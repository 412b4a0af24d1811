// Flash attention for Hopper: tiled online-softmax attention over folded
// queries (B*Hq, Sq, D) and keys/values (B*Hkv, Skv, D), float32 or bf16.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::_flash_kernel
// (launched by flash_attention_folded, wrapped by ops.py::flash_attention).
//
// Bound: operations. At the serving path's prefill (B=4, Hq=24, Hkv=8,
// S=2048, D=128, bf16, causal) one call does about 1.03e11 flops (QK^T and
// PV over the causal half) and must move about 134 MB (q, k, v read once,
// o written once): 0.104 ms at the tensor cores' 989 TFLOP/s against
// 0.040 ms at 3.35 TB/s.
//
// Design. This first version multiplies on the CUDA cores in float32
// (67 TFLOP/s), so it cannot beat about 1.5 ms at that shape; the tensor
// cores (wgmma, TMA) are a later change.
// - The TPU kernel carried m, l and acc in VMEM scratch from one k grid step
//   to the next, which needs the grid to run in order. Hopper blocks run in
//   no order, so one block owns one (b*hq, 64-row q tile) and loops over the
//   k tiles of 64 itself, with m, l and acc in registers.
// - k tiles that lie wholly above the causal diagonal or wholly outside the
//   window are skipped. That is exact: the TPU kernel's pass over such a
//   tile leaves m, l and acc unchanged (alpha = 1, p = 0).
// - The causal tail's q tiles have the most k tiles, so they are issued
//   first and the last wave of blocks is short.
// - Tiles sit in shared memory as float32 (converted on load). K and V share
//   one buffer, loaded in turn, so that two blocks fit an SM at D=128
//   (85 KB each). Rows are padded by 4 floats: 8 threads reading 16 bytes
//   each from 8 different rows hit distinct banks.
// - 256 threads as 16 x 16: thread (ty, tx) owns rows ty*4..ty*4+3 of the
//   tile, score columns tx + 16*j and output columns tx*4 + 64*j + 0..3.
//   The 16 threads of a row group share a half-warp, so the row max and row
//   sum go through warp shuffles.
// - Kept from the TPU kernel, each a place where two versions could differ:
//   the scale multiplies the fp32 dot product; the causal mask is aligned
//   to the kv tail (q_pos + kv_len - q_len >= k_pos) and the window is
//   q_pos + kv_len - q_len - k_pos < window; the -inf guards m_safe and
//   alpha; l is summed from the fp32 p, while p is rounded to v's type
//   before the PV product; a row with l == 0 outputs 0; q row bh reads kv
//   row bh / group.
// The multiply-adds are explicit fmaf: the library is built with
// -fmad=false, which only stops the compiler from contracting a*b+c.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // k rows per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int TM = 4;         // rows per thread
constexpr int TN = 4;         // score columns per thread
constexpr int LDP = BK + 4;   // row stride of the p tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// p rounded to the value type, as the TPU kernel's p.astype(v.dtype)
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// rows x D elements of src (row-major, D per row) into dst (row stride
// D + 4) as float32; rows at or past `valid` are zero
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int valid) {
  constexpr int LDS = D + 4;
#pragma unroll 8
  for (int e = threadIdx.x; e < ROWS * D; e += THREADS) {
    const int r = e / D, c = e % D;
    dst[r * LDS + c] = r < valid ? to_float(src[static_cast<long long>(r) * D + c]) : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int group, int q_len, int kv_len, int causal, int window,
             float scale) {
  constexpr int LDS = D + 4;
  constexpr int TD = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* s_q = reinterpret_cast<float*>(smem4);  // BQ x LDS
  float* s_kv = s_q + BQ * LDS;                  // BK x LDS, k then v
  float* s_p = s_kv + BK * LDS;                  // BQ x LDP

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long bh = blockIdx.x;
  const long long bkv = bh / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest (causal tail) first
  const int off = kv_len - q_len;

  const T* qb = q + (bh * q_len + q0) * D;
  const T* kb = k + bkv * kv_len * D;
  const T* vb = v + bkv * kv_len * D;

  // k tiles that can hold a visible key for some row of this q tile
  const int q_last = min(q0 + BQ, q_len) - 1;
  int kt_begin = 0, kt_end = (kv_len + BK - 1) / BK;
  if (causal) {
    const long long hi = static_cast<long long>(q_last) + off;  // largest visible k
    kt_end = hi < 0 ? 0 : static_cast<int>(min(static_cast<long long>(kt_end), hi / BK + 1));
  }
  {
    const long long lo = static_cast<long long>(q0) + off - window + 1;  // smallest visible k
    if (lo > 0) kt_begin = static_cast<int>(min(lo / BK, static_cast<long long>(kt_end)));
  }

  load_tile<T, D, BQ>(s_q, qb, q_len - q0);

  float m[TM], l[TM], acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    load_tile<T, D, BK>(s_kv, kb + static_cast<long long>(k0) * D, kv_len - k0);
    __syncthreads();  // q (first pass) and k in shared memory

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; d += 4) {
      float4 qv[TM], kv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(s_q + (ty * TM + i) * LDS + d);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(s_kv + (tx + 16 * j) * LDS + d);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // mask, online softmax, p into shared memory
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qi = q0 + ty * TM + i;
      const int qpos = qi + off;
      float m_cur = -INFINITY;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = qi < q_len && kpos < kv_len && qpos - kpos < window;
        if (causal) ok = ok && qpos >= kpos;
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        m_cur = fmaxf(m_cur, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, w));
      const float m_new = fmaxf(m[i], m_cur);
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      const float alpha = m[i] == -INFINITY ? 0.0f : expf(m[i] - m_safe);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = expf(s[i][j] - m_safe);  // masked: exp(-inf) = 0
        row_sum += p;
        s_p[(ty * TM + i) * LDP + tx + 16 * j] = round_to(p, v);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) row_sum += __shfl_xor_sync(0xffffffffu, row_sum, w);
      l[i] = alpha * l[i] + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < TD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // every thread is done with k; p is complete

    load_tile<T, D, BK>(s_kv, vb + static_cast<long long>(k0) * D, kv_len - k0);
    __syncthreads();  // v in shared memory

#pragma unroll 4
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        pv[i] = *reinterpret_cast<const float4*>(s_p + (ty * TM + i) * LDP + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int jj = 0; jj < TD / 4; ++jj) {
          const float4 vv =
              *reinterpret_cast<const float4*>(s_kv + (kk + e) * LDS + tx * 4 + 64 * jj);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float pe = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
            acc[i][jj * 4 + 0] = fmaf(pe, vv.x, acc[i][jj * 4 + 0]);
            acc[i][jj * 4 + 1] = fmaf(pe, vv.y, acc[i][jj * 4 + 1]);
            acc[i][jj * 4 + 2] = fmaf(pe, vv.z, acc[i][jj * 4 + 2]);
            acc[i][jj * 4 + 3] = fmaf(pe, vv.w, acc[i][jj * 4 + 3]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with v and p before the next tile
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qi = q0 + ty * TM + i;
    if (qi >= q_len) continue;
    const float l_safe = l[i] == 0.0f ? 1.0f : l[i];
    T* orow = o + (bh * q_len + qi) * D;
#pragma unroll
    for (int jj = 0; jj < TD / 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) store(orow + tx * 4 + 64 * jj + e, acc[i][jj * 4 + e] / l_safe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, long long bhq, int group,
           int sq, int skv, int causal, int window, float scale, cudaStream_t stream) {
  const int smem = (BQ * (D + 4) + BK * (D + 4) + BQ * LDP) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(bhq), static_cast<unsigned>((sq + BQ - 1) / BQ));
  flash_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), group, sq, skv, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, o: (bhq, sq, d); k, v: (bhkv, skv, d); all contiguous, of one type:
// dtype 0 = float32, 1 = bf16. d is 64 or 128; bhq is a multiple of bhkv.
// window: keys with q_pos + skv - sq - k_pos >= window are masked (the caller
// passes skv for no window). Returns the launch's cudaError_t.
extern "C" int flash_attn(int dtype, const void* q, const void* k, const void* v, void* o,
                          long long bhq, long long bhkv, int sq, int skv, int d, int causal,
                          int window, float scale, void* stream) {
  if (bhq == 0 || sq == 0) return cudaSuccess;
  if (bhkv <= 0 || bhq % bhkv != 0) return cudaErrorInvalidValue;
  if (bhq > 0x7fffffffLL || (sq + BQ - 1) / BQ > 65535) return cudaErrorInvalidConfiguration;
  const int group = static_cast<int>(bhq / bhkv);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64) return launch<float, 64>(q, k, v, o, bhq, group, sq, skv, causal, window, scale, s);
  if (dtype == 0 && d == 128) return launch<float, 128>(q, k, v, o, bhq, group, sq, skv, causal, window, scale, s);
  if (dtype == 1 && d == 64) return launch<__nv_bfloat16, 64>(q, k, v, o, bhq, group, sq, skv, causal, window, scale, s);
  if (dtype == 1 && d == 128) return launch<__nv_bfloat16, 128>(q, k, v, o, bhq, group, sq, skv, causal, window, scale, s);
  return cudaErrorInvalidValue;
}
