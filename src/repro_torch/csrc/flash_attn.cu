// Flash attention for Hopper: tiled online-softmax attention over folded
// queries (B*Hq, Sq, D) and keys/values (B*Hkv, Skv, D), bf16 or float32.
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
// Two kernels, chosen by the element type and the head dim d (1 to 256):
// - bf16 with d a multiple of 8 and at most 128 (the serving path) runs at
//   d padded to DP = 64 or 128: TMA fills the columns past d with zeros,
//   which add exact zeros to Q K^T and to the unstored columns of P V, and
//   S = Q K^T stops after ceil(d / 16) steps of 16. It multiplies on the
//   tensor cores with warpgroup matrix multiplies (wgmma). A block owns 128 q rows of one b*hq row, as
//   two consumer warpgroups of 64 rows, and one producer warpgroup that
//   gives most of its registers to them (setmaxnreg). One producer thread
//   keeps K and V tiles of 128 keys coming by TMA, each into its own
//   two-stage ring of shared memory guarded by "full" and "empty"
//   mbarriers, so the next tiles are in flight while one is multiplied.
//   Tiles stay bf16, in the 128-byte swizzle that TMA writes and wgmma
//   reads. S = Q K^T reads Q and K from shared memory into float32
//   registers; the mask, the online softmax (row max and sum over the 4
//   lanes that share a row) and the rescale of O run on that register
//   fragment; p is cast to bf16 in registers and fed back as the A operand
//   of O += P V, with V read through a transposed (MN-major) descriptor. P
//   never touches shared memory. A warpgroup issues tile i's S together with
//   tile i-1's P V, so its softmax of tile i runs while the tensor cores
//   multiply P V.
// - float32 keeps the CUDA-core kernel below (namespace cuda_cores): on the
//   tensor cores float32 would mean TF32, which changes float32 results.
//   It is bound by the CUDA cores' 67 TFLOP/s. bf16 at a head dim the
//   tensor-core kernel does not take (not a multiple of 8, whose rows TMA
//   cannot address, or 129 to 256) runs on it too, converted to float32 in
//   shared memory. Both pad d to DP = 32, 64, 128 or 256 with zero columns.
//
// Kept from the TPU kernel by both, each a place where two versions could
// differ: the scale multiplies the fp32 dot product; the causal mask is
// aligned to the kv tail (q_pos + kv_len - q_len >= k_pos) and the window is
// q_pos + kv_len - q_len - k_pos < window; the -inf guards m_safe and alpha;
// l is summed from the fp32 p, while p is rounded to v's type before the PV
// product; a row with l == 0 outputs 0; q row bh reads kv row bh / group;
// k tiles wholly above the causal diagonal or outside the window are
// skipped, which is exact: the TPU kernel's pass over such a tile leaves m,
// l and acc unchanged (alpha = 1, p = 0). The causal tail's q tiles have the
// most k tiles, so they are issued first and the last wave of blocks is
// short. Online softmax rounds p at tile edges, so each kernel's plain
// version is taken at its k tile: 128 keys on the tensor cores, 64 on the
// CUDA cores (kernel_block_k in kernels/flash_attention/kernel.py).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// The CUDA-core kernel: float32, and bf16 where the tensor-core kernel does
// not take the head dim. 256 threads as 16 x 16, 64-row tiles in shared
// memory as float32, DP columns wide (the head dim d padded to 32, 64, 128 or
// 256; columns at or past d are zero, so they add exact zeros to every dot
// product and are never stored). Multiply-adds are explicit fmaf (the library
// is built with -fmad=false, which only stops the compiler from contracting
// a*b+c).
namespace cuda_cores {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // k rows per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int TM = 4;         // rows per thread
constexpr int TN = 4;         // score columns per thread
constexpr int LDP = BK + 4;   // row stride of the p tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
// p rounded to the value type, as the TPU kernel's p.astype(v.dtype)
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// rows x DP elements into dst (row stride DP + 4) as float32 from src
// (row-major, d per row); rows at or past `valid` and columns at or past d
// are zero
template <typename T, int DP, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int valid, int d) {
  constexpr int LDS = DP + 4;
#pragma unroll 8
  for (int e = threadIdx.x; e < ROWS * DP; e += THREADS) {
    const int r = e / DP, c = e % DP;
    dst[r * LDS + c] = r < valid && c < d ? to_float(src[static_cast<long long>(r) * d + c]) : 0.0f;
  }
}

// VW consecutive columns of a shared-memory row, as one load
template <int VW>
struct Vec;
template <>
struct Vec<4> {
  float v[4];
  __device__ __forceinline__ explicit Vec(const float* p) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
};
template <>
struct Vec<2> {
  float v[2];
  __device__ __forceinline__ explicit Vec(const float* p) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  }
};

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int d, int group, int q_len, int kv_len, int causal, int window,
             float scale) {
  constexpr int LDS = DP + 4;
  constexpr int TD = DP / 16;          // output columns per thread
  constexpr int VW = TD < 4 ? TD : 4;  // of them adjacent: thread tx owns columns
                                       // tx * VW + 16 * VW * jj + e, e < VW
  extern __shared__ float4 smem4[];
  float* s_q = reinterpret_cast<float*>(smem4);  // BQ x LDS
  float* s_kv = s_q + BQ * LDS;                  // BK x LDS, k then v
  float* s_p = s_kv + BK * LDS;                  // BQ x LDP

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long bh = blockIdx.x;
  const long long bkv = bh / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest (causal tail) first
  const int off = kv_len - q_len;

  const T* qb = q + (bh * q_len + q0) * d;
  const T* kb = k + bkv * kv_len * d;
  const T* vb = v + bkv * kv_len * d;

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

  load_tile<T, DP, BQ>(s_q, qb, q_len - q0, d);

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
    load_tile<T, DP, BK>(s_kv, kb + static_cast<long long>(k0) * d, kv_len - k0, d);
    __syncthreads();  // q (first pass) and k in shared memory

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < DP; c += 4) {
      float4 qv[TM], kv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(s_q + (ty * TM + i) * LDS + c);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(s_kv + (tx + 16 * j) * LDS + c);
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

    load_tile<T, DP, BK>(s_kv, vb + static_cast<long long>(k0) * d, kv_len - k0, d);
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
        for (int jj = 0; jj < TD / VW; ++jj) {
          const Vec<VW> vv(s_kv + (kk + e) * LDS + tx * VW + 16 * VW * jj);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float pe = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
#pragma unroll
            for (int x = 0; x < VW; ++x) acc[i][jj * VW + x] = fmaf(pe, vv.v[x], acc[i][jj * VW + x]);
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
    T* orow = o + (bh * q_len + qi) * d;
#pragma unroll
    for (int jj = 0; jj < TD / VW; ++jj)
#pragma unroll
      for (int x = 0; x < VW; ++x) {
        const int c = tx * VW + 16 * VW * jj + x;
        if (c < d) store(orow + c, acc[i][jj * VW + x] / l_safe);
      }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, long long bhq, int d, int group,
           int sq, int skv, int causal, int window, float scale, cudaStream_t stream) {
  const int smem = (BQ * (DP + 4) + BK * (DP + 4) + BQ * LDP) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(bhq), static_cast<unsigned>((sq + BQ - 1) / BQ));
  flash_kernel<T, DP><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), d, group, sq, skv, causal, window, scale);
  return cudaGetLastError();
}

// the narrowest instance that holds head dim d (d <= 256)
template <typename T>
int launch_padded(const void* q, const void* k, const void* v, void* o, long long bhq, int d,
                  int group, int sq, int skv, int causal, int window, float scale,
                  cudaStream_t s) {
  if (d <= 32) return launch<T, 32>(q, k, v, o, bhq, d, group, sq, skv, causal, window, scale, s);
  if (d <= 64) return launch<T, 64>(q, k, v, o, bhq, d, group, sq, skv, causal, window, scale, s);
  if (d <= 128) return launch<T, 128>(q, k, v, o, bhq, d, group, sq, skv, causal, window, scale, s);
  return launch<T, 256>(q, k, v, o, bhq, d, group, sq, skv, causal, window, scale, s);
}

}  // namespace cuda_cores

// ---------------------------------------------------------------------------
// bf16: warpgroup matrix multiplies on the tensor cores
namespace tc {

constexpr int BM = 128;                             // q rows per block: two warpgroups of 64
constexpr int BN = 128;                             // keys per tile (KERNEL_BLOCK_K)
constexpr int STAGES = 2;                           // K ring and V ring
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = 32 * CONSUMER_WARPS + 128;  // and one producer warpgroup
// registers a thread: the producer gives up most of its share to the consumers
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int SW = 64;                              // bf16 in one 128-byte swizzled row
constexpr float LOG2E = 1.4426950408889634f;

// Each tile of rows x DP is stored as DP/64 column blocks of rows x 64, one
// 128-byte row per q row or key, its 16-byte chunks XOR-ed with row % 8.
// The pattern repeats every 1024 bytes, so every tile starts on such a
// boundary (the sizes below are multiples of 1024). DP is the head dim d
// padded to 64 or 128: TMA fills the columns at or past d with zeros.
template <int DP>
struct Smem {
  __nv_bfloat16 q[BM * DP];
  __nv_bfloat16 k[STAGES][BN * DP];
  __nv_bfloat16 v[STAGES][BN * DP];
  uint64_t k_full[STAGES], v_full[STAGES];    // the tile has landed
  uint64_t k_empty[STAGES], v_empty[STAGES];  // every consumer warp is done with it
  uint64_t q_full;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// a box of 64 columns x rows x 1 of a (batch, rows, d) tensor, by TMA
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int col, int row,
                                         int batch, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(batch), "r"(smem_addr(bar))
      : "memory");
}

// wgmma's shared-memory matrix descriptor for the 128-byte swizzle; the
// leading (lbo) and stride (sbo) byte offsets as the PTX ISA defines them
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from moving a read or write of registers that an
// asynchronous wgmma owns across its wait
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// d (64 x 128, f32) = a * b, plus d if `accumulate`: a (64 x 16) and b (16 x 128)
// both in shared memory, K-major (128-byte swizzle)
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, f32) += a * b: a (64 x 16) in registers, b (16 x 128) in shared
// memory, MN-major (128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) += a * b: a (64 x 16) in registers, b (16 x 64) in shared
// memory, MN-major (128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int DP>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (DP == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

// Fragments (wgmma's accumulator layout): in warp w of a warpgroup, lane
// (g = lane / 4, c = lane % 4) holds, for every 8-column block j, columns
// 8j + 2c and 8j + 2c + 1 of rows 16w + g (registers 4j, 4j + 1) and
// 16w + g + 8 (registers 4j + 2, 4j + 3). The A operand of a 16-deep step
// kk takes the same rows and columns 16kk .. 16kk + 15, so P's fragment is
// S's registers 8kk .. 8kk + 7 packed in pairs.

// S = Q K^T for the warpgroup's 64 rows: K-major both, 16 columns of the
// padded head dim (32 bytes of a swizzled row) a step. Steps over the zero
// columns past d add nothing; they are issued all the same, because a
// branch between the wgmma instructions serializes them (10 to 26 % slower
// on an H100 at d = 128, 96, 80 and 32: tools/flash_topk_variants.py).
// Issued, not waited for.
template <int DP>
__device__ __forceinline__ void issue_s(float* sc, uint32_t q_base, uint32_t k_base) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t step = (kk % 4) * 32;  // within the column block kk / 4
    wgmma_ss_n128(sc, desc(q_base + (kk / 4) * BM * 128 + step, 0, 1024),
                  desc(k_base + (kk / 4) * BN * 128 + step, 0, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P V: V MN-major, 16 keys (two 8-key groups of 1024 bytes) a step.
// Issued, not waited for.
template <int DP>
__device__ __forceinline__ void issue_pv(float* acc, uint32_t (*pa)[4], uint32_t v_base) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) wgmma_pv<DP>(acc, pa[kk], desc(v_base + kk * 2048, BN * 128, 1024));
  wgmma_commit();
}

// Scale and mask one tile's scores, then the online softmax of the thread's
// two rows (r0, r0 + 8): m and l move on, p overwrites s, and alpha is what
// O has to be rescaled by. `edge`: the tile crosses the diagonal, the window
// or the kv tail.
__device__ __forceinline__ void softmax(float* sc, float* m, float* l, float* alpha, bool edge,
                                        int r0, int k0, int c4, int off, int kv_len, int causal,
                                        int window, float scale) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e] * scale;
      if (edge) {
        const int q_pos = r0 + (e / 2) * 8 + off;
        const int k_pos = k0 + 8 * j + 2 * c4 + e % 2;
        bool ok = k_pos < kv_len && q_pos - k_pos < window;
        if (causal) ok = ok && q_pos >= k_pos;
        x = ok ? x : -INFINITY;
      }
      sc[4 * j + e] = x;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
    alpha[r] = m[r] == -INFINITY ? 0.0f : ex2((m[r] - m_safe) * LOG2E);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ex2((sc[4 * j + 2 * r + e] - m_safe) * LOG2E);  // masked: 0
        sc[4 * j + 2 * r + e] = p;
        sum += p;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[r] = alpha[r] * l[r] + sum;
    m[r] = m_new;
  }
}

// p rounded to bf16, packed in pairs: the A operand of P V
__device__ __forceinline__ void pack_p(uint32_t (*pa)[4], const float* sc) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
}

// FULL: d == DP, so every column is stored (no test in the epilogue)
template <int DP, bool FULL>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int d,
                int group, int q_len, int kv_len, int causal, int window, float scale) {
  extern __shared__ uint8_t smem_raw[];
  Smem<DP>& sm =
      *reinterpret_cast<Smem<DP>*>(smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024);

  const int bh = blockIdx.x;
  const int bkv = bh / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest (causal tail) first
  const int off = kv_len - q_len;

  // k tiles that can hold a visible key for some row of this q tile
  const int q_last = min(q0 + BM, q_len) - 1;
  int kt_begin = 0, kt_end = (kv_len + BN - 1) / BN;
  if (causal) {
    const long long hi = static_cast<long long>(q_last) + off;  // largest visible k
    kt_end = hi < 0 ? 0 : static_cast<int>(min(static_cast<long long>(kt_end), hi / BN + 1));
  }
  {
    const long long lo = static_cast<long long>(q0) + off - window + 1;  // smallest visible k
    if (lo > 0) kt_begin = static_cast<int>(min(lo / BN, static_cast<long long>(kt_end)));
  }
  const int n_tiles = kt_end - kt_begin;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], CONSUMER_WARPS);
      mbar_init(&sm.v_empty[s], CONSUMER_WARPS);
    }
    mbar_init(&sm.q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {  // the producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 32 * CONSUMER_WARPS) {
      // every box counts in full, its zero fill past d and past the last row included
      mbar_expect_tx(&sm.q_full, BM * DP * 2);
      for (int c = 0; c < DP / SW; ++c) tma_load(sm.q + c * BM * SW, &tq, c * SW, q0, bh, &sm.q_full);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, k0 = (kt_begin + i) * BN;
        const uint32_t parity = (i / STAGES - 1) & 1;  // tile i - STAGES released the stage
        if (i >= STAGES) mbar_wait(&sm.k_empty[s], parity);
        mbar_expect_tx(&sm.k_full[s], BN * DP * 2);
        for (int c = 0; c < DP / SW; ++c) tma_load(sm.k[s] + c * BN * SW, &tk, c * SW, k0, bkv, &sm.k_full[s]);
        if (i >= STAGES) mbar_wait(&sm.v_empty[s], parity);
        mbar_expect_tx(&sm.v_full[s], BN * DP * 2);
        for (int c = 0; c < DP / SW; ++c) tma_load(sm.v[s] + c * BN * SW, &tv, c * SW, k0, bkv, &sm.v_full[s]);
      }
    }
  } else {
    // a consumer warpgroup: q rows wg * 64 .. wg * 64 + 63 of the block.
    // Tile i's S = Q K^T is issued together with tile i - 1's O += P V, so
    // the softmax of tile i runs while the tensor cores multiply P V.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int wg = warp / 4;
    const int g = lane / 4, c4 = lane % 4;
    const int r0 = q0 + wg * 64 + (warp % 4) * 16 + g;  // this thread's rows: r0 and r0 + 8
    const uint32_t q_base = smem_addr(sm.q) + wg * 64 * 128;
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, alpha[2];
    float sc[BN / 2];
    uint32_t pa[BN / 16][4];
    // the tile crosses the diagonal, the window or the kv tail: mask it
    const auto edge = [&](int k0) {
      return k0 + BN > kv_len || (causal && k0 + BN - 1 > q0 + off) ||
             q0 + BM - 1 + off - k0 >= window;
    };
    mbar_wait(&sm.q_full, 0);
    __syncwarp();  // wgmma is .aligned: the warp's lanes leave the wait together

    if (n_tiles > 0) {
      const int k0 = kt_begin * BN;  // tile 0: S, then its softmax
      mbar_wait(&sm.k_full[0], 0);
      __syncwarp();
      wgmma_fence();
      issue_s<DP>(sc, q_base, smem_addr(sm.k[0]));
      wgmma_wait();
      fence_regs<BN / 2>(sc);
      if (lane == 0) mbar_arrive(&sm.k_empty[0]);
      softmax(sc, m, l, alpha, edge(k0), r0, k0, c4, off, kv_len, causal, window, scale);
      pack_p(pa, sc);  // O is 0: no rescale
    }
    for (int i = 1; i < n_tiles; ++i) {
      const int s = i % STAGES, sp = (i - 1) % STAGES, k0 = (kt_begin + i) * BN;
      mbar_wait(&sm.k_full[s], (i / STAGES) & 1);
      mbar_wait(&sm.v_full[sp], ((i - 1) / STAGES) & 1);
      __syncwarp();
      wgmma_fence();
      issue_s<DP>(sc, q_base, smem_addr(sm.k[s]));
      issue_pv<DP>(acc, pa, smem_addr(sm.v[sp]));
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");  // S is done, P V runs on
      fence_regs<BN / 2>(sc);
      if (lane == 0) mbar_arrive(&sm.k_empty[s]);
      softmax(sc, m, l, alpha, edge(k0), r0, k0, c4, off, kv_len, causal, window, scale);
      wgmma_wait();
      fence_regs<DP / 2>(acc);
      if (lane == 0) mbar_arrive(&sm.v_empty[sp]);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[4 * j + 0] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
      pack_p(pa, sc);
    }
    if (n_tiles > 0) {  // the last tile's P V
      const int sp = (n_tiles - 1) % STAGES;
      mbar_wait(&sm.v_full[sp], ((n_tiles - 1) / STAGES) & 1);
      __syncwarp();
      wgmma_fence();
      issue_pv<DP>(acc, pa, smem_addr(sm.v[sp]));
      wgmma_wait();
      fence_regs<DP / 2>(acc);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r0 + 8 * r;
      if (qi >= q_len) continue;
      const float l_safe = l[r] == 0.0f ? 1.0f : l[r];
      __nv_bfloat16* orow = o + (static_cast<long long>(bh) * q_len + qi) * (FULL ? DP : d);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)  // d is a multiple of 8: a pair never straddles it
        if (FULL || 8 * j < d)
          *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * c4) =
              pack_bf16(acc[4 * j + 2 * r] / l_safe, acc[4 * j + 2 * r + 1] / l_safe);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime so that the
// library needs no link against libcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a (batch, rows, d) bf16 tensor read in boxes of 64 columns x box_rows rows,
// 128-byte swizzled; rows past the end and columns past d read as zero (the
// box may be wider than d). TMA wants global strides in multiples of 16
// bytes, so d is a multiple of 8.
bool tensor_map(CUtensorMap* map, const void* ptr, int d, long long rows, long long batch,
                int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2, static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {SW, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                        strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, long long bhq, long long bhkv,
           int d, int group, int sq, int skv, int causal, int window, float scale,
           cudaStream_t stream) {
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  // TMA reads from 16-byte aligned addresses only
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, d, sq, bhq, BM) || !tensor_map(&tk, k, d, skv, bhkv, BN) ||
      !tensor_map(&tv, v, d, skv, bhkv, BN))
    return cudaErrorInvalidValue;
  const int smem = static_cast<int>(sizeof(Smem<DP>)) + 1024;  // + room to align to 1024
  const auto kernel = d == DP ? flash_tc_kernel<DP, true> : flash_tc_kernel<DP, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(bhq), static_cast<unsigned>((sq + BM - 1) / BM));
  kernel<<<grid, THREADS, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), d, group,
                                          sq, skv, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, o: (bhq, sq, d); k, v: (bhkv, skv, d); all contiguous, of one type:
// dtype 0 = float32, 1 = bf16; 1 <= d <= 256; bhq is a multiple of bhkv.
// bf16 with d a multiple of 8 and at most 128 runs on the tensor cores at
// d padded to 64 or 128; float32, and bf16 at any other d, on the CUDA
// cores at d padded to 32, 64, 128 or 256.
// window: keys with q_pos + skv - sq - k_pos >= window are masked (the caller
// passes skv for no window). Returns the launch's cudaError_t.
extern "C" int flash_attn(int dtype, const void* q, const void* k, const void* v, void* o,
                          long long bhq, long long bhkv, int sq, int skv, int d, int causal,
                          int window, float scale, void* stream) {
  using cuda_cores::BQ;
  if (bhq == 0 || sq == 0) return cudaSuccess;
  if (bhkv <= 0 || bhq % bhkv != 0) return cudaErrorInvalidValue;
  if (bhq > 0x7fffffffLL || (sq + BQ - 1) / BQ > 65535) return cudaErrorInvalidConfiguration;
  const int group = static_cast<int>(bhq / bhkv);
  auto s = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > 256 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  if (dtype == 1 && d % 8 == 0 && d <= 64)
    return tc::launch<64>(q, k, v, o, bhq, bhkv, d, group, sq, skv, causal, window, scale, s);
  if (dtype == 1 && d % 8 == 0 && d <= 128)
    return tc::launch<128>(q, k, v, o, bhq, bhkv, d, group, sq, skv, causal, window, scale, s);
  if (dtype == 1)
    return cuda_cores::launch_padded<__nv_bfloat16>(q, k, v, o, bhq, d, group, sq, skv, causal,
                                                    window, scale, s);
  return cuda_cores::launch_padded<float>(q, k, v, o, bhq, d, group, sq, skv, causal, window,
                                          scale, s);
}
