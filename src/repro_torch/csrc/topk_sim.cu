// Fused GSANA similarity + top-k for Hopper: one CUDA block per PAIR task.
//
// Replaces the TPU kernel src/repro/kernels/topk_sim/kernel.py::_topk_sim_kernel
// (with _sim_from_feats; launched by topk_sim_pallas).
//
// For task p, every valid v row of feat_v (A, F) is scored against every
// valid u row of feat_u (B, F):
//   sigma = 0.2 * (1/(1+|deg_v-deg_u|) + [vtype_v == vtype_u]
//                  + three histogram overlaps sum_t min(h_v, h_u) / max(n_v, n_u, 1))
// invalid pairs score -inf, and k argmax-and-mask passes keep each row's k
// best (score, u slot), lowest slot first on ties.
//
// Bound: device memory. Per task the kernel must read the masks and the
// 5 + T1 + T2 + T3 feature columns of each valid row (a masked slot scores
// -inf whatever its features, so those are never read), and write A * k
// scores and slots; per valid pair it does 2 * (T1 + T2 + T3) + 19 float32
// operations (the histogram min-sums and the five terms). At the main path's
// shapes (36,864 tasks of 53 x 53 slots, about 32 of them valid, F = 101)
// the bytes take about two and a half times as long as the operations at
// peak rates.
//
// Design: 256 threads (8 warps) a task, and shared memory for the two
// feature tiles only (about 46 KB at a bucket cap of 53 and F = 101, so 4
// blocks, 32 warps, fit an SM). The block first compacts the valid rows of
// each tile: only those are loaded (a warp per row, coalesced, by cp.async
// so that every copy is in flight at once) and scored, and a v row that is
// not valid gets its k results (-inf, slot 0) at once. A warp then scores a
// group of v rows against every valid u row, lane `l` taking u rows
// l, l + 32, ...: each u value it loads serves every row of the group, and
// the v value is a broadcast. A lane holds J u rows in registers: 2 where
// B <= 64 (1 in a task with at most 32 valid u rows), else up to 32, where
// the loops stop at the task's valid rows, so the work follows them, not B.
// The histograms are read 16 bytes at a time: rows are shifted so that they
// start on a 16-byte boundary, and the row stride is an odd number of
// 16-byte units, so the lanes of a quarter-warp hit distinct banks. Scores
// stay in registers. Top-k is k rounds of one integer warp max over an
// order-preserving key of each score (keys compare as the floats do, -inf
// lowest, whatever their sign) and a ballot for the lowest slot holding it;
// the winner's lane then sets that key to that of -inf.
// Compaction keeps the slots in order, and a row whose valid slots are used
// up meets -inf everywhere and takes slot 0 at -inf, exactly as the TPU
// kernel's argmax over an all -inf row does. The TPU kernel kept its
// running top-k in VMEM; here it never leaves registers.
//
// Rounding: the operations run in the reference's order (histogram sums in
// index order, which are exact since every term is an integer-valued float;
// the five terms added left to right, then times 0.2; 1/(1+|d|) as an IEEE
// division). The library is built with -fmad=false, so no multiply-add
// contraction can move a score by an ulp and with it a tie in the selection.
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_B = 1024;  // u rows a task may have (32 per lane)

// 4 bytes from device memory into shared memory, without a register (cp.async)
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// The bits of a float -> an integer key that orders as the float does, for
// every finite value and -inf, and back: the map is its own inverse. (It
// orders -0 below +0, but no score is -0: its first term, 1/(1+|d|), is not
// negative, and no sum with such a term is -0.)
__device__ __forceinline__ int flip_key(int bits) { return bits ^ ((bits >> 31) & 0x7fffffff); }

// Rows live in shared memory with column c of the feature plane at c + SHIFT,
// so that the histograms (from column 5) start on a 16-byte boundary.
constexpr int SHIFT = 3;

// inter[r][j] += sum over columns [lo, hi) of min(v_r, u_j), in index order,
// for the lane's first nj u rows
template <int J, int R>
__device__ __forceinline__ void min_sums(float (&inter)[R][J], const float* su, const float* sv,
                                         const int (&u)[J], const int (&v)[R], int n_rows, int nj,
                                         int lo, int hi) {
  lo += SHIFT;
  hi += SHIFT;
  const int body = min(hi, (lo + 3) & ~3);  // scalar up to the first 16-byte boundary
  int c = lo;
  for (; c < body; ++c) {
    float ut[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (j >= nj) break;
      ut[j] = su[u[j] + c];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= n_rows) break;
      const float vt = sv[v[r] + c];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (j >= nj) break;
        inter[r][j] += fminf(vt, ut[j]);
      }
    }
  }
  for (; c + 4 <= hi; c += 4) {  // four columns a load
    float4 ut[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (j >= nj) break;
      ut[j] = *reinterpret_cast<const float4*>(su + u[j] + c);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= n_rows) break;
      const float4 vt = *reinterpret_cast<const float4*>(sv + v[r] + c);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (j >= nj) break;
        inter[r][j] += fminf(vt.x, ut[j].x);
        inter[r][j] += fminf(vt.y, ut[j].y);
        inter[r][j] += fminf(vt.z, ut[j].z);
        inter[r][j] += fminf(vt.w, ut[j].w);
      }
    }
  }
  for (; c < hi; ++c) {
    float ut[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (j >= nj) break;
      ut[j] = su[u[j] + c];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= n_rows) break;
      const float vt = sv[v[r] + c];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (j >= nj) break;
        inter[r][j] += fminf(vt, ut[j]);
      }
    }
  }
}

// Score v rows a0 + WARPS * r (r < n_rows <= R) of sv against the nu valid
// u rows, up to J per lane, and write each row's top k. J * 32 >= nu.
template <int J, int R>
__device__ __forceinline__ void score_rows(const float* su, const float* sv, int ld, int nu,
                                           const int* uslot, const int* vrow, int a0, int n_rows,
                                           int t1, int t2, int t3, int k, float* out_s,
                                           int* out_i) {
  const int lane = threadIdx.x % 32;
  // the u rows a lane scores, the same in every lane: all J where J <= 2
  // (bounds known at compile time keep the narrow instance faster than one
  // read at run time would), else as many as the valid rows need
  const int nj = J <= 2 ? J : max((nu + 31) / 32, 1);
  int u[J];  // offsets of the lane's u rows (a row past nu reads the last one)
#pragma unroll
  for (int j = 0; j < J; ++j) u[j] = max(min(lane + 32 * j, nu - 1), 0) * ld;
  int v[R];  // offsets of the group's v rows
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = (a0 + WARPS * min(r, n_rows - 1)) * ld;
  float s[R][J];  // the running sum of the five terms, then the score
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= n_rows) break;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (j >= nj) break;
      const float s_deg = 1.0f / (1.0f + fabsf(sv[v[r] + SHIFT] - su[u[j] + SHIFT]));
      const float s_typ = sv[v[r] + SHIFT + 1] == su[u[j] + SHIFT + 1] ? 1.0f : 0.0f;
      s[r][j] = s_deg + s_typ;
    }
  }
  const int seg_lo[3] = {5, 5 + t1, 5 + t1 + t2};
  const int seg_w[3] = {t1, t2, t3};
#pragma unroll
  for (int seg = 0; seg < 3; ++seg) {
    float inter[R][J];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < J; ++j) inter[r][j] = 0.0f;
    min_sums<J, R>(inter, su, sv, u, v, n_rows, nj, seg_lo[seg], seg_lo[seg] + seg_w[seg]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= n_rows) break;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (j >= nj) break;
        const float denom =
            fmaxf(fmaxf(sv[v[r] + SHIFT + 2 + seg], su[u[j] + SHIFT + 2 + seg]), 1.0f);
        s[r][j] = s[r][j] + inter[r][j] / denom;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= n_rows) break;
    const int neg_key = flip_key(__float_as_int(-INFINITY));
    int key[J];  // the scores' keys: the rounds select on these
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (j >= nj) break;
      key[j] = lane + 32 * j < nu ? flip_key(__float_as_int(0.2f * s[r][j])) : neg_key;
    }
    const int a = vrow[a0 + WARPS * r];
    for (int round = 0; round < k; ++round) {
      // the warp's best is one integer max of the keys; the lowest slot
      // holding it wins: slot lane + 32 j, lowest j first
      int best = key[0];
#pragma unroll
      for (int j = 1; j < J; ++j) {
        if (j >= nj) break;
        best = max(best, key[j]);
      }
      best = __reduce_max_sync(0xffffffffu, best);
      int pos = 0;
#pragma unroll
      for (int j = J - 1; j >= 0; --j) {
        if (j >= nj) continue;
        const unsigned holders = __ballot_sync(0xffffffffu, key[j] == best);
        if (holders) pos = 32 * j + __ffs(holders) - 1;
      }
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (pos == lane + 32 * j) key[j] = neg_key;
      if (lane == 0) {
        // all -inf: the valid slots are used up, and argmax takes slot 0
        const float score = __int_as_float(flip_key(best));
        out_s[a * k + round] = score;
        out_i[a * k + round] = score == -INFINITY ? 0 : uslot[pos];
      }
    }
  }
}

// J = u rows per lane (B <= 32 * J), R = v rows per warp and group
template <int J, int R>
__global__ void __launch_bounds__(THREADS, J <= 2 ? 4 : 1)
topk_sim_kernel(const float* __restrict__ feat_v, const float* __restrict__ feat_u,
                const float* __restrict__ mask_v, const float* __restrict__ mask_u,
                float* __restrict__ scores, int* __restrict__ idx, int a_rows, int b_rows, int f,
                int ld, int t1, int t2, int t3, int k) {
  extern __shared__ float smem[];
  float* su = smem;                                       // (B, ld) valid u rows, compacted
  float* sv = su + b_rows * ld;                           // (A, ld) valid v rows, compacted
  int* uslot = reinterpret_cast<int*>(sv + a_rows * ld);  // compacted -> u slot
  int* vrow = uslot + b_rows;                              // compacted -> v row
  __shared__ int n_valid[2];
  const long long p = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* out_s = scores + p * a_rows * k;
  int* out_i = idx + p * a_rows * k;

  if (warp < 2) {  // warp 0 compacts the u slots, warp 1 the v rows
    const int n = warp == 0 ? b_rows : a_rows;
    const float* mask = (warp == 0 ? mask_u + p * b_rows : mask_v + p * a_rows);
    int* slots = warp == 0 ? uslot : vrow;
    int count = 0;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const bool ok = i < n && mask[i] > 0.0f;
      const unsigned ballot = __ballot_sync(0xffffffffu, ok);
      if (ok) slots[count + __popc(ballot & ((1u << lane) - 1))] = i;
      count += __popc(ballot);
      if (warp == 1 && i < n && !ok)
        for (int j = 0; j < k; ++j) {
          out_s[i * k + j] = -INFINITY;
          out_i[i * k + j] = 0;
        }
    }
    if (lane == 0) n_valid[warp] = count;
  }
  __syncthreads();
  const int nu = n_valid[0], nv = n_valid[1];
  const int width = 5 + t1 + t2 + t3;  // the columns the score reads
  const float* gu = feat_u + p * b_rows * f;
  const float* gv = feat_v + p * a_rows * f;
  for (int i = warp; i < nu + nv; i += WARPS) {  // every copy in flight at once
    const bool is_u = i < nu;
    const float* src = is_u ? gu + uslot[i] * f : gv + vrow[i - nu] * f;
    float* dst = (is_u ? su + i * ld : sv + (i - nu) * ld) + SHIFT;
    for (int c = lane; c < width; c += 32) copy_async(dst + c, src + c);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  for (int a0 = warp; a0 < nv; a0 += WARPS * R) {
    const int n_rows = min(R, (nv - a0 + WARPS - 1) / WARPS);
    if (J == 2 && nu <= 32)  // the lanes' second u row would be idle
      score_rows<1, R>(su, sv, ld, nu, uslot, vrow, a0, n_rows, t1, t2, t3, k, out_s, out_i);
    else
      score_rows<J, R>(su, sv, ld, nu, uslot, vrow, a0, n_rows, t1, t2, t3, k, out_s, out_i);
  }
}

template <int J, int R>
int launch(const float* feat_v, const float* feat_u, const float* mask_v, const float* mask_u,
           float* scores, int* idx, long long n_tasks, int a_rows, int b_rows, int f, int ld,
           int t1, int t2, int t3, int k, cudaStream_t stream) {
  const size_t shared = sizeof(float) * static_cast<size_t>(a_rows + b_rows) * ld +
                        sizeof(int) * static_cast<size_t>(a_rows + b_rows);
  // above 48 KB a block's dynamic shared memory must be opted into; a launch
  // asking for more than the SM offers fails and the caller sees the error
  cudaError_t err = cudaFuncSetAttribute(topk_sim_kernel<J, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  topk_sim_kernel<J, R><<<static_cast<unsigned>(n_tasks), THREADS, shared, stream>>>(
      feat_v, feat_u, mask_v, mask_u, scores, idx, a_rows, b_rows, f, ld, t1, t2, t3, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// feat_v: (P, A, F), feat_u: (P, B, F), mask_v: (P, A), mask_u: (P, B), all
// float32 row-major; scores: (P, A, k) float32, idx: (P, A, k) int32.
// Returns the launch's cudaError_t.
extern "C" int topk_sim_f32(const float* feat_v, const float* feat_u, const float* mask_v,
                            const float* mask_u, float* scores, int* idx, long long n_tasks,
                            int a_rows, int b_rows, int f, int t1, int t2, int t3, int k,
                            void* stream) {
  if (n_tasks == 0 || a_rows == 0 || k == 0) return cudaSuccess;
  if (b_rows < 1 || k > b_rows || b_rows > MAX_B || 5 + t1 + t2 + t3 > f ||
      n_tasks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  // a multiple of 4 floats that is an odd number of 16-byte units: the 8
  // lanes of a quarter-warp reading 16 bytes of 8 u rows hit distinct banks
  const int ld = (f + SHIFT + 3) / 8 * 8 + 4;
  auto s = static_cast<cudaStream_t>(stream);
  if (b_rows <= 64)
    return launch<2, 6>(feat_v, feat_u, mask_v, mask_u, scores, idx, n_tasks, a_rows, b_rows, f,
                        ld, t1, t2, t3, k, s);
  return launch<MAX_B / 32, 1>(feat_v, feat_u, mask_v, mask_u, scores, idx, n_tasks, a_rows,
                               b_rows, f, ld, t1, t2, t3, k, s);
}
