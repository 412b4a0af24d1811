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
// Bound: device memory. Per task the kernel must read (A + B) * F floats and
// the masks, and write A * k scores and slots; per valid pair it does
// 2 * (T1 + T2 + T3) + 19 float32 operations (the histogram min-sums and the
// five terms). At the main path's shapes (36,864 tasks, A = B = 53, F = 101)
// the bytes take about four times as long as the operations at peak rates.
//
// Design: the block stages feat_u and feat_v of its task in shared memory
// (coalesced loads; about 21 KB each at a bucket cap of 53 and F = 101), then
// each thread owns one v row: it writes its B scores to its own shared-memory
// row and runs the k selection passes there. The TPU kernel's running top-k
// stayed in VMEM; here it stays in shared memory, so the priority lists never
// touch device memory.
//
// Rounding: the operations run in the reference's order (histogram sums in
// index order, which are exact since every term is an integer-valued float;
// the five terms added left to right, then times 0.2; 1/(1+|d|) as an IEEE
// division). The library is built with -fmad=false, so no multiply-add
// contraction can move a score by an ulp and with it a tie in the selection.
#include <cuda_runtime.h>

#include <math.h>

namespace {

__device__ __forceinline__ float overlap(const float* v, const float* u, int lo, int width,
                                         int count_slot) {
  float inter = 0.0f;
  for (int t = lo; t < lo + width; ++t) inter += fminf(v[t], u[t]);
  const float denom = fmaxf(fmaxf(v[count_slot], u[count_slot]), 1.0f);
  return inter / denom;
}

__global__ void topk_sim_kernel(const float* __restrict__ feat_v, const float* __restrict__ feat_u,
                                const float* __restrict__ mask_v, const float* __restrict__ mask_u,
                                float* __restrict__ scores, int* __restrict__ idx, int a_rows,
                                int b_rows, int f, int t1, int t2, int t3, int k) {
  extern __shared__ float smem[];
  float* su = smem;                  // (B, F) feat_u of this task
  float* sv = su + b_rows * f;       // (A, F) feat_v of this task
  float* ss = sv + a_rows * f;       // (A, B) scores, one row per thread
  const long long p = blockIdx.x;
  const float* gu = feat_u + p * b_rows * f;
  const float* gv = feat_v + p * a_rows * f;
  for (int i = threadIdx.x; i < b_rows * f; i += blockDim.x) su[i] = gu[i];
  for (int i = threadIdx.x; i < a_rows * f; i += blockDim.x) sv[i] = gv[i];
  __syncthreads();

  const int a = threadIdx.x;
  if (a >= a_rows) return;
  const float* v = sv + a * f;
  float* s = ss + a * b_rows;
  const bool v_ok = mask_v[p * a_rows + a] > 0.0f;
  for (int b = 0; b < b_rows; ++b) {
    float score = -INFINITY;
    if (v_ok && mask_u[p * b_rows + b] > 0.0f) {
      const float* u = su + b * f;
      const float s_deg = 1.0f / (1.0f + fabsf(v[0] - u[0]));
      const float s_typ = v[1] == u[1] ? 1.0f : 0.0f;
      const float s_nt = overlap(v, u, 5, t1, 2);
      const float s_et = overlap(v, u, 5 + t1, t2, 3);
      const float s_at = overlap(v, u, 5 + t1 + t2, t3, 4);
      score = 0.2f * ((((s_deg + s_typ) + s_nt) + s_et) + s_at);
    }
    s[b] = score;
  }
  float* out_s = scores + (p * a_rows + a) * k;
  int* out_i = idx + (p * a_rows + a) * k;
  for (int j = 0; j < k; ++j) {
    // argmax with a strict '>' keeps the first index among equal maxima
    float best = s[0];
    int best_b = 0;
    for (int b = 1; b < b_rows; ++b) {
      if (s[b] > best) {
        best = s[b];
        best_b = b;
      }
    }
    out_s[j] = best;
    out_i[j] = best_b;
    s[best_b] = -INFINITY;
  }
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
  if (b_rows < 1 || k > b_rows || a_rows > 1024 || 5 + t1 + t2 + t3 > f ||
      n_tasks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t shared =
      sizeof(float) * (static_cast<size_t>(a_rows + b_rows) * f + static_cast<size_t>(a_rows) * b_rows);
  // above 48 KB a block's dynamic shared memory must be opted into; a launch
  // asking for more than the SM offers fails and the caller sees the error
  cudaError_t err = cudaFuncSetAttribute(topk_sim_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  const int threads = ((a_rows + 31) / 32) * 32;
  topk_sim_kernel<<<static_cast<unsigned>(n_tasks), threads, shared,
                    static_cast<cudaStream_t>(stream)>>>(feat_v, feat_u, mask_v, mask_u, scores,
                                                         idx, a_rows, b_rows, f, t1, t2, t3, k);
  return cudaGetLastError();
}
