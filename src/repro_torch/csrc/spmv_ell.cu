// Blocked-ELL SpMV for Hopper: y[r] = sum_k vals[r,k] * x[cols[r,k]], and
// its CSR-stripe variant.
//
// spmv_ell_f32 replaces the TPU kernel
// src/repro/kernels/spmv/kernel.py::_spmv_ell_kernel (launched by
// _spmv_ell_call, wrapped by spmv_ell_pallas); spmv_stripes_f32 replaces
// src/repro/kernels/spmv/stripe.py::spmv_ell_stripes (one pallas_call of
// that kernel per stripe width), described at its definition.
//
// The ELL kernel. Bound: device memory. Each call must read the (R, K) column and value
// planes (R*K*8 bytes), read x (N*4 bytes) and write y (R*4 bytes); it does
// 2 flops per slot, far below the card's float32 rate.
//
// Design: one thread per row. `block_rows` (the strategy's grain) sets how
// many rows one CUDA block owns; the block's threads stride over them. The
// TPU kernel copied the whole of x into every program's VMEM (the paper's S1
// replication); here x is read through the read-only path (__ldg) and stays
// in the 50 MB L2, so nothing is copied per block. Slots with col < 0 are
// padding and are skipped; the sum runs in slot order, in float32.
#include <cuda_runtime.h>

namespace {

__global__ void spmv_ell_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                                const float* __restrict__ x, float* __restrict__ y,
                                long long n_rows, int k, long long n_x, int block_rows) {
  const long long lo = static_cast<long long>(blockIdx.x) * block_rows;
  const long long hi = min(lo + block_rows, n_rows);
  for (long long r = lo + threadIdx.x; r < hi; r += blockDim.x) {
    const int* c = cols + r * k;
    const float* v = vals + r * k;
    float acc = 0.0f;
    for (int s = 0; s < k; ++s) {
      const int j = c[s];
      if (j >= 0 && j < n_x) acc += v[s] * __ldg(x + j);
    }
    y[r] = acc;
  }
}

// CSR-stripe SpMV: rows are cut into stripes of block_rows, and stripe s
// reads only its first widths[s] slots (its rows' largest width, rounded up
// to a power of two and capped at k), so a skewed matrix pays for its hub's
// width in the hub's stripe only. The TPU version gathered each width's
// rows into planes of their own, ran the ELL kernel once a width and
// scattered y back; here block s owns stripe s and reads its slots in place
// from the (R, k) planes, in one launch. Bound: device memory, the column
// index of every slot a stripe reads, the value of each valid one, x and y.
// A stripe narrower than a warp gives each row a thread, which sums in slot
// order as spmv_ell does; a wider one gives each row a warp, whose lanes
// read consecutive slots (coalesced) and add up by shuffles, so a hub row
// does not hold up its stripe. Slots with col < 0 (padding, anywhere in a
// row) are skipped and their values never read.
__global__ void spmv_stripes_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                                    const float* __restrict__ x, float* __restrict__ y,
                                    const int* __restrict__ widths, long long n_rows, int k,
                                    long long n_x, int block_rows) {
  const long long lo = static_cast<long long>(blockIdx.x) * block_rows;
  const long long hi = min(lo + block_rows, n_rows);
  const int width = widths[blockIdx.x];
  if (width < 32) {
    for (long long r = lo + threadIdx.x; r < hi; r += blockDim.x) {
      const int* c = cols + r * k;
      const float* v = vals + r * k;
      float acc = 0.0f;
      for (int s = 0; s < width; ++s) {
        const int j = c[s];
        if (j >= 0 && j < n_x) acc += v[s] * __ldg(x + j);
      }
      y[r] = acc;
    }
    return;
  }
  const int lane = threadIdx.x % 32;
  for (long long r = lo + threadIdx.x / 32; r < hi; r += blockDim.x / 32) {
    const int* c = cols + r * k;
    const float* v = vals + r * k;
    float acc = 0.0f;
    for (int s = lane; s < width; s += 32) {
      const int j = c[s];
      if (j >= 0 && j < n_x) acc += v[s] * __ldg(x + j);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) y[r] = acc;
  }
}

// threads a block: a warp multiple, at most 256; a grain of 1 still launches a warp
int block_threads(int block_rows) { return block_rows >= 256 ? 256 : ((block_rows + 31) / 32) * 32; }

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// cols, vals: (n_rows, k) row-major; x: (n_x,); y: (n_rows,). Returns the
// launch's cudaError_t.
extern "C" int spmv_ell_f32(const int* cols, const float* vals, const float* x, float* y,
                            long long n_rows, int k, long long n_x, int block_rows,
                            void* stream) {
  if (n_rows == 0) return cudaSuccess;
  if (block_rows < 1) return cudaErrorInvalidValue;
  const long long n_blocks = (n_rows + block_rows - 1) / block_rows;
  if (n_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  spmv_ell_kernel<<<static_cast<unsigned>(n_blocks), block_threads(block_rows), 0,
                    static_cast<cudaStream_t>(stream)>>>(cols, vals, x, y, n_rows, k, n_x,
                                                         block_rows);
  return cudaGetLastError();
}

// cols, vals: (n_rows, k) row-major; x: (n_x,); y: (n_rows,); widths:
// (ceil(n_rows / block_rows),) int32, the slots each stripe reads (0 to k).
// Returns the launch's cudaError_t.
extern "C" int spmv_stripes_f32(const int* cols, const float* vals, const float* x, float* y,
                                const int* widths, long long n_rows, int k, long long n_x,
                                int block_rows, void* stream) {
  if (n_rows == 0) return cudaSuccess;
  if (block_rows < 1) return cudaErrorInvalidValue;
  const long long n_blocks = (n_rows + block_rows - 1) / block_rows;
  if (n_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  spmv_stripes_kernel<<<static_cast<unsigned>(n_blocks), block_threads(block_rows), 0,
                        static_cast<cudaStream_t>(stream)>>>(cols, vals, x, y, widths, n_rows, k,
                                                             n_x, block_rows);
  return cudaGetLastError();
}
