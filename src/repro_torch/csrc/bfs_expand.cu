// One BFS frontier-expansion round for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/bfs/kernel.py::_bfs_expand_kernel
// (launched by _bfs_expand_call, wrapped by bfs_expand_pallas).
//
// Every frontier row s proposes itself as parent of each valid neighbour d;
// the proposals are min-merged into proposals[d], which the caller fills
// with UNVISITED (INT32_MAX) first.
//
// Bound: device memory. A round must read the frontier mask (N bytes), the
// adjacency rows of the frontier vertices (n_frontier * K * 4 bytes) and
// write the proposals (N * 4 bytes). Rows outside the frontier cost only
// their mask byte: their adjacency is never read.
//
// Design: one thread per (row, slot); `block_rows` (the strategy's grain)
// sets the rows one CUDA block owns. The TPU kernel kept one private
// partial per program and min-merged it into a revisited output block,
// which relies on the grid running in order; Hopper's blocks run in any
// order, so every proposal goes straight to global memory with an integer
// atomicMin. Min is commutative and associative, so the result, and with it
// the BFS parent tree, is bit-identical whatever order the atomics land in.
#include <cuda_runtime.h>

namespace {

__global__ void bfs_expand_kernel(const int* __restrict__ adj, const bool* __restrict__ frontier,
                                  int* __restrict__ proposals, long long n, int k,
                                  int block_rows) {
  const long long row0 = static_cast<long long>(blockIdx.x) * block_rows;
  const long long rows = min(static_cast<long long>(block_rows), n - row0);
  const long long items = rows * k;
  for (long long i = threadIdx.x; i < items; i += blockDim.x) {
    const long long row = row0 + i / k;
    if (!frontier[row]) continue;
    const int d = adj[row0 * k + i];
    if (d >= 0 && d < n) atomicMin(proposals + d, static_cast<int>(row));
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// adj: (n, k) row-major, -1 padding; frontier: (n,) bool; proposals: (n,)
// int32, pre-filled with INT32_MAX. Returns the launch's cudaError_t.
extern "C" int bfs_expand_i32(const int* adj, const bool* frontier, int* proposals,
                              long long n, int k, int block_rows, void* stream) {
  if (n == 0 || k == 0) return cudaSuccess;
  if (block_rows < 1 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long n_blocks = (n + block_rows - 1) / block_rows;
  bfs_expand_kernel<<<static_cast<unsigned>(n_blocks), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(adj, frontier, proposals, n, k,
                                                           block_rows);
  return cudaGetLastError();
}
