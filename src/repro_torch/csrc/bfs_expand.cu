// One BFS frontier-expansion round for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/bfs/kernel.py::_bfs_expand_kernel
// (launched by _bfs_expand_call, wrapped by bfs_expand_pallas).
//
// Every frontier row s proposes itself as parent of each neighbour d with
// 0 <= d < N; the proposals are min-merged into proposals[d], which the
// caller fills with UNVISITED (INT32_MAX) first. Other entries (-1 padding,
// ids >= N) are dropped, as the TPU kernel's mode="drop" scatter does.
//
// Bound: device memory. A round must read the frontier mask (N bytes), the
// adjacency rows of the frontier vertices (n_frontier * K * 4 bytes) and
// write the proposals (N * 4 bytes). What keeps the large rounds above that
// bound is L2: every valid proposal is one scattered 4-byte atomic there.
// On an H100 (80GB HBM3, 700 W) the main path's largest round, about 21.7 M
// atomics, takes as long as its atomics alone, at about 72 G a second,
// whatever the kernel around them does (tools/bfs_expand_variants.py).
//
// Design, against that bound:
// 1. Frontier first, no division per slot. A warp owns groups of 32
//    consecutive rows: one coalesced 32-byte load of their mask bytes, one
//    __ballot_sync, and the warp visits only the set rows (__ffs over the
//    ballot). A row outside the frontier costs its mask byte and nothing
//    else. A set row's K slots are read by the whole warp, neighbouring
//    lanes on neighbouring addresses, as 8-byte pairs (one pair a lane at
//    K = 66, plus one lane's second pair); a row whose base is only 4-byte
//    aligned peels its first slot and an odd count its last, each taken by
//    one lane as a 4-byte load. The row's address is computed once per row
//    in 32-bit integers; the loop over slots holds no division or modulo.
// 2. Occupancy follows the card, not the grain. `block_rows` (the
//    strategy's grain) stays the rows one CTA owns; the CTA has one warp
//    per 32-row group up to 16 warps (512 threads), and its warps split the
//    groups. At the main path's grain (2048 rows, 512 CTAs) 4 CTAs of 512
//    threads fit on an SM (at most 32 registers a thread, held by
//    __launch_bounds__), so all 512 CTAs are resident at once: 64 warps an
//    SM on 128 of the 132 SMs. bfs_expand_occupancy reports the figure.
// 3. One atomic per valid proposal, fire and forget. Reading proposals[d]
//    first and skipping the atomic when it already holds <= s is exact
//    (values only fall, so a stale read costs an atomic, never a wrong
//    skip), but it was slower in the large rounds of the main path on an
//    H100: the read is a round trip through L2 that the warp waits for,
//    while an atomic whose result is unused (RED) is not, and the reads
//    alone take most of the atomics' time.
// 4. Adjacency read in place. The kernel takes the graph's own (P, V_p, K)
//    nodelet-major planes: global row v lies at plane v % P, slot v / P. A
//    row-major (N, K) adjacency is the P = 1 case of the same kernel.
//
// Hopper's CTAs run in no order, so there is no per-program partial to
// carry as on the TPU: every proposal goes straight to global memory. Min is
// commutative and associative, so the result, and with it the BFS parent
// tree, is bit-identical whatever order the atomics land in.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;  // 16 warps a CTA
constexpr int kMinBlocksPerSm = 4;  // 4 x 512 threads: the SM's 2048, at <= 32 registers
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void propose(int* proposals, int d, int s, unsigned n) {
  if (static_cast<unsigned>(d) < n) atomicMin(proposals + d, s);  // 0 <= d < n
}

__global__ void __launch_bounds__(kMaxThreads, kMinBlocksPerSm)
bfs_expand_kernel(const int* __restrict__ adj, const bool* __restrict__ frontier,
                  int* proposals, unsigned n, unsigned p, unsigned vp, int k, int block_rows) {
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const unsigned row0 = blockIdx.x * static_cast<unsigned>(block_rows);
  const int rows = static_cast<int>(min(static_cast<unsigned>(block_rows), n - row0));
  for (int g = (threadIdx.x >> 5) * 32; g < rows; g += n_warps * 32) {
    const bool in = g + lane < rows && frontier[row0 + g + lane];
    for (unsigned set = __ballot_sync(kFullMask, in); set != 0; set &= set - 1) {
      const unsigned v = row0 + g + (__ffs(set) - 1);
      const unsigned slot = v / p;  // once per frontier row, 32-bit
      const int* row = adj + (static_cast<size_t>(v - slot * p) * vp + slot) * k;
      const int head = static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 2) & 1);
      const int pairs = (k - head) >> 1;
      const int2* row2 = reinterpret_cast<const int2*>(row + head);
      const int s = static_cast<int>(v);
      for (int j = lane; j < pairs; j += 32) {
        const int2 d = __ldcs(row2 + j);  // read once: streamed past L1
        propose(proposals, d.x, s, n);
        propose(proposals, d.y, s, n);
      }
      if (lane == 31 && head) propose(proposals, __ldcs(row), s, n);
      if (lane == 30 && ((k - head) & 1)) propose(proposals, __ldcs(row + k - 1), s, n);
    }
  }
}

int threads_for(int block_rows) {
  const int warps = block_rows / 32 + (block_rows % 32 != 0);
  return 32 * min(warps, kMaxThreads / 32);
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// adj: (p, vp, k) contiguous, -1 padding, global row v at plane v % p, slot
// v / p; p = 1 is a row-major (vp, k) adjacency. frontier: (p * vp,) bool;
// proposals: (p * vp,) int32, pre-filled with INT32_MAX. Returns the
// launch's cudaError_t.
extern "C" int bfs_expand_i32(const int* adj, const bool* frontier, int* proposals, long long p,
                              long long vp, int k, int block_rows, void* stream) {
  const long long n = p * vp;
  if (n == 0 || k == 0) return cudaSuccess;
  if (block_rows < 1 || p < 1 || vp < 1 || k < 0 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long n_blocks = (n + block_rows - 1) / block_rows;
  bfs_expand_kernel<<<static_cast<unsigned>(n_blocks), threads_for(block_rows), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      adj, frontier, proposals, static_cast<unsigned>(n), static_cast<unsigned>(p),
      static_cast<unsigned>(vp), k, block_rows);
  return cudaGetLastError();
}

// The launch shape at a grain: threads a CTA and CTAs resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns its cudaError_t.
extern "C" int bfs_expand_occupancy(int block_rows, int* threads, int* blocks_per_sm) {
  if (block_rows < 1) return cudaErrorInvalidValue;
  *threads = threads_for(block_rows);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, bfs_expand_kernel, *threads, 0);
}
