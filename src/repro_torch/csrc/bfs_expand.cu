// BFS on Hopper: one frontier-expansion round, and a whole search in one
// persistent cooperative launch built on the same expansion.
//
// Replaces the TPU kernel src/repro/kernels/bfs/kernel.py::_bfs_expand_kernel
// (launched by _bfs_expand_call, wrapped by bfs_expand_pallas), and, in
// bfs_search_kernel, the host round loop that calls it a level at a time
// (core/bfs.py::bfs_rounds, bfs_pallas's loop in the reference).
//
// The expansion (expand_rows): every frontier row s proposes itself as
// parent of each neighbour d with 0 <= d < N; the proposals are min-merged
// into proposals[d], which holds UNVISITED (INT32_MAX) first. Other entries
// (-1 padding, ids >= N) are dropped, as the TPU kernel's mode="drop"
// scatter does.
//
// Bound: device memory. A round must read the frontier mask (N bytes), the
// adjacency rows of the frontier vertices (n_frontier * K * 4 bytes) and
// write the proposals (N * 4 bytes). A whole search must read each reached
// vertex's adjacency row once and write the parents once: 0.0826 ms for the
// benchmark's scale-21 Erdos-Renyi graph at 3.35 TB/s. What keeps the large
// rounds above that bound is L2: every valid proposal is one scattered
// 4-byte atomic there. On an H100 (80GB HBM3, 700 W) the main path's largest
// round, about 21.7 M atomics, takes as long as its atomics alone, at about
// 72 G a second, whatever the kernel around them does
// (tools/bfs_expand_variants.py).
//
// Design of the expansion, against that bound:
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
//
// The search (bfs_search_kernel). Driven a level at a time from the host, a
// search waits on the card once a level for the frontier test and launches
// six operations a level; the card then idles through most of a search
// (about 70 % on the benchmark's graph). So the loop runs on the card: one
// grid, launched cooperatively (all its CTAs resident at once), of the
// expansion's CTAs at the occupancy of `block_rows`, each CTA walking over
// row blocks of `block_rows` rows. It stores the root, then a level is the
// expansion (expand_rows, the round kernel's own body), a grid barrier, one
// fused pass over the vertices that commits the new parents, writes the next
// frontier, resets the proposals and counts the newly reached vertices, a
// grid barrier, and the count read by every CTA: 0 ends the search, as
// `max_rounds` levels do. The merge is the same integer min, so the parents
// equal the host loop's bit for bit. The barrier is cooperative_groups'
// grid sync, which the cooperative launch makes safe and which builds
// without relocatable device code; it orders the phases' global writes
// before the next phase's reads.
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;  // 16 warps a CTA
constexpr int kMinBlocksPerSm = 4;  // 4 x 512 threads: the SM's 2048, at <= 32 registers
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kUnvisited = 0x7fffffff;  // INT32_MAX, core/bfs.py's UNVISITED

__device__ __forceinline__ void propose(int* proposals, int d, int s, unsigned n) {
  if (static_cast<unsigned>(d) < n) atomicMin(proposals + d, s);  // 0 <= d < n
}

// Expand the frontier rows among rows [row0, row0 + rows) into proposals,
// with this CTA's warps (the round kernel and the search share it).
__device__ __forceinline__ void expand_rows(const int* adj, const bool* frontier, int* proposals,
                                            unsigned n, unsigned p, unsigned vp, int k,
                                            unsigned row0, int rows) {
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
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

__global__ void __launch_bounds__(kMaxThreads, kMinBlocksPerSm)
bfs_expand_kernel(const int* __restrict__ adj, const bool* __restrict__ frontier,
                  int* proposals, unsigned n, unsigned p, unsigned vp, int k, int block_rows) {
  const unsigned row0 = blockIdx.x * static_cast<unsigned>(block_rows);
  expand_rows(adj, frontier, proposals, n, p, vp, k, row0,
              static_cast<int>(min(static_cast<unsigned>(block_rows), n - row0)));
}

// counts: 2 words, the newly reached count of the even and the odd levels.
// Level L adds into counts[L & 1] and, in block 0, clears counts[(L + 1) & 1]
// for level L + 1: every CTA read that word after level L - 1's second
// barrier, before it reached level L's first.
__global__ void __launch_bounds__(kMaxThreads, kMinBlocksPerSm)
bfs_search_kernel(const int* __restrict__ adj, int* parents, bool* frontier, int* proposals,
                  unsigned* counts, unsigned n, unsigned p, unsigned vp, int k, int block_rows,
                  int root, int max_rounds) {
  __shared__ unsigned warp_newly[kMaxThreads / 32];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned stride = gridDim.x * blockDim.x;
  const unsigned n_blocks = (n - 1) / static_cast<unsigned>(block_rows) + 1;
  for (unsigned v = tid; v < n; v += stride) {
    const bool is_root = v == static_cast<unsigned>(root);
    parents[v] = is_root ? root : kUnvisited;
    frontier[v] = is_root;
    proposals[v] = kUnvisited;
  }
  if (tid == 0) counts[0] = 0;
  grid.sync();
  for (int level = 0; level < max_rounds; ++level) {
    if (k > 0) {
      for (unsigned b = blockIdx.x; b < n_blocks; b += gridDim.x) {
        const unsigned row0 = b * static_cast<unsigned>(block_rows);
        expand_rows(adj, frontier, proposals, n, p, vp, k, row0,
                    static_cast<int>(min(static_cast<unsigned>(block_rows), n - row0)));
      }
    }
    grid.sync();
    unsigned newly = 0;
    for (unsigned v = tid; v < n; v += stride) {
      const int proposal = __ldcg(proposals + v);
      bool in = false;
      if (proposal != kUnvisited) {
        proposals[v] = kUnvisited;
        if (__ldcg(parents + v) == kUnvisited) {
          parents[v] = proposal;
          in = true;
        }
      }
      frontier[v] = in;
      newly += in;
    }
    newly = __reduce_add_sync(kFullMask, newly);
    if ((threadIdx.x & 31) == 0) warp_newly[threadIdx.x >> 5] = newly;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned total = 0;
      for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += warp_newly[w];
      if (total != 0) atomicAdd(counts + (level & 1), total);
      if (blockIdx.x == 0) counts[(level + 1) & 1] = 0;
    }
    grid.sync();
    if (__ldcg(counts + (level & 1)) == 0) break;
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

// The search's launch shape at a grain on the current device: threads a CTA
// and the most CTAs a cooperative launch may hold (resident CTAs an SM times
// the SMs). Returns the first failing call's cudaError_t.
extern "C" int bfs_search_shape(int block_rows, int* threads, int* max_ctas) {
  if (block_rows < 1) return cudaErrorInvalidValue;
  *threads = threads_for(block_rows);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bfs_search_kernel, *threads, 0);
  }
  *max_ctas = per_sm * sms;
  return err;
}

// A whole search from root, at most max_rounds levels, in one cooperative
// launch of ctas CTAs (at most bfs_search_shape's max_ctas). adj as for
// bfs_expand_i32; parents: (p * vp,) int32 out, UNVISITED where unreached;
// frontier (p * vp,) bool, proposals (p * vp,) int32 and counts (2,) uint32
// are the search's scratch, written before they are read. Nothing is
// allocated and nothing waits. Returns the launch's cudaError_t.
extern "C" int bfs_search_i32(const int* adj, int* parents, bool* frontier, int* proposals,
                              unsigned* counts, long long p, long long vp, int k, int block_rows,
                              long long root, long long max_rounds, int ctas, void* stream) {
  const long long n = p * vp;
  if (block_rows < 1 || p < 1 || vp < 1 || k < 0 || n > 0x7fffffffLL || root < 0 || root >= n ||
      max_rounds < 0 || ctas < 1) {
    return cudaErrorInvalidValue;
  }
  unsigned n_u = static_cast<unsigned>(n), p_u = static_cast<unsigned>(p);
  unsigned vp_u = static_cast<unsigned>(vp);
  int root_i = static_cast<int>(root);
  int rounds_i = static_cast<int>(max_rounds < 0x7fffffffLL ? max_rounds : 0x7fffffffLL);
  void* args[] = {&adj, &parents, &frontier, &proposals, &counts, &n_u, &p_u,
                  &vp_u, &k, &block_rows, &root_i, &rounds_i};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(bfs_search_kernel), dim3(ctas),
                                     dim3(threads_for(block_rows)), args, 0,
                                     static_cast<cudaStream_t>(stream));
}
