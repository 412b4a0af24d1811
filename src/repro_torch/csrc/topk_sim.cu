// Fused GSANA similarity + top-k for Hopper.
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
// peak rates; at a coarse grid's buckets (hundreds of valid rows a side)
// the operations bound it.
//
// Two instances, chosen by shape. Both use 256 threads (8 warps), score only
// compacted valid rows (a warp per row loads one, coalesced, by cp.async, so
// that every copy is in flight at once), and let a warp score a group of v
// rows against the valid u rows, lane `l` taking u rows l, l + 32, ...: each
// u value it loads serves every row of the group, and the v value is a
// broadcast. The histograms are read 16 bytes at a time: rows are shifted
// so that they start on a 16-byte boundary, and the row stride is an odd
// number of 16-byte units, so the lanes of a quarter-warp hit distinct
// banks. Scores stay in registers and select on an order-preserving integer
// key (keys compare as the floats do, -inf lowest, whatever their sign).
// - Narrow (B <= 64, the main path): one block a task holds both compacted
//   tiles in shared memory (about 46 KB at a bucket cap of 53 and F = 101,
//   so 4 blocks, 32 warps, fit an SM); a v row that is not valid gets its k
//   results (-inf, slot 0) at once. A lane holds 2 u rows (1 in a task with
//   at most 32 valid u rows). Top-k is k rounds of one integer warp max and
//   a ballot for the lowest slot holding it; the winner's lane then sets
//   that key to that of -inf. Compaction keeps the slots in order, and a row
//   whose valid slots are used up meets -inf everywhere and takes slot 0 at
//   -inf, exactly as the TPU kernel's argmax over an all -inf row does.
// - Wide (any A and B, F up to 1441 scored columns): a block takes 64 v rows
//   of a task and streams the u slots through shared memory 64 at a time,
//   merging each chunk into running top-k lists (topk_sim_wide_kernel), so
//   shared memory no longer grows with the bucket and a large task spreads
//   over A / 64 blocks. (On an H100, GSANA's 574-slot buckets took 15.9 ms
//   at 8 v rows a warp and 2 u rows a lane, 17.4 ms at 4 and 4, 18.3 ms at
//   4 and 2: tools/flash_topk_variants.py.)
// The TPU kernel kept its running top-k in VMEM; here it stays in registers
// (narrow) or in the row's own outputs (wide).
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
// the largest dynamic shared memory a block may have (227 KB)
constexpr size_t MAX_SHARED = 232448;
// the wide instance keeps its running top-k lists in shared memory up to
// this k (16 KB for 32 rows) where they fit, else in device memory
constexpr int LIST_K_MAX = 64;

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

// The five-term sums s (the score over 0.2) of v rows a0 + WARPS * r
// (r < n_rows <= R) of sv against the nu valid u rows of su, up to J per
// lane: lane l holds u rows l + 32 j (j < nj; a row past nu reads the last
// one). J * 32 >= nu.
template <int J, int R>
__device__ __forceinline__ void pair_sums(float (&s)[R][J], const float* su, const float* sv,
                                          int ld, int nu, int nj, int a0, int n_rows, int t1,
                                          int t2, int t3) {
  const int lane = threadIdx.x % 32;
  int u[J];  // offsets of the lane's u rows (a row past nu reads the last one)
#pragma unroll
  for (int j = 0; j < J; ++j) u[j] = max(min(lane + 32 * j, nu - 1), 0) * ld;
  int v[R];  // offsets of the group's v rows
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = (a0 + WARPS * min(r, n_rows - 1)) * ld;
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
}

// Score v rows a0 + WARPS * r (r < n_rows <= R) of sv against the nu valid
// u rows, up to J per lane, and write each row's top k. J * 32 >= nu.
template <int J, int R>
__device__ __forceinline__ void score_rows(const float* su, const float* sv, int ld, int nu,
                                           const int* uslot, const int* vrow, int a0, int n_rows,
                                           int t1, int t2, int t3, int k, float* out_s,
                                           int* out_i) {
  const int lane = threadIdx.x % 32;
  // the u rows a lane scores, the same in every lane: all J (bounds known at
  // compile time keep this instance faster than one read at run time would)
  const int nj = J;
  float s[R][J];
  pair_sums<J, R>(s, su, sv, ld, nu, nj, a0, n_rows, t1, t2, t3);
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

// The narrow instance, B <= 64: one block a task, both compacted tiles in
// shared memory. J = u rows per lane (B <= 32 * J), R = v rows per warp and
// group.
template <int J, int R>
__global__ void __launch_bounds__(THREADS, 4)
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

// Insert (key, slot) into a row's running top k: row_s / row_i (in shared
// or device memory) hold k entries sorted by key, highest first, and the new
// entry goes after every entry whose key is at least its own (those came
// from lower slots), pushing the last one out. Warp-wide, 32 entries a
// step. Returns the new last key.
__device__ __forceinline__ int insert_sorted(float* row_s, int* row_i, int k, int key, int slot) {
  const int lane = threadIdx.x % 32;
  int pos = 0;  // entries that stay ahead of the new one
  for (int base = 0; base < k; base += 32) {
    const int i = base + lane;
    const unsigned ge =
        __ballot_sync(0xffffffffu, i < k && flip_key(__float_as_int(row_s[i])) >= key);
    pos += __popc(ge);
    if (ge != 0xffffffffu) break;  // sorted: the first entry below the key ends the run
  }
  float carry_s = 0.0f;  // entry base - 1, which moves to base
  int carry_i = 0;
  for (int base = pos / 32 * 32; base < k; base += 32) {
    const int i = base + lane;
    const float old_s = i < k ? row_s[i] : 0.0f;
    const int old_i = i < k ? row_i[i] : 0;
    float up_s = __shfl_up_sync(0xffffffffu, old_s, 1);
    int up_i = __shfl_up_sync(0xffffffffu, old_i, 1);
    if (lane == 0) up_s = carry_s, up_i = carry_i;
    carry_s = __shfl_sync(0xffffffffu, old_s, 31);
    carry_i = __shfl_sync(0xffffffffu, old_i, 31);
    __syncwarp();  // every lane has read its entry before any is written
    if (i < k && i >= pos) {
      row_s[i] = i == pos ? __int_as_float(flip_key(key)) : up_s;
      row_i[i] = i == pos ? slot : up_i;
    }
  }
  __syncwarp();  // the writes are seen by every lane
  return flip_key(__float_as_int(row_s[k - 1]));
}

// The wide instance: any A and B. A block takes a group of VG = WARPS * R
// v rows of one task (grid y is the group) and streams the task's u slots
// through shared memory in chunks of CU = 32 * J slots, in slot order: the
// chunk's valid u rows are compacted and loaded, every valid v row of the
// group is scored against them (J u rows a lane, R v rows a warp), and the
// chunk's candidates are merged into each row's running top k. The lists
// start as (-inf, slot 0): what a row takes once its valid slots run out,
// as the TPU kernel's argmax over an all -inf row does. A candidate enters
// only with a key strictly above the list's last, and lands behind every
// entry with an equal key, so ties keep the lowest slot first across chunk
// edges. The lists live in shared memory where they fit (k <= LIST_K_MAX)
// and are copied out at the end; else they live in the rows' own outputs,
// so k is not capped. Shared memory holds VG + CU rows and the
// lists, whatever A and B are.
template <int J, int R>
__global__ void __launch_bounds__(THREADS, 2)
topk_sim_wide_kernel(const float* __restrict__ feat_v, const float* __restrict__ feat_u,
                     const float* __restrict__ mask_v, const float* __restrict__ mask_u,
                     float* __restrict__ scores, int* __restrict__ idx, int a_rows, int b_rows,
                     int f, int ld, int t1, int t2, int t3, int k, bool shared_lists) {
  constexpr int VG = WARPS * R, CU = 32 * J;
  extern __shared__ float smem[];
  float* sv = smem;                                     // (VG, ld) the group's valid v rows
  float* su = sv + VG * ld;                             // (CU, ld) the chunk's valid u rows
  int* vrow = reinterpret_cast<int*>(su + CU * ld);     // compacted -> v row
  int* uslot = vrow + VG;                               // compacted -> u slot
  float* list_s = reinterpret_cast<float*>(uslot + CU);  // (VG, k) running top k, if shared
  int* list_i = reinterpret_cast<int*>(list_s + VG * k);
  __shared__ int n_valid[2];
  const long long p = blockIdx.x;
  const int a_lo = blockIdx.y * VG, a_hi = min(a_lo + VG, a_rows);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* out_s = scores + p * a_rows * k;
  int* out_i = idx + p * a_rows * k;
  const int width = 5 + t1 + t2 + t3;  // the columns the score reads
  const float* gu = feat_u + p * b_rows * f;
  const float* gv = feat_v + p * a_rows * f;
  const float* mu = mask_u + p * b_rows;

  for (long long e = threadIdx.x; e < static_cast<long long>(a_hi - a_lo) * k; e += THREADS) {
    out_s[a_lo * static_cast<long long>(k) + e] = -INFINITY;
    out_i[a_lo * static_cast<long long>(k) + e] = 0;
    if (shared_lists) list_s[e] = -INFINITY, list_i[e] = 0;
  }
  if (warp == 0) {  // the group's valid v rows, in order
    int count = 0;
    for (int base = a_lo; base < a_hi; base += 32) {
      const int i = base + lane;
      const bool ok = i < a_hi && mask_v[p * a_rows + i] > 0.0f;
      const unsigned ballot = __ballot_sync(0xffffffffu, ok);
      if (ok) vrow[count + __popc(ballot & ((1u << lane) - 1))] = i;
      count += __popc(ballot);
    }
    if (lane == 0) n_valid[1] = count;
  }
  __syncthreads();
  const int nv = n_valid[1];
  if (nv == 0) return;
  for (int i = warp; i < nv; i += WARPS)  // waited for with the first chunk
    for (int c = lane; c < width; c += 32) copy_async(sv + i * ld + SHIFT + c, gv + vrow[i] * f + c);
  const int n_rows = min(R, (nv - warp + WARPS - 1) / WARPS);  // this warp's v rows

  for (int c0 = 0; c0 < b_rows; c0 += CU) {
    if (warp == 0) {  // the chunk's valid u slots, in order
      int count = 0;
      for (int base = c0; base < min(c0 + CU, b_rows); base += 32) {
        const int i = base + lane;
        const bool ok = i < b_rows && mu[i] > 0.0f;
        const unsigned ballot = __ballot_sync(0xffffffffu, ok);
        if (ok) uslot[count + __popc(ballot & ((1u << lane) - 1))] = i;
        count += __popc(ballot);
      }
      if (lane == 0) n_valid[0] = count;
    }
    __syncthreads();
    const int nu = n_valid[0];
    for (int i = warp; i < nu; i += WARPS)
      for (int c = lane; c < width; c += 32) copy_async(su + i * ld + SHIFT + c, gu + uslot[i] * f + c);
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();

    if (nu > 0 && n_rows > 0) {
      // every lane scores all J u rows and all R v rows, bounds known at
      // compile time: no test in the inner loops, and the pairs past the
      // chunk's valid u rows or the warp's v rows (which read rows of
      // shared memory that hold no valid row) get the key of -inf
      float s[R][J];
      pair_sums<J, R>(s, su, sv, ld, nu, J, warp, R, t1, t2, t3);
      const int neg_key = flip_key(__float_as_int(-INFINITY));
      int keys[R][J];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < J; ++j)
          keys[r][j] = r < n_rows && lane + 32 * j < nu ? flip_key(__float_as_int(0.2f * s[r][j]))
                                                         : neg_key;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= n_rows) break;
        const int a = vrow[warp + WARPS * r];
        float* row_s = shared_lists ? list_s + (a - a_lo) * k : out_s + static_cast<long long>(a) * k;
        int* row_i = shared_lists ? list_i + (a - a_lo) * k : out_i + static_cast<long long>(a) * k;
        int last = flip_key(__float_as_int(row_s[k - 1]));
        for (;;) {  // the chunk's best candidates, best first, while one beats the list's last
          int best = keys[r][0];
#pragma unroll
          for (int j = 1; j < J; ++j) best = max(best, keys[r][j]);
          best = __reduce_max_sync(0xffffffffu, best);
          if (best <= last) break;
          int pos = 0;  // the lowest compacted slot holding it
#pragma unroll
          for (int j = J - 1; j >= 0; --j) {
            const unsigned holders = __ballot_sync(0xffffffffu, keys[r][j] == best);
            if (holders) pos = 32 * j + __ffs(holders) - 1;
          }
#pragma unroll
          for (int j = 0; j < J; ++j)
            if (pos == lane + 32 * j) keys[r][j] = neg_key;
          last = insert_sorted(row_s, row_i, k, best, uslot[pos]);
        }
      }
    }
    __syncthreads();  // the chunk is scored before the next one replaces it
  }
  if (shared_lists)
    for (int e = threadIdx.x; e < (a_hi - a_lo) * k; e += THREADS) {
      out_s[a_lo * static_cast<long long>(k) + e] = list_s[e];
      out_i[a_lo * static_cast<long long>(k) + e] = list_i[e];
    }
}

size_t narrow_shared(int a_rows, int b_rows, int ld) {
  return sizeof(float) * static_cast<size_t>(a_rows + b_rows) * ld +
         sizeof(int) * static_cast<size_t>(a_rows + b_rows);
}

template <int J, int R>
size_t wide_shared(int ld, int k, bool shared_lists) {
  const size_t lists = shared_lists ? (sizeof(float) + sizeof(int)) * WARPS * R * k : 0;
  return (sizeof(float) * ld + sizeof(int)) * (WARPS * R + 32 * J) + lists;
}

template <int J, int R>
int launch(const float* feat_v, const float* feat_u, const float* mask_v, const float* mask_u,
           float* scores, int* idx, long long n_tasks, int a_rows, int b_rows, int f, int ld,
           int t1, int t2, int t3, int k, cudaStream_t stream) {
  const size_t shared = narrow_shared(a_rows, b_rows, ld);
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

template <int J, int R>
int launch_wide(const float* feat_v, const float* feat_u, const float* mask_v,
                const float* mask_u, float* scores, int* idx, long long n_tasks, int a_rows,
                int b_rows, int f, int ld, int t1, int t2, int t3, int k, bool shared_lists,
                cudaStream_t stream) {
  const size_t shared = wide_shared<J, R>(ld, k, shared_lists);
  const long long groups = (a_rows + WARPS * R - 1) / (WARPS * R);
  if (groups > 65535) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(topk_sim_wide_kernel<J, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(n_tasks), static_cast<unsigned>(groups));
  topk_sim_wide_kernel<J, R><<<grid, THREADS, shared, stream>>>(
      feat_v, feat_u, mask_v, mask_u, scores, idx, a_rows, b_rows, f, ld, t1, t2, t3, k,
      shared_lists);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// feat_v: (P, A, F), feat_u: (P, B, F), mask_v: (P, A), mask_u: (P, B), all
// float32 row-major; scores: (P, A, k) float32, idx: (P, A, k) int32. Any
// A, B >= 1 and k (k > B included); the scored columns 5 + t1 + t2 + t3 at
// most 1441 (shared memory holds 40 rows of them). Returns the launch's
// cudaError_t.
extern "C" int topk_sim_f32(const float* feat_v, const float* feat_u, const float* mask_v,
                            const float* mask_u, float* scores, int* idx, long long n_tasks,
                            int a_rows, int b_rows, int f, int t1, int t2, int t3, int k,
                            void* stream) {
  if (n_tasks == 0 || a_rows == 0 || k == 0) return cudaSuccess;
  const int width = 5 + t1 + t2 + t3;
  if (b_rows < 1 || k < 0 || width > f || n_tasks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // a multiple of 4 floats that is an odd number of 16-byte units: the 8
  // lanes of a quarter-warp reading 16 bytes of 8 u rows hit distinct banks
  const int ld = (width + SHIFT + 3) / 8 * 8 + 4;
  auto s = static_cast<cudaStream_t>(stream);
  if (b_rows <= 64 && narrow_shared(a_rows, b_rows, ld) <= MAX_SHARED)
    return launch<2, 6>(feat_v, feat_u, mask_v, mask_u, scores, idx, n_tasks, a_rows, b_rows, f,
                        ld, t1, t2, t3, k, s);
  // the widest instance that fits, its lists in shared memory where they fit
  for (int pass = 0; pass < 2; ++pass) {
    const bool lists = pass == 0 && k <= LIST_K_MAX;
    if (wide_shared<2, 8>(ld, k, lists) <= MAX_SHARED)
      return launch_wide<2, 8>(feat_v, feat_u, mask_v, mask_u, scores, idx, n_tasks, a_rows,
                               b_rows, f, ld, t1, t2, t3, k, lists, s);
    if (wide_shared<1, 1>(ld, k, lists) <= MAX_SHARED)
      return launch_wide<1, 1>(feat_v, feat_u, mask_v, mask_u, scores, idx, n_tasks, a_rows,
                               b_rows, f, ld, t1, t2, t3, k, lists, s);
  }
  return cudaErrorInvalidValue;
}
