// Packed-bitmap label propagation, CUDA C++ for sm_90a.  Four kernels
// over the sweep's (R rows x W words) LSB-first adjacency slab; the slab
// is never unpacked to memory.
//
// label_prop_rect — replaces repro/kernels/label_prop/kernel.py:104
//   `label_prop_rect_pallas` (body `_label_prop_kernel` :41):
//     out[i] = min(row_labels[i], min over set bits j of row i of col_labels[j])
//   Bound: bytes — each round reads the slab once (4*R*W) plus the
//   label vectors.  Beside them, one label gather per set bit: the main
//   path's slab is ~2% dense, 11.0 M gathers a round.
//   Design: persistent blocks, one an SM (1,024 threads), read the
//   flag before anything else, so an idle round is 132 blocks that exit.
//   A block stages col_labels in shared memory (122 KB at W = 952;
//   where 4*32*W bytes do not fit, the gathers go to global memory
//   through L1 instead), with its first slab loads already in flight.
//   Its rows are blockIdx.x + i*gridDim.x, so the slab's dense rows
//   (on the main path a tenth of the rows hold ~1,976 bits, the median
//   295) spread over the blocks.  The work unit is 256 words of a row,
//   two 16-byte loads a lane; a warp claims its next unit from a
//   shared counter one unit ahead and issues its loads before walking
//   the current one, so no warp is left with a run of dense rows.  A
//   lane walks its 8 words' set bits, each gather's min taken one bit
//   later so that the shared-memory load is not waited on at once; a
//   shuffle tree takes the warp's min and one shared atomicMin folds it
//   into the row's; out[i] is written once the block's rows are done.
//   The TPU grid's sequential word-tile axis becomes the units of a row.
//
// col_reduce — replaces repro/kernels/label_prop/kernel.py:173
//   `col_reduce_pallas` (body `_col_reduce_kernel` :140):
//     col_min[j] = min of row_vals[i] over rows i with bit (i, j) set
//                  (INT32_MAX if none)
//     col_sum[j] = sum of row_weights[i] over the same rows
//   Bound: bytes — one read of the slab; beside it, a min and an add per
//   set bit.  Design: a block (32 warps) owns a tile of 128 words (4,096
//   columns) over a tall chunk of rows, sized so that two blocks an SM
//   (the most threads an SM holds) cover the slab, and keeps the tile's
//   min and sum in shared memory (a word's 32 columns at stride 33,
//   which spreads the lanes' banks).  A warp reads a row of the tile at
//   a time, one 16-byte load a lane (the next row's load issued before
//   the current one is worked), lists the nonzero words in shared memory
//   by a warp prefix sum (branch-free: a lane's 4 words are known at
//   compile time) and deals them to its lanes, which walk each word's
//   set bits into the accumulators with shared atomicMin / atomicAdd.
//   So the work follows the set bits and no lane's dense words set the
//   warp's pace.  On probe builds, walking each lane's own words,
//   claiming rows dynamically as K2 does, and fewer warps an SM were all
//   slower: the walk is bound by latency, which more warps hide.
//   Rows whose value is INT32_MAX and whose weight is 0 change nothing
//   and are skipped.  Each block then adds its tile into col_min /
//   col_sum with one atomicMin and one atomicAdd per touched column
//   (integers, so exact in any order) in place of the TPU's sequential
//   row-tile accumulation.
//
// Both kernels take 16-byte loads where W % 4 == 0 and the slab is
// 16-byte aligned, 4-byte loads of the same words otherwise.
//
// label_prop_update — the per-round scatter-min + pointer jump of
//   repro/kernels/label_prop/ops.py:211-214 (jnp inside the reference's
//   lax.while_loop, no Pallas kernel).  `pos[x]` is the slab row of core
//   column x (-1 otherwise), so the scattered value of any column is
//   computed where it is read and pointer jumping needs no second pass:
//     new(x)  = pos[x] >= 0 ? min(lab[x], m[pos[x]]) : lab[x]
//     out[j]  = new(j) < cap ? min(new(j), new(new(j))) : new(j)
//   Bound: bytes (a few label-vector passes).  Reads `lab`, writes the
//   other buffer, so results equal the reference's round exactly.
//
// The one-sync fixpoint: label_prop_fixpoint (below) runs every round of
// K2 + update in one cooperative launch, grid barriers between the
// steps; a round writes flags[it+1] = 1 when a label changed and the loop
// ends at a 0.  The per-round kernels read flags[it] and return at once
// when it is 0, for callers that enqueue rounds themselves.  The host
// never reads a flag.
//
// Telemetry (repro/obs/device.py's per-round vectors, computed in jnp
// inside the reference's while loop at ops.py:198-248): with a non-null
// `tele` (int32, 4 rows of `tele_stride` rounds) the update kernel adds
// round `it`'s counts into column `it` (the fixpoint kernel counts alike):
//   frontier   = core columns whose gathered m[pos[j]] < lab[j]
//   changed    = columns with jumped != lab[j]
//   hops       = columns with jumped < new(j)
//   shard_wins = frontier (one device: every gather win is a frontier row)
// The reference counts frontier per core slab row; this counts it per
// core column through pos, which is the same number when slab rows are
// unique, as they are for every caller.  Each count is reduced in the
// block (__syncthreads_count) and added with one atomicAdd per block and
// field.  A round whose flag is 0 returns before counting, so the slots
// after the fixpoint stay 0.  A null `tele` launches the TELE = false
// instantiation, the kernel as it was without telemetry.

#include <algorithm>
#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Words w .. w+3 of a slab row (0 past W): one 16-byte load where VEC
// (W % 4 == 0 and an aligned slab, so the four are in or out together).
template <bool VEC>
__device__ __forceinline__ uint4 load4(const uint32_t* __restrict__ row, int w, int W) {
  if (VEC)
    return w < W ? __ldcs(reinterpret_cast<const uint4*>(row + w)) : make_uint4(0u, 0u, 0u, 0u);
  uint4 q;
  q.x = w < W ? __ldcs(row + w) : 0u;
  q.y = w + 1 < W ? __ldcs(row + w + 1) : 0u;
  q.z = w + 2 < W ? __ldcs(row + w + 2) : 0u;
  q.w = w + 3 < W ? __ldcs(row + w + 3) : 0u;
  return q;
}

__device__ __forceinline__ uint32_t nonzero4(const uint4& q) {
  return (uint32_t)(q.x != 0u) | (uint32_t)(q.y != 0u) << 1 | (uint32_t)(q.z != 0u) << 2 |
         (uint32_t)(q.w != 0u) << 3;
}

__device__ __forceinline__ uint32_t pick4(const uint4& q, int k) {
  const uint32_t lo = (k & 1) ? q.y : q.x, hi = (k & 1) ? q.w : q.z;
  return (k & 2) ? hi : lo;
}

constexpr int kRectThreads = 1024;   // one block an SM
constexpr int kRectStage = 256;      // words of a work unit: 2 uint4 a lane
constexpr int kRectBatch = 1024;     // rows a block takes at a time

// Label reads.  K2 alone reads labels that no kernel writes while it
// runs, through the read-only path; the fixpoint reads labels (and m,
// and flags) that the same launch wrote a grid barrier earlier, so
// through L2 (ld.global.cg), which is coherent across SMs: the read-only
// path and L1 may hold a line from an earlier round.
template <bool LIVE>
__device__ __forceinline__ int ld_label(const int* p) { return LIVE ? __ldcg(p) : __ldg(p); }

template <bool LIVE>
__device__ __forceinline__ int4 ld_label4(const int4* p) { return LIVE ? __ldcg(p) : __ldg(p); }

// K2's body over the block's rows: out[i] = min(row label, the min of
// col_labels over row i's set bits), a null row_labels meaning INT32_MAX
// rows.  The block state (s_next, s_rowmin and the staged labels) is set
// here, so each call, and each round of the fixpoint, starts afresh.
template <bool VEC, bool SMEM, bool LIVE>
__device__ __forceinline__ void rect_rows(
    const int* row_labels, const int* col_labels, const uint32_t* __restrict__ bitmap,
    int R, int W, int* out, int4* s_lab4, int* s_rowmin, int* s_next) {
  const int* s_lab = reinterpret_cast<const int*>(s_lab4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWarps = kRectThreads / 32;
  const int G = gridDim.x;
  const int S = max(1, (W + kRectStage - 1) / kRectStage);   // units a row
  // the block's rows are blockIdx.x + i G: dense rows spread over blocks
  const int rows_b = (int)blockIdx.x < R ? (R - 1 - (int)blockIdx.x) / G + 1 : 0;
  uint4 nxt[2];
  auto fetch = [&](int b0, int u) {
    const uint32_t* words = bitmap + (size_t)(blockIdx.x + (size_t)(b0 + u / S) * G) * W;
    const int w0 = (u % S) * kRectStage + lane * 4;
    nxt[0] = load4<VEC>(words, w0, W);
    nxt[1] = load4<VEC>(words, w0 + 128, W);
  };
  for (int b0 = 0; b0 < rows_b; b0 += kRectBatch) {
    const int nb = min(kRectBatch, rows_b - b0), units = nb * S;
    int u = warp;  // a warp's first unit; later ones are claimed from s_next
    if (u < units) fetch(b0, u);
    if (SMEM && b0 == 0) {  // the first units' loads are in flight meanwhile
      int4* dst = s_lab4;
      const int n4 = W * 8;  // W * 32 labels, four a load
      if ((reinterpret_cast<uintptr_t>(col_labels) & 15) == 0) {
        const int4* src = reinterpret_cast<const int4*>(col_labels);
        for (int i = threadIdx.x; i < n4; i += kRectThreads) dst[i] = ld_label4<LIVE>(src + i);
      } else {
        int* d = reinterpret_cast<int*>(dst);
        for (int i = threadIdx.x; i < 4 * n4; i += kRectThreads) d[i] = ld_label<LIVE>(col_labels + i);
      }
    }
    for (int i = threadIdx.x; i < nb; i += kRectThreads) s_rowmin[i] = INT_MAX;
    if (threadIdx.x == 0) *s_next = kWarps;
    __syncthreads();
    int claimed = 0;  // lane 0's claim of the unit after next, read one unit later
    if (lane == 0) claimed = atomicAdd(s_next, 1);
    while (u < units) {
      const uint4 cur[2] = {nxt[0], nxt[1]};
      const int cu = u;
      u = __shfl_sync(0xffffffffu, claimed, 0);
      if (u < units) fetch(b0, u);
      if (lane == 0) claimed = atomicAdd(s_next, 1);
      const int cw0 = (cu % S) * kRectStage;
      int m = INT_MAX, last = INT_MAX;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        uint32_t word = pick4(cur[k >> 2], k & 3);
        const int base = (cw0 + lane * 4 + (k & 3) + 128 * (k >> 2)) * 32;
        while (word) {
          const int j = base + __ffs(word) - 1;
          word &= word - 1;
          m = min(m, last);
          last = SMEM ? s_lab[j] : ld_label<LIVE>(col_labels + j);
        }
      }
      m = warp_min(min(m, last));
      if (lane == 0 && m != INT_MAX) atomicMin(&s_rowmin[cu / S], m);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nb; i += kRectThreads) {
      const int r = blockIdx.x + (b0 + i) * G;
      out[r] = row_labels != nullptr ? min(ld_label<LIVE>(row_labels + r), s_rowmin[i]) : s_rowmin[i];
    }
    __syncthreads();
  }
}

template <bool VEC, bool SMEM>
__global__ void __launch_bounds__(kRectThreads, 1) label_prop_rect_kernel(
    const int* __restrict__ row_labels, const int* __restrict__ col_labels,
    const uint32_t* __restrict__ bitmap, int R, int W, int* __restrict__ out,
    const int* __restrict__ flag) {
  if (flag != nullptr && *flag == 0) return;
  extern __shared__ int4 s_lab4[];
  __shared__ int s_rowmin[kRectBatch];
  __shared__ int s_next;
  rect_rows<VEC, SMEM, false>(row_labels, col_labels, bitmap, R, W, out, s_lab4, s_rowmin, &s_next);
}

constexpr int kTileWords = 128;   // a col_reduce block's column tile: one uint4 a lane
constexpr int kColThreads = 1024;
constexpr int kColWarps = kColThreads / 32;  // rows a block steps by
constexpr int kColBlocksPerSM = 2;
constexpr int kStride = 33;       // shared accumulator slots a word
constexpr int kAccSlots = kTileWords * kStride;
constexpr int kColSmem = (int)sizeof(int) * (2 * kAccSlots + 2 * kColWarps * kTileWords);

// The lane's exclusive prefix of v over the warp, and the warp's total.
__device__ __forceinline__ int warp_exclusive_sum(int v, int lane, int& total) {
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  total = __shfl_sync(0xffffffffu, x, 31);
  return x - v;
}

template <bool VEC>
__global__ void __launch_bounds__(kColThreads, kColBlocksPerSM) col_reduce_kernel(
    const uint32_t* __restrict__ bitmap, const int* __restrict__ row_vals,
    const int* __restrict__ row_weights, int R, int W, int chunk_rows,
    int* __restrict__ col_min, int* __restrict__ col_sum) {
  extern __shared__ int4 s_col4[];
  int* s_min = reinterpret_cast<int*>(s_col4);
  int* s_sum = s_min + kAccSlots;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * kTileWords, r0 = blockIdx.y * chunk_rows, r1 = min(R, r0 + chunk_rows);
  // the warp's list of its row's nonzero words, and where each goes
  uint32_t* s_word = reinterpret_cast<uint32_t*>(s_sum + kAccSlots) + warp * kTileWords;
  int* s_base = s_sum + kAccSlots + (kColWarps + warp) * kTileWords;
  for (int i = threadIdx.x; i < kAccSlots; i += kColThreads) {
    s_min[i] = INT_MAX;
    s_sum[i] = 0;
  }
  __syncthreads();
  const int wl = t0 + lane * 4;                    // the lane's first word
  int r = r0 + warp;                               // the warp's next row
  uint4 nxt;
  int nv, nw;
  auto fetch = [&](int i) {
    nv = __ldg(row_vals + i);
    nw = __ldg(row_weights + i);
    nxt = load4<VEC>(bitmap + (size_t)i * W, wl, W);
  };
  if (r < r1) fetch(r);
  while (r < r1) {
    const uint4 cur = nxt;
    const int v = nv, wt = nw;  // the same in every lane
    r += kColWarps;
    if (r < r1) fetch(r);
    if (v == INT_MAX && wt == 0) continue;  // the row changes nothing
    // list the nonzero words (branch-free: k is known at compile time) ...
    const uint32_t nz = nonzero4(cur);
    int total;
    int pos = warp_exclusive_sum(__popc(nz), lane, total);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if ((nz >> k) & 1u) {
        s_word[pos] = pick4(cur, k);
        s_base[pos] = (lane * 4 + k) * kStride;
        ++pos;
      }
    __syncwarp();
    // ... and deal them to the lanes, so the densest lane does not set the pace
    for (int e = lane; e < total; e += 32) {
      uint32_t word = s_word[e];
      const int base = s_base[e];
      do {
        const int j = base + __ffs(word) - 1;
        word &= word - 1;
        if (v != INT_MAX) atomicMin(&s_min[j], v);
        if (wt != 0) atomicAdd(&s_sum[j], wt);
      } while (word);
    }
    __syncwarp();
  }
  __syncthreads();
  for (int c = threadIdx.x; c < kTileWords * 32; c += kColThreads) {
    const int word = t0 + (c >> 5);
    if (word >= W) break;
    const int j = (c >> 5) * kStride + (c & 31);
    const int mn = s_min[j], sm = s_sum[j];
    if (mn != INT_MAX) atomicMin(&col_min[word * 32 + (c & 31)], mn);
    if (sm != 0) atomicAdd(&col_sum[word * 32 + (c & 31)], sm);
  }
}

__device__ __forceinline__ int scattered(const int* lab, const int* m,
                                         const int* pos, int x) {
  const int p = pos[x];
  return p >= 0 ? min(lab[x], m[p]) : lab[x];
}

template <bool TELE>
__global__ void label_prop_update_kernel(
    const int* __restrict__ lab, const int* __restrict__ m,
    const int* __restrict__ pos, int cap, int* __restrict__ out,
    int* __restrict__ flags, int it, int* __restrict__ tele, int tele_stride) {
  if (flags[it] == 0) return;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (!TELE) {
    if (j >= cap) return;
    const int nj = scattered(lab, m, pos, j);
    const int jumped = nj < cap ? min(nj, scattered(lab, m, pos, nj)) : nj;
    out[j] = jumped;
    if (jumped != lab[j]) flags[it + 1] = 1;
    return;
  }
  // every thread reaches the block reductions below
  bool front = false, changed = false, hop = false;
  if (j < cap) {
    const int lj = lab[j];
    const int nj = scattered(lab, m, pos, j);
    const int jumped = nj < cap ? min(nj, scattered(lab, m, pos, nj)) : nj;
    out[j] = jumped;
    changed = jumped != lj;
    if (changed) flags[it + 1] = 1;
    const int p = pos[j];
    front = p >= 0 && m[p] < lj;
    hop = jumped < nj;
  }
  const int n_front = __syncthreads_count(front);
  const int n_changed = __syncthreads_count(changed);
  const int n_hops = __syncthreads_count(hop);
  if (threadIdx.x == 0) {
    if (n_front) {
      atomicAdd(&tele[it], n_front);
      atomicAdd(&tele[3 * tele_stride + it], n_front);
    }
    if (n_changed) atomicAdd(&tele[tele_stride + it], n_changed);
    if (n_hops) atomicAdd(&tele[2 * tele_stride + it], n_hops);
  }
}

// One round's update over the cap columns, grid-strided, inside the
// fixpoint's launch: the arithmetic of label_prop_update_kernel, with
// lab, m and flags read through L2 (written earlier in the launch).  The
// stride loop's trip count is the same for every thread of a block, so
// the block counts stay collective.
template <bool TELE>
__device__ __forceinline__ void update_cols(
    const int* lab, const int* m, const int* __restrict__ pos, int cap, int* nxt,
    int* flags, int it, int* tele, int tele_stride) {
  const int stride = gridDim.x * blockDim.x;
  for (int base = blockIdx.x * blockDim.x; base < cap; base += stride) {
    const int j = base + threadIdx.x;
    bool front = false, changed = false, hop = false;
    if (j < cap) {
      const int lj = __ldcg(lab + j), p = __ldg(pos + j);
      const int mj = p >= 0 ? __ldcg(m + p) : INT_MAX;
      const int nj = min(lj, mj);  // new(j)
      int jumped = nj;
      if (nj < cap) {
        const int q = __ldg(pos + nj), lq = __ldcg(lab + nj);
        jumped = min(nj, q >= 0 ? min(lq, __ldcg(m + q)) : lq);  // min(new(j), new(new(j)))
      }
      nxt[j] = jumped;
      changed = jumped != lj;
      if (changed) flags[it + 1] = 1;
      front = mj < lj;  // p >= 0 there: mj is INT32_MAX elsewhere
      hop = jumped < nj;
    }
    if (TELE) {
      const int n_front = __syncthreads_count(front);
      const int n_changed = __syncthreads_count(changed);
      const int n_hops = __syncthreads_count(hop);
      if (threadIdx.x == 0) {
        if (n_front) {
          atomicAdd(&tele[it], n_front);
          atomicAdd(&tele[3 * tele_stride + it], n_front);
        }
        if (n_changed) atomicAdd(&tele[tele_stride + it], n_changed);
        if (n_hops) atomicAdd(&tele[2 * tele_stride + it], n_hops);
      }
    }
  }
}

// label_prop_fixpoint — the whole fixpoint in one cooperative launch
//   (replaces the lax.while_loop of repro/kernels/label_prop/ops.py:228
//   in packed_cluster_fixpoint :123, and of :114 in
//   label_propagation_pallas :84).  One 1,024-thread block an SM, as K2.
//   Round it reads buffer it % 2 and writes the other:
//     1. K2's walk (rect_rows) into m: INT32_MAX row labels (rect mode,
//        packed_cluster_fixpoint) or the current labels (square mode,
//        label_propagation_pallas);
//     2. grid.sync();
//     3. the update over the cap columns (update_cols): the other buffer,
//        flags[it + 1], the telemetry column it when tele is not null;
//     4. grid.sync(); every block reads flags[it + 1] and leaves the loop
//        when it is 0.
//   So the buffers, flags and telemetry are bit for bit those of the
//   per-round launches (K2 + label_prop_update behind flags), and the
//   host enqueues one launch a fixpoint in place of 2 * max_iters.
//   Bound: bytes, rounds * (K2's + the update's), as each kernel's.
//   Where trouble lies, and what the kernel does about it:
//   (1) buffers written in the same launch: lab, m and flags are read
//       with __ldcg (L2, coherent), never through __ldg or a const
//       __restrict__ pointer, which the compiler may turn into the
//       non-coherent LDG.CONSTANT path; bitmap and pos, which nothing
//       writes, stay on the read-only path;
//   (2) per-round block state: rect_rows sets s_next and s_rowmin and
//       stages the round's labels in shared memory afresh each call;
//   (3) co-residency: a cooperative launch fails when the grid cannot
//       all be resident; the launcher returns the error, the wrapper
//       raises, and nothing falls back to the per-round launches.  The
//       staged variant takes the opt-in shared-memory limit less this
//       kernel's own static arrays; the unstaged one serves wider slabs
//       (4 * 32 * W bytes over the limit, W > ~1,770 words);
//   (4) grid.sync() needs no relocatable device code since CUDA 11: the
//       build line (nvcc -gencode arch=compute_90a,code=sm_90a -O3
//       -shared) is unchanged;
//   (5) telemetry keeps the reference's contract: per column through
//       pos, as the update kernel counts, and the loop ends before a
//       round whose flag is 0, so later slots stay 0.
template <bool VEC, bool SMEM, bool TELE>
__global__ void __launch_bounds__(kRectThreads, 1) label_prop_fixpoint_kernel(
    const uint32_t* __restrict__ bitmap, int R, int W, int square, int* lab0, int* lab1,
    int* m, const int* __restrict__ pos, int cap, int* flags, int max_iters, int* tele,
    int tele_stride) {
  extern __shared__ int4 s_lab4[];
  __shared__ int s_rowmin[kRectBatch];
  __shared__ int s_next;
  cg::grid_group grid = cg::this_grid();
  for (int it = 0; it < max_iters; ++it) {
    if (__ldcg(flags + it) == 0) break;  // the same in every block: read after a grid barrier
    const int* lab = (it & 1) ? lab1 : lab0;
    int* nxt = (it & 1) ? lab0 : lab1;
    rect_rows<VEC, SMEM, true>(square ? lab : nullptr, lab, bitmap, R, W, m, s_lab4, s_rowmin, &s_next);
    grid.sync();
    update_cols<TELE>(lab, m, pos, cap, nxt, flags, it, tele, tele_stride);
    grid.sync();
  }
}

// packed_connectivity_kernel — the fixpoint's third mode, connectivity
//   (replaces the lax.while_loop of repro/kernels/label_prop/ops.py:367 in
//   _packed_connectivity_jit :325-380, behind packed_connectivity :383:
//   label_prop_rect_pallas kernel.py:104 + col_reduce_pallas kernel.py:173
//   + the jnp update :374-377).  A streaming block's rows are not a
//   superset of the core set, so a round relays columns -> core rows ->
//   columns.  Round it reads label buffer it % 2 and writes the other:
//     1. K2's walk (conn_tile): m[i] = min over row i's set bits j of
//        lab[j]; meanwhile cmin is reset to INT32_MAX (the previous round
//        read it before its last barrier);
//     2. grid.sync();
//     3. K3's walk (conn_tile): cmin[j] = min over the core rows i with
//        bit (i, j) of m[i];
//     4. grid.sync();
//     5. the update over the cap columns:
//          new(j)  = core_c[j] ? min(lab[j], cmin[j]) : INT32_MAX
//          out[j]  = new(j) < cap ? min(new(j), new(new(j))) : new(j)
//        with new(new(j)) computed again from lab and cmin, as update_cols
//        does; the other buffer; flags[it + 1] when a label changed; m
//        reset to INT32_MAX for the next round's K2;
//     6. grid.sync(); every block reads flags[it + 1] and leaves the loop
//        at 0.
//   The two loop-invariant outputs come out of round 0, which always runs
//   on the initial labels: row_first (the min core column adjacent
//   to each row) is round 0's m (the wrapper fills it with INT32_MAX), and
//   the owner (the min core row adjacent to each column) is a second min
//   accumulator of round 0's K3 walk over the same core rows, taking each
//   row's index.  So a block is one launch.
//   Round 0 computes its labels (core column j is j) where it would read
//   them, and the launch ends by moving the last round's labels into
//   lab0 and writing the rounds it ran, so the wrapper launches nothing
//   but its buffers' fills around it.
//   Bound: bytes, rounds * (K2's + K3's + the update's) over the whole
//   slab; K3 and the later rounds' K2 need only the core rows (round 0's
//   K2 is row_first, over every row), and both walks skip the others'
//   words (a tighter bound, which chip_smoke.py prints beside it).
//   The design, from what held the first one to 12% of that bound
//   (0.745 ms: each round's K2 walk 243 us, K3 103-152 us, the update 9):
//   (1) the column labels (4 * 32W bytes: 608 KB at the stream's 4,756
//       words) fit no shared memory, so its K2 gathered each set bit's
//       label from L2, a round trip per bit.  Here both walks run on the
//       same work items, (128-word tile, chunk of rows) pairs: K2 stages
//       the tile's 4,096 labels in shared memory (16 KB, any W), walks
//       the chunk's rows with shared-memory gathers, and folds each row's
//       minimum into m with one global atomicMin (a RED) per (row, tile)
//       that has a set bit;
//   (2) a warp had one row's 16-byte loads in flight, in registers: the
//       walks waited on device memory, row after row.  Here each warp
//       keeps kRing rows of its tile in flight in a shared-memory ring
//       filled by cp.async (no registers held), and lists each row's
//       nonzero words from there and deals them to its lanes (the walk
//       of col_reduce, whose kernel keeps its own body);
//   (3) items are claimed one at a time from a device counter (work[0]
//       for K2, work[1] for K3; each step resets the other's), the next
//       claim in flight while the block works the current item, so the
//       rows and columns whose bits cluster set no block's pace;
//   (4) the grid is sized by occupancy: two 1,024-thread blocks an SM
//       (registers capped at 32), where one block an SM over at most
//       R / 32 blocks ran before;
//   (5) K2's items are short (about 5 a block): they cost one label tile
//       and nothing at their end.  K3's are taller (at most kMaxChunk
//       rows, whose values it stages): each ends by folding its 4,096
//       column minima into cmin (and the owner) with global atomics, so
//       fewer row chunks there mean fewer of those.
//   Kept from the first design: m, cmin, lab and flags are written in the
//   launch and read with __ldcg or cp.async.cg (L2, coherent); bitmap,
//   row_core and core_c, which nothing writes, take the read-only path; a
//   grid that cannot all be resident is refused and the wrapper raises;
//   words >= W and rows >= R are masked here (the reference pads both to
//   its tiles, with pad rows that are not core).
constexpr int kConnBlocksPerSM = 2;  // 1,024-thread blocks (32 warps) an SM
constexpr int kConnItemsK2 = 5;      // K2 items a block, about
constexpr int kConnItemsK3 = 3;      // K3 items a block, about
constexpr int kRing = 4;             // slab rows a warp has in flight
constexpr int kMaxChunk = 512;       // rows of a K3 item at most (its staged row values)
// Shared memory of a connectivity block, in ints: K3's two accumulators
// (K2's 4,096 staged labels alias them), then each warp's ring of kRing
// 128-word rows, the chunk's row values and owner candidates (K3), and
// each warp's list of nonzero words (bytes).
constexpr int kConnRing = 2 * kAccSlots;
constexpr int kConnVals = kConnRing + kColWarps * kRing * kTileWords;
constexpr int kConnList = kConnVals + 2 * kMaxChunk;
constexpr int kConnSmem = (int)sizeof(int) * kConnList + kColWarps * kTileWords;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async: `bytes` (16, or 0 to write 16 zero bytes) through L2 only,
// so a line written earlier in the launch is read as it now is
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes, or 0 to write a zero word (the slab, which nothing writes)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The lane's 4 words of row r of the tile at word t0 into the ring slot:
// 16 bytes where VEC, else 4 words one at a time; words past W, and the
// whole row when it is off, are written as zeros and not read.
template <bool VEC>
__device__ __forceinline__ void ring_fetch(uint32_t* slot, const uint32_t* bitmap, int r, int W, int t0, int lane,
                                           bool on) {
  const int w = t0 + lane * 4;
  const uint32_t* src = bitmap + (size_t)r * W + w;
  if (VEC) {
    cp_async16(slot + lane * 4, on && w < W ? src : bitmap, on && w < W ? 16 : 0);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) cp_async4(slot + lane * 4 + k, on && w + k < W ? src + k : bitmap, on && w + k < W ? 4 : 0);
  }
}

// The walks of the connectivity launch over one work item, the 128-word
// tile at word t0 over rows r0 .. r1 (< kMaxChunk rows for K3):
//   K2 (K3 false): the tile's 4,096 column labels staged in shared
//     memory (INIT: round 0's, each core column's own index and INT32_MAX
//     elsewhere, computed; else lab's, by cp.async), then
//     m[i] = min(m[i], row i's minimum over the tile's set bits) with one
//     global atomicMin a row that has a set bit; rows with mask[i] 0 are
//     skipped (a null mask: every row);
//   K3: cmin[j] = min over the rows with mask[i] of vals[i], and with
//     OWNER owner[j] = min of rows[i] over the same rows, in shared
//     accumulators (a word's 32 columns at stride 33), added into cmin /
//     owner with one global atomicMin a touched column.
// A warp walks rows r0 + warp, r0 + warp + 32, ...; each lane copies its
// 4 words of a row into the warp's ring by cp.async, kRing - 1 rows ahead
// of the one it walks, so loads stay in flight without holding
// registers; the warp lists the row's nonzero words (a prefix sum over
// the lanes) and deals them to the lanes, which walk their set bits.
// Every thread of the block calls it; it ends behind a barrier.
template <bool VEC, bool K3, bool INIT_OR_OWNER>
__device__ __forceinline__ void conn_tile(
    const uint32_t* __restrict__ bitmap, const uint8_t* __restrict__ mask, const int* vals,
    const uint8_t* __restrict__ core_cols, const int* __restrict__ rows, int n, int W, int t0, int r0, int r1,
    int* out_min, int* out_owner, int* smem) {
  constexpr bool INIT = !K3 && INIT_OR_OWNER, OWNER = K3 && INIT_OR_OWNER;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* s_lab = smem;                 // K2
  int* s_min = smem;                 // K3
  int* s_own = smem + kAccSlots;     // K3 with OWNER
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + kConnRing) + warp * kRing * kTileWords;
  int* s_val = smem + kConnVals;     // K3: the chunk's row values
  int* s_cand = s_val + kMaxChunk;   // K3 with OWNER: their row indices
  uint8_t* list = reinterpret_cast<uint8_t*>(smem + kConnList) + warp * kTileWords;
  const int words = min(kTileWords, W - t0);
  if (K3) {
    for (int i = threadIdx.x; i < kAccSlots; i += kColThreads) {
      s_min[i] = INT_MAX;
      if (OWNER) s_own[i] = INT_MAX;
    }
    for (int i = threadIdx.x; i < r1 - r0; i += kColThreads) {
      const bool on = __ldg(mask + r0 + i) != 0;
      s_val[i] = on ? __ldcg(vals + r0 + i) : INT_MAX;
      if (OWNER) s_cand[i] = on ? __ldg(rows + r0 + i) : INT_MAX;
    }
  } else if (INIT) {
    for (int c = threadIdx.x; c < words * 32; c += kColThreads) {
      const int j = t0 * 32 + c;
      s_lab[c] = j < n && __ldg(core_cols + j) ? j : INT_MAX;
    }
  } else {
    for (int i = threadIdx.x; i < words * 8; i += kColThreads) cp_async16(s_lab + 4 * i, vals + t0 * 32 + 4 * i, 16);
  }
  const int first = r0 + warp;
  const int n_rows = first < r1 ? (r1 - 1 - first) / kColWarps + 1 : 0;  // this warp's rows
  auto fetch = [&](int k) {
    const int r = first + k * kColWarps;
    ring_fetch<VEC>(ring + k % kRing * kTileWords, bitmap, r, W, t0, lane, mask == nullptr || __ldg(mask + r));
  };
#pragma unroll
  for (int k = 0; k < kRing - 1; ++k) {
    if (k < n_rows) fetch(k);
    cp_async_commit();  // the first group also holds the staged labels
  }
  cp_async_wait<kRing - 2>();
  __syncthreads();  // labels, accumulators and row values in place
  for (int k = 0; k < n_rows; ++k) {
    if (k + kRing - 1 < n_rows) fetch(k + kRing - 1);
    cp_async_commit();
    cp_async_wait<kRing - 1>();  // row k's words are in
    __syncwarp();
    const int r = first + k * kColWarps;
    const uint32_t* slot = ring + k % kRing * kTileWords;
    const int v = K3 ? s_val[r - r0] : 0, wt = OWNER ? s_cand[r - r0] : INT_MAX;
    const uint4 cur = *reinterpret_cast<const uint4*>(slot + lane * 4);
    const uint32_t nz = nonzero4(cur);
    int total;
    int pos = warp_exclusive_sum(__popc(nz), lane, total);
    if (total > 0 && (!K3 || v != INT_MAX || wt != INT_MAX)) {  // the same in every lane
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if ((nz >> q) & 1u) list[pos++] = (uint8_t)(lane * 4 + q);
      __syncwarp();
      int mn = INT_MAX, last = INT_MAX;  // K2: each gather's min taken one bit later
      for (int e = lane; e < total; e += 32) {
        const int idx = list[e];
        uint32_t word = slot[idx];
        do {
          const int b = __ffs(word) - 1;
          word &= word - 1;
          if (K3) {
            const int j = idx * kStride + b;
            if (v != INT_MAX) atomicMin(&s_min[j], v);
            if (OWNER && wt != INT_MAX) atomicMin(&s_own[j], wt);
          } else {
            mn = min(mn, last);
            last = s_lab[idx * 32 + b];
          }
        } while (word);
      }
      if (!K3) {
        mn = warp_min(min(mn, last));
        if (lane == 0 && mn != INT_MAX) atomicMin(out_min + r, mn);
      }
    }
    __syncwarp();  // the slot and the list are free again
  }
  __syncthreads();
  if (K3) {
    for (int c = threadIdx.x; c < words * 32; c += kColThreads) {
      const int j = (c >> 5) * kStride + (c & 31), col = t0 * 32 + c;
      const int mn = s_min[j];
      if (mn != INT_MAX) atomicMin(out_min + col, mn);
      if (OWNER) {
        const int ow = s_own[j];
        if (ow != INT_MAX) atomicMin(out_owner + col, ow);
      }
    }
    __syncthreads();
  }
}

// Work items 0 .. items - 1 claimed one at a time from *ctr (0 at the
// step's start), thread 0 claiming the next while the block works the
// current one; body(item) must hold a barrier before its end.
template <typename Body>
__device__ __forceinline__ void claim_items(int* ctr, int items, int* s_claim, Body&& body) {
  if (threadIdx.x == 0) *s_claim = atomicAdd(ctr, 1);
  __syncthreads();
  int item = *s_claim;
  while (item < items) {
    int next = 0;
    if (threadIdx.x == 0) next = atomicAdd(ctr, 1);
    body(item);
    if (threadIdx.x == 0) *s_claim = next;
    __syncthreads();
    item = *s_claim;
  }
}

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The probe build's stamp: once the whole block is past this point, the
// time (ns) into stamps[slot][block]; the main path's instantiation
// (STAMP = false) has none.
template <bool STAMP>
__device__ __forceinline__ void stamp(long long* stamps, int slot) {
  if (!STAMP) return;
  __syncthreads();
  if (threadIdx.x == 0) stamps[(size_t)slot * gridDim.x + blockIdx.x] = globaltimer();
}

template <bool VEC, bool STAMP>
__global__ void __launch_bounds__(kColThreads, kConnBlocksPerSM) packed_connectivity_kernel(
    const uint32_t* __restrict__ bitmap, int R, int W, int n, const int* __restrict__ rows,
    const uint8_t* __restrict__ row_core, const uint8_t* __restrict__ core_cols, int* lab0, int* lab1, int* m,
    int* cmin, int* flags, int* row_first, int* owner, int max_iters, int chunk2, int chunk3, long long* stamps) {
  extern __shared__ int4 s_dyn[];
  __shared__ int s_claim;
  int* smem = reinterpret_cast<int*>(s_dyn);
  int* work = flags + max_iters + 1;  // K2's and K3's item counters, then the rounds run
  cg::grid_group grid = cg::this_grid();
  const int cap = W * 32, tiles = (W + kTileWords - 1) / kTileWords;
  const int items2 = tiles * ((R + chunk2 - 1) / chunk2), items3 = tiles * ((R + chunk3 - 1) / chunk3);
  const int tid = blockIdx.x * blockDim.x + threadIdx.x, stride = gridDim.x * blockDim.x;
  auto core = [&](int j) { return j < n && __ldg(core_cols + j) != 0; };
  stamp<STAMP>(stamps, 0);
  int it = 0;
  for (; it < max_iters; ++it) {
    if (it > 0 && __ldcg(flags + it) == 0) break;  // the same in every block: read after a grid barrier
    const int* lab = (it & 1) ? lab1 : lab0;      // round 0 computes its labels: core column j is j
    int* nxt = (it & 1) ? lab0 : lab1;
    int* mr = it == 0 ? row_first : m;            // round 0's m is row_first
    for (int j = tid; j < cap; j += stride) cmin[j] = INT_MAX;
    if (tid == 0) work[1] = 0;
    claim_items(work, items2, &s_claim, [&](int item) {
      const int t0 = (item % tiles) * kTileWords, r0 = (item / tiles) * chunk2, r1 = min(R, r0 + chunk2);
      if (it == 0)
        conn_tile<VEC, false, true>(bitmap, nullptr, nullptr, core_cols, nullptr, n, W, t0, r0, r1, mr, nullptr, smem);
      else
        conn_tile<VEC, false, false>(bitmap, row_core, lab, nullptr, nullptr, n, W, t0, r0, r1, mr, nullptr, smem);
    });
    stamp<STAMP>(stamps, 1 + 3 * it);
    grid.sync();
    if (tid == 0) work[0] = 0;
    claim_items(work + 1, items3, &s_claim, [&](int item) {
      const int t0 = (item % tiles) * kTileWords, r0 = (item / tiles) * chunk3, r1 = min(R, r0 + chunk3);
      if (it == 0)  // with the owner's accumulator
        conn_tile<VEC, true, true>(bitmap, row_core, mr, nullptr, rows, n, W, t0, r0, r1, cmin, owner, smem);
      else
        conn_tile<VEC, true, false>(bitmap, row_core, mr, nullptr, nullptr, n, W, t0, r0, r1, cmin, nullptr, smem);
    });
    stamp<STAMP>(stamps, 2 + 3 * it);
    grid.sync();
    for (int j = tid; j < R; j += stride) m[j] = INT_MAX;  // the next round's K2 takes its min into m
    for (int j = tid; j < cap; j += stride) {
      const bool cj = core(j);
      const int lj = it == 0 ? (cj ? j : INT_MAX) : __ldcg(lab + j);
      const int nj = cj ? min(lj, __ldcg(cmin + j)) : INT_MAX;  // new(j)
      int jumped = nj;
      if (nj < cap) {
        const int lq = it == 0 ? nj : __ldcg(lab + nj);  // nj < cap is a core column
        jumped = min(nj, core(nj) ? min(lq, __ldcg(cmin + nj)) : INT_MAX);  // min(new(j), new(new(j)))
      }
      nxt[j] = jumped;
      if (jumped != lj) flags[it + 1] = 1;
    }
    stamp<STAMP>(stamps, 3 + 3 * it);
    grid.sync();
  }
  // the labels end in lab0: the last round (it - 1) wrote lab1 when it is even
  if ((it - 1) % 2 == 0)
    for (int j = tid; j < n; j += stride) lab0[j] = __ldcg(lab1 + j);
  if (tid == 0) work[2] = it;
}

// The card's SM count and the shared memory a K2 or fixpoint block may
// stage labels in (the opt-in limit less the kernel's static arrays),
// read once a device; the kernels that take dynamic shared memory are
// allowed it then.
struct Card {
  int sms = 0, smem_optin = 0, smem_fixpoint = 0;
};

template <bool VEC, bool SMEM, bool TELE>
void allow_fixpoint_smem(int bytes) {
  cudaFuncSetAttribute(label_prop_fixpoint_kernel<VEC, SMEM, TELE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

Card card() {
  static Card cards[64];
  int d = 0;
  cudaGetDevice(&d);
  Card& c = cards[d & 63];
  if (c.sms == 0) {
    int optin = 0;
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, d);
    cudaFuncAttributes fa;
    cudaFuncGetAttributes(&fa, label_prop_rect_kernel<true, true>);
    c.smem_optin = optin - (int)fa.sharedSizeBytes;  // what is left for the staged labels
    cudaFuncSetAttribute(label_prop_rect_kernel<true, true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem_optin);
    cudaFuncSetAttribute(label_prop_rect_kernel<false, true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem_optin);
    cudaFuncGetAttributes(&fa, label_prop_fixpoint_kernel<true, true, true>);
    c.smem_fixpoint = optin - (int)fa.sharedSizeBytes;
    allow_fixpoint_smem<true, true, false>(c.smem_fixpoint);
    allow_fixpoint_smem<false, true, false>(c.smem_fixpoint);
    allow_fixpoint_smem<true, true, true>(c.smem_fixpoint);
    allow_fixpoint_smem<false, true, true>(c.smem_fixpoint);
    for (auto k : {packed_connectivity_kernel<true, false>, packed_connectivity_kernel<false, false>,
                   packed_connectivity_kernel<true, true>, packed_connectivity_kernel<false, true>})
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kConnSmem);
    cudaFuncSetAttribute(col_reduce_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, kColSmem);
    cudaFuncSetAttribute(col_reduce_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, kColSmem);
    cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, d);
  }
  return c;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" int label_prop_rect_launch(
    const int* row_labels, const int* col_labels, const int* bitmap, int R,
    int W, int* out, const int* flag, void* stream) {
  if (R <= 0) return 0;
  const Card c = card();
  const int blocks = (int)std::min<long long>(c.sms, ((long long)R + 31) / 32);
  const size_t smem = (size_t)W * 32 * sizeof(int);
  const bool vec = W % 4 == 0 && aligned16(bitmap);
  const bool staged = smem <= (size_t)c.smem_optin;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* bits = reinterpret_cast<const uint32_t*>(bitmap);
  if (staged && vec)
    label_prop_rect_kernel<true, true><<<blocks, kRectThreads, smem, s>>>(row_labels, col_labels, bits, R, W, out, flag);
  else if (staged)
    label_prop_rect_kernel<false, true><<<blocks, kRectThreads, smem, s>>>(row_labels, col_labels, bits, R, W, out, flag);
  else if (vec)
    label_prop_rect_kernel<true, false><<<blocks, kRectThreads, 0, s>>>(row_labels, col_labels, bits, R, W, out, flag);
  else
    label_prop_rect_kernel<false, false><<<blocks, kRectThreads, 0, s>>>(row_labels, col_labels, bits, R, W, out, flag);
  return (int)cudaGetLastError();
}

extern "C" int col_reduce_launch(
    const int* bitmap, const int* row_vals, const int* row_weights, int R,
    int W, int* col_min, int* col_sum, void* stream) {
  if (R <= 0 || W <= 0) return 0;
  // a block per slot of the card: tiles x row chunks, chunks a multiple of a block step
  const int tiles = (W + kTileWords - 1) / kTileWords;
  const int want = std::max(1, (kColBlocksPerSM * card().sms + tiles - 1) / tiles);
  int chunk = (R + want - 1) / want;
  chunk = (chunk + kColWarps - 1) / kColWarps * kColWarps;
  const dim3 grid(tiles, (R + chunk - 1) / chunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* bits = reinterpret_cast<const uint32_t*>(bitmap);
  if (W % 4 == 0 && aligned16(bitmap))
    col_reduce_kernel<true><<<grid, kColThreads, kColSmem, s>>>(bits, row_vals, row_weights, R, W, chunk, col_min, col_sum);
  else
    col_reduce_kernel<false><<<grid, kColThreads, kColSmem, s>>>(bits, row_vals, row_weights, R, W, chunk, col_min, col_sum);
  return (int)cudaGetLastError();
}

extern "C" int label_prop_update_launch(
    const int* lab, const int* m, const int* pos, int cap, int* out,
    int* flags, int it, int* tele, int tele_stride, void* stream) {
  if (cap <= 0) return 0;
  const int threads = 256;
  const int blocks = (cap + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tele != nullptr)
    label_prop_update_kernel<true><<<blocks, threads, 0, s>>>(
        lab, m, pos, cap, out, flags, it, tele, tele_stride);
  else
    label_prop_update_kernel<false><<<blocks, threads, 0, s>>>(
        lab, m, pos, cap, out, flags, it, tele, tele_stride);
  return (int)cudaGetLastError();
}

extern "C" int label_prop_fixpoint_launch(
    const int* bitmap, int R, int W, int square, int* lab0, int* lab1, int* m,
    const int* pos, int cap, int* flags, int max_iters, int* tele, int tele_stride,
    void* stream) {
  if (max_iters <= 0 || (R <= 0 && cap <= 0)) return 0;
  const Card c = card();
  // K2's grid (a block an SM, fewer for short slabs), at least one block
  // for the update when there are no rows
  const int blocks = (int)std::max<long long>(1, std::min<long long>(c.sms, ((long long)R + 31) / 32));
  const size_t smem_labels = (size_t)W * 32 * sizeof(int);
  const bool staged = smem_labels <= (size_t)c.smem_fixpoint;
  const bool vec = W % 4 == 0 && aligned16(bitmap);
  const uint32_t* bits = reinterpret_cast<const uint32_t*>(bitmap);
  void (*kernel)(const uint32_t*, int, int, int, int*, int*, int*, const int*, int, int*, int, int*, int);
  if (tele != nullptr)
    kernel = staged ? (vec ? label_prop_fixpoint_kernel<true, true, true> : label_prop_fixpoint_kernel<false, true, true>)
                    : (vec ? label_prop_fixpoint_kernel<true, false, true> : label_prop_fixpoint_kernel<false, false, true>);
  else
    kernel = staged ? (vec ? label_prop_fixpoint_kernel<true, true, false> : label_prop_fixpoint_kernel<false, true, false>)
                    : (vec ? label_prop_fixpoint_kernel<true, false, false> : label_prop_fixpoint_kernel<false, false, false>);
  void* args[] = {(void*)&bits, &R, &W, &square, &lab0, &lab1, &m, (void*)&pos, &cap, &flags,
                  &max_iters, &tele, &tele_stride};
  // a grid that cannot all be resident is refused here (no fallback)
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(kRectThreads), args,
                                                    staged ? smem_labels : 0, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // read, so a refusal is not left for the next launch
  return (int)(e != cudaSuccess ? e : last);
}

namespace {

// packed_connectivity's grid and work items on an (R, W) slab: as many
// blocks as can be resident (kConnBlocksPerSM an SM, fewer for a small
// slab), K2's row chunks about kConnItemsK2 items a block and K3's about
// kConnItemsK3 (at most kMaxChunk rows), each a multiple of a block's 32
// warps.
struct ConnGrid {
  int blocks = 0, per_sm = 0, chunk2 = 0, chunk3 = 0;
};

ConnGrid conn_grid(int R, int W) {
  ConnGrid g;
  const Card c = card();
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&g.per_sm, packed_connectivity_kernel<true, false>, kColThreads,
                                                kConnSmem);
  const int tiles = (W + kTileWords - 1) / kTileWords;
  const long long need = std::max<long long>({1, (long long)tiles * ((R + kColWarps - 1) / kColWarps),
                                              ((long long)W * 32 + kColThreads - 1) / kColThreads});
  g.blocks = (int)std::min<long long>((long long)g.per_sm * c.sms, need);
  auto chunk = [&](int per_block) {
    const int want = std::max(1, (per_block * g.blocks + tiles - 1) / tiles);  // row chunks
    const int rows = (R + want - 1) / want;
    return std::max(kColWarps, (rows + kColWarps - 1) / kColWarps * kColWarps);
  };
  g.chunk2 = chunk(kConnItemsK2);
  g.chunk3 = std::min(kMaxChunk, chunk(kConnItemsK3));
  return g;
}

}  // namespace

extern "C" int packed_connectivity_grid(int R, int W, int* out) {
  const ConnGrid g = conn_grid(R, W);
  out[0] = g.blocks, out[1] = g.per_sm, out[2] = g.chunk2, out[3] = g.chunk3;
  return (int)cudaGetLastError();
}

// row_core (R) and core_cols (n) are bytes, 0 or 1 (torch.bool);
// rows int32.  flags: max_iters + 4 ints, zero: the round flags, then the
// launch's two work-item counters, then the rounds run, written at the
// end.  The labels come out in lab0[:n]; lab1 and m are scratch;
// row_first and owner must hold INT32_MAX.  stamps: null on the main
// path; else (1 + 3 max_iters) x blocks int64 for the probe build.
extern "C" int packed_connectivity_launch(
    const int* bitmap, int R, int W, int n, const int* rows, const uint8_t* row_core, const uint8_t* core_cols,
    int* lab0, int* lab1, int* m, int* cmin, int* flags, int* row_first, int* owner, int max_iters,
    long long* stamps, void* stream) {
  if (max_iters <= 0 || R <= 0 || W <= 0) return 0;
  const ConnGrid g = conn_grid(R, W);
  if (g.blocks <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const bool vec = W % 4 == 0 && aligned16(bitmap);
  const uint32_t* bits = reinterpret_cast<const uint32_t*>(bitmap);
  void (*kernel)(const uint32_t*, int, int, int, const int*, const uint8_t*, const uint8_t*, int*, int*, int*, int*,
                 int*, int*, int*, int, int, int, long long*);
  if (stamps != nullptr)
    kernel = vec ? packed_connectivity_kernel<true, true> : packed_connectivity_kernel<false, true>;
  else
    kernel = vec ? packed_connectivity_kernel<true, false> : packed_connectivity_kernel<false, false>;
  int c2 = g.chunk2, c3 = g.chunk3;
  void* args[] = {(void*)&bits, &R, &W, &n, (void*)&rows, (void*)&row_core, (void*)&core_cols, &lab0, &lab1, &m,
                  &cmin, &flags, &row_first, &owner, &max_iters, &c2, &c3, &stamps};
  // a grid that cannot all be resident is refused here (no fallback)
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(g.blocks), dim3(kColThreads), args,
                                                    kConnSmem, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // read, so a refusal is not left for the next launch
  return (int)(e != cudaSuccess ? e : last);
}
