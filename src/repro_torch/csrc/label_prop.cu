// Packed-bitmap label propagation, CUDA C++ for sm_90a.  Three kernels
// over the sweep's (R rows x W words) LSB-first adjacency slab; the slab
// is never unpacked to memory.
//
// label_prop_rect — replaces repro/kernels/label_prop/kernel.py:104
//   `label_prop_rect_pallas` (body `_label_prop_kernel` :41):
//     out[i] = min(row_labels[i], min over set bits j of row i of col_labels[j])
//   Bound: bytes — each round reads the slab once (4*R*W) plus the
//   label vectors; the work per set bit is one gather from a label
//   vector that stays in L2.  Design: one warp per row, lanes stride
//   over the row's words (coalesced), walk the set bits with __ffs, and
//   a shuffle tree takes the warp's min.  The TPU grid's sequential
//   word-tile axis becomes the lanes' loop.
//
// col_reduce — replaces repro/kernels/label_prop/kernel.py:173
//   `col_reduce_pallas` (body `_col_reduce_kernel` :140):
//     col_min[j] = min of row_vals[i] over rows i with bit (i, j) set
//                  (INT32_MAX if none)
//     col_sum[j] = sum of row_weights[i] over the same rows
//   Bound: bytes — one read of the slab.  Design: a block owns 8 words
//   (256 columns, one per thread) and a chunk of rows; each warp reads
//   its word of every row as a broadcast, skips zero words, and the
//   chunks meet in atomicMin / atomicAdd (integer, so exact in any
//   order) in place of the TPU's sequential row-tile accumulation.
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
// The one-sync fixpoint: every round's kernels read flags[it] and return
// at once when it is 0; the update writes flags[it+1] = 1 when a label
// changed.  The host enqueues max_iters rounds and never reads a flag.
//
// Telemetry (repro/obs/device.py's per-round vectors, computed in jnp
// inside the reference's while loop at ops.py:198-248): with a non-null
// `tele` (int32, 4 rows of `tele_stride` rounds) the update kernel adds
// round `it`'s counts into column `it`:
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

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void label_prop_rect_kernel(
    const int* __restrict__ row_labels, const int* __restrict__ col_labels,
    const uint32_t* __restrict__ bitmap, int R, int W, int* __restrict__ out,
    const int* __restrict__ flag) {
  if (flag != nullptr && *flag == 0) return;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  const uint32_t* words = bitmap + (size_t)row * W;
  int m = INT_MAX;
  for (int c = lane; c < W; c += 32) {
    uint32_t word = words[c];
    while (word) {
      const int b = __ffs(word) - 1;
      word &= word - 1;
      m = min(m, col_labels[c * 32 + b]);
    }
  }
  m = warp_min(m);
  if (lane == 0) out[row] = min(row_labels[row], m);
}

constexpr int kColWords = 8;     // words (x32 columns) per block
constexpr int kRowChunk = 256;   // rows per block

__global__ void __launch_bounds__(kColWords * 32) col_reduce_kernel(
    const uint32_t* __restrict__ bitmap, const int* __restrict__ row_vals,
    const int* __restrict__ row_weights, int R, int W,
    int* __restrict__ col_min, int* __restrict__ col_sum) {
  const int wcol = blockIdx.x * kColWords + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (wcol >= W) return;
  const int r0 = blockIdx.y * kRowChunk;
  const int r1 = min(R, r0 + kRowChunk);
  int mn = INT_MAX, sm = 0;
  for (int i = r0; i < r1; ++i) {
    const uint32_t word = bitmap[(size_t)i * W + wcol];
    if (word == 0u) continue;
    if ((word >> lane) & 1u) {
      mn = min(mn, row_vals[i]);
      sm += row_weights[i];
    }
  }
  const int col = wcol * 32 + lane;
  if (mn != INT_MAX) atomicMin(&col_min[col], mn);
  if (sm != 0) atomicAdd(&col_sum[col], sm);
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

}  // namespace

extern "C" int label_prop_rect_launch(
    const int* row_labels, const int* col_labels, const int* bitmap, int R,
    int W, int* out, const int* flag, void* stream) {
  if (R <= 0) return 0;
  const int threads = 256;
  const int blocks = (int)(((long long)R * 32 + threads - 1) / threads);
  label_prop_rect_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      row_labels, col_labels, reinterpret_cast<const uint32_t*>(bitmap), R, W,
      out, flag);
  return (int)cudaGetLastError();
}

extern "C" int col_reduce_launch(
    const int* bitmap, const int* row_vals, const int* row_weights, int R,
    int W, int* col_min, int* col_sum, void* stream) {
  if (R <= 0 || W <= 0) return 0;
  dim3 grid((W + kColWords - 1) / kColWords, (R + kRowChunk - 1) / kRowChunk);
  col_reduce_kernel<<<grid, kColWords * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(bitmap), row_vals, row_weights, R, W,
      col_min, col_sum);
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
