// Fused Hamming-filter + exact-verify range query, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/hamming_filter/kernel.py:179
// `hamming_filter_pallas`, all four bodies: `_filter_count_kernel` :62,
// `_filter_count_bitmap_kernel` :80, `_filter_count_stats_kernel` :131
// and `_filter_count_bitmap_stats_kernel` :150.  For every (query i, db
// row j) pair:
//
//   ham = popcount(q_sig[i] ^ db_sig[j])          (w = n_bits/32 words)
//   hit = ham <= t_lo                              sure accept, no dot
//      or (ham <= t_hi and dot(q[i], db[j]) > thresh)   band, fp32 verify
//
// and writes per-query int32 counts and, in bitmap mode, the packed
// LSB-first hit words (bit l of word c of row i = column 32c + l).
//
// What bounds it on an H100: the popcount pass is nq*nd*w XOR+POPC
// integer operations over operands that fit in shared memory; the
// inputs and the bitmap are small next to that, so the kernel is
// bound by integer issue rate, not by bytes.  The fp32 verify runs only
// for band pairs, which are a small fraction of all pairs at the
// paper's operating points.
//
// Design:
//   * a block owns 256 db columns (8 warps x 32 lanes, one column per
//     thread) and TQ query rows; both signature tiles are staged in
//     shared memory with coalesced loads (db rows padded to w+1 words so
//     per-thread row reads are bank-conflict free); the query signature
//     is a shared-memory broadcast;
//   * the TPU's sequential db-tile axis is gone: blocks run in any
//     order, counts meet in integer atomics (exact in any order);
//   * verify is skipped wherever no pair falls in the band: each warp
//     tests its 32 pairs of a row with __any_sync, which skips every
//     tile the reference skips and more;
//   * a band pair is verified by the whole warp: lanes split the d
//     products (coalesced row loads, fp32 FMA, never TF32) and a fixed
//     xor-shuffle tree sums them, so the result is deterministic;
//   * the warp's 32 hit bits are exactly the LSB-first word
//     (__ballot_sync), and __popc of that word feeds the counts;
//   * ragged nq/nd are masked in the kernel: no padding, no pad
//     correction, and bits past nd are never set (the tail mask).
//   * count-only mode is the same kernel with BITMAP = false;
//   * STATS = true adds the occupancy counters of the `_stats` bodies:
//     per (row, warp) the __popc of the sure-accept and band ballots go
//     into per-thread registers, a block sums them once through shared
//     memory and adds them with three atomicAdds, [accept, band, reject], into
//     int32 slab row `row0 / chunk_rows` (chunk_rows is a multiple of the
//     block's 32 rows, or >= nq for one whole-call triple, so a block
//     never straddles two rows).  Only real pairs are counted (the kernel
//     never pads); the wrapper adds the reference's pad-grid pairs.  The
//     counters read the classification the kernel already makes and
//     change no count or word.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 256;   // db columns per block (8 warps)
constexpr int kRows = 32;    // query rows per block

template <bool BITMAP, bool STATS>
__global__ void __launch_bounds__(kCols) hamming_filter_kernel(
    const float* __restrict__ q, const float* __restrict__ db,
    const uint32_t* __restrict__ qs, const uint32_t* __restrict__ dbs,
    int nq, int nd, int d, int w, float thresh, int t_lo, int t_hi,
    int* __restrict__ counts, uint32_t* __restrict__ bitmap, int ld_bitmap,
    int* __restrict__ stats, int chunk_rows) {
  extern __shared__ uint32_t smem[];
  uint32_t* db_sig = smem;                      // kCols x (w + 1)
  uint32_t* q_sig = smem + kCols * (w + 1);     // kRows x w
  __shared__ int row_hits[kRows];
  __shared__ int occupancy[2];                  // [accept, band] of the block

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int col0 = blockIdx.x * kCols;
  const int row0 = blockIdx.y * kRows;
  const int j = col0 + tid;
  const bool col_ok = j < nd;

  // stage signature tiles: both are contiguous row ranges in memory
  const int n_db = min(kCols, nd - col0) * w;
  for (int t = tid; t < kCols * w; t += kCols) {
    int r = t / w, k = t - r * w;
    db_sig[r * (w + 1) + k] = t < n_db ? dbs[(size_t)col0 * w + t] : 0u;
  }
  const int n_q = min(kRows, nq - row0) * w;
  for (int t = tid; t < kRows * w; t += kCols)
    q_sig[t] = t < n_q ? qs[(size_t)row0 * w + t] : 0u;
  if (tid < kRows) row_hits[tid] = 0;
  if (STATS && tid < 2) occupancy[tid] = 0;
  __syncthreads();
  int n_accept = 0, n_band = 0;  // this warp's ballot popcounts (warp-uniform)

  const uint32_t* my_sig = db_sig + tid * (w + 1);
  const int rows = min(kRows, nq - row0);
  for (int r = 0; r < rows; ++r) {
    const uint32_t* qr = q_sig + r * w;
    int ham = 0;
    for (int k = 0; k < w; ++k) ham += __popc(qr[k] ^ my_sig[k]);
    bool hit = col_ok && ham <= t_lo;
    const bool band = col_ok && !hit && ham <= t_hi;
    unsigned pending = __ballot_sync(0xffffffffu, band);
    if (STATS) {
      n_accept += __popc(__ballot_sync(0xffffffffu, hit));
      n_band += __popc(pending);
    }
    if (pending) {
      const float* qrow = q + (size_t)(row0 + r) * d;
      while (pending) {
        const int b = __ffs(pending) - 1;
        pending &= pending - 1;
        const float* drow = db + (size_t)(col0 + (tid & ~31) + b) * d;
        float s = 0.f;
        for (int k = lane; k < d; k += 32) s = fmaf(qrow[k], drow[k], s);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == b) hit = s > thresh;
      }
    }
    const unsigned word = __ballot_sync(0xffffffffu, hit);
    if (lane == 0 && word) {
      atomicAdd(&row_hits[r], __popc(word));
      if (BITMAP)
        bitmap[(size_t)(row0 + r) * ld_bitmap + (j >> 5)] = word;
    }
  }
  if (STATS && lane == 0) {
    atomicAdd(&occupancy[0], n_accept);
    atomicAdd(&occupancy[1], n_band);
  }
  __syncthreads();
  if (tid < rows && row_hits[tid]) atomicAdd(&counts[row0 + tid], row_hits[tid]);
  if (STATS && tid == 0) {
    const int pairs = rows * min(kCols, nd - col0);
    int* slot = stats + 3 * (row0 / chunk_rows);
    atomicAdd(&slot[0], occupancy[0]);
    atomicAdd(&slot[1], occupancy[1]);
    atomicAdd(&slot[2], pairs - occupancy[0] - occupancy[1]);
  }
}

template <bool BITMAP, bool STATS>
void launch(dim3 grid, size_t shmem, cudaStream_t s, const float* q, const float* db,
            const uint32_t* qs, const uint32_t* dbs, int nq, int nd, int d, int w,
            float thresh, int t_lo, int t_hi, int* counts, uint32_t* bm, int ld_bitmap,
            int* stats, int chunk_rows) {
  hamming_filter_kernel<BITMAP, STATS><<<grid, kCols, shmem, s>>>(
      q, db, qs, dbs, nq, nd, d, w, thresh, t_lo, t_hi, counts, bm, ld_bitmap,
      stats, chunk_rows);
}

}  // namespace

extern "C" int hamming_filter_launch(
    const float* q, const float* db, const int* q_sig, const int* db_sig,
    int nq, int nd, int d, int w, float thresh, int t_lo, int t_hi,
    int* counts, int* bitmap, int ld_bitmap, int with_bitmap,
    int* stats, int chunk_rows, void* stream) {
  if (nq <= 0 || nd <= 0) return 0;
  dim3 grid((nd + kCols - 1) / kCols, (nq + kRows - 1) / kRows);
  size_t shmem = sizeof(uint32_t) * (size_t)(kCols * (w + 1) + kRows * w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* qs = reinterpret_cast<const uint32_t*>(q_sig);
  const uint32_t* dbs = reinterpret_cast<const uint32_t*>(db_sig);
  uint32_t* bm = reinterpret_cast<uint32_t*>(bitmap);
  auto body = with_bitmap ? (stats ? &launch<true, true> : &launch<true, false>)
                          : (stats ? &launch<false, true> : &launch<false, false>);
  body(grid, shmem, s, q, db, qs, dbs, nq, nd, d, w, thresh, t_lo, t_hi, counts, bm,
       ld_bitmap, stats, chunk_rows);
  return (int)cudaGetLastError();
}
