// Fused Hamming-filter + exact-verify range query, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/hamming_filter/kernel.py:179
// `hamming_filter_pallas` (bodies `_filter_count_bitmap_kernel` :80 and
// `_filter_count_kernel` :62).  For every (query i, db row j) pair:
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
//   * count-only mode is the same kernel with BITMAP = false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 256;   // db columns per block (8 warps)
constexpr int kRows = 32;    // query rows per block

template <bool BITMAP>
__global__ void __launch_bounds__(kCols) hamming_filter_kernel(
    const float* __restrict__ q, const float* __restrict__ db,
    const uint32_t* __restrict__ qs, const uint32_t* __restrict__ dbs,
    int nq, int nd, int d, int w, float thresh, int t_lo, int t_hi,
    int* __restrict__ counts, uint32_t* __restrict__ bitmap, int ld_bitmap) {
  extern __shared__ uint32_t smem[];
  uint32_t* db_sig = smem;                      // kCols x (w + 1)
  uint32_t* q_sig = smem + kCols * (w + 1);     // kRows x w
  __shared__ int row_hits[kRows];

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
  __syncthreads();

  const uint32_t* my_sig = db_sig + tid * (w + 1);
  const int rows = min(kRows, nq - row0);
  for (int r = 0; r < rows; ++r) {
    const uint32_t* qr = q_sig + r * w;
    int ham = 0;
    for (int k = 0; k < w; ++k) ham += __popc(qr[k] ^ my_sig[k]);
    bool hit = col_ok && ham <= t_lo;
    const bool band = col_ok && !hit && ham <= t_hi;
    unsigned pending = __ballot_sync(0xffffffffu, band);
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
  __syncthreads();
  if (tid < rows && row_hits[tid]) atomicAdd(&counts[row0 + tid], row_hits[tid]);
}

}  // namespace

extern "C" int hamming_filter_launch(
    const float* q, const float* db, const int* q_sig, const int* db_sig,
    int nq, int nd, int d, int w, float thresh, int t_lo, int t_hi,
    int* counts, int* bitmap, int ld_bitmap, int with_bitmap, void* stream) {
  if (nq <= 0 || nd <= 0) return 0;
  dim3 grid((nd + kCols - 1) / kCols, (nq + kRows - 1) / kRows);
  size_t shmem = sizeof(uint32_t) * (size_t)(kCols * (w + 1) + kRows * w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* qs = reinterpret_cast<const uint32_t*>(q_sig);
  const uint32_t* dbs = reinterpret_cast<const uint32_t*>(db_sig);
  uint32_t* bm = reinterpret_cast<uint32_t*>(bitmap);
  if (with_bitmap)
    hamming_filter_kernel<true><<<grid, kCols, shmem, s>>>(
        q, db, qs, dbs, nq, nd, d, w, thresh, t_lo, t_hi, counts, bm, ld_bitmap);
  else
    hamming_filter_kernel<false><<<grid, kCols, shmem, s>>>(
        q, db, qs, dbs, nq, nd, d, w, thresh, t_lo, t_hi, counts, bm, ld_bitmap);
  return (int)cudaGetLastError();
}
