// Row popcount of a packed bit slab, CUDA C++ for sm_90a.
//
// Replaces no Pallas kernel: the reference computes
// `jnp.sum(lax.population_count(bitmap), axis=1)` on the device inside the
// fixpoint's jit (repro/kernels/label_prop/ops.py:174): each slab row's
// exact neighbor count, from which pass 2's core test is taken.  The same
// operation restricted to a bit range per row counts KNN-BLOCK's candidate
// windows (core/baselines.py):
//
//   out[r] = |{ bits b of row r : lo[r] <= b < hi[r] }|   (no range: every bit)
//
// What bounds it on an H100: one read of the slab (R x W words) and R int32
// writes, nothing else; the work per word is one POPC and one add.  So it is
// bound by bytes: the main path's 18,432 x 952-word slab is 70.2 MB, 0.021 ms
// at 3.35 TB/s.
//
// Design:
//   * a warp per row, 8 rows a 256-thread block; lanes walk the row in
//     16-byte pieces (when the row length is a multiple of 4 words and the
//     slab is 16-byte aligned), four pieces loaded before the first POPC so
//     a lane keeps 64 bytes in flight, then the ragged tail word by word;
//   * with a range, a piece or word wholly outside [lo, hi) is never
//     loaded (the loops run over the pieces, then the tail words, that
//     [lo, hi) touches), and a word that straddles an end is masked before
//     its POPC;
//   * __reduce_add_sync sums the lanes' counts; lane 0 stores the row's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kUnroll = 4;

// bits [lo, hi) of the word that holds bits [base, base + 32)
__device__ __forceinline__ uint32_t range_mask(int base, int lo, int hi) {
  const int a = min(max(lo - base, 0), 32);
  const int b = min(max(hi - base, 0), 32);
  if (b <= a) return 0u;
  const uint32_t upto_b = b == 32 ? 0xffffffffu : (1u << b) - 1u;
  const uint32_t below_a = a == 32 ? 0xffffffffu : (1u << a) - 1u;
  return upto_b & ~below_a;
}

template <bool RANGE>
__device__ __forceinline__ int count_word(uint32_t w, int word, int lo, int hi) {
  if (RANGE) w &= range_mask(32 * word, lo, hi);
  return __popc(w);
}

template <bool VEC, bool RANGE>
__global__ void __launch_bounds__(kThreads) row_popcount_kernel(
    const uint32_t* __restrict__ bits, int R, int W, const int* __restrict__ lo_r,
    const int* __restrict__ hi_r, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;
  const uint32_t* p = bits + (size_t)row * W;
  // the row's bits [lo, hi), clamped to the row
  const int lo = RANGE ? min(max(lo_r[row], 0), 32 * W) : 0;
  const int hi = RANGE ? min(max(hi_r[row], 0), 32 * W) : 32 * W;
  int cnt = 0;
  int tail = 0;
  if (VEC) {
    const uint4* p4 = reinterpret_cast<const uint4*>(p);
    const int n4 = W / 4;
    // pieces [first, last) can hold bits of [lo, hi)
    const int first = lo / 128;
    const int last = min(n4, (hi + 127) / 128);
    for (int v0 = first + lane; v0 < last; v0 += 32 * kUnroll) {
      uint4 q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = v0 + 32 * u;
        q[u] = v < last ? __ldg(p4 + v) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int w = 4 * (v0 + 32 * u);
        cnt += count_word<RANGE>(q[u].x, w, lo, hi) + count_word<RANGE>(q[u].y, w + 1, lo, hi) +
               count_word<RANGE>(q[u].z, w + 2, lo, hi) + count_word<RANGE>(q[u].w, w + 3, lo, hi);
      }
    }
    tail = 4 * n4;
  }
  // words [w0, w1) past the pieces can hold bits of [lo, hi)
  const int w0 = max(tail, lo / 32);
  const int w1 = min(W, (hi + 31) / 32);
  for (int w = w0 + lane; w < w1; w += 32) cnt += count_word<RANGE>(__ldg(p + w), w, lo, hi);
  cnt = (int)__reduce_add_sync(0xffffffffu, (unsigned)cnt);
  if (lane == 0) out[row] = cnt;
}

}  // namespace

// bits: (R, W) contiguous words; lo, hi: (R,) bit ranges or both null.
extern "C" int row_popcount_launch(const int* bits, int R, int W, const int* lo, const int* hi, int* out,
                                   void* stream) {
  if (R <= 0) return 0;
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* b = reinterpret_cast<const uint32_t*>(bits);
  const bool vec = W % 4 == 0 && (reinterpret_cast<uintptr_t>(bits) & 15) == 0;
  const bool range = lo != nullptr;
  if (vec && range)
    row_popcount_kernel<true, true><<<grid, kThreads, 0, s>>>(b, R, W, lo, hi, out);
  else if (vec)
    row_popcount_kernel<true, false><<<grid, kThreads, 0, s>>>(b, R, W, lo, hi, out);
  else if (range)
    row_popcount_kernel<false, true><<<grid, kThreads, 0, s>>>(b, R, W, lo, hi, out);
  else
    row_popcount_kernel<false, false><<<grid, kThreads, 0, s>>>(b, R, W, lo, hi, out);
  return (int)cudaGetLastError();
}
