// Exact eps-range query: thresholded fp32 inner products, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/range_count/kernel.py:75
// `range_count_pallas` (bodies `_count_kernel` :29 and
// `_count_bitmap_kernel` :49).  For every (query i, db row j) pair:
//
//   hit = dot(q[i], db[j]) > thresh        thresh = float32(1 - eps)
//
// and writes per-query int32 counts and, in bitmap mode, the packed
// LSB-first hit words (bit l of word c of row i = column 32c + l).
//
// What bounds it on an H100: 2*nq*nd*d floating-point operations over
// (nq + nd)*d input floats; at d = 768 every loaded float feeds hundreds
// of products, so the kernel is bound by operations, not bytes.  The
// port's parity contract forbids TF32 and the tensor cores have no IEEE
// fp32, so the ceiling is the CUDA cores' fp32 FMA rate (67 TFLOP/s).
//
// Design:
//   * a register-blocked fp32 product: a block of 256 threads owns 128
//     query rows x 128 db columns; warp w owns rows 16w..16w+15 and lane
//     l owns columns l, l+32, l+64, l+96, so a thread keeps 16 x 4
//     accumulators and the 32 lanes of a warp always hold 32
//     consecutive columns of one row;
//   * the k axis runs in steps of 32 through a two-stage shared-memory
//     ring filled by cp.async (16-byte copies when d % 4 == 0 and both
//     bases are 16-byte aligned, 4-byte copies otherwise), so the next
//     k tile loads while this one is multiplied.  Tiles are stored
//     row-major with a 36-float stride: query rows are read as float4
//     broadcasts, db rows as float4 without bank conflicts;
//   * every accumulator sums its d products in the order k = 0..d-1
//     with fmaf (never TF32), so a result does not depend on the launch
//     shape, and differs from any other fp32 summation order by at most
//     2(d-1)2^-24 for unit vectors;
//   * the TPU's sequential db-tile axis is gone: blocks run in any
//     order and meet in one int32 atomicAdd per row and block, exact in
//     any order;
//   * the hit predicate's __ballot_sync over a warp's 32 consecutive
//     columns is exactly the LSB-first word; __popc of the words gives
//     the counts; four lanes store a row's four words as one 16-byte run;
//   * ragged nq/nd and the d tail are loaded as zeros, rows >= nq are
//     never stored and bits of columns >= nd are never set, so no pad
//     correction is needed, for eps > 1 included;
//   * the count-only mode is the same kernel with BITMAP = false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;            // query rows per block (8 warps x 16)
constexpr int kCols = 128;            // db columns per block (4 x 32 lanes)
constexpr int kK = 32;                // k depth of one stage
constexpr int kStride = kK + 4;       // shared row stride in floats
constexpr int kRowsPerWarp = kRows / (kThreads / 32);
constexpr int kColGroups = kCols / 32;
constexpr int kStageFloats = (kRows + kCols) * kStride;
constexpr size_t kSmemBytes = 2 * kStageFloats * sizeof(float);

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Copy rows [r0, r0 + 128) x k [k0, k0 + 32) of a (n, d) row-major
// matrix into a (128, kStride) shared tile; out-of-range elements are
// zero-filled (a copy of 0 bytes from the matrix base).
template <bool VEC>
__device__ __forceinline__ void load_tile(float* tile, const float* __restrict__ src,
                                          int r0, int n, int k0, int d, int tid) {
  if (VEC) {
#pragma unroll
    for (int i = 0; i < (kRows * kK / 4) / kThreads; ++i) {
      const int t = tid + i * kThreads;
      const int r = t >> 3, c = (t & 7) * 4;
      const bool ok = r0 + r < n && k0 + c < d;
      const float* g = ok ? src + (size_t)(r0 + r) * d + k0 + c : src;
      cp_async16(tile + r * kStride + c, g, ok);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < (kRows * kK) / kThreads; ++i) {
      const int t = tid + i * kThreads;
      const int r = t >> 5, c = t & 31;
      const bool ok = r0 + r < n && k0 + c < d;
      const float* g = ok ? src + (size_t)(r0 + r) * d + k0 + c : src;
      cp_async4(tile + r * kStride + c, g, ok);
    }
  }
}

template <bool BITMAP, bool VEC>
__global__ void __launch_bounds__(kThreads, 2) range_count_kernel(
    const float* __restrict__ q, const float* __restrict__ db,
    int nq, int nd, int d, float thresh,
    int* __restrict__ counts, uint32_t* __restrict__ bitmap, int ld_bitmap) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kCols;

  float acc[kRowsPerWarp][kColGroups];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < kColGroups; ++j) acc[i][j] = 0.f;

  const int n_k = (d + kK - 1) / kK;
  load_tile<VEC>(smem, q, row0, nq, 0, d, tid);
  load_tile<VEC>(smem + kRows * kStride, db, col0, nd, 0, d, tid);
  cp_async_commit();

  for (int kt = 0; kt < n_k; ++kt) {
    if (kt + 1 < n_k) {
      float* next = smem + ((kt + 1) & 1) * kStageFloats;
      load_tile<VEC>(next, q, row0, nq, (kt + 1) * kK, d, tid);
      load_tile<VEC>(next + kRows * kStride, db, col0, nd, (kt + 1) * kK, d, tid);
    }
    cp_async_commit();
    cp_async_wait_one();  // every group but the newest: stage kt is in
    __syncthreads();

    const float* qs = smem + (kt & 1) * kStageFloats + warp * kRowsPerWarp * kStride;
    const float* ds = smem + (kt & 1) * kStageFloats + kRows * kStride + lane * kStride;
#pragma unroll
    for (int kk = 0; kk < kK; kk += 4) {
      float4 b[kColGroups];
#pragma unroll
      for (int j = 0; j < kColGroups; ++j)
        b[j] = *reinterpret_cast<const float4*>(ds + j * 32 * kStride + kk);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(qs + i * kStride + kk);
#pragma unroll
        for (int j = 0; j < kColGroups; ++j) {
          float s = acc[i][j];
          s = fmaf(a.x, b[j].x, s);
          s = fmaf(a.y, b[j].y, s);
          s = fmaf(a.z, b[j].z, s);
          s = fmaf(a.w, b[j].w, s);
          acc[i][j] = s;
        }
      }
    }
    __syncthreads();  // the stage is refilled by the next iteration
  }

  const int n_words = (nd + 31) >> 5;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + warp * kRowsPerWarp + i;
    unsigned words[kColGroups];
    int hits = 0;
#pragma unroll
    for (int j = 0; j < kColGroups; ++j) {
      const bool hit = col0 + j * 32 + lane < nd && acc[i][j] > thresh;
      words[j] = __ballot_sync(0xffffffffu, hit);
      hits += __popc(words[j]);
    }
    if (row >= nq) continue;
    if (BITMAP && lane < kColGroups) {
      const int wi = (col0 >> 5) + lane;
      unsigned word = words[0];
#pragma unroll
      for (int j = 1; j < kColGroups; ++j) word = lane == j ? words[j] : word;
      if (wi < n_words) bitmap[(size_t)row * ld_bitmap + wi] = word;
    }
    if (lane == 0 && hits) atomicAdd(&counts[row], hits);
  }
}

template <bool BITMAP, bool VEC>
int launch(const float* q, const float* db, int nq, int nd, int d, float thresh,
           int* counts, uint32_t* bitmap, int ld_bitmap, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(range_count_kernel<BITMAP, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((nd + kCols - 1) / kCols, (nq + kRows - 1) / kRows);
  range_count_kernel<BITMAP, VEC><<<grid, kThreads, kSmemBytes, s>>>(
      q, db, nq, nd, d, thresh, counts, bitmap, ld_bitmap);
  return (int)cudaGetLastError();
}

}  // namespace

// counts must be zero on entry; bitmap (nq, ld_bitmap >= ceil(nd/32))
// gets every word of columns < nd written (no zeroing needed).
extern "C" int range_count_launch(
    const float* q, const float* db, int nq, int nd, int d, float thresh,
    int* counts, int* bitmap, int ld_bitmap, int with_bitmap, void* stream) {
  if (nq <= 0 || nd <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* bm = reinterpret_cast<uint32_t*>(bitmap);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(db) % 16 == 0;
  if (with_bitmap)
    return vec ? launch<true, true>(q, db, nq, nd, d, thresh, counts, bm, ld_bitmap, s)
               : launch<true, false>(q, db, nq, nd, d, thresh, counts, bm, ld_bitmap, s);
  return vec ? launch<false, true>(q, db, nq, nd, d, thresh, counts, bm, ld_bitmap, s)
             : launch<false, false>(q, db, nq, nd, d, thresh, counts, bm, ld_bitmap, s);
}
