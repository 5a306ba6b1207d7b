// EmbeddingBag for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag/kernel.py:52
// (embedding_bag_pallas, body _make_kernel :31) together with its ops
// wrapper's combiner (ops.py:31-33).  Same function: for (B, L) int32
// ids, each output row is the fp32 sum of the bag's gathered table rows;
// a negative id is padding and adds nothing, an id >= V reads row V - 1
// (the TPU kernel's row gather clamps); "mean" divides by the bag's
// valid ids, at least 1, so an all-padding bag gives 0.  The table is
// (V, D) contiguous, fp32 or bf16 (converted with __bfloat162float); the
// output is (B, D) fp32.
//
// The TPU kernel keeps the table in HBM, scalar-prefetches the ids and
// accumulates 8 bags in VMEM over a sequential grid.  Here one warp owns
// one bag and nothing crosses warps: lane j owns columns j, j + 32, ...
// and keeps their sums in registers; the lanes load 32 of the bag's ids
// at a time (one coalesced read) and pass them round with __shfl_sync,
// so a whole warp reads each gathered row together (128 contiguous bytes
// at D 32 in fp32).  Sums run over l in ascending order.  Row offsets
// are 64-bit, (long long)id * D: tables run to 10^7 rows.  8 bags a
// 256-thread block; the ragged last block masks its missing bags, so B
// is never padded.
//
// Bound: bytes.  Each gathered row, each id and each output row once:
// 4·(B·L·D + B·L + B·D) bytes in fp32 (2·B·L·D + 4·(B·L + B·D) in bf16);
// at bst's user tower (B 262,144, L 20, D 32) that is 725 MB, 0.217 ms at
// 3.35 TB/s.  The rows are random 128-byte reads of a 640 MB table, so
// enough of them must be in flight: the loop over a bag's ids is
// unrolled so each warp issues several row loads before it waits, and
// 64 warps an SM hide the rest.  TMA or cp.async staging is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BAGS = 8;             // bags (warps) per block
constexpr int NT = 32 * BAGS;       // threads per block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// NC columns per lane per pass: D <= 32 * NC runs one pass, a wider
// table walks its columns in passes of 32 * NC
template <typename T, int NC>
__global__ void __launch_bounds__(NT) embedding_bag_kernel(const T* __restrict__ table, const int* __restrict__ ids,
                                                           float* __restrict__ out, int B, int L, int V, int D,
                                                           int mean) {
  const int lane = threadIdx.x % 32;
  const long long bag = (long long)blockIdx.x * BAGS + threadIdx.x / 32;
  if (bag >= B) return;  // the whole warp leaves together
  const int* bag_ids = ids + bag * L;
  float* bag_out = out + bag * D;

  for (int c0 = 0; c0 < D; c0 += 32 * NC) {
    float acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = 0.f;
    int valid = 0;
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int n = min(32, L - l0);
      const int mine = lane < n ? bag_ids[l0 + lane] : -1;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int id = __shfl_sync(FULL, mine, j);
        if (id < 0) continue;
        ++valid;
        const T* row = table + (long long)min(id, V - 1) * D + c0 + lane;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          if (c0 + lane + 32 * c < D) acc[c] += to_float(row[32 * c]);
      }
    }
    const float den = mean ? (float)max(valid, 1) : 1.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = c0 + lane + 32 * c;
      if (col < D) bag_out[col] = mean ? acc[c] / den : acc[c];
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const T* table, const int* ids, float* out, int B, int L, int V, int D, int mean,
                   cudaStream_t stream) {
  const unsigned blocks = (unsigned)((B + BAGS - 1) / BAGS);
  embedding_bag_kernel<T, NC><<<blocks, NT, 0, stream>>>(table, ids, out, B, L, V, D, mean);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* table, const void* ids, void* out, int B, int L, int V, int D, int mean,
                     cudaStream_t s) {
  const T* t = static_cast<const T*>(table);
  const int* i = static_cast<const int*>(ids);
  float* o = static_cast<float*>(out);
  if (D <= 32) return launch<T, 1>(t, i, o, B, L, V, D, mean, s);
  if (D <= 64) return launch<T, 2>(t, i, o, B, L, V, D, mean, s);
  if (D <= 128) return launch<T, 4>(t, i, o, B, L, V, D, mean, s);
  return launch<T, 8>(t, i, o, B, L, V, D, mean, s);
}

}  // namespace

// dtype: 0 fp32, 1 bf16; mean: 0 sum, 1 mean.  Returns cudaGetLastError()
// after the launch.
extern "C" int embedding_bag_launch(const void* table, const void* ids, void* out, int dtype, int B, int L, int V,
                                    int D, int mean, void* stream) {
  if (B <= 0 || L < 0 || V <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0 ? dispatch<float>(table, ids, out, B, L, V, D, mean, s)
                : dtype == 1 ? dispatch<__nv_bfloat16>(table, ids, out, B, L, V, D, mean, s)
                             : cudaErrorInvalidValue;
  return (int)e;
}
