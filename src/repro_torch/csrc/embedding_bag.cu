// EmbeddingBag for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag/kernel.py:52
// (embedding_bag_pallas, body _make_kernel :31) together with its ops
// wrapper's combiner (ops.py:31-33).  Same function: for (B, L) int32
// ids, each output row is the fp32 sum of the bag's gathered table rows;
// a negative id is padding and adds nothing, an id >= V reads row V - 1
// (the TPU kernel's row gather clamps); "mean" divides by the bag's
// valid ids, at least 1, so an all-padding bag gives 0.  The table is
// (V, D) contiguous, fp32 or bf16 (widened exactly: its bits << 16); the
// output is (B, D) fp32.
//
// The TPU kernel keeps the table in HBM, scalar-prefetches the ids and
// accumulates 8 bags in VMEM over a sequential grid.  Here a group of G
// lanes owns a bag, G the power of two that covers a row in 16-byte
// pieces (D/4 lanes in fp32, D/8 in bf16, at most 32): at bst's D 32 in
// fp32, 8 lanes a row and 4 bags a warp, one 128-byte row a group and
// load.  Each lane keeps its piece's sums in fp32 registers.
//
// Bound: bytes.  Each distinct row, each id and each output row once:
// 4·(distinct·D + B·L + B·D) in fp32; at bst's user tower (B 262,144, L
// 20, D 32; 3.25 M distinct of 5.24 M ids) 470 MB, 0.140 ms at 3.35
// TB/s, 0.217 ms reading every id's row.  The rows are random 128-byte
// reads of a 640 MB table, so what sets the time is how many are in
// flight.  The design:
//   - ids: a block stages its bags' ids of a batch in shared memory with
//     coalesced loads, so each id is read once from memory;
//   - loads in flight: every row load of a batch is issued before the
//     first add (a bag of L <= 32 is one batch of NB = 8, 16, 24 or 32
//     slots, a longer bag batches of 16); padding and the slots past L
//     are predicated off in the load itself (zero fill), no branch;
//   - cache hints: rows are read with ld.global.nc.L1::no_allocate under
//     an L2 evict-first policy, so the ids and the output keep L2;
//   - stores: 16 bytes a lane (two in bf16);
//   - sums over l in ascending order, as the plain version's.
// A D that is not a multiple of 4 (8 in bf16), or a table whose address
// is not 16-byte aligned, runs the same mapping with one element a lane
// and load (4 bytes in fp32, 2 in bf16); a row wider than 32 pieces runs
// in passes of 32 pieces.  Row offsets are 64-bit: tables run to 10^7
// rows.  Deduplicating the ids (reading each distinct row once) would
// need them grouped by row, a sort of B·L pairs, and is not done.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;  // threads a block

// The L2 policy of the table rows: evicted first.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// One piece of a row, zero where `on` is false (the load is predicated off).
__device__ __forceinline__ uint4 load_piece(const uint4* p, bool on, uint64_t pol) {
  uint4 v;
  asm volatile(
      "{\n"
      "  .reg .pred q;\n"
      "  setp.ne.b32 q, %4, 0;\n"
      "  mov.b32 %0, 0;\n"
      "  mov.b32 %1, 0;\n"
      "  mov.b32 %2, 0;\n"
      "  mov.b32 %3, 0;\n"
      "  @q ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%5], %6;\n"
      "}\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "r"((int)on), "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ uint32_t load_piece(const float* p, bool on, uint64_t pol) {
  uint32_t v;
  asm volatile(
      "{\n"
      "  .reg .pred q;\n"
      "  setp.ne.b32 q, %1, 0;\n"
      "  mov.b32 %0, 0;\n"
      "  @q ld.global.nc.L1::no_allocate.L2::cache_hint.u32 %0, [%2], %3;\n"
      "}\n"
      : "=r"(v)
      : "r"((int)on), "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ uint32_t load_piece(const uint16_t* p, bool on, uint64_t pol) {
  uint32_t v;  // the 16 bits zero-extended into a 32-bit register
  asm volatile(
      "{\n"
      "  .reg .pred q;\n"
      "  setp.ne.b32 q, %1, 0;\n"
      "  mov.b32 %0, 0;\n"
      "  @q ld.global.nc.L1::no_allocate.L2::cache_hint.u16 %0, [%2], %3;\n"
      "}\n"
      : "=r"(v)
      : "r"((int)on), "l"(p), "l"(pol));
  return v;
}

// bf16 bits to fp32, exactly
__device__ __forceinline__ float lo_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// T: float, or uint16_t holding bf16 bits.  V16: 16-byte pieces, else
// one element a piece.
template <typename T, bool V16>
struct Piece {
  static constexpr int E = V16 ? 16 / (int)sizeof(T) : 1;  // elements a piece
  using Raw = typename std::conditional<V16, uint4, uint32_t>::type;
  using Src = typename std::conditional<V16, uint4, T>::type;
};

template <typename T>
__device__ __forceinline__ void add_piece(float* acc, uint4 v) {
  if constexpr (sizeof(T) == 4) {
    acc[0] += __uint_as_float(v.x);
    acc[1] += __uint_as_float(v.y);
    acc[2] += __uint_as_float(v.z);
    acc[3] += __uint_as_float(v.w);
  } else {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] += lo_bf16(w[i]);
      acc[2 * i + 1] += hi_bf16(w[i]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void add_piece(float* acc, uint32_t v) {
  acc[0] += sizeof(T) == 4 ? __uint_as_float(v) : lo_bf16(v);  // bf16: its bits in the low half
}

// NB: id slots of a batch; lg: log2 of G, the lanes of a bag.
template <typename T, bool V16, int NB>
__device__ __forceinline__ void bag_sums(const T* __restrict__ table, const int* __restrict__ ids,
                                         float* __restrict__ out, int B, int L, int V, int D, int lg, int mean) {
  using P = Piece<T, V16>;
  constexpr int E = P::E;
  __shared__ int s_ids[NT * NB];  // the block's bags' ids of one batch, NB slots a bag
  const int G = 1 << lg, per_block = NT >> lg;
  const int g = threadIdx.x >> lg, c = threadIdx.x & (G - 1);
  const long long bag0 = (long long)blockIdx.x * per_block, bag = bag0 + g;
  const int pieces = D / E;  // V16: D % E == 0
  const uint64_t pol = evict_first();
  const typename P::Src* rows = reinterpret_cast<const typename P::Src*>(table);
  const int* my = s_ids + g * NB;
  for (int p0 = 0; p0 < pieces; p0 += G) {  // passes of G pieces
    const int piece = p0 + c;
    const bool on = bag < B && piece < pieces;
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    int valid = 0;
    for (int l0 = 0; l0 < L; l0 += NB) {
      const int nl = min(NB, L - l0);
      __syncthreads();  // the last batch's ids are read
      for (int i = threadIdx.x; i < per_block * NB; i += NT) {
        const long long b = bag0 + i / NB;
        const int k = i % NB;
        s_ids[i] = b < B && k < nl ? __ldg(ids + b * L + l0 + k) : -1;
      }
      __syncthreads();
      typename P::Raw v[NB];
#pragma unroll
      for (int k = 0; k < NB; ++k) {  // every load of the batch in flight ...
        const int id = my[k];
        v[k] = load_piece(rows + (long long)min(id, V - 1) * pieces + piece, on && id >= 0, pol);
      }
#pragma unroll
      for (int k = 0; k < NB; ++k) {  // ... before the first add, in ascending l
        add_piece<T>(acc, v[k]);
        valid += my[k] >= 0;
      }
    }
    if (on) {
      const float den = mean ? (float)max(valid, 1) : 1.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = mean ? acc[e] / den : acc[e];
      float* o = out + bag * D + (long long)piece * E;
      if constexpr (V16) {
#pragma unroll
        for (int e = 0; e < E; e += 4) *reinterpret_cast<float4*>(o + e) = make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
      } else {
        o[0] = acc[0];
      }
    }
  }
}

// The two variants, each with the launch bound under which ptxas
// allocates it without spilling: its own choice for 16-byte pieces (a
// cap of 64 registers spilled, 1 block an SM took 164 and ran slower);
// at least 2 blocks an SM (at most 128 registers) for one element a
// lane, where its own choice spilled.
template <typename T, int NB>
__global__ void __launch_bounds__(NT) embedding_bag_vec16(const T* __restrict__ table, const int* __restrict__ ids,
                                                          float* __restrict__ out, int B, int L, int V, int D,
                                                          int lg, int mean) {
  bag_sums<T, true, NB>(table, ids, out, B, L, V, D, lg, mean);
}

template <typename T, int NB>
__global__ void __launch_bounds__(NT, 2) embedding_bag_elem(const T* __restrict__ table, const int* __restrict__ ids,
                                                            float* __restrict__ out, int B, int L, int V, int D,
                                                            int lg, int mean) {
  bag_sums<T, false, NB>(table, ids, out, B, L, V, D, lg, mean);
}

template <typename T, bool V16, int NB>
cudaError_t launch(const void* table, const void* ids, void* out, int B, int L, int V, int D, int mean,
                   cudaStream_t s) {
  constexpr int E = Piece<T, V16>::E;
  const int pieces = D / E;
  int lg = 0;
  while ((1 << lg) < pieces && lg < 5) ++lg;  // G: the power of two covering a row's pieces, at most 32
  const long long per_block = NT >> lg;
  const unsigned blocks = (unsigned)((B + per_block - 1) / per_block);
  auto kernel = V16 ? embedding_bag_vec16<T, NB> : embedding_bag_elem<T, NB>;
  kernel<<<blocks, NT, 0, s>>>(static_cast<const T*>(table), static_cast<const int*>(ids), static_cast<float*>(out), B,
                               L, V, D, lg, mean);
  return cudaGetLastError();
}

template <typename T, bool V16>
cudaError_t by_length(const void* table, const void* ids, void* out, int B, int L, int V, int D, int mean,
                      cudaStream_t s) {
  if (L <= 8) return launch<T, V16, 8>(table, ids, out, B, L, V, D, mean, s);
  if (L <= 16 || L > 32) return launch<T, V16, 16>(table, ids, out, B, L, V, D, mean, s);
  if (L <= 24) return launch<T, V16, 24>(table, ids, out, B, L, V, D, mean, s);
  return launch<T, V16, 32>(table, ids, out, B, L, V, D, mean, s);
}

template <typename T>
cudaError_t dispatch(const void* table, const void* ids, void* out, int B, int L, int V, int D, int mean,
                     cudaStream_t s) {
  const bool v16 = D % (16 / (int)sizeof(T)) == 0 && (reinterpret_cast<uintptr_t>(table) & 15) == 0;
  return v16 ? by_length<T, true>(table, ids, out, B, L, V, D, mean, s)
             : by_length<T, false>(table, ids, out, B, L, V, D, mean, s);
}

}  // namespace

// dtype: 0 fp32, 1 bf16; mean: 0 sum, 1 mean.  Returns cudaGetLastError()
// after the launch.
extern "C" int embedding_bag_launch(const void* table, const void* ids, void* out, int dtype, int B, int L, int V,
                                    int D, int mean, void* stream) {
  if (B <= 0 || L < 0 || V <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0 ? dispatch<float>(table, ids, out, B, L, V, D, mean, s)
                : dtype == 1 ? dispatch<uint16_t>(table, ids, out, B, L, V, D, mean, s)
                             : cudaErrorInvalidValue;
  return (int)e;
}
