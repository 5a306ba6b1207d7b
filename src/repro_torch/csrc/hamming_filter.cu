// Fused Hamming-filter + exact-verify range query for Hopper (sm_90a):
// the Hamming distances are +-1 int8 products on the tensor cores
// (wgmma .s8).  Plain C interface.
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
// Hamming distances as a product: bit l of word c becomes the int8
// s = 1 - 2 bit at column 32c + l of a +-1 row, and then
//
//   sum_k s_q[k] s_d[k] = n_bits - 2 ham      exactly, in int32,
//
// so ham = (n_bits - dot) / 2.  One signature word is one k32 step of
// wgmma .s8, so every width the wrapper admits (w <= 32 words) is a
// whole number of steps.
//
// What bounds it on an H100, at K1's shape (4,096 x 30,437 rows, d 768,
// 512 bits): operations.  2 nq nd n_bits = 1.28e11 int8 operations take
// 0.065 ms at 1,979 TOPS; the rows, signatures and hit words 0.037 ms
// at 3.35 TB/s.  The CUDA-core body this replaces ran one POPC per word
// and pair, nq nd w = 2.0e9 of them, 0.48 ms at 16 a clock and SM.  The
// fp32 verify reads the rows of the band pairs only (0.05% of all pairs
// at K1's row).
//
// Design:
//   * a block owns 128 query rows (two warpgroups of 64) x 128 db
//     columns, 256 threads, two blocks an SM; blocks run in any order
//     and counts meet in integer atomics (exact in any order);
//   * the block expands both signature tiles to +-1 bytes in shared
//     memory four words (128 bits: one 128-byte row of a 128-byte
//     swizzle) at a time, double-buffered: while the tensor cores run
//     chunk c, the block expands chunk c + 1 from registers and loads
//     chunk c + 2's words.  A nibble becomes 4 bytes
//     with two multiplies ((n * 0x204081) & 0x01010101, then * 0xFE +
//     0x01010101); rows past nq or nd and words past w expand to zeros,
//     which add nothing;
//   * a chunk is 4 wgmma m64n128k32 a warpgroup, A (its 64 query rows)
//     and B (the 128 db rows) both K-major from shared memory, int32
//     accumulators;
//   * epilogue from the accumulator fragment: a thread holds columns
//     8 j + 2 t + {0, 1} of rows g and g + 8 (g = lane / 4, t = lane % 4),
//     so a 32-column word is spread over the 4 lanes of a quad and 4
//     column groups.  Each thread sets its 8 bits of every word, two
//     quad shuffles OR them, and lane t stores word t of its rows into
//     shared tiles of sure-accept and band words.  Ragged rows and
//     columns (>= nq, >= nd) are masked here: no padding, no pad
//     correction, and bits past nd are never set;
//   * band verify: the block lists its band pairs in shared memory (in
//     the expansion buffers, free once the products are done; 16,384
//     pairs at most, 2 bytes each, so a saturated band (t_lo = -1,
//     eps > 1, t_hi >= n_bits) lists every pair and drops none) by a
//     block-wide prefix sum of the band words' popcounts, and the 8 warps
//     take the pairs round robin: rows dense in band pairs load no one
//     warp.  A pair's fp32 dot is a warp's (lanes split d, IEEE fmaf,
//     never TF32; float4 loads when d % 4 == 0, two partial sums; a
//     fixed xor-shuffle tree: deterministic), and the bit joins the hit
//     word (atomicOr) when dot > thresh;
//   * out: a row's 4 hit words are __popc'd into one atomicAdd of its
//     count and, in bitmap mode, stored where nonzero;
//   * count-only mode is the same kernel with BITMAP = false;
//   * STATS = true adds the occupancy counters of the `_stats` bodies:
//     each warp sums the __popc of its sure-accept and band words (its 16
//     rows lie in one 32-row group, so in one chunk), the block sums them
//     in shared memory per chunk of chunk_rows rows it touches (chunk_rows
//     is a multiple of 32, or >= nq for one whole-call triple: at most 4
//     chunks), and adds each with three atomicAdds, [accept, band,
//     reject], into int32 slab row `row / chunk_rows`.  Only real pairs
//     are counted (the kernel never pads); the wrapper adds the
//     reference's pad-grid pairs.  The counters read the classification
//     the kernel already makes and change no count or word.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;                 // query rows per block: two warpgroups of 64
constexpr int kCols = 128;                 // db columns per block: one wgmma N
constexpr int kThreads = 256;
constexpr int kChunk = 4;                  // signature words a chunk: one 128-byte row
constexpr int kTile = 128 * 128;           // bytes of a chunk of 128 expanded rows
constexpr int kWords = kCols / 32;         // hit words of a row in a block
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmem = 1024 + 4 * (size_t)kTile;  // two buffers of (A, B)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte aligned address at or after p (the swizzle's repeat)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// this thread's generic-proxy writes to shared memory, visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// K-major shared-memory matrix descriptor with a 128-byte swizzle
// (layout 1): rows of 128 bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// wait until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of the accumulators that
// an in-flight wgmma owns across the fence or the wait
__device__ __forceinline__ void pin(int (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 128) += A (64 x 32 s8, smem) . B (32 x 128 s8, smem), both K-major
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}


// bits 0..15 of v as 16 int8 of +-1 (bit 0 -> +1, bit 1 -> -1), LSB first
__device__ __forceinline__ uint4 plus_minus_one(uint32_t v) {
  uint32_t b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t m = (((v >> (4 * i)) & 0xFu) * 0x00204081u) & 0x01010101u;  // a bit a byte
    b[i] = m * 0xFEu + 0x01010101u;                                            // 0 -> 0x01, 1 -> 0xFF
  }
  return make_uint4(b[0], b[1], b[2], b[3]);
}

// this thread's 2 words of chunk c of rows [r0, r0 + 128) of an (n, w)
// word matrix (item i = tid + 256 j: row i / 4, word kChunk c + i % 4);
// rows >= n and words >= w read nothing
__device__ __forceinline__ void fetch(uint32_t (&v)[2], const uint32_t* __restrict__ sig, int r0, int n, int w,
                                      int c) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = threadIdx.x + kThreads * j, r = i / kChunk, word = c * kChunk + i % kChunk;
    v[j] = r0 + r < n && word < w ? __ldg(sig + (size_t)(r0 + r) * w + word) : 0u;
  }
}

// fetch's words as 128 rows x 128 bytes of +-1 (a word is 32 bytes of a
// row), 128-byte swizzle (16-byte chunk j of row r at position
// j ^ (r % 8)); rows >= n and words >= w are zeros, which add nothing
__device__ __forceinline__ void expand(uint8_t* tile, const uint32_t (&v)[2], int r0, int n, int w, int c) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = threadIdx.x + kThreads * j, r = i / kChunk, k = i % kChunk;
    uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
    if (r0 + r < n && c * kChunk + k < w) {
      lo = plus_minus_one(v[j]);
      hi = plus_minus_one(v[j] >> 16);
    }
    uint8_t* row = tile + r * 128;
    *reinterpret_cast<uint4*>(row + (((2 * k) ^ (r & 7)) << 4)) = lo;
    *reinterpret_cast<uint4*>(row + (((2 * k + 1) ^ (r & 7)) << 4)) = hi;
  }
}

// fp32 dot of two d-rows by a warp: lanes split d (IEEE fmaf, two
// partial sums so that more loads are in flight), a fixed xor tree sums
// them, so every lane holds the same deterministic value
__device__ __forceinline__ float row_dot(const float* __restrict__ a, const float* __restrict__ b, int d, int lane,
                                         bool vec) {
  float s0 = 0.f, s1 = 0.f;
  if (vec) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    int k = lane;
#pragma unroll 4
    for (; k + 32 < d / 4; k += 64) {
      const float4 x = __ldg(a4 + k), y = __ldg(b4 + k), u = __ldg(a4 + k + 32), v = __ldg(b4 + k + 32);
      s0 = fmaf(x.x, y.x, s0);
      s1 = fmaf(u.x, v.x, s1);
      s0 = fmaf(x.y, y.y, s0);
      s1 = fmaf(u.y, v.y, s1);
      s0 = fmaf(x.z, y.z, s0);
      s1 = fmaf(u.z, v.z, s1);
      s0 = fmaf(x.w, y.w, s0);
      s1 = fmaf(u.w, v.w, s1);
    }
    if (k < d / 4) {
      const float4 x = __ldg(a4 + k), y = __ldg(b4 + k);
      s0 = fmaf(x.x, y.x, s0);
      s0 = fmaf(x.y, y.y, s0);
      s0 = fmaf(x.z, y.z, s0);
      s0 = fmaf(x.w, y.w, s0);
    }
  } else {
    for (int k = lane; k < d; k += 32) s0 = fmaf(__ldg(a + k), __ldg(b + k), s0);
  }
  float s = s0 + s1;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

template <bool BITMAP, bool STATS>
__global__ void __launch_bounds__(kThreads, 2) hamming_filter_kernel(
    const float* __restrict__ q, const float* __restrict__ db,
    const uint32_t* __restrict__ qs, const uint32_t* __restrict__ dbs,
    int nq, int nd, int d, int w, float thresh, int t_lo, int t_hi,
    int* __restrict__ counts, uint32_t* __restrict__ bitmap, int ld_bitmap,
    int* __restrict__ stats, int chunk_rows) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* buf = align1024(smem_raw);  // buffer b: A (query rows) at 2 b kTile, B (db rows) after it
  __shared__ uint32_t hit_w[kRows * kWords], band_w[kRows * kWords];
  __shared__ int occupancy[4][2];  // STATS: [accept, band] of each chunk the block touches
  __shared__ int warp_pairs[kWarps];

  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.y * kRows, col0 = blockIdx.x * kCols;
  const int nc = (w + kChunk - 1) / kChunk;

  if (STATS && tid < 8) occupancy[tid / 2][tid % 2] = 0;
  uint32_t qv[2], dv[2];  // this thread's signature words of the next chunk
  fetch(qv, qs, row0, nq, w, 0);
  fetch(dv, dbs, col0, nd, w, 0);
  expand(buf, qv, row0, nq, w, 0);
  expand(buf + kTile, dv, col0, nd, w, 0);
  fetch(qv, qs, row0, nq, w, 1);
  fetch(dv, dbs, col0, nd, w, 1);
  fence_proxy_async();
  __syncthreads();

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
#pragma unroll 1
  for (int c = 0; c < nc; ++c) {
    const uint8_t* a = buf + 2 * (c & 1) * kTile;
    wgmma_fence();  // (acc belongs to the products in flight until the last wait)
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk)
      wgmma_s8(acc, desc_sw128(a + wg * 64 * 128 + 32 * kk), desc_sw128(a + kTile + 32 * kk));
    wgmma_commit();
    if (c + 1 < nc) {  // expand the next chunk while this one runs
      wgmma_wait<1>();  // chunk c - 1, the other buffer's, is done in this warpgroup
      __syncthreads();  // ... and in the other
      uint8_t* nb = buf + 2 * ((c + 1) & 1) * kTile;
      expand(nb, qv, row0, nq, w, c + 1);
      expand(nb + kTile, dv, col0, nd, w, c + 1);
      fetch(qv, qs, row0, nq, w, c + 2);  // in flight while chunk c + 1 runs
      fetch(dv, dbs, col0, nd, w, c + 2);
      fence_proxy_async();
      __syncthreads();
    }
  }
  wgmma_wait<0>();
  pin(acc);

  // classify: rows rl and rl + 8 (block-local), columns 8 j + 2 t + {0, 1}
  const int rl = 64 * wg + 16 * (warp % 4) + g;
  const int n_bits = 32 * w;
  uint32_t aw[2][kWords], bw[2][kWords];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
#pragma unroll
    for (int m = 0; m < kWords; ++m) aw[hr][m] = bw[hr][m] = 0u;
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ham = (n_bits - acc[4 * j + 2 * hr + e]) >> 1;
        const uint32_t bit = 1u << (8 * (j % 4) + 2 * t + e);
        if (ham <= t_lo) aw[hr][j / 4] |= bit;
        else if (ham <= t_hi) bw[hr][j / 4] |= bit;
      }
  int n_accept = 0, n_band = 0;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const bool row_ok = row0 + rl + 8 * hr < nq;
#pragma unroll
    for (int m = 0; m < kWords; ++m) {
      uint32_t a = aw[hr][m], b = bw[hr][m];
      a |= __shfl_xor_sync(0xffffffffu, a, 1);
      a |= __shfl_xor_sync(0xffffffffu, a, 2);
      b |= __shfl_xor_sync(0xffffffffu, b, 1);
      b |= __shfl_xor_sync(0xffffffffu, b, 2);
      if (m == t) {  // lane t of the quad stores word t
        const int valid = nd - (col0 + 32 * m);
        const uint32_t mask = !row_ok || valid <= 0 ? 0u : valid >= 32 ? 0xffffffffu : (1u << valid) - 1u;
        hit_w[(rl + 8 * hr) * kWords + m] = a & mask;
        band_w[(rl + 8 * hr) * kWords + m] = b & mask;
        n_accept += __popc(a & mask);
        n_band += __popc(b & mask);
      }
    }
  }
  if (STATS) {
    n_accept = __reduce_add_sync(0xffffffffu, n_accept);
    n_band = __reduce_add_sync(0xffffffffu, n_band);
    const int first = row0 + 64 * wg + 16 * (warp % 4);  // the warp's 16 rows share one chunk
    if (lane == 0 && (n_accept | n_band)) {
      const int slot = first / chunk_rows - row0 / chunk_rows;
      atomicAdd(&occupancy[slot][0], n_accept);
      atomicAdd(&occupancy[slot][1], n_band);
    }
  }
  __syncthreads();

  // verify the band pairs: the block lists them in shared memory (the
  // expansion buffers, free once the products are done), then the 8 warps
  // take them round robin, so rows dense in band pairs load no one warp
  uint16_t* pairs = reinterpret_cast<uint16_t*>(buf);  // (word << 5) | bit
  const uint32_t b0 = band_w[2 * tid], b1 = band_w[2 * tid + 1];
  const int mine = __popc(b0) + __popc(b1);
  int rank = mine;  // inclusive prefix over the warp's lanes, then over the block
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, rank, off);
    if (lane >= off) rank += v;
  }
  if (lane == 31) warp_pairs[warp] = rank;
  __syncthreads();
  int n_pairs = 0;
  rank -= mine;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const int v = warp_pairs[i];
    rank += i < warp ? v : 0;
    n_pairs += v;
  }
  for (uint32_t bits = b0; bits; bits &= bits - 1) pairs[rank++] = (uint16_t)(2 * tid << 5 | (__ffs(bits) - 1));
  for (uint32_t bits = b1; bits; bits &= bits - 1) pairs[rank++] = (uint16_t)((2 * tid + 1) << 5 | (__ffs(bits) - 1));
  __syncthreads();
  const bool vec = (d & 3) == 0 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(db)) & 15u) == 0;
#pragma unroll 1
  for (int i = warp; i < n_pairs; i += kWarps) {
    const int e = pairs[i], idx = e >> 5, bit = e & 31, r = idx / kWords, m = idx % kWords;
    const float s = row_dot(q + (size_t)(row0 + r) * d, db + (size_t)(col0 + 32 * m + bit) * d, d, lane, vec);
    if (lane == 0 && s > thresh) atomicOr(&hit_w[idx], 1u << bit);
  }
  __syncthreads();

  // out: words tid and tid + 256; the 4 words of a row sit in one quad
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + kThreads * i, r = idx / kWords;
    const uint32_t word = hit_w[idx];
    int n = __popc(word);
    n += __shfl_xor_sync(0xffffffffu, n, 1);
    n += __shfl_xor_sync(0xffffffffu, n, 2);
    if (t == 0 && n) atomicAdd(&counts[row0 + r], n);
    if (BITMAP && word) bitmap[(size_t)(row0 + r) * ld_bitmap + col0 / 32 + idx % kWords] = word;
  }
  if (STATS && tid < 4) {
    const long long chunk = row0 / chunk_rows + tid;
    const long long lo = max((long long)row0, chunk * chunk_rows);
    const long long hi = min(min((long long)row0 + kRows, (long long)nq), (chunk + 1) * chunk_rows);
    if (hi > lo) {
      const int pairs = (int)(hi - lo) * min(kCols, nd - col0);
      int* slot = stats + 3 * chunk;
      atomicAdd(&slot[0], occupancy[tid][0]);
      atomicAdd(&slot[1], occupancy[tid][1]);
      atomicAdd(&slot[2], pairs - occupancy[tid][0] - occupancy[tid][1]);
    }
  }
}

template <bool BITMAP, bool STATS>
cudaError_t launch(dim3 grid, cudaStream_t s, const float* q, const float* db, const uint32_t* qs,
                   const uint32_t* dbs, int nq, int nd, int d, int w, float thresh, int t_lo, int t_hi, int* counts,
                   uint32_t* bm, int ld_bitmap, int* stats, int chunk_rows) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(hamming_filter_kernel<BITMAP, STATS>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  hamming_filter_kernel<BITMAP, STATS><<<grid, kThreads, kSmem, s>>>(
      q, db, qs, dbs, nq, nd, d, w, thresh, t_lo, t_hi, counts, bm, ld_bitmap, stats, chunk_rows);
  return cudaGetLastError();
}

}  // namespace

// q (nq, d), db (nd, d) fp32 rows; q_sig (nq, w), db_sig (nd, w) int32
// words, w <= 32; counts (nq,) and bitmap (nq, ld_bitmap) are added to /
// stored into (zero on entry); stats (ceil(nq / chunk_rows), 3) int32 or
// null.  Returns cudaErrorInvalidValue for shapes the kernel does not
// take, else cudaGetLastError() after the launch.
extern "C" int hamming_filter_launch(
    const float* q, const float* db, const int* q_sig, const int* db_sig,
    int nq, int nd, int d, int w, float thresh, int t_lo, int t_hi,
    int* counts, int* bitmap, int ld_bitmap, int with_bitmap,
    int* stats, int chunk_rows, void* stream) {
  if (nq <= 0 || nd <= 0) return 0;
  if (w <= 0 || w > 32 || d <= 0 || (stats && (chunk_rows <= 0 || (chunk_rows % 32 && chunk_rows < nq))) ||
      (nq + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((nd + kCols - 1) / kCols, (nq + kRows - 1) / kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* qs = reinterpret_cast<const uint32_t*>(q_sig);
  const uint32_t* dbs = reinterpret_cast<const uint32_t*>(db_sig);
  uint32_t* bm = reinterpret_cast<uint32_t*>(bitmap);
  auto body = with_bitmap ? (stats ? &launch<true, true> : &launch<true, false>)
                          : (stats ? &launch<false, true> : &launch<false, false>);
  return (int)body(grid, s, q, db, qs, dbs, nq, nd, d, w, thresh, t_lo, t_hi, counts, bm, ld_bitmap, stats,
                   chunk_rows);
}
