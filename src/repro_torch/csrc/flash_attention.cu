// Blocked online-softmax attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:90
// (flash_attention_pallas, body _make_kernel :30).  Same function:
//   s = (q . k^T) * scale in fp32; masked entries are -1e30 and their p
//   is set to 0 explicitly; online softmax with an fp32 running max m,
//   normalizer l and accumulator acc; out = acc / max(l, 1e-30), stored
//   in q's type.
// Query i sits at q_pos = q_offset + i (the wrapper passes Sk - Sq
// unless the caller gives another offset).  causal keeps k_pos <= q_pos,
// window (-1: none) keeps k_pos > q_pos - window; a query with no key
// left gives 0.  GQA: query head h reads kv head h / (Hq / Hkv) in
// place, never repeated.  Operands are addressed by element strides for
// B, H and S (unit stride on D, rows 16-byte aligned), so a decode cache
// prefix goes in without a copy.  The output is contiguous (B, Hq, Sq,
// Dv), Dv = D but for the (192, 128) pair below.
//
// Three mappings, chosen statically by Sq and dtype:
// * bf16 prefill (Sq > 1): prefill_tc_kernel.  Bound: operations (at
//   B 4, Hq 32, S 4096, D 128, causal: 5.5e11 FLOP, 0.56 ms on bf16
//   tensor cores, 8.2 ms as fp32 FMA on the CUDA cores).  One block per
//   (128-query tile, b, h), the heaviest causal tiles first; two
//   consumer warpgroups of 64 query rows and a producer warpgroup that
//   gives its registers to them (setmaxnreg 24 / 240).  One producer
//   thread loads Q once and a 3-stage ring of 128-key K and V tiles by
//   TMA (4-d tensor maps over (D, S, H, B) built from the strides; the
//   out-of-bounds zero fill covers the ragged tail; swizzle 128, 64 or
//   32 bytes for D 64 and 128, 32, 16), each stage behind mbarriers.  S = Q.K^T
//   is wgmma m64n128k16 (bf16 products exact, fp32 sums); the online
//   softmax runs in registers on the accumulator fragment, in fp32 (exp
//   on the special-function unit), masking only tiles that cross the
//   diagonal, the window's edge or Sk.  P.V is two bf16 wgmma products
//   into one fp32 accumulator, P_hi.V + P_lo.V with P_hi = bf16(p),
//   P_lo = bf16(p - P_hi), A from registers (the S fragment has the
//   A-fragment layout), V from shared memory MN-major, N = Dv; l sums the
//   fp32 p.  At D <= 128 tile i + 1's Q.K^T is issued with tile i's
//   P.V, so that its softmax runs while P.V does.  Why two terms: the
//   card holds this kernel to one bf16 step of the fp32-P value, and P
//   rounded once to bf16 misses that on 224,501 of 2,097,152 outputs at
//   B 1, H 8, S 2048, D 128, causal (TF32: 14,235; two terms: 0).  The
//   split costs 1.5x the bf16 tensor-core work (a floor of ~0.83 ms at
//   the row above).
// * fp32 prefill (Sq > 1): prefill_fp32_kernel, fp32 FMA on the CUDA
//   cores (tensor cores would need TF32).  One block per (64-query tile,
//   b, h); K and V tiles of 64 keys staged in shared memory and shared by
//   the tile's queries; each of 256 threads holds a 4 x 4 block of the
//   scores and a 4 x D/16 block of the accumulator.
// * decode (Sq == 1), both dtypes: decode_split_kernel + merge_kernel.
//   Bound: bytes (the cache is read once: B 16, Hkv 8, Sk 32768, D 128
//   in bf16 is 2.15 GB, 0.64 ms at 3.35 TB/s).  One block per (b, kv
//   head, group of 4 query heads, split of Sk): the wrapper picks the
//   splits (ops.py decode_splits) so that the grid reaches ~2 x 132
//   blocks; each split owns a contiguous range of 64-key tiles.  A
//   producer warp keeps a 2-stage TMA ring of K and V tiles, three
//   blocks an SM (storage type, swizzled so that both the row reads of
//   the scores and the column reads of P.V are free of bank
//   conflicts); 8 consumer warps, (head, half of each tile's keys)
//   each, score a key a lane and accumulate P.V in fp32 on the CUDA
//   cores (~4 FLOP a byte: far below the card's 295 FLOP/B balance, so
//   tensor cores would buy nothing).
//   The two halves merge in shared memory; a single split writes the
//   output, else each split writes (m, l, acc) in fp32 to the wrapper's
//   scratch and merge_kernel, enqueued by the same call (two launches),
//   gives out = sum_i e^(m_i - M) acc_i / max(sum_i e^(m_i - M) l_i,
//   1e-30): a wholly masked split (m = -1e30, l = 0) adds exactly 0.
//
// Head widths D: 16, 32, 64, 128 and 192 (MLA's concatenated q/k, 128 + 64),
// and one (DK, DV) pair, (192, 128): MLA's v and output at their own
// width in the bf16 prefill (TC<DK, DV> below), P.V at N 128 on a 32 KB V
// tile over a 2-stage K and V ring.  Its floor is 2 pairs (192 + 2 x 128)
// FLOP on the bf16 tensor cores (the two-term P.V), where v padded to
// 192 cost 2 pairs (192 + 2 x 192).  The fp32 prefill and the decode
// mapping are not instantiated on the pair: the launcher answers kPadV
// and the wrapper (ops.py) calls again with v padded to 192; no path
// runs them at MLA's widths.  At DK 192 the bf16 prefill runs a
// tile's steps in order (TC), and the decode mapping fits two blocks an
// SM (Dec<T, D>).  D 64 (the LM examples' width) is D 128's design at one
// box a row: a bf16 row is 128 bytes, one 128-byte swizzle atom, so a Q,
// K or V tile is a single 16 KB box (3-stage ring, 113 KB) and P.V runs
// at N 64; the fp32 prefill's P tile fits in K's rows (51 KB); a decode
// lane owns 2 output columns.
//
// For training, each prefill mapping also writes a query's fp32
// log-sum-exp of the scaled scores (m + log l from its running max and
// normalizer, +inf where no key was left) when the caller passes an lse
// buffer: the one input the backward (flash_attention_bwd.cu, B11) needs
// beyond q, k, v and the output.  Serving passes none.
//
// Left for later: no cluster multicast of K/V across the GQA group, no
// FP8, no persistent blocks, no store of the output through TMA.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q; const void* k; const void* v; void* out;
  int B, Hq, Hkv, Sq, Sk;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss;
  int causal, window, q_offset;
  float scale;
  int n_split, split_tiles;  // decode: splits of Sk and 64-key tiles per split
  float* part_ml;            // decode scratch (B, Hq, n_split, 2): m, l
  float* part_acc;           // decode scratch (B, Hq, n_split, D)
  float* lse;                // prefill, optional (B, Hq, Sq): log-sum-exp of the scaled scores, for the backward
};

// a row's natural log-sum-exp from its running max m (natural units) and
// normalizer l; +inf where no key was left, so that the backward's
// exp(s - lse) is 0 on it
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : __int_as_float(0x7f800000);
}

__device__ __forceinline__ bool keep(int qp, int kp, int sk, int causal, int window) {
  return kp < sk && (!causal || kp <= qp) && (window < 0 || kp > qp - window);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// ---------------------------------------------------------------------------
// fp32 prefill on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;        // queries per fp32 prefill tile
constexpr int BK = 64;        // keys per fp32 kv tile
constexpr int NT = 256;       // threads per fp32 prefill block

// rows [row0, row0 + rows) of a (S, D) fp32 operand with row stride
// `stride` into shared rows of pitch `ld`; rows at or past `n_rows` are zero
template <int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* base, long long stride,
                                          int row0, int rows, int n_rows) {
  constexpr int CPR = D / 4;
  for (int idx = threadIdx.x; idx < rows * CPR; idx += NT) {
    const int r = idx / CPR, c = (idx % CPR) * 4;
    const float4 x = row0 + r < n_rows ? *reinterpret_cast<const float4*>(base + (long long)(row0 + r) * stride + c)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * ld + c) = x;
  }
}

// the probability tile reuses the K tile's rows where it fits (D 64 and 128)
template <int D> struct Prefill {
  static constexpr bool p_in_k = BQ * (BK + 4) <= BK * (D + 4);
  static constexpr size_t smem = sizeof(float) * (2 * BQ * (D + 4) + BK * D + (p_in_k ? 0 : BQ * (BK + 4)));
};
template <int D>
__global__ void __launch_bounds__(NT) prefill_fp32_kernel(Params p) {
  constexpr int LD = D + 4, LP = BK + 4, DJ = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // BQ x LD
  float* Ks = Qs + BQ * LD;       // BK x LD
  float* Vs = Ks + BK * LD;       // BK x D
  float* Ps = Prefill<D>::p_in_k ? Ks : Vs + BK * D;  // BQ x LP

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y, b = bh / p.Hq, h = bh % p.Hq;
  const int g = h / (p.Hq / p.Hkv);
  const float* qb = static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
  const float* kb = static_cast<const float*>(p.k) + b * p.ksb + g * p.ksh;
  const float* vb = static_cast<const float*>(p.v) + b * p.vsb + g * p.vsh;
  const int off = p.q_offset;

  load_rows<D>(Qs, LD, qb, p.qss, q0, BQ, p.Sq);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF; l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // the kv tiles that hold an unmasked key for some query of this tile
  const int q_first = q0 + off, q_last = min(q0 + BQ, p.Sq) - 1 + off;
  const int n_tiles = (p.Sk + BK - 1) / BK;
  int t_hi = n_tiles - 1;
  if (p.causal) t_hi = q_last < 0 ? -1 : min(t_hi, q_last / BK);
  int t_lo = 0;
  if (p.window >= 0 && q_first - p.window + 1 > 0) t_lo = (q_first - p.window + 1) / BK;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's P.V is done with Ks, Vs, Ps
    load_rows<D>(Ks, LD, kb, p.kss, k0, BK, p.Sk);
    load_rows<D>(Vs, D, vb, p.vss, k0, BK, p.Sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    if (Prefill<D>::p_in_k) __syncthreads();  // every thread is done reading Ks

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qp = q0 + r + off;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = q0 + r < p.Sq && keep(qp, k0 + tx + 16 * j, p.Sk, p.causal, p.window);
        s[i][j] = ok[j] ? s[i][j] * p.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o >= 1; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[r * LP + tx + 16 * j] = pj;
        sum += pj;
      }
#pragma unroll
      for (int o = 8; o >= 1; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();

    float pv[4][DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) pv[i][j] = 0.f;
#pragma unroll 1
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * LP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[DJ];
#pragma unroll
        for (int j = 0; j < DJ; ++j) vv[j] = Vs[(kk + u) * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pu = u == 0 ? pr[i].x : u == 1 ? pr[i].y : u == 2 ? pr[i].z : pr[i].w;
#pragma unroll
          for (int j = 0; j < DJ; ++j) pv[i][j] = fmaf(pu, vv[j], pv[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] = acc[i][j] * corr[i] + pv[i][j];
  }

  float* ob = static_cast<float*>(p.out) + ((long long)(b * p.Hq + h) * p.Sq) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= p.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) ob[(long long)(q0 + r) * D + tx + 16 * j] = acc[i][j] / den;
    if (p.lse != nullptr && tx == 0) p.lse[(long long)(b * p.Hq + h) * p.Sq + q0 + r] = row_lse(m[i], l[i]);
  }
}

// ---------------------------------------------------------------------------
// mbarriers, TMA and wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte aligned address at or after p (the swizzle's repeat)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-d tensor map at coordinates (c0, c1, c2, c3), innermost first
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// named barrier 1 over the consumer threads (the producer warp has left)
__device__ __forceinline__ void consumers_sync(int n_threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n_threads) : "memory");
}

// 2^x on the special-function unit (flushes results below 2^-126 to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// shared-memory matrix descriptor: start address, leading and stride
// byte offsets, layout 1/2/3 = 128/64/32-byte swizzle (the tensor map's)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// wait until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence or the wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int M, int N>
__device__ __forceinline__ void pin(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) pin(r[i]);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) { return *reinterpret_cast<uint32_t*>(&x); }

// wgmma m64nNk16, bf16 inputs, fp32 accumulators (see the PTX ISA's wgmma.mma_async)
// d (64 x 128) (+)= A (64 x 16 bf16, smem) . B (16 x 128 bf16, smem), both K-major;
// accumulate 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128) += A (64 x 16 bf16, registers) . B (16 x 128 bf16, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 192) += A (64 x 16 bf16, registers) . B (16 x 192 bf16, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}"
      ", {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64) += A (64 x 16 bf16, registers) . B (16 x 64 bf16, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32) += A (64 x 16 bf16, registers) . B (16 x 32 bf16, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 16) += A (64 x 16 bf16, registers) . B (16 x 16 bf16, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// bf16 prefill on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TQ = 128;                      // queries per block: two warpgroups of 64
constexpr int TK = 128;                      // keys per K/V tile
constexpr int CONSUMERS = 256;               // the two consumer warpgroups
constexpr int TC_THREADS = CONSUMERS + 128;  // + the producer warpgroup (one thread issues)

// The bf16 prefill is instantiated on a (DK, DV) pair: q and k are DK
// wide, v and the output DV (DK == DV but for MLA's (192, 128)).
// DK <= 128 (OVERLAP): a 3-stage K and V ring, and tile i + 1's Q.K^T
// issued with tile i's P.V, so that its softmax runs while P.V does.
// DK 192: ptxas sizes the kernel by its 384 threads, 168 registers a
// thread whatever setmaxnreg gives the consumers at run time, and S (64)
// beside P_hi/P_lo (64) in flight beside O does not fit them, so each
// tile's steps run in order (Q.K^T, softmax, P.V) and the two consumer
// warpgroups' steps interleave on the tensor cores.  (192, 128): O is 64
// registers (P.V at N 128 on a 32 KB V tile), and a 2-stage K and V ring
// (Q 48 + 2 x 48 + 2 x 32 KB = 209 KB; a third stage would pass the
// 227 KB a block may hold); on the card this ran faster than overlapping
// 64-key half tiles (which fit the registers) and as fast as making the
// two warpgroups take turns on the tensor cores.  (192, 192): a 48 KB
// tile, so one K and one V stage.  A K stage is released as soon as its
// Q.K^T has completed, a V stage after its P.V, so the producer refills K
// a whole tile's softmax and P.V ahead of its use.
template <int DK, int DV = DK> struct TC {
  static constexpr int ROWB = DK * 2 < 128 ? DK * 2 : 128;  // bytes of a row within one TMA box: the swizzle span
  static_assert(DK == DV || (DK * 2 >= 128 && DV * 2 >= 128), "a pair's tiles share one swizzle span");
  static constexpr int BOXD = ROWB / 2;                      // elements of a row within one box
  static constexpr int BOX = TK * ROWB;                      // bytes of one box (TQ == TK rows)
  static constexpr int TILE_K = DK / BOXD * BOX;             // bytes of a Q or K tile
  static constexpr int TILE_V = DV / BOXD * BOX;             // bytes of a V tile
  static constexpr uint32_t LAYOUT = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
  static constexpr uint32_t SBO = 8 * ROWB;                  // 8-row group stride
  static constexpr bool OVERLAP = DK <= 128;
  static constexpr int KST = DK <= 128 ? 3 : DV <= 128 ? 2 : 1;  // K stages
  static constexpr int VST = KST;                                // V stages
  static constexpr size_t smem = 1024 + (size_t)TILE_K * (1 + KST) + (size_t)TILE_V * VST;
};

// S = Q . K^T, 64 x 128 scores of one warpgroup from K-major operands; a
// 16-wide step of D is 32 bytes along the swizzled row
template <int DK, int DV>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_addr, uint32_t k_addr) {
  using C = TC<DK, DV>;
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    const uint32_t at = (kk * 32 / C::ROWB) * C::BOX + (kk * 32) % C::ROWB;
    wgmma_ss_n128(sc, gmma_desc(q_addr + at, 16, C::SBO, C::LAYOUT), gmma_desc(k_addr + at, 16, C::SBO, C::LAYOUT),
                  kk > 0);
  }
}

// O += P_hi . V + P_lo . V, N = DV; V is MN-major (DV contiguous): a
// 16-key step is 16 rows, and the leading byte offset steps from one box
// of DV (a swizzle atom) to the next
template <int DK, int DV>
__device__ __forceinline__ void issue_pv(float (&o)[DV / 2], const uint32_t (&hi)[8][4], const uint32_t (&lo)[8][4],
                                         uint32_t v_addr) {
  using C = TC<DK, DV>;
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    const uint64_t dv = gmma_desc(v_addr + kc * 16 * C::ROWB, C::BOX, C::SBO, C::LAYOUT);
    wgmma_rs(o, hi[kc], dv);
    wgmma_rs(o, lo[kc], dv);
  }
}

// online softmax of one score tile in place (scores in, p out), in base
// 2 (exp(x) = exp2(x log2 e)); rows `qp` and `qp + 8`, columns
// k0 + 8 j + {0, 1} (k0 includes this thread's 2 (lane % 4)); EDGE: the
// tile crosses the diagonal, the window's edge or Sk, and is masked
template <bool EDGE>
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2], float (&l)[2], float (&corr)[2], int qp,
                                             int k0, const Params& p, float sl2) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * j + 2 * hr + e;
        float x = sc[idx] * sl2;
        if (EDGE && !keep(qp + 8 * hr, k0 + 8 * j + e, p.Sk, p.causal, p.window)) x = NEG_INF;
        sc[idx] = x;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[hr], mx);
    corr[hr] = ex2(m[hr] - m_new);
    m[hr] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * j + 2 * hr + e;
        const float pr = EDGE && sc[idx] == NEG_INF ? 0.f : ex2(sc[idx] - m_new);  // masked p is exactly 0
        sc[idx] = pr;
        sum += pr;
      }
    l[hr] = l[hr] * corr[hr] + sum;  // this thread's share; the row's 4 threads add up at the end
  }
}

// P = P_hi + P_lo in bf16, as A fragments: keys 16 kc .. 16 kc + 15 are
// accumulator registers 8 kc .. 8 kc + 7, already in A-fragment order
__device__ __forceinline__ void split_p(const float (&sc)[64], uint32_t (&hi)[8][4], uint32_t (&lo)[8][4]) {
#pragma unroll
  for (int kc = 0; kc < 8; ++kc)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float a = sc[8 * kc + 2 * t], c = sc[8 * kc + 2 * t + 1];
      const __nv_bfloat162 ph = __floats2bfloat162_rn(a, c);
      hi[kc][t] = bits(ph);
      lo[kc][t] = bits(__floats2bfloat162_rn(a - __low2float(ph), c - __high2float(ph)));
    }
}

template <int DK, int DV>
__global__ void __launch_bounds__(TC_THREADS, 1)
    prefill_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, Params p) {
  using C = TC<DK, DV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* ks = qs + C::TILE_K;            // KST K tiles
  uint8_t* vs = ks + C::KST * C::TILE_K;   // VST V tiles
  __shared__ __align__(8) uint64_t q_full, k_full[C::KST], v_full[C::VST], k_empty[C::KST], v_empty[C::VST];

  const int n_qt = (p.Sq + TQ - 1) / TQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * TQ;  // the heaviest causal tiles launch first
  const int bh = blockIdx.y, b = bh / p.Hq, h = bh % p.Hq;
  const int g = h / (p.Hq / p.Hkv);
  const int off = p.q_offset;

  // the kv tiles that hold an unmasked key for some query of this tile
  const int q_first = q0 + off, q_last = min(q0 + TQ, p.Sq) - 1 + off;
  int t_hi = (p.Sk + TK - 1) / TK - 1;
  if (p.causal) t_hi = q_last < 0 ? -1 : min(t_hi, q_last / TK);
  int t_lo = 0;
  if (p.window >= 0 && q_first - p.window + 1 > 0) t_lo = (q_first - p.window + 1) / TK;
  const int n_tiles = t_hi - t_lo + 1;  // <= 0: every query of the tile gives 0

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < C::KST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], CONSUMERS);
    }
    for (int s = 0; s < C::VST; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {  // producer warpgroup: gives its registers up, one thread keeps the rings full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == CONSUMERS) {
      mbar_expect_tx(&q_full, C::TILE_K);
      for (int x = 0; x < DK / C::BOXD; ++x) tma_load(qs + x * C::BOX, &qmap, &q_full, x * C::BOXD, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int sk = i % C::KST, sv = i % C::VST, k0 = (t_lo + i) * TK;
        if (i >= C::KST) mbar_wait(&k_empty[sk], (i / C::KST - 1) & 1);
        mbar_expect_tx(&k_full[sk], C::TILE_K);
        for (int x = 0; x < DK / C::BOXD; ++x)
          tma_load(ks + sk * C::TILE_K + x * C::BOX, &kmap, &k_full[sk], x * C::BOXD, k0, g, b);
        if (i >= C::VST) mbar_wait(&v_empty[sv], (i / C::VST - 1) & 1);
        mbar_expect_tx(&v_full[sv], C::TILE_V);
        for (int x = 0; x < DV / C::BOXD; ++x)
          tma_load(vs + sv * C::TILE_V + x * C::BOX, &vmap, &v_full[sv], x * C::BOXD, k0, g, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");

  // consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) of the
  // tile; this thread holds rows `row` and `row + 8` of the accumulator
  // fragments, columns 8 j + 2 (lane % 4) + {0, 1}.
  const int wg = warp / 4;
  const int row = 64 * wg + 16 * (warp % 4) + lane / 4;
  const int qp = q0 + row + off;
  const int qa = q0 + 64 * wg + off;  // the warpgroup's first query position
  const float sl2 = p.scale * LOG2E;
  const uint32_t q_addr = smem_u32(qs) + wg * 64 * C::ROWB;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, corr[2];
  auto softmax = [&](float (&sc)[64], int k0) {
    if (k0 + TK > p.Sk || (p.causal && k0 + TK - 1 > qa) || (p.window >= 0 && k0 <= qa + 63 - p.window))
      softmax_tile<true>(sc, m, l, corr, qp, k0 + 2 * (lane % 4), p, sl2);
    else
      softmax_tile<false>(sc, m, l, corr, qp, k0 + 2 * (lane % 4), p, sl2);
  };
  auto rescale = [&](float (&o)[DV / 2]) {
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
  };

  float o[DV / 2];
#pragma unroll
  for (int j = 0; j < DV / 2; ++j) o[j] = 0.f;
  float sc[64];
  uint32_t hi[8][4], lo[8][4];

  mbar_wait(&q_full, 0);
  if constexpr (C::OVERLAP) {
    // P.V of tile i runs on the tensor cores while the softmax of tile
    // i + 1 runs
    if (n_tiles > 0) {  // the first tile's probabilities
#pragma unroll
      for (int j = 0; j < 64; ++j) sc[j] = 0.f;
      mbar_wait(&k_full[0], 0);
      pin(sc);
      wgmma_fence();
      issue_qk<DK, DV>(sc, q_addr, smem_u32(ks));
      wgmma_commit();
      wgmma_wait<0>();
      pin(sc);
      mbar_arrive(&k_empty[0]);  // tile 0's K is read
      softmax(sc, t_lo * TK);
      split_p(sc, hi, lo);
    }
    // steady state: tile i + 1's scores are issued ahead of tile i's P.V
    for (int i = 0; i + 1 < n_tiles; ++i) {
      const int sn = (i + 1) % C::KST, sv = i % C::VST, k1 = (t_lo + i + 1) * TK;
      mbar_wait(&k_full[sn], ((i + 1) / C::KST) & 1);
      mbar_wait(&v_full[sv], (i / C::VST) & 1);
      pin(sc), pin(o), pin(hi), pin(lo);
      wgmma_fence();
      issue_qk<DK, DV>(sc, q_addr, smem_u32(ks + sn * C::TILE_K));
      wgmma_commit();
      issue_pv<DK, DV>(o, hi, lo, smem_u32(vs + sv * C::TILE_V));
      wgmma_commit();
      wgmma_wait<1>();  // Q.K^T of tile i + 1 is done; P.V of tile i may still run
      pin(sc);
      mbar_arrive(&k_empty[sn]);  // tile i + 1's K is read
      softmax(sc, k1);
      wgmma_wait<0>();
      pin(o), pin(hi), pin(lo);
      mbar_arrive(&v_empty[sv]);
      rescale(o);
      split_p(sc, hi, lo);
    }
    if (n_tiles > 0) {  // the last tile's P.V
      const int s = (n_tiles - 1) % C::VST;
      mbar_wait(&v_full[s], ((n_tiles - 1) / C::VST) & 1);
      pin(o), pin(hi), pin(lo);
      wgmma_fence();
      issue_pv<DK, DV>(o, hi, lo, smem_u32(vs + s * C::TILE_V));
      wgmma_commit();
      wgmma_wait<0>();
      pin(o), pin(hi), pin(lo);
    }
  } else {
    // one tile at a time: Q.K^T (K's stage released), softmax, P.V (V's
    // stage released); the two warpgroups' steps interleave on the card
#pragma unroll
    for (int j = 0; j < 64; ++j) sc[j] = 0.f;
    for (int i = 0; i < n_tiles; ++i) {
      const int sk = i % C::KST, sv = i % C::VST;
      mbar_wait(&k_full[sk], (i / C::KST) & 1);
      pin(sc), pin(o);
      wgmma_fence();
      issue_qk<DK, DV>(sc, q_addr, smem_u32(ks + sk * C::TILE_K));
      wgmma_commit();
      wgmma_wait<0>();
      pin(sc);
      mbar_arrive(&k_empty[sk]);
      softmax(sc, (t_lo + i) * TK);
      rescale(o);
      split_p(sc, hi, lo);
      mbar_wait(&v_full[sv], (i / C::VST) & 1);
      pin(o), pin(hi), pin(lo);
      wgmma_fence();
      issue_pv<DK, DV>(o, hi, lo, smem_u32(vs + sv * C::TILE_V));
      wgmma_commit();
      wgmma_wait<0>();
      pin(o), pin(hi), pin(lo);
      mbar_arrive(&v_empty[sv]);
    }
  }

  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.out) + ((long long)(b * p.Hq + h) * p.Sq) * DV;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lr = l[hr];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int qi = q0 + row + 8 * hr;
    if (qi >= p.Sq) continue;
    const float den = fmaxf(lr, 1e-30f);
    // m is in base-2 units of the scaled scores
    if (p.lse != nullptr && lane % 4 == 0)
      p.lse[(long long)(b * p.Hq + h) * p.Sq + qi] = row_lse(m[hr] * (1.f / LOG2E), lr);
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)qi * DV + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(o[4 * j + 2 * hr] / den, o[4 * j + 2 * hr + 1] / den);
  }
}

// ---------------------------------------------------------------------------
// decode (Sq == 1): split over Sk, then merge
// ---------------------------------------------------------------------------

constexpr int DBK = 64;                     // keys per decode tile (ops.py DECODE_TILE)
constexpr int DSTAGES = 2;                  // K/V ring depth (three blocks an SM)
constexpr int RG = 4;                       // query heads per decode block (ops.py DECODE_GROUP)
constexpr int DWARPS = 2 * RG;              // consumer warps: (head, half of each tile's keys)
constexpr int D_THREADS = DWARPS * 32 + 32; // + the producer warp

// D 192: the 2-stage ring of 24 KB (bf16) tiles makes 108.6 KB a block,
// so two blocks an SM where D 128 (72.8 KB) fits three; in fp32 (48 KB
// tiles, 206.9 KB) one, as at D 128 (138.3 KB).  A lane's 6 output
// columns are read as 3 pairs, since 6 elements cross a 16-byte chunk.
template <typename T, int D> struct Dec {
  static constexpr int ES = sizeof(T);
  static constexpr int ROWB = D * ES < 128 ? D * ES : 128;  // bytes of a row within one box: the swizzle span
  static constexpr int BOXD = ROWB / ES;
  static constexpr int NBOX = D / BOXD;
  static constexpr int BOX = DBK * ROWB;
  static constexpr int TILE = NBOX * BOX;    // bytes of a K or V tile
  static constexpr int VEC = 16 / ES;        // elements of a 16-byte chunk
  static constexpr int DPL = D >= 32 ? D / 32 : 1;  // output columns a lane owns
  static constexpr int VLOAD = DPL == 6 ? 2 : DPL;  // elements of one V read (within a 16-byte chunk)
  static constexpr size_t smem = 1024 + (size_t)2 * DSTAGES * TILE + sizeof(float) * (RG * D + DWARPS * (D + 2));
};

// byte offset of element (row, col) in a tile stored as swizzled boxes:
// the 16-byte chunk index xor the row's place in the swizzle repeat
template <typename T, int D>
__device__ __forceinline__ uint32_t dec_off(int row, int col) {
  using C = Dec<T, D>;
  const uint32_t o = row * C::ROWB + (col % C::BOXD) * C::ES;
  return (col / C::BOXD) * C::BOX + (o ^ (((o >> 7) & (C::ROWB / 16 - 1)) << 4));
}

// N consecutive elements (within one 16-byte chunk) as floats
template <int N>
__device__ __forceinline__ void load_f(const uint8_t* src, float* dst, float) {
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(src);
    dst[0] = a.x; dst[1] = a.y;
  } else {
    static_assert(N == 1, "fp32: 4, 2 or 1 elements");
    dst[0] = *reinterpret_cast<const float*>(src);
  }
}
template <int N>
__device__ __forceinline__ void load_f(const uint8_t* src, float* dst, __nv_bfloat16) {
  if constexpr (N == 1) {
    dst[0] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(src));
  } else if constexpr (N == 2) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
    dst[0] = f.x; dst[1] = f.y;
  } else {
    static_assert(N == 8 || N == 4, "bf16: 8, 4, 2 or 1 elements");
    uint32_t u[N / 2];
    if constexpr (N == 8) *reinterpret_cast<uint4*>(u) = *reinterpret_cast<const uint4*>(src);
    else *reinterpret_cast<uint2*>(u) = *reinterpret_cast<const uint2*>(src);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
      dst[2 * i] = f.x; dst[2 * i + 1] = f.y;
    }
  }
}

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float(float x) { return x; }
template <> __device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int D>
__global__ void __launch_bounds__(D_THREADS, 3)
    decode_split_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap, Params p) {
  using C = Dec<T, D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);
  uint8_t* vs = ks + DSTAGES * C::TILE;
  float* qs = reinterpret_cast<float*>(vs + DSTAGES * C::TILE);  // RG x D
  float* halves = qs + RG * D;                                    // per warp: acc (D), m, l
  __shared__ __align__(8) uint64_t k_full[DSTAGES], v_full[DSTAGES], empty[DSTAGES];

  const int rep = p.Hq / p.Hkv, n_grp = (rep + RG - 1) / RG;
  const int b = blockIdx.x / (p.Hkv * n_grp), g = blockIdx.x / n_grp % p.Hkv, grp = blockIdx.x % n_grp;
  const int h0 = g * rep + grp * RG;                  // first query head of the group
  const int n_heads = min(RG, rep - grp * RG);
  const int qp = p.q_offset;                          // the one query's position

  // this split's tiles, cut to those that hold an unmasked key
  int t_lo = blockIdx.y * p.split_tiles;
  int t_hi = min(t_lo + p.split_tiles, (p.Sk + DBK - 1) / DBK) - 1;
  if (p.causal) t_hi = qp < 0 ? -1 : min(t_hi, qp / DBK);
  if (p.window >= 0 && qp - p.window + 1 > 0) t_lo = max(t_lo, (qp - p.window + 1) / DBK);
  const int n_tiles = t_hi - t_lo + 1;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < DSTAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], DWARPS);
    }
    mbar_fence_init();
  }
  // the group's q rows in fp32 (row stride: the head stride)
  const T* qb = static_cast<const T*>(p.q) + b * p.qsb + (long long)h0 * p.qsh;
  for (int i = tid; i < RG * D; i += D_THREADS)
    qs[i] = i / D < n_heads ? to_float(qb[(long long)(i / D) * p.qsh + i % D]) : 0.f;
  __syncthreads();

  if (warp == DWARPS) {  // producer: one thread keeps the ring full
    if (lane == 0)
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % DSTAGES, k0 = (t_lo + i) * DBK;
        if (i >= DSTAGES) mbar_wait(&empty[s], (i / DSTAGES - 1) & 1);
        mbar_expect_tx(&k_full[s], C::TILE);
        for (int x = 0; x < C::NBOX; ++x)
          tma_load(ks + s * C::TILE + x * C::BOX, &kmap, &k_full[s], x * C::BOXD, k0, g, b);
        mbar_expect_tx(&v_full[s], C::TILE);
        for (int x = 0; x < C::NBOX; ++x)
          tma_load(vs + s * C::TILE + x * C::BOX, &vmap, &v_full[s], x * C::BOXD, k0, g, b);
      }
    return;
  }

  // consumers: warp (r, half) scores key half * 32 + lane of each tile
  // for head r and owns columns [col, col + DPL) of its P.V
  const int r = warp % RG, half = warp / RG;
  const int kk = half * 32 + lane, col = lane * C::DPL;
  const float* qr = qs + r * D;
  float m = NEG_INF, l = 0.f, acc[C::DPL];
#pragma unroll
  for (int e = 0; e < C::DPL; ++e) acc[e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % DSTAGES, k0 = (t_lo + i) * DBK;
    const uint32_t par = (i / DSTAGES) & 1;
    const uint8_t* kt = ks + s * C::TILE;
    const uint8_t* vt = vs + s * C::TILE;

    mbar_wait(&k_full[s], par);
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < D; c += C::VEC) {
      float kx[C::VEC];
      load_f<C::VEC>(kt + dec_off<T, D>(kk, c), kx, T());
#pragma unroll
      for (int e = 0; e < C::VEC; e += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qr + c + e);
        dot = fmaf(qv.x, kx[e], dot);
        dot = fmaf(qv.y, kx[e + 1], dot);
        dot = fmaf(qv.z, kx[e + 2], dot);
        dot = fmaf(qv.w, kx[e + 3], dot);
      }
    }
    const bool ok = keep(qp, k0 + kk, p.Sk, p.causal, p.window);
    const float x = ok ? dot * p.scale : NEG_INF;
    float mx = x;
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    const float pk = ok ? expf(x - m_new) : 0.f;  // masked p is exactly 0
    l = l * corr + pk;
    m = m_new;
#pragma unroll
    for (int e = 0; e < C::DPL; ++e) acc[e] *= corr;

    mbar_wait(&v_full[s], par);
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const float pj = __shfl_sync(0xffffffffu, pk, j);
      if (col < D) {
        float vx[C::DPL];
#pragma unroll
        for (int e = 0; e < C::DPL; e += C::VLOAD)
          load_f<C::VLOAD>(vt + dec_off<T, D>(half * 32 + j, col + e), vx + e, T());
#pragma unroll
        for (int e = 0; e < C::DPL; ++e) acc[e] = fmaf(pj, vx[e], acc[e]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // the two halves of a head merge; one split writes the output, several
  // write their (m, l, acc) for merge_kernel
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  float* mine = halves + warp * (D + 2);
  if (col < D)
#pragma unroll
    for (int e = 0; e < C::DPL; ++e) mine[col + e] = acc[e];
  if (lane == 0) { mine[D] = m; mine[D + 1] = l; }
  consumers_sync(DWARPS * 32);
  if (half != 0 || r >= n_heads || col >= D) return;
  const float* other = halves + (warp + RG) * (D + 2);
  const float m1 = other[D], mm = fmaxf(m, m1);
  const float w0 = expf(m - mm), w1 = expf(m1 - mm);
  const float ll = w0 * l + w1 * other[D + 1];
  const long long bh = (long long)b * p.Hq + h0 + r;
  if (p.n_split == 1) {
    T* ob = static_cast<T*>(p.out) + bh * D;  // Sq == 1
#pragma unroll
    for (int e = 0; e < C::DPL; ++e) store(ob + col + e, (w0 * acc[e] + w1 * other[col + e]) / fmaxf(ll, 1e-30f));
  } else {
    const long long at = bh * p.n_split + blockIdx.y;
#pragma unroll
    for (int e = 0; e < C::DPL; ++e) p.part_acc[at * D + col + e] = w0 * acc[e] + w1 * other[col + e];
    if (lane == 0) { p.part_ml[2 * at] = mm; p.part_ml[2 * at + 1] = ll; }
  }
}

// out[bh] = sum_i e^(m_i - M) acc_i / max(sum_i e^(m_i - M) l_i, 1e-30),
// M = max_i m_i; one block of D threads per (b, query head)
template <typename T>
__global__ void merge_kernel(const float* __restrict__ ml, const float* __restrict__ acc, T* __restrict__ out,
                             int n_split, int D) {
  const long long bh = blockIdx.x;
  const int c = threadIdx.x;
  const float* mb = ml + bh * n_split * 2;
  float mm = NEG_INF;
  for (int i = 0; i < n_split; ++i) mm = fmaxf(mm, mb[2 * i]);
  float ll = 0.f, a = 0.f;
  for (int i = 0; i < n_split; ++i) {
    const float w = expf(mb[2 * i] - mm);
    ll = fmaf(w, mb[2 * i + 1], ll);
    a = fmaf(w, acc[(bh * n_split + i) * D + c], a);
  }
  store(out + bh * D + c, a / fmaxf(ll, 1e-30f));
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a 4-d map over (D, S, H, B) of an operand with element strides (ss, sh,
// sb), boxes of (box_d, box_s) swizzled over rows of `rowb` bytes
template <typename T>
cudaError_t make_map(CUtensorMap* map, const void* base, int D, int S, int H, int B, long long ss, long long sh,
                     long long sb, int box_d, int box_s, int rowb) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  constexpr int es = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(ss * es), (cuuint64_t)(sh * es), (cuuint64_t)(sb * es)};
  const cuuint32_t box[4] = {(cuuint32_t)box_d, (cuuint32_t)box_s, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = rowb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                               : rowb == 64  ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DK, int DV = DK>
cudaError_t launch_prefill_tc(const Params& p, cudaStream_t stream) {
  using C = TC<DK, DV>;
  CUtensorMap qm, km, vm;
  cudaError_t e = make_map<__nv_bfloat16>(&qm, p.q, DK, p.Sq, p.Hq, p.B, p.qss, p.qsh, p.qsb, C::BOXD, TQ, C::ROWB);
  if (e == cudaSuccess)
    e = make_map<__nv_bfloat16>(&km, p.k, DK, p.Sk, p.Hkv, p.B, p.kss, p.ksh, p.ksb, C::BOXD, TK, C::ROWB);
  if (e == cudaSuccess)
    e = make_map<__nv_bfloat16>(&vm, p.v, DV, p.Sk, p.Hkv, p.B, p.vss, p.vsh, p.vsb, C::BOXD, TK, C::ROWB);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(prefill_tc_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.Sq + TQ - 1) / TQ, p.B * p.Hq);
  prefill_tc_kernel<DK, DV><<<grid, TC_THREADS, C::smem, stream>>>(qm, km, vm, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_prefill_fp32(const Params& p, cudaStream_t stream) {
  constexpr size_t bytes = Prefill<D>::smem;
  cudaError_t e = cudaFuncSetAttribute(prefill_fp32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.Hq);
  prefill_fp32_kernel<D><<<grid, NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_decode(const Params& p, cudaStream_t stream) {
  using C = Dec<T, D>;
  CUtensorMap km, vm;
  cudaError_t e = make_map<T>(&km, p.k, D, p.Sk, p.Hkv, p.B, p.kss, p.ksh, p.ksb, C::BOXD, DBK, C::ROWB);
  if (e == cudaSuccess) e = make_map<T>(&vm, p.v, D, p.Sk, p.Hkv, p.B, p.vss, p.vsh, p.vsb, C::BOXD, DBK, C::ROWB);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(decode_split_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);
  if (e != cudaSuccess) return e;
  const int n_grp = (p.Hq / p.Hkv + RG - 1) / RG;
  dim3 grid(p.B * p.Hkv * n_grp, p.n_split);
  decode_split_kernel<T, D><<<grid, D_THREADS, C::smem, stream>>>(km, vm, p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.n_split == 1) return e;
  merge_kernel<T><<<p.B * p.Hq, D, 0, stream>>>(p.part_ml, p.part_acc, static_cast<T*>(p.out), p.n_split, D);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, int dtype, cudaStream_t stream) {
  if (p.Sq == 1) return dtype == 1 ? launch_decode<__nv_bfloat16, D>(p, stream) : launch_decode<float, D>(p, stream);
  return dtype == 1 ? launch_prefill_tc<D>(p, stream) : launch_prefill_fp32<D>(p, stream);
}

}  // namespace

// dtype: 0 fp32, 1 bf16.  Dv is v's and the output's width: D, or 128
// at D 192 in the bf16 prefill (the one pair).  Where the mapping is not
// instantiated on (D, Dv), nothing is launched and kPadV is returned: the
// caller pads v to D.  Decode (Sq == 1) runs n_split splits of
// split_tiles 64-key tiles each; with n_split > 1, part_ml (B, Hq,
// n_split, 2) and part_acc (B, Hq, n_split, D) are fp32 scratch and a
// second kernel merges them.  lse, when not null, receives each query's
// fp32 log-sum-exp of the scaled scores (B, Hq, Sq) from the prefill
// mappings (Sq > 1; the decode mapping writes none).  Returns
// cudaGetLastError() after the launches.
constexpr int kPadV = -1;

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype,
    int B, int Hq, int Hkv, int Sq, int Sk, int D, int Dv,
    long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss,
    int causal, int window, int q_offset, float scale,
    int n_split, int split_tiles, void* part_ml, void* part_acc, void* lse, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || (dtype != 0 && dtype != 1) ||
      (lse != nullptr && Sq == 1))
    return (int)cudaErrorInvalidValue;
  if (Sq == 1 && (n_split < 1 || split_tiles < 1 || (long long)n_split * split_tiles * DBK < Sk ||
                  (n_split > 1 && (part_ml == nullptr || part_acc == nullptr))))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, out, B, Hq, Hkv, Sq, Sk, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, causal, window, q_offset,
           scale, n_split, split_tiles, static_cast<float*>(part_ml), static_cast<float*>(part_acc),
           static_cast<float*>(lse)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dv != D) {
    if (D == 192 && Dv == 128 && dtype == 1 && Sq > 1) return (int)launch_prefill_tc<192, 128>(p, s);
    return kPadV;
  }
  switch (D) {
    case 16: return (int)launch<16>(p, dtype, s);
    case 32: return (int)launch<32>(p, dtype, s);
    case 64: return (int)launch<64>(p, dtype, s);
    case 128: return (int)launch<128>(p, dtype, s);
    case 192: return (int)launch<192>(p, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
