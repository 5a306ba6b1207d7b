// The gradient of blocked attention (B11) for Hopper (sm_90a), plain C
// interface.
//
// Computes what jax.grad takes of the reference's blockwise_attention
// (src/repro/models/layers.py:94, differentiated by jax.value_and_grad at
// src/repro/launch/steps.py:261; it has no Pallas kernel), in the
// FlashAttention-2 shape: the score matrix is never stored, each tile's
// probabilities are recomputed from q . k^T and the forward's per-row
// log-sum-exp.  With s = (q . k^T) * scale, p = exp(s - lse) where the
// mask keeps (query, key), else 0, and D_i = rowsum(dO o O):
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),
//   dQ = scale dS K,  dK = scale dS^T Q.
// The mask is the forward's (flash_attention.cu keep(), copied): query
// i sits at q_offset + i, causal keeps k_pos <= q_pos, window (-1: none)
// keeps k_pos > q_pos - window, keys past Sk and queries past Sq are
// masked.  A row that the forward found no key for has lse = +inf, and
// every one of its (query, key) pairs is masked, so its p is 0 and its
// gradients 0.  Head widths D: 16, 32, 64, 128 and 192 with v as wide as q
// and k, and MLA's (D, Dv) = (192, 128) pair (q, k, dQ, dK 192 wide; v,
// o, dO, dV 128).  Operands are contiguous (B, H, S, D), rows 16-byte
// aligned; the wrapper copies others.  Outputs are in the inputs' type.
// Two mappings, chosen statically by dtype; neither falls back to the
// other.
//
// * bf16: one tensor-core launch, bracketed by two small kernels.  Bound:
//   operations (at B 4, Hq 32, Hkv 8, S 4096, D 128, causal the five
//   products are 1.37e12 FLOP, 1.39 ms on bf16 tensor cores).
//   - attn_bwd_stats_kernel: a warp a query row, (lse log2 e, D) in fp32
//     into the wrapper's scratch, rows padded to a multiple of 64
//     (lse2 = +inf past Sq, so a padded row's p is 0 without a test).
//   - attn_bwd_tc_kernel: a block per (128-key tile, b, kv head), key tile
//     0 (the heaviest under a causal mask) first; two warpgroups of 64 keys
//     each and no producer warpgroup (dK and dV alone take 128 registers a
//     thread; thread 0 issues the copies itself, so the block may use
//     255).  It loads the K and V tiles once by TMA (4-d tensor maps over
//     (D, S, H, B), zero fill past the ragged edge, swizzle 128, 64 or 32
//     bytes for D 64 and 128, 32, 16), then the Q and dO tiles of 64 queries,
//     with their (lse2, D) pairs (a bulk copy), through a 2-stage ring behind
//     mbarriers (step i + 1's copies issued as step i starts), over the kv
//     head's query group (GQA: Hq / Hkv heads) and the query tiles the mask
//     leaves.  Per step, each warpgroup, with M = its keys (so that P^T and
//     dS^T come out in the A-fragment layout):
//       S^T = K Q^T and dP^T = V dO^T (wgmma, both operands K-major in
//       shared memory); P^T = exp2(S^T scale log2 e - lse2) and dS^T =
//       P^T o (dP^T - D) in fp32 registers (exp on the special-function
//       unit; the mask tested only on tiles that cross the diagonal or the
//       window's edge: keys past Sk are zero rows of K and V, and their dK
//       and dV are not written); dS^T, both terms, into shared memory as
//       key rows (a buffer by step parity); the two warpgroups meet at a
//       named barrier; then one chain of products: dV += P^T dO (A from
//       registers, the dO tile read again as MN-major B), dK += dS^T Q (A
//       the buffer's own 64 key rows, K-major) and dQ_part = dS K (A the
//       same buffer read as MN-major, i.e. transposed; K as MN-major B), at
//       D 128 each warpgroup half of dQ_part's columns over all 128 keys,
//       at D 16, 32 and 64 all columns over its own 64 keys.  dK and dV stay in
//       fp32 registers over the whole walk (the group sum taken in place)
//       and are written once, no atomics.  dQ is not recomputed: dQ_part
//       (fp32) is added into the wrapper's zeroed fp32 (B, Hq, Sq_pad, D)
//       accumulator by 16-byte RED.ADD.F32 (lanes pair up by a shuffle).
//     Five products where the FMA mapping below runs seven.  Tried on the
//     card and not kept (scripts/flash_attention_bwd_check.py, queued ms
//     at B 4, Hq 32, Hkv 8, S 4096, D 128, causal): a producer warpgroup
//     beside the two (ptxas sizes a 384-thread block at 168 registers
//     whatever setmaxnreg gives at run time: 136 bytes spilled; 7.27 with
//     scalar adds); dK with dS^T from registers and dQ as a second chain
//     (6.16: 168 bytes spilled where this layout spills 52-60).
//     scripts/flash_attention_bwd_variants.py times this kernel beside
//     copies with scalar adds and with none.
//   - D 64 (the LM examples' width) is the one walk above with each row a
//     single 128-byte box (128-byte swizzle): K and V 16 KB, Q and dO 8 KB
//     a stage, two dS buffers, 130.5 KB; dK and dV take 64 accumulators a
//     thread; dQ_part as at D 16 and 32 (all 64 columns, its own keys).
//   - At q/k 192 (B11b: (192, 192) and MLA's (192, 128)) one walk does
//     not fit.  dK and dV take (DK + DV) / 2 fp32 accumulators a thread:
//     128 at D 128 (where ptxas already reports 255 registers and 52 bytes
//     spilled), 160 at the pair, 192 at (192, 192), before S, dP and the
//     fragments; and the layout above (two K/V tiles, 2-stage Q and dO
//     rings, two dS buffers) takes 225 KB at the pair and 257 KB at (192,
//     192) of the 227 KB a block may hold.  So the block walks its query
//     steps twice over the same resident K and V tiles: walk 1 computes S^T
//     -> P^T and dV += P^T dO (live: dV's DV / 2 accumulators, S^T's 32 and
//     P's 32 fragment registers: 128 at the pair, 160 at (192, 192)), and
//     writes dV; walk 2 computes S^T, dP^T -> dS^T and dK += dS^T Q, dQ_part
//     = dS K (live: dK's 96, S^T and dP^T's 64, then dK's 96 and dQ_part's
//     48: at most 160).  The ring carries both walks' steps in order (Q and
//     dO are read twice).  That is 9 product units of DK or DV width where
//     one walk would run 8 (S^T once more), with the same dQ adds.  The
//     192-wide operands are stored as 32-column boxes (64-byte swizzle):
//     dQ_part's split is 96 columns a warpgroup, three whole boxes of K
//     (with 64-column boxes it would be one and a half).  Shared memory:
//     pair K 48 + V 32 + 2 x (Q 24 + dO 16) + two dS buffers 64 = 225 KB
//     (+ 1 KB alignment, 1 KB static); (192, 192) K 48 + V 48 + 2 x (24 +
//     24) + one dS buffer 32 = 225 KB, with a second barrier a step before
//     the buffer is written again.
//   - attn_bwd_dq_kernel: dQ = scale acc in bf16.
//   Why two terms: the A operands P and dS are fp32 values; each runs as
//   hi + lo bf16 fragments (hi = bf16(x), lo = bf16(x - hi)), two wgmma
//   into one fp32 accumulator, so dV, dK and dQ take P and dS to about 16
//   bits (the forward's P.V does the same: rounded once, P misses one
//   bf16 step of the fp32-P value on 224,501 of 2,097,152 outputs).  So
//   three of the five products count twice, a floor of 8/5 of the bound.
//   The adds into dQ's accumulator land in an order that changes from run
//   to run, so dQ may differ between two calls in its last bits; dK and dV
//   are reproducible bit for bit.
// * fp32: delta_kernel, dkdv_kernel and dq_kernel on the CUDA cores (fp32
//   FMA: tensor cores would need TF32).  dkdv: a block per (64-key tile, b,
//   kv head), 256 threads; the tile's K and V stay in shared memory, the
//   block loops over the group's query heads and the query tiles the mask
//   leaves, recomputes P and dS for each and accumulates dV and dK in
//   registers, written once.  dq: a block per (64-query tile, b, query
//   head), the heaviest causal tiles first; Q, dO, lse and D stay in
//   shared memory while the key tiles the mask leaves stream through.  Both
//   recompute S and dP (seven products, the price of writing dQ without
//   atomics); operands staged in shared memory as fp32, each thread a 4 x
//   4 block of a tile's scores and a 4 x D/16 block of its accumulators.
//   At D 192 dkdv's P and dS share one tile (dV summed before dS is
//   written): two would need 230.5 KB.  MLA's pair runs here with v, o and
//   dO zero-padded to 192 by the wrapper (zero v columns leave dP as it is,
//   zero dO columns give zero dV columns, cut off).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q; const void* k; const void* v; const void* o; const void* dout;
  const float* lse;           // (B, Hq, Sq): the forward's log-sum-exp of the scaled scores
  float* delta;               // fp32 mapping: (B, Hq, Sq) scratch, rowsum(dO o O)
  float* stats;               // bf16 mapping: (B, Hq, Sq_pad, 2) scratch, (lse log2 e, rowsum(dO o O))
  float* dq_acc;              // bf16 mapping: (B, Hq, Sq_pad, D) fp32, zeroed by the caller
  void* dq; void* dk; void* dv;
  int B, Hq, Hkv, Sq, Sk, Sq_pad;
  int causal, window, q_offset;
  float scale;
};

// the forward's mask (flash_attention.cu)
__device__ __forceinline__ bool keep(int qp, int kp, int sk, int causal, int window) {
  return kp < sk && (!causal || kp <= qp) && (window < 0 || kp > qp - window);
}

// ---------------------------------------------------------------------------
// mbarriers, TMA and wgmma (flash_attention.cu's, copied)
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

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to shared memory
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// four consecutive fp32 values added into global memory (16-byte aligned), no return
__device__ __forceinline__ void red_add4(float* p, float a, float b, float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "f"(a), "f"(b), "f"(c), "f"(d) : "memory");
}

// this thread's writes to shared memory, made visible to the tensor cores' reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier 1 over n_threads of the block
__device__ __forceinline__ void warpgroups_sync(int n_threads) {
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

// x = hi + lo in bf16, as wgmma A fragments: hi = bf16(x), lo = bf16(x - hi)
// (x to about 16 bits).  Columns 16 kc .. 16 kc + 15 of an fp32
// accumulator fragment are its registers 8 kc .. 8 kc + 7, already in
// A-fragment order, so a tile's values become the A operand of the next
// product in place.
template <int NK>
__device__ __forceinline__ void split_hi_lo(const float (&x)[8 * NK], uint32_t (&hi)[NK][4], uint32_t (&lo)[NK][4]) {
#pragma unroll
  for (int kc = 0; kc < NK; ++kc)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float a = x[8 * kc + 2 * t], c = x[8 * kc + 2 * t + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, c);
      hi[kc][t] = bits(h);
      lo[kc][t] = bits(__floats2bfloat162_rn(a - __low2float(h), c - __high2float(h)));
    }
}

// wgmma m64nNk16, bf16 inputs, fp32 accumulators (see the PTX ISA's
// wgmma.mma_async).  SS: d (64 x N) (+)= A (64 x 16, smem) . B (16 x N,
// smem); TA, TB 0: K-major, 1: MN-major; accumulate 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[96], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}"
      ", %96, %97, p, 1, 1, %99, %100;\n}\n"
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
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[48], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"
      ", %48, %49, p, 1, 1, %51, %52;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// RS: d (64 x N) += A (64 x 16 bf16, registers) . B (16 x N bf16, smem, MN-major)
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

__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TN = 128;                          // keys per block: two warpgroups of 64
constexpr int TM = 64;                           // queries per step
constexpr int TC_THREADS = 256;                  // two warpgroups; thread 0 also issues the copies
constexpr int NST = 2;                           // stages of the (Q, dO, (lse2, D)) ring
constexpr int PAD = 64;                          // query rows of the scratch and dQ's accumulator (ops.py BWD_PAD)
constexpr int DS_ROW = TM * 2;                   // bytes of a key's row of one dS term: 64 queries, the swizzle span
constexpr int DS_TERM = TN * DS_ROW;             // one dS^T term: 128 key rows
constexpr int DS_BUF = 2 * DS_TERM;              // hi and lo
constexpr size_t SMEM_MAX = 232448;              // shared memory a block may hold
static_assert(TM == PAD, "a step's (lse2, D) pairs are one bulk copy inside the padded rows");

// one operand width's geometry: rows stored as swizzled TMA boxes of BOXD
// elements (ROWB bytes, the swizzle span); K and V tiles of TN rows, Q and
// dO of TM.  At 192 the boxes are 32 wide (64-byte swizzle) so that
// dQ_part's 96 columns a warpgroup are three whole boxes of K (with 64-wide
// boxes they would be one and a half).  SPLIT and NQ are read for the q/k
// width: at 128 and 192 each warpgroup takes half of dQ_part's columns over
// all 128 keys (NQ / 2 accumulators); narrower, all columns over its own 64
// keys.
template <int D> struct Geo {
  static constexpr int ROWB = D == 192 ? 64 : D * 2 < 128 ? D * 2 : 128;
  static constexpr int BOXD = ROWB / 2;
  static constexpr int NBOX = D / BOXD;
  static constexpr int BOXK = TN * ROWB;
  static constexpr int BOXQ = TM * ROWB;
  static constexpr int TILE_K = NBOX * BOXK;
  static constexpr int TILE_Q = NBOX * BOXQ;
  static constexpr uint32_t LAYOUT = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
  static constexpr bool SPLIT = D >= 128;
  static constexpr int NQ = SPLIT ? D / 2 : D;
  static_assert(NQ % BOXD == 0, "a warpgroup's dQ_part columns are whole boxes of K");
};

// the launch at q/k width DK and v width DV.  TWO_WALK: dK and dV do not
// fit beside each other in registers, so the block walks its query steps
// twice (dV first, then dK and dQ).  NDS: two dS buffers (by step parity)
// where they fit, else one and a second barrier a step.
template <int DK, int DV> struct TC {
  using GK = Geo<DK>;
  using GV = Geo<DV>;
  static constexpr bool TWO_WALK = DK + DV > 256;
  static constexpr size_t STATIC = NST * TM * sizeof(float2) + (1 + 2 * NST) * sizeof(uint64_t);
  static constexpr size_t BASE = 1024 + (size_t)GK::TILE_K + GV::TILE_K + NST * ((size_t)GK::TILE_Q + GV::TILE_Q);
  static constexpr int NDS = BASE + 2 * (size_t)DS_BUF + STATIC <= SMEM_MAX ? 2 : 1;
  static constexpr size_t smem = BASE + NDS * (size_t)DS_BUF;
  static_assert(smem + STATIC <= SMEM_MAX, "a block's shared memory");
  static_assert(TWO_WALK || DK == DV, "one walk holds v as wide as q and k");
};

// acc (64 x 64) = A . B^T over D: A 64 rows of a K-major tile of boxes
// BOXK bytes apart (K or V: this warpgroup's keys), B a K-major tile of
// boxes BOXQ apart (Q or dO); a 16-wide step is 32 bytes along the
// swizzled row
template <int D>
__device__ __forceinline__ void issue_scores(float (&acc)[32], uint32_t a_addr, uint32_t b_addr) {
  using G = Geo<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk * 32) % G::ROWB, box = kk * 32 / G::ROWB;
    wgmma_ss<0, 0>(acc, gmma_desc(a_addr + box * G::BOXK + col, 16, 8 * G::ROWB, G::LAYOUT),
                gmma_desc(b_addr + box * G::BOXQ + col, 16, 8 * G::ROWB, G::LAYOUT), kk > 0);
  }
}

// acc (64 x D) += (hi + lo) . B over the step's 64 queries, A from
// registers, B the dO tile as MN-major (D contiguous): a 16-query step is
// 16 rows, and the leading byte offset steps from one box of D to the next
template <int D>
__device__ __forceinline__ void issue_grad(float (&acc)[D / 2], const uint32_t (&hi)[TM / 16][4],
                                           const uint32_t (&lo)[TM / 16][4], uint32_t b_addr) {
  using G = Geo<D>;
#pragma unroll
  for (int kc = 0; kc < TM / 16; ++kc) {
    const uint64_t db = gmma_desc(b_addr + kc * 16 * G::ROWB, G::BOXQ, 8 * G::ROWB, G::LAYOUT);
    wgmma_rs(acc, hi[kc], db);
    wgmma_rs(acc, lo[kc], db);
  }
}

// dK += (dS_hi + dS_lo)^T . Q over the step's 64 queries: A this
// warpgroup's 64 key rows of the dS buffer (K-major: a 16-query step is
// 32 bytes along the swizzled row), B the Q tile as MN-major
template <int D>
__device__ __forceinline__ void issue_dk(float (&acc)[D / 2], uint32_t ds_rows, uint32_t q_addr) {
  using G = Geo<D>;
#pragma unroll
  for (int kc = 0; kc < TM / 16; ++kc) {
    const uint64_t db = gmma_desc(q_addr + kc * 16 * G::ROWB, G::BOXQ, 8 * G::ROWB, G::LAYOUT);
    wgmma_ss<0, 1>(acc, gmma_desc(ds_rows + kc * 32, 16, 8 * DS_ROW, 1), db, 1);
    wgmma_ss<0, 1>(acc, gmma_desc(ds_rows + DS_TERM + kc * 32, 16, 8 * DS_ROW, 1), db, 1);
  }
}

// dQ_part (64 queries x NQ) = (dS_hi + dS_lo) . K: A the dS buffer read
// as dS (MN-major: the queries of a key are contiguous; a 16-key step is
// 16 rows), B the resident K tile as MN-major (16 rows a step).  SPLIT:
// columns [NQ w, NQ w + NQ) (K's boxes from NQ w / BOXD) over all 128
// keys; else all columns over warpgroup w's 64 keys.
template <int D>
__device__ __forceinline__ void issue_dq(float (&acc)[Geo<D>::NQ / 2], uint32_t ds_addr, uint32_t k_addr, int w) {
  using G = Geo<D>;
  constexpr int STEPS = (G::SPLIT ? TN : TN / 2) / 16;
  const uint32_t a0 = ds_addr + (G::SPLIT ? 0 : w * (TN / 2) * DS_ROW);
  const uint32_t b0 = k_addr + (G::SPLIT ? w * (G::NQ / G::BOXD) * G::BOXK : w * (TN / 2) * G::ROWB);
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
    const uint64_t db = gmma_desc(b0 + kk * 16 * G::ROWB, G::BOXK, 8 * G::ROWB, G::LAYOUT);
    wgmma_ss<1, 1>(acc, gmma_desc(a0 + kk * 16 * DS_ROW, DS_TERM, 8 * DS_ROW, 1), db, kk > 0);
    wgmma_ss<1, 1>(acc, gmma_desc(a0 + DS_TERM + kk * 16 * DS_ROW, DS_TERM, 8 * DS_ROW, 1), db, 1);
  }
}

// P^T (and, DS, dS^T) of a (64-key, 64-query) tile in place: s holds S^T
// (key rows kp and kp + 8, query columns qc + 8 j + {0, 1}, positions), dp
// holds dP^T (not read without DS); st the queries' (lse2, D) pairs from
// the tile's first; EDGE: the tile crosses the diagonal or the window's
// edge
template <bool EDGE, bool DS>
__device__ __forceinline__ void probs_t(float (&s)[32], float (&dp)[32], const float2* st, int kp, int qc, int lane,
                                        const Params& p, float sl2) {
#pragma unroll
  for (int j = 0; j < TM / 8; ++j) {
    const float4 sv = *reinterpret_cast<const float4*>(st + 8 * j + 2 * (lane % 4));
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float l2 = e ? sv.z : sv.x, dl = e ? sv.w : sv.y;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int idx = 4 * j + 2 * hr + e;
        float pr = ex2(fmaf(s[idx], sl2, -l2));
        if (EDGE && !keep(qc + 8 * j + e, kp + 8 * hr, p.Sk, p.causal, p.window)) pr = 0.f;
        s[idx] = pr;
        if (DS) dp[idx] = pr * (dp[idx] - dl);
      }
    }
  }
}

// dS^T of warpgroup w's 64 keys (fragments as split_hi_lo leaves them:
// this thread's keys row and row + 8, queries 16 kc + 8 (t / 2) + 2 (lane
// % 4) + {0, 1}, a packed pair) into a dS buffer: per term 128 key rows of
// the 64 queries, 128 bytes in TMA's 128-byte swizzle (16-byte chunk c of
// key row k at chunk c ^ (k % 8)); w's keys are rows 64 w .. 64 w + 63.
// dK reads it as dS^T (K-major), dQ as dS (MN-major).
__device__ __forceinline__ void store_ds(uint8_t* buf, const uint32_t (&hi)[TM / 16][4],
                                         const uint32_t (&lo)[TM / 16][4], int w, int row, int lane) {
  const int x = row & 7;  // rows row and row + 8 share their place in the swizzle
#pragma unroll
  for (int kc = 0; kc < TM / 16; ++kc)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int k = (TN / 2) * w + row + 8 * (t & 1), chunk = 2 * kc + (t >> 1);
      uint8_t* at = buf + k * DS_ROW + ((chunk ^ x) << 4) + 4 * (lane % 4);
      *reinterpret_cast<uint32_t*>(at) = hi[kc][t];
      *reinterpret_cast<uint32_t*>(at + DS_TERM) = lo[kc][t];
    }
}

// dQ_part (64 queries x NQ) added into dQ's fp32 accumulator (row stride
// D) at acc, this lane's first column of row row + 8 odd: lanes 2m and 2m
// + 1 hold columns c, c + 1 and c + 2, c + 3 of rows row and row + 8; one
// exchange gives the even lane row's four and the odd lane row + 8's, each
// added as one 16-byte RED (a quarter of the scalar adds)
template <int D, int NQ>
__device__ __forceinline__ void add_dq(float* acc, const float (&dq)[NQ / 2], int q0, int row, int odd,
                                       const Params& p) {
  const int r = row + 8 * odd;
#pragma unroll
  for (int j = 0; j < NQ / 8; ++j) {
    const float a0 = dq[4 * j], a1 = dq[4 * j + 1], b0 = dq[4 * j + 2], b1 = dq[4 * j + 3];  // row, row + 8
    const float r0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
    if (q0 + r < p.Sq) red_add4(acc + 8 * j, odd ? r0 : a0, odd ? r1 : a1, odd ? b0 : r0, odd ? b1 : r1);
  }
}

// a warpgroup's fp32 accumulator (64 x D) into rows [r0, r0 + 64) of a
// contiguous (rows, D) bf16 operand, times `mul`; rows at or past n_rows
// are not written.  This thread holds rows r0 + row and r0 + row + 8,
// columns 8 j + 2 (lane % 4) + {0, 1}.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, const float (&acc)[D / 2], int r0, int row, int lane,
                                           int n_rows, float mul) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + row + 8 * hr;
    if (r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(base + (long long)r * D + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hr] * mul, acc[4 * j + 2 * hr + 1] * mul);
  }
}

// (lse2, D) of every padded query row, a warp a row (o and dO are DV wide)
template <int DV>
__global__ void __launch_bounds__(256) attn_bwd_stats_kernel(Params p) {
  const long long rows = (long long)p.B * p.Hq * p.Sq_pad;
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long bh = row / p.Sq_pad;
  const int i = (int)(row % p.Sq_pad);
  float acc = 0.f, l2 = __int_as_float(0x7f800000);
  if (i < p.Sq) {
    const long long at = bh * p.Sq + i;
    const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(p.o) + at * DV;
    const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(p.dout) + at * DV;
    for (int d = lane; d < DV; d += 32) acc = fmaf(__bfloat162float(o[d]), __bfloat162float(g[d]), acc);
#pragma unroll
    for (int s = 16; s >= 1; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
    l2 = p.lse[at] * LOG2E;  // +inf stays +inf
  }
  if (lane == 0) reinterpret_cast<float2*>(p.stats)[row] = make_float2(l2, acc);
}

template <int DK, int DV>
__global__ void __launch_bounds__(TC_THREADS, 1)
    attn_bwd_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap gmap, Params p) {
  using C = TC<DK, DV>;
  using GK = typename C::GK;
  using GV = typename C::GV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);
  uint8_t* vs = ks + GK::TILE_K;
  uint8_t* qs = vs + GV::TILE_K;            // NST Q tiles
  uint8_t* gs = qs + NST * GK::TILE_Q;      // NST dO tiles
  uint8_t* ds = gs + NST * GV::TILE_Q;      // NDS dS buffers
  __shared__ __align__(16) float2 st[NST][TM];
  __shared__ __align__(8) uint64_t kv_full, full[NST], empty[NST];

  const int k0 = blockIdx.x * TN;  // key tile 0 sees every query under a causal mask: the heaviest first
  const int bg = blockIdx.y, b = bg / p.Hkv, g = bg % p.Hkv;
  const int rep = p.Hq / p.Hkv;
  const int off = p.q_offset;

  // the query tiles that hold an unmasked (query, key) pair with this key tile
  const int k_last = min(k0 + TN, p.Sk) - 1;
  int qt_lo = 0, qt_hi = (p.Sq + TM - 1) / TM - 1;
  if (p.causal && k0 - off > 0) qt_lo = (k0 - off) / TM;
  if (p.window >= 0) {
    const long long last = (long long)k_last + p.window - 1 - off;  // the last query position a key here reaches
    qt_hi = last < 0 ? -1 : (int)min((long long)qt_hi, last / TM);
  }
  const int n_qt = max(qt_hi - qt_lo + 1, 0), n_steps = rep * n_qt;
  const int n_loads = (C::TWO_WALK ? 2 : 1) * n_steps;  // the ring's loads: each walk's steps in order

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // load j (step j % n_steps) of the Q and dO tiles and (lse2, D) pairs into stage j % NST
  auto load_step = [&](int j) {
    const int s = j % NST, i = j % n_steps, h = g * rep + i / n_qt, q0 = (qt_lo + i % n_qt) * TM;
    mbar_expect_tx(&full[s], GK::TILE_Q + GV::TILE_Q + TM * (int)sizeof(float2));
    for (int x = 0; x < GK::NBOX; ++x)
      tma_load(qs + s * GK::TILE_Q + x * GK::BOXQ, &qmap, &full[s], x * GK::BOXD, q0, h, b);
    for (int x = 0; x < GV::NBOX; ++x)
      tma_load(gs + s * GV::TILE_Q + x * GV::BOXQ, &gmap, &full[s], x * GV::BOXD, q0, h, b);
    bulk_load(st[s], p.stats + 2 * ((long long)(b * p.Hq + h) * p.Sq_pad + q0), TM * sizeof(float2), &full[s]);
  };
  if (tid == 0) {
    mbar_init(&kv_full, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], TC_THREADS);
    }
    mbar_fence_init();
    mbar_expect_tx(&kv_full, GK::TILE_K + GV::TILE_K);
    for (int x = 0; x < GK::NBOX; ++x) tma_load(ks + x * GK::BOXK, &kmap, &kv_full, x * GK::BOXD, k0, g, b);
    for (int x = 0; x < GV::NBOX; ++x) tma_load(vs + x * GV::BOXK, &vmap, &kv_full, x * GV::BOXD, k0, g, b);
    for (int j = 0; j < NST && j < n_loads; ++j) load_step(j);
  }
  __syncthreads();

  // warpgroup w owns keys kw .. kw + 63; this thread holds key rows row
  // and row + 8 of them (and dQ_part's query rows row, row + 8)
  const int w = warp / 4;
  const int row = 16 * (warp % 4) + lane / 4;
  const int kw = k0 + (TN / 2) * w;
  const int odd = lane & 1;
  const float sl2 = p.scale * LOG2E;
  const uint32_t k_addr = smem_u32(ks), v_addr = smem_u32(vs), ds_addr = smem_u32(ds);
  const uint32_t kw_addr = k_addr + w * (TN / 2) * GK::ROWB, vw_addr = v_addr + w * (TN / 2) * GV::ROWB;
  const int cq = GK::SPLIT ? GK::NQ * w : 0;  // dQ_part's first column
  __nv_bfloat16* dk_out = static_cast<__nv_bfloat16*>(p.dk) + (long long)bg * p.Sk * DK;
  __nv_bfloat16* dv_out = static_cast<__nv_bfloat16*>(p.dv) + (long long)bg * p.Sk * DV;
  // thread 0 issues load j + 1 into the stage that load j - 1 released
  auto refill = [&](int j) {
    if (tid == 0 && j >= 1 && j + 1 < n_loads) {
      mbar_wait(&empty[(j + 1) % NST], ((j - 1) / NST) & 1);
      load_step(j + 1);
    }
  };
  // the fp32 accumulator's place for this lane's dQ_part of step i
  auto dq_at = [&](int i) {
    const int h = g * rep + i / n_qt, q0 = (qt_lo + i % n_qt) * TM;
    return p.dq_acc + ((long long)(b * p.Hq + h) * p.Sq_pad + q0 + row + 8 * odd) * DK + cq + 2 * (lane % 4) -
           2 * odd;
  };
  // the (64-key, 64-query) tile at query position qa crosses the diagonal or the window's edge
  auto edge = [&](int qa) {
    return (p.causal && kw + TN / 2 - 1 > qa) || (p.window >= 0 && kw <= qa + TM - 1 - p.window);
  };

  mbar_wait(&kv_full, 0);
  if constexpr (!C::TWO_WALK) {
    float dk[DK / 2], dv[DV / 2];
#pragma unroll
    for (int j = 0; j < DK / 2; ++j) dk[j] = dv[j] = 0.f;
    for (int i = 0; i < n_steps; ++i) {
      const int sx = i % NST, q0 = (qt_lo + i % n_qt) * TM;
      refill(i);
      // a step's scores, fragments and dQ_part live only inside it, each
      // zeroed just before the product that overwrites it: a value held for
      // the wgmma's read-write operands from an earlier point would keep
      // its registers busy
      float s[32], dp[32], dq[GK::NQ / 2];
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
      uint32_t phi[TM / 16][4], plo[TM / 16][4], shi[TM / 16][4], slo[TM / 16][4];
      mbar_wait(&full[sx], (i / NST) & 1);
      const uint32_t q_addr = smem_u32(qs + sx * GK::TILE_Q), g_addr = smem_u32(gs + sx * GV::TILE_Q);
      // S^T = K Q^T, dP^T = V dO^T
      pin(s), pin(dp);
      wgmma_fence();
      issue_scores<DK>(s, kw_addr, q_addr);
      issue_scores<DV>(dp, vw_addr, g_addr);
      wgmma_commit();
      wgmma_wait<0>();
      pin(s), pin(dp);
      const int qa = q0 + off;  // the tile's first query position
      if (edge(qa))
        probs_t<true, true>(s, dp, st[sx], kw + row, qa + 2 * (lane % 4), lane, p, sl2);
      else
        probs_t<false, true>(s, dp, st[sx], kw + row, qa + 2 * (lane % 4), lane, p, sl2);
      split_hi_lo(s, phi, plo);
      split_hi_lo(dp, shi, slo);
      // dS^T to shared memory for dK and dQ (the buffer two steps back is
      // free: both warpgroups waited for its products before the last barrier)
      const uint32_t dsb = (i & 1) * DS_BUF;
      store_ds(ds + dsb, shi, slo, w, row, lane);
      fence_async_shared();
      warpgroups_sync(TC_THREADS);  // both warpgroups' dS^T are in the buffer
      // dV += P^T dO, dK += dS^T Q, dQ_part = dS K, one chain
#pragma unroll
      for (int j = 0; j < GK::NQ / 2; ++j) dq[j] = 0.f;
      pin(dv), pin(dk), pin(phi), pin(plo), pin(dq);
      wgmma_fence();
      issue_grad<DV>(dv, phi, plo, g_addr);
      issue_dk<DK>(dk, ds_addr + dsb + w * (TN / 2) * DS_ROW, q_addr);
      issue_dq<DK>(dq, ds_addr + dsb, k_addr, w);
      wgmma_commit();
      wgmma_wait<0>();
      pin(dv), pin(dk), pin(phi), pin(plo), pin(dq);
      mbar_arrive(&empty[sx]);  // this step's Q, dO and (lse2, D) are read
      add_dq<DK, GK::NQ>(dq_at(i), dq, q0, row, odd, p);
    }
    store_rows<DK>(dk_out, dk, kw, row, lane, p.Sk, p.scale);
    store_rows<DV>(dv_out, dv, kw, row, lane, p.Sk, 1.f);
  } else {
    {  // walk 1: S^T -> P^T -> dV += P^T dO
      float dv[DV / 2];
#pragma unroll
      for (int j = 0; j < DV / 2; ++j) dv[j] = 0.f;
      for (int i = 0; i < n_steps; ++i) {
        const int sx = i % NST, q0 = (qt_lo + i % n_qt) * TM;
        refill(i);
        float s[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) s[j] = 0.f;
        uint32_t phi[TM / 16][4], plo[TM / 16][4];
        mbar_wait(&full[sx], (i / NST) & 1);
        const uint32_t q_addr = smem_u32(qs + sx * GK::TILE_Q), g_addr = smem_u32(gs + sx * GV::TILE_Q);
        pin(s);
        wgmma_fence();
        issue_scores<DK>(s, kw_addr, q_addr);
        wgmma_commit();
        wgmma_wait<0>();
        pin(s);
        const int qa = q0 + off;
        if (edge(qa))
          probs_t<true, false>(s, s, st[sx], kw + row, qa + 2 * (lane % 4), lane, p, sl2);
        else
          probs_t<false, false>(s, s, st[sx], kw + row, qa + 2 * (lane % 4), lane, p, sl2);
        split_hi_lo(s, phi, plo);
        pin(dv), pin(phi), pin(plo);
        wgmma_fence();
        issue_grad<DV>(dv, phi, plo, g_addr);
        wgmma_commit();
        wgmma_wait<0>();
        pin(dv), pin(phi), pin(plo);
        mbar_arrive(&empty[sx]);
      }
      store_rows<DV>(dv_out, dv, kw, row, lane, p.Sk, 1.f);
    }
    {  // walk 2: S^T, dP^T -> dS^T; dK += dS^T Q, dQ_part = dS K
      float dk[DK / 2];
#pragma unroll
      for (int j = 0; j < DK / 2; ++j) dk[j] = 0.f;
      for (int i = 0; i < n_steps; ++i) {
        const int j = n_steps + i, sx = j % NST, q0 = (qt_lo + i % n_qt) * TM;
        refill(j);
        float s[32], dp[32], dq[GK::NQ / 2];
#pragma unroll
        for (int x = 0; x < 32; ++x) s[x] = dp[x] = 0.f;
        uint32_t shi[TM / 16][4], slo[TM / 16][4];
        mbar_wait(&full[sx], (j / NST) & 1);
        const uint32_t q_addr = smem_u32(qs + sx * GK::TILE_Q), g_addr = smem_u32(gs + sx * GV::TILE_Q);
        pin(s), pin(dp);
        wgmma_fence();
        issue_scores<DK>(s, kw_addr, q_addr);
        issue_scores<DV>(dp, vw_addr, g_addr);
        wgmma_commit();
        wgmma_wait<0>();
        pin(s), pin(dp);
        const int qa = q0 + off;
        if (edge(qa))
          probs_t<true, true>(s, dp, st[sx], kw + row, qa + 2 * (lane % 4), lane, p, sl2);
        else
          probs_t<false, true>(s, dp, st[sx], kw + row, qa + 2 * (lane % 4), lane, p, sl2);
        split_hi_lo(dp, shi, slo);
        const uint32_t dsb = (C::NDS == 2 ? (i & 1) : 0) * DS_BUF;
        // one buffer: the other warpgroup's products of the last step have read it
        if (C::NDS == 1) warpgroups_sync(TC_THREADS);
        store_ds(ds + dsb, shi, slo, w, row, lane);
        fence_async_shared();
        warpgroups_sync(TC_THREADS);
#pragma unroll
        for (int x = 0; x < GK::NQ / 2; ++x) dq[x] = 0.f;
        pin(dk), pin(dq);
        wgmma_fence();
        issue_dk<DK>(dk, ds_addr + dsb + w * (TN / 2) * DS_ROW, q_addr);
        issue_dq<DK>(dq, ds_addr + dsb, k_addr, w);
        wgmma_commit();
        wgmma_wait<0>();
        pin(dk), pin(dq);
        mbar_arrive(&empty[sx]);
        add_dq<DK, GK::NQ>(dq_at(i), dq, q0, row, odd, p);
      }
      store_rows<DK>(dk_out, dk, kw, row, lane, p.Sk, p.scale);
    }
  }
}

// dQ = scale acc in bf16 over rows [0, Sq) of each (b, h): four columns a thread
__global__ void __launch_bounds__(256) attn_bwd_dq_kernel(const float* __restrict__ acc, __nv_bfloat16* __restrict__ dq,
                                                          long long n4, int sq, int sq_pad, int d, float scale) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n4) return;
  const long long per = (long long)sq * d / 4;
  const float4 x = reinterpret_cast<const float4*>(acc)[i / per * ((long long)sq_pad * d / 4) + i % per];
  uint2 u;
  u.x = bits(__floats2bfloat162_rn(x.x * scale, x.y * scale));
  u.y = bits(__floats2bfloat162_rn(x.z * scale, x.w * scale));
  reinterpret_cast<uint2*>(dq)[i] = u;
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int BM = 64;        // queries per tile
constexpr int BN = 64;        // keys per tile
constexpr int NT = 256;       // threads per block: 16 x 16
constexpr int LP = BN + 4;    // pitch of a (query, key) tile in shared memory

// rows [row0, row0 + 64) of a contiguous (S, D) operand into shared rows
// of pitch D + 4; rows at or past n_rows are zero
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* base, int row0, int n_rows) {
  constexpr int CPR = D / 4, LD = D + 4;
  for (int idx = threadIdx.x; idx < BM * CPR; idx += NT) {
    const int r = idx / CPR, c = (idx % CPR) * 4;
    const float4 x = row0 + r < n_rows ? *reinterpret_cast<const float4*>(base + (long long)(row0 + r) * D + c)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * LD + c) = x;
  }
}

// s[i][j] = sum_d A[ty + 16 i][d] B[tx + 16 j][d] over two (64, D) tiles
// of pitch D + 4 (the padding spreads a quarter warp's 16-byte reads over
// all 32 banks)
template <int D>
__device__ __forceinline__ void tile_dots(float (&s)[4][4], const float* A, const float* Bt, int tx, int ty) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(Bt + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// P and dS of a (64-query, 64-key) tile from its scores s and dP, both
// (query ty + 16 i, key tx + 16 j), into shared (query, key) tiles of
// pitch LP (either may be null: not written); masked pairs give exactly 0
__device__ __forceinline__ void probs_and_ds(const float (&s)[4][4], const float (&dp)[4][4], float* Ps, float* dSs,
                                             const float* lse_s, const float* del_s, int q0, int k0, int tx, int ty,
                                             const Params& p) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const bool ok = qi < p.Sq && keep(qi + p.q_offset, k0 + c, p.Sk, p.causal, p.window);
      const float pr = ok ? expf(s[i][j] * p.scale - lse_s[r]) : 0.f;
      if (Ps != nullptr) Ps[r * LP + c] = pr;
      if (dSs != nullptr) dSs[r * LP + c] = pr * (dp[i][j] - del_s[r]);
    }
  }
}

// lse and D of the query rows [q0, q0 + 64) into shared memory
__device__ __forceinline__ void load_rows_stats(float* lse_s, float* del_s, const float* lb, const float* db, int q0,
                                                int sq) {
  if (threadIdx.x < BM) {
    const int qi = q0 + threadIdx.x;
    lse_s[threadIdx.x] = qi < sq ? lb[qi] : 0.f;
    del_s[threadIdx.x] = qi < sq ? db[qi] : 0.f;
  }
}

// D_i = rowsum(dO o O), a warp a row
template <int D>
__global__ void __launch_bounds__(NT) delta_kernel(Params p) {
  const long long rows = (long long)p.B * p.Hq * p.Sq;
  const long long row = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* o = static_cast<const float*>(p.o) + row * D;
  const float* g = static_cast<const float*>(p.dout) + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(o[d], g[d], acc);
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) p.delta[row] = acc;
}

template <int D> struct Smem {
  static constexpr int LD = D + 4;
  // dkdv: P and dS share one tile at D 192, where two would pass the 227 KB
  // a block may hold (230.5 KB); dV's sum then runs before dS is written
  static constexpr bool ONE_PD = D > 128;
  // dkdv: K, V, Q, dO tiles, P and dS tiles, lse and D of the query rows
  static constexpr size_t dkdv = sizeof(float) * (4 * 64 * LD + (ONE_PD ? 1 : 2) * BM * LP + 2 * BM);
  // dq: Q, dO, K, V tiles, the dS tile, lse and D
  static constexpr size_t dq = sizeof(float) * (4 * 64 * LD + BM * LP + 2 * BM);
};

// dV += P^T dO (ADD_DV) and dK += dS^T Q (ADD_DK) over a query tile, for
// this thread's keys ty + 16 i and columns tx + 16 j
template <int D, bool ADD_DV, bool ADD_DK>
__device__ __forceinline__ void accumulate_kv(float (&dv)[4][D / 16], float (&dk)[4][D / 16], const float* Ps,
                                              const float* dSs, const float* dOs, const float* Qs, int tx, int ty) {
  constexpr int LD = D + 4;
#pragma unroll 4
  for (int r = 0; r < BM; ++r) {
    float pk[4], sk[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pk[i] = ADD_DV ? Ps[r * LP + ty + 16 * i] : 0.f;
      sk[i] = ADD_DK ? dSs[r * LP + ty + 16 * i] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float go = ADD_DV ? dOs[r * LD + tx + 16 * j] : 0.f, qv = ADD_DK ? Qs[r * LD + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (ADD_DV) dv[i][j] = fmaf(pk[i], go, dv[i][j]);
        if (ADD_DK) dk[i][j] = fmaf(sk[i], qv, dk[i][j]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1) dkdv_kernel(Params p) {
  constexpr int LD = D + 4, DJ = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BN * LD;
  float* Qs = Vs + BN * LD;
  float* dOs = Qs + BM * LD;
  float* Ps = dOs + BM * LD;
  float* dSs = Smem<D>::ONE_PD ? Ps : Ps + BM * LP;
  float* lse_s = dSs + BM * LP;
  float* del_s = lse_s + BM;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * BN;
  const int bg = blockIdx.y, b = bg / p.Hkv, g = bg % p.Hkv;
  const int rep = p.Hq / p.Hkv;
  const long long kv_base = (long long)bg * p.Sk * D;
  load_tile<D>(Ks, static_cast<const float*>(p.k) + kv_base, k0, p.Sk);
  load_tile<D>(Vs, static_cast<const float*>(p.v) + kv_base, k0, p.Sk);

  // the query tiles that hold an unmasked (query, key) pair with this key tile
  const int off = p.q_offset;
  const int k_last = min(k0 + BN, p.Sk) - 1;
  int qt_lo = 0, qt_hi = (p.Sq + BM - 1) / BM - 1;
  if (p.causal && k0 - off > 0) qt_lo = (k0 - off) / BM;
  if (p.window >= 0) {
    const long long last = (long long)k_last + p.window - 1 - off;  // the last query position a key here reaches
    qt_hi = last < 0 ? -1 : (int)min((long long)qt_hi, last / BM);
  }

  float dk[4][DJ], dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int hh = 0; hh < rep; ++hh) {
    const long long bh = (long long)b * p.Hq + g * rep + hh;
    const float* qb = static_cast<const float*>(p.q) + bh * p.Sq * D;
    const float* gb = static_cast<const float*>(p.dout) + bh * p.Sq * D;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * BM;
      __syncthreads();  // the previous tile's accumulation is done with Qs, dOs, Ps, dSs
      load_tile<D>(Qs, qb, q0, p.Sq);
      load_tile<D>(dOs, gb, q0, p.Sq);
      load_rows_stats(lse_s, del_s, p.lse + bh * p.Sq, p.delta + bh * p.Sq, q0, p.Sq);
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_dots<D>(s, Qs, Ks, tx, ty);
      tile_dots<D>(dp, dOs, Vs, tx, ty);
      if constexpr (Smem<D>::ONE_PD) {
        probs_and_ds(s, dp, Ps, nullptr, lse_s, del_s, q0, k0, tx, ty, p);
        __syncthreads();
        accumulate_kv<D, true, false>(dv, dk, Ps, dSs, dOs, Qs, tx, ty);
        __syncthreads();  // dV's reads of P are done
        probs_and_ds(s, dp, nullptr, dSs, lse_s, del_s, q0, k0, tx, ty, p);
        __syncthreads();
        accumulate_kv<D, false, true>(dv, dk, Ps, dSs, dOs, Qs, tx, ty);
      } else {
        probs_and_ds(s, dp, Ps, dSs, lse_s, del_s, q0, k0, tx, ty, p);
        __syncthreads();
        accumulate_kv<D, true, true>(dv, dk, Ps, dSs, dOs, Qs, tx, ty);
      }
    }
  }

  float* dkb = static_cast<float*>(p.dk) + kv_base;
  float* dvb = static_cast<float*>(p.dv) + kv_base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= p.Sk) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dkb[(long long)key * D + tx + 16 * j] = dk[i][j] * p.scale;
      dvb[(long long)key * D + tx + 16 * j] = dv[i][j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1) dq_kernel(Params p) {
  constexpr int LD = D + 4, DJ = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BM * LD;
  float* Ks = dOs + BM * LD;
  float* Vs = Ks + BN * LD;
  float* dSs = Vs + BN * LD;
  float* lse_s = dSs + BM * LP;
  float* del_s = lse_s + BM;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_qt = (p.Sq + BM - 1) / BM;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BM;  // the heaviest causal tiles launch first
  const long long bh = blockIdx.y;
  const int b = (int)(bh / p.Hq), h = (int)(bh % p.Hq);
  const int g = h / (p.Hq / p.Hkv);
  const long long kv_base = ((long long)b * p.Hkv + g) * p.Sk * D;
  load_tile<D>(Qs, static_cast<const float*>(p.q) + bh * p.Sq * D, q0, p.Sq);
  load_tile<D>(dOs, static_cast<const float*>(p.dout) + bh * p.Sq * D, q0, p.Sq);
  load_rows_stats(lse_s, del_s, p.lse + bh * p.Sq, p.delta + bh * p.Sq, q0, p.Sq);

  // the key tiles that hold an unmasked key for some query of this tile (the forward's)
  const int off = p.q_offset;
  const int q_first = q0 + off, q_last = min(q0 + BM, p.Sq) - 1 + off;
  int t_hi = (p.Sk + BN - 1) / BN - 1;
  if (p.causal) t_hi = q_last < 0 ? -1 : min(t_hi, q_last / BN);
  int t_lo = 0;
  if (p.window >= 0 && q_first - p.window + 1 > 0) t_lo = (q_first - p.window + 1) / BN;

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const float* kb = static_cast<const float*>(p.k) + kv_base;
  const float* vb = static_cast<const float*>(p.v) + kv_base;
  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * BN;
    __syncthreads();  // the previous tile's dS . K is done with Ks, Vs, dSs
    load_tile<D>(Ks, kb, k0, p.Sk);
    load_tile<D>(Vs, vb, k0, p.Sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dots<D>(s, Qs, Ks, tx, ty);
    tile_dots<D>(dp, dOs, Vs, tx, ty);
    probs_and_ds(s, dp, nullptr, dSs, lse_s, del_s, q0, k0, tx, ty, p);
    __syncthreads();
    // dQ += dS K for this thread's queries ty + 16 i, columns tx + 16 j
#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kv = Ks[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(ds[i], kv, acc[i][j]);
      }
    }
  }

  float* dqb = static_cast<float*>(p.dq) + bh * p.Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dqb[(long long)qi * D + tx + 16 * j] = acc[i][j] * p.scale;
  }
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

// a 4-d map over (D, S, H, B) of a contiguous bf16 operand, boxes of
// (box_d, box_s) swizzled over rows of `rowb` bytes
cudaError_t make_map(CUtensorMap* map, const void* base, int D, int S, int H, int B, int box_d, int box_s, int rowb) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2, (cuuint64_t)H * S * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_d, (cuuint32_t)box_s, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = rowb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                               : rowb == 64  ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DK, int DV>
cudaError_t launch_tc(const Params& p, cudaStream_t stream) {
  using C = TC<DK, DV>;
  using GK = typename C::GK;
  using GV = typename C::GV;
  const long long rows = (long long)p.B * p.Hq * p.Sq_pad;
  attn_bwd_stats_kernel<DV><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  CUtensorMap qm, km, vm, gm;
  if (e == cudaSuccess) e = make_map(&qm, p.q, DK, p.Sq, p.Hq, p.B, GK::BOXD, TM, GK::ROWB);
  if (e == cudaSuccess) e = make_map(&km, p.k, DK, p.Sk, p.Hkv, p.B, GK::BOXD, TN, GK::ROWB);
  if (e == cudaSuccess) e = make_map(&vm, p.v, DV, p.Sk, p.Hkv, p.B, GV::BOXD, TN, GV::ROWB);
  if (e == cudaSuccess) e = make_map(&gm, p.dout, DV, p.Sq, p.Hq, p.B, GV::BOXD, TM, GV::ROWB);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attn_bwd_tc_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);
  if (e != cudaSuccess) return e;
  attn_bwd_tc_kernel<DK, DV><<<dim3((p.Sk + TN - 1) / TN, p.B * p.Hkv), TC_THREADS, C::smem, stream>>>(qm, km, vm, gm,
                                                                                                      p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n4 = (long long)p.B * p.Hq * p.Sq * DK / 4;
  attn_bwd_dq_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
      p.dq_acc, static_cast<__nv_bfloat16*>(p.dq), n4, p.Sq, p.Sq_pad, DK, p.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fp32(const Params& p, cudaStream_t stream) {
  const long long rows = (long long)p.B * p.Hq * p.Sq;
  delta_kernel<D><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT, 0, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<D>::dkdv);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<D>::dq);
  if (e != cudaSuccess) return e;
  dkdv_kernel<D><<<dim3((p.Sk + BN - 1) / BN, p.B * p.Hkv), NT, Smem<D>::dkdv, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dq_kernel<D><<<dim3((p.Sq + BM - 1) / BM, p.B * p.Hq), NT, Smem<D>::dq, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, int dtype, cudaStream_t stream) {
  return dtype == 1 ? launch_tc<D, D>(p, stream) : launch_fp32<D>(p, stream);
}

// the launcher's answer where a mapping is not instantiated on (D, Dv):
// nothing is launched, and the wrapper calls again with v, the output and
// dO zero-padded to D (flash_attention.cu's kPadV)
constexpr int kPadV = -1;

}  // namespace

// dtype: 0 fp32, 1 bf16.  q, dq (B, Hq, Sq, D); o, dout (B, Hq, Sq, Dv);
// k, dk (B, Hkv, Sk, D); v, dv (B, Hkv, Sk, Dv); Dv = D, or (D, Dv) =
// (192, 128) (bf16; fp32 answers kPadV); lse (B, Hq, Sq) fp32; all
// contiguous.  scratch: fp32, (B, Hq, Sq) for fp32, (B, Hq, Sq_pad, 2) for
// bf16 with Sq_pad = Sq rounded up to a multiple of 64.  dq_acc: bf16
// only, fp32 (B, Hq, Sq_pad, D), zeroed by the caller (null for fp32).
// window -1: none.  Returns cudaGetLastError() after the three launches.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse, void* scratch,
    void* dq_acc, void* dq, void* dk, void* dv, int dtype, int B, int Hq, int Hkv, int Sq, int Sk, int D, int Dv,
    int causal, int window, int q_offset, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || (dtype != 0 && dtype != 1) ||
      (long long)B * Hq > 65535 || (long long)B * Hkv > 65535 || (dtype == 1 && dq_acc == nullptr))
    return (int)cudaErrorInvalidValue;
  float* f = static_cast<float*>(scratch);
  Params p{q, k, v, o, dout, static_cast<const float*>(lse), dtype == 0 ? f : nullptr, dtype == 1 ? f : nullptr,
           static_cast<float*>(dq_acc), dq, dk, dv, B, Hq, Hkv, Sq, Sk, (Sq + PAD - 1) / PAD * PAD,
           causal, window, q_offset, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 192 && Dv == 128) return dtype == 1 ? (int)launch_tc<192, 128>(p, s) : kPadV;
  if (D != Dv) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return (int)launch<16>(p, dtype, s);
    case 32: return (int)launch<32>(p, dtype, s);
    case 64: return (int)launch<64>(p, dtype, s);
    case 128: return (int)launch<128>(p, dtype, s);
    case 192: return (int)launch<192>(p, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
