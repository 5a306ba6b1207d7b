// Fused RMI-MLP inference for Hopper (sm_90a): tf32 wgmma in three
// terms (3xTF32), weights streamed by TMA.  Plain C interface.
//
// Replaces the TPU kernel repro/kernels/rmi_mlp/kernel.py:48
// `rmi_mlp_pallas` (body `_mlp_kernel` :26) and the `vmap` over a stage's
// experts in repro/kernels/rmi_mlp/ops.py:61-72 `rmi_stage_forward`.
// For every expert e of one RMI stage and every batch row i:
//
//   h1 = relu(W1[e] x[i] + b1[e])        x: (B, d_in), W1[e]: (H1, d_in)
//   h2 = relu(W2[e] h1 + b2[e])          ... four ReLU layers, then
//   out[e, i] = w5[e] . h4 + b5[e]       the scalar head
//
// with every weight in nn.Linear's (out, in) layout, which is K-major.
//
// Arithmetic.  Each product a * b is three tf32 products: a = a_hi + a_lo
// and b = b_hi + b_lo, each part rounded to tf32 (to nearest, ties away),
// and a * b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi on the tensor cores.  What
// is left out (a_lo b_lo and the rounding of the lo parts) is about 2^-21
// |a b| a product.  The tensor cores' fp32 accumulator does not round to
// nearest, though: summed in one chain over K = 769 (291 wgmma into one
// accumulator), the sums drifted to the gate's edge at the gpu test's
// shape (769 x 1000, 4 experts).  So the tensor cores sum 8 k-steps at a
// time (kFlush: 24 products of each output, the chunk's first wgmma
// overwriting the accumulator) and each chunk is added to an fp32 total
// in registers by IEEE adds.  The predictions are thresholded (pred >= alpha tau) and
// routed (floor(pred / target_max E)), so the card holds the kernel to
// the reference's 2e-5 (1 + |plain|) and counts the routes and core tests
// that move; a single tf32 pass (2^-11 a product) misses that gate
// (tests/test_torch_rmi_mlp.py emulates both).  The head (h4 -> 1) stays
// a fp32 warp reduction on the CUDA cores.
//
// Bound on an H100 at the MS-150k predict shape (B = 30,437 rows,
// d_in = 769, widths 512, 512, 256, 128, stages of 1, 2 and 4 experts):
// operations.  One predict is 3.49e11 FLOP against ~0.12 GB of inputs:
// 5.21 ms as fp32 FMA on the CUDA cores (67 TFLOP/s); as three tf32
// products 1.05e12 tensor-core FLOP, 2.12 ms at 495 TFLOP/s; the bytes
// take 0.04 ms.
//
// Design:
//   * a block owns 64 batch rows (one wgmma M) of one expert; the grid
//     is (row tiles x E) with the expert fastest, so neighbouring blocks
//     read the same x rows; one launch runs a whole stage;
//   * a layer runs in passes of 256 outputs (two for a 512-wide layer);
//     two warpgroups split a pass in halves (128 outputs each: one
//     m64n128k8 wgmma, or n64 for a 128-wide layer).  A thread holds the
//     tensor cores' accumulator, its fp32 total and, in a second pass,
//     the first pass's total: 192 registers.  ptxas sizes a wgmma
//     kernel's registers by whole warpgroups (65,536 / 384 = 168 a thread
//     with a producer warp or warpgroup, whatever setmaxnreg says later:
//     it spilled), so there is none: the 256 threads get up to 255
//     registers, and thread 0 issues the TMA loads;
//   * every thread runs the ring's bookkeeping (the TMA instructions are
//     predicated on thread 0), because a wgmma is warpgroup-wide: a
//     branch taken by one thread made ptxas serialize the wgmma, and one
//     taken by one warp made the others wait for it.  The next load's
//     layer, pass and k-step are counted up, never divided out, and the
//     loads are issued after a k-step's wgmma, 4 k-steps ahead, while
//     the tensor cores work;
//   * the activations stay in shared memory, 64 x 512 fp32 with a row
//     stride of 516 floats (the A-fragment loads hit 32 distinct banks).
//     A layer's outputs wait in registers until both warpgroups have
//     read all of its input, then overwrite it with bias + ReLU: one
//     buffer serves every layer, and no activation goes to device memory;
//   * A comes from registers: a thread loads its fragment of a k-step of
//     8 (rows g and g + 8 of its warp's 16, columns t and t + 4) from the
//     buffer and splits it into hi and lo there.  It reads the columns it
//     needs from a row-major buffer, so no K permutation is needed;
//   * B streams through a 6-stage ring.  A stage is one k-step of a pass:
//     the pass's 256 weight rows x 8 k, hi and lo, two TMA boxes with a
//     32-byte swizzle.  The wrapper packs the weights split (hi, lo) and
//     K-major in blocks of 8 k, (2, E, K/8, N, 8), so a box is 8 KB of
//     contiguous memory; the map's zero fill covers k >= d_in.  A k-step
//     is three wgmma: A_hi B_hi, A_hi B_lo, A_lo B_hi.  (Splitting B in
//     shared memory after the load, to read one fp32 copy, is slower:
//     its split, proxy fence and barrier sit in every k-step);
//   * layer 1's A is x: each stage also brings a 64 x 8 box of x by TMA
//     (a 2-d map; rows >= B and k >= d_in zero-filled) into the
//     activation buffer, which layer 1 does not use before its epilogue.
//     TMA needs a row stride that is a multiple of 16 bytes, so the
//     wrapper passes x with its rows padded to a multiple of 4 floats
//     (featurize's 769 columns -> a stride of 772); the pad is never read;
//   * a layer's k-steps run in pairs (rounded up to even: a step past K
//     loads zeros) and every pipeline step has one shape, wait<1> a
//     k-step and wait<0> a chunk, with no branch around a wgmma;
//   * weight traffic: a tile reads its expert's 6.56 MB (hi and lo) from
//     L2 once, 476 tiles x 46 MB = 22 GB a predict; halving it hardly
//     moves the time;
//   * ragged rows come in as TMA zeros and are never stored.
//
// What holds it back (PERF.md): a k-step's three wgmma are 192 tensor
// cycles a warpgroup (384 for the block), against ~1,200 cycles a k-step
// on the card (chip_smoke.py's stage times).  Its time hardly moves with
// the bytes, the count of wgmma, the ring depth or the waits; clock64
// counts put a third of a k-step in issuing the wgmma and most of the
// rest in the ring's bookkeeping and barrier waits, work a k-step of 8
// cannot amortize.  Larger k-steps need registers or shared memory this
// layout does not have.
//
// Shared memory: 132,096 B of activations + 6 stages x (8 KB hi + 8 KB
// lo) = 230,400 B: one block an SM, 256 threads.
//
// Hidden widths: four layers, each 128, 256 or 512 (the paper's are 512,
// 512, 256, 128); the wrapper raises on any other shape.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;                   // batch rows per block: one wgmma M
constexpr int kThreads = 256;               // two warpgroups, half of a pass's outputs each
constexpr int kStages = 6;                  // weight ring depth
constexpr int kK = 8;                       // k of one tf32 wgmma: one ring stage
constexpr int kPassN = 256;                 // a layer's outputs per pass (both warpgroups)
constexpr int kFlush = 8;                   // k-steps the tensor cores sum before an fp32 add
constexpr int kMaxN = 512;                  // widest layer
constexpr int kLd = kMaxN + 4;              // activation row stride, floats
constexpr int kWTile = kPassN * kK * 4;     // bytes of a stage's hi (or lo) tile
constexpr int kXTile = kRows * kK * 4;      // bytes of a stage's x box
constexpr int kActBytes = kRows * kLd * 4;  // 132,096: a multiple of 1024
constexpr size_t kSmem = 1024 + kActBytes + 2 * kStages * kWTile;

struct Maps {
  CUtensorMap x;     // (d_in, B) fp32, box (8, 64), no swizzle
  CUtensorMap w[4];  // layer l: (8, N_l, K_l / 8, E, 2: hi, lo) fp32, box (8, min(N_l, kPassN), 1, 1, 1), 32-byte swizzle
};

struct Params {
  int B, E, n[4], k[4];   // batch rows, experts, each layer's outputs and inputs
  const float* bias[4];   // (E, N_l)
  const float* w5;        // (E, h4): the head's weights
  const float* b5;        // (E,)
  float* out;             // (E, B)
};

// ---------------------------------------------------------------------------
// mbarriers, TMA and wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte aligned address at or after p
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// The TMA helpers below act only in the thread where `on` is set.  They
// are predicated instructions, not branches: every thread runs the ring's
// control flow, so no warp diverges between the wgmma of a k-step (a
// divergent branch there made ptxas serialize them).

// one arrival that also announces `bytes` of TMA traffic
__device__ __forceinline__ void mbar_expect_tx_if(bool on, uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n"
      ::"r"(smem_u32(bar)), "r"(bytes), "r"((int)on)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d_if(bool on, void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                               int c1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"
      "@p cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n}\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"((int)on)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d_if(bool on, void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                               int c1, int c2, int c3, int c4) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %8, 0;\n"
      "@p cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n}\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4),
      "r"((int)on)
      : "memory");
}

// K-major shared-memory matrix descriptor with a 32-byte swizzle (layout
// 3): rows of 32 bytes, 8-row groups 256 bytes apart
__device__ __forceinline__ uint64_t desc_sw32(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(256 >> 4) << 32) |
         ((uint64_t)3 << 62);
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

// x = hi + lo, both tf32 (round to nearest, ties away), as fp32 bit patterns
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
  h &= 0xFFFFE000u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(l) : "f"(x - __uint_as_float(h)));
  hi = h;
  lo = l & 0xFFFFE000u;
}

// d (64 x 128) (+)= A (64 x 8 tf32, registers) . B (8 x 128 tf32, smem, K-major);
// accumulate 0 overwrites d
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (64 x 64) (+)= A (64 x 8 tf32, registers) . B (8 x 64 tf32, smem, K-major);
// accumulate 0 overwrites d
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}


// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// what of layer l's shape the ring needs, picked by compares (a runtime
// index into the parameters would go through local or generic memory)
__device__ __forceinline__ int pick(int l, int a0, int a1, int a2, int a3) {
  return l == 0 ? a0 : l == 1 ? a1 : l == 2 ? a2 : a3;
}

// a layer's k-steps of one pass, rounded up to even (the pipeline runs
// them in pairs; a step past K loads TMA's zeros and adds nothing)
__device__ __forceinline__ int k_steps(int k) { return (k + 2 * kK - 1) / (2 * kK) * 2; }
__device__ __forceinline__ int pass_n(int n) { return n < kPassN ? n : kPassN; }

// What every thread carries through the layers.  Every thread runs the
// ring's bookkeeping (thread 0 alone issues the loads), so it is kept to
// a few integer operations a k-step: the next load's place is counted
// up, never divided out.
struct Ctx {
  const Maps* maps;
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int e, row0;
  int n[4], nk[4];  // each layer's outputs and k-steps (of one pass)
  int it;           // the k-step this thread consumes next, counted over all layers and passes
  int next;         // the next k-step to load ...
  int steps;        // ... of this many
  int nl, np, nkb;  // ... and its layer, pass and k-step in the pass
};

// load k-step c.next (a pass's 256 weight rows x 8 k, hi and lo, and
// layer 1's x box) into stage next % kStages; thread 0 issues it
__device__ __forceinline__ void issue(Ctx& c) {
  const bool on = threadIdx.x == 0;
  const int s = c.next % kStages, l = c.nl;
  const int n = pick(l, c.n[0], c.n[1], c.n[2], c.n[3]), box = pass_n(n);
  uint8_t* hi = c.base + kActBytes + 2 * s * kWTile;
  mbar_expect_tx_if(on, &c.full[s], 2 * box * kK * 4 + (l == 0 ? kXTile : 0));
  tma_load_5d_if(on, hi, &c.maps->w[l], &c.full[s], 0, c.np * box, c.nkb, c.e, 0);
  tma_load_5d_if(on, hi + kWTile, &c.maps->w[l], &c.full[s], 0, c.np * box, c.nkb, c.e, 1);
  if (l == 0) tma_load_2d_if(on, c.base + s * kXTile, &c.maps->x, &c.full[s], c.nkb * kK, c.row0);
  ++c.next;
  if (++c.nkb == pick(l, c.nk[0], c.nk[1], c.nk[2], c.nk[3])) {
    c.nkb = 0;
    if (++c.np * box == n) {
      c.np = 0;
      ++c.nl;
    }
  }
}

// every thread, once it has issued k-step c.it's products: load up to
// k-step it + 4 once every thread has released the stage it reuses
// (k-step it - 2's); this runs while the tensor cores do
__device__ __forceinline__ void refill(Ctx& c) {
  while (c.next < c.steps && c.next <= c.it + kStages - 2) {
    if (c.next >= kStages) mbar_wait(&c.empty[c.next % kStages], (c.next / kStages - 1) & 1);
    issue(c);
  }
}

// One dense layer: relu(act W^T + b) over the block's 64 rows in PASSES
// passes of kPassN outputs, NW of them this warpgroup's; A is the x box of
// each stage (layer 1) or the activation buffer, which the result then
// overwrites.  The tensor cores sum a chunk of kFlush k-steps into `acc`
// (its first product overwrites it), which is then added to the fp32
// `total` by IEEE adds: the accumulator's own rounding acts on short sums
// only.  Pass 0's total waits in `held`.  The pipeline has one shape:
// every k-step waits for the previous one's products (wait<1>), every
// chunk ends with a wait<0>; nothing about the wgmma is conditional.
template <int NW, int PASSES>
__device__ __forceinline__ void dense_layer(Ctx& c, const Params& p, int l) {
  uint8_t* base = c.base;
  float* act = reinterpret_cast<float*>(base);
  uint8_t* ring = base + kActBytes;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r = 16 * (tid / 32 % 4) + g;  // this thread's rows r and r + 8
  const int nk = c.nk[l];

  float acc[NW / 2], total[NW / 2], held[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
  uint32_t ah[2][4], al[2][4];

  // k-step kb: A fragment split into (hi, lo), which stay untouched until
  // the wgmma that reads them is done (the two k-steps of a pair use two
  // sets); `chained` 0 starts a chunk
  auto step = [&](int kb, int chained, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    const int s = c.it % kStages;
    mbar_wait(&c.full[s], (c.it / kStages) & 1);
    const uint8_t* whi = ring + 2 * s * kWTile + wg * NW * kK * 4;  // this warpgroup's half
    const uint8_t* wlo = whi + kWTile;
    float a[4];
    if (l == 0) {
      const float* xs = reinterpret_cast<const float*>(base + s * kXTile);  // 64 x 8, row-major
      a[0] = xs[r * kK + t];
      a[1] = xs[(r + 8) * kK + t];
      a[2] = xs[r * kK + t + 4];
      a[3] = xs[(r + 8) * kK + t + 4];
    } else {
      const float* ar = act + r * kLd + kb * kK + t;
      a[0] = ar[0];
      a[1] = ar[8 * kLd];
      a[2] = ar[4];
      a[3] = ar[8 * kLd + 4];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], hi[i], lo[i]);
    pin(hi), pin(lo);       // (acc belongs to the products in flight until the chunk's wait<0>)
    wgmma_fence();
    const uint64_t dh = desc_sw32(whi), dl = desc_sw32(wlo);
    wgmma_tf32(acc, hi, dh, chained);
    wgmma_tf32(acc, hi, dl, 1);
    wgmma_tf32(acc, lo, dh, 1);
    wgmma_commit();
    refill(c);        // while the products run
    wgmma_wait<1>();  // the previous k-step's products are done
    if (chained) mbar_arrive(&c.empty[(c.it + kStages - 1) % kStages]);
    ++c.it;
  };

#pragma unroll 1
  for (int pass = 0; pass < PASSES; ++pass) {
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) total[i] = 0.f;
#pragma unroll 1
    for (int k0 = 0; k0 < nk; k0 += kFlush) {
      const int end = min(k0 + kFlush, nk);
#pragma unroll 1
      for (int kb = k0; kb < end; kb += 2) {
        step(kb, kb != k0, ah[0], al[0]);
        step(kb + 1, 1, ah[1], al[1]);
      }
      wgmma_wait<0>();  // the chunk is summed: add it in fp32
      pin(acc);
      mbar_arrive(&c.empty[(c.it + kStages - 1) % kStages]);
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) total[i] += acc[i];
    }
    if (pass + 1 < PASSES) {
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) held[i] = total[i];
    }
  }
  pin(ah[0]), pin(al[0]), pin(ah[1]), pin(al[1]);

  __syncthreads();  // both warpgroups have read the whole input
  const float* bias = p.bias[l] + (size_t)c.e * p.n[l];
  auto store = [&](const float (&v)[NW / 2], int col) {
    const float* b = bias + col;
    float* top = act + r * kLd + col;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int cc = 8 * j + 2 * t;
      const float b0 = __ldg(b + cc), b1 = __ldg(b + cc + 1);
      *reinterpret_cast<float2*>(top + cc) = make_float2(fmaxf(v[4 * j] + b0, 0.f), fmaxf(v[4 * j + 1] + b1, 0.f));
      *reinterpret_cast<float2*>(top + 8 * kLd + cc) =
          make_float2(fmaxf(v[4 * j + 2] + b0, 0.f), fmaxf(v[4 * j + 3] + b1, 0.f));
    }
  };
  if (PASSES > 1) store(held, wg * NW);
  store(total, (PASSES - 1) * kPassN + wg * NW);
  __syncthreads();
}

__device__ __forceinline__ void layer(Ctx& c, const Params& p, int l) {
  if (p.n[l] == 512) dense_layer<128, 2>(c, p, l);
  else if (p.n[l] == 256) dense_layer<128, 1>(c, p, l);
  else dense_layer<64, 1>(c, p, l);
}

__global__ void __launch_bounds__(kThreads, 1)
    rmi_mlp_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  Ctx c{&maps, align1024(smem_raw), full, empty, (int)(blockIdx.x % p.E), (int)(blockIdx.x / p.E) * kRows,
        {p.n[0], p.n[1], p.n[2], p.n[3]},
        {k_steps(p.k[0]), k_steps(p.k[1]), k_steps(p.k[2]), k_steps(p.k[3])}, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int l = 0; l < 4; ++l) c.steps += c.nk[l] * (p.n[l] / pass_n(p.n[l]));
  const int e = c.e, row0 = c.row0;
  uint8_t* base = c.base;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();
  while (c.next < kStages - 1 && c.next < c.steps) issue(c);  // the ring's first stages

#pragma unroll
  for (int l = 0; l < 4; ++l) layer(c, p, l);

  // the scalar head, fp32: warp w reduces rows 8 w .. 8 w + 7
  const float* act = reinterpret_cast<const float*>(base);
  const int h4 = p.n[3], warp = tid / 32, lane = tid % 32;
  const float* wh = p.w5 + (size_t)e * h4;
  const float bh = __ldg(p.b5 + e);
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * warp + i;
    float s = 0.f;
    for (int col = lane * 4; col < h4; col += 128) {
      const float4 hv = *reinterpret_cast<const float4*>(act + r * kLd + col);
      const float4 wv = __ldg(reinterpret_cast<const float4*>(wh + col));
      s = fmaf(hv.x, wv.x, s);
      s = fmaf(hv.y, wv.y, s);
      s = fmaf(hv.z, wv.z, s);
      s = fmaf(hv.w, wv.w, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0 && row0 + r < p.B) p.out[(size_t)e * p.B + row0 + r] = s + bh;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the CUDA driver API's cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
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

// an fp32 map of `rank` dims (innermost first) with byte strides for dims
// 1.. and boxes of `box`; out-of-bounds elements load as zeros
cudaError_t make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims, const cuuint64_t* strides,
                     const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

bool width_ok(int n) { return n == 128 || n == 256 || n == 512; }
bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// x: (B, d_in) fp32 rows `ldx` floats apart (ldx a multiple of 4, x
// 16-byte aligned); hidden layer l's weights (2, E, ceil(K_l / 8), N_l, 8)
// fp32, the tf32 parts [hi, lo] K-major in blocks of 8 k (K_1 = d_in,
// K_l = N_{l-1}), its biases (E, N_l); the head's w5 (E, h4) and b5 (E,);
// every base 16-byte aligned; out (E, B).  Returns
// cudaErrorInvalidValue for widths outside {128, 256, 512} or misaligned
// operands, else cudaGetLastError() after the launch.
extern "C" int rmi_mlp_launch(
    const float* x, int B, int d_in, int ldx,
    const float* w1, const float* b1, const float* w2, const float* b2,
    const float* w3, const float* b3, const float* w4, const float* b4,
    const float* w5, const float* b5, int h1, int h2, int h3, int h4, int E,
    float* out, void* stream) {
  if (B <= 0 || E <= 0) return 0;
  if (!width_ok(h1) || !width_ok(h2) || !width_ok(h3) || !width_ok(h4) || d_in <= 0 || ldx < d_in || ldx % 4 ||
      !aligned16(x) || !aligned16(w1) || !aligned16(w2) || !aligned16(w3) || !aligned16(w4) || !aligned16(w5))
    return (int)cudaErrorInvalidValue;
  Maps maps;
  const cuuint32_t xbox[2] = {(cuuint32_t)kK, (cuuint32_t)kRows};
  const cuuint64_t xdims[2] = {(cuuint64_t)d_in, (cuuint64_t)B}, xstride[1] = {(cuuint64_t)ldx * 4};
  cudaError_t err = make_map(&maps.x, x, 2, xdims, xstride, xbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  const float* ws[4] = {w1, w2, w3, w4};
  const int n[4] = {h1, h2, h3, h4}, k[4] = {d_in, h1, h2, h3};
  for (int l = 0; l < 4 && err == cudaSuccess; ++l) {
    const cuuint64_t kb = (cuuint64_t)((k[l] + kK - 1) / kK), nb = (cuuint64_t)n[l] * kK * 4;
    const cuuint64_t dims[5] = {(cuuint64_t)kK, (cuuint64_t)n[l], kb, (cuuint64_t)E, 2};
    const cuuint64_t strides[4] = {kK * 4, nb, nb * kb, nb * kb * E};
    const cuuint32_t box[5] = {(cuuint32_t)kK, (cuuint32_t)(n[l] < kPassN ? n[l] : kPassN), 1, 1, 1};
    err = make_map(&maps.w[l], ws[l], 5, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_32B);
  }
  if (err != cudaSuccess) return (int)err;
  static bool configured = false;
  if (!configured) {
    err = cudaFuncSetAttribute(rmi_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const Params p{B, E, {h1, h2, h3, h4}, {d_in, h1, h2, h3}, {b1, b2, b3, b4}, w5, b5, out};
  const long long blocks = (long long)E * ((B + kRows - 1) / kRows);
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  rmi_mlp_kernel<<<(unsigned)blocks, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(maps, p);
  return (int)cudaGetLastError();
}
