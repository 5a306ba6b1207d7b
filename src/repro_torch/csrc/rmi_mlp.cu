// Fused RMI-MLP inference, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/rmi_mlp/kernel.py:48
// `rmi_mlp_pallas` (body `_mlp_kernel` :26) and the `vmap` over a stage's
// experts in repro/kernels/rmi_mlp/ops.py:61-72 `rmi_stage_forward`.
// For every expert e of one RMI stage and every batch row i:
//
//   h1 = relu(x[i] W1[e] + b1[e])        x: (B, d_in), W1[e]: (d_in, H1)
//   h2 = relu(h1 W2[e] + b2[e])          ... four ReLU layers, then
//   out[e, i] = h4 W5[e][:, 0] + b5[e][0]    the scalar head
//
// with every weight in the reference's (in, out) layout, fp32 throughout.
//
// What bounds it on an H100: operations.  At the MS-150k predict shape
// (B = 30,437 rows, d_in = 769, widths 512, 512, 256, 128, stages of
// 1, 2 and 4 experts) one predict does 2 * 30,437 * 819,840 * 7 =
// 3.49e11 FLOP against ~0.12 GB of inputs (x once per stage, 23 MB of
// weights): 5.2 ms at the CUDA cores' 67 TFLOP/s fp32, 0.04 ms of HBM
// traffic.  The predictions are thresholded (pred >= alpha * tau) and
// routed (floor(pred / target_max * E)), so the product stays IEEE fp32
// FMA on the CUDA cores: no TF32, no bf16 (a wgmma / 3xTF32 design is
// later work).
//
// Design:
//   * one block owns 32 batch rows of one expert (grid = row tiles x E,
//     so one launch runs a whole stage; the expert index is the grid's
//     y, the written-out counterpart of the reference's vmap) and runs
//     the whole five-layer forward; no activation goes to device memory;
//   * the TPU kernel keeps the whole net resident in VMEM.  One expert
//     at d_in = 769 is 3.28 MB of fp32 weights, against 227 KB of shared
//     memory a block, so the weights stream through a two-stage cp.async
//     ring in k-slices of 8 rows (8 x 512 floats, 16-byte copies), read
//     from L2: the 50 MB L2 holds all 7 experts (23 MB);
//   * the activations stay in shared memory: one 32 x 512 fp32 buffer
//     (64 KB).  A layer's outputs accumulate in registers while it reads
//     the buffer, and overwrite it (bias + ReLU) after the last k-slice,
//     so one buffer serves every layer.  Buffer + ring = 98 KB: two blocks
//     an SM;
//   * the tile height sets the L2 traffic: a 32-row tile does 2 * 32
//     FLOP per 4 weight bytes, so one predict re-reads its weights once
//     per tile, 952 tiles x 23 MB = ~22 GB from L2.  Taller tiles would
//     cut that, at the cost of the shared memory above;
//   * register blocking as in range_count.cu: a layer of width N keeps
//     N / 128 warps across the columns; lane l owns 4 consecutive columns
//     (one float4 of a weight row, conflict-free) and 32 / (8 / (N / 128))
//     rows (a broadcast float4 of an activation row), 16 x 4, 8 x 4 or
//     4 x 4 accumulators;
//   * every output sums its products in the order k = 0..K-1 with fmaf,
//     so a result does not depend on the launch shape;
//   * the ragged batch and the k tail (d_in = 769 is not padded to 896 as
//     the reference's wrapper pads it) are loaded as zeros (copies of 0
//     bytes) and rows >= B are never stored;
//   * the 128 -> 1 head is a warp's shuffle reduction per row.
//
// Two blocks an SM cap a thread at 128 registers; the 16 x 4 tile of the
// 512-wide layers then spills about 100 bytes a thread (chip_smoke.py
// prints ptxas's count).  Its times beside the bound and the library's
// fp32 chain: PERF.md.
//
// Hidden widths: four layers, each 128, 256 or 512 (the paper's are 512,
// 512, 256, 128); the wrapper raises on any other shape.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 32;                    // batch rows per block
constexpr int kKS = 8;                     // weight rows (k) per slice
constexpr int kMaxN = 512;                 // widest layer
constexpr int kActStride = kMaxN;          // activation row stride, floats
constexpr int kWSlice = kKS * kMaxN;       // floats of one weight slice
constexpr int kXSlice = kBM * kKS;         // floats of one x slice
constexpr int kStage = kWSlice + kXSlice;
constexpr size_t kSmemBytes = (size_t)(kBM * kActStride + 2 * kStage) * sizeof(float);

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

// Weight rows [k0, k0 + kKS) of a (K, N) row-major matrix into a
// (kKS, N) shared slice; rows >= K are zero-filled.
template <int N>
__device__ __forceinline__ void load_w(float* ws, const float* __restrict__ w,
                                       int k0, int K, int tid) {
  constexpr int kVecs = kKS * N / 4;
#pragma unroll
  for (int i = 0; i < kVecs / kThreads; ++i) {
    const int t = tid + i * kThreads;
    const int r = t / (N / 4), c = (t % (N / 4)) * 4;
    const bool ok = k0 + r < K;
    cp_async16(ws + r * N + c, ok ? w + (size_t)(k0 + r) * N + c : w, ok);
  }
}

// x[row0 .. row0 + kBM) x k [k0, k0 + kKS) into a (kBM, kKS) shared
// slice; ragged rows and the k tail are zeros.
__device__ __forceinline__ void load_x(float* xs, const float* __restrict__ x,
                                       int row0, int B, int k0, int K, int tid) {
#pragma unroll
  for (int i = 0; i < kXSlice / kThreads; ++i) {
    const int t = tid + i * kThreads;
    const int r = t / kKS, c = t % kKS;
    const bool ok = row0 + r < B && k0 + c < K;
    cp_async4(xs + r * kKS + c, ok ? x + (size_t)(row0 + r) * K + k0 + c : x, ok);
  }
}

// One dense layer of width N over the block's kBM rows: A is the x tile
// (FROM_X, streamed beside the weights) or the activation buffer; the
// result, relu(A W + b), replaces the activation buffer.
template <int N, bool FROM_X>
__device__ __forceinline__ void dense_layer(
    const float* __restrict__ w, const float* __restrict__ bias, int K,
    const float* __restrict__ x, int B, int row0, float* act, float* ring, int tid) {
  constexpr int kWC = N / 128;          // warps across the columns
  constexpr int kWR = kWarps / kWC;     // warps across the rows
  constexpr int kTM = kBM / kWR;        // rows per thread
  constexpr int kAStride = FROM_X ? kKS : kActStride;
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = (warp / kWC) * kTM;
  const int c0 = (warp % kWC) * 128 + lane * 4;

  float acc[kTM][4];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int n_k = (K + kKS - 1) / kKS;
  load_w<N>(ring, w, 0, K, tid);
  if (FROM_X) load_x(ring + kWSlice, x, row0, B, 0, K, tid);
  cp_async_commit();

  for (int kt = 0; kt < n_k; ++kt) {
    if (kt + 1 < n_k) {
      float* next = ring + ((kt + 1) & 1) * kStage;
      load_w<N>(next, w, (kt + 1) * kKS, K, tid);
      if (FROM_X) load_x(next + kWSlice, x, row0, B, (kt + 1) * kKS, K, tid);
    }
    cp_async_commit();
    cp_async_wait_one();  // every group but the newest: slice kt is in
    __syncthreads();

    const float* ws = ring + (kt & 1) * kStage + c0;
    const float* as = FROM_X ? ring + (kt & 1) * kStage + kWSlice + r0 * kKS
                             : act + r0 * kActStride + kt * kKS;
#pragma unroll
    for (int kk = 0; kk < kKS; kk += 4) {
      float4 b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = *reinterpret_cast<const float4*>(ws + (kk + q) * N);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(as + i * kAStride + kk);
        float s0 = acc[i][0], s1 = acc[i][1], s2 = acc[i][2], s3 = acc[i][3];
        s0 = fmaf(a.x, b[0].x, s0); s1 = fmaf(a.x, b[0].y, s1);
        s2 = fmaf(a.x, b[0].z, s2); s3 = fmaf(a.x, b[0].w, s3);
        s0 = fmaf(a.y, b[1].x, s0); s1 = fmaf(a.y, b[1].y, s1);
        s2 = fmaf(a.y, b[1].z, s2); s3 = fmaf(a.y, b[1].w, s3);
        s0 = fmaf(a.z, b[2].x, s0); s1 = fmaf(a.z, b[2].y, s1);
        s2 = fmaf(a.z, b[2].z, s2); s3 = fmaf(a.z, b[2].w, s3);
        s0 = fmaf(a.w, b[3].x, s0); s1 = fmaf(a.w, b[3].y, s1);
        s2 = fmaf(a.w, b[3].z, s2); s3 = fmaf(a.w, b[3].w, s3);
        acc[i][0] = s0; acc[i][1] = s1; acc[i][2] = s2; acc[i][3] = s3;
      }
    }
    __syncthreads();  // the slice is refilled, and the buffer overwritten, next
  }

  // epilogue: bias + ReLU into the activation buffer (every read of it
  // ended at the loop's last barrier)
  const float4 bv = __ldg(reinterpret_cast<const float4*>(bias + c0));
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    float4 o;
    o.x = fmaxf(acc[i][0] + bv.x, 0.f);
    o.y = fmaxf(acc[i][1] + bv.y, 0.f);
    o.z = fmaxf(acc[i][2] + bv.z, 0.f);
    o.w = fmaxf(acc[i][3] + bv.w, 0.f);
    *reinterpret_cast<float4*>(act + (r0 + i) * kActStride + c0) = o;
  }
  __syncthreads();
}

template <bool FROM_X>
__device__ __forceinline__ void layer(int n, const float* w, const float* bias, int K,
                                      const float* x, int B, int row0, float* act,
                                      float* ring, int tid) {
  if (n == 512) dense_layer<512, FROM_X>(w, bias, K, x, B, row0, act, ring, tid);
  else if (n == 256) dense_layer<256, FROM_X>(w, bias, K, x, B, row0, act, ring, tid);
  else dense_layer<128, FROM_X>(w, bias, K, x, B, row0, act, ring, tid);
}

__global__ void __launch_bounds__(kThreads, 2) rmi_mlp_kernel(
    const float* __restrict__ x, int B, int d_in,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ w3, const float* __restrict__ b3,
    const float* __restrict__ w4, const float* __restrict__ b4,
    const float* __restrict__ w5, const float* __restrict__ b5,
    int h1, int h2, int h3, int h4, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* act = smem;
  float* ring = smem + kBM * kActStride;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kBM;
  const size_t e = blockIdx.y;

  layer<true>(h1, w1 + e * d_in * h1, b1 + e * h1, d_in, x, B, row0, act, ring, tid);
  layer<false>(h2, w2 + e * h1 * h2, b2 + e * h2, h1, x, B, row0, act, ring, tid);
  layer<false>(h3, w3 + e * h2 * h3, b3 + e * h3, h2, x, B, row0, act, ring, tid);
  layer<false>(h4, w4 + e * h3 * h4, b4 + e * h4, h3, x, B, row0, act, ring, tid);

  // the scalar head: warp w reduces rows w * 4 .. w * 4 + 3
  const float* wh = w5 + e * h4;
  const float bh = __ldg(b5 + e);
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int i = 0; i < kBM / kWarps; ++i) {
    const int r = warp * (kBM / kWarps) + i;
    float s = 0.f;
    for (int c = lane * 4; c < h4; c += 128) {
      const float4 hv = *reinterpret_cast<const float4*>(act + r * kActStride + c);
      const float4 wv = __ldg(reinterpret_cast<const float4*>(wh + c));
      s = fmaf(hv.x, wv.x, s);
      s = fmaf(hv.y, wv.y, s);
      s = fmaf(hv.z, wv.z, s);
      s = fmaf(hv.w, wv.w, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0 && row0 + r < B) out[e * B + row0 + r] = s + bh;
  }
}

bool width_ok(int n) { return n == 128 || n == 256 || n == 512; }

}  // namespace

// x (B, d_in) fp32; per expert e of E: w1 (d_in, h1), b1 (h1,), ...,
// w5 (h4,) (the head's column 0), b5 (1,), stacked contiguously over E
// with 16-byte aligned bases; out (E, B).  Returns cudaErrorInvalidValue
// for widths outside {128, 256, 512}.
extern "C" int rmi_mlp_launch(
    const float* x, int B, int d_in,
    const float* w1, const float* b1, const float* w2, const float* b2,
    const float* w3, const float* b3, const float* w4, const float* b4,
    const float* w5, const float* b5, int h1, int h2, int h3, int h4, int E,
    float* out, void* stream) {
  if (B <= 0 || E <= 0) return 0;
  if (!width_ok(h1) || !width_ok(h2) || !width_ok(h3) || !width_ok(h4) || d_in <= 0)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(rmi_mlp_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((B + kBM - 1) / kBM, E);
  rmi_mlp_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x, B, d_in, w1, b1, w2, b2, w3, b3, w4, b4, w5, b5, h1, h2, h3, h4, out);
  return (int)cudaGetLastError();
}
