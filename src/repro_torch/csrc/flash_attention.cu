// Blocked online-softmax attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:90
// (flash_attention_pallas, body _make_kernel :30).  Same function:
//   s = (q . k^T) * scale in fp32 (q, k, v read in their storage type,
//   bf16 or fp32, and converted to fp32); masked entries are -1e30 and
//   their p is set to 0 explicitly; online softmax with an fp32 running
//   max m, normalizer l and accumulator acc; P.V in fp32 (p is never
//   rounded to bf16); out = acc / max(l, 1e-30), stored in q's type.
// Query i sits at q_pos = q_offset + i (the wrapper passes Sk - Sq
// unless the caller gives another offset).  causal keeps k_pos <= q_pos,
// window (-1: none) keeps k_pos > q_pos - window; a query with no key
// left gives 0.  GQA:
// query head h reads kv head h / (Hq / Hkv) in place, never repeated.
// Operands are addressed by element strides for B, H and S (unit stride
// on D, rows 16-byte aligned), so a decode cache prefix goes in without
// a copy.  The output is contiguous (B, Hq, Sq, D).
//
// Two mappings, one launch each:
// * prefill (Sq > 1): one block per (64-query tile, b, h).  K and V
//   tiles of 64 keys are staged in shared memory as fp32 and shared by
//   every query of the tile; each of the 256 threads holds a 4 x 4 block
//   of the score tile and a 4 x D/16 block of the accumulator.  kv tiles
//   entirely above the diagonal (causal) or entirely left of the window
//   are skipped: a fully masked tile changes neither m, l nor acc.
//   Bound: operations.  At the path's row (B 4, Hq 32, S 4096, D 128,
//   causal) the work is 5.5e11 FLOP: 0.56 ms on bf16 tensor cores, 8.2
//   ms at the 67 TFLOP/s of fp32 FMA on the CUDA cores that this kernel
//   uses; its inner loops read fp32 operands from shared memory as
//   float4, so FMA, not shared-memory bandwidth, is meant to limit it.
// * decode (Sq == 1): one block per (b, kv head, group of 4 query
//   heads), so a kv head's cache is read once for the 4 query heads
//   that share it (llama3-8b: Hq/Hkv = 4, one group).  A thread scores
//   one (head, key) pair of a 64-key tile; the tile's max and sum are
//   reduced through shared memory; each thread then accumulates two of
//   the 4 x D outputs.  Bound: bytes (the cache is read once: at B 16,
//   Hkv 8, Sk 32768, D 128 in bf16 that is 2.15 GB, 0.64 ms at 3.35
//   TB/s).  With B * Hkv blocks (128 at that row) the card is filled
//   only when B * Hkv >= 132; each block walks its tiles in order
//   without overlapping the next tile's load with compute, which bounds
//   it by latency before bandwidth.
//
// Sums run in a fixed order (d, then k, ascending) with fmaf; no TF32,
// no bf16 tensor cores (they would round p to bf16 or reorder the sums:
// that is the redesign's work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // queries per prefill tile
constexpr int BK = 64;        // keys per kv tile
constexpr int NT = 256;       // threads per block
constexpr int RG = 4;         // query heads per decode block
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q; const void* k; const void* v; void* out;
  int B, Hq, Hkv, Sq, Sk;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss;
  int causal, window, q_offset;
  float scale;
};

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load16(const float* src, float* dst) {
  float4 a = *reinterpret_cast<const float4*>(src);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x; dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// rows [row0, row0 + rows) of a (S, D) operand with row stride `stride`
// into shared fp32 rows of pitch `ld`; rows at or past `n_rows` are zero
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* base, long long stride,
                                          int row0, int rows, int n_rows) {
  constexpr int N = Vec<T>::N, CPR = D / N;
  for (int idx = threadIdx.x; idx < rows * CPR; idx += NT) {
    const int r = idx / CPR, c = (idx % CPR) * N;
    float x[N];
    if (row0 + r < n_rows) {
      load16(base + (long long)(row0 + r) * stride + c, x);
    } else {
#pragma unroll
      for (int n = 0; n < N; ++n) x[n] = 0.f;
    }
    float* d = dst + r * ld + c;
#pragma unroll
    for (int n = 0; n < N; n += 4) *reinterpret_cast<float4*>(d + n) = make_float4(x[n], x[n + 1], x[n + 2], x[n + 3]);
  }
}

__device__ __forceinline__ bool keep(int qp, int kp, int sk, int causal, int window) {
  return kp < sk && (!causal || kp <= qp) && (window < 0 || kp > qp - window);
}

// the probability tile reuses the K tile's rows where it fits (D 128)
template <int D> struct Prefill {
  static constexpr bool p_in_k = BQ * (BK + 4) <= BK * (D + 4);
  static constexpr size_t smem = sizeof(float) * (2 * BQ * (D + 4) + BK * D + (p_in_k ? 0 : BQ * (BK + 4)));
};

template <typename T, int D>
__global__ void __launch_bounds__(NT) prefill_kernel(Params p) {
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
  const T* qb = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* kb = static_cast<const T*>(p.k) + b * p.ksb + g * p.ksh;
  const T* vb = static_cast<const T*>(p.v) + b * p.vsb + g * p.vsh;
  const int off = p.q_offset;

  load_rows<T, D>(Qs, LD, qb, p.qss, q0, BQ, p.Sq);

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
    load_rows<T, D>(Ks, LD, kb, p.kss, k0, BK, p.Sk);
    load_rows<T, D>(Vs, D, vb, p.vss, k0, BK, p.Sk);
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

  T* ob = static_cast<T*>(p.out) + ((long long)(b * p.Hq + h) * p.Sq) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= p.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) store(ob + (long long)(q0 + r) * D + tx + 16 * j, acc[i][j] / den);
  }
}

template <int D> struct Decode {
  static constexpr size_t smem = sizeof(float) * (RG * D + BK * (D + 4) + BK * D + RG * BK + 2 * (NT / 32) + 3 * RG);
};

template <typename T, int D>
__global__ void __launch_bounds__(NT) decode_kernel(Params p) {
  constexpr int LD = D + 4, NE = (RG * D + NT - 1) / NT;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // RG x D
  float* Ks = Qs + RG * D;        // BK x LD
  float* Vs = Ks + BK * LD;       // BK x D
  float* Ps = Vs + BK * D;        // RG x BK
  float* red_max = Ps + RG * BK;  // one per warp
  float* red_sum = red_max + NT / 32;
  float* m_s = red_sum + NT / 32;  // per head of the group
  float* l_s = m_s + RG;
  float* c_s = l_s + RG;

  const int rep = p.Hq / p.Hkv;
  const int b = blockIdx.x / p.Hkv, g = blockIdx.x % p.Hkv;
  const int h0 = g * rep + blockIdx.y * RG;                 // first query head of the group
  const int n_heads = min(RG, rep - (int)blockIdx.y * RG);  // heads of this group
  const T* kb = static_cast<const T*>(p.k) + b * p.ksb + g * p.ksh;
  const T* vb = static_cast<const T*>(p.v) + b * p.vsb + g * p.vsh;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r = tid / BK, kk = tid % BK;   // the (head, key) pair this thread scores
  const int qp = p.q_offset;               // the one query's position

  // q rows of the group's heads (row stride: the head stride)
  load_rows<T, D>(Qs, D, static_cast<const T*>(p.q) + b * p.qsb + (long long)h0 * p.qsh, p.qsh, 0, RG, n_heads);
  if (tid < RG) { m_s[tid] = NEG_INF; l_s[tid] = 0.f; }
  float acc[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) acc[e] = 0.f;

  // the kv tiles that hold an unmasked key for the query
  int t_hi = (p.Sk + BK - 1) / BK - 1;
  if (p.causal) t_hi = qp < 0 ? -1 : min(t_hi, qp / BK);
  int t_lo = 0;
  if (p.window >= 0 && qp - p.window + 1 > 0) t_lo = (qp - p.window + 1) / BK;
  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's P.V is done, m_s and l_s are set
    load_rows<T, D>(Ks, LD, kb, p.kss, k0, BK, p.Sk);
    load_rows<T, D>(Vs, D, vb, p.vss, k0, BK, p.Sk);
    __syncthreads();

    float s = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 a = *reinterpret_cast<const float4*>(Qs + r * D + d);
      const float4 c = *reinterpret_cast<const float4*>(Ks + kk * LD + d);
      s = fmaf(a.x, c.x, s); s = fmaf(a.y, c.y, s); s = fmaf(a.z, c.z, s); s = fmaf(a.w, c.w, s);
    }
    const bool ok = r < n_heads && keep(qp, k0 + kk, p.Sk, p.causal, p.window);
    s = ok ? s * p.scale : NEG_INF;
    float mx = s;
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) red_max[warp] = mx;
    __syncthreads();
    // a head's 64 keys are two warps: 2r and 2r + 1
    const float m_new = fmaxf(m_s[r], fmaxf(red_max[2 * r], red_max[2 * r + 1]));
    const float pk = ok ? expf(s - m_new) : 0.f;
    Ps[r * BK + kk] = pk;
    float sum = pk;
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) red_sum[warp] = sum;
    __syncthreads();
    if (kk == 0) {
      const float corr = expf(m_s[r] - m_new);
      l_s[r] = l_s[r] * corr + (red_sum[2 * r] + red_sum[2 * r + 1]);
      m_s[r] = m_new;
      c_s[r] = corr;
    }
    __syncthreads();

#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int idx = tid + e * NT;
      if (idx >= RG * D) break;
      const int hr = idx / D, d = idx % D;
      float pv = 0.f;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) pv = fmaf(Ps[hr * BK + j], Vs[j * D + d], pv);
      acc[e] = acc[e] * c_s[hr] + pv;
    }
  }
  __syncthreads();

#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int idx = tid + e * NT;
    if (idx >= RG * D) break;
    const int hr = idx / D, d = idx % D;
    if (hr >= n_heads) continue;
    T* o = static_cast<T*>(p.out) + ((long long)(b * p.Hq + h0 + hr)) * D + d;  // Sq == 1
    store(o, acc[e] / fmaxf(l_s[hr], 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (p.Sq == 1) {
    constexpr size_t bytes = Decode<D>::smem;
    cudaError_t e = cudaFuncSetAttribute(decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    dim3 grid(p.B * p.Hkv, (p.Hq / p.Hkv + RG - 1) / RG);
    decode_kernel<T, D><<<grid, NT, bytes, stream>>>(p);
  } else {
    constexpr size_t bytes = Prefill<D>::smem;
    cudaError_t e = cudaFuncSetAttribute(prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.Hq);
    prefill_kernel<T, D><<<grid, NT, bytes, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 fp32, 1 bf16.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype,
    int B, int Hq, int Hkv, int Sq, int Sk, int D,
    long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss,
    int causal, int window, int q_offset, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  Params p{q, k, v, out, B, Hq, Hkv, Sq, Sk, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, causal, window, q_offset, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0 ? dispatch<float>(p, D, s)
                : dtype == 1 ? dispatch<__nv_bfloat16>(p, D, s)
                             : cudaErrorInvalidValue;
  return (int)e;
}
