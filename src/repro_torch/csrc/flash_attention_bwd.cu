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
// gradients 0.
//
// Three launches, one stream, one wrapper call:
// * delta_kernel: D_i = sum_d dO[i, d] O[i, d] in fp32, a warp a row;
// * dkdv_kernel: a block per (64-key tile, b, kv head), 256 threads.  The
//   tile's K and V stay in shared memory; the block loops over the
//   group's query heads (GQA: Hq / Hkv of them) and the query tiles the
//   mask leaves, recomputes P and dS for each and accumulates dV and dK
//   for its keys in registers, so the group sum is taken in place and
//   dK and dV are written once, without atomics;
// * dq_kernel: a block per (64-query tile, b, query head), the heaviest
//   causal tiles first; Q, dO, lse and D stay in shared memory while the
//   key tiles the mask leaves stream through, and dQ accumulates in
//   registers.
// Both recompute S and dP (7 products where the fused FA-2 has 5, the
// price of writing dQ without atomics).  Every product runs in fp32 on
// the CUDA cores (FMA), operands staged in shared memory as fp32 (bf16
// inputs widened on load); each thread holds a 4 x 4 block of a tile's
// scores and a 4 x D/16 block of its accumulators.  Outputs are in the
// inputs' type.  Head widths D: 16, 32, 128 with v as wide as q and k
// (MLA's D 192 and (192, 128) pair wait for B11b).  Operands are
// contiguous (B, H, S, D), rows 16-byte aligned; the wrapper copies
// others.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // queries per tile
constexpr int BN = 64;        // keys per tile
constexpr int NT = 256;       // threads per block: 16 x 16
constexpr int LP = BN + 4;    // pitch of a (query, key) tile in shared memory

struct Params {
  const void* q; const void* k; const void* v; const void* o; const void* dout;
  const float* lse;           // (B, Hq, Sq): the forward's log-sum-exp of the scaled scores
  float* delta;               // (B, Hq, Sq) scratch: rowsum(dO o O)
  void* dq; void* dk; void* dv;
  int B, Hq, Hkv, Sq, Sk;
  int causal, window, q_offset;
  float scale;
};

// the forward's mask (flash_attention.cu)
__device__ __forceinline__ bool keep(int qp, int kp, int sk, int causal, int window) {
  return kp < sk && (!causal || kp <= qp) && (window < 0 || kp > qp - window);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 16 bytes of a row as fp32
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&x)[4]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&x)[8]) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

// rows [row0, row0 + 64) of a contiguous (S, D) operand into shared rows
// of pitch D + 4 as fp32; rows at or past n_rows are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base, int row0, int n_rows) {
  constexpr int V = Vec<T>::N, CPR = D / V, LD = D + 4;
  for (int idx = threadIdx.x; idx < BM * CPR; idx += NT) {
    const int r = idx / CPR, c = (idx % CPR) * V;
    float x[V];
    if (row0 + r < n_rows) {
      Vec<T>::load(base + (long long)(row0 + r) * D + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; e += 4)
      *reinterpret_cast<float4*>(dst + r * LD + c + e) = make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
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
// pitch LP; masked pairs give exactly 0
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
      dSs[r * LP + c] = pr * (dp[i][j] - del_s[r]);
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
template <typename T, int D>
__global__ void __launch_bounds__(NT) delta_kernel(Params p) {
  const long long rows = (long long)p.B * p.Hq * p.Sq;
  const long long row = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o = static_cast<const T*>(p.o) + row * D;
  const T* g = static_cast<const T*>(p.dout) + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_float(o[d]), to_float(g[d]), acc);
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) p.delta[row] = acc;
}

template <int D> struct Smem {
  static constexpr int LD = D + 4;
  // dkdv: K, V, Q, dO tiles, P and dS tiles, lse and D of the query rows
  static constexpr size_t dkdv = sizeof(float) * (4 * 64 * LD + 2 * BM * LP + 2 * BM);
  // dq: Q, dO, K, V tiles, the dS tile, lse and D
  static constexpr size_t dq = sizeof(float) * (4 * 64 * LD + BM * LP + 2 * BM);
};

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1) dkdv_kernel(Params p) {
  constexpr int LD = D + 4, DJ = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BN * LD;
  float* Qs = Vs + BN * LD;
  float* dOs = Qs + BM * LD;
  float* Ps = dOs + BM * LD;
  float* dSs = Ps + BM * LP;
  float* lse_s = dSs + BM * LP;
  float* del_s = lse_s + BM;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * BN;
  const int bg = blockIdx.y, b = bg / p.Hkv, g = bg % p.Hkv;
  const int rep = p.Hq / p.Hkv;
  const long long kv_base = (long long)bg * p.Sk * D;
  load_tile<T, D>(Ks, static_cast<const T*>(p.k) + kv_base, k0, p.Sk);
  load_tile<T, D>(Vs, static_cast<const T*>(p.v) + kv_base, k0, p.Sk);

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
    const T* qb = static_cast<const T*>(p.q) + bh * p.Sq * D;
    const T* gb = static_cast<const T*>(p.dout) + bh * p.Sq * D;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * BM;
      __syncthreads();  // the previous tile's accumulation is done with Qs, dOs, Ps, dSs
      load_tile<T, D>(Qs, qb, q0, p.Sq);
      load_tile<T, D>(dOs, gb, q0, p.Sq);
      load_rows_stats(lse_s, del_s, p.lse + bh * p.Sq, p.delta + bh * p.Sq, q0, p.Sq);
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_dots<D>(s, Qs, Ks, tx, ty);
      tile_dots<D>(dp, dOs, Vs, tx, ty);
      probs_and_ds(s, dp, Ps, dSs, lse_s, del_s, q0, k0, tx, ty, p);
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q for this thread's keys ty + 16 i, columns tx + 16 j
#pragma unroll 4
      for (int r = 0; r < BM; ++r) {
        float pk[4], sk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pk[i] = Ps[r * LP + ty + 16 * i];
          sk[i] = dSs[r * LP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float go = dOs[r * LD + tx + 16 * j], qv = Qs[r * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][j] = fmaf(pk[i], go, dv[i][j]);
            dk[i][j] = fmaf(sk[i], qv, dk[i][j]);
          }
        }
      }
    }
  }

  T* dkb = static_cast<T*>(p.dk) + kv_base;
  T* dvb = static_cast<T*>(p.dv) + kv_base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= p.Sk) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      store(dkb + (long long)key * D + tx + 16 * j, dk[i][j] * p.scale);
      store(dvb + (long long)key * D + tx + 16 * j, dv[i][j]);
    }
  }
}

template <typename T, int D>
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
  load_tile<T, D>(Qs, static_cast<const T*>(p.q) + bh * p.Sq * D, q0, p.Sq);
  load_tile<T, D>(dOs, static_cast<const T*>(p.dout) + bh * p.Sq * D, q0, p.Sq);
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

  const T* kb = static_cast<const T*>(p.k) + kv_base;
  const T* vb = static_cast<const T*>(p.v) + kv_base;
  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * BN;
    __syncthreads();  // the previous tile's dS . K is done with Ks, Vs, dSs
    load_tile<T, D>(Ks, kb, k0, p.Sk);
    load_tile<T, D>(Vs, vb, k0, p.Sk);
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

  T* dqb = static_cast<T*>(p.dq) + bh * p.Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) store(dqb + (long long)qi * D + tx + 16 * j, acc[i][j] * p.scale);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const long long rows = (long long)p.B * p.Hq * p.Sq;
  delta_kernel<T, D><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT, 0, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<D>::dkdv);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<D>::dq);
  if (e != cudaSuccess) return e;
  dkdv_kernel<T, D><<<dim3((p.Sk + BN - 1) / BN, p.B * p.Hkv), NT, Smem<D>::dkdv, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dq_kernel<T, D><<<dim3((p.Sq + BM - 1) / BM, p.B * p.Hq), NT, Smem<D>::dq, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, int dtype, cudaStream_t stream) {
  return dtype == 1 ? launch<__nv_bfloat16, D>(p, stream) : launch<float, D>(p, stream);
}

}  // namespace

// dtype: 0 fp32, 1 bf16.  q, o, dout, dq (B, Hq, Sq, D); k, v, dk, dv
// (B, Hkv, Sk, D); lse and delta (B, Hq, Sq) fp32, delta scratch; all
// contiguous.  window -1: none.  Returns cudaGetLastError() after the
// three launches.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse, void* delta,
    void* dq, void* dk, void* dv, int dtype, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    int causal, int window, int q_offset, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || (dtype != 0 && dtype != 1) ||
      (long long)B * Hq > 65535 || (long long)B * Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta), dq, dk, dv,
           B, Hq, Hkv, Sq, Sk, causal, window, q_offset, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)launch<16>(p, dtype, s);
    case 32: return (int)launch<32>(p, dtype, s);
    case 128: return (int)launch<128>(p, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
