// Mixed-attention backward (K2) for Hopper (sm_90a), f32, CUDA cores.
//
// Replaces the Pallas kernel `_attn_bwd_kernel`, launched by
// `_mixed_attention_bwd_pallas` in multi_modal_tracking_tpu/ops/attention.py.
// For q (BH, Nq, D), k/v (BH, Nk, D), the forward output o and its incoming
// gradient g (BH, Nq, D), with allowed(i, j) = (i >= n_mt) || (j < n_mt):
//
//     P  = softmax(mask(Q K^T * scale))        recomputed, never stored
//     dP = g V^T
//     dS = P o (dP - Delta),  Delta_i = rowsum(P o dP)_i = g_i . o_i
//     dS = 0 where masked, then * scale
//     dQ = dS K,   dK = dS^T Q,   dV = P^T g
//
// What bounds it on the H100: about 10 * BH * Nq * Nk * D FLOP (five
// products of the size of the forward's two) against ~9 tensors of
// BH * N * D floats; at the training shapes (BH = 384, Nq = 452, Nk = 580,
// D = 64) that is ~64 GFLOP against ~60 MB, so it is bound by arithmetic.
//
// Design: the TPU kernel held the whole (Nq, Nk) tile of P in VMEM, which a
// Hopper block cannot. Two kernels, flash-attention-2 style, no atomics:
//   A. one block per (64-query tile, b*h): a first pass over 64-key tiles
//      in shared memory gives each row's max and sum, i.e. its logsumexp L
//      (running max starting at the JAX code's finite NEG_INF, as in K1);
//      Delta comes from g and o; a second pass recomputes P = exp(S - L),
//      dP and dS and accumulates dQ in registers. It writes dQ, L, Delta.
//   B. one block per (64-key tile, b*h): loops over 64-query tiles of q, g,
//      L and Delta in shared memory and accumulates dK and dV in registers.
// Four threads share a row (a query row in A, a key row in B), each holding
// D/4 of its channels in float4 chunks; dot products finish with two warp
// shuffles. Masked entries of P and dS are exactly 0: template query rows
// stop at key n_mt in A, and in B a key tile at or past n_mt starts at
// query n_mt, with each entry still tested against the mask.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TQ = 64;         // query rows per tile
constexpr int TK = 64;         // key rows per tile
constexpr int TPR = 4;         // threads per row
constexpr int KC = 16;         // keys per online-softmax chunk (pass 1 of A)
constexpr int THREADS = 64 * TPR;
constexpr float NEG_INF = -1e30f;

template <int C4>
__device__ __forceinline__ float dot4(const float4 (&a)[C4], const float4* b, int part) {
  float d = 0.f;
#pragma unroll
  for (int c = 0; c < C4; ++c) {
    const float4 bb = b[c * TPR + part];
    d = fmaf(a[c].x, bb.x, d);
    d = fmaf(a[c].y, bb.y, d);
    d = fmaf(a[c].z, bb.z, d);
    d = fmaf(a[c].w, bb.w, d);
  }
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  d += __shfl_xor_sync(0xffffffffu, d, 2);
  return d;
}

template <int C4>
__device__ __forceinline__ void axpy4(float4 (&acc)[C4], float a, const float4* x, int part) {
#pragma unroll
  for (int c = 0; c < C4; ++c) {
    const float4 xx = x[c * TPR + part];
    acc[c].x = fmaf(a, xx.x, acc[c].x);
    acc[c].y = fmaf(a, xx.y, acc[c].y);
    acc[c].z = fmaf(a, xx.z, acc[c].z);
    acc[c].w = fmaf(a, xx.w, acc[c].w);
  }
}

// ---------------------------------------------------------------- kernel A
template <int D>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ o,
                   const float* __restrict__ g, float* __restrict__ dq,
                   float* __restrict__ lse_out, float* __restrict__ delta_out,
                   int Nq, int Nk, int n_mt, float scale) {
  constexpr int D4 = D / 4;
  constexpr int C4 = D4 / TPR;
  static_assert(C4 >= 1 && D4 % TPR == 0, "D must be a multiple of 16");
  __shared__ float4 ks[TK * D4];
  __shared__ float4 vs[TK * D4];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * TQ;
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int i = q0 + row;
  const bool row_valid = i < Nq;
  const size_t qoff = (size_t)bh * Nq * D4 + (size_t)i * D4;

  const float4* qg = reinterpret_cast<const float4*>(q);
  const float4* og = reinterpret_cast<const float4*>(o);
  const float4* gg = reinterpret_cast<const float4*>(g);
  const float4* kg = reinterpret_cast<const float4*>(k) + (size_t)bh * Nk * D4;
  const float4* vg = reinterpret_cast<const float4*>(v) + (size_t)bh * Nk * D4;

  float4 qr[C4], gr[C4], acc[C4];
  float delta = 0.f;
#pragma unroll
  for (int c = 0; c < C4; ++c) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    qr[c] = row_valid ? qg[qoff + c * TPR + part] : z;
    gr[c] = row_valid ? gg[qoff + c * TPR + part] : z;
    const float4 oo = row_valid ? og[qoff + c * TPR + part] : z;
    delta = fmaf(gr[c].x, oo.x, delta);
    delta = fmaf(gr[c].y, oo.y, delta);
    delta = fmaf(gr[c].z, oo.z, delta);
    delta = fmaf(gr[c].w, oo.w, delta);
    acc[c] = z;
  }
  delta += __shfl_xor_sync(0xffffffffu, delta, 1);
  delta += __shfl_xor_sync(0xffffffffu, delta, 2);

  const int last_row = min(q0 + TQ, Nq) - 1;
  const int kend_block = (last_row < n_mt) ? min(n_mt, Nk) : Nk;
  const int kend_row = (i < n_mt) ? min(n_mt, Nk) : Nk;

  // pass 1: the row's logsumexp
  float m = NEG_INF, l = 0.f;
  for (int k0 = 0; k0 < kend_block; k0 += TK) {
    const int nk = min(TK, kend_block - k0);
    __syncthreads();
    for (int x = tid; x < nk * D4; x += THREADS) ks[x] = kg[(size_t)k0 * D4 + x];
    __syncthreads();
    for (int c0 = 0; c0 < nk; c0 += KC) {
      float s[KC];
      float cmax = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        const int j = c0 + jj;
        s[jj] = NEG_INF;
        if (j < nk) {                       // block-uniform: shuffles converge
          const float d = dot4<C4>(qr, ks + j * D4, part);
          if (k0 + j < kend_row) {
            s[jj] = d * scale;
            cmax = fmaxf(cmax, s[jj]);
          }
        }
      }
      const float m_new = fmaxf(m, cmax);
      l *= expf(m - m_new);
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        const int j = c0 + jj;
        if (j < nk && k0 + j < kend_row) l += expf(s[jj] - m_new);
      }
      m = m_new;
    }
  }
  const float lse = m + logf(l);

  // pass 2: dS and dQ
  for (int k0 = 0; k0 < kend_block; k0 += TK) {
    const int nk = min(TK, kend_block - k0);
    __syncthreads();
    for (int x = tid; x < nk * D4; x += THREADS) {
      ks[x] = kg[(size_t)k0 * D4 + x];
      vs[x] = vg[(size_t)k0 * D4 + x];
    }
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float s = dot4<C4>(qr, ks + j * D4, part) * scale;
      const float dp = dot4<C4>(gr, vs + j * D4, part);
      if (k0 + j < kend_row) {
        const float p = expf(s - lse);
        axpy4<C4>(acc, p * (dp - delta) * scale, ks + j * D4, part);
      }
    }
  }

  if (row_valid) {
    float4* dqg = reinterpret_cast<float4*>(dq);
#pragma unroll
    for (int c = 0; c < C4; ++c) dqg[qoff + c * TPR + part] = acc[c];
    if (part == 0) {
      lse_out[(size_t)bh * Nq + i] = lse;
      delta_out[(size_t)bh * Nq + i] = delta;
    }
  }
}

// ---------------------------------------------------------------- kernel B
template <int D>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv,
                     int Nq, int Nk, int n_mt, float scale) {
  constexpr int D4 = D / 4;
  constexpr int C4 = D4 / TPR;
  static_assert(C4 >= 1 && D4 % TPR == 0, "D must be a multiple of 16");
  __shared__ float4 qs[TQ * D4];
  __shared__ float4 gs[TQ * D4];
  __shared__ float ls[TQ];
  __shared__ float dls[TQ];

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * TK;
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int j = k0 + row;
  const bool key_valid = j < Nk;
  const size_t koff = (size_t)bh * Nk * D4 + (size_t)j * D4;

  const float4* qg = reinterpret_cast<const float4*>(q) + (size_t)bh * Nq * D4;
  const float4* gg = reinterpret_cast<const float4*>(g) + (size_t)bh * Nq * D4;
  const float* lg = lse + (size_t)bh * Nq;
  const float* dg = delta + (size_t)bh * Nq;
  const float4* kg = reinterpret_cast<const float4*>(k);
  const float4* vg = reinterpret_cast<const float4*>(v);

  float4 kr[C4], vr[C4], dka[C4], dva[C4];
#pragma unroll
  for (int c = 0; c < C4; ++c) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    kr[c] = key_valid ? kg[koff + c * TPR + part] : z;
    vr[c] = key_valid ? vg[koff + c * TPR + part] : z;
    dka[c] = z;
    dva[c] = z;
  }

  // keys at or past n_mt are seen only by search rows (i >= n_mt)
  const int qstart = (k0 >= n_mt) ? n_mt : 0;
  const bool template_key = j < n_mt;
  for (int t0 = qstart; t0 < Nq; t0 += TQ) {
    const int nq = min(TQ, Nq - t0);
    __syncthreads();
    for (int x = tid; x < nq * D4; x += THREADS) {
      qs[x] = qg[(size_t)t0 * D4 + x];
      gs[x] = gg[(size_t)t0 * D4 + x];
    }
    for (int x = tid; x < nq; x += THREADS) {
      ls[x] = lg[t0 + x];
      dls[x] = dg[t0 + x];
    }
    __syncthreads();
    for (int ii = 0; ii < nq; ++ii) {
      const float s = dot4<C4>(kr, qs + ii * D4, part) * scale;
      const float dp = dot4<C4>(vr, gs + ii * D4, part);
      if (key_valid && (t0 + ii >= n_mt || template_key)) {
        const float p = expf(s - ls[ii]);
        axpy4<C4>(dva, p, gs + ii * D4, part);
        axpy4<C4>(dka, p * (dp - dls[ii]) * scale, qs + ii * D4, part);
      }
    }
  }

  if (key_valid) {
    float4* dkg = reinterpret_cast<float4*>(dk);
    float4* dvg = reinterpret_cast<float4*>(dv);
#pragma unroll
    for (int c = 0; c < C4; ++c) {
      dkg[koff + c * TPR + part] = dka[c];
      dvg[koff + c * TPR + part] = dva[c];
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* o, const float* g,
           float* dq, float* dk, float* dv, float* lse, float* delta,
           int BH, int Nq, int Nk, int n_mt, float scale, cudaStream_t s) {
  attn_bwd_dq_kernel<D><<<dim3((Nq + TQ - 1) / TQ, BH), THREADS, 0, s>>>(
      q, k, v, o, g, dq, lse, delta, Nq, Nk, n_mt, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv_kernel<D><<<dim3((Nk + TK - 1) / TK, BH), THREADS, 0, s>>>(
      q, k, v, g, lse, delta, dk, dv, Nq, Nk, n_mt, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, g, dq: (BH, Nq, D); k, v, dk, dv: (BH, Nk, D); lse, delta: (BH, Nq)
// scratch. All f32, contiguous, 16-byte aligned. Launches kernel A then B
// on `stream`; returns the first cudaGetLastError() that is not 0.
extern "C" int mixed_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* o, const void* g, void* dq, void* dk,
                                       void* dv, void* lse, void* delta, int BH, int Nq,
                                       int Nk, int D, int n_mt, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(o);
  const float* gf = static_cast<const float*>(g);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  float* lf = static_cast<float*>(lse);
  float* df = static_cast<float*>(delta);
  switch (D) {
    case 16: return launch<16>(qf, kf, vf, of, gf, dqf, dkf, dvf, lf, df, BH, Nq, Nk, n_mt, scale, s);
    case 32: return launch<32>(qf, kf, vf, of, gf, dqf, dkf, dvf, lf, df, BH, Nq, Nk, n_mt, scale, s);
    case 64: return launch<64>(qf, kf, vf, of, gf, dqf, dkf, dvf, lf, df, BH, Nq, Nk, n_mt, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
