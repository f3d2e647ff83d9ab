// Mixed-attention backward in bf16 (K2-bf16) for Hopper (sm_90a): one bf16
// tensor-core pass per product, f32 accumulation.
//
// Replaces the Pallas kernel `_attn_bwd_kernel`, launched by
// `_mixed_attention_bwd_pallas` in multi_modal_tracking_tpu/ops/attention.py,
// at bf16, the dtype the JAX package trains in. For bf16 q (BH, Nq, D), k/v
// (BH, Nk, D), the bf16 incoming gradient g of the forward output
// (BH, Nq, D) and the f32 row logsumexp L (BH, Nq) that K1-bf16 saved
// (mixed_attention_bf16.cu), with allowed(i, j) = (i >= n_mt) || (j < n_mt):
//
//     P  = exp(Q K^T * scale - L)      f32 scores, recomputed, never stored
//     dP = g V^T                       accumulated in f32
//     dS = P o (dP - Delta),  Delta_i = rowsum(P o dP)_i, in f32
//     dS = 0 where masked, then * scale, then rounded to bf16
//     dQ = dS K,  dK = dS^T Q          accumulated in f32, rounded once
//     dV = bf16(P)^T g                 accumulated in f32, rounded once
//
// These are the Pallas kernel's rounding points at bf16; the plain version
// is ops/attention.py `mixed_attention_bwd_bf16_ref`. P comes from L where
// the Pallas kernel divides exp(s - m) by the row sum: an f32-level
// difference, so a bf16(P) or bf16(dS) may round the other way.
//
// Delta. The f32 K2 takes Delta_i = g_i . o_i from the saved output. Here o
// would be bf16, formed from probabilities K1-bf16 rounded before the sum,
// while the Pallas kernel sums P o dP of the f32 P. So kernel A makes a
// first pass over the keys that forms P and dP and sums P o dP in f32, as
// the Pallas kernel does (two more products in kernel A), and never reads o.
// Taking Delta from the bf16 o instead was measured and refused (PERF.md
// §6: its error against the f32 K2 reached 2.02x the plain version's).
//
// What bounds it on the H100: 10 * BH * D FLOP per unmasked (i, j) pair
// (five products the size of the forward's two) against q, k, v, g, dq, dk
// and dv, 3 * Nq + 4 * Nk rows of BH * D bf16, read or written once, and
// the f32 L; at the largest training shape (BH = 384, Nq = 452, Nk = 580,
// n_mt = 128, D = 64) that is 50 GFLOP, 0.051 ms at 989 TFLOP/s of dense
// bf16, against 181 MB, 0.054 ms at 3.35 TB/s: bytes bound it, narrowly
// (chip_smoke.py, kernels phase).
//
// Design: the f32 K2's two kernels (mixed_attention_bwd.cu), flash-
// attention-2 style, no atomics, deterministic, with every 3xTF32 product
// replaced by one mma.sync m16n8k16 bf16 product (bf16_mma.cuh) and every
// operand staged as bf16 (half the shared memory; rows padded to D + 8
// bf16, 16-byte aligned, so the fragment loads hit 32 banks).
//   A. one block of 4 warps per (64-query tile, b*h); each warp owns 16
//      query rows and holds their Q and g fragments in registers. 32-key
//      tiles of K and V are staged with cp.async, double-buffered. Per
//      tile: S = Q K^T and dP = g V^T, P and dS in the accumulator
//      registers, then dQ += dS K with dS packed to bf16 straight from the
//      accumulators (`acc_pair_as_a`). Delta is written for kernel B.
//   B. one block of 4 warps per (64-key tile, b*h); each warp owns 16 keys
//      and holds their K and V fragments. 32-query tiles of q, g, L and
//      Delta are staged with cp.async, double-buffered. Per tile:
//      S^T = K Q^T and dP^T = V g^T, P^T and dS^T in registers, then
//      dV += bf16(P^T) g and dK += bf16(dS^T) Q.
// The MMA accumulator truncates, so every long sum (dQ over key tiles, dK
// and dV over query tiles) is taken per tile in a fresh accumulator and
// added in f32 (`add_tile`), as in the f32 kernels. The mask stays exact:
// template query tiles stop at key n_mt in A, key tiles at or past n_mt
// start at query n_mt in B, and every entry is still tested, so masked P
// and dS are exactly 0 (ragged tiles and an n_mt inside a tile included).
#include <cuda_bf16.h>
#include <math.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

using bf16mma::bf16;
constexpr int NW = 4;          // warps per block
constexpr int THREADS = 32 * NW;
constexpr int BQ = 16 * NW;    // kernel A: query rows per block
constexpr int BK = 16 * NW;    // kernel B: key rows per block
constexpr int KT = 32;         // kernel A: keys per staged tile
constexpr int QT = 32;         // kernel B: queries per staged tile

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------- kernel A
// At least 4 blocks per SM: left free, ptxas gives it 157 registers (3
// blocks) and it runs 5 % slower at the training shapes.
template <int D>
__global__ void __launch_bounds__(THREADS, 4)
attn_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ g,
                        const float* __restrict__ lse, bf16* __restrict__ dq,
                        float* __restrict__ delta_out, int Nq, int Nk, int n_mt, float scale) {
  constexpr int STR = D + 8;
  constexpr int KS = D / 16;     // k-steps over the head dim in S and dP
  constexpr int NT = KT / 8;     // 8-key column tiles of S and dP
  constexpr int PS = KT / 16;    // k-steps over the tile's keys in dS K
  constexpr int DT = D / 8;      // 8-channel column tiles of dQ
  constexpr int DC = DT < 4 ? DT : 4;   // of them per pass of dS K
  __shared__ __align__(16) bf16 ks[2][KT * STR];
  __shared__ __align__(16) bf16 vs[2][KT * STR];

  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gi = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ;
  const int r0 = q0 + 16 * warp;
  const int rA = r0 + gi, rB = rA + 8;
  const size_t qoff = (size_t)bh * Nq * D;
  const bf16* kg = k + (size_t)bh * Nk * D;
  const bf16* vg = v + (size_t)bh * Nk * D;

  const int kend_t = min(n_mt, Nk);             // a template row's key range
  const int kend_block = min(q0 + BQ, Nq) - 1 < n_mt ? kend_t : Nk;
  const int kend_warp = r0 >= Nq ? 0 : (min(r0 + 15, Nq - 1) < n_mt ? kend_t : Nk);
  const int kendA = rA < n_mt ? kend_t : Nk;
  const int kendB = rB < n_mt ? kend_t : Nk;
  const int ntiles = (kend_block + KT - 1) / KT;

  uint32_t qa[KS][4], ga[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    bf16mma::load_a_rows(qa[kk], q + qoff, r0, 16 * kk, Nq, D, gi, t);
    bf16mma::load_a_rows(ga[kk], g + qoff, r0, 16 * kk, Nq, D, gi, t);
  }
  const float LA = rA < Nq ? lse[(size_t)bh * Nq + rA] : 0.f;
  const float LB = rB < Nq ? lse[(size_t)bh * Nq + rB] : 0.f;
  float dA = 0.f, dB = 0.f;

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  // pass 0 sums Delta = rowsum(P o dP); pass 1 forms dQ
  for (int pass = 0; pass < 2; ++pass) {
    float sA = 0.f, sB = 0.f;
    bf16mma::stage_rows<KT, D, STR, THREADS>(ks[0], kg, 0, Nk, tid);
    bf16mma::stage_rows<KT, D, STR, THREADS>(vs[0], vg, 0, Nk, tid);
    tf32x3::cp_async_commit();
    for (int it = 0; it < ntiles; ++it) {
      const int buf = it & 1;
      if (it + 1 < ntiles) {
        bf16mma::stage_rows<KT, D, STR, THREADS>(ks[buf ^ 1], kg, (it + 1) * KT, Nk, tid);
        bf16mma::stage_rows<KT, D, STR, THREADS>(vs[buf ^ 1], vg, (it + 1) * KT, Nk, tid);
      }
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<1>();
      __syncthreads();

      const int k0 = it * KT;
      if (k0 < kend_warp) {                                  // warp-uniform
        float s[NT][4], dp[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            uint32_t b[2];
            bf16mma::load_b_cols<STR>(b, ks[buf], 8 * n, 16 * kk, gi, t);
            bf16mma::mma(s[n], qa[kk], b);
            bf16mma::load_b_cols<STR>(b, vs[buf], 8 * n, 16 * kk, gi, t);
            bf16mma::mma(dp[n], ga[kk], b);
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = k0 + 8 * n + 2 * t + (e & 1);
            const bool ok = j < (e < 2 ? kendA : kendB);
            const float p = ok ? expf(s[n][e] * scale - (e < 2 ? LA : LB)) : 0.f;
            if (pass == 0) {
              if (e < 2) sA = fmaf(p, dp[n][e], sA);
              else sB = fmaf(p, dp[n][e], sB);
            } else {
              s[n][e] = ok ? p * (dp[n][e] - (e < 2 ? dA : dB)) * scale : 0.f;   // dS
            }
          }
        }
        if (pass == 1) {
          uint32_t da[PS][4];
#pragma unroll
          for (int ps = 0; ps < PS; ++ps) bf16mma::acc_pair_as_a(da[ps], s[2 * ps], s[2 * ps + 1]);
#pragma unroll
          for (int d0 = 0; d0 < DT; d0 += DC) {      // DC independent MMA chains
            float part[DC][4] = {};
#pragma unroll
            for (int ps = 0; ps < PS; ++ps)
#pragma unroll
              for (int d = 0; d < DC; ++d) {
                uint32_t b[2];
                bf16mma::load_b_rows<STR>(b, ks[buf], 16 * ps, 8 * (d0 + d), gi, t);
                bf16mma::mma(part[d], da[ps], b);
              }
#pragma unroll
            for (int d = 0; d < DC; ++d) tf32x3::add_tile(acc[d0 + d], part[d]);
          }
        }
      }
      __syncthreads();
    }
    if (pass == 0) {
      dA = quad_sum(sA);
      dB = quad_sum(sB);
    }
  }

  bf16* dqg = dq + qoff;
  if (rA < Nq) {
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(dqg + (size_t)rA * D + 8 * d + 2 * t) =
          __floats2bfloat162_rn(acc[d][0], acc[d][1]);
    if (t == 0) delta_out[(size_t)bh * Nq + rA] = dA;
  }
  if (rB < Nq) {
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(dqg + (size_t)rB * D + 8 * d + 2 * t) =
          __floats2bfloat162_rn(acc[d][2], acc[d][3]);
    if (t == 0) delta_out[(size_t)bh * Nq + rB] = dB;
  }
}

// ---------------------------------------------------------------- kernel B
template <int D>
__device__ __forceinline__ void stage_query_tile(bf16* qt, bf16* gt, float* lt, float* dlt,
                                                 const bf16* qg, const bf16* gg,
                                                 const float* lg, const float* dg,
                                                 int t0, int Nq, int tid) {
  constexpr int STR = D + 8;
  bf16mma::stage_rows<QT, D, STR, THREADS>(qt, qg, t0, Nq, tid);
  bf16mma::stage_rows<QT, D, STR, THREADS>(gt, gg, t0, Nq, tid);
  if (tid < QT) {
    const bool ok = t0 + tid < Nq;
    tf32x3::cp_async4(lt + tid, ok ? lg + t0 + tid : lg, ok ? 4 : 0);
    tf32x3::cp_async4(dlt + tid, ok ? dg + t0 + tid : dg, ok ? 4 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ g,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int Nq, int Nk,
                          int n_mt, float scale) {
  constexpr int STR = D + 8;
  constexpr int KS = D / 16;     // k-steps over the head dim in S^T and dP^T
  constexpr int NT = QT / 8;     // 8-query column tiles of S^T and dP^T
  constexpr int PS = QT / 16;    // k-steps over the tile's queries in P^T g, dS^T Q
  constexpr int DT = D / 8;
  constexpr int DC = DT < 4 ? DT : 4;   // channel tiles per pass of dV and dK
  __shared__ __align__(16) bf16 qs[2][QT * STR];
  __shared__ __align__(16) bf16 gs[2][QT * STR];
  __shared__ __align__(16) float ls[2][QT];
  __shared__ __align__(16) float dls[2][QT];

  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gi = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * BK;
  const int w0 = k0 + 16 * warp;
  const int jA = w0 + gi, jB = jA + 8;
  const size_t koff = (size_t)bh * Nk * D;
  const bf16* qg = q + (size_t)bh * Nq * D;
  const bf16* gg = g + (size_t)bh * Nq * D;
  const float* lg = lse + (size_t)bh * Nq;
  const float* dg = delta + (size_t)bh * Nq;

  // keys at or past n_mt are seen only by search rows (i >= n_mt)
  const int qstart = k0 >= n_mt ? n_mt : 0;
  const int ntiles = Nq > qstart ? (Nq - qstart + QT - 1) / QT : 0;
  if (ntiles > 0) stage_query_tile<D>(qs[0], gs[0], ls[0], dls[0], qg, gg, lg, dg, qstart, Nq, tid);
  tf32x3::cp_async_commit();
  uint32_t ka[KS][4], va[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    bf16mma::load_a_rows(ka[kk], k + koff, w0, 16 * kk, Nk, D, gi, t);
    bf16mma::load_a_rows(va[kk], v + koff, w0, 16 * kk, Nk, D, gi, t);
  }
  const bool tmplA = jA < n_mt, tmplB = jB < n_mt;

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    const int t0 = qstart + it * QT;
    if (it + 1 < ntiles)
      stage_query_tile<D>(qs[buf ^ 1], gs[buf ^ 1], ls[buf ^ 1], dls[buf ^ 1], qg, gg, lg, dg,
                          t0 + QT, Nq, tid);
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<1>();
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b[2];
        bf16mma::load_b_cols<STR>(b, qs[buf], 8 * n, 16 * kk, gi, t);
        bf16mma::mma(s[n], ka[kk], b);
        bf16mma::load_b_cols<STR>(b, gs[buf], 8 * n, 16 * kk, gi, t);
        bf16mma::mma(dp[n], va[kk], b);
      }
    }
    // s -> P^T, dp -> dS^T (rows: keys jA, jB; columns: queries)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = 8 * n + 2 * t + (e & 1);
        const int i = t0 + il;
        const bool ok = i < Nq && (e < 2 ? jA : jB) < Nk &&
                        (i >= n_mt || (e < 2 ? tmplA : tmplB));
        const float p = ok ? expf(s[n][e] * scale - ls[buf][il]) : 0.f;
        s[n][e] = p;
        dp[n][e] = ok ? p * (dp[n][e] - dls[buf][il]) * scale : 0.f;
      }
    }
    uint32_t pa[PS][4], da[PS][4];
#pragma unroll
    for (int ps = 0; ps < PS; ++ps) {
      bf16mma::acc_pair_as_a(pa[ps], s[2 * ps], s[2 * ps + 1]);
      bf16mma::acc_pair_as_a(da[ps], dp[2 * ps], dp[2 * ps + 1]);
    }
#pragma unroll
    for (int d0 = 0; d0 < DT; d0 += DC) {        // 2 * DC independent MMA chains
      float pv[DC][4] = {}, pk[DC][4] = {};
#pragma unroll
      for (int ps = 0; ps < PS; ++ps) {
#pragma unroll
        for (int d = 0; d < DC; ++d) {
          uint32_t b[2];
          bf16mma::load_b_rows<STR>(b, gs[buf], 16 * ps, 8 * (d0 + d), gi, t);
          bf16mma::mma(pv[d], pa[ps], b);
          bf16mma::load_b_rows<STR>(b, qs[buf], 16 * ps, 8 * (d0 + d), gi, t);
          bf16mma::mma(pk[d], da[ps], b);
        }
      }
#pragma unroll
      for (int d = 0; d < DC; ++d) {
        tf32x3::add_tile(dva[d0 + d], pv[d]);
        tf32x3::add_tile(dka[d0 + d], pk[d]);
      }
    }
    __syncthreads();
  }

  bf16* dkg = dk + koff;
  bf16* dvg = dv + koff;
  if (jA < Nk) {
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(dkg + (size_t)jA * D + 8 * d + 2 * t) =
          __floats2bfloat162_rn(dka[d][0], dka[d][1]);
      *reinterpret_cast<__nv_bfloat162*>(dvg + (size_t)jA * D + 8 * d + 2 * t) =
          __floats2bfloat162_rn(dva[d][0], dva[d][1]);
    }
  }
  if (jB < Nk) {
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(dkg + (size_t)jB * D + 8 * d + 2 * t) =
          __floats2bfloat162_rn(dka[d][2], dka[d][3]);
      *reinterpret_cast<__nv_bfloat162*>(dvg + (size_t)jB * D + 8 * d + 2 * t) =
          __floats2bfloat162_rn(dva[d][2], dva[d][3]);
    }
  }
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* g, const float* lse,
           bf16* dq, bf16* dk, bf16* dv, float* delta, int BH, int Nq, int Nk, int n_mt,
           float scale, cudaStream_t s) {
  attn_bwd_dq_bf16_kernel<D><<<dim3((Nq + BQ - 1) / BQ, BH), THREADS, 0, s>>>(
      q, k, v, g, lse, dq, delta, Nq, Nk, n_mt, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv_bf16_kernel<D><<<dim3((Nk + BK - 1) / BK, BH), THREADS, 0, s>>>(
      q, k, v, g, lse, delta, dk, dv, Nq, Nk, n_mt, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, g, dq: (BH, Nq, D); k, v, dk, dv: (BH, Nk, D); all bf16, contiguous,
// 16-byte aligned. lse: (BH, Nq) f32, the row logsumexp saved by K1-bf16;
// delta: (BH, Nq) f32 scratch. Launches kernel A then B on `stream`;
// returns the first launch error that is not 0.
extern "C" int mixed_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* g, const void* lse, void* dq, void* dk,
                                        void* dv, void* delta, int BH, int Nq, int Nk, int D,
                                        int n_mt, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* gb = static_cast<const bf16*>(g);
  const float* lf = static_cast<const float*>(lse);
  bf16* dqb = static_cast<bf16*>(dq);
  bf16* dkb = static_cast<bf16*>(dk);
  bf16* dvb = static_cast<bf16*>(dv);
  float* df = static_cast<float*>(delta);
  switch (D) {
    case 16: return launch<16>(qb, kb, vb, gb, lf, dqb, dkb, dvb, df, BH, Nq, Nk, n_mt, scale, s);
    case 32: return launch<32>(qb, kb, vb, gb, lf, dqb, dkb, dvb, df, BH, Nq, Nk, n_mt, scale, s);
    case 64: return launch<64>(qb, kb, vb, gb, lf, dqb, dkb, dvb, df, BH, Nq, Nk, n_mt, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
