// Mixed-attention backward (K2) for Hopper (sm_90a): 3xTF32 on the tensor cores.
//
// Replaces the Pallas kernel `_attn_bwd_kernel`, launched by
// `_mixed_attention_bwd_pallas` in multi_modal_tracking_tpu/ops/attention.py.
// For q (BH, Nq, D), k/v (BH, Nk, D), the forward output o, its incoming
// gradient g (BH, Nq, D) and the row logsumexp L (BH, Nq) that K1 saved,
// with allowed(i, j) = (i >= n_mt) || (j < n_mt):
//
//     P  = exp(Q K^T * scale - L)              recomputed, never stored
//     dP = g V^T
//     dS = P o (dP - Delta),  Delta_i = rowsum(P o dP)_i = g_i . o_i
//     dS = 0 where masked, then * scale
//     dQ = dS K,   dK = dS^T Q,   dV = P^T g
//
// What bounds it on the H100: 10 * BH * D FLOP per unmasked (i, j) pair
// (five products the size of the forward's two) against ~9 tensors of
// BH * N * D floats; at the training shapes (BH = 384, Nq <= 452, Nk <= 580,
// D = 64) that is ~64 GFLOP against ~60 MB a call, so operations bound it.
// Every product runs as 3xTF32 (tf32_mma.cuh), f32-accurate at 495 / 3 =
// 165 TFLOP/s.
//
// Design: two kernels, flash-attention-2 style, no atomics, deterministic.
//   A. one block of 4 warps per (64-query tile, b*h); each warp owns 16
//      query rows. Q and g of the block are split into TF32 halves once, as
//      they are staged; K and V are walked in 32-key tiles staged with
//      cp.async, double-buffered, and split when loaded into fragments. One
//      pass per key tile: S = Q K^T and dP = g V^T (mma.sync m16n8k8), then
//      P and dS in the accumulator registers, then dQ += dS K with dS taken
//      straight from the registers. L comes from K1, so no pass recomputes
//      it; Delta is taken from g and o and written for kernel B.
//      dQ sums each key tile in a fresh accumulator (add_tile).
//   B. one block of 4 warps per (64-key tile, b*h); each warp owns 16 keys,
//      K and V split once as staged. 32-query tiles of q, g, L and Delta are
//      staged with cp.async, double-buffered. Per tile: S^T = K Q^T and
//      dP^T = V g^T, P^T and dS^T in registers, dV += P^T g and
//      dK += dS^T Q, each query tile summed in a fresh accumulator.
// The mask stays exact: template query tiles stop at key n_mt in A, key
// tiles at or past n_mt start at query n_mt in B, and every entry is still
// tested, so masked P and dS are exactly 0 (ragged tiles and an n_mt inside
// a tile included).
#include <math.h>

#include "tf32_mma.cuh"

namespace {

using namespace tf32x3;

constexpr int NW = 4;          // warps per block
constexpr int THREADS = 32 * NW;
constexpr int BQ = 16 * NW;    // kernel A: query rows per block
constexpr int BK = 16 * NW;    // kernel B: key rows per block
constexpr int KT = 32;         // kernel A: keys per staged tile
constexpr int QT = 32;         // kernel B: queries per staged tile

template <int D>
constexpr int smem_a_bytes() { return (4 * BQ + 4 * KT) * (D + 4) * 4; }
template <int D>
constexpr int smem_b_bytes() { return (4 * BK + 4 * QT) * (D + 4) * 4 + 4 * QT * 4; }

// ---------------------------------------------------------------- kernel A
template <int D>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ o,
                   const float* __restrict__ g, const float* __restrict__ lse,
                   float* __restrict__ dq, float* __restrict__ delta_out,
                   int Nq, int Nk, int n_mt, float scale) {
  constexpr int STR = D + 4;
  constexpr int KS = D / 8, NT = KT / 8, DT = D / 8;
  extern __shared__ float4 smem4[];
  uint32_t* qb = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* qsm = qb + BQ * STR;
  uint32_t* gb = qsm + BQ * STR;
  uint32_t* gsm = gb + BQ * STR;
  float* kt = reinterpret_cast<float*>(gsm + BQ * STR);   // [2][KT * STR]
  float* vt = kt + 2 * KT * STR;                          // [2][KT * STR]

  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gi = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ;
  const int w0 = 16 * warp;                 // the warp's first row in the block
  const int rA = q0 + w0 + gi, rB = rA + 8;
  const size_t qoff = (size_t)bh * Nq * D;
  const float* kg = k + (size_t)bh * Nk * D;
  const float* vg = v + (size_t)bh * Nk * D;

  const int kend_t = min(n_mt, Nk);
  const int kend_block = min(q0 + BQ, Nq) - 1 < n_mt ? kend_t : Nk;
  const int r0 = q0 + w0;
  const int kend_warp = r0 >= Nq ? 0 : (min(r0 + 15, Nq - 1) < n_mt ? kend_t : Nk);
  const int kendA = rA < n_mt ? kend_t : Nk;
  const int kendB = rB < n_mt ? kend_t : Nk;
  const int ntiles = (kend_block + KT - 1) / KT;

  stage_rows<KT, D, STR, THREADS>(kt, kg, 0, Nk, tid);
  stage_rows<KT, D, STR, THREADS>(vt, vg, 0, Nk, tid);
  cp_async_commit();
  stage_rows_split<BQ, D, STR, THREADS>(qb, qsm, q + qoff, q0, Nq, tid);
  stage_rows_split<BQ, D, STR, THREADS>(gb, gsm, g + qoff, q0, Nq, tid);

  // Delta = g . o per row (lane t sums channels t, t+4, ...), and L
  float dA = 0.f, dB = 0.f;
#pragma unroll
  for (int c = t; c < D; c += 4) {
    if (rA < Nq) dA = fmaf(g[qoff + (size_t)rA * D + c], o[qoff + (size_t)rA * D + c], dA);
    if (rB < Nq) dB = fmaf(g[qoff + (size_t)rB * D + c], o[qoff + (size_t)rB * D + c], dB);
  }
  dA += __shfl_xor_sync(0xffffffffu, dA, 1);
  dA += __shfl_xor_sync(0xffffffffu, dA, 2);
  dB += __shfl_xor_sync(0xffffffffu, dB, 1);
  dB += __shfl_xor_sync(0xffffffffu, dB, 2);
  const float LA = rA < Nq ? lse[(size_t)bh * Nq + rA] : 0.f;
  const float LB = rB < Nq ? lse[(size_t)bh * Nq + rB] : 0.f;

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    float* ktb = kt + buf * KT * STR;
    float* vtb = vt + buf * KT * STR;
    if (it + 1 < ntiles) {
      stage_rows<KT, D, STR, THREADS>(kt + (buf ^ 1) * KT * STR, kg, (it + 1) * KT, Nk, tid);
      stage_rows<KT, D, STR, THREADS>(vt + (buf ^ 1) * KT * STR, vg, (it + 1) * KT, Nk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
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
        const FragA qa = load_a_split<STR>(qb, qsm, w0, 8 * kk, gi, t);
        const FragA ga = load_a_split<STR>(gb, gsm, w0, 8 * kk, gi, t);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          mma3(s[n], qa, load_b_cols<STR>(ktb, 8 * n, 8 * kk, gi, t));
          mma3(dp[n], ga, load_b_cols<STR>(vtb, 8 * n, 8 * kk, gi, t));
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + 8 * n + 2 * t + (e & 1);
          const bool ok = j < (e < 2 ? kendA : kendB);
          const float p = ok ? expf(s[n][e] * scale - (e < 2 ? LA : LB)) : 0.f;
          s[n][e] = ok ? p * (dp[n][e] - (e < 2 ? dA : dB)) * scale : 0.f;   // dS
        }
      }
      FragA da[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) da[n] = acc_as_a(s[n]);
      float part[DT][4] = {};                 // DT independent MMA chains
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int d = 0; d < DT; ++d)
          mma3(part[d], da[n], load_b_rows<STR>(ktb, 8 * n, 8 * d, gi, t));
#pragma unroll
      for (int d = 0; d < DT; ++d) add_tile(acc[d], part[d]);
    }
    __syncthreads();
  }

  float* dqg = dq + qoff;
  if (rA < Nq) {
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<float2*>(dqg + (size_t)rA * D + 8 * d + 2 * t) =
          make_float2(acc[d][0], acc[d][1]);
    if (t == 0) delta_out[(size_t)bh * Nq + rA] = dA;
  }
  if (rB < Nq) {
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<float2*>(dqg + (size_t)rB * D + 8 * d + 2 * t) =
          make_float2(acc[d][2], acc[d][3]);
    if (t == 0) delta_out[(size_t)bh * Nq + rB] = dB;
  }
}

// ---------------------------------------------------------------- kernel B
template <int D>
__device__ __forceinline__ void stage_query_tile(float* qt, float* gt, float* lt, float* dlt,
                                                 const float* qg, const float* gg,
                                                 const float* lg, const float* dg,
                                                 int t0, int Nq, int tid) {
  constexpr int STR = D + 4;
  stage_rows<QT, D, STR, THREADS>(qt, qg, t0, Nq, tid);
  stage_rows<QT, D, STR, THREADS>(gt, gg, t0, Nq, tid);
  if (tid < QT) {
    const bool ok = t0 + tid < Nq;
    cp_async4(lt + tid, ok ? lg + t0 + tid : lg, ok ? 4 : 0);
    cp_async4(dlt + tid, ok ? dg + t0 + tid : dg, ok ? 4 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv,
                     int Nq, int Nk, int n_mt, float scale) {
  constexpr int STR = D + 4;
  constexpr int KS = D / 8, NT = QT / 8, DT = D / 8;
  constexpr int DC = DT < 4 ? DT : 4;   // channel tiles per pass of dV and dK
  extern __shared__ float4 smem4[];
  uint32_t* kb = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* ksm = kb + BK * STR;
  uint32_t* vb = ksm + BK * STR;
  uint32_t* vsm = vb + BK * STR;
  float* qt = reinterpret_cast<float*>(vsm + BK * STR);   // [2][QT * STR]
  float* gt = qt + 2 * QT * STR;                          // [2][QT * STR]
  float* lt = gt + 2 * QT * STR;                          // [2][QT]
  float* dlt = lt + 2 * QT;                               // [2][QT]

  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gi = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * BK;
  const int w0 = 16 * warp;
  const int jA = k0 + w0 + gi, jB = jA + 8;
  const size_t koff = (size_t)bh * Nk * D;
  const float* qg = q + (size_t)bh * Nq * D;
  const float* gg = g + (size_t)bh * Nq * D;
  const float* lg = lse + (size_t)bh * Nq;
  const float* dg = delta + (size_t)bh * Nq;

  // keys at or past n_mt are seen only by search rows (i >= n_mt)
  const int qstart = k0 >= n_mt ? n_mt : 0;
  const int ntiles = Nq > qstart ? (Nq - qstart + QT - 1) / QT : 0;
  if (ntiles > 0) stage_query_tile<D>(qt, gt, lt, dlt, qg, gg, lg, dg, qstart, Nq, tid);
  cp_async_commit();
  stage_rows_split<BK, D, STR, THREADS>(kb, ksm, k + koff, k0, Nk, tid);
  stage_rows_split<BK, D, STR, THREADS>(vb, vsm, v + koff, k0, Nk, tid);
  const bool tmplA = jA < n_mt, tmplB = jB < n_mt;

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    const int t0 = qstart + it * QT;
    float* qtb = qt + buf * QT * STR;
    float* gtb = gt + buf * QT * STR;
    const float* ltb = lt + buf * QT;
    const float* dltb = dlt + buf * QT;
    if (it + 1 < ntiles)
      stage_query_tile<D>(qt + (buf ^ 1) * QT * STR, gt + (buf ^ 1) * QT * STR,
                          lt + (buf ^ 1) * QT, dlt + (buf ^ 1) * QT, qg, gg, lg, dg,
                          t0 + QT, Nq, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const FragA ka = load_a_split<STR>(kb, ksm, w0, 8 * kk, gi, t);
      const FragA va = load_a_split<STR>(vb, vsm, w0, 8 * kk, gi, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mma3(s[n], ka, load_b_cols<STR>(qtb, 8 * n, 8 * kk, gi, t));
        mma3(dp[n], va, load_b_cols<STR>(gtb, 8 * n, 8 * kk, gi, t));
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
        const float p = ok ? expf(s[n][e] * scale - ltb[il]) : 0.f;
        s[n][e] = p;
        dp[n][e] = ok ? p * (dp[n][e] - dltb[il]) * scale : 0.f;
      }
    }
    FragA pa[NT], da[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      pa[n] = acc_as_a(s[n]);
      da[n] = acc_as_a(dp[n]);
    }
#pragma unroll
    for (int d0 = 0; d0 < DT; d0 += DC) {        // 2 * DC independent MMA chains
      float pv[DC][4] = {}, pk[DC][4] = {};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int d = 0; d < DC; ++d) {
          mma3(pv[d], pa[n], load_b_rows<STR>(gtb, 8 * n, 8 * (d0 + d), gi, t));
          mma3(pk[d], da[n], load_b_rows<STR>(qtb, 8 * n, 8 * (d0 + d), gi, t));
        }
      }
#pragma unroll
      for (int d = 0; d < DC; ++d) {
        add_tile(dva[d0 + d], pv[d]);
        add_tile(dka[d0 + d], pk[d]);
      }
    }
    __syncthreads();
  }

  float* dkg = dk + koff;
  float* dvg = dv + koff;
  if (jA < Nk) {
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      *reinterpret_cast<float2*>(dkg + (size_t)jA * D + 8 * d + 2 * t) =
          make_float2(dka[d][0], dka[d][1]);
      *reinterpret_cast<float2*>(dvg + (size_t)jA * D + 8 * d + 2 * t) =
          make_float2(dva[d][0], dva[d][1]);
    }
  }
  if (jB < Nk) {
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      *reinterpret_cast<float2*>(dkg + (size_t)jB * D + 8 * d + 2 * t) =
          make_float2(dka[d][2], dka[d][3]);
      *reinterpret_cast<float2*>(dvg + (size_t)jB * D + 8 * d + 2 * t) =
          make_float2(dva[d][2], dva[d][3]);
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* o, const float* g,
           const float* lse, float* dq, float* dk, float* dv, float* delta,
           int BH, int Nq, int Nk, int n_mt, float scale, cudaStream_t s) {
  // the shared-memory attribute belongs to each device's context: set it
  // once per device
  constexpr int MAX_DEVICES = 64;
  static bool attrs_set[MAX_DEVICES] = {};
  constexpr int smem_a = smem_a_bytes<D>(), smem_b = smem_b_bytes<D>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES || !attrs_set[dev]) {
    err = cudaFuncSetAttribute(attn_bwd_dq_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_b);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < MAX_DEVICES) attrs_set[dev] = true;
  }
  attn_bwd_dq_kernel<D><<<dim3((Nq + BQ - 1) / BQ, BH), THREADS, smem_a, s>>>(
      q, k, v, o, g, lse, dq, delta, Nq, Nk, n_mt, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv_kernel<D><<<dim3((Nk + BK - 1) / BK, BH), THREADS, smem_b, s>>>(
      q, k, v, g, lse, delta, dk, dv, Nq, Nk, n_mt, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, g, dq: (BH, Nq, D); k, v, dk, dv: (BH, Nk, D); lse: (BH, Nq), the
// row logsumexp saved by K1; delta: (BH, Nq) scratch. All f32, contiguous,
// 16-byte aligned. Launches kernel A then B on `stream`; returns the first
// error (attribute or launch) that is not 0.
extern "C" int mixed_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* o, const void* g, const void* lse,
                                       void* dq, void* dk, void* dv, void* delta, int BH,
                                       int Nq, int Nk, int D, int n_mt, float scale,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(o);
  const float* gf = static_cast<const float*>(g);
  const float* lf = static_cast<const float*>(lse);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  float* df = static_cast<float*>(delta);
  switch (D) {
    case 16: return launch<16>(qf, kf, vf, of, gf, lf, dqf, dkf, dvf, df, BH, Nq, Nk, n_mt, scale, s);
    case 32: return launch<32>(qf, kf, vf, of, gf, lf, dqf, dkf, dvf, df, BH, Nq, Nk, n_mt, scale, s);
    case 64: return launch<64>(qf, kf, vf, of, gf, lf, dqf, dkf, dvf, df, BH, Nq, Nk, n_mt, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
