// Mixed-attention forward (K1) for Hopper (sm_90a): 3xTF32 on the tensor cores.
//
// Replaces the Pallas kernel `_attn_kernel`, launched by
// `_mixed_attention_fwd_pallas` in multi_modal_tracking_tpu/ops/attention.py.
// It computes, per (batch, head),
//
//     O = softmax(mask(Q K^T * scale)) V,   L = logsumexp of the same row,
//     allowed(i, j) = (i >= n_mt) || (j < n_mt),
//
// for q (BH, Nq, D) and k/v (BH, Nk, D), Nq != Nk allowed: template rows
// (i < n_mt) see only the template keys, search rows see every key. L is
// written only when the caller passes a pointer (the training forward, for
// K2); the tracker passes null.
//
// What bounds it on the H100: at the tracking shapes (B*H = 24, Nq <= 324,
// Nk <= 580, D = 64) the work is ~1 GFLOP per call against < 4 MB of
// q/k/v/o, so operations bound it. The port holds f32 accuracy, so both
// products run as 3xTF32 (tf32_mma.cuh): 3 TF32 MMAs per product, the
// card's 495 TFLOP/s of TF32 giving 165 TFLOP/s of f32-accurate products.
//
// Design: flash style, nothing of size Nq x Nk exists. Each warp owns 16
// query rows, holds their Q fragments split into TF32 big/small halves in
// registers, and walks 32-key tiles of K and V that the block stages in
// shared memory with cp.async, double-buffered (rows padded to D + 4 floats
// so fragment loads hit 32 banks). Per tile: S = Q K^T (mma.sync m16n8k8),
// scale, mask, online softmax in the accumulator layout (row max and sum
// across the 4 lanes of a quad), then O += P V with P taken straight from
// the accumulator registers (k relabelled, no shuffle), each tile's P V in
// a fresh accumulator added to O with a rounded add (add_tile). The block
// has 1, 2 or 4 warps (16, 32 or 64 query rows), chosen by the caller so
// that the small tracking shapes still give every SM blocks. A warp whose rows are
// all template rows stops at key n_mt. Masked scores are set to the finite
// NEG_INF before the max and get probability exactly 0.
#include <math.h>

#include "tf32_mma.cuh"

namespace {

using namespace tf32x3;

constexpr int KT = 32;         // keys per shared-memory tile

template <int D, int NW>
__global__ void __launch_bounds__(32 * NW)
mixed_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int Nq, int Nk, int n_mt, float scale) {
  constexpr int STR = D + 4;
  constexpr int KS = D / 8;      // k-steps over the head dim
  constexpr int NT = KT / 8;     // 8-key column tiles of S
  constexpr int DT = D / 8;      // 8-channel column tiles of O
  constexpr int DC = DT < 4 ? DT : 4;   // of them per pass of P V
  constexpr int THREADS = 32 * NW;
  __shared__ __align__(16) float ks[2][KT * STR];
  __shared__ __align__(16) float vs[2][KT * STR];

  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * 16 * NW;
  const int r0 = q0 + 16 * warp;
  const int rA = r0 + g, rB = r0 + g + 8;
  const float* qg = q + (size_t)bh * Nq * D;
  const float* kg = k + (size_t)bh * Nk * D;
  const float* vg = v + (size_t)bh * Nk * D;

  const int kend_t = min(n_mt, Nk);             // a template row's key range
  const int last_block = min(q0 + 16 * NW, Nq) - 1;
  const int kend_block = last_block < n_mt ? kend_t : Nk;
  const int last_warp = min(r0 + 15, Nq - 1);
  const int kend_warp = r0 >= Nq ? 0 : (last_warp < n_mt ? kend_t : Nk);
  const int kendA = rA < n_mt ? kend_t : Nk;
  const int kendB = rB < n_mt ? kend_t : Nk;
  const int ntiles = (kend_block + KT - 1) / KT;

  stage_rows<KT, D, STR, THREADS>(ks[0], kg, 0, Nk, tid);
  stage_rows<KT, D, STR, THREADS>(vs[0], vg, 0, Nk, tid);
  cp_async_commit();

  FragA qa[KS];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = 8 * kk + t;
    qa[kk] = split_a(rA < Nq ? qg[(size_t)rA * D + c] : 0.f,
                     rB < Nq ? qg[(size_t)rB * D + c] : 0.f,
                     rA < Nq ? qg[(size_t)rA * D + c + 4] : 0.f,
                     rB < Nq ? qg[(size_t)rB * D + c + 4] : 0.f);
  }
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float mA = NEG_INF, mB = NEG_INF, lA = 0.f, lB = 0.f;   // l: this lane's part

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      stage_rows<KT, D, STR, THREADS>(ks[buf ^ 1], kg, (it + 1) * KT, Nk, tid);
      stage_rows<KT, D, STR, THREADS>(vs[buf ^ 1], vg, (it + 1) * KT, Nk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int k0 = it * KT;
    if (k0 < kend_warp) {                                  // warp-uniform
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mma3(s[n], qa[kk], load_b_cols<STR>(ks[buf], 8 * n, 8 * kk, g, t));
      }
      float cmA = NEG_INF, cmB = NEG_INF;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + 8 * n + 2 * t + (e & 1);
          const bool ok = j < (e < 2 ? kendA : kendB);
          s[n][e] = ok ? s[n][e] * scale : NEG_INF;
        }
        cmA = fmaxf(cmA, fmaxf(s[n][0], s[n][1]));
        cmB = fmaxf(cmB, fmaxf(s[n][2], s[n][3]));
      }
      cmA = fmaxf(cmA, __shfl_xor_sync(0xffffffffu, cmA, 1));
      cmA = fmaxf(cmA, __shfl_xor_sync(0xffffffffu, cmA, 2));
      cmB = fmaxf(cmB, __shfl_xor_sync(0xffffffffu, cmB, 1));
      cmB = fmaxf(cmB, __shfl_xor_sync(0xffffffffu, cmB, 2));
      const float mA_new = fmaxf(mA, cmA), mB_new = fmaxf(mB, cmB);
      const float cA = expf(mA - mA_new), cB = expf(mB - mB_new);
      mA = mA_new;
      mB = mB_new;
      lA *= cA;
      lB *= cB;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[d][0] *= cA; acc[d][1] *= cA; acc[d][2] *= cB; acc[d][3] *= cB;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + 8 * n + 2 * t + (e & 1);
          const bool ok = j < (e < 2 ? kendA : kendB);
          s[n][e] = ok ? expf(s[n][e] - (e < 2 ? mA : mB)) : 0.f;
        }
        lA += s[n][0] + s[n][1];
        lB += s[n][2] + s[n][3];
      }
      FragA pa[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) pa[n] = acc_as_a(s[n]);
#pragma unroll
      for (int d0 = 0; d0 < DT; d0 += DC) {      // DC independent MMA chains
        float part[DC][4] = {};
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int d = 0; d < DC; ++d)
            mma3(part[d], pa[n], load_b_rows<STR>(vs[buf], 8 * n, 8 * (d0 + d), g, t));
#pragma unroll
        for (int d = 0; d < DC; ++d) add_tile(acc[d0 + d], part[d]);
      }
    }
    __syncthreads();
  }

  lA += __shfl_xor_sync(0xffffffffu, lA, 1);
  lA += __shfl_xor_sync(0xffffffffu, lA, 2);
  lB += __shfl_xor_sync(0xffffffffu, lB, 1);
  lB += __shfl_xor_sync(0xffffffffu, lB, 2);
  float* og = o + (size_t)bh * Nq * D;
  if (rA < Nq) {
    const float inv = 1.f / lA;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<float2*>(og + (size_t)rA * D + 8 * d + 2 * t) =
          make_float2(acc[d][0] * inv, acc[d][1] * inv);
    if (lse != nullptr && t == 0) lse[(size_t)bh * Nq + rA] = mA + logf(lA);
  }
  if (rB < Nq) {
    const float inv = 1.f / lB;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<float2*>(og + (size_t)rB * D + 8 * d + 2 * t) =
          make_float2(acc[d][2] * inv, acc[d][3] * inv);
    if (lse != nullptr && t == 0) lse[(size_t)bh * Nq + rB] = mB + logf(lB);
  }
}

template <int D>
int launch(int nw, const float* q, const float* k, const float* v, float* o, float* lse,
           int BH, int Nq, int Nk, int n_mt, float scale, cudaStream_t s) {
  const dim3 grid((Nq + 16 * nw - 1) / (16 * nw), BH);
  switch (nw) {
    case 1: mixed_attention_fwd_kernel<D, 1><<<grid, 32, 0, s>>>(q, k, v, o, lse, Nq, Nk, n_mt, scale); break;
    case 2: mixed_attention_fwd_kernel<D, 2><<<grid, 64, 0, s>>>(q, k, v, o, lse, Nq, Nk, n_mt, scale); break;
    case 4: mixed_attention_fwd_kernel<D, 4><<<grid, 128, 0, s>>>(q, k, v, o, lse, Nq, Nk, n_mt, scale); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (BH, Nq, D), k/v: (BH, Nk, D), o: (BH, Nq, D), lse: (BH, Nq) or null;
// all f32, contiguous, 16-byte aligned. query_warps (1, 2 or 4) sets the
// query rows per block (16 each). Returns cudaGetLastError() after the
// launch.
extern "C" int mixed_attention_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int BH, int Nq, int Nk, int D, int n_mt,
                                       float scale, int query_warps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  switch (D) {
    case 16: return launch<16>(query_warps, qf, kf, vf, of, lf, BH, Nq, Nk, n_mt, scale, s);
    case 32: return launch<32>(query_warps, qf, kf, vf, of, lf, BH, Nq, Nk, n_mt, scale, s);
    case 64: return launch<64>(query_warps, qf, kf, vf, of, lf, BH, Nq, Nk, n_mt, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
