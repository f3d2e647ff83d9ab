// Mixed-attention forward in bf16 (K1-bf16) for Hopper (sm_90a): one bf16
// tensor-core pass per product, f32 accumulation.
//
// Replaces the Pallas kernel `_attn_kernel`, launched by
// `_mixed_attention_fwd_pallas` in multi_modal_tracking_tpu/ops/attention.py,
// at bf16, the JAX package's eval dtype: bf16 q (BH, Nq, D) and k/v
// (BH, Nk, D), Nq != Nk allowed, give the bf16 output of
//
//     O = softmax(mask(Q K^T * scale)) V,   allowed(i, j) = (i >= n_mt) || (j < n_mt),
//
// with the Pallas kernel's rounding points: S = Q K^T accumulated in f32
// and scaled in f32, an f32 softmax, the probabilities rounded to bf16 for
// P V, which accumulates in f32, and the output rounded to bf16. When
// asked (training), it also writes the f32 row logsumexp L = m + log(l) of
// the f32 scores, which the backward K2-bf16 (mixed_attention_bwd_bf16.cu)
// reads; the output does not depend on whether it is asked.
//
// One rounding point differs, as in any flash-style kernel: the Pallas
// kernel rounds the normalised P = exp(s - m) / l of the whole row; this
// kernel rounds exp(s - m_run) under the running row max and divides by
// the f32 row sum l at the end. Both round each probability once, to the
// same relative precision (2^-9), so the outputs agree to about one bf16
// unit; ops/attention.py `mixed_attention_bf16_ref` is the plain version
// with the Pallas rounding, and chip_smoke.py holds the two together.
//
// What bounds it on the H100: at the tracking shapes (B*H = 24, Nq <= 324,
// Nk <= 580, D = 64) about 1 GFLOP per call against < 2 MB of bf16
// q/k/v/o, so operations: 989 TFLOP/s of dense bf16 on the tensor cores.
//
// Design: the f32 kernel's tiling (mixed_attention.cu) with bf16 operands.
// Each warp owns 16 query rows and holds their Q fragments in registers; the
// block stages 32-key tiles of K and V in shared memory with cp.async,
// double-buffered (rows padded to D + 8 bf16, 16-byte aligned, so the
// fragment loads hit 32 banks). Per tile: S = Q K^T (m16n8k16), scale,
// mask, online softmax in the accumulator layout (row max and sum across
// the 4 lanes of a quad), then O += P V with P packed straight from the
// accumulators (bf16_mma.cuh), each tile's P V in a fresh accumulator added
// to O with a rounded add. Masked scores are set to the finite NEG_INF
// before the max and get probability exactly 0; a warp whose rows are all
// template rows stops at key n_mt.
#include <cuda_bf16.h>
#include <math.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

using bf16mma::bf16;
constexpr int KT = 32;         // keys per shared-memory tile

template <int D, int NW>
__global__ void __launch_bounds__(32 * NW)
mixed_attention_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, bf16* __restrict__ o,
                                float* __restrict__ lse, int Nq, int Nk, int n_mt,
                                float scale) {
  constexpr int STR = D + 8;
  constexpr int KS = D / 16;     // k-steps over the head dim in Q K^T
  constexpr int NT = KT / 8;     // 8-key column tiles of S
  constexpr int PS = KT / 16;    // k-steps over the tile's keys in P V
  constexpr int DT = D / 8;      // 8-channel column tiles of O
  constexpr int DC = DT < 4 ? DT : 4;   // of them per pass of P V
  constexpr int THREADS = 32 * NW;
  constexpr float NEG_INF = tf32x3::NEG_INF;
  __shared__ __align__(16) bf16 ks[2][KT * STR];
  __shared__ __align__(16) bf16 vs[2][KT * STR];

  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * 16 * NW;
  const int r0 = q0 + 16 * warp;
  const int rA = r0 + g, rB = r0 + g + 8;
  const bf16* qg = q + (size_t)bh * Nq * D;
  const bf16* kg = k + (size_t)bh * Nk * D;
  const bf16* vg = v + (size_t)bh * Nk * D;

  const int kend_t = min(n_mt, Nk);             // a template row's key range
  const int last_block = min(q0 + 16 * NW, Nq) - 1;
  const int kend_block = last_block < n_mt ? kend_t : Nk;
  const int last_warp = min(r0 + 15, Nq - 1);
  const int kend_warp = r0 >= Nq ? 0 : (last_warp < n_mt ? kend_t : Nk);
  const int kendA = rA < n_mt ? kend_t : Nk;
  const int kendB = rB < n_mt ? kend_t : Nk;
  const int ntiles = (kend_block + KT - 1) / KT;

  bf16mma::stage_rows<KT, D, STR, THREADS>(ks[0], kg, 0, Nk, tid);
  bf16mma::stage_rows<KT, D, STR, THREADS>(vs[0], vg, 0, Nk, tid);
  tf32x3::cp_async_commit();

  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) bf16mma::load_a_rows(qa[kk], qg, r0, 16 * kk, Nq, D, g, t);
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float mA = NEG_INF, mB = NEG_INF, lA = 0.f, lB = 0.f;   // l: this lane's part

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
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t b[2];
          bf16mma::load_b_cols<STR>(b, ks[buf], 8 * n, 16 * kk, g, t);
          bf16mma::mma(s[n], qa[kk], b);
        }
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
      uint32_t pa[PS][4];
#pragma unroll
      for (int ps = 0; ps < PS; ++ps) bf16mma::acc_pair_as_a(pa[ps], s[2 * ps], s[2 * ps + 1]);
#pragma unroll
      for (int d0 = 0; d0 < DT; d0 += DC) {      // DC independent MMA chains
        float part[DC][4] = {};
#pragma unroll
        for (int ps = 0; ps < PS; ++ps)
#pragma unroll
          for (int d = 0; d < DC; ++d) {
            uint32_t b[2];
            bf16mma::load_b_rows<STR>(b, vs[buf], 16 * ps, 8 * (d0 + d), g, t);
            bf16mma::mma(part[d], pa[ps], b);
          }
#pragma unroll
        for (int d = 0; d < DC; ++d) tf32x3::add_tile(acc[d0 + d], part[d]);
      }
    }
    __syncthreads();
  }

  lA += __shfl_xor_sync(0xffffffffu, lA, 1);
  lA += __shfl_xor_sync(0xffffffffu, lA, 2);
  lB += __shfl_xor_sync(0xffffffffu, lB, 1);
  lB += __shfl_xor_sync(0xffffffffu, lB, 2);
  bf16* og = o + (size_t)bh * Nq * D;
  if (lse != nullptr && t == 0) {
    if (rA < Nq) lse[(size_t)bh * Nq + rA] = mA + logf(lA);
    if (rB < Nq) lse[(size_t)bh * Nq + rB] = mB + logf(lB);
  }
  if (rA < Nq) {
    const float inv = 1.f / lA;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)rA * D + 8 * d + 2 * t) =
          __floats2bfloat162_rn(acc[d][0] * inv, acc[d][1] * inv);
  }
  if (rB < Nq) {
    const float inv = 1.f / lB;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)rB * D + 8 * d + 2 * t) =
          __floats2bfloat162_rn(acc[d][2] * inv, acc[d][3] * inv);
  }
}

template <int D>
int launch(int nw, const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int BH,
           int Nq, int Nk, int n_mt, float scale, cudaStream_t s) {
  const dim3 grid((Nq + 16 * nw - 1) / (16 * nw), BH);
  switch (nw) {
    case 1: mixed_attention_fwd_bf16_kernel<D, 1><<<grid, 32, 0, s>>>(q, k, v, o, lse, Nq, Nk, n_mt, scale); break;
    case 2: mixed_attention_fwd_bf16_kernel<D, 2><<<grid, 64, 0, s>>>(q, k, v, o, lse, Nq, Nk, n_mt, scale); break;
    case 4: mixed_attention_fwd_bf16_kernel<D, 4><<<grid, 128, 0, s>>>(q, k, v, o, lse, Nq, Nk, n_mt, scale); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (BH, Nq, D), k/v: (BH, Nk, D), o: (BH, Nq, D); all bf16, contiguous,
// 16-byte aligned. lse: (BH, Nq) f32, or null to skip it. query_warps (1, 2
// or 4) sets the query rows per block (16 each). Returns cudaGetLastError()
// after the launch.
extern "C" int mixed_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int BH, int Nq, int Nk, int D, int n_mt,
                                        float scale, int query_warps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  float* lf = static_cast<float*>(lse);
  switch (D) {
    case 16: return launch<16>(query_warps, qb, kb, vb, ob, lf, BH, Nq, Nk, n_mt, scale, s);
    case 32: return launch<32>(query_warps, qb, kb, vb, ob, lf, BH, Nq, Nk, n_mt, scale, s);
    case 64: return launch<64>(query_warps, qb, kb, vb, ob, lf, BH, Nq, Nk, n_mt, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
