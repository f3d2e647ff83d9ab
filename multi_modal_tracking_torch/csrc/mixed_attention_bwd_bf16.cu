// Mixed-attention backward in bf16 (K2-bf16) for Hopper (sm_90a): wgmma on
// the tensor cores, TMA loads into shared-memory rings, no atomics.
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
// the Pallas kernel divides exp(s - m) by the row sum, and exp(x) is taken
// as 2^(x log2 e) in one MUFU instruction (ex2.approx, relative error below
// 2^-21): f32-level differences, so a bf16(P) or bf16(dS) may round the
// other way. With CUDA's accurate expf and a branch around each masked
// element's exp, the first build of these kernels was no faster than the
// mma.sync ones they replace.
//
// Delta is summed from the f32 P and dP, as the Pallas kernel does, in a
// first sweep of the dQ kernel over the keys; taking it from the bf16
// forward output instead was measured and refused (PERF.md §6: its error
// against the f32 K2 reached 2.02x the plain version's).
//
// What bounds it on the H100: 10 * BH * D FLOP per unmasked (i, j) pair
// (five products the size of the forward's two; Delta's sweep adds 4)
// against q, k, v, g, dq, dk, dv and the f32 L, read or written once; at
// the training shapes the bytes bound it, narrowly (chip_smoke.py,
// kernels phase), so the kernel's aim is the tensor cores' rate.
//
// Design (wgmma_bf16.cuh): two kernels, each with a producer warp that
// keeps TMA loads in flight while consumer warpgroups run wgmma; every
// long sum accumulates straight in one thread's wgmma accumulator, with no
// per-tile partial sum (its error against the f32 K2 stays the plain
// version's, PERF.md §6), and is written once, so the result is the same
// bit for bit from call to call.
//   A. dQ: one block per (64 queries, b*h), one consumer warpgroup; Q and g
//      loaded once, 64-key tiles of K and V streamed through a 2-stage
//      ring twice. Sweep 0 forms S = Q K^T and dP = g V^T (SS wgmma) and
//      sums Delta; sweep 1 forms them again, then dS, packs it to bf16 A
//      fragments in registers and adds dS K into dQ (RS wgmma, K read
//      MN-major). Delta is written for kernel B.
//   B. dK/dV: one block per (128 keys, b*h), two consumer warpgroups of 64
//      keys and a producer warpgroup (one warp loads; the warpgroup gives
//      its registers to the consumers with setmaxnreg); K and V loaded once
//      and used as the A operand of S^T = K Q^T and dP^T = V g^T (SS);
//      64-query tiles of q, g, L and
//      Delta stream through a 2-stage ring shared by both warpgroups; P^T
//      and dS^T are packed in registers for dV += P^T g and dK += dS^T Q
//      (RS, g and Q read MN-major).
// The mask stays exact and skips what it removes: template query tiles
// stop at key n_mt in A, key tiles at or past n_mt start at query n_mt in
// B, and only tiles that cross n_mt or a ragged end test each element, so
// masked P and dS are exactly 0 (an n_mt inside a tile included).
#include <cuda_bf16.h>
#include <math.h>

#include "wgmma_bf16.cuh"

namespace {

using hopper::bf16;
constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile (per warpgroup in B)
constexpr int STAGES = 2;
// A TMA box starts on a 16-byte boundary of its innermost dimension, so
// kernel B loads L and Delta, f32 vectors over b*h*Nq, from the boundary at
// or before a tile's first query: VLEN = 64 + 4 values, VSTRIDE apart in
// shared memory (128-byte slots)
constexpr int VLEN = 68, VSTRIDE = 96;

// ---------------------------------------------------------------- kernel A
template <int D>
struct SmemA {
  static constexpr int TILE = 64 * D * 2;
  static constexpr int Q = 0, G = TILE, KV = 2 * TILE;        // ring: [STAGES][K, V]
  static constexpr int BARS = KV + STAGES * 2 * TILE;         // full[STAGES], empty[STAGES], qg
  static constexpr int ALLOC = BARS + (2 * STAGES + 1) * 8 + 1024;
};

// three blocks a SM: ptxas keeps it at 128 registers without a spill, and
// the third warpgroup a SM hides more of each tile's latency than it costs
template <int D>
__global__ void __launch_bounds__(160, 3)
attn_bwd_dq_bf16_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tg, const float* __restrict__ lse,
                       bf16* __restrict__ dq, float* __restrict__ delta_out, int Nq, int Nk,
                       int n_mt, float scale) {
  using L = SmemA<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* qgbar = empty + STAGES;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int kend_t = min(n_mt, Nk);                     // a template row's key range
  const int kend_block = min(q0 + BQ, Nq) - 1 < n_mt ? kend_t : Nk;
  const int ntiles = (kend_block + BK - 1) / BK;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 4);
    }
    hopper::mbar_init(qgbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128) {
    // ---------------------------------------------------------- producer
    if (tid == 128) {
      hopper::tma_prefetch(&tk);
      hopper::tma_prefetch(&tv);
      hopper::mbar_expect_tx(qgbar, 2 * L::TILE);
      hopper::tma_load_3d(smem + L::Q, &tq, qgbar, 0, q0, bh);
      hopper::tma_load_3d(smem + L::G, &tg, qgbar, 0, q0, bh);
      for (int n = 0; n < 2 * ntiles; ++n) {            // sweep 0, then sweep 1
        const int st = n % STAGES, k0 = (n % ntiles) * BK;
        hopper::mbar_wait(&empty[st], ((n / STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[st], 2 * L::TILE);
        uint8_t* kt = smem + L::KV + st * 2 * L::TILE;
        hopper::tma_load_3d(kt, &tk, &full[st], 0, k0, bh);
        hopper::tma_load_3d(kt + L::TILE, &tv, &full[st], 0, k0, bh);
      }
    }
    return;
  }

  // ------------------------------------------------------------- consumer
  const int wt = tid, lane = tid % 32;
  const int iA = q0 + hopper::acc_row(wt, 0), iB = q0 + hopper::acc_row(wt, 2);
  const int kendA = iA < n_mt ? kend_t : Nk, kendB = iB < n_mt ? kend_t : Nk;
  const float sl2 = scale * hopper::LOG2E;             // exp(x) = 2^(x log2 e)
  const float LA2 = iA < Nq ? lse[(size_t)bh * Nq + iA] * hopper::LOG2E : 0.f;
  const float LB2 = iB < Nq ? lse[(size_t)bh * Nq + iB] * hopper::LOG2E : 0.f;
  const uint8_t* qs = smem + L::Q;
  const uint8_t* gs = smem + L::G;
  float dA = 0.f, dB = 0.f;                             // Delta, this lane's part
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  hopper::mbar_wait(qgbar, 0);
  for (int n = 0; n < 2 * ntiles; ++n) {
    const int st = n % STAGES, k0 = (n % ntiles) * BK;
    const bool dq_sweep = n >= ntiles;
    const uint8_t* kt = smem + L::KV + st * 2 * L::TILE;
    hopper::mbar_wait(&full[st], (n / STAGES) & 1);
    if (n == ntiles) {                                  // Delta complete
      dA = hopper::quad_sum(dA);
      dB = hopper::quad_sum(dB);
    }

    float sc[32], dp[32];
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      hopper::wgmma_ss_n64(sc, hopper::desc<D>(qs + 32 * kk), hopper::desc<D>(kt + 32 * kk),
                           kk > 0);
      hopper::wgmma_ss_n64(dp, hopper::desc<D>(gs + 32 * kk),
                           hopper::desc<D>(kt + L::TILE + 32 * kk), kk > 0);
    }
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    if (!dq_sweep) {                                    // K and V are read: release them
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[st]);
    }

    // masked scores become NEG_INF, so P = 2^(s scale log2 e - L log2 e) = 0
    // there (each element tested only on a tile that crosses n_mt or the
    // ragged end)
    if (k0 + BK > Nk || (q0 < n_mt && k0 + BK > kend_t)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + hopper::acc_col(wt, j, e) >= (e < 2 ? kendA : kendB))
            sc[4 * j + e] = hopper::NEG_INF;
    }
    if (!dq_sweep) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dA = fmaf(hopper::ex2(fmaf(sc[4 * j], sl2, -LA2)), dp[4 * j], dA);
        dA = fmaf(hopper::ex2(fmaf(sc[4 * j + 1], sl2, -LA2)), dp[4 * j + 1], dA);
        dB = fmaf(hopper::ex2(fmaf(sc[4 * j + 2], sl2, -LB2)), dp[4 * j + 2], dB);
        dB = fmaf(hopper::ex2(fmaf(sc[4 * j + 3], sl2, -LB2)), dp[4 * j + 3], dB);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {                   // dS
          const float p = hopper::ex2(fmaf(sc[4 * j + e], sl2, -(e < 2 ? LA2 : LB2)));
          sc[4 * j + e] = p * (dp[4 * j + e] - (e < 2 ? dA : dB)) * scale;
        }
    }
    if (dq_sweep) {
      uint32_t da[4][4];
      hopper::acc_as_a<0>(da[0], sc);
      hopper::acc_as_a<1>(da[1], sc);
      hopper::acc_as_a<2>(da[2], sc);
      hopper::acc_as_a<3>(da[3], sc);
      hopper::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_rs<D>(acc, da[kk], hopper::desc<D>(kt + kk * 16 * 2 * D), 1);
      hopper::wg_commit();
      hopper::wg_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(da);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[st]);
    }
  }
  if (wt % 4 == 0) {
    if (iA < Nq) delta_out[(size_t)bh * Nq + iA] = dA;
    if (iB < Nq) delta_out[(size_t)bh * Nq + iB] = dB;
  }
  hopper::store_rows<D>(dq + (size_t)bh * Nq * D, acc, q0, Nq, wt);
}

// ---------------------------------------------------------------- kernel B
template <int D>
struct SmemB {
  static constexpr int TILE = 64 * D * 2;
  static constexpr int K = 0, V = 2 * TILE;                   // 128 keys each
  static constexpr int RING = 4 * TILE;                       // [STAGES][q, g]
  static constexpr int VEC = RING + STAGES * 2 * TILE;        // [STAGES][L, Delta][VLEN] f32
  static constexpr int BARS = VEC + STAGES * 2 * VSTRIDE * 4; // full, empty [STAGES], kv
  static constexpr int ALLOC = BARS + (2 * STAGES + 1) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(384, 1)
attn_bwd_dkdv_bf16_wgmma(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tg,
                         const __grid_constant__ CUtensorMap tl,
                         const __grid_constant__ CUtensorMap tdelta, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int Nq, int Nk, int n_mt, float scale) {
  using L = SmemB<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;

  const int bh = blockIdx.y;
  const int kb0 = blockIdx.x * 2 * BK;
  const int tid = threadIdx.x;
  // keys at or past n_mt are seen only by search rows (i >= n_mt)
  const int qstart = kb0 >= n_mt ? n_mt : 0;
  const int ntiles = Nq > qstart ? (Nq - qstart + BQ - 1) / BQ : 0;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 8);                  // 4 warps of each warpgroup
    }
    hopper::mbar_init(kvbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {
    // ------------------------------------------------ producer warpgroup
    // one warp issues every load; the warpgroup hands its registers to the
    // consumers (56 x 128 + 224 x 256 <= 65536)
    hopper::regs_dec<56>();
    if (tid == 256) {
      hopper::tma_prefetch(&tq);
      hopper::tma_prefetch(&tg);
      hopper::mbar_expect_tx(kvbar, 4 * L::TILE);
      for (int h = 0; h < 2; ++h) {
        hopper::tma_load_3d(smem + L::K + h * L::TILE, &tk, kvbar, 0, kb0 + h * BK, bh);
        hopper::tma_load_3d(smem + L::V + h * L::TILE, &tv, kvbar, 0, kb0 + h * BK, bh);
      }
      for (int n = 0; n < ntiles; ++n) {
        const int st = n % STAGES, t0 = qstart + n * BQ;
        hopper::mbar_wait(&empty[st], ((n / STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[st], 2 * L::TILE + 2 * VLEN * 4);
        uint8_t* qt = smem + L::RING + st * 2 * L::TILE;
        float* vt = reinterpret_cast<float*>(smem + L::VEC) + st * 2 * VSTRIDE;
        const int v0 = (bh * Nq + t0) & ~3;
        hopper::tma_load_3d(qt, &tq, &full[st], 0, t0, bh);
        hopper::tma_load_3d(qt + L::TILE, &tg, &full[st], 0, t0, bh);
        hopper::tma_load_2d(vt, &tl, &full[st], v0, 0);
        hopper::tma_load_2d(vt + VSTRIDE, &tdelta, &full[st], v0, 0);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  hopper::regs_inc<224>();
  const int w = tid / 128, wt = tid % 128, lane = tid % 32;
  const int k0 = kb0 + w * BK;                          // this warpgroup's keys
  const int jA = k0 + hopper::acc_row(wt, 0), jB = k0 + hopper::acc_row(wt, 2);
  const bool tmplA = jA < n_mt, tmplB = jB < n_mt;
  const float sl2 = scale * hopper::LOG2E;             // exp(x) = 2^(x log2 e)
  const uint8_t* ks = smem + L::K + w * L::TILE;
  const uint8_t* vs = smem + L::V + w * L::TILE;
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  hopper::mbar_wait(kvbar, 0);
  for (int n = 0; n < ntiles; ++n) {
    const int st = n % STAGES, t0 = qstart + n * BQ;
    const uint8_t* qt = smem + L::RING + st * 2 * L::TILE;
    const uint8_t* gt = qt + L::TILE;
    const float* lt = reinterpret_cast<const float*>(smem + L::VEC) + st * 2 * VSTRIDE +
                      ((bh * Nq + t0) & 3);
    const float* dlt = lt + VSTRIDE;
    hopper::mbar_wait(&full[st], (n / STAGES) & 1);

    float sc[32], dp[32];                               // S^T, dP^T: rows keys, columns queries
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      hopper::wgmma_ss_n64(sc, hopper::desc<D>(ks + 32 * kk), hopper::desc<D>(qt + 32 * kk),
                           kk > 0);
      hopper::wgmma_ss_n64(dp, hopper::desc<D>(vs + 32 * kk), hopper::desc<D>(gt + 32 * kk),
                           kk > 0);
    }
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);

    if (t0 + BQ > Nq || (t0 < n_mt && k0 + BK > n_mt)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = t0 + hopper::acc_col(wt, j, e);
          if (i >= Nq || (i < n_mt && !(e < 2 ? tmplA : tmplB))) sc[4 * j + e] = hopper::NEG_INF;
        }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {                     // P^T, dS^T
        const int il = hopper::acc_col(wt, j, e);
        const float p = hopper::ex2(fmaf(sc[4 * j + e], sl2, -lt[il] * hopper::LOG2E));
        sc[4 * j + e] = p;
        dp[4 * j + e] = p * (dp[4 * j + e] - dlt[il]) * scale;
      }
    }
    uint32_t pa[4][4], da[4][4];
    hopper::acc_as_a<0>(pa[0], sc);
    hopper::acc_as_a<1>(pa[1], sc);
    hopper::acc_as_a<2>(pa[2], sc);
    hopper::acc_as_a<3>(pa[3], sc);
    hopper::acc_as_a<0>(da[0], dp);
    hopper::acc_as_a<1>(da[1], dp);
    hopper::acc_as_a<2>(da[2], dp);
    hopper::acc_as_a<3>(da[3], dp);
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hopper::wgmma_rs<D>(dva, pa[kk], hopper::desc<D>(gt + kk * 16 * 2 * D), 1);
      hopper::wgmma_rs<D>(dka, da[kk], hopper::desc<D>(qt + kk * 16 * 2 * D), 1);
    }
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::fence_regs(dva);
    hopper::fence_regs(dka);
    hopper::fence_regs(pa);
    hopper::fence_regs(da);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

  hopper::store_rows<D>(dk + (size_t)bh * Nk * D, dka, k0, Nk, wt);
  hopper::store_rows<D>(dv + (size_t)bh * Nk * D, dva, k0, Nk, wt);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* g, const float* lse,
           bf16* dq, bf16* dk, bf16* dv, float* delta, int BH, int Nq, int Nk, int n_mt,
           float scale, cudaStream_t s) {
  static bool smem_a[16] = {}, smem_b[16] = {};
  CUtensorMap tq, tk, tv, tg, tl, td;
  int err = hopper_host::map_rows(&tq, q, BH, Nq, D, 64);
  if (!err) err = hopper_host::map_rows(&tk, k, BH, Nk, D, 64);
  if (!err) err = hopper_host::map_rows(&tv, v, BH, Nk, D, 64);
  if (!err) err = hopper_host::map_rows(&tg, g, BH, Nq, D, 64);
  if (!err) err = hopper_host::map_vec(&tl, lse, (long long)BH * Nq, VLEN);
  if (!err) err = hopper_host::map_vec(&td, delta, (long long)BH * Nq, VLEN);
  if (!err) err = hopper_host::allow_smem(attn_bwd_dq_bf16_wgmma<D>, SmemA<D>::ALLOC, smem_a);
  if (!err) err = hopper_host::allow_smem(attn_bwd_dkdv_bf16_wgmma<D>, SmemB<D>::ALLOC, smem_b);
  if (err) return err;
  attn_bwd_dq_bf16_wgmma<D><<<dim3((Nq + BQ - 1) / BQ, BH), 160, SmemA<D>::ALLOC, s>>>(
      tq, tk, tv, tg, lse, dq, delta, Nq, Nk, n_mt, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  attn_bwd_dkdv_bf16_wgmma<D><<<dim3((Nk + 2 * BK - 1) / (2 * BK), BH), 384, SmemB<D>::ALLOC,
                                s>>>(tq, tk, tv, tg, tl, td, dk, dv, Nq, Nk, n_mt, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, g, dq: (BH, Nq, D); k, v, dk, dv: (BH, Nk, D); all bf16, contiguous,
// 16-byte aligned. lse: (BH, Nq) f32, the row logsumexp saved by K1-bf16;
// delta: (BH, Nq) f32 scratch; both 16-byte aligned. Launches kernel A then
// B on `stream`; returns the first launch or tensor-map error that is not 0
// (wgmma_bf16.cuh, hopper_host::ERR_*).
extern "C" int mixed_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* g, const void* lse, void* dq, void* dk,
                                        void* dv, void* delta, int BH, int Nq, int Nk, int D,
                                        int n_mt, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(lse);
  bf16* dqb = static_cast<bf16*>(dq);
  bf16* dkb = static_cast<bf16*>(dk);
  bf16* dvb = static_cast<bf16*>(dv);
  float* df = static_cast<float*>(delta);
  switch (D) {
    case 16: return launch<16>(q, k, v, g, lf, dqb, dkb, dvb, df, BH, Nq, Nk, n_mt, scale, s);
    case 32: return launch<32>(q, k, v, g, lf, dqb, dkb, dvb, df, BH, Nq, Nk, n_mt, scale, s);
    case 64: return launch<64>(q, k, v, g, lf, dqb, dkb, dvb, df, BH, Nq, Nk, n_mt, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
