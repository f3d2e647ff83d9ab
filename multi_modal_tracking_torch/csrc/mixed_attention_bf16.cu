// Mixed-attention forward in bf16 (K1-bf16) for Hopper (sm_90a): wgmma on
// the tensor cores, TMA loads into a shared-memory ring, split keys.
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
// kernel rounds exp(s - m_run) under the running max of its key share and
// divides by the f32 row sum l at the end. Both round each probability
// once, to the same relative precision (2^-9), so the outputs agree to
// about one bf16 unit; ops/attention.py `mixed_attention_bf16_ref` is the
// plain version with the Pallas rounding, which chip_smoke.py holds the
// kernel to, and tests/test_torch_port_attention_bf16_hopper.py models this
// kernel's own arithmetic (shares, running max, merge) against the Pallas
// kernel. exp(x) is taken as 2^(x log2 e) in one MUFU instruction
// (ex2.approx, relative error below 2^-21): an f32-level difference, like
// the order of the f32 sums. CUDA's accurate expf, and a branch around each
// masked element's exp, made the first build of this kernel no faster than
// the mma.sync one it replaces: the elementwise work, not the products,
// set its pace.
//
// What bounds it on the H100: at the tracking shapes (B*H = 24, Nq <= 324,
// Nk <= 580, D = 64) about 1 GFLOP per call against < 2 MB of bf16
// q/k/v/o; the bound is the bytes (0.0155 ms per tracked frame) but a call
// is too small to fill the card: 24 * ceil(Nq / 64) = 48 to 144 row tiles,
// each a serial chain over up to 10 key tiles.
//
// Design (wgmma_bf16.cuh): one block per (64 query rows, b*h) with S
// consumer warpgroups and one producer warp. The producer loads the Q tile
// once and streams 64-key tiles of K and V by TMA into a 2-stage ring per
// warpgroup. The block's key tiles are cut into S contiguous shares, one
// per warpgroup (S from ops/attention.py `attention_bf16_plan`: 2 or 3 at
// the tracking shapes, 1 where B*H * ceil(Nq / 64) blocks already fill the
// card). Per tile a warpgroup forms S = Q K^T (SS wgmma, both operands in
// shared memory), scales and masks it, runs the online softmax in the
// accumulator layout (row max and sum across the 4 lanes of a quad), packs
// P to bf16 A fragments in registers and adds P V into its O accumulator
// (RS wgmma, V read MN-major). Warpgroups 1..S-1 then hand (m, l, O)
// through shared memory to warpgroup 0, which rescales each share to the
// common max, sums them and rounds the output once: one launch, no scratch
// in device memory. O accumulates over the key tiles straight in the
// wgmma accumulator, with no per-tile partial sum (the mma.sync kernels
// needed one; this one's error against f32 stays at most the plain
// version's, PERF.md §6). Masked scores are the finite NEG_INF before the max and
// get probability exactly 0; a block whose rows are all template rows
// stops at key n_mt, and only tiles that cross n_mt or the ragged end test
// each element.
#include <cuda_bf16.h>
#include <math.h>

#include "wgmma_bf16.cuh"

namespace {

using hopper::bf16;
using hopper::NEG_INF;
constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // keys per tile
constexpr int STAGES = 2;     // ring depth per warpgroup

template <int D, int S>
struct Smem {
  static constexpr int TILE = BM * D * 2;                    // bytes of a 64 x D tile
  static constexpr int Q = 0;
  static constexpr int KV = TILE;                            // [S][STAGES][K, V]
  static constexpr int BARS = KV + S * STAGES * 2 * TILE;    // full[S][STAGES], empty[S][STAGES], q
  static constexpr int MERGE = BARS + ((2 * S * STAGES + 1) * 8 + 15) / 16 * 16;
  static constexpr int MERGE_FLOATS = D / 2 + 4;             // O, m0, m1, l0, l1 per thread
  static constexpr int BYTES = MERGE + (S - 1) * MERGE_FLOATS * 128 * 4;
  static constexpr int ALLOC = BYTES + 1024;                 // room to align the base
};

template <int D, int S>
__global__ void __launch_bounds__(128 * S + 32, S == 1 ? 2 : 1)
mixed_attention_fwd_bf16_wgmma(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                               float* __restrict__ lse, int Nq, int Nk, int n_mt, float scale) {
  using L = Smem<D, S>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  bf16* qs = reinterpret_cast<bf16*>(smem + L::Q);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + S * STAGES;
  uint64_t* qbar = empty + S * STAGES;
  auto ktile = [&](int s, int st) { return smem + L::KV + ((s * STAGES + st) * 2) * L::TILE; };

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int kend_t = min(n_mt, Nk);                     // a template row's key range
  const int kend_block = min(q0 + BM, Nq) - 1 < n_mt ? kend_t : Nk;
  const int ntiles = (kend_block + BN - 1) / BN;

  if (tid == 0) {
    for (int i = 0; i < S * STAGES; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 4);                  // one arrival per consumer warp
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128 * S) {
    // ---------------------------------------------------------- producer
    if (tid == 128 * S) {
      hopper::tma_prefetch(&tq);
      hopper::tma_prefetch(&tk);
      hopper::tma_prefetch(&tv);
      hopper::mbar_expect_tx(qbar, L::TILE);
      hopper::tma_load_3d(qs, &tq, qbar, 0, q0, bh);
      const int rounds = (ntiles + S - 1) / S;
      for (int r = 0; r < rounds; ++r) {
        for (int s = 0; s < S; ++s) {
          const int t0 = ntiles * s / S, t1 = ntiles * (s + 1) / S;
          if (t0 + r >= t1) continue;
          const int st = r % STAGES, i = s * STAGES + st;
          hopper::mbar_wait(&empty[i], ((r / STAGES) & 1) ^ 1);
          hopper::mbar_expect_tx(&full[i], 2 * L::TILE);
          hopper::tma_load_3d(ktile(s, st), &tk, &full[i], 0, (t0 + r) * BN, bh);
          hopper::tma_load_3d(ktile(s, st) + L::TILE, &tv, &full[i], 0, (t0 + r) * BN, bh);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int s = tid / 128, wt = tid % 128, lane = tid % 32;
  const int iA = q0 + hopper::acc_row(wt, 0), iB = q0 + hopper::acc_row(wt, 2);
  const int kendA = iA < n_mt ? kend_t : Nk, kendB = iB < n_mt ? kend_t : Nk;
  const int t0 = ntiles * s / S, t1 = ntiles * (s + 1) / S;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float mA = NEG_INF, mB = NEG_INF, lA = 0.f, lB = 0.f;   // l: this lane's part

  hopper::mbar_wait(qbar, 0);
  for (int r = 0; r < t1 - t0; ++r) {
    const int st = r % STAGES, i = s * STAGES + st;
    const int k0 = (t0 + r) * BN;
    const uint8_t* kt = ktile(s, st);
    hopper::mbar_wait(&full[i], (r / STAGES) & 1);

    float sc[32];
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss_n64(sc, hopper::desc<D>(reinterpret_cast<const uint8_t*>(qs) + 32 * kk),
                           hopper::desc<D>(kt + 32 * kk), kk > 0);
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::fence_regs(sc);

    // scale; on a tile that crosses n_mt or the ragged end, masked scores
    // become NEG_INF (each element tested only there)
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] *= scale;
    if (k0 + BN > Nk || (q0 < n_mt && k0 + BN > kend_t)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + hopper::acc_col(wt, j, e) >= (e < 2 ? kendA : kendB)) sc[4 * j + e] = NEG_INF;
    }
    float cmA = NEG_INF, cmB = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      cmA = fmaxf(cmA, fmaxf(sc[4 * j], sc[4 * j + 1]));
      cmB = fmaxf(cmB, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    cmA = hopper::quad_max(cmA);
    cmB = hopper::quad_max(cmB);
    const float mA_new = fmaxf(mA, cmA), mB_new = fmaxf(mB, cmB);
    const float cA = hopper::ex2((mA - mA_new) * hopper::LOG2E);
    const float cB = hopper::ex2((mB - mB_new) * hopper::LOG2E);
    mA = mA_new;
    mB = mB_new;
    lA *= cA;
    lB *= cB;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= cA; acc[4 * j + 1] *= cA; acc[4 * j + 2] *= cB; acc[4 * j + 3] *= cB;
    }
    // exp(x - m) as 2^(x log2 e - m log2 e); a row with no allowed key yet
    // (m = NEG_INF) takes offset 0, so its NEG_INF scores still give 0
    const float oA = mA == NEG_INF ? 0.f : mA * hopper::LOG2E;
    const float oB = mB == NEG_INF ? 0.f : mB * hopper::LOG2E;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[4 * j] = hopper::ex2(fmaf(sc[4 * j], hopper::LOG2E, -oA));
      sc[4 * j + 1] = hopper::ex2(fmaf(sc[4 * j + 1], hopper::LOG2E, -oA));
      sc[4 * j + 2] = hopper::ex2(fmaf(sc[4 * j + 2], hopper::LOG2E, -oB));
      sc[4 * j + 3] = hopper::ex2(fmaf(sc[4 * j + 3], hopper::LOG2E, -oB));
      lA += sc[4 * j] + sc[4 * j + 1];
      lB += sc[4 * j + 2] + sc[4 * j + 3];
    }
    uint32_t pa[4][4];
    hopper::acc_as_a<0>(pa[0], sc);
    hopper::acc_as_a<1>(pa[1], sc);
    hopper::acc_as_a<2>(pa[2], sc);
    hopper::acc_as_a<3>(pa[3], sc);

    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_rs<D>(acc, pa[kk], hopper::desc<D>(kt + L::TILE + kk * 16 * 2 * D), 1);
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(pa);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[i]);
  }
  lA = hopper::quad_sum(lA);
  lB = hopper::quad_sum(lB);

  if constexpr (S > 1) {
    // warpgroups 1..S-1 hand (O, m, l) to warpgroup 0 through shared memory,
    // laid out [value][thread] so a warp's accesses hit 32 banks
    float* mg = reinterpret_cast<float*>(smem + L::MERGE);
    if (s > 0) {
      float* mine = mg + (s - 1) * L::MERGE_FLOATS * 128;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) mine[i * 128 + wt] = acc[i];
      mine[(D / 2 + 0) * 128 + wt] = mA;
      mine[(D / 2 + 1) * 128 + wt] = mB;
      mine[(D / 2 + 2) * 128 + wt] = lA;
      mine[(D / 2 + 3) * 128 + wt] = lB;
    }
    hopper::bar_sync(1, 128 * S);
    if (s > 0) return;
    float MA = mA, MB = mB;
#pragma unroll
    for (int p = 1; p < S; ++p) {
      const float* other = mg + (p - 1) * L::MERGE_FLOATS * 128;
      MA = fmaxf(MA, other[(D / 2 + 0) * 128 + wt]);
      MB = fmaxf(MB, other[(D / 2 + 1) * 128 + wt]);
    }
    float cA = hopper::ex2((mA - MA) * hopper::LOG2E), cB = hopper::ex2((mB - MB) * hopper::LOG2E);
    lA *= cA;
    lB *= cB;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= cA; acc[4 * j + 1] *= cA; acc[4 * j + 2] *= cB; acc[4 * j + 3] *= cB;
    }
#pragma unroll
    for (int p = 1; p < S; ++p) {
      const float* other = mg + (p - 1) * L::MERGE_FLOATS * 128;
      cA = hopper::ex2((other[(D / 2 + 0) * 128 + wt] - MA) * hopper::LOG2E);
      cB = hopper::ex2((other[(D / 2 + 1) * 128 + wt] - MB) * hopper::LOG2E);
      lA = fmaf(other[(D / 2 + 2) * 128 + wt], cA, lA);
      lB = fmaf(other[(D / 2 + 3) * 128 + wt], cB, lB);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] = fmaf(other[(4 * j) * 128 + wt], cA, acc[4 * j]);
        acc[4 * j + 1] = fmaf(other[(4 * j + 1) * 128 + wt], cA, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(other[(4 * j + 2) * 128 + wt], cB, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(other[(4 * j + 3) * 128 + wt], cB, acc[4 * j + 3]);
      }
    }
    mA = MA;
    mB = MB;
  }

  if (lse != nullptr && wt % 4 == 0) {
    if (iA < Nq) lse[(size_t)bh * Nq + iA] = mA + logf(lA);
    if (iB < Nq) lse[(size_t)bh * Nq + iB] = mB + logf(lB);
  }
  hopper::store_rows<D>(o + (size_t)bh * Nq * D, acc, q0, Nq, wt, 1.f / lA, 1.f / lB);
}

template <int D, int S>
int launch(const void* q, const void* k, const void* v, bf16* o, float* lse, int BH, int Nq,
           int Nk, int n_mt, float scale, cudaStream_t stream) {
  static bool smem_set[16] = {};
  using L = Smem<D, S>;
  CUtensorMap tq, tk, tv;
  int err = hopper_host::map_rows(&tq, q, BH, Nq, D, BM);
  if (!err) err = hopper_host::map_rows(&tk, k, BH, Nk, D, BN);
  if (!err) err = hopper_host::map_rows(&tv, v, BH, Nk, D, BN);
  if (!err) err = hopper_host::allow_smem(mixed_attention_fwd_bf16_wgmma<D, S>, L::ALLOC, smem_set);
  if (err) return err;
  mixed_attention_fwd_bf16_wgmma<D, S><<<dim3((Nq + BM - 1) / BM, BH), 128 * S + 32, L::ALLOC,
                                         stream>>>(tq, tk, tv, o, lse, Nq, Nk, n_mt, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_split(int splits, const void* q, const void* k, const void* v, bf16* o, float* lse,
                 int BH, int Nq, int Nk, int n_mt, float scale, cudaStream_t s) {
  switch (splits) {
    case 1: return launch<D, 1>(q, k, v, o, lse, BH, Nq, Nk, n_mt, scale, s);
    case 2: return launch<D, 2>(q, k, v, o, lse, BH, Nq, Nk, n_mt, scale, s);
    case 3: return launch<D, 3>(q, k, v, o, lse, BH, Nq, Nk, n_mt, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (BH, Nq, D), k/v: (BH, Nk, D), o: (BH, Nq, D); all bf16, contiguous,
// 16-byte aligned. lse: (BH, Nq) f32, or null to skip it. splits (1 to 3,
// ops/attention.py attention_bf16_plan) is the number of key shares, one
// consumer warpgroup each, per block of 64 query rows. Returns
// cudaGetLastError() after the launch, or a tensor-map error
// (wgmma_bf16.cuh, hopper_host::ERR_*).
extern "C" int mixed_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int BH, int Nq, int Nk, int D, int n_mt,
                                        float scale, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* ob = static_cast<bf16*>(o);
  float* lf = static_cast<float*>(lse);
  switch (D) {
    case 16: return launch_split<16>(splits, q, k, v, ob, lf, BH, Nq, Nk, n_mt, scale, s);
    case 32: return launch_split<32>(splits, q, k, v, ob, lf, BH, Nq, Nk, n_mt, scale, s);
    case 64: return launch_split<64>(splits, q, k, v, ob, lf, BH, Nq, Nk, n_mt, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
