// Mixed-attention forward (K1) for Hopper (sm_90a), f32, CUDA cores.
//
// Replaces the Pallas kernel `_attn_kernel`, launched by
// `_mixed_attention_fwd_pallas` in multi_modal_tracking_tpu/ops/attention.py.
// It computes, per (batch, head),
//
//     O = softmax(mask(Q K^T * scale)) V,
//     allowed(i, j) = (i >= n_mt) || (j < n_mt),
//
// for q (BH, Nq, D) and k/v (BH, Nk, D), Nq != Nk allowed: template rows
// (i < n_mt) see only the template keys, search rows see every key.
//
// What bounds it on the H100: at the tracking shapes (B*H = 24, Nq <= 452,
// Nk <= 580, D = 64) the work is ~1-2 GFLOP against < 4 MB of q/k/v/o, so
// it is bound by arithmetic, and in this simple version by how fast
// CUDA-core FMAs can be fed from shared memory (tensor cores come later).
//
// Design: flash style. One block per (64-query tile, batch*head); the TPU
// kernel held the whole (Nq, Nk) score matrix in VMEM, here a loop walks
// 64-key tiles staged in shared memory and keeps a running max and sum per
// query row (online softmax, f32), so nothing of size Nq x Nk exists. Four
// threads share a query row, each holding D/4 of its channels in registers
// (interleaved in float4 chunks so the four threads hit distinct banks);
// a dot product is finished with two warp shuffles. A tile whose rows are
// all template rows stops at key n_mt. Masked keys contribute exactly zero
// probability and the running max starts at the finite NEG_INF of the JAX
// code, so a fully masked chunk rescales by exp(0) and never makes a NaN.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TQ = 64;         // query rows per block
constexpr int TK = 64;         // keys per shared-memory tile
constexpr int TPR = 4;         // threads per query row
constexpr int KC = 16;         // keys per online-softmax chunk
constexpr int THREADS = TQ * TPR;
constexpr float NEG_INF = -1e30f;

template <int D>
__global__ void __launch_bounds__(THREADS)
mixed_attention_fwd_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ o,
                           int Nq, int Nk, int n_mt, float scale) {
  constexpr int D4 = D / 4;            // float4 per row
  constexpr int C4 = D4 / TPR;         // float4 chunks per thread
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

  const float4* qg = reinterpret_cast<const float4*>(q) + (size_t)bh * Nq * D4;
  const float4* kg = reinterpret_cast<const float4*>(k) + (size_t)bh * Nk * D4;
  const float4* vg = reinterpret_cast<const float4*>(v) + (size_t)bh * Nk * D4;

  float4 qr[C4], acc[C4];
#pragma unroll
  for (int c = 0; c < C4; ++c) {
    qr[c] = row_valid ? qg[(size_t)i * D4 + c * TPR + part]
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int last_row = min(q0 + TQ, Nq) - 1;
  const int kend_block = (last_row < n_mt) ? min(n_mt, Nk) : Nk;
  const int kend_row = (i < n_mt) ? min(n_mt, Nk) : Nk;
  float m = NEG_INF;
  float l = 0.f;

  for (int k0 = 0; k0 < kend_block; k0 += TK) {
    const int nk = min(TK, kend_block - k0);
    __syncthreads();
    for (int x = tid; x < nk * D4; x += THREADS) {
      ks[x] = kg[(size_t)k0 * D4 + x];
      vs[x] = vg[(size_t)k0 * D4 + x];
    }
    __syncthreads();

    for (int c0 = 0; c0 < nk; c0 += KC) {
      float s[KC];
      unsigned ok = 0u;
      float cmax = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        const int j = c0 + jj;
        s[jj] = NEG_INF;
        if (j < nk) {                  // block-uniform: shuffles stay converged
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < C4; ++c) {
            const float4 kk = ks[j * D4 + c * TPR + part];
            dot = fmaf(qr[c].x, kk.x, dot);
            dot = fmaf(qr[c].y, kk.y, dot);
            dot = fmaf(qr[c].z, kk.z, dot);
            dot = fmaf(qr[c].w, kk.w, dot);
          }
          dot += __shfl_xor_sync(0xffffffffu, dot, 1);
          dot += __shfl_xor_sync(0xffffffffu, dot, 2);
          if (k0 + j < kend_row) {
            s[jj] = dot * scale;
            ok |= 1u << jj;
            cmax = fmaxf(cmax, s[jj]);
          }
        }
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      m = m_new;
      l *= corr;
#pragma unroll
      for (int c = 0; c < C4; ++c) {
        acc[c].x *= corr; acc[c].y *= corr; acc[c].z *= corr; acc[c].w *= corr;
      }
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        const int j = c0 + jj;
        if (j < nk) {
          const float p = ((ok >> jj) & 1u) ? expf(s[jj] - m_new) : 0.f;
          l += p;
#pragma unroll
          for (int c = 0; c < C4; ++c) {
            const float4 vv = vs[j * D4 + c * TPR + part];
            acc[c].x = fmaf(p, vv.x, acc[c].x);
            acc[c].y = fmaf(p, vv.y, acc[c].y);
            acc[c].z = fmaf(p, vv.z, acc[c].z);
            acc[c].w = fmaf(p, vv.w, acc[c].w);
          }
        }
      }
    }
  }

  if (row_valid) {
    const float inv = 1.f / l;
    float4* og = reinterpret_cast<float4*>(o) + (size_t)bh * Nq * D4;
#pragma unroll
    for (int c = 0; c < C4; ++c) {
      og[(size_t)i * D4 + c * TPR + part] =
          make_float4(acc[c].x * inv, acc[c].y * inv, acc[c].z * inv, acc[c].w * inv);
    }
  }
}

}  // namespace

// q: (BH, Nq, D), k/v: (BH, Nk, D), o: (BH, Nq, D), all f32, contiguous,
// 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int mixed_attention_fwd_f32(const void* q, const void* k, const void* v,
                                       void* o, int BH, int Nq, int Nk, int D,
                                       int n_mt, float scale, void* stream) {
  const dim3 grid((Nq + TQ - 1) / TQ, BH);
  const dim3 block(THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  switch (D) {
    case 16: mixed_attention_fwd_kernel<16><<<grid, block, 0, s>>>(qf, kf, vf, of, Nq, Nk, n_mt, scale); break;
    case 32: mixed_attention_fwd_kernel<32><<<grid, block, 0, s>>>(qf, kf, vf, of, Nq, Nk, n_mt, scale); break;
    case 64: mixed_attention_fwd_kernel<64><<<grid, block, 0, s>>>(qf, kf, vf, of, Nq, Nk, n_mt, scale); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
