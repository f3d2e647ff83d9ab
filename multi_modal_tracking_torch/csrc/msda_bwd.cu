// Multi-scale deformable attention backward (K4) for Hopper (sm_90a), f32.
//
// Replaces the Pallas kernel `_msda_bwd_kernel`, launched by
// `_msda_pallas_bwd` in multi_modal_tracking_tpu/ops/msda.py, and the
// elementwise chain that follows it there (ops/msda.py:393-418). With the
// forward out[b,q,m,:] = sum_{l,p,c} attw * w_c * V_l[b, corner_c, m, :]
// (w_c the bilinear weight of corner c, zero padding outside the map) and
// its incoming gradient g (B, Lq, M*D):
//
//     dValue[b, corner_c, m, :] += attw * w_c * g[b, q, m, :]
//     dw_c  = <g[b, q, m, :], V_l[b, corner_c, m, :]>        (live corners)
//     dAttw = sum_c w_c * dw_c
//     dLoc  = (d/dfx, d/dfy) of sum_c attw * w_c * dw_c, times (W_l, H_l)
//
// What bounds it on the H100: it reads value, loc, attw and g once and
// writes dValue, dLoc and dAttw; each (b, q, m) touches L*P*4 rows of D
// floats twice (a gather for dw and an atomic add into dValue), ~4 FLOP
// per touched float, so it is bound by memory traffic (mostly L2: the
// training value tensor is 21 MB) and by the atomics' throughput.
//
// Design: K3's layout. One warp per (b, q, m), the D channels across the
// lanes, so every corner row is one coalesced 256-byte read and one
// coalesced run of atomicAdds. Corner weights are recomputed with K3's
// rounding (__fmul_rn(loc, W) - 0.5), a dead corner is skipped entirely,
// dw is a warp reduction, and the chain to dAttw and dLoc runs in the
// kernel (lane 0 writes). The TPU kernel built a dense one-hot matrix A
// and formed A^T g by a matmul; a GPU scatters well, so the atomics do it.
// dValue must be zeroed before the launch; the atomics make its summation
// order vary from run to run.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int MAX_CPL = 4;            // channels per lane: D <= 128
constexpr int WARPS = 8;

struct Levels {
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int start[MAX_LEVELS];
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(WARPS * 32)
msda_bwd_kernel(const float* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ attw, const float* __restrict__ grad,
                float* __restrict__ dvalue, float* __restrict__ dloc,
                float* __restrict__ dattw, int B, int S, int M, int D, int Lq, int L,
                int P, Levels lv) {
  const int warp = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= B * Lq * M) return;       // warp-uniform
  const int m = warp % M;
  const int b = warp / M / Lq;

  const int stride_s = M * D;
  const size_t vbase = (size_t)b * S * stride_s + (size_t)m * D;
  const float* locp = loc + (size_t)warp * L * P * 2;
  const float* awp = attw + (size_t)warp * L * P;
  const float* gp = grad + (size_t)warp * D;  // (B, Lq, M, D) == (B, Lq, M*D)

  float gr[MAX_CPL];
#pragma unroll
  for (int r = 0; r < MAX_CPL; ++r) {
    const int c = lane + 32 * r;
    gr[r] = c < D ? __ldg(gp + c) : 0.f;
  }

  for (int l = 0; l < L; ++l) {
    const int H = lv.h[l], W = lv.w[l];
    const size_t lbase = vbase + (size_t)lv.start[l] * stride_s;
    for (int p = 0; p < P; ++p) {
      const int t = l * P + p;
      const float x = __fmul_rn(__ldg(locp + 2 * t), (float)W) - 0.5f;
      const float y = __fmul_rn(__ldg(locp + 2 * t + 1), (float)H) - 0.5f;
      const float aw = __ldg(awp + t);
      const float x0f = floorf(x), y0f = floorf(y);
      const float fx = x - x0f, fy = y - y0f;
      const int x0 = (int)x0f, y0 = (int)y0f;
      const float wc[4] = {(1.f - fx) * (1.f - fy), fx * (1.f - fy),
                           (1.f - fx) * fy, fx * fy};
      float dw[4];
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        const int xi = x0 + (c4 & 1), yi = y0 + (c4 >> 1);
        dw[c4] = 0.f;
        if (xi < 0 || xi >= W || yi < 0 || yi >= H) continue;   // warp-uniform
        const size_t row = lbase + (size_t)(yi * W + xi) * stride_s;
        const float wgt = aw * wc[c4];
        float part = 0.f;
#pragma unroll
        for (int r = 0; r < MAX_CPL; ++r) {
          const int c = lane + 32 * r;
          if (c < D) {
            part = fmaf(gr[r], __ldg(value + row + c), part);
            atomicAdd(dvalue + row + c, wgt * gr[r]);
          }
        }
        dw[c4] = warp_sum(part);
      }
      if (lane == 0) {
        float daw = 0.f;
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) daw = fmaf(wc[c4], dw[c4], daw);
        const float d0 = aw * dw[0], d1 = aw * dw[1], d2 = aw * dw[2], d3 = aw * dw[3];
        const float dfx = -(1.f - fy) * d0 + (1.f - fy) * d1 - fy * d2 + fy * d3;
        const float dfy = -(1.f - fx) * d0 - fx * d1 + (1.f - fx) * d2 + fx * d3;
        dattw[(size_t)warp * L * P + t] = daw;
        dloc[((size_t)warp * L * P + t) * 2] = dfx * (float)W;
        dloc[((size_t)warp * L * P + t) * 2 + 1] = dfy * (float)H;
      }
    }
  }
}

}  // namespace

// value (B, S, M, D), loc (B, Lq, M, L, P, 2), attw (B, Lq, M, L, P),
// grad (B, Lq, M*D); outputs dvalue (B, S, M, D) (zeroed by the caller),
// dloc and dattw shaped like loc and attw. All f32 and contiguous. shapes:
// host array of L (H, W) pairs. Returns cudaGetLastError() after the launch.
extern "C" int msda_bwd_f32(const void* value, const void* loc, const void* attw,
                            const void* grad, void* dvalue, void* dloc, void* dattw,
                            int B, int S, int M, int D, int Lq, int L, int P,
                            const int* shapes, void* stream) {
  if (L < 1 || L > MAX_LEVELS || D < 1 || D > 32 * MAX_CPL)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = shapes[2 * l];
    lv.w[l] = shapes[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  if (start != S) return static_cast<int>(cudaErrorInvalidValue);
  const long long warps = (long long)B * Lq * M;
  const dim3 grid((unsigned)((warps + WARPS - 1) / WARPS));
  msda_bwd_kernel<<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attw), static_cast<const float*>(grad),
      static_cast<float*>(dvalue), static_cast<float*>(dloc), static_cast<float*>(dattw),
      B, S, M, D, Lq, L, P, lv);
  return static_cast<int>(cudaGetLastError());
}
