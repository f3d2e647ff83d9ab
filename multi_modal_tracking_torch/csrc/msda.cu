// Multi-scale deformable attention forward (K3) for Hopper (sm_90a), f32.
//
// Replaces the Pallas kernel `_msda_kernel`, launched by `_msda_pallas_fwd`
// in multi_modal_tracking_tpu/ops/msda.py. For every (batch, query, head):
//
//     out[b, q, m, :] = sum_l sum_p attw[b,q,m,l,p] * bilinear(V_l[b, :, m, :],
//                          x = loc_x * W_l - 0.5, y = loc_y * H_l - 0.5)
//
// with zero padding outside each level's map: the numerics of
// grid_sample(align_corners=False, padding_mode='zeros').
//
// What bounds it on the H100: it reads value (B, S, M, D), loc and attw once
// and writes (B, Lq, M*D); each output costs L*P*4 gathered rows of D floats
// and ~2 FLOP per gathered float, so it is a gather bound by memory traffic
// (mostly L2 hits: the tracking value tensor is 1.3 MB).
//
// Design: a direct gather in the shape of the reference's
// ms_deform_im2col_cuda.cuh, not the TPU's dense one-hot interpolation
// matrix (the TPU built A (S_l, Lq) per head only because it gathers
// badly). One warp per (b, q, m); the D channels lie across the lanes, so
// each corner fetch is one coalesced row read of D floats. The warp walks
// L x P sampling points x 4 corners, tests each corner's validity on its
// own (zero padding) and accumulates in f32 registers. No level-size bound
// applies: nothing is staged per level.
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

__device__ __forceinline__ void tap(const float* __restrict__ vrow_base, int xi, int yi,
                                    int H, int W, int stride_s, float wgt, int lane, int D,
                                    float acc[MAX_CPL]) {
  if (xi < 0 || xi >= W || yi < 0 || yi >= H) return;
  const float* row = vrow_base + (size_t)(yi * W + xi) * stride_s;
#pragma unroll
  for (int r = 0; r < MAX_CPL; ++r) {
    const int c = lane + 32 * r;
    if (c < D) acc[r] = fmaf(wgt, __ldg(row + c), acc[r]);
  }
}

__global__ void __launch_bounds__(WARPS * 32)
msda_fwd_kernel(const float* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ attw, float* __restrict__ out,
                int B, int S, int M, int D, int Lq, int L, int P, Levels lv) {
  const int warp = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= B * Lq * M) return;
  const int m = warp % M;
  const int bq = warp / M;              // b * Lq + q
  const int b = bq / Lq;

  const int stride_s = M * D;           // value row stride per source position
  const float* vb = value + (size_t)b * S * stride_s + (size_t)m * D;
  const float* locp = loc + (size_t)warp * L * P * 2;
  const float* awp = attw + (size_t)warp * L * P;

  float acc[MAX_CPL];
#pragma unroll
  for (int r = 0; r < MAX_CPL; ++r) acc[r] = 0.f;

  for (int l = 0; l < L; ++l) {
    const int H = lv.h[l], W = lv.w[l];
    const float* vl = vb + (size_t)lv.start[l] * stride_s;
    for (int p = 0; p < P; ++p) {
      const int t = l * P + p;
      // __fmul_rn keeps loc * W a separately rounded product, as in the
      // plain version, so the floor below sees the same coordinate
      const float x = __fmul_rn(__ldg(locp + 2 * t), (float)W) - 0.5f;
      const float y = __fmul_rn(__ldg(locp + 2 * t + 1), (float)H) - 0.5f;
      const float aw = __ldg(awp + t);
      const float x0f = floorf(x), y0f = floorf(y);
      const float fx = x - x0f, fy = y - y0f;
      const int x0 = (int)x0f, y0 = (int)y0f;
      tap(vl, x0, y0, H, W, stride_s, aw * ((1.f - fx) * (1.f - fy)), lane, D, acc);
      tap(vl, x0 + 1, y0, H, W, stride_s, aw * (fx * (1.f - fy)), lane, D, acc);
      tap(vl, x0, y0 + 1, H, W, stride_s, aw * ((1.f - fx) * fy), lane, D, acc);
      tap(vl, x0 + 1, y0 + 1, H, W, stride_s, aw * (fx * fy), lane, D, acc);
    }
  }

  float* op = out + (size_t)warp * D;   // (B, Lq, M, D) == (B, Lq, M*D)
#pragma unroll
  for (int r = 0; r < MAX_CPL; ++r) {
    const int c = lane + 32 * r;
    if (c < D) op[c] = acc[r];
  }
}

}  // namespace

// value (B, S, M, D), loc (B, Lq, M, L, P, 2), attw (B, Lq, M, L, P),
// out (B, Lq, M*D), all f32 and contiguous. shapes: host array of L (H, W)
// pairs. Returns cudaGetLastError() after the launch.
extern "C" int msda_fwd_f32(const void* value, const void* loc, const void* attw,
                            void* out, int B, int S, int M, int D, int Lq, int L,
                            int P, const int* shapes, void* stream) {
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
  msda_fwd_kernel<<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attw), static_cast<float*>(out),
      B, S, M, D, Lq, L, P, lv);
  return static_cast<int>(cudaGetLastError());
}
