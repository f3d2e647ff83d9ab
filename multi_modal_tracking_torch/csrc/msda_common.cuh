// Helpers shared by the MSDA kernels K3 (msda.cu) and K4 (msda_bwd.cu).
//
// The corner arithmetic lives here once, so the forward and the backward
// cannot drift apart: a sampling point (lx, ly) in [0, 1] of a level of
// H x W pixels sits at pixel coordinate x = lx * W - 0.5, y = ly * H - 0.5
// (grid_sample with align_corners=False), with loc * W rounded on its own
// (__fmul_rn, never contracted into an FMA) so the floor below sees the
// same coordinate as the plain version's `_corners`. Its four corners, in
// the order (x0, y0), (x0+1, y0), (x0, y0+1), (x0+1, y0+1), carry the
// bilinear weights (1-fx)(1-fy), fx(1-fy), (1-fx)fy, fx fy; a corner
// outside the map is dead (zero padding) and is skipped by every kernel.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace msda {

constexpr int MAX_LEVELS = 8;
// dynamic shared memory a block may use on the H100 (227 KB), after
// cudaFuncSetAttribute; ops/msda.py msda_plan holds the same number
constexpr int SMEM_MAX = 232448;

struct Levels {
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int start[MAX_LEVELS];
};

// the levels of a (B, S, M, D) value tensor; false if they do not cover S
inline bool make_levels(const int* shapes, int L, int S, Levels& lv) {
  if (L < 1 || L > MAX_LEVELS) return false;
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = shapes[2 * l];
    lv.w[l] = shapes[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  return start == S;
}

// a sampling point: its top-left corner and fractional offsets
struct Tap {
  int x0, y0;
  float fx, fy;
};

__device__ __forceinline__ Tap make_tap(float lx, float ly, int H, int W) {
  const float x = __fmul_rn(lx, (float)W) - 0.5f;
  const float y = __fmul_rn(ly, (float)H) - 0.5f;
  const float x0f = floorf(x), y0f = floorf(y);
  return {(int)x0f, (int)y0f, x - x0f, y - y0f};
}

// corner c (0..3) of the tap: its pixel index y * W + x in the level, and
// whether it lies inside the map
__device__ __forceinline__ bool corner_pixel(const Tap& t, int c, int H, int W, int& pix) {
  const int xi = t.x0 + (c & 1), yi = t.y0 + (c >> 1);
  pix = yi * W + xi;
  return xi >= 0 && xi < W && yi >= 0 && yi < H;
}

__device__ __forceinline__ float corner_weight(const Tap& t, int c) {
  return ((c & 1) ? t.fx : 1.f - t.fx) * ((c & 2) ? t.fy : 1.f - t.fy);
}

// corner c's terms of (d/dfx, d/dfy) of sum_c d_c * w_c, with d_c =
// attw * dw_c: summed over the four corners they give
//   dfx = -(1-fy) d0 + (1-fy) d1 - fy d2 + fy d3
//   dfy = -(1-fx) d0 - fx d1 + (1-fx) d2 + fx d3
// and dLoc = (dfx * W, dfy * H)
__device__ __forceinline__ void corner_dloc(const Tap& t, int c, float d, float& dfx,
                                            float& dfy) {
  const float wy = (c & 2) ? t.fy : 1.f - t.fy;
  const float wx = (c & 1) ? t.fx : 1.f - t.fx;
  dfx = (c & 1) ? wy * d : -(wy * d);
  dfy = (c & 2) ? wx * d : -(wx * d);
}

// cp.async of one 16-byte or 4-byte chunk from device to shared memory
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// rows [s0, s0 + n) of value[b, :, m, :] (row stride M * D floats, each row
// D contiguous floats) into smem as a dense (n, D) matrix, by all threads
// of the block; 16-byte chunks when D is a multiple of 4 (the wrapper
// requires 16-byte aligned tensors). Completes with cp_async_wait_all().
__device__ __forceinline__ void stage_slice(float* smem, const float* vrow0, int n, int D,
                                            int stride, int tid, int threads) {
  if (D % 4 == 0) {
    const int C = D / 4;
    for (int x = tid; x < n * C; x += threads) {
      const int r = x / C, c = x - r * C;
      cp_async16(smem + r * D + 4 * c, vrow0 + (size_t)r * stride + 4 * c);
    }
  } else {
    for (int x = tid; x < n * D; x += threads) {
      const int r = x / D, c = x - r * D;
      cp_async4(smem + x, vrow0 + (size_t)r * stride + c);
    }
  }
}

}  // namespace msda
