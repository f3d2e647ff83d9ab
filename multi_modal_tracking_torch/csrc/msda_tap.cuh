// The tap matrix of the bf16 MSDA kernels K3-bf16 (msda.cu) and K4-bf16
// (msda_bwd.cu), built in shared memory for the tensor cores.
//
// The Pallas kernels (multi_modal_tracking_tpu/ops/msda.py `_msda_kernel`,
// `_msda_bwd_kernel`) at acc_dtype bf16 form, per (batch, head, level), a
// dense tap matrix A (queries x pixels): entry A[q, s] is the f32 sum, in
// tap order (point-major, then corner), of the bf16-rounded weights
// attw * w_c of query q's live taps on pixel s, rounded to bf16 once. Then
// out = sum_l A_l V_l and dV_l = A_l^T g on the matrix unit. These kernels
// build A a tile of 64 query rows at a time:
//
// * One thread per point: a row's P points (2 or 4) sit in consecutive
//   lanes, each lane computing its point's four corners (tap t = 4p + c).
//   Only corners of two different points can fall on one pixel, and only
//   if the points' top-left corners lie within a pixel of each other. The
//   lanes trade corners and rounded weights by shuffles; the first live
//   tap on a pixel sums the rounded weights of the taps on it in tap order
//   (adding an exact zero for each other tap), rounds the sum to bf16 and
//   writes it once: the Pallas kernel's rounding points exactly. Where no
//   two points of any row of the warp meet (uniform locations, mostly), the
//   trade is skipped. A dead corner (outside the map) writes nothing, as
//   the Pallas kernel's index -1 matches no pixel.
// * The tile is zeroed once. A row's entries are only written by its
//   lanes, which put zeros back where they wrote (a warp barrier between)
//   before they write the next tile's row.
// * Layout: column blocks of 64 pixels, each a 64-row x 64-column bf16 tile
//   of 128-byte rows in the 128-byte swizzle on a 1024-byte boundary, so
//   `hopper::desc<64>` (wgmma_bf16.cuh) reads it. As the wgmma A operand it
//   is K-major for out = A V (a 16-pixel slice starts 32 bytes further into
//   the rows) and MN-major for dV = A^T g (a 16-query slice starts 16 rows
//   further on). Value rows (pixels x 64 channels) and the incoming
//   gradient (queries x 64 channels) sit in the same swizzle.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

#include "msda_common.cuh"
#include "wgmma_bf16.cuh"

namespace msda_tap {

using bf16 = __nv_bfloat16;
constexpr int D = 64;               // channels of a head: one 128-byte row
constexpr int ROWS = 64;            // query rows of a tile (wgmma m64)
constexpr int TILE_BYTES = 8192;    // a 64 x 64 bf16 tile: one column block of A
constexpr unsigned FULL = 0xffffffffu;

// byte offset of element (r, c) of a tile of 128-byte rows in the 128-byte
// swizzle: 16-byte chunk c / 8 of row r sits at chunk (c / 8) ^ (r % 8)
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// byte offset of A[row][pix] in a tap tile of column blocks
__device__ __forceinline__ int a_offset(int row, int pix) {
  return (pix >> 6) * TILE_BYTES + swz(row, pix & 63);
}

// rows [0, n) of a (rows, 64) bf16 matrix in device memory (row stride
// `stride` elements, 16-byte aligned) into a swizzled tile, by all threads
__device__ __forceinline__ void stage_rows(uint8_t* dst, const bf16* src, int n, size_t stride,
                                           int tid, int threads) {
  for (int x = tid; x < n * 8; x += threads) {
    const int r = x >> 3, k = x & 7;
    msda::cp_async16(dst + r * 128 + (((k ^ r) & 7) << 4), src + (size_t)r * stride + 8 * k);
  }
}

// n bytes (a multiple of 16) of shared memory set to zero, by all threads
__device__ __forceinline__ void zero_bytes(uint8_t* dst, int n, int tid, int threads) {
  for (int x = tid * 16; x < n; x += threads * 16)
    *reinterpret_cast<uint4*>(dst + x) = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// read-only loads that stay where they are written (asm volatile): a
// tile's points are loaded a tile ahead, and the compiler would otherwise
// sink the loads to their first use and wait for them there
__device__ __forceinline__ float2 ldg_f2(const void* p) {
  float2 v;
  asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "l"(p));
  return v;
}
__device__ __forceinline__ float ldg_bf16(const void* p) {
  unsigned short v;
  asm volatile("ld.global.nc.u16 %0, [%1];" : "=h"(v) : "l"(p));
  return __uint_as_float((uint32_t)v << 16);
}

// one sampling point: location and attention weight
struct Point {
  float x, y, a;
};

// point `idx` (an index into attw; loc holds its (x, y) at 2 idx), zeros
// if !valid
__device__ __forceinline__ Point load_point(const float* __restrict__ loc,
                                            const bf16* __restrict__ attw, size_t idx,
                                            bool valid) {
  if (!valid) idx = 0;
  const float2 xy = ldg_f2(loc + 2 * idx);
  const float a = ldg_bf16(attw + idx);
  return valid ? Point{xy.x, xy.y, a} : Point{0.f, 0.f, 0.f};
}

// A point's four taps (t = 4p + c) merged with its row's other taps:
// pix[c] (-1 dead), bit c of `first`: the first live tap on its pixel,
// sum[c]: the f32 sum in tap order of the rounded weights of the row's
// taps on that pixel; the point's corners and weight for the backward's
// chain
struct PointTaps {
  int pix[4];
  float sum[4];
  unsigned first;
  msda::Tap tap;
  float a;
};

// Point p of a row, held by lane p of a group of P consecutive lanes (one
// per point of the row; all lanes of the warp call it). The group's lanes
// trade their corners and rounded weights by shuffles. Corner c of point p
// and corner c' of point q fall on one pixel when q's top-left corner lies
// (dx, dy) from p's and c' = c - (dx, dy) is a corner: each other point
// gives at most one tap on each of p's pixels, added in the order of q,
// i.e. in tap order. A pixel shared with an earlier point is written by
// that point's lane.
template <int P>
__device__ __forceinline__ void merge_point(const Point& pt, int p, bool valid, int H, int W,
                                            PointTaps& out) {
  const msda::Tap tp = msda::make_tap(pt.x, pt.y, H, W);
  out.tap = tp;
  out.a = pt.a;
  float w[4];
  out.first = 0u;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (!(valid && msda::corner_pixel(tp, c, H, W, out.pix[c]))) out.pix[c] = -1;
    // 0 + w, as the Pallas kernel adds each tap to a zeroed row
    w[c] = 0.f + __bfloat162float(__float2bfloat16_rn(pt.a * msda::corner_weight(tp, c)));
    out.sum[c] = w[c];
    if (out.pix[c] >= 0) out.first |= 1u << c;
  }
  // the row's other points q = p + d (mod P): a later q adds its tap on a
  // pixel of p to p's sum (in order of q: tap order), an earlier one takes
  // p's first place there
  const int base = (threadIdx.x & 31) & ~(P - 1);
  int dx[P - 1], dy[P - 1];
  bool near = false;
#pragma unroll
  for (int d = 1; d < P; ++d) {
    const int src = base + ((p + d) & (P - 1));
    dx[d - 1] = __shfl_sync(FULL, tp.x0, src) - tp.x0;
    dy[d - 1] = __shfl_sync(FULL, tp.y0, src) - tp.y0;
    near |= abs(dx[d - 1]) <= 1 && abs(dy[d - 1]) <= 1;
  }
  if (!__any_sync(FULL, near)) return;         // no two points of any row meet
#pragma unroll
  for (int d = 1; d < P; ++d) {
    const int src = base + ((p + d) & (P - 1));
    const bool later = p + d < P;
    float qw[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) qw[c] = __shfl_sync(FULL, w[c], src);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int cx = (c & 1) - dx[d - 1], cy = (c >> 1) - dy[d - 1];
      const bool hit = out.pix[c] >= 0 && (unsigned)cx <= 1u && (unsigned)cy <= 1u;
      const float wq = cy ? (cx ? qw[3] : qw[2]) : (cx ? qw[1] : qw[0]);
      if (!later && hit) out.first &= ~(1u << c);
      out.sum[c] += later && hit ? wq : 0.f;
    }
  }
}

// a point's merged entries into (or, with zero, out of) its row of a tap
// tile; a tap that writes nothing stores to `trash` instead (no branch),
// a lane's own 4 bytes of shared memory that nothing reads
__device__ __forceinline__ void write_point(uint8_t* A, uint8_t* trash, int row,
                                            const PointTaps& pt, bool zero) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint8_t* dst = (pt.first >> c) & 1u ? A + a_offset(row, pt.pix[c]) : trash;
    *reinterpret_cast<bf16*>(dst) = __float2bfloat16_rn(zero ? 0.f : pt.sum[c]);
  }
}

// The weight the Pallas kernel gives tap (p, c) of a row of P points on an
// H x W level, for the kernels that take a tap at a time (K3-bf16's
// gather and K4-bf16's direct kernel): for the first live tap on its pixel
// `pix` in tap order, the f32 sum of the rounded weights of the row's taps
// on that pixel (0 + each, in tap order), rounded to bf16; for the others
// `first` is false and the weight 0. The row's points are read again from
// device memory (loc: P (x, y) pairs; attw: P weights, bf16).
__device__ __forceinline__ float merged_weight(const float* __restrict__ loc,
                                               const bf16* __restrict__ attw, int P, int H, int W,
                                               int p, int c, int pix, bool& first) {
  float s = 0.f;
  for (int q = 0; q < P; ++q) {
    const msda::Tap tq = msda::make_tap(__ldg(loc + 2 * q), __ldg(loc + 2 * q + 1), H, W);
    const float a = __bfloat162float(attw[q]);
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      int pq;
      if (!msda::corner_pixel(tq, d, H, W, pq) || pq != pix) continue;
      if (4 * q + d < 4 * p + c) {
        first = false;
        return 0.f;
      }
      s += __bfloat162float(__float2bfloat16_rn(a * msda::corner_weight(tq, d)));
    }
  }
  first = true;
  return __bfloat162float(__float2bfloat16_rn(s));
}

}  // namespace msda_tap
