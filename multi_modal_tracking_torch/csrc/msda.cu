// Multi-scale deformable attention forward (K3) for Hopper (sm_90a), f32;
// its bf16 form (K3-bf16) is at the end of the file.
//
// Replaces the Pallas kernel `_msda_kernel`, launched by `_msda_pallas_fwd`
// in multi_modal_tracking_tpu/ops/msda.py. For every (batch, query, head):
//
//     out[b, q, m, :] = sum_l sum_p attw[b,q,m,l,p] * bilinear(V_l[b, :, m, :],
//                          x = loc_x * W_l - 0.5, y = loc_y * H_l - 0.5)
//
// with zero padding outside each level's map: the numerics of
// grid_sample(align_corners=False, padding_mode='zeros'); the corner
// arithmetic is msda_common.cuh's, shared with K4.
//
// What bounds it on the H100: it reads value (B, S, M, D), loc and attw
// once and writes (B, Lq, M*D): 50.4 MB at the training shape (B 16, Lq
// 648, M 8, D 64, two 18x18 levels), 0.015 ms at 3.35 TB/s; about 2 FLOP
// per gathered float. Gathered naively, each (b, q, m) reads L*P*4 = 32
// rows of D floats: 680 MB of L2 traffic at B 16 for 21 MB of values.
//
// Two kernels, chosen by shape in ops/msda.py msda_plan:
//
// * staged (enough (b, m) pairs to fill the card: the training shape): one
//   block per (b, m), as the TPU kernel kept each batch's value rows in
//   VMEM. It stages value[b, :, m, :] of every level (S rows of D floats,
//   648 x 64 x 4 = 165,888 B) into shared memory with cp.async, so 21 MB
//   are staged instead of 680 MB gathered; B*M blocks (128 at the training
//   shape) make one wave on 132 SMs. Its 32 warps walk the queries, one
//   warp per query with channel lane + 32 r in each lane (conflict-free row
//   reads). For eight points at a time each lane computes one corner, from
//   a coalesced load of the point's (x, y, attw) made while the previous
//   query was worked on, and writes its (row offset, attw * w_c) into the
//   warp's corner table; the warp then reads the table by broadcast and the
//   live corner rows, accumulates the output row in registers and writes it
//   once, coalesced. The table replaces per-point shuffles and per-lane
//   corner arithmetic, which left the first version instruction-bound;
//   32 warps (not 16) hide the shared-memory latency of the table-then-row
//   chain.
//
// * gather (few (b, m) pairs, e.g. the tracker's B 1, where 8 staging
//   blocks could not fill 132 SMs; or a value slice too large for shared
//   memory): one warp per (b, q, m) reads the corner rows from device
//   memory (L2: the value tensor was just written by value_proj). There
//   latency, not bytes, sets the time, so the design removes the dependent
//   chain of loads: the warp's L*P (x, y, attw) arrive in one coalesced
//   load, every corner address is computed before the first value load, so
//   all L*P*4 row loads are in flight at once, and at D 64 each lane takes
//   two adjacent channels with one float2 load. L and P are template
//   parameters for the recipe's 2 and 4; other shapes take a generic
//   instantiation. At B 1 it beat the staged kernel with the queries split
//   over several blocks per (b, m) (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "msda_common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int STAGED_WARPS = 32;
constexpr int GATHER_WARPS = 8;
// per-warp corner tables after the value rows (ops/msda.py FWD_TABLE_BYTES)
constexpr int TABLE_BYTES = STAGED_WARPS * 32 * 8;

// (x, y, attw) of point t (< L*P) of warp row bqm = (b * Lq + q) * M + m
__device__ __forceinline__ void load_point(const float* __restrict__ loc,
                                           const float* __restrict__ attw, size_t bqm, int LP,
                                           int t, float& x, float& y, float& a) {
  if (t < LP) {
    const size_t pt = bqm * LP + t;
    x = __ldg(loc + 2 * pt);
    y = __ldg(loc + 2 * pt + 1);
    a = __ldg(attw + pt);
  }
}

// the staged kernel's corner tables start after the (S, D) value rows, on
// an 8-byte boundary
__host__ __device__ constexpr int table_offset(int S, int D) { return (S * D + 1) / 2 * 2; }

template <int CPL>
__global__ void __launch_bounds__(STAGED_WARPS * 32, 1)
msda_fwd_kernel_staged(const float* __restrict__ value, const float* __restrict__ loc,
                       const float* __restrict__ attw, float* __restrict__ out, int S,
                       int M, int D, int Lq, int L, int P, msda::Levels lv) {
  extern __shared__ __align__(16) float smem[];   // (S, D) value rows of (b, m)
  const int m = blockIdx.x % M, b = blockIdx.x / M;
  const int stride = M * D, LP = L * P;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  msda::stage_slice(smem, value + (size_t)b * S * stride + (size_t)m * D, S, D, stride, tid,
                    blockDim.x);
  msda::cp_async_wait_all();
  __syncthreads();

  // per warp, the (row offset in smem, attw * w_c) of 32 corners, the four
  // corners of eight points; -1 marks a dead corner
  int2* table = reinterpret_cast<int2*>(smem + table_offset(S, D)) + warp * 32;
  // lane works on corner lane & 3 of point t0 + (lane >> 2)
  float xn = 0.f, yn = 0.f, an = 0.f;
  if (warp < Lq)
    load_point(loc, attw, (size_t)(b * Lq + warp) * M + m, LP, lane >> 2, xn, yn, an);
  for (int q = warp; q < Lq; q += STAGED_WARPS) {
    float x = xn, y = yn, a = an;
    const size_t bqm = (size_t)(b * Lq + q) * M + m;
    if (q + STAGED_WARPS < Lq)
      load_point(loc, attw, bqm + (size_t)STAGED_WARPS * M, LP, lane >> 2, xn, yn, an);
    float acc[CPL];
#pragma unroll
    for (int r = 0; r < CPL; ++r) acc[r] = 0.f;
    for (int t0 = 0; t0 < LP; t0 += 8) {
      const int t = t0 + (lane >> 2), c = lane & 3;
      if (t0 > 0) load_point(loc, attw, bqm, LP, t, x, y, a);
      const int l = t < LP ? t / P : 0;
      const int H = lv.h[l], W = lv.w[l];
      const msda::Tap tp = msda::make_tap(x, y, H, W);
      int pix;
      const bool live = t < LP && msda::corner_pixel(tp, c, H, W, pix);
      table[lane] = make_int2(live ? (lv.start[l] + pix) * D : -1,
                              __float_as_int(a * msda::corner_weight(tp, c)));
      __syncwarp();
#pragma unroll 8
      for (int k = 0; k < 32; ++k) {
        const int2 ek = table[k];
        if (ek.x < 0) continue;                 // warp-uniform
        const float wgt = __int_as_float(ek.y);
        const float* row = smem + ek.x;
#pragma unroll
        for (int r = 0; r < CPL; ++r) {
          const int ch = lane + 32 * r;
          if (ch < D) acc[r] = fmaf(wgt, row[ch], acc[r]);
        }
      }
      __syncwarp();
    }
    float* op = out + bqm * D;   // (B, Lq, M, D) == (B, Lq, M*D)
#pragma unroll
    for (int r = 0; r < CPL; ++r) {
      const int ch = lane + 32 * r;
      if (ch < D) op[ch] = acc[r];
    }
  }
}

// CPL channels per lane: with VEC (D 64) the adjacent pair 2 lane, 2 lane
// + 1, read as one float2; else channel lane + 32 r
template <int CPL, bool VEC>
struct Row {
  static_assert(!VEC || CPL == 2, "float2 rows hold D 64");
  float v[CPL];
  __device__ __forceinline__ void load(const float* row, int lane, int D, bool live) {
    if constexpr (VEC) {
      const float2 t = live ? __ldg(reinterpret_cast<const float2*>(row) + lane)
                            : make_float2(0.f, 0.f);
      v[0] = t.x;
      v[1] = t.y;
    } else {
#pragma unroll
      for (int r = 0; r < CPL; ++r) {
        const int ch = lane + 32 * r;
        v[r] = live && ch < D ? __ldg(row + ch) : 0.f;
      }
    }
  }
};

template <int CPL, bool VEC>
__device__ __forceinline__ void store_row(float* op, const float (&acc)[CPL], int lane, int D) {
  if constexpr (VEC) {
    reinterpret_cast<float2*>(op)[lane] = make_float2(acc[0], acc[1]);
  } else {
#pragma unroll
    for (int r = 0; r < CPL; ++r) {
      const int ch = lane + 32 * r;
      if (ch < D) op[ch] = acc[r];
    }
  }
}

// L_ and P_ > 0: the shape at compile time, every corner address computed
// before the first value load; 0: runtime L and P, a point at a time
template <int L_, int P_, int CPL, bool VEC>
__global__ void __launch_bounds__(GATHER_WARPS * 32)
msda_fwd_kernel_gather(const float* __restrict__ value, const float* __restrict__ loc,
                       const float* __restrict__ attw, float* __restrict__ out, int B, int S,
                       int M, int D, int Lq, int L, int P, msda::Levels lv) {
  const int warp = blockIdx.x * GATHER_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= B * Lq * M) return;       // warp-uniform
  const int m = warp % M;
  const int b = warp / M / Lq;
  const int stride = M * D;
  const float* vb = value + (size_t)b * S * stride + (size_t)m * D;
  float acc[CPL];
#pragma unroll
  for (int r = 0; r < CPL; ++r) acc[r] = 0.f;

  if constexpr (L_ > 0) {
    constexpr int LP = L_ * P_;
    static_assert(LP <= 32, "one point per lane");
    float lx = 0.f, ly = 0.f, la = 0.f;
    load_point(loc, attw, (size_t)warp, LP, lane, lx, ly, la);
    int off[4 * LP];
    float wgt[4 * LP];
#pragma unroll
    for (int t = 0; t < LP; ++t) {
      const int l = t / P_;
      const int H = lv.h[l], W = lv.w[l];
      const float a = __shfl_sync(FULL, la, t);
      const msda::Tap tp = msda::make_tap(__shfl_sync(FULL, lx, t), __shfl_sync(FULL, ly, t),
                                          H, W);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int pix;
        const bool live = msda::corner_pixel(tp, c, H, W, pix);
        off[4 * t + c] = live ? (lv.start[l] + pix) * stride : -1;
        wgt[4 * t + c] = a * msda::corner_weight(tp, c);
      }
    }
    Row<CPL, VEC> rows[4 * LP];
#pragma unroll
    for (int k = 0; k < 4 * LP; ++k)
      rows[k].load(vb + (off[k] < 0 ? 0 : off[k]), lane, D, off[k] >= 0);
#pragma unroll
    for (int k = 0; k < 4 * LP; ++k) {
      if (off[k] < 0) continue;               // dead corner: skipped
#pragma unroll
      for (int r = 0; r < CPL; ++r) acc[r] = fmaf(wgt[k], rows[k].v[r], acc[r]);
    }
  } else {
    const int LP = L * P;
    for (int t0 = 0; t0 < LP; t0 += 32) {
      float lx = 0.f, ly = 0.f, la = 0.f;
      if (t0 + lane < LP) {
        const size_t pt = (size_t)warp * LP + t0 + lane;
        lx = __ldg(loc + 2 * pt);
        ly = __ldg(loc + 2 * pt + 1);
        la = __ldg(attw + pt);
      }
      for (int t = t0; t < LP && t < t0 + 32; ++t) {
        const int l = t / P;
        const int H = lv.h[l], W = lv.w[l];
        const float a = __shfl_sync(FULL, la, t - t0);
        const msda::Tap tp = msda::make_tap(__shfl_sync(FULL, lx, t - t0),
                                            __shfl_sync(FULL, ly, t - t0), H, W);
        Row<CPL, VEC> rows[4];
        bool live[4];
        float w[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          int pix;
          live[c] = msda::corner_pixel(tp, c, H, W, pix);
          w[c] = a * msda::corner_weight(tp, c);
          rows[c].load(vb + (size_t)(lv.start[l] + (live[c] ? pix : 0)) * stride, lane, D,
                       live[c]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (!live[c]) continue;
#pragma unroll
          for (int r = 0; r < CPL; ++r) acc[r] = fmaf(w[c], rows[c].v[r], acc[r]);
        }
      }
    }
  }
  store_row<CPL, VEC>(out + (size_t)warp * D, acc, lane, D);
}

// the gather path's launch floor: an empty kernel on the same grid
__global__ void __launch_bounds__(GATHER_WARPS * 32) msda_launch_floor_kernel() {}

template <int CPL>
int launch_staged(const float* v, const float* lc, const float* aw, float* o, int B, int S,
                  int M, int D, int Lq, int L, int P, const msda::Levels& lv, cudaStream_t s) {
  const long long smem = (long long)table_offset(S, D) * sizeof(float) + TABLE_BYTES;
  if (smem > msda::SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  // the shared-memory attribute belongs to each device's context: set it
  // once per device
  constexpr int MAX_DEVICES = 64;
  static bool attr_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES || !attr_set[dev]) {
    err = cudaFuncSetAttribute(msda_fwd_kernel_staged<CPL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, msda::SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < MAX_DEVICES) attr_set[dev] = true;
  }
  msda_fwd_kernel_staged<CPL><<<(unsigned)(B * M), STAGED_WARPS * 32, smem, s>>>(
      v, lc, aw, o, S, M, D, Lq, L, P, lv);
  return static_cast<int>(cudaGetLastError());
}

dim3 gather_grid(int B, int Lq, int M) {
  const long long warps = (long long)B * Lq * M;
  return dim3((unsigned)((warps + GATHER_WARPS - 1) / GATHER_WARPS));
}

}  // namespace

// value (B, S, M, D), loc (B, Lq, M, L, P, 2), attw (B, Lq, M, L, P),
// out (B, Lq, M*D), all f32, contiguous and 16-byte aligned. shapes: host
// array of L (H, W) pairs. staged: 1 for the staged kernel, 0 for the
// gather kernel. Returns cudaGetLastError() after the launch.
extern "C" int msda_fwd_f32(const void* value, const void* loc, const void* attw,
                            void* out, int B, int S, int M, int D, int Lq, int L,
                            int P, const int* shapes, int staged, void* stream) {
  msda::Levels lv;
  if (!msda::make_levels(shapes, L, S, lv) || D < 1 || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* v = static_cast<const float*>(value);
  const auto* lc = static_cast<const float*>(loc);
  const auto* aw = static_cast<const float*>(attw);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (staged) {
    if (D <= 32) return launch_staged<1>(v, lc, aw, o, B, S, M, D, Lq, L, P, lv, s);
    if (D <= 64) return launch_staged<2>(v, lc, aw, o, B, S, M, D, Lq, L, P, lv, s);
    return launch_staged<4>(v, lc, aw, o, B, S, M, D, Lq, L, P, lv, s);
  }
  const dim3 grid = gather_grid(B, Lq, M);
  const int threads = GATHER_WARPS * 32;
  if (L == 2 && P == 4 && D == 64)
    msda_fwd_kernel_gather<2, 4, 2, true><<<grid, threads, 0, s>>>(v, lc, aw, o, B, S, M, D,
                                                                    Lq, L, P, lv);
  else if (D <= 32)
    msda_fwd_kernel_gather<0, 0, 1, false><<<grid, threads, 0, s>>>(v, lc, aw, o, B, S, M, D,
                                                                     Lq, L, P, lv);
  else if (D <= 64)
    msda_fwd_kernel_gather<0, 0, 2, false><<<grid, threads, 0, s>>>(v, lc, aw, o, B, S, M, D,
                                                                     Lq, L, P, lv);
  else
    msda_fwd_kernel_gather<0, 0, 4, false><<<grid, threads, 0, s>>>(v, lc, aw, o, B, S, M, D,
                                                                     Lq, L, P, lv);
  return static_cast<int>(cudaGetLastError());
}

// The empty kernel on the gather path's grid (B * Lq * M warps), launched
// the same way: the floor under the gather kernel's time at small B.
extern "C" int msda_launch_floor_f32(int B, int Lq, int M, void* stream) {
  msda_launch_floor_kernel<<<gather_grid(B, Lq, M), GATHER_WARPS * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- bf16 (K3-bf16)
//
// The same two kernels at bf16, the JAX package's eval dtype (value and
// attention weights bf16, locations f32, output bf16), with the Pallas
// kernel's rounding points at acc_dtype bf16 (ops/msda.py
// `_msda_pallas_fwd`): each tap weight (bilinear corner weight x attention
// weight) is formed in f32 and rounded to bf16; value rows are bf16; the
// sum over taps of weight x value accumulates in f32 (each product of two
// bf16 values is exact in f32); the output is rounded to bf16 once. Staged
// value slices take half the shared memory of f32 (82,944 B at S 648, D 64);
// each lane holds channel pairs 2p, 2p + 1 for p = lane + 32 r, read as one
// 32-bit bf16 pair, so D must be a multiple of 8 (16-byte staging pieces).
//
// Drift from the Pallas kernel: it sums the rounded weights of the taps of
// one query and head that fall on the same source pixel in f32 and rounds
// that sum to bf16 again before its product with V (A = sum of taps, cast
// to bf16); these kernels apply each rounded tap weight on its own, one
// rounding fewer. Where two taps share a pixel the outputs differ by at
// most 2^-9 of that pixel's weight times its value; elsewhere only the
// f32 summation order differs. Measured on an H100 (chip_smoke.py, kernels
// phase, recipe shapes B 1 to 16): at most one bf16 unit of the output
// (0.0156 on outputs up to 2.6), with 2.5% of the outputs differing from
// the plain version on uniform locations and 26% on model-like ones, where
// taps cluster; the error against f32 stays at most the plain version's.
namespace {

using bf16 = __nv_bfloat16;

// (x, y, attw) of point t (< L*P) of warp row bqm, attention weight bf16
__device__ __forceinline__ void load_point(const float* __restrict__ loc,
                                           const bf16* __restrict__ attw, size_t bqm, int LP,
                                           int t, float& x, float& y, float& a) {
  if (t < LP) {
    const size_t pt = bqm * LP + t;
    x = __ldg(loc + 2 * pt);
    y = __ldg(loc + 2 * pt + 1);
    a = __bfloat162float(attw[pt]);
  }
}

// tap c of point tp: its weight rounded to bf16, as a float
__device__ __forceinline__ float tap_weight_bf16(float a, const msda::Tap& tp, int c) {
  return __bfloat162float(__float2bfloat16_rn(a * msda::corner_weight(tp, c)));
}

// the staged kernel's corner tables start after the (S, D) bf16 value rows,
// on an 8-byte boundary (in bf16 elements)
__host__ __device__ constexpr int table_offset_bf16(int S, int D) { return (S * D + 3) / 4 * 4; }

// acc += w * row for the lane's RPL channel pairs (pair lane + 32 r of D / 2)
template <int RPL>
__device__ __forceinline__ void fma_row(float2 (&acc)[RPL], float w, const bf16* row, int lane,
                                        int D, bool live) {
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int ch = 2 * (lane + 32 * r);
    if (live && ch < D) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + ch));
      acc[r].x = fmaf(w, f.x, acc[r].x);
      acc[r].y = fmaf(w, f.y, acc[r].y);
    }
  }
}

template <int RPL>
__device__ __forceinline__ void store_row_bf16(bf16* op, const float2 (&acc)[RPL], int lane,
                                               int D) {
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int ch = 2 * (lane + 32 * r);
    if (ch < D)
      *reinterpret_cast<__nv_bfloat162*>(op + ch) = __floats2bfloat162_rn(acc[r].x, acc[r].y);
  }
}

template <int RPL>
__global__ void __launch_bounds__(STAGED_WARPS * 32, 1)
msda_fwd_kernel_staged_bf16(const bf16* __restrict__ value, const float* __restrict__ loc,
                            const bf16* __restrict__ attw, bf16* __restrict__ out, int S,
                            int M, int D, int Lq, int L, int P, msda::Levels lv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);   // (S, D) value rows of (b, m)
  const int m = blockIdx.x % M, b = blockIdx.x / M;
  const int stride = M * D, LP = L * P, C = D / 8;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bf16* vrow0 = value + (size_t)b * S * stride + (size_t)m * D;
  for (int x = tid; x < S * C; x += blockDim.x) {
    const int r = x / C, c = x - r * C;
    msda::cp_async16(smem + r * D + 8 * c, vrow0 + (size_t)r * stride + 8 * c);
  }
  msda::cp_async_wait_all();
  __syncthreads();

  // per warp, the (row offset in smem, rounded tap weight) of 32 corners,
  // the four corners of eight points; -1 marks a dead corner
  int2* table = reinterpret_cast<int2*>(smem + table_offset_bf16(S, D)) + warp * 32;
  float xn = 0.f, yn = 0.f, an = 0.f;
  if (warp < Lq)
    load_point(loc, attw, (size_t)(b * Lq + warp) * M + m, LP, lane >> 2, xn, yn, an);
  for (int q = warp; q < Lq; q += STAGED_WARPS) {
    float x = xn, y = yn, a = an;
    const size_t bqm = (size_t)(b * Lq + q) * M + m;
    if (q + STAGED_WARPS < Lq)
      load_point(loc, attw, bqm + (size_t)STAGED_WARPS * M, LP, lane >> 2, xn, yn, an);
    float2 acc[RPL];
#pragma unroll
    for (int r = 0; r < RPL; ++r) acc[r] = make_float2(0.f, 0.f);
    for (int t0 = 0; t0 < LP; t0 += 8) {
      const int t = t0 + (lane >> 2), c = lane & 3;
      if (t0 > 0) load_point(loc, attw, bqm, LP, t, x, y, a);
      const int l = t < LP ? t / P : 0;
      const int H = lv.h[l], W = lv.w[l];
      const msda::Tap tp = msda::make_tap(x, y, H, W);
      int pix;
      const bool live = t < LP && msda::corner_pixel(tp, c, H, W, pix);
      table[lane] = make_int2(live ? (lv.start[l] + pix) * D : -1,
                              __float_as_int(tap_weight_bf16(a, tp, c)));
      __syncwarp();
#pragma unroll 8
      for (int k = 0; k < 32; ++k) {
        const int2 ek = table[k];
        if (ek.x < 0) continue;                 // warp-uniform
        fma_row<RPL>(acc, __int_as_float(ek.y), smem + ek.x, lane, D, true);
      }
      __syncwarp();
    }
    store_row_bf16<RPL>(out + bqm * D, acc, lane, D);
  }
}

// L_ and P_ > 0: the shape at compile time, every corner address computed
// before the first value load; 0: runtime L and P, a point at a time
template <int L_, int P_, int RPL>
__global__ void __launch_bounds__(GATHER_WARPS * 32)
msda_fwd_kernel_gather_bf16(const bf16* __restrict__ value, const float* __restrict__ loc,
                            const bf16* __restrict__ attw, bf16* __restrict__ out, int B,
                            int S, int M, int D, int Lq, int L, int P, msda::Levels lv) {
  const int warp = blockIdx.x * GATHER_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= B * Lq * M) return;       // warp-uniform
  const int m = warp % M;
  const int b = warp / M / Lq;
  const int stride = M * D;
  const bf16* vb = value + (size_t)b * S * stride + (size_t)m * D;
  float2 acc[RPL];
#pragma unroll
  for (int r = 0; r < RPL; ++r) acc[r] = make_float2(0.f, 0.f);

  if constexpr (L_ > 0) {
    constexpr int LP = L_ * P_;
    static_assert(LP <= 32, "one point per lane");
    float lx = 0.f, ly = 0.f, la = 0.f;
    load_point(loc, attw, (size_t)warp, LP, lane, lx, ly, la);
    int off[4 * LP];
    float wgt[4 * LP];
#pragma unroll
    for (int t = 0; t < LP; ++t) {
      const int l = t / P_;
      const int H = lv.h[l], W = lv.w[l];
      const float a = __shfl_sync(FULL, la, t);
      const msda::Tap tp = msda::make_tap(__shfl_sync(FULL, lx, t), __shfl_sync(FULL, ly, t),
                                          H, W);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int pix;
        const bool live = msda::corner_pixel(tp, c, H, W, pix);
        off[4 * t + c] = live ? (lv.start[l] + pix) * stride : -1;
        wgt[4 * t + c] = tap_weight_bf16(a, tp, c);
      }
    }
    __nv_bfloat162 rows[4 * LP][RPL];
#pragma unroll
    for (int k = 0; k < 4 * LP; ++k)
#pragma unroll
      for (int r = 0; r < RPL; ++r) {
        const int ch = 2 * (lane + 32 * r);
        rows[k][r] = off[k] >= 0 && ch < D
                         ? *reinterpret_cast<const __nv_bfloat162*>(vb + off[k] + ch)
                         : __floats2bfloat162_rn(0.f, 0.f);
      }
#pragma unroll
    for (int k = 0; k < 4 * LP; ++k) {
      if (off[k] < 0) continue;               // dead corner: skipped
#pragma unroll
      for (int r = 0; r < RPL; ++r) {
        const float2 f = __bfloat1622float2(rows[k][r]);
        acc[r].x = fmaf(wgt[k], f.x, acc[r].x);
        acc[r].y = fmaf(wgt[k], f.y, acc[r].y);
      }
    }
  } else {
    const int LP = L * P;
    for (int t0 = 0; t0 < LP; t0 += 32) {
      float lx = 0.f, ly = 0.f, la = 0.f;
      load_point(loc, attw, (size_t)warp, LP, t0 + lane, lx, ly, la);
      for (int t = t0; t < LP && t < t0 + 32; ++t) {
        const int l = t / P;
        const int H = lv.h[l], W = lv.w[l];
        const float a = __shfl_sync(FULL, la, t - t0);
        const msda::Tap tp = msda::make_tap(__shfl_sync(FULL, lx, t - t0),
                                            __shfl_sync(FULL, ly, t - t0), H, W);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          int pix;
          const bool live = msda::corner_pixel(tp, c, H, W, pix);
          fma_row<RPL>(acc, tap_weight_bf16(a, tp, c),
                       vb + (size_t)(lv.start[l] + (live ? pix : 0)) * stride, lane, D, live);
        }
      }
    }
  }
  store_row_bf16<RPL>(out + (size_t)warp * D, acc, lane, D);
}

template <int RPL>
int launch_staged_bf16(const bf16* v, const float* lc, const bf16* aw, bf16* o, int B, int S,
                       int M, int D, int Lq, int L, int P, const msda::Levels& lv,
                       cudaStream_t s) {
  const long long smem = (long long)table_offset_bf16(S, D) * sizeof(bf16) + TABLE_BYTES;
  if (smem > msda::SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int MAX_DEVICES = 64;
  static bool attr_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES || !attr_set[dev]) {
    err = cudaFuncSetAttribute(msda_fwd_kernel_staged_bf16<RPL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, msda::SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < MAX_DEVICES) attr_set[dev] = true;
  }
  msda_fwd_kernel_staged_bf16<RPL><<<(unsigned)(B * M), STAGED_WARPS * 32, smem, s>>>(
      v, lc, aw, o, S, M, D, Lq, L, P, lv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// value (B, S, M, D) bf16, loc (B, Lq, M, L, P, 2) f32, attw (B, Lq, M, L, P)
// bf16, out (B, Lq, M*D) bf16, all contiguous and 16-byte aligned; D a
// multiple of 8 up to 128. shapes: host array of L (H, W) pairs. staged: 1
// for the staged kernel, 0 for the gather kernel. Returns
// cudaGetLastError() after the launch.
extern "C" int msda_fwd_bf16(const void* value, const void* loc, const void* attw,
                             void* out, int B, int S, int M, int D, int Lq, int L,
                             int P, const int* shapes, int staged, void* stream) {
  msda::Levels lv;
  if (!msda::make_levels(shapes, L, S, lv) || D < 8 || D > 128 || D % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* v = static_cast<const bf16*>(value);
  const auto* lc = static_cast<const float*>(loc);
  const auto* aw = static_cast<const bf16*>(attw);
  auto* o = static_cast<bf16*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (staged) {
    if (D <= 64) return launch_staged_bf16<1>(v, lc, aw, o, B, S, M, D, Lq, L, P, lv, s);
    return launch_staged_bf16<2>(v, lc, aw, o, B, S, M, D, Lq, L, P, lv, s);
  }
  const dim3 grid = gather_grid(B, Lq, M);
  const int threads = GATHER_WARPS * 32;
  if (L == 2 && P == 4 && D <= 64)
    msda_fwd_kernel_gather_bf16<2, 4, 1><<<grid, threads, 0, s>>>(v, lc, aw, o, B, S, M, D,
                                                                   Lq, L, P, lv);
  else if (D <= 64)
    msda_fwd_kernel_gather_bf16<0, 0, 1><<<grid, threads, 0, s>>>(v, lc, aw, o, B, S, M, D,
                                                                   Lq, L, P, lv);
  else
    msda_fwd_kernel_gather_bf16<0, 0, 2><<<grid, threads, 0, s>>>(v, lc, aw, o, B, S, M, D,
                                                                   Lq, L, P, lv);
  return static_cast<int>(cudaGetLastError());
}
