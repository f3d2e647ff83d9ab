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
#include "msda_tap.cuh"

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
// K3-bf16 replaces `_msda_kernel` at acc_dtype bf16, the JAX package's eval
// and training dtype (value and attention weights bf16, locations f32,
// output bf16), with its rounding points (ops/msda.py `_msda_pallas_fwd`):
// per (batch, head, level) the tap matrix A of msda_tap.cuh (each tap
// weight attw * w_c formed in f32 and rounded to bf16, the weights of one
// query's taps on one pixel summed in f32 in tap order and rounded again),
// each level's A_l V_l accumulated in f32, the levels summed in f32 and
// rounded to bf16 once. Only the order of the f32 sums differs from the
// Pallas kernel.
//
// What bounds it on the H100: at the training shape (B 16, Lq 648, M 8,
// D 64, two 18x18 levels, P 4) a call reads 10.6 MB of bf16 value and
// 6.6 MB of locations and weights and writes 10.6 MB: 27.9 MB, 8.3 us at
// 3.35 TB/s. The dense products, 2 B M Lq S D = 6.9 GFLOP, take 7 us at
// 989 TFLOP/s of dense bf16, so the tensor cores can keep pace with the
// bytes. What sets the time instead (PERF.md) is the CUDA-core work around
// the products: merging a tile's taps, placing and clearing its entries,
// and the barriers between the tiles.
//
// The tap kernel: a block per (b, m) and chunk of query tiles of 64 rows,
// two warpgroups, warpgroup w taking levels w and w + 2. The block stages
// value[b, :, m, :] of every level once (cp.async into the 128-byte
// swizzle, each level padded with zero rows to a multiple of 32). Per tile
// each warpgroup runs its levels' out += A_l V_l as m64n64k16 wgmma (A
// K-major, V MN-major, both from shared memory) into two accumulators,
// even and odd 16-pixel slices, while its threads merge the next tile's
// taps (msda_tap.cuh: a row's points in consecutive lanes) and load the
// points of the tile after. Warpgroup 1 hands its f32 tile to warpgroup 0
// through shared memory; warpgroup 0 adds it (level 0 + level 1, the
// Pallas kernel's order at two levels), rounds the tile and writes it.
// Both warpgroups issue the same count of products (a warpgroup past its
// levels multiplies a zero block): a count that differs by thread makes
// ptxas serialise the products. The chunk is the whole query range where
// the B*M blocks fill half the card (training, lockstep N = 12); fewer
// pairs (the tracker's B 1) split the tiles over blocks, each staging its
// pair's value rows from L2 (ops/msda.py msda_plan, by shape). Shared
// memory at the recipe's shape: 90,112 B of value rows, two 48 KB tap
// tiles, an 8 KB zero block, the 16 KB hand-over tile: 215,040 B.
//
// Other shapes (D other than 64, P other than 2 or 4, more than 4 levels,
// levels too large for shared memory) keep the gather kernel below: one
// warp per (b, q, m) reading the corner rows from device memory. It
// applies the Pallas kernel's merged weights too (msda_tap::merged_weight:
// a tap reads its level's points again to find the others on its pixel).
// No main path of the recipe reaches it.
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
      const size_t row0 = (size_t)warp * LP + l * P_;     // the level's first point
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int pix;
        bool first = false;
        const bool live = msda::corner_pixel(tp, c, H, W, pix);
        wgt[4 * t + c] = live ? msda_tap::merged_weight(loc + 2 * row0, attw + row0, P_, H, W,
                                                        t - l * P_, c, pix, first)
                              : 0.f;
        off[4 * t + c] = live && first ? (lv.start[l] + pix) * stride : -1;
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
        const msda::Tap tp = msda::make_tap(__shfl_sync(FULL, lx, t - t0),
                                            __shfl_sync(FULL, ly, t - t0), H, W);
        const size_t row0 = (size_t)warp * LP + l * P;     // the level's first point
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          int pix;
          bool first = false;
          const bool live = msda::corner_pixel(tp, c, H, W, pix);
          const float w = live ? msda_tap::merged_weight(loc + 2 * row0, attw + row0, P, H, W,
                                                         t - l * P, c, pix, first)
                               : 0.f;
          fma_row<RPL>(acc, w, vb + (size_t)(lv.start[l] + (live ? pix : 0)) * stride, lane, D,
                       live && first);
        }
      }
    }
  }
  store_row_bf16<RPL>(out + (size_t)warp * D, acc, lane, D);
}

// byte offsets in the tap kernel's shared memory, from its base aligned to
// 1024 bytes; ops/msda.py `tap_fwd_smem` counts the same bytes
struct TapFwdLayout {
  int v[msda::MAX_LEVELS];   // level l's value rows: S_l rounded up to 32, 128 bytes each
  int a[msda::MAX_LEVELS];   // level l's tap tile: ceil(S_l / 64) column blocks
  int zero;                  // a column block of zeros: a warpgroup's products past its levels
  int x;                     // warpgroup 1's f32 partial output tile for warpgroup 0
  int trash;                 // 4 bytes a thread that the taps which write nothing store to
  int slices;                // 16-pixel slices of the largest level, rounded up to pairs
  int bytes;                 // the whole, with 1024 bytes to align the base
};

TapFwdLayout tap_fwd_layout(const msda::Levels& lv, int L) {
  TapFwdLayout lay{};
  int off = 0;
  for (int l = 0; l < L; ++l) {
    lay.v[l] = off;
    off += (lv.h[l] * lv.w[l] + 31) / 32 * 32 * 128;
  }
  for (int l = 0; l < L; ++l) {
    lay.a[l] = off;
    off += (lv.h[l] * lv.w[l] + 63) / 64 * msda_tap::TILE_BYTES;
    lay.slices = max(lay.slices, (lv.h[l] * lv.w[l] + 31) / 32 * 2);
  }
  lay.zero = off;
  lay.x = off + msda_tap::TILE_BYTES;
  lay.trash = lay.x + 128 * 32 * 4;
  lay.bytes = lay.trash + 256 * 4 + 1024;
  return lay;
}

// Two warpgroups; warpgroup w takes levels w and w + 2 (NL: 1 for L <= 2,
// 2 for L <= 4). Its thread i holds point i % P of rows i / P and
// i / P + 128 / P (P 4) or of row i / P (P 2) of each of its levels in
// every tile (a row's points in consecutive lanes), merged while the
// products of the previous tile run. Each warpgroup runs its levels'
// products into two accumulators (even and odd 16-pixel slices);
// warpgroup 1 hands its f32 tile to warpgroup 0 through shared memory,
// which adds it (level 0 + level 1, the Pallas kernel's order at two
// levels), rounds the tile once and writes it. `tiles`: query tiles of 64
// rows a block (ops/msda.py msda_plan's fwd_tiles).
template <int P, int NL>
__global__ void __launch_bounds__(256, 1)
msda_fwd_kernel_tap_bf16(const bf16* __restrict__ value, const float* __restrict__ loc,
                         const bf16* __restrict__ attw, bf16* __restrict__ out, int S, int M,
                         int Lq, int L, msda::Levels lv, TapFwdLayout lay, int tiles) {
  using msda_tap::D;
  constexpr int PT = P / 2;                        // rows a thread holds a level
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  const int n_tiles = (Lq + msda_tap::ROWS - 1) / msda_tap::ROWS;
  const int chunks = (n_tiles + tiles - 1) / tiles;
  const int pair = blockIdx.x / chunks, chunk = blockIdx.x - pair * chunks;
  const int m = pair % M, b = pair / M;
  const int t0 = chunk * tiles, t1 = min(n_tiles, t0 + tiles);
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int point = wt % P;
  const size_t stride = (size_t)M * D;

  // value[b, :, m, :] of every level, zero rows up to a multiple of 32
  // (pairs of 16-pixel slices; A's padding columns are zero, and 0 x NaN
  // would not be), and the tap tiles zeroed once
  for (int l = 0; l < L; ++l) {
    const int s = lv.h[l] * lv.w[l];
    msda_tap::stage_rows(smem + lay.v[l],
                         value + ((size_t)b * S + lv.start[l]) * stride + (size_t)m * D, s,
                         stride, tid, blockDim.x);
    msda_tap::zero_bytes(smem + lay.v[l] + s * 128, ((s + 31) / 32 * 32 - s) * 128, tid,
                         blockDim.x);
  }
  msda_tap::cp_async_commit();
  msda_tap::zero_bytes(smem + lay.a[0], lay.x - lay.a[0], tid, blockDim.x);
  __syncthreads();

  auto level = [&](int li) { return wg + 2 * li; };
  auto row = [&](int k) { return k * (128 / P) + wt / P; };
  auto valid = [&](int t, int li, int k) {
    return t < t1 && level(li) < L && t * msda_tap::ROWS + row(k) < Lq;
  };
  auto index = [&](int t, int li, int k) {
    return (((size_t)(b * Lq + t * msda_tap::ROWS + row(k)) * M + m) * L + level(li)) * P +
           point;
  };
  msda_tap::Point pts[NL][PT];                     // this thread's points of the next tile
  msda_tap::PointTaps cur[NL][PT], nxt[NL][PT];
  auto load = [&](int t) {
#pragma unroll
    for (int li = 0; li < NL; ++li)
#pragma unroll
      for (int k = 0; k < PT; ++k)
        pts[li][k] = msda_tap::load_point(loc, attw, index(t, li, k), valid(t, li, k));
  };
  uint8_t* trash = smem + lay.trash + 4 * tid;
  // this warpgroup's levels, in registers (the parameters' arrays would be
  // read from local memory at a level index known only at run time)
  uint8_t* Al[NL];
  int Hl[NL], Wl[NL];
#pragma unroll
  for (int li = 0; li < NL; ++li) {
    const int l = level(li) < L ? level(li) : 0;
    Al[li] = smem + lay.a[l];
    Hl[li] = lv.h[l];
    Wl[li] = lv.w[l];
  }
  auto merge = [&](int t) {
#pragma unroll
    for (int li = 0; li < NL; ++li)
#pragma unroll
      for (int k = 0; k < PT; ++k)
        msda_tap::merge_point<P>(pts[li][k], point, valid(t, li, k), Hl[li], Wl[li], nxt[li][k]);
  };
  // this tile's entries out, the next's in (a row's other points are in
  // this warp and may write where this lane clears)
  auto place = [&]() {
#pragma unroll
    for (int li = 0; li < NL; ++li)
#pragma unroll
      for (int k = 0; k < PT; ++k)
        msda_tap::write_point(Al[li], trash, row(k), cur[li][k], true);
    __syncwarp();
#pragma unroll
    for (int li = 0; li < NL; ++li)
#pragma unroll
      for (int k = 0; k < PT; ++k) {
        msda_tap::write_point(Al[li], trash, row(k), nxt[li][k], false);
        cur[li][k] = nxt[li][k];
      }
  };

#pragma unroll
  for (int li = 0; li < NL; ++li)
#pragma unroll
    for (int k = 0; k < PT; ++k) cur[li][k].first = 0u;
  load(t0);
  merge(t0);
  place();                                         // tile t0's taps
  load(t0 + 1);
  msda_tap::cp_async_wait<0>();                    // and the value rows
  hopper::fence_async_smem();
  __syncthreads();

  float* X = reinterpret_cast<float*>(smem + lay.x);
  // descriptors of each of this warpgroup's levels and of the zero block; a
  // slice kk sits (kk / 4) blocks and 32 (kk % 4) bytes on in A, 16 kk rows
  // on in the value rows (descriptor addresses count 16 bytes)
  uint64_t da0[NL], db0[NL];
  int nk[NL];
#pragma unroll
  for (int li = 0; li < NL; ++li) {
    const int l = level(li) < L ? level(li) : 0;
    da0[li] = hopper::desc<64>(smem + lay.a[l]);
    db0[li] = hopper::desc<64>(smem + lay.v[l]);
    nk[li] = level(li) < L ? (lv.h[l] * lv.w[l] + 31) / 32 * 2 : 0;
  }
  const uint64_t dz = hopper::desc<64>(smem + lay.zero);
  const int slices = lay.slices;
  for (int t = t0; t < t1; ++t) {
    // the same count of products in both warpgroups (a count that differs
    // between them would make the compiler serialise the products): slices
    // past a warpgroup's levels read the zero block
    float acc0[32], acc1[32];                      // even and odd slices; first products overwrite
    hopper::wg_fence();
#pragma unroll
    for (int li = 0; li < NL; ++li)
      for (int kk = 0; kk < slices; kk += 2) {
        const bool real = kk < nk[li];
        const uint64_t da = real ? da0[li] + (kk >> 2) * (msda_tap::TILE_BYTES >> 4) + (kk & 3) * 2
                                 : dz + (kk & 3) * 2;
        const uint64_t db = db0[li] + (real ? kk * (16 * 128 >> 4) : 0);
        hopper::wgmma_ss_n64_t<0, 1>(acc0, da, db, li | kk);
        hopper::wgmma_ss_n64_t<0, 1>(acc1, da + 2, db + (16 * 128 >> 4), li | kk);
      }
    hopper::wg_commit();
    merge(t + 1);                                  // while the products run
    hopper::wg_wait<0>();
    hopper::fence_regs(acc0);
    hopper::fence_regs(acc1);
    float v[32];                                   // this warpgroup's levels
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = acc0[i] + acc1[i];
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i) X[i * 128 + wt] = v[i];
    }
    __syncthreads();                               // A read by both; X whole
    uint32_t packed[16];                           // warpgroup 0: the rows, rounded once
#pragma unroll
    for (int j = 0; j < 16; ++j)
      packed[j] = wg ? 0u : hopper::pack(v[2 * j] + X[(2 * j) * 128 + wt],
                                         v[2 * j + 1] + X[(2 * j + 1) * 128 + wt]);
    place();                                       // tile t + 1's taps
    hopper::fence_async_smem();
    // device memory after the fence, which would wait for it: this tile's
    // rows (row q of (b, m) at out + ((b Lq + q) M + m) D), then the
    // points of tile t + 2
    if (wg == 0) {
      bf16* ob = out + ((size_t)b * Lq * M + m) * D;
      const int q0 = t * msda_tap::ROWS;
      const int ra = q0 + hopper::acc_row(wt, 0), rb = q0 + hopper::acc_row(wt, 2);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = hopper::acc_col(wt, j, 0);
        if (ra < Lq) *reinterpret_cast<uint32_t*>(ob + (size_t)ra * stride + c) = packed[2 * j];
        if (rb < Lq) *reinterpret_cast<uint32_t*>(ob + (size_t)rb * stride + c) = packed[2 * j + 1];
      }
    }
    load(t + 2);
    __syncthreads();                               // whole, and X read
  }
}

template <int P, int NL>
int launch_tap_nl(const bf16* v, const float* lc, const bf16* aw, bf16* o, int B, int S, int M,
                  int Lq, int L, const msda::Levels& lv, const TapFwdLayout& lay, int tiles,
                  cudaStream_t s) {
  static bool smem_set[16] = {};
  const int err = hopper_host::allow_smem(msda_fwd_kernel_tap_bf16<P, NL>, msda::SMEM_MAX,
                                          smem_set);
  if (err) return err;
  const int n_tiles = (Lq + msda_tap::ROWS - 1) / msda_tap::ROWS;
  const long long blocks = (long long)B * M * ((n_tiles + tiles - 1) / tiles);
  if (blocks == 0) return 0;
  msda_fwd_kernel_tap_bf16<P, NL><<<(unsigned)blocks, 256, lay.bytes, s>>>(
      v, lc, aw, o, S, M, Lq, L, lv, lay, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_tap_p(const bf16* v, const float* lc, const bf16* aw, bf16* o, int B, int S, int M,
                 int Lq, int L, const msda::Levels& lv, const TapFwdLayout& lay, int tiles,
                 cudaStream_t s) {
  if (L <= 2) return launch_tap_nl<P, 1>(v, lc, aw, o, B, S, M, Lq, L, lv, lay, tiles, s);
  return launch_tap_nl<P, 2>(v, lc, aw, o, B, S, M, Lq, L, lv, lay, tiles, s);
}

int launch_tap(const bf16* v, const float* lc, const bf16* aw, bf16* o, int B, int S, int M,
               int D, int Lq, int L, int P, const msda::Levels& lv, int tiles, cudaStream_t s) {
  const TapFwdLayout lay = tap_fwd_layout(lv, L);
  if (D != msda_tap::D || (P != 2 && P != 4) || L > 4 || lay.bytes > msda::SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (P == 2) return launch_tap_p<2>(v, lc, aw, o, B, S, M, Lq, L, lv, lay, tiles, s);
  return launch_tap_p<4>(v, lc, aw, o, B, S, M, Lq, L, lv, lay, tiles, s);
}

}  // namespace

// value (B, S, M, D) bf16, loc (B, Lq, M, L, P, 2) f32, attw (B, Lq, M, L, P)
// bf16, out (B, Lq, M*D) bf16, all contiguous and 16-byte aligned; D a
// multiple of 8 up to 128. shapes: host array of L (H, W) pairs. tap_tiles:
// 0 for the gather kernel; else the tap kernel (D 64, P <= 8, the levels in
// shared memory) with that many query tiles of 64 rows a block. Returns
// cudaGetLastError() after the launch.
extern "C" int msda_fwd_bf16(const void* value, const void* loc, const void* attw,
                             void* out, int B, int S, int M, int D, int Lq, int L,
                             int P, const int* shapes, int tap_tiles, void* stream) {
  msda::Levels lv;
  if (!msda::make_levels(shapes, L, S, lv) || D < 8 || D > 128 || D % 8 != 0 || tap_tiles < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* v = static_cast<const bf16*>(value);
  const auto* lc = static_cast<const float*>(loc);
  const auto* aw = static_cast<const bf16*>(attw);
  auto* o = static_cast<bf16*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (tap_tiles > 0) return launch_tap(v, lc, aw, o, B, S, M, D, Lq, L, P, lv, tap_tiles, s);
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

