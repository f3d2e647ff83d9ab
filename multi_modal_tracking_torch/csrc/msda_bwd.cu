// Multi-scale deformable attention backward (K4) for Hopper (sm_90a), f32;
// its bf16 form (K4-bf16) is described at the end of this comment.
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
// writes dValue, dLoc and dAttw (at the training shape B 16, Lq 648, M 8,
// D 64, two 18x18 levels: 2 x 21 MB for value and dValue, 21 MB for g),
// about 4 FLOP per touched float, so bytes bound it: 0.024 ms at 3.35 TB/s.
//
// Design, as the TPU kernel kept one head's value rows in VMEM: the staged
// kernel gives one block one (b, m, level) slice. It stages V_l[b, :, m, :]
// (S_l rows of D floats at a stride of M*D) into shared memory with
// cp.async, zeroes a dValue accumulator of the same size beside it
// (2 * 18*18 * 64 * 4 = 165,888 B at the training shape), and its 32 warps
// walk all Lq queries, one warp per query. Each lane holds channel pairs
// (2j, 2j+1), so every row access is one 64-bit access a lane and a warp
// touches each bank once per half. For four points at a time, lanes 2k and
// 2k+1 compute corner k from a coalesced load of its point's (x, y, attw)
// and write (row offset, attw * w_c) into the warp's corner table; the warp
// reads the table by broadcast, reads all 16 live rows for dw, then
// scatters attw * w_c * g into the accumulator. The H100 has no native f32
// add on shared memory: atomicAdd there compiles to a 32-bit CAS loop
// (ATOMS.CAST.SPIN), so the scatter is one 64-bit CAS loop per channel
// pair, half the loops. The 16 partial dw are reduced together (16
// shuffles, not 80) into the lane that owns each corner, which chains them
// to dAttw and dLoc in the kernel. Last, the block writes its dValue slice
// once, coalesced: no global atomic and no zero fill of dValue. 32 warps
// (at most 64 registers a thread) hide more of the shared-memory and CAS
// latency than 16 warps with a prefetch of the next query did: the
// latency of that chain, not shared-memory bandwidth, sets its time.
//
// Filling the card: B*M*L blocks, 256 at the training shape; with one
// 170 KB block per SM that is two waves on 132 SMs (132 + 124 blocks, 97 %
// of two full waves), so no query split is made: a split would need a
// second pass to add the partial slices, or global atomics, and would
// stage every slice twice.
//
// A level whose slice, accumulator and tables do not fit in shared memory
// (8 * S_l * D + 4096 > 232,448 B, i.e. S_l > 446 at D 64), or an odd D,
// goes to the direct kernel instead: one warp per (b, q, m) over those
// levels, gathering from device memory and scattering with global atomics
// into a dValue slice the wrapper zeroes. Which levels take which kernel
// is a choice by shape, made by ops/msda.py msda_plan and passed in as
// `staged_mask`.
//
// Shared (staged) or global (direct) atomics make the summation order of
// dValue vary from run to run.
//
// bf16 (K4-bf16) replaces `_msda_bwd_kernel` at acc_dtype bf16, the dtype
// the JAX package trains in, with its rounding points (ops/msda.py:377-418):
// dValue_l = A_l^T g with the tap matrix A_l of msda_tap.cuh (tap weights
// attw * w_c rounded to bf16, a query's taps on one pixel summed in f32 in
// tap order and rounded again) and the bf16 g, accumulated in f32 over all
// queries and rounded to bf16 once; dw = <g, V[corner]> of the bf16 rows in
// f32; the chain into dLoc (f32) and dAttw (rounded to bf16) in f32 on the
// unrounded attw and bilinear weights, each summed over the four corners in
// corner order as the plain version sums them.
//
// What bounds it: at the training shape a call reads value, g (10.6 MB
// each), locations and weights (6.6 MB) and writes dValue, dLoc and dAttw
// (17.2 MB): 45 MB, 13.4 us at 3.35 TB/s. Its two dense products, A^T g
// and g V^T, take 2 x 6.9 GFLOP, 14 us at 989 TFLOP/s of dense bf16.
//
// The tap kernel: one block per (b, m, level), two warpgroups, no atomic.
// It stages V_l (S_l rows of 64 channels, 128-byte swizzle) once and walks
// the query tiles of 64 rows; the g tile of the next tile loads by cp.async
// while the current one is worked on. Thread i holds point i % P of row
// i / P of each tile (msda_tap.cuh: a row's points in consecutive lanes).
// Per tile each warpgroup runs
//   dV[its three 64-pixel tiles] += A^T g   (A MN-major: the transpose bit),
//   dWf[q, s] = g V^T for the same three 64-pixel chunks (both K-major),
// while its threads merge the next tile's taps; dWf goes through
// registers into an f32 (64 x 6 blocks) buffer in shared memory, from
// which each thread picks the dw = dWf[q, pixel] of its point's corners,
// as the Pallas kernel picks them with its one-hot rows, and chains them
// to the point's dAttw and dLoc, written by this block only. dV lives in
// the warpgroups' registers (384 x 64 f32 over the two) until the last
// tile, then is rounded and written once: dValue is the same bits from run
// to run. Device-memory accesses follow the shared-memory proxy fences,
// which would otherwise wait for them. Shared memory (any level of at most
// 384 pixels): 48 KB of value rows, a 48 KB tap tile, two 8 KB g tiles and
// a 98 KB dWf buffer, 217,088 B. As in K3-bf16 the CUDA-core work around
// the products, not the products, sets its time (PERF.md).
//
// A level the tap kernel does not take (D other than 64, P other than 2
// or 4, S_l over 384) goes to the direct kernel, which scatters the Pallas
// kernel's merged weights (msda_tap::merged_weight: the first tap on a
// pixel scatters the rounded sum of the row's taps there) into an f32
// scratch with global atomics; the wrapper zeroes it first and rounds it
// to bf16 afterwards, and the order of the atomics varies from run to run.
// No main path of the recipe reaches it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <type_traits>

#include "msda_common.cuh"
#include "msda_tap.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int STAGED_WARPS = 32;
constexpr int DIRECT_WARPS = 8;
// per-warp corner tables after the two slices (ops/msda.py BWD_TABLE_BYTES)
constexpr int TABLE_BYTES = STAGED_WARPS * 16 * 8;

struct LevelList {
  int n;
  int id[msda::MAX_LEVELS];
};

using bf16 = __nv_bfloat16;

// element access: a read-only global element (float in K4, bf16 in the
// direct kernel's K4-bf16 instantiation) or channel pair as f32, a
// shared-memory pair, a rounded store
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const bf16* p) { return __bfloat162float(__ldg(p)); }
__device__ __forceinline__ float2 load_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 smem_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// the warp's sums of 16 values at once: returns sum over lanes of v[i] for
// i = lane >> 1 (each halving step keeps the half of the values its lane
// group owns and adds the partner's copy of them)
__device__ __forceinline__ float warp_sum16(const float (&v)[16], int lane) {
  float a[8], c[4], d[2];
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    a[k] = (b4 ? v[8 + k] : v[k]) + __shfl_xor_sync(FULL, b4 ? v[k] : v[8 + k], 16);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    c[k] = (b3 ? a[4 + k] : a[k]) + __shfl_xor_sync(FULL, b3 ? a[k] : a[4 + k], 8);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    d[k] = (b2 ? c[2 + k] : c[k]) + __shfl_xor_sync(FULL, b2 ? c[k] : c[2 + k], 4);
  const float e = (b1 ? d[1] : d[0]) + __shfl_xor_sync(FULL, b1 ? d[0] : d[1], 2);
  return e + __shfl_xor_sync(FULL, e, 1);
}

// dst[0] += a, dst[1] += b as one 64-bit compare-and-swap loop: the H100
// has no native f32 add on shared memory (atomicAdd compiles to a 32-bit
// CAS loop, ATOMS.CAST.SPIN), so one loop per channel pair halves the loops
__device__ __forceinline__ void atomic_add_pair(float* dst, float a, float b) {
  auto* p = reinterpret_cast<unsigned long long*>(dst);
  unsigned long long old = *p, seen;
  do {
    seen = old;
    const float2 v = make_float2(__uint_as_float((unsigned)seen) + a,
                                 __uint_as_float((unsigned)(seen >> 32)) + b);
    old = atomicCAS(p, seen, (unsigned long long)__float_as_uint(v.x) |
                                 ((unsigned long long)__float_as_uint(v.y) << 32));
  } while (old != seen);
}

// NP channel pairs per lane: pair j = lane + 32 r holds channels 2j, 2j+1
// (D even; the 64-bit shared accesses of a warp hit every bank once per
// half); f32 only
template <int NP>
__global__ void __launch_bounds__(STAGED_WARPS * 32, 1)
msda_bwd_kernel_staged(const float* __restrict__ value, const float* __restrict__ loc,
                       const float* __restrict__ attw, const float* __restrict__ grad,
                       float* __restrict__ dvalue, float* __restrict__ dloc,
                       float* __restrict__ dattw, int S, int M, int D, int Lq, int L, int P,
                       msda::Levels lv, LevelList staged) {
  extern __shared__ __align__(16) float smem[];
  int blk = blockIdx.x;
  const int l = staged.id[blk % staged.n];
  blk /= staged.n;
  const int m = blk % M, b = blk / M;
  const int H = lv.h[l], W = lv.w[l], Sl = H * W;
  const int stride = M * D;
  const size_t slice = ((size_t)b * S + lv.start[l]) * stride + (size_t)m * D;
  float* dvs = smem;                                   // (S_l, D) f32 dValue accumulator
  float* vs = smem + Sl * D;                           // (S_l, D) value rows
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  msda::stage_slice(vs, value + slice, Sl, D, stride, tid, blockDim.x);
  for (int x = tid; x < Sl * D; x += blockDim.x) dvs[x] = 0.f;
  msda::cp_async_wait_all();
  __syncthreads();

  // per warp, the (offset in the slice, scatter weight) of the 16 corners
  // of four points; -1 marks a dead corner
  int2* table = reinterpret_cast<int2*>(vs + Sl * D) + warp * 16;

  for (int q = warp; q < Lq; q += STAGED_WARPS) {
    const size_t bqm = (size_t)(b * Lq + q) * M + m;
    const size_t pt0 = (bqm * L + l) * P;
    float2 g[NP];                          // query q's g row
#pragma unroll
    for (int r = 0; r < NP; ++r) {
      const int ch = 2 * (lane + 32 * r);
      g[r] = ch < D ? load_pair(grad + bqm * D + ch) : make_float2(0.f, 0.f);
    }

    // lanes 2k and 2k+1 take corner k = 4 (lane >> 3) + ((lane >> 1) & 3)
    // of the four points at p0: point p0 + (lane >> 3), corner (lane >> 1) & 3
    for (int p0 = 0; p0 < P; p0 += 4) {
      const int p = p0 + (lane >> 3), c = (lane >> 1) & 3;
      float x = 0.f, y = 0.f, a = 0.f;
      if (p < P) {
        x = __ldg(loc + 2 * (pt0 + p));
        y = __ldg(loc + 2 * (pt0 + p) + 1);
        a = load(attw + pt0 + p);
      }
      const msda::Tap t = msda::make_tap(x, y, H, W);
      int pix;
      const bool live = p < P && msda::corner_pixel(t, c, H, W, pix);
      const float wc = msda::corner_weight(t, c);
      if ((lane & 1) == 0)
        table[lane >> 1] = make_int2(live ? pix * D : -1, __float_as_int(a * wc));
      __syncwarp();
      // all 16 rows read for dw first, then all 16 scattered
      float part[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        part[k] = 0.f;
        const int2 ek = table[k];
        if (ek.x < 0) continue;                 // warp-uniform
        const float* vr = vs + ek.x;
#pragma unroll
        for (int r = 0; r < NP; ++r) {
          const int ch = 2 * (lane + 32 * r);
          if (ch < D) {
            const float2 v = smem_pair(vr + ch);
            part[k] = fmaf(g[r].y, v.y, fmaf(g[r].x, v.x, part[k]));
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int2 ek = table[k];
        if (ek.x < 0) continue;
        const float wgt = __int_as_float(ek.y);
        float* dr = dvs + ek.x;
#pragma unroll
        for (int r = 0; r < NP; ++r) {
          const int ch = 2 * (lane + 32 * r);
          if (ch < D) atomic_add_pair(dr + ch, wgt * g[r].x, wgt * g[r].y);
        }
      }
      __syncwarp();
      // lane holds dw of its own corner k = lane >> 1; chain it to dAttw
      // and dLoc and sum over the point's four corners (lane bits 1 and 2)
      const float dw = warp_sum16(part, lane);
      float daw = wc * dw, dfx, dfy;
      msda::corner_dloc(t, c, a * dw, dfx, dfy);
#pragma unroll
      for (int o = 2; o <= 4; o <<= 1) {
        daw += __shfl_xor_sync(FULL, daw, o);
        dfx += __shfl_xor_sync(FULL, dfx, o);
        dfy += __shfl_xor_sync(FULL, dfy, o);
      }
      if ((lane & 7) == 0 && p < P) {
        store(dattw + pt0 + p, daw);
        dloc[2 * (pt0 + p)] = dfx * (float)W;
        dloc[2 * (pt0 + p) + 1] = dfy * (float)H;
      }
    }
  }
  __syncthreads();

  // the slice's dValue, each element written once
  if (D % 4 == 0) {
    const int C = D / 4;
    for (int x = tid; x < Sl * C; x += blockDim.x) {
      const int r = x / C, c4 = x - r * C;
      *reinterpret_cast<float4*>(dvalue + slice + (size_t)r * stride + 4 * c4) =
          *reinterpret_cast<const float4*>(dvs + r * D + 4 * c4);
    }
  } else {
    for (int x = tid; x < Sl * D; x += blockDim.x) {
      const int r = x / D, ch = x - r * D;
      dvalue[slice + (size_t)r * stride + ch] = dvs[x];
    }
  }
}

// levels whose bit is clear in staged_mask; dvalue32 of those levels
// zeroed by the caller: the dValue tensor itself at f32, an f32 scratch
// shaped like it at bf16
template <typename T, int CPL>
__global__ void __launch_bounds__(DIRECT_WARPS * 32)
msda_bwd_kernel_direct(const T* __restrict__ value, const float* __restrict__ loc,
                       const T* __restrict__ attw, const T* __restrict__ grad,
                       float* __restrict__ dvalue32, float* __restrict__ dloc,
                       T* __restrict__ dattw, int B, int S, int M, int D, int Lq, int L,
                       int P, msda::Levels lv, unsigned staged_mask) {
  const int warp = blockIdx.x * DIRECT_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= B * Lq * M) return;       // warp-uniform
  const int m = warp % M;
  const int b = warp / M / Lq;

  const int stride_s = M * D;
  const size_t vbase = (size_t)b * S * stride_s + (size_t)m * D;
  const float* locp = loc + (size_t)warp * L * P * 2;
  const T* awp = attw + (size_t)warp * L * P;
  const T* gp = grad + (size_t)warp * D;      // (B, Lq, M, D) == (B, Lq, M*D)

  float gr[CPL];
#pragma unroll
  for (int r = 0; r < CPL; ++r) {
    const int c = lane + 32 * r;
    gr[r] = c < D ? load(gp + c) : 0.f;
  }

  for (int l = 0; l < L; ++l) {
    if ((staged_mask >> l) & 1u) continue;
    const int H = lv.h[l], W = lv.w[l];
    const size_t lbase = vbase + (size_t)lv.start[l] * stride_s;
    for (int p = 0; p < P; ++p) {
      const int t = l * P + p;
      const msda::Tap tp = msda::make_tap(__ldg(locp + 2 * t), __ldg(locp + 2 * t + 1), H, W);
      const float aw = load(awp + t);
      float daw = 0.f, dfx = 0.f, dfy = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        int pix;
        if (!msda::corner_pixel(tp, c4, H, W, pix)) continue;   // warp-uniform
        const size_t row = lbase + (size_t)pix * stride_s;
        const float wc = msda::corner_weight(tp, c4);
        // the weight the tap scatters into dValue: attw * w_c at f32; at
        // bf16 the Pallas kernel's (msda_tap::merged_weight), none but the
        // first tap on a pixel scattering
        bool first = true;
        float wgt = aw * wc;
        if constexpr (std::is_same<T, bf16>::value)
          wgt = msda_tap::merged_weight(locp + 2 * l * P, awp + l * P, P, H, W, p, c4, pix, first);
        float part = 0.f;
#pragma unroll
        for (int r = 0; r < CPL; ++r) {
          const int c = lane + 32 * r;
          if (c < D) {
            part = fmaf(gr[r], load(value + row + c), part);
            if (first) atomicAdd(dvalue32 + row + c, wgt * gr[r]);
          }
        }
        const float dw = warp_sum(part);
        float tx, ty;
        msda::corner_dloc(tp, c4, aw * dw, tx, ty);
        daw = fmaf(wc, dw, daw);
        dfx += tx;
        dfy += ty;
      }
      if (lane == 0) {
        store(dattw + (size_t)warp * L * P + t, daw);
        dloc[((size_t)warp * L * P + t) * 2] = dfx * (float)W;
        dloc[((size_t)warp * L * P + t) * 2 + 1] = dfy * (float)H;
      }
    }
  }
}

LevelList levels_in(unsigned mask, int L, int& max_sl, const msda::Levels& lv) {
  LevelList list{0, {}};
  max_sl = 0;
  for (int l = 0; l < L; ++l) {
    if (!((mask >> l) & 1u)) continue;
    list.id[list.n++] = l;
    if (lv.h[l] * lv.w[l] > max_sl) max_sl = lv.h[l] * lv.w[l];
  }
  return list;
}

// the direct kernel over the levels whose bit is clear in `mask`
template <typename T, int CPL>
void launch_direct(const T* value, const float* loc, const T* attw, const T* grad,
                   float* dvalue32, float* dloc, T* dattw, int B, int S, int M, int D, int Lq,
                   int L, int P, const msda::Levels& lv, unsigned mask, cudaStream_t s) {
  const long long warps = (long long)B * Lq * M;
  msda_bwd_kernel_direct<T, CPL><<<(unsigned)((warps + DIRECT_WARPS - 1) / DIRECT_WARPS),
                                   DIRECT_WARPS * 32, 0, s>>>(
      value, loc, attw, grad, dvalue32, dloc, dattw, B, S, M, D, Lq, L, P, lv, mask);
}

template <int CPL>
int launch_f32(const float* value, const float* loc, const float* attw, const float* grad,
               float* dvalue, float* dloc, float* dattw, int B, int S, int M, int D, int Lq,
               int L, int P, const msda::Levels& lv, unsigned staged_mask, cudaStream_t s) {
  int max_sl;
  const LevelList staged = levels_in(staged_mask, L, max_sl, lv);
  if (staged.n > 0) {
    const long long smem = (long long)(2 * sizeof(float)) * max_sl * D + TABLE_BYTES;
    if (smem > msda::SMEM_MAX || D % 2) return static_cast<int>(cudaErrorInvalidValue);
    static bool attr_set[16] = {};
    const int err = hopper_host::allow_smem(msda_bwd_kernel_staged<(CPL + 1) / 2>,
                                            msda::SMEM_MAX, attr_set);
    if (err) return err;
    msda_bwd_kernel_staged<(CPL + 1) / 2><<<(unsigned)(B * M * staged.n), STAGED_WARPS * 32, smem, s>>>(
        value, loc, attw, grad, dvalue, dloc, dattw, S, M, D, Lq, L, P, lv, staged);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (staged.n < L)
    launch_direct<float, CPL>(value, loc, attw, grad, dvalue, dloc, dattw, B, S, M, D, Lq, L, P,
                              lv, staged_mask, s);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ K4-bf16 tap kernel
using msda_tap::TILE_BYTES;
constexpr int TAP_WG = 2;                  // warpgroups of the tap kernel
constexpr int TAP_MT = 3;                  // 64-pixel tiles (and chunks) a warpgroup
constexpr int TAP_MAX_BLOCKS = TAP_WG * TAP_MT;   // S_l <= 384
// byte offsets in the tap kernel's shared memory, from its base aligned to
// 1024 bytes (ops/msda.py TAP_BWD_SMEM counts the same bytes): value rows
// and the tap tile in TAP_MAX_BLOCKS blocks of 64 pixels, two g tiles, dWf
// as 64 rows of DW_STRIDE floats (rows 8 banks apart: the 64-bit stores of
// a half-warp hit 32 banks), 4 bytes a thread of scratch
constexpr int DW_STRIDE = 64 * TAP_MAX_BLOCKS + 8;
constexpr int OFF_V = 0, OFF_A = TAP_MAX_BLOCKS * TILE_BYTES, OFF_G = 2 * OFF_A;
constexpr int OFF_DW = OFF_G + 2 * TILE_BYTES;
constexpr int OFF_TRASH = OFF_DW + 64 * DW_STRIDE * 4;
constexpr int TAP_BWD_BYTES = OFF_TRASH + TAP_WG * 128 * 4 + 1024;

// rows q0.. q0 + 63 of g[b, :, m, :] into a swizzled tile, zero past Lq
__device__ __forceinline__ void stage_g(uint8_t* dst, const bf16* grad, int b, int m, int M,
                                        int Lq, int q0, int tid, int threads) {
  for (int x = tid; x < msda_tap::ROWS * 8; x += threads) {
    const int r = x >> 3, k = x & 7;
    uint8_t* d = dst + r * 128 + (((k ^ r) & 7) << 4);
    if (q0 + r < Lq)
      msda::cp_async16(d, grad + ((size_t)(b * Lq + q0 + r) * M + m) * msda_tap::D + 8 * k);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Thread i holds point i % P of query row i / P of the tile (the row's P
// points in consecutive lanes of one warp): its four taps, merged with the
// row's others while the products of the previous tile run, and the chain
// of their dw into the point's dAttw and dLoc. All threads issue the
// products of their warpgroup's pixel tiles: dV for tiles wg, wg + 2,
// wg + 4 and dWf for the same chunks, all chains of four products (a level
// of fewer blocks runs the missing ones on zero rows and keeps nothing of
// them).
template <int P>
__global__ void __launch_bounds__(TAP_WG * 128, 1)
msda_bwd_kernel_tap_bf16(const bf16* __restrict__ value, const float* __restrict__ loc,
                         const bf16* __restrict__ attw, const bf16* __restrict__ grad,
                         bf16* __restrict__ dvalue, float* __restrict__ dloc,
                         bf16* __restrict__ dattw, int S, int M, int Lq, int L,
                         msda::Levels lv, LevelList tap) {
  using msda_tap::D;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  int blk = blockIdx.x;
  const int l = tap.id[blk % tap.n];
  blk /= tap.n;
  const int m = blk % M, b = blk / M;
  const int H = lv.h[l], W = lv.w[l], Sl = H * W;
  const size_t stride = (size_t)M * D;
  const size_t slice = ((size_t)b * S + lv.start[l]) * stride + (size_t)m * D;
  uint8_t* V = smem + OFF_V;
  uint8_t* A = smem + OFF_A;
  uint8_t* G = smem + OFF_G;
  float* DW = reinterpret_cast<float*>(smem + OFF_DW);
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int n_tiles = (Lq + msda_tap::ROWS - 1) / msda_tap::ROWS;
  const int row = tid / P, point = tid % P;

  // V_l and zero rows up to TAP_MAX_BLOCKS blocks, the first g tile, the
  // tap tile zeroed once
  msda_tap::stage_rows(V, value + slice, Sl, stride, tid, blockDim.x);
  msda_tap::zero_bytes(V + Sl * 128, (64 * TAP_MAX_BLOCKS - Sl) * 128, tid, blockDim.x);
  stage_g(G, grad, b, m, M, Lq, 0, tid, blockDim.x);
  msda_tap::cp_async_commit();
  msda_tap::zero_bytes(A, TAP_MAX_BLOCKS * TILE_BYTES, tid, blockDim.x);
  __syncthreads();

  // this thread's point index in tile t; whether it has a point there
  auto index = [&](int t) {
    return (((size_t)(b * Lq + t * msda_tap::ROWS + row) * M + m) * L + l) * P + point;
  };
  auto valid = [&](int t) {
    return row < msda_tap::ROWS && t < n_tiles && t * msda_tap::ROWS + row < Lq;
  };
  msda_tap::PointTaps cur, nxt;                    // this point's taps in this tile, the next
  msda_tap::Point pt = msda_tap::load_point(loc, attw, index(0), valid(0));
  msda_tap::merge_point<P>(pt, point, valid(0), H, W, cur);
  uint8_t* trash = smem + OFF_TRASH + 4 * tid;
  msda_tap::write_point(A, trash, row, cur, false);
  pt = msda_tap::load_point(loc, attw, index(1), valid(1));
  float sa = 0.f, sx = 0.f, sy = 0.f;              // the chain of the previous tile

  float dv[TAP_MT][32];
#pragma unroll
  for (int k = 0; k < TAP_MT; ++k)
#pragma unroll
    for (int i = 0; i < 32; ++i) dv[k][i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    msda_tap::cp_async_wait<0>();                  // this tile's g (and, first, V_l)
    hopper::fence_async_smem();
    __syncthreads();                               // this tile's taps and g are whole
    // device memory after the fence, which would wait for it: the next g
    // tile, the previous tile's dAttw and dLoc, the points of tile t + 2
    if (t + 1 < n_tiles)
      stage_g(G + ((t + 1) & 1) * TILE_BYTES, grad, b, m, M, Lq, (t + 1) * msda_tap::ROWS, tid,
              blockDim.x);
    msda_tap::cp_async_commit();
    if (t > 0 && valid(t - 1)) {
      const size_t i = index(t - 1);
      dattw[i] = __float2bfloat16_rn(sa);
      *reinterpret_cast<float2*>(dloc + 2 * i) = make_float2(sx * (float)W, sy * (float)H);
    }
    const msda_tap::Point pt2 = msda_tap::load_point(loc, attw, index(t + 2), valid(t + 2));

    // dV[tiles wg + 2k] += A^T g (A MN-major); dWf[:, chunks wg + 2k] = g V^T,
    // the first two chunks beside dV, the third after them
    const uint8_t* gt = G + (t & 1) * TILE_BYTES;
    const int ra = hopper::acc_row(wt, 0), rb = hopper::acc_row(wt, 2);
    float w[2][32];
    auto chunk = [&](int k, float (&acc)[32], int kk) {
      hopper::wgmma_ss_n64(acc, hopper::desc<64>(gt + 32 * kk),
                           hopper::desc<64>(V + (wg + TAP_WG * k) * TILE_BYTES + 32 * kk), kk > 0);
    };
    auto store = [&](int k, const float (&acc)[32]) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = 64 * (wg + TAP_WG * k) + hopper::acc_col(wt, jj, 0);
        *reinterpret_cast<float2*>(DW + ra * DW_STRIDE + c) = make_float2(acc[4 * jj], acc[4 * jj + 1]);
        *reinterpret_cast<float2*>(DW + rb * DW_STRIDE + c) =
            make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
      }
    };
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int k = 0; k < TAP_MT; ++k)
        hopper::wgmma_ss_n64_t<1, 1>(
            dv[k], hopper::desc<64>(A + (wg + TAP_WG * k) * TILE_BYTES + kk * 2048),
            hopper::desc<64>(gt + kk * 2048), 1);
      chunk(0, w[0], kk);
      chunk(1, w[1], kk);
    }
    hopper::wg_commit();
    msda_tap::merge_point<P>(pt, point, valid(t + 1), H, W, nxt);   // the next tile's taps
    pt = pt2;
    hopper::wg_wait<0>();
    hopper::fence_regs(w[0]);
    hopper::fence_regs(w[1]);
    store(0, w[0]);
    store(1, w[1]);
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) chunk(2, w[0], kk);
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::fence_regs(w[0]);
#pragma unroll
    for (int k = 0; k < TAP_MT; ++k) hopper::fence_regs(dv[k]);
    store(2, w[0]);
    __syncthreads();                               // the tap tile read; dWf whole

    // the chain of this point's taps: dw picked from dWf, summed over its
    // four corners in corner order as the plain version sums them
    if (valid(t)) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float dw = cur.pix[c] >= 0 ? DW[row * DW_STRIDE + cur.pix[c]] : 0.f;
        float dfx, dfy;
        msda::corner_dloc(cur.tap, c, cur.a * dw, dfx, dfy);
        const float da = msda::corner_weight(cur.tap, c) * dw;
        sa = c ? sa + da : da;
        sx = c ? sx + dfx : dfx;
        sy = c ? sy + dfy : dfy;
      }
    }
    // this tile's entries out, the next's in; the row's other points are
    // in this warp and may write where this lane clears
    msda_tap::write_point(A, trash, row, cur, true);
    __syncwarp();
    msda_tap::write_point(A, trash, row, nxt, false);
    cur = nxt;
  }
  if (valid(n_tiles - 1)) {                        // the last tile's dAttw and dLoc
    const size_t i = index(n_tiles - 1);
    dattw[i] = __float2bfloat16_rn(sa);
    *reinterpret_cast<float2*>(dloc + 2 * i) = make_float2(sx * (float)W, sy * (float)H);
  }

  // dValue of the slice, rounded once
  const int ra = hopper::acc_row(wt, 0), rb = hopper::acc_row(wt, 2);
#pragma unroll
  for (int k = 0; k < TAP_MT; ++k) {
    const int i = wg + TAP_WG * k;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = hopper::acc_col(wt, jj, 0);
      const int sa = 64 * i + ra, sb = 64 * i + rb;
      if (sa < Sl)
        *reinterpret_cast<__nv_bfloat162*>(dvalue + slice + (size_t)sa * stride + c) =
            __floats2bfloat162_rn(dv[k][4 * jj], dv[k][4 * jj + 1]);
      if (sb < Sl)
        *reinterpret_cast<__nv_bfloat162*>(dvalue + slice + (size_t)sb * stride + c) =
            __floats2bfloat162_rn(dv[k][4 * jj + 2], dv[k][4 * jj + 3]);
    }
  }
}

template <int P>
int launch_tap_p(const bf16* v, const float* lc, const bf16* aw, const bf16* g, bf16* dv,
                 float* dl, bf16* da, int B, int S, int M, int Lq, int L,
                 const msda::Levels& lv, const LevelList& tap, cudaStream_t s) {
  static bool attr_set[16] = {};
  const int err = hopper_host::allow_smem(msda_bwd_kernel_tap_bf16<P>, msda::SMEM_MAX, attr_set);
  if (err) return err;
  msda_bwd_kernel_tap_bf16<P><<<(unsigned)(B * M * tap.n), TAP_WG * 128, TAP_BWD_BYTES, s>>>(
      v, lc, aw, g, dv, dl, da, S, M, Lq, L, lv, tap);
  return static_cast<int>(cudaGetLastError());
}

template <int CPL>
int launch_bf16(const bf16* v, const float* lc, const bf16* aw, const bf16* g, bf16* dv,
                float* dv32, float* dl, bf16* da, int B, int S, int M, int D, int Lq, int L,
                int P, const msda::Levels& lv, unsigned tap_mask, cudaStream_t s) {
  int max_sl;
  const LevelList tap = levels_in(tap_mask, L, max_sl, lv);
  if (tap.n > 0 && B * M > 0 && Lq > 0) {
    if (D != msda_tap::D || (P != 2 && P != 4) ||
        max_sl > 64 * TAP_MAX_BLOCKS || TAP_BWD_BYTES > msda::SMEM_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    const int err = P == 2 ? launch_tap_p<2>(v, lc, aw, g, dv, dl, da, B, S, M, Lq, L, lv, tap, s)
                           : launch_tap_p<4>(v, lc, aw, g, dv, dl, da, B, S, M, Lq, L, lv, tap, s);
    if (err) return err;
  }
  if (tap.n < L)
    launch_direct<bf16, CPL>(v, lc, aw, g, dv32, dl, da, B, S, M, D, Lq, L, P, lv, tap_mask, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// value (B, S, M, D), loc (B, Lq, M, L, P, 2), attw (B, Lq, M, L, P),
// grad (B, Lq, M*D); outputs dvalue (B, S, M, D), dloc and dattw shaped
// like loc and attw. All f32, contiguous and 16-byte aligned. shapes: host
// array of L (H, W) pairs. Levels whose bit is set in staged_mask take the
// staged kernel, which writes their dValue slices whole; the others take
// the direct kernel, whose dValue slices the caller must have zeroed.
// Returns cudaGetLastError() after the launches.
extern "C" int msda_bwd_f32(const void* value, const void* loc, const void* attw,
                            const void* grad, void* dvalue, void* dloc, void* dattw,
                            int B, int S, int M, int D, int Lq, int L, int P,
                            const int* shapes, int staged_mask, void* stream) {
  msda::Levels lv;
  if (!msda::make_levels(shapes, L, S, lv) || D < 1 || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* v = static_cast<const float*>(value);
  const auto* lc = static_cast<const float*>(loc);
  const auto* aw = static_cast<const float*>(attw);
  const auto* g = static_cast<const float*>(grad);
  auto* dv = static_cast<float*>(dvalue);
  auto* dl = static_cast<float*>(dloc);
  auto* da = static_cast<float*>(dattw);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto mask = static_cast<unsigned>(staged_mask);
  if (D <= 32) return launch_f32<1>(v, lc, aw, g, dv, dl, da, B, S, M, D, Lq, L, P, lv, mask, s);
  if (D <= 64) return launch_f32<2>(v, lc, aw, g, dv, dl, da, B, S, M, D, Lq, L, P, lv, mask, s);
  return launch_f32<4>(v, lc, aw, g, dv, dl, da, B, S, M, D, Lq, L, P, lv, mask, s);
}

// K4-bf16: value, attw, grad, dvalue and dattw bf16, loc and dloc f32;
// D a multiple of 8 up to 128. Levels whose bit is set in tap_mask take the
// tap kernel (D 64, P 2 or 4, S_l <= 384), which writes their dValue slices
// whole; the others take the direct kernel, which scatters into dvalue32,
// an f32 (B, S, M, D) scratch whose slices of those levels the caller has
// zeroed and afterwards rounds into dvalue (unused, may be null, when every
// level takes the tap kernel). Returns cudaGetLastError() after the
// launches.
extern "C" int msda_bwd_bf16(const void* value, const void* loc, const void* attw,
                             const void* grad, void* dvalue, void* dvalue32, void* dloc,
                             void* dattw, int B, int S, int M, int D, int Lq, int L, int P,
                             const int* shapes, int tap_mask, void* stream) {
  msda::Levels lv;
  if (!msda::make_levels(shapes, L, S, lv) || D < 8 || D > 128 || D % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* v = static_cast<const bf16*>(value);
  const auto* lc = static_cast<const float*>(loc);
  const auto* aw = static_cast<const bf16*>(attw);
  const auto* g = static_cast<const bf16*>(grad);
  auto* dv = static_cast<bf16*>(dvalue);
  auto* dv32 = static_cast<float*>(dvalue32);
  auto* dl = static_cast<float*>(dloc);
  auto* da = static_cast<bf16*>(dattw);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto mask = static_cast<unsigned>(tap_mask);
  if (D <= 32) return launch_bf16<1>(v, lc, aw, g, dv, dv32, dl, da, B, S, M, D, Lq, L, P, lv, mask, s);
  if (D <= 64) return launch_bf16<2>(v, lc, aw, g, dv, dv32, dl, da, B, S, M, D, Lq, L, P, lv, mask, s);
  return launch_bf16<4>(v, lc, aw, g, dv, dv32, dl, da, B, S, M, D, Lq, L, P, lv, mask, s);
}
