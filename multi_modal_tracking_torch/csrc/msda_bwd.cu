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
// bf16 (K4-bf16). Both kernels are templates of the element type T of
// value, attw, g, dValue and dAttw (locations and dLoc stay f32), and the
// bf16 instantiations replace `_msda_bwd_kernel` at acc_dtype bf16, the
// dtype the JAX package trains in, with its rounding points
// (ops/msda.py:377-418): each tap weight attw * w_c is formed in f32 and
// rounded to bf16 for dValue; dValue = A^T g accumulates in f32 (each
// product of two bf16 values is exact in f32) and is rounded to bf16 once;
// dw = <g, V> of the bf16 rows accumulates in f32; the chain into dLoc
// (f32) and dAttw (rounded to bf16) runs in f32 on the unrounded attw and
// bilinear weights. Bytes bound it as they bound K4, half of them bf16:
// 45 MB a call at the training shape, 0.013 ms at 3.35 TB/s. The staged
// slice is bf16 beside an f32 accumulator (18*18*64*2 + 18*18*64*4 =
// 124,416 B at the training shape); a direct level scatters into an f32
// scratch with global atomics, which the wrapper zeroes and then rounds to
// bf16 (a bf16 atomic would round at every add). Drift from the Pallas kernel: it sums the rounded weights of
// the taps of one query and head that fall on the same source pixel and
// rounds that sum again before A^T g; these kernels scatter each rounded
// tap weight on its own, as K3-bf16 applies them (msda.cu), one rounding
// fewer: where taps share a pixel, dValue moves by at most 2^-9 of that
// pixel's summed weight times g (measured in chip_smoke.py and PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <type_traits>

#include "msda_common.cuh"

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

// element access of the two instantiations, float (K4) and bf16 (K4-bf16):
// a read-only global element or channel pair as f32, a shared-memory pair
// as f32, a rounded store
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const bf16* p) { return __bfloat162float(__ldg(p)); }
__device__ __forceinline__ float2 load_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
__device__ __forceinline__ float2 smem_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 smem_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

// the weight a tap scatters into dValue: attw * w_c, rounded to bf16 at
// bf16 (the Pallas kernel's w.astype(acc_dtype))
template <typename T>
__device__ __forceinline__ float scatter_weight(float a, float wc) {
  if constexpr (std::is_same<T, bf16>::value)
    return __bfloat162float(__float2bfloat16_rn(a * wc));
  else
    return a * wc;
}

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
// (D even; 64-bit (f32) or 32-bit (bf16) shared accesses of a warp hit
// every bank once per half)
template <typename T, int NP>
__global__ void __launch_bounds__(STAGED_WARPS * 32, 1)
msda_bwd_kernel_staged(const T* __restrict__ value, const float* __restrict__ loc,
                       const T* __restrict__ attw, const T* __restrict__ grad,
                       T* __restrict__ dvalue, float* __restrict__ dloc,
                       T* __restrict__ dattw, int S, int M, int D, int Lq, int L, int P,
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
  T* vs = reinterpret_cast<T*>(smem + Sl * D);         // (S_l, D) value rows
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  if constexpr (std::is_same<T, float>::value) {
    msda::stage_slice(vs, value + slice, Sl, D, stride, tid, blockDim.x);
  } else {                                             // D % 8 == 0 (the wrapper's check)
    const int C = D / 8;
    for (int x = tid; x < Sl * C; x += blockDim.x) {
      const int r = x / C, c = x - r * C;
      msda::cp_async16(vs + r * D + 8 * c, value + slice + (size_t)r * stride + 8 * c);
    }
  }
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
        table[lane >> 1] = make_int2(live ? pix * D : -1, __float_as_int(scatter_weight<T>(a, wc)));
      __syncwarp();
      // all 16 rows read for dw first, then all 16 scattered
      float part[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        part[k] = 0.f;
        const int2 ek = table[k];
        if (ek.x < 0) continue;                 // warp-uniform
        const T* vr = vs + ek.x;
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

  // the slice's dValue, each element written once (rounded once at bf16)
  if constexpr (std::is_same<T, float>::value) {
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
  } else {                                             // D % 8 == 0
    const int C = D / 4;
    for (int x = tid; x < Sl * C; x += blockDim.x) {
      const int r = x / C, c4 = x - r * C;
      const float4 f = *reinterpret_cast<const float4*>(dvs + r * D + 4 * c4);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(f.x, f.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(f.z, f.w);
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&lo);
      packed.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(dvalue + slice + (size_t)r * stride + 4 * c4) = packed;
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
        const float wgt = scatter_weight<T>(aw, wc);
        float part = 0.f;
#pragma unroll
        for (int r = 0; r < CPL; ++r) {
          const int c = lane + 32 * r;
          if (c < D) {
            part = fmaf(gr[r], load(value + row + c), part);
            atomicAdd(dvalue32 + row + c, wgt * gr[r]);
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

template <typename T, int CPL>
int launch(const T* value, const float* loc, const T* attw, const T* grad, T* dvalue,
           float* dvalue32, float* dloc, T* dattw, int B, int S, int M, int D, int Lq, int L,
           int P, const msda::Levels& lv, unsigned staged_mask, cudaStream_t s) {
  LevelList staged{0, {}};
  int max_sl = 0;
  for (int l = 0; l < L; ++l) {
    if (!((staged_mask >> l) & 1u)) continue;
    staged.id[staged.n++] = l;
    if (lv.h[l] * lv.w[l] > max_sl) max_sl = lv.h[l] * lv.w[l];
  }
  if (staged.n > 0) {
    const long long smem = (long long)(sizeof(float) + sizeof(T)) * max_sl * D + TABLE_BYTES;
    if (smem > msda::SMEM_MAX || D % 2) return static_cast<int>(cudaErrorInvalidValue);
    // the shared-memory attribute belongs to each device's context: set it
    // once per device
    constexpr int MAX_DEVICES = 64;
    static bool attr_set[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= MAX_DEVICES || !attr_set[dev]) {
      err = cudaFuncSetAttribute(msda_bwd_kernel_staged<T, (CPL + 1) / 2>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, msda::SMEM_MAX);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < MAX_DEVICES) attr_set[dev] = true;
    }
    msda_bwd_kernel_staged<T, (CPL + 1) / 2><<<(unsigned)(B * M * staged.n), STAGED_WARPS * 32, smem, s>>>(
        value, loc, attw, grad, dvalue, dloc, dattw, S, M, D, Lq, L, P, lv, staged);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (staged.n < L) {
    const long long warps = (long long)B * Lq * M;
    msda_bwd_kernel_direct<T, CPL><<<(unsigned)((warps + DIRECT_WARPS - 1) / DIRECT_WARPS),
                                     DIRECT_WARPS * 32, 0, s>>>(
        value, loc, attw, grad, dvalue32, dloc, dattw, B, S, M, D, Lq, L, P, lv, staged_mask);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_any(const void* value, const void* loc, const void* attw, const void* grad,
               void* dvalue, void* dvalue32, void* dloc, void* dattw, int B, int S, int M,
               int D, int Lq, int L, int P, const int* shapes, int staged_mask, void* stream) {
  msda::Levels lv;
  if (!msda::make_levels(shapes, L, S, lv) || D < 1 || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* v = static_cast<const T*>(value);
  const auto* lc = static_cast<const float*>(loc);
  const auto* aw = static_cast<const T*>(attw);
  const auto* g = static_cast<const T*>(grad);
  auto* dv = static_cast<T*>(dvalue);
  auto* dv32 = static_cast<float*>(dvalue32);
  auto* dl = static_cast<float*>(dloc);
  auto* da = static_cast<T*>(dattw);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto mask = static_cast<unsigned>(staged_mask);
  if (D <= 32) return launch<T, 1>(v, lc, aw, g, dv, dv32, dl, da, B, S, M, D, Lq, L, P, lv, mask, s);
  if (D <= 64) return launch<T, 2>(v, lc, aw, g, dv, dv32, dl, da, B, S, M, D, Lq, L, P, lv, mask, s);
  return launch<T, 4>(v, lc, aw, g, dv, dv32, dl, da, B, S, M, D, Lq, L, P, lv, mask, s);
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
  return launch_any<float>(value, loc, attw, grad, dvalue, dvalue, dloc, dattw, B, S, M, D, Lq,
                           L, P, shapes, staged_mask, stream);
}

// K4-bf16: value, attw, grad, dvalue and dattw bf16, loc and dloc f32;
// D a multiple of 8 up to 128. The direct kernel's levels scatter into
// dvalue32, an f32 (B, S, M, D) scratch whose slices of those levels the
// caller has zeroed and afterwards rounds into dvalue (unused, may be null,
// when every level is staged). Otherwise as msda_bwd_f32.
extern "C" int msda_bwd_bf16(const void* value, const void* loc, const void* attw,
                             const void* grad, void* dvalue, void* dvalue32, void* dloc,
                             void* dattw, int B, int S, int M, int D, int Lq, int L, int P,
                             const int* shapes, int staged_mask, void* stream) {
  if (D % 8) return static_cast<int>(cudaErrorInvalidValue);
  return launch_any<bf16>(value, loc, attw, grad, dvalue, dvalue32, dloc, dattw, B, S, M, D,
                          Lq, L, P, shapes, staged_mask, stream);
}
