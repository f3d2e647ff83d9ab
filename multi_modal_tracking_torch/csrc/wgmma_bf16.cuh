// Hopper (sm_90a) building blocks of the bf16 attention kernels K1-bf16
// (mixed_attention_bf16.cu) and K2-bf16 (mixed_attention_bwd_bf16.cu) and
// of the bf16 MSDA tap kernels (msda_tap.cuh): warpgroup MMAs (wgmma) with
// bf16 operands and f32 accumulators, TMA tile loads completed on
// mbarriers, and the host-side tensor maps.
//
// Tiles. Every operand tile is rows x D bf16, row-major, D in {16, 32, 64},
// so a row is 32, 64 or 128 bytes; TMA writes it swizzled to its width
// (CU_TENSOR_MAP_SWIZZLE_32B / 64B / 128B) and wgmma reads it through a
// descriptor of the same swizzle. Each 8-row group of a tile is one swizzle
// atom of 8 * 2D bytes, and tiles sit on 1024-byte boundaries (so every
// atom starts aligned and the descriptors' base offset is 0).
//   K-major (reduction over D; S = Q K^T, dP = g V^T and their transposes):
//     a 16-wide slice of D starts 32 bytes further into each row.
//   MN-major (reduction over the rows, trans-b = 1; O += P V, dQ += dS K,
//     dV += P^T g, dK += dS^T Q): a 16-row slice starts 16 rows further on;
//     the tile's D columns are one atom wide, so no transposed copy is made.
// In both, the stride between 8-row groups is 8 * 2D bytes; it is written
// into both offset fields of the descriptor (the other one is unused by
// these layouts).
//
// Fragments of m64nNk16 with f32 accumulators: warp w of the warpgroup owns
// rows 16w..16w+15; lane = 4 * g + t holds, for each 8-column block j,
//   d[4j + 0], d[4j + 1]: row 16w + g,     columns 8j + 2t, 8j + 2t + 1
//   d[4j + 2], d[4j + 3]: row 16w + g + 8, columns 8j + 2t, 8j + 2t + 1
// and the A fragment of a register operand (16 rows x 16, bf16 pairs) is
//   a[0]: row g, 2t..2t+1   a[1]: row g+8, 2t..2t+1
//   a[2]: row g, 2t+8..     a[3]: row g+8, 2t+8..
// so the accumulators of columns 16k..16k+15 of one product, rounded and
// packed in pairs (`acc_as_a`), are the A operand of the next product over
// those 16 columns: P and dS never leave the registers.
//
// After each `wait`, the accumulators and register operands of the products
// it waited for go through `fence_regs`, so the compiler neither reads an
// accumulator nor reuses an A register while a wgmma is in flight.
#pragma once
#include <cuda.h>          // CUtensorMap and its enums only: nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

using bf16 = __nv_bfloat16;
constexpr float NEG_INF = -1e30f;   // the Pallas kernel's finite mask value

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also announces `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// waits until the barrier's phase with parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// register budget of the warpgroup that runs it (all 4 warps, together):
// the producer gives registers back, the consumers take them
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// named barrier over the first `threads` threads (id 0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------------------- TMA
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// the box at (c0, c1, c2) of a 3-D map into `dst`, completing on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// the box at (c0, c1) of a 2-D map into `dst`, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// ----------------------------------------------------------------- wgmma
// descriptor of a tile of D-wide bf16 rows (D = 16, 32, 64) in the swizzle
// TMA wrote it with; `smem` must lie on the tile's 8-row grid (or 32 bytes
// along a row of it, for a K-major slice)
template <int D>
__device__ __forceinline__ uint64_t desc(const void* smem) {
  static_assert(D == 16 || D == 32 || D == 64, "head dim 16, 32 or 64");
  constexpr uint64_t mode = D == 64 ? 1 : D == 32 ? 2 : 3;   // 128B, 64B, 32B swizzle
  constexpr uint64_t group = (8 * 2 * D) >> 4;               // 8 rows, in 16-byte units
  return ((smem_u32(smem) & 0x3FFFF) >> 4) | (group << 16) | (group << 32) | (mode << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// D (64 x 64) += A B, A (64 x 16) and B (16 x 64) in shared memory, each
// K-major (0) or MN-major (1, read through the transpose bit): S = Q K^T
// (0, 0; B transposed), the MSDA tap-matrix products out = A V (0, 1) and
// dV = A^T g (1, 1); scale_d 0 overwrites D
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64_t(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 64) += A B^T, A (64 x 16) and B (64 x 16) both K-major in shared
// memory; scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  wgmma_ss_n64_t<0, 0>(d, desc_a, desc_b, scale_d);
}

// generic-proxy writes to shared memory (st.shared, cp.async) made visible
// to the async proxy that wgmma reads through; before the barrier that
// hands the tile to the warpgroups. It waits for the thread's device-memory
// accesses still in flight too: issue those after it.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// D (64 x 16) += A B, A (64 x 16) bf16 in registers (the m16n8k16 A fragment
// of each warp's 16 rows), B (16 x 16) MN-major in shared memory; scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D (64 x 32) += A B, A (64 x 16) bf16 in registers (the m16n8k16 A fragment
// of each warp's 16 rows), B (16 x 32) MN-major in shared memory; scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64) += A B, A (64 x 16) bf16 in registers (the m16n8k16 A fragment
// of each warp's 16 rows), B (16 x 64) MN-major in shared memory; scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}


// D (64 x N) += A B with N = D_HEAD in {16, 32, 64}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, desc_b, scale_d);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, desc_b, scale_d);
  else wgmma_rs_n64(d, a, desc_b, scale_d);
}

// two floats rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// the A fragment of columns 16k..16k+15 from a 64-column accumulator
template <int K>
__device__ __forceinline__ void acc_as_a(uint32_t (&a)[4], const float (&d)[32]) {
  a[0] = pack(d[8 * K + 0], d[8 * K + 1]);
  a[1] = pack(d[8 * K + 2], d[8 * K + 3]);
  a[2] = pack(d[8 * K + 4], d[8 * K + 5]);
  a[3] = pack(d[8 * K + 6], d[8 * K + 7]);
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x in one MUFU instruction (relative error below 2^-21; results below
// 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// row sums and maxima across the 4 lanes of a quad (one accumulator row)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// rows 16w + g (e = 0, 1) and 16w + g + 8 (e = 2, 3) of a wgmma
// accumulator, lane = 4 * g + t, warp w of the warpgroup
__device__ __forceinline__ int acc_row(int wt, int e) {
  return 16 * (wt / 32) + (wt % 32) / 4 + (e & 2) * 4;
}
// column of d[4j + e]
__device__ __forceinline__ int acc_col(int wt, int j, int e) {
  return 8 * j + 2 * (wt % 4) + (e & 1);
}

// the accumulator rows of a 64 x 2N tile to bf16 rows of a row-major
// (n_rows, N) matrix, rows past n_rows skipped
template <int N>
__device__ __forceinline__ void store_rows(bf16* m, const float (&d)[N / 2], int r0, int n_rows,
                                           int wt, float scale0 = 1.f, float scale1 = 1.f) {
  const int ra = r0 + acc_row(wt, 0), rb = r0 + acc_row(wt, 2);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = acc_col(wt, j, 0);
    if (ra < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(m + (size_t)ra * N + c) =
          __floats2bfloat162_rn(d[4 * j] * scale0, d[4 * j + 1] * scale0);
    if (rb < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(m + (size_t)rb * N + c) =
          __floats2bfloat162_rn(d[4 * j + 2] * scale1, d[4 * j + 3] * scale1);
  }
}

}  // namespace hopper

// ------------------------------------------------------------ host side
namespace hopper_host {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: taken through the
// runtime's driver entry point, so the libraries link only cudart
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                  : nullptr;
  }();
  return fn;
}

// error codes of the C entry points beyond cudaError_t's
constexpr int ERR_NO_ENCODER = 10000;    // the driver has no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = 10001;        // 10001 + CUresult: encoding a map failed

// 3-D map over a contiguous (bh, n, d) bf16 tensor, box (1, rows, d),
// swizzled to the row width: rows past n of a head are zero-filled, never
// the next head's
inline int map_rows(CUtensorMap* map, const void* ptr, int bh, int n, int d, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)n * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)d, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw = d == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : d == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                          : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                         strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

// map over a contiguous f32 vector of n values as one row of a 2-D
// tensor, box `len`; values past n are zero-filled
inline int map_vec(CUtensorMap* map, const void* ptr, long long n, int len) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[2] = {(cuuint64_t)n, 1};
  const cuuint64_t strides[1] = {((cuuint64_t)n * 4 + 15) / 16 * 16};
  const cuuint32_t box[2] = {(cuuint32_t)len, 1};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims,
                         strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

// sets a kernel's dynamic shared memory limit once per device
template <typename K>
inline int allow_smem(K kernel, int bytes, bool (&done)[16]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 16 && done[dev]) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  if (dev < 16) done[dev] = true;
  return 0;
}

}  // namespace hopper_host
