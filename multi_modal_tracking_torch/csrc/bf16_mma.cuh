// bf16 tensor-core helpers of the mixed-attention forward in bf16 (K1-bf16).
//
// One mma.sync.m16n8k16 with bf16 operands and an f32 accumulator per
// product: a bf16 value has 8 significant bits, so the product of two is
// exact in f32 and the tensor core's only rounding is its f32 sum; no
// split is needed (the f32 kernels' 3xTF32, tf32_mma.cuh, is).
//
// Fragments of mma.sync.m16n8k16 with bf16 inputs, lane = 4 * g + t; each
// 32-bit register holds two bf16, the lower column (or row of B) in its
// low half:
//   A (16x16, row): a0 (g, 2t..2t+1)  a1 (g+8, 2t..2t+1)
//                   a2 (g, 2t+8..2t+9) a3 (g+8, 2t+8..2t+9)
//   B (16x8, col):  b0 (k = 2t..2t+1, n = g)  b1 (k = 2t+8..2t+9, n = g)
//   C (16x8):       c0 (g, 2t) c1 (g, 2t+1) c2 (g+8, 2t) c3 (g+8, 2t+1)
// So the accumulators of two neighbouring 8-column tiles of S = Q K^T,
// rounded and packed in pairs, are the A fragment of the next product
// P V over those 16 keys (`acc_pair_as_a`): no shuffle.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace bf16mma {

using bf16 = __nv_bfloat16;

// two floats rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// two bf16 values from anywhere, lo in the low half
__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// two adjacent bf16 (4-byte aligned) as one register
__device__ __forceinline__ uint32_t load_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A from the accumulators of S's 8-column tiles lo (keys 0..7 of the 16)
// and hi (keys 8..15), rounded to bf16
__device__ __forceinline__ void acc_pair_as_a(uint32_t (&a)[4], const float (&lo)[4],
                                              const float (&hi)[4]) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}

// A from a row-major (rows, D) matrix in device memory: rows r0+g, r0+g+8
// (zero past n_rows), columns k0+2t.., k0+2t+8..
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[4], const bf16* m, int r0, int k0,
                                            int n_rows, int D, int g, int t) {
  const int rA = r0 + g, rB = r0 + g + 8, c = k0 + 2 * t;
  a[0] = rA < n_rows ? load_pair(m + (size_t)rA * D + c) : 0u;
  a[1] = rB < n_rows ? load_pair(m + (size_t)rB * D + c) : 0u;
  a[2] = rA < n_rows ? load_pair(m + (size_t)rA * D + c + 8) : 0u;
  a[3] = rB < n_rows ? load_pair(m + (size_t)rB * D + c + 8) : 0u;
}

// B = M^T for a row-major tile M [n][k] of stride STR (K [key][d] in Q K^T):
// row n0+g, columns k0+2t.. and k0+2t+8..
template <int STR>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[2], const bf16* m, int n0, int k0,
                                            int g, int t) {
  const bf16* p = m + (n0 + g) * STR + k0 + 2 * t;
  b[0] = load_pair(p);
  b[1] = load_pair(p + 8);
}

// B = M for a row-major tile M [k][n] of stride STR (V [key][d] in P V):
// rows k0+2t, k0+2t+1 and k0+2t+8, k0+2t+9, column n0+g
template <int STR>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[2], const bf16* m, int k0, int n0,
                                            int g, int t) {
  const bf16* p = m + (k0 + 2 * t) * STR + n0 + g;
  b[0] = pack(p[0], p[STR]);
  b[1] = pack(p[8 * STR], p[9 * STR]);
}

// rows [r0, r0 + ROWS) of a row-major (n_rows, D) bf16 matrix into a tile of
// stride STR bf16 with cp.async, 16-byte pieces; rows past n_rows are
// zero-filled
template <int ROWS, int D, int STR, int THREADS>
__device__ __forceinline__ void stage_rows(bf16* tile, const bf16* src, int r0, int n_rows,
                                           int tid) {
  constexpr int C = D / 8;
#pragma unroll 4
  for (int x = tid; x < ROWS * C; x += THREADS) {
    const int r = x / C, c = x % C;
    const bool ok = r0 + r < n_rows;
    const bf16* p = ok ? src + (size_t)(r0 + r) * D + 8 * c : src;
    tf32x3::cp_async16(tile + r * STR + 8 * c, p, ok ? 16 : 0);
  }
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace bf16mma
