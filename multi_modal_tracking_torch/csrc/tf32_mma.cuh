// 3xTF32 tensor-core helpers shared by the mixed-attention kernels (K1, K2).
//
// Each f32 operand x is split into two TF32 values, big = rna_tf32(x) and
// small = rna_tf32(x - big) (rna_tf32: cvt.rna.tf32.f32's rounding, to
// nearest with ties away from zero, 10 mantissa bits), and a product a*b
// is issued as three m16n8k8 TF32 MMAs with an f32 accumulator:
//
//     c += a_small*b_big + a_big*b_small + a_big*b_big
//
// (the small terms first, so they are not lost against the large sum).
// Only small*small, about 2^-22 of the product, is dropped: the result has
// f32 accuracy (CUTLASS's OpMultiplyAddFastF32), unlike one TF32 pass
// (10 mantissa bits). Operands are split once, when a fragment is loaded
// (or staged), never once per MMA.
//
// Fragments of mma.sync.m16n8k8 with tf32 inputs, lane = 4 * g + t:
//   A (16x8, row):  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B (8x8, col):   b0 (k=t, n=g)           b1 (k=t+4, n=g)
//   C (16x8):       c0 (g, 2t) c1 (g, 2t+1) c2 (g+8, 2t) c3 (g+8, 2t+1)
// A product whose A operand is a previous accumulator (P V, dS K) relabels
// its k index so that no shuffle is needed: logical k = t is physical
// column 2t and logical k = t+4 is physical column 2t+1. Then
// A = {c0, c2, c1, c3}, and B's rows are read at physical rows 2t and 2t+1
// (`load_b_rows`).
//
// Shared-memory tiles are row-major with a row stride of D + 4 floats: with
// a stride of 4 (mod 32) words the fragment loads below touch 32 distinct
// banks.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

constexpr float NEG_INF = -1e30f;   // the JAX code's finite mask value

// rna_tf32(x): the bits cvt.rna.tf32.f32 gives for a finite x below the
// largest TF32 value (half an ulp of TF32 added to the magnitude, the 13
// low bits cleared), in two integer operations: on an H100 these take K2
// 17% and K1 13% less time than the conversion instruction (PERF.md,
// Findings, "Conversion throughput").
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split(a0, f.big[0], f.small[0]);
  split(a1, f.big[1], f.small[1]);
  split(a2, f.big[2], f.small[2]);
  split(a3, f.big[3], f.small[3]);
  return f;
}

__device__ __forceinline__ FragB split_b(float b0, float b1) {
  FragB f;
  split(b0, f.big[0], f.small[0]);
  split(b1, f.big[1], f.small[1]);
  return f;
}

// A from an accumulator tile c (rows g, g+8; columns 2t, 2t+1), k relabelled
__device__ __forceinline__ FragA acc_as_a(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// A from tiles [row][k] (stride STR) split at staging into big and small:
// rows r0+g, r0+g+8, columns k0+t, k0+t+4
template <int STR>
__device__ __forceinline__ FragA load_a_split(const uint32_t* big, const uint32_t* small,
                                              int r0, int k0, int g, int t) {
  const int o = (r0 + g) * STR + k0 + t;
  FragA f;
  f.big[0] = big[o];              f.small[0] = small[o];
  f.big[1] = big[o + 8 * STR];    f.small[1] = small[o + 8 * STR];
  f.big[2] = big[o + 4];          f.small[2] = small[o + 4];
  f.big[3] = big[o + 8 * STR + 4]; f.small[3] = small[o + 8 * STR + 4];
  return f;
}

// B = M^T for a row-major M [n][k] (e.g. K [key][d] in Q K^T): n0+g, k0+t, +4
template <int STR>
__device__ __forceinline__ FragB load_b_cols(const float* m, int n0, int k0, int g, int t) {
  const float* p = m + (n0 + g) * STR + k0 + t;
  return split_b(p[0], p[4]);
}

// B = M for a row-major M [k][n] under the relabelled k (e.g. V [key][d] in
// P V): physical rows k0+2t, k0+2t+1, column n0+g
template <int STR>
__device__ __forceinline__ FragB load_b_rows(const float* m, int k0, int n0, int g, int t) {
  const float* p = m + (k0 + 2 * t) * STR + n0 + g;
  return split_b(p[0], p[STR]);
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b at f32 accuracy: three TF32 MMAs
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  mma(c, a.small, b.big);
  mma(c, a.big, b.small);
  mma(c, a.big, b.big);
}

// The tensor cores add into their f32 accumulator with truncation, not
// round-to-nearest, so a sum carried through hundreds of MMAs drifts (about
// 2e-5 of its size over the ~170 MMAs of K2's dK at Nq 452). A long sum is
// therefore taken per tile in a fresh accumulator and added to the running
// total with a rounded f32 add.
__device__ __forceinline__ void add_tile(float (&total)[4], const float (&part)[4]) {
  total[0] += part[0]; total[1] += part[1]; total[2] += part[2]; total[3] += part[3];
}

// cp.async of one 16-byte chunk; src_bytes 0 fills the chunk with zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows [r0, r0 + ROWS) of a row-major (n_rows, D) f32 matrix into a tile of
// stride STR; rows past n_rows are zero-filled
template <int ROWS, int D, int STR, int THREADS>
__device__ __forceinline__ void stage_rows(float* tile, const float* src, int r0, int n_rows,
                                           int tid) {
  constexpr int C = D / 4;
#pragma unroll 4
  for (int x = tid; x < ROWS * C; x += THREADS) {
    const int r = x / C, c = x % C;
    const bool ok = r0 + r < n_rows;
    const float* p = ok ? src + (size_t)(r0 + r) * D + 4 * c : src;
    cp_async16(tile + r * STR + 4 * c, p, ok ? 16 : 0);
  }
}

// the same rows, split into TF32 big and small tiles (plain loads, once per block)
template <int ROWS, int D, int STR, int THREADS>
__device__ __forceinline__ void stage_rows_split(uint32_t* big, uint32_t* small,
                                                 const float* src, int r0, int n_rows,
                                                 int tid) {
  constexpr int C = D / 4;
  for (int x = tid; x < ROWS * C; x += THREADS) {
    const int r = x / C, c = x % C;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n_rows) v = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * D + 4 * c);
    const int o = r * STR + 4 * c;
    split(v.x, big[o], small[o]);
    split(v.y, big[o + 1], small[o + 1]);
    split(v.z, big[o + 2], small[o + 2]);
    split(v.w, big[o + 3], small[o + 3]);
  }
}

}  // namespace tf32x3
