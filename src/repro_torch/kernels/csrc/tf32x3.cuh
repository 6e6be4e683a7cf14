// 3xTF32 products on the tensor cores (mma.sync m16n8k8, TF32 in, fp32
// accumulate), shared by ssd_scan.cu and flash_attention.cu.
//
// A single TF32 pass keeps 10 of fp32's 23 mantissa bits, about 1e-3 of
// relative error on a long product: a different function from the fp32
// reference. 3xTF32 splits each operand f into big = f rounded to TF32 and
// small = the TF32 value of its remainder, and sums
//
//   a b ~ a_big b_big + a_big b_small + a_small b_big
//
// which drops only a_small b_small (below 2^-22 |a b|), so the product
// keeps fp32 accuracy at three times the tensor-core work.
//
// Fragment layouts of m16n8k8 with g = lane / 4 and t = lane % 4:
//   A (16 x 8, row-major): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8, column-major): b0 (k=t, n=g), b1 (k=t+4, n=g)
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
//
// Header only; included by the .cu files (build.py hashes it with them).

#pragma once

#include <stdint.h>

namespace tf32x3 {

struct FragA {  // a 16 x 8 row-major A operand, split
  uint32_t big[4], small[4];
};
struct FragB {  // an 8 x 8 column-major B operand, split
  uint32_t big[2], small[2];
};

// f = big + small: big is f rounded to TF32's 10 mantissa bits, ties away
// from zero (what cvt.rna.tf32.f32 gives for a finite f, in two integer
// instructions instead of its guarded sequence), small is the exact
// remainder, |small| <= 2^-11 |f|, with its low 13 bits dropped as the
// tensor core drops them: big + small is f to within 2^-21 |f|.
__device__ __forceinline__ void split_tf32(float f, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(f) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(f - __uint_as_float(big)) & 0xffffe000u;
}

// a0 (row g, col k), a1 (row g+8, col k), a2 (row g, col k+4), a3 (row
// g+8, col k+4), with g = lane / 4 and k = lane % 4
__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split_tf32(a0, f.big[0], f.small[0]);
  split_tf32(a1, f.big[1], f.small[1]);
  split_tf32(a2, f.big[2], f.small[2]);
  split_tf32(a3, f.big[3], f.small[3]);
  return f;
}

// b0 (row k, col g), b1 (row k+4, col g)
__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split_tf32(b0, f.big[0], f.small[0]);
  split_tf32(b1, f.big[1], f.small[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Term x of a b, added to d: x = 0 a_small b_big, 1 a_big b_small, 2
// a_big b_big. Every product below issues the terms in this order, the
// small ones first, each across all of its tiles before the next, so that
// no mma waits on the one just before it. x is a constant of an unrolled
// loop, so the operand choice costs nothing.
__device__ __forceinline__ void mma_term(float (&d)[4], int x,
                                         const FragA& a, const FragB& b) {
  mma_tf32(d, x == 0 ? a.small : a.big, x == 1 ? b.small : b.big);
}

// acc[r][j] += a[r] b[j] in 3xTF32 for the row blocks r that are `on`;
// acc: c0 (row g, col 2k), c1 (g, 2k+1), c2 (g+8, 2k), c3 (g+8, 2k+1)
template <int NR, int NC>
__device__ __forceinline__ void mma3_tiles(float (&acc)[NR][NC][4],
                                           const FragA (&a)[NR],
                                           const FragB (&b)[NC],
                                           const bool (&on)[NR]) {
#pragma unroll
  for (int x = 0; x < 3; ++x)
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int j = 0; j < NC; ++j)
        if (on[r]) mma_term(acc[r][j], x, a[r], b[j]);
}

// acc[c0 + j] += a b[j] for j < C in 3xTF32, one row block
template <int N, int C>
__device__ __forceinline__ void mma3_span(float (&acc)[N][4], int c0,
                                          const FragA& a,
                                          const FragB (&b)[C]) {
#pragma unroll
  for (int x = 0; x < 3; ++x)
#pragma unroll
    for (int j = 0; j < C; ++j) mma_term(acc[c0 + j], x, a, b[j]);
}

// acc[x][j] += term x of a b[j] for j < C: each term in its own partial
// sum, so that three times as many mma chains are in flight
template <int C>
__device__ __forceinline__ void mma3_terms(float (&acc)[3][C][4],
                                           const FragA& a,
                                           const FragB (&b)[C]) {
#pragma unroll
  for (int x = 0; x < 3; ++x)
#pragma unroll
    for (int j = 0; j < C; ++j) mma_term(acc[x][j], x, a, b[j]);
}

}  // namespace tf32x3
