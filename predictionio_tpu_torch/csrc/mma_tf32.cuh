// f32 products on Hopper's tensor cores in 3xTF32, and the tile staging,
// shared by the flash-attention forward (flash_attention.cu) and backward
// (flash_backward.cu), the ALS Gram kernel (als_gram.cu) and the NeuMF
// scorer (ncf_score.cu).
//
// mma.sync m16n8k8 with TF32 operands and f32 accumulators. Fragment
// layout (g = lane / 4, t = lane % 4): A (16 x 8, row-major) holds
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (8 x 8, column-major)
// holds (k = t, n = g) and (k = t + 4, n = g); C (16 x 8) holds (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1). An accumulator fragment
// serves as an A fragment once the k index is permuted: A column t is C
// column 2t and column t + 4 is C column 2t + 1, so A = (c0, c2, c1, c3)
// with the B rows loaded to match (k = t <-> 2t, k = t + 4 <-> 2t + 1).
//
// Precision. Each operand x splits into hi = tf32(x) and lo = tf32(x - hi);
// a product accumulates a_lo b_hi + a_hi b_lo + a_hi b_hi in f32: about
// 2^-21 of each product is lost (the dropped a_lo b_lo and lo's rounding),
// near f32's 2^-24, where one TF32 product keeps about 3 decimal digits.
// Each 3xTF32 step sums into zeroed accumulators and reaches the running
// sum by an f32 add (`mma3`): the tensor core truncates its sums, so a
// running sum fed back through it drifts by an ulp of itself per step.
// `mma3_acc` chains the products into the running sum all the same, for a
// bound that allows that drift (the NeuMF scorer's); `frag_b` splits a B
// operand once, where it is staged, and `split_fast` an A operand in
// fewer instructions.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a b, one m16n8k8 TF32 product with f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a 16 x 8 A fragment in its hi and lo halves: x0 = (row g, col t),
// x1 = (g + 8, t), x2 = (g, t + 4), x3 = (g + 8, t + 4)
struct FragA {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ FragA frag_a(float x0, float x1, float x2, float x3) {
  FragA f;
  split(x0, f.hi[0], f.lo[0]);
  split(x1, f.hi[1], f.lo[1]);
  split(x2, f.hi[2], f.lo[2]);
  split(x3, f.hi[3], f.lo[3]);
  return f;
}

// c += a b in 3xTF32, b given as its two elements (k = t and k = t + 4 of
// column g): the small and large terms go to zeroed accumulators
// (independent products) and reach c by f32 adds, rounded to nearest.
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  float big[4] = {0.0f, 0.0f, 0.0f, 0.0f}, small[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(small, a.lo, h0, h1);
  mma_tf32(big, a.hi, h0, h1);
  mma_tf32(small, a.hi, l0, l1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += big[e] + small[e];
}

// x as an A operand's hi and lo words, in 3 instructions where `split`
// takes about 11: hi rounds x to nearest TF32 by an integer add (x
// finite; a NaN still reaches lo), lo = x - hi exactly, and the tensor
// core truncates lo to TF32 itself (mma reads only the top 19 bits of a
// TF32 operand). That costs up to 2^-21 of x, twice `split`'s rounding.
__device__ __forceinline__ void split_fast(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// frag_a through split_fast
__device__ __forceinline__ FragA frag_a_fast(float x0, float x1, float x2, float x3) {
  FragA f;
  split_fast(x0, f.hi[0], f.lo[0]);
  split_fast(x1, f.hi[1], f.lo[1]);
  split_fast(x2, f.hi[2], f.lo[2]);
  split_fast(x3, f.hi[3], f.lo[3]);
  return f;
}

// A B fragment split ahead of its use, for a kernel that stages its B
// operand once and reads it many times: the elements k = t and k = t + 4
// of column g as (hi(b0), hi(b1), lo(b0), lo(b1)), so a lane's fragment is
// one 16-byte shared load when 32 of them are stored lane by lane
// ("fragment order").
__device__ __forceinline__ uint4 frag_b(float b0, float b1) {
  uint4 f;
  split(b0, f.x, f.z);
  split(b1, f.y, f.w);
  return f;
}

// c += a b in 3xTF32 with b from frag_b, accumulated in the tensor core:
// three products chained into c, no f32 adds. Each product's sum is
// truncated to c's precision, so a running sum of n products drifts by
// up to 3n/8 ulps of itself. That fits a bound that allows an ulp per
// term of a sum (ncf_score.cu's), not the attention kernels' 2e-5 of
// the largest output, which is why those use `mma3`.
__device__ __forceinline__ void mma3_acc(float (&c)[4], const FragA& a, uint4 b) {
  mma_tf32(c, a.lo, b.x, b.y);
  mma_tf32(c, a.hi, b.z, b.w);
  mma_tf32(c, a.hi, b.x, b.y);
}

// four floats from global memory: one 16-byte load when `vec` (the
// address is 16-byte aligned), else four scalar ones
__device__ __forceinline__ float4 load4(const float* __restrict__ p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(p[0], p[1], p[2], p[3]);
}

// rows [first, first + kRows) of one (b, h) slice, `stride` floats apart
// -> dst [kRows][D + 4], zeros past row T. The D + 4 row stride keeps the
// fragment reads of both kernels free of bank conflicts; neighbouring
// threads load neighbouring float4s of a row.
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src,
                                           long long stride, int first, int T, bool vec) {
  constexpr int kVecs = D / 4;
  for (int e = threadIdx.x; e < kRows * kVecs; e += kThreads) {
    const int r = e / kVecs, c = (e % kVecs) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (first + r < T) x = load4(src + (first + r) * stride + c, vec);
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c) = x;
  }
}

}  // namespace tf32x3
