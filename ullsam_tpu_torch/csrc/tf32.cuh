// Split TF32 ("3xTF32") building blocks of the float32 bodies of B8
// (window_attn_bwd.cu, mma.sync) and B9 (vit_flash_bwd.cu, wgmma): an f32
// value x is hi = tf32(x) plus lo = tf32(x - hi), and a product a . b is
// a_hi b_hi + a_hi b_lo + a_lo b_hi on the tensor cores, each term
// accumulated in f32. x - hi is exact in f32, so what is left out (a_lo
// b_lo, lo's own rounding) is near 2^-22 of |a| |b| a term: f32-accurate
// products at a third of the TF32 rate (495 TFLOP/s dense on an H100).
// ops/kernels/tf32.py emulates the same arithmetic in plain PyTorch.
#pragma once

#include "common.cuh"

namespace ullsam {
namespace {

// x rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
// from zero; the low 13 bits of the result are zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c[16 x 8] += a[16 x 8] . b[8 x 8] on TF32 values (mma.sync m16n8k8,
// row.col): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0
// (k t, n g), b1 (k t + 4, n g); c0, c1 (g, 2 t, + 1), c2, c3 (g + 8, ..)
__device__ __forceinline__ void mma_tf32_1688(float* c, const uint32_t* a,
                                              const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a . b in split TF32 (ah, al: a's hi and lo fragments; bh, bl: b's).
// The tensor cores' f32 accumulation is not IEEE's (each product added can
// lose up to about half an ulp of the running sum, one way), so the three
// terms, the small ones first, go into a partial from zero, which is added
// to c on the CUDA cores (round to nearest).
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ah,
                                           const uint32_t* al,
                                           const uint32_t* bh,
                                           const uint32_t* bl) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32_1688(p, ah, bl);
  mma_tf32_1688(p, al, bh);
  mma_tf32_1688(p, ah, bh);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += p[i];
}

// c += a . b for a b exact in TF32 (a 0 / 1 selection): two passes
__device__ __forceinline__ void mma_2xtf32(float* c, const uint32_t* ah,
                                           const uint32_t* al,
                                           const uint32_t* b) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32_1688(p, al, b);
  mma_tf32_1688(p, ah, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += p[i];
}

}  // namespace
}  // namespace ullsam
