// B13: the fused LayerNorm + MLP half of a ViT block, for Hopper (sm_90a).
//
// Replaces the TPU kernel ullsam_tpu/ops/pallas/vit_block.py
// `_ln_mlp_kernel` (via `fused_ln_mlp`, opt-in by ULLSAM_FUSED_VIT_MLP=1):
// for token rows x [T, C] it returns
//     x + fc2(gelu_tanh(fc1(LN2(x)) + b1)) + b2
// with LN one-pass in f32 and its output rounded to x's type, fc1 + b1
// summed in f32 and rounded, the tanh-form GELU taken in f32 of that and
// rounded again, and fc2 + b2 + x summed in f32 and rounded once (the tanh
// form in float32 too: the TPU kernel has no erf).
//
// What bounds it on this card: operations. At SAM ViT-H (C = 1280, F =
// 5120) one windowed block's half is T = 4900 rows: 4 T C F = 128 GFLOP
// against about 50 MB of operands and result, far above the H100's
// ops:byte ridge. So the products run on the tensor cores (gemm_sm90.cuh:
// wgmma fed by TMA, f32 accumulate), in bf16, and in float32 in split TF32
// (three TF32 products for each, f32-accurate, at 495 / 3 TFLOP/s where
// the CUDA cores' FMA reach 67).
//
// Design: the TPU kernel keeps both weight matrices and a row chunk's
// hidden activations in VMEM (tens of MB). A Hopper SM has 227 KB of shared
// memory, so the chain goes through device memory, as B1 and B4 do:
//   1. ln_rows (ln_rows.cuh): one warp per row, y [T, C] at x's type;
//   2. gemm_linear y . W1^T + b1 with the tanh-GELU epilogue (the sum
//      rounded to the type before the GELU) -> h [T, F];
//   3. gemm_linear h . W2^T + b2 with x as the f32 residual operand -> out.
// Both products take gemm_sm90.cuh's wgmma + TMA kernel where C and F are
// multiples of 128 and 64 (every SAM width); otherwise gemm.cuh's mma.sync
// kernel in bf16 (gemm_bf16) and its FMA kernel in f32 (gemm_f32).
// h is 50 MB in bf16 at T = 4900: written once and read once, 30 us of the
// card's memory rate against the products' ~130 us at the bf16 peak.
#include "gemm_sm90.cuh"
#include "ln_rows.cuh"

namespace ullsam {
namespace {

template <typename T>
int forward(const void* x_, const void* lnw, const void* lnb, const void* w1,
            const void* b1, const void* w2, const void* b2, void* ybuf,
            void* hbuf, void* out, int rows, int C, int F, float eps,
            cudaStream_t st) {
  const T* x = static_cast<const T*>(x_);
  T* y = static_cast<T*>(ybuf);
  T* h = static_cast<T*>(hbuf);
  int err = ln_rows(x, static_cast<const T*>(lnw), static_cast<const T*>(lnb),
                    y, rows, C, eps, st);
  if (err) return err;
  err = gemm_linear(y, static_cast<const T*>(w1), static_cast<const T*>(b1),
                    static_cast<const T*>(nullptr), h, rows, F, C,
                    kActGeluTanh, st);
  if (err) return err;
  return gemm_linear(h, static_cast<const T*>(w2), static_cast<const T*>(b2),
                     x, static_cast<T*>(out), rows, C, F, kActNone, st);
}

}  // namespace
}  // namespace ullsam

// Plain C entry point (loaded with ctypes). Returns 0 or a cudaError_t.
// dtype: 0 = float32, 1 = bfloat16; every tensor has that dtype. x, out
// [rows, C]; lnw, lnb [C]; w1 [F, C], b1 [F]; w2 [C, F], b2 [C] (biases may
// be null); ybuf [rows, C] and hbuf [rows, F] are scratch the caller
// allocates. Requires C % 32 == 0 and F % 32 == 0 (the GEMMs' k-tiles).
extern "C" int ln_mlp_forward(int dtype, const void* x, const void* lnw,
                              const void* lnb, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* ybuf,
                              void* hbuf, void* out, int rows, int C, int F,
                              float eps, void* stream) {
  using namespace ullsam;
  if (rows <= 0 || C % kMmaBK != 0 || F % kMmaBK != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return forward<float>(x, lnw, lnb, w1, b1, w2, b2, ybuf, hbuf, out, rows,
                          C, F, eps, st);
  if (dtype == kBF16)
    return forward<__nv_bfloat16>(x, lnw, lnb, w1, b1, w2, b2, ybuf, hbuf,
                                  out, rows, C, F, eps, st);
  return (int)cudaErrorInvalidValue;
}

// One bf16 product of B1 or B13 on its own: out [M, N] = act(a [M, K] .
// w [N, K]^T + bias [N] + res [M, N]) (bias, res may be null; act 0 none,
// 2 tanh-GELU), through gemm_bf16's choice of kernel. Requires K % 32 == 0
// and N % 8 == 0 (the mma.sync kernel's). Returns 0 or a cudaError_t.
extern "C" int gemm_bf16_forward(const void* a, const void* w,
                                 const void* bias, const void* res, void* out,
                                 int M, int N, int K, int act, void* stream) {
  using namespace ullsam;
  using bf16 = __nv_bfloat16;
  if (M <= 0 || K % kMmaBK != 0 || N % 8 != 0 ||
      (act != kActNone && act != kActGeluTanh))
    return (int)cudaErrorInvalidValue;
  return gemm_bf16(static_cast<const bf16*>(a), static_cast<const bf16*>(w),
                   static_cast<const bf16*>(bias), static_cast<const bf16*>(res),
                   static_cast<bf16*>(out), M, N, K, act,
                   static_cast<cudaStream_t>(stream));
}

// One f32 product of B1 or B13 on its own: out [M, N] = act(a [M, K] . w [N,
// K]^T + bias [N] + res [M, N]) (bias, res may be null; act 0 none, 2
// tanh-GELU of the unrounded sum), through gemm_f32's choice of kernel.
// Requires K % 8 == 0 (the FMA kernel's). Returns 0 or a cudaError_t.
extern "C" int gemm_f32_forward(const void* a, const void* w,
                                const void* bias, const void* res, void* out,
                                int M, int N, int K, int act, void* stream) {
  using namespace ullsam;
  if (M <= 0 || N <= 0 || K % kGemmBK != 0 ||
      (act != kActNone && act != kActGeluTanh))
    return (int)cudaErrorInvalidValue;
  return gemm_f32(static_cast<const float*>(a), static_cast<const float*>(w),
                  static_cast<const float*>(bias),
                  static_cast<const float*>(res), static_cast<float*>(out), M,
                  N, K, act, static_cast<cudaStream_t>(stream));
}
