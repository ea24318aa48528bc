// B1: fused windowed ViT attention half-block for Hopper (sm_90a).
//
// Replaces the TPU kernel ullsam_tpu/ops/pallas/vit_block.py
// `_window_attn_kernel` (via `fused_window_attn`): for pre-partitioned
// windows x [Bw, n, C] it returns
//     x + proj(attn(mask(LN1(x))))
// with per-head softmax(q k^T * hd^-1/2 + decomposed rel-pos bias) v.
//
// What bounds it on this card: operations. At the SAM ViT-B main-path shape
// (Bw = 25 windows of n = 196, C = 768, 12 heads of 64) one call is ~26
// GFLOP (qkv 17.3 + proj 5.8 + attention 2.9) against ~20-40 MB of bytes,
// far above the H100's ops:byte ridge. So the products run on the tensor
// cores (wgmma for qkv and proj, mma.sync in the attention core; f32
// accumulate), in bf16, and in float32 in split TF32 (tf32.cuh: three TF32
// products for each, f32-accurate, at 495 / 3 TFLOP/s where the CUDA
// cores' FMA reach 67).
//
// At SAM ViT-H (Bw = 25, n = 196, C = 1280, 16 heads of 80) a call is ~70
// GFLOP; head dims 64 and 80 have their own instances of the attention core.
//
// Design: a chain of four kernels on one stream, each simple and right:
//   1. ln_mask_kernel (ln_rows.cuh): one warp per token row; one-pass f32
//      LayerNorm (E[x], E[x^2]) and the zeroing of pad tokens' normed
//      activations, with the window geometry (nwx, nwy, Hv, Wv) rebuilt
//      from the row index. Pad keys stay in the softmax: they carry k = qkv
//      bias, as in the reference's pad-after-norm.
//   2. GEMM against the natural [out, in] weight with a bias epilogue, for
//      qkv and, with the f32 residual epilogue, for proj (gemm_linear):
//      gemm_sm90.cuh's wgmma + TMA kernel at N % 128 == 0 and K % 64 == 0,
//      which every SAM width meets (bf16, or f32 in split TF32); gemm.cuh's
//      mma.sync (bf16) or FMA (f32) kernel otherwise.
//   3. the attention core: the port's one window core of the dtype, shared
//      with B3 and B15 (window_core.cuh in bf16, window_core_f32.cuh in
//      f32, split TF32: persistent blocks, each row's whole logits in
//      registers, the exact row max and sum; in bf16 the JAX kernels'
//      rounding of p).
// The TPU kernel's Mosaic workarounds are gone: no 128-lane head padding,
// no one-hot selection matmuls, no [P*n, P*n] block-masked logits.
//
// bf16 rounding points match vit_block.py:231-290: LN output cast before
// qkv, qkv cast after its bias, the normalized p cast before p.v, o_h cast
// before proj; the residual sum is f32.
//
// B3, the attention core alone (window_attn_core_forward below), replaces
// ullsam_tpu/ops/pallas/flash_attention.py `_vit_window_kernel`: the
// forward recompute inside B1's gradient. It is step 3 above on a caller's
// qkv [Bw*n, 3C] (natural layout: no 128-lane head slots, no selection
// matmuls). Its gradient, B8, is window_attn_bwd.cu.
#include "gemm_sm90.cuh"
#include "ln_rows.cuh"
#include "window_core.cuh"
#include "window_core_f32.cuh"

namespace ullsam {
namespace {

constexpr int kAttnMaxKeys = 256;  // n <= 256 tokens per window
constexpr int kAttnMaxRel = 64;    // kh + kw <= 64

// head dims with an instantiated core: SAM ViT-B / L (64), ViT-H (80)
inline bool head_dim_ok(int hd) { return hd == 64 || hd == 80; }

// the core at a runtime head dim (head_dim_ok checked by the caller)
inline int attn_core_hd(int hd, const float* qkv, const float* rh,
                        const float* rw, float* out, int Bw, int n, int C,
                        int nh, int kh, int kw, cudaStream_t st) {
  return window_core_f32_hd(hd, qkv, rh, rw, out, Bw, n, C, nh, kh, kw, st);
}

inline int attn_core_hd(int hd, const __nv_bfloat16* qkv,
                        const __nv_bfloat16* rh, const __nv_bfloat16* rw,
                        __nv_bfloat16* out, int Bw, int n, int C, int nh,
                        int kh, int kw, cudaStream_t st) {
  return window_core(hd, qkv, rh, rw, out, Bw, n, C, nh, kh, kw, st);
}

template <typename T>
int forward(const void* x_, const void* lnw, const void* lnb,
            const void* qkvw, const void* qkvb, const void* projw,
            const void* projb, const void* rh, const void* rw, void* ybuf,
            void* qkvbuf, void* obuf, void* out, int Bw, int n, int C, int nh,
            int hd, int kh, int kw, float eps, int nwx, int nwy, int Hv,
            int Wv, int masked, cudaStream_t st) {
  const T* x = static_cast<const T*>(x_);
  T* y = static_cast<T*>(ybuf);
  T* qkv = static_cast<T*>(qkvbuf);
  T* o = static_cast<T*>(obuf);
  const int M = Bw * n;
  ln_mask_kernel<T><<<(M + 7) / 8, 256, 0, st>>>(
      x, static_cast<const T*>(lnw), static_cast<const T*>(lnb), y, M, C, eps,
      n, kh, kw, nwx, nwy, Hv, Wv, masked);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = gemm_linear(y, static_cast<const T*>(qkvw),
                    static_cast<const T*>(qkvb), nullptr, qkv, M, 3 * C, C,
                    kActNone, st);
  if (err) return err;
  err = attn_core_hd(hd, qkv, static_cast<const T*>(rh),
                     static_cast<const T*>(rw), o, Bw, n, C, nh, kh, kw, st);
  if (err) return err;
  return gemm_linear(o, static_cast<const T*>(projw),
                     static_cast<const T*>(projb), x, static_cast<T*>(out), M,
                     C, C, kActNone, st);
}

}  // namespace
}  // namespace ullsam

// Plain C entry point (loaded with ctypes). Returns 0 or a cudaError_t.
// dtype: 0 = float32, 1 = bfloat16; every tensor argument has that dtype.
// qkvb / projb may be null. ybuf [Bw*n, C], qkvbuf [Bw*n, 3C], obuf
// [Bw*n, C] are scratch the caller allocates.
extern "C" int window_attn_forward(
    int dtype, const void* x, const void* lnw, const void* lnb,
    const void* qkvw, const void* qkvb, const void* projw, const void* projb,
    const void* rh, const void* rw, void* ybuf, void* qkvbuf, void* obuf,
    void* out, int Bw, int n, int C, int nh, int hd, int kh, int kw,
    float eps, int nwx, int nwy, int Hv, int Wv, int masked, void* stream) {
  using namespace ullsam;
  if (n > kAttnMaxKeys || kh + kw > kAttnMaxRel || !head_dim_ok(hd) ||
      nh * hd != C || C % kMmaBK != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return forward<float>(x, lnw, lnb, qkvw, qkvb, projw, projb, rh, rw, ybuf,
                          qkvbuf, obuf, out, Bw, n, C, nh, hd, kh, kw, eps,
                          nwx, nwy, Hv, Wv, masked, st);
  if (dtype == kBF16)
    return forward<__nv_bfloat16>(x, lnw, lnb, qkvw, qkvb, projw, projb, rh,
                                  rw, ybuf, qkvbuf, obuf, out, Bw, n, C, nh,
                                  hd, kh, kw, eps, nwx, nwy, Hv, Wv, masked,
                                  st);
  return (int)cudaErrorInvalidValue;
}

// B3: the attention core alone. qkv [Bw*n, 3C], rh [kh, kh, hd],
// rw [kw, kw, hd], out [Bw*n, C], all of dtype (0 = float32, 1 = bfloat16).
// Returns 0 or a cudaError_t.
extern "C" int window_attn_core_forward(int dtype, const void* qkv,
                                        const void* rh, const void* rw,
                                        void* out, int Bw, int n, int C,
                                        int nh, int hd, int kh, int kw,
                                        void* stream) {
  using namespace ullsam;
  if (n > kAttnMaxKeys || kh * kw != n || kh + kw > kAttnMaxRel ||
      !head_dim_ok(hd) || nh * hd != C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return attn_core_hd(hd, static_cast<const float*>(qkv),
                        static_cast<const float*>(rh),
                        static_cast<const float*>(rw), static_cast<float*>(out),
                        Bw, n, C, nh, kh, kw, st);
  if (dtype == kBF16)
    return attn_core_hd(hd, static_cast<const __nv_bfloat16*>(qkv),
                        static_cast<const __nv_bfloat16*>(rh),
                        static_cast<const __nv_bfloat16*>(rw),
                        static_cast<__nv_bfloat16*>(out), Bw, n, C, nh, kh, kw,
                        st);
  return (int)cudaErrorInvalidValue;
}
