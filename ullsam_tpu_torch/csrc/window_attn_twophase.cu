// B15: two-phase windowed ViT attention core for Hopper (sm_90a).
//
// Replaces the TPU kernel ullsam_tpu/ops/pallas/flash_attention.py
// `_vit_window_kernel_twophase` (opt-in by ULLSAM_WINDOW_TWOPHASE=1): B3's
// function, for each window of n = kh*kw tokens and each head of hd
// channels
//     o = softmax(q k^T * hd^-1/2 + bias) v
//     bias[i, m] = q_i . Rh[row(i), row(m)] + q_i . Rw[col(i), col(m)]
// on the natural layout (qkv [Bw*n, 3C], head h at h*hd of q | k | v;
// tables rh [kh, kh, hd], rw [kw, kw, hd]; o [Bw*n, C]), in the TPU
// kernel's two phases (flash_attention.py:1064-1103): first a row's whole
// f32 logits (scaled q.k plus the rel-pos bias), then its exact max and sum,
// p normalized and rounded to the input type, and p.v accumulated in f32
// with o rounded once.
//
// Where the logits live: the TPU kernel keeps a window's 16 heads of logits
// in VMEM at once (2.46 MB at ViT-H). The function is per head and per row,
// and one head's row of n <= 256 logits fits on chip, so here they never
// leave it: one launch, no scratch in device memory. B15 is B3's function
// at B3's rounding points, so the entry launches the port's one window core
// of each dtype, as B3 and B1 do: each warp holds its 16 rows' whole row of
// logits in mma.sync registers (bf16: window_core.cuh; float32:
// window_core_f32.cuh, split TF32).
//
// What bounds it on this card: latency. At ViT-H a call is 4.9 GFLOP of
// products (5 us at the bf16 peak) and moves qkv and o once (50 MB, 15 us
// at the memory rate). The earlier designs (two launches through a 69 MB
// f32 scratch, each row read twice in phase 2) took 0.2958 ms in bf16 and
// 1.0639 ms in f32 at ViT-H; a float32 body of its own on the CUDA cores
// (64 rows' logits in shared memory, FMA) took 0.6083 ms (H100 80GB HBM3,
// 700 W).
#include "window_core.cuh"
#include "window_core_f32.cuh"

namespace ullsam {
namespace {

constexpr int kMaxKeys = 256;  // n <= 256 tokens per window
constexpr int kMaxRel = 64;    // kh + kw <= 64

}  // namespace
}  // namespace ullsam

// Plain C entry point (loaded with ctypes). Returns 0 or a cudaError_t.
// dtype: 0 = float32, 1 = bfloat16 for qkv [Bw*n, 3C], rh [kh, kh, hd],
// rw [kw, kw, hd] and out [Bw*n, C]. Requires hd in {64, 80}, n = kh * kw
// <= 256, kh + kw <= 64, nh * hd = C. One launch; no scratch.
extern "C" int window_attn_twophase_forward(int dtype, const void* qkv,
                                            const void* rh, const void* rw,
                                            void* out, int Bw, int n, int C,
                                            int nh, int hd, int kh, int kw,
                                            void* stream) {
  using namespace ullsam;
  if (n > kMaxKeys || kh * kw != n || kh + kw > kMaxRel ||
      (hd != 64 && hd != 80) || nh * hd != C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)  // the port's one f32 window core, B3's too
    return window_core_f32_hd(hd, static_cast<const float*>(qkv),
                              static_cast<const float*>(rh),
                              static_cast<const float*>(rw),
                              static_cast<float*>(out), Bw, n, C, nh, kh, kw,
                              st);
  if (dtype == kBF16)  // the port's one bf16 window core, B3's too
    return window_core(hd, static_cast<const __nv_bfloat16*>(qkv),
                       static_cast<const __nv_bfloat16*>(rh),
                       static_cast<const __nv_bfloat16*>(rw),
                       static_cast<__nv_bfloat16*>(out), Bw, n, C, nh, kh, kw,
                       st);
  return (int)cudaErrorInvalidValue;
}
