// B7 and B6: the SAM mask decoder's 4x upscale, hypernetwork dot and mask
// statistics for Hopper (sm_90a).
//
// Replaces the TPU kernels ullsam_tpu/ops/pallas/decoder.py `_upscale_kernel`
// (B7, entry `fused_upscale_hypernet`), `_upscale_stats_kernel` +
// `_stats_of_block` (B6, entry `fused_upscale_hypernet_stats`) and the
// upscale half of `_decode_kernel` (B4). The chain is driven from
// ullsam_tpu_torch/ops/kernels/decoder.py:
//   1. u1 = keys @ convT1 + b1, f32 out        decoder_gemm (decoder_twt.cu)
//   2. grouped LayerNorm over the four 2x2 sub-pixel groups, exact GELU,
//      rounded                                  decoder_ln_gelu (here)
//   3. u2 = u1 @ convT2 + b2, rounded, one row per (pixel, sub-pixel group)
//                                              decoder_gemm
//   4. GELU (tanh in bf16, erf in f32) on u2, rounded, then the hypernet
//      dot per mask and sub-pixel, written straight to the spatial
//      [B, M, 4H, 4W] logits                   decoder_upscale_out (here)
//   5. B6 only: hi / lo pixel counts at thr +- off and the row / column
//      occupancy of logits > thr               decoder_mask_stats (here)
//
// What bounds it on this card: operations. At the AMG chunk shape (256
// prompts, 4096 pixels, C = 256) the two upscale products are 0.8 GFLOP a
// prompt on the tensor cores in bf16; the logits (100 MB in bf16 for 256
// prompts x 3 masks) are written once and read once more by the statistics.
//
// The TPU layout tricks are gone: the logits are written in the natural
// spatial layout, not the block-column [B, N, M*16] one; convT2 is one
// [4 C8, C4] matmul on (pixel, sub-pixel group) rows, not a block-diagonal
// [C, 2C] one; the statistics need no placement matmuls. The counts and
// the occupancy are integers, so block reductions plus atomicAdd / atomicOr
// across blocks give exact, order-free results.
#include "common.cuh"

namespace ullsam {
namespace {

constexpr int kMaxMasks = 4;  // selected mask tokens per prompt
constexpr int kMaxC8 = 64;    // hypernet output width

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x *
         (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

// the dtype-switched GELU of the plain version (layers.gelu)
template <typename T>
__device__ __forceinline__ float gelu_dt(float x);
template <>
__device__ __forceinline__ float gelu_dt<float>(float x) {
  return gelu_erf(x);
}
template <>
__device__ __forceinline__ float gelu_dt<__nv_bfloat16>(float x) {
  return gelu_tanh(x);
}

// one warp per row of u [M, C] f32: LayerNorm over each of the four C/4
// groups (w, b of width C/4, one-pass f32 statistics), exact GELU, rounded
template <typename T>
__global__ void __launch_bounds__(256)
    ln_gelu_groups(const float* __restrict__ u, const T* __restrict__ w,
                   const T* __restrict__ b, T* __restrict__ y, long long M,
                   int C, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * 8 + warp;
  if (r >= M) return;
  const int c4 = C / 4;
  const float* ur = u + r * C;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = lane; c < C; c += 32) {
    const float v = ur[c];
    const int g = c / c4;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k == g) {
        s[k] += v;
        s2[k] += v * v;
      }
  }
  float m1[4], rstd[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    m1[k] = warp_sum(s[k]) / c4;
    rstd[k] = rsqrtf(fmaxf(warp_sum(s2[k]) / c4 - m1[k] * m1[k], 0.f) + eps);
  }
  T* yr = y + r * C;
  for (int c = lane; c < C; c += 32) {
    const int g = c / c4, cc = c - g * c4;
    float mg = 0.f, rg = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k == g) {
        mg = m1[k];
        rg = rstd[k];
      }
    const float v = (ur[c] - mg) * rg * to_f(w[cc]) + to_f(b[cc]);
    yr[c] = from_f<T>(gelu_erf(v));
  }
}

// eight consecutive values as f32 (16-byte aligned source)
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
  out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// u2 [B*N, 16, C8] (pixel r = b*N + i*W + j, sub-pixel e16 = di*8 + dj*4 +
// ei*2 + ej; C8 % 8 == 0, read 16 bytes at a time) and hyper [B, Mm, C8] ->
// logits [B, Mm, 4H, 4W] at (4i + 2di +
// ei, 4j + 2dj + ej). Block (b*H + i, column chunk): thread t < 16 W takes
// output row 4i + t / 4W and column t % 4W of every mask, so neighbouring
// threads write neighbouring logits.
template <typename T>
__global__ void __launch_bounds__(256)
    upscale_out(const T* __restrict__ u2, const T* __restrict__ hyper,
                T* __restrict__ out, int N, int H, int W, int Mm, int C8) {
  __shared__ float hs[kMaxMasks * kMaxC8];
  const int b = blockIdx.x / H, i = blockIdx.x % H, tid = threadIdx.x;
  for (int e = tid; e < Mm * C8; e += 256)
    hs[e] = to_f(hyper[(size_t)b * Mm * C8 + e]);
  __syncthreads();
  const int t = blockIdx.y * 256 + tid, W4 = 4 * W;
  if (t >= 4 * W4) return;
  const int s = t / W4, c = t - s * W4;
  const int j = c >> 2, dj = (c >> 1) & 1, ej = c & 1;
  const int di = s >> 1, ei = s & 1;
  const int e16 = di * 8 + dj * 4 + ei * 2 + ej;
  const T* ur = u2 + (((size_t)b * N + (size_t)i * W + j) * 16 + e16) * C8;
  float acc[kMaxMasks] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < C8; k0 += 8) {
    float x[8];
    load8(ur + k0, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float g = round_to<T>(gelu_dt<T>(x[i]));
#pragma unroll
      for (int m = 0; m < kMaxMasks; ++m)
        if (m < Mm) acc[m] = fmaf(g, hs[m * C8 + k0 + i], acc[m]);
    }
  }
  const size_t plane = (size_t)4 * H * W4;
  T* o = out + (size_t)b * Mm * plane + (size_t)(4 * i + s) * W4 + c;
#pragma unroll
  for (int m = 0; m < kMaxMasks; ++m)
    if (m < Mm) o[m * plane] = from_f<T>(acc[m]);
}

// one block per logit row (plane p = b*Mm + m, row r): counts[p] += (#
// > hi_t, # > lo_t); rowany[p, r] = any > thr; colany[p, c] |= (> thr)
template <typename T>
__global__ void __launch_bounds__(256)
    mask_stats(const T* __restrict__ logits, int H4, int W4, float hi_t,
               float lo_t, float thr, int* __restrict__ counts,
               int* __restrict__ rowany, int* __restrict__ colany) {
  __shared__ int sh[3];
  const long long blk = blockIdx.x;
  const long long p = blk / H4;
  const int tid = threadIdx.x;
  if (tid < 3) sh[tid] = 0;
  __syncthreads();
  const T* row = logits + blk * W4;
  int hi = 0, lo = 0, any = 0;
  for (int c = tid; c < W4; c += 256) {
    const float v = to_f(row[c]);
    hi += v > hi_t;
    lo += v > lo_t;
    if (v > thr) {
      any = 1;
      atomicOr(colany + p * W4 + c, 1);
    }
  }
  hi = __reduce_add_sync(0xffffffffu, hi);
  lo = __reduce_add_sync(0xffffffffu, lo);
  any = __reduce_or_sync(0xffffffffu, any);
  if ((tid & 31) == 0) {
    atomicAdd(sh, hi);
    atomicAdd(sh + 1, lo);
    atomicOr(sh + 2, any);
  }
  __syncthreads();
  if (tid == 0) {
    atomicAdd(counts + 2 * p, sh[0]);
    atomicAdd(counts + 2 * p + 1, sh[1]);
    rowany[blk] = sh[2];
  }
}

template <typename T>
int ln_gelu_launch(const float* u, const void* w, const void* b, void* y,
                   long long M, int C, float eps, cudaStream_t st) {
  ln_gelu_groups<T><<<(unsigned)((M + 7) / 8), 256, 0, st>>>(
      u, static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(y), M, C, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int upscale_out_launch(const void* u2, const void* hyper, void* out, int B,
                       int N, int H, int W, int Mm, int C8, cudaStream_t st) {
  const dim3 grid(B * H, (16 * W + 255) / 256);
  upscale_out<T><<<grid, 256, 0, st>>>(static_cast<const T*>(u2),
                                       static_cast<const T*>(hyper),
                                       static_cast<T*>(out), N, H, W, Mm, C8);
  return (int)cudaGetLastError();
}

template <typename T>
int stats_launch(const void* logits, long long planes, int H4, int W4,
                 float hi_t, float lo_t, float thr, int* counts, int* rowany,
                 int* colany, cudaStream_t st) {
  mask_stats<T><<<(unsigned)(planes * H4), 256, 0, st>>>(
      static_cast<const T*>(logits), H4, W4, hi_t, lo_t, thr, counts, rowany,
      colany);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ullsam

// Plain C entry points (loaded with ctypes). Each returns 0 or a
// cudaError_t. dtype: 0 = float32, 1 = bfloat16.

// y [M, C] (dtype) = GELU(grouped LayerNorm(u [M, C] float32)); w, b [C/4]
extern "C" int decoder_ln_gelu(int dtype, const float* u, const void* w,
                               const void* b, void* y, long long M, int C,
                               float eps, void* stream) {
  using namespace ullsam;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % 4) return cudaErrorInvalidValue;
  if (dtype == kF32) return ln_gelu_launch<float>(u, w, b, y, M, C, eps, st);
  if (dtype == kBF16)
    return ln_gelu_launch<__nv_bfloat16>(u, w, b, y, M, C, eps, st);
  return cudaErrorInvalidValue;
}

// logits [B, Mm, 4H, 4W] from u2 [B*N, 16 * C8] (N = H*W) and hyper
// [B, Mm, C8]
extern "C" int decoder_upscale_out(int dtype, const void* u2,
                                   const void* hyper, void* out, int B, int N,
                                   int H, int W, int Mm, int C8,
                                   void* stream) {
  using namespace ullsam;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N != H * W || Mm < 1 || Mm > kMaxMasks || C8 < 8 || C8 > kMaxC8 ||
      C8 % 8)
    return cudaErrorInvalidValue;
  if (dtype == kF32)
    return upscale_out_launch<float>(u2, hyper, out, B, N, H, W, Mm, C8, st);
  if (dtype == kBF16)
    return upscale_out_launch<__nv_bfloat16>(u2, hyper, out, B, N, H, W, Mm,
                                             C8, st);
  return cudaErrorInvalidValue;
}

// statistics of logits [planes, H4, W4]; counts [planes, 2], rowany
// [planes, H4], colany [planes, W4] int32, zeroed by the caller
extern "C" int decoder_mask_stats(int dtype, const void* logits,
                                  long long planes, int H4, int W4,
                                  float hi_t, float lo_t, float thr,
                                  int* counts, int* rowany, int* colany,
                                  void* stream) {
  using namespace ullsam;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return stats_launch<float>(logits, planes, H4, W4, hi_t, lo_t, thr,
                               counts, rowany, colany, st);
  if (dtype == kBF16)
    return stats_launch<__nv_bfloat16>(logits, planes, H4, W4, hi_t, lo_t,
                                       thr, counts, rowany, colany, st);
  return cudaErrorInvalidValue;
}
