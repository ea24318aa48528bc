// B5's token side, and the whole of B4-B7's chain outside bf16 at SAM's
// widths, as kernels for Hopper (sm_90a); also the GEMM that every product
// of that chain runs on.
//
// Replaces, with decoder_image.cu and decoder_upscale.cu, the TPU kernels
// ullsam_tpu/ops/pallas/decoder.py `_twt_kernel` (:637, B5) and
// `_decode_kernel` (:835, B4). The chain is driven from
// ullsam_tpu_torch/ops/kernels/decoder.py (`_twt` over an ops object); this
// file holds its primitive kernels:
//   * decoder_gemm: gemm.cuh (bf16 mma.sync / f32 FMA) with bias, a residual
//     shared across row blocks, ReLU, bf16 or f32 output: the token
//     projections and MLP for all prompts at once ([B*T, C] rows) and the
//     hypernet MLPs; at other widths also the per-prompt image-side
//     products ([B*N, C] rows) and both upscale products. In f32 the
//     shapes gemm_sm90.cuh's kernel takes (N % 128 == 0, K % 64 == 0, a
//     plain residual) run its f32 kind (split TF32, ReLU as its epilogue's
//     activation): every token-side product at SAM's widths and the
//     hypernet MLPs' first two layers; the rest gemm.cuh's FMA kernel.
//   * decoder_ln: row LayerNorm, one-pass f32 statistics.
//   * decoder_self_attn: token self-attention, one block per (prompt, head).
//   * decoder_t2i: token -> image attention over all N image rows, split
//     flash-decoding style over blocks of (prompt, 512-row tile): one pass
//     writes each tile's partial (max, sum) per (token, head); a second
//     normalises each probability with the whole row's max and sum, rounds
//     it and accumulates p.v per tile; a third sums the tiles. Keys and
//     values are shared (batch stride 0: block 1, against the image's k1 /
//     v1; in f32 at SAM's widths decoder_image.cu's decoder_t2i_f32 takes
//     it) or per prompt (the chain at other widths).
//   * decoder_i2t: image -> token attention, one thread per (image row,
//     head) over the <= 16 tokens, which sit in shared memory (f32 chain).
// At SAM's widths (C = 256, Cd = 128, 8 heads), in bf16 and in f32, the
// per-prompt image side runs decoder_image.cu's two stages and token ->
// image attention instead, and the upscale decoder_upscale.cu's fused
// kernels.
//
// What bounds it on this card. The token side at the AMG chunk (256
// prompts, T = 7, B*T = 1792 rows): launches and latency; its products are
// 1792-row GEMMs of 0.9-7 GFLOP, and block 1's t2i does 3.8 GFLOP on the
// CUDA cores against the shared k1 / v1 (2 MB, from L2). The chain in f32:
// operations; its products run on the CUDA cores (67 TFLOP/s, 20 flop a
// byte meet 3.35 TB/s) and the per-prompt ones do 21-77 flop a byte (K <=
// 256). The chain in bf16: bytes; the same products do 43-154 flop a byte
// against the 295 the tensor cores need, and each [B*N, .] intermediate
// passes through device memory between kernels (about 14.5 GB a chunk at
// SAM's widths in bf16, twice that in f32, which is why both dtypes there
// take the fused kernels).
//
// The TPU layout tricks are gone: tokens are not padded to 16 (the T real
// tokens are all there is), heads are indexed directly (16 wide in the
// cross attentions, 32 in the self attention), no selection matmuls.
//
// Rounding points (bf16), as in the plain version: every GEMM output once
// from f32 (bias and residual added in f32); LN outputs; softmax in f32,
// each probability rounded once normalised, before p.v (in the token ->
// image attention too, which reads its keys twice for it); attention
// outputs.
#include <math_constants.h>

#include "gemm_sm90.cuh"

namespace ullsam {
namespace {

constexpr int kCrossHD = 16;  // cross-attention head width (Cd / heads)
constexpr int kSelfHD = 32;   // self-attention head width (C / heads)
constexpr int kMaxTok = 16;   // tokens per prompt
constexpr int kMaxHeads = 8;  // cross-attention heads (Cd <= 128)
constexpr int kT2iTile = 512; // image rows per t2i block, two threads a pair

template <typename T>
__global__ void __launch_bounds__(256)
    ln_rows(const T* __restrict__ x, const T* __restrict__ w,
            const T* __restrict__ b, T* __restrict__ y, long long M, int C,
            float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * 8 + warp;
  if (r >= M) return;
  const T* xr = x + r * C;
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = to_f(xr[c]);
    s += v;
    s2 += v * v;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float m1 = s / C;
  const float rstd = rsqrtf(fmaxf(s2 / C - m1 * m1, 0.f) + eps);
  T* yr = y + r * C;
  for (int c = lane; c < C; c += 32)
    yr[c] = from_f<T>((to_f(xr[c]) - m1) * rstd * to_f(w[c]) + to_f(b[c]));
}

// one block per (prompt, head); q, k, v rows b*Tt + t with their own strides
template <typename T>
__global__ void __launch_bounds__(256)
    self_attn_core(const T* __restrict__ q, int ldq, const T* __restrict__ k,
                   int ldk, const T* __restrict__ v, int ldv,
                   T* __restrict__ o, int Tt, int C, float scale) {
  constexpr int HD = kSelfHD;
  __shared__ float qs[kMaxTok][HD + 1], ks[kMaxTok][HD + 1],
      vs[kMaxTok][HD + 1], ps[kMaxTok][kMaxTok + 1];
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  for (int e = tid; e < Tt * HD; e += 256) {
    const int t = e / HD, d = e % HD;
    const size_t r = (size_t)b * Tt + t;
    qs[t][d] = to_f(q[r * ldq + h * HD + d]);
    ks[t][d] = to_f(k[r * ldk + h * HD + d]);
    vs[t][d] = to_f(v[r * ldv + h * HD + d]);
  }
  __syncthreads();
  {
    const int i = tid >> 4, j = tid & 15;
    if (i < Tt && j < Tt) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) s = fmaf(qs[i][d], ks[j][d], s);
      ps[i][j] = s * scale;
    }
  }
  __syncthreads();
  if (tid < Tt) {
    float m = -CUDART_INF_F, sum = 0.f;
    for (int j = 0; j < Tt; ++j) m = fmaxf(m, ps[tid][j]);
    for (int j = 0; j < Tt; ++j) {
      ps[tid][j] = expf(ps[tid][j] - m);
      sum += ps[tid][j];
    }
    for (int j = 0; j < Tt; ++j) ps[tid][j] = round_to<T>(ps[tid][j] / sum);
  }
  __syncthreads();
  for (int e = tid; e < Tt * HD; e += 256) {
    const int i = e / HD, d = e % HD;
    float a = 0.f;
    for (int j = 0; j < Tt; ++j) a = fmaf(ps[i][j], vs[j][d], a);
    o[((size_t)b * Tt + i) * C + h * HD + d] = from_f<T>(a);
  }
}

// token -> image attention in three kernels, so that each probability is
// normalised before it is rounded, as in the plain version. Block (prompt b,
// tile) has thread (half, pair), pair = token * heads + head, which walks
// keys tile*512 + half, + 2, ...; its slot is 2 * tile + half, of (max, sum,
// acc[16]) floats.
//   t2i_stats: the slot's running max and sum of exp(s - max);
//   t2i_pv:    max M and sum L over all slots, then the slot's
//              sum of round(exp(s - M) / L) * v;
//   t2i_combine: the sum of the slots' accumulators.
// one head's 16 values of a row, 16-byte aligned, as f32 in 16-byte loads
__device__ __forceinline__ void load_head(const float* __restrict__ p,
                                          float (&x)[kCrossHD]) {
  const float4* v = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < kCrossHD / 4; ++i) {
    const float4 a = __ldg(v + i);
    x[4 * i] = a.x;
    x[4 * i + 1] = a.y;
    x[4 * i + 2] = a.z;
    x[4 * i + 3] = a.w;
  }
}

__device__ __forceinline__ void load_head(const __nv_bfloat16* __restrict__ p,
                                          float (&x)[kCrossHD]) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < kCrossHD / 8; ++i) {
    const uint4 a = __ldg(v + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      x[8 * i + 2 * j] = f.x;
      x[8 * i + 2 * j + 1] = f.y;
    }
  }
}

// a row stride that keeps every head's 16 values 16-byte aligned
template <typename T>
bool head_aligned(long long ld) {
  return (ld * (long long)sizeof(T)) % 16 == 0;
}

template <typename T>
__device__ __forceinline__ float t2i_score(const float (&qv)[kCrossHD],
                                           const T* __restrict__ kr,
                                           float scale) {
  float kv[kCrossHD];
  load_head(kr, kv);
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < kCrossHD; ++d) s = fmaf(qv[d], kv[d], s);
  return s * scale;
}

template <typename T>
__device__ __forceinline__ void t2i_query(const T* __restrict__ q, int b,
                                          int t, int h, int Tt, int Cd,
                                          float (&qv)[kCrossHD]) {
  load_head(q + ((size_t)b * Tt + t) * Cd + h * kCrossHD, qv);
}

template <typename T>
__global__ void __launch_bounds__(256)
    t2i_stats(const T* __restrict__ q, const T* __restrict__ k, int ldkv,
              long long kv_bstride, int N, int Tt, int heads, int Cd,
              float scale, float* __restrict__ part) {
  const int b = blockIdx.x, tile = blockIdx.y, tid = threadIdx.x;
  const int pair = tid & 127, half = tid >> 7, P = Tt * heads;
  if (pair >= P) return;
  const int t = pair / heads, h = pair % heads;
  float qv[kCrossHD];
  t2i_query(q, b, t, h, Tt, Cd, qv);
  const T* kb = k + b * kv_bstride + h * kCrossHD;
  float m = -CUDART_INF_F, l = 0.f;
  const int j1 = min(N, (tile + 1) * kT2iTile);
  for (int j = tile * kT2iTile + half; j < j1; j += 2) {
    const float s = t2i_score(qv, kb + (size_t)j * ldkv, scale);
    if (s > m) {
      l *= expf(m - s);
      m = s;
    }
    l += expf(s - m);
  }
  const int nslots = gridDim.y * 2, slot = tile * 2 + half;
  float* out = part + (((size_t)b * nslots + slot) * P + pair) *
                          (kCrossHD + 2);
  out[0] = m;
  out[1] = l;
}

template <typename T>
__global__ void __launch_bounds__(256)
    t2i_pv(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, int ldkv, long long kv_bstride, int N,
           int Tt, int heads, int Cd, float scale, float* __restrict__ part) {
  constexpr int HD = kCrossHD;
  const int b = blockIdx.x, tile = blockIdx.y, tid = threadIdx.x;
  const int pair = tid & 127, half = tid >> 7, P = Tt * heads;
  if (pair >= P) return;
  const int t = pair / heads, h = pair % heads;
  const int nslots = gridDim.y * 2, slot = tile * 2 + half;
  const size_t stride = (size_t)P * (HD + 2);
  float* p0 = part + ((size_t)b * nslots * P + pair) * (HD + 2);
  float M = -CUDART_INF_F, L = 0.f;
  for (int s = 0; s < nslots; ++s) M = fmaxf(M, p0[s * stride]);
  for (int s = 0; s < nslots; ++s)  // an empty slot (max -inf) adds 0
    L += p0[s * stride + 1] * expf(p0[s * stride] - M);
  float qv[HD], acc[HD];
  t2i_query(q, b, t, h, Tt, Cd, qv);
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  const T* kb = k + b * kv_bstride + h * HD;
  const T* vb = v + b * kv_bstride + h * HD;
  const int j1 = min(N, (tile + 1) * kT2iTile);
  for (int j = tile * kT2iTile + half; j < j1; j += 2) {
    const float s = t2i_score(qv, kb + (size_t)j * ldkv, scale);
    const float p = round_to<T>(expf(s - M) / L);
    float vv[HD];
    load_head(vb + (size_t)j * ldkv, vv);
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, vv[d], acc[d]);
  }
  float* out = p0 + slot * stride;
#pragma unroll
  for (int d = 0; d < HD; ++d) out[2 + d] = acc[d];
}

template <typename T>
__global__ void __launch_bounds__(128)
    t2i_combine(const float* __restrict__ part, int nslots, int Tt, int heads,
                int Cd, T* __restrict__ o) {
  constexpr int HD = kCrossHD;
  const int b = blockIdx.x, pair = threadIdx.x, P = Tt * heads;
  if (pair >= P) return;
  const size_t stride = (size_t)P * (HD + 2);
  const float* p0 = part + ((size_t)b * nslots * P + pair) * (HD + 2);
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  for (int s = 0; s < nslots; ++s)
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] += p0[s * stride + 2 + d];
  const int t = pair / heads, h = pair % heads;
  T* orow = o + ((size_t)b * Tt + t) * Cd + h * HD;
#pragma unroll
  for (int d = 0; d < HD; ++d) orow[d] = from_f<T>(acc[d]);
}

// image -> token attention. Block (tile of 256 / heads image rows, prompt
// b): the prompt's token keys and values sit in shared memory (f32); thread
// (row, head) reads its query at qi + b * q_bstride + n * ldq (q_bstride 0:
// shared by all prompts), takes the softmax over the Tt tokens and writes
// its 16 outputs.
template <typename T>
__global__ void __launch_bounds__(256)
    i2t_attn(const T* __restrict__ qi, int ldq, long long q_bstride,
             const T* __restrict__ kt, const T* __restrict__ vt,
             T* __restrict__ o, int N, int Tt, int heads, int Cd,
             float scale) {
  constexpr int HD = kCrossHD;
  constexpr int LD = (HD + 1) * kMaxHeads;  // heads in distinct banks
  __shared__ float ks[kMaxTok][LD], vs[kMaxTok][LD];
  const int b = blockIdx.y, tid = threadIdx.x;
  for (int e = tid; e < Tt * Cd; e += 256) {
    const int t = e / Cd, c = e - t * Cd;
    const int sc = (c / HD) * (HD + 1) + c % HD;
    ks[t][sc] = to_f(kt[((size_t)b * Tt + t) * Cd + c]);
    vs[t][sc] = to_f(vt[((size_t)b * Tt + t) * Cd + c]);
  }
  __syncthreads();
  const int rows = 256 / heads, h = tid % heads;
  const int n = blockIdx.x * rows + tid / heads;
  if (n >= N) return;
  float qv[HD], s[kMaxTok];
  load_head(qi + b * q_bstride + (size_t)n * ldq + h * HD, qv);
  float m = -CUDART_INF_F;
#pragma unroll
  for (int t = 0; t < kMaxTok; ++t) {
    if (t < Tt) {
      float a = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d)
        a = fmaf(qv[d], ks[t][h * (HD + 1) + d], a);
      s[t] = a * scale;
      m = fmaxf(m, s[t]);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int t = 0; t < kMaxTok; ++t)
    if (t < Tt) {
      s[t] = expf(s[t] - m);
      sum += s[t];
    }
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
#pragma unroll
  for (int t = 0; t < kMaxTok; ++t) {
    if (t < Tt) {
      const float p = round_to<T>(s[t] / sum);
#pragma unroll
      for (int d = 0; d < HD; ++d)
        acc[d] = fmaf(p, vs[t][h * (HD + 1) + d], acc[d]);
    }
  }
  T* orow = o + ((size_t)b * N + n) * Cd + h * HD;
#pragma unroll
  for (int d = 0; d < HD; ++d) orow[d] = from_f<T>(acc[d]);
}

template <typename T>
int ln_launch(const void* x, const void* w, const void* b, void* y,
              long long M, int C, float eps, cudaStream_t st) {
  ln_rows<T><<<(unsigned)((M + 7) / 8), 256, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), M, C, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int self_attn_launch(const void* q, int ldq, const void* k, int ldk,
                     const void* v, int ldv, void* o, int B, int Tt, int C,
                     int heads, float scale, cudaStream_t st) {
  self_attn_core<T><<<dim3(B, heads), 256, 0, st>>>(
      static_cast<const T*>(q), ldq, static_cast<const T*>(k), ldk,
      static_cast<const T*>(v), ldv, static_cast<T*>(o), Tt, C, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int t2i_launch(const void* q, const void* k, const void* v, int ldkv,
               long long kv_bstride, float* part, void* o, int B, int N,
               int Tt, int heads, int Cd, float scale, cudaStream_t st) {
  const int tiles = (N + kT2iTile - 1) / kT2iTile;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  t2i_stats<T><<<dim3(B, tiles), 256, 0, st>>>(qt, kt, ldkv, kv_bstride, N,
                                                Tt, heads, Cd, scale, part);
  int err = (int)cudaGetLastError();
  if (err) return err;
  t2i_pv<T><<<dim3(B, tiles), 256, 0, st>>>(qt, kt, static_cast<const T*>(v),
                                             ldkv, kv_bstride, N, Tt, heads,
                                             Cd, scale, part);
  err = (int)cudaGetLastError();
  if (err) return err;
  t2i_combine<T><<<B, 128, 0, st>>>(part, 2 * tiles, Tt, heads, Cd,
                                    static_cast<T*>(o));
  return (int)cudaGetLastError();
}

template <typename T>
int i2t_launch(const void* qi, int ldq, long long q_bstride, const void* kt,
               const void* vt, void* o, int B, int N, int Tt, int heads,
               int Cd, float scale, cudaStream_t st) {
  const int rows = 256 / heads;
  i2t_attn<T><<<dim3((N + rows - 1) / rows, B), 256, 0, st>>>(
      static_cast<const T*>(qi), ldq, q_bstride, static_cast<const T*>(kt),
      static_cast<const T*>(vt), static_cast<T*>(o), N, Tt, heads, Cd,
      scale);
  return (int)cudaGetLastError();
}

bool cross_ok(int Tt, int heads, int Cd) {
  return Tt >= 1 && Tt <= kMaxTok && heads >= 1 && heads <= kMaxHeads &&
         256 % heads == 0 && heads * kCrossHD == Cd && Tt * heads <= 128;
}

}  // namespace
}  // namespace ullsam

// Plain C entry points (loaded with ctypes). Each returns 0 or a
// cudaError_t. dtype: 0 = float32, 1 = bfloat16, for every tensor argument
// unless said otherwise.

// out [M, N] = act(A [M, K] . W [N, K]^T + bias + res[m % res_rows]);
// bias / res may be null. out is float32 when out_f32 (bf16 inputs only).
extern "C" int decoder_gemm(int dtype, int out_f32, const void* A,
                            const void* W, const void* bias, const void* res,
                            int res_rows, void* out, int M, int N, int K,
                            int relu, void* stream) {
  using namespace ullsam;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || (res && res_rows <= 0)) return cudaErrorInvalidValue;
  if (dtype == kF32) {
    if (K % kGemmBK) return cudaErrorInvalidValue;
    const auto* a = static_cast<const float*>(A);
    const auto* w = static_cast<const float*>(W);
    const auto* bs = static_cast<const float*>(bias);
    const auto* rs = static_cast<const float*>(res);
    auto* o = static_cast<float*>(out);
    // the wgmma GEMM's f32 kind (split TF32) where it takes the shape and
    // the residual is a plain one (not shared across row blocks)
    if ((!rs || res_rows == M) && aligned16(a, w, bs, rs, o) &&
        sm90_takes(M, N, K))
      return gemm_f32_sm90_launch(a, w, bs, rs, o, M, N, K, relu, st);
    return gemm_nt(a, w, bs, rs, res_rows, o, M, N, K, relu, st);
  }
  if (dtype != kBF16 || K % kMmaBK || N % 8) return cudaErrorInvalidValue;
  const auto* a = static_cast<const __nv_bfloat16*>(A);
  const auto* w = static_cast<const __nv_bfloat16*>(W);
  const auto* bs = static_cast<const __nv_bfloat16*>(bias);
  const auto* rs = static_cast<const __nv_bfloat16*>(res);
  if (out_f32)
    return gemm_nt(a, w, bs, rs, res_rows, static_cast<float*>(out), M, N,
                   K, relu, st);
  return gemm_nt(a, w, bs, rs, res_rows, static_cast<__nv_bfloat16*>(out), M,
                 N, K, relu, st);
}

// y [M, C] = LayerNorm(x) * w + b, f32 one-pass statistics
extern "C" int decoder_ln(int dtype, const void* x, const void* w,
                          const void* b, void* y, long long M, int C,
                          float eps, void* stream) {
  using namespace ullsam;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return ln_launch<float>(x, w, b, y, M, C, eps, st);
  if (dtype == kBF16)
    return ln_launch<__nv_bfloat16>(x, w, b, y, M, C, eps, st);
  return cudaErrorInvalidValue;
}

// o [B*Tt, C] = per-head softmax(q k^T * scale) v over each prompt's tokens
extern "C" int decoder_self_attn(int dtype, const void* q, int ldq,
                                 const void* k, int ldk, const void* v,
                                 int ldv, void* o, int B, int Tt, int C,
                                 int heads, float scale, void* stream) {
  using namespace ullsam;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Tt < 1 || Tt > kMaxTok || heads * kSelfHD != C)
    return cudaErrorInvalidValue;
  if (dtype == kF32)
    return self_attn_launch<float>(q, ldq, k, ldk, v, ldv, o, B, Tt, C, heads,
                                   scale, st);
  if (dtype == kBF16)
    return self_attn_launch<__nv_bfloat16>(q, ldq, k, ldk, v, ldv, o, B, Tt,
                                           C, heads, scale, st);
  return cudaErrorInvalidValue;
}

// f32 floats of t2i scratch that decoder_t2i needs for (B, N, Tt, heads)
extern "C" long long decoder_t2i_scratch(int B, int N, int Tt, int heads) {
  using namespace ullsam;
  const long long slots = 2LL * ((N + kT2iTile - 1) / kT2iTile);
  return (long long)B * slots * Tt * heads * (kCrossHD + 2);
}

// o [B*Tt, Cd]: queries q [B*Tt, Cd] against keys / values of N image rows
// at k + b * kv_bstride + n * ldkv (kv_bstride 0: shared by all prompts)
extern "C" int decoder_t2i(int dtype, const void* q, const void* k,
                           const void* v, int ldkv, long long kv_bstride,
                           void* part, void* o, int B, int N, int Tt,
                           int heads, int Cd, float scale, void* stream) {
  using namespace ullsam;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!cross_ok(Tt, heads, Cd) || N < 1) return cudaErrorInvalidValue;
  float* p = static_cast<float*>(part);
  if (dtype == kF32 && head_aligned<float>(ldkv))
    return t2i_launch<float>(q, k, v, ldkv, kv_bstride, p, o, B, N, Tt, heads,
                             Cd, scale, st);
  if (dtype == kBF16 && head_aligned<__nv_bfloat16>(ldkv))
    return t2i_launch<__nv_bfloat16>(q, k, v, ldkv, kv_bstride, p, o, B, N,
                                     Tt, heads, Cd, scale, st);
  return cudaErrorInvalidValue;
}

// o [B*N, Cd]: image rows' queries against their prompt's tokens
// kt, vt [B*Tt, Cd]
extern "C" int decoder_i2t(int dtype, const void* qi, int ldq,
                           long long q_bstride, const void* kt,
                           const void* vt, void* o, int B, int N, int Tt,
                           int heads, int Cd, float scale, void* stream) {
  using namespace ullsam;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!cross_ok(Tt, heads, Cd) || B < 1 || N < 1)
    return cudaErrorInvalidValue;
  if (dtype == kF32 && head_aligned<float>(ldq))
    return i2t_launch<float>(qi, ldq, q_bstride, kt, vt, o, B, N, Tt, heads,
                             Cd, scale, st);
  if (dtype == kBF16 && head_aligned<__nv_bfloat16>(ldq))
    return i2t_launch<__nv_bfloat16>(qi, ldq, q_bstride, kt, vt, o, B, N, Tt,
                                     heads, Cd, scale, st);
  return cudaErrorInvalidValue;
}
