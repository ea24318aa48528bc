// B7 and B6: the SAM mask decoder's 4x upscale, hypernetwork dot and mask
// statistics for Hopper (sm_90a).
//
// Replaces the TPU kernels ullsam_tpu/ops/pallas/decoder.py `_upscale_kernel`
// (:98, B7, entry `fused_upscale_hypernet`), `_upscale_stats_kernel` (:107)
// + `_stats_of_block` (:148) (B6, entry `fused_upscale_hypernet_stats`) and
// the upscale half of `_decode_kernel` (:835, B4). Three implementations,
// chosen by ullsam_tpu_torch/ops/kernels/decoder.py (`fused_upscale`, the
// dtype):
//
// bf16 at SAM's width (C = 256): one kernel, upscale_unit (decoder_sm90.cuh's
// units and pipeline), everything per (prompt, 128 pixels) on chip: u1 =
// keys . convT1 + b1 on wgmma (f32), the grouped LayerNorm and the erf GELU
// in registers, rounded; per sub-pixel group u2 = u1 . convT2 + b2 on
// wgmma, rounded, GELU (tanh), rounded; the hypernet dot; the logits
// straight to the spatial [B, M, 4H, 4W] layout, 8 bytes at a time; B6's
// statistics from the rounded logits in registers. The GELUs' erf and tanh
// are approximations (3e-7 absolute, 2^-11 relative) far under the bf16
// rounding after them. Reads each prompt's keys once (0.54 GB at the AMG
// chunk: 256 prompts, 4096 pixels) and writes the logits once (0.10 GB);
// 0.21 TFLOP of products. What bounds it: by the data sheet operations,
// just (330 flop a byte against the card's 295: 0.212 ms at the bf16 peak,
// 0.191 at 3.35 TB/s). On the card it runs at about 5.8x that: each
// pixel's 256 erf GELUs and LayerNorm values and 512 tanh GELUs run in the
// epilogues on the CUDA cores, with two consumer warpgroups an SM to hide
// their latency.
//
// float32 at SAM's width: upscale_unit_f32 (below; decoder_f32.cuh's units
// of 64 pixels, split TF32, exact erf GELUs), everything on chip as bf16's.
//
// Every other width: the chain
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
// whose f32 products run on the CUDA cores, and whose intermediates pass
// through device memory (at SAM's width and the AMG chunk u1 and u2 would
// be 1 GiB each in f32: 11.3 ms where upscale_unit_f32 takes 3.5).
//
// The TPU layout tricks are gone: the logits are written in the natural
// spatial layout, not the block-column [B, N, M*16] one; convT2 is one
// [4 C8, C4] matmul on (pixel, sub-pixel group) rows, not a block-diagonal
// [C, 2C] one; the statistics need no placement matmuls. The counts and
// the occupancy are integers, so block reductions plus atomicAdd / atomicOr
// across blocks give exact, order-free results.
#include "decoder_f32.cuh"

namespace ullsam {
namespace {

constexpr int kMaxMasks = 4;  // selected mask tokens per prompt
constexpr int kMaxC8 = 64;    // hypernet output width

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// gelu_tanh: gemm.cuh's

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

// ---- the fused bf16 upscale (B7, and B6 with kStats) ---------------------

// acc = bias at each accumulator column
template <int NI>
__device__ __forceinline__ void acc_init_bias(float* v, const bf16* bias,
                                              int tq) {
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(bias + 8 * i + 2 * tq));
    v[4 * i] = v[4 * i + 2] = b.x;
    v[4 * i + 1] = v[4 * i + 3] = b.y;
  }
}

// The exact (erf) GELU with erf by Abramowitz and Stegun 7.1.28: absolute
// error under 3e-7, far under the bf16 rounding that follows it, and
// without erff's branch; the reciprocal in hardware (rcp.approx, 0 for an
// infinite argument)
__device__ __forceinline__ float gelu_erf_fast(float x) {
  const float z = x * 0.70710678118654752f, t = fabsf(z);
  float p = fmaf(fmaf(fmaf(fmaf(fmaf(fmaf(4.30638e-5f, t, 2.765672e-4f), t,
                                     1.520143e-4f),
                                t, 9.2705272e-3f),
                           t, 4.22820123e-2f),
                      t, 7.05230784e-2f),
                 t, 1.f);
  p *= p;
  p *= p;
  p *= p;
  p *= p;
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(p));
  return 0.5f * x * (1.f + copysignf(1.f - r, z));
}

// a quad's four lanes each hold p[0..3]; lane tq gets the quad's sum of
// p[tq] (two shuffle rounds, three shuffles)
__device__ __forceinline__ float quad_reduce_scatter(const float (&p)[4],
                                                     int tq) {
  const bool hi = tq & 2, odd = tq & 1;
  const float k0 = (hi ? p[2] : p[0]) +
                   __shfl_xor_sync(0xffffffffu, hi ? p[0] : p[2], 2);
  const float k1 = (hi ? p[3] : p[1]) +
                   __shfl_xor_sync(0xffffffffu, hi ? p[1] : p[3], 2);
  return (odd ? k1 : k0) + __shfl_xor_sync(0xffffffffu, odd ? k0 : k1, 1);
}

// gelu_tanh with the hardware tanh (tanh.approx.f32, relative error about
// 2^-11, under the bf16 rounding that follows it)
__device__ __forceinline__ float gelu_tanh_fast(float f) {
  float t;
  asm("tanh.approx.f32 %0, %1;"
      : "=f"(t)
      : "f"(f * fmaf(0.044715f * 0.7978845608028654f, f * f,
                     0.7978845608028654f)));
  const float h = 0.5f * f;
  return fmaf(h, t, h);
}

struct UpArgs {
  CUtensorMap keys;  // [B*N, 256], boxes [64][64]
  CUtensorMap w1;    // convT1 as [256, 256]
  CUtensorMap w2;    // convT2 as [128, 64]
  const bf16 *b1, *lnw, *lnb, *b2;
  const bf16* hyper;  // [B, M, 32]
  bf16* out;          // [B, M, 4H, 4W]
  int *counts, *rowany, *colany;
  int B, N, H, W, M, U;
  float hi_t, lo_t, thr, eps;
};

// Per unit (prompt b, pixels n0 .. n0 + 127; warpgroup wg the 64 pixels
// from n0 + 64 wg):
//   u1 = keys[rows] . W1^T + b1 in f32 (one wgmma m64n256 product), the
//        grouped LayerNorm of each (pixel, sub-pixel group) and the erf
//        GELU (gelu_erf_fast) in registers, rounded into X;
//   per sub-pixel group (di, dj): u2 = u1[:, 64 group ..] . W2^T + b2
//        (m64n128, K = 64), rounded, GELU (tanh), rounded, and the
//        hypernetwork dot of each (ei, ej) sub-pixel's 32 values with
//        hyper[b, m] (quad sums), rounded, into the warpgroup's logit
//        staging [M][4 rows][64 pixels][4 columns] in Q;
//   the staging out to the spatial logits, 8 bytes (4 columns) at a time,
//        and with kStats the statistics of those rounded values: counts by
//        warp sums and atomicAdd, row occupancy by one atomicOr a set of
//        lanes on one logit row (__match_any_sync), column occupancy by
//        atomicOr. All integer, so exact and order-free.
template <bool kStats>
__global__ void __launch_bounds__(kUnitThreads, 1)
    upscale_unit(const __grid_constant__ UpArgs a) {
  extern __shared__ unsigned char smraw[];
  const UnitSmem sm(smraw);
  const int tid = threadIdx.x;
  if (tid == 0) sm.init();
  __syncthreads();
  const int units = a.B * a.U;
  if (tid >= 256) {  // the producer warpgroup: one thread issues
    producer_registers();
    if (tid == 256) {
      UnitProducer p(sm);
      int k = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
        const int tile = u / a.B, b = u % a.B;
        for (int w = 0; w < 2; ++w)
          p.rows(sm.x, &a.keys, 4, b * a.N + tile * kUnitRows + 64 * w, w, k);
        for (int kb = 0; kb < 4; ++kb) p.weights(&a.w1, kb, kUnitC);
        p.weights(&a.w2, 0, kUnitCd);
      }
    }
    return;
  }

  consumer_registers();
  UnitConsumer c(sm, tid);
  const int lane = tid & 31;
  constexpr int kStg = kMaxMasks * 4 * 64 * 4;  // a warpgroup's staging
  bf16* stg = sm.q + c.wg * kStg;
  const int H4 = 4 * a.H, W4 = 4 * a.W;
  int k = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
    const int tile = u / a.B, b = u % a.B, n0 = tile * kUnitRows;
    const int nvalid = min(64, max(0, a.N - n0 - 64 * c.wg));
    const int r0 = c.row(0), r1 = c.row(1);
    c.wait_rows(k);
    {
      float acc[128];
      acc_init_bias<32>(acc, a.b1, c.tq);
      c.gemm<256>(acc, sm.x, 4, true);
      // grouped LayerNorm: group i / 8 (64 columns), one-pass statistics
      float s[2][4], s2[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[h][q] = s2[h][q] = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = acc[4 * i + e];
          s[e >> 1][i >> 3] += v;
          s2[e >> 1][i >> 3] += v * v;
        }
      float m1[2][4], rstd[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          m1[h][q] = quad_sum(s[h][q]) / 64.f;
          rstd[h][q] = rsqrtf(
              fmaxf(quad_sum(s2[h][q]) / 64.f - m1[h][q] * m1[h][q], 0.f) +
              a.eps);
        }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int cc = 8 * (i & 7) + 2 * c.tq;
        const float2 wf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(a.lnw + cc));
        const float2 bf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(a.lnb + cc));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float y = (acc[4 * i + e] - m1[e >> 1][i >> 3]) *
                              rstd[e >> 1][i >> 3] * ((e & 1) ? wf.y : wf.x) +
                          ((e & 1) ? bf.y : bf.x);
          acc[4 * i + e] = gelu_erf_fast(y);  // the store rounds it
        }
      }
      acc_store_tile<32>(sm.x, acc, r0, r1, c.tq);
    }
    c.publish();

    // this thread's hypernet columns: hv[m][2j + e] = hyper[b, m, 8j + 2tq + e]
    float hv[kMaxMasks][8];
#pragma unroll
    for (int m = 0; m < kMaxMasks; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 f = make_float2(0.f, 0.f);
        if (m < a.M)
          f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              a.hyper + ((size_t)b * a.M + m) * 32 + 8 * j + 2 * c.tq));
        hv[m][2 * j] = f.x;
        hv[m][2 * j + 1] = f.y;
      }
    // b2 at this thread's accumulator columns (u2's starting sums)
    float b2[64];
    acc_init_bias<16>(b2, a.b2, c.tq);
    // u2: the one slot of W2 serves the four sub-pixel groups
    const int slot = c.kg % kUnitStages, ph = (c.kg / kUnitStages) & 1;
    ++c.kg;
    mbar_wait(&sm.full[slot], ph);
    const bf16* w2 = sm.slot(slot);
#pragma unroll 1
    for (int gq = 0; gq < 4; ++gq) {  // (di, dj)
      float d[64];
      const bf16* x = sm.x + gq * kUnitKB + c.wg * 64 * 64;
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = b2[i];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128k16(d, sw128_desc(x + kk * 16), sw128_desc(w2 + kk * 16),
                         1);
      wgmma_commit();
      wgmma_wait<0>();
      // the last product read X: the next unit's rows may land there while
      // this one's dots, logits and statistics run
      if (gq == 3) c.release_rows();
      acc_round<16>(d);
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = gelu_tanh_fast(d[i]);
      acc_round<16>(d);
      const int di = gq >> 1, dj = gq & 1;
      // the dot of each sub-pixel (ei, ej) = e, columns 32 e .. 32 e + 31
      // (this thread's share: d[4 (4e + j) + 2h + (0, 1)]), with hyper[b,
      // m]; the quad's sums scattered so that lane tq holds sub-pixel tq's
      const int e = c.tq;
#pragma unroll
      for (int m = 0; m < kMaxMasks; ++m)  // hv is 0 past M
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float p[4];
#pragma unroll
          for (int ee = 0; ee < 4; ++ee) {
            float q0 = 0.f, q1 = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              q0 = fmaf(d[4 * (4 * ee + j) + 2 * h], hv[m][2 * j], q0);
              q1 = fmaf(d[4 * (4 * ee + j) + 2 * h + 1], hv[m][2 * j + 1], q1);
            }
            p[ee] = q0 + q1;
          }
          const float v = quad_reduce_scatter(p, c.tq);
          if (m < a.M) {
            const int prow = c.warp * 16 + c.g + 8 * h;
            stg[((m * 4 + 2 * di + (e >> 1)) * 64 + prow) * 4 + 2 * dj +
                (e & 1)] = __float2bfloat16(v);
          }
        }
    }
    if (c.lead) mbar_arrive(&sm.empty[slot]);
    c.sync();

    // the staged logits out, and their statistics
#pragma unroll 1
    for (int base = 0; base < 64 * a.M; base += 128) {
      const int idx = base + c.t;
      if (idx >= 64 * a.M) continue;  // whole warps
      const int m = idx >> 6, p = idx & 63;
      const bool valid = p < nvalid;
      const int n = n0 + c.wg * 64 + p;
      const int i = valid ? n / a.W : 0, j = valid ? n - i * a.W : 0;
      const size_t plane = (size_t)b * a.M + m;
      int hi = 0, lo = 0;
      unsigned rowbits = 0, colbits = 0;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint2 v = *reinterpret_cast<const uint2*>(
            stg + ((m * 4 + s) * 64 + p) * 4);
        if (!valid) continue;
        *reinterpret_cast<uint2*>(a.out + (plane * H4 + 4 * i + s) * W4 +
                                  4 * j) = v;
        if (kStats) {
          const __nv_bfloat162* h2 =
              reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float2 f = __bfloat1622float2(h2[e]);
            hi += (f.x > a.hi_t) + (f.y > a.hi_t);
            lo += (f.x > a.lo_t) + (f.y > a.lo_t);
            const unsigned bx = f.x > a.thr, by = f.y > a.thr;
            rowbits |= (bx | by) << s;
            colbits |= (bx << (2 * e)) | (by << (2 * e + 1));
          }
        }
      }
      if (kStats) {
        hi = __reduce_add_sync(0xffffffffu, hi);
        lo = __reduce_add_sync(0xffffffffu, lo);
        if (lane == 0) {
          atomicAdd(a.counts + 2 * plane, hi);
          atomicAdd(a.counts + 2 * plane + 1, lo);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if ((colbits >> q) & 1)
            atomicOr(a.colany + plane * W4 + 4 * j + q, 1);
        const unsigned grp = __match_any_sync(0xffffffffu, valid ? i : -1);
        const bool leader = valid && __ffs(grp) - 1 == lane;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const unsigned bits = __ballot_sync(0xffffffffu, (rowbits >> s) & 1);
          if (leader && (bits & grp))
            atomicOr(a.rowany + plane * H4 + 4 * i + s, 1);
        }
      }
    }
  }
}

int upscale_fused_launch(bool stats, const UpArgs& a, cudaStream_t st) {
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(upscale_unit<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kUnitSmemBytes),
      cudaFuncSetAttribute(upscale_unit<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kUnitSmemBytes)};
  if (attr[stats] != cudaSuccess) return (int)attr[stats];
  const int units = a.B * a.U;
  const int grid = units < sm_count() ? units : sm_count();
  if (stats)
    upscale_unit<true><<<grid, kUnitThreads, kUnitSmemBytes, st>>>(a);
  else
    upscale_unit<false><<<grid, kUnitThreads, kUnitSmemBytes, st>>>(a);
  return (int)cudaGetLastError();
}


// ---- the fused float32 upscale (B7, and B6 with kStats) ------------------
//
// decoder_f32.cuh's units (prompt b, 64 pixels), products in split TF32:
//   u1 = keys[rows] . W1^T + b1 (warpgroup wg columns 128 wg .., the
//        sub-pixel groups (di, dj) = 2 wg, 2 wg + 1 whole), the grouped
//        LayerNorm of each (pixel, group) over the quad (two passes) and
//        the exact GELU (erff), into X;
//   per group (di, dj): u2 = u1[:, 64 group ..] . W2^T + b2 (m64n64, K =
//        64; warpgroup wg the sub-pixels (ei, ej) = (wg, 0), (wg, 1)), the
//        exact GELU, and the hypernetwork dot of each sub-pixel's 32 values
//        with hyper[b, m] (quad sums) into the logit staging [M][4 rows][64
//        pixels][4 columns] f32 in Q;
//   the staging out to the spatial logits, 16 bytes (4 columns) at a time,
//        and with kStats the statistics of those values: counts by warp
//        sums and atomicAdd, row occupancy by one atomicOr a set of lanes
//        on one logit row (__match_any_sync), column occupancy by atomicOr.
//        All integer, so exact and order-free.
// No value rounds but f32 itself. What bounds it: by the data sheet,
// operations (0.21 TFLOP of products at the AMG chunk: 1.25 ms at 495 / 3
// TFLOP/s, against 1.07 GB of keys and 0.20 GB of logits, 0.38 ms). Each
// unit reads W1's planes (512 KB) and W2's for each group (64 KB) from L2.

struct UpF32Args {
  CUtensorMap keys;          // [B*N, 256], boxes [64][32]
  CUtensorMap w1_hi, w1_lo;  // convT1 as [256, 256]
  CUtensorMap w2_hi, w2_lo;  // convT2 as [128, 64]
  const float *b1, *lnw, *lnb, *b2;
  const float* hyper;  // [B, M, 32]
  float* out;          // [B, M, 4H, 4W]
  int *counts, *rowany, *colany;
  int B, N, H, W, M, U;
  float hi_t, lo_t, thr, eps;
};

template <bool kStats>
__global__ void __launch_bounds__(kUnitThreads, 1)
    upscale_unit_f32(const __grid_constant__ UpF32Args a) {
  extern __shared__ unsigned char smraw[];
  const F32Smem sm(smraw);
  const int tid = threadIdx.x;
  if (tid == 0) sm.init();
  __syncthreads();
  const int units = a.B * a.U;
  if (tid >= 256) {  // the producer warpgroup: one thread issues
    producer_registers();
    if (tid == 256) {
      F32Producer p(sm);
      int k = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
        const int tile = u / a.B, b = u % a.B;
        p.rows(sm.x, &a.keys, 8, b * a.N + tile * kF32Rows, k);
        for (int kb = 0; kb < kUnitC / kF32WK; ++kb)
          p.weights(&a.w1_hi, &a.w1_lo, kb, kUnitC);
        for (int gq = 0; gq < 4; ++gq)
          for (int kb = 0; kb < 64 / kF32WK; ++kb)
            p.weights(&a.w2_hi, &a.w2_lo, kb, kUnitCd);
      }
    }
    return;
  }

  consumer_registers();
  F32Consumer c(sm, tid);
  const int lane = tid & 31, c0 = 128 * c.wg, c2 = 64 * c.wg;
  float* stg = sm.q;  // [M][4 rows][64 pixels][4 columns]
  const int H4 = 4 * a.H, W4 = 4 * a.W;
  int k = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
    const int tile = u / a.B, b = u % a.B, n0 = tile * kF32Rows;
    const int nvalid = min(kF32Rows, a.N - n0);
    c.wait_rows(k);
    {
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      f32_acc_bias<16>(acc, a.b1 + c0, c.tq);
      c.gemm<16>(acc, sm.x, kUnitC / kF32WK, kUnitC, c0);
      // grouped LayerNorm: group gl = i >> 3 of the warpgroup's two (64
      // columns, all in the quad), mean then variance
      float m[2][2], rs[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int gl = 0; gl < 2; ++gl) {
          float s = 0.f;
#pragma unroll
          for (int i = 8 * gl; i < 8 * gl + 8; ++i)
            s += acc[4 * i + 2 * h] + acc[4 * i + 2 * h + 1];
          m[h][gl] = quad_sum(s) * (1.f / 64);
          float d2 = 0.f;
#pragma unroll
          for (int i = 8 * gl; i < 8 * gl + 8; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float d = acc[4 * i + 2 * h + e] - m[h][gl];
              d2 = fmaf(d, d, d2);
            }
          rs[h][gl] = 1.f / sqrtf(quad_sum(d2) * (1.f / 64) + a.eps);
        }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int cc = 8 * (i & 7) + 2 * c.tq;
        const float2 wf = __ldg(reinterpret_cast<const float2*>(a.lnw + cc));
        const float2 bf = __ldg(reinterpret_cast<const float2*>(a.lnb + cc));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float y = (acc[4 * i + e] - m[e >> 1][i >> 3]) *
                              rs[e >> 1][i >> 3] * ((e & 1) ? wf.y : wf.x) +
                          ((e & 1) ? bf.y : bf.x);
          acc[4 * i + e] = gelu_erf(y);
        }
      }
      f32_acc_store<16>(sm.x, acc, c0, c);
    }
    fence_proxy_async();  // X's next rows come by TMA
    c.sync();

    // this thread's hypernet columns: hv[m][2j + e] = hyper[b, m, 8j + 2tq
    // + e] (0 past M)
    float hv[kMaxMasks][8];
#pragma unroll
    for (int m = 0; m < kMaxMasks; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 f = make_float2(0.f, 0.f);
        if (m < a.M)
          f = __ldg(reinterpret_cast<const float2*>(
              a.hyper + ((size_t)b * a.M + m) * 32 + 8 * j + 2 * c.tq));
        hv[m][2 * j] = f.x;
        hv[m][2 * j + 1] = f.y;
      }
#pragma unroll 1
    for (int gq = 0; gq < 4; ++gq) {  // (di, dj)
      float d[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) d[i] = 0.f;
      f32_acc_bias<8>(d, a.b2 + c2, c.tq);
      c.gemm<8>(d, sm.x + 2 * gq * kF32TileKB, 64 / kF32WK, kUnitCd, c2);
      // the last product read X: the next unit's rows may land there
      // while this one's dots, logits and statistics run
      if (gq == 3 && c.chief) mbar_arrive(sm.xempty);
#pragma unroll
      for (int i = 0; i < 32; ++i) d[i] = gelu_erf(d[i]);
      const int di = gq >> 1, dj = gq & 1;
      // sub-pixel (ei, ej) = (wg, el): columns 32 el .. 32 el + 31 of the
      // warpgroup's 64, this thread's d[4 (4 el + j) + 2h + (0, 1)]
#pragma unroll
      for (int m = 0; m < kMaxMasks; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int el = 0; el < 2; ++el) {
            float q0 = 0.f, q1 = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              q0 = fmaf(d[4 * (4 * el + j) + 2 * h], hv[m][2 * j], q0);
              q1 = fmaf(d[4 * (4 * el + j) + 2 * h + 1], hv[m][2 * j + 1],
                        q1);
            }
            const float v = quad_sum(q0 + q1);
            if (m < a.M && c.tq == 0)
              stg[((m * 4 + 2 * di + c.wg) * 64 + c.row(h)) * 4 + 2 * dj +
                  el] = v;
          }
    }
    c.sync();

    // the staged logits out, and their statistics
#pragma unroll 1
    for (int base = 0; base < 64 * a.M; base += 256) {
      const int idx = base + c.t;
      if (idx >= 64 * a.M) continue;  // whole warps
      const int m = idx >> 6, p = idx & 63;
      const bool valid = p < nvalid;
      const int n = n0 + p;
      const int i = valid ? n / a.W : 0, j = valid ? n - i * a.W : 0;
      const size_t plane = (size_t)b * a.M + m;
      int hi = 0, lo = 0;
      unsigned rowbits = 0, colbits = 0;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float4 v =
            *reinterpret_cast<const float4*>(stg + ((m * 4 + s) * 64 + p) * 4);
        if (!valid) continue;
        *reinterpret_cast<float4*>(a.out + (plane * H4 + 4 * i + s) * W4 +
                                   4 * j) = v;
        if (kStats) {
          const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            hi += f[e] > a.hi_t;
            lo += f[e] > a.lo_t;
            const unsigned bit = f[e] > a.thr;
            rowbits |= bit << s;
            colbits |= bit << e;
          }
        }
      }
      if (kStats) {
        hi = __reduce_add_sync(0xffffffffu, hi);
        lo = __reduce_add_sync(0xffffffffu, lo);
        if (lane == 0) {
          atomicAdd(a.counts + 2 * plane, hi);
          atomicAdd(a.counts + 2 * plane + 1, lo);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if ((colbits >> q) & 1)
            atomicOr(a.colany + plane * W4 + 4 * j + q, 1);
        const unsigned grp = __match_any_sync(0xffffffffu, valid ? i : -1);
        const bool leader = valid && __ffs(grp) - 1 == lane;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const unsigned bits = __ballot_sync(0xffffffffu, (rowbits >> s) & 1);
          if (leader && (bits & grp))
            atomicOr(a.rowany + plane * H4 + 4 * i + s, 1);
        }
      }
    }
  }
}

int upscale_f32_launch(bool stats, const UpF32Args& a, cudaStream_t st) {
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(upscale_unit_f32<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kF32SmemBytes),
      cudaFuncSetAttribute(upscale_unit_f32<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kF32SmemBytes)};
  if (attr[stats] != cudaSuccess) return (int)attr[stats];
  const int units = a.B * a.U;
  const int grid = units < sm_count() ? units : sm_count();
  if (stats)
    upscale_unit_f32<true><<<grid, kUnitThreads, kF32SmemBytes, st>>>(a);
  else
    upscale_unit_f32<false><<<grid, kUnitThreads, kF32SmemBytes, st>>>(a);
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

// The fused bf16 upscale at SAM's decoder width: keys [B*N, 256] (N = H*W),
// W1 [256, 256], b1 [256], LayerNorm lnw / lnb [64], W2 [128, 64], b2
// [128], hyper [B, M, 32] -> logits out [B, M, 4H, 4W]; with stats, counts
// [B, M, 2], rowany [B, M, 4H], colany [B, M, 4W] int32, zeroed by the
// caller
extern "C" int decoder_upscale_fused(int stats, const void* keys,
                                     const void* w1, const void* b1,
                                     const void* lnw, const void* lnb,
                                     const void* w2, const void* b2,
                                     const void* hyper, void* out, int* counts,
                                     int* rowany, int* colany, int B, int H,
                                     int W, int M, float hi_t, float lo_t,
                                     float thr, float eps, void* stream) {
  using namespace ullsam;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || W < 1 || M < 1 || M > kMaxMasks ||
      (stats && !(counts && rowany && colany)))
    return cudaErrorInvalidValue;
  UpArgs a{};
  a.b1 = static_cast<const bf16*>(b1);
  a.lnw = static_cast<const bf16*>(lnw);
  a.lnb = static_cast<const bf16*>(lnb);
  a.b2 = static_cast<const bf16*>(b2);
  a.hyper = static_cast<const bf16*>(hyper);
  a.out = static_cast<bf16*>(out);
  a.counts = counts;
  a.rowany = rowany;
  a.colany = colany;
  a.B = B;
  a.N = H * W;
  a.H = H;
  a.W = W;
  a.M = M;
  a.U = (a.N + kUnitRows - 1) / kUnitRows;
  a.hi_t = hi_t;
  a.lo_t = lo_t;
  a.thr = thr;
  a.eps = eps;
  if (!make_map(&a.keys, keys, B * a.N, kUnitC, 64) ||
      !make_map(&a.w1, w1, kUnitC, kUnitC, kUnitC) ||
      !make_map(&a.w2, w2, kUnitCd, 64, kUnitCd))
    return cudaErrorInvalidValue;
  return upscale_fused_launch(stats != 0, a, st);
}

// The fused float32 upscale at SAM's decoder width (the arguments of
// decoder_upscale_fused, every tensor float32), on upscale_unit_f32: W1 and
// W2 as their hi and lo planes (decoder_split_tf32)
extern "C" int decoder_upscale_fused_f32(
    int stats, const void* keys, const void* w1_hi, const void* w1_lo,
    const void* b1, const void* lnw, const void* lnb, const void* w2_hi,
    const void* w2_lo, const void* b2, const void* hyper, void* out,
    int* counts, int* rowany, int* colany, int B, int H, int W, int M,
    float hi_t, float lo_t, float thr, float eps, void* stream) {
  using namespace ullsam;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || W < 1 || M < 1 || M > kMaxMasks ||
      (stats && !(counts && rowany && colany)))
    return cudaErrorInvalidValue;
  using F = const float*;
  UpF32Args a{};
  a.b1 = static_cast<F>(b1);
  a.lnw = static_cast<F>(lnw);
  a.lnb = static_cast<F>(lnb);
  a.b2 = static_cast<F>(b2);
  a.hyper = static_cast<F>(hyper);
  a.out = static_cast<float*>(out);
  a.counts = counts;
  a.rowany = rowany;
  a.colany = colany;
  a.B = B;
  a.N = H * W;
  a.H = H;
  a.W = W;
  a.M = M;
  a.U = f32_units(a.N);
  a.hi_t = hi_t;
  a.lo_t = lo_t;
  a.thr = thr;
  a.eps = eps;
  if (!make_map(&a.keys, keys, B * a.N, kUnitC, kF32Rows, kMapF32) ||
      !make_map_w64(&a.w1_hi, w1_hi, kUnitC, kUnitC, kUnitC) ||
      !make_map_w64(&a.w1_lo, w1_lo, kUnitC, kUnitC, kUnitC) ||
      !make_map_w64(&a.w2_hi, w2_hi, kUnitCd, 64, kUnitCd) ||
      !make_map_w64(&a.w2_lo, w2_lo, kUnitCd, 64, kUnitCd))
    return cudaErrorInvalidValue;
  return upscale_f32_launch(stats != 0, a, st);
}
