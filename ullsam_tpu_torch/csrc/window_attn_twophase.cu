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
// leave it: one launch, no scratch in device memory.
//   * bf16: B3's function at B3's rounding points, so the entry launches the
//     port's one bf16 window core (window_core.cuh), as B3 and B1 do: each
//     warp holds its 16 rows' whole row of logits in mma.sync registers.
//   * float32: true f32 FMA (no TF32), grid (nh, Bw, ceil(n / 64)): a block
//     writes its 64 query rows' logits into shared memory tile by tile of 64
//     keys, turns each row into p there (a warp a row), then sums p.v over
//     64-key tiles of v; the k and v tiles share one region, so two blocks
//     fit an SM (with one, it ran 1.5x slower).
//
// What bounds it on this card: latency. At ViT-H a call is 4.9 GFLOP of
// products (5 us at the bf16 peak) and moves qkv and o once (50 MB, 15 us
// at the memory rate). The earlier design (two launches through a
// 69 MB f32 scratch, each row read twice in phase 2) took 0.2958 ms in bf16
// and 1.0639 ms in f32 at ViT-H (H100 80GB HBM3, 700 W).
#include "window_core.cuh"

namespace ullsam {
namespace {

constexpr int kMaxKeys = 256;  // n <= 256 tokens per window
constexpr int kMaxRel = 64;    // kh + kw <= 64

__host__ __device__ inline int pad16(int n) { return (n + 15) / 16 * 16; }

// ---- float32, CUDA cores ---------------------------------------------------
// grid (nh, Bw, ceil(n / 64)), 256 threads; thread (ty, tx) = (tid / 16,
// tid % 16). q (64 rows) sits d-major in shared memory (float4 reads); one
// region holds in turn a row-major copy of q for the rel-pos terms, each
// 64-key tile of k (d-major) and each 64-key tile of v; the logits of the
// block's 64 rows against all nk keys in S [64][nk + 4]. About 105 KB at
// n = 196, hd 80: two blocks an SM.
constexpr int kF32LdT = 64 + 4;

template <int HD>
__host__ __device__ constexpr int f32_tile_floats() {
  return HD * kF32LdT > 64 * (HD + 4) ? HD * kF32LdT : 64 * (HD + 4);
}

// must match ops/kernels/window_attention.py twophase_smem_bytes
template <int HD>
size_t twophase_f32_smem(int nk, int rl) {
  return sizeof(float) * ((size_t)HD * kF32LdT + f32_tile_floats<HD>() +
                          64 * rl + (size_t)64 * (nk + 4));
}

template <int HD>
__global__ void __launch_bounds__(256, 2)
    twophase_f32(const float* __restrict__ qkv, const float* __restrict__ rh,
                 const float* __restrict__ rw, float* __restrict__ out, int n,
                 int C, int kh, int kw, float scale) {
  constexpr int kCols = HD / 16, kLdV = HD + 4;
  extern __shared__ __align__(16) float sm[];
  const int nk = pad16(n), lds = nk + 4, rl = kh + kw;
  float* Qt = sm;                       // [HD][kF32LdT]
  float* Qr = Qt + HD * kF32LdT;        // [64][kLdV], then
  float* Kt = Qr;                       // [HD][kF32LdT], then
  float* Vs = Qr;                       // [64][kLdV]
  float* RB = Qr + f32_tile_floats<HD>();  // [64][rl]
  float* S = RB + 64 * rl;              // [64][lds]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, win = blockIdx.y, r0 = blockIdx.z * 64;
  const size_t C3 = 3 * (size_t)C;
  const float* base = qkv + (size_t)win * n * C3 + h * HD;

  for (int e = tid; e < 64 * HD; e += 256) {
    const int r = e / HD, d = e % HD;
    const float qv = r0 + r < n ? base[(size_t)(r0 + r) * C3 + d] : 0.f;
    Qt[d * kF32LdT + r] = qv;
    Qr[r * kLdV + d] = qv;
  }
  __syncthreads();
  window_rel_terms<HD>(Qr, kLdV, 64, r0, rh, rw, n, kh, kw, RB, rl, warp,
                       lane);

  // phase 1: logits, 64 keys at a time
  const float inv_kw = 1.f / kw;
  for (int k0 = 0; k0 < nk; k0 += 64) {
    __syncthreads();  // RB written (Qr read); the previous tile's Kt is free
    for (int e = tid; e < 64 * HD; e += 256) {
      const int j = e / HD, d = e % HD;
      Kt[d * kF32LdT + j] =
          k0 + j < n ? base[(size_t)(k0 + j) * C3 + C + d] : 0.f;
    }
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a =
          *reinterpret_cast<const float4*>(Qt + d * kF32LdT + ty * 4);
      const float4 b =
          *reinterpret_cast<const float4*>(Kt + d * kF32LdT + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
    const int key0 = k0 + tx * 4;
    if (key0 >= nk) continue;  // nk % 16 == 0: a group of 4 is all in
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const float* rb = RB + r * rl;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = key0 + j;
        const int kr = div_small(key, inv_kw);
        v[j] = key < n ? s[i][j] * scale + rb[kr] + rb[kh + key - kr * kw]
                       : -INFINITY;
      }
      *reinterpret_cast<float4*>(S + r * lds + key0) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncthreads();
  // phase 2: each row's exact max and sum (a warp a row), p in place
  for (int r = warp; r < 64; r += 8) {
    float* srow = S + r * lds;
    float m = -INFINITY, l = 0.f;
    for (int c = lane; c < nk; c += 32) m = fmaxf(m, srow[c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    for (int c = lane; c < nk; c += 32) l += expf(srow[c] - m);
    l = warp_sum(l);
    for (int c = lane; c < nk; c += 32) srow[c] = expf(srow[c] - m) / l;
  }
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  for (int k0 = 0; k0 < nk; k0 += 64) {
    const int kn = min(64, nk - k0);
    __syncthreads();  // p written; the previous tile's Vs is free
    for (int e = tid; e < kn * HD; e += 256) {
      const int j = e / HD, d = e % HD;
      Vs[j * kLdV + d] =
          k0 + j < n ? base[(size_t)(k0 + j) * C3 + 2 * C + d] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < kn; ++j) {
      float vr[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vr[c] = Vs[j * kLdV + tx * kCols + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = S[(ty * 4 + i) * lds + k0 + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p, vr[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= n) continue;
    float* orow = out + ((size_t)win * n + row) * C + h * HD + tx * kCols;
#pragma unroll
    for (int c = 0; c < kCols; ++c) orow[c] = acc[i][c];
  }
}

template <int HD>
int launch(const float* qkv, const float* rh, const float* rw, float* out,
           int Bw, int n, int C, int nh, int kh, int kw, float scale,
           cudaStream_t st) {
  const size_t smem = twophase_f32_smem<HD>(pad16(n), kh + kw);
  cudaError_t err = cudaFuncSetAttribute(
      twophase_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  twophase_f32<HD><<<dim3(nh, Bw, (n + 63) / 64), 256, smem, st>>>(
      qkv, rh, rw, out, n, C, kh, kw, scale);
  return (int)cudaGetLastError();
}

inline int launch_hd(int hd, const void* qkv, const void* rh, const void* rw,
                     void* out, int Bw, int n, int C, int nh, int kh, int kw,
                     cudaStream_t st) {
  const float* q = static_cast<const float*>(qkv);
  const float* a = static_cast<const float*>(rh);
  const float* b = static_cast<const float*>(rw);
  float* o = static_cast<float*>(out);
  const float scale = 1.0f / sqrtf((float)hd);
  if (hd == 80) return launch<80>(q, a, b, o, Bw, n, C, nh, kh, kw, scale, st);
  return launch<64>(q, a, b, o, Bw, n, C, nh, kh, kw, scale, st);
}

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
  if (dtype == kF32)
    return launch_hd(hd, qkv, rh, rw, out, Bw, n, C, nh, kh, kw, st);
  if (dtype == kBF16)  // the port's one bf16 window core, B3's too
    return window_core(hd, static_cast<const __nv_bfloat16*>(qkv),
                       static_cast<const __nv_bfloat16*>(rh),
                       static_cast<const __nv_bfloat16*>(rw),
                       static_cast<__nv_bfloat16*>(out), Bw, n, C, nh, kh, kw,
                       st);
  return (int)cudaErrorInvalidValue;
}
