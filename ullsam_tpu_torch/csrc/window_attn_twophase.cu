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
// with o rounded once. Not B3's online softmax, which rescales an
// unnormalized p.
//
// Where the logits live: the TPU kernel keeps a window's 16 heads of logits
// in VMEM at once (2.46 MB at ViT-H). The function is per head and per row,
// and one head's row of n <= 256 logits fits on chip, so here they never
// leave it: one launch, no scratch in device memory.
//   * bf16: one block per (head, window, query half), 256 threads, grid
//     (nh, Bw, 2) as B3's. k, v and the block's q rows sit in shared memory
//     ([rows][HD + 8], ldmatrix conflict-free), with the rows' rel-pos terms
//     in f32, computed on the tensor cores (common.cuh
//     window_rel_terms_mma; by FMA they took most of the time). A
//     warp owns 16 query rows and holds their whole row of nk = 16 NT
//     logits in mma.sync m16n8k16 accumulators (NT, the window's 16-key
//     tiles, is a template argument so the row stays in registers: 104 f32
//     a thread at n = 196; one block an SM, 254 registers, no spills). The
//     row max and sum come from quad shuffles; p is normalized and rounded
//     into bf16 A fragments, then p.v on the tensor cores.
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
#include "common.cuh"

namespace ullsam {
namespace {

constexpr int kMaxKeys = 256;  // n <= 256 tokens per window
constexpr int kMaxRel = 64;    // kh + kw <= 64
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ inline int pad16(int n) { return (n + 15) / 16 * 16; }

// ---- bf16, tensor cores ----------------------------------------------------
// must match ops/kernels/window_attention.py twophase_smem_bytes
template <int HD>
struct TwoPhaseMma {
  static constexpr int kLd = HD + 8;  // bf16 rows, ldmatrix conflict-free
  int nk, half, rl;
  __host__ __device__ TwoPhaseMma(int n, int kh, int kw)
      : nk(pad16(n)), half((nk / 16 + 1) / 2), rl(kh + kw) {}
  // K, V [nk][kLd], the block's q rows [half*16][kLd], their rel terms f32
  __host__ __device__ size_t bytes() const {
    return sizeof(__nv_bfloat16) * (size_t)(2 * nk + half * 16) * kLd +
           sizeof(float) * (size_t)half * 16 * rl;
  }
};

// grid (nh, Bw, 2), 256 threads; NT = nk / 16. The two z-blocks of a (head,
// window) split its 16-row query tiles; each warp takes every 8th tile.
template <int HD, int NT>
__global__ void __launch_bounds__(256, 1)
    twophase_mma(const __nv_bfloat16* __restrict__ qkv,
                 const __nv_bfloat16* __restrict__ rh,
                 const __nv_bfloat16* __restrict__ rw,
                 __nv_bfloat16* __restrict__ out, int n, int C, int kh,
                 int kw, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int kLd = TwoPhaseMma<HD>::kLd, kChunks = HD / 8;
  constexpr int nk = NT * 16;
  const TwoPhaseMma<HD> L(n, kh, kw);
  extern __shared__ __align__(16) unsigned char smraw[];
  bf16* Ks = reinterpret_cast<bf16*>(smraw);
  bf16* Vs = Ks + nk * kLd;
  bf16* Qs = Vs + nk * kLd;
  float* RB = reinterpret_cast<float*>(Qs + L.half * 16 * kLd);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, win = blockIdx.y;
  const int qt0 = blockIdx.z * L.half, qt1 = min(NT, qt0 + L.half);
  const int r0 = qt0 * 16;
  const size_t C3 = 3 * (size_t)C;
  const bf16* base = qkv + (size_t)win * n * C3 + h * HD;

  // q first, in its own group: its rel-pos terms overlap k and v's loads
  for (int c = tid; c < L.half * 16 * kChunks; c += 256) {
    const int row = c / kChunks, ch = (c % kChunks) * 8;
    const bool ok = r0 + row < n;
    cp_async16(smem_u32(Qs + row * kLd + ch),
               base + (size_t)(ok ? r0 + row : 0) * C3 + ch, ok);
  }
  cp_async_commit();
  for (int c = tid; c < nk * kChunks; c += 256) {
    const int row = c / kChunks, ch = (c % kChunks) * 8;
    const bool ok = row < n;
    const bf16* src = base + (size_t)(ok ? row : 0) * C3 + ch;
    cp_async16(smem_u32(Ks + row * kLd + ch), src + C, ok);
    cp_async16(smem_u32(Vs + row * kLd + ch), src + 2 * C, ok);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  window_rel_terms_mma<HD>(Qs, kLd, r0, r0 + L.half * 16, rh, rw, n, kh, kw,
                           RB, L.rl, warp, 8, lane);
  cp_async_wait<0>();
  __syncthreads();

  const float inv_kw = 1.f / kw;
  for (int qt = qt0 + warp; qt < qt1; qt += 8) {
    const int lr = (qt - qt0) * 16;
    // phase 1: the 16 rows' logits against every key, in registers
    float s[2 * NT][4];
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
    for (int kd = 0; kd < HD / 16; ++kd) {
      uint32_t qf[4];
      ldmatrix_x4(qf, smem_u32(Qs + (lr + (lane & 15)) * kLd + kd * 16 +
                               (lane >> 4) * 8));
#pragma unroll
      for (int nj = 0; nj < NT; ++nj) {
        uint32_t b[4];
        ldmatrix_x4(b, smem_u32(Ks +
                                (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                    kLd +
                                kd * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16_16816(s[2 * nj], qf, b);
        mma_bf16_16816(s[2 * nj + 1], qf, b + 2);
      }
    }
    // scale, bias and mask (in base 2), then the exact row max
    const float* rb0 = RB + (lr + g) * L.rl;
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = j * 8 + 2 * t + e;
        const int kr = div_small(key, inv_kw), kc = key - kr * kw;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float* rb = rb0 + hf * 8 * L.rl;
          float& x = s[j][2 * hf + e];
          x = key < n ? (x * scale + rb[kr] + rb[kh + kc]) * kLog2e
                      : -INFINITY;
          m[hf] = fmaxf(m[hf], x);
        }
      }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 1));
      m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 2));
    }
    // phase 2: the exact row sum, then p = exp(s - m) / l rounded to bf16
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] = exp2f(s[j][c] - m[c >> 1]);
        l[c >> 1] += s[j][c];
      }
    float inv[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
      inv[hf] = 1.f / l[hf];
    }
    uint32_t pa[NT][4];
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0] * inv[0], s[2 * kk][1] * inv[0]);
      pa[kk][1] = pack_bf16(s[2 * kk][2] * inv[1], s[2 * kk][3] * inv[1]);
      pa[kk][2] =
          pack_bf16(s[2 * kk + 1][0] * inv[0], s[2 * kk + 1][1] * inv[0]);
      pa[kk][3] =
          pack_bf16(s[2 * kk + 1][2] * inv[1], s[2 * kk + 1][3] * inv[1]);
    }
    float acc[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk)
#pragma unroll
      for (int dj = 0; dj < HD / 16; ++dj) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, smem_u32(Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 kLd +
                        dj * 16 + (lane >> 4) * 8));
        mma_bf16_16816(acc[2 * dj], pa[kk], b);
        mma_bf16_16816(acc[2 * dj + 1], pa[kk], b + 2);
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = qt * 16 + g + hf * 8;
      if (row >= n) continue;
      bf16* orow = out + ((size_t)win * n + row) * C + h * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[j][2 * hf], acc[j][2 * hf + 1]);
    }
  }
}

// the instance whose NT is nt (1 <= nt <= 16)
template <int HD, int NT = 1>
int launch_mma(int nt, const __nv_bfloat16* qkv, const __nv_bfloat16* rh,
               const __nv_bfloat16* rw, __nv_bfloat16* out, int Bw, int n,
               int C, int nh, int kh, int kw, float scale, cudaStream_t st) {
  if constexpr (NT < kMaxKeys / 16) {
    if (nt != NT)
      return launch_mma<HD, NT + 1>(nt, qkv, rh, rw, out, Bw, n, C, nh, kh,
                                    kw, scale, st);
  }
  const size_t smem = TwoPhaseMma<HD>(n, kh, kw).bytes();
  cudaError_t err = cudaFuncSetAttribute(
      twophase_mma<HD, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  twophase_mma<HD, NT><<<dim3(nh, Bw, 2), 256, smem, st>>>(
      qkv, rh, rw, out, n, C, kh, kw, scale);
  return (int)cudaGetLastError();
}

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

template <int HD>
int launch(const __nv_bfloat16* qkv, const __nv_bfloat16* rh,
           const __nv_bfloat16* rw, __nv_bfloat16* out, int Bw, int n, int C,
           int nh, int kh, int kw, float scale, cudaStream_t st) {
  return launch_mma<HD>(pad16(n) / 16, qkv, rh, rw, out, Bw, n, C, nh, kh, kw,
                        scale, st);
}

template <typename T>
int launch_hd(int hd, const void* qkv, const void* rh, const void* rw,
              void* out, int Bw, int n, int C, int nh, int kh, int kw,
              float scale, cudaStream_t st) {
  const T* q = static_cast<const T*>(qkv);
  const T* a = static_cast<const T*>(rh);
  const T* b = static_cast<const T*>(rw);
  T* o = static_cast<T*>(out);
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
  const float scale = 1.0f / sqrtf((float)hd);
  if (dtype == kF32)
    return launch_hd<float>(hd, qkv, rh, rw, out, Bw, n, C, nh, kh, kw,
                            scale, st);
  if (dtype == kBF16)
    return launch_hd<__nv_bfloat16>(hd, qkv, rh, rw, out, Bw, n, C, nh, kh,
                                    kw, scale, st);
  return (int)cudaErrorInvalidValue;
}
