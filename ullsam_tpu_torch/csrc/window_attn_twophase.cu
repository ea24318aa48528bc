// B15: two-phase windowed ViT attention core for Hopper (sm_90a).
//
// Replaces the TPU kernel ullsam_tpu/ops/pallas/flash_attention.py
// `_vit_window_kernel_twophase` (opt-in by ULLSAM_WINDOW_TWOPHASE=1): B3's
// function, for each window of n = kh*kw tokens and each head of hd
// channels
//     o = softmax(q k^T * hd^-1/2 + bias) v
//     bias[i, m] = q_i . Rh[row(i), row(m)] + q_i . Rw[col(i), col(m)]
// on the natural layout (qkv [Bw*n, 3C], head h at h*hd of q | k | v;
// tables rh [kh, kh, hd], rw [kw, kw, hd]; o [Bw*n, C]), computed in two
// phases: first every head's logits (scaled q.k plus the rel-pos bias, f32),
// then softmax and p.v, with p normalised and rounded to the input type
// before p.v, and o rounded once (flash_attention.py:1064-1103).
//
// Where the logits live: the TPU kernel keeps a window's nh*n*n f32 logits
// in VMEM (2.46 MB at ViT-H, 16 heads of 196 tokens; 1.84 MB at ViT-B), ten
// times the 227 KB of shared memory a block has. So phase 1's scratch lives
// in device memory, [Bw, nh, nk, nk] f32 with nk = n rounded up to 16 (key
// columns past n hold -inf, rows past n finite values no one reads): 69 MB
// at ViT-H. Chosen: two launches, one per phase. A single launch would need
// every head of a window to finish phase 1 before any starts phase 2, i.e.
// a grid-wide ordering (cooperative launch or per-window counters in device
// memory) for no saving in bytes; two launches on one stream give that
// order for free.
//
// What bounds it on this card: bytes and latency more than operations. At
// ViT-H a layer is 400 (window, head) pairs, 4.9 GFLOP of products (5 us at
// the bf16 peak) against 69 MB of logits written and read back twice
// (phase 2 reads each row for its max and sum, then for p): about 60 us of
// the memory rate, much of it served by the 50 MB L2. B3 keeps its logits
// in registers and moves only qkv and o (about 40 MB).
//
// bf16: both products on the tensor cores (mma.sync m16n8k16, f32
// accumulate); the rel-pos terms by FMA into shared memory, as B3 computes
// them. float32: true f32 FMA on the CUDA cores (no TF32).
#include "common.cuh"

namespace ullsam {
namespace {

constexpr int kMaxKeys = 256;  // n <= 256 tokens per window
constexpr int kMaxRel = 64;    // kh + kw <= 64

__host__ __device__ inline int pad16(int n) { return (n + 15) / 16 * 16; }

// Rel-pos terms RB[r][i] = q_r . Rh[qr, i] (i < kh), q_r . Rw[qc, i - kh]
// for the rows [0, rows) of a row-major q tile (row stride ldq) whose first
// row is query r0 (rows past n use the last row's tables; their q is zero):
// a warp takes a row and four table entries per step, eight lanes to an
// entry, three shuffles to sum (window_attn.cu computes them the same way).
template <int HD, typename T>
__device__ __forceinline__ void rel_terms(const T* qs, int ldq, int rows,
                                          int r0, const T* rh, const T* rw,
                                          int n, int kh, int kw, float* RB,
                                          int ldrb, int warp, int lane) {
  const int rl = kh + kw, sub = lane & 7, part = lane >> 3;
  for (int r = warp; r < rows; r += 8) {
    const int qrow = min(r0 + r, n - 1), y = qrow / kw, x = qrow - y * kw;
    const T* qr = qs + r * ldq;
    for (int i0 = 0; i0 < rl; i0 += 4) {
      const int i = min(i0 + part, rl - 1);
      const T* tab = i < kh ? rh + ((size_t)y * kh + i) * HD
                            : rw + ((size_t)x * kw + i - kh) * HD;
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < HD / 16; ++k) {
        const int d = 16 * k + 2 * sub;
        a = fmaf(to_f(qr[d]), to_f(tab[d]),
                 fmaf(to_f(qr[d + 1]), to_f(tab[d + 1]), a));
      }
      a += __shfl_xor_sync(0xffffffffu, a, 4);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      if (sub == 0 && i0 + part < rl) RB[r * ldrb + i0 + part] = a;
    }
  }
}

// ---- bf16, tensor cores ----------------------------------------------------
// Both phases: grid (nh, Bw, 2), 256 threads; the two z-blocks of a (head,
// window) split its 16-row query tiles, each warp takes every 8th tile.
template <int HD>
struct TwoPhaseMma {
  static constexpr int kLd = HD + 8;  // bf16 rows, ldmatrix conflict-free
  int nk, nt, half, rl;
  __host__ __device__ TwoPhaseMma(int n, int kh, int kw)
      : nk(pad16(n)), nt(nk / 16), half((nk / 16 + 1) / 2), rl(kh + kw) {}
  // phase 1: K [nk][kLd], its q rows [half*16][kLd], their rel terms f32
  __host__ __device__ size_t logits_bytes() const {
    return sizeof(__nv_bfloat16) * (size_t)(nk + half * 16) * kLd +
           sizeof(float) * (size_t)half * 16 * rl;
  }
  // phase 2: V [nk][kLd]
  __host__ __device__ size_t pv_bytes() const {
    return sizeof(__nv_bfloat16) * (size_t)nk * kLd;
  }
};

template <int HD>
__global__ void __launch_bounds__(256)
    logits_mma(const __nv_bfloat16* __restrict__ qkv,
               const __nv_bfloat16* __restrict__ rh,
               const __nv_bfloat16* __restrict__ rw, float* __restrict__ S,
               int n, int C, int nh, int kh, int kw, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int kLd = TwoPhaseMma<HD>::kLd, kChunks = HD / 8;
  const TwoPhaseMma<HD> L(n, kh, kw);
  extern __shared__ __align__(16) unsigned char smraw[];
  bf16* Ks = reinterpret_cast<bf16*>(smraw);
  bf16* Qs = Ks + L.nk * kLd;
  float* RB = reinterpret_cast<float*>(Qs + L.half * 16 * kLd);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, win = blockIdx.y;
  const int qt0 = blockIdx.z * L.half, qt1 = min(L.nt, qt0 + L.half);
  const int r0 = qt0 * 16;
  const size_t C3 = 3 * (size_t)C;
  const bf16* base = qkv + (size_t)win * n * C3 + h * HD;

  for (int c = tid; c < L.nk * kChunks; c += 256) {
    const int row = c / kChunks, ch = (c % kChunks) * 8;
    const bool ok = row < n;
    cp_async16(smem_u32(Ks + row * kLd + ch),
               base + (size_t)(ok ? row : 0) * C3 + C + ch, ok);
  }
  for (int c = tid; c < L.half * 16 * kChunks; c += 256) {
    const int row = c / kChunks, ch = (c % kChunks) * 8;
    const bool ok = r0 + row < n;
    cp_async16(smem_u32(Qs + row * kLd + ch),
               base + (size_t)(ok ? r0 + row : 0) * C3 + ch, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  rel_terms<HD>(Qs, kLd, L.half * 16, r0, rh, rw, n, kh, kw, RB, L.rl, warp,
                lane);
  __syncthreads();

  float* Sw = S + ((size_t)win * nh + h) * L.nk * L.nk;
  const float inv_kw = 1.f / kw;
  for (int qt = qt0 + warp; qt < qt1; qt += 8) {
    const int lr = (qt - qt0) * 16;
    uint32_t qf[HD / 16][4];
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      ldmatrix_x4(qf[ks], smem_u32(Qs + (lr + (lane & 15)) * kLd + ks * 16 +
                                   (lane >> 4) * 8));
    const float* rb0 = RB + (lr + g) * L.rl;
    for (int k0 = 0; k0 < L.nk; k0 += 64) {
      const int nk16 = min(4, (L.nk - k0) / 16);
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          if (nj >= nk16) break;
          uint32_t b[4];
          ldmatrix_x4(b, smem_u32(Ks +
                                  (k0 + nj * 16 + (lane & 7) +
                                   ((lane >> 4) << 3)) * kLd +
                                  kd * 16 + ((lane >> 3) & 1) * 8));
          mma_bf16_16816(s[2 * nj], qf[kd], b);
          mma_bf16_16816(s[2 * nj + 1], qf[kd], b + 2);
        }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= 2 * nk16) break;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float* rb = rb0 + hf * 8 * L.rl;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + j * 8 + 2 * t + e;
            const int kr = div_small(key, inv_kw);
            v[e] = key < n ? s[j][2 * hf + e] * scale + rb[kr] +
                                 rb[kh + key - kr * kw]
                           : -INFINITY;
          }
          const int row = qt * 16 + g + hf * 8;
          *reinterpret_cast<float2*>(Sw + (size_t)row * L.nk + k0 + j * 8 +
                                     2 * t) = make_float2(v[0], v[1]);
        }
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(256)
    pv_mma(const __nv_bfloat16* __restrict__ qkv,
           const float* __restrict__ S, __nv_bfloat16* __restrict__ out, int n,
           int C, int nh, int kh, int kw) {
  using bf16 = __nv_bfloat16;
  constexpr int kLd = TwoPhaseMma<HD>::kLd, kChunks = HD / 8;
  const TwoPhaseMma<HD> L(n, kh, kw);
  extern __shared__ __align__(16) unsigned char smraw[];
  bf16* Vs = reinterpret_cast<bf16*>(smraw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, win = blockIdx.y;
  const int qt0 = blockIdx.z * L.half, qt1 = min(L.nt, qt0 + L.half);
  const size_t C3 = 3 * (size_t)C;
  const bf16* base = qkv + (size_t)win * n * C3 + h * HD;
  for (int c = tid; c < L.nk * kChunks; c += 256) {
    const int row = c / kChunks, ch = (c % kChunks) * 8;
    const bool ok = row < n;
    cp_async16(smem_u32(Vs + row * kLd + ch),
               base + (size_t)(ok ? row : 0) * C3 + 2 * C + ch, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const float* Sw = S + ((size_t)win * nh + h) * L.nk * L.nk;
  for (int qt = qt0 + warp; qt < qt1; qt += 8) {
    // this thread's two rows g, g + 8 of the tile, columns 2t, 2t + 1 of
    // every 8-key group
    const float* row0 = Sw + (size_t)(qt * 16 + g) * L.nk + 2 * t;
    const float* row1 = row0 + 8 * (size_t)L.nk;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int c = 0; c < L.nk; c += 8) {
      const float2 a = *reinterpret_cast<const float2*>(row0 + c);
      const float2 b = *reinterpret_cast<const float2*>(row1 + c);
      m[0] = fmaxf(m[0], fmaxf(a.x, a.y));
      m[1] = fmaxf(m[1], fmaxf(b.x, b.y));
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 1));
      m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 2));
    }
    for (int c = 0; c < L.nk; c += 8) {
      const float2 a = *reinterpret_cast<const float2*>(row0 + c);
      const float2 b = *reinterpret_cast<const float2*>(row1 + c);
      l[0] += expf(a.x - m[0]) + expf(a.y - m[0]);
      l[1] += expf(b.x - m[1]) + expf(b.y - m[1]);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    }
    // p = exp(s - m) / l, rounded to bf16 into the A fragments of p . v
    const auto p2 = [&](const float* r, int hf, int c) {
      const float2 s = *reinterpret_cast<const float2*>(r + c);
      return pack_bf16(expf(s.x - m[hf]) / l[hf], expf(s.y - m[hf]) / l[hf]);
    };
    float acc[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
    for (int kk = 0; kk < L.nt; ++kk) {
      const int c0 = kk * 16;
      const uint32_t pa[4] = {p2(row0, 0, c0), p2(row1, 1, c0),
                              p2(row0, 0, c0 + 8), p2(row1, 1, c0 + 8)};
#pragma unroll
      for (int dj = 0; dj < HD / 16; ++dj) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, smem_u32(Vs +
                        (c0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                        dj * 16 + (lane >> 4) * 8));
        mma_bf16_16816(acc[2 * dj], pa, b);
        mma_bf16_16816(acc[2 * dj + 1], pa, b + 2);
      }
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

// ---- float32, CUDA cores ---------------------------------------------------
// Phase 1: grid (nh, Bw, nk / 64 rounded up), 256 threads; 64 query rows
// against 64-key tiles, thread (ty, tx) = (tid / 16, tid % 16) owning rows
// 4 ty .. + 3 and keys 4 tx .. + 3 of a tile; q and k d-major in shared
// memory (float4 reads), a row-major copy of q for the rel-pos terms.
constexpr int kF32LdT = 64 + 4;

template <int HD>
constexpr size_t logits_f32_smem() {
  return sizeof(float) *
         ((size_t)2 * HD * kF32LdT + 64 * (HD + 4) + 64 * kMaxRel);
}

template <int HD>
__global__ void __launch_bounds__(256)
    logits_f32(const float* __restrict__ qkv, const float* __restrict__ rh,
               const float* __restrict__ rw, float* __restrict__ S, int n,
               int C, int nh, int kh, int kw, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;                     // [HD][kF32LdT]
  float* Kt = Qt + HD * kF32LdT;      // [HD][kF32LdT]
  float* Qr = Kt + HD * kF32LdT;      // [64][HD + 4]
  float* RB = Qr + 64 * (HD + 4);     // [64][kMaxRel]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, win = blockIdx.y, r0 = blockIdx.z * 64;
  const int nk = pad16(n);
  const size_t C3 = 3 * (size_t)C;
  const float* base = qkv + (size_t)win * n * C3 + h * HD;

  for (int e = tid; e < 64 * HD; e += 256) {
    const int r = e / HD, d = e % HD;
    const float qv = r0 + r < n ? base[(size_t)(r0 + r) * C3 + d] : 0.f;
    Qt[d * kF32LdT + r] = qv;
    Qr[r * (HD + 4) + d] = qv;
  }
  __syncthreads();
  rel_terms<HD>(Qr, HD + 4, 64, r0, rh, rw, n, kh, kw, RB, kMaxRel, warp,
                lane);

  float* Sw = S + ((size_t)win * nh + h) * nk * nk;
  const float inv_kw = 1.f / kw;
  for (int k0 = 0; k0 < nk; k0 += 64) {
    __syncthreads();  // RB written; the previous tile's Kt is free
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
      const int r = ty * 4 + i, row = r0 + r;
      if (row >= nk) continue;
      const float* rb = RB + r * kMaxRel;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = key0 + j;
        const int kr = div_small(key, inv_kw);
        v[j] = key < n ? s[i][j] * scale + rb[kr] + rb[kh + key - kr * kw]
                       : -INFINITY;
      }
      *reinterpret_cast<float4*>(Sw + (size_t)row * nk + key0) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// Phase 2: grid (nh, Bw, n / 64 rounded up), 256 threads; each warp turns
// its rows' logits into p = softmax (a row's max and sum over the warp) in
// shared memory, then thread (ty, tx) sums p . v for rows 4 ty .. + 3 and
// columns tx * HD / 16 .. + HD / 16 - 1.
template <int HD>
constexpr size_t pv_f32_smem(int nk) {
  return sizeof(float) * ((size_t)nk * (HD + 4) + (size_t)64 * (nk + 4));
}

template <int HD>
__global__ void __launch_bounds__(256)
    pv_f32(const float* __restrict__ qkv, const float* __restrict__ S,
           float* __restrict__ out, int n, int C, int nh) {
  constexpr int kCols = HD / 16, kLdV = HD + 4;
  extern __shared__ __align__(16) float sm[];
  const int nk = pad16(n), ldp = nk + 4;
  float* Vs = sm;              // [nk][kLdV]
  float* Ps = Vs + nk * kLdV;  // [64][ldp]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, win = blockIdx.y, r0 = blockIdx.z * 64;
  const size_t C3 = 3 * (size_t)C;
  const float* base = qkv + (size_t)win * n * C3 + h * HD;
  for (int e = tid; e < nk * HD; e += 256) {
    const int j = e / HD, d = e % HD;
    Vs[j * kLdV + d] = j < n ? base[(size_t)j * C3 + 2 * C + d] : 0.f;
  }
  const float* Sw = S + ((size_t)win * nh + h) * nk * nk;
  for (int r = warp; r < 64; r += 8) {
    const int row = r0 + r;
    if (row >= n) continue;
    const float* srow = Sw + (size_t)row * nk;
    float m = -INFINITY, l = 0.f;
    for (int c = lane; c < nk; c += 32) m = fmaxf(m, srow[c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    for (int c = lane; c < nk; c += 32) l += expf(srow[c] - m);
    l = warp_sum(l);
    for (int c = lane; c < nk; c += 32) Ps[r * ldp + c] = expf(srow[c] - m) / l;
  }
  __syncthreads();
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  for (int j = 0; j < nk; ++j) {
    float vr[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) vr[c] = Vs[j * kLdV + tx * kCols + c];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = Ps[(ty * 4 + i) * ldp + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p, vr[c], acc[i][c]);
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
int launch(const float* qkv, const float* rh, const float* rw, float* S,
           float* out, int Bw, int n, int C, int nh, int kh, int kw,
           float scale, cudaStream_t st) {
  const int nk = pad16(n);
  size_t smem = logits_f32_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      logits_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  logits_f32<HD><<<dim3(nh, Bw, (nk + 63) / 64), 256, smem, st>>>(
      qkv, rh, rw, S, n, C, nh, kh, kw, scale);
  int e = (int)cudaGetLastError();
  if (e) return e;
  smem = pv_f32_smem<HD>(nk);
  err = cudaFuncSetAttribute(
      pv_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pv_f32<HD><<<dim3(nh, Bw, (n + 63) / 64), 256, smem, st>>>(qkv, S, out, n,
                                                              C, nh);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const __nv_bfloat16* qkv, const __nv_bfloat16* rh,
           const __nv_bfloat16* rw, float* S, __nv_bfloat16* out, int Bw,
           int n, int C, int nh, int kh, int kw, float scale,
           cudaStream_t st) {
  const TwoPhaseMma<HD> L(n, kh, kw);
  size_t smem = L.logits_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      logits_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  logits_mma<HD><<<dim3(nh, Bw, 2), 256, smem, st>>>(qkv, rh, rw, S, n, C,
                                                      nh, kh, kw, scale);
  int e = (int)cudaGetLastError();
  if (e) return e;
  smem = L.pv_bytes();
  err = cudaFuncSetAttribute(
      pv_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pv_mma<HD><<<dim3(nh, Bw, 2), 256, smem, st>>>(qkv, S, out, n, C, nh, kh,
                                                  kw);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* qkv, const void* rh, const void* rw,
              float* S, void* out, int Bw, int n, int C, int nh, int kh,
              int kw, float scale, cudaStream_t st) {
  const T* q = static_cast<const T*>(qkv);
  const T* a = static_cast<const T*>(rh);
  const T* b = static_cast<const T*>(rw);
  T* o = static_cast<T*>(out);
  if (hd == 80)
    return launch<80>(q, a, b, S, o, Bw, n, C, nh, kh, kw, scale, st);
  return launch<64>(q, a, b, S, o, Bw, n, C, nh, kh, kw, scale, st);
}

}  // namespace
}  // namespace ullsam

// Plain C entry point (loaded with ctypes). Returns 0 or a cudaError_t.
// dtype: 0 = float32, 1 = bfloat16 for qkv [Bw*n, 3C], rh [kh, kh, hd],
// rw [kw, kw, hd] and out [Bw*n, C]; scratch is float32 [Bw, nh, nk, nk]
// with nk = n rounded up to a multiple of 16, allocated by the caller.
// Requires hd in {64, 80}, n = kh * kw <= 256, kh + kw <= 64, nh * hd = C.
extern "C" int window_attn_twophase_forward(int dtype, const void* qkv,
                                            const void* rh, const void* rw,
                                            void* scratch, void* out, int Bw,
                                            int n, int C, int nh, int hd,
                                            int kh, int kw, void* stream) {
  using namespace ullsam;
  if (n > kMaxKeys || kh * kw != n || kh + kw > kMaxRel ||
      (hd != 64 && hd != 80) || nh * hd != C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf((float)hd);
  float* S = static_cast<float*>(scratch);
  if (dtype == kF32)
    return launch_hd<float>(hd, qkv, rh, rw, S, out, Bw, n, C, nh, kh, kw,
                            scale, st);
  if (dtype == kBF16)
    return launch_hd<__nv_bfloat16>(hd, qkv, rh, rw, S, out, Bw, n, C, nh, kh,
                                    kw, scale, st);
  return (int)cudaErrorInvalidValue;
}
