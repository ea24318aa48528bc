// The one bf16 windowed attention core of the port, for Hopper (sm_90a):
// B1's core (window_attn.cu `forward`), B3 (`window_attn_core_forward`)
// and B15 (window_attn_twophase.cu `window_attn_twophase_forward`) all
// launch `window_core_bf16` below, so the three give bitwise-equal results.
//
// It computes, for each window of n = kh*kw tokens and each head of HD
// channels,
//     o = softmax(q k^T * hd^-1/2 + bias) v
//     bias[i, m] = q_i . Rh[row(i), row(m)] + q_i . Rw[col(i), col(m)]
// on the natural layout (qkv [Bw*n, 3C], head h at h*HD of q | k | v;
// tables rh [kh, kh, HD], rw [kw, kw, HD]; o [Bw*n, C]) at the JAX
// kernels' rounding points (vit_block.py:275-279, flash_attention.py:
// 1056-1060 and :1064-1103): a row's whole f32 logits, its exact max and
// sum, p normalized and then rounded to bf16, p.v summed in f32 and o
// rounded once.
//
// What bounds it on this card: bytes, and in practice latency. At ViT-H (25
// windows x 16 heads of 80) a call is 4.9 GFLOP (5 us at the bf16 peak)
// and moves qkv and o once (50 MB, 15 us at the memory rate). A block
// holds a row of logits a warp in registers (up to 255 a thread), so one
// block fits an SM: with a block per (head, window, query half) each one
// loads, forms its rel-pos terms, then multiplies, with nothing to
// overlap its loads (about 15 us a block).
//
// Design:
//   * Persistent blocks, one an SM (grid = min(units, SMs)), each walking a
//     contiguous range of units. A unit is a (head, window, query half);
//     the two halves of a (head, window) are neighbours, so a block that
//     takes both loads k and v once for them. The range split leaves every
//     block with floor or ceil of units / SMs (6 or 7 at ViT-H); 800 blocks
//     of one unit would leave a last wave 6% full.
//   * Two slots for k and v and two for q, filled by cp.async: while the
//     block works on one unit, the next unit's q (and, at a new window, its
//     k and v) are in flight.
//   * Per unit: the rows' rel-pos terms in f32 on the tensor cores (rows of
//     one window row all use Rh[y], rows of one window column Rw[x]: each
//     group is a [16 x HD] . [HD x 16] product, common.cuh
//     window_rel_terms_mma, two groups' tables loaded at a time); then
//     a warp a 16-row query tile: its whole row of logits in mma.sync
//     m16n8k16 accumulators (NT = kh key tiles, a template argument so the
//     row stays in registers), the exact row max and sum by quad shuffles,
//     p normalized and rounded into bf16 A fragments, p.v on the tensor
//     cores. A half has at most 8 tiles (n <= 256); at n = 196, 7 and 6.
//   * Keys sit in slots of 16 a window row (kw <= 16): a logit's window row
//     is then known at compile time and its column is one of four a
//     thread, so adding the rel-pos bias costs two registers and an add.
//     Finding each key's row and column by a division and reading both
//     terms from shared memory costs about 25 instructions a logit: with 8
//     warps an SM that latency-bound loop took 70% of the core's time.
//   * Rows are HD bf16 in shared memory. HD 64 pads them to 72 (ldmatrix
//     conflict-free); HD 80 keeps 80 (160 bytes, so both slots fit a block)
//     and swaps the two 16-byte chunks of each pair in rows 4-7 of every 8
//     (WinCoreLayout::off), which takes ldmatrix's 8 rows to 8 distinct
//     bank groups.
#pragma once

#include "common.cuh"

namespace ullsam {
namespace {

constexpr int kCoreMaxSide = 16;  // windows of at most 16 x 16 tokens
constexpr float kCoreLog2e = 1.4426950408889634f;

__host__ __device__ inline int core_pad16(int n) { return (n + 15) / 16 * 16; }

// must match ops/kernels/window_attention.py core_smem_bytes
template <int HD>
struct WinCoreLayout {
  static constexpr int kLd = HD == 80 ? 80 : HD + 8;  // bf16 a row
  // nk key slots (16 a window row), nq 16-row query tiles, half of them a
  // unit, nz units a (head, window)
  int nk, nq, half, nz, rl;
  __host__ __device__ WinCoreLayout(int n, int kh, int kw)
      : nk(16 * kh), nq(core_pad16(n) / 16), half((nq + 1) / 2),
        nz((nq + half - 1) / half), rl(kh + kw) {}
  __host__ __device__ size_t kv_elems() const { return (size_t)2 * nk * kLd; }
  __host__ __device__ size_t q_elems() const { return (size_t)half * 16 * kLd; }
  // two k|v slots, two q slots (bf16), the unit's rel-pos terms (f32)
  __host__ __device__ size_t bytes() const {
    return sizeof(__nv_bfloat16) * 2 * (kv_elems() + q_elems()) +
           sizeof(float) * (size_t)half * 16 * rl;
  }
  // element offset of 16-byte chunk ch of row r
  __device__ __forceinline__ static int off(int r, int ch) {
    if constexpr (HD == 80) return r * kLd + ((ch ^ ((r >> 2) & 1)) << 3);
    return r * kLd + (ch << 3);
  }
};

// grid min(units, SMs), 256 threads, one block an SM; NT = kh: key slot
// 16 kr + kc holds the key of window row kr, column kc (kw <= 16; slots
// with kc >= kw are zero and masked), so a thread's slots j * 8 + 2 t + e
// sit in window row j / 2 (known at compile time) and in one of four
// columns (2 t + e, 8 + 2 t + e): its bias terms are a few registers, not
// a division and two table reads a logit.
template <int HD, int NT>
__global__ void __launch_bounds__(256, 1)
    window_core_bf16(const __nv_bfloat16* __restrict__ qkv,
                     const __nv_bfloat16* __restrict__ rh,
                     const __nv_bfloat16* __restrict__ rw,
                     __nv_bfloat16* __restrict__ out, int n, int C, int nh,
                     int kh, int kw, int units, float scale) {
  using bf16 = __nv_bfloat16;
  using Lay = WinCoreLayout<HD>;
  constexpr int kChunks = HD / 8;  // 16-byte chunks a row
  const Lay L(n, kh, kw);
  extern __shared__ __align__(16) unsigned char smraw[];
  bf16* KV[2] = {reinterpret_cast<bf16*>(smraw),
                 reinterpret_cast<bf16*>(smraw) + L.kv_elems()};
  bf16* Q[2] = {KV[1] + L.kv_elems(), KV[1] + L.kv_elems() + L.q_elems()};
  float* RB = reinterpret_cast<float*>(Q[1] + L.q_elems());

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t C3 = 3 * (size_t)C;
  const int u0 = (int)((long long)blockIdx.x * units / gridDim.x);
  const int u1 = (int)((long long)(blockIdx.x + 1) * units / gridDim.x);
  // unit u: item u / nz = (window, head), query tiles from (u % nz) * half
  const auto base = [&](int u) {
    const int item = u / L.nz;
    return qkv + (size_t)(item / nh) * n * C3 + (item % nh) * HD;
  };
  const auto load_q = [&](int u, bf16* dst) {
    const bf16* src = base(u);
    const int r0 = (u % L.nz) * L.half * 16;
    for (int c = tid; c < L.half * 16 * kChunks; c += 256) {
      const int row = c / kChunks, ch = c % kChunks;
      const bool ok = r0 + row < n;
      cp_async16(smem_u32(dst + Lay::off(row, ch)),
                 src + (size_t)(ok ? r0 + row : 0) * C3 + ch * 8, ok);
    }
  };
  const auto load_kv = [&](int u, bf16* dst) {
    const bf16* src = base(u);
    for (int c = tid; c < L.nk * kChunks; c += 256) {
      const int row = c / kChunks, ch = c % kChunks;  // row: a key slot
      const bool ok = (row & 15) < kw;
      const int key = (row >> 4) * kw + (row & 15);
      const bf16* s = src + (size_t)(ok ? key : 0) * C3 + ch * 8;
      cp_async16(smem_u32(dst + Lay::off(row, ch)), s + C, ok);
      cp_async16(smem_u32(dst + L.nk * Lay::kLd + Lay::off(row, ch)),
                 s + 2 * C, ok);
    }
  };

  int kvs = 0;
  if (u0 < u1) {
    load_kv(u0, KV[0]);
    load_q(u0, Q[0]);
  }
  cp_async_commit();
  for (int u = u0; u < u1; ++u) {
    const int qs = (u - u0) & 1;
    cp_async_wait<0>();
    // this unit's q, k, v have landed; every warp is done with the last
    // unit, so its q slot, the other k|v slot and RB are free
    __syncthreads();
    const bool new_kv = u + 1 < u1 && (u + 1) / L.nz != u / L.nz;
    if (u + 1 < u1) {
      load_q(u + 1, Q[qs ^ 1]);
      if (new_kv) load_kv(u + 1, KV[kvs ^ 1]);
    }
    cp_async_commit();
    const bf16* Qs = Q[qs];
    const bf16* Ks = KV[kvs];
    const bf16* Vs = Ks + L.nk * Lay::kLd;
    const int item = u / L.nz, qt0 = (u % L.nz) * L.half;
    const int qt1 = min(L.nq, qt0 + L.half), r0 = qt0 * 16;
    constexpr int kBatch = HD == 80 && NT > 14 ? 1 : 2;
    window_rel_terms_mma<HD, kBatch>(
        Qs, [](int r, int ch) { return Lay::off(r, ch); }, r0,
        r0 + L.half * 16, rh, rw, n, kh, kw, RB, L.rl, warp, 8, lane);
    __syncthreads();

    const int qt = qt0 + warp;
    if (qt < qt1) {
      const int lr = warp * 16;  // local row of this tile
      // phase 1: the 16 rows' logits against every key, in registers
      float s[2 * NT][4];
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd) {
        uint32_t qf[4];
        ldmatrix_x4(qf, smem_u32(Qs + Lay::off(lr + (lane & 15),
                                               2 * kd + (lane >> 4))));
#pragma unroll
        for (int nj = 0; nj < NT; ++nj) {
          uint32_t b[4];
          ldmatrix_x4(b, smem_u32(Ks + Lay::off(nj * 16 + (lane & 7) +
                                                    ((lane >> 4) << 3),
                                                2 * kd + ((lane >> 3) & 1))));
          mma_bf16_16816(s[2 * nj], qf, b);
          mma_bf16_16816(s[2 * nj + 1], qf, b + 2);
        }
      }
      // scale and bias (in base 2), then the exact row max. Row g + 8 hf's
      // terms: rh[kr] = RB[row][kr]; rw[c2][e] = RB[row][kh + kc] for kc =
      // 8 c2 + 2 t + e, -inf where kc >= kw (an empty slot)
      const float* rb0 = RB + (lr + g) * L.rl;
      float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float* rb = rb0 + hf * 8 * L.rl;
        float rwv[2][2];
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kc = 8 * c2 + 2 * t + e;
            rwv[c2][e] = kc < kw ? rb[kh + kc] : -INFINITY;
          }
#pragma unroll
        for (int j = 0; j < 2 * NT; ++j) {
          const float rhv = rb[j >> 1];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[j][2 * hf + e];
            x = fmaf(x, scale, rhv + rwv[j & 1][e]) * kCoreLog2e;
            m[hf] = fmaxf(m[hf], x);
          }
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
              b, smem_u32(Vs + Lay::off(kk * 16 + (lane & 7) +
                                            ((lane >> 3) & 1) * 8,
                                        2 * dj + (lane >> 4))));
          mma_bf16_16816(acc[2 * dj], pa[kk], b);
          mma_bf16_16816(acc[2 * dj + 1], pa[kk], b + 2);
        }
      bf16* obase = out + (size_t)(item / nh) * n * C + (item % nh) * HD;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = qt * 16 + g + hf * 8;
        if (row >= n) continue;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(obase + (size_t)row * C + j * 8 +
                                             2 * t) =
              __floats2bfloat162_rn(acc[j][2 * hf], acc[j][2 * hf + 1]);
      }
    }
    if (new_kv) kvs ^= 1;
  }
}

// the instance whose NT is nt = kh (1 <= nt <= 16)
template <int HD, int NT = 1>
int launch_window_core(int nt, const __nv_bfloat16* qkv,
                       const __nv_bfloat16* rh, const __nv_bfloat16* rw,
                       __nv_bfloat16* out, int Bw, int n, int C, int nh,
                       int kh, int kw, float scale, cudaStream_t st) {
  if constexpr (NT < kCoreMaxSide) {
    if (nt != NT)
      return launch_window_core<HD, NT + 1>(nt, qkv, rh, rw, out, Bw, n, C,
                                            nh, kh, kw, scale, st);
  }
  const WinCoreLayout<HD> L(n, kh, kw);
  const size_t smem = L.bytes();
  cudaError_t err = cudaFuncSetAttribute(
      window_core_bf16<HD, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int units = Bw * nh * L.nz;
  const int grid = min(units, sm_count());
  window_core_bf16<HD, NT><<<grid, 256, smem, st>>>(qkv, rh, rw, out, n, C,
                                                     nh, kh, kw, units, scale);
  return (int)cudaGetLastError();
}

// The bf16 core at a runtime head dim (64 or 80; checked by the caller):
// qkv [Bw*n, 3C], rh [kh, kh, hd], rw [kw, kw, hd], out [Bw*n, C], windows
// of at most 16 x 16 (n = kh kw; at 16 x 16 and hd 80 the block holds
// 221,184 bytes of shared memory).
inline int window_core(int hd, const __nv_bfloat16* qkv,
                       const __nv_bfloat16* rh, const __nv_bfloat16* rw,
                       __nv_bfloat16* out, int Bw, int n, int C, int nh,
                       int kh, int kw, cudaStream_t st) {
  if (kh < 1 || kw < 1 || kh > kCoreMaxSide || kw > kCoreMaxSide ||
      kh * kw != n)
    return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)hd);
  if (hd == 80)
    return launch_window_core<80>(kh, qkv, rh, rw, out, Bw, n, C, nh, kh, kw,
                                  scale, st);
  return launch_window_core<64>(kh, qkv, rh, rw, out, Bw, n, C, nh, kh, kw,
                                scale, st);
}

}  // namespace
}  // namespace ullsam
