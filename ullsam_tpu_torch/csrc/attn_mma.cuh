// Warp-level attention on the tensor cores (bf16 in, f32 accumulate), shared
// by the bf16 paths of B2 / B14 (global flash) and B10 (LLM flash).
//
// A warp owns 16 query rows: their q as mma A fragments in registers, the
// running max m, partial row sums l and the output accumulator acc in
// registers (FlashAttention-2 layout). Keys and values sit in shared memory
// as rows of HD bf16 with stride HD + 8 (ldmatrix conflict-free), and are
// consumed in chunks of up to 64 keys:
//   s = (q . k) * scale + bias(row, key)    (keys >= nvalid: weight 0)
//   online softmax in f32 (in base 2: exp2 of s * log2 e, one MUFU op per
//   logit); p rounded to bf16 into the A fragments of p . v.
// Fragment layouts are those of mma.m16n8k16: thread (g = lane/4, t = lane%4)
// holds rows g and g + 8, columns 2t and 2t + 1 of each 8-wide tile.
#pragma once

#include "common.cuh"

namespace ullsam {

template <int HD>
struct AttnWarp {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  static constexpr int kLd = HD + 8;
  static constexpr float kLog2e = 1.4426950408889634f;
  uint32_t qf[HD / 16][4];
  float m[2] = {-1e30f, -1e30f};  // running max of s * log2 e
  float l[2] = {0.f, 0.f};
  float acc[HD / 8][4];

  // q rows [row0, row0 + 16) of a [rows][kLd] smem tile; resets the state
  __device__ __forceinline__ void begin(const __nv_bfloat16* qs, int row0,
                                        int lane) {
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      ldmatrix_x4(qf[ks], smem_u32(qs + (row0 + (lane & 15)) * kLd + ks * 16 +
                                   (lane >> 4) * 8));
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
  }

  // keys [0, 16 * nk16) of the smem tiles ks / vs (rows = keys), numbered
  // from key0; nk16 <= 4. bias(hf, key) is the additive bias of this
  // thread's row g + 8 hf.
  template <class Bias>
  __device__ __forceinline__ void chunk(const __nv_bfloat16* ks,
                                        const __nv_bfloat16* vs, int nk16,
                                        int key0, int nvalid, float scale,
                                        const Bias& bias, int lane) {
    const int t = lane & 3;
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
        ldmatrix_x4(b, smem_u32(ks +
                                (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                    kLd +
                                kd * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16_16816(s[2 * nj], qf[kd], b);
        mma_bf16_16816(s[2 * nj + 1], qf[kd], b + 2);
      }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + j * 8 + 2 * t + e;
        const bool ok = j < 2 * nk16 && key < nvalid;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float& x = s[j][2 * hf + e];
          x = ok ? (x * scale + bias(hf, key)) * kLog2e : -INFINITY;
          mx[hf] = fmaxf(mx[hf], x);
        }
      }
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      alpha[hf] = exp2f(m[hf] - mx[hf]);
      m[hf] = mx[hf];
      l[hf] *= alpha[hf];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] = exp2f(s[j][c] - m[c >> 1]);
        l[c >> 1] += s[j][c];
      }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] *= alpha[c >> 1];

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk >= nk16) break;
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dj = 0; dj < HD / 16; ++dj) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, smem_u32(vs +
                        (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                        dj * 16 + (lane >> 4) * 8));
        mma_bf16_16816(acc[2 * dj], pa, b);
        mma_bf16_16816(acc[2 * dj + 1], pa, b + 2);
      }
    }
  }

  // sums the partial row sums over the quad; returns 1 / l per row half
  __device__ __forceinline__ void finish(float (&inv)[2]) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
      inv[hf] = 1.f / l[hf];
    }
  }

  // natural-log logsumexp of row half hf (after finish)
  __device__ __forceinline__ float lse(int hf) const {
    return m[hf] * 0.6931471805599453f + logf(l[hf]);
  }
};

}  // namespace ullsam
