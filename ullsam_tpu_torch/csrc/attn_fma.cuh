// Block-level attention on the CUDA cores in true f32 (FMA, no TF32), shared
// by the float32 paths of B2 (global flash) and B10 (the LLM's flash).
//
// 256 threads work on 64 query rows against a 64-key tile: thread (ty, tx) =
// (tid / 16, tid % 16) holds the logits of rows 4 ty .. 4 ty + 3 and keys
// 4 tx .. 4 tx + 3, and the output columns tx * kCols .. + kCols of its rows.
// Queries and keys sit in shared memory d-major (Qt, Kt [HD][kLdT]), values
// row-major (Vs [64][kLdV]); a tile's probabilities pass through Ps
// [64][kLdP]. Per key tile:
//   s = (q . k) * scale + bias(row, key)    (a bias of -1e30 masks a key)
//   online softmax in f32, the row max and sum taken over the 16 threads of
//   a row group (one half-warp) by shuffles; then acc += p . v.
#pragma once

#include "common.cuh"

namespace ullsam {

template <int HD>
struct AttnBlockF32 {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  static constexpr int kRows = 64, kKeys = 64, kCols = HD / 16;
  static constexpr int kLdT = kRows + 4;  // Qt / Kt, one row per d
  static constexpr int kLdV = HD + 4;
  static constexpr int kLdP = kKeys + 4;
  // floats of the four tiles Qt, Kt, Vs, Ps
  static constexpr size_t kSmemFloats =
      (size_t)2 * HD * kLdT + kKeys * kLdV + kRows * kLdP;

  int tx, ty;
  float m[4], l[4], acc[4][kCols];

  __device__ __forceinline__ void begin(int tid) {
    tx = tid & 15;
    ty = tid >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -1e30f;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
    }
  }

  // keys key0 .. key0 + 63 of the tiles Kt / Vs (filled and synchronised by
  // the caller, which also synchronises before refilling them); bias(r, key)
  // is the additive bias of local row r
  template <class Bias>
  __device__ __forceinline__ void tile(const float* Qt, const float* Kt,
                                       const float* Vs, float* Ps, int key0,
                                       float scale, const Bias& bias) {
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * kLdT + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(Kt + d * kLdT + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      float mx = -1e30f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] * scale + bias(r, key0 + tx * 4 + j);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[r * kLdP + tx * 4 + j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < kKeys; ++j) {
      float vr[kCols];
      const float* vrow = Vs + j * kLdV + tx * kCols;
      if constexpr (kCols == 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(vrow);
        vr[0] = v4.x, vr[1] = v4.y, vr[2] = v4.z, vr[3] = v4.w;
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) vr[c] = vrow[c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty * 4 + i) * kLdP + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p, vr[c], acc[i][c]);
      }
    }
  }

  // first output column of this thread
  __device__ __forceinline__ int col0() const { return tx * kCols; }
};

}  // namespace ullsam
