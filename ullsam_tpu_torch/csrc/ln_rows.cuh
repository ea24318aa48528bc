// LayerNorm rows for the port's ViT kernels (B1's first step, B13's
// prologue): one warp per token row, one-pass f32 statistics (E[x], E[x^2],
// as ops/layers.layer_norm from 32 channels up), the result rounded once to
// the row's type. With `masked`, the normed activations of a window's pad
// tokens are zeroed, the window geometry (nwx, nwy, Hv, Wv) rebuilt from the
// row index (B1).
#pragma once

#include "common.cuh"

namespace ullsam {
namespace {

template <typename T>
__global__ void __launch_bounds__(256)
    ln_mask_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ b, T* __restrict__ y, int rows,
                   int C, float eps, int n, int kh, int kw, int nwx, int nwy,
                   int Hv, int Wv, int masked) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * 8 + warp;
  if (r >= rows) return;
  const T* xr = x + (size_t)r * C;
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = to_f(xr[c]);
    s += v;
    s2 += v * v;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float m1 = s / C;
  const float var = fmaxf(s2 / C - m1 * m1, 0.f);
  const float rstd = rsqrtf(var + eps);
  bool valid = true;
  if (masked) {
    const int wi = (r / n) % (nwy * nwx);  // window index within its image
    const int t = r % n;
    const int row_img = (wi / nwx) * kh + t / kw;
    const int col_img = (wi % nwx) * kw + t % kw;
    valid = row_img < Hv && col_img < Wv;
  }
  T* yr = y + (size_t)r * C;
  for (int c = lane; c < C; c += 32) {
    const float v = (to_f(xr[c]) - m1) * rstd * to_f(w[c]) + to_f(b[c]);
    yr[c] = from_f<T>(valid ? v : 0.f);
  }
}

// y = LN(x) rows, no mask: grid (rows + 7) / 8, 256 threads
template <typename T>
int ln_rows(const T* x, const T* w, const T* b, T* y, int rows, int C,
            float eps, cudaStream_t st) {
  ln_mask_kernel<T><<<(rows + 7) / 8, 256, 0, st>>>(x, w, b, y, rows, C, eps,
                                                    1, 1, 1, 1, 1, 1, 1, 0);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ullsam
