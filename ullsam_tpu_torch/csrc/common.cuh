// Shared helpers for the port's hand-written Hopper kernels.
//
// Storage is float or __nv_bfloat16; arithmetic is always f32: bf16 values
// are widened on load and rounded (round-to-nearest-even) exactly where the
// reference rounds.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ullsam {

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T's precision (the plain version's cast points)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- tensor-core building blocks (sm_80+ PTX, used on sm_90a) ----------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int bytes = pred ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// two floats -> one register of two bf16 (lo in the low half), RNE
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}


// a / d for 0 <= a < 2^16 and 1 <= d <= 64, given inv = 1.f / d: (a + 0.5)
// / d stays at least 1 / (2 d) away from an integer, far beyond the float
// rounding of the product, so truncation is exact (no integer divide)
__device__ __forceinline__ int div_small(int a, float inv) {
  return __float2int_rz((static_cast<float>(a) + 0.5f) * inv);
}

// The rel-pos terms RB[r][i] = q_r . Rh[row(r), i] (i < kh), q_r .
// Rw[col(r), i - kh] of a window's query rows, in bf16 on the tensor cores,
// for windows of at most 16 x 16: the rows of window row y (y*kw .. y*kw + kw - 1) all use
// Rh[y], the rows of window column x (x, x + kw, ...) all use Rw[x], so
// each group is one product [16 rows x HD] . [HD x 16] (mma.sync m16n8k16:
// A rows by ldmatrix from the q tile, B straight from the table in device
// memory). The q tile qs holds queries [q0, q1), row r - q0 of 16-byte
// chunk ch at element off(r - q0, ch); RB's rows likewise (row stride
// ldrb), its rows past n set to 0. Groups with no row in [q0, q1) are
// skipped. A warp takes groups it, it + nwarps, ... kBatch at a time,
// their table fragments loaded from L2 together before any product. Exact
// products, f32 sums. Every warp of the block (nwarps of them) must call
// it; the caller synchronises after.
template <int HD, int kBatch, class Off>
__device__ __forceinline__ void window_rel_terms_mma(
    const __nv_bfloat16* qs, Off off, int q0, int q1,
    const __nv_bfloat16* rh, const __nv_bfloat16* rw, int n, int kh, int kw,
    float* RB, int ldrb, int warp, int nwarps, int lane) {
  const int g = lane >> 2, t = lane & 3, rl = kh + kw;
  for (int e = warp * 32 + lane; e < (q1 - max(q0, n)) * rl;
       e += nwarps * 32)
    RB[(max(q0, n) - q0 + e / rl) * ldrb + e % rl] = 0.f;
  const int items = kh + kw;  // Rh[y] for y < kh, then Rw[x] for x < kw
  for (int it0 = warp; it0 < items; it0 += nwarps * kBatch) {
    uint32_t b[kBatch][2][HD / 16][2];
    bool use[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int it = it0 + nwarps * q;
      const bool isw = it >= kh;
      const int grp = isw ? it - kh : it;  // y or x
      use[q] = it < items &&
               (isw || (grp * kw < q1 && grp * kw + kw > q0));
      if (!use[q]) continue;
      const int ncol = isw ? kw : kh;
      const __nv_bfloat16* tab = isw ? rw + (size_t)grp * kw * HD
                                     : rh + (size_t)grp * kh * HD;
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const __nv_bfloat16* trow =
            tab + (size_t)min(c2 * 8 + g, ncol - 1) * HD + 2 * t;
#pragma unroll
        for (int kd = 0; kd < HD / 16; ++kd) {
          b[q][c2][kd][0] = *reinterpret_cast<const uint32_t*>(trow + kd * 16);
          b[q][c2][kd][1] =
              *reinterpret_cast<const uint32_t*>(trow + kd * 16 + 8);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      if (!use[q]) continue;
      const int it = it0 + nwarps * q;
      const bool isw = it >= kh;
      const int grp = isw ? it - kh : it;
      const int len = isw ? kh : kw, ncol = isw ? kw : kh;
      const int step = isw ? kw : 1, first = isw ? grp : grp * kw;
      // this lane's A row (ldmatrix), clamped into the tile when unused
      const int ja = lane & 15, ra = first + ja * step;
      const int la = (ja < len && ra >= q0 && ra < q1) ? ra - q0 : 0;
      uint32_t a[HD / 16][4];
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd)
        ldmatrix_x4(a[kd], smem_u32(qs + off(la, 2 * kd + (lane >> 4))));
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kd = 0; kd < HD / 16; ++kd)
          mma_bf16_16816(acc, a[kd], b[q][c2][kd]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int jr = g + 8 * (c >> 1), col = c2 * 8 + 2 * t + (c & 1);
          const int row = first + jr * step;
          if (jr < len && col < ncol && row >= q0 && row < q1)
            RB[(row - q0) * ldrb + (isw ? kh : 0) + col] = acc[c];
        }
      }
    }
  }
}

// the card's SM count (persistent grids), read once
inline int sm_count() {
  static const int count = [] {
    int dev = 0, v = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return count;
}

// dtype codes shared with the Python wrappers
enum DType : int { kF32 = 0, kBF16 = 1 };

}  // namespace ullsam
