// Hand-written GEMMs shared by the port's kernels (every product of the
// decoder kernels B4-B7, and B1's and B13's products at shapes
// gemm_sm90.cuh's kernel does not take):
//
//     out[m, n] = act(A[m, :] . W[n, :] + bias[n] + res[m % res_rows, n])
//
// A [M, K] and W [N, K] row-major (W is the natural [out, in] weight), the
// sums in f32, the result rounded once to the output type. act is the
// identity, ReLU, or the tanh-form GELU in f32 of the sum first rounded to
// the output type (B13's fc1: fc1 + b1 is rounded, then GELU'd and rounded
// again, as vit_block.py:60-70 does). `res_rows` lets one [res_rows, N] residual serve every
// block of res_rows output rows (a per-image term shared by all prompts);
// res_rows == M is the plain residual.
//   * float32: gemm_nt_f32, true f32 on the CUDA cores (FMA).
//   * bfloat16: gemm_nt_bf16_mma on the tensor cores (mma.sync m16n8k16,
//     f32 accumulation), output bf16 or f32.
#pragma once

#include "common.cuh"

namespace ullsam {
namespace {

constexpr int kGemmBM = 128, kGemmBN = 128, kGemmBK = 8;

// launches of each GEMM kernel made through this library (each .so has its
// own; gemm_launch_count below reads them for the Python wrappers): the
// bf16 mma.sync and wgmma kernels, gemm_sm90.cuh's f32 (split TF32) one and
// the f32 FMA kernel below
enum GemmKernel : int {
  kGemmMma = 0, kGemmSm90 = 1, kGemmF32Sm90 = 2, kGemmF32Fma = 3
};
long long gemm_launch_counts[4] = {0, 0, 0, 0};

// the epilogue's activation (the C entry points pass these as ints)
enum GemmAct : int { kActNone = 0, kActRelu = 1, kActGeluTanh = 2 };

// tanh-form GELU in f32 (vit_block.py `_gelu_tanh`)
__device__ __forceinline__ float gelu_tanh(float f) {
  const float inner = 0.7978845608028654f * (f + 0.044715f * (f * f * f));
  return 0.5f * f * (1.f + tanhf(inner));
}

template <typename OutT>
__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == kActRelu) return fmaxf(v, 0.f);
  if (act == kActGeluTanh) return gelu_tanh(round_to<OutT>(v));
  return v;
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---- f32 GEMM on the CUDA cores (FMA) -------------------------------------
// Block 128x128, k-tile 8, 256 threads each owning an 8x8 register tile
// (rows 4 ty.. and 64 + 4 ty.., columns 4 tx.. and 64 + 4 tx..). Each thread
// fetches one float4 of A and of W per k-tile into registers while the
// current k-tile is multiplied, then stores them into the other of two smem
// stages (k-major, so the 8x8 products read float4s). Requires K % 8 == 0
// and 16-byte aligned rows.
__global__ void __launch_bounds__(256)
    gemm_nt_f32(const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ bias, const float* __restrict__ res,
                int res_rows, float* __restrict__ out, int M, int N, int K,
                int act) {
  __shared__ __align__(16) float As[2][kGemmBK][kGemmBM + 4];
  __shared__ __align__(16) float Bs[2][kGemmBK][kGemmBN + 4];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kGemmBM, n0 = blockIdx.x * kGemmBN;
  const int lrow = tid >> 1, lk = (tid & 1) * 4;
  const int tx = tid & 15, ty = tid >> 4;
  const int gm = m0 + lrow, gn = n0 + lrow;
  const auto fetch = [&](const float* P, int g, int lim, int k0) {
    return g < lim ? *reinterpret_cast<const float4*>(P + (size_t)g * K + k0 +
                                                      lk)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  const auto stash = [&](float (*S)[kGemmBM + 4], float4 v) {
    S[lk][lrow] = v.x;
    S[lk + 1][lrow] = v.y;
    S[lk + 2][lrow] = v.z;
    S[lk + 3][lrow] = v.w;
  };
  float4 ra = fetch(A, gm, M, 0), rb = fetch(B, gn, N, 0);
  stash(As[0], ra);
  stash(Bs[0], rb);
  __syncthreads();

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int KT = K / kGemmBK;
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT) {
      ra = fetch(A, gm, M, (kt + 1) * kGemmBK);
      rb = fetch(B, gn, N, (kt + 1) * kGemmBK);
    }
#pragma unroll
    for (int kk = 0; kk < kGemmBK; ++kk) {
      const float* as = As[cur][kk];
      const float* bs = Bs[cur][kk];
      const float4 a0 = *reinterpret_cast<const float4*>(as + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(as + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    if (kt + 1 < KT) {  // the other stage was last read before the sync
      stash(As[cur ^ 1], ra);
      stash(Bs[cur ^ 1], rb);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
    const float* rrow = res ? res + (size_t)(m % res_rows) * N : nullptr;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int nn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (nn >= N) continue;
      float v = acc[i][j];
      if (bias) v += bias[nn];
      if (rrow) v += rrow[nn];
      out[(size_t)m * N + nn] = apply_act<float>(v, act);
    }
  }
}

// ---- bf16 tensor-core GEMM (mma.sync m16n8k16, f32 accumulate) ----------
// Block 128x128, k-tile 32, 8 warps of 64x32, operands staged by cp.async in
// two smem stages, fragments by ldmatrix. Rows of 32 bf16 are padded to 40
// (80 bytes) so ldmatrix is conflict-free. Requires K % 32 == 0 and
// N % 8 == 0 (checked by the C entry points).
constexpr int kMmaBM = 128, kMmaBN = 128, kMmaBK = 32, kMmaLd = kMmaBK + 8;

template <typename OutT>
__global__ void __launch_bounds__(256)
    gemm_nt_bf16_mma(const __nv_bfloat16* __restrict__ A,
                     const __nv_bfloat16* __restrict__ B,
                     const __nv_bfloat16* __restrict__ bias,
                     const __nv_bfloat16* __restrict__ res, int res_rows,
                     OutT* __restrict__ out, int M, int N, int K, int act) {
  __shared__ __align__(16) __nv_bfloat16 As[2][kMmaBM * kMmaLd];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][kMmaBN * kMmaLd];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * kMmaBM, n0 = blockIdx.x * kMmaBN;

  auto load = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 128 rows x 4 chunks of 16 B, twice
      const int c = tid + i * 256, row = c >> 2, ch = (c & 3) * 8;
      const int gm = m0 + row, gn = n0 + row;
      cp_async16(smem_u32(&As[stage][row * kMmaLd + ch]),
                 A + (size_t)(gm < M ? gm : 0) * K + k0 + ch, gm < M);
      cp_async16(smem_u32(&Bs[stage][row * kMmaLd + ch]),
                 B + (size_t)(gn < N ? gn : 0) * K + k0 + ch, gn < N);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  const int KT = K / kMmaBK;
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) {
      load((kt + 1) & 1, (kt + 1) * kMmaBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* as = As[kt & 1];
    const __nv_bfloat16* bs = Bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < kMmaBK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int row = wm * 64 + mi * 16 + (lane & 15);
        ldmatrix_x4(af[mi], smem_u32(as + row * kMmaLd + kk + (lane >> 4) * 8));
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int row = wn * 32 + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
        uint32_t r[4];
        ldmatrix_x4(r, smem_u32(bs + row * kMmaLd + kk +
                                ((lane >> 3) & 1) * 8));
        bfr[2 * nj][0] = r[0];
        bfr[2 * nj][1] = r[1];
        bfr[2 * nj + 1][0] = r[2];
        bfr[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16_16816(acc[mi][ni], af[mi], bfr[ni]);
    }
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = m0 + wm * 64 + mi * 16 + g + hf * 8;
        const int nn = n0 + wn * 32 + ni * 8 + 2 * t;
        if (m >= M || nn >= N) continue;
        float v0 = acc[mi][ni][2 * hf], v1 = acc[mi][ni][2 * hf + 1];
        if (bias) {
          v0 += __bfloat162float(bias[nn]);
          v1 += __bfloat162float(bias[nn + 1]);
        }
        if (res) {
          const size_t r = (size_t)(m % res_rows) * N + nn;
          v0 += __bfloat162float(res[r]);
          v1 += __bfloat162float(res[r + 1]);
        }
        store_pair(out + (size_t)m * N + nn, apply_act<OutT>(v0, act),
                   apply_act<OutT>(v1, act));
      }
}

// f32: CUDA-core FMA GEMM; bf16: the tensor-core GEMM
inline int gemm_nt(const float* A, const float* B, const float* bias,
                   const float* res, int res_rows, float* out, int M, int N,
                   int K, int act, cudaStream_t st) {
  dim3 grid((N + kGemmBN - 1) / kGemmBN, (M + kGemmBM - 1) / kGemmBM);
  gemm_nt_f32<<<grid, 256, 0, st>>>(A, B, bias, res, res_rows, out, M, N, K,
                                    act);
  const int err = (int)cudaGetLastError();
  if (!err) ++gemm_launch_counts[kGemmF32Fma];
  return err;
}

template <typename OutT>
int gemm_nt(const __nv_bfloat16* A, const __nv_bfloat16* B,
            const __nv_bfloat16* bias, const __nv_bfloat16* res, int res_rows,
            OutT* out, int M, int N, int K, int act, cudaStream_t st) {
  dim3 grid((N + kMmaBN - 1) / kMmaBN, (M + kMmaBM - 1) / kMmaBM);
  gemm_nt_bf16_mma<OutT><<<grid, 256, 0, st>>>(A, B, bias, res, res_rows, out,
                                               M, N, K, act);
  const int err = (int)cudaGetLastError();
  if (!err) ++gemm_launch_counts[kGemmMma];
  return err;
}

}  // namespace
}  // namespace ullsam

// launches of GEMM kernel `kernel` (0: the bf16 mma.sync kernel, 1: the
// bf16 wgmma + TMA kernel of gemm_sm90.cuh, 2: its f32 split-TF32 kind, 3:
// the f32 FMA kernel) made by this library so far
extern "C" long long gemm_launch_count(int kernel) {
  return kernel >= 0 && kernel < 4 ? ullsam::gemm_launch_counts[kernel] : -1;
}
