// A Hopper GEMM for the bf16 products of B1 (qkv, proj) and B13 (fc1, fc2):
//
//     out[m, n] = act(A[m, :] . W[n, :] + bias[n] + res[m, n])
//
// A [M, K] and W [N, K] row-major (both K-major: wgmma's native NT case, no
// transpose), the sums in f32, out bf16 rounded once; the epilogue is
// gemm.cuh's (apply_act: bias, the tanh-GELU of the sum first rounded to
// bf16, the residual added in f32).
//
// What bounds it: operations. B13's products at ViT-H (T = 4900, C = 1280,
// F = 5120) are 64 GFLOP each against 26-63 MB; gemm.cuh's mma.sync kernel
// reached 198-217 TFLOP/s on them, cuBLAS 519-522 (H100 80GB HBM3, 700 W).
//
// Design (the usual Hopper shape):
//   * 128 x 128 output tiles, k-blocks of 64 (128 bytes of bf16: one row of
//     the 128-byte swizzle), a ring of kStages shared-memory stages.
//   * One producer warp: a single thread issues the TMA loads of A's and
//     W's tiles (cuTensorMapEncodeTiled maps, 128-byte swizzle; rows past
//     M come back as zeros) and arms each stage's `full` mbarrier with the
//     byte count; it waits on the stage's `empty` mbarrier before reuse.
//   * Two consumer warpgroups taking the block's tiles in turn (ping-pong):
//     each multiplies a whole tile, two wgmma.mma_async m64n128k16 a 16-deep
//     step from shared-memory descriptors (K-major, 128-byte swizzle,
//     1024-byte row groups), f32 accumulators in registers (128 a thread),
//     one group in flight; a stage is released once the wgmma group that
//     read it has completed. Its epilogue overlaps the other warpgroup's
//     products: each warp stages 8 rows at a time in f32 in shared memory
//     and writes them back as whole rows, 16 bytes a lane (rows >= M
//     masked); bias, residual and activation are applied there in f32.
//   * Persistent: grid = min(tiles, SMs), each block walks tiles t, t +
//     grid, ...; the producer runs ahead into the next tile. Splitting each
//     tile's rows between the two warpgroups instead leaves the tensor
//     cores idle through every epilogue, and storing 4 bytes a lane from
//     the accumulator layout makes the epilogue longer than a tile's
//     products (H100: 280-546 and 315-594 TFLOP/s against 390-650).
// Shapes it takes (sm90_takes, mirrored by ops/kernels/gemm.py): N % 128 ==
// 0, K % 64 == 0, any M >= 1, 16-byte aligned operands. Other bf16 shapes
// run gemm.cuh's mma.sync kernel; gemm_bf16 makes that choice.
#pragma once

#include <cuda.h>

#include "gemm.cuh"

namespace ullsam {
namespace {

constexpr int kSm90BM = 128, kSm90BN = 128, kSm90BK = 64, kSm90Stages = 5;
constexpr int kSm90Threads = 288;  // two consumer warpgroups + one warp
constexpr int kSm90StageBytes = (kSm90BM + kSm90BN) * kSm90BK * 2;
// a consumer warp's epilogue staging: 8 rows of the tile in f32, rows
// padded to 136 floats (its float2 writes and 16-byte reads conflict-free)
constexpr int kSm90StgLd = kSm90BN + 8;
constexpr int kSm90StgBytes = 8 * 8 * kSm90StgLd * 4;  // the 8 warps
// the stages (1024 bytes to align them), the staging, the mbarriers (full
// and empty a stage, and the two warpgroups' turns); must match
// ops/kernels/gemm.py sm90_smem_bytes
constexpr int kSm90SmemBytes = 1024 + kSm90Stages * kSm90StageBytes +
                               kSm90StgBytes + (2 * kSm90Stages + 2) * 8;

inline bool sm90_takes(int M, int N, int K) {
  return M >= 1 && N >= kSm90BN && N % kSm90BN == 0 && K >= kSm90BK &&
         K % kSm90BK == 0;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// TMA: the box at (c0 along K, c1 along rows) of map into dst; completes
// its bytes on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile with the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO), LBO unused by this layout
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, both from shared memory
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__global__ void __launch_bounds__(kSm90Threads, 1)
    gemm_nt_sm90(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_w,
                 const __nv_bfloat16* __restrict__ bias,
                 const __nv_bfloat16* __restrict__ res,
                 __nv_bfloat16* __restrict__ out, int M, int N, int K,
                 int act) {
  using bf16 = __nv_bfloat16;
  extern __shared__ unsigned char smraw[];
  unsigned char* base = smraw + ((1024 - (smem_u32(smraw) & 1023)) & 1023);
  // stage s: A [128][64] then W [128][64], each 16 KB, 1024-byte aligned
  const auto stage_a = [&](int s) {
    return reinterpret_cast<bf16*>(base + s * kSm90StageBytes);
  };
  const auto stage_w = [&](int s) {
    return reinterpret_cast<bf16*>(base + s * kSm90StageBytes +
                                   kSm90BM * kSm90BK * 2);
  };
  float* stg = reinterpret_cast<float*>(base + kSm90Stages * kSm90StageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      base + kSm90Stages * kSm90StageBytes + kSm90StgBytes);
  uint64_t* empty = full + kSm90Stages;
  uint64_t* turn = empty + kSm90Stages;  // turn[w]: warpgroup w may multiply

  const int tid = threadIdx.x, wg = tid / 128;
  const int tiles_n = N / kSm90BN;
  const int tiles = (M + kSm90BM - 1) / kSm90BM * tiles_n;
  const int kt = K / kSm90BK;
  if (tid == 0) {
    for (int s = 0; s < kSm90Stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);  // released by the warpgroup that read it
    }
    mbar_init(&turn[0], 1);
    mbar_init(&turn[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the block's tiles j = 0, 1, ... are tiles blockIdx.x + j * gridDim.x;
  // k-block kb of tile j sits in stage (j * kt + kb) % kSm90Stages
  if (wg == 2) {  // the producer warp
    if (tid == 256) {
      int s = 0, ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / tiles_n * kSm90BM, n0 = t % tiles_n * kSm90BN;
        for (int kb = 0; kb < kt; ++kb) {
          mbar_wait(&empty[s], ph ^ 1);
          mbar_expect_tx(&full[s], kSm90StageBytes);
          tma_load_2d(stage_a(s), &map_a, &full[s], kb * kSm90BK, m0);
          tma_load_2d(stage_w(s), &map_w, &full[s], kb * kSm90BK, n0);
          if (++s == kSm90Stages) s = 0, ph ^= 1;
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: the block's tiles wg, wg + 2, ..., each whole
  // (rows 0-63 in d[0], 64-127 in d[1]); while one warpgroup writes a
  // tile's epilogue the other multiplies the next. The products take
  // turns: tile j's start waits until tile j - 1's last stage has arrived
  // (turn[wg]), so a warpgroup never waits on a stage's barrier two
  // phases early (a parity wait cannot tell those apart)
  const int lane = tid & 31, wrow = (tid & 127) >> 5;
  const int g = lane >> 2, tq = lane & 3;
  int turns = 0;
  for (int j = wg;; j += 2) {
    const int t = blockIdx.x + j * gridDim.x;
    if (t >= tiles) break;
    if (j > 0) mbar_wait(&turn[wg], turns++ & 1);
    const int m0 = t / tiles_n * kSm90BM, n0 = t % tiles_n * kSm90BN;
    float d[2][64];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) d[h][i] = 0.f;
    int prev = -1;
    for (int kb = 0; kb < kt; ++kb) {
      const int idx = j * kt + kb;
      const int s = idx % kSm90Stages, ph = (idx / kSm90Stages) & 1;
      mbar_wait(&full[s], ph);
      const bf16* a = stage_a(s);
      const bf16* w = stage_w(s);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kSm90BK / 16; ++k) {
        const uint64_t dw = sw128_desc(w + k * 16);
        wgmma_m64n128k16(d[0], sw128_desc(a + k * 16), dw, kb > 0 || k > 0);
        wgmma_m64n128k16(d[1], sw128_desc(a + 64 * kSm90BK + k * 16), dw,
                         kb > 0 || k > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the group that read stage `prev` has completed
      if (prev >= 0 && (tid & 127) == 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    if ((tid & 127) == 0) mbar_arrive(&turn[wg ^ 1]);
    wgmma_wait<0>();
    if ((tid & 127) == 0) mbar_arrive(&empty[prev]);

    // epilogue, 8 rows at a time through this warp's f32 staging: the
    // accumulators go in by the accumulator layout (d[h][4i + c] is row
    // 64 h + 16 wrow + g (+8 for c >= 2), column 8i + 2tq + (c & 1)), then
    // each lane takes 8 columns of a row: bias, residual and activation in
    // f32, and one 16-byte store (a warp writes two whole 256-byte rows)
    float* ws = stg + (tid >> 5) * 8 * kSm90StgLd;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        __syncwarp();
#pragma unroll
        for (int i = 0; i < kSm90BN / 8; ++i)
          *reinterpret_cast<float2*>(ws + g * kSm90StgLd + 8 * i + 2 * tq) =
              make_float2(d[h][4 * i + 2 * hf], d[h][4 * i + 2 * hf + 1]);
        __syncwarp();
        const int mr = m0 + h * 64 + wrow * 16 + hf * 8;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = lane + 32 * k, r = c >> 4, cc = (c & 15) * 8;
          const int m = mr + r;
          if (m >= M) continue;
          const float4 a0 =
              *reinterpret_cast<const float4*>(ws + r * kSm90StgLd + cc);
          const float4 a1 =
              *reinterpret_cast<const float4*>(ws + r * kSm90StgLd + cc + 4);
          float v[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const size_t o = (size_t)m * N + n0 + cc;
          if (bias) {
            const uint4 b = *reinterpret_cast<const uint4*>(bias + n0 + cc);
            const __nv_bfloat162* b2 =
                reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(b2[e]);
              v[2 * e] += f.x;
              v[2 * e + 1] += f.y;
            }
          }
          if (res) {
            const uint4 q = *reinterpret_cast<const uint4*>(res + o);
            const __nv_bfloat162* q2 =
                reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(q2[e]);
              v[2 * e] += f.x;
              v[2 * e + 1] += f.y;
            }
          }
          uint4 packed;
          uint32_t* pw = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pw[e] = pack_bf16(apply_act<bf16>(v[2 * e], act),
                              apply_act<bf16>(v[2 * e + 1], act));
          *reinterpret_cast<uint4*>(out + o) = packed;
        }
      }
  }
}

// cuTensorMapEncodeTiled, a driver-API function, fetched once through the
// runtime (no -lcuda)
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// the map of a row-major bf16 [rows, K] operand in boxes of [box_rows, 64]
inline bool make_map(CUtensorMap* map, const void* p, int rows, int K,
                     int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kSm90BK, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int gemm_nt_sm90_launch(const __nv_bfloat16* A, const __nv_bfloat16* W,
                               const __nv_bfloat16* bias,
                               const __nv_bfloat16* res, __nv_bfloat16* out,
                               int M, int N, int K, int act, cudaStream_t st) {
  CUtensorMap ma, mw;
  if (!make_map(&ma, A, M, K, kSm90BM) || !make_map(&mw, W, N, K, kSm90BN))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_nt_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSm90SmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const int tiles = (M + kSm90BM - 1) / kSm90BM * (N / kSm90BN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  gemm_nt_sm90<<<grid, kSm90Threads, kSm90SmemBytes, st>>>(
      ma, mw, bias, res, out, M, N, K, act);
  const int err = (int)cudaGetLastError();
  if (!err) ++gemm_launch_counts[kGemmSm90];
  return err;
}

// The bf16 products of B1 and B13: act(A W^T + bias + res) with res [M, N]
// or null, out bf16. The wgmma + TMA kernel takes the shapes sm90_takes
// accepts (N % 128 == 0, K % 64 == 0) with 16-byte aligned operands; every
// other shape runs gemm.cuh's mma.sync kernel (which needs K % 32 == 0 and
// N % 8 == 0). Mirrored by ops/kernels/gemm.py gemm_kernel.
inline int gemm_bf16(const __nv_bfloat16* A, const __nv_bfloat16* W,
                     const __nv_bfloat16* bias, const __nv_bfloat16* res,
                     __nv_bfloat16* out, int M, int N, int K, int act,
                     cudaStream_t st) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(W) |
        reinterpret_cast<uintptr_t>(bias) | reinterpret_cast<uintptr_t>(res) |
        reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (aligned && sm90_takes(M, N, K))
    return gemm_nt_sm90_launch(A, W, bias, res, out, M, N, K, act, st);
  return gemm_nt<__nv_bfloat16>(A, W, bias, res, M, out, M, N, K, act, st);
}

// B1's and B13's products at either dtype: f32 on gemm.cuh's FMA kernel
// (true f32), bf16 through gemm_bf16
inline int gemm_linear(const float* A, const float* W, const float* bias,
                       const float* res, float* out, int M, int N, int K,
                       int act, cudaStream_t st) {
  return gemm_nt(A, W, bias, res, M, out, M, N, K, act, st);
}
inline int gemm_linear(const __nv_bfloat16* A, const __nv_bfloat16* W,
                       const __nv_bfloat16* bias, const __nv_bfloat16* res,
                       __nv_bfloat16* out, int M, int N, int K, int act,
                       cudaStream_t st) {
  return gemm_bf16(A, W, bias, res, out, M, N, K, act, st);
}

}  // namespace
}  // namespace ullsam
