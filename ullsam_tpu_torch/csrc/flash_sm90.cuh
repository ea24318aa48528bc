// The wgmma + TMA pieces of the global flash attention's bf16 bodies for
// Hopper (sm_90a), shared by B2 / B14's forward (vit_flash_attn.cu) and
// B9's backward (vit_flash_bwd.cu): tiles of 64 rows of a [rows, D] bf16
// matrix, their TMA maps, and the m64n64k16 / m64n16k16 products on them.
//
// A row of D = 64 columns is 128 bytes: one box in the 128-byte swizzle
// ("a"). At D = 80 a row of 160 bytes exceeds the swizzle's span, so the
// last 16 columns go in a second box in the 32-byte swizzle ("b"): a
// K-major product takes four 16-deep steps from "a" and one from "b", an
// MN-major one (trans-b) an n = 64 product on "a" and an n = 16 one on "b".
#pragma once

#include "sm90.cuh"

namespace ullsam {
namespace {

constexpr int kFlashBox = 64;  // rows of every tile and TMA box

// bytes of one 64-row tile: "a" (columns 0-63) and, at D = 80, "b"
template <int D>
struct FlashTiles {
  static_assert(D == 64 || D == 80, "head dims 64 and 80");
  static constexpr int kTail = D - 64;
  static constexpr int kTileA = kFlashBox * 128;
  static constexpr int kTileB = kFlashBox * kTail * 2;
};

// Pins every value of an accumulator array at this point of the program
// (CUTLASS's warpgroup_fence_operand): placed right before wgmma.fence and
// right after wgmma.wait_group, it keeps the compiler from moving a
// register's definition or use into a warpgroup product's pipeline stage,
// which ptxas answers by serializing the products (advisory C7515).
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2^x on the special-function unit, subnormal results flushed to zero (a
// probability below 2^-126 adds nothing to an f32 sum of ones)
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, both K-major from shared memory
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t da,
                                                   uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T: A from registers (as
// load_a_frags gives it), B K-major from shared memory
__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t* a,
                                                   uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// The wgmma register A operand of warp t128 / 32's 16 rows of a 64-row tile
// (rows g and g + 8, columns 2 t, + 1 and 8 + 2 t, + 1 of each 16-deep
// step, as ldmatrix gives them): steps 0-3 from the 128-byte-swizzled box
// "a" (16-byte chunk c of row r at c ^ (r & 7)), at D = 80 step 4 from the
// 32-byte-swizzled box "b" (chunk c of row r at c ^ ((r >> 2) & 1)).
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4],
                                             const unsigned char* ta,
                                             const unsigned char* tb,
                                             int t128) {
  const int lane = t128 & 31, hi = lane >> 4;
  const int row = (t128 >> 5) * 16 + (lane & 15);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldmatrix_x4(f[ks],
                smem_u32(ta + row * 128 + (((2 * ks + hi) ^ (row & 7)) << 4)));
  if constexpr (D > 64)
    ldmatrix_x4(f[4],
                smem_u32(tb + row * 32 + ((hi ^ ((row >> 2) & 1)) << 4)));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64]: A from registers (an m64nXk16
// accumulator layout rounded to bf16 pairs), B from shared memory MN-major
// (N contiguous, read with trans-b)
__device__ __forceinline__ void wgmma_m64n64k16_rs_t(float* d,
                                                     const uint32_t* a,
                                                     uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 16] += A[64 x 16] . B[16 x 16], as wgmma_m64n64k16_rs_t
__device__ __forceinline__ void wgmma_m64n16k16_rs_t(float* d,
                                                     const uint32_t* a,
                                                     uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the map of bf16 [rows, cols] (row stride ld elements) in boxes of 64 rows
// by box_cols, with the swizzle the wgmma descriptors expect
inline bool make_flash_map(CUtensorMap* map, const void* p, long long rows,
                           long long cols, long long ld, int box_cols,
                           CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)kFlashBox};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
}  // namespace ullsam
