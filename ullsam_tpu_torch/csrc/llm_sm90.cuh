// The wgmma + TMA pieces of the LLM flash attention's bf16 bodies for
// Hopper (sm_90a), shared by B10's forward (llm_flash_attn.cu) and B11's
// backward (llm_flash_bwd.cu).
//
// q, k, v, do (and o) keep their natural layout [B, S, heads * D]; each is
// read through a 3-D TMA map (columns, S, B), so a 64-row tile that runs
// past S is zero-filled inside its own batch row, never read from the next.
// A 64-row tile of one head is two "half" boxes of D / 2 columns, each row
// D bytes: at D = 128 two boxes in the 128-byte swizzle, at D = 64 two in
// the 64-byte swizzle. A K-major product steps 16 columns (32 bytes) along
// a half's row, an MN-major one (trans) 16 rows (16 D bytes) down it.
#pragma once

#include "flash_sm90.cuh"

namespace ullsam {
namespace {

constexpr int kLlmTile = 64;  // rows of every tile and TMA box
constexpr float kLlmLog2e = 1.4426950408889634f;

// bytes of the pieces of one 64-row tile of head dim D
template <int D>
struct LlmTiles {
  static_assert(D == 64 || D == 128, "head dims 64 and 128");
  static constexpr int kHalf = D / 2;               // columns of a half box
  static constexpr int kRowBytes = D;               // bytes of a half's row
  static constexpr int kHalfBytes = kLlmTile * D;   // one half box
  static constexpr int kTile = 2 * kHalfBytes;      // the two halves
};

// wgmma descriptor of a tile whose rows are W bytes in the W-byte swizzle
// (W = 128, 64 or 32): 8-row groups 8 W bytes apart (SBO). K-major, or
// MN-major with one swizzle atom along M / N.
template <int W>
__device__ __forceinline__ uint64_t swz_desc(const void* p) {
  static_assert(W == 128 || W == 64 || W == 32, "swizzle width");
  constexpr uint64_t kLayout = W == 128 ? 1 : W == 64 ? 2 : 3;
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(8 * W / 16) << 32) | (kLayout << 62);
}

// TMA: the box at (c0 columns, c1 rows, c2 batch) of map into dst;
// completes its bytes on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Bulk reduction (the TMA unit): dst[0, bytes / 4) += src[...] in f32, from
// shared memory to global memory, both 16-byte aligned; tracked by bulk
// groups of the issuing thread
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst,
                                                    const void* src,
                                                    int bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], "
      "%2;\n" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the thread's bulk groups but the newest N have read their sources
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// the thread's bulk groups but the newest N are complete
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// d[64 x 32] (+)= A[64 x 16] . B[16 x 32], both from shared memory; TA / TB
// 1 reads A / B MN-major (transposed), 0 K-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32_ss(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d[64 x 64] (+)= A . B as wgmma_n32_ss
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64_ss(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d[64 x N] (+)= A . B from shared memory, N = 32 or 64
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (N == 32)
    wgmma_n32_ss<TA, TB>(d, da, db, accumulate);
  else
    wgmma_n64_ss<TA, TB>(d, da, db, accumulate);
}

// d[64 x 32] += A[64 x 16] . B[16 x 32]: A from registers (an accumulator
// layout rounded to bf16 pairs), B MN-major from shared memory
__device__ __forceinline__ void wgmma_m64n32k16_rs_t(float* d,
                                                     const uint32_t* a,
                                                     uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs_t(float* d, const uint32_t* a,
                                           uint64_t db) {
  if constexpr (N == 32)
    wgmma_m64n32k16_rs_t(d, a, db);
  else
    wgmma_m64n64k16_rs_t(d, a, db);
}

// the map of bf16 [B, S, cols] (natural layout) in boxes of 64 rows by
// box_cols columns of one batch row, in the swizzle of box_cols * 2 bytes
inline bool make_llm_map(CUtensorMap* map, const void* p, int B, int S,
                         long long cols, int box_cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)cols * 2 * (cuuint64_t)S};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)kLlmTile, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = box_cols * 2 == 128
                                         ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_64B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
}  // namespace ullsam
