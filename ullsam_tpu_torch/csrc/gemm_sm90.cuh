// A Hopper GEMM for the products of B1 (qkv, proj) and B13 (fc1, fc2) in
// bf16 and in float32, and (with an int8 W) for B12's prefill:
//
//     out[m, n] = epilogue(A[m, :] . W[n, :])
//
// A [M, K] and W [N, K] row-major (both K-major: wgmma's native NT case, no
// transpose), bf16 (W int8 for B12) or float32, the sums in f32, out
// rounded once. The epilogue is
// a functor applied to 8 columns of a row at a time: B1 / B13's
// (Sm90Bf16Epilogue: gemm.cuh's apply_act, bias, the tanh-GELU of the sum
// first rounded to bf16, the residual added in f32) or B12's
// (w8a16_matmul.cu: the per-channel scale, the f32 bias, f32 or bf16 out).
//
// What bounds it: operations. B13's products at ViT-H (T = 4900, C = 1280,
// F = 5120) are 64 GFLOP each against 26-63 MB; gemm.cuh's mma.sync kernel
// reached 198-217 TFLOP/s on them, cuBLAS 519-522 (H100 80GB HBM3, 700 W).
// B12's prefill linears (M = 1152: 9.7-38.7 GFLOP against 4-17 MB of int8
// weights) likewise. In float32 the same products are f32-accurate at 495 /
// 3 TFLOP/s in split TF32 (tf32.cuh), where gemm.cuh's FMA kernel is held
// to the CUDA cores' 67.
//
// Design (the usual Hopper shape):
//   * 128 x 128 output tiles, k-blocks of 64 (128 bytes of bf16: one row of
//     the 128-byte swizzle), a ring of kSm90Stages shared-memory stages.
//   * One producer warp: a single thread issues the TMA loads of A's and
//     W's tiles (cuTensorMapEncodeTiled maps, 128-byte swizzle; rows past
//     M come back as zeros) and arms each stage's `full` mbarrier with the
//     byte count; it waits on the stage's `empty` mbarrier before reuse.
//   * Two consumer warpgroups taking the block's tiles in turn
//     (ping-pong): each multiplies a whole tile, two wgmma.mma_async
//     m64n128k16 a 16-deep step from shared-memory descriptors (K-major,
//     128-byte swizzle, 1024-byte row groups), f32 accumulators in
//     registers (128 a thread), one group in flight; a stage is released
//     once the wgmma group that read it has completed. Its epilogue
//     overlaps the other warpgroup's products: each warp stages 8 rows at
//     a time in f32 in shared memory and hands the epilogue 8 columns of a
//     row a lane (16-byte loads and stores, rows >= M masked).
//   * Persistent: grid = min(tiles, SMs), each block walks tiles t, t +
//     grid, ...; the producer runs ahead into the next tile. Splitting each
//     tile's rows between the two warpgroups instead leaves the tensor
//     cores idle through every epilogue, and storing 4 bytes a lane from
//     the accumulator layout makes the epilogue longer than a tile's
//     products (H100: 280-546 and 315-594 TFLOP/s against 390-650).
//   * int8 W (B12): a stage holds W's tile as TMA lands it, 128 rows of 64
//     int8 (8 KB, half of bf16's bytes) in the 64-byte swizzle. The product
//     is swapped, out^T = W . x^T: each consumer warp reads its W rows' int8
//     pairs (2 bytes a lane, conflict-free) and converts them exactly
//     (|q| <= 127) into bf16 pairs in registers, wgmma's A operand, with x's
//     tile the shared-memory B operand (m64n144k16: 144 rows of x a tile,
//     Sm90Layout). The two consumer warpgroups work on the same tile (64 W
//     rows each) instead of taking turns: ptxas serializes a warpgroup's
//     register-A wgmma with the instructions that write its operands
//     (advisory C7513), so one warpgroup's conversion overlaps the other's
//     products. The epilogue stages the transposed accumulators as rows of
//     8 and hands out rows of out. Measured on the way (H100 80GB HBM3, 700
//     W, tools/ab_vit_kernels.py, M = 9216): converting into a swizzled
//     bf16 tile in shared memory, read from there as wgmma's B, moved 96 KB
//     of shared memory a k-block against the bf16 W's 72 and ran at
//     360-385 TFLOP/s where the bf16 GEMM ran 640-670; register-A operands
//     with the warpgroups taking turns, 288-335; sharing a tile, 458-549;
//     with 144-row tiles, 485-566. Where its tiles leave SMs idle (the
//     serving engine's 128- and 256-row segments) it splits K
//     (Sm90Split): each unit's f32 partial goes to a workspace and the
//     tile's last unit adds them in a fixed order before the epilogue.
//   * int8 W with f32 x (kSm90Int8X3, B12 at f32 x): x comes as its three
//     bf16 planes (w8a16_matmul.cu's pre-pass: x = b0 + b1 + b2 exactly),
//     one [M, 3K] map whose three boxes land in each stage (three stages,
//     54 KB of x a stage at 144 rows). Each W fragment, converted once,
//     feeds three register-A wgmmas, one a plane, into a partial of the
//     16-deep step from zero that the CUDA cores add to the f32 sum (the
//     tensor cores' accumulation, truncating, would drift: the bf16 kind's
//     one accumulator errs 8.6e-6 of max|out| at K = 8192): every
//     product is exact (an int8 times a bf16), so the result differs from
//     an f32 product only in the order and rounding of the sums, at three
//     bf16 products for each (989 / 3 TFLOP/s, where split TF32 would
//     need three TF32 ones, 495 / 3). The epilogue stages 72 of the
//     tile's 144 x rows at a time; the split rule and Sm90Split are the
//     int8 kind's.
//   * float32 (Sm90Layout<kSm90F32>, split TF32): a k-block is 32 floats
//     (128 bytes, one row of the swizzle); each stage holds A's tile and W's
//     as TMA lands them (three stages), and W's lo plane. The producer is a
//     warpgroup that gives its registers to the consumers (setmaxnreg 40 /
//     232: at 168, ptxas's cap for the block, the consumers spilled). TF32 wgmma reads
//     shared memory K-major only, as both operands are here. The two
//     consumer warpgroups take each tile together (64 rows each, as int8
//     does). Each k-block all 256 consumer threads split the next stage's
//     W tile in place, hi = tf32(x) and lo = tf32(x - hi) beside it, while
//     the current stage's products run (no scratch, no pre-pass); A is
//     split in registers as a warp reads its rows (wgmma's register A
//     operand, m64n128k8), the next k-block's while this one's products
//     run. Each 8-deep step is three products, A_hi W_lo and A_lo W_hi
//     first, then A_hi W_hi, into a partial sum from zero that holds one
//     k-block (12 products); the CUDA cores add it to the f32 sum (round
//     to nearest). The tensor cores' own accumulation can lose about half
//     an ulp a product, one way: over fc2's K = 5120 (640 steps) one
//     accumulator would drift where 160 short partials do not (partials of
//     four k-blocks doubled the error against float64, at the same speed). Sum and
//     partial take 128 registers, so a warpgroup has 64 rows of the 128 x
//     128 tile; its epilogue adds bias and residual in f32 and takes the
//     tanh-GELU of the unrounded sum (gemm.cuh's apply_act<float>).
// Shapes it takes (sm90_takes, mirrored by ops/kernels/gemm.py): N % 128 ==
// 0, K % 64 == 0, any M >= 1, 16-byte aligned operands; the kSm90Int8X3
// kind also a ragged N >= 128 (w8_x3_takes, w8a16_matmul.cu), which its
// epilogue masks. Other bf16 shapes
// run gemm.cuh's mma.sync kernel (gemm_bf16 makes that choice), other f32
// shapes gemm.cuh's FMA kernel (gemm_f32).
#pragma once

#include "gemm.cuh"
#include "sm90.cuh"
#include "tf32.cuh"

namespace ullsam {
namespace {

constexpr int kSm90BM = 128, kSm90BN = 128, kSm90BK = 64, kSm90Stages = 5;
constexpr int kSm90Threads = 288;  // two consumer warpgroups + one warp
// a consumer warp's epilogue staging: 8 rows of the tile in f32, rows
// padded to 136 floats (its float2 writes and 16-byte reads conflict-free)
constexpr int kSm90StgLd = kSm90BN + 8;
constexpr int kSm90StgBytes = 8 * 8 * kSm90StgLd * 4;  // the 8 warps
// float32: a k-block of 32 floats (128 bytes), three stages
constexpr int kSm90F32BK = 32, kSm90F32Stages = 3;

// the kinds of the kernel: bf16 A and W, bf16 A and int8 W (B12), f32,
// and int8 W with f32 A given as its three bf16 planes (B12 at f32 x)
enum Sm90Kind : int {
  kSm90Bf16 = 0, kSm90Int8 = 1, kSm90F32 = 2, kSm90Int8X3 = 3
};

// Shared memory of the kernel of each kind: the stages (A then W, 1024
// bytes to align them; f32 also W's lo plane), the consumer warps'
// epilogue staging, the mbarriers (full and empty a stage, and the two
// warpgroups' turns). With int8 a tile has kBM = 144 rows of A (x): 1152 =
// 8 x 144 rows make 128 tiles of every short-N linear at the caption
// prompt (a wave of 132 SMs, where 128-row tiles make 144, 1.09 waves),
// and 9216 = 64 x 144; its staging holds a transposed block of the swapped
// product (144 rows of 8 + 4 floats a warp). A k-block is 128 bytes of a
// row in every kind (64 bf16, 32 f32). With f32 x (kX3) a stage holds x's
// three bf16 planes (54 KB at 144 rows), so three stages fit, and the
// staging takes 72 of the tile's 144 x rows at a time. Must match
// ops/kernels/gemm.py sm90_smem_bytes and ops/kernels/int8_matmul.py
// sm90_smem_bytes.
template <int kKind>
struct Sm90Layout {
  static constexpr bool kX3 = kKind == kSm90Int8X3;
  static constexpr bool kInt8W = kKind == kSm90Int8 || kX3;
  static constexpr bool kF32 = kKind == kSm90F32;
  static constexpr int kBM = kInt8W ? 144 : kSm90BM;  // rows of A a tile
  static constexpr int kBK = kF32 ? kSm90F32BK : kSm90BK;  // K a k-block
  static constexpr int kPlanes = kX3 ? 3 : 1;  // A's planes a stage
  static constexpr int kStages = kX3 ? 3 : kInt8W ? 6 : kF32 ? kSm90F32Stages
                                                           : kSm90Stages;
  static constexpr int kPlaneBytes = kBM * kSm90BK * 2;
  static constexpr int kABytes = kPlanes * kPlaneBytes;
  static constexpr int kWBytes = kSm90BN * kSm90BK * (kInt8W ? 1 : 2);
  static constexpr int kTxBytes = kABytes + kWBytes;  // what TMA brings
  static constexpr int kStageBytes = kTxBytes + (kF32 ? kWBytes : 0);
  static constexpr int kStgLd = kInt8W ? 12 : kSm90StgLd;  // floats a row
  static constexpr int kStgRows = kX3 ? kBM / 2 : kBM;  // x rows staged
  static constexpr int kStgBytes =
      kInt8W ? 8 * kStgRows * kStgLd * 4 : kSm90StgBytes;
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes +
                                    kStgBytes + (2 * kStages + 2) * 8;
  // f32 and kX3: a producer warpgroup, whose registers go to the
  // consumers (setmaxnreg: sum, partial and A's fragments need about 200;
  // at 168, ptxas's cap for the block, they spill)
  static constexpr bool kRegs = kF32 || kX3;
  static constexpr int kThreads = kRegs ? 384 : kSm90Threads;
  static_assert(kStageBytes % 1024 == 0, "stages stay 1024-byte aligned");
  static_assert(kSmemBytes <= 232448, "one block");
};
constexpr int kSm90SmemBytes = Sm90Layout<kSm90Bf16>::kSmemBytes;

inline bool sm90_takes(int M, int N, int K) {
  return M >= 1 && N >= kSm90BN && N % kSm90BN == 0 && K >= kSm90BK &&
         K % kSm90BK == 0;
}

// Split-K of the int8 kind (B12's prefill at the serving engine's 128- and
// 256-row segments, where its tiles leave most SMs idle): unit u of tiles x
// splits is tile u / splits over k-blocks [u % splits, + 1) x kt / splits.
// A unit writes its f32 partial (its 256 consumer threads' 72 accumulators,
// kSm90PartFloats) to ws; the last unit of a tile (counters[tile], which it
// resets to 0 for the next launch) adds the partials in split order and
// applies the epilogue once. The other kinds run splits = 1.
struct Sm90Split {
  int splits;
  float* ws;
  int* counters;
};
constexpr int kSm90MinSplitKb = 4;  // k-blocks a unit keeps at least
constexpr int kSm90PartFloats = 256 * 144 / 2;  // a unit's partial

// splits of the int8 kind: doubled while the units still fit in one wave
// of the card's SMs and each keeps kSm90MinSplitKb k-blocks. 1 wherever the
// tiles fill the card (M = 1152: 128-512 tiles). Mirrored by
// ops/kernels/int8_matmul.py sm90_splits.
inline int sm90_int8_splits(int M, int N, int K, int sms) {
  const int tiles = (M + 143) / 144 * ((N + kSm90BN - 1) / kSm90BN),
            kt = K / kSm90BK;
  int s = 1;
  while (tiles * s * 2 <= sms && kt % (2 * s) == 0 &&
         kt / (2 * s) >= kSm90MinSplitKb)
    s *= 2;
  return s;
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

// d[64 x 256] (+)= A[64 x 16] . B[256 x 16]^T, both from shared memory (the
// decoder's image-side products, csrc/decoder_sm90.cuh: 128 accumulators a
// thread)
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// An exact small integer as f32 has its low 16 bits zero, so its bf16 is
// its top half: two of them packed by one byte-permute (no F2F conversion)
__device__ __forceinline__ uint32_t pack_bf16_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Two int8 (the low 16 bits of w) -> their bf16 pair, exact: each byte,
// biased by 128, goes into the mantissa of 2^23, less 2^23 + 128
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t w) {
  const uint32_t u = w ^ 0x8080u;
  return pack_bf16_exact(
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f,
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f);
}

// wgmma's register A fragment of W rows r (and r + 8) at the 16-deep step
// k, from an int8 tile [128 rows][64 bytes] in the 64-byte swizzle (TMA's:
// 16-byte chunk c of row r at c ^ ((r >> 1) & 3)); a[0] / a[1] rows r / r +
// 8 at k-columns 2tq, 2tq + 1, a[2] / a[3] the same at 8 + 2tq. A warp's
// 2-byte loads cover 8 distinct 16-byte chunks of a 128-byte line
__device__ __forceinline__ void w8_frag(const unsigned char* w, int r, int k,
                                        int tq, uint32_t* a) {
  const unsigned char* ra = w + r * 64 + ((k ^ ((r >> 1) & 3)) << 4) + 2 * tq;
  const unsigned char* rb =
      w + (r + 8) * 64 + ((k ^ (((r + 8) >> 1) & 3)) << 4) + 2 * tq;
  a[0] = i8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(ra));
  a[1] = i8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(rb));
  a[2] = i8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(ra + 8));
  a[3] = i8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(rb + 8));
}

// d[64 x 144] (+)= A[64 x 16] . B[144 x 16]^T, A from registers (bf16
// pairs in the mma.m16n8k16 A layout, a warp 16 rows), B K-major from
// shared memory
__device__ __forceinline__ void wgmma_m64n144k16_rs(float* d,
                                                    const uint32_t* a,
                                                    uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71}, {%72, %73, %74, %75}, %76, p, 1, "
      "1, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 8] . B[128 x 8]^T in TF32: A from registers (tf32
// values in the m64k8 fragment layout: a warp 16 rows, a0 / a1 rows g / g +
// 8 at k = tq, a2 / a3 the same at k = tq + 4), B K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_m64n128k8_rs(float* d,
                                                        const uint32_t* a,
                                                        uint64_t db,
                                                        int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// B1's and B13's epilogue: bias, residual and activation in f32 on the
// sum, out bf16 (gemm.cuh's apply_act)
struct Sm90Bf16Epilogue {
  const __nv_bfloat16* bias;
  const __nv_bfloat16* res;
  __nv_bfloat16* out;
  int N, act;
  // v: columns n .. n + 7 of row m
  __device__ __forceinline__ void operator()(int m, int n, float* v) const {
    const size_t o = (size_t)m * N + n;
    if (bias) {
      const uint4 b = *reinterpret_cast<const uint4*>(bias + n);
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(b2[e]);
        v[2 * e] += f.x;
        v[2 * e + 1] += f.y;
      }
    }
    if (res) {
      const uint4 q = *reinterpret_cast<const uint4*>(res + o);
      const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(&q);
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
      pw[e] = pack_bf16(apply_act<__nv_bfloat16>(v[2 * e], act),
                        apply_act<__nv_bfloat16>(v[2 * e + 1], act));
    *reinterpret_cast<uint4*>(out + o) = packed;
  }
};

// B1's and B13's float32 epilogue: bias and residual added in f32 to the
// sum, the activation of the unrounded result (gemm.cuh's apply_act), out
// f32
struct Sm90F32Epilogue {
  const float* bias;
  const float* res;
  float* out;
  int N, act;
  // v: columns n .. n + 7 of row m
  __device__ __forceinline__ void operator()(int m, int n, float* v) const {
    const size_t o = (size_t)m * N + n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 x = make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2],
                             v[4 * h + 3]);
      if (bias) {
        const float4 b = *reinterpret_cast<const float4*>(bias + n + 4 * h);
        x = make_float4(x.x + b.x, x.y + b.y, x.z + b.z, x.w + b.w);
      }
      if (res) {
        const float4 r = *reinterpret_cast<const float4*>(res + o + 4 * h);
        x = make_float4(x.x + r.x, x.y + r.y, x.z + r.z, x.w + r.w);
      }
      *reinterpret_cast<float4*>(out + o + 4 * h) =
          make_float4(apply_act<float>(x.x, act), apply_act<float>(x.y, act),
                      apply_act<float>(x.z, act), apply_act<float>(x.w, act));
    }
  }
};

// The staged epilogue of a warp's 16 rows of an m64n128 accumulator (d[4i
// + c]: row rr0 + g (+8 for c >= 2), column 8i + 2tq + (c & 1)) of the tile
// at (m0, n0), 8 rows at a time through the warp's f32 staging ws: the
// accumulators go in by their layout, then each lane takes 8 columns of a
// row (a warp two whole 128-column rows) and hands them to the epilogue
// functor (rows >= M masked)
template <class Epi>
__device__ __forceinline__ void sm90_stage_out(float* ws, const float* d,
                                               int m0, int rr0, int n0, int M,
                                               int lane, const Epi& epi) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kSm90BN / 8; ++i)
      *reinterpret_cast<float2*>(ws + g * kSm90StgLd + 8 * i + 2 * tq) =
          make_float2(d[4 * i + 2 * hf], d[4 * i + 2 * hf + 1]);
    __syncwarp();
    const int rr = rr0 + hf * 8;  // row in the tile
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = lane + 32 * k, r = c >> 4, cc = (c & 15) * 8;
      if (m0 + rr + r >= M) continue;
      const float4 a0 =
          *reinterpret_cast<const float4*>(ws + r * kSm90StgLd + cc);
      const float4 a1 =
          *reinterpret_cast<const float4*>(ws + r * kSm90StgLd + cc + 4);
      float v[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      epi(m0 + rr + r, n0 + cc, v);
    }
  }
}

// With kInt8W the product is swapped: out^T = W . x^T, W's rows the wgmma
// M (a consumer warpgroup's 64, converted from int8 into the register A
// operand), x's tile of 144 rows the shared-memory B operand (n = 144), so
// the accumulators hold out transposed and the epilogue transposes them
// back through its staging.
template <int kKind, class Epi, bool kSplitK = false>
__global__ void __launch_bounds__(Sm90Layout<kKind>::kThreads, 1)
    gemm_nt_sm90(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_w, const Epi epi,
                 const Sm90Split split, int M, int N, int K) {
  using bf16 = __nv_bfloat16;
  using L = Sm90Layout<kKind>;
  constexpr bool kInt8W = L::kInt8W;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smraw[];
  unsigned char* base = smraw + ((1024 - (smem_u32(smraw) & 1023)) & 1023);
  // stage s: A (x) [kBM][64] bf16 swizzled, then W [128][64] (bf16 in the
  // 128-byte swizzle, or int8 in the 64-byte swizzle); f32: A [128][32]
  // and W [128][32] in the 128-byte swizzle, then W's lo plane
  const auto stage_a = [&](int s) {
    return reinterpret_cast<bf16*>(base + s * L::kStageBytes);
  };
  const auto stage_w = [&](int s) {
    return base + s * L::kStageBytes + L::kABytes;
  };
  float* stg = reinterpret_cast<float*>(base + kStages * L::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      base + kStages * L::kStageBytes + L::kStgBytes);
  uint64_t* empty = full + kStages;
  uint64_t* turn = empty + kStages;  // turn[w]: warpgroup w may multiply

  const int tid = threadIdx.x, wg = tid / 128;
  // (kX3 takes a ragged N, the vocab head: its last tile's W rows past N
  // come back from TMA as zeros and its epilogue masks the columns)
  const int tiles_n = (N + kSm90BN - 1) / kSm90BN;
  const int tiles = (M + L::kBM - 1) / L::kBM * tiles_n;
  const int kt = K / L::kBK;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      // released by the warpgroup that read it (int8, f32: by both)
      mbar_init(&empty[s], kInt8W || L::kF32 ? 2 : 1);
    }
    mbar_init(&turn[0], 1);
    mbar_init(&turn[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the block's tiles j = 0, 1, ... are tiles blockIdx.x + j * gridDim.x;
  // k-block kb of tile j sits in stage (j * kt + kb) % kStages. int8 walks
  // units of tiles x splits the same way (Sm90Split), kts k-blocks each
  const int splits = kSplitK ? split.splits : 1, kts = kt / splits;
  if (wg == 2) {  // the producer warp (f32: warpgroup)
    if constexpr (L::kRegs) producer_registers();
    if (tid == 256) {
      int s = 0, ph = 0;
      for (int u = blockIdx.x; u < tiles * splits; u += gridDim.x) {
        const int t = u / splits, kb0 = (u - t * splits) * kts;
        const int m0 = t / tiles_n * L::kBM, n0 = t % tiles_n * kSm90BN;
        for (int kb = kb0; kb < kb0 + kts; ++kb) {
          mbar_wait(&empty[s], ph ^ 1);
          mbar_expect_tx(&full[s], L::kTxBytes);
          // kX3: plane p of x's k-block kb is columns p K + kb kBK of the
          // planes' [M, 3K] map
#pragma unroll
          for (int p = 0; p < L::kPlanes; ++p)
            tma_load_2d(stage_a(s) + p * (L::kPlaneBytes / 2), &map_a,
                        &full[s], p * K + kb * L::kBK, m0);
          tma_load_2d(stage_w(s), &map_w, &full[s], kb * L::kBK, n0);
          if (++s == kStages) s = 0, ph ^= 1;
        }
      }
    }
    return;
  }

  const int lane = tid & 31, wrow = (tid & 127) >> 5;
  const int g = lane >> 2, tq = lane & 3;
  if constexpr (L::kF32) {
    // Cooperative, as int8: both consumer warpgroups take every tile of the
    // block, warpgroup wg its rows 64 wg .. 64 wg + 63 (d[4i + c]: row 64
    // wg + 16 wrow + g (+8 for c >= 2), column 8i + 2tq + (c & 1)). Stage
    // s's W tile is split by all 256 consumer threads (16-byte chunks tid,
    // tid + 256, ...: hi in place, lo kWBytes on) after its full barrier
    // and before a named barrier; the next stage's split runs while this
    // one's products do. Both warpgroups release every stage.
    const auto split_w = [&](int s) {
      float4* w = reinterpret_cast<float4*>(stage_w(s));
      float4* wl = reinterpret_cast<float4*>(stage_w(s) + L::kWBytes);
#pragma unroll
      for (int c = tid; c < L::kWBytes / 16; c += 256) {
        const float4 x = w[c];
        uint32_t h[4], l[4];
        tf32_split(x.x, h[0], l[0]);
        tf32_split(x.y, h[1], l[1]);
        tf32_split(x.z, h[2], l[2]);
        tf32_split(x.w, h[3], l[3]);
        w[c] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                           __uint_as_float(h[2]), __uint_as_float(h[3]));
        wl[c] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                            __uint_as_float(l[2]), __uint_as_float(l[3]));
      }
      fence_proxy_async();  // the planes, written here, read by wgmma
    };
    consumer_registers();
    const int r = wg * 64 + wrow * 16 + g;  // this thread's A rows r, r + 8
    // this warp's A fragments of stage s's four 8-deep steps, split in
    // registers: a[u] is row r + 8 (u & 1), column 8 ks + tq + 4 (u >> 1),
    // in 16-byte chunk 2 ks + (u >> 1) of its row, swizzled (rows r and r +
    // 8 share r & 7 = g: conflict-free)
    const auto load_a = [&](int s, uint32_t (&ah)[4][4],
                            uint32_t (&al)[4][4]) {
      const unsigned char* a =
          reinterpret_cast<const unsigned char*>(stage_a(s));
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int row = r + 8 * (u & 1), ch = 2 * ks + (u >> 1);
          const float x = *reinterpret_cast<const float*>(
              a + row * 128 + ((ch ^ (row & 7)) << 4) + tq * 4);
          tf32_split(x, ah[ks][u], al[ks][u]);
        }
    };
    uint32_t ah0[4][4], al0[4][4], ah1[4][4], al1[4][4];
    if ((int)blockIdx.x < tiles) {
      mbar_wait(&full[0], 0);
      split_w(0);
      load_a(0, ah0, al0);
    }
    named_bar_sync(1, 256);
    int kg = 0;  // k-blocks consumed: k-block kg sits in stage kg % kStages
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / tiles_n * kSm90BM, n0 = t % tiles_n * kSm90BN;
      float acc[64], part[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      // k-block kb (fragments ah, al, split when its stage landed): its 12
      // products into a partial from zero, then, while they run, the next
      // stage's W split and its A fragments (an, ln) loaded; then the
      // partial is added to the sum
      const auto step = [&](int kb, uint32_t (&ah)[4][4],
                            uint32_t (&al)[4][4], uint32_t (&an)[4][4],
                            uint32_t (&ln)[4][4]) {
        const int s = kg % kStages;
        const unsigned char* w = stage_w(s);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint64_t dh = sw128_desc(w + ks * 32);
          wgmma_tf32_m64n128k8_rs(part, ah[ks],
                                  sw128_desc(w + L::kWBytes + ks * 32),
                                  ks > 0);
          wgmma_tf32_m64n128k8_rs(part, al[ks], dh, 1);
          wgmma_tf32_m64n128k8_rs(part, ah[ks], dh, 1);
        }
        wgmma_commit();
        if (kb + 1 < kt || t + (int)gridDim.x < tiles) {
          const int s1 = (kg + 1) % kStages;
          mbar_wait(&full[s1], ((kg + 1) / kStages) & 1);
          split_w(s1);
          load_a(s1, an, ln);
        }
        wgmma_wait<0>();
        if ((tid & 127) == 0) mbar_arrive(&empty[s]);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
        ++kg;
        named_bar_sync(1, 256);  // the next stage's W is split
      };
      // kt = K / 32 is even (K % 64 == 0): the fragment sets alternate
      for (int kb = 0; kb < kt; kb += 2) {
        step(kb, ah0, al0, ah1, al1);
        step(kb + 1, ah1, al1, ah0, al0);
      }
      float* ws = stg + (tid >> 5) * (L::kStgBytes / 32);
      sm90_stage_out(ws, acc, m0, wg * 64 + wrow * 16, n0, M, lane, epi);
    }
    return;
  }
  if constexpr (kInt8W) {
    // Cooperative: both consumer warpgroups take every tile of the block,
    // warpgroup wg the W rows 64 wg .. 64 wg + 63 of its tile (the wgmma
    // M; d[4i + c] is W row 64 wg + 16 wrow + g (+8 for c >= 2), x row 8i
    // + 2tq + (c & 1) of the tile's kBM = 144). A warpgroup's conversion cannot overlap its own
    // wgmma groups (ptxas serializes register-A operands written between a
    // group's fence and its wait), so it overlaps the other warpgroup's.
    // Both release every stage.
    if constexpr (L::kX3) consumer_registers();
    const int wr0 = wg * 64 + wrow * 16 + g;
    int kg = 0;  // k-blocks consumed: k-block kg sits in stage kg % kStages
    constexpr int kAcc = L::kBM / 2;  // n = kBM: kBM / 8 blocks of 4
    for (int u = blockIdx.x; u < tiles * splits; u += gridDim.x) {
      const int t = u / splits, sp = u - t * splits;
      const int m0 = t / tiles_n * L::kBM, n0 = t % tiles_n * kSm90BN;
      float d[kAcc];
#pragma unroll
      for (int i = 0; i < kAcc; ++i) d[i] = 0.f;
      for (int kb = 0; kb < kts; ++kb, ++kg) {
        const int s = kg % kStages, ph = (kg / kStages) & 1;
        mbar_wait(&full[s], ph);
        const unsigned char* w = stage_w(s);
        uint32_t af[4][4];
#pragma unroll
        for (int k = 0; k < kSm90BK / 16; ++k) w8_frag(w, wr0, k, tq, af[k]);
        const bf16* a = stage_a(s);
        if constexpr (L::kX3) {
          // each 16-deep step's three products into a partial from zero,
          // the small planes first (b2, b1, then b0), added to the sum on
          // the CUDA cores (round to nearest): the tensor cores' own
          // accumulation loses up to about half an ulp of what it holds
          // an mma, one way, so the sum never goes through it
#pragma unroll
          for (int k = 0; k < kSm90BK / 16; ++k) {
            float part[kAcc];
            wgmma_fence();
#pragma unroll
            for (int p = L::kPlanes - 1; p >= 0; --p)
              wgmma_m64n144k16_rs(
                  part, af[k],
                  sw128_desc(a + p * (L::kPlaneBytes / 2) + k * 16),
                  p < L::kPlanes - 1);
            wgmma_commit();
            wgmma_wait<0>();
            if (k == kSm90BK / 16 - 1 && (tid & 127) == 0)
              mbar_arrive(&empty[s]);
#pragma unroll
            for (int i = 0; i < kAcc; ++i) d[i] = __fadd_rn(d[i], part[i]);
          }
        } else {
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < kSm90BK / 16; ++k)
            wgmma_m64n144k16_rs(d, af[k], sw128_desc(a + k * 16),
                                kb > 0 || k > 0);
          wgmma_commit();
          wgmma_wait<0>();
          if ((tid & 127) == 0) mbar_arrive(&empty[s]);
        }
      }

      if constexpr (kSplitK) {
        // split-K: this unit's partial to the workspace in the
        // accumulators' own layout (float4 c of consumer thread tid at
        // unit x kAcc x 256 + (c x 256 + tid) x 4: 512 contiguous bytes a
        // warp store); the tile's last unit adds the tile's partials in
        // split order, each thread the same accumulators of every unit,
        // and runs the epilogue once. No float atomics: two calls are
        // bitwise equal.
        __shared__ int last_unit;
        const auto part = [&](int s) {
          return reinterpret_cast<float4*>(split.ws) +
                 (size_t)(t * splits + s) * (kAcc / 4) * 256 + tid;
        };
        {
          float4* p = part(sp);
#pragma unroll
          for (int c = 0; c < kAcc / 4; ++c)
            p[c * 256] = make_float4(d[4 * c], d[4 * c + 1], d[4 * c + 2],
                                     d[4 * c + 3]);
        }
        __threadfence();
        named_bar_sync(1, 256);
        if (tid == 0) {
          last_unit = atomicAdd(&split.counters[t], 1) == splits - 1;
          if (last_unit) split.counters[t] = 0;  // ready for the next launch
        }
        // (every thread reads last_unit before the next unit's first
        // barrier lets it change)
        named_bar_sync(1, 256);
        if (!last_unit) continue;
        __threadfence();
        // half the accumulators at a time: one split's float4s of them
        // loaded before any is added (this unit's own from registers)
        constexpr int kHalf = kAcc / 8;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float4 sum[kHalf];
          for (int s = 0; s < splits; ++s) {
            float4 p[kHalf];
            const float4* q = part(s) + h * kHalf * 256;
#pragma unroll
            for (int c = 0; c < kHalf; ++c) {
              const int i = 4 * (h * kHalf + c);
              p[c] = s == sp ? make_float4(d[i], d[i + 1], d[i + 2], d[i + 3])
                             : __ldcg(q + c * 256);
            }
#pragma unroll
            for (int c = 0; c < kHalf; ++c)
              sum[c] = s == 0 ? p[c]
                              : make_float4(__fadd_rn(sum[c].x, p[c].x),
                                            __fadd_rn(sum[c].y, p[c].y),
                                            __fadd_rn(sum[c].z, p[c].z),
                                            __fadd_rn(sum[c].w, p[c].w));
          }
#pragma unroll
          for (int c = 0; c < kHalf; ++c) {
            const int i = 4 * (h * kHalf + c);
            d[i] = sum[c].x, d[i + 1] = sum[c].y;
            d[i + 2] = sum[c].z, d[i + 3] = sum[c].w;
          }
        }
      }

      // epilogue, transposed through this warp's f32 staging: the
      // product's 8 rows g (+8 hf) are 8 columns of out (W rows n0 + nr
      // ..), its 144 columns rows of out (m0 ..); kStgRows of them at a
      // time staged as [kStgRows][8 + 4] (conflict-free stores and 16-byte
      // loads), then a lane takes rows lane, lane + 32, ... of out, 8
      // columns each
      float* ws = stg + (tid >> 5) * (L::kStgBytes / 32);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int nr = wg * 64 + wrow * 16 + hf * 8;
#pragma unroll
        for (int r0 = 0; r0 < L::kBM; r0 += L::kStgRows) {
          __syncwarp();
#pragma unroll
          for (int i = r0 / 8; i < (r0 + L::kStgRows) / 8; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              ws[(8 * i - r0 + 2 * tq + e) * L::kStgLd + g] =
                  d[4 * i + 2 * hf + e];
          __syncwarp();
#pragma unroll
          for (int k = 0; k < (L::kStgRows + 31) / 32; ++k) {
            const int r = lane + 32 * k;
            if (r >= L::kStgRows || m0 + r0 + r >= M) continue;
            const float4 a0 =
                *reinterpret_cast<const float4*>(ws + r * L::kStgLd);
            const float4 a1 =
                *reinterpret_cast<const float4*>(ws + r * L::kStgLd + 4);
            float v[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            epi(m0 + r0 + r, n0 + nr, v);
          }
        }
      }
    }
    return;
  }

  // bf16 W, ping-pong: consumer warpgroup wg takes the block's tiles wg,
  // wg + 2, ..., each whole (rows 0-63 in d[0], 64-127 in d[1]); while one
  // warpgroup writes a tile's epilogue the other multiplies the next. The
  // products take turns: tile j's start waits until tile j - 1's last
  // stage has arrived (turn[wg]), so a warpgroup never waits on a stage's
  // barrier two phases early (a parity wait cannot tell those apart)
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
      const int s = idx % kStages, ph = (idx / kStages) & 1;
      mbar_wait(&full[s], ph);
      const bf16* a = stage_a(s);
      const bf16* w = reinterpret_cast<const bf16*>(stage_w(s));
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

    // epilogue, through this warp's f32 staging (d[h] is rows 64 h ..)
    float* ws = stg + (tid >> 5) * (L::kStgBytes / 32);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      sm90_stage_out(ws, d[h], m0, h * 64 + wrow * 16, n0, M, lane, epi);
  }
}

// the map of a row-major [rows, K] operand in boxes of [box_rows, 128
// bytes]: bf16 (64 a row) or f32 (32) in the 128-byte swizzle (wgmma reads
// it as it lands), or int8 (64) in the 64-byte swizzle (read 2 bytes a lane
// into wgmma's A fragments)
enum MapType : int { kMapBf16 = 0, kMapInt8 = 1, kMapF32 = 2 };

inline bool make_map(CUtensorMap* map, const void* p, int rows, int K,
                     int box_rows, MapType type = kMapBf16) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const int esize = type == kMapInt8 ? 1 : type == kMapF32 ? 4 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * esize};
  const cuuint32_t box[2] = {(cuuint32_t)(type == kMapF32 ? kSm90F32BK
                                                          : kSm90BK),
                             (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map,
            type == kMapInt8  ? CU_TENSOR_MAP_DATA_TYPE_UINT8
            : type == kMapF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                              : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            2, const_cast<void*>(p), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            type == kMapInt8 ? CU_TENSOR_MAP_SWIZZLE_64B
                             : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One launch of gemm_nt_sm90 of kind kKind over A [M, K] (bf16, or f32;
// kSm90Int8X3: x's bf16 planes [M, 3K]) and W [N, K] (bf16, int8 or f32),
// sm90_takes(M, N, K), 16-byte aligned.
// Returns a cudaError_t code.
template <int kKind, class Epi>
int gemm_sm90_run(const void* A, const void* W, const Epi& epi, int M, int N,
                  int K, cudaStream_t st,
                  const Sm90Split& split = Sm90Split{1, nullptr, nullptr}) {
  using L = Sm90Layout<kKind>;
  const MapType ta = kKind == kSm90F32 ? kMapF32 : kMapBf16;
  const MapType tw = L::kInt8W ? kMapInt8 : ta;
  CUtensorMap ma, mw;
  // kX3: A is x's planes, [M, 3K] bf16 (row m: b0, b1, b2 of x's row m)
  if (!make_map(&ma, A, M, L::kPlanes * K, L::kBM, ta) ||
      !make_map(&mw, W, N, K, kSm90BN, tw))
    return (int)cudaErrorInvalidValue;
  const int units = (M + L::kBM - 1) / L::kBM *
                    ((N + kSm90BN - 1) / kSm90BN) *
                    (L::kInt8W ? split.splits : 1);
  const int grid = units < sm_count() ? units : sm_count();
  if constexpr (L::kInt8W) {
    if (split.splits > 1) {
      static const cudaError_t attr = cudaFuncSetAttribute(
          gemm_nt_sm90<kKind, Epi, true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
      if (attr != cudaSuccess) return (int)attr;
      gemm_nt_sm90<kKind, Epi, true><<<grid, L::kThreads, L::kSmemBytes,
                                       st>>>(ma, mw, epi, split, M, N, K);
      return (int)cudaGetLastError();
    }
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_nt_sm90<kKind, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  gemm_nt_sm90<kKind, Epi><<<grid, L::kThreads, L::kSmemBytes, st>>>(
      ma, mw, epi, split, M, N, K);
  return (int)cudaGetLastError();
}

inline int gemm_nt_sm90_launch(const __nv_bfloat16* A, const __nv_bfloat16* W,
                               const __nv_bfloat16* bias,
                               const __nv_bfloat16* res, __nv_bfloat16* out,
                               int M, int N, int K, int act, cudaStream_t st) {
  const int err = gemm_sm90_run<kSm90Bf16>(
      A, W, Sm90Bf16Epilogue{bias, res, out, N, act}, M, N, K, st);
  if (!err) ++gemm_launch_counts[kGemmSm90];
  return err;
}

inline int gemm_f32_sm90_launch(const float* A, const float* W,
                                const float* bias, const float* res,
                                float* out, int M, int N, int K, int act,
                                cudaStream_t st) {
  const int err = gemm_sm90_run<kSm90F32>(
      A, W, Sm90F32Epilogue{bias, res, out, N, act}, M, N, K, st);
  if (!err) ++gemm_launch_counts[kGemmF32Sm90];
  return err;
}

inline bool aligned16(const void* a, const void* b, const void* c,
                      const void* d, const void* e) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d) |
           reinterpret_cast<uintptr_t>(e)) & 15) == 0;
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
  if (aligned16(A, W, bias, res, out) && sm90_takes(M, N, K))
    return gemm_nt_sm90_launch(A, W, bias, res, out, M, N, K, act, st);
  return gemm_nt<__nv_bfloat16>(A, W, bias, res, M, out, M, N, K, act, st);
}

// The f32 products of B1 and B13: act(A W^T + bias + res), out f32. The
// wgmma + TMA kernel (split TF32) takes the shapes sm90_takes accepts with
// 16-byte aligned operands; every other shape runs gemm.cuh's FMA kernel
// (K % 8 == 0). Mirrored by ops/kernels/gemm.py gemm_kernel.
inline int gemm_f32(const float* A, const float* W, const float* bias,
                    const float* res, float* out, int M, int N, int K,
                    int act, cudaStream_t st) {
  if (aligned16(A, W, bias, res, out) && sm90_takes(M, N, K))
    return gemm_f32_sm90_launch(A, W, bias, res, out, M, N, K, act, st);
  return gemm_nt(A, W, bias, res, M, out, M, N, K, act, st);
}

// B1's and B13's products at either dtype: gemm_f32 or gemm_bf16
inline int gemm_linear(const float* A, const float* W, const float* bias,
                       const float* res, float* out, int M, int N, int K,
                       int act, cudaStream_t st) {
  return gemm_f32(A, W, bias, res, out, M, N, K, act, st);
}
inline int gemm_linear(const __nv_bfloat16* A, const __nv_bfloat16* W,
                       const __nv_bfloat16* bias, const __nv_bfloat16* res,
                       __nv_bfloat16* out, int M, int N, int K, int act,
                       cudaStream_t st) {
  return gemm_bf16(A, W, bias, res, out, M, N, K, act, st);
}

}  // namespace
}  // namespace ullsam
