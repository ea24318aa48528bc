// B12: weight-only int8 matmul (W8A16) for the LLM's linears.
//
//     out[m, n] = cast((sum_k x[m, k] * q[n, k]) * scale[n] + bias[n])
//
// x [M, K] float32 or bfloat16, q [N, K] int8 (the natural [out, in]
// weight), scale [N] f32 (per output channel), bias [N] f32 or none; the
// sum in f32, the result rounded once to f32 or to x's type. int8 -> f32 is
// exact (|q| <= 127), so a bf16 x gives exact products and only the order
// of the sums differs from the plain version; an f32 x is split exactly
// into three bf16 planes (below), so the same holds. Replaces the TPU kernel
// ullsam_tpu/ops/pallas/int8_matmul.py `_w8a16_kernel` (scale on the f32
// sum; the bias and the cast are the JAX linear's epilogue,
// ullsam_tpu/ops/layers.py:76-81, fused here).
//
// What bounds it on an H100, and what the design does about it:
//   * Decode (M <= 16): memory-bound. K.N int8 bytes stream once per call
//     (w1 at M = 1: 16.8 MB, 5.0 us at 3.35 TB/s). With bf16 x at 2 <= M
//     <= 16 (the serving engine's step at 8 rows, 4 beams, a batch of 8)
//     w8a16_decode_tc runs the product on the tensor cores, swapped: out^T
//     = W . x^T on mma.sync m16n8k16, a warp's 16 weight rows the A
//     operand and x's rows, padded to 8 or 16, the n side. On the CUDA
//     cores (w8a16_gemv) a lane did M x 16 f32 FMAs and 2M shared-memory
//     reads of x for each 16 weight bytes: at 8 rows 4.3x its bound. Here
//     the work per weight byte is the exact int8 -> bf16 conversion
//     (byte-permute into the mantissa of 2^23, subtract, keep the top
//     half: about 3 instructions a byte) and 1 / 128 of an mma whatever M
//     is. A lane streams 16 contiguous bytes of each of its two rows from
//     each 64-byte chunk (a quad of lanes covers the chunk), 4 chunks a
//     step, two steps in flight: 16 16-byte loads a lane, 64 KB an SM,
//     each asking L2 for its whole 256-byte line (a step's bytes of a
//     row).
//     The k order inside an mma is free when x follows it, so a lane's own
//     bytes are its A fragment and x's B fragment is 4 consecutive bf16 at
//     the same k (conflict-free 16-byte reads of a padded shared-memory
//     slice). A block of 8 warps takes 128 / W weight rows: the W warps of
//     each 16-row tile split its K and are added in warp order through
//     shared memory, with W doubled (tc_plan) while the blocks still fit
//     in one wave of the card's SMs (wo, w2: 16 rows a block, 8 warps on
//     a tile's K; wqkv 32; w1 / w3 64; the head's 724 groups of 128 rows
//     fill it at W = 1). Blocks split K (S) only where x's slice would
//     not fit in 128 KB (w2 at 9-16 rows): each writes its tiles' f32
//     partials to the workspace in the accumulators' own layout
//     (coalesced), and the group's last block (a counter a group, which
//     it resets to 0 for the next launch) adds them in split order and
//     applies the scale, the bias and the cast once: no float atomics,
//     two calls bitwise equal, one launch a call, and a
//     captured CUDA graph replays it with no memset. The ragged head (N =
//     92,553: 724 groups, no split) masks its last rows. M = 1 keeps
//     w8a16_gemv (x in bf16 or f32; the tensor-core body measured
//     1.3-1.5x slower at one row): each warp
//     gives R whole rows of q; a lane reads 16 bytes of each row per step
//     (a warp: 512 contiguous bytes a row) with streaming loads, four
//     16-byte loads in flight a lane, and blocks stay resident (persistent
//     grid sized by the occupancy API). x lives in shared
//     memory in its own type, in 16-byte vectors laid out chunk-major so
//     that the lanes' reads are conflict-free; K is tiled when M x K does
//     not fit in 96 KB. Each x vector read serves R rows. The FMAs are f32;
//     int8 -> f32 is one byte-permute into the mantissa of 2^23 and one
//     subtraction (no conversion instruction); the scale is applied to the
//     warp-reduced sum.
//   * Prefill (M > 16): operation-bound at the path's shapes (M = 1152: 38.7
//     GFLOP for w1 against 16.8 MB). bf16 x at N % 128 == 0 and K % 64 ==
//     0 (every layer linear of InternLM2-1.8B: wqkv 4096 x 2048, wo 2048 x
//     2048, w1 / w3 8192 x 2048, w2 2048 x 8192) runs gemm_sm90.cuh's
//     wgmma + TMA GEMM with an int8 W operand (see the note there): W's
//     stage lands by TMA as int8 (half of bf16's bytes) and the product is
//     swapped (out^T = W . x^T) so that W is wgmma's register A operand,
//     converted exactly from int8 pairs, with x's 144-row tile the
//     shared-memory B operand; the two consumer warpgroups share a tile so
//     that one's conversion overlaps the other's products, and the
//     epilogue transposes back through its staging, applying the scale and
//     the bias to the f32 sum and rounding once (ragged M masked). qweight
//     keeps its natural [N, K] layout, which the decode GEMV and the plain
//     version read too. 144-row tiles make 128 tiles of wo and w2 at M =
//     1152 (a wave of 132 SMs; 128-row tiles made 144, a second wave 9%
//     full); split-K into 2 or 4 with 128-row tiles there measured 7-40%
//     slower for wqkv, wo and w1 and 5% faster for w2. At the serving
//     engine's segments (M = 128, 256: 16-64 tiles of wqkv, wo and w2)
//     the tiles leave most SMs idle, so the kind splits K there
//     (gemm_sm90.cuh sm90_int8_splits, the same fixed-order reduction in
//     the tile's last unit, W8Epilogue once); M = 1152 and 9216 keep one
//     split, bitwise the unsplit kernel. With bf16 x the ragged
//     92,553-column head and other widths keep w8a16_gemm_mma (128 x 128
//     tiles, k-tile 32, mma.sync m16n8k16, the int8 tile staged by
//     cp.async and converted to bf16 in shared memory before ldmatrix; it
//     beats F.linear on the head). f32 x at widths the wgmma kind does not
//     take (K % 64, N < 128) runs w8a16_gemm_f32, gemm.cuh's CUDA-core FMA
//     GEMM with the int8 tile converted as it is stashed.
//   * f32 x (the app's --dtype float32 --quant int8) on the bf16 tensor
//     cores, exactly: x = b0 + b1 + b2 (split_bf16x3: b0 x cut to bf16, b1
//     the remainder cut, b2 the rest, itself a bf16 wherever x's bits lie
//     at or above 2^-133), so W . x = W . b0 + W . b1 + W . b2 with every
//     product exact, at three bf16 products (3 / 989 of a peak second a
//     TFLOP; split TF32 would need three TF32 ones, 3 / 495, and round x).
//     Each 16-deep step's three products go into a partial from zero, the
//     small planes first, that the CUDA cores add to the f32 sum (round to
//     nearest): the tensor cores' accumulation truncates, and one
//     accumulator over K = 8192 drifts to 8.6e-6 of max|out| (the bf16
//     wgmma kind), where the plain f32 version errs about 3e-7. At
//     2 <= M <= 16 w8a16_decode_tc<.., kX3> (w8a16_decode_tc_f32) stages
//     x's K slice as its three planes, split as it is loaded (three times
//     bf16's bytes, so tc_plan splits K across blocks at fewer rows: K =
//     2048 from 9 rows, w2 from 2, and there gives a block up to 4x the
//     rows, so that fewer blocks read x's slice as f32), each converted
//     weight fragment feeding three mma.sync. At M > 16 where sm90_takes holds
//     (w8a16_sm90_f32) a pre-pass (w8a16_split_x3) writes the planes into
//     the workspace as [M, 3K] bf16 (6 bytes an element against x's 4)
//     and gemm_sm90.cuh's kSm90Int8X3 kind lands three boxes a stage by
//     TMA, W's fragment converted once for three wgmmas; splits as the
//     int8 kind. Two launches, each counted (kW8SplitX3, kW8Sm90F32). It
//     also takes the ragged head and any N of at least one tile
//     (w8_x3_takes; caption_ids' prefill runs the head over every prompt
//     row, 1152 at batch 1), its epilogue masking the last tile's columns
//     past N.
//   * N is ragged (the head), masked by bounds checks; K must be a multiple
//     of 16 (one 16-byte int8 vector), which the C entry and the wrapper
//     check.
// Which kernel a call launches and its splits are mirrored by
// ops/kernels/int8_matmul.py w8a16_kernel and splits (w8a16_splits gives
// this library's own plan), and each launch is counted
// (w8a16_launch_count).
// Later work: a fused gate/up pair (w1 and w3 read one x), the head's
// bf16 prefill on the wgmma kind (as f32 x's takes it), f32 x's decode slice
// read by fewer blocks (each block of wo and w2 reads x's whole f32 slice,
// twice the bytes of its 16 weight rows).
#include <algorithm>
#include <type_traits>

#include "gemm_sm90.cuh"

namespace ullsam {
namespace {

// launches of each B12 kernel made through this library
enum W8Kernel : int {
  kW8Gemv = 0, kW8Sm90 = 1, kW8Mma = 2, kW8F32 = 3, kW8DecodeTc = 4,
  kW8Sm90F32 = 5, kW8DecodeTcF32 = 6, kW8SplitX3 = 7
};
constexpr int kW8Kernels = 8;
long long w8_launch_counts[kW8Kernels] = {0, 0, 0, 0, 0, 0, 0, 0};

// int8 x4 (one word) -> 4 exact floats: b ^ 0x80 = b + 128 in [1, 255]
// placed in the mantissa of 2^23, minus 2^23 + 128
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
           8388736.f;
}

__device__ __forceinline__ void i8x16_to_f32(uint4 w, float* f) {
  i8x4_to_f32(w.x, f);
  i8x4_to_f32(w.y, f + 4);
  i8x4_to_f32(w.z, f + 8);
  i8x4_to_f32(w.w, f + 12);
}

// f32 x = b0 + b1 + b2 in bf16, exactly (int8_matmul.split_bf16x3): b0 is
// x cut to its top 16 bits, b1 the remainder r1 = x - b0 (exact) cut the
// same way, b2 = r1 - b1 (exact, at most 8 significant bits) rounded to
// nearest, which changes it only where its bits lie below 2^-133 (bf16's
// least subnormal: |x| < 2^-110). Cutting, not rounding, b0 keeps the
// largest floats finite. Non-finite x gives NaN parts. Two values at once:
// each part's bf16 pair packed into a word, the first in the low half.
__device__ __forceinline__ void split_bf16x3(float x0, float x1,
                                             uint32_t* h) {
  const uint32_t u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
  const float r0 = x0 - __uint_as_float(u0 & 0xffff0000u);
  const float r1 = x1 - __uint_as_float(u1 & 0xffff0000u);
  const uint32_t v0 = __float_as_uint(r0), v1 = __float_as_uint(r1);
  const __nv_bfloat162 b2 =
      __floats2bfloat162_rn(r0 - __uint_as_float(v0 & 0xffff0000u),
                            r1 - __uint_as_float(v1 & 0xffff0000u));
  h[0] = __byte_perm(u0, u1, 0x7632);
  h[1] = __byte_perm(v0, v1, 0x7632);
  h[2] = *reinterpret_cast<const uint32_t*>(&b2);
}

// 8 floats (two float4) -> the three planes' 8 bf16 each
__device__ __forceinline__ void split8_bf16x3(float4 a, float4 b,
                                              uint4* p) {
  uint32_t h[4][3];
  split_bf16x3(a.x, a.y, h[0]);
  split_bf16x3(a.z, a.w, h[1]);
  split_bf16x3(b.x, b.y, h[2]);
  split_bf16x3(b.z, b.w, h[3]);
#pragma unroll
  for (int q = 0; q < 3; ++q)
    p[q] = make_uint4(h[0][q], h[1][q], h[2][q], h[3][q]);
}

// one 16-byte vector of x as floats: 8 bf16 or 4 f32
__device__ __forceinline__ void vec_to_f32(uint4 v, float* f,
                                           const __nv_bfloat16*) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void vec_to_f32(uint4 v, float* f, const float*) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ void store_out(void* out, size_t i, float v,
                                          int out_f32, const float*) {
  static_cast<float*>(out)[i] = v;
}
__device__ __forceinline__ void store_out(void* out, size_t i, float v,
                                          int out_f32, const __nv_bfloat16*) {
  if (out_f32)
    static_cast<float*>(out)[i] = v;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
}

// ---- decode: M <= MM <= 16 ----------------------------------------------
constexpr int kGemvWarps = 8, kGemvThreads = kGemvWarps * 32;
constexpr int kXSmemBudget = 96 * 1024;

// x[:, k0:k0+kn] -> shared memory, 16-byte vectors ordered [m][v][chunk]
// (v: the vector within a 16-element chunk, VPC of them), nck chunks a row
template <typename T>
__device__ __forceinline__ void fill_x(uint4* xs, const T* __restrict__ x,
                                       int M, int K, int k0, int kn,
                                       int nck) {
  constexpr int VPV = 16 / sizeof(T), VPC = 16 / VPV;
  const int per_row = kn / VPV;
  for (int i = threadIdx.x; i < M * per_row; i += kGemvThreads) {
    const int m = i / per_row, r = i - m * per_row;
    const int c = r / VPC, v = r - c * VPC;
    xs[(m * VPC + v) * nck + c] = *reinterpret_cast<const uint4*>(
        x + (size_t)m * K + k0 + r * VPV);
  }
}

// U = 4 / R chunks of each of the warp's R rows are loaded at once: four
// 16-byte loads in flight a lane whatever R
template <typename T, int MM, int R, int U = 4 / R>
__global__ void __launch_bounds__(kGemvThreads)
    w8a16_gemv(const T* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ scale,
               const float* __restrict__ bias, void* __restrict__ out,
               int out_f32, int M, int N, int K, int KT) {
  constexpr int VPV = 16 / sizeof(T), VPC = 16 / VPV;
  extern __shared__ uint4 xs[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = (N + kGemvWarps * R - 1) / (kGemvWarps * R);
  const int nck = KT / 16;
  const bool resident = KT >= K;
  if (resident) {
    fill_x(xs, x, M, K, 0, K, nck);
    __syncthreads();
  }
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int row0 = (grp * kGemvWarps + warp) * R;
    float acc[R][MM];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int m = 0; m < MM; ++m) acc[r][m] = 0.f;
    for (int k0 = 0; k0 < K; k0 += KT) {
      const int kn = min(KT, K - k0);
      if (!resident) {
        __syncthreads();  // every warp is done with the previous tile
        fill_x(xs, x, M, K, k0, kn, nck);
        __syncthreads();
      }
      const int nc = kn / 16;
      for (int c0 = lane; c0 < nc; c0 += 32 * U) {
        // all U x R loads issued before any is used
        uint4 raw[U][R];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int c = c0 + 32 * u;
            raw[u][r] = row0 + r < N && c < nc
                            ? __ldcs(reinterpret_cast<const uint4*>(
                                  q + (size_t)(row0 + r) * K + k0 + c * 16))
                            : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = c0 + 32 * u;
          if (c >= nc) break;
          float w[R][16];
#pragma unroll
          for (int r = 0; r < R; ++r) i8x16_to_f32(raw[u][r], w[r]);
#pragma unroll
          for (int m = 0; m < MM; ++m) {
            if (m >= M) break;
#pragma unroll
            for (int v = 0; v < VPC; ++v) {
              float xf[VPV];
              vec_to_f32(xs[(m * VPC + v) * nck + c], xf,
                         static_cast<const T*>(nullptr));
#pragma unroll
              for (int r = 0; r < R; ++r)
#pragma unroll
                for (int j = 0; j < VPV; ++j)
                  acc[r][m] = fmaf(w[r][v * VPV + j], xf[j], acc[r][m]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = row0 + r;
#pragma unroll
      for (int m = 0; m < MM; ++m) {
        if (m >= M) break;
        const float s = warp_sum(acc[r][m]);
        if (lane == 0 && n < N) {
          float y = s * scale[n];
          if (bias) y += bias[n];
          store_out(out, (size_t)m * N + n, y, out_f32,
                    static_cast<const T*>(nullptr));
        }
      }
    }
  }
}

// ---- decode, bf16 x, kTcMinM <= M <= 16: tensor cores, split K ---------
// out^T = W . x^T on mma.sync m16n8k16: a warp's 16 weight rows are the A
// operand, x's rows (padded to 8 NT) the n side. A lane streams 16 bytes of
// each of its two rows (g, g + 8) from each 64-byte chunk (the quad of
// lanes tq = 0..3 covers the chunk), kTcChunks chunks a step, two steps in
// flight (16 16-byte loads a lane). The k order inside an mma is free as
// long as x follows it: byte 4s + i of a lane's chunk is logical k 2tq + i
// (i < 2) or 8 + 2tq + i - 2 of the step-s product, so the B fragment of
// step s is the 4 consecutive bf16 of x at the same k (one 8-byte word of
// shared memory), and A is the lane's own bytes converted exactly to bf16
// in registers. A block of 8 warps takes 8 / W tiles of 16 weight rows and
// x's K slice in shared memory; the W warps of a tile split its K and are
// added in warp order through shared memory; S blocks split K only where
// x's slice would not fit (kTcXBytes), adding their partials in the
// group's last block. With f32 x (kX3) the slice is staged as x's three
// bf16 planes (split as it is loaded) and each converted weight fragment
// runs three mmas, one a plane, into a partial from zero that the CUDA
// cores add to the sum (the tensor cores' own accumulation, truncating,
// would lose up to about half an ulp of the sum an mma).
constexpr int kTcWarps = 8, kTcThreads = kTcWarps * 32;
constexpr int kTcChunks = 4;            // 64-byte k-chunks a warp step
constexpr int kTcXBytes = 128 * 1024;   // x's slice in shared memory at most
constexpr int kTcMinM = 2;              // M = 1 keeps the GEMV
constexpr int kTcXPad = 8;              // bf16 a staged x row is padded by
constexpr int kTcSumSplits = 8;         // partials in flight a batch

// the plan of the decode body (w = 0: it does not take the shape): W warps
// a 16-row tile (rows a block 128 / W), doubled while the groups of rows
// still fit twice in one wave of the card's SMs and a warp keeps whole
// 64-byte chunks; S blocks on a K slice, doubled until x's slice (8 or 16
// rows; planes 3 of them with f32 x) fits kTcXBytes. With f32 x, where
// that splits K across blocks, a block takes up to 4x the rows (W / 4, S x
// 4, a warp's K part unchanged): each block stages its slice of x as f32,
// twice the bytes of bf16's, which at 16 rows a block outweighs its
// weights (w2 at 8 rows: 64 KB of x for 32 KB of weights); taller blocks
// read a quarter of it (w2 at 8 rows 0.0216 -> 0.0176 ms, every 16-row
// linear 12-25% faster; where the slice fits, splitting K would cost more
// than it saves: wo at 4 rows 0.0071 -> 0.0074). Mirrored by
// ops/kernels/int8_matmul.py decode_plan.
struct TcPlan {
  int w, s;
};
inline TcPlan tc_plan(int M, int N, int K, int sms, int planes) {
  if (M < kTcMinM || M > 16 || K % 64) return {0, 0};
  const int mm = M <= 8 ? 8 : 16;
  int w = 1;
  while (w < kTcWarps && (N + 8 * kTcWarps / w - 1) / (8 * kTcWarps / w) <=
                             sms && K % (2 * w * 64) == 0)
    w *= 2;
  int s = 1;
  while ((long long)planes * mm * (K / s) * 2 > kTcXBytes) {
    if (K % (2 * s * w * 64)) return {0, 0};
    s *= 2;
  }
  if (planes == 3 && s > 1)
    for (int i = 0; i < 2 && w > 1; ++i) w /= 2, s *= 2;
  return {w, s};
}

// 16 weight bytes read once a call: not kept in L1, and the rest of their
// 256-byte line fetched into L2 at once (a warp step reads 256 contiguous
// bytes of each row, 64 of them a load)
__device__ __forceinline__ uint4 ld_stream256(const int8_t* p) {
  uint4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// int8 x4 (one word) -> bf16 pairs: lo the first two bytes, hi the last two
__device__ __forceinline__ void i8x4_to_bf16x2(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  float f[4];
  i8x4_to_f32(w, f);
  lo = pack_bf16_exact(f[0], f[1]);
  hi = pack_bf16_exact(f[2], f[3]);
}

// y = sum * scale[n] (+ bias[n]), two f32 roundings as the plain version
__device__ __forceinline__ float w8_epi(float v, const float* scale,
                                        const float* bias, int n) {
  const float y = __fmul_rn(v, scale[n]);
  return bias ? __fadd_rn(y, bias[n]) : y;
}

template <int NT, typename OutT, bool kX3 = false,
          typename XT = std::conditional_t<kX3, float, __nv_bfloat16>>
__global__ void __launch_bounds__(kTcThreads, 2)
    w8a16_decode_tc(const XT* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, OutT* __restrict__ out,
                    float* __restrict__ ws, int* __restrict__ counters,
                    int M, int N, int K, int W, int S) {
  extern __shared__ uint4 xs_vec[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(xs_vec);
  __shared__ float4 red[kTcWarps][NT][32];  // the W warps of a tile
  __shared__ int last_block;
  const int tiles = kTcWarps / W;  // 16-row tiles a block
  const int KB = K / S, KW = KB / W, ld = KB + kTcXPad, nch = KW / 64;
  const int grp = blockIdx.x / S, sp = blockIdx.x - grp * S;
  const int k0 = sp * KB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rt = warp / W, wk = warp - rt * W;  // row tile, K part
  const int g = lane >> 2, tq = lane & 3;
  const int ra = (grp * tiles + rt) * 16 + g, rb = ra + 8;  // lane's rows
  const bool va = ra < N, vb = rb < N;
  const int kw0 = wk * KW;  // the warp's K part within the block's slice
  const int8_t* qa = q + (size_t)(va ? ra : 0) * K + k0 + kw0 + 16 * tq;
  const int8_t* qb = q + (size_t)(vb ? rb : 0) * K + k0 + kw0 + 16 * tq;
  const int steps = (nch + kTcChunks - 1) / kTcChunks;
  const int plane = 8 * NT * ld;  // bf16 a plane of x's slice (kX3)
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // step st's chunks of both rows
  const auto load = [&](uint4 (&w)[kTcChunks][2], int st) {
#pragma unroll
    for (int j = 0; j < kTcChunks; ++j) {
      const int c = st * kTcChunks + j;
      w[j][0] = va && c < nch ? ld_stream256(qa + c * 64) : zero;
      w[j][1] = vb && c < nch ? ld_stream256(qb + c * 64) : zero;
    }
  };
  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  const auto mma_step = [&](const uint4 (&w)[kTcChunks][2], int st) {
#pragma unroll
    for (int j = 0; j < kTcChunks; ++j) {
      const int c = st * kTcChunks + j;
      if (c >= nch) break;  // warp-uniform
      const int kk = kw0 + c * 64 + 16 * tq;
      if constexpr (kX3) {
        const uint32_t wa[4] = {w[j][0].x, w[j][0].y, w[j][0].z, w[j][0].w};
        const uint32_t wb[4] = {w[j][1].x, w[j][1].y, w[j][1].z, w[j][1].w};
#pragma unroll
        for (int hx = 0; hx < 2; ++hx) {  // the chunk's 16-byte x halves
          uint32_t a[2][4];  // the A fragments of steps 2 hx, 2 hx + 1
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            i8x4_to_bf16x2(wa[2 * hx + u], a[u][0], a[u][2]);
            i8x4_to_bf16x2(wb[2 * hx + u], a[u][1], a[u][3]);
          }
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            uint4 xq[3];
#pragma unroll
            for (int p = 0; p < 3; ++p)
              xq[p] = reinterpret_cast<const uint4*>(
                  xs + p * plane + (8 * t + g) * ld + kk)[hx];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int p = 2; p >= 0; --p) {  // the small planes first
                const uint32_t b[2] = {u ? xq[p].z : xq[p].x,
                                       u ? xq[p].w : xq[p].y};
                mma_bf16_16816(part, a[u], b);
              }
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[t][e] = __fadd_rn(acc[t][e], part[e]);
            }
          }
        }
        continue;
      }
      uint4 xv[NT][2];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const uint4* xr =
            reinterpret_cast<const uint4*>(xs + (8 * t + g) * ld + kk);
        xv[t][0] = xr[0];
        xv[t][1] = xr[1];
      }
      const uint32_t wa[4] = {w[j][0].x, w[j][0].y, w[j][0].z, w[j][0].w};
      const uint32_t wb[4] = {w[j][1].x, w[j][1].y, w[j][1].z, w[j][1].w};
#pragma unroll
      for (int s4 = 0; s4 < 4; ++s4) {
        uint32_t a[4];
        i8x4_to_bf16x2(wa[s4], a[0], a[2]);
        i8x4_to_bf16x2(wb[s4], a[1], a[3]);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const uint4& h = xv[t][s4 >> 1];
          const uint32_t b[2] = {s4 & 1 ? h.z : h.x, s4 & 1 ? h.w : h.y};
          mma_bf16_16816(acc[t], a, b);
        }
      }
    }
  };

  uint4 w0[kTcChunks][2], w1[kTcChunks][2];
  load(w0, 0);  // two steps in flight while x's slice is staged
  if (steps > 1) load(w1, 1);
  if constexpr (kX3) {
    // f32 x[:, k0 : k0 + KB] -> its three bf16 planes [3][8 NT][ld], rows
    // >= M zero: 8 floats an item, two items' loads in flight at once (the
    // weight steps in flight hold 64 registers)
    const int vpr = KB / 8, items = 8 * NT * vpr;
    const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i0 = threadIdx.x; i0 < items; i0 += 2 * kTcThreads) {
      float4 f[2][2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = i0 + u * kTcThreads, m = i / vpr, v = i - m * vpr;
        const bool ok = i < items && m < M;
        const float4* src = reinterpret_cast<const float4*>(
            x + (ok ? (size_t)m * K + k0 + v * 8 : 0));
        f[u][0] = ok ? __ldg(src) : z4;
        f[u][1] = ok ? __ldg(src + 1) : z4;
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = i0 + u * kTcThreads, m = i / vpr, v = i - m * vpr;
        if (i >= items) break;
        uint4 pv[3];
        split8_bf16x3(f[u][0], f[u][1], pv);
#pragma unroll
        for (int p = 0; p < 3; ++p)
          *reinterpret_cast<uint4*>(xs + p * plane + m * ld + v * 8) = pv[p];
      }
    }
  } else {  // x[:, k0 : k0 + KB] -> xs [8 NT][ld] by cp.async, rows >= M zero
    const int vpr = KB / 8;
    for (int i = threadIdx.x; i < 8 * NT * vpr; i += kTcThreads) {
      const int m = i / vpr, v = i - m * vpr;
      cp_async16(smem_u32(xs + m * ld + v * 8),
                 x + (size_t)(m < M ? m : 0) * K + k0 + v * 8, m < M);
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  for (int st = 0; st < steps; st += 2) {
    mma_step(w0, st);
    if (st + 2 < steps) load(w0, st + 2);
    if (st + 1 >= steps) break;
    mma_step(w1, st + 1);
    if (st + 3 < steps) load(w1, st + 3);
  }

  // the W warps of a tile, added in warp order (its first warp keeps them)
  if (W > 1) {
#pragma unroll
    for (int t = 0; t < NT; ++t)
      red[warp][t][lane] =
          make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
    __syncthreads();
    if (wk == 0)
      for (int j = 1; j < W; ++j)
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const float4 r = red[warp + j][t][lane];
          acc[t][0] = __fadd_rn(acc[t][0], r.x);
          acc[t][1] = __fadd_rn(acc[t][1], r.y);
          acc[t][2] = __fadd_rn(acc[t][2], r.z);
          acc[t][3] = __fadd_rn(acc[t][3], r.w);
        }
  }
  // acc[t][e] of a tile's first warp: out row m = 8t + 2tq + (e & 1),
  // column n = ra (e < 2) or rb
  const auto store = [&]() {
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 8 * t + 2 * tq + (e & 1), n = e < 2 ? ra : rb;
        if (m < M && n < N)
          out[(size_t)m * N + n] = from_f<OutT>(w8_epi(acc[t][e], scale,
                                                       bias, n));
      }
  };
  if (S == 1) {
    if (wk == 0) store();
    return;
  }
  // split K across blocks: each tile's partial to the workspace in the
  // accumulators' own layout (float4 t of lane l of tile rt of block b at
  // ((b x tiles + rt) x NT + t) x 32 + l); the group's last block adds the
  // S partials in split order and runs the epilogue once (no float atomics:
  // two calls are bitwise equal), and resets the group's counter
  float4* ws4 = reinterpret_cast<float4*>(ws);
  const auto part = [&](int s, int t) {
    return ws4 + ((size_t)((grp * S + s) * tiles + rt) * NT + t) * 32 + lane;
  };
  if (wk == 0)
#pragma unroll
    for (int t = 0; t < NT; ++t)
      *part(sp, t) = make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last_block = atomicAdd(&counters[grp], 1) == S - 1;
    if (last_block) counters[grp] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!last_block || wk != 0) return;
  __threadfence();
  for (int s0 = 0; s0 < S; s0 += kTcSumSplits) {
    float4 p[kTcSumSplits][NT];
#pragma unroll
    for (int ss = 0; ss < kTcSumSplits; ++ss)
#pragma unroll
      for (int t = 0; t < NT; ++t)
        p[ss][t] = s0 + ss < S ? __ldcg(part(s0 + ss, t))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int ss = 0; ss < kTcSumSplits; ++ss)
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        if (s0 + ss >= S) continue;
        if (s0 + ss == 0) {
          acc[t][0] = p[ss][t].x, acc[t][1] = p[ss][t].y;
          acc[t][2] = p[ss][t].z, acc[t][3] = p[ss][t].w;
        } else {
          acc[t][0] = __fadd_rn(acc[t][0], p[ss][t].x);
          acc[t][1] = __fadd_rn(acc[t][1], p[ss][t].y);
          acc[t][2] = __fadd_rn(acc[t][2], p[ss][t].z);
          acc[t][3] = __fadd_rn(acc[t][3], p[ss][t].w);
        }
      }
  }
  store();
}

// ---- prefill, bf16: tensor-core GEMM with the int8 tile converted -------
// gemm.cuh's gemm_nt_bf16_mma, with B staged as int8 (128 rows x 32 bytes,
// one 16-byte cp.async a thread) and converted into one bf16 tile before
// the ldmatrix reads. Chunks past K are zero-filled (K % 16 == 0).
template <typename OutT>
__global__ void __launch_bounds__(256)
    w8a16_gemm_mma(const __nv_bfloat16* __restrict__ A,
                   const int8_t* __restrict__ Q,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, OutT* __restrict__ out,
                   int M, int N, int K) {
  __shared__ __align__(16) __nv_bfloat16 As[2][kMmaBM * kMmaLd];
  __shared__ __align__(16) int8_t Bq[2][kMmaBN * kMmaBK];
  __shared__ __align__(16) __nv_bfloat16 Bs[kMmaBN * kMmaLd];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * kMmaBM, n0 = blockIdx.x * kMmaBN;

  auto load = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 128 rows x 4 chunks of 8 bf16, twice
      const int c = tid + i * 256, row = c >> 2, ch = (c & 3) * 8;
      const int gm = m0 + row;
      const bool ok = gm < M && k0 + ch < K;
      cp_async16(smem_u32(&As[stage][row * kMmaLd + ch]),
                 A + (size_t)(ok ? gm : 0) * K + (ok ? k0 + ch : 0), ok);
    }
    {  // 128 rows x 2 chunks of 16 int8
      const int row = tid >> 1, ch = (tid & 1) * 16, gn = n0 + row;
      const bool ok = gn < N && k0 + ch < K;
      cp_async16(smem_u32(&Bq[stage][row * kMmaBK + ch]),
                 Q + (size_t)(ok ? gn : 0) * K + (ok ? k0 + ch : 0), ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  const int KT = (K + kMmaBK - 1) / kMmaBK;
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
    {  // this thread's 16 int8 -> 16 bf16 (exact)
      const int row = tid >> 1, ch = (tid & 1) * 16;
      float f[16];
      i8x16_to_f32(*reinterpret_cast<const uint4*>(
                       &Bq[kt & 1][row * kMmaBK + ch]),
                   f);
      uint4* dst = reinterpret_cast<uint4*>(&Bs[row * kMmaLd + ch]);
      dst[0] = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                          pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
      dst[1] = make_uint4(pack_bf16(f[8], f[9]), pack_bf16(f[10], f[11]),
                          pack_bf16(f[12], f[13]), pack_bf16(f[14], f[15]));
    }
    __syncthreads();
    const __nv_bfloat16* as = As[kt & 1];
#pragma unroll
    for (int kk = 0; kk < kMmaBK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int row = wm * 64 + mi * 16 + (lane & 15);
        ldmatrix_x4(af[mi],
                    smem_u32(as + row * kMmaLd + kk + (lane >> 4) * 8));
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int row = wn * 32 + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
        uint32_t r[4];
        ldmatrix_x4(r, smem_u32(Bs + row * kMmaLd + kk +
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
        if (m >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // N is ragged: one column at a time
          const int nn = n0 + wn * 32 + ni * 8 + 2 * t + e;
          if (nn >= N) continue;
          float v = acc[mi][ni][2 * hf + e] * scale[nn];
          if (bias) v += bias[nn];
          out[(size_t)m * N + nn] = from_f<OutT>(v);
        }
      }
}

// ---- prefill, bf16 on the wgmma GEMM: B12's epilogue -------------------
// v = columns n .. n + 7 of row m of the f32 sum: times scale[n], plus
// bias[n] (two f32 roundings, as the plain version), rounded once to OutT;
// where the 8 columns reach past N (the f32-x kind's last tile at an N
// that is not a multiple of 128, the vocab head's or one of 200) or the
// rows are not 16-byte aligned (N % 8), column by column, the columns past
// N dropped
template <typename OutT>
struct W8Epilogue {
  const float* scale;
  const float* bias;
  OutT* out;
  int N;
  __device__ __forceinline__ void operator()(int m, int n, float* v) const {
    if (N % 8 || n + 8 > N) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (n + e < N) {
          float y = __fmul_rn(v[e], scale[n + e]);
          if (bias) y = __fadd_rn(y, bias[n + e]);
          out[(size_t)m * N + n + e] = from_f<OutT>(y);
        }
      return;
    }
    const float4 s0 = *reinterpret_cast<const float4*>(scale + n);
    const float4 s1 = *reinterpret_cast<const float4*>(scale + n + 4);
    const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __fmul_rn(v[e], sc[e]);
    if (bias) {
      const float4 b0 = *reinterpret_cast<const float4*>(bias + n);
      const float4 b1 = *reinterpret_cast<const float4*>(bias + n + 4);
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(v[e], bb[e]);
    }
    OutT* o = out + (size_t)m * N + n;
    if constexpr (sizeof(OutT) == 4) {
      reinterpret_cast<float4*>(o)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(o)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      *reinterpret_cast<uint4*>(o) =
          make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                     pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    }
  }
};

// ---- prefill, f32: CUDA-core FMA GEMM (true f32) with int8 B ------------
// gemm.cuh's gemm_nt_f32; each thread fetches 4 int8 of B per k-tile
// (K % 8 == 0) and stashes them as floats.
__global__ void __launch_bounds__(256)
    w8a16_gemm_f32(const float* __restrict__ A, const int8_t* __restrict__ Q,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int M, int N, int K) {
  __shared__ __align__(16) float As[2][kGemmBK][kGemmBM + 4];
  __shared__ __align__(16) float Bs[2][kGemmBK][kGemmBN + 4];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kGemmBM, n0 = blockIdx.x * kGemmBN;
  const int lrow = tid >> 1, lk = (tid & 1) * 4;
  const int tx = tid & 15, ty = tid >> 4;
  const int gm = m0 + lrow, gn = n0 + lrow;
  const auto fetch_a = [&](int k0) {
    return gm < M ? *reinterpret_cast<const float4*>(A + (size_t)gm * K +
                                                     k0 + lk)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  const auto fetch_b = [&](int k0) {
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (gn < N)
      i8x4_to_f32(*reinterpret_cast<const uint32_t*>(Q + (size_t)gn * K +
                                                     k0 + lk),
                  f);
    return make_float4(f[0], f[1], f[2], f[3]);
  };
  const auto stash = [&](float (*S)[kGemmBM + 4], float4 v) {
    S[lk][lrow] = v.x;
    S[lk + 1][lrow] = v.y;
    S[lk + 2][lrow] = v.z;
    S[lk + 3][lrow] = v.w;
  };
  float4 ra = fetch_a(0), rb = fetch_b(0);
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
      ra = fetch_a((kt + 1) * kGemmBK);
      rb = fetch_b((kt + 1) * kGemmBK);
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
    if (kt + 1 < KT) {
      stash(As[cur ^ 1], ra);
      stash(Bs[cur ^ 1], rb);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int nn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (nn >= N) continue;
      float v = acc[i][j] * scale[nn];
      if (bias) v += bias[nn];
      out[(size_t)m * N + nn] = v;
    }
  }
}

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <typename T, int MM, int R>
int launch_gemv(const T* x, const int8_t* q, const float* scale,
                const float* bias, void* out, int out_f32, int M, int N,
                int K, cudaStream_t st) {
  // the whole of x in shared memory if it fits in the budget, else K in
  // equal tiles of whole 16-element chunks
  const size_t row_bytes = (size_t)K * sizeof(T);
  int KT = K;
  if ((size_t)M * row_bytes > kXSmemBudget) {
    const int tiles = (int)(((size_t)M * row_bytes + kXSmemBudget - 1) /
                            kXSmemBudget);
    KT = ((K + tiles - 1) / tiles + 15) / 16 * 16;
  }
  const int smem = M * KT * (int)sizeof(T);
  // per shared-memory size in 4 KB steps (at most the 96 KB budget): the
  // occupancy is queried once for each, not at every launch
  static int attr_smem = 0, blocks_per_sm[kXSmemBudget / 4096 + 1] = {};
  auto kernel = w8a16_gemv<T, MM, R>;
  const int step = (smem + 4095) / 4096;
  if (step * 4096 > attr_smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, step * 4096);
    if (e != cudaSuccess) return (int)e;
    attr_smem = step * 4096;
  }
  int& occ = blocks_per_sm[step];
  if (occ == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, kernel, kGemvThreads, step * 4096);
    if (e != cudaSuccess) return (int)e;
    occ = std::max(occ, 1);
  }
  const int groups = (N + kGemvWarps * R - 1) / (kGemvWarps * R);
  const int grid = std::min(groups, occ * num_sms());
  kernel<<<grid, kGemvThreads, smem, st>>>(x, q, scale, bias, out, out_f32,
                                           M, N, K, KT);
  return (int)cudaGetLastError();
}

// rows a warp takes: the most of 4, 2, 1 that still gives every SM two
// row groups of 8 warps
int rows_per_warp(int N) {
  const int want = 2 * num_sms();
  for (int R = 4; R > 1; R >>= 1)
    if ((N + kGemvWarps * R - 1) / (kGemvWarps * R) >= want) return R;
  return 1;
}

template <typename T, int MM>
int gemv_rows(const T* x, const int8_t* q, const float* scale,
              const float* bias, void* out, int out_f32, int M, int N, int K,
              cudaStream_t st) {
  switch (rows_per_warp(N)) {
    case 4:
      return launch_gemv<T, MM, 4>(x, q, scale, bias, out, out_f32, M, N, K,
                                   st);
    case 2:
      return launch_gemv<T, MM, 2>(x, q, scale, bias, out, out_f32, M, N, K,
                                   st);
    default:
      return launch_gemv<T, MM, 1>(x, q, scale, bias, out, out_f32, M, N, K,
                                   st);
  }
}

template <typename T>
int gemv(const T* x, const int8_t* q, const float* scale, const float* bias,
         void* out, int out_f32, int M, int N, int K, cudaStream_t st) {
  if (M == 1)
    return gemv_rows<T, 1>(x, q, scale, bias, out, out_f32, M, N, K, st);
  if (M <= 8)
    return gemv_rows<T, 8>(x, q, scale, bias, out, out_f32, M, N, K, st);
  return gemv_rows<T, 16>(x, q, scale, bias, out, out_f32, M, N, K, st);
}

template <int NT, typename OutT, typename XT>
int launch_decode_tc(const XT* x, const int8_t* q, const float* scale,
                     const float* bias, OutT* out, float* ws, int* counters,
                     int M, int N, int K, TcPlan plan, cudaStream_t st) {
  constexpr bool kX3 = std::is_same<XT, float>::value;
  constexpr int planes = kX3 ? 3 : 1;
  auto kernel = w8a16_decode_tc<NT, OutT, kX3>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTcXBytes + planes * 8 * NT * kTcXPad * 2);
  if (attr != cudaSuccess) return (int)attr;
  const int rows = 16 * kTcWarps / plan.w;
  const int groups = (N + rows - 1) / rows;
  const int smem = planes * 8 * NT * (K / plan.s + kTcXPad) * 2;
  kernel<<<groups * plan.s, kTcThreads, smem, st>>>(
      x, q, scale, bias, out, ws, counters, M, N, K, plan.w, plan.s);
  return (int)cudaGetLastError();
}

// x bf16 (out f32 or bf16) or f32 (its three planes; out f32)
template <typename OutT, typename XT>
int decode_tc(const XT* x, const int8_t* q, const float* scale,
              const float* bias, OutT* out, float* ws, int* counters, int M,
              int N, int K, TcPlan plan, cudaStream_t st) {
  return M <= 8 ? launch_decode_tc<1>(x, q, scale, bias, out, ws, counters,
                                      M, N, K, plan, st)
                : launch_decode_tc<2>(x, q, scale, bias, out, ws, counters,
                                      M, N, K, plan, st);
}

// the f32 prefill's pre-pass: x [M, K] f32 -> its planes [M, 3K] bf16 (row
// m: b0, b1, b2 of x's row m; K % 8 == 0), 8 floats a thread
__global__ void __launch_bounds__(256)
    w8a16_split_x3(const float* __restrict__ x,
                   __nv_bfloat16* __restrict__ xs, int M, int K) {
  const int kv = K / 8;
  const long long n = (long long)M * kv;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n;
       i += (long long)gridDim.x * 256) {
    const int m = (int)(i / kv), v = (int)(i - (long long)m * kv);
    const float4* src = reinterpret_cast<const float4*>(x + (size_t)m * K +
                                                        v * 8);
    uint4 p[3];
    split8_bf16x3(__ldg(src), __ldg(src + 1), p);
    uint4* dst = reinterpret_cast<uint4*>(xs + (size_t)m * 3 * K) + v;
    dst[0] = p[0];
    dst[kv] = p[1];
    dst[2 * kv] = p[2];
  }
}

// the kernel a call launches (w8a16_kernel in ops/kernels/int8_matmul.py),
// its K splits across blocks or units (1: none) and, for the decode body,
// the warps a 16-row tile
struct W8Plan {
  int kernel, splits, warps;
};
// The shapes the wgmma GEMM's f32-x kind takes: sm90_takes' and a ragged N
// of at least one tile (the vocab head). Mirrored by
// ops/kernels/int8_matmul.py x3_takes.
inline bool w8_x3_takes(int M, int N, int K) {
  return M >= 1 && N >= kSm90BN && K >= kSm90BK && K % kSm90BK == 0;
}

// f32 x: the decode body with x's three planes at 2 <= M <= 16 (M = 1 and
// K % 64 keep the GEMV), the wgmma GEMM over the planes at M > 16 where
// w8_x3_takes holds (the head included; other widths the FMA GEMM)
W8Plan w8_plan(int dtype, int M, int N, int K) {
  const bool f32 = dtype == kF32;
  if (M <= 16) {
    const TcPlan tc = tc_plan(M, N, K, num_sms(), f32 ? 3 : 1);
    return tc.w ? W8Plan{f32 ? kW8DecodeTcF32 : kW8DecodeTc, tc.s, tc.w}
                : W8Plan{kW8Gemv, 1, 0};
  }
  if (!(f32 ? w8_x3_takes(M, N, K) : sm90_takes(M, N, K)))
    return {f32 ? kW8F32 : kW8Mma, 1, 0};
  return {f32 ? kW8Sm90F32 : kW8Sm90, sm90_int8_splits(M, N, K, num_sms()),
          0};
}

inline bool w8_decode(int kernel) {
  return kernel == kW8DecodeTc || kernel == kW8DecodeTcF32;
}

// the workspace (f32) a call needs: the split-K partials, the decode body's
// tiles' accumulators (8 NT floats a lane) of every block or the wgmma
// GEMM's units' kSm90PartFloats; then, for the f32 prefill, x's three bf16
// planes (1.5 M K floats). A counter a row group or tile where K splits.
long long w8_part_floats(const W8Plan& p, int M, int N) {
  if (p.splits == 1) return 0;
  if (w8_decode(p.kernel)) {
    const int rows = 16 * kTcWarps / p.warps, nt = M <= 8 ? 1 : 2;
    return (long long)(N + rows - 1) / rows * p.splits * (kTcWarps / p.warps) *
           nt * 32 * 4;
  }
  return (long long)(M + 143) / 144 * ((N + kSm90BN - 1) / kSm90BN) *
         p.splits *
         kSm90PartFloats;
}
long long w8_ws_floats(const W8Plan& p, int M, int N, int K) {
  return w8_part_floats(p, M, N) +
         (p.kernel == kW8Sm90F32 ? (long long)M * K * 3 / 2 : 0);
}
int w8_counters(const W8Plan& p, int M, int N) {
  if (p.splits == 1) return 0;
  return w8_decode(p.kernel)
             ? (N + 16 * kTcWarps / p.warps - 1) / (16 * kTcWarps / p.warps)
             : (M + 143) / 144 * ((N + kSm90BN - 1) / kSm90BN);
}

// the f32 prefill: the pre-pass writes x's planes after the partials in
// ws, then the wgmma GEMM's f32-x kind reads them
int w8_sm90_f32(const float* x, const int8_t* q, const float* scale,
                const float* bias, float* out, int M, int N, int K,
                const W8Plan& p, float* ws, int* counters, cudaStream_t st) {
  __nv_bfloat16* planes =
      reinterpret_cast<__nv_bfloat16*>(ws + w8_part_floats(p, M, N));
  const long long items = (long long)M * K / 8;
  const int grid = (int)std::min<long long>((items + 255) / 256,
                                            8LL * num_sms());
  w8a16_split_x3<<<grid, 256, 0, st>>>(x, planes, M, K);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  ++w8_launch_counts[kW8SplitX3];
  return gemm_sm90_run<kSm90Int8X3>(planes, q,
                                    W8Epilogue<float>{scale, bias, out, N},
                                    M, N, K, st,
                                    Sm90Split{p.splits, ws, counters});
}

}  // namespace
}  // namespace ullsam

using namespace ullsam;

// x [M, K] (dtype kF32 / kBF16), q [N, K] int8, scale [N] f32, bias [N] f32
// or null -> out [M, N], f32 when out_f32 else x's type. All contiguous and
// 16-byte aligned; K % 16 == 0. ws: ws_floats f32 of workspace (split-K
// partials, f32 x's planes),
// counters: n_counters ints, zero (the kernels leave them zero), at least
// what w8a16_splits' plan needs (null and 0 when it splits nothing).
// Returns a cudaError_t code (0 = launched).
extern "C" int w8a16_matmul(int dtype, const void* x, const void* q,
                            const void* scale, const void* bias, void* out,
                            int out_f32, int M, int N, int K, void* ws,
                            long long ws_floats, void* counters,
                            int n_counters, cudaStream_t st) {
  if (M < 1 || N < 1 || K < 16 || K % 16 || (dtype != kF32 && dtype != kBF16))
    return (int)cudaErrorInvalidValue;
  const W8Plan plan = w8_plan(dtype, M, N, K);
  const int kernel = plan.kernel, splits = plan.splits;
  if (ws_floats < w8_ws_floats(plan, M, N, K) ||
      n_counters < w8_counters(plan, M, N))
    return (int)cudaErrorInvalidValue;
  const int8_t* qw = static_cast<const int8_t*>(q);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  float* wsf = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  int err;
  if (dtype == kF32) {
    const float* xf = static_cast<const float*>(x);
    float* of = static_cast<float*>(out);
    if (kernel == kW8Gemv) {
      err = gemv<float>(xf, qw, s, b, out, 1, M, N, K, st);
    } else if (kernel == kW8DecodeTcF32) {
      err = decode_tc(xf, qw, s, b, of, wsf, cnt, M, N, K,
                      TcPlan{plan.warps, splits}, st);
    } else if (kernel == kW8Sm90F32) {
      err = w8_sm90_f32(xf, qw, s, b, of, M, N, K, plan, wsf, cnt, st);
    } else {
      dim3 grid((N + kGemmBN - 1) / kGemmBN, (M + kGemmBM - 1) / kGemmBM);
      w8a16_gemm_f32<<<grid, 256, 0, st>>>(xf, qw, s, b, of, M, N, K);
      err = (int)cudaGetLastError();
    }
  } else {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    if (kernel == kW8Gemv) {
      err = gemv<__nv_bfloat16>(xb, qw, s, b, out, out_f32, M, N, K, st);
    } else if (kernel == kW8DecodeTc) {
      const TcPlan tc{plan.warps, splits};
      err = out_f32 ? decode_tc(xb, qw, s, b, static_cast<float*>(out), wsf,
                                cnt, M, N, K, tc, st)
                    : decode_tc(xb, qw, s, b,
                                static_cast<__nv_bfloat16*>(out), wsf, cnt,
                                M, N, K, tc, st);
    } else if (kernel == kW8Sm90) {
      const Sm90Split split{splits, wsf, cnt};
      err = out_f32
                ? gemm_sm90_run<kSm90Int8>(
                      xb, qw, W8Epilogue<float>{s, b, static_cast<float*>(out),
                                                N},
                      M, N, K, st, split)
                : gemm_sm90_run<kSm90Int8>(
                      xb, qw,
                      W8Epilogue<__nv_bfloat16>{
                          s, b, static_cast<__nv_bfloat16*>(out), N},
                      M, N, K, st, split);
    } else {
      dim3 grid((N + kMmaBN - 1) / kMmaBN, (M + kMmaBM - 1) / kMmaBM);
      if (out_f32)
        w8a16_gemm_mma<float><<<grid, 256, 0, st>>>(
            xb, qw, s, b, static_cast<float*>(out), M, N, K);
      else
        w8a16_gemm_mma<__nv_bfloat16><<<grid, 256, 0, st>>>(
            xb, qw, s, b, static_cast<__nv_bfloat16*>(out), M, N, K);
      err = (int)cudaGetLastError();
    }
  }
  if (!err) ++w8_launch_counts[kernel];
  return err;
}

// The plan of a call on this card: the kernel (W8Kernel) in the low byte,
// its splits in the next, the decode body's warps a tile above them
// (warps << 16 | splits << 8 | kernel); -1 for a shape the entry refuses.
// Mirrored by ops/kernels/int8_matmul.py w8a16_kernel, splits and
// decode_plan.
extern "C" int w8a16_splits(int dtype, int M, int N, int K) {
  if (M < 1 || N < 1 || K < 16 || K % 16 || (dtype != kF32 && dtype != kBF16))
    return -1;
  const W8Plan p = w8_plan(dtype, M, N, K);
  return p.warps << 16 | p.splits << 8 | p.kernel;
}

// The workspace (f32: split-K partials, f32 x's planes) and tile counters a
// call of this shape needs on this card (0 for a call that splits nothing
// across blocks and has no planes; -1 for a shape the entry refuses): what
// ops/kernels/int8_matmul.py workspace mirrors and allocates.
extern "C" long long w8a16_workspace(int dtype, int M, int N, int K,
                                     int counters) {
  if (M < 1 || N < 1 || K < 16 || K % 16 || (dtype != kF32 && dtype != kBF16))
    return -1;
  const W8Plan p = w8_plan(dtype, M, N, K);
  return counters ? w8_counters(p, M, N) : w8_ws_floats(p, M, N, K);
}

// launches of B12 kernel `kernel` made by this library so far: 0 the
// decode GEMV, 1 the wgmma GEMM, 2 the mma.sync GEMM, 3 the f32 FMA GEMM, 4
// the decode body on the tensor cores, 5 the wgmma GEMM at f32 x, 6 the
// decode body at f32 x, 7 the f32 prefill's pre-pass (w8a16_split_x3, one
// before each launch of 5)
extern "C" long long w8a16_launch_count(int kernel) {
  return kernel >= 0 && kernel < kW8Kernels ? w8_launch_counts[kernel] : -1;
}
