// The work-unit framework of the mask decoder's two Hopper (sm_90a) kernels:
// B5's image stages (decoder_image.cu) and B6 / B7's upscale
// (decoder_upscale.cu), in bf16 at SAM's decoder widths (C = 256, Cd = 128,
// 8 heads of 16).
//
// A unit is (prompt b, 128 image rows n0 .. n0 + 127 of it). A persistent
// block walks units u = blockIdx.x, + gridDim.x, ..., unit u being rows
// tile = u / B of prompt b = u % B: the units in flight at once are one
// tile of many prompts, so the rows every prompt shares (the image side's
// [N, .] tensors) and the weights stay in L2. Each unit's intermediates
// stay in shared memory and registers; only what a later step reads is
// written to device memory.
//
// A block is two consumer warpgroups and a producer warpgroup (384
// threads), one block an SM (223,824 bytes of shared memory).
// Consumer warpgroup wg owns rows 64 wg .. 64 wg + 63 of the unit: its
// products are wgmma m64nNk16 (N = 256 or 128) with f32 accumulators in
// registers (128 a thread at N = 256), its epilogues (bias, residual,
// rounding, LayerNorm, GELU, attention over the prompt's <= 16 tokens) run
// in registers in the accumulator layout, where the 256 columns of a row
// sit in one quad (two shuffles a row sum). The producer warpgroup's one
// thread (the others give their registers to the consumers: setmaxnreg)
// streams, by TMA,
//   * each unit's input rows into the warpgroup's half of the X tile
//     (xfull / xempty a warpgroup), and
//   * the weights, k-block by k-block ([N rows][64] bf16, 32 KB at N = 256),
//     and the unit's shared residual rows ([128][128] a slot) through a ring
//     of kUnitStages slots (full / empty a slot, released by both
//     warpgroups), in the order the consumers take them. The weights do not
//     fit beside the tiles (B5's stage 2 multiplies 256 KB of them), so each
//     unit reads them again from L2.
// A unit's outputs leave the X tile by TMA stores (bulk groups, waited for
// before X is rewritten). The prompt's few token rows (T <= 16) are copied
// into shared memory by the consumers.
// Tiles in shared memory are k-blocks of [128 rows][64] bf16 in the
// 128-byte swizzle, as TMA writes them and wgmma reads them (swz).
#pragma once

#include <math_constants.h>

#include "gemm_sm90.cuh"

namespace ullsam {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kUnitRows = 128;     // image rows (pixels) a unit
constexpr int kUnitThreads = 384;  // two consumer warpgroups + a producer
constexpr int kUnitStages = 3;     // weight ring slots
constexpr int kUnitC = 256;        // C: the image rows' width
constexpr int kUnitCd = 128;       // Cd: the cross attentions' width
constexpr int kUnitHeads = 8, kUnitHD = 16, kUnitMaxTok = 16;
constexpr int kUnitKB = kUnitRows * 64;  // elements of a tile's k-block
constexpr int kUnitXBytes = kUnitRows * kUnitC * 2;   // X: [128][256]
constexpr int kUnitQBytes = kUnitRows * kUnitCd * 2;  // Q: [128][128]
constexpr int kUnitSlotBytes = kUnitC * 64 * 2;       // [256][64] weights
// a warpgroup's copy of its prompt's token rows: three [16][128] bf16,
// rows padded to 136 (ldmatrix of 8 rows without bank conflicts)
constexpr int kPromptLd = kUnitCd + 8;
constexpr int kUnitPromptBytes = 3 * kUnitMaxTok * kPromptLd * 2;
constexpr int kUnitBarriers = 2 * kUnitStages + 4;
// Must match ops/kernels/decoder.py sm90_smem_bytes
constexpr int kUnitSmemBytes = 1024 + kUnitXBytes + kUnitQBytes +
                               kUnitStages * kUnitSlotBytes +
                               2 * kUnitPromptBytes + kUnitBarriers * 8;

// element offset of (row, col) in a tile of k-blocks [128][64] bf16, 128-byte
// swizzle: 16-byte chunk c of row r at c ^ (r & 7)
__device__ __forceinline__ int swz(int row, int col) {
  return (col >> 6) * kUnitKB + row * 64 +
         ((((col >> 3) & 7) ^ (row & 7)) << 3) + (col & 7);
}

// TMA store of the box at (c0, c1, c2) of a 3-D map from shared memory,
// in the bulk group of the issuing thread
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the thread's bulk stores have finished reading shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

struct UnitSmem {
  bf16* x;     // X [128][256]: a unit's input rows, then its stage outputs
  bf16* q;     // Q [128][128]: B5 stage 2's image queries / i2t output;
               // the upscale's logit staging
  unsigned char* ring;
  bf16* prompt;  // [2 warpgroups][3][16][136]: a unit's prompt's tokens
  uint64_t *full, *empty, *xfull, *xempty;
  __device__ __forceinline__ explicit UnitSmem(unsigned char* raw) {
    unsigned char* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
    x = reinterpret_cast<bf16*>(base);
    q = reinterpret_cast<bf16*>(base + kUnitXBytes);
    ring = base + kUnitXBytes + kUnitQBytes;
    prompt = reinterpret_cast<bf16*>(ring + kUnitStages * kUnitSlotBytes);
    full = reinterpret_cast<uint64_t*>(ring + kUnitStages * kUnitSlotBytes +
                                       2 * kUnitPromptBytes);
    empty = full + kUnitStages;
    xfull = empty + kUnitStages;
    xempty = xfull + 2;
  }
  __device__ __forceinline__ bf16* slot(int s) const {
    return reinterpret_cast<bf16*>(ring + s * kUnitSlotBytes);
  }
  // thread 0, before the block's first __syncthreads
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < kUnitStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // each consumer warpgroup releases it
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(&xfull[w], 1);
      mbar_init(&xempty[w], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// The producer thread's side: weights into the ring in consumption order,
// a unit's input rows into a warpgroup's half of a tile
struct UnitProducer {
  const UnitSmem& sm;
  int kg;  // k-blocks issued: k-block kg sits in slot kg % kUnitStages
  __device__ __forceinline__ explicit UnitProducer(const UnitSmem& s)
      : sm(s), kg(0) {}
  // k-block kb ([rows][64] at columns 64 kb) of a weight [rows, K]
  __device__ __forceinline__ void weights(const CUtensorMap* map, int kb,
                                          int rows) {
    const int s = kg % kUnitStages, ph = (kg / kUnitStages) & 1;
    ++kg;
    mbar_wait(&sm.empty[s], ph ^ 1);
    mbar_expect_tx(&sm.full[s], rows * 128);
    tma_load_2d(sm.slot(s), map, &sm.full[s], kb * 64, 0);
  }
  // a unit's residual rows r0 .. r0 + 127, columns c0 .. c0 + 127, of map
  // (boxes [128 rows][64]) into the next ring slot as a [128][128] tile
  __device__ __forceinline__ void residual(const CUtensorMap* map, int c0,
                                           int r0) {
    const int s = kg % kUnitStages, ph = (kg / kUnitStages) & 1;
    ++kg;
    mbar_wait(&sm.empty[s], ph ^ 1);
    mbar_expect_tx(&sm.full[s], kUnitRows * 128 * 2);
    tma_load_2d(sm.slot(s), map, &sm.full[s], c0, r0);
    tma_load_2d(sm.slot(s) + kUnitKB, map, &sm.full[s], c0 + 64, r0);
  }
  // nkb k-blocks of rows r0 .. r0 + 63 of map (boxes [64 rows][64]) into
  // warpgroup w's rows of tile, once the warpgroup has released its
  // previous unit (its local unit k)
  __device__ __forceinline__ void rows(bf16* tile, const CUtensorMap* map,
                                       int nkb, int r0, int w, int k) {
    mbar_wait(&sm.xempty[w], (k & 1) ^ 1);
    mbar_expect_tx(&sm.xfull[w], nkb * 64 * 128);
    for (int kb = 0; kb < nkb; ++kb)
      tma_load_2d(tile + kb * kUnitKB + w * 64 * 64, map, &sm.xfull[w],
                  kb * 64, r0);
  }
};

template <int NI>
__device__ __forceinline__ void acc_init_tile(float* v, const bf16* tile,
                                              int row0, int row1, int tq);

// A consumer warpgroup's side
struct UnitConsumer {
  const UnitSmem& sm;
  int wg, t, warp, g, tq, kg;
  bool lead;
  __device__ __forceinline__ UnitConsumer(const UnitSmem& s, int tid)
      : sm(s), wg(tid >> 7), t(tid & 127), warp((tid & 127) >> 5),
        g((tid & 31) >> 2), tq(tid & 3), kg(0), lead((tid & 127) == 0) {}
  // this thread's two accumulator rows within the unit (c < 2, c >= 2)
  __device__ __forceinline__ int row(int hf) const {
    return wg * 64 + warp * 16 + g + 8 * hf;
  }
  __device__ __forceinline__ void sync() const { named_bar_sync(1 + wg, 128); }
  // generic-proxy writes to a tile, then read by wgmma
  __device__ __forceinline__ void publish() const {
    fence_proxy_async();
    sync();
  }
  __device__ __forceinline__ void wait_rows(int k) const {
    mbar_wait(&sm.xfull[wg], k & 1);
  }
  __device__ __forceinline__ void release_rows() const {
    if (lead) bulk_wait_read();  // the X tile's stores have read it
    sync();
    if (lead) mbar_arrive(&sm.xempty[wg]);
  }
  // the warpgroup's rows of X (just written, 256 columns) to rows n0 + 64
  // wg .. of prompt b of a [B, N, 256] map (TMA clips rows past N), by
  // the lead thread; X is rewritten only after store_wait
  __device__ __forceinline__ void store_rows(const CUtensorMap* map, int b,
                                             int n0) const {
    publish();
    if (lead) {
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
        tma_store_3d(map, sm.x + kb * kUnitKB + wg * 64 * 64, kb * 64,
                     n0 + 64 * wg, b);
      bulk_commit();
    }
  }
  __device__ __forceinline__ void store_wait() const {
    if (lead) bulk_wait_read();
    sync();
  }
  // slot i (0..2) of the warpgroup's prompt rows [16][kPromptLd]
  __device__ __forceinline__ bf16* prompt(int i) const {
    return sm.prompt + (wg * 3 + i) * kUnitMaxTok * kPromptLd;
  }
  // prompt rows src [T][128] into slot i, zero past T (16-byte loads; the
  // caller syncs before reading them)
  __device__ __forceinline__ void load_prompt(int i, const bf16* src,
                                              int T) const {
    uint4* d = reinterpret_cast<uint4*>(prompt(i));
    const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int e = t; e < kUnitMaxTok * kUnitCd / 8; e += 128)
      d[(e >> 4) * (kPromptLd / 8) + (e & 15)] =
          e < T * kUnitCd / 8 ? __ldg(s + e) : make_uint4(0, 0, 0, 0);
  }

  // acc = a residual of NI * 8 columns of the warpgroup's rows, from the
  // next NI / 16 ring slots (each [128 rows][128] as UnitProducer::residual
  // lands it), released once the warpgroup has read them
  template <int NI>
  __device__ __forceinline__ void residual(float* acc) {
#pragma unroll
    for (int part = 0; part < NI / 16; ++part) {
      const int s = kg % kUnitStages, ph = (kg / kUnitStages) & 1;
      ++kg;
      mbar_wait(&sm.full[s], ph);
      acc_init_tile<16>(acc + 64 * part, sm.slot(s), row(0), row(1), tq);
      sync();
      if (lead) mbar_arrive(&sm.empty[s]);
    }
  }

  // acc (+)= A . W^T: A the warpgroup's 64 rows of `tile` over nkb k-blocks
  // (K = 64 nkb), W nkb k-blocks [N][64] from the ring; with add the sum
  // starts from acc (its bias and residual, loaded before the product, so
  // that their loads overlap nothing else's wait). Each slot is released
  // once the wgmma group that read it has completed.
  template <int N>
  __device__ __forceinline__ void gemm(float* acc, const bf16* tile, int nkb,
                                       bool add) {
    int prev = -1;
    for (int kb = 0; kb < nkb; ++kb) {
      const int s = kg % kUnitStages, ph = (kg / kUnitStages) & 1;
      ++kg;
      mbar_wait(&sm.full[s], ph);
      const bf16* a = tile + kb * kUnitKB + wg * 64 * 64;
      const bf16* w = sm.slot(s);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (N == 256)
          wgmma_m64n256k16(acc, sw128_desc(a + k * 16), sw128_desc(w + k * 16),
                           add || kb > 0 || k > 0);
        else
          wgmma_m64n128k16(acc, sw128_desc(a + k * 16), sw128_desc(w + k * 16),
                           add || kb > 0 || k > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0 && lead) mbar_arrive(&sm.empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    if (lead) mbar_arrive(&sm.empty[prev]);
    sync();  // every warp's share of the group is done before A is rewritten
  }
};

// ---- epilogues on accumulators: d[4i + c] is row row(c >> 1), column
// 8i + 2tq + (c & 1); NI = N / 8 ------------------------------------------

template <int NI>
__device__ __forceinline__ void acc_add_bias(float* v, const bf16* bias,
                                             int tq) {
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(bias + 8 * i + 2 * tq));
    v[4 * i] += b.x;
    v[4 * i + 1] += b.y;
    v[4 * i + 2] += b.x;
    v[4 * i + 3] += b.y;
  }
}

// acc = the same positions of a tile (a residual kept on chip)
template <int NI>
__device__ __forceinline__ void acc_init_tile(float* v, const bf16* tile,
                                              int row0, int row1, int tq) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              tile + swz(h ? row1 : row0, 8 * i + 2 * tq)));
      v[4 * i + 2 * h] = f.x;
      v[4 * i + 2 * h + 1] = f.y;
    }
}

// x and y rounded to bf16 (round to nearest even): one conversion of the
// pair (cvt.rn.bf16x2.f32) and two widenings
__device__ __forceinline__ void round2_bf16(float& x, float& y) {
  const float2 f = __bfloat1622float2(__floats2bfloat162_rn(x, y));
  x = f.x;
  y = f.y;
}

template <int NI>
__device__ __forceinline__ void acc_round(float* v) {
#pragma unroll
  for (int i = 0; i < 2 * NI; ++i) round2_bf16(v[2 * i], v[2 * i + 1]);
}

// v into a tile, rounded to bf16
template <int NI>
__device__ __forceinline__ void acc_store_tile(bf16* tile, const float* v,
                                               int row0, int row1, int tq) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < NI; ++i)
      *reinterpret_cast<uint32_t*>(tile +
                                   swz(h ? row1 : row0, 8 * i + 2 * tq)) =
          pack_bf16(v[4 * i + 2 * h], v[4 * i + 2 * h + 1]);
}

// d (+)= a . b: mma.sync m16n8k16, bf16 in, f32 sums (not volatile, so
// that the compiler may interleave independent products)
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// sum over a row's quad (its four lanes hold all its columns)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// LayerNorm of the two rows of a 256-wide accumulator (values already
// rounded), one-pass f32 statistics as decoder_ln (each in four partial
// sums, short dependency chains), w / b [256]; the store rounds it
__device__ __forceinline__ void acc_layer_norm(float* v, const bf16* w,
                                               const bf16* b, float eps,
                                               int tq) {
  constexpr int NI = kUnitC / 8;
  float s[2][4] = {}, s2[2][4] = {};
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[c >> 1][i & 3] += v[4 * i + c];
      s2[c >> 1][i & 3] = fmaf(v[4 * i + c], v[4 * i + c], s2[c >> 1][i & 3]);
    }
  float m1[2], rstd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m1[h] = quad_sum((s[h][0] + s[h][1]) + (s[h][2] + s[h][3])) / kUnitC;
    rstd[h] = rsqrtf(
        fmaxf(quad_sum((s2[h][0] + s2[h][1]) + (s2[h][2] + s2[h][3])) /
                      kUnitC -
                  m1[h] * m1[h],
              0.f) +
        eps);
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const float2 wf = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(w + 8 * i + 2 * tq));
    const float2 bf = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(b + 8 * i + 2 * tq));
#pragma unroll
    for (int c = 0; c < 4; ++c)
      v[4 * i + c] = (v[4 * i + c] - m1[c >> 1]) * rstd[c >> 1] *
                         ((c & 1) ? wf.y : wf.x) +
                     ((c & 1) ? bf.y : bf.x);
  }
}

}  // namespace
}  // namespace ullsam
