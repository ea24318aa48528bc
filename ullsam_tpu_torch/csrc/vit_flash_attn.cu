// B2: ViT global flash attention with the factored decomposed rel-pos bias,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel ullsam_tpu/ops/pallas/flash_attention.py
// `_vit_kernel` (via `vit_flash_attention` / `_vit_flash_impl`):
//     o   = softmax(qs k^T + bias) v,   qs = cast(q * D^-1/2)
//     lse = logsumexp of each row (f32, read by B9, the backward)
// with bias[i, key] = rel_h[i, key / KW] + rel_w[i, key % KW]; the N x N
// bias never exists in memory.
//
// What bounds it on this card: operations. At the SAM ViT-B global blocks
// (BH = 12, N = 4096, D = 64) one call is 2*2*N^2*D*BH = 51.5 GFLOP against
// ~38 MB of bytes; under that, the exponentials (BH N^2 = 201 M, 16 a clock
// an SM) and the bias, one add a logit at best. float32 stays true f32 FMA
// (vit_flash_f32, no TF32), bounded by the 67 TFLOP/s f32 rate.
//
// bf16 design (vit_flash_sm90, the usual Hopper attention shape):
//   * A block is 128 queries of one (b, h): two consumer warpgroups of 64
//     rows and one producer warp. The producer's single thread issues TMA
//     loads: each warpgroup's q rows once, then 64-key tiles of k and v into
//     a ring of kFlashStages stages with `full` / `empty` mbarriers (both
//     warpgroups release a stage). q, k and v are read in place through
//     cuTensorMapEncodeTiled maps, so one body serves B2's [BH, N, D] and
//     B14's [B, N, 3C] (below).
//   * Per key tile, S = qs k^T on wgmma m64n64k16 from shared-memory
//     descriptors (both K-major), the online softmax in f32 registers (the
//     accumulator layout: a thread holds rows g and g + 8 of its warp's 16,
//     16 keys each), p rounded to bf16 into wgmma's register A operand, and
//     o += p v on wgmma m64n64k16 with v read MN-major (trans-b). A tile's
//     p.v and the next tile's S are issued together and waited on together,
//     so the tensor cores run both back to back while the other warpgroup
//     runs its softmax.
//   * The bias out of the logit loop: when KW divides the 64-key tile and
//     is at least 8 (SAM's grids: KW = 64 at ViT-B, L and H), a tile covers
//     64 / KW whole key rows and each 8-key accumulator column block lies in
//     one of them. rel_w[i, key % KW] is then the same fragment in every
//     tile, held in 32 registers in the accumulator layout for the whole
//     loop, and rel_h[i, key / KW] is 64 / KW values a row a tile, read from
//     shared memory once a tile: the bias is one add a logit. The previous
//     kernel found each key's grid row by a division and read both factors
//     from shared memory per logit (about 25 instructions, the cost PR 8
//     measured in the window core). Other KW (any KW <= 64 with N % 64 ==
//     0) keep that per-logit path in the same kernel (kRowsPerTile = 0).
//   * q is pre-scaled in place once it lands (elementwise, so the swizzle
//     does not matter) and fenced for the async proxy before the first
//     product.
//   * Head dim 80: rows of 160 bytes exceed the 128-byte swizzle span of one
//     TMA box, so every tile is split: columns 0-63 in a 128-byte-swizzled
//     box, 64-79 in a 32-byte-swizzled box of 16. S takes four 16-deep steps
//     from the first and one from the second; p.v is an n = 64 product on
//     the first and an n = 16 product on the second.
//   * Rounding points match _vit_flash_impl: q is pre-scaled and cast to
//     q's dtype; rel factors arrive at q's dtype and are summed in f32; p
//     (unnormalized, f32) is cast to v's dtype before p.v; the output is acc
//     / l cast to q's dtype once; lse = m + log l in f32.
//
// Head dims 64 (SAM ViT-B / L) and 80 (ViT-H: 16 heads of 80, BH = 16,
// 80.5 GFLOP a call) are instantiated. Both bodies address q, k, v and o
// through a batch and a head stride per bh = b * nh + h and a row stride,
// so one body serves two layouts:
//   * B2, vit_flash_attn_forward: q, k, v, o [BH, N, D], contiguous;
//   * B14, vit_flash_attn_packed_forward, which replaces
//     flash_attention.py `_vit_kernel_packed` (opt-in by
//     ULLSAM_PACKED_GLOBAL=1): head h of image b read straight from the qkv
//     projection [B, N, 3C] at columns h D, C + h D, 2C + h D (row stride
//     3C), and o written into [B, N, C] at column h D, the layout proj
//     consumes: no head-split copy before, no merge transpose after. The TPU
//     kernel pads every head to 128 lanes for that; here the natural layout
//     needs no pad. Same function and rounding points as B2.
#include "attn_fma.cuh"
#include "flash_sm90.cuh"

namespace ullsam {
namespace {

constexpr int kBQ = 64, kBK = 64, kMaxRel = 64;

// Where head bh = b * nh + h of q, k, v and o lies: element (row, d) of q at
// q[b * sb + h * sh + row * ld + d] (k, v alike), of o at
// o[b * sob + h * soh + row * ldo + d].
// A head's rows are addressed in 32 bits from its own base pointer (N * ld
// stays below 2^31), the base in 64.
struct HeadStrides {
  int nh;
  long long sb, sh;
  int ld;
  long long sob, soh;
  int ldo;
  __device__ __forceinline__ size_t in(int bh) const {
    return (size_t)((bh / nh) * sb + (bh % nh) * sh);
  }
  __device__ __forceinline__ size_t out(int bh) const {
    return (size_t)((bh / nh) * sob + (bh % nh) * soh);
  }
};

template <int D>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (AttnBlockF32<D>::kSmemFloats + 2 * kBQ * kMaxRel);
}

// grid (N / 64, BH), 256 threads; q, k, v, o per HeadStrides;
// rel_h [BH, N, KH], rel_w [BH, N, KW]; lse [BH, N]
template <int D>
__global__ void __launch_bounds__(256)
    vit_flash_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ rel_h,
                  const float* __restrict__ rel_w, float* __restrict__ o,
                  float* __restrict__ lse, int N, int KH, int KW,
                  float scale, HeadStrides hs) {
  using FmaBlock = AttnBlockF32<D>;
  constexpr int kLdT = FmaBlock::kLdT, kLdV = FmaBlock::kLdV;
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;                          // [D][kLdT]  (d-major)
  float* Kt = Qt + D * kLdT;               // [D][kLdT]  (d-major)
  float* Vs = Kt + D * kLdT;               // [kBK][kLdV]
  float* Ps = Vs + kBK * kLdV;             // [kBQ][kLdP]
  float* RH = Ps + kBQ * FmaBlock::kLdP;   // [kBQ][kMaxRel]
  float* RW = RH + kBQ * kMaxRel;          // [kBQ][kMaxRel]

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ;
  const float* qh = q + hs.in(bh);
  const float* kh = k + hs.in(bh);
  const float* vh = v + hs.in(bh);
  const int ld = hs.ld;

  for (int e = tid; e < kBQ * D; e += 256) {
    const int r = e / D, d = e % D;
    Qt[d * kLdT + r] = qh[(q0 + r) * ld + d] * scale;
  }
  for (int e = tid; e < kBQ * KH; e += 256) {
    const int r = e / KH, c = e % KH;
    RH[r * kMaxRel + c] = rel_h[((size_t)bh * N + q0 + r) * KH + c];
  }
  for (int e = tid; e < kBQ * KW; e += 256) {
    const int r = e / KW, c = e % KW;
    RW[r * kMaxRel + c] = rel_w[((size_t)bh * N + q0 + r) * KW + c];
  }

  FmaBlock fb;
  fb.begin(tid);
  const float inv_kw = 1.f / KW;
  const auto bias = [&](int r, int key) {
    const int kr = div_small(key, inv_kw);
    return RH[r * kMaxRel + kr] + RW[r * kMaxRel + key - kr * KW];
  };
  for (int k0 = 0; k0 < N; k0 += kBK) {
    __syncthreads();  // previous tile's Kt / Vs / Ps are free
    for (int e = tid; e < kBK * D; e += 256) {
      const int j = e / D, d = e % D;
      const int g = (k0 + j) * ld + d;
      Kt[d * kLdT + j] = kh[g];
      Vs[j * kLdV + d] = vh[g];
    }
    __syncthreads();
    // q was pre-scaled (the reference's rounding point): logits scale 1
    fb.tile(Qt, Kt, Vs, Ps, k0, 1.0f, bias);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + fb.ty * 4 + i;
    const float inv = 1.f / fb.l[i];
#pragma unroll
    for (int c = 0; c < FmaBlock::kCols; ++c)
      o[hs.out(bh) + r * hs.ldo + fb.col0() + c] = fb.acc[i][c] * inv;
    if (fb.tx == 0) lse[(size_t)bh * N + r] = fb.m[i] + logf(fb.l[i]);
  }
}

// ---- bf16: wgmma + TMA (see the note at the top) -------------------------

constexpr int kFlashRows = 128;  // queries a block: two warpgroups of 64
constexpr int kFlashStages = 4;
constexpr int kFlashThreads = 288;   // two consumer warpgroups + one warp
constexpr int kRelLd = kMaxRel + 8;  // bf16 rel rows in shared memory
constexpr float kFlashLog2e = 1.4426950408889634f;

// The block's shared memory; must match ops/kernels/flash_attention.py
// sm90_smem_bytes. Tiles of 64 rows: columns 0-63 of a row in 128 swizzled
// bytes ("a"), at D = 80 columns 64-79 in 32 swizzled bytes ("b"); every
// tile 1024-byte aligned. q [128 rows] a then b; the stages, each k a,
// v a, k b, v b; rel_h and rel_w rows [128][kRelLd] bf16; the mbarriers
// (full and empty a stage, one for each warpgroup's q).
template <int D>
struct FlashSm90Layout {
  static constexpr int kTail = FlashTiles<D>::kTail;
  static constexpr int kTileA = FlashTiles<D>::kTileA;
  static constexpr int kTileB = FlashTiles<D>::kTileB;
  static constexpr int kQBytes = kFlashRows * 128 + kFlashRows * kTail * 2;
  static constexpr int kStageBytes = 2 * (kTileA + kTileB);
  static constexpr int kRelBytes = kFlashRows * kRelLd * 2;
  static constexpr int kSmemBytes = 1024 + kQBytes +
                                    kFlashStages * kStageBytes +
                                    2 * kRelBytes +
                                    (2 * kFlashStages + 2) * 8;
  static_assert(kStageBytes % 1024 == 0 && kQBytes % 1024 == 0, "aligned");
};

// the TMA maps of q, k and v: [0] columns 0-63 (128-byte swizzle), [1] at
// D = 80 columns 64-79 (32-byte swizzle); boxes of 64 rows
struct FlashMaps {
  CUtensorMap q[2], k[2], v[2];
};

// kRowsPerTile = 64 / KW when KW divides 64 and KW >= 8 (the bias from
// registers), 0 for any other KW (the bias per logit from shared memory).
// grid (ceil(N / 128), BH), kFlashThreads threads; rel_h [BH, N, KH],
// rel_w [BH, N, KW], lse [BH, N]; q, k, v through `maps` at row
// (bh / nh) N + key and column (bh % nh) hs.sh, o per HeadStrides.
template <int D, int kRowsPerTile>
__global__ void __launch_bounds__(kFlashThreads, 1)
    vit_flash_sm90(const __grid_constant__ FlashMaps maps,
                   const __nv_bfloat16* __restrict__ rel_h,
                   const __nv_bfloat16* __restrict__ rel_w,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int N, int KH, int KW, float scale, HeadStrides hs) {
  using bf16 = __nv_bfloat16;
  using L = FlashSm90Layout<D>;
  constexpr int kTail = L::kTail;
  extern __shared__ unsigned char smraw[];
  unsigned char* base = smraw + ((1024 - (smem_u32(smraw) & 1023)) & 1023);
  unsigned char* qa = base;                       // [128][64] swizzled
  unsigned char* qb = base + kFlashRows * 128;    // [128][16] (D = 80)
  unsigned char* stages = base + L::kQBytes;
  bf16* RH = reinterpret_cast<bf16*>(stages + kFlashStages * L::kStageBytes);
  bf16* RW = RH + kFlashRows * kRelLd;
  uint64_t* full = reinterpret_cast<uint64_t*>(RW + kFlashRows * kRelLd);
  uint64_t* empty = full + kFlashStages;
  uint64_t* qbar = empty + kFlashStages;
  const auto ka = [&](int s) { return stages + s * L::kStageBytes; };
  const auto va = [&](int s) { return ka(s) + L::kTileA; };
  const auto kb = [&](int s) { return ka(s) + 2 * L::kTileA; };
  const auto vb = [&](int s) { return kb(s) + L::kTileB; };

  const int tid = threadIdx.x, wg = tid / 128;
  const int bh = blockIdx.y, q0 = blockIdx.x * kFlashRows;
  const int nwg = q0 + kBQ < N ? 2 : 1;  // N % 64 == 0
  const int NT = N / kBK;
  const int row0 = (bh / hs.nh) * N;  // the head's first row in the maps
  const int col = (int)((bh % hs.nh) * hs.sh);
  if (tid == 0) {
    for (int s = 0; s < kFlashStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], nwg);  // released by every warpgroup
    }
    mbar_init(&qbar[0], 1);
    mbar_init(&qbar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp
    if (tid == 256) {
      for (int w = 0; w < nwg; ++w) {
        mbar_expect_tx(&qbar[w], kBQ * D * 2);
        tma_load_2d(qa + w * kBQ * 128, &maps.q[0], &qbar[w], col,
                    row0 + q0 + w * kBQ);
        if constexpr (kTail > 0)
          tma_load_2d(qb + w * kBQ * kTail * 2, &maps.q[1], &qbar[w],
                      col + 64, row0 + q0 + w * kBQ);
      }
      int s = 0, ph = 0;
      for (int kt = 0; kt < NT; ++kt) {
        const int r = row0 + kt * kBK;
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], L::kStageBytes);
        tma_load_2d(ka(s), &maps.k[0], &full[s], col, r);
        tma_load_2d(va(s), &maps.v[0], &full[s], col, r);
        if constexpr (kTail > 0) {
          tma_load_2d(kb(s), &maps.k[1], &full[s], col + 64, r);
          tma_load_2d(vb(s), &maps.v[1], &full[s], col + 64, r);
        }
        if (++s == kFlashStages) s = 0, ph ^= 1;
      }
    }
    return;
  }
  if (wg >= nwg) return;  // a last block of 64 queries

  // consumer warpgroup wg: queries q0 + 64 wg .. + 63; warp wr of it rows
  // 16 wr .. 16 wr + 15, a thread rows g and g + 8 of those
  const int t128 = tid & 127, lane = tid & 31, wr = t128 >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qr0 = q0 + wg * kBQ;
  for (int e = t128; e < kBQ * KH; e += 128) {
    const int r = e / KH, c = e - r * KH;
    RH[(wg * kBQ + r) * kRelLd + c] = rel_h[((size_t)bh * N + qr0 + r) * KH + c];
  }
  for (int e = t128; e < kBQ * KW; e += 128) {
    const int r = e / KW, c = e - r * KW;
    RW[(wg * kBQ + r) * kRelLd + c] = rel_w[((size_t)bh * N + qr0 + r) * KW + c];
  }
  // q pre-scaled in place, 16 bytes at a time (the swizzle moves whole
  // 16-byte chunks, so an elementwise pass need not know it)
  mbar_wait(&qbar[wg], 0);
  {
    uint4* qw = reinterpret_cast<uint4*>(qa + wg * kBQ * 128);
    constexpr int kChunks = kBQ * 128 / 16 + kBQ * kTail * 2 / 16;
#pragma unroll
    for (int i = 0; i < kChunks / 128; ++i) {
      const int c = t128 + 128 * i;
      uint4* p = c < kBQ * 8 ? qw + c
                             : reinterpret_cast<uint4*>(
                                   qb + wg * kBQ * kTail * 2) +
                                   (c - kBQ * 8);
      uint4 x = *p;
      uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f =
            __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[e]));
        w[e] = pack_bf16(f.x * scale, f.y * scale);
      }
      *p = x;
    }
  }
  fence_proxy_async();
  named_bar_sync(1 + wg, 128);  // q and the rel rows written

  const int la = wg * kBQ + wr * 16 + g;  // this thread's rows in the block
  const bf16* rh_row[2] = {RH + la * kRelLd, RH + (la + 8) * kRelLd};
  const bf16* rw_row[2] = {RW + la * kRelLd, RW + (la + 8) * kRelLd};
  // rel_w in the accumulator layout (key 8i + 2t + (c & 1) of row c >> 1),
  // times log2 e, for the whole loop
  float rwl[kRowsPerTile > 0 ? 32 : 1];
  if constexpr (kRowsPerTile > 0) {
    constexpr int kKW = kBK / kRowsPerTile;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        rwl[4 * i + c] =
            __bfloat162float(rw_row[c >> 1][(8 * i + 2 * t + (c & 1)) % kKW]) *
            kFlashLog2e;
  }
  const float inv_kw = 1.f / KW;

  const unsigned char* qaw = qa + wg * kBQ * 128;
  const unsigned char* qbw = qb + wg * kBQ * kTail * 2;
  float sacc[32], oa[32], ob[kTail > 0 ? 8 : 1];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = oa[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kTail > 0 ? 8 : 1); ++i) ob[i] = 0.f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};

  // S = qs k^T of the tile in stage s into sacc (async; not committed)
  const auto issue_s = [&](int s) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_m64n64k16_ss(sacc, sw128_desc(qaw + 32 * k),
                         sw128_desc(ka(s) + 32 * k), k > 0);
    if constexpr (kTail > 0)
      wgmma_m64n64k16_ss(sacc, sw32_desc(qbw), sw32_desc(kb(s)), 1);
  };

  mbar_wait(&full[0], 0);
  wgmma_fence();
  issue_s(0);
  wgmma_commit();
  for (int kt = 0; kt < NT; ++kt) {
    const int s = kt % kFlashStages;
    wgmma_wait<0>();  // S of tile kt, and p.v of tile kt - 1
    if (kt > 0 && t128 == 0)
      mbar_arrive(&empty[(kt - 1) % kFlashStages]);

    // logits in base 2 with the bias, and the tile's row maxima
    float mx[2] = {m[0], m[1]};
    if constexpr (kRowsPerTile > 0) {
      float rhl[2][kRowsPerTile];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int r = 0; r < kRowsPerTile; ++r)
          rhl[hf][r] =
              __bfloat162float(rh_row[hf][kt * kRowsPerTile + r]) *
              kFlashLog2e;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float& x = sacc[4 * i + c];
          x = fmaf(x, kFlashLog2e,
                   rwl[4 * i + c] + rhl[c >> 1][i * kRowsPerTile / 8]);
          mx[c >> 1] = fmaxf(mx[c >> 1], x);
        }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = kt * kBK + 8 * i + 2 * t + (c & 1);
          const int kr = div_small(key, inv_kw);
          const float b = __bfloat162float(rh_row[c >> 1][kr]) +
                          __bfloat162float(rw_row[c >> 1][key - kr * KW]);
          float& x = sacc[4 * i + c];
          x = (x + b) * kFlashLog2e;
          mx[c >> 1] = fmaxf(mx[c >> 1], x);
        }
    }
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      alpha[hf] = exp2f(m[hf] - mx[hf]);
      m[hf] = mx[hf];
      l[hf] *= alpha[hf];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sacc[i] = exp2f(sacc[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += sacc[i];
      oa[i] *= alpha[(i >> 1) & 1];
    }
    if constexpr (kTail > 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) ob[i] *= alpha[(i >> 1) & 1];
    }
    // p in bf16 as wgmma's A operand: keys 16 kk .. 16 kk + 15
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_m64n64k16_rs_t(oa, pa[kk], sw128_desc(va(s) + kk * 16 * 128));
      if constexpr (kTail > 0)
        wgmma_m64n16k16_rs_t(ob, pa[kk],
                             sw32_desc(vb(s) + kk * 16 * kTail * 2));
    }
    // the next tile's S; after the last tile an S on this tile's stage,
    // unread, keeps the accumulators' pipeline free of branches
    const int s1 = kt + 1 < NT ? (kt + 1) % kFlashStages : s;
    if (kt + 1 < NT) mbar_wait(&full[s1], ((kt + 1) / kFlashStages) & 1);
    issue_s(s1);
    wgmma_commit();
  }
  wgmma_wait<0>();

  bf16* oh = o + hs.out(bh);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    const float inv = 1.f / l[hf];
    const int r = qr0 + wr * 16 + g + 8 * hf;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(oh + r * hs.ldo + 8 * i + 2 * t) =
          __floats2bfloat162_rn(oa[4 * i + 2 * hf] * inv,
                                oa[4 * i + 2 * hf + 1] * inv);
    if constexpr (kTail > 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<__nv_bfloat162*>(oh + r * hs.ldo + 64 + 8 * i +
                                           2 * t) =
            __floats2bfloat162_rn(ob[4 * i + 2 * hf] * inv,
                                  ob[4 * i + 2 * hf + 1] * inv);
    }
    if (t == 0)
      lse[(size_t)bh * N + r] = m[hf] * 0.6931471805599453f + logf(l[hf]);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* rel_h,
               const void* rel_w, void* o, float* lse, int BH, int N, int KH,
               int KW, float scale, const HeadStrides& hs, cudaStream_t st) {
  const size_t smem = flash_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      vit_flash_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  vit_flash_f32<D><<<dim3(N / kBQ, BH), 256, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(rel_h),
      static_cast<const float*>(rel_w), static_cast<float*>(o), lse, N, KH,
      KW, scale, hs);
  return (int)cudaGetLastError();
}

// The bias path for KW: 64 / KW key rows a 64-key tile when KW divides 64
// and is at least 8, else 0 (per logit). Must match
// ops/kernels/flash_attention.py key_rows_per_tile.
inline int key_rows_per_tile(int KW) {
  return KW >= 8 && kBK % KW == 0 ? kBK / KW : 0;
}

template <int D, int kRowsPerTile>
int launch_sm90_rows(const FlashMaps& maps, const void* rel_h,
                     const void* rel_w, void* o, float* lse, int BH, int N,
                     int KH, int KW, float scale, const HeadStrides& hs,
                     cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  constexpr int smem = FlashSm90Layout<D>::kSmemBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      vit_flash_sm90<D, kRowsPerTile>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  vit_flash_sm90<D, kRowsPerTile>
      <<<dim3((N + kFlashRows - 1) / kFlashRows, BH), kFlashThreads, smem,
         st>>>(maps, static_cast<const bf16*>(rel_h),
               static_cast<const bf16*>(rel_w), static_cast<bf16*>(o), lse, N,
               KH, KW, scale, hs);
  return (int)cudaGetLastError();
}

// q, k, v: the element (0, 0) of head 0 of each; a head's rows are rows
// (bh / nh) N .. + N - 1 of a [BH / nh * N, cols] matrix of row stride hs.ld
template <int D>
int launch_sm90(const void* q, const void* k, const void* v,
                const void* rel_h, const void* rel_w, void* o, float* lse,
                int BH, int N, int KH, int KW, float scale,
                const HeadStrides& hs, cudaStream_t st) {
  FlashMaps maps;
  const long long rows = (long long)BH / hs.nh * N;
  const long long cols = hs.nh == 1 ? D : (long long)hs.nh * hs.sh;
  const void* src[3] = {q, k, v};
  CUtensorMap* dst[3] = {maps.q, maps.k, maps.v};
  for (int i = 0; i < 3; ++i) {
    if (!make_flash_map(&dst[i][0], src[i], rows, cols, hs.ld, 64,
                        CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
    if (D > 64 && !make_flash_map(&dst[i][1], src[i], rows, cols, hs.ld,
                                  D - 64, CU_TENSOR_MAP_SWIZZLE_32B))
      return (int)cudaErrorInvalidValue;
    if (D == 64) dst[i][1] = dst[i][0];
  }
  switch (key_rows_per_tile(KW)) {
    case 1:
      return launch_sm90_rows<D, 1>(maps, rel_h, rel_w, o, lse, BH, N, KH,
                                    KW, scale, hs, st);
    case 2:
      return launch_sm90_rows<D, 2>(maps, rel_h, rel_w, o, lse, BH, N, KH,
                                    KW, scale, hs, st);
    case 4:
      return launch_sm90_rows<D, 4>(maps, rel_h, rel_w, o, lse, BH, N, KH,
                                    KW, scale, hs, st);
    case 8:
      return launch_sm90_rows<D, 8>(maps, rel_h, rel_w, o, lse, BH, N, KH,
                                    KW, scale, hs, st);
    default:
      return launch_sm90_rows<D, 0>(maps, rel_h, rel_w, o, lse, BH, N, KH,
                                    KW, scale, hs, st);
  }
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v,
           const void* rel_h, const void* rel_w, void* o, float* lse, int BH,
           int N, int KH, int KW, float scale, const HeadStrides& hs,
           cudaStream_t st) {
  if (dtype == kF32)
    return launch_f32<D>(q, k, v, rel_h, rel_w, o, lse, BH, N, KH, KW, scale,
                         hs, st);
  if (dtype == kBF16)
    return launch_sm90<D>(q, k, v, rel_h, rel_w, o, lse, BH, N, KH, KW,
                          scale, hs, st);
  return (int)cudaErrorInvalidValue;
}

int launch_d(int dtype, int D, const void* q, const void* k, const void* v,
             const void* rel_h, const void* rel_w, void* o, void* lse, int BH,
             int N, int KH, int KW, float scale, const HeadStrides& hs,
             void* stream) {
  if ((D != 64 && D != 80) || N % kBQ != 0 || KH * KW != N ||
      KH > kMaxRel || KW > kMaxRel)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lsef = static_cast<float*>(lse);
  if (D == 80)
    return launch<80>(dtype, q, k, v, rel_h, rel_w, o, lsef, BH, N, KH, KW,
                      scale, hs, st);
  return launch<64>(dtype, q, k, v, rel_h, rel_w, o, lsef, BH, N, KH, KW,
                    scale, hs, st);
}

}  // namespace
}  // namespace ullsam

// Plain C entry points (loaded with ctypes). Each returns 0 or a
// cudaError_t. dtype: 0 = float32, 1 = bfloat16 for every tensor but lse,
// which is float32. Both require D in {64, 80}, N % 64 == 0, KH * KW == N,
// KH, KW <= 64, 16-byte aligned tensors; rel_h [BH, N, KH], rel_w [BH, N,
// KW], lse [BH, N].

// B2: q, k, v, o [BH, N, D].
extern "C" int vit_flash_attn_forward(int dtype, const void* q, const void* k,
                                      const void* v, const void* rel_h,
                                      const void* rel_w, void* o, void* lse,
                                      int BH, int N, int D, int KH, int KW,
                                      float scale, void* stream) {
  using namespace ullsam;
  const long long nd = (long long)N * D;
  const HeadStrides hs{1, nd, 0, D, nd, 0, D};
  return launch_d(dtype, D, q, k, v, rel_h, rel_w, o, lse, BH, N, KH, KW,
                  scale, hs, stream);
}

// B14: qkv [B, N, 3C] (q | k | v, head h at h * D of each, C = nh * D),
// o [B, N, C]; bh = b * nh + h.
extern "C" int vit_flash_attn_packed_forward(int dtype, const void* qkv,
                                             const void* rel_h,
                                             const void* rel_w, void* o,
                                             void* lse, int B, int nh, int N,
                                             int D, int KH, int KW,
                                             float scale, void* stream) {
  using namespace ullsam;
  const long long C = (long long)nh * D;
  const HeadStrides hs{nh, N * 3 * C, D, (int)(3 * C), N * C, D, (int)C};
  const size_t eb = dtype == kF32 ? 4 : 2;
  const char* base = static_cast<const char*>(qkv);
  return launch_d(dtype, D, base, base + C * eb, base + 2 * C * eb, rel_h,
                  rel_w, o, lse, B * nh, N, KH, KW, scale, hs, stream);
}
