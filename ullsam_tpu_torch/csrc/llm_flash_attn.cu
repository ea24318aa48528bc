// B10: the LLM's causal GQA flash attention with segment ids, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel ullsam_tpu/ops/pallas/flash_attention.py
// `_llm_kernel` (via `llm_flash_attention` / `_llm_flash_impl`). For query
// row i of head h and key j of kv head h / group:
//     o   = softmax(qs k^T over the valid keys) v,   qs = q * scale
//     lse = logsumexp of each row (f32, for B11)
// where key j is valid iff q_seg[i] == kv_seg[j] and, when causal, j <= i,
// and scale is D^-1/2 rounded to q's dtype (the wrapper's q_scale: JAX's
// `q * D ** -0.5` on a bf16 q is a bf16 product). A row with no valid key
// gives o = 0 and lse = -1e30 (the TPU kernel's NEG_INF). No mask tensor
// exists: the predicate is evaluated per logit from the block's query rows
// and the key tile's segment ids, and skipped on a tile whose keys all
// hold the row's one id below the diagonal.
//
// Layouts are the natural ones, no transposes or padding copies: q, o
// [B, S, nh, D]; k, v [B, S, nkv, D]; q_seg, kv_seg [B, S] int32; lse
// [B, nh, S]. S need not be a multiple of the tile: rows and keys past S
// are zero-filled on load (the bf16 body's TMA maps are 3-D, so a tile
// never reads the next batch row) and masked by bounds checks, so no real
// row ever sees them (the TPU pads with segment ids -1 / -2 instead).
//
// What bounds it on this card: operations. At the packed-training shape
// (B = 1, S = 2560, nh = 16, nkv = 8, D = 128, segments of 1124 and 1224
// tokens) the same-segment pairs need 2 products of 2 D per pair and head,
// 11.5 GFLOP, against ~31 MB of bytes. In float32 the products are
// f32-accurate at their fastest in split TF32 (495 / 3 TFLOP/s).
//
// bf16 design (llm_flash_sm90, llm_sm90.cuh's tiles):
//   * A block is 64 queries of one (b, head): one consumer warpgroup and a
//     producer warp, 83.5 KB of shared memory at D = 128, so two blocks
//     share an SM and one block's segment scan and first loads run under
//     the other's products. The producer's first lane issues TMA loads of
//     64-key tiles of k and v of the kv head h / group into a ring of
//     kFwdStages stages (full / empty mbarriers); the warp copies the
//     tile's segment ids beside them and flags a tile whose 64 keys hold
//     one id. q lands once, loaded before the scan. GQA reads the kv head
//     in place; the group's query heads are neighbouring blocks, so its k
//     and v tiles come from L2.
//   * The walk: the key tiles up to the diagonal (all when not causal) that
//     hold one of the block's segment ids (seg_tiles.cuh: on a packed row
//     the tiles near the block-diagonal). A head's blocks run from the last
//     query tile to the first, the heads of one tile neighbours, so on a
//     causal packed row each segment's longest walks start first.
//   * Per key tile, S = qs k^T on wgmma m64n64k16 from shared-memory
//     descriptors (both K-major, 16 columns a step along each half of the
//     head dim), the online softmax in f32 registers in base 2 (the
//     accumulator layout: a thread holds rows g and g + 8 of its warp's 16,
//     16 keys each), no mask on a tile of the rows' one id below the
//     diagonal, p rounded to bf16 into wgmma's register A operand, and
//     o += p v on wgmma with v read MN-major (trans-b), one product for
//     each half.
//   * q is pre-scaled in place once it lands (elementwise: the product in
//     f32, rounded once) and fenced for the async proxy before the first
//     product.
//   * Rounding points match _llm_flash_impl: qs as above; the unnormalized
//     p is cast to bf16 before p.v; the output is acc / l cast to bf16.
// On an H100 (PERF.md section 6) two blocks of one warpgroup an SM ran
// 1.2x one block of two; the block's own scan had cost 18%; issuing the
// next tile's S before this tile's softmax, with S in two buffers, ran
// slower.
//
// float32 design (llm_flash_tf32, llm_f32.cuh: split TF32 on wgmma + TMA):
//   * A pre-pass (llm_split_f32) writes hi and lo planes of q pre-scaled
//     (q * scale rounded in f32, as prescale_q) and of k, natural, and of v
//     transposed ([D][Sp], keys in lf32_pi order): TF32 wgmma reads shared
//     memory K-major only, and p.v contracts v along its rows.
//   * A block is 64 queries of one (b, head): a consumer warpgroup and a
//     producer warpgroup whose first thread loads q's hi and lo planes
//     once and then k hi, k lo, v^T hi, v^T lo of 32 keys a stage through
//     two stages (197.7 KB at D = 128: one block an SM). The walk is the
//     bf16 body's, each live 64-key tile as two 32-key stages.
//   * Per stage S = qs k^T on m64n32k8 in three products a k-step, in
//     kLf32Chains chains from zero summed on the CUDA cores (a chain over
//     all of D = 128, 48 products, would lose up to 24 ulps);
//     the online softmax in f32 registers with expf; p is not rounded in
//     f32, so it is split in registers into the A operand of p.v
//     (m64nDk8, v^T hi and lo from the stage); each stage's p.v goes into
//     a partial from zero and acc = alpha acc + partial on the CUDA cores.
//     o = acc / l, lse = m + log l in f32.
// Head dims 64 and 128 in both dtypes.
#include "llm_f32.cuh"

namespace ullsam {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kBQ = 64, kBK = 64;
constexpr float kEmptyLse = -1e30f;

// ---- float32: split TF32 on wgmma + TMA (see the note at the top) ---------

constexpr int kLf32FwdTile = 32;      // keys a stage
constexpr int kLf32FwdStages = 2;
constexpr int kLf32FwdThreads = 256;  // a consumer and a producer warpgroup

// The block's shared memory; must match ops/kernels/llm_flash_attention.py
// f32_smem_bytes. 1024 bytes to align the planes; q's hi and lo planes of
// 64 rows (q pre-scaled: 32 KB each at D = 128); the stages, each k hi, k
// lo (natural planes of 32 keys) and v^T hi, v^T lo ([D][32]), 16 KB each
// at D = 128; a full and an empty mbarrier a stage and one for q. At D =
// 128: 1024 + 65536 + 2 x 65536 + 40 = 197,672 bytes.
template <int D>
struct Lf32FwdLayout {
  static constexpr int kQ = kLf32Rows * D * 4;     // a q plane
  static constexpr int kK = kLf32FwdTile * D * 4;  // a k or v^T plane
  static constexpr int kStage = 4 * kK;
  static constexpr int kSmem = 1024 + 2 * kQ + kLf32FwdStages * kStage +
                               (2 * kLf32FwdStages + 1) * 8;
  static_assert(kSmem + (int)sizeof(SegTiles) <= 232448, "one block");
};

// the maps of the forward's scratch: `nat` [2 B nh Sp + 2 B nkv Sp][D] (q
// hi, q lo, k hi, k lo) in boxes of 32 rows, `tr` [2 B nkv D][Sp] (v^T hi,
// lo) in boxes of D rows by 32 keys
struct Lf32FwdMaps {
  CUtensorMap nat, tr;
};

// grid (nh * ceil(S / 64), B), kLf32FwdThreads threads: o [B, S, nh, D] and
// lse [B, nh, S] of 64 queries of one (b, head)
template <int D>
__global__ void __launch_bounds__(kLf32FwdThreads, 1)
    llm_flash_tf32(const __grid_constant__ Lf32FwdMaps maps,
                   const int* __restrict__ qseg, const int* __restrict__ kseg,
                   float* __restrict__ o, float* __restrict__ lse, int S,
                   int nh, int nkv, int causal) {
  using L = Lf32FwdLayout<D>;
  constexpr int kT = kLf32FwdTile, kSt = kLf32FwdStages;
  extern __shared__ unsigned char smraw[];
  unsigned char* base = align1024(smraw);  // q hi, q lo
  unsigned char* stages = base + 2 * L::kQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kSt * L::kStage);
  uint64_t* empty = full + kSt;
  uint64_t* qbar = empty + kSt;
  // stage s: k hi, k lo, v^T hi, v^T lo (i = 0..3)
  const auto plane = [&](int s, int i) {
    return stages + s * L::kStage + i * L::kK;
  };
  __shared__ SegTiles tiles;

  const int tid = threadIdx.x, B = gridDim.y;
  const int NT = (S + kLf32Rows - 1) / kLf32Rows, Sp = NT * kLf32Rows;
  const int h = blockIdx.x % nh, b = blockIdx.y;
  const int qt = NT - 1 - blockIdx.x / nh;  // the longest rows first
  const int q0 = qt * kLf32Rows, hk = h / (nh / nkv);
  const int* qsb = qseg + (size_t)b * S;
  const int* ksb = kseg + (size_t)b * S;
  if (tid == 0) {
    for (int s = 0; s < kSt; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // each consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int nkt = causal ? qt + 1 : NT;
  seg_own_ids(tiles, qsb, q0, S, tid);  // synchronises: the barriers exist
  seg_mark_live(tiles, ksb, 0, nkt, S, tid, kLf32FwdThreads);

  if (tid >= 128) {  // the producer warpgroup: one thread issues
    if (tid == 128) {
      const int qrow = (b * nh + h) * Sp + q0, qlo = B * nh * Sp;
      mbar_expect_tx(qbar, 2 * L::kQ);
      for (int i = 0; i < 2; ++i)
        for (int r = 0; r < kLf32Rows; r += kT)
          lf32_load_rows<D, kLf32Rows>(base + i * L::kQ, r, &maps.nat, qbar,
                                       qrow + i * qlo + r);
      const int krow = 2 * B * nh * Sp + (b * nkv + hk) * Sp;
      const int klo = B * nkv * Sp;
      const int vrow = (b * nkv + hk) * D, vlo = B * nkv * D;
      int i = 0;
      for (Lf32Walk<kT> w(tiles, 0, nkt, 1); w.valid(); w.next(), ++i) {
        const int s = i % kSt, ph = (i / kSt) & 1, k0 = w.row0();
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], L::kStage);
        for (int j = 0; j < 2; ++j) {
          lf32_load_rows<D, kT>(plane(s, j), 0, &maps.nat, &full[s],
                                krow + j * klo + k0);
          tma_load_2d(plane(s, 2 + j), &maps.tr, &full[s], k0,
                      vrow + j * vlo);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: warp wr rows q0 + 16 wr .. + 15, a thread rows
  // g and g + 8 of those, keys 8 j + 2 t, + 1 of a tile (accumulator slot
  // 4 j + 2 hf + e)
  const int lane = tid & 31, wr = tid >> 5, g = lane >> 2, t = lane & 3;
  int row[2], rseg[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    row[hf] = q0 + wr * 16 + g + 8 * hf;
    rseg[hf] = row[hf] < S ? qsb[row[hf]] : 0;
  }
  float ch[kLf32Chains][16], part[D / 2], oacc[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) part[c] = oacc[c] = 0.f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  const auto fence_acc = [&] {
#pragma unroll
    for (int c = 0; c < kLf32Chains; ++c) reg_fence(ch[c]);
    reg_fence(part);
    reg_fence(oacc);
  };
  mbar_wait(qbar, 0);

  int i = 0;
  for (Lf32Walk<kT> w(tiles, 0, nkt, 1); w.valid(); w.next(), ++i) {
    const int s = i % kSt, ph = (i / kSt) & 1, k0 = w.row0();
    int kid[8];  // segment ids of the thread's keys 8 j + 2 t + e
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        kid[2 * j + e] = key < S ? ksb[key] : 0;
      }
    mbar_wait(&full[s], ph);
    // S = qs k^T in kLf32Chains chains from zero
#pragma unroll
    for (int c = 0; c < kLf32Chains; ++c)
#pragma unroll
      for (int x = 0; x < 16; ++x) ch[c][x] = 0.f;
    fence_acc();
    wgmma_fence();
    lf32_logits<D, kT>(
        ch,
        [&](int ks, bool lo) {
          return lf32_nat_desc<kLf32Rows>(base + (lo ? L::kQ : 0), ks);
        },
        [&](int ks, bool lo) {
          return lf32_nat_desc<kT>(plane(s, lo ? 1 : 0), ks);
        });
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc();

    // the logits, masked, and the row maxima
    float sv[16], mx[2] = {m[0], m[1]};
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int j = x >> 2, hf = (x >> 1) & 1, e = x & 1;
      float v = ch[0][x];
#pragma unroll
      for (int c = 1; c < kLf32Chains; ++c) v += ch[c][x];
      const int key = k0 + 8 * j + 2 * t + e;
      const bool ok = key < S && kid[2 * j + e] == rseg[hf] &&
                      (!causal || key <= row[hf]);
      sv[x] = ok ? v : -INFINITY;
      mx[hf] = fmaxf(mx[hf], sv[x]);
    }
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      alpha[hf] = expf(m[hf] - mx[hf]);
      m[hf] = mx[hf];
      l[hf] *= alpha[hf];
    }
    // p = exp(s - m), split into the A operand of k-step j: register 2 e +
    // hf holds row g + 8 hf, key 8 j + 2 t + e (lf32_pi)
    uint32_t ph_[4][4], pl_[4][4];
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int j = x >> 2, hf = (x >> 1) & 1, e = x & 1;
      const float p = expf(sv[x] - m[hf]);
      l[hf] += p;
      tf32_split(p, ph_[j][2 * e + hf], pl_[j][2 * e + hf]);
    }

    // this tile's p v into a partial from zero
#pragma unroll
    for (int c = 0; c < D / 2; ++c) part[c] = 0.f;
    fence_acc();
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
      const uint64_t vh = lf32_tr_desc<kT>(plane(s, 2), j);
      const uint64_t vl = lf32_tr_desc<kT>(plane(s, 3), j);
      lf32_rs<D>(part, ph_[j], vl);
      lf32_rs<D>(part, pl_[j], vh);
      lf32_rs<D>(part, ph_[j], vh);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc();
    lf32_release(&empty[s], lane);
#pragma unroll
    for (int c = 0; c < D / 2; ++c)
      oacc[c] = oacc[c] * alpha[(c >> 1) & 1] + part[c];
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    if (row[hf] >= S) continue;
    const bool live = l[hf] > 0.f;
    const float div = live ? l[hf] : 1.f;
    float* out = o + ((size_t)b * S + row[hf]) * nh * D + (size_t)h * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(out + 8 * j + 2 * t) =
          make_float2(oacc[4 * j + 2 * hf] / div,
                      oacc[4 * j + 2 * hf + 1] / div);
    if (t == 0)
      lse[((size_t)b * nh + h) * S + row[hf]] =
          live ? m[hf] + logf(l[hf]) : kLf32EmptyLse;
  }
}

// ---- bf16: wgmma + TMA (see the note at the top) -------------------------

constexpr int kFwdStages = 2;
constexpr int kFwdThreads = 160;  // a consumer warpgroup + a producer warp

// The block's shared memory: 1024 bytes to align the tiles; q's 64 rows
// (two halves); the stages, each k then v of 64 keys; the stages' key
// segment ids [kFwdStages][64] and tile flags (int2: all 64 keys valid and
// of one id, that id); the mbarriers (full and empty a stage, one for q).
// Two blocks fit an SM.
template <int D>
struct FwdLayout {
  using T = LlmTiles<D>;
  static constexpr int kStage = 2 * T::kTile;
  static constexpr int kMeta = kFwdStages * (kLlmTile * 4 + 8);
  static constexpr int kSmem = 1024 + T::kTile + kFwdStages * kStage + kMeta +
                               (2 * kFwdStages + 1) * 8;
  static_assert(2 * (kSmem + (int)sizeof(SegTiles)) <= 232448,
                "two blocks an SM");
};

struct LlmFwdMaps {
  CUtensorMap q, k, v;
};

// grid (nh * ceil(S / 64), B), kFwdThreads threads; q, k, v through maps
// (3-D: columns, S, B), o [B, S, nh, D], lse [B, nh, S]
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 2)
    llm_flash_sm90(const __grid_constant__ LlmFwdMaps maps,
                   const int* __restrict__ qseg, const int* __restrict__ kseg,
                   bf16* __restrict__ o, float* __restrict__ lse, int S,
                   int nh, int nkv, int causal, float scale) {
  using T = LlmTiles<D>;
  using L = FwdLayout<D>;
  constexpr int kH = T::kHalf, kW = T::kRowBytes, kHB = T::kHalfBytes;
  extern __shared__ unsigned char smraw[];
  unsigned char* base = align1024(smraw);
  unsigned char* qw = base;                      // two halves
  unsigned char* stages = base + T::kTile;       // [s]: k h0, k h1, v h0, v h1
  int* ksegs = reinterpret_cast<int*>(stages + kFwdStages * L::kStage);
  int2* flags = reinterpret_cast<int2*>(ksegs + kFwdStages * kLlmTile);
  uint64_t* full = reinterpret_cast<uint64_t*>(flags + kFwdStages);
  uint64_t* empty = full + kFwdStages;
  uint64_t* qbar = empty + kFwdStages;
  const auto kt_half = [&](int s, int hf) {
    return stages + s * L::kStage + hf * kHB;
  };
  const auto vt_half = [&](int s, int hf) {
    return stages + s * L::kStage + T::kTile + hf * kHB;
  };
  __shared__ SegTiles tiles;

  const int tid = threadIdx.x;
  const int NT = (S + kBK - 1) / kBK;
  const int h = blockIdx.x % nh, b = blockIdx.y;
  const int qt = NT - 1 - blockIdx.x / nh;
  const int q0 = qt * kBQ;
  const int hk = h / (nh / nkv);
  const int* qsb = qseg + (size_t)b * S;
  const int* ksb = kseg + (size_t)b * S;
  if (tid == 0) {  // q loads while the block finds its key tiles
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA's expect_tx + the id copiers
      mbar_init(&empty[s], 1);      // released by the warpgroup
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(qbar, T::kTile);
    for (int hf = 0; hf < 2; ++hf)
      tma_load_3d(qw + hf * kHB, &maps.q, qbar, h * D + hf * kH, q0, b);
  }
  const int nkt = causal ? qt + 1 : NT;
  seg_own_ids(tiles, qsb, q0, S, tid);  // synchronises: the barriers exist
  seg_mark_live<4>(tiles, ksb, 0, nkt, S, tid, kFwdThreads);

  if (tid >= 128) {  // the producer warp
    const int lane = tid - 128;
    int i = 0;
    for (int kt = seg_next_live(tiles, 0, nkt); kt < nkt;
         kt = seg_next_live(tiles, kt + 1, nkt), ++i) {
      const int s = i % kFwdStages, ph = (i / kFwdStages) & 1;
      mbar_wait(&empty[s], ph ^ 1);
      const int k0 = kt * kBK;
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * T::kTile);
        for (int hf = 0; hf < 2; ++hf) {
          tma_load_3d(kt_half(s, hf), &maps.k, &full[s], hk * D + hf * kH,
                      k0, b);
          tma_load_3d(vt_half(s, hf), &maps.v, &full[s], hk * D + hf * kH,
                      k0, b);
        }
      }
      const int a = k0 + lane < S ? ksb[k0 + lane] : 0;
      const int c = k0 + 32 + lane < S ? ksb[k0 + 32 + lane] : 0;
      ksegs[s * kLlmTile + lane] = a;
      ksegs[s * kLlmTile + 32 + lane] = c;
      const int first = __shfl_sync(0xffffffffu, a, 0);
      const bool one = __all_sync(0xffffffffu, a == first && c == first) &&
                       k0 + kBK <= S;
      if (lane == 0) flags[s] = make_int2(one ? 1 : 0, first);
      mbar_arrive(&full[s]);
    }
    return;
  }

  // the consumer warpgroup: warp wr rows q0 + 16 wr .. + 15, a thread rows
  // g and g + 8 of those
  const int lane = tid & 31, wr = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  int row[2], rseg[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    row[hf] = q0 + wr * 16 + g + 8 * hf;
    rseg[hf] = row[hf] < S ? qsb[row[hf]] : 0;
  }
  mbar_wait(qbar, 0);
  // q pre-scaled in place, 16 bytes at a time (the swizzle moves whole
  // 16-byte chunks, so an elementwise pass need not know it)
#pragma unroll
  for (int i = 0; i < T::kTile / 16 / 128; ++i) {
    uint4* p = reinterpret_cast<uint4*>(qw) + tid + 128 * i;
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
  fence_proxy_async();
  named_bar_sync(1, 128);  // q scaled

  constexpr int kAcc = kH / 2;  // accumulator registers of a half's product
  float sacc[32], oacc[2][kAcc];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) oacc[0][i] = oacc[1][i] = 0.f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  const auto fence_acc = [&] {
    reg_fence(sacc);
    reg_fence(oacc[0]);
    reg_fence(oacc[1]);
  };

  int i = 0;
  for (int kt = seg_next_live(tiles, 0, nkt); kt < nkt;
       kt = seg_next_live(tiles, kt + 1, nkt), ++i) {
    const int s = i % kFwdStages, ph = (i / kFwdStages) & 1;
    mbar_wait(&full[s], ph);
    // S = qs k^T, both K-major, 16 columns a step along each half
    fence_acc();
    wgmma_fence();
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int ks = 0; ks < kH / 16; ++ks)
        wgmma_m64n64k16_ss(sacc, swz_desc<kW>(qw + hf * kHB + 32 * ks),
                           swz_desc<kW>(kt_half(s, hf) + 32 * ks),
                           hf + ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc();

    // base-2 logits, masked where the tile needs it, and the row maxima
    const int k0 = kt * kBK;
    const int2 fl = flags[s];
    float mx[2] = {m[0], m[1]};
    const bool whole0 = fl.x && fl.y == rseg[0] && (!causal ||
                                                     k0 + kBK - 1 <= row[0]);
    const bool whole1 = fl.x && fl.y == rseg[1] && (!causal ||
                                                     k0 + kBK - 1 <= row[1]);
    if (whole0 && whole1) {
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        sacc[c] *= kLlmLog2e;
        mx[(c >> 1) & 1] = fmaxf(mx[(c >> 1) & 1], sacc[c]);
      }
    } else {
      const int* ks = ksegs + s * kLlmTile;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int2 kk = *reinterpret_cast<const int2*>(ks + 8 * j + 2 * t);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int hf = c >> 1, e = c & 1;
          const int key = k0 + 8 * j + 2 * t + e;
          const bool ok = key < S && (e ? kk.y : kk.x) == rseg[hf] &&
                          (!causal || key <= row[hf]);
          float& x = sacc[4 * j + c];
          x = ok ? x * kLlmLog2e : -INFINITY;
          mx[hf] = fmaxf(mx[hf], x);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      alpha[hf] = ex2_ftz(m[hf] - mx[hf]);
      m[hf] = mx[hf];
      l[hf] *= alpha[hf];
    }
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      sacc[c] = ex2_ftz(sacc[c] - m[(c >> 1) & 1]);
      l[(c >> 1) & 1] += sacc[c];
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int c = 0; c < kAcc; ++c) oacc[hf][c] *= alpha[(c >> 1) & 1];
    // p in bf16 as wgmma's A operand: keys 16 kk .. 16 kk + 15
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        pa[kk][u] = pack_bf16(sacc[8 * kk + 2 * u], sacc[8 * kk + 2 * u + 1]);

    fence_acc();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        wgmma_rs_t<kH>(oacc[hf], pa[kk],
                       swz_desc<kW>(vt_half(s, hf) + kk * 16 * kW));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc();
    if (tid == 0) mbar_arrive(&empty[s]);
  }

  const size_t ldo = (size_t)nh * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    if (row[hf] >= S) continue;
    const bool any = l[hf] > 0.f;
    const float inv = any ? 1.f / l[hf] : 0.f;
    bf16* out = o + ((size_t)b * S + row[hf]) * ldo + (size_t)h * D;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < kH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + half * kH + 8 * j + 2 * t) =
            __floats2bfloat162_rn(oacc[half][4 * j + 2 * hf] * inv,
                                  oacc[half][4 * j + 2 * hf + 1] * inv);
    if (t == 0)
      lse[((size_t)b * nh + h) * S + row[hf]] =
          any ? m[hf] * 0.6931471805599453f + logf(l[hf]) : kEmptyLse;
  }
}

// the split pre-pass into `scratch` (q pre-scaled and k natural, v
// transposed, hi and lo: B Sp D (2 nh + 4 nkv) floats), then the kernel
template <int D>
int launch_tf32(const float* q, const float* k, const float* v,
                const int* qseg, const int* kseg, float* o, float* lse,
                float* scratch, int B, int S, int nh, int nkv, int causal,
                float scale, cudaStream_t st) {
  const int Sp = (S + kLf32Rows - 1) / kLf32Rows * kLf32Rows;
  const long long pq = (long long)B * nh * Sp, pk = (long long)B * nkv * Sp;
  if (!scratch || 2 * (pq + pk) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  float* nat = scratch;                     // q hi, q lo, k hi, k lo
  float* vt = nat + 2 * (pq + pk) * D;      // v^T hi, v^T lo
  int e;
  if ((e = lf32_split<D>(q, B, S, Sp, nh, scale, nat, nullptr, st)) ||
      (e = lf32_split<D>(k, B, S, Sp, nkv, 1.f, nat + 2 * pq * D, nullptr,
                         st)) ||
      (e = lf32_split<D>(v, B, S, Sp, nkv, 1.f, nullptr, vt, st)))
    return e;
  Lf32FwdMaps maps;
  if (!lf32_map(&maps.nat, nat, 2 * (pq + pk), D, 32, kLf32FwdTile) ||
      !lf32_map(&maps.tr, vt, 2LL * B * nkv * D, Sp, kLf32FwdTile, D))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = Lf32FwdLayout<D>::kSmem;
  static const cudaError_t attr = cudaFuncSetAttribute(
      llm_flash_tf32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  llm_flash_tf32<D>
      <<<dim3(nh * (Sp / kLf32Rows), B), kLf32FwdThreads, smem, st>>>(
          maps, qseg, kseg, o, lse, S, nh, nkv, causal);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v,
           const int* qseg, const int* kseg, void* o, float* lse,
           float* scratch, int B, int S, int nh, int nkv, int causal,
           float scale, cudaStream_t st) {
  if (dtype == kF32)
    return launch_tf32<HD>(static_cast<const float*>(q),
                           static_cast<const float*>(k),
                           static_cast<const float*>(v), qseg, kseg,
                           static_cast<float*>(o), lse, scratch, B, S, nh,
                           nkv, causal, scale, st);
  if (dtype == kBF16) {
    LlmFwdMaps maps;
    if (!make_llm_map(&maps.q, q, B, S, (long long)nh * HD, HD / 2) ||
        !make_llm_map(&maps.k, k, B, S, (long long)nkv * HD, HD / 2) ||
        !make_llm_map(&maps.v, v, B, S, (long long)nkv * HD, HD / 2))
      return (int)cudaErrorInvalidValue;
    constexpr int smem = FwdLayout<HD>::kSmem;
    static const cudaError_t attr = [] {
      const cudaError_t e = cudaFuncSetAttribute(
          llm_flash_sm90<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      return e != cudaSuccess ? e
                              : cudaFuncSetAttribute(
                                    llm_flash_sm90<HD>,
                                    cudaFuncAttributePreferredSharedMemoryCarveout,
                                    (int)cudaSharedmemCarveoutMaxShared);
    }();
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid(nh * ((S + kBQ - 1) / kBQ), B);
    llm_flash_sm90<HD><<<grid, kFwdThreads, smem, st>>>(
        maps, qseg, kseg, static_cast<bf16*>(o), lse, S, nh, nkv, causal,
        scale);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ullsam

// Plain C entry point (loaded with ctypes). Returns 0 or a cudaError_t.
// dtype: 0 = float32, 1 = bfloat16 for q, k, v and o; q_seg, kv_seg int32;
// lse float32 [B, nh, S]; scratch float32, B Sp D (kLf32FwdQPlanes nh +
// kLf32FwdKvPlanes nkv) floats in float32 (Sp = 64 ceil(S / 64)), unused
// in bfloat16. Requires D in {64, 128}, nh % nkv == 0, S <= 64 *
// kMaxSegTiles and 16-byte aligned tensors; scale is D^-1/2 rounded to q's
// dtype.
extern "C" int llm_flash_attn_forward(int dtype, const void* q, const void* k,
                                      const void* v, const void* q_seg,
                                      const void* kv_seg, void* o, void* lse,
                                      void* scratch, int B, int S, int nh,
                                      int nkv, int D, int causal, float scale,
                                      void* stream) {
  using namespace ullsam;
  if (B < 1 || S < 1 || S > kSegTile * kMaxSegTiles || nkv < 1 ||
      nh % nkv != 0 || B > 65535 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* qs = static_cast<const int*>(q_seg);
  const int* ks = static_cast<const int*>(kv_seg);
  float* lsef = static_cast<float*>(lse);
  float* scr = static_cast<float*>(scratch);
  if (D == 64)
    return launch<64>(dtype, q, k, v, qs, ks, o, lsef, scr, B, S, nh, nkv,
                      causal, scale, st);
  if (D == 128)
    return launch<128>(dtype, q, k, v, qs, ks, o, lsef, scr, B, S, nh, nkv,
                       causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
