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
// 11.5 GFLOP, against ~31 MB of bytes. float32 stays true f32 FMA
// (llm_flash_f32, no TF32), bounded by the 67 TFLOP/s f32 rate.
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
// Head dims 64 and 128 in both dtypes.
#include "attn_fma.cuh"
#include "llm_sm90.cuh"
#include "seg_tiles.cuh"

namespace ullsam {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kBQ = 64, kBK = 64;
constexpr float kEmptyLse = -1e30f;

// row strides (elements) and bases of one (b, head) pair
struct Rows {
  size_t q, kv;  // row strides of q / o and of k / v
  size_t qoff, kvoff, segoff;
};

__device__ __forceinline__ Rows rows_of(int b, int h, int S, int nh,
                                        int nkv, int hd) {
  Rows r;
  r.q = (size_t)nh * hd;
  r.kv = (size_t)nkv * hd;
  r.qoff = (size_t)b * S * r.q + (size_t)h * hd;
  r.kvoff = (size_t)b * S * r.kv + (size_t)(h / (nh / nkv)) * hd;
  r.segoff = (size_t)b * S;
  return r;
}

// ---- float32: FMA on the CUDA cores ---------------------------------------

template <int HD>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * AttnBlockF32<HD>::kSmemFloats +
         sizeof(int) * (kBQ + kBK);
}

// grid (ceil(S / 64), nh, B), 256 threads
template <int HD>
__global__ void __launch_bounds__(256, 1)
    llm_flash_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ qseg,
                  const int* __restrict__ kseg, float* __restrict__ o,
                  float* __restrict__ lse, int S, int nh, int nkv,
                  int causal, float scale) {
  using FB = AttnBlockF32<HD>;
  constexpr int kLdT = FB::kLdT, kLdV = FB::kLdV;
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;                         // [HD][kLdT]  (d-major)
  float* Kt = Qt + HD * kLdT;             // [HD][kLdT]  (d-major)
  float* Vs = Kt + HD * kLdT;             // [kBK][kLdV]
  float* Ps = Vs + kBK * kLdV;            // [kBQ][kLdP]
  int* QSeg = reinterpret_cast<int*>(Ps + kBQ * FB::kLdP);  // [kBQ]
  int* KSeg = QSeg + kBQ;                                   // [kBK]

  const int tid = threadIdx.x;
  const int NT = (S + kBK - 1) / kBK;
  const int qt = NT - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z, q0 = qt * kBQ;
  const Rows R = rows_of(b, h, S, nh, nkv, HD);

  for (int e = tid; e < kBQ * HD; e += 256) {
    const int r = e / HD, d = e % HD;
    Qt[d * kLdT + r] =
        q0 + r < S ? q[R.qoff + (size_t)(q0 + r) * R.q + d] * scale : 0.f;
  }
  if (tid < kBQ) QSeg[tid] = q0 + tid < S ? qseg[R.segoff + q0 + tid] : 0;

  FB fb;
  fb.begin(tid);
  const int nkt = causal ? qt + 1 : NT;
  __shared__ SegTiles tiles;
  seg_own_ids(tiles, qseg + R.segoff, q0, S, tid);
  seg_mark_live(tiles, kseg + R.segoff, 0, nkt, S, tid, 256);
  for (int kt = seg_next_live(tiles, 0, nkt); kt < nkt;
       kt = seg_next_live(tiles, kt + 1, nkt)) {
    const int k0 = kt * kBK;
    __syncthreads();  // previous tile's Kt / Vs / Ps / KSeg are free
    for (int e = tid; e < kBK * HD; e += 256) {
      const int j = e / HD, d = e % HD;
      const bool in = k0 + j < S;
      const size_t gi = R.kvoff + (size_t)(k0 + j) * R.kv + d;
      Kt[d * kLdT + j] = in ? k[gi] : 0.f;
      Vs[j * kLdV + d] = in ? v[gi] : 0.f;
    }
    if (tid < kBK) KSeg[tid] = k0 + tid < S ? kseg[R.segoff + k0 + tid] : 0;
    __syncthreads();
    const auto bias = [&](int r, int key) {
      const bool ok = key < S && KSeg[key - k0] == QSeg[r] &&
                      (!causal || key <= q0 + r);
      return ok ? 0.f : -INFINITY;
    };
    // q was pre-scaled (the reference's rounding point): logits scale 1
    fb.tile(Qt, Kt, Vs, Ps, k0, 1.0f, bias);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + fb.ty * 4 + i;
    if (r >= S) continue;
    const bool live = fb.l[i] > 0.f;
    const float inv = live ? 1.f / fb.l[i] : 0.f;
#pragma unroll
    for (int c = 0; c < FB::kCols; ++c)
      o[R.qoff + (size_t)r * R.q + fb.col0() + c] = fb.acc[i][c] * inv;
    if (fb.tx == 0)
      lse[((size_t)b * nh + h) * S + r] =
          live ? fb.m[i] + logf(fb.l[i]) : kEmptyLse;
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

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v,
           const int* qseg, const int* kseg, void* o, float* lse, int B,
           int S, int nh, int nkv, int causal, float scale,
           cudaStream_t st) {
  if (dtype == kF32) {
    const dim3 grid((S + kBQ - 1) / kBQ, nh, B);
    const size_t smem = f32_smem_bytes<HD>();
    const cudaError_t err = cudaFuncSetAttribute(
        llm_flash_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    llm_flash_f32<HD><<<grid, 256, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), qseg, kseg, static_cast<float*>(o), lse,
        S, nh, nkv, causal, scale);
    return (int)cudaGetLastError();
  }
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
// lse float32 [B, nh, S]. Requires D in {64, 128}, nh % nkv == 0,
// S <= 64 * kMaxSegTiles and 16-byte aligned tensors; scale is D^-1/2
// rounded to q's dtype.
extern "C" int llm_flash_attn_forward(int dtype, const void* q, const void* k,
                                      const void* v, const void* q_seg,
                                      const void* kv_seg, void* o, void* lse,
                                      int B, int S, int nh, int nkv, int D,
                                      int causal, float scale, void* stream) {
  using namespace ullsam;
  if (B < 1 || S < 1 || S > kSegTile * kMaxSegTiles || nkv < 1 ||
      nh % nkv != 0 || B > 65535 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* qs = static_cast<const int*>(q_seg);
  const int* ks = static_cast<const int*>(kv_seg);
  float* lsef = static_cast<float*>(lse);
  if (D == 64)
    return launch<64>(dtype, q, k, v, qs, ks, o, lsef, B, S, nh, nkv, causal,
                      scale, st);
  if (D == 128)
    return launch<128>(dtype, q, k, v, qs, ks, o, lsef, B, S, nh, nkv,
                       causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
