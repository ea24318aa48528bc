// B11: gradient of the LLM's causal GQA flash attention with segment ids
// (B10), for Hopper (sm_90a).
//
// Replaces the TPU kernels ullsam_tpu/ops/pallas/flash_attention.py
// `_llm_bwd_dq_kernel` and `_llm_bwd_dkv_kernel` (via `_llm_flash_bwd_impl`).
// With the validity predicate (q_seg[i] == kv_seg[j], and j <= i when
// causal), the forward's row logsumexp lse and dd = rowsum(do * o)
// (computed by the caller), it scores as the TPU kernels do, from unscaled
// q (flash_attention.py:604-612):
//     s = f32(q k^T) * D^-1/2,  p = exp(s - lse) at valid keys, 0 elsewhere
//     ds = p (do v^T - dd)
//     dq = (ds k) * D^-1/2,  dk = sum over the group's heads of (ds^T q)
//     * D^-1/2,  dv = sum over the group's heads of p^T do
// p and ds are rounded to the input dtype before their products; every sum
// is f32. Layouts as B10: q, do, dq [B, S, nh, D]; k, v, dk, dv [B, S, nkv,
// D]; segment ids [B, S] int32; lse, dd [B, nh, S]; rows and keys past S
// are zero-filled on load and masked by bounds checks.
//
// What bounds it on this card: operations. The gradient needs 5 products of
// 2 D per valid (query, key) pair and head (s, dp, dv, dk, dq): at the
// packed-training shape (S = 2560, nh = 16, nkv = 8, D = 128, segments of
// 1124 and 1224 tokens) 28.8 GFLOP against ~52 MB.
//
// bf16 (llm_bwd_sm90, llm_sm90.cuh's tiles): one key-major kernel that runs
// the 5 products, and a small one that converts dq's f32 sum.
//   * A block owns 64 keys of one kv head and walks, for each of the
//     group's query heads in turn, the query tiles from the diagonal on
//     (all when not causal) that hold one of its keys' segment ids
//     (seg_tiles.cuh). dK and dV sum the group in registers and are
//     written once, in bf16. Blocks run key tile by key tile, the kv heads
//     of one tile neighbours: on a causal packed row each segment's
//     longest walks start first.
//   * Two consumer warpgroups and a producer warpgroup that gives its
//     registers to them (setmaxnreg 40 / 232). Thread 0 loads the block's
//     k and v by TMA before the segment scan; the producer's first thread
//     then loads q and do of each query tile into a ring of kBwdStages
//     stages (full / empty mbarriers), its first 64 threads copying the
//     tile's lse (times log2 e), dd and segment ids beside them.
//   * Per query tile, warpgroup w takes queries 32 w .. 32 w + 31: S^T = k
//     q^T and dP^T = v do^T on wgmma m64n32k16 (all operands K-major from
//     shared memory), p^T and ds^T in f32 registers, rounded to bf16 into
//     two shared [64 keys][64 queries] tiles in the 128-byte swizzle
//     (double-buffered; one named barrier a tile joins the warpgroups).
//     Then warpgroup w takes columns w D/2 .. of every output: dV += P^T do
//     and dK += dS^T q (m64n(D/2)k16, q and do read MN-major), and dQ =
//     dS k (dS^T read MN-major as A).
//   * dQ: each warpgroup stages its 64 x D/2 partial in shared memory and
//     one thread adds it to the tile's chunk of an f32 scratch with one TMA
//     bulk reduction (cp.reduce.async.bulk .add.f32, 16 KB at D = 128);
//     llm_bwd_convert scales the sums by D^-1/2 and rounds them to bf16.
//     The reductions land in an order that changes from run to run, and so
//     do dq's last bits; dk and dv are the same every run.
// On an H100 (PERF.md section 6): float-pair red.global.add of dQ from
// registers held the kernel near the L2's atomic rate; the bulk
// reductions ran 1.25x. Walking the group's heads in turn ran 1.1x
// spreading them over blocks with dk / dv atomics (half the blocks, half
// the scratch). Loading k / v before the scan and the scan's loads four at
// a time, 1.06x. Issuing the next tile's S^T / dP^T before this tile's
// softmax (two buffers), with or without the softmax under the previous
// tile's products, and a mask-free path for tile pairs of one segment ran
// slower.
// float32 stays true f32 FMA on the CUDA cores, two kernels and no atomics
// (256 threads, 4 x 4 scores and 4 x D/16 outputs each): dq q-tile major,
// dk + dv k-tile major walking the group's heads in turn, bounded by the
// 67 TFLOP/s f32 rate.
#include "llm_sm90.cuh"
#include "seg_tiles.cuh"

namespace ullsam {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kB = 64;         // query / key tile
constexpr int kLdF = kB + 4;   // f32 d-major / score row stride

// ---- float32: FMA on the CUDA cores ---------------------------------------
// 256 threads; thread (ty, tx) = (tid / 16, tid % 16) holds a 4 x 4 block of
// the 64 x 64 score tile (rows 4 ty.., columns 4 tx..) and rows 4 ty.. x
// channels tx * HD / 16 .. of the 64 x HD output. Operands of the score
// products sit d-major ([HD][kLdF]), operands of the output products
// row-major ([64][HD + 4]).

template <int HD>
__device__ __forceinline__ void fma_tile(float (&s)[4][4], const float* at,
                                         const float* bt, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(at + d * kLdF + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(bt + d * kLdF + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[4][HD/16] += P[4 ty.., :] ([64][kLdF]) . B[:, tx HD/16 ..] ([64][HD+4])
template <int HD>
__device__ __forceinline__ void fma_out(float (&acc)[4][HD / 16],
                                        const float* P, const float* B,
                                        int ty, int tx) {
  constexpr int kC = HD / 16, kLdR = HD + 4;
#pragma unroll 4
  for (int m = 0; m < kB; ++m) {
    float bv[kC];
#pragma unroll
    for (int u = 0; u < kC; u += 4) {
      const float4 b4 =
          *reinterpret_cast<const float4*>(B + m * kLdR + tx * kC + u);
      bv[u] = b4.x, bv[u + 1] = b4.y, bv[u + 2] = b4.z, bv[u + 3] = b4.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = P[(ty * 4 + i) * kLdF + m];
#pragma unroll
      for (int u = 0; u < kC; ++u) acc[i][u] = fmaf(p, bv[u], acc[i][u]);
    }
  }
}

// 64 rows [row0, row0 + 64) of a global array with row stride ld_g (HD
// floats used) into smem, d-major and/or row-major (either may be null);
// rows past S are zero
template <int HD>
__device__ __forceinline__ void load_f32(float* dmaj, float* rmaj,
                                         const float* base, size_t ld_g,
                                         int row0, int S, int tid) {
  for (int e = tid; e < kB * HD; e += 256) {
    const int r = e / HD, d = e % HD;
    const float x = row0 + r < S ? base[(size_t)(row0 + r) * ld_g + d] : 0.f;
    if (dmaj) dmaj[d * kLdF + r] = x;
    if (rmaj) rmaj[r * (HD + 4) + d] = x;
  }
}

template <int HD>
constexpr size_t dq_f32_smem() {
  return sizeof(float) * (size_t)(4 * HD * kLdF + kB * (HD + 4) +
                                  kB * kLdF + 4 * kB);
}

// grid (ceil(S / 64), nh, B): dq of 64 query rows, the longest first
template <int HD>
__global__ void __launch_bounds__(256, 1)
    llm_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const int* __restrict__ qseg,
                   const int* __restrict__ kseg,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dd, float* __restrict__ dq,
                   int S, int nh, int nkv, int causal, float scale) {
  constexpr int kC = HD / 16;
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;                  // [HD][kLdF] q
  float* Gt = Qt + HD * kLdF;      // [HD][kLdF] do
  float* Kt = Gt + HD * kLdF;      // [HD][kLdF]
  float* Vt = Kt + HD * kLdF;      // [HD][kLdF]
  float* Kr = Vt + HD * kLdF;      // [64 keys][HD + 4]
  float* DS = Kr + kB * (HD + 4);  // [64 rows][kLdF]
  float* LSE = DS + kB * kLdF;     // [64]
  float* DD = LSE + kB;            // [64]
  int* QSeg = reinterpret_cast<int*>(DD + kB);  // [64]
  int* KSeg = QSeg + kB;                        // [64]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int NT = (S + kB - 1) / kB;
  const int qt = NT - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, q0 = qt * kB;
  const size_t ldq = (size_t)nh * HD, ldk = (size_t)nkv * HD;
  const size_t qoff = (size_t)b * S * ldq + (size_t)h * HD;
  const size_t kvoff = (size_t)b * S * ldk + (size_t)(h / (nh / nkv)) * HD;
  const size_t rb = ((size_t)b * nh + h) * S;
  load_f32<HD>(Qt, nullptr, q + qoff, ldq, q0, S, tid);
  load_f32<HD>(Gt, nullptr, dout + qoff, ldq, q0, S, tid);
  if (tid < kB) {
    const bool in = q0 + tid < S;
    LSE[tid] = in ? lse[rb + q0 + tid] : 0.f;
    DD[tid] = in ? dd[rb + q0 + tid] : 0.f;
    QSeg[tid] = in ? qseg[(size_t)b * S + q0 + tid] : 0;
  }
  float acc[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kC; ++j) acc[i][j] = 0.f;

  const int nkt = causal ? qt + 1 : NT;
  __shared__ SegTiles tiles;
  seg_own_ids(tiles, qseg + (size_t)b * S, q0, S, tid);
  seg_mark_live(tiles, kseg + (size_t)b * S, 0, nkt, S, tid, 256);
  for (int kt = seg_next_live(tiles, 0, nkt); kt < nkt;
       kt = seg_next_live(tiles, kt + 1, nkt)) {
    const int k0 = kt * kB;
    __syncthreads();  // previous tile's Kt / Vt / Kr / DS / KSeg are free
    load_f32<HD>(Kt, Kr, k + kvoff, ldk, k0, S, tid);
    load_f32<HD>(Vt, nullptr, v + kvoff, ldk, k0, S, tid);
    if (tid < kB) KSeg[tid] = k0 + tid < S ? kseg[(size_t)b * S + k0 + tid]
                                           : 0;
    __syncthreads();
    float s[4][4], dp[4][4];
    fma_tile<HD>(s, Qt, Kt, ty, tx);
    fma_tile<HD>(dp, Gt, Vt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j, row = q0 + r, key = k0 + c;
        const bool ok = row < S && key < S && KSeg[c] == QSeg[r] &&
                        (!causal || key <= row);
        const float p = ok ? expf(s[i][j] * scale - LSE[r]) : 0.f;
        DS[r * kLdF + c] = p * (dp[i][j] - DD[r]);
      }
    }
    __syncthreads();
    fma_out<HD>(acc, DS, Kr, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < kC; ++j)
      dq[qoff + (size_t)row * ldq + tx * kC + j] = acc[i][j] * scale;
  }
}

template <int HD>
constexpr size_t dkv_f32_smem() {
  return sizeof(float) * (size_t)(4 * HD * kLdF + 2 * kB * (HD + 4) +
                                  kB * kLdF + 4 * kB);
}

// grid (ceil(S / 64), nkv, B): dk and dv of 64 keys of one kv head
template <int HD>
__global__ void __launch_bounds__(256, 1)
    llm_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const int* __restrict__ qseg,
                    const int* __restrict__ kseg,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd, float* __restrict__ dk,
                    float* __restrict__ dv, int S, int nh, int nkv,
                    int causal, float scale) {
  constexpr int kC = HD / 16;
  extern __shared__ __align__(16) float sm[];
  float* Kt = sm;                  // [HD][kLdF] keys
  float* Vt = Kt + HD * kLdF;      // [HD][kLdF]
  float* Qt = Vt + HD * kLdF;      // [HD][kLdF] q of the query tile
  float* Gt = Qt + HD * kLdF;      // [HD][kLdF] do
  float* Qr = Gt + HD * kLdF;      // [64 q][HD + 4]
  float* Gr = Qr + kB * (HD + 4);  // [64 q][HD + 4]
  float* PT = Gr + kB * (HD + 4);  // [64 keys][kLdF]: p, then ds
  float* LSE = PT + kB * kLdF;     // [64]
  float* DD = LSE + kB;            // [64]
  int* QSeg = reinterpret_cast<int*>(DD + kB);  // [64]
  int* KSeg = QSeg + kB;                        // [64]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int NT = (S + kB - 1) / kB;
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z, k0 = kt * kB;
  const int group = nh / nkv;
  const size_t ldq = (size_t)nh * HD, ldk = (size_t)nkv * HD;
  const size_t kvoff = (size_t)b * S * ldk + (size_t)hk * HD;
  const int qt0 = causal ? kt : 0;
  __shared__ SegTiles tiles;
  seg_own_ids(tiles, kseg + (size_t)b * S, k0, S, tid);
  seg_mark_live(tiles, qseg + (size_t)b * S, qt0, NT, S, tid, 256);
  load_f32<HD>(Kt, nullptr, k + kvoff, ldk, k0, S, tid);
  load_f32<HD>(Vt, nullptr, v + kvoff, ldk, k0, S, tid);
  if (tid < kB) KSeg[tid] = k0 + tid < S ? kseg[(size_t)b * S + k0 + tid] : 0;
  float adk[4][kC], adv[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kC; ++j) adk[i][j] = adv[i][j] = 0.f;

  // the (head of the group, live query tile) pairs, in order
  for (int jh = 0; jh < group; ++jh)
    for (int qt = seg_next_live(tiles, qt0, NT); qt < NT;
         qt = seg_next_live(tiles, qt + 1, NT)) {
      const int h = hk * group + jh, q0 = qt * kB;
      const size_t qoff = (size_t)b * S * ldq + (size_t)h * HD;
      const size_t rb = ((size_t)b * nh + h) * S;
      __syncthreads();  // previous pair's operands are free
      load_f32<HD>(Qt, Qr, q + qoff, ldq, q0, S, tid);
      load_f32<HD>(Gt, Gr, dout + qoff, ldq, q0, S, tid);
      if (tid < kB) {
        const bool in = q0 + tid < S;
        LSE[tid] = in ? lse[rb + q0 + tid] : 0.f;
        DD[tid] = in ? dd[rb + q0 + tid] : 0.f;
        QSeg[tid] = in ? qseg[(size_t)b * S + q0 + tid] : 0;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      fma_tile<HD>(s, Kt, Qt, ty, tx);   // rows = keys, columns = queries
      fma_tile<HD>(dp, Vt, Gt, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kc = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = tx * 4 + j, key = k0 + kc, row = q0 + qi;
          const bool ok = key < S && row < S && QSeg[qi] == KSeg[kc] &&
                          (!causal || row >= key);
          const float p = ok ? expf(s[i][j] * scale - LSE[qi]) : 0.f;
          PT[kc * kLdF + qi] = p;
          dp[i][j] = p * (dp[i][j] - DD[qi]);
        }
      }
      __syncthreads();
      fma_out<HD>(adv, PT, Gr, ty, tx);
      __syncthreads();  // every thread has read p
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          PT[(ty * 4 + i) * kLdF + tx * 4 + j] = dp[i][j];
      __syncthreads();
      fma_out<HD>(adk, PT, Qr, ty, tx);
    }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= S) continue;
    const size_t r = kvoff + (size_t)key * ldk + tx * kC;
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      dk[r + j] = adk[i][j] * scale;
      dv[r + j] = adv[i][j];
    }
  }
}

// ---- bf16: wgmma + TMA (see the note at the top) -------------------------

constexpr int kBwdStages = 3;
constexpr int kBwdThreads = 384;  // two consumer warpgroups + a producer

// The block's shared memory: 1024 bytes to align the tiles; k then v of the
// block's 64 keys (two halves each); the stages, each q then do of 64
// queries; p^T twice then ds^T twice, [64 keys][64 queries] bf16 in the
// 128-byte swizzle; each warpgroup's dq partial [64 x D/2] f32 (in the
// scratch's fragment order); the stages' lse (times log2 e), dd and query segment
// ids [kBwdStages][64] each; the mbarriers (full and empty a stage, one for
// k and v).
template <int D>
struct BwdLayout {
  using T = LlmTiles<D>;
  static constexpr int kKV = 2 * T::kTile;
  static constexpr int kStage = 2 * T::kTile;
  static constexpr int kPD = kLlmTile * 128;
  static constexpr int kDq = kLlmTile * T::kHalf * 4;  // a dq partial
  static constexpr int kMeta = 3 * kBwdStages * kLlmTile * 4;
  static constexpr int kSmem = 1024 + kKV + kBwdStages * kStage + 4 * kPD +
                               2 * kDq + kMeta + (2 * kBwdStages + 1) * 8;
  static_assert(kSmem <= 232448, "one block");
};

struct LlmBwdMaps {
  CUtensorMap q, k, v, g;
};

// grid (nkv * ceil(S / 64), B), kBwdThreads threads; q, k, v, do through
// maps (3-D: columns, S, B); lse, dd [B, nh, S]; dq_acc f32, zeroed, in
// chunks [B][nh][ceil(S / 64)][2 halves of D][64 x D/2] in fragment order
// (llm_bwd_convert); dk, dv [B, S, nkv, D]
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    llm_bwd_sm90(const __grid_constant__ LlmBwdMaps maps,
                 const int* __restrict__ qseg, const int* __restrict__ kseg,
                 const float* __restrict__ lse, const float* __restrict__ dd,
                 float* __restrict__ dq_acc, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int S, int nh, int nkv, int causal,
                 float scale) {
  using T = LlmTiles<D>;
  using L = BwdLayout<D>;
  constexpr int kH = T::kHalf, kW = T::kRowBytes, kHB = T::kHalfBytes;
  constexpr int kAcc = kH / 2;  // accumulator registers of a half's product
  extern __shared__ unsigned char smraw[];
  unsigned char* base = align1024(smraw);
  unsigned char* ktile = base;                         // halves 0, 1
  unsigned char* vtile = base + T::kTile;
  unsigned char* stages = base + L::kKV;               // [s]: q, do
  unsigned char* pds = stages + kBwdStages * L::kStage;  // p^T x2, ds^T x2
  float* dqs = reinterpret_cast<float*>(pds + 4 * L::kPD);  // [wg][64 D/2]
  float* lse2s = dqs + 2 * kLlmTile * kH;                    // [s][64]
  float* dds = lse2s + kBwdStages * kLlmTile;
  int* qsegs = reinterpret_cast<int*>(dds + kBwdStages * kLlmTile);
  uint64_t* full = reinterpret_cast<uint64_t*>(qsegs + kBwdStages * kLlmTile);
  uint64_t* empty = full + kBwdStages;
  uint64_t* kvbar = empty + kBwdStages;
  const auto q_half = [&](int s, int hf) {
    return stages + s * L::kStage + hf * kHB;
  };
  const auto g_half = [&](int s, int hf) {
    return stages + s * L::kStage + T::kTile + hf * kHB;
  };
  __shared__ SegTiles tiles;

  const int tid = threadIdx.x, wg = tid / 128;
  const int hk = blockIdx.x % nkv, b = blockIdx.y;
  const int k0 = blockIdx.x / nkv * kB;
  const int NT = (S + kB - 1) / kB;
  const int group = nh / nkv;
  const int* qsb = qseg + (size_t)b * S;
  const int* ksb = kseg + (size_t)b * S;
  const int qt0 = causal ? k0 / kB : 0;
  if (tid == 0) {  // k and v load while the block finds its query tiles
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 1 + kB);  // the TMA's expect_tx + 64 copiers
      mbar_init(&empty[s], 2);      // released by both warpgroups
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(kvbar, 2 * T::kTile);
    for (int hf = 0; hf < 2; ++hf) {
      tma_load_3d(ktile + hf * kHB, &maps.k, kvbar, hk * D + hf * kH, k0, b);
      tma_load_3d(vtile + hf * kHB, &maps.v, kvbar, hk * D + hf * kH, k0, b);
    }
  }
  seg_own_ids(tiles, ksb, k0, S, tid);  // synchronises: the barriers exist
  seg_mark_live<4>(tiles, qsb, qt0, NT, S, tid, kBwdThreads);

  if (wg == 2) {  // the producer warpgroup: its first 64 threads work
    producer_registers();
    const int p = tid - 256;
    if (p >= kB) return;
    int i = 0;
    for (int h = hk * group; h < (hk + 1) * group; ++h)
    for (int qt = seg_next_live(tiles, qt0, NT); qt < NT;
         qt = seg_next_live(tiles, qt + 1, NT), ++i) {
      const float* lse_h = lse + ((size_t)b * nh + h) * S;
      const float* dd_h = dd + ((size_t)b * nh + h) * S;
      const int s = i % kBwdStages, ph = (i / kBwdStages) & 1;
      mbar_wait(&empty[s], ph ^ 1);
      const int q0 = qt * kB;
      if (p == 0) {
        mbar_expect_tx(&full[s], 2 * T::kTile);
        for (int hf = 0; hf < 2; ++hf) {
          tma_load_3d(q_half(s, hf), &maps.q, &full[s], h * D + hf * kH, q0,
                      b);
          tma_load_3d(g_half(s, hf), &maps.g, &full[s], h * D + hf * kH, q0,
                      b);
        }
      }
      const int r = q0 + p;
      const bool in = r < S;
      lse2s[s * kB + p] = in ? lse_h[r] * kLlmLog2e : 0.f;
      dds[s * kB + p] = in ? dd_h[r] : 0.f;
      qsegs[s * kB + p] = in ? qsb[r] : 0;
      mbar_arrive(&full[s]);
    }
    return;
  }
  consumer_registers();

  // consumer warpgroup wg: a thread holds keys (rows) g and g + 8 of its
  // warp's 16; of a query tile, queries 32 wg + 8 j + 2 t, + 1 (j < 4) in
  // S^T and dP^T; of the outputs, columns wg D/2 + 8 j + 2 t, + 1
  const int t128 = tid & 127, lane = tid & 31, wr = t128 >> 5;
  const int g = lane >> 2, t = lane & 3;
  int kl[2], key[2], kid[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    kl[hf] = wr * 16 + g + 8 * hf;
    key[hf] = k0 + kl[hf];
    kid[hf] = key[hf] < S ? ksb[key[hf]] : 0;
  }
  const float sl = scale * kLlmLog2e;
  float sacc[16], dpacc[16], dvacc[kAcc], dkacc[kAcc], dqacc[kAcc];
#pragma unroll
  for (int c = 0; c < 16; ++c) sacc[c] = dpacc[c] = 0.f;
#pragma unroll
  for (int c = 0; c < kAcc; ++c) dvacc[c] = dkacc[c] = dqacc[c] = 0.f;
  // the accumulators are only ever defined by the products from here on
  const auto fence_acc = [&] {
    reg_fence(sacc);
    reg_fence(dpacc);
    reg_fence(dvacc);
    reg_fence(dkacc);
    reg_fence(dqacc);
  };
  mbar_wait(kvbar, 0);

  int i = 0;
  for (int h = hk * group; h < (hk + 1) * group; ++h)
  for (int qt = seg_next_live(tiles, qt0, NT); qt < NT;
       qt = seg_next_live(tiles, qt + 1, NT), ++i) {
    const int s = i % kBwdStages, ph = (i / kBwdStages) & 1, buf = i & 1;
    const int q0 = qt * kB;
    mbar_wait(&full[s], ph);
    // S^T = k q^T and dP^T = v do^T against this warpgroup's 32 queries
    fence_acc();
    wgmma_fence();
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int ks = 0; ks < kH / 16; ++ks) {
        wgmma_n32_ss<0, 0>(sacc, swz_desc<kW>(ktile + hf * kHB + 32 * ks),
                           swz_desc<kW>(q_half(s, hf) + wg * 32 * kW + 32 * ks),
                           hf + ks > 0);
        wgmma_n32_ss<0, 0>(dpacc, swz_desc<kW>(vtile + hf * kHB + 32 * ks),
                           swz_desc<kW>(g_half(s, hf) + wg * 32 * kW + 32 * ks),
                           hf + ks > 0);
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc();

    // p^T and ds^T, a pair of queries at a time, rounded once into the
    // shared tiles (row kl, 16-byte chunk q / 8 swizzled by kl & 7)
    const float* ls = lse2s + s * kB;
    const float* dl = dds + s * kB;
    const int* qs = qsegs + s * kB;
    unsigned char* pt = pds + buf * L::kPD;
    unsigned char* dt = pds + (2 + buf) * L::kPD;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ql = wg * 32 + 8 * j + 2 * t;
      const float2 lv = *reinterpret_cast<const float2*>(ls + ql);
      const float2 dv = *reinterpret_cast<const float2*>(dl + ql);
      const int2 sg = *reinterpret_cast<const int2*>(qs + ql);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qrow = q0 + ql + e, c = 4 * j + 2 * hf + e;
          const bool ok = key[hf] < S && qrow < S &&
                          (e ? sg.y : sg.x) == kid[hf] &&
                          (!causal || key[hf] <= qrow);
          p[e] = ok ? ex2_ftz(fmaf(sacc[c], sl, -(e ? lv.y : lv.x))) : 0.f;
          ds[e] = p[e] * (dpacc[c] - (e ? dv.y : dv.x));
        }
        const int off =
            kl[hf] * 128 + (((ql >> 3) ^ (kl[hf] & 7)) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(pt + off) = pack_bf16(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(dt + off) = pack_bf16(ds[0], ds[1]);
      }
    }
    fence_proxy_async();
    named_bar_sync(1, 256);  // both warpgroups' queries written

    // dV += P^T do, dK += dS^T q on columns wg D/2 ..; dQ = dS k likewise
    fence_acc();
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wgmma_ss<kH, 0, 1>(dvacc, swz_desc<128>(pt + 32 * ks),
                         swz_desc<kW>(g_half(s, wg) + ks * 16 * kW), 1);
      wgmma_ss<kH, 0, 1>(dkacc, swz_desc<128>(dt + 32 * ks),
                         swz_desc<kW>(q_half(s, wg) + ks * 16 * kW), 1);
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss<kH, 1, 1>(dqacc, swz_desc<128>(dt + ks * 16 * 128),
                         swz_desc<kW>(ktile + wg * kHB + ks * 16 * kW),
                         ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc();
    if (t128 == 0) mbar_arrive(&empty[s]);
    // this warpgroup's dq partial, staged in shared memory in fragment
    // order, added to its scratch chunk by one bulk reduction
    float* stage_dq = dqs + wg * kLlmTile * kH;
    if (t128 == 0) bulk_wait_read<0>();  // the last reduction has read it
    named_bar_sync(2 + wg, 128);
#pragma unroll
    for (int j = 0; j < kH / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(stage_dq +
                                   ((j * 2 + hf) * 128 + t128) * 2) =
            make_float2(dqacc[4 * j + 2 * hf], dqacc[4 * j + 2 * hf + 1]);
    fence_proxy_async();
    named_bar_sync(2 + wg, 128);
    if (t128 == 0) {
      const size_t chunk = (((size_t)b * nh + h) * NT + qt) * 2 + wg;
      bulk_reduce_add_f32(dq_acc + chunk * kLlmTile * kH, stage_dq,
                          kLlmTile * kH * 4);
      bulk_commit();
    }
  }
  if (t128 == 0) bulk_wait<0>();
  // dk (times D^-1/2) and dv of the block's keys, summed over the group
  const size_t ldk = (size_t)nkv * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (key[hf] >= S) continue;
    const size_t off = ((size_t)b * S + key[hf]) * ldk + (size_t)hk * D +
                       wg * kH + 2 * t;
#pragma unroll
    for (int j = 0; j < kH / 8; ++j) {
      const int c = 4 * j + 2 * hf;
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
          __floats2bfloat162_rn(dkacc[c] * scale, dkacc[c + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
          __floats2bfloat162_rn(dvacc[c], dvacc[c + 1]);
    }
  }
}

// dq [B, S, nh, D] = bf16(acc * scale) from the scratch's chunks, eight
// values (16 bytes of a row) a thread a step. Pair u of chunk c (b, h,
// query tile, half w) is thread t128 = u % 128's columns 8 j + 2 t, + 1 of
// row g + 8 hf of its warp's 16, (j, hf) = (u / 256, u / 128 % 2): pairs
// 4 n .. 4 n + 3 are columns 8 j .. 8 j + 7 of one row. Neighbouring
// threads take neighbouring j, so a row's half is written whole.
__global__ void __launch_bounds__(256)
    llm_bwd_convert(const float4* __restrict__ acc, bf16* __restrict__ dq,
                    int B, int S, int nh, int D, float scale) {
  const int half = D / 2, nj = half / 8, octs = 8 * half;  // runs a chunk
  const int NT = (S + 63) / 64;
  const long long n = (long long)B * nh * NT * 2 * octs;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long c = i / octs;
    const int o = (int)(i - c * octs);
    const int j = o % nj, r = o / nj;  // r = hf * 32 + t128 / 4
    const int hf = r >> 5, t128 = (r & 31) * 4;
    const int w = (int)(c & 1), qt = (int)((c >> 1) % NT);
    const long long bh = (c >> 1) / NT;
    const int row = qt * 64 + (t128 >> 5) * 16 + ((t128 & 31) >> 2) + 8 * hf;
    if (row >= S) continue;
    const long long at = 2 * (c * octs + ((j * 2 + hf) * 128 + t128) / 4);
    const float4 a = acc[at], e = acc[at + 1];
    *reinterpret_cast<uint4*>(
        dq + (((bh / nh) * S + row) * nh + bh % nh) * D + w * half + 8 * j) =
        make_uint4(pack_bf16(a.x * scale, a.y * scale),
                   pack_bf16(a.z * scale, a.w * scale),
                   pack_bf16(e.x * scale, e.y * scale),
                   pack_bf16(e.z * scale, e.w * scale));
  }
}

template <class K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int HD>
int launch_sm90(const bf16* q, const bf16* k, const bf16* v, const int* qseg,
                const int* kseg, const bf16* dout, const float* lse,
                const float* dd, bf16* dq, bf16* dk, bf16* dv, float* scratch,
                int B, int S, int nh, int nkv, int causal, float scale,
                cudaStream_t st) {
  if (!scratch) return (int)cudaErrorInvalidValue;
  LlmBwdMaps maps;
  const long long cq = (long long)nh * HD, ck = (long long)nkv * HD;
  if (!make_llm_map(&maps.q, q, B, S, cq, HD / 2) ||
      !make_llm_map(&maps.k, k, B, S, ck, HD / 2) ||
      !make_llm_map(&maps.v, v, B, S, ck, HD / 2) ||
      !make_llm_map(&maps.g, dout, B, S, cq, HD / 2))
    return (int)cudaErrorInvalidValue;
  const long long nq = (long long)B * nh * ((S + kB - 1) / kB) * kB * HD;
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(float) * nq, st);
  if (err != cudaSuccess) return (int)err;
  constexpr int smem = BwdLayout<HD>::kSmem;
  static const int attr = set_smem(llm_bwd_sm90<HD>, smem);
  if (attr) return attr;
  const dim3 grid(nkv * ((S + kB - 1) / kB), B);
  llm_bwd_sm90<HD><<<grid, kBwdThreads, smem, st>>>(
      maps, qseg, kseg, lse, dd, scratch, dk, dv, S, nh, nkv, causal, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  llm_bwd_convert<<<132 * 8, 256, 0, st>>>(
      reinterpret_cast<const float4*>(scratch), dq, B, S, nh, HD, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v,
           const int* qseg, const int* kseg, const void* dout,
           const float* lse, const float* dd, void* dq, void* dk, void* dv,
           float* scratch, int B, int S, int nh, int nkv, int causal,
           float scale, cudaStream_t st) {
  if (dtype == kF32) {
    using F = const float*;
    const int NT = (S + kB - 1) / kB;
    const dim3 gq(NT, nh, B), gkv(NT, nkv, B);
    int e;
    if ((e = set_smem(llm_bwd_dq_f32<HD>, dq_f32_smem<HD>()))) return e;
    llm_bwd_dq_f32<HD><<<gq, 256, dq_f32_smem<HD>(), st>>>(
        F(q), F(k), F(v), qseg, kseg, F(dout), lse, dd,
        static_cast<float*>(dq), S, nh, nkv, causal, scale);
    if ((e = (int)cudaGetLastError())) return e;
    if ((e = set_smem(llm_bwd_dkv_f32<HD>, dkv_f32_smem<HD>()))) return e;
    llm_bwd_dkv_f32<HD><<<gkv, 256, dkv_f32_smem<HD>(), st>>>(
        F(q), F(k), F(v), qseg, kseg, F(dout), lse, dd,
        static_cast<float*>(dk), static_cast<float*>(dv), S, nh, nkv, causal,
        scale);
    return (int)cudaGetLastError();
  }
  if (dtype == kBF16) {
    using H = const bf16*;
    return launch_sm90<HD>(H(q), H(k), H(v), qseg, kseg, H(dout), lse, dd,
                           static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                           static_cast<bf16*>(dv), scratch, B, S, nh, nkv,
                           causal, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ullsam

// Plain C entry point (loaded with ctypes). Returns 0 or a cudaError_t.
// dtype: 0 = float32, 1 = bfloat16 for q, k, v, do, dq, dk, dv; q_seg,
// kv_seg int32 [B, S]; lse, dd float32 [B, nh, S]; scale D^-1/2 (f32). In
// bf16, scratch is B S nh D floats (zeroed here, then dq's f32 sum);
// float32 takes none. Requires D in {64, 128},
// nh % nkv == 0, S <= 64 * kMaxSegTiles and 16-byte aligned tensors.
extern "C" int llm_flash_attn_backward(
    int dtype, const void* q, const void* k, const void* v,
    const void* q_seg, const void* kv_seg, const void* dout, const void* lse,
    const void* dd, void* dq, void* dk, void* dv, void* scratch, int B, int S,
    int nh, int nkv, int D, int causal, float scale, void* stream) {
  using namespace ullsam;
  if (B < 1 || S < 1 || S > kSegTile * kMaxSegTiles || nkv < 1 ||
      nh % nkv != 0 || B > 65535 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* qs = static_cast<const int*>(q_seg);
  const int* ks = static_cast<const int*>(kv_seg);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dd);
  float* acc = static_cast<float*>(scratch);
  if (D == 64)
    return launch<64>(dtype, q, k, v, qs, ks, dout, l, d, dq, dk, dv, acc, B,
                      S, nh, nkv, causal, scale, st);
  if (D == 128)
    return launch<128>(dtype, q, k, v, qs, ks, dout, l, d, dq, dk, dv, acc,
                       B, S, nh, nkv, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
