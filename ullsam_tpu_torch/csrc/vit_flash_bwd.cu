// B9: gradient of the ViT global flash attention (B2) for Hopper (sm_90a).
//
// Replaces the TPU kernels ullsam_tpu/ops/pallas/flash_attention.py
// `_vit_bwd_dq_kernel` and `_vit_bwd_dkv_kernel` (via `_vit_flash_bwd_impl`).
// With bias[i, key] = rel_h[i, key / KW] + rel_w[i, key % KW], the forward's
// row logsumexp lse and dd = rowsum(do * o) (computed by the caller), it
// scores as the TPU kernels do, from unscaled q (:824-827):
//     s = f32(q k^T) * D^-1/2 + bias,  p = exp(s - lse),
//     ds = p (do v^T - dd)
//     dq = (ds k) * D^-1/2,  dk = (ds^T q) * D^-1/2,  dv = p^T do
//     drel_h[i, r] = sum_c ds[i, r*KW + c],  drel_w[i, c] = sum_r ds[i, ..]
// p and ds are rounded to the input dtype before their products; every sum
// is f32; drel is f32. (B2 scores with cast(q * D^-1/2), as the TPU forward
// does; the two agree bitwise at D = 64, where the scale is a power of two,
// and not at 80.)
//
// What bounds it on this card: operations. The gradient needs 5 products of
// 2 N^2 D per head (s, dp, dv, dq, dk): at the ViT-B global blocks (BH = 12,
// N = 4096, D = 64) ~129 GFLOP, at ViT-H's (BH = 16, D = 80) ~215 GFLOP,
// against ~50 / ~80 MB. Two kernels, as on the TPU, so that neither needs
// atomics and every call gives bitwise the same result; they do 7 products
// (s and dp in both), 7/5 of the needed work:
//   * dq + drel, query-major: a block owns 128 queries and walks the key
//     tiles. KW divides 64, so a 64-key tile is 64 / KW whole key-grid rows:
//     drel_h[:, row] is a row sum of the tile's ds (written once, no
//     accumulation), and drel_w accumulates ds in registers, one slot per
//     (row, key % 64), folded to key % KW at the end in a fixed order.
//   * dk + dv, key-major: a block owns 128 keys (128 / KW key-grid rows) and
//     walks the query tiles; its bias needs only those rows' rel_h columns
//     and the query tile's rel_w rows.
//
// bf16 (vit_bwd_dq_sm90, vit_bwd_dkv_sm90): B2's Hopper shape
// (flash_sm90.cuh: 64-row tiles, at D = 80 a 32-byte-swizzled 16-column
// tail). A block is two consumer warpgroups of 64 rows and a producer
// warpgroup that gives its registers to them (setmaxnreg 40 / 232) and
// streams tiles by TMA through a ring of kBwdStages stages (full / empty
// mbarriers, both consumers release a stage).
//   * dq: q and do of the block's 128 queries land once and are held as
//     register A operands. Per key tile, S = q k^T and dP = do v^T on wgmma
//     m64n64k16 (k and v K-major from the stage), p and ds in f32 registers
//     in the accumulator layout, ds rounded to bf16 once, a pair at a time,
//     into wgmma's register A operand of dQ += ds k (k read MN-major). The
//     drel sums add the rounded ds in registers: rel_h is one value a row a
//     tile and rel_w's pair for keys 8 i + 2 t, + 1 one 4-byte load (key %
//     KW, a fixed slot of the accumulator layout).
//   * dkv: k and v of the block's 128 keys land once and are held as
//     register A operands. Per query tile the stage holds q and do (TMA)
//     and, copied by the producer's threads, the tile's rel_w transposed (a
//     thread's two queries one 4-byte load), the block's rel_h columns, lse
//     and dd; S^T = k q^T and dP^T = v do^T on wgmma, then dV += P^T do and
//     dK += dS^T q with P^T and dS^T as register A operands.
//   * A tile's register-A products and the next tile's S and dP are issued
//     together and waited on together, so the tensor cores run them back to
//     back while the other warpgroup computes its p and ds. The
//     accumulators are pinned around each wgmma stage (reg_fence), so
//     ptxas does not serialize the products (C7515), and p comes from the
//     special-function unit's 2^x with subnormals flushed (ex2_ftz).
// On an H100 (PERF.md section 6) the pair runs at 200-240 TFLOP/s of its 7
// products, 2.1x the earlier mma.sync pair; fewer CUDA-core instructions a
// logit moved it most (reg_fence 6%, q / do / k / v in registers 2%, the
// paired loads and ex2_ftz 10%, one rounding a pair 3%); the warpgroups
// issuing in turns (FlashAttention-3's ping-pong) ran 12% slower.
// float32 stays true f32 FMA on the CUDA cores, no TF32 (the JAX f32 path is
// the exact-parity one; flash_attention.py:837-839): 256 threads, a 4 x 4
// block of the 64 x 64 score tile each and 4 x D/16 of the output, bounded
// by the 67 TFLOP/s f32 rate. Head dims 64 (SAM ViT-B / L) and 80 (ViT-H)
// in both dtypes.
#include "flash_sm90.cuh"

namespace ullsam {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kB = 64;           // f32: query / key tile
constexpr int kLdF = kB + 4;     // f32: d-major and score-tile row stride
constexpr float kLog2e = 1.4426950408889634f;

// ---- float32: FMA on the CUDA cores ---------------------------------------
// 256 threads; thread (ty, tx) = (tid / 16, tid % 16) holds a 4 x 4 block of
// the 64 x 64 score tile (rows 4 ty.., columns 4 tx..) and a 4 x kCols block
// of its 64 x D output (rows 4 ty.., channels kCols tx..). Operands of the
// score products sit d-major ([D][kLdF], one row per channel), operands of
// the output products row-major ([64][kLdR]).
template <int D>
struct BwdF32 {
  static_assert(D == 64 || D == 80, "head dims 64 and 80");
  static constexpr int kCols = D / 16;
  static constexpr int kLdR = D + 4;
  // must match ops/kernels/flash_attention.py bwd_f32_smem_bytes
  static constexpr size_t kDqSmem =
      sizeof(float) * (size_t)(4 * D * kLdF + kB * kLdR + kB * kLdF +
                               2 * kB * 65 + 2 * kB);
  static constexpr size_t kDkvSmem =
      sizeof(float) * (size_t)(4 * D * kLdF + 2 * kB * kLdR + 2 * kB * kLdF +
                               kB * 65 + kB * kB / 8 + 2 * kB);
  static_assert(kDqSmem <= 232448 && kDkvSmem <= 232448, "one block");
};

template <int D>
__device__ __forceinline__ void fma_tile(float (&s)[4][4], const float* at,
                                         const float* bt, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(at + d * kLdF + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(bt + d * kLdF + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[4][kCols] += P[4 ty.., :] ([64][kLdF]) . B[:, kCols tx..] ([64][kLdR])
template <int D>
__device__ __forceinline__ void fma_out(float (&acc)[4][BwdF32<D>::kCols],
                                        const float* P, const float* B,
                                        int ty, int tx) {
  constexpr int kCols = BwdF32<D>::kCols, kLdR = BwdF32<D>::kLdR;
#pragma unroll 8
  for (int m = 0; m < kB; ++m) {
    float bv[kCols];
    const float* br = B + m * kLdR + tx * kCols;
    if constexpr (kCols == 4) {
      const float4 b = *reinterpret_cast<const float4*>(br);
      bv[0] = b.x, bv[1] = b.y, bv[2] = b.z, bv[3] = b.w;
    } else {
#pragma unroll
      for (int u = 0; u < kCols; ++u) bv[u] = br[u];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = P[(ty * 4 + i) * kLdF + m];
#pragma unroll
      for (int u = 0; u < kCols; ++u) acc[i][u] = fmaf(p, bv[u], acc[i][u]);
    }
  }
}

// 64 rows x D of a global [rows][D] f32 array into smem, d-major and/or
// row-major (either may be null)
template <int D>
__device__ __forceinline__ void load_f32(float* dmaj, float* rmaj,
                                         const float* src, int tid) {
  for (int e = tid; e < kB * D; e += 256) {
    const int r = e / D, d = e % D;
    const float x = src[(size_t)r * D + d];
    if (dmaj) dmaj[d * kLdF + r] = x;
    if (rmaj) rmaj[r * BwdF32<D>::kLdR + d] = x;
  }
}

// grid (N / 64, BH): dq and drel of 64 query rows
template <int D>
__global__ void __launch_bounds__(256)
    vit_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ rel_h,
                   const float* __restrict__ rel_w,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dd, float* __restrict__ dq,
                   float* __restrict__ drel_h, float* __restrict__ drel_w,
                   int N, int KH, int KW, float scale) {
  constexpr int kCols = BwdF32<D>::kCols, kLdR = BwdF32<D>::kLdR;
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;                  // [D][kLdF] q
  float* Gt = Qt + D * kLdF;       // [D][kLdF] do
  float* Kt = Gt + D * kLdF;       // [D][kLdF]
  float* Vt = Kt + D * kLdF;       // [D][kLdF]
  float* Kr = Vt + D * kLdF;       // [64 keys][kLdR]
  float* DS = Kr + kB * kLdR;      // [64 rows][kLdF]
  float* RH = DS + kB * kLdF;      // [64][65]
  float* RW = RH + kB * 65;        // [64][65]
  float* LSE = RW + kB * 65;       // [64]
  float* DD = LSE + kB;            // [64]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, q0 = blockIdx.x * kB;
  const size_t base = (size_t)bh * N * D, rb = (size_t)bh * N + q0;
  load_f32<D>(Qt, nullptr, q + base + (size_t)q0 * D, tid);
  load_f32<D>(Gt, nullptr, dout + base + (size_t)q0 * D, tid);
  for (int e = tid; e < kB * KH; e += 256)
    RH[(e / KH) * 65 + e % KH] = rel_h[rb * KH + e];
  for (int e = tid; e < kB * KW; e += 256)
    RW[(e / KW) * 65 + e % KW] = rel_w[rb * KW + e];
  if (tid < kB) {
    LSE[tid] = lse[rb + tid];
    DD[tid] = dd[rb + tid];
  }
  const int rpt = kB / KW, tpr = KW / 4;  // grid rows a tile, threads a row
  float acc[4][kCols], drw[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) drw[i][j] = 0.f;
  }

  for (int kt = 0; kt < N / kB; ++kt) {
    __syncthreads();  // previous tile's Kt / Vt / Kr / DS are free
    load_f32<D>(Kt, Kr, k + base + (size_t)kt * kB * D, tid);
    load_f32<D>(Vt, nullptr, v + base + (size_t)kt * kB * D, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
    fma_tile<D>(s, Qt, Kt, ty, tx);
    fma_tile<D>(dp, Gt, Vt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        const float p = expf(s[i][j] * scale + (RH[r * 65 + kt * rpt + c / KW] +
                                                RW[r * 65 + c % KW]) -
                             LSE[r]);
        const float ds = p * (dp[i][j] - DD[r]);
        DS[r * kLdF + c] = ds;
        drw[i][j] += ds;
        rs += ds;
      }
      // the tpr threads of one grid row (a run of tx) sum their shares
      for (int o = 1; o < tpr; o <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      if (tx % tpr == 0) drel_h[(rb + r) * KH + kt * rpt + tx / tpr] = rs;
    }
    __syncthreads();
    fma_out<D>(acc, DS, Kr, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t r = rb + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      dq[r * D + tx * kCols + j] = acc[i][j] * scale;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // threads tx and tx + tpr hold the same column: fold them
      float a = drw[i][j];
      for (int o = tpr; o < 16; o <<= 1)
        a += __shfl_xor_sync(0xffffffffu, a, o);
      if (tx < tpr) drel_w[r * KW + tx * 4 + j] = a;
    }
  }
}

// grid (N / 64, BH): dk and dv of the 64 keys of key-grid rows blockIdx.x *
// 64 / KW ..
template <int D>
__global__ void __launch_bounds__(256)
    vit_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ rel_h,
                    const float* __restrict__ rel_w,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd, float* __restrict__ dk,
                    float* __restrict__ dv, int N, int KH, int KW,
                    float scale) {
  constexpr int kCols = BwdF32<D>::kCols, kLdR = BwdF32<D>::kLdR;
  extern __shared__ __align__(16) float sm[];
  float* Kt = sm;                  // [D][kLdF] keys
  float* Vt = Kt + D * kLdF;       // [D][kLdF]
  float* Qt = Vt + D * kLdF;       // [D][kLdF] q of the query tile
  float* Gt = Qt + D * kLdF;       // [D][kLdF] do
  float* Qr = Gt + D * kLdF;       // [64 q][kLdR]
  float* Gr = Qr + kB * kLdR;      // [64 q][kLdR]
  float* PT = Gr + kB * kLdR;      // [64 keys][kLdF] p
  float* DT = PT + kB * kLdF;      // [64 keys][kLdF] ds
  float* RW = DT + kB * kLdF;      // [64 q][65]
  float* RHs = RW + kB * 65;       // [64 q][rpt]
  float* LSE = RHs + kB * kB / 8;  // [64]
  float* DD = LSE + kB;            // [64]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, k0 = blockIdx.x * kB;
  const int rpt = kB / KW, kr0 = k0 / KW;  // the block's key-grid rows
  const size_t base = (size_t)bh * N * D;
  load_f32<D>(Kt, nullptr, k + base + (size_t)k0 * D, tid);
  load_f32<D>(Vt, nullptr, v + base + (size_t)k0 * D, tid);
  float adk[4][kCols], adv[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) adk[i][j] = adv[i][j] = 0.f;

  for (int qt = 0; qt < N / kB; ++qt) {
    const size_t rb = (size_t)bh * N + (size_t)qt * kB;
    __syncthreads();  // previous tile's operands are free
    load_f32<D>(Qt, Qr, q + base + (size_t)qt * kB * D, tid);
    load_f32<D>(Gt, Gr, dout + base + (size_t)qt * kB * D, tid);
    for (int e = tid; e < kB * KW; e += 256)
      RW[(e / KW) * 65 + e % KW] = rel_w[rb * KW + e];
    for (int e = tid; e < kB * rpt; e += 256)
      RHs[e] = rel_h[(rb + e / rpt) * KH + kr0 + e % rpt];
    if (tid < kB) {
      LSE[tid] = lse[rb + tid];
      DD[tid] = dd[rb + tid];
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    fma_tile<D>(s, Kt, Qt, ty, tx);   // rows = keys, columns = queries
    fma_tile<D>(dp, Vt, Gt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kc = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = tx * 4 + j;
        const float p = expf(s[i][j] * scale + (RHs[qi * rpt + kc / KW] +
                                                RW[qi * 65 + kc % KW]) -
                             LSE[qi]);
        PT[kc * kLdF + qi] = p;
        DT[kc * kLdF + qi] = p * (dp[i][j] - DD[qi]);
      }
    }
    __syncthreads();
    fma_out<D>(adv, PT, Gr, ty, tx);
    fma_out<D>(adk, DT, Qr, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t r = base + (size_t)(k0 + ty * 4 + i) * D + tx * kCols;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      dk[r + j] = adk[i][j] * scale;
      dv[r + j] = adv[i][j];
    }
  }
}

// ---- bf16: wgmma + TMA (see the note at the top) -------------------------

constexpr int kBwdRows = 128;     // queries (dq) or keys (dkv) a block
constexpr int kBwdStages = 4;
constexpr int kBwdThreads = 384;  // two consumer warpgroups + a producer
constexpr int kBwdRelLd = 72;     // bf16 rel rows in shared memory (64 + 8)
constexpr int kBwdMaxRows = 16;   // key-grid rows of a dkv block (KW >= 8)

// The blocks' shared memory; must match ops/kernels/flash_attention.py
// bwd_sm90_smem_bytes. Every tile is a 64-row tile of flash_sm90.cuh, 1024-
// byte aligned.
// dq: q (two warpgroups' tiles, a then b), do likewise; the stages, each k
// a, v a, k b, v b; rel_h and rel_w rows [128][kBwdRelLd] bf16; full and
// empty mbarriers a stage, one for each warpgroup's q and do.
// dkv: k (two warpgroups' tiles), v likewise; the stages, each q a, do a,
// q b, do b, then rel_w [KW <= 64][kBwdRelLd] bf16 (key % KW major, the
// tile's queries along a row), rel_h columns
// [kBwdMaxRows][64] f32 (times log2 e), lse (times log2 e) and dd [64] f32,
// padded to 1024 bytes; full and empty a stage, one for each warpgroup's k
// and v.
template <int D>
struct BwdSm90Layout {
  using T = FlashTiles<D>;
  static constexpr int kTwoTiles = 2 * (T::kTileA + T::kTileB);
  static constexpr int kStageRel =
      kB * kBwdRelLd * 2 + kBwdMaxRows * kB * 4 + 2 * kB * 4;
  static constexpr int kDkvStage = (kTwoTiles + kStageRel + 1023) / 1024 * 1024;
  static constexpr int kBarriers = (2 * kBwdStages + 2) * 8;
  static constexpr int kDqSmem = 1024 + 2 * kTwoTiles + kBwdStages * kTwoTiles +
                                 2 * kBwdRows * kBwdRelLd * 2 + kBarriers;
  static constexpr int kDkvSmem =
      1024 + 2 * kTwoTiles + kBwdStages * kDkvStage + kBarriers;
  static_assert(kTwoTiles % 1024 == 0, "aligned tiles");
  static_assert(kDqSmem <= 232448 && kDkvSmem <= 232448, "one block");
};

// the TMA maps of q, k, v and do: [0] columns 0-63, [1] at D = 80 64-79
struct BwdMaps {
  CUtensorMap q[2], k[2], v[2], g[2];
};

// grid (ceil(N / 128), BH), kBwdThreads threads; q, k, v, do [BH, N, D]
// through `maps` (row bh N + i); rel_h [BH, N, KH], rel_w [BH, N, KW] bf16,
// lse, dd [BH, N] f32; KW = 64 / kRowsPerTile.
template <int D, int kRowsPerTile>
__global__ void __launch_bounds__(kBwdThreads, 1)
    vit_bwd_dq_sm90(const __grid_constant__ BwdMaps maps,
                    const bf16* __restrict__ rel_h,
                    const bf16* __restrict__ rel_w,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd, bf16* __restrict__ dq,
                    float* __restrict__ drel_h, float* __restrict__ drel_w,
                    int N, int KH, float scale) {
  using T = FlashTiles<D>;
  using L = BwdSm90Layout<D>;
  constexpr int kTail = T::kTail, kKW = kB / kRowsPerTile;
  constexpr int kA = T::kTileA, kBt = T::kTileB;
  extern __shared__ unsigned char smraw[];
  unsigned char* base = align1024(smraw);
  unsigned char* gbase = base + L::kTwoTiles;        // do
  unsigned char* stages = base + 2 * L::kTwoTiles;
  bf16* RH = reinterpret_cast<bf16*>(stages + kBwdStages * L::kTwoTiles);
  bf16* RW = RH + kBwdRows * kBwdRelLd;
  uint64_t* full = reinterpret_cast<uint64_t*>(RW + kBwdRows * kBwdRelLd);
  uint64_t* empty = full + kBwdStages;
  uint64_t* qbar = empty + kBwdStages;
  const auto ka = [&](int s) { return stages + s * L::kTwoTiles; };
  const auto va = [&](int s) { return ka(s) + kA; };
  const auto kb = [&](int s) { return ka(s) + 2 * kA; };
  const auto vb = [&](int s) { return kb(s) + kBt; };

  const int tid = threadIdx.x, wg = tid / 128;
  const int bh = blockIdx.y, q0 = blockIdx.x * kBwdRows;
  const int nwg = q0 + kB < N ? 2 : 1;  // N % 64 == 0
  const int NT = N / kB;
  const int row0 = bh * N;  // the head's first row in the maps
  if (tid == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], nwg);  // released by every warpgroup
    }
    mbar_init(&qbar[0], 1);
    mbar_init(&qbar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer warpgroup: one thread issues
    producer_registers();
    if (tid == 256) {
      for (int w = 0; w < nwg; ++w) {
        const int r = row0 + q0 + w * kB;
        mbar_expect_tx(&qbar[w], 2 * kB * D * 2);
        tma_load_2d(base + w * kA, &maps.q[0], &qbar[w], 0, r);
        tma_load_2d(gbase + w * kA, &maps.g[0], &qbar[w], 0, r);
        if constexpr (kTail > 0) {
          tma_load_2d(base + 2 * kA + w * kBt, &maps.q[1], &qbar[w], 64, r);
          tma_load_2d(gbase + 2 * kA + w * kBt, &maps.g[1], &qbar[w], 64, r);
        }
      }
      int s = 0, ph = 0;
      for (int kt = 0; kt < NT; ++kt) {
        const int r = row0 + kt * kB;
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], L::kTwoTiles);
        tma_load_2d(ka(s), &maps.k[0], &full[s], 0, r);
        tma_load_2d(va(s), &maps.v[0], &full[s], 0, r);
        if constexpr (kTail > 0) {
          tma_load_2d(kb(s), &maps.k[1], &full[s], 64, r);
          tma_load_2d(vb(s), &maps.v[1], &full[s], 64, r);
        }
        if (++s == kBwdStages) s = 0, ph ^= 1;
      }
    }
    return;
  }
  consumer_registers();
  if (wg >= nwg) return;  // a last block of 64 queries

  // consumer warpgroup wg: queries q0 + 64 wg .. + 63; warp wr of it rows
  // 16 wr .. 16 wr + 15, a thread rows g and g + 8 of those
  const int t128 = tid & 127, lane = tid & 31, wr = t128 >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qr0 = q0 + wg * kB;
  for (int e = t128; e < kB * KH; e += 128) {
    const int r = e / KH, c = e - r * KH;
    RH[(wg * kB + r) * kBwdRelLd + c] =
        rel_h[((size_t)bh * N + qr0 + r) * KH + c];
  }
  for (int e = t128; e < kB * kKW; e += 128) {
    const int r = e / kKW, c = e - r * kKW;
    RW[(wg * kB + r) * kBwdRelLd + c] =
        rel_w[((size_t)bh * N + qr0 + r) * kKW + c];
  }
  named_bar_sync(1 + wg, 128);  // the rel rows written
  mbar_wait(&qbar[wg], 0);

  const int la = wg * kB + wr * 16 + g;  // this thread's rows in the block
  const bf16* rh_row[2] = {RH + la * kBwdRelLd, RH + (la + 8) * kBwdRelLd};
  const bf16* rw_row[2] = {RW + la * kBwdRelLd, RW + (la + 8) * kBwdRelLd};
  size_t grow[2];
  float lse2[2], ddr[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    grow[hf] = (size_t)bh * N + qr0 + wr * 16 + g + 8 * hf;
    lse2[hf] = lse[grow[hf]] * kLog2e;
    ddr[hf] = dd[grow[hf]];
  }
  const float sl = scale * kLog2e;

  // q and do of the warpgroup's rows as register A operands, for the loop
  uint32_t qf[D / 16][4], gf[D / 16][4];
  load_a_frags<D>(qf, base + wg * kA, base + 2 * kA + wg * kBt, t128);
  load_a_frags<D>(gf, gbase + wg * kA, gbase + 2 * kA + wg * kBt, t128);
  float sacc[32], dpacc[32], qacc[32], qtail[kTail > 0 ? 8 : 1], drw[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = dpacc[i] = qacc[i] = drw[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kTail > 0 ? 8 : 1); ++i) qtail[i] = 0.f;
  // the accumulators are only ever defined by the products from here on
  const auto fence_acc = [&] {
    reg_fence(sacc);
    reg_fence(dpacc);
    reg_fence(qacc);
    reg_fence(qtail);
  };

  // S = q k^T and dP = do v^T of the tile in stage s (async; not
  // committed): q and do from registers, k and v K-major from the stage
  const auto issue_sdp = [&](int s) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wgmma_m64n64k16_rs(sacc, qf[k], sw128_desc(ka(s) + 32 * k), k > 0);
      wgmma_m64n64k16_rs(dpacc, gf[k], sw128_desc(va(s) + 32 * k), k > 0);
    }
    if constexpr (kTail > 0) {
      wgmma_m64n64k16_rs(sacc, qf[4], sw32_desc(kb(s)), 1);
      wgmma_m64n64k16_rs(dpacc, gf[4], sw32_desc(vb(s)), 1);
    }
  };

  mbar_wait(&full[0], 0);
  fence_acc();
  wgmma_fence();
  issue_sdp(0);
  wgmma_commit();
  for (int kt = 0; kt < NT; ++kt) {
    const int s = kt % kBwdStages;
    wgmma_wait<0>();  // S, dP of tile kt, and dQ of tile kt - 1
    fence_acc();
    if (kt > 0 && t128 == 0) mbar_arrive(&empty[(kt - 1) % kBwdStages]);

    // base-2 logits: s * scale log2e + (rel_h + rel_w) log2e - lse log2e
    float rhl[2][kRowsPerTile], rs[2][kRowsPerTile];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int r = 0; r < kRowsPerTile; ++r) {
        rhl[hf][r] = fmaf(
            __bfloat162float(rh_row[hf][kt * kRowsPerTile + r]), kLog2e,
            -lse2[hf]);
        rs[hf][r] = 0.f;
      }
    // ds in bf16 as wgmma's A operand, a pair of logits at a time: register
    // u of keys 16 kk .. 16 kk + 15 holds accumulator slots 8 kk + 2 u, + 1
    // (keys 8 i + 2 t, + 1 of row g + 8 (u & 1), i = 2 kk + u / 2)
    uint32_t da[4][4];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int i = j >> 1, hf = j & 1, c0 = 4 * i + 2 * hf;
      const int r = i * kRowsPerTile / 8;  // the keys' grid row in the tile
      // rel_w of keys 8 i + 2 t, + 1 (key % KW, one 4-byte load)
      const float2 w = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(rw_row[hf] +
                                                   (8 * i + 2 * t) % kKW));
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p =
            ex2_ftz(fmaf(sacc[c0 + e], sl,
                         fmaf(e ? w.y : w.x, kLog2e, rhl[hf][r])));
        ds[e] = p * (dpacc[c0 + e] - ddr[hf]);
      }
      // rounded once, as a pair: the A operand, and the values the drel
      // sums add
      uint32_t& pk = da[i >> 1][2 * (i & 1) + hf];
      pk = pack_bf16(ds[0], ds[1]);
      const float2 dr =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pk));
      drw[c0] += dr.x;
      drw[c0 + 1] += dr.y;
      rs[hf][r] += dr.x;
      rs[hf][r] += dr.y;
    }
    fence_acc();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_m64n64k16_rs_t(qacc, da[kk], sw128_desc(ka(s) + kk * 16 * 128));
      if constexpr (kTail > 0)
        wgmma_m64n16k16_rs_t(qtail, da[kk],
                             sw32_desc(kb(s) + kk * 16 * kTail * 2));
    }
    // the next tile's S and dP; after the last tile an S and dP on this
    // tile's stage, unread, keeps the accumulators' pipeline free of
    // branches
    const int s1 = kt + 1 < NT ? (kt + 1) % kBwdStages : s;
    if (kt + 1 < NT) mbar_wait(&full[s1], ((kt + 1) / kBwdStages) & 1);
    issue_sdp(s1);
    wgmma_commit();
    // drel_h of the tile's grid rows: the quad's sums, in a fixed order
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int r = 0; r < kRowsPerTile; ++r) {
        float a = rs[hf][r];
        a += __shfl_xor_sync(0xffffffffu, a, 1);
        a += __shfl_xor_sync(0xffffffffu, a, 2);
        if (t == 0) drel_h[grow[hf] * KH + kt * kRowsPerTile + r] = a;
      }
  }
  wgmma_wait<0>();

  constexpr int kPer = kKW / 8;  // slots i fold to i % kPer
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    bf16* out = dq + grow[hf] * D;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * i + 2 * t) =
          __floats2bfloat162_rn(qacc[4 * i + 2 * hf] * scale,
                                qacc[4 * i + 2 * hf + 1] * scale);
    if constexpr (kTail > 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<__nv_bfloat162*>(out + 64 + 8 * i + 2 * t) =
            __floats2bfloat162_rn(qtail[4 * i + 2 * hf] * scale,
                                  qtail[4 * i + 2 * hf + 1] * scale);
    }
    float fold[kPer][2];
#pragma unroll
    for (int j = 0; j < kPer; ++j) fold[j][0] = fold[j][1] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      fold[i % kPer][0] += drw[4 * i + 2 * hf];
      fold[i % kPer][1] += drw[4 * i + 2 * hf + 1];
    }
    float* dw = drel_w + grow[hf] * kKW;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      dw[8 * j + 2 * t] = fold[j][0];
      dw[8 * j + 2 * t + 1] = fold[j][1];
    }
  }
}

// grid (ceil(N / 128), BH), kBwdThreads threads; as vit_bwd_dq_sm90. The
// block's keys k0 .. k0 + 127 are key-grid rows k0 / KW ..
template <int D, int kRowsPerTile>
__global__ void __launch_bounds__(kBwdThreads, 1)
    vit_bwd_dkv_sm90(const __grid_constant__ BwdMaps maps,
                     const bf16* __restrict__ rel_h,
                     const bf16* __restrict__ rel_w,
                     const float* __restrict__ lse,
                     const float* __restrict__ dd, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int N, int KH, float scale) {
  using T = FlashTiles<D>;
  using L = BwdSm90Layout<D>;
  constexpr int kTail = T::kTail, kKW = kB / kRowsPerTile;
  constexpr int kA = T::kTileA, kBt = T::kTileB;
  extern __shared__ unsigned char smraw[];
  unsigned char* base = align1024(smraw);
  unsigned char* vbase = base + L::kTwoTiles;
  unsigned char* stages = base + 2 * L::kTwoTiles;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(stages + kBwdStages * L::kDkvStage);
  uint64_t* empty = full + kBwdStages;
  uint64_t* kvbar = empty + kBwdStages;
  const auto qa = [&](int s) { return stages + s * L::kDkvStage; };
  const auto ga = [&](int s) { return qa(s) + kA; };
  const auto qb = [&](int s) { return qa(s) + 2 * kA; };
  const auto gb = [&](int s) { return qb(s) + kBt; };
  const auto rws = [&](int s) {
    return reinterpret_cast<bf16*>(qa(s) + L::kTwoTiles);
  };
  const auto rhs = [&](int s) {
    return reinterpret_cast<float*>(rws(s) + kB * kBwdRelLd);
  };
  const auto lses = [&](int s) { return rhs(s) + kBwdMaxRows * kB; };
  const auto dds = [&](int s) { return lses(s) + kB; };

  const int tid = threadIdx.x, wg = tid / 128;
  const int bh = blockIdx.y, k0 = blockIdx.x * kBwdRows;
  const int nwg = k0 + kB < N ? 2 : 1;
  const int NT = N / kB;
  const int row0 = bh * N;
  const int kr0 = k0 / kKW, nkr = nwg * kRowsPerTile;  // the block's rows
  if (tid == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 129);   // the TMA's expect_tx + 128 copiers
      mbar_init(&empty[s], nwg);
    }
    mbar_init(&kvbar[0], 1);
    mbar_init(&kvbar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer warpgroup
    producer_registers();
    const int p = tid - 256;
    if (p == 0) {
      for (int w = 0; w < nwg; ++w) {
        const int r = row0 + k0 + w * kB;
        mbar_expect_tx(&kvbar[w], 2 * kB * D * 2);
        tma_load_2d(base + w * kA, &maps.k[0], &kvbar[w], 0, r);
        tma_load_2d(vbase + w * kA, &maps.v[0], &kvbar[w], 0, r);
        if constexpr (kTail > 0) {
          tma_load_2d(base + 2 * kA + w * kBt, &maps.k[1], &kvbar[w], 64, r);
          tma_load_2d(vbase + 2 * kA + w * kBt, &maps.v[1], &kvbar[w], 64,
                      r);
        }
      }
    }
    int s = 0, ph = 0;
    for (int qt = 0; qt < NT; ++qt) {
      const size_t rq = (size_t)bh * N + (size_t)qt * kB;
      mbar_wait(&empty[s], ph ^ 1);
      if (p == 0) {
        mbar_expect_tx(&full[s], L::kTwoTiles);
        tma_load_2d(qa(s), &maps.q[0], &full[s], 0, (int)rq);
        tma_load_2d(ga(s), &maps.g[0], &full[s], 0, (int)rq);
        if constexpr (kTail > 0) {
          tma_load_2d(qb(s), &maps.q[1], &full[s], 64, (int)rq);
          tma_load_2d(gb(s), &maps.g[1], &full[s], 64, (int)rq);
        }
      }
      // the tile's rel_w rows, 16 bytes at a time, transposed to [key %
      // KW][query] so that a thread's two queries are one 4-byte load
      constexpr int kCh = kKW / 8;
      bf16* rw = rws(s);
      for (int c = p; c < kB * kCh; c += 128) {
        const int r = c & (kB - 1), ch = c / kB;
        const uint4 v =
            *reinterpret_cast<const uint4*>(rel_w + (rq + r) * kKW + ch * 8);
        const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int u = 0; u < 8; ++u) rw[(ch * 8 + u) * kBwdRelLd + r] = e[u];
      }
      // rel_h of the block's key-grid rows, j-major, times log2 e
      float* rh = rhs(s);
      for (int e = p; e < kB * nkr; e += 128) {
        const int qi = e / nkr, j = e - qi * nkr;
        rh[j * kB + qi] =
            __bfloat162float(rel_h[(rq + qi) * KH + kr0 + j]) * kLog2e;
      }
      if (p < kB) {
        lses(s)[p] = lse[rq + p] * kLog2e;
        dds(s)[p] = dd[rq + p];
      }
      mbar_arrive(&full[s]);
      if (++s == kBwdStages) s = 0, ph ^= 1;
    }
    return;
  }
  consumer_registers();
  if (wg >= nwg) return;  // a last block of 64 keys

  // consumer warpgroup wg: keys k0 + 64 wg .. + 63; a thread keys (rows) g
  // and g + 8 of its warp's 16, queries (columns) 8 i + 2 t + e
  const int t128 = tid & 127, lane = tid & 31, wr = t128 >> 5;
  const int g = lane >> 2, t = lane & 3;
  int kc[2], jr[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kl = wg * kB + wr * 16 + g + 8 * hf;  // the key in the block
    kc[hf] = kl % kKW;                              // k0 % KW == 0
    jr[hf] = kl / kKW;
  }
  const float sl = scale * kLog2e;
  mbar_wait(&kvbar[wg], 0);

  // k and v of the warpgroup's keys as register A operands, for the loop
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_frags<D>(kf, base + wg * kA, base + 2 * kA + wg * kBt, t128);
  load_a_frags<D>(vf, vbase + wg * kA, vbase + 2 * kA + wg * kBt, t128);
  constexpr int kT = kTail > 0 ? 8 : 1;
  float sacc[32], dpacc[32], kacc[32], vacc[32], ktail[kT], vtail[kT];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = dpacc[i] = kacc[i] = vacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kT; ++i) ktail[i] = vtail[i] = 0.f;
  // the accumulators are only ever defined by the products from here on
  const auto fence_acc = [&] {
    reg_fence(sacc);
    reg_fence(dpacc);
    reg_fence(kacc);
    reg_fence(vacc);
    reg_fence(ktail);
    reg_fence(vtail);
  };

  // S^T = k q^T and dP^T = v do^T of the query tile in stage s: k and v
  // from registers, q and do K-major from the stage
  const auto issue_sdp = [&](int s) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wgmma_m64n64k16_rs(sacc, kf[k], sw128_desc(qa(s) + 32 * k), k > 0);
      wgmma_m64n64k16_rs(dpacc, vf[k], sw128_desc(ga(s) + 32 * k), k > 0);
    }
    if constexpr (kTail > 0) {
      wgmma_m64n64k16_rs(sacc, kf[4], sw32_desc(qb(s)), 1);
      wgmma_m64n64k16_rs(dpacc, vf[4], sw32_desc(gb(s)), 1);
    }
  };

  mbar_wait(&full[0], 0);
  fence_acc();
  wgmma_fence();
  issue_sdp(0);
  wgmma_commit();
  for (int qt = 0; qt < NT; ++qt) {
    const int s = qt % kBwdStages;
    wgmma_wait<0>();  // S^T, dP^T of tile qt, and dV, dK of tile qt - 1
    fence_acc();
    if (qt > 0 && t128 == 0) mbar_arrive(&empty[(qt - 1) % kBwdStages]);
    const bf16* rw = rws(s);
    const float* rh = rhs(s);
    const float* ls = lses(s);
    const float* ds_d = dds(s);
    // P^T (rounded here) and dS^T as wgmma's A operands, a pair of logits
    // at a time (queries 8 i + 2 t, + 1 of key row g + 8 hf; register
    // 2 (i & 1) + hf of queries 16 kk .., kk = i / 2)
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float b[2], d[2];  // a query's bias less lse (base 2), and its dd
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = 8 * i + 2 * t + e;
        b[e] = rh[jr[0] * kB + qi] - ls[qi];
        d[e] = ds_d[qi];
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c0 = 4 * i + 2 * hf;
        // rel_w of queries 8 i + 2 t, + 1 at the key's column
        const float2 w = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(
                rw + kc[hf] * kBwdRelLd + 8 * i + 2 * t));
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = 8 * i + 2 * t + e;
          // keys g and g + 8 lie in one grid row unless KW = 8
          const float bh = kKW > 8 || hf == 0
                               ? b[e]
                               : rh[jr[1] * kB + qi] - ls[qi];
          p[e] = ex2_ftz(
              fmaf(sacc[c0 + e], sl, fmaf(e ? w.y : w.x, kLog2e, bh)));
          ds[e] = p[e] * (dpacc[c0 + e] - d[e]);
        }
        pa[i >> 1][2 * (i & 1) + hf] = pack_bf16(p[0], p[1]);
        da[i >> 1][2 * (i & 1) + hf] = pack_bf16(ds[0], ds[1]);
      }
    }
    fence_acc();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_m64n64k16_rs_t(vacc, pa[kk], sw128_desc(ga(s) + kk * 16 * 128));
      wgmma_m64n64k16_rs_t(kacc, da[kk], sw128_desc(qa(s) + kk * 16 * 128));
      if constexpr (kTail > 0) {
        wgmma_m64n16k16_rs_t(vtail, pa[kk],
                             sw32_desc(gb(s) + kk * 16 * kTail * 2));
        wgmma_m64n16k16_rs_t(ktail, da[kk],
                             sw32_desc(qb(s) + kk * 16 * kTail * 2));
      }
    }
    const int s1 = qt + 1 < NT ? (qt + 1) % kBwdStages : s;
    if (qt + 1 < NT) mbar_wait(&full[s1], ((qt + 1) / kBwdStages) & 1);
    issue_sdp(s1);
    wgmma_commit();
  }
  wgmma_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const size_t r = ((size_t)bh * N + k0 + wg * kB + wr * 16 + g + 8 * hf) *
                     D;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(dk + r + 8 * i + 2 * t) =
          __floats2bfloat162_rn(kacc[4 * i + 2 * hf] * scale,
                                kacc[4 * i + 2 * hf + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + r + 8 * i + 2 * t) =
          __floats2bfloat162_rn(vacc[4 * i + 2 * hf], vacc[4 * i + 2 * hf + 1]);
    }
    if constexpr (kTail > 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        *reinterpret_cast<__nv_bfloat162*>(dk + r + 64 + 8 * i + 2 * t) =
            __floats2bfloat162_rn(ktail[4 * i + 2 * hf] * scale,
                                  ktail[4 * i + 2 * hf + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + r + 64 + 8 * i + 2 * t) =
            __floats2bfloat162_rn(vtail[4 * i + 2 * hf],
                                  vtail[4 * i + 2 * hf + 1]);
      }
    }
  }
}

// ---- launchers -------------------------------------------------------------

template <int D>
int launch_f32(const float* q, const float* k, const float* v,
               const float* rel_h, const float* rel_w, const float* dout,
               const float* lse, const float* dd, float* dq, float* dk,
               float* dv, float* drh, float* drw, int BH, int N, int KH,
               int KW, float scale, cudaStream_t st) {
  using L = BwdF32<D>;
  const dim3 grid(N / kB, BH);
  cudaError_t err = cudaFuncSetAttribute(
      vit_bwd_dq_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::kDqSmem);
  if (err != cudaSuccess) return (int)err;
  vit_bwd_dq_f32<D><<<grid, 256, L::kDqSmem, st>>>(
      q, k, v, rel_h, rel_w, dout, lse, dd, dq, drh, drw, N, KH, KW, scale);
  const int e = (int)cudaGetLastError();
  if (e) return e;
  err = cudaFuncSetAttribute(vit_bwd_dkv_f32<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::kDkvSmem);
  if (err != cudaSuccess) return (int)err;
  vit_bwd_dkv_f32<D><<<grid, 256, L::kDkvSmem, st>>>(
      q, k, v, rel_h, rel_w, dout, lse, dd, dk, dv, N, KH, KW, scale);
  return (int)cudaGetLastError();
}

template <int D, int kRowsPerTile>
int launch_sm90_rows(const BwdMaps& maps, const bf16* rel_h,
                     const bf16* rel_w, const float* lse, const float* dd,
                     bf16* dq, bf16* dk, bf16* dv, float* drh, float* drw,
                     int BH, int N, int KH, float scale, cudaStream_t st) {
  using L = BwdSm90Layout<D>;
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      vit_bwd_dq_sm90<D, kRowsPerTile>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kDqSmem);
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      vit_bwd_dkv_sm90<D, kRowsPerTile>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kDkvSmem);
  if (attr_q != cudaSuccess) return (int)attr_q;
  if (attr_kv != cudaSuccess) return (int)attr_kv;
  const dim3 grid((N + kBwdRows - 1) / kBwdRows, BH);
  vit_bwd_dq_sm90<D, kRowsPerTile><<<grid, kBwdThreads, L::kDqSmem, st>>>(
      maps, rel_h, rel_w, lse, dd, dq, drh, drw, N, KH, scale);
  const int e = (int)cudaGetLastError();
  if (e) return e;
  vit_bwd_dkv_sm90<D, kRowsPerTile><<<grid, kBwdThreads, L::kDkvSmem, st>>>(
      maps, rel_h, rel_w, lse, dd, dk, dv, N, KH, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_sm90(const void* q, const void* k, const void* v,
                const void* dout, const bf16* rel_h, const bf16* rel_w,
                const float* lse, const float* dd, bf16* dq, bf16* dk,
                bf16* dv, float* drh, float* drw, int BH, int N, int KH,
                int KW, float scale, cudaStream_t st) {
  BwdMaps maps;
  const void* src[4] = {q, k, v, dout};
  CUtensorMap* dst[4] = {maps.q, maps.k, maps.v, maps.g};
  for (int i = 0; i < 4; ++i) {
    if (!make_flash_map(&dst[i][0], src[i], (long long)BH * N, D, D, 64,
                        CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
    if (D > 64 && !make_flash_map(&dst[i][1], src[i], (long long)BH * N, D,
                                  D, D - 64, CU_TENSOR_MAP_SWIZZLE_32B))
      return (int)cudaErrorInvalidValue;
    if (D == 64) dst[i][1] = dst[i][0];
  }
  switch (KW) {
    case 64:
      return launch_sm90_rows<D, 1>(maps, rel_h, rel_w, lse, dd, dq, dk, dv,
                                    drh, drw, BH, N, KH, scale, st);
    case 32:
      return launch_sm90_rows<D, 2>(maps, rel_h, rel_w, lse, dd, dq, dk, dv,
                                    drh, drw, BH, N, KH, scale, st);
    case 16:
      return launch_sm90_rows<D, 4>(maps, rel_h, rel_w, lse, dd, dq, dk, dv,
                                    drh, drw, BH, N, KH, scale, st);
    case 8:
      return launch_sm90_rows<D, 8>(maps, rel_h, rel_w, lse, dd, dq, dk, dv,
                                    drh, drw, BH, N, KH, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v,
           const void* rel_h, const void* rel_w, const void* dout,
           const float* lse, const float* dd, void* dq, void* dk, void* dv,
           float* drh, float* drw, int BH, int N, int KH, int KW, float scale,
           cudaStream_t st) {
  if (dtype == kF32) {
    using F = const float*;
    return launch_f32<D>(F(q), F(k), F(v), F(rel_h), F(rel_w), F(dout), lse,
                         dd, static_cast<float*>(dq), static_cast<float*>(dk),
                         static_cast<float*>(dv), drh, drw, BH, N, KH, KW,
                         scale, st);
  }
  if (dtype == kBF16) {
    using B = const bf16*;
    return launch_sm90<D>(q, k, v, dout, B(rel_h), B(rel_w), lse, dd,
                          static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                          static_cast<bf16*>(dv), drh, drw, BH, N, KH, KW,
                          scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ullsam

// Plain C entry point (loaded with ctypes). Returns 0 or a cudaError_t.
// dtype: 0 = float32, 1 = bfloat16 for q, k, v, rel_h, rel_w, do, dq, dk,
// dv; lse, dd [BH, N] and drel_h [BH, N, KH], drel_w [BH, N, KW] are
// float32. Requires D in {64, 80}, KW in {8, 16, 32, 64}, KH <= 64, N ==
// KH * KW, N % 64 == 0, 16-byte aligned tensors.
extern "C" int vit_flash_attn_backward(
    int dtype, const void* q, const void* k, const void* v,
    const void* rel_h, const void* rel_w, const void* dout, const void* lse,
    const void* dd, void* dq, void* dk, void* dv, void* drel_h, void* drel_w,
    int BH, int N, int D, int KH, int KW, float scale, void* stream) {
  using namespace ullsam;
  if ((D != 64 && D != 80) || KW < 8 || KW > 64 || 64 % KW || KH < 1 ||
      KH > 64 || N != KH * KW || N % kB)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* dd_f = static_cast<const float*>(dd);
  float* drh = static_cast<float*>(drel_h);
  float* drw = static_cast<float*>(drel_w);
  if (D == 80)
    return launch<80>(dtype, q, k, v, rel_h, rel_w, dout, lse_f, dd_f, dq, dk,
                      dv, drh, drw, BH, N, KH, KW, scale, st);
  return launch<64>(dtype, q, k, v, rel_h, rel_w, dout, lse_f, dd_f, dq, dk,
                    dv, drh, drw, BH, N, KH, KW, scale, st);
}
