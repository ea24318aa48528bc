// B9: gradient of the ViT global flash attention (B2) for Hopper (sm_90a).
//
// Replaces the TPU kernels ullsam_tpu/ops/pallas/flash_attention.py
// `_vit_bwd_dq_kernel` and `_vit_bwd_dkv_kernel` (via `_vit_flash_bwd_impl`).
// With B2's logits s = qs k^T + bias, qs = cast(q * D^-1/2), bias[i, key] =
// rel_h[i, key / KW] + rel_w[i, key % KW], the forward's row logsumexp lse
// and dd = rowsum(do * o) (computed by the caller), it returns
//     p = exp(s - lse),  ds = p (do v^T - dd)
//     dq = ds k * D^-1/2,  dk = ds^T qs,  dv = p^T do
//     drel_h[i, r] = sum_c ds[i, r*KW + c],  drel_w[i, c] = sum_r ds[i, ..]
// p and ds are rounded to the input dtype before their products; every sum
// is f32; drel is f32. (This port scores with B2's cast(q * D^-1/2), so p is
// exactly the forward's probability; the TPU kernel scores q k^T * D^-1/2.)
//
// What bounds it on this card: operations. At the ViT-B global blocks (BH =
// 12, N = 4096, D = 64) the gradient needs 5 products of 2 N^2 D per head
// (s, dp, dv, dq, dk), ~129 GFLOP against ~50 MB. The pair does 7 (3 in dq:
// s, dp, ds.k; 4 in dkv: s, dp, p.do, ds.q), 7/5 of the needed work, as the
// price of two kernels, as on the TPU, so that neither needs atomics:
//   * dq + drel, q-tile major: a block owns 64 query rows and walks the key
//     tiles. KW divides 64, so a 64-key tile is 64 / KW whole key-grid rows
//     (one at ViT-B's KW = 64): drel_h[:, row] is a row sum of the tile's
//     ds (written once, no accumulation), and drel_w accumulates ds in
//     registers, one slot per (row, key % 64), folded to key % KW at the
//     end by shuffles in a fixed order.
//   * dk + dv, k-tile major: a block owns 64 keys (64 / KW key-grid rows)
//     and walks the query tiles; its bias needs only those rows' rel_h
//     columns and the query tile's rel_w rows.
// bf16 runs every product on the tensor cores (mma.sync m16n8k16, f32
// accumulate; 4 warps of 16 rows, the next tile fetched by cp.async while
// the current one is multiplied), reusing common.cuh's fragments as B2's
// attn_mma.cuh does. float32 stays true f32 FMA on the CUDA cores (256
// threads, 4 x 4 outputs each), bounded by the 67 TFLOP/s f32 rate.
#include "common.cuh"

namespace ullsam {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kB = 64;           // query / key tile
constexpr int kD = 64;           // head dim
constexpr int kLd = kD + 8;      // bf16 smem row stride (ldmatrix conflict-free)
constexpr int kRelLd = 64 + 8;   // bf16 rel rows
constexpr int kLdF = kB + 4;     // f32 smem row stride

// ---- tensor-core fragments (m16n8k16 layouts, see attn_mma.cuh) ----------

// A fragments of rows [row0, row0 + 16) x 64 of a [rows][kLd] tile
__device__ __forceinline__ void load_a(uint32_t (&af)[4][4], const bf16* t,
                                       int row0, int lane) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldmatrix_x4(af[ks], smem_u32(t + (row0 + (lane & 15)) * kLd + ks * 16 +
                                 (lane >> 4) * 8));
}

// s[8][4] = A (16 x 64) . B^T for the 64 rows of B ([64][kLd], row = n)
__device__ __forceinline__ void mma_abt(float (&s)[8][4],
                                        const uint32_t (&af)[4][4],
                                        const bf16* b_rows, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
  for (int kd = 0; kd < 4; ++kd)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      uint32_t b[4];
      ldmatrix_x4(b, smem_u32(b_rows +
                              (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                  kLd +
                              kd * 16 + ((lane >> 3) & 1) * 8));
      mma_bf16_16816(s[2 * nj], af[kd], b);
      mma_bf16_16816(s[2 * nj + 1], af[kd], b + 2);
    }
}

// acc[8][4] += P (16 x 64, C fragments, rounded to bf16 here) . B (64 x 64,
// [64][kLd] with row = the contracted index)
__device__ __forceinline__ void mma_pb(float (&acc)[8][4],
                                       const float (&p)[8][4],
                                       const bf16* b_rows, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dj = 0; dj < 4; ++dj) {
      uint32_t b[4];
      ldmatrix_x4_trans(
          b, smem_u32(b_rows +
                      (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                      dj * 16 + (lane >> 4) * 8));
      mma_bf16_16816(acc[2 * dj], pa, b);
      mma_bf16_16816(acc[2 * dj + 1], pa, b + 2);
    }
  }
}

// 64 rows x 64 bf16 from global rows of stride ld_g into [64][kLd] smem
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* src,
                                        size_t ld_g, int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // 64 rows x 8 chunks of 16 B, 128 threads
    const int c = tid + i * 128, row = c >> 3, ch = (c & 7) * 8;
    cp_async16(smem_u32(dst + row * kLd + ch), src + row * ld_g + ch, true);
  }
}

// q rows scaled and rounded (B2's qs), staged at [64][kLd]
__device__ __forceinline__ void stage_qs(bf16* dst, const bf16* q,
                                         float scale, int tid) {
  for (int e = tid; e < kB * kD; e += 128) {
    const int r = e / kD, d = e % kD;
    dst[r * kLd + d] =
        __float2bfloat16(__bfloat162float(q[(size_t)r * kD + d]) * scale);
  }
}

// ---- bf16: dq + drel, q-tile major ----------------------------------------
// grid (N / 64, BH), 128 threads: warp w owns query rows q0 + 16 w .. + 15.
constexpr size_t dq_mma_smem() {
  return sizeof(bf16) * (size_t)(4 * kB * kLd + 2 * kB * kLd + 2 * kB * kRelLd);
}

__global__ void __launch_bounds__(128, 2)
    vit_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ rel_h,
                    const bf16* __restrict__ rel_w,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd, bf16* __restrict__ dq,
                    float* __restrict__ drel_h, float* __restrict__ drel_w,
                    int N, int KH, int KW, float scale) {
  extern __shared__ __align__(16) unsigned char smraw[];
  bf16* Ks = reinterpret_cast<bf16*>(smraw);  // [2][64][kLd]
  bf16* Vs = Ks + 2 * kB * kLd;               // [2][64][kLd]
  bf16* Qs = Vs + 2 * kB * kLd;               // [64][kLd]
  bf16* Gs = Qs + kB * kLd;                   // [64][kLd]
  bf16* RH = Gs + kB * kLd;                   // [64][kRelLd]
  bf16* RW = RH + kB * kRelLd;                // [64][kRelLd]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * kB;
  const size_t base = (size_t)bh * N * kD;

  cp_tile(Ks, k + base, kD, tid);
  cp_tile(Vs, v + base, kD, tid);
  cp_async_commit();
  stage_qs(Qs, q + base + (size_t)q0 * kD, scale, tid);
  cp_tile(Gs, dout + base + (size_t)q0 * kD, kD, tid);
  for (int e = tid; e < kB * KH; e += 128) {
    const int r = e / KH, c = e % KH;
    RH[r * kRelLd + c] = rel_h[((size_t)bh * N + q0 + r) * KH + c];
  }
  for (int e = tid; e < kB * KW; e += 128) {
    const int r = e / KW, c = e % KW;
    RW[r * kRelLd + c] = rel_w[((size_t)bh * N + q0 + r) * KW + c];
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int rpt = kB / KW;  // key-grid rows per 64-key tile
  uint32_t qf[4][4], gf[4][4];
  load_a(qf, Qs, warp * 16, lane);
  load_a(gf, Gs, warp * 16, lane);
  float l2[2], d2[2];
  const int row0 = warp * 16 + g;  // local rows row0, row0 + 8
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l2[hf] = lse[(size_t)bh * N + q0 + row0 + 8 * hf];
    d2[hf] = dd[(size_t)bh * N + q0 + row0 + 8 * hf];
  }
  float acc[8][4], drw[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = drw[j][c] = 0.f;

  const int NT = N / kB;
  for (int kt = 0; kt < NT; ++kt) {
    if (kt + 1 < NT) {
      const int st = (kt + 1) & 1;
      cp_tile(Ks + st * kB * kLd, k + base + (size_t)(kt + 1) * kB * kD, kD,
              tid);
      cp_tile(Vs + st * kB * kLd, v + base + (size_t)(kt + 1) * kB * kD, kD,
              tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt_s = Ks + (kt & 1) * kB * kLd;
    const bf16* vt_s = Vs + (kt & 1) * kB * kLd;
    float s[8][4], dp[8][4];
    mma_abt(s, qf, kt_s, lane);
    mma_abt(dp, gf, vt_s, lane);
    // slot j (keys 8 j .. 8 j + 7 of the tile) lies in grid row kt * rpt +
    // 8 j / KW, at columns (8 j) % KW + 2 t + e; a run of slots makes a
    // grid row, whose sum is written when the run ends
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gr = kt * rpt + (j * 8) / KW;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int hf = c >> 1, col = j * 8 + 2 * t + (c & 1);
        const int r = row0 + 8 * hf;
        const float bias = __bfloat162float(RH[r * kRelLd + gr]) +
                           __bfloat162float(RW[r * kRelLd + col % KW]);
        const float p = expf(s[j][c] + bias - l2[hf]);
        const float ds = round_to<bf16>(p * (dp[j][c] - d2[hf]));
        s[j][c] = ds;
        drw[j][c] += ds;
        rs[hf] += ds;
      }
      if (j == 7 || ((j + 1) * 8) % KW == 0) {  // warp-uniform
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float a = rs[hf];
          a += __shfl_xor_sync(0xffffffffu, a, 1);
          a += __shfl_xor_sync(0xffffffffu, a, 2);
          if (t == 0)
            drel_h[((size_t)bh * N + q0 + row0 + 8 * hf) * KH + gr] = a;
          rs[hf] = 0.f;
        }
      }
    }
    mma_pb(acc, s, kt_s, lane);
    __syncthreads();  // this stage is refilled two tiles later
  }

  // fold the slots to key % KW: slot j holds columns (8 j) % KW + 2 t + e
  const int per = KW / 8;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const size_t r = (size_t)bh * N + q0 + row0 + 8 * hf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dq + r * kD + c) =
          __floats2bfloat162_rn(acc[j][2 * hf] * scale,
                                acc[j][2 * hf + 1] * scale);
    }
    float fold[8][2];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) fold[jj][0] = fold[jj][1] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        if (j % per == jj) {
          fold[jj][0] += drw[j][2 * hf];
          fold[jj][1] += drw[j][2 * hf + 1];
        }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      if (jj < per) {
        drel_w[r * KW + jj * 8 + 2 * t] = fold[jj][0];
        drel_w[r * KW + jj * 8 + 2 * t + 1] = fold[jj][1];
      }
  }
}

// ---- bf16: dk + dv, k-tile major ------------------------------------------
// grid (N / 64, BH), 128 threads: the block's 64 keys are key-grid row kr =
// blockIdx.x; warp w owns keys k0 + 16 w .. + 15.
constexpr size_t dkv_mma_smem() {
  return sizeof(bf16) * (size_t)(2 * kB * kLd + 6 * kB * kLd) +
         sizeof(float) * (kB * kB / 8 + 2 * kB);
}

__global__ void __launch_bounds__(128, 2)
    vit_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ rel_h,
                     const bf16* __restrict__ rel_w,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dd, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int N, int KH, int KW,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smraw[];
  bf16* Ks = reinterpret_cast<bf16*>(smraw);  // [64][kLd]
  bf16* Vs = Ks + kB * kLd;                   // [64][kLd]
  bf16* Qs = Vs + kB * kLd;                   // [2][64][kLd]
  bf16* Gs = Qs + 2 * kB * kLd;               // [2][64][kLd]
  bf16* RW = Gs + 2 * kB * kLd;               // [2][64][kLd]
  float* RHs = reinterpret_cast<float*>(RW + 2 * kB * kLd);  // [64][rpt]
  float* LSE = RHs + kB * kB / 8;                            // [64]
  float* DD = LSE + kB;                                      // [64]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, k0 = blockIdx.x * kB;
  const int rpt = kB / KW, kr0 = k0 / KW;  // the block's key-grid rows
  const size_t base = (size_t)bh * N * kD;
  const size_t rbase = (size_t)bh * N;

  cp_tile(Ks, k + base + (size_t)k0 * kD, kD, tid);
  cp_tile(Vs, v + base + (size_t)k0 * kD, kD, tid);
  auto load_q = [&](int st, int qt) {
    const size_t r0 = (size_t)qt * kB;
    cp_tile(Qs + st * kB * kLd, q + base + r0 * kD, kD, tid);
    cp_tile(Gs + st * kB * kLd, dout + base + r0 * kD, kD, tid);
    bf16* rwd = RW + st * kB * kLd;
    const bf16* rws = rel_w + (rbase + r0) * KW;
    const int ch = KW / 8;  // 16-byte chunks per rel_w row
    for (int c = tid; c < kB * ch; c += 128)
      cp_async16(smem_u32(rwd + (c / ch) * kLd + (c % ch) * 8),
                 rws + (size_t)(c / ch) * KW + (c % ch) * 8, true);
  };
  load_q(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[4][4], vf[4][4];
  load_a(kf, Ks, warp * 16, lane);
  load_a(vf, Vs, warp * 16, lane);
  const int kc0 = warp * 16 + g;  // key columns kc0, kc0 + 8 (key % 64)

  float adk[8][4], adv[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) adk[j][c] = adv[j][c] = 0.f;

  const int NT = N / kB;
  for (int qt = 0; qt < NT; ++qt) {
    const int st = qt & 1;
    if (qt + 1 < NT) {
      load_q((qt + 1) & 1, qt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // B2's qs: scale and round the q rows this thread copied, in place
    bf16* qs = Qs + st * kB * kLd;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * 128, row = c >> 3, ch = (c & 7) * 8;
      __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(qs + row * kLd + ch);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 f = __bfloat1622float2(p2[u]);
        p2[u] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
    }
    for (int e = tid; e < kB * rpt; e += 128) {
      const size_t r = rbase + (size_t)qt * kB + e / rpt;
      RHs[e] = __bfloat162float(rel_h[r * KH + kr0 + e % rpt]);
    }
    if (tid < kB) {
      const size_t r = rbase + (size_t)qt * kB + tid;
      LSE[tid] = lse[r];
      DD[tid] = dd[r];
    }
    __syncthreads();
    const bf16* gs = Gs + st * kB * kLd;
    const bf16* rw = RW + st * kB * kLd;
    float s[8][4], dp[8][4];
    mma_abt(s, kf, qs, lane);   // rows = keys, columns = queries
    mma_abt(dp, vf, gs, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int hf = c >> 1, qi = j * 8 + 2 * t + (c & 1);
        const int kc = kc0 + 8 * hf;
        const float bias = RHs[qi * rpt + kc / KW] +
                           __bfloat162float(rw[qi * kLd + kc % KW]);
        const float p = expf(s[j][c] + bias - LSE[qi]);
        s[j][c] = p;
        dp[j][c] = round_to<bf16>(p * (dp[j][c] - DD[qi]));
      }
    mma_pb(adv, s, gs, lane);   // p rounded to bf16 in the fragments
    mma_pb(adk, dp, qs, lane);
    __syncthreads();  // this stage and RHs / LSE / DD are refilled next
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const size_t r = base + (size_t)(k0 + kc0 + 8 * hf) * kD;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dk + r + c) =
          __floats2bfloat162_rn(adk[j][2 * hf], adk[j][2 * hf + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + r + c) =
          __floats2bfloat162_rn(adv[j][2 * hf], adv[j][2 * hf + 1]);
    }
  }
}

// ---- float32: FMA on the CUDA cores ---------------------------------------
// 256 threads; thread (ty, tx) = (tid / 16, tid % 16) holds a 4 x 4 block
// of the 64 x 64 score tile (rows 4 ty.., columns 4 tx..) and of its 64 x 64
// output (rows 4 ty.., channels 4 tx..). Operands of the score products sit
// d-major ([64][kLdF], one row per channel), operands of the output products
// row-major.

__device__ __forceinline__ void fma_tile(float (&s)[4][4], const float* at,
                                         const float* bt, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < kD; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(at + d * kLdF + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(bt + d * kLdF + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[4][4] += P[4 ty.., :] (row-major [64][kLdF]) . B[:, 4 tx..] (row-major)
__device__ __forceinline__ void fma_out(float (&acc)[4][4], const float* P,
                                        const float* B, int ty, int tx) {
#pragma unroll 8
  for (int m = 0; m < kB; ++m) {
    const float4 b = *reinterpret_cast<const float4*>(B + m * kLdF + tx * 4);
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = P[(ty * 4 + i) * kLdF + m];
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][u] = fmaf(p, bv[u], acc[i][u]);
    }
  }
}

// 64 rows x 64 of a global [rows][64] f32 array into smem, d-major and/or
// row-major (either may be null), times mul
__device__ __forceinline__ void load_f32(float* dmaj, float* rmaj,
                                         const float* src, float mul,
                                         int tid) {
  for (int e = tid; e < kB * kD; e += 256) {
    const int r = e / kD, d = e % kD;
    const float x = src[(size_t)r * kD + d] * mul;
    if (dmaj) dmaj[d * kLdF + r] = x;
    if (rmaj) rmaj[r * kLdF + d] = x;
  }
}

constexpr size_t dq_f32_smem() {
  return sizeof(float) * (size_t)(6 * kD * kLdF + 2 * kB * 65 + 2 * kB);
}

// grid (N / 64, BH): dq and drel of 64 query rows
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
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;                  // [64 d][kLdF] qs
  float* Gt = Qt + kD * kLdF;      // [64 d][kLdF] do
  float* Kt = Gt + kD * kLdF;      // [64 d][kLdF]
  float* Vt = Kt + kD * kLdF;      // [64 d][kLdF]
  float* Kr = Vt + kD * kLdF;      // [64 keys][kLdF]
  float* DS = Kr + kD * kLdF;      // [64 rows][kLdF]
  float* RH = DS + kB * kLdF;      // [64][65]
  float* RW = RH + kB * 65;        // [64][65]
  float* LSE = RW + kB * 65;       // [64]
  float* DD = LSE + kB;            // [64]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, q0 = blockIdx.x * kB;
  const size_t base = (size_t)bh * N * kD, rb = (size_t)bh * N + q0;
  load_f32(Qt, nullptr, q + base + (size_t)q0 * kD, scale, tid);
  load_f32(Gt, nullptr, dout + base + (size_t)q0 * kD, 1.f, tid);
  for (int e = tid; e < kB * KH; e += 256)
    RH[(e / KH) * 65 + e % KH] = rel_h[rb * KH + e];
  for (int e = tid; e < kB * KW; e += 256)
    RW[(e / KW) * 65 + e % KW] = rel_w[rb * KW + e];
  if (tid < kB) {
    LSE[tid] = lse[rb + tid];
    DD[tid] = dd[rb + tid];
  }
  const int rpt = kB / KW, tpr = KW / 4;  // grid rows a tile, threads a row
  float acc[4][4], drw[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = drw[i][j] = 0.f;

  for (int kt = 0; kt < N / kB; ++kt) {
    __syncthreads();  // previous tile's Kt / Vt / Kr / DS are free
    load_f32(Kt, Kr, k + base + (size_t)kt * kB * kD, 1.f, tid);
    load_f32(Vt, nullptr, v + base + (size_t)kt * kB * kD, 1.f, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
    fma_tile(s, Qt, Kt, ty, tx);
    fma_tile(dp, Gt, Vt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        const float p = expf(s[i][j] + RH[r * 65 + kt * rpt + c / KW] +
                             RW[r * 65 + c % KW] - LSE[r]);
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
    fma_out(acc, DS, Kr, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t r = rb + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dq[r * kD + tx * 4 + j] = acc[i][j] * scale;
      // threads tx and tx + tpr hold the same column: fold them
      float a = drw[i][j];
      for (int o = tpr; o < 16; o <<= 1)
        a += __shfl_xor_sync(0xffffffffu, a, o);
      if (tx < tpr) drel_w[r * KW + tx * 4 + j] = a;
    }
  }
}

constexpr size_t dkv_f32_smem() {
  return sizeof(float) * (size_t)(8 * kD * kLdF + kB * 65 + kB * kB / 8 +
                                  2 * kB);
}

// grid (N / 64, BH): dk and dv of the 64 keys of key-grid row blockIdx.x
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
  extern __shared__ __align__(16) float sm[];
  float* Kt = sm;                  // [64 d][kLdF] keys
  float* Vt = Kt + kD * kLdF;      // [64 d][kLdF]
  float* Qt = Vt + kD * kLdF;      // [64 d][kLdF] qs of the query tile
  float* Qr = Qt + kD * kLdF;      // [64 q][kLdF]
  float* Gt = Qr + kD * kLdF;      // [64 d][kLdF] do
  float* Gr = Gt + kD * kLdF;      // [64 q][kLdF]
  float* PT = Gr + kD * kLdF;      // [64 keys][kLdF] p
  float* DT = PT + kB * kLdF;      // [64 keys][kLdF] ds
  float* RW = DT + kB * kLdF;      // [64 q][65]
  float* RHs = RW + kB * 65;       // [64 q][rpt]
  float* LSE = RHs + kB * kB / 8;  // [64]
  float* DD = LSE + kB;            // [64]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, k0 = blockIdx.x * kB;
  const int rpt = kB / KW, kr0 = k0 / KW;  // the block's key-grid rows
  const size_t base = (size_t)bh * N * kD;
  load_f32(Kt, nullptr, k + base + (size_t)k0 * kD, 1.f, tid);
  load_f32(Vt, nullptr, v + base + (size_t)k0 * kD, 1.f, tid);
  float adk[4][4], adv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) adk[i][j] = adv[i][j] = 0.f;

  for (int qt = 0; qt < N / kB; ++qt) {
    const size_t rb = (size_t)bh * N + (size_t)qt * kB;
    __syncthreads();  // previous tile's operands are free
    load_f32(Qt, Qr, q + base + (size_t)qt * kB * kD, scale, tid);
    load_f32(Gt, Gr, dout + base + (size_t)qt * kB * kD, 1.f, tid);
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
    fma_tile(s, Kt, Qt, ty, tx);   // rows = keys, columns = queries
    fma_tile(dp, Vt, Gt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kc = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = tx * 4 + j;
        const float p = expf(s[i][j] + RHs[qi * rpt + kc / KW] +
                             RW[qi * 65 + kc % KW] - LSE[qi]);
        PT[kc * kLdF + qi] = p;
        DT[kc * kLdF + qi] = p * (dp[i][j] - DD[qi]);
      }
    }
    __syncthreads();
    fma_out(adv, PT, Gr, ty, tx);
    fma_out(adk, DT, Qr, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t r = base + (size_t)(k0 + ty * 4 + i) * kD + tx * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dk[r + j] = adk[i][j];
      dv[r + j] = adv[i][j];
    }
  }
}

}  // namespace
}  // namespace ullsam

// Plain C entry point (loaded with ctypes). Returns 0 or a cudaError_t.
// dtype: 0 = float32, 1 = bfloat16 for q, k, v, rel_h, rel_w, do, dq, dk,
// dv; lse, dd [BH, N] and drel_h [BH, N, KH], drel_w [BH, N, KW] are
// float32. Requires D == 64, KW in {8, 16, 32, 64}, KH <= 64, N == KH * KW
// (so N % 64 == 0).
extern "C" int vit_flash_attn_backward(
    int dtype, const void* q, const void* k, const void* v,
    const void* rel_h, const void* rel_w, const void* dout, const void* lse,
    const void* dd, void* dq, void* dk, void* dv, void* drel_h, void* drel_w,
    int BH, int N, int D, int KH, int KW, float scale, void* stream) {
  using namespace ullsam;
  if (D != kD || KW < 8 || KW > 64 || 64 % KW || KH < 1 || KH > 64 ||
      N != KH * KW || N % kB)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(N / kB, BH);
  const float* lse_f = static_cast<const float*>(lse);
  const float* dd_f = static_cast<const float*>(dd);
  float* drh = static_cast<float*>(drel_h);
  float* drw = static_cast<float*>(drel_w);
  cudaError_t err;
  if (dtype == kF32) {
    using F = const float*;
    err = cudaFuncSetAttribute(vit_bwd_dq_f32,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dq_f32_smem());
    if (err != cudaSuccess) return (int)err;
    vit_bwd_dq_f32<<<grid, 256, dq_f32_smem(), st>>>(
        F(q), F(k), F(v), F(rel_h), F(rel_w), F(dout), lse_f, dd_f,
        static_cast<float*>(dq), drh, drw, N, KH, KW, scale);
    int e = (int)cudaGetLastError();
    if (e) return e;
    err = cudaFuncSetAttribute(vit_bwd_dkv_f32,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dkv_f32_smem());
    if (err != cudaSuccess) return (int)err;
    vit_bwd_dkv_f32<<<grid, 256, dkv_f32_smem(), st>>>(
        F(q), F(k), F(v), F(rel_h), F(rel_w), F(dout), lse_f, dd_f,
        static_cast<float*>(dk), static_cast<float*>(dv), N, KH, KW, scale);
    return (int)cudaGetLastError();
  }
  if (dtype == kBF16) {
    using B = const bf16*;
    err = cudaFuncSetAttribute(vit_bwd_dq_bf16,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dq_mma_smem());
    if (err != cudaSuccess) return (int)err;
    vit_bwd_dq_bf16<<<grid, 128, dq_mma_smem(), st>>>(
        B(q), B(k), B(v), B(rel_h), B(rel_w), B(dout), lse_f, dd_f,
        static_cast<bf16*>(dq), drh, drw, N, KH, KW, scale);
    int e = (int)cudaGetLastError();
    if (e) return e;
    err = cudaFuncSetAttribute(vit_bwd_dkv_bf16,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dkv_mma_smem());
    if (err != cudaSuccess) return (int)err;
    vit_bwd_dkv_bf16<<<grid, 128, dkv_mma_smem(), st>>>(
        B(q), B(k), B(v), B(rel_h), B(rel_w), B(dout), lse_f, dd_f,
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, KH, KW, scale);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
