// B11: gradient of the LLM's causal GQA flash attention with segment ids
// (B10), for Hopper (sm_90a).
//
// Replaces the TPU kernels ullsam_tpu/ops/pallas/flash_attention.py
// `_llm_bwd_dq_kernel` and `_llm_bwd_dkv_kernel` (via `_llm_flash_bwd_impl`).
// With B10's logits s = qs k^T, qs = cast(q * D^-1/2), the validity
// predicate (q_seg[i] == kv_seg[j], and j <= i when causal), the forward's
// row logsumexp lse and dd = rowsum(do * o) (computed by the caller):
//     p = exp(s - lse) at valid keys, 0 elsewhere;  ds = p (do v^T - dd)
//     dq = ds k * D^-1/2,  dk = sum over the group's heads of ds^T qs,
//     dv = sum over the group's heads of p^T do
// p and ds are rounded to the input dtype before their products; every sum
// is f32. (This port scores with B10's cast(q * D^-1/2), so p is exactly
// the forward's probability; the TPU kernel scores q k^T * D^-1/2.)
// Layouts as B10: q, do, dq [B, S, nh, D]; k, v, dk, dv [B, S, nkv, D];
// segment ids [B, S] int32; lse, dd [B, nh, S]; rows and keys past S are
// zero-filled on load and masked by bounds checks.
//
// What bounds it on this card: operations. The gradient needs 5 products of
// 2 D per valid (query, key) pair and head (s, dp, dv, dq, dk): at the
// packed-training shape (S = 2560, nh = 16, nkv = 8, D = 128) 67.1 GFLOP
// over the causal half against ~52 MB. The pair does 7 (3 in dq: s, dp,
// ds.k; 4 in dkv: s, dp, p.do, ds.q), as the price of two kernels, as on the
// TPU, so that neither needs float atomics:
//   * dq, q-tile major: a block owns 64 query rows of one head and walks the
//     key tiles up to the diagonal.
//   * dk + dv, k-tile major: a block owns 64 keys of one kv head and walks,
//     for each of the group's query heads, the query tiles from the
//     diagonal on; it sums the group in its registers (the TPU's
//     `group * nq` inner grid axis).
// Both walk only the tiles that hold one of their own tile's segment ids
// (seg_tiles.cuh: on a packed row, the tiles near the block-diagonal).
// bf16 runs every product on the tensor cores (mma.sync m16n8k16, f32
// accumulate; 4 warps of 16 rows; the next tile fetched by cp.async while
// the current one is multiplied). At D = 128 a warp's accumulators are 64
// (dq) or 128 (dk + dv) f32 registers, so operands stay in shared memory and
// are reloaded with ldmatrix per use, and the score tile is taken 32 columns
// at a time (16 in dk + dv at D = 128, which spilled at 32) to keep the
// registers for s and dp few. float32 stays true f32 FMA on the CUDA cores
// (256 threads, 4 x 4 scores and 4 x D/16 outputs each), bounded by the 67
// TFLOP/s f32 rate.
#include "common.cuh"
#include "seg_tiles.cuh"

namespace ullsam {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kB = 64;         // query / key tile
constexpr int kLdF = kB + 4;   // f32 d-major / score row stride

// ---- tensor-core fragments (m16n8k16 layouts, see attn_mma.cuh) ----------

// A fragment: rows [row0, row0 + 16) x cols [col0, col0 + 16) of a [rows][ld]
// tile
__device__ __forceinline__ void load_a16(uint32_t (&a)[4], const bf16* t,
                                         int ld, int row0, int col0,
                                         int lane) {
  ldmatrix_x4(a, smem_u32(t + (row0 + (lane & 15)) * ld + col0 +
                          (lane >> 4) * 8));
}

// B fragments of two n8 tiles from a [n][ld] tile (row = n, col = k): n in
// [n0, n0 + 16), k in [col0, col0 + 16)
__device__ __forceinline__ void load_b16(uint32_t (&b)[4], const bf16* t,
                                         int ld, int n0, int col0,
                                         int lane) {
  ldmatrix_x4(b, smem_u32(t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld +
                          col0 + ((lane >> 3) & 1) * 8));
}

// B fragments of two n8 tiles from a [k][ld] tile (row = the contracted k):
// k in [k0, k0 + 16), n in [n0, n0 + 16)
__device__ __forceinline__ void load_bt16(uint32_t (&b)[4], const bf16* t,
                                          int ld, int k0, int n0, int lane) {
  ldmatrix_x4_trans(b, smem_u32(t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                        * ld + n0 + (lane >> 4) * 8));
}

// columns [16 kk, 16 kk + 16) of a C-fragment tile as an A fragment, rounded
// to bf16
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c)[N][4],
                                       int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// 64 rows x HD bf16 from global rows [row0, row0 + 64) of stride ld_g into
// [64][HD + 8] smem by cp.async, rows past S zero-filled
template <int HD>
__device__ __forceinline__ void cp_rows(bf16* dst, const bf16* base,
                                        size_t ld_g, int row0, int S,
                                        int tid) {
  constexpr int kChunks = HD / 8, kLd = HD + 8;
  for (int c = tid; c < kB * kChunks; c += 128) {
    const int row = c / kChunks, ch = (c % kChunks) * 8;
    const bool in = row0 + row < S;
    cp_async16(smem_u32(dst + row * kLd + ch),
               base + (size_t)(in ? row0 + row : 0) * ld_g + ch, in);
  }
}

// ---- bf16: dq, q-tile major -----------------------------------------------
// grid (ceil(S / 64), nh, B), 128 threads: warp w owns query rows
// q0 + 16 w .. + 15; the tiles with the most keys first.
template <int HD>
constexpr size_t dq_mma_smem() {
  return sizeof(bf16) * (size_t)(6 * kB * (HD + 8)) + sizeof(int) * 2 * kB;
}

template <int HD>
__global__ void __launch_bounds__(128, 2)
    llm_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ qseg,
                    const int* __restrict__ kseg,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd, bf16* __restrict__ dq,
                    int S, int nh, int nkv, int causal, float scale) {
  constexpr int kLd = HD + 8;
  extern __shared__ __align__(16) unsigned char smraw[];
  bf16* Ks = reinterpret_cast<bf16*>(smraw);  // [2][64][kLd]
  bf16* Vs = Ks + 2 * kB * kLd;               // [2][64][kLd]
  bf16* Qs = Vs + 2 * kB * kLd;               // [64][kLd] qs
  bf16* Gs = Qs + kB * kLd;                   // [64][kLd] do
  int* KSeg = reinterpret_cast<int*>(Gs + kB * kLd);  // [2][64]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int NT = (S + kB - 1) / kB;
  const int qt = NT - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, q0 = qt * kB;
  const size_t ldq = (size_t)nh * HD, ldk = (size_t)nkv * HD;
  const bf16* qb = q + (size_t)b * S * ldq + (size_t)h * HD;
  const bf16* gb = dout + (size_t)b * S * ldq + (size_t)h * HD;
  const size_t kvoff = (size_t)b * S * ldk + (size_t)(h / (nh / nkv)) * HD;
  const int* ksb = kseg + (size_t)b * S;

  auto load_kv = [&](int stage, int k0) {
    cp_rows<HD>(Ks + stage * kB * kLd, k + kvoff, ldk, k0, S, tid);
    cp_rows<HD>(Vs + stage * kB * kLd, v + kvoff, ldk, k0, S, tid);
    if (tid < kB) KSeg[stage * kB + tid] = k0 + tid < S ? ksb[k0 + tid] : 0;
  };
  const int nkt = causal ? qt + 1 : NT;
  __shared__ SegTiles tiles;
  seg_own_ids(tiles, qseg + (size_t)b * S, q0, S, tid);
  seg_mark_live(tiles, ksb, 0, nkt, S, tid, 128);
  int kt = seg_next_live(tiles, 0, nkt);
  if (kt < nkt) load_kv(0, kt * kB);
  cp_rows<HD>(Gs, gb, ldq, q0, S, tid);
  cp_async_commit();
  for (int e = tid; e < kB * HD / 2; e += 128) {  // B10's qs
    const int r = e / (HD / 2), d = (e % (HD / 2)) * 2;
    float2 f = make_float2(0.f, 0.f);
    if (q0 + r < S)
      f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          qb + (size_t)(q0 + r) * ldq + d));
    *reinterpret_cast<__nv_bfloat162*>(Qs + r * kLd + d) =
        __floats2bfloat162_rn(f.x * scale, f.y * scale);
  }

  int row[2], seg[2];
  float l2[2], d2[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    row[hf] = q0 + warp * 16 + g + 8 * hf;
    const bool in = row[hf] < S;
    const size_t ri = ((size_t)b * nh + h) * S + row[hf];
    seg[hf] = in ? qseg[(size_t)b * S + row[hf]] : 0;
    l2[hf] = in ? lse[ri] : 0.f;
    d2[hf] = in ? dd[ri] : 0.f;
  }
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  for (int i = 0; kt < nkt; ++i) {
    const int next = seg_next_live(tiles, kt + 1, nkt);
    if (next < nkt) {
      load_kv((i + 1) & 1, next * kB);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = kt * kB;
    const bf16* kt_s = Ks + (i & 1) * kB * kLd;
    const bf16* vt_s = Vs + (i & 1) * kB * kLd;
    const int* ks = KSeg + (i & 1) * kB;
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // keys 32 half .. + 31
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd) {
        uint32_t aq[4], ag[4];
        load_a16(aq, Qs, kLd, warp * 16, kd * 16, lane);
        load_a16(ag, Gs, kLd, warp * 16, kd * 16, lane);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          uint32_t bk[4], bv[4];
          load_b16(bk, kt_s, kLd, half * 32 + nj * 16, kd * 16, lane);
          mma_bf16_16816(s[2 * nj], aq, bk);
          mma_bf16_16816(s[2 * nj + 1], aq, bk + 2);
          load_b16(bv, vt_s, kLd, half * 32 + nj * 16, kd * 16, lane);
          mma_bf16_16816(dp[2 * nj], ag, bv);
          mma_bf16_16816(dp[2 * nj + 1], ag, bv + 2);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int hf = c >> 1, kl = half * 32 + j * 8 + 2 * t + (c & 1);
          const int key = k0 + kl;
          const bool ok = row[hf] < S && key < S && ks[kl] == seg[hf] &&
                          (!causal || key <= row[hf]);
          const float p = ok ? expf(s[j][c] - l2[hf]) : 0.f;
          s[j][c] = round_to<bf16>(p * (dp[j][c] - d2[hf]));
        }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t da[4];
        pack_a(da, s, kk);
#pragma unroll
        for (int dj = 0; dj < HD / 16; ++dj) {
          uint32_t bk[4];
          load_bt16(bk, kt_s, kLd, half * 32 + kk * 16, dj * 16, lane);
          mma_bf16_16816(acc[2 * dj], da, bk);
          mma_bf16_16816(acc[2 * dj + 1], da, bk + 2);
        }
      }
    }
    __syncthreads();  // this stage is refilled two tiles later
    kt = next;
  }
  cp_async_wait<0>();  // with no live tile, Gs's group is still in flight

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (row[hf] >= S) continue;
    bf16* out = dq + (size_t)b * S * ldq + (size_t)row[hf] * ldq +
                (size_t)h * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * hf] * scale,
                                acc[j][2 * hf + 1] * scale);
  }
}

// ---- bf16: dk + dv, k-tile major ------------------------------------------
// grid (ceil(S / 64), nkv, B), 128 threads: warp w owns keys k0 + 16 w ..
// + 15; the block walks (head of the group, query tile) pairs with the next
// pair's q, do, lse, dd and segment ids fetched while the current one is
// multiplied.
template <int HD>
constexpr size_t dkv_mma_smem() {
  return sizeof(bf16) * (size_t)(6 * kB * (HD + 8)) +
         sizeof(float) * 2 * 3 * kB;
}

template <int HD>
__global__ void __launch_bounds__(128, 2)
    llm_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const int* __restrict__ qseg,
                     const int* __restrict__ kseg,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dd, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int S, int nh, int nkv,
                     int causal, float scale) {
  constexpr int kLd = HD + 8, kChunks = HD / 8;
  extern __shared__ __align__(16) unsigned char smraw[];
  bf16* Ks = reinterpret_cast<bf16*>(smraw);  // [64][kLd]
  bf16* Vs = Ks + kB * kLd;                   // [64][kLd]
  bf16* Qs = Vs + kB * kLd;                   // [2][64][kLd] qs
  bf16* Gs = Qs + 2 * kB * kLd;               // [2][64][kLd] do
  float* LSE = reinterpret_cast<float*>(Gs + 2 * kB * kLd);  // [2][64]
  float* DD = LSE + 2 * kB;                                  // [2][64]
  int* QSeg = reinterpret_cast<int*>(DD + 2 * kB);           // [2][64]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int NT = (S + kB - 1) / kB;
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z, k0 = kt * kB;
  const int group = nh / nkv;
  const size_t ldq = (size_t)nh * HD, ldk = (size_t)nkv * HD;
  const size_t kvoff = (size_t)b * S * ldk + (size_t)hk * HD;
  const int qt0 = causal ? kt : 0;
  // queries per score slab: 16 at D = 128 (32 left dk + dv at 255
  // registers with spills), 32 at D = 64
  constexpr int kQW = HD == 128 ? 16 : 32, kNJ = kQW / 16;

  __shared__ SegTiles tiles;
  seg_own_ids(tiles, kseg + (size_t)b * S, k0, S, tid);
  seg_mark_live(tiles, qseg + (size_t)b * S, qt0, NT, S, tid, 128);
  cp_rows<HD>(Ks, k + kvoff, ldk, k0, S, tid);
  cp_rows<HD>(Vs, v + kvoff, ldk, k0, S, tid);
  auto load_q = [&](int st, int jh, int qt) {
    const int h = hk * group + jh, r0 = qt * kB;
    const size_t off = (size_t)b * S * ldq + (size_t)h * HD;
    cp_rows<HD>(Qs + st * kB * kLd, q + off, ldq, r0, S, tid);
    cp_rows<HD>(Gs + st * kB * kLd, dout + off, ldq, r0, S, tid);
    if (tid < kB) {
      const bool in = r0 + tid < S;
      const size_t ri = ((size_t)b * nh + h) * S + r0 + tid;
      LSE[st * kB + tid] = in ? lse[ri] : 0.f;
      DD[st * kB + tid] = in ? dd[ri] : 0.f;
      QSeg[st * kB + tid] = in ? qseg[(size_t)b * S + r0 + tid] : 0;
    }
  };
  // the (head of the group, live query tile) pairs, in order
  int jh = 0, qt = seg_next_live(tiles, qt0, NT);
  const bool any = qt < NT;
  if (any) load_q(0, jh, qt);
  cp_async_commit();

  int key[2], seg[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    key[hf] = k0 + warp * 16 + g + 8 * hf;
    seg[hf] = key[hf] < S ? kseg[(size_t)b * S + key[hf]] : 0;
  }
  float adk[HD / 8][4], adv[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) adk[j][c] = adv[j][c] = 0.f;

  for (int it = 0; any && jh < group; ++it) {
    const int st = it & 1;
    int njh = jh, nqt = seg_next_live(tiles, qt + 1, NT);
    if (nqt >= NT) {
      ++njh;
      nqt = seg_next_live(tiles, qt0, NT);
    }
    if (njh < group) {
      load_q((it + 1) & 1, njh, nqt);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // B10's qs: scale and round the q rows this thread copied, in place
    bf16* qs = Qs + st * kB * kLd;
    for (int c = tid; c < kB * kChunks; c += 128) {
      __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(
          qs + (c / kChunks) * kLd + (c % kChunks) * 8);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 f = __bfloat1622float2(p2[u]);
        p2[u] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
    }
    __syncthreads();
    const int q0 = qt * kB;
    const bf16* gs = Gs + st * kB * kLd;
    const float* ls = LSE + st * kB;
    const float* ds_ = DD + st * kB;
    const int* qsg = QSeg + st * kB;
#pragma unroll
    for (int w0 = 0; w0 < kB; w0 += kQW) {  // queries w0 .. w0 + kQW - 1
      float s[2 * kNJ][4], dp[2 * kNJ][4];  // rows = keys, cols = queries
#pragma unroll
      for (int j = 0; j < 2 * kNJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd) {
        uint32_t ak[4], av[4];
        load_a16(ak, Ks, kLd, warp * 16, kd * 16, lane);
        load_a16(av, Vs, kLd, warp * 16, kd * 16, lane);
#pragma unroll
        for (int n = 0; n < kNJ; ++n) {
          uint32_t bq[4], bg[4];
          load_b16(bq, qs, kLd, w0 + n * 16, kd * 16, lane);
          mma_bf16_16816(s[2 * n], ak, bq);
          mma_bf16_16816(s[2 * n + 1], ak, bq + 2);
          load_b16(bg, gs, kLd, w0 + n * 16, kd * 16, lane);
          mma_bf16_16816(dp[2 * n], av, bg);
          mma_bf16_16816(dp[2 * n + 1], av, bg + 2);
        }
      }
#pragma unroll
      for (int j = 0; j < 2 * kNJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int hf = c >> 1, qi = w0 + j * 8 + 2 * t + (c & 1);
          const int qrow = q0 + qi;
          const bool ok = key[hf] < S && qrow < S && qsg[qi] == seg[hf] &&
                          (!causal || qrow >= key[hf]);
          const float p = ok ? expf(s[j][c] - ls[qi]) : 0.f;
          s[j][c] = p;
          dp[j][c] = round_to<bf16>(p * (dp[j][c] - ds_[qi]));
        }
#pragma unroll
      for (int kk = 0; kk < kNJ; ++kk) {
        uint32_t pa[4], da[4];
        pack_a(pa, s, kk);   // p rounded to bf16 here
        pack_a(da, dp, kk);
#pragma unroll
        for (int dj = 0; dj < HD / 16; ++dj) {
          uint32_t bb[4];
          load_bt16(bb, gs, kLd, w0 + kk * 16, dj * 16, lane);
          mma_bf16_16816(adv[2 * dj], pa, bb);
          mma_bf16_16816(adv[2 * dj + 1], pa, bb + 2);
          load_bt16(bb, qs, kLd, w0 + kk * 16, dj * 16, lane);
          mma_bf16_16816(adk[2 * dj], da, bb);
          mma_bf16_16816(adk[2 * dj + 1], da, bb + 2);
        }
      }
    }
    __syncthreads();  // this stage is refilled two pairs later
    jh = njh;
    qt = nqt;
  }
  cp_async_wait<0>();  // with no live pair, K / V's group is still in flight

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (key[hf] >= S) continue;
    const size_t r = kvoff + (size_t)key[hf] * ldk;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int c = j * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dk + r + c) =
          __floats2bfloat162_rn(adk[j][2 * hf], adk[j][2 * hf + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + r + c) =
          __floats2bfloat162_rn(adv[j][2 * hf], adv[j][2 * hf + 1]);
    }
  }
}

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
// floats used) into smem, d-major and/or row-major (either may be null),
// times mul; rows past S are zero
template <int HD>
__device__ __forceinline__ void load_f32(float* dmaj, float* rmaj,
                                         const float* base, size_t ld_g,
                                         int row0, int S, float mul,
                                         int tid) {
  for (int e = tid; e < kB * HD; e += 256) {
    const int r = e / HD, d = e % HD;
    const float x =
        row0 + r < S ? base[(size_t)(row0 + r) * ld_g + d] * mul : 0.f;
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
__global__ void __launch_bounds__(256)
    llm_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const int* __restrict__ qseg,
                   const int* __restrict__ kseg,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dd, float* __restrict__ dq,
                   int S, int nh, int nkv, int causal, float scale) {
  constexpr int kC = HD / 16;
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;                  // [HD][kLdF] qs
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
  load_f32<HD>(Qt, nullptr, q + qoff, ldq, q0, S, scale, tid);
  load_f32<HD>(Gt, nullptr, dout + qoff, ldq, q0, S, 1.f, tid);
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
    load_f32<HD>(Kt, Kr, k + kvoff, ldk, k0, S, 1.f, tid);
    load_f32<HD>(Vt, nullptr, v + kvoff, ldk, k0, S, 1.f, tid);
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
        const float p = ok ? expf(s[i][j] - LSE[r]) : 0.f;
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
__global__ void __launch_bounds__(256)
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
  float* Qt = Vt + HD * kLdF;      // [HD][kLdF] qs of the query tile
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
  load_f32<HD>(Kt, nullptr, k + kvoff, ldk, k0, S, 1.f, tid);
  load_f32<HD>(Vt, nullptr, v + kvoff, ldk, k0, S, 1.f, tid);
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
      load_f32<HD>(Qt, Qr, q + qoff, ldq, q0, S, scale, tid);
      load_f32<HD>(Gt, Gr, dout + qoff, ldq, q0, S, 1.f, tid);
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
          const float p = ok ? expf(s[i][j] - LSE[qi]) : 0.f;
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
      dk[r + j] = adk[i][j];
      dv[r + j] = adv[i][j];
    }
  }
}

template <class K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v,
           const int* qseg, const int* kseg, const void* dout,
           const float* lse, const float* dd, void* dq, void* dk, void* dv,
           int B, int S, int nh, int nkv, int causal, float scale,
           cudaStream_t st) {
  const int NT = (S + kB - 1) / kB;
  const dim3 gq(NT, nh, B), gkv(NT, nkv, B);
  int e;
  if (dtype == kF32) {
    using F = const float*;
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
    if ((e = set_smem(llm_bwd_dq_bf16<HD>, dq_mma_smem<HD>()))) return e;
    llm_bwd_dq_bf16<HD><<<gq, 128, dq_mma_smem<HD>(), st>>>(
        H(q), H(k), H(v), qseg, kseg, H(dout), lse, dd, static_cast<bf16*>(dq),
        S, nh, nkv, causal, scale);
    if ((e = (int)cudaGetLastError())) return e;
    if ((e = set_smem(llm_bwd_dkv_bf16<HD>, dkv_mma_smem<HD>()))) return e;
    llm_bwd_dkv_bf16<HD><<<gkv, 128, dkv_mma_smem<HD>(), st>>>(
        H(q), H(k), H(v), qseg, kseg, H(dout), lse, dd,
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, nh, nkv, causal,
        scale);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ullsam

// Plain C entry point (loaded with ctypes). Returns 0 or a cudaError_t.
// dtype: 0 = float32, 1 = bfloat16 for q, k, v, do, dq, dk, dv; q_seg,
// kv_seg int32 [B, S]; lse, dd float32 [B, nh, S]. Requires D in {64, 128}
// and nh % nkv == 0, S <= 64 * kMaxSegTiles.
extern "C" int llm_flash_attn_backward(
    int dtype, const void* q, const void* k, const void* v,
    const void* q_seg, const void* kv_seg, const void* dout, const void* lse,
    const void* dd, void* dq, void* dk, void* dv, int B, int S, int nh,
    int nkv, int D, int causal, float scale, void* stream) {
  using namespace ullsam;
  if (B < 1 || S < 1 || S > kSegTile * kMaxSegTiles || nkv < 1 ||
      nh % nkv != 0 || B > 65535 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* qs = static_cast<const int*>(q_seg);
  const int* ks = static_cast<const int*>(kv_seg);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dd);
  if (D == 64)
    return launch<64>(dtype, q, k, v, qs, ks, dout, l, d, dq, dk, dv, B, S,
                      nh, nkv, causal, scale, st);
  if (D == 128)
    return launch<128>(dtype, q, k, v, qs, ks, dout, l, d, dq, dk, dv, B, S,
                       nh, nkv, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
