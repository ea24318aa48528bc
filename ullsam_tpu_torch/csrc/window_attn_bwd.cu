// B8: gradient of the windowed ViT attention core (B3) for Hopper (sm_90a).
//
// Replaces the TPU kernel ullsam_tpu/ops/pallas/flash_attention.py
// `_vit_window_bwd_kernel` (via `_vit_window_packed_bwd_impl`). For each
// window of n = kh*kw <= 256 tokens and head of hd channels, with
//     s = q k^T * hd^-1/2 + bias,  bias[i, m] = rel_h[i, row(m)] +
//     rel_w[i, col(m)],  rel_h[i, r] = q_i . Rh[row(i), r],
//     rel_w[i, c] = q_i . Rw[col(i), c],  p = softmax(s)
// and the output gradient do, it returns
//     dv = p^T do,  dp = do v^T,  dd = rowsum(dp * p),  ds = p (dp - dd)
//     drel_h[i, r] = sum_c ds[i, r*kw + c],  drel_w[i, c] = sum_r ds[i, ..]
//     dq = ds k * scale + drel_h Rh[row(i)] + drel_w Rw[col(i)]
//     dk = ds^T q * scale
//     dRh[y, r] = sum over windows, heads and rows i with row(i) = y of
//                 drel_h[i, r] q_i   (dRw likewise by column)
// Rounding points as the TPU kernel (:1236-1263): the softmax, dd and every
// sum are f32; p, ds and drel are rounded to the input dtype before their
// products; the outputs are rounded once at the end. Deterministic: no float
// atomics, every sum in a fixed order.
//
// What bounds it on this card: latency, not operations or bytes. At the
// ViT-B main-path shape (25 windows x 12 heads, n = 196) the five products
// are 7.4 GFLOP (7.5 us at the bf16 peak) against 53 MB to move (16 us at
// the memory rate). The earlier design (every product by f32 FMA on the
// CUDA cores, thread j owning key j) took 1.8082 ms in bf16 there (H100
// 80GB HBM3, 700 W), 4.4 TFLOP/s.
//
// bf16 (head dims 64 and 80, windows up to 16x16): FlashAttention-2's
// backward without atomics, since a whole window fits in one block. One
// block per (head, window), 256 threads. q, k, v and do sit in shared memory
// as [nk][HD + 8] bf16 rows (nk = n rounded up to 16, zero rows past n;
// ldmatrix conflict-free), beside the rel-pos terms of every row in f32
// (on the tensor cores, common.cuh window_rel_terms_mma) and each row's
// max, 1 / sum and dd. Every n x n x HD product is mma.sync m16n8k16 with
// f32 accumulators.
//   * Pass 1, query-major: a warp owns 16 query rows. It holds their whole
//     row of logits in registers (NT = nk / 16 is a template argument),
//     takes the exact softmax, computes dp = do v^T a 16-key tile at a time
//     to sum dd, then again to form ds = p (dp - dd), rounded, which feeds
//     straight from the accumulators both ds k and drel = ds . sel, a 0 / 1
//     selection of each key's window row and column (exact sums, on the
//     tensor cores). ds k * scale goes to an f32 scratch, the rounded drel
//     rows to the `drel` scratch, the row statistics to shared memory.
//   * Pass 2, key-major: a warp owns 16 keys. For each 16-query tile it
//     recomputes s^T = k q^T and dp^T = v do^T, forms p^T and ds^T from the
//     stored statistics, and accumulates dv = p^T do and dk = ds^T q in
//     registers; it writes them once.
//   * Pass 3: the block's share of the table gradients (below).
//   * Pass 4: k, v and do are dead, so the tables and the window's drel
//     rows move into their shared memory, and dq = ds k * scale + drel_h Rh
//     + drel_w Rw is summed there and rounded once (read from device memory,
//     with almost no L1 left beside the shared memory, the tables made dq's
//     rel part the largest cost of an earlier version).
// That is 8 products where the gradient needs 5 (s twice, dp three times):
// at n = 196 still far under the card's rate. Done by FMA, the rel-pos
// work (terms, drel sums, dq's share) took most of the first version's
// time.
//
// float32 (head dims 64 and 80, bwd_tf32): bf16's plan on the tensor cores
// in split TF32 (tf32.cuh): every product, the rel-pos terms, the drel sums
// and dq's rel part included, is mma.sync m16n8k8 on TF32 values, three
// passes (a_hi b_hi + a_hi b_lo + a_lo b_hi) into one f32 accumulator, or
// two against the exact 0 / 1 selection of the drel sums; the hi / lo split
// (cvt.rna) is done in registers as each fragment is read. The tensor
// cores' accumulation is not IEEE's (each step can lose about half an ulp
// of the running sum, one way), so each k-step's passes go into a partial
// from zero that the CUDA cores add (tf32.cuh mma_3xtf32): every output then
// errs against a float64 evaluation no more than the plain f32 version
// does. mma.sync was chosen for the latency-bound n = 196 over wgmma; it
// issues 6 instructions a 16-deep step where bf16 issues one, and the f32
// body runs at about 5x bf16's time (PERF.md section 6).
// Fragments are read from f32 tiles [rows][HD + 4] with scalar loads, free
// of bank conflicts for both row-major and tf32_pi-ordered reads; an A
// operand taken from an accumulator holds its keys in tf32_pi order (keys
// 2 t, 2 t + 1 at k t, t + 4), so the B rows of ds k, p^T do and ds^T q are
// read in that order. Four f32 window tiles at HD = 80 would take 4 x 208 x
// 84 x 4 = 279,552 bytes, over the 232,448 a block has, so the block holds
// two and restages them: q for the rel-pos terms; k and v for pass 1, whose
// warps read their q rows' A fragments from device memory and stage their
// do rows in a tile of their own; q and do for pass 2, whose warps stage
// their k rows and keep their v rows' A fragments in registers (208,576
// bytes at 14 x 14, HD = 80). Pass 1 writes ds k * scale straight into dq
// (f32) and pass 4 adds drel_h Rh, then drel_w Rw, window rows before
// window columns, in the plain version's order. Windows of at most 16 x 16
// (the drel sums' selection), as bf16; 16 x 16 at HD = 80 does not fit. The
// row of logits is a template-sized register array (NT key tiles), compiled
// for the NT of kTf32Nts only.
//
// Table gradients, deterministic in both types: each (window, head)'s share
// in a third pass of its block on the tensor cores (drel^T q per window row
// and column; f32 in split TF32, in place of a CUDA-core kernel that took
// 0.23 ms a ViT-H call), then a last kernel adds the shares in a fixed
// order.
#include "tf32.cuh"

namespace ullsam {
namespace {

constexpr int kMaxKeys = 256;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kSmemLimit = 232448;

__host__ __device__ inline int pad16(int n) { return (n + 15) / 16 * 16; }

// ---- bf16, tensor cores ----------------------------------------------------
// must match ops/kernels/window_attention.py bwd_smem_bytes
template <int HD>
struct BwdMma {
  static constexpr int kLd = HD + 8;
  int nk, rl;
  __host__ __device__ BwdMma(int n, int kh, int kw)
      : nk(pad16(n)), rl(kh + kw) {}
  // q, k, v, do [nk][kLd] bf16; rel terms [nk][rl], m, 1 / l, dd [nk] f32
  __host__ __device__ size_t bytes() const {
    return sizeof(__nv_bfloat16) * 4 * (size_t)nk * kLd +
           sizeof(float) * ((size_t)nk * rl + 3 * (size_t)nk);
  }
};

// dp = do v^T for the 16 rows from r0 (of do in gs) against the 16 keys
// of tile kt of v (rows of vs)
template <int HD>
__device__ __forceinline__ void dp_tile(const __nv_bfloat16* gs, int r0,
                                        const __nv_bfloat16* vs, int kt,
                                        float (&dp)[2][4], int lane) {
  constexpr int kLd = BwdMma<HD>::kLd;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int c = 0; c < 4; ++c) dp[jj][c] = 0.f;
#pragma unroll
  for (int kd = 0; kd < HD / 16; ++kd) {
    uint32_t a[4], b[4];
    ldmatrix_x4(a, smem_u32(gs + (r0 + (lane & 15)) * kLd + kd * 16 +
                            (lane >> 4) * 8));
    ldmatrix_x4(b, smem_u32(vs + (kt * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                     kLd +
                            kd * 16 + ((lane >> 3) & 1) * 8));
    mma_bf16_16816(dp[0], a, b);
    mma_bf16_16816(dp[1], a, b + 2);
  }
}

// The 0 / 1 selection [16 keys of tile kt] x [32 columns]: column c < 16
// sums the keys in window row c, column 16 + c those in window column c
// (kh, kw <= 16). ds . sel is then drel_h | drel_w on the tensor cores:
// exact sums of bf16 values in f32. b[cb] is the B fragment of columns
// cb*8 .. cb*8 + 7; this lane's four keys' row and column are found once.
__device__ __forceinline__ void sel_frags(int kt, int n, int kh, int kw,
                                          float inv_kw, int lane,
                                          uint32_t (&b)[4][2]) {
  const int g = lane >> 2, t = lane & 3;
  int kr[4], kc[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {  // keys 2t, 2t + 1, 8 + 2t, 9 + 2t
    const int key = kt * 16 + 8 * (u >> 1) + 2 * t + (u & 1);
    kr[u] = key < n ? div_small(key, inv_kw) : -1;
    kc[u] = key < n ? key - kr[u] * kw : -1;
  }
#pragma unroll
  for (int cb = 0; cb < 4; ++cb) {
    const int c = (cb & 1) * 8 + g;
    const bool isw = cb >= 2, ok = c < (isw ? kw : kh);
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int u = 2 * h2 + e;
        v[e] = ok && (isw ? kc[u] : kr[u]) == c ? 1.f : 0.f;
      }
      b[cb][h2] = pack_bf16(v[0], v[1]);
    }
  }
}

// grid (nh, Bw), 256 threads. qkv [Bw*n, 3C], do [Bw*n, C], dqkv [Bw*n, 3C];
// rh [kh, kh, HD], rw [kw, kw, HD]; drel [Bw, nh, n, kh + kw] f32 and part
// [Bw, nh, (kh*kh + kw*kw) * HD] f32 (this block's share of dRh | dRw);
// dqf [Bw*n, C] f32 holds ds k * scale from pass 1 to pass 4
template <int HD, int NT>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_mma(const __nv_bfloat16* __restrict__ qkv,
            const __nv_bfloat16* __restrict__ rh,
            const __nv_bfloat16* __restrict__ rw,
            const __nv_bfloat16* __restrict__ dout,
            __nv_bfloat16* __restrict__ dqkv, float* __restrict__ drel,
            float* __restrict__ part, float* __restrict__ dqf, int n, int C,
            int nh, int kh, int kw, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int kLd = BwdMma<HD>::kLd, kChunks = HD / 8, nk = NT * 16;
  const int rl = kh + kw;
  extern __shared__ __align__(16) unsigned char smraw[];
  bf16* Qs = reinterpret_cast<bf16*>(smraw);
  bf16* Ks = Qs + nk * kLd;
  bf16* Vs = Ks + nk * kLd;
  bf16* Gs = Vs + nk * kLd;                               // do
  float* RB = reinterpret_cast<float*>(Gs + nk * kLd);    // [nk][rl]
  float* Ms = RB + nk * rl;                               // max (base 2)
  float* Li = Ms + nk;                                    // 1 / sum
  float* Dd = Li + nk;                                    // dd

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, win = blockIdx.y;
  const size_t C3 = 3 * (size_t)C;
  const bf16* base = qkv + (size_t)win * n * C3 + h * HD;
  const bf16* gbase = dout + (size_t)win * n * C + h * HD;
  bf16* dbase = dqkv + (size_t)win * n * C3 + h * HD;
  float* drel_b = drel + ((size_t)win * nh + h) * n * rl;
  float* dqf_b = dqf + (size_t)win * n * C + h * HD;

  // q first, in its own group: its rel-pos terms overlap the other loads
  for (int c = tid; c < nk * kChunks; c += kThreads) {
    const int row = c / kChunks, ch = (c % kChunks) * 8;
    const bool ok = row < n;
    cp_async16(smem_u32(Qs + row * kLd + ch),
               base + (size_t)(ok ? row : 0) * C3 + ch, ok);
  }
  cp_async_commit();
  for (int c = tid; c < nk * kChunks; c += kThreads) {
    const int row = c / kChunks, ch = (c % kChunks) * 8;
    const bool ok = row < n;
    const bf16* src = base + (size_t)(ok ? row : 0) * C3 + ch;
    const int o = row * kLd + ch;
    cp_async16(smem_u32(Ks + o), src + C, ok);
    cp_async16(smem_u32(Vs + o), src + 2 * C, ok);
    cp_async16(smem_u32(Gs + o), gbase + (size_t)(ok ? row : 0) * C + ch, ok);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  window_rel_terms_mma<HD, 1>(
      Qs, [](int r, int ch) { return r * kLd + 8 * ch; }, 0, nk, rh, rw, n,
      kh, kw, RB, rl, warp, kWarps, lane);
  cp_async_wait<0>();
  __syncthreads();

  const float inv_kw = 1.f / kw;
  // ---- pass 1: a warp's 16 query rows --------------------------------------
  for (int qt = warp; qt < NT; qt += kWarps) {
    const int r0 = qt * 16;
    float s[2 * NT][4];
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
    for (int kd = 0; kd < HD / 16; ++kd) {
      uint32_t qf[4];
      ldmatrix_x4(qf, smem_u32(Qs + (r0 + (lane & 15)) * kLd + kd * 16 +
                               (lane >> 4) * 8));
#pragma unroll
      for (int nj = 0; nj < NT; ++nj) {
        uint32_t b[4];
        ldmatrix_x4(b, smem_u32(Ks +
                                (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                    kLd +
                                kd * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16_16816(s[2 * nj], qf, b);
        mma_bf16_16816(s[2 * nj + 1], qf, b + 2);
      }
    }
    // the exact softmax of the rows, p in f32 (s in base 2)
    const float* rb0 = RB + (r0 + g) * rl;
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = j * 8 + 2 * t + e;
        const int kr = div_small(key, inv_kw), kc = key - kr * kw;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float* rb = rb0 + hf * 8 * rl;
          float& x = s[j][2 * hf + e];
          x = key < n ? (x * scale + rb[kr] + rb[kh + kc]) * kLog2e
                      : -INFINITY;
          m[hf] = fmaxf(m[hf], x);
        }
      }
    float l[2] = {0.f, 0.f}, li[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 1));
      m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 2));
    }
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] = exp2f(s[j][c] - m[c >> 1]);
        l[c >> 1] += s[j][c];
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
      li[hf] = 1.f / l[hf];
    }
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] *= li[c >> 1];

    // dd = rowsum(dp * p), dp one 16-key tile at a time
    float dd[2] = {0.f, 0.f};
#pragma unroll
    for (int kt = 0; kt < NT; ++kt) {
      float dp[2][4];
      dp_tile<HD>(Gs, r0, Vs, kt, dp, lane);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          dd[c >> 1] = fmaf(s[2 * kt + jj][c], dp[jj][c], dd[c >> 1]);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      dd[hf] += __shfl_xor_sync(0xffffffffu, dd[hf], 1);
      dd[hf] += __shfl_xor_sync(0xffffffffu, dd[hf], 2);
    }
    if (t == 0) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        Ms[r0 + g + 8 * hf] = m[hf];
        Li[r0 + g + 8 * hf] = li[hf];
        Dd[r0 + g + 8 * hf] = dd[hf];
      }
    }

    // ds = p (dp - dd) rounded, as the A fragments of dq = ds k and of
    // drel = ds . sel (drel_h in columns 0-15, drel_w in 16-31)
    float acc[HD / 8][4], dr[4][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
#pragma unroll
    for (int cb = 0; cb < 4; ++cb)
#pragma unroll
      for (int c = 0; c < 4; ++c) dr[cb][c] = 0.f;
#pragma unroll
    for (int kt = 0; kt < NT; ++kt) {
      float dp[2][4];
      dp_tile<HD>(Gs, r0, Vs, kt, dp, lane);
      uint32_t da[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float* p = s[2 * kt + jj] + 2 * hf;
          const float* d = dp[jj] + 2 * hf;
          da[2 * jj + hf] = pack_bf16(p[0] * (d[0] - dd[hf]),
                                      p[1] * (d[1] - dd[hf]));
        }
#pragma unroll
      for (int dj = 0; dj < HD / 16; ++dj) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, smem_u32(Ks + (kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 kLd +
                        dj * 16 + (lane >> 4) * 8));
        mma_bf16_16816(acc[2 * dj], da, b);
        mma_bf16_16816(acc[2 * dj + 1], da, b + 2);
      }
      uint32_t sb[4][2];
      sel_frags(kt, n, kh, kw, inv_kw, lane, sb);
#pragma unroll
      for (int cb = 0; cb < 4; ++cb) mma_bf16_16816(dr[cb], da, sb[cb]);
    }
    // drel rounded; into the scratch for dq's rel part and the tables
#pragma unroll
    for (int cb = 0; cb < 4; ++cb)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = r0 + g + 8 * (c >> 1), col = cb * 8 + 2 * t + (c & 1);
        const int cc = col & 15;
        if (i < n && cc < (col >= 16 ? kw : kh))
          drel_b[(size_t)i * rl + (col >= 16 ? kh : 0) + cc] =
              round_to<bf16>(dr[cb][c]);
      }
    // ds k * scale, unrounded, for pass 4
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = r0 + g + 8 * hf;
      if (i >= n) continue;
      float* row = dqf_b + (size_t)i * C + 2 * t;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(row + j * 8) =
            make_float2(acc[j][2 * hf] * scale, acc[j][2 * hf + 1] * scale);
    }
  }
  __syncthreads();  // every row's statistics

  // ---- pass 2: a warp's 16 keys ------------------------------------------
  for (int kt = warp; kt < NT; kt += kWarps) {
    const int m0 = kt * 16;
    uint32_t kf[HD / 16][4], vf[HD / 16][4];
#pragma unroll
    for (int kd = 0; kd < HD / 16; ++kd) {
      const int o = (m0 + (lane & 15)) * kLd + kd * 16 + (lane >> 4) * 8;
      ldmatrix_x4(kf[kd], smem_u32(Ks + o));
      ldmatrix_x4(vf[kd], smem_u32(Vs + o));
    }
    float dv[HD / 8][4], dk[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) dv[j][c] = dk[j][c] = 0.f;
    // this thread's keys m0 + g + 8 hf: validity and table indices
    int kr[2], kc[2];
    bool kok[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = m0 + g + 8 * hf;
      kok[hf] = key < n;
      kr[hf] = div_small(key, inv_kw);
      kc[hf] = kh + key - kr[hf] * kw;
    }
#pragma unroll 1
    for (int qt = 0; qt < NT; ++qt) {
      const int i0 = qt * 16;
      float sT[2][4], dpT[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int c = 0; c < 4; ++c) sT[jj][c] = dpT[jj][c] = 0.f;
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd) {
        const int o = (i0 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                      kd * 16 + ((lane >> 3) & 1) * 8;
        uint32_t b[4];
        ldmatrix_x4(b, smem_u32(Qs + o));
        mma_bf16_16816(sT[0], kf[kd], b);
        mma_bf16_16816(sT[1], kf[kd], b + 2);
        ldmatrix_x4(b, smem_u32(Gs + o));
        mma_bf16_16816(dpT[0], vf[kd], b);
        mma_bf16_16816(dpT[1], vf[kd], b + 2);
      }
      // element (key m0 + g + 8 hf, query i0 + 8 jj + 2 t + e)
      uint32_t pa[4], da[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float pv[2], dv2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = i0 + 8 * jj + 2 * t + e;
            const float* rb = RB + i * rl;
            const float x =
                kok[hf] ? (sT[jj][2 * hf + e] * scale + rb[kr[hf]] +
                           rb[kc[hf]]) * kLog2e
                        : -INFINITY;
            const float p = exp2f(x - Ms[i]) * Li[i];
            pv[e] = p;
            dv2[e] = p * (dpT[jj][2 * hf + e] - Dd[i]);
          }
          pa[2 * jj + hf] = pack_bf16(pv[0], pv[1]);
          da[2 * jj + hf] = pack_bf16(dv2[0], dv2[1]);
        }
#pragma unroll
      for (int dj = 0; dj < HD / 16; ++dj) {
        const int o = (i0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                      dj * 16 + (lane >> 4) * 8;
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_u32(Gs + o));
        mma_bf16_16816(dv[2 * dj], pa, b);
        mma_bf16_16816(dv[2 * dj + 1], pa, b + 2);
        ldmatrix_x4_trans(b, smem_u32(Qs + o));
        mma_bf16_16816(dk[2 * dj], da, b);
        mma_bf16_16816(dk[2 * dj + 1], da, b + 2);
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (!kok[hf]) continue;
      bf16* row = dbase + (size_t)(m0 + g + 8 * hf) * C3;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int d = j * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(row + C + d) =
            __floats2bfloat162_rn(dk[j][2 * hf] * scale,
                                  dk[j][2 * hf + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(row + 2 * C + d) =
            __floats2bfloat162_rn(dv[j][2 * hf], dv[j][2 * hf + 1]);
      }
    }
  }

  // ---- pass 3: this (window, head)'s share of the table gradients ---------
  // dRh[y, r] = sum_x drel_h[y*kw + x, r] q[y*kw + x] and dRw[x, c] = sum_y
  // drel_w[y*kw + x, c] q[y*kw + x]: per window row y (column x) one
  // [16 entries x 16 members] . [16 members x HD] product, A the rounded
  // drel (exact in bf16), B the members' q rows
  float* pw = part + ((size_t)win * nh + h) * (kh * kh + kw * kw) * HD;
  for (int grp = warp; grp < rl; grp += kWarps) {
    const bool isw = grp >= kh;
    const int a = isw ? grp - kh : grp;  // y or x
    const int len = isw ? kh : kw, ncol = isw ? kw : kh;
    const int first = isw ? a : a * kw, step = isw ? kw : 1;
    uint32_t af[4];
#pragma unroll
    for (int q4 = 0; q4 < 4; ++q4) {
      const int m = g + 8 * (q4 & 1), k = 2 * t + 8 * (q4 >> 1);
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        v[e] = m < ncol && k + e < len
                   ? drel_b[(size_t)(first + (k + e) * step) * rl +
                            (isw ? kh : 0) + m]
                   : 0.f;
      af[q4] = pack_bf16(v[0], v[1]);
    }
    const int kb = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int qrow = kb < len ? first + kb * step : first;
    float* dst = pw + (isw ? kh * kh * HD + (size_t)a * kw * HD
                           : (size_t)a * kh * HD);
#pragma unroll
    for (int dj = 0; dj < HD / 16; ++dj) {
      uint32_t b[4];
      ldmatrix_x4_trans(
          b, smem_u32(Qs + qrow * kLd + dj * 16 + (lane >> 4) * 8));
      float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16_16816(c0, af, b);
      mma_bf16_16816(c1, af, b + 2);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = g + 8 * hf;
        if (m >= ncol) continue;
        float* row = dst + (size_t)m * HD + dj * 16 + 2 * t;
        *reinterpret_cast<float2*>(row) =
            make_float2(c0[2 * hf], c0[2 * hf + 1]);
        *reinterpret_cast<float2*>(row + 8) =
            make_float2(c1[2 * hf], c1[2 * hf + 1]);
      }
    }
  }

  // ---- pass 4: dq = ds k * scale + drel_h Rh[row(i)] + drel_w Rw[col(i)] --
  // k, v and do are dead: the tables and the window's drel rows move into
  // their shared memory (read in place where they do not fit), then each
  // thread finishes pairs of dq channels, summing in a fixed order, and
  // rounds them once
  __syncthreads();
  const int eh = kh * kh * HD, et = eh + kw * kw * HD;
  const bool fit = (size_t)et * sizeof(bf16) + (size_t)n * rl * sizeof(float)
                   <= 3 * (size_t)nk * kLd * sizeof(bf16);
  const bf16* Th = rh;
  const bf16* Tw = rw;
  const float* DR = drel_b;
  if (fit) {
    bf16* T = Ks;
    float* D = reinterpret_cast<float*>(T + et);  // et * 2 bytes: 16-aligned
    for (int c = tid; c < et / 8; c += kThreads)
      reinterpret_cast<uint4*>(T)[c] =
          c < eh / 8 ? reinterpret_cast<const uint4*>(rh)[c]
                     : reinterpret_cast<const uint4*>(rw)[c - eh / 8];
    for (int e = tid; e < n * rl; e += kThreads) D[e] = drel_b[e];
    __syncthreads();
    Th = T;
    Tw = T + eh;
    DR = D;
  }
  for (int e = tid; e < n * (HD / 2); e += kThreads) {
    const int i = e / (HD / 2), d = 2 * (e - i * (HD / 2));
    const int y = i / kw, x = i - y * kw;
    float2 a = *reinterpret_cast<const float2*>(dqf_b + (size_t)i * C + d);
    const float* dr = DR + (size_t)i * rl;
    const bf16* th = Th + (size_t)y * kh * HD + d;
    for (int r = 0; r < kh; ++r) {
      const float2 tv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(th + (size_t)r * HD));
      a.x = fmaf(dr[r], tv.x, a.x);
      a.y = fmaf(dr[r], tv.y, a.y);
    }
    const bf16* tw = Tw + (size_t)x * kw * HD + d;
    for (int c = 0; c < kw; ++c) {
      const float2 tv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(tw + (size_t)c * HD));
      a.x = fmaf(dr[kh + c], tv.x, a.x);
      a.y = fmaf(dr[kh + c], tv.y, a.y);
    }
    *reinterpret_cast<__nv_bfloat162*>(dbase + (size_t)i * C3 + d) =
        __floats2bfloat162_rn(a.x, a.y);
  }
}

// the instance whose NT is nt (1 <= nt <= 16)
template <int HD, int NT = 1>
int launch_mma(int nt, const __nv_bfloat16* qkv, const __nv_bfloat16* rh,
               const __nv_bfloat16* rw, const __nv_bfloat16* dout,
               __nv_bfloat16* dqkv, float* drel, float* part, float* dqf,
               int Bw, int n, int C, int nh, int kh, int kw, float scale,
               cudaStream_t st) {
  if constexpr (NT < kMaxKeys / 16) {
    if (nt != NT)
      return launch_mma<HD, NT + 1>(nt, qkv, rh, rw, dout, dqkv, drel, part,
                                    dqf, Bw, n, C, nh, kh, kw, scale, st);
  }
  const size_t smem = BwdMma<HD>(n, kh, kw).bytes();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_mma<HD, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  bwd_mma<HD, NT><<<dim3(nh, Bw), kThreads, smem, st>>>(
      qkv, rh, rw, dout, dqkv, drel, part, dqf, n, C, nh, kh, kw, scale);
  return (int)cudaGetLastError();
}

// ---- float32, split TF32 on the tensor cores (head dims 64 and 80) ------

// The f32 kernel's instances by key tiles NT: a window of nt tiles runs the
// first NT >= nt (the extra tiles are padding, masked as any key or query
// past n), so that 10 instances, not 32, are compiled
constexpr int kTf32Nts[] = {2, 4, 8, 13, 16};
constexpr int kTf32NtCount = sizeof(kTf32Nts) / sizeof(int);

inline int tf32_nt(int n) {
  const int nt = pad16(n) / 16;
  for (int i = 0; i < kTf32NtCount; ++i)
    if (kTf32Nts[i] >= nt) return kTf32Nts[i];
  return kMaxKeys / 16;
}

// must match ops/kernels/window_attention.py bwd_smem_bytes
template <int HD>
struct BwdTf32 {
  // f32 row stride: a multiple of 4 floats (16-byte rows for cp.async) that
  // is 4 mod 8, so that every fragment read below is free of bank conflicts
  static constexpr int kLd = HD + 4;
  int nk, rl;
  BwdTf32(int n, int kh, int kw) : nk(16 * tf32_nt(n)), rl(kh + kw) {}
  // two tiles [nk][kLd] (q; then k and v; then q and do), a [16][kLd] tile
  // for each warp (its do rows in pass 1, its k rows in pass 2), the rel
  // terms [nk][rl] and each row's max, 1 / sum and dd, all f32
  size_t bytes() const {
    return sizeof(float) * (2 * (size_t)nk * kLd + kWarps * 16 * kLd +
                            (size_t)nk * rl + 3 * (size_t)nk);
  }
};

// rows [0, rows) of an f32 [rows][HD] block at src (row stride `stride`
// floats) into dst [.][HD + 4] by cp.async, rows from nvalid on zero-filled
template <int HD>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           size_t stride, int rows,
                                           int nvalid, int tid, int nthr) {
  constexpr int kCh = HD / 4, kLd = HD + 4;
  for (int c = tid; c < rows * kCh; c += nthr) {
    const int r = c / kCh, ch = (c - r * kCh) * 4;
    const bool ok = r < nvalid;
    cp_async16(smem_u32(dst + r * kLd + ch),
               src + (size_t)(ok ? r : 0) * stride + ch, ok);
  }
}

template <int N>
__device__ __forceinline__ void split_n(const float (&x)[N],
                                        uint32_t (&hi)[N],
                                        uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) tf32_split(x[i], hi[i], lo[i]);
}

// the m16n8k8 A fragment of rows r and r8 (the thread's g and g + 8) and
// columns k0 + t, + 4 of a row-major f32 tile with row stride ld
__device__ __forceinline__ void frag_a(const float* X, int ld, int r, int r8,
                                       int k0, int t, float (&a)[4]) {
  a[0] = X[r * ld + k0 + t];
  a[1] = X[r8 * ld + k0 + t];
  a[2] = X[r * ld + k0 + t + 4];
  a[3] = X[r8 * ld + k0 + t + 4];
}

// the B fragment whose n index is row n0 + g of a row-major tile and whose
// k index its columns k0 + t, + 4 (X^T as B)
__device__ __forceinline__ void frag_b_rows(const float* X, int ld, int n0,
                                            int k0, int g, int t,
                                            uint32_t (&bh)[2],
                                            uint32_t (&bl)[2]) {
  const float* x = X + (n0 + g) * ld + k0 + t;
  tf32_split(x[0], bh[0], bl[0]);
  tf32_split(x[4], bh[1], bl[1]);
}

// the B fragment whose k index runs over rows k0 .. k0 + 7 of a row-major
// tile in tf32_pi order (rows k0 + 2 t, + 1: the k order of an A operand
// taken from an m16n8 accumulator) and whose n index is column n0 + g
__device__ __forceinline__ void frag_b_pi(const float* X, int ld, int k0,
                                          int n0, int g, int t,
                                          uint32_t (&bh)[2],
                                          uint32_t (&bl)[2]) {
  const float* x = X + (k0 + 2 * t) * ld + n0 + g;
  tf32_split(x[0], bh[0], bl[0]);
  tf32_split(x[ld], bh[1], bl[1]);
}

// the accumulator c [16 x 8] (c0, c1 row g, c2, c3 row g + 8) as the A
// fragment of a k-step over its 8 columns, in tf32_pi order, split
__device__ __forceinline__ void acc_to_a(const float (&c)[4],
                                         uint32_t (&ah)[4],
                                         uint32_t (&al)[4]) {
  const float a[4] = {c[0], c[2], c[1], c[3]};
  split_n(a, ah, al);
}

// Per window row y (column x), the group's rows i (y kw + x over x, or
// over y) against one table: out[i][col] = sum_d A[i][d] T[col][d] (the
// rel-pos terms: A = q, T = Rh[y] or Rw[x]) in split TF32; a warp a group
template <int HD>
__device__ void rel_terms_tf32(const float* Qs, const float* rh,
                               const float* rw, int n, int nk, int kh,
                               int kw, float* RB, int rl, int warp,
                               int lane) {
  constexpr int kLd = BwdTf32<HD>::kLd;
  const int g = lane >> 2, t = lane & 3;
  for (int e = warp * 32 + lane; e < (nk - n) * rl; e += kThreads)
    RB[n * rl + e] = 0.f;
  for (int it = warp; it < kh + kw; it += kWarps) {
    const bool isw = it >= kh;
    const int grp = isw ? it - kh : it;  // y or x
    const int len = isw ? kh : kw, ncol = isw ? kw : kh;
    const int step = isw ? kw : 1, first = isw ? grp : grp * kw;
    const float* tab = isw ? rw + (size_t)grp * kw * HD
                           : rh + (size_t)grp * kh * HD;
    const int ra = g < len ? first + g * step : first;
    const int ra8 = g + 8 < len ? first + (g + 8) * step : first;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 2
    for (int kd = 0; kd < HD / 8; ++kd) {
      float a[4];
      frag_a(Qs, kLd, ra, ra8, 8 * kd, t, a);
      uint32_t ah[4], al[4];
      split_n(a, ah, al);
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const float* trow =
            tab + (size_t)min(c2 * 8 + g, ncol - 1) * HD + 8 * kd + t;
        uint32_t bh[2], bl[2];
        tf32_split(trow[0], bh[0], bl[0]);
        tf32_split(trow[4], bh[1], bl[1]);
        mma_3xtf32(acc[c2], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int c2 = 0; c2 < 2; ++c2)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jr = g + 8 * (c >> 1), col = c2 * 8 + 2 * t + (c & 1);
        if (jr < len && col < ncol)
          RB[(first + jr * step) * rl + (isw ? kh : 0) + col] = acc[c2][c];
      }
  }
}

// dq[i] += sum_c drel[i][off + c] T[c] for the rows i of window row y (or
// column x) against its table (Rh[y] or Rw[x]) in split TF32: one group a
// warp, the groups of one kind (rows if !isw, columns if isw)
template <int HD>
__device__ void dq_rel_tf32(bool isw, const float* drel, const float* rh,
                            const float* rw, float* dq, size_t ldq, int kh,
                            int kw, int rl, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int grp = warp; grp < (isw ? kw : kh); grp += kWarps) {
    const int len = isw ? kh : kw, ncol = isw ? kw : kh;
    const int step = isw ? kw : 1, first = isw ? grp : grp * kw;
    const int off = isw ? kh : 0;
    const float* tab = isw ? rw + (size_t)grp * kw * HD
                           : rh + (size_t)grp * kh * HD;
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      float a[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = g + 8 * (u & 1), c = 8 * ks + t + 4 * (u >> 1);
        a[u] = j < len && c < ncol
                   ? drel[(size_t)(first + j * step) * rl + off + c]
                   : 0.f;
      }
      split_n(a, ah[ks], al[ks]);
    }
#pragma unroll 2
    for (int nb = 0; nb < HD / 8; ++nb) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t bh[2], bl[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = 8 * ks + t + 4 * u;
          tf32_split(c < ncol ? tab[(size_t)c * HD + 8 * nb + g] : 0.f,
                     bh[u], bl[u]);
        }
        mma_3xtf32(acc, ah[ks], al[ks], bh, bl);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = g + 8 * hf;
        if (j >= len) continue;
        float2* o = reinterpret_cast<float2*>(
            dq + (size_t)(first + j * step) * ldq + 8 * nb + 2 * t);
        const float2 v = *o;
        *o = make_float2(v.x + acc[2 * hf], v.y + acc[2 * hf + 1]);
      }
    }
  }
}

// This (window, head)'s share of the table gradients in split TF32, one
// group a warp: dRh[y][r] = sum_x drel_h[y kw + x][r] q[y kw + x] (members
// x of window row y, entries r), dRw[x][c] likewise over the members y of
// window column x; pw [kh kh + kw kw][HD] in bf16's `part` layout, q the
// tile Qs [nk][HD + 4]
template <int HD>
__device__ void tables_tf32(const float* drel, const float* Qs, float* pw,
                            int kh, int kw, int rl, int warp, int lane) {
  constexpr int kLd = BwdTf32<HD>::kLd;
  const int g = lane >> 2, t = lane & 3;
  for (int it = warp; it < kh + kw; it += kWarps) {
    const bool isw = it >= kh;
    const int grp = isw ? it - kh : it;  // y or x
    const int len = isw ? kh : kw, ncol = isw ? kw : kh;  // members, entries
    const int step = isw ? kw : 1, first = isw ? grp : grp * kw;
    const int off = isw ? kh : 0;
    float* dst = pw + (isw ? kh * kh * HD + (size_t)grp * kw * HD
                           : (size_t)grp * kh * HD);
    // A [entries][members] = drel^T: register u of k-step ks holds entry
    // g + 8 (u & 1), member 8 ks + t + 4 (u >> 1)
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      float a[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = g + 8 * (u & 1), m = 8 * ks + t + 4 * (u >> 1);
        a[u] = j < ncol && m < len
                   ? drel[(size_t)(first + m * step) * rl + off + j]
                   : 0.f;
      }
      split_n(a, ah[ks], al[ks]);
    }
#pragma unroll 2
    for (int nb = 0; nb < HD / 8; ++nb) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t bh[2], bl[2];  // B [members][channels]: q rows
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int m = 8 * ks + t + 4 * u;
          tf32_split(m < len ? Qs[(first + m * step) * kLd + 8 * nb + g]
                             : 0.f,
                     bh[u], bl[u]);
        }
        mma_3xtf32(acc, ah[ks], al[ks], bh, bl);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = g + 8 * hf;
        if (j < ncol)
          *reinterpret_cast<float2*>(dst + (size_t)j * HD + 8 * nb + 2 * t) =
              make_float2(acc[2 * hf], acc[2 * hf + 1]);
      }
    }
  }
}

// grid (nh, Bw), 256 threads; the layout of the bf16 kernel's arguments in
// f32 (dqf unused: dq accumulates in dqkv itself)
template <int HD, int NT>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_tf32(const float* __restrict__ qkv, const float* __restrict__ rh,
             const float* __restrict__ rw, const float* __restrict__ dout,
             float* __restrict__ dqkv, float* __restrict__ drel,
             float* __restrict__ part, int n, int C, int nh, int kh, int kw,
             float scale) {
  constexpr int kLd = BwdTf32<HD>::kLd, nk = NT * 16;
  const int rl = kh + kw;
  extern __shared__ __align__(16) float smf[];
  float* T0 = smf;                  // q, then k, then q   [nk][kLd]
  float* T1 = T0 + nk * kLd;        // v, then do          [nk][kLd]
  float* Wt = T1 + nk * kLd;        // [kWarps][16][kLd]
  float* RB = Wt + kWarps * 16 * kLd;  // [nk][rl]
  float* Ms = RB + nk * rl;         // max
  float* Li = Ms + nk;              // 1 / sum
  float* Dd = Li + nk;              // dd

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, win = blockIdx.y;
  const size_t C3 = 3 * (size_t)C;
  const float* base = qkv + (size_t)win * n * C3 + h * HD;
  const float* gbase = dout + (size_t)win * n * C + h * HD;
  float* dbase = dqkv + (size_t)win * n * C3 + h * HD;
  float* drel_b = drel + ((size_t)win * nh + h) * n * rl;
  float* Ww = Wt + warp * 16 * kLd;  // this warp's tile
  const float inv_kw = 1.f / kw;

  // q, its rel-pos terms; then k and v in its place
  stage_rows<HD>(T0, base, C3, nk, n, tid, kThreads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  rel_terms_tf32<HD>(T0, rh, rw, n, nk, kh, kw, RB, rl, warp, lane);
  __syncthreads();
  stage_rows<HD>(T0, base + C, C3, nk, n, tid, kThreads);
  stage_rows<HD>(T1, base + 2 * C, C3, nk, n, tid, kThreads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // ---- pass 1: a warp's 16 query rows --------------------------------------
  for (int qt = warp; qt < NT; qt += kWarps) {
    const int r0 = qt * 16, ra = r0 + g, ra8 = ra + 8;
    __syncwarp();
    stage_rows<HD>(Ww, gbase + (size_t)r0 * C, C, 16, n - r0, lane, 32);
    cp_async_commit();
    // s = q k^T: q's A fragments from device memory, k's B from T0
    float s[2 * NT][4];
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll 1
    for (int kd = 0; kd < HD / 8; ++kd) {
      float a[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int row = (u & 1) ? ra8 : ra;
        a[u] = row < n ? base[(size_t)row * C3 + 8 * kd + t + 4 * (u >> 1)]
                       : 0.f;
      }
      uint32_t ah[4], al[4];
      split_n(a, ah, al);
#pragma unroll
      for (int nj = 0; nj < 2 * NT; ++nj) {
        uint32_t bh[2], bl[2];
        frag_b_rows(T0, kLd, 8 * nj, 8 * kd, g, t, bh, bl);
        mma_3xtf32(s[nj], ah, al, bh, bl);
      }
    }
    // the exact softmax of the rows in f32
    const float* rb0 = RB + ra * rl;
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = j * 8 + 2 * t + e;
        const int kr = div_small(key, inv_kw), kc = key - kr * kw;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float* rb = rb0 + hf * 8 * rl;
          float& x = s[j][2 * hf + e];
          x = key < n ? x * scale + (rb[kr] + rb[kh + kc]) : -INFINITY;
          m[hf] = fmaxf(m[hf], x);
        }
      }
    float l[2] = {0.f, 0.f}, li[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 1));
      m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 2));
    }
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] = expf(s[j][c] - m[c >> 1]);
        l[c >> 1] += s[j][c];
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
      li[hf] = 1.f / l[hf];
    }
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] *= li[c >> 1];
    cp_async_wait<0>();
    __syncwarp();  // the warp's do rows in Ww

    // dp = do v^T of the rows against the 16 keys of tile kt
    const auto dp_tile = [&](int kt, float (&dp)[2][4]) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int c = 0; c < 4; ++c) dp[jj][c] = 0.f;
#pragma unroll 2
      for (int kd = 0; kd < HD / 8; ++kd) {
        float a[4];
        frag_a(Ww, kLd, g, g + 8, 8 * kd, t, a);
        uint32_t ah[4], al[4];
        split_n(a, ah, al);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t bh[2], bl[2];
          frag_b_rows(T1, kLd, kt * 16 + 8 * jj, 8 * kd, g, t, bh, bl);
          mma_3xtf32(dp[jj], ah, al, bh, bl);
        }
      }
    };
    // dd = rowsum(dp * p)
    float dd[2] = {0.f, 0.f};
#pragma unroll
    for (int kt = 0; kt < NT; ++kt) {
      float dp[2][4];
      dp_tile(kt, dp);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          dd[c >> 1] = fmaf(s[2 * kt + jj][c], dp[jj][c], dd[c >> 1]);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      dd[hf] += __shfl_xor_sync(0xffffffffu, dd[hf], 1);
      dd[hf] += __shfl_xor_sync(0xffffffffu, dd[hf], 2);
    }
    if (t == 0) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        Ms[ra + 8 * hf] = m[hf];
        Li[ra + 8 * hf] = li[hf];
        Dd[ra + 8 * hf] = dd[hf];
      }
    }

    // ds = p (dp - dd) as the A operand of dq += ds k and of drel = ds .
    // sel (drel_h in columns 0-15, drel_w in 16-31: 0 / 1, exact in TF32,
    // so two passes)
    float acc[HD / 8][4], dr[4][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
#pragma unroll
    for (int cb = 0; cb < 4; ++cb)
#pragma unroll
      for (int c = 0; c < 4; ++c) dr[cb][c] = 0.f;
#pragma unroll
    for (int kt = 0; kt < NT; ++kt) {
      float dp[2][4];
      dp_tile(kt, dp);
      // the keys of this lane's B rows, 16 kt + 8 jj + 2 t + e
      int kr[2][2], kc[2][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kt * 16 + 8 * jj + 2 * t + e;
          kr[jj][e] = key < n ? div_small(key, inv_kw) : -1;
          kc[jj][e] = key < n ? key - kr[jj][e] * kw : -1;
        }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        float d4[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          d4[c] = s[2 * kt + jj][c] * (dp[jj][c] - dd[c >> 1]);
        uint32_t ah[4], al[4];
        acc_to_a(d4, ah, al);
#pragma unroll
        for (int nb = 0; nb < HD / 8; ++nb) {
          uint32_t bh[2], bl[2];
          frag_b_pi(T0, kLd, kt * 16 + 8 * jj, 8 * nb, g, t, bh, bl);
          mma_3xtf32(acc[nb], ah, al, bh, bl);
        }
#pragma unroll
        for (int cb = 0; cb < 4; ++cb) {
          const int c = (cb & 1) * 8 + g;
          const bool isw = cb >= 2, ok = c < (isw ? kw : kh);
          uint32_t b[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            b[e] = ok && (isw ? kc[jj][e] : kr[jj][e]) == c ? 0x3f800000u
                                                             : 0u;
          mma_2xtf32(dr[cb], ah, al, b);
        }
      }
    }
    // drel into the scratch (dq's rel part, the tables); ds k * scale
    // into dq's columns, its rel part added in pass 4
#pragma unroll
    for (int cb = 0; cb < 4; ++cb)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = ra + 8 * (c >> 1), col = cb * 8 + 2 * t + (c & 1);
        const int cc = col & 15;
        if (i < n && cc < (col >= 16 ? kw : kh))
          drel_b[(size_t)i * rl + (col >= 16 ? kh : 0) + cc] = dr[cb][c];
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = ra + 8 * hf;
      if (i >= n) continue;
      float* row = dbase + (size_t)i * C3 + 2 * t;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(row + j * 8) =
            make_float2(acc[j][2 * hf] * scale, acc[j][2 * hf + 1] * scale);
    }
  }
  __syncthreads();  // every row's statistics; k and v are done

  // ---- pass 2: a warp's 16 keys --------------------------------------------
  stage_rows<HD>(T0, base, C3, nk, n, tid, kThreads);
  stage_rows<HD>(T1, gbase, C, nk, n, tid, kThreads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int kt = warp; kt < NT; kt += kWarps) {
    const int m0 = kt * 16;
    __syncwarp();
    stage_rows<HD>(Ww, base + (size_t)m0 * C3 + C, C3, 16, n - m0, lane, 32);
    cp_async_commit();
    // v of the warp's keys as A fragments, from device memory
    float va[HD / 8][4];
#pragma unroll
    for (int kd = 0; kd < HD / 8; ++kd)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int row = m0 + g + 8 * (u & 1);
        va[kd][u] = row < n ? base[(size_t)row * C3 + 2 * C + 8 * kd + t +
                                   4 * (u >> 1)]
                            : 0.f;
      }
    float dv[HD / 8][4], dk[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) dv[j][c] = dk[j][c] = 0.f;
    int kr[2], kc[2];
    bool kok[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = m0 + g + 8 * hf;
      kok[hf] = key < n;
      kr[hf] = div_small(key, inv_kw);
      kc[hf] = kh + key - kr[hf] * kw;
    }
    cp_async_wait<0>();
    __syncwarp();  // the warp's k rows in Ww
#pragma unroll 1
    for (int qt = 0; qt < NT; ++qt) {
      const int i0 = qt * 16;
      float sT[2][4], dpT[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int c = 0; c < 4; ++c) sT[jj][c] = dpT[jj][c] = 0.f;
#pragma unroll
      for (int kd = 0; kd < HD / 8; ++kd) {
        float a[4];
        frag_a(Ww, kLd, g, g + 8, 8 * kd, t, a);
        uint32_t kh_[4], kl_[4], vh[4], vl[4];
        split_n(a, kh_, kl_);
        split_n(va[kd], vh, vl);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t bh[2], bl[2];
          frag_b_rows(T0, kLd, i0 + 8 * jj, 8 * kd, g, t, bh, bl);
          mma_3xtf32(sT[jj], kh_, kl_, bh, bl);
          frag_b_rows(T1, kLd, i0 + 8 * jj, 8 * kd, g, t, bh, bl);
          mma_3xtf32(dpT[jj], vh, vl, bh, bl);
        }
      }
      // element (key m0 + g + 8 hf, query i0 + 8 jj + 2 t + e)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        float p4[4], d4[4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = i0 + 8 * jj + 2 * t + e, c = 2 * hf + e;
            float p = 0.f, ds = 0.f;
            if (kok[hf] && i < n) {
              const float* rb = RB + i * rl;
              const float x = sT[jj][c] * scale + (rb[kr[hf]] + rb[kc[hf]]);
              p = expf(x - Ms[i]) * Li[i];
              ds = p * (dpT[jj][c] - Dd[i]);
            }
            p4[c] = p;
            d4[c] = ds;
          }
        uint32_t ph[4], pl[4], dh[4], dl[4];
        acc_to_a(p4, ph, pl);
        acc_to_a(d4, dh, dl);
#pragma unroll
        for (int nb = 0; nb < HD / 8; ++nb) {
          uint32_t bh[2], bl[2];
          frag_b_pi(T1, kLd, i0 + 8 * jj, 8 * nb, g, t, bh, bl);
          mma_3xtf32(dv[nb], ph, pl, bh, bl);
          frag_b_pi(T0, kLd, i0 + 8 * jj, 8 * nb, g, t, bh, bl);
          mma_3xtf32(dk[nb], dh, dl, bh, bl);
        }
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (!kok[hf]) continue;
      float* row = dbase + (size_t)(m0 + g + 8 * hf) * C3 + 2 * t;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<float2*>(row + C + 8 * j) =
            make_float2(dk[j][2 * hf] * scale, dk[j][2 * hf + 1] * scale);
        *reinterpret_cast<float2*>(row + 2 * C + 8 * j) =
            make_float2(dv[j][2 * hf], dv[j][2 * hf + 1]);
      }
    }
  }

  // ---- pass 3: this (window, head)'s share of the table gradients --------
  // (q is still in T0), summed over every share in a fixed order after
  __syncthreads();  // every row's drel
  tables_tf32<HD>(drel_b, T0,
                  part + ((size_t)win * nh + h) * (kh * kh + kw * kw) * HD,
                  kh, kw, rl, warp, lane);

  // ---- pass 4: dq += drel_h Rh[row(i)], then + drel_w Rw[col(i)] ----------
  // window rows first, then window columns, so that each dq sums in the
  // plain version's order
  dq_rel_tf32<HD>(false, drel_b, rh, rw, dbase, C3, kh, kw, rl, warp, lane);
  __syncthreads();
  dq_rel_tf32<HD>(true, drel_b, rh, rw, dbase, C3, kh, kw, rl, warp, lane);
}

// the instance whose NT is tf32_nt(n)
template <int HD, int I = 0>
int launch_tf32(const float* qkv, const float* rh, const float* rw,
                const float* dout, float* dqkv, float* drel, float* part,
                int Bw, int n, int C, int nh, int kh, int kw, float scale,
                cudaStream_t st) {
  constexpr int NT = kTf32Nts[I];
  if constexpr (I + 1 < kTf32NtCount) {
    if (tf32_nt(n) != NT)
      return launch_tf32<HD, I + 1>(qkv, rh, rw, dout, dqkv, drel, part, Bw,
                                    n, C, nh, kh, kw, scale, st);
  }
  const size_t smem = BwdTf32<HD>(n, kh, kw).bytes();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_tf32<HD, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  bwd_tf32<HD, NT><<<dim3(nh, Bw), kThreads, smem, st>>>(
      qkv, rh, rw, dout, dqkv, drel, part, n, C, nh, kh, kw, scale);
  return (int)cudaGetLastError();
}

// ---- table gradients -------------------------------------------------------
// Both types: out[e] = the sum of the P partials part[p, e] (one per
// (window, head)) in a fixed order: 8 threads an entry each sum a strided
// eighth (p = ty, ty + 8, ...), then the eight sums are added in order. drh
// and drw are the two halves of out.
__global__ void __launch_bounds__(256)
    tables_sum(const float* __restrict__ part, float* __restrict__ drh,
               float* __restrict__ drw, int P, int eh, int E) {
  __shared__ float red[8][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + tx;
  float acc = 0.f;
  if (e < E) {
#pragma unroll 8
    for (int p = ty; p < P; p += 8) acc += part[(size_t)p * E + e];
  }
  red[ty][tx] = acc;
  __syncthreads();
  if (ty != 0 || e >= E) return;
  for (int k = 1; k < 8; ++k) acc += red[k][tx];
  if (e < eh)
    drh[e] = acc;
  else
    drw[e - eh] = acc;
}

template <int HD>
int launch_f32(const float* qkv, const float* rh, const float* rw,
               const float* dout, float* dqkv, float* drel, float* part,
               int Bw, int n, int C, int nh, int kh, int kw, float scale,
               cudaStream_t st) {
  if (BwdTf32<HD>(n, kh, kw).bytes() > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  return launch_tf32<HD>(qkv, rh, rw, dout, dqkv, drel, part, Bw, n, C, nh,
                         kh, kw, scale, st);
}

// bwd_tf32 with its table partials; P = Bw * nh of them
int core(const float* qkv, const float* rh, const float* rw, const float* dout,
         float* dqkv, float* drel, float* part, float*, int Bw, int n, int C,
         int nh, int hd, int kh, int kw, float scale, cudaStream_t st) {
  if (kh > 16 || kw > 16) return (int)cudaErrorInvalidValue;
  if (hd == 64)
    return launch_f32<64>(qkv, rh, rw, dout, dqkv, drel, part, Bw, n, C, nh,
                          kh, kw, scale, st);
  if (hd == 80)
    return launch_f32<80>(qkv, rh, rw, dout, dqkv, drel, part, Bw, n, C, nh,
                          kh, kw, scale, st);
  return (int)cudaErrorInvalidValue;
}

// bwd_mma with its table partials; P = Bw * nh of them
int core(const __nv_bfloat16* qkv, const __nv_bfloat16* rh,
         const __nv_bfloat16* rw, const __nv_bfloat16* dout,
         __nv_bfloat16* dqkv, float* drel, float* part, float* dqf, int Bw,
         int n, int C, int nh, int hd, int kh, int kw, float scale,
         cudaStream_t st) {
  const int nt = pad16(n) / 16;
  if (kh > 16 || kw > 16) return (int)cudaErrorInvalidValue;
  if (hd == 64 && BwdMma<64>(n, kh, kw).bytes() <= kSmemLimit)
    return launch_mma<64>(nt, qkv, rh, rw, dout, dqkv, drel, part, dqf, Bw, n,
                          C, nh, kh, kw, scale, st);
  if (hd == 80 && BwdMma<80>(n, kh, kw).bytes() <= kSmemLimit)
    return launch_mma<80>(nt, qkv, rh, rw, dout, dqkv, drel, part, dqf, Bw, n,
                          C, nh, kh, kw, scale, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int backward(const void* qkv, const void* rh, const void* rw, const void* dout,
             void* dqkv, float* drh, float* drw, float* drel, float* part,
             float* dqf, int Bw, int n, int C, int nh, int hd, int kh, int kw,
             cudaStream_t st) {
  int e = core(static_cast<const T*>(qkv), static_cast<const T*>(rh),
               static_cast<const T*>(rw), static_cast<const T*>(dout),
               static_cast<T*>(dqkv), drel, part, dqf, Bw, n, C, nh, hd, kh,
               kw, 1.0f / sqrtf((float)hd), st);
  if (e) return e;
  const int eh = kh * kh * hd, E = eh + kw * kw * hd;
  tables_sum<<<(E + 31) / 32, 256, 0, st>>>(part, drh, drw, Bw * nh, eh, E);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ullsam

// Plain C entry point (loaded with ctypes). Returns 0 or a cudaError_t.
// dtype: 0 = float32, 1 = bfloat16 (hd 64 or 80) for qkv [Bw*n, 3C],
// rh [kh, kh, hd], rw [kw, kw, hd], dout [Bw*n, C] and dqkv [Bw*n, 3C];
// drh, drw, and the scratch drel [Bw, nh, n, kh + kw] and part [Bw * nh,
// (kh*kh + kw*kw) * hd] are float32, as is
// the scratch dqf [Bw*n, C] that bfloat16 needs (float32: null). Shared
// memory as bwd_smem_bytes.
extern "C" int window_attn_bwd(int dtype, const void* qkv, const void* rh,
                               const void* rw, const void* dout, void* dqkv,
                               void* drh, void* drw, void* drel, void* part,
                               void* dqf, int Bw, int n, int C, int nh,
                               int hd, int kh, int kw, void* stream) {
  using namespace ullsam;
  if (n > kMaxKeys || kh * kw != n || nh * hd != C || kh + kw > 64 ||
      (dtype == kBF16 && dqf == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* f_drh = static_cast<float*>(drh);
  float* f_drw = static_cast<float*>(drw);
  float* f_drel = static_cast<float*>(drel);
  float* f_part = static_cast<float*>(part);
  float* f_dqf = static_cast<float*>(dqf);
  if (dtype == kF32)
    return backward<float>(qkv, rh, rw, dout, dqkv, f_drh, f_drw, f_drel,
                           f_part, f_dqf, Bw, n, C, nh, hd, kh, kw, st);
  if (dtype == kBF16)
    return backward<__nv_bfloat16>(qkv, rh, rw, dout, dqkv, f_drh, f_drw,
                                   f_drel, f_part, f_dqf, Bw, n, C, nh, hd, kh,
                                   kw, st);
  return (int)cudaErrorInvalidValue;
}
