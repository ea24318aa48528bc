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
// float32 (head dims 64 and 80): true f32 FMA on the CUDA cores, one block
// per (head, window), 256 threads; thread j owns key j (its column of 16
// logits, p, dp and ds in registers), row statistics pass through shared
// memory. k and v sit d-major in shared memory ([HD][n | 1], odd stride) and
// dv is accumulated there in f32 over 16-row query tiles. At head dim 64 dk
// is too (176,384 bytes at 14x14 windows). At ViT-H's 80 the four d-major
// tiles would take 4 x 80 x 197 x 4 = 252,160 bytes, over the 232,448 a
// block has, so dk is accumulated in thread j's registers (80 of them,
// key j's row of dk being its alone) and the block needs 216,256. Two
// blocks per (window, head), each owning half of dk's and dv's columns,
// would fit as well but recompute s, dp and the softmax in both; holding dv
// in registers too would take 2 x 80 accumulators beside the 48 of a
// tile's column and spill. (dk in registers at 64 as well ran 10% slower
// than in shared memory: the loop over d, unrolled 80 or 64 times, costs
// more than the shared-memory adds it saves.) Each sum keeps its order, so
// the result is bitwise the same in either layout and on every call.
//
// Table gradients, deterministic in both types: bf16 forms each (window,
// head)'s share in a third pass of its block on the tensor cores (drel^T q
// per window row and column); f32 sums each window's share from the `drel`
// scratch in a second kernel. A last kernel adds the shares in a fixed
// order. (A first version's per-window sum kernel, latency-bound, cost
// about a third of the call.)
#include "common.cuh"

namespace ullsam {
namespace {

constexpr int kMaxKeys = 256;
constexpr int kTQ = 16;      // query rows per tile
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

// ---- float32, CUDA cores (head dims 64 and 80) ----------------------------

__host__ __device__ inline int f32_ld(int n) { return n | 1; }

// must match ops/kernels/window_attention.py bwd_smem_bytes: k, v, dv and,
// at head dim 64, dk d-major [hd][n | 1]; q and do tiles [16][hd]; ds
// [16][n | 1]; the rows' rel-pos terms and their drel [16][kh + kw]; max,
// sum, dd; the reduction
size_t f32_smem_bytes(int n, int rl, int hd) {
  const size_t ld = f32_ld(n);
  return (hd > 64 ? 3 : 4) * hd * ld * sizeof(float) +
         2 * kTQ * hd * sizeof(float) +
         kTQ * ld * sizeof(float) + 2 * kTQ * rl * sizeof(float) +
         3 * kTQ * sizeof(float) + kWarps * kTQ * sizeof(float);
}

// per-row reduction of v[16] over the block's threads (max or sum);
// out[16] in shared memory; every thread must call it
template <bool kMax>
__device__ __forceinline__ void block_rows(const float (&v)[kTQ], float* red,
                                           float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kTQ; ++r) {
    float x = v[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x, o);
      x = kMax ? fmaxf(x, y) : x + y;
    }
    if (lane == 0) red[warp * kTQ + r] = x;
  }
  __syncthreads();
  if (threadIdx.x < kTQ) {
    float x = red[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) {
      const float y = red[w * kTQ + threadIdx.x];
      x = kMax ? fmaxf(x, y) : x + y;
    }
    out[threadIdx.x] = x;
  }
  __syncthreads();
}

// grid (nh, Bw), 256 threads; the layout of the bf16 kernel's arguments
template <int kHD>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_f32(const float* __restrict__ qkv, const float* __restrict__ rh,
            const float* __restrict__ rw, const float* __restrict__ dout,
            float* __restrict__ dqkv, float* __restrict__ drel, int n, int C,
            int nh, int kh, int kw, float scale) {
  constexpr int kCols = kHD / 16;  // dq channels a thread
  constexpr bool kDkRegs = kHD > 64;  // dk in registers, else d-major smem
  const int ld = f32_ld(n), rl = kh + kw;
  extern __shared__ __align__(16) float sm[];
  float* Kt = sm;                   // [HD][ld]
  float* Vt = Kt + kHD * ld;        // [HD][ld]
  float* dVt = Vt + kHD * ld;       // [HD][ld]
  float* dKt = dVt + kHD * ld;      // [HD][ld] at head dim 64
  float* Qs = dKt + (kDkRegs ? 0 : kHD * ld);  // [16][HD]
  float* Gs = Qs + kTQ * kHD;       // [16][HD]
  float* DS = Gs + kTQ * kHD;       // [16][ld]
  float* RB = DS + kTQ * ld;        // [16][rl]
  float* DR = RB + kTQ * rl;        // [16][rl]
  float* Mx = DR + kTQ * rl;        // [16]
  float* Sm = Mx + kTQ;             // [16]
  float* Dd = Sm + kTQ;             // [16]
  float* red = Dd + kTQ;            // [8][16]

  const int tid = threadIdx.x;
  const int h = blockIdx.x, win = blockIdx.y;
  const size_t C3 = 3 * (size_t)C;
  const float* base = qkv + (size_t)win * n * C3 + h * kHD;
  const float* gbase = dout + (size_t)win * n * C + h * kHD;
  float* dbase = dqkv + (size_t)win * n * C3 + h * kHD;

  for (int e = tid; e < n * kHD; e += kThreads) {
    const int j = e / kHD, d = e % kHD;
    Kt[d * ld + j] = base[(size_t)j * C3 + C + d];
    Vt[d * ld + j] = base[(size_t)j * C3 + 2 * C + d];
    dVt[d * ld + j] = 0.f;
    if constexpr (!kDkRegs) dKt[d * ld + j] = 0.f;
  }

  const int j = tid;             // this thread's key column
  const bool col = j < n;
  const int kr = col ? j / kw : 0, kc = col ? j - (j / kw) * kw : 0;
  float adk[kDkRegs ? kHD : 1];  // key j's row of dk
#pragma unroll
  for (int d = 0; d < (kDkRegs ? kHD : 1); ++d) adk[d] = 0.f;

  for (int i0 = 0; i0 < n; i0 += kTQ) {
    const int rows = min(kTQ, n - i0);
    __syncthreads();  // previous tile's Qs / Gs / DS / RB / DR are free
    for (int e = tid; e < kTQ * kHD; e += kThreads) {
      const int r = e / kHD, d = e % kHD;
      const bool ok = r < rows;
      Qs[e] = ok ? base[(size_t)(i0 + r) * C3 + d] : 0.f;
      Gs[e] = ok ? gbase[(size_t)(i0 + r) * C + d] : 0.f;
    }
    __syncthreads();
    // rel-pos terms of the tile's rows: one 64-long dot per (row, entry)
    for (int e = tid; e < kTQ * rl; e += kThreads) {
      const int r = e / rl, idx = e % rl;
      float a = 0.f;
      if (r < rows) {
        const int i = i0 + r, y = i / kw, x = i - y * kw;
        const float* tab = idx < kh ? rh + ((size_t)y * kh + idx) * kHD
                                    : rw + ((size_t)x * kw + idx - kh) * kHD;
        const float* q = Qs + r * kHD;
#pragma unroll 8
        for (int d = 0; d < kHD; ++d) a = fmaf(q[d], tab[d], a);
      }
      RB[e] = a;
    }
    __syncthreads();

    // column j: logits, softmax, dp, ds (registers)
    float s[kTQ], dp[kTQ];
#pragma unroll
    for (int r = 0; r < kTQ; ++r) s[r] = dp[r] = 0.f;
    if (col) {
#pragma unroll 4
      for (int d = 0; d < kHD; ++d) {
        const float kv = Kt[d * ld + j], vv = Vt[d * ld + j];
#pragma unroll
        for (int r = 0; r < kTQ; ++r) {
          s[r] = fmaf(Qs[r * kHD + d], kv, s[r]);
          dp[r] = fmaf(Gs[r * kHD + d], vv, dp[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kTQ; ++r)
        s[r] = s[r] * scale + RB[r * rl + kr] + RB[r * rl + kh + kc];
    } else {
#pragma unroll
      for (int r = 0; r < kTQ; ++r) s[r] = -INFINITY;
    }
    block_rows<true>(s, red, Mx);
#pragma unroll
    for (int r = 0; r < kTQ; ++r) s[r] = col ? expf(s[r] - Mx[r]) : 0.f;
    block_rows<false>(s, red, Sm);
    float pdp[kTQ];
#pragma unroll
    for (int r = 0; r < kTQ; ++r) {
      s[r] /= Sm[r];  // p, f32
      pdp[r] = s[r] * dp[r];
    }
    block_rows<false>(pdp, red, Dd);
    if (col) {
      float ds[kTQ];
#pragma unroll
      for (int r = 0; r < kTQ; ++r) {
        ds[r] = s[r] * (dp[r] - Dd[r]);
        DS[r * ld + j] = ds[r];
      }
      // channel d of key j: the tile's share of dv added, of dk returned
      const auto dkv = [&](int d) {
        float av = 0.f, ak = 0.f;
#pragma unroll
        for (int r = 0; r < kTQ; ++r) {
          av = fmaf(s[r], Gs[r * kHD + d], av);
          ak = fmaf(ds[r], Qs[r * kHD + d], ak);
        }
        dVt[d * ld + j] += av;
        return ak;
      };
      if constexpr (kDkRegs) {
#pragma unroll
        for (int d = 0; d < kHD; ++d) adk[d] += dkv(d);
      } else {
        for (int d = 0; d < kHD; ++d) dKt[d * ld + j] += dkv(d);
      }
    }
    __syncthreads();  // DS complete

    // the two bias sums of each row's ds
    for (int e = tid; e < kTQ * rl; e += kThreads) {
      const int r = e / rl, idx = e % rl;
      const float* dsr = DS + r * ld;
      float a = 0.f;
      if (idx < kh) {
        for (int c = 0; c < kw; ++c) a += dsr[idx * kw + c];
      } else {
        for (int y = 0; y < kh; ++y) a += dsr[y * kw + idx - kh];
      }
      DR[e] = a;
      if (r < rows)
        drel[(((size_t)win * nh + h) * n + i0 + r) * rl + idx] = a;
    }
    __syncthreads();

    // dq of the tile: thread (row r, kCols channels from d0)
    {
      const int r = tid >> 4, d0 = (tid & 15) * kCols;
      float acc[kCols];
#pragma unroll
      for (int u = 0; u < kCols; ++u) acc[u] = 0.f;
      const float* dsr = DS + r * ld;
      for (int m = 0; m < n; ++m) {
        const float w = dsr[m];
#pragma unroll
        for (int u = 0; u < kCols; ++u)
          acc[u] = fmaf(w, Kt[(d0 + u) * ld + m], acc[u]);
      }
      if (r < rows) {
        const int i = i0 + r, y = i / kw, x = i - y * kw;
        float rel[kCols];
#pragma unroll
        for (int u = 0; u < kCols; ++u) rel[u] = 0.f;
        for (int idx = 0; idx < rl; ++idx) {
          const float w = DR[r * rl + idx];
          const float* tab = idx < kh ? rh + ((size_t)y * kh + idx) * kHD
                                      : rw + ((size_t)x * kw + idx - kh) * kHD;
#pragma unroll
          for (int u = 0; u < kCols; ++u)
            rel[u] = fmaf(w, tab[d0 + u], rel[u]);
        }
        float* dq = dbase + (size_t)i * C3 + d0;
#pragma unroll
        for (int u = 0; u < kCols; ++u) dq[u] = acc[u] * scale + rel[u];
      }
    }
  }
  if constexpr (kDkRegs) {
    if (col) {
      float* dk = dbase + (size_t)j * C3 + C;
#pragma unroll
      for (int d = 0; d < kHD; ++d) dk[d] = adk[d] * scale;
    }
  }
  __syncthreads();
  for (int e = tid; e < n * kHD; e += kThreads) {
    const int jj = e / kHD, d = e % kHD;
    if constexpr (!kDkRegs)
      dbase[(size_t)jj * C3 + C + d] = dKt[d * ld + jj] * scale;
    dbase[(size_t)jj * C3 + 2 * C + d] = dVt[d * ld + jj];
  }
}

// ---- table gradients -------------------------------------------------------
// float32, after bwd_f32: grid (ceil(E / 256), Bw) with E = (kh*kh + kw*kw)
// * hd entries. Entry e < kh*kh*hd is dRh[y, r, d] (e = (y*kh + r)*hd + d),
// the rest dRw[x, c, d]; each thread sums its entry over one window's heads
// and rows (columns) into part[win, e].
template <int hd>
__global__ void __launch_bounds__(256)
    tables_part_f32(const float* __restrict__ qkv,
                    const float* __restrict__ drel, float* __restrict__ part,
                    int n, int C, int nh, int kh, int kw) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  const int eh = kh * kh * hd, E = eh + kw * kw * hd;
  if (e >= E) return;
  const int win = blockIdx.y, rl = kh + kw;
  const size_t C3 = 3 * (size_t)C;
  const int d = e % hd;
  const bool is_h = e < eh;
  const int t = (is_h ? e : e - eh) / hd;
  const int k = is_h ? kh : kw;
  const int a = t / k, b = t % k;  // (y, r) or (x, c)
  float acc = 0.f;
  for (int h = 0; h < nh; ++h) {
    const float* dr = drel + ((size_t)win * nh + h) * n * rl;
    const float* q = qkv + (size_t)win * n * C3 + h * hd + d;
    const int cnt = is_h ? kw : kh;
    for (int o = 0; o < cnt; ++o) {
      const int i = is_h ? a * kw + o : o * kw + a;
      acc = fmaf(dr[(size_t)i * rl + (is_h ? b : kh + b)], q[(size_t)i * C3],
                 acc);
    }
  }
  part[(size_t)win * E + e] = acc;
}

// Both types: out[e] = the sum of the P partials part[p, e] (bf16: one per
// (window, head); f32: one per window) in a fixed order: 8 threads an entry
// each sum a strided eighth (p = ty, ty + 8, ...), then the eight sums are
// added in order. drh and drw are the two halves of out.
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
  const size_t smem = f32_smem_bytes(n, kh + kw, HD);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bwd_f32<HD><<<dim3(nh, Bw), kThreads, smem, st>>>(
      qkv, rh, rw, dout, dqkv, drel, n, C, nh, kh, kw, scale);
  const int e = (int)cudaGetLastError();
  if (e) return e;
  const int E = (kh * kh + kw * kw) * HD;
  tables_part_f32<HD><<<dim3((E + 255) / 256, Bw), 256, 0, st>>>(
      qkv, drel, part, n, C, nh, kh, kw);
  return (int)cudaGetLastError();
}

// bwd_f32, then the per-window table partials; P = Bw of them
int core(const float* qkv, const float* rh, const float* rw, const float* dout,
         float* dqkv, float* drel, float* part, float*, int Bw, int n, int C,
         int nh, int hd, int kh, int kw, float scale, cudaStream_t st) {
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
  const int P = sizeof(T) == 4 ? Bw : Bw * nh;
  tables_sum<<<(E + 31) / 32, 256, 0, st>>>(part, drh, drw, P, eh, E);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ullsam

// Plain C entry point (loaded with ctypes). Returns 0 or a cudaError_t.
// dtype: 0 = float32, 1 = bfloat16 (hd 64 or 80) for qkv [Bw*n, 3C],
// rh [kh, kh, hd], rw [kw, kw, hd], dout [Bw*n, C] and dqkv [Bw*n, 3C];
// drh, drw, and the scratch drel [Bw, nh, n, kh + kw] and part [P, (kh*kh +
// kw*kw) * hd] (P = Bw * nh for bfloat16, Bw for float32) are float32, as is
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
