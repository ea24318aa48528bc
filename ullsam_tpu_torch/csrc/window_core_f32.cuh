// The one float32 windowed attention core of the port, for Hopper (sm_90a):
// B1's core (window_attn.cu `forward`), B3 (`window_attn_core_forward`) and
// B15 (window_attn_twophase.cu `window_attn_twophase_forward`) all launch
// `window_core_f32` below in float32, as window_core.cuh's bf16 core in
// bf16, so the three give bitwise-equal results.
//
// It computes window_core.cuh's function in f32: for each window of n =
// kh*kw tokens and each head of HD channels
//     o = softmax(q k^T * hd^-1/2 + bias) v
//     bias[i, m] = q_i . Rh[row(i), row(m)] + q_i . Rw[col(i), col(m)]
// (the rel-pos terms from the unscaled q), a row's whole f32 logits, its
// exact max and sum, p normalized, p.v summed in f32 (ops/kernels/
// window_attention.py window_attn_core_plain).
//
// What bounds it on this card: operations, then latency. At ViT-H (25
// windows x 16 heads of 80, n = 196) a call is 4.9 GFLOP of products, 30
// us at the split-TF32 rate (495 / 3 TFLOP/s), against qkv and o (100 MB
// in f32, 30 us at the memory rate). The earlier core ran every product by
// FMA on the CUDA cores (window_attn_core_f32, 64-query blocks with an
// online softmax) and took 0.4924 ms there (H100 80GB HBM3, 700 W).
//
// Design: the bf16 core's (window_core.cuh) on the tensor cores in split
// TF32 (tf32.cuh): every product, the rel-pos terms included, is mma.sync
// m16n8k8 on TF32 values, issued three times (a_hi b_lo, a_lo b_hi, a_hi
// b_hi) into a partial from zero that the CUDA cores add (mma_3xtf32), so
// no tensor-core accumulation runs a long chain.
//   * Persistent blocks, one an SM (grid = min(units, SMs)), each walking a
//     contiguous range of units; a unit is a (head, window, query half), 7
//     or 6 warps of 16 query rows at n = 196.
//   * k and v sit in shared memory split once into hi and lo planes, so no
//     fragment is split twice (splitting every k and v fragment in
//     registers cost B8's f32 body about 2x); at head dim 80 k's two planes
//     take 150 KB, so k and then v pass through one region: a unit loads
//     and splits k, its warps hold their rows' whole logits in registers
//     (the exact row max and sum, p normalized), then v replaces k. A
//     thread loads 4 of its 16-byte pieces at a time into registers and
//     splits them (measured on an H100 at ViT-H, hd 80: 0.30 ms; 8 at a
//     time 0.37, cp.async of every piece and a split in place 0.40-0.42,
//     v's share held in registers across the logits 0.55-0.60, spilling).
//   * Keys sit in slots of 16 a window row (kw <= 16), as the bf16 core's:
//     a logit's window row is known at compile time and its column is one
//     of four a thread, so its bias is two registers and an add. NT, the
//     slot rows an instance holds, is 2, 4, 8, 14 or 16 (a window of kh
//     rows runs the first NT >= kh; the rows past kh are empty slots), so
//     10 instances, not 32, are compiled.
//   * f32 rows of HD + 4 floats (4 mod 8): every fragment read is free of
//     bank conflicts. q is read from its f32 tile and split per fragment
//     (ten a row tile); p is split from the logits' registers, its keys in
//     tf32_pi order (an A operand taken from an m16n8 accumulator), and v's
//     B fragments read in that order.
//   * The rel-pos terms: each window row's kw rows against Rh[y] and each
//     window column's kh rows against Rw[x] are one [16 x HD] . [HD x 16]
//     product, a warp a group (window_rel_terms_tf32).
#pragma once

#include "tf32.cuh"
#include "window_core.cuh"

namespace ullsam {
namespace {

// launches of the f32 core made by this library (each .so has its own;
// window_core_f32_launch_count reads it for the Python wrappers)
long long window_core_f32_launches = 0;

// the instances' slot rows; a window of kh rows runs the first NT >= kh
constexpr int kCoreF32Nts[] = {2, 4, 8, 14, 16};

// must match ops/kernels/window_attention.py core_f32_smem_bytes
template <int HD>
struct WinCoreF32Layout {
  static constexpr int kLd = HD + 4;  // f32 a row: 16-byte rows, 4 mod 8
  // nk key slots (16 a slot row), nq 16-row query tiles, half of them a
  // unit, nz units a (head, window)
  int nk, nq, half, nz, rl;
  __host__ __device__ WinCoreF32Layout(int n, int kh, int kw, int nt)
      : nk(16 * nt), nq(core_pad16(n) / 16), half((nq + 1) / 2),
        nz((nq + half - 1) / half), rl(kh + kw) {}
  // k, then v: hi and lo planes [nk][kLd]; the unit's q [half * 16][kLd];
  // its rel-pos terms [half * 16][rl]; all f32
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * (2 * (size_t)nk * kLd + (size_t)half * 16 * kLd +
                            (size_t)half * 16 * rl);
  }
};

// The rel-pos terms of the unit's rows [q0, q1) in split TF32 on the tensor
// cores: RB[r - q0][i] = q_r . Rh[row(r)][i] (i < kh), q_r . Rw[col(r)][i -
// kh], rows past n zero. The rows of window row y (y kw .. y kw + kw - 1) all
// use Rh[y], the rows of window column x (x, x + kw, ...) all use Rw[x]:
// each group is one product [16 rows x HD] . [HD x 16] (A rows from the q
// tile Qs, rows relative to q0; B from the table in device memory), a warp
// a group. Groups with no row in [q0, q1) are skipped. Every warp of the
// block (8) calls it; the caller synchronises after.
template <int HD>
__device__ void window_rel_terms_tf32(const float* Qs, int q0, int q1,
                                      const float* rh, const float* rw, int n,
                                      int kh, int kw, float* RB, int rl,
                                      int warp, int lane) {
  constexpr int kLd = WinCoreF32Layout<HD>::kLd;
  const int g = lane >> 2, t = lane & 3;
  for (int e = warp * 32 + lane; e < (q1 - max(q0, n)) * rl; e += 256)
    RB[(max(q0, n) - q0 + e / rl) * rl + e % rl] = 0.f;
  for (int it = warp; it < kh + kw; it += 8) {
    const bool isw = it >= kh;
    const int grp = isw ? it - kh : it;  // y or x
    if (!isw && (grp * kw >= q1 || grp * kw + kw <= q0)) continue;
    const int len = isw ? kh : kw, ncol = isw ? kw : kh;
    const int step = isw ? kw : 1, first = isw ? grp : grp * kw;
    const float* tab = isw ? rw + (size_t)grp * kw * HD
                           : rh + (size_t)grp * kh * HD;
    // this thread's A rows g and g + 8 of the group, as rows of Qs (row 0
    // where the group has no such row in the unit: its products are
    // dropped)
    const auto local = [&](int j) {
      const int row = first + j * step;
      return j < len && row >= q0 && row < q1 ? row - q0 : 0;
    };
    const int la = local(g), la8 = local(g + 8);
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 2
    for (int kd = 0; kd < HD / 8; ++kd) {
      const float a[4] = {Qs[la * kLd + 8 * kd + t], Qs[la8 * kLd + 8 * kd + t],
                          Qs[la * kLd + 8 * kd + t + 4],
                          Qs[la8 * kLd + 8 * kd + t + 4]};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) tf32_split(a[u], ah[u], al[u]);
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
        const int row = first + jr * step;
        if (jr < len && col < ncol && row >= q0 && row < q1 && row < n)
          RB[(row - q0) * rl + (isw ? kh : 0) + col] = acc[c2][c];
      }
  }
}

// grid min(units, SMs), 256 threads, one block an SM; slot 16 kr + kc of
// the planes holds the key of window row kr, column kc (kr < kh, kc < kw;
// every other slot of the NT rows is zero and masked), so a thread's slots
// j * 8 + 2 t + e sit in window row j / 2 (known at compile time) and in
// one of four columns (2 t + e, 8 + 2 t + e).
template <int HD, int NT>
__global__ void __launch_bounds__(256, 1)
    window_core_f32(const float* __restrict__ qkv,
                    const float* __restrict__ rh,
                    const float* __restrict__ rw, float* __restrict__ out,
                    int n, int C, int nh, int kh, int kw, int units,
                    float scale) {
  using Lay = WinCoreF32Layout<HD>;
  constexpr int kLd = Lay::kLd, kNk = 16 * NT, kCh = HD / 4;
  const Lay L(n, kh, kw, NT);
  extern __shared__ __align__(16) float smf[];
  float* Ph = smf;                      // k, then v, hi  [kNk][kLd]
  float* Pl = Ph + kNk * kLd;           // lo             [kNk][kLd]
  float* Qs = Pl + kNk * kLd;           // q              [half * 16][kLd]
  float* RB = Qs + L.half * 16 * kLd;   // rel-pos terms  [half * 16][rl]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t C3 = 3 * (size_t)C;
  const int u0 = (int)((long long)blockIdx.x * units / gridDim.x);
  const int u1 = (int)((long long)(blockIdx.x + 1) * units / gridDim.x);

  // k (src = the head's k columns) or v into the hi and lo planes (slot 16
  // kr + kc; the empty slots zero): 4 of a thread's 16-byte pieces in
  // flight at a time, each split as it lands
  const auto load_split = [&](const float* src) {
    constexpr int kTotal = kNk * kCh;
    for (int c0 = tid; c0 < kTotal; c0 += 4 * 256) {
      float4 x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = c0 + i * 256, row = c / kCh, ch = c - row * kCh;
        const int kr = row >> 4, kc = row & 15;
        x[i] = c < kTotal && kr < kh && kc < kw
                   ? __ldg(reinterpret_cast<const float4*>(
                         src + (size_t)(kr * kw + kc) * C3 + ch * 4))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = c0 + i * 256, row = c / kCh, ch = c - row * kCh;
        if (c >= kTotal) continue;
        uint32_t h[4], l[4];
        tf32_split(x[i].x, h[0], l[0]);
        tf32_split(x[i].y, h[1], l[1]);
        tf32_split(x[i].z, h[2], l[2]);
        tf32_split(x[i].w, h[3], l[3]);
        *reinterpret_cast<uint4*>(Ph + row * kLd + ch * 4) =
            make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(Pl + row * kLd + ch * 4) =
            make_uint4(l[0], l[1], l[2], l[3]);
      }
    }
  };

  for (int u = u0; u < u1; ++u) {
    const int item = u / L.nz, qt0 = (u % L.nz) * L.half;
    const int qt1 = min(L.nq, qt0 + L.half), r0 = qt0 * 16;
    const float* src = qkv + (size_t)(item / nh) * n * C3 + (item % nh) * HD;
    __syncthreads();  // the last unit is done with every buffer
    // q's rows r0 .. r0 + 16 half - 1 (zero past n) and k's planes
    for (int c = tid; c < L.half * 16 * kCh; c += 256) {
      const int row = c / kCh, ch = c - row * kCh;
      const bool ok = r0 + row < n;
      cp_async16(smem_u32(Qs + row * kLd + ch * 4),
                 src + (size_t)(ok ? r0 + row : 0) * C3 + ch * 4, ok);
    }
    cp_async_commit();
    load_split(src + C);
    cp_async_wait<0>();
    __syncthreads();
    window_rel_terms_tf32<HD>(Qs, r0, r0 + L.half * 16, rh, rw, n, kh, kw,
                              RB, L.rl, warp, lane);
    __syncthreads();

    const int qt = qt0 + warp;
    const bool mine = qt < qt1;
    const int lr = warp * 16;  // this warp's first row in Qs and RB
    // phase 1: the 16 rows' logits against every key slot, in registers
    float s[2 * NT][4];
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
    if (mine) {
#pragma unroll 2
      for (int kd = 0; kd < HD / 8; ++kd) {
        const float* qa = Qs + (lr + g) * kLd + 8 * kd + t;
        const float a[4] = {qa[0], qa[8 * kLd], qa[4], qa[8 * kLd + 4]};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int u2 = 0; u2 < 4; ++u2) tf32_split(a[u2], ah[u2], al[u2]);
#pragma unroll
        for (int nj = 0; nj < 2 * NT; ++nj) {
          if ((nj >> 1) >= kh) continue;  // an empty slot row
          const int o = (8 * nj + g) * kLd + 8 * kd + t;
          const uint32_t bh[2] = {__float_as_uint(Ph[o]),
                                  __float_as_uint(Ph[o + 4])};
          const uint32_t bl[2] = {__float_as_uint(Pl[o]),
                                  __float_as_uint(Pl[o + 4])};
          mma_3xtf32(s[nj], ah, al, bh, bl);
        }
      }
      // scale and bias, then the exact row max. Row g + 8 hf's terms:
      // rh[kr] = RB[row][kr]; rw[c2][e] = RB[row][kh + kc] for kc = 8 c2 +
      // 2 t + e, -inf where kc >= kw or kr >= kh (an empty slot)
      const float* rb0 = RB + (lr + g) * L.rl;
      float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float* rb = rb0 + hf * 8 * L.rl;
        float rwv[2][2];
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kc = 8 * c2 + 2 * t + e;
            rwv[c2][e] = kc < kw ? rb[kh + kc] : -INFINITY;
          }
#pragma unroll
        for (int j = 0; j < 2 * NT; ++j) {
          const float rhv = (j >> 1) < kh ? rb[j >> 1] : -INFINITY;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[j][2 * hf + e];
            x = x * scale + (rhv + rwv[j & 1][e]);
            m[hf] = fmaxf(m[hf], x);
          }
        }
      }
      float l[2] = {0.f, 0.f};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 1));
        m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 2));
      }
      // the exact row sum, then p = exp(s - m) / l
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[j][c] = expf(s[j][c] - m[c >> 1]);
          l[c >> 1] += s[j][c];
        }
      float inv[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
        l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
        inv[hf] = 1.f / l[hf];
      }
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] *= inv[c >> 1];
    }
    __syncthreads();  // every warp is done with k
    load_split(src + 2 * C);
    __syncthreads();

    // phase 2: o = p v, p's 8-slot steps from the registers (tf32_pi order:
    // k index t is slot 8 j + 2 t, t + 4 slot 8 j + 2 t + 1)
    if (mine) {
      float acc[HD / 8][4];
#pragma unroll
      for (int dj = 0; dj < HD / 8; ++dj)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[dj][c] = 0.f;
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j) {
        if ((j >> 1) >= kh) continue;  // an empty slot row: p = 0
        const float pa[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int u2 = 0; u2 < 4; ++u2) tf32_split(pa[u2], ah[u2], al[u2]);
#pragma unroll
        for (int dj = 0; dj < HD / 8; ++dj) {
          const int o = (8 * j + 2 * t) * kLd + 8 * dj + g;
          const uint32_t bh[2] = {__float_as_uint(Ph[o]),
                                  __float_as_uint(Ph[o + kLd])};
          const uint32_t bl[2] = {__float_as_uint(Pl[o]),
                                  __float_as_uint(Pl[o + kLd])};
          mma_3xtf32(acc[dj], ah, al, bh, bl);
        }
      }
      float* obase = out + (size_t)(item / nh) * n * C + (item % nh) * HD;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = qt * 16 + g + hf * 8;
        if (row >= n) continue;
#pragma unroll
        for (int dj = 0; dj < HD / 8; ++dj)
          *reinterpret_cast<float2*>(obase + (size_t)row * C + 8 * dj +
                                     2 * t) =
              make_float2(acc[dj][2 * hf], acc[dj][2 * hf + 1]);
      }
    }
  }
}

template <int HD, int NT>
int launch_core_f32(const float* qkv, const float* rh, const float* rw,
                    float* out, int Bw, int n, int C, int nh, int kh, int kw,
                    float scale, cudaStream_t st) {
  const WinCoreF32Layout<HD> L(n, kh, kw, NT);
  const size_t smem = L.bytes();
  cudaError_t err = cudaFuncSetAttribute(
      window_core_f32<HD, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int units = Bw * nh * L.nz;
  const int grid = min(units, sm_count());
  window_core_f32<HD, NT><<<grid, 256, smem, st>>>(qkv, rh, rw, out, n, C,
                                                    nh, kh, kw, units, scale);
  const int e = (int)cudaGetLastError();
  if (!e) ++window_core_f32_launches;
  return e;
}

template <int HD>
int launch_core_f32_hd(const float* qkv, const float* rh, const float* rw,
                       float* out, int Bw, int n, int C, int nh, int kh,
                       int kw, float scale, cudaStream_t st) {
  if (kh <= kCoreF32Nts[0])
    return launch_core_f32<HD, kCoreF32Nts[0]>(qkv, rh, rw, out, Bw, n, C, nh,
                                               kh, kw, scale, st);
  if (kh <= kCoreF32Nts[1])
    return launch_core_f32<HD, kCoreF32Nts[1]>(qkv, rh, rw, out, Bw, n, C, nh,
                                               kh, kw, scale, st);
  if (kh <= kCoreF32Nts[2])
    return launch_core_f32<HD, kCoreF32Nts[2]>(qkv, rh, rw, out, Bw, n, C, nh,
                                               kh, kw, scale, st);
  if (kh <= kCoreF32Nts[3])
    return launch_core_f32<HD, kCoreF32Nts[3]>(qkv, rh, rw, out, Bw, n, C, nh,
                                               kh, kw, scale, st);
  return launch_core_f32<HD, kCoreF32Nts[4]>(qkv, rh, rw, out, Bw, n, C, nh,
                                             kh, kw, scale, st);
}

// The f32 core at a runtime head dim (64 or 80; checked by the caller):
// qkv [Bw*n, 3C], rh [kh, kh, hd], rw [kw, kw, hd], out [Bw*n, C], windows
// of at most 16 x 16 (n = kh kw; at 16 x 16 and hd 80 the block holds
// 231,424 bytes of shared memory).
inline int window_core_f32_hd(int hd, const float* qkv, const float* rh,
                              const float* rw, float* out, int Bw, int n,
                              int C, int nh, int kh, int kw,
                              cudaStream_t st) {
  if (kh < 1 || kw < 1 || kh > kCoreMaxSide || kw > kCoreMaxSide ||
      kh * kw != n)
    return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)hd);
  if (hd == 80)
    return launch_core_f32_hd<80>(qkv, rh, rw, out, Bw, n, C, nh, kh, kw,
                                  scale, st);
  return launch_core_f32_hd<64>(qkv, rh, rw, out, Bw, n, C, nh, kh, kw,
                                scale, st);
}

}  // namespace
}  // namespace ullsam

// launches of the f32 window core made by this library so far
extern "C" long long window_core_f32_launch_count() {
  return ullsam::window_core_f32_launches;
}
