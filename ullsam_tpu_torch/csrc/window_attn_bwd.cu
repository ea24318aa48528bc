// B8: gradient of the windowed ViT attention core (B3) for Hopper (sm_90a).
//
// Replaces the TPU kernel ullsam_tpu/ops/pallas/flash_attention.py
// `_vit_window_bwd_kernel` (via `_vit_window_packed_bwd_impl`). For each
// window of n = kh*kw <= 256 tokens and head of 64 channels, with
//     s = q k^T * 64^-1/2 + bias,  bias[i, m] = rel_h[i, row(m)] +
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
// products; the outputs are rounded once at the end.
//
// What bounds it on this card: not the operations. At the ViT-B main-path
// shape (25 windows x 12 heads, n = 196) the backward is ~7 GFLOP against
// ~20 MB, far under a millisecond of either; its time is set by latency and
// occupancy. Design, simple first: one block per (head, window), 256
// threads, all math in f32 FMA on the CUDA cores for both dtypes (bf16 is
// widened on load and rounded at the cast points above).
//   * the window's k and v stay in shared memory, d-major ([64][n | 1], odd
//     stride: conflict-free column reads), and dk, dv accumulate there in
//     f32 over the query tiles;
//   * queries go in tiles of 16 rows; thread j owns key j: it computes the
//     16 logits of column j, so p, dp and ds of its column stay in
//     registers and only row statistics (max, sum, dd) pass through shared
//     memory; it adds its column's share to dk[j] and dv[j];
//   * the rows' ds goes to shared memory for dq and the two bias sums;
//   * the rounded drel of every (window, head, row) is written to a scratch
//     array, and two small kernels sum the table gradients from it in a
//     fixed order (per window, then over windows): deterministic, no float
//     atomics.
#include "common.cuh"

namespace ullsam {
namespace {

constexpr int kHD = 64;      // head dim
constexpr int kTQ = 16;      // query rows per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__host__ __device__ inline int bwd_ld(int n) { return n | 1; }

// must match ops/kernels/window_attention.py bwd_smem_bytes
template <typename T>
size_t bwd_smem_bytes(int n, int rl) {
  const size_t ld = bwd_ld(n);
  return 2 * kHD * ld * sizeof(T) + 2 * kHD * ld * sizeof(float) +
         2 * kTQ * kHD * sizeof(float) + kTQ * ld * sizeof(float) +
         2 * kTQ * rl * sizeof(float) + 3 * kTQ * sizeof(float) +
         kWarps * kTQ * sizeof(float);
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

// grid (nh, Bw), 256 threads. qkv [Bw*n, 3C], do [Bw*n, C], dqkv [Bw*n, 3C];
// rh [kh, kh, 64], rw [kw, kw, 64]; drel [Bw, nh, n, kh + kw] f32
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    window_bwd_core(const T* __restrict__ qkv, const T* __restrict__ rh,
                    const T* __restrict__ rw, const T* __restrict__ dout,
                    T* __restrict__ dqkv, float* __restrict__ drel, int n,
                    int C, int nh, int kh, int kw, float scale) {
  const int ld = bwd_ld(n), rl = kh + kw;
  extern __shared__ __align__(16) unsigned char smraw[];
  T* Kt = reinterpret_cast<T*>(smraw);                   // [64][ld]
  T* Vt = Kt + kHD * ld;                                 // [64][ld]
  float* dKt = reinterpret_cast<float*>(Vt + kHD * ld);  // [64][ld]
  float* dVt = dKt + kHD * ld;                           // [64][ld]
  float* Qs = dVt + kHD * ld;                            // [16][64]
  float* Gs = Qs + kTQ * kHD;                            // [16][64]
  float* DS = Gs + kTQ * kHD;                            // [16][ld]
  float* RB = DS + kTQ * ld;                             // [16][rl]
  float* DR = RB + kTQ * rl;                             // [16][rl]
  float* Mx = DR + kTQ * rl;                             // [16]
  float* Sm = Mx + kTQ;                                  // [16]
  float* Dd = Sm + kTQ;                                  // [16]
  float* red = Dd + kTQ;                                 // [8][16]

  const int tid = threadIdx.x;
  const int h = blockIdx.x, win = blockIdx.y;
  const size_t C3 = 3 * (size_t)C;
  const T* base = qkv + (size_t)win * n * C3 + h * kHD;
  const T* gbase = dout + (size_t)win * n * C + h * kHD;
  T* dbase = dqkv + (size_t)win * n * C3 + h * kHD;

  for (int e = tid; e < n * kHD; e += kThreads) {
    const int j = e / kHD, d = e % kHD;
    Kt[d * ld + j] = base[(size_t)j * C3 + C + d];
    Vt[d * ld + j] = base[(size_t)j * C3 + 2 * C + d];
    dKt[d * ld + j] = 0.f;
    dVt[d * ld + j] = 0.f;
  }

  const int j = tid;             // this thread's key column
  const bool col = j < n;
  const int kr = col ? j / kw : 0, kc = col ? j - (j / kw) * kw : 0;

  for (int i0 = 0; i0 < n; i0 += kTQ) {
    const int rows = min(kTQ, n - i0);
    __syncthreads();  // previous tile's Qs / Gs / DS / RB / DR are free
    for (int e = tid; e < kTQ * kHD; e += kThreads) {
      const int r = e / kHD, d = e % kHD;
      const bool ok = r < rows;
      Qs[e] = ok ? to_f(base[(size_t)(i0 + r) * C3 + d]) : 0.f;
      Gs[e] = ok ? to_f(gbase[(size_t)(i0 + r) * C + d]) : 0.f;
    }
    __syncthreads();
    // rel-pos terms of the tile's rows: one 64-long dot per (row, entry)
    for (int e = tid; e < kTQ * rl; e += kThreads) {
      const int r = e / rl, idx = e % rl;
      float a = 0.f;
      if (r < rows) {
        const int i = i0 + r, y = i / kw, x = i - y * kw;
        const T* tab = idx < kh ? rh + ((size_t)y * kh + idx) * kHD
                                : rw + ((size_t)x * kw + idx - kh) * kHD;
        const float* q = Qs + r * kHD;
#pragma unroll 8
        for (int d = 0; d < kHD; ++d) a = fmaf(q[d], to_f(tab[d]), a);
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
        const float kv = to_f(Kt[d * ld + j]), vv = to_f(Vt[d * ld + j]);
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
        ds[r] = round_to<T>(s[r] * (dp[r] - Dd[r]));
        s[r] = round_to<T>(s[r]);  // p rounded for p^T do
        DS[r * ld + j] = ds[r];
      }
      for (int d = 0; d < kHD; ++d) {
        float av = 0.f, ak = 0.f;
#pragma unroll
        for (int r = 0; r < kTQ; ++r) {
          av = fmaf(s[r], Gs[r * kHD + d], av);
          ak = fmaf(ds[r], Qs[r * kHD + d], ak);
        }
        dVt[d * ld + j] += av;
        dKt[d * ld + j] += ak;
      }
    }
    __syncthreads();  // DS complete

    // the two bias sums of each row's ds, rounded
    for (int e = tid; e < kTQ * rl; e += kThreads) {
      const int r = e / rl, idx = e % rl;
      const float* dsr = DS + r * ld;
      float a = 0.f;
      if (idx < kh) {
        for (int c = 0; c < kw; ++c) a += dsr[idx * kw + c];
      } else {
        for (int y = 0; y < kh; ++y) a += dsr[y * kw + idx - kh];
      }
      a = round_to<T>(a);
      DR[e] = a;
      if (r < rows)
        drel[(((size_t)win * nh + h) * n + i0 + r) * rl + idx] = a;
    }
    __syncthreads();

    // dq of the tile: thread (row r, 4 channels from d0)
    {
      const int r = tid >> 4, d0 = (tid & 15) * 4;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const float* dsr = DS + r * ld;
      for (int m = 0; m < n; ++m) {
        const float w = dsr[m];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc[u] = fmaf(w, to_f(Kt[(d0 + u) * ld + m]), acc[u]);
      }
      if (r < rows) {
        const int i = i0 + r, y = i / kw, x = i - y * kw;
        float rel[4] = {0.f, 0.f, 0.f, 0.f};
        for (int idx = 0; idx < rl; ++idx) {
          const float w = DR[r * rl + idx];
          const T* tab = idx < kh ? rh + ((size_t)y * kh + idx) * kHD
                                  : rw + ((size_t)x * kw + idx - kh) * kHD;
#pragma unroll
          for (int u = 0; u < 4; ++u)
            rel[u] = fmaf(w, to_f(tab[d0 + u]), rel[u]);
        }
        T* dq = dbase + (size_t)i * C3 + d0;
#pragma unroll
        for (int u = 0; u < 4; ++u) dq[u] = from_f<T>(acc[u] * scale + rel[u]);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < n * kHD; e += kThreads) {
    const int jj = e / kHD, d = e % kHD;
    dbase[(size_t)jj * C3 + C + d] = from_f<T>(dKt[d * ld + jj] * scale);
    dbase[(size_t)jj * C3 + 2 * C + d] = from_f<T>(dVt[d * ld + jj]);
  }
}

// Table gradients, pass 1: grid (ceil(E / 256), Bw) with E = (kh*kh + kw*kw)
// * 64 entries. Entry e < kh*kh*64 is dRh[y, r, d] (e = (y*kh + r)*64 + d),
// the rest dRw[x, c, d]; each thread sums its entry over one window's heads
// and rows (columns) into part[win, e].
template <typename T>
__global__ void __launch_bounds__(256)
    window_bwd_tables_part(const T* __restrict__ qkv,
                           const float* __restrict__ drel,
                           float* __restrict__ part, int n, int C, int nh,
                           int kh, int kw) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  const int eh = kh * kh * kHD, E = eh + kw * kw * kHD;
  if (e >= E) return;
  const int win = blockIdx.y, rl = kh + kw;
  const size_t C3 = 3 * (size_t)C;
  const int d = e % kHD;
  const bool is_h = e < eh;
  const int t = (is_h ? e : e - eh) / kHD;
  const int k = is_h ? kh : kw;
  const int a = t / k, b = t % k;  // (y, r) or (x, c)
  float acc = 0.f;
  for (int h = 0; h < nh; ++h) {
    const float* dr = drel + ((size_t)win * nh + h) * n * rl;
    const T* q = qkv + (size_t)win * n * C3 + h * kHD + d;
    const int cnt = is_h ? kw : kh;
    for (int o = 0; o < cnt; ++o) {
      const int i = is_h ? a * kw + o : o * kw + a;
      acc = fmaf(dr[(size_t)i * rl + (is_h ? b : kh + b)],
                 to_f(q[(size_t)i * C3]), acc);
    }
  }
  part[(size_t)win * E + e] = acc;
}

// pass 2: out[e] = sum over windows in order of part[win, e]; drh and drw
// are the two halves
__global__ void __launch_bounds__(256)
    window_bwd_tables_sum(const float* __restrict__ part,
                          float* __restrict__ drh, float* __restrict__ drw,
                          int Bw, int eh, int E) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= E) return;
  float acc = 0.f;
  for (int w = 0; w < Bw; ++w) acc += part[(size_t)w * E + e];
  if (e < eh)
    drh[e] = acc;
  else
    drw[e - eh] = acc;
}

template <typename T>
int backward(const void* qkv, const void* rh, const void* rw, const void* dout,
             void* dqkv, float* drh, float* drw, float* drel, float* part,
             int Bw, int n, int C, int nh, int kh, int kw, cudaStream_t st) {
  const int rl = kh + kw;
  const size_t smem = bwd_smem_bytes<T>(n, rl);
  cudaError_t err = cudaFuncSetAttribute(
      window_bwd_core<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.0f / sqrtf((float)kHD);
  window_bwd_core<T><<<dim3(nh, Bw), kThreads, smem, st>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(rh),
      static_cast<const T*>(rw), static_cast<const T*>(dout),
      static_cast<T*>(dqkv), drel, n, C, nh, kh, kw, scale);
  int e = (int)cudaGetLastError();
  if (e) return e;
  const int eh = kh * kh * kHD, E = eh + kw * kw * kHD;
  window_bwd_tables_part<T><<<dim3((E + 255) / 256, Bw), 256, 0, st>>>(
      static_cast<const T*>(qkv), drel, part, n, C, nh, kh, kw);
  e = (int)cudaGetLastError();
  if (e) return e;
  window_bwd_tables_sum<<<(E + 255) / 256, 256, 0, st>>>(part, drh, drw, Bw,
                                                         eh, E);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ullsam

// Plain C entry point (loaded with ctypes). Returns 0 or a cudaError_t.
// dtype: 0 = float32, 1 = bfloat16 for qkv [Bw*n, 3C], rh [kh, kh, 64],
// rw [kw, kw, 64], dout [Bw*n, C] and dqkv [Bw*n, 3C]; drh, drw, and the
// scratch drel [Bw, nh, n, kh + kw] and part [Bw, (kh*kh + kw*kw) * 64]
// are float32.
extern "C" int window_attn_bwd(int dtype, const void* qkv, const void* rh,
                               const void* rw, const void* dout, void* dqkv,
                               void* drh, void* drw, void* drel, void* part,
                               int Bw, int n, int C, int nh, int hd, int kh,
                               int kw, void* stream) {
  using namespace ullsam;
  if (n > 256 || kh * kw != n || hd != kHD || nh * hd != C || kh + kw > 64)
    return (int)cudaErrorInvalidValue;
  const size_t smem = dtype == kF32 ? bwd_smem_bytes<float>(n, kh + kw)
                                    : bwd_smem_bytes<__nv_bfloat16>(n, kh + kw);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* f_drh = static_cast<float*>(drh);
  float* f_drw = static_cast<float*>(drw);
  float* f_drel = static_cast<float*>(drel);
  float* f_part = static_cast<float*>(part);
  if (dtype == kF32)
    return backward<float>(qkv, rh, rw, dout, dqkv, f_drh, f_drw, f_drel,
                           f_part, Bw, n, C, nh, kh, kw, st);
  if (dtype == kBF16)
    return backward<__nv_bfloat16>(qkv, rh, rw, dout, dqkv, f_drh, f_drw,
                                   f_drel, f_part, Bw, n, C, nh, kh, kw, st);
  return (int)cudaErrorInvalidValue;
}
