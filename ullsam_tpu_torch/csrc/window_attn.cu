// B1: fused windowed ViT attention half-block for Hopper (sm_90a).
//
// Replaces the TPU kernel ullsam_tpu/ops/pallas/vit_block.py
// `_window_attn_kernel` (via `fused_window_attn`): for pre-partitioned
// windows x [Bw, n, C] it returns
//     x + proj(attn(mask(LN1(x))))
// with per-head softmax(q k^T * hd^-1/2 + decomposed rel-pos bias) v.
//
// What bounds it on this card: operations. At the SAM ViT-B main-path shape
// (Bw = 25 windows of n = 196, C = 768, 12 heads of 64) one call is ~26
// GFLOP (qkv 17.3 + proj 5.8 + attention 2.9) against ~20-40 MB of bytes,
// far above the H100's ops:byte ridge. So the products run on the tensor
// cores in bf16 (mma.sync, f32 accumulate); float32 stays true f32 FMA on
// the CUDA cores (no TF32), whose 67 TFLOP/s is then the ceiling.
//
// At SAM ViT-H (Bw = 25, n = 196, C = 1280, 16 heads of 80) a call is ~70
// GFLOP; head dims 64 and 80 have their own instances of the attention core.
//
// Design: a chain of four kernels on one stream, each simple and right:
//   1. ln_mask_kernel (ln_rows.cuh): one warp per token row; one-pass f32
//      LayerNorm (E[x], E[x^2]) and the zeroing of pad tokens' normed
//      activations, with the window geometry (nwx, nwy, Hv, Wv) rebuilt
//      from the row index. Pad keys stay in the softmax: they carry k = qkv
//      bias, as in the reference's pad-after-norm.
//   2. GEMM (gemm.cuh) against the natural [out, in] weight with a bias
//      epilogue, for qkv and, with the f32 residual epilogue, for proj:
//      gemm_nt_bf16_mma
//      (128x128x32 tiles, cp.async double buffer, ldmatrix + mma.sync) or,
//      in f32, gemm_nt_f32 (128x128x8 tiles of 8x8 FMA per thread, the next
//      k-tile fetched into registers while the current one is multiplied).
//   3. the attention core, one (head, window) per block: in bf16
//      window_attn_core_mma (k, v, q in shared memory, rel-pos terms by FMA,
//      16-row query tiles per warp through attn_mma.cuh); in f32
//      window_attn_core_f32 (64-query blocks against 64-key tiles through
//      attn_fma.cuh).
// The TPU kernel's Mosaic workarounds are gone: no 128-lane head padding,
// no one-hot selection matmuls, no [P*n, P*n] block-masked logits.
//
// bf16 rounding points match vit_block.py:231-290: LN output cast before
// qkv, qkv cast after its bias, p cast before p.v, o_h cast before proj;
// the residual sum is f32.
//
// B3, the attention core alone (window_attn_core_forward below), replaces
// ullsam_tpu/ops/pallas/flash_attention.py `_vit_window_kernel`: the
// forward recompute inside B1's gradient. It is step 3 above on a caller's
// qkv [Bw*n, 3C] (natural layout: no 128-lane head slots, no selection
// matmuls). Its gradient, B8, is window_attn_bwd.cu.
#include "attn_fma.cuh"
#include "attn_mma.cuh"
#include "gemm.cuh"
#include "ln_rows.cuh"

namespace ullsam {
namespace {

constexpr int kAttnMaxKeys = 256;  // n <= 256 tokens per window
constexpr int kAttnMaxRel = 64;    // kh + kw <= 64

// head dims with an instantiated core: SAM ViT-B / L (64), ViT-H (80)
inline bool head_dim_ok(int hd) { return hd == 64 || hd == 80; }

// ---- f32 attention core on the CUDA cores ---------------------------------
// grid (nh, Bw, ceil(n / 64)), 256 threads: 64 query rows of one (head,
// window) against the window's keys in 64-key tiles (attn_fma.cuh; keys past
// n get a bias of -1e30). The block first computes its rows' rel-pos terms
// RB[r][i] = q_r . Rh[qr, i] (i < kh), q_r . Rw[qc, i - kh] from the unscaled
// q, as the reference does: a warp takes a row and four table entries per
// step, eight lanes to an entry (coalesced float2 loads of the table row,
// three shuffles to sum). qkv [Bw*n, 3C] (q | k | v, head h at h*HD);
// rh [kh, kh, HD], rw [kw, kw, HD]; out [Bw*n, C].
template <int HD>
size_t core_f32_smem_bytes() {
  return sizeof(float) *
         (AttnBlockF32<HD>::kSmemFloats + (size_t)64 * kAttnMaxRel);
}

template <int HD>
__global__ void __launch_bounds__(256)
    window_attn_core_f32(const float* __restrict__ qkv,
                         const float* __restrict__ rh,
                         const float* __restrict__ rw, float* __restrict__ out,
                         int n, int C, int kh, int kw, float scale) {
  using Fma = AttnBlockF32<HD>;
  constexpr int kLdT = Fma::kLdT, kLdV = Fma::kLdV;
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;                       // [HD][kLdT]  (d-major)
  float* Kt = Qt + HD * kLdT;           // [HD][kLdT]  (d-major)
  float* Vs = Kt + HD * kLdT;           // [64][kLdV]
  float* Ps = Vs + 64 * kLdV;           // [64][kLdP]
  float* RB = Ps + 64 * Fma::kLdP;      // [64][kAttnMaxRel]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, win = blockIdx.y, r0 = blockIdx.z * 64;
  const int rows = min(64, n - r0);
  const size_t C3 = 3 * (size_t)C;
  const float* base = qkv + (size_t)win * n * C3 + h * HD;

  for (int e = tid; e < 64 * HD; e += 256) {
    const int r = e / HD, d = e % HD;
    const float qv = r < rows ? base[(size_t)(r0 + r) * C3 + d] : 0.f;
    Qt[d * kLdT + r] = qv;
    Vs[r * kLdV + d] = qv;  // row-major copy for the rel-pos terms
  }
  __syncthreads();
  const int rl = kh + kw, sub = lane & 7, part = lane >> 3;
  for (int r = warp; r < rows; r += 8) {
    const int qrow = r0 + r, y = qrow / kw, x = qrow - y * kw;
    const float* q = Vs + r * kLdV;
    for (int i0 = 0; i0 < rl; i0 += 4) {
      const int i = min(i0 + part, rl - 1);
      const float* tab = i < kh ? rh + ((size_t)y * kh + i) * HD
                                : rw + ((size_t)x * kw + i - kh) * HD;
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < HD / 16; ++k) {
        const int d = 16 * k + 2 * sub;
        const float2 tv = *reinterpret_cast<const float2*>(tab + d);
        const float2 qd = *reinterpret_cast<const float2*>(q + d);
        a = fmaf(qd.x, tv.x, fmaf(qd.y, tv.y, a));
      }
      a += __shfl_xor_sync(0xffffffffu, a, 4);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      if (sub == 0 && i0 + part < rl) RB[r * kAttnMaxRel + i0 + part] = a;
    }
  }

  Fma fb;
  fb.begin(tid);
  const float inv_kw = 1.f / kw;
  const auto bias = [&](int r, int key) {
    const float* rb = RB + r * kAttnMaxRel;
    const int kr = div_small(key, inv_kw);
    return key < n ? rb[kr] + rb[kh + key - kr * kw] : -1e30f;
  };
  for (int k0 = 0; k0 < n; k0 += 64) {
    __syncthreads();  // RB written; previous tile's Kt / Vs / Ps are free
    for (int e = tid; e < 64 * HD; e += 256) {
      const int j = e / HD, d = e % HD;
      const bool ok = k0 + j < n;
      const float* row = base + (size_t)(ok ? k0 + j : 0) * C3 + d;
      Kt[d * kLdT + j] = ok ? row[C] : 0.f;
      Vs[j * kLdV + d] = ok ? row[2 * C] : 0.f;
    }
    __syncthreads();
    fb.tile(Qt, Kt, Vs, Ps, k0, scale, bias);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + fb.ty * 4 + i;
    if (row >= n) continue;
    const float inv = 1.f / fb.l[i];
    float* orow = out + ((size_t)win * n + row) * C + h * HD + fb.col0();
#pragma unroll
    for (int c = 0; c < Fma::kCols; ++c) orow[c] = fb.acc[i][c] * inv;
  }
}

// ---- bf16 attention core on the tensor cores ------------------------------
// grid (nh, Bw, 2): the two z-blocks of a (head, window) split its query
// rows; each stages the window's k and v (zero rows up to a multiple of 16)
// and its own q rows in shared memory by cp.async, computes the rel-pos
// terms q.Rh / q.Rw of its rows with FMA into shared memory, then each warp
// runs 16-row query tiles through AttnWarp (logits scaled in f32, as the
// reference scales q.k, not q).
template <int HD>
struct WinMmaLayout {
  static constexpr int kLd = AttnWarp<HD>::kLd;
  int nk16, nkv, nq16, half, rl;
  __host__ __device__ WinMmaLayout(int n, int kh, int kw)
      : nk16((n + 15) / 16), nkv(nk16 * 16), nq16(nk16),
        half((nk16 + 1) / 2), rl(kh + kw) {}
  __host__ __device__ size_t bytes() const {
    return sizeof(__nv_bfloat16) * (size_t)(2 * nkv + half * 16) * kLd +
           sizeof(float) * (size_t)half * 16 * rl;
  }
};

template <int HD>
__global__ void __launch_bounds__(256)
    window_attn_core_mma(const __nv_bfloat16* __restrict__ qkv,
                         const __nv_bfloat16* __restrict__ rh,
                         const __nv_bfloat16* __restrict__ rw,
                         __nv_bfloat16* __restrict__ out, int n, int C, int kh,
                         int kw, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int kLd = AttnWarp<HD>::kLd;
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  const WinMmaLayout<HD> L(n, kh, kw);
  extern __shared__ __align__(16) unsigned char smraw[];
  bf16* Ks = reinterpret_cast<bf16*>(smraw);
  bf16* Vs = Ks + L.nkv * kLd;
  bf16* Qs = Vs + L.nkv * kLd;                                 // L.half*16 rows
  float* RB = reinterpret_cast<float*>(Qs + L.half * 16 * kLd);  // [rows][rl]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, win = blockIdx.y;
  const int qt0 = blockIdx.z * L.half;
  const int qt1 = min(L.nq16, qt0 + L.half);
  const int r0 = qt0 * 16;  // first query row of this block
  const size_t C3 = 3 * (size_t)C;
  const bf16* base = qkv + (size_t)win * n * C3 + h * HD;

  for (int c = tid; c < L.nkv * kChunks; c += 256) {
    const int row = c / kChunks, ch = (c % kChunks) * 8;
    const bool ok = row < n;
    const bf16* src = base + (size_t)(ok ? row : 0) * C3 + ch;
    cp_async16(smem_u32(Ks + row * kLd + ch), src + C, ok);
    cp_async16(smem_u32(Vs + row * kLd + ch), src + 2 * C, ok);
  }
  for (int c = tid; c < L.half * 16 * kChunks; c += 256) {
    const int row = c / kChunks, ch = (c % kChunks) * 8;
    const bool ok = r0 + row < n;
    cp_async16(smem_u32(Qs + row * kLd + ch),
               base + (size_t)(ok ? r0 + row : 0) * C3 + ch, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // rel-pos terms RB[r][i] = q_r . Rh[qr, i] (i < kh), q_r . Rw[qc, i - kh]:
  // a warp takes a row and four table entries per step, eight lanes to an
  // entry (coalesced bf16x2 loads of the table row, three shuffles to sum)
  const int sub = lane & 7, part = lane >> 3;
  for (int r = warp; r < L.half * 16; r += 8) {
    const int qrow = min(r0 + r, n - 1), y = qrow / kw, x = qrow - y * kw;
    const bf16* qr = Qs + r * kLd;
    for (int i0 = 0; i0 < L.rl; i0 += 4) {
      const int i = min(i0 + part, L.rl - 1);
      const bf16* tab = i < kh ? rh + ((size_t)y * kh + i) * HD
                               : rw + ((size_t)x * kw + i - kh) * HD;
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < HD / 16; ++k) {
        const int d = 16 * k + 2 * sub;
        const float2 tv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(tab + d));
        const float2 qd = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(qr + d));
        a = fmaf(qd.x, tv.x, fmaf(qd.y, tv.y, a));
      }
      a += __shfl_xor_sync(0xffffffffu, a, 4);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      if (sub == 0 && i0 + part < L.rl) RB[r * L.rl + i0 + part] = a;
    }
  }
  __syncthreads();

  for (int qt = qt0 + warp; qt < qt1; qt += 8) {
    const int lr = (qt - qt0) * 16;  // local row of this tile
    AttnWarp<HD> aw;
    aw.begin(Qs, lr, lane);
    const float* rb0 = RB + (lr + g) * L.rl;
    const float inv_kw = 1.f / kw;
    const auto bias = [&](int hf, int key) {
      const float* rb = rb0 + hf * 8 * L.rl;
      const int kr = div_small(key, inv_kw);
      return rb[kr] + rb[kh + key - kr * kw];
    };
    for (int k0 = 0; k0 < L.nkv; k0 += 64)
      aw.chunk(Ks + k0 * kLd, Vs + k0 * kLd, min(4, (L.nkv - k0) / 16), k0,
               n, scale, bias, lane);
    float inv[2];
    aw.finish(inv);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = qt * 16 + g + hf * 8;
      if (row >= n) continue;
      bf16* orow = out + ((size_t)win * n + row) * C + h * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t) =
            __floats2bfloat162_rn(aw.acc[j][2 * hf] * inv[hf],
                                  aw.acc[j][2 * hf + 1] * inv[hf]);
    }
  }
}

// f32: the CUDA-core core (true f32); bf16: the tensor-core core
template <int HD>
int attn_core(const float* qkv, const float* rh, const float* rw, float* out,
              int Bw, int n, int C, int nh, int kh, int kw, float scale,
              cudaStream_t st) {
  const size_t smem = core_f32_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      window_attn_core_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_attn_core_f32<HD><<<dim3(nh, Bw, (n + 63) / 64), 256, smem, st>>>(
      qkv, rh, rw, out, n, C, kh, kw, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int attn_core(const __nv_bfloat16* qkv, const __nv_bfloat16* rh,
              const __nv_bfloat16* rw, __nv_bfloat16* out, int Bw, int n,
              int C, int nh, int kh, int kw, float scale, cudaStream_t st) {
  const size_t smem = WinMmaLayout<HD>(n, kh, kw).bytes();
  cudaError_t err = cudaFuncSetAttribute(
      window_attn_core_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_attn_core_mma<HD><<<dim3(nh, Bw, 2), 256, smem, st>>>(
      qkv, rh, rw, out, n, C, kh, kw, scale);
  return (int)cudaGetLastError();
}

// the core at a runtime head dim (head_dim_ok checked by the caller)
template <typename T>
int attn_core_hd(int hd, const T* qkv, const T* rh, const T* rw, T* out,
                 int Bw, int n, int C, int nh, int kh, int kw, float scale,
                 cudaStream_t st) {
  if (hd == 80)
    return attn_core<80>(qkv, rh, rw, out, Bw, n, C, nh, kh, kw, scale, st);
  return attn_core<64>(qkv, rh, rw, out, Bw, n, C, nh, kh, kw, scale, st);
}

template <typename T>
int forward(const void* x_, const void* lnw, const void* lnb,
            const void* qkvw, const void* qkvb, const void* projw,
            const void* projb, const void* rh, const void* rw, void* ybuf,
            void* qkvbuf, void* obuf, void* out, int Bw, int n, int C, int nh,
            int hd, int kh, int kw, float eps, int nwx, int nwy, int Hv,
            int Wv, int masked, cudaStream_t st) {
  const T* x = static_cast<const T*>(x_);
  T* y = static_cast<T*>(ybuf);
  T* qkv = static_cast<T*>(qkvbuf);
  T* o = static_cast<T*>(obuf);
  const int M = Bw * n;
  ln_mask_kernel<T><<<(M + 7) / 8, 256, 0, st>>>(
      x, static_cast<const T*>(lnw), static_cast<const T*>(lnb), y, M, C, eps,
      n, kh, kw, nwx, nwy, Hv, Wv, masked);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = gemm_nt(y, static_cast<const T*>(qkvw),
                   static_cast<const T*>(qkvb), nullptr, qkv, M, 3 * C, C, st);
  if (err) return err;
  const float scale = 1.0f / sqrtf((float)hd);
  const T* rht = static_cast<const T*>(rh);
  const T* rwt = static_cast<const T*>(rw);
  err = attn_core_hd(hd, qkv, rht, rwt, o, Bw, n, C, nh, kh, kw, scale, st);
  if (err) return err;
  return gemm_nt(o, static_cast<const T*>(projw),
                    static_cast<const T*>(projb), x, static_cast<T*>(out), M,
                    C, C, st);
}

}  // namespace
}  // namespace ullsam

// Plain C entry point (loaded with ctypes). Returns 0 or a cudaError_t.
// dtype: 0 = float32, 1 = bfloat16; every tensor argument has that dtype.
// qkvb / projb may be null. ybuf [Bw*n, C], qkvbuf [Bw*n, 3C], obuf
// [Bw*n, C] are scratch the caller allocates.
extern "C" int window_attn_forward(
    int dtype, const void* x, const void* lnw, const void* lnb,
    const void* qkvw, const void* qkvb, const void* projw, const void* projb,
    const void* rh, const void* rw, void* ybuf, void* qkvbuf, void* obuf,
    void* out, int Bw, int n, int C, int nh, int hd, int kh, int kw,
    float eps, int nwx, int nwy, int Hv, int Wv, int masked, void* stream) {
  using namespace ullsam;
  if (n > kAttnMaxKeys || kh + kw > kAttnMaxRel || !head_dim_ok(hd) ||
      nh * hd != C || C % kMmaBK != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return forward<float>(x, lnw, lnb, qkvw, qkvb, projw, projb, rh, rw, ybuf,
                          qkvbuf, obuf, out, Bw, n, C, nh, hd, kh, kw, eps,
                          nwx, nwy, Hv, Wv, masked, st);
  if (dtype == kBF16)
    return forward<__nv_bfloat16>(x, lnw, lnb, qkvw, qkvb, projw, projb, rh,
                                  rw, ybuf, qkvbuf, obuf, out, Bw, n, C, nh,
                                  hd, kh, kw, eps, nwx, nwy, Hv, Wv, masked,
                                  st);
  return (int)cudaErrorInvalidValue;
}

// B3: the attention core alone. qkv [Bw*n, 3C], rh [kh, kh, hd],
// rw [kw, kw, hd], out [Bw*n, C], all of dtype (0 = float32, 1 = bfloat16).
// Returns 0 or a cudaError_t.
extern "C" int window_attn_core_forward(int dtype, const void* qkv,
                                        const void* rh, const void* rw,
                                        void* out, int Bw, int n, int C,
                                        int nh, int hd, int kh, int kw,
                                        void* stream) {
  using namespace ullsam;
  if (n > kAttnMaxKeys || kh * kw != n || kh + kw > kAttnMaxRel ||
      !head_dim_ok(hd) || nh * hd != C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf((float)hd);
  if (dtype == kF32)
    return attn_core_hd(hd, static_cast<const float*>(qkv),
                        static_cast<const float*>(rh),
                        static_cast<const float*>(rw), static_cast<float*>(out),
                        Bw, n, C, nh, kh, kw, scale, st);
  if (dtype == kBF16)
    return attn_core_hd(hd, static_cast<const __nv_bfloat16*>(qkv),
                        static_cast<const __nv_bfloat16*>(rh),
                        static_cast<const __nv_bfloat16*>(rw),
                        static_cast<__nv_bfloat16*>(out), Bw, n, C, nh, kh, kw,
                        scale, st);
  return (int)cudaErrorInvalidValue;
}
