// B2: ViT global flash attention with the factored decomposed rel-pos bias,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel ullsam_tpu/ops/pallas/flash_attention.py
// `_vit_kernel` (via `vit_flash_attention` / `_vit_flash_impl`):
//     o   = softmax(qs k^T + bias) v,   qs = cast(q * D^-1/2)
//     lse = logsumexp of each row (f32, for the backward of a later slice)
// with bias[i, key] = rel_h[i, key / KW] + rel_w[i, key % KW]; the N x N
// bias never exists in memory.
//
// What bounds it on this card: operations. At the SAM ViT-B global blocks
// (BH = 12, N = 4096, D = 64) one call is 2*2*N^2*D*BH = 51.5 GFLOP against
// ~38 MB of bytes. bf16 runs the products on the tensor cores
// (vit_flash_bf16_mma); float32 stays true f32 FMA (vit_flash_f32, no
// TF32), bounded by the 67 TFLOP/s f32 rate.
//
// Design: one block per (bh, 64-query tile); a loop over 64-key tiles (one
// key-grid row at KW = 64) with the online-softmax recurrence in f32. The
// block keeps its queries' rel_h [64, KH] and rel_w [64, KW] rows in shared
// memory for the whole key loop and adds rel_h[q, key / KW] +
// rel_w[q, key % KW] per logit: no one-hot selection matmuls, no 128-lane
// padding. f32: 256 threads through attn_fma.cuh. bf16: 4 warps of 16 query
// rows (attn_mma.cuh), K / V tiles double-buffered by cp.async.
//
// Rounding points match _vit_flash_impl: q is pre-scaled and cast to q's
// dtype; rel factors arrive at q's dtype; p is cast to v's dtype before p.v;
// the output is acc / l cast to q's dtype.
//
// Head dims 64 (SAM ViT-B / L) and 80 (ViT-H: 16 heads of 80, BH = 16,
// 80.5 GFLOP a call) are instantiated. The kernels address q, k, v and o
// through strides (a batch and a head stride per bh = b * nh + h, and a row
// stride), so one body serves two layouts:
//   * B2, vit_flash_attn_forward: q, k, v, o [BH, N, D], contiguous;
//   * B14, vit_flash_attn_packed_forward, which replaces
//     flash_attention.py `_vit_kernel_packed` (opt-in by
//     ULLSAM_PACKED_GLOBAL=1): head h of image b read straight from the qkv
//     projection [B, N, 3C] at columns h D, C + h D, 2C + h D (row stride
//     3C), and o written into [B, N, C] at column h D, the layout proj
//     consumes: no head-split copy before, no merge transpose after. The TPU
//     kernel pads every head to 128 lanes for that; here the natural layout
//     needs no pad. Same function and rounding points as B2.
#include "attn_fma.cuh"
#include "attn_mma.cuh"

namespace ullsam {
namespace {

constexpr int kBQ = 64, kBK = 64, kMaxRel = 64;

// Where head bh = b * nh + h of q, k, v and o lies: element (row, d) of q at
// q[b * sb + h * sh + row * ld + d] (k, v alike), of o at
// o[b * sob + h * soh + row * ldo + d].
// A head's rows are addressed in 32 bits from its own base pointer (N * ld
// stays below 2^31), the base in 64.
struct HeadStrides {
  int nh;
  long long sb, sh;
  int ld;
  long long sob, soh;
  int ldo;
  __device__ __forceinline__ size_t in(int bh) const {
    return (size_t)((bh / nh) * sb + (bh % nh) * sh);
  }
  __device__ __forceinline__ size_t out(int bh) const {
    return (size_t)((bh / nh) * sob + (bh % nh) * soh);
  }
};

template <int D>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (AttnBlockF32<D>::kSmemFloats + 2 * kBQ * kMaxRel);
}

// grid (N / 64, BH), 256 threads; q, k, v, o per HeadStrides;
// rel_h [BH, N, KH], rel_w [BH, N, KW]; lse [BH, N]
template <int D>
__global__ void __launch_bounds__(256)
    vit_flash_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ rel_h,
                  const float* __restrict__ rel_w, float* __restrict__ o,
                  float* __restrict__ lse, int N, int KH, int KW,
                  float scale, HeadStrides hs) {
  using FmaBlock = AttnBlockF32<D>;
  constexpr int kLdT = FmaBlock::kLdT, kLdV = FmaBlock::kLdV;
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;                          // [D][kLdT]  (d-major)
  float* Kt = Qt + D * kLdT;               // [D][kLdT]  (d-major)
  float* Vs = Kt + D * kLdT;               // [kBK][kLdV]
  float* Ps = Vs + kBK * kLdV;             // [kBQ][kLdP]
  float* RH = Ps + kBQ * FmaBlock::kLdP;   // [kBQ][kMaxRel]
  float* RW = RH + kBQ * kMaxRel;          // [kBQ][kMaxRel]

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ;
  const float* qh = q + hs.in(bh);
  const float* kh = k + hs.in(bh);
  const float* vh = v + hs.in(bh);
  const int ld = hs.ld;

  for (int e = tid; e < kBQ * D; e += 256) {
    const int r = e / D, d = e % D;
    Qt[d * kLdT + r] = qh[(q0 + r) * ld + d] * scale;
  }
  for (int e = tid; e < kBQ * KH; e += 256) {
    const int r = e / KH, c = e % KH;
    RH[r * kMaxRel + c] = rel_h[((size_t)bh * N + q0 + r) * KH + c];
  }
  for (int e = tid; e < kBQ * KW; e += 256) {
    const int r = e / KW, c = e % KW;
    RW[r * kMaxRel + c] = rel_w[((size_t)bh * N + q0 + r) * KW + c];
  }

  FmaBlock fb;
  fb.begin(tid);
  const float inv_kw = 1.f / KW;
  const auto bias = [&](int r, int key) {
    const int kr = div_small(key, inv_kw);
    return RH[r * kMaxRel + kr] + RW[r * kMaxRel + key - kr * KW];
  };
  for (int k0 = 0; k0 < N; k0 += kBK) {
    __syncthreads();  // previous tile's Kt / Vs / Ps are free
    for (int e = tid; e < kBK * D; e += 256) {
      const int j = e / D, d = e % D;
      const int g = (k0 + j) * ld + d;
      Kt[d * kLdT + j] = kh[g];
      Vs[j * kLdV + d] = vh[g];
    }
    __syncthreads();
    // q was pre-scaled (the reference's rounding point): logits scale 1
    fb.tile(Qt, Kt, Vs, Ps, k0, 1.0f, bias);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + fb.ty * 4 + i;
    const float inv = 1.f / fb.l[i];
#pragma unroll
    for (int c = 0; c < FmaBlock::kCols; ++c)
      o[hs.out(bh) + r * hs.ldo + fb.col0() + c] = fb.acc[i][c] * inv;
    if (fb.tx == 0) lse[(size_t)bh * N + r] = fb.m[i] + logf(fb.l[i]);
  }
}

// ---- bf16: tensor cores (mma.sync m16n8k16, f32 accumulate) -------------
// The same function for bf16, FlashAttention-2 style (attn_mma.cuh): 4 warps
// per 64-query block, 16 query rows per warp; 64-key K / V tiles
// double-buffered by cp.async; the bias rebuilt per logit from the block's
// rel_h / rel_w rows, kept in shared memory at their input dtype. q is
// staged in the second K buffer, which each warp has read into registers
// before that buffer is first filled: 54 KB a block, so 4 blocks (16 warps)
// share an SM and hide each other's latency (at D = 80: 62 KB, 3 blocks).
constexpr int kRelLd = kMaxRel + 8;  // bf16; a quad's 8 rows: 8 bank groups

template <int D>
constexpr size_t flash_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) *
         (size_t)(4 * kBK * AttnWarp<D>::kLd + 2 * kBQ * kRelLd);
}

template <int D>
__global__ void __launch_bounds__(128, D == 64 ? 4 : 3)
    vit_flash_bf16_mma(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ rel_h,
                       const __nv_bfloat16* __restrict__ rel_w,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int N, int KH, int KW, float scale, HeadStrides hs) {
  using bf16 = __nv_bfloat16;
  constexpr int kLd = AttnWarp<D>::kLd;
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smraw[];
  bf16* Ks = reinterpret_cast<bf16*>(smraw);  // [2][64][kLd]
  bf16* Vs = Ks + 2 * kBK * kLd;              // [2][64][kLd]
  bf16* Qs = Ks + kBK * kLd;                  // [64][kLd], K stage 1
  bf16* RH = Vs + 2 * kBK * kLd;              // [64][kRelLd]
  bf16* RW = RH + kBQ * kRelLd;               // [64][kRelLd]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ;
  const bf16* kh = k + hs.in(bh);
  const bf16* vh = v + hs.in(bh);
  const int ld = hs.ld;

  auto load_kv = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < kChunks / 2; ++i) {  // 64 rows x D / 8 chunks of 16 B
      const int c = tid + i * 128, row = c / kChunks, ch = (c % kChunks) * 8;
      const int src = (k0 + row) * ld + ch;
      const int dst = (stage * kBK + row) * kLd + ch;
      cp_async16(smem_u32(Ks + dst), kh + src, true);
      cp_async16(smem_u32(Vs + dst), vh + src, true);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  const bf16* qh = q + hs.in(bh);
  for (int e = tid; e < kBQ * D; e += 128) {
    const int r = e / D, d = e % D;
    Qs[r * kLd + d] =
        __float2bfloat16(__bfloat162float(qh[(q0 + r) * ld + d]) * scale);
  }
  for (int e = tid; e < kBQ * KH; e += 128) {
    const int r = e / KH, c = e % KH;
    RH[r * kRelLd + c] = rel_h[((size_t)bh * N + q0 + r) * KH + c];
  }
  for (int e = tid; e < kBQ * KW; e += 128) {
    const int r = e / KW, c = e % KW;
    RW[r * kRelLd + c] = rel_w[((size_t)bh * N + q0 + r) * KW + c];
  }
  __syncthreads();

  AttnWarp<D> aw;
  aw.begin(Qs, warp * 16, lane);
  __syncthreads();  // every warp holds its q: K stage 1 may be refilled
  const bf16* rh0 = RH + (warp * 16 + g) * kRelLd;
  const bf16* rw0 = RW + (warp * 16 + g) * kRelLd;
  const float inv_kw = 1.f / KW;
  const auto bias = [&](int hf, int key) {
    const int kr = div_small(key, inv_kw);
    return __bfloat162float(rh0[hf * 8 * kRelLd + kr]) +
           __bfloat162float(rw0[hf * 8 * kRelLd + key - kr * KW]);
  };
  const int NT = N / kBK;
  for (int kt = 0; kt < NT; ++kt) {
    if (kt + 1 < NT) {
      load_kv((kt + 1) & 1, (kt + 1) * kBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // q was pre-scaled (the reference's rounding point): logits scale 1
    aw.chunk(Ks + (kt & 1) * kBK * kLd, Vs + (kt & 1) * kBK * kLd, 4,
             kt * kBK, N, 1.0f, bias, lane);
    __syncthreads();  // this stage is refilled two tiles later
  }

  float inv[2];
  aw.finish(inv);
  bf16* oh = o + hs.out(bh);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + warp * 16 + g + hf * 8;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(oh + r * hs.ldo + j * 8 + 2 * t) =
          __floats2bfloat162_rn(aw.acc[j][2 * hf] * inv[hf],
                                aw.acc[j][2 * hf + 1] * inv[hf]);
    if (t == 0) lse[(size_t)bh * N + r] = aw.lse(hf);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* rel_h,
               const void* rel_w, void* o, float* lse, int BH, int N, int KH,
               int KW, float scale, const HeadStrides& hs, cudaStream_t st) {
  const size_t smem = flash_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      vit_flash_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  vit_flash_f32<D><<<dim3(N / kBQ, BH), 256, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(rel_h),
      static_cast<const float*>(rel_w), static_cast<float*>(o), lse, N, KH,
      KW, scale, hs);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16_mma(const void* q, const void* k, const void* v,
                    const void* rel_h, const void* rel_w, void* o, float* lse,
                    int BH, int N, int KH, int KW, float scale,
                    const HeadStrides& hs, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  const size_t smem = flash_mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      vit_flash_bf16_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  vit_flash_bf16_mma<D><<<dim3(N / kBQ, BH), 128, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(rel_h),
      static_cast<const bf16*>(rel_w), static_cast<bf16*>(o), lse, N, KH, KW,
      scale, hs);
  return (int)cudaGetLastError();
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v,
           const void* rel_h, const void* rel_w, void* o, float* lse, int BH,
           int N, int KH, int KW, float scale, const HeadStrides& hs,
           cudaStream_t st) {
  if (dtype == kF32)
    return launch_f32<D>(q, k, v, rel_h, rel_w, o, lse, BH, N, KH, KW, scale,
                         hs, st);
  if (dtype == kBF16)
    return launch_bf16_mma<D>(q, k, v, rel_h, rel_w, o, lse, BH, N, KH, KW,
                              scale, hs, st);
  return (int)cudaErrorInvalidValue;
}

int launch_d(int dtype, int D, const void* q, const void* k, const void* v,
             const void* rel_h, const void* rel_w, void* o, void* lse, int BH,
             int N, int KH, int KW, float scale, const HeadStrides& hs,
             void* stream) {
  if ((D != 64 && D != 80) || N % kBQ != 0 || KH * KW != N ||
      KH > kMaxRel || KW > kMaxRel)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lsef = static_cast<float*>(lse);
  if (D == 80)
    return launch<80>(dtype, q, k, v, rel_h, rel_w, o, lsef, BH, N, KH, KW,
                      scale, hs, st);
  return launch<64>(dtype, q, k, v, rel_h, rel_w, o, lsef, BH, N, KH, KW,
                    scale, hs, st);
}

}  // namespace
}  // namespace ullsam

// Plain C entry points (loaded with ctypes). Each returns 0 or a
// cudaError_t. dtype: 0 = float32, 1 = bfloat16 for every tensor but lse,
// which is float32. Both require D in {64, 80}, N % 64 == 0, KH * KW == N,
// KH, KW <= 64; rel_h [BH, N, KH], rel_w [BH, N, KW], lse [BH, N].

// B2: q, k, v, o [BH, N, D].
extern "C" int vit_flash_attn_forward(int dtype, const void* q, const void* k,
                                      const void* v, const void* rel_h,
                                      const void* rel_w, void* o, void* lse,
                                      int BH, int N, int D, int KH, int KW,
                                      float scale, void* stream) {
  using namespace ullsam;
  const long long nd = (long long)N * D;
  const HeadStrides hs{1, nd, 0, D, nd, 0, D};
  return launch_d(dtype, D, q, k, v, rel_h, rel_w, o, lse, BH, N, KH, KW,
                  scale, hs, stream);
}

// B14: qkv [B, N, 3C] (q | k | v, head h at h * D of each, C = nh * D),
// o [B, N, C]; bh = b * nh + h.
extern "C" int vit_flash_attn_packed_forward(int dtype, const void* qkv,
                                             const void* rel_h,
                                             const void* rel_w, void* o,
                                             void* lse, int B, int nh, int N,
                                             int D, int KH, int KW,
                                             float scale, void* stream) {
  using namespace ullsam;
  const long long C = (long long)nh * D;
  const HeadStrides hs{nh, N * 3 * C, D, (int)(3 * C), N * C, D, (int)C};
  const size_t eb = dtype == kF32 ? 4 : 2;
  const char* base = static_cast<const char*>(qkv);
  return launch_d(dtype, D, base, base + C * eb, base + 2 * C * eb, rel_h,
                  rel_w, o, lse, B * nh, N, KH, KW, scale, hs, stream);
}
