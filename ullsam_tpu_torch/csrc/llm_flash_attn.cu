// B10: the LLM's causal GQA flash attention with segment ids, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel ullsam_tpu/ops/pallas/flash_attention.py
// `_llm_kernel` (via `llm_flash_attention` / `_llm_flash_impl`). For query
// row i of head h and key j of kv head h / group:
//     o   = softmax(qs k^T over the valid keys) v,   qs = cast(q * D^-1/2)
//     lse = logsumexp of each row (f32, for B11)
// where key j is valid iff q_seg[i] == kv_seg[j] and, when causal, j <= i.
// A row with no valid key gives o = 0 and lse = -1e30 (the TPU kernel's
// NEG_INF). No mask tensor exists: the predicate is evaluated per logit
// from the block's query rows and the key tile's segment ids.
//
// Layouts are the natural ones, no transposes or padding copies: q, o
// [B, S, nh, D]; k, v [B, S, nkv, D]; q_seg, kv_seg [B, S] int32; lse
// [B, nh, S]. S need not be a multiple of the tile: rows and keys past S
// are zero-filled on load and masked by bounds checks, so no real row ever
// sees them (the TPU pads with segment ids -1 / -2 instead).
//
// What bounds it on this card: operations. At the packed-training shape
// (B = 1, S = 2560, nh = 16, nkv = 8, D = 128) the causal half is
// 2 S^2 D nh = 26.8 GFLOP against ~31 MB of bytes. bf16 runs the products
// on the tensor cores (llm_flash_bf16); float32 stays true f32 FMA
// (llm_flash_f32, no TF32), bounded by the 67 TFLOP/s f32 rate.
//
// Design: one block per (b, head, 64-query tile), the tiles with the most
// keys scheduled first; a loop over the 64-key tiles up to the diagonal
// (all of them when not causal) that hold one of the block's segment ids
// (seg_tiles.cuh: on a packed row, the tiles near the block-diagonal),
// with the online-softmax recurrence in f32; GQA by indexing kv head
// h / group, never repeating k / v. bf16: 4 warps of 16 query rows
// (attn_mma.cuh, templated on the head dim), K / V tiles and their segment
// ids double-buffered by cp.async; q is staged in the second K buffer,
// which each warp has read into registers before that buffer is first
// filled. float32: 256 threads through attn_fma.cuh.
//
// Rounding points match _llm_flash_impl: q is pre-scaled and cast to q's
// dtype; p is cast to v's dtype before p.v; the output is acc / l cast to
// q's dtype.
#include "attn_fma.cuh"
#include "attn_mma.cuh"
#include "seg_tiles.cuh"

namespace ullsam {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kBQ = 64, kBK = 64;
constexpr float kEmptyLse = -1e30f;

// row strides (elements) and bases of one (b, head) pair
struct Rows {
  size_t q, kv;  // row strides of q / o and of k / v
  size_t qoff, kvoff, segoff;
};

__device__ __forceinline__ Rows rows_of(int b, int h, int S, int nh,
                                        int nkv, int hd) {
  Rows r;
  r.q = (size_t)nh * hd;
  r.kv = (size_t)nkv * hd;
  r.qoff = (size_t)b * S * r.q + (size_t)h * hd;
  r.kvoff = (size_t)b * S * r.kv + (size_t)(h / (nh / nkv)) * hd;
  r.segoff = (size_t)b * S;
  return r;
}

// ---- float32: FMA on the CUDA cores ---------------------------------------

template <int HD>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * AttnBlockF32<HD>::kSmemFloats +
         sizeof(int) * (kBQ + kBK);
}

// grid (ceil(S / 64), nh, B), 256 threads
template <int HD>
__global__ void __launch_bounds__(256)
    llm_flash_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ qseg,
                  const int* __restrict__ kseg, float* __restrict__ o,
                  float* __restrict__ lse, int S, int nh, int nkv,
                  int causal, float scale) {
  using FB = AttnBlockF32<HD>;
  constexpr int kLdT = FB::kLdT, kLdV = FB::kLdV;
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;                         // [HD][kLdT]  (d-major)
  float* Kt = Qt + HD * kLdT;             // [HD][kLdT]  (d-major)
  float* Vs = Kt + HD * kLdT;             // [kBK][kLdV]
  float* Ps = Vs + kBK * kLdV;            // [kBQ][kLdP]
  int* QSeg = reinterpret_cast<int*>(Ps + kBQ * FB::kLdP);  // [kBQ]
  int* KSeg = QSeg + kBQ;                                   // [kBK]

  const int tid = threadIdx.x;
  const int NT = (S + kBK - 1) / kBK;
  const int qt = NT - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z, q0 = qt * kBQ;
  const Rows R = rows_of(b, h, S, nh, nkv, HD);

  for (int e = tid; e < kBQ * HD; e += 256) {
    const int r = e / HD, d = e % HD;
    Qt[d * kLdT + r] =
        q0 + r < S ? q[R.qoff + (size_t)(q0 + r) * R.q + d] * scale : 0.f;
  }
  if (tid < kBQ) QSeg[tid] = q0 + tid < S ? qseg[R.segoff + q0 + tid] : 0;

  FB fb;
  fb.begin(tid);
  const int nkt = causal ? qt + 1 : NT;
  __shared__ SegTiles tiles;
  seg_own_ids(tiles, qseg + R.segoff, q0, S, tid);
  seg_mark_live(tiles, kseg + R.segoff, 0, nkt, S, tid, 256);
  for (int kt = seg_next_live(tiles, 0, nkt); kt < nkt;
       kt = seg_next_live(tiles, kt + 1, nkt)) {
    const int k0 = kt * kBK;
    __syncthreads();  // previous tile's Kt / Vs / Ps / KSeg are free
    for (int e = tid; e < kBK * HD; e += 256) {
      const int j = e / HD, d = e % HD;
      const bool in = k0 + j < S;
      const size_t gi = R.kvoff + (size_t)(k0 + j) * R.kv + d;
      Kt[d * kLdT + j] = in ? k[gi] : 0.f;
      Vs[j * kLdV + d] = in ? v[gi] : 0.f;
    }
    if (tid < kBK) KSeg[tid] = k0 + tid < S ? kseg[R.segoff + k0 + tid] : 0;
    __syncthreads();
    const auto bias = [&](int r, int key) {
      const bool ok = key < S && KSeg[key - k0] == QSeg[r] &&
                      (!causal || key <= q0 + r);
      return ok ? 0.f : -INFINITY;
    };
    // q was pre-scaled (the reference's rounding point): logits scale 1
    fb.tile(Qt, Kt, Vs, Ps, k0, 1.0f, bias);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + fb.ty * 4 + i;
    if (r >= S) continue;
    const bool live = fb.l[i] > 0.f;
    const float inv = live ? 1.f / fb.l[i] : 0.f;
#pragma unroll
    for (int c = 0; c < FB::kCols; ++c)
      o[R.qoff + (size_t)r * R.q + fb.col0() + c] = fb.acc[i][c] * inv;
    if (fb.tx == 0)
      lse[((size_t)b * nh + h) * S + r] =
          live ? fb.m[i] + logf(fb.l[i]) : kEmptyLse;
  }
}

// ---- bf16: tensor cores (mma.sync m16n8k16, f32 accumulate) -------------

template <int HD>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (size_t)(4 * kBK * AttnWarp<HD>::kLd) +
         sizeof(int) * (2 * kBK);
}

// grid (ceil(S / 64), nh, B), 128 threads: warp w owns query rows
// q0 + 16 w .. + 15
template <int HD>
__global__ void __launch_bounds__(128, HD == 64 ? 3 : 2)
    llm_flash_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ qseg,
                   const int* __restrict__ kseg, bf16* __restrict__ o,
                   float* __restrict__ lse, int S, int nh, int nkv,
                   int causal, float scale) {
  constexpr int kLd = AttnWarp<HD>::kLd;
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smraw[];
  bf16* Ks = reinterpret_cast<bf16*>(smraw);  // [2][64][kLd]
  bf16* Vs = Ks + 2 * kBK * kLd;              // [2][64][kLd]
  bf16* Qs = Ks + kBK * kLd;                  // [64][kLd], K stage 1
  int* KSeg = reinterpret_cast<int*>(Vs + 2 * kBK * kLd);  // [2][64]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int NT = (S + kBK - 1) / kBK;
  const int qt = NT - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z, q0 = qt * kBQ;
  const Rows R = rows_of(b, h, S, nh, nkv, HD);

  auto load_kv = [&](int stage, int k0) {
    for (int c = tid; c < kBK * kChunks; c += 128) {
      const int row = c / kChunks, ch = (c % kChunks) * 8;
      const bool in = k0 + row < S;  // past S: zero-filled, nothing read
      const size_t src = R.kvoff + (size_t)(in ? k0 + row : 0) * R.kv + ch;
      const int dst = (stage * kBK + row) * kLd + ch;
      cp_async16(smem_u32(Ks + dst), k + src, in);
      cp_async16(smem_u32(Vs + dst), v + src, in);
    }
    if (tid < kBK)
      KSeg[stage * kBK + tid] = k0 + tid < S ? kseg[R.segoff + k0 + tid] : 0;
  };
  const int nkt = causal ? qt + 1 : NT;
  __shared__ SegTiles tiles;
  seg_own_ids(tiles, qseg + R.segoff, q0, S, tid);
  seg_mark_live(tiles, kseg + R.segoff, 0, nkt, S, tid, 128);
  int kt = seg_next_live(tiles, 0, nkt);
  if (kt < nkt) load_kv(0, kt * kBK);
  cp_async_commit();

  for (int e = tid; e < kBQ * HD / 2; e += 128) {
    const int r = e / (HD / 2), d = (e % (HD / 2)) * 2;
    float2 f = make_float2(0.f, 0.f);
    if (q0 + r < S)
      f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          q + R.qoff + (size_t)(q0 + r) * R.q + d));
    *reinterpret_cast<__nv_bfloat162*>(Qs + r * kLd + d) =
        __floats2bfloat162_rn(f.x * scale, f.y * scale);
  }
  __syncthreads();

  AttnWarp<HD> aw;
  aw.begin(Qs, warp * 16, lane);
  __syncthreads();  // every warp holds its q: K stage 1 may be refilled
  int row[2], seg[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    row[hf] = q0 + warp * 16 + g + 8 * hf;
    seg[hf] = row[hf] < S ? qseg[R.segoff + row[hf]] : 0;
  }
  for (int i = 0; kt < nkt; ++i) {
    const int next = seg_next_live(tiles, kt + 1, nkt);
    if (next < nkt) {
      load_kv((i + 1) & 1, next * kBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = kt * kBK;
    const int* ks = KSeg + (i & 1) * kBK;
    // keys past S are masked inside chunk (nvalid = S)
    const auto bias = [&](int hf, int key) {
      const bool ok =
          ks[key - k0] == seg[hf] && (!causal || key <= row[hf]);
      return ok ? 0.f : -INFINITY;
    };
    // q was pre-scaled (the reference's rounding point): logits scale 1
    aw.chunk(Ks + (i & 1) * kBK * kLd, Vs + (i & 1) * kBK * kLd, 4, k0, S,
             1.0f, bias, lane);
    __syncthreads();  // this stage is refilled two tiles later
    kt = next;
  }
  cp_async_wait<0>();  // a block with no live tile still drains its group

  float inv[2];
  aw.finish(inv);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row[hf];
    if (r >= S) continue;
    const bool live = aw.l[hf] > 0.f;
    const float iv = live ? inv[hf] : 0.f;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + R.qoff + (size_t)r * R.q +
                                         j * 8 + 2 * t) =
          __floats2bfloat162_rn(aw.acc[j][2 * hf] * iv,
                                aw.acc[j][2 * hf + 1] * iv);
    if (t == 0)
      lse[((size_t)b * nh + h) * S + r] = live ? aw.lse(hf) : kEmptyLse;
  }
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v,
           const int* qseg, const int* kseg, void* o, float* lse, int B,
           int S, int nh, int nkv, int causal, float scale,
           cudaStream_t st) {
  const dim3 grid((S + kBQ - 1) / kBQ, nh, B);
  cudaError_t err;
  if (dtype == kF32) {
    const size_t smem = f32_smem_bytes<HD>();
    err = cudaFuncSetAttribute(llm_flash_f32<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    llm_flash_f32<HD><<<grid, 256, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), qseg, kseg, static_cast<float*>(o), lse,
        S, nh, nkv, causal, scale);
    return (int)cudaGetLastError();
  }
  if (dtype == kBF16) {
    const size_t smem = mma_smem_bytes<HD>();
    err = cudaFuncSetAttribute(llm_flash_bf16<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    llm_flash_bf16<HD><<<grid, 128, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), qseg, kseg, static_cast<bf16*>(o), lse,
        S, nh, nkv, causal, scale);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ullsam

// Plain C entry point (loaded with ctypes). Returns 0 or a cudaError_t.
// dtype: 0 = float32, 1 = bfloat16 for q, k, v and o; q_seg, kv_seg int32;
// lse float32 [B, nh, S]. Requires D in {64, 128}, nh % nkv == 0 and
// S <= 64 * kMaxSegTiles.
extern "C" int llm_flash_attn_forward(int dtype, const void* q, const void* k,
                                      const void* v, const void* q_seg,
                                      const void* kv_seg, void* o, void* lse,
                                      int B, int S, int nh, int nkv, int D,
                                      int causal, float scale, void* stream) {
  using namespace ullsam;
  if (B < 1 || S < 1 || S > kSegTile * kMaxSegTiles || nkv < 1 ||
      nh % nkv != 0 || B > 65535 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* qs = static_cast<const int*>(q_seg);
  const int* ks = static_cast<const int*>(kv_seg);
  float* lsef = static_cast<float*>(lse);
  if (D == 64)
    return launch<64>(dtype, q, k, v, qs, ks, o, lsef, B, S, nh, nkv, causal,
                      scale, st);
  if (D == 128)
    return launch<128>(dtype, q, k, v, qs, ks, o, lsef, B, S, nh, nkv,
                       causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
