// B5's per-prompt image side for Hopper (sm_90a), bf16 at SAM's decoder
// widths (C = 256, Cd = 128, 8 heads of 16, T <= 16 tokens): the part of
// the TwoWayTransformer whose rows are (prompt, image row), B * N of them,
// in two launches of one kernel (decoder_image_stage) with the units and
// pipeline of decoder_sm90.cuh, and the token -> image attention against
// what they write (decoder_t2i_part). Its float32 kind, on decoder_f32.cuh's
// units, follows them (image_stage_f32, decoder_t2i_part_f32, and
// decoder_t2i_f32 for block 1's attention against the shared image).
//
// Replaces the per-prompt image side of the TPU kernels
// ullsam_tpu/ops/pallas/decoder.py `_decode_kernel` (:835, B4) and
// `_twt_kernel` (:637, B5), which keep each prompt's refined image keys in
// VMEM. The token side (B * T rows) stays on decoder_twt.cu's kernels.
//
// Per unit (prompt b, rows n0 .. n0 + 127), everything between the marked
// writes on chip:
//   stage 1  o1 = i2t(qi1[rows], kt1[b], vt1[b])         (rows by TMA)
//            keys1 = LN_norm4(o1 . W_i2t_out0^T + b + src[rows])   [write]
//            k2 | v2 = keys1 . W_img2[:256]^T + res2[rows, :256]   [write]
//            the block-2 token -> image logits of prompt b's queries
//            against the rounded k2: (max, sum exp) per (token, head,
//            64 rows)                                             [write]
//   stage 2  keys1[rows]                                   (rows by TMA)
//            q_img = keys1 . W_img2[256:]^T + res2[rows, 256:]
//            o2 = i2t(q_img, kt2[b], vt2[b])
//            keys2 = LN_norm4'(o2 . W_i2t_out1^T + b + keys1)     [write]
//            kf | vf = keys2 . W_imgf^T + resf[rows]              [write]
//            the final attention's logit partials against kf      [write]
// decoder_t2i_part then forms each query's softmax from the partials (max
// M and sum L over all rows), and sums round(exp(s - M) / L) * v over the
// rows, reading k and v once; the logit s is computed by the same
// t2i_logits (one tensor-core product) from the same rounded keys in both
// places.
//
// The stages write their outputs by TMA from the unit's X tile (per-prompt
// 3-D maps, rows past N clipped) and take the shared residual rows (src,
// res2, resf) by TMA through the weight ring, so no thread waits on device
// memory. Stage 2 reads keys1: recomputing it from qi1 instead (0.54 GB
// less traffic, block 1's i2t, out-projection and LayerNorm again) ran
// about 2x slower on the card, since the CUDA-core work is what holds it.
//
// What bounds it: by the data sheet, bytes. At the AMG chunk (256 prompts,
// N = 4096, T = 7) stage 1 does 0.21 TFLOP and moves 1.09 GB (writes keys1
// and k2 | v2), stage 2 0.28 TFLOP and 1.62 GB (reads keys1, writes keys2
// and kf | vf), each decoder_t2i_part reads 0.55 GB: 130-195 flop a byte,
// under the card's 295 (0.33, 0.48 and 0.16 ms at 3.35 TB/s; the old chain
// moved about 9 GB for the same work). On the card they run at 1.6-2.7x
// those bounds: what holds the stages is the CUDA-core work between the
// products (the attentions' softmax, the LayerNorms, the rounding), with
// two consumer warpgroups an SM to hide its latency, both in the same
// phase since they share each weight k-block. Each unit also reads its
// products' weights again from L2 (192-256 KB) and its residual rows (64-96
// KB).
//
// Rounding points (bf16), as the plain chain: every product once from f32
// with bias and residual added in f32; LayerNorm outputs; attention
// probabilities normalised with the whole row's max and sum, then rounded,
// before p.v; attention outputs.
#include "decoder_f32.cuh"

namespace ullsam {
namespace {

struct StageArgs {
  CUtensorMap rows;   // stage 1: qi1 [N, 128]; stage 2: keys1 [B*N, 256];
                      // boxes [64][64]
  CUtensorMap w_out;  // this stage's i2t out-projection [256, 128]
  CUtensorMap w_kv;   // stage 1: img2 rows 0..255; stage 2: imgf [256, 256]
  CUtensorMap w_q;    // stage 2: img2 rows 256..383 [128, 256]
  // the shared residuals, boxes [128][64]: stage 1 src [N, 256] (of the
  // out-projection) and res2 [N, 384] (of k | v); stage 2 res2 (of q_img,
  // columns 256..383) and resf [N, 256] (of k | v)
  CUtensorMap res_a, res_kv;
  // out: keys1 (stage 1) or keys2 (stage 2), and k | v: [B, N, 256],
  // boxes [64][64] of a prompt
  CUtensorMap keys_out, kv_out;
  const bf16 *b_out, *nw, *nb;  // the out-projection's bias, norm4
  const bf16 *kt, *vt;          // the i2t's tokens [B*T, 128]
  const bf16* qt;     // this stage's token -> image queries [B*T, 128]
  float2* part;       // [B][2U][T*heads] (max, sum exp)
  int B, N, T, U;
  float scale, eps;
};

// The token -> image logits of 16 query rows against 8 keys, one head:
// mma.sync m16n8k16 (exact bf16 products, f32 sums) from q's A fragment and
// the keys' B fragment, then the scale by a multiply never contracted. B5's
// stages (the partials) and decoder_t2i_part (the probabilities) both call
// it on the same rounded values, so both see the same logits.
__device__ __forceinline__ void t2i_logits(float (&s)[4], const uint32_t* qa,
                                           const uint32_t* kb, float scale) {
  s[0] = s[1] = s[2] = s[3] = 0.f;
  mma16816(s, qa, kb);
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] = __fmul_rn(s[e], scale);
}

// i2t in place on a tile's columns 0..127, the warpgroup's rows: each row's
// query against prompt b's T token keys / values kt, vt [16][kPromptLd] (the
// warpgroup's copies in shared memory, zero past T). Warp w takes its 16
// rows, head by head, on the tensor cores (mma.sync m16n8k16): the logits
// [16 rows x 16 tokens], their softmax over the quad (tokens past T
// masked), p rounded, p . v [16 x 16], rounded.
__device__ __forceinline__ void unit_i2t(bf16* tile, const UnitConsumer& c,
                                         const bf16* kt, const bf16* vt, int T,
                                         float scale) {
  const int lane = c.t & 31, mi = lane >> 3;
  const int r0 = c.wg * 64 + c.warp * 16;
  // four heads at a time, each step for all four before the next, so that
  // their products and shuffles overlap
#pragma unroll 1
  for (int h0 = 0; h0 < kUnitHeads; h0 += 4) {
    uint32_t qa[4][4], kb[4][4], vb[4][4], pa[4][4];
    float s[4][2][4] = {}, o[4][2][4] = {};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = h0 + j;
      ldmatrix_x4(qa[j], smem_u32(tile + swz(r0 + (lane & 15),
                                             16 * h + 8 * (lane >> 4))));
      ldmatrix_x4(kb[j], smem_u32(kt + ((mi >> 1) * 8 + (lane & 7)) *
                                           kPromptLd +
                                  16 * h + 8 * (mi & 1)));
      ldmatrix_x4_trans(vb[j], smem_u32(vt + ((mi & 1) * 8 + (lane & 7)) *
                                                 kPromptLd +
                                        16 * h + 8 * (mi >> 1)));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mma16816(s[j][0], qa[j], kb[j]);      // tokens 0..7
      mma16816(s[j][1], qa[j], kb[j] + 2);  // tokens 8..15
    }
    // row g: s[j][n][0..1], row g + 8: [2..3]; token 8n + 2tq + (e & 1)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float m = -CUDART_INF_F;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[j][n][2 * hf + e];
            x = 8 * n + 2 * c.tq + e < T ? x * scale : -CUDART_INF_F;
            m = fmaxf(m, x);
          }
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[j][n][2 * hf + e];
            x = __expf(x - m);
            sum += x;
          }
        const float inv = __fdividef(1.f, quad_sum(sum));
#pragma unroll
        for (int n = 0; n < 2; ++n)
          pa[j][2 * n + hf] =
              pack_bf16(s[j][n][2 * hf] * inv, s[j][n][2 * hf + 1] * inv);
      }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mma16816(o[j][0], pa[j], vb[j]);      // dims 0..7
      mma16816(o[j][1], pa[j], vb[j] + 2);  // dims 8..15
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<uint32_t*>(
              tile + swz(r0 + c.g + 8 * hf, 16 * (h0 + j) + 8 * n +
                                                2 * c.tq)) =
              pack_bf16(o[j][n][2 * hf], o[j][n][2 * hf + 1]);
  }
}

// The token -> image logit partials of the warpgroup's 64 rows (the first
// nvalid of them real): prompt b's queries q [16][kPromptLd] (shared memory,
// zero past T) against the keys in the tile's columns 0..127. Warp w takes
// heads 2w and 2w + 1: per head the logits [16 tokens x 64 keys] by
// t2i_logits (keys past nvalid masked), each token's max and sum of exps
// over the quad: (max, sum exp) to part[token * 8 + head].
__device__ __forceinline__ void unit_t2i_partials(const bf16* tile,
                                                  const UnitConsumer& c,
                                                  const bf16* q, int T,
                                                  int nvalid, float scale,
                                                  float2* part) {
  const int lane = c.t & 31, mi = lane >> 3;
#pragma unroll 2
  for (int hh = 0; hh < 2; ++hh) {
    const int h = 2 * c.warp + hh;
    uint32_t qa[4];
    ldmatrix_x4(qa, smem_u32(q + (lane & 15) * kPromptLd + 16 * h +
                             8 * (lane >> 4)));
    float s[8][4];  // keys 8n + 2tq + (e & 1): row g s[n][0..1], g + 8 [2..3]
#pragma unroll
    for (int k16 = 0; k16 < 4; ++k16) {
      uint32_t kb[4];
      ldmatrix_x4(kb, smem_u32(tile + swz(c.wg * 64 + 16 * k16 +
                                              (mi >> 1) * 8 + (lane & 7),
                                          16 * h + 8 * (mi & 1))));
      t2i_logits(s[2 * k16], qa, kb, scale);
      t2i_logits(s[2 * k16 + 1], qa, kb + 2, scale);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float m = -CUDART_INF_F, l = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * hf + e];
          if (8 * n + 2 * c.tq + e >= nvalid) x = -CUDART_INF_F;
          m = fmaxf(m, x);
        }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (m != -CUDART_INF_F) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) l += expf(s[n][2 * hf + e] - m);
      }
      l = quad_sum(l);
      const int tt = c.g + 8 * hf;
      if (c.tq == 0 && tt < T) part[tt * kUnitHeads + h] = make_float2(m, l);
    }
  }
}

// keys1 of the warpgroup's rows into X: i2t of qi1 (in X's columns 0..127)
// against prompt b's block-1 tokens, its out-projection with src as the
// residual, LayerNorm norm4
__device__ __forceinline__ void stage_keys1(const StageArgs& a,
                                            UnitConsumer& c) {
  const UnitSmem& sm = c.sm;
  unit_i2t(sm.x, c, c.prompt(0), c.prompt(1), a.T, a.scale);
  const int r0 = c.row(0), r1 = c.row(1);
  float acc[128];
  c.residual<32>(acc);  // src
  acc_add_bias<32>(acc, a.b_out, c.tq);
  c.publish();
  c.gemm<256>(acc, sm.x, 2, true);
  acc_round<32>(acc);
  acc_layer_norm(acc, a.nw, a.nb, a.eps, c.tq);
  acc_store_tile<32>(sm.x, acc, r0, r1, c.tq);
}

// keys2 of the warpgroup's rows into X (keys1 there): q_img into Q, i2t in
// place against prompt b's block-2 tokens, the out-projection with keys1
// as the residual, LayerNorm norm4
__device__ __forceinline__ void stage_keys2(const StageArgs& a,
                                            UnitConsumer& c) {
  const UnitSmem& sm = c.sm;
  const int r0 = c.row(0), r1 = c.row(1);
  float acc[128];
  c.residual<16>(acc);  // res2's q_img columns
  c.gemm<128>(acc, sm.x, 4, true);
  acc_store_tile<16>(sm.q, acc, r0, r1, c.tq);
  c.sync();
  unit_i2t(sm.q, c, c.prompt(0), c.prompt(1), a.T, a.scale);
  acc_init_tile<32>(acc, sm.x, r0, r1, c.tq);
  acc_add_bias<32>(acc, a.b_out, c.tq);
  c.publish();
  c.gemm<256>(acc, sm.q, 2, true);
  acc_round<32>(acc);
  acc_layer_norm(acc, a.nw, a.nb, a.eps, c.tq);
  acc_store_tile<32>(sm.x, acc, r0, r1, c.tq);
}

// X (k | v, just written) to a.kv, and the logit partials of its k against
// the queries a.qt
__device__ __forceinline__ void stage_kv_out(const StageArgs& a,
                                             const UnitConsumer& c, int b,
                                             int tile, int nvalid) {
  c.store_rows(&a.kv_out, b, tile * kUnitRows);
  const int P = a.T * kUnitHeads;
  unit_t2i_partials(c.sm.x, c, c.prompt(2), a.T, nvalid,
                    a.scale,
                    a.part + ((size_t)b * 2 * a.U + 2 * tile + c.wg) * P);
}

template <int kStage>
__global__ void __launch_bounds__(kUnitThreads, 1)
    image_stage(const __grid_constant__ StageArgs a) {
  extern __shared__ unsigned char smraw[];
  const UnitSmem sm(smraw);
  const int tid = threadIdx.x;
  if (tid == 0) sm.init();
  __syncthreads();
  const int units = a.B * a.U;

  if (tid >= 256) {  // the producer warpgroup: one thread issues
    producer_registers();
    if (tid == 256) {
      UnitProducer p(sm);
      int k = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
        const int tile = u / a.B, b = u % a.B, n0 = tile * kUnitRows;
        // stage 1 reads qi1 (K = 128, shared), stage 2 keys1 (K = 256)
        for (int w = 0; w < 2; ++w)
          p.rows(sm.x, &a.rows, kStage == 1 ? 2 : 4,
                 (kStage == 1 ? 0 : b * a.N) + n0 + 64 * w, w, k);
        // in the order the consumers take them: residuals and weights
        if (kStage == 1) {
          p.residual(&a.res_a, 0, n0);
          p.residual(&a.res_a, 128, n0);
        } else {
          p.residual(&a.res_a, 2 * kUnitCd, n0);
          for (int kb = 0; kb < 4; ++kb) p.weights(&a.w_q, kb, kUnitCd);
        }
        p.weights(&a.w_out, 0, kUnitC);
        p.weights(&a.w_out, 1, kUnitC);
        p.residual(&a.res_kv, 0, n0);
        p.residual(&a.res_kv, 128, n0);
        for (int kb = 0; kb < 4; ++kb) p.weights(&a.w_kv, kb, kUnitC);
      }
    }
    return;
  }

  consumer_registers();
  UnitConsumer c(sm, tid);
  int k = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
    const int tile = u / a.B, b = u % a.B, n0 = tile * kUnitRows;
    const int nvalid = min(64, max(0, a.N - n0 - 64 * c.wg));
    const int r0 = c.row(0), r1 = c.row(1);
    // the prompt's token rows: the i2t's keys and values, the partials'
    // queries
    const size_t tb = (size_t)b * a.T * kUnitCd;
    c.load_prompt(0, a.kt + tb, a.T);
    c.load_prompt(1, a.vt + tb, a.T);
    c.load_prompt(2, a.qt + tb, a.T);
    c.wait_rows(k);
    c.sync();
    if (kStage == 1)
      stage_keys1(a, c);
    else
      stage_keys2(a, c);
    c.store_rows(&a.keys_out, b, n0);
    // k | v of this stage's attention: X . W_kv^T + res[rows, :256]
    float acc[128];
    c.residual<32>(acc);
    c.gemm<256>(acc, sm.x, 4, true);
    c.store_wait();
    acc_store_tile<32>(sm.x, acc, r0, r1, c.tq);
    stage_kv_out(a, c, b, tile, nvalid);
    c.release_rows();
  }
}

// ---- decoder_t2i_part: the token -> image attention from the partials ---

constexpr int kT2iRows = 512;  // image rows (keys) a block

// Block (prompt b, keys tile * 512 ..): warp w takes heads 2w and 2w + 1.
// Each lane forms M and L of its (token, head) pairs from the 2U partials
// (a quarter of the slots a lane, then over the quad). Then 16 keys at a
// time: their k | v rows of the warp's heads into the warp's shared memory,
// the logits by t2i_logits, p = round(exp(s - M) / L) (keys past N: 0),
// p . v on the tensor cores; the tile's sums [16 tokens][16] of each head
// to acc [B][tiles][T * 8][16].
__global__ void __launch_bounds__(128)
    t2i_part_pv(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                const float2* __restrict__ part, float* __restrict__ acc,
                int N, int T, int S, float scale) {
  __shared__ __align__(16) bf16 kvs[4][2][16][40];  // [warp][k|v][key][32+8]
  const int b = blockIdx.x, tile = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int mi = lane >> 3, P = T * kUnitHeads;
  float M[2][2], L[2][2];
  uint32_t qa[2][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int h = 2 * warp + hh;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int tt = g + 8 * hf;
      const float2* pp = part + (size_t)b * S * P + tt * kUnitHeads + h;
      float m = -CUDART_INF_F, l = 0.f;
      if (tt < T) {
        for (int s = tq; s < S; s += 4) m = fmaxf(m, pp[(size_t)s * P].x);
      }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (tt < T) {
        for (int s = tq; s < S; s += 4) {
          const float2 e = pp[(size_t)s * P];
          if (e.x != -CUDART_INF_F) l += e.y * expf(e.x - m);
        }
      }
      M[hh][hf] = m;
      L[hh][hf] = quad_sum(l);
    }
    // q's A fragment: rows = tokens (zero past T), 16 dims of head h
    const bf16* qb = q + (size_t)b * T * kUnitCd + 16 * h + 2 * tq;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int tt = g + 8 * (r & 1);
      qa[hh][r] = tt < T ? *reinterpret_cast<const uint32_t*>(
                               qb + (size_t)tt * kUnitCd + 8 * (r >> 1))
                         : 0u;
    }
  }
  float o[2][2][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[hh][n][e] = 0.f;
  const bf16* kb0 = kv + (size_t)b * N * kUnitC + 32 * warp;
  const int j1 = min(N, (tile + 1) * kT2iRows);
  for (int j0 = tile * kT2iRows; j0 < j1; j0 += 16) {
    // 16 keys x (k, v) x 32 columns: 128 chunks of 16 bytes, 4 a lane
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = lane + 32 * r, key = e >> 3, w = (e >> 2) & 1,
                ch = e & 3;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (j0 + key < j1)
        val = __ldg(reinterpret_cast<const uint4*>(
            kb0 + (size_t)(j0 + key) * kUnitC + w * kUnitCd + 8 * ch));
      *reinterpret_cast<uint4*>(&kvs[warp][w][key][8 * ch]) = val;
    }
    __syncwarp();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      uint32_t kb[4], vb[4], pa[4];
      ldmatrix_x4(kb, smem_u32(&kvs[warp][0][(mi >> 1) * 8 + (lane & 7)]
                                    [16 * hh + 8 * (mi & 1)]));
      ldmatrix_x4_trans(vb, smem_u32(&kvs[warp][1][(mi & 1) * 8 + (lane & 7)]
                                         [16 * hh + 8 * (mi >> 1)]));
      float s[2][4];
      t2i_logits(s[0], qa[hh], kb, scale);
      t2i_logits(s[1], qa[hh], kb + 2, scale);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            p[e] = g + 8 * hf < T && j0 + 8 * n + 2 * tq + e < j1
                       ? expf(s[n][2 * hf + e] - M[hh][hf]) / L[hh][hf]
                       : 0.f;
          pa[2 * n + hf] = pack_bf16(p[0], p[1]);  // rounds p
        }
      mma16816(o[hh][0], pa, vb);
      mma16816(o[hh][1], pa, vb + 2);
    }
    __syncwarp();
  }
  const int tiles = gridDim.y;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int tt = g + 8 * hf;
      if (tt >= T) continue;
      float* out = acc + (((size_t)b * tiles + tile) * P + tt * kUnitHeads +
                          2 * warp + hh) * 16;
#pragma unroll
      for (int n = 0; n < 2; ++n)
        *reinterpret_cast<float2*>(out + 8 * n + 2 * tq) =
            make_float2(o[hh][n][2 * hf], o[hh][n][2 * hf + 1]);
    }
}

// o [B*T, 128] bf16: the sum of each pair's tiles, rounded
__global__ void __launch_bounds__(128)
    t2i_part_sum(const float* __restrict__ acc, int slots, int T,
                 bf16* __restrict__ o) {
  const int b = blockIdx.x, pair = threadIdx.x, P = T * kUnitHeads;
  if (pair >= P) return;
  float s[16];
#pragma unroll
  for (int d = 0; d < 16; ++d) s[d] = 0.f;
  for (int k = 0; k < slots; ++k) {
    const float* a = acc + (((size_t)b * slots + k) * P + pair) * 16;
#pragma unroll
    for (int d = 0; d < 16; ++d) s[d] += a[d];
  }
  const int tt = pair / kUnitHeads, h = pair % kUnitHeads;
  bf16* orow = o + ((size_t)b * T + tt) * kUnitCd + 16 * h;
#pragma unroll
  for (int d = 0; d < 16; ++d) orow[d] = __float2bfloat16(s[d]);
}

inline bool map_rows(CUtensorMap* m, const void* p, int rows, int K,
                     int box_rows) {
  return p != nullptr && make_map(m, p, rows, K, box_rows);
}

// the map of a per-prompt [B, N, 256] bf16 tensor in boxes of [64 rows][64]
// of one prompt (128-byte swizzle, X's layout): a box's rows past N are
// not written
inline bool map_prompt_rows(CUtensorMap* m, const void* p, int B, int N) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn || !p) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)kUnitC, (cuuint64_t)N,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)kUnitC * 2,
                                 (cuuint64_t)N * kUnitC * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kStage>
int stage_launch(const StageArgs& a, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      image_stage<kStage>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kUnitSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const int units = a.B * a.U;
  const int grid = units < sm_count() ? units : sm_count();
  image_stage<kStage><<<grid, kUnitThreads, kUnitSmemBytes, st>>>(a);
  return (int)cudaGetLastError();
}

// work units a prompt of N image rows (two logit partial slots a unit)
inline int image_units(int N) { return (N + kUnitRows - 1) / kUnitRows; }


// ---- float32 at SAM's widths: the same stages on decoder_f32.cuh's units
// (prompt b, 64 rows), products in split TF32 on wgmma ---------------------
//
// Per unit, as the bf16 stages (the notes above), everything between the
// marked writes on chip:
//   stage 1  o1 = i2t(qi1[rows], kt1[b], vt1[b])  (rows by TMA into Q)
//            keys1 = LN_norm4(o1 . W_i2t_out0^T + b + src[rows])   [write]
//            k2 | v2 = keys1 . W_img2[:256]^T + res2[rows, :256]   [write]
//            the partials of block 2's queries against k2 | v2    [write]
//   stage 2  keys1[rows]                                   (rows by TMA)
//            q_img = keys1 . W_img2[256:]^T + res2[rows, 256:]   (into Q)
//            o2 = i2t(q_img, kt2[b], vt2[b])                     (in Q)
//            keys2 = LN_norm4'(o2 . W_i2t_out1^T + b + keys1)     [write]
//            kf | vf = keys2 . W_imgf^T + resf[rows]              [write]
//            the final attention's partials against kf | vf       [write]
// The shared residual rows (src, res2, resf: 14 MB at N = 4096, read by
// every prompt, so from L2) are loaded by the consumers into their
// accumulators, while the product's first k-block lands. The attentions
// run on the CUDA cores in f32: i2t is each image row against <= 16 tokens
// at head dim 16. The token -> image attention is split as flash decoding
// splits a long softmax: each unit's partial of each (token, head) is its
// 64 logits' max m, sum l of exp(s - m) and sum o of exp(s - m) v, from the
// k | v it holds on chip; decoder_t2i_part_f32 combines a prompt's
// partials, o = sum_u o_u e^(m_u - M) / sum_u l_u e^(m_u - M). In bf16
// each probability is rounded once normalised, which needs the whole
// row's max and sum first (a second pass over k | v); in f32 nothing
// rounds p, and the two orders differ only by f32 rounding, so no pass
// re-reads the 1.07 GB of k | v (the two-pass f32 version took 1.1 ms a
// pass at the AMG chunk).
//
// What bounds it: by the data sheet, operations (split TF32 at 495 / 3
// TFLOP/s). At the AMG chunk stage 1 does 0.21 TFLOP of products, stage 2
// 0.28, against 2.2 and 3.2 GB of f32 traffic (1.25 and 1.67 ms against
// 0.64 and 0.96 ms). Each unit also reads its products' weights from L2 in
// both planes: 768 KB (stage 1) and 1 MB (stage 2) a 64-row unit. On the
// card (H100 80GB HBM3, 700 W) stage 1 takes 3.6 ms and stage 2 4.7 (60
// TFLOP/s; decoder_f32.cuh says what holds them), decoder_t2i_part_f32
// 0.06 and decoder_t2i_f32 0.63 (its logits and p . v on the CUDA cores).

struct StageF32Args {
  CUtensorMap rows;  // stage 1: qi1 [N, 128]; stage 2: keys1 [B*N, 256];
                     // boxes [64][32] f32
  CUtensorMap wo_hi, wo_lo;    // the i2t out-projection [256, 128]'s planes
  CUtensorMap wkv_hi, wkv_lo;  // stage 1: img2 rows 0..255; stage 2: imgf
  CUtensorMap wq_hi, wq_lo;    // stage 2: img2 rows 256..383 [128, 256]
  CUtensorMap keys_out, kv_out;  // [B, N, 256] f32, boxes [64][32]
  const float* res_a;   // stage 1: src [N, 256]; stage 2: res2 [N, 384]
  const float* res_kv;  // stage 1: res2 [N, 384]; stage 2: resf [N, 256]
  int ld_a, ld_kv;      // their row strides
  const float *b_out, *nw, *nb;  // the out-projection's bias, norm4
  const float *kt, *vt;          // the i2t's tokens [B*T, 128]
  const float* qt;  // this stage's token -> image queries [B*T, 128]
  float2* ml;       // [B][U][T*heads] (max, sum exp) a unit
  float* po;        // [B][U][T*heads][16] sum exp(s - max) v a unit
  int B, N, T, U;
  float scale, eps;
};

// the logit of query q against key k (16 values each) at head dim 16: one
// FMA chain in a fixed order, then the scale
__device__ __forceinline__ float t2i_logit_f32(const float (&q)[16],
                                               const float (&k)[16],
                                               float scale) {
  float a = 0.f;
#pragma unroll
  for (int d = 0; d < 16; ++d) a = fmaf(q[d], k[d], a);
  return __fmul_rn(a, scale);
}

// 16 values of a tile's row from column c (a multiple of 16)
__device__ __forceinline__ void tile_head(const float* tile, int row, int c,
                                          float (&x)[16]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float4 v =
        *reinterpret_cast<const float4*>(tile + fswz(row, c + 4 * e));
    x[4 * e] = v.x;
    x[4 * e + 1] = v.y;
    x[4 * e + 2] = v.z;
    x[4 * e + 3] = v.w;
  }
}

// i2t in place on a tile's columns 0..127: each (row, head) query against
// the prompt's T token keys / values kt, vt [16][kF32PromptLd] on the CUDA
// cores in f32. Thread t takes the pairs t and t + 256 (head p / 64, row p
// % 64): a warp's lanes share the head, so the token rows are broadcast.
__device__ __forceinline__ void f32_i2t(float* tile, const F32Consumer& c,
                                        const float* kt, const float* vt,
                                        int T, float scale) {
#pragma unroll 1
  for (int j = 0; j < 2; ++j) {
    const int p = c.t + 256 * j, h = p >> 6, r = p & 63;
    float q[16], s[kUnitMaxTok], o[16];
    tile_head(tile, r, 16 * h, q);
    float m = -CUDART_INF_F;
#pragma unroll
    for (int tt = 0; tt < kUnitMaxTok; ++tt) {
      s[tt] = -CUDART_INF_F;
      if (tt < T) {
        float k[16];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 v = *reinterpret_cast<const float4*>(
              kt + tt * kF32PromptLd + 16 * h + 4 * e);
          k[4 * e] = v.x;
          k[4 * e + 1] = v.y;
          k[4 * e + 2] = v.z;
          k[4 * e + 3] = v.w;
        }
        s[tt] = t2i_logit_f32(q, k, scale);
        m = fmaxf(m, s[tt]);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int tt = 0; tt < kUnitMaxTok; ++tt)
      if (tt < T) {
        s[tt] = expf(s[tt] - m);
        sum += s[tt];
      }
#pragma unroll
    for (int d = 0; d < 16; ++d) o[d] = 0.f;
#pragma unroll
    for (int tt = 0; tt < kUnitMaxTok; ++tt)
      if (tt < T) {
        const float pt = s[tt] / sum;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 v = *reinterpret_cast<const float4*>(
              vt + tt * kF32PromptLd + 16 * h + 4 * e);
          o[4 * e] = fmaf(pt, v.x, o[4 * e]);
          o[4 * e + 1] = fmaf(pt, v.y, o[4 * e + 1]);
          o[4 * e + 2] = fmaf(pt, v.z, o[4 * e + 2]);
          o[4 * e + 3] = fmaf(pt, v.w, o[4 * e + 3]);
        }
      }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<float4*>(tile + fswz(r, 16 * h + 4 * e)) =
          make_float4(o[4 * e], o[4 * e + 1], o[4 * e + 2], o[4 * e + 3]);
  }
}

// The token -> image partials of the unit's 64 keys and values (the
// tile's columns 0..127 and 128..255, the first nvalid rows real) against
// the prompt's queries q [16][kF32PromptLd]: warp w takes head w, its lanes
// G groups of 32 / G tokens (G = 4 for T <= 8, else 2), group g's lanes
// the keys 64 g / G .. (m, l, o as above); the groups are merged over
// shuffles into ml[token * 8 + head] and po[(token * 8 + head) * 16 ..].
template <int G>
__device__ __forceinline__ void f32_t2i_partials(const float* tile,
                                                 const F32Consumer& c,
                                                 const float* q, int T,
                                                 int nvalid, float scale,
                                                 float2* ml, float* po) {
  constexpr int kTl = 32 / G, kKeys = 64 / G;  // token lanes, keys a lane
  const int lane = c.t & 31, h = c.t >> 5, tt = lane % kTl, g = lane / kTl;
  const int nv = min(kKeys, nvalid - kKeys * g);  // this group's real keys
  float qv[16], s[kKeys], o[16];
#pragma unroll
  for (int d = 0; d < 16; ++d) qv[d] = q[tt * kF32PromptLd + 16 * h + d];
  float m = -CUDART_INF_F, l = 0.f;
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    float k[16];
    tile_head(tile, kKeys * g + j, 16 * h, k);
    s[j] = j < nv ? t2i_logit_f32(qv, k, scale) : -CUDART_INF_F;
    m = fmaxf(m, s[j]);
  }
#pragma unroll
  for (int d = 0; d < 16; ++d) o[d] = 0.f;
#pragma unroll
  for (int j = 0; j < kKeys; ++j)
    if (j < nv) {
      float v[16];
      tile_head(tile, kKeys * g + j, kUnitCd + 16 * h, v);
      const float p = expf(s[j] - m);
      l += p;
#pragma unroll
      for (int d = 0; d < 16; ++d) o[d] = fmaf(p, v[d], o[d]);
    }
#pragma unroll
  for (int off = kTl; off < 32; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float M = fmaxf(m, mo);
    const float a = m == -CUDART_INF_F ? 0.f : expf(m - M);
    const float bo = mo == -CUDART_INF_F ? 0.f : expf(mo - M);
#pragma unroll
    for (int d = 0; d < 16; ++d)
      o[d] = o[d] * a + __shfl_xor_sync(0xffffffffu, o[d], off) * bo;
    l = l * a + lo * bo;
    m = M;
  }
  if (g == 0 && tt < T) {
    const int pair = tt * kUnitHeads + h;
    ml[pair] = make_float2(m, l);
    float4* out = reinterpret_cast<float4*>(po + pair * 16);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[e] = make_float4(o[4 * e], o[4 * e + 1], o[4 * e + 2], o[4 * e + 3]);
  }
}

// keys1 of the unit into X: i2t of qi1 (in Q, where the producer put it)
// against the prompt's block-1 tokens, its out-projection with src as the
// residual, LayerNorm norm4. Q is released once the product has read it:
// the next unit's qi1 lands there while this unit's epilogues run.
__device__ __forceinline__ void f32_stage_keys1(const StageF32Args& a,
                                                F32Consumer& c, int n0,
                                                int nvalid) {
  const F32Smem& sm = c.sm;
  const int c0 = 128 * c.wg;
  f32_i2t(sm.q, c, c.prompt(0), c.prompt(1), a.T, a.scale);
  fence_proxy_async();  // Q's next rows come by TMA
  c.sync();
  float acc[64];
  f32_acc_load<16>(acc, a.res_a + (size_t)n0 * a.ld_a + c0, a.ld_a, nvalid,
                   c);
  f32_acc_bias<16>(acc, a.b_out + c0, c.tq);
  c.gemm<16>(acc, sm.q, kUnitCd / kF32WK, kUnitC, c0);
  if (c.chief) mbar_arrive(sm.xempty);
  f32_layer_norm(acc, a.nw + c0, a.nb + c0, a.eps, c);
  f32_acc_store<16>(sm.x, acc, c0, c);
}

// keys2 of the unit into X (keys1 there): q_img into Q, i2t in place
// against the prompt's block-2 tokens, the out-projection with keys1 as the
// residual, LayerNorm norm4
__device__ __forceinline__ void f32_stage_keys2(const StageF32Args& a,
                                                F32Consumer& c, int n0,
                                                int nvalid) {
  const F32Smem& sm = c.sm;
  {
    const int cq = 64 * c.wg;  // q_img: 128 columns, 64 a warpgroup
    float q[32];
    f32_acc_load<8>(q, a.res_a + (size_t)n0 * a.ld_a + 2 * kUnitCd + cq,
                    a.ld_a, nvalid, c);
    c.gemm<8>(q, sm.x, kUnitC / kF32WK, kUnitCd, cq);
    f32_acc_store<8>(sm.q, q, cq, c);
  }
  c.sync();
  f32_i2t(sm.q, c, c.prompt(0), c.prompt(1), a.T, a.scale);
  c.sync();
  const int c0 = 128 * c.wg;
  float acc[64];
  f32_acc_from_tile<16>(acc, sm.x, c0, c);
  f32_acc_bias<16>(acc, a.b_out + c0, c.tq);
  c.gemm<16>(acc, sm.q, kUnitCd / kF32WK, kUnitC, c0);
  f32_layer_norm(acc, a.nw + c0, a.nb + c0, a.eps, c);
  f32_acc_store<16>(sm.x, acc, c0, c);
}

template <int kStage>
__global__ void __launch_bounds__(kUnitThreads, 1)
    image_stage_f32(const __grid_constant__ StageF32Args a) {
  extern __shared__ unsigned char smraw[];
  const F32Smem sm(smraw);
  const int tid = threadIdx.x;
  if (tid == 0) sm.init();
  __syncthreads();
  const int units = a.B * a.U;

  if (tid >= 256) {  // the producer warpgroup: one thread issues
    producer_registers();
    if (tid == 256) {
      F32Producer p(sm);
      int k = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
        const int tile = u / a.B, b = u % a.B, n0 = tile * kF32Rows;
        // stage 1 reads qi1 (K = 128, shared) into Q, stage 2 keys1 (K =
        // 256) into X
        if (kStage == 1)
          p.rows(sm.q, &a.rows, 4, n0, k);
        else
          p.rows(sm.x, &a.rows, 8, b * a.N + n0, k);
        if (kStage == 2)
          for (int kb = 0; kb < kUnitC / kF32WK; ++kb)
            p.weights(&a.wq_hi, &a.wq_lo, kb, kUnitCd);
        for (int kb = 0; kb < kUnitCd / kF32WK; ++kb)
          p.weights(&a.wo_hi, &a.wo_lo, kb, kUnitC);
        for (int kb = 0; kb < kUnitC / kF32WK; ++kb)
          p.weights(&a.wkv_hi, &a.wkv_lo, kb, kUnitC);
      }
    }
    return;
  }

  consumer_registers();
  F32Consumer c(sm, tid);
  const int c0 = 128 * c.wg;
  // the prompt's token rows (the i2t's keys and values, the partials'
  // queries), each unit's fetched while the unit before it ends
  const auto fetch_prompt = [&](int u) {
    if (u >= units) return;
    const size_t tb = (size_t)(u % a.B) * a.T * kUnitCd;
    c.load_prompt(0, a.kt + tb, a.T);
    c.load_prompt(1, a.vt + tb, a.T);
    c.load_prompt(2, a.qt + tb, a.T);
  };
  fetch_prompt(blockIdx.x);
  int k = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
    const int tile = u / a.B, b = u % a.B, n0 = tile * kF32Rows;
    const int nvalid = min(kF32Rows, a.N - n0);
    c.wait_prompt();
    c.wait_rows(k);
    c.sync();
    if (kStage == 1)
      f32_stage_keys1(a, c, n0, nvalid);
    else
      f32_stage_keys2(a, c, n0, nvalid);
    c.store_rows(&a.keys_out, b, n0);
    // k | v of this stage's attention: X . W_kv^T + res[rows, :256]
    float acc[64];
    f32_acc_load<16>(acc, a.res_kv + (size_t)n0 * a.ld_kv + c0, a.ld_kv,
                     nvalid, c);
    c.gemm<16>(acc, sm.x, kUnitC / kF32WK, kUnitC, c0);
    c.store_wait();
    f32_acc_store<16>(sm.x, acc, c0, c);
    c.store_rows(&a.kv_out, b, n0);
    const size_t slot = ((size_t)b * a.U + tile) * a.T * kUnitHeads;
    if (a.T <= kUnitMaxTok / 2)
      f32_t2i_partials<4>(sm.x, c, c.prompt(2), a.T, nvalid, a.scale,
                          a.ml + slot, a.po + slot * 16);
    else
      f32_t2i_partials<2>(sm.x, c, c.prompt(2), a.T, nvalid, a.scale,
                          a.ml + slot, a.po + slot * 16);
    // X free once its stores have read it (stage 2: the next unit's keys1
    // lands there; stage 1 released Q, its input, after the out-projection)
    if (kStage == 1)
      c.store_wait();
    else
      c.release_rows();
    fetch_prompt(u + gridDim.x);
  }
}

// o [B*T, 128] f32 from U partials a (token, head) pair, ml [B][U][P]
// (max, sum exp) and po [B][U][P][16]: M = max m_u, o = sum_u po_u e^(m_u -
// M) / sum_u l_u e^(m_u - M), the partials in order. Block b, thread pair.
__global__ void __launch_bounds__(128)
    t2i_combine_f32(const float2* __restrict__ ml,
                    const float* __restrict__ po, int U, int T,
                    float* __restrict__ o) {
  const int b = blockIdx.x, pair = threadIdx.x, P = T * kUnitHeads;
  if (pair >= P) return;
  const float2* mp = ml + (size_t)b * U * P + pair;
  float M = -CUDART_INF_F, L = 0.f, acc[16];
  for (int u = 0; u < U; ++u) M = fmaxf(M, mp[(size_t)u * P].x);
#pragma unroll
  for (int d = 0; d < 16; ++d) acc[d] = 0.f;
  for (int u = 0; u < U; ++u) {
    const float2 e = mp[(size_t)u * P];
    if (e.x == -CUDART_INF_F) continue;
    const float w = expf(e.x - M);
    L = fmaf(e.y, w, L);
    const float4* pu = reinterpret_cast<const float4*>(
        po + (((size_t)b * U + u) * P + pair) * 16);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 x = __ldg(pu + q);
      acc[4 * q] = fmaf(x.x, w, acc[4 * q]);
      acc[4 * q + 1] = fmaf(x.y, w, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(x.z, w, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(x.w, w, acc[4 * q + 3]);
    }
  }
  const int tt = pair / kUnitHeads, h = pair % kUnitHeads;
  float* orow = o + ((size_t)b * T + tt) * kUnitCd + 16 * h;
#pragma unroll
  for (int d = 0; d < 16; ++d) orow[d] = acc[d] / L;
}

// The partials of block 1's token -> image attention against the shared
// image's k1, v1 (or any k, v rows of ld floats at b * bstride):
// block (prompt b, keys tile * 512 ..), 256 threads, thread t = g P + pair
// (key group g < nq, nq P <= 256). 32 keys at a time: their k and v rows
// into shared memory (every thread; the next 32 fetched into registers
// while these are used; a head's 16-byte pieces 8 apart, so that a warp's
// 8 heads read 128 contiguous bytes), its group's keys g, g + nq, ..: the
// logits by t2i_logit_f32, the running (m, l, o) rescaled once a chunk;
// the groups merged in order through shared memory into the tile's
// partial (ml, po as the stages' [B][tiles][P]).
__global__ void __launch_bounds__(256)
    t2i_flash_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, int ld, long long bstride,
                  float2* __restrict__ ml, float* __restrict__ po, int N,
                  int T, int nq, float scale) {
  __shared__ float4 kvs[32][kUnitC / 4];
  const int b = blockIdx.x, tile = blockIdx.y, tid = threadIdx.x;
  const int P = T * kUnitHeads, grp = tid / P, pair = tid - grp * P;
  const int tt = pair >> 3, h = pair & 7;
  const bool active = grp < nq;
  float qv[16], o[16], m = -CUDART_INF_F, l = 0.f;
#pragma unroll
  for (int d = 0; d < 16; ++d) {
    qv[d] = active ? q[((size_t)b * T + tt) * kUnitCd + 16 * h + d] : 0.f;
    o[d] = 0.f;
  }
  const int j1 = min(N, (tile + 1) * kT2iRows);
  const float* kb0 = k + b * bstride;
  const float* vb0 = v + b * bstride;
  // this thread's 8 of a chunk's 2048 16-byte pieces: key e >> 6, piece c
  // = e & 63 (k's 32, then v's), stored at (c & 32) + 8 (c & 3) + head
  float4 nxt[8];
  const auto fetch = [&](int j0) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int e = tid + 256 * r, key = e >> 6, c = e & 63;
      nxt[r] = j0 + key < j1
                   ? __ldg(reinterpret_cast<const float4*>(
                         (c < 32 ? kb0 : vb0) + (size_t)(j0 + key) * ld +
                         4 * (c & 31)))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  fetch(tile * kT2iRows);
  for (int j0 = tile * kT2iRows; j0 < j1; j0 += 32) {
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int e = tid + 256 * r, c = e & 63;
      kvs[e >> 6][(c & 32) + 8 * (c & 3) + ((c & 31) >> 2)] = nxt[r];
    }
    __syncthreads();
    if (j0 + 32 < j1) fetch(j0 + 32);
    if (!active) continue;
    const int nk = min(32, j1 - j0);
    float s[16], cm = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int key = grp + nq * i;
      s[i] = -CUDART_INF_F;
      if (key < nk) {
        float kk[16];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 x = kvs[key][8 * e + h];
          kk[4 * e] = x.x, kk[4 * e + 1] = x.y, kk[4 * e + 2] = x.z,
          kk[4 * e + 3] = x.w;
        }
        s[i] = t2i_logit_f32(qv, kk, scale);
        cm = fmaxf(cm, s[i]);
      }
    }
    if (cm > m) {  // rescale the running sums to the new max
      const float a = expf(m - cm);
      l *= a;
#pragma unroll
      for (int d = 0; d < 16; ++d) o[d] *= a;
      m = cm;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int key = grp + nq * i;
      if (key < nk) {
        const float p = expf(s[i] - m);
        l += p;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 y = kvs[key][32 + 8 * e + h];
          o[4 * e] = fmaf(p, y.x, o[4 * e]);
          o[4 * e + 1] = fmaf(p, y.y, o[4 * e + 1]);
          o[4 * e + 2] = fmaf(p, y.z, o[4 * e + 2]);
          o[4 * e + 3] = fmaf(p, y.w, o[4 * e + 3]);
        }
      }
    }
  }
  // the groups' (m, l, o), merged in group order through kvs
  __syncthreads();
  float* red = reinterpret_cast<float*>(kvs);  // [nq][P][18]
  if (active && grp > 0) {
    float* r = red + (grp * P + pair) * 18;
    r[0] = m;
    r[1] = l;
#pragma unroll
    for (int d = 0; d < 16; ++d) r[2 + d] = o[d];
  }
  __syncthreads();
  if (!active || grp > 0) return;
  float M = m;
  for (int g = 1; g < nq; ++g) M = fmaxf(M, red[(g * P + pair) * 18]);
  const float a0 = m == -CUDART_INF_F ? 0.f : expf(m - M);
  l *= a0;
#pragma unroll
  for (int d = 0; d < 16; ++d) o[d] *= a0;
  for (int g = 1; g < nq; ++g) {
    const float* r = red + (g * P + pair) * 18;
    if (r[0] == -CUDART_INF_F) continue;
    const float a = expf(r[0] - M);
    l = fmaf(r[1], a, l);
#pragma unroll
    for (int d = 0; d < 16; ++d) o[d] = fmaf(r[2 + d], a, o[d]);
  }
  const size_t slot = ((size_t)b * gridDim.y + tile) * P + pair;
  ml[slot] = make_float2(M, l);
  float4* out = reinterpret_cast<float4*>(po + slot * 16);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    out[e] = make_float4(o[4 * e], o[4 * e + 1], o[4 * e + 2], o[4 * e + 3]);
}

// hi = tf32(x), lo = tf32(x - hi) of n floats (a weight's two planes, made
// once when the weights are packed)
__global__ void __launch_bounds__(256)
    split_tf32_planes(const float* __restrict__ x, float* __restrict__ hi,
                      float* __restrict__ lo, long long n) {
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < n;
       i += (long long)gridDim.x * 256) {
    uint32_t h, l;
    tf32_split(x[i], h, l);
    hi[i] = __uint_as_float(h);
    lo[i] = __uint_as_float(l);
  }
}

template <int kStage>
int stage_f32_launch(const StageF32Args& a, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      image_stage_f32<kStage>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kF32SmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const int units = a.B * a.U;
  const int grid = units < sm_count() ? units : sm_count();
  image_stage_f32<kStage><<<grid, kUnitThreads, kF32SmemBytes, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ullsam

// Plain C entry points (loaded with ctypes). Each returns 0 or a
// cudaError_t. Every tensor is bf16 and row-major, 16-byte aligned.

// One of B5's image stages over B prompts of T tokens against N shared
// image rows (see the notes above). Stage 1: rows = qi1 [N, 128], res2
// [N, 384], w_out / b_out / nw / nb = block 1's i2t out-projection and
// norm4, w_kv = img2 [384, 256], kt / vt = block 1's i2t tokens, qt =
// block 2's t2i queries -> keys (keys1), kv (block 2's k | v), part. Stage
// 2: rows = keys1 [B*N, 256], res2 and resf [N, 256], block 2's w_out /
// b_out / nw / nb, w_kv = imgf [256, 256], w_q = img2, kt / vt = block 2's
// i2t tokens, qt = the final attention's queries -> keys (keys2), kv (the
// final attention's k | v), part.
extern "C" int decoder_image_stage(
    int stage, const void* rows, const void* src, const void* res2,
    const void* resf, const void* w_out, const void* b_out, const void* nw,
    const void* nb, const void* w_kv, const void* w_q, const void* kt,
    const void* vt, const void* qt, void* keys, void* kv, void* part, int B,
    int N, int T, float scale, float eps, void* stream) {
  using namespace ullsam;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1 || T < 1 || T > kUnitMaxTok ||
      (stage != 1 && stage != 2) || !keys || !kv || !part)
    return cudaErrorInvalidValue;
  using B16 = const bf16*;
  StageArgs a{};
  a.b_out = static_cast<B16>(b_out);
  a.nw = static_cast<B16>(nw);
  a.nb = static_cast<B16>(nb);
  a.kt = static_cast<B16>(kt);
  a.vt = static_cast<B16>(vt);
  a.qt = static_cast<B16>(qt);
  a.part = static_cast<float2*>(part);
  a.B = B;
  a.N = N;
  a.T = T;
  a.U = image_units(N);
  a.scale = scale;
  a.eps = eps;
  const bool ok =
      (stage == 1 ? map_rows(&a.rows, rows, N, kUnitCd, 64) &&
                        map_rows(&a.res_a, src, N, kUnitC, kUnitRows) &&
                        map_rows(&a.res_kv, res2, N, 3 * kUnitCd, kUnitRows)
                  : map_rows(&a.rows, rows, B * N, kUnitC, 64) &&
                        map_rows(&a.w_q,
                                 static_cast<B16>(w_q) + 2 * kUnitCd * kUnitC,
                                 kUnitCd, kUnitC, kUnitCd) &&
                        map_rows(&a.res_a, res2, N, 3 * kUnitCd, kUnitRows) &&
                        map_rows(&a.res_kv, resf, N, kUnitC, kUnitRows)) &&
      map_rows(&a.w_out, w_out, kUnitC, kUnitCd, kUnitC) &&
      map_rows(&a.w_kv, w_kv, kUnitC, kUnitC, kUnitC) &&
      map_prompt_rows(&a.keys_out, keys, B, N) &&
      map_prompt_rows(&a.kv_out, kv, B, N);
  if (!ok) return cudaErrorInvalidValue;
  return stage == 1 ? stage_launch<1>(a, st) : stage_launch<2>(a, st);
}

// o [B*T, 128] bf16: queries q [B*T, 128] against the k | v rows kv
// [B*N, 256] of an image stage, with that stage's partials; scratch holds
// B * ceil(N / 512) * T * 8 * 16 floats
extern "C" int decoder_t2i_part(const void* q, const void* kv,
                                const void* part, void* scratch, void* o,
                                int B, int N, int T, float scale,
                                void* stream) {
  using namespace ullsam;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1 || T < 1 || T > kUnitMaxTok) return cudaErrorInvalidValue;
  const int tiles = (N + kT2iRows - 1) / kT2iRows;
  t2i_part_pv<<<dim3(B, tiles), 128, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kv),
      static_cast<const float2*>(part), static_cast<float*>(scratch), N, T,
      2 * image_units(N), scale);
  int err = (int)cudaGetLastError();
  if (err) return err;
  t2i_part_sum<<<B, 128, 0, st>>>(static_cast<const float*>(scratch),
                                  tiles, T, static_cast<bf16*>(o));
  return (int)cudaGetLastError();
}

// The float32 kind of decoder_image_stage at SAM's widths (the same
// arguments, every tensor float32), on image_stage_f32: each weight as its
// hi and lo planes (decoder_split_tf32): wo_* the stage's i2t out-projection
// [256, 128], wkv_* img2 [384, 256] (stage 1; its rows 0..255) or imgf
// [256, 256] (stage 2), wq_* img2 (stage 2; its rows 256..383). The token
// -> image partials a unit: ml holds B * ceil(N / 64) * T * 8 (max, sum
// exp) pairs, po 16 floats for each.
extern "C" int decoder_image_stage_f32(
    int stage, const void* rows, const void* src, const void* res2,
    const void* resf, const void* wo_hi, const void* wo_lo,
    const void* b_out, const void* nw, const void* nb, const void* wkv_hi,
    const void* wkv_lo, const void* wq_hi, const void* wq_lo, const void* kt,
    const void* vt, const void* qt, void* keys, void* kv, void* ml, void* po,
    int B, int N, int T, float scale, float eps, void* stream) {
  using namespace ullsam;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1 || T < 1 || T > kUnitMaxTok ||
      (stage != 1 && stage != 2) || !keys || !kv || !ml || !po || !src ||
      !res2 || (stage == 2 && !resf))
    return cudaErrorInvalidValue;
  using F = const float*;
  StageF32Args a{};
  a.res_a = static_cast<F>(stage == 1 ? src : res2);
  a.ld_a = stage == 1 ? kUnitC : 3 * kUnitCd;
  a.res_kv = static_cast<F>(stage == 1 ? res2 : resf);
  a.ld_kv = stage == 1 ? 3 * kUnitCd : kUnitC;
  a.b_out = static_cast<F>(b_out);
  a.nw = static_cast<F>(nw);
  a.nb = static_cast<F>(nb);
  a.kt = static_cast<F>(kt);
  a.vt = static_cast<F>(vt);
  a.qt = static_cast<F>(qt);
  a.ml = static_cast<float2*>(ml);
  a.po = static_cast<float*>(po);
  a.B = B;
  a.N = N;
  a.T = T;
  a.U = f32_units(N);
  a.scale = scale;
  a.eps = eps;
  const size_t q_off = (size_t)2 * kUnitCd * kUnitC;  // img2's row 256
  const bool ok =
      rows &&
      (stage == 1
           ? make_map(&a.rows, rows, N, kUnitCd, kF32Rows, kMapF32)
           : make_map(&a.rows, rows, B * N, kUnitC, kF32Rows, kMapF32) &&
                 make_map_w64(&a.wq_hi, static_cast<F>(wq_hi) + q_off,
                              kUnitCd, kUnitC, kUnitCd) &&
                 make_map_w64(&a.wq_lo, static_cast<F>(wq_lo) + q_off,
                              kUnitCd, kUnitC, kUnitCd)) &&
      make_map_w64(&a.wo_hi, wo_hi, kUnitC, kUnitCd, kUnitC) &&
      make_map_w64(&a.wo_lo, wo_lo, kUnitC, kUnitCd, kUnitC) &&
      make_map_w64(&a.wkv_hi, wkv_hi, kUnitC, kUnitC, kUnitC) &&
      make_map_w64(&a.wkv_lo, wkv_lo, kUnitC, kUnitC, kUnitC) &&
      map_prompt_rows_f32(&a.keys_out, keys, B, N) &&
      map_prompt_rows_f32(&a.kv_out, kv, B, N);
  if (!ok) return cudaErrorInvalidValue;
  return stage == 1 ? stage_f32_launch<1>(a, st) : stage_f32_launch<2>(a, st);
}

// o [B*T, 128] f32: the token -> image attention of an f32 image stage,
// its queries against the k | v rows it wrote, from the partials it wrote
// (ml, po; U = ceil(N / 64) a prompt)
extern "C" int decoder_t2i_part_f32(const void* ml, const void* po, void* o,
                                    int B, int N, int T, void* stream) {
  using namespace ullsam;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1 || T < 1 || T > kUnitMaxTok) return cudaErrorInvalidValue;
  t2i_combine_f32<<<B, 128, 0, st>>>(static_cast<const float2*>(ml),
                                     static_cast<const float*>(po),
                                     f32_units(N), T, static_cast<float*>(o));
  return (int)cudaGetLastError();
}

// o [B*T, 128] f32: queries q [B*T, 128] against keys / values of N image
// rows at k, v + b * bstride + n * ld (bstride 0: shared by all prompts;
// rows 16-byte aligned), in float32: t2i_flash_f32's partials a 512-row
// tile, then t2i_combine_f32; scratch holds B * ceil(N / 512) * T * 8 *
// (2 + 16) floats (ops/kernels/decoder.py t2i_f32_scratch)
extern "C" int decoder_t2i_f32(const void* q, const void* k, const void* v,
                               int ld, long long bstride, void* scratch,
                               void* o, int B, int N, int T, float scale,
                               void* stream) {
  using namespace ullsam;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1 || T < 1 || T > kUnitMaxTok || ld % 4 || bstride % 4)
    return cudaErrorInvalidValue;
  const int tiles = (N + kT2iRows - 1) / kT2iRows;
  int nq = 1;  // key groups a block: as many as 256 threads hold, up to 8
  while (nq < 8 && 2 * nq * T * kUnitHeads <= 256) nq *= 2;
  float2* ml = static_cast<float2*>(scratch);
  float* po = static_cast<float*>(scratch) +
              (size_t)2 * B * tiles * T * kUnitHeads;
  t2i_flash_f32<<<dim3(B, tiles), 256, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), ld, bstride, ml, po, N, T, nq, scale);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  t2i_combine_f32<<<B, 128, 0, st>>>(ml, po, tiles, T,
                                     static_cast<float*>(o));
  return (int)cudaGetLastError();
}

// hi = tf32(x), lo = tf32(x - hi) of x [n] f32 (round to nearest, ties
// away, as cvt.rna): a weight's planes for the f32 kernels' split TF32
extern "C" int decoder_split_tf32(const void* x, void* hi, void* lo,
                                  long long n, void* stream) {
  using namespace ullsam;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || !x || !hi || !lo) return cudaErrorInvalidValue;
  const long long blocks = (n + 255) / 256;
  split_tf32_planes<<<(unsigned)(blocks < 1024 ? blocks : 1024), 256, 0, st>>>(
      static_cast<const float*>(x), static_cast<float*>(hi),
      static_cast<float*>(lo), n);
  return (int)cudaGetLastError();
}
