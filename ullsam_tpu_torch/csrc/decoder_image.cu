// B5's per-prompt image side for Hopper (sm_90a), bf16 at SAM's decoder
// widths (C = 256, Cd = 128, 8 heads of 16, T <= 16 tokens): the part of
// the TwoWayTransformer whose rows are (prompt, image row), B * N of them,
// in two launches of one kernel (decoder_image_stage) with the units and
// pipeline of decoder_sm90.cuh, and the token -> image attention against
// what they write (decoder_t2i_part).
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
#include "decoder_sm90.cuh"

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
