// B11: gradient of the LLM's causal GQA flash attention with segment ids
// (B10), for Hopper (sm_90a).
//
// Replaces the TPU kernels ullsam_tpu/ops/pallas/flash_attention.py
// `_llm_bwd_dq_kernel` and `_llm_bwd_dkv_kernel` (via `_llm_flash_bwd_impl`).
// With the validity predicate (q_seg[i] == kv_seg[j], and j <= i when
// causal), the forward's row logsumexp lse and dd = rowsum(do * o)
// (computed by the caller), it scores as the TPU kernels do, from unscaled
// q (flash_attention.py:604-612):
//     s = f32(q k^T) * D^-1/2,  p = exp(s - lse) at valid keys, 0 elsewhere
//     ds = p (do v^T - dd)
//     dq = (ds k) * D^-1/2,  dk = sum over the group's heads of (ds^T q)
//     * D^-1/2,  dv = sum over the group's heads of p^T do
// p and ds are rounded to the input dtype before their products; every sum
// is f32. Layouts as B10: q, do, dq [B, S, nh, D]; k, v, dk, dv [B, S, nkv,
// D]; segment ids [B, S] int32; lse, dd [B, nh, S]; rows and keys past S
// are zero-filled on load and masked by bounds checks.
//
// What bounds it on this card: operations. The gradient needs 5 products of
// 2 D per valid (query, key) pair and head (s, dp, dv, dk, dq): at the
// packed-training shape (S = 2560, nh = 16, nkv = 8, D = 128, segments of
// 1124 and 1224 tokens) 28.8 GFLOP against ~52 MB.
//
// bf16 (llm_bwd_sm90, llm_sm90.cuh's tiles): one key-major kernel that runs
// the 5 products, and a small one that converts dq's f32 sum.
//   * A block owns 64 keys of one kv head and walks, for each of the
//     group's query heads in turn, the query tiles from the diagonal on
//     (all when not causal) that hold one of its keys' segment ids
//     (seg_tiles.cuh). dK and dV sum the group in registers and are
//     written once, in bf16. Blocks run key tile by key tile, the kv heads
//     of one tile neighbours: on a causal packed row each segment's
//     longest walks start first.
//   * Two consumer warpgroups and a producer warpgroup that gives its
//     registers to them (setmaxnreg 40 / 232). Thread 0 loads the block's
//     k and v by TMA before the segment scan; the producer's first thread
//     then loads q and do of each query tile into a ring of kBwdStages
//     stages (full / empty mbarriers), its first 64 threads copying the
//     tile's lse (times log2 e), dd and segment ids beside them.
//   * Per query tile, warpgroup w takes queries 32 w .. 32 w + 31: S^T = k
//     q^T and dP^T = v do^T on wgmma m64n32k16 (all operands K-major from
//     shared memory), p^T and ds^T in f32 registers, rounded to bf16 into
//     two shared [64 keys][64 queries] tiles in the 128-byte swizzle
//     (double-buffered; one named barrier a tile joins the warpgroups).
//     Then warpgroup w takes columns w D/2 .. of every output: dV += P^T do
//     and dK += dS^T q (m64n(D/2)k16, q and do read MN-major), and dQ =
//     dS k (dS^T read MN-major as A).
//   * dQ: each warpgroup stages its 64 x D/2 partial in shared memory and
//     one thread adds it to the tile's chunk of an f32 scratch with one TMA
//     bulk reduction (cp.reduce.async.bulk .add.f32, 16 KB at D = 128);
//     llm_bwd_convert scales the sums by D^-1/2 and rounds them to bf16.
//     The reductions land in an order that changes from run to run, and so
//     do dq's last bits; dk and dv are the same every run.
// On an H100 (PERF.md section 6): float-pair red.global.add of dQ from
// registers held the kernel near the L2's atomic rate; the bulk
// reductions ran 1.25x. Walking the group's heads in turn ran 1.1x
// spreading them over blocks with dk / dv atomics (half the blocks, half
// the scratch). Loading k / v before the scan and the scan's loads four at
// a time, 1.06x. Issuing the next tile's S^T / dP^T before this tile's
// softmax (two buffers), with or without the softmax under the previous
// tile's products, and a mask-free path for tile pairs of one segment ran
// slower.
//
// float32 (llm_split_f32, llm_bwd_dq_tf32, llm_bwd_dkv_tf32; llm_f32.cuh):
// the same function on the tensor cores in split TF32, two kernels as on
// the TPU and no atomics, so every call gives bitwise the same result.
// They do 7 products (S and dP in both), 7/5 of the needed work.
//   * A pre-pass writes the hi and lo planes of q, k, v and do as they are
//     ([B H][Sp][D]) and of q, k and do transposed ([B H][D][Sp], 8-groups
//     in lf32_pi order): TF32 wgmma reads shared memory K-major only, and
//     dQ += ds k, dK += ds^T q and dV += p^T do contract along rows
//     (231 MB at the sft shape).
//   * A block holds 64 rows of one side fixed in shared memory, hi and lo
//     (128 KB at D = 128), and streams the other side's live tiles of
//     kTile rows (16 at D = 128, where four buffers of 32 rows would not
//     fit beside them). Two consumer warpgroups split the work so that
//     one's CUDA-core work and waits run under the other's products, and
//     a producer warpgroup gives its registers to them (setmaxnreg); its
//     first thread loads each tile's buffers, each released by the
//     warpgroup that reads it once its products are done.
//   * dq, query-major: 64 queries of one (b, head), q and do fixed.
//     Warpgroup 0: S = q k^T and p; warpgroup 1: dP = do v^T, ds = p (dP
//     - dd) with p passed through shared memory, and dQ += ds k (k^T).
//   * dk + dv, key-major: 64 keys of one (b, kv head), k and v fixed; the
//     walk takes the group's query heads in turn. Warpgroup 0: S^T = k
//     q^T, p and dV += p^T do (do^T); warpgroup 1: dP^T = v do^T, ds^T and
//     dK += ds^T q (q^T). dK and dV sum the group in registers.
//   * S and dP sum their k-steps in kLf32Chains chains (12 products at D =
//     128), folded on the CUDA cores. p and ds are split in registers into
//     the A operands. A warpgroup issues its next tile's logits behind its
//     output products and frees the buffer those read as soon as they are
//     done, so its next load runs under the logits. dQ, dK and dV restart
//     from zero every kLf32FlushRows rows of the walk, added to their f32
//     rows in device memory (the block owns them).
//   * Tiles are skipped as the bf16 body skips them (seg_tiles.cuh); rows
//     past S are zero planes and masked; a block with no live tile writes
//     zeros.
#include "llm_f32.cuh"

namespace ullsam {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kB = 64;  // bf16: query / key tile

// ---- float32: split TF32 on wgmma + TMA (see the note at the top) ---------

// The blocks' shared memory; must match ops/kernels/llm_flash_attention.py
// bwd_f32_smem_bytes. A natural plane of R rows takes 4 R D bytes, a
// transposed one [D][R] as much.
// dq: 1024 bytes to align; q hi, q lo, do hi, do lo of the block's 64
// queries; three buffers of a key tile, each a hi and a lo plane: k
// (warpgroup 0's), v and k^T (warpgroup 1's); p passed from warpgroup 0
// to 1, two buffers of [kTile / 2][128] f32; full and empty mbarriers a
// buffer, two of each for p, one for q and do. At D = 128: 1024 + 131072
// + 3 x 16384 + 8192 + 88 = 189,528.
// dkv: k hi, k lo, v hi, v lo of the block's 64 keys; four buffers of a
// query tile: q and do^T (warpgroup 0's), do and q^T (warpgroup 1's); the
// p buffers; full and empty mbarriers a buffer, two of each for p, one
// for k and v. At D = 128: 1024 + 131072 + 4 x 16384 + 8192 + 104 =
// 205,928.
constexpr int kLf32BwdThreads = 384;  // two consumer warpgroups + a producer

template <int D>
struct Lf32BwdLayout {
  static constexpr int kTile = D > 64 ? 16 : 32;  // rows of a streamed tile
  static constexpr int kP64 = kLf32Rows * D * 4;   // a plane of 64 rows
  static constexpr int kFixed = 4 * kP64;
  static constexpr int kBuf = 2 * kTile * D * 4;   // a tile's hi, lo planes
  static constexpr int kPx = 2 * kTile / 2 * 128 * 4;  // two p buffers
  static constexpr int kDqSmem = 1024 + kFixed + 3 * kBuf + kPx + 11 * 8;
  static constexpr int kDkvSmem = 1024 + kFixed + 4 * kBuf + kPx + 13 * 8;
  static_assert(kDkvSmem + (int)sizeof(SegTiles) <= 232448, "one block");
};

// The maps of the backward's scratch: `nat` [4 B nh Sp + 4 B nkv Sp][D] (q
// hi, q lo, do hi, do lo, k hi, k lo, v hi, v lo) and `tr` [4 B nh D + 2 B
// nkv D][Sp] (q^T hi, q^T lo, do^T hi, do^T lo, k^T hi, k^T lo), in boxes
// of kTile rows or columns.
struct Lf32BwdMaps {
  CUtensorMap nat, tr;
};

// grid (nh * ceil(S / 64), B), kLf32BwdThreads threads: dq of 64 queries
// of one (b, head), the longest walks first; lse, dd [B, nh, S].
// Warpgroup 0 takes S = q k^T and p; warpgroup 1 dP = do v^T, ds = p (dP
// - dd) (p from warpgroup 0 through shared memory) and dQ += ds k;
// warpgroup 2 the loads.
template <int D>
__global__ void __launch_bounds__(kLf32BwdThreads, 1)
    llm_bwd_dq_tf32(const __grid_constant__ Lf32BwdMaps maps,
                    const int* __restrict__ qseg,
                    const int* __restrict__ kseg,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd, float* __restrict__ dq,
                    int S, int nh, int nkv, int causal, float scale) {
  using L = Lf32BwdLayout<D>;
  constexpr int kT = L::kTile, kN = kT / 2, kBuf = L::kBuf;
  constexpr int kFlush = kLf32FlushRows / kT;
  enum { kK = 0, kV = 1, kKt = 2 };  // the tile buffers
  extern __shared__ unsigned char smraw[];
  unsigned char* base = align1024(smraw);  // q hi, q lo, do hi, do lo
  unsigned char* bufs = base + L::kFixed;  // k | v, k^T (hi, lo)
  float* px = reinterpret_cast<float*>(bufs + 3 * kBuf);  // [2][kN][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(px + 2 * kN * 128);
  uint64_t* empty = full + 3;
  uint64_t* pfull = empty + 3;
  uint64_t* pempty = pfull + 2;
  uint64_t* qbar = pempty + 2;
  const auto buf = [&](int i) { return bufs + i * kBuf; };
  __shared__ SegTiles tiles;

  const int tid = threadIdx.x, wg = tid >> 7, B = gridDim.y;
  const int NT = (S + kLf32Rows - 1) / kLf32Rows, Sp = NT * kLf32Rows;
  const int h = blockIdx.x % nh, b = blockIdx.y;
  const int qt = NT - 1 - blockIdx.x / nh, q0 = qt * kLf32Rows;
  const int hk = h / (nh / nkv);
  const int* qsb = qseg + (size_t)b * S;
  const int* ksb = kseg + (size_t)b * S;
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);  // each warp of the buffer's warpgroup
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&pfull[i], 4);   // warpgroup 0's warps: p written
      mbar_init(&pempty[i], 4);  // warpgroup 1's: p read
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int nkt = causal ? qt + 1 : NT;
  seg_own_ids(tiles, qsb, q0, S, tid);  // synchronises: the barriers exist
  seg_mark_live(tiles, ksb, 0, nkt, S, tid, kLf32BwdThreads);

  if (wg == 2) {  // the producer warpgroup: one thread issues
    producer_registers();
    if (tid == 256) {
      const int pq = B * nh * Sp, pk = B * nkv * Sp;
      const int qrow = (b * nh + h) * Sp + q0;
      mbar_expect_tx(qbar, L::kFixed);
      for (int i = 0; i < 4; ++i)  // q hi, q lo, do hi, do lo
        for (int r = 0; r < kLf32Rows; r += kT)
          lf32_load_rows<D, kLf32Rows>(base + i * L::kP64, r, &maps.nat,
                                       qbar, i * pq + qrow + r);
      // natural rows of k hi (then k lo, v hi, v lo), transposed of k^T
      const int krow = 4 * pq + (b * nkv + hk) * Sp;
      const int trow = 4 * B * nh * D + (b * nkv + hk) * D, tlo = B * nkv * D;
      int n = 0;
      for (Lf32Walk<kT> w(tiles, 0, nkt, 1); w.valid(); w.next(), ++n) {
        const int k0 = w.row0(), ph = n & 1;
        for (int i = 0; i < 3; ++i) {  // k, v, k^T: in the order of use
          mbar_wait(&empty[i], ph ^ 1);
          mbar_expect_tx(&full[i], kBuf);
          for (int j = 0; j < 2; ++j) {
            unsigned char* dst = buf(i) + j * (kBuf / 2);
            if (i == kKt)
              tma_load_2d(dst, &maps.tr, &full[i], k0, trow + j * tlo);
            else
              lf32_load_rows<D, kT>(dst, 0, &maps.nat, &full[i],
                                    krow + (2 * i + j) * pk + k0);
          }
        }
      }
    }
    return;
  }
  consumer_registers();

  // a consumer thread: rows g and g + 8 of its warp's 16, keys 8 j + 2 t +
  // e of a tile (accumulator slot 4 j + 2 hf + e)
  const int t128 = tid & 127, lane = tid & 31, wr = t128 >> 5;
  const int g = lane >> 2, t = lane & 3;
  int row[2], rseg[2];
  float rv[2];  // lse (warpgroup 0) or dd (1) of the rows
  float* dq_rows[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    row[hf] = q0 + wr * 16 + g + 8 * hf;
    const bool in = row[hf] < S;
    const size_t rb = ((size_t)b * nh + h) * S + row[hf];
    rseg[hf] = in ? qsb[row[hf]] : 0;
    rv[hf] = in ? (wg ? dd[rb] : lse[rb]) : 0.f;
    dq_rows[hf] =
        in ? dq + (((size_t)b * S + row[hf]) * nh + h) * D : nullptr;
  }
  float ch[kLf32Chains][kN], qacc[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) qacc[c] = 0.f;
  const auto fence_acc = [&] {
#pragma unroll
    for (int c = 0; c < kLf32Chains; ++c) reg_fence(ch[c]);
    reg_fence(qacc);
  };
  // S = q k^T (warpgroup 0) or dP = do v^T (1), in kLf32Chains chains from
  // zero
  const unsigned char* fixed = base + wg * 2 * L::kP64;
  const int nat = wg ? kV : kK;
  const auto issue_logits = [&] {
#pragma unroll
    for (int c = 0; c < kLf32Chains; ++c) {
#pragma unroll
      for (int x = 0; x < kN; ++x) ch[c][x] = 0.f;
      reg_fence(ch[c]);
    }
    wgmma_fence();
    lf32_logits<D, kT>(
        ch,
        [&](int ks, bool lo) {
          return lf32_nat_desc<kLf32Rows>(fixed + (lo ? L::kP64 : 0), ks);
        },
        [&](int ks, bool lo) {
          return lf32_nat_desc<kT>(buf(nat) + (lo ? kBuf / 2 : 0), ks);
        });
    wgmma_commit();
  };
  mbar_wait(qbar, 0);

  Lf32Walk<kT> w(tiles, 0, nkt, 1);
  int n = 0;
  if (w.valid()) {
    mbar_wait(&full[nat], 0);
    issue_logits();
  }
  for (; w.valid(); ++n) {
    const int k0 = w.row0(), ph = n & 1, pb = n & 1;
    float* pxb = px + pb * kN * 128;
    if (wg == 0) {
      int kid[kN / 2];  // segment ids of the thread's keys 8 j + 2 t + e
#pragma unroll
      for (int j = 0; j < kT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * t + e;
          kid[2 * j + e] = key < S ? ksb[key] : 0;
        }
      wgmma_wait<0>();  // this tile's S
      fence_acc();
      lf32_release(&empty[kK], lane);
      mbar_wait(&pempty[pb], ((n >> 1) & 1) ^ 1);  // p of tile n - 2 read
#pragma unroll
      for (int x = 0; x < kN; ++x) {  // p = exp(s D^-1/2 - lse), valid keys
        const int j = x >> 2, hf = (x >> 1) & 1, e = x & 1;
        float v = ch[0][x];
#pragma unroll
        for (int c = 1; c < kLf32Chains; ++c) v += ch[c][x];
        const int key = k0 + 8 * j + 2 * t + e;
        const bool ok = key < S && row[hf] < S &&
                        kid[2 * j + e] == rseg[hf] &&
                        (!causal || key <= row[hf]);
        pxb[x * 128 + t128] = ok ? expf(v * scale - rv[hf]) : 0.f;
      }
      lf32_release(&pfull[pb], lane);
      w.next();
      if (w.valid()) {  // the next tile's S
        mbar_wait(&full[kK], (n + 1) & 1);
        issue_logits();
      }
      continue;
    }
    wgmma_wait<0>();  // this tile's dP
    fence_acc();
    lf32_release(&empty[kV], lane);
    if (n > 0 && n % kFlush == 0)
      lf32_flush<D>(dq_rows, qacc, t, n == kFlush, 1.f);
    // ds = p (dP - dd), split into the A operand of k-step j: register 2 e
    // + hf holds row g + 8 hf, key 8 j + 2 t + e (lf32_pi)
    uint32_t dh[kT / 8][4], dl[kT / 8][4];
    mbar_wait(&pfull[pb], (n >> 1) & 1);
#pragma unroll
    for (int x = 0; x < kN; ++x) {
      const int j = x >> 2, hf = (x >> 1) & 1, e = x & 1;
      float v = ch[0][x];
#pragma unroll
      for (int c = 1; c < kLf32Chains; ++c) v += ch[c][x];
      const float ds = pxb[x * 128 + t128] * (v - rv[hf]);
      tf32_split(ds, dh[j][2 * e + hf], dl[j][2 * e + hf]);
    }
    lf32_release(&pempty[pb], lane);
    mbar_wait(&full[kKt], ph);
    fence_acc();
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {  // dQ += ds k
      const uint64_t kh = lf32_tr_desc<kT>(buf(kKt), j);
      const uint64_t kl = lf32_tr_desc<kT>(buf(kKt) + kBuf / 2, j);
      lf32_rs<D>(qacc, dh[j], kl);
      lf32_rs<D>(qacc, dl[j], kh);
      lf32_rs<D>(qacc, dh[j], kh);
    }
    wgmma_commit();
    w.next();
    if (w.valid()) {  // the next tile's dP, issued behind this dQ
      mbar_wait(&full[kV], (n + 1) & 1);
      issue_logits();
      wgmma_wait<1>();  // the dQ done, k^T free while dP runs
    } else {
      wgmma_wait<0>();
    }
    fence_acc();
    lf32_release(&empty[kKt], lane);
  }
  if (wg == 1) {
    wgmma_wait<0>();
    fence_acc();
    lf32_flush<D>(dq_rows, qacc, t, n <= kFlush, scale);
  }
}

// grid (nkv * ceil(S / 64), B), kLf32BwdThreads threads: dk and dv of 64
// keys of one (b, kv head), summed over the group's query heads in turn.
// Warpgroup 0 takes S^T = k q^T, p and dV += p^T do; warpgroup 1 dP^T = v
// do^T, ds = p (dP - dd) (p from warpgroup 0 through shared memory) and
// dK += ds^T q; warpgroup 2 the loads.
template <int D>
__global__ void __launch_bounds__(kLf32BwdThreads, 1)
    llm_bwd_dkv_tf32(const __grid_constant__ Lf32BwdMaps maps,
                     const int* __restrict__ qseg,
                     const int* __restrict__ kseg,
                     const float* __restrict__ lse,
                     const float* __restrict__ dd, float* __restrict__ dk,
                     float* __restrict__ dv, int S, int nh, int nkv,
                     int causal, float scale) {
  using L = Lf32BwdLayout<D>;
  constexpr int kT = L::kTile, kN = kT / 2, kBuf = L::kBuf;
  constexpr int kFlush = kLf32FlushRows / kT;
  enum { kQ = 0, kGt = 1, kG = 2, kQt = 3 };  // the tile buffers
  extern __shared__ unsigned char smraw[];
  unsigned char* base = align1024(smraw);  // k hi, k lo, v hi, v lo
  unsigned char* bufs = base + L::kFixed;  // q, do^T | do, q^T (hi, lo)
  float* px = reinterpret_cast<float*>(bufs + 4 * kBuf);  // [2][kN][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(px + 2 * kN * 128);
  uint64_t* empty = full + 4;
  uint64_t* pfull = empty + 4;
  uint64_t* pempty = pfull + 2;
  uint64_t* kvbar = pempty + 2;
  const auto buf = [&](int i) { return bufs + i * kBuf; };
  __shared__ SegTiles tiles;

  const int tid = threadIdx.x, wg = tid >> 7, B = gridDim.y;
  const int NT = (S + kLf32Rows - 1) / kLf32Rows, Sp = NT * kLf32Rows;
  const int hk = blockIdx.x % nkv, b = blockIdx.y;
  const int kt = blockIdx.x / nkv, k0 = kt * kLf32Rows;
  const int group = nh / nkv, qt0 = causal ? kt : 0;
  const int* qsb = qseg + (size_t)b * S;
  const int* ksb = kseg + (size_t)b * S;
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);  // each warp of the buffer's warpgroup
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&pfull[i], 4);   // warpgroup 0's warps: p written
      mbar_init(&pempty[i], 4);  // warpgroup 1's: p read
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  seg_own_ids(tiles, ksb, k0, S, tid);  // synchronises: the barriers exist
  seg_mark_live(tiles, qsb, qt0, NT, S, tid, kLf32BwdThreads);

  if (wg == 2) {  // the producer warpgroup: one thread issues
    producer_registers();
    if (tid == 256) {
      const int pq = B * nh * Sp, pk = B * nkv * Sp, tq = B * nh * D;
      const int krow = 4 * pq + (b * nkv + hk) * Sp + k0;
      mbar_expect_tx(kvbar, L::kFixed);
      for (int i = 0; i < 4; ++i)  // k hi, k lo, v hi, v lo
        for (int r = 0; r < kLf32Rows; r += kT)
          lf32_load_rows<D, kLf32Rows>(base + i * L::kP64, r, &maps.nat,
                                       kvbar, krow + i * pk + r);
      int n = 0;
      for (Lf32Walk<kT> w(tiles, qt0, NT, group); w.valid(); w.next(), ++n) {
        const int h = hk * group + w.h, q0 = w.row0(), ph = n & 1;
        const int qrow = (b * nh + h) * Sp + q0, trow = (b * nh + h) * D;
        // in the order of first use: q, do (natural), do^T, q^T; plane i of
        // the scratch: q hi, q lo, do hi, do lo (natural and transposed)
        const int order[4] = {kQ, kG, kGt, kQt};
        for (int o = 0; o < 4; ++o) {
          const int i = order[o], first = i == kQ || i == kQt ? 0 : 2;
          mbar_wait(&empty[i], ph ^ 1);
          mbar_expect_tx(&full[i], kBuf);
          for (int j = 0; j < 2; ++j) {
            unsigned char* dst = buf(i) + j * (kBuf / 2);
            if (i == kQ || i == kG)
              lf32_load_rows<D, kT>(dst, 0, &maps.nat, &full[i],
                                    (first + j) * pq + qrow);
            else
              tma_load_2d(dst, &maps.tr, &full[i], q0,
                          (first + j) * tq + trow);
          }
        }
      }
    }
    return;
  }
  consumer_registers();

  // a consumer thread: keys (rows) g and g + 8 of its warp's 16, queries
  // (columns) 8 j + 2 t + e of a tile (accumulator slot 4 j + 2 hf + e)
  const int t128 = tid & 127, lane = tid & 31, wr = t128 >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nat = wg ? kG : kQ, trn = wg ? kQt : kGt;  // this one's buffers
  int key[2], kid[2];
  float* out_rows[2];  // dV (warpgroup 0) or dK (1) rows
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    key[hf] = k0 + wr * 16 + g + 8 * hf;
    const bool in = key[hf] < S;
    kid[hf] = in ? ksb[key[hf]] : 0;
    out_rows[hf] = in ? (wg ? dk : dv) + (((size_t)b * S + key[hf]) * nkv +
                                          hk) * D
                      : nullptr;
  }
  float ch[kLf32Chains][kN], acc[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) acc[c] = 0.f;
  const auto fence_acc = [&] {
#pragma unroll
    for (int c = 0; c < kLf32Chains; ++c) reg_fence(ch[c]);
    reg_fence(acc);
  };
  // S^T = k q^T (warpgroup 0) or dP^T = v do^T (1), in kLf32Chains chains
  // from zero
  const unsigned char* fixed = base + wg * 2 * L::kP64;
  const auto issue_logits = [&] {
#pragma unroll
    for (int c = 0; c < kLf32Chains; ++c) {
#pragma unroll
      for (int x = 0; x < kN; ++x) ch[c][x] = 0.f;
      reg_fence(ch[c]);
    }
    wgmma_fence();
    lf32_logits<D, kT>(
        ch,
        [&](int ks, bool lo) {
          return lf32_nat_desc<kLf32Rows>(fixed + (lo ? L::kP64 : 0), ks);
        },
        [&](int ks, bool lo) {
          return lf32_nat_desc<kT>(buf(nat) + (lo ? kBuf / 2 : 0), ks);
        });
    wgmma_commit();
  };
  mbar_wait(kvbar, 0);

  Lf32Walk<kT> w(tiles, qt0, NT, group);
  int n = 0;
  if (w.valid()) {
    mbar_wait(&full[nat], 0);
    issue_logits();
  }
  for (; w.valid(); ++n) {
    const int h = hk * group + w.h, q0 = w.row0(), ph = n & 1, pb = n & 1;
    // the thread's queries q0 + 8 j + 2 t + e: lse and segment ids
    // (warpgroup 0) or dd (1)
    float qv[kN / 2];
    int qid[kN / 2];
#pragma unroll
    for (int j = 0; j < kT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = q0 + 8 * j + 2 * t + e;
        const size_t rb = ((size_t)b * nh + h) * S + q;
        const bool in = q < S;
        qv[2 * j + e] = in ? (wg ? dd[rb] : lse[rb]) : 0.f;
        qid[2 * j + e] = in && !wg ? qsb[q] : 0;
      }
    wgmma_wait<0>();  // this tile's logits
    fence_acc();
    lf32_release(&empty[nat], lane);
    if (n > 0 && n % kFlush == 0)
      lf32_flush<D>(out_rows, acc, t, n == kFlush, 1.f);
    // p^T (0) or ds^T (1), split into the A operand of k-step j: register
    // 2 e + hf holds key row g + 8 hf, query 8 j + 2 t + e
    uint32_t fh[kT / 8][4], fl[kT / 8][4];
    float* pxb = px + pb * kN * 128;
    if (wg == 0) {
      const int use = n >> 1;  // buffer pb's use count
      mbar_wait(&pempty[pb], (use & 1) ^ 1);
#pragma unroll
      for (int x = 0; x < kN; ++x) {
        const int j = x >> 2, hf = (x >> 1) & 1, e = x & 1;
        float v = ch[0][x];
#pragma unroll
        for (int c = 1; c < kLf32Chains; ++c) v += ch[c][x];
        const int q = q0 + 8 * j + 2 * t + e;
        const bool ok = key[hf] < S && q < S && qid[2 * j + e] == kid[hf] &&
                        (!causal || key[hf] <= q);
        const float p = ok ? expf(v * scale - qv[2 * j + e]) : 0.f;
        pxb[x * 128 + t128] = p;
        tf32_split(p, fh[j][2 * e + hf], fl[j][2 * e + hf]);
      }
      lf32_release(&pfull[pb], lane);
    } else {
      mbar_wait(&pfull[pb], (n >> 1) & 1);
#pragma unroll
      for (int x = 0; x < kN; ++x) {
        const int j = x >> 2, hf = (x >> 1) & 1, e = x & 1;
        float v = ch[0][x];
#pragma unroll
        for (int c = 1; c < kLf32Chains; ++c) v += ch[c][x];
        const float ds = pxb[x * 128 + t128] * (v - qv[2 * j + e]);
        tf32_split(ds, fh[j][2 * e + hf], fl[j][2 * e + hf]);
      }
      lf32_release(&pempty[pb], lane);
    }
    mbar_wait(&full[trn], ph);
    fence_acc();
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {  // dV += p^T do, or dK += ds^T q
      const uint64_t bh = lf32_tr_desc<kT>(buf(trn), j);
      const uint64_t bl = lf32_tr_desc<kT>(buf(trn) + kBuf / 2, j);
      lf32_rs<D>(acc, fh[j], bl);
      lf32_rs<D>(acc, fl[j], bh);
      lf32_rs<D>(acc, fh[j], bh);
    }
    wgmma_commit();
    w.next();
    if (w.valid()) {  // the next tile's logits, issued behind these
      mbar_wait(&full[nat], (n + 1) & 1);
      issue_logits();
      wgmma_wait<1>();  // dV or dK done, its buffer free while they run
    } else {
      wgmma_wait<0>();
    }
    fence_acc();
    lf32_release(&empty[trn], lane);
  }
  wgmma_wait<0>();
  fence_acc();
  lf32_flush<D>(out_rows, acc, t, n <= kFlush, wg ? scale : 1.f);
}

// ---- bf16: wgmma + TMA (see the note at the top) -------------------------

constexpr int kBwdStages = 3;
constexpr int kBwdThreads = 384;  // two consumer warpgroups + a producer

// The block's shared memory: 1024 bytes to align the tiles; k then v of the
// block's 64 keys (two halves each); the stages, each q then do of 64
// queries; p^T twice then ds^T twice, [64 keys][64 queries] bf16 in the
// 128-byte swizzle; each warpgroup's dq partial [64 x D/2] f32 (in the
// scratch's fragment order); the stages' lse (times log2 e), dd and query segment
// ids [kBwdStages][64] each; the mbarriers (full and empty a stage, one for
// k and v).
template <int D>
struct BwdLayout {
  using T = LlmTiles<D>;
  static constexpr int kKV = 2 * T::kTile;
  static constexpr int kStage = 2 * T::kTile;
  static constexpr int kPD = kLlmTile * 128;
  static constexpr int kDq = kLlmTile * T::kHalf * 4;  // a dq partial
  static constexpr int kMeta = 3 * kBwdStages * kLlmTile * 4;
  static constexpr int kSmem = 1024 + kKV + kBwdStages * kStage + 4 * kPD +
                               2 * kDq + kMeta + (2 * kBwdStages + 1) * 8;
  static_assert(kSmem <= 232448, "one block");
};

struct LlmBwdMaps {
  CUtensorMap q, k, v, g;
};

// grid (nkv * ceil(S / 64), B), kBwdThreads threads; q, k, v, do through
// maps (3-D: columns, S, B); lse, dd [B, nh, S]; dq_acc f32, zeroed, in
// chunks [B][nh][ceil(S / 64)][2 halves of D][64 x D/2] in fragment order
// (llm_bwd_convert); dk, dv [B, S, nkv, D]
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    llm_bwd_sm90(const __grid_constant__ LlmBwdMaps maps,
                 const int* __restrict__ qseg, const int* __restrict__ kseg,
                 const float* __restrict__ lse, const float* __restrict__ dd,
                 float* __restrict__ dq_acc, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int S, int nh, int nkv, int causal,
                 float scale) {
  using T = LlmTiles<D>;
  using L = BwdLayout<D>;
  constexpr int kH = T::kHalf, kW = T::kRowBytes, kHB = T::kHalfBytes;
  constexpr int kAcc = kH / 2;  // accumulator registers of a half's product
  extern __shared__ unsigned char smraw[];
  unsigned char* base = align1024(smraw);
  unsigned char* ktile = base;                         // halves 0, 1
  unsigned char* vtile = base + T::kTile;
  unsigned char* stages = base + L::kKV;               // [s]: q, do
  unsigned char* pds = stages + kBwdStages * L::kStage;  // p^T x2, ds^T x2
  float* dqs = reinterpret_cast<float*>(pds + 4 * L::kPD);  // [wg][64 D/2]
  float* lse2s = dqs + 2 * kLlmTile * kH;                    // [s][64]
  float* dds = lse2s + kBwdStages * kLlmTile;
  int* qsegs = reinterpret_cast<int*>(dds + kBwdStages * kLlmTile);
  uint64_t* full = reinterpret_cast<uint64_t*>(qsegs + kBwdStages * kLlmTile);
  uint64_t* empty = full + kBwdStages;
  uint64_t* kvbar = empty + kBwdStages;
  const auto q_half = [&](int s, int hf) {
    return stages + s * L::kStage + hf * kHB;
  };
  const auto g_half = [&](int s, int hf) {
    return stages + s * L::kStage + T::kTile + hf * kHB;
  };
  __shared__ SegTiles tiles;

  const int tid = threadIdx.x, wg = tid / 128;
  const int hk = blockIdx.x % nkv, b = blockIdx.y;
  const int k0 = blockIdx.x / nkv * kB;
  const int NT = (S + kB - 1) / kB;
  const int group = nh / nkv;
  const int* qsb = qseg + (size_t)b * S;
  const int* ksb = kseg + (size_t)b * S;
  const int qt0 = causal ? k0 / kB : 0;
  if (tid == 0) {  // k and v load while the block finds its query tiles
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 1 + kB);  // the TMA's expect_tx + 64 copiers
      mbar_init(&empty[s], 2);      // released by both warpgroups
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(kvbar, 2 * T::kTile);
    for (int hf = 0; hf < 2; ++hf) {
      tma_load_3d(ktile + hf * kHB, &maps.k, kvbar, hk * D + hf * kH, k0, b);
      tma_load_3d(vtile + hf * kHB, &maps.v, kvbar, hk * D + hf * kH, k0, b);
    }
  }
  seg_own_ids(tiles, ksb, k0, S, tid);  // synchronises: the barriers exist
  seg_mark_live<4>(tiles, qsb, qt0, NT, S, tid, kBwdThreads);

  if (wg == 2) {  // the producer warpgroup: its first 64 threads work
    producer_registers();
    const int p = tid - 256;
    if (p >= kB) return;
    int i = 0;
    for (int h = hk * group; h < (hk + 1) * group; ++h)
    for (int qt = seg_next_live(tiles, qt0, NT); qt < NT;
         qt = seg_next_live(tiles, qt + 1, NT), ++i) {
      const float* lse_h = lse + ((size_t)b * nh + h) * S;
      const float* dd_h = dd + ((size_t)b * nh + h) * S;
      const int s = i % kBwdStages, ph = (i / kBwdStages) & 1;
      mbar_wait(&empty[s], ph ^ 1);
      const int q0 = qt * kB;
      if (p == 0) {
        mbar_expect_tx(&full[s], 2 * T::kTile);
        for (int hf = 0; hf < 2; ++hf) {
          tma_load_3d(q_half(s, hf), &maps.q, &full[s], h * D + hf * kH, q0,
                      b);
          tma_load_3d(g_half(s, hf), &maps.g, &full[s], h * D + hf * kH, q0,
                      b);
        }
      }
      const int r = q0 + p;
      const bool in = r < S;
      lse2s[s * kB + p] = in ? lse_h[r] * kLlmLog2e : 0.f;
      dds[s * kB + p] = in ? dd_h[r] : 0.f;
      qsegs[s * kB + p] = in ? qsb[r] : 0;
      mbar_arrive(&full[s]);
    }
    return;
  }
  consumer_registers();

  // consumer warpgroup wg: a thread holds keys (rows) g and g + 8 of its
  // warp's 16; of a query tile, queries 32 wg + 8 j + 2 t, + 1 (j < 4) in
  // S^T and dP^T; of the outputs, columns wg D/2 + 8 j + 2 t, + 1
  const int t128 = tid & 127, lane = tid & 31, wr = t128 >> 5;
  const int g = lane >> 2, t = lane & 3;
  int kl[2], key[2], kid[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    kl[hf] = wr * 16 + g + 8 * hf;
    key[hf] = k0 + kl[hf];
    kid[hf] = key[hf] < S ? ksb[key[hf]] : 0;
  }
  const float sl = scale * kLlmLog2e;
  float sacc[16], dpacc[16], dvacc[kAcc], dkacc[kAcc], dqacc[kAcc];
#pragma unroll
  for (int c = 0; c < 16; ++c) sacc[c] = dpacc[c] = 0.f;
#pragma unroll
  for (int c = 0; c < kAcc; ++c) dvacc[c] = dkacc[c] = dqacc[c] = 0.f;
  // the accumulators are only ever defined by the products from here on
  const auto fence_acc = [&] {
    reg_fence(sacc);
    reg_fence(dpacc);
    reg_fence(dvacc);
    reg_fence(dkacc);
    reg_fence(dqacc);
  };
  mbar_wait(kvbar, 0);

  int i = 0;
  for (int h = hk * group; h < (hk + 1) * group; ++h)
  for (int qt = seg_next_live(tiles, qt0, NT); qt < NT;
       qt = seg_next_live(tiles, qt + 1, NT), ++i) {
    const int s = i % kBwdStages, ph = (i / kBwdStages) & 1, buf = i & 1;
    const int q0 = qt * kB;
    mbar_wait(&full[s], ph);
    // S^T = k q^T and dP^T = v do^T against this warpgroup's 32 queries
    fence_acc();
    wgmma_fence();
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int ks = 0; ks < kH / 16; ++ks) {
        wgmma_n32_ss<0, 0>(sacc, swz_desc<kW>(ktile + hf * kHB + 32 * ks),
                           swz_desc<kW>(q_half(s, hf) + wg * 32 * kW + 32 * ks),
                           hf + ks > 0);
        wgmma_n32_ss<0, 0>(dpacc, swz_desc<kW>(vtile + hf * kHB + 32 * ks),
                           swz_desc<kW>(g_half(s, hf) + wg * 32 * kW + 32 * ks),
                           hf + ks > 0);
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc();

    // p^T and ds^T, a pair of queries at a time, rounded once into the
    // shared tiles (row kl, 16-byte chunk q / 8 swizzled by kl & 7)
    const float* ls = lse2s + s * kB;
    const float* dl = dds + s * kB;
    const int* qs = qsegs + s * kB;
    unsigned char* pt = pds + buf * L::kPD;
    unsigned char* dt = pds + (2 + buf) * L::kPD;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ql = wg * 32 + 8 * j + 2 * t;
      const float2 lv = *reinterpret_cast<const float2*>(ls + ql);
      const float2 dv = *reinterpret_cast<const float2*>(dl + ql);
      const int2 sg = *reinterpret_cast<const int2*>(qs + ql);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qrow = q0 + ql + e, c = 4 * j + 2 * hf + e;
          const bool ok = key[hf] < S && qrow < S &&
                          (e ? sg.y : sg.x) == kid[hf] &&
                          (!causal || key[hf] <= qrow);
          p[e] = ok ? ex2_ftz(fmaf(sacc[c], sl, -(e ? lv.y : lv.x))) : 0.f;
          ds[e] = p[e] * (dpacc[c] - (e ? dv.y : dv.x));
        }
        const int off =
            kl[hf] * 128 + (((ql >> 3) ^ (kl[hf] & 7)) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(pt + off) = pack_bf16(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(dt + off) = pack_bf16(ds[0], ds[1]);
      }
    }
    fence_proxy_async();
    named_bar_sync(1, 256);  // both warpgroups' queries written

    // dV += P^T do, dK += dS^T q on columns wg D/2 ..; dQ = dS k likewise
    fence_acc();
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wgmma_ss<kH, 0, 1>(dvacc, swz_desc<128>(pt + 32 * ks),
                         swz_desc<kW>(g_half(s, wg) + ks * 16 * kW), 1);
      wgmma_ss<kH, 0, 1>(dkacc, swz_desc<128>(dt + 32 * ks),
                         swz_desc<kW>(q_half(s, wg) + ks * 16 * kW), 1);
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss<kH, 1, 1>(dqacc, swz_desc<128>(dt + ks * 16 * 128),
                         swz_desc<kW>(ktile + wg * kHB + ks * 16 * kW),
                         ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc();
    if (t128 == 0) mbar_arrive(&empty[s]);
    // this warpgroup's dq partial, staged in shared memory in fragment
    // order, added to its scratch chunk by one bulk reduction
    float* stage_dq = dqs + wg * kLlmTile * kH;
    if (t128 == 0) bulk_wait_read<0>();  // the last reduction has read it
    named_bar_sync(2 + wg, 128);
#pragma unroll
    for (int j = 0; j < kH / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(stage_dq +
                                   ((j * 2 + hf) * 128 + t128) * 2) =
            make_float2(dqacc[4 * j + 2 * hf], dqacc[4 * j + 2 * hf + 1]);
    fence_proxy_async();
    named_bar_sync(2 + wg, 128);
    if (t128 == 0) {
      const size_t chunk = (((size_t)b * nh + h) * NT + qt) * 2 + wg;
      bulk_reduce_add_f32(dq_acc + chunk * kLlmTile * kH, stage_dq,
                          kLlmTile * kH * 4);
      bulk_commit();
    }
  }
  if (t128 == 0) bulk_wait<0>();
  // dk (times D^-1/2) and dv of the block's keys, summed over the group
  const size_t ldk = (size_t)nkv * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (key[hf] >= S) continue;
    const size_t off = ((size_t)b * S + key[hf]) * ldk + (size_t)hk * D +
                       wg * kH + 2 * t;
#pragma unroll
    for (int j = 0; j < kH / 8; ++j) {
      const int c = 4 * j + 2 * hf;
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
          __floats2bfloat162_rn(dkacc[c] * scale, dkacc[c + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
          __floats2bfloat162_rn(dvacc[c], dvacc[c + 1]);
    }
  }
}

// dq [B, S, nh, D] = bf16(acc * scale) from the scratch's chunks, eight
// values (16 bytes of a row) a thread a step. Pair u of chunk c (b, h,
// query tile, half w) is thread t128 = u % 128's columns 8 j + 2 t, + 1 of
// row g + 8 hf of its warp's 16, (j, hf) = (u / 256, u / 128 % 2): pairs
// 4 n .. 4 n + 3 are columns 8 j .. 8 j + 7 of one row. Neighbouring
// threads take neighbouring j, so a row's half is written whole.
__global__ void __launch_bounds__(256)
    llm_bwd_convert(const float4* __restrict__ acc, bf16* __restrict__ dq,
                    int B, int S, int nh, int D, float scale) {
  const int half = D / 2, nj = half / 8, octs = 8 * half;  // runs a chunk
  const int NT = (S + 63) / 64;
  const long long n = (long long)B * nh * NT * 2 * octs;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long c = i / octs;
    const int o = (int)(i - c * octs);
    const int j = o % nj, r = o / nj;  // r = hf * 32 + t128 / 4
    const int hf = r >> 5, t128 = (r & 31) * 4;
    const int w = (int)(c & 1), qt = (int)((c >> 1) % NT);
    const long long bh = (c >> 1) / NT;
    const int row = qt * 64 + (t128 >> 5) * 16 + ((t128 & 31) >> 2) + 8 * hf;
    if (row >= S) continue;
    const long long at = 2 * (c * octs + ((j * 2 + hf) * 128 + t128) / 4);
    const float4 a = acc[at], e = acc[at + 1];
    *reinterpret_cast<uint4*>(
        dq + (((bh / nh) * S + row) * nh + bh % nh) * D + w * half + 8 * j) =
        make_uint4(pack_bf16(a.x * scale, a.y * scale),
                   pack_bf16(a.z * scale, a.w * scale),
                   pack_bf16(e.x * scale, e.y * scale),
                   pack_bf16(e.z * scale, e.w * scale));
  }
}

template <class K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int HD>
int launch_sm90(const bf16* q, const bf16* k, const bf16* v, const int* qseg,
                const int* kseg, const bf16* dout, const float* lse,
                const float* dd, bf16* dq, bf16* dk, bf16* dv, float* scratch,
                int B, int S, int nh, int nkv, int causal, float scale,
                cudaStream_t st) {
  if (!scratch) return (int)cudaErrorInvalidValue;
  LlmBwdMaps maps;
  const long long cq = (long long)nh * HD, ck = (long long)nkv * HD;
  if (!make_llm_map(&maps.q, q, B, S, cq, HD / 2) ||
      !make_llm_map(&maps.k, k, B, S, ck, HD / 2) ||
      !make_llm_map(&maps.v, v, B, S, ck, HD / 2) ||
      !make_llm_map(&maps.g, dout, B, S, cq, HD / 2))
    return (int)cudaErrorInvalidValue;
  const long long nq = (long long)B * nh * ((S + kB - 1) / kB) * kB * HD;
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(float) * nq, st);
  if (err != cudaSuccess) return (int)err;
  constexpr int smem = BwdLayout<HD>::kSmem;
  static const int attr = set_smem(llm_bwd_sm90<HD>, smem);
  if (attr) return attr;
  const dim3 grid(nkv * ((S + kB - 1) / kB), B);
  llm_bwd_sm90<HD><<<grid, kBwdThreads, smem, st>>>(
      maps, qseg, kseg, lse, dd, scratch, dk, dv, S, nh, nkv, causal, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  llm_bwd_convert<<<132 * 8, 256, 0, st>>>(
      reinterpret_cast<const float4*>(scratch), dq, B, S, nh, HD, scale);
  return (int)cudaGetLastError();
}

// the split pre-pass into `scratch` (natural q, do, k, v and transposed q,
// do, k, hi and lo: B Sp D (8 nh + 6 nkv) floats), then the two kernels
template <int D>
int launch_tf32(const float* q, const float* k, const float* v,
                const int* qseg, const int* kseg, const float* dout,
                const float* lse, const float* dd, float* dq, float* dk,
                float* dv, float* scratch, int B, int S, int nh, int nkv,
                int causal, float scale, cudaStream_t st) {
  using L = Lf32BwdLayout<D>;
  const int NT = (S + kLf32Rows - 1) / kLf32Rows, Sp = NT * kLf32Rows;
  const long long pq = (long long)B * nh * Sp, pk = (long long)B * nkv * Sp;
  if (!scratch || 4 * (pq + pk) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  float* nat = scratch;  // q, do, k, v (hi, lo each)
  float* tr = nat + 4 * (pq + pk) * D;  // q^T, do^T, k^T
  int e;
  if ((e = lf32_split<D>(q, B, S, Sp, nh, 1.f, nat, tr, st)) ||
      (e = lf32_split<D>(dout, B, S, Sp, nh, 1.f, nat + 2 * pq * D,
                         tr + 2 * pq * D, st)) ||
      (e = lf32_split<D>(k, B, S, Sp, nkv, 1.f, nat + 4 * pq * D,
                         tr + 4 * pq * D, st)) ||
      (e = lf32_split<D>(v, B, S, Sp, nkv, 1.f, nat + (4 * pq + 2 * pk) * D,
                         nullptr, st)))
    return e;
  const long long nrows = 4 * (pq + pk), trows = (4LL * nh + 2 * nkv) * B * D;
  Lf32BwdMaps maps;
  if (!lf32_map(&maps.nat, nat, nrows, D, 32, L::kTile) ||
      !lf32_map(&maps.tr, tr, trows, Sp, L::kTile, D))
    return (int)cudaErrorInvalidValue;
  static const int attr_q = set_smem(llm_bwd_dq_tf32<D>, L::kDqSmem);
  static const int attr_kv = set_smem(llm_bwd_dkv_tf32<D>, L::kDkvSmem);
  if (attr_q) return attr_q;
  if (attr_kv) return attr_kv;
  llm_bwd_dq_tf32<D>
      <<<dim3(nh * NT, B), kLf32BwdThreads, L::kDqSmem, st>>>(
          maps, qseg, kseg, lse, dd, dq, S, nh, nkv, causal, scale);
  if ((e = (int)cudaGetLastError())) return e;
  llm_bwd_dkv_tf32<D>
      <<<dim3(nkv * NT, B), kLf32BwdThreads, L::kDkvSmem, st>>>(
          maps, qseg, kseg, lse, dd, dk, dv, S, nh, nkv, causal, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v,
           const int* qseg, const int* kseg, const void* dout,
           const float* lse, const float* dd, void* dq, void* dk, void* dv,
           float* scratch, int B, int S, int nh, int nkv, int causal,
           float scale, cudaStream_t st) {
  if (dtype == kF32) {
    using F = const float*;
    return launch_tf32<HD>(F(q), F(k), F(v), qseg, kseg, F(dout), lse, dd,
                           static_cast<float*>(dq), static_cast<float*>(dk),
                           static_cast<float*>(dv), scratch, B, S, nh, nkv,
                           causal, scale, st);
  }
  if (dtype == kBF16) {
    using H = const bf16*;
    return launch_sm90<HD>(H(q), H(k), H(v), qseg, kseg, H(dout), lse, dd,
                           static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                           static_cast<bf16*>(dv), scratch, B, S, nh, nkv,
                           causal, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ullsam

// Plain C entry point (loaded with ctypes). Returns 0 or a cudaError_t.
// dtype: 0 = float32, 1 = bfloat16 for q, k, v, do, dq, dk, dv; q_seg,
// kv_seg int32 [B, S]; lse, dd float32 [B, nh, S]; scale D^-1/2 (f32). In
// bf16, scratch is B nh Sp D floats (Sp = 64 ceil(S / 64); zeroed here,
// then dq's f32 sum); in float32 B Sp D (kLf32BwdQPlanes nh +
// kLf32BwdKvPlanes nkv) floats (the split planes). Requires D in {64, 128},
// nh % nkv == 0, S <= 64 * kMaxSegTiles and 16-byte aligned tensors.
extern "C" int llm_flash_attn_backward(
    int dtype, const void* q, const void* k, const void* v,
    const void* q_seg, const void* kv_seg, const void* dout, const void* lse,
    const void* dd, void* dq, void* dk, void* dv, void* scratch, int B, int S,
    int nh, int nkv, int D, int causal, float scale, void* stream) {
  using namespace ullsam;
  if (B < 1 || S < 1 || S > kSegTile * kMaxSegTiles || nkv < 1 ||
      nh % nkv != 0 || B > 65535 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* qs = static_cast<const int*>(q_seg);
  const int* ks = static_cast<const int*>(kv_seg);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dd);
  float* acc = static_cast<float*>(scratch);
  if (D == 64)
    return launch<64>(dtype, q, k, v, qs, ks, dout, l, d, dq, dk, dv, acc, B,
                      S, nh, nkv, causal, scale, st);
  if (D == 128)
    return launch<128>(dtype, q, k, v, qs, ks, dout, l, d, dq, dk, dv, acc,
                       B, S, nh, nkv, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
