// B9: gradient of the ViT global flash attention (B2) for Hopper (sm_90a).
//
// Replaces the TPU kernels ullsam_tpu/ops/pallas/flash_attention.py
// `_vit_bwd_dq_kernel` and `_vit_bwd_dkv_kernel` (via `_vit_flash_bwd_impl`).
// With bias[i, key] = rel_h[i, key / KW] + rel_w[i, key % KW], the forward's
// row logsumexp lse and dd = rowsum(do * o) (computed by the caller), it
// scores as the TPU kernels do, from unscaled q (:824-827):
//     s = f32(q k^T) * D^-1/2 + bias,  p = exp(s - lse),
//     ds = p (do v^T - dd)
//     dq = (ds k) * D^-1/2,  dk = (ds^T q) * D^-1/2,  dv = p^T do
//     drel_h[i, r] = sum_c ds[i, r*KW + c],  drel_w[i, c] = sum_r ds[i, ..]
// p and ds are rounded to the input dtype before their products; every sum
// is f32; drel is f32. (B2 scores with cast(q * D^-1/2), as the TPU forward
// does; the two agree bitwise at D = 64, where the scale is a power of two,
// and not at 80.)
//
// What bounds it on this card: operations. The gradient needs 5 products of
// 2 N^2 D per head (s, dp, dv, dq, dk): at the ViT-B global blocks (BH = 12,
// N = 4096, D = 64) ~129 GFLOP, at ViT-H's (BH = 16, D = 80) ~215 GFLOP,
// against ~50 / ~80 MB. Two kernels, as on the TPU, so that neither needs
// atomics and every call gives bitwise the same result; they do 7 products
// (s and dp in both), 7/5 of the needed work:
//   * dq + drel, query-major: a block owns 128 queries and walks the key
//     tiles. KW divides 64, so a 64-key tile is 64 / KW whole key-grid rows:
//     drel_h[:, row] is a row sum of the tile's ds (written once, no
//     accumulation), and drel_w accumulates ds in registers, one slot per
//     (row, key % 64), folded to key % KW at the end in a fixed order.
//   * dk + dv, key-major: a block owns 128 keys (128 / KW key-grid rows) and
//     walks the query tiles; its bias needs only those rows' rel_h columns
//     and the query tile's rel_w rows.
//
// bf16 (vit_bwd_dq_sm90, vit_bwd_dkv_sm90): B2's Hopper shape
// (flash_sm90.cuh: 64-row tiles, at D = 80 a 32-byte-swizzled 16-column
// tail). A block is two consumer warpgroups of 64 rows and a producer
// warpgroup that gives its registers to them (setmaxnreg 40 / 232) and
// streams tiles by TMA through a ring of kBwdStages stages (full / empty
// mbarriers, both consumers release a stage).
//   * dq: q and do of the block's 128 queries land once and are held as
//     register A operands. Per key tile, S = q k^T and dP = do v^T on wgmma
//     m64n64k16 (k and v K-major from the stage), p and ds in f32 registers
//     in the accumulator layout, ds rounded to bf16 once, a pair at a time,
//     into wgmma's register A operand of dQ += ds k (k read MN-major). The
//     drel sums add the rounded ds in registers: rel_h is one value a row a
//     tile and rel_w's pair for keys 8 i + 2 t, + 1 one 4-byte load (key %
//     KW, a fixed slot of the accumulator layout).
//   * dkv: k and v of the block's 128 keys land once and are held as
//     register A operands. Per query tile the stage holds q and do (TMA)
//     and, copied by the producer's threads, the tile's rel_w transposed (a
//     thread's two queries one 4-byte load), the block's rel_h columns, lse
//     and dd; S^T = k q^T and dP^T = v do^T on wgmma, then dV += P^T do and
//     dK += dS^T q with P^T and dS^T as register A operands.
//   * A tile's register-A products and the next tile's S and dP are issued
//     together and waited on together, so the tensor cores run them back to
//     back while the other warpgroup computes its p and ds. The
//     accumulators are pinned around each wgmma stage (reg_fence), so
//     ptxas does not serialize the products (C7515), and p comes from the
//     special-function unit's 2^x with subnormals flushed (ex2_ftz).
// On an H100 (PERF.md section 6) the pair runs at 200-240 TFLOP/s of its 7
// products, 2.1x the earlier mma.sync pair; fewer CUDA-core instructions a
// logit moved it most (reg_fence 6%, q / do / k / v in registers 2%, the
// paired loads and ex2_ftz 10%, one rounding a pair 3%); the warpgroups
// issuing in turns (FlashAttention-3's ping-pong) ran 12% slower.
// float32 (vit_bwd_split_f32, vit_bwd_dq_tf32, vit_bwd_dkv_tf32): the same
// two kernels on the tensor cores in split TF32 ("3xTF32", tf32.cuh). An f32
// operand x is hi = tf32(x) plus lo = tf32(x - hi) (cvt.rna; x - hi is exact
// in f32), and each of the 7 products is issued three times into one f32
// accumulator, A_hi B_lo and A_lo B_hi first, then A_hi B_hi. What is left
// out (A_lo B_lo and lo's own rounding) is near 2^-22 of each term, so the
// products keep the JAX f32 path's exact-parity precision
// (flash_attention.py:837-839) at 495 / 3 TFLOP/s, not the CUDA cores' 67.
// The tensor cores' accumulation is not IEEE's, though: each step can lose
// about half an ulp of the running sum, one way. So no accumulator runs a
// long chain: S and dP of dq sum their k-steps in two halves (12-15 steps
// each), dQ, dK and dV are added to their f32 output rows in device memory
// every kF32Flush tiles (the block owns them; round to nearest) and start
// again from zero. Against a float64 evaluation every output then errs
// within 2.5x of the plain f32 version's own (cuBLAS; one accumulator over
// the 4096 keys erred 14x on dq; a flush every 4 tiles, 1.8x, cost 5%).
// TF32 wgmma reads A and B from shared memory K-major only (its transpose
// flags exist for 16-bit types alone), and three products contract an
// operand along its rows (dq += ds k, dk += ds^T q, dv += p^T do). So a
// pre-pass (vit_bwd_split_f32) writes into scratch that the wrapper
// allocates the hi and lo planes of q, k, v and do as they are ([BH N][D])
// and of q, k and do transposed ([BH D][N]), each 8-key group of a
// transposed row in the order tf32_pi in which a register A operand made
// from an m64 accumulator holds its keys (0.14 ms at ViT-H). Both kernels
// read every shared-memory operand by TMA (32 columns a 128-byte-swizzled
// box, at D = 80 a 64-byte-swizzled tail of 16) and split only p and ds, in
// registers. A block is one consumer warpgroup of 64 rows and a producer
// warpgroup: with their lo planes the f32 tiles take four times bf16's
// shared memory, so the 64 fixed rows (q and do, or k and v, hi and lo) and
// 2-4 slots of 32-row tiles fill a block (F32Layout), and the tensor cores
// idle while the one consumer scores.
//   * dq: two rings, k and v (hi, lo) of a 32-key tile, released once S =
//     q k^T and dP = do v^T (m64n32k8, both operands from shared memory) are
//     done, and k^T (hi, lo), released once dQ += ds k (m64nDk8, ds the
//     register A operand) is: each load has a tile's time to land. rel_h and
//     rel_w of the thread's keys are read per tile under the products; the
//     drel sums stay on the CUDA cores (sums, not products), drel_w's in
//     shared memory, in a fixed order.
//   * dkv: per 32-query tile two ring items, q and do (hi, lo, with the
//     tile's rel_w transposed, rel_h columns, lse and dd, which the
//     producer's threads load before they wait for the slot and then store
//     into one of two rel buffers), then q^T and do^T; S^T = k q^T and dP^T
//     = v do^T with k and v fixed, then dV += p^T do and dK += ds^T q from
//     the transposed item.
// Neither kernel uses atomics: every call gives bitwise the same result.
// Head dims 64 (SAM ViT-B / L) and 80 (ViT-H) in both dtypes.
#include "flash_sm90.cuh"
#include "tf32.cuh"

namespace ullsam {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kB = 64;           // bf16: query / key tile
constexpr float kLog2e = 1.4426950408889634f;

// ---- float32: split TF32 on wgmma + TMA (see the note at the top) ---------

constexpr int kF32Rows = 64;      // queries (dq) or keys (dkv) of a block
constexpr int kF32Tile = 32;      // rows of a streamed tile
constexpr int kF32Threads = 256;  // a consumer and a producer warpgroup
constexpr int kF32MaxRows = 8;    // key-grid rows of a dkv block (KW >= 8)
constexpr int kF32RwLd = 40;      // dkv's rel_w rows [key % KW][query]
constexpr int kF32DrwSlots = 32;  // dq's drel_w sums a thread (KW = 64)

// The blocks' shared memory; must match ops/kernels/flash_attention.py
// bwd_f32_smem_bytes. An f32 plane of R rows holds columns 0-31 and 32-63
// as two 128-byte-swizzled boxes [R][128 bytes] and, at D = 80, columns
// 64-79 as a 64-byte-swizzled box [R][64 bytes]: R D 4 bytes. A transposed
// plane is one box [D][32 columns]: 128 D bytes, as much as a plane of 32
// rows.
// dq: q hi, q lo, do hi, do lo of the block's 64 queries; two rings of
// kDqStages slots, one of k hi, k lo, v hi, v lo (32 keys), released once S
// and dP are done, and one of k^T hi, k^T lo, released once dQ is; each
// consumer thread's drel_w sums [kF32DrwSlots][128] f32; full and empty
// mbarriers a slot, one for q and do.
// dkv: k hi, k lo, v hi, v lo of the block's 64 keys; the ring's slots of
// four planes (q hi, q lo, do hi, do lo of 32 queries, or their transposes);
// two rel buffers, each rel_w [64][kF32RwLd] (key % KW major), rel_h
// columns [kF32MaxRows][32], lse [32], dd [32] f32; full and empty a slot,
// one for k and v.
template <int D>
struct F32Layout {
  static_assert(D == 64 || D == 80, "head dims 64 and 80");
  static constexpr int kPlane64 = kF32Rows * D * 4;  // a plane of 64 rows
  static constexpr int kPlane32 = kF32Tile * D * 4;  // of 32 rows
  static constexpr int kFixed = 4 * kPlane64;
  static constexpr int kTr = 128 * D;
  static constexpr int kDqStages = D > 64 ? 2 : 3;
  static constexpr int kDkvSlots = D > 64 ? 3 : 4;
  static constexpr int kDkvSlot = 4 * kPlane32;
  static constexpr int kRelFloats =
      64 * kF32RwLd + kF32MaxRows * kF32Tile + 2 * kF32Tile;
  static constexpr int kDqSmem = 1024 + kFixed +
                                 kDqStages * (4 * kPlane32 + 2 * kTr) +
                                 kF32DrwSlots * 128 * 4 +
                                 (4 * kDqStages + 1) * 8;
  static constexpr int kDkvSmem = 1024 + kFixed + kDkvSlots * kDkvSlot +
                                  2 * kRelFloats * 4 + (2 * kDkvSlots + 1) * 8;
  static_assert(kTr == kPlane32, "a transposed plane fills a slot");
  static_assert(kDqSmem <= 232448 && kDkvSmem <= 232448, "one block");
};

// Position c of an 8-key group of a transposed plane holds key tf32_pi(c):
// the k order of a TF32 register A operand whose registers are taken from
// an m64 accumulator (k c and c + 4 of thread t: keys 2 t and 2 t + 1)
__host__ __device__ constexpr int tf32_pi(int c) {
  return c < 4 ? 2 * c : 2 * (c - 4) + 1;
}

// wgmma descriptor of a tile with the 64-byte swizzle: rows of 64 bytes,
// 8-row groups 512 bytes apart, K-major
__device__ __forceinline__ uint64_t sw64_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) | (2ull << 62);
}

// the descriptor of k-step ks (columns 8 ks .. 8 ks + 7) of an f32 plane of
// R rows
template <int R>
__device__ __forceinline__ uint64_t plane_desc(const unsigned char* p,
                                               int ks) {
  return ks < 8 ? sw128_desc(p + (ks >> 2) * R * 128 + (ks & 3) * 32)
                : sw64_desc(p + 2 * R * 128 + (ks - 8) * 32);
}

// d[64 x 32] (+)= A[64 x 8] . B[32 x 8]^T in TF32, A and B K-major in
// shared memory
__device__ __forceinline__ void wgmma_tf32_m64n32k8_ss(
    float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}"
      ", %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 8] . B[64 x 8]^T in TF32: A from registers
// (tf32 values in the m64k8 fragment layout), B K-major in shared
// memory
__device__ __forceinline__ void wgmma_tf32_m64n64k8_rs(
    float* d, const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d[64 x 80] (+)= A[64 x 8] . B[80 x 8]^T in TF32: A from registers
// (tf32 values in the m64k8 fragment layout), B K-major in shared
// memory
__device__ __forceinline__ void wgmma_tf32_m64n80k8_rs(
    float* d, const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39}"
      ", {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}


template <int D>
__device__ __forceinline__ void wgmma_tf32_out(float* d, const uint32_t* a,
                                               uint64_t db, int accumulate) {
  if constexpr (D == 64)
    wgmma_tf32_m64n64k8_rs(d, a, db, accumulate);
  else
    wgmma_tf32_m64n80k8_rs(d, a, db, accumulate);
}

// The tensor cores' f32 accumulation is not IEEE's: each product added
// loses up to about half an ulp of the running sum, one way (measured on an
// H100: dQ summed over 4096 keys in one accumulator, 1536 wgmma steps, erred
// 3.6e-5 of max|dq| against float64, the f32 plain version 2.6e-6). So an
// accumulator of dQ, dK or dV sums kF32Flush tiles (12 kF32Flush steps),
// then the thread adds it to its rows of the f32 output in device memory
// (round to nearest; the block owns those rows) and restarts from zero.
constexpr int kF32Flush = 8;

// out[row g + 8 hf][column 8 i + 2 t, + 1] (+)= acc * mul for the thread's
// two rows (row pointers `rows`) of an m64nD accumulator
template <int D>
__device__ __forceinline__ void flush_rows(float* const (&rows)[2],
                                           const float* acc, int t,
                                           bool first, float mul) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      float2* o = reinterpret_cast<float2*>(rows[hf] + 8 * i + 2 * t);
      const float2 v = first ? make_float2(0.f, 0.f) : *o;
      *o = make_float2((v.x + acc[4 * i + 2 * hf]) * mul,
                       (v.y + acc[4 * i + 2 * hf + 1]) * mul);
    }
}

// the TMA maps of the split planes: `nat` [8 BH N][D] (q, k, v, do; hi then
// lo) in 32-column boxes of 32 rows, `tail` its columns 64-79 (D = 80),
// `tr` [6 BH D][N] (q, k, do transposed; hi then lo) in boxes of D rows by
// 32 columns
struct F32Maps {
  CUtensorMap nat, tail, tr;
};

inline bool make_f32_map(CUtensorMap* map, const void* p, long long rows,
                         long long cols, int box_cols, int box_rows,
                         CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(p),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// map row `row` .. + 31 of the natural planes into rows r0 .. r0 + 31 of
// the plane of R rows at p
template <int D, int R>
__device__ __forceinline__ void load_rows(unsigned char* p, int r0,
                                          const F32Maps& m, uint64_t* bar,
                                          int row) {
  tma_load_2d(p + r0 * 128, &m.nat, bar, 0, row);
  tma_load_2d(p + R * 128 + r0 * 128, &m.nat, bar, 32, row);
  if constexpr (D > 64)
    tma_load_2d(p + 2 * R * 128 + r0 * 64, &m.tail, bar, 64, row);
}

// grid (N / 32, BH, 4): 32 rows of head blockIdx.y of q, k, v or do
// (blockIdx.z) split into hi and lo, as they are (nat plane 2 z, 2 z + 1)
// and, but for v, transposed (tr planes 2 z', 2 z' + 1; z' = 0, 1, 2 for
// q, k, do) with the keys of each 8-group in tf32_pi order
template <int D>
__global__ void __launch_bounds__(256)
    vit_bwd_split_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout, float* __restrict__ nat,
                      float* __restrict__ tr, int BH, int N) {
  __shared__ float tile[kF32Tile][D + 1];
  const int z = blockIdx.z, bh = blockIdx.y, r0 = blockIdx.x * kF32Tile;
  const float* src = z == 0 ? q : z == 1 ? k : z == 2 ? v : dout;
  const size_t plane = (size_t)BH * N * D;
  const size_t off = ((size_t)bh * N + r0) * D;
  float* hi = nat + 2 * z * plane;
  for (int e = threadIdx.x; e < kF32Tile * D; e += 256) {
    const float x = src[off + e];
    uint32_t h, l;
    tf32_split(x, h, l);
    hi[off + e] = __uint_as_float(h);
    hi[plane + off + e] = __uint_as_float(l);
    tile[e / D][e % D] = x;
  }
  if (z == 2) return;  // v is contracted along d only
  __syncthreads();
  float* thi = tr + 2 * (z == 3 ? 2 : z) * plane;
  for (int e = threadIdx.x; e < D * kF32Tile; e += 256) {
    const int d = e / kF32Tile, c = e % kF32Tile;
    const float x = tile[(c & ~7) + tf32_pi(c & 7)][d];
    uint32_t h, l;
    tf32_split(x, h, l);
    const size_t o = ((size_t)bh * D + d) * N + r0 + c;
    thi[o] = __uint_as_float(h);
    thi[plane + o] = __uint_as_float(l);
  }
}

// grid (N / 64, BH), kF32Threads threads: dq and drel of 64 queries.
// rel_h [BH, N, KH], rel_w [BH, N, KW], lse, dd [BH, N] f32; the split
// planes through `maps`; KW = kKW divides 64
template <int D, int kKW>
__global__ void __launch_bounds__(kF32Threads, 1)
    vit_bwd_dq_tf32(const __grid_constant__ F32Maps maps,
                    const float* __restrict__ rel_h,
                    const float* __restrict__ rel_w,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd, float* __restrict__ dq,
                    float* __restrict__ drel_h, float* __restrict__ drel_w,
                    int BH, int N, int KH, float scale) {
  using L = F32Layout<D>;
  constexpr int kStages = L::kDqStages;
  constexpr int kP32 = L::kPlane32, kP64 = L::kPlane64;
  // a key-grid row spans kHalves tiles, or a tile spans kRpt rows
  constexpr int kHalves = kKW > kF32Tile ? kKW / kF32Tile : 1;
  constexpr int kRpt = kKW > kF32Tile ? 1 : kF32Tile / kKW;
  extern __shared__ unsigned char smraw[];
  unsigned char* base = align1024(smraw);  // q hi, q lo, do hi, do lo
  unsigned char* nats = base + L::kFixed;             // k, v rows
  unsigned char* trs = nats + kStages * 4 * kP32;      // k^T
  // drel_w sums: slot j of consumer thread tid at DRW[j * 128 + tid]
  float* DRW = reinterpret_cast<float*>(trs + kStages * 2 * L::kTr);
  uint64_t* full = reinterpret_cast<uint64_t*>(DRW + kF32DrwSlots * 128);
  uint64_t* empty = full + kStages;
  uint64_t* full_t = empty + kStages;
  uint64_t* empty_t = full_t + kStages;
  uint64_t* qbar = empty_t + kStages;
  // slot s: k hi, k lo, v hi, v lo (i = 0..3); k^T hi, lo (j = 0, 1)
  const auto st = [&](int s, int i) { return nats + (s * 4 + i) * kP32; };
  const auto stt = [&](int s, int j) { return trs + (s * 2 + j) * L::kTr; };

  const int tid = threadIdx.x, bh = blockIdx.y, q0 = blockIdx.x * kF32Rows;
  const int NT = N / kF32Tile, rows = BH * N;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
      mbar_init(&full_t[s], 1);
      mbar_init(&empty_t[s], 1);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warpgroup: one thread issues
    if (tid == 128) {
      mbar_expect_tx(qbar, L::kFixed);
      const int planes[4] = {0, 1, 6, 7};  // q hi, q lo, do hi, do lo
      for (int i = 0; i < 4; ++i)
        for (int h = 0; h < 2; ++h)
          load_rows<D, kF32Rows>(base + i * kP64, 32 * h, maps, qbar,
                                 planes[i] * rows + bh * N + q0 + 32 * h);
      int s = 0, ph = 0;
      for (int kt = 0; kt < NT; ++kt) {
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], 4 * kP32);
        for (int i = 0; i < 4; ++i)  // nat planes 2-5: k hi, lo, v hi, lo
          load_rows<D, kF32Tile>(st(s, i), 0, maps, &full[s],
                                 (2 + i) * rows + bh * N + kt * kF32Tile);
        mbar_wait(&empty_t[s], ph ^ 1);
        mbar_expect_tx(&full_t[s], 2 * L::kTr);
        for (int j = 0; j < 2; ++j)  // tr planes 2, 3: k^T hi, lo
          tma_load_2d(stt(s, j), &maps.tr, &full_t[s], kt * kF32Tile,
                      (2 + j) * BH * D + bh * D);
        if (++s == kStages) s = 0, ph ^= 1;
      }
    }
    return;
  }

  // the consumer warpgroup: warp wr rows 16 wr .., a thread rows g, g + 8
  const int lane = tid & 31, wr = tid >> 5, g = lane >> 2, t = lane & 3;
  size_t grow[2];
  float lse_r[2], dd_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    grow[hf] = (size_t)bh * N + q0 + wr * 16 + g + 8 * hf;
    lse_r[hf] = lse[grow[hf]];
    dd_r[hf] = dd[grow[hf]];
  }
  float* const dq_rows[2] = {dq + grow[0] * D, dq + grow[1] * D};
  for (int j = 0; j < kF32DrwSlots; ++j) DRW[j * 128 + tid] = 0.f;
  // S and dP each in two accumulators, k-steps [0, D / 16) and [D / 16,
  // D / 8): the tensor cores' accumulation loses up to about half an ulp a
  // step, one way, and the halves keep each chain short
  float sacc[16], sacc2[16], dpacc[16], dpacc2[16], qacc[D / 2], rs[2][kRpt];
#pragma unroll
  for (int i = 0; i < 16; ++i) sacc[i] = sacc2[i] = dpacc[i] = dpacc2[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) qacc[i] = 0.f;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int r = 0; r < kRpt; ++r) rs[hf][r] = 0.f;
  const auto fence_acc = [&] {
    reg_fence(sacc);
    reg_fence(sacc2);
    reg_fence(dpacc);
    reg_fence(dpacc2);
    reg_fence(qacc);
  };

  // S = q k^T and dP = do v^T of the slot's 32 keys, in split TF32
  const auto issue_sdp = [&](int s) {
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const uint64_t qh = plane_desc<kF32Rows>(base, ks);
      const uint64_t ql = plane_desc<kF32Rows>(base + kP64, ks);
      const uint64_t gh = plane_desc<kF32Rows>(base + 2 * kP64, ks);
      const uint64_t gl = plane_desc<kF32Rows>(base + 3 * kP64, ks);
      const uint64_t kh = plane_desc<kF32Tile>(st(s, 0), ks);
      const uint64_t kl = plane_desc<kF32Tile>(st(s, 1), ks);
      const uint64_t vh = plane_desc<kF32Tile>(st(s, 2), ks);
      const uint64_t vl = plane_desc<kF32Tile>(st(s, 3), ks);
      const bool second = ks >= D / 16;
      const int acc = ks != 0 && ks != D / 16;
      float* sa = second ? sacc2 : sacc;
      float* da = second ? dpacc2 : dpacc;
      wgmma_tf32_m64n32k8_ss(sa, qh, kl, acc);
      wgmma_tf32_m64n32k8_ss(sa, ql, kh, 1);
      wgmma_tf32_m64n32k8_ss(sa, qh, kh, 1);
      wgmma_tf32_m64n32k8_ss(da, gh, vl, acc);
      wgmma_tf32_m64n32k8_ss(da, gl, vh, 1);
      wgmma_tf32_m64n32k8_ss(da, gh, vh, 1);
    }
  };

  mbar_wait(qbar, 0);
  mbar_wait(&full[0], 0);
  fence_acc();
  wgmma_fence();
  issue_sdp(0);
  wgmma_commit();
  for (int kt = 0; kt < NT; ++kt) {
    const int s = kt % kStages;
    const int h = kHalves > 1 ? kt % kHalves : 0;
    // rel_h of the tile's key-grid rows and rel_w of the thread's keys 32 h
    // + 8 i + 2 t + e (mod KW), loaded under the products
    float rh[2][kRpt], rw[2][8];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int r = 0; r < kRpt; ++r)
        rh[hf][r] = rel_h[grow[hf] * KH + (kHalves > 1 ? kt / kHalves
                                                      : kt * kRpt + r)];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 w = *reinterpret_cast<const float2*>(
            rel_w + grow[hf] * kKW + (32 * h + 8 * i + 2 * t) % kKW);
        rw[hf][2 * i] = w.x;
        rw[hf][2 * i + 1] = w.y;
      }
    }
    wgmma_wait<0>();  // S, dP of tile kt, and dQ of tile kt - 1
    fence_acc();
    if (tid == 0) {
      mbar_arrive(&empty[s]);
      if (kt > 0) mbar_arrive(&empty_t[(kt - 1) % kStages]);
    }
    if (kt > 0 && kt % kF32Flush == 0)
      flush_rows<D>(dq_rows, qacc, t, kt == kF32Flush, 1.f);
    // p and ds of keys 8 i + 2 t + e, rows g + 8 hf (accumulator slot
    // 4 i + 2 hf + e); ds split into the A operand of k-step i, whose
    // register 2 e + hf holds row g + 8 hf, key 2 t + e (tf32_pi)
    uint32_t dh[4][4], dl[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = kKW >= kF32Tile ? 0 : i * 8 / kKW;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 4 * i + 2 * hf + e;
          const float bias = rh[hf][r] + rw[hf][2 * i + e];
          const float sv = sacc[c] + sacc2[c];
          const float p = expf(sv * scale + bias - lse_r[hf]);
          const float ds = p * (dpacc[c] + dpacc2[c] - dd_r[hf]);
          // drel_w slot of key 32 h + 8 i + 2 t + e (its own slot a tile
          // when KW = 64; folded at the end when KW < 64)
          DRW[(16 * h + c) * 128 + tid] += ds;
          rs[hf][r] += ds;
          tf32_split(ds, dh[i][2 * e + hf], dl[i][2 * e + hf]);
        }
    }
    mbar_wait(&full_t[s], (kt / kStages) & 1);
    fence_acc();
    wgmma_fence();
    const int restart = kt % kF32Flush == 0;  // a new partial dQ
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t bh_ = sw128_desc(stt(s, 0) + 32 * j);
      const uint64_t bl = sw128_desc(stt(s, 1) + 32 * j);
      wgmma_tf32_out<D>(qacc, dh[j], bl, j > 0 || !restart);
      wgmma_tf32_out<D>(qacc, dl[j], bh_, 1);
      wgmma_tf32_out<D>(qacc, dh[j], bh_, 1);
    }
    // the next tile's S and dP; after the last tile an S and dP on this
    // tile's slot (released, but no load follows), unread, keeps the
    // accumulators' pipeline free of branches
    const int s1 = kt + 1 < NT ? (kt + 1) % kStages : s;
    if (kt + 1 < NT) mbar_wait(&full[s1], ((kt + 1) / kStages) & 1);
    issue_sdp(s1);
    wgmma_commit();
    // drel_h of the grid rows the tile completes: the quad's sums
    if (kHalves == 1 || h == kHalves - 1) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int r = 0; r < kRpt; ++r) {
          float a = rs[hf][r];
          a += __shfl_xor_sync(0xffffffffu, a, 1);
          a += __shfl_xor_sync(0xffffffffu, a, 2);
          if (t == 0)
            drel_h[grow[hf] * KH +
                   (kHalves > 1 ? kt / kHalves : kt * kRpt + r)] = a;
          rs[hf][r] = 0.f;
        }
    }
  }
  wgmma_wait<0>();
  fence_acc();
  flush_rows<D>(dq_rows, qacc, t, NT <= kF32Flush, scale);

  // drel_w: slots i fold to i % kPer
  constexpr int kPer = kKW >= kF32Tile ? 4 : kKW / 8;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float* dw = drel_w + grow[hf] * kKW;
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      float fold[kPer][2];
#pragma unroll
      for (int j = 0; j < kPer; ++j) fold[j][0] = fold[j][1] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          fold[i % kPer][e] += DRW[(16 * h + 4 * i + 2 * hf + e) * 128 + tid];
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        *reinterpret_cast<float2*>(dw + 32 * h + 8 * j + 2 * t) =
            make_float2(fold[j][0], fold[j][1]);
    }
  }
}

// grid (N / 64, BH), kF32Threads threads: dk and dv of 64 keys (key-grid
// rows k0 / KW ..); the arguments as vit_bwd_dq_tf32's
template <int D, int kKW>
__global__ void __launch_bounds__(kF32Threads, 1)
    vit_bwd_dkv_tf32(const __grid_constant__ F32Maps maps,
                     const float* __restrict__ rel_h,
                     const float* __restrict__ rel_w,
                     const float* __restrict__ lse,
                     const float* __restrict__ dd, float* __restrict__ dk,
                     float* __restrict__ dv, int BH, int N, int KH,
                     float scale) {
  using L = F32Layout<D>;
  constexpr int kSlots = L::kDkvSlots;
  constexpr int kP32 = L::kPlane32, kP64 = L::kPlane64;
  constexpr int kBlkRows = kF32Rows / kKW;  // the block's key-grid rows
  extern __shared__ unsigned char smraw[];
  unsigned char* base = align1024(smraw);  // k hi, k lo, v hi, v lo
  unsigned char* slots = base + L::kFixed;
  float* rel = reinterpret_cast<float*>(slots + kSlots * L::kDkvSlot);
  uint64_t* full = reinterpret_cast<uint64_t*>(rel + 2 * L::kRelFloats);
  uint64_t* empty = full + kSlots;
  uint64_t* kvbar = empty + kSlots;
  // item 2 qt: q hi, q lo, do hi, do lo of query tile qt (i = 0..3); item
  // 2 qt + 1: q^T hi, q^T lo, do^T hi, do^T lo
  const auto slot = [&](int a, int i) {
    return slots + (a % kSlots) * L::kDkvSlot + i * kP32;
  };
  // rel buffer of tile qt: rel_w [64][kF32RwLd], rel_h [kF32MaxRows][32],
  // lse [32], dd [32]
  const auto relbuf = [&](int qt) { return rel + (qt & 1) * L::kRelFloats; };
  constexpr int kRhOff = 64 * kF32RwLd, kLsOff = kRhOff + kF32MaxRows * 32;

  const int tid = threadIdx.x, bh = blockIdx.y, k0 = blockIdx.x * kF32Rows;
  const int NT = N / kF32Tile, rows = BH * N, kr0 = k0 / kKW;
  if (tid == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&full[s], 129);  // the TMA's expect_tx + 128 producers
      mbar_init(&empty[s], 4);   // each consumer warp
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warpgroup
    const int p = tid - 128;
    if (p == 0) {
      mbar_expect_tx(kvbar, L::kFixed);
      for (int i = 0; i < 4; ++i)  // nat planes 2-5: k hi, lo, v hi, lo
        for (int h = 0; h < 2; ++h)
          load_rows<D, kF32Rows>(base + i * kP64, 32 * h, maps, kvbar,
                                 (2 + i) * rows + bh * N + k0 + 32 * h);
    }
    // a thread's query p % 32, rel_w columns p / 32 + 4 j and rel_h rows
    // kr0 + p / 32 + 4 j of each tile
    const int qi = p % kF32Tile, c0 = p / kF32Tile;
    for (int a = 0; a < 2 * NT; ++a) {
      const int s = a % kSlots, qt = a >> 1;
      const size_t rq = (size_t)bh * N + qt * kF32Tile;
      // a query tile's rel rows, lse and dd: loaded before the wait, every
      // load issued before any store
      float w[kKW / 4], hr[(kBlkRows + 3) / 4], ls = 0.f, dv_ = 0.f;
      if (!(a & 1)) {
#pragma unroll
        for (int j = 0; j < kKW / 4; ++j)
          w[j] = rel_w[(rq + qi) * kKW + c0 + 4 * j];
#pragma unroll
        for (int j = 0; j < (kBlkRows + 3) / 4; ++j)
          hr[j] = c0 + 4 * j < kBlkRows
                      ? rel_h[(rq + qi) * KH + kr0 + c0 + 4 * j]
                      : 0.f;
        if (p < kF32Tile) {
          ls = lse[rq + p];
          dv_ = dd[rq + p];
        }
      }
      mbar_wait(&empty[s], ((a / kSlots) & 1) ^ 1);
      if (p == 0) {
        mbar_expect_tx(&full[s], L::kDkvSlot);
        if (a & 1) {
          const int planes[4] = {0, 1, 4, 5};  // q^T hi, lo, do^T hi, lo
          for (int i = 0; i < 4; ++i)
            tma_load_2d(slot(a, i), &maps.tr, &full[s], qt * kF32Tile,
                        planes[i] * BH * D + bh * D);
        } else {
          const int planes[4] = {0, 1, 6, 7};  // q hi, lo, do hi, lo
          for (int i = 0; i < 4; ++i)
            load_rows<D, kF32Tile>(slot(a, i), 0, maps, &full[s],
                                   planes[i] * rows + (int)rq);
        }
      }
      if (!(a & 1)) {  // into the tile's rel buffer, free of bank conflicts
        float* r = relbuf(qt);
#pragma unroll
        for (int j = 0; j < kKW / 4; ++j)
          r[(c0 + 4 * j) * kF32RwLd + qi] = w[j];
#pragma unroll
        for (int j = 0; j < (kBlkRows + 3) / 4; ++j)
          if (c0 + 4 * j < kBlkRows)
            r[kRhOff + (c0 + 4 * j) * kF32Tile + qi] = hr[j];
        if (p < kF32Tile) {
          r[kLsOff + p] = ls;
          r[kLsOff + kF32Tile + p] = dv_;
        }
      }
      mbar_arrive(&full[s]);
    }
    return;
  }

  // the consumer warpgroup: a thread keys (rows) g and g + 8 of its warp's
  // 16, queries (columns) 8 i + 2 t + e of the tile
  const int lane = tid & 31, wr = tid >> 5, g = lane >> 2, t = lane & 3;
  int kc[2], jr[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kl = wr * 16 + g + 8 * hf;  // the key in the block
    kc[hf] = kl % kKW;                    // k0 % KW == 0
    jr[hf] = kl / kKW;
  }
  float* dk_rows[2];
  float* dv_rows[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const size_t o = ((size_t)bh * N + k0 + wr * 16 + g + 8 * hf) * D;
    dk_rows[hf] = dk + o;
    dv_rows[hf] = dv + o;
  }
  float sacc[16], dpacc[16], kacc[D / 2], vacc[D / 2];
#pragma unroll
  for (int i = 0; i < 16; ++i) sacc[i] = dpacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) kacc[i] = vacc[i] = 0.f;
  const auto fence_acc = [&] {
    reg_fence(sacc);
    reg_fence(dpacc);
    reg_fence(kacc);
    reg_fence(vacc);
  };
  // S^T = k q^T and dP^T = v do^T of item a's 32 queries, in split TF32
  const auto issue_sdp = [&](int a) {
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const uint64_t kh = plane_desc<kF32Rows>(base, ks);
      const uint64_t kl = plane_desc<kF32Rows>(base + kP64, ks);
      const uint64_t vh = plane_desc<kF32Rows>(base + 2 * kP64, ks);
      const uint64_t vl = plane_desc<kF32Rows>(base + 3 * kP64, ks);
      const uint64_t qh = plane_desc<kF32Tile>(slot(a, 0), ks);
      const uint64_t ql = plane_desc<kF32Tile>(slot(a, 1), ks);
      const uint64_t gh = plane_desc<kF32Tile>(slot(a, 2), ks);
      const uint64_t gl = plane_desc<kF32Tile>(slot(a, 3), ks);
      wgmma_tf32_m64n32k8_ss(sacc, kh, ql, ks > 0);
      wgmma_tf32_m64n32k8_ss(sacc, kl, qh, 1);
      wgmma_tf32_m64n32k8_ss(sacc, kh, qh, 1);
      wgmma_tf32_m64n32k8_ss(dpacc, vh, gl, ks > 0);
      wgmma_tf32_m64n32k8_ss(dpacc, vl, gh, 1);
      wgmma_tf32_m64n32k8_ss(dpacc, vh, gh, 1);
    }
  };
  // a consumer warp is done with item a's slot
  const auto release = [&](int a) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[a % kSlots]);
  };

  mbar_wait(kvbar, 0);
  mbar_wait(&full[0], 0);
  fence_acc();
  wgmma_fence();
  issue_sdp(0);
  wgmma_commit();
  for (int qt = 0; qt < NT; ++qt) {
    const int a = 2 * qt;
    wgmma_wait<0>();  // S^T, dP^T of tile qt, and dK, dV of tile qt - 1
    fence_acc();
    if (qt > 0) release(a - 1);
    if (qt > 0 && qt % kF32Flush == 0) {
      flush_rows<D>(dk_rows, kacc, t, qt == kF32Flush, 1.f);
      flush_rows<D>(dv_rows, vacc, t, qt == kF32Flush, 1.f);
    }
    const float* r = relbuf(qt);
    // p^T and ds^T (key row g + 8 hf, queries 8 i + 2 t + e: slot 4 i +
    // 2 hf + e), split into the A operands of k-step i (register 2 e + hf)
    uint32_t ph[4][4], pl[4][4], dh[4][4], dl[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q2 = 8 * i + 2 * t;
      const float2 ls = *reinterpret_cast<const float2*>(r + kLsOff + q2);
      const float2 dv2 =
          *reinterpret_cast<const float2*>(r + kLsOff + kF32Tile + q2);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float2 w =
            *reinterpret_cast<const float2*>(r + kc[hf] * kF32RwLd + q2);
        const float2 hh = *reinterpret_cast<const float2*>(
            r + kRhOff + jr[hf] * kF32Tile + q2);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 4 * i + 2 * hf + e;
          const float bias = e ? hh.y + w.y : hh.x + w.x;
          const float pv = expf(sacc[c] * scale + bias - (e ? ls.y : ls.x));
          const float ds = pv * (dpacc[c] - (e ? dv2.y : dv2.x));
          tf32_split(pv, ph[i][2 * e + hf], pl[i][2 * e + hf]);
          tf32_split(ds, dh[i][2 * e + hf], dl[i][2 * e + hf]);
        }
      }
    }
    release(a);  // q, do and the rel buffer read
    mbar_wait(&full[(a + 1) % kSlots], ((a + 1) / kSlots) & 1);
    fence_acc();
    wgmma_fence();
    const int restart = qt % kF32Flush == 0;  // new partial dK and dV
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t qth = sw128_desc(slot(a + 1, 0) + 32 * j);
      const uint64_t qtl = sw128_desc(slot(a + 1, 1) + 32 * j);
      const uint64_t gth = sw128_desc(slot(a + 1, 2) + 32 * j);
      const uint64_t gtl = sw128_desc(slot(a + 1, 3) + 32 * j);
      wgmma_tf32_out<D>(vacc, ph[j], gtl, j > 0 || !restart);
      wgmma_tf32_out<D>(vacc, pl[j], gth, 1);
      wgmma_tf32_out<D>(vacc, ph[j], gth, 1);
      wgmma_tf32_out<D>(kacc, dh[j], qtl, j > 0 || !restart);
      wgmma_tf32_out<D>(kacc, dl[j], qth, 1);
      wgmma_tf32_out<D>(kacc, dh[j], qth, 1);
    }
    // the next tile's S^T and dP^T; after the last tile an unread pair on
    // this tile's slot (no item follows to overwrite it)
    const int a1 = qt + 1 < NT ? a + 2 : a;
    if (qt + 1 < NT) mbar_wait(&full[a1 % kSlots], (a1 / kSlots) & 1);
    issue_sdp(a1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_acc();
  flush_rows<D>(dk_rows, kacc, t, NT <= kF32Flush, scale);
  flush_rows<D>(dv_rows, vacc, t, NT <= kF32Flush, 1.f);
}

// ---- bf16: wgmma + TMA (see the note at the top) -------------------------

constexpr int kBwdRows = 128;     // queries (dq) or keys (dkv) a block
constexpr int kBwdStages = 4;
constexpr int kBwdThreads = 384;  // two consumer warpgroups + a producer
constexpr int kBwdRelLd = 72;     // bf16 rel rows in shared memory (64 + 8)
constexpr int kBwdMaxRows = 16;   // key-grid rows of a dkv block (KW >= 8)

// The blocks' shared memory; must match ops/kernels/flash_attention.py
// bwd_sm90_smem_bytes. Every tile is a 64-row tile of flash_sm90.cuh, 1024-
// byte aligned.
// dq: q (two warpgroups' tiles, a then b), do likewise; the stages, each k
// a, v a, k b, v b; rel_h and rel_w rows [128][kBwdRelLd] bf16; full and
// empty mbarriers a stage, one for each warpgroup's q and do.
// dkv: k (two warpgroups' tiles), v likewise; the stages, each q a, do a,
// q b, do b, then rel_w [KW <= 64][kBwdRelLd] bf16 (key % KW major, the
// tile's queries along a row), rel_h columns
// [kBwdMaxRows][64] f32 (times log2 e), lse (times log2 e) and dd [64] f32,
// padded to 1024 bytes; full and empty a stage, one for each warpgroup's k
// and v.
template <int D>
struct BwdSm90Layout {
  using T = FlashTiles<D>;
  static constexpr int kTwoTiles = 2 * (T::kTileA + T::kTileB);
  static constexpr int kStageRel =
      kB * kBwdRelLd * 2 + kBwdMaxRows * kB * 4 + 2 * kB * 4;
  static constexpr int kDkvStage = (kTwoTiles + kStageRel + 1023) / 1024 * 1024;
  static constexpr int kBarriers = (2 * kBwdStages + 2) * 8;
  static constexpr int kDqSmem = 1024 + 2 * kTwoTiles + kBwdStages * kTwoTiles +
                                 2 * kBwdRows * kBwdRelLd * 2 + kBarriers;
  static constexpr int kDkvSmem =
      1024 + 2 * kTwoTiles + kBwdStages * kDkvStage + kBarriers;
  static_assert(kTwoTiles % 1024 == 0, "aligned tiles");
  static_assert(kDqSmem <= 232448 && kDkvSmem <= 232448, "one block");
};

// the TMA maps of q, k, v and do: [0] columns 0-63, [1] at D = 80 64-79
struct BwdMaps {
  CUtensorMap q[2], k[2], v[2], g[2];
};

// grid (ceil(N / 128), BH), kBwdThreads threads; q, k, v, do [BH, N, D]
// through `maps` (row bh N + i); rel_h [BH, N, KH], rel_w [BH, N, KW] bf16,
// lse, dd [BH, N] f32; KW = 64 / kRowsPerTile.
template <int D, int kRowsPerTile>
__global__ void __launch_bounds__(kBwdThreads, 1)
    vit_bwd_dq_sm90(const __grid_constant__ BwdMaps maps,
                    const bf16* __restrict__ rel_h,
                    const bf16* __restrict__ rel_w,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd, bf16* __restrict__ dq,
                    float* __restrict__ drel_h, float* __restrict__ drel_w,
                    int N, int KH, float scale) {
  using T = FlashTiles<D>;
  using L = BwdSm90Layout<D>;
  constexpr int kTail = T::kTail, kKW = kB / kRowsPerTile;
  constexpr int kA = T::kTileA, kBt = T::kTileB;
  extern __shared__ unsigned char smraw[];
  unsigned char* base = align1024(smraw);
  unsigned char* gbase = base + L::kTwoTiles;        // do
  unsigned char* stages = base + 2 * L::kTwoTiles;
  bf16* RH = reinterpret_cast<bf16*>(stages + kBwdStages * L::kTwoTiles);
  bf16* RW = RH + kBwdRows * kBwdRelLd;
  uint64_t* full = reinterpret_cast<uint64_t*>(RW + kBwdRows * kBwdRelLd);
  uint64_t* empty = full + kBwdStages;
  uint64_t* qbar = empty + kBwdStages;
  const auto ka = [&](int s) { return stages + s * L::kTwoTiles; };
  const auto va = [&](int s) { return ka(s) + kA; };
  const auto kb = [&](int s) { return ka(s) + 2 * kA; };
  const auto vb = [&](int s) { return kb(s) + kBt; };

  const int tid = threadIdx.x, wg = tid / 128;
  const int bh = blockIdx.y, q0 = blockIdx.x * kBwdRows;
  const int nwg = q0 + kB < N ? 2 : 1;  // N % 64 == 0
  const int NT = N / kB;
  const int row0 = bh * N;  // the head's first row in the maps
  if (tid == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], nwg);  // released by every warpgroup
    }
    mbar_init(&qbar[0], 1);
    mbar_init(&qbar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer warpgroup: one thread issues
    producer_registers();
    if (tid == 256) {
      for (int w = 0; w < nwg; ++w) {
        const int r = row0 + q0 + w * kB;
        mbar_expect_tx(&qbar[w], 2 * kB * D * 2);
        tma_load_2d(base + w * kA, &maps.q[0], &qbar[w], 0, r);
        tma_load_2d(gbase + w * kA, &maps.g[0], &qbar[w], 0, r);
        if constexpr (kTail > 0) {
          tma_load_2d(base + 2 * kA + w * kBt, &maps.q[1], &qbar[w], 64, r);
          tma_load_2d(gbase + 2 * kA + w * kBt, &maps.g[1], &qbar[w], 64, r);
        }
      }
      int s = 0, ph = 0;
      for (int kt = 0; kt < NT; ++kt) {
        const int r = row0 + kt * kB;
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], L::kTwoTiles);
        tma_load_2d(ka(s), &maps.k[0], &full[s], 0, r);
        tma_load_2d(va(s), &maps.v[0], &full[s], 0, r);
        if constexpr (kTail > 0) {
          tma_load_2d(kb(s), &maps.k[1], &full[s], 64, r);
          tma_load_2d(vb(s), &maps.v[1], &full[s], 64, r);
        }
        if (++s == kBwdStages) s = 0, ph ^= 1;
      }
    }
    return;
  }
  consumer_registers();
  if (wg >= nwg) return;  // a last block of 64 queries

  // consumer warpgroup wg: queries q0 + 64 wg .. + 63; warp wr of it rows
  // 16 wr .. 16 wr + 15, a thread rows g and g + 8 of those
  const int t128 = tid & 127, lane = tid & 31, wr = t128 >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qr0 = q0 + wg * kB;
  for (int e = t128; e < kB * KH; e += 128) {
    const int r = e / KH, c = e - r * KH;
    RH[(wg * kB + r) * kBwdRelLd + c] =
        rel_h[((size_t)bh * N + qr0 + r) * KH + c];
  }
  for (int e = t128; e < kB * kKW; e += 128) {
    const int r = e / kKW, c = e - r * kKW;
    RW[(wg * kB + r) * kBwdRelLd + c] =
        rel_w[((size_t)bh * N + qr0 + r) * kKW + c];
  }
  named_bar_sync(1 + wg, 128);  // the rel rows written
  mbar_wait(&qbar[wg], 0);

  const int la = wg * kB + wr * 16 + g;  // this thread's rows in the block
  const bf16* rh_row[2] = {RH + la * kBwdRelLd, RH + (la + 8) * kBwdRelLd};
  const bf16* rw_row[2] = {RW + la * kBwdRelLd, RW + (la + 8) * kBwdRelLd};
  size_t grow[2];
  float lse2[2], ddr[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    grow[hf] = (size_t)bh * N + qr0 + wr * 16 + g + 8 * hf;
    lse2[hf] = lse[grow[hf]] * kLog2e;
    ddr[hf] = dd[grow[hf]];
  }
  const float sl = scale * kLog2e;

  // q and do of the warpgroup's rows as register A operands, for the loop
  uint32_t qf[D / 16][4], gf[D / 16][4];
  load_a_frags<D>(qf, base + wg * kA, base + 2 * kA + wg * kBt, t128);
  load_a_frags<D>(gf, gbase + wg * kA, gbase + 2 * kA + wg * kBt, t128);
  float sacc[32], dpacc[32], qacc[32], qtail[kTail > 0 ? 8 : 1], drw[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = dpacc[i] = qacc[i] = drw[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kTail > 0 ? 8 : 1); ++i) qtail[i] = 0.f;
  // the accumulators are only ever defined by the products from here on
  const auto fence_acc = [&] {
    reg_fence(sacc);
    reg_fence(dpacc);
    reg_fence(qacc);
    reg_fence(qtail);
  };

  // S = q k^T and dP = do v^T of the tile in stage s (async; not
  // committed): q and do from registers, k and v K-major from the stage
  const auto issue_sdp = [&](int s) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wgmma_m64n64k16_rs(sacc, qf[k], sw128_desc(ka(s) + 32 * k), k > 0);
      wgmma_m64n64k16_rs(dpacc, gf[k], sw128_desc(va(s) + 32 * k), k > 0);
    }
    if constexpr (kTail > 0) {
      wgmma_m64n64k16_rs(sacc, qf[4], sw32_desc(kb(s)), 1);
      wgmma_m64n64k16_rs(dpacc, gf[4], sw32_desc(vb(s)), 1);
    }
  };

  mbar_wait(&full[0], 0);
  fence_acc();
  wgmma_fence();
  issue_sdp(0);
  wgmma_commit();
  for (int kt = 0; kt < NT; ++kt) {
    const int s = kt % kBwdStages;
    wgmma_wait<0>();  // S, dP of tile kt, and dQ of tile kt - 1
    fence_acc();
    if (kt > 0 && t128 == 0) mbar_arrive(&empty[(kt - 1) % kBwdStages]);

    // base-2 logits: s * scale log2e + (rel_h + rel_w) log2e - lse log2e
    float rhl[2][kRowsPerTile], rs[2][kRowsPerTile];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int r = 0; r < kRowsPerTile; ++r) {
        rhl[hf][r] = fmaf(
            __bfloat162float(rh_row[hf][kt * kRowsPerTile + r]), kLog2e,
            -lse2[hf]);
        rs[hf][r] = 0.f;
      }
    // ds in bf16 as wgmma's A operand, a pair of logits at a time: register
    // u of keys 16 kk .. 16 kk + 15 holds accumulator slots 8 kk + 2 u, + 1
    // (keys 8 i + 2 t, + 1 of row g + 8 (u & 1), i = 2 kk + u / 2)
    uint32_t da[4][4];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int i = j >> 1, hf = j & 1, c0 = 4 * i + 2 * hf;
      const int r = i * kRowsPerTile / 8;  // the keys' grid row in the tile
      // rel_w of keys 8 i + 2 t, + 1 (key % KW, one 4-byte load)
      const float2 w = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(rw_row[hf] +
                                                   (8 * i + 2 * t) % kKW));
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p =
            ex2_ftz(fmaf(sacc[c0 + e], sl,
                         fmaf(e ? w.y : w.x, kLog2e, rhl[hf][r])));
        ds[e] = p * (dpacc[c0 + e] - ddr[hf]);
      }
      // rounded once, as a pair: the A operand, and the values the drel
      // sums add
      uint32_t& pk = da[i >> 1][2 * (i & 1) + hf];
      pk = pack_bf16(ds[0], ds[1]);
      const float2 dr =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pk));
      drw[c0] += dr.x;
      drw[c0 + 1] += dr.y;
      rs[hf][r] += dr.x;
      rs[hf][r] += dr.y;
    }
    fence_acc();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_m64n64k16_rs_t(qacc, da[kk], sw128_desc(ka(s) + kk * 16 * 128));
      if constexpr (kTail > 0)
        wgmma_m64n16k16_rs_t(qtail, da[kk],
                             sw32_desc(kb(s) + kk * 16 * kTail * 2));
    }
    // the next tile's S and dP; after the last tile an S and dP on this
    // tile's stage, unread, keeps the accumulators' pipeline free of
    // branches
    const int s1 = kt + 1 < NT ? (kt + 1) % kBwdStages : s;
    if (kt + 1 < NT) mbar_wait(&full[s1], ((kt + 1) / kBwdStages) & 1);
    issue_sdp(s1);
    wgmma_commit();
    // drel_h of the tile's grid rows: the quad's sums, in a fixed order
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int r = 0; r < kRowsPerTile; ++r) {
        float a = rs[hf][r];
        a += __shfl_xor_sync(0xffffffffu, a, 1);
        a += __shfl_xor_sync(0xffffffffu, a, 2);
        if (t == 0) drel_h[grow[hf] * KH + kt * kRowsPerTile + r] = a;
      }
  }
  wgmma_wait<0>();

  constexpr int kPer = kKW / 8;  // slots i fold to i % kPer
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    bf16* out = dq + grow[hf] * D;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * i + 2 * t) =
          __floats2bfloat162_rn(qacc[4 * i + 2 * hf] * scale,
                                qacc[4 * i + 2 * hf + 1] * scale);
    if constexpr (kTail > 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<__nv_bfloat162*>(out + 64 + 8 * i + 2 * t) =
            __floats2bfloat162_rn(qtail[4 * i + 2 * hf] * scale,
                                  qtail[4 * i + 2 * hf + 1] * scale);
    }
    float fold[kPer][2];
#pragma unroll
    for (int j = 0; j < kPer; ++j) fold[j][0] = fold[j][1] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      fold[i % kPer][0] += drw[4 * i + 2 * hf];
      fold[i % kPer][1] += drw[4 * i + 2 * hf + 1];
    }
    float* dw = drel_w + grow[hf] * kKW;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      dw[8 * j + 2 * t] = fold[j][0];
      dw[8 * j + 2 * t + 1] = fold[j][1];
    }
  }
}

// grid (ceil(N / 128), BH), kBwdThreads threads; as vit_bwd_dq_sm90. The
// block's keys k0 .. k0 + 127 are key-grid rows k0 / KW ..
template <int D, int kRowsPerTile>
__global__ void __launch_bounds__(kBwdThreads, 1)
    vit_bwd_dkv_sm90(const __grid_constant__ BwdMaps maps,
                     const bf16* __restrict__ rel_h,
                     const bf16* __restrict__ rel_w,
                     const float* __restrict__ lse,
                     const float* __restrict__ dd, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int N, int KH, float scale) {
  using T = FlashTiles<D>;
  using L = BwdSm90Layout<D>;
  constexpr int kTail = T::kTail, kKW = kB / kRowsPerTile;
  constexpr int kA = T::kTileA, kBt = T::kTileB;
  extern __shared__ unsigned char smraw[];
  unsigned char* base = align1024(smraw);
  unsigned char* vbase = base + L::kTwoTiles;
  unsigned char* stages = base + 2 * L::kTwoTiles;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(stages + kBwdStages * L::kDkvStage);
  uint64_t* empty = full + kBwdStages;
  uint64_t* kvbar = empty + kBwdStages;
  const auto qa = [&](int s) { return stages + s * L::kDkvStage; };
  const auto ga = [&](int s) { return qa(s) + kA; };
  const auto qb = [&](int s) { return qa(s) + 2 * kA; };
  const auto gb = [&](int s) { return qb(s) + kBt; };
  const auto rws = [&](int s) {
    return reinterpret_cast<bf16*>(qa(s) + L::kTwoTiles);
  };
  const auto rhs = [&](int s) {
    return reinterpret_cast<float*>(rws(s) + kB * kBwdRelLd);
  };
  const auto lses = [&](int s) { return rhs(s) + kBwdMaxRows * kB; };
  const auto dds = [&](int s) { return lses(s) + kB; };

  const int tid = threadIdx.x, wg = tid / 128;
  const int bh = blockIdx.y, k0 = blockIdx.x * kBwdRows;
  const int nwg = k0 + kB < N ? 2 : 1;
  const int NT = N / kB;
  const int row0 = bh * N;
  const int kr0 = k0 / kKW, nkr = nwg * kRowsPerTile;  // the block's rows
  if (tid == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 129);   // the TMA's expect_tx + 128 copiers
      mbar_init(&empty[s], nwg);
    }
    mbar_init(&kvbar[0], 1);
    mbar_init(&kvbar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer warpgroup
    producer_registers();
    const int p = tid - 256;
    if (p == 0) {
      for (int w = 0; w < nwg; ++w) {
        const int r = row0 + k0 + w * kB;
        mbar_expect_tx(&kvbar[w], 2 * kB * D * 2);
        tma_load_2d(base + w * kA, &maps.k[0], &kvbar[w], 0, r);
        tma_load_2d(vbase + w * kA, &maps.v[0], &kvbar[w], 0, r);
        if constexpr (kTail > 0) {
          tma_load_2d(base + 2 * kA + w * kBt, &maps.k[1], &kvbar[w], 64, r);
          tma_load_2d(vbase + 2 * kA + w * kBt, &maps.v[1], &kvbar[w], 64,
                      r);
        }
      }
    }
    int s = 0, ph = 0;
    for (int qt = 0; qt < NT; ++qt) {
      const size_t rq = (size_t)bh * N + (size_t)qt * kB;
      mbar_wait(&empty[s], ph ^ 1);
      if (p == 0) {
        mbar_expect_tx(&full[s], L::kTwoTiles);
        tma_load_2d(qa(s), &maps.q[0], &full[s], 0, (int)rq);
        tma_load_2d(ga(s), &maps.g[0], &full[s], 0, (int)rq);
        if constexpr (kTail > 0) {
          tma_load_2d(qb(s), &maps.q[1], &full[s], 64, (int)rq);
          tma_load_2d(gb(s), &maps.g[1], &full[s], 64, (int)rq);
        }
      }
      // the tile's rel_w rows, 16 bytes at a time, transposed to [key %
      // KW][query] so that a thread's two queries are one 4-byte load
      constexpr int kCh = kKW / 8;
      bf16* rw = rws(s);
      for (int c = p; c < kB * kCh; c += 128) {
        const int r = c & (kB - 1), ch = c / kB;
        const uint4 v =
            *reinterpret_cast<const uint4*>(rel_w + (rq + r) * kKW + ch * 8);
        const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int u = 0; u < 8; ++u) rw[(ch * 8 + u) * kBwdRelLd + r] = e[u];
      }
      // rel_h of the block's key-grid rows, j-major, times log2 e
      float* rh = rhs(s);
      for (int e = p; e < kB * nkr; e += 128) {
        const int qi = e / nkr, j = e - qi * nkr;
        rh[j * kB + qi] =
            __bfloat162float(rel_h[(rq + qi) * KH + kr0 + j]) * kLog2e;
      }
      if (p < kB) {
        lses(s)[p] = lse[rq + p] * kLog2e;
        dds(s)[p] = dd[rq + p];
      }
      mbar_arrive(&full[s]);
      if (++s == kBwdStages) s = 0, ph ^= 1;
    }
    return;
  }
  consumer_registers();
  if (wg >= nwg) return;  // a last block of 64 keys

  // consumer warpgroup wg: keys k0 + 64 wg .. + 63; a thread keys (rows) g
  // and g + 8 of its warp's 16, queries (columns) 8 i + 2 t + e
  const int t128 = tid & 127, lane = tid & 31, wr = t128 >> 5;
  const int g = lane >> 2, t = lane & 3;
  int kc[2], jr[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kl = wg * kB + wr * 16 + g + 8 * hf;  // the key in the block
    kc[hf] = kl % kKW;                              // k0 % KW == 0
    jr[hf] = kl / kKW;
  }
  const float sl = scale * kLog2e;
  mbar_wait(&kvbar[wg], 0);

  // k and v of the warpgroup's keys as register A operands, for the loop
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_frags<D>(kf, base + wg * kA, base + 2 * kA + wg * kBt, t128);
  load_a_frags<D>(vf, vbase + wg * kA, vbase + 2 * kA + wg * kBt, t128);
  constexpr int kT = kTail > 0 ? 8 : 1;
  float sacc[32], dpacc[32], kacc[32], vacc[32], ktail[kT], vtail[kT];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = dpacc[i] = kacc[i] = vacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kT; ++i) ktail[i] = vtail[i] = 0.f;
  // the accumulators are only ever defined by the products from here on
  const auto fence_acc = [&] {
    reg_fence(sacc);
    reg_fence(dpacc);
    reg_fence(kacc);
    reg_fence(vacc);
    reg_fence(ktail);
    reg_fence(vtail);
  };

  // S^T = k q^T and dP^T = v do^T of the query tile in stage s: k and v
  // from registers, q and do K-major from the stage
  const auto issue_sdp = [&](int s) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wgmma_m64n64k16_rs(sacc, kf[k], sw128_desc(qa(s) + 32 * k), k > 0);
      wgmma_m64n64k16_rs(dpacc, vf[k], sw128_desc(ga(s) + 32 * k), k > 0);
    }
    if constexpr (kTail > 0) {
      wgmma_m64n64k16_rs(sacc, kf[4], sw32_desc(qb(s)), 1);
      wgmma_m64n64k16_rs(dpacc, vf[4], sw32_desc(gb(s)), 1);
    }
  };

  mbar_wait(&full[0], 0);
  fence_acc();
  wgmma_fence();
  issue_sdp(0);
  wgmma_commit();
  for (int qt = 0; qt < NT; ++qt) {
    const int s = qt % kBwdStages;
    wgmma_wait<0>();  // S^T, dP^T of tile qt, and dV, dK of tile qt - 1
    fence_acc();
    if (qt > 0 && t128 == 0) mbar_arrive(&empty[(qt - 1) % kBwdStages]);
    const bf16* rw = rws(s);
    const float* rh = rhs(s);
    const float* ls = lses(s);
    const float* ds_d = dds(s);
    // P^T (rounded here) and dS^T as wgmma's A operands, a pair of logits
    // at a time (queries 8 i + 2 t, + 1 of key row g + 8 hf; register
    // 2 (i & 1) + hf of queries 16 kk .., kk = i / 2)
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float b[2], d[2];  // a query's bias less lse (base 2), and its dd
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = 8 * i + 2 * t + e;
        b[e] = rh[jr[0] * kB + qi] - ls[qi];
        d[e] = ds_d[qi];
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c0 = 4 * i + 2 * hf;
        // rel_w of queries 8 i + 2 t, + 1 at the key's column
        const float2 w = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(
                rw + kc[hf] * kBwdRelLd + 8 * i + 2 * t));
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = 8 * i + 2 * t + e;
          // keys g and g + 8 lie in one grid row unless KW = 8
          const float bh = kKW > 8 || hf == 0
                               ? b[e]
                               : rh[jr[1] * kB + qi] - ls[qi];
          p[e] = ex2_ftz(
              fmaf(sacc[c0 + e], sl, fmaf(e ? w.y : w.x, kLog2e, bh)));
          ds[e] = p[e] * (dpacc[c0 + e] - d[e]);
        }
        pa[i >> 1][2 * (i & 1) + hf] = pack_bf16(p[0], p[1]);
        da[i >> 1][2 * (i & 1) + hf] = pack_bf16(ds[0], ds[1]);
      }
    }
    fence_acc();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_m64n64k16_rs_t(vacc, pa[kk], sw128_desc(ga(s) + kk * 16 * 128));
      wgmma_m64n64k16_rs_t(kacc, da[kk], sw128_desc(qa(s) + kk * 16 * 128));
      if constexpr (kTail > 0) {
        wgmma_m64n16k16_rs_t(vtail, pa[kk],
                             sw32_desc(gb(s) + kk * 16 * kTail * 2));
        wgmma_m64n16k16_rs_t(ktail, da[kk],
                             sw32_desc(qb(s) + kk * 16 * kTail * 2));
      }
    }
    const int s1 = qt + 1 < NT ? (qt + 1) % kBwdStages : s;
    if (qt + 1 < NT) mbar_wait(&full[s1], ((qt + 1) / kBwdStages) & 1);
    issue_sdp(s1);
    wgmma_commit();
  }
  wgmma_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const size_t r = ((size_t)bh * N + k0 + wg * kB + wr * 16 + g + 8 * hf) *
                     D;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(dk + r + 8 * i + 2 * t) =
          __floats2bfloat162_rn(kacc[4 * i + 2 * hf] * scale,
                                kacc[4 * i + 2 * hf + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + r + 8 * i + 2 * t) =
          __floats2bfloat162_rn(vacc[4 * i + 2 * hf], vacc[4 * i + 2 * hf + 1]);
    }
    if constexpr (kTail > 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        *reinterpret_cast<__nv_bfloat162*>(dk + r + 64 + 8 * i + 2 * t) =
            __floats2bfloat162_rn(ktail[4 * i + 2 * hf] * scale,
                                  ktail[4 * i + 2 * hf + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + r + 64 + 8 * i + 2 * t) =
            __floats2bfloat162_rn(vtail[4 * i + 2 * hf],
                                  vtail[4 * i + 2 * hf + 1]);
      }
    }
  }
}

// ---- launchers -------------------------------------------------------------

template <int D, int kKW>
int launch_f32_kw(const F32Maps& maps, const float* rel_h, const float* rel_w,
                  const float* lse, const float* dd, float* dq, float* dk,
                  float* dv, float* drh, float* drw, int BH, int N, int KH,
                  float scale, cudaStream_t st) {
  using L = F32Layout<D>;
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      vit_bwd_dq_tf32<D, kKW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kDqSmem);
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      vit_bwd_dkv_tf32<D, kKW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kDkvSmem);
  if (attr_q != cudaSuccess) return (int)attr_q;
  if (attr_kv != cudaSuccess) return (int)attr_kv;
  const dim3 grid(N / kF32Rows, BH);
  vit_bwd_dq_tf32<D, kKW><<<grid, kF32Threads, L::kDqSmem, st>>>(
      maps, rel_h, rel_w, lse, dd, dq, drh, drw, BH, N, KH, scale);
  const int e = (int)cudaGetLastError();
  if (e) return e;
  vit_bwd_dkv_tf32<D, kKW><<<grid, kF32Threads, L::kDkvSmem, st>>>(
      maps, rel_h, rel_w, lse, dd, dk, dv, BH, N, KH, scale);
  return (int)cudaGetLastError();
}

// the split pre-pass into `scratch` (nat [8 BH N][D], then tr [6 BH D][N]
// f32), then the two kernels
template <int D>
int launch_f32(const float* q, const float* k, const float* v,
               const float* rel_h, const float* rel_w, const float* dout,
               const float* lse, const float* dd, float* dq, float* dk,
               float* dv, float* drh, float* drw, float* scratch, int BH,
               int N, int KH, int KW, float scale, cudaStream_t st) {
  float* nat = scratch;
  float* tr = nat + 8 * (size_t)BH * N * D;
  vit_bwd_split_f32<D><<<dim3(N / kF32Tile, BH, 4), 256, 0, st>>>(
      q, k, v, dout, nat, tr, BH, N);
  const int e = (int)cudaGetLastError();
  if (e) return e;
  F32Maps maps;
  if (!make_f32_map(&maps.nat, nat, 8LL * BH * N, D, 32, kF32Tile,
                    CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_f32_map(&maps.tail, nat, 8LL * BH * N, D, 16, kF32Tile,
                    CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_f32_map(&maps.tr, tr, 6LL * BH * D, N, 32, D,
                    CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  switch (KW) {
    case 64:
      return launch_f32_kw<D, 64>(maps, rel_h, rel_w, lse, dd, dq, dk, dv,
                                  drh, drw, BH, N, KH, scale, st);
    case 32:
      return launch_f32_kw<D, 32>(maps, rel_h, rel_w, lse, dd, dq, dk, dv,
                                  drh, drw, BH, N, KH, scale, st);
    case 16:
      return launch_f32_kw<D, 16>(maps, rel_h, rel_w, lse, dd, dq, dk, dv,
                                  drh, drw, BH, N, KH, scale, st);
    case 8:
      return launch_f32_kw<D, 8>(maps, rel_h, rel_w, lse, dd, dq, dk, dv,
                                 drh, drw, BH, N, KH, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int D, int kRowsPerTile>
int launch_sm90_rows(const BwdMaps& maps, const bf16* rel_h,
                     const bf16* rel_w, const float* lse, const float* dd,
                     bf16* dq, bf16* dk, bf16* dv, float* drh, float* drw,
                     int BH, int N, int KH, float scale, cudaStream_t st) {
  using L = BwdSm90Layout<D>;
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      vit_bwd_dq_sm90<D, kRowsPerTile>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kDqSmem);
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      vit_bwd_dkv_sm90<D, kRowsPerTile>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kDkvSmem);
  if (attr_q != cudaSuccess) return (int)attr_q;
  if (attr_kv != cudaSuccess) return (int)attr_kv;
  const dim3 grid((N + kBwdRows - 1) / kBwdRows, BH);
  vit_bwd_dq_sm90<D, kRowsPerTile><<<grid, kBwdThreads, L::kDqSmem, st>>>(
      maps, rel_h, rel_w, lse, dd, dq, drh, drw, N, KH, scale);
  const int e = (int)cudaGetLastError();
  if (e) return e;
  vit_bwd_dkv_sm90<D, kRowsPerTile><<<grid, kBwdThreads, L::kDkvSmem, st>>>(
      maps, rel_h, rel_w, lse, dd, dk, dv, N, KH, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_sm90(const void* q, const void* k, const void* v,
                const void* dout, const bf16* rel_h, const bf16* rel_w,
                const float* lse, const float* dd, bf16* dq, bf16* dk,
                bf16* dv, float* drh, float* drw, int BH, int N, int KH,
                int KW, float scale, cudaStream_t st) {
  BwdMaps maps;
  const void* src[4] = {q, k, v, dout};
  CUtensorMap* dst[4] = {maps.q, maps.k, maps.v, maps.g};
  for (int i = 0; i < 4; ++i) {
    if (!make_flash_map(&dst[i][0], src[i], (long long)BH * N, D, D, 64,
                        CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
    if (D > 64 && !make_flash_map(&dst[i][1], src[i], (long long)BH * N, D,
                                  D, D - 64, CU_TENSOR_MAP_SWIZZLE_32B))
      return (int)cudaErrorInvalidValue;
    if (D == 64) dst[i][1] = dst[i][0];
  }
  switch (KW) {
    case 64:
      return launch_sm90_rows<D, 1>(maps, rel_h, rel_w, lse, dd, dq, dk, dv,
                                    drh, drw, BH, N, KH, scale, st);
    case 32:
      return launch_sm90_rows<D, 2>(maps, rel_h, rel_w, lse, dd, dq, dk, dv,
                                    drh, drw, BH, N, KH, scale, st);
    case 16:
      return launch_sm90_rows<D, 4>(maps, rel_h, rel_w, lse, dd, dq, dk, dv,
                                    drh, drw, BH, N, KH, scale, st);
    case 8:
      return launch_sm90_rows<D, 8>(maps, rel_h, rel_w, lse, dd, dq, dk, dv,
                                    drh, drw, BH, N, KH, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v,
           const void* rel_h, const void* rel_w, const void* dout,
           const float* lse, const float* dd, void* dq, void* dk, void* dv,
           float* drh, float* drw, float* scratch, int BH, int N, int KH,
           int KW, float scale, cudaStream_t st) {
  if (dtype == kF32) {
    using F = const float*;
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    return launch_f32<D>(F(q), F(k), F(v), F(rel_h), F(rel_w), F(dout), lse,
                         dd, static_cast<float*>(dq), static_cast<float*>(dk),
                         static_cast<float*>(dv), drh, drw, scratch, BH, N,
                         KH, KW, scale, st);
  }
  if (dtype == kBF16) {
    using B = const bf16*;
    return launch_sm90<D>(q, k, v, dout, B(rel_h), B(rel_w), lse, dd,
                          static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                          static_cast<bf16*>(dv), drh, drw, BH, N, KH, KW,
                          scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ullsam

// Bytes of the scratch that vit_flash_attn_backward needs: float32 the hi
// and lo planes of q, k, v, do and of q, k, do transposed (14 BH N D
// floats); bfloat16 none.
extern "C" long long vit_flash_bwd_scratch_bytes(int dtype, int BH, int N,
                                                 int D) {
  return dtype == ullsam::kF32 ? 14LL * BH * N * D * 4 : 0;
}

// Plain C entry point (loaded with ctypes). Returns 0 or a cudaError_t.
// dtype: 0 = float32, 1 = bfloat16 for q, k, v, rel_h, rel_w, do, dq, dk,
// dv; lse, dd [BH, N] and drel_h [BH, N, KH], drel_w [BH, N, KW] are
// float32, as is `scratch` (vit_flash_bwd_scratch_bytes; float32 only).
// Requires D in {64, 80}, KW in {8, 16, 32, 64}, KH <= 64, N == KH * KW,
// N % 64 == 0, 16-byte aligned tensors.
extern "C" int vit_flash_attn_backward(
    int dtype, const void* q, const void* k, const void* v,
    const void* rel_h, const void* rel_w, const void* dout, const void* lse,
    const void* dd, void* dq, void* dk, void* dv, void* drel_h, void* drel_w,
    void* scratch, int BH, int N, int D, int KH, int KW, float scale,
    void* stream) {
  using namespace ullsam;
  if ((D != 64 && D != 80) || KW < 8 || KW > 64 || 64 % KW || KH < 1 ||
      KH > 64 || N != KH * KW || N % kB)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* dd_f = static_cast<const float*>(dd);
  float* drh = static_cast<float*>(drel_h);
  float* drw = static_cast<float*>(drel_w);
  float* scr = static_cast<float*>(scratch);
  if (D == 80)
    return launch<80>(dtype, q, k, v, rel_h, rel_w, dout, lse_f, dd_f, dq, dk,
                      dv, drh, drw, scr, BH, N, KH, KW, scale, st);
  return launch<64>(dtype, q, k, v, rel_h, rel_w, dout, lse_f, dd_f, dq, dk,
                    dv, drh, drw, scr, BH, N, KH, KW, scale, st);
}
