// B2: ViT global flash attention with the factored decomposed rel-pos bias,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel ullsam_tpu/ops/pallas/flash_attention.py
// `_vit_kernel` (via `vit_flash_attention` / `_vit_flash_impl`):
//     o   = softmax(qs k^T + bias) v,   qs = cast(q * D^-1/2)
//     lse = logsumexp of each row (f32, read by B9, the backward)
// with bias[i, key] = rel_h[i, key / KW] + rel_w[i, key % KW]; the N x N
// bias never exists in memory.
//
// What bounds it on this card: operations. At the SAM ViT-B global blocks
// (BH = 12, N = 4096, D = 64) one call is 2*2*N^2*D*BH = 51.5 GFLOP against
// ~38 MB of bytes; under that, the exponentials (BH N^2 = 201 M, 16 a clock
// an SM) and the bias, one add a logit at best. float32 is f32-accurate at
// its fastest in split TF32 (495 / 3 TFLOP/s; vit_flash_tf32 below).
//
// bf16 design (vit_flash_sm90, the usual Hopper attention shape):
//   * A block is 128 queries of one (b, h): two consumer warpgroups of 64
//     rows and one producer warp. The producer's single thread issues TMA
//     loads: each warpgroup's q rows once, then 64-key tiles of k and v into
//     a ring of kFlashStages stages with `full` / `empty` mbarriers (both
//     warpgroups release a stage). q, k and v are read in place through
//     cuTensorMapEncodeTiled maps, so one body serves B2's [BH, N, D] and
//     B14's [B, N, 3C] (below).
//   * Per key tile, S = qs k^T on wgmma m64n64k16 from shared-memory
//     descriptors (both K-major), the online softmax in f32 registers (the
//     accumulator layout: a thread holds rows g and g + 8 of its warp's 16,
//     16 keys each), p rounded to bf16 into wgmma's register A operand, and
//     o += p v on wgmma m64n64k16 with v read MN-major (trans-b). A tile's
//     p.v and the next tile's S are issued together and waited on together,
//     so the tensor cores run both back to back while the other warpgroup
//     runs its softmax.
//   * The bias out of the logit loop: when KW divides the 64-key tile and
//     is at least 8 (SAM's grids: KW = 64 at ViT-B, L and H), a tile covers
//     64 / KW whole key rows and each 8-key accumulator column block lies in
//     one of them. rel_w[i, key % KW] is then the same fragment in every
//     tile, held in 32 registers in the accumulator layout for the whole
//     loop, and rel_h[i, key / KW] is 64 / KW values a row a tile, read from
//     shared memory once a tile: the bias is one add a logit. The previous
//     kernel found each key's grid row by a division and read both factors
//     from shared memory per logit (about 25 instructions, the cost PR 8
//     measured in the window core). Other KW (any KW <= 64 with N % 64 ==
//     0) keep that per-logit path in the same kernel (kRowsPerTile = 0).
//   * q is pre-scaled in place once it lands (elementwise, so the swizzle
//     does not matter) and fenced for the async proxy before the first
//     product.
//   * Head dim 80: rows of 160 bytes exceed the 128-byte swizzle span of one
//     TMA box, so every tile is split: columns 0-63 in a 128-byte-swizzled
//     box, 64-79 in a 32-byte-swizzled box of 16. S takes four 16-deep steps
//     from the first and one from the second; p.v is an n = 64 product on
//     the first and an n = 16 product on the second.
//   * Rounding points match _vit_flash_impl: q is pre-scaled and cast to
//     q's dtype; rel factors arrive at q's dtype and are summed in f32; p
//     (unnormalized, f32) is cast to v's dtype before p.v; the output is acc
//     / l cast to q's dtype once; lse = m + log l in f32.
//
// float32 design (vit_split_f32 + vit_flash_tf32: split TF32 on wgmma +
// TMA, the shape of B10's float32 body, csrc/llm_f32.cuh):
//   * An f32 operand x is hi = tf32(x) plus lo = tf32(x - hi) (tf32.cuh),
//     and each product is issued three times on wgmma, A_hi B_lo and A_lo
//     B_hi first, then A_hi B_hi: f32-accurate products at 495 / 3 TFLOP/s,
//     not the CUDA cores' 67, on which the earlier FMA body reached 16% of
//     the bound. TF32 wgmma reads shared memory K-major only, and p.v
//     contracts v along its rows, so a pre-pass (vit_split_f32) writes into
//     scratch that the wrapper allocates (kF32Planes BH N D floats) the hi
//     and lo planes of qs (q * scale rounded in f32, as prescale_q) and k,
//     natural [BH N][D], and of v transposed [BH D][N], each 8-key group in
//     the lf32_pi order of a register A operand. It reads q, k and v through
//     HeadStrides, so the kernel serves B2 and B14 on head-major planes and
//     writes o through HeadStrides as the bf16 body does.
//   * A block is 128 queries of one (b, h): two consumer warpgroups of 64
//     rows and a producer warpgroup that gives them its registers
//     (setmaxnreg) and issues TMA loads: each warpgroup's qs hi and lo
//     once, then k hi, k lo, v^T hi, v^T lo of 32 keys a stage through a
//     ring of kStages stages that both warpgroups share and release. An f32
//     plane of R rows is columns 0-31 and 32-63 as two 128-byte-swizzled
//     boxes [R][128 bytes] and, at D = 80, columns 64-79 as a
//     64-byte-swizzled box [R][64 bytes]; a v^T plane is one box [D][32].
//     Shared memory (F32Layout): 1024 to align, qs 4 x 64 x 4 D (65,536 at
//     D = 64, 81,920 at 80), a stage 4 x 32 x 4 D (32,768 / 40,960): 4
//     stages at D = 64 (197,712 bytes with the mbarriers), 3 at 80
//     (205,888), one block an SM.
//   * Per stage, S = qs k^T is m64n32k8, three products a k-step. The
//     tensor cores' f32 accumulation loses up to about half an ulp a step,
//     one way (PERF.md section 6), so S sums its k-steps in
//     kF32Chains chains from zero (12 / 15 products a chain at D = 64 / 80),
//     added on the CUDA cores in a fixed order. The online softmax runs in
//     f32 registers with expf; nothing rounds p, which is split in registers
//     into the A operand of p.v (m64nDk8, v^T hi and lo from the stage). A
//     stage's p.v goes into a partial from zero, and acc = alpha acc +
//     partial on the CUDA cores. A tile's p.v and the next tile's S are
//     issued together and waited on together, as in the bf16 body, so one
//     warpgroup's products run while the other computes its softmax.
//   * The bias: when KW divides 64 and is at least 8 (f32_bias_kw), each
//     8-key block of a 32-key tile lies in one key row. rel_w of the
//     thread's keys is then one 16-register fragment in the accumulator
//     layout for every tile (at KW = 64 two, a tile half a key row, taken
//     in turns), loaded once, and rel_h is 32 / KW values a row a tile (one
//     a tile at KW = 64), read from device memory under the products. Other
//     KW read both factors per logit (no SAM grid). In f32 the factors stay
//     f32 and are added as the plain version adds them: (S + (rel_h +
//     rel_w)).
//   * o = acc / l, lse = m + log l in f32. No atomics: every call gives
//     bitwise the same result.
// On an H100 (PERF.md section 6) the body runs 0.711 ms at ViT-B and 1.08
// at ViT-H, pre-pass included (73-80 TFLOP/s; the earlier FMA body 1.89
// / 3.17); one consumer warpgroup a block (B10's shape, 6 / 4 stages) ran 8%
// slower.
//
// Head dims 64 (SAM ViT-B / L) and 80 (ViT-H: 16 heads of 80, BH = 16,
// 80.5 GFLOP a call) are instantiated. Both bodies address q, k, v and o
// through a batch and a head stride per bh = b * nh + h and a row stride,
// so one body serves two layouts:
//   * B2, vit_flash_attn_forward: q, k, v, o [BH, N, D], contiguous;
//   * B14, vit_flash_attn_packed_forward, which replaces
//     flash_attention.py `_vit_kernel_packed` (opt-in by
//     ULLSAM_PACKED_GLOBAL=1): head h of image b read straight from the qkv
//     projection [B, N, 3C] at columns h D, C + h D, 2C + h D (row stride
//     3C), and o written into [B, N, C] at column h D, the layout proj
//     consumes: no head-split copy before, no merge transpose after. The TPU
//     kernel pads every head to 128 lanes for that; here the natural layout
//     needs no pad. Same function and rounding points as B2.
#include "flash_sm90.cuh"
#include "llm_f32.cuh"

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

// ---- float32: split TF32 on wgmma + TMA (see the note at the top) ---------

constexpr int kF32Rows = 128;     // queries a block: two warpgroups of 64
constexpr int kF32Keys = 32;      // keys a stage
constexpr int kF32Threads = 384;  // two consumer warpgroups + a producer one
constexpr int kF32Chains = 2;     // accumulators of a logit tile
// Planes of the scratch, each BH N D floats: qs hi, qs lo, k hi, k lo
// natural [BH N][D]; v^T hi, v^T lo [BH D][N]. Must match
// ops/kernels/flash_attention.py fwd_f32_scratch_floats.
constexpr int kF32NatPlanes = 4, kF32Planes = 6;

// The block's shared memory; must match ops/kernels/flash_attention.py
// fwd_f32_smem_bytes. 1024 bytes to align the planes; qs hi and lo of each
// warpgroup's 64 rows; the stages, each k hi, k lo (natural planes of 32
// keys) and v^T hi, v^T lo ([D][32]); a full and an empty mbarrier a stage
// and one for each warpgroup's qs.
template <int D>
struct F32Layout {
  static_assert(D == 64 || D == 80, "head dims 64 and 80");
  static constexpr int kStages = D > 64 ? 3 : 4;
  static constexpr int kQ = 64 * D * 4;        // a qs plane of 64 rows
  static constexpr int kK = kF32Keys * D * 4;  // a k or v^T plane of a stage
  static constexpr int kStage = 4 * kK;
  static constexpr int kSmem =
      1024 + 4 * kQ + kStages * kStage + (2 * kStages + 2) * 8;
  static_assert(kQ % 1024 == 0 && kK % 1024 == 0, "aligned planes");
  static_assert(kSmem <= 232448, "one block");
};

// The bias path of the float32 body for KW, with 32-key tiles: KW when it
// divides 64 and is at least 8 (each 8-key block of a tile in one key row:
// rel_w a register fragment, rel_h a value a row per key row of the tile),
// else 0 (both factors per logit). Must match ops/kernels/
// flash_attention.py f32_bias_kw.
inline int f32_bias_kw(int KW) { return KW >= 8 && 64 % KW == 0 ? KW : 0; }

// the maps of the scratch: `nat` [4 BH N][D] (qs hi, qs lo, k hi, k lo) in
// boxes of 32 columns by 32 rows, `tail` its columns 64-79 (D = 80), `tr`
// [2 BH D][N] (v^T hi, lo) in boxes of D rows by 32 keys
struct F32Maps {
  CUtensorMap nat, tail, tr;
};

// d[64 x 32] (+)= A[64 x 8] . B[32 x 8]^T in TF32, both K-major in shared
// memory; `acc` 0 starts from zero
__device__ __forceinline__ void tf32_ss_n32(float* d, uint64_t da,
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 64] (+)= A[64 x 8] . B[64 x 8]^T in TF32: A from registers (TF32
// values in the m64k8 fragment layout), B K-major in shared memory
__device__ __forceinline__ void tf32_rs_n64(float* d, const uint32_t* a,
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d[64 x 80] (+)= A[64 x 8] . B[80 x 8]^T, as tf32_rs_n64
__device__ __forceinline__ void tf32_rs_n80(float* d, const uint32_t* a,
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <int D>
__device__ __forceinline__ void tf32_rs(float* d, const uint32_t* a,
                                        uint64_t db, int acc) {
  if constexpr (D == 64)
    tf32_rs_n64(d, a, db, acc);
  else
    tf32_rs_n80(d, a, db, acc);
}

// the descriptor of k-step ks (columns 8 ks .. 8 ks + 7) of a natural
// plane of R rows (columns 64-79 in the 64-byte-swizzled tail box)
template <int R>
__device__ __forceinline__ uint64_t f32_nat_desc(const unsigned char* p,
                                                 int ks) {
  return ks < 8 ? swz_desc<128>(p + (ks >> 2) * R * 128 + (ks & 3) * 32)
                : swz_desc<64>(p + 2 * R * 128 + (ks - 8) * 32);
}

// natural-plane rows row .. row + 31 into rows r0 .. of the plane of R rows
// at p
template <int D, int R>
__device__ __forceinline__ void f32_load_rows(unsigned char* p, int r0,
                                              const F32Maps& m,
                                              uint64_t* bar, int row) {
  tma_load_2d(p + r0 * 128, &m.nat, bar, 0, row);
  tma_load_2d(p + R * 128 + r0 * 128, &m.nat, bar, 32, row);
  if constexpr (D > 64)
    tma_load_2d(p + 2 * R * 128 + r0 * 64, &m.tail, bar, 64, row);
}

// grid (N / 32, BH, 3), 256 threads: rows 32 blockIdx.x .. + 31 of head
// blockIdx.y of qs (z = 0: q times scale, rounded in f32), k (1) or v (2),
// read through hs, split into hi and lo: qs and k natural (planes 2 z, 2 z
// + 1 of nat [4 BH N][D]), v transposed (tr [2 BH D][N]) with each 8-key
// group in lf32_pi order
template <int D>
__global__ void __launch_bounds__(256)
    vit_split_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, HeadStrides hs, float scale,
                  float* __restrict__ nat, float* __restrict__ tr, int BH,
                  int N) {
  __shared__ float tile[kF32Keys][D + 1];
  const int z = blockIdx.z, bh = blockIdx.y, r0 = blockIdx.x * kF32Keys;
  const float* src = (z == 0 ? q : z == 1 ? k : v) + hs.in(bh);
  const size_t plane = (size_t)BH * N * D;
  for (int e = threadIdx.x; e < kF32Keys * D; e += 256) {
    const int r = e / D, d = e % D;
    float x = src[(r0 + r) * hs.ld + d];
    if (z == 0) x = __fmul_rn(x, scale);  // rounded before the split
    if (z < 2) {
      const size_t o = ((size_t)bh * N + r0 + r) * D + d;
      uint32_t hi, lo;
      tf32_split(x, hi, lo);
      nat[2 * z * plane + o] = __uint_as_float(hi);
      nat[(2 * z + 1) * plane + o] = __uint_as_float(lo);
    } else {
      tile[r][d] = x;
    }
  }
  if (z < 2) return;
  __syncthreads();
  for (int e = threadIdx.x; e < D * kF32Keys; e += 256) {
    const int d = e / kF32Keys, c = e % kF32Keys;
    const float x = tile[(c & ~7) + lf32_pi(c & 7)][d];
    const size_t o = ((size_t)bh * D + d) * N + r0 + c;
    uint32_t hi, lo;
    tf32_split(x, hi, lo);
    tr[o] = __uint_as_float(hi);
    tr[plane + o] = __uint_as_float(lo);
  }
}

// grid (ceil(N / 128), BH), kF32Threads threads: o (per HeadStrides) and
// lse [BH, N] of 128 queries of head bh. rel_h [BH, N, KH], rel_w [BH, N,
// KW]; the split planes through `maps`. kKW = f32_bias_kw(KW).
template <int D, int kKW>
__global__ void __launch_bounds__(kF32Threads, 1)
    vit_flash_tf32(const __grid_constant__ F32Maps maps,
                   const float* __restrict__ rel_h,
                   const float* __restrict__ rel_w, float* __restrict__ o,
                   float* __restrict__ lse, int N, int KH, int KW,
                   HeadStrides hs) {
  using L = F32Layout<D>;
  constexpr int kSt = L::kStages, kT = kF32Keys;
  // a key row spans kHalves tiles (KW = 64), or a tile kRpt key rows
  constexpr int kHalves = kKW > kT ? kKW / kT : 1;
  constexpr int kRpt = kKW >= kT ? 1 : kKW > 0 ? kT / kKW : 1;
  constexpr int kSteps = D / 8 / kF32Chains;  // k-steps a chain
  extern __shared__ unsigned char smraw[];
  unsigned char* base = align1024(smraw);  // qs of warpgroup w: hi, lo
  unsigned char* stages = base + 4 * L::kQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kSt * L::kStage);
  uint64_t* empty = full + kSt;
  uint64_t* qbar = empty + kSt;
  const auto qplane = [&](int w, int lo) {
    return base + (2 * w + lo) * L::kQ;
  };
  // stage s: k hi, k lo, v^T hi, v^T lo (i = 0..3)
  const auto plane = [&](int s, int i) {
    return stages + s * L::kStage + i * L::kK;
  };

  const int tid = threadIdx.x, wg = tid / 128;
  const int bh = blockIdx.y, q0 = blockIdx.x * kF32Rows;
  const int nwg = q0 + 64 < N ? 2 : 1;  // N % 64 == 0
  const int NT = N / kT, BH = gridDim.y;
  if (tid == 0) {
    for (int s = 0; s < kSt; ++s) {
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
      const int rows = BH * N;  // rows of a natural plane
      for (int w = 0; w < nwg; ++w) {
        mbar_expect_tx(&qbar[w], 2 * L::kQ);
        for (int lo = 0; lo < 2; ++lo)
          for (int r = 0; r < 64; r += kT)
            f32_load_rows<D, 64>(qplane(w, lo), r, maps, &qbar[w],
                                 lo * rows + bh * N + q0 + 64 * w + r);
      }
      int s = 0, ph = 0;
      for (int kt = 0; kt < NT; ++kt) {
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], L::kStage);
        for (int j = 0; j < 2; ++j) {  // nat planes 2, 3; tr planes 0, 1
          f32_load_rows<D, kT>(plane(s, j), 0, maps, &full[s],
                               (2 + j) * rows + bh * N + kt * kT);
          tma_load_2d(plane(s, 2 + j), &maps.tr, &full[s], kt * kT,
                      j * BH * D + bh * D);
        }
        if (++s == kSt) s = 0, ph ^= 1;
      }
    }
    return;
  }
  consumer_registers();
  if (wg >= nwg) return;  // a last block of 64 queries

  // consumer warpgroup wg: queries q0 + 64 wg .. + 63; warp wr of it rows
  // 16 wr .. 16 wr + 15, a thread rows g and g + 8 of those, keys 8 j + 2 t,
  // + 1 of a tile (accumulator slot 4 j + 2 hf + e)
  const int t128 = tid & 127, lane = tid & 31, wr = t128 >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qr0 = q0 + wg * 64;
  size_t grow[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    grow[hf] = (size_t)bh * N + qr0 + wr * 16 + g + 8 * hf;
  const float* rh_row[2] = {rel_h + grow[0] * KH, rel_h + grow[1] * KH};
  const float* rw_row[2] = {rel_w + grow[0] * KW, rel_w + grow[1] * KW};
  // rel_w of the thread's keys 32 h + 8 j + 2 t + e (mod KW) in the
  // accumulator layout, for every tile
  float rw[kHalves][16];
  if constexpr (kKW > 0) {
#pragma unroll
    for (int h = 0; h < kHalves; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float2 w = __ldg(reinterpret_cast<const float2*>(
              rw_row[hf] + (32 * h + 8 * j + 2 * t) % kKW));
          rw[h][4 * j + 2 * hf] = w.x;
          rw[h][4 * j + 2 * hf + 1] = w.y;
        }
  }
  const float inv_kw = 1.f / KW;

  const unsigned char* qh = qplane(wg, 0);
  const unsigned char* ql = qplane(wg, 1);
  float sacc[kF32Chains][16], part[D / 2], oacc[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) part[c] = oacc[c] = 0.f;
#pragma unroll
  for (int c = 0; c < kF32Chains; ++c)
#pragma unroll
    for (int x = 0; x < 16; ++x) sacc[c][x] = 0.f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, alpha[2] = {0.f, 0.f};
  const auto fence_acc = [&] {
#pragma unroll
    for (int c = 0; c < kF32Chains; ++c) reg_fence(sacc[c]);
    reg_fence(part);
  };

  // S = qs k^T of the stage's 32 keys into kF32Chains chains from zero
  const auto issue_s = [&](int s) {
#pragma unroll
    for (int c = 0; c < kF32Chains; ++c)
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const int ks = c * kSteps + kk;
        const uint64_t ah = f32_nat_desc<64>(qh, ks);
        const uint64_t al = f32_nat_desc<64>(ql, ks);
        const uint64_t bhi = f32_nat_desc<kT>(plane(s, 0), ks);
        const uint64_t blo = f32_nat_desc<kT>(plane(s, 1), ks);
        tf32_ss_n32(sacc[c], ah, blo, kk > 0);
        tf32_ss_n32(sacc[c], al, bhi, 1);
        tf32_ss_n32(sacc[c], ah, bhi, 1);
      }
  };

  mbar_wait(&qbar[wg], 0);
  mbar_wait(&full[0], 0);
  fence_acc();
  wgmma_fence();
  issue_s(0);
  wgmma_commit();
  for (int kt = 0; kt < NT; ++kt) {
    const int s = kt % kSt;
    // rel_h of the tile's key rows, read under the products
    float rh[2][kRpt];
    if constexpr (kKW > 0) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int r = 0; r < kRpt; ++r)
          rh[hf][r] = __ldg(rh_row[hf] + (kHalves > 1 ? kt / kHalves
                                                      : kt * kRpt + r));
    }
    wgmma_wait<0>();  // S of tile kt, and p.v of tile kt - 1
    fence_acc();
    if (kt > 0) {
      if (t128 == 0) mbar_arrive(&empty[(kt - 1) % kSt]);
#pragma unroll
      for (int c = 0; c < D / 2; ++c)
        oacc[c] = oacc[c] * alpha[(c >> 1) & 1] + part[c];
    }

    // the logits with the bias, and the tile's row maxima
    float mx[2] = {m[0], m[1]};
    const int h = kHalves > 1 ? kt % kHalves : 0;
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int j = x >> 2, hf = (x >> 1) & 1, e = x & 1;
      float b;
      if constexpr (kKW > 0) {
        const float w = kHalves > 1 && h ? rw[kHalves - 1][x] : rw[0][x];
        b = rh[hf][kKW >= kT ? 0 : 8 * j / kKW] + w;
      } else {
        const int key = kt * kT + 8 * j + 2 * t + e;
        const int kr = div_small(key, inv_kw);
        b = __ldg(rh_row[hf] + kr) + __ldg(rw_row[hf] + key - kr * KW);
      }
      float& v = sacc[0][x];
#pragma unroll
      for (int c = 1; c < kF32Chains; ++c) v += sacc[c][x];
      v += b;
      mx[hf] = fmaxf(mx[hf], v);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      alpha[hf] = expf(m[hf] - mx[hf]);
      m[hf] = mx[hf];
      l[hf] *= alpha[hf];
    }
    // p = exp(s - m), split into the A operand of k-step j: register 2 e +
    // hf holds row g + 8 hf, key 8 j + 2 t + e (lf32_pi)
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int j = x >> 2, hf = (x >> 1) & 1, e = x & 1;
      const float p = expf(sacc[0][x] - m[hf]);
      l[hf] += p;
      tf32_split(p, ph[j][2 * e + hf], pl[j][2 * e + hf]);
    }

    // this tile's p.v into a partial from zero, and the next tile's S; after
    // the last tile an S on this tile's stage, unread, keeps the
    // accumulators' pipeline free of branches
    fence_acc();
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
      const uint64_t vh = lf32_tr_desc<kT>(plane(s, 2), j);
      const uint64_t vl = lf32_tr_desc<kT>(plane(s, 3), j);
      tf32_rs<D>(part, ph[j], vl, j > 0);
      tf32_rs<D>(part, pl[j], vh, 1);
      tf32_rs<D>(part, ph[j], vh, 1);
    }
    const int s1 = kt + 1 < NT ? (kt + 1) % kSt : s;
    if (kt + 1 < NT) mbar_wait(&full[s1], ((kt + 1) / kSt) & 1);
    issue_s(s1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_acc();
#pragma unroll
  for (int c = 0; c < D / 2; ++c)
    oacc[c] = oacc[c] * alpha[(c >> 1) & 1] + part[c];

  float* oh = o + hs.out(bh);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    const int r = qr0 + wr * 16 + g + 8 * hf;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(oh + r * hs.ldo + 8 * j + 2 * t) =
          make_float2(oacc[4 * j + 2 * hf] / l[hf],
                      oacc[4 * j + 2 * hf + 1] / l[hf]);
    if (t == 0) lse[grow[hf]] = m[hf] + logf(l[hf]);
  }
}

// ---- bf16: wgmma + TMA (see the note at the top) -------------------------

constexpr int kFlashRows = 128;  // queries a block: two warpgroups of 64
constexpr int kFlashStages = 4;
constexpr int kFlashThreads = 288;   // two consumer warpgroups + one warp
constexpr int kRelLd = kMaxRel + 8;  // bf16 rel rows in shared memory
constexpr float kFlashLog2e = 1.4426950408889634f;

// The block's shared memory; must match ops/kernels/flash_attention.py
// sm90_smem_bytes. Tiles of 64 rows: columns 0-63 of a row in 128 swizzled
// bytes ("a"), at D = 80 columns 64-79 in 32 swizzled bytes ("b"); every
// tile 1024-byte aligned. q [128 rows] a then b; the stages, each k a,
// v a, k b, v b; rel_h and rel_w rows [128][kRelLd] bf16; the mbarriers
// (full and empty a stage, one for each warpgroup's q).
template <int D>
struct FlashSm90Layout {
  static constexpr int kTail = FlashTiles<D>::kTail;
  static constexpr int kTileA = FlashTiles<D>::kTileA;
  static constexpr int kTileB = FlashTiles<D>::kTileB;
  static constexpr int kQBytes = kFlashRows * 128 + kFlashRows * kTail * 2;
  static constexpr int kStageBytes = 2 * (kTileA + kTileB);
  static constexpr int kRelBytes = kFlashRows * kRelLd * 2;
  static constexpr int kSmemBytes = 1024 + kQBytes +
                                    kFlashStages * kStageBytes +
                                    2 * kRelBytes +
                                    (2 * kFlashStages + 2) * 8;
  static_assert(kStageBytes % 1024 == 0 && kQBytes % 1024 == 0, "aligned");
};

// the TMA maps of q, k and v: [0] columns 0-63 (128-byte swizzle), [1] at
// D = 80 columns 64-79 (32-byte swizzle); boxes of 64 rows
struct FlashMaps {
  CUtensorMap q[2], k[2], v[2];
};

// kRowsPerTile = 64 / KW when KW divides 64 and KW >= 8 (the bias from
// registers), 0 for any other KW (the bias per logit from shared memory).
// grid (ceil(N / 128), BH), kFlashThreads threads; rel_h [BH, N, KH],
// rel_w [BH, N, KW], lse [BH, N]; q, k, v through `maps` at row
// (bh / nh) N + key and column (bh % nh) hs.sh, o per HeadStrides.
template <int D, int kRowsPerTile>
__global__ void __launch_bounds__(kFlashThreads, 1)
    vit_flash_sm90(const __grid_constant__ FlashMaps maps,
                   const __nv_bfloat16* __restrict__ rel_h,
                   const __nv_bfloat16* __restrict__ rel_w,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int N, int KH, int KW, float scale, HeadStrides hs) {
  using bf16 = __nv_bfloat16;
  using L = FlashSm90Layout<D>;
  constexpr int kTail = L::kTail;
  extern __shared__ unsigned char smraw[];
  unsigned char* base = smraw + ((1024 - (smem_u32(smraw) & 1023)) & 1023);
  unsigned char* qa = base;                       // [128][64] swizzled
  unsigned char* qb = base + kFlashRows * 128;    // [128][16] (D = 80)
  unsigned char* stages = base + L::kQBytes;
  bf16* RH = reinterpret_cast<bf16*>(stages + kFlashStages * L::kStageBytes);
  bf16* RW = RH + kFlashRows * kRelLd;
  uint64_t* full = reinterpret_cast<uint64_t*>(RW + kFlashRows * kRelLd);
  uint64_t* empty = full + kFlashStages;
  uint64_t* qbar = empty + kFlashStages;
  const auto ka = [&](int s) { return stages + s * L::kStageBytes; };
  const auto va = [&](int s) { return ka(s) + L::kTileA; };
  const auto kb = [&](int s) { return ka(s) + 2 * L::kTileA; };
  const auto vb = [&](int s) { return kb(s) + L::kTileB; };

  const int tid = threadIdx.x, wg = tid / 128;
  const int bh = blockIdx.y, q0 = blockIdx.x * kFlashRows;
  const int nwg = q0 + kBQ < N ? 2 : 1;  // N % 64 == 0
  const int NT = N / kBK;
  const int row0 = (bh / hs.nh) * N;  // the head's first row in the maps
  const int col = (int)((bh % hs.nh) * hs.sh);
  if (tid == 0) {
    for (int s = 0; s < kFlashStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], nwg);  // released by every warpgroup
    }
    mbar_init(&qbar[0], 1);
    mbar_init(&qbar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp
    if (tid == 256) {
      for (int w = 0; w < nwg; ++w) {
        mbar_expect_tx(&qbar[w], kBQ * D * 2);
        tma_load_2d(qa + w * kBQ * 128, &maps.q[0], &qbar[w], col,
                    row0 + q0 + w * kBQ);
        if constexpr (kTail > 0)
          tma_load_2d(qb + w * kBQ * kTail * 2, &maps.q[1], &qbar[w],
                      col + 64, row0 + q0 + w * kBQ);
      }
      int s = 0, ph = 0;
      for (int kt = 0; kt < NT; ++kt) {
        const int r = row0 + kt * kBK;
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], L::kStageBytes);
        tma_load_2d(ka(s), &maps.k[0], &full[s], col, r);
        tma_load_2d(va(s), &maps.v[0], &full[s], col, r);
        if constexpr (kTail > 0) {
          tma_load_2d(kb(s), &maps.k[1], &full[s], col + 64, r);
          tma_load_2d(vb(s), &maps.v[1], &full[s], col + 64, r);
        }
        if (++s == kFlashStages) s = 0, ph ^= 1;
      }
    }
    return;
  }
  if (wg >= nwg) return;  // a last block of 64 queries

  // consumer warpgroup wg: queries q0 + 64 wg .. + 63; warp wr of it rows
  // 16 wr .. 16 wr + 15, a thread rows g and g + 8 of those
  const int t128 = tid & 127, lane = tid & 31, wr = t128 >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qr0 = q0 + wg * kBQ;
  for (int e = t128; e < kBQ * KH; e += 128) {
    const int r = e / KH, c = e - r * KH;
    RH[(wg * kBQ + r) * kRelLd + c] = rel_h[((size_t)bh * N + qr0 + r) * KH + c];
  }
  for (int e = t128; e < kBQ * KW; e += 128) {
    const int r = e / KW, c = e - r * KW;
    RW[(wg * kBQ + r) * kRelLd + c] = rel_w[((size_t)bh * N + qr0 + r) * KW + c];
  }
  // q pre-scaled in place, 16 bytes at a time (the swizzle moves whole
  // 16-byte chunks, so an elementwise pass need not know it)
  mbar_wait(&qbar[wg], 0);
  {
    uint4* qw = reinterpret_cast<uint4*>(qa + wg * kBQ * 128);
    constexpr int kChunks = kBQ * 128 / 16 + kBQ * kTail * 2 / 16;
#pragma unroll
    for (int i = 0; i < kChunks / 128; ++i) {
      const int c = t128 + 128 * i;
      uint4* p = c < kBQ * 8 ? qw + c
                             : reinterpret_cast<uint4*>(
                                   qb + wg * kBQ * kTail * 2) +
                                   (c - kBQ * 8);
      uint4 x = *p;
      uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f =
            __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[e]));
        w[e] = pack_bf16(f.x * scale, f.y * scale);
      }
      *p = x;
    }
  }
  fence_proxy_async();
  named_bar_sync(1 + wg, 128);  // q and the rel rows written

  const int la = wg * kBQ + wr * 16 + g;  // this thread's rows in the block
  const bf16* rh_row[2] = {RH + la * kRelLd, RH + (la + 8) * kRelLd};
  const bf16* rw_row[2] = {RW + la * kRelLd, RW + (la + 8) * kRelLd};
  // rel_w in the accumulator layout (key 8i + 2t + (c & 1) of row c >> 1),
  // times log2 e, for the whole loop
  float rwl[kRowsPerTile > 0 ? 32 : 1];
  if constexpr (kRowsPerTile > 0) {
    constexpr int kKW = kBK / kRowsPerTile;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        rwl[4 * i + c] =
            __bfloat162float(rw_row[c >> 1][(8 * i + 2 * t + (c & 1)) % kKW]) *
            kFlashLog2e;
  }
  const float inv_kw = 1.f / KW;

  const unsigned char* qaw = qa + wg * kBQ * 128;
  const unsigned char* qbw = qb + wg * kBQ * kTail * 2;
  float sacc[32], oa[32], ob[kTail > 0 ? 8 : 1];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = oa[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kTail > 0 ? 8 : 1); ++i) ob[i] = 0.f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};

  // S = qs k^T of the tile in stage s into sacc (async; not committed)
  const auto issue_s = [&](int s) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_m64n64k16_ss(sacc, sw128_desc(qaw + 32 * k),
                         sw128_desc(ka(s) + 32 * k), k > 0);
    if constexpr (kTail > 0)
      wgmma_m64n64k16_ss(sacc, sw32_desc(qbw), sw32_desc(kb(s)), 1);
  };

  mbar_wait(&full[0], 0);
  wgmma_fence();
  issue_s(0);
  wgmma_commit();
  for (int kt = 0; kt < NT; ++kt) {
    const int s = kt % kFlashStages;
    wgmma_wait<0>();  // S of tile kt, and p.v of tile kt - 1
    if (kt > 0 && t128 == 0)
      mbar_arrive(&empty[(kt - 1) % kFlashStages]);

    // logits in base 2 with the bias, and the tile's row maxima
    float mx[2] = {m[0], m[1]};
    if constexpr (kRowsPerTile > 0) {
      float rhl[2][kRowsPerTile];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int r = 0; r < kRowsPerTile; ++r)
          rhl[hf][r] =
              __bfloat162float(rh_row[hf][kt * kRowsPerTile + r]) *
              kFlashLog2e;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float& x = sacc[4 * i + c];
          x = fmaf(x, kFlashLog2e,
                   rwl[4 * i + c] + rhl[c >> 1][i * kRowsPerTile / 8]);
          mx[c >> 1] = fmaxf(mx[c >> 1], x);
        }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = kt * kBK + 8 * i + 2 * t + (c & 1);
          const int kr = div_small(key, inv_kw);
          const float b = __bfloat162float(rh_row[c >> 1][kr]) +
                          __bfloat162float(rw_row[c >> 1][key - kr * KW]);
          float& x = sacc[4 * i + c];
          x = (x + b) * kFlashLog2e;
          mx[c >> 1] = fmaxf(mx[c >> 1], x);
        }
    }
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      alpha[hf] = exp2f(m[hf] - mx[hf]);
      m[hf] = mx[hf];
      l[hf] *= alpha[hf];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sacc[i] = exp2f(sacc[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += sacc[i];
      oa[i] *= alpha[(i >> 1) & 1];
    }
    if constexpr (kTail > 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) ob[i] *= alpha[(i >> 1) & 1];
    }
    // p in bf16 as wgmma's A operand: keys 16 kk .. 16 kk + 15
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_m64n64k16_rs_t(oa, pa[kk], sw128_desc(va(s) + kk * 16 * 128));
      if constexpr (kTail > 0)
        wgmma_m64n16k16_rs_t(ob, pa[kk],
                             sw32_desc(vb(s) + kk * 16 * kTail * 2));
    }
    // the next tile's S; after the last tile an S on this tile's stage,
    // unread, keeps the accumulators' pipeline free of branches
    const int s1 = kt + 1 < NT ? (kt + 1) % kFlashStages : s;
    if (kt + 1 < NT) mbar_wait(&full[s1], ((kt + 1) / kFlashStages) & 1);
    issue_s(s1);
    wgmma_commit();
  }
  wgmma_wait<0>();

  bf16* oh = o + hs.out(bh);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    const float inv = 1.f / l[hf];
    const int r = qr0 + wr * 16 + g + 8 * hf;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(oh + r * hs.ldo + 8 * i + 2 * t) =
          __floats2bfloat162_rn(oa[4 * i + 2 * hf] * inv,
                                oa[4 * i + 2 * hf + 1] * inv);
    if constexpr (kTail > 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<__nv_bfloat162*>(oh + r * hs.ldo + 64 + 8 * i +
                                           2 * t) =
            __floats2bfloat162_rn(ob[4 * i + 2 * hf] * inv,
                                  ob[4 * i + 2 * hf + 1] * inv);
    }
    if (t == 0)
      lse[(size_t)bh * N + r] = m[hf] * 0.6931471805599453f + logf(l[hf]);
  }
}

template <int D, int kKW>
int launch_tf32_kw(const F32Maps& maps, const float* rel_h,
                   const float* rel_w, float* o, float* lse, int BH, int N,
                   int KH, int KW, const HeadStrides& hs, cudaStream_t st) {
  constexpr int smem = F32Layout<D>::kSmem;
  static const cudaError_t attr = cudaFuncSetAttribute(
      vit_flash_tf32<D, kKW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return (int)attr;
  vit_flash_tf32<D, kKW>
      <<<dim3((N + kF32Rows - 1) / kF32Rows, BH), kF32Threads, smem, st>>>(
          maps, rel_h, rel_w, o, lse, N, KH, KW, hs);
  return (int)cudaGetLastError();
}

// the split pre-pass into `scratch` (nat [4 BH N][D], then tr [2 BH D][N]
// f32), then the kernel
template <int D>
int launch_tf32(const float* q, const float* k, const float* v,
                const float* rel_h, const float* rel_w, float* o, float* lse,
                float* scratch, int BH, int N, int KH, int KW, float scale,
                const HeadStrides& hs, cudaStream_t st) {
  const long long rows = (long long)kF32NatPlanes * BH * N;
  if (!scratch || rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  float* nat = scratch;
  float* tr = nat + rows * D;
  vit_split_f32<D><<<dim3(N / kF32Keys, BH, 3), 256, 0, st>>>(
      q, k, v, hs, scale, nat, tr, BH, N);
  const int e = (int)cudaGetLastError();
  if (e) return e;
  F32Maps maps;
  if (!lf32_map(&maps.nat, nat, rows, D, 32, kF32Keys) ||
      !lf32_map(&maps.tail, nat, rows, D, 16, kF32Keys) ||
      !lf32_map(&maps.tr, tr, 2LL * BH * D, N, 32, D))
    return (int)cudaErrorInvalidValue;
  switch (f32_bias_kw(KW)) {
    case 64:
      return launch_tf32_kw<D, 64>(maps, rel_h, rel_w, o, lse, BH, N, KH,
                                   KW, hs, st);
    case 32:
      return launch_tf32_kw<D, 32>(maps, rel_h, rel_w, o, lse, BH, N, KH,
                                   KW, hs, st);
    case 16:
      return launch_tf32_kw<D, 16>(maps, rel_h, rel_w, o, lse, BH, N, KH,
                                   KW, hs, st);
    case 8:
      return launch_tf32_kw<D, 8>(maps, rel_h, rel_w, o, lse, BH, N, KH, KW,
                                  hs, st);
    default:
      return launch_tf32_kw<D, 0>(maps, rel_h, rel_w, o, lse, BH, N, KH, KW,
                                  hs, st);
  }
}

// The bias path for KW: 64 / KW key rows a 64-key tile when KW divides 64
// and is at least 8, else 0 (per logit). Must match
// ops/kernels/flash_attention.py key_rows_per_tile.
inline int key_rows_per_tile(int KW) {
  return KW >= 8 && kBK % KW == 0 ? kBK / KW : 0;
}

template <int D, int kRowsPerTile>
int launch_sm90_rows(const FlashMaps& maps, const void* rel_h,
                     const void* rel_w, void* o, float* lse, int BH, int N,
                     int KH, int KW, float scale, const HeadStrides& hs,
                     cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  constexpr int smem = FlashSm90Layout<D>::kSmemBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      vit_flash_sm90<D, kRowsPerTile>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  vit_flash_sm90<D, kRowsPerTile>
      <<<dim3((N + kFlashRows - 1) / kFlashRows, BH), kFlashThreads, smem,
         st>>>(maps, static_cast<const bf16*>(rel_h),
               static_cast<const bf16*>(rel_w), static_cast<bf16*>(o), lse, N,
               KH, KW, scale, hs);
  return (int)cudaGetLastError();
}

// q, k, v: the element (0, 0) of head 0 of each; a head's rows are rows
// (bh / nh) N .. + N - 1 of a [BH / nh * N, cols] matrix of row stride hs.ld
template <int D>
int launch_sm90(const void* q, const void* k, const void* v,
                const void* rel_h, const void* rel_w, void* o, float* lse,
                int BH, int N, int KH, int KW, float scale,
                const HeadStrides& hs, cudaStream_t st) {
  FlashMaps maps;
  const long long rows = (long long)BH / hs.nh * N;
  const long long cols = hs.nh == 1 ? D : (long long)hs.nh * hs.sh;
  const void* src[3] = {q, k, v};
  CUtensorMap* dst[3] = {maps.q, maps.k, maps.v};
  for (int i = 0; i < 3; ++i) {
    if (!make_flash_map(&dst[i][0], src[i], rows, cols, hs.ld, 64,
                        CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
    if (D > 64 && !make_flash_map(&dst[i][1], src[i], rows, cols, hs.ld,
                                  D - 64, CU_TENSOR_MAP_SWIZZLE_32B))
      return (int)cudaErrorInvalidValue;
    if (D == 64) dst[i][1] = dst[i][0];
  }
  switch (key_rows_per_tile(KW)) {
    case 1:
      return launch_sm90_rows<D, 1>(maps, rel_h, rel_w, o, lse, BH, N, KH,
                                    KW, scale, hs, st);
    case 2:
      return launch_sm90_rows<D, 2>(maps, rel_h, rel_w, o, lse, BH, N, KH,
                                    KW, scale, hs, st);
    case 4:
      return launch_sm90_rows<D, 4>(maps, rel_h, rel_w, o, lse, BH, N, KH,
                                    KW, scale, hs, st);
    case 8:
      return launch_sm90_rows<D, 8>(maps, rel_h, rel_w, o, lse, BH, N, KH,
                                    KW, scale, hs, st);
    default:
      return launch_sm90_rows<D, 0>(maps, rel_h, rel_w, o, lse, BH, N, KH,
                                    KW, scale, hs, st);
  }
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v,
           const void* rel_h, const void* rel_w, void* o, float* lse,
           float* scratch, int BH, int N, int KH, int KW, float scale,
           const HeadStrides& hs, cudaStream_t st) {
  if (dtype == kF32) {
    using F = const float*;
    return launch_tf32<D>(F(q), F(k), F(v), F(rel_h), F(rel_w),
                          static_cast<float*>(o), lse, scratch, BH, N, KH,
                          KW, scale, hs, st);
  }
  if (dtype == kBF16)
    return launch_sm90<D>(q, k, v, rel_h, rel_w, o, lse, BH, N, KH, KW,
                          scale, hs, st);
  return (int)cudaErrorInvalidValue;
}

int launch_d(int dtype, int D, const void* q, const void* k, const void* v,
             const void* rel_h, const void* rel_w, void* o, void* lse,
             void* scratch, int BH, int N, int KH, int KW, float scale,
             const HeadStrides& hs, void* stream) {
  if ((D != 64 && D != 80) || N % kBQ != 0 || KH * KW != N ||
      KH > kMaxRel || KW > kMaxRel)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lsef = static_cast<float*>(lse);
  float* scr = static_cast<float*>(scratch);
  if (D == 80)
    return launch<80>(dtype, q, k, v, rel_h, rel_w, o, lsef, scr, BH, N, KH,
                      KW, scale, hs, st);
  return launch<64>(dtype, q, k, v, rel_h, rel_w, o, lsef, scr, BH, N, KH,
                    KW, scale, hs, st);
}

}  // namespace
}  // namespace ullsam

// Bytes of the scratch that the forwards need: float32 the hi and lo
// planes of qs, k and v^T (kF32Planes BH N D floats); bfloat16 none.
extern "C" long long vit_flash_fwd_scratch_bytes(int dtype, int BH, int N,
                                                 int D) {
  return dtype == ullsam::kF32
             ? 4LL * ullsam::kF32Planes * BH * N * D
             : 0;
}

// Plain C entry points (loaded with ctypes). Each returns 0 or a
// cudaError_t. dtype: 0 = float32, 1 = bfloat16 for every tensor but lse,
// which is float32, as is `scratch` (vit_flash_fwd_scratch_bytes; float32
// only, unused in bfloat16). Both require D in {64, 80}, N % 64 == 0, KH *
// KW == N, KH, KW <= 64, 16-byte aligned tensors; rel_h [BH, N, KH], rel_w
// [BH, N, KW], lse [BH, N].

// B2: q, k, v, o [BH, N, D].
extern "C" int vit_flash_attn_forward(int dtype, const void* q, const void* k,
                                      const void* v, const void* rel_h,
                                      const void* rel_w, void* o, void* lse,
                                      void* scratch, int BH, int N, int D,
                                      int KH, int KW, float scale,
                                      void* stream) {
  using namespace ullsam;
  const long long nd = (long long)N * D;
  const HeadStrides hs{1, nd, 0, D, nd, 0, D};
  return launch_d(dtype, D, q, k, v, rel_h, rel_w, o, lse, scratch, BH, N,
                  KH, KW, scale, hs, stream);
}

// B14: qkv [B, N, 3C] (q | k | v, head h at h * D of each, C = nh * D),
// o [B, N, C]; bh = b * nh + h.
extern "C" int vit_flash_attn_packed_forward(int dtype, const void* qkv,
                                             const void* rel_h,
                                             const void* rel_w, void* o,
                                             void* lse, void* scratch, int B,
                                             int nh, int N, int D, int KH,
                                             int KW, float scale,
                                             void* stream) {
  using namespace ullsam;
  const long long C = (long long)nh * D;
  const HeadStrides hs{nh, N * 3 * C, D, (int)(3 * C), N * C, D, (int)C};
  const size_t eb = dtype == kF32 ? 4 : 2;
  const char* base = static_cast<const char*>(qkv);
  return launch_d(dtype, D, base, base + C * eb, base + 2 * C * eb, rel_h,
                  rel_w, o, lse, scratch, B * nh, N, KH, KW, scale, hs,
                  stream);
}
