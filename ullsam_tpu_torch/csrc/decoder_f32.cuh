// The work-unit framework of the mask decoder's float32 Hopper (sm_90a)
// kernels: B5's image stages (decoder_image.cu, image_stage_f32) and B6 /
// B7's upscale (decoder_upscale.cu, upscale_unit_f32) at SAM's decoder
// widths (C = 256, Cd = 128, 8 heads of 16, T <= 16, M <= 4). The float32
// kind of decoder_sm90.cuh's bf16 units: the same producer warpgroup, TMA
// ring and persistent walk over units, with the products in split TF32
// (tf32.cuh) on wgmma.
//
// Shared memory sets the unit's shape. In f32 a 128-row unit's X and Q
// tiles alone take 196,608 bytes, so a unit here is (prompt b, 64 image
// rows n0 .. n0 + 63) and the two consumer warpgroups split each product's
// columns: warpgroup wg computes columns 128 wg .. 128 wg + 127 of a
// 256-wide product (m64n128k8: 64 accumulators and 64 partial sums a
// thread) and 64 wg .. 64 wg + 63 of a 128-wide one (m64n64k8). One block
// an SM, 384 threads, kF32SmemBytes = 224,064 of the 232,448 bytes:
//   * 1024 bytes to align the tiles;
//   * X [64][256] f32 (65,536): the unit's input rows as TMA lands them,
//     then each stage's outputs; k-blocks of [64 rows][32] f32 (128 bytes
//     a row) in the 128-byte swizzle, which the TMA stores read back;
//   * Q [64][128] f32 (32,768): B5 stage 2's image queries and i2t
//     output; the upscale's logit staging;
//   * the weight ring, kF32Stages = 3 slots of 32,768: a k-block of 16
//     columns of W's hi plane ([256 rows][16] f32, 64 bytes a row, the
//     64-byte swizzle) and of its lo plane beside it;
//   * the prompt's token rows, three [16][132] f32 (25,344; rows padded
//     from 128), fetched by cp.async for the next unit while a unit ends;
//   * the LayerNorm's exchange of half-row sums between the warpgroups
//     ([2 passes][2 warpgroups][64] f32, 1,024);
//   * a full and an empty mbarrier a slot, xfull and xempty (64).
// A k-block of 32 columns would take 64 KB a slot: two slots and the tiles
// do not fit. B5's stage 1 takes its input (128 columns) into Q, which it
// releases once its first product has read it, so that the next unit's
// rows land while this one's epilogues run; stage 2 and the upscale take
// 256 columns into X, released at the unit's end.
//
// Products (split TF32, as gemm_sm90.cuh's f32 kind). TF32 wgmma reads
// shared memory K-major only, so W's rows [N][K] are the B operand as they
// stand. W's hi = tf32(w) and lo = tf32(w - hi) planes are made once, when
// the weights are packed (decoder_split_tf32), and TMA brings both: a split
// in the kernel would cost each unit shared-memory bandwidth for every
// k-block of every product. A, the unit's rows, is split in registers as a
// warp reads them from the tile (wgmma's register A operand), the next
// k-block's while this one's products run. Each 8-deep step is three
// products, A_hi W_lo and A_lo W_hi first, then A_hi W_hi, into a partial
// sum from zero that covers one k-block (6 products); the CUDA cores add
// it to the f32 sum. A long tensor-core chain drifts by about half an ulp
// a product; a short partial does not.
//
// Epilogues run in registers in the accumulator layout (d[4i + c]: row 16
// warp + g + 8 (c >> 1), column c0 + 8i + 2tq + (c & 1)). A LayerNorm over
// 256 columns spans both warpgroups: each posts its half-row sums to shared
// memory, a named barrier, each reads the other's. Every statistic is two
// passes (mean, then the mean square of x - mean); 1 / sqrtf, not rsqrtf.
// Nothing rounds between the products but f32 itself.
//
// What bounds them: by the data sheet, operations (split TF32 at 495 / 3
// TFLOP/s). On the card (H100 80GB HBM3, 700 W, the AMG chunk) the units
// run at 57-62 TFLOP/s, 2.7-2.8x that bound: the two warpgroups take each
// k-block together and then each epilogue together (the attentions, the
// LayerNorms and the GELUs on the CUDA cores), so nothing overlaps the
// products but the other warpgroup's share of them, and each unit waits on
// its weight planes from L2 (768 KB-1 MB a 64-row unit, 64 KB in flight).
// Clusters of two blocks sharing each k-block by TMA multicast (half the L2
// traffic) ran no faster.
#pragma once

#include "decoder_sm90.cuh"
#include "tf32.cuh"

namespace ullsam {
namespace {

constexpr int kF32Rows = 64;       // image rows (pixels) a unit
constexpr int kF32Stages = 3;      // weight ring slots
constexpr int kF32WK = 16;         // K of a weight k-block (64 bytes)
constexpr int kF32PromptLd = 132;  // floats a prompt row (128, padded)
constexpr int kF32TileKB = kF32Rows * 32;             // floats of [64][32]
constexpr int kF32XBytes = kF32Rows * kUnitC * 4;     // X [64][256]
constexpr int kF32QBytes = kF32Rows * kUnitCd * 4;    // Q [64][128]
constexpr int kF32SlotBytes = 2 * kUnitC * kF32WK * 4;  // hi, lo [256][16]
constexpr int kF32PromptBytes = 3 * kUnitMaxTok * kF32PromptLd * 4;
constexpr int kF32RedBytes = 2 * 2 * kF32Rows * 4;
constexpr int kF32Barriers = 2 * kF32Stages + 2;
// Must match ops/kernels/decoder.py f32_smem_bytes
constexpr int kF32SmemBytes = 1024 + kF32XBytes + kF32QBytes +
                              kF32Stages * kF32SlotBytes + kF32PromptBytes +
                              kF32RedBytes + kF32Barriers * 8;
static_assert(kF32SmemBytes <= 232448, "one block an SM");

// float offset of (row, col) in a tile of k-blocks [64][32] f32, 128-byte
// swizzle: 16-byte chunk c of row r at c ^ (r & 7)
__device__ __forceinline__ int fswz(int row, int col) {
  return (col >> 5) * kF32TileKB + row * 32 +
         ((((col >> 2) & 7) ^ (row & 7)) << 2) + (col & 3);
}

// wgmma descriptor of a K-major tile with the 64-byte swizzle: rows of 64
// bytes, 8-row groups 512 bytes apart (SBO)
__device__ __forceinline__ uint64_t sw64_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) | (2ull << 62);
}

// d[64 x 64] (+)= A[64 x 8] . B[64 x 8]^T in TF32, A from registers (the
// m64k8 fragment layout of wgmma_tf32_m64n128k8_rs), B K-major in shared
// memory
__device__ __forceinline__ void wgmma_tf32_m64n64k8_rs(float* d,
                                                       const uint32_t* a,
                                                       uint64_t db,
                                                       int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}"
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

struct F32Smem {
  float* x;  // X [64][256]
  float* q;  // Q [64][128]
  unsigned char* ring;
  float* prompt;  // [3][16][kF32PromptLd]
  float* red;     // [2 passes][2 warpgroups][64]
  uint64_t *full, *empty, *xfull, *xempty;
  __device__ __forceinline__ explicit F32Smem(unsigned char* raw) {
    unsigned char* base = align1024(raw);
    x = reinterpret_cast<float*>(base);
    q = reinterpret_cast<float*>(base + kF32XBytes);
    ring = base + kF32XBytes + kF32QBytes;
    prompt = reinterpret_cast<float*>(ring + kF32Stages * kF32SlotBytes);
    red = prompt + 3 * kUnitMaxTok * kF32PromptLd;
    full = reinterpret_cast<uint64_t*>(red + 2 * 2 * kF32Rows);
    empty = full + kF32Stages;
    xfull = empty + kF32Stages;
    xempty = xfull + 1;
  }
  __device__ __forceinline__ unsigned char* slot(int s) const {
    return ring + s * kF32SlotBytes;
  }
  // thread 0, before the block's first __syncthreads
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < kF32Stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // each consumer warpgroup releases it
    }
    mbar_init(xfull, 1);
    mbar_init(xempty, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// The producer thread's side: weight k-blocks into the ring in the order
// the consumers take them, a unit's rows into X (or Q)
struct F32Producer {
  const F32Smem& sm;
  int kg;  // k-blocks issued: k-block kg sits in slot kg % kF32Stages
  __device__ __forceinline__ explicit F32Producer(const F32Smem& s)
      : sm(s), kg(0) {}
  // k-block kb ([rows][16] at columns 16 kb) of W's hi and lo planes (maps
  // of [rows, K] f32 in boxes [rows][16], 64-byte swizzle)
  __device__ __forceinline__ void weights(const CUtensorMap* hi,
                                          const CUtensorMap* lo, int kb,
                                          int rows) {
    const int s = kg % kF32Stages, ph = (kg / kF32Stages) & 1;
    ++kg;
    mbar_wait(&sm.empty[s], ph ^ 1);
    mbar_expect_tx(&sm.full[s], 2 * rows * kF32WK * 4);
    tma_load_2d(sm.slot(s), hi, &sm.full[s], kb * kF32WK, 0);
    tma_load_2d(sm.slot(s) + rows * kF32WK * 4, lo, &sm.full[s], kb * kF32WK,
                0);
  }
  // nkb k-blocks [64 rows][32] of rows r0 .. r0 + 63 of map into tile (X,
  // or Q for B5's stage 1), once the consumers have released their previous
  // unit's (local unit k)
  __device__ __forceinline__ void rows(float* tile, const CUtensorMap* map,
                                       int nkb, int r0, int k) {
    mbar_wait(sm.xempty, (k & 1) ^ 1);
    mbar_expect_tx(sm.xfull, nkb * kF32TileKB * 4);
    for (int kb = 0; kb < nkb; ++kb)
      tma_load_2d(tile + kb * kF32TileKB, map, sm.xfull, kb * 32, r0);
  }
};

// The consumers' side: thread t of 256, warpgroup wg
struct F32Consumer {
  const F32Smem& sm;
  int t, wg, warp, g, tq, kg;
  bool lead, chief;  // a warpgroup's first thread; the block's first
  __device__ __forceinline__ F32Consumer(const F32Smem& s, int tid)
      : sm(s), t(tid), wg(tid >> 7), warp((tid & 127) >> 5),
        g((tid & 31) >> 2), tq(tid & 3), kg(0), lead((tid & 127) == 0),
        chief(tid == 0) {}
  // this thread's two accumulator rows within the unit (c < 2, c >= 2)
  __device__ __forceinline__ int row(int hf) const {
    return warp * 16 + g + 8 * hf;
  }
  __device__ __forceinline__ void sync() const { named_bar_sync(1, 256); }
  // generic-proxy writes to X, then read by TMA stores
  __device__ __forceinline__ void publish() const {
    fence_proxy_async();
    sync();
  }
  __device__ __forceinline__ void wait_rows(int k) const {
    mbar_wait(sm.xfull, k & 1);
  }
  // X is free for the next unit's rows once its stores have read it
  __device__ __forceinline__ void release_rows() const {
    if (chief) bulk_wait_read();
    sync();
    if (chief) mbar_arrive(sm.xempty);
  }
  // X (all 256 columns, just written) to rows n0 .. of prompt b of a
  // [B, N, 256] f32 map (boxes [64][32]; TMA clips rows past N), by the
  // chief; X is rewritten only after store_wait
  __device__ __forceinline__ void store_rows(const CUtensorMap* map, int b,
                                             int n0) const {
    publish();
    if (chief) {
#pragma unroll
      for (int kb = 0; kb < 8; ++kb)
        tma_store_3d(map, sm.x + kb * kF32TileKB, kb * 32, n0, b);
      bulk_commit();
    }
  }
  __device__ __forceinline__ void store_wait() const {
    if (chief) bulk_wait_read();
    sync();
  }
  __device__ __forceinline__ float* prompt(int i) const {
    return sm.prompt + i * kUnitMaxTok * kF32PromptLd;
  }
  // prompt rows src [T][128] f32 into copy i, zero past T, by cp.async
  // (no register holds them: issued for the next unit while this one ends,
  // waited for by wait_prompt, then a sync before they are read)
  __device__ __forceinline__ void load_prompt(int i, const float* src,
                                              int T) const {
    const uint32_t d = smem_u32(prompt(i));
#pragma unroll
    for (int e = t; e < kUnitMaxTok * kUnitCd / 4; e += 256)
      cp_async16(d + ((e >> 5) * kF32PromptLd + 4 * (e & 31)) * 4,
                 src + 4 * (e < T * kUnitCd / 4 ? e : 0),
                 e < T * kUnitCd / 4);
  }
  __device__ __forceinline__ void wait_prompt() const {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }

  // this warp's A fragments of weight k-block kb (columns 16 kb .. 16 kb +
  // 15 of the tile), split: a[ks][u] is row row(u & 1), column 16 kb + 8 ks
  // + tq + 4 (u >> 1); rows r and r + 8 share r & 7 = g, so a warp's loads
  // touch 8 distinct 16-byte chunks (conflict-free)
  __device__ __forceinline__ void load_a(const float* tile, int kb,
                                         uint32_t (&ah)[2][4],
                                         uint32_t (&al)[2][4]) const {
    const float* a = tile + (kb >> 1) * kF32TileKB;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = row(u & 1), ch = 4 * (kb & 1) + 2 * ks + (u >> 1);
        tf32_split(a[r * 32 + ((ch ^ (r & 7)) << 2) + tq], ah[ks][u],
                   al[ks][u]);
      }
  }

  // acc += A . W^T over nkb k-blocks of 16 (K = 16 nkb): A the unit's 64
  // rows of `tile`, W's rows c0 .. c0 + 8 NI - 1 of the ring's next nkb
  // slots (rows W rows a plane). Each k-block's six products go into a
  // partial from zero, added to acc once they complete; the slot is then
  // released. Ends with every consumer's reads of `tile` done.
  template <int NI>
  __device__ __forceinline__ void gemm(float* acc, const float* tile, int nkb,
                                       int rows, int c0) {
    uint32_t ah0[2][4], al0[2][4], ah1[2][4], al1[2][4];
    load_a(tile, 0, ah0, al0);
    const auto step = [&](int kb, uint32_t(&ah)[2][4], uint32_t(&al)[2][4],
                          uint32_t(&an)[2][4], uint32_t(&ln)[2][4]) {
      const int s = kg % kF32Stages, ph = (kg / kF32Stages) & 1;
      ++kg;
      mbar_wait(&sm.full[s], ph);
      const unsigned char* wh = sm.slot(s) + c0 * kF32WK * 4;
      const unsigned char* wl = wh + rows * kF32WK * 4;
      float part[4 * NI];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const uint64_t dh = sw64_desc(wh + ks * 32);
        const uint64_t dl = sw64_desc(wl + ks * 32);
        if constexpr (NI == 16) {
          wgmma_tf32_m64n128k8_rs(part, ah[ks], dl, ks > 0);
          wgmma_tf32_m64n128k8_rs(part, al[ks], dh, 1);
          wgmma_tf32_m64n128k8_rs(part, ah[ks], dh, 1);
        } else {
          wgmma_tf32_m64n64k8_rs(part, ah[ks], dl, ks > 0);
          wgmma_tf32_m64n64k8_rs(part, al[ks], dh, 1);
          wgmma_tf32_m64n64k8_rs(part, ah[ks], dh, 1);
        }
      }
      wgmma_commit();
      if (kb + 1 < nkb) load_a(tile, kb + 1, an, ln);
      wgmma_wait<0>();
      if (lead) mbar_arrive(&sm.empty[s]);
#pragma unroll
      for (int i = 0; i < 4 * NI; ++i) acc[i] += part[i];
    };
    // nkb is even (4, 8 or 16): the fragment sets alternate
    for (int kb = 0; kb < nkb; kb += 2) {
      step(kb, ah0, al0, ah1, al1);
      step(kb + 1, ah1, al1, ah0, al0);
    }
    sync();
  }
};

// ---- epilogues on accumulators of NI * 8 columns from c0 ------------------

// v = rows n0 + row(h) of p (a row-major f32 [., ld], p pointing at row n0,
// column c0), 0 for the rows past nvalid
template <int NI>
__device__ __forceinline__ void f32_acc_load(float* v, const float* p, int ld,
                                             int nvalid,
                                             const F32Consumer& c) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = c.row(h);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      float2 f = make_float2(0.f, 0.f);
      if (r < nvalid)
        f = __ldg(reinterpret_cast<const float2*>(p + (size_t)r * ld + 8 * i +
                                                  2 * c.tq));
      v[4 * i + 2 * h] = f.x;
      v[4 * i + 2 * h + 1] = f.y;
    }
  }
}

// v += bias[c0 + ...] (bias pointing at column c0)
template <int NI>
__device__ __forceinline__ void f32_acc_bias(float* v, const float* bias,
                                             int tq) {
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 8 * i +
                                                           2 * tq));
    v[4 * i] += b.x;
    v[4 * i + 1] += b.y;
    v[4 * i + 2] += b.x;
    v[4 * i + 3] += b.y;
  }
}

// v = the same positions of a tile (a residual kept on chip)
template <int NI>
__device__ __forceinline__ void f32_acc_from_tile(float* v, const float* tile,
                                                  int c0,
                                                  const F32Consumer& c) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const float2 f = *reinterpret_cast<const float2*>(
          tile + fswz(c.row(h), c0 + 8 * i + 2 * c.tq));
      v[4 * i + 2 * h] = f.x;
      v[4 * i + 2 * h + 1] = f.y;
    }
}

// v into a tile
template <int NI>
__device__ __forceinline__ void f32_acc_store(float* tile, const float* v,
                                              int c0, const F32Consumer& c) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < NI; ++i)
      *reinterpret_cast<float2*>(tile +
                                 fswz(c.row(h), c0 + 8 * i + 2 * c.tq)) =
          make_float2(v[4 * i + 2 * h], v[4 * i + 2 * h + 1]);
}

// LayerNorm of the unit's rows over 256 columns, the warpgroup's 128 in v
// (w, b pointing at column c0): each warpgroup's half-row sums through
// shared memory, mean then variance (two passes), as the plain version's
// formula (x - mean) / sqrt(var + eps) * w + b
__device__ __forceinline__ void f32_layer_norm(float* v, const float* w,
                                               const float* b, float eps,
                                               const F32Consumer& c) {
  float* red = c.sm.red;
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e >> 1] += v[4 * i + e];
  float m[2], d2[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] = quad_sum(s[h]);
    if (c.tq == 0) red[c.wg * kF32Rows + c.row(h)] = s[h];
  }
  c.sync();
#pragma unroll
  for (int h = 0; h < 2; ++h)
    m[h] = (red[c.row(h)] + red[kF32Rows + c.row(h)]) * (1.f / kUnitC);
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = v[4 * i + e] - m[e >> 1];
      d2[e >> 1] = fmaf(d, d, d2[e >> 1]);
    }
  float* red2 = red + 2 * kF32Rows;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    d2[h] = quad_sum(d2[h]);
    if (c.tq == 0) red2[c.wg * kF32Rows + c.row(h)] = d2[h];
  }
  c.sync();
  float rs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    rs[h] = 1.f / sqrtf((red2[c.row(h)] + red2[kF32Rows + c.row(h)]) *
                            (1.f / kUnitC) +
                        eps);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float2 wf =
        __ldg(reinterpret_cast<const float2*>(w + 8 * i + 2 * c.tq));
    const float2 bf =
        __ldg(reinterpret_cast<const float2*>(b + 8 * i + 2 * c.tq));
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[4 * i + e] = (v[4 * i + e] - m[e >> 1]) * rs[e >> 1] *
                         ((e & 1) ? wf.y : wf.x) +
                     ((e & 1) ? bf.y : bf.x);
  }
}

// the map of a row-major [rows, K] f32 weight plane in boxes [box_rows][16]
// (64 bytes a row, the 64-byte swizzle: the ring's layout)
inline bool make_map_w64(CUtensorMap* m, const void* p, int rows, int K,
                         int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn || !p) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kF32WK, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(p), dims,
            strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the map of a per-prompt [B, N, 256] f32 tensor in boxes of [64 rows][32]
// of one prompt (128-byte swizzle, X's layout): a box's rows past N are
// not written
inline bool map_prompt_rows_f32(CUtensorMap* m, const void* p, int B, int N) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn || !p) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)kUnitC, (cuuint64_t)N,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)kUnitC * 4,
                                 (cuuint64_t)N * kUnitC * 4};
  const cuuint32_t box[3] = {32, kF32Rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(p), dims,
            strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// work units a prompt of N image rows
inline int f32_units(int N) { return (N + kF32Rows - 1) / kF32Rows; }

}  // namespace
}  // namespace ullsam
