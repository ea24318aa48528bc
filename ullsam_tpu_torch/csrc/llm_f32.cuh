// The split-TF32 ("3xTF32") pieces of the float32 bodies of the LLM flash
// attention for Hopper (sm_90a): B10's forward (llm_flash_attn.cu,
// llm_flash_tf32) and B11's backward (llm_flash_bwd.cu, llm_bwd_dq_tf32
// and llm_bwd_dkv_tf32).
//
// An f32 operand x is hi = tf32(x) plus lo = tf32(x - hi) (tf32.cuh), and
// each product is issued three times on wgmma into one f32 accumulator,
// A_hi B_lo and A_lo B_hi first, then A_hi B_hi: f32-accurate products at
// 495 / 3 TFLOP/s, not the CUDA cores' 67. TF32 wgmma reads shared memory
// K-major only, so a pre-pass (llm_split_f32) writes the hi and lo planes
// of what the kernels read from shared memory into scratch that the
// wrapper allocates, head-major, each head's positions padded with zero
// rows to Sp = 64 ceil(S / 64):
//   * natural planes [B H][Sp][D], read by TMA in boxes of 32 columns (128
//     bytes, 128-byte swizzle) by R rows: a plane of R rows in shared
//     memory is D / 32 such boxes [R][128 bytes];
//   * transposed planes [B H][D][Sp], each 8-group of positions in the
//     order lf32_pi in which a register A operand taken from an m64
//     accumulator holds its k (keys 2 t and 2 t + 1 of thread t are its
//     k t and t + 4), read in boxes of D rows by C columns (C = 32: rows
//     of 128 bytes in the 128-byte swizzle; C = 16: 64 bytes, 64-byte
//     swizzle).
// The tensor cores' f32 accumulation is not IEEE's: each product added
// can lose up to about half an ulp of the running sum, one way (PERF.md
// section 6, PRs 13-14). So no accumulator runs a long chain: a logit
// tile sums its k-steps in kLf32Chains chains of D / 32 steps (12 products
// at D = 128), added on the CUDA cores in a fixed order; a tile's p.v goes
// into a partial from zero; dQ, dK and dV are added to their f32 rows in
// device memory every kLf32FlushRows rows of the walk (48 products) and
// restart from zero. Every sum has a fixed order: no atomics, the same bits
// every call.
//
// B10's blocks are one consumer warpgroup of 64 rows and a producer
// warpgroup whose first thread issues the TMA loads (at 256 threads a
// thread may hold 255 registers, so setmaxnreg would move nothing); B11's
// blocks have two consumer warpgroups, to which the producer gives its
// registers.
#pragma once

#include "llm_sm90.cuh"
#include "seg_tiles.cuh"
#include "tf32.cuh"

namespace ullsam {
namespace {

constexpr int kLf32Rows = 64;        // rows (queries or keys) a block owns
constexpr int kLf32Chains = 4;       // accumulators of a logit tile
constexpr int kLf32FlushRows = 128;  // rows of the walk a partial sums
constexpr float kLf32EmptyLse = -1e30f;

// Planes of the float32 scratch, each Sp x D floats, per query head and
// per kv head: the forward's q (pre-scaled) hi, lo and k hi, lo natural,
// v hi, lo transposed; the backward's q, do hi, lo natural and transposed,
// k hi, lo natural and transposed, v hi, lo natural. Must match
// ops/kernels/llm_flash_attention.py F32_FWD_PLANES / F32_BWD_PLANES.
constexpr int kLf32FwdQPlanes = 2, kLf32FwdKvPlanes = 4;
constexpr int kLf32BwdQPlanes = 8, kLf32BwdKvPlanes = 6;

// Position c of an 8-group of a transposed plane holds position
// lf32_pi(c) of the group
__host__ __device__ constexpr int lf32_pi(int c) {
  return c < 4 ? 2 * c : 2 * (c - 4) + 1;
}

// d[64 x 16] += A[64 x 8] . B[16 x 8]^T in TF32, A and B K-major in
// shared memory
__device__ __forceinline__ void lf32_ss_n16(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 32] += A[64 x 8] . B[32 x 8]^T in TF32, A and B K-major in
// shared memory
__device__ __forceinline__ void lf32_ss_n32(float* d, uint64_t da,
                                          uint64_t db) {
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
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 64] += A[64 x 8] . B[64 x 8]^T in TF32: A from registers (TF32
// values in the m64k8 fragment layout), B K-major in shared memory
__device__ __forceinline__ void lf32_rs_n64(float* d, const uint32_t* a,
                                          uint64_t db) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 8] . B[128 x 8]^T in TF32: A from registers (TF32
// values in the m64k8 fragment layout), B K-major in shared memory
__device__ __forceinline__ void lf32_rs_n128(float* d, const uint32_t* a,
                                          uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void lf32_ss(float* d, uint64_t da, uint64_t db) {
  static_assert(N == 16 || N == 32, "streamed tiles of 16 or 32 rows");
  if constexpr (N == 16)
    lf32_ss_n16(d, da, db);
  else
    lf32_ss_n32(d, da, db);
}

template <int N>
__device__ __forceinline__ void lf32_rs(float* d, const uint32_t* a,
                                        uint64_t db) {
  static_assert(N == 64 || N == 128, "head dims 64 and 128");
  if constexpr (N == 64)
    lf32_rs_n64(d, a, db);
  else
    lf32_rs_n128(d, a, db);
}

// ch[c] (+)= a . b^T over k-steps c D / 32 .. (c + 1) D / 32 - 1 in split
// TF32 (three products a step, the small ones first), a and b natural
// planes of 64 and N rows (a_desc / b_desc (ks, lo): the descriptor of
// k-step ks of the hi or lo plane). Chain by chain: taking the products
// in turns across the chains ran no faster on an H100 and held more
// registers.
template <int D, int N, class ADesc, class BDesc>
__device__ __forceinline__ void lf32_logits(float (&ch)[kLf32Chains][N / 2],
                                            ADesc a_desc, BDesc b_desc) {
  constexpr int kSteps = D / 8 / kLf32Chains;
#pragma unroll
  for (int c = 0; c < kLf32Chains; ++c)
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
      for (int prod = 0; prod < 3; ++prod) {
        const int ks = c * kSteps + kk;
        lf32_ss<N>(ch[c], a_desc(ks, prod == 1), b_desc(ks, prod == 0));
      }
}

// the descriptor of k-step ks (columns 8 ks .. 8 ks + 7) of a natural
// plane of R rows
template <int R>
__device__ __forceinline__ uint64_t lf32_nat_desc(const unsigned char* p,
                                                  int ks) {
  return swz_desc<128>(p + (ks >> 2) * R * 128 + (ks & 3) * 32);
}

// the descriptor of k-step j (positions 8 j .. 8 j + 7) of a transposed
// plane [D][C]
template <int C>
__device__ __forceinline__ uint64_t lf32_tr_desc(const unsigned char* p,
                                                 int j) {
  return swz_desc<4 * C>(p + 32 * j);
}

// the map of an f32 array [rows][cols] in boxes of box_rows rows by
// box_cols columns (32: the 128-byte swizzle; 16: the 64-byte one)
inline bool lf32_map(CUtensorMap* map, const float* p, long long rows,
                     long long cols, int box_cols, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// rows row .. of a natural map (its box rows at a time) into rows r0 .. of
// the plane of R rows at p
template <int D, int R>
__device__ __forceinline__ void lf32_load_rows(unsigned char* p, int r0,
                                               const CUtensorMap* map,
                                               uint64_t* bar, int row) {
#pragma unroll
  for (int c = 0; c < D / 32; ++c)
    tma_load_2d(p + c * R * 128 + r0 * 128, map, bar, 32 * c, row);
}

// grid (Sp / 32, B H), 256 threads: positions 32 blockIdx.x .. + 31 of
// head h = blockIdx.y % H of batch row b = blockIdx.y / H of src [B, S, H,
// D], times mul (rounded in f32; 1 leaves x as it is), split into hi and
// lo: natural planes [B H][Sp][D] at nat (hi) and nat + B H Sp D (lo);
// transposed ones [B H][D][Sp] at tr and tr + B H Sp D. Positions past S
// are zero. nat or tr may be null.
template <int D>
__global__ void __launch_bounds__(256)
    llm_split_f32(const float* __restrict__ src, int S, int Sp, int H,
                  float mul, float* __restrict__ nat,
                  float* __restrict__ tr) {
  __shared__ float tile[32][D + 1];
  const int bh = blockIdx.y, b = bh / H, h = bh % H, r0 = blockIdx.x * 32;
  const size_t plane = (size_t)gridDim.y * Sp * D;
  for (int e = threadIdx.x; e < 32 * D; e += 256) {
    const int r = e / D, d = e % D, s = r0 + r;
    const float x =
        s < S ? src[(((size_t)b * S + s) * H + h) * D + d] * mul : 0.f;
    if (nat) {
      const size_t o = ((size_t)bh * Sp + s) * D + d;
      uint32_t hi, lo;
      tf32_split(x, hi, lo);
      nat[o] = __uint_as_float(hi);
      nat[plane + o] = __uint_as_float(lo);
    }
    tile[r][d] = x;
  }
  if (!tr) return;
  __syncthreads();
  for (int e = threadIdx.x; e < D * 32; e += 256) {
    const int d = e / 32, c = e % 32;
    const float x = tile[(c & ~7) + lf32_pi(c & 7)][d];
    const size_t o = ((size_t)bh * D + d) * Sp + r0 + c;
    uint32_t hi, lo;
    tf32_split(x, hi, lo);
    tr[o] = __uint_as_float(hi);
    tr[plane + o] = __uint_as_float(lo);
  }
}

template <int D>
inline int lf32_split(const float* src, int B, int S, int Sp, int H,
                      float mul, float* nat, float* tr, cudaStream_t st) {
  llm_split_f32<D><<<dim3(Sp / 32, B * H), 256, 0, st>>>(src, S, Sp, H, mul,
                                                        nat, tr);
  return (int)cudaGetLastError();
}

// A block's walk over the other side: for each of `heads` heads, the live
// 64-row tiles in [t0, t1) (seg_tiles.cuh), each as 64 / R tiles of R
// rows. The producer and the consumer walk it alike.
template <int R>
struct Lf32Walk {
  static constexpr int kSubs = kSegTile / R;
  const SegTiles& st;
  int t0, t1, heads, h, t, u;
  __device__ __forceinline__ Lf32Walk(const SegTiles& s, int t0_, int t1_,
                                      int heads_)
      : st(s), t0(t0_), t1(t1_), heads(heads_), h(0),
        t(seg_next_live(s, t0_, t1_)), u(0) {}
  __device__ __forceinline__ bool valid() const { return t < t1; }
  __device__ __forceinline__ int row0() const { return t * kSegTile + u * R; }
  __device__ __forceinline__ void next() {
    if (++u < kSubs) return;
    u = 0;
    t = seg_next_live(st, t + 1, t1);
    if (t >= t1 && ++h < heads) t = seg_next_live(st, t0, t1);
  }
};

// a consumer warp is done with what `bar` guards (its products waited)
__device__ __forceinline__ void lf32_release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// out[row g + 8 hf][column 8 i + 2 t, + 1] (+)= acc for the thread's two
// rows of an m64nD accumulator (row pointers; null: a row past S), times
// mul; then acc = 0. `first` overwrites.
template <int D>
__device__ __forceinline__ void lf32_flush(float* const (&rows)[2],
                                           float (&acc)[D / 2], int t,
                                           bool first, float mul) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (!rows[hf]) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      float2* o = reinterpret_cast<float2*>(rows[hf] + 8 * i + 2 * t);
      const float2 v = first ? make_float2(0.f, 0.f) : *o;
      *o = make_float2((v.x + acc[4 * i + 2 * hf]) * mul,
                       (v.y + acc[4 * i + 2 * hf + 1]) * mul);
    }
  }
#pragma unroll
  for (int c = 0; c < D / 2; ++c) acc[c] = 0.f;
}

}  // namespace
}  // namespace ullsam
