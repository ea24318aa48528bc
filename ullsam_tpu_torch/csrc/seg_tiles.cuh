// Segment tile skipping for the LLM flash kernels (B10, B11).
//
// A block owns one 64-row tile of one side (queries in B10 and B11's dq,
// keys in B11's dk + dv) and walks the 64-row tiles of the other side. A
// pair of rows can only interact when their segment ids are equal, so the
// block collects the ids of its own tile's runs of equal ids (one to three
// on a packed row) and marks the other side's tiles that hold one of them;
// the others are skipped, never loaded. The per-pair predicate still decides
// inside a live tile. On a packed row of documents that keeps the tiles
// near the block-diagonal.
#pragma once

#include "common.cuh"

namespace ullsam {

constexpr int kSegTile = 64;
constexpr int kMaxSegTiles = 4096;  // S <= 262144

struct SegTiles {
  int n;                               // runs of the own tile
  int ids[kSegTile];                   // each run's id, in row order
  int rows[kSegTile];                  // the own tile's ids, row by row
  unsigned starts[2];                  // bit r % 32: row r starts a run
  unsigned live[kMaxSegTiles / 32];    // bit t: tile t may interact
};

// the ids of the runs of equal ids of seg[r0, min(r0 + 64, S)), in row
// order (an id met again after another is listed once for each of its
// runs); all threads call (at least 64); ends synchronised
__device__ __forceinline__ void seg_own_ids(SegTiles& st, const int* seg,
                                            int r0, int S, int tid) {
  // rows past S repeat the last row's id, which adds no new one
  if (tid < kSegTile) st.rows[tid] = seg[min(r0 + tid, S - 1)];
  __syncthreads();
  const int lane = tid & 31;
  unsigned starts = 0;
  if (tid < kSegTile) {  // warps 0 and 1, whole
    starts = __ballot_sync(0xffffffffu,
                           tid == 0 || st.rows[tid - 1] != st.rows[tid]);
    if (lane == 0) st.starts[tid >> 5] = starts;
  }
  __syncthreads();
  if (tid < kSegTile) {  // each run's first row writes its id in place
    const int at = (tid >= 32 ? __popc(st.starts[0]) : 0) +
                   __popc(starts & ((1u << lane) - 1u));
    if ((starts >> lane) & 1u) st.ids[at] = st.rows[tid];
    if (tid == 0) st.n = __popc(st.starts[0]) + __popc(st.starts[1]);
  }
  __syncthreads();
}

__device__ __forceinline__ bool seg_in(const SegTiles& st, int s) {
  for (int i = 0; i < st.n; ++i)
    if (st.ids[i] == s) return true;
  return false;
}

// marks the tiles t in [t0, t1) holding a row r < S whose id is one of the
// own tile's; all threads call (nthreads a multiple of 32); ends
// synchronised. A warp reads kRuns runs of 32 rows a pass, their loads
// issued together (the bf16 bodies take 4; the f32 ones 1, which keeps
// their registers as they were)
template <int kRuns = 1>
__device__ __forceinline__ void seg_mark_live(SegTiles& st, const int* seg,
                                              int t0, int t1, int S, int tid,
                                              int nthreads) {
  for (int w = tid; w < (t1 + 31) / 32; w += nthreads) st.live[w] = 0u;
  __syncthreads();
  const int lane = tid & 31, end = min(t1 * kSegTile, S);
  // a warp reads 32 consecutive rows, all in one tile (tiles are 64-row
  // aligned), and sets its bit once
  for (int base = t0 * kSegTile + (tid - lane); base < end;
       base += kRuns * nthreads) {
    int id[kRuns];
#pragma unroll
    for (int u = 0; u < kRuns; ++u) {
      const int r = base + u * nthreads + lane;
      id[u] = r < end ? seg[r] : 0;
    }
#pragma unroll
    for (int u = 0; u < kRuns; ++u) {
      const int run = base + u * nthreads;
      const bool hit = run + lane < end && seg_in(st, id[u]);
      if (__ballot_sync(0xffffffffu, hit) && lane == 0) {
        const int t = run / kSegTile;
        atomicOr(&st.live[t >> 5], 1u << (t & 31));
      }
    }
  }
  __syncthreads();
}

// the first live tile in [t, t1), or t1
__device__ __forceinline__ int seg_next_live(const SegTiles& st, int t,
                                             int t1) {
  while (t < t1 && !((st.live[t >> 5] >> (t & 31)) & 1u)) ++t;
  return t;
}

}  // namespace ullsam
