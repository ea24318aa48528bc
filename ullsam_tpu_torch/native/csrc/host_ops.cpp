// Native host ops for ullsam_tpu_torch: COCO-RLE encoding and decoding,
// connected components and the mask IoU matrix (a copy of
// ullsam_tpu/native/csrc/host_ops.cpp; the IoU counts on bit-packed rows).
// Replaces the reference's external native deps (pycocotools's C encoder,
// OpenCV's connectedComponentsWithStats) with a dependency-free C ABI
// library loaded via ctypes.
//
// Build: ullsam_tpu_torch/native/build.py (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Column-major run-length encode B HxW binary masks (COCO convention:
// counts start with a zero-run). masks: B*H*W uint8 (row-major [B,H,W]).
// counts_out: caller-allocated flat int32 buffer of capacity max_counts.
// lengths_out: per-mask number of counts (B entries).
// Returns total counts written, or -1 if max_counts would be exceeded.
int64_t rle_encode_masks(const uint8_t* masks, int64_t B, int64_t H,
                         int64_t W, int32_t* counts_out, int64_t max_counts,
                         int64_t* lengths_out) {
  int64_t total = 0;
  for (int64_t b = 0; b < B; ++b) {
    const uint8_t* m = masks + b * H * W;
    int64_t start = total;
    uint8_t cur = 0;  // COCO starts with a 0-run (may be length 0)
    int64_t run = 0;
    // column-major traversal of the row-major [H, W] mask
    for (int64_t x = 0; x < W; ++x) {
      for (int64_t y = 0; y < H; ++y) {
        uint8_t v = m[y * W + x] != 0;
        if (v == cur) {
          ++run;
        } else {
          if (total >= max_counts) return -1;
          counts_out[total++] = static_cast<int32_t>(run);
          cur = v;
          run = 1;
        }
      }
    }
    if (total >= max_counts) return -1;
    counts_out[total++] = static_cast<int32_t>(run);
    lengths_out[b] = total - start;
  }
  return total;
}

// Decode one uncompressed RLE into a row-major [H, W] uint8 mask.
void rle_decode(const int32_t* counts, int64_t n_counts, int64_t H,
                int64_t W, uint8_t* mask_out) {
  std::memset(mask_out, 0, static_cast<size_t>(H * W));
  int64_t idx = 0;
  uint8_t val = 0;
  for (int64_t i = 0; i < n_counts; ++i) {
    int64_t run = counts[i];
    if (val) {
      for (int64_t j = idx; j < idx + run && j < H * W; ++j) {
        int64_t x = j / H, y = j % H;  // column-major index
        mask_out[y * W + x] = 1;
      }
    }
    idx += run;
    val = !val;
  }
}

// 8-connected components labeling (two-pass union-find), matching OpenCV's
// connectedComponentsWithStats default connectivity used by the reference
// (utils/amg.py:274-291). mask: H*W uint8; labels_out: H*W int32
// (0 = background, components numbered 1..n). Returns n.
int32_t connected_components(const uint8_t* mask, int64_t H, int64_t W,
                             int32_t* labels_out) {
  std::vector<int32_t> parent;
  parent.reserve(1024);
  parent.push_back(0);  // background sentinel

  auto find = [&](int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };
  auto unite = [&](int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a != b) parent[a > b ? a : b] = (a < b ? a : b);
  };

  // first pass
  for (int64_t y = 0; y < H; ++y) {
    for (int64_t x = 0; x < W; ++x) {
      int64_t i = y * W + x;
      if (!mask[i]) {
        labels_out[i] = 0;
        continue;
      }
      int32_t neigh[4] = {0, 0, 0, 0};
      int n = 0;
      if (x > 0 && labels_out[i - 1]) neigh[n++] = labels_out[i - 1];
      if (y > 0) {
        const int64_t up = i - W;
        if (labels_out[up]) neigh[n++] = labels_out[up];
        if (x > 0 && labels_out[up - 1]) neigh[n++] = labels_out[up - 1];
        if (x + 1 < W && labels_out[up + 1]) neigh[n++] = labels_out[up + 1];
      }
      if (n == 0) {
        int32_t fresh = static_cast<int32_t>(parent.size());
        parent.push_back(fresh);
        labels_out[i] = fresh;
      } else {
        int32_t mn = neigh[0];
        for (int j = 1; j < n; ++j)
          if (neigh[j] < mn) mn = neigh[j];
        labels_out[i] = mn;
        for (int j = 0; j < n; ++j) unite(mn, neigh[j]);
      }
    }
  }

  // flatten + renumber
  std::vector<int32_t> remap(parent.size(), 0);
  int32_t next = 0;
  for (size_t l = 1; l < parent.size(); ++l) {
    int32_t r = find(static_cast<int32_t>(l));
    if (remap[r] == 0 && r == static_cast<int32_t>(l)) remap[r] = ++next;
  }
  for (int64_t i = 0; i < H * W; ++i) {
    if (labels_out[i]) labels_out[i] = remap[find(labels_out[i])];
  }
  return next;
}

// Batched binary IoU between two mask stacks at uint8 (used by eval
// utilities; A: [N, HW], B: [M, HW] flattened row-major). Each mask is
// packed to 64-bit words once, so a pair costs HW / 64 AND + popcount
// steps; the counts are exact integers and the quotient is taken in
// float32, inter / union (0 where the union is empty).
static void pack_bits(const uint8_t* m, int64_t n, int64_t HW, int64_t words,
                      uint64_t* out, int64_t* area) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* row = m + i * HW;
    uint64_t* dst = out + i * words;
    int64_t count = 0;
    for (int64_t w = 0; w < words; ++w) {
      uint64_t bits = 0;
      const int64_t base = w * 64;
      const int64_t end = base + 64 < HW ? base + 64 : HW;
      for (int64_t k = base; k < end; ++k)
        bits |= static_cast<uint64_t>(row[k] != 0) << (k - base);
      dst[w] = bits;
      count += __builtin_popcountll(bits);
    }
    area[i] = count;
  }
}

void mask_iou_matrix(const uint8_t* a, int64_t N, const uint8_t* b,
                     int64_t M, int64_t HW, float* iou_out) {
  const int64_t words = (HW + 63) / 64;
  std::vector<uint64_t> pa(N * words), pb(M * words);
  std::vector<int64_t> area_a(N, 0), area_b(M, 0);
  pack_bits(a, N, HW, words, pa.data(), area_a.data());
  pack_bits(b, M, HW, words, pb.data(), area_b.data());
  for (int64_t i = 0; i < N; ++i) {
    const uint64_t* ra = pa.data() + i * words;
    for (int64_t j = 0; j < M; ++j) {
      const uint64_t* rb = pb.data() + j * words;
      int64_t inter = 0;
      for (int64_t w = 0; w < words; ++w)
        inter += __builtin_popcountll(ra[w] & rb[w]);
      int64_t uni = area_a[i] + area_b[j] - inter;
      iou_out[i * M + j] = uni > 0 ? static_cast<float>(inter) / uni : 0.0f;
    }
  }
}

}  // extern "C"
