// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11; the Random123 constants), the one counter-based generator of
// the port's dropout kernels: the fused self-attention forward and backward
// (attention-probability dropout, drawn in the forward and drawn again in
// the backward) and the dropout-mask generator.
//
// A mask is a function of (two seed words, flat element index) and of
// nothing else: element e of a mask takes word e % 4 of
// philox(counter = (lo32(e / 4), hi32(e / 4), 0, 0), key = seed words).
// No kernel's tiling enters, so any kernel, and the plain PyTorch version
// (`gdl_tpu_torch/ops/dropout.py::philox_u32`), draws the same bits.
// An element is kept iff its word, compared UNSIGNED, is below
// keep_thresh = min(round((1 - rate) * 2^32), 2^32 - 1).

#pragma once

#include <cstdint>

namespace philox {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;

struct U4 {
  uint32_t v[4];
};

__host__ __device__ inline U4 philox4x32_10(uint32_t c0, uint32_t c1,
                                            uint32_t c2, uint32_t c3,
                                            uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint64_t p0 = static_cast<uint64_t>(kM0) * c0;
    const uint64_t p1 = static_cast<uint64_t>(kM1) * c2;
    const uint32_t n0 = static_cast<uint32_t>(p1 >> 32) ^ c1 ^ k0;
    const uint32_t n2 = static_cast<uint32_t>(p0 >> 32) ^ c3 ^ k1;
    c1 = static_cast<uint32_t>(p1);
    c3 = static_cast<uint32_t>(p0);
    c0 = n0;
    c2 = n2;
    k0 += kW0;
    k1 += kW1;
  }
  return U4{{c0, c1, c2, c3}};
}

// the four words of group `group` (elements 4*group .. 4*group + 3)
__host__ __device__ inline U4 group_words(uint64_t group, uint32_t k0,
                                          uint32_t k1) {
  return philox4x32_10(static_cast<uint32_t>(group),
                       static_cast<uint32_t>(group >> 32), 0u, 0u, k0, k1);
}

// keep[i] for the four consecutive elements e0 .. e0 + 3 (one Philox call
// when e0 is a multiple of 4, two otherwise)
__host__ __device__ inline void keep4(uint64_t e0, uint32_t k0, uint32_t k1,
                                      uint32_t keep_thresh, bool keep[4]) {
  const uint64_t g = e0 >> 2;
  const int off = static_cast<int>(e0 & 3u);
  const U4 a = group_words(g, k0, k1);
  if (off == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) keep[i] = a.v[i] < keep_thresh;
    return;
  }
  const U4 b = group_words(g + 1, k0, k1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = off + i;
    keep[i] = (j < 4 ? a.v[j] : b.v[j - 4]) < keep_thresh;
  }
}

// Where a mask lies in the stream: local element e draws stream element
// offset + (e / seg_elems) * seg_stride + e % seg_elems (all three
// multiples of 4, so a Philox group never straddles two segments).
// seg_elems == seg_stride is one segment, elements offset, offset + 1, ...
// of the stream: a rank's rows of a [B...] tensor; three segments are a
// rank's rows of three stacked batches [3b...] (ops/dropout.py). A run of
// elements inside one segment is a run of the stream, so a kernel maps
// the first element of such a run and draws from there (keep4).
struct Layout {
  uint64_t offset, seg_elems, seg_stride;

  __host__ __device__ uint64_t element(uint64_t e) const {
    if (seg_elems == seg_stride) return offset + e;
    const uint64_t seg = e / seg_elems;
    return offset + seg * seg_stride + (e - seg * seg_elems);
  }
};

}  // namespace philox
