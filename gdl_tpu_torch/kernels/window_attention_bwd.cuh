// The window-attention backward of one (window, head), the device body of
// kernels #4, #4-delta, #6's and #7's backwards and #3's attention stage
// (window_attention_train.cu holds their kernels and launchers and the
// functions they compute). Per (window, head), from q, k, v, dout and p
// (saved in T, or computed again in f32 with RECOMPUTE):
//
//   q_s = round_T(q * round_T(scale))
//   dp  = dout . v^T                              (f32)
//   ds  = p * (dp - rowsum(dp * p))  (or dp - delta with DELTA)
//   dbias[h] += ds                                (f32, unrounded)
//   dq  = round_T(ds) . k * scale;  dk = round_T(ds)^T . q_s
//   dv  = p_T^T . dout   (p_T: the saved p, or round_T(p) with RECOMPUTE)
//   [dq | dk | dv] -> dqkv in T;  with DB the column sums of what was
//   stored (kernel #3's db)
//
// Design. A block of four warps owns one head (or walks a group of heads)
// and a run of windows; each (window, head) of the run is a tile:
//   - loads: q, k, v and dout rows (d contiguous elements at strides 3C
//     and C) come in by cp.async in the widest piece their alignment
//     allows (16, 8 or 4 bytes; element by element where no piece fits),
//     p's [n, n] slab as one contiguous span (16-byte copies of its
//     aligned interior, element copies at its two edges, never a byte
//     outside it) into a flat buffer shifted so that the copies stay
//     aligned. Shared memory is zeroed once at block start and the copies
//     write only rows < n, columns < d: the pads stay zero. In bf16 the
//     next tile's copies run under this tile's products (two stages); f32
//     and RECOMPUTE take one stage, so that three blocks fit an SM (two
//     in f32 with RECOMPUTE). RECOMPUTE copies bias[h] once and each
//     window's mask, the next one's as soon as this one's scores are
//     formed: read from device memory by each lane, they cost more than
//     the scores' product;
//   - phase 1, warp w on the query rows 16w .. 16w + 15 (the keys < n in
//     8-key tiles): it scales its rows of q in place, forms dp (and with
//     RECOMPUTE the scores, then p by a softmax in registers: exp by
//     ex2.approx, one reciprocal a row) as 16 x 8 fragments, the row sums
//     by two quad shuffles, ds in the same fragments (its share of dbias
//     stays in that layout across the run), writes round_T(ds) to shared
//     memory and forms dq = ds_T . k;
//   - one barrier, then phase 2, warp w on the keys 16w .. 16w + 15:
//     dk = ds_T^T . q_s and dv = p_T^T . dout, K = the queries.
// bf16: every product on the tensor cores (mma.sync m16n8k16, f32 sums):
// the A operand of dq straight from ds's accumulator registers, k, v, q_s
// and dout through ldmatrix (.trans where K is their row index), ds_T
// through ldmatrix.trans, p's A fragments from the flat buffer. f32: the
// same fragment layout on FMA (no TF32), float4 and float2 reads of the
// row tiles. Each sum has a fixed order and no atomics: two runs give
// equal bits. The flat copies, the scores' product (rows_by_keys) and
// the softmax (softmax_rows) are the forward body's, in
// window_attention_fwd.cuh: #7's backward computes p as the forwards
// compute it.

#pragma once

#include <cstdint>

#include "gemm_tile.cuh"
#include "window_attention_fwd.cuh"

namespace {

// What a launch of the backward body reads and writes, in element counts.
struct BwdArgs {
  const void* qkv;      // [bw, n, 3c] in T
  const void* p;        // [bw, heads, n, n] in T (null with RECOMPUTE)
  const void* dout;     // [bw, n, c] in T
  const float* delta;   // DELTA: [bw, heads, n]
  const float* bias;    // RECOMPUTE: [heads, n, n]
  const float* mask;    // RECOMPUTE: [nw, n, n] or null
  void* dqkv;           // [bw, n, 3c] in T
  float* dbias_part;    // [ceil(bw / wpb), heads, n, n]
  float* db_part;       // DB: [ceil(bw / wpb), 3c]
  int bw, n, c, heads, d, nw;
  int g;       // heads a block walks in turn (1, or #6's head group)
  int wpb;     // windows a block walks for each head
  float scale;
  int width;   // bytes a copy of a row piece takes: 16, 8, 4 or 0 (element)
  int pairs;   // 1: dqkv's column pairs are stored together (d even)
};

// Shared memory of a block, sized by n at launch: NS stages of
// [q | k | v | dout] row tiles [kNP][LDQ] (RowTile) and the flat p buffer,
// then the ds tile [kNP][LDS]; with RECOMPUTE then bias[h] as a flat f32
// buffer and, in bf16, mask[w % nw] as another (f32 copies each window's
// mask into its stage's p buffer and writes p_T over it, element for
// element).
template <typename T, int DMAX, bool RECOMPUTE = false>
struct BwdLayout {
  static constexpr bool kBf16 = RowTile<T, DMAX>::kBf16;
  static constexpr int LDQ = RowTile<T, DMAX>::LDQ;
  static constexpr int LDS = kNP + 8;
  static constexpr int NS = kBf16 && !RECOMPUTE ? 2 : 1;
  static constexpr int TILE = RowTile<T, DMAX>::TILE;
  static constexpr int kFlatBuffers = RECOMPUTE ? (kBf16 ? 2 : 1) : 0;
  // blocks an SM that the registers must allow: what shared memory allows
  // at the Swin shapes (d = 64: two), at most three
  static constexpr int MIN_BLOCKS = DMAX > 32 ? 2 : 3;

  // the flat p buffer: a shift of < 8, then n * n, in 16-byte pieces
  __host__ __device__ static constexpr int pflat(int n) {
    return (n * n + 8 + 7) / 8 * 8;
  }
  __host__ __device__ static constexpr int stage(int n) {
    return 4 * TILE + pflat(n);
  }
  // the stages and the ds tile, zeroed at block start
  __host__ __device__ static constexpr size_t zeroed_bytes(int n) {
    return sizeof(T) * (NS * stage(n) + kNP * LDS);
  }
  __host__ __device__ static constexpr size_t bytes(int n) {
    return zeroed_bytes(n) + sizeof(float) * kFlatBuffers * flat_floats(n);
  }
  __host__ __device__ static constexpr size_t max_bytes() {
    return bytes(kNP);
  }
};

__device__ __forceinline__ float bwd_f(float v) { return v; }
__device__ __forceinline__ float bwd_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ uint32_t bwd_bits(T v);
template <>
__device__ __forceinline__ uint32_t bwd_bits(__nv_bfloat16 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v));
}

// q, k, v and dout rows of one tile into the stage's four row tiles, in
// pieces of W bytes (0: element by element): q, k, v at qkv_w + 0, c, 2c
// (rows 3c apart), dout at g_w (rows c apart). One base for q, k and v
// keeps the main loop within its registers: the forward's copy_rows, a
// pointer and a stride a source, raised #4's spills and cost #4 and #6
// 5% in bf16.
template <typename T, int DMAX, int W>
__device__ __forceinline__ void copy_qkv_dout_rows(T* qs, const T* qkv_w,
                                                   const T* g_w, int n, int c,
                                                   int d, int tid) {
  using L = BwdLayout<T, DMAX>;
  T* ks = qs + L::TILE;
  T* vs = ks + L::TILE;
  T* gs = vs + L::TILE;
  const int c3 = 3 * c;
  if constexpr (W == 0) {
    for (int e = tid; e < n * d; e += kBodyThreads) {
      const int r = e / d, col = e % d;
      const T* src = qkv_w + static_cast<size_t>(r) * c3 + col;
      qs[r * L::LDQ + col] = src[0];
      ks[r * L::LDQ + col] = src[c];
      vs[r * L::LDQ + col] = src[2 * c];
      gs[r * L::LDQ + col] = g_w[static_cast<size_t>(r) * c + col];
    }
  } else {
    constexpr int V = W / static_cast<int>(sizeof(T));
    const int per_row = d / V;
    for (int e = tid; e < n * per_row; e += kBodyThreads) {
      const int r = e / per_row, col = (e % per_row) * V;
      const T* src = qkv_w + static_cast<size_t>(r) * c3 + col;
      const int at = r * L::LDQ + col;
      copy_piece<W>(qs + at, src);
      copy_piece<W>(ks + at, src + c);
      copy_piece<W>(vs + at, src + 2 * c);
      copy_piece<W>(gs + at, g_w + static_cast<size_t>(r) * c + col);
    }
  }
}

// Tile (win, head)'s rows of q, k, v, dout, and (with_p) its p slab, into
// the stage at st; cp.async where the alignment allows, element copies
// where it does not. The caller commits the group.
template <typename T, int DMAX>
__device__ __forceinline__ void issue_tile(const BwdArgs& a, T* st, int win,
                                           int head, bool with_p, int tid) {
  using L = BwdLayout<T, DMAX>;
  const int n = a.n, c = a.c, d = a.d;
  const T* qkv_w = static_cast<const T*>(a.qkv) +
                   static_cast<size_t>(win) * n * 3 * c + head * d;
  const T* g_w =
      static_cast<const T*>(a.dout) + static_cast<size_t>(win) * n * c +
      head * d;
  switch (a.width) {
    case 16:
      copy_qkv_dout_rows<T, DMAX, 16>(st, qkv_w, g_w, n, c, d, tid);
      break;
    case 8:
      copy_qkv_dout_rows<T, DMAX, 8>(st, qkv_w, g_w, n, c, d, tid);
      break;
    case 4:
      copy_qkv_dout_rows<T, DMAX, 4>(st, qkv_w, g_w, n, c, d, tid);
      break;
    default:
      copy_qkv_dout_rows<T, DMAX, 0>(st, qkv_w, g_w, n, c, d, tid);
  }
  if (with_p)
    copy_flat(st + 4 * L::TILE,
              static_cast<const T*>(a.p) +
                  (static_cast<size_t>(win) * a.heads + head) * n * n,
              n * n, tid);
}

template <typename T, int DMAX>
__device__ __forceinline__ void zero_acc(float (&acc)[DMAX / 8][4]) {
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// Stores the warp's rows r0 + g (+ 8) < n of a [16, DMAX] fragment block
// into dqkv's column block `part` (0: dq, 1: dk, 2: dv) of tile (win,
// head), each value times `mul` and rounded to T; with DB adds what it
// stored to the column sums db[j][0..1].
template <typename T, int DMAX, bool DB>
__device__ __forceinline__ void store_part(const BwdArgs& a,
                                           const float (&acc)[DMAX / 8][4],
                                           float mul, int part, int win,
                                           int head, int r0, int lane,
                                           float (&db)[DMAX / 8][2]) {
  const int g = lane / 4, q = lane % 4;
  const int n = a.n, d = a.d, c3 = 3 * a.c;
  T* base = static_cast<T*>(a.dqkv) + static_cast<size_t>(win) * n * c3 +
            part * a.c + head * d;
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
    const int col = 8 * j + 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g + 8 * h;
      const T v0 = Num<T>::store(acc[j][2 * h] * mul);
      const T v1 = Num<T>::store(acc[j][2 * h + 1] * mul);
      if constexpr (DB) {  // rows and columns past n and d hold zeros
        db[j][0] += bwd_f(v0);
        db[j][1] += bwd_f(v1);
      }
      if (row >= n || col >= d) continue;
      T* dst = base + static_cast<size_t>(row) * c3 + col;
      if (a.pairs) {  // d even: col + 1 < d, and the pair is aligned
        if constexpr (sizeof(T) == 2) {
          __nv_bfloat162 v;
          v.x = v0;
          v.y = v1;
          *reinterpret_cast<__nv_bfloat162*>(dst) = v;
        } else {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        }
      } else {
        dst[0] = v0;
        if (col + 1 < d) dst[1] = v1;
      }
    }
  }
}

// Phase 1 of one tile for the warp on query rows r0 .. r0 + 15 (r0 < n):
// q_s in place, dp (and with RECOMPUTE s and p, from the flat bias and
// mask buffers bias_s, mask_s), ds, dbias, the ds tile, dq stored. The
// stage's p buffer holds p (or receives p_T) at shift pshift.
template <typename T, int DMAX, bool DELTA, bool RECOMPUTE, bool DB>
__device__ __forceinline__ void query_rows(const BwdArgs& a, T* st, T* dss,
                                           const float* bias_s,
                                           const float* mask_s, int pshift,
                                           int win,
                                           int head, int r0, int lane,
                                           float scale_t,
                                           float (&dbacc)[8][4],
                                           float (&dbq)[DMAX / 8][2]) {
  using L = BwdLayout<T, DMAX>;
  constexpr int DT = DMAX / 8;
  const int g = lane / 4, q = lane % 4;
  const int n = a.n;
  T* qs = st;
  T* ks = qs + L::TILE;
  T* vs = ks + L::TILE;
  T* gs = vs + L::TILE;
  T* ps = gs + L::TILE;

  // q_s on this warp's rows (read by the other warps only after the
  // phase barrier)
  scale_rows<T, DMAX>(qs, r0, lane, scale_t);

  // p of the warp's fragments, f32: read (rows and keys past n give 0),
  // or with RECOMPUTE softmax(q_s . k^T + bias + mask), unrounded, as the
  // forward computes it
  float pv[8][4];
  if constexpr (RECOMPUTE) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[j][e] = 0.f;
    rows_by_keys<T, DMAX>(pv, qs, ks, r0, n, a.d, lane);
    const float* bh =
        bias_s + flat_shift(a.bias + static_cast<size_t>(head) * n * n);
    const float* mw =
        a.mask != nullptr
            ? mask_s + flat_shift(a.mask +
                                  static_cast<size_t>(win % a.nw) * n * n)
            : nullptr;
    softmax_rows<false>(pv, bh, mw, n, n, r0, lane);
    T* pt = ps + pshift;  // in f32 over the mask: each lane has read
                          // the elements it writes
    // p_T = round_T(p) into the flat buffer for dv
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = r0 + g + 8 * (e / 2), jj = 8 * j + 2 * q + e % 2;
        if (i < n && jj < n) pt[i * n + jj] = Num<T>::store(pv[j][e]);
      }
  } else {
    const T* pw = ps + pshift;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = r0 + g + 8 * (e / 2), jj = 8 * j + 2 * q + e % 2;
        pv[j][e] = i < n && jj < n ? bwd_f(pw[i * n + jj]) : 0.f;
      }
  }

  // dp = dout . v^T; the row sums; ds = p * (dp - rowsum)
  float ds[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ds[j][e] = 0.f;
  rows_by_keys<T, DMAX>(ds, gs, vs, r0, n, a.d, lane);
  float rs[2];
  if constexpr (DELTA) {
    const float* dl =
        a.delta + (static_cast<size_t>(win) * a.heads + head) * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = r0 + g + 8 * h;
      rs[h] = i < n ? dl[i] : 0.f;
    }
  } else {
    rs[0] = rs[1] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        rs[e / 2] = fmaf(ds[j][e], pv[j][e], rs[e / 2]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
    }
  }
  // ds in f32 into dbias; round_T(ds) kept and written to the ds tile
  // (rows and keys past n: p = 0, so ds = 0)
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = pv[j][e] * (ds[j][e] - rs[e / 2]);
      dbacc[j][e] += v;
      ds[j][e] = Num<T>::round(v);
    }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      T* dst = dss + (r0 + g + 8 * h) * L::LDS + 8 * j + 2 * q;
      if constexpr (L::kBf16) {
        *reinterpret_cast<uint32_t*>(dst) =
            gemm::pack_bf16(ds[j][2 * h], ds[j][2 * h + 1]);
      } else {
        *reinterpret_cast<float2*>(dst) =
            make_float2(ds[j][2 * h], ds[j][2 * h + 1]);
      }
    }

  // dq = ds_T . k (K = the keys)
  float dq[DT][4];
  zero_acc<T, DMAX>(dq);
  if constexpr (L::kBf16) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (16 * kk >= n) break;
      // the A fragment of keys 16 kk .. + 15 is the accumulators of key
      // tiles 2 kk and 2 kk + 1
      const uint32_t af[4] = {
          gemm::pack_bf16(ds[2 * kk][0], ds[2 * kk][1]),
          gemm::pack_bf16(ds[2 * kk][2], ds[2 * kk][3]),
          gemm::pack_bf16(ds[2 * kk + 1][0], ds[2 * kk + 1][1]),
          gemm::pack_bf16(ds[2 * kk + 1][2], ds[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t b[4];  // k [keys][d], K outer: transposed
        gemm::ldsm_x4_trans(b, ks + (16 * kk + ((lane / 8) % 2) * 8 +
                                     lane % 8) * L::LDQ +
                                   8 * j + (lane / 16) * 8);
        gemm::mma_bf16(dq[j], af, b);
        gemm::mma_bf16(dq[j + 1], af, b + 2);
      }
    }
  } else {
    __syncwarp();  // this warp's rows of the ds tile are written
    const float* a0p = dss + (r0 + g) * L::LDS;
    const float* a1p = a0p + 8 * L::LDS;
    for (int t4 = 0; t4 < n; t4 += 4) {
      const float4 x0 = *reinterpret_cast<const float4*>(a0p + t4);
      const float4 x1 = *reinterpret_cast<const float4*>(a1p + t4);
      const float u0[4] = {x0.x, x0.y, x0.z, x0.w};
      const float u1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          const float2 b = *reinterpret_cast<const float2*>(
              ks + (t4 + u) * L::LDQ + 8 * j + 2 * q);
          dq[j][0] = fmaf(u0[u], b.x, dq[j][0]);
          dq[j][1] = fmaf(u0[u], b.y, dq[j][1]);
          dq[j][2] = fmaf(u1[u], b.x, dq[j][2]);
          dq[j][3] = fmaf(u1[u], b.y, dq[j][3]);
        }
    }
  }
  store_part<T, DMAX, DB>(a, dq, a.scale, 0, win, head, r0, lane, dbq);
}

// Phase 2 of one tile for the warp on keys m0 .. m0 + 15 (m0 < n):
// dk = ds_T^T . q_s and dv = p_T^T . dout (K = the queries, p_T in the
// stage's p buffer at shift pshift), stored.
template <typename T, int DMAX, bool DB>
__device__ __forceinline__ void key_rows(const BwdArgs& a, const T* st,
                                         const T* dss, int pshift, int win,
                                         int head, int m0, int lane,
                                         float (&dbk)[DMAX / 8][2],
                                         float (&dbv)[DMAX / 8][2]) {
  using L = BwdLayout<T, DMAX>;
  constexpr int DT = DMAX / 8;
  const int g = lane / 4, q = lane % 4;
  const int n = a.n;
  const T* qs = st;
  const T* gs = qs + 3 * L::TILE;
  const T* pw = qs + 4 * L::TILE + pshift;
  // p_T[i][m] (0 past n)
  auto p_at = [&](int i, int m) {
    return i < n && m < n ? pw[i * n + m] : Num<T>::store(0.f);
  };
  float dk[DT][4], dv[DT][4];
  zero_acc<T, DMAX>(dk);
  zero_acc<T, DMAX>(dv);
  if constexpr (L::kBf16) {
#pragma unroll
    for (int kk = 0; kk < kNP; kk += 16) {
      if (kk >= n) break;
      uint32_t ads[4];  // ds_T [queries][keys], K outer: transposed
      gemm::ldsm_x4_trans(ads, dss + (kk + (lane / 16) * 8 + lane % 8) *
                                         L::LDS +
                                     m0 + ((lane / 8) % 2) * 8);
      uint32_t ap[4];  // A[m][k] = p_T[k][m] from the flat buffer
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = kk + 2 * q + 8 * (r / 2), m = m0 + g + 8 * (r % 2);
        ap[r] = bwd_bits(p_at(i, m)) | (bwd_bits(p_at(i + 1, m)) << 16);
      }
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t b[4];  // q_s and dout [queries][d], K outer: transposed
        const int at = (kk + ((lane / 8) % 2) * 8 + lane % 8) * L::LDQ +
                       8 * j + (lane / 16) * 8;
        gemm::ldsm_x4_trans(b, qs + at);
        gemm::mma_bf16(dk[j], ads, b);
        gemm::mma_bf16(dk[j + 1], ads, b + 2);
        gemm::ldsm_x4_trans(b, gs + at);
        gemm::mma_bf16(dv[j], ap, b);
        gemm::mma_bf16(dv[j + 1], ap, b + 2);
      }
    }
  } else {
    for (int i = 0; i < n; ++i) {
      const float s0 = dss[i * L::LDS + m0 + g];
      const float s1 = dss[i * L::LDS + m0 + g + 8];
      const float p0 = p_at(i, m0 + g), p1 = p_at(i, m0 + g + 8);
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const float2 bq = *reinterpret_cast<const float2*>(
            qs + i * L::LDQ + 8 * j + 2 * q);
        const float2 bg = *reinterpret_cast<const float2*>(
            gs + i * L::LDQ + 8 * j + 2 * q);
        dk[j][0] = fmaf(s0, bq.x, dk[j][0]);
        dk[j][1] = fmaf(s0, bq.y, dk[j][1]);
        dk[j][2] = fmaf(s1, bq.x, dk[j][2]);
        dk[j][3] = fmaf(s1, bq.y, dk[j][3]);
        dv[j][0] = fmaf(p0, bg.x, dv[j][0]);
        dv[j][1] = fmaf(p0, bg.y, dv[j][1]);
        dv[j][2] = fmaf(p1, bg.x, dv[j][2]);
        dv[j][3] = fmaf(p1, bg.y, dv[j][3]);
      }
    }
  }
  store_part<T, DMAX, DB>(a, dk, 1.f, 1, win, head, m0, lane, dbk);
  store_part<T, DMAX, DB>(a, dv, 1.f, 2, win, head, m0, lane, dbv);
}

// The block: heads h0 .. h0 + g - 1 in turn, each over the windows of its
// run, one tile a (window, head); one dbias partial per (run, head) and
// with DB one db partial per run (dq, dk, dv column sums of the stored
// values: per lane over its rows in window order, then over the eight
// row groups of a warp by shuffles, then over the four warps in order).
template <typename T, int DMAX, bool DELTA, bool RECOMPUTE, bool DB>
__device__ __forceinline__ void bwd_windows(const BwdArgs& a) {
  static_assert(!(DB && (DELTA || RECOMPUTE)), "#3's stage A only");
  using L = BwdLayout<T, DMAX, RECOMPUTE>;
  constexpr int DT = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int stage = L::stage(a.n);
  T* dss = smem + L::NS * stage;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = a.n;
  const int groups = a.heads / a.g;
  const int run = blockIdx.x / groups, h0 = (blockIdx.x % groups) * a.g;
  const int w0 = run * a.wpb, nwin = min(a.bw, w0 + a.wpb) - w0;
  const int tiles = a.g * nwin;
  const float scale_t = Num<T>::round(a.scale);
  const int r0 = 16 * warp;

  for (int e = tid; e < static_cast<int>(L::zeroed_bytes(n) / 16);
       e += kBodyThreads)
    reinterpret_cast<int4*>(smem_raw)[e] = make_int4(0, 0, 0, 0);
  __syncthreads();

  // RECOMPUTE (one head a block): bias[h0] once, the window's mask with
  // each tile, into its own buffer in bf16 and into the stage's p buffer
  // in f32
  float* bias_s = reinterpret_cast<float*>(dss + kNP * L::LDS);
  float* mask_s = bias_s + flat_floats(n);
  auto mask_of = [&](int win) {
    return a.mask + static_cast<size_t>(win % a.nw) * n * n;
  };
  auto issue = [&](int t) {
    if (t < tiles) {
      T* st = smem + (t % L::NS) * stage;
      const int win = w0 + t % nwin;
      issue_tile<T, DMAX>(a, st, win, h0 + t / nwin, !RECOMPUTE, tid);
      if (RECOMPUTE && a.mask != nullptr)
        copy_flat(L::kBf16 ? mask_s
                           : reinterpret_cast<float*>(st + 4 * L::TILE),
                  mask_of(win), n * n, tid);
    }
    gemm::cp_async_commit();
  };
  if constexpr (RECOMPUTE)
    copy_flat(bias_s, a.bias + static_cast<size_t>(h0) * n * n, n * n, tid);

  float dbacc[8][4];  // this warp's share of dbias[head], fragment layout
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dbacc[j][e] = 0.f;
  float dbq[DT][2], dbk[DT][2], dbv[DT][2];
#pragma unroll
  for (int j = 0; j < DT; ++j)
    dbq[j][0] = dbq[j][1] = dbk[j][0] = dbk[j][1] = dbv[j][0] = dbv[j][1] =
        0.f;

  if constexpr (L::NS == 2) issue(0);
  for (int t = 0; t < tiles; ++t) {
    const int win = w0 + t % nwin, head = h0 + t / nwin;
    if constexpr (L::NS == 1) {
      if (t > 0) __syncthreads();  // the stage is free again
      issue(t);
    }
    gemm::cp_async_wait<0>();  // tile t has landed (for this thread)
    __syncthreads();  // ... for every thread; tile t - 1 is done
    if constexpr (L::NS == 2) issue(t + 1);  // under this tile's products
    T* st = smem + (t % L::NS) * stage;
    // where p (or p_T) lies in the stage's p buffer
    int pshift = 0;
    if constexpr (!RECOMPUTE)
      pshift = flat_shift(static_cast<const T*>(a.p) +
                          (static_cast<size_t>(win) * a.heads + head) * n * n);
    else if (!L::kBf16 && a.mask != nullptr)
      pshift = flat_shift(mask_of(win));
    if (r0 < n)
      query_rows<T, DMAX, DELTA, RECOMPUTE, DB>(
          a, st, dss, bias_s,
          L::kBf16 ? mask_s : reinterpret_cast<float*>(st + 4 * L::TILE),
          pshift, win, head, r0, lane, scale_t, dbacc, dbq);
    __syncthreads();  // ds_T, q_s (and p_T) are complete
    if (r0 < n)
      key_rows<T, DMAX, DB>(a, st, dss, pshift, win, head, r0, lane, dbk,
                            dbv);
    if (t % nwin == nwin - 1) {  // the head's run is done: its partial
      if (r0 < n) {
        const int g = lane / 4, q = lane % 4;
        float* part = a.dbias_part +
                      (static_cast<size_t>(run) * a.heads + head) * n * n;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = r0 + g + 8 * (e / 2), jj = 8 * j + 2 * q + e % 2;
            if (i < n && jj < n) part[i * n + jj] = dbacc[j][e];
            dbacc[j][e] = 0.f;
          }
      }
    }
  }
  gemm::cp_async_wait<0>();

  if constexpr (DB) {
    // red[warp][[q|k|v] DMAX + col] in the ds tile's space
    __syncthreads();
    float* red = reinterpret_cast<float*>(dss);
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          dbq[j][e] += __shfl_xor_sync(0xffffffffu, dbq[j][e], o);
          dbk[j][e] += __shfl_xor_sync(0xffffffffu, dbk[j][e], o);
          dbv[j][e] += __shfl_xor_sync(0xffffffffu, dbv[j][e], o);
        }
    if (lane < 4) {  // g = 0: one lane's sums, the same lane every run
#pragma unroll
      for (int j = 0; j < DT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * lane + e;
          red[warp * 3 * DMAX + col] = dbq[j][e];
          red[warp * 3 * DMAX + DMAX + col] = dbk[j][e];
          red[warp * 3 * DMAX + 2 * DMAX + col] = dbv[j][e];
        }
    }
    __syncthreads();
    for (int col = tid; col < 3 * DMAX; col += kBodyThreads) {
      const int part = col / DMAX, dd = col % DMAX;
      if (dd >= a.d) continue;
      float sum = 0.f;
      for (int w = 0; w < kBodyWarps; ++w) sum += red[w * 3 * DMAX + col];
      a.db_part[static_cast<size_t>(run) * 3 * a.c + part * a.c + h0 * a.d +
                dd] = sum;
    }
  }
}

}  // namespace
