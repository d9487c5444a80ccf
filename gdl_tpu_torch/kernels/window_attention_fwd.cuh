// The window-attention forward body, shared by window_attention_train.cu
// (kernel #5, the save-p forward on a qkv computed outside: SAVE=true;
// kernel #6's forward, the same launch; kernel #7's forward: SAVE=false;
// kernel #2, which makes #5's launch after its projection),
// window_attention_eval.cu (kernel #1, which makes #7's forward launch
// after its projection) and window_attention_bhnd.cu (kernels #8 and #9,
// one launch, on separate q, k, v [B, H, N, D]). Per window w and head h,
// from q, k, v rows of d elements (qkv [Bw, N, 3C]: columns
// [q|k|v][head][d], q not yet scaled; or q, k, v [B, H, N, D]):
//
//   q_s = round_T(q * round_T(scale))
//   s   = q_s . k^T (f32) + bias[h] + mask[w % nW]      (f32)
//   p   = softmax(s) over keys (f32) -> round_T         (SAVE: written)
//   out = p . v (f32 accumulate) -> T
//
// T is float or bfloat16; every rounding point above is the TPU kernels'
// (_wa_kernel, _wa_qkv_t_savep_kernel and the others of
// gdl_tpu/ops/window_attention.py). #1 and #2 (the TPU's
// _wa_xw_t_eval_kernel and _wa_xw_t_savep_kernel) first compute
// qkv = round_T(round_T(x . W^T) + b), which the TPU keeps in VMEM; here
// that is a launch of its own on the GEMM tile (window_attention_proj.cuh)
// into device memory in T at the TPU's rounding point, read back here.
//
// What bounds it: per (window, head) the forward reads 3 n d elements of
// q, k, v and writes n d of out (and n^2 of p with SAVE) for two
// n x n x d products: at the Swin-B shapes (n = 49, d = 32) about 10
// operations a byte, far below the card's ratio, so the bytes bound it.
//
// Design (the backward body's layout, window_attention_bwd.cuh). A block
// of four warps owns one head and a run of windows of one mask class
// (w = r mod nW): bias[h] and mask[r] are copied into shared memory once
// a block, into rows padded so that a lane reads its two keys of a tile
// as one float2 off distinct banks, not read by each lane from device
// memory. Each window of the run is a tile:
//   - q, k, v rows come in by cp.async in T, in the widest piece (16, 8 or
//     4 bytes) their alignment allows, element by element where none
//     fits, into row tiles [kNP][LDQ] zeroed once at block start (rows
//     past n and columns past d stay zero). In bf16 two stages: the next
//     window's rows arrive under this window's products;
//   - warp w on the query rows 16w .. 16w + 15 (the keys < n in 8-key
//     tiles) scales its rows of q in place, forms the scores as 16 x 8
//     fragments (rows_by_keys), and p by softmax_rows, the function #7's
//     backward computes p with: bias and mask from shared memory, the row
//     max and sum by quad shuffles, exp by ex2.approx, one reciprocal a
//     row; rows and keys past n give p = 0, never NaN;
//   - out = round_T(p) . v: in bf16 on the tensor cores (mma.sync
//     m16n8k16, f32 sums), the A operand packed straight from p's
//     accumulator registers, v through ldmatrix.trans; in f32 (no TF32:
//     f32 stays f32, as the plain versions run) on an FMA tile of four
//     rows by d / 8 columns a lane, p through the warp's rows of q's tile
//     (free after the scores; q's rows are 68 floats), float4 reads;
//   - bf16: out rows are staged in the warp's rows of q's tile and stored
//     in 16/8/4-byte pieces; with SAVE, p goes into a flat buffer shifted
//     as its [n, n] slab is shifted off 16 bytes, and the block writes
//     the slab as one span, 16-byte stores of its aligned interior and
//     element stores at its two edges (store_flat, the mirror of
//     copy_flat). f32: each warp writes its rows of p's slab from q's
//     tile (contiguous, no block barrier) and its rows of out straight
//     from the registers, a float4 a lane and row.
// Sized so that four blocks (16 warps) fit an SM at the Swin shapes in
// both dtypes: the stages, the padded bias and mask and (bf16) the flat p
// buffer take 56.2 KB in bf16 and 56.6 KB in f32.
// A window's sums have a fixed order and no atomics: two runs give equal
// bits, and every entry, whatever its layout or grid, gives the bits of
// every other on the same values.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

#include "gemm_tile.cuh"

namespace {

constexpr int kNP = 64;  // max tokens per window (rows padded to 64)
constexpr int kBodyWarps = 4;
constexpr int kBodyThreads = 32 * kBodyWarps;

template <typename T>
struct Num;

template <>
struct Num<float> {
  __device__ static float load(const float* p) { return *p; }
  __device__ static float round(float v) { return v; }
  __device__ static float store(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  // round-to-nearest-even, as XLA's and PyTorch's bf16 casts
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};

// A row tile [kNP][LDQ] of d <= DMAX elements a row in T. Rows are padded
// by 16 bytes in bf16 (the eight rows an ldmatrix phase reads fall on
// distinct banks) and by 4 floats in f32 (float4 rows off the bank period).
template <typename T, int DMAX>
struct RowTile {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int LDQ = DMAX + (kBf16 ? 8 : 4);
  static constexpr int TILE = kNP * LDQ;
  static_assert((sizeof(T) * TILE) % 16 == 0, "16-byte tiles");
};

// floats of a flat f32 [n, n] buffer: a shift of < 4, then n * n
__host__ __device__ constexpr int flat_floats(int n) {
  return (n * n + 4 + 3) / 4 * 4;
}

// elements from a slab's start back to the last 16-byte boundary
template <typename E>
__device__ __forceinline__ int flat_shift(const E* slab) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(slab) / sizeof(E)) %
                          (16 / sizeof(E)));
}

// The contiguous span src[0 .. nn) into buf + flat_shift(src), so that
// 16-byte copies stay aligned: cp.async of the aligned interior, element
// copies of the edges; not a byte outside the span is read. The caller
// commits the group.
template <typename E>
__device__ __forceinline__ void copy_flat(E* buf, const E* src, int nn,
                                          int tid) {
  constexpr int V = 16 / static_cast<int>(sizeof(E));
  const int sh = flat_shift(src);
  E* dst = buf + sh;
  const int e0 = min(nn, (V - sh) % V);  // up to the first 16-byte boundary
  const int body = (nn - e0) / V;
  for (int k = tid; k < body; k += kBodyThreads)
    gemm::cp_async16(dst + e0 + k * V, src + e0 + k * V, 16);
  const int e1 = e0 + body * V;
  for (int e = tid; e < e0 + (nn - e1); e += kBodyThreads) {
    const int at = e < e0 ? e : e1 + (e - e0);
    dst[at] = src[at];
  }
}

// The mirror of copy_flat: the span held at buf + flat_shift(dst) out to
// dst[0 .. nn), 16-byte stores of the aligned interior, element stores of
// the edges; not a byte outside the span is written.
template <typename E>
__device__ __forceinline__ void store_flat(E* dst, const E* buf, int nn,
                                           int tid) {
  constexpr int V = 16 / static_cast<int>(sizeof(E));
  const int sh = flat_shift(dst);
  const E* src = buf + sh;
  const int e0 = min(nn, (V - sh) % V);
  const int body = (nn - e0) / V;
  for (int k = tid; k < body; k += kBodyThreads)
    *reinterpret_cast<int4*>(dst + e0 + k * V) =
        *reinterpret_cast<const int4*>(src + e0 + k * V);
  const int e1 = e0 + body * V;
  for (int e = tid; e < e0 + (nn - e1); e += kBodyThreads) {
    const int at = e < e0 ? e : e1 + (e - e0);
    dst[at] = src[at];
  }
}

// one row piece of W bytes, global -> shared
template <int W, typename T>
__device__ __forceinline__ void copy_piece(T* dst, const T* src) {
  if constexpr (W == 16)
    gemm::cp_async16(dst, src, 16);
  else
    gemm::cp_async_ca<W>(dst, src, W);
}

// Rows 0 .. n - 1 (d elements each) of K row sources, src[i] with its rows
// ld[i] elements apart, into the row tiles dst[i] (rows lds[i] elements
// apart), in pieces of W bytes (0: element by element). The caller
// commits the group.
template <int W, int K, typename T>
__device__ __forceinline__ void copy_rows(T* const (&dst)[K],
                                          const int (&lds)[K],
                                          const T* const (&src)[K],
                                          const size_t (&ld)[K], int n, int d,
                                          int tid) {
  if constexpr (W == 0) {
    for (int e = tid; e < n * d; e += kBodyThreads) {
      const int r = e / d, col = e % d;
#pragma unroll
      for (int i = 0; i < K; ++i)
        dst[i][r * lds[i] + col] = src[i][r * ld[i] + col];
    }
  } else {
    constexpr int V = W / static_cast<int>(sizeof(T));
    const int per_row = d / V;
    for (int e = tid; e < n * per_row; e += kBodyThreads) {
      const int r = e / per_row, col = (e % per_row) * V;
#pragma unroll
      for (int i = 0; i < K; ++i)
        copy_piece<W>(dst[i] + r * lds[i] + col, src[i] + r * ld[i] + col);
    }
  }
}

// copy_rows in the piece width `width` (16, 8, 4 bytes, or 0)
template <int K, typename T>
__device__ __forceinline__ void copy_rows_by(int width, T* const (&dst)[K],
                                             const int (&lds)[K],
                                             const T* const (&src)[K],
                                             const size_t (&ld)[K], int n,
                                             int d, int tid) {
  switch (width) {
    case 16:
      copy_rows<16>(dst, lds, src, ld, n, d, tid);
      break;
    case 8:
      copy_rows<8>(dst, lds, src, ld, n, d, tid);
      break;
    case 4:
      copy_rows<4>(dst, lds, src, ld, n, d, tid);
      break;
    default:
      copy_rows<0>(dst, lds, src, ld, n, d, tid);
  }
}

// q_s = round_T(q * T(scale)) in place on the warp's rows r0 .. r0 + 15 of
// the q tile, rows LDA elements apart (read by other warps, if at all,
// only after a barrier)
template <typename T, int DMAX, int LDA = RowTile<T, DMAX>::LDQ>
__device__ __forceinline__ void scale_rows(T* qs, int r0, int lane,
                                           float scale_t) {
  for (int e = lane; e < 16 * DMAX; e += 32) {
    T* x = qs + (r0 + e / DMAX) * LDA + e % DMAX;
    *x = Num<T>::store(Num<T>::load(x) * scale_t);
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// the products on the fragment layout of mma.sync m16n8k16: lane (g, q) =
// (lane / 4, lane % 4) holds c[j][0..1] = C[g][8j + 2q + 0..1] and
// c[j][2..3] = C[g + 8][8j + 2q + 0..1] of the warp's 16 rows
// ---------------------------------------------------------------------------

// c + a . b, the four products in order
__device__ __forceinline__ float dot4(float4 a, float4 b, float c) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, c))));
}

// acc[j][..] += A[r0 .. r0 + 15][:DMAX] . B[8j .. 8j + 7][:DMAX]^T for the
// key tiles j < NKT, A and B row tiles, A's rows LDA elements apart, B's
// LDQ (the scores' and dp's layout: K = the head dim)
template <int NKT, typename T, int DMAX, int LDA>
__device__ __forceinline__ void rows_by_key_tiles(float (&acc)[8][4],
                                                  const T* as, const T* bs,
                                                  int r0, int d, int lane) {
  using R = RowTile<T, DMAX>;
  if constexpr (R::kBf16) {
#pragma unroll
    for (int kk = 0; kk < DMAX; kk += 16) {
      uint32_t a[4];
      gemm::ldsm_x4(a, as + (r0 + lane % 16) * LDA + kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j + 1 < NKT; j += 2) {
        uint32_t b[4];  // B fragments of key tiles j and j + 1
        gemm::ldsm_x4(b, bs + (8 * j + (lane / 16) * 8 + lane % 8) * R::LDQ +
                             kk + ((lane / 8) % 2) * 8);
        gemm::mma_bf16(acc[j], a, b);
        gemm::mma_bf16(acc[j + 1], a, b + 2);
      }
      if constexpr (NKT % 2 == 1) {
        uint32_t b[2];  // the last key tile alone
        gemm::ldsm_x2(b, bs + (8 * (NKT - 1) + lane % 8) * R::LDQ + kk +
                             ((lane / 8) % 2) * 8);
        gemm::mma_bf16(acc[NKT - 1], a, b);
      }
    }
  } else {
    const int g = lane / 4, q = lane % 4;
    const float* a0p = as + (r0 + g) * LDA;
    const float* a1p = a0p + 8 * LDA;
    for (int k4 = 0; k4 < d; k4 += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(a0p + k4);
      const float4 a1 = *reinterpret_cast<const float4*>(a1p + k4);
#pragma unroll
      for (int j = 0; j < NKT; ++j) {
        const float4 b0 = *reinterpret_cast<const float4*>(
            bs + (8 * j + 2 * q) * R::LDQ + k4);
        const float4 b1 = *reinterpret_cast<const float4*>(
            bs + (8 * j + 2 * q + 1) * R::LDQ + k4);
        acc[j][0] = dot4(a0, b0, acc[j][0]);
        acc[j][1] = dot4(a0, b1, acc[j][1]);
        acc[j][2] = dot4(a1, b0, acc[j][2]);
        acc[j][3] = dot4(a1, b1, acc[j][3]);
      }
    }
  }
}

// the product over the key tiles that hold keys < n: all 8, or 7 where
// n <= 56 (a Swin window's 49)
template <typename T, int DMAX, int LDA = RowTile<T, DMAX>::LDQ>
__device__ __forceinline__ void rows_by_keys(float (&acc)[8][4], const T* as,
                                             const T* bs, int r0, int n,
                                             int d, int lane) {
  if (n > 56)
    rows_by_key_tiles<8, T, DMAX, LDA>(acc, as, bs, r0, d, lane);
  else
    rows_by_key_tiles<7, T, DMAX, LDA>(acc, as, bs, r0, d, lane);
}

// p = softmax(s + bias + mask) over the keys < n, in place and unrounded
// in f32, on the warp's fragments of the query rows r0 + g (+ 8): bh and
// mw (null: no mask) are the [n, n] bias and mask in shared memory, rows
// ld elements apart (the flat buffers: ld = n); with PAIRS (ld even, the
// rows 8-byte aligned) a lane reads its two keys 2q, 2q + 1 of a tile as
// one float2. Rows and keys past n give p = 0: a row past n is all -inf,
// and its sum of 0 is never divided by. The forward and #7's backward
// both call it.
template <bool PAIRS>
__device__ __forceinline__ void softmax_rows(float (&s)[8][4],
                                             const float* bh,
                                             const float* mw, int ld, int n,
                                             int r0, int lane) {
  const int g = lane / 4, q = lane % 4;
  // the pair at row i, keys jj and jj + 1 (jj < n; jj + 1 read if < n)
  auto pair = [&](const float* m, int i, int jj) {
    if constexpr (PAIRS)
      return *reinterpret_cast<const float2*>(m + i * ld + jj);
    else
      return make_float2(m[i * ld + jj], jj + 1 < n ? m[i * ld + jj + 1]
                                                    : 0.f);
  };
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = r0 + g + 8 * h, jj = 8 * j + 2 * q;
      float v0 = -CUDART_INF_F, v1 = -CUDART_INF_F;
      if (i < n && jj < n) {
        const float2 b = pair(bh, i, jj);
        v0 = s[j][2 * h] + b.x;
        if (jj + 1 < n) v1 = s[j][2 * h + 1] + b.y;
        if (mw != nullptr) {
          const float2 m = pair(mw, i, jj);
          v0 += m.x;
          if (jj + 1 < n) v1 += m.y;
        }
      }
      s[j][2 * h] = v0;
      s[j][2 * h + 1] = v1;
      mx[h] = fmaxf(mx[h], fmaxf(v0, v1));
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + g + 8 * (e / 2);
      // rows past n are all -inf: their p is 0; so are key tiles past n
      const float x = i < n && 8 * j < n ? __expf(s[j][e] - mx[e / 2]) : 0.f;
      s[j][e] = x;
      sum[e / 2] += x;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
  }
  const float inv[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (r0 + g + 8 * (e / 2) < n) s[j][e] *= inv[e / 2];  // past n: 0
}

// ---------------------------------------------------------------------------
// the forward body
// ---------------------------------------------------------------------------

// What a launch of the forward body reads and writes. q, k, v and out
// point at window 0, head 0, row 0; the strides are in elements.
struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // [heads, n, n]
  const float* mask;  // [nw, n, n] or null; window w takes mask[w % nw]
  void* out;
  void* p;            // SAVE: [bw, heads, n, n]
  size_t ld, win, head;     // q, k, v: between rows, windows, heads
  size_t ldo, owin, ohead;  // out: the same
  int bw, n, heads, d, nw;
  int wpb;      // windows a block walks, all of one mask class
  float scale;
  int width;    // bytes a piece of a q, k, v or out row takes: 16, 8, 4, 0
};

// Shared memory of a block, sized by n at launch: NS stages of row tiles
// q [kNP][LDA], k [krows][LDQ], v [kNP][LDQ], zeroed at block start (k's
// rows stop at the last key tile's); in bf16 the flat p buffer of SAVE (a
// shift of < 8, then n * n); bias[h] and mask[r] as f32 tiles [n][ldb].
// In f32 a warp's rows of q also take its p, the A operand of out = p . v
// (keys < kNP, so a q row holds at least kNP + 4 floats), and SAVE writes
// p from there. At the Swin shapes (n = 49, d = 32) a block takes 56,224
// bytes in bf16 and 56,640 in f32: four blocks an SM.
template <typename T, int DMAX>
struct FwdLayout {
  using R = RowTile<T, DMAX>;
  static constexpr int NS = R::kBf16 ? 2 : 1;
  static constexpr int LDA =
      R::kBf16 || R::LDQ >= kNP + 4 ? R::LDQ : kNP + 4;
  static constexpr int MIN_BLOCKS = DMAX > 32 ? 2 : 4;

  // key rows the scores read: 7 key tiles where n <= 56, else 8
  __host__ __device__ static constexpr int krows(int n) {
    return n <= 56 ? 56 : kNP;
  }
  // bias and mask rows: even, 24 or 8 mod 32 floats, so that a warp's
  // float2 reads of 8 rows by 4 key pairs fall on distinct banks
  __host__ __device__ static constexpr int ldb(int n) {
    return n <= 56 ? 56 : 72;
  }
  // elements of T in a stage: q, then k, then v
  __host__ __device__ static constexpr int stage(int n) {
    return kNP * LDA + (krows(n) + kNP) * R::LDQ;
  }
  __host__ __device__ static constexpr int pflat(int n) {
    return R::kBf16 ? (n * n + 8 + 7) / 8 * 8 : 0;
  }
  __host__ __device__ static constexpr size_t zeroed_bytes(int n) {
    return sizeof(T) * NS * stage(n);
  }
  __host__ __device__ static constexpr size_t bytes(int n) {
    return zeroed_bytes(n) + sizeof(T) * pflat(n) +
           sizeof(float) * 2 * n * ldb(n);
  }
  __host__ __device__ static constexpr size_t max_bytes() {
    return bytes(kNP);
  }
  static_assert((sizeof(T) * kNP * LDA) % 16 == 0 &&
                    (sizeof(T) * 56 * R::LDQ) % 16 == 0,
                "16-byte tiles");
};

// The warp's 16 rows of out, staged in rows r0 .. r0 + 15 of os (rows lds
// elements apart), to out_w (rows ldo elements apart): rows < n, d
// elements each, in pieces of W bytes (0: element by element)
template <typename T, int W>
__device__ __forceinline__ void store_rows(T* out_w, size_t ldo, const T* os,
                                           int lds, int r0, int n, int d,
                                           int lane) {
  const int rows = min(16, n - r0);
  if constexpr (W == 0) {
    for (int e = lane; e < rows * d; e += 32) {
      const int r = r0 + e / d, col = e % d;
      out_w[r * ldo + col] = os[r * lds + col];
    }
  } else {
    using V = std::conditional_t<W == 16, int4,
                                 std::conditional_t<W == 8, int2, int>>;
    constexpr int E = W / static_cast<int>(sizeof(T));
    const int per_row = d / E;
    for (int e = lane; e < rows * per_row; e += 32) {
      const int r = r0 + e / per_row, col = (e % per_row) * E;
      *reinterpret_cast<V*>(out_w + r * ldo + col) =
          *reinterpret_cast<const V*>(os + r * lds + col);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_rows_by(int width, T* out_w, size_t ldo,
                                              const T* os, int lds, int r0,
                                              int n, int d, int lane) {
  switch (width) {
    case 16:
      store_rows<T, 16>(out_w, ldo, os, lds, r0, n, d, lane);
      break;
    case 8:
      store_rows<T, 8>(out_w, ldo, os, lds, r0, n, d, lane);
      break;
    case 4:
      store_rows<T, 4>(out_w, ldo, os, lds, r0, n, d, lane);
      break;
    default:
      store_rows<T, 0>(out_w, ldo, os, lds, r0, n, d, lane);
  }
}

// out = round_T(p) . v on the tensor cores for the warp's fragments of p
// (registers, rounded to bf16), staged in the warp's rows of q's tile
template <int DMAX>
__device__ __forceinline__ void out_bf16(const float (&s)[8][4],
                                         __nv_bfloat16* qs,
                                         const __nv_bfloat16* vs, int r0,
                                         int n, int d, int lane) {
  using R = RowTile<__nv_bfloat16, DMAX>;
  constexpr int DT = DMAX / 8;
  const int g = lane / 4, q = lane % 4;
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (16 * kk >= n) break;
    // the A fragment of keys 16 kk .. + 15 is the accumulators of key
    // tiles 2 kk and 2 kk + 1
    const uint32_t af[4] = {gemm::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            gemm::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            gemm::pack_bf16(s[2 * kk + 1][0],
                                            s[2 * kk + 1][1]),
                            gemm::pack_bf16(s[2 * kk + 1][2],
                                            s[2 * kk + 1][3])};
#pragma unroll
    for (int j = 0; j < DT; j += 2) {
      uint32_t b[4];  // v [keys][d], K outer: transposed
      gemm::ldsm_x4_trans(b, vs + (16 * kk + ((lane / 8) % 2) * 8 +
                                   lane % 8) * R::LDQ +
                                 8 * j + (lane / 16) * 8);
      gemm::mma_bf16(o[j], af, b);
      gemm::mma_bf16(o[j + 1], af, b + 2);
    }
  }
  __syncwarp();  // every lane is past its reads of q's rows
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g + 8 * h, col = 8 * j + 2 * q;
      if (row >= n || col >= d) continue;
      __nv_bfloat16* dst = qs + row * R::LDQ + col;
      if (col + 1 < d)
        *reinterpret_cast<uint32_t*>(dst) =
            gemm::pack_bf16(o[j][2 * h], o[j][2 * h + 1]);
      else
        dst[0] = Num<__nv_bfloat16>::store(o[j][2 * h]);
    }
}

// out = p . v on the FMA pipes in f32, p in the warp's rows of q's tile
// (rows LDA floats apart): each lane four rows r0 + rg + 4i by d / 8
// columns, float4 reads of p rows and v rows. Stored straight from the
// registers where the rows take vectors of the lane's width, else staged
// in the warp's rows of q's tile.
template <int DMAX>
__device__ __forceinline__ void out_f32(const FwdArgs& a, float* qs,
                                        const float* vs, float* out_w, int r0,
                                        int lane) {
  using R = RowTile<float, DMAX>;
  constexpr int LDA = FwdLayout<float, DMAX>::LDA;
  constexpr int CW = DMAX / 8;         // columns a lane
  constexpr int VW = CW < 4 ? CW : 4;  // in vectors of VW
  constexpr int NV = CW / VW;
  const int n = a.n, d = a.d;
  const int rg = lane / 8, cg = lane % 8;
  float o[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) o[i][c] = 0.f;
  for (int t4 = 0; t4 < n; t4 += 4) {
    float pa[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x =
          *reinterpret_cast<const float4*>(qs + (r0 + rg + 4 * i) * LDA + t4);
      pa[i][0] = x.x;
      pa[i][1] = x.y;
      pa[i][2] = x.z;
      pa[i][3] = x.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float b[CW];
#pragma unroll
      for (int h = 0; h < NV; ++h) {
        const float* src = vs + (t4 + u) * R::LDQ + VW * cg + 8 * VW * h;
        if constexpr (VW == 4) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          b[4 * h] = x.x;
          b[4 * h + 1] = x.y;
          b[4 * h + 2] = x.z;
          b[4 * h + 3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(src);
          b[2 * h] = x.x;
          b[2 * h + 1] = x.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CW; ++c) o[i][c] = fmaf(pa[i][u], b[c], o[i][c]);
    }
  }
  if (a.width >= 4 * VW) {  // the lane's vectors straight to out
    using V = std::conditional_t<VW == 4, float4, float2>;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + rg + 4 * i;
      if (row >= n) continue;
#pragma unroll
      for (int h = 0; h < NV; ++h) {
        const int col = VW * cg + 8 * VW * h;
        if (col >= d) continue;
        V x;
        float* lanes = reinterpret_cast<float*>(&x);
#pragma unroll
        for (int c = 0; c < VW; ++c) lanes[c] = o[i][VW * h + c];
        *reinterpret_cast<V*>(out_w + row * a.ldo + col) = x;
      }
    }
    return;
  }
  __syncwarp();  // every lane is past its reads of the warp's p rows
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + rg + 4 * i;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int col = VW * cg + 8 * VW * (c / VW) + c % VW;
      if (col < d) qs[row * LDA + col] = o[i][c];
    }
  }
  __syncwarp();
  store_rows_by(a.width, out_w, a.ldo, qs, LDA, r0, n, d, lane);
}

// One tile for the warp on query rows r0 .. r0 + 15 (r0 < n): q_s in
// place, the scores, p (rounded to T; with SAVE to p_w, through the flat
// buffer pw in bf16, straight from q's rows in f32), out = p . v stored.
// bh, mw: bias and mask (or null) in shared memory, rows ldb apart.
template <typename T, int DMAX, bool SAVE>
__device__ __forceinline__ void fwd_rows(const FwdArgs& a, T* qs,
                                         const T* ks, const T* vs, T* pw,
                                         T* p_w, const float* bh,
                                         const float* mw, int ldb, T* out_w,
                                         int r0, int lane, float scale_t) {
  using R = RowTile<T, DMAX>;
  constexpr int LDA = FwdLayout<T, DMAX>::LDA;
  const int g = lane / 4, q = lane % 4;
  const int n = a.n, d = a.d;

  scale_rows<T, DMAX, LDA>(qs, r0, lane, scale_t);
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  rows_by_keys<T, DMAX, LDA>(s, qs, ks, r0, n, d, lane);
  softmax_rows<true>(s, bh, mw, ldb, n, r0, lane);
  // p_T = round_T(p): the saved p and the operand of out = p . v
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = Num<T>::round(s[j][e]);

  if constexpr (R::kBf16) {
    if constexpr (SAVE) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r0 + g + 8 * (e / 2), jj = 8 * j + 2 * q + e % 2;
          if (i < n && jj < n) pw[i * n + jj] = Num<T>::store(s[j][e]);
        }
    }
    out_bf16<DMAX>(s, qs, vs, r0, n, d, lane);
    __syncwarp();  // out's rows are staged
    store_rows_by(a.width, out_w, a.ldo, qs, LDA, r0, n, d, lane);
  } else {
    __syncwarp();  // every lane is past its reads of q's rows
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(qs + (r0 + g + 8 * h) * LDA + 8 * j +
                                   2 * q) =
            make_float2(s[j][2 * h], s[j][2 * h + 1]);
    __syncwarp();  // the warp's p rows are written
    if constexpr (SAVE) {  // rows r0 .. of p_w: contiguous, n floats each
      const int rows = min(16, n - r0);
      for (int e = lane; e < rows * n; e += 32)
        p_w[r0 * n + e] = qs[(r0 + e / n) * LDA + e % n];
    }
    out_f32<DMAX>(a, qs, vs, out_w, r0, lane);
  }
}

// The block: head blockIdx.x % heads, mask class r and the run of windows
// r + nw * j, j in [run * wpb, run * wpb + wpb), of those < bw; a tile a
// window.
template <typename T, int DMAX, bool SAVE>
__device__ __forceinline__ void fwd_windows(const FwdArgs& a) {
  using R = RowTile<T, DMAX>;
  using L = FwdLayout<T, DMAX>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n;
  const int head = blockIdx.x % a.heads;
  const int rest = blockIdx.x / a.heads;
  const int cls = rest % a.nw, j0 = (rest / a.nw) * a.wpb;
  const int tiles = min(a.wpb, (a.bw - cls + a.nw - 1) / a.nw - j0);
  if (tiles <= 0) return;  // a class with fewer windows (any bw, #8)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp;
  const float scale_t = Num<T>::round(a.scale);
  const int stage = L::stage(n), ldb = L::ldb(n);

  T* smem = reinterpret_cast<T*>(smem_raw);
  T* pbuf = smem + L::NS * stage;
  float* bias_s = reinterpret_cast<float*>(pbuf + L::pflat(n));
  float* mask_s = bias_s + n * ldb;

  for (int e = tid; e < static_cast<int>(L::zeroed_bytes(n) / 16);
       e += kBodyThreads)
    reinterpret_cast<int4*>(smem_raw)[e] = make_int4(0, 0, 0, 0);
  __syncthreads();

  // bias[h] and mask[r] once a block, committed with tile 0's rows
  const float* bias_h = a.bias + static_cast<size_t>(head) * n * n;
  const float* mask_r =
      a.mask != nullptr ? a.mask + static_cast<size_t>(cls) * n * n : nullptr;
  for (int e = tid; e < n * n; e += kBodyThreads) {
    const int i = e / n, jj = e % n;
    gemm::cp_async_ca<4>(bias_s + i * ldb + jj, bias_h + e, 4);
    if (mask_r != nullptr)
      gemm::cp_async_ca<4>(mask_s + i * ldb + jj, mask_r + e, 4);
  }
  const float* mw = mask_r != nullptr ? mask_s : nullptr;

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const size_t ld[3] = {a.ld, a.ld, a.ld};
  const int lds[3] = {L::LDA, R::LDQ, R::LDQ};
  auto tile = [&](int t, int i) {  // tile i (q, k, v) of tile t's stage
    T* st = smem + (t % L::NS) * stage;
    return i == 0 ? st : st + kNP * L::LDA + (i - 1) * L::krows(n) * R::LDQ;
  };
  auto win_of = [&](int t) { return cls + a.nw * (j0 + t); };
  auto issue = [&](int t) {
    if (t < tiles) {
      const size_t at = static_cast<size_t>(win_of(t)) * a.win +
                        static_cast<size_t>(head) * a.head;
      const T* src[3] = {q + at, k + at, v + at};
      T* const dst[3] = {tile(t, 0), tile(t, 1), tile(t, 2)};
      copy_rows_by(a.width, dst, lds, src, ld, n, a.d, tid);
    }
    gemm::cp_async_commit();
  };

  if constexpr (L::NS == 2) issue(0);
  for (int t = 0; t < tiles; ++t) {
    if constexpr (L::NS == 1) {
      if (t > 0) __syncthreads();  // the stage is free again
      issue(t);
    }
    gemm::cp_async_wait<0>();  // tile t has landed (for this thread)
    __syncthreads();  // ... for every thread; tile t - 1 is done
    if constexpr (L::NS == 2) issue(t + 1);  // under this tile's products
    const size_t win = win_of(t);
    T* p_w = SAVE ? static_cast<T*>(a.p) + (win * a.heads + head) * n * n
                  : nullptr;
    T* out_w = static_cast<T*>(a.out) + win * a.owin +
               static_cast<size_t>(head) * a.ohead;
    if (r0 < n)
      fwd_rows<T, DMAX, SAVE>(
          a, tile(t, 0), tile(t, 1), tile(t, 2),
          SAVE && R::kBf16 ? pbuf + flat_shift(p_w) : nullptr, p_w, bias_s,
          mw, ldb, out_w, r0, lane, scale_t);
    if constexpr (SAVE && R::kBf16) {
      __syncthreads();  // every warp's rows of p are in the flat buffer
      store_flat(p_w, pbuf, n * n, tid);
    }
  }
  gemm::cp_async_wait<0>();
}

// #1, #2, #5, #6's and #7's forward: the body on a qkv [bw, n, 3c]
template <typename T, int DMAX, bool SAVE>
__global__ void __launch_bounds__(kBodyThreads,
                                  FwdLayout<T, DMAX>::MIN_BLOCKS)
    wa_fwd_kernel(FwdArgs a) {
  fwd_windows<T, DMAX, SAVE>(a);
}

// above 48 KB a block's shared memory has to be granted explicitly; the
// launchers set it once per instantiation
template <typename K>
cudaError_t grant_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// f(std::integral_constant<int, DMAX>) with the smallest of the three
// register tilings (DMAX 16, 32, 64) that holds head dim d
template <typename F>
int with_dmax(int d, F&& f) {
  if (d <= 16) return f(std::integral_constant<int, 16>{});
  if (d <= 32) return f(std::integral_constant<int, 32>{});
  return f(std::integral_constant<int, 64>{});
}

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<T>) for the element type of dtype code 0 (float32) or 1 (bfloat16)
template <typename F>
int with_dtype(int dtype, F&& f) {
  if (dtype == 0) return f(Tag<float>{});
  if (dtype == 1) return f(Tag<__nv_bfloat16>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// the widest piece (16, 8 or 4 bytes) in which every q, k, v and out row
// of a head can be moved, or 0: element by element
template <typename T>
int fwd_width(const FwdArgs& a) {
  for (int w = 16; w >= 4; w /= 2) {
    const bool fits =
        (a.d * sizeof(T)) % w == 0 && (a.ld * sizeof(T)) % w == 0 &&
        (a.ldo * sizeof(T)) % w == 0 &&
        reinterpret_cast<uintptr_t>(a.q) % w == 0 &&
        reinterpret_cast<uintptr_t>(a.k) % w == 0 &&
        reinterpret_cast<uintptr_t>(a.v) % w == 0 &&
        reinterpret_cast<uintptr_t>(a.out) % w == 0;
    if (fits) return w;
  }
  return 0;
}

// heads x nw x ceil(ceil(bw / nw) / wpb) blocks of `kernel`, an
// instantiation of the body at <T, DMAX> whose shared memory the caller
// has granted (FwdLayout<T, DMAX>::max_bytes(), once per kernel)
template <typename T, int DMAX, typename K>
int launch_body(K kernel, FwdArgs a, cudaStream_t s) {
  using L = FwdLayout<T, DMAX>;
  if (a.mask == nullptr) a.nw = 1;
  a.width = fwd_width<T>(a);
  const unsigned runs = static_cast<unsigned>(
      ((a.bw + a.nw - 1) / a.nw + a.wpb - 1) / a.wpb);
  const unsigned grid =
      static_cast<unsigned>(a.heads) * static_cast<unsigned>(a.nw) * runs;
  kernel<<<grid, kBodyThreads, L::bytes(a.n), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// out [bw, n, c] (and, with SAVE, p [bw, heads, n, n]) from qkv
// [bw, n, 3c], all in T; a block walks wpb windows of one mask class
template <typename T, bool SAVE>
int dispatch_fwd(const void* qkv, const void* bias, const void* mask,
                 void* out, void* p, int bw, int n, int c, int heads, int d,
                 int nw, int wpb, float scale, cudaStream_t s) {
  const T* q = static_cast<const T*>(qkv);
  FwdArgs a{};
  a.q = q;
  a.k = q + c;
  a.v = q + 2 * c;
  a.bias = static_cast<const float*>(bias);
  a.mask = static_cast<const float*>(mask);
  a.out = out;
  a.p = p;
  a.ld = 3 * static_cast<size_t>(c);
  a.win = static_cast<size_t>(n) * a.ld;
  a.head = d;
  a.ldo = c;
  a.owin = static_cast<size_t>(n) * c;
  a.ohead = d;
  a.bw = bw;
  a.n = n;
  a.heads = heads;
  a.d = d;
  a.nw = nw;
  a.wpb = wpb;
  a.scale = scale;
  return with_dmax(d, [&](auto dm) {
    constexpr int DMAX = decltype(dm)::value;
    static const cudaError_t attr = grant_smem(
        wa_fwd_kernel<T, DMAX, SAVE>, FwdLayout<T, DMAX>::max_bytes());
    if (attr != cudaSuccess) return static_cast<int>(attr);
    return launch_body<T, DMAX>(wa_fwd_kernel<T, DMAX, SAVE>, a, s);
  });
}

}  // namespace
