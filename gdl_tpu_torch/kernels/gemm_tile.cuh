// A block-tile GEMM for Hopper: C[M, N] = store(epi(A . B)), sums in f32,
// an epilogue in f32 on each sum, then the store. Each operand comes in
// one of two layouts, a type parameter:
//   - KInner: K contiguous. A [M, K] (x [rows, C]), B [N, K] (a weight in
//     nn.Linear layout [out, in]): the tile's first layout pair;
//   - KOuter: K is the row index. A [K, M], B [K, N], M or N contiguous:
//     W [3C, C] read as [K, N] for dx = dqkv . W, and dqkv and x read
//     along their tokens for dW = dqkv^T . x (kernel #3's products).
// The store is a type parameter too: RoundT rounds each sum to T once;
// F32Partial splits K over gridDim.z (block z sums k in [z kc, (z + 1)
// kc)) and stores each split's sums unrounded in f32 at C + z M N, for the
// caller to add in a fixed order.
//
// What it replaces. The qkv projection of `_sa_xw_eval_kernel`
// (gdl_tpu/ops/self_attention.py:637, the product at :644-648: x . W in
// f32, rounded to T) for kernel #13 and of `_sa_xw_fwd_kernel` (:154) for
// #10, with the identity epilogue; #15's fc1 and fc2 (`_mlp_kernel`,
// gdl_tpu/ops/mlp.py:69), with the bias and GELU epilogues of
// mlp_fused.cu; and #3's projection backward (`_wa_xw_t_bwd_fused_kernel`,
// gdl_tpu/ops/window_attention.py:1167-1199), dx and the split dW, with
// the epilogues of namespace wa3 in window_attention_train.cu; and the qkv
// projection of #1 and #2 (`_wa_xw_t_eval_kernel`, `_wa_xw_t_savep_kernel`,
// :1034-1039), with wa2::ProjBias of window_attention_proj.cuh. The
// epilogue, the layouts and the store are type parameters of the kernel,
// so each caller's instantiation has its own symbol. The PTX helpers and
// load_tile below also serve the attention kernels without the tile: the
// self-attention row tile (#10, #12, #13, #11's part A) and #11's part B
// (sa_bwd_keys_kernel in self_attention_train.cu, whose products take
// the KOuter fragments' ldmatrix.trans addressing of this tile).
//
// What bounds it on this card. At the mmformer shapes (M = 64 * 392 rows,
// K = 512, N = 1536) the product is 2MNK = 39.5 GFLOP against 0.1 GB of
// operands: far on the operations side of the roofline in both dtypes
// (989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32 on SIMT FMA). The
// first design (sa_proj_kernel, since deleted) ran both dtypes
// on SIMT FMA with scalar loads into shared memory and no overlap of load
// and compute, at about 22 TFLOP/s.
//
// What the design does about it:
//   - a 128 x 128 block tile over K steps 64 deep (bf16) or 32 (f32),
//     256 threads (8 warps); or 64 x 128 (the BM parameter), which a
//     caller takes where the 128-row grid would leave SMs idle;
//   - the operand tiles come in through a ring of kStages cp.async stages
//     in dynamic shared memory (16-byte copies), so the loads of step
//     k + 2 run under the products of step k. A tile is stored as it lies
//     in memory: [rows][K] for KInner, [K][rows] for KOuter. The ragged
//     M, N and K edges are zero-filled by the copy's source size, never
//     read past the end. Where a row is not 16-byte aligned (its stride
//     times the item size % 16 != 0, or a pointer off 16 bytes) the tile
//     is copied element by element through registers instead: the same
//     ring, synchronous copies;
//   - bf16: mma.sync m16n8k16 (bf16 in, f32 sums) on fragments from
//     ldmatrix, on the tensor cores; ldmatrix.trans for a KOuter tile.
//     Each warp owns a BM/2 x 32 sub-tile (BM/32 x 4 fragments, BM/2 f32
//     sums a thread). Tile rows are padded by 8 elements (16 bytes), so
//     the eight rows an ldmatrix phase reads fall on distinct banks;
//   - f32: register-blocked FMA, BM/16 x 8 sums a thread, float4 reads
//     from rows padded by 4 floats: 16 shared-memory reads for every 256
//     FMAs. A KInner operand gives the thread rows (or columns) t + 16 i
//     and is read along K; a KOuter one gives it runs of four, 4 t + 64 i
//     + 0..3, read across them at each k. No TF32 anywhere: f32 stays
//     f32, as torch.backends.cuda.matmul.allow_tf32 = False keeps the
//     plain version.
// Not here yet: wgmma, TMA, warp specialisation, persistent blocks.
//
// Each output element (of each partial) is one thread's sum over k in
// order, so a launch gives the same bits every time (no atomics); the
// layouts change where the operands lie, not the sums.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace gemm {
// internal to each library that includes it: a static of a template here
// (a launcher's attribute guard) must not be one object across the
// libraries loaded into a process
namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;  // rows of C per block (64 is the other choice)
constexpr int kBN = 128;  // columns of C per block
constexpr int kStages = 3;

// The epilogue maps the f32 sum of output (row, col) to the f32 value
// that is rounded to T and stored: epi(v, col). The identity is #13's.
struct Identity {
  __device__ float operator()(float v, int) const { return v; }
};

// operand layouts (see the header): K contiguous, or K the row index
struct KInner {};
struct KOuter {};

// stores (see the header): round to T, or an f32 partial of a K split
struct RoundT {};
struct F32Partial {};

template <typename L>
constexpr bool k_inner() {
  return std::is_same<L, KInner>::value;
}

// ---- PTX helpers (shared with the attention kernels) ----------------------

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `src_bytes` (0..16) of them are read, the rest
// of the 16 zero-filled
__device__ inline void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// W (4 or 8) bytes global -> shared, through L1; `src_bytes` (0..W) of
// them are read, the rest zero-filled
template <int W>
__device__ inline void cp_async_ca(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(W), "r"(src_bytes)
               : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ inline void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ inline void ldsm_x2(uint32_t r[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ inline void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ inline void ldsm_x2_trans(uint32_t r[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a . b on the tensor cores: a 16 x 16 (row), b 16 x 8 (col), bf16 in,
// f32 sums. Fragment layout (g = lane / 4, q = lane % 4): a0 = A[g][2q..],
// a1 = A[g + 8][2q..], a2 = A[g][2q + 8..], a3 = A[g + 8][2q + 8..];
// b0 = B[2q..][g], b1 = B[2q + 8..][g]; c0, c1 = C[g][2q, 2q + 1],
// c2, c3 = C[g + 8][2q, 2q + 1].
__device__ inline void mma_bf16(float c[4], const uint32_t a[4],
                                const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copy a [rows, cols] tile of a row-major source (row stride `ld`
// elements) whose valid part is [valid_rows, valid_cols] into shared
// memory (row stride `lds` elements), zero-filling the rest. `cols` is a
// multiple of the 16-byte vector. With `vec`, 16-byte cp.async copies (the
// caller has checked the alignment); otherwise element by element.
template <typename T, int THREADS>
__device__ inline void load_tile(T* dst, int lds, const T* src, size_t ld,
                                 int rows, int cols, int valid_rows,
                                 int valid_cols, bool vec, int tid) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    const int vpr = cols / V;
    for (int e = tid; e < rows * vpr; e += THREADS) {
      const int r = e / vpr, c = (e % vpr) * V;
      int n = 0;
      if (r < valid_rows && c < valid_cols)
        n = (valid_cols - c < V ? valid_cols - c : V) * sizeof(T);
      cp_async16(dst + r * lds + c, n ? src + r * ld + c : src, n);
    }
  } else {
    for (int e = tid; e < rows * cols; e += THREADS) {
      const int r = e / cols, c = e % cols;
      dst[r * lds + c] =
          (r < valid_rows && c < valid_cols) ? src[r * ld + c] : T(0.f);
    }
  }
}

// ---- the two inner-product policies ---------------------------------------

// Policy<T, BM, LA, LB>: the K depth of a stage, the shared tiles of A and
// B in their layouts (A_ELEMS, B_ELEMS elements, row strides LDA, LDB),
// the sums a thread holds and the inner product of one stage.
template <typename T, int BM, typename LA = KInner, typename LB = KInner>
struct Policy;

// bf16 on the tensor cores; warp (wm, wn) owns rows wm*BM/2 .. +BM/2-1 and
// columns wn*32 .. +31 of the block tile
template <int BM, typename LA, typename LB>
struct Policy<__nv_bfloat16, BM, LA, LB> {
  static_assert(BM == 64 || BM == 128, "row tile");
  using T = __nv_bfloat16;
  static constexpr bool AK = k_inner<LA>(), BKI = k_inner<LB>();
  static constexpr int BK = 64;  // K per stage
  // 144-byte rows ([rows][K]) or 272-byte rows ([K][rows])
  static constexpr int LDA = AK ? BK + 8 : BM + 8;
  static constexpr int LDB = BKI ? BK + 8 : kBN + 8;
  static constexpr int A_ELEMS = (AK ? BM : BK) * LDA;
  static constexpr int B_ELEMS = (BKI ? kBN : BK) * LDB;
  static constexpr int MIN_BLOCKS = 2;  // an SM: at most 128 registers
  static constexpr int MT = BM / 32, NT = 4;  // 16 x 8 fragments a warp
  struct Acc {
    float c[MT][NT][4];
  };

  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int t = 0; t < 4; ++t) acc.c[i][j][t] = 0.f;
  }

  // A fragment i: rows m0 .. m0 + 15 of the warp, K kk .. kk + 15. From
  // a [K][rows] tile the four 8 x 8 matrices are read transposed: lanes
  // 8 t .. 8 t + 7 give K rows kk + 8 (t / 2) + 0..7 at rows m0 + 8 (t % 2)
  __device__ static void load_a(uint32_t a[4], const T* as, int m0, int kk,
                                int lane) {
    if constexpr (AK)
      ldsm_x4(a, as + (m0 + lane % 16) * LDA + kk + (lane / 16) * 8);
    else
      ldsm_x4_trans(a, as + (kk + (lane / 16) * 8 + lane % 8) * LDA + m0 +
                           ((lane / 8) % 2) * 8);
  }

  __device__ static void step(Acc& acc, const T* as, const T* bs, int tid) {
    const int lane = tid % 32, warp = tid / 32;
    const int wm = warp % 2, wn = warp / 2;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        load_a(a[i], as, wm * (BM / 2) + i * 16, kk, lane);
      if constexpr (BKI) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
          ldsm_x2(b[j], bs + (wn * 32 + j * 8 + lane % 8) * LDB + kk +
                            ((lane / 8) % 2) * 8);
      } else {
        // B fragments j, j + 1 from a [K][N] tile, transposed: lanes
        // 8 t .. 8 t + 7 give K rows kk + 8 (t % 2) + 0..7 at columns
        // n0 + 8 (t / 2)
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t r[4];
          ldsm_x4_trans(r, bs + (kk + ((lane / 8) % 2) * 8 + lane % 8) * LDB +
                               wn * 32 + j * 8 + (lane / 16) * 8);
          b[j][0] = r[0];
          b[j][1] = r[1];
          b[j + 1][0] = r[2];
          b[j + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc.c[i][j], a[i], b[j]);
    }
  }

  // replaces every sum this thread holds by fn(col, sum), col in the tile
  template <typename F>
  __device__ static void map(Acc& acc, int tid, F fn) {
    const int wn = tid / 64, q = tid % 4;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = wn * 32 + j * 8 + 2 * q;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          acc.c[i][j][t] = fn(c + t % 2, acc.c[i][j][t]);
      }
  }

  // visits every element of the block tile this thread holds:
  // fn(row, col, v0, v1) for the column pair (col, col + 1)
  template <typename F>
  __device__ static void each_pair(const Acc& acc, int tid, F fn) {
    const int lane = tid % 32, warp = tid / 32;
    const int wm = warp % 2, wn = warp / 2;
    const int g = lane / 4, q = lane % 4;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int r = wm * (BM / 2) + i * 16 + g, c = wn * 32 + j * 8 + 2 * q;
        fn(r, c, acc.c[i][j][0], acc.c[i][j][1]);
        fn(r + 8, c, acc.c[i][j][2], acc.c[i][j][3]);
      }
  }
};

// f32 on SIMT FMA; thread (ty, tx) = (tid / 16, tid % 16) owns MI = BM / 16
// rows and 8 columns: rows ty + 16 i for a KInner A, 4 ty + 64 (i / 4) +
// i % 4 for a KOuter A (runs of four, one float4 at each k); columns
// likewise from tx by B's layout
template <int BM, typename LA, typename LB>
struct Policy<float, BM, LA, LB> {
  static_assert(BM == 64 || BM == 128, "row tile");
  using T = float;
  static constexpr bool AK = k_inner<LA>(), BKI = k_inner<LB>();
  static constexpr int BK = 32;  // K per stage
  // 36 floats ([rows][K]: float4 rows, no conflicts) or BM + 4 ([K][rows])
  static constexpr int LDA = AK ? BK + 4 : BM + 4;
  static constexpr int LDB = BKI ? BK + 4 : kBN + 4;
  static constexpr int A_ELEMS = (AK ? BM : BK) * LDA;
  static constexpr int B_ELEMS = (BKI ? kBN : BK) * LDB;
  static constexpr int MI = BM / 16;
  // the 8 x 8 tile needs > 128 registers, the 4 x 8 tile fewer
  static constexpr int MIN_BLOCKS = BM == 128 ? 1 : 2;
  struct Acc {
    float c[MI][8];
  };

  __device__ static int row(int tid, int i) {
    const int ty = tid / 16;
    return AK ? ty + 16 * i : 4 * ty + 64 * (i / 4) + i % 4;
  }

  __device__ static int col(int tid, int j) {
    const int tx = tid % 16;
    return BKI ? tx + 16 * j : 4 * tx + 64 * (j / 4) + j % 4;
  }

  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc.c[i][j] = 0.f;
  }

  // v[r][u] = the operand at the thread's r-th row (or column) and K
  // kk + u, from a tile of R rows in layout KIN (stride LD)
  template <bool KIN, int R, int LD>
  __device__ static void load4(float (&v)[R][4], const T* s, int t, int kk) {
    if constexpr (KIN) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 x =
            *reinterpret_cast<const float4*>(s + (t + 16 * r) * LD + kk);
        v[r][0] = x.x;
        v[r][1] = x.y;
        v[r][2] = x.z;
        v[r][3] = x.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int r = 0; r < R; r += 4) {
          const float4 x = *reinterpret_cast<const float4*>(
              s + (kk + u) * LD + 4 * t + 16 * r);
          v[r][u] = x.x;
          v[r + 1][u] = x.y;
          v[r + 2][u] = x.z;
          v[r + 3][u] = x.w;
        }
    }
  }

  // each sum takes its k in ascending order, one fmaf each
  __device__ static void step(Acc& acc, const T* as, const T* bs, int tid) {
    const int tx = tid % 16, ty = tid / 16;
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float a[MI][4], b[8][4];
      load4<AK, MI, LDA>(a, as, ty, kk);
      load4<BKI, 8, LDB>(b, bs, tx, kk);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          float s = acc.c[i][j];
#pragma unroll
          for (int u = 0; u < 4; ++u) s = fmaf(a[i][u], b[j][u], s);
          acc.c[i][j] = s;
        }
    }
  }

  template <typename F>
  __device__ static void map(Acc& acc, int tid, F fn) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc.c[i][j] = fn(col(tid, j), acc.c[i][j]);
  }

  template <typename F>
  __device__ static void each(const Acc& acc, int tid, F fn) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) fn(row(tid, i), col(tid, j), acc.c[i][j]);
  }
};

template <typename P>
constexpr size_t smem_bytes() {
  return sizeof(typename P::T) * kStages * (P::A_ELEMS + P::B_ELEMS);
}

struct Args {
  const void* a;  // [m, k] (KInner) or [k, m] (KOuter)
  const void* b;  // [n, k] (KInner) or [k, n] (KOuter)
  void* c;        // [m, n], or [ceil(k / kc), m, n] f32 partials
  int m, n, k;
  int kc;   // F32Partial: block z sums k in [z kc, min(k, (z + 1) kc))
  int vec;  // 1: rows and pointers are 16-byte aligned
};

// C = store(epi(A . B)) with A, B in layouts LA, LB and the store Store.
// Grid: (ceil(n / 128), ceil(m / BM), K splits); the blocks of one row of
// tiles run next to each other and share A's rows in L2.
template <typename T, int BM = kBM, typename Epi = Identity,
          typename LA = KInner, typename LB = KInner, typename Store = RoundT>
__global__ void __launch_bounds__(kThreads,
                                  Policy<T, BM, LA, LB>::MIN_BLOCKS)
    gemm_tile_kernel(Args p, Epi epi) {
  using P = Policy<T, BM, LA, LB>;
  constexpr bool kPartial = std::is_same<Store, F32Partial>::value;
  using Out = std::conditional_t<kPartial, float, T>;
  constexpr int kBK = P::BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * kBN;
  const int kb = kPartial ? blockIdx.z * p.kc : 0;
  const int klen = kPartial ? min(p.k - kb, p.kc) : p.k;
  // row strides, and the block's first element of A and B
  const size_t lda = P::AK ? p.k : p.m, ldb = P::BKI ? p.k : p.n;
  const T* a = static_cast<const T*>(p.a) +
               (P::AK ? static_cast<size_t>(r0) * lda + kb
                      : static_cast<size_t>(kb) * lda + r0);
  const T* b = static_cast<const T*>(p.b) +
               (P::BKI ? static_cast<size_t>(c0) * ldb + kb
                       : static_cast<size_t>(kb) * ldb + c0);
  const int vr = p.m - r0, vc = p.n - c0;
  const bool vec = p.vec != 0;
  const int steps = (klen + kBK - 1) / kBK;

  auto stage_a = [&](int s) { return smem + s * (P::A_ELEMS + P::B_ELEMS); };
  auto issue = [&](int kt) {
    if (kt < steps) {
      T* as = stage_a(kt % kStages);
      T* bs = as + P::A_ELEMS;
      const int k0 = kt * kBK;
      if constexpr (P::AK)
        load_tile<T, kThreads>(as, P::LDA, a + k0, lda, BM, kBK, vr,
                               klen - k0, vec, tid);
      else
        load_tile<T, kThreads>(as, P::LDA, a + k0 * lda, lda, kBK, BM,
                               klen - k0, vr, vec, tid);
      if constexpr (P::BKI)
        load_tile<T, kThreads>(bs, P::LDB, b + k0, ldb, kBN, kBK, vc,
                               klen - k0, vec, tid);
      else
        load_tile<T, kThreads>(bs, P::LDB, b + k0 * ldb, ldb, kBK, kBN,
                               klen - k0, vc, vec, tid);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  typename P::Acc acc;
  P::zero(acc);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<kStages - 2>();  // step kt has landed (for this thread)
    __syncthreads();  // ... for every thread; and step kt - 1 is consumed
    issue(kt + kStages - 1);  // into the slot step kt - 1 used
    const T* as = stage_a(kt % kStages);
    P::step(acc, as, as + P::A_ELEMS, tid);
  }
  cp_async_wait<0>();

  // the epilogue on every sum, then the stores: the sums' epilogues are
  // independent of each other and of the stores, so they interleave. A
  // column past n takes the last column's arguments; it is never stored.
  P::map(acc, tid, [&](int col, float v) {
    const int gc = c0 + col;
    return epi(v, gc < p.n ? gc : p.n - 1);
  });
  Out* c = static_cast<Out*>(p.c);
  if constexpr (kPartial) c += static_cast<size_t>(blockIdx.z) * p.m * p.n;
  if constexpr (sizeof(T) == 2) {
    const bool pairs = p.n % 2 == 0;
    P::each_pair(acc, tid, [&](int r, int col, float v0, float v1) {
      const int gr = r0 + r, gc = c0 + col;
      if (gr >= p.m || gc >= p.n) return;
      Out* dst = c + static_cast<size_t>(gr) * p.n + gc;
      if constexpr (kPartial) {
        if (pairs) {  // n even: gc is even and gc + 1 < n
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (gc + 1 < p.n) dst[1] = v1;
        }
      } else if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
      } else {
        dst[0] = __float2bfloat16_rn(v0);
        if (gc + 1 < p.n) dst[1] = __float2bfloat16_rn(v1);
      }
    });
  } else {
    P::each(acc, tid, [&](int r, int col, float v) {
      const int gr = r0 + r, gc = c0 + col;
      if (gr < p.m && gc < p.n) c[static_cast<size_t>(gr) * p.n + gc] = v;
    });
  }
}

// both operands' rows (strides lda, ldb elements) and pointers 16-byte
// aligned
inline bool aligned16(const void* a, const void* b, size_t lda, size_t ldb,
                      size_t item) {
  return (lda * item) % 16 == 0 && (ldb * item) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

// blocks of the grid at row tile bm
inline long grid_blocks(int m, int n, int bm) {
  return static_cast<long>((n + kBN - 1) / kBN) * ((m + bm - 1) / bm);
}

// c = store(epi(a . b)). With F32Partial, K is split into ceil(k / kc)
// f32 partials (c [splits, m, n]); kc < k must keep a KInner operand's
// rows aligned (a multiple of 64 does in both dtypes).
template <typename T, int BM = kBM, typename Epi = Identity,
          typename LA = KInner, typename LB = KInner, typename Store = RoundT>
int launch(const void* a, const void* b, void* c, int m, int n, int k,
           cudaStream_t stream, Epi epi = Epi(), int kc = 0) {
  using P = Policy<T, BM, LA, LB>;
  constexpr size_t smem = smem_bytes<P>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_tile_kernel<T, BM, Epi, LA, LB, Store>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (!std::is_same<Store, F32Partial>::value || kc <= 0 || kc > k) kc = k;
  const size_t lda = P::AK ? k : m, ldb = P::BKI ? k : n;
  Args p{a, b, c, m, n, k, kc, aligned16(a, b, lda, ldb, sizeof(T)) ? 1 : 0};
  const dim3 grid((n + kBN - 1) / kBN, (m + BM - 1) / BM, (k + kc - 1) / kc);
  gemm_tile_kernel<T, BM, Epi, LA, LB, Store>
      <<<grid, kThreads, smem, stream>>>(p, epi);
  return static_cast<int>(cudaGetLastError());
}

// The row tile of an [m, n] product: 64 where that holds more blocks an
// SM (f32: two against one; bf16 holds two of either) and the 128-row grid
// takes more than one wave of resident blocks but less than two, so its
// last wave would leave SMs idle; else 128. Measured at the Swin-B shapes
// (#15): f32 fc2 at stage 2 (196 blocks) 15% faster on the 64-row tile,
// fc2 at stage 3 (104 blocks, under one wave) 12% slower; in bf16 the
// 64-row tile was as fast or slower everywhere. Returns a cudaError_t.
template <typename T>
int row_tile(int m, int n, int* bm) {
  *bm = 128;
  using P64 = Policy<T, 64>;
  using P128 = Policy<T, 128>;
  if constexpr (P64::MIN_BLOCKS > P128::MIN_BLOCKS) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    // MIN_BLOCKS is what an SM holds of a tile: the launch bounds ask for
    // it, and registers or shared memory allow no more
    const long wave = static_cast<long>(P128::MIN_BLOCKS) * sms;
    const long blocks = grid_blocks(m, n, 128);
    if (blocks > wave && blocks < 2 * wave) *bm = 64;
  }
  return 0;
}

}  // namespace
}  // namespace gemm
