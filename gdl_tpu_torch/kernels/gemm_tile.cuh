// A block-tile GEMM for Hopper: C[M, N] = round_T(epi(A[M, K] . B[N, K]^T)),
// both operands K-contiguous (x [rows, C] and a weight in nn.Linear layout
// [out, in]), sums in f32, an epilogue in f32 on each sum, one rounding to
// T at the store.
//
// What it replaces. The qkv projection of `_sa_xw_eval_kernel`
// (gdl_tpu/ops/self_attention.py:637, the product at :644-648: x . W in
// f32, rounded to T) for kernel #13 and of `_sa_xw_fwd_kernel` (:154) for
// #10, with the identity epilogue; and #15's fc1 and fc2 (`_mlp_kernel`,
// gdl_tpu/ops/mlp.py:69), with the bias and GELU epilogues of
// mlp_fused.cu. The epilogue is a type parameter of the kernel, so each
// caller's instantiation has its own symbol.
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
//     k + 2 run under the products of step k. The ragged M, N and K edges
//     are zero-filled by the copy's source size, never read past the end.
//     Where a row is not 16-byte aligned (K * sizeof(T) % 16 != 0, or a
//     pointer off 16 bytes) the tile is copied element by element through
//     registers instead: the same ring, synchronous copies;
//   - bf16: mma.sync m16n8k16 (bf16 in, f32 sums) on fragments from
//     ldmatrix, on the tensor cores. Each warp owns a BM/2 x 32 sub-tile
//     (BM/32 x 4 fragments, BM/2 f32 sums a thread). The tile rows are
//     padded to 72 elements (144 bytes), so the eight rows an ldmatrix
//     phase reads fall on distinct banks;
//   - f32: register-blocked FMA, BM/16 x 8 sums a thread (rows ty + 16 i,
//     columns tx + 16 j), float4 reads along K from rows padded to 36
//     floats: 16 shared-memory reads for every 256 FMAs. No TF32 anywhere:
//     f32 stays f32, as torch.backends.cuda.matmul.allow_tf32 = False keeps
//     the plain version.
// Not here yet: wgmma, TMA, warp specialisation, persistent blocks.
//
// Each output element is one thread's sum in a fixed order, so a launch
// gives the same bits every time (no atomics, no split K).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

template <typename T, int BM>
struct Policy;

// bf16 on the tensor cores; warp (wm, wn) owns rows wm*BM/2 .. +BM/2-1 and
// columns wn*32 .. +31 of the block tile
template <int BM>
struct Policy<__nv_bfloat16, BM> {
  static_assert(BM == 64 || BM == 128, "row tile");
  using T = __nv_bfloat16;
  static constexpr int BK = 64;        // K per stage
  static constexpr int LDS = BK + 8;   // 144-byte rows
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

  __device__ static void step(Acc& acc, const T* as, const T* bs, int tid) {
    const int lane = tid % 32, warp = tid / 32;
    const int wm = warp % 2, wn = warp / 2;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(a[i], as + (wm * (BM / 2) + i * 16 + lane % 16) * LDS + kk +
                          (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        ldsm_x2(b[j], bs + (wn * 32 + j * 8 + lane % 8) * LDS + kk +
                          ((lane / 8) % 2) * 8);
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

// f32 on SIMT FMA; thread (ty, tx) = (tid / 16, tid % 16) owns rows
// ty + 16 i and columns tx + 16 j, i < MI = BM / 16, j < 8
template <int BM>
struct Policy<float, BM> {
  static_assert(BM == 64 || BM == 128, "row tile");
  using T = float;
  static constexpr int BK = 32;        // K per stage
  static constexpr int LDS = BK + 4;   // 36 floats: float4 rows, no conflicts
  static constexpr int MI = BM / 16;
  // the 8 x 8 tile needs > 128 registers, the 4 x 8 tile fewer
  static constexpr int MIN_BLOCKS = BM == 128 ? 1 : 2;
  struct Acc {
    float c[MI][8];
  };

  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc.c[i][j] = 0.f;
  }

  __device__ static void step(Acc& acc, const T* as, const T* bs, int tid) {
    const int tx = tid % 16, ty = tid / 16;
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[MI];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + (ty + 16 * i) * LDS + kk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b =
            *reinterpret_cast<const float4*>(bs + (tx + 16 * j) * LDS + kk);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          float s = acc.c[i][j];
          s = fmaf(a[i].x, b.x, s);
          s = fmaf(a[i].y, b.y, s);
          s = fmaf(a[i].z, b.z, s);
          s = fmaf(a[i].w, b.w, s);
          acc.c[i][j] = s;
        }
      }
    }
  }

  template <typename F>
  __device__ static void map(Acc& acc, int tid, F fn) {
    const int tx = tid % 16;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc.c[i][j] = fn(tx + 16 * j, acc.c[i][j]);
  }

  template <typename F>
  __device__ static void each(const Acc& acc, int tid, F fn) {
    const int tx = tid % 16, ty = tid / 16;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) fn(ty + 16 * i, tx + 16 * j, acc.c[i][j]);
  }
};

template <typename T, int BM>
constexpr size_t smem_bytes() {
  return sizeof(T) * kStages * (BM + kBN) * Policy<T, BM>::LDS;
}

struct Args {
  const void* a;  // [m, k]
  const void* b;  // [n, k]
  void* c;        // [m, n]
  int m, n, k;
  int vec;  // 1: rows and pointers are 16-byte aligned
};

// C = round_T(epi(A . B^T)). Grid: (ceil(n / 128), ceil(m / BM)); the
// blocks of one row of tiles run next to each other and share A's rows in
// L2.
template <typename T, int BM = kBM, typename Epi = Identity>
__global__ void __launch_bounds__(kThreads, Policy<T, BM>::MIN_BLOCKS)
    gemm_tile_kernel(Args p, Epi epi) {
  using P = Policy<T, BM>;
  constexpr int LDS = P::LDS, kBK = P::BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * kBN;
  const T* a = static_cast<const T*>(p.a) + static_cast<size_t>(r0) * p.k;
  const T* b = static_cast<const T*>(p.b) + static_cast<size_t>(c0) * p.k;
  const int vr = p.m - r0, vc = p.n - c0;
  const bool vec = p.vec != 0;
  const int steps = (p.k + kBK - 1) / kBK;

  auto stage_a = [&](int s) { return smem + s * (BM + kBN) * LDS; };
  auto issue = [&](int kt) {
    if (kt < steps) {
      T* as = stage_a(kt % kStages);
      const int k0 = kt * kBK;
      load_tile<T, kThreads>(as, LDS, a + k0, p.k, BM, kBK, vr, p.k - k0,
                             vec, tid);
      load_tile<T, kThreads>(as + BM * LDS, LDS, b + k0, p.k, kBN, kBK, vc,
                             p.k - k0, vec, tid);
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
    P::step(acc, as, as + BM * LDS, tid);
  }
  cp_async_wait<0>();

  // the epilogue on every sum, then the stores: the sums' epilogues are
  // independent of each other and of the stores, so they interleave. A
  // column past n takes the last column's arguments; it is never stored.
  P::map(acc, tid, [&](int col, float v) {
    const int gc = c0 + col;
    return epi(v, gc < p.n ? gc : p.n - 1);
  });
  T* c = static_cast<T*>(p.c);
  if constexpr (sizeof(T) == 2) {
    const bool pairs = p.n % 2 == 0;
    P::each_pair(acc, tid, [&](int r, int col, float v0, float v1) {
      const int gr = r0 + r, gc = c0 + col;
      if (gr >= p.m || gc >= p.n) return;
      T* dst = c + static_cast<size_t>(gr) * p.n + gc;
      if (pairs) {  // n even: gc is even and gc + 1 < n
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

// the rows of a and b and both pointers 16-byte aligned
inline bool aligned16(const void* a, const void* b, int k, size_t item) {
  return (k * item) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

// blocks of the grid at row tile bm
inline long grid_blocks(int m, int n, int bm) {
  return static_cast<long>((n + kBN - 1) / kBN) * ((m + bm - 1) / bm);
}

template <typename T, int BM = kBM, typename Epi = Identity>
int launch(const void* a, const void* b, void* c, int m, int n, int k,
           cudaStream_t stream, Epi epi = Epi()) {
  constexpr size_t smem = smem_bytes<T, BM>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_tile_kernel<T, BM, Epi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  Args p{a, b, c, m, n, k, aligned16(a, b, k, sizeof(T)) ? 1 : 0};
  const dim3 grid((n + kBN - 1) / kBN, (m + BM - 1) / BM);
  gemm_tile_kernel<T, BM, Epi><<<grid, kThreads, smem, stream>>>(p, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace gemm
