// Training kernels of the fused self-attention (gdl_tpu/ops/
// self_attention.py):
//
//   gdl_sa_fwd_launch  kernel #10, the forward `_sa_xw_fwd_kernel` +
//                      `_sa_attn_tail` (pallas_call at :444): qkv
//                      projection, softmax, attention-probability
//                      dropout, p . v; writes out, the qkv residual
//                      [B, N, 3C] and the pre-dropout p residual
//                      [B, H, N, N]
//   gdl_sa_qkv_fwd_launch
//                      kernel #12, the forward `_sa_fwd_kernel` +
//                      `_sa_attn_tail` of self_attention_qkv (:339): the
//                      same without the projection, on a qkv [B, N, 3C]
//                      the caller projected
//   gdl_sa_bwd_launch  kernel #11, the backward `_sa_bwd_kernel` (:375):
//                      dqkv [B, N, 3C] from qkv, the saved p, the same mask
//                      and dout
//
// For batch row b and head h over N tokens the forwards compute, with the
// TPU kernels' rounding points (T float or bfloat16):
//
//   qkv = round_T(x . W^T)                      (#10 only; f32 sums)
//   q   = round_T(q * round_T(scale));  s = q . k^T        (f32)
//   p   = softmax(s) over the whole row (f32; exp(s - max) / sum)
//   p residual = round_T(p), stored BEFORE dropout
//   P   = round_T(p * m), m in {0, float32(1 / (1 - rate))} or 1
//   out[b, :, h*d:(h+1)*d] = round_T(P . v)     (f32 sums)
//
// dropout_mode: 0 none; 1 the mask [B, H, N, N] in T with values
// {0, 1/(1-rate)} is read from `mask`; 2 the mask is drawn in the kernel
// by Philox from the two seed words at `seed` (device memory), keyed on
// the flat [B, H, N, N] index, keeping an element iff its word <
// keep_thresh, and drawn again, bit for bit, in the backward. `keep_out`,
// if not null, receives the mode-2 keep mask as bytes (gdl_tpu's
// emit_mask output; a debug output for holding the kernel's bits to the
// plain generator's).
//
// What bounds the forwards. Per mmformer_n step (batch 64, 4 calls at
// N = 196 and 3 at N = 392, C = 512, 8 heads of 64) #12 is 82 GFLOP
// against 2.3 GB in f32 (1.1 GB in bf16), #10 adds a 197-GFLOP
// projection: in f32 both are bound by operations at the SIMT rate
// (67 TFLOP/s), in bf16 #12 by bytes (the p residual) and #10 by bytes
// too (0.34 / 0.38 ms). The first design ran everything on SIMT f32 FMA,
// the attention at 11% of its f32 bound.
//
// What the design does about it:
//   1. #10's projection is gemm::gemm_tile_kernel (gemm_tile.cuh, #13's
//      and #15's GEMM tile, the identity epilogue) into the qkv residual:
//      mma.sync with cp.async stages in bf16, register tiles in f32.
//   2. The attention of both is sa_rows::sa_train_kernel, the row tile of
//      #13's eval kernel (self_attention_rows.cuh: bf16 on mma.sync with
//      a cp.async ring holding every K/V chunk of a head, 64-row blocks,
//      a one-pass whole-row softmax; f32 register-blocked) with one more
//      pass over each row of the score tile, one warp a row: it divides
//      by the row's sum, stores the p residual along the row, draws one
//      Philox word group per four keys (or reads the mask), writes the
//      keep bytes, and leaves round_T(p * m) in the tile for P . V.
//
// The backward (#11) computes, from qkv, the ROUNDED pre-dropout p
// residual, the same mask m and dout:
//
//   p_d = round_T(p * m);  dv = p_d^T . dout;  dp = (dout . v^T) * m
//   ds  = round_T(p * (dp - sum_j dp * p))    (the inner sum in f32)
//   dq  = (ds . k) * scale (f32 scale);  dk = ds^T . round_T(q * T(scale))
//
// What bounds it. Per mmformer_n step it is 163 GFLOP against 3.1 GB in
// f32 (bound by operations at the SIMT rate, 2.43 ms) and 1.5 GB in bf16
// (bound by bytes, 0.46 ms); the ds scratch between its two launches
// moves one more score-sized write and read. The first design ran both
// launches on SIMT f32 FMA with scalar loads and no overlap of load and
// compute: bf16 no faster than f32, at 3.3% of its bound.
//
// What the design does about it: two launches on one stream, so that no
// sum crosses blocks (bit-reproducible, no atomics):
//   A. sa_rows::sa_bwd_rows_kernel, the row tile in its backward mode
//      (self_attention_rows.cuh): dout's rows in place of q, v's chunks in
//      place of k, so dp = dout . v^T lands in the f32 score tile; one
//      warp a row draws m again, reduces delta with shuffles and writes
//      ds to the scratch [B, H, N, N] in T and to the tile; k's chunks
//      then give dq = (ds . k) * scale into the q third of dqkv. bf16 on
//      mma.sync, f32 register-blocked, as the forwards.
//   B. sa_keys::sa_bwd_keys_kernel, one 256-thread block per (batch,
//      head, 64 keys): the query rows in chunks (64 bf16, 32 f32) of p,
//      ds, dout and q come in through a ring of cp.async stages; p_d and
//      q_s are formed in shared memory (m drawn again by Philox: ≈ 7.7 G
//      integer operations a step, where part A writing p_d for part B to
//      read in p's place would add a score-sized write, 0.63 GB in bf16,
//      and a second scratch); both products have the query index as K
//      (gemm_tile.cuh's KOuter layouts): bf16 mma.sync on ldmatrix.trans
//      fragments, warps 0-3 dv and 4-7 dk, 16 keys x d each; f32
//      register-blocked FMA in runs of four. dk and dv are stored once.
// Not here yet: wgmma, TMA, warp specialisation, persistent blocks.
//
// Plain C interface: pointers are device pointers, `stream` a
// cudaStream_t; dtype 0 = float32, 1 = bfloat16. Each returns the error
// code of cudaGetLastError() after its launches (0 = success).

#include "self_attention_rows.cuh"

// ---- #11 part B: dv and dk, one block per (batch, head, 64 keys) ---------

namespace sa_keys {
namespace {

using gemm::cp_async_commit;
using gemm::cp_async_wait;
using gemm::ldsm_x4_trans;
using gemm::load_tile;
using gemm::mma_bf16;
using sa_rows::Args;

constexpr int kKeys = 64;  // keys a block
constexpr int kThreads = 256;
constexpr int kHalfSmem = 115712;  // two blocks an SM

// Keys<T, DMAX>: the query rows of a chunk (QC, the K of both products),
// the shared tiles' row strides, the sums a thread holds and the products
// of one chunk. A stage holds p_d and ds [QC][LDS] (keys contiguous: the
// products' A operand, K outer) and dout and q_s [QC][LDD] (d contiguous:
// their B operand, K outer), gemm_tile.cuh's KOuter layouts.
template <typename T, int DMAX>
struct Keys;

// bf16 on the tensor cores: warp w holds dv (w < 4) or dk for the keys
// (w % 4) * 16 .. + 15 and all DMAX columns, mma.sync m16n8k16 on
// fragments from ldmatrix.trans
template <int DMAX>
struct Keys<__nv_bfloat16, DMAX> {
  using T = __nv_bfloat16;
  static constexpr int QC = 64;
  static constexpr int DB = DMAX;        // columns of the dout and q tiles
  static constexpr int LDS = kKeys + 8;  // 16-byte rows off the bank period
  static constexpr int LDD = DB + 8;
  static constexpr int NT = DMAX / 8;  // 8-column tiles of a warp's sums
  struct Acc {
    float c[NT][4];
  };

  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc.c[j][t] = 0.f;
  }

  // acc += A^T . B over the chunk's QC query rows: A = p_d or ds, B = dout
  // or q_s
  __device__ static void step(Acc& acc, const T* pd, const T* ds,
                              const T* dout, const T* qs, int tid) {
    const int lane = tid % 32, warp = tid / 32;
    const int m0 = (warp % 4) * 16;
    const T* as = warp < 4 ? pd : ds;
    const T* bs = warp < 4 ? dout : qs;
#pragma unroll
    for (int kk = 0; kk < QC; kk += 16) {
      // A fragment of keys m0 .. m0 + 15 from the [q][keys] tile, read
      // transposed (gemm_tile.cuh's KOuter A)
      uint32_t a[4];
      ldsm_x4_trans(a, as + (kk + (lane / 16) * 8 + lane % 8) * LDS + m0 +
                           ((lane / 8) % 2) * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {  // B fragments j, j + 1 ([q][d])
        uint32_t r[4];
        ldsm_x4_trans(r, bs + (kk + ((lane / 8) % 2) * 8 + lane % 8) * LDD +
                             j * 8 + (lane / 16) * 8);
        mma_bf16(acc.c[j], a, r);
        mma_bf16(acc.c[j + 1], a, r + 2);
      }
    }
  }

  // fn(dk, key, col, v) for every sum this thread holds
  template <typename F>
  __device__ static void each(const Acc& acc, int tid, F fn) {
    const int lane = tid % 32, warp = tid / 32;
    const int m0 = (warp % 4) * 16, g = lane / 4, q = lane % 4;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t)
        fn(warp >= 4, m0 + g + 8 * (t / 2), j * 8 + 2 * q + t % 2,
           acc.c[j][t]);
  }
};

// f32 on SIMT FMA: threads 0 .. 127 hold dv, 128 .. 255 dk; thread t
// takes the keys 4 (t % 16) + 0..3 and the columns 4 ((t % 128) / 16) +
// 32 u + 0..3 (runs of four: one float4 of each operand at each q row)
template <int DMAX>
struct Keys<float, DMAX> {
  using T = float;
  static constexpr int QC = 32;
  static constexpr int DB = DMAX < 32 ? 32 : DMAX;
  static constexpr int LDS = kKeys + 4;  // float4 rows off the bank period
  static constexpr int LDD = DB + 4;
  static constexpr int CU = DB / 32;  // runs of four columns a thread
  struct Acc {
    float c[4][4 * CU];
  };

  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4 * CU; ++j) acc.c[i][j] = 0.f;
  }

  // each sum takes its q rows in ascending order, one fmaf each
  __device__ static void step(Acc& acc, const T* pd, const T* ds,
                              const T* dout, const T* qs, int tid) {
    const int tk = tid % 16, td = (tid % 128) / 16;
    const T* as = tid < 128 ? pd : ds;
    const T* bs = tid < 128 ? dout : qs;
#pragma unroll 4
    for (int k = 0; k < QC; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(as + k * LDS + 4 * tk);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int u = 0; u < CU; ++u) {
        const float4 b4 = *reinterpret_cast<const float4*>(bs + k * LDD +
                                                           4 * td + 32 * u);
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc.c[i][4 * u + e] = fmaf(av[i], bv[e], acc.c[i][4 * u + e]);
      }
    }
  }

  template <typename F>
  __device__ static void each(const Acc& acc, int tid, F fn) {
    const int tk = tid % 16, td = (tid % 128) / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < CU; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          fn(tid >= 128, 4 * tk + i, 4 * td + 32 * u + e, acc.c[i][4 * u + e]);
  }
};

// elements of one stage: p_d, ds, dout, q_s
template <typename K>
__host__ __device__ constexpr int stage_elems() {
  return 2 * K::QC * K::LDS + 2 * K::QC * K::LDD;
}

// three stages where two blocks an SM still fit, else two
template <typename T, typename K>
__host__ __device__ constexpr int stages() {
  return 3 * sizeof(T) * stage_elems<K>() <= kHalfSmem ? 3 : 2;
}

// rows [rows][64 keys] of p or ds (row stride ld) into shared memory (row
// stride lds), zero past (vrows, vcols), by copies of `width` bytes: 16
// or none (element by element) as load_tile makes them, or 8 or 4 by
// cp.async through L1 (rows of N = 196 in bf16 are 392 bytes)
template <typename T>
__device__ inline void load_scores(int width, T* dst, int lds, const T* src,
                                   size_t ld, int rows, int vrows, int vcols,
                                   int tid) {
  if (width != 8 && width != 4) {
    load_tile<T, kThreads>(dst, lds, src, ld, rows, kKeys, vrows, vcols,
                           width == 16, tid);
    return;
  }
  const int v = width / static_cast<int>(sizeof(T));  // elements a copy
  const int vpr = kKeys / v;
  for (int e = tid; e < rows * vpr; e += kThreads) {
    const int r = e / vpr, c = (e % vpr) * v;
    int nb = 0;
    if (r < vrows && c < vcols)
      nb = (vcols - c < v ? vcols - c : v) * static_cast<int>(sizeof(T));
    const T* s = nb ? src + r * ld + c : src;
    if (width == 8)
      gemm::cp_async_ca<8>(dst + r * lds + c, s, nb);
    else
      gemm::cp_async_ca<4>(dst + r * lds + c, s, nb);
  }
}

// A stage in place, once it is in: p_d = round_T(p * m), m drawn again by
// Philox on the flat [B, H, N, N] index (mode 2) or read (mode 1), four
// consecutive keys at a time; and q_s = round_T(q * round_T(scale)).
// Elements past N are zeros and stay zeros.
template <typename K, typename T>
__device__ inline void prologue(T* pd, T* qs, const Args& a, int i0, int j0,
                                uint64_t bh, uint32_t k0, uint32_t k1,
                                float scale_t, int tid) {
  const int n = a.n;
  if (a.dropout_mode != 0) {
    const bool vec = a.rowvec != 0;
    for (int e = tid; e < K::QC * (kKeys / 4); e += kThreads) {
      const int r = e / (kKeys / 4), j = j0 + 4 * (e % (kKeys / 4));
      const int i = i0 + r;
      if (i >= n || j >= n) continue;
      const int valid = n - j < 4 ? n - j : 4;
      float m[4], v[4];
      sa_rows::multiplier4<T>(a, (bh + i) * static_cast<uint64_t>(n) + j,
                              valid, vec, k0, k1, m);
      T* s = pd + r * K::LDS + (j - j0);
      sa_rows::load4<T>(s, v, 4, true);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        v[t] = sa_rows::to_f(sa_rows::to_t<T>(v[t] * m[t]));
      sa_rows::store4<T>(s, v, 4, true);
    }
  }
  for (int e = tid; e < K::QC * (K::DB / 4); e += kThreads) {
    const int r = e / (K::DB / 4), col = 4 * (e % (K::DB / 4));
    T* s = qs + r * K::LDD + col;
    float v[4];
    sa_rows::load4<T>(s, v, 4, true);
#pragma unroll
    for (int t = 0; t < 4; ++t)
      v[t] = sa_rows::to_f(sa_rows::to_t<T>(v[t] * scale_t));
    sa_rows::store4<T>(s, v, 4, true);
  }
}

// dv = p_d^T . dout and dk = ds^T . q_s for the keys j0 .. j0 + 63 of one
// (batch, head), over the query rows in chunks of QC through a ring of
// cp.async stages; dk and dv are stored once, at columns C and 2C of
// dqkv. width: the copy size of p's and ds's rows (see load_scores).
// (2 blocks an SM: at most 128 registers; d > 64 takes 1, whose sums
// would not fit 128 registers a thread)
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, DMAX > 64 ? 1 : 2)
    sa_bwd_keys_kernel(Args a, int width) {
  using K = Keys<T, DMAX>;
  constexpr int QC = K::QC, LDS = K::LDS, LDD = K::LDD, DB = K::DB;
  constexpr int STAGE = stage_elems<K>();
  constexpr int NS = stages<T, K>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int n = a.n, c = a.c, d = a.d, c3 = 3 * c;
  const int j0 = blockIdx.x * kKeys, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const bool vec = a.vec != 0;
  const uint64_t bh = (static_cast<uint64_t>(b) * gridDim.y + head) * n;
  const T* qkv_b =
      static_cast<const T*>(a.qkv) + static_cast<size_t>(b) * n * c3 + head * d;
  const T* dout_b =
      static_cast<const T*>(a.dout) + static_cast<size_t>(b) * n * c + head * d;
  const T* p_b = static_cast<const T*>(a.p) + bh * n + j0;
  const T* ds_b = static_cast<const T*>(a.ds) + bh * n + j0;
  const int nq = (n + QC - 1) / QC;
  uint32_t k0 = 0, k1 = 0;
  if (a.dropout_mode == 2) {
    k0 = static_cast<uint32_t>(a.seed[0]);
    k1 = static_cast<uint32_t>(a.seed[1]);
  }
  const float scale_t =
      std::is_same<T, float>::value ? a.scale : sa_rows::bf16_round(a.scale);

  // chunk t's four operands into stage t % NS; a group is committed even
  // past the end, so that the count of groups in flight stays NS - 1
  auto issue = [&](int t) {
    if (t < nq) {
      T* pd = smem + (t % NS) * STAGE;
      T* ds = pd + QC * LDS;
      T* dout = ds + QC * LDS;
      T* qs = dout + QC * LDD;
      const int i0 = t * QC;
      const size_t row = static_cast<size_t>(i0) * n;
      load_scores<T>(width, pd, LDS, p_b + row, n, QC, n - i0, n - j0, tid);
      load_scores<T>(width, ds, LDS, ds_b + row, n, QC, n - i0, n - j0, tid);
      load_tile<T, kThreads>(dout, LDD, dout_b + static_cast<size_t>(i0) * c,
                             c, QC, DB, n - i0, d, vec, tid);
      load_tile<T, kThreads>(qs, LDD, qkv_b + static_cast<size_t>(i0) * c3,
                             c3, QC, DB, n - i0, d, vec, tid);
    }
    cp_async_commit();
  };

  typename K::Acc acc;
  K::zero(acc);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) issue(s);
  for (int t = 0; t < nq; ++t) {
    cp_async_wait<NS - 2>();  // chunk t has landed (for this thread)
    __syncthreads();  // ... for every thread; and chunk t - 1 is consumed
    issue(t + NS - 1);  // into the stage chunk t - 1 used
    T* pd = smem + (t % NS) * STAGE;
    T* ds = pd + QC * LDS;
    T* dout = ds + QC * LDS;
    T* qs = dout + QC * LDD;
    prologue<K>(pd, qs, a, t * QC, j0, bh, k0, k1, scale_t, tid);
    __syncthreads();  // p_d and q_s are in place
    K::step(acc, pd, ds, dout, qs, tid);
  }
  cp_async_wait<0>();

  // dqkv [B, N, 3C]: dk at column offset C, dv at 2C
  T* out = static_cast<T*>(a.out) + static_cast<size_t>(b) * n * c3 + head * d;
  K::each(acc, tid, [&](bool dk, int key, int col, float v) {
    const int j = j0 + key;
    if (j < n && col < d)
      out[static_cast<size_t>(j) * c3 + (dk ? c : 2 * c) + col] =
          sa_rows::to_t<T>(v);
  });
}

// the widest copy of p's and ds's rows that their alignment allows
int score_width(size_t row_bytes, const void* p, const void* ds) {
  for (int w = 16; w >= 4; w /= 2)
    if (row_bytes % w == 0 && reinterpret_cast<uintptr_t>(p) % w == 0 &&
        reinterpret_cast<uintptr_t>(ds) % w == 0)
      return w;
  return 0;
}

template <typename T, int DMAX>
int launch_dmax(Args a, int batch, cudaStream_t s) {
  using K = Keys<T, DMAX>;
  constexpr size_t smem = sizeof(T) * stages<T, K>() * stage_elems<K>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      sa_bwd_keys_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  a.vec = (a.d * sizeof(T)) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.qkv) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.dout) % 16 == 0;
  const int width = score_width(a.n * sizeof(T), a.p, a.ds);
  const dim3 grid((a.n + kKeys - 1) / kKeys, a.heads, batch);
  sa_bwd_keys_kernel<T, DMAX><<<grid, kThreads, smem, s>>>(a, width);
  return static_cast<int>(cudaGetLastError());
}

// part B over the ds that part A wrote
template <typename T>
int launch(const Args& a, int batch, cudaStream_t s) {
  if (a.d <= 16) return launch_dmax<T, 16>(a, batch, s);
  if (a.d <= 32) return launch_dmax<T, 32>(a, batch, s);
  if (a.d <= 64) return launch_dmax<T, 64>(a, batch, s);
  if (a.d <= 128) return launch_dmax<T, 128>(a, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace sa_keys

namespace {

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the forwards: the projection into qkv when x is given, then the row
// tiles
template <typename T>
int launch_forward(const void* x, const void* w, void* qkv, void* p,
                   void* out, const void* mask, const void* seed,
                   void* keep_out, int batch, int n, int c, int heads, int d,
                   float scale, int dropout_mode, unsigned keep_thresh,
                   float inv_keep, cudaStream_t s) {
  if (x != nullptr) {
    const int err = gemm::launch<T>(x, w, qkv, batch * n, 3 * c, c, s);
    if (err != 0) return err;
  }
  sa_rows::Args a{};
  a.qkv = qkv;
  a.out = out;
  a.n = n;
  a.c = c;
  a.d = d;
  a.heads = heads;
  a.scale = scale;
  a.p = p;
  a.mask = mask;
  a.seed = static_cast<const int*>(seed);
  a.keep_out = static_cast<unsigned char*>(keep_out);
  a.dropout_mode = dropout_mode;
  a.keep_thresh = keep_thresh;
  a.inv_keep = inv_keep;
  a.rowvec = n % 4 == 0 && aligned16(p) &&
             (dropout_mode != 1 || aligned16(mask)) &&
             (keep_out == nullptr || aligned16(keep_out));
  return sa_rows::launch_attention<T, sa_rows::kTrain>(a, batch, s);
}

// #11: part A (dp, ds into the scratch, dq), then part B (dk, dv) on it
template <typename T>
int backward(const sa_rows::Args& a, int batch, cudaStream_t s) {
  const int err = sa_rows::launch_attention<T, sa_rows::kBwd>(a, batch, s);
  if (err != 0) return err;
  return sa_keys::launch<T>(a, batch, s);
}

template <typename... A>
int forward(int dtype, A... args) {
  if (dtype == 0) return launch_forward<float>(args...);
  if (dtype == 1) return launch_forward<__nv_bfloat16>(args...);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int gdl_sa_fwd_launch(const void* x, const void* w, void* qkv,
                                 void* p, void* out, const void* mask,
                                 const void* seed, void* keep_out, int batch,
                                 int n, int c, int heads, int d, float scale,
                                 int dropout_mode, unsigned keep_thresh,
                                 float inv_keep, int dtype, void* stream) {
  return forward(dtype, x, w, qkv, p, out, mask, seed, keep_out, batch, n, c,
                 heads, d, scale, dropout_mode, keep_thresh, inv_keep,
                 static_cast<cudaStream_t>(stream));
}

// kernel #12: the row tiles of gdl_sa_fwd_launch alone, on a qkv in T
extern "C" int gdl_sa_qkv_fwd_launch(const void* qkv, void* p, void* out,
                                     const void* mask, const void* seed,
                                     void* keep_out, int batch, int n, int c,
                                     int heads, int d, float scale,
                                     int dropout_mode, unsigned keep_thresh,
                                     float inv_keep, int dtype,
                                     void* stream) {
  return forward(dtype, static_cast<const void*>(nullptr),
                 static_cast<const void*>(nullptr), const_cast<void*>(qkv), p,
                 out, mask, seed, keep_out, batch, n, c, heads, d, scale,
                 dropout_mode, keep_thresh, inv_keep,
                 static_cast<cudaStream_t>(stream));
}

extern "C" int gdl_sa_bwd_launch(const void* qkv, const void* p,
                                 const void* mask, const void* seed,
                                 const void* dout, void* ds, void* dqkv,
                                 int batch, int n, int c, int heads, int d,
                                 float scale, int dropout_mode,
                                 unsigned keep_thresh, float inv_keep,
                                 int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  sa_rows::Args a{};
  a.qkv = qkv;
  a.out = dqkv;
  a.n = n;
  a.c = c;
  a.d = d;
  a.heads = heads;
  a.scale = scale;
  a.p = const_cast<void*>(p);
  a.mask = mask;
  a.seed = static_cast<const int*>(seed);
  a.dropout_mode = dropout_mode;
  a.keep_thresh = keep_thresh;
  a.inv_keep = inv_keep;
  a.dout = dout;
  a.ds = ds;
  a.rowvec = n % 4 == 0 && aligned16(p) && aligned16(ds) &&
             (dropout_mode != 1 || aligned16(mask));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? backward<float>(a, batch, s)
                    : backward<__nv_bfloat16>(a, batch, s);
}
