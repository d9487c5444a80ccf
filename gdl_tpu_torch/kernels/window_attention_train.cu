// Fused window attention for Swin training on Hopper: the save-p forwards
// and the attention backwards from the saved p.
//
// Forward, gdl_wa_savep_launch (kernel #2), replaces
// gdl_tpu/ops/window_attention.py::window_attention_pallas_qkv_fused
// (kernel body _wa_xw_t_savep_kernel): what the eval kernel computes, and
// also the residuals the backward reads, qkv [Bw, N, 3C] after the bias
// add (q not yet scaled) and p [Bw, H, N, N], both in T. Two launches on
// the caller's stream: the projection on the GEMM tile into qkv
// (wa2::project, window_attention_proj.cuh), then #5's launch on it.
//
// Forward on a qkv computed outside, gdl_wa_qkv_savep_launch (kernel #5),
// replaces window_attention_pallas_qkv(save_p, transposed)
// (_qkv_attn_savep_t_fwd, kernel body _wa_qkv_t_savep_kernel):
// wa_fwd_kernel of window_attention_fwd.cuh with SAVE; writes out and p.
// The forwards' body (#1, #2, #5, #6's, #7's, and #8 and #9 in
// window_attention_bhnd.cu), its design and what bounds it are in
// window_attention_fwd.cuh.
//
// Backward, gdl_wa_bwd_launch, replaces _attn_bwd_pallas_t (kernel body
// _wa_qkv_t_bwd_p_kernel, the default BWD_DELTA=False body). Per window
// and head, from the saved qkv and p and from dout:
//
//   dv = p^T . dout                    (f32 accumulate)
//   dp = dout . v^T                    (f32)
//   ds = p * (dp - rowsum(dp * p))     (f32)
//   dq = T(ds) . k * scale             (f32 accumulate, scale in f32)
//   dk = T(ds)^T . q_scaled            (f32 accumulate)
//   dqkv = [dq | dk | dv] -> T         [Bw, N, 3C]
//   dbias[h] = sum over windows of ds  (f32)
//
// With a delta pointer (gdl_wa_bwd_delta_launch; the BWD_DELTA body
// _wa_qkv_t_bwd_pd_kernel) the row sum is read, not computed:
// ds = p * (dp - delta), delta [Bw, H, N] f32 = sum_d dout * out per query,
// made by the caller.
//
// T is float or bfloat16; every rounding point above is the TPU kernel's.
// In those two the projection backward (dx, dW, db) stays outside, as
// plain GEMMs, as gdl_tpu runs it with FUSED_PROJECTION_BACKWARD off.
//
// The other two argument combinations of window_attention_pallas_qkv:
//
// - kernel #7 (save_p=False: _qkv_attn_fwd / _qkv_attn_bwd, bodies
//   _wa_qkv_kernel and _wa_qkv_bwd_kernel). Forward, gdl_wa_qkv_fwd_launch:
//   #5 without the p write. Backward, gdl_wa_bwd_recompute_launch, from
//   qkv, bias, mask and dout alone: s = q_scaled . k^T + bias + mask and
//   p = softmax(s) are computed again in f32, then #4's products, with
//   two rounding points of its own: p stays UNROUNDED f32 in
//   ds = p * (dp - rowsum(dp * p)), and is rounded to T only as the
//   operand of dv = p^T . dout. It reads no p (N*N per head) and does one
//   more N x N x d product per (window, head). BWD_DELTA does not reach it.
// - kernel #6 (transposed=False: _qkv_attn_savep_fwd / _qkv_attn_savep_bwd,
//   bodies _wa_qkv_savep_kernel and _wa_qkv_bwd_p_kernel): the same
//   functions as #5 and #4 in the TPU's row score layout, a tiling choice
//   of the TPU that has no counterpart here. Its forward,
//   gdl_wa_qkv_savep_rows_launch, is #5's launch; its backward,
//   gdl_wa_bwd_rows_launch, runs #4's device code per head, but
//   a block walks a group of g heads (gdl_tpu's head group, g * d = 128
//   where the heads allow) in turn instead of owning one head, so the grid
//   has heads / g times fewer, longer blocks. Equal bits to #5 and #4.
//
// Design of the backwards (#4, #4-delta, #6's and #7's, and #3's
// attention stage: one device body, bwd_windows of
// window_attention_bwd.cuh, in five kernels). A block of four warps owns
// one head (#6: walks its group of heads in turn) and a fixed run of `wpb`
// consecutive windows, and keeps its share of dbias in registers across
// the run; each block writes one dbias partial [N, N] per head, which the
// wrapper sums. No atomics: the sums have a fixed order, so two runs give
// equal bits. Per (window, head) the backward does 4 N x N x d products
// (5 with the scores again in #7) and reads qkv, p and dout once: at the
// Swin-B shapes it is bound by those bytes (p dominates in bf16: N*N per
// head against 3d per token), so the body streams them:
//   - q, k, v and dout rows and p's slab (#7: bias and mask) come in by
//     cp.async, in T (not f32); in bf16 from a saved p into two stages,
//     so that the next window's copies run under this window's products;
//   - the products run on the tensor cores in bf16 (mma.sync m16n8k16 on
//     ldmatrix fragments; dq's A operand is ds's accumulator registers)
//     and on a register-blocked FMA tile in f32 (no TF32: f32 stays f32,
//     as the plain versions run), on the same fragment layout: warp w
//     holds query rows 16w .. 16w + 15 for dp, the softmax backward and
//     dq, then after one barrier keys 16w .. 16w + 15 for dk and dv.
//
// Kernel #3, the fused projection backward, gdl_wa_bwd_fused_launch,
// replaces _xw_attn_savep_t_bwd's fused branch (kernel body
// _wa_xw_t_bwd_fused_kernel, gdl_tpu/ops/window_attention.py:1112):
//
//   dqkv   = #4's attention backward, rounded to T   [Bw, N, 3C]
//   dx     = dqkv . W     (f32 over all heads, one rounding to T)
//   dW     = dqkv^T . x   (f32 over all windows, one rounding to w's T)
//   db     = f32 sum over windows and tokens of the rounded dqkv
//   dbias  = f32 sum over windows of ds
//
// The TPU kernel rounds dqkv to T at the point where the backward splits
// into these sums, and keeps it in VMEM. Here it goes through device
// memory in T at that same rounding point, as #15's g does: the two sums
// pull apart (dx over the heads of ONE window, dW over ALL windows of a
// head), and a block that owned both would need atomics or would compute
// the attention backward more than once (the first design did, 2C/CT
// times over). The round trip (dqkv written once and read twice: 3.6 GB
// a bf16 arm-B step, 7.1 GB f32, 1.1 / 2.1 ms at 3.35 TB/s) is small
// beside the products; the bound does not count it. Three launches on the
// caller's stream:
//   A. wa_bwd_fused_attn_kernel: #4's grid and device body (bwd_windows
//      of window_attention_bwd.cuh, tensor cores in bf16) into the
//      caller's dqkv workspace, with #4's dbias partials and, switched on
//      for #3 alone, a db partial [runs, 3C] per run of windows: the
//      column sums of the rounded dqkv, per lane over its rows in window
//      order, then over a warp's row groups and the four warps in order.
//      Bound like #4: by the bytes of p and qkv;
//   B. dx [Bw N, C] = dqkv . W on gemm_tile.cuh (A along K, B = W [3C, C]
//      along N: ldmatrix.trans fragments in bf16), with the epilogue type
//      wa3::Dx; the 64-row tile where gemm::row_tile asks for it;
//   C. dW = dqkv^T . x on the tile with both operands along the tokens
//      (ldmatrix.trans for both in bf16), K split into runs of kc tokens
//      so that the [3C, C] grid of 128 x 128 tiles fills the card (stages
//      0-2 have 3, 12 and 48 tiles); each run stores an unrounded f32
//      partial (epilogue wa3::DwPart, store gemm::F32Partial).
// B and C are bound by their operations: 2 * Bw N 3C C multiply-adds each,
// on the tensor cores in bf16 and on the SIMT FMA tile in f32. The
// wrapper sums the dW, db and dbias partials in a fixed order and rounds
// once: no atomics anywhere, two runs give equal bits.
//
// Plain C interface (no PyTorch headers), loaded with ctypes from
// gdl_tpu_torch/kernels/__init__.py.

#include "gemm_tile.cuh"
#include "window_attention_bwd.cuh"
#include "window_attention_fwd.cuh"
#include "window_attention_proj.cuh"

namespace {

// ---------------------------------------------------------------------------
// the backwards: one device body (bwd_windows), five kernels, so that the
// profiler and the launch counts tell #4, #4-delta, #3's stage A, #6 and
// #7 apart
// ---------------------------------------------------------------------------

// #4 (DELTA false) and #4-delta (the softmax row sums read from delta)
template <typename T, int DMAX, bool DELTA>
__global__ void __launch_bounds__(kBodyThreads, BwdLayout<T, DMAX>::MIN_BLOCKS)
    wa_bwd_kernel(BwdArgs a) {
  bwd_windows<T, DMAX, DELTA, false, false>(a);
}

// #3's stage A: #4 into the dqkv workspace, with the db partials
template <typename T, int DMAX>
__global__ void __launch_bounds__(kBodyThreads, BwdLayout<T, DMAX>::MIN_BLOCKS)
    wa_bwd_fused_attn_kernel(BwdArgs a) {
  bwd_windows<T, DMAX, false, false, true>(a);
}

// #7's backward: p computed again from q, k, bias and mask, unrounded in
// ds and rounded to T as dv's operand; no p read
template <typename T, int DMAX>
__global__ void __launch_bounds__(kBodyThreads, BwdLayout<T, DMAX>::MIN_BLOCKS)
    wa_bwd_recompute_kernel(BwdArgs a) {
  bwd_windows<T, DMAX, false, true, false>(a);
}

// #6's backward: #4's body per head (so #4's dqkv bits), a block walking
// a group of g heads in turn over its run, one dbias partial per head
template <typename T, int DMAX>
__global__ void __launch_bounds__(kBodyThreads, BwdLayout<T, DMAX>::MIN_BLOCKS)
    wa_bwd_rows_kernel(BwdArgs a) {
  bwd_windows<T, DMAX, false, false, false>(a);
}

enum class Bwd { kDefault, kDelta, kFused, kRecompute, kRows };

template <typename T, int DMAX, Bwd K>
auto bwd_kernel() {
  if constexpr (K == Bwd::kDefault) return wa_bwd_kernel<T, DMAX, false>;
  else if constexpr (K == Bwd::kDelta) return wa_bwd_kernel<T, DMAX, true>;
  else if constexpr (K == Bwd::kFused) return wa_bwd_fused_attn_kernel<T, DMAX>;
  else if constexpr (K == Bwd::kRecompute)
    return wa_bwd_recompute_kernel<T, DMAX>;
  else return wa_bwd_rows_kernel<T, DMAX>;
}

// the widest piece (16, 8 or 4 bytes) in which every q, k, v and dout row
// of a head can be copied, or 0: element by element
template <typename T>
int row_width(const BwdArgs& a) {
  for (int w = 16; w >= 4; w /= 2)
    if ((a.d * sizeof(T)) % w == 0 && (a.c * sizeof(T)) % w == 0 &&
        reinterpret_cast<uintptr_t>(a.qkv) % w == 0 &&
        reinterpret_cast<uintptr_t>(a.dout) % w == 0)
      return w;
  return 0;
}

// ceil(bw / wpb) runs x heads / g blocks of the kernel K
template <typename T, Bwd K>
int launch_bwd(BwdArgs a, cudaStream_t s) {
  a.width = row_width<T>(a);
  a.pairs = a.d % 2 == 0 &&
            reinterpret_cast<uintptr_t>(a.dqkv) % (2 * sizeof(T)) == 0;
  return with_dmax(a.d, [&](auto dm) {
    constexpr int DMAX = decltype(dm)::value;
    using L = BwdLayout<T, DMAX, K == Bwd::kRecompute>;
    const size_t smem = L::bytes(a.n);
    const auto kernel = bwd_kernel<T, DMAX, K>();
    static const cudaError_t attr = grant_smem(kernel, L::max_bytes());
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const unsigned grid = static_cast<unsigned>((a.bw + a.wpb - 1) / a.wpb) *
                          static_cast<unsigned>(a.heads / a.g);
    kernel<<<grid, kBodyThreads, smem, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  });
}

// the arguments every backward takes; one head a block, no mask
BwdArgs bwd_args(const void* qkv, const void* p, const void* dout,
                 void* dqkv, void* dbias_part, int bw, int n, int c,
                 int heads, int d, int wpb, float scale) {
  BwdArgs a{};
  a.qkv = qkv;
  a.p = p;
  a.dout = dout;
  a.dqkv = dqkv;
  a.dbias_part = static_cast<float*>(dbias_part);
  a.bw = bw;
  a.n = n;
  a.c = c;
  a.heads = heads;
  a.d = d;
  a.nw = 1;
  a.g = 1;
  a.wpb = wpb;
  a.scale = scale;
  return a;
}

template <Bwd K>
int dispatch_bwd(int dtype, const BwdArgs& a, cudaStream_t s) {
  return with_dtype(dtype, [&](auto t) {
    return launch_bwd<typename decltype(t)::type, K>(a, s);
  });
}

bool bad_shape(int bw, int n, int c, int heads, int d) {
  return n < 1 || n > kNP || d < 1 || d > 64 || heads * d != c || bw < 1;
}

}  // namespace

// ---------------------------------------------------------------------------
// kernel #3's projection products on the GEMM tile (gemm_tile.cuh)
// ---------------------------------------------------------------------------

// Epilogue types of #3's own, so that its instantiations of the tile have
// symbols of their own (profile_step files them under #3).
namespace wa3 {

// dx = dqkv . W: the f32 sum over all heads, rounded once to T
struct Dx {
  __device__ float operator()(float v, int) const { return v; }
};

// a K-split partial of dW = dqkv^T . x, stored unrounded in f32
struct DwPart {
  __device__ float operator()(float v, int) const { return v; }
};

// dx [tokens, c] = dqkv [tokens, 3c] . w [3c, c] in T (A along K, B along
// N; the row tile by gemm::row_tile); dw_part [ceil(tokens / kc), 3c, c]
// f32 = the partials of dqkv^T . x [tokens, c] over runs of kc tokens
// (both operands along M and N)
template <typename T>
int products(const void* dqkv, const void* x, const void* w, void* dx,
             void* dw_part, int tokens, int c, int kc, cudaStream_t s) {
  using gemm::KInner;
  using gemm::KOuter;
  int bm = 128;
  int err = gemm::row_tile<T>(tokens, c, &bm);
  if (err != 0) return err;
  err = bm == 64
            ? gemm::launch<T, 64, Dx, KInner, KOuter>(dqkv, w, dx, tokens, c,
                                                      3 * c, s)
            : gemm::launch<T, 128, Dx, KInner, KOuter>(dqkv, w, dx, tokens,
                                                       c, 3 * c, s);
  if (err != 0) return err;
  return gemm::launch<T, 128, DwPart, KOuter, KOuter, gemm::F32Partial>(
      dqkv, x, dw_part, 3 * c, c, tokens, s, DwPart(), kc);
}

}  // namespace wa3

// x [bw, n, c], w [3c, c], b [3c] in T (dtype 0: float32, 1: bfloat16);
// bias [heads, n, n] and mask [nw, n, n] (or null) in float32. Writes
// out [bw, n, c], qkv [bw, n, 3c] and p [bw, heads, n, n], all in T; the
// attention's blocks walk wpb windows of one mask class each. Returns a
// cudaError_t (0 on success).
extern "C" int gdl_wa_savep_launch(const void* x, const void* w,
                                   const void* b, const void* bias,
                                   const void* mask, void* out, void* qkv,
                                   void* p, int bw, int n, int c, int heads,
                                   int d, int nw, int wpb, float scale,
                                   int dtype, void* stream) {
  if (bad_shape(bw, n, c, heads, d) || nw < 1 || bw % nw != 0 || wpb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dtype(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    const int err = wa2::project<T>(x, w, b, qkv, bw * n, c, s);
    if (err != 0) return err;
    return dispatch_fwd<T, true>(qkv, bias, mask, out, p, bw, n, c, heads,
                                 d, nw, wpb, scale, s);
  });
}

// Kernels #5 and #6's forward: qkv [bw, n, 3c] in T, computed by the
// caller (columns [q|k|v][head][d], q unscaled); bias and mask as above;
// blocks of wpb windows. Writes out [bw, n, c] and p [bw, heads, n, n] in
// T. Returns a cudaError_t (0 on success).
extern "C" int gdl_wa_qkv_savep_launch(const void* qkv, const void* bias,
                                       const void* mask, void* out, void* p,
                                       int bw, int n, int c, int heads, int d,
                                       int nw, int wpb, float scale,
                                       int dtype, void* stream) {
  if (bad_shape(bw, n, c, heads, d) || nw < 1 || bw % nw != 0 || wpb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dtype(dtype, [&](auto t) {
    return dispatch_fwd<typename decltype(t)::type, true>(
        qkv, bias, mask, out, p, bw, n, c, heads, d, nw, wpb, scale, s);
  });
}

// qkv [bw, n, 3c], p [bw, heads, n, n], dout [bw, n, c] in T; writes dqkv
// [bw, n, 3c] in T and dbias_part [ceil(bw / wpb), heads, n, n] in
// float32, one partial per run of wpb windows (the caller sums them).
// Returns a cudaError_t (0 on success).
extern "C" int gdl_wa_bwd_launch(const void* qkv, const void* p,
                                 const void* dout, void* dqkv,
                                 void* dbias_part, int bw, int n, int c,
                                 int heads, int d, int wpb, float scale,
                                 int dtype, void* stream) {
  if (bad_shape(bw, n, c, heads, d) || wpb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_bwd<Bwd::kDefault>(
      dtype, bwd_args(qkv, p, dout, dqkv, dbias_part, bw, n, c, heads, d, wpb,
                      scale),
      s);
}

// The same with the softmax row sums given: delta [bw, heads, n] float32,
// delta[w, h, i] = sum over d of dout[w, i, h, d] * out[w, i, h, d].
extern "C" int gdl_wa_bwd_delta_launch(const void* qkv, const void* p,
                                       const void* dout, const void* delta,
                                       void* dqkv, void* dbias_part, int bw,
                                       int n, int c, int heads, int d,
                                       int wpb, float scale, int dtype,
                                       void* stream) {
  if (bad_shape(bw, n, c, heads, d) || wpb < 1 || delta == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BwdArgs a = bwd_args(qkv, p, dout, dqkv, dbias_part, bw, n, c, heads, d,
                       wpb, scale);
  a.delta = static_cast<const float*>(delta);
  return dispatch_bwd<Bwd::kDelta>(dtype, a, s);
}

// Kernel #3. qkv, p, dout as above, x [bw, n, c] and w [3c, c] in T;
// dqkv [bw, n, 3c] in T is the caller's workspace. Three launches on the
// stream: the attention backward into dqkv, with db [runs, 3c] and dbias
// [runs, heads, n, n] float32 partials per run of wpb windows, runs =
// ceil(bw / wpb); dx [bw, n, c] in T = dqkv . w; dW's float32 partials
// dw_part [ceil(bw n / kc), 3c, c] over runs of kc tokens (kc >= bw n: one
// partial; else a multiple of 64). The caller sums the partials. Returns
// a cudaError_t (0 on success).
extern "C" int gdl_wa_bwd_fused_launch(const void* qkv, const void* p,
                                       const void* dout, const void* x,
                                       const void* w, void* dqkv, void* dx,
                                       void* dw_part, void* db_part,
                                       void* dbias_part, int bw, int n, int c,
                                       int heads, int d, int wpb, int kc,
                                       float scale, int dtype, void* stream) {
  const int tokens = bw * n;
  if (bad_shape(bw, n, c, heads, d) || wpb < 1 || kc < 1 ||
      (kc < tokens && kc % 64 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BwdArgs a = bwd_args(qkv, p, dout, dqkv, dbias_part, bw, n, c, heads, d,
                       wpb, scale);
  a.db_part = static_cast<float*>(db_part);
  return with_dtype(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    const int err = launch_bwd<T, Bwd::kFused>(a, s);
    if (err != 0) return err;
    return wa3::products<T>(dqkv, x, w, dx, dw_part, tokens, c, kc, s);
  });
}

// Kernel #7's forward: qkv [bw, n, 3c] in T computed by the caller, bias
// and mask as above, blocks of wpb windows; writes out [bw, n, c] in T and
// no p. Returns a cudaError_t (0 on success).
extern "C" int gdl_wa_qkv_fwd_launch(const void* qkv, const void* bias,
                                     const void* mask, void* out, int bw,
                                     int n, int c, int heads, int d, int nw,
                                     int wpb, float scale, int dtype,
                                     void* stream) {
  if (bad_shape(bw, n, c, heads, d) || nw < 1 || bw % nw != 0 || wpb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dtype(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    return dispatch_fwd<T, false>(qkv, bias, mask, out, nullptr, bw, n, c,
                                  heads, d, nw, wpb, scale, s);
  });
}

// Kernel #7's backward: qkv and dout in T, bias and mask (or null) in
// float32; computes p again, writes dqkv [bw, n, 3c] in T and dbias_part
// [ceil(bw / wpb), heads, n, n] in float32 (the caller sums them).
extern "C" int gdl_wa_bwd_recompute_launch(const void* qkv, const void* bias,
                                           const void* mask, const void* dout,
                                           void* dqkv, void* dbias_part,
                                           int bw, int n, int c, int heads,
                                           int d, int nw, int wpb,
                                           float scale, int dtype,
                                           void* stream) {
  if (bad_shape(bw, n, c, heads, d) || nw < 1 || bw % nw != 0 || wpb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BwdArgs a = bwd_args(qkv, nullptr, dout, dqkv, dbias_part, bw, n, c, heads,
                       d, wpb, scale);
  a.bias = static_cast<const float*>(bias);
  a.mask = static_cast<const float*>(mask);
  a.nw = nw;
  return dispatch_bwd<Bwd::kRecompute>(dtype, a, s);
}

// Kernel #6's forward: gdl_wa_qkv_savep_launch's launch (#5's grid and
// body, so #5's bits); the blocks no longer walk gdl_tpu's head group.
extern "C" int gdl_wa_qkv_savep_rows_launch(const void* qkv, const void* bias,
                                            const void* mask, void* out,
                                            void* p, int bw, int n, int c,
                                            int heads, int d, int nw, int wpb,
                                            float scale, int dtype,
                                            void* stream) {
  return gdl_wa_qkv_savep_launch(qkv, bias, mask, out, p, bw, n, c, heads, d,
                                 nw, wpb, scale, dtype, stream);
}

// Kernel #6's backward: as gdl_wa_bwd_launch, a block per run of wpb
// windows and group of g heads; one dbias partial per (run, head).
extern "C" int gdl_wa_bwd_rows_launch(const void* qkv, const void* p,
                                      const void* dout, void* dqkv,
                                      void* dbias_part, int bw, int n, int c,
                                      int heads, int d, int g, int wpb,
                                      float scale, int dtype, void* stream) {
  if (bad_shape(bw, n, c, heads, d) || wpb < 1 || g < 1 || heads % g != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BwdArgs a = bwd_args(qkv, p, dout, dqkv, dbias_part, bw, n, c, heads, d,
                       wpb, scale);
  a.g = g;
  return dispatch_bwd<Bwd::kRows>(dtype, a, s);
}
