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
//   of the TPU that has no counterpart here. gdl_wa_qkv_savep_rows_launch
//   and gdl_wa_bwd_rows_launch run #5's and #4's device code per head,
//   but a block walks a group of g heads (gdl_tpu's head group, g * d =
//   128 where the heads allow) in turn instead of owning one head, so the
//   grid has heads / g times fewer, longer blocks. Equal bits to #5 and #4.
//
// Design of the backwards (a first, simple one for #4, #6 and #7). The
// forwards are described in window_attention_fwd.cuh. The backward gives
// each block one head and a fixed run of `wpb` consecutive windows: it
// loads q, k, v, dout and p of one window into shared memory (rows padded
// to 64 there only), runs the five small products on the CUDA cores in
// f32 FMA, writes dqkv, and keeps its share of dbias in registers across
// the run. Each block writes one dbias partial [H, N, N]; the wrapper sums
// the partials. No atomics: the sum has a fixed order, so two runs give
// equal bits. The backward does 5 N x N x d products per (window, head),
// about 2.5x the forward's attention work, and reads qkv, p and dout once
// (p dominates: N*N per head against 3d per token). Tensor-core products,
// TMA and sharing a window across heads are later work.
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
//   A. wa_bwd_fused_attn_kernel: #4's grid and device body (bwd_windows:
//      attn_bwd_tile, store_dqkv) into the caller's dqkv workspace, with
//      #4's dbias partials and, switched on for #3 alone, a db partial
//      [runs, 3C] per run of windows. Bound like #4: by the bytes of p
//      and qkv, at the SIMT rate of its five small products in practice;
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
#include "window_attention_fwd.cuh"
#include "window_attention_proj.cuh"

namespace {

// ---------------------------------------------------------------------------
// attention backward of one (window, head) from the saved p
// ---------------------------------------------------------------------------

template <int DMAX>
struct BwdSmem {
  static constexpr int kLdQ = DMAX + 1;
  static constexpr int kLdP = kNP + 1;
  // qs (scaled q), ks, vs, gs (dout) [kNP][kLdQ]; ps, dss [kNP][kLdP]
  static constexpr int kQkvg = 4 * kNP * kLdQ;
  static constexpr int kFloats = kQkvg + 2 * kNP * kLdP;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

// Loads q (scaled in T), k, v, dout and p of (win, head) into shared
// memory, forms ds (adding it to dbacc: rows ty+16a, columns tx+16j) and
// leaves dq (not yet scaled), dk, dv of rows ty+16a and head-dim columns
// tx+16j in gq, gk, gv; padded rows and columns come out 0. Every thread
// of the block calls it; the caller synchronises before shared memory is
// written again. With DELTA the softmax row sums are read from
// delta [Bw, H, N]. With RECOMPUTE p is not read: it is computed again
// from q, k, bias [H, N, N] and mask [nw, N, N] (or null) as the forward
// computes it, and kept in f32; it is rounded to T only as the operand of
// dv = p^T . dout (kernel #7's rounding points).
template <typename T, int DMAX, bool DELTA, bool RECOMPUTE = false>
__device__ __forceinline__ void attn_bwd_tile(
    const T* __restrict__ qkv, const T* __restrict__ p,
    const T* __restrict__ dout, const float* __restrict__ delta, int win,
    int head, int n, int c, int heads, int d, float scale_t, float* smem,
    float (&dbacc)[4][4], float (&gq)[4][DMAX / 16], float (&gk)[4][DMAX / 16],
    float (&gv)[4][DMAX / 16], const float* __restrict__ bias = nullptr,
    const float* __restrict__ mask = nullptr, int nw = 1) {
  using S = BwdSmem<DMAX>;
  constexpr int DT = DMAX / 16;  // head-dim columns per thread
  float* qs = smem;
  float* ks = qs + kNP * S::kLdQ;
  float* vs = ks + kNP * S::kLdQ;
  float* gs = vs + kNP * S::kLdQ;
  float* ps = gs + kNP * S::kLdQ;
  float* dss = ps + kNP * S::kLdP;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int c3 = 3 * c;

  // ---- load q (scaled in T), k, v, dout of this head; p ---------------
  const T* qkv_w = qkv + static_cast<size_t>(win) * n * c3 + head * d;
  const T* g_w = dout + static_cast<size_t>(win) * n * c + head * d;
  for (int e = tid; e < kNP * DMAX; e += kThreads) {
    const int r = e / DMAX, dd = e % DMAX;
    float q = 0.f, k = 0.f, v = 0.f, g = 0.f;
    if (r < n && dd < d) {
      const T* row = qkv_w + static_cast<size_t>(r) * c3 + dd;
      q = Num<T>::round(Num<T>::load(row) * scale_t);
      k = Num<T>::load(row + c);
      v = Num<T>::load(row + 2 * c);
      g = Num<T>::load(g_w + static_cast<size_t>(r) * c + dd);
    }
    qs[r * S::kLdQ + dd] = q;
    ks[r * S::kLdQ + dd] = k;
    vs[r * S::kLdQ + dd] = v;
    gs[r * S::kLdQ + dd] = g;
  }
  if constexpr (RECOMPUTE) {
    __syncthreads();  // q and k are in shared memory
    // s = q . k^T + bias[h] + mask (f32), 0 outside [n, n]
    const float* bh = bias + static_cast<size_t>(head) * n * n;
    const float* mw =
        mask != nullptr ? mask + static_cast<size_t>(win % nw) * n * n
                        : nullptr;
    float sacc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[a][j] = 0.f;
    for (int k = 0; k < d; ++k) {
      float qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = qs[(ty + 16 * a) * S::kLdQ + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * S::kLdQ + k];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[a][j] = fmaf(qv[a], kv[j], sacc[a][j]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jj = tx + 16 * j;
        float sv = 0.f;
        if (i < n && jj < n) {
          sv = sacc[a][j] + bh[i * n + jj];
          if (mw != nullptr) sv += mw[i * n + jj];
        }
        ps[i * S::kLdP + jj] = sv;
      }
    }
    __syncthreads();
    // p = softmax(s) over keys in f32, one warp per row, NOT rounded;
    // padded rows and columns stay 0
    const int lane = tid % 32;
    for (int i = tid / 32; i < n; i += kThreads / 32) {
      float* row = ps + i * S::kLdP;
      const float s0 = lane < n ? row[lane] : -CUDART_INF_F;
      const float s1 = lane + 32 < n ? row[lane + 32] : -CUDART_INF_F;
      float m = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float e0 = lane < n ? expf(s0 - m) : 0.f;
      const float e1 = lane + 32 < n ? expf(s1 - m) : 0.f;
      float sum = e0 + e1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane < n) row[lane] = e0 / sum;
      if (lane + 32 < n) row[lane + 32] = e1 / sum;
    }
  } else {
    const T* p_w = p + (static_cast<size_t>(win) * heads + head) * n * n;
    for (int e = tid; e < kNP * kNP; e += kThreads) {
      const int i = e / kNP, j = e % kNP;
      ps[i * S::kLdP + j] = (i < n && j < n) ? Num<T>::load(p_w + i * n + j)
                                             : 0.f;
    }
  }
  __syncthreads();

  // ---- dp = dout . v^T; ds = p * (dp - rowsum(dp * p)), f32 -----------
  {
    float dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[a][j] = 0.f;
    for (int k = 0; k < d; ++k) {
      float gvv[4], vv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) gvv[a] = gs[(ty + 16 * a) * S::kLdQ + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = vs[(tx + 16 * j) * S::kLdQ + k];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[a][j] = fmaf(gvv[a], vv[j], dp[a][j]);
    }
    float pr[4][4], rs[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pr[a][j] = ps[(ty + 16 * a) * S::kLdP + tx + 16 * j];
    if constexpr (DELTA) {
      const float* dl = delta + (static_cast<size_t>(win) * heads + head) * n;
#pragma unroll
      for (int a = 0; a < 4; ++a)
        rs[a] = ty + 16 * a < n ? dl[ty + 16 * a] : 0.f;
    } else {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        rs[a] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) rs[a] = fmaf(dp[a][j], pr[a][j], rs[a]);
      }
      // the 16 threads of a half-warp share ty, so they hold one row's
      // 64 columns between them
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
#pragma unroll
        for (int a = 0; a < 4; ++a)
          rs[a] += __shfl_xor_sync(0xffffffffu, rs[a], o);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // padded rows and columns have p = 0, so ds = 0 there
        const float ds = pr[a][j] * (dp[a][j] - rs[a]);
        dbacc[a][j] += ds;
        dss[(ty + 16 * a) * S::kLdP + tx + 16 * j] = Num<T>::round(ds);
      }
  }
  __syncthreads();

  // ---- dq = ds . k, dk = ds^T . q_scaled, dv = p^T . dout -------------
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < DT; ++j) gq[a][j] = gk[a][j] = gv[a][j] = 0.f;
  for (int t = 0; t < n; ++t) {
    float ds_row[4], ds_col[4], p_col[4], kv[DT], qv[DT], dv[DT];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      ds_row[a] = dss[(ty + 16 * a) * S::kLdP + t];  // ds[i, t]
      ds_col[a] = dss[t * S::kLdP + ty + 16 * a];    // ds[t, j]
      p_col[a] = ps[t * S::kLdP + ty + 16 * a];      // p[t, j]
      if constexpr (RECOMPUTE) p_col[a] = Num<T>::round(p_col[a]);
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      kv[j] = ks[t * S::kLdQ + tx + 16 * j];
      qv[j] = qs[t * S::kLdQ + tx + 16 * j];
      dv[j] = gs[t * S::kLdQ + tx + 16 * j];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        gq[a][j] = fmaf(ds_row[a], kv[j], gq[a][j]);
        gk[a][j] = fmaf(ds_col[a], qv[j], gk[a][j]);
        gv[a][j] = fmaf(p_col[a], dv[j], gv[a][j]);
      }
  }
}

__device__ __forceinline__ void zero16(float (&acc)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;
}

// this thread's dq (scaled here, in f32), dk and dv of (win, head) into
// dqkv [Bw, N, 3C] in T: rows ty+16a, head-dim columns tx+16j
template <typename T, int DMAX>
__device__ __forceinline__ void store_dqkv(T* __restrict__ dqkv, int win,
                                           int head, int n, int c, int d,
                                           float scale,
                                           const float (&gq)[4][DMAX / 16],
                                           const float (&gk)[4][DMAX / 16],
                                           const float (&gv)[4][DMAX / 16]) {
  constexpr int DT = DMAX / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int c3 = 3 * c;
  T* dw = dqkv + static_cast<size_t>(win) * n * c3 + head * d;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
    if (i >= n) continue;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int col = tx + 16 * j;
      if (col >= d) continue;
      T* row = dw + static_cast<size_t>(i) * c3 + col;
      row[0] = Num<T>::store(gq[a][j] * scale);
      row[c] = Num<T>::store(gk[a][j]);
      row[2 * c] = Num<T>::store(gv[a][j]);
    }
  }
}

// this thread's share of a dbias partial: rows ty+16a, columns tx+16j
__device__ __forceinline__ void store_dbias(float* part, int n,
                                            const float (&dbacc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
    if (i >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = tx + 16 * j;
      if (jj < n) part[i * n + jj] = dbacc[a][j];
    }
  }
}

// ---------------------------------------------------------------------------
// kernels #4 and #4-delta (dqkv written, the projection backward outside)
// and kernel #3's stage A (the same into a dqkv workspace, with db)
// ---------------------------------------------------------------------------

// The blocks of #4 and of #3's stage A: one head and a run of wpb
// windows. Each (window, head) goes through attn_bwd_tile into dqkv in T;
// the block keeps its share of dbias in registers and writes one dbias
// partial. With DB (#3) it also writes one db partial: db_part[run,
// [q|k|v][head][d]] = the f32 sum over the run's windows and tokens of
// the dqkv values the block stored, rounded to T (dq scaled before
// rounding, as store_dqkv scales it). Each thread sums its rows in order
// over the windows; the 16 row groups are added in order at the end,
// through shared memory.
template <typename T, int DMAX, bool DELTA, bool DB>
__device__ __forceinline__ void bwd_windows(
    const T* __restrict__ qkv, const T* __restrict__ p,
    const T* __restrict__ dout, const float* __restrict__ delta,
    T* __restrict__ dqkv, float* __restrict__ dbias_part,
    float* __restrict__ db_part, int bw, int n, int c, int heads, int d,
    int wpb, float scale) {
  constexpr int DT = DMAX / 16;
  extern __shared__ float smem[];
  const int chunk = blockIdx.x / heads;
  const int head = blockIdx.x % heads;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float scale_t = Num<T>::round(scale);

  float dbacc[4][4];  // this block's share of dbias[head]
  zero16(dbacc);
  float dbq[DT], dbk[DT], dbv[DT];  // DB: columns tx + 16 j, rows ty + 16 a
#pragma unroll
  for (int j = 0; j < DT; ++j) dbq[j] = dbk[j] = dbv[j] = 0.f;

  const int w_end = min(bw, (chunk + 1) * wpb);
  for (int win = chunk * wpb; win < w_end; ++win) {
    float gq[4][DT], gk[4][DT], gv[4][DT];
    attn_bwd_tile<T, DMAX, DELTA>(qkv, p, dout, delta, win, head, n, c, heads,
                                  d, scale_t, smem, dbacc, gq, gk, gv);
    store_dqkv<T, DMAX>(dqkv, win, head, n, c, d, scale, gq, gk, gv);
    if constexpr (DB) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (ty + 16 * a >= n) continue;
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          dbq[j] += Num<T>::round(gq[a][j] * scale);
          dbk[j] += Num<T>::round(gk[a][j]);
          dbv[j] += Num<T>::round(gv[a][j]);
        }
      }
    }
    __syncthreads();  // the next window overwrites shared memory
  }
  store_dbias(
      dbias_part + (static_cast<size_t>(chunk) * heads + head) * n * n, n,
      dbacc);
  if constexpr (DB) {
    static_assert(16 * 3 * DMAX <= BwdSmem<DMAX>::kFloats, "db reduction");
    // red[ty][[q|k|v] DMAX + col]: the 16 row groups' column sums
    float* red = smem;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      red[ty * 3 * DMAX + tx + 16 * j] = dbq[j];
      red[ty * 3 * DMAX + DMAX + tx + 16 * j] = dbk[j];
      red[ty * 3 * DMAX + 2 * DMAX + tx + 16 * j] = dbv[j];
    }
    __syncthreads();
    for (int col = threadIdx.x; col < 3 * DMAX; col += kThreads) {
      const int part = col / DMAX, dd = col % DMAX;
      if (dd >= d) continue;
      float sum = 0.f;
      for (int r = 0; r < 16; ++r) sum += red[r * 3 * DMAX + col];
      db_part[static_cast<size_t>(chunk) * 3 * c + part * c + head * d + dd] =
          sum;
    }
  }
}

// Two kernels on one body, so that the profiler and the launch counts tell
// #4 from #3's stage A, and #4 keeps its bits
template <typename T, int DMAX, bool DELTA>
__global__ void __launch_bounds__(kThreads)
wa_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ p,
              const T* __restrict__ dout, const float* __restrict__ delta,
              T* __restrict__ dqkv, float* __restrict__ dbias_part,
              float* __restrict__ db_part, int bw, int n, int c, int heads,
              int d, int wpb, float scale) {
  bwd_windows<T, DMAX, DELTA, false>(qkv, p, dout, delta, dqkv, dbias_part,
                                     db_part, bw, n, c, heads, d, wpb, scale);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
wa_bwd_fused_attn_kernel(const T* __restrict__ qkv, const T* __restrict__ p,
                         const T* __restrict__ dout,
                         const float* __restrict__ delta, T* __restrict__ dqkv,
                         float* __restrict__ dbias_part,
                         float* __restrict__ db_part, int bw, int n, int c,
                         int heads, int d, int wpb, float scale) {
  bwd_windows<T, DMAX, false, true>(qkv, p, dout, delta, dqkv, dbias_part,
                                    db_part, bw, n, c, heads, d, wpb, scale);
}

// #4 (DB false) or #3's stage A (DB true, no delta): ceil(bw / wpb) runs
// x heads blocks
template <typename T, int DMAX, bool DELTA, bool DB>
int launch_bwd(const void* qkv, const void* p, const void* dout,
               const void* delta, void* dqkv, void* dbias_part, void* db_part,
               int bw, int n, int c, int heads, int d, int wpb, float scale,
               cudaStream_t stream) {
  static_assert(!(DB && DELTA), "#3's stage A takes no delta");
  constexpr size_t smem = BwdSmem<DMAX>::kBytes;
  const auto kernel = [] {
    if constexpr (DB) return wa_bwd_fused_attn_kernel<T, DMAX>;
    else return wa_bwd_kernel<T, DMAX, DELTA>;
  }();
  static const cudaError_t attr = grant_smem(kernel, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const unsigned chunks = static_cast<unsigned>((bw + wpb - 1) / wpb);
  const unsigned grid = chunks * static_cast<unsigned>(heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(p),
      static_cast<const T*>(dout), static_cast<const float*>(delta),
      static_cast<T*>(dqkv), static_cast<float*>(dbias_part),
      static_cast<float*>(db_part), bw, n, c, heads, d, wpb, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool DELTA, bool DB = false>
int dispatch_bwd(const void* qkv, const void* p, const void* dout,
                 const void* delta, void* dqkv, void* dbias_part,
                 void* db_part, int bw, int n, int c, int heads, int d,
                 int wpb, float scale, cudaStream_t s) {
  return with_dmax(d, [&](auto dm) {
    return launch_bwd<T, decltype(dm)::value, DELTA, DB>(
        qkv, p, dout, delta, dqkv, dbias_part, db_part, bw, n, c, heads, d,
        wpb, scale, s);
  });
}

// ---------------------------------------------------------------------------
// kernel #7's backward: p computed again from qkv, bias and mask
// ---------------------------------------------------------------------------

// #4's blocks (one head, a run of wpb windows, one dbias partial each),
// with attn_bwd_tile<RECOMPUTE>: one more N x N x d product per (window,
// head), the scores, and no p read.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
wa_bwd_recompute_kernel(const T* __restrict__ qkv,
                        const float* __restrict__ bias,
                        const float* __restrict__ mask,
                        const T* __restrict__ dout, T* __restrict__ dqkv,
                        float* __restrict__ dbias_part, int bw, int n, int c,
                        int heads, int d, int nw, int wpb, float scale) {
  constexpr int DT = DMAX / 16;
  extern __shared__ float smem[];
  const int chunk = blockIdx.x / heads;
  const int head = blockIdx.x % heads;
  const float scale_t = Num<T>::round(scale);
  float dbacc[4][4];
  zero16(dbacc);
  const int w_end = min(bw, (chunk + 1) * wpb);
  for (int win = chunk * wpb; win < w_end; ++win) {
    float gq[4][DT], gk[4][DT], gv[4][DT];
    attn_bwd_tile<T, DMAX, false, true>(qkv, nullptr, dout, nullptr, win,
                                        head, n, c, heads, d, scale_t, smem,
                                        dbacc, gq, gk, gv, bias, mask, nw);
    store_dqkv<T, DMAX>(dqkv, win, head, n, c, d, scale, gq, gk, gv);
    __syncthreads();  // the next window overwrites shared memory
  }
  store_dbias(
      dbias_part + (static_cast<size_t>(chunk) * heads + head) * n * n, n,
      dbacc);
}

// ---------------------------------------------------------------------------
// kernel #6: the save-p forward and the backward from p, a group of heads
// per block
// ---------------------------------------------------------------------------

// The TPU's row-layout kernels hold the scores of a group of g heads
// (gd = g * d = 128 lanes) in rows of one block. Here a block owns one
// window (forward) or one run of windows (backward) and a group of g
// heads, and walks the heads in turn through the device code of #5 and
// #4; each head's arithmetic, and so every bit, is theirs.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
wa_fwd_rows_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                   const float* __restrict__ mask, T* __restrict__ out,
                   T* __restrict__ p_out, int n, int c, int heads, int d,
                   int nw, int g, float scale) {
  using S = FwdSmem<DMAX>;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kNP * S::kLdQ;
  float* vs = ks + kNP * S::kLdQ;
  float* ps = smem + S::kQkv;
  const int groups = heads / g;
  const int win = blockIdx.x / groups;
  const int h0 = (blockIdx.x % groups) * g;
  const int c3 = 3 * c;
  const float scale_t = Num<T>::round(scale);
  const float* mw =
      mask != nullptr ? mask + static_cast<size_t>(win % nw) * n * n : nullptr;
  for (int head = h0; head < h0 + g; ++head) {
    const T* qw = qkv + static_cast<size_t>(win) * n * c3 + head * d;
    load_head<T, DMAX>(qw, qw + c, qw + 2 * c, c3, n, d, scale_t, qs, ks, vs);
    __syncthreads();
    attn_fwd_tail<T, DMAX, true>(
        qs, ks, vs, ps, bias + static_cast<size_t>(head) * n * n, mw,
        p_out + (static_cast<size_t>(win) * heads + head) * n * n,
        out + static_cast<size_t>(win) * n * c + head * d, c, n, d);
    __syncthreads();  // the next head overwrites shared memory
  }
}

// one block per (run of wpb windows, group of g heads): for each head of
// the group, #4's walk over the run and one dbias partial
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
wa_bwd_rows_kernel(const T* __restrict__ qkv, const T* __restrict__ p,
                   const T* __restrict__ dout, T* __restrict__ dqkv,
                   float* __restrict__ dbias_part, int bw, int n, int c,
                   int heads, int d, int g, int wpb, float scale) {
  constexpr int DT = DMAX / 16;
  extern __shared__ float smem[];
  const int groups = heads / g;
  const int chunk = blockIdx.x / groups;
  const int h0 = (blockIdx.x % groups) * g;
  const float scale_t = Num<T>::round(scale);
  const int w_end = min(bw, (chunk + 1) * wpb);
  for (int head = h0; head < h0 + g; ++head) {
    float dbacc[4][4];
    zero16(dbacc);
    for (int win = chunk * wpb; win < w_end; ++win) {
      float gq[4][DT], gk[4][DT], gv[4][DT];
      attn_bwd_tile<T, DMAX, false>(qkv, p, dout, nullptr, win, head, n, c,
                                    heads, d, scale_t, smem, dbacc, gq, gk,
                                    gv);
      store_dqkv<T, DMAX>(dqkv, win, head, n, c, d, scale, gq, gk, gv);
      __syncthreads();  // the next tile overwrites shared memory
    }
    store_dbias(
        dbias_part + (static_cast<size_t>(chunk) * heads + head) * n * n, n,
        dbacc);
  }
}

template <typename T>
int launch_bwd_recompute(const void* qkv, const void* bias, const void* mask,
                         const void* dout, void* dqkv, void* dbias_part,
                         int bw, int n, int c, int heads, int d, int nw,
                         int wpb, float scale, cudaStream_t s) {
  return with_dmax(d, [&](auto dm) {
    constexpr int DMAX = decltype(dm)::value;
    constexpr size_t smem = BwdSmem<DMAX>::kBytes;
    static const cudaError_t attr =
        grant_smem(wa_bwd_recompute_kernel<T, DMAX>, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const unsigned grid =
        static_cast<unsigned>((bw + wpb - 1) / wpb) * static_cast<unsigned>(heads);
    wa_bwd_recompute_kernel<T, DMAX><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(qkv), static_cast<const float*>(bias),
        static_cast<const float*>(mask), static_cast<const T*>(dout),
        static_cast<T*>(dqkv), static_cast<float*>(dbias_part), bw, n, c,
        heads, d, nw, wpb, scale);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int launch_fwd_rows(const void* qkv, const void* bias, const void* mask,
                    void* out, void* p, int bw, int n, int c, int heads, int d,
                    int nw, int g, float scale, cudaStream_t s) {
  return with_dmax(d, [&](auto dm) {
    constexpr int DMAX = decltype(dm)::value;
    constexpr size_t smem = FwdSmem<DMAX>::kBytes;
    static const cudaError_t attr =
        grant_smem(wa_fwd_rows_kernel<T, DMAX>, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const unsigned grid =
        static_cast<unsigned>(bw) * static_cast<unsigned>(heads / g);
    wa_fwd_rows_kernel<T, DMAX><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(qkv), static_cast<const float*>(bias),
        static_cast<const float*>(mask), static_cast<T*>(out),
        static_cast<T*>(p), n, c, heads, d, nw, g, scale);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int launch_bwd_rows(const void* qkv, const void* p, const void* dout,
                    void* dqkv, void* dbias_part, int bw, int n, int c,
                    int heads, int d, int g, int wpb, float scale,
                    cudaStream_t s) {
  return with_dmax(d, [&](auto dm) {
    constexpr int DMAX = decltype(dm)::value;
    constexpr size_t smem = BwdSmem<DMAX>::kBytes;
    static const cudaError_t attr =
        grant_smem(wa_bwd_rows_kernel<T, DMAX>, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const unsigned grid = static_cast<unsigned>((bw + wpb - 1) / wpb) *
                          static_cast<unsigned>(heads / g);
    wa_bwd_rows_kernel<T, DMAX><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(qkv), static_cast<const T*>(p),
        static_cast<const T*>(dout), static_cast<T*>(dqkv),
        static_cast<float*>(dbias_part), bw, n, c, heads, d, g, wpb, scale);
    return static_cast<int>(cudaGetLastError());
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
// out [bw, n, c], qkv [bw, n, 3c] and p [bw, heads, n, n], all in T.
// Returns a cudaError_t (0 on success).
extern "C" int gdl_wa_savep_launch(const void* x, const void* w,
                                   const void* b, const void* bias,
                                   const void* mask, void* out, void* qkv,
                                   void* p, int bw, int n, int c, int heads,
                                   int d, int nw, float scale, int dtype,
                                   void* stream) {
  if (bad_shape(bw, n, c, heads, d) || nw < 1 || bw % nw != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dtype(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    const int err = wa2::project<T>(x, w, b, qkv, bw * n, c, s);
    if (err != 0) return err;
    return dispatch_fwd<T, true>(qkv, bias, mask, out, p, bw, n, c, heads,
                                 d, nw, scale, s);
  });
}

// qkv [bw, n, 3c] in T, computed by the caller (columns [q|k|v][head][d],
// q unscaled); bias and mask as above. Writes out [bw, n, c] and
// p [bw, heads, n, n] in T. Returns a cudaError_t (0 on success).
extern "C" int gdl_wa_qkv_savep_launch(const void* qkv, const void* bias,
                                       const void* mask, void* out, void* p,
                                       int bw, int n, int c, int heads, int d,
                                       int nw, float scale, int dtype,
                                       void* stream) {
  if (bad_shape(bw, n, c, heads, d) || nw < 1 || bw % nw != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dtype(dtype, [&](auto t) {
    return dispatch_fwd<typename decltype(t)::type, true>(
        qkv, bias, mask, out, p, bw, n, c, heads, d, nw, scale, s);
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
  return with_dtype(dtype, [&](auto t) {
    return dispatch_bwd<typename decltype(t)::type, false>(
        qkv, p, dout, nullptr, dqkv, dbias_part, nullptr, bw, n, c, heads, d,
        wpb, scale, s);
  });
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
  return with_dtype(dtype, [&](auto t) {
    return dispatch_bwd<typename decltype(t)::type, true>(
        qkv, p, dout, delta, dqkv, dbias_part, nullptr, bw, n, c, heads, d,
        wpb, scale, s);
  });
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
  return with_dtype(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    const int err = dispatch_bwd<T, false, true>(qkv, p, dout, nullptr, dqkv,
                                                 dbias_part, db_part, bw, n,
                                                 c, heads, d, wpb, scale, s);
    if (err != 0) return err;
    return wa3::products<T>(dqkv, x, w, dx, dw_part, tokens, c, kc, s);
  });
}

// Kernel #7's forward: qkv [bw, n, 3c] in T computed by the caller, bias
// and mask as above; writes out [bw, n, c] in T and no p. Returns a
// cudaError_t (0 on success).
extern "C" int gdl_wa_qkv_fwd_launch(const void* qkv, const void* bias,
                                     const void* mask, void* out, int bw,
                                     int n, int c, int heads, int d, int nw,
                                     float scale, int dtype, void* stream) {
  if (bad_shape(bw, n, c, heads, d) || nw < 1 || bw % nw != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dtype(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    return dispatch_fwd<T, false>(qkv, bias, mask, out, nullptr, bw, n, c,
                                  heads, d, nw, scale, s);
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
  return with_dtype(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    return launch_bwd_recompute<T>(qkv, bias, mask, dout, dqkv, dbias_part,
                                   bw, n, c, heads, d, nw, wpb, scale, s);
  });
}

// Kernel #6's forward: as gdl_wa_qkv_savep_launch (writes out and p), a
// block per window and group of g heads (g divides heads).
extern "C" int gdl_wa_qkv_savep_rows_launch(const void* qkv, const void* bias,
                                            const void* mask, void* out,
                                            void* p, int bw, int n, int c,
                                            int heads, int d, int nw, int g,
                                            float scale, int dtype,
                                            void* stream) {
  if (bad_shape(bw, n, c, heads, d) || nw < 1 || bw % nw != 0 || g < 1 ||
      heads % g != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dtype(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    return launch_fwd_rows<T>(qkv, bias, mask, out, p, bw, n, c, heads, d, nw,
                              g, scale, s);
  });
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
  return with_dtype(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    return launch_bwd_rows<T>(qkv, p, dout, dqkv, dbias_part, bw, n, c, heads,
                              d, g, wpb, scale, s);
  });
}
