// Fused window attention for Swin training on Hopper: the save-p forward
// and the attention backward from the saved p.
//
// Forward, gdl_wa_savep_launch, replaces
// gdl_tpu/ops/window_attention.py::window_attention_pallas_qkv_fused
// (kernel body _wa_xw_t_savep_kernel): the forward of
// window_attention_fwd.cuh, which computes what the eval kernel computes
// and also writes the residuals the backward reads: qkv [Bw, N, 3C] after
// the bias add (q not yet scaled) and p [Bw, H, N, N], both in T.
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
// T is float or bfloat16; every rounding point above is the TPU kernel's.
// The projection backward (dx, dW, db) stays outside, as plain GEMMs, as
// gdl_tpu runs it (its FUSED_PROJECTION_BACKWARD gate is off).
//
// Design (a first, simple one). The forward is described in
// window_attention_fwd.cuh; it is bound, like the eval kernel, by the
// projection's FMAs (98% of its work) at the SIMT f32 rate. The backward
// gives each block one head and a fixed run of `wpb` consecutive windows:
// it loads q, k, v, dout and p of one window into shared memory (rows
// padded to 64 there only), runs the five small products on the CUDA
// cores in f32 FMA, writes dqkv, and keeps its share of dbias in
// registers across the run. Each block writes one dbias partial
// [H, N, N]; the wrapper sums the partials. No atomics: the sum has a
// fixed order, so two runs give equal bits. The backward does 5 N x N x d
// products per (window, head), about 2.5x the forward's attention work
// and a tenth of its projection, and reads qkv, p and dout once (p
// dominates: N*N per head against 3d per token). Tensor-core products,
// TMA and sharing a window across heads are later work.
//
// Plain C interface (no PyTorch headers), loaded with ctypes from
// gdl_tpu_torch/kernels/__init__.py.

#include "window_attention_fwd.cuh"

namespace {

// ---------------------------------------------------------------------------
// backward from the saved p
// ---------------------------------------------------------------------------

template <int DMAX>
struct BwdSmem {
  static constexpr int kLdQ = DMAX + 1;
  static constexpr int kLdP = kNP + 1;
  // qs (scaled q), ks, vs, gs (dout) [kNP][kLdQ]; ps, dss [kNP][kLdP]
  static constexpr int kFloats = 4 * kNP * kLdQ + 2 * kNP * kLdP;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
wa_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ p,
              const T* __restrict__ dout, T* __restrict__ dqkv,
              float* __restrict__ dbias_part, int bw, int n, int c, int heads,
              int d, int wpb, float scale) {
  using S = BwdSmem<DMAX>;
  constexpr int DT = DMAX / 16;  // head-dim columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kNP * S::kLdQ;
  float* vs = ks + kNP * S::kLdQ;
  float* gs = vs + kNP * S::kLdQ;
  float* ps = gs + kNP * S::kLdQ;
  float* dss = ps + kNP * S::kLdP;

  const int chunk = blockIdx.x / heads;
  const int head = blockIdx.x % heads;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int c3 = 3 * c;
  const float scale_t = Num<T>::round(scale);

  // this block's share of dbias[head], rows ty+16a, columns tx+16j
  float dbacc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) dbacc[a][j] = 0.f;

  const int w_end = min(bw, (chunk + 1) * wpb);
  for (int win = chunk * wpb; win < w_end; ++win) {
    // ---- load q (scaled in T), k, v, dout of this head; p -------------
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
    const T* p_w = p + (static_cast<size_t>(win) * heads + head) * n * n;
    for (int e = tid; e < kNP * kNP; e += kThreads) {
      const int i = e / kNP, j = e % kNP;
      ps[i * S::kLdP + j] = (i < n && j < n) ? Num<T>::load(p_w + i * n + j)
                                             : 0.f;
    }
    __syncthreads();

    // ---- dp = dout . v^T; ds = p * (dp - rowsum(dp * p)), f32 ---------
    {
      float dp[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[a][j] = 0.f;
      for (int k = 0; k < d; ++k) {
        float gv[4], vv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) gv[a] = gs[(ty + 16 * a) * S::kLdQ + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) vv[j] = vs[(tx + 16 * j) * S::kLdQ + k];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) dp[a][j] = fmaf(gv[a], vv[j], dp[a][j]);
      }
      float pr[4][4], rs[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        rs[a] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pr[a][j] = ps[(ty + 16 * a) * S::kLdP + tx + 16 * j];
          rs[a] = fmaf(dp[a][j], pr[a][j], rs[a]);
        }
      }
      // the 16 threads of a half-warp share ty, so they hold one row's
      // 64 columns between them
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
#pragma unroll
        for (int a = 0; a < 4; ++a)
          rs[a] += __shfl_xor_sync(0xffffffffu, rs[a], o);
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

    // ---- dq = ds . k, dk = ds^T . q_scaled, dv = p^T . dout -----------
    float gq[4][DT], gk[4][DT], gv[4][DT];
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
    __syncthreads();  // the next window overwrites shared memory
  }

  float* part = dbias_part + (static_cast<size_t>(chunk) * heads + head) * n * n;
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

template <typename T, int DMAX>
int launch_bwd(const void* qkv, const void* p, const void* dout, void* dqkv,
               void* dbias_part, int bw, int n, int c, int heads, int d,
               int wpb, float scale, cudaStream_t stream) {
  constexpr size_t smem = BwdSmem<DMAX>::kBytes;
  static const cudaError_t attr = grant_smem(wa_bwd_kernel<T, DMAX>, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const unsigned chunks = static_cast<unsigned>((bw + wpb - 1) / wpb);
  const unsigned grid = chunks * static_cast<unsigned>(heads);
  wa_bwd_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(p),
      static_cast<const T*>(dout), static_cast<T*>(dqkv),
      static_cast<float*>(dbias_part), bw, n, c, heads, d, wpb, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bwd(const void* qkv, const void* p, const void* dout,
                 void* dqkv, void* dbias_part, int bw, int n, int c,
                 int heads, int d, int wpb, float scale, cudaStream_t s) {
  if (d <= 16)
    return launch_bwd<T, 16>(qkv, p, dout, dqkv, dbias_part, bw, n, c, heads,
                             d, wpb, scale, s);
  if (d <= 32)
    return launch_bwd<T, 32>(qkv, p, dout, dqkv, dbias_part, bw, n, c, heads,
                             d, wpb, scale, s);
  return launch_bwd<T, 64>(qkv, p, dout, dqkv, dbias_part, bw, n, c, heads,
                           d, wpb, scale, s);
}

}  // namespace

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
  if (n < 1 || n > kNP || d < 1 || d > 64 || heads * d != c || bw < 1 ||
      nw < 1 || bw % nw != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_fwd<float, true>(x, w, b, bias, mask, out, qkv, p, bw, n,
                                     c, heads, d, nw, scale, s);
  if (dtype == 1)
    return dispatch_fwd<__nv_bfloat16, true>(x, w, b, bias, mask, out, qkv,
                                             p, bw, n, c, heads, d, nw, scale,
                                             s);
  return static_cast<int>(cudaErrorInvalidValue);
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
  if (n < 1 || n > kNP || d < 1 || d > 64 || heads * d != c || bw < 1 ||
      wpb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_bwd<float>(qkv, p, dout, dqkv, dbias_part, bw, n, c,
                               heads, d, wpb, scale, s);
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16>(qkv, p, dout, dqkv, dbias_part, bw, n,
                                       c, heads, d, wpb, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
