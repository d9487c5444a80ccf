// The window-attention forward on a qkv in device memory, shared by
// window_attention_train.cu (kernel #5, the save-p forward on a qkv
// computed outside: SAVE=true; kernel #7's forward: SAVE=false; kernel #2,
// which makes #5's launch after its projection; kernel #6's forward, which
// walks a group of heads per block), window_attention_eval.cu (kernel #1,
// which makes #7's forward launch after its projection) and
// window_attention_bhnd.cu (kernels #8 and #9 on separate q, k, v
// [B, H, N, D]). The attention of one (window, head) past the loads is one
// device function, attn_fwd_tail, so every entry rounds alike. Per window
// w and head h, from qkv [Bw, N, 3C] (columns [q|k|v][head][d], q not yet
// scaled):
//
//   q   = q * T(scale)                                   (in T)
//   s   = q . k^T (f32) + bias[h] + mask[w % nW]         (f32)
//   p   = softmax(s) over keys (f32) -> round to T       (SAVE: written)
//   out[w, :, h*d:(h+1)*d] = p . v (f32 accumulate) -> T
//
// T is float or bfloat16; every rounding point above is the TPU kernels'.
//
// #1 and #2 (the TPU's _wa_xw_t_eval_kernel and _wa_xw_t_savep_kernel)
// first compute qkv = round_T(round_T(x . W^T) + b), which the TPU keeps
// in VMEM. Here that is a launch of its own on the GEMM tile
// (window_attention_proj.cuh) over all Bw * N tokens, into device memory
// in T at the TPU's rounding point; #2 keeps it as the backward's
// residual. The projection is 2 Bw N 3C C operations, 92% of #2's work at
// the Swin-B shapes, so it is bound by operations and runs on the tensor
// cores in bf16; inside this kernel's (window, head) blocks it would read
// each window's x once per head and run on SIMT FMA. qkv's round trip
// costs #2 one more read of it and #1 a write and a read, small beside
// the products.
//
// Design of the attention (a first, simple one): one 256-thread block per
// (window, head); q, k, v, then the scores, live in shared memory in f32;
// the two N x N x d products run on the CUDA cores in f32 FMA. It is
// bound by the bytes of qkv, p and out. Tensor-core products, TMA and
// sharing a window across heads are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kNP = 64;  // max tokens per window (rows padded to 64)

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

template <int DMAX>
struct FwdSmem {
  static constexpr int kLdQ = DMAX + 1;
  static constexpr int kLdP = kNP + 1;
  // qs, ks, vs [kNP][kLdQ], then ps [kNP][kLdP]
  static constexpr int kQkv = 3 * kNP * kLdQ;
  static constexpr int kFloats = kQkv + kNP * kLdP;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

// q (scaled in T), k and v of one head into shared memory, rows padded to
// kNP and columns to DMAX with zeros. q, k, v point at the head's first
// element of each; row r lies ld elements after row r - 1. The caller
// synchronises before reading them.
template <typename T, int DMAX>
__device__ __forceinline__ void load_head(const T* __restrict__ q,
                                          const T* __restrict__ k,
                                          const T* __restrict__ v, size_t ld,
                                          int n, int d, float scale_t,
                                          float* qs, float* ks, float* vs) {
  constexpr int kLdQ = DMAX + 1;
  for (int e = threadIdx.x; e < kNP * DMAX; e += kThreads) {
    const int r = e / DMAX, dd = e % DMAX;
    float qv = 0.f, kv = 0.f, vv = 0.f;
    if (r < n && dd < d) {
      const size_t at = r * ld + dd;
      qv = Num<T>::round(Num<T>::load(q + at) * scale_t);
      kv = Num<T>::load(k + at);
      vv = Num<T>::load(v + at);
    }
    qs[r * kLdQ + dd] = qv;
    ks[r * kLdQ + dd] = kv;
    vs[r * kLdQ + dd] = vv;
  }
}

// The attention of one (window, head) once q (scaled in T), k and v lie in
// shared memory: scores + bias[h] + mask (bh, mw: [n, n] f32, mw may be
// null) in f32, softmax over keys, p rounded to T (and, with SAVE, written
// to p_w [n, n]), out = p . v (f32 accumulate) written as rows of out_w
// with row stride ldo. Shared by every forward entry. Every thread of the
// block calls it; the caller synchronises before shared memory is
// written again.
template <typename T, int DMAX, bool SAVE>
__device__ __forceinline__ void attn_fwd_tail(
    const float* qs, const float* ks, const float* vs, float* ps,
    const float* __restrict__ bh, const float* __restrict__ mw,
    T* __restrict__ p_w, T* __restrict__ out_w, size_t ldo, int n, int d) {
  constexpr int kLdQ = DMAX + 1;
  constexpr int kLdP = kNP + 1;
  constexpr int DT = DMAX / 16;  // output columns per thread
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  // ---- phase 2: scores + bias + mask, f32 -------------------------------
  {
    float sacc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[a][j] = 0.f;
    for (int k = 0; k < d; ++k) {
      float qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = qs[(ty + 16 * a) * kLdQ + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * kLdQ + k];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[a][j] = fmaf(qv[a], kv[j], sacc[a][j]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a;
      if (i >= n) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jj = tx + 16 * j;
        if (jj >= n) continue;
        float s = sacc[a][j] + bh[i * n + jj];
        if (mw != nullptr) s += mw[i * n + jj];
        ps[i * kLdP + jj] = s;
      }
    }
  }
  __syncthreads();

  // ---- phase 3: softmax over keys, one warp per row; (save p) -----------
  {
    const int lane = tid % 32;
    for (int i = tid / 32; i < n; i += kThreads / 32) {
      float* row = ps + i * kLdP;
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
      if (lane < n) {
        const float p0 = Num<T>::round(e0 / sum);
        row[lane] = p0;
        if constexpr (SAVE) p_w[i * n + lane] = Num<T>::store(p0);
      }
      if (lane + 32 < n) {
        const float p1 = Num<T>::round(e1 / sum);
        row[lane + 32] = p1;
        if constexpr (SAVE) p_w[i * n + lane + 32] = Num<T>::store(p1);
      }
    }
  }
  __syncthreads();

  // ---- phase 4: out = p . v, f32 accumulate -----------------------------
  {
    float oacc[4][DT];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < DT; ++j) oacc[a][j] = 0.f;
    for (int jj = 0; jj < n; ++jj) {
      float pv[4], vv[DT];
#pragma unroll
      for (int a = 0; a < 4; ++a) pv[a] = ps[(ty + 16 * a) * kLdP + jj];
#pragma unroll
      for (int j = 0; j < DT; ++j) vv[j] = vs[jj * kLdQ + tx + 16 * j];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < DT; ++j) oacc[a][j] = fmaf(pv[a], vv[j], oacc[a][j]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a;
      if (i >= n) continue;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const int col = tx + 16 * j;
        if (col < d) out_w[i * ldo + col] = Num<T>::store(oacc[a][j]);
      }
    }
  }
}

// one block per (window, head) of qkv [Bw, N, 3C] in T; with SAVE also
// writes p [Bw, H, N, N] in T, the residual of the training backward
template <typename T, int DMAX, bool SAVE>
__global__ void __launch_bounds__(kThreads)
wa_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
              const float* __restrict__ mask, T* __restrict__ out,
              T* __restrict__ p_out, int n, int c, int heads, int d, int nw,
              float scale) {
  using S = FwdSmem<DMAX>;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kNP * S::kLdQ;
  float* vs = ks + kNP * S::kLdQ;
  float* ps = smem + S::kQkv;

  const int win = blockIdx.x / heads;
  const int head = blockIdx.x % heads;
  const int c3 = 3 * c;
  const float scale_t = Num<T>::round(scale);
  // q (scaled in T), k, v of this head straight from the qkv tensor
  const T* qw = qkv + static_cast<size_t>(win) * n * c3 + head * d;
  load_head<T, DMAX>(qw, qw + c, qw + 2 * c, c3, n, d, scale_t, qs, ks, vs);
  __syncthreads();
  attn_fwd_tail<T, DMAX, SAVE>(
      qs, ks, vs, ps, bias + static_cast<size_t>(head) * n * n,
      mask != nullptr ? mask + static_cast<size_t>(win % nw) * n * n
                      : nullptr,
      SAVE ? p_out + (static_cast<size_t>(win) * heads + head) * n * n
           : nullptr,
      out + static_cast<size_t>(win) * n * c + head * d, c, n, d);
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

template <typename T, int DMAX, bool SAVE>
int launch_fwd(const void* qkv, const void* bias, const void* mask,
               void* out, void* p, int bw, int n, int c, int heads, int d,
               int nw, float scale, cudaStream_t stream) {
  constexpr size_t smem = FwdSmem<DMAX>::kBytes;
  static const cudaError_t attr =
      grant_smem(wa_fwd_kernel<T, DMAX, SAVE>, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const unsigned grid = static_cast<unsigned>(bw) * static_cast<unsigned>(heads);
  wa_fwd_kernel<T, DMAX, SAVE><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<T*>(out),
      static_cast<T*>(p), n, c, heads, d, nw, scale);
  return static_cast<int>(cudaGetLastError());
}

// out [bw, n, c] (and, with SAVE, p [bw, heads, n, n]) from qkv
// [bw, n, 3c], all in T
template <typename T, bool SAVE>
int dispatch_fwd(const void* qkv, const void* bias, const void* mask,
                 void* out, void* p, int bw, int n, int c, int heads, int d,
                 int nw, float scale, cudaStream_t s) {
  return with_dmax(d, [&](auto dm) {
    return launch_fwd<T, decltype(dm)::value, SAVE>(
        qkv, bias, mask, out, p, bw, n, c, heads, d, nw, scale, s);
  });
}

}  // namespace
