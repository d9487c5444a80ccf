// Forward-only window attention on separate q, k, v [B, H, N, D] (the
// layout of gdl_tpu's first window-attention kernels), for callers that
// hold the heads apart:
//
//   gdl_wa_bhnd_launch    replaces gdl_tpu/ops/window_attention.py::
//                         window_attention_pallas (body _wa_kernel)
//   gdl_wa_packed_launch  replaces window_attention_pallas_packed (body
//                         _wa_packed_kernel), the same function with the
//                         heads packed in groups
//
// Per window b and head h, with the rounding points of
// window_attention_xla, the reference of both:
//
//   q   = q * T(scale)                                 (in T)
//   s   = q . k^T (f32) + bias[h] + mask[b % nW]       (f32)
//   p   = softmax(s) over keys (f32) -> round to T
//   out[b, h] = p . v (f32 accumulate) -> T
//
// Design (a first, simple one). Both load the head's q, k, v rows into
// shared memory and run attn_fwd_tail of window_attention_fwd.cuh, the
// device code of every window-attention forward here, so the two agree to
// the bit with each other and with kernel #5 on the same values. What
// differs is the block: #8 gives a block one (window, head); #9 gives a
// block one window and a group of g heads (gdl_tpu's packed head group,
// g * d = 128 where the heads allow) and walks them in turn, the TPU's
// packing without the block-diagonal zeros it multiplies. Bound on the
// H100 by the bytes of q, k, v and out (the two N x N x d products are
// 2.5 FLOP a byte in f32); tensor-core products and TMA are later work.
//
// Plain C interface (no PyTorch headers), loaded with ctypes from
// gdl_tpu_torch/kernels/__init__.py. T is float or bfloat16; bias
// [H, N, N] and mask [nW, N, N] (or null) are float32.

#include "window_attention_fwd.cuh"

namespace {

// one (window, head): q, k, v rows into shared memory, then the attention
template <typename T, int DMAX>
__device__ __forceinline__ void bhnd_head(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ mask,
    T* __restrict__ out, int win, int head, int n, int heads, int d, int nw,
    float scale_t, float* smem) {
  using S = FwdSmem<DMAX>;
  float* qs = smem;
  float* ks = qs + kNP * S::kLdQ;
  float* vs = ks + kNP * S::kLdQ;
  float* ps = smem + S::kQkv;
  const size_t off = (static_cast<size_t>(win) * heads + head) * n * d;
  load_head<T, DMAX>(q + off, k + off, v + off, d, n, d, scale_t, qs, ks, vs);
  __syncthreads();
  attn_fwd_tail<T, DMAX, false>(
      qs, ks, vs, ps, bias + static_cast<size_t>(head) * n * n,
      mask != nullptr ? mask + static_cast<size_t>(win % nw) * n * n
                      : nullptr,
      nullptr, out + off, d, n, d);
}

// kernel #8: one block per (window, head)
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
wa_bhnd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ bias,
               const float* __restrict__ mask, T* __restrict__ out, int n,
               int heads, int d, int nw, float scale) {
  extern __shared__ float smem[];
  bhnd_head<T, DMAX>(q, k, v, bias, mask, out, blockIdx.x / heads,
                     blockIdx.x % heads, n, heads, d, nw,
                     Num<T>::round(scale), smem);
}

// kernel #9: one block per (window, group of g heads), the heads in turn
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
wa_packed_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 const float* __restrict__ mask, T* __restrict__ out, int n,
                 int heads, int d, int nw, int g, float scale) {
  extern __shared__ float smem[];
  const int groups = heads / g;
  const int win = blockIdx.x / groups;
  const int h0 = (blockIdx.x % groups) * g;
  for (int head = h0; head < h0 + g; ++head) {
    bhnd_head<T, DMAX>(q, k, v, bias, mask, out, win, head, n, heads, d, nw,
                       Num<T>::round(scale), smem);
    __syncthreads();  // the next head overwrites shared memory
  }
}

bool bad_shape(int b, int n, int heads, int d, int nw) {
  return b < 1 || n < 1 || n > kNP || d < 1 || d > 64 || heads < 1 || nw < 1;
}

}  // namespace

// q, k, v, out [b, heads, n, d] in T (dtype 0: float32, 1: bfloat16); bias
// [heads, n, n] and mask [nw, n, n] (or null) in float32; window i takes
// mask[i % nw]. Returns a cudaError_t (0 on success).
extern "C" int gdl_wa_bhnd_launch(const void* q, const void* k,
                                  const void* v, const void* bias,
                                  const void* mask, void* out, int b, int n,
                                  int heads, int d, int nw, float scale,
                                  int dtype, void* stream) {
  if (bad_shape(b, n, heads, d, nw))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dtype(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    return with_dmax(d, [&](auto dm) {
      constexpr int DMAX = decltype(dm)::value;
      constexpr size_t smem = FwdSmem<DMAX>::kBytes;
      static const cudaError_t attr =
          grant_smem(wa_bhnd_kernel<T, DMAX>, smem);
      if (attr != cudaSuccess) return static_cast<int>(attr);
      const unsigned grid =
          static_cast<unsigned>(b) * static_cast<unsigned>(heads);
      wa_bhnd_kernel<T, DMAX><<<grid, kThreads, smem, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const float*>(bias),
          static_cast<const float*>(mask), static_cast<T*>(out), n, heads, d,
          nw, scale);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

// The same, a block per window and group of g heads (g divides heads);
// b must be a multiple of nw, as window_attention_pallas_packed demands.
extern "C" int gdl_wa_packed_launch(const void* q, const void* k,
                                    const void* v, const void* bias,
                                    const void* mask, void* out, int b, int n,
                                    int heads, int d, int nw, int g,
                                    float scale, int dtype, void* stream) {
  if (bad_shape(b, n, heads, d, nw) || b % nw != 0 || g < 1 ||
      heads % g != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dtype(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    return with_dmax(d, [&](auto dm) {
      constexpr int DMAX = decltype(dm)::value;
      constexpr size_t smem = FwdSmem<DMAX>::kBytes;
      static const cudaError_t attr =
          grant_smem(wa_packed_kernel<T, DMAX>, smem);
      if (attr != cudaSuccess) return static_cast<int>(attr);
      const unsigned grid =
          static_cast<unsigned>(b) * static_cast<unsigned>(heads / g);
      wa_packed_kernel<T, DMAX><<<grid, kThreads, smem, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const float*>(bias),
          static_cast<const float*>(mask), static_cast<T*>(out), n, heads, d,
          nw, g, scale);
      return static_cast<int>(cudaGetLastError());
    });
  });
}
