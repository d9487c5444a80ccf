// Forward-only window attention on separate q, k, v [B, H, N, D] (the
// layout of gdl_tpu's first window-attention kernels), for callers that
// hold the heads apart:
//
//   gdl_wa_bhnd_launch    replaces gdl_tpu/ops/window_attention.py::
//                         window_attention_pallas (body _wa_kernel, #8)
//   gdl_wa_packed_launch  replaces window_attention_pallas_packed (body
//                         _wa_packed_kernel, #9), the same function with
//                         the heads packed in groups on the TPU
//
// Per window b and head h, with the rounding points of
// window_attention_xla, the reference of both:
//
//   q   = q * T(scale)                                 (in T)
//   s   = q . k^T (f32) + bias[h] + mask[b % nW]       (f32)
//   p   = softmax(s) over keys (f32) -> round to T
//   out[b, h] = p . v (f32 accumulate) -> T
//
// wa_bhnd_kernel is the forward body of window_attention_fwd.cuh (every
// window-attention forward of the port) on the [B, H, N, D] strides: a
// block owns one head and a run of windows of one mask class, and any B
// is taken (a class may hold fewer windows than another). #9's entry
// makes #8's launch; the TPU's packing of a head group into one block has
// no counterpart here. Both give the bits of kernel #5 on the same values.
// Bound on the H100 by the bytes of q, k, v and out; the design is in
// window_attention_fwd.cuh.
//
// Plain C interface (no PyTorch headers), loaded with ctypes from
// gdl_tpu_torch/kernels/__init__.py. T is float or bfloat16; bias
// [H, N, N] and mask [nW, N, N] (or null) are float32.

#include "window_attention_fwd.cuh"

namespace {

// kernels #8 and #9: the forward body, no p
template <typename T, int DMAX>
__global__ void __launch_bounds__(kBodyThreads,
                                  FwdLayout<T, DMAX>::MIN_BLOCKS)
    wa_bhnd_kernel(FwdArgs a) {
  fwd_windows<T, DMAX, false>(a);
}

bool bad_shape(int b, int n, int heads, int d, int nw, int wpb) {
  return b < 1 || n < 1 || n > kNP || d < 1 || d > 64 || heads < 1 ||
         nw < 1 || wpb < 1;
}

// q, k, v, out [b, heads, n, d] in T; a block walks wpb windows of one
// mask class
int launch_bhnd(const void* q, const void* k, const void* v,
                const void* bias, const void* mask, void* out, int b, int n,
                int heads, int d, int nw, int wpb, float scale, int dtype,
                cudaStream_t s) {
  FwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = static_cast<const float*>(bias);
  a.mask = static_cast<const float*>(mask);
  a.out = out;
  a.ld = a.ldo = d;
  a.head = a.ohead = static_cast<size_t>(n) * d;
  a.win = a.owin = static_cast<size_t>(heads) * n * d;
  a.bw = b;
  a.n = n;
  a.heads = heads;
  a.d = d;
  a.nw = nw;
  a.wpb = wpb;
  a.scale = scale;
  return with_dtype(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    return with_dmax(d, [&](auto dm) {
      constexpr int DMAX = decltype(dm)::value;
      static const cudaError_t attr = grant_smem(
          wa_bhnd_kernel<T, DMAX>, FwdLayout<T, DMAX>::max_bytes());
      if (attr != cudaSuccess) return static_cast<int>(attr);
      return launch_body<T, DMAX>(wa_bhnd_kernel<T, DMAX>, a, s);
    });
  });
}

}  // namespace

// Kernel #8. q, k, v, out [b, heads, n, d] in T (dtype 0: float32, 1:
// bfloat16); bias [heads, n, n] and mask [nw, n, n] (or null) in float32;
// window i takes mask[i % nw]; a block walks wpb windows of one mask
// class. Returns a cudaError_t (0 on success).
extern "C" int gdl_wa_bhnd_launch(const void* q, const void* k,
                                  const void* v, const void* bias,
                                  const void* mask, void* out, int b, int n,
                                  int heads, int d, int nw, int wpb,
                                  float scale, int dtype, void* stream) {
  if (bad_shape(b, n, heads, d, nw, wpb))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bhnd(q, k, v, bias, mask, out, b, n, heads, d, nw, wpb, scale,
                     dtype, static_cast<cudaStream_t>(stream));
}

// Kernel #9: #8's launch; b must be a multiple of nw, as
// window_attention_pallas_packed demands.
extern "C" int gdl_wa_packed_launch(const void* q, const void* k,
                                    const void* v, const void* bias,
                                    const void* mask, void* out, int b, int n,
                                    int heads, int d, int nw, int wpb,
                                    float scale, int dtype, void* stream) {
  if (bad_shape(b, n, heads, d, nw, wpb) || b % nw != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bhnd(q, k, v, bias, mask, out, b, n, heads, d, nw, wpb, scale,
                     dtype, static_cast<cudaStream_t>(stream));
}
