// Fused window attention, forward only, for Swin inference on Hopper.
//
// Replaces gdl_tpu/ops/window_attention.py::window_attention_pallas_qkv_fused_eval
// (kernel body _wa_xw_t_eval_kernel): the forward of
// window_attention_fwd.cuh without the residual writes, so q, k, v and p
// never reach device memory, which is what the TPU kernel was written
// for. The math, rounding points and design are described there.
//
// Plain C interface (no PyTorch headers), loaded with ctypes from
// gdl_tpu_torch/kernels/__init__.py.

#include "window_attention_fwd.cuh"

// x [bw, n, c], w [3c, c], b [3c] in T (dtype 0: float32, 1: bfloat16);
// bias [heads, n, n] and mask [nw, n, n] (or null) in float32;
// out [bw, n, c] in T. Returns a cudaError_t (0 on success).
extern "C" int gdl_wa_eval_launch(const void* x, const void* w, const void* b,
                                  const void* bias, const void* mask,
                                  void* out, int bw, int n, int c, int heads,
                                  int d, int nw, float scale, int dtype,
                                  void* stream) {
  if (n < 1 || n > kNP || d < 1 || d > 64 || heads * d != c || bw < 1 ||
      nw < 1 || bw % nw != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dtype(dtype, [&](auto t) {
    return dispatch_fwd<typename decltype(t)::type, false>(
        x, w, b, bias, mask, out, nullptr, nullptr, bw, n, c, heads, d, nw,
        scale, s);
  });
}
