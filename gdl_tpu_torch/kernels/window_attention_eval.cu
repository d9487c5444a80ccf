// Fused window attention, forward only, for Swin inference on Hopper:
// kernel #1.
//
// Replaces gdl_tpu/ops/window_attention.py::window_attention_pallas_qkv_fused_eval
// (kernel body _wa_xw_t_eval_kernel): the qkv projection, then the
// window attention, with the TPU kernel's rounding points. Two launches
// on the caller's stream:
//   1. wa2::project (window_attention_proj.cuh): qkv [Bw N, 3C] =
//      round_T(round_T(x . W^T) + b) on the GEMM tile, over all tokens at
//      once, into a workspace in T that the caller allocates;
//   2. wa_fwd_kernel without the p write (window_attention_fwd.cuh),
//      which is kernel #7's forward: out from that qkv.
// The TPU kernel keeps qkv in VMEM; here it goes through device memory
// once (written by 1, read by 2), where the TPU kernel rounds it. The
// projection is 2 Bw N 3C C operations, most of the work at the Swin-B
// shapes, so it runs over all tokens on the GEMM tile's tensor cores in
// bf16; the attention's design and what bounds it are in
// window_attention_fwd.cuh.
//
// Plain C interface (no PyTorch headers), loaded with ctypes from
// gdl_tpu_torch/kernels/__init__.py.

#include "window_attention_proj.cuh"

// x [bw, n, c], w [3c, c], b [3c] in T (dtype 0: float32, 1: bfloat16);
// bias [heads, n, n] and mask [nw, n, n] (or null) in float32; qkv
// [bw, n, 3c] in T is the caller's workspace; writes out [bw, n, c] in T;
// the attention's blocks walk wpb windows of one mask class each.
// Returns a cudaError_t (0 on success).
extern "C" int gdl_wa_eval_launch(const void* x, const void* w, const void* b,
                                  const void* bias, const void* mask,
                                  void* qkv, void* out, int bw, int n, int c,
                                  int heads, int d, int nw, int wpb,
                                  float scale, int dtype, void* stream) {
  if (n < 1 || n > kNP || d < 1 || d > 64 || heads * d != c || bw < 1 ||
      nw < 1 || bw % nw != 0 || wpb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dtype(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    const int err = wa2::project<T>(x, w, b, qkv, bw * n, c, s);
    if (err != 0) return err;
    return dispatch_fwd<T, false>(qkv, bias, mask, out, nullptr, bw, n, c,
                                  heads, d, nw, wpb, scale, s);
  });
}
