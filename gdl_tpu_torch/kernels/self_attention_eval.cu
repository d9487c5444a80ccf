// Eval/serving forward of the fused self-attention: the qkv projection
// and softmax(q k^T) v with no residual outputs and no dropout. Replaces
// the TPU kernel `_sa_xw_eval_kernel` behind `self_attention_fused_eval`
// (gdl_tpu/ops/self_attention.py). It is the training forward of
// self_attention_fwd.cuh without the p write and the mask; see the
// design note there. `qkv` is a scratch buffer [B, N, 3C] in T that the
// wrapper allocates.
//
// Plain C interface: pointers are device pointers, `stream` a
// cudaStream_t; dtype 0 = float32, 1 = bfloat16. Returns the error code
// of cudaGetLastError() after the launches (0 = success).

#include "self_attention_fwd.cuh"

extern "C" int gdl_sa_eval_launch(const void* x, const void* w, void* qkv,
                                  void* out, int batch, int n, int c,
                                  int heads, int d, float scale, int dtype,
                                  void* stream) {
  SaArgs a{};
  a.qkv = qkv;
  a.out = out;
  a.n = n;
  a.c = c;
  a.heads = heads;
  a.d = d;
  a.scale = scale;
  a.inv_keep = 1.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_forward<float, MODE_EVAL>(x, w, a, batch, s);
  if (dtype == 1)
    return launch_forward<__nv_bfloat16, MODE_EVAL>(x, w, a, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
