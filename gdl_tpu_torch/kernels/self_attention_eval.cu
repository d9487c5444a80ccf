// Kernel #13: the eval/serving forward of the fused self-attention, the
// qkv projection and softmax(q k^T) v with no residual outputs and no
// dropout. Replaces the TPU kernel `_sa_xw_eval_kernel` behind
// `self_attention_fused_eval` (gdl_tpu/ops/self_attention.py:637,
// pallas_call at :689). For batch row b and head h, over N tokens:
//
//   qkv = round_T(x[b] . W^T)          (f32 sums; gemm_tile.cuh)  [N, 3C]
//   q   = round_T(q * round_T(scale))
//   s   = q . k^T                       (f32)
//   p   = round_T(softmax(s))           (the whole row, in f32)
//   out[b, :, h*d:(h+1)*d] = round_T(p . v)   (f32 sums)
//
// T is float or bfloat16; these rounding points are the TPU kernel's and
// the plain version's (`self_attention_fused_eval_ref`).
//
// What bounds it on this card. Per eval forward of mmformer_n (batch 64,
// 4 calls at N = 196 and 3 at N = 392, C = 512, 8 heads of 64) the work
// is 197 GFLOP of projection and 82 GFLOP of attention against 0.5 GB of
// operands: bound by operations in both dtypes (989 TFLOP/s bf16 on the
// tensor cores, 67 TFLOP/s f32 on SIMT FMA). The first design ran both
// dtypes on SIMT FMA (bf16 widened on load), its attention bound by
// shared-memory loads (8 loads for 16 FMAs) and its chunks loaded by
// scalar copies that did not overlap compute.
//
// What this design does about it. One entry point, two kernels:
//   1. gemm::gemm_tile_kernel (gemm_tile.cuh): qkv = x . W^T over all B*N
//      rows into a scratch buffer the wrapper allocates; mma.sync in bf16,
//      8 x 8 register tiles in f32.
//   2. sa_rows::sa_eval_kernel (self_attention_rows.cuh, the row tile it
//      shares with the training forward #10 / #12): one block per (batch,
//      head, R query rows), R = 64 where the f32 score tile [R, N] and two
//      chunk buffers fit in a block's 227 KB (N up to about 540 in f32,
//      800 in bf16), else 32, so N up to 1024 is taken. K, then V, stream
//      through the block by cp.async through a ring of up to 8 chunk
//      buffers, so the block waits for the L2 once, not once a chunk.
//      bf16 runs S = q . k^T and P . V on mma.sync with ldmatrix
//      fragments, P = round_bf16(e * (1 / sum)) packed from the f32 tile;
//      f32 runs the same structure in register-blocked SIMT FMA (float4
//      reads, 12 reads for 128 FMAs) and multiplies its sums by 1 / sum.
//      The softmax keeps the whole row, as the TPU kernel does: no online
//      (rescaled) softmax, which would move bf16's rounding point of p.
// Not here yet: wgmma, TMA, warp specialisation, persistent blocks.
// No atomics: a launch gives the same bits every time.
//
// Plain C interface: pointers are device pointers, `stream` a
// cudaStream_t; dtype 0 = float32, 1 = bfloat16. `qkv` is a scratch
// buffer [B, N, 3C] in T. Returns the error code of cudaGetLastError()
// after the launches (0 = success).

#include "self_attention_rows.cuh"

namespace sa_eval {

template <typename T>
int launch(const void* x, const void* w, void* qkv, void* out, int batch,
           int n, int c, int heads, int d, float scale, cudaStream_t s) {
  int err = gemm::launch<T>(x, w, qkv, batch * n, 3 * c, c, s);
  if (err != 0) return err;
  sa_rows::Args a{};
  a.qkv = qkv;
  a.out = out;
  a.n = n;
  a.c = c;
  a.d = d;
  a.heads = heads;
  a.scale = scale;
  return sa_rows::launch_attention<T, sa_rows::kEval>(a, batch, s);
}

}  // namespace sa_eval

extern "C" int gdl_sa_eval_launch(const void* x, const void* w, void* qkv,
                                  void* out, int batch, int n, int c,
                                  int heads, int d, float scale, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return sa_eval::launch<float>(x, w, qkv, out, batch, n, c, heads, d,
                                  scale, s);
  if (dtype == 1)
    return sa_eval::launch<__nv_bfloat16>(x, w, qkv, out, batch, n, c, heads,
                                          d, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
