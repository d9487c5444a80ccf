// The qkv projection of kernels #1 (window_attention_eval.cu) and #2
// (window_attention_train.cu) on the shared GEMM tile (gemm_tile.cuh):
//
//   qkv [tokens, 3C] = round_T(round_T(x . W^T) + b)
//
// over all Bw * N tokens of a call at once: x [tokens, C] and W [3C, C]
// (nn.Linear layout) both along K, the f32 sums on the tensor cores in
// bf16 (mma.sync) and on the register-blocked FMA tile in f32 (no TF32).
// This is the TPU kernels' first step (_wa_xw_t_savep_kernel and
// _wa_xw_t_eval_kernel, gdl_tpu/ops/window_attention.py:1034-1039): the
// product is cast to T, then the bias is added in T. The epilogue
// wa2::ProjBias does the cast and the add in f32, as a bf16 add of
// PyTorch's (the plain version) computes it; the tile's RoundT store then
// rounds the sum to T. mlp::Fc2Bias, which adds its bias before any
// rounding, is another function.
//
// The epilogue's namespace, wa2, is in the instantiation's symbol, so
// that profile_step files the projection apart from #10's and #13's
// (the identity epilogue) and #15's (namespace mlp).

#pragma once

#include "gemm_tile.cuh"
#include "window_attention_fwd.cuh"

namespace wa2 {
// internal to each library that includes it (see gemm_tile.cuh)
namespace {

// epi(v, col) = round_T(v) + b[col], in f32; the store rounds it to T
template <typename T>
struct ProjBias {
  const T* bias;
  __device__ float operator()(float v, int col) const {
    return Num<T>::round(v) + Num<T>::load(bias + col);
  }
};

// qkv [tokens, 3c] = round_T(round_T(x [tokens, c] . w [3c, c]^T) + b) in
// T, on the row tile that gemm::row_tile picks. Returns a cudaError_t.
template <typename T>
int project(const void* x, const void* w, const void* b, void* qkv,
            int tokens, int c, cudaStream_t s) {
  int bm = 128;
  const int err = gemm::row_tile<T>(tokens, 3 * c, &bm);
  if (err != 0) return err;
  const ProjBias<T> epi{static_cast<const T*>(b)};
  if (bm == 64)
    return gemm::launch<T, 64>(x, w, qkv, tokens, 3 * c, c, s, epi);
  return gemm::launch<T, 128>(x, w, qkv, tokens, 3 * c, c, s, epi);
}

}  // namespace
}  // namespace wa2
