// Transformer MLP (fc1 + exact GELU + fc2) forward for Hopper: kernel #15.
//
// gdl_mlp_fused_launch replaces gdl_tpu/ops/mlp.py::mlp_fused (kernel body
// _mlp_kernel, pallas_call at :136). On x [M, C], with the weights in
// nn.Linear layout (w1 [hidden, C], w2 [C, hidden]):
//
//   h = x . w1^T + b1   (f32 accumulate, bias added in f32) -> round to T
//   g = gelu(h)         (f32, erf by Abramowitz & Stegun 7.1.26) -> T
//   o = g . w2^T + b2   (f32 accumulate, bias added in f32) -> round to T
//
// T is float or bfloat16; the rounding points are the TPU kernel's.
// Forward only: the backward recomputes h and g with plain ops, as
// gdl_tpu's does.
//
// What bounds it on the H100. 4 M C hidden operations against
// (2 M C + 2 C hidden) elements moved once: at the Swin-B shapes
// (hidden = 4C, C = 128 .. 1024) thousands of operations a byte, far on
// the operations side in both dtypes (989 TFLOP/s bf16 on the tensor
// cores, 67 TFLOP/s f32 on SIMT FMA).
//
// Design: two launches of the shared block-tile GEMM (gemm_tile.cuh) on
// the caller's stream, each with an epilogue of its own:
//   fc1: g [M, hidden] = round_T(gelu(round_T(x . w1^T + b1)))   K = C
//   fc2: o [M, C]      = round_T(g . w2^T + b2)                  K = hidden
// bf16 runs on the tensor cores (mma.sync), f32 on the register-blocked
// FMA tile (no TF32). g goes through device memory in T, which is where
// the TPU kernel rounds it: a tile that kept all C output columns of a
// row block on the chip (what a single fused launch needs, as the TPU
// keeps them in VMEM) would hold 128 x 1024 f32 sums at C = 1024, twice an
// SM's register file. The round trip costs 2 M hidden elements of
// traffic a call, small beside the products at these shapes (it is not
// counted in the function's bound). In f32, where the 128-row grid of a
// product would end in a part-empty wave (fc2 at stage 2), that product
// takes the 64-row tile, of which an SM holds two (gemm::row_tile). K is
// never split: every output is one thread's sum in a fixed order, so a
// call gives the same bits every time.
//
// expf is the accurate one (not __expf): with it the erf above is within
// 1.5e-7 of the exact one, as on the TPU.
//
// Plain C interface (no PyTorch headers), loaded with ctypes from
// gdl_tpu_torch/kernels/__init__.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_tile.cuh"

namespace mlp {

template <typename T>
struct Num;

template <>
struct Num<float> {
  __device__ static float f32(float v) { return v; }
  __device__ static float round(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  __device__ static float f32(__nv_bfloat16 v) { return __bfloat162float(v); }
  // round-to-nearest-even, as XLA's and PyTorch's bf16 casts
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// Abramowitz & Stegun 7.1.26, max abs error 1.5e-7
__device__ __forceinline__ float erf_as(float x) {
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float r = 1.0f - poly * expf(-ax * ax);
  return x < 0.f ? -r : (x > 0.f ? r : 0.f);
}

__device__ __forceinline__ float gelu_as(float x) {
  return x * 0.5f * (1.0f + erf_as(x * 0.70710678118654752440f));
}

// fc1's epilogue: gelu(round_T(v + b1[col])); the store rounds g to T
template <typename T>
struct Fc1Gelu {
  const T* bias;
  __device__ float operator()(float v, int col) const {
    return gelu_as(Num<T>::round(v + Num<T>::f32(bias[col])));
  }
};

// fc2's epilogue: v + b2[col]; the store rounds o to T
template <typename T>
struct Fc2Bias {
  const T* bias;
  __device__ float operator()(float v, int col) const {
    return v + Num<T>::f32(bias[col]);
  }
};

// c [m, n] = round_T(epi(a [m, k] . b [n, k]^T)) on the row tile that
// gemm::row_tile picks
template <typename T, typename Epi>
int product(const void* a, const void* b, void* c, int m, int n, int k,
            Epi epi, cudaStream_t s) {
  int bm = 128;
  const int err = gemm::row_tile<T>(m, n, &bm);
  if (err != 0) return err;
  if (bm == 64) return gemm::launch<T, 64>(a, b, c, m, n, k, s, epi);
  return gemm::launch<T, 128>(a, b, c, m, n, k, s, epi);
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, void* g, void* o, int m, int c, int hidden,
           cudaStream_t s) {
  const int err = product<T>(x, w1, g, m, hidden, c,
                             Fc1Gelu<T>{static_cast<const T*>(b1)}, s);
  if (err != 0) return err;
  return product<T>(g, w2, o, m, c, hidden,
                    Fc2Bias<T>{static_cast<const T*>(b2)}, s);
}

}  // namespace mlp

// x [m, c], w1 [hidden, c], b1 [hidden], w2 [c, hidden], b2 [c] in T
// (dtype 0: float32, 1: bfloat16); g [m, hidden] in T is the caller's
// workspace for gelu(fc1); writes o [m, c] in T. Returns a cudaError_t
// (0 on success).
extern "C" int gdl_mlp_fused_launch(const void* x, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, void* g, void* o, int m,
                                    int c, int hidden, int dtype,
                                    void* stream) {
  if (m < 1 || c < 1 || c > 1024 || hidden < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return mlp::launch<float>(x, w1, b1, w2, b2, g, o, m, c, hidden, s);
  if (dtype == 1)
    return mlp::launch<__nv_bfloat16>(x, w1, b1, w2, b2, g, o, m, c, hidden,
                                      s);
  return static_cast<int>(cudaErrorInvalidValue);
}
