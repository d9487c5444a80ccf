// Fused transformer MLP (fc1 + exact GELU + fc2) forward for Hopper.
//
// gdl_mlp_fused_launch replaces gdl_tpu/ops/mlp.py::mlp_fused (kernel body
// _mlp_kernel). On x [M, C], with the weights in nn.Linear layout
// (w1 [hidden, C], w2 [C, hidden]):
//
//   h = x . w1^T + b1   (f32 accumulate, bias added in f32) -> round to T
//   g = gelu(h)         (f32, erf by Abramowitz & Stegun 7.1.26) -> T
//   o = g . w2^T + b2   (f32 accumulate, bias added in f32) -> round to T
//
// T is float or bfloat16; the rounding points are the TPU kernel's. The
// [M, hidden] intermediates h and g never reach device memory. Forward
// only: the backward recomputes them with plain ops, as gdl_tpu's does.
//
// Design (a first, simple one). A 256-thread block owns BM rows of x and
// all C output columns, whose f32 sums it keeps in registers (BM * C / 256
// a thread: 128 at most, which is what caps C at 1024 with BM = 32). It
// walks the hidden axis in chunks of 64: the chunk of h is a [BM, 64]
// product over C with x and w1 streamed through shared memory 32 columns
// at a time (x is read again for every chunk, from L2); bias, rounding,
// GELU and rounding leave g [BM, 64] in shared memory; then 16 hidden
// columns of w2 at a time are staged and o += g . w2^T. Both products run
// on the CUDA cores in f32 FMA. What bounds it on the H100: the
// 4 * M * C * hidden operations at the SIMT f32 rate; each block re-reads
// both weight matrices from L2 (M / BM times over in all), so small M per
// weight byte is the expensive corner. One block of 8 warps fits an SM
// (registers), so loads and FMAs overlap little. Tensor-core products,
// TMA and double buffering are later work.
//
// expf is the accurate one (not __expf): with it the erf above is within
// 1.5e-7 of the exact one, as on the TPU.
//
// Plain C interface (no PyTorch headers), loaded with ctypes from
// gdl_tpu_torch/kernels/__init__.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHC = 64;   // hidden columns per chunk
constexpr int kKC = 32;   // C columns of x and w1 staged per step
constexpr int kHS = 16;   // hidden columns of w2 staged per step

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

template <int BM, int NJ>
struct MlpSmem {
  static constexpr int kLdK = kKC + 1;
  static constexpr int kLdG = kHC + 1;
  static constexpr int kLdC = 64 * NJ + 1;
  // xs [BM][kLdK], w1s [kHC][kLdK], gs [BM][kLdG], w2s [kHS][kLdC]
  static constexpr int kFloats =
      BM * kLdK + kHC * kLdK + BM * kLdG + kHS * kLdC;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

// NJ = ceil(C / 64) output columns per thread; BM rows per block
template <typename T, int BM, int NJ>
__global__ void __launch_bounds__(kThreads)
mlp_kernel(const T* __restrict__ x, const T* __restrict__ w1,
           const T* __restrict__ b1, const T* __restrict__ w2,
           const T* __restrict__ b2, T* __restrict__ o, int m, int c,
           int hidden) {
  using S = MlpSmem<BM, NJ>;
  constexpr int RA = BM / 16;  // fc1: rows ty + 16a, columns tx + 16j, j < 4
  constexpr int RM = BM / 4;   // fc2: rows rg * RM + a, columns tc + 64j
  extern __shared__ float smem[];
  float* xs = smem;
  float* w1s = xs + BM * S::kLdK;
  float* gs = w1s + kHC * S::kLdK;
  float* w2s = gs + BM * S::kLdG;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int tc = tid % 64, rg = tid / 64;
  const int row0 = blockIdx.x * BM;

  float oacc[RM][NJ];
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) oacc[a][j] = 0.f;

  for (int h0 = 0; h0 < hidden; h0 += kHC) {
    // ---- h chunk = x tile . w1[h0 : h0 + 64]^T, f32 accumulate ----------
    float hacc[RA][4];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) hacc[a][j] = 0.f;
    for (int k0 = 0; k0 < c; k0 += kKC) {
      for (int e = tid; e < BM * kKC; e += kThreads) {
        const int r = e / kKC, kk = e % kKC;
        xs[r * S::kLdK + kk] =
            (row0 + r < m && k0 + kk < c)
                ? Num<T>::load(x + static_cast<size_t>(row0 + r) * c + k0 + kk)
                : 0.f;
      }
      for (int e = tid; e < kHC * kKC; e += kThreads) {
        const int hh = e / kKC, kk = e % kKC;
        w1s[hh * S::kLdK + kk] =
            (h0 + hh < hidden && k0 + kk < c)
                ? Num<T>::load(w1 + static_cast<size_t>(h0 + hh) * c + k0 + kk)
                : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) {
        float xv[RA], wv[4];
#pragma unroll
        for (int a = 0; a < RA; ++a) xv[a] = xs[(ty + 16 * a) * S::kLdK + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = w1s[(tx + 16 * j) * S::kLdK + kk];
#pragma unroll
        for (int a = 0; a < RA; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            hacc[a][j] = fmaf(xv[a], wv[j], hacc[a][j]);
      }
      __syncthreads();  // xs and w1s are overwritten by the next step
    }
    // ---- + b1 (f32) -> T -> gelu (f32) -> T, into gs ---------------------
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int hh = tx + 16 * j;
        float g = 0.f;
        if (h0 + hh < hidden) {
          const float h =
              Num<T>::round(hacc[a][j] + Num<T>::load(b1 + h0 + hh));
          g = Num<T>::round(gelu_as(h));
        }
        gs[(ty + 16 * a) * S::kLdG + hh] = g;
      }
    // (the first barrier of the loop below orders gs before its reads)

    // ---- o += g chunk . w2[:, h0 : h0 + 64]^T, f32 accumulate ------------
    for (int hs = 0; hs < kHC; hs += kHS) {
      for (int e = tid; e < kHS * 64 * NJ; e += kThreads) {
        const int col = e / kHS, hh = e % kHS;
        w2s[hh * S::kLdC + col] =
            (col < c && h0 + hs + hh < hidden)
                ? Num<T>::load(w2 + static_cast<size_t>(col) * hidden + h0 +
                               hs + hh)
                : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int hh = 0; hh < kHS; ++hh) {
        float gv[RM], wv[NJ];
#pragma unroll
        for (int a = 0; a < RM; ++a)
          gv[a] = gs[(rg * RM + a) * S::kLdG + hs + hh];
#pragma unroll
        for (int j = 0; j < NJ; ++j) wv[j] = w2s[hh * S::kLdC + tc + 64 * j];
#pragma unroll
        for (int a = 0; a < RM; ++a)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            oacc[a][j] = fmaf(gv[a], wv[j], oacc[a][j]);
      }
      __syncthreads();  // w2s, then gs, are overwritten
    }
  }

  // ---- + b2 (f32) -> T ---------------------------------------------------
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = tc + 64 * j;
    if (col >= c) continue;
    const float bias = Num<T>::load(b2 + col);
#pragma unroll
    for (int a = 0; a < RM; ++a) {
      const int r = row0 + rg * RM + a;
      if (r < m)
        o[static_cast<size_t>(r) * c + col] = Num<T>::store(oacc[a][j] + bias);
    }
  }
}

template <typename T, int BM, int NJ>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, void* o, int m, int c, int hidden,
           cudaStream_t stream) {
  constexpr size_t smem = MlpSmem<BM, NJ>::kBytes;
  // above 48 KB a block's shared memory has to be granted explicitly
  static const cudaError_t attr = cudaFuncSetAttribute(
      mlp_kernel<T, BM, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const unsigned grid = static_cast<unsigned>((m + BM - 1) / BM);
  mlp_kernel<T, BM, NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(o), m, c, hidden);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* w1, const void* b1, const void* w2,
             const void* b2, void* o, int m, int c, int hidden,
             cudaStream_t s) {
  // BM * 64 NJ / 256 sums a thread: 32, 64, 128, 128
  if (c <= 128)
    return launch<T, 64, 2>(x, w1, b1, w2, b2, o, m, c, hidden, s);
  if (c <= 256)
    return launch<T, 64, 4>(x, w1, b1, w2, b2, o, m, c, hidden, s);
  if (c <= 512)
    return launch<T, 64, 8>(x, w1, b1, w2, b2, o, m, c, hidden, s);
  return launch<T, 32, 16>(x, w1, b1, w2, b2, o, m, c, hidden, s);
}

}  // namespace

// x [m, c], w1 [hidden, c], b1 [hidden], w2 [c, hidden], b2 [c] in T
// (dtype 0: float32, 1: bfloat16); writes o [m, c] in T. c <= 1024.
// Returns a cudaError_t (0 on success).
extern "C" int gdl_mlp_fused_launch(const void* x, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, void* o, int m, int c,
                                    int hidden, int dtype, void* stream) {
  if (m < 1 || c < 1 || c > 1024 || hidden < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, w1, b1, w2, b2, o, m, c, hidden, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w1, b1, w2, b2, o, m, c, hidden, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
