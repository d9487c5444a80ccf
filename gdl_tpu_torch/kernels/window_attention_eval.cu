// Fused window attention, forward only, for Swin inference on Hopper.
//
// Replaces gdl_tpu/ops/window_attention.py::window_attention_pallas_qkv_fused_eval
// (kernel body _wa_xw_t_eval_kernel). Per window w and head h:
//
//   qkv = x[w] . W_h^T (f32 accumulate) -> round to T -> + b_h (in T)
//   q   = q * T(scale)                                   (in T)
//   s   = q . k^T (f32) + bias[h] + mask[w % nW]         (f32)
//   p   = softmax(s) over keys (f32) -> round to T
//   out[w, :, h*d:(h+1)*d] = p . v (f32 accumulate) -> T
//
// T is float or bfloat16; every rounding point above is the TPU kernel's.
// The qkv projection stays inside the kernel: q, k, v and p never reach
// device memory, which is what the TPU kernel was written for.
//
// Design (a first, simple one): one 256-thread block per (window, head).
// x and the head's 3d rows of W stream through shared memory in KC-wide
// chunks of C; each thread holds a 4 x (3*DMAX/16) register tile of the
// projection. q, k, v, then the scores, live in shared memory. All
// products run on the CUDA cores in f32 FMA. What bounds it on the H100:
// the projection's FMAs (Bw*N*3C*C MACs a call, 98% of the work) at the
// SIMT f32 rate, and the H-fold re-read of x from L2 (one block per
// head). Tensor-core products (mma/wgmma), TMA and sharing x across the
// heads of a window are later work.
//
// Plain C interface (no PyTorch headers), loaded with ctypes from
// gdl_tpu_torch/kernels/__init__.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNP = 64;  // max tokens per window (rows padded to 64)
constexpr int kKC = 32;  // C-chunk streamed through shared memory

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
struct Smem {
  static constexpr int kLdX = kKC + 1;
  static constexpr int kLdQ = DMAX + 1;
  static constexpr int kLdP = kNP + 1;
  // phase 1 (projection): xs[kNP][kLdX], ws[3*DMAX][kLdX]
  static constexpr int kProj = (kNP + 3 * DMAX) * kLdX;
  // phase 2: qs, ks, vs [kNP][kLdQ] (aliases phase 1), ps [kNP][kLdP]
  static constexpr int kQkv = 3 * kNP * kLdQ;
  static constexpr int kUnion = kProj > kQkv ? kProj : kQkv;
  static constexpr int kFloats = kUnion + kNP * kLdP;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
wa_eval_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ b, const float* __restrict__ bias,
               const float* __restrict__ mask, T* __restrict__ out, int n,
               int c, int heads, int d, int nw, float scale) {
  using S = Smem<DMAX>;
  constexpr int JT = 3 * DMAX / 16;  // projection columns per thread
  constexpr int DT = DMAX / 16;      // output columns per thread
  extern __shared__ float smem[];
  float* xs = smem;
  float* ws = smem + kNP * S::kLdX;
  float* qs = smem;
  float* ks = qs + kNP * S::kLdQ;
  float* vs = ks + kNP * S::kLdQ;
  float* ps = smem + S::kUnion;

  const int win = blockIdx.x / heads;
  const int head = blockIdx.x % heads;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int d3 = 3 * d;
  const T* xw = x + static_cast<size_t>(win) * n * c;

  // ---- phase 1: qkv = x . W_h^T, f32 accumulate -------------------------
  float acc[4][JT];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < JT; ++j) acc[a][j] = 0.f;

  for (int k0 = 0; k0 < c; k0 += kKC) {
    for (int e = tid; e < kNP * kKC; e += kThreads) {
      const int r = e / kKC, kk = e % kKC;
      xs[r * S::kLdX + kk] =
          (r < n && k0 + kk < c)
              ? Num<T>::load(xw + static_cast<size_t>(r) * c + k0 + kk)
              : 0.f;
    }
    for (int e = tid; e < 3 * DMAX * kKC; e += kThreads) {
      const int col = e / kKC, kk = e % kKC;
      float v = 0.f;
      if (col < d3 && k0 + kk < c) {
        // W rows are ordered [q|k|v][head][d] (nn.Linear layout)
        const int row = (col / d) * c + head * d + col % d;
        v = Num<T>::load(w + static_cast<size_t>(row) * c + k0 + kk);
      }
      ws[col * S::kLdX + kk] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKC; ++kk) {
      float xv[4], wv[JT];
#pragma unroll
      for (int a = 0; a < 4; ++a) xv[a] = xs[(ty + 16 * a) * S::kLdX + kk];
#pragma unroll
      for (int j = 0; j < JT; ++j) wv[j] = ws[(tx + 16 * j) * S::kLdX + kk];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < JT; ++j) acc[a][j] = fmaf(xv[a], wv[j], acc[a][j]);
    }
    __syncthreads();  // phase 2 reuses xs/ws
  }

  // round to T, add the bias in T, scale q in T
  const float scale_t = Num<T>::round(scale);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
#pragma unroll
    for (int j = 0; j < JT; ++j) {
      const int col = tx + 16 * j;
      if (col >= d3) continue;
      const int part = col / d, dd = col % d;
      float v = 0.f;
      if (r < n) {
        v = Num<T>::round(acc[a][j]);
        v = Num<T>::round(v + Num<T>::load(b + part * c + head * d + dd));
        if (part == 0) v = Num<T>::round(v * scale_t);
      }
      float* dst = part == 0 ? qs : (part == 1 ? ks : vs);
      dst[r * S::kLdQ + dd] = v;
    }
  }
  __syncthreads();

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
      for (int a = 0; a < 4; ++a) qv[a] = qs[(ty + 16 * a) * S::kLdQ + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * S::kLdQ + k];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[a][j] = fmaf(qv[a], kv[j], sacc[a][j]);
    }
    const float* bh = bias + static_cast<size_t>(head) * n * n;
    const float* mw =
        mask != nullptr ? mask + static_cast<size_t>(win % nw) * n * n
                        : nullptr;
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
        ps[i * S::kLdP + jj] = s;
      }
    }
  }
  __syncthreads();

  // ---- phase 3: softmax over keys, one warp per row ---------------------
  {
    const int lane = tid % 32;
    for (int i = tid / 32; i < n; i += kThreads / 32) {
      float* row = ps + i * S::kLdP;
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
      if (lane < n) row[lane] = Num<T>::round(e0 / sum);
      if (lane + 32 < n) row[lane + 32] = Num<T>::round(e1 / sum);
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
      for (int a = 0; a < 4; ++a) pv[a] = ps[(ty + 16 * a) * S::kLdP + jj];
#pragma unroll
      for (int j = 0; j < DT; ++j) vv[j] = vs[jj * S::kLdQ + tx + 16 * j];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < DT; ++j) oacc[a][j] = fmaf(pv[a], vv[j], oacc[a][j]);
    }
    T* ow = out + static_cast<size_t>(win) * n * c + head * d;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a;
      if (i >= n) continue;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const int col = tx + 16 * j;
        if (col < d) ow[static_cast<size_t>(i) * c + col] = Num<T>::store(oacc[a][j]);
      }
    }
  }
}

template <typename T, int DMAX>
int launch(const void* x, const void* w, const void* b, const void* bias,
           const void* mask, void* out, int bw, int n, int c, int heads,
           int d, int nw, float scale, cudaStream_t stream) {
  constexpr size_t smem = Smem<DMAX>::kBytes;
  // above 48 KB a block's shared memory has to be granted explicitly;
  // set once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      wa_eval_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const unsigned grid = static_cast<unsigned>(bw) * static_cast<unsigned>(heads);
  wa_eval_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<T*>(out), n, c, heads, d,
      nw, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* w, const void* b, const void* bias,
             const void* mask, void* out, int bw, int n, int c, int heads,
             int d, int nw, float scale, cudaStream_t stream) {
  if (d <= 16)
    return launch<T, 16>(x, w, b, bias, mask, out, bw, n, c, heads, d, nw,
                         scale, stream);
  if (d <= 32)
    return launch<T, 32>(x, w, b, bias, mask, out, bw, n, c, heads, d, nw,
                         scale, stream);
  return launch<T, 64>(x, w, b, bias, mask, out, bw, n, c, heads, d, nw,
                       scale, stream);
}

}  // namespace

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
  if (dtype == 0)
    return dispatch<float>(x, w, b, bias, mask, out, bw, n, c, heads, d, nw,
                           scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, b, bias, mask, out, bw, n, c, heads,
                                   d, nw, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
