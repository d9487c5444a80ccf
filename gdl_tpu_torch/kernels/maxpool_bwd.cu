// Backward of MaxPool2d(kernel 3, stride 2, padding 1) on channel-last
// maps, for the ResNet stems on Hopper.
//
// Replaces gdl_tpu/ops/maxpool.py::max_pool_3x3_s2_pallas's backward
// (Pallas body _mp_bwd_kernel). What it computes: each cotangent
// g[n, oi, oj, c] goes to the FIRST maximum of its 3x3 window of x in
// row-major order, ties included; cells off the grid count as -inf; the
// compares run in f32 (exact for bf16 values).
//
// Bound: bytes. x is read once, g once, dx written once, and there is
// next to no arithmetic, so the least time is (|x| + |g| + |dx|) over the
// memory rate.
//
// Design. The TPU kernel is shaped by its compiler (even/odd phase split,
// lane-packed interleave, one image per grid step); none of that is
// carried over. A block owns a tile of kTH x kTW windows of one image
// and up to kCC channels, channels innermost, each thread taking 16
// bytes of them, so neighbouring threads read neighbouring addresses.
//   Phase 1: for every window of the tile, and the one further row and
//     column of windows that reach into the tile's input cells, find the
//     offset k = 3*di + dj of the window's first maximum (9 reads of x,
//     which neighbouring windows share through L1) and keep it as one
//     byte per channel in shared memory.
//   Phase 2: every input cell (i, j) of the tile lies in at most two
//     windows by row (oi with 2*oi-1 <= i <= 2*oi+1) and two by column.
//     It looks those up in shared memory and adds g of each window whose
//     first maximum it is.
// dx is written once, the sum is taken in f32 in one fixed order (window
// offset (di, dj) ascending, the plain version's order) and rounded once,
// and there are no atomics, so two runs give equal bits. Odd H or W need
// only the bounds tests.
//
// Plain C interface (no PyTorch headers), loaded with ctypes from
// gdl_tpu_torch/kernels/__init__.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTH = 4;         // windows per tile, rows
constexpr int kTW = 8;         // windows per tile, columns
constexpr int kCC = 64;        // channels per block at most
constexpr int kThreads = 256;
constexpr int kNone = 9;       // no cell of the window takes its g
constexpr int kWin = (kTH + 1) * (kTW + 1);

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[V]) {
  Vec<T, V> t = *reinterpret_cast<const Vec<T, V>*>(p);
#pragma unroll
  for (int u = 0; u < V; ++u) out[u] = to_float(t.v[u]);
}

// The tile a block works on: image n, windows [oi0, oi0 + kTH) x
// [oj0, oj0 + kTW), channels [c0, c0 + cw).
struct Tile {
  long long n;
  int oi0, oj0, c0, cw;
};

__device__ __forceinline__ Tile tile_of(long long block, int tiles_h,
                                        int tiles_w, int chunks, int c) {
  Tile t;
  const int chunk = static_cast<int>(block % chunks);
  block /= chunks;
  t.oj0 = static_cast<int>(block % tiles_w) * kTW;
  block /= tiles_w;
  t.oi0 = static_cast<int>(block % tiles_h) * kTH;
  t.n = block / tiles_h;
  t.c0 = chunk * kCC;
  t.cw = min(kCC, c - t.c0);
  return t;
}

// Phase 1: sidx[(wi * (kTW + 1) + wj) * kCC + ch] = offset of the first
// maximum of window (oi0 + wi, oj0 + wj) in channel c0 + ch, or kNone
// for a window off the output grid or with a NaN in it.
template <typename T, int V>
__device__ __forceinline__ void first_max_phase(const T* __restrict__ xn,
                                                uint8_t* sidx, const Tile& t,
                                                int h, int w, int c, int ho,
                                                int wo, int tid) {
  const int cv = t.cw / V;
  for (int item = tid; item < kWin * cv; item += kThreads) {
    const int ch = (item % cv) * V;
    const int win = item / cv;
    const int oi = t.oi0 + win / (kTW + 1), oj = t.oj0 + win % (kTW + 1);
    uint8_t best_k[V];
    if (oi >= ho || oj >= wo) {
#pragma unroll
      for (int u = 0; u < V; ++u) best_k[u] = kNone;
    } else {
      float best[V];
      bool nan[V];
#pragma unroll
      for (int u = 0; u < V; ++u) {
        best[u] = -CUDART_INF_F;
        best_k[u] = 0;
        nan[u] = false;
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int ii = 2 * oi - 1 + k / 3, jj = 2 * oj - 1 + k % 3;
        if (ii < 0 || ii >= h || jj < 0 || jj >= w) continue;  // -inf
        float v[V];
        load_vec<T, V>(
            xn + (static_cast<long long>(ii) * w + jj) * c + t.c0 + ch, v);
#pragma unroll
        for (int u = 0; u < V; ++u) {
          if (v[u] > best[u]) {  // strictly: the first maximum stays
            best[u] = v[u];
            best_k[u] = k;
          }
          nan[u] = nan[u] || (v[u] != v[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < V; ++u)
        if (nan[u]) best_k[u] = kNone;
    }
#pragma unroll
    for (int u = 0; u < V; ++u) sidx[win * kCC + ch + u] = best_k[u];
  }
}

// Phase 2: dx of the tile's input cells, rows [2*oi0, 2*oi0 + 2*kTH) and
// columns [2*oj0, 2*oj0 + 2*kTW).
template <typename T, int V>
__device__ __forceinline__ void gather_phase(const T* __restrict__ gn,
                                             T* __restrict__ dxn,
                                             const uint8_t* sidx,
                                             const Tile& t, int h, int w,
                                             int c, int wo, int tid) {
  const int cv = t.cw / V;
  for (int item = tid; item < 4 * kTH * kTW * cv; item += kThreads) {
    const int ch = (item % cv) * V;
    const int cell = item / cv;
    const int li = cell / (2 * kTW), lj = cell % (2 * kTW);
    const int i = 2 * t.oi0 + li, j = 2 * t.oj0 + lj;
    if (i >= h || j >= w) continue;
    // the windows that hold row i, by ascending offset di = i - 2*oi + 1:
    // an even row is the middle (di 1) of window i/2; an odd row is the
    // top (di 0) of window (i+1)/2 and the bottom (di 2) of window
    // (i-1)/2. Columns alike. A window past the grid holds kNone.
    int wis[2], wjs[2], nr = 0, nc = 0;
    if (li & 1) {
      wis[nr++] = (li + 1) / 2;
      wis[nr++] = (li - 1) / 2;
    } else {
      wis[nr++] = li / 2;
    }
    if (lj & 1) {
      wjs[nc++] = (lj + 1) / 2;
      wjs[nc++] = (lj - 1) / 2;
    } else {
      wjs[nc++] = lj / 2;
    }
    float acc[V];
#pragma unroll
    for (int u = 0; u < V; ++u) acc[u] = 0.f;
    for (int a = 0; a < nr; ++a) {
      for (int b = 0; b < nc; ++b) {
        const int wi = wis[a], wj = wjs[b];
        const int k0 = (li - 2 * wi + 1) * 3 + (lj - 2 * wj + 1);
        const uint8_t* idx = sidx + (wi * (kTW + 1) + wj) * kCC + ch;
        bool take[V], any = false;
#pragma unroll
        for (int u = 0; u < V; ++u) {
          take[u] = idx[u] == k0;
          any = any || take[u];
        }
        if (!any) continue;
        float gv[V];
        load_vec<T, V>(gn + (static_cast<long long>(t.oi0 + wi) * wo +
                             t.oj0 + wj) * c + t.c0 + ch, gv);
#pragma unroll
        for (int u = 0; u < V; ++u)
          if (take[u]) acc[u] += gv[u];
      }
    }
    Vec<T, V> out;
#pragma unroll
    for (int u = 0; u < V; ++u) out.v[u] = from_float<T>(acc[u]);
    *reinterpret_cast<Vec<T, V>*>(
        dxn + (static_cast<long long>(i) * w + j) * c + t.c0 + ch) = out;
  }
}

// x, dx [b, h, w, c]; g [b, ho, wo, c]; one block per tile.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    maxpool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       T* __restrict__ dx, int h, int w, int c, int ho,
                       int wo, int tiles_h, int tiles_w, int chunks) {
  __shared__ uint8_t sidx[kWin * kCC];
  const Tile t = tile_of(blockIdx.x, tiles_h, tiles_w, chunks, c);
  const int tid = threadIdx.x;
  first_max_phase<T, V>(x + t.n * h * w * c, sidx, t, h, w, c, ho, wo, tid);
  __syncthreads();
  gather_phase<T, V>(g + t.n * ho * wo * c, dx + t.n * h * w * c, sidx, t, h,
                     w, c, wo, tid);
}

template <typename T, int V>
int launch(const void* x, const void* g, void* dx, int b, int h, int w, int c,
           cudaStream_t s) {
  const int ho = (h - 1) / 2 + 1, wo = (w - 1) / 2 + 1;
  // the input cells of the tiles [2*oi0, 2*oi0 + 2*kTH) cover rows
  // 0 .. 2*ho - 1 >= h - 1, and the columns alike
  const int tiles_h = (ho + kTH - 1) / kTH, tiles_w = (wo + kTW - 1) / kTW;
  const int chunks = (c + kCC - 1) / kCC;
  const long long blocks =
      static_cast<long long>(b) * tiles_h * tiles_w * chunks;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  maxpool_bwd_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx),
      h, w, c, ho, wo, tiles_h, tiles_w, chunks);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// x, dx [b, h, w, c] and g [b, (h-1)/2+1, (w-1)/2+1, c], dense, in T
// (dtype 0: float32, 1: bfloat16). Threads take 16 bytes of channels each
// where c and the pointers allow it, else one channel. Returns a
// cudaError_t (0 on success).
extern "C" int gdl_maxpool_bwd_launch(const void* x, const void* g, void* dx,
                                      int b, int h, int w, int c, int dtype,
                                      void* stream) {
  if (b < 1 || h < 1 || w < 1 || c < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool al = aligned16(x) && aligned16(g) && aligned16(dx);
  if (dtype == 0) {
    if (al && c % 4 == 0) return launch<float, 4>(x, g, dx, b, h, w, c, s);
    return launch<float, 1>(x, g, dx, b, h, w, c, s);
  }
  if (dtype == 1) {
    if (al && c % 8 == 0)
      return launch<__nv_bfloat16, 8>(x, g, dx, b, h, w, c, s);
    return launch<__nv_bfloat16, 1>(x, g, dx, b, h, w, c, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
