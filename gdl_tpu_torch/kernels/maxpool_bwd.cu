// Backward of MaxPool2d(kernel 3, stride 2, padding 1) on channel-last
// maps, for the ResNet stems on Hopper.
//
// Replaces gdl_tpu/ops/maxpool.py::max_pool_3x3_s2_pallas's backward
// (Pallas body _mp_bwd_kernel). What it computes: each cotangent
// g[n, oi, oj, c] goes to the FIRST maximum of its 3x3 window of x in
// row-major order, ties included; cells off the grid count as -inf; a
// window that holds a NaN gives nothing; the compares run in f32 (exact
// for bf16 values).
//
// Bound: bytes. x is read once, g once, dx written once, and there is
// next to no arithmetic, so the least time is (|x| + |g| + |dx|) over the
// memory rate. The first design (a block a tile of 4 x 8 windows and 64
// channels, 9 loads of x a window through L1, then g from device memory,
// no copy in flight while a block computed) reached about half of that
// rate in f32 and a third in bf16.
//
// Design. The TPU kernel is shaped by its compiler (even/odd phase split,
// lane-packed interleave, one image per grid step); none of that is
// carried over. A tile is kTH x kTW = 8 x 8 windows of one image and 128
// bytes of channels (32 in f32, 64 in bf16), so that every dtype moves
// the same bytes a thread: a thread takes 16 bytes of a cell's channels,
// eight threads a cell. A resident grid (one block of 512 threads an SM:
// two stages take 113 KB of shared memory) walks the tiles:
//   Copy: the tile's x with its halo (input rows 2*oi0 - 1 .. 2*oi0 +
//     2*kTH + 1, the columns alike; -inf where they leave the grid) and g
//     of its windows and of the one further row and column of windows
//     that reach into its cells go to a stage by cp.async, issued for
//     tile t+1 before tile t is worked on, so one tile's copies are in
//     flight under the other's work. The halo is 41% of the cells staged
//     (63% with 4 x 8 windows); it comes from L2, where the neighbouring
//     tile, walked at the same time, brought it.
//   First maxima: for every window of the stage, the offset k = 3*di + dj
//     of its first maximum, from shared memory, once: the maximum with
//     NaN passed through, then the first cell equal to it, kNone where it
//     is NaN. bf16 runs on pairs of channels (max.NaN.bf16x2 and a
//     bf16x2 compare into masks), f32 on single ones. The offsets are
//     kept an int a channel in f32, a byte in bf16.
//   Gather: a thread takes the 2 x 2 input cells (2a .. 2a+1, 2b .. 2b+1)
//     of window (a, b) of the tile: they lie in windows (a, b), (a, b+1),
//     (a+1, b) and (a+1, b+1) and no others. It reads those four windows'
//     offsets and g once, sums each cell's share in f32 in window offset
//     order (di, dj) ascending, the plain version's order, rounds once
//     and writes each cell's 16 bytes of dx.
// A tile's instructions set the pace of the first resident design (4 x 8
// windows, three blocks of 256 threads an SM, a bounds test a cell, the
// first maximum tracked a byte at a time): it ran bf16 at a third of the
// memory rate. Hence the -inf halo, the pairs and the 512 threads.
// dx is written once, the sums run in one fixed order and there are no
// atomics, so two runs give equal bits. Where C is no multiple of the
// 16-byte vector or a pointer is not 16-byte aligned, a thread takes one
// channel and the copies are plain loads and stores.
//
// Plain C interface (no PyTorch headers), loaded with ctypes from
// gdl_tpu_torch/kernels/__init__.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTH = 8;             // windows per tile, rows
constexpr int kTW = 8;             // windows per tile, columns
constexpr int kChunkBytes = 128;   // bytes of channels of a tile cell
constexpr int kThreads = 512;
constexpr int kNone = 9;           // no cell of the window takes its g
constexpr int kXR = 2 * kTH + 3;   // staged x rows, with the halo
constexpr int kXC = 2 * kTW + 3;   // staged x columns
constexpr int kWR = kTH + 1;       // windows whose offsets a tile needs
constexpr int kWC = kTW + 1;
constexpr int kXCells = kXR * kXC;
constexpr int kWins = kWR * kWC;

// T's layout in a tile: channels a cell (kCC), threads a cell (kLanes),
// bytes of a stage (x cells, then g cells) and of the whole block; the
// offsets of the windows' first maxima are kept one int a channel in f32
// (the gather reads them without unpacking) and one byte in bf16 (a
// thread's eight in one 8-byte read)
template <typename T, int V>
struct Cfg {
  using K = std::conditional_t<sizeof(T) == 4, int32_t, uint8_t>;
  static constexpr int kCC = kChunkBytes / static_cast<int>(sizeof(T));
  static constexpr int kLanes = kCC / V;
  static constexpr int kStage = (kXCells + kWins) * kChunkBytes;
  static constexpr int kSmem =
      2 * kStage + kWins * kCC * static_cast<int>(sizeof(K));
};

// bf16 pairs, elementwise on a 32-bit word of two bf16 values
template <typename T, int V>
constexpr bool kPairs = sizeof(T) == 2 && V % 2 == 0;

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

// max with NaN passed through, in f32 and on two bf16 values
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ uint32_t max_nan_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// 0xffff in each half where the two bf16 values are equal, else 0
__device__ __forceinline__ uint32_t eq_mask_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("set.eq.u32.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename K, int V>
struct alignas(sizeof(K) * V) Idx {
  K k[V];
};

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[V]) {
  const Vec<T, V> t = *reinterpret_cast<const Vec<T, V>*>(p);
#pragma unroll
  for (int u = 0; u < V; ++u) out[u] = to_float(t.v[u]);
}

// one thread's piece of a cell: 16 bytes by cp.async, or one element
template <typename T, int V>
__device__ __forceinline__ void copy_piece(T* dst, const T* src) {
  if constexpr (V * sizeof(T) == 16) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  } else {
    *dst = *src;
  }
}

// one thread's piece of a cell off the grid: -inf
template <typename T, int V>
__device__ __forceinline__ void fill_neg_inf(T* dst) {
  Vec<T, V> v;
#pragma unroll
  for (int u = 0; u < V; ++u) v.v[u] = from_float<T>(-CUDART_INF_F);
  *reinterpret_cast<Vec<T, V>*>(dst) = v;
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest group of copies have landed
__device__ __forceinline__ void wait_older_copies() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The tile a block works on: image n, windows [oi0, oi0 + kTH) x
// [oj0, oj0 + kTW), channels [c0, c0 + cw).
struct Tile {
  int n, oi0, oj0, c0, cw;
};

struct Dims {
  int h, w, c, ho, wo, tiles_h, tiles_w, chunks;
};

template <int CC>
__device__ __forceinline__ Tile tile_of(int t, const Dims& d) {
  Tile r;
  const int chunk = t % d.chunks;
  t /= d.chunks;
  r.oj0 = t % d.tiles_w * kTW;
  t /= d.tiles_w;
  r.oi0 = t % d.tiles_h * kTH;
  r.n = t / d.tiles_h;
  r.c0 = chunk * CC;
  r.cw = min(CC, d.c - r.c0);
  return r;
}

// Copy: stage[cell * kCC + ch] = x of staged cell `cell` (row-major over
// kXR x kXC), -inf for a cell off the grid; then g of window `win`
// (row-major over kWR x kWC) at cell kXCells + win for windows on the
// output grid (the others are never read). A thread keeps its channels:
// kThreads is a multiple of kLanes.
template <typename T, int V>
__device__ __forceinline__ void issue_tile(const T* __restrict__ x,
                                           const T* __restrict__ g, T* stage,
                                           const Tile& t, const Dims& d,
                                           int tid) {
  using C = Cfg<T, V>;
  const int ch = (tid % C::kLanes) * V;
  if (ch >= t.cw) return;
  // element offsets of the staged cell (0, 0) and of window (0, 0), which
  // may lie before the image; cells are added as rows and columns
  const long long xrow = static_cast<long long>(d.w) * d.c;
  const long long grow = static_cast<long long>(d.wo) * d.c;
  const int i0 = 2 * t.oi0 - 1, j0 = 2 * t.oj0 - 1;
  const long long x0 = (static_cast<long long>(t.n) * d.h + i0) * xrow +
                       static_cast<long long>(j0) * d.c + t.c0 + ch;
  const long long g0 = (static_cast<long long>(t.n) * d.ho + t.oi0) * grow +
                       static_cast<long long>(t.oj0) * d.c + t.c0 + ch;
  T* dst = stage + ch;
  for (int cell = tid / C::kLanes; cell < kXCells + kWins;
       cell += kThreads / C::kLanes) {
    if (cell < kXCells) {
      const int r = cell / kXC, q = cell % kXC;
      if (static_cast<unsigned>(i0 + r) < static_cast<unsigned>(d.h) &&
          static_cast<unsigned>(j0 + q) < static_cast<unsigned>(d.w)) {
        copy_piece<T, V>(dst + cell * C::kCC,
                         x + (x0 + r * xrow + static_cast<long long>(q) * d.c));
      } else {
        fill_neg_inf<T, V>(dst + cell * C::kCC);
      }
    } else {
      const int win = cell - kXCells;
      const int r = win / kWC, q = win % kWC;
      if (t.oi0 + r < d.ho && t.oj0 + q < d.wo)
        copy_piece<T, V>(dst + cell * C::kCC,
                         g + (g0 + r * grow + static_cast<long long>(q) * d.c));
    }
  }
}

// The offset k = 3*di + dj of the first cell of a window equal to its
// maximum, kNone where the maximum is NaN (a window with a NaN gives
// nothing); cells off the grid hold -inf. v[k] holds the window's cell k.
// The maximum passes NaN through and is one of the values, so "first
// equal" is the plain version's rule, ties and signed zeros included.
template <typename K, int V>
__device__ __forceinline__ void first_max_f32(const float (&v)[9][V],
                                              Idx<K, V>& out) {
#pragma unroll
  for (int u = 0; u < V; ++u) {
    float m = v[0][u];
#pragma unroll
    for (int k = 1; k < 9; ++k) m = max_nan(m, v[k][u]);
    int best = kNone;
#pragma unroll
    for (int k = 8; k >= 0; --k) best = v[k][u] == m ? k : best;
    out.k[u] = static_cast<K>(best);
  }
}

// the same on bf16 pairs: v[k][p] holds channels 2p, 2p+1 of cell k
template <int V>
__device__ __forceinline__ void first_max_bf16x2(const uint32_t (&v)[9][V / 2],
                                                 Idx<uint8_t, V>& out) {
  static_assert(V % 4 == 0, "whole words of offsets");
  uint32_t best[V / 2];
#pragma unroll
  for (int p = 0; p < V / 2; ++p) {
    uint32_t m = v[0][p];
#pragma unroll
    for (int k = 1; k < 9; ++k) m = max_nan_bf16x2(m, v[k][p]);
    uint32_t b = kNone * 0x10001u;
#pragma unroll
    for (int k = 8; k >= 0; --k) {
      const uint32_t eq = eq_mask_bf16x2(v[k][p], m);
      b = (eq & (k * 0x10001u)) | (~eq & b);
    }
    best[p] = b;  // the offsets of channels 2p and 2p+1 in bytes 0 and 2
  }
  uint32_t packed[V / 4];
#pragma unroll
  for (int q = 0; q < V / 4; ++q)
    packed[q] = __byte_perm(best[2 * q], best[2 * q + 1], 0x6420);
  out = *reinterpret_cast<const Idx<uint8_t, V>*>(packed);
}

// First maxima: sidx[win * kCC + ch] = the offset of the first maximum of
// window win (row-major over kWR x kWC) in channel c0 + ch, or kNone for a
// window off the output grid or with a NaN in it.
template <typename T, int V>
__device__ __forceinline__ void first_max(const T* stage,
                                          typename Cfg<T, V>::K* sidx,
                                          const Tile& t, const Dims& d,
                                          int tid) {
  using C = Cfg<T, V>;
  using K = typename C::K;
  const int ch = (tid % C::kLanes) * V;
  if (ch >= t.cw) return;
  for (int win = tid / C::kLanes; win < kWins; win += kThreads / C::kLanes) {
    const int wi = win / kWC, wj = win % kWC;
    const T* cell0 = stage + ((2 * wi) * kXC + 2 * wj) * C::kCC + ch;
    Idx<K, V> best;
    if constexpr (kPairs<T, V>) {
      uint32_t v[9][V / 2];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const Vec<uint32_t, V / 2> cell = *reinterpret_cast<
            const Vec<uint32_t, V / 2>*>(cell0 + ((k / 3) * kXC + k % 3) * C::kCC);
#pragma unroll
        for (int p = 0; p < V / 2; ++p) v[k][p] = cell.v[p];
      }
      first_max_bf16x2<V>(v, best);
    } else {
      float v[9][V];
#pragma unroll
      for (int k = 0; k < 9; ++k)
        load_vec<T, V>(cell0 + ((k / 3) * kXC + k % 3) * C::kCC, v[k]);
      first_max_f32<K, V>(v, best);
    }
    if (t.oi0 + wi >= d.ho || t.oj0 + wj >= d.wo) {
#pragma unroll
      for (int u = 0; u < V; ++u) best.k[u] = kNone;
    }
    *reinterpret_cast<Idx<K, V>*>(sidx + win * C::kCC + ch) = best;
  }
}

// acc[u] += g[u] where the window's offset in channel u is k
template <int V>
__device__ __forceinline__ void take(float (&acc)[V], const int (&kw)[V],
                                     int k, const float (&gv)[V]) {
#pragma unroll
  for (int u = 0; u < V; ++u)
    if (kw[u] == k) acc[u] += gv[u];
}

// dx of the quad's cell (r, s), at element offset `off` from dxq
template <typename T, int V>
__device__ __forceinline__ void store_cell(T* __restrict__ dxq,
                                           const float (&acc)[V], bool in,
                                           long long off) {
  if (!in) return;
  Vec<T, V> out;
#pragma unroll
  for (int u = 0; u < V; ++u) out.v[u] = from_float<T>(acc[u]);
  *reinterpret_cast<Vec<T, V>*>(dxq + off) = out;
}

// a window's offsets (one int a channel) and g (in f32) from the stage
template <typename T, int V>
__device__ __forceinline__ void window_of(const typename Cfg<T, V>::K* sidx,
                                          const T* gs, int win, int (&kw)[V],
                                          float (&gv)[V]) {
  using C = Cfg<T, V>;
  const Idx<typename C::K, V> idx =
      *reinterpret_cast<const Idx<typename C::K, V>*>(sidx + win * C::kCC);
#pragma unroll
  for (int u = 0; u < V; ++u) kw[u] = idx.k[u];
  load_vec<T, V>(gs + win * C::kCC, gv);
}

// Gather: dx of the tile's input cells, rows [2*oi0, 2*oi0 + 2*kTH) and
// columns [2*oj0, 2*oj0 + 2*kTW), a 2 x 2 quad a thread and 16 bytes.
template <typename T, int V>
__device__ __forceinline__ void gather(const T* stage,
                                       const typename Cfg<T, V>::K* sidx,
                                       T* __restrict__ dx, const Tile& t,
                                       const Dims& d, int tid) {
  using C = Cfg<T, V>;
  const int ch = (tid % C::kLanes) * V;
  if (ch >= t.cw) return;
  const long long xrow = static_cast<long long>(d.w) * d.c;
  T* dxn = dx + (static_cast<long long>(t.n) * d.h * xrow + t.c0 + ch);
  const T* gs = stage + kXCells * C::kCC + ch;
  sidx += ch;
  for (int quad = tid / C::kLanes; quad < kTH * kTW;
       quad += kThreads / C::kLanes) {
    const int a = quad / kTW, b = quad % kTW;
    // the four windows, by their place in the stage: (a, b), (a, b+1),
    // (a+1, b), (a+1, b+1)
    const int w00 = a * kWC + b;
    int k00[V], k01[V], k10[V], k11[V];
    float g00[V], g01[V], g10[V], g11[V];
    window_of<T, V>(sidx, gs, w00, k00, g00);
    window_of<T, V>(sidx, gs, w00 + 1, k01, g01);
    window_of<T, V>(sidx, gs, w00 + kWC, k10, g10);
    window_of<T, V>(sidx, gs, w00 + kWC + 1, k11, g11);
    const int i = 2 * (t.oi0 + a), j = 2 * (t.oj0 + b);
    T* dxq = dxn + (i * xrow + static_cast<long long>(j) * d.c);
    const bool row0 = i < d.h, row1 = i + 1 < d.h;
    const bool col0 = j < d.w, col1 = j + 1 < d.w;
    float acc[V];
    // (i, j): the middle of (a, b)
#pragma unroll
    for (int u = 0; u < V; ++u) acc[u] = 0.f;
    take<V>(acc, k00, 4, g00);
    store_cell<T, V>(dxq, acc, row0 && col0, 0);
    // (i, j+1): (di, dj) = (1, 0) of (a, b+1), then (1, 2) of (a, b)
#pragma unroll
    for (int u = 0; u < V; ++u) acc[u] = 0.f;
    take<V>(acc, k01, 3, g01);
    take<V>(acc, k00, 5, g00);
    store_cell<T, V>(dxq, acc, row0 && col1, d.c);
    // (i+1, j): (0, 1) of (a+1, b), then (2, 1) of (a, b)
#pragma unroll
    for (int u = 0; u < V; ++u) acc[u] = 0.f;
    take<V>(acc, k10, 1, g10);
    take<V>(acc, k00, 7, g00);
    store_cell<T, V>(dxq, acc, row1 && col0, xrow);
    // (i+1, j+1): (0, 0) of (a+1, b+1), (0, 2) of (a+1, b), (2, 0) of
    // (a, b+1), (2, 2) of (a, b)
#pragma unroll
    for (int u = 0; u < V; ++u) acc[u] = 0.f;
    take<V>(acc, k11, 0, g11);
    take<V>(acc, k10, 2, g10);
    take<V>(acc, k01, 6, g01);
    take<V>(acc, k00, 8, g00);
    store_cell<T, V>(dxq, acc, row1 && col1, xrow + d.c);
  }
}

// x, dx [b, h, w, c]; g [b, ho, wo, c]; a resident grid walks the tiles,
// two stages of shared memory.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    maxpool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       T* __restrict__ dx, Dims d, int tiles) {
  using C = Cfg<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);                 // tile t's
  T* other = reinterpret_cast<T*>(smem + C::kStage);     // tile t+1's
  auto* sidx = reinterpret_cast<typename C::K*>(smem + 2 * C::kStage);
  const int tid = threadIdx.x;
  int t = blockIdx.x;
  Tile cur = tile_of<C::kCC>(t, d);
  if (t < tiles) issue_tile<T, V>(x, g, stage, cur, d, tid);
  commit_copies();
  for (; t < tiles; t += gridDim.x) {
    const int next = t + gridDim.x;  // tiles + gridDim.x < 2^31
    const Tile nxt = tile_of<C::kCC>(next, d);
    if (next < tiles) issue_tile<T, V>(x, g, other, nxt, d, tid);
    commit_copies();
    wait_older_copies();
    __syncthreads();  // tile t's stage has landed, from every thread
    first_max<T, V>(stage, sidx, cur, d, tid);
    __syncthreads();
    gather<T, V>(stage, sidx, dx, cur, d, tid);
    __syncthreads();  // the stage and sidx are free for the next copies
    T* const done = stage;
    stage = other;
    other = done;
    cur = nxt;
  }
}


// the resident grid on the current device: its SMs times the blocks of
// this kernel an SM holds (the same on every device of a process), once
// the kernel may take its shared memory
template <typename T, int V>
cudaError_t resident_blocks(int* blocks) {
  using C = Cfg<T, V>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      maxpool_bwd_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (attr != cudaSuccess) return attr;
  static int per_sm = 0;
  cudaError_t err = cudaSuccess;
  if (per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, maxpool_bwd_kernel<T, V>, kThreads, C::kSmem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  return err;
}

template <typename T, int V>
int launch(const void* x, const void* g, void* dx, int b, int h, int w, int c,
           cudaStream_t s) {
  using C = Cfg<T, V>;
  Dims d;
  d.h = h;
  d.w = w;
  d.c = c;
  d.ho = (h - 1) / 2 + 1;
  d.wo = (w - 1) / 2 + 1;
  // the input cells of the tiles [2*oi0, 2*oi0 + 2*kTH) cover rows
  // 0 .. 2*ho - 1 >= h - 1, and the columns alike
  d.tiles_h = (d.ho + kTH - 1) / kTH;
  d.tiles_w = (d.wo + kTW - 1) / kTW;
  d.chunks = (c + C::kCC - 1) / C::kCC;
  const long long tiles =
      static_cast<long long>(b) * d.tiles_h * d.tiles_w * d.chunks;
  int resident = 0;
  const cudaError_t err = resident_blocks<T, V>(&resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // tile indices, and the last one plus the grid, stay below 2^31
  if (tiles + resident > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = tiles < resident ? static_cast<int>(tiles) : resident;
  maxpool_bwd_kernel<T, V><<<blocks, kThreads, C::kSmem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx),
      d, static_cast<int>(tiles));
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
