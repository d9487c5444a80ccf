// The backward of the fused self-attention for the mmformer transformer
// stack, part A of `_sa_bwd_kernel` (gdl_tpu/ops/self_attention.py, kernel
// #11; part B and the entry points are in self_attention_train.cu), and
// what the backward shares: the rounding helpers and the dropout
// multiplier. (The forwards, #10, #12 and #13, run on the row tile of
// self_attention_rows.cuh.) For batch row b and head h, over N tokens,
// from the qkv residual [B, N, 3C], the ROUNDED pre-dropout p residual
// [B, H, N, N] that the training forward stored and the same mask m:
//
//   p_d = round_T(p * m);  dv = p_d^T . dout;  dp = (dout . v^T) * m
//   ds  = p * (dp - sum_j dp * p)  (f32) -> round to T
//   dq  = (ds . k) * scale;  dk = ds^T . (q * T(scale))
//
// T is float or bfloat16; the rounding points are the TPU kernels'. The
// mask m is read from memory (dropout_mode 1) or drawn in the kernel
// (dropout_mode 2) by Philox keyed on the flat [B, H, N, N] element index
// (philox.cuh), so the forward, both backward kernels and the plain
// PyTorch version see the same bits whatever their tiling.
//
// What bounds it. Per mmformer_n step (7 calls) the backward is 163 GFLOP
// against 3.1 GB in f32: bound by operations at the SIMT f32 rate; in
// bf16 by bytes (0.46 ms), far from either on this design.
//
// The design (a first, simple one; CUDA cores, f32 FMA, no tensor
// cores): two kernels, so that no sum crosses blocks (bit-reproducible,
// no atomics):
//   A. sa_tile_kernel, one 128-thread block per (batch, head, 32 query
//      rows): dp = dout . v^T into a [32, N] f32 score tile in shared
//      memory (v streams through in 64-key chunks, re-read from L2), then
//      per row (one warp) m, delta and ds; ds goes to a scratch buffer
//      [B, H, N, N] in T, and dq = (ds . k) * scale is written.
//   B. sa_bwd_kv_kernel, per 32 keys: walks the query rows in chunks of
//      32, rebuilding p_d from p and m and reading ds back, and
//      accumulates dv = p_d^T . dout and dk = ds^T . q_s in registers.
// The ds scratch costs one write and one read of a score-sized array
// (315 MB in f32 at N = 392); recomputing dp in B instead would cost a
// fifth N^2*d product. The forwards' tensor-core row tile is the pattern
// for its redesign.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

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

// ---- the row tile of part A ----------------------------------------------

constexpr int kTileThreads = 128;
constexpr int kTR = 32;  // query rows per block
constexpr int kKT = 64;  // keys per chunk streamed through shared memory
constexpr int kMaxSmem = 232448;  // a block's 227 KB on sm_90

struct SaArgs {
  const void* qkv;          // [B, N, 3C]
  void* out;                // dqkv [B, N, 3C]
  const void* p;            // [B, H, N, N], the forward's residual
  const void* mask;         // dropout_mode 1: [B, H, N, N] in T
  const int* seed;          // dropout_mode 2: two words on the device
  const void* dout;         // [B, N, C]
  void* ds;                 // scratch [B, H, N, N] in T
  int n, c, heads, d;
  float scale;
  int dropout_mode;
  uint32_t keep_thresh;
  float inv_keep;
};

// the mask values m of the four elements e0 .. e0 + 3 of row-major
// [B, H, N, N]; `valid` of them exist in this row
template <typename T>
__device__ inline void mask4(const SaArgs& a, uint64_t e0, int valid,
                             uint32_t k0, uint32_t k1, float m[4],
                             bool keep[4]) {
  if (a.dropout_mode == 2) {
    philox::keep4(e0, k0, k1, a.keep_thresh, keep);
#pragma unroll
    for (int t = 0; t < 4; ++t) m[t] = keep[t] ? a.inv_keep : 0.f;
  } else if (a.dropout_mode == 1) {
    const T* mk = static_cast<const T*>(a.mask) + e0;
#pragma unroll
    for (int t = 0; t < 4; ++t) m[t] = t < valid ? Num<T>::load(mk + t) : 0.f;
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) m[t] = 1.f;
  }
}

template <int DMAX>
constexpr size_t tile_smem_floats(int n) {
  return static_cast<size_t>(kTR + kKT) * (DMAX + 1) +
         static_cast<size_t>(kTR) * (n | 1);
}

// part A: dp = dout . v^T, ds, dq for 32 query rows
template <typename T, int DMAX>
__global__ void __launch_bounds__(kTileThreads) sa_tile_kernel(SaArgs a) {
  constexpr int LDQ = DMAX + 1;
  constexpr int DT = DMAX / 16;
  extern __shared__ float smem[];
  float* as = smem;             // [kTR][LDQ]: dout
  float* bs = as + kTR * LDQ;   // [kKT][LDQ]: a chunk of v, then of k
  float* S = bs + kKT * LDQ;    // [kTR][lds]: the score tile

  const int n = a.n, c = a.c, d = a.d, heads = a.heads;
  const int c3 = 3 * c;
  const int lds = n | 1;
  const int i0 = blockIdx.x * kTR;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;  // 0..7
  const T* qkv_b =
      static_cast<const T*>(a.qkv) + static_cast<size_t>(b) * n * c3 + head * d;
  const float scale_t = Num<T>::round(a.scale);

  uint32_t k0 = 0, k1 = 0;
  if (a.dropout_mode == 2) {
    k0 = static_cast<uint32_t>(a.seed[0]);
    k1 = static_cast<uint32_t>(a.seed[1]);
  }

  // the A tile: dout rows
  for (int e = tid; e < kTR * DMAX; e += kTileThreads) {
    const int r = e / DMAX, dd = e % DMAX;
    as[r * LDQ + dd] =
        (i0 + r < n && dd < d)
            ? Num<T>::load(static_cast<const T*>(a.dout) +
                           (static_cast<size_t>(b) * n + i0 + r) * c +
                           head * d + dd)
            : 0.f;
  }

  // ---- phase 1: S = dout . v^T ---------------------------------------------
  {
    const T* bsrc = qkv_b + 2 * c;
    for (int j0 = 0; j0 < n; j0 += kKT) {
      __syncthreads();  // the chunk buffer is free; `as` is complete
      for (int e = tid; e < kKT * DMAX; e += kTileThreads) {
        const int r = e / DMAX, dd = e % DMAX;
        bs[r * LDQ + dd] =
            (j0 + r < n && dd < d)
                ? Num<T>::load(bsrc + static_cast<size_t>(j0 + r) * c3 + dd)
                : 0.f;
      }
      __syncthreads();
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
#pragma unroll 8
      for (int k = 0; k < DMAX; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) av[r] = as[(ty + 8 * r) * LDQ + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * LDQ + k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(av[r], bv[j], acc[r][j]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = j0 + tx + 16 * j;
          if (col < n) S[(ty + 8 * r) * lds + col] = acc[r][j];
        }
    }
  }
  __syncthreads();

  // ---- phase 2: the rows, one warp each ------------------------------------
  {
    const int lane = tid % 32;
    const int nquads = (n + 3) / 4;
    for (int r = tid / 32; r < kTR; r += kTileThreads / 32) {
      const int i = i0 + r;
      if (i >= n) continue;  // the whole warp together
      float* row = S + r * lds;
      const uint64_t rb =
          ((static_cast<uint64_t>(b) * heads + head) * n + i) * n;
      // dp = (dout . v^T) * m; delta = sum_j dp * p
      const T* pin = static_cast<const T*>(a.p) + rb;
      float delta = 0.f;
      for (int q = lane; q < nquads; q += 32) {
        const int j = 4 * q;
        const int valid = n - j < 4 ? n - j : 4;
        float m[4];
        bool keep[4];
        mask4<T>(a, rb + j, valid, k0, k1, m, keep);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (t >= valid) break;
          const float dp = row[j + t] * m[t];
          row[j + t] = dp;
          delta = fmaf(dp, Num<T>::load(pin + j + t), delta);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        delta += __shfl_xor_sync(0xffffffffu, delta, o);
      __syncwarp();
      T* dsout = static_cast<T*>(a.ds) + rb;
      for (int j = lane; j < n; j += 32) {
        const float ds =
            Num<T>::round(Num<T>::load(pin + j) * (row[j] - delta));
        dsout[j] = Num<T>::store(ds);
        row[j] = ds;
      }
    }
  }

  // ---- phase 3: dq = (ds . k) * scale --------------------------------------
  {
    const T* bsrc = qkv_b + c;
    float acc[4][DT];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < DT; ++j) acc[r][j] = 0.f;
    for (int j0 = 0; j0 < n; j0 += kKT) {
      __syncthreads();  // phase 2, or the previous chunk, is done
      for (int e = tid; e < kKT * DMAX; e += kTileThreads) {
        const int r = e / DMAX, dd = e % DMAX;
        bs[r * LDQ + dd] =
            (j0 + r < n && dd < d)
                ? Num<T>::load(bsrc + static_cast<size_t>(j0 + r) * c3 + dd)
                : 0.f;
      }
      __syncthreads();
      const int jn = n - j0 < kKT ? n - j0 : kKT;
#pragma unroll 4
      for (int jj = 0; jj < jn; ++jj) {
        float pv[4], vv[DT];
#pragma unroll
        for (int r = 0; r < 4; ++r) pv[r] = S[(ty + 8 * r) * lds + j0 + jj];
#pragma unroll
        for (int j = 0; j < DT; ++j) vv[j] = bs[jj * LDQ + tx + 16 * j];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < DT; ++j) acc[r][j] = fmaf(pv[r], vv[j], acc[r][j]);
      }
    }
    // the dq third of dqkv [B, N, 3C]
    T* ob = static_cast<T*>(a.out) + static_cast<size_t>(b) * n * c3 + head * d;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 8 * r;
      if (i >= n) continue;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const int col = tx + 16 * j;
        if (col < d)
          ob[static_cast<size_t>(i) * c3 + col] =
              Num<T>::store(acc[r][j] * a.scale);
      }
    }
  }
}

// above 48 KB a block's shared memory has to be granted explicitly; the
// launchers grant the card's maximum once per instantiation
template <typename K>
cudaError_t grant_smem(K kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

template <typename T, int DMAX>
int launch_tile(const SaArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = sizeof(float) * tile_smem_floats<DMAX>(a.n);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = grant_smem(sa_tile_kernel<T, DMAX>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.n + kTR - 1) / kTR, a.heads, batch);
  sa_tile_kernel<T, DMAX><<<grid, kTileThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_tile(const SaArgs& a, int batch, cudaStream_t s) {
  if (a.d <= 16) return launch_tile<T, 16>(a, batch, s);
  if (a.d <= 32) return launch_tile<T, 32>(a, batch, s);
  if (a.d <= 64) return launch_tile<T, 64>(a, batch, s);
  if (a.d <= 128) return launch_tile<T, 128>(a, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
