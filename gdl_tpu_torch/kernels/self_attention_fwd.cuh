// Fused multi-head self-attention for the mmformer transformer stack,
// the kernels of self_attention_train.cu: the training forward
// `_sa_xw_fwd_kernel` + `_sa_attn_tail` and the backward `_sa_bwd_kernel`
// of gdl_tpu/ops/self_attention.py. (The eval forward has kernels of its
// own, self_attention_eval.cu.) For batch row b and head h, over N tokens
// (no padding of N on this card, so every key is valid):
//
//   qkv = x[b] . W^T (no bias; f32 accumulate) -> round to T     [N, 3C]
//   q   = q * T(scale)                                           (in T)
//   s   = q . k^T                                                (f32)
//   p   = softmax(s) over all N keys (f32); the training forward stores
//         round_T(p), BEFORE dropout, as the backward's residual
//   p_d = round_T(p * m),  m = dropout mask {0, 1/(1-rate)} or 1
//   out[b, :, h*d:(h+1)*d] = p_d . v (f32 accumulate) -> T
//
// and the backward, from the ROUNDED p residual and the same m:
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
// Design (a first, simple one; CUDA cores, f32 FMA, no tensor cores).
// The TPU kernel keeps a whole [N, N] score tile of a head group in 16 MB
// of VMEM. One head at N = 392 is 615 KB of f32 against 227 KB of shared
// memory here, and the softmax must be the whole row's because p is
// saved. So one entry point enqueues two kernels on the stream:
//   1. sa_proj_kernel: qkv = x . W^T as a tiled GEMM over all B*N rows
//      (64 x 192 tiles, 4 x 12 register tiles), written once to the qkv
//      residual. Projecting inside the attention blocks would repeat K and
//      V of all N tokens once per row tile (N/32 times the work).
//   2. sa_tile_kernel: one 128-thread block per (batch, head, 32 query
//      rows). The [32, N] score tile lives in shared memory; K, then V,
//      stream through it in 64-key chunks, re-read from L2. Row maximum,
//      sum, normalisation, the p write and the dropout are one warp per
//      row.
// What this costs against the TPU design: qkv makes one trip through
// device memory (B*N*3C elements written and read back, 154 MB in f32 at
// [64, 392, 512]: about 0.1 ms at the memory rate, against milliseconds
// of FMAs), and K and V are re-read N/32 times from L2. What bounds it:
// the FMAs (2*B*N*3C*C for the projection, 4*B*N*N*C for the attention)
// at the SIMT f32 rate, far below the tensor cores'; the eval forward's
// tensor-core tiles (gemm_tile.cuh, self_attention_eval.cu) are the
// pattern for these kernels' redesign.
//
// The backward is two kernels as well, so that no sum crosses blocks
// (bit-reproducible, no atomics):
//   A. sa_tile_kernel<MODE_BWD>, per 32 query rows: dp = dout . v^T into
//      the score tile, then per row m, delta and ds; ds goes to a scratch
//      buffer [B, H, N, N] in T, and dq = (ds . k) * scale is written.
//   B. sa_bwd_kv_kernel, per 32 keys: walks the query rows in chunks of
//      32, rebuilding p_d from p and m and reading ds back, and
//      accumulates dv = p_d^T . dout and dk = ds^T . q_s in registers.
// The ds scratch costs one write and one read of a score-sized array
// (315 MB in f32 at N = 392); recomputing dp in B instead would cost a
// fifth N^2*d product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

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

// ---- 1. the projection ---------------------------------------------------

constexpr int kProjThreads = 256;
constexpr int kProjTM = 64;   // rows of x per block
constexpr int kProjTN = 192;  // columns of qkv per block
constexpr int kProjKC = 32;   // C-chunk streamed through shared memory

// out[M, n3] = round_T(x[M, c] . w[n3, c]^T), w in nn.Linear layout
template <typename T>
__global__ void __launch_bounds__(kProjThreads)
sa_proj_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int m, int c, int n3) {
  constexpr int LD = kProjKC + 1;
  constexpr int JT = kProjTN / 16;
  __shared__ float xs[kProjTM * LD];
  __shared__ float ws[kProjTN * LD];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int r0 = blockIdx.x * kProjTM;
  const int c0 = blockIdx.y * kProjTN;

  float acc[4][JT];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < JT; ++j) acc[a][j] = 0.f;

  for (int k0 = 0; k0 < c; k0 += kProjKC) {
    for (int e = tid; e < kProjTM * kProjKC; e += kProjThreads) {
      const int r = e / kProjKC, kk = e % kProjKC;
      xs[r * LD + kk] =
          (r0 + r < m && k0 + kk < c)
              ? Num<T>::load(x + static_cast<size_t>(r0 + r) * c + k0 + kk)
              : 0.f;
    }
    for (int e = tid; e < kProjTN * kProjKC; e += kProjThreads) {
      const int col = e / kProjKC, kk = e % kProjKC;
      ws[col * LD + kk] =
          (c0 + col < n3 && k0 + kk < c)
              ? Num<T>::load(w + static_cast<size_t>(c0 + col) * c + k0 + kk)
              : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kProjKC; ++kk) {
      float xv[4], wv[JT];
#pragma unroll
      for (int a = 0; a < 4; ++a) xv[a] = xs[(ty + 16 * a) * LD + kk];
#pragma unroll
      for (int j = 0; j < JT; ++j) wv[j] = ws[(tx + 16 * j) * LD + kk];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < JT; ++j) acc[a][j] = fmaf(xv[a], wv[j], acc[a][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + ty + 16 * a;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < JT; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < n3)
        out[static_cast<size_t>(r) * n3 + col] = Num<T>::store(acc[a][j]);
    }
  }
}

template <typename T>
int launch_proj(const void* x, const void* w, void* qkv, int rows, int c,
                cudaStream_t stream) {
  const int n3 = 3 * c;
  const dim3 grid((rows + kProjTM - 1) / kProjTM,
                  (n3 + kProjTN - 1) / kProjTN);
  sa_proj_kernel<T><<<grid, kProjThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(qkv), rows, c, n3);
  return static_cast<int>(cudaGetLastError());
}

// ---- 2. the row-tile kernel ----------------------------------------------

constexpr int kTileThreads = 128;
constexpr int kTR = 32;  // query rows per block
constexpr int kKT = 64;  // keys per chunk streamed through shared memory
constexpr int kMaxSmem = 232448;  // a block's 227 KB on sm_90

constexpr int MODE_TRAIN = 1;  // forward, writes p, applies dropout
constexpr int MODE_BWD = 2;    // backward part A: ds scratch and dq

struct SaArgs {
  const void* qkv;          // [B, N, 3C]
  void* out;                // forward: out [B, N, C]; backward: dqkv
  void* p;                  // [B, H, N, N]: written (TRAIN), read (BWD)
  const void* mask;         // dropout_mode 1: [B, H, N, N] in T
  const int* seed;          // dropout_mode 2: two words on the device
  const void* dout;         // backward: [B, N, C]
  void* ds;                 // backward: scratch [B, H, N, N] in T
  unsigned char* keep_out;  // TRAIN, dropout_mode 2: the drawn keep mask
                            // [B, H, N, N] as bytes, or null
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

template <typename T, int DMAX, int MODE>
__global__ void __launch_bounds__(kTileThreads) sa_tile_kernel(SaArgs a) {
  constexpr int LDQ = DMAX + 1;
  constexpr int DT = DMAX / 16;
  extern __shared__ float smem[];
  float* as = smem;             // [kTR][LDQ]: q * scale, or dout
  float* bs = as + kTR * LDQ;   // [kKT][LDQ]: a chunk of k or v
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

  // the A tile: q rows scaled in T (forward) or dout rows (backward)
  for (int e = tid; e < kTR * DMAX; e += kTileThreads) {
    const int r = e / DMAX, dd = e % DMAX;
    float v = 0.f;
    if (i0 + r < n && dd < d) {
      if (MODE == MODE_BWD) {
        v = Num<T>::load(static_cast<const T*>(a.dout) +
                         (static_cast<size_t>(b) * n + i0 + r) * c + head * d +
                         dd);
      } else {
        v = Num<T>::round(
            Num<T>::load(qkv_b + static_cast<size_t>(i0 + r) * c3 + dd) *
            scale_t);
      }
    }
    as[r * LDQ + dd] = v;
  }

  // ---- phase 1: S = A . B^T, B = k (forward) or v (backward) -------------
  {
    const T* bsrc = qkv_b + (MODE == MODE_BWD ? 2 * c : c);
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
      if (MODE != MODE_BWD) {
        float mx = -CUDART_INF_F;
        for (int j = lane; j < n; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        float sum = 0.f;
        for (int j = lane; j < n; j += 32) {
          const float ex = expf(row[j] - mx);
          row[j] = ex;
          sum += ex;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        __syncwarp();
        for (int q = lane; q < nquads; q += 32) {
          const int j = 4 * q;
          const int valid = n - j < 4 ? n - j : 4;
          float m[4];
          bool keep[4];
          mask4<T>(a, rb + j, valid, k0, k1, m, keep);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            if (t >= valid) break;
            const float pf = row[j + t] / sum;
            static_cast<T*>(a.p)[rb + j + t] = Num<T>::store(pf);
            if (a.keep_out != nullptr && a.dropout_mode == 2)
              a.keep_out[rb + j + t] = keep[t] ? 1 : 0;
            row[j + t] = Num<T>::round(pf * m[t]);
          }
        }
      } else {
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
  }

  // ---- phase 3: O = S . B, B = v (forward) or k (backward) ----------------
  {
    const T* bsrc = qkv_b + (MODE == MODE_BWD ? c : 2 * c);
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
    // forward: out [B, N, C]; backward: the dq third of dqkv [B, N, 3C]
    const int ldo = MODE == MODE_BWD ? c3 : c;
    const float post = MODE == MODE_BWD ? a.scale : 1.f;
    T* ob = static_cast<T*>(a.out) + static_cast<size_t>(b) * n * ldo + head * d;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 8 * r;
      if (i >= n) continue;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const int col = tx + 16 * j;
        if (col < d)
          ob[static_cast<size_t>(i) * ldo + col] =
              Num<T>::store(acc[r][j] * post);
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

template <typename T, int DMAX, int MODE>
int launch_tile(const SaArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = sizeof(float) * tile_smem_floats<DMAX>(a.n);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = grant_smem(sa_tile_kernel<T, DMAX, MODE>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.n + kTR - 1) / kTR, a.heads, batch);
  sa_tile_kernel<T, DMAX, MODE><<<grid, kTileThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MODE>
int dispatch_tile(const SaArgs& a, int batch, cudaStream_t s) {
  if (a.d <= 16) return launch_tile<T, 16, MODE>(a, batch, s);
  if (a.d <= 32) return launch_tile<T, 32, MODE>(a, batch, s);
  if (a.d <= 64) return launch_tile<T, 64, MODE>(a, batch, s);
  if (a.d <= 128) return launch_tile<T, 128, MODE>(a, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the training forward: projection, then the row tiles
template <typename T, int MODE>
int launch_forward(const void* x, const void* w, const SaArgs& a, int batch,
                   cudaStream_t s) {
  const int err =
      launch_proj<T>(x, w, const_cast<void*>(a.qkv), batch * a.n, a.c, s);
  if (err != 0) return err;
  return dispatch_tile<T, MODE>(a, batch, s);
}

}  // namespace
