// Training kernels of the fused self-attention (gdl_tpu/ops/
// self_attention.py):
//
//   gdl_sa_fwd_launch  the forward `_sa_xw_fwd_kernel` + `_sa_attn_tail`:
//                      qkv projection, softmax, attention-probability
//                      dropout, p . v; writes out, the qkv residual
//                      [B, N, 3C] and the pre-dropout p residual
//                      [B, H, N, N]
//   gdl_sa_bwd_launch  the backward `_sa_bwd_kernel`: dqkv [B, N, 3C] from
//                      qkv, the saved p, the same mask and dout
//
// The arithmetic, the rounding points and the design of both are in
// self_attention_fwd.cuh. dropout_mode: 0 none; 1 the mask [B, H, N, N]
// in T with values {0, 1/(1-rate)} is read from `mask`; 2 the mask is
// drawn in the kernel by Philox from the two seed words at `seed` (device
// memory), keeping an element iff its word < keep_thresh, and drawn
// again, bit for bit, in the backward. `keep_out`, if not null, receives
// the mode-2 keep mask as bytes (a debug output for holding the kernel's
// bits to the plain generator's).
//
// Plain C interface: pointers are device pointers, `stream` a
// cudaStream_t; dtype 0 = float32, 1 = bfloat16. Each returns the error
// code of cudaGetLastError() after its launches (0 = success).

#include "self_attention_fwd.cuh"

namespace {

constexpr int kKvTI = 32;  // query rows per chunk
constexpr int kKvTJ = 32;  // keys per block

// backward part B: dv = p_d^T . dout and dk = ds^T . q_s for 32 keys
template <typename T, int DMAX>
__global__ void __launch_bounds__(kTileThreads) sa_bwd_kv_kernel(SaArgs a) {
  constexpr int LDQ = DMAX + 1;
  constexpr int LDP = kKvTJ + 1;
  constexpr int DT = DMAX / 16;
  __shared__ float pds[kKvTI * LDP];  // p_d chunk [i][j]
  __shared__ float dss[kKvTI * LDP];  // ds chunk [i][j]
  __shared__ float dos[kKvTI * LDQ];  // dout chunk [i][d]
  __shared__ float qss[kKvTI * LDQ];  // q * T(scale) chunk [i][d]

  const int n = a.n, c = a.c, d = a.d, heads = a.heads;
  const int c3 = 3 * c;
  const int j0 = blockIdx.x * kKvTJ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const T* qkv_b =
      static_cast<const T*>(a.qkv) + static_cast<size_t>(b) * n * c3 + head * d;
  const T* dout_b =
      static_cast<const T*>(a.dout) + static_cast<size_t>(b) * n * c + head * d;
  const T* p_bh = static_cast<const T*>(a.p);
  const T* ds_bh = static_cast<const T*>(a.ds);
  const uint64_t bh = (static_cast<uint64_t>(b) * heads + head) * n;
  const float scale_t = Num<T>::round(a.scale);
  uint32_t k0 = 0, k1 = 0;
  if (a.dropout_mode == 2) {
    k0 = static_cast<uint32_t>(a.seed[0]);
    k1 = static_cast<uint32_t>(a.seed[1]);
  }

  float adv[4][DT], adk[4][DT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < DT; ++j) adv[r][j] = adk[r][j] = 0.f;

  for (int i0 = 0; i0 < n; i0 += kKvTI) {
    __syncthreads();
    for (int w = tid; w < kKvTI * (kKvTJ / 4); w += kTileThreads) {
      const int r = w / (kKvTJ / 4), q = w % (kKvTJ / 4);
      const int i = i0 + r, j = j0 + 4 * q;
      int valid = 0;
      if (i < n && j < n) valid = n - j < 4 ? n - j : 4;
      float m[4] = {0.f, 0.f, 0.f, 0.f};
      bool keep[4];
      const uint64_t e0 = (bh + i) * n + j;
      if (valid > 0) mask4<T>(a, e0, valid, k0, k1, m, keep);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float pd = 0.f, dsv = 0.f;
        if (t < valid) {
          pd = Num<T>::round(Num<T>::load(p_bh + e0 + t) * m[t]);
          dsv = Num<T>::load(ds_bh + e0 + t);
        }
        pds[r * LDP + 4 * q + t] = pd;
        dss[r * LDP + 4 * q + t] = dsv;
      }
    }
    for (int e = tid; e < kKvTI * DMAX; e += kTileThreads) {
      const int r = e / DMAX, dd = e % DMAX;
      const int i = i0 + r;
      float dv = 0.f, qv = 0.f;
      if (i < n && dd < d) {
        dv = Num<T>::load(dout_b + static_cast<size_t>(i) * c + dd);
        qv = Num<T>::round(
            Num<T>::load(qkv_b + static_cast<size_t>(i) * c3 + dd) * scale_t);
      }
      dos[r * LDQ + dd] = dv;
      qss[r * LDQ + dd] = qv;
    }
    __syncthreads();
#pragma unroll 4
    for (int ii = 0; ii < kKvTI; ++ii) {
      float pa[4], da[4], dv[DT], qv[DT];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[r] = pds[ii * LDP + ty + 8 * r];
        da[r] = dss[ii * LDP + ty + 8 * r];
      }
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        dv[j] = dos[ii * LDQ + tx + 16 * j];
        qv[j] = qss[ii * LDQ + tx + 16 * j];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          adv[r][j] = fmaf(pa[r], dv[j], adv[r][j]);
          adk[r][j] = fmaf(da[r], qv[j], adk[r][j]);
        }
    }
  }
  // dqkv [B, N, 3C]: dk at column offset C, dv at 2C
  T* ob = static_cast<T*>(a.out) + static_cast<size_t>(b) * n * c3 + head * d;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + ty + 8 * r;
    if (j >= n) continue;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      const int col = tx + 16 * t;
      if (col < d) {
        ob[static_cast<size_t>(j) * c3 + c + col] = Num<T>::store(adk[r][t]);
        ob[static_cast<size_t>(j) * c3 + 2 * c + col] =
            Num<T>::store(adv[r][t]);
      }
    }
  }
}

template <typename T, int DMAX>
int launch_kv(const SaArgs& a, int batch, cudaStream_t stream) {
  const dim3 grid((a.n + kKvTJ - 1) / kKvTJ, a.heads, batch);
  sa_bwd_kv_kernel<T, DMAX><<<grid, kTileThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_backward(const SaArgs& a, int batch, cudaStream_t s) {
  int err = dispatch_tile<T, MODE_BWD>(a, batch, s);
  if (err != 0) return err;
  if (a.d <= 16) return launch_kv<T, 16>(a, batch, s);
  if (a.d <= 32) return launch_kv<T, 32>(a, batch, s);
  if (a.d <= 64) return launch_kv<T, 64>(a, batch, s);
  return launch_kv<T, 128>(a, batch, s);
}

SaArgs make_args(const void* qkv, void* out, void* p, const void* mask,
                 const void* seed, int n, int c, int heads, int d,
                 float scale, int dropout_mode, unsigned keep_thresh,
                 float inv_keep) {
  SaArgs a{};
  a.qkv = qkv;
  a.out = out;
  a.p = p;
  a.mask = mask;
  a.seed = static_cast<const int*>(seed);
  a.n = n;
  a.c = c;
  a.heads = heads;
  a.d = d;
  a.scale = scale;
  a.dropout_mode = dropout_mode;
  a.keep_thresh = keep_thresh;
  a.inv_keep = inv_keep;
  return a;
}

}  // namespace

extern "C" int gdl_sa_fwd_launch(const void* x, const void* w, void* qkv,
                                 void* p, void* out, const void* mask,
                                 const void* seed, void* keep_out, int batch,
                                 int n, int c, int heads, int d, float scale,
                                 int dropout_mode, unsigned keep_thresh,
                                 float inv_keep, int dtype, void* stream) {
  SaArgs a = make_args(qkv, out, p, mask, seed, n, c, heads, d, scale,
                       dropout_mode, keep_thresh, inv_keep);
  a.keep_out = static_cast<unsigned char*>(keep_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_forward<float, MODE_TRAIN>(x, w, a, batch, s);
  if (dtype == 1)
    return launch_forward<__nv_bfloat16, MODE_TRAIN>(x, w, a, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int gdl_sa_bwd_launch(const void* qkv, const void* p,
                                 const void* mask, const void* seed,
                                 const void* dout, void* ds, void* dqkv,
                                 int batch, int n, int c, int heads, int d,
                                 float scale, int dropout_mode,
                                 unsigned keep_thresh, float inv_keep,
                                 int dtype, void* stream) {
  SaArgs a = make_args(qkv, dqkv, const_cast<void*>(p), mask, seed, n, c,
                       heads, d, scale, dropout_mode, keep_thresh, inv_keep);
  a.dout = dout;
  a.ds = ds;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_backward<float>(a, batch, s);
  if (dtype == 1) return launch_backward<__nv_bfloat16>(a, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
