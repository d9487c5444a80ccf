// The row tile of the mmformer self-attention: one block per (batch,
// head, R query rows) computes, over all N keys of the head,
//
//   q   = round_T(q * round_T(scale))
//   s   = q . k^T                       (f32, the whole [R, N] row tile)
//   p   = softmax(s) over the whole row (f32)
//   out[b, :, h*d:(h+1)*d] = round_T(P . v)   (f32 sums)
//
// from a qkv [B, N, 3C] in T (float or bfloat16). Three kernels share the
// body, `rows_body`, whose mode is a template parameter:
//   - sa_eval_kernel (#13, self_attention_eval.cu): P = round_T(p), no
//     residuals;
//   - sa_train_kernel (#10 after its projection, #12; self_attention_
//     train.cu): after the softmax one more pass over each row writes the
//     pre-dropout residual round_T(p) to p [B, H, N, N], forms the dropout
//     multiplier m (the mask read from memory, dropout_mode 1, or drawn by
//     Philox on the flat [B, H, N, N] index, mode 2, as the backward draws
//     it again), writes the keep bytes when asked, and leaves
//     P = round_T(p * m) in the score tile for phase 3.
//   - sa_bwd_rows_kernel (part A of the backward #11, self_attention_
//     train.cu): the same phases with dp in place of s. The A rows are
//     dout [B, N, C], unscaled; phase 1 streams v, so the tile holds
//     dp = dout . v^T; the row pass (bwd_rows, one warp a row) reads p
//     along the row, forms m as the training pass does, reduces
//     delta = sum_j dp * m * p and leaves ds = round_T(p * (dp * m -
//     delta)) in the tile and in the scratch ds [B, H, N, N]; phase 3
//     streams k, and dq = (ds . k) * scale (f32 scale) goes to the q third
//     of dqkv [B, N, 3C]. What bounds it is #12's: the score-sized p read
//     and ds write in bf16, the products in f32.
// p = e / sum is a division in the training kernel, as jax.nn.softmax and
// the plain version compute it; the eval kernel multiplies by 1 / sum.
//
// The design (the eval kernel's). 4R threads; R = 64 where the f32
// score tile [R, N] and two chunk buffers fit in a block's 227 KB, else
// 32. K, then V, stream through the block in chunks of KC keys by
// cp.async, through a ring of up to 8 buffers sized on the host, so that
// every chunk of a head is in flight at once where it fits.
//   - bf16: each warp owns 16 query rows and half of a chunk's keys
//     (phase 1) or half of the head's columns (phase 3). q's A fragments
//     stay in registers; S = q . k^T and P . V run on mma.sync (bf16 in,
//     f32 sums) with fragments from ldmatrix; P's A fragments are packed
//     from the f32 tile. KC = 64.
//   - f32: the same structure on SIMT FMA, S and P . V in 4 x 8 register
//     tiles from float4 reads (12 reads for 128 FMAs); the keys of a chunk
//     are split over 128 / DMAX groups of threads whose partial sums are
//     added in a fixed order at the end. KC = 128.
//   - The softmax keeps the whole row (no online softmax, which would move
//     the rounding point of p); phase 1 keeps each row's maximum in
//     registers, so the exponentials and their sum are one pass. The
//     training pass is one warp a row, four consecutive keys a lane: one
//     Philox call per four keys, and the p, mask and keep rows are read
//     and written along the row, 16 bytes (f32) or 8 (bf16) a lane where
//     N % 4 == 0.
// No atomics: a launch gives the same bits every time.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

#include "gemm_tile.cuh"
#include "philox.cuh"

namespace sa_rows {
// internal to each library that includes it: a static of a template here
// (a launcher's attribute guard) must not be one object across the
// libraries loaded into a process
namespace {

using gemm::cp_async_commit;
using gemm::cp_async_wait;
using gemm::ldsm_x2_trans;
using gemm::ldsm_x4;
using gemm::load_tile;
using gemm::mma_bf16;
using gemm::pack_bf16;

constexpr int kMaxSmem = 232448;  // a block's 227 KB on sm_90
// two blocks an SM: the SM's 228 KB less 1 KB the runtime keeps per block
constexpr int kHalfSmem = 115712;
constexpr int kMaxBuf = 8;  // chunk buffers in the ring

struct Args {
  const void* qkv;  // [B, N, 3C]
  void* out;        // [B, N, C]
  int n, c, d;
  float scale;
  int lds;       // row stride of the score tile, in floats
  int s_floats;  // floats of the score tile's region
  int nbuf;      // chunk buffers in the ring, 1 .. kMaxBuf
  int vec;       // 1: 16-byte cp.async copies (rows and pointer aligned)
  // the training kernel's alone
  void* p;                  // [B, H, N, N]: the pre-dropout residual
  const void* mask;         // dropout_mode 1: [B, H, N, N] in T
  const int* seed;          // dropout_mode 2: two words on the device
  unsigned char* keep_out;  // mode 2: the keep mask as bytes, or null
  int heads;
  int dropout_mode;  // 0 none, 1 mask, 2 Philox
  uint32_t keep_thresh;
  float inv_keep;
  int rowvec;  // 1: N % 4 == 0 and p, mask, keep_out (ds) 16-byte aligned
  // the backward's alone
  const void* dout;  // [B, N, C]
  void* ds;          // scratch [B, H, N, N] in T, read by the keys kernel
};

// what rows_body does between its phases, a template parameter: the eval
// and training forwards (the softmax), or the backward (dp in place of s)
enum : int { kEval = 0, kTrain = 1, kBwd = 2 };

__device__ inline float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// wait until at most n copy groups of this thread are in flight; a count
// above 6 waits for more than it must
__device__ inline void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// Row statistics beside the score tile: mx[2][R], the row maxima that two
// groups of threads found in phase 1 (the whole row's is their maximum),
// and inv[R], what phase 3 multiplies the tile's values by: 1 / sum of
// the row's exponentials (eval), or 1 (training: the tile holds P).
struct Stats {
  float* mx;
  float* inv;
};

// ---- bf16: mma.sync --------------------------------------------------------

template <int DMAX, int R>
struct PathBf16 {
  using T = __nv_bfloat16;
  static constexpr int KC = 64;        // keys per chunk
  static constexpr int LDK = DMAX + 8;  // 16-byte rows off the bank period
  static constexpr int KS = DMAX / 16;  // k16 steps of q . k^T
  static constexpr int RG = R / 16;     // row groups (one warp each)
  static constexpr int NTD = DMAX / 16;  // 8-column tiles of out per warp

  struct State {
    uint32_t q[KS][4];  // q * scale, A fragments
    float o[NTD][4];    // out, C fragments
    float m[2];         // maxima of rows g and g + 8 over this thread's keys
  };

  __device__ static void init(State& st, const T* qs, float scale_t,
                              int tid) {
    const int lane = tid % 32, rg = (tid / 32) % RG;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      ldsm_x4(st.q[ks], qs + (rg * 16 + lane % 16) * LDK + ks * 16 +
                            (lane / 16) * 8);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const __nv_bfloat162 v =
            *reinterpret_cast<const __nv_bfloat162*>(&st.q[ks][t]);
        st.q[ks][t] = pack_bf16(__low2float(v) * scale_t,
                                __high2float(v) * scale_t);
      }
    }
#pragma unroll
    for (int u = 0; u < NTD; ++u)
#pragma unroll
      for (int t = 0; t < 4; ++t) st.o[u][t] = 0.f;
    st.m[0] = st.m[1] = -CUDART_INF_F;
  }

  // S[:, j0 .. j0 + KC) = q . k^T for this warp's 16 rows and half of the
  // chunk's 8-key tiles (q is in registers; k rows past N are zeros)
  __device__ static void scores(State& st, float* S, int lds, const T*,
                                const T* ks_, int j0, int n, int tid) {
    const int lane = tid % 32, warp = tid / 32;
    const int rg = warp % RG, sp = warp / RG;
    const int g = lane / 4, q = lane % 4;
    constexpr int NT = KC / 16;  // 8-key tiles a warp
    float acc[NT][4];
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[u][t] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int u = 0; u < NT; u += 2) {  // two 8-key tiles a load
        uint32_t b[4];
        ldsm_x4(b, ks_ + ((sp * NT + u) * 8 + lane % 8 + (lane / 16) * 8) *
                             LDK +
                         ks * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(acc[u], st.q[ks], b);
        mma_bf16(acc[u + 1], st.q[ks], b + 2);
      }
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      const int col = j0 + (sp * NT + u) * 8 + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* dst = S + (rg * 16 + g + 8 * h) * lds + col;
        const float v0 = acc[u][2 * h], v1 = acc[u][2 * h + 1];
        if (col + 1 < n) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          st.m[h] = fmaxf(st.m[h], fmaxf(v0, v1));
        } else if (col < n) {
          dst[0] = v0;
          st.m[h] = fmaxf(st.m[h], v0);
        }
      }
    }
  }

  // after the last k chunk: this warp's row maxima to mx[sp]
  __device__ static void row_max(State& st, Stats ss, int tid) {
    const int lane = tid % 32, warp = tid / 32;
    const int rg = warp % RG, sp = warp / RG;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = st.m[h];
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (lane % 4 == 0) ss.mx[sp * R + rg * 16 + lane / 4 + 8 * h] = m;
    }
  }

  // out += P . v over the chunk's keys, P = round_bf16(tile * inv) packed
  // from the tile
  __device__ static void pv(State& st, const float* S, Stats ss, int lds,
                            const T* vs, int j0, int npad, int d, int tid) {
    const int lane = tid % 32, warp = tid / 32;
    const int rg = warp % RG, sp = warp / RG;
    const int g = lane / 4, q = lane % 4;
    const int steps = (npad - j0 < KC ? npad - j0 : KC) / 16;
    const float i0 = ss.inv[rg * 16 + g], i8 = ss.inv[rg * 16 + g + 8];
    const float* r0 = S + (rg * 16 + g) * lds + j0 + 2 * q;
    const float* r8 = r0 + 8 * lds;
    // every step runs, the ones past the tile's padded width on zeros (v
    // rows past N are zeros too), so that the loads of all four steps can
    // be in flight together
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      const int k = ks * 16;
      const bool in = ks < steps;
      const float2 z = make_float2(0.f, 0.f);
      const float2 p00 = in ? *reinterpret_cast<const float2*>(r0 + k) : z;
      const float2 p10 = in ? *reinterpret_cast<const float2*>(r8 + k) : z;
      const float2 p01 =
          in ? *reinterpret_cast<const float2*>(r0 + k + 8) : z;
      const float2 p11 =
          in ? *reinterpret_cast<const float2*>(r8 + k + 8) : z;
      const uint32_t a[4] = {pack_bf16(p00.x * i0, p00.y * i0),
                             pack_bf16(p10.x * i8, p10.y * i8),
                             pack_bf16(p01.x * i0, p01.y * i0),
                             pack_bf16(p11.x * i8, p11.y * i8)};
#pragma unroll
      for (int u = 0; u < NTD; ++u) {
        const int nt = sp * NTD + u;
        if (nt * 8 < d) {
          uint32_t bv[2];
          ldsm_x2_trans(bv, vs + (k + lane % 16) * LDK + nt * 8);
          mma_bf16(st.o[u], a, bv);
        }
      }
    }
  }

  // rows i0 .. of out (row stride ldo) = round_bf16(sums), or
  // round_bf16(sums * scale) with SCALE (the backward's dq)
  template <bool SCALE>
  __device__ static void finish(const State& st, float*, Stats, T* out,
                                int i0, int n, int ldo, int d, int tid,
                                float scale) {
    const int lane = tid % 32, warp = tid / 32;
    const int rg = warp % RG, sp = warp / RG;
    const int g = lane / 4, q = lane % 4;
    const bool pairs = d % 2 == 0 && ldo % 2 == 0;
#pragma unroll
    for (int u = 0; u < NTD; ++u) {
      const int col = (sp * NTD + u) * 8 + 2 * q;
      if (col >= d) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + rg * 16 + g + 8 * h;
        if (i >= n) continue;
        T* dst = out + static_cast<size_t>(i) * ldo + col;
        float v0 = st.o[u][2 * h], v1 = st.o[u][2 * h + 1];
        if constexpr (SCALE) {
          v0 *= scale;
          v1 *= scale;
        }
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          dst[0] = __float2bfloat16_rn(v0);
          if (col + 1 < d) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
};

// ---- f32: register-blocked SIMT FMA ----------------------------------------

template <int DMAX, int R>
struct PathF32 {
  using T = float;
  static constexpr int KC = 128;       // keys per chunk
  static constexpr int LDK = DMAX + 4;  // float4 rows off the bank period
  static constexpr int RY = R / 4;      // row groups: rows ry + RY * i
  static constexpr int CG = DMAX / 8;   // column groups of phase 3
  static constexpr int SPLITS = 128 / DMAX;  // key groups of phase 3

  struct State {
    float o[4][8];  // rows ry + RY i; columns cx*4 + e, DMAX/2 + cx*4 + e
    float m[4];     // maxima of rows ty + RY i over this thread's keys
  };

  __device__ static void init(State& st, T* qs, float scale_t, int tid) {
    // q * scale in place (f32: the product is already rounded); the caller
    // synchronises before the tile is read
    for (int e = tid; e < R * DMAX; e += 4 * R) {
      const int r = e / DMAX, k = e % DMAX;
      qs[r * LDK + k] *= scale_t;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      st.m[i] = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j) st.o[i][j] = 0.f;
    }
  }

  // S[:, j0 .. j0 + KC): thread (ty, tx) takes rows ty + RY i and keys
  // tx + 16 j
  __device__ static void scores(State& st, float* S, int lds, const T* qs,
                                const T* ks_, int j0, int n, int tid) {
    const int tx = tid % 16, ty = tid / 16;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int k = 0; k < DMAX; k += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (ty + RY * i) * LDK + k);
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // k rows past N are zeros
        const float4 b =
            *reinterpret_cast<const float4*>(ks_ + (tx + 16 * j) * LDK + k);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float s = acc[i][j];
          s = fmaf(a[i].x, b.x, s);
          s = fmaf(a[i].y, b.y, s);
          s = fmaf(a[i].z, b.z, s);
          s = fmaf(a[i].w, b.w, s);
          acc[i][j] = s;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = j0 + tx + 16 * j;
        if (col < n) {
          S[(ty + RY * i) * lds + col] = acc[i][j];
          st.m[i] = fmaxf(st.m[i], acc[i][j]);
        }
      }
  }

  // after the last k chunk: the 16 threads of a row group hold the row's
  // keys between them
  __device__ static void row_max(State& st, Stats ss, int tid) {
    const int tx = tid % 16, ty = tid / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float m = st.m[i];
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (tx == 0) ss.mx[ty + RY * i] = ss.mx[R + ty + RY * i] = m;
    }
  }

  // out += tile . v over the key quads 4m with m % SPLITS == sp; the sums
  // are multiplied by inv at the end
  __device__ static void pv(State& st, const float* S, Stats, int lds,
                            const T* vs, int j0, int npad, int, int tid) {
    const int cx = tid % CG, ry = (tid / CG) % RY, sp = tid / (CG * RY);
    const int kn = npad - j0 < KC ? npad - j0 : KC;
#pragma unroll 2
    for (int m = sp; m < kn / 4; m += SPLITS) {
      const int k = 4 * m;
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(S + (ry + RY * i) * lds + j0 +
                                                k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(
              vs + (k + kk) * LDK + h * (DMAX / 2) + cx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pk = kk == 0   ? p[i].x
                             : kk == 1 ? p[i].y
                             : kk == 2 ? p[i].z
                                       : p[i].w;
            st.o[i][4 * h + 0] = fmaf(pk, v.x, st.o[i][4 * h + 0]);
            st.o[i][4 * h + 1] = fmaf(pk, v.y, st.o[i][4 * h + 1]);
            st.o[i][4 * h + 2] = fmaf(pk, v.z, st.o[i][4 * h + 2]);
            st.o[i][4 * h + 3] = fmaf(pk, v.w, st.o[i][4 * h + 3]);
          }
        }
      }
    }
  }

  // the key groups' partial sums meet in the score tile's region, added
  // in the order of the groups, then multiplied by inv (or, with SCALE, by
  // scale: the backward's dq); out's row stride is ldo
  template <bool SCALE>
  __device__ static void finish(const State& st, float* part, Stats ss,
                                T* out, int i0, int n, int ldo, int d,
                                int tid, float scale) {
    const int cx = tid % CG, ry = (tid / CG) % RY, sp = tid / (CG * RY);
    __syncthreads();  // every thread is done reading the score tile
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float4*>(part + (sp * R + ry + RY * i) * DMAX +
                                   h * (DMAX / 2) + cx * 4) =
            make_float4(st.o[i][4 * h], st.o[i][4 * h + 1],
                        st.o[i][4 * h + 2], st.o[i][4 * h + 3]);
    __syncthreads();
    for (int e = tid; e < R * d; e += 4 * R) {
      const int r = e / d, col = e % d;
      if (i0 + r >= n) break;  // rows ascend with e
      float s = part[r * DMAX + col];
#pragma unroll
      for (int t = 1; t < SPLITS; ++t) s += part[(t * R + r) * DMAX + col];
      if constexpr (SCALE) {
        out[static_cast<size_t>(i0 + r) * ldo + col] = s * scale;
      } else {
        out[static_cast<size_t>(i0 + r) * ldo + col] = s * ss.inv[r];
      }
    }
  }
};

template <typename T, int DMAX, int R>
using Path = typename std::conditional<std::is_same<T, float>::value,
                                       PathF32<DMAX, R>,
                                       PathBf16<DMAX, R>>::type;

// ---- the training pass: four consecutive keys of a row --------------------

template <typename T>
__device__ inline T to_t(float v);
template <>
__device__ inline float to_t<float>(float v) {
  return v;
}
template <>
__device__ inline __nv_bfloat16 to_t<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ inline float to_f(float v) { return v; }
__device__ inline float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// v[0 .. valid) to dst; `vec` (valid == 4, dst aligned): one access
template <typename T>
__device__ inline void store4(T* dst, const float v[4], int valid, bool vec) {
  if (vec) {
    if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
    }
    return;
  }
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (t < valid) dst[t] = to_t<T>(v[t]);
}

// v[t] = src[t] for t < valid, 0 past it
template <typename T>
__device__ inline void load4(const T* src, float v[4], int valid, bool vec) {
  if (vec) {
    if constexpr (std::is_same<T, float>::value) {
      const float4 u = *reinterpret_cast<const float4*>(src);
      v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(src);
      const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
      const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
      v[0] = __low2float(lo), v[1] = __high2float(lo);
      v[2] = __low2float(hi), v[3] = __high2float(hi);
    }
    return;
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) v[t] = t < valid ? to_f(src[t]) : 0.f;
}

// Row r of the tile holds e = exp(s - max) and `sum` their sum (every lane
// of the warp): p = e / sum goes to the residual in T, and P = round_T(p *
// m) stays in the tile. Lane l takes the key quads l, l + 32, ...
template <typename T>
__device__ void train_row(float* row, float sum, const Args& a, uint64_t rb,
                          uint32_t k0, uint32_t k1, int lane) {
  const int n = a.n, nquads = (n + 3) / 4;
  const bool vec = a.rowvec != 0;
  T* prow = static_cast<T*>(a.p) + rb;
  for (int q = lane; q < nquads; q += 32) {
    const int j = 4 * q;
    const int valid = n - j < 4 ? n - j : 4;
    // the tile's row is padded with zeros to a multiple of 16 keys
    const float4 e = *reinterpret_cast<const float4*>(row + j);
    const float pf[4] = {e.x / sum, e.y / sum, e.z / sum, e.w / sum};
    store4<T>(prow + j, pf, valid, vec);
    float m[4] = {1.f, 1.f, 1.f, 1.f};
    if (a.dropout_mode == 2) {
      bool keep[4];
      philox::keep4(rb + j, k0, k1, a.keep_thresh, keep);
#pragma unroll
      for (int t = 0; t < 4; ++t) m[t] = keep[t] ? a.inv_keep : 0.f;
      if (a.keep_out != nullptr) {
        unsigned char* kb = a.keep_out + rb + j;
        if (vec) {
          *reinterpret_cast<uchar4*>(kb) =
              make_uchar4(keep[0], keep[1], keep[2], keep[3]);
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (t < valid) kb[t] = keep[t] ? 1 : 0;
        }
      }
    } else if (a.dropout_mode == 1) {
      load4<T>(static_cast<const T*>(a.mask) + rb + j, m, valid, vec);
    }
    float pd[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) pd[t] = to_f(to_t<T>(pf[t] * m[t]));
    *reinterpret_cast<float4*>(row + j) = make_float4(pd[0], pd[1], pd[2],
                                                      pd[3]);
  }
}

// One pass over each row of the tile, one warp a row: e = exp(s - max) for
// the n keys, 0 for the padding keys n .. npad that phase 3 reads; then
// inv = 1 / sum e (eval), or the training pass and inv = 1. Rows past n
// (their q rows are zeros) make no residual.
template <typename T, int R, bool TRAIN>
__device__ void softmax_rows(float* S, Stats ss, const Args& a, int lds,
                             int npad, int i0, uint64_t bh, int tid) {
  const int n = a.n, lane = tid % 32;
  uint32_t k0 = 0, k1 = 0;
  if (TRAIN && a.dropout_mode == 2) {
    k0 = static_cast<uint32_t>(a.seed[0]);
    k1 = static_cast<uint32_t>(a.seed[1]);
  }
  for (int r = tid / 32; r < R; r += R / 8) {
    float* row = S + r * lds;
    const float mx = fmaxf(ss.mx[r], ss.mx[R + r]);
    float sum = 0.f;
    for (int j = lane; j < npad; j += 32) {
      const float ex = j < n ? expf(row[j] - mx) : 0.f;
      row[j] = ex;
      sum += ex;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if constexpr (TRAIN) {
      __syncwarp();  // the row's exponentials are in the tile
      if (i0 + r < n)
        train_row<T>(row, sum, a, (bh + i0 + r) * static_cast<uint64_t>(n),
                     k0, k1, lane);
      if (lane == 0) ss.inv[r] = 1.f;
    } else {
      if (lane == 0) ss.inv[r] = 1.f / sum;
    }
  }
}

// ---- the backward's pass: dp in place of s ---------------------------------

// The dropout multiplier m of the four elements e0 .. e0 + 3 of a row-major
// [B, H, N, N] (`valid` of them in the row; `vec`: valid == 4 and aligned):
// drawn again by Philox (mode 2, as the forward drew it), read in T (mode
// 1), or 1 (mode 0).
template <typename T>
__device__ inline void multiplier4(const Args& a, uint64_t e0, int valid,
                                   bool vec, uint32_t k0, uint32_t k1,
                                   float m[4]) {
  if (a.dropout_mode == 2) {
    bool keep[4];
    philox::keep4(e0, k0, k1, a.keep_thresh, keep);
#pragma unroll
    for (int t = 0; t < 4; ++t) m[t] = keep[t] ? a.inv_keep : 0.f;
  } else if (a.dropout_mode == 1) {
    load4<T>(static_cast<const T*>(a.mask) + e0, m, valid, vec);
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) m[t] = 1.f;
  }
}

// One warp a row; row r of the tile holds dp = dout . v^T for the n keys
// (past them, whatever the tile held). Lane l takes the key quads l,
// l + 32, ...: first dp * m back to the tile and delta = sum_j dp * m * p
// (f32), then ds = round_T(p * (dp * m - delta)) to the scratch ds
// [B, H, N, N] and to the tile, 0 for the padding keys n .. npad that
// phase 3 reads; p is read along the row twice (the second time from the
// cache). Rows past n (their dout rows are zeros) hold zeros. inv = 1:
// phase 3 takes the tile as it is.
template <typename T, int R>
__device__ void bwd_rows(float* S, Stats ss, const Args& a, int lds,
                         int npad, int i0, uint64_t bh, int tid) {
  const int n = a.n, lane = tid % 32;
  const int nquads = (n + 3) / 4, pquads = npad / 4;
  const bool vec = a.rowvec != 0;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  uint32_t k0 = 0, k1 = 0;
  if (a.dropout_mode == 2) {
    k0 = static_cast<uint32_t>(a.seed[0]);
    k1 = static_cast<uint32_t>(a.seed[1]);
  }
  for (int r = tid / 32; r < R; r += R / 8) {
    float* row = S + r * lds;
    if (lane == 0) ss.inv[r] = 1.f;
    if (i0 + r >= n) {
      for (int q = lane; q < pquads; q += 32)
        *reinterpret_cast<float4*>(row + 4 * q) = zero;
      continue;
    }
    const uint64_t rb = (bh + i0 + r) * static_cast<uint64_t>(n);
    const T* prow = static_cast<const T*>(a.p) + rb;
    float delta = 0.f;
    for (int q = lane; q < nquads; q += 32) {
      const int j = 4 * q;
      const int valid = n - j < 4 ? n - j : 4;
      const float4 s4 = *reinterpret_cast<const float4*>(row + j);
      float pv[4], m[4];
      load4<T>(prow + j, pv, valid, vec);
      multiplier4<T>(a, rb + j, valid, vec, k0, k1, m);
      float dp[4] = {s4.x * m[0], s4.y * m[1], s4.z * m[2], s4.w * m[3]};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (t >= valid) dp[t] = 0.f;
        delta = fmaf(dp[t], pv[t], delta);
      }
      *reinterpret_cast<float4*>(row + j) = make_float4(dp[0], dp[1], dp[2],
                                                        dp[3]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      delta += __shfl_xor_sync(0xffffffffu, delta, o);
    T* dsrow = static_cast<T*>(a.ds) + rb;
    for (int q = lane; q < pquads; q += 32) {
      const int j = 4 * q;
      const int valid = n - j < 0 ? 0 : (n - j < 4 ? n - j : 4);
      float ds[4] = {0.f, 0.f, 0.f, 0.f};
      if (valid > 0) {
        const float4 d4 = *reinterpret_cast<const float4*>(row + j);
        const float dp[4] = {d4.x, d4.y, d4.z, d4.w};
        float pv[4];
        load4<T>(prow + j, pv, valid, vec);
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (t < valid) ds[t] = to_f(to_t<T>(pv[t] * (dp[t] - delta)));
        store4<T>(dsrow + j, ds, valid, vec);
      }
      *reinterpret_cast<float4*>(row + j) = make_float4(ds[0], ds[1], ds[2],
                                                        ds[3]);
    }
  }
}

// ---- the kernels -----------------------------------------------------------

// one block per (batch, head, R query rows); 4R threads. The forwards
// (MODE kEval, kTrain): the A rows are q (qkv at stride 3C), phase 1
// streams k, phase 3 v, out [B, N, C]. The backward (kBwd): the A rows
// are dout [B, N, C], unscaled; phase 1 streams v (dp = dout . v^T in the
// score tile), the row pass is bwd_rows, phase 3 streams k (ds . k), and
// dq = sums * scale goes to the q third of dqkv [B, N, 3C].
template <typename T, int DMAX, int R, int MODE>
__device__ __forceinline__ void rows_body(const Args& a) {
  using P = Path<T, DMAX, R>;
  constexpr bool BWD = MODE == kBwd;
  constexpr int THREADS = 4 * R, KC = P::KC, LDK = P::LDK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* S = reinterpret_cast<float*>(smem_raw);  // [R][lds] score tile
  const Stats ss{S + a.s_floats, S + a.s_floats + 2 * R};
  T* qs = reinterpret_cast<T*>(S + a.s_floats + 3 * R);  // [R][LDK]
  T* ring = qs + R * LDK;  // nbuf x [KC][LDK]

  const int n = a.n, c = a.c, d = a.d, c3 = 3 * c, lds = a.lds;
  const int nb = a.nbuf;
  const int npad = (n + 15) / 16 * 16;
  const int i0 = blockIdx.x * R, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const bool vec = a.vec != 0;
  const T* base =
      static_cast<const T*>(a.qkv) + static_cast<size_t>(b) * n * c3 + head * d;
  const int nc = (n + KC - 1) / KC;  // chunks of phase 1, then as many of 3
  const int total = 2 * nc;
  // the A rows, and the column offsets of phase 1's and phase 3's chunks
  const int lda = BWD ? c : c3;
  const T* arows =
      BWD ? static_cast<const T*>(a.dout) + static_cast<size_t>(b) * n * c +
                head * d
          : base;
  const int off1 = BWD ? 2 * c : c, off3 = BWD ? c : 2 * c;

  // chunk t (keys (t % nc) * KC .. of phase 1's operand, or of phase 3's
  // from t = nc) into ring slot t % nb; a group is committed even past the
  // end, so that the count of groups in flight stays nb - 1
  auto issue = [&](int t) {
    if (t < total) {
      const int j0 = (t % nc) * KC;
      load_tile<T, THREADS>(ring + (t % nb) * KC * LDK, LDK,
                            base + (t < nc ? off1 : off3) +
                                static_cast<size_t>(j0) * c3,
                            c3, KC, DMAX, n - j0, d, vec, tid);
    }
    cp_async_commit();
  };

  load_tile<T, THREADS>(qs, LDK, arows + static_cast<size_t>(i0) * lda, lda,
                        R, DMAX, n - i0, d, vec, tid);
  issue(0);  // one group: the A rows and chunk 0
  for (int t = 1; t < nb - 1; ++t) issue(t);

  typename P::State st;
  const float scale_t = BWD ? 1.f
                            : (std::is_same<T, float>::value
                                   ? a.scale
                                   : bf16_round(a.scale));
  for (int t = 0; t < total; ++t) {
    cp_async_wait_n(nb > 1 ? nb - 2 : 0);
    __syncthreads();  // chunk t is in; every thread is done with chunk t - 1
    if (t == 0) {
      P::init(st, qs, scale_t, tid);
      __syncthreads();
    }
    if (nb > 1) issue(t + nb - 1);  // into the slot chunk t - 1 used
    const T* cur = ring + (t % nb) * KC * LDK;
    const int j0 = (t % nc) * KC;
    if (t < nc) {
      P::scores(st, S, lds, qs, cur, j0, n, tid);
      if (t == nc - 1) {
        const uint64_t bh = (static_cast<uint64_t>(b) * gridDim.y + head) * n;
        if constexpr (BWD) {
          __syncthreads();  // the dp tile is complete
          bwd_rows<T, R>(S, ss, a, lds, npad, i0, bh, tid);
        } else {
          P::row_max(st, ss, tid);
          __syncthreads();  // the score tile and the row maxima are complete
          softmax_rows<T, R, MODE == kTrain>(S, ss, a, lds, npad, i0, bh,
                                             tid);
        }
      }
    } else {
      P::pv(st, S, ss, lds, cur, j0, npad, d, tid);
    }
    if (nb == 1 && t + 1 < total) {
      __syncthreads();
      issue(t + 1);
    }
  }
  const int ldo = BWD ? c3 : c;
  P::template finish<BWD>(
      st, S, ss,
      static_cast<T*>(a.out) + static_cast<size_t>(b) * n * ldo + head * d,
      i0, n, ldo, d, tid, a.scale);
}

// (f32: min. 1 block an SM, or ptxas holds it to 128 registers and spills
// its tiles; bf16: 2, so that it stays within 128 and two blocks fit)
template <typename T, int DMAX, int R>
__global__ void __launch_bounds__(4 * R, std::is_same<T, float>::value ? 1 : 2)
    sa_eval_kernel(Args a) {
  rows_body<T, DMAX, R, kEval>(a);
}

template <typename T, int DMAX, int R>
__global__ void __launch_bounds__(4 * R, std::is_same<T, float>::value ? 1 : 2)
    sa_train_kernel(Args a) {
  rows_body<T, DMAX, R, kTrain>(a);
}

// part A of the backward (#11): dp, ds and dq
template <typename T, int DMAX, int R>
__global__ void __launch_bounds__(4 * R, std::is_same<T, float>::value ? 1 : 2)
    sa_bwd_rows_kernel(Args a) {
  rows_body<T, DMAX, R, kBwd>(a);
}

// ---- the host side ---------------------------------------------------------

template <typename T, int DMAX, int R>
size_t smem_bytes(int n, int nbuf, int* lds, int* s_floats) {
  using P = Path<T, DMAX, R>;
  // rows of 16 keys, the stride = 8 (mod 16) floats: the float2 reads of
  // the bf16 fragments and the float4 reads of f32 meet no bank twice
  *lds = (n + 15) / 16 * 16 + 8;
  // f32 also holds the key groups' partial sums [SPLITS][R][DMAX] there
  const int part = std::is_same<T, float>::value ? 128 : 0;
  *s_floats = R * (*lds > part ? *lds : part);
  return sizeof(float) * static_cast<size_t>(*s_floats + 3 * R) +
         sizeof(T) * static_cast<size_t>(R + nbuf * P::KC) * P::LDK;
}

// The ring's depth: every chunk of the head in flight at once where the
// SM still holds two blocks (at least four buffers), else as many as one
// block can hold; up to kMaxBuf. 0: the tile does not fit.
template <typename T, int DMAX, int R>
int ring_depth(int n) {
  using P = Path<T, DMAX, R>;
  int lds, sf;
  const long base = static_cast<long>(smem_bytes<T, DMAX, R>(n, 0, &lds, &sf));
  const long slot = static_cast<long>(sizeof(T)) * P::KC * P::LDK;
  const int chunks = 2 * ((n + P::KC - 1) / P::KC);
  const int want = chunks < kMaxBuf ? chunks : kMaxBuf;
  const long two = (kHalfSmem - base) / slot, one = (kMaxSmem - base) / slot;
  if (base <= kHalfSmem && two >= (want < 4 ? want : 4))
    return static_cast<int>(two < want ? two : want);
  if (base > kMaxSmem) return 0;
  return static_cast<int>(one < want ? one : want);
}

// the kernel of the mode; only it is instantiated
template <typename T, int DMAX, int R, int MODE>
constexpr auto rows_kernel() {
  if constexpr (MODE == kBwd) {
    return sa_bwd_rows_kernel<T, DMAX, R>;
  } else if constexpr (MODE == kTrain) {
    return sa_train_kernel<T, DMAX, R>;
  } else {
    return sa_eval_kernel<T, DMAX, R>;
  }
}

template <typename T, int DMAX, int R, int MODE>
int launch_rows(Args a, int nbuf, int batch, cudaStream_t s) {
  const auto kernel = rows_kernel<T, DMAX, R, MODE>();
  const size_t smem = smem_bytes<T, DMAX, R>(a.n, nbuf, &a.lds, &a.s_floats);
  a.nbuf = nbuf;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.n + R - 1) / R, a.heads, batch);
  kernel<<<grid, 4 * R, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// R = 64 where its tile and two chunk buffers fit, else 32
template <typename T, int DMAX, int MODE>
int launch_dmax(const Args& a, int batch, cudaStream_t s) {
  const int nb64 = ring_depth<T, DMAX, 64>(a.n);
  if (nb64 >= 2) return launch_rows<T, DMAX, 64, MODE>(a, nb64, batch, s);
  const int nb32 = ring_depth<T, DMAX, 32>(a.n);
  if (nb32 >= 1) return launch_rows<T, DMAX, 32, MODE>(a, nb32, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The row tiles over a qkv [batch, n, 3c] that is already in memory (and,
// for kBwd, dout); `a` holds everything but the tile's layout (lds,
// s_floats, nbuf) and vec.
template <typename T, int MODE>
int launch_attention(Args a, int batch, cudaStream_t s) {
  a.vec = (a.d * sizeof(T)) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.qkv) % 16 == 0 &&
          (MODE != kBwd || reinterpret_cast<uintptr_t>(a.dout) % 16 == 0);
  if (a.d <= 16) return launch_dmax<T, 16, MODE>(a, batch, s);
  if (a.d <= 32) return launch_dmax<T, 32, MODE>(a, batch, s);
  if (a.d <= 64) return launch_dmax<T, 64, MODE>(a, batch, s);
  if (a.d <= 128) return launch_dmax<T, 128, MODE>(a, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace sa_rows
