// The dropout-mask generator of the transformer stacks: writes the
// {0, 1/(1-rate)} mask of n elements in T, element e kept iff word e % 4
// of Philox group e / 4 under the two seed words is < keep_thresh
// (philox.cuh). Replaces the TPU kernel `_mask_kernel` behind
// `prng_dropout_mask` (gdl_tpu/ops/dropout.py), which seeds the TPU's own
// generator per grid block: its bits cannot be reproduced, its rule
// (unsigned compare against round((1-rate) * 2^32), values exactly 0 and
// 1/(1-rate) rounded to T) is kept. The multiply x * mask stays outside,
// as there.
//
// What bounds it. The bytes: n elements written once, nothing read but
// two words. In bf16 the instructions come close behind: a Philox group
// is 19 32x32->64 products (the first round multiplies one word, the
// counter's upper words being 0) and about 20 three-way xors for 8 bytes
// written. The first design (one thread a group, a grid of groups / 256
// blocks: 95 waves of blocks starting and retiring on each SM at
// [25088, 4096]) issued about 94 instructions a group, 20 of them key
// additions and many of the rest 64-bit counter and index arithmetic, and
// wrote bf16 no faster than f32: its instructions set its pace.
//
// Design. A resident grid (the SMs times the blocks an SM holds) walks
// the mask in 16-byte stores, consecutive threads on consecutive stores:
// a thread takes four Philox groups a round, as four f32 stores or two
// bf16 ones (two groups a store), and carries their four chains at once,
// interleaved round by round so that their products overlap. The ten
// round keys are computed once, before the walk (they live in uniform
// registers). Where n < 2^32 the counter is one 32-bit word (its upper
// word is 0) and so is every index. A group then costs about 52
// instructions: 18 IMAD.WIDE, 21 LOP3, 4 compares and 4 selects, the
// rest shared by the round. The stores that do not fill a round, and the
// last n % (16 / sizeof(T)) elements, are written apart after the walk.
//
// Plain C interface: `out` and `seed` are device pointers, `stream` a
// cudaStream_t; dtype 0 = float32, 1 = bfloat16. `out` must be 16-byte
// aligned (as the allocator's are). Returns the error code of
// cudaGetLastError() after the launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 4;  // Philox groups a thread carries at once

// element type -> its bits and how many make a 16-byte store
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kPerStore = 4;
  static uint32_t bits(float v) {
    uint32_t u;
    __builtin_memcpy(&u, &v, 4);
    return u;
  }
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPerStore = 8;
  static uint32_t bits(float v) {
    const __nv_bfloat16 b = __float2bfloat16_rn(v);
    uint16_t u;
    __builtin_memcpy(&u, &b, 2);
    return u;
  }
};

struct Keys {
  uint32_t k0[10], k1[10];
};

// Philox4x32-10 (philox.cuh's philox4x32_10) of K groups at once, the
// counters (lo32(group), hi32(group), 0, 0), their rounds interleaved
template <int K, typename Index>
__device__ __forceinline__ void philox_groups(const Index (&group)[K],
                                              const Keys& key,
                                              uint32_t (&w)[K][4]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    w[j][0] = static_cast<uint32_t>(group[j]);
    w[j][1] = sizeof(Index) > 4
                  ? static_cast<uint32_t>(static_cast<uint64_t>(group[j]) >> 32)
                  : 0u;
    w[j][2] = 0u;
    w[j][3] = 0u;
  }
#pragma unroll
  for (int r = 0; r < 10; ++r) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const uint32_t c0 = w[j][0], c1 = w[j][1], c2 = w[j][2], c3 = w[j][3];
      const uint32_t hi0 = __umulhi(philox::kM0, c0), lo0 = philox::kM0 * c0;
      const uint32_t hi1 = __umulhi(philox::kM1, c2), lo1 = philox::kM1 * c2;
      w[j][0] = hi1 ^ c1 ^ key.k0[r];
      w[j][1] = lo1;
      w[j][2] = hi0 ^ c3 ^ key.k1[r];
      w[j][3] = lo0;
    }
  }
}

// the 16-byte store of groups [g0, g0 + G) (G = 1 in f32, 2 in bf16)
template <typename T, int G>
__device__ __forceinline__ uint4 pack(const uint32_t (*w)[4], uint32_t thresh,
                                      uint32_t kept) {
  uint32_t v[4];
  if constexpr (G == 1) {
#pragma unroll
    for (int t = 0; t < 4; ++t) v[t] = w[0][t] < thresh ? kept : 0u;
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint32_t* q = w[t / 2];
      const int e = 2 * (t % 2);
      v[t] = (q[e] < thresh ? kept : 0u) | ((q[e + 1] < thresh ? kept : 0u)
                                            << 16);
    }
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

template <typename T, typename Index>
__global__ void __launch_bounds__(kThreads)
dropout_mask_kernel(T* __restrict__ out, Index n,
                    const int* __restrict__ seed, uint32_t keep_thresh,
                    uint32_t kept_bits) {
  constexpr int E = Elem<T>::kPerStore;  // elements a store
  constexpr int G = E / 4;               // groups a store
  constexpr int S = kChains / G;         // stores a thread a round
  Keys key;
  key.k0[0] = static_cast<uint32_t>(seed[0]);
  key.k1[0] = static_cast<uint32_t>(seed[1]);
#pragma unroll
  for (int r = 1; r < 10; ++r) {
    key.k0[r] = key.k0[r - 1] + philox::kW0;
    key.k1[r] = key.k1[r - 1] + philox::kW1;
  }
  uint4* __restrict__ dst = reinterpret_cast<uint4*>(out);
  const Index stores = n / E;
  const Index stride = static_cast<Index>(gridDim.x) * kThreads;
  const Index tid = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x;
  // rounds that every thread of the grid fills: S stores a thread each
  const Index full = stores / (stride * S) * (stride * S);
  for (Index base = tid; base < full; base += stride * S) {
    Index group[kChains];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int q = 0; q < G; ++q)
        group[s * G + q] = (base + s * stride) * G + q;
    uint32_t w[kChains][4];
    philox_groups<kChains, Index>(group, key, w);
#pragma unroll
    for (int s = 0; s < S; ++s)
      dst[base + s * stride] = pack<T, G>(w + s * G, keep_thresh, kept_bits);
  }
  // the stores left over, one a thread at a time
  for (Index st = full + tid; st < stores; st += stride) {
    Index group[G];
#pragma unroll
    for (int q = 0; q < G; ++q) group[q] = st * G + q;
    uint32_t w[G][4];
    philox_groups<G, Index>(group, key, w);
    dst[st] = pack<T, G>(w, keep_thresh, kept_bits);
  }
  // the last n % E elements (at most G groups), by the grid's thread 0
  if (tid == 0) {
    for (Index k = 0; k < n - stores * E; k += 4) {
      const Index e0 = stores * E + k;
      Index group[1] = {e0 / 4};
      uint32_t w[1][4];
      philox_groups<1, Index>(group, key, w);
      uint16_t* o16 = reinterpret_cast<uint16_t*>(out);
      uint32_t* o32 = reinterpret_cast<uint32_t*>(out);
      for (int t = 0; t < 4 && e0 + t < n; ++t) {
        const uint32_t v = w[0][t] < keep_thresh ? kept_bits : 0u;
        if constexpr (sizeof(T) == 4) {
          o32[e0 + t] = v;
        } else {
          o16[e0 + t] = static_cast<uint16_t>(v);
        }
      }
    }
  }
}

// the resident grid on the current device: its SMs times the blocks of
// this kernel an SM holds (the same on every device of a process)
template <typename T, typename Index>
cudaError_t resident_blocks(int* blocks) {
  static int per_sm = 0;
  cudaError_t err = cudaSuccess;
  if (per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dropout_mask_kernel<T, Index>, kThreads, 0);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  return err;
}

template <typename T, typename Index>
int launch_as(void* out, uint64_t n, const void* seed, unsigned keep_thresh,
              uint32_t kept_bits, cudaStream_t stream) {
  constexpr uint64_t per_block =
      static_cast<uint64_t>(kThreads) * kChains * 4;  // elements a round
  int resident = 0;
  const cudaError_t err = resident_blocks<T, Index>(&resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  uint64_t blocks = (n + per_block - 1) / per_block;
  if (blocks > static_cast<uint64_t>(resident)) blocks = resident;
  dropout_mask_kernel<T, Index>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<T*>(out), static_cast<Index>(n),
          static_cast<const int*>(seed), keep_thresh, kept_bits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(void* out, uint64_t n, const void* seed, unsigned keep_thresh,
           float inv_keep, cudaStream_t stream) {
  if (n == 0) return 0;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const uint32_t kept = Elem<T>::bits(inv_keep);
  // a 32-bit counter and indices while every element index fits in 32 bits
  if (n < (uint64_t{1} << 32))
    return launch_as<T, uint32_t>(out, n, seed, keep_thresh, kept, stream);
  return launch_as<T, uint64_t>(out, n, seed, keep_thresh, kept, stream);
}

}  // namespace

extern "C" int gdl_dropout_mask_launch(void* out, long long n,
                                       const void* seed,
                                       unsigned keep_thresh, float inv_keep,
                                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint64_t count = static_cast<uint64_t>(n);
  if (dtype == 0) return launch<float>(out, count, seed, keep_thresh, inv_keep, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(out, count, seed, keep_thresh, inv_keep, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
