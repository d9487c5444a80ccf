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
// Bound by bytes: n elements written once, nothing read but two words.
// One thread per Philox group: ten rounds of two 32x32->64 multiplies buy
// four elements, stored as one 16-byte (f32) or 8-byte (bf16) write.
//
// Plain C interface: `out` and `seed` are device pointers, `stream` a
// cudaStream_t; dtype 0 = float32, 1 = bfloat16. Returns the error code
// of cudaGetLastError() after the launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

__device__ inline float to_t(float v, float*) { return v; }
__device__ inline __nv_bfloat16 to_t(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_mask_kernel(T* __restrict__ out, uint64_t n,
                    const int* __restrict__ seed, uint32_t keep_thresh,
                    float inv_keep) {
  const uint32_t k0 = static_cast<uint32_t>(seed[0]);
  const uint32_t k1 = static_cast<uint32_t>(seed[1]);
  const T kept = to_t(inv_keep, static_cast<T*>(nullptr));
  const T zero = to_t(0.f, static_cast<T*>(nullptr));
  const uint64_t groups = (n + 3) / 4;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kThreads;
  for (uint64_t g = static_cast<uint64_t>(blockIdx.x) * kThreads + threadIdx.x;
       g < groups; g += stride) {
    const philox::U4 w = philox::group_words(g, k0, k1);
    alignas(16) T v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) v[t] = w.v[t] < keep_thresh ? kept : zero;
    const uint64_t e0 = 4 * g;
    if (e0 + 4 <= n) {
      // `out` comes from the allocator, so group g is aligned to 4 * sizeof(T)
      if (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(out + e0) =
            *reinterpret_cast<const float4*>(v);
      } else {
        *reinterpret_cast<uint2*>(out + e0) =
            *reinterpret_cast<const uint2*>(v);
      }
    } else {
      for (int t = 0; e0 + t < n; ++t) out[e0 + t] = v[t];
    }
  }
}

template <typename T>
int launch(void* out, uint64_t n, const void* seed, unsigned keep_thresh,
           float inv_keep, cudaStream_t stream) {
  const uint64_t groups = (n + 3) / 4;
  uint64_t blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > (1u << 20)) blocks = 1u << 20;  // the rest by the stride loop
  if (blocks == 0) return 0;
  dropout_mask_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<T*>(out), n, static_cast<const int*>(seed), keep_thresh,
      inv_keep);
  return static_cast<int>(cudaGetLastError());
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
