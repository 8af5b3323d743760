// The dropout keep mask from counter-based random bits.
//
// Replaces the jax.random.bernoulli draw of paddle_tpu/ops/nn_ops.py
// _dropout (no Pallas kernel: XLA's own random bits there). Element i of the
// mask of one op at step s is kept where
//   mix32(i ^ mix32(key ^ s)) < threshold,
// key = op_key(program seed, op index) and threshold = keep * 2^32 (2^32
// keeps everything), with the mixer of core/registry.py (two multiply /
// xorshift rounds on uint32). The step is read from a device int64, never
// passed by value, so a CUDA graph that captured the launch draws the mask
// of the step it replays. The plain version (ops/kernels/random_bits.py
// keep_mask_reference) computes the same bits with int64 tensor ops.
//
// Bound on an H100: bytes, the mask written once (2 bytes an element in
// bf16: 16.8 MB for the Transformer's [64, 64, 2048] FFN activation,
// 5.0 us at 3.35 TB/s); a dozen integer operations an element are far
// below the card's rate. A grid-stride loop over runs of 4 consecutive
// elements a thread.

#include <stdint.h>

#include "common.cuh"

namespace ptt {

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x21f0aaadu;
  x ^= x >> 15;
  x *= 0x735a2d97u;
  return x ^ (x >> 15);
}

template <typename T>
__device__ __forceinline__ T keep_value(bool on);
template <>
__device__ __forceinline__ float keep_value<float>(bool on) {
  return on ? 1.f : 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 keep_value<__nv_bfloat16>(bool on) {
  return __float2bfloat16(on ? 1.f : 0.f);
}
template <>
__device__ __forceinline__ uint8_t keep_value<uint8_t>(bool on) {
  return on ? 1 : 0;
}

template <typename T>
__global__ void __launch_bounds__(256)
    keep_mask_kernel(T* __restrict__ out, long long n, uint32_t key,
                     const long long* __restrict__ step,
                     unsigned long long threshold) {
  const uint32_t h = mix32(key ^ static_cast<uint32_t>(*step));
  const long long stride = 4LL * gridDim.x * blockDim.x;
  for (long long i0 = 4LL * (blockIdx.x * (long long)blockDim.x +
                             threadIdx.x);
       i0 < n; i0 += stride) {
    T v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = keep_value<T>(mix32(static_cast<uint32_t>(i0 + e) ^ h) <
                           threshold);
    if (i0 + 4 <= n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) out[i0 + e] = v[e];
    } else {
      for (int e = 0; i0 + e < n; ++e) out[i0 + e] = v[e];
    }
  }
}

template <typename T>
cudaError_t launch_keep_mask(void* out, long long n, uint32_t key,
                             const void* step, unsigned long long threshold,
                             cudaStream_t stream) {
  long long blocks = (n + 1023) / 1024;
  if (blocks > 132 * 16) blocks = 132 * 16;
  keep_mask_kernel<T><<<static_cast<int>(blocks), 256, 0, stream>>>(
      static_cast<T*>(out), n, key, static_cast<const long long*>(step),
      threshold);
  return cudaGetLastError();
}

}  // namespace ptt

// out: n contiguous elements of fp32 (dtype 0), bf16 (1) or one byte (2:
// torch.bool), written 1 where kept and 0 where dropped; step: one int64 on
// the device; threshold <= 2^32. Returns the launch's CUDA error.
extern "C" int ptt_keep_mask(void* out, long long n, int dtype, unsigned key,
                             const void* step, unsigned long long threshold,
                             void* stream) {
  if (n < 1 || threshold > (1ULL << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return static_cast<int>(
        ptt::launch_keep_mask<float>(out, n, key, step, threshold, s));
  if (dtype == ptt::kBFloat16)
    return static_cast<int>(ptt::launch_keep_mask<__nv_bfloat16>(
        out, n, key, step, threshold, s));
  if (dtype == 2)
    return static_cast<int>(
        ptt::launch_keep_mask<uint8_t>(out, n, key, step, threshold, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
