// Dropout from counter-based random bits: the keep mask, and dropout itself
// with the bits drawn in registers.
//
// Replaces the jax.random.bernoulli draw of paddle_tpu/ops/nn_ops.py
// _dropout and the `x * mask` / `where(mask, x / keep, 0)` around it (no
// Pallas kernel: XLA's own random bits and elementwise ops there). Element i
// of one dropout site at step s is kept where
//   mix32(i ^ mix32(key ^ s)) < threshold,
// key = op_key(program seed, op index) (mixed with the layer and site in
// the layer stack) and threshold = keep * 2^32 (2^32 keeps everything), with
// the mixer of core/registry.py (two multiply / xorshift rounds on uint32).
// The step is read from a device int64, never passed by value, so a CUDA
// graph that captured the launch draws the bits of the step it replays. The
// plain versions (ops/kernels/random_bits.py) compute the same bits with
// int64 tensor ops.
//
// dropout_kernel applies a site's dropout to x (or to its gradient dy) and
// never writes the mask: the forward draws the bits, the backward draws them
// again from the same (key, step), so a training step neither writes, reads
// nor saves a tensor of x's size for them. Its four ops are the roundings of
// the torch expressions they replace, as torch computes them on the card (a
// division by a Python scalar is a product with its fp32 reciprocal there,
// and bf16 arithmetic runs in fp32, rounded once an operation), each product
// a real multiply (__fmul_rn), so signed zeros, inf and NaN come out as
// torch's:
//   kOpMul      x * m                   (downgrade_in_infer, both ways)
//   kOpMulDiv   (x * m) / keep          (upscale_in_train, forward)
//   kOpDivMul   (dy / keep) * m         (upscale_in_train, backward)
//   kOpWhereDiv m ? x / keep : +0       (the attention output, both ways)
//
// Bound on an H100: bytes. dropout reads x and writes y once (2 bytes an
// element each in bf16: 33.6 MB for the Transformer's [64, 64, 2048] FFN
// activation, 10.0 us at 3.35 TB/s); the keep mask writes its mask once.
// A dozen integer operations an element are far below the card's rate. So a
// thread moves 16 bytes a load and a store (8 bf16, 4 fp32, 16 bool),
// neighbouring threads on neighbouring addresses, its bits computed from the
// flat index in registers; the grid covers every vector (a grid-stride loop
// only past 2^31 blocks), so no SM idles, and the ragged tail is masked.

#include <stdint.h>

#include "common.cuh"

namespace ptt {

constexpr int kOpMul = 0;
constexpr int kOpMulDiv = 1;
constexpr int kOpDivMul = 2;
constexpr int kOpWhereDiv = 3;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x21f0aaadu;
  x ^= x >> 15;
  x *= 0x735a2d97u;
  return x ^ (x >> 15);
}

__device__ __forceinline__ bool kept(long long i, uint32_t h,
                                     unsigned long long threshold) {
  return mix32(static_cast<uint32_t>(i) ^ h) < threshold;
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

// the bits of 1 in T, placed by keep_mask_kernel in the 32-bit words of a
// 16-byte store (built in registers: an array of T would live in local
// memory)
template <typename T>
__device__ __forceinline__ uint32_t one_bits();
template <>
__device__ __forceinline__ uint32_t one_bits<float>() {
  return 0x3f800000u;
}
template <>
__device__ __forceinline__ uint32_t one_bits<__nv_bfloat16>() {
  return 0x3f80u;
}
template <>
__device__ __forceinline__ uint32_t one_bits<uint8_t>() {
  return 1u;
}

// the blocks of kThreads threads that give every vector of V elements a
// thread (at most 2^31 - 1: the kernels loop past it)
inline int grid_for(long long n, int v) {
  long long blocks = ((n + v - 1) / v + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 2147483647LL ? blocks : 2147483647LL);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    keep_mask_kernel(T* __restrict__ out, long long n, uint32_t key,
                     const long long* __restrict__ step,
                     unsigned long long threshold) {
  constexpr int V = 16 / sizeof(T);
  const uint32_t h = mix32(key ^ static_cast<uint32_t>(*step));
  const long long stride = static_cast<long long>(V) * gridDim.x * kThreads;
  for (long long i0 = static_cast<long long>(V) *
                      (blockIdx.x * static_cast<long long>(kThreads) +
                       threadIdx.x);
       i0 < n; i0 += stride) {
    if (i0 + V <= n) {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (kept(i0 + e, h, threshold))
          w[e * sizeof(T) / 4] |= one_bits<T>()
                                  << (8 * (e * sizeof(T) % 4));
      *reinterpret_cast<uint4*>(out + i0) =
          make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      for (int e = 0; i0 + e < n; ++e)
        out[i0 + e] = keep_value<T>(kept(i0 + e, h, threshold));
    }
  }
}

template <typename T, int OP>
__device__ __forceinline__ T drop_one(T v, bool on, float inv) {
  const float x = to_f32(v);
  const float m = on ? 1.f : 0.f;
  if (OP == kOpMul) return from_f32<T>(__fmul_rn(x, m));
  if (OP == kOpMulDiv)
    return from_f32<T>(__fmul_rn(round_as<T>(__fmul_rn(x, m)), inv));
  if (OP == kOpDivMul)
    return from_f32<T>(__fmul_rn(round_as<T>(__fmul_rn(x, inv)), m));
  return on ? from_f32<T>(__fmul_rn(x, inv)) : from_f32<T>(0.f);
}

// y = OP(x, keep bits); vec: x and y both 16-byte aligned (else every
// element is loaded and stored on its own)
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                   uint32_t key, const long long* __restrict__ step,
                   unsigned long long threshold, float inv, bool vec) {
  constexpr int V = 16 / sizeof(T);
  const uint32_t h = mix32(key ^ static_cast<uint32_t>(*step));
  const long long stride = static_cast<long long>(V) * gridDim.x * kThreads;
  for (long long i0 = static_cast<long long>(V) *
                      (blockIdx.x * static_cast<long long>(kThreads) +
                       threadIdx.x);
       i0 < n; i0 += stride) {
    const bool whole = vec && i0 + V <= n;
    alignas(16) T v[V];
    if (whole) {
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(x + i0);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = i0 + e < n ? x[i0 + e] : x[i0];
    }
#pragma unroll
    for (int e = 0; e < V; ++e)
      v[e] = drop_one<T, OP>(v[e], kept(i0 + e, h, threshold), inv);
    if (whole) {
      *reinterpret_cast<uint4*>(y + i0) = *reinterpret_cast<const uint4*>(v);
    } else {
      for (int e = 0; e < V && i0 + e < n; ++e) y[i0 + e] = v[e];
    }
  }
}

template <typename T>
cudaError_t launch_keep_mask(void* out, long long n, uint32_t key,
                             const void* step, unsigned long long threshold,
                             cudaStream_t stream) {
  keep_mask_kernel<T><<<grid_for(n, 16 / sizeof(T)), kThreads, 0, stream>>>(
      static_cast<T*>(out), n, key, static_cast<const long long*>(step),
      threshold);
  return cudaGetLastError();
}

template <typename T, int OP>
cudaError_t launch_dropout_op(const void* x, void* y, long long n,
                              uint32_t key, const void* step,
                              unsigned long long threshold, float inv,
                              cudaStream_t stream) {
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  dropout_kernel<T, OP><<<grid_for(n, 16 / sizeof(T)), kThreads, 0,
                          stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, key,
      static_cast<const long long*>(step), threshold, inv, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dropout(const void* x, void* y, long long n, int op,
                           uint32_t key, const void* step,
                           unsigned long long threshold, float inv,
                           cudaStream_t s) {
  switch (op) {
    case kOpMul:
      return launch_dropout_op<T, kOpMul>(x, y, n, key, step, threshold, inv,
                                          s);
    case kOpMulDiv:
      return launch_dropout_op<T, kOpMulDiv>(x, y, n, key, step, threshold,
                                             inv, s);
    case kOpDivMul:
      return launch_dropout_op<T, kOpDivMul>(x, y, n, key, step, threshold,
                                             inv, s);
    case kOpWhereDiv:
      return launch_dropout_op<T, kOpWhereDiv>(x, y, n, key, step, threshold,
                                               inv, s);
  }
  return cudaErrorInvalidValue;
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

// y = op(x, keep bits of (key, *step)) over n contiguous fp32 (dtype 0) or
// bf16 (1) elements; op 0 mul, 1 mul then div, 2 div then mul, 3 where div
// (the ops above); inv: the fp32 reciprocal of keep (torch's for a division
// by the Python scalar keep); threshold <= 2^32. Returns the launch's CUDA
// error.
extern "C" int ptt_dropout(const void* x, void* y, long long n, int dtype,
                           int op, unsigned key, const void* step,
                           unsigned long long threshold, float inv,
                           void* stream) {
  if (n < 1 || threshold > (1ULL << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return static_cast<int>(ptt::launch_dropout<float>(
        x, y, n, op, key, step, threshold, inv, s));
  if (dtype == ptt::kBFloat16)
    return static_cast<int>(ptt::launch_dropout<__nv_bfloat16>(
        x, y, n, op, key, step, threshold, inv, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
