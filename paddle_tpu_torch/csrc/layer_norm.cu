// Row layer norm forward, y = (x - mean) * rsqrt(var + eps) * gamma + beta.
//
// Replaces the TPU kernel _ln_kernel / _ln_pallas in
// paddle_tpu/ops/pallas/layer_norm.py (K1).
//
// Bound on an H100: bytes. Each element is read and written once and costs
// about 8 flops, far below the card's 20 flops/byte fp32 balance point. At
// the decode shape [16, 512] fp32 the whole call moves 70 KB, which is
// 0.02 us at 3.35 TB/s: the launch itself (a few us) is the real cost.
//
// Design: one warp per row for d <= 1024 (four rows per 128-thread block),
// one 256-thread block per row above that. Mean and variance are two fp32
// passes over the row (the second pass re-reads x, which is in L1/L2), the
// same arithmetic as the reference's _ln_reference; y is written in x's
// dtype (fp32 or bf16); gamma and beta are fp32.
//
// Left for later: vectorised 16-byte loads, keeping the row in registers
// instead of re-reading it, and fusing the residual add that precedes
// every call on the decode path (or the whole layer into a CUDA graph) to
// get rid of the launch cost.

#include "common.cuh"

namespace ptt {

template <typename T>
__global__ void __launch_bounds__(128)
    ln_warp_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, T* __restrict__ y, int n,
                   int d, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;  // uniform across the warp
  const T* xr = x + (size_t)row * d;
  T* yr = y + (size_t)row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += to_f32(xr[c]);
  const float mean = warp_sum(s) / d;
  float ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float t = to_f32(xr[c]) - mean;
    ss += t * t;
  }
  const float inv = rsqrtf(warp_sum(ss) / d + eps);
  for (int c = lane; c < d; c += 32)
    yr[c] = from_f32<T>((to_f32(xr[c]) - mean) * inv * gamma[c] + beta[c]);
}

// sum of v over the block; every thread gets the total
template <int THREADS>
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  v = warp_sum(v);
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < THREADS / 32 ? red[lane] : 0.f);
}

template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS)
    ln_block_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, T* __restrict__ y, int d,
                    float eps) {
  __shared__ float red[THREADS / 32];
  const T* xr = x + (size_t)blockIdx.x * d;
  T* yr = y + (size_t)blockIdx.x * d;
  float s = 0.f;
  for (int c = threadIdx.x; c < d; c += THREADS) s += to_f32(xr[c]);
  const float mean = block_sum<THREADS>(s, red) / d;
  float ss = 0.f;
  for (int c = threadIdx.x; c < d; c += THREADS) {
    const float t = to_f32(xr[c]) - mean;
    ss += t * t;
  }
  const float inv = rsqrtf(block_sum<THREADS>(ss, red) / d + eps);
  for (int c = threadIdx.x; c < d; c += THREADS)
    yr[c] = from_f32<T>((to_f32(xr[c]) - mean) * inv * gamma[c] + beta[c]);
}

template <typename T>
void launch_ln(const void* x, const void* gamma, const void* beta, void* y,
               int n, int d, float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  T* yt = static_cast<T*>(y);
  if (d <= 1024) {
    constexpr int kThreads = 128;
    constexpr int kRows = kThreads / 32;
    ln_warp_kernel<T><<<(n + kRows - 1) / kRows, kThreads, 0, stream>>>(
        xt, g, b, yt, n, d, eps);
  } else {
    constexpr int kThreads = 256;
    ln_block_kernel<T, kThreads><<<n, kThreads, 0, stream>>>(xt, g, b, yt, d,
                                                             eps);
  }
}

}  // namespace ptt

// x, y: [n, d] contiguous, fp32 (dtype 0) or bf16 (dtype 1); gamma, beta:
// [d] fp32. Returns cudaGetLastError() after the launch.
extern "C" int ptt_layer_norm(const void* x, const void* gamma,
                              const void* beta, void* y, int n, int d,
                              float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32) {
    ptt::launch_ln<float>(x, gamma, beta, y, n, d, eps, s);
  } else if (dtype == ptt::kBFloat16) {
    ptt::launch_ln<__nv_bfloat16>(x, gamma, beta, y, n, d, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
