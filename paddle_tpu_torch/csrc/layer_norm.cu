// Row layer norm: the forward y = (x - mean) * rsqrt(var + eps) * gamma +
// beta, and its backward.
//
// The forward replaces the TPU kernel _ln_kernel / _ln_pallas in
// paddle_tpu/ops/pallas/layer_norm.py (K1); the backward replaces the
// backward half of its custom_vjp, _ln_vjp_bwd (layer_norm.py:91), the VJP
// of _ln_reference: with xhat = (x - mean) * rstd and gg = g * gamma,
//   dx = rstd * (gg - mean(gg) - xhat * mean(gg * xhat)),
//   dgamma = sum over rows of g * xhat,  dbeta = sum over rows of g,
// in fp32, dx in x's dtype, dgamma and dbeta fp32.
//
// Bound on an H100: bytes. Each element is read and written once and costs
// about 8 flops (the backward reads x and g and writes dx: about 12), far
// below the card's 20 flops/byte fp32 balance point. At the decode shape
// [16, 512] fp32 the forward moves 70 KB, 0.02 us at 3.35 TB/s: the launch
// is the real cost. At the Transformer's training shape [4096, 512] fp32 it
// moves 16.8 MB (5.0 us), the backward 25.2 MB (7.5 us).
//
// Forward design: one warp per row for d <= 1024 (four rows per 128-thread
// block), one 256-thread block per row above that. A warp reads its row
// once, with 16-byte loads where the row and the pointers allow them, into
// its slice of shared memory, and takes it into registers in the order the
// reduction needs (lane l holds elements l, l + 32, ...); mean and the
// centered variance are then two passes over registers, and y leaves
// through the same slice with 16-byte stores. The sums keep the order of
// the earlier kernel, which re-read x three times (lane l adds elements l,
// l + 32, ... in turn, then a butterfly over the lanes), and so does the
// arithmetic of y, so y's bits are unchanged. Rows that are not a multiple
// of 16 bytes (or not 16-byte aligned) are loaded element by element into
// the same registers. gamma and beta are fp32; y is in x's dtype.
//
// Backward design, two kernels:
// 1. ln_bwd_rows_kernel: a warp a row at a time (rows r = 4 * (block +
//    k * grid) + warp, for a fixed grid of at most kLnBwdBlocks blocks); it
//    holds x and g in registers as the forward does (d <= 1024; above that
//    one warp a block reads them from memory in each pass), recomputes mean
//    and rstd from the row exactly as the forward does, writes dx, and adds
//    g * xhat and g into per-warp column sums in shared memory. At the end
//    the block adds its warps' sums in warp order and writes one fp32
//    partial row [2, d] (dgamma, dbeta) to a [blocks, 2, d] workspace.
// 2. ln_bwd_cols_kernel adds the partials of every column over the blocks
//    in a fixed order (16 lanes a column, each over every 16th block in
//    turn, then the 16 in lane order). No atomics: two runs give the same
//    bits.
// The TPU kernel's custom_vjp rematerialises the reference under XLA; the
// port's plain version (layer_norm_reference_bwd) does the same under
// autograd, about 25 launches a call.
//
// Left for later: fusing the residual add that precedes every call on the
// decode path (or the whole layer into a CUDA graph) to get rid of the
// launch cost.

#include <stdint.h>

#include "common.cuh"

namespace ptt {

constexpr int kLnRowsPerBlock = 4;  // warps (rows at a time) of a block
constexpr int kLnWarpMaxD = 1024;   // widest row a warp holds in registers
constexpr int kLnBwdBlocks = 256;   // most blocks of the backward's rows
constexpr int kLnColLanes = 16;     // lanes adding one column's partials

// Lane `lane` of a warp loads row[lane + 32 m], m < NPL, into t[m] (0 past
// d). V16: through `buf` (the warp's slice of shared memory, 32 * NPL
// elements) with 16-byte loads; otherwise element by element.
template <typename T, int NPL, bool V16>
__device__ __forceinline__ void ln_load(float (&t)[NPL], const T* row, int d,
                                        int lane, T* buf) {
  if (V16) {
    // every 16-byte load of the lane in flight before the first is used
    constexpr int E = 16 / sizeof(T);
    constexpr int NV = (NPL + E - 1) / E;
    uint4 r[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (32 * k + lane) * E;
      if (c < d) r[k] = __ldg(reinterpret_cast<const uint4*>(row + c));
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (32 * k + lane) * E;
      if (c < d) *reinterpret_cast<uint4*>(buf + c) = r[k];
    }
    __syncwarp();
#pragma unroll
    for (int m = 0; m < NPL; ++m) {
      const int c = lane + 32 * m;
      t[m] = c < d ? to_f32(buf[c]) : 0.f;
    }
    __syncwarp();  // buf may be written again
  } else {
#pragma unroll
    for (int m = 0; m < NPL; ++m) {
      const int c = lane + 32 * m;
      t[m] = c < d ? to_f32(row[c]) : 0.f;
    }
  }
}

// row[lane + 32 m] = v[m] in T for lane + 32 m < d, through `buf` with
// 16-byte stores (V16) or element by element
template <typename T, int NPL, bool V16>
__device__ __forceinline__ void ln_store(T* row, const float (&v)[NPL],
                                         int d, int lane, T* buf) {
  if (V16) {
    constexpr int E = 16 / sizeof(T);
#pragma unroll
    for (int m = 0; m < NPL; ++m) {
      const int c = lane + 32 * m;
      if (c < d) buf[c] = from_f32<T>(v[m]);
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < (NPL + E - 1) / E; ++k) {
      const int c = (32 * k + lane) * E;
      if (c < d)
        *reinterpret_cast<uint4*>(row + c) =
            *reinterpret_cast<const uint4*>(buf + c);
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int m = 0; m < NPL; ++m) {
      const int c = lane + 32 * m;
      if (c < d) row[c] = from_f32<T>(v[m]);
    }
  }
}

// mean and rstd of a row a warp holds as t[m] = x[lane + 32 m]: the sums in
// the order of the earlier three-pass kernel (each lane in m order, then a
// butterfly), the centered variance, the same operations
template <int NPL>
__device__ __forceinline__ void ln_stats(const float (&t)[NPL], int d,
                                         int lane, float eps, float& mean,
                                         float& inv) {
  float s = 0.f;
#pragma unroll
  for (int m = 0; m < NPL; ++m)
    if (lane + 32 * m < d) s += t[m];
  mean = warp_sum(s) / d;
  float ss = 0.f;
#pragma unroll
  for (int m = 0; m < NPL; ++m)
    if (lane + 32 * m < d) {
      const float c = t[m] - mean;
      ss += c * c;
    }
  inv = rsqrtf(warp_sum(ss) / d + eps);
}

template <typename T, int NPL, bool V16>
__global__ void __launch_bounds__(32 * kLnRowsPerBlock)
    ln_warp_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, T* __restrict__ y, int n,
                   int d, float eps) {
  __shared__ __align__(16) T buf[kLnRowsPerBlock][V16 ? 32 * NPL : 1];
  const int warp = threadIdx.x / 32;
  const int row = blockIdx.x * kLnRowsPerBlock + warp;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;  // uniform across the warp
  // gamma and beta are read while x is on its way, not after the stats
  float ga[NPL], be[NPL];
#pragma unroll
  for (int m = 0; m < NPL; ++m) {
    const int c = lane + 32 * m;
    ga[m] = c < d ? gamma[c] : 0.f;
    be[m] = c < d ? beta[c] : 0.f;
  }
  float t[NPL];
  ln_load<T, NPL, V16>(t, x + (size_t)row * d, d, lane, buf[warp]);
  float mean, inv;
  ln_stats<NPL>(t, d, lane, eps, mean, inv);
#pragma unroll
  for (int m = 0; m < NPL; ++m) {
    const int c = lane + 32 * m;
    if (c < d) t[m] = (t[m] - mean) * inv * ga[m] + be[m];
  }
  ln_store<T, NPL, V16>(y + (size_t)row * d, t, d, lane, buf[warp]);
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

// 16-byte accesses for every row: d a multiple of 16 bytes, aligned bases
inline bool ln_v16(const void* a, const void* b, const void* c, int d,
                   int item) {
  return (d * item) % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(c) % 16 == 0;
}

template <typename T, int NPL>
void launch_ln_warp(const T* x, const float* g, const float* b, T* y, int n,
                    int d, float eps, bool v16, cudaStream_t stream) {
  const int grid = (n + kLnRowsPerBlock - 1) / kLnRowsPerBlock;
  if (v16)
    ln_warp_kernel<T, NPL, true><<<grid, 32 * kLnRowsPerBlock, 0, stream>>>(
        x, g, b, y, n, d, eps);
  else
    ln_warp_kernel<T, NPL, false><<<grid, 32 * kLnRowsPerBlock, 0, stream>>>(
        x, g, b, y, n, d, eps);
}

template <typename T>
void launch_ln(const void* x, const void* gamma, const void* beta, void* y,
               int n, int d, float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  T* yt = static_cast<T*>(y);
  const bool v16 = ln_v16(x, y, x, d, sizeof(T));
  if (d <= 128) {
    launch_ln_warp<T, 4>(xt, g, b, yt, n, d, eps, v16, stream);
  } else if (d <= 256) {
    launch_ln_warp<T, 8>(xt, g, b, yt, n, d, eps, v16, stream);
  } else if (d <= 512) {
    launch_ln_warp<T, 16>(xt, g, b, yt, n, d, eps, v16, stream);
  } else if (d <= kLnWarpMaxD) {
    launch_ln_warp<T, 32>(xt, g, b, yt, n, d, eps, v16, stream);
  } else {
    constexpr int kThreads = 256;
    ln_block_kernel<T, kThreads><<<n, kThreads, 0, stream>>>(xt, g, b, yt, d,
                                                             eps);
  }
}

// ------------------------------------------------------------ backward
// NPL > 0: a warp holds x and g of its row in registers (d <= 32 * NPL),
// four warps a block; NPL == 0: one warp a block reads them from memory in
// each pass (any d). Dynamic shared memory: the warps' column sums
// [warps][2][d] fp32, then (V16) the warps' staging slices [warps][d] T.
template <typename T, int NPL, bool V16>
__global__ void __launch_bounds__(32 * kLnRowsPerBlock)
    ln_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                       const float* __restrict__ gamma, T* __restrict__ dx,
                       float* __restrict__ part, int n, int d, float eps) {
  extern __shared__ __align__(16) float smem_ln[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* acc_g = smem_ln + (size_t)warp * 2 * d;  // sum g * xhat
  float* acc_b = acc_g + d;                        // sum g
  T* buf = reinterpret_cast<T*>(smem_ln + (size_t)warps * 2 * d) +
           (size_t)warp * d;
  for (int c = lane; c < d; c += 32) acc_g[c] = acc_b[c] = 0.f;
  constexpr int P = NPL > 0 ? NPL : 1;
  float ga[P];  // gamma of the lane's columns, for every row
#pragma unroll
  for (int m = 0; m < P; ++m) {
    const int c = lane + 32 * m;
    ga[m] = NPL > 0 && c < d ? gamma[c] : 0.f;
  }

  for (int r0 = blockIdx.x * warps; r0 < n; r0 += gridDim.x * warps) {
    const int row = r0 + warp;
    if (row >= n) break;  // uniform across the warp
    const T* xr = x + (size_t)row * d;
    const T* gr = gy + (size_t)row * d;
    T* dr = dx + (size_t)row * d;
    if (NPL > 0) {
      float t[P], gv[P];
      ln_load<T, P, V16>(t, xr, d, lane, buf);
      ln_load<T, P, V16>(gv, gr, d, lane, buf);
      float mean, inv;
      ln_stats<P>(t, d, lane, eps, mean, inv);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int m = 0; m < P; ++m) {
        const int c = lane + 32 * m;
        if (c < d) {
          t[m] = (t[m] - mean) * inv;  // xhat
          acc_g[c] += gv[m] * t[m];
          acc_b[c] += gv[m];
          gv[m] *= ga[m];  // gg
          s1 += gv[m];
          s2 += gv[m] * t[m];
        }
      }
      const float a1 = warp_sum(s1) / d;
      const float a2 = warp_sum(s2) / d;
#pragma unroll
      for (int m = 0; m < P; ++m) t[m] = inv * (gv[m] - a1 - t[m] * a2);
      ln_store<T, P, V16>(dr, t, d, lane, buf);
    } else {
      // every pass reads the row from memory (L1 / L2 after the first)
      float s = 0.f;
      for (int c = lane; c < d; c += 32) s += to_f32(xr[c]);
      const float mean = warp_sum(s) / d;
      float ss = 0.f;
      for (int c = lane; c < d; c += 32) {
        const float cv = to_f32(xr[c]) - mean;
        ss += cv * cv;
      }
      const float inv = rsqrtf(warp_sum(ss) / d + eps);
      float s1 = 0.f, s2 = 0.f;
      for (int c = lane; c < d; c += 32) {
        const float xh = (to_f32(xr[c]) - mean) * inv;
        const float gf = to_f32(gr[c]);
        acc_g[c] += gf * xh;
        acc_b[c] += gf;
        const float gg = gf * gamma[c];
        s1 += gg;
        s2 += gg * xh;
      }
      const float a1 = warp_sum(s1) / d;
      const float a2 = warp_sum(s2) / d;
      for (int c = lane; c < d; c += 32) {
        const float xh = (to_f32(xr[c]) - mean) * inv;
        const float gg = to_f32(gr[c]) * gamma[c];
        dr[c] = from_f32<T>(inv * (gg - a1 - xh * a2));
      }
    }
  }
  __syncthreads();
  // the block's partial: its warps' sums added in warp order
  float* out = part + (size_t)blockIdx.x * 2 * d;
  for (int c = threadIdx.x; c < 2 * d; c += blockDim.x) {
    float v = 0.f;
    for (int w = 0; w < warps; ++w) v += smem_ln[(size_t)w * 2 * d + c];
    out[c] = v;
  }
}

// dgamma[c], dbeta[c]: the blocks' partials of column c added in a fixed
// order: lane k of the column's 16 adds blocks k, k + 16, ... in turn, then
// the 16 are added in lane order. Blocks of 32 columns x 16 lanes.
__global__ void __launch_bounds__(32 * kLnColLanes)
    ln_bwd_cols_kernel(const float* __restrict__ part,
                       float* __restrict__ dgamma, float* __restrict__ dbeta,
                       int blocks, int d) {
  __shared__ float red[2][kLnColLanes][33];
  const int cx = threadIdx.x % 32;
  const int k = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + cx;
  float sg = 0.f, sb = 0.f;
  if (c < d)
    for (int b = k; b < blocks; b += kLnColLanes) {
      sg += part[((size_t)b * 2) * d + c];
      sb += part[((size_t)b * 2 + 1) * d + c];
    }
  red[0][k][cx] = sg;
  red[1][k][cx] = sb;
  __syncthreads();
  if (k == 0 && c < d) {
    float tg = 0.f, tb = 0.f;
    for (int j = 0; j < kLnColLanes; ++j) {
      tg += red[0][j][cx];
      tb += red[1][j][cx];
    }
    dgamma[c] = tg;
    dbeta[c] = tb;
  }
}

// the row kernel's launch: blocks, threads, dynamic shared memory
struct LnBwdPlan {
  int blocks, threads;
  size_t smem;
};

inline LnBwdPlan ln_bwd_plan(int n, int d, int item, bool v16) {
  LnBwdPlan p;
  const int warps = d <= kLnWarpMaxD ? kLnRowsPerBlock : 1;
  p.threads = 32 * warps;
  const int groups = (n + warps - 1) / warps;
  p.blocks = groups < kLnBwdBlocks ? groups : kLnBwdBlocks;
  if (p.blocks < 1) p.blocks = 1;
  p.smem = sizeof(float) * 2 * (size_t)warps * d +
           (v16 && d <= kLnWarpMaxD ? (size_t)warps * d * item : 0);
  return p;
}

template <typename T, int NPL, bool V16>
cudaError_t launch_ln_bwd_rows(const T* x, const T* gy, const float* gamma,
                               T* dx, float* part, int n, int d, float eps,
                               const LnBwdPlan& p, cudaStream_t stream) {
  auto kernel = ln_bwd_rows_kernel<T, NPL, V16>;
  if (p.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<p.blocks, p.threads, p.smem, stream>>>(x, gy, gamma, dx, part, n,
                                                  d, eps);
  return cudaGetLastError();
}

template <typename T, int NPL>
cudaError_t ln_bwd_rows_v(const T* x, const T* gy, const float* gamma, T* dx,
                          float* part, int n, int d, float eps,
                          const LnBwdPlan& p, bool v16, cudaStream_t stream) {
  return v16 ? launch_ln_bwd_rows<T, NPL, true>(x, gy, gamma, dx, part, n, d,
                                                eps, p, stream)
             : launch_ln_bwd_rows<T, NPL, false>(x, gy, gamma, dx, part, n,
                                                 d, eps, p, stream);
}

template <typename T>
cudaError_t launch_ln_bwd(const void* x, const void* gy, const void* gamma,
                          void* dx, void* dgamma, void* dbeta, void* work,
                          int n, int d, float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(gy);
  const float* g = static_cast<const float*>(gamma);
  T* dt = static_cast<T*>(dx);
  float* part = static_cast<float*>(work);
  const bool v16 = ln_v16(x, gy, dx, d, sizeof(T));
  const LnBwdPlan p = ln_bwd_plan(n, d, sizeof(T), v16);
  cudaError_t err;
  if (d <= 128)
    err = ln_bwd_rows_v<T, 4>(xt, gt, g, dt, part, n, d, eps, p, v16, stream);
  else if (d <= 256)
    err = ln_bwd_rows_v<T, 8>(xt, gt, g, dt, part, n, d, eps, p, v16, stream);
  else if (d <= 512)
    err = ln_bwd_rows_v<T, 16>(xt, gt, g, dt, part, n, d, eps, p, v16,
                               stream);
  else if (d <= kLnWarpMaxD)
    err = ln_bwd_rows_v<T, 32>(xt, gt, g, dt, part, n, d, eps, p, v16,
                               stream);
  else
    err = launch_ln_bwd_rows<T, 0, false>(xt, gt, g, dt, part, n, d, eps, p,
                                          stream);
  if (err != cudaSuccess) return err;
  ln_bwd_cols_kernel<<<(d + 31) / 32, 32 * kLnColLanes, 0, stream>>>(
      part, static_cast<float*>(dgamma), static_cast<float*>(dbeta),
      p.blocks, d);
  return cudaGetLastError();
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

// fp32 floats of workspace ptt_layer_norm_bwd needs for [n, d] rows (the
// row kernel's partials [blocks, 2, d]).
extern "C" long long ptt_layer_norm_bwd_workspace(int n, int d) {
  const ptt::LnBwdPlan p = ptt::ln_bwd_plan(n, d, 4, false);
  return 2LL * p.blocks * d;
}

// x, gy, dx: [n, d] contiguous, fp32 (dtype 0) or bf16 (dtype 1), n >= 1;
// gamma: [d] fp32; dgamma, dbeta: [d] fp32 outputs; work:
// ptt_layer_norm_bwd_workspace(n, d) fp32 floats. Two launches (rows, then
// columns); returns the first error.
extern "C" int ptt_layer_norm_bwd(const void* x, const void* gy,
                                  const void* gamma, void* dx, void* dgamma,
                                  void* dbeta, void* work, int n, int d,
                                  float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == ptt::kFloat32)
    return static_cast<int>(ptt::launch_ln_bwd<float>(
        x, gy, gamma, dx, dgamma, dbeta, work, n, d, eps, s));
  if (dtype == ptt::kBFloat16)
    return static_cast<int>(ptt::launch_ln_bwd<__nv_bfloat16>(
        x, gy, gamma, dx, dgamma, dbeta, work, n, d, eps, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
