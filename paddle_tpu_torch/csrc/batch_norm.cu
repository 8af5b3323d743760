// Training batch-norm forward: per-channel fp32 mean and biased variance
// over every element of the channel, then y = x * a + b with
// a = gamma * rsqrt(var + eps) and b = beta - mean * a.
//
// Replaces the TPU kernel _bn_kernel / _fused_bn_fwd in
// paddle_tpu/ops/pallas/batch_norm.py (K5). The backward is the closed
// form of _bn_vjp_bwd in PyTorch (ops/kernels/batch_norm.py), as the TPU
// has no backward kernel either.
//
// Bound on an H100: bytes. The function reads x once and writes y once
// (about 6 flops an element), far below the card's balance point. At
// ResNet-50's stem, [802,816 rows, 64] bf16, that is 205 MB, 0.061 ms at
// 3.35 TB/s; the whole network's 53 calls a step move 2.71 GB, 0.81 ms.
// This kernel reads x twice (statistics, then normalize), 1.5x the bound
// in bytes at best; keeping x on chip between the passes is left for
// later.
//
// Design. The Pallas kernel carries sum / sumsq in VMEM from one
// sequential grid step to the next; blocks on the card run in parallel,
// so the statistics are a split reduction in three launches:
//   1. stats: a grid of (row chunk x channel tile) blocks; each block sums
//      x and x^2 in fp32 over its rows for its channels and writes one row
//      of partials to a workspace [chunks, C]. The chunk count depends only
//      on the shape (about 8 blocks an SM for the stem, which is one
//      channel tile wide), so there are no atomics and the sums are the
//      same from run to run.
//   2. finalize: eight threads a channel add the partials in a fixed
//      order and write mean, var = max(E[x^2] - mean^2, 0) (the
//      reference's one-pass form and clamp) and a, b.
//   3. normalize: y = x * a + b with 16-byte loads and stores. For bf16, a
//      and b are rounded to bf16 first, then the product and the sum are
//      each rounded to bf16: the Pallas kernel's rounding points
//      (batch_norm.py:92-94). __fmul_rn / __fadd_rn keep nvcc from
//      contracting them into one fma.
// x is the [N, C, S] view of the activation (S = H*W, or 1 for [N, C]) in
// one of two dense orders, so neither NHWC nor NCHW costs a transpose:
//   rows   (channels_last = 1): element (n, c, s) at (n*S + s)*C + c;
//   planes (channels_last = 0): element (n, c, s) at (n*C + c)*S + s.
// Any N*S >= 1 and any C (the Pallas kernel wants rows % 8 == 0 and C < 128
// or a multiple of 128): 16-byte vectors where the contiguous axis and
// the pointers allow them, one element a thread otherwise.

#include <stdint.h>

#include "common.cuh"

namespace ptt {

constexpr int kBnThreads = 256;
constexpr int kBnTargetBlocks = 132 * 8;  // 8 blocks of 256 on each SM

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// the launch geometry, a function of the shape and the pointers' alignment
struct BnPlan {
  int vec;          // elements a thread loads at once along the contiguous axis
  int tx;           // rows: threads across a channel tile (vec channels each)
  int ctiles;       // rows: channel tiles
  int chunks;       // partial sums a channel
  long long chunk;  // rows: rows a chunk; planes: vectors a chunk
};

__host__ __device__ inline long long ceil_div(long long a, long long b) {
  return (a + b - 1) / b;
}

static BnPlan bn_plan(const void* x, const void* y, long long n, int c,
                      long long s, int channels_last, int elem_bytes) {
  BnPlan p;
  const int wide = 16 / elem_bytes;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (channels_last) {
    const long long rows = n * s;
    p.vec = (aligned && c % wide == 0) ? wide : 1;
    const int cvecs = c / p.vec;
    p.tx = 1;
    while (p.tx < 32 && p.tx < cvecs) p.tx *= 2;
    p.ctiles = (int)ceil_div(cvecs, p.tx);
    const int ty = kBnThreads / p.tx;
    long long chunks = ceil_div(kBnTargetBlocks, p.ctiles);
    const long long most = ceil_div(rows, 4LL * ty);  // >= 4 rows a thread
    if (chunks > most) chunks = most;
    if (chunks < 1) chunks = 1;
    p.chunk = ceil_div(rows, chunks);
    p.chunks = (int)ceil_div(rows, p.chunk);
  } else {
    p.vec = (aligned && s % wide == 0) ? wide : 1;
    p.tx = 0;
    p.ctiles = 0;
    const long long total = n * (s / p.vec);  // vectors of one channel
    long long chunks = ceil_div(kBnTargetBlocks, c);
    const long long most = ceil_div(total, 4LL * kBnThreads);
    if (chunks > most) chunks = most;
    if (chunks < 1) chunks = 1;
    p.chunk = ceil_div(total, chunks);
    p.chunks = (int)ceil_div(total, p.chunk);
  }
  return p;
}

// ------------------------------------------------------------- pass 1
// rows: block (tx x ty) threads; thread (tx, ty) owns channels
// [c0, c0 + VEC) of tile blockIdx.y and rows ty, ty + ty_n, ... of chunk
// blockIdx.x. The block's per-channel sums go through shared memory in
// row order.
template <typename T, int VEC>
__global__ void __launch_bounds__(kBnThreads)
    bn_stats_rows_kernel(const T* __restrict__ x, float* __restrict__ psum,
                         float* __restrict__ psq, long long rows, int c,
                         long long chunk, int tx_n) {
  __shared__ float sh_s[kBnThreads * VEC];
  __shared__ float sh_q[kBnThreads * VEC];
  const int tx = threadIdx.x % tx_n;
  const int ty = threadIdx.x / tx_n;
  const int ty_n = kBnThreads / tx_n;
  const int c0 = (blockIdx.y * tx_n + tx) * VEC;
  const long long r0 = (long long)blockIdx.x * chunk;
  const long long r1 = r0 + chunk < rows ? r0 + chunk : rows;
  float s[VEC], q[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.f;
  if (c0 < c) {
    for (long long r = r0 + ty; r < r1; r += ty_n) {
      const Pack<T, VEC> p =
          *reinterpret_cast<const Pack<T, VEC>*>(x + r * c + c0);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float v = to_f32(p.v[j]);
        s[j] += v;
        q[j] += v * v;
      }
    }
  }
  const int width = tx_n * VEC;  // channels of the tile
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    sh_s[ty * width + tx * VEC + j] = s[j];
    sh_q[ty * width + tx * VEC + j] = q[j];
  }
  __syncthreads();
  const int ch = blockIdx.y * width + threadIdx.x;
  if (threadIdx.x < width && ch < c) {
    float ts = 0.f, tq = 0.f;
    for (int k = 0; k < ty_n; ++k) {
      ts += sh_s[k * width + threadIdx.x];
      tq += sh_q[k * width + threadIdx.x];
    }
    psum[(long long)blockIdx.x * c + ch] = ts;
    psq[(long long)blockIdx.x * c + ch] = tq;
  }
}

// sum of v over the block in a fixed order; thread 0 gets the total
__device__ __forceinline__ float bn_block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kBnThreads / 32; ++w) t += red[w];
  __syncthreads();
  return t;
}

// planes: block (chunk blockIdx.x, channel blockIdx.y) walks its range of
// the channel's N * S / VEC vectors.
template <typename T, int VEC>
__global__ void __launch_bounds__(kBnThreads)
    bn_stats_planes_kernel(const T* __restrict__ x, float* __restrict__ psum,
                           float* __restrict__ psq, long long n, int c,
                           long long s_len, long long chunk) {
  __shared__ float red[kBnThreads / 32];
  const int ch = blockIdx.y;
  const long long per_plane = s_len / VEC;
  const long long total = n * per_plane;
  const long long v0 = (long long)blockIdx.x * chunk;
  const long long v1 = v0 + chunk < total ? v0 + chunk : total;
  float s = 0.f, q = 0.f;
  for (long long v = v0 + threadIdx.x; v < v1; v += kBnThreads) {
    const long long img = v / per_plane;
    const long long off = (v - img * per_plane) * VEC;
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(
        x + (img * c + ch) * s_len + off);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float e = to_f32(p.v[j]);
      s += e;
      q += e * e;
    }
  }
  const float ts = bn_block_sum(s, red);
  const float tq = bn_block_sum(q, red);
  if (threadIdx.x == 0) {
    psum[(long long)blockIdx.x * c + ch] = ts;
    psq[(long long)blockIdx.x * c + ch] = tq;
  }
}

// ------------------------------------------------------------- pass 2
// block: 32 channels x kFinLanes lanes; lane l adds chunks l, l + lanes, ...
// of its channel, then lane 0 adds the lanes in order: a fixed order, so
// the statistics are the same from run to run
constexpr int kFinLanes = kBnThreads / 32;

__global__ void __launch_bounds__(kBnThreads)
    bn_finalize_kernel(const float* __restrict__ psum,
                       const float* __restrict__ psq, int chunks, int c,
                       float count, const float* __restrict__ gamma,
                       const float* __restrict__ beta, float* __restrict__ mean,
                       float* __restrict__ var, float* __restrict__ ab,
                       float eps) {
  __shared__ float sh_s[kFinLanes][32];
  __shared__ float sh_q[kFinLanes][32];
  const int t = threadIdx.x % 32;
  const int lane = threadIdx.x / 32;
  const int ch = blockIdx.x * 32 + t;
  float s = 0.f, q = 0.f;
  if (ch < c) {
#pragma unroll 4
    for (int k = lane; k < chunks; k += kFinLanes) {
      s += psum[(long long)k * c + ch];
      q += psq[(long long)k * c + ch];
    }
  }
  sh_s[lane][t] = s;
  sh_q[lane][t] = q;
  __syncthreads();
  if (lane != 0 || ch >= c) return;
  s = q = 0.f;
  for (int l = 0; l < kFinLanes; ++l) {
    s += sh_s[l][t];
    q += sh_q[l][t];
  }
  const float m = __fdiv_rn(s, count);
  const float v =
      fmaxf(__fsub_rn(__fdiv_rn(q, count), __fmul_rn(m, m)), 0.f);
  const float a = __fmul_rn(gamma[ch], rsqrtf(__fadd_rn(v, eps)));
  mean[ch] = m;
  var[ch] = v;
  ab[ch] = a;
  ab[c + ch] = __fsub_rn(beta[ch], __fmul_rn(m, a));
}

// ------------------------------------------------------------- pass 3
// y = x * a + b at x's precision: fp32 as is; bf16 with a and b rounded
// to bf16 and the product and the sum each rounded to bf16
template <typename T>
__device__ __forceinline__ T bn_affine(T xv, float a, float b) {
  return from_f32<T>(
      __fadd_rn(round_as<T>(__fmul_rn(to_f32(xv), a)), b));
}

// rows: thread (tx, ty) of block (blockIdx.x, tile blockIdx.y) holds the a
// and b of its VEC channels and walks rows ty + blockIdx.x * ty_n, ...
template <typename T, int VEC>
__global__ void __launch_bounds__(kBnThreads)
    bn_normalize_rows_kernel(const T* __restrict__ x, T* __restrict__ y,
                             const float* __restrict__ ab, long long rows,
                             int c, int tx_n) {
  const int tx = threadIdx.x % tx_n;
  const int ty = threadIdx.x / tx_n;
  const int ty_n = kBnThreads / tx_n;
  const int c0 = (blockIdx.y * tx_n + tx) * VEC;
  if (c0 >= c) return;
  float a[VEC], b[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    a[j] = round_as<T>(ab[c0 + j]);
    b[j] = round_as<T>(ab[c + c0 + j]);
  }
  const long long step = (long long)gridDim.x * ty_n;
  for (long long r = (long long)blockIdx.x * ty_n + ty; r < rows; r += step) {
    const Pack<T, VEC> in =
        *reinterpret_cast<const Pack<T, VEC>*>(x + r * c + c0);
    Pack<T, VEC> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) out.v[j] = bn_affine(in.v[j], a[j], b[j]);
    *reinterpret_cast<Pack<T, VEC>*>(y + r * c + c0) = out;
  }
}

// planes: block (plane blockIdx.x = n*C + c, part blockIdx.y) walks the
// plane's vectors
template <typename T, int VEC>
__global__ void __launch_bounds__(kBnThreads)
    bn_normalize_planes_kernel(const T* __restrict__ x, T* __restrict__ y,
                               const float* __restrict__ ab, int c,
                               long long s_len) {
  const int ch = blockIdx.x % c;
  const float a = round_as<T>(ab[ch]);
  const float b = round_as<T>(ab[c + ch]);
  const long long base = (long long)blockIdx.x * s_len;
  const long long per_plane = s_len / VEC;
  for (long long v = (long long)blockIdx.y * kBnThreads + threadIdx.x;
       v < per_plane; v += (long long)gridDim.y * kBnThreads) {
    const Pack<T, VEC> in =
        *reinterpret_cast<const Pack<T, VEC>*>(x + base + v * VEC);
    Pack<T, VEC> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) out.v[j] = bn_affine(in.v[j], a, b);
    *reinterpret_cast<Pack<T, VEC>*>(y + base + v * VEC) = out;
  }
}

template <typename T, int VEC>
void launch_bn(const BnPlan& p, const T* x, const float* gamma,
               const float* beta, T* y, float* mean, float* var, float* work,
               long long n, int c, long long s, int channels_last, float eps,
               cudaStream_t stream) {
  float* psum = work;
  float* psq = work + (long long)p.chunks * c;
  float* ab = work + 2LL * p.chunks * c;
  if (channels_last) {
    const long long rows = n * s;
    bn_stats_rows_kernel<T, VEC><<<dim3(p.chunks, p.ctiles), kBnThreads, 0,
                                   stream>>>(x, psum, psq, rows, c, p.chunk,
                                             p.tx);
  } else {
    bn_stats_planes_kernel<T, VEC><<<dim3(p.chunks, c), kBnThreads, 0,
                                     stream>>>(x, psum, psq, n, c, s,
                                               p.chunk);
  }
  bn_finalize_kernel<<<(int)ceil_div(c, 32), kBnThreads, 0, stream>>>(
      psum, psq, p.chunks, c, (float)(n * s), gamma, beta, mean, var, ab,
      eps);
  if (channels_last) {
    const long long rows = n * s;
    const int ty = kBnThreads / p.tx;
    long long blocks = ceil_div(rows, ty);
    const long long most = ceil_div(4LL * kBnTargetBlocks, p.ctiles);
    if (blocks > most) blocks = most;
    bn_normalize_rows_kernel<T, VEC><<<dim3((int)blocks, p.ctiles),
                                       kBnThreads, 0, stream>>>(
        x, y, ab, rows, c, p.tx);
  } else {
    long long parts = ceil_div(s / VEC, kBnThreads);
    if (parts > 65535) parts = 65535;
    bn_normalize_planes_kernel<T, VEC><<<dim3((unsigned)(n * c),
                                              (unsigned)parts),
                                         kBnThreads, 0, stream>>>(x, y, ab, c,
                                                                  s);
  }
}

template <typename T>
int run_bn(const void* x, const void* gamma, const void* beta, void* y,
           void* mean, void* var, void* work, long long work_floats,
           long long n, int c, long long s, int channels_last, float eps,
           cudaStream_t stream) {
  const BnPlan p = bn_plan(x, y, n, c, s, channels_last, sizeof(T));
  if (work_floats < 2LL * p.chunks * c + 2LL * c ||
      (channels_last && p.ctiles > 65535) || (!channels_last && c > 65535) ||
      n * c > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float* m = static_cast<float*>(mean);
  float* v = static_cast<float*>(var);
  float* w = static_cast<float*>(work);
  if (p.vec == 1)
    launch_bn<T, 1>(p, xt, g, b, yt, m, v, w, n, c, s, channels_last, eps,
                    stream);
  else
    launch_bn<T, (int)(16 / sizeof(T))>(p, xt, g, b, yt, m, v, w, n, c, s,
                                        channels_last, eps, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ptt

// fp32 floats of workspace that ptt_batch_norm_train needs for this shape
// and these pointers (partial sums and squares [chunks, C], then a and b).
extern "C" long long ptt_batch_norm_workspace(const void* x, const void* y,
                                              long long n, int c, long long s,
                                              int channels_last, int dtype) {
  const int elem = dtype == ptt::kBFloat16 ? 2 : 4;
  const ptt::BnPlan p = ptt::bn_plan(x, y, n, c, s, channels_last, elem);
  return 2LL * p.chunks * c + 2LL * c;
}

// x, y: the [n, c, s] activation and its output, dense in the order given
// by channels_last (see the note at the top), fp32 (dtype 0) or bf16
// (dtype 1); gamma, beta: [c] fp32; mean, var: [c] fp32 outputs; work:
// ptt_batch_norm_workspace(...) fp32 floats. n * s >= 1, c >= 1. Returns
// cudaGetLastError() after the launches.
extern "C" int ptt_batch_norm_train(const void* x, const void* gamma,
                                    const void* beta, void* y, void* mean,
                                    void* var, void* work,
                                    long long work_floats, long long n, int c,
                                    long long s, int channels_last, float eps,
                                    int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || c < 1 || s < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == ptt::kFloat32)
    return ptt::run_bn<float>(x, gamma, beta, y, mean, var, work, work_floats,
                              n, c, s, channels_last, eps, st);
  if (dtype == ptt::kBFloat16)
    return ptt::run_bn<__nv_bfloat16>(x, gamma, beta, y, mean, var, work,
                                      work_floats, n, c, s, channels_last, eps,
                                      st);
  return static_cast<int>(cudaErrorInvalidValue);
}
