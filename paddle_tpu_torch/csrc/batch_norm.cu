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
//
// Design. The Pallas kernel carries sum / sumsq in VMEM from one
// sequential grid step to the next and then replays the rows; blocks on the
// card run in parallel, so the statistics are a split reduction. It runs as
// ONE persistent kernel, launched cooperatively with exactly as many blocks
// as the card holds at once (one 512-thread block an SM: each asks for
// nearly all of the SM's shared memory), with a grid-wide barrier between
// the statistics and the normalize:
//   1. each block owns fixed, contiguous work items (a range of rows of one
//      channel tile, or a range of one channel's plane vectors) and sums x
//      and x^2 in fp32 over each, writing one partial a channel and item to
//      a workspace [chunks, C] (no atomics);
//   2. cooperative_groups::this_grid().sync();
//   3. for each of its items, the block adds the partials of the item's
//      channels in a fixed order (chunk k goes to lane k mod L, each lane
//      adds its chunks in ascending order, then the L lanes are added in
//      order), so every block gets the same statistics, and the same from
//      run to run; then mean, var = max(E[x^2] - mean^2, 0) (the reference's
//      one-pass form and clamp) and a, b, with __fdiv_rn / __fmul_rn at the
//      JAX package's rounding points;
//   4. y = x * a + b with 16-byte loads and stores. For bf16, a and b are
//      rounded to bf16 first, then the product and the sum are each rounded
//      to bf16: the Pallas kernel's rounding points (batch_norm.py:92-94).
//      __fmul_rn / __fadd_rn keep nvcc from contracting them into one fma.
// When every block's items fit its shared memory (208 KB a block, about
// 27 MB over the card), phase 1 stages x there and phase 4 normalizes from
// it: x is read from device memory once. At ResNet-50's shapes that covers
// the stage-3 and stage-4 calls and the 64- and 128-channel calls of stages
// 1-2. Otherwise phase 4 walks the block's items, and the rows of each, in
// the reverse of phase 1's order, so its first reads find the part of x
// that phase 1 read last still in the 50 MB L2.
//
// x is the [N, C, S] view of the activation (S = H*W, or 1 for [N, C]) in
// one of two dense orders, so neither NHWC nor NCHW costs a transpose:
//   rows   (channels_last = 1): element (n, c, s) at (n*S + s)*C + c;
//   planes (channels_last = 0): element (n, c, s) at (n*C + c)*S + s.
// Any N*S >= 1 and any C (the Pallas kernel wants rows % 8 == 0 and C < 128
// or a multiple of 128): 16-byte vectors where the contiguous axis and
// the pointers allow them, one element a thread otherwise.

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace ptt {

constexpr int kBnThreads = 512;
constexpr int kBnWarps = kBnThreads / 32;
constexpr int kBnMaxTile = 256;  // channels of a rows tile (32 x 8 bf16)
constexpr int kBnLanes = 32;     // most lanes one channel's chunks split over
// dynamic shared memory: warp partials [warps][256], a and b [2][256], then
// x's staging area; the whole is what one block may have on an H100
// (232,448 bytes) less 1 KB
constexpr size_t kBnRedFloats = (size_t)kBnWarps * kBnMaxTile;
constexpr size_t kBnSmemBytes = 231424;
constexpr size_t kBnStageBytes =
    kBnSmemBytes - sizeof(float) * (kBnRedFloats + 2 * kBnMaxTile);

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// the work split, a function of the shape, the pointers' alignment and the
// number of blocks the card holds
struct BnPlan {
  int vec;          // elements a thread loads at once along the contiguous axis
  int tx;           // rows: threads across a channel tile (vec channels each)
  int ctiles;       // rows: channel tiles
  int chunks;       // partials a channel
  long long chunk;  // rows: rows a chunk; planes: vectors a chunk
  int items;        // rows: ctiles * chunks; planes: C * chunks
  int grid;         // blocks: min(items, what the card holds)
  int on_chip;      // every block's items fit its staging area
};

struct BnArgs {
  const void* x;
  void* y;
  const float* gamma;
  const float* beta;
  float* mean;
  float* var;
  float* psum;  // [chunks, C]
  float* psq;   // [chunks, C]
  long long n, s;
  int c;
  float eps;
  BnPlan p;
};

__host__ __device__ inline long long ceil_div(long long a, long long b) {
  return (a + b - 1) / b;
}

static BnPlan bn_plan(const void* x, const void* y, long long n, int c,
                      long long s, int channels_last, int elem_bytes,
                      int blocks) {
  BnPlan p;
  const int wide = 16 / elem_bytes;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  long long elems;  // x's elements in the largest item
  if (channels_last) {
    const long long rows = n * s;
    p.vec = (aligned && c % wide == 0) ? wide : 1;
    const int cvecs = (int)ceil_div(c, p.vec);
    p.tx = 1;
    while (p.tx < 32 && p.tx < cvecs) p.tx *= 2;
    p.ctiles = (int)ceil_div(cvecs, p.tx);
    const int ty = kBnThreads / p.tx;
    long long chunks = blocks / p.ctiles;
    const long long most = ceil_div(rows, ty);  // a row for every thread
    if (chunks > most) chunks = most;
    if (chunks < 1) chunks = 1;
    p.chunk = ceil_div(rows, chunks);
    p.chunks = (int)ceil_div(rows, p.chunk);
    p.items = p.ctiles * p.chunks;
    elems = p.chunk * p.tx * p.vec;
  } else {
    p.vec = (aligned && s % wide == 0) ? wide : 1;
    p.tx = 0;
    p.ctiles = 0;
    const long long total = n * (s / p.vec);  // vectors of one channel
    long long chunks = blocks / c;
    const long long most = ceil_div(total, kBnThreads);
    if (chunks > most) chunks = most;
    if (chunks < 1) chunks = 1;
    p.chunk = ceil_div(total, chunks);
    p.chunks = (int)ceil_div(total, p.chunk);
    p.items = c * p.chunks;
    elems = p.chunk * p.vec;
  }
  p.grid = p.items < blocks ? p.items : blocks;
  const long long per_block = ceil_div(p.items, p.grid);
  p.on_chip = per_block * elems * elem_bytes <= (long long)kBnStageBytes;
  return p;
}

// ------------------------------------------------------------- phase 1
// Sum over the block of v[VEC] of every thread, for each of the tile's
// W = tx_n * VEC channels: shuffles over the rows a warp holds, then the
// warps in order through shared memory. Thread t < W gets channel t's total.
template <int VEC>
__device__ __forceinline__ float bn_tile_sum(float (&v)[VEC], float* red,
                                             int tx_n, int tx) {
  const int width = tx_n * VEC;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    for (int o = tx_n; o < 32; o <<= 1)
      v[j] += __shfl_xor_sync(0xffffffffu, v[j], o);
  if (lane < tx_n)  // the warp's first row: tx == lane
#pragma unroll
    for (int j = 0; j < VEC; ++j) red[warp * width + tx * VEC + j] = v[j];
  __syncthreads();
  float t = 0.f;
  if ((int)threadIdx.x < width)
    for (int w = 0; w < kBnWarps; ++w) t += red[w * width + threadIdx.x];
  __syncthreads();
  return t;
}

// sum of v over the block in a fixed order; thread 0 gets the total
__device__ __forceinline__ float bn_block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kBnWarps; ++w) t += red[w];
  __syncthreads();
  return t;
}

// ------------------------------------------------------------- phase 3
// The statistics of channels [c0, c0 + width) from every chunk's partial:
// lane l (of L) adds chunks l, l + L, ... in ascending order, then thread
// j < width adds the lanes in order and writes a, b to ab[j], ab[kBnMaxTile
// + j]; the item of chunk 0 also writes mean and var. The same order in
// every block.
__device__ __forceinline__ void bn_finalize(const BnArgs& a, int c0,
                                            int width, bool first,
                                            float* red, float* ab) {
  const int lanes = min(kBnThreads / width, kBnLanes);
  const int j = threadIdx.x % width;
  const int l = threadIdx.x / width;
  const int c = c0 + j;
  if (l < lanes) {
    float s = 0.f, q = 0.f;
    if (c < a.c)
      for (int k = l; k < a.p.chunks; k += lanes) {
        s += a.psum[(long long)k * a.c + c];
        q += a.psq[(long long)k * a.c + c];
      }
    red[l * width + j] = s;
    red[(lanes + l) * width + j] = q;
  }
  __syncthreads();
  if ((int)threadIdx.x < width && c < a.c) {
    float s = 0.f, q = 0.f;
    for (int k = 0; k < lanes; ++k) {
      s += red[k * width + j];
      q += red[(lanes + k) * width + j];
    }
    const float count = (float)(a.n * a.s);
    const float m = __fdiv_rn(s, count);
    const float v =
        fmaxf(__fsub_rn(__fdiv_rn(q, count), __fmul_rn(m, m)), 0.f);
    const float g = __fmul_rn(a.gamma[c], rsqrtf(__fadd_rn(v, a.eps)));
    ab[j] = g;
    ab[kBnMaxTile + j] = __fsub_rn(a.beta[c], __fmul_rn(m, g));
    if (first) {
      a.mean[c] = m;
      a.var[c] = v;
    }
  }
  __syncthreads();
}

// ------------------------------------------------------------- phase 4
// y = x * a + b at x's precision: fp32 as is; bf16 with a and b rounded
// to bf16 and the product and the sum each rounded to bf16
template <typename T>
__device__ __forceinline__ T bn_affine(T xv, float a, float b) {
  return from_f32<T>(
      __fadd_rn(round_as<T>(__fmul_rn(to_f32(xv), a)), b));
}

// Where a thread's vectors of one item lie in x (and y): vector e of the
// item's range is row e (ROWS: element e * C + c0) or, for planes, vector
// pos of image img of channel g (element (img * C + g) * S + pos * VEC).
// Walking e by +-ty_n keeps img and pos without a 64-bit division a step.
template <int VEC, bool ROWS>
struct BnWalk {
  long long e, img, pos;
  long long per_plane, step_img, step_pos;  // planes: ty_n = step_img *
                                            // per_plane + step_pos
  __device__ __forceinline__ BnWalk(long long e_, int ty_n,
                                    long long per_plane_)
      : e(e_), img(0), pos(0), per_plane(per_plane_), step_img(0),
        step_pos(0) {
    if (!ROWS) {
      img = e / per_plane;
      pos = e - img * per_plane;
      step_img = ty_n / per_plane;
      step_pos = ty_n - step_img * per_plane;
    }
  }
  __device__ __forceinline__ long long at(int c, int g, long long s,
                                          int c0) const {
    return ROWS ? e * c + c0 : (img * c + g) * s + pos * VEC;
  }
  __device__ __forceinline__ void next(int ty_n) {
    e += ty_n;
    if (!ROWS) {
      img += step_img;
      pos += step_pos;
      if (pos >= per_plane) {
        pos -= per_plane;
        ++img;
      }
    }
  }
  __device__ __forceinline__ void prev(int ty_n) {
    e -= ty_n;
    if (!ROWS) {
      img -= step_img;
      pos -= step_pos;
      if (pos < 0) {
        pos += per_plane;
        --img;
      }
    }
  }
};

// vectors a thread has in flight at once in each pass
constexpr int kBnBatch = 8;

// One kernel, both passes. ROWS: thread (tx, ty) of an item owns channels
// [c0, c0 + VEC) of its tile and rows e0 + ty, e0 + ty + ty_n, ...;
// planes: thread t owns vectors e0 + t, e0 + t + 512, ... of its channel.
// Each pass issues kBnBatch vector loads before it uses any of them.
template <typename T, int VEC, bool ROWS>
__global__ void __launch_bounds__(kBnThreads, 1)
    bn_train_kernel(const BnArgs a) {
  extern __shared__ __align__(16) unsigned char smem_bn[];
  using P = Pack<T, VEC>;
  float* red = reinterpret_cast<float*>(smem_bn);
  float* ab = red + kBnRedFloats;
  T* stage = reinterpret_cast<T*>(ab + 2 * kBnMaxTile);
  const BnPlan& p = a.p;
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);
  const int c = a.c;
  const long long rows = a.n * a.s;
  const long long per_plane = a.s / VEC;
  const long long total = a.n * per_plane;
  const int tx_n = ROWS ? p.tx : 1;
  const int tx = ROWS ? (int)threadIdx.x % tx_n : 0;
  const int ty = ROWS ? (int)threadIdx.x / tx_n : (int)threadIdx.x;
  const int ty_n = kBnThreads / tx_n;
  const int width = ROWS ? tx_n * VEC : 1;  // channels of an item
  const int groups = ROWS ? p.ctiles : c;    // items of one chunk
  const int row_elems = ROWS ? width : VEC;  // staged elements a vector

  // item it: channel group it % groups, chunk it / groups; its range
  // [e0, e1) of rows (ROWS) or of the channel's vectors
  auto range = [&](int it, long long& e0, long long& e1) {
    e0 = (long long)(it / groups) * p.chunk;
    const long long end = ROWS ? rows : total;
    e1 = e0 + p.chunk < end ? e0 + p.chunk : end;
  };

  // ---- phase 1: partial sums of every item, x staged where it fits
  long long off = 0;  // staging elements used by this block's items
  for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
    const int g = it % groups;
    const int c0 = (g * tx_n + tx) * VEC;
    long long e0, e1;
    range(it, e0, e1);
    float s[VEC], q[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.f;
    if (!ROWS || c0 < c) {
      BnWalk<VEC, ROWS> w(e0 + ty, ty_n, per_plane);
      while (w.e < e1) {
        P v[kBnBatch];
        long long rel[kBnBatch];
#pragma unroll
        for (int u = 0; u < kBnBatch; ++u) {
          rel[u] = w.e - e0;
          if (w.e < e1) {
            v[u] = *reinterpret_cast<const P*>(x + w.at(c, g, a.s, c0));
            w.next(ty_n);
          }
        }
#pragma unroll
        for (int u = 0; u < kBnBatch; ++u) {
          if (e0 + rel[u] < e1) {
            if (p.on_chip)
              *reinterpret_cast<P*>(stage + off + rel[u] * row_elems +
                                    tx * VEC) = v[u];
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              const float f = to_f32(v[u].v[j]);
              s[j] += f;
              q[j] += f * f;
            }
          }
        }
      }
    }
    const long long chunk_i = it / groups;
    if (ROWS) {
      const float ts = bn_tile_sum<VEC>(s, red, tx_n, tx);
      const float tq = bn_tile_sum<VEC>(q, red, tx_n, tx);
      const int ch = g * width + (int)threadIdx.x;
      if ((int)threadIdx.x < width && ch < c) {
        a.psum[chunk_i * c + ch] = ts;
        a.psq[chunk_i * c + ch] = tq;
      }
    } else {
      float ss = 0.f, qq = 0.f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        ss += s[j];
        qq += q[j];
      }
      const float ts = bn_block_sum(ss, red);
      const float tq = bn_block_sum(qq, red);
      if (threadIdx.x == 0) {
        a.psum[chunk_i * c + g] = ts;
        a.psq[chunk_i * c + g] = tq;
      }
    }
    off += (e1 - e0) * row_elems;
  }

  cooperative_groups::this_grid().sync();  // every partial written

  // ---- phases 3 and 4, the block's items in reverse order, each walked
  // from its end
  const int mine = (p.items - (int)blockIdx.x + (int)gridDim.x - 1) /
                   (int)gridDim.x;
  for (int m = mine - 1; m >= 0; --m) {
    const int it = (int)blockIdx.x + m * (int)gridDim.x;
    const int g = it % groups;
    const int c0 = (g * tx_n + tx) * VEC;
    long long e0, e1;
    range(it, e0, e1);
    off -= (e1 - e0) * row_elems;
    bn_finalize(a, g * width, width, it < groups, red, ab);
    if (ROWS && c0 >= c) continue;
    float fa[VEC], fb[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      fa[j] = round_as<T>(ab[ROWS ? tx * VEC + j : 0]);
      fb[j] = round_as<T>(ab[kBnMaxTile + (ROWS ? tx * VEC + j : 0)]);
    }
    BnWalk<VEC, ROWS> w(e1 - 1 - ty, ty_n, per_plane);
    while (w.e >= e0) {
      P v[kBnBatch];
      long long at[kBnBatch];
#pragma unroll
      for (int u = 0; u < kBnBatch; ++u) {
        at[u] = -1;
        if (w.e >= e0) {
          at[u] = w.at(c, g, a.s, c0);
          v[u] = p.on_chip
                     ? *reinterpret_cast<const P*>(
                           stage + off + (w.e - e0) * row_elems + tx * VEC)
                     : *reinterpret_cast<const P*>(x + at[u]);
          w.prev(ty_n);
        }
      }
#pragma unroll
      for (int u = 0; u < kBnBatch; ++u) {
        if (at[u] >= 0) {
          P out;
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            out.v[j] = bn_affine(v[u].v[j], fa[j], fb[j]);
          *reinterpret_cast<P*>(y + at[u]) = out;
        }
      }
    }
  }
}

// Blocks of one kernel instantiation the card holds at once (its occupancy
// at the full shared-memory request times the SMs); 0 when the device
// cannot launch it cooperatively. Sets the shared-memory attribute the
// first time (before any graph capture).
template <typename T, int VEC, bool ROWS>
int bn_blocks(cudaError_t* err) {
  static int blocks = -1;
  if (blocks >= 0) return blocks;
  int dev = 0, sms = 0, coop = 0, occ = 0;
  auto kernel = bn_train_kernel<T, VEC, ROWS>;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (*err == cudaSuccess)
    *err = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kBnSmemBytes);
  if (*err == cudaSuccess)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, kernel, kBnThreads, kBnSmemBytes);
  if (*err != cudaSuccess) return 0;
  if (!coop || occ < 1) {
    *err = cudaErrorCooperativeLaunchTooLarge;
    return 0;
  }
  blocks = occ * sms;
  return blocks;
}

template <typename T, int VEC, bool ROWS>
cudaError_t run_bn(BnArgs a, long long work_floats, int elem_bytes,
                   int channels_last, cudaStream_t stream,
                   long long* floats_out, int* plan_out) {
  cudaError_t err = cudaSuccess;
  const int blocks = bn_blocks<T, VEC, ROWS>(&err);
  if (blocks == 0) return err;
  a.p = bn_plan(a.x, a.y, a.n, a.c, a.s, channels_last, elem_bytes, blocks);
  const long long need = 2LL * a.p.chunks * a.c;
  if (floats_out != nullptr) {  // workspace query: no launch
    *floats_out = need;
    if (plan_out != nullptr) {
      const int plan[6] = {a.p.vec,   a.p.chunks, a.p.items,
                           a.p.grid,  a.p.on_chip, blocks};
      for (int i = 0; i < 6; ++i) plan_out[i] = plan[i];
    }
    return cudaSuccess;
  }
  if (work_floats < need) return cudaErrorInvalidValue;
  a.psq = a.psum + (long long)a.p.chunks * a.c;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(bn_train_kernel<T, VEC, ROWS>),
      dim3(a.p.grid), dim3(kBnThreads), args, kBnSmemBytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The instantiation for this dtype, vector width and order; with
// floats_out set, only the workspace size is computed
inline cudaError_t bn_dispatch(BnArgs a, long long work_floats, int dtype,
                               int channels_last, cudaStream_t stream,
                               long long* floats_out, int* plan_out) {
  const int elem = dtype == kBFloat16 ? 2 : 4;
  // the vector width depends only on the shape and pointers, not the grid
  const int vec = bn_plan(a.x, a.y, a.n, a.c, a.s, channels_last, elem, 1).vec;
  using B = __nv_bfloat16;
#define PTT_BN(T, VEC)                                                       \
  return channels_last                                                      \
             ? run_bn<T, VEC, true>(a, work_floats, elem, 1, stream,        \
                                    floats_out, plan_out)                   \
             : run_bn<T, VEC, false>(a, work_floats, elem, 0, stream,       \
                                     floats_out, plan_out)
  if (dtype == kFloat32) {
    if (vec == 1) PTT_BN(float, 1);
    PTT_BN(float, 4);
  }
  if (vec == 1) PTT_BN(B, 1);
  PTT_BN(B, 8);
#undef PTT_BN
}

inline BnArgs bn_args(const void* x, const void* gamma, const void* beta,
                      void* y, void* mean, void* var, void* work,
                      long long n, int c, long long s, float eps) {
  BnArgs a;
  a.x = x;
  a.y = y;
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.mean = static_cast<float*>(mean);
  a.var = static_cast<float*>(var);
  a.psum = static_cast<float*>(work);
  a.psq = nullptr;
  a.n = n;
  a.s = s;
  a.c = c;
  a.eps = eps;
  return a;
}

}  // namespace ptt

// fp32 floats of workspace that ptt_batch_norm_train needs for this shape
// and these pointers on the current device (partial sums and squares
// [chunks, C]); -1 when the device cannot run the kernel. With `plan` set,
// also writes the launch's split there: vector width, chunks, work items,
// blocks, x staged on chip (1) or not (0), blocks the card holds.
extern "C" long long ptt_batch_norm_workspace(const void* x, const void* y,
                                              long long n, int c, long long s,
                                              int channels_last, int dtype,
                                              int* plan) {
  long long floats = -1;
  if (n < 1 || c < 1 || s < 1 ||
      (dtype != ptt::kFloat32 && dtype != ptt::kBFloat16))
    return -1;
  const ptt::BnArgs a = ptt::bn_args(x, nullptr, nullptr, const_cast<void*>(y),
                                     nullptr, nullptr, nullptr, n, c, s, 0.f);
  if (ptt::bn_dispatch(a, 0, dtype, channels_last, nullptr, &floats,
                       plan) != cudaSuccess)
    return -1;
  return floats;
}

// x, y: the [n, c, s] activation and its output, dense in the order given
// by channels_last (see the note at the top), fp32 (dtype 0) or bf16
// (dtype 1); gamma, beta: [c] fp32; mean, var: [c] fp32 outputs; work:
// ptt_batch_norm_workspace(...) fp32 floats. n * s >= 1, c >= 1. One
// cooperative launch; returns its error, then cudaGetLastError().
extern "C" int ptt_batch_norm_train(const void* x, const void* gamma,
                                    const void* beta, void* y, void* mean,
                                    void* var, void* work,
                                    long long work_floats, long long n, int c,
                                    long long s, int channels_last, float eps,
                                    int dtype, void* stream) {
  if (n < 1 || c < 1 || s < 1 ||
      (dtype != ptt::kFloat32 && dtype != ptt::kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  const ptt::BnArgs a =
      ptt::bn_args(x, gamma, beta, y, mean, var, work, n, c, s, eps);
  return static_cast<int>(ptt::bn_dispatch(a, work_floats, dtype,
                                           channels_last,
                                           static_cast<cudaStream_t>(stream),
                                           nullptr, nullptr));
}
