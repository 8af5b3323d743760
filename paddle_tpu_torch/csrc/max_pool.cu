// The gradient of 2-D max pooling, sent where the JAX package sends it.
//
// Replaces the VJP of paddle_tpu/ops/conv_ops.py:186 (jax.lax.reduce_window
// with lax.max, whose gradient XLA computes with select_and_scatter; no
// Pallas kernel). select_and_scatter scans each window in row-major order,
// its padding counted as -inf, and keeps its pick while pick >= next: the
// first largest element, but a NaN pick gives way to the next element, so
// in a window holding a NaN the pick is the first largest element after its
// last NaN (the NaN itself where it comes last). torch's max pooling
// backward sends the gradient to the last NaN instead. The plain version
// (ops/kernels/max_pool.py) computes the same picks with tensor ops over the
// unfolded windows, K times the output's size.
//
// max_pool_pick_kernel: one thread an output element scans its window (K
// loads of x, neighbouring threads on neighbouring windows) and writes the
// pick: its row-major place in the window as one byte (255 for padding)
// where K < 255, else the flat h * W + w of x's plane (-1 for padding).
// max_pool_grad_kernel: one thread an element of x gathers the gradient of
// every window that picked it, in row-major window order, summed in fp32
// and rounded once to x's dtype: no atomics, the same bits every run.
// Both run a grid of (rows or planes) x (the elements in one), in memory
// order: NCHW planes of h * w, or channels-last rows of w * c, so
// neighbouring threads touch neighbouring addresses and a thread divides
// its index once (integer division, not the bytes, bounded the first
// version: 0.82 ms against torch's 0.54 at ResNet-50's stem pool). Where
// channels-last channels come in 16-byte groups, a thread takes one group
// (max_pool_*_vec_kernel): one load a window place for 8 bf16 channels.
//
// Bound on an H100: bytes. The gradient must read x and dy and write dx
// once (2 bytes an element each in bf16: ResNet-50's stem pool at batch 64,
// x [64, 64, 112, 112], moves 231 MB, 69 us at 3.35 TB/s); the picks add
// one byte an output element, written once and read from L2. A handful of
// comparisons a window are far below the card's rate.

#include <stdint.h>

#include "common.cuh"

namespace ptt {

constexpr int kPoolThreads = 256;

// Every index is 32-bit: the wrapper takes tensors of fewer than 2^31
// elements (64-bit division costs several times the loads here).
struct PoolGeom {
  unsigned n, c, h, w, oh, ow;
  unsigned kh, kw, sh, sw, ph, pw;
  int channels_last;
};

// the pick of window place k (row-major) at padded row py, column px
template <typename P>
__device__ __forceinline__ P pick_of(const PoolGeom& g, bool inside,
                                     unsigned k, unsigned py, unsigned px) {
  if (sizeof(P) == 1) return inside ? (P)k : (P)255;
  return inside ? (P)((py - g.ph) * g.w + (px - g.pw)) : (P)-1;
}

template <typename T, typename P, int K, int S>
__global__ void __launch_bounds__(kPoolThreads)
    max_pool_pick_kernel(const T* __restrict__ x, P* __restrict__ pick,
                         PoolGeom g) {
  // NCHW: a plane (n, c) of oh * ow; channels-last: a row (n, oy) of
  // ow * c
  const unsigned outer = g.channels_last ? g.n * g.oh : g.n * g.c;
  const unsigned inner = g.channels_last ? g.ow * g.c : g.oh * g.ow;
  // K, S: the window and stride where they are square and common, so the
  // loops unroll and the divisions become shifts; 0: from g
  const unsigned kh = K ? K : g.kh, kw = K ? K : g.kw;
  const unsigned sh = S ? S : g.sh, sw = S ? S : g.sw;
  for (unsigned r = blockIdx.y; r < outer; r += gridDim.y) {
    for (unsigned j = blockIdx.x * blockDim.x + threadIdx.x; j < inner;
         j += gridDim.x * blockDim.x) {
      unsigned oy, ox, xbase, xstep, ystep;
      if (g.channels_last) {
        const unsigned n = r / g.oh;
        oy = r - n * g.oh;
        ox = j / g.c;
        const unsigned ch = j - ox * g.c;
        xbase = n * g.h * g.w * g.c + ch;
        xstep = g.c;
        ystep = g.w * g.c;
      } else {
        oy = j / g.ow;
        ox = j - oy * g.ow;
        xbase = r * g.h * g.w;
        xstep = 1;
        ystep = g.w;
      }
      float best = 0.0f;
      P at = 0;
      // most windows lie inside x: no test a place
      const bool full = oy * sh >= g.ph && oy * sh + kh <= g.h + g.ph &&
                        ox * sw >= g.pw && ox * sw + kw <= g.w + g.pw;
#pragma unroll
      for (unsigned a = 0; a < kh; ++a) {
        const unsigned py = oy * sh + a;   // padded row
#pragma unroll
        for (unsigned b = 0; b < kw; ++b) {
          const unsigned px = ox * sw + b;
          const bool inside = full || (py >= g.ph && py - g.ph < g.h &&
                                       px >= g.pw && px - g.pw < g.w);
          const float v =
              inside ? to_f32(x[xbase + (py - g.ph) * ystep +
                                (px - g.pw) * xstep])
                     : __int_as_float(0xff800000);   // -inf
          // keep the pick while pick >= next (false where either is NaN)
          if ((a == 0 && b == 0) || !(best >= v)) {
            best = v;
            at = pick_of<P>(g, inside, a * kw + b, py, px);
          }
        }
      }
      pick[r * inner + j] = at;
    }
  }
}

template <typename T, typename P, int K, int S>
__global__ void __launch_bounds__(kPoolThreads)
    max_pool_grad_kernel(const T* __restrict__ dy, const P* __restrict__ pick,
                         T* __restrict__ dx, PoolGeom g) {
  // NCHW: a plane (n, c) of h * w; channels-last: a row (n, y) of w * c
  const unsigned outer = g.channels_last ? g.n * g.h : g.n * g.c;
  const unsigned inner = g.channels_last ? g.w * g.c : g.h * g.w;
  const unsigned kh = K ? K : g.kh, kw = K ? K : g.kw;
  const unsigned sh = S ? S : g.sh, sw = S ? S : g.sw;
  for (unsigned r = blockIdx.y; r < outer; r += gridDim.y) {
    for (unsigned j = blockIdx.x * blockDim.x + threadIdx.x; j < inner;
         j += gridDim.x * blockDim.x) {
      unsigned y, xx, obase, ostep, orow;
      if (g.channels_last) {
        const unsigned n = r / g.h;
        y = r - n * g.h;
        xx = j / g.c;
        const unsigned ch = j - xx * g.c;
        obase = n * g.oh * g.ow * g.c + ch;
        ostep = g.c;
        orow = g.ow * g.c;
      } else {
        y = j / g.w;
        xx = j - y * g.w;
        obase = r * g.oh * g.ow;
        ostep = 1;
        orow = g.ow;
      }
      // the windows o with o * s <= p < o * s + k, p the padded coordinate
      const unsigned py = y + g.ph, px = xx + g.pw;
      const unsigned oy_lo = py + 1 > kh ? (py + 1 - kh + sh - 1) / sh : 0;
      const unsigned ox_lo = px + 1 > kw ? (px + 1 - kw + sw - 1) / sw : 0;
      const unsigned oy_end = py / sh + 1 < g.oh ? py / sh + 1 : g.oh;
      const unsigned ox_end = px / sw + 1 < g.ow ? px / sw + 1 : g.ow;
      float acc = 0.0f;
      for (unsigned oy = oy_lo; oy < oy_end; ++oy) {
        for (unsigned ox = ox_lo; ox < ox_end; ++ox) {
          const unsigned o = obase + oy * orow + ox * ostep;
          const P me = pick_of<P>(g, true,
                                  (py - oy * sh) * kw + px - ox * sw,
                                  py, px);
          if (pick[o] == me) acc += to_f32(dy[o]);
        }
      }
      dx[r * inner + j] = from_f32<T>(acc);
    }
  }
}

// a grid of (rows or planes) x (blocks along one), each side capped: the
// kernels loop past the cap
inline dim3 pool_grid(long long outer, long long inner) {
  const long long blocks = (inner + kPoolThreads - 1) / kPoolThreads;
  return dim3((unsigned)(blocks < 65535 ? blocks : 65535),
              (unsigned)(outer < 65535 ? outer : 65535));
}

template <typename T, typename P, int K, int S>
int launch(const void* x, const void* dy, void* dx, void* pick,
           const PoolGeom& g, cudaStream_t stream) {
  const long long planes = (long long)g.n * g.c;
  max_pool_pick_kernel<T, P, K, S>
      <<<g.channels_last
             ? pool_grid((long long)g.n * g.oh, (long long)g.ow * g.c)
             : pool_grid(planes, (long long)g.oh * g.ow),
         kPoolThreads, 0, stream>>>(static_cast<const T*>(x),
                                    static_cast<P*>(pick), g);
  max_pool_grad_kernel<T, P, K, S>
      <<<g.channels_last
             ? pool_grid((long long)g.n * g.h, (long long)g.w * g.c)
             : pool_grid(planes, (long long)g.h * g.w),
         kPoolThreads, 0, stream>>>(static_cast<const T*>(dy),
                                    static_cast<const P*>(pick),
                                    static_cast<T*>(dx), g);
  return (int)cudaGetLastError();
}

// Channels-last with 16-byte channel groups (c a multiple of V = 16 /
// sizeof(T), every pointer 16-byte aligned) and windows of fewer than 255
// places: a thread takes V neighbouring channels, so each window place is
// one 16-byte load and the index arithmetic is shared by V channels. The
// picks and sums are the scalar kernels', channel by channel.
template <typename T>
struct alignas(16) Vec {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

template <typename T, int K, int S>
__global__ void __launch_bounds__(kPoolThreads)
    max_pool_pick_vec_kernel(const T* __restrict__ x,
                             unsigned char* __restrict__ pick,
                             PoolGeom g) {
  constexpr int V = Vec<T>::kN;
  const unsigned kh = K ? K : g.kh, kw = K ? K : g.kw;
  const unsigned sh = S ? S : g.sh, sw = S ? S : g.sw;
  const unsigned groups = g.c / V, outer = g.n * g.oh, inner = g.ow * groups;
  for (unsigned r = blockIdx.y; r < outer; r += gridDim.y) {
    const unsigned n = r / g.oh, oy = r - n * g.oh;
    for (unsigned j = blockIdx.x * blockDim.x + threadIdx.x; j < inner;
         j += gridDim.x * blockDim.x) {
      const unsigned ox = j / groups, ch = (j - ox * groups) * V;
      float best[V];
      unsigned char at[V];
      const bool full = oy * sh >= g.ph && oy * sh + kh <= g.h + g.ph &&
                        ox * sw >= g.pw && ox * sw + kw <= g.w + g.pw;
#pragma unroll
      for (unsigned a = 0; a < kh; ++a) {
        const unsigned py = oy * sh + a;
#pragma unroll
        for (unsigned b = 0; b < kw; ++b) {
          const unsigned px = ox * sw + b;
          const bool inside = full || (py >= g.ph && py - g.ph < g.h &&
                                       px >= g.pw && px - g.pw < g.w);
          Vec<T> in;
          if (inside) {
            in = *reinterpret_cast<const Vec<T>*>(
                x + ((n * g.h + py - g.ph) * g.w + px - g.pw) * g.c + ch);
          }
          const unsigned char k = inside ? (unsigned char)(a * kw + b)
                                         : (unsigned char)255;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float v = inside ? to_f32(in.v[e])
                                   : __int_as_float(0xff800000);   // -inf
            // keep the pick while pick >= next (false where either is NaN)
            if ((a == 0 && b == 0) || !(best[e] >= v)) {
              best[e] = v;
              at[e] = k;
            }
          }
        }
      }
      unsigned char* out = pick + ((n * g.oh + oy) * g.ow + ox) * g.c + ch;
#pragma unroll
      for (int e = 0; e < V; ++e) out[e] = at[e];
    }
  }
}

template <typename T, int K, int S>
__global__ void __launch_bounds__(kPoolThreads)
    max_pool_grad_vec_kernel(const T* __restrict__ dy,
                             const unsigned char* __restrict__ pick,
                             T* __restrict__ dx, PoolGeom g) {
  constexpr int V = Vec<T>::kN;
  const unsigned kh = K ? K : g.kh, kw = K ? K : g.kw;
  const unsigned sh = S ? S : g.sh, sw = S ? S : g.sw;
  const unsigned groups = g.c / V, outer = g.n * g.h, inner = g.w * groups;
  for (unsigned r = blockIdx.y; r < outer; r += gridDim.y) {
    const unsigned n = r / g.h, y = r - n * g.h;
    for (unsigned j = blockIdx.x * blockDim.x + threadIdx.x; j < inner;
         j += gridDim.x * blockDim.x) {
      const unsigned xx = j / groups, ch = (j - xx * groups) * V;
      const unsigned py = y + g.ph, px = xx + g.pw;
      const unsigned oy_lo =
          py + 1 > kh ? (py + 1 - kh + sh - 1) / sh : 0;
      const unsigned ox_lo =
          px + 1 > kw ? (px + 1 - kw + sw - 1) / sw : 0;
      const unsigned oy_end = py / sh + 1 < g.oh ? py / sh + 1 : g.oh;
      const unsigned ox_end = px / sw + 1 < g.ow ? px / sw + 1 : g.ow;
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.0f;
      for (unsigned oy = oy_lo; oy < oy_end; ++oy) {
        for (unsigned ox = ox_lo; ox < ox_end; ++ox) {
          const unsigned o = ((n * g.oh + oy) * g.ow + ox) * g.c + ch;
          const unsigned char me =
              (unsigned char)((py - oy * sh) * kw + px - ox * sw);
          const Vec<T> d = *reinterpret_cast<const Vec<T>*>(dy + o);
#pragma unroll
          for (int e = 0; e < V; ++e)
            if (pick[o + e] == me) acc[e] += to_f32(d.v[e]);
        }
      }
      Vec<T> res;
#pragma unroll
      for (int e = 0; e < V; ++e) res.v[e] = from_f32<T>(acc[e]);
      *reinterpret_cast<Vec<T>*>(dx + ((n * g.h + y) * g.w + xx) * g.c +
                                 ch) = res;
    }
  }
}

template <typename T, int K, int S>
int launch_vec(const void* x, const void* dy, void* dx, void* pick,
               const PoolGeom& g, cudaStream_t stream) {
  const long long groups = g.c / Vec<T>::kN;
  max_pool_pick_vec_kernel<T, K, S>
      <<<pool_grid((long long)g.n * g.oh, g.ow * groups), kPoolThreads, 0,
         stream>>>(static_cast<const T*>(x),
                   static_cast<unsigned char*>(pick), g);
  max_pool_grad_vec_kernel<T, K, S>
      <<<pool_grid((long long)g.n * g.h, g.w * groups), kPoolThreads, 0,
         stream>>>(static_cast<const T*>(dy),
                   static_cast<const unsigned char*>(pick),
                   static_cast<T*>(dx), g);
  return (int)cudaGetLastError();
}

// the window and stride (K, S) specialized: ResNet's and GoogLeNet's 3x3/2,
// the inception pools' 3x3/1, VGG's 2x2/2; 0 reads them from g
template <typename T, typename P>
int by_shape(const void* x, const void* dy, void* dx, void* pick,
             const PoolGeom& g, bool vec, cudaStream_t s) {
  const bool square = g.kh == g.kw && g.sh == g.sw;
  const int k = square ? (int)g.kh : 0, st = square ? (int)g.sh : 0;
  if (vec) {
    if (k == 3 && st == 2) return launch_vec<T, 3, 2>(x, dy, dx, pick, g, s);
    if (k == 3 && st == 1) return launch_vec<T, 3, 1>(x, dy, dx, pick, g, s);
    if (k == 2 && st == 2) return launch_vec<T, 2, 2>(x, dy, dx, pick, g, s);
    return launch_vec<T, 0, 0>(x, dy, dx, pick, g, s);
  }
  if (k == 3 && st == 2) return launch<T, P, 3, 2>(x, dy, dx, pick, g, s);
  if (k == 3 && st == 1) return launch<T, P, 3, 1>(x, dy, dx, pick, g, s);
  if (k == 2 && st == 2) return launch<T, P, 2, 2>(x, dy, dx, pick, g, s);
  return launch<T, P, 0, 0>(x, dy, dx, pick, g, s);
}

}  // namespace ptt

// x and dx [n, c, h, w], dy [n, c, oh, ow], all NCHW-contiguous or all
// channels-last, each of fewer than 2^31 elements (else an error code);
// pick: n * c * oh * ow bytes of scratch where kh * kw < 255, else as many
// int32. Padding: ph rows above and pw columns left (the rows and columns
// below and right that the output extents reach are padding too). dtype: 0
// float32, 1 bfloat16.
extern "C" int ptt_max_pool_bwd(const void* x, const void* dy, void* dx,
                                void* pick, long long n, long long c,
                                long long h, long long w, long long oh,
                                long long ow, int kh, int kw, int sh, int sw,
                                int ph, int pw, int channels_last, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n * c * h * w * oh * ow == 0) return 0;
  const long long most = n * c * (h * w > oh * ow ? h * w : oh * ow);
  if (most >= (1ll << 31) || (h + ph + kh) * (w + pw + kw) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  using U = unsigned;
  const ptt::PoolGeom g{(U)n,  (U)c,  (U)h,  (U)w,  (U)oh, (U)ow, (U)kh,
                        (U)kw, (U)sh, (U)sw, (U)ph, (U)pw, channels_last};
  const int group = dtype == ptt::kFloat32 ? 4 : 8;
  const bool vec = channels_last && c % group == 0 &&
                   ((uintptr_t)x | (uintptr_t)dy | (uintptr_t)dx) % 16 == 0;
  const bool small = kh * kw < 255;
  if (dtype == ptt::kFloat32)
    return small ? ptt::by_shape<float, unsigned char>(x, dy, dx, pick, g,
                                                       vec, s)
                 : ptt::by_shape<float, int>(x, dy, dx, pick, g, false, s);
  if (dtype == ptt::kBFloat16)
    return small ? ptt::by_shape<__nv_bfloat16, unsigned char>(x, dy, dx,
                                                               pick, g, vec, s)
                 : ptt::by_shape<__nv_bfloat16, int>(x, dy, dx, pick, g,
                                                     false, s);
  return (int)cudaErrorInvalidValue;
}
