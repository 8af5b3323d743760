// 2-D max pooling, forward and gradient, sent where the JAX package sends
// them.
//
// Replaces paddle_tpu/ops/conv_ops.py:186 (jax.lax.reduce_window with
// lax.max) and its VJP (XLA's select_and_scatter; no Pallas kernel).
// select_and_scatter scans each window in row-major order, its padding
// counted as -inf, and keeps its pick while pick >= next: the first largest
// element, but a NaN pick gives way to the next element, so in a window
// holding a NaN the pick is the first largest element after its last NaN
// (the NaN itself where it comes last). torch's max pooling backward sends
// the gradient to the last NaN instead. The plain versions
// (ops/kernels/max_pool.py) compute the same with tensor ops over the
// unfolded windows.
//
// max_pool_fwd_kernel writes y (the window's max, NaN where the window holds
// one, -inf where it holds nothing but padding) and, where the caller asks,
// the pick: its row-major place in the window as one byte (255 for padding)
// where K < 255, else the flat h * W + w of x's plane (-1 for padding).
// max_pool_bwd_kernel reads the picks and dy, never x: an element of dx
// gathers the gradient of every window that picked it, in row-major window
// order, summed in fp32 and rounded once: no atomics, the same bits every
// run. Every element of dx is written, picked or not.
//
// Tiles: both kernels see the tensor as "planes" of rows (NCHW: the n * c
// planes of h rows of w elements; channels-last: the n images of h rows of
// w * c elements), so a band of rows, or several whole planes, is one
// contiguous chunk. A CTA takes several whole planes (small planes: the
// inception pools' 14 x 14) or a band of one plane's rows, chosen on the host
// so the staged chunk fits about 40 KB of shared memory and the grid has a
// few CTAs an SM. Channels-last with 16-byte channel groups takes a slice of
// the channels as well (a multiple of 16 that divides c) where one output
// row's windows of whole rows of c would pass 56 KB (four CTAs an SM): the
// CTA then sees the tensor as if it had only its slice's channels ("cs"),
// stages them with one 16-byte cp.async a pixel's piece of the slice, and
// maps its outputs back to x's channels (in the generic kernel, K = 0). It stages, with 16-byte cp.async,
// the input rows its outputs' windows read (forward), or the dy and picks of
// every window that covers its rows of dx (gradient; the halo where windows
// overlap is staged by both neighbours). Padding is taken by index, never
// copied. A tile that would still pass 200 KB (windows of hundreds of rows,
// rows of thousands of pixels) is not staged: the generic kernel then reads
// x, or dy and the picks, from global memory where it would have read the
// staged copy. Then:
// - channels-last with 16-byte channel groups: a thread takes one pixel's
//   group, whose channels share their windows: one 16-byte shared-memory
//   load a window place (forward) or a window (gradient), one 16-byte
//   store of y or dx and one of the picks;
// - NCHW forward: a thread takes one output at a time, its neighbours the
//   next outputs, so their windows' places lie a stride apart in shared
//   memory, in distinct banks (several outputs a thread would put them 16
//   bytes or more apart, a 4- to 8-way bank conflict at stride 2); y and
//   the picks are stored by neighbouring threads at neighbouring addresses;
// - NCHW gradient (K and S known): a thread takes 8 bf16 or 4 fp32
//   neighbours of a dx row, reads each window of the row's window rows
//   once for all of them, with every test known at compile time but the
//   pick's, and writes them with one 16-byte store where the row allows;
// - otherwise (other windows, channels-last groups under 16 bytes, int32
//   picks) an element at a time from the staged windows.
// A thread divides by a multiply and a shift (FastDiv): once an output in
// the NCHW forward, else once for the 16 bytes it writes.
//
// y's zeros: the reference's max counts -0 below +0 (a window holding both
// gives +0), while the picks keep the first of equal values.
//
// Bound on an H100: bytes. The forward reads x and writes y and the picks
// once; the gradient reads the picks and dy and writes dx once (ResNet-50's
// stem pool at batch 64, bf16 [64, 64, 112, 112] 3x3/2: 141 MB each way,
// 0.042 ms at 3.35 TB/s). A window's compares and a handful of adds an
// element are below the card's rate, but in the NCHW forward at 3x3
// windows they come close to the bytes' time.

#include "common.cuh"

namespace ptt {

constexpr int kPoolMaxThreads = 512;
constexpr unsigned kPoolStageBytes = 40 * 1024;   // a CTA's staged chunk
constexpr unsigned kPoolSliceBytes = 56 * 1024;   // slice channels past it
constexpr unsigned kPoolMostBytes = 200 * 1024;   // stage no more than it

// n / d for n < 2^31 by a multiply-high and a shift (d >= 1)
struct FastDiv {
  unsigned m, s;
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, m) + n) >> s;
  }
};

inline FastDiv fast_div(unsigned d) {
  unsigned s = 0;
  while (s < 32 && (1ull << s) < d) ++s;
  const unsigned long long m =
      ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return FastDiv{(unsigned)m, s};
}

// Every index is 32-bit: the wrapper takes tensors of fewer than 2^31
// elements.
struct PoolGeom {
  // planes of h x (w * c) in, oh x (ow * c) out; c = 1 for NCHW
  unsigned planes, h, w, c, oh, ow;
  unsigned kh, kw, sh, sw, ph, pw;
  // a CTA: planes [g * pb, g * pb + pb), or band b of one plane's rows
  // (output rows forward, dx rows backward), and channel slice l of cs
  // channels (cs = c but in a sliced channels-last tile);
  // blockIdx.x = (g * bands + b) * slices + l
  unsigned pb, bands, band_rows, cs, slices;
  unsigned pick_off;        // backward: the staged picks' byte offset
  // the written tensor's extents, as if it had cs channels
  FastDiv by_plane, by_row, by_c;
  FastDiv by_chunks, by_h;          // gradient by rows: chunks a row, h
  FastDiv by_slices, by_bands;      // blockIdx.x's parts
};

template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Pack {
  T v[N];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// src[g0, g1) to dst[g0 - a0, g1 - a0), a0 = g0 rounded down to 16 bytes:
// 16-byte copies where they lie inside the range, single elements at its
// ragged ends (src 16-byte aligned)
template <typename E>
__device__ __forceinline__ unsigned stage(const E* __restrict__ src, E* dst,
                                          unsigned g0, unsigned g1) {
  constexpr unsigned VE = 16 / sizeof(E);
  const unsigned a0 = g0 & ~(VE - 1);
  for (unsigned e = a0 + threadIdx.x * VE; e < g1; e += blockDim.x * VE) {
    if (e >= g0 && e + VE <= g1) {
      cp_async16(dst + (e - a0), src + e);
    } else {
#pragma unroll
      for (unsigned k = 0; k < VE; ++k)
        if (e + k >= g0 && e + k < g1) dst[e + k - a0] = src[e + k];
    }
  }
  return a0;
}

// The same for a tile of cs of x's c channels from channel ch0 (cs * E a
// multiple of 16 bytes): [g0, g1) indexes the tensor as if it had only
// those channels, a multiple of cs at each end
template <typename E>
__device__ __forceinline__ unsigned stage_slice(const E* __restrict__ src,
                                                E* dst, unsigned g0,
                                                unsigned g1,
                                                const PoolGeom& g,
                                                unsigned ch0) {
  constexpr unsigned VE = 16 / sizeof(E);
  for (unsigned e = g0 + threadIdx.x * VE; e < g1; e += blockDim.x * VE) {
    const unsigned pix = g.by_c.div(e);
    cp_async16(dst + (e - g0), src + pix * g.c + ch0 + (e - pix * g.cs));
  }
  return g0;
}

template <typename E>
__device__ __forceinline__ unsigned stage_tile(const E* __restrict__ src,
                                               E* dst, unsigned g0,
                                               unsigned g1,
                                               const PoolGeom& g,
                                               unsigned ch0) {
  return g.slices > 1 ? stage_slice(src, dst, g0, g1, g, ch0)
                      : stage(src, dst, g0, g1);
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// max(a, b), NaN where either is NaN, +0 over -0 (the reference's max)
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// the pick of window place k (row-major) at input row r, column col
template <typename P>
__device__ __forceinline__ P pick_code(bool inside, unsigned k, int r,
                                       int col, unsigned w) {
  if (sizeof(P) == 1) return inside ? (P)k : (P)255;
  return inside ? (P)(r * (int)w + col) : (P)-1;
}

// One window's scan over the staged rows, `at` row r0 and column c0 (the
// window's first place, possibly padding; xs + base at row 0, column 0 of
// its plane and its channel): y and the pick. FULL: no place is padding.
template <typename T, typename P, int K, bool FULL>
__device__ __forceinline__ void scan(const T* xs, int base, int r0, int c0,
                                     const PoolGeom& g, float& y, P& at) {
  const int kh = K ? K : (int)g.kh, kw = K ? K : (int)g.kw;
  const int rw = (int)(g.w * g.c), c = (int)g.c;
  float best = neg_inf(), top = neg_inf();
  at = 0;
#pragma unroll
  for (int a = 0; a < kh; ++a) {
    const int r = r0 + a;
#pragma unroll
    for (int b = 0; b < kw; ++b) {
      const int col = c0 + b;
      const bool inside = FULL || ((unsigned)r < g.h && (unsigned)col < g.w);
      const float v = inside ? to_f32(xs[base + r * rw + col * c]) : neg_inf();
      top = max_nan(top, v);
      // keep the pick while pick >= next (false where either is NaN)
      if ((a == 0 && b == 0) || !(best >= v)) {
        best = v;
        at = pick_code<P>(inside, a * kw + b, r, col, g.w);
      }
    }
  }
  y = top;
}

// A channel group's running max over a window, NaN where the window holds
// one, +0 over -0 (padding places are not added: a window of nothing but
// padding keeps -inf): bf16 pairs by __hmax2_nan, fp32 by max_nan.
template <typename T, int V>
struct WindowMax;

template <int V>
struct WindowMax<__nv_bfloat16, V> {
  __nv_bfloat162 m[V / 2];
  __device__ __forceinline__ WindowMax() {
#pragma unroll
    for (int k = 0; k < V / 2; ++k)
      m[k] = __floats2bfloat162_rn(neg_inf(), neg_inf());
  }
  __device__ __forceinline__ void add(const Pack<__nv_bfloat16, V>& in) {
    const __nv_bfloat162* two = reinterpret_cast<const __nv_bfloat162*>(in.v);
#pragma unroll
    for (int k = 0; k < V / 2; ++k) m[k] = __hmax2_nan(m[k], two[k]);
  }
  __device__ __forceinline__ Pack<__nv_bfloat16, V> get() const {
    Pack<__nv_bfloat16, V> out;
#pragma unroll
    for (int k = 0; k < V / 2; ++k) {
      out.v[2 * k] = m[k].x;
      out.v[2 * k + 1] = m[k].y;
    }
    return out;
  }
};

template <int V>
struct WindowMax<float, V> {
  float m[V];
  __device__ __forceinline__ WindowMax() {
#pragma unroll
    for (int k = 0; k < V; ++k) m[k] = neg_inf();
  }
  __device__ __forceinline__ void add(const Pack<float, V>& in) {
#pragma unroll
    for (int k = 0; k < V; ++k) m[k] = max_nan(m[k], in.v[k]);
  }
  __device__ __forceinline__ Pack<float, V> get() const {
    Pack<float, V> out;
#pragma unroll
    for (int k = 0; k < V; ++k) out.v[k] = m[k];
    return out;
  }
};

// The CTA's share: planes [p0, p1), rows [r0, r1) of them (output rows
// forward, dx rows backward) and channels [ch0, ch0 + g.cs)
struct Share {
  unsigned p0, p1, r0, r1, ch0;
};

template <bool SLICED>
__device__ __forceinline__ Share share_of(const PoolGeom& g,
                                          unsigned rows) {
  const unsigned rest = SLICED ? g.by_slices.div(blockIdx.x) : blockIdx.x;
  const unsigned l = blockIdx.x - rest * g.slices;
  const unsigned grp = g.by_bands.div(rest), band = rest - grp * g.bands;
  Share t;
  t.p0 = grp * g.pb;
  t.p1 = min(t.p0 + g.pb, g.planes);
  t.r0 = band * g.band_rows;
  t.r1 = min(t.r0 + g.band_rows, rows);
  t.ch0 = l * g.cs;
  return t;
}

// Each thread V = 16 / sizeof(T) consecutive outputs at a time. VC: a
// channels-last pixel's 16-byte channel group (c a multiple of V, byte
// picks), whose V channels share one window: one 16-byte shared-memory
// load a place. Else V consecutive outputs in memory order, each its own
// window. STAGED false: x is read where it lies (K and S read from g).
// Channel slices (g.slices > 1) run the generic kernel (K = 0): the
// specialized ones keep the registers of whole rows of c.
template <typename T, typename P, int K, int S, bool VC, bool STAGED>
__global__ void __launch_bounds__(kPoolMaxThreads)
    max_pool_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                        P* __restrict__ pick, PoolGeom g) {
  constexpr unsigned V = 16 / sizeof(T);
  constexpr bool SLICED = VC && K == 0;
  extern __shared__ __align__(16) unsigned char smem[];
  const T* xs = STAGED ? reinterpret_cast<const T*>(smem) : x;
  const unsigned kh = K ? K : g.kh, kw = K ? K : g.kw;
  const unsigned sh = S ? S : g.sh, sw = S ? S : g.sw;
  const Share my = share_of<SLICED>(g, g.oh);
  const unsigned p0 = my.p0, p1 = my.p1, oy0 = my.r0, oy1 = my.r1;
  // extents as if x had only the tile's cs channels (all of them, cs = c,
  // but in a sliced tile)
  const unsigned rw = g.w * g.cs, plane_in = g.h * rw;
  const unsigned orw = g.ow * g.cs, plane_out = g.oh * orw;
  // the input rows these outputs' windows read
  const int r0 = max(0, (int)(oy0 * sh) - (int)g.ph);
  const int r1 = min((int)g.h, (int)((oy1 - 1) * sh + kh) - (int)g.ph);
  unsigned a0 = 0;
  if constexpr (STAGED) {
    const unsigned g0 = p0 * plane_in + r0 * rw;
    const unsigned g1 = (p1 - 1) * plane_in + r1 * rw;
    T* dst = reinterpret_cast<T*>(smem);
    if (r1 > r0)
      a0 = SLICED ? stage_tile(x, dst, g0, g1, g, my.ch0)
                  : stage(x, dst, g0, g1);
    cp_async_wait_all();
    __syncthreads();
  }
  const unsigned o0 = p0 * plane_out + oy0 * orw;
  const unsigned o1 = (p1 - 1) * plane_out + oy1 * orw;
  if constexpr (VC) {
    for (unsigned e0 = o0 + threadIdx.x * V; e0 < o1; e0 += blockDim.x * V) {
      const unsigned p = g.by_plane.div(e0);
      unsigned rem = e0 - p * plane_out;
      const unsigned oy = g.by_row.div(rem);
      rem -= oy * orw;
      const unsigned ox = g.by_c.div(rem), ch = rem - ox * g.cs;
      const int r = (int)(oy * sh) - (int)g.ph;
      const int col = (int)(ox * sw) - (int)g.pw;
      const int base = (int)(p * plane_in + ch) - (int)a0;
      const bool full = r >= 0 && r + (int)kh <= (int)g.h && col >= 0 &&
                        col + (int)kw <= (int)g.w;
      float best[V];
      WindowMax<T, V> ym;
      Pack<P, V> pv;
#pragma unroll
      for (unsigned k = 0; k < V; ++k) {
        best[k] = neg_inf();
        pv.v[k] = 0;
      }
#pragma unroll
      for (unsigned a = 0; a < kh; ++a) {
#pragma unroll
        for (unsigned b = 0; b < kw; ++b) {
          const int rr = r + (int)a, cc = col + (int)b;
          const bool inside =
              full || ((unsigned)rr < g.h && (unsigned)cc < g.w);
          Pack<T, V> in;
          if (inside) {
            in = *reinterpret_cast<const Pack<T, V>*>(
                xs + base + rr * (int)rw + cc * (int)g.cs);
            ym.add(in);
          }
          const P code = pick_code<P>(inside, a * kw + b, rr, cc, g.w);
#pragma unroll
          for (unsigned k = 0; k < V; ++k) {
            const float v = inside ? to_f32(in.v[k]) : neg_inf();
            // keep the pick while pick >= next (false where either is NaN)
            if ((a == 0 && b == 0) || !(best[k] >= v)) {
              best[k] = v;
              pv.v[k] = code;
            }
          }
        }
      }
      // back to x's channels
      const unsigned at =
          SLICED ? ((p * g.oh + oy) * g.ow + ox) * g.c + my.ch0 + ch : e0;
      *reinterpret_cast<Pack<T, V>*>(y + at) = ym.get();
      if (pick) *reinterpret_cast<Pack<P, V>*>(pick + at) = pv;
    }
  } else {
    // one output a thread at a time, neighbouring threads on neighbouring
    // outputs: their windows' places lie a stride apart in shared memory,
    // in distinct banks (V outputs a thread would put them 16 bytes or more
    // apart: a 4- to 8-way bank conflict at stride 2)
    for (unsigned e = o0 + threadIdx.x; e < o1; e += blockDim.x) {
      const unsigned p = g.by_plane.div(e);
      unsigned rem = e - p * plane_out;
      const unsigned oy = g.by_row.div(rem);
      rem -= oy * orw;
      const unsigned ox = g.by_c.div(rem), ch = rem - ox * g.c;
      const int r = (int)(oy * sh) - (int)g.ph;
      const int col = (int)(ox * sw) - (int)g.pw;
      const int base = (int)(p * plane_in + ch) - (int)a0;
      float v;
      P at;
      // the checked scan for the whole warp where any of its windows holds
      // padding, so the warp does not run both
      if (__all_sync(__activemask(), r >= 0 && r + (int)kh <= (int)g.h &&
                     col >= 0 && col + (int)kw <= (int)g.w))
        scan<T, P, K, true>(xs, base, r, col, g, v, at);
      else
        scan<T, P, K, false>(xs, base, r, col, g, v, at);
      y[e] = from_f32<T>(v);
      if (pick) pick[e] = at;
    }
  }
}

// The gradient at input row yy, column xx (wbase: the staged windows' plane
// and channel): the dy of every window whose pick is this element, in
// row-major window order, summed in fp32.
template <typename T, typename P, int K, int S>
__device__ __forceinline__ float gather(const T* dys, const P* pks,
                                        int wbase, int pbase, unsigned yy,
                                        unsigned xx, const PoolGeom& g) {
  const unsigned kh = K ? K : g.kh, kw = K ? K : g.kw;
  const unsigned sh = S ? S : g.sh, sw = S ? S : g.sw;
  const int orw = (int)(g.ow * g.c), c = (int)g.c;
  // the windows o with o * s <= p < o * s + k, p the padded coordinate
  const unsigned py = yy + g.ph, px = xx + g.pw;
  const unsigned oy_lo = py >= kh ? (py - kh) / sh + 1 : 0;
  const unsigned ox_lo = px >= kw ? (px - kw) / sw + 1 : 0;
  const unsigned oy_hi = min(py / sh, g.oh - 1);
  const unsigned ox_hi = min(px / sw, g.ow - 1);
  const P flat = (P)(yy * g.w + xx);
  float acc = 0.0f;
  // K, S known: at most ceil(K / S) windows each way, unrolled
  constexpr unsigned N = K ? (K + S - 1) / S : 1;
  const unsigned ny = K ? N : (oy_hi >= oy_lo ? oy_hi - oy_lo + 1 : 0);
  const unsigned nx = K ? N : (ox_hi >= ox_lo ? ox_hi - ox_lo + 1 : 0);
#pragma unroll
  for (unsigned t = 0; t < ny; ++t) {
    const unsigned oy = oy_lo + t;
    if (oy > oy_hi) break;
#pragma unroll
    for (unsigned u = 0; u < nx; ++u) {
      const unsigned ox = ox_lo + u;
      if (ox > ox_hi) break;
      const int wi = (int)oy * orw + (int)ox * c;
      const P me = sizeof(P) == 1
                       ? (P)((py - oy * sh) * kw + px - ox * sw)
                       : flat;
      if (pks[pbase + wi] == me) acc += to_f32(dys[wbase + wi]);
    }
  }
  return acc;
}

// ceil(a / b) and floor(a / b), b > 0, a of any sign
__host__ __device__ constexpr int ceil_div(int a, int b) {
  return a >= 0 ? (a + b - 1) / b : -((-a) / b);
}
__host__ __device__ constexpr int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// One window row's share of V neighbouring elements of a dx row (NCHW, byte
// picks, K and S known): the elements' padded columns px0 + k, px0 = oxb *
// S + PH, lie in windows oxb + j, JLO <= j <= JHI; element k takes window j
// where j * S <= PH + k < j * S + K, at place rowcode + PH + k - j * S.
// Each window's pick and dy is read once for the V elements, and every
// test is known at compile time but the pick's; the elements' sums run in
// row-major window order. ds, ps: the staged window row.
template <typename T, int K, int S, int PH, int V>
__device__ __forceinline__ void row_windows(float (&acc)[V],
                                            const T* ds,
                                            const unsigned char* ps,
                                            int oxb, unsigned ow,
                                            int rowcode) {
  constexpr int JLO = ceil_div(PH - K + 1, S), JHI = floor_div(PH + V - 1, S);
#pragma unroll
  for (int j = JLO; j <= JHI; ++j) {
    const int ox = oxb + j;
    const bool valid = (unsigned)ox < ow;
    const int pk = valid ? (int)ps[ox] : -1;
    const float d = valid ? to_f32(ds[ox]) : 0.0f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (j * S <= PH + k && PH + k < j * S + K &&
          pk == rowcode + PH + k - j * S)
        acc[k] += d;
    }
  }
}

// STAGED false: dy and the picks are read where they lie (K and S read
// from g). Channel slices run the generic kernel, as in the forward.
template <typename T, typename P, int K, int S, bool VC, bool STAGED>
__global__ void __launch_bounds__(kPoolMaxThreads)
    max_pool_bwd_kernel(const P* __restrict__ pick, const T* __restrict__ dy,
                        T* __restrict__ dx, PoolGeom g) {
  constexpr unsigned V = 16 / sizeof(T);
  constexpr bool SLICED = VC && K == 0;
  extern __shared__ __align__(16) unsigned char smem[];
  const T* dys = STAGED ? reinterpret_cast<const T*>(smem) : dy;
  const P* pks = STAGED ? reinterpret_cast<const P*>(smem + g.pick_off)
                        : pick;
  const unsigned kh = K ? K : g.kh, kw = K ? K : g.kw;
  const unsigned sh = S ? S : g.sh, sw = S ? S : g.sw;
  const Share my = share_of<SLICED>(g, g.h);
  const unsigned p0 = my.p0, p1 = my.p1, y0 = my.r0, y1 = my.r1;
  // extents as if the tensors had only the tile's cs channels
  const unsigned rw = g.w * g.cs, plane_in = g.h * rw;
  const unsigned orw = g.ow * g.cs, plane_out = g.oh * orw;
  // the window rows that cover dx rows [y0, y1)
  const unsigned oy_lo = y0 + g.ph >= kh ? (y0 + g.ph - kh) / sh + 1 : 0;
  const unsigned oy_hi = min((y1 - 1 + g.ph) / sh, g.oh - 1);
  unsigned qa = 0, pa = 0;
  if constexpr (STAGED) {
    if (oy_hi >= oy_lo) {
      const unsigned q0 = p0 * plane_out + oy_lo * orw;
      const unsigned q1 = (p1 - 1) * plane_out + (oy_hi + 1) * orw;
      T* dst = reinterpret_cast<T*>(smem);
      P* pdst = reinterpret_cast<P*>(smem + g.pick_off);
      qa = SLICED ? stage_tile(dy, dst, q0, q1, g, my.ch0)
                  : stage(dy, dst, q0, q1);
      pa = SLICED ? stage_tile(pick, pdst, q0, q1, g, my.ch0)
                  : stage(pick, pdst, q0, q1);
    }
    cp_async_wait_all();
    __syncthreads();
  }
  if constexpr (K != 0 && sizeof(P) == 1 && !VC) {
    if (g.c == 1) {
      // NCHW: a thread takes V neighbouring elements of one row, chunk x0
      // of its row r (rows [r0, r1) of the CTA's planes in memory order)
      constexpr unsigned NY = (K + S - 1) / S;
      const unsigned chunks = (g.w + V - 1) / V;
      const unsigned r0 = p0 * g.h + y0, r1 = (p1 - 1) * g.h + y1;
      for (unsigned i = threadIdx.x; i < (r1 - r0) * chunks;
           i += blockDim.x) {
        const unsigned rr = g.by_chunks.div(i);
        const unsigned x0 = (i - rr * chunks) * V, r = r0 + rr;
        const unsigned p = g.by_h.div(r), py = r - p * g.h + g.ph;
        const int px0 = (int)(x0 + g.pw), oxb = px0 / S;
        const unsigned oy_a = py >= K ? (py - K) / S + 1 : 0;
        const unsigned oy_b = min(py / S, g.oh - 1);
        float acc[V];
#pragma unroll
        for (unsigned k = 0; k < V; ++k) acc[k] = 0.0f;
#pragma unroll
        for (unsigned t = 0; t < NY; ++t) {
          const unsigned oy = oy_a + t;
          if (oy > oy_b) break;
          const int wi = (int)(p * plane_out + oy * g.ow);
          const int rowcode = (int)(py - oy * S) * K;
          const T* ds = dys + (wi - (int)qa);
          const unsigned char* ps =
              reinterpret_cast<const unsigned char*>(pks) + (wi - (int)pa);
          if (S == 2 && px0 - oxb * S == 1)
            row_windows<T, K, S, (S == 2 ? 1 : 0), V>(acc, ds, ps, oxb,
                                                      g.ow, rowcode);
          else
            row_windows<T, K, S, 0, V>(acc, ds, ps, oxb, g.ow, rowcode);
        }
        const unsigned e0 = r * g.w + x0;
        Pack<T, V> res;
#pragma unroll
        for (unsigned k = 0; k < V; ++k) res.v[k] = from_f32<T>(acc[k]);
        if (x0 + V <= g.w && e0 % V == 0) {
          *reinterpret_cast<Pack<T, V>*>(dx + e0) = res;
        } else {
#pragma unroll
          for (unsigned k = 0; k < V; ++k)
            if (x0 + k < g.w) dx[e0 + k] = res.v[k];
        }
      }
      return;
    }
  }
  const unsigned x0 = p0 * plane_in + y0 * rw;
  const unsigned x1 = (p1 - 1) * plane_in + y1 * rw;
  for (unsigned e0 = (x0 & ~(V - 1)) + threadIdx.x * V; e0 < x1;
       e0 += blockDim.x * V) {
    const unsigned first = max(e0, x0);
    unsigned p = g.by_plane.div(first), rem = first - p * plane_in;
    unsigned yy = g.by_row.div(rem);
    rem -= yy * rw;
    unsigned xx = g.by_c.div(rem), ch = rem - xx * g.cs;
    Pack<T, V> res;
    if constexpr (VC) {
      const unsigned py = yy + g.ph, px = xx + g.pw;
      const unsigned oy_a = py >= kh ? (py - kh) / sh + 1 : 0;
      const unsigned ox_a = px >= kw ? (px - kw) / sw + 1 : 0;
      const unsigned oy_b = min(py / sh, g.oh - 1);
      const unsigned ox_b = min(px / sw, g.ow - 1);
      const int base = (int)(p * plane_out + ch);
      float acc[V];
#pragma unroll
      for (unsigned k = 0; k < V; ++k) acc[k] = 0.0f;
      constexpr unsigned N = K ? (K + S - 1) / S : 1;
      const unsigned ny = K ? N : (oy_b >= oy_a ? oy_b - oy_a + 1 : 0);
      const unsigned nx = K ? N : (ox_b >= ox_a ? ox_b - ox_a + 1 : 0);
#pragma unroll
      for (unsigned t = 0; t < ny; ++t) {
        const unsigned oy = oy_a + t;
        if (oy > oy_b) break;
#pragma unroll
        for (unsigned u = 0; u < nx; ++u) {
          const unsigned ox = ox_a + u;
          if (ox > ox_b) break;
          const int wi = base + (int)(oy * orw + ox * g.cs);
          const P me = (P)((py - oy * sh) * kw + px - ox * sw);
          const Pack<T, V> d =
              *reinterpret_cast<const Pack<T, V>*>(dys + (wi - (int)qa));
          const Pack<P, V> pk =
              *reinterpret_cast<const Pack<P, V>*>(pks + (wi - (int)pa));
#pragma unroll
          for (unsigned k = 0; k < V; ++k)
            if (pk.v[k] == me) acc[k] += to_f32(d.v[k]);
        }
      }
#pragma unroll
      for (unsigned k = 0; k < V; ++k) res.v[k] = from_f32<T>(acc[k]);
      // back to x's channels
      *reinterpret_cast<Pack<T, V>*>(
          dx + (SLICED ? ((p * g.h + yy) * g.w + xx) * g.c + my.ch0 + ch
                       : e0)) = res;
      continue;
    }
#pragma unroll
    for (unsigned k = 0; k < V; ++k) {
      res.v[k] = from_f32<T>(0.0f);
      if (e0 + k < first || e0 + k >= x1) continue;
      const int base = (int)(p * plane_out + ch);
      res.v[k] = from_f32<T>(gather<T, P, K, S>(
          dys, pks, base - (int)qa, base - (int)pa, yy, xx, g));
      if (++ch == g.c) {
        ch = 0;
        if (++xx == g.w) {
          xx = 0;
          if (++yy == g.h) {
            yy = 0;
            ++p;
          }
        }
      }
    }
    if (e0 >= x0 && e0 + V <= x1) {
      *reinterpret_cast<Pack<T, V>*>(dx + e0) = res;
    } else {
#pragma unroll
      for (unsigned k = 0; k < V; ++k)
        if (e0 + k >= x0 && e0 + k < x1) dx[e0 + k] = res.v[k];
    }
  }
}

// SMs of the current device, read once
inline int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

// A CTA's share: whole planes while `plane_bytes` of staging fit the budget
// (no more than a few CTAs an SM's worth of planes each), else bands of
// `rows` rows (of `total` a plane) with rows_of(rows) staged rows of
// `row_bytes` each
template <typename F>
void tile(PoolGeom& g, unsigned total, unsigned long long plane_bytes,
          unsigned long long row_bytes, F rows_of) {
  const unsigned target = 4u * (unsigned)sm_count();
  const unsigned units = g.planes * g.slices;   // CTAs at a plane each
  if (plane_bytes <= kPoolStageBytes) {
    const unsigned long long fit = kPoolStageBytes / plane_bytes;
    const unsigned spread = (units + target - 1) / target;
    g.pb = (unsigned)(fit < spread ? fit : spread);
    if (g.pb < 1) g.pb = 1;
    g.bands = 1;
    g.band_rows = total;
    return;
  }
  g.pb = 1;
  unsigned most = 1;   // rows a band may hold within the budget
  while (most < total && rows_of(most + 1) * row_bytes <= kPoolStageBytes)
    ++most;
  unsigned bands = (total + most - 1) / most;
  const unsigned spread = (target + units - 1) / units;
  if (bands < spread) bands = spread < total ? spread : total;
  g.band_rows = (total + bands - 1) / bands;
  g.bands = (total + g.band_rows - 1) / g.band_rows;
}

// The channels a channels-last tile takes (vc: 16-byte groups): all c
// while one output row's staging, row_bytes(c), fits kPoolSliceBytes,
// else the largest multiple of 16 that divides c and fits (at least 16)
template <typename F>
void slice(PoolGeom& g, bool vc, F row_bytes) {
  g.cs = g.c;
  g.slices = 1;
  if (!vc || g.c % 16) return;
  for (unsigned d = 2; d <= g.c / 16 && row_bytes(g.cs) > kPoolSliceBytes;
       ++d)
    if ((g.c / 16) % d == 0) {
      g.cs = g.c / d;
      g.slices = d;
    }
}

// threads for `items` pieces of a CTA's work: up to 512, spread evenly
// over the rounds, a multiple of 32
inline int threads_for(unsigned long long items) {
  const unsigned long long rounds = (items + kPoolMaxThreads - 1) /
                                    kPoolMaxThreads;
  unsigned long long t = (items + rounds - 1) / rounds;
  t = (t + 31) / 32 * 32;
  return (int)(t < 64 ? 64 : t);
}

// The divisors of blockIdx.x and of the written tensor's extents as if it
// had cs channels (planes of `rows` x `cols`)
inline void divisors(PoolGeom& g, unsigned rows, unsigned cols) {
  g.by_slices = fast_div(g.slices);
  g.by_bands = fast_div(g.bands);
  g.by_plane = fast_div(rows * cols * g.cs);
  g.by_row = fast_div(cols * g.cs);
  g.by_c = fast_div(g.cs);
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// A tile past kPoolMostBytes: one output row of one plane a CTA, x read
// where it lies
template <typename T, typename P, bool VC>
int fwd_direct(const void* x, void* y, void* pick, PoolGeom g,
               cudaStream_t s) {
  constexpr unsigned V = 16 / sizeof(T);
  g.cs = g.c;
  g.slices = g.pb = g.band_rows = 1;
  g.bands = g.oh;
  divisors(g, g.oh, g.ow);
  const unsigned long long orw = (unsigned long long)g.ow * g.c;
  max_pool_fwd_kernel<T, P, 0, 0, VC, false>
      <<<g.planes * g.oh, threads_for(VC ? orw / V : orw), 0, s>>>(
          static_cast<const T*>(x), static_cast<T*>(y), static_cast<P*>(pick),
          g);
  return (int)cudaGetLastError();
}

template <typename T, typename P, int K, int S, bool VC>
int fwd(const void* x, void* y, void* pick, PoolGeom g, cudaStream_t s) {
  constexpr unsigned V = 16 / sizeof(T);
  const PoolGeom whole = g;
  const unsigned sh = g.sh, kh = g.kh;
  auto rows_of = [&](unsigned rows) {
    const unsigned long long in = (rows - 1ull) * sh + kh;
    return in < g.h ? in : (unsigned long long)g.h;
  };
  slice(g, VC, [&](unsigned cs) {
    return rows_of(1) * g.w * cs * sizeof(T);
  });
  if (K != 0 && g.slices > 1) return fwd<T, P, 0, 0, VC>(x, y, pick, whole, s);
  const unsigned long long rw = (unsigned long long)g.w * g.cs;
  tile(g, g.oh, g.h * rw * sizeof(T), rw * sizeof(T), rows_of);
  const unsigned long long span =
      g.bands == 1 ? g.pb * (unsigned long long)g.h * rw
                   : rows_of(g.band_rows) * rw;
  const size_t smem = (size_t)span * sizeof(T) + 32;
  if (smem > kPoolMostBytes) return fwd_direct<T, P, VC>(x, y, pick, whole, s);
  divisors(g, g.oh, g.ow);
  const unsigned ctas = ((g.planes + g.pb - 1) / g.pb) * g.bands * g.slices;
  const unsigned long long outs =
      (unsigned long long)g.pb * g.band_rows * g.ow * g.cs;
  const int threads = threads_for(VC ? outs / V : outs);
  auto kernel = max_pool_fwd_kernel<T, P, K, S, VC, true>;
  const int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<ctas, threads, smem, s>>>(static_cast<const T*>(x),
                                     static_cast<T*>(y),
                                     static_cast<P*>(pick), g);
  return (int)cudaGetLastError();
}

// A tile past kPoolMostBytes: one dx row of one plane a CTA, dy and the
// picks read where they lie
template <typename T, typename P, bool VC>
int bwd_direct(const void* pick, const void* dy, void* dx, PoolGeom g,
               cudaStream_t s) {
  constexpr unsigned V = 16 / sizeof(T);
  g.cs = g.c;
  g.slices = g.pb = g.band_rows = 1;
  g.bands = g.h;
  divisors(g, g.h, g.w);
  const unsigned long long rw = (unsigned long long)g.w * g.c;
  max_pool_bwd_kernel<T, P, 0, 0, VC, false>
      <<<g.planes * g.h, threads_for((rw + V - 1) / V + !VC), 0, s>>>(
          static_cast<const P*>(pick), static_cast<const T*>(dy),
          static_cast<T*>(dx), g);
  return (int)cudaGetLastError();
}

template <typename T, typename P, int K, int S, bool VC>
int bwd(const void* pick, const void* dy, void* dx, PoolGeom g,
        cudaStream_t s) {
  constexpr unsigned V = 16 / sizeof(T);
  const PoolGeom whole = g;
  const unsigned sh = g.sh, kh = g.kh, oh = g.oh;
  const unsigned long long per = sizeof(T) + sizeof(P);
  // dx rows [y0, y0 + rows) are covered by at most this many window rows
  auto windows_of = [&](unsigned rows) {
    const unsigned long long n = (rows + kh - 2ull) / sh + 1;
    return n < oh ? n : (unsigned long long)oh;
  };
  slice(g, VC, [&](unsigned cs) {
    return windows_of(1) * g.ow * cs * per;
  });
  if (K != 0 && g.slices > 1)
    return bwd<T, P, 0, 0, VC>(pick, dy, dx, whole, s);
  const unsigned long long orw = (unsigned long long)g.ow * g.cs;
  const unsigned long long rw = (unsigned long long)g.w * g.cs;
  tile(g, g.h, oh * orw * per, orw * per, windows_of);
  const unsigned long long span =
      g.bands == 1 ? g.pb * (unsigned long long)oh * orw
                   : windows_of(g.band_rows) * orw;
  g.pick_off = (unsigned)((span * sizeof(T) + 32 + 15) / 16 * 16);
  const size_t smem = g.pick_off + (size_t)span * sizeof(P) + 32;
  if (smem > kPoolMostBytes)
    return bwd_direct<T, P, VC>(pick, dy, dx, whole, s);
  divisors(g, g.h, g.w);
  const unsigned chunks = (g.w + V - 1) / V;
  g.by_chunks = fast_div(chunks);
  g.by_h = fast_div(g.h);
  const unsigned ctas = ((g.planes + g.pb - 1) / g.pb) * g.bands * g.slices;
  const bool by_rows = K != 0 && sizeof(P) == 1 && !VC && g.c == 1;
  const unsigned long long rows = (unsigned long long)g.pb * g.band_rows;
  const int threads = threads_for(
      by_rows ? rows * chunks : (rows * rw + V - 1) / V + !VC);
  auto kernel = max_pool_bwd_kernel<T, P, K, S, VC, true>;
  const int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<ctas, threads, smem, s>>>(static_cast<const P*>(pick),
                                     static_cast<const T*>(dy),
                                     static_cast<T*>(dx), g);
  return (int)cudaGetLastError();
}

// the window and stride (K, S) specialized: ResNet's and GoogLeNet's 3x3/2,
// the inception pools' 3x3/1, VGG's 2x2/2; 0 reads them from g. Channels-
// last with 16-byte channel groups (vc) takes one pixel's group a thread.
// Windows of 255 places or more keep int32 picks, on the generic path.
template <typename T, bool FWD>
int by_shape(const void* a, const void* b, void* c, const PoolGeom& g,
             bool vc, cudaStream_t s) {
  const bool square = g.kh == g.kw && g.sh == g.sw;
  const int k = square ? (int)g.kh : 0, st = square ? (int)g.sh : 0;
  using B = unsigned char;
#define PTT_POOL(P, K, S, VC)                                            \
  return FWD ? fwd<T, P, K, S, VC>(a, const_cast<void*>(b), c, g, s)    \
             : bwd<T, P, K, S, VC>(a, b, c, g, s)
  if (g.kh * g.kw >= 255) PTT_POOL(int, 0, 0, false);
  if (vc) {
    if (k == 3 && st == 2) PTT_POOL(B, 3, 2, true);
    if (k == 3 && st == 1) PTT_POOL(B, 3, 1, true);
    if (k == 2 && st == 2) PTT_POOL(B, 2, 2, true);
    PTT_POOL(B, 0, 0, true);
  }
  if (k == 3 && st == 2) PTT_POOL(B, 3, 2, false);
  if (k == 3 && st == 1) PTT_POOL(B, 3, 1, false);
  if (k == 2 && st == 2) PTT_POOL(B, 2, 2, false);
  PTT_POOL(B, 0, 0, false);
#undef PTT_POOL
}

inline int geom(PoolGeom* g, long long n, long long c, long long h,
                long long w, long long oh, long long ow, int kh, int kw,
                int sh, int sw, int ph, int pw, int channels_last) {
  const long long most = n * c * (h * w > oh * ow ? h * w : oh * ow);
  if (most >= (1ll << 31) || (h + ph + kh) * (w + pw + kw) >= (1ll << 31) ||
      kh < 1 || kw < 1 || sh < 1 || sw < 1 || ph < 0 || pw < 0)
    return (int)cudaErrorInvalidValue;
  using U = unsigned;
  *g = PoolGeom{};
  g->planes = (U)(channels_last ? n : n * c);
  g->c = (U)(channels_last ? c : 1);
  g->h = (U)h;
  g->w = (U)w;
  g->oh = (U)oh;
  g->ow = (U)ow;
  g->kh = (U)kh;
  g->kw = (U)kw;
  g->sh = (U)sh;
  g->sw = (U)sw;
  g->ph = (U)ph;
  g->pw = (U)pw;
  return 0;
}

}  // namespace ptt

// x [n, c, h, w] -> y [n, c, oh, ow], both NCHW-contiguous or both
// channels-last, 16-byte aligned, each of fewer than 2^31 elements (else an
// error code); pick: n * c * oh * ow bytes in y's layout where kh * kw <
// 255, else as many int32, or null for no picks. Padding: ph rows above and
// pw columns left (the rows and columns below and right that the output
// extents reach are padding too). dtype: 0 float32, 1 bfloat16.
extern "C" int ptt_max_pool_fwd(const void* x, void* y, void* pick,
                                long long n, long long c, long long h,
                                long long w, long long oh, long long ow,
                                int kh, int kw, int sh, int sw, int ph,
                                int pw, int channels_last, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n * c * oh * ow == 0) return 0;
  if (h * w == 0) return (int)cudaErrorInvalidValue;
  ptt::PoolGeom g;
  const int rc = ptt::geom(&g, n, c, h, w, oh, ow, kh, kw, sh, sw, ph, pw,
                           channels_last);
  if (rc) return rc;
  const int group = dtype == ptt::kFloat32 ? 4 : 8;
  const bool vc = channels_last && c % group == 0;
  if (dtype == ptt::kFloat32)
    return ptt::by_shape<float, true>(x, y, pick, g, vc, s);
  if (dtype == ptt::kBFloat16)
    return ptt::by_shape<__nv_bfloat16, true>(x, y, pick, g, vc, s);
  return (int)cudaErrorInvalidValue;
}

// dx [n, c, h, w] from pick and dy [n, c, oh, ow] (the forward's, in dx's
// layout), all 16-byte aligned; the geometry and dtype as the forward's.
extern "C" int ptt_max_pool_bwd(const void* pick, const void* dy, void* dx,
                                long long n, long long c, long long h,
                                long long w, long long oh, long long ow,
                                int kh, int kw, int sh, int sw, int ph,
                                int pw, int channels_last, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n * c * h * w == 0) return 0;
  if (oh * ow == 0) return (int)cudaErrorInvalidValue;
  ptt::PoolGeom g;
  const int rc = ptt::geom(&g, n, c, h, w, oh, ow, kh, kw, sh, sw, ph, pw,
                           channels_last);
  if (rc) return rc;
  const int group = dtype == ptt::kFloat32 ? 4 : 8;
  const bool vc = channels_last && c % group == 0;
  if (dtype == ptt::kFloat32)
    return ptt::by_shape<float, false>(pick, dy, dx, g, vc, s);
  if (dtype == ptt::kBFloat16)
    return ptt::by_shape<__nv_bfloat16, false>(pick, dy, dx, g, vc, s);
  return (int)cudaErrorInvalidValue;
}
