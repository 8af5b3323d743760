// Ragged paged attention: one query per (row, head) against that row's KV
// cache, found page by page through its block table.
//
// Replaces the TPU kernel _paged_kernel / _paged_pallas in
// paddle_tpu/ops/pallas/paged_attention.py (K4).
//
// Bound on an H100: bytes. Each live K/V element is read once and used for
// two flops (one multiply-add against q or p), so the kernel sits far below
// the card's compute roof. At the decode shape (16 rows, 8 heads, head dim
// 64, fp32 pages, 64..576 live tokens a row) one call must read ~21 MB,
// about 6.5 us at 3.35 TB/s. What decides its time is therefore how many
// 16-byte loads the whole card keeps in flight, and that no long row runs
// as one serial chain.
//
// Design (two kernels on the caller's stream):
//
// 1. paged_split_kernel, grid (H, N, Z), 4 warps a block. Block z of
//    (row, head) takes the fixed chunk of kChunkTokens = 256 tokens
//    (chunk_pages(bs) pages: 8 at bs 32) that starts at page z * chunk; a
//    block whose chunk starts at or past ceil(len / bs) exits at once and
//    writes nothing. The chunk is a constant of the kernel, never a function
//    of N, H or the grid, so a row's result is a pure function of its q,
//    pages and length: the same bits in a 16-row decode step and in a
//    512-row prefill bucket.
//    Inside a block a warp owns a page at a time (pages first + warp,
//    + 4, ...); there is no block-wide barrier in the page loop. A key row
//    of D elements is split over `lanes` = pow2ceil(max(D, Dv) * itemsize /
//    16) lanes, 16 bytes each, so one 16-byte load of a warp covers
//    32 / lanes keys (bf16, D = 64: 8 lanes a key, 4 keys; fp32: 16 lanes,
//    2 keys). A page is walked in tiles of kTileLoads = 8 such loads. The
//    partial dot products are finished with __shfl_xor_sync over the lanes
//    of a key, the tile's max and sum over the key groups the same way; each
//    warp keeps its running m, l and its 16-byte slice of acc in registers.
//    Loads in flight: plain unrolled 16-byte register loads (ld.global.nc),
//    started a tile ahead: the next tile's K loads go out as soon as this
//    tile's scores are done and its V loads right after this tile's p.v, so
//    each warp always has 4-8 KB on the way while it does its math, and the
//    16 warps an SM holds at ~120 registers a thread cover the rest of the
//    latency (16 loads a tile left room for 12 warps and was slower at
//    every shape). Registers were taken over a cp.async ring because a warp
//    touches every loaded byte exactly once, from one lane: shared memory
//    would only add a store, a load and a wait per element. Each warp reads
//    its own table entries, clamped to [0, NB-1] (a row stride of 0 serves
//    the prefill's one broadcast table); pages at or past len are never
//    read, nor are the keys of the last page past len.
//    The warps of a block merge once, at the end, through shared memory, in
//    warp order, and the block writes its partial (acc[Dv], m, l) in fp32
//    to workspace[row, head, z, :].
// 2. paged_merge_kernel, grid (H, N): works out the number of live splits
//    from len itself, reads only those, combines them in split order
//    (M = max m_z; l = sum l_z exp(m_z - M); acc likewise) and writes
//    acc / l (l = 0 -> 1: a row with no live split gives 0) as fp32.
//    A second kernel rather than "last block merges": no counter to keep
//    zero, no fence, valid under CUDA-graph replay as it stands.
//
// 3. paged_split_any_kernel, the same split (and the same merge kernel) for
//    the rows the 16-byte loads cannot take: key or value rows that are not
//    a multiple of 16 bytes (a bf16 arena with d_key 36, an fp32 one with
//    d_key 30), rows wider than 512 bytes, and Dv up to 256 (kMaxAnyDim;
//    so is D). A warp still owns a page at a time, but takes one key at a
//    time with all 32 lanes: lane j loads elements [(32 i + j) E, +E) of
//    the row for i = 0, 1, ..., with the widest load (8, 4 or 2 bytes, E
//    elements) that divides both row widths and both arenas' alignment.
//    Keys go in tiles of 8 for the online softmax; no load is started
//    ahead. It reads the same bytes as the 16-byte kernel and keeps the
//    fixed 256-token chunk, so a row's bits still do not depend on its
//    batch. Speed was not its aim: shapes that reach it are off every
//    main path.
//
// Numerics are the Pallas kernel's: scale applied to q; masked columns at
// -1e9 with p = 0; fp32 m, l and acc; p rounded to the page dtype before
// p.v; fp32 output. No atomics on floats anywhere.
//
// Still left: several heads a block to share the table walk, the tensor
// cores for the prefill's many rows against one table, and fusing the merge
// into the split kernel's tail for rows with a single live split.

#include "common.cuh"

namespace ptt {

constexpr int kPagedWarps = 4;
constexpr int kPagedThreads = 32 * kPagedWarps;
constexpr int kChunkTokens = 256;  // tokens a split block covers
constexpr int kTileLoads = 8;      // 16-byte loads of a lane per K or V tile
constexpr int kMaxDv = 128;      // the 16-byte kernel
constexpr int kMaxAnyDim = 256;  // the any-width kernel, D and Dv
constexpr int kAnyKeys = 8;      // keys of one softmax tile there
constexpr float kPagedMasked = -1e9f;

__host__ __device__ inline int chunk_pages(int bs) {
  const int c = kChunkTokens / bs;
  return c < 1 ? 1 : c;
}

// the 16 bytes one lane loads, as fp32 values
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int E = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int E = 8;
  // a bf16 is the top half of the fp32 of the same value
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x << 16);
    f[1] = __uint_as_float(u.x & 0xffff0000u);
    f[2] = __uint_as_float(u.y << 16);
    f[3] = __uint_as_float(u.y & 0xffff0000u);
    f[4] = __uint_as_float(u.z << 16);
    f[5] = __uint_as_float(u.z & 0xffff0000u);
    f[6] = __uint_as_float(u.w << 16);
    f[7] = __uint_as_float(u.w & 0xffff0000u);
  }
};

// One tile of one page into registers: load i covers keys off + i * kpi + g
// (g the lane's key group), elements [j * E, j * E + E) of each. Keys at or
// past `live` (the page's live keys) and lanes past the row's width load
// nothing and hold zeros.
template <typename T>
__device__ __forceinline__ void load_tile_regs(uint4 (&buf)[kTileLoads],
                                               const T* __restrict__ page,
                                               int width, int off, int live,
                                               int kpi, int g, int j) {
  constexpr int E = Vec16<T>::E;
  const bool lane_on = j * E < width;
#pragma unroll
  for (int i = 0; i < kTileLoads; ++i) {
    const int key = off + i * kpi + g;
    if (lane_on && key < live) {
      buf[i] = __ldg(reinterpret_cast<const uint4*>(
          page + (size_t)key * width + j * E));
    } else {
      buf[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kPagedThreads)
    paged_split_kernel(const float* __restrict__ q,
                       const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ tables, long long table_stride,
                       const int* __restrict__ lens, float* __restrict__ ws,
                       int h, int nb, int bs, int d, int dv, int p, int lanes,
                       float scale) {
  constexpr int E = Vec16<T>::E;
  __shared__ float sm_m[kPagedWarps];
  __shared__ float sm_l[kPagedWarps];
  __shared__ float sm_acc[kPagedWarps][kMaxDv];
  const int head = blockIdx.x;
  const int row = blockIdx.y;
  const int z = blockIdx.z;
  const int len = lens[row];
  int npages = len > 0 ? (len + bs - 1) / bs : 0;
  if (npages > p) npages = p;
  const int cpages = chunk_pages(bs);
  const int first = z * cpages;
  if (first >= npages) return;  // dead split: nothing written, nothing read
  const int last = min(first + cpages, npages);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane / lanes;        // key group of this lane
  const int j = lane & (lanes - 1);  // 16-byte slice of the key row
  const int kpi = 32 / lanes;        // keys one warp-wide load covers
  const int tk = kTileLoads * kpi;   // keys a tile covers
  const int tpp = (bs + tk - 1) / tk;

  // this warp's pages are my_first, my_first + kPagedWarps, ... < last;
  // its items are their tiles in order, up to the last live key
  const int my_first = first + warp;
  const int my_pages =
      my_first < last ? (last - my_first + kPagedWarps - 1) / kPagedWarps : 0;
  int n_items = 0;
  if (my_pages > 0) {
    const int pl = my_first + (my_pages - 1) * kPagedWarps;
    const int live = min(bs, len - pl * bs);
    n_items = (my_pages - 1) * tpp + (live + tk - 1) / tk;
  }

  const size_t qrow = (size_t)row * h + head;
  float qs[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int c = j * E + e;
    qs[e] = c < d ? q[qrow * d + c] * scale : 0.f;
  }
  const int* trow = tables + (size_t)row * table_stride;

  float m = kPagedMasked;  // running max
  float l = 0.f;           // running sum of exp
  float acc[E];            // this lane's slice of the output, its key group
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  uint4 kbuf[kTileLoads], vbuf[kTileLoads];
  int page = my_first;
  int tile = 0;  // tile of the page
  int phys = 0;
  if (n_items > 0) {
    phys = trow[page];
    phys = phys < 0 ? 0 : (phys > nb - 1 ? nb - 1 : phys);
    const size_t base = ((size_t)phys * h + head) * bs;
    const int live = min(bs, len - page * bs);
    load_tile_regs<T>(kbuf, k_pages + base * d, d, 0, live, kpi, g, j);
    load_tile_regs<T>(vbuf, v_pages + base * dv, dv, 0, live, kpi, g, j);
  }
  for (int t = 0; t < n_items; ++t) {
    const int off = tile * tk;
    const int live = min(bs, len - page * bs);
    // the next item, and its table entry, before this tile's math
    const bool more = t + 1 < n_items;
    int npage = page, ntile = tile + 1, nphys = phys;
    if (ntile == tpp) {
      ntile = 0;
      npage = page + kPagedWarps;
      if (more) {
        nphys = trow[npage];
        nphys = nphys < 0 ? 0 : (nphys > nb - 1 ? nb - 1 : nphys);
      }
    }
    const size_t nbase = ((size_t)nphys * h + head) * bs;
    const int nlive = min(bs, len - npage * bs);

    // scores of this tile: the lanes of a key finish its dot product
    float sc[kTileLoads];
    float mx = kPagedMasked;
#pragma unroll
    for (int i = 0; i < kTileLoads; ++i) {
      float kf[E];
      Vec16<T>::unpack(kbuf[i], kf);
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) s = fmaf(qs[e], kf[e], s);
      for (int o = lanes >> 1; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      sc[i] = off + i * kpi + g < live ? s : kPagedMasked;
      mx = fmaxf(mx, sc[i]);
    }
    if (more)
      load_tile_regs<T>(kbuf, k_pages + nbase * d, d, ntile * tk, nlive, kpi,
                        g, j);
    for (int o = 16; o >= lanes; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float mnext = fmaxf(m, mx);
    const float alpha = expf(m - mnext);
    float lsum = 0.f;
#pragma unroll
    for (int i = 0; i < kTileLoads; ++i) {
      const float pr =
          off + i * kpi + g < live ? expf(sc[i] - mnext) : 0.f;
      lsum += pr;
      sc[i] = round_as<T>(pr);
    }
    // every lane of a key holds its p: count each key once
    for (int o = 16; o >= lanes; o >>= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
    l = alpha * l + lsum;
    m = mnext;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
    for (int i = 0; i < kTileLoads; ++i) {
      float vf[E];
      Vec16<T>::unpack(vbuf[i], vf);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(sc[i], vf[e], acc[e]);
    }
    if (more)
      load_tile_regs<T>(vbuf, v_pages + nbase * dv, dv, ntile * tk, nlive,
                        kpi, g, j);
    page = npage;
    tile = ntile;
    phys = nphys;
  }

  // the key groups of a warp each hold a part of acc: add them up
#pragma unroll
  for (int e = 0; e < E; ++e)
    for (int o = 16; o >= lanes; o >>= 1)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  if (g == 0) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (j * E + e < dv) sm_acc[warp][j * E + e] = acc[e];
  }
  __syncthreads();

  // the block's partial, warps merged in warp order (a warp that had no
  // page holds m = -1e9, l = 0 and weighs exp(-1e9 - M) = 0)
  const int tid = threadIdx.x;
  if (tid < dv) {
    float mm = sm_m[0];
#pragma unroll
    for (int w = 1; w < kPagedWarps; ++w) mm = fmaxf(mm, sm_m[w]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kPagedWarps; ++w) {
      const float f = expf(sm_m[w] - mm);
      ll += sm_l[w] * f;
      aa += sm_acc[w][tid] * f;
    }
    float* part = ws + ((qrow * gridDim.z) + z) * (size_t)(dv + 2);
    part[tid] = aa;
    if (tid == 0) {
      part[dv] = mm;
      part[dv + 1] = ll;
    }
  }
}

// ---------------------------------------------- rows of any width
// One load of U (8, 4 or 2 bytes) as E fp32 values
template <typename T, typename U>
__device__ __forceinline__ void unpack_any(const U& u, float* f) {
  constexpr int E = sizeof(U) / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < E; ++i) f[i] = to_f32(e[i]);
}

template <typename T, typename U>
__global__ void __launch_bounds__(kPagedThreads)
    paged_split_any_kernel(const float* __restrict__ q,
                           const T* __restrict__ k_pages,
                           const T* __restrict__ v_pages,
                           const int* __restrict__ tables,
                           long long table_stride,
                           const int* __restrict__ lens,
                           float* __restrict__ ws, int h, int nb, int bs,
                           int d, int dv, int p, float scale) {
  constexpr int E = sizeof(U) / sizeof(T);       // elements a load
  constexpr int NC = kMaxAnyDim / (32 * E);      // loads a lane, at most
  __shared__ float sm_m[kPagedWarps];
  __shared__ float sm_l[kPagedWarps];
  __shared__ float sm_acc[kPagedWarps][kMaxAnyDim];
  const int head = blockIdx.x;
  const int row = blockIdx.y;
  const int z = blockIdx.z;
  const int len = lens[row];
  int npages = len > 0 ? (len + bs - 1) / bs : 0;
  if (npages > p) npages = p;
  const int cpages = chunk_pages(bs);
  const int first = z * cpages;
  if (first >= npages) return;  // dead split: nothing written, nothing read
  const int last = min(first + cpages, npages);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // lane's elements: (32 ch + lane) E + e, ch < NC
  const size_t qrow = (size_t)row * h + head;
  float qs[NC][E], acc[NC][E];
#pragma unroll
  for (int ch = 0; ch < NC; ++ch)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int c = (32 * ch + lane) * E + e;
      qs[ch][e] = c < d ? q[qrow * d + c] * scale : 0.f;
      acc[ch][e] = 0.f;
    }
  const int* trow = tables + (size_t)row * table_stride;
  float m = kPagedMasked;
  float l = 0.f;
  for (int page = first + warp; page < last; page += kPagedWarps) {
    int phys = trow[page];
    phys = phys < 0 ? 0 : (phys > nb - 1 ? nb - 1 : phys);
    const size_t base = ((size_t)phys * h + head) * bs;
    const int live = min(bs, len - page * bs);
    for (int k0 = 0; k0 < live; k0 += kAnyKeys) {
      float sc[kAnyKeys];
      float mx = kPagedMasked;
#pragma unroll
      for (int i = 0; i < kAnyKeys; ++i) {
        const int key = k0 + i;  // the same for the whole warp
        float sv = 0.f;
        if (key < live) {
          const T* kr = k_pages + (base + key) * d;
#pragma unroll
          for (int ch = 0; ch < NC; ++ch) {
            const int c0 = (32 * ch + lane) * E;
            if (c0 < d) {
              float kf[E];
              unpack_any<T, U>(__ldg(reinterpret_cast<const U*>(kr + c0)),
                               kf);
#pragma unroll
              for (int e = 0; e < E; ++e) sv = fmaf(qs[ch][e], kf[e], sv);
            }
          }
        }
        sv = warp_sum(sv);
        sc[i] = key < live ? sv : kPagedMasked;
        mx = fmaxf(mx, sc[i]);
      }
      const float mnext = fmaxf(m, mx);
      const float alpha = expf(m - mnext);
      float lsum = 0.f;
#pragma unroll
      for (int i = 0; i < kAnyKeys; ++i) {
        const float pr = k0 + i < live ? expf(sc[i] - mnext) : 0.f;
        lsum += pr;
        sc[i] = round_as<T>(pr);
      }
      l = alpha * l + lsum;
      m = mnext;
#pragma unroll
      for (int ch = 0; ch < NC; ++ch)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[ch][e] *= alpha;
#pragma unroll
      for (int i = 0; i < kAnyKeys; ++i) {
        if (k0 + i < live) {
          const T* vr = v_pages + (base + k0 + i) * dv;
#pragma unroll
          for (int ch = 0; ch < NC; ++ch) {
            const int c0 = (32 * ch + lane) * E;
            if (c0 < dv) {
              float vf[E];
              unpack_any<T, U>(__ldg(reinterpret_cast<const U*>(vr + c0)),
                               vf);
#pragma unroll
              for (int e = 0; e < E; ++e)
                acc[ch][e] = fmaf(sc[i], vf[e], acc[ch][e]);
            }
          }
        }
      }
    }
  }
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int ch = 0; ch < NC; ++ch)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int c = (32 * ch + lane) * E + e;
      if (c < dv) sm_acc[warp][c] = acc[ch][e];
    }
  __syncthreads();

  // the block's partial, warps merged in warp order, as the 16-byte kernel
  float mm = sm_m[0];
#pragma unroll
  for (int w = 1; w < kPagedWarps; ++w) mm = fmaxf(mm, sm_m[w]);
  float* part = ws + ((qrow * gridDim.z) + z) * (size_t)(dv + 2);
  for (int c = threadIdx.x; c < dv; c += kPagedThreads) {
    float aa = 0.f;
#pragma unroll
    for (int w = 0; w < kPagedWarps; ++w)
      aa += sm_acc[w][c] * expf(sm_m[w] - mm);
    part[c] = aa;
  }
  if (threadIdx.x == 0) {
    float ll = 0.f;
#pragma unroll
    for (int w = 0; w < kPagedWarps; ++w) ll += sm_l[w] * expf(sm_m[w] - mm);
    part[dv] = mm;
    part[dv + 1] = ll;
  }
}

__global__ void paged_merge_kernel(const float* __restrict__ ws,
                                   const int* __restrict__ lens,
                                   float* __restrict__ out, int h, int bs,
                                   int dv, int p, int nz) {
  const int head = blockIdx.x;
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const int len = lens[row];
  int npages = len > 0 ? (len + bs - 1) / bs : 0;
  if (npages > p) npages = p;
  const int cpages = chunk_pages(bs);
  const int nlive = min(nz, (npages + cpages - 1) / cpages);
  const size_t qrow = (size_t)row * h + head;
  const float* part = ws + qrow * nz * (size_t)(dv + 2);
  float mm = kPagedMasked;
  for (int z = 0; z < nlive; ++z)
    mm = fmaxf(mm, part[(size_t)z * (dv + 2) + dv]);
  float ll = 0.f, aa = 0.f;
  for (int z = 0; z < nlive; ++z) {
    const float* pz = part + (size_t)z * (dv + 2);
    const float f = expf(pz[dv] - mm);
    ll += pz[dv + 1] * f;
    if (tid < dv) aa += pz[tid] * f;
  }
  if (tid < dv) out[qrow * dv + tid] = aa / (ll == 0.f ? 1.f : ll);
}

inline int pow2_ceil(int v) {
  int r = 1;
  while (r < v) r <<= 1;
  return r;
}

// the widest load, in bytes (8, 4 or 2, at least one element), that divides
// both row widths and both arenas' addresses
inline int any_load_bytes(int d, int dv, int item, const void* kp,
                          const void* vp) {
  const size_t a = reinterpret_cast<size_t>(kp) |
                   reinterpret_cast<size_t>(vp);
  for (int w = 8; w > item; w >>= 1)
    if ((d * item) % w == 0 && (dv * item) % w == 0 && a % w == 0) return w;
  return item;
}

template <typename T, typename U>
void launch_any(const float* q, const void* kp, const void* vp,
                const int* tables, long long table_stride, const int* lens,
                float* ws, int n, int h, int nb, int bs, int d, int dv,
                int p, int nz, float scale, cudaStream_t s) {
  paged_split_any_kernel<T, U><<<dim3(h, n, nz), kPagedThreads, 0, s>>>(
      q, static_cast<const T*>(kp), static_cast<const T*>(vp), tables,
      table_stride, lens, ws, h, nb, bs, d, dv, p, scale);
}

}  // namespace ptt

// q: [n, h, d] fp32; k_pages: [nb, h, bs, d], v_pages: [nb, h, bs, dv], fp32
// (dtype 0) or bf16 (dtype 1), d and dv at most 256; tables: int32, row r
// at tables + r * table_stride, p entries; lens: [n] int32; workspace: fp32
// [n, h, nz, dv + 2] with nz = ceil(p / chunk_pages(bs)) (the wrapper sizes
// it with the same constant; another nz is refused), never read where not
// written; out: [n, h, dv] fp32; n <= 65535. The 16-byte kernel takes rows
// that are multiples of 16 bytes, at most 512 bytes, dv <= 128, in 16-byte
// aligned arenas; every other row takes the any-width kernel. Sets
// *launched to 1 (16-byte split kernel) or 2 (any-width split kernel), and
// 0 where nothing was launched. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for what no kernel takes.
extern "C" int ptt_paged_attention(const void* q, const void* k_pages,
                                   const void* v_pages, const void* tables,
                                   long long table_stride, const void* lens,
                                   void* workspace, void* out, int n, int h,
                                   int nb, int bs, int d, int dv, int p,
                                   int nz, float scale, int dtype,
                                   int* launched, void* stream) {
  *launched = 0;
  if (dtype != ptt::kFloat32 && dtype != ptt::kBFloat16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int item = dtype == ptt::kFloat32 ? 4 : 2;
  const int wide = (d > dv ? d : dv) * item;
  if (n < 1 || h < 1 || nb < 1 || bs < 1 || d < 1 || dv < 1 || p < 1 ||
      d > ptt::kMaxAnyDim || dv > ptt::kMaxAnyDim || n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cpages = ptt::chunk_pages(bs);
  if (nz != (p + cpages - 1) / cpages || nz > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(h, n, nz);
  const float* qf = static_cast<const float*>(q);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lens);
  float* ws = static_cast<float*>(workspace);
  const bool v16 = dv <= ptt::kMaxDv && (d * item) % 16 == 0 &&
                   (dv * item) % 16 == 0 && wide <= 512 &&
                   reinterpret_cast<size_t>(k_pages) % 16 == 0 &&
                   reinterpret_cast<size_t>(v_pages) % 16 == 0;
  const int lanes = ptt::pow2_ceil(wide / 16);  // the 16-byte kernel's
  if (!v16) {
    const int w = ptt::any_load_bytes(d, dv, item, k_pages, v_pages);
    using B = __nv_bfloat16;
#define PTT_ANY(T, U)                                                      \
  ptt::launch_any<T, U>(qf, k_pages, v_pages, tb, table_stride, ln, ws, n, \
                        h, nb, bs, d, dv, p, nz, scale, s)
    if (dtype == ptt::kFloat32) {
      if (w == 8) PTT_ANY(float, uint2);
      else PTT_ANY(float, unsigned);
    } else {
      if (w == 8) PTT_ANY(B, uint2);
      else if (w == 4) PTT_ANY(B, unsigned);
      else PTT_ANY(B, unsigned short);
    }
#undef PTT_ANY
    *launched = 2;
  } else if (dtype == ptt::kFloat32) {
    ptt::paged_split_kernel<float><<<grid, ptt::kPagedThreads, 0, s>>>(
        qf, static_cast<const float*>(k_pages),
        static_cast<const float*>(v_pages), tb, table_stride, ln, ws, h, nb,
        bs, d, dv, p, lanes, scale);
  } else {
    ptt::paged_split_kernel<__nv_bfloat16>
        <<<grid, ptt::kPagedThreads, 0, s>>>(
            qf, static_cast<const __nv_bfloat16*>(k_pages),
            static_cast<const __nv_bfloat16*>(v_pages), tb, table_stride, ln,
            ws, h, nb, bs, d, dv, p, lanes, scale);
  }
  if (v16) *launched = 1;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ptt::paged_merge_kernel<<<dim3(h, n), 32 * ((dv + 31) / 32), 0, s>>>(
      ws, ln, static_cast<float*>(out), h, bs, dv, p, nz);
  return static_cast<int>(cudaGetLastError());
}
