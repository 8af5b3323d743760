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
//    d_key 30), rows wider than 512 bytes, and Dv above 128. Rows of any
//    width: a key row is walked in chunks of kMaxAnyDim = 256 columns (q of
//    the first chunk held in registers, of the others read again from
//    device memory), and above 256 value columns each split is taken by
//    ceil(Dv / 256) blocks, one for each 256-column chunk of the output
//    (every one of them computes the same scores, m and l; the first
//    writes m and l). A warp still owns a page at a time, but takes one key at a
//    time with all 32 lanes: lane j loads elements [(32 i + j) E, +E) of
//    the row for i = 0, 1, ..., with the widest load (8, 4, 2 or, for
//    one-byte pages, 1 byte: E elements) that divides both row widths and
//    both arenas' alignment.
//    Keys go in tiles of 8 for the online softmax; no load is started
//    ahead. It reads the same bytes as the 16-byte kernel and keeps the
//    fixed 256-token chunk, so a row's bits still do not depend on its
//    batch. Speed was not its aim: shapes that reach it are off every
//    main path.
//
// 4. Quantized arenas (int8, or e4m3 fp8): both split kernels also take a
//    storage type of one byte, with the per-row fp32 scale arenas
//    [NB, H, bs] indexed (phys * H + head) * bs + slot. Its reference is the
//    gather path paged_attention_reference of the same file (the Pallas
//    kernel never sees int8 or fp8 pages): there every K and V element is
//    dequantized to fp32 (float(v) * scale[row]) before the attention math.
//    Here the same product is taken in registers as each 16 bytes (16
//    elements) arrive, so the bytes read stay one a element: at the
//    engine's shape (d 64) a key row is 64 bytes plus its 4-byte scale,
//    against 256 bytes at fp32. An int8 row is read as int8_t, an e4m3 row
//    as __nv_fp8_e4m3 (through f16, exact). p is not rounded: the reference
//    dequantizes to fp32 first, so its p.v is fp32 throughout. The 16-byte
//    kernel's tile of 8 loads then spans 64 keys, so a 32-token page fills
//    half of it; the loads past the page are skipped.
//
// 5. The KV write, folded into the split launch where the new rows come in
//    the arena's own type: fp32 rows into an fp32 arena, bf16 into bf16
//    (the engine's decode and verify steps on fp32 arenas). Both split
//    kernels; a template flag, so the launch without it is the kernel above
//    unchanged. It replaces the reference's dropping scatter,
//    paddle_tpu/ops/paged_decode_ops.py _write_positions
//    (`.at[phys, head, off].set(new, mode='drop')`, no Pallas kernel), which
//    the decode ops run on each layer's arenas before K4 reads them. A
//    stand-alone write moves 128 KB at the decode shape and costs a whole
//    launch; folded in, it costs a few stores of blocks that run anyway.
//    The decode ops keep the stand-alone kernel (kv_write.cu) for the
//    prefill and for rows that must be converted (a bf16, int8 or e4m3
//    arena under fp32 rows): every block that reads a fresh key would read
//    (and convert) it again, ~256 a block in a 512-row prefill, and there
//    the fold measured slower than the two launches (PERF.md).
//    - Who writes: row r's new K and V rows (k_new[r], v_new[r]) go to
//      (phys[r], head, off[r]) where keep[r] is set, written by one split
//      block of the row: its last, where that split is dead (it reads no
//      page, so the write rides on a block with nothing else to do: every
//      row shorter than the table's last chunk, the engine's decode rows
//      among them), else the block whose chunk holds the row's last
//      position; before the page walk. In the 16-byte kernel its last two
//      warps (the smallest page share of a partial chunk) write K and V;
//      in the any-width kernel warps 0 and 1, the first value chunk's block
//      K, each value chunk's block its own V columns.
//    - Fresh keys come from the input, never from the arena: for row r every
//      position t in [fresh_lo[r], len) is read from input row
//      fresh_src[r] + t - fresh_lo[r] (clamped to the n rows): the same
//      bytes the arena read would give, so a row's output equals
//      write-then-attend bit for bit wherever the rows it reads were kept.
//      In the 16-byte kernel a tile takes one of three ways, decided for
//      the whole warp: no fresh key (every tile of a decode step but its
//      last): the page loads; all keys fresh: the same 16-byte loads from
//      the input rows, another base and stride; both (one tile of a row):
//      each key from its own source. The any-width kernel picks each key's
//      row where it reads it.
//    - Why it is legal: the split kernels read pages through
//      const __restrict__ pointers with ld.global.nc, which is undefined for
//      an address the same grid writes. The writes go through separate
//      non-const pointers, and no block reads a slot the launch writes:
//      (a) a row's write lies at its position len - 1 >= fresh_lo of every
//      row of its sequence that reads it, and those rows take it from the
//      input; (b) the decode ops write only at or past a sequence's cached
//      span, inside its own pages, never into a page another sequence
//      shares (ops/paged_decode_ops.py _extend_rows, the prefix cache), so
//      no other row reads the slot through its table. Dropped rows (empty
//      decode slots with lens 0 and all-NB tables clamped onto page NB - 1)
//      read their fresh positions from the input too, so they never race
//      with a live row writing that page; their output then differs from
//      the stale-arena read of write-then-attend, and no caller reads it.
//
// Numerics are the Pallas kernel's: scale applied to q; masked columns at
// -1e9 with p = 0; fp32 m, l and acc; p rounded to the page dtype before
// p.v (not for quantized pages, as above); fp32 output. No atomics on floats
// anywhere. The split kernels' running sums are explicit fused multiply-adds
// (__fmaf_rn): a product and sum left to the compiler may be fused in one
// instantiation and not in another, and the launch that writes must give
// the bits of the one that does not.
//
// Still left: several heads a block to share the table walk, the tensor
// cores for the prefill's many rows against one table, and fusing the merge
// into the split kernel's tail for rows with a single live split.

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

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

// one byte a element: 16 int8 values, sign-extended
template <>
struct Vec16<int8_t> {
  static constexpr int E = 16;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        f[4 * k + b] = static_cast<float>(
            static_cast<int>(w[k] << (24 - 8 * b)) >> 24);
  }
};

// two e4m3 values (low byte first) as fp32, through f16: both exact
__device__ __forceinline__ float2 fp8x2_to_float2(unsigned v) {
  const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(v & 0xffffu), __NV_E4M3);
  return __half22float2(__half2(r));
}

template <>
struct Vec16<__nv_fp8_e4m3> {
  static constexpr int E = 16;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 lo = fp8x2_to_float2(w[k]);
      const float2 hi = fp8x2_to_float2(w[k] >> 16);
      f[4 * k] = lo.x;
      f[4 * k + 1] = lo.y;
      f[4 * k + 2] = hi.x;
      f[4 * k + 3] = hi.y;
    }
  }
};

__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}

// a one-byte storage type carries a per-row fp32 scale beside its pages
template <typename T>
struct Quantized {
  static constexpr bool value = false;
};
template <>
struct Quantized<int8_t> {
  static constexpr bool value = true;
};
template <>
struct Quantized<__nv_fp8_e4m3> {
  static constexpr bool value = true;
};

// p as p.v takes it: rounded to the page dtype, or fp32 for quantized pages
template <typename T>
__device__ __forceinline__ float round_p(float v) {
  if constexpr (Quantized<T>::value) {
    return v;
  } else {
    return round_as<T>(v);
  }
}

// ------------------------------------------------------ the folded write
// What a split launch that also writes the new K/V rows takes (passed by
// value; unused when the kernel's W flag is off). The new rows have the
// arena's type.
struct PagedWrite {
  const void* k_new;          // [n, h, d]
  const void* v_new;          // [n, h, dv]
  void* k_dst;                // the arenas the split reads through its
  void* v_dst;                // const pages, written through these only
  const int* phys;            // [n] page and slot of row r's write
  const int* off;
  const unsigned char* keep;  // [n] row r writes
  const int* fresh_lo;        // [n] first position read from the input
  const int* fresh_src;       // [n] the input row of that position
};

// The split block that writes row r (of nz): the last, where that split is
// dead (it reads no page: the write rides on a block with nothing else to
// do, as it does for every row shorter than the table's last chunk), else
// the one whose chunk holds the page of position len - 1
__device__ __forceinline__ int write_split(int len, int bs, int p, int nz) {
  const int cpages = chunk_pages(bs);
  int npages = len > 0 ? (len + bs - 1) / bs : 0;
  if (npages > p) npages = p;
  if ((nz - 1) * cpages >= npages) return nz - 1;
  return (npages - 1) / cpages;
}

// One warp copies columns [c0, c1) of row r's new K (is_v false) or V row
// of `head` into its arena slot
template <typename T>
__device__ void write_new_row(const PagedWrite& w, bool is_v, int row,
                              int head, int h, int bs, int width, int c0,
                              int c1, int lane) {
  const T* src = static_cast<const T*>(is_v ? w.v_new : w.k_new) +
                 ((size_t)row * h + head) * width;
  const size_t slot = ((size_t)w.phys[row] * h + head) * bs + w.off[row];
  T* dst = static_cast<T*>(is_v ? w.v_dst : w.k_dst) + slot * width;
  for (int c = c0 + lane; c < c1; c += 32) dst[c] = src[c];
}

// One tile of one page into registers: load i covers keys off + i * kpi + g
// (g the lane's key group), elements [j * E, j * E + E) of each; key k's
// row starts at page + k * stride (stride = width for a page). Keys at or
// past `live` (the page's live keys) and lanes past the row's width load
// nothing and hold zeros.
// For quantized pages `scl` holds the key's row scales: scl[i] is the scale
// of load i's key (0 past `live`).
template <typename T>
__device__ __forceinline__ void load_tile_regs(uint4 (&buf)[kTileLoads],
                                               float (&scl)[kTileLoads],
                                               const T* __restrict__ page,
                                               const float* __restrict__ rs,
                                               int width, size_t stride,
                                               int off, int live, int kpi,
                                               int g, int j) {
  constexpr int E = Vec16<T>::E;
  const bool lane_on = j * E < width;
#pragma unroll
  for (int i = 0; i < kTileLoads; ++i) {
    const int key = off + i * kpi + g;
    if (lane_on && key < live) {
      buf[i] = __ldg(reinterpret_cast<const uint4*>(
          page + (size_t)key * stride + j * E));
    } else {
      buf[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    if constexpr (Quantized<T>::value)
      scl[i] = key < live ? __ldg(rs + key) : 0.f;
  }
}

// A row's fresh keys: positions from flo on are input row src0 + position
struct FreshKeys {
  int flo;
  int src0;
};

// A K or V tile of a page (keys from position pos0) into registers, as
// load_tile_regs, with the fresh keys (W) from the input rows. The whole
// warp takes one of three ways: a tile with no fresh key (every tile of a
// decode step but its last) loads the page; a tile of fresh keys only loads
// them as a page with another base and stride; the one tile of a row that
// holds both (or a tile whose rows fall outside the input: a caller's
// fault) picks each key's source on its own.
template <typename T, bool W>
__device__ __forceinline__ void load_tile(
    uint4 (&buf)[kTileLoads], float (&scl)[kTileLoads],
    const T* __restrict__ page, const float* __restrict__ rs, int width,
    int off, int live, int kpi, int g, int j, int pos0, bool is_v,
    const FreshKeys& fr, const PagedWrite& w, int n, int h, int head) {
  if constexpr (!W) {
    load_tile_regs<T>(buf, scl, page, rs, width, width, off, live, kpi, g, j);
  } else {
    constexpr int E = Vec16<T>::E;
    const int tk = kTileLoads * kpi;
    const int fk = fr.flo - pos0;  // the page's first fresh key
    if (off + tk <= fk || fk >= live) {
      load_tile_regs<T>(buf, scl, page, rs, width, width, off, live, kpi, g,
                        j);
      return;
    }
    const T* src = static_cast<const T*>(is_v ? w.v_new : w.k_new);
    const int r = fr.src0 + pos0;  // input row of key 0
    if (fk <= off && r + off >= 0 && r + min(off + tk, live) - 1 < n) {
      load_tile_regs<T>(buf, scl, src + ((ptrdiff_t)r * h + head) * width,
                        rs, width, (size_t)h * width, off, live, kpi, g, j);
      return;
    }
    const bool lane_on = j * E < width;
#pragma unroll
    for (int i = 0; i < kTileLoads; ++i) {
      const int key = off + i * kpi + g;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (key < live && lane_on) {
        if (key < fk) {
          v = __ldg(reinterpret_cast<const uint4*>(
              page + (size_t)key * width + j * E));
        } else {
          const int sr = max(0, min(r + key, n - 1));
          v = __ldg(reinterpret_cast<const uint4*>(
              src + ((size_t)sr * h + head) * width + j * E));
        }
      }
      buf[i] = v;
    }
  }
}

// The page walk of one split block (pages first .. last - 1 of row `row`):
// its partial (acc[Dv], m, l) into the workspace
template <typename T, bool W>
__device__ __forceinline__ void split_pages(
    const float* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ trow,
    float* __restrict__ ws, int row, int head, int z, int len, int first,
    int last, int n, int h, int nb, int bs, int d, int dv, int lanes,
    float scale, const FreshKeys& fr, const PagedWrite& w) {
  constexpr int E = Vec16<T>::E;
  constexpr bool Q = Quantized<T>::value;
  __shared__ float sm_m[kPagedWarps];
  __shared__ float sm_l[kPagedWarps];
  __shared__ float sm_acc[kPagedWarps][kMaxDv];
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

  float m = kPagedMasked;  // running max
  float l = 0.f;           // running sum of exp
  float acc[E];            // this lane's slice of the output, its key group
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  uint4 kbuf[kTileLoads], vbuf[kTileLoads];
  float ksc[kTileLoads], vsc[kTileLoads];  // row scales (quantized pages)
  int page = my_first;
  int tile = 0;  // tile of the page
  int phys = 0;
  if (n_items > 0) {
    phys = trow[page];
    phys = phys < 0 ? 0 : (phys > nb - 1 ? nb - 1 : phys);
    const size_t base = ((size_t)phys * h + head) * bs;
    const int live = min(bs, len - page * bs);
    load_tile<T, W>(kbuf, ksc, k_pages + base * d, Q ? k_scales + base : 0,
                    d, 0, live, kpi, g, j, page * bs, false, fr, w, n, h,
                    head);
    load_tile<T, W>(vbuf, vsc, v_pages + base * dv, Q ? v_scales + base : 0,
                    dv, 0, live, kpi, g, j, page * bs, true, fr, w, n, h,
                    head);
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
      if constexpr (Q) {
#pragma unroll
        for (int e = 0; e < E; ++e) kf[e] = __fmul_rn(kf[e], ksc[i]);
      }
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) s = fmaf(qs[e], kf[e], s);
      for (int o = lanes >> 1; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      sc[i] = off + i * kpi + g < live ? s : kPagedMasked;
      mx = fmaxf(mx, sc[i]);
    }
    if (more)
      load_tile<T, W>(kbuf, ksc, k_pages + nbase * d,
                      Q ? k_scales + nbase : 0, d, ntile * tk, nlive, kpi, g,
                      j, npage * bs, false, fr, w, n, h, head);
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
      sc[i] = round_p<T>(pr);
    }
    // every lane of a key holds its p: count each key once
    for (int o = 16; o >= lanes; o >>= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
    l = __fmaf_rn(alpha, l, lsum);
    m = mnext;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
    for (int i = 0; i < kTileLoads; ++i) {
      float vf[E];
      Vec16<T>::unpack(vbuf[i], vf);
      if constexpr (Q) {
#pragma unroll
        for (int e = 0; e < E; ++e) vf[e] = __fmul_rn(vf[e], vsc[i]);
      }
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(sc[i], vf[e], acc[e]);
    }
    if (more)
      load_tile<T, W>(vbuf, vsc, v_pages + nbase * dv,
                      Q ? v_scales + nbase : 0, dv, ntile * tk, nlive, kpi,
                      g, j, npage * bs, true, fr, w, n, h, head);
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
    for (int w2 = 1; w2 < kPagedWarps; ++w2) mm = fmaxf(mm, sm_m[w2]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w2 = 0; w2 < kPagedWarps; ++w2) {
      const float f = expf(sm_m[w2] - mm);
      ll = __fmaf_rn(sm_l[w2], f, ll);
      aa = __fmaf_rn(sm_acc[w2][tid], f, aa);
    }
    float* part = ws + ((qrow * gridDim.z) + z) * (size_t)(dv + 2);
    part[tid] = aa;
    if (tid == 0) {
      part[dv] = mm;
      part[dv + 1] = ll;
    }
  }
}

template <typename T, bool W>
__global__ void __launch_bounds__(kPagedThreads)
    paged_split_kernel(const float* __restrict__ q,
                       const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales,
                       const int* __restrict__ tables, long long table_stride,
                       const int* __restrict__ lens, float* __restrict__ ws,
                       int n, int h, int nb, int bs, int d, int dv, int p,
                       int lanes, float scale, PagedWrite w) {
  const int head = blockIdx.x;
  const int row = blockIdx.y;
  const int z = blockIdx.z;
  const int len = lens[row];
  FreshKeys fr{0, 0};
  bool keep = false;
  if constexpr (W) {  // loaded beside the length, not after it
    keep = w.keep[row] != 0;
    fr.flo = w.fresh_lo[row];
    fr.src0 = w.fresh_src[row] - fr.flo;
  }
  int npages = len > 0 ? (len + bs - 1) / bs : 0;
  if (npages > p) npages = p;
  const int cpages = chunk_pages(bs);
  const int first = z * cpages;
  const int last = min(first + cpages, npages);
  // the block that writes the row (header note 5): its last two warps,
  // whose page share of a partial chunk is the smallest, the new K row
  // and the new V row
  if constexpr (W) {
    const int warp = threadIdx.x >> 5;
    const bool wv = warp == kPagedWarps - 1;
    if (keep && z == write_split(len, bs, p, gridDim.z) &&
        warp >= kPagedWarps - 2)
      write_new_row<T>(w, wv, row, head, h, bs, wv ? dv : d, 0,
                       wv ? dv : d, threadIdx.x & 31);
  }
  if (first < last)  // a live split
    split_pages<T, W>(q, k_pages, v_pages, k_scales, v_scales,
                      tables + (size_t)row * table_stride, ws, row, head, z,
                      len, first, last, n, h, nb, bs, d, dv, lanes, scale, fr,
                      w);
}

// ---------------------------------------------- rows of any width
// The writes of one split block of the any-width kernel: the kept row's K
// and V when this block is the row's writer (write_split). dv0/dvc: the
// value columns of the block
template <typename T>
__device__ __forceinline__ void write_if_mine(const PagedWrite& w, int row,
                                              int head, int h, int bs, int d,
                                              int dv, int dv0, int dvc,
                                              int len, int p, int z, int nz,
                                              int warp, int lane) {
  if (z != write_split(len, bs, p, nz) || !w.keep[row]) return;
  if (warp == 0 && dv0 == 0)
    write_new_row<T>(w, false, row, head, h, bs, d, 0, d, lane);
  else if (warp == 1)
    write_new_row<T>(w, true, row, head, h, bs, dv, dv0, dv0 + dvc, lane);
}

// One load of U (8, 4, 2 or 1 bytes) as E fp32 values
template <typename T, typename U>
__device__ __forceinline__ void unpack_any(const U& u, float* f) {
  constexpr int E = sizeof(U) / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < E; ++i) f[i] = to_f32(e[i]);
}

template <typename T, typename U, bool W>
__global__ void __launch_bounds__(kPagedThreads)
    paged_split_any_kernel(const float* __restrict__ q,
                           const T* __restrict__ k_pages,
                           const T* __restrict__ v_pages,
                           const float* __restrict__ k_scales,
                           const float* __restrict__ v_scales,
                           const int* __restrict__ tables,
                           long long table_stride,
                           const int* __restrict__ lens,
                           float* __restrict__ ws, int n, int h, int nb,
                           int bs, int d, int dv, int p, int ndc,
                           float scale, PagedWrite w) {
  constexpr int E = sizeof(U) / sizeof(T);       // elements a load
  constexpr int NC = kMaxAnyDim / (32 * E);      // loads a lane, at most
  constexpr bool Q = Quantized<T>::value;
  __shared__ float sm_m[kPagedWarps];
  __shared__ float sm_l[kPagedWarps];
  __shared__ float sm_acc[kPagedWarps][kMaxAnyDim];
  const int head = blockIdx.x;
  const int row = blockIdx.y;
  // blockIdx.z: the split, and the block's chunk of kMaxAnyDim value columns
  const int z = blockIdx.z / ndc;
  const int dv0 = (blockIdx.z - z * ndc) * kMaxAnyDim;
  const int dvc = min(kMaxAnyDim, dv - dv0);
  const int len = lens[row];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int npages = len > 0 ? (len + bs - 1) / bs : 0;
  if (npages > p) npages = p;
  const int cpages = chunk_pages(bs);
  const int first = z * cpages;
  int flo = 0, fsrc = 0;
  if constexpr (W) {
    write_if_mine<T>(w, row, head, h, bs, d, dv, dv0, dvc, len, p, z,
                     gridDim.z / ndc, warp, lane);
    flo = w.fresh_lo[row];
    fsrc = w.fresh_src[row];
  }
  if (first >= npages) return;  // dead split: nothing read
  const int last = min(first + cpages, npages);

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
    // keys at or past fk are fresh: input row sr + key (W only)
    const int fk = W ? flo - page * bs : bs;
    const int sr = fsrc - flo + page * bs;
    const T* k_src = static_cast<const T*>(w.k_new);
    const T* v_src = static_cast<const T*>(w.v_new);
    for (int k0 = 0; k0 < live; k0 += kAnyKeys) {
      float sc[kAnyKeys];
      float mx = kPagedMasked;
#pragma unroll
      for (int i = 0; i < kAnyKeys; ++i) {
        const int key = k0 + i;  // the same for the whole warp
        float sv = 0.f;
        if (key < live) {
          const T* kr = W && key >= fk
                            ? k_src + ((size_t)min(max(sr + key, 0), n - 1) *
                                           h + head) * d
                            : k_pages + (base + key) * d;
          float ks = 1.f;
          if constexpr (Q) ks = __ldg(k_scales + base + key);
          // the key row in chunks of kMaxAnyDim columns: q of the first
          // from registers, of the others from device memory
          for (int cb = 0; cb < d; cb += kMaxAnyDim) {
#pragma unroll
            for (int ch = 0; ch < NC; ++ch) {
              const int c0 = cb + (32 * ch + lane) * E;
              if (c0 < d) {
                float kf[E];
                unpack_any<T, U>(
                    __ldg(reinterpret_cast<const U*>(kr + c0)), kf);
                if constexpr (Q) {
#pragma unroll
                  for (int e = 0; e < E; ++e) kf[e] = __fmul_rn(kf[e], ks);
                }
#pragma unroll
                for (int e = 0; e < E; ++e) {
                  const float qv =
                      cb == 0 ? qs[ch][e] : q[qrow * d + c0 + e] * scale;
                  sv = fmaf(qv, kf[e], sv);
                }
              }
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
        sc[i] = round_p<T>(pr);
      }
      l = __fmaf_rn(alpha, l, lsum);
      m = mnext;
#pragma unroll
      for (int ch = 0; ch < NC; ++ch)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[ch][e] *= alpha;
#pragma unroll
      for (int i = 0; i < kAnyKeys; ++i) {
        const int key = k0 + i;
        if (key < live) {
          const T* vr = (W && key >= fk
                             ? v_src + ((size_t)min(max(sr + key, 0), n - 1) *
                                            h + head) * dv
                             : v_pages + (base + key) * dv) + dv0;
          float vs = 1.f;
          if constexpr (Q) vs = __ldg(v_scales + base + key);
#pragma unroll
          for (int ch = 0; ch < NC; ++ch) {
            const int c0 = (32 * ch + lane) * E;
            if (c0 < dvc) {
              float vf[E];
              unpack_any<T, U>(__ldg(reinterpret_cast<const U*>(vr + c0)),
                               vf);
              if constexpr (Q) {
#pragma unroll
                for (int e = 0; e < E; ++e) vf[e] = __fmul_rn(vf[e], vs);
              }
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
      if (c < dvc) sm_acc[warp][c] = acc[ch][e];
    }
  __syncthreads();

  // the block's partial, warps merged in warp order, as the 16-byte kernel
  float mm = sm_m[0];
#pragma unroll
  for (int w = 1; w < kPagedWarps; ++w) mm = fmaxf(mm, sm_m[w]);
  float* part = ws + ((qrow * (gridDim.z / ndc)) + z) * (size_t)(dv + 2);
  for (int c = threadIdx.x; c < dvc; c += kPagedThreads) {
    float aa = 0.f;
#pragma unroll
    for (int w = 0; w < kPagedWarps; ++w)
      aa = __fmaf_rn(sm_acc[w][c], expf(sm_m[w] - mm), aa);
    part[dv0 + c] = aa;
  }
  if (threadIdx.x == 0 && dv0 == 0) {
    float ll = 0.f;
#pragma unroll
    for (int w = 0; w < kPagedWarps; ++w)
      ll = __fmaf_rn(sm_l[w], expf(sm_m[w] - mm), ll);
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
  float ll = 0.f;
  for (int z = 0; z < nlive; ++z) {
    const float* pz = part + (size_t)z * (dv + 2);
    ll += pz[dv + 1] * expf(pz[dv] - mm);
  }
  for (int c = tid; c < dv; c += blockDim.x) {
    float aa = 0.f;
    for (int z = 0; z < nlive; ++z) {
      const float* pz = part + (size_t)z * (dv + 2);
      aa += pz[c] * expf(pz[dv] - mm);
    }
    out[qrow * dv + c] = aa / (ll == 0.f ? 1.f : ll);
  }
}

inline int pow2_ceil(int v) {
  int r = 1;
  while (r < v) r <<= 1;
  return r;
}

// the widest load, in bytes (8, 4 or 2, at least one element), that divides
// both row widths and the addresses of both arenas (and of the new rows,
// when the launch writes)
inline int any_load_bytes(int d, int dv, int item, const void* kp,
                          const void* vp, const void* kn, const void* vn) {
  const size_t a = reinterpret_cast<size_t>(kp) |
                   reinterpret_cast<size_t>(vp) |
                   reinterpret_cast<size_t>(kn) |
                   reinterpret_cast<size_t>(vn);
  for (int w = 8; w > item; w >>= 1)
    if ((d * item) % w == 0 && (dv * item) % w == 0 && a % w == 0) return w;
  return item;
}

// The launches below take the write through `w`: nullptr launches the
// kernels without it (W off). Only fp32 and bf16 pages take a write (the
// caller checks).
template <typename T, typename U>
void launch_any(const float* q, const void* kp, const void* vp,
                const float* ks, const float* vs, const int* tables,
                long long table_stride, const int* lens, float* ws, int n,
                int h, int nb, int bs, int d, int dv, int p, int nz,
                float scale, const PagedWrite* w, cudaStream_t s) {
  const int ndc = (dv + kMaxAnyDim - 1) / kMaxAnyDim;
  const dim3 grid(h, n, nz * ndc);
  const T* k = static_cast<const T*>(kp);
  const T* v = static_cast<const T*>(vp);
  if constexpr (!Quantized<T>::value) {
    if (w != nullptr) {
      paged_split_any_kernel<T, U, true><<<grid, kPagedThreads, 0, s>>>(
          q, k, v, ks, vs, tables, table_stride, lens, ws, n, h, nb, bs, d,
          dv, p, ndc, scale, *w);
      return;
    }
  }
  paged_split_any_kernel<T, U, false><<<grid, kPagedThreads, 0, s>>>(
      q, k, v, ks, vs, tables, table_stride, lens, ws, n, h, nb, bs, d, dv,
      p, ndc, scale, PagedWrite{});
}

// the any-width kernel of storage type T at the widest load of lw bytes
template <typename T>
void launch_any_width(int lw, const float* q, const void* kp, const void* vp,
                      const float* ks, const float* vs, const int* tables,
                      long long table_stride, const int* lens, float* ws,
                      int n, int h, int nb, int bs, int d, int dv, int p,
                      int nz, float scale, const PagedWrite* w,
                      cudaStream_t s) {
#define PTT_ANY(U)                                                          \
  launch_any<T, U>(q, kp, vp, ks, vs, tables, table_stride, lens, ws, n, h, \
                   nb, bs, d, dv, p, nz, scale, w, s)
  // a load of U holds whole elements: no U narrower than T is instantiated
  if (lw == 8) {
    PTT_ANY(uint2);
  } else if constexpr (sizeof(T) == 4) {
    PTT_ANY(unsigned);
  } else if (lw == 4) {
    PTT_ANY(unsigned);
  } else if constexpr (sizeof(T) == 2) {
    PTT_ANY(unsigned short);
  } else if (lw == 2) {
    PTT_ANY(unsigned short);
  } else {
    PTT_ANY(unsigned char);
  }
#undef PTT_ANY
}

template <typename T>
void launch_v16(const float* q, const void* kp, const void* vp,
                const float* ks, const float* vs, const int* tables,
                long long table_stride, const int* lens, float* ws, int n,
                int h, int nb, int bs, int d, int dv, int p, int nz,
                int lanes, float scale, const PagedWrite* w, cudaStream_t s) {
  const dim3 grid(h, n, nz);
  const T* k = static_cast<const T*>(kp);
  const T* v = static_cast<const T*>(vp);
  if constexpr (!Quantized<T>::value) {
    if (w != nullptr) {
      paged_split_kernel<T, true><<<grid, kPagedThreads, 0, s>>>(
          q, k, v, ks, vs, tables, table_stride, lens, ws, n, h, nb, bs, d,
          dv, p, lanes, scale, *w);
      return;
    }
  }
  paged_split_kernel<T, false><<<grid, kPagedThreads, 0, s>>>(
      q, k, v, ks, vs, tables, table_stride, lens, ws, n, h, nb, bs, d, dv,
      p, lanes, scale, PagedWrite{});
}

}  // namespace ptt

// q: [n, h, d] fp32; k_pages: [nb, h, bs, d], v_pages: [nb, h, bs, dv], fp32
// (dtype 0), bf16 (1), int8 (2) or e4m3 fp8 (3), any d and dv; for
// int8 and fp8, k_scales and v_scales: fp32 [nb, h, bs], one scale a stored
// row (ignored for fp32 and bf16); tables: int32, row r at tables + r *
// table_stride, p entries; lens: [n] int32; workspace: fp32
// [n, h, nz, dv + 2] with nz = ceil(p / chunk_pages(bs)) (the wrapper sizes
// it with the same constant; another nz is refused), never read where not
// written; out: [n, h, dv] fp32; n <= 65535. The 16-byte kernel takes rows
// that are multiples of 16 bytes, at most 512 bytes, dv <= 128, in 16-byte
// aligned arenas (and new rows, when writing); every other row takes the
// any-width kernel.
// The write (k_new not null; header note 5), fp32 and bf16 pages only:
// k_new [n, h, d] and v_new [n, h, dv] contiguous, of the pages' dtype;
// phys, off, fresh_lo, fresh_src: [n] int32; keep: [n] one byte a row. Row
// r's new rows go to (phys[r], :, off[r]) of the arenas where keep[r] is
// set, and then 0 <= phys < nb, 0 <= off < bs, phys * bs + off the page
// slot of position lens[r] - 1 in row r's table; positions [fresh_lo[r],
// lens[r]) are read from input rows fresh_src[r] + position - fresh_lo[r].
// The arenas are written, though the pointers are const here.
// Sets *launched to 1 (16-byte split kernel) or 2 (any-width split kernel),
// plus 2 for quantized pages (3, 4), plus 8 where the launch wrote, and 0
// where nothing was launched. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for what no kernel takes.
extern "C" int ptt_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* tables,
    long long table_stride, const void* lens, void* workspace, void* out,
    int n, int h, int nb, int bs, int d, int dv, int p, int nz, float scale,
    int dtype, const void* k_new, const void* v_new, const void* phys,
    const void* off, const void* keep, const void* fresh_lo,
    const void* fresh_src, int* launched, void* stream) {
  *launched = 0;
  if (dtype < ptt::kFloat32 || dtype > ptt::kFloat8E4M3)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool quant = dtype == ptt::kInt8 || dtype == ptt::kFloat8E4M3;
  const bool write = k_new != nullptr;
  const int item = dtype == ptt::kFloat32 ? 4 : (quant ? 1 : 2);
  const int wide = (d > dv ? d : dv) * item;
  if (n < 1 || h < 1 || nb < 1 || bs < 1 || d < 1 || dv < 1 || p < 1 ||
      n > 65535 || (quant && (k_scales == nullptr || v_scales == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (write && (quant || v_new == nullptr || phys == nullptr ||
                off == nullptr || keep == nullptr || fresh_lo == nullptr ||
                fresh_src == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cpages = ptt::chunk_pages(bs);
  const int ndc = (dv + ptt::kMaxAnyDim - 1) / ptt::kMaxAnyDim;
  if (nz != (p + cpages - 1) / cpages || (long long)nz * ndc > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lens);
  float* ws = static_cast<float*>(workspace);
  ptt::PagedWrite pw{};
  if (write) {
    pw.k_new = k_new;
    pw.v_new = v_new;
    pw.k_dst = const_cast<void*>(k_pages);
    pw.v_dst = const_cast<void*>(v_pages);
    pw.phys = static_cast<const int*>(phys);
    pw.off = static_cast<const int*>(off);
    pw.keep = static_cast<const unsigned char*>(keep);
    pw.fresh_lo = static_cast<const int*>(fresh_lo);
    pw.fresh_src = static_cast<const int*>(fresh_src);
  }
  const ptt::PagedWrite* w = write ? &pw : nullptr;
  const size_t align = reinterpret_cast<size_t>(k_pages) |
                       reinterpret_cast<size_t>(v_pages) |
                       reinterpret_cast<size_t>(k_new) |
                       reinterpret_cast<size_t>(v_new);
  const bool v16 = dv <= ptt::kMaxDv && (d * item) % 16 == 0 &&
                   (dv * item) % 16 == 0 && wide <= 512 && align % 16 == 0;
  const int lanes = ptt::pow2_ceil(wide / 16);  // the 16-byte kernel's
  using B = __nv_bfloat16;
  using F8 = __nv_fp8_e4m3;
  if (!v16) {
    const int lw =
        ptt::any_load_bytes(d, dv, item, k_pages, v_pages, k_new, v_new);
#define PTT_ANY(T)                                                        \
  ptt::launch_any_width<T>(lw, qf, k_pages, v_pages, ks, vs, tb,          \
                           table_stride, ln, ws, n, h, nb, bs, d, dv, p,  \
                           nz, scale, w, s)
    if (dtype == ptt::kFloat32) PTT_ANY(float);
    else if (dtype == ptt::kBFloat16) PTT_ANY(B);
    else if (dtype == ptt::kInt8) PTT_ANY(int8_t);
    else PTT_ANY(F8);
#undef PTT_ANY
  } else {
#define PTT_V16(T)                                                         \
  ptt::launch_v16<T>(qf, k_pages, v_pages, ks, vs, tb, table_stride, ln,  \
                     ws, n, h, nb, bs, d, dv, p, nz, lanes, scale, w, s)
    if (dtype == ptt::kFloat32) PTT_V16(float);
    else if (dtype == ptt::kBFloat16) PTT_V16(B);
    else if (dtype == ptt::kInt8) PTT_V16(int8_t);
    else PTT_V16(F8);
#undef PTT_V16
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  *launched = (v16 ? 1 : 2) + (quant ? 2 : 0) + (write ? 8 : 0);
  const int merge_threads = dv < 256 ? 32 * ((dv + 31) / 32) : 256;
  ptt::paged_merge_kernel<<<dim3(h, n), merge_threads, 0, s>>>(
      ws, ln, static_cast<float*>(out), h, bs, dv, p, nz);
  return static_cast<int>(cudaGetLastError());
}
