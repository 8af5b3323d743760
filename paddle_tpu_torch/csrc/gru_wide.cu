// The GRU recurrence at widths past one cluster, as one launch a sequence
// each way: the forward walks all T positions, the backward walks them in
// reverse, with W [D, 3D] spread in slices over (almost) every SM of the
// card and each step's values exchanged through L2. They take the place
// of the per-position path of rnn_cell.cu (two torch.mm and two cell
// launches a position, 4 T launches each way) wherever gru_seq.cu's
// cluster cannot hold W and ops/kernels/rnn_cell.py gru_wide_plan has a
// launch (the GRU of rnn_search and stacked_gru_tagger at hidden 512).
//
// They replace no Pallas kernel: paddle_tpu/ops/rnn_ops.py gru_scan (:78)
// over gru_step (:407) is one lax.scan, which XLA compiles into one loop
// around the two products. The function is gru_seq.cu's (its header
// states it): gate layout [u, r, c]; both products rounded to the dtype
// before x and the bias are added; the activated gates and r h_prev
// rounded where they are made; fp32 arithmetic with the backward's carry
// in fp32; the length mask, reverse and activation codes 0-3. Only the
// products' order of summation differs from cuBLAS's.
//
// Bound on an H100: at B 64 x T 100 x hidden 512 the products' 10.1
// GFLOP each way (0.150 ms at fp32's 67 TFLOP/s; bf16's 54 MB of bytes,
// 0.016 ms); but T dependent steps, each with two exchanges between SMs
// through L2, set the floor.
//
// Design:
// - A CTA of 256 threads owns 16 batch rows (a row group, the m16 of
//   mma.sync) and U units (8, 16, 32 or 64); the grid is the row groups
//   times the slices of D, at most one CTA an SM, launched cooperatively
//   (with the cluster dimension beside it) so that every CTA is resident
//   while the others wait for it. It keeps W's slice for its units in
//   shared memory for all T steps (gru_layout.cuh: forward W's u, r and c
//   columns, backward W's rows). Products are bf16 on the tensor cores
//   with fp32 accumulation or fp32 by FFMA in the same fragment, never
//   TF32, cut into pieces (n-tiles of 8 columns times slices of the
//   depth, at least one a warp) whose fp32 sums are added in one fixed
//   order and rounded to the dtype. Each CTA owns whole columns over the
//   full depth: no partial sum crosses CTAs, so two runs, captured or
//   eager, give equal bits.
// - The exchange: the history is already in global memory (the forward's
//   hidden and r h_prev outputs, the backward's dx), so a CTA publishes its
//   units' values there and adds one to its row group's counter (a
//   release at GPU scope); a consumer's thread 0 polls the counter with
//   acquire loads until every CTA of the group has arrived, and the CTA
//   then stages the group's [16, D] rows into shared memory through L2:
//   in a cluster of two CTAs of the group, each copies half the rows by
//   bulk copies multicast into both (L2 serves a row once a pair), else
//   by cp.async.cg. The counters rise over the whole sequence (two
//   arrivals a CTA a step); the wrapper zeroes them on the stream before
//   each launch. No grid-wide barrier. The next step's global loads are
//   issued after a release, so that it never waits for them.
// - Forward step: h_prev @ W_ur; the first cells (u, r, rh = r h_prev),
//   rh published; rh staged, rh @ W_c; the second cells (c and the
//   blended h), h published. A thread keeps its own cells' h in a
//   register, and one staging buffer [16, D] serves h and rh in turn.
// - Backward step: the first cells (da_u, da_c, the carry) from g1 of the
//   later step, published; (da_u, da_c) staged, drh = da_c @ W_c^T of its
//   units; the second cells (da_r, carry += drh r), published; da_r staged
//   over da_c, g1 = (da_u, da_r) @ W_ur^T of its units. dh0 = g1 of the
//   first position + the carry, as the per-position path computes it.

#include "gru_layout.cuh"

namespace ptt {

constexpr int kWideWarps = kSeqThreads / 32;
constexpr int kWideMaxGrid = 132;  // the H100 SXM's SMs

// A product of `ncols` columns is cut into pieces, each a warp's: n-tiles
// of 8 columns times slices of its depth, at least one piece a warp
__host__ __device__ inline int wide_slices(int ncols) {
  const int tiles = ncols / 8;
  return tiles >= kWideWarps ? 1 : kWideWarps / tiles;
}
// the fp32 sums of a kernel's pieces, [slice][16][ncols], for its widest
// product (the forward's first: 2U columns; the backward's: U)
__host__ __device__ inline int wide_part_floats(int U, bool bwd) {
  const int ncols = bwd ? U : 2 * U;
  return kSeqRows * ncols * wide_slices(ncols);
}
// Shared memory: W's slice (gru_layout.cuh), one staging buffer of the
// group's 16 rows in the dtype (forward [16][dk + pad] for h, then rh;
// backward [16][2 dk + pad], da_u then da_c, da_c overwritten by da_r),
// then the products' pieces in fp32.
__host__ __device__ inline int wide_smem_bytes(int D, int U, bool bf16,
                                               bool bwd) {
  const int dk = gru_dk(D);
  return (gru_w_elems(D, U, bf16, bwd) +
          kSeqRows * seq_ld(bwd ? 2 * dk : dk, bf16)) *
             (bf16 ? 2 : 4) +
         4 * wide_part_floats(U, bwd) + 16;
}

struct GruWideArgs {
  const void* x;          // forward: [B, T, 3D], strides xsb, xst
  long long xsb, xst;
  const void* w;          // [D, 3D] contiguous
  const void* bias;       // [3D] or null
  const void* h0;         // [B, D], row stride h0s
  long long h0s;
  const int* len;         // [B] or null
  void* hidden;           // [B, T, D]: the forward's output, backward's input
  void* gates;            // [B, T, 3D]: likewise
  void* rh;               // [B, T, D]: the forward's r h_prev
  const void* dh_out;     // backward: [B, T, D] or null
  void* dx;               // backward output [B, T, 3D]
  void* dh_mm;            // [B, D]: the first position's g1
  float* dhc;             // [B, D] fp32: the carry after the first position
  unsigned* count;        // [row groups]: zero at the launch
  int B, T, D, U, S, C, reverse, ga, na;  // S: CTAs a row group,
                                          // C: CTAs a cluster
};

// ------------------------------------------------------------ the exchange
// After this CTA's threads have written their values: one arrival on the
// group's counter, released at GPU scope.
__device__ __forceinline__ void wide_arrive(unsigned* count) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(count)
                 : "memory");
}

__device__ __forceinline__ unsigned long long wide_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Until the group's counter reaches `target` (acquired at GPU scope). A
// wait past 10 s means an arrival that never comes: the kernel traps (a
// launch error) rather than hold the card.
__device__ __forceinline__ void wide_wait(const unsigned* count,
                                          unsigned target) {
  if (threadIdx.x == 0) {
    unsigned v;
    unsigned long long t0 = 0;
    for (unsigned polls = 0;; ++polls) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(v)
                   : "l"(count)
                   : "memory");
      if (v >= target) break;
      if ((polls & 1023) == 1023) {
        if (t0 == 0)
          t0 = wide_ns();
        else if (wide_ns() - t0 > 10000000000ull)
          __trap();
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float ld_cg(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];\n" : "=f"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ __nv_bfloat16 ld_cg(const __nv_bfloat16* p) {
  unsigned short v;
  asm volatile("ld.global.cg.u16 %0, [%1];\n" : "=h"(v) : "l"(p) : "memory");
  return __ushort_as_bfloat16(v);
}

// The staging of a group's rows after a wait: `sets` sets of `rows` rows
// of D elements (set i's row r at src + i src_step + r rs) into dst + i
// dst_step (row stride ld). C == 1: each CTA copies every row through L2
// itself, cp.async.cg where every row is 16-byte aligned. C > 1 (a
// cluster of C CTAs of one row group, rows 16-byte aligned): CTA `rank`
// copies rows rank 16 / C .. by one bulk copy each, multicast into every
// CTA of the cluster, and each CTA waits on its own mbarrier `bar` for
// all the rows' bytes, so L2 serves a row once a cluster.
struct WideStage {
  int C, rank;
  unsigned bar, phase;

  template <typename T>
  __device__ __forceinline__ void run(T* dst, int ld, const T* src,
                                      long long rs, int rows, int D,
                                      int sets = 1, int dst_step = 0,
                                      long long src_step = 0) {
    constexpr int kVec = 16 / sizeof(T);
    if (C > 1) {
      if (threadIdx.x == 0) {
        const unsigned bytes = D * static_cast<unsigned>(sizeof(T));
        // generic-proxy writes of other SMs, acquired above, before the
        // async proxy reads them
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        seq_bar_arm(bar, bytes * rows * sets);
        const int per = kSeqRows / C;
        const unsigned short mask = static_cast<unsigned short>((1 << C) - 1);
        for (int i = 0; i < sets; ++i)
          for (int r = rank * per; r < (rank + 1) * per && r < rows; ++r)
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
                "bytes.multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(
                    seq_smem_u32(dst + i * dst_step + r * ld)),
                "l"(src + i * src_step + r * rs), "r"(bytes), "r"(bar),
                "h"(mask)
                : "memory");
      }
      seq_bar_wait(bar, phase & 1);
      ++phase;
      return;
    }
    const bool vec = D % kVec == 0 && rs % kVec == 0 && src_step % kVec == 0 &&
                     (reinterpret_cast<unsigned long long>(src) & 15) == 0;
    for (int i = 0; i < sets; ++i) {
      T* d = dst + i * dst_step;
      const T* g = src + i * src_step;
      if (vec) {
        const int per = D / kVec;
        for (int j = threadIdx.x; j < rows * per; j += kSeqThreads) {
          const int r = j / per, c = (j % per) * kVec;
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                           seq_smem_u32(d + r * ld + c)),
                       "l"(g + r * rs + c)
                       : "memory");
        }
      } else {
        for (int j = threadIdx.x; j < rows * D; j += kSeqThreads) {
          const int r = j / D, c = j % D;
          d[r * ld + c] = ld_cg(g + r * rs + c);
        }
      }
    }
    if (vec) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
};

// The cluster's geometry and, with C > 1, its mbarrier at `bar` (zeroed
// shared memory), ready before any CTA of the cluster stages
__device__ __forceinline__ WideStage wide_stager(unsigned bar) {
  cg::cluster_group cluster = cg::this_cluster();
  WideStage st = {static_cast<int>(cluster.num_blocks()),
                  static_cast<int>(cluster.block_rank()), bar, 0u};
  if (st.C > 1) {
    if (threadIdx.x == 0) {
      seq_bar_init(bar);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster.sync();
  }
  return st;
}

// No CTA leaves while a peer's bulk copies may still address it
__device__ __forceinline__ void wide_leave(const WideStage& st) {
  if (st.C > 1) cg::this_cluster().sync();
}

// ------------------------------------------------------------ the products
// The 16 staged rows (a, row stride lda) times `ncols` columns of W (b,
// row stride ldb: n-major in bf16, k-major in fp32) over depth [0,
// depth), a multiple of 16: one n-tile a piece (seq_cluster.cuh's
// product), its fp32 C fragment into part [slice][16][ncols]
template <typename T>
__device__ __forceinline__ void wide_product(float* part, int ncols,
                                             const T* a, int lda, const T* b,
                                             int ldb, int depth, int warp,
                                             int lane) {
  const int tiles = ncols / 8, slices = wide_slices(ncols);
  const int steps = depth / 16, gid = lane >> 2, tig = lane & 3;
  for (int i = warp; i < tiles * slices; i += kWideWarps) {
    const int t = i % tiles, s = i / tiles;
    const int k0 = 16 * (s * steps / slices);
    const int k1 = 16 * ((s + 1) * steps / slices);
    float acc[4];
    seq_product<2>(acc, a, lda, b, ldb, 8 * t, k0, k1 - k0, lane);
    float* o = part + s * kSeqRows * ncols + 8 * t + 2 * tig;
    o[gid * ncols] = acc[0];
    o[gid * ncols + 1] = acc[1];
    o[(gid + 8) * ncols] = acc[2];
    o[(gid + 8) * ncols + 1] = acc[3];
  }
}

// Column c of row r of a product of `ncols` columns: its pieces added in
// slice order, rounded to T (as torch.mm writes the product in the dtype)
template <typename T>
__device__ __forceinline__ float wide_sum(const float* part, int ncols,
                                          int r, int c) {
  const int slices = wide_slices(ncols);
  float v = part[r * ncols + c];
  for (int s = 1; s < slices; ++s) v += part[(s * kSeqRows + r) * ncols + c];
  return round_as<T>(v);
}

// ------------------------------------------------------------ the kernels
template <typename T>
__global__ void __launch_bounds__(kSeqThreads)
    gru_wide_fwd_kernel(GruWideArgs a) {
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, U = a.U, nT = a.T, D3 = 3 * a.D, S = a.S;
  const int dk = gru_dk(D), ld = seq_ld(dk, kBf16);
  const int ldw = kBf16 ? ld : 3 * U;
  T* ws = reinterpret_cast<T*>(smem);
  T* st = ws + gru_w_elems(D, U, kBf16, false);
  float* part = reinterpret_cast<float*>(st + kSeqRows * ld);
  // W's c columns: rows 2U.. (bf16, n-major) or columns 2U.. (fp32)
  const T* wc = ws + (kBf16 ? 2 * U * ldw : 2 * U);
  const int row0 = (blockIdx.x / S) * kSeqRows, j0 = (blockIdx.x % S) * U;
  const int rows = min(kSeqRows, a.B - row0);
  unsigned* count = a.count + blockIdx.x / S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* x = static_cast<const T*>(a.x);
  const T* bias = static_cast<const T*>(a.bias);
  const T* h0 = static_cast<const T*>(a.h0);
  T* hid = static_cast<T*>(a.hidden);
  T* gat = static_cast<T*>(a.gates);
  T* rho = static_cast<T*>(a.rh);

  seq_zero(smem, wide_smem_bytes(D, U, kBf16, false));
  __syncthreads();
  WideStage sg =
      wide_stager(seq_smem_u32(part + wide_part_floats(U, false)));
  gru_load_w_fwd(ws, static_cast<const T*>(a.w), D, U, j0);
  for (int i = threadIdx.x; i < rows * D; i += kSeqThreads) {
    const int r = i / D, k = i % D;
    st[r * ld + k] = h0[(row0 + r) * a.h0s + k];
  }

  const SeqCells cl(a, row0, j0);
  float bq[kSeqSlots][3], hpv[kSeqSlots];
#pragma unroll
  for (int s = 0; s < kSeqSlots; ++s) {
#pragma unroll
    for (int q = 0; q < 3; ++q)
      bq[s][q] = (cl.on[s] && bias != nullptr)
                     ? to_f32(bias[q * D + cl.j[s]])
                     : 0.f;
    hpv[s] = cl.on[s] ? to_f32(h0[cl.b[s] * a.h0s + cl.j[s]]) : 0.f;
  }
  auto load_x = [&](int k, float (&dst)[kSeqSlots][3]) {
    const int p = a.reverse ? nT - 1 - k : k;
#pragma unroll
    for (int s = 0; s < kSeqSlots; ++s) {
      const T* xr = x + cl.b[s] * a.xsb + p * a.xst + cl.j[s];
#pragma unroll
      for (int q = 0; q < 3; ++q)
        dst[s][q] = cl.on[s] ? to_f32(xr[q * D]) : 0.f;
    }
  };
  float xv[kSeqSlots][3], xn[kSeqSlots][3];
  load_x(0, xv);
  __syncthreads();

  const bool plain_acts = a.ga == 0 && a.na == 1;
  const long long rs = static_cast<long long>(nT) * D;  // a row's stride
  for (int k = 0; k < nT; ++k) {
    const int p = a.reverse ? nT - 1 - k : k;
    if (k > 0) {
      // h of the step before, from every CTA of the group
      wide_wait(count, 2u * k * S);
      const int pp = a.reverse ? nT - k : k - 1;
      sg.run(st, ld, hid + static_cast<long long>(row0) * rs +
                         static_cast<long long>(pp) * D,
             rs, rows, D);
    }
    // the first product, h_prev @ W[:, u and r columns of the units]
    wide_product(part, 2 * U, st, ld, ws, ldw, dk, warp, lane);
    __syncthreads();
    float uv[kSeqSlots];
    auto first = [&](const auto& acts) {
#pragma unroll
      for (int s = 0; s < kSeqSlots; ++s) {
        uv[s] = 0.f;
        if (!cl.on[s]) continue;
        const int r = cl.r[s], j = cl.j[s], u = cl.u[s];
        const GruGates g = gru_step_gates<T>(
            xv[s][0] + bq[s][0] + wide_sum<T>(part, 2 * U, r, u),
            xv[s][1] + bq[s][1] + wide_sum<T>(part, 2 * U, r, U + u), hpv[s],
            acts);
        uv[s] = g.u;
        const long long o = static_cast<long long>(cl.b[s]) * nT + p;
        T* gp = gat + o * D3 + j;
        gp[0] = from_f32<T>(g.u);
        gp[D] = from_f32<T>(g.r);
        rho[o * D + j] = from_f32<T>(g.rh);
      }
    };
    if (plain_acts)
      first(GruDefaultActs{});
    else
      first(RnnActs{a.ga, 0, a.na});
    wide_arrive(count);
    // the next step's x, in flight while this CTA waits (issued after the
    // release, so that the release does not wait for them)
    if (k + 1 < nT) load_x(k + 1, xn);
    // r h_prev of the step, from every CTA of the group
    wide_wait(count, (2u * k + 1) * S);
    sg.run(st, ld, rho + static_cast<long long>(row0) * rs +
                       static_cast<long long>(p) * D,
           rs, rows, D);
    // the second product, (r h_prev) @ W[:, c columns of the units]
    wide_product(part, U, st, ld, wc, ldw, dk, warp, lane);
    __syncthreads();
    auto second = [&](const auto& acts) {
#pragma unroll
      for (int s = 0; s < kSeqSlots; ++s) {
        if (!cl.on[s]) continue;
        const int r = cl.r[s], j = cl.j[s];
        const float m = p < cl.len[s] ? 1.f : 0.f;
        const GruOut o = gru_step_out<T>(
            xv[s][2] + bq[s][2] + wide_sum<T>(part, U, r, cl.u[s]), uv[s],
            hpv[s], m, acts);
        hpv[s] = round_as<T>(o.h);
        const long long at = static_cast<long long>(cl.b[s]) * nT + p;
        gat[at * D3 + 2 * D + j] = from_f32<T>(o.c);
        hid[at * D + j] = from_f32<T>(o.h);
      }
    };
    if (plain_acts)
      second(GruDefaultActs{});
    else
      second(RnnActs{a.ga, 0, a.na});
    if (k + 1 < nT) {
      wide_arrive(count);
#pragma unroll
      for (int s = 0; s < kSeqSlots; ++s)
#pragma unroll
        for (int q = 0; q < 3; ++q) xv[s][q] = xn[s][q];
    }
  }
  wide_leave(sg);
}

template <typename T>
__global__ void __launch_bounds__(kSeqThreads)
    gru_wide_bwd_kernel(GruWideArgs a) {
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, U = a.U, nT = a.T, D3 = 3 * a.D, S = a.S;
  const int dk = gru_dk(D), ld = seq_ld(2 * dk, kBf16);
  const int ldw = kBf16 ? seq_ld(3 * dk, true) : U;
  T* ws = reinterpret_cast<T*>(smem);
  T* ds = ws + gru_w_elems(D, U, kBf16, true);
  float* part = reinterpret_cast<float*>(ds + kSeqRows * ld);
  // W's c block: columns 2 dk.. (bf16) or rows 2 dk.. (fp32)
  const T* wc = ws + (kBf16 ? 2 * dk : 2 * dk * U);
  const int row0 = (blockIdx.x / S) * kSeqRows, j0 = (blockIdx.x % S) * U;
  const int rows = min(kSeqRows, a.B - row0);
  unsigned* count = a.count + blockIdx.x / S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* h0 = static_cast<const T*>(a.h0);
  const T* hid = static_cast<const T*>(a.hidden);
  const T* gat = static_cast<const T*>(a.gates);
  const T* dho = static_cast<const T*>(a.dh_out);
  T* dx = static_cast<T*>(a.dx);

  seq_zero(smem, wide_smem_bytes(D, U, kBf16, true));
  __syncthreads();
  WideStage sg =
      wide_stager(seq_smem_u32(part + wide_part_floats(U, true)));
  gru_load_w_bwd(ws, static_cast<const T*>(a.w), D, U, j0);

  const SeqCells cl(a, row0, j0);
  float carry[kSeqSlots], g1[kSeqSlots];
#pragma unroll
  for (int s = 0; s < kSeqSlots; ++s) carry[s] = g1[s] = 0.f;
  // a step's inputs of a cell: u, r, c, h_prev, dh_out
  auto load_step = [&](int k, float (&dst)[kSeqSlots][5]) {
    const int p = a.reverse ? nT - 1 - k : k;
    const int pp = a.reverse ? nT - k : k - 1;
#pragma unroll
    for (int s = 0; s < kSeqSlots; ++s) {
#pragma unroll
      for (int i = 0; i < 5; ++i) dst[s][i] = 0.f;
      if (!cl.on[s]) continue;
      const long long b = cl.b[s];
      const int j = cl.j[s];
      const T* g = gat + (b * nT + p) * D3 + j;
#pragma unroll
      for (int q = 0; q < 3; ++q) dst[s][q] = to_f32(g[q * D]);
      dst[s][3] = to_f32(k == 0 ? h0[b * a.h0s + j]
                                : hid[(b * nT + pp) * D + j]);
      if (dho != nullptr) dst[s][4] = to_f32(dho[(b * nT + p) * D + j]);
    }
  };
  float cur[kSeqSlots][5], nxt[kSeqSlots][5];
  load_step(nT - 1, cur);
  __syncthreads();

  const bool plain_acts = a.ga == 0 && a.na == 1;
  const long long rs = static_cast<long long>(nT) * D3;  // a row's stride
  for (int k = nT - 1; k >= 0; --k) {
    const int p = a.reverse ? nT - 1 - k : k;
    const unsigned n = nT - 1 - k;  // steps done
    const T* dxp = dx + static_cast<long long>(row0) * rs +
                   static_cast<long long>(p) * D3;
    // the first cells, from g1 of the later step (zero at the first)
    auto first = [&](const auto& acts) {
#pragma unroll
      for (int s = 0; s < kSeqSlots; ++s) {
        if (!cl.on[s]) continue;
        const float(&v)[5] = cur[s];
        const float dh = v[4] + g1[s] + carry[s];
        const GruGrad0 g = gru_step_bwd0(dh, v[0], v[2], v[3],
                                         p < cl.len[s] ? 1.f : 0.f, acts);
        carry[s] = g.carry;
        T* o = dx + (static_cast<long long>(cl.b[s]) * nT + p) * D3 +
               cl.j[s];
        o[0] = from_f32<T>(g.da_u);
        o[2 * D] = from_f32<T>(g.da_c);
      }
    };
    if (plain_acts)
      first(GruDefaultActs{});
    else
      first(RnnActs{a.ga, 0, a.na});
    wide_arrive(count);
    // the earlier step's inputs, in flight while this CTA waits
    if (k > 0) load_step(k - 1, nxt);
    // da_u and da_c of the step, from every CTA of the group
    wide_wait(count, (2u * n + 1) * S);
    sg.run(ds, ld, dxp, rs, rows, D, 2, dk, 2 * D);
    // drh = da_c @ W[units, c block]^T over all D columns
    wide_product(part, U, ds + dk, ld, wc, ldw, dk, warp, lane);
    __syncthreads();
    auto second = [&](const auto& acts) {
#pragma unroll
      for (int s = 0; s < kSeqSlots; ++s) {
        if (!cl.on[s]) continue;
        const GruGrad1 g = gru_step_bwd1(
            wide_sum<T>(part, U, cl.r[s], cl.u[s]), cur[s][1], cur[s][3],
            carry[s], acts);
        carry[s] = g.carry;
        dx[(static_cast<long long>(cl.b[s]) * nT + p) * D3 + D + cl.j[s]] =
            from_f32<T>(g.da_r);
      }
    };
    if (plain_acts)
      second(GruDefaultActs{});
    else
      second(RnnActs{a.ga, 0, a.na});
    wide_arrive(count);
    // da_r, over da_c
    wide_wait(count, (2u * n + 2) * S);
    sg.run(ds + dk, ld, dxp + D, rs, rows, D);
    // g1 = (da_u, da_r) @ W[units, u and r blocks]^T over all 2D columns,
    // for the earlier step
    wide_product(part, U, ds, ld, ws, ldw, 2 * dk, warp, lane);
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kSeqSlots; ++s)
      g1[s] = cl.on[s] ? wide_sum<T>(part, U, cl.r[s], cl.u[s]) : 0.f;
    if (k > 0) {
#pragma unroll
      for (int s = 0; s < kSeqSlots; ++s)
#pragma unroll
        for (int i = 0; i < 5; ++i) cur[s][i] = nxt[s][i];
    }
  }
  T* mm = static_cast<T*>(a.dh_mm);
#pragma unroll
  for (int s = 0; s < kSeqSlots; ++s) {
    if (!cl.on[s]) continue;
    const long long o = static_cast<long long>(cl.b[s]) * D + cl.j[s];
    mm[o] = from_f32<T>(g1[s]);
    a.dhc[o] = carry[s];
  }
  wide_leave(sg);
}

// T steps of the exchanges alone at a plan's launch: two a step, each an
// arrival, the wait for the group and the staging of its rows (the
// forward's h and r h_prev, the backward's (da_u, da_c) and da_r) from
// the [B, T, 3D] buffer a.dx.
template <typename T>
__global__ void __launch_bounds__(kSeqThreads)
    gru_wide_floor_kernel(GruWideArgs a, int backward) {
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, nT = a.T, D3 = 3 * a.D, S = a.S;
  const int dk = gru_dk(D), ld = seq_ld(backward ? 2 * dk : dk, kBf16);
  T* st = reinterpret_cast<T*>(smem) +
          gru_w_elems(D, a.U, kBf16, backward != 0);
  float* part = reinterpret_cast<float*>(st + kSeqRows * ld);
  WideStage sg = wide_stager(
      seq_smem_u32(part + wide_part_floats(a.U, backward != 0)));
  const int row0 = (blockIdx.x / S) * kSeqRows;
  const int rows = min(kSeqRows, a.B - row0);
  unsigned* count = a.count + blockIdx.x / S;
  const long long rs = static_cast<long long>(nT) * D3;
  const T* buf = static_cast<const T*>(a.dx) +
                 static_cast<long long>(row0) * rs;
  for (int k = 0; k < nT; ++k) {
    const T* at = buf + static_cast<long long>(k) * D3;
    wide_arrive(count);
    wide_wait(count, (2u * k + 1) * S);
    sg.run(st, ld, at, rs, rows, D, backward ? 2 : 1, dk, 2 * D);
    wide_arrive(count);
    wide_wait(count, (2u * k + 2) * S);
    sg.run(st + (backward ? dk : 0), ld, at + D, rs, rows, D);
  }
  wide_leave(sg);
}

// The plan's geometry as gru_wide_plan computes it (U of 8, 16, 32 or
// 64 units, S CTAs covering D with none empty, a grid of at most one CTA
// an SM; clusters of C = 2 CTAs where S is even and a row is 16-byte
// aligned, else 1), a dtype the kernels take, and both directions'
// shared memory within 227 KB; false where it is not one this file
// launches.
inline bool wide_plan_ok(int B, int T, int D, int U, int C, int dtype) {
  if (B < 1 || T < 1 || D < 1 || (U != 8 && U != 16 && U != 32 && U != 64) ||
      (dtype != kFloat32 && dtype != kBFloat16) || (C != 1 && C != 2))
    return false;
  const int S = (D + U - 1) / U, G = (B + kSeqRows - 1) / kSeqRows;
  const bool bf16 = dtype == kBFloat16;
  if (C == 2 && (S % 2 != 0 || (D * (bf16 ? 2 : 4)) % 16 != 0)) return false;
  return G * S <= kWideMaxGrid &&
         wide_smem_bytes(D, U, bf16, false) <= kSeqSmemLimit &&
         wide_smem_bytes(D, U, bf16, true) <= kSeqSmemLimit;
}

// A cooperative launch of the plan's grid, in clusters of a.C CTAs:
// every CTA resident at once, or the launch is refused
// (cudaErrorCooperativeLaunchTooLarge), and the wrapper raises.
template <typename... Args>
inline cudaError_t wide_launch(void (*kernel)(Args...), const GruWideArgs& a,
                               int smem, cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.S * ((a.B + kSeqRows - 1) / kSeqRows));
  cfg.blockDim = dim3(kSeqThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = a.C;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.C > 1 ? 2 : 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

inline GruWideArgs wide_args(int B, int T, int D, int U, int C,
                             void* count) {
  GruWideArgs a = {};
  a.B = B;
  a.T = T;
  a.D = D;
  a.U = U;
  a.S = (D + U - 1) / U;
  a.C = C;
  a.count = static_cast<unsigned*>(count);
  return a;
}

}  // namespace ptt

// The shared memory bytes of a plan's launch (backward 0 / 1), for the
// wrapper's plan to be checked against.
extern "C" int ptt_gru_wide_smem(int D, int U, int dtype, int backward) {
  return ptt::wide_smem_bytes(D, U, dtype == ptt::kBFloat16, backward != 0);
}

// The forward over all T positions: hidden, gates [u, r, c] and r h_prev,
// as ptt_gru_seq_fwd computes them. count: uint32 [ceil(B / 16)], zero.
// Strides in elements; x's last dim, w, bias, hidden, gates and rh
// contiguous; dtype 0 fp32, 1 bf16 for every float tensor; len int32 [B]
// or null; U the plan's units a CTA. Returns the launch's CUDA error
// (cudaErrorInvalidValue for arguments it does not take).
extern "C" int ptt_gru_wide_fwd(const void* x, long long xsb, long long xst,
                                const void* w, const void* bias,
                                const void* h0, long long h0s,
                                const void* len, void* hidden, void* gates,
                                void* rh, void* count, int B, int T, int D,
                                int U, int C, int reverse, int dtype, int ga,
                                int na, void* stream) {
  if (!ptt::wide_plan_ok(B, T, D, U, C, dtype) ||
      !ptt::rnn_acts_ok(ga, na, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  ptt::GruWideArgs a = ptt::wide_args(B, T, D, U, C, count);
  a.x = x;
  a.xsb = xsb;
  a.xst = xst;
  a.w = w;
  a.bias = bias;
  a.h0 = h0;
  a.h0s = h0s;
  a.len = static_cast<const int*>(len);
  a.hidden = hidden;
  a.gates = gates;
  a.rh = rh;
  a.reverse = reverse != 0;
  a.ga = ga;
  a.na = na;
  const bool bf16 = dtype == ptt::kBFloat16;
  const int smem = ptt::wide_smem_bytes(D, U, bf16, false);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? ptt::wide_launch(ptt::gru_wide_fwd_kernel<__nv_bfloat16>, a,
                              smem, s, a)
           : ptt::wide_launch(ptt::gru_wide_fwd_kernel<float>, a, smem, s,
                              a));
}

// The backward over all T positions in reverse order: dx [B, T, 3D], dh_mm
// [B, D] (the first position's (da_u, da_r) @ W[:, :2D]^T, in the dtype)
// and the fp32 carry dhc [B, D] after it, as ptt_gru_seq_bwd computes
// them. dh_out [B, T, D] contiguous or null; gates and hidden the
// forward's; count as ptt_gru_wide_fwd's; the rest as there.
extern "C" int ptt_gru_wide_bwd(const void* dh_out, const void* w,
                                const void* gates, const void* hidden,
                                const void* h0, long long h0s,
                                const void* len, void* dx, void* dh_mm,
                                void* dhc, void* count, int B, int T, int D,
                                int U, int C, int reverse, int dtype, int ga,
                                int na, void* stream) {
  if (!ptt::wide_plan_ok(B, T, D, U, C, dtype) ||
      !ptt::rnn_acts_ok(ga, na, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  ptt::GruWideArgs a = ptt::wide_args(B, T, D, U, C, count);
  a.w = w;
  a.h0 = h0;
  a.h0s = h0s;
  a.len = static_cast<const int*>(len);
  a.hidden = const_cast<void*>(hidden);
  a.gates = const_cast<void*>(gates);
  a.dh_out = dh_out;
  a.dx = dx;
  a.dh_mm = dh_mm;
  a.dhc = static_cast<float*>(dhc);
  a.reverse = reverse != 0;
  a.ga = ga;
  a.na = na;
  const bool bf16 = dtype == ptt::kBFloat16;
  const int smem = ptt::wide_smem_bytes(D, U, bf16, true);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? ptt::wide_launch(ptt::gru_wide_bwd_kernel<__nv_bfloat16>, a,
                              smem, s, a)
           : ptt::wide_launch(ptt::gru_wide_bwd_kernel<float>, a, smem, s,
                              a));
}

// T steps of the two exchanges alone (gru_wide_floor_kernel) at a plan's
// launch (the forward's or the backward's shared memory), staging from
// buf [B, T, 3D] in the dtype: the floor of T dependent steps. count as
// ptt_gru_wide_fwd's.
extern "C" int ptt_gru_wide_floor(const void* buf, void* count, int B, int T,
                                  int D, int U, int C, int dtype,
                                  int backward, void* stream) {
  if (!ptt::wide_plan_ok(B, T, D, U, C, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  ptt::GruWideArgs a = ptt::wide_args(B, T, D, U, C, count);
  a.dx = const_cast<void*>(buf);
  const bool bf16 = dtype == ptt::kBFloat16;
  const int smem = ptt::wide_smem_bytes(D, U, bf16, backward != 0);
  const int bwd = backward != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? ptt::wide_launch(ptt::gru_wide_floor_kernel<__nv_bfloat16>, a,
                              smem, s, a, bwd)
           : ptt::wide_launch(ptt::gru_wide_floor_kernel<float>, a, smem, s,
                              a, bwd));
}
