// The GRU recurrence as one launch a sequence each way: the forward walks
// all T positions, the backward walks them in reverse, each keeping its
// slice of the recurrent weight W [D, 3D] in shared memory for the whole
// sequence. They take the place of the per-position path of rnn_cell.cu
// (two torch.mm and two cell launches a position, 4 T launches each way)
// on every shape whose plan fits (ops/kernels/rnn_cell.py gru_seq_plan).
//
// They replace no Pallas kernel: paddle_tpu/ops/rnn_ops.py gru_scan (:78)
// over gru_step (:407) is one lax.scan, which XLA compiles into one loop
// around the two products. The function is gru_scan's as the cells state
// it (rnn_cell.cu's header, rnn_math.cuh): gate layout [u, r, c]; u and r
// are gate((x + b)[:2D] + h_prev @ W[:, :2D]), c is cand((x + b)[2D:] +
// (r h_prev) @ W[:, 2D:]), h = u h_prev + (1 - u) c blended with h_prev by
// the length mask; reverse walks positions T-1 .. 0; carries in the
// input's dtype; activation codes 0-3. As on the per-position path both
// products are rounded to the dtype before x and the bias are added
// (torch.mm writes them in the dtype), and so are the backward's drh =
// da_c @ W[:, 2D:]^T and (da_u, da_r) @ W[:, :2D]^T; the activated gates
// and r h_prev are rounded where they are made; the arithmetic is fp32,
// with the backward's carry in fp32. Only the products' order of
// summation differs from cuBLAS's.
//
// Bound on an H100: at the GRU models' shapes the bytes (B 128, T 100,
// hidden 128, bf16: about 26 MB each way, 0.008 ms) and 1.3 GFLOP of
// products; but T dependent steps, each with two exchanges between SMs,
// set the floor.
//
// Design (lstm_seq.cu's, with the GRU's two exchanges a step):
// - A thread-block cluster of C <= 8 CTAs owns 16 batch rows (the m16 of
//   mma.sync); a CTA of 256 threads owns U hidden units (U a multiple of
//   8, at most 64) and keeps W's slice for them in shared memory for all
//   T steps. Products are bf16 on the tensor cores with fp32 accumulation
//   or fp32 by FFMA, never TF32, each n-tile of 8 columns on its own warp
//   (two partial sums forward, four backward, added in one fixed order),
//   staged rounded to the dtype in shared memory; every thread then takes
//   the cells of one (row, unit) (four at U = 64).
// - Forward: the CTA holds W's u, r and c columns of its units. A step:
//   h_prev @ W_ur; the first cells (u, r, rh = r h_prev); exchange 1, rh
//   to every CTA; rh @ W_c for its units; the second cells (c and the
//   blended h); exchange 2, h to every CTA. The h and rh buffers are each
//   double-buffered, as lstm_seq.cu's h.
// - Backward: the CTA holds W's rows of its units ([U, 3D]). A step: the
//   first cells (da_u, da_c and the carry) from g1 = the later step's
//   (da_u, da_r) @ W_ur^T; exchange 1, da_u and da_c to every CTA; drh =
//   da_c @ W_c^T for its units over all D columns; the second cells (da_r,
//   carry += drh r); exchange 2, da_r to every CTA; g1 for its units over
//   all 2D columns. No partial sum crosses CTAs, so two runs, captured or
//   eager, give equal bits. dh0 = g1 of the first position + the carry,
//   as the per-position path computes it.
// - Exchanges are st.async onto the receiver's mbarrier (seq_cluster.cuh):
//   no global fence and no cluster barrier a step.

#include "gru_layout.cuh"

namespace ptt {

// Shared memory: W's slice in the dtype (gru_layout.cuh), the exchange
// buffers of 16 rows in the dtype, the products staged in fp32, then four
// mbarriers (32 bytes).
//   forward: buffers h (two) then rh (two), [16][dk + pad]; staging
//     [16][2U]; mbarriers h0, h1, rh0, rh1;
//   backward: buffers two of [16][3 dk + pad] holding (da_u, da_r, da_c)
//     at W's columns; staging [16][U]; mbarriers (exchange 1, buffer 0,
//     1), (exchange 2, buffer 0, 1).
__host__ __device__ inline int gru_buf_elems(int D, bool bf16, bool bwd) {
  return kSeqRows * seq_ld(bwd ? 3 * gru_dk(D) : gru_dk(D), bf16);
}
__host__ __device__ inline int gru_smem_bytes(int D, int U, bool bf16,
                                              bool bwd) {
  return (gru_w_elems(D, U, bf16, bwd) +
          (bwd ? 2 : 4) * gru_buf_elems(D, bf16, bwd)) *
             (bf16 ? 2 : 4) +
         4 * kSeqRows * (bwd ? U : 2 * U) + 32;
}

struct GruSeqArgs {
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
  int B, T, D, C, U, reverse, ga, na;
};

// The C fragment (rows gid, gid + 8; columns 2 tig, 2 tig + 1) of one
// warp's n-tile, rounded to T, into the staging rows of `width` floats at
// column c0
template <typename T>
__device__ __forceinline__ void gru_stage(float* st, int width, int c0,
                                          const float (&acc)[4], int lane) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    st[(gid + 8 * (i >> 1)) * width + c0 + 2 * tig + (i & 1)] =
        round_as<T>(acc[i]);
}

template <typename T>
__global__ void __launch_bounds__(kSeqThreads)
    gru_seq_fwd_kernel(GruSeqArgs a) {
  constexpr bool kBf16 = sizeof(T) == 2;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, U = a.U, nT = a.T, D3 = 3 * a.D, C = a.C;
  const int dk = gru_dk(D), ld = seq_ld(dk, kBf16);
  const int ldw = kBf16 ? ld : 3 * U;  // W's row stride
  T* ws = reinterpret_cast<T*>(smem);
  T* hs = ws + gru_w_elems(D, U, kBf16, false);
  const int buf_n = kSeqRows * ld;
  T* rs = hs + 2 * buf_n;
  float* pre = reinterpret_cast<float*>(rs + 2 * buf_n);
  const unsigned barh = seq_smem_u32(pre + kSeqRows * 2 * U);
  const unsigned barr = barh + 16;
  const int j0 = static_cast<int>(cluster.block_rank()) * U;
  const int row0 = (blockIdx.x / C) * kSeqRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  const T* bias = static_cast<const T*>(a.bias);
  const T* h0 = static_cast<const T*>(a.h0);
  T* hid = static_cast<T*>(a.hidden);
  T* gat = static_cast<T*>(a.gates);
  T* rho = static_cast<T*>(a.rh);
  // the bytes the cluster's CTAs write into a buffer a step: the rows
  // this cluster has, a pair of units a store
  const unsigned step_bytes =
      min(kSeqRows, a.B - row0) * seq_dp(D) * static_cast<int>(sizeof(T));

  seq_zero(smem, gru_smem_bytes(D, U, kBf16, false));
  __syncthreads();
  gru_load_w_fwd(ws, w, D, U, j0);
  for (int i = threadIdx.x; i < kSeqRows * D; i += kSeqThreads) {
    const int r = i / D, k = i % D;
    if (row0 + r < a.B) hs[r * ld + k] = h0[(row0 + r) * a.h0s + k];
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) seq_bar_init(barh + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // h: buffer 1 takes step 1's input, buffer 0 step 2's; rh: buffer
    // k & 1 takes step k's
    if (nT > 1) seq_bar_arm(barh + 8, step_bytes);
    if (nT > 2) seq_bar_arm(barh, step_bytes);
    seq_bar_arm(barr, step_bytes);
    if (nT > 1) seq_bar_arm(barr + 8, step_bytes);
  }

  const SeqCells cl(a, row0, j0);
  float bq[kSeqSlots][3];
#pragma unroll
  for (int s = 0; s < kSeqSlots; ++s)
#pragma unroll
    for (int q = 0; q < 3; ++q)
      bq[s][q] = (cl.on[s] && bias != nullptr)
                     ? to_f32(bias[q * D + cl.j[s]])
                     : 0.f;
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
  float xv[kSeqSlots][3];
  load_x(0, xv);
  cluster.sync();  // every CTA's buffers and barriers are ready

  for (int k = 0; k < nT; ++k) {
    const int p = a.reverse ? nT - 1 - k : k;
    const T* hb = hs + (k & 1) * buf_n;
    if (k > 0) {
      seq_bar_wait(barh + 8 * (k & 1), ((k - 1) >> 1) & 1);
      // every thread is past the wait before the buffer's next phase is
      // armed (for step k + 2), and none falls a step behind
      __syncthreads();
      if (threadIdx.x == 0 && k + 2 < nT)
        seq_bar_arm(barh + 8 * (k & 1), step_bytes);
    }
    float xn[kSeqSlots][3];
    if (k + 1 < nT) load_x(k + 1, xn);
    // the first product, h_prev @ W[:, u and r columns]: n-tile t of the
    // 2U columns on warp t % 8
    for (int t = warp; t < U / 4; t += kSeqThreads / 32) {
      float acc[4];
      seq_product<2>(acc, hb, ld, ws, ldw, 8 * t, 0, dk, lane);
      gru_stage<T>(pre, 2 * U, 8 * t, acc, lane);
    }
    __syncthreads();
    const T* rb = rs + (k & 1) * buf_n;
    const unsigned rdst = seq_smem_u32(rb);
    float uv[kSeqSlots], hpv[kSeqSlots];
    auto first = [&](const auto& acts) {
#pragma unroll
      for (int s = 0; s < kSeqSlots; ++s) {
        if (!cl.in[s]) continue;
        float rh = 0.f;
        uv[s] = hpv[s] = 0.f;
        if (cl.on[s]) {
          const int r = cl.r[s], j = cl.j[s], u = cl.u[s];
          hpv[s] = to_f32(hb[r * ld + j]);
          const GruGates g = gru_step_gates<T>(
              xv[s][0] + bq[s][0] + pre[r * 2 * U + u],
              xv[s][1] + bq[s][1] + pre[r * 2 * U + U + u], hpv[s], acts);
          uv[s] = g.u;
          rh = g.rh;
          const long long o = static_cast<long long>(cl.b[s]) * nT + p;
          T* gp = gat + o * D3 + j;
          gp[0] = from_f32<T>(g.u);
          gp[D] = from_f32<T>(g.r);
          rho[o * D + j] = from_f32<T>(g.rh);
        }
        // units j, j + 1 (0 past D: a padding column) in one store
        const float rn = __shfl_xor_sync(0xffffffffu, rh, 1);
        if (cl.on[s] && (cl.u[s] & 1) == 0)
          seq_send<T>(rdst + (cl.r[s] * ld + cl.j[s]) * sizeof(T),
                      barr + 8 * (k & 1), rh, rn, C);
      }
    };
    const bool plain_acts = a.ga == 0 && a.na == 1;
    if (plain_acts)
      first(GruDefaultActs{});
    else
      first(RnnActs{a.ga, 0, a.na});
    seq_bar_wait(barr + 8 * (k & 1), (k >> 1) & 1);
    __syncthreads();
    if (threadIdx.x == 0 && k + 2 < nT)
      seq_bar_arm(barr + 8 * (k & 1), step_bytes);
    // the second product, (r h_prev) @ W[:, c columns]
    for (int t = warp; t < U / 8; t += kSeqThreads / 32) {
      float acc[4];
      seq_product<2>(acc, rb, ld, ws, ldw, 2 * U + 8 * t, 0, dk, lane);
      gru_stage<T>(pre, U, 8 * t, acc, lane);
    }
    __syncthreads();
    const int nb = (k + 1) & 1;
    const unsigned hdst = seq_smem_u32(hs + nb * buf_n);
    auto second = [&](const auto& acts) {
#pragma unroll
      for (int s = 0; s < kSeqSlots; ++s) {
        if (!cl.in[s]) continue;
        float h = 0.f;
        if (cl.on[s]) {
          const int r = cl.r[s], j = cl.j[s];
          const float m = p < cl.len[s] ? 1.f : 0.f;
          const GruOut o = gru_step_out<T>(
              xv[s][2] + bq[s][2] + pre[r * U + cl.u[s]], uv[s], hpv[s], m,
              acts);
          h = round_as<T>(o.h);
          const long long at = static_cast<long long>(cl.b[s]) * nT + p;
          gat[at * D3 + 2 * D + j] = from_f32<T>(o.c);
          hid[at * D + j] = from_f32<T>(o.h);
        }
        if (k + 1 < nT) {
          const float hn = __shfl_xor_sync(0xffffffffu, h, 1);
          if (cl.on[s] && (cl.u[s] & 1) == 0)
            seq_send<T>(hdst + (cl.r[s] * ld + cl.j[s]) * sizeof(T),
                        barh + 8 * nb, h, hn, C);
        }
      }
    };
    if (plain_acts)
      second(GruDefaultActs{});
    else
      second(RnnActs{a.ga, 0, a.na});
#pragma unroll
    for (int s = 0; s < kSeqSlots; ++s)
#pragma unroll
      for (int q = 0; q < 3; ++q) xv[s][q] = xn[s][q];
  }
  cluster.sync();  // no CTA leaves while a peer may still address it
}

template <typename T>
__global__ void __launch_bounds__(kSeqThreads)
    gru_seq_bwd_kernel(GruSeqArgs a) {
  constexpr bool kBf16 = sizeof(T) == 2;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, U = a.U, nT = a.T, D3 = 3 * a.D, C = a.C;
  const int dk = gru_dk(D), ld = seq_ld(3 * dk, kBf16);
  const int ldw = kBf16 ? ld : U;
  T* ws = reinterpret_cast<T*>(smem);
  T* ds = ws + gru_w_elems(D, U, kBf16, true);
  const int buf_n = kSeqRows * ld;
  float* mmv = reinterpret_cast<float*>(ds + 2 * buf_n);
  const unsigned bar1 = seq_smem_u32(mmv + kSeqRows * U);
  const unsigned bar2 = bar1 + 16;
  const int j0 = static_cast<int>(cluster.block_rank()) * U;
  const int row0 = (blockIdx.x / C) * kSeqRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* w = static_cast<const T*>(a.w);
  const T* h0 = static_cast<const T*>(a.h0);
  const T* hid = static_cast<const T*>(a.hidden);
  const T* gat = static_cast<const T*>(a.gates);
  const T* dho = static_cast<const T*>(a.dh_out);
  T* dx = static_cast<T*>(a.dx);
  // a step's bytes into a buffer: exchange 1 (da_u, da_c) two gate blocks
  // of the cluster's rows, exchange 2 (da_r) one
  const unsigned block_bytes =
      min(kSeqRows, a.B - row0) * seq_dp(D) * static_cast<int>(sizeof(T));

  seq_zero(smem, gru_smem_bytes(D, U, kBf16, true));
  __syncthreads();
  gru_load_w_bwd(ws, w, D, U, j0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) seq_bar_init(bar1 + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // position k's gradients go to buffer k & 1: the last two first
    for (int k = nT - 1; k >= 0 && k >= nT - 2; --k) {
      seq_bar_arm(bar1 + 8 * (k & 1), 2 * block_bytes);
      seq_bar_arm(bar2 + 8 * (k & 1), block_bytes);
    }
  }

  const SeqCells cl(a, row0, j0);
  float carry[kSeqSlots];
#pragma unroll
  for (int s = 0; s < kSeqSlots; ++s) carry[s] = 0.f;
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
  float cur[kSeqSlots][5];
  load_step(nT - 1, cur);
  cluster.sync();  // every CTA's buffers and barriers are ready

  const bool plain_acts = a.ga == 0 && a.na == 1;
  for (int k = nT - 1; k >= 0; --k) {
    const int p = a.reverse ? nT - 1 - k : k;
    float nxt[kSeqSlots][5];
    if (k > 0) load_step(k - 1, nxt);
    T* db = ds + (k & 1) * buf_n;
    const unsigned dst = seq_smem_u32(db);
    const unsigned e1 = bar1 + 8 * (k & 1), e2 = bar2 + 8 * (k & 1);
    // buffer k & 1's phase for position k: its (nT - 1 - k) / 2-th
    const unsigned parity = ((nT - 1 - k) >> 1) & 1;
    // the first cells, from g1 (staged by the later step; zero at the
    // first): da_u and da_c to every CTA
    auto first = [&](const auto& acts) {
#pragma unroll
      for (int s = 0; s < kSeqSlots; ++s) {
        if (!cl.in[s]) continue;
        float du = 0.f, dc = 0.f;
        if (cl.on[s]) {
          const float(&v)[5] = cur[s];
          const float dh = v[4] + mmv[cl.r[s] * U + cl.u[s]] + carry[s];
          const GruGrad0 g = gru_step_bwd0(dh, v[0], v[2], v[3],
                                           p < cl.len[s] ? 1.f : 0.f, acts);
          T* o = dx + (static_cast<long long>(cl.b[s]) * nT + p) * D3 +
                 cl.j[s];
          o[0] = from_f32<T>(g.da_u);
          o[2 * D] = from_f32<T>(g.da_c);
          du = round_as<T>(g.da_u);
          dc = round_as<T>(g.da_c);
          carry[s] = g.carry;
        }
        const float dun = __shfl_xor_sync(0xffffffffu, du, 1);
        const float dcn = __shfl_xor_sync(0xffffffffu, dc, 1);
        if (cl.on[s] && (cl.u[s] & 1) == 0) {
          const unsigned at = dst + (cl.r[s] * ld + cl.j[s]) * sizeof(T);
          seq_send<T>(at, e1, du, dun, C);
          seq_send<T>(at + 2 * dk * sizeof(T), e1, dc, dcn, C);
        }
      }
    };
    if (plain_acts)
      first(GruDefaultActs{});
    else
      first(RnnActs{a.ga, 0, a.na});
    seq_bar_wait(e1, parity);
    __syncthreads();
    if (threadIdx.x == 0 && k >= 2) seq_bar_arm(e1, 2 * block_bytes);
    // drh = da_c @ W[units, c block]^T over all D columns
    for (int t = warp; t < U / 8; t += kSeqThreads / 32) {
      float acc[4];
      seq_product<4>(acc, db, ld, ws, ldw, 8 * t, 2 * dk, dk, lane);
      gru_stage<T>(mmv, U, 8 * t, acc, lane);
    }
    __syncthreads();
    auto second = [&](const auto& acts) {
#pragma unroll
      for (int s = 0; s < kSeqSlots; ++s) {
        if (!cl.in[s]) continue;
        float dr = 0.f;
        if (cl.on[s]) {
          const GruGrad1 g = gru_step_bwd1(mmv[cl.r[s] * U + cl.u[s]],
                                           cur[s][1], cur[s][3], carry[s],
                                           acts);
          dx[(static_cast<long long>(cl.b[s]) * nT + p) * D3 + D + cl.j[s]] =
              from_f32<T>(g.da_r);
          dr = round_as<T>(g.da_r);
          carry[s] = g.carry;
        }
        const float drn = __shfl_xor_sync(0xffffffffu, dr, 1);
        if (cl.on[s] && (cl.u[s] & 1) == 0)
          seq_send<T>(dst + (cl.r[s] * ld + dk + cl.j[s]) * sizeof(T), e2,
                      dr, drn, C);
      }
    };
    if (plain_acts)
      second(GruDefaultActs{});
    else
      second(RnnActs{a.ga, 0, a.na});
    seq_bar_wait(e2, parity);
    __syncthreads();
    if (threadIdx.x == 0 && k >= 2) seq_bar_arm(e2, block_bytes);
    // g1 = (da_u, da_r) @ W[units, u and r blocks]^T over all 2D columns,
    // for the earlier step
    for (int t = warp; t < U / 8; t += kSeqThreads / 32) {
      float acc[4];
      seq_product<4>(acc, db, ld, ws, ldw, 8 * t, 0, 2 * dk, lane);
      gru_stage<T>(mmv, U, 8 * t, acc, lane);
    }
    __syncthreads();
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
    mm[o] = from_f32<T>(mmv[cl.r[s] * U + cl.u[s]]);
    a.dhc[o] = carry[s];
  }
  cluster.sync();  // no CTA leaves while a peer may still address it
}

// the plan's geometry as gru_seq_plan computes it; false where it is not
// one this file launches
inline bool gru_plan_ok(int B, int T, int D, int C, int U, int dtype) {
  if (!seq_geometry_ok(B, T, D, C, U, dtype)) return false;
  const bool bf16 = dtype == kBFloat16;
  return gru_smem_bytes(D, U, bf16, false) <= kSeqSmemLimit &&
         gru_smem_bytes(D, U, bf16, true) <= kSeqSmemLimit;
}

}  // namespace ptt

// The shared memory bytes of a plan's launch (backward 0 / 1), for the
// wrapper's plan to be checked against.
extern "C" int ptt_gru_seq_smem(int D, int U, int dtype, int backward) {
  return ptt::gru_smem_bytes(D, U, dtype == ptt::kBFloat16, backward != 0);
}

// The forward over all T positions: hidden, gates [u, r, c] and r h_prev.
// Strides in elements; x's last dim, w, bias, hidden, gates and rh
// contiguous; dtype 0 fp32, 1 bf16 for every float tensor; len int32 [B]
// or null; C, U the plan's cluster size and units a CTA. Returns the
// launch's CUDA error (cudaErrorInvalidValue for arguments it does not
// take).
extern "C" int ptt_gru_seq_fwd(const void* x, long long xsb, long long xst,
                               const void* w, const void* bias,
                               const void* h0, long long h0s,
                               const void* len, void* hidden, void* gates,
                               void* rh, int B, int T, int D, int C, int U,
                               int reverse, int dtype, int ga, int na,
                               void* stream) {
  if (!ptt::gru_plan_ok(B, T, D, C, U, dtype) || !ptt::rnn_acts_ok(ga, na, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  ptt::GruSeqArgs a = {};
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
  a.B = B;
  a.T = T;
  a.D = D;
  a.C = C;
  a.U = U;
  a.reverse = reverse != 0;
  a.ga = ga;
  a.na = na;
  const bool bf16 = dtype == ptt::kBFloat16;
  const int smem = ptt::gru_smem_bytes(D, U, bf16, false);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? ptt::seq_launch(ptt::gru_seq_fwd_kernel<__nv_bfloat16>, C, B,
                             smem, s, a)
           : ptt::seq_launch(ptt::gru_seq_fwd_kernel<float>, C, B, smem, s,
                             a));
}

// The backward over all T positions in reverse order: dx [B, T, 3D] (the
// pre-activations' gradient), dh_mm [B, D] (the first position's (da_u,
// da_r) @ W[:, :2D]^T, in the dtype) and the fp32 carry dhc [B, D] after
// it. dh_out [B, T, D] contiguous or null; gates and hidden the forward's;
// the rest as ptt_gru_seq_fwd.
extern "C" int ptt_gru_seq_bwd(const void* dh_out, const void* w,
                               const void* gates, const void* hidden,
                               const void* h0, long long h0s,
                               const void* len, void* dx, void* dh_mm,
                               void* dhc, int B, int T, int D, int C, int U,
                               int reverse, int dtype, int ga, int na,
                               void* stream) {
  if (!ptt::gru_plan_ok(B, T, D, C, U, dtype) || !ptt::rnn_acts_ok(ga, na, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  ptt::GruSeqArgs a = {};
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
  a.B = B;
  a.T = T;
  a.D = D;
  a.C = C;
  a.U = U;
  a.reverse = reverse != 0;
  a.ga = ga;
  a.na = na;
  const bool bf16 = dtype == ptt::kBFloat16;
  const int smem = ptt::gru_smem_bytes(D, U, bf16, true);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? ptt::seq_launch(ptt::gru_seq_bwd_kernel<__nv_bfloat16>, C, B,
                             smem, s, a)
           : ptt::seq_launch(ptt::gru_seq_bwd_kernel<float>, C, B, smem, s,
                             a));
}

// T steps of the two exchanges alone (seq_floor_kernel<2>) at a plan's
// launch geometry (the forward's or the backward's shared memory): the
// floor of T dependent steps.
extern "C" int ptt_gru_seq_floor(int B, int T, int D, int C, int U,
                                 int dtype, int backward, void* stream) {
  if (!ptt::gru_plan_ok(B, T, D, C, U, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  // at least the floor kernel's own: its barriers and two exchanges'
  // double buffers of 4-byte slots
  const int slots = C * (8 * U < ptt::kSeqThreads ? 8 * U : ptt::kSeqThreads);
  const int own = 32 + 4 * 4 * slots;
  const int plan =
      ptt::gru_smem_bytes(D, U, dtype == ptt::kBFloat16, backward != 0);
  const int smem = plan > own ? plan : own;
  return static_cast<int>(ptt::seq_launch(ptt::seq_floor_kernel<2>, C, B,
                                          smem,
                                          static_cast<cudaStream_t>(stream),
                                          T, U));
}
