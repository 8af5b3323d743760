// The LSTM recurrence as one launch a sequence each way: the forward walks
// all T positions, the backward walks them in reverse, each keeping its
// slice of the recurrent weight W [D, 4D] in shared memory for the whole
// sequence. They take the place of the per-position path of rnn_cell.cu (a
// torch.mm and a cell launch a position, 2 T launches each way) on every
// shape whose plan fits (ops/kernels/rnn_cell.py lstm_seq_plan).
//
// They replace no Pallas kernel: paddle_tpu/ops/rnn_ops.py lstm_scan (:30)
// is one lax.scan, which XLA compiles into one loop around the product.
// The function is lstm_scan's as the cells state it (rnn_cell.cu's header,
// rnn_math.cuh): gate layout [i, f, g, o], the masked blend (a position
// past a row's length carries h and c), reverse walking positions T-1 .. 0,
// carries held in the input's dtype, activation codes 0-3. As on the
// per-position path the product h_prev @ W is rounded to the dtype before
// x and the bias are added (torch.mm writes it in the dtype), and the
// backward's dgates @ W^T likewise; only the products' order of summation
// differs from cuBLAS's.
//
// Bound on an H100: at bench_rnn_lstm's shape (B 128, T 100, hidden 128,
// bf16) the bytes, 33 MB in and out (0.0099 ms), over 1.7 GFLOP of
// products; but T dependent steps set the floor, each a product, a cell
// and an exchange between SMs, about a microsecond of latency whatever the
// bytes.
//
// Design:
// - Rows are independent, so a thread-block cluster owns 16 rows of the
//   batch (the m16 of mma.sync.m16n8k16); clusters never wait on each
//   other. Its C CTAs (C <= 8, the portable size) each own U hidden units
//   (U a multiple of 8: one mma n-tile a gate) and their four gate columns.
// - A step has three phases in a CTA of 256 threads. The product: warp w <
//   U / 8 computes its 8 units' products for the 16 rows (bf16 on the
//   tensor cores with fp32 accumulation, fp32 by FFMA, never TF32) and
//   stages them, rounded to the dtype, in shared memory. The cells: every
//   thread takes one (row, unit) of the 16 x U (four where U = 64), so the
//   step's activations run on all 8 warps; the fp32 cell c (forward) and
//   the fp32 carries dh_pass, dc_carry (backward) stay in its registers.
//   The exchange: neighbouring lanes pair their units (a shuffle) and the
//   even one stores the pair into the buffer of every CTA of the cluster
//   with st.async, which completes bytes on that CTA's mbarrier; a CTA
//   waits on its own mbarrier for all of the step's bytes. No step fences
//   global memory and no step has a cluster barrier.
// - Forward: the CTA holds W[:, gate columns of its units] and h_prev for
//   the cluster's 16 rows at full width, double-buffered (a buffer is
//   written again only after every CTA has sent the step that read it).
// - Backward: the CTA holds W's rows of its units, [U, 4D]; every CTA's
//   dgates [16, 4D] reach every CTA, which computes dh_mm for its own units
//   over all 4D columns. So every sum has one fixed order (no partials
//   cross CTAs), and two runs, captured or eager, give equal bits.
// - A step's global inputs (x; the gates, cells and output gradients) are
//   loaded into registers one step ahead; the outputs are stored as they
//   are made.

#include "seq_cluster.cuh"

namespace ptt {

// the forward's product depth (D) and the backward's (the four gate blocks
// of D rounded up to even, so a pair of units is one aligned store)
__host__ __device__ inline int seq_kf(int D) { return seq_round_up(D, 16); }
__host__ __device__ inline int seq_kb(int D) {
  return seq_round_up(4 * seq_dp(D), 64);
}
// Shared memory: W's slice and two buffers of 16 rows (h_prev forward,
// dgates backward) in the dtype, the product staged in fp32 for the cells,
// then the buffers' two mbarriers (16 bytes).
//   forward bf16: W [4U][kf + 8], row (u / 8) 32 + 8 q + u % 8 holding
//     column q D + j0 + u over k (the mma's B operand, n-major);
//   forward fp32: W [kf][4U], column (u / 8) 32 + ((u % 8) / 2) 8 + 2 q +
//     u % 2 (a lane's 8 values in two float4s);
//   backward bf16: W [U][kb + 8], row u holding W[j0 + u, q D + j] at
//     column q Dp + j (Dp = D rounded up to even; the dgates buffers'
//     columns likewise);
//   backward fp32: W [kb][U], the same columns as rows;
//   staging: forward [16][4U] (row, q U + u: the rounded h_prev @ W of the
//     CTA's gate columns), backward [16][U] (the rounded dgates @ W^T of
//     its units).
__host__ __device__ inline int seq_w_elems(int D, int U, bool bf16,
                                           bool bwd) {
  if (!bwd)
    return bf16 ? 4 * U * seq_ld(seq_kf(D), true) : seq_kf(D) * 4 * U;
  return bf16 ? U * seq_ld(seq_kb(D), true) : seq_kb(D) * U;
}
__host__ __device__ inline int seq_buf_elems(int D, bool bf16, bool bwd) {
  return kSeqRows * seq_ld(bwd ? seq_kb(D) : seq_kf(D), bf16);
}
__host__ __device__ inline int seq_stage_floats(int U, bool bwd) {
  return kSeqRows * (bwd ? U : 4 * U);
}
__host__ __device__ inline int seq_smem_bytes(int D, int U, bool bf16,
                                              bool bwd) {
  return (seq_w_elems(D, U, bf16, bwd) + 2 * seq_buf_elems(D, bf16, bwd)) *
             (bf16 ? 2 : 4) +
         4 * seq_stage_floats(U, bwd) + 16;
}

struct SeqArgs {
  const void* x;          // forward: [B, T, 4D], strides xsb, xst
  long long xsb, xst;
  const void* w;          // [D, 4D] contiguous
  const void* bias;       // [4D] or null
  const void* h0;         // [B, D], row stride h0s
  long long h0s;
  const void* c0;         // [B, D], row stride c0s
  long long c0s;
  const int* len;         // [B] or null
  void* hidden;           // forward output [B, T, D]
  void* cell;             // [B, T, D]: the forward's output, backward's input
  void* gates;            // [B, T, 4D]: likewise
  const void* dh_out;     // backward: [B, T, D] or null
  const void* dc_out;     // [B, T, D] or null
  void* dx;               // backward output [B, T, 4D]
  void* dh_mm;            // [B, D]: the first position's dgates @ W^T
  float* dh_pass;         // [B, D] fp32
  float* dc_carry;        // [B, D] fp32
  int B, T, D, C, U, reverse, ga, ca, na;
};

// ----------------------------------------------------------- the kernels
template <typename T>
__global__ void __launch_bounds__(kSeqThreads)
    lstm_seq_fwd_kernel(SeqArgs a) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kVec = 16 / sizeof(T);  // elements a 16-byte load
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, U = a.U, nT = a.T, D4 = 4 * a.D, C = a.C;
  const int kf = seq_kf(D), ld = seq_ld(kf, kBf16);
  T* ws = reinterpret_cast<T*>(smem);
  T* hs = ws + seq_w_elems(D, U, kBf16, false);
  const int buf_n = kSeqRows * ld;
  float* pre = reinterpret_cast<float*>(hs + 2 * buf_n);
  const unsigned bar0 = seq_smem_u32(pre + seq_stage_floats(U, false));
  const int j0 = static_cast<int>(cluster.block_rank()) * U;
  const int row0 = (blockIdx.x / C) * kSeqRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  const T* bias = static_cast<const T*>(a.bias);
  const T* h0 = static_cast<const T*>(a.h0);
  const T* c0 = static_cast<const T*>(a.c0);
  T* hid = static_cast<T*>(a.hidden);
  T* cel = static_cast<T*>(a.cell);
  T* gat = static_cast<T*>(a.gates);
  // the bytes the cluster's CTAs write into a buffer a step: the rows
  // this cluster has, a pair of units a store
  const unsigned step_bytes =
      min(kSeqRows, a.B - row0) * seq_dp(D) * static_cast<int>(sizeof(T));

  seq_zero(smem, seq_smem_bytes(D, U, kBf16, false));
  __syncthreads();
  // W's gate columns of this CTA's units: 16-byte loads where every run of
  // units starts aligned
  auto put_w = [&](int k, int q, int u, T v) {
    ws[kBf16 ? ((u >> 3) * 32 + q * 8 + (u & 7)) * ld + k
             : k * 4 * U + (u >> 3) * 32 + ((u & 7) >> 1) * 8 + q * 2 +
                   (u & 1)] = v;
  };
  if (D % kVec == 0) {
    const int runs = U / kVec;
#pragma unroll 4
    for (int i = threadIdx.x; i < D * 4 * runs; i += kSeqThreads) {
      const int u = (i % runs) * kVec, q = (i / runs) % 4,
                k = i / (4 * runs);
      if (j0 + u >= D) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(
          w + static_cast<long long>(k) * D4 + q * D + j0 + u);
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int t = 0; t < kVec; ++t) put_w(k, q, u + t, e[t]);
    }
  } else {
    for (int i = threadIdx.x; i < D * 4 * U; i += kSeqThreads) {
      const int u = i % U, q = (i / U) % 4, k = i / (4 * U);
      if (j0 + u < D)
        put_w(k, q, u, w[static_cast<long long>(k) * D4 + q * D + j0 + u]);
    }
  }
  for (int i = threadIdx.x; i < kSeqRows * D; i += kSeqThreads) {
    const int r = i / D, k = i % D;
    if (row0 + r < a.B) hs[r * ld + k] = h0[(row0 + r) * a.h0s + k];
  }
  if (threadIdx.x == 0) {
    seq_bar_init(bar0);
    seq_bar_init(bar0 + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // buffer 1 takes step 1's input, buffer 0 step 2's
    if (nT > 1) seq_bar_arm(bar0 + 8, step_bytes);
    if (nT > 2) seq_bar_arm(bar0, step_bytes);
  }

  const SeqCells cl(a, row0, j0);
  float cst[kSeqSlots], bq[kSeqSlots][4];
#pragma unroll
  for (int s = 0; s < kSeqSlots; ++s) {
    cst[s] = cl.on[s] ? to_f32(c0[cl.b[s] * a.c0s + cl.j[s]]) : 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      bq[s][q] = (cl.on[s] && bias != nullptr)
                     ? to_f32(bias[q * D + cl.j[s]])
                     : 0.f;
  }
  auto load_x = [&](int k, float (&dst)[kSeqSlots][4]) {
    const int p = a.reverse ? nT - 1 - k : k;
#pragma unroll
    for (int s = 0; s < kSeqSlots; ++s) {
      const T* xr = x + cl.b[s] * a.xsb + p * a.xst + cl.j[s];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        dst[s][q] = cl.on[s] ? to_f32(xr[q * D]) : 0.f;
    }
  };
  float xv[kSeqSlots][4];
  load_x(0, xv);
  cluster.sync();  // every CTA's buffers and barriers are ready

  for (int k = 0; k < nT; ++k) {
    const int p = a.reverse ? nT - 1 - k : k;
    const T* hb = hs + (k & 1) * buf_n;
    if (k > 0) {
      seq_bar_wait(bar0 + 8 * (k & 1), ((k - 1) >> 1) & 1);
      // every thread is past the wait before the buffer's next phase is
      // armed (for step k + 2), and none falls a step behind
      __syncthreads();
      if (threadIdx.x == 0 && k + 2 < nT)
        seq_bar_arm(bar0 + 8 * (k & 1), step_bytes);
    }
    float xn[kSeqSlots][4];
    if (k + 1 < nT) load_x(k + 1, xn);
    if (warp < U / 8) {
      float acc[4][4];  // [gate][C fragment: rows gid, gid + 8]
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[q][i] = 0.f;
      if constexpr (kBf16) {
#pragma unroll 4
        for (int kk = 0; kk < kf; kk += 16) {
          unsigned af[4], b01[4], b23[4];
          ldmatrix_x4(af, a_rows(hb, ld, 0, kk, lane));
          ldmatrix_x4(b01, b_rows(ws, ld, warp * 32, kk, lane));
          ldmatrix_x4(b23, b_rows(ws, ld, warp * 32 + 16, kk, lane));
          mma_bf16(acc[0], af, b01[0], b01[1]);
          mma_bf16(acc[1], af, b01[2], b01[3]);
          mma_bf16(acc[2], af, b23[0], b23[1]);
          mma_bf16(acc[3], af, b23[2], b23[3]);
        }
      } else {
        const float* wl = ws + warp * 32 + tig * 8;
#pragma unroll 2
        for (int kk = 0; kk < kf; kk += 4) {
          const float4 r0 =
              *reinterpret_cast<const float4*>(hb + gid * ld + kk);
          const float4 r1 =
              *reinterpret_cast<const float4*>(hb + (gid + 8) * ld + kk);
          const float h0v[4] = {r0.x, r0.y, r0.z, r0.w};
          const float h1v[4] = {r1.x, r1.y, r1.z, r1.w};
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const float4 wa =
                *reinterpret_cast<const float4*>(wl + (kk + s) * 4 * U);
            const float4 wb =
                *reinterpret_cast<const float4*>(wl + (kk + s) * 4 * U + 4);
            const float wv[4][2] = {{wa.x, wa.y}, {wa.z, wa.w},
                                    {wb.x, wb.y}, {wb.z, wb.w}};
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                acc[q][e] = fmaf(h0v[s], wv[q][e], acc[q][e]);
                acc[q][2 + e] = fmaf(h1v[s], wv[q][e], acc[q][2 + e]);
              }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pre[(gid + 8 * (i >> 1)) * 4 * U + q * U + warp * 8 + 2 * tig +
              (i & 1)] = round_as<T>(acc[q][i]);
    }
    __syncthreads();
    const int nb = (k + 1) & 1;
    const unsigned dst = seq_smem_u32(hs + nb * buf_n);
    auto cells = [&](const auto& acts) {
#pragma unroll
      for (int s = 0; s < kSeqSlots; ++s) {
        if (!cl.in[s]) continue;
        float h = 0.f;
        if (cl.on[s]) {
          const int r = cl.r[s], j = cl.j[s];
          float av[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            av[q] = xv[s][q] + pre[r * 4 * U + q * U + cl.u[s]] + bq[s][q];
          const float m = p < cl.len[s] ? 1.f : 0.f;
          const LstmStep st =
              lstm_step<T>(av, to_f32(hb[r * ld + j]), cst[s], m, acts);
          cst[s] = round_as<T>(st.c);
          h = round_as<T>(st.h);
          const long long o =
              (static_cast<long long>(cl.b[s]) * nT + p) * D + j;
          hid[o] = from_f32<T>(st.h);
          cel[o] = from_f32<T>(st.c);
          T* g = gat + (static_cast<long long>(cl.b[s]) * nT + p) * D4 + j;
#pragma unroll
          for (int q = 0; q < 4; ++q) g[q * D] = from_f32<T>(st.g[q]);
        }
        if (k + 1 < nT) {
          // units j, j + 1 (0 past D: a padding column) in one store
          const float hn = __shfl_xor_sync(0xffffffffu, h, 1);
          if (cl.on[s] && (cl.u[s] & 1) == 0)
            seq_send<T>(dst + (cl.r[s] * ld + cl.j[s]) * sizeof(T),
                        bar0 + 8 * nb, h, hn, C);
        }
      }
    };
    if (a.ga == 0 && a.ca == 1 && a.na == 1)
      cells(LstmDefaultActs{});
    else
      cells(RnnActs{a.ga, a.ca, a.na});
#pragma unroll
    for (int s = 0; s < kSeqSlots; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[s][q] = xn[s][q];
  }
  cluster.sync();  // no CTA leaves while a peer may still address it
}

template <typename T>
__global__ void __launch_bounds__(kSeqThreads)
    lstm_seq_bwd_kernel(SeqArgs a) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kVec = 16 / sizeof(T);
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, U = a.U, nT = a.T, D4 = 4 * a.D, C = a.C;
  const int Dp = seq_dp(D), kb = seq_kb(D), ld = seq_ld(kb, kBf16);
  T* ws = reinterpret_cast<T*>(smem);
  T* ds = ws + seq_w_elems(D, U, kBf16, true);
  const int buf_n = kSeqRows * ld;
  float* mmv = reinterpret_cast<float*>(ds + 2 * buf_n);
  const unsigned bar0 = seq_smem_u32(mmv + seq_stage_floats(U, true));
  const int j0 = static_cast<int>(cluster.block_rank()) * U;
  const int row0 = (blockIdx.x / C) * kSeqRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const T* w = static_cast<const T*>(a.w);
  const T* c0 = static_cast<const T*>(a.c0);
  const T* cel = static_cast<const T*>(a.cell);
  const T* gat = static_cast<const T*>(a.gates);
  const T* dho = static_cast<const T*>(a.dh_out);
  const T* dco = static_cast<const T*>(a.dc_out);
  T* dx = static_cast<T*>(a.dx);
  // the cluster's CTAs' writes into a dgates buffer a step: its rows, four
  // gate blocks of Dp columns
  const unsigned step_bytes = min(kSeqRows, a.B - row0) * 4 * Dp *
                              static_cast<int>(sizeof(T));

  seq_zero(smem, seq_smem_bytes(D, U, kBf16, true));
  __syncthreads();
  // W's rows of this CTA's units, gate block q at column q Dp
  auto put_w = [&](int u, int c, T v) {
    const int col = (c / D) * Dp + c % D;
    ws[kBf16 ? u * ld + col : col * U + u] = v;
  };
  if (D % kVec == 0) {
    const int runs = D4 / kVec;
#pragma unroll 4
    for (int i = threadIdx.x; i < U * runs; i += kSeqThreads) {
      const int u = i / runs, c = (i % runs) * kVec;
      if (j0 + u >= D) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(
          w + static_cast<long long>(j0 + u) * D4 + c);
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int t = 0; t < kVec; ++t) put_w(u, c + t, e[t]);
    }
  } else {
    for (int i = threadIdx.x; i < U * D4; i += kSeqThreads) {
      const int u = i / D4, c = i % D4;
      if (j0 + u < D)
        put_w(u, c, w[static_cast<long long>(j0 + u) * D4 + c]);
    }
  }
  if (threadIdx.x == 0) {
    seq_bar_init(bar0);
    seq_bar_init(bar0 + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // position k's dgates go to buffer k & 1: the last two first
    seq_bar_arm(bar0 + 8 * ((nT - 1) & 1), step_bytes);
    if (nT > 1) seq_bar_arm(bar0 + 8 * ((nT - 2) & 1), step_bytes);
  }

  const SeqCells cl(a, row0, j0);
  float dpass[kSeqSlots], dcar[kSeqSlots];
#pragma unroll
  for (int s = 0; s < kSeqSlots; ++s) dpass[s] = dcar[s] = 0.f;
  // a step's inputs of a cell: the gates [4], c, c_prev, dh_out, dc_out
  auto load_step = [&](int k, float (&dst)[kSeqSlots][8]) {
    const int p = a.reverse ? nT - 1 - k : k;
    const int pp = a.reverse ? nT - k : k - 1;
#pragma unroll
    for (int s = 0; s < kSeqSlots; ++s) {
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[s][i] = 0.f;
      if (!cl.on[s]) continue;
      const long long b = cl.b[s];
      const int j = cl.j[s];
      const long long o = (b * nT + p) * D + j;
      const T* g = gat + (b * nT + p) * D4 + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) dst[s][q] = to_f32(g[q * D]);
      dst[s][4] = to_f32(cel[o]);
      dst[s][5] = to_f32(k == 0 ? c0[b * a.c0s + j]
                                : cel[(b * nT + pp) * D + j]);
      if (dho != nullptr) dst[s][6] = to_f32(dho[o]);
      if (dco != nullptr) dst[s][7] = to_f32(dco[o]);
    }
  };
  float cur[kSeqSlots][8];
  load_step(nT - 1, cur);
  cluster.sync();  // every CTA's buffers and barriers are ready

  for (int k = nT - 1; k >= 0; --k) {
    const int p = a.reverse ? nT - 1 - k : k;
    float nxt[kSeqSlots][8];
    if (k > 0) load_step(k - 1, nxt);
    T* db = ds + (k & 1) * buf_n;
    const unsigned bar = bar0 + 8 * (k & 1);
    const unsigned dst = seq_smem_u32(db);
    auto cells = [&](const auto& acts) {
#pragma unroll
      for (int s = 0; s < kSeqSlots; ++s) {
        if (!cl.in[s]) continue;
        float da[4] = {0.f, 0.f, 0.f, 0.f};
        if (cl.on[s]) {
          const float(&v)[8] = cur[s];
          const float dh = v[6] + mmv[cl.r[s] * U + cl.u[s]] + dpass[s];
          const float dc = v[7] + dcar[s];
          const float g[4] = {v[0], v[1], v[2], v[3]};
          const LstmGrad r = lstm_step_bwd(dh, dc, g, v[4], v[5],
                                           p < cl.len[s] ? 1.f : 0.f, acts);
          T* o = dx + (static_cast<long long>(cl.b[s]) * nT + p) * D4 +
                 cl.j[s];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            o[q * D] = from_f32<T>(r.da[q]);
            da[q] = round_as<T>(r.da[q]);
          }
          dpass[s] = r.dh_pass;
          dcar[s] = r.dc_carry;
        }
        // units j, j + 1 of each gate (0 past D) in one store
        float dn[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          dn[q] = __shfl_xor_sync(0xffffffffu, da[q], 1);
        if (cl.on[s] && (cl.u[s] & 1) == 0)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            seq_send<T>(
                dst + (cl.r[s] * ld + q * Dp + cl.j[s]) * sizeof(T), bar,
                da[q], dn[q], C);
      }
    };
    if (a.ga == 0 && a.ca == 1 && a.na == 1)
      cells(LstmDefaultActs{});
    else
      cells(RnnActs{a.ga, a.ca, a.na});
    // buffer k & 1's phase for position k: its (nT - 1 - k) / 2-th
    seq_bar_wait(bar, ((nT - 1 - k) >> 1) & 1);
    __syncthreads();
    if (threadIdx.x == 0 && k >= 2) seq_bar_arm(bar, step_bytes);
    // dh_mm of the 16 rows and warp w's 8 units: dgates [16, 4 Dp] @
    // W[units, :]^T, four partial sums over the depth added in one order
    if (warp < U / 8) {
      float acc[4];
      if constexpr (kBf16)
        seq_product<4>(acc, db, ld, ws, ld, warp * 8, 0, kb, lane);
      else
        seq_product<4>(acc, db, ld, ws, U, warp * 8, 0, kb, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mmv[(gid + 8 * (i >> 1)) * U + warp * 8 + 2 * tig + (i & 1)] =
            round_as<T>(acc[i]);
    }
    __syncthreads();
    if (k > 0) {
#pragma unroll
      for (int s = 0; s < kSeqSlots; ++s)
#pragma unroll
        for (int i = 0; i < 8; ++i) cur[s][i] = nxt[s][i];
    }
  }
  T* mm = static_cast<T*>(a.dh_mm);
#pragma unroll
  for (int s = 0; s < kSeqSlots; ++s) {
    if (!cl.on[s]) continue;
    const long long o = static_cast<long long>(cl.b[s]) * D + cl.j[s];
    mm[o] = from_f32<T>(mmv[cl.r[s] * U + cl.u[s]]);
    a.dh_pass[o] = dpass[s];
    a.dc_carry[o] = dcar[s];
  }
  cluster.sync();  // no CTA leaves while a peer may still address it
}

// the plan's geometry as lstm_seq_plan computes it; false where it is not
// one this file launches
inline bool seq_plan_ok(int B, int T, int D, int C, int U, int dtype) {
  if (!seq_geometry_ok(B, T, D, C, U, dtype)) return false;
  const bool bf16 = dtype == kBFloat16;
  return seq_smem_bytes(D, U, bf16, false) <= kSeqSmemLimit &&
         seq_smem_bytes(D, U, bf16, true) <= kSeqSmemLimit;
}

}  // namespace ptt

// The shared memory bytes of a plan's launch (backward 0 / 1), for the
// wrapper's plan to be checked against.
extern "C" int ptt_lstm_seq_smem(int D, int U, int dtype, int backward) {
  return ptt::seq_smem_bytes(D, U, dtype == ptt::kBFloat16, backward != 0);
}

// The forward over all T positions. Strides in elements; x's last dim, w,
// bias, hidden, cell and gates contiguous; dtype 0 fp32, 1 bf16 for every
// float tensor; len int32 [B] or null; C, U the plan's cluster size and
// units a CTA. Returns the launch's CUDA error (cudaErrorInvalidValue for
// arguments it does not take).
extern "C" int ptt_lstm_seq_fwd(const void* x, long long xsb, long long xst,
                                const void* w, const void* bias,
                                const void* h0, long long h0s, const void* c0,
                                long long c0s, const void* len, void* hidden,
                                void* cell, void* gates, int B, int T, int D,
                                int C, int U, int reverse, int dtype, int ga,
                                int ca, int na, void* stream) {
  if (!ptt::seq_plan_ok(B, T, D, C, U, dtype) || !ptt::rnn_acts_ok(ga, ca, na))
    return static_cast<int>(cudaErrorInvalidValue);
  ptt::SeqArgs a = {};
  a.x = x;
  a.xsb = xsb;
  a.xst = xst;
  a.w = w;
  a.bias = bias;
  a.h0 = h0;
  a.h0s = h0s;
  a.c0 = c0;
  a.c0s = c0s;
  a.len = static_cast<const int*>(len);
  a.hidden = hidden;
  a.cell = cell;
  a.gates = gates;
  a.B = B;
  a.T = T;
  a.D = D;
  a.C = C;
  a.U = U;
  a.reverse = reverse != 0;
  a.ga = ga;
  a.ca = ca;
  a.na = na;
  const bool bf16 = dtype == ptt::kBFloat16;
  const int smem = ptt::seq_smem_bytes(D, U, bf16, false);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? ptt::seq_launch(ptt::lstm_seq_fwd_kernel<__nv_bfloat16>, C, B,
                             smem, s, a)
           : ptt::seq_launch(ptt::lstm_seq_fwd_kernel<float>, C, B, smem, s,
                             a));
}

// The backward over all T positions in reverse order: dx [B, T, 4D] (the
// pre-activations' gradient), dh_mm [B, D] (the first position's dgates @
// W^T, in the dtype), the fp32 carries dh_pass and dc_carry [B, D] after
// it. dh_out and dc_out [B, T, D] contiguous or null; gates and cell the
// forward's; the rest as ptt_lstm_seq_fwd.
extern "C" int ptt_lstm_seq_bwd(const void* dh_out, const void* dc_out,
                                const void* w, const void* gates,
                                const void* cell, const void* c0,
                                long long c0s, const void* len, void* dx,
                                void* dh_mm, void* dh_pass, void* dc_carry,
                                int B, int T, int D, int C, int U,
                                int reverse, int dtype, int ga, int ca,
                                int na, void* stream) {
  if (!ptt::seq_plan_ok(B, T, D, C, U, dtype) || !ptt::rnn_acts_ok(ga, ca, na))
    return static_cast<int>(cudaErrorInvalidValue);
  ptt::SeqArgs a = {};
  a.w = w;
  a.c0 = c0;
  a.c0s = c0s;
  a.len = static_cast<const int*>(len);
  a.cell = const_cast<void*>(cell);
  a.gates = const_cast<void*>(gates);
  a.dh_out = dh_out;
  a.dc_out = dc_out;
  a.dx = dx;
  a.dh_mm = dh_mm;
  a.dh_pass = static_cast<float*>(dh_pass);
  a.dc_carry = static_cast<float*>(dc_carry);
  a.B = B;
  a.T = T;
  a.D = D;
  a.C = C;
  a.U = U;
  a.reverse = reverse != 0;
  a.ga = ga;
  a.ca = ca;
  a.na = na;
  const bool bf16 = dtype == ptt::kBFloat16;
  const int smem = ptt::seq_smem_bytes(D, U, bf16, true);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? ptt::seq_launch(ptt::lstm_seq_bwd_kernel<__nv_bfloat16>, C, B,
                             smem, s, a)
           : ptt::seq_launch(ptt::lstm_seq_bwd_kernel<float>, C, B, smem, s,
                             a));
}

// T steps of the exchange alone (seq_floor_kernel, one exchange a step)
// at a plan's launch geometry (the forward's or the backward's shared
// memory): the floor of T dependent steps.
extern "C" int ptt_lstm_seq_floor(int B, int T, int D, int C, int U,
                                  int dtype, int backward, void* stream) {
  if (!ptt::seq_plan_ok(B, T, D, C, U, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem =
      ptt::seq_smem_bytes(D, U, dtype == ptt::kBFloat16, backward != 0);
  return static_cast<int>(ptt::seq_launch(ptt::seq_floor_kernel<1>, C, B,
                                          smem,
                                          static_cast<cudaStream_t>(stream),
                                          T, U));
}
