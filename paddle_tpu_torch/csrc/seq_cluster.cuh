// What the recurrences that run one launch a sequence share (lstm_seq.cu,
// gru_seq.cu): the geometry of a thread-block cluster that owns 16 batch
// rows, the exchange of values between its CTAs by st.async onto the
// receiver's mbarrier, the one-n-tile product of those 16 rows on the
// tensor cores (bf16) or by FFMA (fp32) that both backward kernels and the
// GRU forward run (the LSTM forward's four-gate tile is its own), the
// cells a thread owns, the launch, and the floor kernel that runs the
// exchanges alone.
#pragma once

#include <cooperative_groups.h>

#include "flash_tiles.cuh"
#include "rnn_math.cuh"

namespace cg = cooperative_groups;

namespace ptt {

constexpr int kSeqRows = 16;            // batch rows a cluster
constexpr int kSeqThreads = 256;        // a CTA
constexpr int kSeqSlots = 4;            // cells a thread: 16 U <= 4 x 256
constexpr int kSeqMaxCluster = 8;       // the portable cluster size
constexpr int kSeqSmemLimit = 232448;   // 227 KB a block

__host__ __device__ inline int seq_round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
// D rounded up to even: a pair of units is one aligned store
__host__ __device__ inline int seq_dp(int D) { return seq_round_up(D, 2); }
// a row of a 16-row buffer: bf16 rows 16 bytes longer than a multiple of
// 32 (ldmatrix without bank conflicts), fp32 rows 4 words longer (float4
// reads of rows gid and gid + 8 on different banks)
__host__ __device__ inline int seq_ld(int k, bool bf16) {
  return k + (bf16 ? 8 : 4);
}

__device__ __forceinline__ void seq_zero(unsigned char* smem, int bytes) {
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x * 16; i < bytes; i += blockDim.x * 16)
    *reinterpret_cast<uint4*>(smem + i) = z;
}

// ------------------------------------- the exchange between a cluster's CTAs
// A buffer's mbarrier completes a phase when this CTA's thread 0 has armed
// it (one arrival, with the bytes the cluster's CTAs will write) and every
// one of those bytes has landed: the writers use st.async, whose
// complete-tx on the destination's mbarrier releases the data at cluster
// scope, so no step fences the global memory traffic.
__device__ __forceinline__ unsigned seq_smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// this CTA's shared address `addr` in the shared memory of CTA `rank`
__device__ __forceinline__ unsigned seq_map(unsigned addr, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void seq_bar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void seq_bar_arm(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void seq_bar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "SEQ_WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra SEQ_WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// units j, j + 1 of one row (v1 = 0 where j + 1 is past D: a padding
// column) into every CTA's buffer at this CTA's shared address `addr`,
// completing that CTA's mbarrier `bar`: 4 bytes in bf16, 8 in fp32
template <typename T>
__device__ __forceinline__ void seq_send(unsigned addr, unsigned bar,
                                        float v0, float v1, int C) {
  for (int r = 0; r < C; ++r) {
    const unsigned a = seq_map(addr, r), b = seq_map(bar, r);
    if constexpr (sizeof(T) == 2) {
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], "
          "%1, [%2];\n" ::"r"(a),
          "r"(pack_bf16(v0, v1)), "r"(b)
          : "memory");
    } else {
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 "
          "[%0], {%1, %2}, [%3];\n" ::"r"(a),
          "r"(__float_as_uint(v0)), "r"(__float_as_uint(v1)), "r"(b)
          : "memory");
    }
  }
}

// ------------------------------------------------- the recurrent products
// Two 8x8 b16 blocks: lanes 0-15 give the row addresses (lane i: row i % 8
// of block i / 8); register k holds block k's (row gid, cols 2 tig, +1).
__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2],
                                            const void* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// The KS partial sums of a C fragment, added in one fixed order
template <int KS>
__device__ __forceinline__ void seq_fold(float (&out)[4],
                                         const float (&acc)[KS][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (KS == 2)
      out[i] = acc[0][i] + acc[1][i];
    else
      out[i] = (acc[0][i] + acc[1][i]) + (acc[2][i] + acc[3][i]);
  }
}

// One warp's n-tile of 8 columns, C [16 x 8] of the cluster's 16 rows
// (the C fragment: rows gid, gid + 8, columns 2 tig, 2 tig + 1): A = rows
// 0..15 of `a` (row stride lda), columns [k0, k0 + depth), times B over
// the same depth, in KS partial sums (2 or 4) added in one fixed order.
// bf16, on the tensor cores: B is n-major, its rows n0 .. n0 + 7 of `b`
// (row stride ldb) holding the depth at columns k0 ..; depth a multiple of
// 16, whose steps of 16 go round the partial sums (step i to sum i % KS).
// fp32, by FFMA: B is k-major, depth k at row k of `b` (row stride ldb),
// the tile's columns from col0, lane tig's two at col0 + 2 tig; depth a
// multiple of 4, depth k going to sum k % KS.
template <int KS>
__device__ __forceinline__ void seq_product(float (&out)[4],
                                            const __nv_bfloat16* a, int lda,
                                            const __nv_bfloat16* b, int ldb,
                                            int n0, int k0, int depth,
                                            int lane) {
  static_assert(KS == 2 || KS == 4, "two or four partial sums");
  float acc[KS][4] = {};
  // one x4 load holds the 8 rows' next 32 columns: two steps; a turn of
  // the loop takes KS steps, one a sum, so every index is a constant, and
  // loads all their fragments before the first product (the loads and
  // products are volatile asm, which the compiler keeps in order)
  const __nv_bfloat16* brow = b + (n0 + (lane & 7)) * ldb + (lane >> 3) * 8;
  const int steps = depth / 16;
  int i = 0;
#pragma unroll 2
  for (; i + KS <= steps; i += KS) {
    unsigned af[KS][4], w[KS / 2][4];
#pragma unroll
    for (int s = 0; s < KS; ++s)
      ldmatrix_x4(af[s], a_rows(a, lda, 0, k0 + 16 * (i + s), lane));
#pragma unroll
    for (int p = 0; p < KS / 2; ++p)
      ldmatrix_x4(w[p], brow + k0 + 16 * (i + 2 * p));
#pragma unroll
    for (int s = 0; s < KS; ++s)
      mma_bf16(acc[s], af[s], w[s / 2][2 * (s % 2)],
               w[s / 2][2 * (s % 2) + 1]);
  }
#pragma unroll
  for (int s = 0; s + 1 < KS; ++s) {
    if (i + s < steps) {
      const int kk = k0 + 16 * (i + s);
      unsigned a0[4], w[2];
      ldmatrix_x4(a0, a_rows(a, lda, 0, kk, lane));
      ldmatrix_x2(w, brow + kk);
      mma_bf16(acc[s], a0, w[0], w[1]);
    }
  }
  seq_fold<KS>(out, acc);
}

template <int KS>
__device__ __forceinline__ void seq_product(float (&out)[4], const float* a,
                                            int lda, const float* b, int ldb,
                                            int col0, int k0, int depth,
                                            int lane) {
  static_assert(KS == 2 || KS == 4, "two or four partial sums");
  const int gid = lane >> 2, tig = lane & 3;
  float acc[KS][4] = {};
  const float* bl = b + col0 + 2 * tig;
#pragma unroll 2
  for (int kk = k0; kk < k0 + depth; kk += 4) {
    const float4 r0 = *reinterpret_cast<const float4*>(a + gid * lda + kk);
    const float4 r1 =
        *reinterpret_cast<const float4*>(a + (gid + 8) * lda + kk);
    const float h0v[4] = {r0.x, r0.y, r0.z, r0.w};
    const float h1v[4] = {r1.x, r1.y, r1.z, r1.w};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float2 w = *reinterpret_cast<const float2*>(bl + (kk + s) * ldb);
      float(&c)[4] = acc[s % KS];
      c[0] = fmaf(h0v[s], w.x, c[0]);
      c[1] = fmaf(h0v[s], w.y, c[1]);
      c[2] = fmaf(h1v[s], w.x, c[2]);
      c[3] = fmaf(h1v[s], w.y, c[3]);
    }
  }
  seq_fold<KS>(out, acc);
}

// ----------------------------------------------------------- the cells
// The thread's cells: slot s is cell i = threadIdx.x + 256 s of the
// cluster's 16 x U, row i / U and unit j0 + i % U. `in`: the slot is one
// of them (the same for a whole warp, as 16 U is a multiple of 128); `on`:
// its row is in the batch and its unit in the hidden width. Args: a
// kernel's arguments with B, T, D, U and len (int32 [B] or null).
struct SeqCells {
  int r[kSeqSlots], u[kSeqSlots], b[kSeqSlots], j[kSeqSlots],
      len[kSeqSlots];
  bool in[kSeqSlots], on[kSeqSlots];

  template <typename Args>
  __device__ __forceinline__ SeqCells(const Args& a, int row0, int j0) {
#pragma unroll
    for (int s = 0; s < kSeqSlots; ++s) {
      const int i = threadIdx.x + kSeqThreads * s;
      in[s] = i < kSeqRows * a.U;
      r[s] = i / a.U;
      u[s] = i % a.U;
      b[s] = row0 + r[s];
      j[s] = j0 + u[s];
      on[s] = in[s] && b[s] < a.B && j[s] < a.D;
      len[s] = (on[s] && a.len != nullptr) ? a.len[b[s]] : a.T;
    }
  }
};

// ------------------------------------------------------ launch and floor
// The floor of T dependent steps: the exchanges alone, at a plan's grid,
// cluster, block and shared memory. A step makes kExchanges exchanges as
// the recurrences do (each of the 8 U senders, at most a CTA's threads,
// sends 4 bytes to every CTA of the cluster, which waits for all of them):
// the first kExchanges - 1 sent and awaited within the step, the last
// sent for the next step (the carried h).
template <int kExchanges>
__global__ void __launch_bounds__(kSeqThreads)
    seq_floor_kernel(int steps, int U) {
  constexpr int E = kExchanges;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = static_cast<int>(cluster.num_blocks());
  const int senders = min(8 * U, kSeqThreads);
  const int n = C * senders;  // 4-byte slots a buffer
  unsigned* slots = reinterpret_cast<unsigned*>(smem + 16 * E);
  const unsigned bar0 = seq_smem_u32(smem);  // exchange e, buffer: 16 e + 8 buf
  const unsigned bytes = 4u * n;
  if (threadIdx.x == 0) {
    for (int e = 0; e < E; ++e) {
      seq_bar_init(bar0 + 16 * e);
      seq_bar_init(bar0 + 16 * e + 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int e = 0; e + 1 < E; ++e) {
      seq_bar_arm(bar0 + 16 * e, bytes);
      if (steps > 1) seq_bar_arm(bar0 + 16 * e + 8, bytes);
    }
    if (steps > 1) seq_bar_arm(bar0 + 16 * (E - 1) + 8, bytes);
    if (steps > 2) seq_bar_arm(bar0 + 16 * (E - 1), bytes);
  }
  cluster.sync();
  const int slot =
      static_cast<int>(cluster.block_rank()) * senders + threadIdx.x;
  const bool sender = static_cast<int>(threadIdx.x) < senders;
  auto send = [&](int e, int buf, unsigned v) {
    const unsigned addr = seq_smem_u32(slots + (2 * e + buf) * n + slot);
    const unsigned bar = bar0 + 16 * e + 8 * buf;
    for (int r = 0; r < C; ++r)
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
          "[%0], %1, [%2];\n" ::"r"(seq_map(addr, r)),
          "r"(v), "r"(seq_map(bar, r))
          : "memory");
  };
  for (int k = 0; k < steps; ++k) {
    const unsigned last = bar0 + 16 * (E - 1) + 8 * (k & 1);
    if (k > 0) {
      seq_bar_wait(last, ((k - 1) >> 1) & 1);
      __syncthreads();
      if (threadIdx.x == 0 && k + 2 < steps) seq_bar_arm(last, bytes);
    }
    for (int e = 0; e + 1 < E; ++e) {
      const unsigned bar = bar0 + 16 * e + 8 * (k & 1);
      if (sender) send(e, k & 1, static_cast<unsigned>(k));
      seq_bar_wait(bar, (k >> 1) & 1);
      __syncthreads();
      if (threadIdx.x == 0 && k + 2 < steps) seq_bar_arm(bar, bytes);
    }
    if (k + 1 < steps && sender)
      send(E - 1, (k + 1) & 1, static_cast<unsigned>(k));
  }
  cluster.sync();
}

template <typename... Args>
inline cudaError_t seq_launch(void (*kernel)(Args...), int C, int B,
                              int smem, cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((B + kSeqRows - 1) / kSeqRows));
  cfg.blockDim = dim3(kSeqThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The plan's geometry as the wrappers' plans compute it (C CTAs of U
// units, U a multiple of 8 with 16 U cells at most 4 a thread, covering D
// with no empty CTA) and a dtype the kernels take; the caller checks the
// shared memory.
inline bool seq_geometry_ok(int B, int T, int D, int C, int U, int dtype) {
  return B >= 1 && T >= 1 && D >= 1 && C >= 1 && C <= kSeqMaxCluster &&
         U >= 8 && U % 8 == 0 && kSeqRows * U <= kSeqSlots * kSeqThreads &&
         C * U >= D && (C - 1) * U < D &&
         (dtype == kFloat32 || dtype == kBFloat16);
}

}  // namespace ptt
