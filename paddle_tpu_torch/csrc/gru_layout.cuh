// The GRU recurrent weight W [D, 3D] as the sequence kernels keep it in
// shared memory: gru_seq.cu (a thread-block cluster holds W) and
// gru_wide.cu (the whole card holds it) lay out a CTA's slice alike.
#pragma once

#include "seq_cluster.cuh"

namespace ptt {

// A gate block's depth: D rounded up to 16 (an mma's k), so the products
// over the u and r blocks and over the c block start on a k step.
__host__ __device__ inline int gru_dk(int D) { return seq_round_up(D, 16); }

// The slice of units j0 .. j0 + U - 1, in elements:
//   forward bf16: W [3U][dk + 8], row q U + u holding column q D + j0 + u
//     over k (the mma's B operand, n-major); fp32: W [dk][3U], column
//     q U + u;
//   backward bf16: W [U][3 dk + 8], row u holding W[j0 + u, q D + j] at
//     column q dk + j; fp32: W [3 dk][U], the same columns as rows.
__host__ __device__ inline int gru_w_elems(int D, int U, bool bf16,
                                           bool bwd) {
  const int dk = gru_dk(D);
  if (!bwd) return bf16 ? 3 * U * seq_ld(dk, true) : dk * 3 * U;
  return bf16 ? U * seq_ld(3 * dk, true) : 3 * dk * U;
}

// The forward's slice into ws (zeroed beforehand: units past D and depth
// past D stay 0), 16-byte loads where every run of units starts aligned.
template <typename T>
__device__ __forceinline__ void gru_load_w_fwd(T* ws, const T* w, int D,
                                               int U, int j0) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kVec = 16 / sizeof(T);
  const int D3 = 3 * D, ld = seq_ld(gru_dk(D), kBf16);
  const int ldw = kBf16 ? ld : 3 * U;
  auto put_w = [&](int k, int q, int u, T v) {
    ws[kBf16 ? (q * U + u) * ld + k : k * ldw + q * U + u] = v;
  };
  if (D % kVec == 0) {
    const int runs = U / kVec;
#pragma unroll 4
    for (int i = threadIdx.x; i < D * 3 * runs; i += blockDim.x) {
      const int u = (i % runs) * kVec, q = (i / runs) % 3,
                k = i / (3 * runs);
      if (j0 + u >= D) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(
          w + static_cast<long long>(k) * D3 + q * D + j0 + u);
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int t = 0; t < kVec; ++t) put_w(k, q, u + t, e[t]);
    }
  } else {
    for (int i = threadIdx.x; i < D * 3 * U; i += blockDim.x) {
      const int u = i % U, q = (i / U) % 3, k = i / (3 * U);
      if (j0 + u < D)
        put_w(k, q, u, w[static_cast<long long>(k) * D3 + q * D + j0 + u]);
    }
  }
}

// The backward's slice (W's rows of the units, gate block q at column
// q dk) into ws, zeroed beforehand.
template <typename T>
__device__ __forceinline__ void gru_load_w_bwd(T* ws, const T* w, int D,
                                               int U, int j0) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kVec = 16 / sizeof(T);
  const int D3 = 3 * D, dk = gru_dk(D), ld = seq_ld(3 * dk, kBf16);
  auto put_w = [&](int u, int c, T v) {
    const int col = (c / D) * dk + c % D;
    ws[kBf16 ? u * ld + col : col * U + u] = v;
  };
  if (D % kVec == 0) {
    const int runs = D3 / kVec;
#pragma unroll 4
    for (int i = threadIdx.x; i < U * runs; i += blockDim.x) {
      const int u = i / runs, c = (i % runs) * kVec;
      if (j0 + u >= D) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(
          w + static_cast<long long>(j0 + u) * D3 + c);
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int t = 0; t < kVec; ++t) put_w(u, c + t, e[t]);
    }
  } else {
    for (int i = threadIdx.x; i < U * D3; i += blockDim.x) {
      const int u = i / D3, c = i % D3;
      if (j0 + u < D)
        put_w(u, c, w[static_cast<long long>(j0 + u) * D3 + c]);
    }
  }
}

}  // namespace ptt
