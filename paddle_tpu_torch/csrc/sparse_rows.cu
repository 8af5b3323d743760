// The row-sparse embedding update: one table's [n, dim] gradient rows (one
// row an id occurrence of this step's lookups) merged by id and applied to
// the touched rows of the table and its accumulators, in place.
//
// It has no Pallas counterpart: the reference computes this work with XLA
// (paddle_tpu/ops/optimizer_ops.py:39-215, _sparse_rows and
// _merge_duplicate_rows: an argsort, a segment sum and a dropping scatter,
// `.at[ids].add(..., mode='drop')`, in the sparse branches of sgd, momentum,
// adam and adagrad).
//
// Input: the ids in stable-sorted order and the permutation that sorted them
// (torch.sort(stable=True), a library sort outside this kernel), the rows in
// their original order. Each run of equal ids is one table row. Per row:
//   sgd      each occurrence in turn, in stable-sorted order (the order in
//            which XLA's scatter-add applies duplicate updates):
//            p = p + T(-lr * g_k)
//   adagrad  g = the run's sum, taken in sorted order; then the
//   momentum reference's formulas as it writes them: each new value enters
//   adam     as old + T(new - old), the parameter as p + T(-dp)
//            (momentum and adam lazy: only touched rows decay)
// T(x) rounds to the table's type (identity for fp32; for bf16 tables the
// arithmetic is fp32 and each delta and each stored value rounds to bf16).
// Ids outside [0, vocab) are dropped, as mode='drop' drops them (the JAX
// package wraps negative ids; the port's lookup refuses them before they
// get here).
//
// No float atomics: one warp owns a run and sums it in a fixed order, so
// the result's bits do not depend on scheduling (a captured step equals the
// eager one, a resumed run the uninterrupted one). Every operation is an
// explicitly rounded intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn,
// __fsqrt_rn), which the compiler never contracts into an FMA, so the
// kernel rounds as sparse_rows_reference does on the CPU and on the card.
//
// Bound on an H100: bytes. Per call it reads the sorted ids and the order
// (16 B an occurrence) and the n x dim gradient rows, and reads and writes
// the touched rows of the table and of each accumulator; at Wide&Deep's
// width (4,096 occurrences a table, dim 16 or 1) that is ~0.3-0.6 MB, well
// under what one launch costs. Design: one warp a sorted position; the warp
// at a run's start walks the run 32 occurrences at a time: the lanes load
// 32 entries of the order at once, shuffle them, each lane loads its
// column of all 32 rows (independent loads in flight together), then adds
// them in order. A run of many duplicates (a Zipf head id) is one warp's
// serial work; the other warps exit at once.

#include <stdint.h>

#include "common.cuh"

namespace ptt {

constexpr int kSgd = 0;
constexpr int kAdagrad = 1;
constexpr int kMomentum = 2;
constexpr int kAdam = 3;

struct SparseHyper {
  float epsilon;       // adagrad, adam
  float mu;            // momentum
  float beta1, one_minus_beta1, beta2, one_minus_beta2;   // adam
  int nesterov;        // momentum
};

template <typename T, int KIND>
__global__ void __launch_bounds__(256)
    sparse_rows_kernel(T* __restrict__ p, T* __restrict__ s1,
                       T* __restrict__ s2, const long long* __restrict__ sids,
                       const long long* __restrict__ order,
                       const T* __restrict__ rows,
                       const float* __restrict__ lr_ptr,
                       const float* __restrict__ b1p_ptr,
                       const float* __restrict__ b2p_ptr, long long n,
                       long long vocab, int dim, SparseHyper hp) {
  constexpr unsigned kFull = 0xffffffffu;
  const long long w =
      (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= n) return;
  const long long id = sids[w];
  if (w > 0 && sids[w - 1] == id) return;   // not the start of a run
  if (id < 0 || id >= vocab) return;         // dropped
  long long end = w;
  for (;;) {                                 // the run is [w, end)
    const long long j = end + lane;
    const unsigned same = __ballot_sync(kFull, j < n && sids[j] == id);
    if (same == kFull) {
      end += 32;
      continue;
    }
    end += __ffs(~same) - 1;
    break;
  }
  const float lr = *lr_ptr;
  float lr_t = lr;
  if (KIND == kAdam)
    lr_t = __fdiv_rn(__fmul_rn(lr, __fsqrt_rn(__fsub_rn(1.f, *b2p_ptr))),
                     __fsub_rn(1.f, *b1p_ptr));
  const size_t base = (size_t)id * dim;
  for (int c0 = 0; c0 < dim; c0 += 32) {
    const int c = c0 + lane;
    const bool act = c < dim;
    // sgd: the row's running value; the others: the run's sum
    float acc = (KIND == kSgd && act) ? to_f32(p[base + c]) : 0.f;
    for (long long j0 = w; j0 < end; j0 += 32) {
      const long long jl = j0 + lane;
      const long long src = jl < end ? order[jl] : 0;
      const long long left = end - j0;
      const int cnt = left < 32 ? (int)left : 32;
      float v[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const long long r = __shfl_sync(kFull, src, k);
        v[k] = (act && k < cnt) ? to_f32(rows[(size_t)r * dim + c]) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        if (k < cnt) {
          if (KIND == kSgd)
            acc = round_as<T>(
                __fadd_rn(acc, round_as<T>(__fmul_rn(-lr, v[k]))));
          else
            acc = __fadd_rn(acc, v[k]);
        }
      }
    }
    if (!act) continue;
    const size_t at = base + c;
    if (KIND == kSgd) {
      p[at] = from_f32<T>(acc);
      continue;
    }
    const float g = acc;
    const float old_p = to_f32(p[at]);
    float dp;
    if (KIND == kAdagrad) {
      const float old_m = to_f32(s1[at]);
      const float new_m = __fadd_rn(old_m, __fmul_rn(g, g));
      s1[at] = from_f32<T>(
          __fadd_rn(old_m, round_as<T>(__fsub_rn(new_m, old_m))));
      dp = __fdiv_rn(__fmul_rn(lr, g),
                     __fadd_rn(__fsqrt_rn(new_m), hp.epsilon));
    } else if (KIND == kMomentum) {
      const float old_v = to_f32(s1[at]);
      const float new_v = __fadd_rn(__fmul_rn(hp.mu, old_v), g);
      s1[at] = from_f32<T>(
          __fadd_rn(old_v, round_as<T>(__fsub_rn(new_v, old_v))));
      dp = hp.nesterov
               ? __fmul_rn(__fadd_rn(g, __fmul_rn(hp.mu, new_v)), lr)
               : __fmul_rn(lr, new_v);
    } else {
      const float old_m = to_f32(s1[at]);
      const float old_v = to_f32(s2[at]);
      const float new_m = __fadd_rn(__fmul_rn(hp.beta1, old_m),
                                    __fmul_rn(hp.one_minus_beta1, g));
      const float new_v =
          __fadd_rn(__fmul_rn(hp.beta2, old_v),
                    __fmul_rn(hp.one_minus_beta2, __fmul_rn(g, g)));
      s1[at] = from_f32<T>(
          __fadd_rn(old_m, round_as<T>(__fsub_rn(new_m, old_m))));
      s2[at] = from_f32<T>(
          __fadd_rn(old_v, round_as<T>(__fsub_rn(new_v, old_v))));
      dp = __fdiv_rn(__fmul_rn(lr_t, new_m),
                     __fadd_rn(__fsqrt_rn(new_v), hp.epsilon));
    }
    p[at] = from_f32<T>(__fadd_rn(old_p, -round_as<T>(dp)));
  }
}

template <typename T, int KIND>
cudaError_t launch_sparse_rows(void* p, void* s1, void* s2,
                               const long long* sids, const long long* order,
                               const void* rows, const float* lr,
                               const float* b1p, const float* b2p,
                               long long n, long long vocab, int dim,
                               const SparseHyper& hp, cudaStream_t stream) {
  const long long blocks = (n + 7) / 8;     // 8 warps a block
  sparse_rows_kernel<T, KIND><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<T*>(p), static_cast<T*>(s1), static_cast<T*>(s2), sids,
      order, static_cast<const T*>(rows), lr, b1p, b2p, n, vocab, dim, hp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t sparse_rows_kind(int kind, void* p, void* s1, void* s2,
                             const long long* sids, const long long* order,
                             const void* rows, const float* lr,
                             const float* b1p, const float* b2p, long long n,
                             long long vocab, int dim, const SparseHyper& hp,
                             cudaStream_t st) {
  switch (kind) {
    case kSgd:
      return launch_sparse_rows<T, kSgd>(p, s1, s2, sids, order, rows, lr,
                                         b1p, b2p, n, vocab, dim, hp, st);
    case kAdagrad:
      return launch_sparse_rows<T, kAdagrad>(p, s1, s2, sids, order, rows,
                                             lr, b1p, b2p, n, vocab, dim, hp,
                                             st);
    case kMomentum:
      return launch_sparse_rows<T, kMomentum>(p, s1, s2, sids, order, rows,
                                              lr, b1p, b2p, n, vocab, dim,
                                              hp, st);
    case kAdam:
      return launch_sparse_rows<T, kAdam>(p, s1, s2, sids, order, rows, lr,
                                          b1p, b2p, n, vocab, dim, hp, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace ptt

// kind: 0 sgd, 1 adagrad, 2 momentum, 3 adam. dtype: 0 fp32, 1 bf16, for the
// table param [vocab, dim], its accumulators s1 (adagrad's moment,
// momentum's velocity, adam's moment1) and s2 (adam's moment2), each
// contiguous [vocab, dim] or null where the kind has none, and the rows
// [n, dim]. sorted_ids, order: [n] int64. lr, beta1_pow, beta2_pow: one
// fp32 each on the device (the pows only for adam). Returns the launch's
// CUDA error. The scalars come as the fp32 values torch's and JAX's fp32
// arithmetic gives a Python float (one_minus_beta* is 1 - beta taken in
// double on the host, then rounded).
extern "C" int ptt_sparse_rows(int kind, int dtype, void* param, void* s1,
                               void* s2, const void* sorted_ids,
                               const void* order, const void* rows,
                               const void* lr, const void* beta1_pow,
                               const void* beta2_pow, long long n,
                               long long vocab, int dim, float epsilon,
                               float mu, int nesterov, float beta1,
                               float one_minus_beta1, float beta2,
                               float one_minus_beta2, void* stream) {
  if (n < 1 || (n + 7) / 8 > 2147483647LL || vocab < 1 || dim < 1 ||
      lr == nullptr || ((kind == 1 || kind == 2 || kind == 3) && !s1) ||
      (kind == 3 && (!s2 || !beta1_pow || !beta2_pow)))
    return static_cast<int>(cudaErrorInvalidValue);
  ptt::SparseHyper hp;
  hp.epsilon = epsilon;
  hp.mu = mu;
  hp.nesterov = nesterov;
  hp.beta1 = beta1;
  hp.one_minus_beta1 = one_minus_beta1;
  hp.beta2 = beta2;
  hp.one_minus_beta2 = one_minus_beta2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* ids = static_cast<const long long*>(sorted_ids);
  const long long* ord = static_cast<const long long*>(order);
  const float* lrp = static_cast<const float*>(lr);
  const float* b1p = static_cast<const float*>(beta1_pow);
  const float* b2p = static_cast<const float*>(beta2_pow);
  if (dtype == ptt::kFloat32)
    return static_cast<int>(ptt::sparse_rows_kind<float>(
        kind, param, s1, s2, ids, ord, rows, lrp, b1p, b2p, n, vocab, dim,
        hp, st));
  if (dtype == ptt::kBFloat16)
    return static_cast<int>(ptt::sparse_rows_kind<__nv_bfloat16>(
        kind, param, s1, s2, ids, ord, rows, lrp, b1p, b2p, n, vocab, dim,
        hp, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
