// The row-sparse embedding update, for a group of tables in one launch: each
// table's [n, dim] gradient rows (one row an id occurrence of this step's
// lookups) merged by id and applied to the touched rows of the table and of
// its accumulators, in place.
//
// It has no Pallas counterpart: the reference computes this work with XLA
// (paddle_tpu/ops/optimizer_ops.py:39-215, _sparse_rows and
// _merge_duplicate_rows: an argsort, a segment sum and a dropping scatter,
// `.at[ids].add(..., mode='drop')`, in the sparse branches of sgd, momentum,
// adam and adagrad).
//
// Per table, in stable-sorted id order (torch.sort(stable=True)'s order),
// each run of equal ids is one table row:
//   sgd      each occurrence in turn, in sorted order (the order in which
//            XLA's scatter-add applies duplicate updates):
//            p = p + T(-lr * g_k)
//   adagrad  g = the run's sum, taken in sorted order; then the
//   momentum reference's formulas as it writes them: each new value enters
//   adam     as old + T(new - old), the parameter as p + T(-dp)
//            (momentum and adam lazy: only touched rows decay)
// T(x) rounds to the table's type (identity for fp32; for bf16 tables the
// arithmetic is fp32 and each delta and each stored value rounds to bf16).
// Ids outside [0, vocab) are dropped, as mode='drop' drops them.
//
// No float atomics: one thread sums one (run, column) in a fixed order, so
// the result's bits do not depend on scheduling (a captured step equals the
// eager one, a resumed run the uninterrupted one). Every operation is an
// explicitly rounded intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn,
// __fsqrt_rn), which the compiler never contracts into an FMA, so the
// kernel rounds as sparse_rows_reference does on the CPU and on the card.
//
// Bound on an H100: bytes, ~0.3 MB a table at Wide&Deep's width (4,096
// occurrences, dim 16), well under what one launch costs. What costs time
// is latency: a Zipf head id repeats ~400 times, and its run is a chain of
// dependent adds. Design:
// - One launch for the group: the tables' descriptors come by value in the
//   kernel's parameters (a CUDA graph holds them; nothing is read on the
//   host), and each block finds its table by a binary search over them.
// - The sorting variant (n <= 8,192 ids a table): one block a table. It
//   loads the table's unsorted ids and sorts (id, position) pairs in shared
//   memory with CUB's block radix sort over the bit length of vocab (LSD
//   and stable: exactly torch.sort(stable=True)'s order); an id outside the
//   table becomes the key vocab, which sorts last and is dropped.
// - The presorted variant (ids sorted and their order given, by torch.sort:
//   tables above 8,192 ids, and the one-table entry point): blocks of
//   4,096 sorted positions; a block owns the runs that start in its chunk.
// - Then a block walks its positions in tiles. Per tile: the run starts
//   are found in parallel (a block scan of start flags gives each segment,
//   a run's part inside the tile); all threads gather the tile's gradient
//   rows into shared memory, many loads in flight at once (and, for sgd,
//   each run's starting row); then one thread a (segment, column) adds its
//   values from shared memory in sorted order, so the head run's chain
//   costs shared-memory adds only, and a run that continues into the next
//   tile hands its running value on through shared memory; finally the
//   runs that end in the tile are applied, their old rows loaded in
//   batches.

#include <stdint.h>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

#include "common.cuh"

namespace ptt {

constexpr int kSgd = 0;
constexpr int kAdagrad = 1;
constexpr int kMomentum = 2;
constexpr int kAdam = 3;

constexpr int kRowsThreads = 512;
constexpr int kMaxTables = 128;       // descriptors in one launch
constexpr int kTileMax = 4096;        // sorted positions in one tile
constexpr int kStageMax = 16384;      // staged gradient values in one tile
constexpr int kChunk = 4096;          // presorted: positions a block owns
constexpr int kSortedMaxIds = kRowsThreads * 16;   // 8,192
constexpr int kSegPerThread = kTileMax / kRowsThreads;
constexpr int kBatch = 8;             // independent loads a thread issues
// shared memory a block may use on an H100, less a reserve for the static
// arrays (the block scan's storage: ptxas counts 2,208 bytes)
constexpr int kSmemLimit = 232448 - 4096;

struct SparseHyper {
  float epsilon;       // adagrad, adam
  float mu;            // momentum
  float beta1, one_minus_beta1, beta2, one_minus_beta2;   // adam
  int nesterov;        // momentum
};

// One table, as the kernel takes it (88 bytes).
struct SparseTable {
  void* p;
  void* s1;                  // adagrad's moment, momentum's velocity,
  void* s2;                  // adam's moment1; adam's moment2
  const long long* ids;      // [n]: the lookup's ids (sorted: presorted)
  const long long* order;    // [n]: presorted only, the sorting permutation
  const void* rows;          // [n, dim] in the lookup's order
  const float* b1p;          // adam only
  const float* b2p;
  int n, vocab, dim, first_block;
  int vec;                   // columns a thread moves at once: 4 or 1
};

struct SparseGroup {
  SparseTable t[kMaxTables];
  int count;
};

// One table as the C interface takes it from the host: 11 8-byte fields.
struct SparseTableArg {
  void* p;
  void* s1;
  void* s2;
  const void* ids;
  const void* order;
  const void* rows;
  const void* b1p;
  const void* b2p;
  long long n, vocab, dim;
};

__device__ __forceinline__ unsigned key_of(long long id, int vocab) {
  return (id >= 0 && id < vocab) ? (unsigned)id : (unsigned)vocab;
}

template <int V>
struct VecTag {
  static constexpr int value = V;
};

// V consecutive values (16 bytes of fp32, 8 of bf16 at V = 4) as fp32
__device__ __forceinline__ void load_cols(const float* p, float (&o)[1]) {
  o[0] = *p;
}
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p,
                                          float (&o)[1]) {
  o[0] = __bfloat162float(*p);
}
__device__ __forceinline__ void load_cols(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p,
                                          float (&o)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  o[0] = __low2float(a);
  o[1] = __high2float(a);
  o[2] = __low2float(b);
  o[3] = __high2float(b);
}
__device__ __forceinline__ void store_cols(float* p, const float (&v)[1]) {
  *p = v[0];
}
__device__ __forceinline__ void store_cols(__nv_bfloat16* p,
                                           const float (&v)[1]) {
  *p = __float2bfloat16(v[0]);
}
__device__ __forceinline__ void store_cols(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_cols(__nv_bfloat16* p,
                                           const float (&v)[4]) {
  uint2 w;
  *reinterpret_cast<__nv_bfloat162*>(&w.x) =
      __halves2bfloat162(__float2bfloat16(v[0]), __float2bfloat16(v[1]));
  *reinterpret_cast<__nv_bfloat162*>(&w.y) =
      __halves2bfloat162(__float2bfloat16(v[2]), __float2bfloat16(v[3]));
  *reinterpret_cast<uint2*>(p) = w;
}

// The block's table: the last descriptor whose first block is at or
// before this block.
__device__ __forceinline__ int table_of(const SparseGroup& g) {
  int lo = 0, hi = g.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (g.t[mid].first_block <= (int)blockIdx.x)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// Presorted: the first run start at or after x (n if none), block-wide.
__device__ int first_start(const long long* ids, int n, int vocab, int x,
                           int* found) {
  if (x <= 0) return 0;
  for (int base = x; base < n; base += kRowsThreads) {
    if (threadIdx.x == 0) *found = n;
    __syncthreads();
    const int j = base + threadIdx.x;
    if (j < n && key_of(ids[j], vocab) != key_of(ids[j - 1], vocab))
      atomicMin(found, j);
    __syncthreads();
    const int f = *found;
    __syncthreads();
    if (f < n) return f;
  }
  return n;
}

// Shared-memory layout of one block (bytes): the keys and positions (the
// sorted table, or a presorted tile with one key of halo each side), the
// staged gradient values and the segments' values (which the sort's storage
// overlays), the segments, and the running values carried between tiles.
template <int IPT, bool PRESORTED>
struct SmemPlan {
  static constexpr int kKeys =
      PRESORTED ? kTileMax + 4 : kRowsThreads * IPT;
  static constexpr int kPos = PRESORTED ? kTileMax : kRowsThreads * IPT;
  // seg_start holds kTileMax + 1 entries, padded to keep carry 16-byte
  // aligned
  static constexpr size_t kFixed =
      (size_t)(kKeys + kPos) * 4 + (size_t)(2 * kTileMax + 4) * 4 +
      kTileMax;
  __host__ __device__ static size_t sort_bytes() {
    if constexpr (PRESORTED)
      return 0;
    else
      return sizeof(typename cub::BlockRadixSort<unsigned, kRowsThreads,
                                                 IPT, int>::TempStorage);
  }
  // the staged values a tile may hold at this group's widest dim
  __host__ __device__ static int stage(int max_dim) {
    long long room = (long long)kSmemLimit - (long long)kFixed -
                     8LL * max_dim - 16;
    long long s = room / 8;
    if (s > kStageMax) s = kStageMax;
    return (int)(s & ~3LL);
  }
  __host__ __device__ static size_t union_bytes(int stage) {
    size_t u = 8 * (size_t)stage;
    const size_t s = sort_bytes();
    if (s > u) u = s;
    return (u + 15) / 16 * 16;
  }
  __host__ __device__ static size_t bytes(int stage, int max_dim) {
    return kFixed + union_bytes(stage) + 8 * (size_t)max_dim;
  }
};

template <typename T, int IPT, bool PRESORTED>
__global__ void __launch_bounds__(kRowsThreads)
    sparse_rows_group_kernel(const __grid_constant__ SparseGroup g, int kind,
                             const float* __restrict__ lr_ptr,
                             SparseHyper hp, int stage_floats) {
  using Plan = SmemPlan<IPT, PRESORTED>;
  using Scan = cub::BlockScan<int, kRowsThreads>;
  __shared__ typename Scan::TempStorage scan_storage;
  __shared__ int found;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* skey = reinterpret_cast<unsigned*>(smem);
  int* spos = reinterpret_cast<int*>(skey + Plan::kKeys);
  unsigned char* ubase = reinterpret_cast<unsigned char*>(spos + Plan::kPos);
  float* stage = reinterpret_cast<float*>(ubase);
  float* sv = stage + stage_floats;
  int* seg_start =
      reinterpret_cast<int*>(ubase + Plan::union_bytes(stage_floats));
  int* seg_id = seg_start + kTileMax + 4;
  unsigned char* seg_flag = reinterpret_cast<unsigned char*>(seg_id + kTileMax);
  float* carry = reinterpret_cast<float*>(seg_flag + kTileMax);

  const int ti = table_of(g);
  const SparseTable& t = g.t[ti];
  const int n = t.n, vocab = t.vocab, D = t.dim;
  const int tid = threadIdx.x;

  int lo = 0, hi = n;
  if constexpr (PRESORTED) {
    const int b = (int)blockIdx.x - t.first_block;
    const long long c0 = (long long)b * kChunk;
    const int end = (int)min((long long)n, c0 + kChunk);
    lo = first_start(t.ids, n, vocab, (int)c0, &found);
    if (lo >= end) return;   // every position of the chunk continues a run
    hi = first_start(t.ids, n, vocab, end, &found);
  } else {
    using Sort = cub::BlockRadixSort<unsigned, kRowsThreads, IPT, int>;
    unsigned keys[IPT];
    int vals[IPT];
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      const int j = tid * IPT + k;
      keys[k] = j < n ? key_of(t.ids[j], vocab) : (unsigned)vocab;
      vals[k] = j;
    }
    const int bits = 32 - __clz(vocab);   // vocab itself fits
    Sort(*reinterpret_cast<typename Sort::TempStorage*>(ubase))
        .Sort(keys, vals, 0, bits);
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      skey[tid * IPT + k] = keys[k];
      spos[tid * IPT + k] = vals[k];
    }
    __syncthreads();
  }

  const float lr = *lr_ptr;
  float lr_t = lr;
  if (kind == kAdam)
    lr_t = __fdiv_rn(__fmul_rn(lr, __fsqrt_rn(__fsub_rn(1.f, *t.b2p))),
                     __fsub_rn(1.f, *t.b1p));
  T* P = static_cast<T*>(t.p);
  T* S1 = static_cast<T*>(t.s1);
  T* S2 = static_cast<T*>(t.s2);
  const T* rows = static_cast<const T*>(t.rows);
  int tile = stage_floats / D;
  if (tile > kTileMax) tile = kTileMax;

  // The tile loop, with each thread moving V columns at once (V = 4 where
  // dim is a multiple of 4 and the tensors are aligned to it).
  auto run = [&](auto vec_tag) {
    constexpr int V = decltype(vec_tag)::value;
    // the runs a thread applies at once (their old rows in flight)
    constexpr int kApply = 8 / V;
    // a thread's place in the per-element phases: column unit c0 (V
    // columns; and c0 + cl, ... where dim exceeds the block) of rows r0,
    // r0 + rs, ...: cl is a power of two >= dim / V, capped at the block,
    // so no division is needed
    const int du = D / V;
    int cl = 1;
    while (cl < du && cl < kRowsThreads) cl <<= 1;
    const int c0 = tid & (cl - 1);
    const int r0 = tid >> (31 - __clz(cl));
    const int rs = kRowsThreads / cl;

    int parity = 0;
    for (int t0 = lo; t0 < hi; t0 += tile, parity ^= 1) {
      const int t1 = min(t0 + tile, hi);
      const int len = t1 - t0;
      // the tile's keys: key(j) = K[j - kb]; positions: pos(j) = Q[j - qb]
      const unsigned* K = skey;
      const int* Q = spos;
      int kb = 0, qb = 0;
      if constexpr (PRESORTED) {
        for (int i0 = tid; i0 < len + 2; i0 += kRowsThreads * kBatch) {
          unsigned v[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int i = i0 + u * kRowsThreads;
            const int j = t0 - 1 + i;
            v[u] = (i < len + 2 && j >= 0 && j < n)
                       ? key_of(t.ids[j], vocab)
                       : 0xffffffffu;
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int i = i0 + u * kRowsThreads;
            if (i < len + 2) skey[i] = v[u];
          }
        }
        for (int i0 = tid; i0 < len; i0 += kRowsThreads * kBatch) {
          int v[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int i = i0 + u * kRowsThreads;
            v[u] = i < len ? (int)t.order[t0 + i] : 0;
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int i = i0 + u * kRowsThreads;
            if (i < len) spos[i] = v[u];
          }
        }
        __syncthreads();
        kb = t0 - 1;
        qb = t0;
      }

      // segments: a new one at the tile's start and at every run start
      int cnt = 0;
      unsigned flags = 0;
#pragma unroll
      for (int k = 0; k < kSegPerThread; ++k) {
        const int i = tid * kSegPerThread + k;
        if (i < len) {
          const int j = t0 + i;
          if (i == 0 || K[j - kb] != K[j - 1 - kb]) {
            flags |= 1u << k;
            ++cnt;
          }
        }
      }
      int off, nseg;
      Scan(scan_storage).ExclusiveSum(cnt, off, nseg);
#pragma unroll
      for (int k = 0; k < kSegPerThread; ++k)
        if (flags >> k & 1u) seg_start[off++] = tid * kSegPerThread + k;
      if (tid == 0) seg_start[nseg] = len;
      __syncthreads();
      for (int s = tid; s < nseg; s += kRowsThreads) {
        const int j0 = t0 + seg_start[s];
        const int i1 = seg_start[s + 1];
        const unsigned key = K[j0 - kb];
        const bool first = j0 == lo || key != K[j0 - 1 - kb];
        const bool last =
            i1 < len || t1 == hi || K[t1 - kb] != K[t1 - 1 - kb];
        seg_id[s] = key < (unsigned)vocab ? (int)key : -1;
        seg_flag[s] = (first ? 1 : 0) | (last ? 2 : 0);
      }
      __syncthreads();

      // gather: the tile's gradient rows in sorted order, and for sgd the
      // starting row of each run that starts here
      for (int i0 = r0; i0 < len; i0 += rs * kBatch) {
        for (int cu = c0; cu < du; cu += cl) {
          const int c = cu * V;
          float v[kBatch][V];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int i = i0 + u * rs;
#pragma unroll
            for (int w = 0; w < V; ++w) v[u][w] = 0.f;
            if (i < len && K[t0 + i - kb] < (unsigned)vocab)
              load_cols(rows + (size_t)Q[t0 + i - qb] * D + c, v[u]);
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int i = i0 + u * rs;
            if (i < len) store_cols(stage + i * D + c, v[u]);
          }
        }
      }
      if (kind == kSgd) {
        for (int s0 = r0; s0 < nseg; s0 += rs * kBatch) {
          for (int cu = c0; cu < du; cu += cl) {
            const int c = cu * V;
            float v[kBatch][V];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              const int s = s0 + u * rs;
#pragma unroll
              for (int w = 0; w < V; ++w) v[u][w] = 0.f;
              if (s < nseg && seg_id[s] >= 0 && (seg_flag[s] & 1))
                load_cols(P + (size_t)seg_id[s] * D + c, v[u]);
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              const int s = s0 + u * rs;
              if (s < nseg) store_cols(sv + s * D + c, v[u]);
            }
          }
        }
      }
      __syncthreads();

      // the chains: one thread a (segment, column unit), each column in
      // sorted order
      for (int s = r0; s < nseg; s += rs) {
        if (seg_id[s] < 0) continue;
        const int f = seg_flag[s];
        const int i0 = seg_start[s], i1 = seg_start[s + 1];
        for (int cu = c0; cu < du; cu += cl) {
          const int c = cu * V;
          float acc[V];
          if (!(f & 1)) {
            load_cols(carry + parity * D + c, acc);
          } else if (kind == kSgd) {
            load_cols(sv + s * D + c, acc);
          } else {
#pragma unroll
            for (int w = 0; w < V; ++w) acc[w] = 0.f;
          }
          if (kind == kSgd) {
#pragma unroll 4
            for (int i = i0; i < i1; ++i) {
              float x[V];
              load_cols(stage + i * D + c, x);
#pragma unroll
              for (int w = 0; w < V; ++w)
                acc[w] = round_as<T>(__fadd_rn(
                    acc[w], round_as<T>(__fmul_rn(-lr, x[w]))));
            }
          } else {
#pragma unroll 4
            for (int i = i0; i < i1; ++i) {
              float x[V];
              load_cols(stage + i * D + c, x);
#pragma unroll
              for (int w = 0; w < V; ++w) acc[w] = __fadd_rn(acc[w], x[w]);
            }
          }
          if (f & 2)
            store_cols(sv + s * D + c, acc);
          else
            store_cols(carry + (parity ^ 1) * D + c, acc);
        }
      }
      __syncthreads();

      // the runs that end in this tile: their rows updated
      for (int s0 = r0; s0 < nseg; s0 += rs * kApply) {
        for (int cu = c0; cu < du; cu += cl) {
          const int c = cu * V;
          float gv[kApply][V], op[kApply][V], o1[kApply][V], o2[kApply][V];
          size_t at[kApply];
          bool act[kApply];
#pragma unroll
          for (int u = 0; u < kApply; ++u) {
            const int s = s0 + u * rs;
            act[u] = s < nseg && seg_id[s] >= 0 && (seg_flag[s] & 2);
            at[u] = act[u] ? (size_t)seg_id[s] * D + c : 0;
#pragma unroll
            for (int w = 0; w < V; ++w)
              gv[u][w] = op[u][w] = o1[u][w] = o2[u][w] = 0.f;
            if (act[u]) {
              load_cols(sv + s * D + c, gv[u]);
              if (kind != kSgd) {
                load_cols(P + at[u], op[u]);
                load_cols(S1 + at[u], o1[u]);
                if (kind == kAdam) load_cols(S2 + at[u], o2[u]);
              }
            }
          }
#pragma unroll
          for (int u = 0; u < kApply; ++u) {
            if (!act[u]) continue;
            if (kind == kSgd) {
              store_cols(P + at[u], gv[u]);
              continue;
            }
            float np[V], n1[V], n2[V];
#pragma unroll
            for (int w = 0; w < V; ++w) {
              const float gr = gv[u][w];
              float dp;
              if (kind == kAdagrad) {
                const float old_m = o1[u][w];
                const float new_m = __fadd_rn(old_m, __fmul_rn(gr, gr));
                n1[w] = __fadd_rn(old_m, round_as<T>(__fsub_rn(new_m, old_m)));
                dp = __fdiv_rn(__fmul_rn(lr, gr),
                               __fadd_rn(__fsqrt_rn(new_m), hp.epsilon));
              } else if (kind == kMomentum) {
                const float old_v = o1[u][w];
                const float new_v = __fadd_rn(__fmul_rn(hp.mu, old_v), gr);
                n1[w] = __fadd_rn(old_v, round_as<T>(__fsub_rn(new_v, old_v)));
                dp = hp.nesterov
                         ? __fmul_rn(__fadd_rn(gr, __fmul_rn(hp.mu, new_v)),
                                     lr)
                         : __fmul_rn(lr, new_v);
              } else {
                const float old_m = o1[u][w];
                const float old_v = o2[u][w];
                const float new_m =
                    __fadd_rn(__fmul_rn(hp.beta1, old_m),
                              __fmul_rn(hp.one_minus_beta1, gr));
                const float new_v = __fadd_rn(
                    __fmul_rn(hp.beta2, old_v),
                    __fmul_rn(hp.one_minus_beta2, __fmul_rn(gr, gr)));
                n1[w] = __fadd_rn(old_m, round_as<T>(__fsub_rn(new_m, old_m)));
                n2[w] = __fadd_rn(old_v, round_as<T>(__fsub_rn(new_v, old_v)));
                dp = __fdiv_rn(__fmul_rn(lr_t, new_m),
                               __fadd_rn(__fsqrt_rn(new_v), hp.epsilon));
              }
              np[w] = __fadd_rn(op[u][w], -round_as<T>(dp));
            }
            store_cols(S1 + at[u], n1);
            if (kind == kAdam) store_cols(S2 + at[u], n2);
            store_cols(P + at[u], np);
          }
        }
      }
      __syncthreads();   // the next tile reuses every tile array
    }
  };
  if (t.vec == 4)
    run(VecTag<4>());
  else
    run(VecTag<1>());
}

template <typename T, int IPT, bool PRESORTED>
cudaError_t launch_group(const SparseGroup& g, int blocks, int max_dim,
                         int kind, const float* lr, const SparseHyper& hp,
                         cudaStream_t stream) {
  using Plan = SmemPlan<IPT, PRESORTED>;
  const int stage = Plan::stage(max_dim);
  if (stage < max_dim) return cudaErrorInvalidValue;
  const size_t smem = Plan::bytes(stage, max_dim);
  auto kernel = sparse_rows_group_kernel<T, IPT, PRESORTED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kRowsThreads, smem, stream>>>(g, kind, lr, hp, stage);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const SparseGroup& g, int blocks, int max_n,
                         int max_dim, int presorted, int kind,
                         const float* lr, const SparseHyper& hp,
                         cudaStream_t st) {
  if (presorted)
    return launch_group<T, 1, true>(g, blocks, max_dim, kind, lr, hp, st);
  if (max_n <= kRowsThreads * 2)
    return launch_group<T, 2, false>(g, blocks, max_dim, kind, lr, hp, st);
  if (max_n <= kRowsThreads * 8)
    return launch_group<T, 8, false>(g, blocks, max_dim, kind, lr, hp, st);
  return launch_group<T, 16, false>(g, blocks, max_dim, kind, lr, hp, st);
}

}  // namespace ptt

// The most tables one call takes, and the most ids a table may have for
// the sorting variant (presorted = 0).
extern "C" int ptt_sparse_rows_limits(int which) {
  return which == 0 ? ptt::kMaxTables : ptt::kSortedMaxIds;
}

// One launch for ``count`` tables of one kind and dtype. kind: 0 sgd, 1
// adagrad, 2 momentum, 3 adam. dtype: 0 fp32, 1 bf16, for each table's
// param [vocab, dim], its accumulators s1 (adagrad's moment, momentum's
// velocity, adam's moment1) and s2 (adam's moment2), each contiguous
// [vocab, dim] or null where the kind has none, and its rows [n, dim].
// presorted = 0: ids are the lookup's [n] int64 ids (n <= 8,192), order
// null; presorted = 1: ids sorted stably and order the permutation that
// sorted them, [n] int64 each. lr: one fp32 on the device, shared by the
// tables; b1p, b2p: adam's two pows, one fp32 each. Returns the launch's
// CUDA error. The scalars come as the fp32 values torch's and JAX's fp32
// arithmetic gives a Python float (one_minus_beta* is 1 - beta taken in
// double on the host, then rounded).
extern "C" int ptt_sparse_rows_group(
    int kind, int dtype, int presorted, const void* tables, int count,
    const void* lr, float epsilon, float mu, int nesterov, float beta1,
    float one_minus_beta1, float beta2, float one_minus_beta2,
    void* stream) {
  if (count < 1 || count > ptt::kMaxTables || lr == nullptr || kind < 0 ||
      kind > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const ptt::SparseTableArg* in =
      static_cast<const ptt::SparseTableArg*>(tables);
  ptt::SparseGroup g;
  int blocks = 0, max_n = 0, max_dim = 0;
  for (int i = 0; i < count; ++i) {
    const ptt::SparseTableArg& a = in[i];
    if (a.n < 1 || a.n > 2147483647LL || a.vocab < 1 ||
        a.vocab >= 2147483647LL || a.dim < 1 || a.dim > 65536 || !a.p ||
        !a.ids || !a.rows || (presorted && !a.order) ||
        (!presorted && a.n > ptt::kSortedMaxIds) ||
        ((kind == 1 || kind == 2 || kind == 3) && !a.s1) ||
        (kind == 3 && (!a.s2 || !a.b1p || !a.b2p)))
      return static_cast<int>(cudaErrorInvalidValue);
    ptt::SparseTable& t = g.t[i];
    t.p = a.p;
    t.s1 = a.s1;
    t.s2 = a.s2;
    t.ids = static_cast<const long long*>(a.ids);
    t.order = static_cast<const long long*>(a.order);
    t.rows = a.rows;
    t.b1p = static_cast<const float*>(a.b1p);
    t.b2p = static_cast<const float*>(a.b2p);
    t.n = (int)a.n;
    t.vocab = (int)a.vocab;
    t.dim = (int)a.dim;
    t.first_block = blocks;
    // four columns a thread where every row starts 16 (fp32) or 8 (bf16)
    // bytes aligned
    const uintptr_t align = dtype == ptt::kFloat32 ? 16 : 8;
    const uintptr_t bits = reinterpret_cast<uintptr_t>(a.p) |
                           reinterpret_cast<uintptr_t>(a.s1) |
                           reinterpret_cast<uintptr_t>(a.s2) |
                           reinterpret_cast<uintptr_t>(a.rows);
    t.vec = (a.dim % 4 == 0 && bits % align == 0) ? 4 : 1;
    blocks += presorted ? (int)((a.n + ptt::kChunk - 1) / ptt::kChunk) : 1;
    if (t.n > max_n) max_n = t.n;
    if (t.dim > max_dim) max_dim = t.dim;
  }
  g.count = count;
  ptt::SparseHyper hp;
  hp.epsilon = epsilon;
  hp.mu = mu;
  hp.nesterov = nesterov;
  hp.beta1 = beta1;
  hp.one_minus_beta1 = one_minus_beta1;
  hp.beta2 = beta2;
  hp.one_minus_beta2 = one_minus_beta2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lrp = static_cast<const float*>(lr);
  if (dtype == ptt::kFloat32)
    return static_cast<int>(ptt::launch_typed<float>(
        g, blocks, max_n, max_dim, presorted, kind, lrp, hp, st));
  if (dtype == ptt::kBFloat16)
    return static_cast<int>(ptt::launch_typed<__nv_bfloat16>(
        g, blocks, max_n, max_dim, presorted, kind, lrp, hp, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
