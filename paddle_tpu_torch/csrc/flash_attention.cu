// Flash attention over [B, H, T, D]: the FA2 forward (K2) and its two-kernel
// backward (K3: dK/dV over query tiles, dQ over key tiles).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
// _fwd_kernel (launched by _flash_fwd) and _bwd_dkv_kernel / _bwd_dq_kernel
// (launched by _flash_bwd).
//
// What they compute (the Pallas kernels' function, not their blocking):
// s = (q . k^T) * scale with fp32 accumulation over inputs of the tensors'
// dtype; causal (col <= row, aligned top-left) and per-example kv_len
// (col < kv_len[b]) masks; online softmax with fp32 m and l; p rounded to
// v's dtype before p . v; out in q's dtype and lse = m + log(l) in fp32. The
// backward recomputes p = exp(s - lse), takes delta = rowsum(dO * O) from
// the caller (computed in fp32 outside the kernels, as the reference does),
// forms ds = p * (dp - delta) * scale, rounds p and ds to the input dtype
// before the dV, dK and dQ products, and sums dK/dV over query tiles and dQ
// over key tiles. Two backward kernels keep every output owned by one block:
// no atomics, the result does not depend on the order blocks run in.
//
// Tiles with no live key (past kv_len, above the causal band) are skipped,
// never run masked: a masked score is -1e30, and running such a tile would
// give p = exp(-1e30 - lse) = 1 on a row whose lse is itself -1e30. Inside a
// tile that runs, masked entries get p = 0 explicitly. Any Tq and Tk work:
// rows and columns past the end of a tail tile are zero-filled and masked.
// A row with no live key gives out 0 and lse -1e30, as the Pallas kernel
// does (its denominator 0 becomes 1).
//
// Bound on an H100: at the training shapes (T = 64 or 512, D = 64) the work,
// 4*Tq*Tk*D flops per head forward and 2.5 times that backward, is bound by
// the tensor cores' rate when done in bf16; this first version runs every
// product in fp32 on the CUDA cores (67 TFLOP/s peak), so it sits far above
// that bound. Design: one 256-thread block (a 16 x 16 grid of threads) per
// (b*h, 64-row tile); q, k, v, dO tiles are staged in shared memory as fp32
// (rows padded by one float against bank conflicts); each thread owns a
// 4 x 4 block of the 64 x 64 score tile (rows ty + 16i, columns tx + 16j)
// and 4 x ceil(D/16) output accumulators in registers; row maxima and sums
// are shuffle reductions over the 16 threads that share a row. Tensors are
// addressed through (b, h, t) strides with D contiguous, so the head-split
// views of [B, T, H*D] activations need no copy.
//
// Left for later: mma.sync / wgmma on bf16 tiles, TMA loads into a ring of
// shared-memory stages, keeping p in registers, and splitting long rows.

#include "common.cuh"

namespace ptt {

constexpr int kFlashThreads = 256;  // 16 x 16
constexpr int kTile = 64;           // query rows and key columns per tile
constexpr int kLdP = kTile + 1;     // row stride of the p / ds tiles
constexpr float kMasked = -1e30f;

// [B, H, T, D] addressed through strides (elements); D is contiguous
struct View {
  long long sb, sh, st;
};

struct Dims {
  int b, h, tq, tk, d, causal;
  float scale;
};

__device__ __forceinline__ long long offset(const View& v, int bi, int hi,
                                            int t) {
  return bi * v.sb + hi * v.sh + t * v.st;
}

// rows [t0, t0 + kTile) of one (b, h) slice into dst[kTile][ld] as fp32;
// rows at or past t_end are zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          const View& v, int bi, int hi,
                                          int t0, int t_end, int d) {
  for (int i = threadIdx.x; i < kTile * d; i += kFlashThreads) {
    const int r = i / d;
    const int c = i - r * d;
    const int t = t0 + r;
    dst[r * ld + c] = t < t_end ? to_f32(src[offset(v, bi, hi, t) + c]) : 0.f;
  }
}

// reductions over the 16 threads (tx = 0..15) that share a row
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int key_limit(const Dims& s, const int* kv_len,
                                         int bi) {
  int lim = s.tk;
  if (kv_len != nullptr) lim = min(lim, max(kv_len[bi], 0));
  return lim;
}

__device__ __forceinline__ bool live(const Dims& s, int row, int col,
                                     int k_lim) {
  return row < s.tq && col < k_lim && (!s.causal || col <= row);
}

// ------------------------------------------------------------- forward
// smem: Q [64][d+1], K [64][d+1], V [64][d], P [64][65]
template <typename T, int NJ>
__global__ void __launch_bounds__(kFlashThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, const int* __restrict__ kv_len,
                     View vq, View vk, View vv, View vo, Dims s) {
  extern __shared__ float smem[];
  const int d = s.d;
  const int ld = d + 1;
  float* qs = smem;
  float* ks = qs + kTile * ld;
  float* vs = ks + kTile * ld;
  float* ps = vs + kTile * d;
  const int bh = blockIdx.x;
  const int bi = bh / s.h;
  const int hi = bh - bi * s.h;
  const int q0 = blockIdx.y * kTile;
  const int q_end = min(q0 + kTile, s.tq);
  const int k_lim = key_limit(s, kv_len, bi);
  const int k_end = s.causal ? min(k_lim, q_end) : k_lim;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  load_tile(qs, ld, q, vq, bi, hi, q0, s.tq, d);
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // q staged; last tile's k, v and p consumed
    load_tile(ks, ld, k, vk, bi, hi, k0, s.tk, d);
    load_tile(vs, d, v, vv, bi, hi, k0, s.tk, d);
    __syncthreads();
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * ld + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      bool on[4];
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        on[j] = live(s, q0 + r, k0 + tx + 16 * j, k_lim);
        sc[i][j] = on[j] ? sc[i][j] * s.scale : kMasked;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = on[j] ? expf(sc[i][j] - m_new) : 0.f;
        rs += p;
        ps[r * kLdP + tx + 16 * j] = round_as<T>(p);
      }
      l[i] = alpha * l[i] + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    const int kn = min(kTile, k_end - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float vr[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        vr[j] = c < d ? vs[kk * d + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty + 16 * i) * kLdP + kk];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p, vr[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= s.tq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + offset(vo, bi, hi, r);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) orow[c] = from_f32<T>(acc[i][j] / denom);
    }
    if (tx == 0) lse[(long long)bh * s.tq + r] = m[i] + logf(denom);
  }
}

// ------------------------------------------- backward, shared tile math
// For the q tile at q0 and the k tile at k0 (staged in qs/dos and ks/vs),
// writes round(p) into ps (when ps != nullptr) and round(ds) into dss,
// [64 q rows][65]. lse_s / delta_s hold the tile's 64 rows.
template <typename T>
__device__ __forceinline__ void bwd_tile(const float* qs, const float* dos,
                                         const float* ks, const float* vs,
                                         const float* lse_s,
                                         const float* delta_s, float* ps,
                                         float* dss, const Dims& s, int q0,
                                         int k0, int k_lim, int ld) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  float sc[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
  for (int c = 0; c < s.d; ++c) {
    float qv[4], dv[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = qs[(ty + 16 * i) * ld + c];
      dv[i] = dos[(ty + 16 * i) * ld + c];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = ks[(tx + 16 * j) * ld + c];
      vv[j] = vs[(tx + 16 * j) * ld + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        dp[i][j] = fmaf(dv[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kc = tx + 16 * j;
      const bool on = live(s, q0 + r, k0 + kc, k_lim);
      const float p = on ? expf(sc[i][j] * s.scale - lse_s[r]) : 0.f;
      const float ds = p * (dp[i][j] - delta_s[r]) * s.scale;
      if (ps != nullptr) ps[r * kLdP + kc] = round_as<T>(p);
      dss[r * kLdP + kc] = round_as<T>(ds);
    }
  }
}

__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long base, int t0, int t_end) {
  for (int i = threadIdx.x; i < kTile; i += kFlashThreads)
    dst[i] = t0 + i < t_end ? src[base + t0 + i] : 0.f;
}

// ----------------------------------------------------- backward: dK, dV
// One block per (b*h, 64-key tile), summing over the query tiles.
// smem: Q, dO, K, V [64][d+1]; P, dS [64][65]; lse, delta [64]
template <typename T, int NJ>
__global__ void __launch_bounds__(kFlashThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ kv_len, T* __restrict__ dk,
                         T* __restrict__ dv, View vq, View vk, View vv,
                         View vdo, View vdk, View vdv, Dims s) {
  extern __shared__ float smem[];
  const int d = s.d;
  const int ld = d + 1;
  float* qs = smem;
  float* dos = qs + kTile * ld;
  float* ks = dos + kTile * ld;
  float* vs = ks + kTile * ld;
  float* ps = vs + kTile * ld;
  float* dss = ps + kTile * kLdP;
  float* lse_s = dss + kTile * kLdP;
  float* delta_s = lse_s + kTile;
  const int bh = blockIdx.x;
  const int bi = bh / s.h;
  const int hi = bh - bi * s.h;
  const int k0 = blockIdx.y * kTile;
  const int k_lim = key_limit(s, kv_len, bi);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const long long row_base = (long long)bh * s.tq;

  float adk[4][NJ], adv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  if (k0 < k_lim) {
    load_tile(ks, ld, k, vk, bi, hi, k0, s.tk, d);
    load_tile(vs, ld, v, vv, bi, hi, k0, s.tk, d);
    // causal (Tq == Tk): query tiles ending before k0 have no live pair
    for (int q0 = s.causal ? k0 : 0; q0 < s.tq; q0 += kTile) {
      __syncthreads();  // k, v staged; last tile's q, dO, p, ds consumed
      load_tile(qs, ld, q, vq, bi, hi, q0, s.tq, d);
      load_tile(dos, ld, dout, vdo, bi, hi, q0, s.tq, d);
      load_rows(lse_s, lse, row_base, q0, s.tq);
      load_rows(delta_s, delta, row_base, q0, s.tq);
      __syncthreads();
      bwd_tile<T>(qs, dos, ks, vs, lse_s, delta_s, ps, dss, s, q0, k0, k_lim,
                  ld);
      __syncthreads();
      const int rn = min(kTile, s.tq - q0);
      for (int r = 0; r < rn; ++r) {
        float dor[NJ], qr[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = tx + 16 * j;
          dor[j] = c < d ? dos[r * ld + c] : 0.f;
          qr[j] = c < d ? qs[r * ld + c] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = ps[r * kLdP + ty + 16 * i];
          const float ds = dss[r * kLdP + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            adv[i][j] = fmaf(p, dor[j], adv[i][j]);
            adk[i][j] = fmaf(ds, qr[j], adk[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty + 16 * i;
    if (kr >= s.tk) continue;
    T* krow = dk + offset(vdk, bi, hi, kr);
    T* vrow = dv + offset(vdv, bi, hi, kr);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) {
        krow[c] = from_f32<T>(adk[i][j]);
        vrow[c] = from_f32<T>(adv[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------- backward: dQ
// One block per (b*h, 64-query tile), summing over the key tiles.
// smem: Q, dO, K, V [64][d+1]; dS [64][65]; lse, delta [64]
template <typename T, int NJ>
__global__ void __launch_bounds__(kFlashThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ kv_len, T* __restrict__ dq,
                        View vq, View vk, View vv, View vdo, View vdq,
                        Dims s) {
  extern __shared__ float smem[];
  const int d = s.d;
  const int ld = d + 1;
  float* qs = smem;
  float* dos = qs + kTile * ld;
  float* ks = dos + kTile * ld;
  float* vs = ks + kTile * ld;
  float* dss = vs + kTile * ld;
  float* lse_s = dss + kTile * kLdP;
  float* delta_s = lse_s + kTile;
  const int bh = blockIdx.x;
  const int bi = bh / s.h;
  const int hi = bh - bi * s.h;
  const int q0 = blockIdx.y * kTile;
  const int q_end = min(q0 + kTile, s.tq);
  const int k_lim = key_limit(s, kv_len, bi);
  const int k_end = s.causal ? min(k_lim, q_end) : k_lim;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const long long row_base = (long long)bh * s.tq;

  load_tile(qs, ld, q, vq, bi, hi, q0, s.tq, d);
  load_tile(dos, ld, dout, vdo, bi, hi, q0, s.tq, d);
  load_rows(lse_s, lse, row_base, q0, s.tq);
  load_rows(delta_s, delta, row_base, q0, s.tq);
  float adq[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) adq[i][j] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // q, dO staged; last tile's k, v, ds consumed
    load_tile(ks, ld, k, vk, bi, hi, k0, s.tk, d);
    load_tile(vs, ld, v, vv, bi, hi, k0, s.tk, d);
    __syncthreads();
    bwd_tile<T>(qs, dos, ks, vs, lse_s, delta_s, nullptr, dss, s, q0, k0,
                k_lim, ld);
    __syncthreads();
    const int kn = min(kTile, k_end - k0);
    for (int kc = 0; kc < kn; ++kc) {
      float kr[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        kr[j] = c < d ? ks[kc * ld + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dss[(ty + 16 * i) * kLdP + kc];
#pragma unroll
        for (int j = 0; j < NJ; ++j) adq[i][j] = fmaf(ds, kr[j], adq[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= s.tq) continue;
    T* qrow = dq + offset(vdq, bi, hi, r);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) qrow[c] = from_f32<T>(adq[i][j]);
    }
  }
}

// dynamic shared memory of each kernel, bytes
inline size_t fwd_smem(int d) {
  return sizeof(float) * (size_t)(2 * kTile * (d + 1) + kTile * d +
                                  kTile * kLdP);
}
inline size_t dkv_smem(int d) {
  return sizeof(float) *
         (size_t)(4 * kTile * (d + 1) + 2 * kTile * kLdP + 2 * kTile);
}
inline size_t dq_smem(int d) {
  return sizeof(float) *
         (size_t)(4 * kTile * (d + 1) + kTile * kLdP + 2 * kTile);
}

inline View view_at(const long long* strides, int i) {
  return View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

// Raise a kernel's dynamic shared-memory limit to what the largest head
// dim of its NJ class needs, once per kernel (before any graph capture).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *done = true;
  return err;
}

template <typename T, int NJ>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, const void* kv_len,
                       const long long* strides, const Dims& s,
                       cudaStream_t stream) {
  static bool done = false;
  auto kernel = flash_fwd_kernel<T, NJ>;
  cudaError_t err = allow_smem(kernel, fwd_smem(16 * NJ), &done);
  if (err != cudaSuccess) return err;
  const dim3 grid(s.b * s.h, (s.tq + kTile - 1) / kTile);
  if (grid.x == 0 || grid.y == 0) return cudaSuccess;
  kernel<<<grid, kFlashThreads, fwd_smem(s.d), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      static_cast<const int*>(kv_len), view_at(strides, 0),
      view_at(strides, 1), view_at(strides, 2), view_at(strides, 3), s);
  return cudaGetLastError();
}

template <typename T, int NJ>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       const void* kv_len, void* dk, void* dv,
                       const long long* strides, const Dims& s,
                       cudaStream_t stream) {
  static bool done = false;
  auto kernel = flash_bwd_dkv_kernel<T, NJ>;
  cudaError_t err = allow_smem(kernel, dkv_smem(16 * NJ), &done);
  if (err != cudaSuccess) return err;
  const dim3 grid(s.b * s.h, (s.tk + kTile - 1) / kTile);
  if (grid.x == 0 || grid.y == 0) return cudaSuccess;
  kernel<<<grid, kFlashThreads, dkv_smem(s.d), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<T*>(dk),
      static_cast<T*>(dv), view_at(strides, 0), view_at(strides, 1),
      view_at(strides, 2), view_at(strides, 3), view_at(strides, 4),
      view_at(strides, 5), s);
  return cudaGetLastError();
}

template <typename T, int NJ>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* kv_len, void* dq, const long long* strides,
                      const Dims& s, cudaStream_t stream) {
  static bool done = false;
  auto kernel = flash_bwd_dq_kernel<T, NJ>;
  cudaError_t err = allow_smem(kernel, dq_smem(16 * NJ), &done);
  if (err != cudaSuccess) return err;
  const dim3 grid(s.b * s.h, (s.tq + kTile - 1) / kTile);
  if (grid.x == 0 || grid.y == 0) return cudaSuccess;
  kernel<<<grid, kFlashThreads, dq_smem(s.d), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<T*>(dq),
      view_at(strides, 0), view_at(strides, 1), view_at(strides, 2),
      view_at(strides, 3), view_at(strides, 4), s);
  return cudaGetLastError();
}

inline bool valid(const Dims& s, int dtype) {
  return s.d >= 1 && s.d <= 128 && s.b >= 0 && s.h >= 1 && s.tq >= 0 &&
         s.tk >= 0 && (dtype == kFloat32 || dtype == kBFloat16) &&
         (!s.causal || s.tq == s.tk);
}

}  // namespace ptt

// The launchers share one contract. q, k, v, dO and every output are
// [B, H, T, D] with D contiguous and the (b, h, t) strides, in elements, in
// `strides` (three per tensor, in argument order); lse and delta are
// [B*H, Tq] contiguous fp32; kv_len is [B] int32 or null; dtype 0 is fp32,
// 1 is bf16 (all of q, k, v, dO and the outputs); D <= 128; causal needs
// Tq == Tk. Each returns the CUDA error of its launch (cudaGetLastError()).
#define PTT_DISPATCH(LAUNCH, ...)                                         \
  do {                                                                    \
    if (!ptt::valid(s, dtype)) return (int)cudaErrorInvalidValue;         \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                  \
    cudaError_t err;                                                      \
    if (dtype == ptt::kFloat32)                                           \
      err = s.d <= 64 ? ptt::LAUNCH<float, 4>(__VA_ARGS__, s, st)         \
                      : ptt::LAUNCH<float, 8>(__VA_ARGS__, s, st);        \
    else                                                                  \
      err = s.d <= 64 ? ptt::LAUNCH<__nv_bfloat16, 4>(__VA_ARGS__, s, st) \
                      : ptt::LAUNCH<__nv_bfloat16, 8>(__VA_ARGS__, s, st); \
    return (int)err;                                                      \
  } while (0)

extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, const void* kv_len,
                             const long long* strides, int b, int h, int tq,
                             int tk, int d, int causal, float scale,
                             int dtype, void* stream) {
  const ptt::Dims s{b, h, tq, tk, d, causal, scale};
  PTT_DISPATCH(launch_fwd, q, k, v, o, lse, kv_len, strides);
}

extern "C" int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* kv_len,
                                 void* dk, void* dv, const long long* strides,
                                 int b, int h, int tq, int tk, int d,
                                 int causal, float scale, int dtype,
                                 void* stream) {
  const ptt::Dims s{b, h, tq, tk, d, causal, scale};
  PTT_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, kv_len, dk, dv,
               strides);
}

extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* kv_len,
                                void* dq, const long long* strides, int b,
                                int h, int tq, int tk, int d, int causal,
                                float scale, int dtype, void* stream) {
  const ptt::Dims s{b, h, tq, tk, d, causal, scale};
  PTT_DISPATCH(launch_dq, q, k, v, dout, lse, delta, kv_len, dq, strides);
}

// dynamic shared memory, bytes, of kernel 0 (forward), 1 (dK/dV) or 2 (dQ)
// at head dim d
extern "C" int ptt_flash_smem_bytes(int kernel, int d) {
  if (kernel == 0) return static_cast<int>(ptt::fwd_smem(d));
  if (kernel == 1) return static_cast<int>(ptt::dkv_smem(d));
  return static_cast<int>(ptt::dq_smem(d));
}
