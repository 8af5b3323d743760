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
// Bound on an H100: at the training shapes (T = 64 or 512, D = 64) the
// forward is bound by bytes (q, k, v read and out written once: 16.8 MB,
// 5 us at B = 64, H = 8, T = 64), with the tensor cores' time for its
// 4*Tq*Tk*D flops per head close behind at T = 512; the backward does 2.5
// times the flops.
//
// Two forward kernels, chosen in launch_fwd from dtype, D, strides and base
// pointers alone (each writes its code to ptt_flash_fwd's `launched` where it
// launches, and nowhere else):
//
// * flash_fwd_mma_kernel, bf16 with D a multiple of 16 up to 128 and every
//   stride and base pointer a multiple of 8 elements: the training path.
//   One 4-warp block per (b*h, 64-row tile); a warp owns 16 query rows. The
//   Q tile and the K and V tiles stay bf16 in shared memory, copied with
//   16-byte cp.async into rows padded by 16 bytes (flash_tiles.cuh), rows
//   past the end zero-filled by the copy itself; K/V have two stages, so
//   tile j + 1 loads while tile j is multiplied, and Q, K0 and V0 are all in
//   flight at once. Both products run on the tensor cores as
//   mma.sync.m16n8k16 (bf16 in, fp32 accumulate) from ldmatrix fragments,
//   V through ldmatrix.trans. mma.sync was taken over wgmma: at T = 64..512
//   and D = 64 the work is bound by bytes, which mma.sync reaches, and its
//   fragments let one warp keep its 16 rows' scores in registers. The S
//   fragment is scaled, masked and exponentiated in registers (in the log2
//   domain with ex2.approx; a tile no mask touches skips the mask), row max
//   and sum are shuffles over the 4 lanes of a row, and packing the fragment
//   to bf16 as the A operand of p . v is the reference's p.astype(v.dtype);
//   p never touches shared memory. The output tile is staged through the
//   warp's own Q rows and stored as 16-byte rows.
// * flash_fwd_kernel (SIMT, fp32 products on the CUDA cores): fp32 inputs
//   (the parity path: TF32 would not hold 1e-4 against the host) and any
//   bf16 input the tensor-core kernel's loads do not allow (odd head dims,
//   misaligned views). One 256-thread block (16 x 16) per (b*h, 64-row
//   tile); q, k, v tiles staged in shared memory as fp32; each thread owns a
//   4 x 4 block of the 64 x 64 score tile and 4 x ceil(D/16) output
//   accumulators; p goes through shared memory.
//
// The backward kernels (SIMT, as the second forward kernel) stage q, k, v
// and dO as fp32 tiles and run every product on the CUDA cores. Tensors are
// addressed through (b, h, t) strides with D contiguous, so the head-split
// views of [B, T, H*D] activations need no copy.
//
// Still left: the backward on the tensor cores (mma.sync on bf16 tiles from
// flash_tiles.cuh's loads and fragments, p and ds in registers), TMA loads,
// and splitting long rows.

#include "flash_tiles.cuh"

namespace ptt {

constexpr int kFlashThreads = 256;  // 16 x 16, the SIMT kernels
constexpr int kMmaThreads = 128;    // 4 warps x 16 query rows
constexpr int kLdP = kTile + 1;     // row stride of the SIMT p / ds tiles

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

// --------------------------------------- forward, bf16 on the tensor cores
// smem (bf16, rows tile_ld(d) apart): Q [64], K [2][64], V [2][64]
// DB: 16-wide blocks of the head dim the registers hold (d <= 16 * DB)
template <int DB>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse,
                         const int* __restrict__ kv_len, View vq, View vk,
                         View vv, View vo, Dims s) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int d = s.d;
  const int ld = tile_ld(d);
  const int nd = d / 16;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* ks = qs + kTile * ld;      // two stages
  __nv_bfloat16* vs = ks + 2 * kTile * ld;  // two stages
  const int bh = blockIdx.x;
  const int bi = bh / s.h;
  const int hi = bh - bi * s.h;
  const int q0 = blockIdx.y * kTile;
  const int q_end = min(q0 + kTile, s.tq);
  const int k_lim = key_limit(s, kv_len, bi);
  const int k_end = s.causal ? min(k_lim, q_end) : k_lim;
  const int ntiles = (k_end + kTile - 1) / kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;  // row of the fragment (and gid + 8)
  const int tig = lane & 3;   // column pair of the fragment
  const int wrow = warp * 16;  // this warp's rows of the tile
  const int rows[2] = {q0 + wrow + gid, q0 + wrow + gid + 8};
  // keys [0, lims[hf]) are live for row rows[hf]
  int lims[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    lims[hf] = rows[hf] >= s.tq ? 0
               : s.causal       ? min(k_lim, rows[hf] + 1)
                                : k_lim;
  const float scale2 = s.scale * 1.4426950408889634f;  // log2(e)

  float m[2] = {kMasked, kMasked};  // running max, log2 domain
  float l[2] = {0.f, 0.f};
  float oacc[2 * DB][4];
#pragma unroll
  for (int i = 0; i < 2 * DB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[i][e] = 0.f;

  if (ntiles > 0) {
    const __nv_bfloat16* qsl = q + offset(vq, bi, hi, 0);
    const __nv_bfloat16* ksl = k + offset(vk, bi, hi, 0);
    const __nv_bfloat16* vsl = v + offset(vv, bi, hi, 0);
    load_tile_async(qs, ld, qsl, vq.st, q0, s.tq, d, kMmaThreads);
    load_tile_async(ks, ld, ksl, vk.st, 0, s.tk, d, kMmaThreads);
    load_tile_async(vs, ld, vsl, vv.st, 0, s.tk, d, kMmaThreads);
    cp_async_commit();
    unsigned qf[DB][4];  // this warp's Q rows as A fragments, per 16 of d
    for (int j = 0; j < ntiles; ++j) {
      const int k0 = j * kTile;
      if (j + 1 < ntiles) {
        // the other stage was consumed before the barrier that ended the
        // last iteration
        const int st = (j + 1) & 1;
        load_tile_async(ks + st * kTile * ld, ld, ksl, vk.st, k0 + kTile,
                        s.tk, d, kMmaThreads);
        load_tile_async(vs + st * kTile * ld, ld, vsl, vv.st, k0 + kTile,
                        s.tk, d, kMmaThreads);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // every thread's copies of tile j have landed
      if (j == 0) {
#pragma unroll
        for (int kb = 0; kb < DB; ++kb)
          if (kb < nd)
            ldmatrix_x4(qf[kb], qs + (wrow + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                                    kb * 16 + (lane >> 4) * 8);
      }
      const __nv_bfloat16* kt = ks + (j & 1) * kTile * ld;
      const __nv_bfloat16* vt = vs + (j & 1) * kTile * ld;

      // s = q . k^T: 16 rows x 64 keys a warp, 8 blocks of 8 keys
      float sacc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[i][e] = 0.f;
#pragma unroll
      for (int kb = 0; kb < DB; ++kb) {
        if (kb < nd) {
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            // blocks: (keys 16 np.., d lo), (same keys, d hi),
            // (keys 16 np + 8.., d lo), (those keys, d hi)
            unsigned bf[4];
            ldmatrix_x4(bf, kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * ld +
                                kb * 16 + ((lane >> 3) & 1) * 8);
            mma_bf16(sacc[2 * np], qf[kb], bf[0], bf[1]);
            mma_bf16(sacc[2 * np + 1], qf[kb], bf[2], bf[3]);
          }
        }
      }

      // scale, mask, online softmax: all in the fragment's registers, in
      // the log2 domain (t = s * scale * log2(e), p = 2^(t - m)). A tile
      // that no mask touches for this warp's rows skips the mask.
      const bool full = k0 + kTile <= k_lim && q0 + wrow + 16 <= s.tq &&
                        (!s.causal || k0 + kTile - 1 <= q0 + wrow);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int lim = lims[hf];
        float mx = kMasked;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + nb * 8 + tig * 2 + e;
            const float tv = full || col < lim
                                 ? sacc[nb][hf * 2 + e] * scale2
                                 : kMasked;
            sacc[nb][hf * 2 + e] = tv;
            mx = fmaxf(mx, tv);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hf], mx);
        const float alpha = fast_exp2(m[hf] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + nb * 8 + tig * 2 + e;
            const float pr = full || col < lim
                                 ? fast_exp2(sacc[nb][hf * 2 + e] - m_new)
                                 : 0.f;
            rs += pr;
            sacc[nb][hf * 2 + e] = pr;
          }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l[hf] = alpha * l[hf] + rs;
        m[hf] = m_new;
#pragma unroll
        for (int i = 0; i < 2 * DB; ++i) {
          oacc[i][hf * 2] *= alpha;
          oacc[i][hf * 2 + 1] *= alpha;
        }
      }

      // out += p . v, p packed to bf16 as the A operand; key blocks with
      // no live key of this tile are left out
      const int kn = min(kTile, k_end - k0);
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        if (kb * 16 < kn) {
          unsigned pf[4];
          pf[0] = pack_bf16(sacc[2 * kb][0], sacc[2 * kb][1]);
          pf[1] = pack_bf16(sacc[2 * kb][2], sacc[2 * kb][3]);
          pf[2] = pack_bf16(sacc[2 * kb + 1][0], sacc[2 * kb + 1][1]);
          pf[3] = pack_bf16(sacc[2 * kb + 1][2], sacc[2 * kb + 1][3]);
#pragma unroll
          for (int dp = 0; dp < DB; ++dp) {
            if (dp < nd) {
              // transposed blocks: (keys lo, d 16 dp..), (keys hi, same d),
              // (keys lo, d 16 dp + 8..), (keys hi, that d)
              unsigned bf[4];
              ldmatrix_x4_trans(
                  bf, vt + (kb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                          dp * 16 + (lane >> 4) * 8);
              mma_bf16(oacc[2 * dp], pf, bf[0], bf[1]);
              mma_bf16(oacc[2 * dp + 1], pf, bf[2], bf[3]);
            }
          }
        }
      }
      __syncthreads();  // this stage may be overwritten two tiles on
    }
  }

  // out = acc / l through this warp's own Q rows (their fragments are in
  // registers), then 16-byte row stores
  float denom[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) denom[hf] = l[hf] == 0.f ? 1.f : l[hf];
#pragma unroll
  for (int i = 0; i < 2 * DB; ++i) {
    if (i < 2 * nd) {
      const int col = i * 8 + tig * 2;
      *reinterpret_cast<unsigned*>(qs + (wrow + gid) * ld + col) =
          pack_bf16(oacc[i][0] / denom[0], oacc[i][1] / denom[0]);
      *reinterpret_cast<unsigned*>(qs + (wrow + gid + 8) * ld + col) =
          pack_bf16(oacc[i][2] / denom[1], oacc[i][3] / denom[1]);
    }
  }
  __syncwarp();
  const int chunks = d / 8;
  for (int i = lane; i < 16 * chunks; i += 32) {
    const int r = i / chunks;
    const int c = i - r * chunks;
    const int row = q0 + wrow + r;
    if (row < s.tq)
      *reinterpret_cast<uint4*>(o + offset(vo, bi, hi, row) + c * 8) =
          *reinterpret_cast<const uint4*>(qs + (wrow + r) * ld + c * 8);
  }
  if (tig == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (rows[hf] < s.tq)
        lse[(long long)bh * s.tq + rows[hf]] =
            l[hf] == 0.f ? kMasked
                         : m[hf] * 0.6931471805599453f + logf(l[hf]);
  }
}

// ------------------------------------------- forward, SIMT (fp32 products)
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

// What a forward launcher writes to `launched`: the kernel it put on the
// stream. Nothing is written where nothing is launched (an empty grid).
constexpr int kLaunchedSimt = 1;
constexpr int kLaunchedMma = 2;

template <typename T, int NJ>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, const void* kv_len,
                       const long long* strides, int* launched,
                       const Dims& s, cudaStream_t stream) {
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
  *launched = kLaunchedSimt;
  return cudaGetLastError();
}

// The tensor-core forward takes bf16 with a head dim that is a multiple of
// 16 up to 128 and, for its 16-byte copies and stores, strides and base
// pointers (q, k, v, out) that are multiples of 8 elements.
inline bool use_mma(int dtype, int d, const long long* strides,
                    const void* q, const void* k, const void* v,
                    const void* o) {
  if (dtype != kBFloat16 || d < 16 || d > 128 || d % 16 != 0) return false;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8 != 0) return false;
  const void* ptrs[4] = {q, k, v, o};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<size_t>(ptr) % 16 != 0) return false;
  return true;
}

inline size_t mma_smem(int d) {
  return sizeof(__nv_bfloat16) * (size_t)(5 * kTile * tile_ld(d));
}

template <int DB>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v,
                           void* o, void* lse, const void* kv_len,
                           const long long* strides, int* launched,
                           const Dims& s, cudaStream_t stream) {
  static bool done = false;
  auto kernel = flash_fwd_mma_kernel<DB>;
  cudaError_t err = allow_smem(kernel, mma_smem(16 * DB), &done);
  if (err != cudaSuccess) return err;
  const dim3 grid(s.b * s.h, (s.tq + kTile - 1) / kTile);
  if (grid.x == 0 || grid.y == 0) return cudaSuccess;
  kernel<<<grid, kMmaThreads, mma_smem(s.d), stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), static_cast<const int*>(kv_len),
      view_at(strides, 0), view_at(strides, 1), view_at(strides, 2),
      view_at(strides, 3), s);
  *launched = kLaunchedMma;
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
// ptt_flash_fwd also sets *launched to the forward kernel it launched: 0 none
// (an empty grid or an error before the launch), 1 the SIMT kernel, 2 the
// tensor-core kernel.
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
                             int dtype, int* launched, void* stream) {
  const ptt::Dims s{b, h, tq, tk, d, causal, scale};
  *launched = 0;
  if (ptt::valid(s, dtype) && ptt::use_mma(dtype, d, strides, q, k, v, o)) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return (int)(d <= 64 ? ptt::launch_fwd_mma<4>(q, k, v, o, lse, kv_len,
                                                  strides, launched, s, st)
                         : ptt::launch_fwd_mma<8>(q, k, v, o, lse, kv_len,
                                                  strides, launched, s, st));
  }
  PTT_DISPATCH(launch_fwd, q, k, v, o, lse, kv_len, strides, launched);
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

// dynamic shared memory, bytes, of kernel 0 (SIMT forward), 1 (dK/dV),
// 2 (dQ) or 3 (tensor-core forward) at head dim d
extern "C" int ptt_flash_smem_bytes(int kernel, int d) {
  if (kernel == 3) return static_cast<int>(ptt::mma_smem(d));
  if (kernel == 0) return static_cast<int>(ptt::fwd_smem(d));
  if (kernel == 1) return static_cast<int>(ptt::dkv_smem(d));
  return static_cast<int>(ptt::dq_smem(d));
}
