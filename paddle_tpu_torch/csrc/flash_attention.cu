// Flash attention over [B, H, T, D]: the FA2 forward (K2) and its two-kernel
// backward (K3: dK/dV over query tiles, dQ over key tiles).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
// _fwd_kernel (launched by _flash_fwd) and _bwd_dkv_kernel / _bwd_dq_kernel
// (launched by _flash_bwd).
//
// What they compute (the Pallas kernels' function, not their blocking):
// s = (q . k^T) * scale with fp32 accumulation over inputs of the tensors'
// dtype; causal (col <= row + Tk - Tq, aligned bottom-right as the
// reference's tril(.., tk - tq), so any Tq and Tk) and per-example kv_len
// (col < kv_len[b]) masks; online softmax with fp32 m and l; p rounded to
// v's dtype before p . v; out in q's dtype and lse = m + log(l) in fp32. The
// backward recomputes p = exp(s - lse), takes delta = rowsum(dO * O) in
// fp32, forms ds = p * (dp - delta) * scale, rounds p and ds to the input
// dtype before the dV, dK and dQ products, and sums dK/dV over query tiles
// and dQ over key tiles. Two backward kernels keep every output owned by one
// block: no atomics, the result does not depend on the order blocks run in.
// The dQ kernel, launched first, also computes delta for its query rows (it
// loads their dO anyway) and writes it to a [B*H, Tq] fp32 buffer; the dK/dV
// kernel, launched second on the same stream, reads it there.
//
// Tiles with no live key (past kv_len, above the causal band) are skipped,
// never run masked: a masked score is -1e30, and running such a tile would
// give p = exp(-1e30 - lse) = 1 on a row whose lse is itself -1e30. Inside a
// tile that runs, masked entries get p = 0 explicitly. Any Tq and Tk work:
// rows and columns past the end of a tail tile are zero-filled and masked.
// A row with no live key (kv_len 0, or the first Tq - Tk rows under the
// causal mask) gives what the reference's reference_attention gives, the
// softmax of an all -1e9 row: out = mean of V over all Tk keys (written by
// the forward kernels after their key loop) and lse = -1e9 + log(Tk); in
// the backward it adds dO / Tk to every key's dV (the dK/dV kernels, after
// their query loop) and nothing to dQ or dK.
//
// Bound on an H100: at the training shapes (T = 64 or 512, D = 64) the
// forward is bound by bytes (q, k, v read and out written once: 16.8 MB,
// 5 us at B = 64, H = 8, T = 64), with the tensor cores' time for its
// 4*Tq*Tk*D flops per head close behind at T = 512; the backward reads q,
// k, v, o, dO and writes dq, dk, dv (twice the bytes) and does 2.5 times
// the flops.
//
// Each of the three launchers (forward, dK/dV, dQ) chooses between a
// tensor-core kernel and a SIMT kernel from dtype, D, strides and base
// pointers alone, and writes its code to the caller's `launched` where it
// launches, and nowhere else:
//
// * the tensor-core kernels (flash_fwd_mma_kernel, flash_bwd_dkv_mma_kernel,
//   flash_bwd_dq_mma_kernel), bf16 with D a multiple of 16 up to 128 and
//   every stride and base pointer a multiple of 8 elements: the training
//   path. One 4-warp block per (b*h, 64-row tile); a warp owns 16 rows of
//   the block's own tile (query rows in the forward and dQ, key rows in
//   dK/dV). Tiles stay bf16 in shared memory, copied with 16-byte cp.async
//   into rows padded by 16 bytes (flash_tiles.cuh), rows past the end
//   zero-filled by the copy itself; the tiles the loop walks over (K/V, or
//   Q/dO for dK/dV) have two stages, so tile j + 1 loads while tile j is
//   multiplied. Every product runs on the tensor cores as mma.sync.m16n8k16
//   (bf16 in, fp32 accumulate) from ldmatrix fragments; an operand whose
//   k index runs down the rows of shared memory (V in p . v, dO in
//   p^T . dO, Q in ds^T . q, K in ds . k) goes through ldmatrix.trans.
//   mma.sync was taken over wgmma: at T = 64..512 and D = 64 the work is
//   bound by bytes and latency, which mma.sync reaches, and its fragments
//   let one warp keep its 16 rows' scores in registers. A score fragment is
//   scaled, masked and exponentiated in registers (in the log2 domain with
//   ex2.approx; a tile no mask touches skips the mask). In the forward, row
//   max and sum are shuffles over the 4 lanes of a row and packing the
//   fragment to bf16 as the A operand of p . v is the reference's
//   p.astype(v.dtype). The backward keeps the transposed scores: dK/dV
//   forms s^T = K . Q^T and dp^T = V . dO^T for its 16 key rows x 32
//   queries (a tile in two halves, so the score fragments fit beside dK
//   and dV in 128 registers at D <= 64: four blocks an SM), packs p^T (the
//   reference's rounding of p) as the A operand of dV += p^T . dO and
//   ds^T = p^T (dp^T - delta) scale as that of dK += ds^T . Q, so it needs
//   no shared memory for p or ds and computes each score once (5 tile
//   products a tile pair between the two kernels with dQ's s, dp and dQ,
//   where the SIMT pair takes 7). dK and dV, like dQ, stay in fp32
//   registers for the whole loop. Output tiles leave through the warp's
//   own rows of shared memory as 16-byte rows.
// * the SIMT kernels (flash_fwd_kernel, flash_bwd_dkv_kernel,
//   flash_bwd_dq_kernel; fp32 products on the CUDA cores): fp32 inputs (the
//   parity path: TF32 would not hold 1e-4 against the host) and any bf16
//   input the tensor-core kernels' loads do not allow (odd head dims,
//   misaligned views), and every head dim up to 256 (kMaxHeadDim). One
//   256-thread block (16 x 16) per (b*h, 64-row tile); tiles staged in
//   shared memory as fp32; each thread owns a 4 x 4 block of the 64 x 64
//   score tile; p and ds go through shared memory. Above D = 128 the two
//   backward kernels walk query tiles of 32 rows (2 x 4 a thread), so that
//   fp32 tiles of 256 columns fit a block's 227 KB.
//
// Tensors are addressed through (b, h, t) strides with D contiguous, so the
// head-split views of [B, T, H*D] activations need no copy.
//
// * the wide SIMT kernels (flash_fwd_wide_kernel, flash_bwd_dkv_wide_kernel,
//   flash_bwd_dq_wide_kernel) for every head dim above 256: the same tiles
//   and numerics, the head dim walked in chunks of 128 columns (scores
//   summed over the chunks before the softmax; each block writes one
//   128-column chunk of the output and recomputes the scores for it).
//
// Still left: TMA loads, and splitting long rows.

#include "flash_tiles.cuh"

namespace ptt {

constexpr int kFlashThreads = 256;  // 16 x 16, the SIMT kernels
constexpr int kMmaThreads = 128;    // 4 warps x 16 query rows
constexpr int kLdP = kTile + 1;     // row stride of the SIMT p / ds tiles

// rows [t0, t0 + rows) of one (b, h) slice into dst[rows][ld] as fp32;
// rows at or past t_end are zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          const View& v, int bi, int hi,
                                          int t0, int t_end, int d,
                                          int rows = kTile) {
  for (int i = threadIdx.x; i < rows * d; i += kFlashThreads) {
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
  const int off = s.tk - s.tq;  // the causal band's bottom-right offset
  const int k_end = s.causal ? min(k_lim, max(q_end + off, 0)) : k_lim;
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
  for (int hf = 0; hf < 2; ++hf) lims[hf] = row_limit(s, k_lim, rows[hf]);
  const float scale2 = s.scale * kLog2e;

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
            ldmatrix_x4(qf[kb], a_rows(qs, ld, wrow, kb * 16, lane));
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
            ldmatrix_x4(bf, b_rows(kt, ld, np * 16, kb * 16, lane));
            mma_bf16(sacc[2 * np], qf[kb], bf[0], bf[1]);
            mma_bf16(sacc[2 * np + 1], qf[kb], bf[2], bf[3]);
          }
        }
      }

      // scale, mask, online softmax: all in the fragment's registers, in
      // the log2 domain (t = s * scale * log2(e), p = 2^(t - m)). A tile
      // that no mask touches for this warp's rows skips the mask.
      const bool full = k0 + kTile <= k_lim && q0 + wrow + 16 <= s.tq &&
                        (!s.causal || k0 + kTile - 1 <= q0 + wrow + off);
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
          pack_a(pf, sacc[2 * kb], sacc[2 * kb + 1]);
#pragma unroll
          for (int dp = 0; dp < DB; ++dp) {
            if (dp < nd) {
              // transposed blocks: (keys lo, d 16 dp..), (keys hi, same d),
              // (keys lo, d 16 dp + 8..), (keys hi, that d)
              unsigned bf[4];
              ldmatrix_x4_trans(bf, b_trans(vt, ld, kb * 16, dp * 16, lane));
              mma_bf16(oacc[2 * dp], pf, bf[0], bf[1]);
              mma_bf16(oacc[2 * dp + 1], pf, bf[2], bf[3]);
            }
          }
        }
      }
      __syncthreads();  // this stage may be overwritten two tiles on
    }
  }

  // rows with no live key (l = 0) take the mean of V over all Tk keys,
  // through the K stages, free now (the loop ended on a barrier)
  const int ndead = dead_rows(s, k_lim);
  if (q0 < ndead) {
    float* mv = reinterpret_cast<float*>(ks);
    sum_rows(mv, v + offset(vv, bi, hi, 0), vv.st, s.tk,
             s.tk > 0 ? 1.f / s.tk : 0.f, d, kMmaThreads);
    __syncthreads();
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (rows[hf] < ndead)
#pragma unroll
        for (int i = 0; i < 2 * DB; ++i)
          if (i < d / 8) {
            oacc[i][hf * 2] = mv[i * 8 + tig * 2];
            oacc[i][hf * 2 + 1] = mv[i * 8 + tig * 2 + 1];
          }
  }

  // out = acc / l through this warp's own Q rows (their fragments are in
  // registers), then 16-byte row stores
  float denom[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) denom[hf] = l[hf] == 0.f ? 1.f : l[hf];
#pragma unroll
  for (int i = 0; i < 2 * DB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[i][e] /= denom[e >> 1];
  store_rows<DB>(qs, ld, oacc, wrow, o, vo, bi, hi, q0, s.tq, d, lane);
  if (tig == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (rows[hf] < s.tq)
        lse[(long long)bh * s.tq + rows[hf]] =
            l[hf] == 0.f ? dead_lse(s)
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
  const int k_end =
      s.causal ? min(k_lim, max(q_end + s.tk - s.tq, 0)) : k_lim;
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

  // rows with no live key (l = 0) take the mean of V over all Tk keys,
  // through the K tile, free once every thread is past the loop
  const int ndead = dead_rows(s, k_lim);
  if (q0 < ndead) {
    __syncthreads();
    sum_rows(ks, v + offset(vv, bi, hi, 0), vv.st, s.tk,
             s.tk > 0 ? 1.f / s.tk : 0.f, d, kFlashThreads);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (q0 + ty + 16 * i < ndead)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = tx + 16 * j;
          acc[i][j] = c < d ? ks[c] : 0.f;
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
    if (tx == 0)
      lse[(long long)bh * s.tq + r] =
          l[i] == 0.f ? dead_lse(s) : m[i] + logf(denom);
  }
}

// ------------------------------------------- backward, shared tile math
// From the unscaled scores sc = q . k and dp = dO . v of a tile, writes
// round(p) into ps (when ps != nullptr) and round(ds) into dss,
// [16 * QI q rows][65].
template <typename T, int QI>
__device__ __forceinline__ void bwd_finish(const float (&sc)[QI][4],
                                           const float (&dp)[QI][4],
                                           const float* lse_s,
                                           const float* delta_s, float* ps,
                                           float* dss, const Dims& s, int q0,
                                           int k0, int k_lim) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < QI; ++i) {
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

// For the q tile at q0 (16 * QI rows) and the k tile at k0 (staged in
// qs/dos and ks/vs), writes round(p) into ps (when ps != nullptr) and
// round(ds) into dss, [16 * QI q rows][65]. lse_s / delta_s hold the tile's
// rows.
template <typename T, int QI>
__device__ __forceinline__ void bwd_tile(const float* qs, const float* dos,
                                         const float* ks, const float* vs,
                                         const float* lse_s,
                                         const float* delta_s, float* ps,
                                         float* dss, const Dims& s, int q0,
                                         int k0, int k_lim, int ld) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  float sc[QI][4], dp[QI][4];
#pragma unroll
  for (int i = 0; i < QI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
  for (int c = 0; c < s.d; ++c) {
    float qv[QI], dv[QI], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < QI; ++i) {
      qv[i] = qs[(ty + 16 * i) * ld + c];
      dv[i] = dos[(ty + 16 * i) * ld + c];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = ks[(tx + 16 * j) * ld + c];
      vv[j] = vs[(tx + 16 * j) * ld + c];
    }
#pragma unroll
    for (int i = 0; i < QI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        dp[i][j] = fmaf(dv[i], vv[j], dp[i][j]);
      }
  }
  bwd_finish<T, QI>(sc, dp, lse_s, delta_s, ps, dss, s, q0, k0, k_lim);
}

__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long base, int t0, int t_end,
                                          int rows) {
  for (int i = threadIdx.x; i < rows; i += kFlashThreads)
    dst[i] = t0 + i < t_end ? src[base + t0 + i] : 0.f;
}

// ----------------------------------------------------- backward: dK, dV
// One block per (b*h, 64-key tile), summing over the query tiles of QT =
// 16 * QI rows (32 above D = 128, for shared memory).
// smem: Q, dO [QT][d+1]; K, V [64][d+1]; P, dS [QT][65]; lse, delta [QT]
template <typename T, int NJ, int QI>
__global__ void __launch_bounds__(kFlashThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ kv_len, T* __restrict__ dk,
                         T* __restrict__ dv, View vq, View vk, View vv,
                         View vdo, View vdk, View vdv, Dims s) {
  constexpr int QT = 16 * QI;
  extern __shared__ float smem[];
  const int d = s.d;
  const int ld = d + 1;
  float* qs = smem;
  float* dos = qs + QT * ld;
  float* ks = dos + QT * ld;
  float* vs = ks + kTile * ld;
  float* ps = vs + kTile * ld;
  float* dss = ps + QT * kLdP;
  float* lse_s = dss + QT * kLdP;
  float* delta_s = lse_s + QT;
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
    // causal: query rows below k0 - (Tk - Tq) have no live pair
    for (int q0 = s.causal ? max(k0 - (s.tk - s.tq), 0) : 0; q0 < s.tq;
         q0 += QT) {
      __syncthreads();  // k, v staged; last tile's q, dO, p, ds consumed
      load_tile(qs, ld, q, vq, bi, hi, q0, s.tq, d, QT);
      load_tile(dos, ld, dout, vdo, bi, hi, q0, s.tq, d, QT);
      load_rows(lse_s, lse, row_base, q0, s.tq, QT);
      load_rows(delta_s, delta, row_base, q0, s.tq, QT);
      __syncthreads();
      bwd_tile<T, QI>(qs, dos, ks, vs, lse_s, delta_s, ps, dss, s, q0, k0,
                      k_lim, ld);
      __syncthreads();
      const int rn = min(QT, s.tq - q0);
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

  // rows with no live key add dO / Tk to every key's dV (p rounded as the
  // live p is), through the Q tile, free once every thread is past the loop
  const int ndead = dead_rows(s, k_lim);
  if (ndead > 0) {
    __syncthreads();
    sum_rows(qs, dout + offset(vdo, bi, hi, 0), vdo.st, ndead,
             round_as<T>(1.f / s.tk), d, kFlashThreads);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        if (c < d) adv[i][j] += qs[c];
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
// One block per (b*h, query tile of QT = 16 * QI rows: 32 above D = 128,
// for shared memory), summing over the key tiles. Computes delta =
// rowsum(dO * O) of its rows first and writes it out for the dK/dV kernel,
// which runs after it on the same stream.
// smem: Q, dO [QT][d+1]; K, V [64][d+1]; dS [QT][65]; lse, delta [QT]
template <typename T, int NJ, int QI>
__global__ void __launch_bounds__(kFlashThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const T* __restrict__ o,
                        const float* __restrict__ lse,
                        float* __restrict__ delta,
                        const int* __restrict__ kv_len, T* __restrict__ dq,
                        View vq, View vk, View vv, View vdo, View vo,
                        View vdq, Dims s) {
  constexpr int QT = 16 * QI;
  extern __shared__ float smem[];
  const int d = s.d;
  const int ld = d + 1;
  float* qs = smem;
  float* dos = qs + QT * ld;
  float* ks = dos + QT * ld;
  float* vs = ks + kTile * ld;
  float* dss = vs + kTile * ld;
  float* lse_s = dss + QT * kLdP;
  float* delta_s = lse_s + QT;
  const int bh = blockIdx.x;
  const int bi = bh / s.h;
  const int hi = bh - bi * s.h;
  const int q0 = blockIdx.y * QT;
  const int q_end = min(q0 + QT, s.tq);
  const int k_lim = key_limit(s, kv_len, bi);
  const int k_end =
      s.causal ? min(k_lim, max(q_end + s.tk - s.tq, 0)) : k_lim;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const long long row_base = (long long)bh * s.tq;

  load_tile(qs, ld, q, vq, bi, hi, q0, s.tq, d, QT);
  load_tile(dos, ld, dout, vdo, bi, hi, q0, s.tq, d, QT);
  load_rows(lse_s, lse, row_base, q0, s.tq, QT);
  __syncthreads();  // dO staged
  // delta of row r: the 16 threads of the row each sum every 16th column
#pragma unroll
  for (int i = 0; i < QI; ++i) {
    const int r = ty + 16 * i;
    float part = 0.f;
    if (q0 + r < s.tq) {
      const T* orow = o + offset(vo, bi, hi, q0 + r);
      for (int c = tx; c < d; c += 16)
        part += dos[r * ld + c] * to_f32(orow[c]);
    }
    const float total = row_sum(part);
    if (tx == 0) {
      delta_s[r] = total;
      if (q0 + r < s.tq) delta[row_base + q0 + r] = total;
    }
  }
  float adq[QI][NJ];
#pragma unroll
  for (int i = 0; i < QI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) adq[i][j] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // q, dO staged; last tile's k, v, ds consumed
    load_tile(ks, ld, k, vk, bi, hi, k0, s.tk, d);
    load_tile(vs, ld, v, vv, bi, hi, k0, s.tk, d);
    __syncthreads();
    bwd_tile<T, QI>(qs, dos, ks, vs, lse_s, delta_s, nullptr, dss, s, q0, k0,
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
      for (int i = 0; i < QI; ++i) {
        const float ds = dss[(ty + 16 * i) * kLdP + kc];
#pragma unroll
        for (int j = 0; j < NJ; ++j) adq[i][j] = fmaf(ds, kr[j], adq[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < QI; ++i) {
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

// --------------------------------------- head dims above 256 (SIMT, wide)
// The SIMT kernels above hold a whole head-dim row of every tile in shared
// memory, which at fp32 fits up to D = 256. Above that, the wide kernels
// walk the head dim in chunks of kWideCols columns: q . k^T (and dO . v^T)
// of a tile is accumulated over the chunks, column by column in order,
// before the softmax, and the output columns are split over blockIdx.z, a
// chunk of kWideCols a block. Each block of a (b*h, tile) recomputes the
// tile's scores for its own output chunk: D / kWideCols times the score
// work, for tiles of at most (kWideCols + 1) * 4 bytes a row.
constexpr int kWideCols = 128;
constexpr int kWideNJ = kWideCols / 16;
constexpr int kWideLd = kWideCols + 1;

// sc[i][j] += q . k over every chunk of the head dim for the query rows
// ty + 16 i of the qs tile and the keys tx + 16 j of the ks tile (and, with
// DP, dp += dO . v through dos and vs), staging each chunk in shared memory
// first. Rows past t_end load as zeros.
template <typename T, int QI, bool DP>
__device__ __forceinline__ void wide_scores(
    float (&sc)[QI][4], float (&dp)[QI][4], float* qs, float* dos, float* ks,
    float* vs, const T* q, const T* dout, const T* k, const T* v,
    const View& vq, const View& vdo, const View& vk, const View& vv, int bi,
    int hi, int q0, int k0, const Dims& s) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < QI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
  for (int c0 = 0; c0 < s.d; c0 += kWideCols) {
    const int dc = min(kWideCols, s.d - c0);
    __syncthreads();  // the last chunk (or tile) consumed
    load_tile(qs, kWideLd, q + c0, vq, bi, hi, q0, s.tq, dc, 16 * QI);
    load_tile(ks, kWideLd, k + c0, vk, bi, hi, k0, s.tk, dc);
    if constexpr (DP) {
      load_tile(dos, kWideLd, dout + c0, vdo, bi, hi, q0, s.tq, dc, 16 * QI);
      load_tile(vs, kWideLd, v + c0, vv, bi, hi, k0, s.tk, dc);
    }
    __syncthreads();
    for (int c = 0; c < dc; ++c) {
      float qv[QI], dv[QI], kv[4], vv4[4];
#pragma unroll
      for (int i = 0; i < QI; ++i) {
        qv[i] = qs[(ty + 16 * i) * kWideLd + c];
        if constexpr (DP) dv[i] = dos[(ty + 16 * i) * kWideLd + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(tx + 16 * j) * kWideLd + c];
        if constexpr (DP) vv4[j] = vs[(tx + 16 * j) * kWideLd + c];
      }
#pragma unroll
      for (int i = 0; i < QI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          if constexpr (DP) dp[i][j] = fmaf(dv[i], vv4[j], dp[i][j]);
        }
    }
  }
}

// forward: grid (B*H, q tiles, D chunks)
// smem: Q, K [64][kWideLd] (a chunk of columns), V [64][kWideCols] (the
// block's output chunk), P [64][65]
template <typename T>
__global__ void __launch_bounds__(kFlashThreads)
    flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o,
                          float* __restrict__ lse,
                          const int* __restrict__ kv_len, View vq, View vk,
                          View vv, View vo, Dims s) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kTile * kWideLd;
  float* vs = ks + kTile * kWideLd;
  float* ps = vs + kTile * kWideCols;
  const int bh = blockIdx.x;
  const int bi = bh / s.h;
  const int hi = bh - bi * s.h;
  const int q0 = blockIdx.y * kTile;
  const int q_end = min(q0 + kTile, s.tq);
  const int c_out = blockIdx.z * kWideCols;
  const int w_out = min(kWideCols, s.d - c_out);
  const int k_lim = key_limit(s, kv_len, bi);
  const int k_end =
      s.causal ? min(k_lim, max(q_end + s.tk - s.tq, 0)) : k_lim;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  float m[4], l[4], acc[4][kWideNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kWideNJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    float sc[4][4], unused[4][4];
    wide_scores<T, 4, false>(sc, unused, qs, nullptr, ks, nullptr, q,
                             nullptr, k, nullptr, vq, vq, vk, vk, bi, hi, q0,
                             k0, s);
    // the chunk loop's barrier covers the last p . v's reads of V and P
    load_tile(vs, kWideCols, v + c_out, vv, bi, hi, k0, s.tk, w_out);
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
      for (int j = 0; j < kWideNJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    const int kn = min(kTile, k_end - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float vr[kWideNJ];
#pragma unroll
      for (int j = 0; j < kWideNJ; ++j) {
        const int c = tx + 16 * j;
        vr[j] = c < w_out ? vs[kk * kWideCols + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty + 16 * i) * kLdP + kk];
#pragma unroll
        for (int j = 0; j < kWideNJ; ++j) acc[i][j] = fmaf(p, vr[j], acc[i][j]);
      }
    }
  }

  // rows with no live key: the mean of V's chunk columns over all Tk keys
  const int ndead = dead_rows(s, k_lim);
  if (q0 < ndead) {
    __syncthreads();
    sum_rows(ks, v + offset(vv, bi, hi, 0) + c_out, vv.st, s.tk,
             s.tk > 0 ? 1.f / s.tk : 0.f, w_out, kFlashThreads);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (q0 + ty + 16 * i < ndead)
#pragma unroll
        for (int j = 0; j < kWideNJ; ++j) {
          const int c = tx + 16 * j;
          acc[i][j] = c < w_out ? ks[c] : 0.f;
        }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= s.tq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + offset(vo, bi, hi, r) + c_out;
#pragma unroll
    for (int j = 0; j < kWideNJ; ++j) {
      const int c = tx + 16 * j;
      if (c < w_out) orow[c] = from_f32<T>(acc[i][j] / denom);
    }
    if (tx == 0 && blockIdx.z == 0)
      lse[(long long)bh * s.tq + r] =
          l[i] == 0.f ? dead_lse(s) : m[i] + logf(denom);
  }
}

// dK, dV: grid (B*H, key tiles, D chunks), summing over query tiles of 64
// smem: Q, dO [64][kWideLd]; K, V [64][kWideLd]; P, dS [64][65]; lse,
// delta [64]
template <typename T>
__global__ void __launch_bounds__(kFlashThreads)
    flash_bwd_dkv_wide_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const int* __restrict__ kv_len,
                              T* __restrict__ dk, T* __restrict__ dv,
                              View vq, View vk, View vv, View vdo, View vdk,
                              View vdv, Dims s) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * kWideLd;
  float* ks = dos + kTile * kWideLd;
  float* vs = ks + kTile * kWideLd;
  float* ps = vs + kTile * kWideLd;
  float* dss = ps + kTile * kLdP;
  float* lse_s = dss + kTile * kLdP;
  float* delta_s = lse_s + kTile;
  const int bh = blockIdx.x;
  const int bi = bh / s.h;
  const int hi = bh - bi * s.h;
  const int k0 = blockIdx.y * kTile;
  const int c_out = blockIdx.z * kWideCols;
  const int w_out = min(kWideCols, s.d - c_out);
  const int k_lim = key_limit(s, kv_len, bi);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const long long row_base = (long long)bh * s.tq;

  float adk[4][kWideNJ], adv[4][kWideNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kWideNJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  if (k0 < k_lim) {
    for (int q0 = s.causal ? max(k0 - (s.tk - s.tq), 0) : 0; q0 < s.tq;
         q0 += kTile) {
      // the last tile's lse, delta, p and ds were read before the barriers
      // that came after them
      load_rows(lse_s, lse, row_base, q0, s.tq, kTile);
      load_rows(delta_s, delta, row_base, q0, s.tq, kTile);
      float sc[4][4], dp[4][4];
      wide_scores<T, 4, true>(sc, dp, qs, dos, ks, vs, q, dout, k, v, vq, vdo,
                              vk, vv, bi, hi, q0, k0, s);
      bwd_finish<T, 4>(sc, dp, lse_s, delta_s, ps, dss, s, q0, k0, k_lim);
      __syncthreads();  // p, ds written; the score chunks consumed
      load_tile(qs, kWideLd, q + c_out, vq, bi, hi, q0, s.tq, w_out);
      load_tile(dos, kWideLd, dout + c_out, vdo, bi, hi, q0, s.tq, w_out);
      __syncthreads();
      const int rn = min(kTile, s.tq - q0);
      for (int r = 0; r < rn; ++r) {
        float dor[kWideNJ], qr[kWideNJ];
#pragma unroll
        for (int j = 0; j < kWideNJ; ++j) {
          const int c = tx + 16 * j;
          dor[j] = c < w_out ? dos[r * kWideLd + c] : 0.f;
          qr[j] = c < w_out ? qs[r * kWideLd + c] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = ps[r * kLdP + ty + 16 * i];
          const float ds = dss[r * kLdP + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < kWideNJ; ++j) {
            adv[i][j] = fmaf(p, dor[j], adv[i][j]);
            adk[i][j] = fmaf(ds, qr[j], adk[i][j]);
          }
        }
      }
      __syncthreads();  // before the next tile's lse, delta and chunks
    }
  }

  const int ndead = dead_rows(s, k_lim);
  if (ndead > 0) {
    __syncthreads();
    sum_rows(qs, dout + offset(vdo, bi, hi, 0) + c_out, vdo.st, ndead,
             round_as<T>(1.f / s.tk), w_out, kFlashThreads);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kWideNJ; ++j) {
        const int c = tx + 16 * j;
        if (c < w_out) adv[i][j] += qs[c];
      }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty + 16 * i;
    if (kr >= s.tk) continue;
    T* krow = dk + offset(vdk, bi, hi, kr) + c_out;
    T* vrow = dv + offset(vdv, bi, hi, kr) + c_out;
#pragma unroll
    for (int j = 0; j < kWideNJ; ++j) {
      const int c = tx + 16 * j;
      if (c < w_out) {
        krow[c] = from_f32<T>(adk[i][j]);
        vrow[c] = from_f32<T>(adv[i][j]);
      }
    }
  }
}

// dQ: grid (B*H, query tiles of 64, D chunks), summing over key tiles.
// Block z == 0 writes delta = rowsum(dO * O) of its rows for the dK/dV
// kernel (every z computes it, reading dO and O from device memory).
// smem: Q, dO [64][kWideLd]; K, V [64][kWideLd]; dS [64][65]; lse, delta
// [64]
template <typename T>
__global__ void __launch_bounds__(kFlashThreads)
    flash_bwd_dq_wide_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const T* __restrict__ o,
                             const float* __restrict__ lse,
                             float* __restrict__ delta,
                             const int* __restrict__ kv_len,
                             T* __restrict__ dq, View vq, View vk, View vv,
                             View vdo, View vo, View vdq, Dims s) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * kWideLd;
  float* ks = dos + kTile * kWideLd;
  float* vs = ks + kTile * kWideLd;
  float* dss = vs + kTile * kWideLd;
  float* lse_s = dss + kTile * kLdP;
  float* delta_s = lse_s + kTile;
  const int bh = blockIdx.x;
  const int bi = bh / s.h;
  const int hi = bh - bi * s.h;
  const int q0 = blockIdx.y * kTile;
  const int q_end = min(q0 + kTile, s.tq);
  const int c_out = blockIdx.z * kWideCols;
  const int w_out = min(kWideCols, s.d - c_out);
  const int k_lim = key_limit(s, kv_len, bi);
  const int k_end =
      s.causal ? min(k_lim, max(q_end + s.tk - s.tq, 0)) : k_lim;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const long long row_base = (long long)bh * s.tq;

  load_rows(lse_s, lse, row_base, q0, s.tq, kTile);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    float part = 0.f;
    if (q0 + r < s.tq) {
      const T* orow = o + offset(vo, bi, hi, q0 + r);
      const T* drow = dout + offset(vdo, bi, hi, q0 + r);
      for (int c = tx; c < s.d; c += 16)
        part += to_f32(drow[c]) * to_f32(orow[c]);
    }
    const float total = row_sum(part);
    if (tx == 0) {
      delta_s[r] = total;
      if (q0 + r < s.tq && blockIdx.z == 0) delta[row_base + q0 + r] = total;
    }
  }
  float adq[4][kWideNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kWideNJ; ++j) adq[i][j] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    float sc[4][4], dp[4][4];
    wide_scores<T, 4, true>(sc, dp, qs, dos, ks, vs, q, dout, k, v, vq, vdo,
                            vk, vv, bi, hi, q0, k0, s);
    bwd_finish<T, 4>(sc, dp, lse_s, delta_s, nullptr, dss, s, q0, k0, k_lim);
    __syncthreads();  // ds written; the score chunks consumed
    load_tile(ks, kWideLd, k + c_out, vk, bi, hi, k0, s.tk, w_out);
    __syncthreads();
    const int kn = min(kTile, k_end - k0);
    for (int kc = 0; kc < kn; ++kc) {
      float kr[kWideNJ];
#pragma unroll
      for (int j = 0; j < kWideNJ; ++j) {
        const int c = tx + 16 * j;
        kr[j] = c < w_out ? ks[kc * kWideLd + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dss[(ty + 16 * i) * kLdP + kc];
#pragma unroll
        for (int j = 0; j < kWideNJ; ++j) adq[i][j] = fmaf(ds, kr[j], adq[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= s.tq) continue;
    T* qrow = dq + offset(vdq, bi, hi, r) + c_out;
#pragma unroll
    for (int j = 0; j < kWideNJ; ++j) {
      const int c = tx + 16 * j;
      if (c < w_out) qrow[c] = from_f32<T>(adq[i][j]);
    }
  }
}

// ------------------------------------- backward, bf16 on the tensor cores

// dK, dV. One block per (b*h, 64-key tile), summing over the live query
// tiles; a warp owns 16 key rows and keeps their dK and dV in registers.
// smem (bf16, rows tile_ld(d) apart): K, V, Q [2], dO [2]; then fp32
// lse * log2(e) [2][64] and delta [2][64] of the query tile of each stage
template <int DB>
__global__ void __launch_bounds__(kMmaThreads, DB == 4 ? 4 : 1)
    flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const int* __restrict__ kv_len,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, View vq,
                             View vk, View vv, View vdo, View vdk, View vdv,
                             Dims s) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int d = s.d;
  const int ld = tile_ld(d);
  const int nd = d / 16;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* vs = ks + kTile * ld;
  __nv_bfloat16* qs = vs + kTile * ld;       // two stages
  __nv_bfloat16* dos = qs + 2 * kTile * ld;  // two stages
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kTile * ld);
  float* delta_s = lse_s + 2 * kTile;
  const int bh = blockIdx.x;
  const int bi = bh / s.h;
  const int hi = bh - bi * s.h;
  const int k0 = blockIdx.y * kTile;
  const int k_lim = key_limit(s, kv_len, bi);
  const int off = s.tk - s.tq;  // the causal band's bottom-right offset
  // causal: query rows below k0 - off have no live pair
  const int q_first = s.causal ? max(k0 - off, 0) : 0;
  const int ntiles =
      k0 < k_lim && q_first < s.tq ? (s.tq - q_first + kTile - 1) / kTile : 0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tig = lane & 3;
  const int wrow = warp * 16;  // this warp's key rows of the tile
  const int krows[2] = {k0 + wrow + (lane >> 2), k0 + wrow + (lane >> 2) + 8};
  const float scale2 = s.scale * kLog2e;
  const long long row_base = (long long)bh * s.tq;

  float dka[2 * DB][4], dva[2 * DB][4];
#pragma unroll
  for (int i = 0; i < 2 * DB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  if (ntiles > 0) {
    const __nv_bfloat16* qsl = q + offset(vq, bi, hi, 0);
    const __nv_bfloat16* dsl = dout + offset(vdo, bi, hi, 0);
    load_tile_async(ks, ld, k + offset(vk, bi, hi, 0), vk.st, k0, s.tk, d,
                    kMmaThreads);
    load_tile_async(vs, ld, v + offset(vv, bi, hi, 0), vv.st, k0, s.tk, d,
                    kMmaThreads);
    load_tile_async(qs, ld, qsl, vq.st, q_first, s.tq, d, kMmaThreads);
    load_tile_async(dos, ld, dsl, vdo.st, q_first, s.tq, d, kMmaThreads);
    cp_async_commit();
    for (int j = 0; j < ntiles; ++j) {
      const int q0 = q_first + j * kTile;
      const int st = j & 1;
      {
        // this tile's lse (log2 domain) and delta; the stage was last read
        // two tiles ago, before the barrier that ended the last iteration
        const int t = threadIdx.x & (kTile - 1);
        const bool ok = q0 + t < s.tq;
        if (threadIdx.x < kTile)
          lse_s[st * kTile + t] = ok ? lse[row_base + q0 + t] * kLog2e : 0.f;
        else
          delta_s[st * kTile + t] = ok ? delta[row_base + q0 + t] : 0.f;
      }
      if (j + 1 < ntiles) {
        const int nx = (st ^ 1) * kTile * ld;
        load_tile_async(qs + nx, ld, qsl, vq.st, q0 + kTile, s.tq, d,
                        kMmaThreads);
        load_tile_async(dos + nx, ld, dsl, vdo.st, q0 + kTile, s.tq, d,
                        kMmaThreads);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // every thread's copies and rows of tile j landed
      const __nv_bfloat16* qt = qs + st * kTile * ld;
      const __nv_bfloat16* dt = dos + st * kTile * ld;
      const float* lt = lse_s + st * kTile;
      const float* dlt = delta_s + st * kTile;
      const int qn = min(kTile, s.tq - q0);  // query rows of the tile

      // a tile-wide condition: no mask touches this warp's key rows
      const bool full = k0 + wrow + 16 <= k_lim && q0 + kTile <= s.tq &&
                        (!s.causal || k0 + wrow + 15 <= q0 + off);
      // the tile's queries in two halves of 32, so the score fragments of
      // one half (32 registers each for s and dp) live beside dK and dV
#pragma unroll
      for (int qh = 0; qh < 2; ++qh) {
        const int qb = qh * 32;  // the half's first query of the tile
        if (qb >= qn) break;
        // s^T = K . Q^T and dp^T = V . dO^T: 16 key rows x 32 queries a
        // warp, 4 blocks of 8 queries; query blocks past Tq are left out
        float sacc[4][4], pacc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[i][e] = pacc[i][e] = 0.f;
#pragma unroll
        for (int kb = 0; kb < DB; ++kb) {
          if (kb < nd) {
            unsigned ka[4], va[4];
            ldmatrix_x4(ka, a_rows(ks, ld, wrow, kb * 16, lane));
            ldmatrix_x4(va, a_rows(vs, ld, wrow, kb * 16, lane));
#pragma unroll
            for (int np = 0; np < 2; ++np) {
              if (qb + np * 16 < qn) {
                unsigned bq[4], bd[4];
                ldmatrix_x4(bq, b_rows(qt, ld, qb + np * 16, kb * 16, lane));
                ldmatrix_x4(bd, b_rows(dt, ld, qb + np * 16, kb * 16, lane));
                mma_bf16(sacc[2 * np], ka, bq[0], bq[1]);
                mma_bf16(sacc[2 * np + 1], ka, bq[2], bq[3]);
                mma_bf16(pacc[2 * np], va, bd[0], bd[1]);
                mma_bf16(pacc[2 * np + 1], va, bd[2], bd[3]);
              }
            }
          }
        }

        // p^T = exp(s^T scale - lse) (0 where masked) into sacc, ds^T =
        // p^T (dp^T - delta) scale into pacc
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = qb + nb * 8 + tig * 2 + (e & 1);
            const int row = krows[e >> 1];
            const bool on = full || (q0 + c < s.tq && row < k_lim &&
                                     (!s.causal || row <= q0 + c + off));
            const float p =
                on ? fast_exp2(sacc[nb][e] * scale2 - lt[c]) : 0.f;
            sacc[nb][e] = p;
            pacc[nb][e] = p * (pacc[nb][e] - dlt[c]) * s.scale;
          }

        // dV += p^T . dO and dK += ds^T . Q, p^T and ds^T packed to bf16
        // as the A operands; dO and Q through ldmatrix.trans
#pragma unroll
        for (int kb = 0; kb < 2; ++kb) {
          if (qb + kb * 16 < qn) {
            unsigned pf[4], sf[4];
            pack_a(pf, sacc[2 * kb], sacc[2 * kb + 1]);
            pack_a(sf, pacc[2 * kb], pacc[2 * kb + 1]);
#pragma unroll
            for (int dp = 0; dp < DB; ++dp) {
              if (dp < nd) {
                unsigned bd[4], bq[4];
                ldmatrix_x4_trans(
                    bd, b_trans(dt, ld, qb + kb * 16, dp * 16, lane));
                ldmatrix_x4_trans(
                    bq, b_trans(qt, ld, qb + kb * 16, dp * 16, lane));
                mma_bf16(dva[2 * dp], pf, bd[0], bd[1]);
                mma_bf16(dva[2 * dp + 1], pf, bd[2], bd[3]);
                mma_bf16(dka[2 * dp], sf, bq[0], bq[1]);
                mma_bf16(dka[2 * dp + 1], sf, bq[2], bq[3]);
              }
            }
          }
        }
      }
      __syncthreads();  // this stage may be overwritten two tiles on
    }
  }

  // rows with no live key add dO / Tk to every key's dV (p rounded to
  // bf16 as the live p is), through the Q stages, free now (the loop ended
  // on a barrier)
  const int ndead = dead_rows(s, k_lim);
  if (ndead > 0) {
    float* dsum = reinterpret_cast<float*>(qs);
    sum_rows(dsum, dout + offset(vdo, bi, hi, 0), vdo.st, ndead,
             round_as<__nv_bfloat16>(1.f / s.tk), d, kMmaThreads);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2 * DB; ++i)
      if (i < d / 8)
#pragma unroll
        for (int e = 0; e < 4; ++e) dva[i][e] += dsum[i * 8 + tig * 2 + (e & 1)];
  }

  // dK through the warp's own K rows, dV through its V rows (a block past
  // kv_len writes zeros, or the dead rows' share)
  store_rows<DB>(ks, ld, dka, wrow, dk, vdk, bi, hi, k0, s.tk, d, lane);
  store_rows<DB>(vs, ld, dva, wrow, dv, vdv, bi, hi, k0, s.tk, d, lane);
}

// dQ, and delta. One block per (b*h, 64-query tile), summing over the live
// key tiles; a warp owns 16 query rows and keeps their dQ in registers.
// Before the loop it computes delta = rowsum(dO * O) of its rows in fp32
// and writes it for the dK/dV kernel, which runs after it on the stream.
// smem (bf16, rows tile_ld(d) apart): Q, dO, K [2], V [2]
template <int DB>
__global__ void __launch_bounds__(kMmaThreads, DB == 4 ? 4 : 1)
    flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const __nv_bfloat16* __restrict__ o,
                            const float* __restrict__ lse,
                            float* __restrict__ delta,
                            const int* __restrict__ kv_len,
                            __nv_bfloat16* __restrict__ dq, View vq, View vk,
                            View vv, View vdo, View vo, View vdq, Dims s) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int d = s.d;
  const int ld = tile_ld(d);
  const int nd = d / 16;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* dos = qs + kTile * ld;
  __nv_bfloat16* ks = dos + kTile * ld;     // two stages
  __nv_bfloat16* vs = ks + 2 * kTile * ld;  // two stages
  const int bh = blockIdx.x;
  const int bi = bh / s.h;
  const int hi = bh - bi * s.h;
  const int q0 = blockIdx.y * kTile;
  const int q_end = min(q0 + kTile, s.tq);
  const int k_lim = key_limit(s, kv_len, bi);
  const int off = s.tk - s.tq;  // the causal band's bottom-right offset
  const int k_end = s.causal ? min(k_lim, max(q_end + off, 0)) : k_lim;
  const int ntiles = (k_end + kTile - 1) / kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wrow = warp * 16;  // this warp's query rows of the tile
  const int rows[2] = {q0 + wrow + gid, q0 + wrow + gid + 8};
  int lims[2];  // keys [0, lims[hf]) are live for row rows[hf]
  float lse2[2];
  const long long row_base = (long long)bh * s.tq;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    lims[hf] = row_limit(s, k_lim, rows[hf]);
    lse2[hf] = rows[hf] < s.tq ? lse[row_base + rows[hf]] * kLog2e : 0.f;
  }
  const float scale2 = s.scale * kLog2e;
  const __nv_bfloat16* ksl = k + offset(vk, bi, hi, 0);
  const __nv_bfloat16* vsl = v + offset(vv, bi, hi, 0);

  load_tile_async(qs, ld, q + offset(vq, bi, hi, 0), vq.st, q0, s.tq, d,
                  kMmaThreads);
  load_tile_async(dos, ld, dout + offset(vdo, bi, hi, 0), vdo.st, q0, s.tq,
                  d, kMmaThreads);
  cp_async_commit();
  if (ntiles > 0) {
    load_tile_async(ks, ld, ksl, vk.st, 0, s.tk, d, kMmaThreads);
    load_tile_async(vs, ld, vsl, vv.st, 0, s.tk, d, kMmaThreads);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();  // Q and dO landed

  // delta of the warp's 16 rows: lanes 2r and 2r + 1 each sum half of row
  // r's products in fp32 (O read from global, dO from shared memory), one
  // shuffle adds the halves. Every row below Tq is written, also a row with
  // no live key (the dK/dV kernel multiplies its delta by p = 0).
  float dl[2];
  {
    const int r = lane >> 1;
    const int half = lane & 1;
    const int row = q0 + wrow + r;
    const int per = d / 16;  // 8-element chunks a lane
    float part = 0.f;
    if (row < s.tq) {
      const __nv_bfloat16* orow = o + offset(vo, bi, hi, row);
      for (int cc = 0; cc < per; ++cc) {
        const int c = (half * per + cc) * 8;
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 gv =
            *reinterpret_cast<const uint4*>(dos + (wrow + r) * ld + c);
        const __nv_bfloat16* oe = reinterpret_cast<const __nv_bfloat16*>(&ov);
        const __nv_bfloat16* ge = reinterpret_cast<const __nv_bfloat16*>(&gv);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          part += __bfloat162float(ge[e]) * __bfloat162float(oe[e]);
      }
    }
    const float total = part + __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0 && row < s.tq) delta[row_base + row] = total;
    dl[0] = __shfl_sync(0xffffffffu, total, 2 * gid);
    dl[1] = __shfl_sync(0xffffffffu, total, 2 * gid + 16);
  }

  float dqa[2 * DB][4];
#pragma unroll
  for (int i = 0; i < 2 * DB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[i][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * kTile;
    if (j + 1 < ntiles) {
      // the other stage was consumed before the barrier that ended the
      // last iteration
      const int nx = ((j + 1) & 1) * kTile * ld;
      load_tile_async(ks + nx, ld, ksl, vk.st, k0 + kTile, s.tk, d,
                      kMmaThreads);
      load_tile_async(vs + nx, ld, vsl, vv.st, k0 + kTile, s.tk, d,
                      kMmaThreads);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of tile j have landed
    const __nv_bfloat16* kt = ks + (j & 1) * kTile * ld;
    const __nv_bfloat16* vt = vs + (j & 1) * kTile * ld;
    const int kn = min(kTile, k_end - k0);  // keys with a live row

    // s = Q . K^T and dp = dO . V^T: 16 query rows x 64 keys a warp
    float sacc[8][4], pacc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[i][e] = pacc[i][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < DB; ++kb) {
      if (kb < nd) {
        unsigned qa[4], da[4];
        ldmatrix_x4(qa, a_rows(qs, ld, wrow, kb * 16, lane));
        ldmatrix_x4(da, a_rows(dos, ld, wrow, kb * 16, lane));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np * 16 < kn) {
            unsigned bk[4], bv[4];
            ldmatrix_x4(bk, b_rows(kt, ld, np * 16, kb * 16, lane));
            ldmatrix_x4(bv, b_rows(vt, ld, np * 16, kb * 16, lane));
            mma_bf16(sacc[2 * np], qa, bk[0], bk[1]);
            mma_bf16(sacc[2 * np + 1], qa, bk[2], bk[3]);
            mma_bf16(pacc[2 * np], da, bv[0], bv[1]);
            mma_bf16(pacc[2 * np + 1], da, bv[2], bv[3]);
          }
        }
      }
    }

    // ds = p (dp - delta) scale into pacc, p = exp(s scale - lse), 0 where
    // masked; a tile no mask touches for this warp's rows skips the mask
    const bool full = k0 + kTile <= k_lim && q0 + wrow + 16 <= s.tq &&
                      (!s.causal || k0 + kTile - 1 <= q0 + wrow + off);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        const int col = k0 + nb * 8 + tig * 2 + (e & 1);
        const float p = full || col < lims[hf]
                            ? fast_exp2(sacc[nb][e] * scale2 - lse2[hf])
                            : 0.f;
        pacc[nb][e] = p * (pacc[nb][e] - dl[hf]) * s.scale;
      }

    // dQ += ds . K, ds packed to bf16 as the A operand, K through
    // ldmatrix.trans; key blocks with no live key are left out
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      if (kb * 16 < kn) {
        unsigned sf[4];
        pack_a(sf, pacc[2 * kb], pacc[2 * kb + 1]);
#pragma unroll
        for (int dp = 0; dp < DB; ++dp) {
          if (dp < nd) {
            unsigned bk[4];
            ldmatrix_x4_trans(bk, b_trans(kt, ld, kb * 16, dp * 16, lane));
            mma_bf16(dqa[2 * dp], sf, bk[0], bk[1]);
            mma_bf16(dqa[2 * dp + 1], sf, bk[2], bk[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage may be overwritten two tiles on
  }

  // dQ through the warp's own Q rows
  store_rows<DB>(qs, ld, dqa, wrow, dq, vdq, bi, hi, q0, s.tq, d, lane);
}

// dynamic shared memory of each kernel, bytes
inline size_t fwd_smem(int d) {
  return sizeof(float) * (size_t)(2 * kTile * (d + 1) + kTile * d +
                                  kTile * kLdP);
}
// the SIMT backward kernels walk query tiles of 32 rows above D = 128
inline int bwd_qtile(int d) { return d > 128 ? 32 : kTile; }
inline size_t dkv_smem(int d) {
  const int qt = bwd_qtile(d);
  return sizeof(float) * (size_t)(2 * (qt + kTile) * (d + 1) +
                                  2 * qt * kLdP + 2 * qt);
}
inline size_t dq_smem(int d) {
  const int qt = bwd_qtile(d);
  return sizeof(float) *
         (size_t)(2 * (qt + kTile) * (d + 1) + qt * kLdP + 2 * qt);
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

// What a launcher writes to `launched`: the kernel it put on the stream.
// Nothing is written where nothing is launched (an empty grid).
constexpr int kLaunchedSimt = 1;
constexpr int kLaunchedMma = 2;

template <typename T, int NJ, int QI>
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

// The tensor-core kernels take bf16 with a head dim that is a multiple of
// 16 up to 128 and, for their 16-byte copies, loads and stores, strides and
// base pointers (of every tensor the kernel reads or writes through 16-byte
// accesses) that are multiples of 8 elements.
inline bool use_mma(int dtype, int d, const long long* strides, int n_views,
                    const void* const* ptrs) {
  if (dtype != kBFloat16 || d < 16 || d > 128 || d % 16 != 0) return false;
  for (int i = 0; i < 3 * n_views; ++i)
    if (strides[i] % 8 != 0) return false;
  for (int i = 0; i < n_views; ++i)
    if (reinterpret_cast<size_t>(ptrs[i]) % 16 != 0) return false;
  return true;
}

inline size_t mma_smem(int d) {
  return sizeof(__nv_bfloat16) * (size_t)(5 * kTile * tile_ld(d));
}

// both tensor-core backward kernels: six bf16 tiles; the dK/dV kernel's
// two stages of lse and delta after them
inline size_t bwd_mma_smem(int d) {
  return sizeof(__nv_bfloat16) * (size_t)(6 * kTile * tile_ld(d)) +
         sizeof(float) * (size_t)(4 * kTile);
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

template <typename T, int NJ, int QI>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       const void* kv_len, void* dk, void* dv,
                       const long long* strides, int* launched,
                       const Dims& s, cudaStream_t stream) {
  static bool done = false;
  auto kernel = flash_bwd_dkv_kernel<T, NJ, QI>;
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
  *launched = kLaunchedSimt;
  return cudaGetLastError();
}

template <typename T, int NJ, int QI>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* o, const void* lse,
                      void* delta, const void* kv_len, void* dq,
                      const long long* strides, int* launched, const Dims& s,
                      cudaStream_t stream) {
  static bool done = false;
  auto kernel = flash_bwd_dq_kernel<T, NJ, QI>;
  cudaError_t err = allow_smem(kernel, dq_smem(16 * NJ), &done);
  if (err != cudaSuccess) return err;
  const dim3 grid(s.b * s.h, (s.tq + 16 * QI - 1) / (16 * QI));
  if (grid.x == 0 || grid.y == 0) return cudaSuccess;
  kernel<<<grid, kFlashThreads, dq_smem(s.d), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const T*>(o), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<const int*>(kv_len),
      static_cast<T*>(dq), view_at(strides, 0), view_at(strides, 1),
      view_at(strides, 2), view_at(strides, 3), view_at(strides, 4),
      view_at(strides, 5), s);
  *launched = kLaunchedSimt;
  return cudaGetLastError();
}

template <int DB>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, const void* kv_len, void* dk,
                           void* dv, const long long* strides, int* launched,
                           const Dims& s, cudaStream_t stream) {
  static bool done = false;
  auto kernel = flash_bwd_dkv_mma_kernel<DB>;
  cudaError_t err = allow_smem(kernel, bwd_mma_smem(16 * DB), &done);
  if (err != cudaSuccess) return err;
  const dim3 grid(s.b * s.h, (s.tk + kTile - 1) / kTile);
  if (grid.x == 0 || grid.y == 0) return cudaSuccess;
  using B = __nv_bfloat16;
  kernel<<<grid, kMmaThreads, bwd_mma_smem(s.d), stream>>>(
      static_cast<const B*>(q), static_cast<const B*>(k),
      static_cast<const B*>(v), static_cast<const B*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<B*>(dk),
      static_cast<B*>(dv), view_at(strides, 0), view_at(strides, 1),
      view_at(strides, 2), view_at(strides, 3), view_at(strides, 4),
      view_at(strides, 5), s);
  *launched = kLaunchedMma;
  return cudaGetLastError();
}

template <int DB>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v,
                          const void* dout, const void* o, const void* lse,
                          void* delta, const void* kv_len, void* dq,
                          const long long* strides, int* launched,
                          const Dims& s, cudaStream_t stream) {
  static bool done = false;
  auto kernel = flash_bwd_dq_mma_kernel<DB>;
  cudaError_t err = allow_smem(kernel, bwd_mma_smem(16 * DB), &done);
  if (err != cudaSuccess) return err;
  const dim3 grid(s.b * s.h, (s.tq + kTile - 1) / kTile);
  if (grid.x == 0 || grid.y == 0) return cudaSuccess;
  using B = __nv_bfloat16;
  kernel<<<grid, kMmaThreads, bwd_mma_smem(s.d), stream>>>(
      static_cast<const B*>(q), static_cast<const B*>(k),
      static_cast<const B*>(v), static_cast<const B*>(dout),
      static_cast<const B*>(o), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<const int*>(kv_len),
      static_cast<B*>(dq), view_at(strides, 0), view_at(strides, 1),
      view_at(strides, 2), view_at(strides, 3), view_at(strides, 4),
      view_at(strides, 5), s);
  *launched = kLaunchedMma;
  return cudaGetLastError();
}

// the largest head dim of the SIMT kernels (the tensor-core ones: 128);
// the wide kernels take every head dim above it
constexpr int kMaxHeadDim = 256;

inline size_t fwd_wide_smem() {
  return sizeof(float) *
         (size_t)(2 * kTile * kWideLd + kTile * kWideCols + kTile * kLdP);
}
inline size_t dkv_wide_smem() {
  return sizeof(float) *
         (size_t)(4 * kTile * kWideLd + 2 * kTile * kLdP + 2 * kTile);
}
inline size_t dq_wide_smem() {
  return sizeof(float) *
         (size_t)(4 * kTile * kWideLd + kTile * kLdP + 2 * kTile);
}

inline dim3 wide_grid(const Dims& s, int t) {
  return dim3(s.b * s.h, (t + kTile - 1) / kTile,
              (s.d + kWideCols - 1) / kWideCols);
}

template <typename T>
cudaError_t launch_fwd_wide(const void* q, const void* k, const void* v,
                            void* o, void* lse, const void* kv_len,
                            const long long* strides, int* launched,
                            const Dims& s, cudaStream_t stream) {
  static bool done = false;
  auto kernel = flash_fwd_wide_kernel<T>;
  cudaError_t err = allow_smem(kernel, fwd_wide_smem(), &done);
  if (err != cudaSuccess) return err;
  const dim3 grid = wide_grid(s, s.tq);
  if (grid.x == 0 || grid.y == 0) return cudaSuccess;
  kernel<<<grid, kFlashThreads, fwd_wide_smem(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      static_cast<const int*>(kv_len), view_at(strides, 0),
      view_at(strides, 1), view_at(strides, 2), view_at(strides, 3), s);
  *launched = kLaunchedSimt;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv_wide(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* kv_len, void* dk,
                            void* dv, const long long* strides, int* launched,
                            const Dims& s, cudaStream_t stream) {
  static bool done = false;
  auto kernel = flash_bwd_dkv_wide_kernel<T>;
  cudaError_t err = allow_smem(kernel, dkv_wide_smem(), &done);
  if (err != cudaSuccess) return err;
  const dim3 grid = wide_grid(s, s.tk);
  if (grid.x == 0 || grid.y == 0) return cudaSuccess;
  kernel<<<grid, kFlashThreads, dkv_wide_smem(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<T*>(dk),
      static_cast<T*>(dv), view_at(strides, 0), view_at(strides, 1),
      view_at(strides, 2), view_at(strides, 3), view_at(strides, 4),
      view_at(strides, 5), s);
  *launched = kLaunchedSimt;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq_wide(const void* q, const void* k, const void* v,
                           const void* dout, const void* o, const void* lse,
                           void* delta, const void* kv_len, void* dq,
                           const long long* strides, int* launched,
                           const Dims& s, cudaStream_t stream) {
  static bool done = false;
  auto kernel = flash_bwd_dq_wide_kernel<T>;
  cudaError_t err = allow_smem(kernel, dq_wide_smem(), &done);
  if (err != cudaSuccess) return err;
  const dim3 grid = wide_grid(s, s.tq);
  if (grid.x == 0 || grid.y == 0) return cudaSuccess;
  kernel<<<grid, kFlashThreads, dq_wide_smem(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const T*>(o), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<const int*>(kv_len),
      static_cast<T*>(dq), view_at(strides, 0), view_at(strides, 1),
      view_at(strides, 2), view_at(strides, 3), view_at(strides, 4),
      view_at(strides, 5), s);
  *launched = kLaunchedSimt;
  return cudaGetLastError();
}

inline bool valid(const Dims& s, int dtype) {
  return s.d >= 1 && s.b >= 0 && s.h >= 1 && s.tq >= 0 && s.tk >= 0 &&
         (dtype == kFloat32 || dtype == kBFloat16);
}

}  // namespace ptt

// The launchers share one contract. q, k, v, dO, O and every output are
// [B, H, T, D] with D contiguous and the (b, h, t) strides, in elements, in
// `strides` (three per tensor, in the order the tensors are passed); lse
// and delta are [B*H, Tq] contiguous fp32; kv_len is [B] int32 or null;
// dtype 0 is fp32, 1 is bf16 (all of q, k, v, dO, O and the outputs);
// any D (above 256 the wide kernels); any Tq and Tk, causal aligned
// bottom-right. Each returns the CUDA error of its
// launch (cudaGetLastError()) and sets *launched to the kernel it launched:
// 0 none (an empty grid or an error before the launch), 1 the SIMT kernel,
// 2 the tensor-core kernel. ptt_flash_bwd_dq writes delta = rowsum(dO * O)
// (fp32); ptt_flash_bwd_dkv reads it, so it is launched after dQ on the
// same stream.
// (16-column groups of the head dim a thread holds, and query rows / 16 of
// the backward's tile: 32 rows above D = 128, for shared memory)
#define PTT_DISPATCH_T(T, LAUNCH, ...)                             \
  (s.d <= 64    ? ptt::LAUNCH<T, 4, 4>(__VA_ARGS__, s, st)         \
   : s.d <= 128 ? ptt::LAUNCH<T, 8, 4>(__VA_ARGS__, s, st)         \
                : ptt::LAUNCH<T, 16, 2>(__VA_ARGS__, s, st))
#define PTT_DISPATCH(LAUNCH, ...)                                         \
  do {                                                                    \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                  \
    if (s.d > ptt::kMaxHeadDim)                                           \
      return (int)(dtype == ptt::kFloat32                                 \
                       ? ptt::LAUNCH##_wide<float>(__VA_ARGS__, s, st)    \
                       : ptt::LAUNCH##_wide<__nv_bfloat16>(__VA_ARGS__, s, \
                                                           st));          \
    return (int)(dtype == ptt::kFloat32                                   \
                     ? PTT_DISPATCH_T(float, LAUNCH, __VA_ARGS__)         \
                     : PTT_DISPATCH_T(__nv_bfloat16, LAUNCH, __VA_ARGS__)); \
  } while (0)

// the same for the tensor-core kernels, templated on the head dim's blocks
#define PTT_DISPATCH_MMA(LAUNCH, ...)                                     \
  do {                                                                    \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                  \
    return (int)(s.d <= 64 ? ptt::LAUNCH<4>(__VA_ARGS__, s, st)           \
                           : ptt::LAUNCH<8>(__VA_ARGS__, s, st));         \
  } while (0)

extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, const void* kv_len,
                             const long long* strides, int b, int h, int tq,
                             int tk, int d, int causal, float scale,
                             int dtype, int* launched, void* stream) {
  const ptt::Dims s{b, h, tq, tk, d, causal, scale};
  *launched = 0;
  if (!ptt::valid(s, dtype)) return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, o};
  if (ptt::use_mma(dtype, d, strides, 4, ptrs))
    PTT_DISPATCH_MMA(launch_fwd_mma, q, k, v, o, lse, kv_len, strides,
                     launched);
  PTT_DISPATCH(launch_fwd, q, k, v, o, lse, kv_len, strides, launched);
}

// strides: q, k, v, dO, dK, dV
extern "C" int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* kv_len,
                                 void* dk, void* dv, const long long* strides,
                                 int b, int h, int tq, int tk, int d,
                                 int causal, float scale, int dtype,
                                 int* launched, void* stream) {
  const ptt::Dims s{b, h, tq, tk, d, causal, scale};
  *launched = 0;
  if (!ptt::valid(s, dtype)) return (int)cudaErrorInvalidValue;
  const void* ptrs[6] = {q, k, v, dout, dk, dv};
  if (ptt::use_mma(dtype, d, strides, 6, ptrs))
    PTT_DISPATCH_MMA(launch_dkv_mma, q, k, v, dout, lse, delta, kv_len, dk,
                     dv, strides, launched);
  PTT_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, kv_len, dk, dv,
               strides, launched);
}

// strides: q, k, v, dO, O, dQ
extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* o,
                                const void* lse, void* delta,
                                const void* kv_len, void* dq,
                                const long long* strides, int b, int h,
                                int tq, int tk, int d, int causal,
                                float scale, int dtype, int* launched,
                                void* stream) {
  const ptt::Dims s{b, h, tq, tk, d, causal, scale};
  *launched = 0;
  if (!ptt::valid(s, dtype)) return (int)cudaErrorInvalidValue;
  const void* ptrs[6] = {q, k, v, dout, o, dq};
  if (ptt::use_mma(dtype, d, strides, 6, ptrs))
    PTT_DISPATCH_MMA(launch_dq_mma, q, k, v, dout, o, lse, delta, kv_len, dq,
                     strides, launched);
  PTT_DISPATCH(launch_dq, q, k, v, dout, o, lse, delta, kv_len, dq, strides,
               launched);
}

// dynamic shared memory, bytes, of kernel 0 (SIMT forward), 1 (SIMT dK/dV),
// 2 (SIMT dQ), 3 (tensor-core forward) or 4 (either tensor-core backward
// kernel) at head dim d
extern "C" int ptt_flash_smem_bytes(int kernel, int d) {
  if (kernel == 4) return static_cast<int>(ptt::bwd_mma_smem(d));
  if (kernel == 3) return static_cast<int>(ptt::mma_smem(d));
  if (kernel == 0) return static_cast<int>(ptt::fwd_smem(d));
  if (kernel == 1) return static_cast<int>(ptt::dkv_smem(d));
  return static_cast<int>(ptt::dq_smem(d));
}
