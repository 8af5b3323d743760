// Tile geometry, masks, asynchronous tile loads and tensor-core fragment
// helpers shared by the flash-attention kernels (flash_attention.cu): the
// bf16 tensor-core forward and both tensor-core backward kernels use all of
// them; the SIMT kernels share the geometry and masks.
#pragma once

#include "common.cuh"

namespace ptt {

constexpr int kTile = 64;  // query rows and key columns per tile
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;  // scores in the log2 domain

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

// ---------------------------------------------- bf16 tiles in shared memory
// A [64][d] bf16 tile keeps its rows d + 8 elements apart: the 16 bytes of
// padding make a row an odd number of 16-byte chunks, so the eight row
// addresses of one ldmatrix 8x8 block fall into eight different bank groups
// (no conflicts) for every d that is a multiple of 16.
__host__ __device__ inline int tile_ld(int d) { return d + 8; }

// 16 bytes global -> shared, asynchronously; with ok false nothing is read
// and the 16 bytes are zero-filled (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [t0, t0 + 64) of one (b, h) slice, `slice` pointing at its row 0 and
// rows `st` elements apart, into dst[64][ld] with 16-byte cp.async started by
// all `threads` threads of the block; rows at or past t_end are zero-filled.
// d is a multiple of 8 and every row address a multiple of 16 bytes. The
// caller commits the group and waits for it.
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, int ld,
                                                const __nv_bfloat16* slice,
                                                long long st, int t0,
                                                int t_end, int d,
                                                int threads) {
  const int chunks = d / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < kTile * chunks; i += threads) {
    const int r = i / chunks;
    const int c = i - r * chunks;
    const int t = t0 + r;
    const bool ok = t < t_end;
    cp_async16(dst + r * ld + c * 8, ok ? slice + t * st + c * 8 : slice, ok);
  }
}

// ------------------------------------------------- tensor-core fragments
// mma.sync.m16n8k16, bf16 inputs, fp32 accumulation. With lane = 4 * gid +
// tig: A (16 x 16, row-major) holds a0 = (row gid, cols 2 tig, 2 tig + 1),
// a1 = (row gid + 8, same cols), a2 = a0's cols + 8, a3 = a1's cols + 8;
// B (16 x 8, "col") holds b0 = (k 2 tig, 2 tig + 1; n gid), b1 = k + 8;
// C (16 x 8) holds c0, c1 = (row gid, cols 2 tig, 2 tig + 1), c2, c3 =
// (row gid + 8, same cols). So two neighbouring C blocks, packed to bf16
// pairs, are the A operand of the next product.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 blocks from shared memory: lane i gives the address of row
// i % 8 of block i / 8; register k of lane 4 * gid + tig then holds block
// k's (row gid, cols 2 tig, 2 tig + 1).
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same with each block transposed: register k holds block k's (rows
// 2 tig, 2 tig + 1; col gid), which is the B operand of a product whose k
// index runs down the rows of shared memory (V in p . v).
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 2^x by the special-function unit (about 2 ulp; 0 for very negative x)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// ldmatrix row addresses into a bf16 tile `t` (rows `ld` apart) for lane
// `lane`. a_rows: the A operand of rows r0..r0 + 15, columns c0..c0 + 15.
__device__ __forceinline__ const __nv_bfloat16* a_rows(
    const __nv_bfloat16* t, int ld, int r0, int c0, int lane) {
  return t + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + c0 +
         (lane >> 4) * 8;
}
// b_rows: the B operands of a product whose n index runs down the rows
// (n0..n0 + 15; registers 0, 1 for n0.., 2, 3 for n0 + 8..), k over the
// columns c0..c0 + 15
__device__ __forceinline__ const __nv_bfloat16* b_rows(
    const __nv_bfloat16* t, int ld, int n0, int c0, int lane) {
  return t + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + c0 +
         ((lane >> 3) & 1) * 8;
}
// b_trans (for ldmatrix.trans): the B operands of a product whose k index
// runs down the rows (k0..k0 + 15), n over the columns c0..c0 + 15
// (registers 0, 1 for c0.., 2, 3 for c0 + 8..)
__device__ __forceinline__ const __nv_bfloat16* b_trans(
    const __nv_bfloat16* t, int ld, int k0, int c0, int lane) {
  return a_rows(t, ld, k0, c0, lane);
}

// Two neighbouring C blocks (16 x 8 each, fp32) as the bf16 A operand
// (16 x 16) of the next product: the reference's rounding to the input dtype
__device__ __forceinline__ void pack_a(unsigned (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// A warp's 16 rows of fp32 accumulators (16 x d, C blocks of 8 columns) to
// bf16 rows t0 + wrow.. of `out`, through the warp's own rows [wrow,
// wrow + 16) of the staging tile `st` (no other warp reads them) and 16-byte
// stores; rows at or past t_end are not stored
template <int DB>
__device__ __forceinline__ void store_rows(__nv_bfloat16* st, int ld,
                                           const float (&acc)[2 * DB][4],
                                           int wrow, __nv_bfloat16* out,
                                           const View& v, int bi, int hi,
                                           int t0, int t_end, int d,
                                           int lane) {
  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int i = 0; i < 2 * DB; ++i) {
    if (i < d / 8) {
      const int col = i * 8 + tig * 2;
      *reinterpret_cast<unsigned*>(st + (wrow + gid) * ld + col) =
          pack_bf16(acc[i][0], acc[i][1]);
      *reinterpret_cast<unsigned*>(st + (wrow + gid + 8) * ld + col) =
          pack_bf16(acc[i][2], acc[i][3]);
    }
  }
  __syncwarp();
  const int chunks = d / 8;
  for (int i = lane; i < 16 * chunks; i += 32) {
    const int r = i / chunks;
    const int c = i - r * chunks;
    const int t = t0 + wrow + r;
    if (t < t_end)
      *reinterpret_cast<uint4*>(out + offset(v, bi, hi, t) + c * 8) =
          *reinterpret_cast<const uint4*>(st + (wrow + r) * ld + c * 8);
  }
}

}  // namespace ptt
