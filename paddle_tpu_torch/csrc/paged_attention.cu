// Ragged paged attention: one query per (row, head) against that row's KV
// cache, found page by page through its block table.
//
// Replaces the TPU kernel _paged_kernel / _paged_pallas in
// paddle_tpu/ops/pallas/paged_attention.py (K4).
//
// Bound on an H100: bytes. Each live K/V element is read once and used for
// two flops (one multiply-add against q or p), so the kernel sits far below
// the card's compute roof. At the decode shape (16 rows, 8 heads, head dim
// 64, fp32 pages, 576 live tokens a row) one call must read
// 16*8*576*128*4 B = 37.7 MB, about 11 us at 3.35 TB/s.
//
// Design: one 128-thread block per (row, head); grid (H, N). The block
// reads its own length and table row (the row stride may be 0, so the
// prefill's one table broadcast to all S rows needs no copy), clamps each
// table entry to [0, NB-1] as the reference does, and walks pages
// 0 .. min(ceil(len/bs), P)-1 only: pages at or past len are never read.
// Each page's bs x D K tile (rows padded by one float against bank
// conflicts) and bs x Dv V tile are staged in shared memory as fp32; thread
// j < bs scores key j, and the block runs the fp32 online softmax of the
// Pallas kernel: masked columns get -1e9, p = exp(s - m) is rounded to the
// page dtype before p.v (the reference's p.astype(v.dtype)), the running
// sum and the accumulator stay fp32, and a row that read no page divides
// by 1. The output is fp32 (q's dtype). Scale is applied to q, as in
// paged_attention_reference.
//
// Left for later: overlapping the next page's load with this page's math
// (cp.async or TMA with an mbarrier ring), 16-byte vector loads, splitting
// a long row across blocks (a second reduction pass), several heads per
// block to share the table walk, and wgmma for the prefill's many rows.

#include "common.cuh"

namespace ptt {

constexpr int kPagedThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kPagedThreads)
    paged_attention_kernel(const float* __restrict__ q,
                           const T* __restrict__ k_pages,
                           const T* __restrict__ v_pages,
                           const int* __restrict__ tables,
                           long long table_stride,
                           const int* __restrict__ lens,
                           float* __restrict__ out, int h, int nb, int bs,
                           int d, int dv, int p, float scale) {
  extern __shared__ float smem[];
  const int head = blockIdx.x;
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const int ks_stride = d + 1;
  float* qs = smem;                 // [d]
  float* ks = qs + d;               // [bs, d + 1]
  float* vs = ks + bs * ks_stride;  // [bs, dv]
  float* ps = vs + bs * dv;         // [bs]

  const size_t qrow = (size_t)row * h + head;
  for (int i = tid; i < d; i += kPagedThreads) qs[i] = q[qrow * d + i] * scale;

  const int len = lens[row];
  int npages = len > 0 ? (len + bs - 1) / bs : 0;
  if (npages > p) npages = p;
  const int* trow = tables + (size_t)row * table_stride;

  float m = -1e9f;  // running max
  float l = 0.f;    // running sum of exp
  float acc = 0.f;  // output element tid (tid < dv)
  for (int pi = 0; pi < npages; ++pi) {
    int phys = trow[pi];
    phys = phys < 0 ? 0 : (phys > nb - 1 ? nb - 1 : phys);
    const size_t tile = ((size_t)phys * h + head) * bs;
    const T* kt = k_pages + tile * d;
    const T* vt = v_pages + tile * dv;
    __syncthreads();  // last page's tiles and ps consumed; qs visible
    for (int i = tid; i < bs * d; i += kPagedThreads)
      ks[(i / d) * ks_stride + i % d] = to_f32(kt[i]);
    for (int i = tid; i < bs * dv; i += kPagedThreads) vs[i] = to_f32(vt[i]);
    __syncthreads();
    if (tid < bs) {
      const float* kr = ks + tid * ks_stride;
      float s = 0.f;
      for (int c = 0; c < d; ++c) s += qs[c] * kr[c];
      ps[tid] = pi * bs + tid < len ? s : -1e9f;
    }
    __syncthreads();
    float mcur = -1e9f;
    for (int j = 0; j < bs; ++j) mcur = fmaxf(mcur, ps[j]);
    const float mnext = fmaxf(m, mcur);
    const float alpha = expf(m - mnext);
    __syncthreads();  // every thread has read the raw scores
    if (tid < bs) ps[tid] = expf(ps[tid] - mnext);
    __syncthreads();
    float lcur = 0.f;
    float pv = 0.f;
    for (int j = 0; j < bs; ++j) {
      lcur += ps[j];
      if (tid < dv) pv += round_as<T>(ps[j]) * vs[j * dv + tid];
    }
    l = alpha * l + lcur;
    acc = acc * alpha + pv;
    m = mnext;
  }
  if (tid < dv) out[qrow * dv + tid] = acc / (l == 0.f ? 1.f : l);
}

}  // namespace ptt

// q: [n, h, d] fp32; k_pages: [nb, h, bs, d], v_pages: [nb, h, bs, dv], fp32
// (dtype 0) or bf16 (dtype 1); tables: int32, row r at tables +
// r * table_stride, p entries; lens: [n] int32; out: [n, h, dv] fp32. The
// caller guarantees bs <= 128, dv <= 128 and the shared-memory size
// ptt_paged_attention_smem_bytes() <= 48 KB. Returns cudaGetLastError().
extern "C" int ptt_paged_attention_smem_bytes(int bs, int d, int dv) {
  return static_cast<int>(sizeof(float)) * (d + bs * (d + 1) + bs * dv + bs);
}

extern "C" int ptt_paged_attention(const void* q, const void* k_pages,
                                   const void* v_pages, const void* tables,
                                   long long table_stride, const void* lens,
                                   void* out, int n, int h, int nb, int bs,
                                   int d, int dv, int p, float scale,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(h, n);
  const size_t smem = ptt_paged_attention_smem_bytes(bs, d, dv);
  const float* qf = static_cast<const float*>(q);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lens);
  float* o = static_cast<float*>(out);
  if (dtype == ptt::kFloat32) {
    ptt::paged_attention_kernel<float><<<grid, ptt::kPagedThreads, smem, s>>>(
        qf, static_cast<const float*>(k_pages),
        static_cast<const float*>(v_pages), tb, table_stride, ln, o, h, nb, bs,
        d, dv, p, scale);
  } else if (dtype == ptt::kBFloat16) {
    ptt::paged_attention_kernel<__nv_bfloat16>
        <<<grid, ptt::kPagedThreads, smem, s>>>(
            qf, static_cast<const __nv_bfloat16*>(k_pages),
            static_cast<const __nv_bfloat16*>(v_pages), tb, table_stride, ln,
            o, h, nb, bs, d, dv, p, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
