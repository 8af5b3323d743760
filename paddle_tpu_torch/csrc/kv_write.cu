// The KV write of the paged decode ops: one layer's new K and V rows into
// the page arenas, every row whose keep bit is set, the others dropped.
//
// It has no Pallas counterpart: it is the port's form of the reference's
// dropping scatter, paddle_tpu/ops/paged_decode_ops.py _write_positions /
// _write_scales (`.at[phys, head, off].set(new, mode='drop')`), which the
// reference leaves to XLA. The keep bits are computed on the device (position
// inside the table, a live row, a table entry inside the pool), so the
// host never reads which rows write: the launch is the same for every
// step and can be captured in a CUDA graph.
//
// The decode and verify steps whose new rows have the arena's type (fp32
// rows into fp32 pages) fold the write into paged attention's split launch
// instead (paged_attention.cu, note 5); this kernel serves the prefill and
// the arenas that convert the rows (bf16 under fp32 rows, int8, e4m3).
//
// Quantized arenas (int8, or e4m3 fp8, each with an fp32 scale arena
// [NB, H, bs]): the same pass quantizes each (token, head) row on its own,
// bit for bit as quant/core.py quantize_rows (the reference's
// paddle_tpu/quant/core.py:192): amax = max |x| clamped to 1e-30, scale =
// amax / 127 (or / 448) and q = x / scale by true division, rounded half to
// even and clamped to +-127 for int8, rounded to nearest even for e4m3;
// the scale is written beside the row.
//
// Bound on an H100: bytes. Each kept row is read once and written once (at
// the decode shape, 16 rows x 8 heads x 64 elements for K and for V: 64 KB
// in, 64 KB out at fp32); the launch and its latency set the time. One warp
// a (row, head, K or V): lanes stride the row, a shuffle max gives amax.

#include <cuda_fp8.h>
#include <stdint.h>

#include "common.cuh"

namespace ptt {

template <typename T>
struct KvStore;
template <>
struct KvStore<float> {
  static constexpr bool kQuant = false;
  static constexpr float kQmax = 0.f;
  __device__ static float put(float x, float) { return x; }
};
template <>
struct KvStore<__nv_bfloat16> {
  static constexpr bool kQuant = false;
  static constexpr float kQmax = 0.f;
  __device__ static __nv_bfloat16 put(float x, float) {
    return __float2bfloat16(x);
  }
};
template <>
struct KvStore<int8_t> {
  static constexpr bool kQuant = true;
  static constexpr float kQmax = 127.f;
  __device__ static int8_t put(float x, float s) {
    const float q = rintf(__fdiv_rn(x, s));
    return static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
  }
};
template <>
struct KvStore<__nv_fp8_e4m3> {
  static constexpr bool kQuant = true;
  static constexpr float kQmax = 448.f;
  __device__ static __nv_fp8_e4m3 put(float x, float s) {
    __nv_fp8_e4m3 q;
    q.__x = __nv_cvt_float_to_fp8(__fdiv_rn(x, s), __NV_SATFINITE, __NV_E4M3);
    return q;
  }
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// grid (N, H, 2): blockIdx.z 0 writes K, 1 writes V; one warp a block
template <typename S, typename T>
__global__ void __launch_bounds__(32)
    kv_write_kernel(const S* __restrict__ k_new, const S* __restrict__ v_new,
                    T* __restrict__ k_arena, T* __restrict__ v_arena,
                    float* __restrict__ k_scales,
                    float* __restrict__ v_scales,
                    const int* __restrict__ phys, const int* __restrict__ off,
                    const uint8_t* __restrict__ keep, int h, int bs, int d,
                    int dv) {
  const int row = blockIdx.x;
  if (!keep[row]) return;
  const int head = blockIdx.y;
  const bool is_v = blockIdx.z == 1;
  const int width = is_v ? dv : d;
  const S* src = (is_v ? v_new : k_new) + ((size_t)row * h + head) * width;
  const size_t slot = ((size_t)phys[row] * h + head) * bs + off[row];
  T* dst = (is_v ? v_arena : k_arena) + slot * width;
  const int lane = threadIdx.x;
  float s = 0.f;
  if constexpr (KvStore<T>::kQuant) {
    float m = 0.f;
    for (int c = lane; c < width; c += 32) m = fmaxf(m, fabsf(to_f32(src[c])));
    m = fmaxf(warp_max(m), 1e-30f);
    s = __fdiv_rn(m, KvStore<T>::kQmax);
    if (lane == 0) (is_v ? v_scales : k_scales)[slot] = s;
  }
  for (int c = lane; c < width; c += 32)
    dst[c] = KvStore<T>::put(to_f32(src[c]), s);
}

template <typename S, typename T>
cudaError_t launch_kv_write(const void* kn, const void* vn, void* ka,
                            void* va, float* ks, float* vs, const int* phys,
                            const int* off, const uint8_t* keep, int n, int h,
                            int bs, int d, int dv, cudaStream_t stream) {
  kv_write_kernel<S, T><<<dim3(n, h, 2), 32, 0, stream>>>(
      static_cast<const S*>(kn), static_cast<const S*>(vn),
      static_cast<T*>(ka), static_cast<T*>(va), ks, vs, phys, off, keep, h,
      bs, d, dv);
  return cudaGetLastError();
}

template <typename S>
cudaError_t kv_write_to(int arena_dtype, const void* kn, const void* vn,
                        void* ka, void* va, float* ks, float* vs,
                        const int* phys, const int* off, const uint8_t* keep,
                        int n, int h, int bs, int d, int dv,
                        cudaStream_t st) {
  switch (arena_dtype) {
    case kFloat32:
      return launch_kv_write<S, float>(kn, vn, ka, va, ks, vs, phys, off,
                                       keep, n, h, bs, d, dv, st);
    case kBFloat16:
      return launch_kv_write<S, __nv_bfloat16>(kn, vn, ka, va, ks, vs, phys,
                                               off, keep, n, h, bs, d, dv,
                                               st);
    case kInt8:
      return launch_kv_write<S, int8_t>(kn, vn, ka, va, ks, vs, phys, off,
                                        keep, n, h, bs, d, dv, st);
    case kFloat8E4M3:
      return launch_kv_write<S, __nv_fp8_e4m3>(kn, vn, ka, va, ks, vs, phys,
                                               off, keep, n, h, bs, d, dv,
                                               st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace ptt

// k_new [n, h, d], v_new [n, h, dv]: contiguous, fp32 (src_dtype 0) or bf16
// (1); k_arena [nb, h, bs, d], v_arena [nb, h, bs, dv]: one layer's
// contiguous arenas of fp32 (0), bf16 (1), int8 (2) or e4m3 (3); for int8 and
// e4m3, k_scales and v_scales fp32 [nb, h, bs]. phys, off: [n] int32, read
// only where keep [n] (one byte a row) is set, and then 0 <= phys < nb,
// 0 <= off < bs. Returns the launch's CUDA error.
extern "C" int ptt_kv_write(const void* k_new, const void* v_new,
                            int src_dtype, void* k_arena, void* v_arena,
                            void* k_scales, void* v_scales, int arena_dtype,
                            const void* phys, const void* off,
                            const void* keep, int n, int h, int bs, int d,
                            int dv, void* stream) {
  const bool quant =
      arena_dtype == ptt::kInt8 || arena_dtype == ptt::kFloat8E4M3;
  if (n < 1 || n > 2147483647 || h < 1 || h > 65535 || bs < 1 || d < 1 ||
      dv < 1 || (quant && (k_scales == nullptr || v_scales == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ks = static_cast<float*>(k_scales);
  float* vs = static_cast<float*>(v_scales);
  const int* ph = static_cast<const int*>(phys);
  const int* of = static_cast<const int*>(off);
  const uint8_t* kp = static_cast<const uint8_t*>(keep);
  if (src_dtype == ptt::kFloat32)
    return static_cast<int>(ptt::kv_write_to<float>(
        arena_dtype, k_new, v_new, k_arena, v_arena, ks, vs, ph, of, kp, n,
        h, bs, d, dv, st));
  if (src_dtype == ptt::kBFloat16)
    return static_cast<int>(ptt::kv_write_to<__nv_bfloat16>(
        arena_dtype, k_new, v_new, k_arena, v_arena, ks, vs, ph, of, kp, n,
        h, bs, d, dv, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
