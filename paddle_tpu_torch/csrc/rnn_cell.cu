// The LSTM and GRU cells of the recurrent ops, forward and backward: one
// time step's elementwise work around the recurrent product h_prev @ W,
// which stays a torch.matmul (the JAX package leaves it to XLA too). Each
// recurrence runs on them where its sequence kernels (lstm_seq.cu,
// gru_seq.cu) have no launch plan (wider recurrences), the sequence
// kernels taking the rest.
//
// They replace no Pallas kernel: in paddle_tpu/ops/rnn_ops.py each
// recurrence is one lax.scan (lstm_scan :31, gru_scan :81 with gru_step
// :393), whose step XLA compiles into one loop fusion around the product.
// Written as plain torch ops a step would launch about 12 kernels forward
// and 20 backward; each of these is one launch a step (the GRU's two, one
// on each side of its second product).
//
// Gate layouts (rnn_ops.py's contract): the LSTM's 4D columns hold
// [i, f, g (candidate), o], the GRU's 3D columns [u (update), r (reset),
// c (candidate)]. Step semantics, with m = 1 where the step's position is
// below the row's length (0 past it; 1 with no lengths):
//   LSTM: a = (x + h_prev @ W) + b; i, f, o = gate(a_i, a_f, a_o);
//         g = cand(a_g); c' = f * c_prev + i * g; h' = o * cell(c');
//         h = m h' + (1 - m) h_prev; c = m c' + (1 - m) c_prev.
//   GRU:  u, r = gate((x + b)[:2D] + h_prev @ W[:, :2D]);
//         c = cand((x + b)[2D:] + (r h_prev) @ W[:, 2D:]);
//         h' = u h_prev + (1 - u) c; h = m h' + (1 - m) h_prev.
// Activation codes: 0 sigmoid, 1 tanh, 2 relu, 3 identity (rnn_ops.py's
// _ACTS, :150). The arithmetic is fp32 in registers; every value the
// reference holds in the carry's dtype and the backward reads again (the
// activated gates, the cell c, r h_prev) is rounded to that dtype where it
// is made, so the backward differentiates the function the forward
// computed; h, c and the gradients leave rounded to the carry's dtype.
// Padding carries the state (the masked blend above), and a reverse
// recurrence is the forward one walking positions T-1 .. 0: the wrapper
// passes each step's position and the row lengths.
//
// Backward, with dh and dc the gradients reaching the step's outputs (the
// output's own plus the carry's from the later step, held in fp32):
//   LSTM: dh' = m dh, dc' = m dc + dh' o cell'(c), pass (1 - m) dh and
//         dc_prev = dc' f + (1 - m) dc; da = (dc' g gate'(i), dc' c_prev
//         gate'(f), dc' i cand'(g), dh' cell(c) gate'(o)) is written as
//         the input's gradient; dh_prev = da @ W^T + pass is the next
//         launch's (the product is the wrapper's).
//   GRU phase 0: dh' = m dh, da_u = dh' (h_prev - c) gate'(u), da_c = dh'
//         (1 - u) cand'(c), carry (1 - m) dh + dh' u; the wrapper takes
//         drh = da_c @ W_c^T. Phase 1: da_r = drh h_prev gate'(r), carry
//         += drh r; the wrapper takes (da_u, da_r) @ W_ur^T for the next.
// The derivatives come from the saved outputs: sigmoid y(1 - y), tanh
// 1 - y^2, relu (y > 0), identity 1.
//
// Bound on an H100: bytes. A step moves each of its inputs once and
// writes its outputs once at a few flops an element. At bench_rnn_lstm's
// shape (batch 128, hidden 128, bf16) one LSTM step reads x, the product
// and the gates' bias (3 x 128 x 512 x 2 B) and the carries, and writes h,
// c and the gates: about 0.66 MB, 0.2 us at 3.35 TB/s; a launch costs more
// than that, so the recurrence is bound by its 2 T launches and products.
//
// Design: one thread a (row, unit); a thread reads its unit of all the
// gates, so no value crosses threads. At bench_rnn_lstm's step (B 128,
// hidden 128) that is 16,384 threads. The fp32 carries of the backward are
// read and written in place by the thread that owns them.

#include "rnn_math.cuh"  // the step arithmetic, shared with the sequence kernels

namespace ptt {

constexpr int kRnnThreads = 128;

template <typename T>
__device__ __forceinline__ float rnn_load_or_zero(const T* p, long long i) {
  return p == nullptr ? 0.f : to_f32(p[i]);
}

__device__ __forceinline__ float rnn_mask(const int* len, int b, int pos) {
  return len == nullptr ? 1.f : (pos < len[b] ? 1.f : 0.f);
}

// One LSTM step at position pos. x: the projected input at pos (row
// stride xs); hw: h_prev @ W, [B, 4D]; bias: [4D] or null; hp, cp: the
// carries (row strides hps, cps); h, c: the outputs at pos (row stride
// hcs); gates: the activated gates at pos (row stride gs).
template <typename T>
__global__ void __launch_bounds__(kRnnThreads) lstm_cell_fwd_kernel(
    const T* __restrict__ x, long long xs, const T* __restrict__ hw,
    const T* __restrict__ bias, const T* hp, long long hps, const T* cp,
    long long cps, const int* __restrict__ len, int pos, T* h, T* c,
    long long hcs, T* __restrict__ gates, long long gs, int B, int D,
    int ga, int ca, int na) {
  const long long n = static_cast<long long>(B) * D;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < n; t += stride) {
    const int b = static_cast<int>(t / D);
    const int j = static_cast<int>(t % D);
    const float m = rnn_mask(len, b, pos);
    float a[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      a[q] = to_f32(x[b * xs + q * D + j]) +
             to_f32(hw[static_cast<long long>(b) * 4 * D + q * D + j]) +
             rnn_load_or_zero(bias, q * D + j);
    const float hpv = to_f32(hp[b * hps + j]);
    const float cpv = to_f32(cp[b * cps + j]);
    const LstmStep st = lstm_step<T>(a, hpv, cpv, m, RnnActs{ga, ca, na});
    T* g = gates + b * gs + j;
#pragma unroll
    for (int q = 0; q < 4; ++q) g[q * D] = from_f32<T>(st.g[q]);
    h[b * hcs + j] = from_f32<T>(st.h);
    c[b * hcs + j] = from_f32<T>(st.c);
  }
}

// One LSTM step's backward at position pos. dh_out, dc_out: the outputs'
// gradients at pos (row strides dhs, dcs; null: zero); dh_mm: the later
// step's da @ W^T, [B, D] (null at the last step); dh_pass, dc_carry: the
// fp32 carries [B, D], read and written; gates, c: the forward's at pos;
// cp: c_prev; dg: the pre-activations' gradient at pos (row stride dgs).
template <typename T>
__global__ void __launch_bounds__(kRnnThreads) lstm_cell_bwd_kernel(
    const T* __restrict__ dh_out, long long dhs, const T* __restrict__ dc_out,
    long long dcs, const T* __restrict__ dh_mm, float* __restrict__ dh_pass,
    float* __restrict__ dc_carry, const T* __restrict__ gates, long long gs,
    const T* __restrict__ c, long long cs, const T* __restrict__ cp,
    long long cps, const int* __restrict__ len, int pos,
    T* __restrict__ dg, long long dgs, int B, int D, int ga, int ca,
    int na) {
  const long long n = static_cast<long long>(B) * D;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < n; t += stride) {
    const int b = static_cast<int>(t / D);
    const int j = static_cast<int>(t % D);
    const float m = rnn_mask(len, b, pos);
    const float dh = rnn_load_or_zero(dh_out, b * dhs + j) +
                     rnn_load_or_zero(dh_mm, t) + dh_pass[t];
    const float dc = rnn_load_or_zero(dc_out, b * dcs + j) + dc_carry[t];
    const T* g = gates + b * gs + j;
    float gv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) gv[q] = to_f32(g[q * D]);
    const LstmGrad r =
        lstm_step_bwd(dh, dc, gv, to_f32(c[b * cs + j]),
                      to_f32(cp[b * cps + j]), m, RnnActs{ga, ca, na});
    T* o = dg + b * dgs + j;
#pragma unroll
    for (int q = 0; q < 4; ++q) o[q * D] = from_f32<T>(r.da[q]);
    dh_pass[t] = r.dh_pass;
    dc_carry[t] = r.dc_carry;
  }
}

// One GRU step at position pos, in two phases (launches) around the
// second product. Phase 0: mm = h_prev @ W[:, :2D], [B, 2D]; writes u and
// r into gates and r h_prev into out. Phase 1: mm = (r h_prev) @
// W[:, 2D:], [B, D]; reads u from gates, writes c into gates and h into
// out. x: the projected input at pos (row stride xs); bias: [3D] or null;
// hp: h_prev.
template <typename T>
__global__ void __launch_bounds__(kRnnThreads) gru_cell_fwd_kernel(
    int phase, const T* __restrict__ x, long long xs,
    const T* __restrict__ bias,
    const T* __restrict__ mm, const T* hp, long long hps,
    const int* __restrict__ len, int pos, T* gates, long long gs, T* out,
    long long os, int B, int D, int ga, int na) {
  const long long n = static_cast<long long>(B) * D;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < n; t += stride) {
    const int b = static_cast<int>(t / D);
    const int j = static_cast<int>(t % D);
    const float hpv = to_f32(hp[b * hps + j]);
    T* g = gates + b * gs + j;
    const RnnActs acts{ga, 0, na};
    if (phase == 0) {
      float a[2];
#pragma unroll
      for (int q = 0; q < 2; ++q)
        a[q] = to_f32(x[b * xs + q * D + j]) +
               rnn_load_or_zero(bias, q * D + j) +
               to_f32(mm[static_cast<long long>(b) * 2 * D + q * D + j]);
      const GruGates y = gru_step_gates<T>(a[0], a[1], hpv, acts);
      g[0] = from_f32<T>(y.u);
      g[D] = from_f32<T>(y.r);
      out[b * os + j] = from_f32<T>(y.rh);
    } else {
      const GruOut o = gru_step_out<T>(
          to_f32(x[b * xs + 2 * D + j]) + rnn_load_or_zero(bias, 2 * D + j) +
              to_f32(mm[t]),
          to_f32(g[0]), hpv, rnn_mask(len, b, pos), acts);
      g[2 * D] = from_f32<T>(o.c);
      out[b * os + j] = from_f32<T>(o.h);
    }
  }
}

// One GRU step's backward at position pos, in two phases around the
// product with W[:, 2D:]^T. Phase 0: dh_out: the output's gradient at pos
// (row stride dhs; null: zero); mm: the later step's (da_u, da_r) @
// W[:, :2D]^T, [B, D] (null at the last step); writes da_u and da_c into
// dg and sets the fp32 carry dhc to (1 - m) dh + dh' u. Phase 1: mm = drh
// = da_c @ W[:, 2D:]^T, [B, D]; writes da_r into dg and adds drh r to dhc.
template <typename T>
__global__ void __launch_bounds__(kRnnThreads) gru_cell_bwd_kernel(
    int phase, const T* __restrict__ dh_out, long long dhs,
    const T* __restrict__ mm,
    float* __restrict__ dhc, const T* __restrict__ gates, long long gs,
    const T* __restrict__ hp, long long hps, const int* __restrict__ len,
    int pos, T* __restrict__ dg, long long dgs, int B, int D, int ga,
    int na) {
  const long long n = static_cast<long long>(B) * D;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < n; t += stride) {
    const int b = static_cast<int>(t / D);
    const int j = static_cast<int>(t % D);
    const T* g = gates + b * gs + j;
    const float hpv = to_f32(hp[b * hps + j]);
    const float dmm = rnn_load_or_zero(mm, t);
    T* o = dg + b * dgs + j;
    const RnnActs acts{ga, 0, na};
    if (phase == 0) {
      const float dh = rnn_load_or_zero(dh_out, b * dhs + j) + dmm + dhc[t];
      const GruGrad0 r = gru_step_bwd0(dh, to_f32(g[0]), to_f32(g[2 * D]),
                                       hpv, rnn_mask(len, b, pos), acts);
      o[0] = from_f32<T>(r.da_u);
      o[2 * D] = from_f32<T>(r.da_c);
      dhc[t] = r.carry;
    } else {
      const GruGrad1 r = gru_step_bwd1(dmm, to_f32(g[D]), hpv, dhc[t], acts);
      o[D] = from_f32<T>(r.da_r);
      dhc[t] = r.carry;
    }
  }
}

inline int rnn_grid(long long n) {
  long long blocks = (n + kRnnThreads - 1) / kRnnThreads;
  const long long cap = 132LL * 16;
  return static_cast<int>(blocks < 1 ? 1 : (blocks > cap ? cap : blocks));
}

template <typename T>
cudaError_t launch_lstm_fwd(const void* x, long long xs, const void* hw,
                            const void* bias, const void* hp, long long hps,
                            const void* cp, long long cps, const int* len,
                            int pos, void* h, void* c, long long hcs,
                            void* gates, long long gs, int B, int D, int ga,
                            int ca, int na, cudaStream_t s) {
  lstm_cell_fwd_kernel<T>
      <<<rnn_grid(static_cast<long long>(B) * D), kRnnThreads, 0, s>>>(
          static_cast<const T*>(x), xs, static_cast<const T*>(hw),
          static_cast<const T*>(bias), static_cast<const T*>(hp), hps,
          static_cast<const T*>(cp), cps, len, pos, static_cast<T*>(h),
          static_cast<T*>(c), hcs, static_cast<T*>(gates), gs, B, D, ga, ca,
          na);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_lstm_bwd(const void* dh_out, long long dhs,
                            const void* dc_out, long long dcs,
                            const void* dh_mm, float* dh_pass,
                            float* dc_carry, const void* gates, long long gs,
                            const void* c, long long cs, const void* cp,
                            long long cps, const int* len, int pos, void* dg,
                            long long dgs, int B, int D, int ga, int ca,
                            int na, cudaStream_t s) {
  lstm_cell_bwd_kernel<T>
      <<<rnn_grid(static_cast<long long>(B) * D), kRnnThreads, 0, s>>>(
          static_cast<const T*>(dh_out), dhs, static_cast<const T*>(dc_out),
          dcs, static_cast<const T*>(dh_mm), dh_pass, dc_carry,
          static_cast<const T*>(gates), gs, static_cast<const T*>(c), cs,
          static_cast<const T*>(cp), cps, len, pos, static_cast<T*>(dg), dgs,
          B, D, ga, ca, na);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gru_fwd(int phase, const void* x, long long xs,
                           const void* bias, const void* mm, const void* hp,
                           long long hps, const int* len, int pos,
                           void* gates, long long gs, void* out, long long os,
                           int B, int D, int ga, int na, cudaStream_t s) {
  gru_cell_fwd_kernel<T>
      <<<rnn_grid(static_cast<long long>(B) * D), kRnnThreads, 0, s>>>(
          phase, static_cast<const T*>(x), xs, static_cast<const T*>(bias),
          static_cast<const T*>(mm), static_cast<const T*>(hp), hps, len, pos,
          static_cast<T*>(gates), gs, static_cast<T*>(out), os, B, D, ga, na);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gru_bwd(int phase, const void* dh_out, long long dhs,
                           const void* mm, float* dhc, const void* gates,
                           long long gs, const void* hp, long long hps,
                           const int* len, int pos, void* dg, long long dgs,
                           int B, int D, int ga, int na, cudaStream_t s) {
  gru_cell_bwd_kernel<T>
      <<<rnn_grid(static_cast<long long>(B) * D), kRnnThreads, 0, s>>>(
          phase, static_cast<const T*>(dh_out), dhs, static_cast<const T*>(mm),
          dhc, static_cast<const T*>(gates), gs, static_cast<const T*>(hp),
          hps, len, pos, static_cast<T*>(dg), dgs, B, D, ga, na);
  return cudaGetLastError();
}

}  // namespace ptt

// Strides and B, D are in elements; dtype 0 fp32, 1 bf16 for every T
// tensor of a call; len: int32 [B] or null; act codes 0-3. Each returns
// the launch's CUDA error (cudaErrorInvalidValue for arguments it does
// not take).
extern "C" int ptt_lstm_cell_fwd(const void* x, long long xs, const void* hw,
                                 const void* bias, const void* hp,
                                 long long hps, const void* cp, long long cps,
                                 const void* len, int pos, void* h, void* c,
                                 long long hcs, void* gates, long long gs,
                                 int B, int D, int dtype, int ga, int ca,
                                 int na, void* stream) {
  if (B < 1 || D < 1 || !ptt::rnn_acts_ok(ga, ca, na))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* l = static_cast<const int*>(len);
  if (dtype == ptt::kFloat32)
    return static_cast<int>(ptt::launch_lstm_fwd<float>(
        x, xs, hw, bias, hp, hps, cp, cps, l, pos, h, c, hcs, gates, gs, B, D,
        ga, ca, na, s));
  if (dtype == ptt::kBFloat16)
    return static_cast<int>(ptt::launch_lstm_fwd<__nv_bfloat16>(
        x, xs, hw, bias, hp, hps, cp, cps, l, pos, h, c, hcs, gates, gs, B, D,
        ga, ca, na, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int ptt_lstm_cell_bwd(const void* dh_out, long long dhs,
                                 const void* dc_out, long long dcs,
                                 const void* dh_mm, void* dh_pass,
                                 void* dc_carry, const void* gates,
                                 long long gs, const void* c, long long cs,
                                 const void* cp, long long cps,
                                 const void* len, int pos, void* dg,
                                 long long dgs, int B, int D, int dtype,
                                 int ga, int ca, int na, void* stream) {
  if (B < 1 || D < 1 || !ptt::rnn_acts_ok(ga, ca, na))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* l = static_cast<const int*>(len);
  float* hp = static_cast<float*>(dh_pass);
  float* cc = static_cast<float*>(dc_carry);
  if (dtype == ptt::kFloat32)
    return static_cast<int>(ptt::launch_lstm_bwd<float>(
        dh_out, dhs, dc_out, dcs, dh_mm, hp, cc, gates, gs, c, cs, cp, cps, l,
        pos, dg, dgs, B, D, ga, ca, na, s));
  if (dtype == ptt::kBFloat16)
    return static_cast<int>(ptt::launch_lstm_bwd<__nv_bfloat16>(
        dh_out, dhs, dc_out, dcs, dh_mm, hp, cc, gates, gs, c, cs, cp, cps, l,
        pos, dg, dgs, B, D, ga, ca, na, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int ptt_gru_cell_fwd(int phase, const void* x, long long xs,
                                const void* bias, const void* mm,
                                const void* hp, long long hps,
                                const void* len, int pos, void* gates,
                                long long gs, void* out, long long os, int B,
                                int D, int dtype, int ga, int na,
                                void* stream) {
  if (B < 1 || D < 1 || (phase != 0 && phase != 1) ||
      !ptt::rnn_acts_ok(ga, na, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* l = static_cast<const int*>(len);
  if (dtype == ptt::kFloat32)
    return static_cast<int>(ptt::launch_gru_fwd<float>(
        phase, x, xs, bias, mm, hp, hps, l, pos, gates, gs, out, os, B, D, ga,
        na, s));
  if (dtype == ptt::kBFloat16)
    return static_cast<int>(ptt::launch_gru_fwd<__nv_bfloat16>(
        phase, x, xs, bias, mm, hp, hps, l, pos, gates, gs, out, os, B, D, ga,
        na, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int ptt_gru_cell_bwd(int phase, const void* dh_out, long long dhs,
                                const void* mm, void* dhc, const void* gates,
                                long long gs, const void* hp, long long hps,
                                const void* len, int pos, void* dg,
                                long long dgs, int B, int D, int dtype,
                                int ga, int na, void* stream) {
  if (B < 1 || D < 1 || (phase != 0 && phase != 1) ||
      !ptt::rnn_acts_ok(ga, na, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* l = static_cast<const int*>(len);
  float* carry = static_cast<float*>(dhc);
  if (dtype == ptt::kFloat32)
    return static_cast<int>(ptt::launch_gru_bwd<float>(
        phase, dh_out, dhs, mm, carry, gates, gs, hp, hps, l, pos, dg, dgs, B,
        D, ga, na, s));
  if (dtype == ptt::kBFloat16)
    return static_cast<int>(ptt::launch_gru_bwd<__nv_bfloat16>(
        phase, dh_out, dhs, mm, carry, gates, gs, hp, hps, l, pos, dg, dgs, B,
        D, ga, na, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
