// One LSTM step's and one GRU step's arithmetic, forward and backward,
// shared by the cell kernels (rnn_cell.cu: one launch a position) and the
// sequence kernels (lstm_seq.cu, gru_seq.cu: one launch a sequence), so
// both compute the same function. The activation codes and the step
// semantics are rnn_cell.cu's.
#pragma once

#include "common.cuh"

namespace ptt {

__device__ __forceinline__ float rnn_act(int kind, float x) {
  switch (kind) {
    case 0:
      return 1.f / (1.f + expf(-x));
    case 1:
      return tanhf(x);
    case 2:
      return x < 0.f ? 0.f : x;  // a NaN stays NaN, as jnp.maximum's does
    default:
      return x;
  }
}

// the activation's derivative from its output y
__device__ __forceinline__ float rnn_dact(int kind, float y) {
  switch (kind) {
    case 0:
      return y * (1.f - y);
    case 1:
      return 1.f - y * y;
    case 2:
      return y > 0.f ? 1.f : 0.f;
    default:
      return 1.f;
  }
}

// A step's activation codes (gate, cell, candidate): RnnActs holds them
// at run time; RnnActsOf binds them at compile time, so the switches of
// rnn_act fold away and the compiler can interleave independent steps.
struct RnnActs {
  int ga, ca, na;
  __device__ __forceinline__ int gate() const { return ga; }
  __device__ __forceinline__ int cell() const { return ca; }
  __device__ __forceinline__ int cand() const { return na; }
};

template <int GA, int CA, int NA>
struct RnnActsOf {
  __device__ __forceinline__ constexpr int gate() const { return GA; }
  __device__ __forceinline__ constexpr int cell() const { return CA; }
  __device__ __forceinline__ constexpr int cand() const { return NA; }
};

// the LSTM's default activations: sigmoid gates, tanh cell and candidate;
// the GRU's (sigmoid gates, tanh candidate) read the same codes
using LstmDefaultActs = RnnActsOf<0, 1, 1>;
using GruDefaultActs = LstmDefaultActs;

// The forward step from the pre-activations a [i, f, g, o] (x + h_prev @ W
// + bias), the carries and the mask m: the activated gates and the new
// cell rounded to T, h and c blended by m (in fp32; the caller rounds them
// to T where it stores them).
struct LstmStep {
  float g[4];
  float h, c;
};

template <typename T, typename Acts>
__device__ __forceinline__ LstmStep lstm_step(const float (&a)[4], float hpv,
                                              float cpv, float m,
                                              const Acts& acts) {
  LstmStep s;
  s.g[0] = round_as<T>(rnn_act(acts.gate(), a[0]));
  s.g[1] = round_as<T>(rnn_act(acts.gate(), a[1]));
  s.g[2] = round_as<T>(rnn_act(acts.cand(), a[2]));
  s.g[3] = round_as<T>(rnn_act(acts.gate(), a[3]));
  const float cn = round_as<T>(s.g[1] * cpv + s.g[0] * s.g[2]);
  const float hn = s.g[3] * rnn_act(acts.cell(), cn);
  s.h = m * hn + (1.f - m) * hpv;
  s.c = m * cn + (1.f - m) * cpv;
  return s;
}

// The backward step: dh and dc the gradients reaching the step's outputs
// (fp32), g the saved gates, cv the saved cell, cpv c_prev. da: the
// pre-activations' gradient (the caller rounds it to T); dh_pass and
// dc_carry: the fp32 carries handed to the earlier step.
struct LstmGrad {
  float da[4];
  float dh_pass, dc_carry;
};

template <typename Acts>
__device__ __forceinline__ LstmGrad lstm_step_bwd(float dh, float dc,
                                                  const float (&g)[4],
                                                  float cv, float cpv,
                                                  float m, const Acts& acts) {
  LstmGrad r;
  const int ga = acts.gate(), ca = acts.cell(), na = acts.cand();
  const float dhn = m * dh;
  const float ac = rnn_act(ca, cv);
  const float dcn = m * dc + dhn * g[3] * rnn_dact(ca, ac);
  r.da[0] = dcn * g[2] * rnn_dact(ga, g[0]);
  r.da[1] = dcn * cpv * rnn_dact(ga, g[1]);
  r.da[2] = dcn * g[0] * rnn_dact(na, g[2]);
  r.da[3] = dhn * ac * rnn_dact(ga, g[3]);
  r.dh_pass = (1.f - m) * dh;
  r.dc_carry = dcn * g[1] + (1.f - m) * dc;
  return r;
}

// The GRU forward step in two halves around its second product. The first
// from the pre-activations of u and r ((x + b) + h_prev @ W[:, :2D]) and
// h_prev: the activated gates and r h_prev, each rounded to T.
struct GruGates {
  float u, r, rh;
};

template <typename T, typename Acts>
__device__ __forceinline__ GruGates gru_step_gates(float au, float ar,
                                                   float hpv,
                                                   const Acts& acts) {
  GruGates g;
  g.u = round_as<T>(rnn_act(acts.gate(), au));
  g.r = round_as<T>(rnn_act(acts.gate(), ar));
  g.rh = round_as<T>(g.r * hpv);
  return g;
}

// The second from the candidate's pre-activation ((x + b) + (r h_prev) @
// W[:, 2D:]), u, h_prev and the mask m: the candidate rounded to T and h
// blended by m (in fp32; the caller rounds it where it stores it).
struct GruOut {
  float c, h;
};

template <typename T, typename Acts>
__device__ __forceinline__ GruOut gru_step_out(float ac, float u, float hpv,
                                               float m, const Acts& acts) {
  GruOut o;
  o.c = round_as<T>(rnn_act(acts.cand(), ac));
  const float hn = u * hpv + (1.f - u) * o.c;
  o.h = m * hn + (1.f - m) * hpv;
  return o;
}

// The backward's first half: dh the gradient reaching h (the output's,
// the later step's (da_u, da_r) @ W[:, :2D]^T and the fp32 carry), the
// saved u and c, h_prev and m: da_u, da_c (the caller rounds them to T)
// and the carry handed on, (1 - m) dh + m dh u.
struct GruGrad0 {
  float da_u, da_c, carry;
};

template <typename Acts>
__device__ __forceinline__ GruGrad0 gru_step_bwd0(float dh, float u, float c,
                                                  float hpv, float m,
                                                  const Acts& acts) {
  GruGrad0 g;
  const float dhn = m * dh;
  g.da_u = dhn * (hpv - c) * rnn_dact(acts.gate(), u);
  g.da_c = dhn * (1.f - u) * rnn_dact(acts.cand(), c);
  g.carry = (1.f - m) * dh + dhn * u;
  return g;
}

// Its second half, from drh = da_c @ W[:, 2D:]^T (rounded to T), the
// saved r, h_prev and the carry: da_r and the carry plus drh r.
struct GruGrad1 {
  float da_r, carry;
};

template <typename Acts>
__device__ __forceinline__ GruGrad1 gru_step_bwd1(float drh, float r,
                                                  float hpv, float carry,
                                                  const Acts& acts) {
  GruGrad1 g;
  g.da_r = drh * hpv * rnn_dact(acts.gate(), r);
  g.carry = carry + drh * r;
  return g;
}

inline bool rnn_acts_ok(int a, int b, int c) {
  return a >= 0 && a <= 3 && b >= 0 && b <= 3 && c >= 0 && c <= 3;
}

}  // namespace ptt
