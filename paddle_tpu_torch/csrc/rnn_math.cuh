// One LSTM step's arithmetic, forward and backward, shared by the cell
// kernels (rnn_cell.cu: one launch a position) and the sequence kernels
// (lstm_seq.cu: one launch a sequence), so both compute the same function.
// The activation codes and the step semantics are rnn_cell.cu's.
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

// the LSTM's default activations: sigmoid gates, tanh cell and candidate
using LstmDefaultActs = RnnActsOf<0, 1, 1>;

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

inline bool rnn_acts_ok(int a, int b, int c) {
  return a >= 0 && a <= 3 && b >= 0 && b <= 3 && c >= 0 && c <= 3;
}

}  // namespace ptt
