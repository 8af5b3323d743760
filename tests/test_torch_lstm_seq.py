"""The LSTM sequence kernels' plain versions and launch plan, on the CPU.

ops/kernels/rnn_cell.py's lstm_seq_fwd_reference / lstm_seq_bwd_reference
(the per-position loop of torch.mm and plain cells that the card tests
hold csrc/lstm_seq.cu against) against the JAX package's lstm_scan and
its VJP on the same numpy inputs: hidden and cell, then the input's, h0's
and c0's gradients and dW = h_prev^T dgates, with ragged lengths (T, 0 and
in between), full lengths, no lengths, all padding, reverse, every
activation, and bias, dhidden or dcell absent. Then lstm_seq_plan: every
shape the repository runs gets a launch that fits 227 KB of shared memory
a CTA, and a width past that gets None. Then the wrappers on CPU tensors:
the plain versions, bit for bit, and no launch counted.

Tolerances, of the largest magnitude of the reference's array, as
tests/test_torch_rnn.py's: fp32 outputs 1e-5 and gradients 1e-4 (the same
arithmetic with sums in another order); bf16 2^-5 (the reference rounds
every intermediate of a step to bf16, the plain cells keep fp32 between
the values they round).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops import rnn_ops as J

from paddle_tpu_torch.ops.kernels import rnn_cell as K

B, T, D = 4, 6, 8
LENS = [6, 0, 3, 1]
TOL = {'fp32': (1e-5, 1e-4), 'bf16': (2.0 ** -5, 2.0 ** -5)}
SIG = ('sigmoid', 'tanh', 'tanh')
CASES = {
    # (activations, reverse, lengths, with bias, with dhidden, with dcell)
    'ragged': (SIG, False, LENS, True, True, True),
    'reverse': (SIG, True, LENS, True, True, True),
    'tanh-relu-identity': (('tanh', 'relu', 'identity'), False, LENS, True,
                           True, True),
    'identity-sigmoid-relu_reverse': (('identity', 'sigmoid', 'relu'), True,
                                      LENS, True, True, True),
    'relu-identity-sigmoid': (('relu', 'identity', 'sigmoid'), False, LENS,
                              True, True, True),
    'full_lengths': (SIG, False, [T] * B, True, True, True),
    'no_lengths': (SIG, True, None, True, True, True),
    'all_padding': (SIG, False, [0] * B, True, True, True),
    'no_bias': (SIG, False, LENS, False, True, True),
    'no_dhidden': (SIG, True, LENS, True, False, True),
    'no_dcell': (SIG, False, LENS, True, True, False),
}


def _close(got, want, rel, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all() and np.isfinite(want).all(), what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, '%s: %.3g > %.3g x %.3g' % (what, err, rel,
                                                          scale)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(B, T, 4 * D) * 0.5, rng.randn(D, 4 * D) * 0.3,
              rng.randn(4 * D) * 0.1, rng.randn(B, D) * 0.5,
              rng.randn(B, D) * 0.5]
    cots = [rng.randn(B, T, D), rng.randn(B, T, D)]
    return [a.astype('f') for a in arrays], [c.astype('f') for c in cots]


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_lstm_seq_references_match_lstm_scan(case, dtype):
    acts, reverse, lens, with_bias, with_dh, with_dc = CASES[case]
    (x, w, bias, h0, c0), (dh, dc) = _inputs(len(case))
    if not with_bias:
        bias = np.zeros_like(bias)
    if not with_dh:
        dh = np.zeros_like(dh)
    if not with_dc:
        dc = np.zeros_like(dc)
    jd = jnp.bfloat16 if dtype == 'bf16' else jnp.float32
    td = torch.bfloat16 if dtype == 'bf16' else torch.float32
    length = None if lens is None else jnp.asarray(lens, jnp.int32)

    def f(x, w, b, h0, c0):
        return J.lstm_scan(x, w, b.reshape(1, -1), h0, c0, length,
                           gate_act=J._ACTS[acts[0]],
                           cell_act=J._ACTS[acts[1]],
                           cand_act=J._ACTS[acts[2]], is_reverse=reverse)
    ref, vjp = jax.vjp(f, *[jnp.asarray(a, jd) for a in (x, w, bias, h0,
                                                          c0)])
    rdx, rdw, _, rdh0, rdc0 = vjp((jnp.asarray(dh, jd), jnp.asarray(dc, jd)))

    def t(a):
        return torch.tensor(a).to(td)
    lt = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    codes = tuple(K.ACTS[a] for a in acts)
    hidden, cell, gates = K.lstm_seq_fwd_reference(
        t(x), t(w), t(bias) if with_bias else None, t(h0), t(c0), lt, codes,
        reverse)
    dx, dh0, dc0 = K.lstm_seq_bwd_reference(
        t(dh) if with_dh else None, t(dc) if with_dc else None, t(w), gates,
        cell, t(c0), lt, codes, reverse)
    prev = K._previous(t(h0), hidden, reverse)
    dw = torch.mm(prev.reshape(-1, D).t(), dx.reshape(-1, 4 * D))
    out_tol, grad_tol = TOL[dtype]

    def f32(v):
        return np.asarray(v.float().numpy() if torch.is_tensor(v) else v,
                          np.float32)
    for name, got, want in (('hidden', hidden, ref[0]),
                            ('cell', cell, ref[1])):
        _close(f32(got), f32(want), out_tol, name)
    for name, got, want in (('dx', dx, rdx), ('dw', dw, rdw),
                            ('dh0', dh0, rdh0), ('dc0', dc0, rdc0)):
        _close(f32(got), f32(want), grad_tol, name)
    if lens is not None and not any(lens):
        assert not dx.any() and torch.equal(hidden, t(h0)[:, None].expand(
            B, T, D))


# (batch, hidden, dtype) of every recurrence the repository runs: the
# benchmark and the smoke's phases, the sequence models, the tests
RUN_SHAPES = {
    'bench_rnn_lstm': (128, 128, torch.bfloat16),
    'bench_rnn_lstm_fp32_card_vs_host': (8, 128, torch.float32),
    'stacked_lstm_net': (64, 128, torch.float32),
    'lstm_text_classifier_card_test': (8, 32, torch.bfloat16),
    'seq_models_hidden_64': (64, 64, torch.float32),
    'phase19c_recurrence': (8, 32, torch.float32),
    'phase19c_ragged': (8, 24, torch.bfloat16),
    'phase19c_odd': (37, 20, torch.float32),
    'rnn_tests': (4, 8, torch.bfloat16),
    'hidden_256_bf16': (128, 256, torch.bfloat16),
}
NO_PLAN = {
    'bench_rnn_lstm_hidden_512': (128, 512, torch.bfloat16),
    'hidden_256_fp32': (64, 256, torch.float32),
    'hidden_1024_fp32': (8, 1024, torch.float32),
    'float16': (64, 128, torch.float16),
    'hidden_0': (8, 0, torch.float32),
}


@pytest.mark.parametrize('shape', sorted(RUN_SHAPES))
def test_lstm_seq_plan_fits(shape):
    b, d, dtype = RUN_SHAPES[shape]
    plan = K.lstm_seq_plan(b, d, dtype)
    assert plan is not None
    assert max(plan['smem_fwd'], plan['smem_bwd']) <= K.SEQ_SMEM_LIMIT
    assert plan['rows'] == 16
    assert 1 <= plan['cluster'] <= 8 and plan['units'] % 8 == 0
    assert (plan['cluster'] - 1) * plan['units'] < d <= \
        plan['cluster'] * plan['units']
    assert plan['threads'] == 256 and 16 * plan['units'] <= 4 * 256
    assert plan['grid'] == plan['cluster'] * -(-b // 16)


@pytest.mark.parametrize('shape', sorted(NO_PLAN))
def test_lstm_seq_plan_none_past_the_limit(shape):
    assert K.lstm_seq_plan(*NO_PLAN[shape]) is None


def test_lstm_seq_plan_bench_geometry():
    """bench_rnn_lstm's recurrence: 8 clusters of 8 CTAs, 16 units and 256
    threads a CTA, the forward's and backward's bf16 layouts, their fp32
    staging of the product and their two mbarriers."""
    plan = K.lstm_seq_plan(128, 128, torch.bfloat16)
    assert (plan['cluster'], plan['units'], plan['threads'], plan['grid']) \
        == (8, 16, 256, 64)
    assert plan['smem_fwd'] == (4 * 16 + 32) * (128 + 8) * 2 + 4 * 16 * 64 + 16
    assert plan['smem_bwd'] == (16 + 32) * (512 + 8) * 2 + 4 * 16 * 16 + 16


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['fp32', 'bf16'])
def test_lstm_seq_wrappers_on_cpu_take_the_plain_versions(dtype):
    (x, w, bias, h0, c0), (dh, dc) = _inputs(3)
    args = [torch.tensor(a).to(dtype) for a in (x, w, bias, h0, c0)]
    lt = torch.tensor(LENS, dtype=torch.int32)
    before = (K.lstm_seq_fwd.launches, K.lstm_seq_bwd.launches)
    got = K.lstm_seq_fwd(*args, lt, (0, 1, 1), True)
    want = K.lstm_seq_fwd_reference(*args, lt, (0, 1, 1), True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    cots = [torch.tensor(c).to(dtype) for c in (dh, dc)]
    gb = K.lstm_seq_bwd(*cots, args[1], got[2], got[1], args[4], lt,
                        (0, 1, 1), True)
    wb = K.lstm_seq_bwd_reference(*cots, args[1], got[2], got[1], args[4],
                                  lt, (0, 1, 1), True)
    assert all(torch.equal(a, b) for a, b in zip(gb, wb))
    assert (K.lstm_seq_fwd.launches, K.lstm_seq_bwd.launches) == before
    hidden, cell = K.LstmRecurrence.apply(*args, lt, (0, 1, 1), True)
    assert torch.equal(hidden, got[0]) and torch.equal(cell, got[1])
