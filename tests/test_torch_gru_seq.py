"""The GRU sequence kernels' plain versions and launch plan, on the CPU.

ops/kernels/rnn_cell.py's gru_seq_fwd_reference / gru_seq_bwd_reference
(the per-position loop of two torch.mm and plain cells that the card tests
hold csrc/gru_seq.cu against) against the JAX package's gru_scan and its
VJP on the same numpy inputs: hidden, then the input's, h0's and the
bias's gradients and dW = [h_prev^T da_ur, rh^T da_c], with ragged lengths
(T, 0 and in between), full lengths, no lengths, all padding, reverse,
every activation pair, and bias or dhidden absent. Then gru_seq_plan:
every shape the repository runs gets a launch that fits 227 KB of shared
memory a CTA, and a width past that gets None. Then the wrappers on CPU
tensors: the plain versions, bit for bit, and no launch counted.

Tolerances, of the largest magnitude of the reference's array, as
tests/test_torch_lstm_seq.py's: fp32 outputs 1e-5 and gradients 1e-4 (the
same arithmetic with sums in another order); bf16 2^-5 (the reference
rounds every intermediate of a step to bf16, the plain cells keep fp32
between the values they round).

Every case takes tests/test_torch_rnn.py's draws (seed 0, the same
order). The identity gate with a relu candidate is unbounded, and in bf16
its comparison measures the reference's rounding as much as the port's:
on other draws h grows to 10^2-10^6 within the 6 steps and gru_scan in
bf16 departs from gru_scan in fp32 by 11-65 % of the largest magnitude
(the plain version by 0.5-11 %); on one with |h| about 2 the reference's
dh0 departs from fp32's by 4.3 % and the plain version's by 1.9 %, so the
plain version stands 3.5 % from the bf16 reference.
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
SIG = ('sigmoid', 'tanh')
CASES = {
    # (activations (gate, candidate), reverse, lengths, with bias,
    #  with dhidden)
    'ragged': (SIG, False, LENS, True, True),
    'reverse': (SIG, True, LENS, True, True),
    'relu-identity': (('relu', 'identity'), False, LENS, True, True),
    'tanh-sigmoid_reverse': (('tanh', 'sigmoid'), True, LENS, True, True),
    'identity-relu': (('identity', 'relu'), False, LENS, True, True),
    'full_lengths': (SIG, False, [T] * B, True, True),
    'no_lengths': (SIG, True, None, True, True),
    'all_padding': (SIG, False, [0] * B, True, True),
    'no_bias': (SIG, False, LENS, False, True),
    'no_dhidden': (SIG, True, LENS, True, False),
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
    """x, w, bias, h0 and the output's cotangent, drawn as
    tests/test_torch_rnn.py draws a GRU's (a c0 slot drawn and dropped)."""
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(B, T, 3 * D) * 0.5, rng.randn(D, 3 * D) * 0.3,
              rng.randn(3 * D) * 0.1, rng.randn(B, D) * 0.5,
              rng.randn(B, D) * 0.5][:4]
    return [a.astype('f') for a in arrays], rng.randn(B, T, D).astype('f')


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_gru_seq_references_match_gru_scan(case, dtype):
    acts, reverse, lens, with_bias, with_dh = CASES[case]
    (x, w, bias, h0), dh = _inputs(0)
    if not with_bias:
        bias = np.zeros_like(bias)
    if not with_dh:
        dh = np.zeros_like(dh)
    jd = jnp.bfloat16 if dtype == 'bf16' else jnp.float32
    td = torch.bfloat16 if dtype == 'bf16' else torch.float32
    length = None if lens is None else jnp.asarray(lens, jnp.int32)

    def f(x, w, b, h0):
        return J.gru_scan(x, w, b.reshape(1, -1), h0, length,
                          gate_act=J._ACTS[acts[0]],
                          cand_act=J._ACTS[acts[1]], is_reverse=reverse)
    ref, vjp = jax.vjp(f, *[jnp.asarray(a, jd) for a in (x, w, bias, h0)])
    rdx, rdw, rdb, rdh0 = vjp(jnp.asarray(dh, jd))

    def t(a):
        return torch.tensor(a).to(td)
    lt = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    codes = tuple(K.ACTS[a] for a in acts)
    hidden, gates, rh = K.gru_seq_fwd_reference(
        t(x), t(w), t(bias) if with_bias else None, t(h0), lt, codes,
        reverse)
    dx, dh0 = K.gru_seq_bwd_reference(
        t(dh) if with_dh else None, t(w), gates, hidden, t(h0), lt, codes,
        reverse)
    prev = K._previous(t(h0), hidden, reverse).reshape(-1, D)
    dx2 = dx.reshape(-1, 3 * D)
    dw = torch.cat([torch.mm(prev.t(), dx2[:, :2 * D]),
                    torch.mm(rh.reshape(-1, D).t(), dx2[:, 2 * D:])], 1)
    out_tol, grad_tol = TOL[dtype]

    def f32(v):
        return np.asarray(v.float().numpy() if torch.is_tensor(v) else v,
                          np.float32)
    _close(f32(hidden), f32(ref), out_tol, 'hidden')
    grads = [('dx', dx, rdx), ('dw', dw, rdw), ('dh0', dh0, rdh0)]
    if with_bias:
        grads.append(('dbias', dx.sum((0, 1)), rdb))
    for name, got, want in grads:
        _close(f32(got), f32(want), grad_tol, name)
    if lens is not None and not any(lens):
        assert not dx.any() and torch.equal(hidden, t(h0)[:, None].expand(
            B, T, D))


# (batch, hidden, dtype) of every GRU recurrence the repository runs: the
# sequence models, the smoke's phases, the card tests, the CPU tests
RUN_SHAPES = {
    'stacked_gru_tagger': (64, 128, torch.float32),
    'srl_tagger_and_rnn_search_encoder': (64, 64, torch.float32),
    'bench_shape_bf16': (128, 128, torch.bfloat16),
    'gru_recurrence_card_vs_host': (8, 32, torch.float32),
    'phase19c_ragged': (8, 24, torch.bfloat16),
    'phase19c_odd': (37, 20, torch.float32),
    'rnn_tests': (4, 8, torch.bfloat16),
    'small_models': (8, 16, torch.float32),
    'hidden_256_fp32': (64, 256, torch.float32),
    'hidden_256_bf16': (128, 256, torch.bfloat16),
}
NO_PLAN = {
    'hidden_512_bf16': (128, 512, torch.bfloat16),
    'hidden_512_fp32': (8, 512, torch.float32),
    'hidden_1024_fp32': (8, 1024, torch.float32),
    'float16': (64, 128, torch.float16),
    'hidden_0': (8, 0, torch.float32),
}


@pytest.mark.parametrize('shape', sorted(RUN_SHAPES))
def test_gru_seq_plan_fits(shape):
    b, d, dtype = RUN_SHAPES[shape]
    plan = K.gru_seq_plan(b, d, dtype)
    assert plan is not None
    assert max(plan['smem_fwd'], plan['smem_bwd']) <= K.SEQ_SMEM_LIMIT
    assert plan['rows'] == 16
    assert 1 <= plan['cluster'] <= 8 and plan['units'] % 8 == 0
    assert (plan['cluster'] - 1) * plan['units'] < d <= \
        plan['cluster'] * plan['units']
    assert plan['threads'] == 256 and 16 * plan['units'] <= 4 * 256
    assert plan['grid'] == plan['cluster'] * -(-b // 16)


@pytest.mark.parametrize('shape', sorted(NO_PLAN))
def test_gru_seq_plan_none_past_the_limit(shape):
    assert K.gru_seq_plan(*NO_PLAN[shape]) is None


def test_gru_seq_plan_geometry():
    """The models' recurrence at hidden 128: 8 clusters of 8 CTAs (bf16 at
    batch 128), 16 units and 256 threads a CTA, the forward's and
    backward's bf16 layouts, their fp32 staging of the products and four
    mbarriers; fp32 at hidden 256, the widest plan, within 227 KB."""
    plan = K.gru_seq_plan(128, 128, torch.bfloat16)
    assert (plan['cluster'], plan['units'], plan['threads'], plan['grid']) \
        == (8, 16, 256, 64)
    assert plan['smem_fwd'] == (3 * 16 + 64) * (128 + 8) * 2 + \
        4 * 16 * 32 + 32
    assert plan['smem_bwd'] == (16 + 32) * (384 + 8) * 2 + 4 * 16 * 16 + 32
    wide = K.gru_seq_plan(64, 256, torch.float32)
    assert (wide['cluster'], wide['units']) == (8, 32)
    assert wide['smem_fwd'] == (256 * 96 + 64 * 260) * 4 + 4 * 16 * 64 + 32
    assert wide['smem_bwd'] == (768 * 32 + 32 * 772) * 4 + 4 * 16 * 32 + 32


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['fp32', 'bf16'])
def test_gru_seq_wrappers_on_cpu_take_the_plain_versions(dtype):
    (x, w, bias, h0), dh = _inputs(3)
    args = [torch.tensor(a).to(dtype) for a in (x, w, bias, h0)]
    lt = torch.tensor(LENS, dtype=torch.int32)
    before = (K.gru_seq_fwd.launches, K.gru_seq_bwd.launches,
              K.gru_cell_fwd.launches, K.gru_cell_bwd.launches)
    got = K.gru_seq_fwd(*args, lt, (0, 1), True)
    want = K.gru_seq_fwd_reference(*args, lt, (0, 1), True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    cot = torch.tensor(dh).to(dtype)
    gb = K.gru_seq_bwd(cot, args[1], got[1], got[0], args[3], lt, (0, 1),
                       True)
    wb = K.gru_seq_bwd_reference(cot, args[1], got[1], got[0], args[3], lt,
                                 (0, 1), True)
    assert all(torch.equal(a, b) for a, b in zip(gb, wb))
    assert (K.gru_seq_fwd.launches, K.gru_seq_bwd.launches,
            K.gru_cell_fwd.launches, K.gru_cell_bwd.launches) == before
    leaves = [a.clone().requires_grad_() for a in args]
    hidden = K.GruRecurrence.apply(*leaves, lt, (0, 1), True)
    assert torch.equal(hidden, got[0])
    dxs = torch.autograd.grad(hidden, leaves[0], cot)[0]
    assert torch.equal(dxs, gb[0])


def test_gru_positions_are_the_plain_cells_on_cpu():
    """gru_positions_fwd / _bwd through the wrappers (plain=False) equal
    the plain loops on CPU tensors bit for bit: a CPU tensor takes each
    cell's plain version."""
    (x, w, bias, h0), dh = _inputs(5)
    args = [torch.tensor(a) for a in (x, w, bias, h0)]
    lt = torch.tensor(LENS, dtype=torch.int32)
    got = K.gru_positions_fwd(*args, lt, (0, 1), False)
    want = K.gru_positions_fwd(*args, lt, (0, 1), False, plain=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    cot = torch.tensor(dh)
    gb = K.gru_positions_bwd(cot, args[1], got[1], got[0], args[3], lt,
                             (0, 1), False)
    wb = K.gru_positions_bwd(cot, args[1], got[1], got[0], args[3], lt,
                             (0, 1), False, plain=True)
    assert all(torch.equal(a, b) for a, b in zip(gb, wb))
