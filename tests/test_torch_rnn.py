"""The recurrent ops, port vs reference, on the CPU.

The recurrences (ops/kernels/rnn_cell.py: LstmRecurrence, GruRecurrence,
whose cells here are the CUDA kernels' plain versions) against the JAX
package's lstm_scan / gru_scan on the same numpy inputs, forward and
every gradient (x, W, bias, h0, c0), with ragged lengths (T, 0 and in
between), no lengths, reverse and every activation; then each of the six
op types through a Program of the reference's layers serialized into the
port (tests/test_torch_harness.py's run_both), fp32 and bf16 AMP; then the
plain cells against the Function and against autograd.

Tolerances, of the largest magnitude of the reference's array: fp32
outputs 1e-5 and gradients 1e-4 (the same arithmetic with sums in another
order; measured worst 3e-7 / 1.2e-6 absolute on values of order 1-7).
bf16 (the reference rounds every intermediate of a step to bf16, the
cells keep fp32 between the values they round): outputs and gradients
2^-5 (measured worst 1.1 % / 1.5 % for the LSTM, 2.2 % / 2.8 % for the
GRU with an identity gate and a relu candidate, whose values grow without
a bound).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops import rnn_ops as J

from paddle_tpu_torch.ops.kernels import rnn_cell as K

from test_torch_harness import run_both

B, T, D = 4, 6, 8
LENS = np.array([6, 0, 3, 1], np.int32)
LSTM_ACTS = [('sigmoid', 'tanh', 'tanh'), ('tanh', 'relu', 'identity'),
             ('identity', 'sigmoid', 'relu'), ('relu', 'identity', 'sigmoid')]
GRU_ACTS = [('sigmoid', 'tanh'), ('relu', 'identity'), ('tanh', 'sigmoid'),
            ('identity', 'relu')]
TOL = {'fp32': (1e-5, 1e-4), 'bf16': (2.0 ** -5, 2.0 ** -5)}


def _close(got, want, rel, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all() and np.isfinite(want).all(), what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, '%s: %.3g > %.3g x %.3g' % (what, err, rel,
                                                          scale)


def _inputs(kind, seed):
    rng = np.random.RandomState(seed)
    g = 4 if kind == 'lstm' else 3
    arrays = [rng.randn(B, T, g * D) * 0.5, rng.randn(D, g * D) * 0.3,
              rng.randn(g * D) * 0.1, rng.randn(B, D) * 0.5,
              rng.randn(B, D) * 0.5][:5 if kind == 'lstm' else 4]
    cots = [rng.randn(B, T, D) for _ in range(2 if kind == 'lstm' else 1)]
    return [a.astype('f') for a in arrays], [c.astype('f') for c in cots]


def _recurrence(kind, acts, reverse, dtype, lens, seed=0):
    """(reference outputs, reference grads, port outputs, port grads)."""
    arrays, cots = _inputs(kind, seed)
    jd = jnp.bfloat16 if dtype == 'bf16' else jnp.float32
    td = torch.bfloat16 if dtype == 'bf16' else torch.float32
    length = None if lens is None else jnp.asarray(lens)
    if kind == 'lstm':
        def f(x, w, b, h0, c0):
            return J.lstm_scan(x, w, b.reshape(1, -1), h0, c0, length,
                               gate_act=J._ACTS[acts[0]],
                               cell_act=J._ACTS[acts[1]],
                               cand_act=J._ACTS[acts[2]], is_reverse=reverse)
    else:
        def f(x, w, b, h0):
            return (J.gru_scan(x, w, b.reshape(1, -1), h0, length,
                               gate_act=J._ACTS[acts[0]],
                               cand_act=J._ACTS[acts[1]],
                               is_reverse=reverse),)
    ref, vjp = jax.vjp(f, *[jnp.asarray(a, jd) for a in arrays])
    rgrads = vjp(tuple(jnp.asarray(c, jd) for c in cots))
    ts = [torch.tensor(a).to(td).requires_grad_() for a in arrays]
    lt = None if lens is None else torch.tensor(lens)
    codes = tuple(K.ACTS[a] for a in acts)
    if kind == 'lstm':
        got = K.LstmRecurrence.apply(*ts, lt, codes, reverse)
    else:
        got = (K.GruRecurrence.apply(*ts, lt, codes, reverse),)
    grads = torch.autograd.grad(got, ts, [torch.tensor(c).to(td)
                                          for c in cots])
    f32 = (lambda v: np.asarray(v, np.float32))
    return ([f32(r) for r in ref], [f32(g) for g in rgrads],
            [o.detach().float().numpy() for o in got],
            [g.float().numpy() for g in grads])


def _check(kind, acts, reverse, dtype, lens):
    ref, rgrads, got, grads = _recurrence(kind, acts, reverse, dtype, lens)
    out_tol, grad_tol = TOL[dtype]
    for name, g, r in zip(('hidden', 'cell'), got, ref):
        _close(g, r, out_tol, name)
    for name, g, r in zip(('x', 'w', 'bias', 'h0', 'c0'), grads, rgrads):
        _close(g, r, grad_tol, 'd' + name)


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('reverse', [False, True], ids=['forward', 'reverse'])
@pytest.mark.parametrize('acts', LSTM_ACTS, ids='-'.join)
def test_lstm_recurrence_matches_lstm_scan(acts, reverse, dtype):
    _check('lstm', acts, reverse, dtype, LENS)


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('reverse', [False, True], ids=['forward', 'reverse'])
@pytest.mark.parametrize('acts', GRU_ACTS, ids='-'.join)
def test_gru_recurrence_matches_gru_scan(acts, reverse, dtype):
    _check('gru', acts, reverse, dtype, LENS)


@pytest.mark.parametrize('kind', ['lstm', 'gru'])
@pytest.mark.parametrize('reverse', [False, True], ids=['forward', 'reverse'])
def test_recurrence_without_lengths(kind, reverse):
    acts = LSTM_ACTS[0] if kind == 'lstm' else GRU_ACTS[0]
    _check(kind, acts, reverse, 'fp32', None)


@pytest.mark.parametrize('kind', ['lstm', 'gru'])
@pytest.mark.parametrize('reverse', [False, True], ids=['forward', 'reverse'])
def test_padding_carries_the_state(kind, reverse):
    """A row of length 0 repeats h0 (and c0) at every position, and only
    its h0 (c0) gradient is nonzero; a forward row's positions past its
    length repeat its last state; a reverse row walks the padding first,
    carrying h0 there."""
    acts = LSTM_ACTS[0] if kind == 'lstm' else GRU_ACTS[0]
    arrays, _ = _inputs(kind, 3)
    _, _, got, grads = _recurrence(kind, acts, reverse, 'fp32', LENS, 3)
    h, h0 = got[0], arrays[3]
    np.testing.assert_array_equal(h[1], np.broadcast_to(h0[1], (T, D)))
    np.testing.assert_array_equal(grads[0][1], 0.0)
    assert np.abs(grads[3][1]).max() > 0
    n = LENS[2]
    if reverse:
        np.testing.assert_array_equal(h[2, n:], np.broadcast_to(h0[2],
                                                                (T - n, D)))
    else:
        np.testing.assert_array_equal(h[2, n:], np.broadcast_to(h[2, n - 1],
                                                                (T - n, D)))
    if kind == 'lstm':
        np.testing.assert_array_equal(got[1][1], np.broadcast_to(
            arrays[4][1], (T, D)))


@pytest.mark.parametrize('kind', ['lstm', 'gru'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['fp32', 'bf16'])
def test_plain_cells_step_the_recurrence(kind, dtype):
    """The Function's forward is its plain cell stepped over the positions
    in reverse order, the product hp @ W before each, bit for bit."""
    arrays, _ = _inputs(kind, 5)
    ts = [torch.tensor(a).to(dtype) for a in arrays]
    lt = torch.tensor(LENS)
    x, w, bias, h0 = ts[:4]
    if kind == 'lstm':
        acts = (0, 1, 1)
        hidden, cell = K.LstmRecurrence.apply(*ts, lt, acts, True)
        hp, cp = h0, ts[4]
        for p in range(T - 1, -1, -1):
            m = K.step_mask(lt, p, B, x.device)
            hp, cp, _ = K.lstm_cell_reference(x[:, p], hp @ w, bias, hp, cp,
                                              m, acts, dtype)
            assert torch.equal(hidden[:, p], hp)
            assert torch.equal(cell[:, p], cp)
    else:
        acts = (0, 1)
        hidden = K.GruRecurrence.apply(*ts, lt, acts, True)
        hp = h0
        for p in range(T - 1, -1, -1):
            m = K.step_mask(lt, p, B, x.device)
            ur, rh = K.gru_cell_reference(0, x[:, p], bias, hp @ w[:, :2 * D],
                                          hp, None, m, acts, dtype)
            _, hp = K.gru_cell_reference(1, x[:, p], bias,
                                         rh @ w[:, 2 * D:], hp, ur, m, acts,
                                         dtype)
            assert torch.equal(hidden[:, p], hp)


@pytest.mark.parametrize('acts', LSTM_ACTS, ids='-'.join)
def test_lstm_cell_backward_is_autograd_of_its_forward(acts):
    """The plain backward cell at fp32 equals autograd through the plain
    forward cell (rtol 1e-6), at a masked and an unmasked row; the carries
    it hands on are the gradients of h_prev's pass-through and c_prev."""
    codes = tuple(K.ACTS[a] for a in acts)
    rng = np.random.RandomState(7)
    x, hw, hp, cp = (torch.tensor(rng.randn(*s).astype('f')) for s in
                     ((B, 4 * D), (B, 4 * D), (B, D), (B, D)))
    bias = torch.tensor(rng.randn(4 * D).astype('f'))
    m = torch.tensor([[1.0], [0.0], [1.0], [1.0]])
    dh, dc = (torch.tensor(rng.randn(B, D).astype('f')) for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (x, hp, cp)]
    h, c, gates = K.lstm_cell_reference(leaves[0], hw, bias, leaves[1],
                                        leaves[2], m, codes, torch.float32)
    want = torch.autograd.grad((h, c), leaves, (dh, dc))
    da, dh_pass, dc_prev = K.lstm_cell_reference_bwd(
        dh, dc, None, torch.zeros(B, D), torch.zeros(B, D), gates.detach(),
        c.detach(), cp, m, codes, torch.float32)
    np.testing.assert_allclose(da, want[0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(dh_pass, want[1], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(dc_prev, want[2], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('acts', GRU_ACTS, ids='-'.join)
def test_gru_cell_backward_is_autograd_of_its_forward(acts):
    """The two plain backward phases at fp32 against autograd through the
    two forward phases (rtol 1e-6): the pre-activations' gradients, the
    carry (the gradient of h_prev outside the products) and drh."""
    codes = tuple(K.ACTS[a] for a in acts)
    rng = np.random.RandomState(8)
    x = torch.tensor(rng.randn(B, 3 * D).astype('f'))
    hp = torch.tensor(rng.randn(B, D).astype('f'))
    w = torch.tensor(rng.randn(D, 3 * D).astype('f') * 0.3)
    m = torch.tensor([[1.0], [0.0], [1.0], [1.0]])
    dh = torch.tensor(rng.randn(B, D).astype('f'))
    xl, hl = x.clone().requires_grad_(), hp.clone().requires_grad_()
    ur, rh = K.gru_cell_reference(0, xl, None, hl @ w[:, :2 * D], hl, None,
                                  m, codes, torch.float32)
    c, h = K.gru_cell_reference(1, xl, None, rh @ w[:, 2 * D:], hl, ur, m,
                                codes, torch.float32)
    want = torch.autograd.grad(h, (xl, hl), dh)
    gates = torch.cat([ur, c], -1).detach()
    (da_u, da_c), carry = K.gru_cell_reference_bwd(
        0, dh, None, torch.zeros(B, D), gates, hp, m, codes, torch.float32)
    drh = da_c @ w[:, 2 * D:].t()
    da_r, carry = K.gru_cell_reference_bwd(1, None, drh, carry, gates, hp, m,
                                           codes, torch.float32)
    dx = torch.cat([da_u, da_r, da_c], -1)
    np.testing.assert_allclose(dx, want[0], rtol=1e-6, atol=1e-7)
    dhp = carry + torch.cat([da_u, da_r], -1) @ w[:, :2 * D].t()
    np.testing.assert_allclose(dhp, want[1], rtol=1e-5, atol=1e-6)


# ------------------------------------------------- the op types, by program
def _seq_feed(g, unit, seed=11):
    """x [B, T, g D] (one step's [B, g D] for a unit op), h0, c0 and,
    but for a unit op, the lengths."""
    rng = np.random.RandomState(seed)
    shape = (B, g * D) if unit else (B, T, g * D)
    feed = {'x': (rng.randn(*shape) * 0.5).astype('f'),
            'h0': (rng.randn(B, D) * 0.5).astype('f'),
            'c0': (rng.randn(B, D) * 0.5).astype('f')}
    if not unit:
        feed['len'] = LENS.astype('int64')
    return feed


def _lstm(L, v, reverse=False, acts=LSTM_ACTS[0]):
    return L.dynamic_lstm(v['x'], 4 * D, h_0=v['h0'], c_0=v['c0'],
                          is_reverse=reverse, gate_activation=acts[0],
                          cell_activation=acts[1],
                          candidate_activation=acts[2], use_peepholes=True,
                          length=v.get('len'))


def _gru(L, v, reverse=False, acts=GRU_ACTS[0]):
    return L.dynamic_gru(v['x'], D, h_0=v['h0'], is_reverse=reverse,
                         gate_activation=acts[0],
                         candidate_activation=acts[1], length=v.get('len'))


OPS = {
    'lstm': (lambda L, v: _lstm(L, v), 4),
    'lstm_reverse_relu': (lambda L, v: _lstm(L, v, True, LSTM_ACTS[1]), 4),
    'gru': (lambda L, v: _gru(L, v), 3),
    'gru_reverse_relu': (lambda L, v: _gru(L, v, True, GRU_ACTS[1]), 3),
    'simple_rnn': (lambda L, v: L.simple_rnn(v['x'], length=v.get('len'),
                                             h_0=v['h0']), 1),
    'simple_rnn_reverse_relu': (lambda L, v: L.simple_rnn(
        v['x'], act='relu', is_reverse=True, length=v.get('len')), 1),
    'lstmp': (lambda L, v: L.dynamic_lstmp(v['x'], 4 * D, 5,
                                           length=v.get('len')), 4),
    'lstmp_reverse': (lambda L, v: L.dynamic_lstmp(
        v['x'], 4 * D, 5, is_reverse=True, proj_activation='identity',
        length=v.get('len')), 4),
    'lstm_unit': (lambda L, v: L.lstm_unit(v['x'], v['h0'], v['c0'],
                                           forget_bias=1.0), 1),
    'gru_unit': (lambda L, v: L.gru_unit(v['x'], v['h0'], 3 * D), 3),
}


@pytest.mark.parametrize('amp', [None, 'bf16'], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('case', sorted(OPS))
def test_op_types_through_programs(case, amp):
    """Every output of the case's ops and every feed's gradient, the
    reference's program run by both packages (run_both), at the
    tolerances above; lstm and gru with H0 / C0 and lengths."""
    build, g = OPS[case]
    feed = _seq_feed(g, case.endswith('unit'))
    names, ref, got, _, _ = run_both(build, feed, amp)
    out_tol, grad_tol = TOL['bf16' if amp else 'fp32']
    for (op_type, name), r, p in zip(names, ref, got):
        if np.asarray(r).dtype.kind not in 'fV' and \
                np.asarray(r).dtype.name != 'bfloat16':
            np.testing.assert_array_equal(p, r, name)
            continue
        _close(np.asarray(p, np.float32), np.asarray(r, np.float32),
               grad_tol if op_type == '@GRAD' else out_tol,
               '%s %s' % (op_type, name))
