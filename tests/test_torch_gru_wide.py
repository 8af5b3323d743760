"""The wide GRU kernels' launch plan, routing and plain versions, on the
CPU.

ops/kernels/rnn_cell.py's gru_wide_plan (csrc/gru_wide.cu's geometry: W
spread over the card's SMs, 16 rows and a slice of the units a CTA): at
the GRU models' shapes at hidden 512 every unit is owned once, each CTA's
forward and backward bytes fit 227 KB, the grid stays within one CTA an
SM, and past its reach the plan is None. gru_path's three-way routing
(the cluster's plan, else the wide one, else the cells). The plain
versions the wide kernels are held against on the card
(gru_seq_fwd_reference / gru_seq_bwd_reference) against the JAX package's
gru_scan and its VJP at hidden 512, at tests/test_torch_gru_seq.py's
tolerances: fp32 outputs 1e-5 and gradients 1e-4 of the largest
magnitude (sums in another order), bf16 2^-5 (the reference rounds every
intermediate of a step to bf16). Then the wrappers and GruRecurrence on
CPU tensors at 512: the plain versions bit for bit, no launch counted.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops import rnn_ops as J

from paddle_tpu_torch.ops.kernels import rnn_cell as K

B, T, D = 4, 5, 512
LENS = [5, 0, 3, 1]
TOL = {'fp32': (1e-5, 1e-4), 'bf16': (2.0 ** -5, 2.0 ** -5)}
CASES = {
    # (reverse, lengths, with bias, with dhidden)
    'ragged': (False, LENS, True, True),
    'reverse': (True, LENS, True, True),
    'no_bias': (False, LENS, False, True),
    'no_dhidden': (True, LENS, True, False),
}

# (batch, hidden, dtype) of the GRU recurrences that run on the wide
# kernels: rnn_search's encoder and stacked_gru_tagger at hidden 512
# (batch 64, fp32 and bf16 AMP), the card tests' and the smoke's
# recurrence at batch 8, and the smoke's odd case (37 rows, hidden 500)
WIDE_SHAPES = {
    'rnn_search_fp32': (64, 512, torch.float32),
    'rnn_search_bf16': (64, 512, torch.bfloat16),
    'card_vs_host': (8, 512, torch.float32),
    'odd_rows_and_width': (37, 500, torch.bfloat16),
    'batch_128_bf16': (128, 512, torch.bfloat16),
}
NO_WIDE_PLAN = {
    'hidden_1024_fp32': (8, 1024, torch.float32),
    'hidden_1024_batch_64': (64, 1024, torch.float32),
    'hidden_1024_bf16': (64, 1024, torch.bfloat16),
    'batch_128_fp32': (128, 512, torch.float32),
    'grid_past_the_sms': (1024, 512, torch.bfloat16),
    'float16': (64, 512, torch.float16),
    'hidden_0': (8, 0, torch.float32),
    'batch_0': (0, 512, torch.float32),
}


@pytest.mark.parametrize('shape', sorted(WIDE_SHAPES))
def test_gru_wide_plan_fits(shape):
    b, d, dtype = WIDE_SHAPES[shape]
    plan = K.gru_wide_plan(b, d, dtype)
    assert plan is not None
    assert plan['rows'] == 16 and plan['threads'] == 256
    assert plan['groups'] == -(-b // 16)
    assert plan['units'] in (8, 16, 32, 64)
    # every unit owned once: the slices cover d, none of them empty
    assert (plan['slices'] - 1) * plan['units'] < d <= \
        plan['slices'] * plan['units']
    assert plan['grid'] == plan['groups'] * plan['slices'] <= 132
    assert max(plan['smem_fwd'], plan['smem_bwd']) <= K.SEQ_SMEM_LIMIT
    # pairs of CTAs share the staging where the slices pair up and a row
    # is 16-byte aligned (the bulk copies' unit)
    elt = 2 if dtype == torch.bfloat16 else 4
    assert plan['cluster'] == (2 if plan['slices'] % 2 == 0 and
                               d * elt % 16 == 0 else 1)
    # the fewest units that keep the grid within the SMs
    if plan['units'] > 8:
        assert plan['groups'] * -(-d // (plan['units'] // 2)) > 132


@pytest.mark.parametrize('shape', sorted(NO_WIDE_PLAN))
def test_gru_wide_plan_none_past_its_reach(shape):
    assert K.gru_wide_plan(*NO_WIDE_PLAN[shape]) is None


def test_gru_wide_plan_geometry():
    """64 x 512: 4 row groups x 32 CTAs of 16 units, 128 CTAs in pairs;
    fp32 holds W's 48 columns over 512 (98,304 B) and one [16, 512 + 4]
    staging buffer forward, W's 16 rows over 3 x 512 and one [16, 2 x 512
    + 4] buffer backward, then the widest product's fp32 pieces (2 depth
    slices of 4 n-tiles forward, 4 of 2 backward: 4,096 B) and an
    mbarrier; bf16 the n-major rows padded by 8."""
    parts = 4096 + 16
    fp32 = K.gru_wide_plan(64, 512, torch.float32)
    assert (fp32['groups'], fp32['slices'], fp32['units'], fp32['grid'],
            fp32['cluster']) == (4, 32, 16, 128, 2)
    assert fp32['smem_fwd'] == 512 * 48 * 4 + 16 * 516 * 4 + parts == \
        135440
    assert fp32['smem_bwd'] == 1536 * 16 * 4 + 16 * 1028 * 4 + parts == \
        168208
    bf16 = K.gru_wide_plan(64, 512, torch.bfloat16)
    assert (bf16['units'], bf16['cluster']) == (16, 2)
    assert bf16['smem_fwd'] == (48 + 16) * 520 * 2 + parts
    assert bf16['smem_bwd'] == (16 * 1544 + 16 * 1032) * 2 + parts


@pytest.mark.parametrize('shape,path', [
    ((64, 128, torch.float32), 'seq'),
    ((8, 32, torch.float32), 'seq'),
    ((64, 256, torch.float32), 'seq'),
    ((64, 512, torch.float32), 'wide'),
    ((64, 512, torch.bfloat16), 'wide'),
    ((8, 512, torch.float32), 'wide'),
    ((8, 1024, torch.float32), 'cells'),
    ((64, 1024, torch.float32), 'cells'),
], ids=lambda v: v if isinstance(v, str) else '%dx%d_%s' % (
    v[0], v[1], str(v[2])[6:]))
def test_gru_path_routes_seq_then_wide_then_cells(shape, path):
    """The cluster's kernels where gru_seq_plan fits (still the faster
    design), else the wide ones, else the cells; the GRU models' hidden
    512 takes the wide kernels, and a width past both plans the cells."""
    assert K.gru_path(*shape) == path
    assert (K.gru_seq_plan(*shape) is not None) == (path == 'seq')


def _inputs(seed):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(B, T, 3 * D) * 0.5,
              rng.randn(D, 3 * D) * 0.3 / np.sqrt(D / 8.0),
              rng.randn(3 * D) * 0.1, rng.randn(B, D) * 0.5]
    return [a.astype('f') for a in arrays], rng.randn(B, T, D).astype('f')


def _close(got, want, rel, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all() and np.isfinite(want).all(), what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, '%s: %.3g > %.3g x %.3g' % (what, err, rel,
                                                          scale)


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_gru_wide_references_match_gru_scan_at_512(case, dtype):
    reverse, lens, with_bias, with_dh = CASES[case]
    (x, w, bias, h0), dh = _inputs(0)
    if not with_bias:
        bias = np.zeros_like(bias)
    if not with_dh:
        dh = np.zeros_like(dh)
    jd = jnp.bfloat16 if dtype == 'bf16' else jnp.float32
    td = torch.bfloat16 if dtype == 'bf16' else torch.float32
    length = jnp.asarray(lens, jnp.int32)

    def f(x, w, b, h0):
        return J.gru_scan(x, w, b.reshape(1, -1), h0, length,
                          is_reverse=reverse)
    ref, vjp = jax.vjp(f, *[jnp.asarray(a, jd) for a in (x, w, bias, h0)])
    rdx, rdw, rdb, rdh0 = vjp(jnp.asarray(dh, jd))

    def t(a):
        return torch.tensor(a).to(td)
    lt = torch.tensor(lens, dtype=torch.int32)
    hidden, gates, rh = K.gru_seq_fwd_reference(
        t(x), t(w), t(bias) if with_bias else None, t(h0), lt, (0, 1),
        reverse)
    dx, dh0 = K.gru_seq_bwd_reference(
        t(dh) if with_dh else None, t(w), gates, hidden, t(h0), lt, (0, 1),
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
    # the length-0 row keeps h0 and passes its gradient through untouched
    np.testing.assert_array_equal(f32(hidden[1]), f32(t(h0)[1:2].expand(
        T, D)))
    assert not dx[1].any()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['fp32', 'bf16'])
def test_gru_wide_wrappers_and_recurrence_on_cpu_take_the_plain_path(dtype):
    """gru_wide_fwd / gru_wide_bwd on CPU tensors are the plain versions
    bit for bit, and GruRecurrence at hidden 512 on the CPU runs them:
    no kernel's launch is counted."""
    (x, w, bias, h0), dh = _inputs(3)
    args = [torch.tensor(a).to(dtype) for a in (x, w, bias, h0)]
    lt = torch.tensor(LENS, dtype=torch.int32)
    counters = (K.gru_wide_fwd, K.gru_wide_bwd, K.gru_seq_fwd, K.gru_seq_bwd,
                K.gru_cell_fwd, K.gru_cell_bwd)
    before = [c.launches for c in counters]
    got = K.gru_wide_fwd(*args, lt, (0, 1), True)
    want = K.gru_seq_fwd_reference(*args, lt, (0, 1), True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    cot = torch.tensor(dh).to(dtype)
    gb = K.gru_wide_bwd(cot, args[1], got[1], got[0], args[3], lt, (0, 1),
                        True)
    wb = K.gru_seq_bwd_reference(cot, args[1], got[1], got[0], args[3], lt,
                                 (0, 1), True)
    assert all(torch.equal(a, b) for a, b in zip(gb, wb))
    leaves = [a.clone().requires_grad_() for a in args]
    hidden = K.GruRecurrence.apply(*leaves, lt, (0, 1), True)
    assert torch.equal(hidden, got[0])
    dxs = torch.autograd.grad(hidden, leaves[0], cot)[0]
    assert torch.equal(dxs, gb[0])
    assert [c.launches for c in counters] == before


def test_gru_wide_counters_are_read_by_the_smoke():
    """Both wide kernels' counts are among the port's launch counters,
    and the smoke's expected launches take the three-way routing."""
    import chip_smoke
    from paddle_tpu_torch.ops.kernels import launch_counters
    names = [n for n, _, _ in launch_counters()]
    assert 'gru_wide_fwd' in names and 'gru_wide_bwd' in names
    want = chip_smoke.recurrence_want(torch, 'gru', 64, 100, 512, times=6)
    assert want == chip_smoke.rnn_want(gru_wides=6)
    assert chip_smoke.recurrence_want(torch, 'gru', 64, 100, 1024) == \
        chip_smoke.rnn_want(gru_steps=100)
    assert chip_smoke.recurrence_want(torch, 'gru', 64, 100, 128) == \
        chip_smoke.rnn_want(gru_seqs=1)
