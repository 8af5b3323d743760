"""The Switch-MoE slice, port vs reference: the slot-form switch_moe
against the JAX package's dense switch_moe_reference and the port's own
plain copy of it, the MoE LM (unrolled and scan_layers) trained in both
packages from the same weights, the scan against the unrolled program,
the programs and parameter marks, the weights carried across, and a mesh
refused.

Tolerances: fp32 values and gradients rtol 1e-5, atol 1e-6 against the
reference (the same sums in another order), 1e-6 / 1e-7 against the
port's plain copy; bf16 (tokens and expert weights, the router fp32) 4
bf16 ulps of an array's largest magnitude (the hidden layer, the experts'
output and the combine are rounded to bf16 after sums XLA and torch order
differently); the LM's losses rtol 1e-5 at fp32 and 1e-2 under bf16 AMP
(the port rounds each op's gradient to bf16, the reference keeps its
cotangents in fp32 inside one XLA computation).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as fluid
from paddle_tpu.models import moe as JM
from paddle_tpu.ops.moe_ops import switch_moe_reference as jax_moe

import paddle_tpu_torch as pt
from paddle_tpu_torch.models import moe as PM
from paddle_tpu_torch.ops import moe_ops as M
from paddle_tpu_torch.weights import load_into_scope

# tests/test_moe.py's sizes: capacity 3 binds for some experts
S, D, E, H, CAP = 16, 8, 4, 12, 3
NAMES = ('x', 'gate_w', 'w1', 'b1', 'w2', 'b2')


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(S, D).astype('f'), rng.randn(D, E).astype('f'),
            (rng.randn(E, D, H) * 0.3).astype('f'),
            (rng.randn(E, H) * 0.1).astype('f'),
            (rng.randn(E, H, D) * 0.3).astype('f'),
            (rng.randn(E, D) * 0.1).astype('f')]


def _cotangent():
    return np.random.RandomState(9).randn(S, D).astype('f')


def _jax_run(arrays, k, bf16):
    """The reference's (out, aux, ids) and the gradients of
    sum(out * c) + aux with respect to every input."""
    c = jnp.asarray(_cotangent())
    args = [jnp.asarray(a) for a in arrays]
    if bf16:
        args = [a if i == 1 else a.astype(jnp.bfloat16)
                for i, a in enumerate(args)]

    def loss(*a):
        out, aux, _ = jax_moe(*a, CAP, k=k)
        return jnp.sum(out.astype(jnp.float32) * c) + aux
    out, aux, ids = jax_moe(*args, CAP, k=k)
    grads = jax.grad(loss, argnums=tuple(range(6)))(*args)
    return [np.asarray(out.astype(jnp.float32)), float(aux),
            np.asarray(ids)], [np.asarray(g.astype(jnp.float32))
                               for g in grads]


def _port_run(fn, arrays, k, bf16):
    ts = [torch.tensor(a) for a in arrays]
    if bf16:
        ts = [t if i == 1 else t.to(torch.bfloat16)
              for i, t in enumerate(ts)]
    ts = [t.requires_grad_() for t in ts]
    res = fn(*ts, CAP, k)
    out, aux, ids = res[0], res[1], res[2]
    loss = (out.float() * torch.tensor(_cotangent())).sum() + aux
    grads = torch.autograd.grad(loss, ts)
    return [out.detach().float().numpy(), float(aux), ids.numpy()], \
        [g.float().numpy() for g in grads]


def _close(got, want, bf16, rtol=1e-5, atol=1e-6, what=''):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want), what)
    fin = np.isfinite(want)
    if not fin.any():
        return
    if bf16:
        bound = 4 * 2.0 ** -8 * np.abs(want[fin]).max()
        assert np.abs(got[fin] - want[fin]).max() <= bound, what
    else:
        np.testing.assert_allclose(got[fin], want[fin], rtol=rtol,
                                   atol=atol, err_msg=what)


@pytest.mark.parametrize('bf16', [False, True], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('k', [1, 2])
def test_slots_match_the_reference(k, bf16):
    """The slot form against the reference's dense einsums: the output,
    the aux loss, the expert ids (exactly) and the gradients of x, gate_w,
    w1, b1, w2 and b2."""
    arrays = _inputs()
    (rout, raux, rids), rgrads = _jax_run(arrays, k, bf16)
    (out, aux, ids), grads = _port_run(M.switch_moe_slots, arrays, k, bf16)
    np.testing.assert_array_equal(ids, rids)
    _close(out, rout, bf16, what='out')
    _close(aux, raux, bf16, what='aux')
    for name, g, r in zip(NAMES, grads, rgrads):
        _close(g, r, bf16, what=name)


@pytest.mark.parametrize('k', [1, 2])
def test_slots_match_the_plain_copy(k):
    """The slot form against the port's plain version (the reference's
    einsums in torch), fp32, rtol 1e-6; and the capacity binds: some
    assignment is dropped (its slot the spare row)."""
    arrays = _inputs(1)
    (out, aux, ids), grads = _port_run(M.switch_moe_slots, arrays, k, False)
    (pout, paux, pids), pgrads = _port_run(M.switch_moe_reference, arrays,
                                           k, False)
    np.testing.assert_array_equal(ids, pids)
    np.testing.assert_allclose(out, pout, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(aux, paux, rtol=1e-6)
    for name, g, p in zip(NAMES, grads, pgrads):
        np.testing.assert_allclose(g, p, rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    slots = M.route(torch.tensor(ids), E, CAP)
    assert (slots == E * CAP).any()
    kept = slots[slots < E * CAP]
    assert kept.unique().numel() == kept.numel()


def test_route_fills_choice_major():
    """Every first choice takes its slot before any second choice: a
    second choice is kept only where its expert has room after all the
    first choices."""
    ids = torch.tensor([[0, 1], [0, 2], [1, 0], [0, 1]])
    slots = M.route(ids, 3, 2).tolist()
    # first choices: expert 0 takes tokens 0, 1 (token 3 dropped), expert
    # 1 token 2; second choices: expert 1 has one slot left (token 0),
    # expert 2 two (token 1), expert 0 none (token 2 dropped)
    assert slots == [[0, 3], [1, 4], [2, 6], [6, 6]]


@pytest.mark.parametrize('k', [1, 2])
def test_nan_feed_spreads_as_the_dense_form(k):
    """A NaN token: the dense einsums turn every output and every gradient
    NaN where the reference's do; the slot form's zero-weighted sums give
    the same NaN places in the output, the aux loss and the gradients of
    x, gate_w, w1, b1, w2 and b2, the finite values within fp32's rtol."""
    arrays = _inputs(2)
    arrays[0][3, 2] = np.nan
    (rout, raux, _), rgrads = _jax_run(arrays, k, False)
    (out, aux, _), grads = _port_run(M.switch_moe_slots, arrays, k, False)
    assert np.isnan(rout).all() and np.isnan(raux)
    _close(out, rout, False, what='out')
    _close(aux, raux, False, what='aux')
    for name, g, r in zip(NAMES, grads, rgrads):
        _close(g, r, False, what=name)


@pytest.mark.parametrize('k', [1, 2])
def test_inf_feed(k):
    """An inf token (and no NaN): the output, the aux loss and the
    gradients of x, gate_w, w1, b1, w2 and b2 have the reference's NaN
    and inf places. The dense dispatch gives the inf token's own slot inf
    (1 * inf plus the other tokens' 0 * x) and every other slot of its
    column NaN; the slot form counts a column's non-finite tokens other
    than the slot's own, forward and backward."""
    arrays = _inputs(2)
    arrays[0][5, 1] = np.inf
    (rout, raux, _), rgrads = _jax_run(arrays, k, False)
    (out, aux, _), grads = _port_run(M.switch_moe_slots, arrays, k, False)
    _close(out, rout, False, what='out')
    _close(aux, raux, False, what='aux')
    for name, g, r in zip(NAMES, grads, rgrads):
        _close(g, r, False, what=name)


def test_relu_gradient_is_a_select():
    """The relu op's gradient, which the experts' FFN uses too, is
    jax.nn.relu's, select(x > 0, g, 0): 0 at x <= 0 and at a NaN x even
    where the incoming gradient is NaN or inf (the NaN feed above needs
    it: its cotangents through the experts' ReLU are NaN), g where
    x > 0."""
    from paddle_tpu_torch.ops import pointwise
    assert M.relu is pointwise.relu
    x = np.array([-1.0, 0.0, -0.0, np.nan, 2.0, 3.0, -4.0, 5.0], 'f')
    g = np.array([np.nan, np.inf, -np.inf, np.nan, np.nan, 1.5, 2.0,
                  -np.inf], 'f')
    _, vjp = jax.vjp(jax.nn.relu, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    t = torch.tensor(x, requires_grad=True)
    got = torch.autograd.grad(pointwise.relu(t), t, torch.tensor(g))[0]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[[0, 1, 2, 3, 6]], 0.0)


class _Ops(TorchDispatchMode):
    """Every aten op run, with its output shapes."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else [out]
        self.seen.append((str(func.overloadpacket.__name__),
                          [tuple(o.shape) for o in outs
                           if isinstance(o, torch.Tensor)], kwargs or {}))
        return out


@pytest.mark.parametrize('k', [1, 2])
def test_slot_form_makes_no_dispatch_tensor_and_reads_nothing(k):
    """Forward and backward: no tensor with S * E * C elements or more
    beside the [E * C + 1, D] buffer's own size, no host read (item,
    nonzero, a boolean mask index) and no float atomics (index_add, an
    accumulating index_put, scatter_add): what a CUDA graph captures and
    what repeats bit for bit."""
    ts = [torch.tensor(a).requires_grad_() for a in _inputs()]
    with _Ops() as rec:
        out, aux, _, _ = M.switch_moe_slots(*ts, CAP, k)
        torch.autograd.grad(out.sum() + aux, ts)
    names = [n for n, _, _ in rec.seen]
    assert not {'_local_scalar_dense', 'item', 'nonzero', 'index_add',
                'scatter_add', 'masked_select'} & set(names), names
    assert not any(n.startswith('index_put') and kw.get('accumulate')
                   for n, _, kw in rec.seen)
    assert 'index_copy' in names and 'bmm' in names
    for n, shapes, _ in rec.seen:
        for shape in shapes:
            assert int(np.prod(shape)) < S * E * CAP or \
                shape[-1] == D or shape[-1] == H, (n, shape)
            assert shape not in ((S, E, CAP), (S, k, E, CAP)), (n, shape)


# ------------------------------------------------------------ programs
LM = dict(n_layer=2, n_head=2, d_model=16, d_inner=32, num_experts=4)
VOCAB, SEQ = 32, 8


def _lm(pkg, model, scan, top_k=1, amp=None, opt='Adam', lr=3e-3,
        dropout=0.0):
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        avg, _ = model.switch_transformer_lm(
            VOCAB, SEQ, top_k=top_k, scan_layers=scan,
            dropout_rate=dropout, **LM)
        getattr(pkg.optimizer, opt)(learning_rate=lr).minimize(avg)
    main.amp = amp
    return main, startup, avg


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    words = rng.randint(1, VOCAB, (8, SEQ)).astype('int64')
    return {'word': words, 'label': np.roll(words, -1, axis=1)}


def _jax_startup(startup):
    scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
    return scope, {n: np.asarray(scope.find(n)) for n in scope.keys()
                   if scope.find(n) is not None}


@pytest.mark.parametrize('scan', [False, True], ids=['unrolled', 'scan'])
def test_programs_mirror_the_reference(scan):
    """The LM's main and startup programs: the same ops in the same order
    with the same slots and attrs, the same parameters (names, shapes,
    dtypes, trainable) and the expert marks (expert_shard; the stacked
    ones expert_shard_axis 1), kept across clone()."""
    for ref, got in zip(_lm(fluid, JM, scan)[:2], _lm(pt, PM, scan)[:2]):
        rops, gops = ref.global_block().ops, got.global_block().ops
        assert [op.type for op in gops] == [op.type for op in rops]
        for r, g in zip(rops, gops):
            assert (g.inputs, g.outputs) == (r.inputs, r.outputs), r.type
            assert sorted(g.attrs) == sorted(r.attrs), r.type
    jmain, pmain = _lm(fluid, JM, scan)[0], _lm(pt, PM, scan)[0]
    rp = {p.name: p for p in jmain.all_parameters()}
    for prog in (pmain, pmain.clone(), pmain.clone(for_test=True)):
        gp = {p.name: p for p in prog.all_parameters()}
        assert sorted(gp) == sorted(rp)
        for name, r in rp.items():
            g = gp[name]
            assert (g.shape, g.dtype, g.trainable) == \
                (r.shape, r.dtype, r.trainable), name
            for mark in ('expert_shard', 'expert_shard_axis'):
                assert getattr(g, mark, None) == getattr(r, mark, None), \
                    (name, mark)
    assert sum(bool(getattr(p, 'expert_shard', False))
               for p in pmain.all_parameters()) == 4 * (1 if scan else 2)


def test_switch_moe_layer_arguments():
    """switch_moe's signature, its parameter names under an explicit name
    (<base>_gate.w, _1.w, _1.b, _2.w, _2.b) and default initializers as
    the reference's, and a top_k outside [1, E] refused by both the layer
    and the LM."""
    import inspect
    assert inspect.signature(pt.layers.switch_moe) == \
        inspect.signature(fluid.layers.switch_moe)
    inits = []
    for pkg in (fluid, pt):
        pkg.reset_default_programs()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = pkg.layers.data(name='x', shape=[4, 8], dtype='float32')
            pkg.layers.switch_moe(x, 4, 16, param_attr=pkg.ParamAttr(
                name='ex'))
            with pytest.raises(ValueError, match='top_k'):
                pkg.layers.switch_moe(x, 4, 16, top_k=5)
        names = sorted(p.name for p in main.all_parameters())
        assert names == ['ex_1.b', 'ex_1.w', 'ex_2.b', 'ex_2.w',
                         'ex_gate.w']
        inits.append([(op.type, op.outputs, sorted(op.attrs.items()))
                      for op in startup.global_block().ops])
    assert inits[0] == inits[1]
    with pytest.raises(ValueError, match='top_k'):
        PM.switch_transformer_lm(VOCAB, SEQ, top_k=0, **LM)


def _train_both(scan, top_k, amp, steps=3, opt='Adam', lr=3e-3):
    jmain, jstart, javg = _lm(fluid, JM, scan, top_k, amp, opt, lr)
    jscope, init = _jax_startup(jstart)
    feed = _feed()
    jexe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(jscope):
        ref = [float(np.asarray(jexe.run(jmain, feed=feed,
                                         fetch_list=[javg])[0]).reshape(()))
               for _ in range(steps)]
    pmain, pstart, pavg = _lm(pt, PM, scan, top_k, amp, opt, lr)
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pscope):
        pexe.run(pstart)
        load_into_scope(init, pscope, pt.CPUPlace())
        got = [float(pexe.run(pmain, feed=feed,
                              fetch_list=[pavg])[0].reshape(()))
               for _ in range(steps)]
    return got, ref


@pytest.mark.parametrize('scan,top_k,amp', [
    (False, 1, None), (False, 2, None), (True, 1, None), (True, 2, None),
    (False, 1, 'bf16'), (True, 1, 'bf16')])
def test_lm_trains_as_the_reference(scan, top_k, amp):
    """3 Adam steps of the MoE LM from the reference startup's weights:
    the losses equal the reference's within rtol 1e-5 (fp32) or 1e-2
    (bf16 AMP), and they fall."""
    got, ref = _train_both(scan, top_k, amp)
    np.testing.assert_allclose(got, ref, rtol=1e-5 if amp is None else 1e-2)
    assert got[-1] < got[0]


def test_scan_matches_unrolled():
    """tests/test_moe.py's scan-vs-unrolled case in the port: the
    moe_layer_stack program from the unrolled startup's weights, stacked
    by stack_moe_trained_weights, follows the unrolled program's 3 SGD
    steps (top_k 2) within rtol 1e-4, atol 1e-5."""
    feed = _feed(9)
    kw = dict(top_k=2, opt='SGD', lr=0.3)
    umain, ustart, uavg = _lm(pt, PM, False, **kw)
    su, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    with pt.scope_guard(su):
        exe.run(ustart)
        init = {n: su.numpy(n) for n in su.keys()}
        base = [float(exe.run(umain, feed=feed, fetch_list=[uavg])[0])
                for _ in range(3)]
    smain, sstart, savg = _lm(pt, PM, True, **kw)
    ss = pt.Scope()
    with pt.scope_guard(ss):
        exe.run(sstart)
        load_into_scope(init, ss, pt.CPUPlace())
        stacked = PM.stack_moe_trained_weights(ss, LM['n_layer'])
        assert len(stacked) == 13
        got = [float(exe.run(smain, feed=feed, fetch_list=[savg])[0])
               for _ in range(3)]
    np.testing.assert_allclose(got, base, rtol=1e-4, atol=1e-5)


def test_stack_moe_trained_weights_as_the_reference():
    """The stacked names and values equal the reference's
    stack_moe_trained_weights on the same unrolled scope; a layer index
    past n_layer and a missing layer raise."""
    _, jstart, _ = _lm(fluid, JM, False)
    jscope, init = _jax_startup(jstart)
    want = JM.stack_moe_trained_weights(jscope, LM['n_layer'])
    pscope = pt.Scope()
    load_into_scope(init, pscope, pt.CPUPlace())
    got = PM.stack_moe_trained_weights(pscope, LM['n_layer'])
    assert got == want
    for name in got:
        np.testing.assert_array_equal(pscope.numpy(name),
                                      np.asarray(jscope.find(name)))
    with pytest.raises(ValueError, match='layer index'):
        PM.stack_moe_trained_weights(pscope, 1)
    short = pt.Scope()
    short.set('moe_1_slf_q.w', torch.zeros(2, 2))
    with pytest.raises(ValueError, match='missing layers'):
        PM.stack_moe_trained_weights(short, 2)


@pytest.mark.parametrize('scan', [False, True], ids=['unrolled', 'scan'])
def test_weights_carry_across(scan):
    """weights.load_into_scope carries the reference startup's values of
    the MoE LM (the unrolled names, or the stacked [L, E, ...] ones) into
    the port: every variable of the port's startup is there, at its
    shape and dtype, and equal bit for bit."""
    _, jstart, _ = _lm(fluid, JM, scan)
    _, init = _jax_startup(jstart)
    _, pstart, _ = _lm(pt, PM, scan)
    own = pt.Scope()
    with pt.scope_guard(own):
        pt.Executor(pt.CPUPlace()).run(pstart)
    scope = pt.Scope()
    load_into_scope(init, scope, pt.CPUPlace())
    assert sorted(scope.keys()) == sorted(own.keys())
    for name in own.keys():
        assert scope.find(name).shape == own.find(name).shape, name
        assert scope.find(name).dtype == own.find(name).dtype, name
        np.testing.assert_array_equal(scope.numpy(name), init[name])
    if scan:
        assert tuple(scope.find('moe_stack_1.w').shape) == \
            (LM['n_layer'], LM['num_experts'], LM['d_model'], LM['d_inner'])


@pytest.mark.parametrize('scan', [False, True], ids=['switch_moe',
                                                     'moe_layer_stack'])
def test_a_mesh_is_refused(scan):
    """An op on a program with a mesh raises, naming ROADMAP Queue 1 item
    9 (expert parallelism needs the mesh the port does not have)."""
    main, startup, avg = _lm(pt, PM, scan)
    main.mesh = object()
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        with pytest.raises(NotImplementedError, match='item 9'):
            exe.run(main, feed=_feed(), fetch_list=[avg])


def test_dropout_draws_once_a_layer(monkeypatch):
    """moe_layer_stack at dropout 0.1: one dropout site a layer (the
    attention output's), each layer its own key; the same steps from the
    same state repeat bit for bit."""
    from paddle_tpu_torch.ops.kernels import random_bits
    main, startup, avg = _lm(pt, PM, True, dropout=0.1)
    keys = []
    orig = random_bits.DropoutApply.apply

    def counted(*a):
        keys.append(a[3])
        return orig(*a)
    monkeypatch.setattr(random_bits.DropoutApply, 'apply', counted)
    res = []
    for _ in range(2):
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
        with pt.scope_guard(scope):
            exe.run(startup)
            res.append([float(exe.run(main, feed=_feed(),
                                      fetch_list=[avg])[0])
                        for _ in range(2)])
    assert len(keys) == 2 * 2 * LM['n_layer']
    assert len(set(keys[:LM['n_layer']])) == LM['n_layer']
    assert res[0] == res[1] and np.isfinite(res[0]).all()
