"""Transformer training, port vs reference: the port's training Program
mirrors the JAX package's op for op, both train a tiny transformer_base
from the same weights to the same losses and parameters (fp32 and bf16
AMP), the training ops agree with their JAX lowerings one by one, and the
port's loss falls on its CPU place."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as fluid
from paddle_tpu.models import transformer as JT
from paddle_tpu.ops import nn_ops as jnn

import paddle_tpu_torch as pt
from paddle_tpu_torch.models import transformer as PT
from paddle_tpu_torch.ops import nn_ops as tnn
from paddle_tpu_torch.weights import load_into_scope

CFG = dict(src_vocab_size=64, trg_vocab_size=64, src_seq_len=8,
           trg_seq_len=8, n_layer=2, d_model=32, d_inner=64, d_key=8,
           d_value=8, dropout_rate=0.0)
LR = 1e-3
STEPS = 3
FEED = JT.make_fake_batch(4, 8, 8, 64, 64, seed=1)


def _build(pkg, model, opt=None, **overrides):
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        avg_cost, logits = model.transformer_base(**dict(CFG, **overrides))
        (opt or pkg.optimizer.Adam)(learning_rate=LR).minimize(avg_cost)
    return main, startup, avg_cost, logits


def _same_attr(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


@pytest.mark.parametrize('which', ['main', 'startup'])
def test_program_mirrors_reference(which):
    """Same ops in the same order with the same slots, var names and
    attrs; same parameters with the same shapes, dtypes and flags."""
    ref = _build(fluid, JT)
    got = _build(pt, PT)
    rb = (ref[0] if which == 'main' else ref[1]).global_block()
    gb = (got[0] if which == 'main' else got[1]).global_block()
    assert [op.type for op in gb.ops] == [op.type for op in rb.ops]
    for rop, gop in zip(rb.ops, gb.ops):
        assert gop.inputs == rop.inputs, rop.type
        assert gop.outputs == rop.outputs, rop.type
        assert sorted(gop.attrs) == sorted(rop.attrs), rop.type
        for key in rop.attrs:
            assert _same_attr(gop.attrs[key], rop.attrs[key]), (rop.type, key)
    if which == 'main':
        rparams = {p.name: p for p in ref[0].all_parameters()}
        gparams = {p.name: p for p in got[0].all_parameters()}
        assert sorted(gparams) == sorted(rparams)
        for name, rp in rparams.items():
            gp = gparams[name]
            assert (gp.shape, gp.dtype, gp.trainable, gp.persistable) == \
                (rp.shape, rp.dtype, rp.trainable, rp.persistable), name


def _train_both(amp, fetch_all=False):
    """3 Adam steps in each package from the JAX startup's weights.
    Returns (ref losses, port losses, ref scope, port scope, names of the
    copied vars, per-step fetch dtypes of both)."""
    jmain, jstart, javg, _ = _build(fluid, JT)
    pmain, _, pavg, _ = _build(pt, PT)
    jmain.amp = pmain.amp = amp
    fetch = [javg.name]
    if fetch_all:
        # every value the forward section produces
        marker = [op.type for op in jmain.global_block().ops] \
            .index('backward_marker')
        for op in jmain.global_block().ops[:marker]:
            fetch += [n for n in op.output_names() if n not in fetch]
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(jscope):
        jexe.run(jstart)
    arrays = {n: np.asarray(jscope.find(n)) for n in jscope.keys()
              if jscope.find(n) is not None}
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    load_into_scope(arrays, pscope, pt.CPUPlace())
    ref, got, dtypes = [], [], []
    for _ in range(STEPS):
        with fluid.scope_guard(jscope):
            jout = jexe.run(jmain, feed=FEED, fetch_list=fetch,
                            return_numpy=False)
        with pt.scope_guard(pscope):
            pout = pexe.run(pmain, feed=FEED, fetch_list=fetch,
                            return_numpy=False)
        ref.append(float(np.asarray(jout[0], 'float32')))
        got.append(float(pout[0].float()))
        dtypes.append(([str(v.dtype) for v in jout],
                       [str(v.dtype).replace('torch.', '') for v in pout]))
    return ref, got, jscope, pscope, sorted(arrays), dtypes


def _param_gap(jscope, pscope, names):
    return max(float(np.max(np.abs(np.asarray(jscope.find(n), 'float32') -
                                   pscope.numpy(n).astype('float32'))))
               for n in names)


def test_training_matches_reference_fp32():
    """fp32: the two packages compute the same step with sums in another
    order, so the loss agrees to rtol 1e-5. Adam divides each moment by
    the root of the second moment, which can turn a gradient difference
    at rounding level into a move of up to lr in either package per step,
    so a parameter is held to 2·lr·steps."""
    ref, got, jscope, pscope, names, _ = _train_both(None)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert ref[-1] < ref[0]
    assert _param_gap(jscope, pscope, names) <= 2 * LR * STEPS


def test_training_matches_reference_bf16_amp():
    """bf16 AMP: the same casts (whitelist ops in bf16, blacklist ops in
    fp32, layer_norm outputs back to bf16) and so the same dtype for
    every value of the forward. Attention rounds differently (the JAX
    reference path takes its softmax in bf16, the port's flash path in
    fp32 with p rounded to bf16), so the loss is held to rtol 2e-3 and
    each parameter to Adam's 2·lr·steps."""
    ref, got, jscope, pscope, names, dtypes = _train_both('bf16',
                                                          fetch_all=True)
    np.testing.assert_allclose(got, ref, rtol=2e-3)
    for rdt, gdt in dtypes:
        assert gdt == rdt
    assert 'bfloat16' in dtypes[0][0] and 'float32' in dtypes[0][0]
    assert _param_gap(jscope, pscope, names) <= 2 * LR * STEPS


def test_loss_falls_on_the_cpu_place():
    """The reference's end-to-end check (tests/test_models_e2e.py) on the
    port: 12 Adam steps on one batch, with dropout, lower the loss."""
    main, startup, avg_cost, _ = _build(pt, PT, dropout_rate=0.1)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    losses = []
    with pt.scope_guard(scope):
        exe.run(startup)
        for _ in range(12):
            out, = exe.run(main, feed=FEED, fetch_list=[avg_cost])
            losses.append(float(out))
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], losses


def test_fetched_parameters_are_copies():
    """The update ops change parameters in place; an array fetched
    before a step keeps its values after it."""
    main, startup, avg_cost, _ = _build(pt, PT)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        _, before = exe.run(main, feed=FEED,
                            fetch_list=[avg_cost, 'out_proj.w'])
        kept = before.copy()
        exe.run(main, feed=FEED, fetch_list=[avg_cost])
        after = pt.global_scope().numpy('out_proj.w')
    np.testing.assert_array_equal(before, kept)
    assert np.abs(after - before).max() > 0


# ------------------------------------------------- ops vs their lowerings
def _run_pair(build, feed, steps=1, startup_feed=None):
    """Build a program with ``build(pkg)`` (which returns the names to
    fetch) in each package, run startup and ``steps`` steps, return the
    last fetches of both (ref, port)."""
    outs = []
    for pkg in (fluid, pt):
        pkg.reset_default_programs()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            fetch = build(pkg)
        scope = pkg.Scope()
        exe = pkg.Executor(pkg.CPUPlace())
        with pkg.scope_guard(scope):
            exe.run(startup)
            if startup_feed:
                for n, v in startup_feed.items():
                    scope.set(n, v if pkg is fluid else torch.tensor(v))
            for _ in range(steps):
                res = exe.run(main, feed=feed, fetch_list=fetch)
        outs.append([np.asarray(r, 'float32') for r in res])
    return outs


def test_adam_op_matches_reference():
    """fc + mean under Adam for 3 steps from the same weights: the moments
    and the parameters agree (one step of Adam is ±lr on every weight with
    a clear gradient, so any flipped sign would show as 2e-2)."""
    rng = np.random.RandomState(0)
    w0 = rng.randn(6, 3).astype('float32')

    def build(pkg):
        x = pkg.layers.data(name='x', shape=[6], dtype='float32')
        y = pkg.layers.fc(input=x, size=3, bias_attr=False,
                          param_attr=pkg.ParamAttr(name='w'))
        loss = pkg.layers.mean(pkg.layers.elementwise_mul(x=y, y=y))
        pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
        return ['w', 'w_moment1_acc', 'w_moment2_acc', 'beta1_pow_acc_0']

    feed = {'x': rng.randn(5, 6).astype('float32')}
    ref, got = _run_pair(build, feed, steps=3, startup_feed={'w': w0})
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-7)
    assert np.abs(ref[0] - w0).min() > 1e-3   # every weight moved


def test_lookup_table_op_matches_reference():
    """Gather with padding_idx: the padding rows read 0 and their table
    rows get no gradient (one SGD step moves every other looked-up row)."""
    rng = np.random.RandomState(1)
    table = rng.randn(10, 4).astype('float32')
    ids = np.array([[0, 3, 3], [9, 0, 2]], 'int64')

    def build(pkg):
        i = pkg.layers.data(name='ids', shape=[3], dtype='int64')
        e = pkg.layers.embedding(input=i, size=[10, 4], padding_idx=0,
                                 param_attr=pkg.ParamAttr(name='emb'))
        loss = pkg.layers.reduce_sum(pkg.layers.elementwise_mul(x=e, y=e))
        pkg.optimizer.SGD(learning_rate=0.5).minimize(loss)
        return [e.name, 'emb']

    ref, got = _run_pair(build, {'ids': ids}, startup_feed={'emb': table})
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=0)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-6, atol=1e-6)
    assert np.all(got[0][ids == 0] == 0)
    np.testing.assert_array_equal(got[1][0], table[0])


@pytest.mark.parametrize('impl', ['downgrade_in_infer', 'upscale_in_train'])
def test_dropout_op_matches_reference(impl):
    """is_test: x·(1-p) (downgrade_in_infer) or x, exactly as the JAX
    lowering. Training: the masks come from different generators, so the
    semantics are compared: out = x·mask (no scaling under
    downgrade_in_infer, 1/(1-p) under upscale_in_train), Mask in {0, 1},
    a kept share near 1-p in both."""
    x = np.random.RandomState(2).rand(64, 64).astype('float32') + 0.5
    p = 0.3

    def build(is_test):
        def fn(pkg):
            xv = pkg.layers.data(name='x', shape=[64], dtype='float32')
            out = pkg.layers.dropout(xv, dropout_prob=p, is_test=is_test,
                                     dropout_implementation=impl)
            op = pkg.default_main_program().global_block().ops[-1]
            return [out.name, op.output('Mask')]
        return fn

    ref, got = _run_pair(build(True), {'x': x})
    want = x * (1 - p) if impl == 'downgrade_in_infer' else x
    for r, g in ((ref[0], got[0]), (ref[1], got[1])):
        np.testing.assert_allclose(g, r, rtol=1e-6)
    np.testing.assert_allclose(got[0], want, rtol=1e-6)
    np.testing.assert_array_equal(got[1], np.ones_like(x))

    ref, got = _run_pair(build(False), {'x': x})
    scale = 1.0 if impl == 'downgrade_in_infer' else 1.0 / (1 - p)
    for out, mask in (ref, got):
        assert set(np.unique(mask)) <= {0.0, 1.0}
        np.testing.assert_allclose(out, x * mask * scale, rtol=1e-6)
        assert abs(mask.mean() - (1 - p)) < 0.03


@pytest.mark.parametrize('eps', [0.1, 0.0])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_label_smoothed_cross_entropy_matches_reference(eps, dtype):
    """Loss and its gradient against jax.vjp of the JAX package's
    _ls_ce_fused: fp32 1e-5; bf16 logits: both take the statistics in
    fp32 and round the gradient to bf16 once, so one bf16 ulp."""
    rng = np.random.RandomState(3)
    x = (rng.randn(6, 5, 40) * 3).astype('float32')
    label = rng.randint(0, 40, (6, 5)).astype('int64')
    g = rng.rand(6, 5).astype('float32')
    jx = jnp.asarray(x).astype(dtype)
    loss, vjp = jax.vjp(lambda a: jnn._ls_ce_fused(a, jnp.asarray(label),
                                                   eps), jx)
    dx_ref = np.asarray(vjp(jnp.asarray(g))[0].astype(jnp.float32))
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype)).requires_grad_()
    tloss = tnn.label_smoothed_ce(tx, torch.tensor(label), eps)
    assert tloss.dtype == torch.float32
    tloss.backward(torch.tensor(g))
    np.testing.assert_allclose(tloss.detach().numpy(), np.asarray(loss),
                               rtol=1e-5, atol=1e-5)
    dx = tx.grad.float().numpy()
    tol = 1e-6 if dtype == 'float32' else \
        2.0 ** (np.floor(np.log2(np.maximum(np.abs(dx_ref), 1e-30))) - 7)
    assert np.all(np.abs(dx - dx_ref) <= tol)
