"""Gradient accumulation and the assign copy, port vs reference.

``assign`` gives a copy in the port: the optimizer ops update their
parameters and moments in place, so a value assigned from a parameter
before the update keeps the pre-update value, as the reference's
immutable arrays do (the alias test). ``GradientAccumulator`` is built on
exactly that: it snapshots every persistable the inner update writes and
blends it back on the gated steps. Its tests mirror the reference's
(tests/test_optimizers.py's SGD and Adam cases, tests/test_sparse_grad.py's
forced-dense case) and hold the port against paddle_tpu on the same
numpy inputs: parameters after every micro step within rtol 1e-6 (fp32;
the same ops in the same order), the gated steps bit for bit unchanged,
and run_steps against run calls bit for bit.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (port tests import both frameworks)
import torch

import paddle_tpu as fluid

import paddle_tpu_torch as pt


def _fc_program(pkg, name, n_in, accum, opt, lr):
    """x [n_in] -> fc(1, no bias, param ``name``) -> mean square error
    under ``opt(lr)``, wrapped in GradientAccumulator(., accum) when
    accum is not None. Returns (main, startup, loss)."""
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data(name='x', shape=[n_in], dtype='float32')
        y = pkg.layers.data(name='y', shape=[1], dtype='float32')
        pred = pkg.layers.fc(input=x, size=1, bias_attr=False,
                             param_attr=pkg.ParamAttr(name=name))
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        inner = getattr(pkg.optimizer, opt)(learning_rate=lr)
        if accum is None:
            inner.minimize(loss)
        else:
            pkg.optimizer.GradientAccumulator(inner, accum).minimize(loss)
    return main, startup, loss


# ------------------------------------------------------------ assign alias
def _alias_run(pkg, opt, w0=None):
    """snap = assign(w) before opt's update of w (and, for Adam, a
    snapshot of moment1 just before the adam op): returns the second
    step's fetches (snap, w, moment1's snap, moment1), w at the start and
    w before the second step; from ``w0`` when it is given."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data(name='x', shape=[4], dtype='float32')
        pred = pkg.layers.fc(input=x, size=3, bias_attr=False,
                             param_attr=pkg.ParamAttr(name='al_w'))
        loss = pkg.layers.mean(pred)
        w = main.global_block().var('al_w')
        snap = pkg.layers.assign(w)
        getattr(pkg.optimizer, opt)(learning_rate=0.5).minimize(loss)
        moments = [v for v in main.list_vars() if 'moment1' in v.name]
        msnap = None
        if moments:
            # a snapshot of the moment taken after the update ops' inputs
            # are read, as GradientAccumulator takes them: inserted right
            # before the adam op
            block = main.global_block()
            at = next(i for i, op in enumerate(block.ops)
                      if op.type == 'adam')
            msnap = pkg.layers.assign(moments[0])
            block.ops.insert(at, block.ops.pop())
    feed = {'x': np.random.RandomState(3).randn(2, 4).astype('f')}
    fetch = [snap, 'al_w'] + ([msnap, moments[0]] if moments else [])
    if pkg is fluid:
        scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    else:
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    with pkg.scope_guard(scope):
        exe.run(startup)
        if w0 is not None:
            scope.set('al_w', torch.tensor(w0))
        w0 = np.array(scope.find('al_w'))
        # a first step moves the moments off zero, the second is checked
        exe.run(main, feed=feed, fetch_list=fetch)
        w1 = np.array(scope.find('al_w'))
        got = [np.asarray(v) for v in exe.run(main, feed=feed,
                                               fetch_list=fetch)]
    return got, w0, w1


@pytest.mark.parametrize('opt', ['SGD', 'Adam'])
def test_assign_is_a_copy_before_an_in_place_update(opt):
    """The fault this slice repairs: the port's assign returned its input
    tensor, so the in-place update changed the snapshot too. Now snap is
    the pre-update w (and Adam's moment snapshot the pre-update moment),
    equal to the reference's; w and the moment moved."""
    ref, w0, _ = _alias_run(fluid, opt)
    got, _, w_before = _alias_run(pt, opt, w0)
    np.testing.assert_array_equal(got[0], w_before)
    assert not np.array_equal(got[1], got[0])
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-7)
    if opt == 'Adam':
        assert not np.array_equal(got[2], got[3])


def _view_run(pkg, opt, w0):
    """reshape(w) and transpose(w) fetched from two steps of opt's update
    of w, from ``w0``: returns the second step's fetches
    and w before it."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data(name='x', shape=[4], dtype='float32')
        pred = pkg.layers.fc(input=x, size=3, bias_attr=False,
                             param_attr=pkg.ParamAttr(name='vw_w'))
        loss = pkg.layers.mean(pred)
        w = main.global_block().var('vw_w')
        flat = pkg.layers.reshape(w, [12])
        wt = pkg.layers.transpose(w, [1, 0])
        getattr(pkg.optimizer, opt)(learning_rate=0.5).minimize(loss)
    feed = {'x': np.random.RandomState(4).randn(2, 4).astype('f')}
    if pkg is fluid:
        scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    else:
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    with pkg.scope_guard(scope):
        exe.run(startup)
        scope.set('vw_w', torch.tensor(w0) if pkg is pt else
                  jax.numpy.asarray(w0))
        exe.run(main, feed=feed, fetch_list=[flat, wt])
        w1 = np.array(scope.find('vw_w'))
        got = [np.asarray(v) for v in exe.run(main, feed=feed,
                                               fetch_list=[flat, wt])]
    return got, w1


@pytest.mark.parametrize('opt', ['SGD', 'Adam'])
def test_fetched_view_of_a_parameter_is_its_pre_update_value(opt):
    """reshape and transpose return views of the parameter, which the
    update then writes in place: the executor copies such a fetch before
    the update ops run, so it is the pre-update w, as the reference's
    arrays are (its fetches equal the port's), and w moved."""
    w0 = np.random.RandomState(5).randn(4, 3).astype('f')
    ref, rw1 = _view_run(fluid, opt, w0)
    got, w1 = _view_run(pt, opt, w0)
    np.testing.assert_allclose(w1, rw1, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[0], w1.reshape(12))
    np.testing.assert_array_equal(got[1], w1.T)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-7)


def test_assign_output_owns_its_storage():
    """The lowering copies: its output equals its input and never shares
    its storage."""
    from paddle_tpu_torch.core.registry import get_lowering
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        x = pt.layers.data(name='x', shape=[3], dtype='float32')
        pt.layers.assign(x)
    op = main.global_block().ops[-1]
    t = torch.arange(6.0).reshape(2, 3)
    env = {op.input('X'): t}
    from paddle_tpu_torch.core.registry import LoweringContext
    ctx = LoweringContext(env, op, main.global_block(), 0,
                          torch.device('cpu'))
    get_lowering('assign')(ctx)
    out = env[op.output('Out')]
    assert torch.equal(out, t) and out.data_ptr() != t.data_ptr()


def test_training_programs_hold_no_assign():
    """The assign copy costs the main paths nothing: Transformer-base and
    ResNet-50's training programs hold no assign op."""
    from paddle_tpu_torch.models import resnet, transformer
    counts = []
    for build in (
            lambda: transformer.transformer_base(
                src_vocab_size=64, trg_vocab_size=64, src_seq_len=8,
                trg_seq_len=8, n_layer=6)[0],
            lambda: resnet.resnet50_with_loss(class_dim=10)[1]):
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            pt.optimizer.Adam(learning_rate=1e-3).minimize(build())
        counts.append(sum(op.type == 'assign'
                          for op in main.global_block().ops))
    assert counts == [0, 0]


# ----------------------------------------------------- GradientAccumulator
def _scope_exe(pkg):
    if pkg is fluid:
        return fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    return pt.Scope(), pt.Executor(pt.CPUPlace())


def _accum_trajectory(pkg, opt, lr, xs, ys, accum, feeds, w0, name):
    """Params (and beta1 pows) after each step of ``feeds`` (index lists
    into xs / ys), from w0."""
    main, startup, loss = _fc_program(pkg, name, xs.shape[1], accum, opt,
                                      lr)
    scope, exe = _scope_exe(pkg)
    out = []
    with pkg.scope_guard(scope):
        exe.run(startup)
        scope.set(name, w0 if pkg is fluid else torch.tensor(w0))
        for idx in feeds:
            exe.run(main, feed={'x': xs[idx], 'y': ys[idx]},
                    fetch_list=[loss])
            pows = sorted(n for n in scope.keys() if 'beta1_pow' in n)
            out.append((np.array(scope.find(name)),
                        [np.array(scope.find(n)).reshape(()) for n in pows]))
    return out


def test_accumulator_equals_big_batch_sgd():
    """tests/test_optimizers.py's SGD case: GradientAccumulator(SGD, 2)'s
    first micro step leaves w bit for bit, the second equals one step on
    the whole batch (rtol 1e-5), and each step equals the reference's
    (rtol 1e-6)."""
    rng = np.random.RandomState(0)
    xs = rng.randn(16, 6).astype('float32')
    ys = xs @ rng.randn(6, 1).astype('float32')
    w0 = np.random.RandomState(5).randn(6, 1).astype('float32')
    halves = [np.arange(8), np.arange(8, 16)]
    got = _accum_trajectory(pt, 'SGD', 0.1, xs, ys, 2, halves, w0, 'ga_w')
    ref = _accum_trajectory(fluid, 'SGD', 0.1, xs, ys, 2, halves, w0,
                            'ga_w')
    big = _accum_trajectory(pt, 'SGD', 0.1, xs, ys, None,
                            [np.arange(16)], w0, 'ga_w')
    np.testing.assert_array_equal(got[0][0], w0)
    np.testing.assert_allclose(got[1][0], big[0][0], rtol=1e-5, atol=1e-6)
    for (g, _), (r, _) in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-7)


def test_accumulator_adam_state_gating():
    """tests/test_optimizers.py's Adam case: 6 micro steps of
    GradientAccumulator(Adam, 2) on one batch equal 3 Adam steps (the
    weights rtol 1e-5, the beta1 pows rtol 1e-6); the gated steps leave
    the weight and the beta pows bit for bit; each step equals the
    reference's (rtol 1e-6)."""
    rng = np.random.RandomState(1)
    xs = rng.randn(8, 4).astype('float32')
    ys = rng.randn(8, 1).astype('float32')
    w0 = np.random.RandomState(6).randn(4, 1).astype('float32')
    every = [np.arange(8)]
    got = _accum_trajectory(pt, 'Adam', 0.05, xs, ys, 2, every * 6, w0,
                            'gaa_w')
    ref = _accum_trajectory(fluid, 'Adam', 0.05, xs, ys, 2, every * 6, w0,
                            'gaa_w')
    big = _accum_trajectory(pt, 'Adam', 0.05, xs, ys, None, every * 3, w0,
                            'gaa_w')
    for i in (0, 2, 4):     # gated micro steps
        prev = w0 if i == 0 else got[i - 1][0]
        np.testing.assert_array_equal(got[i][0], prev)
    np.testing.assert_array_equal(got[0][1], [np.float32(0.9)])
    for i in range(3):
        np.testing.assert_allclose(got[2 * i + 1][0], big[i][0], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got[2 * i + 1][1], big[i][1], rtol=1e-6)
    for (g, gp), (r, rp) in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(gp, rp, rtol=1e-6)


def test_accumulator_program_mirrors_reference():
    """Same ops in the same order with the same slots as the reference's
    GradientAccumulator(Adam, 3) program; the snapshots come before the
    update ops."""
    ref = _fc_program(fluid, 'm_w', 4, 3, 'Adam', 0.1)[0].global_block().ops
    got = _fc_program(pt, 'm_w', 4, 3, 'Adam', 0.1)[0].global_block().ops
    assert [op.type for op in got] == [op.type for op in ref]
    for r, g in zip(ref, got):
        assert g.inputs == r.inputs and g.outputs == r.outputs, r.type
    types = [op.type for op in got]
    assert types.index('assign') < types.index('adam')


def test_accumulator_k1_passes_through():
    """accum_steps=1 is the inner optimizer's own minimize; accum_steps
    that are no positive integer raise, as the reference's."""
    main, _, _ = _fc_program(pt, 'k1_w', 4, 1, 'SGD', 0.1)
    plain, _, _ = _fc_program(pt, 'k1_w', 4, None, 'SGD', 0.1)
    assert [op.type for op in main.global_block().ops] == \
        [op.type for op in plain.global_block().ops]
    for bad in (0, 2.5, -1):
        with pytest.raises(ValueError):
            pt.optimizer.GradientAccumulator(pt.optimizer.SGD(0.1), bad)


def _sparse_build(pkg, opt):
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        ids = pkg.layers.data(name='ids', shape=[6], dtype='int64')
        y = pkg.layers.data(name='y', shape=[1], dtype='float32')
        emb = pkg.layers.embedding(input=ids, size=[50, 8], is_sparse=True,
                                   param_attr=pkg.ParamAttr(name='table'))
        pred = pkg.layers.fc(input=pkg.layers.reduce_mean(emb, dim=1),
                             size=1)
        cost = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        opt.minimize(cost)
    return main, startup, cost


@pytest.mark.parametrize('lazy', [False, True])
def test_accumulator_forces_dense(lazy):
    """tests/test_sparse_grad.py's case: under the wrapper the marker's
    sparse_grads is empty (row gradients cannot accumulate), the inner
    optimizer's flag is restored (a lazy Adam's instance value too), and
    two micro steps equal the reference's (rtol 1e-6)."""
    inner = pt.optimizer.Adam(learning_rate=0.1, lazy_mode=True) if lazy \
        else pt.optimizer.SGD(learning_rate=0.1)
    main, startup, cost = _sparse_build(
        pt, pt.optimizer.GradientAccumulator(inner, 2))
    marker = [op for op in main.global_block().ops
              if op.type == 'backward_marker'][0]
    assert marker.attrs['sparse_grads'] == {}
    assert inner._supports_sparse_update
    assert ('_supports_sparse_update' in inner.__dict__) == lazy
    assert pt.optimizer.SGD(learning_rate=0.1)._supports_sparse_update
    jinner = fluid.optimizer.Adam(learning_rate=0.1, lazy_mode=True) \
        if lazy else fluid.optimizer.SGD(learning_rate=0.1)
    jmain, jstart, jcost = _sparse_build(
        fluid, fluid.optimizer.GradientAccumulator(jinner, 2))
    rng = np.random.RandomState(0)
    feed = {'ids': rng.randint(0, 50, (4, 6)).astype('int64'),
            'y': rng.randn(4, 1).astype('f')}
    jscope, jexe = _scope_exe(fluid)
    with fluid.scope_guard(jscope):
        jexe.run(jstart)
        init = {n: np.array(jscope.find(n)) for n in jscope.keys()}
        for _ in range(2):
            jexe.run(jmain, feed=feed, fetch_list=[jcost])
        want = np.array(jscope.find('table'))
    pscope, pexe = _scope_exe(pt)
    with pt.scope_guard(pscope):
        pexe.run(startup)
        for n, v in init.items():
            pscope.set(n, torch.tensor(v))
        for _ in range(2):
            pexe.run(main, feed=feed, fetch_list=[cost])
        got = pscope.numpy('table')
    assert not np.array_equal(got, init['table'])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_accumulator_run_steps_equals_runs():
    """run_steps(4) of GradientAccumulator(Adam, 4) equals 4 run calls bit
    for bit (the phase and the blend are ops: no host branch), and the
    update lands on the fourth step."""
    rng = np.random.RandomState(2)
    feed = {'x': rng.randn(8, 4).astype('f'), 'y': rng.randn(8, 1).astype('f')}
    main, startup, loss = _fc_program(pt, 'rs_w', 4, 4, 'Adam', 0.1)
    res = []
    for steps in ('run_steps', 'run'):
        scope, exe = _scope_exe(pt)
        with pt.scope_guard(scope):
            exe.run(startup)
            scope.set('rs_w', torch.ones(4, 1))
            if steps == 'run_steps':
                losses = exe.run_steps(4, main, feed=feed,
                                       fetch_list=[loss])[0].reshape(-1)
            else:
                losses = np.array([exe.run(main, feed=feed,
                                           fetch_list=[loss])[0].reshape(())
                                   for _ in range(4)])
            res.append((losses, {n: scope.numpy(n) for n in scope.keys()}))
    np.testing.assert_array_equal(res[0][0], res[1][0])
    for n, v in res[0][1].items():
        np.testing.assert_array_equal(v, res[1][1][n])
    assert res[0][0][0] == res[0][0][3]    # no update before the 4th step
    assert not np.array_equal(res[0][1]['rs_w'], np.ones((4, 1), 'f'))
