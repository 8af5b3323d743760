"""The port's Executor: run_steps, StepHandle, the reference's run
arguments, the dropout mask keyed by (seed, step, op, element), and scope
tensors that keep their address from step to step (what a captured CUDA
graph needs), on the CPU place. Mirrors tests/test_executor.py's run_steps
tests and tests/test_pipeline.py's StepHandle test; run_steps is held
against the JAX package's at dropout 0 on the same weights."""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.registry import HOST_BOUND, mix32, op_key
from paddle_tpu_torch.ops.kernels import random_bits
from paddle_tpu_torch.weights import load_into_scope


def _mlp(pkg, dropout, opt='momentum'):
    """x -> fc(16, relu) -> dropout -> fc(1); the mean squared error."""
    x = pkg.layers.data(name='x', shape=[8], dtype='float32')
    y = pkg.layers.data(name='y', shape=[1], dtype='float32')
    h = pkg.layers.fc(input=x, size=16, act='relu',
                      param_attr=pkg.ParamAttr(name='ms_w1'))
    h = pkg.layers.dropout(h, dropout_prob=dropout)
    pred = pkg.layers.fc(input=h, size=1,
                         param_attr=pkg.ParamAttr(name='ms_w2'))
    d = pkg.layers.elementwise_add(pred, pkg.layers.scale(y, scale=-1.0))
    cost = pkg.layers.mean(pkg.layers.elementwise_mul(d, d))
    if opt == 'momentum':
        pkg.optimizer.Momentum(learning_rate=0.05,
                               momentum=0.9).minimize(cost)
    else:
        pkg.optimizer.Adam(learning_rate=0.01).minimize(cost)
    return cost


def _feed(seed, lead=()):
    rng = np.random.RandomState(seed)
    return {'x': rng.randn(*(lead + (16, 8))).astype('f'),
            'y': rng.randn(*(lead + (16, 1))).astype('f')}


def _port(dropout=0.3, opt='momentum', weights=None):
    """A fresh program, scope and CPU executor with the startup run (or
    ``weights`` loaded)."""
    pt.reset_default_programs()
    cost = _mlp(pt, dropout, opt)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        if weights is None:
            exe.run(pt.default_startup_program())
        else:
            load_into_scope(weights, scope, pt.CPUPlace())
    return cost, scope, exe


def test_run_steps_matches_per_step_trajectory():
    """run_steps(5) reproduces five run calls bit for bit, dropout masks
    included (both draw the masks of the executor's steps 0..4), in the
    losses and the momentum state."""
    feed = _feed(0)
    cost, s1, exe = _port()
    with pt.scope_guard(s1):
        single = [exe.run(feed=feed, fetch_list=[cost])[0].reshape(())
                  for _ in range(5)]
    cost, s2, exe = _port()
    with pt.scope_guard(s2):
        multi = exe.run_steps(5, feed=feed, fetch_list=[cost])[0]
    assert multi.shape == (5, 1)
    np.testing.assert_array_equal(multi.reshape(-1), np.array(single))
    for name in s1.keys():
        np.testing.assert_array_equal(s2.numpy(name), s1.numpy(name),
                                      err_msg=name)


def test_run_steps_stacked_feed():
    """stacked_feed=True: step i takes slice i of a [steps, ...] feed, bit
    for bit as feeding the batches one by one."""
    feeds = _feed(1, lead=(4,))
    cost, s1, exe = _port()
    with pt.scope_guard(s1):
        single = [exe.run(feed={'x': feeds['x'][i], 'y': feeds['y'][i]},
                          fetch_list=[cost])[0].reshape(())
                  for i in range(4)]
    cost, s2, exe = _port()
    with pt.scope_guard(s2):
        multi = exe.run_steps(4, feed=feeds, fetch_list=[cost],
                              stacked_feed=True)[0]
    np.testing.assert_array_equal(multi.reshape(-1), np.array(single))
    np.testing.assert_array_equal(s2.numpy('ms_w1'), s1.numpy('ms_w1'))


def test_run_steps_stacked_feed_wrong_leading_dim():
    cost, scope, exe = _port()
    with pt.scope_guard(scope):
        with pytest.raises(ValueError, match='leading'):
            exe.run_steps(3, feed={'x': np.zeros((2, 16, 8), 'f'),
                                   'y': np.zeros((2, 16, 1), 'f')},
                          fetch_list=[cost], stacked_feed=True)


@pytest.mark.parametrize('stacked', [False, True])
def test_run_steps_matches_jax_run_steps(stacked):
    """At dropout 0, the port's run_steps(4) and the JAX package's
    run_steps(4) from the JAX startup's weights: losses and every
    parameter within 1e-5 (the same float32 math, summed in other
    orders)."""
    feed = _feed(2, lead=(4,)) if stacked else _feed(2)
    fluid.reset_default_programs()
    jcost = _mlp(fluid, 0.0)
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(jscope):
        jexe.run(fluid.default_startup_program())
        weights = {n: np.asarray(jscope.find(n)) for n in jscope.keys()
                   if jscope.find(n) is not None}
        want = np.asarray(jexe.run_steps(4, feed=feed, fetch_list=[jcost],
                                         stacked_feed=stacked)[0])
    cost, scope, exe = _port(0.0, weights=weights)
    with pt.scope_guard(scope):
        got = exe.run_steps(4, feed=feed, fetch_list=[cost],
                            stacked_feed=stacked)[0]
    np.testing.assert_allclose(got.reshape(-1), want.reshape(-1),
                               rtol=1e-5, atol=1e-6)
    for name in ('ms_w1', 'ms_w2'):
        np.testing.assert_allclose(scope.numpy(name),
                                   np.asarray(jscope.find(name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_step_handle():
    """run(return_handle=True) gives a StepHandle with the reference's
    fields; on the CPU it is ready at once, resolve() returns the fetches
    as numpy, equal to run's, and is idempotent; run_steps' handle holds
    the stacked fetches."""
    cost, scope, exe = _port(0.0)
    feed = _feed(3)
    with pt.scope_guard(scope):
        snap = {n: scope.find(n).clone() for n in scope.keys()}
        want = exe.run(feed=feed, fetch_list=[cost])[0]
        for n, t in snap.items():
            scope.find(n).copy_(t)
        h = exe.run(feed=feed, fetch_list=[cost], return_handle=True)
        assert h.steps == 1 and h.dispatched_at > 0
        assert h.cache_miss is False
        assert h.ready()
        got = h.resolve()
        assert isinstance(got[0], np.ndarray)
        np.testing.assert_array_equal(got[0], want)
        assert h.resolve() is got
        h3 = exe.run_steps(3, feed=feed, fetch_list=[cost],
                           return_handle=True)
        assert h3.steps == 3 and h3.resolve()[0].shape == (3, 1)


def test_reference_run_arguments_and_cache_miss():
    """run takes use_program_cache and return_handle as the reference's
    does; last_cache_miss is True for a key's first call only, and the
    CPU place never captures."""
    cost, scope, exe = _port(0.0)
    feed = _feed(4)
    with pt.scope_guard(scope):
        exe.run(feed=feed, fetch_list=[cost], return_numpy=True,
                use_program_cache=True, return_handle=False)
        assert exe.last_cache_miss and not exe.last_captured
        exe.run(feed=feed, fetch_list=[cost])
        assert not exe.last_cache_miss and not exe.last_captured
        exe.run(feed=dict(feed, x=feed['x'][:8], y=feed['y'][:8]),
                fetch_list=[cost])
        assert exe.last_cache_miss
    assert exe.captures == 0


def test_use_program_cache_false_gives_the_same_result():
    """use_program_cache=False runs the same steps (eagerly on the card;
    on the CPU both are eager): bit for bit, dropout on."""
    feed = _feed(5)
    out = []
    for cache in (True, False):
        cost, scope, exe = _port()
        with pt.scope_guard(scope):
            out.append([exe.run(feed=feed, fetch_list=[cost],
                                use_program_cache=cache)[0]
                        for _ in range(3)] + [scope.numpy('ms_w1')])
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def _dropout_program(p, seed):
    pt.reset_default_programs()
    main = pt.default_main_program()
    main.random_seed = seed
    x = pt.layers.data(name='x', shape=[64, 64], dtype='float32')
    out = pt.layers.dropout(x, dropout_prob=p)
    mask = main.global_block().ops[-1].output('Mask')
    return out, mask


def test_dropout_mask_reproducible_differs_by_step_and_drops_about_p():
    """The mask is a pure function of (program seed, step, op index,
    element index): two executors at the same seed draw the same masks,
    a step draws another than the step before, another seed another
    mask, and about p of the elements are dropped."""
    feed = {'x': np.ones((4, 64, 64), 'f')}

    def masks(seed, steps=2):
        out, mask = _dropout_program(0.3, seed)
        exe = pt.Executor(pt.CPUPlace())
        with pt.scope_guard(pt.Scope()):
            return [exe.run(feed=feed, fetch_list=[out, mask])
                    for _ in range(steps)]

    a, b, c = masks(7), masks(7), masks(8)
    for (oa, ma), (ob, mb) in zip(a, b):
        np.testing.assert_array_equal(ma, mb)
        np.testing.assert_array_equal(oa, ob)
    assert not np.array_equal(a[0][1], a[1][1])
    assert not np.array_equal(a[0][1], c[0][1])
    for out, m in a:
        assert set(np.unique(m)) <= {0.0, 1.0}
        np.testing.assert_array_equal(out, m)   # downgrade_in_infer: x*m
        assert abs(float(m.mean()) - 0.7) < 0.01


def test_keep_mask_bits_are_the_registry_hash():
    """Element i of an op's mask at step s is kept where mix32(i ^
    mix32(key ^ s)) < keep * 2^32: the plain version's int64 tensor ops
    give the same bits as the Python-int hash (the CUDA kernel's
    arithmetic)."""
    key, step, keep = op_key(11, 3), 5, 0.75
    m = random_bits.keep_mask_reference((3, 40), keep, key,
                                        torch.tensor(step), torch.device(
                                            'cpu'))
    h = mix32(key ^ step)
    want = [mix32(i ^ h) < random_bits.keep_threshold(keep)
            for i in range(120)]
    assert m.reshape(-1).tolist() == want
    assert random_bits.keep_threshold(1.0) == 1 << 32
    assert bool(random_bits.keep_mask_reference(
        (50,), 1.0, key, torch.tensor(0), torch.device('cpu')).all())


def _bn_adam_program():
    pt.reset_default_programs()
    x = pt.layers.data(name='x', shape=[4, 6, 6], dtype='float32')
    label = pt.layers.data(name='label', shape=[1], dtype='int64')
    h = pt.layers.conv2d(x, num_filters=8, filter_size=3, padding=1)
    h = pt.layers.batch_norm(h, act='relu')
    h = pt.layers.pool2d(h, pool_type='avg', global_pooling=True)
    cost = pt.layers.mean(pt.layers.cross_entropy(
        pt.layers.fc(h, size=5, act='softmax'), label))
    pt.optimizer.Adam(learning_rate=0.01).minimize(cost)
    return cost


def test_persistable_tensors_keep_their_address():
    """Every persistable tensor (parameters, Adam moments and beta powers,
    the batch norm's running statistics) keeps its data_ptr from step to
    step while its value moves: the executor writes each scope output
    into the tensor the scope holds."""
    cost = _bn_adam_program()
    rng = np.random.RandomState(6)
    feed = {'x': rng.randn(8, 4, 6, 6).astype('f'),
            'label': rng.randint(0, 5, (8, 1)).astype('int64')}
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe.run(pt.default_startup_program())
        ptrs = {n: scope.find(n).data_ptr() for n in scope.keys()}
        before = {n: scope.numpy(n) for n in scope.keys()}
        for _ in range(3):
            exe.run(feed=feed, fetch_list=[cost])
    assert {n: scope.find(n).data_ptr() for n in scope.keys()} == ptrs
    moved = [n for n in scope.keys()
             if not np.array_equal(scope.numpy(n), before[n])]
    names = pt.default_main_program().global_block().vars
    stats = [n for n in names if n.endswith('.mean') or
             n.endswith('.variance')]
    moments = [n for n in scope.keys() if 'moment' in n]
    assert stats and moments
    assert set(stats + moments) <= set(moved)


def test_host_bound_ops_are_the_startup_draws():
    """The ops that draw initial values on the host are flagged, so no
    plan holding one is ever captured."""
    assert {'uniform_random', 'gaussian_random'} <= HOST_BOUND
    assert 'fill_constant' not in HOST_BOUND and 'dropout' not in HOST_BOUND
