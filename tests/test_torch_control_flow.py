"""The control-flow layers and ops, port vs reference, on the CPU: the
nine cases of tests/test_control_flow.py (StaticRNN, While, IfElse,
DynamicRNN, the tensor arrays, pruning through sub-blocks, an error clip
inside a step block), each built in both packages and run from the
reference startup's scope on the same numpy feed; then a parameter read
only inside a DynamicRNN step (its gradient is the reference's, not zero),
the sub-block liveness of the executor's plan, and a plan holding
``while`` being host-bound.

Tolerances: the integer results, the array reads and the counters exact;
float results of sums within rtol 1e-6 (the same additions in the same
order); gradients and parameter changes within rtol 1e-5 (products summed
in another order).
"""

import json

import numpy as np
import pytest

import jax  # noqa: F401  (port tests import both frameworks)

import paddle_tpu as fluid
from paddle_tpu.core.serialize import program_to_dict as jax_to_dict

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.serialize import program_from_dict
from paddle_tpu_torch.weights import load_into_scope


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype('f')


def run_both(build, feed, steps=1, optimizer=None, trace=None):
    """``build(pkg)`` appends the layers of a case to the default programs
    and returns the vars to fetch (with ``optimizer(pkg)``, the first is
    the loss it minimizes). Both packages run ``steps`` steps from the
    reference startup's scope: (reference fetches, port fetches, reference
    scope, port scope, the startup's arrays), fetches of the last step;
    ``trace``, a list, takes (reference, port) fetches of every step."""
    out = []
    for pkg in (fluid, pt):
        pkg.reset_default_programs()
        fetch = build(pkg)
        if optimizer is not None:
            optimizer(pkg).minimize(fetch[0])
        out.append((pkg.default_main_program(),
                    pkg.default_startup_program(), [v.name for v in fetch]))
    (jmain, jstart, names), (pmain, _, pnames) = out
    assert names == pnames
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(jscope):
        jexe.run(jstart)
    arrays = {n: np.asarray(jscope.find(n)) for n in jscope.keys()
              if jscope.find(n) is not None}
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    load_into_scope(arrays, pscope, pt.CPUPlace())
    for _ in range(steps):
        with fluid.scope_guard(jscope):
            ref = [np.asarray(v) for v in
                   jexe.run(jmain, feed=feed, fetch_list=names)]
        with pt.scope_guard(pscope):
            got = [np.asarray(v) for v in
                   pexe.run(pmain, feed=feed, fetch_list=names)]
        if trace is not None:
            trace.append((ref, got))
    return ref, got, jscope, pscope, arrays


def _equal(ref, got):
    for r, g in zip(ref, got):
        assert r.shape == g.shape
        np.testing.assert_array_equal(g, r)


def test_static_rnn_cumsum():
    def build(pkg):
        L = pkg.layers
        x = L.data(name='x', shape=[5, 3], dtype='float32')
        rnn = L.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            mem = rnn.memory(batch_ref=x, shape=[3], value=0.0)
            acc = L.elementwise_add(x=mem, y=xt)
            rnn.update_memory(mem, acc)
            rnn.step_output(acc)
        return [rnn()]
    xs = _rand(2, 5, 3)
    ref, got, _, _, _ = run_both(build, {'x': xs})
    _equal(ref, got)
    np.testing.assert_allclose(got[0], np.cumsum(xs, axis=1), rtol=1e-6)


def _countdown(pkg):
    L = pkg.layers
    i = L.fill_constant(shape=[1], dtype='int64', value=0)
    limit = L.fill_constant(shape=[1], dtype='int64', value=5)
    cond = L.less_than(x=i, y=limit)
    total = L.fill_constant(shape=[1], dtype='float32', value=0.0)
    w = L.While(cond=cond)
    with w.block():
        L.increment(x=i, value=1, in_place=True)
        L.increment(x=total, value=2.0, in_place=True)
        L.less_than(x=i, y=limit, cond=cond)
    return [total, i]


def test_while_countdown():
    ref, got, _, _, _ = run_both(_countdown, {})
    _equal(ref, got)
    np.testing.assert_array_equal(got[0], [10.0])
    np.testing.assert_array_equal(got[1], [5])


def _if_else(pkg, outer_constant):
    L = pkg.layers
    x = L.data(name='x', shape=[3], dtype='float32')
    zeros = L.fill_constant_batch_size_like(x, shape=[1, 1],
                                            dtype='float32', value=0.0)
    bias = L.fill_constant(shape=[3], dtype='float32', value=7.0) \
        if outer_constant else None
    cond = L.less_than(x=zeros, y=L.reduce_sum(x, dim=1, keep_dim=True))
    ie = L.IfElse(cond)
    with ie.true_block():
        ie.output(L.elementwise_add(x=x, y=bias) if outer_constant
                  else L.scale(x, scale=2.0))
    with ie.false_block():
        ie.output(L.scale(x, scale=-1.0))
    return list(ie())


XS_SIGNED = np.array([[1, 1, 1], [-1, -1, -1], [0.5, -2, 3], [0, 0, 0]],
                     'float32')


def test_if_else_per_example_select():
    ref, got, _, _, _ = run_both(lambda pkg: _if_else(pkg, False),
                                 {'x': XS_SIGNED})
    _equal(ref, got)
    np.testing.assert_array_equal(got[0][0], XS_SIGNED[0] * 2.0)
    np.testing.assert_array_equal(got[0][1], -XS_SIGNED[1])


def test_if_else_branch_reads_outer_constant():
    """A var produced in the main block and read only inside a branch
    keeps its producer through the executor's pruning."""
    ref, got, _, _, _ = run_both(lambda pkg: _if_else(pkg, True),
                                 {'x': XS_SIGNED})
    _equal(ref, got)
    np.testing.assert_array_equal(got[0][0], XS_SIGNED[0] + 7.0)


def test_program_prune_keeps_sub_block_producers():
    """Program.prune walks sub-blocks: the branch's outer constant keeps
    its fill_constant, and the port keeps the reference's op list."""
    kept = []
    for pkg in (fluid, pt):
        pkg.reset_default_programs()
        out, = _if_else(pkg, True)
        pruned = pkg.default_main_program().prune([out])
        kept.append([op.type for op in pruned.global_block().ops])
    assert kept[1] == kept[0]
    assert kept[1].count('fill_constant') == 1


def test_while_body_reads_outer_constant():
    def build(pkg):
        L = pkg.layers
        i = L.fill_constant(shape=[1], dtype='int64', value=0)
        limit = L.fill_constant(shape=[1], dtype='int64', value=3)
        step = L.fill_constant(shape=[1], dtype='float32', value=2.5)
        cond = L.less_than(x=i, y=limit)
        total = L.fill_constant(shape=[1], dtype='float32', value=0.0)
        w = L.While(cond=cond)
        with w.block():
            L.increment(x=i, value=1, in_place=True)
            acc = L.elementwise_add(x=total, y=step)
            L.assign(acc, total)
            L.less_than(x=i, y=limit, cond=cond)
        return [total, i]
    ref, got, _, _, _ = run_both(build, {})
    _equal(ref, got)
    np.testing.assert_array_equal(got[0], [7.5])


def _drnn_cumsum(pkg):
    L = pkg.layers
    x = L.data(name='x', shape=[4, 2], dtype='float32')
    length = L.data(name='len', shape=[], dtype='int64')
    drnn = L.DynamicRNN(length=length)
    with drnn.block():
        xt = drnn.step_input(x)
        mem = drnn.memory(batch_ref=x, shape=[2], value=0.0)
        acc = L.elementwise_add(x=mem, y=xt)
        drnn.update_memory(mem, acc)
        drnn.output(acc)
    return [drnn()]


def test_dynamic_rnn_respects_lengths():
    xs = np.ones((3, 4, 2), dtype='float32')
    lens = np.array([2, 4, 0], dtype='int64')
    ref, got, _, _, _ = run_both(_drnn_cumsum, {'x': xs, 'len': lens})
    _equal(ref, got)
    np.testing.assert_array_equal(got[0][0, :, 0], [1, 2, 0, 0])
    np.testing.assert_array_equal(got[0][1, :, 0], [1, 2, 3, 4])
    np.testing.assert_array_equal(got[0][2], 0)


def test_array_write_read():
    """Two writes and reads, the array's length (its capacity, 64, as the
    reference gives it) and is_empty, exact."""
    def build(pkg):
        L = pkg.layers
        x = L.data(name='x', shape=[3], dtype='float32')
        i0 = L.fill_constant(shape=[1], dtype='int64', value=0)
        i1 = L.fill_constant(shape=[1], dtype='int64', value=1)
        arr = L.array_write(x, i0)
        L.array_write(L.scale(x, 3.0), i1, array=arr)
        return [L.array_read(arr, i0), L.array_read(arr, i1),
                L.array_length(arr), L.is_empty(x)]
    xs = _rand(2, 3, seed=1)
    ref, got, _, _, _ = run_both(build, {'x': xs})
    _equal(ref, got)
    np.testing.assert_array_equal(got[0], xs)
    np.testing.assert_array_equal(got[1], xs * np.float32(3.0))
    assert int(got[2].reshape(-1)[0]) == 64
    assert not bool(got[3].reshape(-1)[0])


def _clipped_rnn(pkg, clip):
    L = pkg.layers
    x = L.data(name='x', shape=[3, 4], dtype='float32')
    rnn = L.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        mem = rnn.memory(batch_ref=x, shape=[4], value=0.0)
        h = L.fc(input=[xt, mem], size=4, bias_attr=False,
                 param_attr=[pkg.ParamAttr(name='rx_w'),
                             pkg.ParamAttr(name='rh_w')])
        if clip:
            h.error_clip = pkg.clip.ErrorClipByValue(max=1e-4)
        rnn.update_memory(mem, h)
        rnn.step_output(h)
    return [L.reduce_sum(L.scale(rnn(), scale=1000.0))]


@pytest.mark.parametrize('clip', [False, True], ids=['plain', 'clipped'])
def test_error_clip_inside_rnn_sub_block(clip):
    """An error_clip on a StaticRNN step var clamps the gradient inside
    the step: one SGD(1.0) step moves rx_w as the reference's does (rtol
    1e-5), by more than 1e2 unclipped and less than 1e-1 clipped."""
    ref, got, jscope, pscope, w0 = run_both(
        lambda pkg: _clipped_rnn(pkg, clip), {'x': np.ones((2, 3, 4), 'f')},
        optimizer=lambda pkg: pkg.optimizer.SGD(learning_rate=1.0))
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    want = np.asarray(jscope.find('rx_w')) - w0['rx_w']
    moved = pscope.numpy('rx_w') - w0['rx_w']
    np.testing.assert_allclose(moved, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    dw = float(np.abs(moved).max())
    assert (dw < 1e-1) if clip else (dw > 1e2), dw


def _step_only_param(pkg):
    """A DynamicRNN whose step reads a parameter nothing outside reads
    (the fc's weight, drnn_w), over lengths that end rows early."""
    L = pkg.layers
    x = L.data(name='x', shape=[5, 3], dtype='float32')
    length = L.data(name='len', shape=[], dtype='int64')
    drnn = L.DynamicRNN(length=length)
    with drnn.block():
        xt = drnn.step_input(x)
        mem = drnn.memory(batch_ref=x, shape=[4], value=0.0)
        h = L.tanh(L.elementwise_add(
            L.fc(input=xt, size=4, bias_attr=False,
                 param_attr=pkg.ParamAttr(name='drnn_w')),
            L.fc(input=mem, size=4, bias_attr=False,
                 param_attr=pkg.ParamAttr(name='drnn_u'))))
        drnn.update_memory(mem, h)
        drnn.output(h)
    loss = L.reduce_mean(L.square(drnn()))
    pkg.backward.append_backward(loss)
    return [loss, pkg.default_main_program().global_block()
            .var('drnn_w@GRAD'),
            pkg.default_main_program().global_block().var('drnn_u@GRAD')]


def test_param_read_only_in_dynamic_rnn_step_gets_its_gradient():
    """drnn_w and drnn_u are read only inside the step block: the plan
    takes them as scope inputs (leaves of the backward), so their
    gradients are the reference's within 1e-5, not zero."""
    feed = {'x': _rand(3, 5, 3, seed=4),
            'len': np.array([5, 2, 0], 'int64')}
    ref, got, _, _, _ = run_both(_step_only_param, feed)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    for r, g in zip(ref[1:], got[1:]):
        assert np.abs(r).max() > 1e-3
        np.testing.assert_allclose(g, r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max())


def test_plan_liveness_walks_sub_blocks():
    """The executor's plan: a parameter read only in the step block is a
    scope input, a feed read only there is asked for, and nothing the
    step reads is freed before the dynamic_rnn op."""
    from paddle_tpu_torch.core.executor import _Plan, _prune_ops
    pt.reset_default_programs()
    fetch = _step_only_param(pt)
    program = pt.default_main_program()
    block = program.global_block()
    ops = _prune_ops(block, list(block.ops), [v.name for v in fetch])
    plan = _Plan(block, ops, ['x', 'len'], [v.name for v in fetch])
    assert {'drnn_w', 'drnn_u'} <= set(plan.scope_in)
    assert plan.needed_feeds == ['len', 'x']
    loop = next(i for i, op in enumerate(ops) if op.type == 'dynamic_rnn')
    for i, names in plan.frees.items():
        if i < loop:
            assert not {'drnn_w', 'drnn_u', 'x', 'len'} & set(names), i
    assert not plan.host_bound


def test_plan_holding_while_is_host_bound():
    """``while`` is registered host-bound: a plan that holds it, or holds
    an op whose sub-block holds it, runs eagerly; a StaticRNN or IfElse
    plan does not."""
    from paddle_tpu_torch.core.registry import HOST_BOUND
    assert 'while' in HOST_BOUND
    exe = pt.Executor(pt.CPUPlace())
    pt.reset_default_programs()
    total, i = _countdown(pt)
    plan = exe._plan(pt.default_main_program(), [], [total.name])
    assert plan.host_bound
    for build, feeds in ((lambda: _if_else(pt, True), ['x']),
                         (lambda: _drnn_cumsum(pt), ['x', 'len'])):
        pt.reset_default_programs()
        out, = build()
        assert not exe._plan(pt.default_main_program(), feeds,
                             [out.name]).host_bound


def test_reference_program_dict_runs_in_the_port():
    """The reference's serialized DynamicRNN and IfElse programs (sub-block
    attributes through JSON) load into the port and give its results."""
    feed = {'x': np.ones((3, 4, 2), 'f'), 'len': np.array([2, 4, 0])}
    for build, f in ((_drnn_cumsum, feed),
                     (lambda pkg: _if_else(pkg, True), {'x': XS_SIGNED})):
        fluid.reset_default_programs()
        out, = build(fluid)
        ref = fluid.Executor(fluid.CPUPlace()).run(feed=f, fetch_list=[out])
        main = program_from_dict(json.loads(json.dumps(jax_to_dict(
            fluid.default_main_program()))))
        got = pt.Executor(pt.CPUPlace()).run(main, feed=f,
                                             fetch_list=[out.name])
        np.testing.assert_array_equal(np.asarray(got[0]),
                                      np.asarray(ref[0]))


@pytest.mark.parametrize('name', ['while', 'if_else', 'static_rnn'])
def test_smoke_control_flow_programs_match_the_reference(name):
    """The programs phase 20c of chip_smoke.py runs on the card (a While
    countdown over a tensor array, an IfElse, a StaticRNN) equal the
    reference's results exactly on the host."""
    from chip_smoke import control_flow_builds
    feed = control_flow_builds(pt)[name][1]
    ref, got, _, _, _ = run_both(
        lambda pkg: control_flow_builds(pkg)[name][0](), feed)
    _equal(ref, got)
    if name == 'while':
        np.testing.assert_array_equal(got[0], feed['x'] * np.float32(64.0))
        assert int(got[1][0]) == 6 and int(got[2][0]) == 64
