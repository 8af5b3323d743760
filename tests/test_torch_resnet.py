"""ResNet training, port vs reference: the port builds ResNet-50 as the
JAX package does, op for op; a small bottleneck net built from the ported
blocks trains to the same losses, parameters and running statistics in
both layouts and precisions (the JAX package's batch norm on its Pallas
kernel, in interpret mode); full-depth ResNet-50 agrees on its first
step; and the conv2d and pool2d ops agree with their JAX lowerings,
gradients included."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as fluid
from paddle_tpu.models import resnet as JR
from paddle_tpu.ops import conv_ops as jconv

import paddle_tpu_torch as pt
from paddle_tpu_torch.models import resnet as PR
from paddle_tpu_torch.ops import conv_ops as tconv
from paddle_tpu_torch.weights import load_into_scope

LR = 0.01


@pytest.fixture(autouse=True)
def _jax_bn_on_its_kernel(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_BN_PALLAS', '1')
    monkeypatch.setenv('PADDLE_TPU_PALLAS_INTERPRET', '1')


def _same_attr(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


@pytest.mark.parametrize('layout', ['NCHW', 'NHWC'])
def test_resnet50_program_mirrors_reference(layout):
    """Same ops in the same order with the same slots and attrs, the same
    var shapes, the same parameters (names, shapes, flags) and the same
    startup ops."""
    progs = []
    for pkg, model in ((fluid, JR), (pt, PR)):
        pkg.reset_default_programs()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            _, avg_cost, _ = model.resnet50_with_loss(
                image_shape=(3, 64, 64), class_dim=10, data_format=layout)
            pkg.optimizer.Momentum(learning_rate=0.1,
                                   momentum=0.9).minimize(avg_cost)
        progs.append((main, startup))
    (rmain, rstart), (gmain, gstart) = progs
    for rb, gb in ((rmain.global_block(), gmain.global_block()),
                   (rstart.global_block(), gstart.global_block())):
        assert [op.type for op in gb.ops] == [op.type for op in rb.ops]
        for rop, gop in zip(rb.ops, gb.ops):
            assert gop.inputs == rop.inputs, rop.type
            assert gop.outputs == rop.outputs, rop.type
            assert sorted(gop.attrs) == sorted(rop.attrs), rop.type
            for key in rop.attrs:
                assert _same_attr(gop.attrs[key], rop.attrs[key]), \
                    (rop.type, key)
        assert {n: v.shape for n, v in gb.vars.items()} == \
            {n: v.shape for n, v in rb.vars.items()}
    types = [op.type for op in gmain.global_block().ops]
    assert (types.count('conv2d'), types.count('batch_norm'),
            types.count('momentum')) == (53, 53, 161)
    rparams = {p.name: p for p in rmain.all_parameters()}
    gparams = {p.name: p for p in gmain.all_parameters()}
    assert sorted(gparams) == sorted(rparams)
    for name, rp in rparams.items():
        gp = gparams[name]
        assert (gp.shape, gp.dtype, gp.trainable, gp.persistable) == \
            (rp.shape, rp.dtype, rp.trainable, rp.persistable), name


# --------------------------------------------------- training, both packages
def _small_net(pkg, model, layout, amp):
    """Stem conv_bn_layer, max pool, two layer_warp(bottleneck) stages (the
    second strided), global average pool, fc softmax, cross_entropy,
    Momentum(LR, 0.9): every op and block of ResNet-50 at a small size."""
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        img = pkg.layers.data(name='image', shape=[3, 16, 16],
                              dtype='float32')
        label = pkg.layers.data(name='label', shape=[1], dtype='int64')
        h = pkg.layers.transpose(img, [0, 2, 3, 1]) if layout == 'NHWC' \
            else img
        h = model.conv_bn_layer(h, 16, 3, 1, 1, data_format=layout)
        h = pkg.layers.pool2d(h, pool_size=3, pool_type='max', pool_stride=2,
                              pool_padding=1, data_format=layout)
        h = model.layer_warp(model.bottleneck, h, 8, 2, 1,
                             data_format=layout)
        h = model.layer_warp(model.bottleneck, h, 16, 2, 2,
                             data_format=layout)
        h = pkg.layers.pool2d(h, pool_size=4, pool_type='avg',
                              global_pooling=True, data_format=layout)
        pred = pkg.layers.fc(h, size=10, act='softmax')
        avg_cost = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        pkg.optimizer.Momentum(learning_rate=LR,
                               momentum=0.9).minimize(avg_cost)
    main.amp = amp
    return main, startup, avg_cost


def _train_both(build, feed, steps):
    """``steps`` steps in each package from the JAX startup's weights.
    Returns (ref losses, port losses, ref scope, port scope, the names of
    the parameters, running statistics and velocities, and the scopes'
    running statistics after the first step)."""
    jmain, jstart, javg = build(fluid, JR)
    pmain, _, pavg = build(pt, PR)
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(jscope):
        jexe.run(jstart)
    arrays = {n: np.asarray(jscope.find(n)) for n in jscope.keys()
              if jscope.find(n) is not None}
    stats = sorted(n for n in arrays
                   if n.endswith('.mean') or n.endswith('.variance'))
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    load_into_scope(arrays, pscope, pt.CPUPlace())
    ref, got, first_stats = [], [], None
    for _ in range(steps):
        with fluid.scope_guard(jscope):
            ref.append(float(np.asarray(jexe.run(
                jmain, feed=feed, fetch_list=[javg])[0]).reshape(())))
        with pt.scope_guard(pscope):
            got.append(float(pexe.run(pmain, feed=feed,
                                      fetch_list=[pavg])[0].reshape(())))
        if first_stats is None:
            first_stats = [(np.asarray(jscope.find(n)), pscope.numpy(n))
                           for n in stats]
    names = {'params': [p.name for p in pmain.all_parameters()],
             'stats': stats,
             'velocity': [n for n in arrays if n.endswith('_velocity_acc')]}
    return ref, got, jscope, pscope, names, first_stats


def _gap(jscope, pscope, names):
    """Largest |ref - port| over the named vars."""
    return max(float(np.max(np.abs(np.asarray(jscope.find(n), 'float32') -
                                   pscope.numpy(n).astype('float32'))))
               for n in names)


@pytest.mark.parametrize('amp', [None, 'bf16'])
@pytest.mark.parametrize('layout', ['NCHW', 'NHWC'])
def test_small_bottleneck_net_trains_like_reference(layout, amp):
    """3 Momentum steps of the small net (batch 8, 16x16, 10 classes) from
    the same weights. fp32: the same step with sums in another order, so
    losses within rtol 1e-5 and every parameter, running statistic and
    velocity within 1e-4. bf16 AMP: the same casts, but conv backward and
    the other bf16 ops round at their own points, which moves gradients by
    about 1 % (velocities up to a third of their largest entry after 3
    steps): the first loss (the same forward, rounded in bf16 at other
    points) within rtol 1e-3, the later ones within 1e-2 (the JAX
    package's own NCHW and NHWC runs of this net, which differ only in
    how the convolutions round, end 5e-3 apart), parameters
    within LR·steps (the distance a unit velocity moves them), running
    statistics within 2e-2 of their size."""
    feed = PR.make_fake_batch(8, 16, 10, seed=1)
    ref, got, jscope, pscope, names, _ = _train_both(
        lambda pkg, model: _small_net(pkg, model, layout, amp), feed, 3)
    assert np.isfinite(got).all() and got[-1] < got[0]
    if amp is None:
        np.testing.assert_allclose(got, ref, rtol=1e-5)
        assert _gap(jscope, pscope, sum(names.values(), [])) <= 1e-4
        return
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-3)
    np.testing.assert_allclose(got, ref, rtol=1e-2)
    assert _gap(jscope, pscope, names['params']) <= LR * 3
    for n in names['stats']:
        want = np.asarray(jscope.find(n))
        assert np.abs(pscope.numpy(n) - want).max() <= \
            2e-2 * np.abs(want).max(), n


def test_resnet50_full_depth_first_step_matches_reference():
    """ResNet-50 at full depth (32x32, batch 8, 10 classes, NCHW, fp32), 2
    Momentum steps at LR from the same weights. The first step's loss and
    the running statistics it leaves behind (all 53 batch norms, the
    forward at every depth) agree within 1e-3 relative: fp32 sums in
    another order, grown through 53 normalizations over as few as 8
    values. The second loss is only held finite: at this configuration a
    training step amplifies rounding into percent-level changes of the
    next loss within one package (chip_smoke.py's phase 10 prints the host
    against itself with its input scaled by 1 + 2^-23), so no tolerance on
    it would test the port."""
    feed = PR.make_fake_batch(8, 32, 10)

    def build(pkg, model):
        pkg.reset_default_programs()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            _, avg_cost, _ = model.resnet50_with_loss(
                image_shape=(3, 32, 32), class_dim=10, data_format='NCHW')
            pkg.optimizer.Momentum(learning_rate=LR,
                                   momentum=0.9).minimize(avg_cost)
        return main, startup, avg_cost

    ref, got, _, _, names, first_stats = _train_both(build, feed, 2)
    assert len(names['stats']) == 2 * 53
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-3)
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    for want, have in first_stats:
        assert np.abs(have - want).max() <= 1e-3 * np.abs(want).max()


# ------------------------------------------------------ conv2d and pool2d
CONV_CASES = [  # (strides, paddings, dilations, groups)
    ([1, 1], [1, 1], [1, 1], 1),
    ([2, 2], [3, 3], [1, 1], 1),
    ([2, 1], [0, 2], [2, 1], 2),
    ([1, 1], [1, 0, 2, 1], [1, 1], 1),
]


@pytest.mark.parametrize('layout', ['NCHW', 'NHWC'])
@pytest.mark.parametrize('case', CONV_CASES)
def test_conv2d_op_matches_reference(layout, case):
    """The conv2d lowering's output and its gradients against the JAX
    lowering: fp32 convolutions with sums in another order, 1e-4."""
    strides, pads, dilations, groups = case
    rng = np.random.RandomState(len(pads) + strides[0] + groups)
    x = rng.randn(2, 4, 9, 8).astype('float32')
    w = rng.randn(6, 4 // groups, 3, 3).astype('float32')
    gy = None
    outs = []
    for pkg, lower in ((fluid, jconv._conv2d), (pt, tconv._conv2d)):
        xin = x.transpose(0, 2, 3, 1) if layout == 'NHWC' else x
        op = _FakeOp('conv2d', {'Input': ['x'], 'Filter': ['w']},
                     {'Output': ['y']},
                     {'strides': strides, 'paddings': pads,
                      'dilations': dilations, 'groups': groups,
                      'data_format': layout})
        if pkg is fluid:
            def f(a, b, op=op):
                return _jax_lower(lower, op, {'x': a, 'w': b})['y']
            y, vjp = jax.vjp(f, jnp.asarray(xin), jnp.asarray(w))
            if gy is None:
                gy = np.random.RandomState(9).randn(*y.shape).astype('f')
            dx, dw = vjp(jnp.asarray(gy))
            outs.append([np.asarray(v) for v in (y, dx, dw)])
        else:
            a = torch.tensor(xin, requires_grad=True)
            b = torch.tensor(w, requires_grad=True)
            y = _torch_lower(lower, op, {'x': a, 'w': b})['y']
            y.backward(torch.tensor(gy))
            outs.append([v.detach().numpy() for v in (y, a.grad, b.grad)])
    for got, want in zip(outs[1], outs[0]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


POOL_CASES = [  # (type, ksize, strides, paddings, global, ceil, exclusive)
    ('max', [3, 3], [2, 2], [1, 1], False, False, True),
    ('max', [2, 2], [2, 2], [0, 0], False, True, True),
    ('avg', [3, 3], [2, 2], [1, 1], False, False, True),
    ('avg', [3, 3], [2, 2], [1, 1], False, False, False),
    ('avg', [2, 3], [2, 2], [0, 1], False, True, True),
    ('avg', [7, 7], [1, 1], [0, 0], True, False, True),
    ('max', [7, 7], [1, 1], [0, 0], True, False, True),
]


@pytest.mark.parametrize('layout', ['NCHW', 'NHWC'])
@pytest.mark.parametrize('case', POOL_CASES)
def test_pool2d_matches_reference(layout, case):
    """pool2d against the JAX package's _pool2d_impl, output and input
    gradient. The input is a ReLU output, so most 3x3 windows hold ties
    at 0: the max-pool gradient goes to the first of them in row-major
    order on both sides. fp32: 1e-6 (the same windows summed in another
    order)."""
    ptype, k, s, p, glob, ceil, excl = case
    rng = np.random.RandomState(3)
    x = np.maximum(rng.randn(2, 3, 7, 9), 0).astype('float32')
    x[0, 0, :3, :3] = 0.5                      # ties at a positive value
    xin = x.transpose(0, 2, 3, 1) if layout == 'NHWC' else x

    def jf(a):
        return jconv._pool2d_impl(a, ptype, k, [1, 1] if glob else s, p,
                                  glob, ceil_mode=ceil, exclusive=excl,
                                  data_format=layout)

    y, vjp = jax.vjp(jf, jnp.asarray(xin))
    gy = np.random.RandomState(4).rand(*y.shape).astype('float32') + 0.5
    dx, = vjp(jnp.asarray(gy))
    t = torch.tensor(xin, requires_grad=True)
    t4 = t.permute(0, 3, 1, 2) if layout == 'NHWC' else t
    out = tconv.pool2d(t4, ptype, k, [1, 1] if glob else s, p, glob,
                       ceil_mode=ceil, exclusive=excl)
    out = out.permute(0, 2, 3, 1) if layout == 'NHWC' else out
    out.backward(torch.tensor(gy))
    assert out.shape == y.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(dx), rtol=1e-6,
                               atol=1e-6)


def _run_pair(build, feed, steps, startup_feed):
    """Build with ``build(pkg)`` (returns names to fetch) in each package,
    set ``startup_feed`` into the scope after startup, run ``steps``
    steps; returns the last fetches of both (ref, port) as numpy."""
    outs = []
    for pkg in (fluid, pt):
        pkg.reset_default_programs()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            fetch = build(pkg)
        scope, exe = pkg.Scope(), pkg.Executor(pkg.CPUPlace())
        with pkg.scope_guard(scope):
            exe.run(startup)
            for n, v in startup_feed.items():
                scope.set(n, v if pkg is fluid else torch.tensor(v))
            for _ in range(steps):
                res = exe.run(main, feed=feed, fetch_list=fetch)
        outs.append([np.asarray(r) for r in res])
    return outs


@pytest.mark.parametrize('nesterov', [False, True])
def test_momentum_cross_entropy_and_accuracy_match_reference(nesterov):
    """fc + softmax + cross_entropy under Momentum for 3 steps from the
    same weights: the loss, top-2 accuracy with its counts, the weights
    and the velocity agree (fp32, 1e-5). lazy_mode raises."""
    rng = np.random.RandomState(2)
    w0 = rng.randn(6, 5).astype('float32')

    def build(pkg):
        x = pkg.layers.data(name='x', shape=[6], dtype='float32')
        y = pkg.layers.data(name='y', shape=[1], dtype='int64')
        prob = pkg.layers.fc(input=x, size=5, act='softmax', bias_attr=False,
                             param_attr=pkg.ParamAttr(name='w'))
        loss = pkg.layers.mean(pkg.layers.cross_entropy(prob, y))
        correct = pkg.default_main_program().global_block().create_var(
            name='correct', dtype='int32')
        acc = pkg.layers.accuracy(prob, y, k=2, correct=correct)
        pkg.optimizer.Momentum(learning_rate=0.5, momentum=0.9,
                               use_nesterov=nesterov).minimize(loss)
        return [loss.name, acc.name, 'correct', 'w', 'w_velocity_acc']

    feed = {'x': rng.randn(16, 6).astype('float32'),
            'y': rng.randint(0, 5, (16, 1)).astype('int64')}
    ref, got = _run_pair(build, feed, 3, {'w': w0})
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.astype('float32'), r.astype('float32'),
                                   rtol=1e-5, atol=1e-6)
    assert np.abs(ref[3] - w0).min() > 1e-4          # every weight moved
    with pytest.raises(NotImplementedError):          # row-sparse: not ported
        pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                              lazy_mode=True)


class _FakeOp(object):
    def __init__(self, type, inputs, outputs, attrs):
        self.type, self.inputs, self.outputs, self.attrs = \
            type, inputs, outputs, attrs

    def input(self, slot):
        return self.inputs[slot][0]

    def output(self, slot):
        return self.outputs[slot][0]


class _NoVars(object):
    """A block without var metadata: no output is stop_gradient."""

    def _find_var_recursive(self, name):
        return None


def _jax_lower(lower, op, env):
    from paddle_tpu.core.registry import LoweringContext
    lower(LoweringContext(env, op, _NoVars(), 0, None))
    return env


def _torch_lower(lower, op, env):
    from paddle_tpu_torch.core.registry import LoweringContext
    lower(LoweringContext(env, op, _NoVars(), 0, torch.device('cpu')))
    return env
