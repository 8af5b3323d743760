"""The conv path's image classifiers, port against reference: MobileNet v1
(both layouts), SE-ResNeXt, VGG-16 and vgg_bn_drop, AlexNet, GoogLeNet and
the three MNIST nets build the reference's Program op for op at their
published input sizes; AlexNet and the MNIST nets train 3 Momentum steps
from the reference startup's weights to its losses, first gradients and
parameters (three_steps_match), as GoogLeNet does in
tests/test_torch_googlenet.py. The batch-norm nets (MobileNet,
SE-ResNeXt, vgg_bn_drop) are held on their first step, its gradients
included (first_step_matches), by tests/test_torch_mobilenet.py,
test_torch_resnext.py and test_torch_cnn_deep.py (the JAX package's
batch norm on its Pallas kernel, in interpret mode).

Dropout is fixed inside the models (vgg16 and alexnet 0.5, se_resnext 0.5,
googlenet 0.4, vgg_bn_drop 0.3 to 0.5), and the two packages draw their
masks from different generators by design. So the training tests apply
one edit to both programs after building: every dropout op's
dropout_prob is set to 0. The program tests keep the published rates."""

import numpy as np
import pytest

import jax  # noqa: F401  (port tests import both frameworks)

import paddle_tpu as fluid
from paddle_tpu.models import (alexnet as JA, googlenet as JG, lenet as JL,
                               mobilenet as JM, resnext as JX, vgg as JV)

import paddle_tpu_torch as pt
from paddle_tpu_torch.models import (alexnet as PA, googlenet as PG,
                                     lenet as PL, mobilenet as PM,
                                     resnext as PX, vgg as PV)
from paddle_tpu_torch.weights import load_into_scope

LR = 0.01
MODELS = {'mobilenet': (JM, PM), 'resnext': (JX, PX), 'vgg': (JV, PV),
          'alexnet': (JA, PA), 'googlenet': (JG, PG), 'lenet': (JL, PL)}


@pytest.fixture(autouse=True)
def _jax_bn_on_its_kernel(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_BN_PALLAS', '1')
    monkeypatch.setenv('PADDLE_TPU_PALLAS_INTERPRET', '1')


def _same_attr(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def _classifier(pkg, model, builder, image, **kw):
    """image data [3 or 1, image, image], an int64 label, the builder's
    softmax output, mean cross-entropy."""
    chans = 1 if builder in ('lenet', 'mlp', 'softmax') else 3
    if builder in ('lenet', 'mlp', 'softmax'):
        fn = {'lenet': model.convolutional_neural_network,
              'mlp': model.multilayer_perceptron,
              'softmax': model.softmax_regression}[builder]
        _, avg, _ = fn()
        return avg
    img = pkg.layers.data(name='image', shape=[chans, image, image],
                          dtype='float32')
    label = pkg.layers.data(name='label', shape=[1], dtype='int64')
    predict = {
        'mobile_net': lambda: model.mobile_net(img, **kw),
        'se_resnext': lambda: model.se_resnext(img, **kw),
        'vgg16': lambda: model.vgg16(img, **kw),
        'vgg_bn_drop': lambda: model.vgg_bn_drop(img, **kw),
        'alexnet': lambda: model.alexnet(img, **kw),
        'googlenet': lambda: model.googlenet(img, **kw),
    }[builder]()
    return pkg.layers.mean(pkg.layers.cross_entropy(predict, label))


def _build(pkg, model, builder, image, amp=None, momentum=True, lr=LR,
           **kw):
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        avg = _classifier(pkg, model, builder, image, **kw)
        if momentum:
            pkg.optimizer.Momentum(learning_rate=lr,
                                   momentum=0.9).minimize(avg)
    main.amp = amp
    return main, startup, avg


# (id, model, builder, input size, builder arguments): the published
# inputs (ImageNet 224, CIFAR 32, MNIST 28)
PUBLISHED = [
    ('mobilenet_nchw', 'mobilenet', 'mobile_net', 224,
     dict(class_dim=1000, data_format='NCHW')),
    ('mobilenet_nhwc', 'mobilenet', 'mobile_net', 224,
     dict(class_dim=1000, data_format='NHWC')),
    ('se_resnext50', 'resnext', 'se_resnext', 224,
     dict(class_dim=1000, depth=50)),
    ('vgg16', 'vgg', 'vgg16', 224, dict(class_dim=1000)),
    ('vgg_bn_drop', 'vgg', 'vgg_bn_drop', 32, dict(class_dim=10)),
    ('alexnet', 'alexnet', 'alexnet', 224, dict(class_dim=1000)),
    ('googlenet', 'googlenet', 'googlenet', 224, dict(class_dim=1000)),
    ('lenet', 'lenet', 'lenet', 28, {}),
    ('mlp', 'lenet', 'mlp', 28, {}),
    ('softmax_regression', 'lenet', 'softmax', 28, {}),
]
# the number of (conv2d, batch_norm, dropout, lrn) ops of each
OP_COUNTS = {'mobilenet_nchw': (27, 27, 0, 0),
             'mobilenet_nhwc': (27, 27, 0, 0), 'se_resnext50': (53, 53, 1, 0), 'vgg16': (13, 0, 2, 0),
             'vgg_bn_drop': (13, 14, 10, 0), 'alexnet': (5, 0, 2, 2),
             'googlenet': (57, 0, 1, 0), 'lenet': (2, 0, 0, 0),
             'mlp': (0, 0, 0, 0), 'softmax_regression': (0, 0, 0, 0)}


@pytest.mark.parametrize('case', PUBLISHED, ids=[c[0] for c in PUBLISHED])
def test_program_mirrors_reference(case):
    """Same ops in the same order with the same slots and attrs, the same
    var shapes, the same parameters (names, shapes, flags) and the same
    startup ops, with Momentum's update ops."""
    key, mod, builder, image, kw = case
    jmodel, pmodel = MODELS[mod]
    progs = [_build(pkg, model, builder, image, **kw)[:2]
             for pkg, model in ((fluid, jmodel), (pt, pmodel))]
    (rmain, rstart), (gmain, gstart) = progs
    for rb, gb in ((rmain.global_block(), gmain.global_block()),
                   (rstart.global_block(), gstart.global_block())):
        assert [op.type for op in gb.ops] == [op.type for op in rb.ops]
        for rop, gop in zip(rb.ops, gb.ops):
            assert gop.inputs == rop.inputs, rop.type
            assert gop.outputs == rop.outputs, rop.type
            assert sorted(gop.attrs) == sorted(rop.attrs), rop.type
            for a in rop.attrs:
                assert _same_attr(gop.attrs[a], rop.attrs[a]), (rop.type, a)
        assert {n: v.shape for n, v in gb.vars.items()} == \
            {n: v.shape for n, v in rb.vars.items()}
    types = [op.type for op in gmain.global_block().ops]
    assert tuple(types.count(t) for t in ('conv2d', 'batch_norm', 'dropout',
                                          'lrn')) == OP_COUNTS[key]
    rparams = {p.name: p for p in rmain.all_parameters()}
    gparams = {p.name: p for p in gmain.all_parameters()}
    assert sorted(gparams) == sorted(rparams)
    for name, rp in rparams.items():
        gp = gparams[name]
        assert (gp.shape, gp.dtype, gp.trainable, gp.persistable) == \
            (rp.shape, rp.dtype, rp.trainable, rp.persistable), name


def no_dropout(program):
    """The edit both programs take before training: every dropout op's
    rate set to 0 (the packages' masks differ by design)."""
    for op in program.global_block().ops:
        if op.type == 'dropout':
            op.attrs['dropout_prob'] = 0.0
    return program


def reference_run(build, feed, steps=3):
    """``steps`` Momentum steps of the JAX package's program from its
    startup's weights, dropout at 0. Returns (losses, the first step's
    gradient of each parameter, the running statistics after it, scope,
    the startup's arrays, parameter names)."""
    jmain, jstart, javg = build(fluid, 0)
    no_dropout(jmain)
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(jscope):
        jexe.run(jstart)
    arrays = {n: np.asarray(jscope.find(n)) for n in jscope.keys()
              if jscope.find(n) is not None}
    params = [p.name for p in jmain.all_parameters()]
    losses, grads, stats = [], None, None
    for i in range(steps):
        with fluid.scope_guard(jscope):
            out = jexe.run(jmain, feed=feed, fetch_list=[javg] + (
                [p + '@GRAD' for p in params] if i == 0 else []))
        losses.append(float(np.asarray(out[0]).reshape(())))
        if i == 0:
            grads = dict(zip(params, [np.asarray(g, 'float64')
                                      for g in out[1:]]))
            stats = {n: np.asarray(jscope.find(n), 'float32')
                     for n in _stats(arrays)}
    return losses, grads, stats, jscope, arrays, params


def port_run(build, arrays, feed, steps=3):
    """The same steps in the port from ``arrays``. Returns (losses, first
    gradients, running statistics after the first step, scope)."""
    pmain, _, pavg = build(pt, 1)
    no_dropout(pmain)
    params = [p.name for p in pmain.all_parameters()]
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    load_into_scope(arrays, pscope, pt.CPUPlace())
    losses, grads, stats = [], None, None
    for i in range(steps):
        with pt.scope_guard(pscope):
            out = pexe.run(pmain, feed=feed, fetch_list=[pavg] + (
                [p + '@GRAD' for p in params] if i == 0 else []))
        losses.append(float(np.asarray(out[0]).reshape(())))
        if i == 0:
            grads = dict(zip(params, [np.asarray(g, 'float64')
                                      for g in out[1:]]))
            stats = {n: pscope.numpy(n).astype('float32')
                     for n in _stats(arrays)}
    return losses, grads, stats, pscope


def _stats(arrays):
    return [n for n in arrays if n.endswith('.mean') or
            n.endswith('.variance')]


def train_both(build, feed, steps=3):
    """``steps`` Momentum steps in each package from the reference
    startup's weights, dropout at 0. Returns (reference losses, port
    losses, reference scope, port scope, parameter names, the running
    statistics after the first step as {name: (reference, port)}, the
    first step's gradients as {parameter: (reference, port)})."""
    ref, rgrads, rstats, jscope, arrays, params = reference_run(
        build, feed, steps)
    got, pgrads, pstats, pscope = port_run(build, arrays, feed, steps)
    return ref, got, jscope, pscope, params, \
        {n: (rstats[n], pstats[n]) for n in rstats}, \
        {n: (rgrads[n], pgrads[n]) for n in params}


def grad_gap(grads, floor=1e-3):
    """Largest ||port - reference|| / ||reference|| over the parameters'
    first-step gradients {parameter: (reference, port)}, each parameter's
    norm floored at ``floor`` times the largest parameter's (a conv bias
    before a batch norm has gradient 0 up to rounding)."""
    norms = {n: float(np.linalg.norm(r)) for n, (r, _) in grads.items()}
    top = max(norms.values())
    return max(float(np.linalg.norm(g - r)) /
               max(norms[n], floor * top, 1e-30)
               for n, (r, g) in grads.items())


def grad_norm_gap(grads):
    """||port - reference|| / ||reference|| over every parameter's first
    gradient together."""
    num = sum(float(np.square(g - r).sum()) for r, g in grads.values())
    den = sum(float(np.square(r).sum()) for r, _ in grads.values())
    return (num / den) ** 0.5


def first_gap(first):
    """Largest gap over the first step's running statistics, each against
    its largest |reference| entry."""
    return max([0.0] + [float(np.abs(r - g).max()) /
                        max(float(np.abs(r).max()), 1e-30)
                        for r, g in first.values()])


def gap(jscope, pscope, names):
    """Largest |ref - port| over the named vars."""
    return max(float(np.max(np.abs(
        np.asarray(jscope.find(n), 'float32') -
        pscope.numpy(n).astype('float32')))) for n in names)


def image_feed(batch, image, chans=3, classes=10, seed=0):
    rng = np.random.RandomState(seed)
    return {'image': rng.rand(batch, chans, image, image).astype('float32'),
            'label': rng.randint(0, classes, (batch, 1)).astype('int64')}


def mnist_feed(batch, seed=0):
    rng = np.random.RandomState(seed)
    return {'img': rng.rand(batch, 1, 28, 28).astype('float32'),
            'label': rng.randint(0, 10, (batch, 1)).astype('int64')}


# (id, model, builder, image, batch, builder arguments): the sizes of
# tests/test_models_e2e.py (the MNIST nets at batch 8)
SMALL = [
    ('alexnet', 'alexnet', 'alexnet', 67, 4, dict(class_dim=10)),
    ('lenet', 'lenet', 'lenet', 28, 8, {}),
    ('mlp', 'lenet', 'mlp', 28, 8, {}),
    ('softmax_regression', 'lenet', 'softmax', 28, 8, {}),
]


def small_build(case, amp, lr=LR):
    _, mod, builder, image, _, kw = case

    def build(pkg, side):
        return _build(pkg, MODELS[mod][side], builder, image, amp=amp, lr=lr,
                      **kw)
    return build


def case_feed(case):
    key, _, _, image, batch, _ = case
    if key in ('lenet', 'mlp', 'softmax_regression'):
        return mnist_feed(batch)
    return image_feed(batch, image)


def grads_match(grads, bounds):
    """The first step's gradients held to ``bounds``: (grad_gap's, or None,
    grad_norm_gap's)."""
    each, whole = bounds
    if each is not None:
        assert grad_gap(grads) <= each, grad_gap(grads)
    assert grad_norm_gap(grads) <= whole, grad_norm_gap(grads)


def three_steps_match(case, amp, lr, grads):
    """3 Momentum steps (lr, 0.9) from the same weights. fp32: the same
    step with sums in other orders: losses within rtol 1e-5, every
    parameter within 1e-5. bf16 AMP: the same casts, the convolutions and
    the other bf16 ops rounding at their own points: losses within rtol
    1e-2, parameters within lr·3 (the distance a unit velocity moves them
    in 3 steps). The first step's gradients within ``grads``
    (grads_match)."""
    ref, got, jscope, pscope, params, _, first = train_both(
        small_build(case, amp, lr), case_feed(case))
    assert np.isfinite(got).all() and got[-1] < got[0], got
    if amp is None:
        np.testing.assert_allclose(got, ref, rtol=1e-5)
        assert gap(jscope, pscope, params) <= 1e-5
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-2)
        assert gap(jscope, pscope, params) <= lr * 3
    grads_match(first, grads)


@pytest.mark.parametrize('amp', [None, 'bf16'], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('case', SMALL, ids=[c[0] for c in SMALL])
def test_small_build_trains_like_reference(case, amp):
    """three_steps_match at LR 0.01; the first step's gradients within
    1e-5 at fp32 (each parameter's and all together), all together
    within 0.1 under bf16 AMP (AlexNet's reads 0.049, and 0.042 with the
    images scaled by 1 + 2^-23)."""
    three_steps_match(case, amp, LR,
                      (1e-5, 1e-5) if amp is None else (None, 0.1))


def first_step_matches(case, amp, stats_tol, grads):
    """The check of the nets whose later steps a one-ulp nudge of the
    images already moves by 1e-4 to percents in either package
    (tests/torch_cnn_conditioning.py prints it; PERF.md keeps its
    readings): 2 steps from the same weights. The first step's loss
    within rtol 1e-5 at fp32 (1e-2 under bf16 AMP), the running
    statistics it leaves within ``stats_tol`` of their largest entry and
    its gradients within ``grads`` (grads_match, None: not held); the
    second loss finite."""
    ref, got, _, _, _, first, first_grads = train_both(
        small_build(case, amp), case_feed(case), steps=2)
    assert np.isfinite(got).all() and np.isfinite(ref).all(), (ref, got)
    np.testing.assert_allclose(got[0], ref[0],
                               rtol=1e-5 if amp is None else 1e-2)
    assert first_gap(first) <= stats_tol
    if grads is not None:
        grads_match(first_grads, grads)
