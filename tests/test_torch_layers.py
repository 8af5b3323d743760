"""The public layer surface of the port against the JAX package: the
arguments and methods the reference accepts and the port refused before
(layers.fc(use_mkldnn=), layers.data(type=), Constant(force_cpu=), the
LayerHelper methods, observe's handle accessors and enable(every_secs=)),
the new layers (signatures and the programs they build, dict for dict,
provenance included), nets.* at a small width, Variable's arithmetic
sugar, Program.create_block / rollback / prepend_op, core/flags.py,
core/lod.py, the top-level names, and the op and layer coverage."""

import importlib
import inspect
import json
import pkgutil

import numpy as np
import pytest

import jax  # noqa: F401  (port tests import both frameworks)
import torch

import paddle_tpu as fluid
from paddle_tpu import observe as jobs
from paddle_tpu.core import flags as jflags
from paddle_tpu.core import lod as jlod
from paddle_tpu.core import registry as jregistry
from paddle_tpu.core.serialize import program_to_dict as jax_to_dict
from paddle_tpu.layers.helper import LayerHelper as JHelper

import paddle_tpu_torch as pt
from paddle_tpu_torch import observe as pobs
from paddle_tpu_torch.core import flags as pflags
from paddle_tpu_torch.core import lod as plod
from paddle_tpu_torch.core import registry as pregistry
from paddle_tpu_torch.core.serialize import program_to_dict
from paddle_tpu_torch.layers.helper import LayerHelper as PHelper

PKGS = ((fluid, JHelper), (pt, PHelper))


def _dicts(build):
    """build(pkg, helper_cls) on fresh programs in each package; returns
    the two (main, startup) dicts as JSON would carry them."""
    out = []
    for pkg, helper in PKGS:
        pkg.reset_default_programs()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            build(pkg, helper)
        to_dict = jax_to_dict if pkg is fluid else program_to_dict
        out.append(json.loads(json.dumps([to_dict(main),
                                          to_dict(startup)])))
    return out


def _same_program(build):
    ref, got = _dicts(build)
    assert got == ref


def _x(pkg, shape=(4, 8), name='x', dtype='float32'):
    return pkg.layers.data(name=name, shape=list(shape), dtype=dtype,
                           append_batch_size=False)


# --------------------------------------------- the arguments once refused
def _custom_layer(pkg, helper_cls):
    """A layer written against the reference's LayerHelper: its input by
    helper.input(), a global var set by set_variable_initializer, a
    variable and a tmp variable of the helper."""
    x = _x(pkg)
    helper = helper_cls('my_layer', input=x)
    inp = helper.input()
    g = helper.create_global_variable(name='my_global', shape=[1],
                                      dtype='float32', persistable=True)
    helper.set_variable_initializer(g, pkg.initializer.Constant(
        2.5, force_cpu=True))
    v = helper.create_variable(name='my_var', dtype='float32')
    t = helper.create_tmp_variable('float32')
    helper.append_op(type='elementwise_mul', inputs={'X': [inp], 'Y': [g]},
                     outputs={'Out': [t]}, attrs={'axis': -1})
    helper.append_op(type='scale', inputs={'X': [t]}, outputs={'Out': [v]},
                     attrs={'scale': 2.0})


REFUSED = {
    'fc_use_mkldnn': lambda pkg, h: pkg.layers.fc(
        input=_x(pkg), size=3, use_mkldnn=True),
    'data_type': lambda pkg, h: pkg.layers.data(
        name='d', shape=[3], dtype='float32', type='dense'),
    'constant_force_cpu': lambda pkg, h: pkg.layers.create_parameter(
        shape=[3], dtype='float32', name='p',
        default_initializer=pkg.initializer.Constant(0.5, force_cpu=True)),
    'layer_helper': _custom_layer,
}


@pytest.mark.parametrize('case', sorted(REFUSED))
def test_refused_arguments_build_the_reference_program(case):
    """Each call the port refused (TypeError or AttributeError) before
    now builds the program the reference builds."""
    _same_program(REFUSED[case])


def test_custom_layer_runs_as_the_reference():
    """The LayerHelper layer above gives the reference's values."""
    x = np.random.RandomState(0).randn(4, 8).astype('f')
    got = []
    for pkg, helper in PKGS:
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            _custom_layer(pkg, helper)
        scope, exe = pkg.Scope(), pkg.Executor(pkg.CPUPlace())
        with pkg.scope_guard(scope):
            exe.run(startup)
            got.append(np.asarray(exe.run(main, feed={'x': x},
                                          fetch_list=['my_var'])[0]))
    np.testing.assert_array_equal(got[1], got[0])
    np.testing.assert_array_equal(got[1], x * 5.0)


@pytest.mark.parametrize('kind', ['counter', 'gauge', 'histogram'])
def test_observe_handle_accessors(kind):
    """observe.counter / gauge / histogram return the registry's handle,
    as the reference's do, and what goes through the handle shows in the
    snapshot under the same key in both packages."""
    snaps = []
    for mod in (jobs, pobs):
        mod.reset()
        handle = getattr(mod, kind)('harness_' + kind, 'a test metric')
        assert handle is getattr(mod.registry(), kind)('harness_' + kind)
        if kind == 'counter':
            handle.inc(3)
        elif kind == 'gauge':
            handle.set(7.5)
        else:
            handle.observe(0.25)
        snaps.append(mod.registry().snapshot())
        mod.reset()
    key = [k for k in snaps[0] if 'harness_' + kind in json.dumps(
        snaps[0][k])]
    assert key
    assert json.dumps(snaps[1][key[0]], sort_keys=True) == \
        json.dumps(snaps[0][key[0]], sort_keys=True)


def test_observe_enable_every_secs():
    """enable(every_secs=) is accepted as in the reference and kept for the
    periodic flush (not ported yet); the default is the reference's."""
    assert inspect.signature(pobs.enable).parameters['every_secs'].default \
        == inspect.signature(jobs.enable).parameters['every_secs'].default
    try:
        pobs.enable(every_secs=5.0)
        assert pobs.enabled()
        assert pobs._SINK['every_secs'] == 5.0
    finally:
        pobs.disable()
        pobs.reset()


# ---------------------------------------------------------- the new layers
NEW_LAYERS = {
    'ops': ['sigmoid', 'logsigmoid', 'exp', 'relu', 'tanh', 'tanh_shrink',
            'softshrink', 'sqrt', 'rsqrt', 'abs', 'ceil', 'floor', 'round',
            'reciprocal', 'log', 'square', 'softplus', 'softsign', 'brelu',
            'leaky_relu', 'soft_relu', 'elu', 'relu6', 'pow', 'stanh',
            'hard_shrink', 'thresholded_relu', 'hard_sigmoid', 'swish',
            'gelu', 'mish', 'sin', 'cos', 'mul',
            'sigmoid_cross_entropy_with_logits', 'elementwise_max',
            'elementwise_min', 'elementwise_pow', 'softmax', 'logical_and',
            'logical_or', 'logical_xor', 'logical_not', 'uniform_random',
            'uniform_random_batch_size_like', 'gaussian_random',
            'gaussian_random_batch_size_like'],
    'tensor': ['create_tensor', 'create_global_var', 'sums', 'ones', 'zeros',
               'ones_like', 'zeros_like'],
    'nn': ['matmul', 'reduce_mean', 'reduce_max', 'reduce_min',
           'reduce_prod', 'split', 'relu_layer', 'dot', 'sign', 'l1_norm',
           'squared_l2_norm', 'squared_l2_distance', 'fc'],
    'manip': ['prelu'],
    'control_flow': ['increment'],
}


def _signature(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize('module', sorted(NEW_LAYERS))
def test_new_layers_have_the_reference_signatures(module):
    """Every layer this slice adds (and fc) takes the reference's
    arguments, in its order, with its defaults, ignored ones included;
    each is reachable as layers.<name> and from its module."""
    jmod = importlib.import_module('paddle_tpu.layers.' + module)
    pmod = importlib.import_module('paddle_tpu_torch.layers.' + module)
    for name in NEW_LAYERS[module]:
        assert _signature(getattr(pmod, name)) == \
            _signature(getattr(jmod, name)), name
        assert getattr(pt.layers, name) is getattr(pmod, name), name


def test_layers_ops_all_is_the_references():
    assert pt.layers.ops.__all__ == fluid.layers.ops.__all__
    assert set(fluid.layers.ops.__all__) <= set(dir(pt.layers))


def _build_layers(pkg, h):
    """Every new layer once, over data of both dtypes it takes."""
    L = pkg.layers
    x, y = _x(pkg), _x(pkg, name='y')
    b = _x(pkg, name='b', dtype='bool')
    img = _x(pkg, (2, 3, 4, 4), name='img')
    for name in NEW_LAYERS['ops'][:33]:
        getattr(L, name)(x)
    L.leaky_relu(x, alpha=0.1)
    L.pow(x, factor=3.0)
    L.brelu(x, t_min=1.0, t_max=2.0)
    L.mul(x, L.transpose(y, [1, 0]))
    L.sigmoid_cross_entropy_with_logits(x, y)
    for name in ('elementwise_max', 'elementwise_min', 'elementwise_pow'):
        getattr(L, name)(x, y)
    L.elementwise_max(x, y, act='relu')
    L.softmax(x)
    L.logical_and(b, b)
    L.logical_or(b, b)
    L.logical_xor(b, b)
    L.logical_not(b)
    L.uniform_random([2, 3], min=-2.0, max=2.0, seed=3)
    L.gaussian_random([2, 3], mean=1.0, std=0.5)
    L.uniform_random_batch_size_like(x, [1, 5], seed=2)
    L.gaussian_random_batch_size_like(x, [1, 5], input_dim_idx=1,
                                      output_dim_idx=1)
    L.create_tensor('float32', name='ct')
    L.create_tensor('int64')
    L.create_global_var([2], 3.0, 'float32', persistable=True,
                        force_cpu=True, name='gv')
    L.create_global_var([1], 1.0, 'int64')
    L.sums([x, y])
    L.ones([2, 3], 'float32')
    L.zeros([4], 'int64', force_cpu=True)
    L.ones_like(x)
    L.zeros_like(y)
    L.matmul(x, y, transpose_y=True, alpha=0.5)
    L.matmul(img, img)
    L.reduce_mean(x)
    L.reduce_mean(x, dim=1, keep_dim=True)
    L.reduce_max(img, dim=[1, 3])
    L.reduce_min(x, dim=-1)
    L.reduce_prod(x, dim=0, keep_dim=True)
    L.split(x, 2, dim=1)
    L.split(img, [1, 2], dim=1)
    L.relu_layer(x)
    L.dot(x, y)
    L.sign(x)
    L.l1_norm(x)
    L.squared_l2_norm(x)
    L.squared_l2_distance(x, y)
    L.prelu(img, mode='all')
    L.prelu(img, mode='channel')
    L.prelu(x, mode='element', param_attr=pkg.ParamAttr(name='alpha_e'))
    L.increment(x, value=2.0, in_place=False)
    counter = L.fill_constant([1], 'int64', 0)
    L.increment(counter)


def test_new_layers_build_the_reference_program():
    """The same ops, attributes, vars, shapes, parameters, initializers
    and provenance as the reference, for every new layer."""
    _same_program(_build_layers)


# ------------------------------------------------------------------- nets
def _nets(pkg, which, dropout=0.0, proj=False):
    """``which`` over data vars; with ``proj`` glu's and the attention's
    inputs go through an fc first (parameters to train)."""
    L, nets = pkg.layers, pkg.nets

    def p(v):
        return L.fc(v, size=8, num_flatten_dims=len(v.shape) - 1) \
            if proj else v
    if which == 'simple_img_conv_pool':
        img = _x(pkg, (2, 3, 8, 8), name='img')
        return nets.simple_img_conv_pool(img, num_filters=4, filter_size=3,
                                         pool_size=2, pool_stride=2,
                                         act='relu')
    if which == 'img_conv_group':
        img = _x(pkg, (2, 3, 8, 8), name='img')
        return nets.img_conv_group(img, conv_num_filter=[4, 4], pool_size=2,
                                   conv_act='relu', pool_stride=2)
    if which == 'glu':
        return nets.glu(p(_x(pkg, (4, 8))), dim=1)
    q = p(_x(pkg, (2, 5, 8), name='q'))
    k = p(_x(pkg, (2, 6, 8), name='k'))
    v = p(_x(pkg, (2, 6, 8), name='v'))
    return nets.scaled_dot_product_attention(q, k, v, num_heads=2,
                                             dropout_rate=dropout)


NETS = ['simple_img_conv_pool', 'img_conv_group', 'glu',
        'scaled_dot_product_attention']


def _net_feed(which):
    rng = np.random.RandomState(5)
    if which in ('simple_img_conv_pool', 'img_conv_group'):
        return {'img': rng.randn(2, 3, 8, 8).astype('f')}
    if which == 'glu':
        return {'x': rng.randn(4, 8).astype('f')}
    return {n: rng.randn(2, t, 8).astype('f')
            for n, t in (('q', 5), ('k', 6), ('v', 6))}


@pytest.mark.parametrize('which', NETS)
def test_nets_match_the_reference(which):
    """Each composite network builds the reference's program and, from the
    reference's parameters, gives its output and its parameters'
    gradients (through mean; glu's and the attention's inputs through an
    fc) within 1e-5."""
    _same_program(lambda pkg, h: _nets(pkg, which))
    feed = _net_feed(which)
    outs, scopes = [], []
    for pkg, _ in PKGS:
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            out = _nets(pkg, which, proj=True)
            loss = pkg.layers.mean(out)
            grads = pkg.backward.append_backward(loss)
        scope, exe = pkg.Scope(), pkg.Executor(pkg.CPUPlace())
        with pkg.scope_guard(scope):
            exe.run(startup)
            if pkg is pt:
                for n, val in scopes[0].items():
                    scope.set(n, torch.from_numpy(val.copy()))
            else:
                scopes.append({n: np.asarray(scope.find(n))
                               for n in scope.keys()
                               if scope.find(n) is not None})
            fetch = [out] + [g for _, g in grads]
            outs.append([np.asarray(v) for v in
                         exe.run(main, feed=feed, fetch_list=fetch)])
    for r, g in zip(outs[0], outs[1]):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)


def test_scaled_dot_product_attention_runs_as_written():
    """No pass rewrites the attention of nets: the program holds matmul,
    softmax and matmul (and dropout at a rate above 0), as the
    reference's."""
    ref, got = _dicts(lambda pkg, h: _nets(pkg, 'attn', dropout=0.1))
    assert got == ref
    types = [o['type'] for o in got[0]['blocks'][0]['ops']]
    assert types.count('matmul') == 2 and 'softmax' in types and \
        'dropout' in types and 'fused_attention' not in types


def test_sequence_conv_pool_waits_for_the_sequence_ops():
    with pytest.raises(NotImplementedError, match='Queue 1 item 7'):
        pt.nets.sequence_conv_pool(None, 4, 3)


# ------------------------------------------------- Variable, Program, core
def _sugar(pkg, h):
    x, y = _x(pkg), _x(pkg, name='y')
    return [x + y, x + 1.5, 2 * x, x - y, 3 - x, x * y, x / 2, y / x,
            (x * 2).astype('int32'), x.astype('float64')]


def test_variable_sugar_matches_the_reference():
    """+, -, *, / with vars and numbers (both orders) and astype build the
    reference's ops and give its values."""
    _same_program(_sugar)
    rng = np.random.RandomState(2)
    feed = {'x': rng.rand(4, 8).astype('f') + 0.5,
            'y': rng.randn(4, 8).astype('f')}
    got = []
    for pkg, h in PKGS:
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            outs = _sugar(pkg, h)
        exe = pkg.Executor(pkg.CPUPlace())
        with pkg.scope_guard(pkg.Scope()):
            exe.run(startup)
            got.append([np.asarray(v) for v in
                        exe.run(main, feed=feed, fetch_list=outs)])
    for r, g in zip(*got):
        np.testing.assert_allclose(g.astype('f8'), r.astype('f8'),
                                   rtol=1e-6)


def _blocks(pkg, h):
    main = pkg.default_main_program()
    x = _x(pkg)
    sub = main.create_block()
    assert main.current_block() is sub and sub.parent_idx == 0
    sub.append_op(type='scale', inputs={'X': [x]}, outputs={'Out': [x]},
                  attrs={'scale': 2.0})
    inner = main.create_block()
    assert inner.parent_idx == sub.idx
    main.rollback()
    assert main.current_block() is sub
    main.rollback()
    assert main.current_block_idx == 0
    main.rollback()
    assert main.current_block_idx == 0
    main.global_block().prepend_op(type='fill_constant',
                                   outputs={'Out': ['first']},
                                   attrs={'shape': [1], 'value': 1.0})
    assert main.global_block().ops[0].type == 'fill_constant'
    other = main.create_block(parent_idx=0)
    assert other.parent_idx == 0
    main.rollback()


def test_create_block_rollback_prepend_match_the_reference():
    _same_program(_blocks)


def test_provenance_names_the_user_line():
    """An op's provenance is the line of the user code that built it,
    through any layers; clone and the dict round trip keep it."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = _x(pt)
        line = inspect.currentframe().f_lineno + 1
        out = pt.layers.gelu(pt.layers.fc(x, size=3))
    where = '%s:%d' % (__file__, line)
    ops = main.global_block().ops
    assert ops[-1].provenance == where and ops[0].provenance == where
    assert where in repr(ops[-1])
    assert main.clone().global_block().ops[-1].provenance == where
    from paddle_tpu_torch.core.serialize import program_from_dict
    again = program_from_dict(json.loads(json.dumps(program_to_dict(main))))
    assert again.global_block().ops[-1].provenance == where
    assert out.name == ops[-1].output('Out')


@pytest.mark.parametrize('env', [{}, {'PADDLE_TPU_BENCHMARK': '1',
                                      'PADDLE_TPU_READER_PREFETCH': '64',
                                      'PADDLE_TPU_COMPILE_CACHE': '0'}])
def test_flags_match_the_reference(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert pflags.init_flags() == jflags.init_flags()
    assert pflags.init_flags({'v': 2}) == jflags.init_flags({'v': 2})
    pflags.set_flag('use_bf16', True)
    assert pflags.get_flag('use_bf16') is True
    with pytest.raises(KeyError):
        pflags.set_flag('no_such_flag', 1)
    assert pt.init_flags is pflags.init_flags
    pflags.init_flags()
    jflags.init_flags()


LOD_CASES = {
    'ints': [[1, 2, 3], [4], [5, 6]],
    'rows': [np.arange(6, dtype='f').reshape(3, 2),
             np.arange(2, dtype='f').reshape(1, 2)],
}


@pytest.mark.parametrize('case', sorted(LOD_CASES))
@pytest.mark.parametrize('bucketed', [False, True])
def test_lod_round_trips_match_the_reference(case, bucketed):
    seqs = LOD_CASES[case]
    got = plod.pad_sequences(seqs, pad_value=-1, bucketed=bucketed)
    ref = jlod.pad_sequences(seqs, pad_value=-1, bucketed=bucketed)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
        assert g.dtype == r.dtype
    back = plod.unpad_sequences(*got)
    for b, s in zip(back, seqs):
        np.testing.assert_array_equal(b, np.asarray(s))
    lod = plod.lengths_to_lod(got[1])
    assert lod == jlod.lengths_to_lod(ref[1])
    np.testing.assert_array_equal(plod.lod_to_lengths(lod), got[1])
    flat = np.concatenate([np.asarray(s) for s in seqs])
    for g, r in zip(pt.create_lod_tensor(flat, [[len(s) for s in seqs]]),
                    fluid.create_lod_tensor(flat, [[len(s)
                                                    for s in seqs]])):
        np.testing.assert_array_equal(g, r)
    assert [plod.bucket_length(n) for n in (1, 16, 17, 5000)] == \
        [jlod.bucket_length(n) for n in (1, 16, 17, 5000)]
    with pytest.raises(NotImplementedError):
        plod.create_lod_tensor(flat, [[1], [2]])


TOP_LEVEL = ['nets', 'backward', 'append_backward', 'create_lod_tensor',
             'pad_sequences', 'init_flags', 'enforce', 'EnforceError',
             'switch_main_program', 'switch_startup_program']


def test_top_level_names():
    """The reference's top-level names scripts import, with its
    signatures; backward is the module with append_backward."""
    for name in TOP_LEVEL:
        got, ref = getattr(pt, name), getattr(fluid, name)
        if inspect.isfunction(ref):
            assert _signature(got) == _signature(ref), name
    assert pt.backward.append_backward is pt.append_backward
    with pytest.raises(pt.EnforceError, match='bad 3'):
        pt.enforce(False, 'bad %d', 3)
    old = pt.switch_main_program(pt.Program())
    assert pt.switch_main_program(old) is not old


def _op_types(pkg):
    ops = importlib.import_module(pkg.__name__ + '.ops')
    for m in pkgutil.iter_modules(ops.__path__):
        try:
            importlib.import_module(ops.__name__ + '.' + m.name)
        except ImportError:
            pass
    registry = jregistry if pkg is fluid else pregistry
    return set(registry.OP_LOWERINGS)


def test_coverage_count():
    """170 of the reference's 241 op types have a lowering in the port,
    every one of them a reference op type."""
    ref, got = _op_types(fluid), _op_types(pt)
    assert len(ref) == 241 and len(got) == 170 and got <= ref


# ------------------------- the op modules' layers, weight norm, initializers
MODULE_LAYERS = {
    'tensor': ['assign', 'argmin', 'argsort', 'reverse', 'linspace'],
    'manip': ['gather', 'scatter', 'squeeze', 'where', 'shape', 'range',
              'isfinite', 'pixel_shuffle'],
    'nn': ['auc', 'l2_normalize', 'smooth_l1', 'im2sequence', 'multiplex',
           'label_smooth', 'pad', 'maxout', 'bilinear_tensor_product', 'nce',
           'huber_loss', 'rank_loss', 'margin_rank_loss', 'hinge_loss',
           'log_loss', 'resize_bilinear', 'resize_nearest',
           'modified_huber_loss'],
    'control_flow': ['Print'],
}


@pytest.mark.parametrize('module', sorted(MODULE_LAYERS))
def test_module_layers_have_the_reference_signatures(module):
    """The 32 layers over the tensor, nn, random and misc op modules' op
    types take the reference's arguments, ignored ones included (auc's
    curve, num_thresholds and topk, Print's first_n, summarize, ...), and
    are reachable as layers.<name>."""
    jmod = importlib.import_module('paddle_tpu.layers.' + module)
    pmod = importlib.import_module('paddle_tpu_torch.layers.' + module)
    for name in MODULE_LAYERS[module]:
        assert _signature(getattr(pmod, name)) == \
            _signature(getattr(jmod, name)), name
        assert getattr(pt.layers, name) is getattr(pmod, name), name
        assert name in pmod.__all__, name


def _build_module_layers(pkg, h):
    """Every one of the 32 layers once or more, over data of the shapes
    and dtypes it takes."""
    L = pkg.layers
    x, y = _x(pkg), _x(pkg, name='y')
    img = _x(pkg, (2, 4, 4, 4), name='img')
    ids = _x(pkg, (3, 1), name='ids', dtype='int64')
    lbl = _x(pkg, (4, 1), name='lbl', dtype='int64')
    L.assign(x)
    L.assign(np.arange(6, dtype='float32').reshape(2, 3))
    L.argmin(x, axis=0)
    L.argsort(x)
    L.reverse(x, 1)
    L.reverse(x, [0, 1])
    L.linspace(0, 1, 5)
    L.linspace(2, 9, 4, dtype='int32')
    L.gather(x, ids)
    L.scatter(x, ids, L.gather(y, ids))
    L.squeeze(L.unsqueeze(x, [1]), [1])
    L.squeeze(L.unsqueeze(x, [0]), [])
    L.where(x, x, y)
    L.shape(x)
    L.range(0, 10, 3)
    L.range(0.5, 2.0, 0.25, dtype='float32')
    L.isfinite(x)
    L.pixel_shuffle(img, 2)
    L.auc(x, lbl, curve='PR', num_thresholds=10, topk=2)
    L.l2_normalize(x, axis=1, epsilon=1e-6)
    L.smooth_l1(x, y, inside_weight=y, outside_weight=y, sigma=2.0)
    L.smooth_l1(x, y, last_dim_only=True)
    L.im2sequence(img, filter_size=[2, 3], stride=[1, 2],
                  padding=[1, 0, 0, 1])
    L.im2sequence(img, filter_size=2, stride=2, padding=1)
    L.multiplex([x, y], _x(pkg, (4, 1), name='mid', dtype='int32'))
    L.label_smooth(x, epsilon=0.2)
    L.label_smooth(x, prior_dist=_x(pkg, (1, 8), name='prior'))
    L.pad(x, [1, 0, 2, 3], pad_value=0.5)
    L.maxout(img, 2)
    L.bilinear_tensor_product(x, y, 3, act='tanh')
    L.bilinear_tensor_product(x, y, 2, bias_attr=False,
                              param_attr=pkg.ParamAttr(name='btp_w'))
    L.nce(x, lbl, num_total_classes=20, num_neg_samples=5)
    L.nce(x, lbl, 7)
    L.huber_loss(x, y, delta=0.5)
    L.rank_loss(y, x, y)
    L.margin_rank_loss(y, x, y, margin=0.2)
    L.hinge_loss(x, y)
    L.log_loss(x, y, epsilon=1e-3)
    L.resize_bilinear(img, [7, 5])
    L.resize_nearest(img, [3, 2])
    L.modified_huber_loss(x, y)
    L.Print(x, first_n=3, message='x is', summarize=2)
    L.Print(y)


def test_module_layers_build_the_reference_program():
    """The same ops, slots, attributes, vars, shapes, parameters and
    initializers as the reference, for every one of the 32 layers."""
    _same_program(_build_module_layers)


def _wn_build(pkg, h, dim):
    x = _x(pkg, (4, 6))
    return pkg.layers.fc(x, size=3, param_attr=pkg.WeightNormParamAttr(
        dim=dim, name='wn_fc', initializer=pkg.initializer.Normal(0.0, 0.5)))


@pytest.mark.parametrize('dim', [None, 0, 1, -1])
def test_weight_norm_param_attr_builds_the_reference_program(dim):
    """fc with a WeightNormParamAttr: the parameters <name>.wn_v and
    <name>.wn_g, the startup weight_norm_g_init op and the weight_norm op,
    as the reference builds them."""
    _same_program(lambda pkg, h: _wn_build(pkg, h, dim))
    pt.reset_default_programs()
    _wn_build(pt, PHelper, dim)
    names = {p.name for p in pt.default_main_program().all_parameters()}
    assert {'wn_fc.wn_v', 'wn_fc.wn_g'} <= names and 'wn_fc' not in names


@pytest.mark.parametrize('dim', [2, -3])
def test_weight_norm_dim_out_of_range_raises(dim):
    for pkg in (fluid, pt):
        pkg.reset_default_programs()
        with pytest.raises(ValueError, match='out of range'):
            _wn_build(pkg, None, dim)


def _wn_train(pkg, dim, scope_from=None):
    """3 SGD steps of a weight-normalized fc (startup run, or the given
    scope's v and g copied in); returns (g after startup, v after startup,
    losses, final v and g)."""
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = _x(pkg, (4, 6))
        y = _x(pkg, (4, 3), name='y')
        pred = pkg.layers.fc(x, size=3, bias_attr=False,
                             param_attr=pkg.WeightNormParamAttr(
                                 dim=dim, name='wn_fc'))
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.SGD(learning_rate=0.5).minimize(loss)
    scope, exe = pkg.Scope(), pkg.Executor(pkg.CPUPlace())
    rng = np.random.RandomState(2)
    feed = {'x': rng.randn(4, 6).astype('f'), 'y': rng.randn(4, 3)
            .astype('f')}

    def read(n):
        v = scope.find(n)
        return np.array(np.asarray(v) if pkg is fluid else v.numpy())
    with pkg.scope_guard(scope):
        exe.run(startup)
        g0, v0 = read('wn_fc.wn_g'), read('wn_fc.wn_v')
        if scope_from is not None:
            for n, val in scope_from.items():
                scope.set(n, torch.from_numpy(val.copy()))
        losses = [float(np.asarray(exe.run(main, feed=feed,
                                           fetch_list=[loss])[0])
                        .reshape(())) for _ in range(3)]
        return g0, v0, losses, read('wn_fc.wn_v'), read('wn_fc.wn_g')


@pytest.mark.parametrize('dim', [None, 0, 1])
def test_weight_norm_trains_as_the_reference(dim):
    """g starts at ||v|| (over every axis but dim) in both packages, and 3
    SGD steps from the reference's v and g give its losses, v and g within
    1e-5."""
    jg0, jv0, jl, jv, jg = _wn_train(fluid, dim)
    pg0, pv0, _, _, _ = _wn_train(pt, dim)
    for g0, v0 in ((jg0, jv0), (pg0, pv0)):
        axes = tuple(i for i in range(2) if i != dim) if dim is not None \
            else (0, 1)
        want = np.sqrt(np.sum(np.square(v0.astype(np.float64)), axis=axes)
                       + 1e-12).reshape(-1)
        np.testing.assert_allclose(g0, want, rtol=1e-6)
    _, _, pl, pv, pg = _wn_train(pt, dim, {'wn_fc.wn_v': jv0,
                                           'wn_fc.wn_g': jg0})
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    np.testing.assert_allclose(pv, jv, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pg, jg, rtol=1e-5, atol=1e-6)


INITIALIZERS = {
    'truncated_normal': lambda m: m.TruncatedNormal(0.5, 0.2, seed=3),
    'msra_uniform': lambda m: m.MSRA(),
    'msra_normal': lambda m: m.MSRAInitializer(uniform=False, fan_in=20),
    'bilinear': lambda m: m.Bilinear(),
}


@pytest.mark.parametrize('name', sorted(INITIALIZERS))
def test_initializers_build_the_reference_startup(name):
    """TruncatedNormal, MSRA (both laws) and Bilinear append the
    reference's startup op with its attributes, and the names and aliases
    are the reference's."""
    def build(pkg, h):
        pkg.layers.create_parameter(
            [4, 4, 3, 3], 'float32', name='w',
            default_initializer=INITIALIZERS[name](pkg.initializer))
    _same_program(build)


def test_initializer_values_and_helpers():
    """Bilinear's filter equals the reference's startup value exactly;
    TruncatedNormal's draws stay within 2 std; MSRA's uniform limit is
    sqrt(6 / fan_in); force_init_on_cpu and init_on_cpu are the
    reference's no-ops."""
    got = {}
    for pkg in (fluid, pt):
        pkg.reset_default_programs()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            for name, make in INITIALIZERS.items():
                shape = [64, 64, 3, 3] if name != 'bilinear' else [3, 3, 4, 4]
                pkg.layers.create_parameter(
                    shape, 'float32', name=name,
                    default_initializer=make(pkg.initializer))
        scope = pkg.Scope()
        with pkg.scope_guard(scope):
            pkg.Executor(pkg.CPUPlace()).run(startup)
        got[pkg] = {n: np.asarray(scope.find(n)) if pkg is fluid else
                    scope.numpy(n) for n in INITIALIZERS}
        assert pkg.initializer.force_init_on_cpu() is False
        with pkg.initializer.init_on_cpu():
            pass
    ref, mine = got[fluid], got[pt]
    np.testing.assert_array_equal(mine['bilinear'], ref['bilinear'])
    t = mine['truncated_normal']
    assert t.min() >= 0.5 - 0.4 and t.max() <= 0.5 + 0.4
    assert abs(t.mean() - 0.5) < 4 * 0.2 / np.sqrt(t.size)
    lim = np.sqrt(6.0 / (64 * 9))
    assert np.abs(mine['msra_uniform']).max() <= lim
    assert abs(mine['msra_normal'].std() - np.sqrt(2.0 / 20)) < 0.01
    for alias, cls in (('TruncatedNormal', 'TruncatedNormalInitializer'),
                       ('MSRA', 'MSRAInitializer'),
                       ('Bilinear', 'BilinearInitializer')):
        assert getattr(pt.initializer, alias) is \
            getattr(pt.initializer, cls)
