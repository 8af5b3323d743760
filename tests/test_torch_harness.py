"""The cross-package parity harness, and the op and layer cases that go
through it.

``parity(build, feed)`` builds a Program with paddle_tpu's layers under
program_guard, serializes its main and startup programs with paddle_tpu's
core/serialize.py through JSON and loads them with the port's
program_from_dict. Both startups run; every persistable of the reference
scope is copied into the port's as numpy. Both executors then run on
CPUPlace with one feed made from a seed with numpy, fetching every output
of every op and, through append_backward, every @GRAD. The first op whose
output differs is named with its type, its output and the largest
difference.

Gradients: each float feed reaches the ops under test through a probe, a
parameter of its shape initialized to -0.0 and added to it (x + -0.0 is x
bit for bit, -0.0, NaN and inf included), so the probe's @GRAD is the
gradient at the feed. The loss is the sum of reduce_sum over each float
output of the case (the harness's own ops, not compared). Under
``amp='bf16'`` each probed feed is also cast to bfloat16 before the ops
under test, so they run on bf16 values.

Tolerances, stated per op type (EXACT, tolerance()) and applied by
chip_smoke.py's parity_difference, the rule phase 16b holds the card to:
exact for the comparisons, the logical ops, sign, floor / ceil / round,
cast, max / min and their ties, and the other ops whose result is one of
their inputs or an exact function of them (values equal, NaN where NaN).
An op that sums an element from terms (SUMS: their count n and, per
element, the sum S of their magnitudes; a product's own magnitude) is
held to 1e-6 * (|ref| + n S) at fp32 and one bf16 ulp + 1e-6 n S in bf16,
element by element. A pointwise op at fp32 is held to 1e-6 * (|ref| + M)
and a bf16 output to one bf16 ulp (of the larger of |ref| and |port|)
plus 2^-8 M, M the output's largest finite magnitude over the ordinary
elements (inputs 0 or normal and at most 2.5 in magnitude), so an edge
input (3e9, 100, 1e-40) is held to its own output's magnitude and widens
no other element's bound. The 2^-8 M: the reference rounds some
intermediate values of a fused bf16 expression that the port keeps in
fp32 (tanh(x) in x - tanh(x), sigmoid(x) in swish). A gradient under
bf16 AMP is held to one bf16 ulp plus 2^-6 M: the reference keeps its
cotangents in fp32 inside one XLA computation, torch rounds each op's
gradient to bf16. An absolute 1.2e-38 (fp32's smallest normal) is for
results XLA's CPU backend flushes to zero (exp(-100), softplus(-100),
logsigmoid(100)) where torch keeps the subnormal. XLA's CPU backend also
reads subnormal inputs as zero; the 'subnormal' feed therefore runs the
port with torch.set_flush_denormal(True), the same float environment.

The reference tests mirrored: tests/test_ops_math.py (activations on a
signed and a positive input, elementwise, reductions, logical and
compare, minus) and tests/test_layers.py (prelu, matmul)."""

import json

import numpy as np
import pytest

import jax  # noqa: F401  (port tests import both frameworks)
import torch

import paddle_tpu as fluid
from paddle_tpu.core.serialize import program_to_dict as jax_to_dict
from paddle_tpu.initializer import Constant as JConstant
from paddle_tpu.layers.helper import LayerHelper as JHelper

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.serialize import program_from_dict
from paddle_tpu_torch.ops import pointwise

from chip_smoke import (LAYERS_EDGE as EDGE, LAYERS_FAULTS, PARITY_RTOL,
                        ordinary, parity_difference, prod_others)

EXACT = {
    'less_than', 'less_equal', 'greater_than', 'greater_equal', 'equal',
    'not_equal', 'logical_and', 'logical_or', 'logical_xor', 'logical_not',
    'sign', 'floor', 'ceil', 'round', 'cast', 'elementwise_max',
    'elementwise_min', 'reduce_max', 'reduce_min', 'elementwise_add',
    'split', 'abs', 'relu', 'relu6', 'brelu', 'clip', 'leaky_relu',
    'hard_shrink', 'thresholded_relu', 'minus', 'elementwise_floordiv',
    'elementwise_mod', 'increment', 'softshrink',
    # the tensor, nn and misc op modules' ops whose result is one of their
    # inputs' elements, a constant or a comparison
    'assign', 'squeeze', 'unsqueeze', 'reshape', 'gather', 'scatter',
    'shape', 'pad', 'reverse', 'multiplex', 'maxout', 'pixel_shuffle',
    'im2sequence', 'argmin', 'argsort', 'nearest_interp', 'isfinite',
    'lod_reset', 'where', 'linspace', 'range',
}


# reduce_max / reduce_min (and maxout, a max over channel groups) over a
# NaN: the reference's gradient there is 0
# in its fp32 program (XLA rewrites jax's (g / count) * indicator into a
# select) and NaN under bf16 AMP (it does not); the port gives 0, and the
# elements the reference gives NaN are not compared
NAN_OR_ZERO_GRAD = {'reduce_max', 'reduce_min', 'maxout'}


def tolerance(op_type):
    """'exact' or the fp32 rtol of ``op_type``'s outputs (a bf16 output is
    held to one bf16 ulp wherever the op is not exact)."""
    return 'exact' if op_type in EXACT else PARITY_RTOL


# ------------------------------------------------------------------ feeds
# EDGE (chip_smoke.py's LAYERS_EDGE): NaN, +-inf, +-0, ties and halves,
# the clips' bounds, beyond int32; the second operand: the same values in
# another order, equal to the first at a quarter of the positions (ties)
EDGE_Y = np.roll(EDGE, 3, axis=1)
EDGE_Y[:, ::4] = EDGE[:, ::4]
SUBNORMAL = np.array([
    [1e-40, -1e-40, 1e-45, -1e-45, 5e-39, -5e-39, 1.0, -1.0],
    [2e-38, 1e-39, -3e-39, 0.5, 1e-38, -1e-38, 2.0, 0.0],
    [1e-40, 1e-40, -7e-41, 3e-42, 1.5, -2.5, 1e-37, -1e-37],
    [8e-39, -8e-39, 4e-40, 0.25, -0.25, 1e-41, -1e-41, 3.0],
], np.float32)
SUBNORMAL_Y = np.roll(SUBNORMAL, 5, axis=1)
SUBNORMAL_Y[:, ::4] = SUBNORMAL[:, ::4]


def _random(seed, positive=False, shape=(4, 8)):
    rng = np.random.RandomState(seed)
    if positive:
        return rng.uniform(0.1, 2.0, shape).astype(np.float32)
    return rng.uniform(-2.0, 2.0, shape).astype(np.float32)


def feed_for(kind, positive=False):
    """(x, y) of a feed kind: 'random' (signed, or positive for a domain
    like log's), 'edge' or 'subnormal'."""
    if kind == 'edge':
        return EDGE, EDGE_Y
    if kind == 'subnormal':
        return SUBNORMAL, SUBNORMAL_Y
    return _random(1, positive), _random(2, positive)


# ---------------------------------------------------------------- harness
def _probed(L, name, value, amp):
    """The data var ``name`` plus its probe (a -0.0 parameter of its
    shape), cast to bf16 under amp: what the ops under test read."""
    x = L.data(name=name, shape=list(value.shape), dtype=str(value.dtype),
               append_batch_size=False)
    if value.dtype.kind != 'f':
        return x
    probe = L.create_parameter(shape=list(value.shape), dtype='float32',
                               name=name + '_probe',
                               default_initializer=JConstant(-0.0))
    x = L.elementwise_add(x, probe)
    return L.cast(x, 'bfloat16') if amp else x


def build_reference(build, feed, amp, backward=True):
    """(main, startup, outputs, loss or None) built with paddle_tpu; the
    loss and backward only with ``backward``."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        L = fluid.layers
        ins = {n: _probed(L, n, v, amp) for n, v in feed.items()}
        outs = build(L, ins)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        floats = [o for o in outs if o.dtype in ('float32', 'bfloat16')]
        loss = None
        if backward and floats and \
                any(v.dtype.kind == 'f' for v in feed.values()):
            sums = [L.reduce_sum(L.cast(o, 'float32')) for o in floats]
            loss = sums[0] if len(sums) == 1 else L.sums(sums)
            fluid.backward.append_backward(loss)
    if amp:
        main.amp = 'bf16'
    return main, startup, outs, loss


def _compared_names(main, loss):
    """[(op type, output name)] of every op before the backward marker,
    without the harness's loss ops, then ('@GRAD', name) of every
    gradient."""
    ops = main.global_block().ops
    names, seen, grads = [], set(), []
    loss_ops = _loss_ops(ops, loss)
    for i, op in enumerate(ops):
        if op.type == 'backward_marker':
            grads = list(op.attrs['grad_names'])
            break
        if i in loss_ops:
            continue
        for n in op.output_names():
            if n not in seen:
                seen.add(n)
                names.append((op.type, n))
    return names + [('@GRAD', g) for g in grads]


def _loss_ops(ops, loss):
    """Indices of the ops that only compute the loss (the casts, reduce_sums
    and sum the harness appended after the case's own ops)."""
    if loss is None:
        return set()
    marker = next(i for i, op in enumerate(ops)
                  if op.type == 'backward_marker')
    out, needed = set(), {loss.name}
    for i in range(marker - 1, -1, -1):
        op = ops[i]
        if op.type not in ('cast', 'reduce_sum', 'sum') or \
                not set(op.output_names()) & needed:
            break
        out.add(i)
        needed.update(op.input_names())
    return out


def run_both(build, feed, amp=None, flush_denormal=False):
    """Build with the reference, carry the programs and persistables to the
    port, run both on CPUPlace; returns (names, ref values, port values,
    main, the case's output names) with names as _compared_names gives
    them."""
    main, startup, outs, loss = build_reference(build, feed, amp)
    names = _compared_names(main, loss)
    fetch = [n for _, n in names]

    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(jscope):
        jexe.run(startup)
        ref = jexe.run(main, feed=feed, fetch_list=fetch)
        persist = {n: np.asarray(jscope.find(n)) for n in jscope.keys()
                   if jscope.find(n) is not None}

    pmain = program_from_dict(json.loads(json.dumps(jax_to_dict(main))))
    pstart = program_from_dict(json.loads(json.dumps(jax_to_dict(startup))))
    pmain.amp = main.amp
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    try:
        torch.set_flush_denormal(flush_denormal)
        with pt.scope_guard(pscope):
            pexe.run(pstart)
            for n, v in persist.items():
                pscope.set(n, _to_torch(v))
            got = pexe.run(pmain, feed=feed, fetch_list=fetch)
    finally:
        torch.set_flush_denormal(False)
    return names, [np.asarray(v) for v in ref], \
        [np.asarray(v) for v in got], main, [o.name for o in outs]


def _to_torch(arr):
    """A numpy array (bfloat16 ones too, as the reference's scope holds
    them) as a CPU tensor of its dtype, a copy."""
    if arr.dtype.name == 'bfloat16':
        return torch.from_numpy(np.array(arr).view(np.uint16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _as_f64(a):
    a = np.asarray(a)
    if a.dtype.kind in 'biu':
        return a.astype(np.float64)
    return a.astype(np.float32).astype(np.float64)


def check_parity(build, feed, amp=None, flush_denormal=False, sums=None):
    """Run both packages; raise naming the first op whose output differs
    (its type, output and largest difference); the gradients take the
    tolerance of the last op compared before them. ``sums``: (n, fn) of a
    case whose ops sum an element from n terms, fn(feed) giving the
    magnitudes of those terms per element as ([an array an output of the
    case, None for a pointwise one], {feed name: an array for its
    gradient}); its other arrays, and every array of a case without
    ``sums``, are held as pointwise."""
    names, ref, got, main, outs = run_both(build, feed, amp, flush_denormal)
    terms, s_outs, s_grads = 0, {}, {}
    if sums is not None:
        terms, fn = sums
        per_out, s_grads = fn({k: v.astype(np.float64) if v.dtype.kind ==
                               'f' else v for k, v in feed.items()})
        s_outs = dict(zip(outs, per_out))
    last = None
    for (op_type, name), r, g in zip(names, ref, got):
        grad = op_type == '@GRAD'
        if grad:
            tol = tolerance(last)
            bf16 = amp is not None and tol != 'exact'
            s = s_grads.get(name[:-len('_probe@GRAD')])
        else:
            last = op_type
            tol = tolerance(op_type)
            var = main.global_block()._find_var_recursive(name)
            bf16 = var is not None and var.dtype == 'bfloat16'
            s = s_outs.get(name)
        diff = parity_difference(
            g, r, tol == 'exact', bf16, grad, terms=terms, sums=s,
            where=ordinary(np.shape(r), *feed.values()),
            skip_nan=grad and last in NAN_OR_ZERO_GRAD)
        if diff is not None:
            raise AssertionError(
                'first difference: op %s, output %s, largest difference '
                '%r (tolerance %s%s)\nref  %s\nport %s'
                % (op_type if op_type != '@GRAD' else 'gradient', name,
                   diff, tol, ', bf16 ulp' if bf16 else '', r, g))
    return names


# ------------------------------------------------------------------ cases
def _op(L, op_type, inputs, out_dtype=None, attrs=None, out_slots=('Out',)):
    """One op of ``op_type`` with no layer of its own in the reference."""
    helper = JHelper(op_type)
    first = next(iter(inputs.values()))
    outs = {}
    for slot in out_slots:
        v = helper.create_variable_for_type_inference(
            out_dtype or first.dtype)
        outs[slot] = [v]
    helper.append_op(type=op_type, inputs={k: [v] for k, v in
                                           inputs.items()},
                     outputs=outs, attrs=attrs or {})
    return [outs[s][0] for s in out_slots]


def unary(layer, **attrs):
    return lambda L, v: getattr(L, layer)(v['x'], **attrs)


def binary(layer, **kw):
    return lambda L, v: getattr(L, layer)(v['x'], v['y'], **kw)


def compare(op_type):
    return lambda L, v: _op(L, op_type, {'X': v['x'], 'Y': v['y']},
                            out_dtype='bool')


def logical(op_type):
    def build(L, v):
        if op_type == 'logical_not':
            return getattr(L, op_type)(v['a'])
        return getattr(L, op_type)(v['a'], v['b'])
    return build


# (case id, build, inputs, positive domain); inputs: 'x', 'xy', 'bool',
# 'x_label', 'x_row' (y one row broadcast over x)
# the op types this slice adds
NEW_OPS = [
    ('elementwise_max', binary('elementwise_max'), 'xy', False),
    ('elementwise_min', binary('elementwise_min'), 'xy', False),
    ('elementwise_pow', binary('elementwise_pow'), 'xy', True),
    ('elementwise_mod', lambda L, v: _op(
        L, 'elementwise_mod', {'X': v['x'], 'Y': v['y']}), 'xy', False),
    ('elementwise_floordiv', lambda L, v: _op(
        L, 'elementwise_floordiv', {'X': v['x'], 'Y': v['y']}), 'xy',
     False),
    ('reduce_mean', lambda L, v: [L.reduce_mean(v['x']),
                                  L.reduce_mean(v['x'], dim=1,
                                                keep_dim=True)], 'x', False),
    ('reduce_max', lambda L, v: [L.reduce_max(v['x'], dim=[1]),
                                 L.reduce_max(v['x'], dim=0, keep_dim=True),
                                 L.reduce_max(v['x'])], 'x', False),
    ('reduce_min', lambda L, v: [L.reduce_min(v['x'], dim=-1),
                                 L.reduce_min(v['x'], keep_dim=True)], 'x',
     False),
    ('reduce_prod', lambda L, v: [L.reduce_prod(v['x'], dim=1),
                                  L.reduce_prod(v['x'], dim=[0, 1],
                                                keep_dim=True)], 'x', False),
    ('greater_than', compare('greater_than'), 'xy', False),
    ('greater_equal', compare('greater_equal'), 'xy', False),
    ('less_equal', compare('less_equal'), 'xy', False),
    ('not_equal', compare('not_equal'), 'xy', False),
    ('logical_and', logical('logical_and'), 'bool', False),
    ('logical_or', logical('logical_or'), 'bool', False),
    ('logical_xor', logical('logical_xor'), 'bool', False),
    ('logical_not', logical('logical_not'), 'bool', False),
    ('dot', binary('dot'), 'xy', False),
    ('minus', lambda L, v: _op(L, 'minus', {'X': v['x'], 'Y': v['y']}),
     'xy', False),
    ('l1_norm', unary('l1_norm'), 'x', False),
    ('squared_l2_norm', unary('squared_l2_norm'), 'x', False),
    ('squared_l2_distance', lambda L, v: _op(
        L, 'squared_l2_distance', {'X': v['x'], 'Y': v['y']},
        out_slots=('Out', 'sub_result')), 'x_row', False),
    ('prelu_all', lambda L, v: L.prelu(v['x'], mode='all'), 'x', False),
    ('prelu_channel', lambda L, v: L.prelu(v['x'], mode='channel'), 'x',
     False),
    ('prelu_element', lambda L, v: L.prelu(v['x'], mode='element'), 'x',
     False),
    ('mish', unary('mish'), 'x', False),
    ('stanh', unary('stanh'), 'x', False),
    ('hard_shrink', unary('hard_shrink'), 'x', False),
    ('softshrink', unary('softshrink'), 'x', False),
    ('hard_sigmoid', unary('hard_sigmoid'), 'x', False),
    ('soft_relu', unary('soft_relu'), 'x', False),
    ('thresholded_relu', unary('thresholded_relu'), 'x', False),
    ('sigmoid_cross_entropy_with_logits', lambda L, v:
     L.sigmoid_cross_entropy_with_logits(v['x'], v['label']), 'x_label',
     False),
    ('split', lambda L, v: L.split(v['x'], 2, dim=1) +
     L.split(v['x'], [3, 5], dim=-1) + L.split(v['x'], [1, 3], dim=0), 'x',
     False),
]

# the reference's layers over op types the port already had
LAYERS = [(n, unary(n), 'x', n in ('sqrt', 'rsqrt', 'log', 'reciprocal'))
          for n in ('abs', 'ceil', 'cos', 'elu', 'exp', 'floor', 'gelu',
                    'leaky_relu', 'log', 'logsigmoid', 'reciprocal', 'relu',
                    'relu6', 'round', 'rsqrt', 'sigmoid', 'sign', 'sin',
                    'softplus', 'softsign', 'sqrt', 'square', 'swish',
                    'tanh_shrink', 'tanh')] + [
    ('brelu', unary('brelu', t_min=0.0, t_max=24.0), 'x', False),
    ('pow', unary('pow', factor=0.5), 'x', True),
    ('pow_cube', unary('pow', factor=3.0), 'x', False),
    ('softmax', lambda L, v: L.softmax(v['x']), 'x', False),
    ('matmul', lambda L, v: [L.matmul(v['x'], v['y'], transpose_y=True),
                             L.matmul(v['x'], v['y'], transpose_x=True,
                                      alpha=0.5)], 'xy', False),
    ('mul', lambda L, v: L.mul(v['x'], L.transpose(v['y'], [1, 0])), 'xy',
     False),
    ('increment', lambda L, v: L.increment(v['x'], value=2.0,
                                           in_place=False), 'x', False),
    ('clip', lambda L, v: L.clip(v['x'], -1.5, 2.5), 'x', False),
    ('cast', lambda L, v: [L.cast(v['x'], d) for d in
                           ('int32', 'int16', 'int8', 'uint8', 'bool')],
     'x', False),
]



def _nchw(v, shape):
    return lambda L: L.reshape(v, shape)


# the op types of the tensor, nn and misc op modules the port adds next,
# through their layers where the reference has one; inputs as above and
# 'x_index' (int64 [5, 1] ids with a repeat), 'scatter' (x, three ids with
# a repeat, two update rows), 'x_ids' (int32 [4, 1] ids of {0, 1}),
# 'x_01' (a 0/1 float label of x's shape), 'p_01' (x in [0, 1] beside
# it: in [0.1, 0.9) at random, |x| / 3 clipped), 'image' (NCHW: [2, 3, 9, 7] at
# random, x as [1, 2, 4, 4] on the edge and subnormal feeds)
MODULE_OPS = [
    ('assign', unary('assign'), 'x', False),
    ('squeeze', lambda L, v: [
        L.squeeze(L.unsqueeze(v['x'], [0, 2]), [0, 2]),
        L.squeeze(L.unsqueeze(v['x'], [1]), [])], 'x', False),
    ('gather', lambda L, v: L.gather(v['x'], v['index']), 'x_index', False),
    ('scatter', lambda L, v: L.scatter(v['x'], v['index'], v['updates']),
     'scatter', False),
    ('shape', lambda L, v: [L.shape(v['x']),
                            L.shape(L.unsqueeze(v['x'], [0]))], 'x', False),
    ('pad', lambda L, v: [L.pad(v['x'], [1, 2, 0, 3], pad_value=0.5),
                          L.pad(v['x'], [0, 0, 2, 0])], 'x', False),
    ('reverse', lambda L, v: [L.reverse(v['x'], 1),
                              L.reverse(v['x'], [0, 1])], 'x', False),
    ('multiplex', lambda L, v: L.multiplex([v['x'], v['y']], v['ids']),
     'x_ids', False),
    ('smooth_l1_loss', lambda L, v: [
        L.smooth_l1(v['x'], v['y']),
        L.smooth_l1(v['x'], v['y'], sigma=2.0, last_dim_only=True),
        L.smooth_l1(v['x'], v['y'], inside_weight=v['w'],
                    outside_weight=v['w'], sigma=0.5)], 'xyw', False),
    ('auc', lambda L, v: L.auc(v['x'], v['label']), 'x_01', False),
    ('l2_normalize', lambda L, v: [L.l2_normalize(v['x'], axis=1),
                                   L.l2_normalize(v['x'], axis=0,
                                                  epsilon=1e-3)], 'x',
     False),
    ('maxout', lambda L, v: L.maxout(L.reshape(v['x'], [2, 4, 2, 2]), 2),
     'x', False),
    ('im2sequence', lambda L, v: [
        L.im2sequence(L.reshape(v['x'], [2, 1, 4, 4]), filter_size=[2, 3],
                      stride=[1, 2], padding=[1, 0, 0, 1]),
        L.im2sequence(L.reshape(v['x'], [1, 2, 4, 4]), filter_size=2,
                      stride=2)], 'x', False),
    ('label_smooth', lambda L, v: [
        L.label_smooth(v['x'], epsilon=0.2),
        L.label_smooth(v['x'], prior_dist=v['y'], epsilon=0.1)], 'x_row',
     False),
    ('huber_loss', lambda L, v: [L.huber_loss(v['x'], v['y']),
                                 L.huber_loss(v['x'], v['y'], delta=0.5)],
     'xy', False),
    ('rank_loss', lambda L, v: L.rank_loss(v['label'], v['x'], v['y']),
     'xy_01', False),
    ('margin_rank_loss', lambda L, v: [
        L.margin_rank_loss(v['label'], v['x'], v['y'], margin=0.5),
        L.margin_rank_loss(v['label'], v['x'], v['y'], margin=0.0)],
     'xy_01', False),
    ('hinge_loss', lambda L, v: L.hinge_loss(v['x'], v['label']), 'x_01',
     False),
    ('log_loss', lambda L, v: L.log_loss(v['x'], v['label']), 'p_01',
     False),
    ('bilinear_tensor_product', lambda L, v: L.bilinear_tensor_product(
        v['x'], v['y'], 3), 'xy', False),
    ('pixel_shuffle', lambda L, v: L.pixel_shuffle(
        L.reshape(v['x'], [2, 4, 2, 2]), 2), 'x', False),
    ('modified_huber_loss', lambda L, v: L.modified_huber_loss(
        v['x'], v['label']), 'x_01', False),
    ('argmin', lambda L, v: [L.argmin(v['x'], axis=1),
                             L.argmin(v['x'], axis=0)], 'x', False),
    ('argsort', lambda L, v: list(L.argsort(v['x'], axis=1)) +
     list(L.argsort(v['x'], axis=0)), 'x', False),
    ('bilinear_interp', lambda L, v: [
        L.resize_bilinear(v['x'], s) for s in ((11, 9), (5, 3), (3, 2),
                                               (4, 12))], 'image', False),
    ('nearest_interp', lambda L, v: [
        L.resize_nearest(v['x'], s) for s in ((11, 9), (5, 3), (3, 2),
                                              (4, 12))], 'image', False),
    ('isfinite', lambda L, v: [L.isfinite(v['x']),
                               L.isfinite(L.reshape(v['x'], [2, 16]))], 'x',
     False),
    ('lod_reset', lambda L, v: _op(L, 'lod_reset', {'X': v['x']}), 'x',
     False),
    ('where', lambda L, v: L.where(v['x'], v['x'], v['y']), 'xy', False),
    ('linspace', lambda L, v: [
        L.elementwise_add(v['x'], L.linspace(-3.5, 2.25, 8)),
        L.linspace(0.0, 1.0, 100), L.linspace(2, 9, 5, 'int32'),
        L.linspace(1.5, 1.5, 1)], 'x', False),
    ('range', lambda L, v: [
        L.elementwise_add(v['x'], L.range(-1.5, 2.5, 0.5, 'float32')),
        L.range(0, 10, 3, 'int64'), L.range(0.1, 1.0, 0.1, 'float32')],
     'x', False),
    ('weight_norm', lambda L, v: [
        L.elementwise_mul(v['x'], L.create_parameter(
            [4, 8], 'float32', attr=fluid.WeightNormParamAttr(dim=d)))
        for d in (0, 1, None)], 'x', False),
]

CASES = {c[0]: c for c in NEW_OPS + LAYERS + MODULE_OPS}


def _softmax(x):
    with np.errstate(invalid='ignore', over='ignore'):
        e = np.exp(x - x.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)


def _sums_matmul(f):
    a, b = np.abs(f['x']), np.abs(f['y'])
    with np.errstate(invalid='ignore'):
        return [a @ b.T, 0.5 * a.T @ b], \
            {'x': b.sum(0)[None] + 0.5 * b.sum(1)[:, None],
             'y': a.sum(0)[None] + 0.5 * a.sum(1)[:, None]}


def _sums_distance(f):
    d = np.abs(f['x'] - f['y'])
    return [(d * d).sum(1, keepdims=True), None], \
        {'x': 2 * d, 'y': 2 * d.sum(0, keepdims=True)}


# the bilinear product's weight is Xavier-uniform, |W| < 0.27 ([3, 8, 8]:
# sqrt(6 / (64 + 24)))
def _sums_bilinear(f):
    a, b = np.abs(f['x']), np.abs(f['y'])
    with np.errstate(invalid='ignore', over='ignore'):
        return [np.broadcast_to(0.27 * (a.sum(1) * b.sum(1))[:, None],
                                (4, 3))], \
            {'x': np.broadcast_to(0.27 * 3 * b.sum(1, keepdims=True), a.shape),
             'y': np.broadcast_to(0.27 * 3 * a.sum(1, keepdims=True), b.shape)}


# the cases that sum an element from terms: how many, and the magnitudes
# of those terms for each output and gradient (check_parity); a product's
# are its own magnitude (its n roundings are relative)
SUMS = {
    'reduce_mean': (32, lambda f: (
        [np.abs(f['x']).mean(), np.abs(f['x']).mean(1, keepdims=True)],
        {'x': np.full(f['x'].shape, 1 / 32 + 1 / 8)})),
    'reduce_prod': (32, lambda f: (
        [np.abs(f['x']).prod(1), np.abs(f['x']).prod().reshape(1, 1)],
        {'x': prod_others(np.abs(f['x']), 1) +
         prod_others(np.abs(f['x']))})),
    'dot': (8, lambda f: ([(np.abs(f['x'] * f['y'])).sum(1, keepdims=True)],
                          {'x': np.abs(f['y']), 'y': np.abs(f['x'])})),
    'l1_norm': (32, lambda f: ([np.abs(f['x']).sum()],
                               {'x': np.ones(f['x'].shape)})),
    'squared_l2_norm': (32, lambda f: ([np.square(f['x']).sum()],
                                       {'x': 2 * np.abs(f['x'])})),
    'squared_l2_distance': (8, _sums_distance),
    'matmul': (8, _sums_matmul),
    'mul': (8, lambda f: ([np.abs(f['x']) @ np.abs(f['y']).T],
                          {'x': np.broadcast_to(np.abs(f['y']).sum(0),
                                                f['x'].shape),
                           'y': np.broadcast_to(np.abs(f['x']).sum(0),
                                                f['y'].shape)})),
    'softmax': (8, lambda f: ([np.abs(_softmax(f['x']))],
                              {'x': np.abs(_softmax(f['x']))})),
    'bilinear_tensor_product': (64, _sums_bilinear),
}


def case_feed(inputs, kind, positive):
    x, y = feed_for(kind, positive)
    ids = np.random.RandomState(5 if kind == 'random' else 6)
    label01 = (ids.rand(*x.shape) > 0.5).astype(np.float32)
    if inputs == 'x':
        return {'x': x}
    if inputs == 'xy':
        return {'x': x, 'y': y}
    if inputs == 'xyw':
        return {'x': x, 'y': y, 'w': np.abs(_random(7))}
    if inputs == 'x_row':
        return {'x': x, 'y': y[1:2]}
    if inputs == 'x_label':
        return {'x': x, 'label': np.clip(np.nan_to_num(np.abs(y)), 0, 1)
                .astype(np.float32)}
    if inputs == 'x_01':
        return {'x': x, 'label': label01}
    if inputs == 'p_01':
        p = _random(9, shape=x.shape) * 0.2 + 0.5 if kind == 'random' \
            else np.clip(np.abs(x) / 3.0, 0.0, 1.0)
        return {'x': p.astype(np.float32), 'label': label01}
    if inputs == 'xy_01':
        return {'x': x, 'y': y, 'label': label01}
    if inputs == 'x_index':
        return {'x': x, 'index': np.array([[3], [0], [3], [1], [2]],
                                          np.int64)}
    if inputs == 'scatter':
        return {'x': x, 'index': np.array([[1], [3], [1]], np.int64),
                'updates': y[:3]}
    if inputs == 'x_ids':
        return {'x': x, 'y': y, 'ids': np.array([[1], [0], [1], [1]],
                                                np.int32)}
    if inputs == 'image':
        return {'x': _random(8, shape=(2, 3, 9, 7)) if kind == 'random'
                else x.reshape(1, 2, 4, 4)}
    rng = np.random.RandomState(3 if kind == 'random' else 4)
    return {'a': rng.rand(4, 8) > 0.5, 'b': rng.rand(4, 8) > 0.5}


@pytest.mark.parametrize('amp', [None, 'bf16'], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('kind', ['random', 'edge', 'subnormal'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_op_parity(case, kind, amp):
    """Each new op type and each layer over a registered op: the port's
    program loaded from the reference's equals it, forward and gradient,
    on a random, an edge and a subnormal feed, at fp32 and under bf16
    AMP."""
    _, build, inputs, positive = CASES[case]
    check_parity(build, case_feed(inputs, kind, positive), amp=amp,
                 flush_denormal=kind == 'subnormal', sums=SUMS.get(case))


# the six faults repaired in this slice: the op's build; the edge values
# of x where the port gave another value or gradient before are
# LAYERS_FAULTS'
FAULTS = {
    'sign': unary('sign'),
    'gelu': unary('gelu'),
    'cast': CASES['cast'][1],
    'pow': unary('pow', factor=0.5),
    'clip': CASES['clip'][1],
    'brelu': unary('brelu', t_min=0.0, t_max=24.0),
    'relu6': unary('relu6'),
    'leaky_relu': unary('leaky_relu'),
}


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_repaired_fault(fault):
    """Each repaired fault on the edge feed, fp32: at the edge values it
    concerns (NaN, +-inf, beyond int32, a clip's bounds, 0) the port's
    value and gradient equal the reference's exactly, and at least one
    such value is there to compare."""
    build, where = FAULTS[fault], LAYERS_FAULTS[fault]
    x = EDGE
    names, ref, got, _, _ = run_both(build, {'x': x})
    at = where(x)
    assert at.any()
    compared = 0
    for (op_type, name), r, g in zip(names, ref, got):
        if op_type in ('elementwise_add', 'cast') and fault != 'cast':
            continue
        if r.shape != x.shape:
            continue
        r64, g64 = _as_f64(r)[at], _as_f64(g)[at]
        assert np.array_equal(r64, g64, equal_nan=True), \
            (fault, op_type, name, x[at], r64, g64)
        compared += 1
    assert compared >= (5 if fault == 'cast' else 2), names


# the random fills: their bits diverge from the reference's by design, so
# they are held to the reference's shape and dtype, their range or
# moments, and same-seed repeatability
RANDOM = {
    'uniform_random_batch_size_like': lambda L, v:
    L.uniform_random_batch_size_like(v['x'], [1, 64], min=-0.5, max=2.0),
    'gaussian_random_batch_size_like': lambda L, v:
    L.gaussian_random_batch_size_like(v['x'], [3, 1], input_dim_idx=1,
                                      output_dim_idx=1, mean=1.0, std=2.0),
    'uniform_random': lambda L, v: L.uniform_random([256, 64], min=-0.5,
                                                    max=2.0),
    'gaussian_random': lambda L, v: L.gaussian_random([256, 64], mean=1.0,
                                                      std=2.0),
}


def _random_runs(build, feed, seed):
    """The reference's draw, and the port's at two executor steps, twice
    (two executors of one program seed)."""
    main, startup, outs, _ = build_reference(build, feed, None,
                                             backward=False)
    main.random_seed = seed
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(jscope):
        jexe.run(startup)
        ref, = jexe.run(main, feed=feed, fetch_list=[outs[0]])
    pmain = program_from_dict(json.loads(json.dumps(jax_to_dict(main))))
    pstart = program_from_dict(json.loads(json.dumps(jax_to_dict(startup))))
    runs = []
    for _ in range(2):
        pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
        with pt.scope_guard(pscope):
            pexe.run(pstart)
            runs.append([np.asarray(pexe.run(pmain, feed=feed,
                                             fetch_list=[outs[0].name])[0])
                         for _ in range(2)])
    return np.asarray(ref), runs


@pytest.mark.parametrize('op', sorted(RANDOM))
def test_random_fill(op):
    """Shape and dtype as the reference's, range [min, max) or mean and
    std within 4 standard errors (16,384 draws), the same draws from a
    second executor of the same program seed at the same step, new
    draws at the next step."""
    x = np.zeros((256, 3), np.float32)
    ref, ((a0, a1), (b0, b1)) = _random_runs(RANDOM[op], {'x': x}, seed=7)
    assert a0.shape == ref.shape == ((256, 64) if 'uniform' in op else
                                     (3, 3) if 'like' in op else (256, 64))
    assert a0.dtype == ref.dtype == np.float32
    assert np.array_equal(a0, b0) and np.array_equal(a1, b1)
    if op.startswith('uniform_random'):
        assert a0.min() >= -0.5 and a0.max() < 2.0
        assert abs(a0.mean() - 0.75) < 4 * 2.5 / np.sqrt(12 * a0.size)
    elif a0.size > 100:
        assert abs(a0.mean() - 1.0) < 4 * 2.0 / np.sqrt(a0.size)
        assert abs(a0.std() - 2.0) < 0.1
    if 'like' in op:
        assert not np.array_equal(a0, a1)
    else:
        assert np.array_equal(a0, a1)


# ------------------------------------------------- the harness catches
class _Mapped(object):
    """A lowering's context whose Out goes through ``fn``."""

    def __init__(self, ctx, fn):
        self._ctx, self._fn = ctx, fn

    def __getattr__(self, name):
        return getattr(self._ctx, name)

    def set_output(self, slot, value):
        self._ctx.set_output(slot, self._fn(value))


def _mapped(op_type, fn):
    def mutate(monkeypatch):
        from paddle_tpu_torch.core import registry
        right = registry.OP_LOWERINGS[op_type]
        monkeypatch.setitem(registry.OP_LOWERINGS, op_type,
                            lambda ctx: right(_Mapped(ctx, fn)))
    return mutate


def _drop_a_factor(monkeypatch):
    """reduce_prod leaves out the last factor along each reduced axis."""
    forward = pointwise._Prod.forward

    def wrong(ctx, x, dim, keep):
        last = x.narrow(dim, x.shape[dim] - 1, 1)
        return forward(ctx, x, dim, keep) / (last if keep else
                                             last.squeeze(dim))
    monkeypatch.setattr(pointwise._Prod, 'forward', staticmethod(wrong))


# a wrong port, the case and the feed it runs on. The harness's earlier
# rule scaled the bound of an op that sums by 32 times the run's largest
# magnitude (about 0.9 under bf16 for reduce_prod) and a pointwise op's by
# the output's largest (3e9 on the edge feed): it passed reduce_prod 2^-5
# off under bf16 and gelu 2^-4 off at both precisions
WRONG = {
    'reduce_prod without a factor': (_drop_a_factor, 'reduce_prod',
                                     'random'),
    'reduce_prod 2^-5 off': (_mapped('reduce_prod',
                                     lambda v: v * (1.0 + 2.0 ** -5)),
                             'reduce_prod', 'random'),
    'gelu 2^-4 off': (_mapped('gelu', lambda v: v + 2.0 ** -4), 'gelu',
                      'edge'),
}


@pytest.mark.parametrize('amp', [None, 'bf16'], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('wrong', sorted(WRONG))
def test_harness_catches_a_wrong_port(wrong, amp, monkeypatch):
    """A port that leaves a factor out of reduce_prod, puts its value four
    bf16 ulps off, or adds 2^-4 to gelu's on the edge feed fails
    check_parity at fp32 and under bf16 AMP, the first difference named
    at that op."""
    mutate, case, kind = WRONG[wrong]
    mutate(monkeypatch)
    _, build, inputs, positive = CASES[case]
    with pytest.raises(AssertionError, match='op %s,' % case):
        check_parity(build, case_feed(inputs, kind, positive), amp=amp,
                     sums=SUMS.get(case))


def test_an_extreme_element_widens_no_other_bound():
    """parity_difference takes a pointwise op's scale from the ordinary
    elements: beside an output of 3e9, an error of 1e-3 at 1.0 fails;
    with every element in the scale it would pass."""
    x = np.array([3e9, 1.0, -0.5], np.float32)
    want = x.astype(np.float64)
    got = want + np.array([0.0, 1e-3, 0.0])
    assert parity_difference(got, want, where=ordinary(x.shape, x)) == \
        pytest.approx(1e-3)
    assert parity_difference(got, want) is None


# ----------------------------------- the random op module's new op types
def _no_input_op(L, op_type, attrs, dtype='float32'):
    helper = JHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type=op_type, inputs={}, outputs={'Out': [out]},
                     attrs=attrs)
    return [out]


RANDOM_OPS = {
    'truncated_gaussian_random': lambda L, v: _no_input_op(
        L, 'truncated_gaussian_random',
        {'shape': [256, 64], 'mean': 1.0, 'std': 2.0}),
    'randint': lambda L, v: _no_input_op(
        L, 'randint', {'shape': [256, 64], 'low': -3, 'high': 7}, 'int64'),
    'shuffle_batch': lambda L, v: _op(L, 'shuffle_batch', {'X': v['x']},
                                      out_slots=('Out',)),
}


@pytest.mark.parametrize('op', sorted(RANDOM_OPS))
def test_random_op(op):
    """truncated_gaussian_random, randint and shuffle_batch: the
    reference's shape, their range and moments (16,384 draws; the
    truncated normal's std is 0.8796 of its std), the same draws from a
    second executor of the program seed at the same step and new ones at
    the next step."""
    x = np.repeat(np.arange(256, dtype=np.float32)[:, None], 3, axis=1)
    ref, ((a0, a1), (b0, b1)) = _random_runs(RANDOM_OPS[op], {'x': x},
                                             seed=17)
    assert a0.shape == ref.shape
    assert np.array_equal(a0, b0) and np.array_equal(a1, b1)
    assert not np.array_equal(a0, a1)
    if op == 'truncated_gaussian_random':
        assert a0.dtype == ref.dtype == np.float32
        for v in (a0, ref):
            assert v.min() >= -3.0 and v.max() <= 5.0
        assert abs(a0.mean() - 1.0) < 4 * 1.76 / np.sqrt(a0.size)
        assert abs(a0.std() - 2.0 * 0.8796) < 0.05
    elif op == 'randint':
        assert a0.dtype == np.int64
        assert a0.min() == ref.min() == -3 and a0.max() == ref.max() == 6
        assert set(np.unique(a0)) == set(range(-3, 7))
        assert abs(a0.mean() - 1.5) < 4 * np.sqrt(8.25 / a0.size)
    else:
        assert a0.dtype == ref.dtype == np.float32
        for v in (a0, ref):
            np.testing.assert_array_equal(np.sort(v[:, 0]), x[:, 0])
            assert (v == v[:, :1]).all()


def test_shuffle_batch_index_and_gradient():
    """Out is X[ShuffleIdx], ShuffleIdx an int64 permutation, and X's
    gradient through the gather is the upstream gradient sent back to
    each row's place."""
    main, startup = pt.Program(), pt.Program()
    main.random_seed = 3
    with pt.program_guard(main, startup):
        L = pt.layers
        x = L.elementwise_add(
            L.data(name='x', shape=[64, 3], dtype='float32',
                   append_batch_size=False),
            L.create_parameter([64, 3], 'float32', name='x_probe',
                               default_initializer=pt.initializer.Constant(
                                   -0.0)))
        c = L.data(name='c', shape=[64, 3], dtype='float32',
                   append_batch_size=False)
        from paddle_tpu_torch.layers.helper import LayerHelper
        helper = LayerHelper('shuffle_batch')
        out = helper.create_variable_for_type_inference('float32')
        idx = helper.create_variable_for_type_inference('int64')
        helper.append_op(type='shuffle_batch', inputs={'X': [x]},
                         outputs={'Out': [out], 'ShuffleIdx': [idx]})
        loss = L.reduce_sum(L.elementwise_mul(out, c))
        pt.backward.append_backward(loss)
    rng = np.random.RandomState(0)
    xv, cv = rng.randn(64, 3).astype('f'), rng.randn(64, 3).astype('f')
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        o, i, g = exe.run(main, feed={'x': xv, 'c': cv},
                          fetch_list=[out, idx, 'x_probe@GRAD'])
    assert i.dtype == np.int64
    np.testing.assert_array_equal(np.sort(i), np.arange(64))
    np.testing.assert_array_equal(o, xv[i])
    want = np.zeros_like(cv)
    want[i] = cv
    np.testing.assert_array_equal(g, want)


def test_nce_closed_form():
    """nce's Cost equals -log sigmoid(s_pos) - sum log sigmoid(-s_neg)
    computed in numpy from the port's weights and the negatives it drew
    (the op's generator: program seed, op index and step), and the
    reference's program builds the same op."""
    from paddle_tpu_torch.core.registry import _mix
    feed = {'x': _random(11, shape=(6, 5)),
            'label': np.array([[0], [3], [7], [3], [9], [1]], np.int64)}

    def build(L, v):
        return L.nce(v['x'], v['label'], num_total_classes=10,
                     num_neg_samples=4)
    main, startup, outs, _ = build_reference(build, feed, None,
                                             backward=False)
    main.random_seed = 5
    pmain = program_from_dict(json.loads(json.dumps(jax_to_dict(main))))
    pstart = program_from_dict(json.loads(json.dumps(jax_to_dict(startup))))
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        exe.run(pstart)
        runs = [exe.run(pmain, feed=feed, fetch_list=[outs[0].name])[0]
                for _ in range(2)]
    ops = pmain.global_block().ops
    k = next(i for i, op in enumerate(ops) if op.type == 'nce')
    w_name, b_name = ops[k].input('Weight'), ops[k].input('Bias')
    w = scope.find(w_name).numpy().astype(np.float64)
    b = scope.find(b_name).numpy().astype(np.float64).reshape(-1)
    x = scope.find('x_probe').numpy() + feed['x']
    lbl = feed['label'][:, 0]
    for step, got in enumerate(runs, start=1):
        g = torch.Generator().manual_seed(_mix(5, k, step))
        neg = torch.randint(0, 10, (4,), generator=g).numpy()
        s_pos = (x * w[lbl]).sum(1) + b[lbl]
        s_neg = x @ w[neg].T + b[neg]
        want = np.log1p(np.exp(-s_pos)) + np.log1p(np.exp(s_neg)).sum(1)
        assert got.shape == (6, 1)
        np.testing.assert_allclose(got[:, 0], want, rtol=1e-5)
    assert not np.array_equal(runs[0], runs[1])


def test_print_writes_and_passes(capsys):
    """Print writes its message and the value at every run, as
    jax.debug.print does inside the reference's program, and Out is In
    bit for bit."""
    x = _random(12)

    def build(L, v):
        return L.Print(v['x'], message='the value: ')
    main, startup, outs, _ = build_reference(build, {'x': x}, None,
                                             backward=False)
    pmain = program_from_dict(json.loads(json.dumps(jax_to_dict(main))))
    pstart = program_from_dict(json.loads(json.dumps(jax_to_dict(startup))))
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(pstart)
        capsys.readouterr()
        got = [exe.run(pmain, feed={'x': x}, fetch_list=[outs[0].name])[0]
               for _ in range(2)]
    written = capsys.readouterr().out
    assert written.count('the value: ' + '{}'.format(x)) == 2
    for g in got:
        np.testing.assert_array_equal(g, x)
