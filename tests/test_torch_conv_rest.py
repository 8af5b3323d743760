"""The conv path's convolution and normalization ops, port against the JAX
package's lowerings on the same numpy inputs: conv2d_transpose, conv3d,
row_conv, conv_shift, spp, group_norm and norm, each forward and its
gradient (through jax.vjp and torch autograd, with one cotangent from a
seed), at fp32 and under bf16 AMP; and their layers (with lrn, crop,
roi_pool, max_pool2d_with_index and unpool) build the reference's
programs.

Tolerances: fp32 sums in another order (cuDNN / oneDNN against XLA's
convolution): 1e-4 of the output's largest magnitude for the
convolutions, 1e-5 for the normalizations, 1e-6 for the ops that add a
few terms in the reference's order (row_conv, conv_shift, spp); exact for
max pooling. bf16: one bf16 ulp of each element plus 2^-7 of the output's
largest magnitude (the two packages round a bf16 op's intermediate
values at different points); gradients under bf16 twice that (torch
rounds each op's gradient to bf16, the reference keeps its cotangents in
fp32 inside one computation)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.core.registry import LoweringContext as JaxContext
from paddle_tpu.ops import conv_ops as jconv, norm_ops as jnorm

from paddle_tpu_torch.core.registry import LoweringContext as TorchContext
from paddle_tpu_torch.ops import conv_ops as tconv, norm_ops as tnorm

from test_torch_layers import _same_program, _x


class FakeOp(object):
    def __init__(self, type, inputs, outputs, attrs):
        self.type, self.attrs = type, attrs
        self.inputs = {k: [k.lower()] for k in inputs}
        self.outputs = {k: [k.lower()] for k in outputs}

    def input(self, slot):
        return self.inputs[slot][0]

    def output(self, slot):
        names = self.outputs.get(slot)
        return names[0] if names else None


class NoVars(object):
    def _find_var_recursive(self, name):
        return None


def bf16_ulp(a):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
                   - 7)


def run_op(lowerings, op_type, inputs, outs, attrs=None, amp=None,
           grad=(), bf16_in=(), seed=0):
    """The op through the JAX lowering and the port's on ``inputs`` ({slot:
    numpy}); ``bf16_in``: slots given as bfloat16. Returns [(ref, port)]
    of each output slot, then of each gradient slot (the cotangent a
    seeded normal of each float output)."""
    jlower, tlower = lowerings
    attrs = attrs or {}
    op = FakeOp(op_type, inputs, outs, attrs)
    grad = list(grad)
    rng = np.random.RandomState(seed + 99)
    cts = {}

    def jfun(*gvals):
        env = {}
        for slot, v in inputs.items():
            a = jnp.asarray(v)
            env[slot.lower()] = a.astype(jnp.bfloat16) if slot in bf16_in \
                else a
        for slot, g in zip(grad, gvals):
            env[slot.lower()] = g
        jlower(JaxContext(env, op, NoVars(), 0, None, amp=amp))
        return [env[o.lower()] for o in outs]

    gin = [jnp.asarray(inputs[s]).astype(jnp.bfloat16) if s in bf16_in
           else jnp.asarray(inputs[s]) for s in grad]
    ref, vjp = jax.vjp(jfun, *gin)
    for o, r in zip(outs, ref):
        if jnp.issubdtype(r.dtype, jnp.floating):
            cts[o] = rng.randn(*r.shape).astype('float32')
    ref_grads = vjp([jnp.asarray(cts[o]).astype(r.dtype) if o in cts
                     else np.zeros(r.shape, jax.dtypes.float0)
                     for o, r in zip(outs, ref)]) if grad else []

    env = {}
    leaves = {}
    for slot, v in inputs.items():
        t = torch.tensor(v)
        if slot in bf16_in:
            t = t.bfloat16()
        if slot in grad:
            t.requires_grad_()
            leaves[slot] = t
        env[slot.lower()] = t
    tlower(TorchContext(env, op, NoVars(), 0, torch.device('cpu'), amp=amp))
    got = [env[o.lower()] for o in outs]
    got_grads = []
    if grad:
        pairs = [(g, torch.tensor(cts[o]).to(g.dtype)) for o, g in
                 zip(outs, got) if o in cts and g.requires_grad]
        got_grads = torch.autograd.grad([p[0] for p in pairs],
                                        [leaves[s] for s in grad],
                                        [p[1] for p in pairs],
                                        allow_unused=True)
    as_np = [np.asarray(jnp.asarray(r).astype(jnp.float32)
                        if jnp.issubdtype(r.dtype, jnp.floating)
                        else r) for r in list(ref) + list(ref_grads)]
    got_np = [(g.detach().float() if g.is_floating_point() else g.detach())
              .numpy() if g is not None else None
              for g in list(got) + list(got_grads)]
    return list(zip(as_np, got_np))


def close(pairs, rtol, bf16=False, grad_from=None, grad_k=2.0):
    """Each (ref, port) pair: the same shape; fp32 within rtol of the
    output's largest |ref|; bf16 within one ulp of each element plus 2^-7
    of the largest |ref| (``grad_k`` times that for the pairs from
    ``grad_from`` on)."""
    for i, (r, g) in enumerate(pairs):
        assert g is not None and r.shape == g.shape, (i, r.shape)
        r64, g64 = r.astype(np.float64), g.astype(np.float64)
        scale = float(np.abs(r64).max()) if r64.size else 0.0
        if bf16:
            k = grad_k if grad_from is not None and i >= grad_from else 1.0
            bound = k * (bf16_ulp(r64) + 2.0 ** -7 * scale)
        else:
            bound = rtol * scale + 1e-30
        err = np.abs(g64 - r64)
        assert (err <= bound).all(), (i, float(err.max()),
                                      float(np.max(bound)))


CONV = (jconv._conv2d_transpose, tconv._conv2d_transpose)
CONV3D = (jconv._conv3d, tconv._conv3d)

# (strides, paddings, dilations, groups, filter)
TRANSPOSE_CASES = [
    ([2, 2], [1, 1], [1, 1], 1, (6, 4, 4, 4)),
    ([1, 1], [0, 0], [1, 1], 1, (6, 3, 3, 3)),
    ([2, 3], [0, 2], [2, 1], 1, (6, 2, 3, 5)),
    ([2, 2], [1, 1], [1, 1], 2, (6, 2, 3, 3)),
]


@pytest.mark.parametrize('amp', [None, 'bf16'], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('case', TRANSPOSE_CASES)
def test_conv2d_transpose_matches_reference(case, amp):
    """conv2d_transpose (on the AMP whitelist: fp32 operands cast to
    bf16): the output extent (in - 1)·stride - 2·pad + dilation·(k - 1)
    + 1, the output and the gradients of Input and Filter."""
    strides, pads, dil, groups, fshape = case
    rng = np.random.RandomState(groups + strides[1])
    x = rng.randn(2, 6, 5, 7).astype('float32')
    w = rng.randn(*fshape).astype('float32')
    pairs = run_op(CONV, 'conv2d_transpose', {'Input': x, 'Filter': w},
                   ['Output'], dict(strides=strides, paddings=pads,
                                    dilations=dil, groups=groups),
                   amp=amp, grad=['Input', 'Filter'])
    oh = (5 - 1) * strides[0] - 2 * pads[0] + dil[0] * (fshape[2] - 1) + 1
    assert pairs[0][1].shape == (2, fshape[1] * groups, oh,
                                 pairs[0][1].shape[3])
    close(pairs, 1e-4, bf16=amp is not None, grad_from=1)


@pytest.mark.parametrize('amp', [None, 'bf16'], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('case', [([1, 1, 1], [1, 1, 1], [1, 1, 1], 1),
                                  ([2, 1, 2], [0, 1, 2], [1, 2, 1], 1),
                                  ([1, 2, 1], [1, 0, 1], [1, 1, 1], 2)])
def test_conv3d_matches_reference(case, amp):
    """conv3d (on no AMP list: a bf16 input runs in bf16, an fp32 one in
    fp32): NCDHW input, OIDHW filter, output and gradients."""
    strides, pads, dil, groups = case
    rng = np.random.RandomState(7 + groups)
    x = rng.randn(2, 4, 5, 6, 7).astype('float32')
    w = rng.randn(6, 4 // groups, 3, 3, 3).astype('float32')
    bf16 = ('Input', 'Filter') if amp else ()
    pairs = run_op(CONV3D, 'conv3d', {'Input': x, 'Filter': w}, ['Output'],
                   dict(strides=strides, paddings=pads, dilations=dil,
                        groups=groups), amp=amp, grad=['Input', 'Filter'],
                   bf16_in=bf16)
    close(pairs, 1e-4, bf16=amp is not None, grad_from=1)


@pytest.mark.parametrize('amp', [None, 'bf16'], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('k', [1, 3, 6])
def test_row_conv_matches_reference(k, amp):
    """row_conv's k taps summed in the reference's order (i = 0..k-1,
    from 0): fp32 within 1e-6; the lookahead past the end reads 0."""
    rng = np.random.RandomState(k)
    x = rng.randn(3, 5, 8).astype('float32')
    w = rng.randn(k, 8).astype('float32')
    pairs = run_op((jconv._row_conv, tconv._row_conv), 'row_conv',
                   {'X': x, 'Filter': w}, ['Out'], amp=amp,
                   grad=['X', 'Filter'])
    close(pairs, 1e-6, bf16=amp is not None, grad_from=1)


@pytest.mark.parametrize('amp', [None, 'bf16'], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('shape', [(2, 6, 3), (4, 9, 5), (3, 7, 7)])
def test_conv_shift_matches_reference(shape, amp):
    """Circular convolution: out[i] = Σ_j x[(i + j - n//2) mod m]·y[j],
    the wrap at both ends, with the gradients of X and Y."""
    b, m, n = shape
    rng = np.random.RandomState(m)
    x = rng.randn(b, m).astype('float32')
    y = rng.randn(b, n).astype('float32')
    bf16 = ('X', 'Y') if amp else ()
    pairs = run_op((jconv._conv_shift, tconv._conv_shift), 'conv_shift',
                   {'X': x, 'Y': y}, ['Out'], amp=amp, grad=['X', 'Y'],
                   bf16_in=bf16)
    close(pairs, 1e-6, bf16=amp is not None, grad_from=1)


@pytest.mark.parametrize('pooling', ['max', 'avg'])
@pytest.mark.parametrize('height', [1, 2, 3])
def test_spp_matches_reference(height, pooling):
    """Spatial pyramid pooling over a 7 x 9 map (levels of ragged,
    ceil-mode bins: level 2 pools 2 x 3 windows into 4 x 3 bins, not 4 x
    4): max exact, avg within 1e-6, and the gradient; the
    input is a ReLU output with ties at 0."""
    rng = np.random.RandomState(height)
    x = np.maximum(rng.randn(2, 3, 7, 9), 0).astype('float32')
    pairs = run_op((jconv._spp, tconv._spp), 'spp', {'X': x}, ['Out'],
                   dict(pyramid_height=height, pooling_type=pooling),
                   grad=['X'])
    close(pairs, 0.0 if pooling == 'max' else 1e-6)


# (ksize, strides, paddings, ceil_mode, data_format): apart, overlapping
# (ResNet's stem pool, GoogLeNet's 3x3/1 and ceil-mode pools), padding
# beyond half the window, NHWC
MAX_POOLS = [
    (2, 2, 0, False, 'NCHW'),
    (3, 2, 1, False, 'NCHW'),
    (3, 1, 1, False, 'NCHW'),
    (3, 2, 0, True, 'NCHW'),
    (2, 1, 2, False, 'NCHW'),
    (3, 2, 1, True, 'NHWC'),
]


@pytest.mark.parametrize('amp', [None, 'bf16'], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('case', MAX_POOLS, ids=lambda c: 'k%d_s%d_p%d%s_%s'
                         % (c[0], c[1], c[2], '_ceil' if c[3] else '',
                            c[4]))
def test_max_pool_gradient_at_nan_matches_reference(case, amp):
    """pool2d's max gradient on a map of NaN, ±inf, -inf-only windows and
    ties: the reference's select_and_scatter keeps its pick while pick >=
    next, so in a window holding a NaN the gradient goes to the first
    largest element after the last NaN, not to the NaN. Out equal (NaN
    where a window holds one); the gradient exact where windows do not
    overlap, else within the rounding of its sums (fp32 1e-6 of the
    largest entry, bf16 one ulp of each element and 2^-7)."""
    k, s, p, ceil, fmt = case
    rng = np.random.RandomState(k * 10 + s + p)
    x = np.round(rng.randn(2, 3, 7, 9) * 2) / 2
    x[rng.rand(*x.shape) < 0.15] = np.nan
    x[rng.rand(*x.shape) < 0.05] = np.inf
    x[rng.rand(*x.shape) < 0.05] = -np.inf
    x[0, 0, :3, :3] = -np.inf
    x = x.astype('float32')
    if fmt == 'NHWC':
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    attrs = dict(pooling_type='max', ksize=[k, k], strides=[s, s],
                 paddings=[p, p], ceil_mode=ceil, data_format=fmt)
    (out_r, out_g), (g_r, g_g) = run_op(
        (jconv._pool2d, tconv._pool2d), 'pool2d', {'X': x}, ['Out'], attrs,
        amp=amp, grad=['X'], bf16_in=['X'] if amp else ())
    assert np.isnan(out_r).any()
    assert np.array_equal(out_g, out_r, equal_nan=True)
    if s >= k:
        assert np.array_equal(g_g, g_r)
    else:
        close([(g_r, g_g)], 1e-6, bf16=amp is not None)


@pytest.mark.parametrize('amp', [None, 'bf16'], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('case', [(2, True, True), (4, True, False),
                                  (1, False, True), (8, False, False)])
def test_group_norm_matches_reference(case, amp):
    """group_norm with and without Scale and Bias: the two-pass variance
    from fp32 sums; a bf16 X normalized in bf16 at the reference's
    rounding points (the op is on no AMP list). Y and the gradients of X,
    Scale and Bias."""
    groups, scale, bias = case
    rng = np.random.RandomState(groups)
    inputs = {'X': (3.0 + 2.0 * rng.randn(2, 8, 3, 5)).astype('float32')}
    if scale:
        inputs['Scale'] = rng.randn(8).astype('float32')
    if bias:
        inputs['Bias'] = rng.randn(8).astype('float32')
    pairs = run_op((jnorm._group_norm, tnorm._group_norm), 'group_norm',
                   inputs, ['Y'], dict(groups=groups, epsilon=1e-5),
                   amp=amp, grad=list(inputs),
                   bf16_in=('X',) if amp else ())
    close(pairs, 1e-5, bf16=amp is not None, grad_from=1)


@pytest.mark.parametrize('amp', [None, 'bf16'], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('axis', [1, -1, 0])
def test_norm_matches_reference(axis, amp):
    """norm: Out = x / sqrt(Σ x² + eps) along axis, and Norm. Its bf16
    gradient, g/norm - x·Σ(g·x)/norm³, is the difference of two terms as
    large as the result or larger, each rounded to bf16: held to twice
    the other ops' gradient bound."""
    rng = np.random.RandomState(axis + 5)
    x = rng.randn(3, 4, 5).astype('float32')
    pairs = run_op((jnorm._norm, tnorm._norm), 'norm', {'X': x},
                   ['Out', 'Norm'], dict(axis=axis, epsilon=1e-10),
                   amp=amp, grad=['X'], bf16_in=('X',) if amp else ())
    close(pairs, 1e-6, bf16=amp is not None, grad_from=2, grad_k=4.0)


def _build_conv_layers(pkg, h):
    """Every one of the conv path's 11 layers once or more."""
    L = pkg.layers
    img = _x(pkg, (2, 4, 8, 8), name='img')
    vol = _x(pkg, (2, 3, 4, 6, 6), name='vol')
    seq = _x(pkg, (2, 5, 6), name='seq')
    x, y = _x(pkg, (4, 7), name='x'), _x(pkg, (4, 3), name='y')
    rois = _x(pkg, (3, 5), name='rois', dtype='int64')
    L.conv3d(vol, 5, 3, padding=1, act='relu')
    L.conv3d(vol, 4, [1, 3, 3], stride=[1, 2, 2], groups=1,
             bias_attr=False)
    L.conv2d_transpose(img, 3, filter_size=4, stride=2, padding=1)
    L.conv2d_transpose(img, 2, output_size=[17, 17], stride=2,
                       act='sigmoid')
    L.group_norm(img, groups=2)
    L.group_norm(img, groups=4, param_attr=False, bias_attr=False,
                 act='relu')
    L.row_conv(seq, future_context_size=2)
    L.conv_shift(x, y)
    L.spp(img, pyramid_height=3, pool_type='avg')
    L.lrn(img, n=3, alpha=1e-3)
    L.crop(img, shape=[1, 2, 4, 4], offsets=[1, 0, 2, 2])
    L.crop(img, shape=_x(pkg, (1, 3, 5, 5), name='like'))
    L.roi_pool(img, rois, pooled_height=2, pooled_width=3,
               spatial_scale=0.5)
    pooled, mask = L.max_pool2d_with_index(img, [2, 2], strides=[2, 2])
    L.unpool(pooled, mask, [2, 2], strides=[2, 2])


def test_conv_layers_build_the_reference_program():
    """The same ops, slots, attributes, vars, shapes, parameters and
    initializers as the reference, for every one of the 11 layers."""
    _same_program(_build_conv_layers)
