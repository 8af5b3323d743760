"""Math ops: mul, matmul, elementwise, reductions, scale, mean, the
comparisons and logical ops, cos_sim, dot, minus and the norms
(reference: paddle_tpu ops/math_ops.py; fluid's mul_op, matmul_op,
elementwise_*_op, reduce_op, scale_op, mean_op, compare_op, logical_op,
cos_sim_op, dot_op, minus_op, l1_norm_op, squared_l2_norm_op,
squared_l2_distance_op).

A plain matrix product goes to ``torch.matmul``, as the JAX package leaves
it to XLA.
"""

import torch

from ..core.registry import register
from . import pointwise


def _flatten_2d(x, num_col_dims):
    lead = 1
    for s in x.shape[:num_col_dims]:
        lead *= s
    return x.reshape(lead, -1)


@register('mul')
def _mul(ctx):
    """out = flatten(x) @ flatten(y) (reference mul_op.cc:24)."""
    x = ctx.input('X')
    y = ctx.input('Y')
    xd = ctx.attr('x_num_col_dims', 1)
    yd = ctx.attr('y_num_col_dims', 1)
    out = torch.matmul(_flatten_2d(x, xd), _flatten_2d(y, yd))
    ctx.set_output('Out', out.reshape(tuple(x.shape[:xd]) +
                                      tuple(y.shape[yd:])))


@register('matmul')
def _matmul(ctx):
    x = ctx.input('X')
    y = ctx.input('Y')
    if ctx.attr('transpose_X', False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if ctx.attr('transpose_Y', False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = ctx.attr('alpha', 1.0)
    if alpha != 1.0:
        out = out * alpha
    ctx.set_output('Out', out)


def _broadcast_y(x, y, axis):
    """Fluid elementwise broadcast: align y's dims to x starting at
    ``axis`` (-1: at the trailing dims)."""
    if x.shape == y.shape:
        return y
    if axis == -1 or axis is None:
        axis = x.dim() - y.dim()
    return y.reshape([1] * axis + list(y.shape) +
                     [1] * (x.dim() - axis - y.dim()))


def _promoted(x, y):
    """Both operands at their promoted dtype. Explicit, because torch
    lets a 0-dim tensor take the other operand's narrower float dtype
    where jnp promotes (a 0-dim fp32 times a bf16 tensor is fp32 in jnp,
    bf16 in torch)."""
    dtype = torch.promote_types(x.dtype, y.dtype)
    return x.to(dtype), y.to(dtype)


def _register_elementwise(name, fn):
    @register('elementwise_' + name)
    def _op(ctx, fn=fn):
        x = ctx.input('X')
        y = _broadcast_y(x, ctx.input('Y'), ctx.attr('axis', -1))
        ctx.set_output('Out', fn(*_promoted(x, y)))


_register_elementwise('add', torch.add)
_register_elementwise('sub', torch.sub)
_register_elementwise('mul', torch.mul)
_register_elementwise('div', torch.div)
# jnp's gradients: a tie's split in halves, none where the result is NaN
_register_elementwise('max', pointwise.maximum)
_register_elementwise('min', pointwise.minimum)
_register_elementwise('pow', pointwise.pow)
# jnp.mod is the floor modulo (the result takes the divisor's sign)
_register_elementwise('mod', pointwise.remainder)
_register_elementwise('floordiv', pointwise.floor_divide)


def _register_reduce(name, fn):
    """reduce_<name> over ``dim`` (an int or a list; default [0]) or, with
    ``reduce_all``, over every axis; ``keep_dim`` keeps the reduced axes
    as 1s. ``fn(x, dim, keepdim)`` reduces every axis where dim is
    None."""
    @register('reduce_' + name)
    def _op(ctx, fn=fn):
        x = ctx.input('X')
        keep = ctx.attr('keep_dim', False)
        if ctx.attr('reduce_all', False):
            out = fn(x, None, False)
            if keep:
                out = out.reshape((1,) * x.dim())
        else:
            dim = ctx.attr('dim', [0])
            if isinstance(dim, int):
                dim = [dim]
            out = fn(x, tuple(d % x.dim() for d in dim), keep)
        ctx.set_output('Out', out)


def _reducer(fn):
    return lambda x, dim, keep: fn(x) if dim is None else \
        fn(x, dim=dim, keepdim=keep)


_register_reduce('sum', _reducer(torch.sum))
_register_reduce('mean', _reducer(torch.mean))
# a tie's gradient shared evenly among the ties, as jax.grad of jnp.max
# does (torch.max(dim) gives all of it to one index)
_register_reduce('max', pointwise.amax)
_register_reduce('min', pointwise.amin)
_register_reduce('prod', pointwise.prod)


@register('mean')
def _mean(ctx):
    """Scalar mean, shaped [1] like the reference LoDTensor."""
    ctx.set_output('Out', ctx.input('X').mean().reshape(1))


@register('scale')
def _scale(ctx):
    x = ctx.input('X')
    scale = ctx.attr('scale', 1.0)
    bias = ctx.attr('bias', 0.0)
    if ctx.attr('bias_after_scale', True):
        out = x * scale + bias
    else:
        out = (x + bias) * scale
    ctx.set_output('Out', out.to(x.dtype))


@register('cos_sim')
def _cos_sim(ctx):
    """Row-wise cosine similarity over the last axis, with the reference's
    1e-12 in the denominator (paddle_tpu ops/math_ops.py cos_sim); XNorm
    and YNorm are the rows' L2 norms."""
    x = ctx.input('X')
    y = ctx.input('Y')
    xn = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True))
    out = torch.sum(x * y, dim=-1, keepdim=True) / (xn * yn + 1e-12)
    ctx.set_output('Out', out)
    ctx.set_output('XNorm', xn)
    ctx.set_output('YNorm', yn)


def _register_compare(name, fn):
    @register(name)
    def _op(ctx, fn=fn):
        ctx.set_output('Out', fn(ctx.input('X'), ctx.input('Y')))


_register_compare('less_than', torch.lt)
_register_compare('less_equal', torch.le)
_register_compare('greater_than', torch.gt)
_register_compare('greater_equal', torch.ge)
_register_compare('equal', torch.eq)
_register_compare('not_equal', torch.ne)


def _register_logical(name, fn, unary=False):
    @register('logical_' + name)
    def _op(ctx, fn=fn, unary=unary):
        x = ctx.input('X')
        ctx.set_output('Out', fn(x) if unary else fn(x, ctx.input('Y')))


_register_logical('and', torch.logical_and)
_register_logical('or', torch.logical_or)
_register_logical('xor', torch.logical_xor)
_register_logical('not', torch.logical_not, unary=True)


@register('dot')
def _dot(ctx):
    """Row-wise dot product over the last axis, kept as a size-1 axis."""
    x = ctx.input('X')
    y = ctx.input('Y')
    ctx.set_output('Out', torch.sum(x * y, dim=-1, keepdim=True))


@register('l1_norm')
def _l1_norm(ctx):
    """sum(|x|) over every element, shaped [1]."""
    ctx.set_output('Out', pointwise.abs(ctx.input('X')).sum().reshape(1))


@register('squared_l2_norm')
def _squared_l2_norm(ctx):
    """sum(x^2) over every element, shaped [1]."""
    ctx.set_output('Out', torch.square(ctx.input('X')).sum().reshape(1))


@register('squared_l2_distance')
def _squared_l2_distance(ctx):
    """Row-wise sum((x - y)^2), kept as a size-1 axis; Y may be one row
    broadcast over X's batch. sub_result is x - y."""
    sub = ctx.input('X') - ctx.input('Y')
    ctx.set_output('sub_result', sub)
    ctx.set_output('Out', torch.square(sub).sum(-1, keepdim=True))


@register('minus')
def _minus(ctx):
    ctx.set_output('Out', ctx.input('X') - ctx.input('Y'))
