"""Math ops the training path runs: mul, matmul, elementwise, scale,
reduce_sum, mean (reference: paddle_tpu ops/math_ops.py; fluid's
mul_op, matmul_op, elementwise_*_op, scale_op, reduce_op, mean_op).

A plain matrix product goes to ``torch.matmul``, as the JAX package leaves
it to XLA.
"""

import torch

from ..core.registry import register


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


@register('reduce_sum')
def _reduce_sum(ctx):
    x = ctx.input('X')
    keep = ctx.attr('keep_dim', False)
    if ctx.attr('reduce_all', False):
        out = x.sum()
        if keep:
            out = out.reshape((1,) * x.dim())
    else:
        dim = ctx.attr('dim', [0])
        if isinstance(dim, int):
            dim = [dim]
        out = x.sum(dim=tuple(d % x.dim() for d in dim), keepdim=keep)
    ctx.set_output('Out', out)


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
