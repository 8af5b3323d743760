"""Tensor ops (reference: paddle_tpu ops/tensor_ops.py): the startup
fills, and sum, reshape, slice, unsqueeze, cast, transpose and top_k."""

import numpy as np
import torch

from ..core.dtypes import to_torch_dtype
from ..core.registry import register


@register('fill_constant')
def _fill_constant(ctx):
    shape = [int(s) for s in ctx.attr('shape')]
    ctx.set_output('Out', torch.full(shape, ctx.attr('value', 0.0),
                                     dtype=ctx.out_dtype('Out'),
                                     device=ctx.device))


@register('assign_value')
def _assign_value(ctx):
    """The op's values moved to the device once (the op keeps that tensor)
    and copied on the device at every run, so a captured graph holds no
    host-to-device copy."""
    dtype = ctx.out_dtype('Out')
    cache = ctx.op.__dict__.setdefault('_device_values', {})
    key = (str(ctx.device), dtype)
    if key not in cache:
        values = np.asarray(ctx.attr('values'))
        shape = ctx.attr('shape', None)
        if shape:
            values = values.reshape(shape)
        cache[key] = torch.as_tensor(values).to(device=ctx.device,
                                                dtype=dtype)
    ctx.set_output('Out', cache[key].clone())


@register('sum')
def _sum(ctx):
    xs = ctx.input_list('X')
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    ctx.set_output('Out', out)


@register('reshape')
def _reshape(ctx):
    """fluid semantics: 0 copies the input's dim, -1 is inferred."""
    x = ctx.input('X')
    shape = [x.shape[i] if s == 0 else s
             for i, s in enumerate(ctx.attr('shape'))]
    ctx.set_output('Out', x.reshape(shape))


@register('slice')
def _slice(ctx):
    # the reference slice_op names its input slot 'Input'
    x = ctx.input('Input') if ctx.has_input('Input') else ctx.input('X')
    idx = [slice(None)] * x.dim()
    for ax, st, en in zip(ctx.attr('axes'), ctx.attr('starts'),
                          ctx.attr('ends')):
        idx[ax] = slice(st, en)
    ctx.set_output('Out', x[tuple(idx)])


@register('unsqueeze')
def _unsqueeze(ctx):
    x = ctx.input('X')
    for ax in sorted(ctx.attr('axes')):
        x = x.unsqueeze(ax)
    ctx.set_output('Out', x)


@register('cast')
def _cast(ctx):
    ctx.set_output('Out', ctx.input('X').to(
        to_torch_dtype(ctx.attr('out_dtype'))))


@register('transpose')
def _transpose(ctx):
    """A view: the ops that read it take its strides as they are."""
    ctx.set_output('Out', ctx.input('X').permute(*ctx.attr('axis')))


@register('top_k')
def _top_k(ctx):
    """Values and indices of the k largest along the last axis, in
    descending order; the indices are int64, as the IR declares them."""
    values, indices = torch.topk(ctx.input('X'), ctx.attr('k', 1), dim=-1)
    ctx.set_output('Out', values)
    ctx.set_output('Indices', indices)
