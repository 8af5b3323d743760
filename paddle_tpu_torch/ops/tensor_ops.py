"""Tensor ops (reference: paddle_tpu ops/tensor_ops.py): the startup
fills, fill_constant_batch_size_like, sum, concat, reshape, slice,
unsqueeze, cast, transpose, one_hot, top_k, cumsum, expand and stack."""

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


@register('fill_constant_batch_size_like')
def _fill_constant_bsl(ctx):
    shape = [int(s) for s in ctx.attr('shape')]
    shape[ctx.attr('output_dim_idx', 0)] = \
        ctx.input('Input').shape[ctx.attr('input_dim_idx', 0)]
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


@register('concat')
def _concat(ctx):
    ctx.set_output('Out', torch.cat(ctx.input_list('X'),
                                    dim=ctx.attr('axis', 0)))


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


@register('one_hot')
def _one_hot(ctx):
    x = ctx.input('X')
    if x.dim() >= 2 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    ctx.set_output('Out', torch.nn.functional.one_hot(
        x.long(), ctx.attr('depth')).to(ctx.out_dtype('Out')))


def top_k(x, k):
    """(values, int64 indices) of the k largest entries along the last
    axis, in ``lax.top_k``'s order: larger value first and, on a tie, the
    lower index first (torch.topk fixes no order among ties). One
    torch.topk over an exact int64 key: the value's fp32 bits mapped to
    an order-preserving int32 (-0.0 taken as +0.0) in the high half, the
    index reversed in the low half, so no two keys are equal."""
    f = x.float() + 0.0
    bits = f.view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7fffffff, bits).to(torch.int64)
    n = x.shape[-1]
    rev = (n - 1) - torch.arange(n, dtype=torch.int64, device=x.device)
    _, indices = torch.topk(ordered * (1 << 32) + rev, k, dim=-1)
    return x.gather(-1, indices), indices


@register('top_k')
def _top_k(ctx):
    """Values and indices of the k largest along the last axis, in
    descending order with ties to the lower index; the indices are int64,
    as the IR declares them."""
    values, indices = top_k(ctx.input('X'), ctx.attr('k', 1))
    ctx.set_output('Out', values)
    ctx.set_output('Indices', indices)


@register('cumsum')
def _cumsum(ctx):
    x = ctx.input('X')
    axis = ctx.attr('axis', -1)
    if ctx.attr('reverse', False):
        x = x.flip(axis)
    out = torch.cumsum(x, dim=axis).to(x.dtype)
    if ctx.attr('exclusive', False):
        out = out - x
    if ctx.attr('reverse', False):
        out = out.flip(axis)
    ctx.set_output('Out', out)


@register('expand')
def _expand(ctx):
    ctx.set_output('Out', ctx.input('X').repeat(*ctx.attr('expand_times')))


@register('stack')
def _stack(ctx):
    ctx.set_output('Out', torch.stack(ctx.input_list('X'),
                                      dim=ctx.attr('axis', 0)))
