"""Tensor ops (reference: paddle_tpu ops/tensor_ops.py): the startup
fills, fill_constant_batch_size_like, assign, sum, concat, split, reshape,
slice, squeeze, unsqueeze, cast, transpose, one_hot, top_k, cumsum,
expand, stack, increment, the clips (clip, clip_by_norm,
global_norm_clip), gather, scatter, shape, pad, reverse and multiplex."""

import numpy as np
import torch

from ..core.dtypes import to_torch_dtype
from ..core.registry import register
from .pointwise import maximum, minimum


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


def device_constant(ctx, key, make):
    """A tensor that the op's attrs and ``key`` alone fix: made on the host
    by ``make()`` once, moved to the device once and kept by the op, so a
    captured graph holds no host-to-device copy. An op that outputs it
    hands out a copy."""
    cache = ctx.op.__dict__.setdefault('_device_values', {})
    key = (str(ctx.device),) + tuple(key)
    if key not in cache:
        cache[key] = make().to(ctx.device)
    return cache[key]


@register('assign_value')
def _assign_value(ctx):
    """The op's values, copied on the device at every run."""
    dtype = ctx.out_dtype('Out')

    def make():
        values = np.asarray(ctx.attr('values'))
        shape = ctx.attr('shape', None)
        if shape:
            values = values.reshape(shape)
        return torch.as_tensor(values).to(dtype)
    ctx.set_output('Out', device_constant(ctx, (dtype,), make).clone())


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


@register('split')
def _split(ctx):
    """Out: the pieces along ``axis``, of the sizes in ``sections`` or
    ``num`` equal pieces."""
    x = ctx.input('X')
    axis = ctx.attr('axis', 0)
    sections = ctx.attr('sections', None)
    size = list(sections) if sections else \
        x.shape[axis] // ctx.attr('num', 0)
    ctx.set_output_list('Out', torch.split(x, size, dim=axis))


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


def cast(x, dtype):
    """``x`` in ``dtype`` as XLA converts: a float to an integer type
    saturates at the type's bounds and NaN becomes 0, on the host as on
    the card (a plain ``.to()`` wraps on the host)."""
    if not x.is_floating_point() or dtype.is_floating_point or \
            dtype == torch.bool:
        return x.to(dtype)
    info = torch.iinfo(dtype)
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x.detach())
    inside = x.clamp(info.min, info.max).to(dtype)
    return torch.where(x >= float(info.max), info.max,
                       torch.where(x <= float(info.min), info.min, inside))


@register('cast')
def _cast(ctx):
    ctx.set_output('Out', cast(ctx.input('X'),
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
    index reversed in the low half, so no two keys are equal. Every NaN
    counts as the positive NaN, above +inf, as the reference's do (torch's
    cast to bfloat16 gives NaN the sign bit)."""
    f = x.float() + 0.0
    f.masked_fill_(torch.isnan(f), float('nan'))
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


@register('increment')
def _increment(ctx):
    """x + step in x's dtype (the LR schedule's step counter)."""
    x = ctx.input('X')
    step = ctx.attr('step', 1.0)
    if not x.dtype.is_floating_point:
        step = int(step)
    ctx.set_output('Out', x + step)


def clip(x, lo, hi):
    """jnp.clip: minimum(maximum(x, lo), hi), the bounds in x's dtype, so
    a value at a bound takes half the gradient as in jax (torch.clamp
    gives all of it)."""
    def bound(v):
        return torch.full((), v, dtype=x.dtype, device=x.device)
    return minimum(maximum(x, bound(lo)), bound(hi))


@register('clip')
def _clip(ctx):
    ctx.set_output('Out', clip(ctx.input('X'), ctx.attr('min'),
                               ctx.attr('max')))


@register('clip_by_norm')
def _clip_by_norm(ctx):
    """x · max_norm / ‖x‖ where ‖x‖ > max_norm, else x (a select on the
    device, no host branch)."""
    x = ctx.input('X')
    max_norm = ctx.attr('max_norm')
    norm = torch.sqrt(torch.sum(torch.square(x)))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp(norm, min=1e-12),
                        torch.ones_like(norm))
    ctx.set_output('Out', x * scale.to(x.dtype))


def global_norm_scale(grads, max_norm):
    """min(1, max_norm / max(‖grads‖, 1e-12)) as an fp32 0-dim tensor:
    each gradient's norm in fp32 (one multi-tensor launch), their squares
    summed in the order of the list."""
    norms = torch._foreach_norm([g.float() for g in grads])
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for n in norms:
        total = total + torch.square(n)
    norm = torch.sqrt(total)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


@register('global_norm_clip')
def _global_norm_clip(ctx):
    """Every gradient scaled by one global-norm factor (reference: one
    fused op where fluid's clip.py chains square and sum ops a
    gradient)."""
    grads = ctx.input_list('X')
    scale = global_norm_scale(grads, ctx.attr('max_global_norm'))
    ctx.set_output_list('Out', [g * scale.to(g.dtype) for g in grads])


@register('assign')
def _assign(ctx):
    """A copy, as the reference's immutable arrays give: the optimizer ops
    update their parameters and moments in place, so a value assigned
    from one before its update must not share its storage."""
    ctx.set_output('Out', ctx.input('X').clone())


@register('squeeze')
def _squeeze(ctx):
    """The listed axes dropped (every unit axis when none are listed)."""
    x = ctx.input('X')
    axes = ctx.attr('axes', None)
    ctx.set_output('Out', x.squeeze(tuple(axes)) if axes else x.squeeze())


def _rows(index):
    """An index of ids as int64 [n] (a [n, 1] index squeezed)."""
    if index.dim() == 2 and index.shape[1] == 1:
        index = index.squeeze(-1)
    return index.long()


@register('gather')
def _gather(ctx):
    """Rows ``Index`` of X (jnp.take along axis 0); the gradient sums into
    a row taken more than once."""
    x = ctx.input('X')
    ctx.set_output('Out', x[_rows(ctx.input('Index'))])


def scatter_rows(x, index, updates):
    """x with row index[i] replaced by updates[i]; where an id repeats, its
    last occurrence wins (what the reference gives on the host). One
    deterministic rule on the host and the card: each row's last update
    position is found by an amax scatter of the positions, then every row
    is a select between x and that update. The gradient, as jax's scatter
    rule gives it: x's rows that were replaced get none, and of the
    updates only the winning ones get their row's."""
    n_rows = x.shape[0]
    index = torch.where(index < 0, index + n_rows, index)
    pos = torch.arange(index.shape[0], device=x.device)
    last = torch.full((n_rows,), -1, dtype=torch.int64, device=x.device)
    last.scatter_reduce_(0, index, pos, reduce='amax')
    hit = (last >= 0).reshape((n_rows,) + (1,) * (x.dim() - 1))
    return torch.where(hit, updates.to(x.dtype)[last.clamp(min=0)], x)


@register('scatter')
def _scatter(ctx):
    ctx.set_output('Out', scatter_rows(ctx.input('X'),
                                       _rows(ctx.input('Ids')),
                                       ctx.input('Updates')))


@register('shape')
def _shape(ctx):
    """X's shape as int32."""
    shape = tuple(ctx.input('X').shape)
    ctx.set_output('Out', device_constant(ctx, shape, lambda: torch.tensor(
        shape, dtype=torch.int32)).clone())


@register('pad')
def _pad(ctx):
    """Constant padding from fluid's flat ``paddings`` (before, after for
    each axis in order)."""
    x = ctx.input('X')
    p = ctx.attr('paddings')
    flat = []
    for i in reversed(range(x.dim())):
        flat += [p[2 * i], p[2 * i + 1]]
    ctx.set_output('Out', torch.nn.functional.pad(
        x, flat, value=ctx.attr('pad_value', 0.0)))


@register('reverse')
def _reverse(ctx):
    axes = ctx.attr('axis')
    ctx.set_output('Out', ctx.input('X').flip(
        [axes] if isinstance(axes, int) else list(axes)))


@register('multiplex')
def _multiplex(ctx):
    """Row i of Out is row i of X[Ids[i]]."""
    stacked = torch.stack(ctx.input_list('X'))
    ids = ctx.input('Ids').reshape(-1).long()
    rows = torch.arange(ids.shape[0], device=ids.device)
    ctx.set_output('Out', stacked[ids, rows])
