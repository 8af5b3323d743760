"""Sequence ops over padded [B, T, ...] batches with an optional int
``Length`` [B] (reference: paddle_tpu ops/sequence_ops.py; fluid's
sequence_*_op over LoD tensors). Every shape is static: masks take the
place of the LoD bookkeeping, so a captured step holds them as they are.
"""

import torch

from ..core.registry import register
from . import pointwise
from .tensor_ops import top_k

_NEG = -1e9


def _mask(lengths, max_len, dtype):
    """[B, T] in ``dtype``: 1 below each row's length, else 0."""
    pos = torch.arange(max_len, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).to(dtype)


@register('sequence_pool')
def _sequence_pool(ctx):
    """X [B, T, D] -> [B, D]: AVERAGE (or AVG), SUM, SQRT (the sum over
    sqrt(length)), MAX (padding at -1e9, which a length-0 row returns; ties
    share the gradient, as jnp.max's do), FIRST, LAST (position
    max(length - 1, 0))."""
    x = ctx.input('X')
    pool = ctx.attr('pooltype', 'AVERAGE').upper()
    b, t = x.shape[0], x.shape[1]
    if ctx.has_input('Length'):
        lengths = ctx.input('Length').reshape(-1)
        m = _mask(lengths, t, x.dtype)[..., None]
    else:
        lengths = torch.full((b,), t, dtype=torch.int32, device=x.device)
        m = torch.ones((b, t, 1), dtype=x.dtype, device=x.device)
    if pool == 'AVG':
        pool = 'AVERAGE'
    count = torch.clamp(lengths[:, None].to(x.dtype), min=1)
    if pool == 'AVERAGE':
        out = torch.sum(x * m, 1) / count
    elif pool == 'SUM':
        out = torch.sum(x * m, 1)
    elif pool == 'SQRT':
        out = torch.sum(x * m, 1) / torch.sqrt(count)
    elif pool == 'MAX':
        neg = torch.full((), _NEG, dtype=x.dtype, device=x.device)
        out = pointwise.amax(torch.where(m > 0, x, neg), (1,))
    elif pool == 'FIRST':
        out = x[:, 0]
    elif pool == 'LAST':
        idx = torch.clamp(lengths.long() - 1, min=0)
        idx = idx.reshape((b, 1) + (1,) * (x.dim() - 2)).expand(
            (b, 1) + tuple(x.shape[2:]))
        out = x.gather(1, idx).squeeze(1)
    else:
        raise NotImplementedError('sequence_pool type %r' % pool)
    ctx.set_output('Out', out)


@register('sequence_softmax')
def _sequence_softmax(ctx):
    """Softmax over T of X [B, T], the positions past each row's length
    at -1e9 first."""
    x = ctx.input('X')
    if ctx.has_input('Length'):
        m = _mask(ctx.input('Length').reshape(-1), x.shape[1], x.dtype)
        x = torch.where(m > 0, x, torch.full((), _NEG, dtype=x.dtype,
                                             device=x.device))
    ctx.set_output('Out', torch.softmax(x, -1))


@register('sequence_expand')
def _sequence_expand(ctx):
    """X [B, D] repeated over Y's time axis: [B, T, D]."""
    x = ctx.input('X')
    t = ctx.input('Y').shape[1]
    ctx.set_output('Out', x[:, None, :].expand(x.shape[0], t, x.shape[-1]))


@register('sequence_reshape')
def _sequence_reshape(ctx):
    x = ctx.input('X')
    ctx.set_output('Out', x.reshape(x.shape[0], -1, ctx.attr('new_dim')))


@register('sequence_concat')
def _sequence_concat(ctx):
    ctx.set_output('Out', torch.cat(ctx.input_list('X'), 1))


@register('sequence_slice')
def _sequence_slice(ctx):
    """``length`` positions from ``offset`` along T; the start is clamped
    so the slice fits, as lax.dynamic_slice_in_dim clamps it."""
    x = ctx.input('X')
    length = ctx.attr('length')
    start = min(max(ctx.attr('offset', 0), 0), x.shape[1] - length)
    ctx.set_output('Out', x[:, start:start + length])


@register('sequence_conv')
def _sequence_conv(ctx):
    """The context-window convolution over T (sequence_conv_op.cc): the
    window's shifted copies of X [B, T, D] (zeros past either end)
    side by side, [B, T, contextLength * D], times Filter
    [contextLength * D, out]."""
    x = ctx.input('X')
    w = ctx.input('Filter')
    ctx_len = ctx.attr('contextLength', 3)
    ctx_start = ctx.attr('contextStart', -(ctx_len // 2))
    b, t, d = x.shape
    cols = []
    for i in range(ctx_len):
        shift = ctx_start + i
        if shift < 0:
            cols.append(torch.cat([x.new_zeros((b, -shift, d)),
                                   x[:, :t + shift]], 1))
        elif shift > 0:
            cols.append(torch.cat([x[:, shift:], x.new_zeros((b, shift, d))],
                                  1))
        else:
            cols.append(x)
    ctx.set_output('Out', torch.matmul(torch.cat(cols, -1), w))


@register('sequence_erase')
def _sequence_erase(ctx):
    """Each of ``tokens`` set to 0 in place (removing them would change the
    shape)."""
    x = ctx.input('X')
    keep = torch.ones_like(x, dtype=torch.bool)
    for tok in ctx.attr('tokens', []):
        keep = keep & (x != tok)
    ctx.set_output('Out', torch.where(keep, x, torch.zeros_like(x)))


@register('kmax_seq_score')
def _kmax_seq_score(ctx):
    """Indices of the ``beam_size`` largest scores along T of X [B, T]
    (fp32), positions past each row's Length at -1e9 first; ties in
    lax.top_k's order."""
    x = ctx.input('X').float()
    if ctx.has_input('Length'):
        alive = _mask(ctx.input('Length').reshape(-1), x.shape[1],
                      torch.bool)
        x = torch.where(alive, x, torch.full((), _NEG, device=x.device))
    _, idx = top_k(x, ctx.attr('beam_size', 1))
    ctx.set_output('Out', idx.to(ctx.out_dtype('Out', 'int64')))
