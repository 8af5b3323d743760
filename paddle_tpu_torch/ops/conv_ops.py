"""Convolution and pooling ops: conv2d, conv2d_transpose, conv3d, pool2d,
row_conv, conv_shift and spp (reference: paddle_tpu ops/conv_ops.py;
fluid's conv_op.cc, conv_transpose_op.cc, pool_op.cc, row_conv_op.cc,
conv_shift_op.cc, spp_op.cc).

A convolution goes to ``torch.nn.functional.conv2d`` / ``conv_transpose2d``
/ ``conv3d`` (cuDNN on the card), as the JAX package leaves it to XLA's
``conv_general_dilated``. In NHWC the
IR tensor is [N, H, W, C]: the op hands cuDNN its [N, C, H, W] view, which
has channels-last strides, with the filter laid out channels-last too, and
permutes the output back, so a channels-last network moves no activation
between layouts.
"""

import torch
import torch.nn.functional as F

from ..core.registry import register
from .kernels.max_pool import max_pool_bwd, max_pool_fwd
from .kernels.max_pool import memory_format as layout_of


def _operand(ctx, value, memory_format):
    """``value`` under conv2d's AMP rule (whitelisted: fp32 becomes bf16)
    in ``memory_format``: the cast and the layout change are one copy, and
    none when the tensor already is both."""
    dtype = torch.bfloat16 if (ctx.amp == 'bf16' and
                               value.dtype == torch.float32) else value.dtype
    return value.to(dtype=dtype, memory_format=memory_format)


@register('conv2d')
def _conv2d(ctx):
    nhwc = ctx.attr('data_format', 'NCHW') == 'NHWC'
    fmt = torch.channels_last if nhwc else torch.contiguous_format
    x = ctx.env[ctx.op.input('Input')]
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    x = _operand(ctx, x, fmt)
    w = _operand(ctx, ctx.env[ctx.op.input('Filter')], fmt)   # OIHW
    pads = list(ctx.attr('paddings', [0, 0]))
    if len(pads) == 4 and (pads[0] != pads[1] or pads[2] != pads[3]):
        # (top, bottom, left, right): pad explicitly, then no conv padding
        x = F.pad(x, (pads[2], pads[3], pads[0], pads[1]))
        pads = [0, 0]
    elif len(pads) == 4:
        pads = [pads[0], pads[2]]
    out = F.conv2d(x, w, None, tuple(ctx.attr('strides', [1, 1])),
                   tuple(pads), tuple(ctx.attr('dilations', [1, 1])),
                   ctx.attr('groups', 1))
    ctx.set_output('Output', out.permute(0, 2, 3, 1) if nhwc else out)


@register('conv2d_transpose')
def _conv2d_transpose(ctx):
    """The fractionally strided convolution of an NCHW Input; the filter
    is [Cin, Cout/groups, kh, kw], F.conv_transpose2d's own layout, and
    the output extent (in - 1)·stride - 2·pad + dilation·(k - 1) + 1
    (no output padding). Whitelisted under AMP, as conv2d."""
    x = _operand(ctx, ctx.env[ctx.op.input('Input')], torch.contiguous_format)
    w = _operand(ctx, ctx.env[ctx.op.input('Filter')],
                 torch.contiguous_format)
    out = F.conv_transpose2d(x, w, None, tuple(ctx.attr('strides', [1, 1])),
                             tuple(ctx.attr('paddings', [0, 0])), 0,
                             ctx.attr('groups', 1),
                             tuple(ctx.attr('dilations', [1, 1])))
    ctx.set_output('Output', out)


@register('conv3d')
def _conv3d(ctx):
    """NCDHW Input, OIDHW Filter (conv3d is on no AMP list: it runs in the
    dtype it is given)."""
    out = F.conv3d(ctx.input('Input'), ctx.input('Filter'), None,
                   tuple(ctx.attr('strides', [1, 1, 1])),
                   tuple(ctx.attr('paddings', [0, 0, 0])),
                   tuple(ctx.attr('dilations', [1, 1, 1])),
                   ctx.attr('groups', 1))
    ctx.set_output('Output', out)


@register('row_conv')
def _row_conv(ctx):
    """The lookahead convolution of a padded [batch, seq, dim] X:
    out[t] = sum over i = 0..k-1 of w[i]·x[t + i] (x is 0 past the end),
    the taps summed in that order from 0, as the JAX package sums them.
    Whitelisted under AMP."""
    x = ctx.input('X')
    w = ctx.input('Filter')           # [k, dim]
    k, t = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, 0, k - 1))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + t, :] * w[i]
    ctx.set_output('Out', out)


@register('conv_shift')
def _conv_shift(ctx):
    """Circular convolution of X [b, m] with Y [b, n] (n odd, n <= m):
    out[i] = sum over j of x[(i + j - n//2) mod m]·y[j]."""
    x = ctx.input('X')
    y = ctx.input('Y')
    m, n = x.shape[1], y.shape[1]
    idx = (torch.arange(m, device=x.device)[:, None] +
           torch.arange(-(n // 2), n // 2 + 1, device=x.device)[None]) % m
    ctx.set_output('Out', torch.einsum('bmn,bn->bm', x[:, idx], y))


@register('spp')
def _spp(ctx):
    """Spatial pyramid pooling of an NCHW X: at level l the map pooled
    into 2^l x 2^l bins of ceil(H / 2^l) x ceil(W / 2^l) (ceil_mode), each
    level flattened, the levels concatenated."""
    x = ctx.input('X')
    pooling_type = ctx.attr('pooling_type', 'max')
    n, _, h, w = x.shape
    outs = []
    for lv in range(ctx.attr('pyramid_height', 2)):
        bins = 2 ** lv
        kh, kw = -(-h // bins), -(-w // bins)
        outs.append(pool2d(x, pooling_type, [kh, kw], [kh, kw], [0, 0],
                           False, ceil_mode=True).reshape(n, -1))
    ctx.set_output('Out', torch.cat(outs, dim=1))


class _MaxPool(torch.autograd.Function):
    """Max pooling of an [N, C, H, W] x over -inf padding ``pad`` (left,
    right, top, bottom) with the JAX package's picks: kernels.max_pool's
    forward writes y and, where x needs a gradient, the picks, which the
    backward reads in place of x; in a window holding a NaN the gradient
    goes to the first largest element after its last NaN, as
    select_and_scatter sends it, rather than to the NaN."""

    @staticmethod
    def forward(ctx, x, ksize, strides, pad):
        y, pick = max_pool_fwd(x, ksize, strides, pad,
                               picks=ctx.needs_input_grad[0])
        ctx.geometry = ksize, strides, pad, tuple(x.shape[2:]), layout_of(x)
        if pick is not None:
            ctx.save_for_backward(pick)
        return y

    @staticmethod
    def backward(ctx, g):
        pick, = ctx.saved_tensors
        return (max_pool_bwd(pick, g, *ctx.geometry), None, None, None)


def pool2d(x4, pooling_type, ksize, strides, pads, global_pooling,
           ceil_mode=False, exclusive=True):
    """Pooling of an [N, C, H, W] tensor with the JAX package's semantics:
    max over windows padded with -inf; avg as the window sum over the
    count of real (unpadded) elements when ``exclusive`` (and padding or
    ceil_mode makes windows ragged), else over kh·kw; ceil_mode adds
    bottom/right padding so ceil-division windows fit; global pooling
    reduces H and W."""
    if global_pooling:
        if pooling_type == 'max':
            return x4.amax(dim=(2, 3), keepdim=True)
        return x4.mean(dim=(2, 3), keepdim=True)
    (kh, kw), (sh, sw), (ph, pw) = ksize, strides, pads
    h, w = x4.shape[2:]
    eh = -(h + 2 * ph - kh) % sh if ceil_mode else 0
    ew = -(w + 2 * pw - kw) % sw if ceil_mode else 0
    pad = (pw, pw + ew, ph, ph + eh)
    if pooling_type == 'max':
        return _MaxPool.apply(x4, (kh, kw), (sh, sw), pad)
    if not (eh or ew or ph > kh // 2 or pw > kw // 2):
        # torch's own padding is the same: count_include_pad=False counts
        # the real elements
        return F.avg_pool2d(x4, (kh, kw), (sh, sw), (ph, pw),
                            count_include_pad=not exclusive)
    summed = F.avg_pool2d(F.pad(x4, pad), (kh, kw), (sh, sw),
                          divisor_override=1)
    if exclusive and (ph or pw or ceil_mode):
        ones = torch.ones((1, 1, h, w), dtype=x4.dtype, device=x4.device)
        counts = F.avg_pool2d(F.pad(ones, pad), (kh, kw), (sh, sw),
                              divisor_override=1)
        return summed / torch.clamp_min(counts, 1.0)
    return summed / (kh * kw)


@register('pool2d')
def _pool2d(ctx):
    x = ctx.input('X')
    nhwc = ctx.attr('data_format', 'NCHW') == 'NHWC'
    global_pooling = ctx.attr('global_pooling', False)
    out = pool2d(x.permute(0, 3, 1, 2) if nhwc else x,
                 ctx.attr('pooling_type', 'max'), ctx.attr('ksize', [2, 2]),
                 [1, 1] if global_pooling else ctx.attr('strides', [2, 2]),
                 ctx.attr('paddings', [0, 0]), global_pooling,
                 ceil_mode=ctx.attr('ceil_mode', False),
                 exclusive=ctx.attr('exclusive', True))
    ctx.set_output('Out', out.permute(0, 2, 3, 1) if nhwc else out)
