"""Convolution and pooling ops: conv2d and pool2d (reference: paddle_tpu
ops/conv_ops.py; fluid's conv_op.cc, pool_op.cc).

A convolution goes to ``torch.nn.functional.conv2d`` (cuDNN on the card),
as the JAX package leaves it to XLA's ``conv_general_dilated``. In NHWC the
IR tensor is [N, H, W, C]: the op hands cuDNN its [N, C, H, W] view, which
has channels-last strides, with the filter laid out channels-last too, and
permutes the output back, so a channels-last network moves no activation
between layouts.
"""

import torch
import torch.nn.functional as F

from ..core.registry import register


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
    if not (eh or ew or ph > kh // 2 or pw > kw // 2):
        # torch's own padding is the same: -inf for max; for avg,
        # count_include_pad=False counts the real elements
        if pooling_type == 'max':
            return F.max_pool2d(x4, (kh, kw), (sh, sw), (ph, pw))
        return F.avg_pool2d(x4, (kh, kw), (sh, sw), (ph, pw),
                            count_include_pad=not exclusive)
    pad = (pw, pw + ew, ph, ph + eh)
    if pooling_type == 'max':
        return F.max_pool2d(F.pad(x4, pad, value=float('-inf')), (kh, kw),
                            (sh, sw))
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
