"""The layer_norm op (reference: paddle_tpu ops/norm_ops.py; fluid's
layer_norm_op.cc)."""

import torch

from ..core.registry import register
from .kernels.layer_norm import fused_layer_norm


@register('layer_norm')
def _layer_norm(ctx):
    """With Scale and Bias, every shape goes through K1's autograd
    Function (kernel forward on the card). Mean and Variance are computed
    only when something reads them."""
    x = ctx.input('X')
    begin = ctx.attr('begin_norm_axis', 1)
    eps = ctx.attr('epsilon', 1e-5)
    axes = tuple(range(begin, x.dim()))
    if ctx.has_input('Scale') and ctx.has_input('Bias'):
        out = fused_layer_norm(x, ctx.input('Scale'), ctx.input('Bias'),
                               eps=eps, begin_norm_axis=begin)
    else:
        mean = x.mean(dim=axes, keepdim=True)
        var = x.var(dim=axes, unbiased=False, keepdim=True)
        out = (x - mean) * torch.rsqrt(var + eps)
        norm_shape = x.shape[begin:]
        if ctx.has_input('Scale'):
            out = out * ctx.input('Scale').reshape(norm_shape)
        if ctx.has_input('Bias'):
            out = out + ctx.input('Bias').reshape(norm_shape)
    if ctx.output_read('Mean'):
        ctx.set_output('Mean', x.mean(dim=axes))
    if ctx.output_read('Variance'):
        ctx.set_output('Variance', x.var(dim=axes, unbiased=False))
    ctx.set_output('Y', out)
