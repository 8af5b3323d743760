"""The batch_norm and layer_norm ops (reference: paddle_tpu
ops/norm_ops.py; fluid's batch_norm_op.cc, layer_norm_op.cc)."""

import torch

from ..core.registry import register
from .kernels.batch_norm import fused_batch_norm_train
from .kernels.layer_norm import fused_layer_norm


@register('batch_norm')
def _batch_norm(ctx):
    """Training: every shape goes through K5's autograd Function (kernel
    forward on the card); the running statistics move by ``momentum`` in
    fp32. is_test: the running statistics in plain torch, as the JAX
    package does. Under bf16 AMP the op reads its raw bf16 X (ctx.input
    would up-cast it: batch_norm is blacklisted) and normalizes in bf16,
    y = x·a + b with a and b rounded to bf16, as the JAX package does."""
    raw_x = ctx.env[ctx.op.input('X')]
    bf16 = ctx.amp == 'bf16' and raw_x.dtype == torch.bfloat16
    x = raw_x if bf16 else ctx.input('X')
    scale = ctx.input('Scale')
    bias = ctx.input('Bias')
    mean = ctx.input('Mean')
    variance = ctx.input('Variance')
    momentum = ctx.attr('momentum', 0.9)
    eps = ctx.attr('epsilon', 1e-5)
    layout = ctx.attr('data_layout', 'NCHW')
    if not (ctx.attr('is_test', False) or ctx.is_test):
        out, use_mean, use_var = fused_batch_norm_train(
            x, scale, bias, eps, layout=layout if x.dim() == 4 else 'NC')
        ctx.set_output('MeanOut', (momentum * mean + (1.0 - momentum) *
                                   use_mean).detach())
        ctx.set_output('VarianceOut', (momentum * variance + (1.0 - momentum)
                                       * use_var).detach())
        ctx.set_output('SavedMean', use_mean.detach())
        ctx.set_output('SavedVariance', use_var.detach())
        ctx.set_output('Y', out)
        return
    if x.dim() == 4:
        bshape = (1, -1, 1, 1) if layout == 'NCHW' else (1, 1, 1, -1)
    else:
        bshape = (1, -1)
    inv = torch.rsqrt(variance.reshape(bshape) + eps)
    if bf16:
        a = scale.reshape(bshape) * inv
        b = bias.reshape(bshape) - mean.reshape(bshape) * a
        out = x * a.to(x.dtype) + b.to(x.dtype)
    else:
        out = (x - mean.reshape(bshape)) * inv * scale.reshape(bshape) + \
            bias.reshape(bshape)
    ctx.set_output('Y', out)


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
