"""The batch_norm, layer_norm, group_norm and norm ops (reference:
paddle_tpu ops/norm_ops.py; fluid's batch_norm_op.cc, layer_norm_op.cc,
group_norm_op.cc, norm_op.cc)."""

import torch

from ..core.registry import register
from .kernels.batch_norm import fused_batch_norm_train
from .kernels.layer_norm import fused_layer_norm


@register('batch_norm')
def _batch_norm(ctx):
    """Training: every shape goes through K5's autograd Function (kernel
    forward on the card); the running statistics move by ``momentum`` in
    fp32, in place (under a remat policy into new tensors). is_test: the
    running statistics in plain torch, as the JAX package does. Under
    bf16 AMP the op reads its raw bf16 X (ctx.input
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
        # the running statistics move in place where MeanOut / VarianceOut
        # name the Mean / Variance vars (the layer's layout): the scope's
        # tensors keep their address, as a captured graph needs. Under a
        # remat policy they are new tensors, which the executor copies
        # into the scope's after the step: the backward's recompute of
        # this op must not move them a second time
        for in_slot, out_slot, run, cur in (('Mean', 'MeanOut', mean,
                                             use_mean),
                                            ('Variance', 'VarianceOut',
                                             variance, use_var)):
            a, b = momentum * run, (1.0 - momentum) * cur.detach()
            if ctx.op.output(out_slot) == ctx.op.input(in_slot) and \
                    ctx.remat is None and \
                    torch.result_type(a, b) == run.dtype:
                new = torch.add(a, b, out=run)
            else:
                new = a + b
            ctx.set_output(out_slot, new)
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


def _rounded(v, dtype):
    """v's value rounded to ``dtype``, its gradient passed on in v's own
    dtype, unrounded."""
    if dtype == v.dtype:
        return v
    return v + (v.to(dtype).to(v.dtype) - v).detach()


@register('group_norm')
def _group_norm(ctx):
    """Normalization over groups of channels of an NCHW X. group_norm is
    on neither AMP list: a bf16 X is normalized at the JAX package's bf16
    rounding points (the mean and the two-pass variance from fp32 sums,
    each rounded to bf16; x - mean, var + eps, its rsqrt and the product
    each rounded to bf16), then scaled and shifted by the fp32
    parameters; the executor hands Y back to the bf16 stream. The
    gradient runs in fp32 and is rounded once, to X's dtype (the
    reference rounds its bf16 cotangents op by op: the two differ by a
    few bf16 ulps of the terms the gradient cancels)."""
    x = ctx.input('X')
    groups = ctx.attr('groups', 32)
    eps = ctx.attr('epsilon', 1e-5)
    n, c = x.shape[:2]
    spatial = tuple(x.shape[2:])
    xf = x.float().reshape((n, groups, c // groups) + spatial)
    axes = tuple(range(2, xf.dim()))
    mean32 = xf.mean(dim=axes, keepdim=True)
    var32 = (xf - mean32).square().mean(dim=axes, keepdim=True)
    mean, var = _rounded(mean32, x.dtype), _rounded(var32, x.dtype)
    inv = _rounded(torch.rsqrt(_rounded(var + eps, x.dtype)), x.dtype)
    out = _rounded(_rounded(xf - mean, x.dtype) * inv, x.dtype)
    out = out.reshape(x.shape)
    bshape = (1, c) + (1,) * len(spatial)
    if ctx.has_input('Scale'):
        out = out * ctx.input('Scale').reshape(bshape)
    if ctx.has_input('Bias'):
        out = out + ctx.input('Bias').reshape(bshape)
    ctx.set_output('Y', out if ctx.has_input('Scale') or
                   ctx.has_input('Bias') else out.to(x.dtype))


@register('norm')
def _norm(ctx):
    """x / sqrt(sum(x², axis) + epsilon), and that norm (norm_op.cc)."""
    x = ctx.input('X')
    axis = ctx.attr('axis', 1)
    eps = ctx.attr('epsilon', 1e-10)
    norm = torch.sqrt(x.square().sum(dim=axis, keepdim=True) + eps)
    ctx.set_output('Norm', norm)
    ctx.set_output('Out', x / norm)
