"""Activation ops (reference: paddle_tpu ops/activation_ops.py; fluid's
activation_op.cc family)."""

import torch
import torch.nn.functional as F

from ..core.registry import register


def _unary(name, fn):
    @register(name)
    def _op(ctx, fn=fn):
        ctx.set_output('Out', fn(ctx.input('X'), ctx))


_unary('sigmoid', lambda x, ctx: torch.sigmoid(x))
_unary('logsigmoid', lambda x, ctx: F.logsigmoid(x))
_unary('exp', lambda x, ctx: torch.exp(x))
_unary('relu', lambda x, ctx: torch.relu(x))
_unary('tanh', lambda x, ctx: torch.tanh(x))
_unary('tanh_shrink', lambda x, ctx: x - torch.tanh(x))
_unary('sqrt', lambda x, ctx: torch.sqrt(x))
_unary('rsqrt', lambda x, ctx: torch.rsqrt(x))
_unary('abs', lambda x, ctx: torch.abs(x))
_unary('ceil', lambda x, ctx: torch.ceil(x))
_unary('floor', lambda x, ctx: torch.floor(x))
_unary('round', lambda x, ctx: torch.round(x))
_unary('reciprocal', lambda x, ctx: 1.0 / x)
_unary('log', lambda x, ctx: torch.log(x))
_unary('square', lambda x, ctx: torch.square(x))
_unary('softplus', lambda x, ctx: torch.logaddexp(x, torch.zeros_like(x)))
_unary('softsign', lambda x, ctx: F.softsign(x))
_unary('gelu', lambda x, ctx: F.gelu(x))
_unary('sign', lambda x, ctx: torch.sign(x))
_unary('sin', lambda x, ctx: torch.sin(x))
_unary('cos', lambda x, ctx: torch.cos(x))
_unary('brelu', lambda x, ctx: torch.clamp(x, ctx.attr('t_min', 0.0),
                                           ctx.attr('t_max', 24.0)))
_unary('leaky_relu', lambda x, ctx: F.leaky_relu(
    x, negative_slope=ctx.attr('alpha', 0.02)))
_unary('elu', lambda x, ctx: F.elu(x, alpha=ctx.attr('alpha', 1.0)))
_unary('relu6', lambda x, ctx: torch.clamp(x, 0.0,
                                           ctx.attr('threshold', 6.0)))
_unary('pow', lambda x, ctx: torch.pow(x, ctx.attr('factor', 1.0)))
_unary('swish', lambda x, ctx: x * torch.sigmoid(ctx.attr('beta', 1.0) * x))


@register('softmax')
def _softmax(ctx):
    ctx.set_output('Out', torch.softmax(ctx.input('X'), dim=-1))


@register('log_softmax')
def _log_softmax(ctx):
    ctx.set_output('Out', torch.log_softmax(ctx.input('X'),
                                            dim=ctx.attr('axis', -1)))
