"""Activation ops (reference: paddle_tpu ops/activation_ops.py; fluid's
activation_op.cc family). Each is the JAX lowering's expression, so the
edge values agree too: sign keeps NaN, gelu is jax.nn.gelu's exact form,
pow follows C pow at +-inf (ops/pointwise.py gives it and abs jax's
gradients), the clips split a tie's gradient in halves as jnp.clip does,
and leaky_relu passes the gradient at 0."""

import math

import torch
import torch.nn.functional as F

from ..core.registry import register
from . import pointwise
from .tensor_ops import clip


def _unary(name, fn, fused=False):
    """Registers ``name`` as Out = fn(x, ctx, c), c(v) a constant rounded
    to x's dtype first, as jax rounds a weakly typed Python scalar. On a
    bf16 or fp16 x a ``fused`` expression (several ops, so several
    roundings) runs in fp32, its gradient too, and rounds once, as XLA
    computes a fused expression of a narrow dtype; any other runs in x's
    dtype, as one torch kernel already computes in fp32 and rounds once."""
    @register(name)
    def _op(ctx, fn=fn):
        x = ctx.input('X')
        c = _Narrow(x.dtype)
        if fused and c.narrow:
            out = fn(x.float(), ctx, c).to(x.dtype)
        else:
            out = fn(x, ctx, c)
        ctx.set_output('Out', out)


class _Narrow(object):
    """x's dtype inside a unary op's function: c(v) rounds a constant to
    it, c.round(t) a tensor (kept in t's dtype); ``narrow``: bf16 or
    fp16."""

    def __init__(self, dtype):
        self.dtype = dtype
        self.narrow = dtype in (torch.bfloat16, torch.float16)

    def __call__(self, v):
        return float(torch.tensor(v, dtype=self.dtype)) if self.narrow \
            else float(v)

    def round(self, t):
        return t.to(self.dtype).to(t.dtype) if self.narrow else t


def _softplus(x):
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _sign(x):
    """jnp.sign: NaN stays NaN (torch.sign gives 0); zero gradient."""
    return torch.where(torch.isnan(x), x.detach(), torch.sign(x))


def _gelu(x, c):
    """jax.nn.gelu(approximate=False): 0.5 * x * erfc(-x * sqrt(1/2)), the
    constant rounded to the input's dtype (F.gelu gives NaN at +inf)."""
    return 0.5 * x * torch.erfc(-x * c(math.sqrt(0.5)))


def _softshrink(x, lam):
    return torch.where(x > lam, x - lam, torch.where(
        x < -lam, x + lam, torch.zeros_like(x)))


def _full(x, v):
    return torch.full((), v, dtype=x.dtype, device=x.device)


def _hard_sigmoid(x, slope, offset, c):
    """clip(slope * x + offset, 0, 1), the linear part rounded where XLA
    rounds it: once (a fused multiply-add) at fp32, after the product and
    after the sum in a narrow dtype; so a value at a bound takes the same
    side of it, and the same gradient."""
    if not c.narrow:
        lin = torch.addcmul(_full(x, offset), x, _full(x, slope))
    else:
        lin = c.round(c.round(slope * x) + offset)
    return clip(lin, 0.0, 1.0)


_unary('relu', lambda x, ctx, c: pointwise.relu(x))
_unary('abs', lambda x, ctx, c: pointwise.abs(x))
_unary('ceil', lambda x, ctx, c: torch.ceil(x))
_unary('floor', lambda x, ctx, c: torch.floor(x))
_unary('round', lambda x, ctx, c: torch.round(x))
_unary('sign', lambda x, ctx, c: _sign(x))

_unary('sigmoid', lambda x, ctx, c: torch.sigmoid(x))
_unary('logsigmoid', lambda x, ctx, c: F.logsigmoid(x))
_unary('exp', lambda x, ctx, c: torch.exp(x))
_unary('tanh', lambda x, ctx, c: torch.tanh(x))
_unary('tanh_shrink', lambda x, ctx, c: x - torch.tanh(x), fused=True)
_unary('sqrt', lambda x, ctx, c: torch.sqrt(x))
_unary('rsqrt', lambda x, ctx, c: pointwise.rsqrt(x))
_unary('reciprocal', lambda x, ctx, c: 1.0 / x)
_unary('log', lambda x, ctx, c: torch.log(x))
_unary('square', lambda x, ctx, c: torch.square(x))
_unary('softplus', lambda x, ctx, c: _softplus(x))
_unary('softsign', lambda x, ctx, c: x / (1.0 + torch.abs(x)), fused=True)
_unary('gelu', lambda x, ctx, c: _gelu(x, c), fused=True)
_unary('sin', lambda x, ctx, c: torch.sin(x))
_unary('cos', lambda x, ctx, c: torch.cos(x))
_unary('elu', lambda x, ctx, c: F.elu(x, alpha=c(ctx.attr('alpha', 1.0))),
       fused=True)
_unary('brelu', lambda x, ctx, c: clip(x, c(ctx.attr('t_min', 0.0)),
                                       c(ctx.attr('t_max', 24.0))))
_unary('leaky_relu', lambda x, ctx, c: torch.where(
    x >= 0, x, c(ctx.attr('alpha', 0.02)) * x))
_unary('soft_relu', lambda x, ctx, c: torch.log1p(torch.exp(clip(
    x, -c(ctx.attr('threshold', 40.0)), c(ctx.attr('threshold', 40.0))))),
       fused=True)
_unary('relu6', lambda x, ctx, c: clip(x, 0.0,
                                       c(ctx.attr('threshold', 6.0))))
_unary('pow', lambda x, ctx, c: pointwise.pow(
    x, _full(x, c(ctx.attr('factor', 1.0)))))
_unary('stanh', lambda x, ctx, c: c(ctx.attr('scale_b', 1.7159)) *
       torch.tanh(c(ctx.attr('scale_a', 2.0 / 3.0)) * x), fused=True)
_unary('hard_shrink', lambda x, ctx, c: torch.where(
    torch.abs(x) > c(ctx.attr('threshold', 0.5)), x, torch.zeros_like(x)))
_unary('softshrink', lambda x, ctx, c: _softshrink(
    x, c(ctx.attr('lambda', 0.5))))
_unary('thresholded_relu', lambda x, ctx, c: torch.where(
    x > c(ctx.attr('threshold', 1.0)), x, torch.zeros_like(x)))
_unary('hard_sigmoid', lambda x, ctx, c: _hard_sigmoid(
    x, c(ctx.attr('slope', 0.2)), c(ctx.attr('offset', 0.5)), c),
       fused=True)
_unary('swish', lambda x, ctx, c: x * torch.sigmoid(
    c(ctx.attr('beta', 1.0)) * x), fused=True)
_unary('mish', lambda x, ctx, c: x * torch.tanh(_softplus(x)), fused=True)


@register('softmax')
def _softmax(ctx):
    ctx.set_output('Out', torch.softmax(ctx.input('X'), dim=-1))


@register('log_softmax')
def _log_softmax(ctx):
    ctx.set_output('Out', torch.log_softmax(ctx.input('X'),
                                            dim=ctx.attr('axis', -1)))


@register('prelu')
def _prelu(ctx):
    """where(x > 0, x, alpha * x); alpha is one value ('all'), one a
    channel of an NC... layout ('channel') or one an element of a row
    ('element')."""
    x = ctx.input('X')
    alpha = ctx.input('Alpha')
    mode = ctx.attr('mode', 'all')
    if mode == 'channel':
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    elif mode == 'element':
        alpha = alpha.reshape((1,) + tuple(x.shape[1:]))
    ctx.set_output('Out', torch.where(x > 0, x, alpha * x))
