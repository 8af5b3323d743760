"""Optimizer update ops: sgd, momentum and adam (dense) and
adam_beta_pow_update (reference: paddle_tpu ops/optimizer_ops.py; fluid's
sgd_op, momentum_op, adam_op).

The executor runs them under ``torch.no_grad()`` after the gradients
exist. Each updates its Param and accumulators in place (ParamOut and the
*Out slots name the same persistable vars), so a step allocates no second
copy of the parameters or moments.
"""

import torch

from ..core.registry import register


def _lr(ctx):
    return ctx.input('LearningRate').reshape(())


def _inplace(ctx, in_slot, out_slot):
    """The tensor to update for out_slot: in_slot's own tensor when both
    slots name one var (the optimizer's layout), else a copy."""
    t = ctx.input(in_slot)
    return t if ctx.op.output(out_slot) == ctx.op.input(in_slot) \
        else t.clone()


@register('sgd')
def _sgd(ctx):
    p = _inplace(ctx, 'Param', 'ParamOut')
    p.sub_((_lr(ctx) * ctx.input('Grad')).to(p.dtype))
    ctx.set_output('ParamOut', p)


@register('momentum')
def _momentum(ctx):
    """v = mu·v + g; p -= lr·v, or with use_nesterov p -= (g + mu·v)·lr."""
    g = ctx.input('Grad')
    p = _inplace(ctx, 'Param', 'ParamOut')
    v = _inplace(ctx, 'Velocity', 'VelocityOut')
    mu = ctx.attr('mu', 0.9)
    v.mul_(mu).add_(g)
    if ctx.attr('use_nesterov', False):
        step = (g + mu * v) * _lr(ctx)
    else:
        step = _lr(ctx) * v
    p.sub_(step.to(p.dtype))
    ctx.set_output('VelocityOut', v)
    ctx.set_output('ParamOut', p)


@register('adam')
def _adam(ctx):
    """m = b1·m + (1-b1)·g; v = b2·v + (1-b2)·g²;
    p -= lr·sqrt(1-b2^t)/(1-b1^t) · m / (sqrt(v) + eps)."""
    g = ctx.input('Grad')
    p = _inplace(ctx, 'Param', 'ParamOut')
    m = _inplace(ctx, 'Moment1', 'Moment1Out')
    v = _inplace(ctx, 'Moment2', 'Moment2Out')
    b1 = ctx.attr('beta1', 0.9)
    b2 = ctx.attr('beta2', 0.999)
    eps = ctx.attr('epsilon', 1e-8)
    lr_t = _lr(ctx) * torch.sqrt(1.0 - ctx.input('Beta2Pow').reshape(())) / \
        (1.0 - ctx.input('Beta1Pow').reshape(()))
    m.mul_(b1).add_(g, alpha=1.0 - b1)
    v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
    step = torch.div(m, v.sqrt().add_(eps)).mul_(lr_t)
    p.sub_(step.to(p.dtype))
    ctx.set_output('Moment1Out', m)
    ctx.set_output('Moment2Out', v)
    ctx.set_output('ParamOut', p)


@register('adam_beta_pow_update')
def _adam_beta_pow_update(ctx):
    b1p = _inplace(ctx, 'Beta1Pow', 'Beta1PowOut')
    b2p = _inplace(ctx, 'Beta2Pow', 'Beta2PowOut')
    b1p.mul_(ctx.attr('beta1', 0.9))
    b2p.mul_(ctx.attr('beta2', 0.999))
    ctx.set_output('Beta1PowOut', b1p)
    ctx.set_output('Beta2PowOut', b2p)
