"""The learning-rate decay op: one lowering for every schedule
(reference: paddle_tpu ops/lr_ops.py; fluid's learning_rate_decay.py
builds each formula from many small ops).

The step comes from the program's ``@LR_DECAY_COUNTER@`` on the device
and the rate stays a device tensor (the optimizer ops read it as one), so
a captured step holds the schedule without a host read or a host copy
(constants are fills). The formulas are the reference's, in its order of
operations, in fp32, at its compiler's rounding points: XLA turns a
division by a constant into a product with the fp32 reciprocal, folds
products of constants into one fp32 constant, pow(x, 2) into x·x and a
product and a sum into one fused multiply-add; its exp is a Cephes-style
polynomial, its cos and pow correctly rounded; a constant over a tensor
stays a true division (torch's ``c / t`` would take the reciprocal of t
first). So each schedule gives the JAX package's fp32 bits on the host
(tests/test_torch_trainer.py).
"""

import math

import numpy as np
import torch

from ..core.registry import register


def _f32(x):
    """x rounded to fp32 (a constant as the reference's compiler folds
    it)."""
    return float(np.float32(x))


def _fma(a, b, c):
    """a · b + c rounded once to fp32, as the reference's CPU compiler
    contracts a product and a sum (computed in fp64: the fp32 product is
    exact there)."""
    return (a.double() * b + c).float()


def _exp(x):
    """exp in fp32 as the reference's CPU compiler evaluates it (a
    Cephes-style range reduction and polynomial, each step one fused
    multiply-add), so the schedule's bits match; torch.exp differs in the
    last place."""
    n = torch.floor(_fma(x, _f32(1.44269504088896341), 0.5))
    r = _fma(n, _f32(-0.693359375), x)
    r = _fma(n, _f32(2.12194440e-4), r)
    p = torch.full_like(x, _f32(1.9875691500e-4))
    for k in (1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
              1.6666665459e-1, 5.0000001201e-1):
        p = _fma(p, r, _f32(k))
    y = _fma(p, r * r, r) + 1.0
    return y * torch.exp2(n)


def lr_decay(step, kind, lr, decay_steps=1, decay_rate=0.0,
             staircase=False, **attrs):
    """The rate at ``step`` (an fp32 0-dim tensor) as an fp32 0-dim
    tensor; ``attrs`` holds the kind's other attributes."""
    inv_ds = _f32(1.0 / float(decay_steps))
    dr = decay_rate
    if kind == 'exponential':
        p = step * inv_ds
        if staircase:
            p = torch.floor(p)
        return torch.pow(torch.full_like(p, dr), p) * lr
    if kind in ('natural_exp', 'inverse_time'):
        sign = -1.0 if kind == 'natural_exp' else 1.0
        if staircase:
            x = torch.floor(step * inv_ds) * (sign * dr)
        else:
            # (step · 1/ds) · dr folds into one constant
            x = step * _f32(_f32(sign * dr) * inv_ds)
        if kind == 'natural_exp':
            return _exp(x) * lr
        if not staircase:
            return torch.full_like(x, lr) / _fma(step, _f32(
                _f32(dr) * inv_ds), 1.0)
        return torch.full_like(x, lr) / (x + 1.0)
    if kind == 'polynomial':
        end_lr = attrs.get('end_learning_rate', 0.0001)
        power = attrs.get('power', 1.0)
        if attrs.get('cycle', False):
            div = torch.ceil(torch.clamp(step * inv_ds, min=1.0))
            decay_steps = div * float(decay_steps)
            x = 1.0 - torch.minimum(step, decay_steps) / decay_steps
        else:
            x = _fma(torch.clamp(step, max=float(decay_steps)), -inv_ds,
                     1.0)
        if power != 1.0:
            x = torch.pow(x, power)
        return _fma(x, _f32(lr - end_lr), end_lr)
    if kind == 'piecewise':
        # values[sum(step >= boundaries)], as selects (no index tensor)
        values = attrs['values']
        out = torch.full_like(step, values[0])
        for b, v in zip(attrs['boundaries'], values[1:]):
            out = torch.where(step >= b, torch.full_like(step, v), out)
        return out
    if kind == 'cosine':
        frac = torch.clamp(step * _f32(1.0 / float(attrs['total_steps'])),
                           max=1.0)
        # cos and pow correctly rounded (through fp64), as the reference's
        return (torch.cos((frac * _f32(math.pi)).double()).float() + 1.0) \
            * _f32(0.5 * lr)
    if kind == 'noam':
        warmup = float(attrs['warmup_steps'])
        s = torch.clamp(step, min=1.0)
        return torch.minimum(torch.pow(s.double(), -0.5).float(),
                             s * _f32(warmup ** -1.5)) * \
            _f32(lr * float(attrs['d_model']) ** -0.5)
    raise NotImplementedError('lr_decay kind %r' % kind)


@register('lr_decay')
def _lr_decay(ctx):
    attrs = dict(ctx.op.attrs)
    kind = attrs.pop('kind')
    lr = attrs.pop('learning_rate')
    step = ctx.input('Step').reshape(()).to(torch.float32)
    ctx.set_output('Out', lr_decay(step, kind, lr, **attrs).reshape(1))
