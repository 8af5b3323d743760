"""Gradient and error clipping (reference: paddle_tpu clip.py;
python/paddle/fluid/clip.py).

Gradient clips are ops appended between the backward marker and the
regularizers: ``clip`` (by value), ``clip_by_norm`` (each gradient) and
one ``global_norm_clip`` op over a group's gradients. An error clip
clamps the gradient flowing back through one var: set
``var.error_clip = ErrorClipByValue(...)`` and the executor wraps the
var's value, in the training forward, in ``error_clip_grad`` (an
identity whose backward clamps)."""

import torch

from .layers.helper import LayerHelper

__all__ = ['ErrorClipByValue', 'GradientClipByValue', 'GradientClipByNorm',
           'GradientClipByGlobalNorm', 'append_gradient_clip_ops',
           'set_gradient_clip', 'error_clip_callback', 'error_clip_grad']


class ErrorClipByValue(object):
    """Clamp the gradient flowing back through a var to [min, max] (min
    defaults to -max)."""

    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max


class _ErrorClipGrad(torch.autograd.Function):
    """Identity forward; the cotangent clamped to [lo, hi] backward."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.bounds = (lo, hi)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.bounds
        return torch.clamp(g, lo, hi), None, None


def error_clip_callback(block, op_desc):
    """A no-op, kept for the reference's API: fluid appends clip ops to
    each gradient op here; in this package the executor applies a var's
    ``error_clip`` as the clamp of ``error_clip_grad`` instead."""


def error_clip_grad(x, lo, hi):
    """x, with the gradient that flows back through it clamped to
    [lo, hi] (reference: paddle_tpu core/executor.py _error_clip_grad)."""
    return _ErrorClipGrad.apply(x, lo, hi)


class BaseGradientClipAttr(object):
    def create_operators(self, param, grad, helper):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    """No clip: the gradient as it is."""

    def create_operators(self, param, grad, helper):
        return param, grad


def _clipped_like(helper, grad):
    out = helper.create_variable_for_type_inference(grad.dtype)
    out.shape = grad.shape
    out.stop_gradient = True
    return out


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def create_operators(self, param, grad, helper):
        out = _clipped_like(helper, grad)
        helper.append_op(type='clip', inputs={'X': [grad]},
                         outputs={'Out': [out]},
                         attrs={'min': self.min, 'max': self.max})
        return param, out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def create_operators(self, param, grad, helper):
        out = _clipped_like(helper, grad)
        helper.append_op(type='clip_by_norm', inputs={'X': [grad]},
                         outputs={'Out': [out]},
                         attrs={'max_norm': self.clip_norm})
        return param, out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Global-norm clip: one ``global_norm_clip`` op over the group's
    gradients, appended once every gradient of the group is known."""

    def __init__(self, clip_norm, group_name='default_group'):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name
        self._pending = []

    def create_operators(self, param, grad, helper):
        self._pending.append((param, grad))
        return param, grad

    def flush(self, helper):
        if not self._pending:
            return []
        grads = [g for _, g in self._pending]
        outs = [_clipped_like(helper, g) for g in grads]
        helper.append_op(type='global_norm_clip',
                         inputs={'X': grads},
                         outputs={'Out': outs},
                         attrs={'max_global_norm': self.clip_norm})
        result = [(p, o) for (p, _), o in zip(self._pending, outs)]
        self._pending = []
        return result


def set_gradient_clip(clip, param_list=None, program=None):
    """Attach a default clip to ``program`` (the default main program when
    None); with ``param_list`` also to those parameters."""
    from .core.program import default_main_program
    program = program if program is not None else default_main_program()
    program._gradient_clip_attr = clip
    if param_list is not None:
        for p in param_list:
            if hasattr(p, 'gradient_clip_attr'):
                p.gradient_clip_attr = clip


def append_gradient_clip_ops(param_grads):
    """[(param, grad)] with each clipped gradient replaced: the unclipped
    and per-gradient clipped pairs first, then each global-norm group's,
    in the reference's order."""
    from .core.program import default_main_program
    helper = LayerHelper('gradient_clip')
    program_clip = getattr(default_main_program(),
                           '_gradient_clip_attr', None)
    res = []
    global_clips = {}
    for p, g in param_grads:
        clip_attr = getattr(p, 'gradient_clip_attr', None) or program_clip
        if clip_attr is None:
            res.append((p, g))
            continue
        if isinstance(clip_attr, GradientClipByGlobalNorm):
            global_clips.setdefault(clip_attr.group_name, clip_attr)
            clip_attr.create_operators(p, g, helper)
        else:
            res.append(clip_attr.create_operators(p, g, helper))
    for clip_attr in global_clips.values():
        res.extend(clip_attr.flush(helper))
    return res
