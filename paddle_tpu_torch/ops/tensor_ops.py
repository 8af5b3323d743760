"""Startup tensor ops (reference: paddle_tpu ops/tensor_ops.py)."""

import numpy as np
import torch

from ..core.registry import register


@register('fill_constant')
def _fill_constant(ctx):
    shape = [int(s) for s in ctx.attr('shape')]
    ctx.set_output('Out', torch.full(shape, ctx.attr('value', 0.0),
                                     dtype=ctx.out_dtype('Out'),
                                     device=ctx.device))


@register('assign_value')
def _assign_value(ctx):
    values = np.asarray(ctx.attr('values'))
    shape = ctx.attr('shape', None)
    if shape:
        values = values.reshape(shape)
    ctx.set_output('Out', torch.as_tensor(values).to(
        device=ctx.device, dtype=ctx.out_dtype('Out')))
