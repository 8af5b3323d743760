"""Arg ops (reference: paddle_tpu ops/misc_ops.py; fluid's
arg_min_max_op)."""

import torch

from ..core.registry import register


@register('argmax')
def _argmax(ctx):
    """int64 index of the largest entry along ``axis``; on a tie the first
    one, as jnp.argmax gives."""
    ctx.set_output('Out', torch.argmax(ctx.input('X'),
                                       dim=ctx.attr('axis', -1)))
