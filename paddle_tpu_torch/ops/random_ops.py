"""Startup random ops (reference: paddle_tpu ops/random_ops.py).

Values are drawn in fp32 on the host from the op's seeded torch.Generator
(LoweringContext.generator) and then moved to the device, so a program's
initial parameters do not depend on the place. They differ from the JAX
package's draws by design: tests that compare the two packages copy
parameters across instead. Both ops are host-bound (registry.HOST_BOUND):
a plan that holds one runs eagerly, never as a CUDA graph.
"""

import torch

from ..core.registry import register


def _shape_from(ctx):
    return [int(s) for s in ctx.attr('shape')]


@register('uniform_random', host_bound=True)
def _uniform_random(ctx):
    lo = ctx.attr('min', -1.0)
    hi = ctx.attr('max', 1.0)
    g = ctx.generator(ctx.attr('seed', 0))
    out = torch.rand(_shape_from(ctx), generator=g) * (hi - lo) + lo
    ctx.set_output('Out', out.to(device=ctx.device,
                                 dtype=ctx.out_dtype('Out')))


@register('gaussian_random', host_bound=True)
def _gaussian_random(ctx):
    mean = ctx.attr('mean', 0.0)
    std = ctx.attr('std', 1.0)
    g = ctx.generator(ctx.attr('seed', 0))
    out = mean + std * torch.randn(_shape_from(ctx), generator=g)
    ctx.set_output('Out', out.to(device=ctx.device,
                                 dtype=ctx.out_dtype('Out')))
