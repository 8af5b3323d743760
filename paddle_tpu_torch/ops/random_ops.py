"""Random ops (reference: paddle_tpu ops/random_ops.py): the startup
fills uniform_random and gaussian_random, and their *_batch_size_like
forms, whose leading (or ``output_dim_idx``) size is read from an input;
truncated_gaussian_random (TruncatedNormal's fill), randint and
shuffle_batch.

Values are drawn in fp32 on the host from the op's seeded torch.Generator
(LoweringContext.generator) and then moved to the device, so they do not
depend on the place. They differ from the JAX package's draws by design:
tests that compare the two packages copy parameters across instead, and
hold the draws to their shape, range and moments. The *_batch_size_like
draws, truncated_gaussian_random, randint and shuffle_batch are keyed by
the step too, so each step of a main program draws afresh and a run at
the same step repeats them. Every op here is
host-bound (registry.HOST_BOUND): a plan that holds one runs eagerly,
never as a CUDA graph.
"""

import math

import torch

from ..core.registry import register


def _shape_from(ctx):
    return [int(s) for s in ctx.attr('shape')]


def _batch_size_like(ctx):
    """The shape attr with its output_dim_idx entry taken from Input's
    input_dim_idx, and a generator keyed by the step."""
    shape = _shape_from(ctx)
    shape[ctx.attr('output_dim_idx', 0)] = \
        ctx.input('Input').shape[ctx.attr('input_dim_idx', 0)]
    return shape, ctx.generator(step=True)


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


@register('uniform_random_batch_size_like', host_bound=True)
def _uniform_random_bsl(ctx):
    lo = ctx.attr('min', -1.0)
    hi = ctx.attr('max', 1.0)
    shape, g = _batch_size_like(ctx)
    out = torch.rand(shape, generator=g) * (hi - lo) + lo
    ctx.set_output('Out', out.to(device=ctx.device,
                                 dtype=ctx.out_dtype('Out')))


@register('gaussian_random_batch_size_like', host_bound=True)
def _gaussian_random_bsl(ctx):
    shape, g = _batch_size_like(ctx)
    out = ctx.attr('mean', 0.0) + ctx.attr('std', 1.0) * torch.randn(
        shape, generator=g)
    ctx.set_output('Out', out.to(device=ctx.device,
                                 dtype=ctx.out_dtype('Out')))


@register('truncated_gaussian_random', host_bound=True)
def _truncated_gaussian_random(ctx):
    """mean + std * z, z a normal truncated to [-2, 2], by the inverse of
    its distribution function on a uniform draw."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(_shape_from(ctx), generator=ctx.generator(step=True))
    z = (math.sqrt(2.0) * torch.erfinv(lo + (hi - lo) * u)).clamp(-2.0, 2.0)
    out = ctx.attr('mean', 0.0) + ctx.attr('std', 1.0) * z
    ctx.set_output('Out', out.to(device=ctx.device,
                                 dtype=ctx.out_dtype('Out')))


@register('randint', host_bound=True)
def _randint(ctx):
    """Integers uniform in [low, high), int64 unless Out says otherwise."""
    out = torch.randint(ctx.attr('low', 0), ctx.attr('high', 100),
                        _shape_from(ctx), generator=ctx.generator(step=True))
    ctx.set_output('Out', out.to(device=ctx.device,
                                 dtype=ctx.out_dtype('Out', 'int64')))


@register('shuffle_batch', host_bound=True)
def _shuffle_batch(ctx):
    """Out = X[perm] for a random permutation of the rows (the gradient
    flows back through the gather); ShuffleIdx is perm, int64."""
    x = ctx.input('X')
    perm = torch.randperm(x.shape[0], generator=ctx.generator(step=True))
    perm = perm.to(x.device)
    ctx.set_output('Out', x[perm])
    ctx.set_output('ShuffleIdx', perm)
