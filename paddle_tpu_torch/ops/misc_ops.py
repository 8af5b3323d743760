"""Misc ops (reference: paddle_tpu ops/misc_ops.py; fluid's
arg_min_max_op, argsort_op, bilinear_interp_op, nearest_interp_op,
isfinite_op, print_op, lod_reset_op, where, linspace, range): the arg ops,
the two resizes, isfinite, print, lod_reset, where, linspace, range and
weight normalization (weight_norm, and weight_norm_g_init, its startup
op)."""

import numpy as np
import torch

from ..core.registry import register
from .tensor_ops import device_constant


@register('argmax')
def _argmax(ctx):
    """int64 index of the largest entry along ``axis``; on a tie the first
    one, as jnp.argmax gives."""
    ctx.set_output('Out', torch.argmax(ctx.input('X'),
                                       dim=ctx.attr('axis', -1)))


@register('argmin')
def _argmin(ctx):
    """int64 index of the smallest entry along ``axis``, the first on a tie
    (a NaN counts as the smallest, as in jnp.argmin)."""
    ctx.set_output('Out', torch.argmin(ctx.input('X'),
                                       dim=ctx.attr('axis', -1)))


@register('argsort')
def _argsort(ctx):
    """Out: X sorted ascending along ``axis`` (NaN last); Indices: the
    int64 positions they came from, a stable sort as jnp.argsort's."""
    out, idx = torch.sort(ctx.input('X'), dim=ctx.attr('axis', -1),
                          stable=True)
    ctx.set_output('Indices', idx)
    ctx.set_output('Out', out)


def _triangle_weights(n_in, n_out):
    """jax.image's bilinear weight matrix [n_in, n_out] (compute_weight_mat:
    half-pixel sample points, a triangle kernel widened by 1 / scale when
    downsampling, each column normalized, columns outside the input 0),
    fp32."""
    inv_scale = 1.0 / (n_out / n_in)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale \
        - 0.5
    dist = torch.abs(sample[None, :] - torch.arange(
        n_in, dtype=torch.float32)[:, None]) / max(inv_scale, 1.0)
    w = torch.clamp(1.0 - torch.abs(dist), min=0.0)
    total = w.sum(0, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    w = torch.where(torch.abs(total) > 1000.0 * eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


@register('bilinear_interp')
def _bilinear_interp(ctx):
    """jax.image.resize(method='bilinear') on NCHW X: antialiased (the
    kernel widens when downsampling), as jax's contraction of X with one
    weight matrix an axis, so a non-finite value reaches every output of
    its row and column (0 * inf is NaN there too); fp32, rounded once to
    X's dtype. An axis whose size does not change is left as it is."""
    x = ctx.input('X')
    out = x.float()
    for axis, size in ((2, ctx.attr('out_h')), (3, ctx.attr('out_w'))):
        n_in = out.shape[axis]
        if n_in != size:
            w = device_constant(ctx, (n_in, size),
                                lambda: _triangle_weights(n_in, size))
            out = torch.movedim(torch.movedim(out, axis, -1) @ w, -1, axis)
    ctx.set_output('Out', out.to(x.dtype))


@register('nearest_interp')
def _nearest_interp(ctx):
    """jax.image.resize(method='nearest') on NCHW X: the source pixel
    nearest to each half-pixel centre."""
    x = ctx.input('X')
    out = torch.nn.functional.interpolate(
        x, size=(ctx.attr('out_h'), ctx.attr('out_w')), mode='nearest-exact')
    ctx.set_output('Out', out)


@register('isfinite')
def _isfinite(ctx):
    """[1] bool: every element of X is finite."""
    ctx.set_output('Out', torch.isfinite(ctx.input('X')).all().reshape(1))


@register('print', host_bound=True)
def _print(ctx):
    """Writes ``message`` and In's value every run, as jax.debug.print
    does inside a compiled program; Out is In."""
    x = ctx.input('In')
    value = x.detach()
    if value.dtype == torch.bfloat16:
        value = value.float()
    print(ctx.attr('message', 'print: ') + '{}'.format(value.cpu().numpy()))
    ctx.set_output('Out', x)


@register('lod_reset')
def _lod_reset(ctx):
    """The identity: the port keeps no LoD on a tensor (core/lod.py)."""
    ctx.set_output('Out', ctx.input('X'))


@register('where')
def _where(ctx):
    ctx.set_output('Out', torch.where(ctx.input('Condition') > 0,
                                      ctx.input('X'), ctx.input('Y')))


@register('linspace')
def _linspace(ctx):
    """The reference's linspace bits: jnp.linspace as XLA compiles it with
    constant bounds, start * (1 - i * r) + i * (stop * r) for i < num - 1
    with r = 1 / (num - 1) (each product rounded in the computation's
    float type), then stop; floored for an integer type."""
    dtype = ctx.out_dtype('Out')

    def make():
        num = int(ctx.attr('num'))
        ct = dtype if dtype.is_floating_point else torch.float32
        start = torch.tensor(ctx.attr('start'), dtype=ct)
        stop = torch.tensor(ctx.attr('stop'), dtype=ct)
        if num > 1:
            i = torch.arange(num - 1, dtype=ct)
            r = torch.tensor(1.0, dtype=ct) / (num - 1)
            out = torch.cat([start * (1 - i * r) + i * (stop * r),
                             stop.reshape(1)])
        else:
            out = start.reshape(1)[:num]
        if not dtype.is_floating_point:
            out = torch.floor(out)
        return out.to(dtype)
    ctx.set_output('Out', device_constant(ctx, (), make).clone())


@register('range')
def _range(ctx):
    """np.arange(start, end, step) in Out's dtype (what jnp.arange does
    with a step)."""
    dtype = ctx.out_dtype('Out')

    def make():
        np_dtype = torch.empty(0, dtype=dtype).numpy().dtype \
            if dtype != torch.bfloat16 else np.float32
        return torch.from_numpy(np.arange(
            ctx.attr('start', 0), ctx.attr('end'), ctx.attr('step', 1),
            dtype=np_dtype)).to(dtype)
    ctx.set_output('Out', device_constant(ctx, (), make).clone())


def _wn_norm(v, dim):
    """sqrt(sum(v^2) + 1e-12) over every axis but ``dim`` (-1: every
    axis), kept."""
    axes = [i for i in range(v.dim()) if i != dim] if dim >= 0 else \
        list(range(v.dim()))
    sq = torch.square(v)
    if axes:
        sq = torch.sum(sq, dim=axes, keepdim=True)
    return torch.sqrt(sq + 1e-12)


@register('weight_norm')
def _weight_norm(ctx):
    """W = G * V / ||V|| (WeightNormParamAttr's reparameterization), the
    norm over every axis but ``dim``."""
    v, g = ctx.input('V'), ctx.input('G')
    dim = ctx.attr('dim', -1)
    gshape = [1] * v.dim()
    if dim >= 0:
        gshape[dim] = v.shape[dim]
    ctx.set_output('W', g.reshape(gshape) * v / _wn_norm(v, dim))


@register('weight_norm_g_init')
def _weight_norm_g_init(ctx):
    """Startup: G = ||V||, so the first W equals V's initial value."""
    ctx.set_output('G', _wn_norm(ctx.input('V'), ctx.attr('dim', -1))
                   .reshape(-1))
