"""Functions whose value or gradient is the JAX package's where torch's
differs: at a tie, at 0, where a value is not finite (max / min, abs,
pow, mod, floor division, rsqrt, relu), and the reductions amax / amin
(ties) and prod (a gradient a CUDA graph can capture). ``rule(fn, grads,
*xs)`` is fn's value with, for each input, the gradient ``grads`` gives:
a function of (g, out, *xs), the reference's JVP rule
(jax/_src/lax/lax.py) written in torch."""

import torch


class _Rule(torch.autograd.Function):

    @staticmethod
    def forward(ctx, fn, grads, *xs):
        out = fn(*xs)
        ctx.grads = grads
        ctx.save_for_backward(out, *xs)
        return out

    @staticmethod
    def backward(ctx, g):
        out, *xs = ctx.saved_tensors
        res = [None, None]
        for x, grad, needed in zip(xs, ctx.grads, ctx.needs_input_grad[2:]):
            gx = grad(g, out, *xs) if needed and grad is not None else None
            if gx is not None and gx.shape != x.shape:
                gx = gx.sum_to_size(x.shape)
            res.append(gx)
        return tuple(res)


def rule(fn, grads, *xs):
    return _Rule.apply(fn, grads, *xs)


def _zero(t):
    return torch.zeros((), dtype=t.dtype, device=t.device)


def _share(g, mine, other):
    """g times lax's _balanced_eq: 1 where this operand is the result, 1/2
    where the other one is too, 0 where neither (a NaN result; a NaN g
    stays NaN, as in jax's product)."""
    return g * (mine.to(g.dtype) / (1.0 + other.to(g.dtype)))


_EXTREMUM_GRADS = (lambda g, z, x, y: _share(g, x == z, y == z),
                   lambda g, z, x, y: _share(g, y == z, x == z))


def maximum(x, y):
    """jnp.maximum: a tie splits the gradient in halves; a NaN result
    passes none (torch.maximum passes all of it to both)."""
    return rule(torch.maximum, _EXTREMUM_GRADS, x, y)


def minimum(x, y):
    """jnp.minimum, with maximum's gradient."""
    return rule(torch.minimum, _EXTREMUM_GRADS, x, y)


def abs(x):
    """jnp.abs: the gradient is g where x >= 0 (0 included), else -g
    (torch.abs passes 0 at 0)."""
    return rule(torch.abs,
                (lambda g, out, x: torch.where(x >= 0, g, -g),), x)


def _replace_zero(x):
    return torch.where(x == 0, torch.ones_like(x), x)


def pow(x, y):
    """jnp.power of floats: C pow; d/dx = y * x^(y - 1) with no case at
    y = 0, d/dy = log(x, 1 where x = 0) * x^y."""
    return rule(torch.pow,
                (lambda g, out, x, y: g * (y * torch.pow(x, y - 1)),
                 lambda g, out, x, y: g * (torch.log(_replace_zero(x)) *
                                           out)), x, y)


def _fmod(x, y):
    """C fmod, exact: computed in float64 (the result is representable in
    x's dtype), as torch's host fmod gives NaN for a subnormal float32
    divisor that the card's handles."""
    return torch.fmod(x.double(), y.double()).to(x.dtype)


def _mod_dy(g, out, x, y):
    q = x / y
    trunc_mod = _fmod(x, y)
    plus = (trunc_mod != 0) & ((trunc_mod < 0) != (y < 0))
    return -g * (torch.sign(q) * torch.floor(torch.abs(q))) + \
        torch.where(plus, g, _zero(g))


def _floor_mod(x, y):
    """jnp.mod's expression: fmod, plus y where fmod's result is nonzero
    and its sign is not y's (torch.remainder differs from it at inf on
    the card)."""
    if not x.is_floating_point():
        return torch.remainder(x, y)
    trunc_mod = _fmod(x, y)
    plus = (trunc_mod != 0) & ((trunc_mod < 0) != (y < 0))
    return torch.where(plus, trunc_mod + y, trunc_mod)


def remainder(x, y):
    """jnp.mod, the floor modulo (the result takes y's sign): d/dx = 1;
    d/dy = -trunc(x / y), plus 1 where y was added to fmod's result."""
    return rule(_floor_mod, (lambda g, out, x, y: g, _mod_dy), x, y)


def rsqrt(x):
    """torch.rsqrt with lax's gradient, g * (-0.5 * out / x): -inf at
    x = -0 (torch's -0.5 * out^3 gives +inf there)."""
    return rule(torch.rsqrt,
                (lambda g, out, x: g * (-0.5 * (out / x)),), x)


class _Relu(torch.autograd.Function):
    """torch.relu with jax.nn.relu's gradient, select(x > 0, g, 0): 0 at
    x <= 0 and at a NaN x even where g is NaN or inf (torch's backward
    passes g at a NaN x, a product g * 0 would be NaN there); only the
    result saved."""

    @staticmethod
    def forward(ctx, x):
        out = torch.relu(x)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        out, = ctx.saved_tensors
        return torch.where(out > 0, g, 0.0)


def relu(x):
    return _Relu.apply(x)


class _Chooser(torch.autograd.Function):
    """amax / amin over ``dim`` (None: every axis) with the reference's
    gradient: shared evenly among the elements equal to the result, and
    none where the result is NaN (torch's gives the row NaN)."""

    @staticmethod
    def forward(ctx, x, fn, dim, keep):
        out = fn(x) if dim is None else fn(x, dim=dim, keepdim=keep)
        ctx.dim, ctx.keep = dim, keep
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        dim = tuple(range(x.dim())) if ctx.dim is None else ctx.dim
        if ctx.dim is None or not ctx.keep:
            out = out.reshape([1 if d in dim else s
                               for d, s in enumerate(x.shape)])
            g = g.reshape(out.shape)
        at = x == out
        count = at.sum(dim=dim, keepdim=True).to(g.dtype)
        return torch.where(at, g / count, _zero(g)), None, None, None


def amax(x, dim=None, keep=False):
    return _Chooser.apply(x, torch.amax, dim, keep)


def amin(x, dim=None, keep=False):
    return _Chooser.apply(x, torch.amin, dim, keep)


class _Prod(torch.autograd.Function):
    """torch.prod over one dim, its gradient from the exclusive products
    left and right of each element: no host read, so a CUDA graph can
    capture it (torch's own looks for zeros on the host), and zeros in
    the row handled as jax's is. A narrow dtype multiplies in fp32 and
    rounds once, on the host as on the card."""

    @staticmethod
    def forward(ctx, x, dim, keep):
        ctx.dim, ctx.keep = dim, keep
        ctx.save_for_backward(x)
        return torch.prod(x.float(), dim=dim, keepdim=keep).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        d, n = ctx.dim, x.shape[ctx.dim]
        g, x32 = g.float(), x.float()
        if not ctx.keep:
            g = g.unsqueeze(d)
        one = torch.ones_like(x32.narrow(d, 0, 1))
        left = torch.cumprod(torch.cat([one, x32.narrow(d, 0, n - 1)], d), d)
        right = torch.cumprod(torch.cat(
            [one, x32.flip(d).narrow(d, 0, n - 1)], d), d).flip(d)
        return (g * (left * right)).to(x.dtype), None, None


def prod(x, dim=None, keep=False):
    """torch.prod over ``dim`` (a tuple; None: every axis), one axis at a
    time from the last, with _Prod's gradient."""
    if dim is None:
        return _Prod.apply(x.reshape(-1), 0, False)
    for d in sorted(dim, reverse=True):
        x = _Prod.apply(x, d, keep)
    return x


def _round_away(d):
    """lax.round's default: halves away from zero."""
    return torch.where(d >= 0, torch.floor(d + 0.5), torch.ceil(d - 0.5))


def floor_divide(x, y):
    """jnp.floor_divide; for floats CPython's float_divmod as jnp writes
    it (x / 0 is NaN, where torch gives inf); a zero gradient, as jax's
    round passes none (torch.floor_divide has no gradient)."""
    x, y = x.detach(), y.detach()
    if not x.is_floating_point():
        return torch.floor_divide(x, y)
    mod = _fmod(x, y)
    div = (x - mod) / y
    fix = (mod != 0) & (torch.sign(y) != torch.sign(mod))
    return _round_away(torch.where(fix, div - 1, div))
