"""The max pool's two plain versions (ops/kernels/max_pool.py) against the
JAX package: ``max_pool_fwd_reference`` gives y equal to
paddle_tpu/ops/conv_ops.py ``_pool2d_impl``'s reduce_window max (NaN where
the window holds one) and its picks, and ``max_pool_bwd_reference`` from
those picks and dy gives jax.vjp's gradient of that reduce_window (XLA's
select_and_scatter). The inputs hold NaN, ±inf, ±0, -inf-only windows
and ties; the cases are test_torch_conv_rest.py's six pools in both layouts,
windows of nothing but padding, and windows of 255 places or more (the
int32 picks).

Tolerances: y bit for bit (NaN at the same places; the reference's max
counts -0 below +0). The gradient exact where windows do not overlap;
where they do, an element's gradient is a sum of several windows' dy, which
the two packages add in other orders and, in bf16, round at other points:
fp32 within 1e-6 of the largest entry, bf16 within one ulp of each element
and 2^-7 of the largest entry (test_torch_conv_rest.py's bounds)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from paddle_tpu.ops import conv_ops as jconv

from paddle_tpu_torch.ops.conv_ops import pool2d
from paddle_tpu_torch.ops.kernels import max_pool as K

from test_torch_conv_rest import MAX_POOLS, close

# (ksize, stride, padding, ceil_mode, map h x w) beyond MAX_POOLS' shapes:
# windows of nothing but padding where windows overlap (pad 3 >= k 3);
# spp's one-bin pool over 16 x 16 (256 places: int32 picks); an
# overlapping pool of 16 x 16 windows with padding (int32 picks)
EXTRA_POOLS = [
    (3, 2, 3, True, (7, 9)),
    (16, 16, 0, True, (16, 16)),
    (16, 4, 3, False, (20, 22)),
]

CASES = [(k, s, p, ceil, (7, 9)) for k, s, p, ceil, _ in MAX_POOLS] + \
    EXTRA_POOLS


def _pad(h, w, k, s, p, ceil):
    """pool2d's padding (left, right, top, bottom), ceil mode's extra
    bottom / right rows included."""
    eh = -(h + 2 * p - k) % s if ceil else 0
    ew = -(w + 2 * p - k) % s if ceil else 0
    return (p, p + ew, p, p + eh)


def _inputs(case, seed):
    """x [2, 3, h, w] on a 1/2 grid (ties) with NaN, ±inf and a -inf
    corner, and a cotangent for the pool's output."""
    k, s, p, ceil, (h, w) = case
    rng = np.random.RandomState(seed)
    x = np.round(rng.randn(2, 3, h, w) * 2) / 2
    x[rng.rand(*x.shape) < 0.15] = np.nan
    x[rng.rand(*x.shape) < 0.05] = np.inf
    x[rng.rand(*x.shape) < 0.05] = -np.inf
    x[0, 0, :3, :3] = -np.inf
    x = x.astype('float32')
    pad = _pad(h, w, k, s, p, ceil)
    oh, ow = K.out_size((h, w), (k, k), (s, s), pad)
    dy = rng.randn(2, 3, oh, ow).astype('float32')
    return x, dy, pad


def _jax(x, dy, case, fmt, dtype):
    """y and jax.vjp's gradient of _pool2d_impl on x (NCHW numpy), in
    ``fmt``, as float32 NCHW numpy."""
    k, s, p, ceil, _ = case
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    to = (lambda a: a.transpose(0, 2, 3, 1)) if fmt == 'NHWC' else \
        (lambda a: a)
    back = (lambda a: a.transpose(0, 3, 1, 2)) if fmt == 'NHWC' else \
        (lambda a: a)

    def f(v):
        return jconv._pool2d_impl(v, 'max', [k, k], [s, s], [p, p], False,
                                  ceil_mode=ceil, data_format=fmt)
    y, vjp = jax.vjp(f, jnp.asarray(to(x)).astype(jdt))
    dx, = vjp(jnp.asarray(to(dy)).astype(jdt))
    return (back(np.asarray(y.astype(jnp.float32))),
            back(np.asarray(dx.astype(jnp.float32))))


def _same_bits(a, b):
    """float32 arrays NaN at the same places and bit for bit elsewhere."""
    nan = np.isnan(a)
    return np.array_equal(nan, np.isnan(b)) and np.array_equal(
        np.where(nan, np.float32(0), a).view(np.int32),
        np.where(nan, np.float32(0), b).view(np.int32))


def _torch_x(a, fmt, dtype):
    t = torch.tensor(a).to(dtype)
    return t.contiguous(memory_format=torch.channels_last) \
        if fmt == 'NHWC' else t


def _ids(case):
    k, s, p, ceil, (h, w) = case
    return 'k%d_s%d_p%d%s_%dx%d' % (k, s, p, '_ceil' if ceil else '', h, w)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['fp32', 'bf16'])
@pytest.mark.parametrize('fmt', ['NCHW', 'NHWC'])
@pytest.mark.parametrize('case', CASES, ids=_ids)
def test_split_plain_versions_match_reference(case, fmt, dtype):
    """y bit for bit reduce_window's max, NaN where the window holds one;
    the gradient from the picks and dy alone equal to jax.vjp's (within the
    rounding of its sums where windows overlap)."""
    k, s = case[:2]
    x, dy, pad = _inputs(case, k * 10 + s + case[2])
    y_ref, dx_ref = _jax(x, dy, case, fmt, dtype)
    xt = _torch_x(x, fmt, dtype)
    y, pick = K.max_pool_fwd_reference(xt, (k, k), (s, s), pad)
    assert pick.dtype == K.pick_dtype((k, k))
    assert pick.dtype == (torch.uint8 if k * k < 255 else torch.int32)
    y = y.float().numpy()
    assert np.isnan(y_ref).any()
    assert _same_bits(y, y_ref)
    dx = K.max_pool_bwd_reference(pick, _torch_x(dy, fmt, dtype), (k, k),
                                  (s, s), pad, x.shape[2:])
    dx = dx.float().numpy()
    if s >= k:
        assert np.array_equal(dx, dx_ref)
    else:
        close([(dx_ref, dx)], 1e-6, bf16=dtype == torch.bfloat16)


def _pr23_bwd_reference(x, dy, ksize, strides, pad):
    """The gradient as the single plain version before the split computed
    it from x and dy (picks redone on the unfolded windows, dy scattered
    to them and folded back)."""
    (kh, kw), k = ksize, ksize[0] * ksize[1]
    xp = F.pad(x, pad, value=float('-inf'))
    n, c, oh, ow = dy.shape
    win = xp.unfold(2, kh, strides[0]).unfold(3, kw, strides[1]) \
        .reshape(n, c, oh, ow, k)
    pos = torch.arange(k, device=x.device, dtype=torch.int32)
    last_nan = torch.where(win.isnan(), pos, -1).amax(-1, keepdim=True)
    after = pos > last_nan
    top = torch.where(after, win, float('-inf')).amax(-1, keepdim=True)
    pick = (after & (win == top)).to(torch.uint8).argmax(-1, keepdim=True)
    pick = torch.where(last_nan == k - 1, k - 1, pick)
    cols = torch.zeros(win.shape, dtype=dy.dtype, device=dy.device) \
        .scatter_(-1, pick, dy.unsqueeze(-1))
    dx = F.fold(cols.permute(0, 1, 4, 2, 3).reshape(n, c * k, oh * ow),
                xp.shape[2:], (kh, kw), stride=strides)
    h, w = x.shape[2:]
    return dx[:, :, pad[2]:pad[2] + h, pad[0]:pad[0] + w]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['fp32', 'bf16'])
@pytest.mark.parametrize('case', CASES, ids=_ids)
def test_split_plain_path_equals_single_plain_version(case, dtype):
    """max_pool_bwd_reference(max_pool_fwd_reference(x)[1], dy) bit for
    bit the gradient the one plain version made from x and dy."""
    k, s = case[:2]
    x, dy, pad = _inputs(case, 7 * k + s)
    xt, dyt = torch.tensor(x).to(dtype), torch.tensor(dy).to(dtype)
    _, pick = K.max_pool_fwd_reference(xt, (k, k), (s, s), pad)
    got = K.max_pool_bwd_reference(pick, dyt, (k, k), (s, s), pad,
                                   x.shape[2:])
    want = _pr23_bwd_reference(xt, dyt, (k, k), (s, s), pad)
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))


@pytest.mark.parametrize('case', [c for c in CASES if c[2] >= c[0]],
                         ids=_ids)
def test_padding_only_windows(case):
    """A window of nothing but padding: y -inf, its pick padding (255),
    no gradient from it."""
    k, s, p, ceil, (h, w) = case
    x = torch.zeros(1, 1, h, w)
    pad = _pad(h, w, k, s, p, ceil)
    y, pick = K.max_pool_fwd_reference(x, (k, k), (s, s), pad)
    assert y[0, 0, 0, 0] == float('-inf') and pick[0, 0, 0, 0] == 255
    assert bool((y == float('-inf')).eq(pick == 255).all())
    dy = torch.ones_like(y)
    dx = K.max_pool_bwd_reference(pick, dy, (k, k), (s, s), pad, (h, w))
    assert float(dx.sum()) == float((pick != 255).sum())


def test_picks_only_where_x_needs_a_gradient(monkeypatch):
    """_MaxPool asks for picks only where x needs a gradient; y is the same
    either way, and the gradient through pool2d is the plain path's."""
    x, dy, pad = _inputs(MAX_POOLS[1][:4] + ((7, 9),), 3)
    xt = torch.tensor(x)
    calls = []
    real = K.max_pool_fwd_reference

    def spy(x, ksize, strides, pad, picks=True):
        calls.append(picks)
        return real(x, ksize, strides, pad, picks)
    monkeypatch.setattr(K, 'max_pool_fwd_reference', spy)
    y0 = pool2d(xt, 'max', [3, 3], [2, 2], [1, 1], False)
    xg = xt.clone().requires_grad_()
    y1 = pool2d(xg, 'max', [3, 3], [2, 2], [1, 1], False)
    assert calls == [False, True]
    assert torch.equal(y0.nan_to_num(), y1.detach().nan_to_num())
    dx, = torch.autograd.grad(y1, xg, torch.tensor(dy))
    _, pick = real(xt, (3, 3), (2, 2), pad)
    assert torch.equal(dx, K.max_pool_bwd_reference(
        pick, torch.tensor(dy), (3, 3), (2, 2), pad, (7, 9)))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['fp32', 'bf16'])
def test_sign_of_a_zero_max(dtype):
    """A window whose max is zero: +0 where it holds +0 (before or after a
    -0), -0 where it holds only -0, as reduce_window's max gives it; the
    pick stays the first of the equal zeros."""
    rows = [[-0.0, 0.0, -1.0], [0.0, -0.0, -1.0], [-0.0, -0.0, -1.0],
            [-1.0, -0.0, 0.0], [-1.0, -2.0, -0.0], [0.0, 0.0, -0.0]]
    x = np.array(rows, 'float32').reshape(1, 1, len(rows), 3)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    y_ref = np.asarray(jconv._pool2d_impl(
        jnp.asarray(x).astype(jdt), 'max', [1, 3], [1, 1], [0, 0],
        False).astype(jnp.float32))
    y, pick = K.max_pool_fwd_reference(_torch_x(x, 'NCHW', dtype), (1, 3),
                                       (1, 1), (0, 0, 0, 0))
    assert _same_bits(y.float().numpy(), y_ref)
    assert np.signbit(y_ref).ravel().tolist() == [False, False, True,
                                                  False, True, False]
    assert pick.ravel().tolist() == [0, 0, 0, 1, 2, 0]
