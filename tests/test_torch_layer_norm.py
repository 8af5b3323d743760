"""Port vs reference for the fused layer norm (K1): the port's plain
version against the JAX package's _ln_reference and against its Pallas
kernel _ln_pallas in interpret mode, on the same numpy inputs."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.ops.pallas import layer_norm as jln
from paddle_tpu_torch.ops.kernels import layer_norm as tln

SHAPES = [(64, 128), (16, 512)]


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_PALLAS_INTERPRET', '1')


def _inputs(n, d, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, d) * 2.0 + 0.5).astype('float32')
    g = (1.0 + 0.1 * rng.randn(d)).astype('float32')
    b = (0.1 * rng.randn(d)).astype('float32')
    return x, g, b


def _bf16_ulp(x):
    """One bf16 ulp (8 significant bits) at |x|."""
    a = np.maximum(np.abs(x.astype(np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _port(x, g, b, dtype):
    xt = torch.tensor(x).to(dtype)
    y = tln.fused_layer_norm(xt, torch.tensor(g), torch.tensor(b), eps=1e-5)
    assert y.dtype == dtype
    return y.float().numpy()


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('impl', ['reference', 'pallas_interpret'])
def test_plain_matches_jax_fp32(shape, impl):
    """fp32: both sides take fp32 statistics over the same row; only
    the summation order differs, so 1e-5 absolute (values are O(1))."""
    x, g, b = _inputs(*shape)
    fn = jln._ln_reference if impl == 'reference' else jln._ln_pallas
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                         1e-5))
    got = _port(x, g, b, torch.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('impl', ['reference', 'pallas_interpret'])
def test_plain_matches_jax_bf16(shape, impl):
    """bf16 x: statistics in fp32, y rounded once to bf16 on both sides;
    fp32 rounding differences may move that rounding by one bf16 ulp."""
    x, g, b = _inputs(*shape, seed=1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    # the port sees the same bf16 inputs
    x_rounded = np.asarray(xb.astype(jnp.float32))
    fn = jln._ln_reference if impl == 'reference' else jln._ln_pallas
    want = np.asarray(fn(xb, jnp.asarray(g), jnp.asarray(b), 1e-5)
                      .astype(jnp.float32))
    got = _port(x_rounded, g, b, torch.bfloat16)
    diff = np.abs(got.astype(np.float64) - want)
    assert np.all(diff <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))), \
        diff.max()


def test_leading_dims_and_begin_norm_axis():
    """fused_layer_norm flattens the normalized trailing dims like the
    reference's wrapper."""
    x, g, b = _inputs(6, 32, seed=2)
    x3 = x.reshape(2, 3, 32)
    want = np.asarray(jln.fused_layer_norm(
        jnp.asarray(x3), jnp.asarray(g), jnp.asarray(b), eps=1e-5))
    got = tln.fused_layer_norm(torch.from_numpy(x3), torch.from_numpy(g),
                               torch.from_numpy(b), eps=1e-5).numpy()
    assert got.shape == (2, 3, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor never reaches the kernel: the launch count stays."""
    before = tln.fused_layer_norm.launches
    x, g, b = _inputs(4, 16, seed=3)
    tln.fused_layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                         torch.from_numpy(b))
    assert tln.fused_layer_norm.launches == before


@pytest.mark.parametrize('shape', SHAPES + [(7, 1000)])
def test_reference_bwd_matches_jax_vjp(shape):
    """layer_norm_reference_bwd, the plain version of the backward kernels,
    against jax.vjp of the JAX package's fused_layer_norm (its custom_vjp
    backward _ln_vjp_bwd), fp32: 1e-5."""
    import jax
    n, d = shape
    x, g, b = _inputs(n, d, seed=4)
    gy = np.random.RandomState(5).randn(n, d).astype('float32')
    _, vjp = jax.vjp(lambda a, w, c: jln.fused_layer_norm(a, w, c, 1e-5),
                     jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    want = vjp(jnp.asarray(gy))
    got = tln.layer_norm_reference_bwd(torch.tensor(x), torch.tensor(g),
                                       torch.tensor(b), torch.tensor(gy),
                                       1e-5)
    for t, w, name in zip(got, want, ('dx', 'dgamma', 'dbeta')):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_autograd_backward_on_cpu_takes_the_plain_version():
    """On a CPU tensor the Function's backward is layer_norm_reference_bwd
    and launches nothing."""
    x, g, b = _inputs(6, 32, seed=6)
    gy = torch.tensor(np.random.RandomState(7).randn(6, 32)
                      .astype('float32'))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, g, b)]
    before = tln.fused_layer_norm.bwd_launches
    y = tln.fused_layer_norm(*leaves, eps=1e-5)
    got = torch.autograd.grad(y, leaves, gy)
    assert tln.fused_layer_norm.bwd_launches == before
    want = tln.layer_norm_reference_bwd(torch.tensor(x), torch.tensor(g),
                                        torch.tensor(b), gy, 1e-5)
    for t, w in zip(got, want):
        assert torch.equal(t, w)
