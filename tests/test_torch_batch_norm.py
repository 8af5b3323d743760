"""Port vs reference for the training batch norm (K5): the port's plain
version and its autograd Function against the JAX package's
fused_batch_norm_train (its Pallas kernel in interpret mode, its
custom_vjp backward) on the same numpy inputs, and the batch_norm op
lowering against the JAX package's op in training, at test time and under
bf16 AMP."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as fluid
from paddle_tpu.ops.pallas import batch_norm as jbn
from paddle_tpu_torch.ops.kernels import batch_norm as tbn

import paddle_tpu_torch as pt
from paddle_tpu_torch.weights import load_into_scope

# (layout, shape): shapes the Pallas kernel takes (rows % 8 == 0, C < 128
# or a multiple of 128), or the JAX package would not run it
CASES = [('NHWC', (4, 6, 6, 64)), ('NCHW', (4, 32, 6, 6)),
         ('NC', (64, 128))]


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_PALLAS_INTERPRET', '1')


def _inputs(shape, c, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2 + 1).astype('float32')
    scale = (rng.rand(c) + 0.5).astype('float32')
    bias = rng.randn(c).astype('float32')
    gy = rng.randn(*shape).astype('float32')
    return x, scale, bias, gy


def _bf16_ulp(x):
    """One bf16 ulp (8 significant bits) at |x|."""
    a = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _within_ulp(got, want):
    diff = np.abs(np.asarray(got, np.float64) - want)
    return np.all(diff <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want))))


def _channels(layout, shape):
    return shape[1] if layout == 'NCHW' else shape[-1]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('layout,shape', CASES)
def test_forward_and_gradient_match_jax(layout, shape, dtype):
    """y, mean, var and (dx, dscale, dbias) for a cotangent gy. fp32 as
    the JAX package's own kernel tests hold its kernel to its jnp form:
    mean rtol 1e-5, var rtol 1e-4 atol 1e-5, y 1e-4, gradients 2e-4.
    bf16 x: the statistics are fp32 sums of the same bf16 values (the
    same fp32 bounds), y and dx are rounded to bf16 at the same points on
    both sides, so at most one bf16 ulp apart."""
    c = _channels(layout, shape)
    x, scale, bias, gy = _inputs(shape, c, seed=len(shape) + c)
    jx = jnp.asarray(x).astype(dtype)
    jgy = jnp.asarray(gy).astype(dtype)

    def jfn(a, s, b):
        return jbn.fused_batch_norm_train(a, s, b, 1e-5, layout=layout)

    (jy, jm, jv), vjp = jax.vjp(jfn, jx, jnp.asarray(scale),
                                jnp.asarray(bias))
    jdx, jds, jdb = vjp((jgy, jnp.zeros_like(jm), jnp.zeros_like(jv)))

    tdt = getattr(torch, dtype)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(tdt) \
        .requires_grad_()
    ts = torch.tensor(scale, requires_grad=True)
    tb = torch.tensor(bias, requires_grad=True)
    before = tbn.fused_batch_norm_train.launches
    ty, tm, tv = tbn.fused_batch_norm_train(tx, ts, tb, 1e-5, layout=layout)
    assert tbn.fused_batch_norm_train.launches == before   # CPU: plain
    assert ty.dtype == tdt and ty.shape == tx.shape
    assert tm.dtype == tv.dtype == torch.float32
    assert not tm.requires_grad and not tv.requires_grad
    ty.backward(torch.tensor(np.asarray(jgy.astype(jnp.float32))).to(tdt))

    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-5)
    for got, want, name in ((ts.grad, jds, 'dscale'), (tb.grad, jdb,
                                                        'dbias')):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4, err_msg=name)
    y32 = np.asarray(jy.astype(jnp.float32))
    dx32 = np.asarray(jdx.astype(jnp.float32))
    if dtype == 'float32':
        np.testing.assert_allclose(ty.detach().numpy(), y32, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(tx.grad.numpy(), dx32, rtol=2e-4,
                                   atol=2e-4)
    else:
        assert tx.grad.dtype == torch.bfloat16
        assert _within_ulp(ty.detach().float().numpy(), y32)
        assert _within_ulp(tx.grad.float().numpy(), dx32)


def test_any_shape_and_the_memory_layout_is_kept():
    """Shapes the Pallas kernel refuses (rows not a multiple of 8, C
    neither < 128 nor a multiple of 128) against the closed form, and y
    keeps a channels-last NCHW tensor's strides."""
    rng = np.random.RandomState(5)
    x = torch.tensor(rng.randn(3, 7, 5, 130).astype('float32'))
    s = torch.tensor(rng.rand(130).astype('float32') + 0.5)
    b = torch.tensor(rng.randn(130).astype('float32'))
    y, m, v = tbn.fused_batch_norm_train(x, s, b, 1e-5, layout='NHWC')
    xf = x.double().reshape(-1, 130)
    want = (xf - xf.mean(0)) / torch.sqrt(xf.var(0, unbiased=False) + 1e-5)
    np.testing.assert_allclose(y.reshape(-1, 130).numpy(),
                               (want * s.double() + b.double()).numpy(),
                               rtol=1e-4, atol=1e-4)
    nchw = x.permute(0, 3, 1, 2)           # channels-last strides
    y2, m2, _ = tbn.fused_batch_norm_train(nchw, s, b, 1e-5, layout='NCHW')
    assert y2.stride() == nchw.stride()
    np.testing.assert_allclose(y2.permute(0, 2, 3, 1).numpy(), y.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(m2.numpy(), m.numpy(), rtol=1e-6)


# ------------------------------------------------------------ the op
def _bn_program(pkg, layout, is_test, amp):
    """image -> conv2d (so that under AMP the op gets a raw bf16 X) ->
    batch_norm; SGD so that the training section runs."""
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        img = pkg.layers.data(name='img', shape=[3, 6, 6], dtype='float32')
        x = pkg.layers.transpose(img, [0, 2, 3, 1]) if layout == 'NHWC' \
            else img
        conv = pkg.layers.conv2d(x, num_filters=16, filter_size=3,
                                 padding=1, bias_attr=False,
                                 data_format=layout)
        y = pkg.layers.batch_norm(conv, is_test=is_test, data_layout=layout,
                                  momentum=0.8)
        loss = pkg.layers.mean(y)
        if not is_test:
            pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    main.amp = amp
    op = [o for o in main.global_block().ops if o.type == 'batch_norm'][0]
    slots = ['Y', 'MeanOut', 'VarianceOut'] + \
        ([] if is_test else ['SavedMean', 'SavedVariance'])
    return main, startup, [op.output(s) for s in slots]


def _run_op_pair(layout, is_test, amp):
    """Both packages from the JAX startup's weights (running statistics
    moved off 0 and 1 so that is_test reads something), one run; returns
    the fetches (numpy, dtype names) of each."""
    rng = np.random.RandomState(7)
    feed = {'img': rng.rand(8, 3, 6, 6).astype('float32')}
    jmain, jstart, fetch = _bn_program(fluid, layout, is_test, amp)
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(jscope):
        jexe.run(jstart)
    arrays = {n: np.asarray(jscope.find(n)) for n in jscope.keys()
              if jscope.find(n) is not None}
    for n in arrays:
        if n.endswith('.mean') or n.endswith('.variance'):
            arrays[n] = (rng.rand(16) * 0.5 + 0.5).astype('float32')
            jscope.set(n, jnp.asarray(arrays[n]))
    pmain, _, pfetch = _bn_program(pt, layout, is_test, amp)
    assert pfetch == fetch
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    load_into_scope(arrays, pscope, pt.CPUPlace())
    with fluid.scope_guard(jscope):
        ref = jexe.run(jmain, feed=feed, fetch_list=fetch, return_numpy=False)
    with pt.scope_guard(pscope):
        got = pexe.run(pmain, feed=feed, fetch_list=fetch, return_numpy=False)
    return ([(np.asarray(v.astype(jnp.float32)), str(v.dtype)) for v in ref],
            [(v.float().numpy(), str(v.dtype).replace('torch.', ''))
             for v in got])


@pytest.mark.parametrize('amp', [None, 'bf16'])
@pytest.mark.parametrize('is_test', [False, True])
@pytest.mark.parametrize('layout', ['NCHW', 'NHWC'])
def test_batch_norm_op_matches_jax(monkeypatch, layout, is_test, amp):
    """Y, MeanOut, VarianceOut (and in training SavedMean and
    SavedVariance) and their dtypes against the JAX op with its Pallas
    kernel. Y: fp32 1e-4 (one-pass statistics summed in another order);
    bf16 (raw bf16 X under AMP): one bf16 ulp. The statistics are fp32:
    1e-5 relative, and 1e-5 absolute for the variance."""
    monkeypatch.setenv('PADDLE_TPU_BN_PALLAS', '1')
    ref, got = _run_op_pair(layout, is_test, amp)
    assert [d for _, d in got] == [d for _, d in ref]
    assert ref[0][1] == ('bfloat16' if amp else 'float32')
    assert all(d == 'float32' for _, d in ref[1:])
    (gy, _), (ry, _) = got[0], ref[0]
    if amp:
        assert _within_ulp(gy, ry)
    else:
        np.testing.assert_allclose(gy, ry, rtol=1e-4, atol=1e-4)
    for (g, _), (r, _) in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('amp', [None, 'bf16'])
def test_batch_norm_op_matches_jax_default_path(monkeypatch, amp):
    """Against the JAX package's default (jnp, no Pallas) training path:
    it takes fp32 statistics in two passes (fp32), or under bf16 reduces
    the bf16 x and its bf16-rounded squares with XLA's own reductions, and
    rounds y at its own points, so the bound is looser: Y within 1e-4
    (fp32) or two bf16 ulps, the statistics within 1e-4 (fp32) or 1e-3
    (bf16, about 2^-9 of E[x²])."""
    monkeypatch.delenv('PADDLE_TPU_BN_PALLAS', raising=False)
    ref, got = _run_op_pair('NCHW', False, amp)
    assert [d for _, d in got] == [d for _, d in ref]
    (gy, _), (ry, _) = got[0], ref[0]
    if amp:
        diff = np.abs(gy.astype(np.float64) - ry)
        assert np.all(diff <= 2 * _bf16_ulp(np.maximum(np.abs(gy),
                                                       np.abs(ry))))
    else:
        np.testing.assert_allclose(gy, ry, rtol=1e-4, atol=1e-4)
    tol = 1e-3 if amp else 1e-4
    for (g, _), (r, _) in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g, r, rtol=tol, atol=tol)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_plain_matches_pallas_at_2048_channels(dtype):
    """C = 2048 (ResNet-50's stage-4 width: one launch with x staged on
    chip on the card) against the JAX package's Pallas kernel in
    interpret mode: mean rtol 1e-5, var rtol 1e-4 atol 1e-5; y fp32 1e-4,
    bf16 one bf16 ulp (the same rounding points on both sides)."""
    x, scale, bias, _ = _inputs((2, 2, 2, 2048), 2048, seed=31)
    jx = jnp.asarray(x).astype(dtype)
    jy, jm, jv = jbn.fused_batch_norm_train(jx, jnp.asarray(scale),
                                           jnp.asarray(bias), 1e-5,
                                           layout='NHWC')
    tdt = getattr(torch, dtype)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(tdt)
    ty, tm, tv = tbn.fused_batch_norm_train(tx, torch.tensor(scale),
                                            torch.tensor(bias), 1e-5,
                                            layout='NHWC')
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-5)
    y32 = np.asarray(jy.astype(jnp.float32))
    if dtype == 'float32':
        np.testing.assert_allclose(ty.numpy(), y32, rtol=1e-4, atol=1e-4)
    else:
        assert _within_ulp(ty.float().numpy(), y32)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_plain_matches_jax_reference_at_an_odd_row_count(dtype):
    """An odd row count (3 x 37 x 11 = 1221 rows, which the Pallas kernel
    refuses: it needs rows % 8 == 0) against the JAX package's jnp
    reference of the same kernel (_bn_reference): statistics as above; y
    fp32 1e-4; bf16 within one bf16 ulp each of x*a, b and y (the jnp
    reference rounds y once in fp32, the port at the Pallas kernel's
    points)."""
    x, scale, bias, _ = _inputs((3, 37, 11, 96), 96, seed=32)
    jx = jnp.asarray(x).astype(dtype)
    jy, jm, jv = jbn._bn_reference(jx.reshape(-1, 96), jnp.asarray(scale),
                                   jnp.asarray(bias), 1e-5)
    tdt = getattr(torch, dtype)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(tdt)
    ty, tm, tv = tbn.fused_batch_norm_train(tx, torch.tensor(scale),
                                            torch.tensor(bias), 1e-5,
                                            layout='NHWC')
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-5)
    y32 = np.asarray(jy.astype(jnp.float32)).reshape(x.shape)
    got = ty.float().numpy()
    if dtype == 'float32':
        np.testing.assert_allclose(got, y32, rtol=1e-4, atol=1e-4)
    else:
        xf = np.asarray(jx.astype(jnp.float32), np.float64)
        a = scale / np.sqrt(np.asarray(jv, np.float64) + 1e-5)
        b = bias - np.asarray(jm, np.float64) * a
        tol = _bf16_ulp(xf * a) + _bf16_ulp(b) + _bf16_ulp(y32)
        assert np.all(np.abs(got - y32) <= tol)
