"""Dropout on the port's training path (ops/kernels/random_bits.py): the
fused pass's plain version against the torch expressions it replaces,
forward and backward through autograd, bit for bit (signed zeros, inf and
NaN included); the dropout op writing its Mask only where it is read; the
backward drawing the forward's bits; run_steps against run for a small
Transformer at dropout 0.1, unrolled and scan_layers; and the dropout
op's semantics, forward and gradient, beside the JAX package's (each with
its own bits: the two packages draw differently)."""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.registry import op_key
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.ops.kernels import random_bits as rb

CPU = torch.device('cpu')
SPECIAL = [0.0, -0.0, float('inf'), -float('inf'), float('nan'), 1e-30,
           -3.5]


def _bits(t):
    """The raw bits of a float tensor (NaN-safe equality)."""
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32
                               else torch.int16)


def _input(shape, dtype, seed):
    """Random values with ±0, ±inf, NaN and a tiny value at the front."""
    x = torch.from_numpy(np.random.RandomState(seed).randn(
        int(np.prod(shape))).astype('float32'))
    x[:len(SPECIAL)] = torch.tensor(SPECIAL)
    return x.reshape(shape).to(dtype)


def _today(x, mode, keep, key, step):
    """The torch expression each call site computed before the fused
    pass, over keep_mask_reference."""
    if mode == 'where_div':
        m = rb.keep_mask_reference(x.shape, keep, key, step, CPU)
        return torch.where(m, x / keep, torch.zeros((), dtype=x.dtype))
    m = rb.keep_mask_reference(x.shape, keep, key, step, CPU, x.dtype)
    return x * m if mode == 'mul' else (x * m) / keep


@pytest.mark.parametrize('shape', [(3, 5, 7), (37, 3)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('mode', rb.MODES)
def test_plain_dropout_equals_todays_expression(mode, dtype, shape):
    """Forward and backward (through DropoutApply and autograd) equal
    today's expression under autograd, bit for bit, at two steps; the
    direct plain calls give the same bits."""
    keep, key = 0.7, op_key(3, 11)
    for step_value in (0, 5):
        step = torch.tensor(step_value)
        x = _input(shape, dtype, 1 + step_value)
        dy = _input(shape, dtype, 2 + step_value).flip(-1)
        xa = x.clone().requires_grad_()
        want = _today(xa, mode, keep, key, step)
        want_dx, = torch.autograd.grad(want, xa, dy)
        xb = x.clone().requires_grad_()
        got = rb.DropoutApply.apply(xb, mode, keep, key, step)
        got_dx, = torch.autograd.grad(got, xb, dy)
        assert got.dtype == dtype and got_dx.dtype == dtype
        assert torch.equal(_bits(got), _bits(want.detach()))
        assert torch.equal(_bits(got_dx), _bits(want_dx))
        assert torch.equal(_bits(rb.fused_dropout(x, mode, keep, key, step)),
                           _bits(want.detach()))
        assert torch.equal(_bits(rb.fused_dropout(dy, mode, keep, key, step,
                                                  backward=True)),
                           _bits(want_dx))


def test_dropout_function_saves_only_the_step():
    """The autograd node holds the step tensor and no tensor of x's
    size."""
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    x = torch.randn(4, 33, requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = rb.DropoutApply.apply(x, 'mul_div', 0.9, 7, torch.tensor(2))
    assert saved == [()]
    y.sum().backward()
    assert x.grad is not None


def test_dropout_kernel_wrapper_raises_on_what_it_does_not_take():
    """The CUDA wrapper's checks, which run before any launch: fp16, a
    non-contiguous input, an unknown mode, a step of the wrong type."""
    step = torch.tensor(0)
    with pytest.raises(TypeError):
        rb._dropout_cuda(torch.zeros(8, dtype=torch.float16), 'mul', 0.9, 1,
                         step, False)
    with pytest.raises(TypeError):
        rb._dropout_cuda(torch.zeros(8, 4).t(), 'mul', 0.9, 1, step, False)
    with pytest.raises(ValueError):
        rb._dropout_cuda(torch.zeros(8), 'scale', 0.9, 1, step, False)
    with pytest.raises(ValueError):
        rb._dropout_cuda(torch.zeros(8), 'mul', 0.9, 1, step.int(), False)
    with pytest.raises(ValueError):
        rb.dropout_reference(torch.zeros(8), 'scale', 0.9, 1, step)


def _dropout_train(p, impl, seed=4):
    """x [16, 16] -> fc(12, no bias, 'dw') -> dropout -> sum(out * y)
    under SGD(0): the dropout op's input, output, Mask and dw's gradient
    can be fetched. With x the identity, h is dw and dw's gradient is the
    dropout input's, exactly."""
    pt.reset_default_programs()
    main = pt.default_main_program()
    main.random_seed = seed
    x = pt.layers.data(name='x', shape=[16], dtype='float32')
    y = pt.layers.data(name='y', shape=[12], dtype='float32')
    h = pt.layers.fc(input=x, size=12, bias_attr=False,
                     param_attr=pt.ParamAttr(name='dw'))
    out = pt.layers.dropout(h, dropout_prob=p, dropout_implementation=impl)
    op = main.global_block().ops[-1]
    cost = pt.layers.reduce_sum(pt.layers.elementwise_mul(out, y))
    pt.optimizer.SGD(learning_rate=0.0).minimize(cost)
    return main, op, h, out, cost


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    return {'x': np.eye(16, dtype='f'),
            'y': rng.randn(16, 12).astype('f')}


@pytest.mark.parametrize('impl', ['downgrade_in_infer', 'upscale_in_train'])
def test_dropout_op_writes_mask_only_when_read(monkeypatch, impl):
    """A training step that does not read Mask draws no mask; fetching
    Mask gives the keep mask of (seed, step, op) in x's dtype, and the
    output is today's: x * mask (/ (1 - p) under upscale_in_train)."""
    calls = []
    real = rb.keep_mask_reference

    def counted(*args, **kw):
        calls.append(args[0])
        return real(*args, **kw)

    monkeypatch.setattr(rb, 'keep_mask_reference', counted)
    p = 0.3
    main, op, h, out, cost = _dropout_train(p, impl)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(pt.default_startup_program())
        exe.set_step(3)
        exe.run(main, feed=_feed(), fetch_list=[cost, out])
        assert calls == []
        hv, ov, mv = exe.run(main, feed=_feed(),
                             fetch_list=[h, out, op.output('Mask')])
    assert len(calls) == 1
    index = main.global_block().ops.index(op)
    want = rb.keep_mask_reference((16, 12), 1.0 - p,
                                  op_key(main.random_seed, index),
                                  torch.tensor(4), CPU, torch.float32)
    assert mv.dtype == np.float32
    np.testing.assert_array_equal(mv, want.numpy())
    ht = torch.from_numpy(hv)
    want_out = ht * want if impl == 'downgrade_in_infer' else \
        (ht * want) / (1.0 - p)
    np.testing.assert_array_equal(ov, want_out.numpy())


@pytest.mark.parametrize('impl', ['downgrade_in_infer', 'upscale_in_train'])
def test_backward_draws_the_forwards_bits(impl):
    """Over two consecutive runs (steps 5 and 6), the gradient reaching
    the dropout's input is dy * m (dy / (1 - p) * m under
    upscale_in_train) with the m of that run's forward step, and the two
    steps' bits differ."""
    p = 0.4
    main, op, h, out, cost = _dropout_train(p, impl)
    index = main.global_block().ops.index(op)
    feed = _feed(1)
    exe = pt.Executor(pt.CPUPlace())
    masks = []
    with pt.scope_guard(pt.Scope()):
        exe.run(pt.default_startup_program())
        exe.set_step(5)
        for step in (5, 6):
            gw, = exe.run(main, feed=feed, fetch_list=['dw@GRAD'])
            m = rb.keep_mask_reference((16, 12), 1.0 - p,
                                       op_key(main.random_seed, index),
                                       torch.tensor(step), CPU,
                                       torch.float32)
            dy = torch.from_numpy(feed['y'])
            dh = dy * m if impl == 'downgrade_in_infer' else \
                (dy / (1.0 - p)) * m
            np.testing.assert_array_equal(gw, dh.numpy())
            masks.append(m)
    assert not torch.equal(masks[0], masks[1])


def _transformer(scan):
    pt.reset_default_programs()
    avg_cost, _ = T.transformer_base(
        src_vocab_size=48, trg_vocab_size=48, src_seq_len=8, trg_seq_len=8,
        n_layer=2, n_head=2, d_key=8, d_value=8, d_model=16, d_inner=32,
        dropout_rate=0.1, scan_layers=scan)
    pt.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
    return avg_cost


@pytest.mark.parametrize('scan', [False, True])
def test_transformer_run_steps_equals_run_at_dropout(scan, monkeypatch):
    """A 2-layer Transformer at dropout 0.1 (unrolled, then scan_layers):
    run_steps(3) equals 3 run calls bit for bit in the losses and every
    scope variable, no mask is drawn, and the dropout moved the loss."""
    calls = []
    real = rb.keep_mask_reference
    monkeypatch.setattr(rb, 'keep_mask_reference',
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    avg_cost = _transformer(scan)
    main = pt.default_main_program()
    host = pt.Scope()
    with pt.scope_guard(host):
        pt.Executor(pt.CPUPlace()).run(pt.default_startup_program())
    weights = {n: host.numpy(n) for n in host.keys()}
    feed = T.make_fake_batch(3, 8, 8, 48, 48, seed=2)
    from paddle_tpu_torch.weights import load_into_scope
    res = []
    for mode in ('run', 'run_steps'):
        scope = pt.Scope()
        load_into_scope(weights, scope, pt.CPUPlace())
        exe = pt.Executor(pt.CPUPlace())
        with pt.scope_guard(scope):
            if mode == 'run':
                losses = np.array([exe.run(main, feed=feed,
                                           fetch_list=[avg_cost])[0]
                                   .reshape(()) for _ in range(3)])
            else:
                losses = exe.run_steps(3, main, feed=feed,
                                       fetch_list=[avg_cost])[0].reshape(-1)
        res.append((losses, {n: scope.numpy(n) for n in scope.keys()}))
    assert calls == []
    assert np.isfinite(res[0][0]).all()
    np.testing.assert_array_equal(res[1][0], res[0][0])
    for n, v in res[0][1].items():
        np.testing.assert_array_equal(res[1][1][n], v, err_msg=n)
    # the same weights at dropout 0 give another first loss
    pt.reset_default_programs()
    avg0, _ = T.transformer_base(
        src_vocab_size=48, trg_vocab_size=48, src_seq_len=8, trg_seq_len=8,
        n_layer=2, n_head=2, d_key=8, d_value=8, d_model=16, d_inner=32,
        dropout_rate=0.0, scan_layers=scan)
    scope = pt.Scope()
    load_into_scope(weights, scope, pt.CPUPlace())
    with pt.scope_guard(scope):
        first = pt.Executor(pt.CPUPlace()).run(
            pt.default_main_program(), feed=feed, fetch_list=[avg0])[0]
    assert float(first.reshape(())) != float(res[0][0][0])


@pytest.mark.parametrize('impl', ['downgrade_in_infer', 'upscale_in_train'])
def test_dropout_op_semantics_beside_the_jax_package(impl):
    """In each package, with its own bits: Out = X * Mask (/ (1 - p)
    under upscale_in_train), Mask in {0, 1} keeping about 1 - p, and the
    gradient of the dropout's input is dy * Mask (dy / (1 - p) * Mask),
    read through dw's gradient, within fp32 rounding of the matmul."""
    rng = np.random.RandomState(2)
    p, feed = 0.3, {'x': rng.randn(16, 8).astype('f'),
                    'y': rng.randn(16, 12).astype('f')}
    for pkg in (fluid, pt):
        pkg.reset_default_programs()
        main = pkg.default_main_program()
        x = pkg.layers.data(name='x', shape=[8], dtype='float32')
        y = pkg.layers.data(name='y', shape=[12], dtype='float32')
        h = pkg.layers.fc(input=x, size=12, bias_attr=False,
                          param_attr=pkg.ParamAttr(name='dw'))
        out = pkg.layers.dropout(h, dropout_prob=p,
                                 dropout_implementation=impl)
        mask = main.global_block().ops[-1].output('Mask')
        cost = pkg.layers.mean(pkg.layers.elementwise_mul(out, y))
        pkg.optimizer.SGD(learning_rate=0.0).minimize(cost)
        exe = pkg.Executor(pkg.CPUPlace())
        with pkg.scope_guard(pkg.Scope()):
            exe.run(pkg.default_startup_program())
            hv, ov, mv, gw = [np.asarray(v, 'float32') for v in exe.run(
                main, feed=feed, fetch_list=[h, out, mask, 'dw@GRAD'])]
        scale = 1.0 if impl == 'downgrade_in_infer' else 1.0 / (1.0 - p)
        assert set(np.unique(mv)) <= {0.0, 1.0}
        assert abs(float(mv.mean()) - (1.0 - p)) < 0.15
        np.testing.assert_allclose(ov, hv * mv * scale, rtol=1e-6)
        want = feed['x'].T @ (feed['y'] / (16 * 12) * mv * scale)
        np.testing.assert_allclose(gw, want, rtol=1e-5, atol=1e-7)
