"""Inputs the JAX op computes on its default path and the port once
refused: the port's fused_attention against the JAX package's
fused_attention with Pallas off (``reference_attention``), forward through
both packages' Executors and gradients through jax.vjp and torch autograd,
on the same numpy inputs, fp32, 1e-5:

* causal with Tq != Tk (the mask aligned bottom-right, tril(.., tk - tq));
* rows with no live key (kv_len 0, and the first Tq - Tk rows under the
  causal mask): the mean of V, dO / Tk to every key's dV;
* head dims above 128 (192 and 256) and above 256 (320, the wide
  kernels' head dim walked in chunks).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as fluid
from paddle_tpu.ops import attention_ops as jops

import paddle_tpu_torch as pt
from paddle_tpu_torch.ops import attention_ops as tops


@pytest.fixture(autouse=True)
def _default_path(monkeypatch):
    """The JAX op's default path: no Pallas, no tuning table."""
    monkeypatch.delenv('PADDLE_TPU_USE_PALLAS', raising=False)
    monkeypatch.delenv('PADDLE_TPU_AUTOTUNE', raising=False)


# (label, B, Tq, Tk, heads, head dim, causal, key lengths or None)
CASES = [
    ('causal Tq 48 < Tk 64', 2, 48, 64, 2, 16, True, None),
    ('causal Tq 64 > Tk 48 (16 dead rows)', 2, 64, 48, 2, 16, True, None),
    ('causal Tq 64 > Tk 48 with kv_len', 2, 64, 48, 2, 16, True, [40, 48]),
    ('a kv_len-0 row', 3, 24, 24, 2, 16, False, [24, 0, 7]),
    ('a kv_len-0 row, causal', 2, 24, 24, 2, 16, True, [0, 24]),
    ('head dim 192', 2, 20, 20, 2, 192, False, [20, 11]),
    ('head dim 256, causal', 2, 20, 20, 1, 256, True, None),
    ('head dim 320', 2, 20, 24, 2, 320, False, [24, 9]),
    ('head dim 320, causal Tq 24 > Tk 20', 2, 24, 20, 1, 320, True, None),
]


def _inputs(b, tq, tk, hd, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, tq, hd).astype('float32'),
            rng.randn(b, tk, hd).astype('float32'),
            rng.randn(b, tk, hd).astype('float32'),
            rng.randn(b, tq, hd).astype('float32'))


def _program(pkg, tq, tk, hd, n_head, causal, with_len):
    q = pkg.layers.data(name='q', shape=[tq, hd], dtype='float32')
    k = pkg.layers.data(name='k', shape=[tk, hd], dtype='float32')
    v = pkg.layers.data(name='v', shape=[tk, hd], dtype='float32')
    inputs = {'Q': [q], 'K': [k], 'V': [v]}
    if with_len:
        inputs['KeyLength'] = [pkg.layers.data(name='len', shape=[],
                                               dtype='int64')]
    helper = pkg.layers.helper.LayerHelper('fused_attention', name='attn')
    out = helper.create_variable_for_type_inference('float32')
    helper.append_op(type='fused_attention', inputs=inputs,
                     outputs={'Out': [out]},
                     attrs={'n_head': n_head, 'causal': causal,
                            'dropout_rate': 0.0})
    return out


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_fused_attention_op_matches_jax_default_path(case):
    _, b, tq, tk, h, d, causal, lens = case
    q, k, v, _ = _inputs(b, tq, tk, h * d, 11)
    feed = {'q': q, 'k': k, 'v': v}
    if lens is not None:
        feed['len'] = np.array(lens, 'int64')
    outs = []
    for pkg in (fluid, pt):
        pkg.reset_default_programs()
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            out = _program(pkg, tq, tk, h * d, h, causal, lens is not None)
        res, = pkg.Executor(pkg.CPUPlace()).run(main, feed=feed,
                                                fetch_list=[out])
        outs.append(np.asarray(res))
    assert outs[1].shape == (b, tq, h * d)
    assert np.isfinite(outs[1]).all()
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_fused_attention_gradients_match_jax_default_path(case):
    _, b, tq, tk, h, d, causal, lens = case
    q, k, v, do = _inputs(b, tq, tk, h * d, 12)
    jlens = None if lens is None else jnp.asarray(lens, jnp.int32)
    out, vjp = jax.vjp(lambda a, b_, c: jops.fused_attention(
        a, b_, c, h, causal=causal, key_length=jlens),
        *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]

    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    tlens = None if lens is None else torch.tensor(lens)
    got = tops.fused_attention(*leaves, h, causal=causal, key_length=tlens)
    grads = torch.autograd.grad(got, leaves, torch.tensor(do))
    for name, g, w in zip(('out', 'dq', 'dk', 'dv'),
                          [got.detach()] + list(grads), want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    if lens is not None and 0 in lens:
        # a row with no live key: the mean of V, no gradient to q or k
        i = lens.index(0)
        np.testing.assert_allclose(
            got[i].detach().numpy(),
            np.broadcast_to(v[i].mean(0), (tq, h * d)), rtol=1e-5,
            atol=1e-6)
        assert np.all(grads[0][i].numpy() == 0)
        assert np.all(grads[1][i].numpy() == 0)


def test_head_dim_above_256_is_the_one_refusal():
    """Head dims above 256 were the port's one refusal; the port now
    computes them as the JAX op does (head dim 264, 1e-5)."""
    q, k, v, _ = _inputs(1, 4, 4, 2 * 264, 13)
    got = tops.fused_attention(*(torch.tensor(x) for x in (q, k, v)), 2)
    want = jops.fused_attention(*(jnp.asarray(x) for x in (q, k, v)), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
