"""Port vs reference for flash attention (K2 forward, K3 backward) and the
layer norm's autograd Function (K1): the port's plain versions and its
autograd Function on the host against the JAX package's Pallas kernels in
interpret mode (out, and dq/dk/dv from jax.vjp), and the port's
fused_attention op against the JAX op's default path, on the same numpy
inputs."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as fluid
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import layer_norm as jln

import paddle_tpu_torch as pt
from paddle_tpu_torch.ops.attention_ops import reference_attention
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import layer_norm as tln


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_PALLAS_INTERPRET', '1')


def _inputs(b, h, t, d, kv, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(b, h, t, d).astype('float32')
                   for _ in range(4))
    lens = None
    if kv:
        lens = rng.randint(t // 2, t + 1, (b,)).astype('int32')
        lens[-1] = 1
    return q, k, v, do, lens


def _round(x, dtype):
    """x as the given dtype sees it (bf16-rounded values in fp32)."""
    return np.asarray(jnp.asarray(x).astype(dtype).astype(jnp.float32))


def _tol(dtype, ref):
    """fp32: the same sums in another order, 1e-5. bf16: outputs rounded
    to bf16, and p rounded to bf16 against the running max of each tile
    (Pallas) or the row max (plain), so 1e-2 of the largest value plus
    1e-2 relative."""
    if dtype == 'float32':
        return 1e-5
    return 1e-2 * np.abs(ref).max() + 1e-2 * np.abs(ref)


# (B, H, T, D, causal, kv_len): T = 40 is not a multiple of the kernels'
# 64-row tile (the Pallas blocks become 8), T = 128 is two tiles
CASES = [(2, 2, 40, 16, False, False), (2, 2, 40, 16, True, False),
         (3, 2, 40, 16, False, True), (3, 2, 40, 16, True, True),
         (2, 1, 128, 32, True, True)]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', CASES)
def test_plain_and_function_match_pallas_interpret(case, dtype):
    b, h, t, d, causal, kv = case
    q, k, v, do, lens = _inputs(b, h, t, d, kv)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(dtype) for a in (q, k, v, do))
    jlens = None if lens is None else jnp.asarray(lens)
    out, vjp = jax.vjp(lambda a, b_, c: jfa.flash_attention(
        a, b_, c, causal=causal, kv_len=jlens), jq, jk, jv)
    want = [np.asarray(x.astype(jnp.float32)) for x in (out,) + vjp(jdo)]

    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.tensor(_round(a, dtype)).to(tdt)
                       for a in (q, k, v, do))
    tlens = None if lens is None else torch.tensor(lens)
    o, lse = tfa.flash_attention_reference_fwd(tq, tk, tv, tlens, causal)
    grads = tfa.flash_attention_reference_bwd(tq, tk, tv, o, lse, tdo, tlens,
                                              causal)
    got = [x.float().numpy() for x in (o,) + grads]
    for g, w in zip(got, want):
        assert np.all(np.abs(g - w) <= _tol(dtype, w)), np.abs(g - w).max()
    if dtype == 'float32':
        # the port's composed reference_attention agrees (both align the
        # causal band bottom-right)
        ref = reference_attention(tq, tk, tv, causal=causal,
                                  key_length=tlens)
        np.testing.assert_allclose(ref.numpy(), got[0], rtol=1e-5,
                                   atol=1e-5)

    # the autograd Function takes the plain versions on the host
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    fo = tfa.flash_attention(*leaves, causal=causal, kv_len=tlens)
    fo.backward(tdo)
    assert fo.dtype == tdt
    torch.testing.assert_close(fo, o, rtol=0, atol=0)
    for leaf, g in zip(leaves, grads):
        torch.testing.assert_close(leaf.grad, g, rtol=0, atol=0)


def test_lse_and_short_rows():
    """lse is the log-sum-exp of the live scores; a row with kv_len 1
    attends to key 0 only; a row with kv_len 0 gives what the JAX op's
    default path (reference_attention) gives: the mean of V over all keys,
    with lse -1e9 + log(Tk)."""
    q, k, v, _, _ = _inputs(3, 1, 8, 4, False, seed=5)
    lens = torch.tensor([8, 1, 0])
    o, lse = tfa.flash_attention_reference_fwd(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), lens)
    s = np.einsum('bhqd,bhkd->bhqk', q, k) * 0.5
    np.testing.assert_allclose(lse[0].numpy(),
                               np.log(np.exp(s[0]).sum(-1)), rtol=1e-5)
    np.testing.assert_allclose(o[1].numpy(),
                               np.broadcast_to(v[1, :, :1], (1, 8, 4)),
                               rtol=1e-6)
    np.testing.assert_allclose(o[2].numpy(),
                               np.broadcast_to(v[2].mean(1, keepdims=True),
                                               (1, 8, 4)), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(lse[2].numpy(), -1e9 + np.log(8), rtol=1e-7)


def test_causal_needs_equal_lengths():
    """Causal with Tq != Tk is aligned bottom-right (query row i sees keys
    up to i + Tk - Tq), as reference_attention's tril(.., tk - tq); a head
    dim above 256, once refused, is taken too."""
    q, k, v, _, _ = _inputs(1, 2, 6, 8, False, seed=9)
    out = tfa.flash_attention(torch.tensor(q[:, :, :4]), torch.tensor(k),
                              torch.tensor(v), causal=True)
    want = reference_attention(torch.tensor(q[:, :, :4]), torch.tensor(k),
                               torch.tensor(v), causal=True)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    q, k, v, _, _ = _inputs(1, 1, 6, 264, False, seed=10)
    out = tfa.flash_attention(torch.tensor(q[:, :, :4]), torch.tensor(k),
                              torch.tensor(v), causal=True)
    want = reference_attention(torch.tensor(q[:, :, :4]), torch.tensor(k),
                               torch.tensor(v), causal=True)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def _attention_program(pkg, b, t, hd, n_head, causal, with_len):
    q = pkg.layers.data(name='q', shape=[t, hd], dtype='float32')
    k = pkg.layers.data(name='k', shape=[t, hd], dtype='float32')
    v = pkg.layers.data(name='v', shape=[t, hd], dtype='float32')
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


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('with_len', [False, True])
def test_fused_attention_op_matches_reference(causal, with_len):
    """The op on [B, T, H*D] inputs through each package's Executor:
    the port's flash path against the JAX op's default (reference_attention)
    path; fp32, 1e-5."""
    b, t, n_head, dh = 3, 12, 2, 8
    rng = np.random.RandomState(7)
    feed = {n: rng.randn(b, t, n_head * dh).astype('float32')
            for n in ('q', 'k', 'v')}
    if with_len:
        feed['len'] = np.array([12, 5, 1], 'int64')
    outs = []
    for pkg in (fluid, pt):
        pkg.reset_default_programs()
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            out = _attention_program(pkg, b, t, n_head * dh, n_head, causal,
                                     with_len)
        res, = pkg.Executor(pkg.CPUPlace()).run(main, feed=feed,
                                                fetch_list=[out])
        outs.append(np.asarray(res))
    assert outs[1].shape == (b, t, n_head * dh)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_layer_norm_function_matches_jax_vjp(dtype):
    """K1's autograd Function (plain forward on the host, rematerialised
    backward) against jax.vjp of the JAX package's fused_layer_norm: fp32
    1e-5; bf16 x: y and dx are rounded to bf16 once on each side, so one
    bf16 ulp (dgamma/dbeta stay fp32: 1e-4 of their size)."""
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 6, 32) * 2 + 0.5).astype('float32')
    g = (1 + 0.1 * rng.randn(32)).astype('float32')
    b = (0.1 * rng.randn(32)).astype('float32')
    gy = rng.randn(2, 6, 32).astype('float32')
    jx = jnp.asarray(x).astype(dtype)
    y, vjp = jax.vjp(lambda a, c, e: jln.fused_layer_norm(a, c, e, eps=1e-5,
                                                          begin_norm_axis=2),
                     jx, jnp.asarray(g), jnp.asarray(b))
    want = [np.asarray(w.astype(jnp.float32)) for w in
            (y,) + vjp(jnp.asarray(gy).astype(dtype))]

    tdt = getattr(torch, dtype)
    leaves = [torch.tensor(_round(x, dtype)).to(tdt).requires_grad_(),
              torch.tensor(g).requires_grad_(),
              torch.tensor(b).requires_grad_()]
    before = tln.fused_layer_norm.launches
    ty = tln.fused_layer_norm(*leaves, eps=1e-5, begin_norm_axis=2)
    ty.backward(torch.tensor(_round(gy, dtype)).to(tdt))
    assert tln.fused_layer_norm.launches == before
    got = [t.detach().float().numpy() for t in
           [ty] + [leaf.grad for leaf in leaves]]
    for i, (gv, wv) in enumerate(zip(got, want)):
        if dtype == 'float32':
            np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-5)
        elif i < 2:
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(wv),
                                                      1e-30))) - 7)
            assert np.all(np.abs(gv - wv) <= ulp + 1e-6)
        else:
            np.testing.assert_allclose(gv, wv, rtol=1e-4,
                                       atol=1e-4 * np.abs(wv).max())


# ---- the tiled version: 64-key tiles, online softmax, p rounded per tile
# (B, H, T, D, causal, kv_len): one tile with a tail, exactly one tile,
# several tiles with a tail
TILED_CASES = CASES + [(2, 2, 64, 16, True, False),
                       (2, 1, 200, 32, False, True)]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', TILED_CASES)
def test_tiled_version_matches_pallas_interpret_and_plain(case, dtype):
    """flash_attention_tiled_reference_fwd (the tensor-core kernel's order
    of operations) against the JAX package's forward kernel in interpret
    mode and against the port's whole-row plain version: fp32 1e-5; bf16
    1e-2 of the largest value plus 1e-2 relative (p rounded per tile
    against the running max); lse within 1e-5 of the plain version's."""
    b, h, t, d, causal, kv = case
    q, k, v, _, lens = _inputs(b, h, t, d, kv, seed=3)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    jlens = None if lens is None else jnp.asarray(lens)
    want = np.asarray(jfa.flash_attention(jq, jk, jv, causal=causal,
                                          kv_len=jlens).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.tensor(_round(a, dtype)).to(tdt) for a in (q, k, v))
    tlens = None if lens is None else torch.tensor(lens)
    out, lse = tfa.flash_attention_tiled_reference_fwd(tq, tk, tv, tlens,
                                                       causal)
    ref_out, ref_lse = tfa.flash_attention_reference_fwd(tq, tk, tv, tlens,
                                                         causal)
    assert out.dtype == tdt and lse.dtype == torch.float32
    got = out.float().numpy()
    assert np.all(np.abs(got - want) <= _tol(dtype, want))
    plain = ref_out.float().numpy()
    assert np.all(np.abs(got - plain) <= _tol(dtype, plain))
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_tiled_version_rows_without_a_live_key():
    """kv_len 0 gives the mean of V and lse -1e9 + log(Tk), as the kernels
    and reference_attention do; a tile size that does not divide T changes
    nothing beyond rounding."""
    q, k, v, _, _ = _inputs(3, 2, 150, 8, False, seed=6)
    lens = torch.tensor([150, 70, 0])
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    out, lse = tfa.flash_attention_tiled_reference_fwd(tq, tk, tv, lens)
    np.testing.assert_allclose(out[2].numpy(),
                               np.broadcast_to(v[2].mean(1, keepdims=True),
                                               (2, 150, 8)), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(lse[2].numpy(), -1e9 + np.log(150), rtol=1e-7)
    other, lse2 = tfa.flash_attention_tiled_reference_fwd(tq, tk, tv, lens,
                                                          tile=32)
    np.testing.assert_allclose(out.numpy(), other.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), lse2.numpy(), rtol=1e-6)


# ---- the backward at the shapes K3's tensor-core pair takes: head dims
# 16, 32 and 64 (multiples of 16), T = 200 (three full 64-row tiles and a
# tail of 8), and a row whose kv_len is 1
BWD_TC_CASES = [(2, 1, 200, 16, False, True), (2, 1, 200, 32, True, True),
                (2, 1, 200, 64, True, True), (2, 1, 200, 64, False, False)]


@pytest.mark.parametrize('case', BWD_TC_CASES)
def test_backward_plain_matches_pallas_at_tensor_core_shapes(case):
    """flash_attention_reference_bwd (bf16 inputs) against jax.vjp of the
    JAX package's flash attention, its Pallas backward kernels in
    interpret mode: 1e-2 of the largest value plus 1e-2 relative (dq, dk,
    dv rounded to bf16; p and ds rounded to bf16 on both sides from scores
    summed in another order). delta = rowsum(dO * O) is formed from the
    forward's own output on each side."""
    b, h, t, d, causal, kv = case
    q, k, v, do, lens = _inputs(b, h, t, d, kv, seed=21)
    dtype = 'bfloat16'
    jq, jk, jv, jdo = (jnp.asarray(a).astype(dtype) for a in (q, k, v, do))
    jlens = None if lens is None else jnp.asarray(lens)
    _, vjp = jax.vjp(lambda a, b_, c: jfa.flash_attention(
        a, b_, c, causal=causal, kv_len=jlens), jq, jk, jv)
    want = [np.asarray(x.astype(jnp.float32)) for x in vjp(jdo)]
    tq, tk, tv, tdo = (torch.tensor(_round(a, dtype)).to(torch.bfloat16)
                       for a in (q, k, v, do))
    tlens = None if lens is None else torch.tensor(lens)
    o, lse = tfa.flash_attention_reference_fwd(tq, tk, tv, tlens, causal)
    got = tfa.flash_attention_reference_bwd(tq, tk, tv, o, lse, tdo, tlens,
                                            causal)
    for g, w in zip(got, want):
        g = g.float().numpy()
        assert np.all(np.abs(g - w) <= _tol(dtype, w)), np.abs(g - w).max()
    if lens is not None:
        # the kv_len-1 row attends to key 0 only: every later key of that
        # example gets no gradient
        assert lens[-1] == 1
        assert np.all(got[1][-1, :, 1:].float().numpy() == 0)
        assert np.all(got[2][-1, :, 1:].float().numpy() == 0)
