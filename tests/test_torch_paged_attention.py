"""Port vs reference for ragged paged attention (K4): the port's plain
version against the JAX package's paged_attention_reference and against
its Pallas kernel _paged_pallas in interpret mode, on the same numpy
inputs — ragged page-crossing lengths, sentinel (>= NB) table entries
past the owned pages, broadcast prefill tables, fp32 and bf16 pages."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.ops.kernels import paged_attention as tpa


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_PALLAS_INTERPRET', '1')


def _case(b=4, h=2, nb=24, bs=8, p=4, d=16, seed=5, lens=(1, 9, 25, 32),
          broadcast=False):
    rng = np.random.RandomState(seed)
    k_pages = rng.randn(nb, h, bs, d).astype('float32')
    v_pages = rng.randn(nb, h, bs, d).astype('float32')
    q = rng.randn(b, h, d).astype('float32')
    if broadcast:
        tables = np.broadcast_to(rng.permutation(nb)[:p], (b, p))
    else:
        tables = rng.permutation(nb)[:b * p].reshape(b, p)
    return (q, k_pages, v_pages, np.ascontiguousarray(tables, np.int32),
            np.asarray(lens, np.int32)[:b])


def _jax(impl, q, kp, vp, tables, lens):
    args = [jnp.asarray(a) for a in (q, kp, vp, tables, lens)]
    if impl == 'pallas_interpret':
        return np.asarray(jpa._paged_pallas(*args, kp.shape[-1] ** -0.5)
                          .astype(jnp.float32))
    return np.asarray(jpa.paged_attention_reference(*args)
                      .astype(jnp.float32))


def _port(q, kp, vp, tables, lens, dtype=torch.float32, expand=False):
    t = torch.tensor(tables)
    if expand:      # the prefill's one table row, as a stride-0 view
        t = t[:1].expand(tables.shape[0], tables.shape[1])
    out = tpa.paged_attention(torch.tensor(q), torch.tensor(kp).to(dtype),
                              torch.tensor(vp).to(dtype), t,
                              torch.tensor(lens))
    return out.float().numpy()


@pytest.mark.parametrize('impl', ['reference', 'pallas_interpret'])
def test_fp32_ragged_page_crossing(impl):
    """fp32 everywhere: the two sides sum in different orders (the
    kernel online, page by page), so 2e-5 relative / 2e-6 absolute, as
    the JAX package's own kernel-vs-reference test."""
    args = _case()
    np.testing.assert_allclose(_port(*args), _jax(impl, *args),
                               rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize('impl', ['reference', 'pallas_interpret'])
def test_broadcast_prefill_table(impl):
    """Prefill rows share one table row (lengths cached+1 .. cached+S);
    the port takes it as a stride-0 view."""
    args = _case(b=6, lens=(5, 6, 7, 8, 9, 10), broadcast=True, seed=6)
    np.testing.assert_allclose(_port(*args, expand=True),
                               _jax(impl, *args), rtol=2e-5, atol=2e-6)


def test_sentinel_entries_past_owned_pages_do_not_leak():
    """Entries past a row's length, including the >= NB 'no page'
    sentinel, must not change the output (tests/test_pallas_kernels.py
    asserts the same of the JAX kernel)."""
    q, kp, vp, tables, lens = _case()
    base = _port(q, kp, vp, tables, lens)
    t2 = tables.copy()
    nb, bs = kp.shape[0], kp.shape[2]
    for i, n in enumerate(lens):
        t2[i, (int(n) + bs - 1) // bs:] = nb + 7
    np.testing.assert_array_equal(_port(q, kp, vp, t2, lens), base)


@pytest.mark.parametrize('impl', ['reference', 'pallas_interpret'])
def test_bf16_pages(impl):
    """bf16 pages with fp32 q: scores in fp32, weights rounded to bf16
    before w.v. The reference rounds the normalized weights and its
    output to bf16; the Pallas kernel rounds the running exp and keeps
    an fp32 output. Outputs are O(1), so one bf16 step (2^-8 relative)
    plus the weight rounding bounds the gap: 2e-2 relative, 1e-2
    absolute."""
    q, kp, vp, tables, lens = _case(seed=7)
    kb = jnp.asarray(kp).astype(jnp.bfloat16)
    vb = jnp.asarray(vp).astype(jnp.bfloat16)
    args = [jnp.asarray(q), kb, vb, jnp.asarray(tables), jnp.asarray(lens)]
    if impl == 'pallas_interpret':
        want = jpa._paged_pallas(*args, kp.shape[-1] ** -0.5)
    else:
        want = jpa.paged_attention_reference(*args)
    want = np.asarray(want.astype(jnp.float32))
    got = _port(q, np.asarray(kb.astype(jnp.float32)),
                np.asarray(vb.astype(jnp.float32)), tables, lens,
                dtype=torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=1e-2)


def test_bf16_plain_matches_reference_to_one_ulp():
    """Against the gather reference the port's plain version rounds at
    the same places (weights and output in bf16), so it agrees to one
    bf16 ulp."""
    q, kp, vp, tables, lens = _case(seed=8)
    kb = jnp.asarray(kp).astype(jnp.bfloat16)
    vb = jnp.asarray(vp).astype(jnp.bfloat16)
    want = np.asarray(jpa.paged_attention_reference(
        jnp.asarray(q), kb, vb, jnp.asarray(tables), jnp.asarray(lens))
        .astype(jnp.float32))
    got = _port(q, np.asarray(kb.astype(jnp.float32)),
                np.asarray(vb.astype(jnp.float32)), tables, lens,
                dtype=torch.bfloat16)
    a = np.maximum(np.abs(want.astype(np.float64)), 2.0 ** -126)
    ulp = 2.0 ** (np.floor(np.log2(a)) - 7)
    assert np.all(np.abs(got - want) <= ulp + 1e-6)
