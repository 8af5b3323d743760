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
def test_head_dim_320(impl):
    """Key and value head dims of 320 (above the 256 the any-width kernel
    once stopped at), ragged lengths and a sentinel entry, fp32: the same
    bound as the other fp32 cases."""
    q, kp, vp, tables, lens = _case(d=320, seed=9, lens=(3, 17, 32, 1))
    tables = tables.copy()
    tables[3, 1:] = kp.shape[0]
    np.testing.assert_allclose(_port(q, kp, vp, tables, lens),
                               _jax(impl, q, kp, vp, tables, lens),
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


# ---- the split version: per-chunk partials merged in split order -------
# lengths: one token, around a page edge, exactly one 256-token chunk, one
# past it, every split live (P * bs), a ragged middle, and an empty slot
SPLIT_LENS = (1, 31, 32, 33, 256, 257, 2048, 700, 0)


def _split_case(seed=11, lens=SPLIT_LENS, h=2, nb=96, bs=32, p=64, d=16,
                broadcast=False):
    rng = np.random.RandomState(seed)
    b = len(lens)
    k_pages = rng.randn(nb, h, bs, d).astype('float32')
    v_pages = rng.randn(nb, h, bs, d).astype('float32')
    q = rng.randn(b, h, d).astype('float32')
    if broadcast:
        tables = np.broadcast_to(rng.randint(0, nb, p), (b, p))
    else:
        tables = rng.randint(0, nb, (b, p))
    tables = np.ascontiguousarray(tables, np.int32)
    lens = np.asarray(lens, np.int32)
    for i, n in enumerate(lens):        # "no page" past the owned pages
        if not broadcast:
            tables[i, (int(n) + bs - 1) // bs:] = nb + 1
    return q, k_pages, v_pages, tables, lens


def _split(q, kp, vp, tables, lens, dtype=torch.float32, expand=False):
    t = torch.tensor(tables)
    if expand:
        t = t[:1].expand(tables.shape[0], tables.shape[1])
    out = tpa.paged_attention_split_reference(
        torch.tensor(q), torch.tensor(kp).to(dtype),
        torch.tensor(vp).to(dtype), t, torch.tensor(lens))
    assert out.dtype == torch.float32
    return out.numpy()


def test_chunk_is_a_constant_of_the_block_size():
    """256 tokens a split whatever the batch: 8 pages at block 32, one
    page once a block holds 256 tokens or more."""
    assert tpa.CHUNK_TOKENS == 256
    assert [tpa.chunk_pages(bs) for bs in (8, 32, 48, 128, 256, 512)] == \
        [32, 8, 5, 2, 1, 1]


@pytest.mark.parametrize('impl', ['reference', 'pallas_interpret'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_split_version_matches_jax(impl, dtype):
    """The split version against the JAX package on lengths 1, 31, 32,
    33, a chunk boundary, 2,048 and an empty slot. fp32: the same sums in
    another order, 1e-5. bf16: p is rounded per chunk against the chunk's
    max (the reference rounds normalised weights and its output), so the
    bounds of the chip smoke: 2e-2 + 2e-2 * |want|. The empty slot gives
    0 (the JAX reference averages every gathered column there; the decode
    ops never ask for it)."""
    q, kp, vp, tables, lens = _split_case()
    jdt = getattr(jnp, dtype)
    kb = jnp.asarray(kp).astype(jdt)
    vb = jnp.asarray(vp).astype(jdt)
    args = [jnp.asarray(q), kb, vb, jnp.asarray(tables), jnp.asarray(lens)]
    if impl == 'pallas_interpret':
        want = jpa._paged_pallas(*args, kp.shape[-1] ** -0.5)
    else:
        want = jpa.paged_attention_reference(*args)
    want = np.asarray(want.astype(jnp.float32))
    got = _split(q, np.asarray(kb.astype(jnp.float32)),
                 np.asarray(vb.astype(jnp.float32)), tables, lens,
                 dtype=getattr(torch, dtype))
    live = lens > 0
    assert np.all(got[~live] == 0)
    if dtype == 'float32':
        np.testing.assert_allclose(got[live], want[live], rtol=1e-5,
                                   atol=1e-5)
    else:
        gap = np.abs(got[live] - want[live])
        assert np.all(gap <= 2e-2 + 2e-2 * np.abs(want[live])), gap.max()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('broadcast', [False, True])
def test_split_version_matches_plain_version(dtype, broadcast):
    """Both plain versions of the port on the same inputs, the broadcast
    prefill table (stride 0) included: fp32 1e-5; bf16 2e-2 + 2e-2 *
    |plain| (the one-pass version rounds its output to bf16)."""
    lens = SPLIT_LENS[:-1] if broadcast else SPLIT_LENS
    q, kp, vp, tables, lens = _split_case(seed=12, lens=lens,
                                          broadcast=broadcast)
    got = _split(q, kp, vp, tables, lens, dtype, expand=broadcast)
    want = _port(q, kp, vp, tables, lens, dtype, expand=broadcast)
    live = lens > 0
    if dtype == torch.float32:
        np.testing.assert_allclose(got[live], want[live], rtol=1e-5,
                                   atol=1e-5)
    else:
        gap = np.abs(got[live] - want[live])
        assert np.all(gap <= 2e-2 + 2e-2 * np.abs(want[live])), gap.max()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_split_version_rows_do_not_depend_on_the_batch(dtype):
    """A row's output is a pure function of its q, pages and length: the
    same row alone, in the 9-row batch and inside a 40-row call against
    its own table gives the same bits (the engine's concurrent-equals-
    alone and preempt-and-recompute invariants rest on this)."""
    q, kp, vp, tables, lens = _split_case(seed=13)
    full = _split(q, kp, vp, tables, lens, dtype)
    rng = np.random.RandomState(3)
    for i in (0, 4, 5, 6, 7):
        alone = _split(q[i:i + 1], kp, vp, tables[i:i + 1], lens[i:i + 1],
                       dtype)
        np.testing.assert_array_equal(alone[0], full[i])
        qs = rng.randn(40, *q.shape[1:]).astype('float32')
        ls = rng.randint(1, 2049, 40).astype('int32')
        qs[17], ls[17] = q[i], lens[i]
        row = np.where(tables[i] >= kp.shape[0], 3, tables[i]) \
            .astype('int32')
        many = _split(qs, kp, vp, np.broadcast_to(row, (40, row.size)).copy(),
                      ls, dtype, expand=True)
        np.testing.assert_array_equal(many[17], full[i])


# rows the 16-byte kernel cannot load, which the JAX package sends to its
# gather path: (page dtype, D, Dv)
ANY_WIDTH = [('bfloat16', 36, 36), ('float32', 30, 30),
             ('float32', 64, 192), ('bfloat16', 192, 192)]


@pytest.mark.parametrize('case', ANY_WIDTH)
def test_plain_versions_match_jax_gather_path_at_any_width(monkeypatch,
                                                           case):
    """Both plain versions of the port (the any-width kernel's) against
    the JAX package's paged_attention on its default, gather path (Pallas
    off), at a bf16 d_key of 36, an fp32 d_key of 30 and Dv 192. fp32: the
    same sums in another order, 1e-5; bf16: 2e-2 + 2e-2 * |want| (p
    rounded to bf16 at other points), the one-pass version to 1e-5 of the
    reference's own rounding. The empty slot gives 0."""
    monkeypatch.delenv('PADDLE_TPU_PAGED_PALLAS', raising=False)
    monkeypatch.delenv('PADDLE_TPU_USE_PALLAS', raising=False)
    dtype, d, dv = case
    rng = np.random.RandomState(d + dv)
    nb, h, bs, p = 40, 2, 8, 8
    kp = rng.randn(nb, h, bs, d).astype('float32')
    vp = rng.randn(nb, h, bs, dv).astype('float32')
    q = rng.randn(5, h, d).astype('float32')
    tables = rng.permutation(nb)[:5 * p].reshape(5, p).astype('int32')
    lens = np.array([1, 9, 33, 64, 0], 'int32')
    jdt = getattr(jnp, dtype)
    kb, vb = jnp.asarray(kp).astype(jdt), jnp.asarray(vp).astype(jdt)
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q), kb, vb, jnp.asarray(tables), jnp.asarray(lens))
        .astype(jnp.float32))
    assert want.shape == (5, h, dv)
    tdt = getattr(torch, dtype)
    args = (torch.tensor(q),
            torch.tensor(np.asarray(kb.astype(jnp.float32))).to(tdt),
            torch.tensor(np.asarray(vb.astype(jnp.float32))).to(tdt),
            torch.tensor(tables), torch.tensor(lens))
    one = tpa.paged_attention(*args).float().numpy()
    split = tpa.paged_attention_split_reference(*args).numpy()
    live = lens > 0
    assert np.all(split[~live] == 0)
    np.testing.assert_allclose(one, want, rtol=1e-5, atol=1e-5)
    if dtype == 'float32':
        np.testing.assert_allclose(split[live], want[live], rtol=1e-5,
                                   atol=1e-5)
    else:
        gap = np.abs(split[live] - want[live])
        assert np.all(gap <= 2e-2 + 2e-2 * np.abs(want[live])), gap.max()


# ---- quantized pages: int8 / e4m3 rows with one fp32 scale a row --------
QDTYPES = ['int8', 'float8_e4m3fn']


@pytest.mark.parametrize('kv_dtype', QDTYPES)
@pytest.mark.parametrize('version', ['one_pass', 'split'])
def test_quantized_plain_versions_match_jax_gather_path(kv_dtype, version):
    """int8 and e4m3 pages quantized by the JAX package's quantize_rows,
    their scales beside them: both plain versions of the port (the
    quantized kernel's) against the JAX paged_attention_reference(...,
    k_scales, v_scales), which dequantizes to fp32 before the attention.
    Every operand is then the same fp32 value on both sides, summed in
    another order: within 1e-5 of the largest value. An empty slot gives
    0 in the split version (the JAX reference averages there)."""
    from paddle_tpu.quant import core as jq
    rng = np.random.RandomState(21)
    nb, h, bs, d, p = 48, 2, 8, 8, 8
    kf = (rng.randn(nb, h, bs, d) * 3).astype('float32')
    vf = rng.randn(nb, h, bs, d).astype('float32')
    q = rng.randn(6, h, d).astype('float32')
    tables = rng.permutation(nb)[:6 * p].reshape(6, p).astype('int32')
    lens = np.array([1, 7, 8, 9, 64, 0], 'int32')
    tables[2, 1:] = nb + 5                # "no page" past the owned one
    kq, ks = jq.quantize_rows(jnp.asarray(kf), kv_dtype)
    vq, vs = jq.quantize_rows(jnp.asarray(vf), kv_dtype)
    want = np.asarray(jpa.paged_attention_reference(
        jnp.asarray(q), kq, vq, jnp.asarray(tables), jnp.asarray(lens),
        k_scales=ks, v_scales=vs))
    tdt = getattr(torch, kv_dtype)

    def port_pages(a):
        raw = np.asarray(a).view(np.uint8) if kv_dtype != 'int8' \
            else np.asarray(a)
        return torch.tensor(raw).view(tdt)

    fn = tpa.paged_attention if version == 'one_pass' else \
        tpa.paged_attention_split_reference
    got = fn(torch.tensor(q), port_pages(kq), port_pages(vq),
             torch.tensor(tables), torch.tensor(lens),
             k_scales=torch.tensor(np.asarray(ks)),
             v_scales=torch.tensor(np.asarray(vs))).numpy()
    assert got.dtype == np.float32
    live = lens > 0
    if version == 'split':
        assert np.all(got[~live] == 0)
    else:
        live[:] = True
    top = float(np.abs(want[live]).max())
    assert float(np.abs(got[live] - want[live]).max()) <= 1e-5 * top


def test_quantized_split_version_rows_do_not_depend_on_the_batch():
    """The quantized kernel's order of operations keeps a row's bits
    whatever its batch: one row alone and inside a 24-row call."""
    from paddle_tpu_torch.quant.core import quantize_rows
    q, kp, vp, tables, lens = _split_case(seed=14)
    kq, ks = quantize_rows(torch.tensor(kp), 'int8')
    vq, vs = quantize_rows(torch.tensor(vp), 'int8')
    kw = dict(k_scales=ks, v_scales=vs)
    full = tpa.paged_attention_split_reference(
        torch.tensor(q), kq, vq, torch.tensor(tables), torch.tensor(lens),
        **kw)
    for i in (1, 4, 6):
        alone = tpa.paged_attention_split_reference(
            torch.tensor(q[i:i + 1]), kq, vq, torch.tensor(tables[i:i + 1]),
            torch.tensor(lens[i:i + 1]), **kw)
        assert torch.equal(alone[0], full[i])
        qs = torch.randn(24, *q.shape[1:])
        ls = torch.randint(1, 2049, (24,), dtype=torch.int32)
        qs[5], ls[5] = torch.tensor(q[i]), int(lens[i])
        row = torch.tensor(np.where(tables[i] >= kp.shape[0], 3,
                                    tables[i]).astype('int32'))
        many = tpa.paged_attention_split_reference(
            qs, kq, vq, row.expand(24, row.numel()), ls, **kw)
        assert torch.equal(many[5], full[i])
