"""Port vs reference for a decode layer's KV write and paged attention
(K4), ``paged_decode_ops.write_attend``: the write folded into K4's launch
(``paged_attention_write``: each kept row's new K/V written, the positions
the rows write read from the input) for the decode and verify steps on
arenas of the new rows' dtype, else the stand-alone write (``kv_write``,
quantized with its scale on int8 / e4m3 arenas) and then K4. On the CPU
both are the composition ``kv_write_reference`` then
``paged_attention_reference``; here they are held against the JAX
package's ``_write_positions`` / ``_write_scales`` and its Pallas kernel
in interpret mode (or ``paged_attention_reference`` with scales, for int8
and fp8 arenas), on the same numpy inputs, for the decode step's, the
verify step's (k + 1 = 4) and the broadcast prefill's row sets, each with
dropped rows, at head dims 16 and 36. The plain model of the fused
kernel's own order, ``paged_attention_write_split_reference`` (fresh keys
from the input), is held against write-then-attend in split order, bit
for bit on the rows that read only kept rows; the fold refuses rows it
would have to convert; and the decode ops fold exactly where they
should."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.ops import paged_decode_ops as jpd
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.quant import core as jq
import paddle_tpu_torch as pt
from paddle_tpu_torch.ops import paged_decode_ops as tpd
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.ops.paged_decode_ops import write_attend, write_slots
from paddle_tpu_torch.quant import core as tq
from paddle_tpu_torch.serving.decode import (DecodeEngine, LMSpec,
                                             random_weights)

KV_DTYPES = ['float32', 'bfloat16', 'int8', 'float8_e4m3fn']
# the arenas the fold takes: new rows of the arena's own dtype
DIRECT = ['float32', 'bfloat16']
ROW_SETS = ['decode', 'verify', 'prefill']
NB, H, BS, P = 24, 3, 8, 4


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_PALLAS_INTERPRET', '1')


def _row_set(kind, rng):
    """(tables [N, P], pos [N], live [N], fresh_lo [N], fresh_src [N]) as
    the decode ops make them, numpy int32 / bool; each set has rows whose
    writes drop."""
    perm = rng.permutation(NB).astype('int32')
    if kind == 'decode':
        # four sequences and an empty slot (length 0, every entry >= NB)
        lens = np.array([3, 8, 17, 30, 0], 'int32')
        tables = perm[:5 * P].reshape(5, P).copy()
        for i, n in enumerate(lens):
            tables[i, (int(n) + BS) // BS:] = NB + 3
        tables[4] = NB
        n = lens.size
        return (tables, lens, np.ones(n, bool), lens.copy(),
                np.arange(n, dtype='int32'))
    if kind == 'verify':
        # three sequences and an empty slot, k + 1 = 4 rows each; the
        # third's last row sits past the table's capacity
        lens = np.array([5, 14, 29, 0], 'int32')
        k1 = 4
        tables = perm[:4 * P].reshape(4, P).copy()
        for i, n in enumerate(lens):
            tables[i, (int(n) + k1 - 1 + BS) // BS:] = NB + 3
        tables[3] = NB
        rep = np.repeat(np.arange(4), k1)
        pos = (lens[:, None] + np.arange(k1)[None, :]).reshape(-1)
        return (np.ascontiguousarray(tables[rep]), pos.astype('int32'),
                np.ones(pos.size, bool), lens[rep].copy(),
                (rep * k1).astype('int32'))
    # prefill: 12 padded rows after 5 cached tokens, Len 9 (rows 9.. are
    # not live), one table row
    s, cached, length = 12, 5, 9
    row = perm[:P].copy()
    row[-(-(cached + s) // BS):] = NB + 3
    t = np.arange(s, dtype='int32')
    return (np.broadcast_to(row, (s, P)), (cached + t).astype('int32'),
            t < length, np.full(s, cached, 'int32'),
            np.zeros(s, 'int32'))


def _comparable(pos, keep, fresh_lo, fresh_src):
    """Rows that are kept and read from the input only kept rows (the
    rows the fused kernel must match write-then-attend on)."""
    ok = keep.copy()
    for r in range(pos.size):
        for t in range(int(fresh_lo[r]), min(int(pos[r]) + 1, P * BS)):
            ok[r] &= bool(keep[fresh_src[r] + t - fresh_lo[r]])
    return ok


def _case(kind, kv_dtype, d, seed, src=torch.float32):
    """Arenas (the port's tensors), the row set and the new rows."""
    rng = np.random.RandomState(seed)
    tables, pos, live, fresh_lo, fresh_src = _row_set(kind, rng)
    n = pos.size
    dv = d + 4
    kf = rng.randn(NB, H, BS, d).astype('float32')
    vf = rng.randn(NB, H, BS, dv).astype('float32')
    t = dict(q=torch.tensor(rng.randn(n, H, d).astype('float32')),
             k_new=torch.tensor(3 * rng.randn(n, H, d).astype('float32'))
             .to(src),
             v_new=torch.tensor(rng.randn(n, H, dv).astype('float32'))
             .to(src))
    if tq.kv_quantized(kv_dtype):
        t['kp'], t['ks'] = tq.quantize_rows(torch.tensor(kf), kv_dtype)
        t['vp'], t['vs'] = tq.quantize_rows(torch.tensor(vf), kv_dtype)
    else:
        dt = getattr(torch, kv_dtype)
        t['kp'], t['vp'] = torch.tensor(kf).to(dt), torch.tensor(vf).to(dt)
        t['ks'] = t['vs'] = None
    t['tables'] = torch.tensor(np.ascontiguousarray(tables))
    if kind == 'prefill':            # one table row, stride 0
        t['tables'] = t['tables'][:1].expand(n, P)
    t['lens'] = torch.tensor(pos + 1)
    phys, off, keep = write_slots(t['tables'], torch.tensor(pos),
                                  torch.tensor(live), NB, BS)
    t.update(phys=phys, off=off, keep=keep,
             fresh_lo=torch.tensor(fresh_lo),
             fresh_src=torch.tensor(fresh_src))
    t['ok'] = _comparable(pos, keep.numpy(), fresh_lo, fresh_src)
    return t


def _arenas(t):
    return [x.clone() if x is not None else None
            for x in (t['kp'], t['vp'], t['ks'], t['vs'])]


def _raw(x):
    return x.view(torch.uint8) if x.element_size() == 1 else x


def _port_write(t, kind):
    """The decode op's layer (``write_attend``), folded as the op folds:
    the decode and verify steps on arenas of the new rows' dtype."""
    kp, vp, ks, vs = _arenas(t)
    fold = kind != 'prefill' and t['k_new'].dtype == kp.dtype
    out = write_attend(t['q'], t['k_new'], t['v_new'], kp, vp, t['tables'],
                       t['lens'], t['phys'], t['off'], t['keep'],
                       (t['fresh_lo'], t['fresh_src']) if fold else None,
                       ks, vs)
    return out.float().numpy(), (kp, vp, ks, vs)


def _jax_pages(x, kv_dtype):
    """A port arena as the JAX package's array (same bits)."""
    if kv_dtype == 'float8_e4m3fn':
        return jnp.asarray(x.view(torch.uint8).numpy()).view(
            jnp.float8_e4m3fn)
    if kv_dtype == 'bfloat16':
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _jax_write(t, kv_dtype):
    """The JAX package's write (dropped rows sent to phys = NB, as its
    _extend_rows does) then its attention: the Pallas kernel in interpret
    mode for fp32 / bf16 pages, the gather path with scales for int8 and
    fp8. Returns (output [N, H, Dv] fp32, the four arenas)."""
    keep = t['keep'].numpy()
    phys = jnp.asarray(np.where(keep, t['phys'].numpy(), NB))
    off = jnp.asarray(t['off'].numpy())
    kc, vc = (_jax_pages(t[k], kv_dtype) for k in ('kp', 'vp'))
    k_new = jnp.asarray(t['k_new'].numpy())
    v_new = jnp.asarray(t['v_new'].numpy())
    tables = jnp.asarray(np.ascontiguousarray(t['tables'].numpy()))
    q = jnp.asarray(t['q'].numpy())
    lens = jnp.asarray(t['lens'].numpy())
    if tq.kv_quantized(kv_dtype):
        kq, ksr = jq.quantize_rows(k_new, kv_dtype)
        vq, vsr = jq.quantize_rows(v_new, kv_dtype)
        kc = jpd._write_positions(kc, kq, phys, off)
        vc = jpd._write_positions(vc, vq, phys, off)
        ks = jpd._write_scales(jnp.asarray(t['ks'].numpy()), ksr, phys, off)
        vs = jpd._write_scales(jnp.asarray(t['vs'].numpy()), vsr, phys, off)
        out = jpa.paged_attention_reference(q, kc, vc, tables, lens,
                                            k_scales=ks, v_scales=vs)
        scales = [np.asarray(ks), np.asarray(vs)]
    else:
        kc = jpd._write_positions(kc, k_new.astype(kc.dtype), phys, off)
        vc = jpd._write_positions(vc, v_new.astype(vc.dtype), phys, off)
        out = jpa._paged_pallas(q, kc, vc, tables, lens,
                                kc.shape[-1] ** -0.5)
        scales = [None, None]
    return np.asarray(out.astype(jnp.float32)), [kc, vc] + scales


def _same_arena(port, jax_arena):
    """One arena (or scale arena) of each package, bit for bit."""
    if jax_arena is None:
        return port is None
    if port.element_size() == 1:
        return np.array_equal(port.view(torch.uint8).numpy(),
                              np.asarray(jax_arena).view(np.uint8))
    return np.array_equal(port.float().numpy(),
                          np.asarray(jnp.asarray(jax_arena)
                                     .astype(jnp.float32)))


@pytest.mark.parametrize('d', [16, 36])
@pytest.mark.parametrize('kind', ROW_SETS)
@pytest.mark.parametrize('kv_dtype', KV_DTYPES)
def test_write_matches_jax_write_then_attend(kv_dtype, kind, d):
    """The port's layer write and attention (the CPU path; fp32 new rows,
    so the fp32 arenas' decode and verify rows take the fold) against the
    JAX package's write-then-attend: every arena and scale bit for bit, and
    the outputs of the rows that read only kept rows within the
    tolerances of tests/test_torch_paged_attention.py: fp32 2e-5 relative
    and 2e-6 absolute; bf16 2e-2 and 1e-2 (the plain version rounds its
    weights and output to bf16, the kernel its running exp); int8 and fp8
    1e-5 of the largest value (the same dequantized operands in another
    order)."""
    t = _case(kind, kv_dtype, d, seed=100 + d + ROW_SETS.index(kind))
    assert 0 < t['ok'].sum() < t['ok'].size     # some rows drop
    got, arenas = _port_write(t, kind)
    want, jarenas = _jax_write(t, kv_dtype)
    for a, b in zip(arenas, jarenas):
        assert _same_arena(a, b)
    ok = t['ok']
    if kv_dtype == 'float32':
        np.testing.assert_allclose(got[ok], want[ok], rtol=2e-5, atol=2e-6)
    elif kv_dtype == 'bfloat16':
        np.testing.assert_allclose(got[ok], want[ok], rtol=2e-2, atol=1e-2)
    else:
        top = float(np.abs(want[ok]).max())
        assert float(np.abs(got[ok] - want[ok]).max()) <= 1e-5 * top


def _composition_split(t):
    """Write-then-attend in the split kernel's order (the unfused launch's
    plain version): kv_write_reference then
    paged_attention_split_reference."""
    kp, vp, ks, vs = _arenas(t)
    tpa.kv_write_reference(t['k_new'], t['v_new'], kp, vp, t['phys'],
                           t['off'], t['keep'], ks, vs)
    out = tpa.paged_attention_split_reference(
        t['q'], kp, vp, t['tables'], t['lens'], k_scales=ks, v_scales=vs)
    return out, (kp, vp, ks, vs)


def _model(t):
    kp, vp, ks, vs = _arenas(t)
    out = tpa.paged_attention_write_split_reference(
        t['q'], t['k_new'], t['v_new'], kp, vp, t['tables'], t['lens'],
        t['phys'], t['off'], t['keep'], t['fresh_lo'], t['fresh_src'])
    return out, (kp, vp, ks, vs)


@pytest.mark.parametrize('kind', ROW_SETS)
@pytest.mark.parametrize('kv_dtype', DIRECT)
def test_kernel_order_model_equals_write_then_attend(kv_dtype, kind):
    """The kernel-order model (fresh keys from the input rows) against
    write-then-attend in the same split order: the arenas, and every row
    that reads only kept rows, bit for bit; new rows of the arena's
    dtype."""
    t = _case(kind, kv_dtype, 16, seed=200 + ROW_SETS.index(kind),
              src=getattr(torch, kv_dtype))
    got, arenas = _model(t)
    want, warenas = _composition_split(t)
    for a, b in zip(arenas, warenas):
        if a is not None:
            assert torch.equal(_raw(a), _raw(b))
    ok = torch.tensor(t['ok'])
    assert ok.any()
    assert torch.equal(got[ok], want[ok])


@pytest.mark.parametrize('kv_dtype', DIRECT)
def test_kernel_order_model_reads_fresh_keys_from_the_input(kv_dtype):
    """An empty decode slot (length 0, every table entry past the pool)
    writes nothing, yet attends over its one position, which the fused
    kernel reads from the input: its output is exactly its own new value
    row (one key, weight 1), where write-then-attend reads a stale slot of
    the clamped page."""
    t = _case('decode', kv_dtype, 16, seed=7, src=getattr(torch, kv_dtype))
    got, _ = _model(t)
    empty = 4
    assert not bool(t['keep'][empty]) and int(t['lens'][empty]) == 1
    assert torch.equal(got[empty], t['v_new'][empty].float())
    want, _ = _composition_split(t)
    assert not torch.equal(want[empty], got[empty])


def test_write_slots_drop_as_the_reference():
    """write_slots keeps exactly the rows the JAX package's _extend_rows
    does not send to phys = NB: live, inside the table's capacity, through
    an entry inside the pool; phys and off there are its scatter's."""
    rng = np.random.RandomState(3)
    for kind in ROW_SETS:
        tables, pos, live, _, _ = _row_set(kind, rng)
        phys, off, keep = write_slots(torch.tensor(np.ascontiguousarray(
            tables)), torch.tensor(pos), torch.tensor(live), NB, BS)
        logical = np.clip(pos // BS, 0, P - 1)
        jphys = np.take_along_axis(tables, logical[:, None], axis=1)[:, 0]
        jphys = np.where((pos < P * BS) & live, jphys, NB)
        want = jphys < NB
        assert np.array_equal(keep.numpy(), want)
        assert np.array_equal(phys.numpy()[want], jphys[want])
        assert np.array_equal(off.numpy(), pos % BS)
        assert not want.all()


@pytest.mark.parametrize('src, kv_dtype', [
    (src, kv) for src in DIRECT for kv in KV_DTYPES if kv != src])
def test_fold_refuses_rows_it_would_convert(src, kv_dtype):
    """paged_attention_write (and its kernel-order model) take only new
    rows of the arenas' dtype; a write that rounds or quantizes is the
    stand-alone kv_write's, so the fold refuses it on any device."""
    t = _case('decode', kv_dtype, 16, seed=9, src=getattr(torch, src))
    kp, vp, _, _ = _arenas(t)
    args = (t['q'], t['k_new'], t['v_new'], kp, vp, t['tables'], t['lens'],
            t['phys'], t['off'], t['keep'], t['fresh_lo'], t['fresh_src'])
    for fn in (tpa.paged_attention_write,
               tpa.paged_attention_write_split_reference):
        with pytest.raises(ValueError, match='kv_write'):
            fn(*args)


@pytest.mark.parametrize('kv_dtype, spec_k', [
    ('float32', 0), ('float32', 2), ('bfloat16', 0), ('int8', 2),
    ('float8_e4m3fn', 0)])
def test_decode_ops_fold_the_write_only_where_it_wins(monkeypatch,
                                                      kv_dtype, spec_k):
    """A tiny fp32 engine's run on the CPU: every decode and verify step
    on fp32 arenas runs one folded write-and-attend a layer; every
    prefill, and every op on the arenas that convert the fp32 rows (bf16,
    int8, fp8), runs the stand-alone write and then the attention."""
    calls = dict(fold=0, write=0)

    def counted(fn, key):
        def wrap(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrap
    monkeypatch.setattr(tpd, 'paged_attention_write',
                        counted(tpd.paged_attention_write, 'fold'))
    monkeypatch.setattr(tpd, 'kv_write', counted(tpd.kv_write, 'write'))
    spec = LMSpec(vocab_size=60, n_layer=2, n_head=2, d_key=8, d_value=8,
                  d_model=16, d_inner=32)
    eng = DecodeEngine(spec, max_batch=4, block_size=4, num_blocks=64,
                       pages_per_seq=4, place=pt.CPUPlace(),
                       weights=random_weights(spec, seed=3),
                       kv_dtype=kv_dtype, spec_k=spec_k)
    rng = np.random.RandomState(0)
    eng.start()
    streams = [eng.submit(prompt_ids=rng.randint(0, 60, 5).tolist(),
                          max_new_tokens=4, temperature=0.0, seed=i)
               for i in range(3)]
    for s in streams:
        assert len(s.result(timeout=120)) == 4
    eng.shutdown()
    steps = eng.decode_steps + eng.verify_steps
    assert eng.prefills == 3 and steps > 0
    assert (eng.verify_steps > 0) == (spec_k > 0)
    folds = spec.n_layer * steps if kv_dtype == 'float32' else 0
    assert calls == dict(fold=folds,
                         write=spec.n_layer * (eng.prefills + steps) - folds)
