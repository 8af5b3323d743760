"""The decode extras, port vs reference: the per-row KV quantizer bit for
bit, the speculative-verify op through both Executors at fp32, int8 and
fp8 arenas, the prefix cache's trie semantics, the n-gram draft and the
acceptance rule (the unit tests of tests/test_prefix_spec.py run on the
port), and the engine with the prefix cache, speculation and quantized
arenas: streams equal the sequential plain baseline, the pool drains, a
published page is never written again, and the greedy streams equal the
JAX engine's at int8 with both features on."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as fluid
from paddle_tpu.quant import core as jq
from paddle_tpu.serving.decode import DecodeEngine as RefEngine
from paddle_tpu.serving.decode import LMSpec as RefSpec
from paddle_tpu.serving.decode.model import \
    build_lm_programs as ref_build_lm_programs

import paddle_tpu_torch as pt
from paddle_tpu_torch.quant import core as tq
from paddle_tpu_torch.serving.decode import (BlockTable, DecodeEngine,
                                             KVPool, LMSpec, NgramDraft,
                                             PrefixCache, accept_drafts,
                                             build_lm_programs,
                                             random_weights)
from paddle_tpu_torch.serving.decode.model import (arena_bytes,
                                                   kv_bytes_per_token,
                                                   num_blocks_for_budget)
from paddle_tpu_torch.serving.decode.scheduler import Scheduler, Sequence
from paddle_tpu_torch.weights import from_numpy

DIMS = dict(vocab_size=60, n_layer=2, n_head=2, d_key=8, d_value=8,
            d_model=16, d_inner=32)
SPEC = LMSpec(**DIMS)
REF_SPEC = RefSpec(**DIMS)
WEIGHTS = random_weights(SPEC, seed=3)
GEOM = dict(max_batch=4, block_size=4, num_blocks=64, pages_per_seq=8)


def _engine(**kw):
    for k, v in GEOM.items():
        kw.setdefault(k, v)
    kw.setdefault('weights', WEIGHTS)
    kw.setdefault('place', pt.CPUPlace())
    return DecodeEngine(SPEC, **kw)


def _shared_prefix_requests(n=6, seed=0):
    """Mixed-length requests, most sharing a 9-token system prompt (two
    full pages at block_size 4), greedy and sampled rows mixed."""
    rng = np.random.RandomState(seed)
    shared = [7, 3, 7, 1, 7, 4, 7, 2, 7]
    reqs = []
    for i in range(n):
        if i % 3 == 2:      # a minority of cold prompts
            prompt = rng.randint(0, 60, rng.randint(2, 8)).tolist()
        else:
            prompt = shared + rng.randint(0, 60, rng.randint(1, 5)).tolist()
        reqs.append(dict(prompt_ids=prompt,
                         max_new_tokens=int(rng.randint(3, 8)),
                         temperature=0.0 if i % 2 == 0 else 0.7,
                         seed=100 + i))
    return reqs


def _run(eng, reqs):
    eng.start()
    streams = [eng.submit(**r) for r in reqs]
    out = [s.result(timeout=120) for s in streams]
    eng.shutdown()
    return out


_BASELINE = {}


def _baseline(seed, **kw):
    """Sequential single-request decode on a plain engine (no cache, no
    speculation): the reference every feature must reproduce."""
    key = (seed, tuple(sorted(kw.items())))
    if key not in _BASELINE:
        _BASELINE[key] = [_run(_engine(**kw), [r])[0]
                          for r in _shared_prefix_requests(seed=seed)]
    return _BASELINE[key]


def _np(x):
    """A JAX or numpy array as numpy, fp8 as its bytes."""
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype.itemsize == 1 and \
        a.dtype != np.int8 else a


# ----------------------------------------------------------- quantizer
@pytest.mark.parametrize('kv_dtype', ['int8', 'float8_e4m3fn'])
def test_quantize_rows_equals_reference_bit_for_bit(kv_dtype):
    """Rows of every scale (zero rows, tiny rows, values at half steps):
    the port's q and scales equal the JAX package's bit for bit, fp8
    compared as bytes."""
    rng = np.random.RandomState(0)
    x = (rng.randn(40, 3, 64) *
         rng.exponential(3.0, (40, 3, 1))).astype('float32')
    x[1, 2] = 0.0
    x[2, 0, :7] = 1e-3
    x[3, 1] = np.arange(64, dtype='float32') - 31.5   # half steps at int8
    jqv, jsv = jq.quantize_rows(jnp.asarray(x), kv_dtype)
    q, s = tq.quantize_rows(torch.tensor(x), kv_dtype)
    assert q.dtype == getattr(torch, kv_dtype) and s.dtype == torch.float32
    got = q.view(torch.uint8).numpy() if kv_dtype != 'int8' else q.numpy()
    np.testing.assert_array_equal(got, _np(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jsv))


def test_kv_dtype_knob_and_bytes_accounting(monkeypatch):
    """PADDLE_TPU_KV_DTYPE is read per call, the constructor arg wins;
    kv_bytes_per_token counts the scale bytes and a byte budget buys
    about twice the pages at int8 (the reference's numbers)."""
    monkeypatch.setenv('PADDLE_TPU_KV_DTYPE', 'int8')
    assert tq.resolve_kv_dtype() == 'int8'
    eng = _engine()
    assert eng.kv_dtype == 'int8'
    assert eng._progs.arena_names == ('lm_kcache', 'lm_vcache',
                                      'lm_kscale', 'lm_vscale')
    assert _engine(kv_dtype='bf16').kv_dtype == 'bfloat16'
    monkeypatch.delenv('PADDLE_TPU_KV_DTYPE')
    assert _engine().kv_dtype == 'float32'
    with pytest.raises(ValueError):
        tq.resolve_kv_dtype('int4')
    # L*H*(dk+dv) = 2*2*16 = 64 elements a token
    assert kv_bytes_per_token(SPEC, 'float32') == 64 * 4
    assert kv_bytes_per_token(SPEC, 'int8') == 64 + 2 * 2 * 2 * 4
    budget = arena_bytes(SPEC, 16, 4, 'float32')
    nb8 = num_blocks_for_budget(budget, SPEC, 4, 'int8')
    assert nb8 / 16.0 >= 1.8
    assert arena_bytes(SPEC, nb8, 4, 'int8') <= budget


# ------------------------------------------------ programs and the ops
def _op_types(prog):
    return [op.type for op in prog.global_block().ops]


@pytest.mark.parametrize('kv_dtype', ['float32', 'int8', 'float8_e4m3fn'])
def test_verify_program_and_scale_arenas_mirror_reference(kv_dtype):
    ref = ref_build_lm_programs(REF_SPEC, 4, 4, 64, 4, spec_k=2,
                                kv_dtype=kv_dtype)
    got = build_lm_programs(SPEC, 4, 4, 64, 4, spec_k=2, kv_dtype=kv_dtype)
    assert tuple(got.arena_names) == tuple(ref.arena_names)
    for name in ('startup', 'prefill', 'decode', 'verify'):
        assert _op_types(getattr(got, name)) == \
            _op_types(getattr(ref, name)), name
    for name in ('prefill', 'decode', 'verify'):
        rop = getattr(ref, name).global_block().ops[0]
        gop = getattr(got, name).global_block().ops[0]
        assert sorted(gop.inputs) == sorted(rop.inputs), name
        assert sorted(gop.outputs) == sorted(rop.outputs), name
        assert gop.attrs == rop.attrs, name
    for name in ref.arena_names:
        rv = ref.verify.global_block().var(name)
        gv = got.verify.global_block().var(name)
        assert (gv.shape, gv.dtype) == (rv.shape, rv.dtype), name
    for feed in ('sv_tokens', 'sv_lens', 'sv_tables', 'sv_temps',
                 'sv_seeds'):
        assert got.verify.global_block().var(feed).shape == \
            ref.verify.global_block().var(feed).shape, feed


def _scopes(ref, got):
    rscope, gscope = fluid.Scope(), pt.Scope()
    rexe, gexe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    with fluid.scope_guard(rscope):
        rexe.run(program=ref.startup)
    for name, arr in WEIGHTS.items():
        rscope.set(name, np.asarray(arr, 'float32'))
    with pt.scope_guard(gscope):
        gexe.run(program=got.startup)
    for name, t in from_numpy(WEIGHTS, pt.CPUPlace()).items():
        gscope.set(name, t)
    return (rexe, rscope), (gexe, gscope)


def _arenas_equal(ref, got, kv_dtype, rscope, gscope):
    """fp32 arenas within 1e-5; quantized ones equal after dequantization
    within one quantization step (the K/V rows differ between the
    packages by fp32 rounding, which can move a value across a rounding
    boundary) and their scales within 1e-5 relative."""
    if kv_dtype == 'float32':
        for name in got.arena_names:
            np.testing.assert_allclose(np.asarray(gscope.numpy(name)),
                                       np.asarray(rscope.numpy(name)),
                                       rtol=1e-5, atol=1e-5)
        return
    tdt = getattr(torch, kv_dtype)
    for arena, scale in (('lm_kcache', 'lm_kscale'),
                         ('lm_vcache', 'lm_vscale')):
        rs = np.asarray(rscope.numpy(scale))
        gs = gscope.numpy(scale)
        np.testing.assert_allclose(gs, rs, rtol=1e-5, atol=0)
        rq = np.asarray(rscope.numpy(arena))
        rf = np.asarray(jnp.asarray(rq).astype(jnp.float32))
        gf = gscope.get(arena).to(tdt).float().numpy()
        if kv_dtype == 'int8':
            step = np.ones_like(rf)
        else:   # one e4m3 step at the value (subnormal spacing 2^-9)
            a = np.maximum(np.abs(rf), 2.0 ** -6)
            step = 2.0 ** (np.floor(np.log2(a)) - 3)
        gap = np.abs(gf * gs[..., None] - rf * rs[..., None])
        assert np.all(gap <= step * rs[..., None] * (1 + 1e-5) + 1e-6), \
            (arena, float(gap.max()))


@pytest.mark.parametrize('kv_dtype', ['float32', 'int8', 'float8_e4m3fn'])
def test_spec_verify_op_matches_reference(kv_dtype):
    """Two prefills, then two verify steps with k = 2 (drafts that agree
    and disagree with the target) through both Executors from the same
    weights: the live rows' next tokens are equal at every position and
    the arenas agree (see _arenas_equal)."""
    ref = ref_build_lm_programs(REF_SPEC, 4, 4, 64, 4, spec_k=2,
                                kv_dtype=kv_dtype)
    got = build_lm_programs(SPEC, 4, 4, 64, 4, spec_k=2, kv_dtype=kv_dtype)
    (rexe, rscope), (gexe, gscope) = _scopes(ref, got)
    prefills = [([7, 3, 11, 42, 5], [3, 1, 64, 64]),
                ([19, 2, 8], [9, 5, 64, 64])]
    nexts = []
    for ids, table in prefills:
        pad = np.zeros((1, 8), 'int64')
        pad[0, :len(ids)] = ids
        feed = {'pf_ids': pad, 'pf_len': np.asarray([len(ids)], 'int32'),
                'pf_cached': np.asarray([0], 'int32'),
                'pf_table': np.asarray([table], 'int32'),
                'pf_temp': np.asarray([0.0], 'float32'),
                'pf_seed': np.asarray([0], 'int32')}
        with fluid.scope_guard(rscope):
            r, = rexe.run(program=ref.prefill, feed=feed,
                          fetch_list=[ref.prefill_fetch])
        with pt.scope_guard(gscope):
            g, = gexe.run(program=got.prefill, feed=feed,
                          fetch_list=[got.prefill_fetch])
        assert int(np.asarray(g).reshape(-1)[0]) == \
            int(np.asarray(r).reshape(-1)[0])
        nexts.append(int(np.asarray(g).reshape(-1)[0]))
    _arenas_equal(ref, got, kv_dtype, rscope, gscope)

    lens = np.asarray([5, 3, 0, 0], 'int32')
    tables = np.full((4, 4), 64, 'int32')
    tables[0], tables[1] = prefills[0][1], prefills[1][1]
    tokens = np.zeros((4, 3), 'int64')
    tokens[0] = [nexts[0], 13, 22]
    tokens[1] = [nexts[1], 40, 41]
    for _ in range(2):
        feed = {'sv_tokens': tokens, 'sv_lens': lens, 'sv_tables': tables,
                'sv_temps': np.zeros((4,), 'float32'),
                'sv_seeds': np.zeros((4,), 'int32')}
        with fluid.scope_guard(rscope):
            r, = rexe.run(program=ref.verify, feed=feed,
                          fetch_list=[ref.verify_fetch])
        with pt.scope_guard(gscope):
            g, = gexe.run(program=got.verify, feed=feed,
                          fetch_list=[got.verify_fetch])
        g, r = np.asarray(g).reshape(4, 3), np.asarray(r).reshape(4, 3)
        np.testing.assert_array_equal(g[:2], r[:2])
        _arenas_equal(ref, got, kv_dtype, rscope, gscope)
        # accept the target's first token, take its tail as new drafts
        tokens = np.zeros((4, 3), 'int64')
        tokens[:2, 0] = g[:2, 0]
        tokens[:2, 1:] = g[:2, 1:]
        lens = lens + np.asarray([1, 1, 0, 0], 'int32')


def test_row_tiles_give_every_row_the_same_bits():
    """The LM's products run in ROW_TILE-row tiles, so a row's result is
    the same bits at any row count (a 16-row decode padded to one tile, a
    verify batch, a prefill of several tiles) and agrees with the plain
    product."""
    from paddle_tpu_torch.ops.paged_decode_ops import ROW_TILE, _mm, \
        _pad_rows
    rng = np.random.RandomState(4)
    x = torch.tensor(rng.randn(4 * ROW_TILE, 48).astype('float32'))
    w = torch.tensor(rng.randn(48, 80).astype('float32'))
    full = _mm(x, w)
    np.testing.assert_allclose(full.numpy(), (x @ w).numpy(), rtol=1e-5,
                               atol=1e-5)
    for m in (ROW_TILE, 2 * ROW_TILE, 3 * ROW_TILE):
        assert torch.equal(_mm(x[:m], w), full[:m])
    padded = _pad_rows(x[:16], ROW_TILE)
    assert padded.shape == (ROW_TILE, 48)
    assert torch.equal(_mm(padded, w)[:16], full[:16])


# ------------------------------------------------------- trie semantics
def test_prefix_cache_match_stops_at_full_page_boundary():
    pool = KVPool(num_blocks=16, block_size=4)
    cache = PrefixCache(pool)
    t = BlockTable()
    tokens = list(range(11))            # 2 full pages + a 3-token tail
    assert pool.grow(t, len(tokens))
    cache.publish(tokens, t, upto_tokens=11)
    assert cache.cached_pages() == 2    # the partial page never enters
    t2 = BlockTable()
    assert cache.match(tokens, t2) == 8
    assert t2.block_ids == t.block_ids[:2]
    # the prompt IS the cached span: at least one token must prefill
    t3 = BlockTable()
    assert cache.match(tokens[:8], t3) == 4
    assert t3.block_ids == t.block_ids[:1]
    # a diverging second page: only the first page hits
    t4 = BlockTable()
    assert cache.match(tokens[:4] + [55, 56, 57, 58, 9], t4) == 4
    assert t4.block_ids == t.block_ids[:1]
    # acquire takes every full page (no prefill follows)
    ids, covered = cache.acquire(tokens[:8])
    assert ids == t.block_ids[:2] and covered == 8
    pool.free(ids)
    for tb in (t2, t3, t4, t):
        pool.release(tb)
    cache.clear()
    assert pool.free_blocks() == pool.num_blocks
    assert (cache.hits, cache.tokens_reused) == (3, 16)


def test_prefix_cache_eviction_integrates_with_free_list():
    pool = KVPool(num_blocks=4, block_size=4)
    cache = PrefixCache(pool)
    t = BlockTable()
    assert pool.grow(t, 16)
    cache.publish(list(range(16)), t, upto_tokens=16)
    pool.release(t)                     # the cache is now the sole owner
    assert pool.free_blocks() == 0 and cache.cached_pages() == 4
    got = pool.alloc(2)                 # pressure evicts through the pool
    assert got is not None and len(got) == 2
    assert cache.cached_pages() == 2 and cache.evictions == 2
    pool.free(got)
    t2 = BlockTable()
    assert cache.match(list(range(9)), t2) == 8
    assert pool.alloc(3) is None        # matched pages are pinned
    assert cache.cached_pages() == 2
    pool.release(t2)
    assert pool.alloc(3) is not None    # demoted back to evictable
    cache.clear()


def test_prefix_cache_unmatch_rolls_back_admission_failure():
    pool = KVPool(num_blocks=8, block_size=4)
    cache = PrefixCache(pool)
    t = BlockTable()
    pool.grow(t, 8)
    cache.publish(list(range(8)), t, upto_tokens=8)
    pool.release(t)
    t2 = BlockTable()
    n = cache.match(list(range(9)), t2)
    assert n == 8 and len(t2.block_ids) == 2
    cache.unmatch(t2, n)
    assert t2.block_ids == [] and cache.cached_pages() == 2
    cache.clear()
    assert pool.free_blocks() == pool.num_blocks


def test_prefix_cache_lru_and_priority_eviction_order():
    """Touching chain A makes B the LRU victim; a page published by the
    batch class goes before an interactive one whatever their ages."""
    pool = KVPool(num_blocks=8, block_size=4)
    cache = PrefixCache(pool)
    tabs = [BlockTable() for _ in range(3)]
    for tb in tabs:
        pool.grow(tb, 4)
    cache.publish([1, 2, 3, 4], tabs[0], upto_tokens=4)
    cache.publish([5, 6, 7, 8], tabs[1], upto_tokens=4)
    pages = [tb.block_ids[0] for tb in tabs]
    for tb in tabs[:2]:
        pool.release(tb)
    t = BlockTable()
    assert cache.match([1, 2, 3, 4, 9], t) == 4
    pool.release(t)
    assert cache.reclaim(1) == 1
    assert pool.refcount(pages[1]) == 0 and pool.refcount(pages[0]) == 1
    cache.publish([9, 9, 9, 9], tabs[2], upto_tokens=4, priority='batch')
    pool.release(tabs[2])
    t = BlockTable()
    assert cache.match([1, 2, 3, 4, 9], t) == 4    # A is the newest
    pool.release(t)
    assert cache.reclaim(1) == 1
    assert pool.refcount(pages[2]) == 0 and pool.refcount(pages[0]) == 1
    cache.clear()
    assert pool.free_blocks() == pool.num_blocks


def test_fork_partial_last_page_not_shared():
    pool = KVPool(num_blocks=8, block_size=4)
    t = BlockTable()
    pool.grow(t, 11)                    # pages 0, 1 full; page 2 partial
    f = pool.fork(t, frozen_tokens=11)
    assert f.block_ids == t.block_ids[:2]
    assert pool.refcount(t.block_ids[2]) == 1
    f2 = pool.fork(t, frozen_tokens=8)
    assert f2.block_ids == t.block_ids[:2]
    f3 = pool.fork(t)
    assert f3.block_ids == t.block_ids
    for tb in (f, f2, f3, t):
        pool.release(tb)
    assert pool.free_blocks() == pool.num_blocks


def test_ngram_draft_learns_and_falls_back():
    d = NgramDraft(max_ngram=3, context=2)
    assert d.propose([1], 3) == []
    assert d.propose([1, 2, 3, 4, 1, 2], 2) == [3, 4]   # prompt lookup
    d.observe([7, 8, 9])
    d.observe([8, 9, 10])
    assert d.propose([5, 7, 8], 2) == [9, 10]           # learned chain
    d.observe([7, 8, 9])
    d.observe([7, 8, 11])
    assert d.propose([0, 7, 8], 1) == [9]               # majority wins


def test_accept_drafts_longest_prefix_rule():
    assert accept_drafts([5, 6, 7], [5, 6, 7, 8]) == [5, 6, 7, 8]
    assert accept_drafts([5, 6, 7], [5, 6, 9, 8]) == [5, 6, 9]
    assert accept_drafts([4, 6, 7], [5, 6, 7, 8]) == [5]
    assert accept_drafts([], [3]) == [3]


def test_scheduler_priority_admission_and_victims():
    """Interactive requests are admitted before earlier batch ones, and
    pool exhaustion preempts the batch class first."""
    pool = KVPool(num_blocks=5, block_size=4)
    sched = Scheduler(pool, max_batch=3)
    seqs = [Sequence(i, [1] * 3, 4, 0.0, 0, None, priority=p)
            for i, p in enumerate(['batch', None, 'interactive'])]
    for s in seqs:
        sched.add(s)
    order = [sched.pop_admittable().request_id for _ in range(3)]
    assert order == [2, 1, 0]
    assert sched.peak_running == 3
    for s in seqs:
        s.cache_len = 3
    # each holds one page of five; the interactive one growing to four
    # pages preempts the batch one (the youngest, the standard one, stays)
    assert sched.ensure_growth(seqs[2], 4 * 4)
    assert [s.state for s in seqs] == ['waiting', 'running', 'running']
    assert sched.preemptions == 1


# ----------------------------------------------------------------- e2es
def test_prefix_cache_streams_equal_baseline_and_pool_drains():
    want = _baseline(0)
    eng = _engine(prefix_cache=True)
    assert eng.warmup() == len(eng.prompt_buckets) + 1
    got = _run(eng, _shared_prefix_requests(seed=0))
    assert got == want, 'the prefix cache changed token streams'
    assert eng.prefix_cache.hits > 0 and eng.prefix_cache.tokens_reused > 0
    assert eng.pool.free_blocks() == eng.pool.num_blocks


def test_spec_decode_streams_equal_baseline():
    want = _baseline(0)
    eng = _engine(spec_k=3)
    assert eng.warmup() == len(eng.prompt_buckets) + 2   # decode + verify
    got = _run(eng, _shared_prefix_requests(seed=0))
    assert got == want, 'speculative decoding changed token streams'
    assert eng.verify_steps > 0 and eng.spec_rows > 0
    assert eng.pool.free_blocks() == eng.pool.num_blocks


def test_cache_hit_preempt_requeue_drain():
    """A pool small enough that admission, growth, cache eviction and
    preemption fight over the same pages, both features on."""
    want = _baseline(0)
    eng = _engine(num_blocks=9, prefix_cache=True, spec_k=2)
    got = _run(eng, _shared_prefix_requests(seed=0))
    assert got == want, 'preemption under cache pressure changed streams'
    assert eng.preemptions > 0, 'the pool must be small enough to preempt'
    assert eng.prefix_cache.evictions > 0, 'the cache must evict'
    assert eng.pool.free_blocks() == eng.pool.num_blocks


@pytest.mark.parametrize('kv_dtype', ['float32', 'int8'])
def test_both_features_with_sampling(kv_dtype):
    want = _baseline(3, kv_dtype=kv_dtype)
    eng = _engine(prefix_cache=True, spec_k=3, kv_dtype=kv_dtype)
    eng.warmup()
    got = _run(eng, _shared_prefix_requests(seed=3))
    assert got == want
    assert eng.pool.free_blocks() == eng.pool.num_blocks


@pytest.mark.parametrize('kv_dtype', ['int8', 'fp8'])
def test_quantized_concurrent_equals_sequential(kv_dtype):
    want = _baseline(0, kv_dtype=kv_dtype)
    eng = _engine(kv_dtype=kv_dtype)
    eng.warmup()
    got = _run(eng, _shared_prefix_requests(seed=0))
    assert got == want
    assert eng.pool.free_blocks() == eng.pool.num_blocks
    assert eng.resident_seqs_peak >= 2


def test_long_prompts_prefill_in_several_row_tiles():
    """Prompts of 70-150 tokens sharing 64: the plain prefill runs two or
    three row tiles, a cache hit one; streams with the cache and
    speculation on equal the sequential plain ones."""
    rng = np.random.RandomState(9)
    shared = rng.randint(0, 60, 64).tolist()
    reqs = [dict(prompt_ids=shared + rng.randint(
        0, 60, int(rng.randint(6, 86))).tolist(), max_new_tokens=5,
        temperature=0.0 if i % 2 else 0.7, seed=300 + i) for i in range(4)]
    geom = dict(pages_per_seq=48, num_blocks=160)
    want = [_run(_engine(**geom), [r])[0] for r in reqs]
    eng = _engine(prefix_cache=True, spec_k=2, **geom)
    assert _run(eng, reqs) == want
    assert eng.prefix_cache.tokens_reused >= 3 * 64


def test_published_page_bytes_never_change():
    """The arenas are written in place: after a page is published, later
    traffic (cache hits, verify writes past them, rejected drafts) leaves
    its K, V and scale bytes as they were."""
    eng = _engine(prefix_cache=True, spec_k=3, kv_dtype='int8')
    reqs = _shared_prefix_requests(seed=0)
    eng.start()
    eng.generate(timeout=120, **reqs[0])
    roots = list(eng.prefix_cache._root.children.values())
    pages = [n.page_id for n in roots] + \
        [c.page_id for n in roots for c in n.children.values()]
    assert len(pages) >= 2
    names = eng._progs.arena_names
    before = {n: eng._scope.get(n)[:, pages].clone() for n in names}
    more = reqs[1:] + [dict(r, seed=r['seed'] + 50) for r in reqs]
    streams = [eng.submit(**r) for r in more]
    for s in streams:
        s.result(timeout=120)
    assert eng.prefix_cache.hits > 0
    for n in names:
        assert torch.equal(eng._scope.get(n)[:, pages], before[n]), n
    eng.shutdown()
    assert eng.pool.free_blocks() == eng.pool.num_blocks


def test_env_knobs_read_per_call(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_PREFIX_CACHE', '1')
    monkeypatch.setenv('PADDLE_TPU_SPEC_K', '2')
    eng = _engine()
    assert eng.prefix_cache is not None and eng.spec_k == 2
    monkeypatch.setenv('PADDLE_TPU_PREFIX_CACHE', '0')
    monkeypatch.setenv('PADDLE_TPU_SPEC_K', '0')
    eng2 = _engine()
    assert eng2.prefix_cache is None and eng2.spec_k == 0
    assert eng2._progs.verify is None
    monkeypatch.setenv('PADDLE_TPU_SPEC_K', '5')
    eng3 = _engine(spec_k=1, prefix_cache=True)
    assert eng3.spec_k == 1 and eng3.prefix_cache is not None


@pytest.mark.parametrize('kv_dtype', ['int8'])
def test_greedy_streams_equal_reference_engine_with_extras(kv_dtype):
    """The port's engine and paddle_tpu's, both with the prefix cache and
    spec_k=2 at an int8 arena, serve the same greedy streams."""
    reqs = _shared_prefix_requests(seed=1)
    for r in reqs:
        r['temperature'] = 0.0
    kw = dict(kv_dtype=kv_dtype, prefix_cache=True, spec_k=2, **GEOM)
    ref = RefEngine(REF_SPEC, weights=WEIGHTS, place=fluid.CPUPlace(), **kw)
    want = _run(ref, reqs)
    got = _run(_engine(kv_dtype=kv_dtype, prefix_cache=True, spec_k=2),
               reqs)
    assert got == want


def test_sampled_token_does_not_depend_on_the_row_place():
    """A row's sampled token depends on its logits, seed, position and
    temperature only: the same rows in another order and inside a larger
    batch give the same tokens, temperature-0 rows stay the first maximum,
    and another position draws another token somewhere."""
    from paddle_tpu_torch.ops.paged_decode_ops import _sample_tokens
    rng = np.random.RandomState(9)
    n, v = 8, 60
    logits = torch.tensor(rng.randn(n, v).astype('float32'))
    seeds = torch.tensor(rng.randint(0, 1 << 30, n), dtype=torch.int32)
    pos = torch.tensor(rng.randint(1, 500, n), dtype=torch.int32)
    temps = torch.tensor([0.0, 0.7, 1.0, 0.0, 0.5, 2.0, 0.9, 0.0])
    base = _sample_tokens(logits, seeds, pos, temps)
    perm = torch.tensor(rng.permutation(n))
    moved = _sample_tokens(logits[perm], seeds[perm], pos[perm], temps[perm])
    assert torch.equal(moved, base[perm])
    big = _sample_tokens(torch.cat([logits, logits]),
                         torch.cat([seeds, seeds]), torch.cat([pos, pos]),
                         torch.cat([temps, temps]))
    assert torch.equal(big[:n], base) and torch.equal(big[n:], base)
    greedy = temps == 0
    assert torch.equal(base[greedy], torch.argmax(logits[greedy], dim=-1))
    later = _sample_tokens(logits.repeat(16, 1), seeds.repeat(16),
                           pos.repeat(16) + torch.arange(16).repeat_interleave(
                               n).to(torch.int32), temps.repeat(16))
    assert not torch.equal(later.reshape(16, n)[:, 1],
                           base[1].expand(16))


def _old_scatter(k_new, v_new, ka, va, ks, vs, phys, off, keep, kv_dtype):
    """The writes before the KV-write kernel, one kept row at a time:
    quantize_rows per row (quantized arenas) and a plain assignment."""
    for i in range(keep.shape[0]):
        if not bool(keep[i]):
            continue
        p, o = int(phys[i]), int(off[i])
        for arena, scales, new in ((ka, ks, k_new), (va, vs, v_new)):
            if scales is None:
                arena[p, :, o] = new[i].to(arena.dtype)
            else:
                q8, s8 = tq.quantize_rows(new[i:i + 1], kv_dtype)
                arena.view(torch.uint8)[p, :, o] = q8[0].view(torch.uint8)
                scales[p, :, o] = s8[0]


@pytest.mark.parametrize('kv_dtype', ['float32', 'bfloat16', 'int8',
                                      'float8_e4m3fn'])
def test_kv_write_plain_drops_rows_and_equals_old_scatter(kv_dtype):
    """The KV write's plain version (the CPU path) writes the kept rows as
    the row-by-row scatter with quantize_rows does, bit for bit (arenas
    and scales), and leaves every slot of a dropped row (past the pool,
    not live) as it was."""
    from paddle_tpu_torch.ops.kernels.kv_write import kv_write
    rng = np.random.RandomState(10)
    nb, h, bs, d, dv, n = 6, 2, 4, 12, 8, 9
    k_new = torch.tensor(3 * rng.randn(n, h, d).astype('float32'))
    v_new = torch.tensor(rng.randn(n, h, dv).astype('float32'))
    k_new[4] = 0
    slots = rng.permutation(nb * bs)[:n]
    phys = torch.tensor(slots // bs, dtype=torch.int32)
    off = torch.tensor(slots % bs, dtype=torch.int32)
    keep = torch.tensor(rng.rand(n) < 0.6)
    keep[4] = True
    phys[2], keep[2] = nb, False
    quant = tq.kv_quantized(kv_dtype)
    dtype = getattr(torch, kv_dtype)

    def arena(width):
        raw = torch.tensor(rng.randint(0, 255, (nb, h, bs, width)),
                           dtype=torch.uint8)
        return raw.view(dtype) if quant else raw.to(dtype)

    ka, va = arena(d), arena(dv)
    scales = [torch.tensor(rng.randn(nb, h, bs).astype('float32'))
              for _ in range(2)] if quant else [None, None]
    got = [ka.clone(), va.clone()] + [s.clone() if quant else None
                                      for s in scales]
    want = [ka.clone(), va.clone()] + [s.clone() if quant else None
                                       for s in scales]
    kv_write(k_new, v_new, got[0], got[1], phys, off, keep, got[2], got[3])
    _old_scatter(k_new, v_new, *want, phys, off, keep, kv_dtype)
    for a, b in zip(got, want):
        if a is not None:
            assert torch.equal(a.view(torch.uint8) if quant and a.dim() == 4
                               else a, b.view(torch.uint8)
                               if quant and b.dim() == 4 else b)
    for i in np.flatnonzero(~keep.numpy()):
        p, o = int(phys[i]), int(off[i])
        if p >= nb:
            continue
        for a, orig in ((got[0], ka), (got[1], va)):
            raw = (lambda t: t.view(torch.uint8) if quant else t)
            assert torch.equal(raw(a)[p, :, o], raw(orig)[p, :, o])
