"""Decode serving, port vs reference: the port's LM programs mirror the
JAX package's, the paged prefill / decode ops give the same tokens and
arenas through both Executors from the same weights, and DecodeEngine's
greedy streams equal the JAX engine's token for token at fp32 and bf16
arenas. Then the port's own engine invariants: concurrent == sequential,
preemption preserves streams, pages reclaimed after drain,
backpressure, per-seed determinism of sampled streams."""

import numpy as np
import pytest

import torch  # noqa: F401  (both frameworks load side by side)

import paddle_tpu as fluid
from paddle_tpu.serving.decode import DecodeEngine as RefEngine
from paddle_tpu.serving.decode import LMSpec as RefSpec
from paddle_tpu.serving.decode.model import \
    build_lm_programs as ref_build_lm_programs

import paddle_tpu_torch as pt
from paddle_tpu_torch.serving import EngineClosedError, QueueFullError
from paddle_tpu_torch.serving.decode import (BlockTable, DecodeEngine,
                                             KVPool, LMSpec,
                                             build_lm_programs,
                                             random_weights)

DIMS = dict(vocab_size=60, n_layer=2, n_head=2, d_key=8, d_value=8,
            d_model=16, d_inner=32)
SPEC = LMSpec(**DIMS)
REF_SPEC = RefSpec(**DIMS)
WEIGHTS = random_weights(SPEC, seed=3)
GEOM = dict(max_batch=4, block_size=4, num_blocks=64, pages_per_seq=4)


def _engine(**kw):
    for k, v in GEOM.items():
        kw.setdefault(k, v)
    kw.setdefault('weights', WEIGHTS)
    kw.setdefault('place', pt.CPUPlace())
    return DecodeEngine(SPEC, **kw)


def _mixed_requests(n=6, seed=0, sampled=True):
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.randint(1, 10))
        reqs.append(dict(prompt_ids=rng.randint(0, 60, plen).tolist(),
                         max_new_tokens=int(rng.randint(3, 7)),
                         temperature=0.7 if sampled and i % 2 else 0.0,
                         seed=100 + i))
    return reqs


def _run(eng, reqs):
    eng.start()
    streams = [eng.submit(**r) for r in reqs]
    out = [s.result(timeout=120) for s in streams]
    eng.shutdown()
    return out


_SEQ_REF = {}


def _sequential(seed):
    """One fresh port engine per request: the bit-identity baseline."""
    if seed not in _SEQ_REF:
        _SEQ_REF[seed] = [_run(_engine(), [r])[0]
                          for r in _mixed_requests(seed=seed)]
    return _SEQ_REF[seed]


# ------------------------------------------------------ programs mirror
def _op_types(prog):
    return [op.type for op in prog.global_block().ops]


@pytest.mark.parametrize('kv_dtype', ['float32', 'bfloat16'])
def test_programs_mirror_reference(kv_dtype):
    ref = ref_build_lm_programs(REF_SPEC, 4, 4, 64, 4, kv_dtype=kv_dtype)
    got = build_lm_programs(SPEC, 4, 4, 64, 4, kv_dtype=kv_dtype)
    assert got.param_names == ref.param_names
    assert tuple(got.arena_names) == tuple(ref.arena_names)
    assert got.capacity == ref.capacity
    for name in ('startup', 'prefill', 'decode'):
        assert _op_types(getattr(got, name)) == \
            _op_types(getattr(ref, name)), name
    for name in list(ref.param_names) + list(ref.arena_names):
        rv = ref.prefill.global_block().var(name)
        gv = got.prefill.global_block().var(name)
        assert (gv.shape, gv.dtype, gv.persistable) == \
            (rv.shape, rv.dtype, rv.persistable), name
    # the ops carry the same slots and attrs
    for name in ('prefill', 'decode'):
        rop = getattr(ref, name).global_block().ops[0]
        gop = getattr(got, name).global_block().ops[0]
        assert sorted(gop.inputs) == sorted(rop.inputs)
        assert sorted(gop.outputs) == sorted(rop.outputs)
        assert gop.attrs == rop.attrs


# --------------------------------------------- ops through both Executors
def _ref_scope(progs):
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(program=progs.startup)
    for name, arr in WEIGHTS.items():
        scope.set(name, np.asarray(arr, 'float32'))
    return exe, scope


def _port_scope(progs):
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        exe.run(program=progs.startup)
    from paddle_tpu_torch.weights import from_numpy
    for name, t in from_numpy(WEIGHTS, pt.CPUPlace()).items():
        scope.set(name, t)
    return exe, scope


def _arenas(scope):
    return [np.asarray(scope.numpy(n)).astype(np.float32)
            for n in ('lm_kcache', 'lm_vcache')]


@pytest.mark.parametrize('kv_dtype', ['float32', 'bfloat16'])
def test_prefill_and_decode_ops_match_reference(kv_dtype):
    """Same weights and feeds through both Executors: equal next tokens;
    arenas within fp32 rounding (1e-5: the K/V rows are products of
    O(1) activations and weights) or, at bf16, one bf16 step (1e-2)."""
    ref = ref_build_lm_programs(REF_SPEC, 4, 4, 64, 4, kv_dtype=kv_dtype)
    got = build_lm_programs(SPEC, 4, 4, 64, 4, kv_dtype=kv_dtype)
    rexe, rscope = _ref_scope(ref)
    gexe, gscope = _port_scope(got)
    tol = dict(rtol=1e-5, atol=1e-5) if kv_dtype == 'float32' else \
        dict(rtol=1e-2, atol=1e-2)

    # prefill two sequences: 5 tokens (bucket 8) on pages 3,1 and
    # 3 tokens (bucket 4) on page 9; the padded tail drops its writes
    prefills = [([7, 3, 11, 42, 5], [3, 1, 64, 64]),
                ([19, 2, 8], [9, 64, 64, 64])]
    nexts = []
    for ids, table in prefills:
        bucket = 8 if len(ids) > 4 else 4
        pad = np.zeros((1, bucket), 'int64')
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
        for a, b in zip(_arenas(gscope), _arenas(rscope)):
            np.testing.assert_allclose(a, b, **tol)

    # two decode steps: rows 0-1 live, rows 2-3 empty (all-NB tables)
    tokens = np.asarray(nexts + [0, 0], 'int64')
    lens = np.asarray([5, 3, 0, 0], 'int32')
    tables = np.full((4, 4), 64, 'int32')
    tables[0], tables[1] = prefills[0][1], prefills[1][1]
    for _ in range(2):
        feed = {'dec_tokens': tokens, 'dec_lens': lens,
                'dec_tables': tables,
                'dec_temps': np.zeros((4,), 'float32'),
                'dec_seeds': np.zeros((4,), 'int32')}
        with fluid.scope_guard(rscope):
            r, = rexe.run(program=ref.decode, feed=feed,
                          fetch_list=[ref.decode_fetch])
        with pt.scope_guard(gscope):
            g, = gexe.run(program=got.decode, feed=feed,
                          fetch_list=[got.decode_fetch])
        np.testing.assert_array_equal(np.asarray(g)[:2], np.asarray(r)[:2])
        for a, b in zip(_arenas(gscope), _arenas(rscope)):
            np.testing.assert_allclose(a, b, **tol)
        tokens = np.asarray(g, 'int64').reshape(-1)
        lens = lens + np.asarray([1, 1, 0, 0], 'int32')


# ------------------------------------------------ engines, token streams
@pytest.mark.parametrize('kv_dtype', ['fp32', 'bf16'])
def test_greedy_streams_equal_reference_engine(kv_dtype):
    """DecodeEngine greedy streams equal paddle_tpu's DecodeEngine token
    for token, from the same weights, concurrent mixed-length traffic."""
    reqs = _mixed_requests(n=6, seed=1, sampled=False)
    for r in reqs:
        r['max_new_tokens'] = 6
    ref = RefEngine(REF_SPEC, weights=WEIGHTS, place=fluid.CPUPlace(),
                    kv_dtype=kv_dtype, **GEOM)
    want = _run(ref, reqs)
    got = _run(_engine(kv_dtype=kv_dtype), reqs)
    assert got == want


def test_weights_round_trip_and_reference_export():
    """load_weights takes the reference engine's export_weights() dict;
    the port exports the same arrays back."""
    ref = RefEngine(REF_SPEC, weights=WEIGHTS, place=fluid.CPUPlace(),
                    **GEOM)
    exported = ref.export_weights()
    eng = _engine(weights=None)
    eng.load_weights(exported)
    back = eng.export_weights()
    assert sorted(back) == sorted(exported)
    for name in exported:
        np.testing.assert_array_equal(back[name],
                                      np.asarray(exported[name], 'float32'))
    with pytest.raises(ValueError):
        eng.load_weights({'not_a_param': np.zeros(3, 'float32')})


# ----------------------------------------------- the port's invariants
def test_kv_pool_alloc_free_refcount():
    pool = KVPool(num_blocks=8, block_size=4)
    assert pool.free_blocks() == 8
    assert [pool.blocks_for(n) for n in (0, 1, 4, 5)] == [0, 1, 1, 2]
    a = pool.alloc(3)
    assert len(a) == 3 and pool.free_blocks() == 5
    assert pool.alloc(6) is None          # exhaustion is None, not raise
    assert pool.free_blocks() == 5        # a failed alloc takes nothing
    pool.incref(a)                        # shared prefix: two owners
    pool.free(a)
    assert pool.free_blocks() == 5
    pool.free(a)
    assert pool.free_blocks() == 8        # the last owner returns them
    with pytest.raises(ValueError):
        pool.free(a)                      # double free detected


def test_kv_pool_grow_release_and_fork():
    pool = KVPool(num_blocks=4, block_size=4)
    t = BlockTable()
    assert pool.grow(t, 1) and len(t) == 1
    assert pool.grow(t, 4) and len(t) == 1     # still fits page 0
    assert pool.grow(t, 5) and len(t) == 2
    f = pool.fork(t)                           # shares both pages
    assert f.block_ids == t.block_ids
    pool.release(t)
    assert pool.free_blocks() == 2             # the fork still owns them
    g = pool.fork(f, frozen_tokens=5)          # only the full page
    assert g.block_ids == f.block_ids[:1]
    t2 = BlockTable()
    assert not pool.grow(t2, 16)               # needs 4, only 2 free
    assert len(t2) == 0
    pool.release(f)
    assert pool.free_blocks() == 3             # g still holds page 0
    pool.release(g)
    assert pool.free_blocks() == 4


def test_concurrent_equals_sequential_and_pages_reclaimed():
    reqs = _mixed_requests()
    eng = _engine()
    assert eng.warmup() == len(eng.prompt_buckets) + 1
    eng.start()
    assert eng.ready()
    streams = [eng.submit(**r) for r in reqs]
    conc = [s.result(timeout=120) for s in streams]
    eng.shutdown()
    assert eng.pool.free_blocks() == eng.pool.num_blocks
    assert conc == _sequential(0)
    for s, r in zip(streams, reqs):
        assert len(s.result()) == r['max_new_tokens']
        assert s.finish_reason == 'max_tokens'


def test_preemption_requeue_preserves_streams():
    """A pool too small for the offered load preempts and requeues
    (never fails a request), reclaims every page and still produces the
    sequential streams."""
    eng = _engine(num_blocks=7)   # the longest request needs 4 pages
    got = _run(eng, _mixed_requests())
    assert eng.preemptions > 0, 'test must actually exercise eviction'
    assert got == _sequential(0)
    assert eng.pool.free_blocks() == eng.pool.num_blocks


def test_concurrent_submitters_stress():
    """More submitter threads than cores, a tiny switch interval and a
    pool small enough to preempt: every stream resolves with its full
    length, greedy streams equal the sequential baseline, the worker
    survives and every page comes back."""
    import sys
    import threading
    want = _sequential(0)
    reqs = _mixed_requests()
    eng = _engine(num_blocks=6, max_queue_depth=256)
    eng.start()
    results, errors = {}, []
    mu = threading.Lock()

    def client(k):
        try:
            for j in range(4):
                i = (k + j) % len(reqs)
                out = eng.generate(timeout=120, **reqs[i])
                with mu:
                    results.setdefault(i, []).append(out)
        except Exception as e:  # reported by the assert below
            with mu:
                errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    eng.shutdown()
    assert not errors, errors[:3]
    assert eng.preemptions > 0, 'the pool must be small enough to preempt'
    assert sum(len(v) for v in results.values()) == 48
    for i, outs in results.items():
        for out in outs:
            assert len(out) == reqs[i]['max_new_tokens']
            if reqs[i]['temperature'] == 0.0:
                assert out == want[i]
    assert eng.pool.free_blocks() == eng.pool.num_blocks


def test_streaming_tokens_arrive_incrementally():
    eng = _engine()
    eng.start()
    stream = eng.submit([5, 9, 2], max_new_tokens=8)
    got = [tok for tok in stream]
    assert all(isinstance(t, int) for t in got)
    assert got == stream.result() and stream.done()
    eng.shutdown()


def test_sampled_streams_deterministic_per_seed():
    eng = _engine()
    eng.start()
    kw = dict(max_new_tokens=8, temperature=0.9)
    a = eng.generate([4, 4, 4], seed=11, **kw)
    b = eng.generate([4, 4, 4], seed=11, **kw)
    c = eng.generate([4, 4, 4], seed=12, **kw)
    eng.shutdown()
    assert a == b
    assert a != c


def test_submit_validation_and_backpressure():
    eng = _engine(max_queue_depth=2)
    # never started: requests queue but nothing drains
    with pytest.raises(ValueError):
        eng.submit([])
    with pytest.raises(ValueError):
        eng.submit([1], max_new_tokens=0)
    with pytest.raises(ValueError):
        eng.submit(list(range(40)))            # > max_prompt_len
    with pytest.raises(ValueError):
        eng.submit([1, 2], max_new_tokens=100)  # > per-seq capacity
    with pytest.raises(ValueError):
        eng.submit([60], max_new_tokens=2)      # outside the vocabulary
    eng.submit([1], max_new_tokens=2)
    eng.submit([1], max_new_tokens=2)
    with pytest.raises(QueueFullError):
        eng.submit([1], max_new_tokens=2)
    eng.shutdown(drain=False)
    with pytest.raises(EngineClosedError):
        eng.submit([1], max_new_tokens=2)


def test_shutdown_without_drain_fails_pending():
    eng = _engine()
    stream = eng.submit([1, 2], max_new_tokens=4)   # never started
    eng.shutdown(drain=False)
    with pytest.raises(EngineClosedError):
        stream.result(timeout=5)
    assert stream.finish_reason == 'error'
    assert eng.pool.free_blocks() == eng.pool.num_blocks


@pytest.mark.parametrize('kw', [dict(prefix_cache=True), dict(spec_k=2),
                                dict(kv_dtype='int8'),
                                dict(kv_dtype='fp8')])
def test_later_slice_features_raise(kw):
    with pytest.raises(NotImplementedError):
        _engine(**kw)
