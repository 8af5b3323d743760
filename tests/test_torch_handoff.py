"""Disaggregated decode serving, port vs reference: the port counterparts
of tests/test_handoff.py (pool fragmentation and alloc-stall gauges; the
KV packet round trip bit for bit at fp32, bf16, int8 and fp8, scales
included; typed dtype, geometry and arena-set refusals; staging reused
across exports; the export and install seconds split into the arena-lock
wait and the copies; a packet of an unknown dtype refused; exports owning
their tensors; a failed install freeing
its pages; oversized page groups chunking; a handoff then decode equal to
one engine's stream at fp32 and int8 with sampling; preempt and resume
after a handoff; the PhaseRouter pipeline equal to one engine with no
executor cache miss after warmup, dedup across the hop and the phase
gauges; the colocated mode and the shed paths), then packets crossing
both ways between the packages at every arena dtype (the receiving
engine decodes the same greedy stream as the single engines), and fp8
arenas saved by one package's io loading in the other's."""

import json
import struct

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import io as jio
from paddle_tpu import observe as jobs
from paddle_tpu.quant.core import kv_fp8_supported as ref_fp8_supported
from paddle_tpu.serving import handoff as jhandoff
from paddle_tpu.serving.decode import DecodeEngine as RefEngine
from paddle_tpu.serving.decode import LMSpec as RefSpec

import paddle_tpu_torch as pt
from paddle_tpu_torch import observe
from paddle_tpu_torch.serving import (EngineClosedError, HandoffError,
                                      KVDtypeMismatchError, KVGeometryError,
                                      KVPacket, NoReplicaAvailableError,
                                      PhaseRouter, QueueFullError,
                                      SLOShedError)
from paddle_tpu_torch.serving import handoff as handoff_mod
from paddle_tpu_torch.serving.decode import (DecodeEngine, KVPool, LMSpec,
                                             random_weights)

DIMS = dict(vocab_size=60, n_layer=2, n_head=2, d_key=8, d_value=8,
            d_model=16, d_inner=32)
SPEC = LMSpec(**DIMS)
REF_SPEC = RefSpec(**DIMS)
WEIGHTS = random_weights(SPEC, seed=3)
GEOM = dict(max_batch=4, block_size=4, num_blocks=64, pages_per_seq=8)
DTYPES = ['float32', 'bfloat16', 'int8', 'fp8']


@pytest.fixture(autouse=True)
def _observe_clean():
    yield
    for mod in (observe, jobs):
        mod._SINK['path'] = None
        mod._SINK['trace_path'] = None
        mod.disable()
        mod.reset()


def _engine(**kw):
    for k, v in GEOM.items():
        kw.setdefault(k, v)
    kw.setdefault('weights', WEIGHTS)
    kw.setdefault('place', pt.CPUPlace())
    kw.setdefault('prefix_cache', True)
    return DecodeEngine(SPEC, **kw)


def _ref_engine(**kw):
    for k, v in GEOM.items():
        kw.setdefault(k, v)
    return RefEngine(REF_SPEC, weights=WEIGHTS, place=fluid.CPUPlace(),
                     prefix_cache=True, **kw)


def _prompt(n, seed=0):
    return [int(t) for t in np.random.RandomState(seed).randint(0, 60, n)]


def _bits(t):
    """The raw bytes of a CPU tensor or a numpy array."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(t).tobytes()


# --------------------------------------------------- pool observability
def test_pool_fragmentation_and_alloc_stall():
    observe.enable()
    pool = KVPool(num_blocks=8, block_size=4)
    assert pool.largest_free_run() == 8
    assert pool.fragmentation() == 0.0
    assert pool.used_blocks() == 0 and pool.occupancy() == 0.0
    ids = pool.alloc(8)
    pool.free([ids[i] for i in range(0, 8, 2)])
    assert pool.free_blocks() == 4 and pool.used_blocks() == 4
    assert pool.occupancy() == pytest.approx(0.5)
    assert pool.largest_free_run() == 1
    assert pool.fragmentation() == pytest.approx(0.75)
    snap = observe.snapshot()
    assert snap['gauges']['decode.kv_free_pages'] == 4
    assert snap['gauges']['decode.kv_largest_free_run'] == 1
    assert snap['gauges']['decode.kv_fragmentation'] == pytest.approx(0.75)

    # a shortfall the reclaimer rescues records a stall sample
    def reclaimer(n):
        held = [i for i in range(8) if pool.refcount(i) > 0][:n]
        if held:
            pool.free(held)
        return len(held)

    pool.set_reclaimer(reclaimer)
    got = pool.alloc(6)
    assert got is not None and len(got) == 6
    stall = observe.snapshot()['histograms'].get(
        'decode.alloc_stall_seconds', {})
    assert stall.get('count', 0) >= 1


def test_alloc_stall_on_exhaustion():
    observe.enable()
    pool = KVPool(num_blocks=4, block_size=4)
    pool.alloc(4)
    assert pool.alloc(1) is None        # no reclaimer: stall recorded
    snap = observe.snapshot()
    assert snap['histograms']['decode.alloc_stall_seconds']['count'] >= 1


# ------------------------------------------------------ packet wire form
@pytest.mark.parametrize('kv_dtype', DTYPES)
def test_packet_roundtrip_bit_identical(kv_dtype):
    """bytes -> restored pages bit for bit at every arena dtype, scales
    included; installed into a fresh engine and read back, the same."""
    eng = _engine(kv_dtype=kv_dtype)
    eng.start()
    prompt = _prompt(11, seed=1)
    eng.generate(prompt, max_new_tokens=1, timeout=120)
    pkt = handoff_mod.export_packet(eng, prompt)
    assert pkt is not None and pkt.n_pages == 2   # 11 tokens, bs=4
    assert pkt.kv_dtype == eng.kv_dtype
    assert pkt.tokens == prompt[:8]
    names = {'lm_kcache', 'lm_vcache'}
    if kv_dtype in ('int8', 'fp8'):
        names |= {'lm_kscale', 'lm_vscale'}
    assert set(pkt.arrays) == names
    assert pkt.wire_bytes() == handoff_mod.packet_wire_bytes(
        SPEC, 2, 4, eng.kv_dtype)

    back = KVPacket.from_bytes(pkt.to_bytes())
    assert back.header['kv_dtype'] == pkt.header['kv_dtype']
    assert back.tokens == pkt.tokens
    for name, arr in pkt.arrays.items():
        got = back.arrays[name]
        assert got.dtype == arr.dtype and got.shape == arr.shape
        assert _bits(got) == _bits(arr), name

    dst = _engine(kv_dtype=kv_dtype)
    covered, installed, dedup = handoff_mod.install_packet(dst, back)
    assert (covered, installed, dedup) == (8, 2, 0)
    ids, n = dst.prefix_cache.acquire(prompt)
    assert n == 8
    staged = dst.read_pages(ids)
    for name, arr in back.arrays.items():
        assert _bits(staged[name]) == _bits(arr), name
    dst.pool.free(ids)
    eng.shutdown()
    dst.shutdown(drain=False)


def test_cross_dtype_mismatch_raises_typed():
    a = _engine(kv_dtype='int8')
    a.start()
    prompt = _prompt(9, seed=2)
    a.generate(prompt, max_new_tokens=1, timeout=120)
    pkt = handoff_mod.export_packet(a, prompt)
    b = _engine()                       # fp32 arenas
    with pytest.raises(KVDtypeMismatchError):
        handoff_mod.install_packet(b, pkt)
    c = _engine(block_size=8, kv_dtype='int8')
    with pytest.raises(KVGeometryError):
        handoff_mod.install_packet(c, pkt)
    a.shutdown()
    b.shutdown(drain=False)
    c.shutdown(drain=False)


def test_packet_verify_knob_catches_corruption(monkeypatch):
    eng = _engine()
    eng.start()
    prompt = _prompt(9, seed=3)
    eng.generate(prompt, max_new_tokens=1, timeout=120)
    monkeypatch.setenv('PADDLE_TPU_HANDOFF_VERIFY', '1')
    wire = bytearray(handoff_mod.export_packet(eng, prompt).to_bytes())
    assert KVPacket.from_bytes(bytes(wire)).tokens == prompt[:8]
    wire[-3] ^= 0xFF                    # flip a payload byte
    with pytest.raises(HandoffError):
        KVPacket.from_bytes(bytes(wire))
    monkeypatch.setenv('PADDLE_TPU_HANDOFF_VERIFY', '0')
    with pytest.raises(HandoffError):   # a stamped packet is always checked
        KVPacket.from_bytes(bytes(wire))
    unstamped = bytearray(handoff_mod.export_packet(eng, prompt).to_bytes())
    assert b'sha1' not in bytes(unstamped)
    unstamped[-3] ^= 0xFF
    KVPacket.from_bytes(bytes(unstamped))   # never stamped: not checked
    with pytest.raises(HandoffError):
        KVPacket.from_bytes(b'XXXX' + bytes(unstamped[4:]))
    eng.shutdown()


def test_staging_no_per_handoff_allocation_growth():
    eng = _engine()
    eng.start()
    prompt = _prompt(30, seed=4)        # 7 full pages of 4
    eng.generate(prompt, max_new_tokens=1, timeout=120)
    first = handoff_mod.export_packet(eng, prompt)
    allocs_after_first = eng._staging_allocs
    assert allocs_after_first >= 1
    wires = {first.to_bytes()}
    for _ in range(4):
        wires.add(handoff_mod.export_packet(eng, prompt).to_bytes())
    assert eng._staging_allocs == allocs_after_first
    assert len(wires) == 1
    eng.shutdown()


def test_page_io_splits_lock_wait_from_copies():
    src, dst = _engine(), _engine()
    src.start()
    dst.start()
    prompt = _prompt(30, seed=4)
    src.generate(prompt, max_new_tokens=1, timeout=120)
    observe.enable()
    handoff_mod.handoff(src, dst, prompt)
    hists = observe.snapshot()['histograms']
    for op in ('read', 'write'):
        wait = hists['decode.arena_wait_seconds{op=%s}' % op]
        copy = hists['decode.page_copy_seconds{op=%s}' % op]
        assert wait['count'] == copy['count'] == 1
        assert wait['sum'] >= 0.0 and copy['sum'] > 0.0
    whole = hists['handoff.export_seconds']['sum']
    assert hists['decode.arena_wait_seconds{op=read}']['sum'] + \
        hists['decode.page_copy_seconds{op=read}']['sum'] <= whole
    src.shutdown()
    dst.shutdown()


def test_packet_of_an_unknown_dtype_is_refused():
    eng = _engine()
    eng.start()
    prompt = _prompt(9, seed=3)
    eng.generate(prompt, max_new_tokens=1, timeout=120)
    wire = handoff_mod.export_packet(eng, prompt).to_bytes()
    (hlen,) = struct.unpack('<I', wire[4:8])
    header = json.loads(wire[8:8 + hlen].decode())
    header['arenas'][0]['dtype'] = 'float7'
    hj = json.dumps(header, sort_keys=True).encode()
    bad = wire[:4] + struct.pack('<I', len(hj)) + hj + wire[8 + hlen:]
    with pytest.raises(HandoffError, match='float7'):
        KVPacket.from_bytes(bad)
    eng.shutdown()


def test_warmup_allocates_the_staging_and_touches_no_arena():
    eng = _engine(kv_dtype='int8')
    before = {n: _bits(eng._scope.get(n)) for n in eng._progs.arena_names}
    eng.warmup()
    assert eng._staging_allocs == 4     # one buffer an arena
    for n, b in before.items():
        assert _bits(eng._scope.get(n)) == b, n
    eng.start()
    prompt = _prompt(30, seed=4)
    eng.generate(prompt, max_new_tokens=1, timeout=120)
    handoff_mod.export_packet(eng, prompt)
    assert eng._staging_allocs == 4
    eng.shutdown()


def test_export_owns_its_arrays():
    eng = _engine()
    eng.start()
    a, b = _prompt(16, seed=11), _prompt(16, seed=12)
    eng.generate(a, max_new_tokens=1, timeout=120)
    eng.generate(b, max_new_tokens=1, timeout=120)
    pkt_a = handoff_mod.export_packet(eng, a)
    before = {n: _bits(t) for n, t in pkt_a.arrays.items()}
    handoff_mod.export_packet(eng, b)
    for n, t in pkt_a.arrays.items():
        assert _bits(t) == before[n], n
    eng.shutdown()


def test_install_failure_frees_pages(monkeypatch):
    src = _engine()
    src.start()
    prompt = _prompt(16, seed=13)
    src.generate(prompt, max_new_tokens=1, timeout=120)
    pkt = handoff_mod.export_packet(src, prompt)
    dst = _engine()
    free0 = dst.pool.free_blocks()

    def boom(*a, **kw):
        raise RuntimeError('injected write failure')

    monkeypatch.setattr(dst, 'write_pages', boom)
    with pytest.raises(RuntimeError):
        handoff_mod.install_packet(dst, pkt)
    assert dst.pool.free_blocks() == free0
    src.shutdown()
    dst.shutdown(drain=False)


def test_arena_set_mismatch_raises_before_alloc():
    src = _engine()
    src.start()
    prompt = _prompt(9, seed=14)
    src.generate(prompt, max_new_tokens=1, timeout=120)
    pkt = handoff_mod.export_packet(src, prompt)
    pkt.header['arena_names'] = ['lm_kcache']
    dst = _engine()
    free0 = dst.pool.free_blocks()
    with pytest.raises(KVGeometryError):
        handoff_mod.install_packet(dst, pkt)
    assert dst.pool.free_blocks() == free0
    src.shutdown()
    dst.shutdown(drain=False)


def test_oversized_page_group_chunks():
    """Page groups larger than pages_per_seq go through the staging
    buffers chunk by chunk; the round trip stays bit for bit."""
    eng = _engine()
    n = eng.pages_per_seq + 3
    ids = eng.pool.alloc(n)
    shapes = {k: tuple(t.shape) for k, t in eng.read_pages(ids).items()}
    rng = np.random.RandomState(15)
    payload = {k: rng.uniform(-1, 1, size=s).astype('float32')
               for k, s in shapes.items()}
    eng.write_pages(ids, payload)
    back = eng.read_pages(ids)
    for k, want in payload.items():
        np.testing.assert_array_equal(back[k].numpy(), want)
    with pytest.raises(ValueError):     # the arena's dtype, or nothing
        eng.write_pages(ids, {k: v.astype('float64')
                              for k, v in payload.items()})
    eng.pool.free(ids)
    eng.shutdown(drain=False)


def test_remote_replicas_wait_for_the_rpc_layer():
    class Remote(object):
        def export_packet_bytes(self, tokens):
            return b''

    with pytest.raises(NotImplementedError, match='Queue 1 item 10'):
        handoff_mod.handoff(Remote(), _engine(), [1, 2, 3, 4])


# ------------------------------------------------------------ e2e hops
@pytest.mark.parametrize('kv_dtype', ['float32', 'int8'])
def test_handoff_e2e_bit_identical(kv_dtype):
    """Prefill on A, decode on B == one engine, token for token, with
    sampling (the port against itself)."""
    prompt = _prompt(13, seed=5)
    base = _engine(kv_dtype=kv_dtype)
    base.start()
    ref = base.generate(prompt, max_new_tokens=10, temperature=0.7, seed=42,
                        timeout=120)
    base.shutdown()
    a, b = _engine(kv_dtype=kv_dtype), _engine(kv_dtype=kv_dtype)
    a.start()
    b.start()
    a.generate(prompt, max_new_tokens=1, temperature=0.7, seed=42,
               timeout=120)
    assert handoff_mod.handoff(a, b, prompt) == 12
    got = b.generate(prompt, max_new_tokens=10, temperature=0.7, seed=42,
                     timeout=120)
    assert got == ref
    a.shutdown()
    b.shutdown()


def test_handoff_then_preempt_and_resume_on_b():
    observe.enable()
    long_prompt, other_prompt = _prompt(14, seed=6), _prompt(12, seed=7)
    refs = []
    for p in (long_prompt, other_prompt):
        e = _engine()
        e.start()
        refs.append(e.generate(p, max_new_tokens=12, temperature=0.6, seed=9,
                               timeout=120))
        e.shutdown()
    a = _engine()
    a.start()
    a.generate(long_prompt, max_new_tokens=1, temperature=0.6, seed=9,
               timeout=120)
    b = _engine(num_blocks=12)          # two sequences exhaust 12 pages
    b.start()
    handoff_mod.handoff(a, b, long_prompt)
    s1 = b.submit(long_prompt, max_new_tokens=12, temperature=0.6, seed=9)
    s2 = b.submit(other_prompt, max_new_tokens=12, temperature=0.6, seed=9)
    got = [s1.result(120), s2.result(120)]
    assert observe.snapshot()['counters'].get(
        'decode.preemptions_total', 0) > 0
    assert got == refs
    a.shutdown()
    b.shutdown()
    assert b.pool.free_blocks() == b.pool.num_blocks


def _misses(snap):
    return sum(v for k, v in snap['counters'].items()
               if k.startswith('executor.cache_miss_total'))


def test_phase_router_e2e_zero_misses():
    """1 prefill + 2 decode replicas == one engine, with no executor cache
    miss after warmup on any replica, dedup across the hop for the shared
    system prompt, and the phase gauges."""
    observe.enable()
    shared = _prompt(8, seed=8)
    rng = np.random.RandomState(9)
    reqs = [dict(prompt_ids=shared + [int(t) for t in
                                      rng.randint(0, 60, 3 + i)],
                 max_new_tokens=5 + (i % 3),
                 temperature=0.0 if i % 2 else 0.6, seed=100 + i)
            for i in range(6)]
    base = _engine()
    base.start()
    refs = [base.generate(timeout=120, **r) for r in reqs]
    base.shutdown()

    pre = [_engine(name='pf0')]
    dec = [_engine(name='dc0'), _engine(name='dc1')]
    for e in pre + dec:
        e.warmup()
        e.start()
    router = PhaseRouter(pre, dec, route='hx')
    assert router.ready()
    snap0 = observe.snapshot()
    streams = [router.submit(r['prompt_ids'],
                             max_new_tokens=r['max_new_tokens'],
                             temperature=r['temperature'], seed=r['seed'],
                             session='s1') for r in reqs]
    got = [s.result(120) for s in streams]
    snap1 = observe.snapshot()
    assert got == refs
    assert _misses(snap1) - _misses(snap0) == 0
    assert sum(v for k, v in snap1['counters'].items()
               if k.startswith('executor.cache_hit_total')) > 0
    assert snap1['counters'].get('handoff.count_total', 0) == 6
    assert snap1['counters'].get('handoff.pages_deduped_total', 0) > 0
    gauges = snap1['gauges']
    assert gauges.get('router.phase_replicas{phase=prefill,route=hx}') == 1
    assert gauges.get('router.phase_replicas{phase=decode,route=hx}') == 2
    assert router.prefill_phase_p95() > 0
    assert 0 < router.decode_free_page_frac() <= 1
    assert [n for n, _ in router.pool('decode').replicas()] == ['dc0',
                                                                'dc1']
    router.close(shutdown_replicas=True)
    for e in pre + dec:
        assert e.pool.free_blocks() == e.num_blocks


def test_phase_router_colocated_and_sheds():
    dec = [_engine(name='c0')]
    dec[0].warmup()
    dec[0].start()
    router = PhaseRouter([], dec, route='cx', colocated=True)
    prompt = _prompt(9, seed=10)
    base = _engine()
    base.start()
    ref = base.generate(prompt, max_new_tokens=6, timeout=120)
    base.shutdown()
    assert router.generate(prompt, timeout=120, max_new_tokens=6) == ref
    with pytest.raises(SLOShedError):   # expired deadline: shed at submit
        router.submit(prompt, deadline_s=-0.001)
    router.close()
    with pytest.raises(EngineClosedError):
        router.submit(prompt)
    dec[0].shutdown()


def test_phase_router_refusals():
    eng = _engine(name='r0')
    with pytest.raises(ValueError):     # disaggregated needs a prefill pool
        PhaseRouter([], [eng])
    with pytest.raises(NotImplementedError, match='Queue 1 item 10'):
        PhaseRouter([], [eng], colocated=True, tenants=object())
    with pytest.raises(NotImplementedError, match='Queue 1 item 11'):
        PhaseRouter([], [eng], colocated=True, slo=object())
    # no ready replica (never started): the request fails typed
    router = PhaseRouter([], [eng], colocated=True, max_inflight=1)
    with pytest.raises(NoReplicaAvailableError):
        router.generate([1, 2, 3], timeout=60)
    router.close()
    assert issubclass(SLOShedError, QueueFullError)


def test_retry_budget_matches_reference():
    """The retry budget's token bucket: deposits capped at the burst, a
    spend takes one token, a refund gives it back (the reference's)."""
    from paddle_tpu.serving.router import _RetryBudget as RefBudget
    from paddle_tpu_torch.serving.router import _RetryBudget
    mine, ref = _RetryBudget(0.3, 2.0), RefBudget(0.3, 2.0)
    ops = ['spend', 'spend', 'spend', 'deposit', 'deposit', 'deposit',
           'deposit', 'spend', 'refund', 'deposit', 'spend', 'spend']
    for op in ops:
        got = [b.try_spend() if op == 'spend' else
               (b.deposit() if op == 'deposit' else b.refund())
               for b in (mine, ref)]
        assert got[0] == got[1] and mine.tokens == ref.tokens, op


# -------------------------------------------------- across the packages
def _cross_dtypes():
    return [d for d in DTYPES if d != 'fp8' or ref_fp8_supported()]


@pytest.mark.parametrize('kv_dtype', _cross_dtypes())
def test_packets_cross_both_ways(kv_dtype):
    """A packet exported by the JAX package's engine, through its
    to_bytes, installs in the port (from_bytes, install_packet) and the
    port decodes the JAX engine's greedy stream; a port packet installs
    in the JAX engine, which decodes the same stream. The installed pages
    read back as the packet's bits."""
    prompt = _prompt(13, seed=21)
    jax_a = _ref_engine(kv_dtype=kv_dtype)
    jax_a.start()
    want = jax_a.generate(prompt, max_new_tokens=8, timeout=120)
    jax_wire = jhandoff.export_packet(jax_a, prompt).to_bytes()
    port_a = _engine(kv_dtype=kv_dtype)
    port_a.start()
    assert port_a.generate(prompt, max_new_tokens=8, timeout=120) == want
    port_wire = handoff_mod.export_packet(port_a, prompt).to_bytes()

    # JAX -> port
    pkt = KVPacket.from_bytes(jax_wire)
    dst = _engine(kv_dtype=kv_dtype)
    assert handoff_mod.install_packet(dst, pkt) == (12, 3, 0)
    ids, _ = dst.prefix_cache.acquire(prompt)
    for name, t in dst.read_pages(ids).items():
        assert _bits(t) == _bits(pkt.arrays[name]), name
    dst.pool.free(ids)
    dst.start()
    assert dst.generate(prompt, max_new_tokens=8, timeout=120) == want

    # port -> JAX
    jpkt = jhandoff.KVPacket.from_bytes(port_wire)
    for name, t in KVPacket.from_bytes(port_wire).arrays.items():
        assert _bits(jpkt.arrays[name]) == _bits(t), name
    jdst = _ref_engine(kv_dtype=kv_dtype)
    assert jhandoff.install_packet(jdst, jpkt) == (12, 3, 0)
    jdst.start()
    assert jdst.generate(prompt, max_new_tokens=8, timeout=120) == want
    for e in (jax_a, port_a, dst, jdst):
        e.shutdown()


def test_fp8_arena_io_crosses_both_ways(tmp_path):
    """save_persistables of an fp8 decode program: the port writes an fp8
    arena as its uint8 bits under the name float8_e4m3fn, which the JAX
    package loads bit for bit; the port loads the JAX package's file (its
    npz holds the arena as a one-byte void type) as float8_e4m3fn, bit
    for bit."""
    prompt = _prompt(13, seed=22)
    eng = _engine(kv_dtype='fp8')
    eng.start()
    eng.generate(prompt, max_new_tokens=2, timeout=120)
    eng.shutdown()
    prog = eng._progs.decode
    arena = eng._scope.get('lm_kcache')
    assert arena.dtype == torch.float8_e4m3fn and arena.float().abs().sum() > 0
    with pt.scope_guard(eng._scope):
        pt.io.save_persistables(pt.Executor(pt.CPUPlace()),
                                str(tmp_path / 'port'), prog)
    with open(tmp_path / 'port' / 'manifest.json') as f:
        assert json.load(f)['lm_kcache']['dtype'] == 'float8_e4m3fn'

    ref = _ref_engine(kv_dtype='fp8')
    ref.start()
    ref.generate(prompt, max_new_tokens=2, timeout=120)
    ref.shutdown()
    ref_arena = np.asarray(ref._scope.find('lm_kcache'))
    assert ref_arena.dtype.name == 'float8_e4m3fn'
    with fluid.scope_guard(ref._scope):
        exe = fluid.Executor(fluid.CPUPlace())
        jio.save_persistables(exe, str(tmp_path / 'jax'), ref._progs.decode)
        # the port's file in the JAX package
        jio.load_persistables(exe, str(tmp_path / 'port'),
                              ref._progs.decode)
    got = np.asarray(ref._scope.find('lm_kcache'))
    assert got.view(np.uint8).tobytes() == _bits(arena)

    # the JAX package's file in the port
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.io.load_persistables(pt.Executor(pt.CPUPlace()),
                                str(tmp_path / 'jax'), prog)
    back = scope.get('lm_kcache')
    assert back.dtype == torch.float8_e4m3fn
    assert _bits(back) == ref_arena.view(np.uint8).tobytes()
