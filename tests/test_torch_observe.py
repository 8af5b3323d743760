"""The port's observe core and loadgen against the reference's: the same
inc / set_gauge / record calls give equal snapshots, request-trace
contexts cross between the packages through their wire form, the flight
dump and the Chrome trace carry the reference's keys, the engines'
readiness checks and the executor's cache counters land in the registry,
and loadgen's draws equal the reference's for the same seeds."""

import json
import threading
import time

import numpy as np
import pytest

from paddle_tpu import observe as jobs
from paddle_tpu.observe import reqtrace as jrt
from paddle_tpu.serving import loadgen as jlg

import paddle_tpu_torch as pt
from paddle_tpu_torch import observe
from paddle_tpu_torch.observe import reqtrace as prt
from paddle_tpu_torch.observe.registry import Registry, parse_rendered
from paddle_tpu_torch.serving import QueueFullError
from paddle_tpu_torch.serving import loadgen as plg
from paddle_tpu_torch.serving.decode import (DecodeEngine, LMSpec,
                                             random_weights)


@pytest.fixture(autouse=True)
def _clean():
    for mod in (observe, jobs):
        mod.reset()
    yield
    for mod in (observe, jobs):
        mod._SINK['path'] = None
        mod._SINK['trace_path'] = None
        mod._flight_armed = False
        mod.disable()
        mod.reset()


def _drive(mod):
    """One fixed sequence of calls through a package's module API."""
    mod.inc('handoff.count_total')
    mod.inc('handoff.bytes_total', 7168)
    mod.inc('executor.cache_miss_total', kind='single', key=mod.key_id(
        ('prog', 3, (('x', (4, 8), 'float32'),))))
    mod.inc('router.phase_dispatch_total', 3, phase='decode',
            replica='dc0', route='r')
    mod.set_gauge('router.phase_replicas', 2, phase='decode', route='r')
    mod.set_gauge('decode.kv_fragmentation', 0.25)
    mod.add_gauge('decode.kv_free_pages', 5)
    mod.add_gauge('decode.kv_free_pages', -2)
    rng = np.random.RandomState(3)
    for v in rng.exponential(0.01, 300):
        mod.record('handoff.seconds', float(v))
    mod.record('decode.ttft_seconds', 0.05, exemplar='abc', cached='1')
    mod.record('decode.ttft_seconds', 0.02, exemplar='def', cached='1')


def test_snapshots_equal_across_packages():
    assert observe.snapshot()['counters'] == {}
    observe.enable()
    jobs.enable()
    _drive(observe)
    _drive(jobs)
    mine, ref = observe.snapshot(), jobs.snapshot()
    assert mine == ref
    assert mine['counters']['handoff.bytes_total'] == 7168
    assert mine['gauges']['decode.kv_free_pages'] == 3
    h = mine['histograms']['decode.ttft_seconds{cached=1}']
    assert h['exemplar'] == {'value': 0.05, 'trace_id': 'abc'}
    assert observe.get_counter('handoff.count_total') == 1
    assert observe.get_gauge('router.phase_replicas', phase='decode',
                             route='r') == 2
    assert observe.registry().summary_table() == \
        jobs.registry().summary_table()


def test_disabled_helpers_record_nothing():
    _drive(observe)
    snap = observe.snapshot()
    assert snap['counters'] == {} and snap['gauges'] == {} and \
        snap['histograms'] == {}
    with observe.span('x') as sp:
        assert sp is None
    observe.flight_event('nothing')
    assert observe.flight_recorder().events() == []


@pytest.mark.parametrize('rendered', [
    'handoff.count_total', 'router.phase_replicas{phase=decode,route=r}',
    'executor.cache_miss_total{key=1a2b3c4d,kind=single}'])
def test_parse_rendered_matches_reference(rendered):
    from paddle_tpu.observe.registry import parse_rendered as ref_parse
    assert parse_rendered(rendered) == ref_parse(rendered)


def test_registry_refuses_a_second_type():
    reg = Registry()
    reg.counter('x')
    with pytest.raises(TypeError):
        reg.gauge('x')


def test_flush_writes_jsonl_lines_of_the_reference(tmp_path):
    observe.enable(jsonl=str(tmp_path / 'p.jsonl'))
    jobs.enable(jsonl=str(tmp_path / 'j.jsonl'))
    _drive(observe)
    _drive(jobs)
    observe.flush(kind='summary')
    jobs.flush(kind='summary')
    mine = json.loads(open(tmp_path / 'p.jsonl').read().splitlines()[-1])
    ref = json.loads(open(tmp_path / 'j.jsonl').read().splitlines()[-1])
    assert sorted(mine) == sorted(ref)
    for k in ('counters', 'gauges', 'histograms', 'kind', 'host', 'pid'):
        assert mine[k] == ref[k]


# ------------------------------------------------------------- reqtrace
@pytest.mark.parametrize('direction', ['port_to_ref', 'ref_to_port'])
def test_reqtrace_wire_crosses_packages(direction):
    observe.enable()
    jobs.enable()
    src, dst = (prt, jrt) if direction == 'port_to_ref' else (jrt, prt)
    ctx = src.new_context('disagg', deadline_s=30.0, sample=1.0,
                          baggage={'tenant': 'acme'})
    assert ctx.sampled and len(ctx.trace_id) == 12
    wire = ctx.to_wire()
    assert sorted(wire) == ['baggage', 'deadline_s', 'route', 'sampled',
                            'trace_id']
    back = dst.from_wire(json.loads(json.dumps(wire)))
    assert back.trace_id == ctx.trace_id and back.sampled
    assert back.route == 'disagg' and back.baggage == {'tenant': 'acme'}
    assert 29.0 < back.remaining() <= 30.0
    assert back.to_wire()['trace_id'] == wire['trace_id']
    assert dst.from_wire(None) is None
    # unsampled, no deadline: the same wire form both ways
    plain = src.new_context('decode', sample=0.0)
    assert plain.to_wire() == dst.from_wire(plain.to_wire()).to_wire()


def test_reqtrace_records_stages_on_the_port_spans():
    observe.enable()
    ctx = prt.new_context('decode', sample=1.0)
    t0 = time.perf_counter()
    ctx.stage('prefill', t0, t0 + 0.001, bucket=16)
    ctx.event('token', pos=1)
    ctx.flow_begin('decode_request')
    ctx.flow_end()
    names = [e['name'] for e in observe.spans().events()]
    assert names == ['prefill', 'token', 'decode_request', 'decode_request']
    assert all(e['args']['trace_id'] == ctx.trace_id
               for e in observe.spans().events())
    observe.disable()
    assert not prt.new_context('decode', sample=1.0).sampled


def test_span_trace_export_has_the_reference_keys(tmp_path):
    observe.enable(trace=str(tmp_path / 'p.json'))
    jobs.enable(trace=str(tmp_path / 'j.json'))
    for mod in (observe, jobs):
        with mod.span('handoff.export', pages=3):
            with mod.span('inner'):
                pass
        mod.export_trace()
    mine = json.load(open(tmp_path / 'p.json'))
    ref = json.load(open(tmp_path / 'j.json'))
    assert sorted(mine) == sorted(ref)
    assert [sorted(e) for e in mine['traceEvents']] == \
        [sorted(e) for e in ref['traceEvents']]
    assert [e['name'] for e in mine['traceEvents']] == ['inner',
                                                        'handoff.export']


# --------------------------------------------------------------- flight
def test_flight_dump_has_the_reference_keys(tmp_path):
    for mod in (observe, jobs):
        mod.arm_flight()
        mod.flight_event('kv_handoff', pages=3, kind='x', seconds=0.5,
                         bad=float('nan'))
    err = RuntimeError('boom')
    mine = observe.flight_dump('test', exc=err,
                               path=str(tmp_path / 'p.json'))
    ref = jobs.flight_dump('test', exc=err, path=str(tmp_path / 'j.json'))
    # the same exception dumps once
    assert observe.flight_dump('again', exc=err,
                               path=str(tmp_path / 'other.json')) == mine
    a, b = json.load(open(mine)), json.load(open(ref))
    assert sorted(a) == sorted(b)
    assert a['kind'] == 'paddle_tpu_postmortem' and a['schema'] == 1
    assert a['events'][-1]['data'] == b['events'][-1]['data']
    assert a['exception']['type'] == 'RuntimeError'
    assert a['host'] == b['host'] == 0


def test_health_checks_follow_the_engine():
    spec = LMSpec(vocab_size=60, n_layer=1, n_head=2, d_key=4, d_value=4,
                  d_model=8, d_inner=16)
    eng = DecodeEngine(spec, max_batch=2, block_size=4, num_blocks=16,
                       pages_per_seq=4, weights=random_weights(spec, 1),
                       place=pt.CPUPlace(), name='r0')
    eng.start()
    ok, checks = observe.run_health_checks(include_readiness=True)
    mine = [v for k, v in checks.items() if k.startswith('decode.engine')]
    assert not ok and mine == [{'ok': False, 'detail': 'not warmed up'}]
    assert observe.run_health_checks()[0]      # readiness only
    eng.warmup()
    assert observe.run_health_checks(include_readiness=True)[0]
    with eng:
        assert eng.queue_depth() == 0 and eng.free_slots() == 2
        assert eng.decode_load() == (16, 2, 0)
        assert eng.kv_geometry()['arena_names'] == ('lm_kcache',
                                                    'lm_vcache')
        assert eng.arena_specs() == {'lm_kcache': None, 'lm_vcache': None}
    assert not [k for k in observe.run_health_checks(True)[1]
                if k.startswith('decode.engine')]
    with pytest.raises(TypeError):
        observe.register_health_check('x', None)


def test_executor_counts_cache_misses_and_hits():
    observe.enable()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name='x', shape=[3], dtype='float32')
        y = pt.layers.scale(x, scale=2.0)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup)
    feed = {'x': np.ones((2, 3), 'f')}
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[y])
    exe.run_steps(2, main, feed=feed, fetch_list=[y])
    c = observe.snapshot()['counters']

    def total(prefix, kind):
        return sum(v for k, v in c.items()
                   if k.startswith(prefix) and 'kind=%s' % kind in k)

    assert total('executor.cache_miss_total', 'single') == 2  # both programs
    assert total('executor.cache_hit_total', 'single') == 2
    # run_steps runs run's key: a hit
    assert total('executor.cache_hit_total', 'multi') == 1
    assert total('executor.cache_miss_total', 'multi') == 0
    assert observe.key_id(('a', 1)) == jobs.key_id(('a', 1))


# -------------------------------------------------------------- loadgen
@pytest.mark.parametrize('seed', [0, 7, 1234])
def test_loadgen_draws_equal_reference(seed):
    kw = dict(long_prompt_frac=0.35, short_prompt=(16, 64),
              long_prompt=(448, 512), short_new=(4, 8), long_new=(48, 64))
    for fn, args in ((lambda m, r: m.phase_mix(r, **kw), ()),
                     (lambda m, r: m.phase_mix(r), ()),
                     (lambda m, r: m.heavy_tailed_rows(r, 4, 64), ()),
                     (lambda m, r: m.tenant_mix(
                         r, [('acme', 3), ('zeta', 1)]), ()),
                     (lambda m, r: m.tenant_mix(
                         r, [('acme', 3), ('zeta', 1)], phases=True), ())):
        a, b = np.random.RandomState(seed), np.random.RandomState(seed)
        assert [fn(plg, a) for _ in range(50)] == \
            [fn(jlg, b) for _ in range(50)]
    lat = list(np.random.RandomState(seed).exponential(0.1, 99))
    assert plg.percentiles(lat) == jlg.percentiles(lat)
    assert plg.percentiles([]) == jlg.percentiles([])
    for t in (0.0, 1.3, 5.0, 9.9):
        assert plg.diurnal(2, 10, 10)(t) == jlg.diurnal(2, 10, 10)(t)
        sched = [(0, 1.0), (2, 5.0)]
        assert plg.qps_at(sched, t) == jlg.qps_at(sched, t)
        assert plg.flash_crowd(sched, 20, 1, 2)(t) == \
            jlg.flash_crowd(sched, 20, 1, 2)(t)


def test_loadgen_loops_count_rejects_and_errors():
    stats = plg.Stats()
    calls = {'n': 0}
    lock = threading.Lock()

    def do_request(rng):
        with lock:
            calls['n'] += 1
            n = calls['n']
        if n % 5 == 0:
            raise QueueFullError('full')
        if n % 7 == 0:
            raise ValueError('bad')
        return 2

    plg.closed_loop(do_request, stats, time.perf_counter() + 0.2, 3)
    assert stats.ok > 0 and stats.rejected > 0 and stats.errors > 0
    assert stats.rows == 2 * stats.ok
    assert stats.counts_between(0, 1e9) == {
        'ok': stats.ok, 'rejected': stats.rejected, 'errors': stats.errors}

    # a fixed number of requests: the clients stop after the last one
    bounded = plg.Stats()
    plg.closed_loop(lambda rng: 1, bounded, time.perf_counter() + 60, 4,
                    requests=10)
    assert bounded.ok == 10

    from concurrent.futures import Future
    open_stats = plg.Stats()

    def submit_request(rng):
        f = Future()
        f.set_result(None)
        return f, 1

    plg.open_loop(submit_request, open_stats, time.perf_counter() + 0.2,
                  200.0)
    assert open_stats.ok > 0 and open_stats.rows == open_stats.ok
