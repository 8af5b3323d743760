"""The phase router of a disaggregated decode fleet (reference: paddle_tpu
serving/router.py ``PhaseRouter``, ``HandoffStream``, ``_PhasePool`` and
the errors and retry budget they share with the single-phase ``Router``).

A prefill pool (compute-bound replicas) feeds a decode pool (replicas
bound by KV pages) through the KV page handoff (``serving.handoff``): a
long prefill never stalls a resident decode step, because the two phases
run on different replicas. ``colocated=True`` serves each request on one
decode-pool replica instead, with no handoff: the baseline at equal
replica count.

Placement: the least-loaded ready prefill replica by (queue depth + 1) x
its rolling prefill latency; the decode replica with an open batch slot
and the most free pages, with rendezvous-hash session affinity leading
the ranking (never blocking failover). A replica that dies mid-request
(EngineClosedError) is retried on the next candidate, a full one
(QueueFullError) skipped. Accepted requests complete or fail typed,
never hang. Every decision is observable: ``router.*`` counters and
gauges, ``handoff.ttft_attributed_seconds``, flight events of the hop.

Not ported yet (ROADMAP Queue 1 item 10): the single-phase ``Router``
(hedged requests, dynamic fleet membership under a controller),
``FleetController`` and the RPC transport; ``tenants=`` (quota
admission, with the rest of serving/tenancy.py) and ``slo=`` (with
observe/slo.py, Queue 1 item 11) raise NotImplementedError when given.
The reference's tuning arguments that nothing here sets (``retries``,
``session_affinity``, ``handoff_workers`` and its environment knob,
``lat_window``, ``via_bytes``) are the constants below.
"""

import itertools
import threading
import time
import zlib

from .. import observe as _obs
from ..observe import reqtrace as _reqtrace
from .engine import EngineClosedError, QueueFullError

__all__ = ['PhaseRouter', 'HandoffStream', 'NoReplicaAvailableError',
           'SLOShedError']

_RETRIES = 2            # failovers a phase tries after its first replica
_HANDOFF_WORKERS = 4    # threads running request pipelines
_LAT_WINDOW = 64        # requests in the TTFT-attribution window


class NoReplicaAvailableError(RuntimeError):
    """Every replica is down or not ready — the fleet cannot accept
    this request at all (distinct from QueueFullError: full is
    transient backpressure, this is an availability incident)."""


class SLOShedError(QueueFullError):
    """Admission control shed this request: the route's predicted p99
    exceeds its remaining latency budget, or the deadline budget was
    already exhausted at submit. A QueueFullError subclass so callers'
    existing reject/backoff handling applies unchanged."""


class _RetryBudget(object):
    """Token bucket shared by hedges and failovers: each accepted
    request deposits ``ratio`` tokens (capped at ``burst``), each
    hedge or failover dispatch spends 1.0 — so retry traffic is
    bounded by ratio x accepted + burst, by construction."""

    __slots__ = ('ratio', 'burst', 'tokens', '_mu')

    def __init__(self, ratio, burst):
        self.ratio = float(ratio)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._mu = threading.Lock()

    def deposit(self):
        with self._mu:
            self.tokens = min(self.burst, self.tokens + self.ratio)
            return self.tokens

    def try_spend(self):
        with self._mu:
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                return True
            return False

    def refund(self):
        with self._mu:
            self.tokens = min(self.burst, self.tokens + 1.0)


class _DeadlineExpired(Exception):
    """Internal pipeline signal: the request's deadline ran out
    between phases (converted to SLOShedError at the stream)."""


class HandoffStream(object):
    """The client's view of a disaggregated generation request: quacks
    like ``decode.GenerationStream`` (iterate for tokens, ``result()``
    for the full list, ``finish_reason``), but the tokens come from
    whichever decode replica the pipeline landed on. Until the decode
    phase starts, iteration and ``result()`` block; a pipeline failure
    (no replica, shed, handoff error) surfaces as that typed exception
    from either call — accepted requests settle, never hang."""

    __slots__ = ('request_id', '_evt', '_inner', '_exc')

    def __init__(self, request_id):
        self.request_id = request_id
        self._evt = threading.Event()
        self._inner = None
        self._exc = None

    # pipeline-side
    def _wire(self, inner):
        self._inner = inner
        self._evt.set()

    def _fail(self, exc):
        self._exc = exc
        self._evt.set()

    # client-side
    @property
    def finish_reason(self):
        if self._exc is not None:
            return 'error'
        return self._inner.finish_reason if self._inner is not None \
            else None

    def done(self):
        return self._exc is not None or \
            (self._inner is not None and self._inner.done())

    def __iter__(self):
        self._evt.wait()
        if self._exc is not None:
            raise self._exc
        return iter(self._inner)

    def result(self, timeout=None):
        t0 = time.perf_counter()
        if not self._evt.wait(timeout):
            raise TimeoutError('decode phase not reached within %ss'
                               % timeout)
        if self._exc is not None:
            raise self._exc
        left = None if timeout is None else \
            max(0.0, timeout - (time.perf_counter() - t0))
        return self._inner.result(left)


class PhaseRouter(object):
    """Fleet scheduler for a phase-split decode fleet: a **prefill pool**
    (admission keyed on queue depth x predicted prefill latency) feeding a
    **decode pool** (admission keyed on open batch slots and free KV
    pages) through the KV page handoff (``serving.handoff``).

    ::

        pre = [DecodeEngine(spec, prefix_cache=True, ...)]   # x P
        dec = [DecodeEngine(spec, prefix_cache=True, ...)]   # x D
        pr = PhaseRouter(pre, dec, route='disagg')
        stream = pr.submit(prompt, max_new_tokens=64, session='u1')
        for tok in stream: ...
        pr.close()

    Every replica is a ``DecodeEngine`` with ``prefix_cache=True`` (the
    cache holds the pages to export on the prefill side and registers the
    installed ones on the decode side), with the SAME weights and arena
    ``kv_dtype`` fleet-wide. The request pipeline runs on a pool of
    ``_HANDOFF_WORKERS`` threads:

    1. **prefill**: the best prefill replica runs the prompt with
       ``max_new_tokens=1`` (sampling is keyed by (seed, position), so the
       decode replica draws the same first token again from the handed-off
       pages).
    2. **handoff**: the prompt's frozen full pages hop replica: export
       (pin the chain, read through reused staging buffers), install
       (dedup against the destination cache, write the tail in place,
       publish). A shared system prompt ships once a decode replica.
    3. **decode**: the full request submits on the chosen decode replica
       and matches the just-installed chain: its prefill covers only the
       uncached suffix (fewer than block_size tokens and the sampling
       position). Neither pool captures a new graph.

    ``colocated=True`` serves each request, prefill and decode, on one
    decode-pool replica with no handoff: the baseline at equal replica
    count, and the right choice for short prompts or a tiny fleet.

    Per-phase membership is dynamic (``add_replica(r, phase=...)`` /
    ``remove_replica(name, phase=...)`` under the router lock), and
    ``pool(phase)`` gives each pool the single-phase router's membership
    surface. ``prefill_phase_p95`` and ``decode_free_page_frac`` are the
    per-phase scaling signals.
    """

    PHASES = ('prefill', 'decode')

    def __init__(self, prefill_replicas, decode_replicas, slo=None,
                 route='disagg', colocated=False, max_inflight=None,
                 tenants=None):
        if tenants is not None:
            raise NotImplementedError(
                'PhaseRouter(tenants=...): tenant quotas (the rest of '
                'serving/tenancy.py) are not ported to paddle_tpu_torch; '
                'they come with the fleet (ROADMAP Queue 1 item 10)')
        if slo is not None:
            raise NotImplementedError(
                'PhaseRouter(slo=...): observe/slo.py is not ported to '
                'paddle_tpu_torch (ROADMAP Queue 1 item 11)')
        self.route = str(route)
        self._slo = None
        self.colocated = bool(colocated)
        self._mu = threading.Lock()
        self._rr = itertools.count()
        self._ids = itertools.count(1)
        self._closed = False
        self._inflight = 0
        self._pools = {'prefill': [], 'decode': []}
        for phase, reps in (('prefill', prefill_replicas or []),
                            ('decode', decode_replicas)):
            for i, r in enumerate(reps):
                name = getattr(r, 'name', None) or \
                    '%s%d' % (phase, i)
                self.add_replica(r, phase=phase, name=name)
        if not self._pools['decode']:
            raise ValueError('PhaseRouter needs at least one decode '
                             'replica')
        if not self.colocated and not self._pools['prefill']:
            raise ValueError('PhaseRouter needs at least one prefill '
                             'replica (or colocated=True)')
        self.max_inflight = int(max_inflight) if max_inflight \
            else 8 * _HANDOFF_WORKERS
        # rolling prefill-phase latency per replica (EWMA) + a recent-
        # TTFT-attribution window (prefill + handoff seconds) the
        # per-phase autoscaling policy reads
        self._pf_lat = {}
        self._ttft_window = []
        from concurrent.futures import ThreadPoolExecutor
        self._pipeline = ThreadPoolExecutor(
            max_workers=_HANDOFF_WORKERS,
            thread_name_prefix='paddle_tpu_torch_handoff')
        self._publish()

    # -------------------------------------------------------- membership
    def add_replica(self, replica, phase='decode', name=None):
        if phase not in self.PHASES:
            raise ValueError('phase must be one of %s, got %r'
                             % (self.PHASES, phase))
        name = str(name) if name else (getattr(replica, 'name', None)
                                       or 'replica?')
        with self._mu:
            for ph in self.PHASES:
                if any(n == name for n, _ in self._pools[ph]):
                    raise ValueError('replica name %r already in the '
                                     '%s pool' % (name, ph))
            self._pools[phase].append((name, replica))
        _obs.inc('router.membership_changes_total', change='add',
                 route=self.route, phase=phase)
        self._publish()
        return name

    def remove_replica(self, name, phase=None):
        phases = (phase,) if phase else self.PHASES
        with self._mu:
            for ph in phases:
                for i, (n, r) in enumerate(self._pools[ph]):
                    if n == name:
                        del self._pools[ph][i]
                        _obs.inc('router.membership_changes_total',
                                 change='remove', route=self.route,
                                 phase=ph)
                        self._publish_locked()
                        return r
        raise KeyError('no replica named %r in %s' % (name, phases))

    def members(self, phase):
        with self._mu:
            return list(self._pools[phase])

    def pool(self, phase):
        """A Router-shaped view of one phase's membership
        (add_replica/remove_replica/replicas/route/ready) so a
        ``FleetController`` can own that phase's lifecycle without
        knowing about the other."""
        return _PhasePool(self, phase)

    # --------------------------------------------------------- liveness
    def ready(self):
        dec = any(r.ready() for _, r in self.members('decode'))
        if self.colocated:
            return dec
        return dec and any(r.ready()
                           for _, r in self.members('prefill'))

    def close(self, shutdown_replicas=False, drain=True):
        self._closed = True
        self._pipeline.shutdown(wait=True)
        if shutdown_replicas:
            for ph in self.PHASES:
                for _, r in self.members(ph):
                    r.shutdown(drain=drain)

    def _publish(self):
        with self._mu:
            self._publish_locked()

    def _publish_locked(self):
        if not _obs.enabled():
            return
        for ph in self.PHASES:
            members = self._pools[ph]
            _obs.set_gauge('router.phase_replicas', len(members),
                           phase=ph, route=self.route)
            _obs.set_gauge('router.phase_replicas_ready',
                           sum(1 for _, r in members if r.ready()),
                           phase=ph, route=self.route)

    # ------------------------------------------------- pressure signals
    def prefill_phase_p95(self):
        """p95 of the recent TTFT attribution window (prefill phase +
        handoff seconds per request) — what ``ttft_pressure`` scales
        the prefill pool on."""
        with self._mu:
            w = sorted(self._ttft_window)
        if not w:
            return None
        return w[min(len(w) - 1, int(0.95 * len(w)))]

    def decode_free_page_frac(self):
        """min over ready decode replicas of free_pages/num_blocks —
        what ``page_pressure`` scales the decode pool on (the fleet is
        as healthy as its most page-starved replica)."""
        fracs = [r.free_pages() / float(r.num_blocks)
                 for _, r in self.members('decode') if r.ready()]
        return min(fracs) if fracs else None

    def _note_prefill(self, replica_name, seconds):
        """Per-prefill-replica latency EWMA — the predicted-prefill-
        latency half of the prefill admission key."""
        with self._mu:
            prev = self._pf_lat.get(replica_name)
            self._pf_lat[replica_name] = seconds if prev is None \
                else 0.7 * prev + 0.3 * seconds

    def _note_ttft(self, seconds):
        with self._mu:
            self._ttft_window.append(seconds)
            if len(self._ttft_window) > _LAT_WINDOW:
                del self._ttft_window[:-_LAT_WINDOW]
        _obs.record('handoff.ttft_attributed_seconds', seconds,
                    route=self.route)

    # --------------------------------------------------------- placement
    def _prefill_candidates(self, exclude=()):
        """Ready prefill replicas, cheapest expected wait first:
        (queue_depth + 1) x rolling prefill latency — the compute-
        bound admission key (a deep queue on a slow replica is the
        worst seat in the house)."""
        with self._mu:
            members = list(self._pools['prefill'])
            lat = dict(self._pf_lat)
        avail = [(n, r) for n, r in members
                 if n not in exclude and r.ready()]
        return sorted(
            avail, key=lambda nr: ((nr[1].queue_depth() + 1)
                                   * lat.get(nr[0], 1e-3),
                                   next(self._rr)))

    def _decode_candidates(self, session=None, exclude=()):
        """Ready decode replicas, most headroom first: open batch
        slots, then free KV pages — the HBM-bound admission key. A
        session pins (rendezvous hash) to keep its prefixes hot on one
        replica's radix cache; the pin leads the ranking but never
        blocks failover."""
        members = self.members('decode')
        avail = [(n, r) for n, r in members
                 if n not in exclude and r.ready()]
        ranked = sorted(
            avail, key=lambda nr: (nr[1].free_slots() == 0,
                                   -nr[1].free_pages(),
                                   next(self._rr)))
        if session is not None and members:
            key = str(session).encode()
            pin = max(members,
                      key=lambda nr: zlib.crc32(
                          nr[0].encode() + b'\x00' + key))
            if pin in ranked:
                ranked.remove(pin)
                ranked.insert(0, pin)
        return ranked

    # ----------------------------------------------------------- intake
    def submit(self, prompt_ids, max_new_tokens=16, temperature=0.0,
               seed=0, eos_id=None, session=None, deadline_s=None,
               ctx=None):
        """Route one generation request through the phase pipeline;
        returns a :class:`HandoffStream` immediately. Raises
        QueueFullError when the pipeline is at ``max_inflight``
        (bounded like any admission queue), SLOShedError on an
        already-expired deadline, EngineClosedError after close().
        Accepted requests complete or fail typed — never hang."""
        if self._closed:
            raise EngineClosedError('PhaseRouter is closed')
        if ctx is None:
            ctx = _reqtrace.new_context(self.route,
                                        deadline_s=deadline_s)
        remaining = ctx.remaining()
        if remaining is not None and remaining <= 0.0:
            _obs.inc('router.phase_sheds_total',
                     reason='deadline_expired', route=self.route)
            raise SLOShedError('phase router shed: deadline budget '
                               'already exhausted')
        with self._mu:
            if self._inflight >= self.max_inflight:
                _obs.inc('router.phase_sheds_total',
                         reason='pipeline_full', route=self.route)
                raise QueueFullError(
                    'handoff pipeline full (%d inflight >= '
                    'max_inflight=%d)'
                    % (self._inflight, self.max_inflight))
            self._inflight += 1
        _obs.inc('router.phase_requests_total', route=self.route)
        stream = HandoffStream(next(self._ids))
        req = dict(prompt=[int(t) for t in prompt_ids],
                   max_new_tokens=int(max_new_tokens),
                   temperature=float(temperature), seed=int(seed),
                   eos_id=eos_id, session=session, ctx=ctx)
        try:
            self._pipeline.submit(self._run_pipeline, req, stream)
        except RuntimeError:
            with self._mu:
                self._inflight -= 1
            raise EngineClosedError('PhaseRouter is closed')
        return stream

    def generate(self, prompt_ids, timeout=None, **kwargs):
        """submit() + wait."""
        return self.submit(prompt_ids, **kwargs).result(timeout)

    # ---------------------------------------------------------- pipeline
    def _run_pipeline(self, req, stream):
        try:
            if self.colocated:
                self._decode_phase(req, stream, src=None)
            else:
                src = self._prefill_phase(req)
                self._decode_phase(req, stream, src=src)
        except _DeadlineExpired:
            _obs.inc('router.phase_sheds_total',
                     reason='deadline_expired', route=self.route)
            stream._fail(SLOShedError(
                'deadline expired in the handoff pipeline'))
        except BaseException as e:
            _obs.inc('router.phase_errors_total',
                     error=type(e).__name__, route=self.route)
            stream._fail(e)
        finally:
            with self._mu:
                self._inflight -= 1

    def _check_deadline(self, ctx):
        remaining = ctx.remaining()
        if remaining is not None and remaining <= 0.0:
            raise _DeadlineExpired()

    def _prefill_phase(self, req):
        """Dispatch the prompt-only prefill (max_new_tokens=1) to the
        best prefill replica, failing over across the pool; returns
        the replica that now holds the prompt's frozen pages in its
        cache. The sampled token is discarded — the decode replica
        regenerates it bit-identically ((seed, position)-keyed
        sampling over identical KV bits)."""
        ctx = req['ctx']
        self._check_deadline(ctx)
        t0 = time.perf_counter()
        tried = set()
        last_exc = None
        for _ in range(_RETRIES + 1):
            cands = self._prefill_candidates(exclude=tried)
            if not cands:
                break
            name, eng = cands[0]
            tried.add(name)
            try:
                s = eng.submit(req['prompt'], max_new_tokens=1,
                               temperature=req['temperature'],
                               seed=req['seed'], ctx=ctx)
                _obs.inc('router.phase_dispatch_total',
                         phase='prefill', replica=name,
                         route=self.route)
                s.result()
            except QueueFullError as e:
                last_exc = e
                continue
            except EngineClosedError as e:
                # replica died under the prefill: its pages died with
                # it — retry whole-phase on the next replica
                last_exc = e
                _obs.inc('router.failover_total', replica=name,
                         route=self.route)
                continue
            dt = time.perf_counter() - t0
            self._note_prefill(name, dt)
            if ctx.sampled:
                ctx.event('prefill_phase', replica=name,
                          seconds=round(dt, 6))
            return name, eng, t0
        if last_exc is not None:
            raise last_exc
        _obs.inc('router.no_replica_total', route=self.route,
                 phase='prefill')
        raise NoReplicaAvailableError(
            'no ready prefill replica for route %r' % self.route)

    def _decode_phase(self, req, stream, src):
        """Install the handed-off pages (when disaggregated) and
        submit the full request on the chosen decode replica; wire the
        replica's GenerationStream to the client's HandoffStream.
        Failover re-installs on the next candidate — the packet
        lives on the PREFILL replica's cache until eviction, so a
        decode replica dying mid-handoff costs one re-export."""
        from . import handoff as _handoff
        ctx = req['ctx']
        tried = set()
        last_exc = None
        for _ in range(_RETRIES + 1):
            self._check_deadline(ctx)
            cands = self._decode_candidates(req['session'],
                                            exclude=tried)
            if not cands:
                break
            name, eng = cands[0]
            tried.add(name)
            try:
                if src is not None:
                    src_name, src_eng, t0_pf = src
                    covered = _handoff.handoff(src_eng, eng,
                                               req['prompt'], ctx=ctx)
                    # TTFT attribution: prefill + handoff is the part
                    # the PHASE SPLIT added ahead of the decode
                    # replica's (small) suffix prefill
                    self._note_ttft(time.perf_counter() - t0_pf)
                    if ctx.sampled:
                        ctx.event('kv_handoff', src=src_name,
                                  dst=name, covered_tokens=covered)
                inner = eng.submit(req['prompt'],
                                   max_new_tokens=req['max_new_tokens'],
                                   temperature=req['temperature'],
                                   seed=req['seed'],
                                   eos_id=req['eos_id'], ctx=ctx)
            except QueueFullError as e:
                last_exc = e
                continue
            except EngineClosedError as e:
                last_exc = e
                _obs.inc('router.failover_total', replica=name,
                         route=self.route)
                continue
            _obs.inc('router.phase_dispatch_total', phase='decode',
                     replica=name, route=self.route)
            stream._wire(inner)
            return
        if last_exc is not None:
            raise last_exc
        _obs.inc('router.no_replica_total', route=self.route,
                 phase='decode')
        raise NoReplicaAvailableError(
            'no ready decode replica for route %r' % self.route)


class _PhasePool(object):
    """Router-membership adapter for one phase of a PhaseRouter: the
    single-phase router's surface (add_replica / remove_replica /
    replicas / route / ready), so a per-phase controller can own that
    phase's lifecycle."""

    def __init__(self, router, phase):
        if phase not in PhaseRouter.PHASES:
            raise ValueError('unknown phase %r' % phase)
        self._router = router
        self.phase = phase
        self.route = '%s/%s' % (router.route, phase)
        self._slo = router._slo

    def replicas(self):
        return self._router.members(self.phase)

    def add_replica(self, replica, name=None):
        return self._router.add_replica(replica, phase=self.phase,
                                        name=name)

    def remove_replica(self, name):
        return self._router.remove_replica(name, phase=self.phase)

    def ready(self):
        return any(r.ready() for _, r in self.replicas())
