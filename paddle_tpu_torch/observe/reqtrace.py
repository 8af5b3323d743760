"""Per-request distributed tracing: one trace id across threads and
processes (reference: paddle_tpu observe/reqtrace.py; the same wire
form, so a context crosses between the packages in a KV packet header).

A disaggregated request crosses several threads: the client calls
``PhaseRouter.submit``, a handoff worker runs the prefill phase and the
KV hop, and each replica's worker prefills and decodes it.
``RequestContext`` is the correlating handle:

- created once at admission (``DecodeEngine.submit`` /
  ``PhaseRouter.submit``) with a fresh ``trace_id``, the route name, an
  optional absolute deadline, and a sampling decision,
- carried on the request (``Sequence.ctx``) across every thread hop,
- each stage calls ``ctx.stage(name, t0, t1)`` on whatever thread
  completed it, plus ``ctx.event(name)`` for zero-duration marks
  (per-token decode events),
- thread hops are linked by Chrome-trace flow events (``ctx.flow_*``),
- PROCESS hops ride the wire form: ``ctx.to_wire()`` is a JSON-safe
  dict (trace id, sampling bit, deadline as a *relative* remaining
  budget, route, baggage) that serving/handoff.py stamps into every KV
  packet header; ``from_wire()`` rebuilds the context on the far side.

Sampling: ``PADDLE_TPU_TRACE_SAMPLE`` (a fraction, read PER CALL, never
at import) decides whether a request records spans; unsampled requests
carry a context whose recording methods are no-ops. The engines pass
``ctx.exemplar()`` (the trace id when sampled) into their latency
histograms, so the worst sample names the trace that caused it.
"""

import os
import random
import sys
import threading
import time

__all__ = ['RequestContext', 'new_context', 'sample_rate',
           'from_wire', 'TRACE_SAMPLE_ENV']


def _obs():
    # the parent package, resolved at call time: ``observe.spans`` names
    # both the submodule and the accessor function, so a from-import
    # here would bind whichever happened to win at import order
    return sys.modules[__name__.rpartition('.')[0]]


def _enabled():
    return _obs().enabled()


def _spans_fn():
    return _obs().spans()

TRACE_SAMPLE_ENV = 'PADDLE_TPU_TRACE_SAMPLE'

_rng = random.Random()
_rng_lock = threading.Lock()


def sample_rate(environ=None):
    """The live trace-sampling fraction in [0, 1] — read from the
    environment PER CALL (never at import), default 0.
    Malformed values read as 0 rather than raising mid-submit."""
    env = os.environ if environ is None else environ
    raw = env.get(TRACE_SAMPLE_ENV)
    if not raw:
        return 0.0
    try:
        return min(1.0, max(0.0, float(raw)))
    except ValueError:
        return 0.0


def _new_trace_id():
    # 48 bits: unique enough for any run's sampled set, and small
    # enough that the int form (the Chrome-trace flow id) survives
    # every JSON parser's float path exactly
    with _rng_lock:
        return '%012x' % _rng.getrandbits(48)


def new_context(route, deadline_s=None, sample=None, baggage=None):
    """Create the per-request context at admission. ``deadline_s`` is a
    relative budget (seconds from now); ``sample`` overrides the
    environment sampling fraction (pass 1.0/0.0 for deterministic
    tests); ``baggage`` is a small JSON-safe dict that rides the wire
    form across process hops. A request is only ever sampled while
    telemetry is enabled — spans would be dropped on the floor
    otherwise."""
    rate = sample_rate() if sample is None else float(sample)
    if rate >= 1.0:
        sampled = True
    elif rate <= 0.0:
        sampled = False
    else:
        with _rng_lock:
            sampled = _rng.random() < rate
    sampled = bool(sampled and _enabled())
    return RequestContext(
        trace_id=_new_trace_id() if sampled else None,
        route=route,
        deadline=(time.perf_counter() + float(deadline_s))
        if deadline_s is not None else None,
        sampled=sampled, baggage=baggage)


def from_wire(doc, route=None):
    """Reconstitute a :class:`RequestContext` from its ``to_wire()``
    dict on the receiving side of a process hop. Returns None for a
    falsy ``doc`` (the hop carried no trace). The trace id and baggage
    survive verbatim; the *relative* ``deadline_s`` budget becomes an
    absolute perf_counter deadline on THIS process's clock (wall-clock
    skew between hosts never corrupts the budget); the sampling bit is
    honored only while local telemetry is enabled — same contract as
    admission. A sampled reconstituted context is pre-armed with a
    flow handle (flow id = trace id), so ``flow_step``/``flow_end`` on
    the receiving side link back to the sender's ``flow_begin``."""
    if not doc:
        return None
    trace_id = doc.get('trace_id')
    sampled = bool(doc.get('sampled')) and trace_id is not None \
        and _enabled()
    deadline_s = doc.get('deadline_s')
    ctx = RequestContext(
        trace_id=trace_id,
        route=route if route is not None else doc.get('route'),
        deadline=(time.perf_counter() + float(deadline_s))
        if deadline_s is not None else None,
        sampled=sampled, baggage=doc.get('baggage'))
    if sampled:
        from .spans import FlowHandle
        ctx._flow = FlowHandle(int(trace_id, 16), 'rpc')
    return ctx


class RequestContext(object):
    """Identity + budget + recording surface for one request."""

    __slots__ = ('trace_id', 'route', 'deadline', 'sampled', 't_start',
                 'baggage', '_flow')

    def __init__(self, trace_id, route, deadline, sampled,
                 baggage=None):
        self.trace_id = trace_id
        self.route = route
        self.deadline = deadline      # absolute perf_counter, or None
        self.sampled = sampled
        self.t_start = time.perf_counter()
        self.baggage = dict(baggage) if baggage else None
        self._flow = None

    # ----------------------------------------------------------- wire
    def to_wire(self):
        """JSON-safe wire form for a process hop: trace id, sampling
        bit, the deadline converted to a RELATIVE remaining budget
        (absolute perf_counter values are meaningless in another
        process), the route, and the baggage dict. Always returns a
        dict — the sender decides whether to attach it."""
        remaining = self.remaining()
        return {'trace_id': self.trace_id,
                'sampled': bool(self.sampled),
                'deadline_s': remaining,
                'route': self.route,
                'baggage': self.baggage}

    # ------------------------------------------------------------ budget
    def remaining(self):
        """Seconds of deadline budget left (None without a deadline;
        negative once blown)."""
        if self.deadline is None:
            return None
        return self.deadline - time.perf_counter()

    def expired(self):
        return self.deadline is not None and \
            time.perf_counter() > self.deadline

    def exemplar(self):
        """The trace id when sampled, else None — feed it straight to
        ``observe.record(..., exemplar=ctx.exemplar())``."""
        return self.trace_id if self.sampled else None

    # --------------------------------------------------------- recording
    def _attrs(self, extra=None):
        a = {'trace_id': self.trace_id, 'route': self.route}
        if extra:
            a.update(extra)
        return a

    def stage(self, name, t0, t1, **attrs):
        """Record one completed stage of this request's timeline
        (explicit perf_counter bounds, calling thread's track)."""
        if self.sampled:
            _spans_fn().add_span(name, t0, t1, attrs=self._attrs(attrs))

    def event(self, name, **attrs):
        """Zero-duration mark on this request's timeline (per-token
        decode events, shed/retry decisions)."""
        if self.sampled:
            _spans_fn().add_instant(name, attrs=self._attrs(attrs))

    # ------------------------------------------------- cross-thread flow
    def flow_begin(self, name):
        """Start (or restart) this request's flow arrow on the calling
        thread; the consumer thread's flow_step/flow_end links its
        spans back to this point. Flow id = the trace id, so the raw
        Perfetto JSON stays greppable by either."""
        if not self.sampled:
            return None
        self._flow = _spans_fn().flow_begin(
            name, attrs=self._attrs(), flow_id=int(self.trace_id, 16))
        return self._flow

    def flow_step(self, name=None):
        if self.sampled and self._flow is not None:
            _spans_fn().flow_step(self._flow, attrs=self._attrs())

    def flow_end(self, name=None):
        if self.sampled and self._flow is not None:
            _spans_fn().flow_end(self._flow, attrs=self._attrs())
            self._flow = None
