"""paddle_tpu_torch.observe — the telemetry core (reference: paddle_tpu
observe/__init__.py; the same metric names, snapshot keys, flight-dump
keys and request-trace wire form).

- a dependency-free metrics registry: labeled counters / gauges /
  histograms with a JSONL sink and an end-of-run summary table
  (`registry.py`),
- host-side span tracing exported as Chrome-trace/Perfetto JSON, bridged
  to ``torch.profiler.record_function`` so host spans line up with the
  card's kernels in a torch profile (`spans.py`),
- a flight recorder: a bounded ring of structured events dumped as a
  postmortem JSON (`flight.py`),
- per-request tracing: ``RequestContext`` correlates one request's spans
  across threads and, through its wire form in the KV packet header,
  across processes (`reqtrace.py`),
- a health-check registry the engines register their readiness in
  (``run_health_checks`` reads it).

Every helper checks ``enabled()`` first, a module-global read: with
telemetry off a hot loop pays one boolean test a call site. Turn it on
with::

    from paddle_tpu_torch import observe
    observe.enable(jsonl='run_metrics.jsonl', trace='run_trace.json')
    ...serve...
    observe.disable()          # final snapshot + trace export

Not ported yet (ROADMAP Queue 1 item 11), and absent: MFU and goodput
accounting (`mfu.py`), anomaly detection, the diagnostics HTTP server
(``serve``), the fleet view, SLO tracking, and the SIGTERM postmortem
handler.
"""

import atexit
import os
import threading
import time
import zlib

from .flight import FlightRecorder
from .registry import Registry
from .spans import SpanRecorder

__all__ = ['enabled', 'enable', 'disable', 'reset', 'registry', 'spans',
           'inc', 'set_gauge', 'add_gauge', 'record', 'get_gauge',
           'get_counter', 'snapshot', 'span', 'key_id', 'flush',
           'export_trace', 'register_health_check',
           'unregister_health_check', 'run_health_checks',
           'flight_recorder', 'flight_event', 'flight_dump', 'arm_flight']

_enabled = False          # THE gate: helpers read this module global
_REG = Registry()
_SPANS = SpanRecorder()
_FLIGHT = FlightRecorder()
_SINK = {'path': None, 'trace_path': None}
_atexit_armed = []

# flight recording has its own gate so a forensics-only run (arm_flight,
# metrics off) still records the ring: _flight_on == (_enabled or
# _flight_armed), kept at every state change
_flight_on = False
_flight_armed = False
_FLIGHT_DUMP = {'path': None, 'last_exc': None, 'last_path': None}

_checks_lock = threading.Lock()
_checks = {}              # name -> (fn, readiness_only)

# span drops become a registry counter (a truncated trace shows in a
# snapshot). Name-based lookup so reset() cannot orphan the counter.
_SPANS.on_drop = lambda n=1: (
    _REG.counter('spans_dropped_total').inc(n) if _enabled else None)


# ------------------------------------------------------------- lifecycle
def enabled():
    """True when telemetry is on. The disabled fast path everywhere is
    this one global read."""
    return _enabled


def enable(jsonl=None, trace=None):
    """Turn telemetry on. ``jsonl`` appends metric snapshots (one JSON
    object a line: ``flush()``, and a ``kind: "summary"`` line on
    disable() / exit); ``trace`` writes a Chrome-trace JSON of the
    recorded spans at the same points."""
    global _enabled, _flight_on
    _enabled = True
    _flight_on = True
    if jsonl is not None:
        _SINK['path'] = jsonl
    if trace is not None:
        _SINK['trace_path'] = trace
    if not _atexit_armed:
        _atexit_armed.append(True)
        atexit.register(_atexit_flush)


def disable():
    """Final snapshot (kind 'summary') + trace export, then gate off.
    Flight recording stays on when separately armed (arm_flight)."""
    global _enabled, _flight_on
    if _enabled:
        flush(kind='summary')
        export_trace()
    _enabled = False
    _flight_on = _flight_armed


def reset():
    """Clear every metric, span and flight event (the sink paths and the
    enabled flag survive)."""
    _REG.clear()
    _SPANS.clear()
    _FLIGHT.clear()


def _atexit_flush():
    if _enabled:
        try:
            flush(kind='summary')
            export_trace()
        except Exception:
            pass


# --------------------------------------------------------------- access
def registry():
    return _REG


def spans():
    return _SPANS


# ------------------------------------------------- gated helper facade
def inc(name, n=1, **labels):
    if _enabled:
        _REG.counter(name).inc(n, **labels)


def set_gauge(name, value, **labels):
    if _enabled:
        _REG.gauge(name).set(value, **labels)


def add_gauge(name, n, **labels):
    if _enabled:
        _REG.gauge(name).add(n, **labels)


def record(name, value, exemplar=None, **labels):
    """Histogram observation; ``exemplar`` (a trace id) rides along to
    the worst-bucket exemplar slot (see reqtrace.py)."""
    if _enabled:
        _REG.histogram(name).observe(value, exemplar=exemplar, **labels)


def get_gauge(name, default=None, **labels):
    return _REG.gauge(name).value(default=default, **labels)


def get_counter(name, **labels):
    return _REG.counter(name).value(**labels)


class _NullCtx(object):
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()


class _SpanCtx(object):
    __slots__ = ('name', 'attrs', '_sp')

    def __init__(self, name, attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self._sp = _SPANS.begin(self.name, self.attrs or None)
        return self._sp

    def __exit__(self, *exc):
        _SPANS.end(self._sp)
        return False


def span(name, **attrs):
    """Context manager recording one nested host span (and a
    torch.profiler range of the same name). A no-op singleton when
    disabled."""
    if not _enabled:
        return _NULL
    return _SpanCtx(name, attrs)


def key_id(key):
    """Stable 8-hex-digit id for an unwieldy cache key, used as a metric
    label (full keys embed object ids and shape tuples)."""
    return '%08x' % (zlib.crc32(repr(key).encode()) & 0xffffffff)


def _host():
    """The ``host`` tag of snapshots and dumps: ``PADDLE_TPU_OBSERVE_HOST``
    (read per call: a replica's name), else 0 (one process)."""
    return os.environ.get('PADDLE_TPU_OBSERVE_HOST') or 0


def snapshot():
    snap = _REG.snapshot()
    snap['host'] = _host()
    snap['pid'] = os.getpid()
    return snap


# ---------------------------------------------------------------- sink
def flush(kind='snapshot'):
    """Append one JSONL snapshot line now (when a sink path is set)."""
    path = _SINK['path']
    if not path:
        return
    line = _REG.to_json_line(ts=round(time.time(), 3), kind=kind,
                             pid=os.getpid(), host=_host())
    with open(path, 'a') as f:
        f.write(line + '\n')


def export_trace(path=None):
    """Write the Chrome trace JSON (default: the enable(trace=...) path).
    Returns the path written, or None when there is nowhere to write."""
    path = path or _SINK['trace_path']
    if not path:
        return None
    return _SPANS.export(path)


# --------------------------------------------------------- health checks
def register_health_check(name, fn, readiness_only=False):
    """Register ``fn`` under ``name``: ``fn()`` returns truthy/falsy or
    ``(ok, detail)``; raising counts as failing. ``readiness_only`` checks
    count only for readiness (an engine not warmed up yet is unready, not
    unhealthy). Re-registering a name replaces it."""
    if not callable(fn):
        raise TypeError('health check %r is not callable' % name)
    with _checks_lock:
        _checks[str(name)] = (fn, bool(readiness_only))


def unregister_health_check(name):
    with _checks_lock:
        _checks.pop(str(name), None)


def run_health_checks(include_readiness=False):
    """(all_ok, {name: {'ok', 'detail'}}) over the registered checks."""
    with _checks_lock:
        items = sorted(_checks.items())
    results = {}
    all_ok = True
    for name, (fn, readiness_only) in items:
        if readiness_only and not include_readiness:
            continue
        try:
            r = fn()
            if isinstance(r, tuple):
                ok, detail = bool(r[0]), r[1]
            else:
                ok, detail = bool(r), None
        except Exception as e:
            ok, detail = False, '%s: %s' % (type(e).__name__, e)
        results[name] = {'ok': ok, 'detail': detail}
        all_ok = all_ok and ok
    return all_ok, results


# --------------------------------------------------------- flight recorder
def flight_recorder():
    return _FLIGHT


def flight_event(kind, /, **data):
    """Append one structured event to the flight ring. One module-global
    boolean read when neither telemetry nor the recorder is armed."""
    if _flight_on:
        _FLIGHT.record(kind, **data)


def arm_flight(path=None, capacity=None):
    """Turn flight recording on independently of the metrics gate and
    (optionally) set the postmortem dump path."""
    global _flight_armed, _flight_on
    _flight_armed = True
    _flight_on = True
    if capacity:
        _FLIGHT.capacity = int(capacity)
    if path:
        _FLIGHT_DUMP['path'] = path
    return _FLIGHT


def flight_dump(reason, exc=None, path=None, extra=None):
    """Write the postmortem JSON now (ring + final metrics snapshot + last
    spans + exception). A no-op unless flight recording is on AND a path
    is known. Re-dumping for the SAME exception object is a no-op. Never
    raises: forensics must not mask the original failure. Returns the
    path written, or None."""
    if not _flight_on:
        return None
    path = path or _FLIGHT_DUMP['path']
    if not path:
        return None
    if exc is not None and exc is _FLIGHT_DUMP['last_exc']:
        return _FLIGHT_DUMP['last_path']
    try:
        p = _FLIGHT.dump(path, reason, exc=exc, metrics=_REG.snapshot(),
                         spans=_SPANS.events()[-100:], anomalies={},
                         host=_host(), extra=extra)
    except Exception:
        return None
    if exc is not None:
        _FLIGHT_DUMP['last_exc'] = exc
        _FLIGHT_DUMP['last_path'] = p
    return p
