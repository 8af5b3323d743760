"""Flight recorder: a bounded ring of structured events and its
postmortem dump (reference: paddle_tpu observe/flight.py; the same JSON
keys, so tools/flight_report.py renders a dump of either package).

A serving replica's most valuable telemetry is its last few seconds, the
part a periodic JSONL sink has not flushed yet. The recorder keeps the
last ``capacity`` structured events (handoffs, rejections, preemptions,
pool exhaustion, evictions, worker deaths) in memory at deque-append
cost, and ``dump()`` writes one self-contained postmortem JSON: ring
contents, the final metrics snapshot, the last spans, and the exception.

Call sites go through ``observe.flight_event(kind, **data)`` (one
module-global boolean read when off) and ``observe.flight_dump``.

Postmortem JSON schema (``SCHEMA_VERSION``):

    kind             "paddle_tpu_postmortem"
    schema           1
    reason           why the dump happened
    ts / pid / host  dump wall time, process id, the replica name or 0
    uptime_seconds   recorder lifetime at dump
    exception        {type, message, traceback} or null
    events           ring contents, oldest first ({seq, ts, kind, data})
    events_total     events ever recorded
    evicted_events   events pushed out of the ring before the dump
    metrics          observe registry snapshot (counters/gauges/histograms)
    spans            last completed spans ({name, ts, dur, ...})
    anomalies        per-signal detector state ({} until the anomaly
                     monitor is ported)
"""

import collections
import json
import math
import os
import threading
import time
import traceback

__all__ = ['FlightRecorder', 'DEFAULT_CAPACITY', 'SCHEMA_VERSION',
           'POSTMORTEM_KIND']

DEFAULT_CAPACITY = 512
SCHEMA_VERSION = 1
POSTMORTEM_KIND = 'paddle_tpu_postmortem'


def _jsonable(v):
    """Coerce one event-data value to something json.dumps round-trips
    losslessly with json.loads (NaN/Inf become strings, numpy scalars
    unwrap, everything unknown stringifies)."""
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, float):
        return v if math.isfinite(v) else repr(v)
    item = getattr(v, 'item', None)   # numpy scalar
    if item is not None:
        try:
            return _jsonable(v.item())
        except Exception:
            pass
    return str(v)


def _format_exception(exc):
    if exc is None:
        return None
    try:
        tb = ''.join(traceback.format_exception(
            type(exc), exc, exc.__traceback__))
    except Exception:
        tb = None
    return {'type': type(exc).__name__, 'message': str(exc),
            'traceback': tb}


class FlightRecorder(object):
    """Thread-safe bounded ring of {seq, ts, kind, data} events."""

    def __init__(self, capacity=DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self.started_at = time.time()
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=self.capacity)
        self._seq = 0
        self._evicted = 0

    # ------------------------------------------------------------ record
    def record(self, kind, /, **data):
        """Append one event. Cheap: one dict build + locked deque
        append; old events fall off the far end. (`kind` is
        positional-only so event data may itself carry a `kind` key.)"""
        ev = {'ts': round(time.time(), 6), 'kind': str(kind)}
        if data:
            ev['data'] = {k: _jsonable(v) for k, v in data.items()}
        with self._lock:
            ev['seq'] = self._seq
            self._seq += 1
            if len(self._ring) == self._ring.maxlen:
                self._evicted += 1
            self._ring.append(ev)
        return ev

    def events(self):
        with self._lock:
            return list(self._ring)

    def counts(self):
        """(recorded_total, evicted) — evicted events predate the ring."""
        with self._lock:
            return self._seq, self._evicted

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._seq = 0
            self._evicted = 0

    # -------------------------------------------------------- postmortem
    def postmortem(self, reason, exc=None, metrics=None, spans=None,
                   anomalies=None, host=None, extra=None):
        """The postmortem document (see module docstring for schema)."""
        total, evicted = self.counts()
        # host is 0 for one process, or a replica-name STRING
        # (PADDLE_TPU_OBSERVE_HOST): both must survive, or a replica's
        # dump dies in int()
        try:
            host_v = 0 if host is None else int(host)
        except (TypeError, ValueError):
            host_v = str(host)
        doc = {
            'kind': POSTMORTEM_KIND,
            'schema': SCHEMA_VERSION,
            'reason': str(reason),
            'ts': round(time.time(), 6),
            'pid': os.getpid(),
            'host': host_v,
            'uptime_seconds': round(time.time() - self.started_at, 6),
            'exception': _format_exception(exc),
            'events': self.events(),
            'events_total': total,
            'evicted_events': evicted,
            'metrics': metrics if metrics is not None else {},
            'spans': spans if spans is not None else [],
            'anomalies': anomalies if anomalies is not None else {},
        }
        if extra:
            doc.update({k: _jsonable(v) for k, v in extra.items()})
        return doc

    def dump(self, path, reason, exc=None, metrics=None, spans=None,
             anomalies=None, host=None, extra=None):
        """Write the postmortem JSON atomically (tmp + rename: a SIGKILL
        mid-dump leaves the previous dump intact, never a torn one).
        Returns the path written."""
        doc = self.postmortem(reason, exc=exc, metrics=metrics,
                              spans=spans, anomalies=anomalies,
                              host=host, extra=extra)
        d = os.path.dirname(os.path.abspath(path))
        if d and not os.path.isdir(d):
            os.makedirs(d, exist_ok=True)
        tmp = '%s.%d.tmp' % (path, os.getpid())
        with open(tmp, 'w') as f:
            json.dump(doc, f, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path
