"""Host-side span tracing exported as Chrome-trace/Perfetto JSON
(reference: paddle_tpu observe/spans.py; the same event keys).

Spans are nested host wall-time intervals (a handoff's export and
install, a router phase). Each completed span becomes one Chrome-trace
"complete" event (``ph: "X"`` with ``ts``/``dur`` in microseconds), so
the file written by export() loads directly in Perfetto or
chrome://tracing, with nesting recovered from containment on the
(pid, tid) track.

Bridge to device traces: entering a span also enters
``torch.profiler.record_function(name)``, so the SAME span names show in
a torch profile of the card (``chip_smoke.py --profile`` takes one):
host intervals and device kernels line up by name in one view. The range
costs nothing unless a profiler is recording.

Cross-thread parenting: the thread-local ``begin``/``end`` stack can
only nest spans on ONE thread. A request that crosses threads (router
submit, handoff worker, decode worker) links its spans with Chrome-trace
*flow events* instead: the producer calls ``flow_begin(name)`` and hands
the returned ``FlowHandle`` to the consumer, who calls
``flow_step``/``flow_end`` on *its* thread. ``add_span`` records a
completed interval with explicit perf_counter timestamps (no stack), and
``add_instant`` records zero-duration marks (per-token events).
"""

import json
import os
import sys
import threading
import time

__all__ = ['SpanRecorder', 'FlowHandle', 'MAX_EVENTS']

# bound memory in unbounded runs: keep the first MAX_EVENTS spans and
# count the rest (dropped count is recorded in the export metadata)
MAX_EVENTS = 200000


class _Span(object):
    __slots__ = ('name', 'attrs', 't0', 'ann')

    def __init__(self, name, attrs):
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0
        self.ann = None


class FlowHandle(object):
    """Ticket for one producer→consumer handoff arrow. Created by
    ``SpanRecorder.flow_begin`` on the producer thread; any number of
    ``flow_step`` calls and one ``flow_end`` may follow from OTHER
    threads — the events share ``flow_id`` so Perfetto links the
    enclosing slices across tracks."""

    __slots__ = ('flow_id', 'name')

    def __init__(self, flow_id, name):
        self.flow_id = flow_id
        self.name = name


class SpanRecorder(object):
    def __init__(self):
        self._lock = threading.Lock()
        self._events = []
        self._dropped = 0
        # observe.__init__ points this at the registry's
        # spans_dropped_total counter, so a truncated trace is visible
        # from a snapshot alone (not just the trace-file metadata)
        self.on_drop = None
        self._tls = threading.local()
        # one zero point for the whole recorder: perf_counter deltas
        # anchored to an epoch timestamp so ts is meaningful across
        # threads
        self._epoch0 = time.time() - time.perf_counter()
        self._flow_ids = 0

    # ---------------------------------------------------------- record
    def begin(self, name, attrs=None, bridge_profiler=True):
        sp = _Span(name, attrs)
        if bridge_profiler:
            torch = sys.modules.get('torch')
            if torch is not None:
                try:
                    sp.ann = torch.profiler.record_function(name)
                    sp.ann.__enter__()
                except Exception:
                    sp.ann = None
        stack = getattr(self._tls, 'stack', None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append(sp)
        sp.t0 = time.perf_counter()
        return sp

    def end(self, sp=None):
        t1 = time.perf_counter()
        stack = getattr(self._tls, 'stack', None)
        if not stack:
            return
        top = stack.pop()
        if sp is not None and top is not sp:
            # mismatched end (generator-based caller): unwind to sp
            while stack and top is not sp:
                top = stack.pop()
        if top.ann is not None:
            try:
                top.ann.__exit__(None, None, None)
            except Exception:
                pass
        ev = {'name': top.name, 'ph': 'X', 'pid': os.getpid(),
              'tid': threading.get_ident(),
              'ts': (self._epoch0 + top.t0) * 1e6,
              'dur': (t1 - top.t0) * 1e6}
        if top.attrs:
            ev['args'] = top.attrs
        self._append(ev)

    def _append(self, ev):
        with self._lock:
            if len(self._events) < MAX_EVENTS:
                self._events.append(ev)
                cb = None
            else:
                self._dropped += 1
                cb = self.on_drop
        if cb is not None:
            try:
                cb(1)
            except Exception:
                pass

    def depth(self):
        return len(getattr(self._tls, 'stack', ()) or ())

    # ------------------------------------------- explicit-interval spans
    def add_span(self, name, t0, t1, attrs=None, tid=None):
        """Record a completed span with explicit ``time.perf_counter()``
        bounds — no thread-local stack, no profiler range. The span lands on
        the calling thread's track (or ``tid``), so a stage whose start
        was clocked on another thread (e.g. a request's queue wait,
        started at submit() but observed ending in the batcher) still
        renders with exact bounds."""
        ev = {'name': name, 'ph': 'X', 'pid': os.getpid(),
              'tid': threading.get_ident() if tid is None else tid,
              'ts': (self._epoch0 + t0) * 1e6,
              'dur': max(0.0, t1 - t0) * 1e6}
        if attrs:
            ev['args'] = dict(attrs)
        self._append(ev)

    def add_instant(self, name, attrs=None):
        """Record a zero-duration mark on the calling thread (scope
        't'): per-token decode events, admission decisions, kills."""
        ev = {'name': name, 'ph': 'i', 's': 't', 'pid': os.getpid(),
              'tid': threading.get_ident(),
              'ts': (self._epoch0 + time.perf_counter()) * 1e6}
        if attrs:
            ev['args'] = dict(attrs)
        self._append(ev)

    # ------------------------------------------------ cross-thread flows
    def flow_begin(self, name, attrs=None, flow_id=None):
        """Start a flow arrow on the calling thread; returns the
        FlowHandle the consumer thread passes to flow_step/flow_end.
        ``flow_id`` defaults to a recorder-unique integer (pass a
        trace id to make the arrow greppable in the raw JSON)."""
        with self._lock:
            if flow_id is None:
                self._flow_ids += 1
                flow_id = self._flow_ids
        h = FlowHandle(flow_id, name)
        self._flow_event('s', h, attrs)
        return h

    def flow_step(self, handle, attrs=None):
        """Mark the flow passing through the calling thread."""
        self._flow_event('t', handle, attrs)

    def flow_end(self, handle, attrs=None):
        """Terminate the flow on the calling thread."""
        self._flow_event('f', handle, attrs, bind_enclosing=True)

    def _flow_event(self, ph, handle, attrs, bind_enclosing=False):
        ev = {'name': handle.name, 'cat': 'flow', 'ph': ph,
              'id': handle.flow_id, 'pid': os.getpid(),
              'tid': threading.get_ident(),
              'ts': (self._epoch0 + time.perf_counter()) * 1e6}
        if bind_enclosing:
            ev['bp'] = 'e'   # bind the arrowhead to the enclosing slice
        if attrs:
            ev['args'] = dict(attrs)
        self._append(ev)

    # ---------------------------------------------------------- export
    def events(self):
        with self._lock:
            return list(self._events)

    def clear(self):
        with self._lock:
            self._events = []
            self._dropped = 0
    
    def chrome_trace(self):
        """Chrome trace JSON object (dict) of all completed spans."""
        with self._lock:
            doc = {'traceEvents': list(self._events),
                   'displayTimeUnit': 'ms'}
            if self._dropped:
                doc['paddle_tpu_dropped_spans'] = self._dropped
            return doc

    def export(self, path):
        doc = self.chrome_trace()
        tmp = path + '.tmp'
        with open(tmp, 'w') as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path
