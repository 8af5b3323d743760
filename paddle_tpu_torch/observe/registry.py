"""Dependency-free metrics registry: labeled counters, gauges and
histograms, a JSON snapshot and an end-of-run summary table (reference:
paddle_tpu observe/registry.py; the same names, label rendering and
snapshot keys, so a snapshot reads the same in both packages).

- One metric object per name; label sets materialize lazily per sorted
  label items, Prometheus-style. Rendered names look like
  ``executor.cache_miss_total{key=1a2b3c4d,kind=single}``.
- Histograms keep exact count/sum/min/max plus a bounded reservoir
  (RESERVOIR_CAP samples, Vitter's algorithm R with a fixed seed), so
  snapshot quantiles stay O(1) memory in unbounded runs.
- Everything is guarded by one registry lock: the engines' workers, the
  router's handoff threads and the callers all record into one registry.

The Prometheus text renderer and the fleet relabelling wait with the
diagnostics server and the fleet view (ROADMAP Queue 1 item 11).
"""

import json
import random
import threading

__all__ = ['Counter', 'Gauge', 'Histogram', 'Registry', 'RESERVOIR_CAP',
           'parse_rendered']

RESERVOIR_CAP = 4096


def _label_key(labels):
    return tuple(sorted(labels.items()))


def _render(name, label_key):
    if not label_key:
        return name
    return '%s{%s}' % (name, ','.join('%s=%s' % (k, v)
                                      for k, v in label_key))


def parse_rendered(rendered):
    """Inverse of the snapshot naming: ``name{k=v,k2=v2}`` ->
    ``(name, {k: v})`` (label values come back as strings)."""
    if '{' not in rendered:
        return rendered, {}
    name, _, rest = rendered.partition('{')
    labels = {}
    for part in rest.rstrip('}').split(','):
        if not part:
            continue
        k, _, v = part.partition('=')
        labels[k] = v
    return name, labels


class _Metric(object):
    kind = None

    def __init__(self, name, registry, help=''):
        self.name = name
        self.help = help
        self._registry = registry
        self._lock = registry._lock
        self._values = {}


class Counter(_Metric):
    """Monotonically increasing count (per label set)."""

    kind = 'counter'

    def inc(self, n=1, **labels):
        lk = _label_key(labels)
        with self._lock:
            self._values[lk] = self._values.get(lk, 0) + n

    def value(self, **labels):
        with self._lock:
            return self._values.get(_label_key(labels), 0)

    def _snapshot_into(self, out):
        for lk, v in self._values.items():
            out[_render(self.name, lk)] = v


class Gauge(_Metric):
    """Last-set value (per label set)."""

    kind = 'gauge'

    def set(self, value, **labels):
        lk = _label_key(labels)
        with self._lock:
            self._values[lk] = value

    def add(self, n, **labels):
        lk = _label_key(labels)
        with self._lock:
            self._values[lk] = self._values.get(lk, 0) + n

    def value(self, default=None, **labels):
        with self._lock:
            return self._values.get(_label_key(labels), default)

    def _snapshot_into(self, out):
        for lk, v in self._values.items():
            out[_render(self.name, lk)] = v


class _HistState(object):
    __slots__ = ('count', 'total', 'min', 'max', 'samples', 'rng',
                 'exemplar')

    def __init__(self, seed):
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self.samples = []
        self.rng = random.Random(seed)
        # worst-bucket exemplar: the trace id of the largest value ever
        # observed WITH an exemplar: a p99 spike names the request
        # trace that caused it
        self.exemplar = None

    def observe(self, v, exemplar=None):
        v = float(v)
        self.count += 1
        self.total += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        if exemplar is not None and (self.exemplar is None
                                     or v >= self.exemplar['value']):
            self.exemplar = {'value': v, 'trace_id': str(exemplar)}
        if len(self.samples) < RESERVOIR_CAP:
            self.samples.append(v)
        else:
            j = self.rng.randrange(self.count)
            if j < RESERVOIR_CAP:
                self.samples[j] = v

    def stats(self):
        out = {'count': self.count, 'sum': self.total,
               'min': self.min, 'max': self.max,
               'mean': self.total / self.count if self.count else None}
        s = sorted(self.samples)
        for q, key in ((0.5, 'p50'), (0.9, 'p90'), (0.95, 'p95'),
                       (0.99, 'p99')):
            out[key] = s[min(len(s) - 1, int(q * len(s)))] if s else None
        if self.exemplar is not None:
            out['exemplar'] = dict(self.exemplar)
        return out


class Histogram(_Metric):
    """Streaming distribution: exact count/sum/min/max + reservoir
    quantiles (per label set)."""

    kind = 'histogram'

    def observe(self, value, exemplar=None, **labels):
        lk = _label_key(labels)
        with self._lock:
            st = self._values.get(lk)
            if st is None:
                st = self._values[lk] = _HistState(hash((self.name, lk)))
            st.observe(value, exemplar=exemplar)

    def stats(self, **labels):
        with self._lock:
            st = self._values.get(_label_key(labels))
            return st.stats() if st is not None else None

    def count(self, **labels):
        with self._lock:
            st = self._values.get(_label_key(labels))
            return st.count if st is not None else 0

    def total(self, **labels):
        with self._lock:
            st = self._values.get(_label_key(labels))
            return st.total if st is not None else 0.0

    def aggregate(self):
        """(count, sum) across every label set — the profiler's
        summarize() substrate."""
        with self._lock:
            return (sum(st.count for st in self._values.values()),
                    sum(st.total for st in self._values.values()))

    def _snapshot_into(self, out):
        for lk, st in self._values.items():
            out[_render(self.name, lk)] = st.stats()


class Registry(object):
    """Home of every metric. Metric constructors are get-or-create so
    call sites never coordinate; asking for an existing name with a
    different type raises."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics = {}

    def _get(self, cls, name, help):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, self, help)
            elif not isinstance(m, cls):
                raise TypeError('metric %r already registered as %s, not %s'
                                % (name, m.kind, cls.kind))
            return m

    def counter(self, name, help=''):
        return self._get(Counter, name, help)

    def gauge(self, name, help=''):
        return self._get(Gauge, name, help)

    def histogram(self, name, help=''):
        return self._get(Histogram, name, help)

    def metrics(self, prefix=''):
        with self._lock:
            return [m for n, m in sorted(self._metrics.items())
                    if n.startswith(prefix)]

    def clear(self):
        with self._lock:
            self._metrics = {}

    # ------------------------------------------------------------ export
    def snapshot(self):
        """{'counters': {rendered_name: n}, 'gauges': {...},
        'histograms': {rendered_name: stats_dict}} — JSON-ready."""
        out = {'counters': {}, 'gauges': {}, 'histograms': {}}
        with self._lock:
            for m in self._metrics.values():
                m._snapshot_into(out[m.kind + 's'])
        return out

    def to_json_line(self, **extra):
        rec = dict(extra)
        rec.update(self.snapshot())
        return json.dumps(rec, sort_keys=True, default=str)

    def summary_table(self):
        """End-of-run human summary: counters and gauges one per line,
        histograms with count/mean/p50/p95/max."""
        snap = self.snapshot()
        lines = []
        if snap['counters']:
            lines.append('%-52s %14s' % ('Counter', 'Value'))
            for name, v in sorted(snap['counters'].items()):
                lines.append('%-52s %14s' % (name, v))
        if snap['gauges']:
            lines.append('%-52s %14s' % ('Gauge', 'Value'))
            for name, v in sorted(snap['gauges'].items()):
                sv = '%.6g' % v if isinstance(v, float) else str(v)
                lines.append('%-52s %14s' % (name, sv))
        if snap['histograms']:
            lines.append('%-52s %8s %12s %12s %12s %12s'
                         % ('Histogram', 'Count', 'Mean', 'P50', 'P95',
                            'Max'))
            for name, st in sorted(snap['histograms'].items()):
                lines.append(
                    '%-52s %8d %12.6g %12.6g %12.6g %12.6g'
                    % (name, st['count'], st['mean'] or 0.0,
                       st['p50'] or 0.0, st['p95'] or 0.0,
                       st['max'] or 0.0))
        return '\n'.join(lines)
