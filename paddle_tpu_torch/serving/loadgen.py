"""Load-generator driver for the serving benches (reference: paddle_tpu
serving/loadgen.py; the same draws for the same seeds, so a run of the
port and of the JAX package offer the same traffic).

Two loop disciplines drive any request shape:

- **closed loop**: ``clients`` threads each keep exactly one request in
  flight (latency under a fixed concurrency).
- **open loop**: one pacer submits at ``qps`` with Poisson arrivals
  regardless of completions (latency under offered load; overload shows
  as rejects through the engines' QueueFullError backpressure). ``qps``
  may be a constant, a callable ``f(elapsed_s) -> qps``, or a list of
  ``(t_s, qps)`` breakpoints (step-hold).

The caller adapts its engine through two callables:

    do_request(rng) -> rows          # closed loop: submit AND wait
    submit_request(rng) -> (future, rows) | None   # open loop

Both raise / return None on QueueFullError (counted as a reject) and
raise anything else as an error. ``Stats`` is the thread-safe ledger: it
timestamps every completion, reject and error relative to its creation;
``percentiles`` renders it. ``diurnal`` / ``flash_crowd`` /
``heavy_tailed_rows`` / ``phase_mix`` are scenario shapes; ``tenant_mix``
labels those draws with weighted tenants and tenant-prefixed session ids.
"""

import math
import threading
import time

import numpy as np

__all__ = ['Stats', 'percentiles', 'closed_loop', 'open_loop',
           'qps_at', 'diurnal', 'flash_crowd', 'heavy_tailed_rows',
           'phase_mix', 'tenant_mix']


class Stats(object):
    """Thread-safe request ledger. All `*_times` are seconds since
    construction (or the explicit ``t0`` perf_counter anchor), so a
    scenario's phases can be located in the ledger afterwards."""

    def __init__(self, t0=None):
        self.mu = threading.Lock()
        self.t0 = time.perf_counter() if t0 is None else t0
        self.latencies = []
        self.rows = 0
        self.ok = 0
        self.rejected = 0
        self.errors = 0
        self.ok_times = []
        self.reject_times = []
        self.error_times = []

    def _now(self):
        return time.perf_counter() - self.t0

    def done(self, seconds, rows):
        with self.mu:
            self.latencies.append(seconds)
            self.ok += 1
            self.rows += rows
            self.ok_times.append(self._now())

    def reject(self):
        with self.mu:
            self.rejected += 1
            self.reject_times.append(self._now())

    def error(self):
        with self.mu:
            self.errors += 1
            self.error_times.append(self._now())

    def counts_between(self, t_lo, t_hi):
        """{'ok', 'rejected', 'errors'} with timestamps in
        [t_lo, t_hi) — how a phase of a scenario went."""
        with self.mu:
            return {
                'ok': sum(1 for t in self.ok_times if t_lo <= t < t_hi),
                'rejected': sum(1 for t in self.reject_times
                                if t_lo <= t < t_hi),
                'errors': sum(1 for t in self.error_times
                              if t_lo <= t < t_hi),
            }


def percentiles(latencies):
    """{'p50','p95','p99','mean','max'} in milliseconds (None-filled
    when empty)."""
    if not latencies:
        return {'p50': None, 'p95': None, 'p99': None, 'mean': None,
                'max': None}
    arr = np.sort(np.asarray(latencies, dtype=np.float64)) * 1000.0
    pick = lambda q: float(arr[min(len(arr) - 1, int(q * len(arr)))])  # noqa
    return {'p50': pick(0.50), 'p95': pick(0.95), 'p99': pick(0.99),
            'mean': float(arr.mean()), 'max': float(arr[-1])}


# ------------------------------------------------------- QPS schedules
def qps_at(qps, elapsed):
    """Resolve a QPS spec at ``elapsed`` seconds: a number holds, a
    callable is ``f(elapsed)``, a list of (t, qps) breakpoints
    step-holds the last breakpoint whose t <= elapsed (0 before the
    first)."""
    if callable(qps):
        return max(0.0, float(qps(elapsed)))
    if isinstance(qps, (list, tuple)):
        current = 0.0
        for t, q in qps:
            if elapsed >= t:
                current = q
            else:
                break
        return max(0.0, float(current))
    return max(0.0, float(qps))


def diurnal(base_qps, peak_qps, period_s):
    """Sinusoidal day/night load curve: base at t=0, peak at
    period_s/2 — the fleet scenario's background traffic."""
    def f(elapsed):
        phase = (1.0 - math.cos(2.0 * math.pi * elapsed / period_s)) / 2
        return base_qps + (peak_qps - base_qps) * phase
    return f


def flash_crowd(schedule, spike_qps, t_start, duration_s):
    """Overlay a flash-crowd burst on any QPS spec: offered load jumps
    to ``spike_qps`` (if higher) during [t_start, t_start+duration)."""
    def f(elapsed):
        q = qps_at(schedule, elapsed)
        if t_start <= elapsed < t_start + duration_s:
            return max(q, float(spike_qps))
        return q
    return f


def heavy_tailed_rows(rng, lo, hi, alpha=1.3):
    """Pareto-ish request size in [lo, hi]: most requests are small,
    a heavy tail is large — the mixed-length traffic that makes tail
    latency hard (PAPERS: Ragged Paged Attention)."""
    draw = float(rng.pareto(alpha))
    frac = min(1.0, draw / 10.0)
    return int(lo + round((hi - lo) * frac))


def phase_mix(rng, long_prompt_frac=0.3, short_prompt=(4, 16),
              long_prompt=(48, 96), short_new=(4, 8),
              long_new=(24, 48)):
    """One ``(prompt_len, max_new_tokens)`` draw of the mixed
    long-prompt/long-decode chaos mix the disaggregated-fleet bench
    drives: a ``long_prompt_frac`` minority of requests are prefill-
    heavy (long prompt, few new tokens), the rest are decode-heavy
    (short prompt, many new tokens). On a colocated replica every
    long prefill dispatch stalls all resident decode steps behind it
    — exactly the inter-token tail the phase split removes."""
    if rng.rand() < long_prompt_frac:
        return (int(rng.randint(long_prompt[0], long_prompt[1] + 1)),
                int(rng.randint(short_new[0], short_new[1] + 1)))
    return (int(rng.randint(short_prompt[0], short_prompt[1] + 1)),
            int(rng.randint(long_new[0], long_new[1] + 1)))


def tenant_mix(rng, tenants, sessions_per_tenant=4, rows=(4, 64),
               phases=False):
    """One draw of a multi-tenant traffic mix: pick a tenant by
    weight, mint a tenant-prefixed session id (``"acme/s3"`` — the
    tenancy module's ``tenant_of_session`` convention, so the router
    charges the right quota bucket AND the rendezvous pin stays
    per-session), and draw the request shape.

    ``tenants`` is ``[(name, weight), ...]``. With ``phases=False``
    returns ``(tenant, session, rows)`` where ``rows`` is a
    ``heavy_tailed_rows`` draw over the ``rows=(lo, hi)`` range (the
    micro-batch benches' request size); with ``phases=True`` returns
    ``(tenant, session, prompt_len, max_new_tokens)`` from a
    ``phase_mix`` draw (the decode benches' shape)."""
    names = [t[0] for t in tenants]
    weights = np.asarray([float(t[1]) for t in tenants])
    weights = weights / weights.sum()
    name = names[int(rng.choice(len(names), p=weights))]
    session = '%s/s%d' % (name, int(rng.randint(sessions_per_tenant)))
    if phases:
        prompt_len, max_new = phase_mix(rng)
        return name, session, prompt_len, max_new
    return name, session, heavy_tailed_rows(rng, rows[0], rows[1])


# ---------------------------------------------------------- the loops
def closed_loop(do_request, stats, deadline, clients, requests=None):
    """``clients`` threads each loop: one request in flight at a time.
    ``do_request(rng)`` submits, waits, and returns the request's row
    count; QueueFullError counts as a reject, anything else an error.
    ``requests`` (an extension of the reference's loop) bounds the run
    to that many ``do_request`` calls in all: the clients stop when the
    last one has been started or at ``deadline``, whichever comes first
    (a fixed workload instead of a fixed duration)."""
    from . import QueueFullError
    left = [requests]
    mu = threading.Lock()

    def take():
        with mu:
            if left[0] is None:
                return True
            if left[0] <= 0:
                return False
            left[0] -= 1
            return True

    def client(seed):
        rng = np.random.RandomState(seed)
        while time.perf_counter() < deadline and take():
            t0 = time.perf_counter()
            try:
                rows = do_request(rng)
            except QueueFullError:
                stats.reject()
                continue
            except Exception:
                stats.error()
                continue
            stats.done(time.perf_counter() - t0, rows)

    threads = [threading.Thread(target=client, args=(1000 + i,),
                                daemon=True) for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def open_loop(submit_request, stats, deadline, qps, seed=7):
    """One pacer submits at ``qps`` (Poisson arrivals; constant,
    callable, or (t, qps) breakpoints — see qps_at) regardless of
    completions. ``submit_request(rng)`` returns (future, rows) or
    None on a reject; latency is clocked at future resolution (the
    dispatcher thread), not at a late collection point. The caller's
    engine.shutdown(drain=True) is the completion barrier."""
    from . import QueueFullError
    rng = np.random.RandomState(seed)
    loop_t0 = time.perf_counter()
    next_t = loop_t0
    while time.perf_counter() < deadline:
        now = time.perf_counter()
        if now < next_t:
            time.sleep(min(next_t - now, 0.005))
            continue
        rate = qps_at(qps, now - loop_t0)
        if rate <= 0.0:
            # schedule says silence: re-check for load 50ms from now
            next_t = now + 0.05
            continue
        next_t += (1.0 / rate) * float(rng.exponential(1.0))
        t0 = time.perf_counter()
        try:
            handed = submit_request(rng)
        except QueueFullError:
            handed = None
        if handed is None:
            stats.reject()
            continue
        fut, rows = handed

        def _cb(f, t0=t0, rows=rows):
            try:
                f.result()
                stats.done(time.perf_counter() - t0, rows)
            except Exception:
                stats.error()
        fut.add_done_callback(_cb)
