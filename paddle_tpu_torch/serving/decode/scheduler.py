"""Continuous-batching scheduler for autoregressive decode (reference:
paddle_tpu serving/decode/scheduler.py).

State machine per request (a ``Sequence``)::

    WAITING --admit/prefill--> RUNNING --eos/max_tokens--> FINISHED
       ^                         |
       +------preempt/requeue----+   (pool exhaustion)

The running set occupies at most ``max_batch`` slots of the fixed-shape
decode step; sequences join the running batch the moment a slot and
enough KV pages are free and leave it the moment they finish.

Admission is highest priority class first (serving.tenancy; FIFO within a
class). With a prefix cache, admission first maps the prompt's cached
pages into the block table, and rolls the match back when the pool cannot
supply the rest. Pool exhaustion preempts the lowest-class, youngest
running sequence (the one that loses the least progress), releases its
pages, and requeues it at the front of the waiting line with ``prompt +
generated-so-far`` as its new prefill prefix (recompute-style preemption:
already-streamed tokens are never re-streamed). The cache is the pool's
reclaimer, so every growth evicts reclaimable cached pages before anyone
is preempted. The scheduler is driven by the engine's single worker
thread; only the waiting queue is touched from submit() threads.

``cache_len`` counts KV entries materialized on the device. After
prefilling a prefix of length p the cache holds p entries and the sampled
next token is *pending* (its KV is written by the decode step that
consumes it).
"""

import collections
import queue as _queue
import threading
import time

from concurrent.futures import Future

from ... import observe as _obs
from ..tenancy import priority_rank
from .kv_pool import BlockTable

__all__ = ['Sequence', 'GenerationStream', 'Scheduler',
           'WAITING', 'RUNNING', 'FINISHED']

WAITING, RUNNING, FINISHED = 'waiting', 'running', 'finished'

_END = object()


class GenerationStream(object):
    """Per-request token stream + future.

    Iterate for tokens as they are generated (``for tok in stream:``),
    or block for the whole thing with ``result(timeout)`` (the list of
    generated token ids, prompt excluded). ``finish_reason`` is
    'eos' | 'max_tokens' | 'error' once done."""

    def __init__(self, request_id, prompt_len):
        self.request_id = request_id
        self.prompt_len = prompt_len
        self.finish_reason = None
        self._q = _queue.Queue()
        self._future = Future()
        self._future.set_running_or_notify_cancel()

    # engine-side
    def _put(self, token):
        self._q.put(int(token))

    def _finish(self, reason, tokens):
        self.finish_reason = reason
        self._q.put(_END)
        self._future.set_result(list(tokens))

    def _fail(self, exc):
        self.finish_reason = 'error'
        self._q.put(_END)
        if not self._future.done():
            self._future.set_exception(exc)

    # client-side
    def __iter__(self):
        while True:
            item = self._q.get()
            if item is _END:
                return
            yield item

    def result(self, timeout=None):
        return self._future.result(timeout)

    def done(self):
        return self._future.done()


class Sequence(object):
    """One in-flight generation request."""

    __slots__ = ('request_id', 'prompt', 'max_new_tokens', 'temperature',
                 'seed', 'eos_id', 'table', 'generated', 'streamed',
                 'state', 'stream', 'cache_len', 'pending_token',
                 't_submit', 't_admit', 't_first_token', 't_last_token',
                 'preemptions', 'cached_len', 'published_pages', 'ctx',
                 'tenant', 'priority', 'prio_rank')

    def __init__(self, request_id, prompt, max_new_tokens, temperature,
                 seed, eos_id, ctx=None, tenant=None, priority=None):
        self.request_id = request_id
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.eos_id = eos_id
        self.table = BlockTable()
        self.generated = []
        self.streamed = 0
        self.state = WAITING
        self.stream = GenerationStream(request_id, len(self.prompt))
        self.cache_len = 0
        self.pending_token = None
        self.t_submit = time.perf_counter()
        self.t_admit = None
        self.t_first_token = None
        self.t_last_token = None
        self.preemptions = 0
        self.cached_len = 0        # prefix-cache hit span (this prefill)
        self.published_pages = 0   # full pages already offered to the cache
        self.ctx = ctx      # reqtrace.RequestContext (trace correlation)
        # scheduling class (serving.tenancy): None lands on 'standard'
        self.tenant = tenant
        self.priority = priority
        self.prio_rank = priority_rank(priority)

    def prefix(self):
        """Tokens whose KV must exist before the next decode step —
        after a preemption this is what re-prefills."""
        return self.prompt + self.generated

    def finished(self):
        if len(self.generated) >= self.max_new_tokens:
            return 'max_tokens'
        if self.eos_id is not None and self.generated and \
                self.generated[-1] == self.eos_id:
            return 'eos'
        return None


class Scheduler(object):
    """Owns the waiting queue, the running set, and the page budget.
    All mutation happens on the engine worker thread except ``add``
    (submit path). ``cache`` is the prefix cache (prefix_cache.py), or
    None."""

    def __init__(self, pool, max_batch, cache=None):
        self.pool = pool
        self.max_batch = int(max_batch)
        self.cache = cache
        self.waiting = collections.deque()
        self.running = []          # admission order (oldest first)
        self.preemptions = 0
        self.peak_running = 0      # most sequences ever running at once
        self._mu = threading.Lock()

    def add(self, seq):
        with self._mu:
            self.waiting.append(seq)
        self._publish()

    def counts(self):
        with self._mu:
            return len(self.waiting), len(self.running)

    def free_slots(self):
        """Batch slots not occupied: with the pool's free pages, what the
        phase router ranks decode replicas by."""
        with self._mu:
            return max(0, self.max_batch - len(self.running))

    def _publish(self):
        if _obs.enabled():
            w, r = self.counts()
            _obs.set_gauge('decode.waiting_seqs', w)
            _obs.set_gauge('decode.running_seqs', r)

    def pop_admittable(self):
        """Admit the next waiting sequence, highest class first, if a
        batch slot is free and the pool covers its prefill prefix plus one
        decode write. A prefix-cache hit maps the shared pages first, so
        only the uncached suffix needs fresh pages. Returns the Sequence
        (pages allocated, state RUNNING) or None."""
        with self._mu:
            if len(self.running) >= self.max_batch or not self.waiting:
                return None
            idx, best = 0, self.waiting[0].prio_rank
            if best > 0:
                for i, s in enumerate(self.waiting):
                    if s.prio_rank < best:
                        idx, best = i, s.prio_rank
                        if best == 0:
                            break
            seq = self.waiting[idx]
            prefix = seq.prefix()
            if self.cache is not None and not seq.table.block_ids:
                seq.cached_len = self.cache.match(prefix, seq.table)
                seq.published_pages = seq.cached_len // self.pool.block_size
            if not self.pool.grow(seq.table, len(prefix) + 1):
                if seq.cached_len:
                    # roll the match back: pinned cache pages would block
                    # the very evictions admission waits on
                    self.cache.unmatch(seq.table, seq.cached_len)
                    seq.cached_len = 0
                    seq.published_pages = 0
                _obs.inc('decode.admission_blocked_total')
                return None
            del self.waiting[idx]
            seq.t_admit = time.perf_counter()
            seq.state = RUNNING
            self.running.append(seq)
            if len(self.running) > self.peak_running:
                self.peak_running = len(self.running)
                if _obs.enabled():
                    _obs.set_gauge('decode.running_seqs_peak',
                                   self.peak_running)
        self._publish()
        return seq

    def ensure_growth(self, seq, need_tokens=None):
        """Make sure ``seq`` owns the pages its next writes land in
        (``need_tokens`` positions: one decode write by default, cache_len
        + k + 1 for a speculative step), preempting victims on exhaustion
        once the cache's evictor has nothing left to give. False when
        ``seq`` itself was preempted (caller must drop it from this
        step)."""
        if need_tokens is None:
            need_tokens = seq.cache_len + 1
        while not self.pool.grow(seq.table, need_tokens):
            _obs.inc('decode.pool_exhausted_total')
            _obs.flight_event('decode_pool_exhausted',
                              request_id=seq.request_id,
                              free_blocks=self.pool.free_blocks(),
                              running=len(self.running),
                              waiting=len(self.waiting))
            victim = self._pick_victim()
            self.preempt(victim)
            if victim is seq:
                return False
        return True

    def _pick_victim(self):
        """The lowest priority class, youngest within it."""
        worst = max(seq.prio_rank for seq in self.running)
        for seq in reversed(self.running):
            if seq.prio_rank == worst:
                return seq
        return self.running[-1]

    def preempt(self, seq):
        """Release pages, requeue at the FRONT with prompt+generated as
        the new prefill prefix. Already-streamed tokens stay streamed.
        Shared cached pages lose this sequence's reference; the re-prefill
        matches whatever is still cached."""
        with self._mu:
            self.running.remove(seq)
            self.waiting.appendleft(seq)
        self.pool.release(seq.table)
        seq.state = WAITING
        seq.cache_len = 0
        seq.pending_token = None
        seq.cached_len = 0
        seq.published_pages = 0
        seq.preemptions += 1
        self.preemptions += 1
        _obs.inc('decode.preemptions_total')
        _obs.inc('tenant.preempted', tenant=seq.tenant or 'default',
                 priority=seq.priority or 'standard')
        _obs.flight_event('decode_preempt', request_id=seq.request_id,
                          generated=len(seq.generated),
                          freed_blocks=self.pool.free_blocks())
        if seq.ctx is not None:
            seq.ctx.event('preempt', generated=len(seq.generated))
        self._publish()

    def finish(self, seq, reason):
        with self._mu:
            self.running.remove(seq)
        self.pool.release(seq.table)
        seq.state = FINISHED
        _obs.inc('decode.finished_total', reason=reason)
        seq.stream._finish(reason, seq.generated)
        self._publish()

    def fail_all(self, exc):
        """Worker-death path: every in-flight and queued request gets the
        exception instead of hanging its client forever. Returns the
        number of requests failed."""
        with self._mu:
            seqs = list(self.running) + list(self.waiting)
            self.running = []
            self.waiting.clear()
        for seq in seqs:
            if seq.table.block_ids:
                self.pool.release(seq.table)
            seq.state = FINISHED
            seq.stream._fail(exc)
        self._publish()
        return len(seqs)
