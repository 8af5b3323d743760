"""Continuous-batching scheduler for autoregressive decode (reference:
paddle_tpu serving/decode/scheduler.py; every request here is of the
'standard' class: FIFO admission, youngest-first preemption).

State machine per request (a ``Sequence``)::

    WAITING --admit/prefill--> RUNNING --eos/max_tokens--> FINISHED
       ^                         |
       +------preempt/requeue----+   (pool exhaustion)

The running set occupies at most ``max_batch`` slots of the fixed-shape
decode step; sequences join the running batch the moment a slot and
enough KV pages are free and leave it the moment they finish.

Pool exhaustion preempts the youngest running sequence (the one that
loses the least progress), releases its pages, and requeues it at the
front of the waiting line with ``prompt + generated-so-far`` as its new
prefill prefix (recompute-style preemption: already-streamed tokens are
never re-streamed). The scheduler is driven by the engine's single
worker thread; only the waiting queue is touched from submit() threads.

``cache_len`` counts KV entries materialized on the device. After
prefilling a prefix of length p the cache holds p entries and the sampled
next token is *pending* (its KV is written by the decode step that
consumes it).
"""

import collections
import queue as _queue
import threading

from concurrent.futures import Future

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
                 'seed', 'eos_id', 'table', 'generated', 'state', 'stream',
                 'cache_len', 'pending_token')

    def __init__(self, request_id, prompt, max_new_tokens, temperature,
                 seed, eos_id):
        self.request_id = request_id
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.eos_id = eos_id
        self.table = BlockTable()
        self.generated = []
        self.state = WAITING
        self.stream = GenerationStream(request_id, len(self.prompt))
        self.cache_len = 0
        self.pending_token = None

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
    (submit path)."""

    def __init__(self, pool, max_batch):
        self.pool = pool
        self.max_batch = int(max_batch)
        self.waiting = collections.deque()
        self.running = []          # admission order (oldest first)
        self.preemptions = 0
        self._mu = threading.Lock()

    def add(self, seq):
        with self._mu:
            self.waiting.append(seq)

    def counts(self):
        with self._mu:
            return len(self.waiting), len(self.running)

    def pop_admittable(self):
        """Admit the next waiting sequence if a batch slot is free and the
        pool covers its prefill prefix plus one decode write. Returns the
        Sequence (pages allocated, state RUNNING) or None."""
        with self._mu:
            if len(self.running) >= self.max_batch or not self.waiting:
                return None
            seq = self.waiting[0]
            if not self.pool.grow(seq.table, len(seq.prefix()) + 1):
                return None
            self.waiting.popleft()
            seq.state = RUNNING
            self.running.append(seq)
        return seq

    def ensure_growth(self, seq, need_tokens=None):
        """Make sure ``seq`` owns the pages its next decode write lands in
        (``need_tokens`` positions, default one write), preempting the
        youngest running sequence on exhaustion. False when ``seq``
        itself was preempted (caller must drop it from this step)."""
        if need_tokens is None:
            need_tokens = seq.cache_len + 1
        while not self.pool.grow(seq.table, need_tokens):
            victim = self.running[-1]
            self.preempt(victim)
            if victim is seq:
                return False
        return True

    def preempt(self, seq):
        """Release pages, requeue at the FRONT with prompt+generated as
        the new prefill prefix. Already-streamed tokens stay streamed."""
        with self._mu:
            self.running.remove(seq)
            self.waiting.appendleft(seq)
        self.pool.release(seq.table)
        seq.state = WAITING
        seq.cache_len = 0
        seq.pending_token = None
        self.preemptions += 1

    def finish(self, seq, reason):
        with self._mu:
            self.running.remove(seq)
        self.pool.release(seq.table)
        seq.state = FINISHED
        seq.stream._finish(reason, seq.generated)

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
        return len(seqs)
