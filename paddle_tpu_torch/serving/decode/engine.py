"""DecodeEngine: continuous-batching autoregressive decode serving
(reference: paddle_tpu serving/decode/engine.py).

- **submit()** (any thread) validates a prompt against the page budget
  and returns a `GenerationStream` immediately: iterate it for tokens as
  they are generated, or `.result()` for the full sequence.
- **one worker thread** runs the prefill/decode loop: admit waiting
  requests into free batch slots (one `paged_prefill` run per admission,
  bucketed prompt lengths), then one `paged_decode_step` for the whole
  running batch. Sequences enter and leave the running batch
  continuously; the batch never waits for its slowest member.
- **fixed decode shape**: the decode step always runs at [max_batch] with
  per-slot block tables, so the same kernels run whatever the batch
  holds, and a row's result does not depend on the other rows.
- **pool exhaustion** preempts the youngest running sequence
  (recompute-style requeue, scheduler.py) rather than failing it.

The engine runs on ``CUDAPlace(0)`` unless ``place`` says otherwise; with
no CUDA device and no place it raises. The prefix cache, speculative
decoding and quantized (int8/fp8) arenas belong to a later port slice:
asking for them raises NotImplementedError.
"""

import itertools
import threading
import time

import numpy as np

from ...core.executor import Executor
from ...core.scope import Scope, scope_guard
from ...quant.core import resolve_kv_dtype
from ...weights import from_numpy
from ..buckets import pow2_ladder
from ..engine import EngineClosedError, QueueFullError
from .kv_pool import KVPool
from .model import LMSpec, build_lm_programs, kv_bytes_per_token
from .scheduler import RUNNING, Scheduler, Sequence

__all__ = ['DecodeEngine', 'LMSpec']

_LATER = 'belongs to a later port slice (the decode extras)'


class DecodeEngine(object):
    """Continuous-batching decode server over a paged KV cache.

    ::

        spec = LMSpec(vocab_size=1000, n_layer=2, ...)
        eng = DecodeEngine(spec, max_batch=8, block_size=16,
                           num_blocks=128, pages_per_seq=8)
        eng.warmup()
        eng.start()
        stream = eng.submit([1, 5, 7], max_new_tokens=32)
        for tok in stream: ...          # tokens as they generate
        eng.shutdown()

    ``pages_per_seq * block_size`` caps prompt_len + max_new_tokens of a
    single request; ``num_blocks`` is the shared device page budget that
    continuous batching packs.
    """

    def __init__(self, spec, max_batch=8, block_size=16, num_blocks=64,
                 pages_per_seq=8, max_queue_depth=64, max_prompt_len=None,
                 place=None, weights=None, prefix_cache=None, spec_k=None,
                 kv_dtype=None):
        if prefix_cache:
            raise NotImplementedError('prefix_cache=True ' + _LATER)
        if spec_k:
            raise NotImplementedError('spec_k > 0 (speculative decoding) '
                                      + _LATER)
        self.spec = spec
        self.max_batch = int(max_batch)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.pages_per_seq = int(pages_per_seq)
        self.max_queue_depth = int(max_queue_depth)
        self.kv_dtype = resolve_kv_dtype(kv_dtype)
        self._exe = Executor(place)
        self.place = self._exe.place
        self._progs = build_lm_programs(spec, self.max_batch,
                                        self.block_size, self.num_blocks,
                                        self.pages_per_seq,
                                        kv_dtype=self.kv_dtype)
        self.kv_bytes_per_token = kv_bytes_per_token(spec, self.kv_dtype)
        self.capacity = self._progs.capacity
        self.max_prompt_len = int(max_prompt_len) if max_prompt_len \
            else self.capacity - 1
        self.prompt_buckets = pow2_ladder(self.max_prompt_len)

        self._scope = Scope()
        with scope_guard(self._scope):
            self._exe.run(program=self._progs.startup)
        if weights:
            self.load_weights(weights)

        self.pool = KVPool(self.num_blocks, self.block_size)
        self._sched = Scheduler(self.pool, self.max_batch)
        self._mu = threading.Condition(threading.Lock())
        self._done_cv = threading.Condition(threading.Lock())
        self._unfinished = 0
        self._ids = itertools.count(1)
        self._closed = False
        self._draining = False
        self._started = False
        self._warmed = False
        self._broken = None
        self._thread = None
        self.warmup_signatures = 0
        # runs of each program, read by callers that relate kernel launch
        # counts to engine steps (chip_smoke.py)
        self.prefills = 0
        self.decode_steps = 0

    # ----------------------------------------------------------- weights
    def load_weights(self, weights):
        """Install a {param name: array} dict (names per
        model.DecodePrograms.param_names), e.g. the JAX package's
        ``export_weights()`` or ``random_weights``."""
        unknown = sorted(set(weights) - set(self._progs.param_names))
        if unknown:
            raise ValueError('unknown param names %s (expected a subset '
                             'of %s)' % (unknown, self._progs.param_names))
        for name, t in from_numpy(weights, self.place).items():
            self._scope.set(name, t)

    def export_weights(self):
        return {n: self._scope.numpy(n) for n in self._progs.param_names}

    # ------------------------------------------------------------ intake
    def submit(self, prompt_ids, max_new_tokens=16, temperature=0.0,
               seed=0, eos_id=None):
        """Enqueue one generation request; returns a GenerationStream.
        Raises QueueFullError past max_queue_depth, EngineClosedError
        after shutdown, ValueError for prompts the page budget can never
        hold or token ids outside the vocabulary."""
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        max_new = int(max_new_tokens)
        if not prompt:
            raise ValueError('submit: empty prompt')
        if max_new < 1:
            raise ValueError('submit: max_new_tokens must be >= 1')
        if min(prompt) < 0 or max(prompt) >= self.spec.vocab_size:
            raise ValueError('submit: token ids must lie in [0, %d)'
                             % self.spec.vocab_size)
        if len(prompt) > self.max_prompt_len:
            raise ValueError('prompt of %d tokens exceeds max_prompt_len'
                             '=%d' % (len(prompt), self.max_prompt_len))
        total = len(prompt) + max_new
        if total > self.capacity:
            raise ValueError(
                'prompt+max_new_tokens=%d exceeds per-sequence capacity '
                '%d (pages_per_seq=%d x block_size=%d)'
                % (total, self.capacity, self.pages_per_seq,
                   self.block_size))
        if self.pool.blocks_for(total) > self.num_blocks:
            raise ValueError(
                'request needs %d KV pages but the pool only has %d'
                % (self.pool.blocks_for(total), self.num_blocks))
        with self._mu:
            if self._closed:
                raise EngineClosedError('DecodeEngine is shut down')
            if self._broken is not None:
                raise EngineClosedError(
                    'DecodeEngine worker died: %r' % self._broken)
            waiting, _ = self._sched.counts()
            if waiting >= self.max_queue_depth:
                raise QueueFullError(
                    'decode queue full (%d waiting >= max_queue_depth='
                    '%d)' % (waiting, self.max_queue_depth))
            seq = Sequence(next(self._ids), prompt, max_new, temperature,
                           seed, eos_id)
            with self._done_cv:
                self._unfinished += 1
            self._sched.add(seq)
            self._mu.notify_all()
        return seq.stream

    def generate(self, prompt_ids, timeout=None, **kwargs):
        """submit() + wait: returns the generated token list."""
        return self.submit(prompt_ids, **kwargs).result(timeout)

    @property
    def preemptions(self):
        """Sequences preempted (and requeued) so far."""
        return self._sched.preemptions

    def free_pages(self):
        return self.pool.free_blocks()

    # ---------------------------------------------------------- lifecycle
    def ready(self):
        return bool(self._started and self._warmed and not self._closed
                    and self._broken is None)

    def start(self):
        with self._mu:
            if self._closed:
                raise EngineClosedError('DecodeEngine is shut down')
            if self._started:
                return self
            self._started = True
        self._thread = threading.Thread(
            target=self._worker, name='paddle_tpu_torch_decode_worker',
            daemon=True)
        self._thread.start()
        return self

    def warmup(self):
        """Run every shape live traffic can produce once: one prefill per
        prompt bucket and the decode step, so allocator pools and
        library handles exist before the first request. Warmup feeds point
        every block-table entry past the pool (all writes drop), so the
        arenas are untouched. Returns the number of shapes run."""
        nb = self.num_blocks
        mb, pps = self.max_batch, self.pages_per_seq
        for b in self.prompt_buckets:
            self._run_prefill(np.zeros((1, b), 'int64'), 1, 0,
                              np.full((1, pps), nb, 'int32'), 0.0, 0)
        self._run_decode(
            np.zeros((mb,), 'int64'),
            np.zeros((mb,), 'int32'),
            np.full((mb, pps), nb, 'int32'),
            np.zeros((mb,), 'float32'),
            np.zeros((mb,), 'int32'))
        self.warmup_signatures = len(self.prompt_buckets) + 1
        self._warmed = True
        return self.warmup_signatures

    def drain(self, timeout=None):
        deadline = None if timeout is None else \
            time.perf_counter() + timeout
        with self._done_cv:
            while self._unfinished > 0:
                wait = None if deadline is None else \
                    deadline - time.perf_counter()
                if wait is not None and wait <= 0:
                    return False
                self._done_cv.wait(wait)
        return True

    def shutdown(self, drain=True, timeout=None):
        """Stop accepting requests; drain=True finishes everything
        already accepted, drain=False fails queued-and-running requests
        with EngineClosedError."""
        with self._mu:
            if self._closed and self._thread is None:
                return
            self._closed = True
            self._draining = bool(drain)
            self._mu.notify_all()
        if drain and self._started and self._broken is None:
            self.drain(timeout)
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        if not drain or not self._started:
            self._fail_remaining(EngineClosedError(
                'DecodeEngine shut down without draining'))

    def _request_done(self, n=1):
        with self._done_cv:
            self._unfinished -= n
            if self._unfinished <= 0:
                self._done_cv.notify_all()

    def _fail_remaining(self, exc):
        n = self._sched.fail_all(exc)
        if n:
            self._request_done(n)

    # ------------------------------------------------------------ worker
    def _worker(self):
        try:
            while True:
                with self._mu:
                    while not self._closed and \
                            self._sched.counts() == (0, 0):
                        self._mu.wait()
                    waiting, running = self._sched.counts()
                    if self._closed and (
                            not self._draining or
                            (waiting == 0 and running == 0)):
                        return
                self._admit()
                if self._sched.running:
                    self._decode_step()
                elif self._sched.waiting:
                    # head-of-line blocked on pages with nothing running
                    # to free them — only another submit/shutdown can
                    # change that; avoid a hot spin
                    with self._mu:
                        if not self._closed:
                            self._mu.wait(0.05)
        except Exception as e:  # the worker is the boundary: fail loudly
            self._broken = e
            self._fail_remaining(e)

    def _admit(self):
        while True:
            seq = self._sched.pop_admittable()
            if seq is None:
                return
            self._prefill(seq)

    # ----------------------------------------------------------- dispatch
    def _run_prefill(self, ids, length, cached, table, temp, seed):
        with scope_guard(self._scope):
            out = self._exe.run(
                program=self._progs.prefill,
                feed={'pf_ids': ids,
                      'pf_len': np.asarray([length], 'int32'),
                      'pf_cached': np.asarray([cached], 'int32'),
                      'pf_table': table,
                      'pf_temp': np.asarray([temp], 'float32'),
                      'pf_seed': np.asarray([seed], 'int32')},
                fetch_list=[self._progs.prefill_fetch])
        self.prefills += 1
        return int(np.asarray(out[0]).reshape(-1)[0])

    def _run_decode(self, tokens, lens, tables, temps, seeds):
        with scope_guard(self._scope):
            out = self._exe.run(
                program=self._progs.decode,
                feed={'dec_tokens': tokens, 'dec_lens': lens,
                      'dec_tables': tables, 'dec_temps': temps,
                      'dec_seeds': seeds},
                fetch_list=[self._progs.decode_fetch])
        self.decode_steps += 1
        return np.asarray(out[0]).reshape(-1)

    def _bucket(self, n):
        for b in self.prompt_buckets:
            if n <= b:
                return b
        raise ValueError('prefix of %d tokens exceeds the top prompt '
                         'bucket %d' % (n, self.prompt_buckets[-1]))

    def _table_row(self, seq):
        row = np.full((self.pages_per_seq,), self.num_blocks, 'int32')
        ids = seq.table.block_ids
        row[:len(ids)] = ids
        return row

    def _prefill(self, seq):
        """Prefill the whole ``seq.prefix()`` (prompt, plus what was
        generated before a preemption) and emit its next token."""
        prefix = seq.prefix()
        bucket = self._bucket(len(prefix))
        ids = np.zeros((1, bucket), 'int64')
        ids[0, :len(prefix)] = prefix
        tok = self._run_prefill(ids, len(prefix), 0,
                                self._table_row(seq)[None, :],
                                seq.temperature, seq.seed)
        seq.cache_len = len(prefix)
        self._emit(seq, tok)
        reason = seq.finished()
        if reason:
            self._finish(seq, reason)

    def _decode_step(self):
        for seq in list(self._sched.running):
            if seq.state is not RUNNING:
                continue   # preempted as a victim earlier in this pass
            self._sched.ensure_growth(seq)
        batch = list(self._sched.running)
        if not batch:
            return
        mb, pps, nb = self.max_batch, self.pages_per_seq, self.num_blocks
        tokens = np.zeros((mb,), 'int64')
        lens = np.zeros((mb,), 'int32')
        tables = np.full((mb, pps), nb, 'int32')
        temps = np.zeros((mb,), 'float32')
        seeds = np.zeros((mb,), 'int32')
        for i, seq in enumerate(batch):
            tokens[i] = seq.pending_token
            lens[i] = seq.cache_len
            tables[i] = self._table_row(seq)
            temps[i] = seq.temperature
            seeds[i] = seq.seed
        nxt = self._run_decode(tokens, lens, tables, temps, seeds)
        for i, seq in enumerate(batch):
            seq.cache_len += 1
            self._emit(seq, int(nxt[i]))
            reason = seq.finished()
            if reason:
                self._finish(seq, reason)

    def _emit(self, seq, token):
        seq.generated.append(token)
        seq.pending_token = token
        seq.stream._put(token)

    def _finish(self, seq, reason):
        self._sched.finish(seq, reason)
        self._request_done()
