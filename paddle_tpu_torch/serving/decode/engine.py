"""DecodeEngine: continuous-batching autoregressive decode serving
(reference: paddle_tpu serving/decode/engine.py).

- **submit()** (any thread) validates a prompt against the page budget
  and returns a `GenerationStream` immediately: iterate it for tokens as
  they are generated, or `.result()` for the full sequence.
- **one worker thread** runs the prefill/decode loop: admit waiting
  requests into free batch slots (one `paged_prefill` run per admission,
  bucketed suffix lengths), then one `paged_decode_step` for the whole
  running batch. Sequences enter and leave the running batch
  continuously; the batch never waits for its slowest member.
- **fixed decode shape**: the decode step always runs at [max_batch] with
  per-slot block tables, so the same kernels run whatever the batch
  holds, and a row's result does not depend on the other rows.
- **pool exhaustion** preempts the lowest-class youngest running sequence
  (recompute-style requeue, scheduler.py) rather than failing it. The
  prefix cache's evictor runs first: reclaimable cached pages feed the
  free list before any victim is chosen.
- **global prefix cache** (`prefix_cache=True` or
  PADDLE_TPU_PREFIX_CACHE=1): frozen full pages are published to a radix
  trie keyed by token chains; a request whose prompt hits a cached chain
  maps the shared pages and prefills only the uncached suffix.
- **speculative decoding** (`spec_k=K` or PADDLE_TPU_SPEC_K=K): a host-side
  draft (prompt-lookup n-gram by default, pluggable via ``draft=``)
  proposes k tokens per running sequence and ONE `paged_spec_verify` run
  at a fixed [max_batch, k+1] shape scores every proposal; the longest
  accepted prefix emits up to k+1 tokens a step, the same tokens as plain
  decode.
- **quantized arenas** (`kv_dtype='int8'|'fp8'` or PADDLE_TPU_KV_DTYPE):
  K/V rows stored in one byte an element with one fp32 scale a row.
- **KV page handoff** (serving/handoff.py): ``read_pages`` gathers frozen
  pages out of every arena on the device and copies them through reused
  host staging buffers; ``write_pages`` installs pages into the arena
  tensors in place (never ``scope.set``: a replaced tensor would make the
  executor capture again). Both hold the arena lock, which the worker
  also holds around every step, so a page read or write lands between
  two steps, on the stream the steps run on.

Per-row device work does not depend on the batch, so each request's token
stream is the one it gets alone: continuous batching, prefix caching and
speculation change how fast the tokens come, never which.

The engine runs on ``CUDAPlace(0)`` unless ``place`` says otherwise; with
no CUDA device and no place it raises. On the card each program shape runs
as a CUDA graph (core/executor.py): ``warmup()`` captures every shape live
traffic can produce, so serving captures nothing more (``captures`` stays
where warm-up left it) until ``scope.set`` installs a new tensor.

With ``observe`` on, the engine records the reference's ``decode.*``
metrics (requests, prefills, steps, TTFT, inter-token gaps, queue wait,
request latency, speculation), flight events, and per-request trace
stages; ``start()`` registers a readiness check.
"""

import itertools
import threading
import time

import numpy as np
import torch

from ... import observe as _obs
from ...core.executor import WARMUP_RUNS, Executor
from ...core.scope import Scope, scope_guard
from ...io import raw_bits
from ...observe import reqtrace as _reqtrace
from ...quant.core import resolve_kv_dtype
from ...weights import from_numpy
from ..buckets import pow2_ladder
from ..engine import EngineClosedError, QueueFullError
from .kv_pool import KVPool
from .model import LMSpec, build_lm_programs, kv_bytes_per_token
from .prefix_cache import PrefixCache, prefix_cache_enabled
from .scheduler import RUNNING, Scheduler, Sequence
from .spec import NgramDraft, accept_drafts, spec_k_from_env

__all__ = ['DecodeEngine', 'LMSpec']

_ENGINE_IDS = itertools.count(1)


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
                 draft=None, kv_dtype=None, name=None):
        self.spec = spec
        # fleet identity: the phase router keys membership, placement and
        # per-replica metrics on it
        self.name = str(name) if name else None
        self.max_batch = int(max_batch)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.pages_per_seq = int(pages_per_seq)
        self.max_queue_depth = int(max_queue_depth)
        # feature knobs: explicit constructor args win, else the env
        # (PADDLE_TPU_PREFIX_CACHE / PADDLE_TPU_SPEC_K / PADDLE_TPU_KV_DTYPE,
        # read here, per call, never at import)
        cache_on = prefix_cache_enabled(prefix_cache)
        self.spec_k = spec_k_from_env(spec_k)
        self.kv_dtype = resolve_kv_dtype(kv_dtype)
        self.draft = draft if draft is not None else \
            (NgramDraft() if self.spec_k > 0 else None)
        self._exe = Executor(place)
        self.place = self._exe.place
        self._progs = build_lm_programs(spec, self.max_batch,
                                        self.block_size, self.num_blocks,
                                        self.pages_per_seq,
                                        spec_k=self.spec_k,
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
        if _obs.enabled():
            _obs.set_gauge('decode.kv_bytes_per_token',
                           self.kv_bytes_per_token, kv_dtype=self.kv_dtype)
        self.prefix_cache = PrefixCache(self.pool) if cache_on else None
        self._sched = Scheduler(self.pool, self.max_batch,
                                cache=self.prefix_cache)
        # serializes arena access between the worker's steps and the page
        # reads and writes of the KV handoff (the router's threads): a page
        # write lands between two steps, never inside one
        self._arena_mu = threading.Lock()
        # host staging for page reads and writes: one reused buffer an
        # arena (pages_per_seq pages of every layer, pinned on the card),
        # allocated on first use; _staging_allocs counts the allocations
        self._staging = {}
        self._staging_allocs = 0
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
        self._health_name = None
        self.warmup_signatures = 0
        # runs of each program, read by callers that relate kernel launch
        # counts to engine steps (chip_smoke.py)
        self.prefills = 0
        self.decode_steps = 0
        self.verify_steps = 0
        # speculation: rows verified, draft tokens proposed and accepted
        self.spec_rows = 0
        self.spec_drafted = 0
        self.spec_accepted = 0

    # ----------------------------------------------------------- weights
    def load_weights(self, weights):
        """Install a {param name: array} dict (names per
        model.DecodePrograms.param_names), e.g. the JAX package's
        ``export_weights()`` or ``random_weights``, copied into the
        parameters the scope already holds."""
        unknown = sorted(set(weights) - set(self._progs.param_names))
        if unknown:
            raise ValueError('unknown param names %s (expected a subset '
                             'of %s)' % (unknown, self._progs.param_names))
        for name, t in from_numpy(weights, self.place).items():
            cur = self._scope.find(name)
            if cur is not None and cur.shape == t.shape and \
                    cur.dtype == t.dtype:
                # into the tensor the captured graphs read: they stay valid
                cur.copy_(t)
            else:
                self._scope.set(name, t)

    def export_weights(self):
        return {n: self._scope.numpy(n) for n in self._progs.param_names}

    # ------------------------------------------------------------ intake
    def submit(self, prompt_ids, max_new_tokens=16, temperature=0.0,
               seed=0, eos_id=None, ctx=None, deadline_s=None, tenant=None,
               priority=None):
        """Enqueue one generation request; returns a GenerationStream.
        Raises QueueFullError past max_queue_depth, EngineClosedError
        after shutdown, ValueError for prompts the page budget can never
        hold or token ids outside the vocabulary. ``ctx`` carries an
        upstream trace context (observe.reqtrace); when absent one is made
        here (route 'decode', sampled per PADDLE_TPU_TRACE_SAMPLE, with
        ``deadline_s`` as its budget). ``tenant`` / ``priority``
        (serving.tenancy classes) set the request's admission order,
        preemption order and the eviction order of the cache pages it
        publishes; None means 'standard'."""
        t_sub0 = time.perf_counter()
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
                _obs.inc('decode.rejected_total', reason='queue_full')
                _obs.flight_event('decode_rejected', reason='queue_full',
                                  queue_depth=waiting)
                raise QueueFullError(
                    'decode queue full (%d waiting >= max_queue_depth='
                    '%d)' % (waiting, self.max_queue_depth))
            if ctx is None:
                ctx = _reqtrace.new_context('decode', deadline_s=deadline_s)
            seq = Sequence(next(self._ids), prompt, max_new, temperature,
                           seed, eos_id, ctx=ctx, tenant=tenant,
                           priority=priority)
            with self._done_cv:
                self._unfinished += 1
            self._sched.add(seq)
            self._mu.notify_all()
        if ctx.sampled:
            ctx.stage('submit', t_sub0, time.perf_counter(),
                      prompt_tokens=len(prompt))
            ctx.flow_begin('decode_request')
        _obs.inc('decode.requests_total')
        return seq.stream

    def generate(self, prompt_ids, timeout=None, **kwargs):
        """submit() + wait: returns the generated token list."""
        return self.submit(prompt_ids, **kwargs).result(timeout)

    @property
    def preemptions(self):
        """Sequences preempted (and requeued) so far."""
        return self._sched.preemptions

    @property
    def resident_seqs_peak(self):
        """Most sequences ever running (page-resident) at once."""
        return self._sched.peak_running

    # ------------------------------------------------------- phase load
    def queue_depth(self):
        """Waiting requests: the router's least-loaded signal."""
        waiting, _ = self._sched.counts()
        return waiting

    def free_pages(self):
        """Free KV pages right now: the decode-phase admission signal (a
        decode replica runs out of pages, not of FLOPs)."""
        return self.pool.free_blocks()

    def free_slots(self):
        """Open decode-batch slots (max_batch - running)."""
        return self._sched.free_slots()

    def decode_load(self):
        """(free_pages, free_slots, waiting): what the phase router ranks
        decode replicas by."""
        waiting, _ = self._sched.counts()
        return self.pool.free_blocks(), self._sched.free_slots(), waiting

    @property
    def captures(self):
        """CUDA graphs captured by the engine's executor so far: constant
        from the end of warmup() to shutdown (0 on the CPU place)."""
        return self._exe.captures

    # -------------------------------------------------- KV page handoff
    def kv_geometry(self):
        """The arena contract a KV handoff packet must match exactly:
        geometry (layers, heads, head dims, block size), storage dtype and
        the arena names (serving/handoff.py refuses anything else)."""
        s = self.spec
        return {
            'n_layer': s.n_layer, 'n_head': s.n_head,
            'd_key': s.d_key, 'd_value': s.d_value,
            'block_size': self.block_size, 'kv_dtype': self.kv_dtype,
            'arena_names': tuple(self._progs.arena_names),
        }

    def arena_specs(self):
        """{arena name: logical sharding spec}: None for every arena (one
        card holds them whole), which a packet header records as
        replicated, as the reference's single-device arenas."""
        return {name: None for name in self._progs.arena_names}

    def _stream(self):
        """The stream the engine's steps run on (the worker's current
        stream: the device's default stream), or None on the host."""
        dev = self._exe.device
        return torch.cuda.default_stream(dev) if dev.type == 'cuda' \
            else None

    def _staging_view(self, name, raw, n_pages):
        """The first ``n_pages`` pages of ``name``'s staging buffer, as a
        contiguous host tensor [L, n_pages, ...] of the raw dtype."""
        page_shape = tuple(raw.shape[2:])
        per_page = int(np.prod(page_shape, dtype=np.int64))
        need = raw.shape[0] * self.pages_per_seq * per_page
        buf = self._staging.get(name)
        if buf is None or buf.dtype != raw.dtype or buf.numel() < need:
            buf = torch.empty(need, dtype=raw.dtype,
                              pin_memory=raw.device.type == 'cuda')
            self._staging[name] = buf
            self._staging_allocs += 1
        return buf[:raw.shape[0] * n_pages * per_page].view(
            (raw.shape[0], n_pages) + page_shape)

    def _raw_arena(self, name):
        """The arena and a view of its raw bits (``io.raw_bits``): page
        reads and writes copy bits, exact whatever the dtype."""
        arena = self._scope.get(name)
        return arena, raw_bits(arena)

    def read_pages(self, page_ids):
        """The pages ``page_ids`` of every arena: {arena name: CPU tensor
        [L, n_pages, ...] of the arena's dtype}. Each chunk of at most
        pages_per_seq pages is one gather on the device (``index_select``
        over the page ids, on the raw bits) and one copy into the arena's
        reused staging buffer, copied out under the arena lock, so the
        returned tensors belong to the caller (concurrent exports cannot
        overwrite each other). The caller holds references (pool
        refcounts) on the pages, so they cannot be reallocated mid-read."""
        ids = [int(i) for i in page_ids]
        n, pps = len(ids), self.pages_per_seq
        stream = self._stream()
        out = {}
        t_ask = time.perf_counter()
        with self._arena_mu, torch.cuda.stream(stream):
            t_got = time.perf_counter()
            for name in self._progs.arena_names:
                arena, raw = self._raw_arena(name)
                dest = torch.empty((raw.shape[0], n) + tuple(raw.shape[2:]),
                                   dtype=raw.dtype)
                for start in range(0, n, pps):
                    chunk = ids[start:start + pps]
                    idx = torch.as_tensor(chunk, dtype=torch.int64).to(
                        raw.device)
                    host = self._staging_view(name, raw, len(chunk))
                    host.copy_(raw.index_select(1, idx))
                    dest[:, start:start + len(chunk)] = host
                out[name] = dest.view(arena.dtype)
        self._note_page_io('read', t_ask, t_got)
        return out

    def _note_page_io(self, op, t_ask, t_got):
        """Split one page read or write into its wait for the arena lock
        and its copies under the lock (host clock), the two parts of the
        handoff's export and install seconds."""
        if _obs.enabled():
            _obs.record('decode.arena_wait_seconds', t_got - t_ask, op=op)
            _obs.record('decode.page_copy_seconds',
                        time.perf_counter() - t_got, op=op)

    def write_pages(self, page_ids, arrays):
        """Install page payloads into the arenas at ``page_ids``, in place:
        ``arrays`` maps every arena name to [L, n_pages, ...] host data of
        the arena's dtype (a tensor, or a numpy array of a dtype numpy
        has): the other half of read_pages. Each chunk of at most
        pages_per_seq pages goes through the arena's staging buffer and
        one ``index_copy_`` into the scope's own arena tensor (on the raw
        bits), under the arena lock and on the steps' stream: no tensor is
        replaced, so no captured graph is invalidated. Page ids outside
        the pool are dropped (the reference's scatter ``mode='drop'``).
        Pages must be the caller's (freshly allocated)."""
        ids = [int(i) for i in page_ids]
        keep = [j for j, p in enumerate(ids) if 0 <= p < self.num_blocks]
        srcs = {}
        for name in self._progs.arena_names:
            if name not in arrays:
                raise KeyError('write_pages: missing arena %r' % name)
            arena = self._scope.get(name)
            src = arrays[name]
            if not isinstance(src, torch.Tensor):
                src = torch.from_numpy(np.ascontiguousarray(src))
            want = (arena.shape[0], len(ids)) + tuple(arena.shape[2:])
            if src.dtype != arena.dtype or tuple(src.shape) != want:
                raise ValueError(
                    'write_pages: arena %r takes %s %s, got %s %s'
                    % (name, arena.dtype, want, src.dtype,
                       tuple(src.shape)))
            srcs[name] = src
        if not keep:
            return
        pps = self.pages_per_seq
        stream = self._stream()
        t_ask = time.perf_counter()
        with self._arena_mu, torch.cuda.stream(stream):
            t_got = time.perf_counter()
            for name, src in srcs.items():
                _, raw = self._raw_arena(name)
                src = src.view(raw.dtype)
                for start in range(0, len(keep), pps):
                    chunk = keep[start:start + pps]
                    host = self._staging_view(name, raw, len(chunk))
                    host.copy_(src[:, chunk])
                    idx = torch.as_tensor([ids[j] for j in chunk],
                                          dtype=torch.int64).to(raw.device)
                    raw.index_copy_(1, idx, host.to(raw.device,
                                                    non_blocking=True))
                    if stream is not None:
                        # the staging buffer is reused by the next chunk
                        stream.synchronize()
        self._note_page_io('write', t_ask, t_got)

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
        self._health_name = 'decode.engine%d' % next(_ENGINE_IDS)
        _obs.register_health_check(self._health_name, self._ready_check,
                                   readiness_only=True)
        return self

    def _ready_check(self):
        if self.ready():
            return True, None
        if self._broken is not None:
            return False, 'worker died: %r' % self._broken
        if not self._warmed:
            return False, 'not warmed up'
        return False, 'shutting down' if self._closed else 'not started'

    def warmup(self):
        """Run every shape live traffic can produce: one prefill per prompt
        bucket, the decode step and, with speculation on, the verify step,
        each until the executor has captured it (its eager warm-up runs,
        then the capture), so graphs, allocator pools and library handles
        exist before the first request. Warmup feeds point every
        block-table entry past the pool (all writes drop), so the arenas
        are untouched. Returns the number of shapes run."""
        t_all = time.perf_counter()
        nb = self.num_blocks
        mb, pps = self.max_batch, self.pages_per_seq
        idle = (np.zeros((mb,), 'int32'), np.full((mb, pps), nb, 'int32'),
                np.zeros((mb,), 'float32'), np.zeros((mb,), 'int32'))
        for _ in range(WARMUP_RUNS + 1):
            for b in self.prompt_buckets:
                t0 = time.perf_counter()
                self._run_prefill(np.zeros((1, b), 'int64'), 1, 0,
                                  np.full((1, pps), nb, 'int32'), 0.0, 0)
                _obs.record('decode.warmup_seconds',
                            time.perf_counter() - t0, kind='prefill',
                            bucket=b)
            t0 = time.perf_counter()
            self._run_decode(np.zeros((mb,), 'int64'), *idle)
            _obs.record('decode.warmup_seconds', time.perf_counter() - t0,
                        kind='decode', bucket='')
            if self.spec_k > 0:
                t0 = time.perf_counter()
                self._run_verify(np.zeros((mb, self.spec_k + 1), 'int64'),
                                 *idle)
                _obs.record('decode.warmup_seconds',
                            time.perf_counter() - t0, kind='spec_verify',
                            bucket='')
        self.warmup_signatures = len(self.prompt_buckets) + 1 + \
            (self.spec_k > 0)
        if self.prefix_cache is not None:
            # the KV handoff's page path: a read of pages_per_seq pages
            # allocates the staging buffers, a write to dropped ids runs
            # the install's checks; the arenas are untouched
            t0 = time.perf_counter()
            got = self.read_pages([0] * pps)
            self.write_pages([nb] * pps, got)
            _obs.record('decode.warmup_seconds', time.perf_counter() - t0,
                        kind='handoff', bucket='')
        self._warmed = True
        _obs.set_gauge('decode.warmup_signatures', self.warmup_signatures)
        _obs.set_gauge('decode.warmup_total_seconds',
                       time.perf_counter() - t_all)
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
        if self._health_name is not None:
            _obs.unregister_health_check(self._health_name)
            self._health_name = None
        if drain and self._started and self._broken is None:
            self.drain(timeout)
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        if not drain or not self._started:
            self._fail_remaining(EngineClosedError(
                'DecodeEngine shut down without draining'))
        if self.prefix_cache is not None:
            # the cache dies with the engine: dropping its page references
            # drains the pool to its initial free count
            self.prefix_cache.clear()

    def close(self):
        self.shutdown(drain=True)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown(drain=exc[0] is None)
        return False

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
            _obs.inc('decode.worker_errors_total')
            _obs.flight_event('decode_worker_died', error=repr(e))
            self._fail_remaining(e)

    def _admit(self):
        while True:
            seq = self._sched.pop_admittable()
            if seq is None:
                return
            _obs.record('decode.queue_seconds', seq.t_admit - seq.t_submit,
                        exemplar=seq.ctx.exemplar() if seq.ctx else None)
            if seq.ctx is not None and seq.ctx.sampled:
                # began on the submit thread, ends here on the worker
                seq.ctx.stage('queue_wait', seq.t_submit, seq.t_admit)
                seq.ctx.flow_step()
            self._prefill(seq)

    # ----------------------------------------------------------- dispatch
    def _run_prefill(self, ids, length, cached, table, temp, seed):
        with self._arena_mu, scope_guard(self._scope):
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

    def _run_verify(self, tokens, lens, tables, temps, seeds):
        with self._arena_mu, scope_guard(self._scope):
            out = self._exe.run(
                program=self._progs.verify,
                feed={'sv_tokens': tokens, 'sv_lens': lens,
                      'sv_tables': tables, 'sv_temps': temps,
                      'sv_seeds': seeds},
                fetch_list=[self._progs.verify_fetch])
        self.verify_steps += 1
        return np.asarray(out[0]).reshape(tokens.shape)

    def _run_decode(self, tokens, lens, tables, temps, seeds):
        with self._arena_mu, scope_guard(self._scope):
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
        """Prefill the uncached suffix of ``seq.prefix()`` (prompt, plus
        what was generated before a preemption) and emit its next token:
        the whole prefix on a cache miss, only the tokens past the matched
        span on a hit (the hit's pages are already in the block table)."""
        prefix = seq.prefix()
        cached = seq.cached_len
        suffix = prefix[cached:]
        bucket = self._bucket(len(suffix))
        ids = np.zeros((1, bucket), 'int64')
        ids[0, :len(suffix)] = suffix
        t0 = time.perf_counter()
        tok = self._run_prefill(ids, len(suffix), cached,
                                self._table_row(seq)[None, :],
                                seq.temperature, seq.seed)
        t1 = time.perf_counter()
        _obs.record('decode.prefill_seconds', t1 - t0, bucket=bucket)
        _obs.inc('decode.prefills_total')
        if cached:
            _obs.flight_event('decode_prefix_hit', request_id=seq.request_id,
                              cached_tokens=cached,
                              prefix_tokens=len(prefix))
        if seq.ctx is not None and seq.ctx.sampled:
            seq.ctx.stage('prefill', t0, t1, bucket=bucket,
                          prefix_tokens=len(prefix), cached_tokens=cached)
        seq.cache_len = len(prefix)
        self._maybe_publish(seq)
        self._emit(seq, tok, time.perf_counter())
        reason = seq.finished()
        if reason:
            self._finish(seq, reason)

    def _maybe_publish(self, seq):
        """Offer every newly frozen (full) page to the prefix cache."""
        if self.prefix_cache is None:
            return
        full = seq.cache_len // self.block_size
        if full > seq.published_pages:
            self.prefix_cache.publish(seq.prefix(), seq.table,
                                      seq.cache_len, tenant=seq.tenant,
                                      priority=seq.priority)
            seq.published_pages = full

    def _batch_feeds(self, batch):
        """lens, tables, temps and seeds of ``batch`` at [max_batch]."""
        mb, pps, nb = self.max_batch, self.pages_per_seq, self.num_blocks
        lens = np.zeros((mb,), 'int32')
        tables = np.full((mb, pps), nb, 'int32')
        temps = np.zeros((mb,), 'float32')
        seeds = np.zeros((mb,), 'int32')
        for i, seq in enumerate(batch):
            lens[i] = seq.cache_len
            tables[i] = self._table_row(seq)
            temps[i] = seq.temperature
            seeds[i] = seq.seed
        return lens, tables, temps, seeds

    def _decode_step(self):
        if self.spec_k > 0 and self._spec_step():
            return
        for seq in list(self._sched.running):
            if seq.state is not RUNNING:
                continue   # preempted as a victim earlier in this pass
            self._sched.ensure_growth(seq)
        batch = list(self._sched.running)
        if not batch:
            return
        tokens = np.zeros((self.max_batch,), 'int64')
        for i, seq in enumerate(batch):
            tokens[i] = seq.pending_token
        t0 = time.perf_counter()
        nxt = self._run_decode(tokens, *self._batch_feeds(batch))
        now = time.perf_counter()
        _obs.record('decode.step_seconds', now - t0)
        _obs.record('decode.batch_occupancy',
                    len(batch) / float(self.max_batch))
        _obs.inc('decode.steps_total')
        for i, seq in enumerate(batch):
            seq.cache_len += 1
            self._maybe_publish(seq)
            self._emit(seq, int(nxt[i]), now)
            reason = seq.finished()
            if reason:
                self._finish(seq, reason)

    def _spec_step(self):
        """Draft-and-verify decode: the draft proposes up to k tokens per
        running sequence, one ``paged_spec_verify`` run scores all k+1
        positions of every row, and the longest accepted prefix (plus the
        target's own next token) is emitted: up to k+1 tokens a sequence a
        step, the tokens of one-at-a-time decode, since sampling is keyed
        by (seed, position). Returns False (step not taken) when no
        sequence has a proposal: the plain decode step is cheaper then."""
        k = self.spec_k
        pairs = [(s, list(self.draft.propose(s.prefix(), k))[:k])
                 for s in self._sched.running if s.state is RUNNING]
        if not any(d for _, d in pairs):
            return False
        for seq, _ in pairs:
            if seq.state is not RUNNING:
                continue   # preempted as a victim earlier in this pass
            self._sched.ensure_growth(
                seq, min(seq.cache_len + k + 1, self.capacity))
        # ensure_growth may have preempted members of this very batch
        pairs = [(s, d) for s, d in pairs if s.state is RUNNING]
        if not pairs:
            return True
        tokens = np.zeros((self.max_batch, k + 1), 'int64')
        drafts = []
        for i, (seq, d) in enumerate(pairs):
            self.spec_drafted += len(d)
            _obs.inc('decode.spec_draft_tokens_total', len(d))
            d = d + [0] * (k - len(d))   # padded drafts verify for free
            drafts.append(d)
            tokens[i, 0] = seq.pending_token
            tokens[i, 1:] = d
        t0 = time.perf_counter()
        nxt = self._run_verify(tokens,
                               *self._batch_feeds([s for s, _ in pairs]))
        now = time.perf_counter()
        _obs.record('decode.step_seconds', now - t0)
        _obs.record('decode.batch_occupancy',
                    len(pairs) / float(self.max_batch))
        _obs.inc('decode.steps_total')
        _obs.inc('decode.spec_steps_total')
        for i, (seq, _) in enumerate(pairs):
            emit = accept_drafts(drafts[i], nxt[i])
            self.spec_rows += 1
            self.spec_accepted += len(emit) - 1
            _obs.record('decode.spec_accepted_len', len(emit) - 1)
            _obs.inc('decode.spec_accepted_tokens_total', len(emit) - 1)
            for tok in emit:
                seq.cache_len += 1
                self._maybe_publish(seq)
                self._emit(seq, int(tok), now)
                reason = seq.finished()
                if reason:
                    self._finish(seq, reason)
                    break
        return True

    def _emit(self, seq, token, now):
        seq.generated.append(token)
        seq.pending_token = token
        if self.draft is not None and hasattr(self.draft, 'observe'):
            # online draft training: every target emission teaches the
            # draft what follows this context window
            g = seq.generated
            self.draft.observe(g[-4:] if len(g) >= 4
                               else (seq.prompt + g)[-4:])
        if seq.t_first_token is None:
            seq.t_first_token = now
            _obs.record('decode.ttft_seconds', now - seq.t_submit,
                        cached='1' if seq.cached_len else '0')
        if seq.t_last_token is not None:
            _obs.record('decode.inter_token_seconds',
                        now - seq.t_last_token)
        seq.t_last_token = now
        seq.stream._put(token)
        seq.streamed += 1
        if seq.ctx is not None and seq.ctx.sampled:
            # one instant mark a generated token: the decode cadence
            seq.ctx.event('token', pos=len(seq.generated))
        _obs.inc('decode.tokens_total')

    def _finish(self, seq, reason):
        self._sched.finish(seq, reason)
        _obs.record('decode.request_seconds',
                    time.perf_counter() - seq.t_submit,
                    exemplar=seq.ctx.exemplar() if seq.ctx else None)
        _obs.record('decode.request_tokens', len(seq.generated))
        if seq.ctx is not None and seq.ctx.sampled:
            seq.ctx.event('finish', reason=reason,
                          tokens=len(seq.generated))
            seq.ctx.flow_end()
        self._request_done()
