"""High-level Trainer (reference: paddle_tpu trainer.py; the v2 trainer
loop python/paddle/v2/trainer.py SGD.train with event handlers, and the
later fluid.Trainer shape).

A reader-driven loop over the Executor: batches from a v2-style reader,
step and epoch events to a handler, checkpoints through
fault.CheckpointManager (periodic mid-epoch saves, keep-last-K retention,
sha1-verified auto-resume) and bad-step guards (fault.guards) on the
fetched loss.

The loop is a bounded asynchronous pipeline (``train(pipeline_depth=D)``):
each step is enqueued on the card without a synchronisation
(``Executor.run(..., return_handle=True)``) and a deque of at most D
in-flight StepHandles is resolved oldest-first, so the host prepares and
enqueues steps k+1..k+D while step k runs. D=1 (the default) resolves
each dispatch at once; every depth runs the same steps in the same order
on the same state, so parameters and events are the same at any depth.
``host_prefetch=N`` moves reader iteration, feed conversion and window
stacking onto a worker thread behind a bounded queue;
``steps_per_dispatch=w`` runs windows of w steps through
``Executor.run_steps``.

The scope is the caller's ``global_scope()`` (use ``scope_guard`` for
another). The JAX package's telemetry (the observe calls) and its static
program verification are not ported (ROADMAP Queue 1 item 11);
``stacked_windows`` waits for the staging ring (Queue 1 item 2).
"""

import collections
import threading
import time

import numpy as np
import torch

from . import io as _io
from .core.executor import Executor
from .core.place import CUDAPlace
from .core.program import (default_main_program, default_startup_program,
                           program_guard)
from .fault import CheckpointConfig, CheckpointManager
from .fault import inject as _inject
from .fault.guards import BadStepGuard, is_bad

__all__ = ['BeginEpochEvent', 'EndEpochEvent', 'BeginStepEvent',
           'EndStepEvent', 'Trainer']

_PREFETCH_ERR = object()


class BeginEpochEvent(object):
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class EndEpochEvent(object):
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class BeginStepEvent(object):
    def __init__(self, epoch_id, step_id):
        self.epoch = epoch_id
        self.step = step_id


class EndStepEvent(object):
    """A step's result for the event handler: the fetched ``metrics`` and
    ``wall_time``, the host seconds charged to this step (a window's wall
    split evenly; a pipelined step's wall excludes the time it overlapped
    older in-flight steps). ``telemetry`` is always None in the port."""

    def __init__(self, epoch_id, step_id, metrics, wall_time=None,
                 telemetry=None):
        self.epoch = epoch_id
        self.step = step_id
        self.metrics = metrics
        self.wall_time = wall_time
        self.telemetry = telemetry


class _Inflight(object):
    """One dispatched but unresolved unit of the trainer's pipeline."""

    __slots__ = ('epoch', 'step0', 'steps', 'items', 'handle', 't0')

    def __init__(self, epoch, step0, steps, items, handle, t0):
        self.epoch = epoch
        self.step0 = step0
        self.steps = steps
        self.items = items
        self.handle = handle
        self.t0 = t0        # dispatch (enqueue) start


class Trainer(object):
    """``train_func`` builds the graph and returns the fetch vars (loss
    first); ``optimizer_func`` returns the optimizer. With no place the
    trainer runs on ``CUDAPlace(0)`` and raises without a CUDA device."""

    def __init__(self, train_func, optimizer_func, place=None,
                 checkpoint_config=None, program=None,
                 startup_program=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.program = program or default_main_program()
        self.startup = startup_program or default_startup_program()
        # build into self.program / self.startup even when the caller
        # passed its own Programs
        with program_guard(self.program, self.startup):
            self.fetches = train_func()
            if not isinstance(self.fetches, (list, tuple)):
                self.fetches = [self.fetches]
            optimizer_func().minimize(self.fetches[0])
        self.exe = Executor(self.place)
        if isinstance(checkpoint_config, str):
            # a bare dirname: epoch-end saves only, guards off
            checkpoint_config = CheckpointConfig(checkpoint_config,
                                                 nan_policy=None)
        self.checkpoint_config = checkpoint_config
        self._ckpt = (CheckpointManager(checkpoint_config)
                      if checkpoint_config is not None else None)
        self.checkpoint_dir = (checkpoint_config.dirname
                               if checkpoint_config is not None else None)
        self._guard = None
        if checkpoint_config is not None and checkpoint_config.nan_policy:
            self._guard = BadStepGuard(
                checkpoint_config.nan_policy,
                checkpoint_config.max_bad_steps,
                manager=self._ckpt, executor=self.exe,
                program=self.program)
        self._ckpt_reader = None
        self._last_save = time.monotonic()
        self._step = 0
        # pipeline state
        self._event_handler = lambda e: None
        self._inflight = collections.deque()
        self._group_start_step = 0     # _step at the last pipeline-empty
        self._last_resolve_end = None
        self._in_ckpt_drain = False
        # pulled-vs-trained ledger in reader yields: _pulled moves with
        # the reader (maybe on the prefetch thread), _trained with
        # resolves; the lock keeps a checkpoint's (offset, pending) pair
        # consistent against concurrent pulls
        self._reader_lock = threading.Lock()
        self._pulled = 0
        self._trained = 0
        self._pending = 0
        # request_yield() parks the loop at its next dispatch boundary
        # (drained) until resume_from_yield(); pausing between dispatches
        # never changes what is dispatched
        self._yield_requested = False
        self._yield_gate = threading.Event()
        self._yield_gate.set()
        self._parked = False

    def _to_feed(self, data, feeder, feed_order):
        if feeder is not None:
            return feeder.feed(data)
        if isinstance(data, dict):
            return data
        return {name: np.asarray([d[i] for d in data])
                for i, name in enumerate(feed_order)}

    def train(self, num_epochs, event_handler=None, reader=None,
              feed_order=None, feeder=None, steps_per_dispatch=1,
              pipeline_depth=1, host_prefetch=0, stacked_windows=False):
        """Event-driven training loop (the reference's v2 contract).

        ``steps_per_dispatch`` w > 1 runs windows of w steps as one
        ``Executor.run_steps`` over stacked feeds (the same trajectory):
        a window's BeginStepEvents fire before its dispatch and its
        EndStepEvents, with each step's metrics, after. Batches that do
        not fill a window run one by one.

        ``pipeline_depth`` D > 1 keeps up to D dispatches in flight,
        resolved oldest-first: BeginStepEvent fires at dispatch and
        EndStepEvent at resolve. Checkpoint cadence points and skip_step
        snapshots drain the pipeline first, so a save may land up to D-1
        steps late and skip_step undoes a whole drain group.

        ``host_prefetch`` N > 0 prepares feeds on a worker thread behind
        a queue of at most N."""
        if stacked_windows:
            raise NotImplementedError(
                'Trainer.train(stacked_windows=True) reads device-resident '
                'superbatches from the staging ring, not ported to '
                'paddle_tpu_torch (ROADMAP Queue 1 item 2)')
        event_handler = event_handler or (lambda e: None)
        self._event_handler = event_handler
        _inject.install_from_env()
        from .reader.state import CheckpointableReader
        self._ckpt_reader = (reader if isinstance(reader,
                                                  CheckpointableReader)
                             else None)
        self.exe.run(self.startup)
        start_epoch = 0
        resume_step = 0
        if self._ckpt is not None and self.checkpoint_config.resume:
            meta = self._ckpt.restore(self.exe, self.program,
                                      reader=self._ckpt_reader)
            if meta is not None:
                if meta.get('reader') and self._ckpt_reader is None \
                        and reader is not None:
                    import warnings
                    warnings.warn(
                        'resume: the checkpoint records a reader '
                        'position but the passed reader is not a '
                        'CheckpointableReader — the resumed stream '
                        'will REPLAY already-trained items. Wrap it in '
                        'reader.checkpointable(...) to resume '
                        'mid-epoch.')
                self._step = int(meta.get('step') or 0)
                # the dropout masks go on where they stopped: the startup
                # run took step index 0, training step k runs at k + 1
                self.exe.set_step(self._step + 1)
                tstate = meta.get('trainer') or {}
                start_epoch = int(tstate.get('epoch', 0))
                resume_step = int(tstate.get('epoch_step', 0))
        self._last_save = time.monotonic()
        w = int(steps_per_dispatch)
        depth = max(1, int(pipeline_depth))
        self._inflight = collections.deque()
        self._last_resolve_end = None
        self._in_ckpt_drain = False
        self._pulled = 0
        self._trained = 0
        # skip_step undoes through a host snapshot taken at pipeline-empty
        # points: the whole group drains before the pipeline refills
        sync_groups = self._guard is not None and \
            self._guard.needs_snapshot
        for epoch in range(start_epoch, num_epochs):
            event_handler(BeginEpochEvent(epoch))
            # resumed mid-epoch: the CheckpointableReader replays only the
            # untrained remainder; step ids go on where they left off
            step = resume_step
            resume_step = 0
            units = self._feed_units(reader, feeder, feed_order, w)
            if host_prefetch and int(host_prefetch) > 0:
                units = self._prefetch_units(units, int(host_prefetch))
            for feed, n_steps, n_items in units:
                if self._yield_requested:
                    self._yield_point()
                self._dispatch(epoch, step, feed, n_steps, n_items)
                step += n_steps
                if len(self._inflight) >= depth:
                    if sync_groups:
                        while self._inflight:
                            self._resolve_oldest()
                    else:
                        self._resolve_oldest()
            while self._inflight:
                self._resolve_oldest()
            event_handler(EndEpochEvent(epoch))
            if self._ckpt is not None and self.checkpoint_config.epoch_end:
                with self._reader_lock:
                    self._pending = self._pulled - self._trained
                    self._save_checkpoint(epoch + 1, 0)
        if self._ckpt is not None:
            # the completeness point: the last async save has landed
            self._ckpt.wait()

    # ------------------------------------------------------ feed stream
    @staticmethod
    def _feed_sig(feed):
        return {n: tuple(v.shape) if hasattr(v, 'shape')
                else np.asarray(v).shape for n, v in feed.items()}

    @staticmethod
    def _stack_window(window):
        """Stack w per-step feeds into [w, ...] arrays (tensors stay
        tensors) for run_steps(stacked_feed=True)."""
        out = {}
        for name in window[0]:
            vals = [f[name] for f in window]
            out[name] = torch.stack(vals) if isinstance(
                vals[0], torch.Tensor) else np.stack(vals)
        return out

    def _feed_units(self, reader, feeder, feed_order, w):
        """One epoch of prepared dispatch units (feed, n_steps, n_items):
        reader pulls, feed conversion and window stacking, so that
        _prefetch_units can move the whole generator onto a worker
        thread. n_items counts reader yields (the CheckpointableReader's
        offset unit)."""
        it = iter(reader())
        window = []
        while True:
            with self._reader_lock:
                try:
                    data = next(it)
                except StopIteration:
                    break
                self._pulled += 1
            feed = self._to_feed(data, feeder, feed_order)
            if w <= 1:
                yield feed, 1, 1
                continue
            if window and self._feed_sig(feed) != \
                    self._feed_sig(window[0]):
                # a shape change mid-window: the collected prefix runs
                # step by step, stacking resumes at this batch
                for f in window:
                    yield f, 1, 1
                window = []
            window.append(feed)
            if len(window) == w:
                stacked = self._stack_window(window)
                window = []
                yield stacked, w, w
        for f in window:    # a trailing window runs step by step
            yield f, 1, 1

    def _prefetch_units(self, units, depth):
        """Iterate ``units`` on a worker thread behind a Queue(depth).
        Puts watch a closed flag, so a consumer that stops early never
        leaves the worker blocked on a full queue."""
        from queue import Full, Queue
        q = Queue(maxsize=max(1, int(depth)))
        done = object()
        closed = threading.Event()

        def _put(item):
            while not closed.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except Full:
                    pass
            return False

        def work():
            try:
                for unit in units:
                    if not _put(unit):
                        return
                _put(done)
            except BaseException as e:   # raised on the consumer's side
                _put((_PREFETCH_ERR, e, None))

        t = threading.Thread(target=work, daemon=True,
                             name='paddle_tpu_torch_trainer_prefetch')
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if item[0] is _PREFETCH_ERR:
                    raise item[1]
                yield item
        finally:
            closed.set()

    # -------------------------------------------------------- yielding
    def request_yield(self):
        """Ask the loop to pause at its next dispatch boundary; it drains
        its in-flight steps, then parks until resume_from_yield(). A
        yield never changes what is dispatched."""
        self._yield_gate.clear()
        self._yield_requested = True

    def resume_from_yield(self):
        """Release a request_yield() park (idempotent)."""
        self._yield_requested = False
        self._yield_gate.set()

    def yielded(self):
        """True while the loop is parked (drained and blocked)."""
        return self._parked

    def _yield_point(self):
        while self._inflight:
            self._resolve_oldest()
        self._parked = True
        self._yield_gate.wait()
        self._parked = False

    # ------------------------------------------------- dispatch/resolve
    def _dispatch(self, epoch, step0, feed, n_steps, n_items):
        handler = self._event_handler
        g = self._guard
        if not self._inflight:
            if g is not None and g.needs_snapshot:
                # nothing is in flight: the snapshot stalls no work
                g.snapshot()
            self._group_start_step = self._step
        for i in range(n_steps):
            handler(BeginStepEvent(epoch, step0 + i))
        t0 = time.perf_counter()
        if n_steps == 1:
            h = self.exe.run(program=self.program, feed=feed,
                             fetch_list=self.fetches, return_handle=True)
        else:
            h = self.exe.run_steps(n_steps, program=self.program, feed=feed,
                                   fetch_list=self.fetches,
                                   stacked_feed=True, return_handle=True)
        self._inflight.append(
            _Inflight(epoch, step0, n_steps, n_items, h, t0))

    def _resolve_oldest(self):
        """Resolve the oldest in-flight dispatch: wait for its fetches,
        run the guard, fire its EndStepEvents, count it and checkpoint
        when due. Returns (epoch, next in-epoch step) of the unit."""
        handler = self._event_handler
        ent = self._inflight.popleft()
        metrics = ent.handle.resolve()
        r1 = time.perf_counter()
        self._step += ent.steps
        g = self._guard
        verdict = 'ok'
        if g is not None:
            undo = ent.steps
            if is_bad(metrics[0]) and self._inflight:
                # the steps behind this one ran on poisoned state: drain
                # and discard them before the guard restores anything
                self._drain_discard()
            if g.needs_snapshot:
                # the snapshot predates the whole drain group
                undo = self._step - self._group_start_step
            verdict = g.handle(metrics[0], self._step, steps=undo)
            if verdict == 'skipped':
                self._step = self._group_start_step
        if self._last_resolve_end is not None:
            wall = r1 - max(ent.t0, self._last_resolve_end)
        else:
            wall = r1 - ent.t0
        self._last_resolve_end = r1
        if ent.steps == 1:
            handler(EndStepEvent(ent.epoch, ent.step0, metrics,
                                 wall_time=wall))
        else:
            for i in range(ent.steps):
                handler(EndStepEvent(
                    ent.epoch, ent.step0 + i,
                    [np.asarray(m[i]) for m in metrics],
                    wall_time=wall / ent.steps))
        self._trained += ent.items
        if verdict == 'ok':
            # never checkpoint a bad step's state
            self._maybe_checkpoint(ent.epoch, ent.step0 + ent.steps)
        _inject.fire('step_end', step=self._step)
        return ent.epoch, ent.step0 + ent.steps

    def _drain_discard(self):
        """A bad step with younger dispatches in flight: resolve them
        (the guard's restore overwrites their updates), fire their
        EndStepEvents and count their reader items as consumed (the
        stream goes on past a bad batch), but not their steps."""
        handler = self._event_handler
        while self._inflight:
            ent = self._inflight.popleft()
            metrics = ent.handle.resolve()
            if ent.steps == 1:
                handler(EndStepEvent(ent.epoch, ent.step0, metrics))
            else:
                for i in range(ent.steps):
                    handler(EndStepEvent(
                        ent.epoch, ent.step0 + i,
                        [np.asarray(m[i]) for m in metrics]))
            self._trained += ent.items

    # ----------------------------------------------------- checkpoints
    def _save_checkpoint(self, epoch, epoch_step):
        """Checkpoint now, recording where the loop stands: a resume
        restarts at (epoch, epoch_step) with the reader replaying the
        untrained remainder of that epoch."""
        self._ckpt.save(self.exe, self.program, step=self._step,
                        reader=self._ckpt_reader,
                        reader_pending=self._pending,
                        trainer_state={'epoch': int(epoch),
                                       'epoch_step': int(epoch_step)})
        self._last_save = time.monotonic()

    def _ckpt_cadence_due(self):
        cfg = self.checkpoint_config
        if self._ckpt is None or (not cfg.save_every_steps and
                                  cfg.save_every_secs is None):
            return False
        due = bool(cfg.save_every_steps) and self._step > 0 and \
            self._step % cfg.save_every_steps == 0
        if not due and cfg.save_every_secs is not None:
            due = time.monotonic() - self._last_save >= cfg.save_every_secs
        return due

    def _maybe_checkpoint(self, epoch, epoch_step):
        if self._in_ckpt_drain or not self._ckpt_cadence_due():
            return
        # a due save is a sync point: younger steps already dispatched
        # resolve first, so the saved state and position agree (the save
        # lands up to depth-1 steps late under pipelining)
        self._in_ckpt_drain = True
        try:
            while self._inflight:
                epoch, epoch_step = self._resolve_oldest()
        finally:
            self._in_ckpt_drain = False
        with self._reader_lock:
            self._pending = self._pulled - self._trained
            if self._ckpt_reader is not None and \
                    self._pending > self._ckpt_reader.offset:
                # pulled-but-untrained items span an epoch boundary: their
                # positions are unknowable, so the next cadence point saves
                return
            self._save_checkpoint(epoch, epoch_step)

    def save_params(self, dirname):
        _io.save_params(self.exe, dirname, main_program=self.program)

    def save_inference_model(self, dirname, feeded_var_names,
                             target_vars):
        _io.save_inference_model(dirname, feeded_var_names, target_vars,
                                 self.exe, main_program=self.program)
