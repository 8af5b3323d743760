"""Executor: runs a Program's ops through the torch lowerings, on a CUDA
place as one CUDA graph per key.

Reference: paddle/fluid/framework/executor.{h,cc} + python/fluid/executor.py,
and the JAX package's compile-once / dispatch-many executor. The ops that
contribute to the fetches or write persistable state are kept (the same
pruning as the JAX package's executor), feeds become tensors on the
place's device, each op's lowering runs in order, and persistable outputs
are written into the scope's own tensors, in place (a lowering that
returns a new tensor for one is copied into the tensor the scope holds),
so a scope tensor keeps its address from step to step. Lowerings may
update scope tensors in place (the decode ops write their KV rows into the
arenas, the optimizer ops their parameters and moments).

On a CUDA place, ``run`` keys each call as the reference keys its
executables: (program, version, amp, the sorted (name, shape, dtype) of the
feeds, the fetch names). The first ``WARMUP_RUNS`` calls of a key run
eagerly, on the side stream the capture uses (so cuBLAS, cuDNN and
autograd are set up before it); the next call captures the step into a
``torch.cuda.CUDAGraph`` and replays it; later calls only replay. Every
call is exactly one step. Feeds go into the graph's static device buffers
(through pinned staging buffers, guarded by an event), fetches are copied
out of the graph right after its replay, and the step index lives in a
device tensor that the graph reads and advances. A replay first checks
that every scope tensor the graph reads or writes is still the one it
captured; where ``scope.set`` installed another, the key is captured again
(a cache miss). The graphs of one executor share one memory pool (they
never run at once). Kernel launch counts (``ops.kernels.launch_counters``)
move at each replay by what the capture recorded.

A plan that holds a host-bound op (``registry.HOST_BOUND``: the startup
ops that draw on the host) is never captured, and neither is a run on the
CPU place or with ``use_program_cache=False``: those run eagerly, one
launch per op. ``last_captured`` says which way this thread's last call
went. A capture or replay that fails raises; nothing falls back.

A program with a ``backward_marker`` (optimizer.minimize) is a training
step: the ops before the marker run with the trainable parameters as leaf
tensors, ``torch.autograd.grad`` of the summed loss gives every ``p@GRAD``
(zero where the loss does not reach a parameter, as jax.value_and_grad
gives), and the ops after it run under ``torch.no_grad()`` once the
gradients exist, so no tensor saved for the backward aliases a parameter
being updated. Everything else runs under ``torch.no_grad()``. In the
forward, a var with an ``error_clip`` (clip.ErrorClipByValue) is wrapped
in an identity whose backward clamps its gradient, as the reference's
custom_vjp does.

``set_step`` fills the step index in place: a resumed Trainer sets it
where its checkpoint left off, so the captured graphs, which read that
tensor, draw the uninterrupted run's masks.
"""

import threading
import time

import numpy as np
import torch

from ..clip import ErrorClipByValue, error_clip_grad
from .dtypes import to_torch_dtype
from .place import CUDAPlace
from .program import Variable, default_main_program
from .registry import (AMP_BF16_OUT_SLOTS, HOST_BOUND, LoweringContext,
                       get_lowering)
from .scope import global_scope, tensor_to_numpy

# eager runs of a key on the CUDA place before it is captured
WARMUP_RUNS = 1


def _ensure_ops_imported():
    from .. import ops as _ops  # noqa: F401  (registers lowerings)


def _analyze(block, ops, feed_names):
    """Scope inputs (values read before any op defines them) and scope
    outputs (persistable vars written)."""
    defined = set(feed_names)
    scope_in, scope_out = [], []
    for op in ops:
        if op.type == 'backward_marker':
            defined.update(op.attrs['grad_names'])
            continue
        for name in op.input_names():
            if name in defined or name in scope_in:
                continue
            scope_in.append(name)
        for name in op.output_names():
            defined.add(name)
            var = block._find_var_recursive(name)
            if var is not None and var.persistable and name not in scope_out:
                scope_out.append(name)
    return scope_in, scope_out


def collect_error_clips(block, ops):
    """{var name: (lo, hi)} for every op output carrying an error_clip
    (reference: paddle_tpu core/executor.py collect_error_clips). Only
    ErrorClipByValue maps onto the cotangent clamp."""
    clips = {}
    for op in ops:
        for n in op.output_names():
            if n in clips:
                continue
            v = block._find_var_recursive(n)
            ec = getattr(v, 'error_clip', None) if v is not None else None
            if ec is None:
                continue
            if not isinstance(ec, ErrorClipByValue):
                raise NotImplementedError(
                    'error_clip on %r: only ErrorClipByValue is '
                    'supported by the cotangent-clamp lowering (got %s)'
                    % (n, type(ec).__name__))
            clips[n] = (float(ec.min), float(ec.max))
    return clips


def _prune_ops(block, ops, fetch_names):
    """Keep ops contributing to fetches or to persistable state updates."""
    needed = set(fetch_names)
    kept = []
    for op in reversed(ops):
        writes_state = any(
            (lambda v: v is not None and v.persistable)(
                block._find_var_recursive(n))
            for n in op.output_names())
        if op.type == 'backward_marker' or writes_state or \
                (set(op.output_names()) & needed):
            kept.append(op)
            needed.update(op.input_names())
            if op.type == 'backward_marker':
                needed.add(op.attrs['loss_name'])
    kept.reverse()
    return kept


def _detached(value):
    return value.detach() if value.requires_grad else value


def _counters():
    from ..ops.kernels import launch_counters
    return [(fn, attr) for _, fn, attr in launch_counters()]


def _read_counts():
    return [getattr(fn, attr) for fn, attr in _counters()]


class StepHandle(object):
    """One dispatched step (or ``run_steps`` window) whose fetches may still
    be in flight.

    ``run(..., return_handle=True)`` returns once the step is enqueued.
    ``resolve()`` waits for it and returns the fetches as numpy arrays
    (idempotent: the tensors are dropped on the first call); ``ready()``
    asks without waiting. On the card the fetches are pinned host tensors
    whose copies are enqueued behind the step, and both read a CUDA event
    recorded after those copies, so a handle waits for its own dispatch
    only, never for younger ones (the Trainer's pipeline keeps several in
    flight); on the CPU a handle is ready at once.
    ``dispatched_at`` is the host clock (time.perf_counter) at enqueue."""

    __slots__ = ('fetches', 'steps', 'dispatched_at', 'cache_miss',
                 '_event', '_resolved')

    def __init__(self, fetches, steps=1, cache_miss=False, event=None):
        self.fetches = fetches
        self.steps = int(steps)
        self.cache_miss = bool(cache_miss)
        self.dispatched_at = time.perf_counter()
        self._event = event
        self._resolved = None

    def ready(self):
        """True when every fetch has landed (does not block)."""
        if self._resolved is not None or self._event is None:
            return True
        return bool(self._event.query())

    def resolve(self):
        """Block until the dispatch completes; returns numpy fetches."""
        if self._resolved is None:
            if self._event is not None:
                self._event.synchronize()
            self._resolved = [tensor_to_numpy(v) for v in self.fetches]
            self.fetches = self._resolved
            self._event = None
        return self._resolved


class _Graph(object):
    """One captured step: the graph, its static feed buffers (and pinned
    staging buffers with the event of their last copy), its fetch tensors
    (in the graph's pool: copied out right after each replay), the scope
    tensors it reads or writes, and the launch counts one replay adds."""

    __slots__ = ('graph', 'feeds', 'staging', 'staged', 'fetches',
                 'scope_refs', 'deltas')

    def valid(self, scope):
        for name, t in self.scope_refs:
            cur = scope.find(name)
            if not isinstance(cur, torch.Tensor) or \
                    cur.data_ptr() != t.data_ptr() or \
                    cur.shape != t.shape or cur.dtype != t.dtype:
                return False
        return True


class _KeyState(object):
    """A key's eager runs so far, its graph, and whether its plan holds a
    host-bound op."""

    __slots__ = ('eager_runs', 'graph', 'host_bound')

    def __init__(self, host_bound):
        self.eager_runs = 0
        self.graph = None
        self.host_bound = host_bound


class _Plan(object):
    """What one (program, feeds, fetches) runs: the kept ops, the
    feeds they need, the scope's inputs and outputs, the backward
    marker's index (None for no training section), the names any kept op
    reads or the caller fetches, and for each op the values no later op
    reads (``frees``: the step drops them from its environment after that
    op, so a step holds only its live values; autograd keeps what the
    backward saved)."""

    def __init__(self, block, ops, feed_names, fetch_names):
        self.ops = ops
        consumed = set()
        for op in ops:
            consumed.update(op.input_names())
        self.needed_feeds = sorted(
            n for n in consumed
            if (lambda v: v is not None and v.is_data)(
                block._find_var_recursive(n)))
        self.scope_in, self.scope_out = _analyze(block, ops, feed_names)
        markers = [i for i, op in enumerate(ops)
                   if op.type == 'backward_marker']
        if len(markers) > 1:
            raise NotImplementedError(
                'Program has %d backward sections (several minimize / '
                'append_backward calls); build each loss in its own '
                'Program.' % len(markers))
        self.marker = markers[0] if markers else None
        self.error_clips = collect_error_clips(
            block, ops if self.marker is None else ops[:self.marker])
        self.reads = consumed | set(fetch_names)
        keep = set(fetch_names) | set(self.scope_out)
        last = {}
        for i, op in enumerate(ops):
            for name in op.output_names() + op.input_names():
                last[name] = i
        # the scope's inputs, and the loss, live to the end of the forward:
        # in a training step that is the marker, whose frees the step
        # releases after the backward
        end = len(ops) if self.marker is None else self.marker
        held = set(self.scope_in)
        if self.marker is not None:
            held.add(ops[self.marker].attrs['loss_name'])
        for name in held:
            last[name] = max(last.get(name, end), end)
        self.frees = {}
        for name, i in last.items():
            if name not in keep:
                self.frees.setdefault(i, []).append(name)


class Executor(object):
    """``Executor(place)``; with no place it runs on ``CUDAPlace(0)`` and
    raises when there is no CUDA device."""

    def __init__(self, place=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.device()
        self._plans = {}
        self._keys = {}
        # the step index (keys each step's dropout masks and is read by a
        # captured graph at replay): a 0-dim int64 tensor on the device,
        # advanced by every step
        self._step = None
        # CUDA graphs captured so far (a re-capture counts again)
        self.captures = 0
        self._pool = None
        self._side = None
        # one dispatch at a time: lowerings update scope tensors in place,
        # and the graphs share one memory pool
        self._lock = threading.Lock()
        self._tls = threading.local()

    @property
    def last_cache_miss(self):
        """Whether THIS thread's most recent run()/run_steps() call saw a
        key for the first time or (re)captured its graph."""
        return getattr(self._tls, 'last_cache_miss', False)

    @property
    def last_captured(self):
        """Whether THIS thread's most recent run()/run_steps() call ran its
        (last) step as a replay of a CUDA graph: False for an eager warm-up
        run, a host-bound plan, the CPU place or use_program_cache=False."""
        return getattr(self._tls, 'last_captured', False)

    def set_step(self, step):
        """Set the step index (it keys each step's dropout masks) to
        ``step``, in place: the captured graphs read this tensor. The
        startup program's run takes index 0, so training step k (from 0)
        runs at k + 1; a resumed trainer sets its next step's index."""
        with self._lock:
            self._step_tensor().fill_(int(step))

    def close(self):
        """Drop every captured graph (and its pool) and plan."""
        with self._lock:
            self._keys.clear()
            self._plans.clear()
            self._pool = None

    def _plan(self, program, feed_names, fetch_names):
        key = (id(program), program._version, tuple(sorted(feed_names)),
               tuple(fetch_names))
        plan = self._plans.get(key)
        if plan is None:
            block = program.global_block()
            ops = _prune_ops(block, list(block.ops), fetch_names)
            plan = _Plan(block, ops, feed_names, fetch_names)
            self._plans[key] = plan
        return plan

    def _feed_value(self, block, name, value):
        """The feed as a tensor of its var's dtype, where it was given (a
        numpy array becomes a CPU tensor)."""
        var = block._find_var_recursive(name)
        dtype = to_torch_dtype(var.dtype) if var is not None else None
        t = value if isinstance(value, torch.Tensor) else \
            torch.as_tensor(np.ascontiguousarray(value))
        if dtype is not None and t.dtype != dtype:
            t = t.to(dtype)
        return t

    def _prepare(self, program, feed, fetch_list, scope):
        _ensure_ops_imported()
        program = program if program is not None else default_main_program()
        fetch_list = fetch_list or []
        scope = scope if scope is not None else global_scope()
        block = program.global_block()
        fetch_names = [f.name if isinstance(f, Variable) else f
                       for f in fetch_list]
        with torch.no_grad():
            feeds = {n: self._feed_value(block, n, v)
                     for n, v in (feed or {}).items()}
        return program, block, feeds, fetch_names, scope

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, use_program_cache=True, return_handle=False):
        program, block, feeds, fetch_names, scope = self._prepare(
            program, feed, fetch_list, scope)
        plan = self._plan(program, list(feeds), fetch_names)
        self._check_feeds(plan, feeds, 'Executor.run')
        key = self._key(program, feeds, fetch_names)
        with self._lock:
            fetches, missed, captured = self._dispatch(
                program, block, plan, key, feeds, fetch_names, scope,
                use_program_cache)
            if return_handle:
                fetches, event = self._copy_out(fetches)
        self._tls.last_cache_miss = missed
        self._tls.last_captured = captured
        if return_handle:
            return StepHandle(fetches, 1, missed, event)
        if return_numpy:
            return [tensor_to_numpy(v) for v in fetches]
        return fetches

    def run_steps(self, steps, program=None, feed=None, fetch_list=None,
                  scope=None, return_numpy=True, stacked_feed=False,
                  return_handle=False):
        """Run ``steps`` steps of one key back to back: on the card, replays
        of its graph with no host synchronisation in between (the first
        calls of a new key warm up and capture, as in ``run``). Feeds are
        the same every step, or with ``stacked_feed=True`` every feed has a
        leading [steps, ...] axis and step i takes slice i (moved to the
        device once, sliced there). Fetches come back stacked over the
        steps axis. State chains from step to step exactly as across
        ``run`` calls, and step i draws the masks of the executor's next
        step index: the result equals ``steps`` calls of ``run``."""
        steps = int(steps)
        if steps < 1:
            raise ValueError('run_steps: steps must be >= 1, got %d' % steps)
        program, block, feeds, fetch_names, scope = self._prepare(
            program, feed, fetch_list, scope)
        if stacked_feed:
            for name, v in feeds.items():
                if v.dim() == 0 or v.shape[0] != steps:
                    raise ValueError(
                        'run_steps(stacked_feed=True): feed %r leading dim '
                        '%s != steps %d' % (name, tuple(v.shape)[:1] or
                                            '()', steps))
        # on the card, the feeds go to the device once: each step's slice is
        # then a device-to-device copy, never a host round trip
        with torch.no_grad():
            feeds = {n: v.to(self.device) for n, v in feeds.items()}
        step_feeds = [{n: v[i] for n, v in feeds.items()}
                      for i in range(steps)] if stacked_feed else \
            [feeds] * steps
        plan = self._plan(program, list(feeds), fetch_names)
        self._check_feeds(plan, feeds, 'Executor.run_steps')
        key = self._key(program, step_feeds[0], fetch_names)
        missed_any = False
        with self._lock:
            out = None
            for i, f in enumerate(step_feeds):
                fetches, missed, captured = self._dispatch(
                    program, block, plan, key, f, fetch_names, scope, True,
                    out=None if out is None else [o[i] for o in out])
                missed_any = missed_any or missed
                if out is None:
                    out = [torch.empty((steps,) + tuple(v.shape),
                                       dtype=v.dtype, device=v.device)
                           for v in fetches]
                    for o, v in zip(out, fetches):
                        o[0].copy_(v)
            if return_handle:
                out, event = self._copy_out(out)
        self._tls.last_cache_miss = missed_any
        self._tls.last_captured = captured
        if return_handle:
            return StepHandle(out, steps, missed_any, event)
        if return_numpy:
            return [tensor_to_numpy(v) for v in out]
        return out

    # ------------------------------------------------------------ dispatch
    @staticmethod
    def _check_feeds(plan, feeds, what):
        missing = [n for n in plan.needed_feeds if n not in feeds]
        if missing:
            raise ValueError('%s: missing feed for data vars %s'
                             % (what, missing))

    @staticmethod
    def _key(program, feeds, fetch_names):
        sig = tuple(sorted((n, tuple(v.shape), str(v.dtype))
                           for n, v in feeds.items()))
        return (id(program), program._version, program.amp, sig,
                tuple(fetch_names))

    def _copy_out(self, fetches):
        """A handle's fetches: on the card, pinned host copies enqueued
        behind the step (non-blocking) and an event recorded after them,
        so that resolving the handle waits for this step only, not for
        the steps dispatched after it (a blocking copy would wait for the
        whole stream); on the CPU the fetches as they are."""
        if self.device.type != 'cuda':
            return fetches, None
        host = []
        for v in fetches:
            h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            h.copy_(v, non_blocking=True)
            host.append(h)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return host, event

    def _step_tensor(self):
        if self._step is None:
            self._step = torch.zeros((), dtype=torch.int64,
                                     device=self.device)
        return self._step

    def _side_stream(self):
        if self._side is None:
            self._side = torch.cuda.Stream(device=self.device)
        return self._side

    def _dispatch(self, program, block, plan, key, feeds, fetch_names, scope,
                  use_cache, out=None):
        """One step. Returns (fetch tensors, missed, captured); with ``out``
        the fetches are copied into those tensors and they are returned."""
        state = self._keys.get(key) if use_cache else None
        missed = state is None
        if use_cache and state is None:
            state = self._keys[key] = _KeyState(
                any(op.type in HOST_BOUND for op in plan.ops))
        self._step_tensor()     # made here, outside any capture
        if not use_cache or state.host_bound or self.device.type != 'cuda':
            fetches = self._eager(program, block, plan, feeds, fetch_names,
                                  scope)
            return self._deliver(fetches, out, copy=False), missed, False
        if state.eager_runs < WARMUP_RUNS or \
                any(scope.find(n) is None for n in plan.scope_out):
            # warm-up, on the capture's side stream
            state.eager_runs += 1
            side = self._side_stream()
            main = torch.cuda.current_stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                fetches = self._eager(program, block, plan, feeds,
                                      fetch_names, scope)
            main.wait_stream(side)
            for t in fetches:
                t.record_stream(main)
            return self._deliver(fetches, out, copy=False), missed, False
        graph = state.graph
        if graph is None or not graph.valid(scope):
            state.graph = None      # the old graph's memory goes first
            graph = state.graph = self._capture(program, block, plan, feeds,
                                                fetch_names, scope)
            missed = True
        return self._replay(graph, feeds, out), missed, True

    @staticmethod
    def _deliver(fetches, out, copy):
        if out is None:
            return [v.clone() for v in fetches] if copy else fetches
        for o, v in zip(out, fetches):
            o.copy_(v)
        return out

    def _eager(self, program, block, plan, feeds, fetch_names, scope):
        with torch.no_grad():
            env = {n: v.to(self.device) for n, v in feeds.items()}
        return self._step_ops(program, block, plan, env, fetch_names, scope,
                              capturing=False)

    def _capture(self, program, block, plan, feeds, fetch_names, scope):
        """Capture one step of ``plan`` into a CUDA graph (nothing runs)."""
        g = _Graph()
        g.feeds = {n: torch.empty(v.shape, dtype=v.dtype, device=self.device)
                   for n, v in feeds.items()}
        g.staging = {}
        g.staged = None
        names = [n for n in list(plan.scope_in) + list(plan.scope_out)
                 if n not in g.feeds]
        g.scope_refs = [(n, scope.find(n)) for n in dict.fromkeys(names)]
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        counters = _counters()
        before = _read_counts()
        try:
            # thread_local: another thread's CUDA calls (a server's other
            # engines, a metrics reader) cannot invalidate this capture;
            # the autograd device thread's launches on the capture stream
            # are still recorded
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._side_stream(),
                                  capture_error_mode='thread_local'):
                env = dict(g.feeds)
                g.fetches = self._step_ops(program, block, plan, env,
                                           fetch_names, scope,
                                           capturing=True)
            g.deltas = [b - a for a, b in zip(before, _read_counts())]
        finally:
            # the capture recorded launches and ran none of them
            for (fn, attr), v in zip(counters, before):
                setattr(fn, attr, v)
        g.graph = graph
        self.captures += 1
        return g

    def _replay(self, g, feeds, out):
        with torch.no_grad():
            host = [n for n, v in feeds.items() if v.device.type == 'cpu']
            if host:
                # host feeds go through pinned buffers, copied in only once
                # the last replay's copies out of them have run
                if g.staged is not None:
                    g.staged.synchronize()
                for n in host:
                    buf = g.staging.get(n)
                    if buf is None:
                        buf = g.staging[n] = torch.empty(
                            feeds[n].shape, dtype=feeds[n].dtype,
                            pin_memory=True)
                    buf.copy_(feeds[n])
            for n, dst in g.feeds.items():
                dst.copy_(g.staging[n] if n in host else feeds[n],
                          non_blocking=True)
            if host:
                g.staged = torch.cuda.Event()
                g.staged.record(torch.cuda.current_stream(self.device))
            g.graph.replay()
            for (fn, attr), d in zip(_counters(), g.deltas):
                if d:
                    setattr(fn, attr, getattr(fn, attr) + d)
            return self._deliver(g.fetches, out, copy=True)

    # ---------------------------------------------------------------- step
    def _step_ops(self, program, block, plan, env, fetch_names, scope,
                  capturing):
        """Run the plan's ops over ``env`` (the feeds), write the scope's
        outputs in place and advance the step: the body of an eager run and
        of a capture. Returns the fetch tensors."""
        seed = program.random_seed if program.random_seed is not None else 0
        step = self._step_tensor()
        for name in plan.scope_in:
            if name in env:
                continue
            value = scope.find(name)
            if value is None:
                raise RuntimeError(
                    'Variable %r is not initialized in scope. Run the '
                    'startup program first.' % name)
            env[name] = value

        clips = plan.error_clips

        def run_ops(ops, start):
            for i, op in enumerate(ops):
                self._run_op(env, op, block, start + i, seed, step,
                             program.amp, plan.reads)
                if clips and torch.is_grad_enabled():
                    # the reference's error clip: the gradient flowing
                    # back through the var is clamped
                    for name in op.output_names():
                        if name in clips and name in env:
                            env[name] = error_clip_grad(env[name],
                                                        *clips[name])
                for name in plan.frees.get(start + i, ()):
                    env.pop(name, None)

        if plan.marker is None:
            with torch.no_grad():
                run_ops(plan.ops, 0)
        else:
            self._train_step(env, plan, run_ops)
        with torch.no_grad():
            for name in plan.scope_out:
                self._write_scope(scope, name, _detached(env[name]),
                                  capturing)
            step.add_(1)
        fetches = []
        for name in fetch_names:
            if name not in env:
                raise KeyError('fetch target %r was not produced' % name)
            fetches.append(_detached(env[name]))
        return fetches

    @staticmethod
    def _write_scope(scope, name, value, capturing):
        """The scope's tensor for ``name`` takes ``value`` in place (a
        lowering's new tensor is copied in); a var the scope does not hold
        yet, or holds at another shape or dtype, is set."""
        cur = scope.find(name)
        if isinstance(cur, torch.Tensor) and isinstance(value, torch.Tensor) \
                and cur.shape == value.shape and cur.dtype == value.dtype \
                and cur.device == value.device:
            if cur.data_ptr() != value.data_ptr():
                cur.copy_(value)
            return
        if capturing:
            raise RuntimeError(
                'Executor: persistable output %r changes its shape or dtype '
                'inside a captured step (scope holds %s, the step gives %s)'
                % (name, None if cur is None else
                   (tuple(cur.shape), cur.dtype),
                   (tuple(value.shape), value.dtype)))
        scope.set(name, value)

    def _run_op(self, env, op, block, index, seed, step, amp, reads):
        ctx = LoweringContext(env, op, block, index, self.device, seed,
                              step, is_test=bool(op.attrs.get('is_test',
                                                              False)),
                              amp=amp, reads=reads)
        try:
            get_lowering(op.type)(ctx)
        except KeyError as e:
            raise RuntimeError(
                'While running op %r: missing input %s. Feed it or run '
                'producers first.' % (op.type, e))
        if amp == 'bf16' and op.type in AMP_BF16_OUT_SLOTS:
            # fp32-statistics ops hand their activation back to the bf16
            # stream (registry.AMP_BF16_OUT_SLOTS)
            for slot in AMP_BF16_OUT_SLOTS[op.type]:
                name = op.output(slot)
                if name in env and env[name].dtype == torch.float32:
                    env[name] = env[name].to(torch.bfloat16)

    def _train_step(self, env, plan, run_ops):
        """Forward with the trainable parameters as leaves, gradients of
        the summed loss, then the update ops under no_grad."""
        marker = plan.ops[plan.marker]
        param_names = marker.attrs['param_names']
        grad_names = marker.attrs['grad_names']
        loss_name = marker.attrs['loss_name']
        stored = {n: env[n] for n in param_names}
        # the forward and the update are named for torch.profiler (one range
        # each a step): the device time by section reads them; the backward
        # runs on autograd's device thread, outside any range of this one
        with torch.enable_grad():
            leaves = []
            for n in param_names:
                env[n] = stored[n].detach().requires_grad_()
                leaves.append(env[n])
            with torch.profiler.record_function('forward'):
                run_ops(plan.ops[:plan.marker], 0)
            loss = env[loss_name]
            grads = [None] * len(leaves)
            if loss.requires_grad:
                grads = torch.autograd.grad(loss.sum(), leaves,
                                            allow_unused=True)
        # the forward's values that nothing after the marker reads go now,
        # with the autograd graph they held
        for n in plan.frees.get(plan.marker, ()):
            env.pop(n, None)
        env.update(stored)
        for pn, gn, g in zip(param_names, grad_names, grads):
            env[gn] = torch.zeros_like(stored[pn]) if g is None else g
        with torch.no_grad(), torch.profiler.record_function('optimizer'):
            run_ops(plan.ops[plan.marker + 1:], plan.marker + 1)
