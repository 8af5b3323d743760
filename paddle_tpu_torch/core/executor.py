"""Executor: runs a Program's ops eagerly through the torch lowerings.

Reference: paddle/fluid/framework/executor.{h,cc} + python/fluid/executor.py.
The ops that contribute to the fetches or write persistable state are
kept (the same pruning as the JAX package's executor), feeds become
tensors on the place's device, each op's lowering runs in order, and
persistable outputs are written back to the scope. Lowerings may update
scope tensors in place (the decode ops write their KV rows into the
arenas, the optimizer ops their parameters and moments).

A program with a ``backward_marker`` (optimizer.minimize) is a training
step: the ops before the marker run with the trainable parameters as leaf
tensors, ``torch.autograd.grad`` of the summed loss gives every ``p@GRAD``
(zero where the loss does not reach a parameter, as jax.value_and_grad
gives), and the ops after it run under ``torch.no_grad()`` once the
gradients exist, so no tensor saved for the backward aliases a parameter
being updated. Everything else runs under ``torch.no_grad()``.
"""

import threading

import numpy as np
import torch

from .dtypes import to_torch_dtype
from .place import CUDAPlace
from .program import Variable, default_main_program
from .registry import AMP_BF16_OUT_SLOTS, LoweringContext, get_lowering
from .scope import global_scope, tensor_to_numpy


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


class _Plan(object):
    """What one (program, feeds, fetches) runs: the kept ops, the
    feeds they need, the scope's inputs and outputs, the backward
    marker's index (None for no training section), the names any kept op
    reads or the caller fetches, and the names the ops after the marker
    read."""

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
        self.reads = consumed | set(fetch_names)
        self.after_reads = set(fetch_names) | set(self.scope_out)
        if self.marker is not None:
            for op in ops[self.marker + 1:]:
                self.after_reads.update(op.input_names())


class Executor(object):
    """``Executor(place)``; with no place it runs on ``CUDAPlace(0)`` and
    raises when there is no CUDA device."""

    def __init__(self, place=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.device()
        self._plans = {}
        # runs so far: keys each step's dropout masks
        self._step = 0
        # one dispatch at a time: lowerings update scope tensors in place
        self._lock = threading.Lock()

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

    def _feed_tensor(self, block, name, value):
        var = block._find_var_recursive(name)
        dtype = to_torch_dtype(var.dtype) if var is not None else None
        t = value if isinstance(value, torch.Tensor) else \
            torch.as_tensor(np.ascontiguousarray(value))
        if dtype is not None and t.dtype != dtype:
            t = t.to(dtype)
        return t.to(self.device)

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        _ensure_ops_imported()
        program = program if program is not None else default_main_program()
        feed = feed or {}
        fetch_list = fetch_list or []
        scope = scope if scope is not None else global_scope()
        block = program.global_block()
        fetch_names = [f.name if isinstance(f, Variable) else f
                       for f in fetch_list]

        plan = self._plan(program, list(feed), fetch_names)
        missing = [n for n in plan.needed_feeds if n not in feed]
        if missing:
            raise ValueError('Executor.run: missing feed for data vars %s'
                             % missing)
        seed = program.random_seed if program.random_seed is not None else 0

        with self._lock:
            step = self._step
            self._step += 1
            with torch.no_grad():
                env = {n: self._feed_tensor(block, n, v)
                       for n, v in feed.items()}
            for name in plan.scope_in:
                if name in env:
                    continue
                value = scope.find(name)
                if value is None:
                    raise RuntimeError(
                        'Variable %r is not initialized in scope. Run the '
                        'startup program first.' % name)
                env[name] = value

            def run_ops(ops, start):
                for i, op in enumerate(ops):
                    self._run_op(env, op, block, start + i, seed, step,
                                 program.amp, plan.reads)

            if plan.marker is None:
                with torch.no_grad():
                    run_ops(plan.ops, 0)
            else:
                self._train_step(env, plan, run_ops)
            for name in plan.scope_out:
                scope.set(name, _detached(env[name]))
            fetches = []
            for name in fetch_names:
                if name not in env:
                    raise KeyError('fetch target %r was not produced' % name)
                fetches.append(_detached(env[name]))
        if return_numpy:
            return [tensor_to_numpy(v) for v in fetches]
        return fetches

    def run_steps(self, steps, program=None, feed=None, fetch_list=None,
                  scope=None, **kwargs):
        """The JAX package fuses several steps into one dispatch; the
        port runs its steps eagerly, so call ``run`` in a loop."""
        raise NotImplementedError('Executor.run_steps is not ported to '
                                  'paddle_tpu_torch: call run() per step')

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
        for n in list(env):
            if n not in plan.after_reads:
                del env[n]
        env.update(stored)
        for pn, gn, g in zip(param_names, grad_names, grads):
            env[gn] = torch.zeros_like(stored[pn]) if g is None else g
        with torch.no_grad(), torch.profiler.record_function('optimizer'):
            run_ops(plan.ops[plan.marker + 1:], plan.marker + 1)
