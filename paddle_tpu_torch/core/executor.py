"""Executor: runs a Program's ops eagerly through the torch lowerings.

Reference: paddle/fluid/framework/executor.{h,cc} + python/fluid/executor.py.
Inference only: the ops that contribute to the fetches or write
persistable state are kept (the same pruning as the JAX package's
executor), feeds become tensors on the place's device, each op's lowering
runs in order under ``torch.no_grad()``, and persistable outputs are
written back to the scope. Lowerings may update scope tensors in place
(the decode ops write their KV rows into the arenas that way).
"""

import threading

import numpy as np
import torch

from .dtypes import to_torch_dtype
from .place import CUDAPlace
from .program import Variable, default_main_program
from .registry import LoweringContext, get_lowering
from .scope import global_scope, tensor_to_numpy


def _ensure_ops_imported():
    from .. import ops as _ops  # noqa: F401  (registers lowerings)


def _analyze(block, ops, feed_names):
    """Scope inputs (values read before any op defines them) and scope
    outputs (persistable vars written)."""
    defined = set(feed_names)
    scope_in, scope_out = [], []
    for op in ops:
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
        if writes_state or (set(op.output_names()) & needed):
            kept.append(op)
            needed.update(op.input_names())
    kept.reverse()
    return kept


class Executor(object):
    """``Executor(place)``; with no place it runs on ``CUDAPlace(0)`` and
    raises when there is no CUDA device."""

    def __init__(self, place=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.device()
        self._plans = {}
        # one dispatch at a time: lowerings update scope tensors in place
        self._lock = threading.Lock()

    def _plan(self, program, feed_names, fetch_names):
        key = (id(program), program._version, tuple(sorted(feed_names)),
               tuple(fetch_names))
        plan = self._plans.get(key)
        if plan is None:
            block = program.global_block()
            ops = _prune_ops(block, list(block.ops), fetch_names)
            consumed = set()
            for op in ops:
                consumed.update(op.input_names())
            needed_feeds = sorted(
                n for n in consumed
                if (lambda v: v is not None and v.is_data)(
                    block._find_var_recursive(n)))
            scope_in, scope_out = _analyze(block, ops, feed_names)
            plan = (ops, needed_feeds, scope_in, scope_out)
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

        ops, needed_feeds, scope_in, scope_out = self._plan(
            program, list(feed), fetch_names)
        missing = [n for n in needed_feeds if n not in feed]
        if missing:
            raise ValueError('Executor.run: missing feed for data vars %s'
                             % missing)
        seed = program.random_seed if program.random_seed is not None else 0

        with self._lock, torch.no_grad():
            env = {n: self._feed_tensor(block, n, v) for n, v in feed.items()}
            for name in scope_in:
                if name in env:
                    continue
                value = scope.find(name)
                if value is None:
                    raise RuntimeError(
                        'Variable %r is not initialized in scope. Run the '
                        'startup program first.' % name)
                env[name] = value
            for i, op in enumerate(ops):
                ctx = LoweringContext(env, op, block, i, self.device, seed)
                try:
                    get_lowering(op.type)(ctx)
                except KeyError as e:
                    raise RuntimeError(
                        'While running op %r: missing input %s. Feed it or '
                        'run producers first.' % (op.type, e))
            for name in scope_out:
                scope.set(name, env[name])
            fetches = []
            for name in fetch_names:
                if name not in env:
                    raise KeyError('fetch target %r was not produced' % name)
                fetches.append(env[name])
        if return_numpy:
            return [tensor_to_numpy(v) for v in fetches]
        return fetches
