"""Scope: runtime variable store (reference: paddle/fluid/framework/scope.{h,cc}).

Holds name -> torch tensor. Persistable program variables (parameters,
the KV arenas) live here between Executor.run calls, on the executor's
device; only fetched values are copied to the host.
"""

import contextlib
import threading

import torch


def tensor_to_numpy(value):
    """Host numpy copy of a tensor; bfloat16 (which numpy lacks) widens to
    float32. Always a copy: the optimizer ops update scope tensors in
    place, and an array sharing a CPU tensor's memory would change with
    them."""
    if not isinstance(value, torch.Tensor):
        import numpy as np
        return np.asarray(value)
    value = value.detach()
    if value.dtype == torch.bfloat16:
        value = value.float()
    elif value.device.type == 'cpu':
        value = value.clone()
    return value.cpu().numpy()


class Scope(object):
    def __init__(self, parent=None):
        self._vars = {}
        self._parent = parent

    def var(self, name):
        """Get-or-create slot for name (mirrors Scope::Var)."""
        if name not in self._vars and (self._parent is None or
                                       self._parent.find(name) is None):
            self._vars[name] = None
        return name

    def find(self, name):
        if name in self._vars:
            return self._vars[name]
        if self._parent is not None:
            return self._parent.find(name)
        return None

    def has(self, name):
        return name in self._vars or (self._parent is not None and
                                      self._parent.has(name))

    def set(self, name, value):
        self._vars[name] = value

    def get(self, name):
        value = self.find(name)
        if value is None:
            raise KeyError('Variable %r has no value in scope (did you run '
                           'the startup program?)' % name)
        return value

    def erase(self, name):
        self._vars.pop(name, None)

    def new_scope(self):
        return Scope(parent=self)

    def keys(self):
        return list(self._vars.keys())

    def numpy(self, name):
        return tensor_to_numpy(self.get(name))

    def clear(self):
        self._vars.clear()


_global_scope = Scope()

# scope_guard overrides are per thread: a serving worker thread and a
# client thread must not see each other's guarded scopes.
_tls = threading.local()


def global_scope():
    stack = getattr(_tls, 'scope_stack', None)
    if stack:
        return stack[-1]
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    stack = getattr(_tls, 'scope_stack', None)
    if stack is None:
        stack = _tls.scope_stack = []
    stack.append(scope)
    try:
        yield
    finally:
        stack.pop()
