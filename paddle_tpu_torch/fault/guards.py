"""Bad-step guards: a NaN/Inf sentinel on the fetched loss (reference:
paddle_tpu fault/guards.py).

A poisoned batch or a numerical blowup shows as a non-finite loss, and by
the time it is fetched the same step has applied its (equally
non-finite) update. Recovery therefore undoes state:

- 'raise': a BadStepError at once (the default).
- 'skip_step': restore the host snapshot taken before the dispatch, so
  the bad batch was never trained on.
- 'rollback': reload parameters and optimizer state from the newest
  complete checkpoint (the data stream goes on past the bad batch).

Every policy escalates to 'raise' after max_bad_steps consecutive bad
steps. Under ``Trainer.train(pipeline_depth=D)`` 'skip_step' snapshots
once a drain group and undoes the whole group (up to D steps), and the
trainer drains every in-flight dispatch before a restore.

Restores write into the scope's own tensors (io._restore_into), so the
executor's captured graphs stay valid and replay after an undo.
"""

import numpy as np

__all__ = ['NAN_POLICIES', 'BadStepError', 'BadStepGuard', 'is_bad']

NAN_POLICIES = ('raise', 'skip_step', 'rollback')


class BadStepError(RuntimeError):
    """Non-finite loss the configured policy could not absorb."""

    def __init__(self, message, step=None, loss=None):
        super(BadStepError, self).__init__(message)
        self.step = step
        self.loss = loss


def is_bad(value):
    """True when a fetched metric contains NaN or +/-Inf."""
    arr = np.asarray(value)
    if arr.dtype.kind not in 'fc':
        return False
    return not bool(np.all(np.isfinite(arr)))


class BadStepGuard(object):
    """Trainer-side policy engine. Call snapshot() before a dispatch
    (only needed when needs_snapshot), handle() on its fetched loss
    after; handle returns 'ok' | 'skipped' | 'rolled_back' or raises."""

    def __init__(self, policy, max_bad_steps=8, manager=None,
                 executor=None, program=None):
        if policy not in NAN_POLICIES:
            raise ValueError('nan_policy must be one of %s, got %r'
                             % (NAN_POLICIES, policy))
        self.policy = policy
        self.max_bad_steps = int(max_bad_steps)
        self._manager = manager
        self._executor = executor
        self._program = program
        self._consecutive = 0
        self._snap = None

    @property
    def needs_snapshot(self):
        return self.policy == 'skip_step'

    def snapshot(self):
        from .. import io as _io
        self._snap = _io._snapshot_vars(self._program,
                                        predicate=_io._is_persistable)

    def _restore_snapshot(self):
        from .. import io as _io
        from ..core.dtypes import to_torch_dtype
        from ..core.scope import global_scope
        arrays, manifest = self._snap
        scope = global_scope()
        block = self._program.global_block()
        device = self._executor.device
        for name, arr in arrays.items():
            _io._restore_into(
                scope, name, _io._from_numpy(arr, manifest[name]['dtype']),
                device, to_torch_dtype(block.var(name).dtype))

    def handle(self, loss, step, steps=1):
        """``steps``: how many training steps this verdict covers (1, a
        run_steps window, or a pipelined skip_step drain group)."""
        if not is_bad(loss):
            self._consecutive = 0
            return 'ok'
        self._consecutive += 1
        head = ('non-finite loss at global step %d (%r)'
                % (step, np.asarray(loss).ravel()[:4].tolist()))
        if steps > 1:
            head += ' [undo unit: %d steps]' % int(steps)
        if self.policy == 'raise':
            raise BadStepError(head + " — nan_policy='raise'",
                               step=step, loss=loss)
        if self._consecutive > self.max_bad_steps:
            raise BadStepError(
                head + ' — %d consecutive bad steps exceed max_bad_steps='
                '%d; the model state itself is likely poisoned'
                % (self._consecutive, self.max_bad_steps),
                step=step, loss=loss)
        if self.policy == 'skip_step':
            if self._snap is None:
                raise BadStepError(
                    head + " — nan_policy='skip_step' but no pre-step "
                    'snapshot was taken', step=step, loss=loss)
            self._restore_snapshot()
            return 'skipped'
        # rollback
        meta = None
        if self._manager is not None:
            from .manager import NoUsableCheckpointError
            try:
                meta = self._manager.restore(self._executor, self._program)
            except NoUsableCheckpointError:
                meta = None
        if meta is None:
            raise BadStepError(
                head + " — nan_policy='rollback' but no complete "
                'checkpoint exists to roll back to', step=step, loss=loss)
        return 'rolled_back'
