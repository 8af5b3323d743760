"""Deterministic fault injection (reference: paddle_tpu fault/inject.py):
the harness that proves the fault-tolerance layer instead of trusting it.

Each fault is deterministic (a fixed step index, no randomness):

- kill the process once the global step reaches k (os._exit: the abrupt
  end of a preemption's grace window),
- truncate a checkpoint file right after it commits (a write torn by
  preemption, or a partial copy that survived the atomic rename),
- poison batch k's float arrays with NaNs (corrupt input),
- make a reader raise transiently (flaky storage).

Hook points: the Trainer calls fire('step_end', step=...) after each
step, the CheckpointManager fire('checkpoint_saved', ...) after each
commit. Both are no-ops without an installed plan.

Environment contract (for subprocess crash/resume drills; the resumed
run must not set these again or it dies at the same step):

    PADDLE_TPU_FI_KILL_AT_STEP=k     os._exit(42) at global step >= k
    PADDLE_TPU_FI_CORRUPT_CKPT_AT=k  truncate params.npz of the
                                     checkpoint committed at step k

The SIGTERM preemption and the serving fleet's chaos actions
(kill_replica, crash_loop, kill_process) are not ported (ROADMAP Queue 1
items 10 and 11).
"""

import os

__all__ = ['KILL_EXIT_CODE', 'FaultPlan', 'TransientReaderError',
           'install', 'install_from_env', 'clear', 'active', 'fire',
           'truncate_file', 'poison_nans', 'flaky']

KILL_EXIT_CODE = 42
_ENV_KILL = 'PADDLE_TPU_FI_KILL_AT_STEP'
_ENV_CORRUPT = 'PADDLE_TPU_FI_CORRUPT_CKPT_AT'


class TransientReaderError(IOError):
    """Injected transient input failure (reader.retry's target class)."""


class FaultPlan(object):
    def __init__(self, kill_at_step=None, corrupt_checkpoint_at_step=None):
        self.kill_at_step = kill_at_step
        self.corrupt_checkpoint_at_step = corrupt_checkpoint_at_step


_active = None


def install(plan):
    global _active
    _active = plan


def clear():
    global _active
    _active = None


def active():
    return _active


def install_from_env(environ=None):
    """Install a plan from the PADDLE_TPU_FI_* vars. No-op when none are
    set or when a plan was already installed programmatically."""
    env = os.environ if environ is None else environ
    if _active is not None:
        return _active
    kill = env.get(_ENV_KILL)
    corrupt = env.get(_ENV_CORRUPT)
    if kill is None and corrupt is None:
        return None
    plan = FaultPlan(
        kill_at_step=int(kill) if kill else None,
        corrupt_checkpoint_at_step=int(corrupt) if corrupt else None)
    install(plan)
    return plan


def fire(point, step=None, dirname=None):
    plan = _active
    if plan is None:
        return
    if (point == 'step_end' and plan.kill_at_step is not None
            and step is not None and step >= plan.kill_at_step):
        # os._exit: no atexit, no flushes, no thread joins — the closest
        # in-process stand-in for a preempted VM. >= (not ==) so a
        # windowed dispatch that jumps past k still dies.
        os._exit(KILL_EXIT_CODE)
    if (point == 'checkpoint_saved'
            and plan.corrupt_checkpoint_at_step is not None
            and step == plan.corrupt_checkpoint_at_step and dirname):
        truncate_file(os.path.join(dirname, 'params.npz'))


def truncate_file(path, keep_fraction=0.5):
    """Cut a file to a prefix of itself — the on-disk shape of a write
    torn mid-stream."""
    size = os.path.getsize(path)
    with open(path, 'r+b') as f:
        f.truncate(int(size * keep_fraction))


def poison_nans(reader, at_step):
    """Wrap a reader: the item at stream index at_step has every float
    array replaced with NaNs (dict / tuple / list items supported)."""
    import numpy as np

    def _poison_val(v):
        arr = np.asarray(v)
        if arr.dtype.kind == 'f':
            return np.full_like(arr, np.nan)
        return v

    def _poison(item):
        if isinstance(item, dict):
            return {k: _poison_val(v) for k, v in item.items()}
        if isinstance(item, (list, tuple)):
            return type(item)(_poison_val(v) for v in item)
        return _poison_val(item)

    def wrapper():
        for i, item in enumerate(reader()):
            yield _poison(item) if i == at_step else item
    return wrapper


def flaky(reader, fail_times, fail_after=0, exc=TransientReaderError):
    """Wrap a reader factory: the first fail_times iterations raise exc
    after yielding fail_after items; later passes run clean. State is
    exposed as wrapper.state ({'fails', 'calls'}) for assertions."""
    state = {'fails': 0, 'calls': 0}

    def wrapper():
        state['calls'] += 1
        if state['fails'] < fail_times:
            state['fails'] += 1
            n = 0
            for item in reader():
                if n >= fail_after:
                    raise exc('injected transient failure %d/%d'
                              % (state['fails'], fail_times))
                yield item
                n += 1
            raise exc('injected transient failure %d/%d (at stream end)'
                      % (state['fails'], fail_times))
        for item in reader():
            yield item
    wrapper.state = state
    return wrapper
