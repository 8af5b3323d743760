"""Fault tolerance: preemption-tolerant training (reference: paddle_tpu
fault/).

Three local pieces wired through the Trainer:

- periodic mid-epoch checkpoints with keep-last-K retention and an
  atomically written LATEST pointer (``manager.CheckpointManager``),
- auto-resume from the newest COMPLETE checkpoint, sha1-verified and
  falling back to the previous one past a torn write
  (``CheckpointConfig(dirname, resume=True)``),
- bad-step guards: a NaN/Inf sentinel on the fetched loss with a
  configurable policy (``guards.BadStepGuard``), and ``reader.retry``
  for transient input errors.

``inject`` is the deterministic fault-injection harness that proves them
end to end: kill or SIGTERM at step k, truncate a checkpoint after it
commits, poison batch k with NaNs, make a reader raise transiently.
"""

from .config import CheckpointConfig  # noqa: F401
from .manager import (CheckpointManager, LATEST_FILE,  # noqa: F401
                      NoUsableCheckpointError)
from .guards import BadStepError, BadStepGuard, NAN_POLICIES, is_bad  # noqa
from . import inject  # noqa: F401

__all__ = ['CheckpointConfig', 'CheckpointManager', 'LATEST_FILE',
           'NoUsableCheckpointError', 'BadStepError', 'BadStepGuard',
           'NAN_POLICIES', 'is_bad', 'inject']
