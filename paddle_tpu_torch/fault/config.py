"""Checkpoint/resume policy for the Trainer (reference: paddle_tpu
fault/config.py; see fault/__init__.py)."""

from .guards import NAN_POLICIES

__all__ = ['CheckpointConfig']


class CheckpointConfig(object):
    """Declarative fault-tolerance policy, passed as
    ``Trainer(..., checkpoint_config=CheckpointConfig(dirname, ...))``.

    dirname: root of the managed checkpoint tree — one ``step_XXXXXXXX/``
        directory per checkpoint plus a ``LATEST`` pointer file.
    save_every_steps: mid-epoch save cadence in global steps (None
        disables the step trigger).
    save_every_secs: mid-epoch save cadence in wall seconds (None
        disables the time trigger). Either trigger firing saves.
    keep_last: retention — GC deletes all but the newest K step dirs
        after each commit.
    resume: at train() start, restore params/optimizer state/global
        step/epoch/reader position from the newest COMPLETE checkpoint
        (sha1-verified; falls back to older ones on corruption) and
        continue mid-epoch. A no-op when the tree is empty; raises
        NoUsableCheckpointError when checkpoints exist but every one is
        torn/incompatible (keep-last exhaustion is surfaced, never
        silently retrained from scratch). A checkpoint recorded on
        another topology is unusable in the port (io.load_checkpoint).
    async_save: device-to-host snapshot synchronously, serialize and
        write on a background thread (io.save_checkpoint's async path).
    epoch_end: also checkpoint at every epoch boundary (the legacy
        Trainer cadence).
    nan_policy: None (off) | 'raise' | 'skip_step' | 'rollback' — what
        to do when the fetched loss goes NaN/Inf (guards.BadStepGuard).
    max_bad_steps: consecutive bad steps tolerated by the skip/rollback
        policies before escalating to BadStepError.
    """

    def __init__(self, dirname, save_every_steps=None, save_every_secs=None,
                 keep_last=3, resume=False, async_save=True, epoch_end=True,
                 nan_policy='raise', max_bad_steps=8):
        if not dirname:
            raise ValueError('CheckpointConfig: dirname is required')
        if int(keep_last) < 1:
            raise ValueError('CheckpointConfig: keep_last must be >= 1, '
                             'got %r' % (keep_last,))
        if save_every_steps is not None and int(save_every_steps) < 1:
            raise ValueError('CheckpointConfig: save_every_steps must be '
                             '>= 1, got %r' % (save_every_steps,))
        if nan_policy is not None and nan_policy not in NAN_POLICIES:
            raise ValueError('CheckpointConfig: nan_policy must be None or '
                             'one of %s, got %r' % (NAN_POLICIES, nan_policy))
        self.dirname = str(dirname)
        self.save_every_steps = (None if save_every_steps is None
                                 else int(save_every_steps))
        self.save_every_secs = (None if save_every_secs is None
                                else float(save_every_secs))
        self.keep_last = int(keep_last)
        self.resume = bool(resume)
        self.async_save = bool(async_save)
        self.epoch_end = bool(epoch_end)
        self.nan_policy = nan_policy
        self.max_bad_steps = int(max_bad_steps)
