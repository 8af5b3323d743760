"""Managed checkpoint tree: step dirs + LATEST pointer + retention GC
(reference: paddle_tpu fault/manager.py).

Layout under config.dirname:

    step_00000012/
        manifest.json       var dtypes/shapes
        params.npz          every persistable (params + optimizer state)
        checkpoint.json     written LAST; records both files' sha1 plus
                            step / reader / trainer state
    step_00000024/ ...
    LATEST                  name of the newest committed step dir,
                            written atomically AFTER the dir completes

A checkpoint is COMPLETE iff checkpoint.json exists and both recorded
sha1s verify (io.verify_checkpoint). LATEST is an optimization, not the
source of truth: restore() tries the pointer first, then scans step
dirs newest-first, skipping torn/corrupt candidates — so a write torn
by preemption (or bit-rot that survives the atomic rename) falls back
to the previous complete checkpoint instead of failing the job.
"""

import os
import re
import shutil
import threading
import warnings

from .. import io as _io
from . import inject

__all__ = ['CheckpointManager', 'NoUsableCheckpointError', 'LATEST_FILE',
           'STEP_DIR_FMT']

LATEST_FILE = 'LATEST'
STEP_DIR_FMT = 'step_%08d'
_STEP_RE = re.compile(r'^step_(\d{8,})$')


class NoUsableCheckpointError(RuntimeError):
    """restore() found checkpoint candidates but every one was torn,
    corrupt, or recorded on another topology (keep-last-K
    exhaustion). Distinct from an EMPTY tree, which restores nothing
    and returns None — exhaustion means training state EXISTED and was
    lost, so silently starting from scratch would be data loss."""


class CheckpointManager(object):
    def __init__(self, config):
        self.config = config
        self.dirname = config.dirname
        self._pending = None
        self._errbox = []
        self._gc_lock = threading.Lock()

    # ----------------------------------------------------------- paths
    def step_dir(self, step):
        return os.path.join(self.dirname, STEP_DIR_FMT % int(step))

    def _scan(self):
        """[(step, path)] of step dirs, newest first."""
        try:
            names = os.listdir(self.dirname)
        except OSError:
            return []
        out = []
        for n in names:
            m = _STEP_RE.match(n)
            if m:
                out.append((int(m.group(1)), os.path.join(self.dirname, n)))
        out.sort(reverse=True)
        return out

    def latest_pointer(self):
        """(step, path) named by LATEST, or None."""
        try:
            with open(os.path.join(self.dirname, LATEST_FILE)) as f:
                name = f.read().strip()
        except OSError:
            return None
        m = _STEP_RE.match(name)
        if not m:
            return None
        path = os.path.join(self.dirname, name)
        return (int(m.group(1)), path) if os.path.isdir(path) else None

    def _candidates(self):
        # newest-first SCAN, not the pointer: a crash between the
        # checkpoint.json rename and the LATEST write leaves a complete
        # checkpoint the pointer doesn't name yet — verification (not
        # LATEST) is the source of truth for completeness
        return self._scan()

    # ------------------------------------------------------------ save
    def save(self, executor, main_program, step, reader=None,
             trainer_state=None, reader_pending=0):
        """Checkpoint at `step`. With config.async_save the disk write
        AND the commit (LATEST + GC) run on a background thread; call
        wait() for the completeness point. Saves are serialized: a new
        save first joins the previous commit, so GC never races an
        in-flight write."""
        self.wait()
        d = self.step_dir(step)
        handle = _io.save_checkpoint(
            executor, d, main_program=main_program, step=step,
            reader=reader, trainer_state=trainer_state,
            reader_pending=reader_pending,
            async_save=self.config.async_save)
        if handle is None or handle.done():
            if handle is not None:
                handle.result()
            self._commit(step, d)
            return

        def _finalize():
            try:
                handle.result()
                self._commit(step, d)
            except BaseException as e:
                self._errbox.append(e)
        t = threading.Thread(target=_finalize, daemon=True,
                             name='paddle_tpu_torch_ckpt_commit')
        t.start()
        self._pending = t

    def wait(self, timeout=None):
        """Join the in-flight async commit; re-raise its error if any."""
        t = self._pending
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError('checkpoint commit still in progress')
            self._pending = None
        if self._errbox:
            raise self._errbox.pop(0)

    def _commit(self, step, d):
        _io._write_atomic(
            os.path.join(self.dirname, LATEST_FILE),
            lambda f: f.write(os.path.basename(d).encode()))
        self._gc()
        # fires AFTER the pointer lands so injected corruption exercises
        # the worst case: LATEST names a checkpoint whose sha1s no
        # longer verify, and restore must fall back by scanning
        inject.fire('checkpoint_saved', step=step, dirname=d)

    def _gc(self):
        with self._gc_lock:
            for _, path in self._scan()[self.config.keep_last:]:
                shutil.rmtree(path, ignore_errors=True)

    # --------------------------------------------------------- restore
    def find_latest(self):
        """(step, path, meta) of the newest COMPLETE checkpoint, or
        None. Torn/corrupt candidates are warned about and skipped."""
        for step, path in self._candidates():
            try:
                return step, path, _io.verify_checkpoint(path)
            except ValueError as e:
                warnings.warn('CheckpointManager: skipping %r (%s)'
                              % (path, e))
        return None

    def restore(self, executor, main_program=None, reader=None):
        """Restore from the newest complete checkpoint; on a load failure
        (corruption the sha1 pass could not see, another topology) fall
        back to the next older one. Returns the checkpoint meta dict
        (step / reader / trainer keys), None when the tree holds no
        checkpoint at all, or raises NoUsableCheckpointError when
        candidates existed but none was usable (keep-last-K
        exhaustion)."""
        failures = []
        for step, path in self._candidates():
            try:
                meta = _io.verify_checkpoint(path)
                _io.load_checkpoint(
                    executor, path, main_program,
                    reader=reader if (reader is not None and
                                      meta.get('reader')) else None)
                return meta
            except Exception as e:
                failures.append('%s: %s: %s'
                                % (os.path.basename(path),
                                   type(e).__name__, e))
                warnings.warn('CheckpointManager: checkpoint %r unusable '
                              '(%s: %s); falling back to the previous one'
                              % (path, type(e).__name__, e))
        if failures:
            raise NoUsableCheckpointError(
                'CheckpointManager: %d checkpoint candidate(s) under %r '
                'and NONE is usable — keep-last-%d retention is '
                'exhausted:\n  %s\nTraining state existed here; starting '
                'from scratch silently would be data loss. Repair or '
                'remove the tree (or raise keep_last) and rerun.'
                % (len(failures), self.dirname, self.config.keep_last,
                   '\n  '.join(failures)))
        return None
