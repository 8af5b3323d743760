"""Checkpointable reader state: mid-epoch resume (reference: paddle_tpu
reader/state.py).

Reference analog: go/master/service.go:165-213 — the data master
persists its task queue to etcd and recovers mid-epoch on failover, so
resumed training sees exactly the untrained remainder. Masterless
design: instead of storing a task queue, the wrapper makes
the epoch stream DETERMINISTIC (per-epoch shuffle seed chained from a
base seed) and records only (epoch, offset); resume replays the same
epoch order and skips the consumed prefix — recompute-over-store, the
same trade the executor makes with rematerialization.

Pairs with io.save_checkpoint(..., reader=...) / load_checkpoint(...,
reader=...). Under multihost positional sharding every process consumes
the same NUMBER of items per step, so the single-writer checkpoint's
(epoch, offset) applies to every host's shard reader.
"""

import random

__all__ = ['checkpointable', 'CheckpointableReader']


class CheckpointableReader(object):
    """Wrap a reader factory with resumable position state.

    reader: nullary callable yielding one epoch of items.
    shuffle_buf: optional buffered shuffle INSIDE the wrapper (use this
        instead of reader.shuffle — the global-RNG decorator is not
        replayable) with a per-epoch rng seeded (seed, epoch), so epoch
        k's order is identical on replay.
    seed: base seed for the per-epoch shuffle chain.

    Each __call__ yields the remainder of the current epoch (all of it
    when offset == 0) and advances (epoch, offset) as items are
    consumed; a generator abandoned mid-epoch leaves offset at the
    consumed count, which is exactly what state_dict() then captures.
    """

    def __init__(self, reader, shuffle_buf=0, seed=0):
        self._base = reader
        self._buf = int(shuffle_buf)
        self._seed = int(seed)
        self.epoch = 0
        self.offset = 0
        # Positional-shard width (parallel.multihost.shard_reader sets
        # this to the host count when it wraps us). The shard wrapper
        # sits OUTSIDE, so `offset` always counts GLOBAL stream items —
        # width items advance here per one per-host yield. The Trainer's
        # pending ledger counts PER-HOST yields; state_dict converts
        # with this width, which is what keeps a checkpointed position
        # valid when the run resumes at a different host count.
        self.shard_width = 1

    def _epoch_stream(self):
        if not self._buf:
            for e in self._base():
                yield e
            return
        rng = random.Random((self._seed * 1000003) ^ self.epoch)
        buf = []
        for e in self._base():
            buf.append(e)
            if len(buf) >= self._buf:
                rng.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            rng.shuffle(buf)
            for b in buf:
                yield b

    def __call__(self):
        skip = self.offset
        for i, e in enumerate(self._epoch_stream()):
            if i < skip:
                continue    # replayed prefix: already trained on
            self.offset = i + 1
            yield e
        self.epoch += 1
        self.offset = 0

    # ------------------------------------------------------------ state
    def state_dict(self, pending=0):
        """pending: items already PULLED from the stream but not yet
        trained on (the Trainer's partially-filled dispatch window) —
        subtracted from offset so resume replays them. Callers must not
        pass a pending that spans an epoch boundary (offset resets to 0
        there; the Trainer defers the save instead).

        pending is in PER-HOST yield units while offset is in GLOBAL
        stream units: under positional sharding one per-host yield
        advances the underlying stream by shard_width items, so pending
        is scaled before subtracting. The recorded offset is therefore
        topology-neutral — a resume at any other host count replays
        exactly the untrained global remainder. `hosts` records the
        writing width for tooling/postmortems."""
        width = max(1, int(self.shard_width))
        pending = int(pending) * width
        if pending < 0 or pending > self.offset:
            raise ValueError(
                'state_dict: pending=%d global items (pending x '
                'shard_width=%d) not in [0, offset=%d] — pulled-but-'
                'untrained items cannot span an epoch boundary'
                % (pending, width, self.offset))
        return {'epoch': int(self.epoch),
                'offset': int(self.offset) - pending,
                'seed': self._seed, 'shuffle_buf': self._buf,
                'hosts': width}

    def load_state_dict(self, state):
        if int(state.get('seed', self._seed)) != self._seed or \
                int(state.get('shuffle_buf', self._buf)) != self._buf:
            raise ValueError(
                'reader state was saved with seed=%s shuffle_buf=%s but '
                'this reader has seed=%s shuffle_buf=%s — the replayed '
                'epoch order would differ from the trained one'
                % (state.get('seed'), state.get('shuffle_buf'),
                   self._seed, self._buf))
        # offset is global-stream units — no remap needed across a
        # changed dp width (state['hosts'] is the WRITING width, kept
        # for inspection; this reader's own shard_width is whatever the
        # restoring topology set)
        self.epoch = int(state['epoch'])
        self.offset = int(state['offset'])


def checkpointable(reader, shuffle_buf=0, seed=0):
    """Decorator form: reader.checkpointable(r, shuffle_buf=1024)."""
    return CheckpointableReader(reader, shuffle_buf=shuffle_buf, seed=seed)
