"""Reader decorators (reference: paddle_tpu reader/decorator.py;
python/paddle/v2/reader/decorator.py)."""

import itertools
import random
from queue import Queue
from threading import Thread

import numpy as np
import torch

__all__ = ['map_readers', 'buffered', 'compose', 'chain', 'shuffle',
           'prefetch_to_device',
           'firstn', 'xmap_readers', 'cache', 'batch', 'shard', 'retry']


def map_readers(func, *readers):
    def reader():
        rs = [r() for r in readers]
        for items in zip(*rs):
            yield func(*items)
    return reader


def shuffle(reader, buf_size):
    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b
    return data_reader


def chain(*readers):
    def reader():
        for r in readers:
            for e in r():
                yield e
    return reader


def compose(*readers, **kwargs):
    check_alignment = kwargs.pop('check_alignment', True)

    def make_tuple(x):
        if isinstance(x, tuple):
            return x
        return (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum(list(map(make_tuple, outputs)), ())
        else:
            for outputs in itertools.zip_longest(*rs):
                for o in outputs:
                    if o is None:
                        raise RuntimeError('readers have different lengths')
                yield sum(list(map(make_tuple, outputs)), ())
    return reader


def buffered(reader, size):
    class EndSignal(object):
        pass
    end = EndSignal()

    def data_reader():
        from queue import Full
        from threading import Event
        r = reader()
        q = Queue(maxsize=size)
        closed = Event()

        def put(item):
            # close-aware put: a consumer that stopped pulling
            # (break / GeneratorExit) leaves the queue full forever —
            # a bare q.put would pin this thread for the process
            # lifetime, one leaked thread per abandoned epoch
            while not closed.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except Full:
                    pass
            return False

        def read_worker():
            for d in r:
                if not put(d):
                    return
            put(end)

        t = Thread(target=read_worker,
                   name='paddle_tpu_buffered_reader')
        t.daemon = True
        t.start()
        try:
            e = q.get()
            while e is not end:
                yield e
                e = q.get()
        finally:
            closed.set()
    return data_reader


def firstn(reader, n):
    def data_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item
    return data_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over a reader with worker threads."""
    end = object()

    def data_reader():
        in_q = Queue(buffer_size)
        out_q = Queue(buffer_size)

        def feed():
            for i, sample in enumerate(reader()):
                in_q.put((i, sample))
            for _ in range(process_num):
                in_q.put(end)

        def work():
            while True:
                item = in_q.get()
                if item is end:
                    out_q.put(end)
                    break
                i, sample = item
                out_q.put((i, mapper(sample)))

        feeder = Thread(target=feed)
        feeder.daemon = True
        feeder.start()
        workers = []
        for _ in range(process_num):
            w = Thread(target=work)
            w.daemon = True
            w.start()
            workers.append(w)

        finished = 0
        pending = {}
        next_idx = 0
        while finished < process_num:
            item = out_q.get()
            if item is end:
                finished += 1
                continue
            if not order:
                yield item[1]
            else:
                pending[item[0]] = item[1]
                while next_idx in pending:
                    yield pending.pop(next_idx)
                    next_idx += 1
        for idx in sorted(pending):
            yield pending[idx]
    return data_reader


def cache(reader):
    all_data = []

    def data_reader():
        if not all_data:
            all_data.extend(reader())
        for d in all_data:
            yield d
    return data_reader


def batch(reader, batch_size, drop_last=True):
    """Group examples into lists of batch_size (reference: paddle.batch).
    drop_last defaults True: a fixed batch shape keeps one executor key
    (one captured graph) for every batch."""
    def batch_reader():
        b = []
        for item in reader():
            b.append(item)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return batch_reader


def retry(reader, tries=3, backoff=0.1, exceptions=(OSError,)):
    """Transient-input-error tolerance: when the underlying reader raises
    one of `exceptions`, the stream is rebuilt and the already-yielded
    prefix is SKIPPED on replay (readers here are deterministic — the
    same contract CheckpointableReader's mid-epoch resume leans on), so
    consumers see each item at most once, in order.

    `tries` counts consecutive failed attempts: the tries-th consecutive
    failure re-raises; any successfully yielded item resets the counter.
    `backoff` seconds before each retry, doubling per consecutive
    failure (0 disables sleeping).
    """
    import time
    if tries < 1:
        raise ValueError('retry: tries must be >= 1, got %r' % (tries,))

    def data_reader():
        yielded = 0
        failures = 0
        while True:
            try:
                for i, item in enumerate(reader()):
                    if i < yielded:
                        continue    # replayed prefix: already delivered
                    yield item
                    yielded += 1
                    failures = 0
                return
            except exceptions:
                failures += 1
                if failures >= tries:
                    raise
                if backoff:
                    time.sleep(backoff * (2 ** (failures - 1)))
    return data_reader


def resolve_device(place):
    """A place (or a torch.device) -> torch.device; None is
    CUDAPlace(0)'s."""
    if place is None:
        from ..core.place import CUDAPlace
        place = CUDAPlace(0)
    if hasattr(place, 'device_id'):     # a paddle_tpu_torch Place
        return place.device()
    return torch.device(place)


def feed_normalizer(first, feed_names):
    """Returns item -> feed-dict fn for readers yielding dicts or tuples."""
    if feed_names is not None and not isinstance(first, dict):
        return lambda item: dict(zip(feed_names, item))
    return lambda item: item


def prefetch_to_device(reader, feed_names=None, buffer_size=2, place=None):
    """Overlap the host-to-device copy with compute: the next batch(es) are
    moved to the card while the current one trains (the reference's
    pinned-memory double buffering).

    ``reader`` yields dicts (or tuples zipped with ``feed_names``); the
    result yields dicts of tensors on ``place``'s device (CUDAPlace(0) when
    None). On the card each value is copied into a page-locked host
    buffer, then to the device on a side stream with no host wait; the
    stream that is current when a batch is yielded waits for that copy on
    the card.

    Mutation safety: a reader that reuses its output buffers is safe to
    prefetch. On the card a value is copied out of the reader's buffer
    before the next item is pulled; on the host it is copied
    (staging.host_alias_safe, the same invariant as the staging ring), so
    the producer overwriting its buffer cannot change a prefetched
    batch."""
    from .staging import _copy_stream, host_alias_safe

    device = resolve_device(place)

    def put(value):
        if isinstance(value, torch.Tensor):
            if value.device == device:
                return value, None
            value = value.cpu().numpy()
        value = host_alias_safe(np.asarray(value), device)
        if device.type != 'cuda':
            return torch.from_numpy(value), None
        pinned = torch.from_numpy(np.ascontiguousarray(value)).pin_memory()
        with torch.cuda.stream(_copy_stream(device)):
            out = pinned.to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return out, done

    def device_reader():
        import collections
        pending = collections.deque()
        norm = [None]

        def enqueue(item):
            if norm[0] is None:
                norm[0] = feed_normalizer(item, feed_names)
            pending.append({k: put(v) for k, v in norm[0](item).items()})

        def deliver(entry):
            if device.type == 'cuda':
                consumer = torch.cuda.current_stream(device)
                for t, done in entry.values():
                    if done is not None:
                        consumer.wait_event(done)
                        t.record_stream(consumer)
            return {k: t for k, (t, _) in entry.items()}

        it = iter(reader())
        for item in itertools.islice(it, buffer_size):
            enqueue(item)
        for item in it:
            out = pending.popleft()
            enqueue(item)   # the NEXT batch's copy is now in flight
            yield deliver(out)
        while pending:
            yield deliver(pending.popleft())

    return device_reader


def shard(reader, num_shards, shard_id, drop_uneven=True):
    """Deterministic round-robin shard of a reader stream: shard i yields
    samples i, i+n, i+2n, ... Every host must construct the SAME base
    reader (same seed/order); the shards are then disjoint and together
    cover the stream — the role go/master/service.go:1-510 plays with its
    task queue, done as a pure function of position so there is no
    master to run or lose.

    drop_uneven=True drops the ragged tail so all shards yield the SAME
    number of samples — required under SPMD, where every host must step
    the same number of times or the collectives deadlock.
    """
    if not 0 <= shard_id < num_shards:
        raise ValueError('shard_id %d not in [0, %d)' % (shard_id,
                                                         num_shards))

    def impl():
        buf = []
        for i, item in enumerate(reader()):
            if i % num_shards == shard_id:
                buf.append(item)
            if len(buf) and (i + 1) % num_shards == 0:
                yield buf.pop()
        if buf and not drop_uneven:
            yield buf.pop()
    return impl
