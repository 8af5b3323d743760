"""Host staging feeder: the native aligned-buffer ring and superbatch
packing (reference: paddle_tpu reader/staging.py; the pinned-memory double
buffering of the reference's DataProvider).

A background thread packs ``steps`` consecutive batches contiguously into
one page-aligned slot of the C++ staging ring (native/staging.cpp) while
the current window trains. The consumer wraps the slot zero-copy as CPU
tensors and issues one host-to-device copy a field a window. On the card
each slot is page-locked once (``cudaHostRegister``) before its first
copy, the copies run on a side stream into fresh device tensors, and only
those copies are waited for before the slot goes back to the producer.
Pairs with ``Executor.run_steps(stacked_feed=True)``: one dispatch and one
transfer a field for every ``steps`` training steps.
"""

import ctypes
import itertools
import queue
import threading
import time
import warnings

import numpy as np
import torch

from .. import observe as _obs

__all__ = ['staged_superbatch', 'fields_to_device', 'host_alias_safe']

_ALIGN = 4096           # each field's region starts page-aligned
_COPY_STREAMS = {}


def _load():
    from ..native import load_staging
    return load_staging()


def host_alias_safe(arr, target):
    """``arr`` safe to hand to ``target`` (a torch.device) while the caller
    keeps writing into its buffer: on the host a tensor made from a numpy
    array aliases it, so the array is copied there. On the card the copy
    to device memory is the copy. The one home of the invariant, shared by
    fields_to_device (staging ring slots) and reader.prefetch_to_device
    (readers that reuse their output buffers)."""
    if target.type == 'cpu' and isinstance(arr, np.ndarray):
        return arr.copy()
    return arr


def _copy_stream(device):
    stream = _COPY_STREAMS.get(device)
    if stream is None:
        stream = _COPY_STREAMS[device] = torch.cuda.Stream(device=device)
    return stream


def fields_to_device(fields, target):
    """fields: name -> numpy view aliasing a reusable staging slot; returns
    name -> tensor on ``target`` that no longer reads the slot, so the
    caller may release and refill it. On the host: copies
    (host_alias_safe). On the card: the slot must be page-locked (a
    pageable slot raises); one ``copy_(non_blocking=True)`` a field on a
    side stream into a fresh device tensor, made safe for the stream that
    is current here (``record_stream``), then a wait for those copies
    alone."""
    if target.type != 'cuda':
        return {n: torch.from_numpy(host_alias_safe(a, target))
                for n, a in fields.items()}
    consumer = torch.cuda.current_stream(target)
    side = _copy_stream(target)
    window = {}
    with torch.cuda.stream(side):
        for n, a in fields.items():
            src = torch.from_numpy(a)
            if not src.is_pinned():
                raise RuntimeError(
                    'fields_to_device: feed %r lies in pageable host memory; '
                    'a staging slot is page-locked before its first copy'
                    % n)
            dst = torch.empty(src.shape, dtype=src.dtype, device=target)
            dst.copy_(src, non_blocking=True)
            dst.record_stream(consumer)
            window[n] = dst
        copied = torch.cuda.Event()
        copied.record(side)
    copied.synchronize()
    return window


def _register(ptr, nbytes, device):
    """Page-lock one ring slot for the card's copy engine; raises when the
    driver refuses."""
    with torch.cuda.device(device):
        torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(
            ptr, nbytes, 0))


def _unregister(ptr, device):
    with torch.cuda.device(device):
        torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(ptr))


def staged_superbatch(reader, steps, feed_names=None, n_buffers=3,
                      place=None):
    """Wrap ``reader`` (yielding per-step feed dicts, or tuples zipped with
    ``feed_names``) into a reader of device-resident superbatch dicts:
    every yield maps name -> tensor of shape [steps, *batch] on the place's
    device, for Executor.run_steps(steps, feed=..., stacked_feed=True).
    Trailing batches that do not fill a window are dropped (static shapes,
    as reader.batch(drop_last=True)); a batch whose shape differs from the
    first raises ValueError naming the feed. ``place``: CUDAPlace(0) when
    None.

    The returned reader's ``stats`` dict counts, over its epochs, the
    rings opened, the slots page-locked (and the seconds that took) and
    the windows consumed."""
    from .decorator import feed_normalizer, resolve_device

    device = resolve_device(place)
    stats = {'rings': 0, 'slots_pinned': 0, 'pin_seconds': 0.0,
             'windows': 0}

    def gen():
        lib = _load()
        it = iter(reader())
        try:
            first = next(it)
        except StopIteration:
            return
        norm = feed_normalizer(first, feed_names)
        first = norm(first)
        names = sorted(first)
        specs = {n: (np.asarray(first[n]).shape, np.asarray(first[n]).dtype)
                 for n in names}
        sizes = {n: int(np.prod(specs[n][0])) * specs[n][1].itemsize
                 for n in names}
        offs, total = {}, 0
        for n in names:
            offs[n] = total
            total += -(-(sizes[n] * steps) // _ALIGN) * _ALIGN

        def slot(buf, nbytes):
            """name -> the [steps, *shape] numpy view of its region of the
            slot at ``buf``."""
            raw = (ctypes.c_uint8 * nbytes).from_address(buf)
            return {n: np.frombuffer(
                raw, dtype=specs[n][1], count=steps * int(np.prod(
                    specs[n][0])), offset=offs[n]).reshape(
                        (steps,) + specs[n][0]) for n in names}

        ring = lib.staging_open(total, n_buffers)
        if not ring:
            raise MemoryError('staging_open failed (%d bytes x %d)'
                              % (total, n_buffers))
        stats['rings'] += 1
        err = queue.Queue()
        state = {'produced': 0, 'consumed': 0}

        def _ring_gauges():
            # occupancy: committed windows not yet consumed, 0..n_buffers
            # (near n_buffers: the reader is ahead of the card; at 0: the
            # input pipeline is the bottleneck)
            _obs.set_gauge('reader.staging_ring_occupancy',
                           state['produced'] - state['consumed'])
            _obs.set_gauge('reader.staging_ring_slots', n_buffers)

        def produce():
            try:
                batches = []
                # the first batch goes through the same flush as the rest,
                # so a steps=1 window packs exactly one batch
                for item in itertools.chain([first], map(norm, it)):
                    batches.append(item)
                    if len(batches) < steps:
                        continue
                    for n in names:
                        for b in batches:
                            if np.shape(b[n]) != specs[n][0]:
                                raise ValueError(
                                    'staged_superbatch: feed %r shape %s '
                                    '!= first batch %s'
                                    % (n, np.shape(b[n]), specs[n][0]))
                    buf = lib.staging_acquire_fill(ring)
                    if not buf:
                        return  # the consumer closed the ring early
                    # one copy a field: its batches stacked into its region
                    for n, region in slot(buf, total).items():
                        np.stack([b[n] for b in batches], out=region,
                                 casting='unsafe')
                    if lib.staging_commit(ring, total):
                        raise RuntimeError('staging_commit failed')
                    state['produced'] += 1
                    if _obs.enabled():
                        _obs.inc('reader.staging_windows_produced_total')
                        _ring_gauges()
                    batches = []
            except Exception as e:  # raised on the consumer's side
                err.put(e)
            finally:
                lib.staging_close_ring(ring)

        t = threading.Thread(target=produce, daemon=True,
                             name='paddle_tpu_torch_staging_producer')
        t.start()
        pinned = []
        try:
            while True:
                out_len = ctypes.c_uint64()
                buf = lib.staging_acquire_read(ring, ctypes.byref(out_len))
                if not buf:
                    if not err.empty():
                        raise err.get()
                    return
                if device.type == 'cuda' and buf not in pinned:
                    t0 = time.perf_counter()
                    _register(buf, total, device)
                    stats['pin_seconds'] += time.perf_counter() - t0
                    pinned.append(buf)
                    stats['slots_pinned'] += 1
                window = fields_to_device(slot(buf, out_len.value), device)
                if lib.staging_release(ring):
                    raise RuntimeError('staging_release failed')
                state['consumed'] += 1
                stats['windows'] += 1
                if _obs.enabled():
                    _obs.inc('reader.staging_windows_consumed_total')
                    _ring_gauges()
                yield window
        finally:
            lib.staging_close_ring(ring)
            t.join(timeout=5.0)
            for ptr in pinned:
                _unregister(ptr, device)
            if t.is_alive():
                # the producer is stuck inside the user's reader: freeing
                # now would hand it a dangling ring, so the ring leaks
                warnings.warn('staged_superbatch: producer thread did not '
                              'exit; leaking one staging ring')
            else:
                lib.staging_free(ring)

    gen.stats = stats
    return gen
