"""The staging ring of the port (native/staging.cpp, reader/staging.py),
reader.prefetch_to_device and Trainer.train(stacked_windows=True), held
against the JAX package's on the same readers, on the CPU.

Mirrors the reference's tests/test_staging.py (the ring's round trip and
misuse, windows equal to np.stack, windows feeding run_steps, steps=1, a
changed shape), tests/test_pipeline.py (stacked windows through the
Trainer; prefetch_to_device's mutation safety and tail) and
tests/test_readers.py (prefetch_to_device)."""

import ctypes
import os
import threading
import warnings

import numpy as np
import pytest

import jax  # noqa: F401  (port tests import both frameworks)
import torch

import paddle_tpu as fluid
from paddle_tpu import observe as jobs
from paddle_tpu.native import load_staging as jload_staging
from paddle_tpu.reader import decorator as jdecorator
from paddle_tpu.reader.staging import staged_superbatch as jstaged

import paddle_tpu_torch as pt
from paddle_tpu_torch import native as pnative
from paddle_tpu_torch import observe as pobs
from paddle_tpu_torch.reader import decorator as pdecorator
from paddle_tpu_torch.reader import staging as pstaging
from paddle_tpu_torch.reader.staging import staged_superbatch

HOST = pt.CPUPlace()


# ------------------------------------------------------------- the ring
def _roundtrip(lib):
    ring = lib.staging_open(1 << 12, 3)
    assert ring
    payloads = [bytes([i] * 100 + [255 - i]) for i in range(7)]

    def produce():
        for p in payloads:
            buf = lib.staging_acquire_fill(ring)
            assert buf
            ctypes.memmove(buf, p, len(p))
            assert lib.staging_commit(ring, len(p)) == 0
        lib.staging_close_ring(ring)

    t = threading.Thread(target=produce)
    t.start()
    got = []
    while True:
        n = ctypes.c_uint64()
        buf = lib.staging_acquire_read(ring, ctypes.byref(n))
        if not buf:
            break
        got.append(ctypes.string_at(buf, n.value))
        assert lib.staging_release(ring) == 0
    t.join()
    lib.staging_free(ring)
    return payloads, got


def test_ring_roundtrip_ordering():
    """FIFO, bytes intact, no tearing: the port's ring gives what it was
    given, as the reference's does."""
    for lib in (pnative.load_staging(), jload_staging()):
        payloads, got = _roundtrip(lib)
        assert got == payloads


def test_ring_misuse_returns_error():
    lib = pnative.load_staging()
    assert not lib.staging_open(0, 3)       # zero capacity
    assert not lib.staging_open(1024, 1)    # fewer than 2 buffers
    ring = lib.staging_open(1024, 2)
    assert lib.staging_capacity(ring) == 1024
    assert lib.staging_commit(ring, 10) == -1    # commit without fill
    assert lib.staging_release(ring) == -1       # release without read
    assert lib.staging_acquire_fill(ring)
    assert lib.staging_commit(ring, 4096) == -1  # over capacity
    lib.staging_close_ring(ring)
    lib.staging_free(ring)


def test_ring_is_built_at_first_use_into_the_build_dir():
    """The port's own copy of the ring's source, built with g++ into
    _build/ under a name keyed by the source's hash (a second build
    reuses it, no temporary is left), bound with the reference's restype
    and argtypes."""
    path = pnative.build_native('staging')
    assert os.path.dirname(path) == pnative.BUILD_DIR
    assert pnative.build_native('staging') == path
    assert not [f for f in os.listdir(pnative.BUILD_DIR)
                if f.startswith('libstaging') and f.endswith('.tmp')]
    mine, ref = pnative.load_staging(), jload_staging()
    for fn in ('staging_open', 'staging_capacity', 'staging_acquire_fill',
               'staging_commit', 'staging_acquire_read', 'staging_release',
               'staging_close_ring', 'staging_free'):
        a, b = getattr(mine, fn), getattr(ref, fn)
        assert a.restype == b.restype, fn
        assert [t.__name__ for t in a.argtypes] == \
            [t.__name__ for t in b.argtypes], fn


# ------------------------------------------------------ staged windows
def _batches(n, batch=4, seed=0):
    rng = np.random.RandomState(seed)
    return [{'x': rng.randn(batch, 8).astype('f'),
             'y': rng.randn(batch, 1).astype('f'),
             'i': rng.randint(0, 9, (batch, 2)).astype('int64')}
            for _ in range(n)]


@pytest.mark.parametrize('steps', [1, 3])
def test_windows_equal_np_stack_and_the_reference(steps):
    """7 batches: windows of ``steps`` (a trailing partial one dropped),
    each field the np.stack of its batches, as the reference's windows,
    as CPU tensors that do not alias the ring's slots."""
    data = _batches(7)
    got = list(staged_superbatch(lambda: iter(data), steps, place=HOST)())
    want = list(jstaged(lambda: iter(data), steps,
                        place=fluid.CPUPlace())())
    assert len(got) == len(want) == 7 // steps
    for k, (w, r) in enumerate(zip(got, want)):
        assert sorted(w) == sorted(r) == ['i', 'x', 'y']
        for n in w:
            stack = np.stack([data[k * steps + i][n] for i in range(steps)])
            assert isinstance(w[n], torch.Tensor)
            assert w[n].device.type == 'cpu'
            np.testing.assert_array_equal(w[n].numpy(), stack)
            np.testing.assert_array_equal(w[n].numpy(), np.asarray(r[n]))


def test_tuples_with_feed_names():
    data = _batches(4)
    rows = [(b['x'], b['y']) for b in data]
    got = list(staged_superbatch(lambda: iter(rows), 2, feed_names=['x',
                                                                     'y'],
                                 place=HOST)())
    assert len(got) == 2
    np.testing.assert_array_equal(got[1]['y'].numpy(),
                                  np.stack([data[2]['y'], data[3]['y']]))


def test_mismatched_shape_raises_naming_the_feed():
    data = _batches(3)
    data[2]['x'] = np.zeros((5, 8), 'f')    # the batch size drifts
    with pytest.raises(ValueError, match="'x'"):
        list(staged_superbatch(lambda: iter(data), 3, place=HOST)())
    with pytest.raises(ValueError, match="'x'"):
        list(jstaged(lambda: iter(data), 3, place=fluid.CPUPlace())())


def test_early_exit_closes_the_ring():
    """A consumer that stops after one window closes the ring: the
    producer thread ends and nothing leaks."""
    data = _batches(40)
    before = {t.ident for t in threading.enumerate()}
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        it = staged_superbatch(lambda: iter(data), 2, n_buffers=2,
                               place=HOST)()
        next(it)
        it.close()
    left = [t for t in threading.enumerate()
            if t.name == 'paddle_tpu_torch_staging_producer' and
            t.ident not in before and t.is_alive()]
    assert not left


def _linreg_cost(pkg):
    """fit_a_line on 8 features from constant weights (the two packages'
    random initializers differ by design)."""
    x = pkg.layers.data(name='x', shape=[8], dtype='float32')
    y = pkg.layers.data(name='y', shape=[1], dtype='float32')
    pred = pkg.layers.fc(
        input=x, size=1,
        param_attr=pkg.ParamAttr(name='fw',
                                 initializer=pkg.initializer.Constant(0.05)),
        bias_attr=pkg.ParamAttr(name='fb',
                                initializer=pkg.initializer.Constant(0.0)))
    return pkg.layers.mean(pkg.layers.square_error_cost(pred, y))


def _linreg(pkg):
    pkg.reset_default_programs()
    cost = _linreg_cost(pkg)
    pkg.optimizer.SGD(learning_rate=0.1).minimize(cost)
    return cost


def test_windows_feed_run_steps():
    """Windows through Executor.run_steps(stacked_feed=True) give the
    losses of the batches one Executor.run at a time, bit for bit, and the
    reference's staged run within 1e-5."""
    data = [{k: v for k, v in b.items() if k != 'i'}
            for b in _batches(6, seed=3)]
    runs = []
    for staged in (False, True):
        with pt.scope_guard(pt.Scope()):
            cost = _linreg(pt)
            exe = pt.Executor(HOST)
            exe.run(pt.default_startup_program())
            if staged:
                losses = []
                for w in staged_superbatch(lambda: iter(data), 3,
                                           place=HOST)():
                    losses += exe.run_steps(3, feed=w, fetch_list=[cost],
                                            stacked_feed=True)[0].reshape(
                        -1).tolist()
            else:
                losses = [float(exe.run(feed=b, fetch_list=[cost])[0]
                                .reshape(())) for b in data]
            runs.append(losses)
    with fluid.scope_guard(fluid.Scope()):
        cost = _linreg(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(fluid.default_startup_program())
        ref = []
        for w in jstaged(lambda: iter(data), 3, place=fluid.CPUPlace())():
            ref += np.asarray(exe.run_steps(
                3, feed=w, fetch_list=[cost],
                stacked_feed=True)[0]).reshape(-1).tolist()
    assert runs[1] == runs[0]
    np.testing.assert_allclose(runs[1], ref, rtol=1e-5, atol=1e-6)


def test_ring_gauges_match_the_reference():
    """With telemetry on, the windows produced and consumed and the ring's
    gauges (slots, occupancy ending at 0) read as the reference's."""
    data = _batches(6)
    snaps = []
    for mod, run in ((pobs, lambda: list(staged_superbatch(
            lambda: iter(data), 2, place=HOST)())),
            (jobs, lambda: list(jstaged(lambda: iter(data), 2,
                                        place=fluid.CPUPlace())()))):
        mod.reset()
        mod.enable()
        try:
            run()
            snaps.append((mod.get_counter(
                'reader.staging_windows_produced_total'),
                mod.get_counter('reader.staging_windows_consumed_total'),
                mod.get_gauge('reader.staging_ring_slots'),
                mod.get_gauge('reader.staging_ring_occupancy')))
        finally:
            mod.disable()
            mod.reset()
    assert snaps[0] == snaps[1] == (3, 3, 3, 0)


# --------------------------------------------------- the Trainer's path
def _trainer(pkg, reader, **kw):
    """SGD(0.1) on the linear regression from constant weights, one epoch;
    returns (losses, fw, fb, the trainer)."""
    with pkg.scope_guard(pkg.Scope()):
        pkg.reset_default_programs()

        def train_func():
            return [_linreg_cost(pkg)]
        trainer = pkg.Trainer(
            train_func=train_func,
            optimizer_func=lambda: pkg.optimizer.SGD(learning_rate=0.1),
            place=pkg.CPUPlace())
        losses = []

        def handler(e):
            if type(e).__name__ == 'EndStepEvent':
                losses.append(float(np.asarray(e.metrics[0]).reshape(())))
        trainer.train(num_epochs=1, event_handler=handler, reader=reader,
                      **kw)
        scope = pkg.global_scope()
        fw, fb = (np.array(np.asarray(scope.find(n)) if pkg is fluid else
                           scope.numpy(n)) for n in ('fw', 'fb'))
        return losses, fw, fb, trainer


@pytest.mark.parametrize('depth', [1, 2])
def test_stacked_windows_device_resident(depth):
    """train(stacked_windows=True) over staged_superbatch windows of 2
    ends where host stacking (steps_per_dispatch=2) ends, bit for bit, and
    on the reference's stacked-window run (its windows device_put by
    hand, as its own test feeds them) within 1e-5; one reader item is one
    window."""
    data = [{k: v for k, v in b.items() if k != 'i'}
            for b in _batches(6, seed=7)]
    host = _trainer(pt, lambda: iter(data), steps_per_dispatch=2,
                    pipeline_depth=depth)
    staged = _trainer(pt, staged_superbatch(lambda: iter(data), 2,
                                            place=HOST),
                      steps_per_dispatch=2, stacked_windows=True,
                      pipeline_depth=depth)

    def superbatches():
        for i in range(0, 6, 2):
            yield {n: jax.device_put(np.stack([b[n] for b in data[i:i + 2]]))
                   for n in data[i]}
    ref = _trainer(fluid, superbatches, steps_per_dispatch=2,
                   stacked_windows=True, pipeline_depth=depth)
    assert staged[0] == host[0] and len(staged[0]) == 6
    for a, b in zip(staged[1:3], host[1:3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(staged[0], ref[0], rtol=1e-5, atol=1e-7)
    for a, b in zip(staged[1:3], ref[1:3]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    assert staged[3]._pulled == 3 and staged[3]._trained == 3


# ------------------------------------------------- prefetch_to_device
def test_prefetch_to_device_mutation_safety_and_tail():
    """A reader that reuses its output buffer does not change a batch
    already prefetched, and the buffered tail drains after the source
    ends: the reference's batches."""
    def make():
        buf = np.zeros((2, 3), dtype='float32')

        def reuse_reader():
            for i in range(5):
                buf[:] = i      # the same buffer every yield
                yield {'x': buf}
        return reuse_reader
    got = [b['x'].numpy().copy() for b in pdecorator.prefetch_to_device(
        make(), buffer_size=2, place=HOST)()]
    want = [np.asarray(b['x']).copy() for b in jdecorator.prefetch_to_device(
        make(), buffer_size=2, place=fluid.CPUPlace())()]
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, np.full((2, 3), i, 'float32'))


def test_prefetch_to_device_tuples_and_tensors():
    """Tuples zip with feed_names; a tensor already on the target stays
    as it is."""
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)

    def reader():
        for i in range(3):
            yield (np.full((1, 2), i, 'int64'), t)
    got = list(pdecorator.prefetch_to_device(
        reader, feed_names=['a', 'b'], buffer_size=5, place=HOST)())
    assert [g['a'].tolist() for g in got] == [[[i, i]] for i in range(3)]
    assert all(g['b'] is t for g in got)


def test_host_alias_safe_copies_on_the_host_only():
    a = np.arange(4, dtype='float32')
    c = pstaging.host_alias_safe(a, torch.device('cpu'))
    assert c is not a and np.array_equal(c, a)
    assert pstaging.host_alias_safe(a, torch.device('meta')) is a


def test_default_place_wants_a_card():
    """With no place the ring and the prefetch copy to CUDAPlace(0):
    without a card they raise instead of staying on the host."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        staged_superbatch(lambda: iter(_batches(2)), 2)
    with pytest.raises(RuntimeError, match='CUDA'):
        pdecorator.prefetch_to_device(lambda: iter(_batches(2)))
