"""The training lifecycle, port against the JAX package on the same numpy
inputs: every lr_decay schedule at steps 0-50, the README's fit_a_line
and a tiny Transformer with noam, a global-norm clip and L1/L2 decay,
ErrorClipByValue's gradients, the Trainer's events and metrics (at
pipeline depths 1 and 2 and in windows of 2), and the port's own
invariants: resume from a checkpoint equals the uninterrupted run bit for
bit at dropout 0.1, a mid-epoch resume replays exactly the untrained
items, the bad-step policies under poisoned batches, the yield park, the
reader decorators and the DataFeeder."""

import os
import shutil
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as fluid
from paddle_tpu import reader as jreader
from paddle_tpu.core.executor import _error_clip_grad
from paddle_tpu.models import transformer as JT

import paddle_tpu_torch as pt
from paddle_tpu_torch import reader as preader
from paddle_tpu_torch.clip import error_clip_grad
from paddle_tpu_torch.fault import (BadStepError, CheckpointConfig,
                                    CheckpointManager, inject)
from paddle_tpu_torch.models import transformer as PT
from paddle_tpu_torch.weights import load_into_scope

SCHEDULES = {
    'exponential': lambda m: m.exponential_decay(0.1, 7, 0.8),
    'exponential_staircase': lambda m: m.exponential_decay(
        0.1, 7, 0.8, staircase=True),
    'natural_exp': lambda m: m.natural_exp_decay(0.1, 7, 0.3),
    'natural_exp_staircase': lambda m: m.natural_exp_decay(
        0.1, 7, 0.3, staircase=True),
    'inverse_time': lambda m: m.inverse_time_decay(0.1, 7, 0.5),
    'polynomial': lambda m: m.polynomial_decay(0.1, 20, 0.001, power=2.0),
    'polynomial_cycle': lambda m: m.polynomial_decay(0.1, 20, 0.001,
                                                     cycle=True),
    'piecewise': lambda m: m.piecewise_decay([5, 17, 30],
                                             [0.1, 0.05, 0.01, 0.002]),
    'cosine': lambda m: m.cosine_decay(0.1, 10, 4),
    'noam': lambda m: m.noam_decay(512, 20),
}


def _schedule(pkg, build, steps=51):
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        lr = build(pkg.learning_rate_decay)
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    with pkg.scope_guard(scope):
        exe.run(startup)
        return np.array([float(np.asarray(exe.run(main, fetch_list=[lr])[0])
                               .reshape(())) for _ in range(steps)])


@pytest.mark.parametrize('kind', sorted(SCHEDULES))
def test_lr_schedule_matches_reference(kind):
    """The rate at steps 0-50 (the @LR_DECAY_COUNTER@ advanced by its
    increment op each run) within 1e-7 relative of the JAX package's."""
    want = _schedule(fluid, SCHEDULES[kind])
    got = _schedule(pt, SCHEDULES[kind])
    assert want[0] > 0 and len(set(want.tolist())) > 1
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)


def _readme_fit_a_line(fluid, regularized):
    """The README's first example, written against either package (with
    ``regularized``: 13d's variant, L2Decay and exponential_decay)."""
    fluid.reset_default_programs()
    x = fluid.layers.data(name='x', shape=[13], dtype='float32')
    y = fluid.layers.data(name='y', shape=[1], dtype='float32')
    pred = fluid.layers.fc(input=x, size=1)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    if regularized:
        fluid.optimizer.SGD(
            learning_rate=fluid.learning_rate_decay.exponential_decay(
                0.05, 50, 0.9),
            regularization=fluid.regularizer.L2Decay(1e-4)).minimize(loss)
    else:
        fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return loss


@pytest.mark.parametrize('regularized', [False, True])
def test_readme_fit_a_line_matches_reference(regularized):
    """200 SGD steps of fit_a_line in each package from the JAX startup's
    weights: every loss within 1e-5 (relative, and absolute once the loss
    nears 0)."""
    jloss = _readme_fit_a_line(fluid, regularized)
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(jscope):
        jexe.run(fluid.default_startup_program())
    jmain = fluid.default_main_program()
    ploss = _readme_fit_a_line(pt, regularized)
    pmain = pt.default_main_program()
    pexe, pscope = pt.Executor(pt.CPUPlace()), pt.Scope()
    with pt.scope_guard(pscope):
        pexe.run(pt.default_startup_program())
    load_into_scope({n: np.asarray(jscope.find(n)) for n in jscope.keys()
                     if jscope.find(n) is not None}, pscope, pt.CPUPlace())
    rng = np.random.RandomState(0)
    w = rng.randn(13, 1).astype('float32')
    want, got = [], []
    for _ in range(200):
        xs = rng.randn(16, 13).astype('float32')
        feed = {'x': xs, 'y': (xs @ w + 0.5).astype('float32')}
        with fluid.scope_guard(jscope):
            want.append(float(np.asarray(jexe.run(
                jmain, feed=feed, fetch_list=[jloss])[0]).reshape(())))
        with pt.scope_guard(pscope):
            got.append(float(pexe.run(pmain, feed=feed,
                                      fetch_list=[ploss])[0].reshape(())))
    assert want[-1] < 1e-2 * want[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


TINY = dict(src_vocab_size=32, trg_vocab_size=32, src_seq_len=8,
            trg_seq_len=8, n_layer=2, d_model=16, d_inner=32, d_key=8,
            d_value=8, n_head=2)


def _lifecycle(pkg, model, decay, dropout=0.0, clip=1.0):
    """A tiny Transformer with noam, a global-norm clip, L1 or L2 decay
    and Adam (β2 0.98, ε 1e-9), on fresh default programs."""
    pkg.reset_default_programs()
    avg_cost, _ = model.transformer_base(dropout_rate=dropout, **TINY)
    pkg.clip.set_gradient_clip(pkg.clip.GradientClipByGlobalNorm(clip))
    reg = {'L1': pkg.regularizer.L1Decay,
           'L2': pkg.regularizer.L2Decay}[decay](1e-3)
    pkg.optimizer.Adam(learning_rate=pkg.learning_rate_decay.noam_decay(
        16, 4), beta1=0.9, beta2=0.98, epsilon=1e-9,
        regularization=reg).minimize(avg_cost)
    return avg_cost


@pytest.mark.parametrize('decay', ['L1', 'L2'])
def test_transformer_lifecycle_matches_reference(decay):
    """3 Adam steps with noam, a global-norm clip of 0.5 (it binds: the
    first gradient norm is larger) and L1/L2 decay from the JAX startup's
    weights: losses within 1e-5, and the clip's and the schedule's ops
    in the port's step."""
    jcost = _lifecycle(fluid, JT, decay, clip=0.5)
    jmain, jstart = fluid.default_main_program(), \
        fluid.default_startup_program()
    pcost = _lifecycle(pt, PT, decay, clip=0.5)
    pmain = pt.default_main_program()
    ops = [o.type for o in pmain.global_block().ops]
    for op in ('increment', 'lr_decay', 'global_norm_clip', 'scale',
               'sign' if decay == 'L1' else 'adam'):
        assert op in ops, op
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(jscope):
        jexe.run(jstart)
    pexe, pscope = pt.Executor(pt.CPUPlace()), pt.Scope()
    load_into_scope({n: np.asarray(jscope.find(n)) for n in jscope.keys()
                     if jscope.find(n) is not None}, pscope, pt.CPUPlace())
    feed = JT.make_fake_batch(4, 8, 8, 32, 32, seed=2)
    want, got = [], []
    grads = [o for o in pmain.global_block().ops
             if o.type == 'global_norm_clip'][0].inputs['X']
    norms = []
    for _ in range(3):
        with fluid.scope_guard(jscope):
            want.append(float(np.asarray(jexe.run(
                jmain, feed=feed, fetch_list=[jcost])[0])))
        with pt.scope_guard(pscope):
            out = pexe.run(pmain, feed=feed, fetch_list=[pcost] + grads)
            got.append(float(out[0]))
            norms.append(float(np.sqrt(sum(np.sum(np.square(g))
                                           for g in out[1:]))))
    assert norms[0] > 0.5, norms
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for name in ('@LR_DECAY_COUNTER@',):
        assert int(pscope.numpy(name)[0]) == int(np.asarray(
            jscope.find(name))[0]) == 2


def test_error_clip_grad_matches_jax_vjp():
    """The port's identity-with-clamped-cotangent against jax.vjp of the
    JAX package's custom_vjp, and through a program: the gradients of
    fc parameters below a clipped activation equal the JAX package's."""
    rng = np.random.RandomState(0)
    x = rng.randn(6, 5).astype('float32')
    g = (rng.randn(6, 5) * 3).astype('float32')
    y, vjp = jax.vjp(lambda v: _error_clip_grad(v, -1.0, 0.5), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_()
    out = error_clip_grad(xt, -1.0, 0.5)
    got, = torch.autograd.grad(out, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(y))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (np.abs(want - g) > 0).any()

    def build(pkg):
        pkg.reset_default_programs()
        xv = pkg.layers.data(name='x', shape=[5], dtype='float32')
        yv = pkg.layers.data(name='y', shape=[1], dtype='float32')
        h = pkg.layers.fc(input=xv, size=4)
        h.error_clip = pkg.clip.ErrorClipByValue(max=0.01)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(
            pkg.layers.fc(input=h, size=1), yv))
        _, pg = pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [v.name for _, v in pg]

    feed = {'x': x, 'y': (rng.randn(6, 1) * 5).astype('float32')}
    jgrads = build(fluid)
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(jscope):
        jexe.run(fluid.default_startup_program())
        weights = {n: np.asarray(jscope.find(n)) for n in jscope.keys()}
        want = jexe.run(fluid.default_main_program(), feed=feed,
                        fetch_list=jgrads)
    pgrads = build(pt)
    assert pgrads == jgrads
    pscope = pt.Scope()
    load_into_scope(weights, pscope, pt.CPUPlace())
    with pt.scope_guard(pscope):
        got = pt.Executor(pt.CPUPlace()).run(
            pt.default_main_program(), feed=feed, fetch_list=pgrads)
    for name, a, b in zip(pgrads, got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def _line_batches(n, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(4, 1).astype('float32')
    out = []
    for _ in range(n):
        xs = rng.randn(8, 4).astype('float32')
        out.append({'x': xs, 'y': (xs @ w).astype('float32')})
    return out


def _line_train_func(pkg):
    def train_func():
        x = pkg.layers.data(name='x', shape=[4], dtype='float32')
        y = pkg.layers.data(name='y', shape=[1], dtype='float32')
        pred = pkg.layers.fc(
            input=x, size=1,
            param_attr=pkg.ParamAttr(
                name='fw', initializer=pkg.initializer.Constant(0.05)),
            bias_attr=pkg.ParamAttr(
                name='fb', initializer=pkg.initializer.Constant(0.0)))
        return [pkg.layers.mean(pkg.layers.square_error_cost(pred, y))]
    return train_func


def _trainer_run(pkg, cfg=None, reader=None, n_epochs=1, handler=None,
                 **train_kw):
    """One Trainer run (SGD 0.1) in a fresh scope and fresh programs;
    returns (trainer, the final 'fw' as numpy)."""
    with pkg.scope_guard(pkg.Scope()):
        pkg.reset_default_programs()
        trainer = pkg.Trainer(
            train_func=_line_train_func(pkg),
            optimizer_func=lambda: pkg.optimizer.SGD(learning_rate=0.1),
            place=pkg.CPUPlace(), checkpoint_config=cfg)
        trainer.train(num_epochs=n_epochs, reader=reader,
                      event_handler=handler, **train_kw)
        return trainer, np.array(np.asarray(
            pkg.global_scope().find('fw')) if pkg is fluid else
            pkg.global_scope().numpy('fw'))


def _event_log(pkg):
    log = []

    def handler(e):
        row = [type(e).__name__, e.epoch, getattr(e, 'step', None)]
        if type(e).__name__ == 'EndStepEvent':
            row.append(float(np.asarray(e.metrics[0]).reshape(())))
        log.append(row)
    return log, handler


@pytest.mark.parametrize('kw', [dict(pipeline_depth=1),
                                dict(pipeline_depth=2, host_prefetch=2),
                                dict(steps_per_dispatch=2)],
                         ids=['depth1', 'depth2', 'window2'])
def test_trainer_events_match_reference(kw):
    """The event sequence (type, epoch, step) of 2 epochs of 5 batches
    and every step's loss (within 1e-5) equal the JAX package's Trainer
    at the same settings, and the final parameter within 1e-6."""
    batches = _line_batches(5)
    jlog, jh = _event_log(fluid)
    _, jw = _trainer_run(fluid, reader=lambda: iter(batches), n_epochs=2,
                         handler=jh, **kw)
    plog, ph = _event_log(pt)
    _, pw = _trainer_run(pt, reader=lambda: iter(batches), n_epochs=2,
                         handler=ph, **kw)
    assert [r[:3] for r in plog] == [r[:3] for r in jlog]
    assert len([r for r in plog if r[0] == 'EndStepEvent']) == 10
    np.testing.assert_allclose([r[3] for r in plog if len(r) > 3],
                               [r[3] for r in jlog if len(r) > 3],
                               rtol=1e-5)
    np.testing.assert_allclose(pw, jw, rtol=1e-6, atol=1e-7)


def _transformer_trainer(ckpt_dir, resume, dropout=0.1, place=None):
    pt.reset_default_programs()
    main = pt.Program()
    main.random_seed = 7
    startup = pt.Program()
    cfg = CheckpointConfig(ckpt_dir, save_every_steps=3, async_save=True,
                           resume=resume, epoch_end=False)
    return pt.Trainer(
        train_func=lambda: [_lifecycle_cost(dropout)],
        optimizer_func=lambda: pt.optimizer.Adam(
            learning_rate=pt.learning_rate_decay.noam_decay(16, 4),
            beta1=0.9, beta2=0.98, epsilon=1e-9),
        place=place or pt.CPUPlace(), checkpoint_config=cfg, program=main,
        startup_program=startup)


def _lifecycle_cost(dropout):
    avg_cost, _ = PT.transformer_base(dropout_rate=dropout, **TINY)
    pt.clip.set_gradient_clip(pt.clip.GradientClipByGlobalNorm(1.0))
    return avg_cost


def _fake_reader(n):
    def reader():
        for i in range(n):
            yield PT.make_fake_batch(4, 8, 8, 32, 32, seed=i)
    return reader


def _losses(log):
    return [np.asarray(e.metrics[0]).copy() for e in log
            if type(e).__name__ == 'EndStepEvent']


def test_resume_from_a_checkpoint_is_bit_exact(tmp_path):
    """8 steps at dropout 0.1 uninterrupted; then a fresh Trainer on a
    fresh scope and executor resumes from step 3's checkpoint: its losses
    4-8 and every persistable equal the uninterrupted run's bit for bit
    (the dropout masks go on at the executor's next step index)."""
    whole = str(tmp_path / 'whole')
    log = []
    with pt.scope_guard(pt.Scope()):
        t = _transformer_trainer(whole, resume=False)
        t.train(num_epochs=1, reader=preader.checkpointable(
            _fake_reader(8)), event_handler=log.append)
        want = {v.name: pt.global_scope().numpy(v.name)
                for v in t.program.list_vars()
                if v.persistable and not v.is_data}
    want_losses = _losses(log)
    assert len(want_losses) == 8
    resumed = str(tmp_path / 'resumed')
    os.makedirs(resumed)
    step3 = CheckpointManager(CheckpointConfig(whole)).step_dir(3)
    shutil.copytree(step3, os.path.join(resumed, os.path.basename(step3)))
    log = []
    with pt.scope_guard(pt.Scope()):
        t = _transformer_trainer(resumed, resume=True)
        t.train(num_epochs=1, reader=preader.checkpointable(
            _fake_reader(8)), event_handler=log.append)
        got = {n: pt.global_scope().numpy(n) for n in want}
    got_losses = _losses(log)
    assert [e.step for e in log if type(e).__name__ == 'EndStepEvent'] \
        == [3, 4, 5, 6, 7]
    for a, b in zip(got_losses, want_losses[3:]):
        np.testing.assert_array_equal(a, b)
    assert '@LR_DECAY_COUNTER@' in want and len(want) > 20
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


class _LoggingFeeder(object):
    """A feeder that records the id (x[0, 0]) of every batch it feeds."""

    def __init__(self):
        self.ids = []

    def feed(self, data):
        self.ids.append(int(data['x'][0, 0]))
        return data


class _Stop(Exception):
    pass


def _id_batches(n):
    rng = np.random.RandomState(1)
    out = []
    for i in range(n):
        xs = rng.randn(8, 4).astype('float32')
        xs[0, 0] = i
        out.append({'x': xs, 'y': xs[:, :1].copy()})
    return out


def test_mid_epoch_resume_replays_exactly_the_untrained_items(tmp_path):
    """A shuffled checkpointable reader, a checkpoint every 3 steps and a
    crash at step 5 of epoch 1: the resumed run trains exactly the items
    the checkpoint had not, in the uninterrupted order, and ends on the
    uninterrupted run's parameters."""
    batches = _id_batches(10)
    base = lambda: iter(batches)  # noqa: E731
    order = _LoggingFeeder()
    _, w_whole = _trainer_run(pt, reader=preader.checkpointable(
        base, shuffle_buf=4, seed=3), n_epochs=2, feeder=order)
    assert sorted(order.ids[:10]) == list(range(10))
    assert order.ids[:10] != order.ids[10:]

    cfg = CheckpointConfig(str(tmp_path), save_every_steps=3,
                           async_save=False, epoch_end=False)
    first = _LoggingFeeder()

    def crash(e):
        if type(e).__name__ == 'EndStepEvent' and e.epoch == 1 and \
                e.step == 4:
            raise _Stop()
    with pytest.raises(_Stop):
        _trainer_run(pt, cfg, reader=preader.checkpointable(
            base, shuffle_buf=4, seed=3), n_epochs=2, handler=crash,
            feeder=first)
    assert first.ids == order.ids[:15]
    second = _LoggingFeeder()
    cfg = CheckpointConfig(str(tmp_path), save_every_steps=3,
                           async_save=False, epoch_end=False, resume=True)
    _, w = _trainer_run(pt, cfg, reader=preader.checkpointable(
        base, shuffle_buf=4, seed=3), n_epochs=2, feeder=second)
    # the newest checkpoint is step 12 (epoch 1, in-epoch step 2)
    assert second.ids == order.ids[12:]
    np.testing.assert_array_equal(w, w_whole)


@pytest.mark.parametrize('policy', ['raise', 'skip_step', 'rollback'])
def test_bad_step_policies_under_poisoned_batches(tmp_path, policy):
    """poison_nans at batch 2: 'raise' raises BadStepError; 'skip_step',
    and 'rollback' with a checkpoint every step, end on the parameters of
    a run that never saw batch 2; the undo writes into the scope's own
    tensors."""
    batches = _line_batches(6)
    poisoned = inject.poison_nans(lambda: iter(batches), 2)
    cfg = CheckpointConfig(str(tmp_path), nan_policy=policy,
                           epoch_end=False, async_save=False,
                           save_every_steps=1 if policy == 'rollback'
                           else None)
    if policy == 'raise':
        with pytest.raises(BadStepError, match='non-finite'):
            _trainer_run(pt, cfg, reader=poisoned)
        return
    trainer, w = _trainer_run(pt, cfg, reader=poisoned)
    assert np.all(np.isfinite(w))
    _, w_ref = _trainer_run(pt, reader=lambda: iter(
        [b for i, b in enumerate(batches) if i != 2]))
    np.testing.assert_array_equal(w, w_ref)


def test_bad_steps_escalate_after_max_bad_steps(tmp_path):
    all_bad = [{'x': b['x'], 'y': np.full_like(b['y'], np.nan)}
               for b in _line_batches(6)]
    cfg = CheckpointConfig(str(tmp_path), nan_policy='skip_step',
                           max_bad_steps=3, epoch_end=False)
    with pytest.raises(BadStepError, match='consecutive'):
        _trainer_run(pt, cfg, reader=lambda: iter(all_bad))


def test_request_yield_parks_and_resumes_without_changing_the_run():
    batches = _line_batches(6)
    _, w_ref = _trainer_run(pt, reader=lambda: iter(batches),
                            pipeline_depth=2)
    box = {}

    def handler(e):
        t = box['trainer']
        if type(e).__name__ == 'EndStepEvent' and e.step == 1:
            t.request_yield()
            threading.Timer(0.2, t.resume_from_yield).start()
            threading.Timer(0.1, lambda: box.setdefault(
                'parked', t.yielded())).start()

    with pt.scope_guard(pt.Scope()):
        pt.reset_default_programs()
        t = box['trainer'] = pt.Trainer(
            _line_train_func(pt),
            lambda: pt.optimizer.SGD(learning_rate=0.1), place=pt.CPUPlace())
        t.train(1, handler, reader=lambda: iter(batches), pipeline_depth=2)
        w = pt.global_scope().numpy('fw')
    assert box['parked'] is True and not t.yielded()
    np.testing.assert_array_equal(w, w_ref)


def _items():
    return lambda: iter(range(10))


READERS = {
    'batch': lambda r: r.batch(_items(), 3, drop_last=False),
    'chain': lambda r: r.chain(_items(), _items()),
    'compose': lambda r: r.compose(_items(), _items()),
    'firstn': lambda r: r.firstn(_items(), 4),
    'map_readers': lambda r: r.map_readers(lambda a, b: a * b, _items(),
                                           _items()),
    'buffered': lambda r: r.buffered(_items(), 2),
    'cache': lambda r: r.cache(_items()),
    'xmap_ordered': lambda r: r.xmap_readers(lambda v: v + 1, _items(), 3,
                                             4, order=True),
    'shard': lambda r: r.shard(_items(), 3, 1),
    'checkpointable': lambda r: r.checkpointable(_items(), shuffle_buf=4,
                                                 seed=5),
}


@pytest.mark.parametrize('name', sorted(READERS))
def test_reader_decorators_match_reference(name):
    want = list(READERS[name](jreader)())
    got = list(READERS[name](preader)())
    assert got == want


def test_shuffle_and_retry_keep_the_items():
    got = list(preader.shuffle(_items(), 4)())
    assert sorted(got) == list(range(10))
    flaky = inject.flaky(_items(), fail_times=2, fail_after=3)
    assert list(preader.retry(flaky, tries=3, backoff=0)()) == \
        list(range(10))
    # prefetch_to_device on the host: the reference's batches, in order
    def feeds():
        for i in range(5):
            yield {'x': np.full((2, 3), i, 'float32'), 'i': np.int64(i)}
    want = list(jreader.prefetch_to_device(feeds, place=fluid.CPUPlace())())
    got = list(preader.prefetch_to_device(feeds, place=pt.CPUPlace())())
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def test_data_feeder_matches_reference():
    rows = [(np.arange(4, dtype='float32') + i, i) for i in range(3)]
    feeds = []
    for pkg in (fluid, pt):
        pkg.reset_default_programs()
        x = pkg.layers.data(name='x', shape=[4], dtype='float32')
        y = pkg.layers.data(name='y', shape=[1], dtype='int64')
        feeds.append(pkg.DataFeeder([x, y]).feed(rows))
    for name in ('x', 'y'):
        assert feeds[1][name].dtype == feeds[0][name].dtype
        np.testing.assert_array_equal(feeds[1][name], feeds[0][name])


_KILL_CHILD = r'''
import sys
import numpy as np
import paddle_tpu_torch as pt
batches = []
rng = np.random.RandomState(0)
for _ in range(5):
    xs = rng.randn(8, 4).astype('float32')
    batches.append({'x': xs, 'y': xs[:, :1].copy()})

def train_func():
    x = pt.layers.data(name='x', shape=[4], dtype='float32')
    y = pt.layers.data(name='y', shape=[1], dtype='float32')
    return [pt.layers.mean(pt.layers.square_error_cost(
        pt.layers.fc(input=x, size=1), y))]

trainer = pt.Trainer(train_func, lambda: pt.optimizer.SGD(learning_rate=0.1),
                     place=pt.CPUPlace(), checkpoint_config=pt.CheckpointConfig(
                         sys.argv[1], save_every_steps=1, async_save=False))
trainer.train(1, reader=lambda: iter(batches))
print('finished')
'''


def test_environment_injections_kill_and_truncate(tmp_path):
    """PADDLE_TPU_FI_KILL_AT_STEP=3 ends a training process with exit code
    42 after step 3's checkpoint; PADDLE_TPU_FI_CORRUPT_CKPT_AT=3 truncates
    that checkpoint after its commit, and a restore falls back to step
    2's."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo,
               PADDLE_TPU_FI_KILL_AT_STEP='3',
               PADDLE_TPU_FI_CORRUPT_CKPT_AT='3')
    r = subprocess.run([sys.executable, '-c', _KILL_CHILD, str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == inject.KILL_EXIT_CODE, r.stdout + r.stderr
    assert 'finished' not in r.stdout
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path)))
    assert [s for s, _ in mgr._scan()] == [3, 2, 1]
    with pytest.warns(UserWarning, match='skipping'):
        step, _, meta = mgr.find_latest()
    assert step == 2 and meta['step'] == 2
    plan = inject.install_from_env({'PADDLE_TPU_FI_KILL_AT_STEP': '7'})
    try:
        assert plan.kill_at_step == 7 and \
            plan.corrupt_checkpoint_at_step is None
    finally:
        inject.clear()


def test_error_clip_callback_is_the_references_no_op():
    """clip.error_clip_callback is exported by both packages and does
    nothing in either: it returns None and appends no op."""
    assert 'error_clip_callback' in fluid.clip.__all__
    assert 'error_clip_callback' in pt.clip.__all__
    for pkg in (fluid, pt):
        pkg.reset_default_programs()
        block = pkg.default_main_program().global_block()
        n = len(block.ops)
        assert pkg.clip.error_clip_callback(block, None) is None
        assert len(block.ops) == n


def test_null_gradient_clip_attr_matches_reference():
    """clip.NullGradientClipAttr hands each (param, grad) back unchanged,
    and a program with it as its clip trains as the reference does: the
    same op types after minimize and the same final weight."""
    ops, weights = [], []
    for pkg in (fluid, pt):
        null = pkg.clip.NullGradientClipAttr()
        assert isinstance(null, pkg.clip.BaseGradientClipAttr)
        assert null.create_operators('p', 'g', None) == ('p', 'g')

        def train_func(pkg=pkg, null=null):
            cost = _line_train_func(pkg)()
            pkg.clip.set_gradient_clip(null)
            return cost
        with pkg.scope_guard(pkg.Scope()):
            pkg.reset_default_programs()
            trainer = pkg.Trainer(
                train_func=train_func,
                optimizer_func=lambda pkg=pkg: pkg.optimizer.SGD(0.1),
                place=pkg.CPUPlace())
            batches = _line_batches(3)
            trainer.train(num_epochs=1, reader=lambda: iter(batches))
            ops.append([op.type for op in trainer.program.global_block().ops])
            weights.append(np.array(np.asarray(
                pkg.global_scope().find('fw')) if pkg is fluid else
                pkg.global_scope().numpy('fw')))
    assert ops[0] == ops[1]
    assert not [t for t in ops[1] if 'clip' in t]
    np.testing.assert_allclose(weights[1], weights[0], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('cfg', ['none', 'dirname', 'config'])
def test_trainer_checkpoint_dir_matches_reference(tmp_path, cfg):
    """Trainer.checkpoint_dir is the checkpoint config's dirname (a bare
    dirname given as the config too) or None, as the reference's."""
    for pkg in (fluid, pt):
        root = str(tmp_path / pkg.__name__)
        config = {'none': None, 'dirname': root,
                  'config': pkg.fault.CheckpointConfig(
                      root, save_every_steps=2)}[cfg]
        with pkg.scope_guard(pkg.Scope()):
            pkg.reset_default_programs()
            trainer = pkg.Trainer(
                train_func=_line_train_func(pkg),
                optimizer_func=lambda pkg=pkg: pkg.optimizer.SGD(0.1),
                place=pkg.CPUPlace(), checkpoint_config=config)
        assert trainer.checkpoint_dir == (None if cfg == 'none' else root)
