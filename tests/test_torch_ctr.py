"""Wide&Deep CTR, the recommender and word2vec in the port against the JAX
package: the same program built by both, the JAX startup's weights copied
across, the same numpy batches (ids drawn from a Zipf law folded onto each
table, so duplicate ids are common), and the losses and every persistable
compared; rows never fed stay frozen bit for bit. Then the CTR example's
flow: a checkpoint written mid-epoch after 12 of 20 batches resumes bit for
bit, and an Adagrad-trained checkpoint loads both ways with the JAX
package. Small: 4 slots of 200 rows, batch 16.

Tolerances, each with its reason:
- losses: rtol 1e-5 (the MLP's fp32 matmuls and reductions sum in another
  order in torch and XLA; 5 steps compound it);
- tables and weights under SGD and lazy Momentum: rtol 1e-5, atol 1e-6
  (the update is linear in the gradient, so the same order effects);
- under Adagrad and lazy Adam: rtol 1e-5 and atol 2e-4 x lr. Their first
  step moves an entry by lr * g / (|g| + eps), a normalised step: where a
  gradient entry is near 0 its relative summation-order error (up to
  ~1e-4 for a sum that cancels) passes into the step almost whole.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (port tests import both frameworks)
import torch

import paddle_tpu as fluid
from paddle_tpu import reader as JR
from paddle_tpu.dataset import ctr as jctr
from paddle_tpu.models import recommender as JRec
from paddle_tpu.models import wide_deep as JW
from paddle_tpu.models import word2vec as JV

import paddle_tpu_torch as pt
from paddle_tpu_torch import reader as PR
from paddle_tpu_torch.dataset import ctr as pctr
from paddle_tpu_torch.models import recommender as PRec
from paddle_tpu_torch.models import wide_deep as PW
from paddle_tpu_torch.models import word2vec as PV

SLOTS, VOCAB, BATCH = 4, 200, 16
OPTS = {
    'sgd': (lambda p: p.optimizer.SGD(0.1), 1e-6),
    'adagrad': (lambda p: p.optimizer.Adagrad(0.05), 2e-4 * 0.05),
    'lazy_adam': (lambda p: p.optimizer.Adam(1e-3, lazy_mode=True),
                  2e-4 * 1e-3),
    'lazy_momentum': (lambda p: p.optimizer.Momentum(0.1, 0.9,
                                                     lazy_mode=True), 1e-6),
}


def _program(pkg, build, opt):
    """(main, startup, cost) of ``build()`` under ``opt`` in fresh
    programs with the reference's names."""
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = 7
    with pkg.program_guard(main, startup):
        cost = build()
        if opt is not None:
            opt(pkg).minimize(cost)
    return main, startup, cost


def _wide_deep(pkg, opt):
    W = JW if pkg is fluid else PW
    return _program(pkg, lambda: W.build(num_slots=SLOTS,
                                         vocab_size=VOCAB)[1], opt)


def ctr_batches(n, seed, batch=BATCH, slots=SLOTS, vocab=VOCAB):
    """Wide&Deep feeds: Zipf(1.3) ids folded onto each table, 13 dense
    features, a click label."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        f = {'C%d' % i: ((rng.zipf(1.3, (batch, 1)) - 1 + 17 * i) % vocab)
             .astype('int64') for i in range(slots)}
        f['dense'] = rng.rand(batch, 13).astype('float32')
        f['label'] = rng.randint(0, 2, (batch, 1)).astype('int64')
        out.append(f)
    return out


def _persistables(program):
    return sorted(v.name for v in program.list_vars()
                  if v.persistable and not v.is_data)


def _pair(build, opt):
    """Both packages' programs, the JAX startup run and its scope copied
    into the port's: (jax (main, cost, exe, scope), port (...))."""
    jm, js, jc = build(fluid, opt)
    pm, ps, pc = build(pt, opt)
    names = _persistables(jm)
    assert _persistables(pm) == names
    jscope, pscope = fluid.Scope(), pt.Scope()
    jexe, pexe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    with fluid.scope_guard(jscope):
        jexe.run(js)
    with pt.scope_guard(pscope):
        pexe.run(ps)
    for n in names:
        pscope.set(n, torch.from_numpy(np.array(jscope.find(n))))
    return (jm, jc, jexe, jscope), (pm, pc, pexe, pscope), names


def _train(side, batches):
    main, cost, exe, scope = side
    pkg = fluid if isinstance(exe, fluid.Executor) else pt
    losses = []
    with pkg.scope_guard(scope):
        for b in batches:
            loss, = exe.run(main, feed=b, fetch_list=[cost])
            losses.append(float(np.asarray(loss).reshape(())))
    return losses


def test_ctr_dataset_matches_reference():
    for split in ('train', 'test'):
        want = list(zip(range(64), getattr(jctr, split)()()))
        got = list(zip(range(64), getattr(pctr, split)()()))
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert a[2] == b[2]


@pytest.mark.parametrize('opt', sorted(OPTS))
def test_wide_deep_matches_reference(opt):
    """5 steps of Wide&Deep (all 8 tables row-sparse) under each
    optimizer: losses and every persistable within the stated tolerance;
    rows no batch fed keep their initial bits in the table and its
    accumulators."""
    make, atol = OPTS[opt]
    jside, pside, names = _pair(_wide_deep, make)
    marker = [op for op in pside[0].global_block().ops
              if op.type == 'backward_marker'][0]
    assert len(marker.attrs['sparse_grads']) == 2 * SLOTS
    before = {n: pside[3].find(n).clone() for n in names}
    batches = ctr_batches(5, seed=1)
    jl, pl = _train(jside, batches), _train(pside, batches)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    for n in names:
        np.testing.assert_allclose(pside[3].find(n).numpy(),
                                   np.asarray(jside[3].find(n)), rtol=1e-5,
                                   atol=atol, err_msg=n)
    for i in range(SLOTS):
        fed = np.zeros(VOCAB, bool)
        for b in batches:
            fed[b['C%d' % i][:, 0]] = True
        assert 0 < fed.sum() < VOCAB
        for n in names:
            if n.startswith(('emb_slot_%d' % i, 'wide_slot_%d' % i)):
                got = pside[3].find(n)
                assert torch.equal(got[~fed], before[n][~fed]), n
                assert not torch.equal(got[fed], before[n][fed]), n


def _recommender(pkg, opt):
    R = JRec if pkg is fluid else PRec
    return _program(pkg, lambda: R.recommender()[1], opt)


def _recommender_batches(n, seed, batch=BATCH):
    rng = np.random.RandomState(seed)
    vocab = {'uid': 944, 'gender': 2, 'age': 7, 'job': 21, 'mov_id': 1683,
             'category': 19}
    out = []
    for _ in range(n):
        f = {k: rng.randint(0, v, (batch, 1)).astype('int64')
             for k, v in vocab.items()}
        f['score'] = (5.0 * rng.rand(batch, 1)).astype('float32')
        out.append(f)
    return out


def _word2vec(pkg, opt):
    V = JV if pkg is fluid else PV
    return _program(pkg, lambda: V.train_program(100, is_sparse=True)[0],
                    opt)


def _word2vec_batches(n, seed, batch=BATCH):
    rng = np.random.RandomState(seed)
    names = ['firstw', 'secondw', 'thirdw', 'fourthw', 'nextw']
    return [{k: rng.randint(0, 100, (batch, 1)).astype('int64')
             for k in names} for _ in range(n)]


@pytest.mark.parametrize('model', ['recommender', 'word2vec'])
def test_embedding_models_match_reference(model):
    """The recommender at its defaults (emb 32, fc 200; cos_sim) and
    word2vec (its shared table takes the dense gradient) over 3 SGD
    steps: losses and every persistable."""
    build, batches = {
        'recommender': (_recommender, _recommender_batches(3, 2)),
        'word2vec': (_word2vec, _word2vec_batches(3, 3))}[model]
    jside, pside, names = _pair(build, lambda p: p.optimizer.SGD(0.2))
    marker = [op for op in pside[0].global_block().ops
              if op.type == 'backward_marker'][0]
    assert marker.attrs['sparse_grads'] == {}
    jl, pl = _train(jside, batches), _train(pside, batches)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    for n in names:
        np.testing.assert_allclose(pside[3].find(n).numpy(),
                                   np.asarray(jside[3].find(n)), rtol=1e-5,
                                   atol=1e-6, err_msg=n)


# ------------------------------------------------------- the example's flow
def _example_reader(pkg):
    R = JR if pkg is fluid else PR
    data = ctr_batches(20, seed=5)
    return R.CheckpointableReader(lambda: iter(data), shuffle_buf=8,
                                  seed=42)


def _port_ctr(opt=lambda p: p.optimizer.SGD(0.1)):
    main, startup, cost = _wide_deep(pt, opt)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup)
    return main, exe, cost


def test_mid_epoch_checkpoint_resumes_bit_for_bit(tmp_path):
    """The CTR example's flow (examples/train_ctr_sparse_resume.py) in the
    port: 12 of 20 batches, a checkpoint with the reader's position, a
    fresh scope and executor, load, the remaining 8: every table equals an
    uninterrupted epoch's bit for bit."""
    scope = pt.Scope()
    with pt.scope_guard(scope):
        main, exe, cost = _port_ctr()
        for b in _example_reader(pt)():
            exe.run(main, feed=b, fetch_list=[cost])
        names = _persistables(main)
        want = {n: scope.find(n).clone() for n in names}

    ckpt = str(tmp_path / 'ckpt')
    with pt.scope_guard(pt.Scope()):
        main, exe, cost = _port_ctr()
        reader = _example_reader(pt)
        gen = reader()
        for i, b in enumerate(gen):
            exe.run(main, feed=b, fetch_list=[cost])
            if i == 11:
                break
        gen.close()
        pt.io.save_checkpoint(exe, ckpt, main_program=main, step=12,
                              reader=reader)
    resumed = pt.Scope()
    with pt.scope_guard(resumed):
        main, exe, cost = _port_ctr()
        reader2 = _example_reader(pt)
        step = pt.io.load_checkpoint(exe, ckpt, main_program=main,
                                     reader=reader2)
        rest = list(reader2())
        assert step == 12 and len(rest) == 8
        for b in rest:
            exe.run(main, feed=b, fetch_list=[cost])
        for n in names:
            assert torch.equal(resumed.find(n), want[n]), n


def test_adagrad_checkpoint_crosses_both_ways(tmp_path):
    """An Adagrad-trained Wide&Deep checkpoint (tables and their
    ``*_moment_acc``) written by either package loads into the other bit
    for bit."""
    adagrad = lambda p: p.optimizer.Adagrad(0.05)   # noqa: E731
    jside, pside, names = _pair(_wide_deep, adagrad)
    assert 'emb_slot_0_moment_acc' in names
    batches = ctr_batches(3, seed=9)
    _train(jside, batches)
    _train(pside, batches)
    for src, dst in ((pside, jside), (jside, pside)):
        sp = pt if src is pside else fluid
        dp = pt if dst is pside else fluid
        path = str(tmp_path / ('from_%s' % sp.__name__))
        with sp.scope_guard(src[3]):
            sp.io.save_checkpoint(src[2], path, main_program=src[0], step=3)
        fresh = dp.Scope()
        with dp.scope_guard(fresh):
            main, startup, _ = _wide_deep(dp, adagrad)
            exe = dp.Executor(dp.CPUPlace())
            exe.run(startup)
            assert dp.io.load_checkpoint(exe, path, main_program=main) == 3
        for n in names:
            np.testing.assert_array_equal(
                np.asarray(fresh.find(n) if dp is fluid
                           else fresh.find(n).numpy()),
                np.asarray(src[3].find(n) if sp is fluid
                           else src[3].find(n).numpy()), err_msg=n)
