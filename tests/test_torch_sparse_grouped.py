"""The grouped row-sparse update in the port: the plain version of the
grouped kernel (sparse_rows_grouped_reference) against the per-table plain
version, and the executor's grouping of a step's sparse update ops
(ops/optimizer_ops.SparseUpdates): one grouped call a step for Wide&Deep's
tables, the same bits as applying each table by hand in op order, the JAX
package's results, and the flush before an op that reads a table (or
writes the beta pows lazy Adam reads) within the same run.

Tolerances, each with its reason:
- the grouped plain version against the per-table one, and the executor's
  grouped step against the hand-rolled per-table application: bit for bit
  (the same operations in the same order; the tables are disjoint);
- Wide&Deep against the JAX package over 3 steps: losses rtol 1e-5, every
  persistable rtol 1e-5 and atol 1e-6 (the MLP's fp32 matmuls sum in
  another order in torch and XLA), or 1e-3 x lr under Adagrad and lazy
  Adam: their normalised first step lr * g / (|g| + eps) carries a
  near-zero gradient entry's summation-order error almost whole, the bound
  chip_smoke.py's phase 15 states for the same update (these batches move
  one Adagrad entry by 3.9e-4 x lr).
"""

import numpy as np
import pytest

import jax  # noqa: F401  (port tests import both frameworks)
import torch

import paddle_tpu as fluid
from paddle_tpu.models import wide_deep as JW

import paddle_tpu_torch as pt
from paddle_tpu_torch.models import wide_deep as PW
from paddle_tpu_torch.ops import optimizer_ops as O
from paddle_tpu_torch.ops.kernels import sparse_rows as S

SLOTS, VOCAB, BATCH = 4, 200, 16
STATE = {'sgd': 0, 'adagrad': 1, 'momentum': 1, 'adam': 2}


# ------------------------------------------- the grouped plain version
def _tables(kind, dtype, seed):
    """Five tables of one kind: dims 16 and 1, one empty, ids past the
    table in two of them, a Zipf head in every other one."""
    rng = np.random.RandomState(seed)
    out = []
    for vocab, dim, n in ((50, 16, 40), (30, 1, 33), (20, 16, 0),
                          (64, 1, 70), (40, 16, 25)):
        ids = ((rng.zipf(1.3, n) - 1) % vocab).astype('int64')
        if n > 30:
            ids[3:6] = vocab + np.arange(3)   # past the table: dropped
        table = torch.from_numpy(rng.randn(vocab, dim).astype('f')).to(dtype)
        rows = torch.from_numpy(rng.randn(n, dim).astype('f')).to(dtype)
        state = [torch.from_numpy(rng.rand(vocab, dim).astype('f'))
                 .to(dtype) for _ in range(STATE[kind])]
        pows = [torch.tensor([0.9 ** 4]), torch.tensor([0.999 ** 4])] \
            if kind == 'adam' else []
        out.append(S.SparseTable(table, rows, torch.from_numpy(ids), state,
                                 pows))
    return out


def _clone(tables):
    return [t._replace(param=t.param.clone(),
                       state=tuple(s.clone() for s in t.state))
            for t in tables]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['fp32', 'bf16'])
@pytest.mark.parametrize('kind', ['sgd', 'adagrad', 'momentum',
                                  'momentum_nesterov', 'adam'])
def test_grouped_reference_equals_per_table(kind, dtype):
    """sparse_rows_grouped_reference and the wrapper on CPU tensors equal
    sparse_rows_reference applied to each table in turn, bit for bit, with
    no launch counted; the empty table and unfed rows keep their bits."""
    nesterov = kind == 'momentum_nesterov'
    kind = 'momentum' if nesterov else kind
    hyper = dict(epsilon=1e-8 if kind == 'adam' else 1e-6, mu=0.9,
                 use_nesterov=nesterov, beta1=0.9, beta2=0.999)
    lr = torch.tensor([0.05])
    start = _tables(kind, dtype, seed=3)
    want = _clone(start)
    for t in want:
        sids, order = S.sort_ids(t.ids)
        S.sparse_rows_reference(kind, t.param, t.rows, sids, order, lr,
                                t.state, t.beta_pows, **hyper)
    launches, tables = S.sparse_rows.launches, S.sparse_rows.tables
    for fn in (S.sparse_rows_grouped_reference, S.sparse_rows_grouped):
        got = _clone(start)
        fn(kind, got, lr, **hyper)
        for g, w, s in zip(got, want, start):
            assert torch.equal(g.param, w.param)
            for a, b in zip(g.state, w.state):
                assert torch.equal(a, b)
            fed = torch.zeros(s.param.shape[0], dtype=torch.bool)
            ids = s.ids[(s.ids >= 0) & (s.ids < s.param.shape[0])]
            fed[ids] = True
            assert torch.equal(g.param[~fed], s.param[~fed])
    assert (S.sparse_rows.launches, S.sparse_rows.tables) == \
        (launches, tables)


def test_grouped_wrapper_refuses_what_the_kernel_does_not_take():
    good = _tables('adam', torch.float32, seed=4)
    lr = torch.tensor([0.1])
    with pytest.raises(ValueError):
        S.sparse_rows_grouped('rmsprop', _clone(good), lr)
    with pytest.raises(ValueError):     # adam without its second moment
        S.sparse_rows_grouped('adam', [good[0]._replace(
            state=good[0].state[:1])], lr)
    with pytest.raises(ValueError):     # ids of another length than rows
        S.sparse_rows_grouped('adam', [good[0]._replace(
            ids=good[0].ids[:-1])], lr)


# -------------------------------------------- the executor's grouping
OPTS = {
    'sgd': (lambda p: p.optimizer.SGD(0.1), 1e-6),
    'adagrad': (lambda p: p.optimizer.Adagrad(0.05), 1e-3 * 0.05),
    'lazy_adam': (lambda p: p.optimizer.Adam(1e-3, lazy_mode=True),
                  1e-3 * 1e-3),
    'lazy_momentum': (lambda p: p.optimizer.Momentum(0.1, 0.9,
                                                     lazy_mode=True), 1e-6),
}


def _wide_deep(pkg, opt):
    W = JW if pkg is fluid else PW
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = 7
    with pkg.program_guard(main, startup):
        cost = W.build(num_slots=SLOTS, vocab_size=VOCAB)[1]
        opt(pkg).minimize(cost)
    return main, startup, cost


def _batches(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        f = {'C%d' % i: ((rng.zipf(1.3, (BATCH, 1)) - 1 + 17 * i) % VOCAB)
             .astype('int64') for i in range(SLOTS)}
        f['dense'] = rng.rand(BATCH, 13).astype('float32')
        f['label'] = rng.randint(0, 2, (BATCH, 1)).astype('int64')
        out.append(f)
    return out


def _persistables(program):
    return sorted(v.name for v in program.list_vars()
                  if v.persistable and not v.is_data)


def _sparse_ops(main):
    """The update ops whose gradient is row-sparse, in program order."""
    block = main.global_block()
    return [op for op in block.ops
            if op.type in ('sgd', 'adagrad', 'momentum', 'adam') and
            getattr(block.var(op.input('Grad')), 'sparse_ids', None)]


def _by_hand(op, block, scope, grads, feed):
    """The op's table and accumulators after applying its gradient rows
    with sparse_rows_reference to copies of the scope's tensors."""
    kind = op.type
    slots = {'sgd': [], 'adagrad': ['Moment'], 'momentum': ['Velocity'],
             'adam': ['Moment1', 'Moment2']}[kind]
    param = scope.find(op.input('Param')).clone()
    state = [scope.find(op.input(s)).clone() for s in slots]
    pows = [scope.find(op.input(b)) for b in ('Beta1Pow', 'Beta2Pow')] \
        if kind == 'adam' else []
    ids = torch.from_numpy(
        feed[block.var(op.input('Grad')).sparse_ids].reshape(-1))
    rows = torch.from_numpy(grads[op.input('Grad')]).reshape(
        ids.shape[0], -1)
    sids, order = S.sort_ids(ids)
    a = op.attrs
    if kind == 'sgd':
        hyper = {}
    elif kind == 'adagrad':
        hyper = dict(epsilon=a['epsilon'])
    elif kind == 'momentum':
        hyper = dict(mu=a['mu'], use_nesterov=bool(a.get('use_nesterov')))
    else:
        hyper = dict(epsilon=a['epsilon'], beta1=a['beta1'],
                     beta2=a['beta2'])
    S.sparse_rows_reference(kind, param, rows, sids, order,
                            scope.find(op.input('LearningRate')), state,
                            pows, **hyper)
    return [param] + state, [op.input('Param')] + \
        [op.input(s) for s in slots]


@pytest.mark.parametrize('opt', sorted(OPTS))
def test_wide_deep_step_is_one_grouped_call(opt, monkeypatch):
    """3 steps of Wide&Deep: each makes exactly one grouped call, holding
    all 2 x SLOTS tables in op order; after each step every table and
    accumulator equals the hand-rolled per-table application of that
    step's gradient rows bit for bit; and the 3 steps agree with the JAX
    package within the stated tolerance."""
    make, atol = OPTS[opt]
    jm, js, jc = _wide_deep(fluid, make)
    pm, ps, pc = _wide_deep(pt, make)
    names = _persistables(jm)
    assert _persistables(pm) == names
    jscope, pscope = fluid.Scope(), pt.Scope()
    jexe, pexe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    with fluid.scope_guard(jscope):
        jexe.run(js)
    for n in names:
        pscope.set(n, torch.from_numpy(np.array(jscope.find(n))))
    ops = _sparse_ops(pm)
    assert len(ops) == 2 * SLOTS
    grad_names = [op.input('Grad') for op in ops]
    calls = []
    real = O.sparse_rows_grouped

    def spy(kind, tables, lr, **hyper):
        calls.append((kind, [t.param for t in tables]))
        return real(kind, tables, lr, **hyper)
    monkeypatch.setattr(O, 'sparse_rows_grouped', spy)
    jl, pl = [], []
    for feed in _batches(3, seed=2):
        with fluid.scope_guard(jscope):
            loss, = jexe.run(jm, feed=feed, fetch_list=[jc])
            jl.append(float(np.asarray(loss).reshape(())))
        with pt.scope_guard(pscope):
            del calls[:]
            grads = pexe.run(pm, feed=feed, fetch_list=[pc] + grad_names)
            assert len(calls) == 1
            assert calls[0][0] == ops[0].type
            assert [p.data_ptr() for p in calls[0][1]] == \
                [pscope.find(op.input('Param')).data_ptr() for op in ops]
            pl.append(float(np.asarray(grads[0]).reshape(())))
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    for n in names:
        np.testing.assert_allclose(pscope.find(n).numpy(),
                                   np.asarray(jscope.find(n)), rtol=1e-5,
                                   atol=atol, err_msg=n)


@pytest.mark.parametrize('opt', sorted(OPTS))
def test_grouped_step_equals_per_table_by_hand(opt):
    """Each of 3 Wide&Deep steps: every table and accumulator after the
    executor's grouped step equals sparse_rows_reference applied by hand,
    table by table in op order, to the state before the step (with the
    beta pows before their update), bit for bit."""
    make, _ = OPTS[opt]
    pm, ps, pc = _wide_deep(pt, make)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        exe.run(ps)
        ops = _sparse_ops(pm)
        grad_names = [op.input('Grad') for op in ops]
        block = pm.global_block()
        for feed in _batches(3, seed=5):
            before = {n: scope.find(n).clone() for n in _persistables(pm)}
            out = exe.run(pm, feed=feed, fetch_list=grad_names)
            after = {n: scope.find(n).clone() for n in before}
            for n, v in before.items():
                scope.find(n).copy_(v)
            grads = dict(zip(grad_names, out))
            for op in ops:
                want, names = _by_hand(op, block, scope, grads, feed)
                for w, n in zip(want, names):
                    assert torch.equal(after[n], w), n
            for n, v in after.items():
                scope.find(n).copy_(v)


def _sgd_program(reader):
    """A sparse sgd op on the table 'w' (dim 4, 12 rows) followed by
    ``reader``, an op appended to the same block."""
    prog = pt.Program()
    b = prog.global_block()
    b.create_var(name='ids', shape=(-1, 1), dtype='int64', is_data=True)
    b.create_var(name='w', shape=(12, 4), dtype='float32', persistable=True)
    g = b.create_var(name='w@GRAD', shape=(-1, 4), dtype='float32')
    g.sparse_ids = 'ids'
    b.create_var(name='lr', shape=(1,), dtype='float32', persistable=True)
    b.append_op(type='sgd', inputs={'Param': ['w'], 'Grad': ['w@GRAD'],
                                    'LearningRate': ['lr']},
                outputs={'ParamOut': ['w']})
    reader(b)
    return prog


def test_an_op_reading_the_table_sees_the_update():
    """An op that reads the table after its sparse update within the same
    run sees the updated rows: the held update is applied first."""
    def reader(b):
        b.create_var(name='w2', shape=(12, 4), dtype='float32')
        b.append_op(type='scale', inputs={'X': ['w']},
                    outputs={'Out': ['w2']}, attrs={'scale': 2.0})
    prog = _sgd_program(reader)
    rng = np.random.RandomState(6)
    w0 = rng.randn(12, 4).astype('f')
    ids = np.array([[3], [5], [3], [15]], 'int64')
    rows = rng.randn(4, 4).astype('f')
    scope = pt.Scope()
    scope.set('w', torch.from_numpy(w0.copy()))
    scope.set('lr', torch.tensor([0.5]))
    with pt.scope_guard(scope):
        w2, = pt.Executor(pt.CPUPlace()).run(
            prog, feed={'ids': ids, 'w@GRAD': rows}, fetch_list=['w2'])
    want = torch.from_numpy(w0.copy())
    S.sparse_rows_reference('sgd', want, torch.from_numpy(rows),
                            *S.sort_ids(torch.from_numpy(ids[:, 0])),
                            torch.tensor([0.5]))
    assert torch.equal(scope.find('w'), want)
    np.testing.assert_array_equal(w2, 2.0 * want.numpy())
    assert not np.array_equal(want.numpy(), w0)


def test_lazy_adam_reads_the_beta_pows_before_their_update():
    """Lazy Adam's sparse update reads Beta1Pow and Beta2Pow before the
    adam_beta_pow_update op that follows it in the same run writes them
    in place: the table equals the update at the old pows bit for bit
    (and not at the new ones), and the pows advance once."""
    prog = pt.Program()
    b = prog.global_block()
    b.create_var(name='ids', shape=(-1, 1), dtype='int64', is_data=True)
    for n, shape in (('w', (12, 4)), ('m1', (12, 4)), ('m2', (12, 4)),
                     ('lr', (1,)), ('b1p', (1,)), ('b2p', (1,))):
        b.create_var(name=n, shape=shape, dtype='float32', persistable=True)
    g = b.create_var(name='w@GRAD', shape=(-1, 4), dtype='float32')
    g.sparse_ids = 'ids'
    b.append_op(type='adam',
                inputs={'Param': ['w'], 'Grad': ['w@GRAD'],
                        'Moment1': ['m1'], 'Moment2': ['m2'],
                        'Beta1Pow': ['b1p'], 'Beta2Pow': ['b2p'],
                        'LearningRate': ['lr']},
                outputs={'ParamOut': ['w'], 'Moment1Out': ['m1'],
                         'Moment2Out': ['m2']},
                attrs={'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8})
    b.append_op(type='adam_beta_pow_update',
                inputs={'Beta1Pow': ['b1p'], 'Beta2Pow': ['b2p']},
                outputs={'Beta1PowOut': ['b1p'], 'Beta2PowOut': ['b2p']},
                attrs={'beta1': 0.9, 'beta2': 0.999})
    rng = np.random.RandomState(7)
    init = {'w': rng.randn(12, 4), 'm1': rng.rand(12, 4),
            'm2': rng.rand(12, 4), 'lr': [0.01], 'b1p': [0.9 ** 2],
            'b2p': [0.999 ** 2]}
    init = {k: np.asarray(v, 'f') for k, v in init.items()}
    ids = np.array([[1], [4], [1], [1], [9]], 'int64')
    rows = rng.randn(5, 4).astype('f')
    scope = pt.Scope()
    for k, v in init.items():
        scope.set(k, torch.from_numpy(v.copy()))
    with pt.scope_guard(scope):
        pt.Executor(pt.CPUPlace()).run(
            prog, feed={'ids': ids, 'w@GRAD': rows})
    ends = []
    for pows in ((init['b1p'], init['b2p']),
                 (init['b1p'] * np.float32(0.9),
                  init['b2p'] * np.float32(0.999))):
        w, m1, m2 = (torch.from_numpy(init[k].copy())
                     for k in ('w', 'm1', 'm2'))
        S.sparse_rows_reference(
            'adam', w, torch.from_numpy(rows),
            *S.sort_ids(torch.from_numpy(ids[:, 0])),
            torch.from_numpy(init['lr']), [m1, m2],
            [torch.from_numpy(p) for p in pows], epsilon=1e-8)
        ends.append(w)
    assert torch.equal(scope.find('w'), ends[0])
    assert not torch.equal(ends[0], ends[1])
    np.testing.assert_array_equal(scope.find('b1p').numpy(),
                                  init['b1p'] * np.float32(0.9))
