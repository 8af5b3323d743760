"""Row-sparse embedding gradients in the port against the JAX package:
which tables take them (core/backward.py _sparse_grad_lookups, case by
case, and across Program.clone), the sparse branches of sgd, momentum,
adam and adagrad against the JAX lowerings (duplicate ids, ids past the
table, padding_idx; fp32 and bf16 tables), the sparse_rows kernel's plain
version against the
JAX package's _merge_duplicate_rows plus each update, the eight dense
optimizer ops and the optimizer classes over 3 steps, cos_sim, and on the
CPU path: a sparse table is no autograd leaf, its @GRAD is [n_ids, dim]
and no table-sized tensor is made.

Tolerances, each with its reason:
- the sparse updates at the op level: 2 fp32 ulp of the value (rtol 2.4e-7
  on top of atol 1e-7 for values near 0). Both sum a run's rows in sorted
  order and apply the reference's formulas op for op, but XLA may fuse and
  reorder a few fp32 operations;
- sparse_rows_reference against the JAX merge plus update: the same bound;
- bf16 tables: sgd bit for bit, the others within 2^-5 of the largest
  value (the JAX package rounds every intermediate to bf16, the port each
  stored value once);
- the dense ops over 3 steps and the optimizer classes: rtol 1e-5, atol
  1e-6 (torch and XLA evaluate pow, sqrt and division chains with
  different fusion; 3 steps compound them);
- cos_sim: rtol 1e-6 (two fp32 reductions over 32 elements in another
  order).
"""

import numpy as np
import pytest

import jax  # noqa: F401  (port tests import both frameworks)
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as fluid
from paddle_tpu import ops as _jops  # noqa: F401  (registers lowerings)
from paddle_tpu.core import registry as jreg
from paddle_tpu.models import wide_deep as JW
from paddle_tpu.models import word2vec as JV
from paddle_tpu.ops.optimizer_ops import _merge_duplicate_rows

import paddle_tpu_torch as pt
from paddle_tpu_torch import ops as _pops  # noqa: F401
from paddle_tpu_torch.core import registry as preg
from paddle_tpu_torch.models import wide_deep as PW
from paddle_tpu_torch.models import word2vec as PV
from paddle_tpu_torch.ops.kernels import sparse_rows as S

PKGS = {'jax': fluid, 'port': pt}
OP_RTOL, OP_ATOL = 2.4e-7, 1e-7


# ------------------------------------------------------------- eligibility
def _wide_deep(pkg, opt, clone=False, **kw):
    """Wide&Deep at 4 slots x 200 rows; ``clone``: the model's program is
    cloned before minimize runs on the clone."""
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        W = JW if pkg is fluid else PW
        _, cost, _, _ = W.build(num_slots=4, vocab_size=200, **kw)
        if clone:
            main = main.clone()
            cost = main.global_block().var(cost.name)
        with pkg.program_guard(main, startup):
            opt(pkg).minimize(cost)
    return main


def _marker(program):
    return [op for op in program.global_block().ops
            if op.type == 'backward_marker'][0]


def _case(name):
    """The function that makes each eligibility case's program, given a
    package."""
    sgd = lambda p: p.optimizer.SGD(0.1)       # noqa: E731
    cases = {
        'wide_deep_sgd': lambda p: _wide_deep(p, sgd),
        'wide_deep_adagrad': lambda p: _wide_deep(
            p, lambda q: q.optimizer.Adagrad(0.05)),
        'wide_deep_lazy_adam': lambda p: _wide_deep(
            p, lambda q: q.optimizer.Adam(1e-3, lazy_mode=True)),
        'wide_deep_lazy_momentum': lambda p: _wide_deep(
            p, lambda q: q.optimizer.Momentum(0.1, 0.9, lazy_mode=True)),
        'wide_deep_adam_not_lazy': lambda p: _wide_deep(
            p, lambda q: q.optimizer.Adam(1e-3)),
        'wide_deep_momentum_not_lazy': lambda p: _wide_deep(
            p, lambda q: q.optimizer.Momentum(0.1, 0.9)),
        'wide_deep_optimizer_regularization': lambda p: _wide_deep(
            p, lambda q: q.optimizer.SGD(
                0.1, regularization=q.regularizer.L2Decay(1e-4))),
        'wide_deep_cloned': lambda p: _wide_deep(p, sgd, clone=True),
        'word2vec_shared_table': _word2vec,
        'regularized_table': lambda p: _one_table(p, 'regularizer'),
        'clipped_table': lambda p: _one_table(p, 'gradient_clip'),
        'program_clip': lambda p: _one_table(p, 'program_clip'),
        'ids_not_data': lambda p: _one_table(p, 'computed_ids'),
    }
    return cases[name]


def _word2vec(pkg):
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        V = JV if pkg is fluid else PV
        cost, _ = V.train_program(100, is_sparse=True)
        pkg.optimizer.SGD(0.1).minimize(cost)
    return main


def _one_table(pkg, what):
    """One is_sparse table and one plain one, the first made ineligible by
    ``what``."""
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        ids = pkg.layers.data(name='ids', shape=[1], dtype='int64')
        y = pkg.layers.data(name='y', shape=[1], dtype='float32')
        kw = {}
        if what == 'regularizer':
            kw['regularizer'] = pkg.regularizer.L2Decay(1e-3)
        if what == 'gradient_clip':
            kw['gradient_clip'] = pkg.clip.GradientClipByValue(1.0)
        look = ids
        if what == 'computed_ids':
            look = pkg.layers.scale(ids, scale=1.0)
        a = pkg.layers.embedding(look, size=[50, 4], is_sparse=True,
                                 param_attr=pkg.ParamAttr(name='a', **kw))
        b = pkg.layers.embedding(ids, size=[50, 4], is_sparse=True,
                                 param_attr=pkg.ParamAttr(name='b'))
        pred = pkg.layers.fc(input=pkg.layers.concat([a, b], axis=-1),
                             size=1)
        cost = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        if what == 'program_clip':
            pkg.clip.set_gradient_clip(
                pkg.clip.GradientClipByGlobalNorm(1.0), program=main)
        pkg.optimizer.SGD(0.1).minimize(cost)
    return main


CASES = ['wide_deep_sgd', 'wide_deep_adagrad', 'wide_deep_lazy_adam',
         'wide_deep_lazy_momentum', 'wide_deep_adam_not_lazy',
         'wide_deep_momentum_not_lazy',
         'wide_deep_optimizer_regularization', 'wide_deep_cloned',
         'word2vec_shared_table', 'regularized_table', 'clipped_table',
         'program_clip', 'ids_not_data']
WANT_TABLES = {'wide_deep_sgd': 8, 'wide_deep_adagrad': 8,
               'wide_deep_lazy_adam': 8, 'wide_deep_lazy_momentum': 8,
               'wide_deep_cloned': 8, 'regularized_table': 1,
               'clipped_table': 1, 'ids_not_data': 1}


@pytest.mark.parametrize('case', CASES)
def test_sparse_eligibility_matches_reference(case):
    """The marker's sparse_grads and every grad var's sparse_ids equal the
    JAX package's on the same model and optimizer."""
    got = {}
    for key, pkg in PKGS.items():
        prog = _case(case)(pkg)
        marker = _marker(prog)
        block = prog.global_block()
        got[key] = (marker.attrs['sparse_grads'],
                    {g: getattr(block.var(g), 'sparse_ids', None)
                     for g in marker.attrs['grad_names']})
    assert got['port'] == got['jax']
    assert len(got['port'][0]) == WANT_TABLES.get(case, 0)


def test_clone_keeps_the_sparse_annotations():
    """Program.clone carries sparse_grad (the table's flag) and sparse_ids
    (its gradient's Ids) as the reference's clone does: a program cloned
    before or after minimize keeps the sparse path."""
    for pkg in (fluid, pt):
        before = _wide_deep(pkg, lambda q: q.optimizer.SGD(0.1), clone=True)
        assert len(_marker(before).attrs['sparse_grads']) == 8
        after = _wide_deep(pkg, lambda q: q.optimizer.SGD(0.1)).clone()
        blk = after.global_block()
        assert blk.var('emb_slot_0').sparse_grad is True
        assert blk.var('emb_slot_0@GRAD').sparse_ids == 'C0'
        assert blk.var('wide_slot_3@GRAD').sparse_ids == 'C3'


# --------------------------------------------------------- op-level updates
def _op_program(pkg, kind, vocab, dim, nesterov=False):
    """A program holding one update op of ``kind`` over a table whose Grad
    carries sparse_ids='ids'."""
    prog = pkg.Program()
    b = prog.global_block()
    b.create_var(name='ids', shape=(-1, 1), dtype='int64', is_data=True)
    b.create_var(name='w', shape=(vocab, dim), dtype='float32',
                 persistable=True)
    g = b.create_var(name='w@GRAD', shape=(-1, dim), dtype='float32')
    g.sparse_ids = 'ids'
    b.create_var(name='lr', shape=(1,), dtype='float32', persistable=True)
    inputs = {'Param': ['w'], 'Grad': ['w@GRAD'], 'LearningRate': ['lr']}
    outputs = {'ParamOut': ['w']}
    attrs = {}
    slots = {'momentum': [('Velocity', 'VelocityOut')],
             'adagrad': [('Moment', 'MomentOut')],
             'adam': [('Moment1', 'Moment1Out'), ('Moment2', 'Moment2Out')],
             'sgd': []}[kind]
    for i, o in slots:
        b.create_var(name=i, shape=(vocab, dim), dtype='float32',
                     persistable=True)
        inputs[i] = [i]
        outputs[o] = [i]
    if kind == 'adam':
        for n in ('b1p', 'b2p'):
            b.create_var(name=n, shape=(1,), dtype='float32',
                         persistable=True)
        inputs['Beta1Pow'] = ['b1p']
        inputs['Beta2Pow'] = ['b2p']
        attrs = {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8}
    if kind == 'momentum':
        attrs = {'mu': 0.9, 'use_nesterov': nesterov}
    if kind == 'adagrad':
        attrs = {'epsilon': 1e-6}
    op = b.append_op(type=kind, inputs=inputs, outputs=outputs, attrs=attrs)
    return prog, op, [o for o, _ in slots]


def _run_op(pkg, kind, arrays, vocab, dim, nesterov=False, bf16=False):
    """One update op through ``pkg``'s lowering; the table, its gradient
    and accumulators in bf16 where ``bf16``. Returns them as fp32 numpy."""
    prog, op, state = _op_program(pkg, kind, vocab, dim, nesterov)
    block = prog.global_block()
    table = ['w', 'w@GRAD'] + state
    if bf16:
        for n in table:
            block.var(n).dtype = 'bfloat16'
    if pkg is fluid:
        env = {k: jnp.asarray(v) for k, v in arrays.items()}
        env['ids'] = env['ids'].astype(jnp.int32)
        for n in table if bf16 else ():
            env[n] = env[n].astype(jnp.bfloat16)
        jreg.get_lowering(kind)(jreg.LoweringContext(env, op, block, 0,
                                                     None))
        return [np.asarray(env[n].astype(jnp.float32))
                for n in ['w'] + state]
    env = {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}
    for n in table if bf16 else ():
        env[n] = env[n].to(torch.bfloat16)
    preg.get_lowering(kind)(preg.LoweringContext(env, op, block, 0,
                                                 torch.device('cpu')))
    return [env[n].float().numpy() for n in ['w'] + state]


def _op_inputs(kind, vocab, dim, seed):
    rng = np.random.RandomState(seed)
    n = 24
    ids = rng.randint(0, vocab, (n, 1)).astype('int64')
    ids[:5] = 3                  # a run of duplicates
    ids[5:7] = vocab + 2         # past the table: dropped
    ids[7] = vocab - 1
    arrays = {'ids': ids,
              'w': rng.randn(vocab, dim).astype('f'),
              'w@GRAD': rng.randn(n, dim).astype('f'),
              'lr': np.array([0.05], 'f')}
    for name in {'momentum': ['Velocity'], 'adagrad': ['Moment'],
                 'adam': ['Moment1', 'Moment2'], 'sgd': []}[kind]:
        arrays[name] = rng.rand(vocab, dim).astype('f')
    if kind == 'adam':
        arrays['b1p'] = np.array([0.9 ** 3], 'f')
        arrays['b2p'] = np.array([0.999 ** 3], 'f')
    return arrays


@pytest.mark.parametrize('dim', [1, 16])
@pytest.mark.parametrize('kind', ['sgd', 'adagrad', 'momentum',
                                  'momentum_nesterov', 'adam'])
def test_sparse_update_op_matches_jax_lowering(kind, dim):
    """One sparse update through each package's lowering: duplicate ids
    merge, ids past the table drop, untouched rows keep their bits."""
    nesterov = kind == 'momentum_nesterov'
    kind = 'momentum' if nesterov else kind
    vocab = 40
    arrays = _op_inputs(kind, vocab, dim, seed=dim)
    want = _run_op(fluid, kind, arrays, vocab, dim, nesterov)
    got = _run_op(pt, kind, arrays, vocab, dim, nesterov)
    touched = np.zeros(vocab, bool)
    ids = arrays['ids'][:, 0]
    touched[ids[ids < vocab]] = True
    state = {'momentum': ['Velocity'], 'adagrad': ['Moment'],
             'adam': ['Moment1', 'Moment2'], 'sgd': []}[kind]
    for name, g, w in zip(['w'] + state, got, want):
        np.testing.assert_allclose(g, w, rtol=OP_RTOL, atol=OP_ATOL,
                                   err_msg=name)
        np.testing.assert_array_equal(g[~touched], arrays[name][~touched])
        assert not np.array_equal(g[touched], arrays[name][touched])


@pytest.mark.parametrize('dim', [1, 16])
@pytest.mark.parametrize('kind', ['sgd', 'adagrad', 'momentum', 'adam'])
def test_sparse_update_op_on_bf16_tables(kind, dim):
    """bf16 tables (with bf16 accumulators and gradient rows). sgd is bit
    for bit: each occurrence's step is rounded to bf16 and added in bf16,
    as the reference's scatter-add does. The others: the JAX package
    rounds every intermediate of the update to bf16 (the merged sum, the
    moments, the step), the port computes them in fp32 and rounds each
    stored delta and value once, so the two agree within 2^-5 of the
    largest value (4 bf16 steps of it)."""
    vocab = 40
    arrays = _op_inputs(kind, vocab, dim, seed=20 + dim)
    want = _run_op(fluid, kind, arrays, vocab, dim, bf16=True)
    got = _run_op(pt, kind, arrays, vocab, dim, bf16=True)
    for g, w in zip(got, want):
        if kind == 'sgd':
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(
                g, w, rtol=0, atol=2.0 ** -5 * float(np.abs(w).max()))


@pytest.mark.parametrize('dim', [1, 16])
@pytest.mark.parametrize('kind', ['sgd', 'adagrad', 'momentum', 'adam'])
def test_sparse_rows_reference_matches_merge_and_update(kind, dim):
    """The kernel's plain version against the JAX package's
    _merge_duplicate_rows followed by the sparse branch's formulas, written
    here with jnp as the reference writes them."""
    vocab = 60
    arrays = _op_inputs(kind, vocab, dim, seed=10 + dim)
    flat = arrays['ids'][:, 0]
    rows = arrays['w@GRAD']
    lr = 0.05
    state = {'momentum': ['Velocity'], 'adagrad': ['Moment'],
             'adam': ['Moment1', 'Moment2'], 'sgd': []}[kind]
    p = jnp.asarray(arrays['w'])
    st = [jnp.asarray(arrays[n]) for n in state]
    jflat = jnp.asarray(flat.astype('int32'))
    if kind == 'sgd':
        want = [p.at[jflat].add(-lr * jnp.asarray(rows), mode='drop')]
    else:
        rep, merged, valid = _merge_duplicate_rows(jflat, jnp.asarray(rows))
        v = valid[:, None]
        old = [jnp.take(s, rep, axis=0) for s in st]
        if kind == 'adagrad':
            new = [old[0] + jnp.square(merged)]
            dp = lr * merged / (jnp.sqrt(new[0]) + 1e-6)
        elif kind == 'momentum':
            new = [0.9 * old[0] + merged]
            dp = lr * new[0]
        else:
            new = [0.9 * old[0] + (1.0 - 0.9) * merged,
                   0.999 * old[1] + (1.0 - 0.999) * jnp.square(merged)]
            lr_t = lr * jnp.sqrt(1.0 - jnp.float32(0.999 ** 3)) / \
                (1.0 - jnp.float32(0.9 ** 3))
            dp = lr_t * new[0] / (jnp.sqrt(new[1]) + 1e-8)
        want = [p.at[rep].add(-jnp.where(v, dp, 0.0), mode='drop')]
        want += [s.at[rep].add(jnp.where(v, nv - o, 0.0), mode='drop')
                 for s, o, nv in zip(st, old, new)]
    tp = torch.from_numpy(arrays['w'].copy())
    ts = [torch.from_numpy(arrays[n].copy()) for n in state]
    sids, order = S.sort_ids(torch.from_numpy(flat))
    pows = (torch.tensor([0.9 ** 3]), torch.tensor([0.999 ** 3])) \
        if kind == 'adam' else ()
    S.sparse_rows_reference(kind, tp, torch.from_numpy(rows), sids, order,
                            torch.tensor([lr]), ts, pows, epsilon=1e-8
                            if kind == 'adam' else 1e-6)
    for g, w in zip([tp] + ts, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=OP_RTOL,
                                   atol=OP_ATOL)


def test_sparse_rows_wrapper_takes_the_plain_version_only_on_the_host():
    """On CPU tensors the wrapper is the plain version (no launch counted);
    it refuses what the kernel does not take."""
    before = S.sparse_rows.launches
    p = torch.zeros(10, 3)
    S.sparse_rows('sgd', p, torch.ones(4, 3), *S.sort_ids(
        torch.tensor([2, 2, 11, 5])), torch.tensor([1.0]))
    assert S.sparse_rows.launches == before
    np.testing.assert_array_equal(p[2].numpy(), [-2.0] * 3)
    np.testing.assert_array_equal(p[5].numpy(), [-1.0] * 3)
    assert float(p.abs().sum()) == 9.0
    with pytest.raises(ValueError):
        S.sparse_rows('adam', p, torch.ones(4, 3), *S.sort_ids(
            torch.tensor([2, 2, 1, 5])), torch.tensor([1.0]))
    with pytest.raises(ValueError):
        S.sparse_rows('rmsprop', p, torch.ones(4, 3), *S.sort_ids(
            torch.tensor([2, 2, 1, 5])), torch.tensor([1.0]))


# ------------------------------------------------------ dense ops, classes
def _mlp(pkg, opt):
    """A 2-layer MLP on 8 features under ``opt``, in a fresh program."""
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = 3
    with pkg.program_guard(main, startup):
        x = pkg.layers.data(name='x', shape=[8], dtype='float32')
        y = pkg.layers.data(name='y', shape=[1], dtype='float32')
        h = pkg.layers.fc(input=x, size=16, act='tanh')
        pred = pkg.layers.fc(input=h, size=1)
        cost = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        opt(pkg).minimize(cost)
    return main, startup, cost


DENSE_OPTS = {
    'adagrad': lambda p: p.optimizer.Adagrad(0.1),
    'adamax': lambda p: p.optimizer.Adamax(0.01),
    'decayed_adagrad': lambda p: p.optimizer.DecayedAdagrad(0.05),
    'adadelta': lambda p: p.optimizer.Adadelta(1.0, rho=0.9),
    'rmsprop': lambda p: p.optimizer.RMSProp(0.01, momentum=0.5),
    'ftrl': lambda p: p.optimizer.Ftrl(0.1, l1=0.01, l2=0.01),
    'proximal_adagrad': lambda p: p.optimizer.ProximalAdagrad(
        0.1, l1=0.001, l2=0.01),
}


def _copy_scope(jscope, pscope, program):
    for v in program.list_vars():
        if v.persistable and not v.is_data:
            pscope.set(v.name, torch.from_numpy(
                np.array(jscope.find(v.name))))


@pytest.mark.parametrize('name', sorted(DENSE_OPTS))
def test_dense_optimizer_matches_reference_over_three_steps(name):
    """Each optimizer class (and its dense op; Adamax also beta_pow_update)
    trains the same MLP from the same weights in both packages for 3
    steps: losses, parameters and accumulators (same names) agree."""
    jm, js, jc = _mlp(fluid, DENSE_OPTS[name])
    pm, ps, pc = _mlp(pt, DENSE_OPTS[name])
    jnames = sorted(v.name for v in jm.list_vars() if v.persistable)
    assert sorted(v.name for v in pm.list_vars() if v.persistable) == jnames
    jscope, pscope = fluid.Scope(), pt.Scope()
    jexe, pexe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    with fluid.scope_guard(jscope):
        jexe.run(js)
    with pt.scope_guard(pscope):
        pexe.run(ps)
    _copy_scope(jscope, pscope, pm)
    rng = np.random.RandomState(4)
    for _ in range(3):
        feed = {'x': rng.randn(16, 8).astype('f'),
                'y': rng.randn(16, 1).astype('f')}
        with fluid.scope_guard(jscope):
            jl, = jexe.run(jm, feed=feed, fetch_list=[jc])
        with pt.scope_guard(pscope):
            pl, = pexe.run(pm, feed=feed, fetch_list=[pc])
        np.testing.assert_allclose(pl, np.asarray(jl), rtol=1e-5, atol=1e-6)
    for n in jnames:
        np.testing.assert_allclose(pscope.find(n).numpy(),
                                   np.asarray(jscope.find(n)), rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def test_proximal_gd_op_matches_jax_lowering():
    """proximal_gd (an op with no optimizer class) over 3 steps."""
    rng = np.random.RandomState(6)
    w = rng.randn(5, 4).astype('f')
    jw, tw = w.copy(), w.copy()
    for _ in range(3):
        g = rng.randn(5, 4).astype('f')
        for pkg in (fluid, pt):
            prog = pkg.Program()
            b = prog.global_block()
            for n, shape in (('w', (5, 4)), ('g', (5, 4)), ('lr', (1,))):
                b.create_var(name=n, shape=shape, dtype='float32')
            op = b.append_op(type='proximal_gd',
                             inputs={'Param': ['w'], 'Grad': ['g'],
                                     'LearningRate': ['lr']},
                             outputs={'ParamOut': ['w']},
                             attrs={'l1': 0.05, 'l2': 0.1})
            if pkg is fluid:
                env = {'w': jnp.asarray(jw), 'g': jnp.asarray(g),
                       'lr': jnp.asarray([0.1], jnp.float32)}
                jreg.get_lowering('proximal_gd')(
                    jreg.LoweringContext(env, op, b, 0, None))
                jw = np.asarray(env['w'])
            else:
                env = {'w': torch.from_numpy(tw.copy()),
                       'g': torch.from_numpy(g), 'lr': torch.tensor([0.1])}
                preg.get_lowering('proximal_gd')(preg.LoweringContext(
                    env, op, b, 0, torch.device('cpu')))
                tw = env['w'].numpy()
    np.testing.assert_allclose(tw, jw, rtol=1e-6, atol=1e-7)


def test_cos_sim_matches_reference():
    rng = np.random.RandomState(8)
    x = rng.randn(6, 32).astype('f')
    y = rng.randn(6, 32).astype('f')
    y[2] = 0.0                       # a zero row: 0 / 1e-12
    outs = []
    for pkg in (fluid, pt):
        pkg.reset_default_programs()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            a = pkg.layers.data(name='a', shape=[32], dtype='float32')
            b = pkg.layers.data(name='b', shape=[32], dtype='float32')
            out = pkg.layers.cos_sim(X=a, Y=b)
        exe = pkg.Executor(pkg.CPUPlace())
        res, = exe.run(main, feed={'a': x, 'b': y}, fetch_list=[out])
        outs.append(np.asarray(res))
    assert outs[1].shape == (6, 1)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------- the CPU path
class _Allocations(TorchDispatchMode):
    """Records the shape and address of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(t, torch.Tensor):
                self.shapes.append((tuple(t.shape), t.data_ptr()))
        return out


def _one_lookup(pkg, is_sparse, vocab=5000, dim=16):
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        ids = pkg.layers.data(name='ids', shape=[1], dtype='int64')
        y = pkg.layers.data(name='y', shape=[1], dtype='float32')
        emb = pkg.layers.embedding(ids, size=[vocab, dim],
                                   is_sparse=is_sparse, padding_idx=0,
                                   param_attr=pkg.ParamAttr(name='t'))
        pred = pkg.layers.fc(input=emb, size=1)
        cost = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.Adagrad(0.1).minimize(cost)
    return main, startup, cost


@pytest.mark.parametrize('is_sparse', [True, False])
def test_cpu_step_binds_row_gradients_and_makes_no_table_sized_tensor(
        is_sparse):
    """On the CPU path a sparse table is no leaf (the scope tensor never
    requires grad), its @GRAD is [n_ids, dim] with padding rows 0, and no
    op of the step makes a tensor of the table's size; the dense table's
    @GRAD is [vocab, dim]."""
    vocab, dim, n = 5000, 16, 16
    main, startup, cost = _one_lookup(pt, is_sparse, vocab, dim)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    rng = np.random.RandomState(2)
    ids = rng.randint(1, vocab, (n, 1)).astype('int64')
    ids[:3] = 0                                  # padding_idx
    ids[3:6] = 9                                 # duplicates
    feed = {'ids': ids, 'y': rng.randn(n, 1).astype('f')}
    with pt.scope_guard(scope):
        exe.run(startup)
        with _Allocations() as rec:
            loss, grad = exe.run(main, feed=feed,
                                 fetch_list=[cost, 't@GRAD'])
        table = scope.find('t')
        state = {scope.find(v.name).data_ptr() for v in main.list_vars()
                 if v.persistable and not v.is_data}
    assert not table.requires_grad and table.grad is None
    # a table-sized tensor that is not the scope's own (an in-place update
    # returns the table or its accumulator itself)
    big = [s for s, ptr in rec.shapes
           if int(np.prod(s)) >= vocab * dim and ptr not in state]
    if is_sparse:
        assert grad.shape == (n, dim)
        np.testing.assert_array_equal(grad[:3], 0.0)
        assert np.abs(grad[3:]).sum() > 0
        assert big == [], big
    else:
        assert grad.shape == (vocab, dim)
        assert (vocab, dim) in big


def test_sparse_ids_outlive_their_lookup_in_the_plan():
    """The executor's plan frees each value after its last reader; the
    Ids of a row-sparse gradient are read by the update op through the
    gradient var, so they live until that op."""
    from paddle_tpu_torch.core.executor import _Plan, _prune_ops
    main, _, cost = _one_lookup(pt, True)
    block = main.global_block()
    ops = _prune_ops(block, list(block.ops), [cost.name])
    plan = _Plan(block, ops, ['ids', 'y'], [cost.name])
    freed_at = [i for i, names in plan.frees.items() if 'ids' in names]
    update = [i for i, op in enumerate(ops) if op.type == 'adagrad' and
              op.input('Param') == 't']
    assert freed_at == update
