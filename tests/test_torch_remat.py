"""memory_optimize's rematerialising backward, port vs reference.

``memory_optimize`` sets the program's remat policy (the reference's
levels, policies and errors) and the Executor runs the forward section as
one torch.utils.checkpoint function: under every policy the losses and
every scope variable after 3 steps equal the run without remat bit for bit
(the same ops recomputed on the same inputs), on fit_a_line (the
reference's tests/test_aux.py program), a tiny Transformer (dropout 0.1,
unrolled and scan_layers), Wide&Deep with row-sparse gradients and the
MoE LM; the forward really runs again in the backward ('full' recomputes
the matmuls, 'dots_saveable' keeps them); and the losses equal the
reference's remat run within rtol 1e-5.
"""

import weakref

import numpy as np
import pytest

import jax  # noqa: F401  (port tests import both frameworks)
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import paddle_tpu as fluid

import paddle_tpu_torch as pt
from paddle_tpu_torch.weights import load_into_scope

POLICIES = ['full', 'dots_saveable', 'nothing_saveable']


def test_policies_and_levels_as_the_reference():
    """REMAT_POLICIES, level 0 / 1, 'none', an unknown policy raising, and
    release_memory at the top level returning its program."""
    import importlib
    pm = importlib.import_module('paddle_tpu_torch.memory_optimize')
    jm = importlib.import_module('paddle_tpu.memory_optimize')
    assert pm.REMAT_POLICIES == jm.REMAT_POLICIES
    for kw, want in ((dict(level=0), 'dots_saveable'),
                     (dict(level=1), 'full'),
                     (dict(policy='nothing_saveable'), 'nothing_saveable'),
                     (dict(policy='none'), None)):
        for pkg in (pt, fluid):
            prog = pkg.Program()
            assert pkg.memory_optimize(prog, **kw) is prog
            assert prog.remat_policy == want, (pkg.__name__, kw)
    with pytest.raises(ValueError, match='unknown remat policy'):
        pt.memory_optimize(pt.Program(), policy='some')
    prog = pt.Program()
    assert pt.release_memory(prog) is prog
    assert pt.Program().remat_policy is None
    assert pt.Program().clone().remat_policy is None


def _fit_a_line(pkg):
    """tests/test_aux.py's remat program: x [8] -> fc(16, relu) -> fc(1)
    -> mean square error, SGD(0.1)."""
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data(name='x', shape=[8], dtype='float32')
        y = pkg.layers.data(name='y', shape=[1], dtype='float32')
        h = pkg.layers.fc(input=x, size=16, act='relu')
        pred = pkg.layers.fc(input=h, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    rng = np.random.RandomState(0)
    xs = rng.rand(16, 8).astype('float32')
    return main, startup, loss, {'x': xs,
                                 'y': xs.sum(1, keepdims=True)}


def _transformer(pkg, scan=False):
    from paddle_tpu_torch.models import transformer as T
    pt.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        avg, _ = T.transformer_base(
            src_vocab_size=64, trg_vocab_size=64, src_seq_len=8,
            trg_seq_len=8, n_layer=2, d_model=32, d_inner=64, d_key=8,
            d_value=8, dropout_rate=0.1, scan_layers=scan)
        pt.optimizer.Adam(learning_rate=1e-3).minimize(avg)
    main.random_seed = 5
    return main, startup, avg, T.make_fake_batch(4, 8, 8, 64, 64, seed=1)


def _moe(pkg):
    from paddle_tpu_torch.models import moe
    pt.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        avg, _ = moe.switch_transformer_lm(
            32, 8, n_layer=2, n_head=2, d_model=16, d_inner=32,
            num_experts=4, top_k=2, dropout_rate=0.1, scan_layers=True)
        pt.optimizer.Adam(learning_rate=3e-3).minimize(avg)
    words = np.random.RandomState(0).randint(1, 32, (8, 8)).astype('int64')
    return main, startup, avg, {'word': words,
                                'label': np.roll(words, -1, axis=1)}


def _wide_deep(pkg):
    """Wide&Deep with row-sparse gradients (lazy Adam): the leaves are
    the lookups' row seeds, not the tables."""
    from paddle_tpu_torch.models import wide_deep
    pt.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        _, avg, _, _ = wide_deep.build(num_slots=4, vocab_size=200)
        pt.optimizer.Adam(learning_rate=1e-2, lazy_mode=True).minimize(avg)
    rng = np.random.RandomState(0)
    feed = {'C%d' % i: rng.randint(0, 200, (16, 1)).astype('int64')
            for i in range(4)}
    feed.update(dense=rng.randn(16, 13).astype('f'),
                label=rng.randint(0, 2, (16, 1)).astype('int64'))
    marker = [op for op in main.global_block().ops
              if op.type == 'backward_marker'][0]
    assert len(marker.attrs['sparse_grads']) == 8
    return main, startup, avg, feed


def _conv_bn(pkg):
    """Two conv + batch_norm(relu) blocks, a global average pool and a
    softmax classifier, Momentum: the forward moves the running mean and
    variance, persistables that remat must move once a step."""
    pt.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        img = pt.layers.data(name='img', shape=[3, 8, 8], dtype='float32')
        label = pt.layers.data(name='label', shape=[1], dtype='int64')
        h = img
        for filters in (8, 16):
            h = pt.layers.conv2d(h, num_filters=filters, filter_size=3,
                                 padding=1, bias_attr=False)
            h = pt.layers.batch_norm(h, act='relu')
        h = pt.layers.pool2d(h, pool_type='avg', global_pooling=True)
        logits = pt.layers.fc(input=h, size=4)
        avg = pt.layers.mean(pt.layers.softmax_with_cross_entropy(logits,
                                                                  label))
        pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(avg)
    rng = np.random.RandomState(0)
    return main, startup, avg, {
        'img': rng.randn(8, 3, 8, 8).astype('f'),
        'label': rng.randint(0, 4, (8, 1)).astype('int64')}


BUILDS = {'fit_a_line': lambda: _fit_a_line(pt),
          'conv_batch_norm': lambda: _conv_bn(pt),
          'wide_deep_sparse': lambda: _wide_deep(pt),
          'transformer': lambda: _transformer(pt),
          'transformer_scan': lambda: _transformer(pt, scan=True),
          'moe_scan': lambda: _moe(pt)}


def _steps(main, startup, loss, feed, policy, init, steps=3):
    """(losses, {var: numpy}) after ``steps`` steps from ``init``."""
    pt.memory_optimize(main, policy=policy or 'none')
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        exe.run(startup)
        load_into_scope(init, scope, pt.CPUPlace())
        losses = [exe.run(main, feed=feed, fetch_list=[loss])[0]
                  for _ in range(steps)]
        return np.array(losses), {n: scope.numpy(n) for n in scope.keys()}


@pytest.mark.parametrize('policy', POLICIES)
@pytest.mark.parametrize('build', sorted(BUILDS))
def test_remat_is_bit_for_bit(build, policy):
    """3 steps under the policy equal 3 steps without remat bit for bit:
    the losses and every scope variable (parameters, moments, beta
    pows)."""
    main, startup, loss, feed = BUILDS[build]()
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.Executor(pt.CPUPlace()).run(startup)
    init = {n: scope.numpy(n) for n in scope.keys()}
    base = _steps(main, startup, loss, feed, None, init)
    got = _steps(main, startup, loss, feed, policy, init)
    np.testing.assert_array_equal(got[0], base[0])
    assert sorted(got[1]) == sorted(base[1])
    for n, v in base[1].items():
        np.testing.assert_array_equal(got[1][n], v, err_msg=n)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.addmm,
                                   torch.ops.aten.bmm):
            self.mm += 1
        return func(*args, **(kwargs or {}))


def _count_step(policy, forward_calls):
    """One fit_a_line step under ``policy``: (matmuls run, forward
    lowerings run)."""
    from paddle_tpu_torch.core import registry
    main, startup, loss, feed = _fit_a_line(pt)
    pt.memory_optimize(main, policy=policy)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        del forward_calls[:]
        orig = registry.OP_LOWERINGS['mul']

        def counted(ctx):
            forward_calls.append(ctx.op.type)
            return orig(ctx)
        registry.OP_LOWERINGS['mul'] = counted
        try:
            with _CountMM() as mode:
                exe.run(main, feed=feed, fetch_list=[loss])
        finally:
            registry.OP_LOWERINGS['mul'] = orig
    return mode.mm, len(forward_calls)


def test_the_forward_runs_again_in_the_backward():
    """The two fc layers' mul lowerings run once a step without remat and
    twice under a policy (the recompute); 'full' runs their matmuls again,
    'dots_saveable' keeps them (the same matmul count as no remat)."""
    calls = []
    none = _count_step('none', calls)
    full = _count_step('full', calls)
    dots = _count_step('dots_saveable', calls)
    assert none[1] == 2 and full[1] == 4 and dots[1] == 4
    assert full[0] == none[0] + 2 and dots[0] == none[0]


def test_policy_keys_the_plan_and_fetches_a_forward_value():
    """The plan (and graph) key holds the policy: a program run before
    and after memory_optimize has two plans; a forward value fetched under
    remat (the hidden layer) equals the one without."""
    main, startup, loss, feed = _fit_a_line(pt)
    hidden = [op for op in main.global_block().ops
              if op.type == 'relu'][0].output('Out')
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe.run(startup)
        init = {n: scope.numpy(n) for n in scope.keys()}
        want = exe.run(main, feed=feed, fetch_list=[loss, hidden])
        load_into_scope(init, scope, pt.CPUPlace())
        pt.memory_optimize(main, level=1)
        got = exe.run(main, feed=feed, fetch_list=[loss, hidden])
    assert len([k for k in exe._plans if k[0] == id(main)]) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('level', [0, 1])
def test_losses_equal_the_reference_remat(level):
    """fit_a_line's 20 SGD steps under memory_optimize(level) from the
    reference startup's weights: the losses equal the reference's remat
    run within rtol 1e-5 (fp32 sums in another order, over 20 steps), and
    fall (tests/test_aux.py's assertion)."""
    jmain, jstart, jloss, feed = _fit_a_line(fluid)
    fluid.memory_optimize(jmain, level=level)
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(jscope):
        jexe.run(jstart)
        init = {n: np.asarray(jscope.find(n)) for n in jscope.keys()}
        ref = [float(np.asarray(jexe.run(jmain, feed=feed,
                                         fetch_list=[jloss])[0]).reshape(()))
               for _ in range(20)]
    main, startup, loss, _ = _fit_a_line(pt)
    got = _steps(main, startup, loss, feed,
                 'dots_saveable' if level == 0 else 'full', init,
                 steps=20)[0].reshape(-1)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert got[-1] < got[0]


def test_recompute_gives_the_first_forwards_attention_bits(monkeypatch):
    """Under level 1 the backward runs the forward again: every flash
    attention forward (the kernel's plain version here; K2 on the card,
    tests/test_torch_gpu.py) is called twice a step, and each recomputed
    output and log-sum-exp equals one first forward's bit for bit (the
    backward recomputes the segments last first)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa
    calls = []
    orig = tfa.flash_attention_fwd

    def recorded(*args, **kwargs):
        out, lse = orig(*args, **kwargs)
        calls.append((out.detach().clone(), lse.detach().clone()))
        return out, lse
    monkeypatch.setattr(tfa, 'flash_attention_fwd', recorded)
    main, startup, loss, feed = _transformer(pt)
    pt.memory_optimize(main, level=1)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        del calls[:]
        exe.run(main, feed=feed, fetch_list=[loss])
    n = len(calls) // 2
    assert n == 3 * 2 and len(calls) == 2 * n
    first = calls[:n]
    for o2, l2 in calls[n:]:
        same = [i for i, (o1, l1) in enumerate(first)
                if o1.shape == o2.shape and torch.equal(o1, o2) and
                torch.equal(l1, l2)]
        assert same, 'a recomputed attention differs from every first one'
        del first[same[0]]


class _LiveBytes(TorchDispatchMode):
    """The bytes of the storages that aten ops made while the mode is on
    and that are not freed yet (each storage counted once, until it is
    freed), and the most of them at any time (``peak``)."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self.ptrs = set()

    def _free(self, ptr, nbytes):
        self.live -= nbytes
        self.ptrs.discard(ptr)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                ptr = st.data_ptr()
                if ptr and ptr not in self.ptrs:
                    self.ptrs.add(ptr)
                    self.live += st.nbytes()
                    self.peak = max(self.peak, self.live)
                    weakref.finalize(st, self._free, ptr, st.nbytes())
        return out


def _deep_transformer(scan):
    """6 + 6 layers at batch 16 x seq 16, d_model 32: the activations
    outweigh the parameters, as at a real width."""
    from paddle_tpu_torch.models import transformer as T
    pt.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        avg, _ = T.transformer_base(
            src_vocab_size=64, trg_vocab_size=64, src_seq_len=16,
            trg_seq_len=16, n_layer=6, d_model=32, d_inner=64, d_key=8,
            d_value=8, dropout_rate=0.1, scan_layers=scan)
        pt.optimizer.Adam(learning_rate=1e-3).minimize(avg)
    return main, startup, avg, T.make_fake_batch(16, 16, 16, 64, 64, seed=1)


@pytest.mark.parametrize('scan', [False, True], ids=['unrolled', 'scan'])
def test_remat_lowers_the_steps_peak(scan):
    """The most bytes a training step holds at once (its second step,
    counted over the storages its aten ops make): the forward is cut into
    checkpointed segments and each stacked layer is a checkpoint of its
    own, so the backward holds one segment's activations and the values
    at the cuts. 'full' holds under half of no remat's peak (the plain
    version of the attention kernel keeps its own matmuls, so
    'dots_saveable' is held only to no more than no remat here)."""
    peaks = {}
    for policy in ('none', 'full', 'dots_saveable'):
        main, startup, loss, feed = _deep_transformer(scan)
        pt.memory_optimize(main, policy=policy)
        exe = pt.Executor(pt.CPUPlace())
        with pt.scope_guard(pt.Scope()):
            exe.run(startup)
            exe.run(main, feed=feed, fetch_list=[loss])
            with _LiveBytes() as mode:
                exe.run(main, feed=feed, fetch_list=[loss])
        peaks[policy] = mode.peak
    print('step peak bytes: %s' % peaks)
    assert peaks['full'] < 0.5 * peaks['none']
    assert peaks['dots_saveable'] <= peaks['none']


def test_segments_cut_between_layers():
    """The unrolled Transformer's forward is cut into about sqrt(n)
    segments, each handing one value (the residual stream, at the end the
    loss) to what follows; with scan_layers each stack op is a segment of
    its own (no inputs listed: it checkpoints its layers)."""
    from paddle_tpu_torch.core.executor import SELF_REMAT, _Plan
    for scan in (False, True):
        main, _, loss, _ = _deep_transformer(scan)
        block = main.global_block()
        plan = _Plan(block, list(block.ops), [], [loss.name], 'full')
        segs = plan.remat_segments
        assert segs[0][0] == 0 and segs[-1][1] == plan.marker
        assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))
        stacks = [s for s in segs if s[2] is None]
        if scan:
            assert len(stacks) == 2
            assert all(block.ops[a].type in SELF_REMAT
                       for a, _, _, _ in stacks)
        else:
            assert not stacks
            assert abs(len(segs) - plan.marker ** 0.5) < 0.5 * \
                plan.marker ** 0.5
            assert all(len(outs) == 1 for _, _, _, outs in segs), segs
        assert _Plan(block, list(block.ops), [], [loss.name]) \
            .remat_segments == []
