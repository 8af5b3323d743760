"""NMT inference and the stacked Transformer, port vs reference: the same
numpy inputs and the reference's parameters go through paddle_tpu (CPU)
and paddle_tpu_torch (CPUPlace()). The inference graphs' ops and the beam
ops against their JAX lowerings, the layer stack's forward, training with
scan_layers, stack_trained_weights, and greedy and beam decode (unrolled
and incremental) on the reference's overfit copy-task weights. Ties in
top_k follow lax.top_k (the lower index first). Dropout draws differ
between the packages by design, so dropout-on tests hold the port's own
invariants."""

import functools
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as fluid
from paddle_tpu.models import transformer as JT

import paddle_tpu_torch as pt
from paddle_tpu_torch.models import transformer as PT
from paddle_tpu_torch.ops import tensor_ops as ttensor
from paddle_tpu_torch.ops import transformer_ops as tto
from paddle_tpu_torch.weights import load_into_scope


def _arrays(scope):
    return {n: np.asarray(scope.find(n)) for n in scope.keys()
            if scope.find(n) is not None}


def _run(pkg, build, feed, arrays=None):
    """Build ``build(pkg)``'s fetches on fresh programs, run the startup
    (then load ``arrays``, the reference's values) and the main program
    once on the CPU place; returns the fetches as numpy and the scope."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        outs = build(pkg)
    scope, exe = pkg.Scope(), pkg.Executor(pkg.CPUPlace())
    with pkg.scope_guard(scope):
        exe.run(startup)
        if arrays is not None:
            if pkg is pt:
                load_into_scope(arrays, scope, pt.CPUPlace())
            else:
                for n, v in arrays.items():
                    scope.set(n, v)
        got = exe.run(main, feed=feed, fetch_list=list(outs))
    return [np.asarray(v) for v in got], scope


def _data(pkg, name, shape, dtype='float32'):
    return pkg.layers.data(name=name, shape=list(shape), dtype=dtype,
                           append_batch_size=False)


# ------------------------------------------------------------ ops and ties
def _bf16_rounded(x):
    """fp32 values rounded to the nearest bf16 (ties to even)."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7fff + ((bits >> 16) & 1)) & 0xffff0000
    return bits.astype(np.uint32).view(np.float32)


def _tie_rows():
    every7 = np.zeros((1, 300), np.float32)
    every7[0, ::7] = 1.0
    one_live = np.full((1, 64), -1e30, np.float32)
    one_live[0, 3] = 0.5
    return every7, one_live


_RNG = np.random.RandomState(0)
_BF16_LOGITS = _bf16_rounded(_RNG.randn(6, 4000) * 3.0)
_EVERY7, _ONE_LIVE = _tie_rows()
_TIES = np.array([[1., 3., 3., 0., 3., 2., 3., 1., 0.],
                  [0., 0., 0., 0., 0., 0., 0., 0., 0.],
                  [-1., -2., -1., -5., 7., 7., -1., 7., 2.]], np.float32)
_PRE_IDS = np.array([[5, 1, 7], [1, 1, 4]], np.int64)      # end_id 1
_PRE_SCORES = np.array([[-0.5, -0.75, -2.0], [-1.0, -1.25, -1.5]],
                       np.float32)
_CAND_IDS = _RNG.randint(2, 9, (2, 3, 3)).astype(np.int64)
# candidates with equal totals across beams and finished beams
_CAND_SCORES = np.array([[[-0.25, -0.5, -0.5], [-0.75, -1.0, -1.0],
                          [-0.5, -0.5, -0.5]],
                         [[-0.5, -0.5, -1.0], [-0.25, -0.75, -0.75],
                          [-0.5, -0.25, -0.25]]], np.float32)
_STEP_IDS = _RNG.randint(0, 6, (7, 3, 4)).astype(np.int64)  # end_id 1
_STEP_PARENTS = _RNG.randint(0, 4, (7, 3, 4)).astype(np.int64)


def _op(fetch, feeds):
    """(build, feed): ``fetch(pkg, vars)`` returns the fetches, with
    ``vars`` the data vars of ``feeds`` by name."""
    def build(pkg):
        vs = {n: _data(pkg, n, v.shape, str(v.dtype))
              for n, v in feeds.items()}
        out = fetch(pkg, vs)
        return out if isinstance(out, (list, tuple)) else [out]
    return build, feeds


_ints = _RNG.randint(0, 4, (3, 6)).astype(np.int64)
_floats = _RNG.randn(3, 6).astype(np.float32)
OP_CASES = {
    'fill_constant': _op(lambda pkg, v: [
        pkg.layers.fill_constant([2, 3], 'int64', 7),
        pkg.layers.fill_constant([4], 'float32', -2.5)], {}),
    'fill_constant_batch_size_like': _op(lambda pkg, v: [
        pkg.layers.fill_constant_batch_size_like(v['x'], [1, 4], 'int64',
                                                 3),
        pkg.layers.fill_constant_batch_size_like(
            v['x'], [2, 1], 'float32', 1.5, input_dim_idx=1,
            output_dim_idx=1)], {'x': _floats}),
    'concat': _op(lambda pkg, v: [
        pkg.layers.concat([v['a'], v['b']], axis=1),
        pkg.layers.concat([v['x'], v['x']], axis=0)],
        {'a': _ints[:, :2], 'b': _ints, 'x': _floats}),
    'one_hot': _op(lambda pkg, v: pkg.layers.one_hot(v['i'], depth=6),
                   {'i': _RNG.randint(0, 6, (5, 1)).astype(np.int64)}),
    'cumsum': _op(lambda pkg, v: [
        pkg.layers.cumsum(v['i'], axis=1),
        pkg.layers.cumsum(v['x'], axis=0, exclusive=True),
        pkg.layers.cumsum(v['x'], axis=1, reverse=True)],
        {'i': _ints, 'x': _floats}),
    'expand': _op(lambda pkg, v: [
        pkg.layers.expand(v['x'], expand_times=[1, 4, 2]),
        pkg.layers.expand(v['i'], expand_times=[2, 3])],
        {'x': _floats.reshape(3, 1, 6), 'i': _ints}),
    'stack': _op(lambda pkg, v: [
        pkg.layers.stack([v['a'], v['b'], v['a']], axis=0),
        pkg.layers.stack([v['a'], v['b']], axis=1)],
        {'a': _ints, 'b': _ints[::-1].copy()}),
    'argmax': _op(lambda pkg, v: [pkg.layers.argmax(v['x'], axis=-1),
                                  pkg.layers.argmax(v['x'], axis=0)],
                  {'x': _TIES}),
    'equal_less_than': _op(lambda pkg, v: [
        pkg.layers.equal(x=v['a'], y=v['b']),
        pkg.layers.less_than(x=v['a'], y=v['b'])],
        {'a': _ints, 'b': _ints[::-1].copy()}),
    'elementwise_sub': _op(lambda pkg, v: [
        pkg.layers.elementwise_sub(x=v['a'], y=v['b']),
        pkg.layers.elementwise_sub(x=v['x'], y=v['x'])],
        {'a': _ints, 'b': _ints[::-1].copy(), 'x': _floats}),
    'log_softmax': _op(lambda pkg, v: pkg.layers.log_softmax(v['x']),
                       {'x': _floats}),
    'top_k_every_7th': _op(lambda pkg, v: pkg.layers.topk(v['x'], k=5),
                           {'x': _EVERY7}),
    'top_k_one_live': _op(lambda pkg, v: pkg.layers.topk(v['x'], k=4),
                          {'x': _ONE_LIVE}),
    'top_k_ties': _op(lambda pkg, v: pkg.layers.topk(v['x'], k=6),
                      {'x': _TIES}),
    'top_k_bf16_logits': _op(lambda pkg, v: pkg.layers.topk(v['x'], k=8),
                             {'x': _BF16_LOGITS}),
    'beam_search': _op(lambda pkg, v: pkg.layers.beam_search(
        v['pre_ids'], v['pre_scores'], v['ids'], v['scores'], beam_size=3,
        end_id=1), {'pre_ids': _PRE_IDS, 'pre_scores': _PRE_SCORES,
                    'ids': _CAND_IDS, 'scores': _CAND_SCORES}),
    'beam_search_decode': _op(lambda pkg, v: pkg.layers.beam_search_decode(
        v['ids'], v['parents'], final_scores=v['scores'], end_id=1),
        {'ids': _STEP_IDS, 'parents': _STEP_PARENTS,
         'scores': _RNG.randn(3, 4).astype(np.float32)}),
    'beam_gather': _op(lambda pkg, v: [
        pkg.layers.beam_gather(v['x'], v['idx']),
        pkg.layers.beam_gather(v['f'], v['idx'])],
        {'x': _RNG.randint(0, 9, (2, 3, 5)).astype(np.int64),
         'f': _RNG.randn(2, 3, 2, 4).astype(np.float32),
         'idx': np.array([[2, 2, 0], [1, 0, 1]], np.int64)}),
}


@pytest.mark.parametrize('name', sorted(OP_CASES))
def test_op_matches_reference_lowering(name):
    """Integer outputs exact, float outputs within 1e-6."""
    build, feed = OP_CASES[name]
    ref, _ = _run(fluid, build, feed)
    got, _ = _run(pt, build, feed)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape, name
        if np.issubdtype(r.dtype, np.floating):
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, r.astype(g.dtype))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_top_k_ties_follow_lax_top_k(dtype):
    """The port's top_k on tied values, the two tie rows above and bf16
    logits among them, returns lax.top_k's indices, and values in the
    input's dtype."""
    for rows, k in ((_EVERY7, 5), (_ONE_LIVE, 4), (_TIES, 9),
                    (_BF16_LOGITS, 64)):
        x = torch.from_numpy(rows).to(getattr(torch, dtype))
        vals, idx = ttensor.top_k(x, k)
        jv, ji = jax.lax.top_k(jnp.asarray(rows, getattr(jnp, dtype)), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        assert vals.dtype == x.dtype
        np.testing.assert_array_equal(vals.float().numpy(),
                                      np.asarray(jv, np.float32))
    assert ttensor.top_k(torch.from_numpy(_EVERY7), 5)[1].tolist() == \
        [[0, 7, 14, 21, 28]]
    assert ttensor.top_k(torch.from_numpy(_ONE_LIVE), 4)[1].tolist() == \
        [[3, 0, 1, 2]]


# ----------------------------------------------------------- layer stack
SMALL = dict(n_layer=2, n_head=2, d_key=8, d_value=8, d_model=16,
             d_inner=32)


@pytest.mark.parametrize('decoder', [False, True])
@pytest.mark.parametrize('with_len', [False, True])
def test_layer_stack_forward_matches_reference(decoder, with_len):
    """transformer_layer_stack at fp32, dropout 0: within 1e-5."""
    b, t, s, d = 3, 5, 6, SMALL['d_model']
    rng = np.random.RandomState(3)
    feed = {'x': rng.randn(b, t, d).astype(np.float32)}
    if decoder:
        feed['enc'] = rng.randn(b, s, d).astype(np.float32)
    if with_len:
        feed['len'] = np.array([s if decoder else t, 2, 1], np.int64)
    prefix = 'dec_stack' if decoder else 'enc_stack'

    def build(model):
        def fn(pkg):
            x = _data(pkg, 'x', feed['x'].shape)
            enc = _data(pkg, 'enc', feed['enc'].shape) if decoder else None
            ln = _data(pkg, 'len', [b], 'int64') if with_len else None
            params = model._stacked_layer_params(
                prefix, SMALL['n_layer'], SMALL['n_head'], SMALL['d_key'],
                SMALL['d_value'], d, SMALL['d_inner'], decoder=decoder)
            return [model._layer_stack(x, params, SMALL['n_head'], 0.0,
                                       enc_out=enc, src_length=ln,
                                       name=prefix)]
        return fn

    (ref,), jscope = _run(fluid, build(JT), feed)
    (got,), _ = _run(pt, build(PT), feed, arrays=_arrays(jscope))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


# ----------------------------------------------- training with scan_layers
TRAIN = dict(SMALL, dropout_rate=0.0, label_smooth_eps=0.1, src_seq_len=6,
             trg_seq_len=6)
VOCAB = 50


def _train(pkg, model, scan, arrays, feed, steps=3, stack=False, **kw):
    """``steps`` SGD(0.5) steps of transformer(scan_layers=scan) from
    ``arrays`` (stack_trained_weights first with ``stack``); returns the
    losses, the executor, the program, the loss var and the scope."""
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        avg, _ = model.transformer(VOCAB, VOCAB, max_length=16,
                                   scan_layers=scan, **dict(TRAIN, **kw))
        pkg.optimizer.SGD(learning_rate=0.5).minimize(avg)
    scope, exe = pkg.Scope(), pkg.Executor(pkg.CPUPlace())
    with pkg.scope_guard(scope):
        exe.run(startup)
        for n, v in arrays.items():
            if pkg is pt:
                scope.set(n, torch.from_numpy(np.array(v)))
            else:
                scope.set(n, v)
        if stack:
            model.stack_trained_weights(scope, TRAIN['n_layer'])
        losses = [float(np.asarray(exe.run(main, feed=feed,
                                           fetch_list=[avg])[0]))
                  for _ in range(steps)]
    return losses, exe, main, avg, scope


@functools.lru_cache(maxsize=1)
def _unrolled_startup():
    """The reference's unrolled startup values (shared, never written)."""
    fluid.reset_default_programs()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        JT.transformer(VOCAB, VOCAB, max_length=16, **TRAIN)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CPUPlace()).run(startup)
    return _arrays(scope)


def test_scan_layers_training_matches_reference_and_unrolled():
    """3 SGD steps of transformer(scan_layers=True) from the reference's
    unrolled startup, stacked: the losses within 1e-5 of the reference's
    scan program and of the port's unrolled program from the same
    weights."""
    arrays = _unrolled_startup()
    feed = JT.make_fake_batch(4, 6, 6, VOCAB, VOCAB, seed=7)
    ref_scan = _train(fluid, JT, True, arrays, feed, stack=True)[0]
    got_scan = _train(pt, PT, True, arrays, feed, stack=True)[0]
    got_unrolled = _train(pt, PT, False, arrays, feed)[0]
    np.testing.assert_allclose(got_scan, ref_scan, rtol=1e-5)
    np.testing.assert_allclose(got_scan, got_unrolled, rtol=1e-5)
    assert got_scan[-1] < got_scan[0]


def test_scan_layers_env_default(monkeypatch):
    """PADDLE_TPU_SCAN_LAYERS=1 makes scan_layers=None build the stacked
    layout, one transformer_layer_stack op a side, as in the reference."""
    monkeypatch.setenv('PADDLE_TPU_SCAN_LAYERS', '1')
    pt.reset_default_programs()
    PT.transformer(VOCAB, VOCAB, max_length=16, **TRAIN)
    ops = [op.type for op in pt.default_main_program().global_block().ops]
    assert ops.count('transformer_layer_stack') == 2


def test_scan_layers_dropout_invariants():
    """Dropout 0.1 in the stack: two executors from the same weights take
    the same steps bit for bit, run_steps(3) equals 3 run calls, and the
    draws move the loss away from the dropout-0 one. Each (layer, site)
    has its own mask, kept with probability 1 - rate."""
    arrays = _unrolled_startup()
    feed = JT.make_fake_batch(4, 6, 6, VOCAB, VOCAB, seed=7)
    a, _, _, _, _ = _train(pt, PT, True, arrays, feed, stack=True,
                           dropout_rate=0.1)
    b, exe, main, avg, scope = _train(pt, PT, True, arrays, feed, steps=0,
                                      stack=True, dropout_rate=0.1)
    with pt.scope_guard(scope):
        b = exe.run_steps(3, main, feed=feed, fetch_list=[avg])[0]
    assert np.array_equal(np.asarray(a, np.float32), b.reshape(-1))
    plain = _train(pt, PT, True, arrays, feed, stack=True)[0]
    assert a[0] != plain[0]

    ctx = types.SimpleNamespace(seed=3, op_index=5,
                                step_tensor=lambda: torch.tensor(2))
    sites = tto._Sites(ctx, 0.25, 6)
    # a site's dropout of ones is its mask
    ones = torch.ones(64, 256)
    masks = [sites.drop(ones, layer, site, 'mul')
             for layer in range(2) for site in range(6)]
    for i in range(len(masks)):
        assert abs(float(masks[i].mean()) - 0.75) < 0.01
        for j in range(i):
            assert not torch.equal(masks[i], masks[j])
    again = tto._Sites(ctx, 0.25, 6).drop(ones, 1, 4, 'mul')
    assert torch.equal(again, masks[6 + 4])


# ------------------------------------------------- stack_trained_weights
def test_stack_trained_weights_matches_reference():
    arrays = _unrolled_startup()
    jscope, pscope = fluid.Scope(), pt.Scope()
    for n, v in arrays.items():
        jscope.set(n, v)
    load_into_scope(arrays, pscope, pt.CPUPlace())
    before = {n: pscope.find(n) for n in pscope.keys()}
    ref = JT.stack_trained_weights(jscope, TRAIN['n_layer'])
    got = PT.stack_trained_weights(pscope, TRAIN['n_layer'])
    assert got == ref and len(got) == len(tto.ENC_SLOTS) + \
        len(tto.DEC_SLOTS)
    for n in got:
        np.testing.assert_array_equal(pscope.numpy(n),
                                      np.asarray(jscope.find(n)))
        assert n not in before
    # a second call installs new tensors (a captured graph that read the
    # old ones is captured again)
    first = {n: pscope.find(n) for n in got}
    PT.stack_trained_weights(pscope, TRAIN['n_layer'])
    assert all(pscope.find(n) is not first[n] for n in got)


def test_stack_trained_weights_errors_as_reference():
    arrays = _unrolled_startup()
    for pkg, model, load in (
            (fluid, JT, lambda s, a: [s.set(n, v) for n, v in a.items()]),
            (pt, PT, lambda s, a: load_into_scope(a, s, pt.CPUPlace()))):
        scope = pkg.Scope()
        load(scope, arrays)
        with pytest.raises(ValueError, match='has layer index 1 but '
                                             'n_layer=1'):
            model.stack_trained_weights(scope, 1)
        scope = pkg.Scope()
        load(scope, {n: v for n, v in arrays.items()
                     if n != 'dec_1_cross_k.w'})
        with pytest.raises(ValueError, match=r"'dec_stack_cross_k.w' "
                                             r"missing layers \[1\]"):
            model.stack_trained_weights(scope, 2)


# ------------------------------------------------------------ decoding
COPY = dict(max_length=32, n_layer=1, n_head=2, d_key=8, d_value=8,
            d_model=16, d_inner=32)
SEQ, CVOCAB, BEAM = 6, 16, 3


@pytest.fixture(scope='module')
def copy_task():
    """The reference's overfit copy task (tests/test_transformer_infer.py):
    60 Adam(0.01) steps in the JAX package; its parameters and sources."""
    rng = np.random.RandomState(0)
    src = rng.randint(2, CVOCAB, (8, SEQ)).astype('int64')
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        avg, _ = JT.transformer(CVOCAB, CVOCAB, dropout_rate=0.0,
                                label_smooth_eps=0.0, src_seq_len=SEQ,
                                trg_seq_len=SEQ, **COPY)
        fluid.optimizer.Adam(learning_rate=0.01).minimize(avg)
    scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    trg_in = np.concatenate([np.zeros((8, 1), 'int64'), src[:, :-1]], 1)
    feed = {'src_word': src, 'src_length': np.full((8,), SEQ, 'int64'),
            'trg_word': trg_in, 'lbl_word': src,
            'lbl_weight': np.ones((8, SEQ), 'float32')}
    with fluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(60):
            loss = exe.run(main, feed=feed, fetch_list=[avg])[0]
    assert float(np.asarray(loss)) < 0.15
    return _arrays(scope), src, {}


def _infer_feed(src):
    lens = np.full((src.shape[0],), src.shape[1], 'int64')
    lens[1] = 3         # one shorter sentence: kv_len reaches the decoder
    return {'src_word': src, 'src_length': lens}


def _decode(pkg, model, kind, incremental, arrays, src, scan=False):
    def build(p):
        common = dict(max_out_len=SEQ + 1, src_seq_len=SEQ, eos_id=1,
                      scan_layers=scan, incremental=incremental, **COPY)
        if kind == 'greedy':
            ids, _ = model.transformer_greedy_infer(CVOCAB, CVOCAB,
                                                    **common)
            return [ids]
        (sent, scores), _ = model.transformer_beam_infer(
            CVOCAB, CVOCAB, beam_size=BEAM, **common)
        return [sent, scores]

    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        outs = build(pkg)
    scope, exe = pkg.Scope(), pkg.Executor(pkg.CPUPlace())
    with pkg.scope_guard(scope):
        if pkg is pt:
            load_into_scope(arrays, scope, pt.CPUPlace())
        else:
            for n, v in arrays.items():
                scope.set(n, v)
        if incremental and not scan:
            model.stack_trained_weights(scope, COPY['n_layer'])
        return [np.asarray(v) for v in exe.run(main, feed=_infer_feed(src),
                                               fetch_list=outs)]


@pytest.mark.parametrize('incremental', [False, True])
@pytest.mark.parametrize('kind', ['greedy', 'beam'])
def test_decode_matches_reference_on_copy_task(copy_task, kind,
                                               incremental):
    """Ids equal to the reference's, scores within 1e-5; the decode
    copies the source."""
    arrays, src, cache = copy_task
    key = (kind, incremental)
    if key not in cache:
        cache[key] = _decode(fluid, JT, kind, incremental, arrays, src)
    ref = cache[key]
    got = _decode(pt, PT, kind, incremental, arrays, src)
    np.testing.assert_array_equal(got[0], ref[0].astype(np.int64))
    if kind == 'beam':
        np.testing.assert_allclose(got[1], ref[1], rtol=1e-5, atol=1e-5)
        top = got[0][:, 0, :SEQ]
        assert (np.diff(got[1], axis=1) <= 1e-5).all()
    else:
        top = got[0][:, 1:]
    keep = np.arange(8) != 1
    assert (top[keep] == src[keep]).mean() > 0.9


def test_incremental_equals_unrolled_in_the_port(copy_task):
    arrays, src, _ = copy_task
    for kind in ('greedy', 'beam'):
        a = _decode(pt, PT, kind, False, arrays, src)
        b = _decode(pt, PT, kind, True, arrays, src)
        np.testing.assert_array_equal(a[0], b[0])
        if kind == 'beam':
            np.testing.assert_allclose(a[1], b[1], rtol=1e-5, atol=1e-6)


def test_scan_trained_scope_decodes():
    """A scope trained with scan_layers=True drives the inference
    builders directly (the reference's test_scan_trained_scope_decodes):
    unrolled and incremental, greedy and beam, copy the source."""
    seq_len, vocab = 5, 12
    rng = np.random.RandomState(0)
    src = rng.randint(2, vocab, (8, seq_len)).astype('int64')
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        avg, _ = PT.transformer(
            vocab, vocab, dropout_rate=0.0, label_smooth_eps=0.0,
            src_seq_len=seq_len, trg_seq_len=seq_len, scan_layers=True,
            **COPY)
        pt.optimizer.Adam(learning_rate=0.01).minimize(avg)
    trg_in = np.concatenate([np.zeros((8, 1), 'int64'), src[:, :-1]], 1)
    feed = {'src_word': src, 'src_length': np.full((8,), seq_len, 'int64'),
            'trg_word': trg_in, 'lbl_word': src,
            'lbl_weight': np.ones((8, seq_len), 'float32')}
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        exe.run(startup)
        for _ in range(80):
            loss = exe.run(main, feed=feed, fetch_list=[avg])[0]
        assert float(loss) < 0.2
        outs = {}
        for incremental in (False, True):
            for kind in ('greedy', 'beam'):
                prog = pt.Program()
                with pt.program_guard(prog, pt.Program()):
                    kw = dict(max_out_len=seq_len + 1, src_seq_len=seq_len,
                              scan_layers=True, incremental=incremental,
                              **COPY)
                    if kind == 'greedy':
                        fetch = [PT.transformer_greedy_infer(
                            vocab, vocab, **kw)[0]]
                    else:
                        fetch = list(PT.transformer_beam_infer(
                            vocab, vocab, beam_size=3, **kw)[0])
                outs[kind, incremental] = exe.run(
                    prog, feed={'src_word': src,
                                'src_length': feed['src_length']},
                    fetch_list=fetch)
    for kind in ('greedy', 'beam'):
        np.testing.assert_array_equal(outs[kind, False][0],
                                      outs[kind, True][0])
    assert (outs['greedy', True][0][:, 1:] == src).mean() > 0.9
    assert (outs['beam', True][0][:, 0, :seq_len] == src).mean() > 0.9
