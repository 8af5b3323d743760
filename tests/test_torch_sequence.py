"""The sequence, CTC, CRF and metric op types, port vs reference, on the
CPU; then metrics.py and evaluator.py against the reference's on the same
arrays.

Each op goes through tests/test_torch_harness.py: the reference's program
(its layers, or one op where the reference has no layer) serialized into
the port, both run on the same numpy feed, every output and every float
feed's gradient compared. Feeds: 'random', 'edge' (the harness's edge
values: NaN, +-inf, +-0, 3e9, ... laid over the float inputs) and
'empty' (every row of length 0); the other feeds hold lengths T, 0 and
between. fp32 and bf16 AMP.

Tolerances. The harness's rule (check_parity: pointwise 1e-6 of the
array's ordinary magnitude at fp32, one bf16 ulp plus 2^-8 of it in bf16;
a sum of n terms 1e-6 n times their magnitudes) for the ops that are one
formula or one sum. The recurrences (warpctc, linear_chain_crf add T
steps of logaddexp / logsumexp in fp32 whichever the feed's dtype) and
sequence_conv (a product of 3 D or 4 D terms, bf16 under AMP):
chip_smoke.py's recurrence_difference, shared with phase 19d: each array
within 1e-5 of its largest finite magnitude M (at least 1: the inputs are
of order 1), and a bf16 array (or a gradient under bf16 AMP) within 2^-8
of its own magnitude and 2^-8 M (2^-6 M for a gradient) more, the
harness's bf16 rule; NaN and inf placed as the reference places them.
Integer outputs (paths, indices, lengths, kept tokens) exactly.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (port tests import both frameworks)

import paddle_tpu as fluid
from paddle_tpu.param_attr import ParamAttr

import paddle_tpu_torch as pt

from chip_smoke import recurrence_difference
from test_torch_harness import EDGE, _op, check_parity, run_both

B, T, D, C = 4, 6, 5, 4
LENS = np.array([6, 0, 3, 1], np.int64)


def _float(kind, shape, seed, scale=1.0):
    if kind == 'edge':
        return np.resize(EDGE, shape).astype(np.float32)
    rng = np.random.RandomState(seed)
    return (rng.uniform(-2.0, 2.0, shape) * scale).astype(np.float32)


def _lens(kind):
    return np.zeros(B, np.int64) if kind == 'empty' else LENS


# ------------------------------------------------------ the sequence ops
def _pool(pool_type, length=True):
    return lambda L, v: L.sequence_pool(v['x'], pool_type,
                                        length=v['len'] if length else None)


SEQ = {
    'pool_average': (_pool('average'), 'x3'),
    'pool_avg_no_length': (_pool('avg', False), 'x3'),
    'pool_sum': (_pool('sum'), 'x3'),
    'pool_sqrt': (_pool('sqrt'), 'x3'),
    'pool_max': (_pool('max'), 'x3'),
    'pool_first': (_pool('first'), 'x3'),
    'pool_last': (_pool('last'), 'x3'),
    'pool_last_no_length': (_pool('last', False), 'x3'),
    'first_step': (lambda L, v: L.sequence_first_step(v['x'], v['len']),
                   'x3'),
    'last_step': (lambda L, v: L.sequence_last_step(v['x'], v['len']),
                  'x3'),
    # weighted, so the loss (the sum of the outputs) is no constant
    'softmax': (lambda L, v: L.elementwise_mul(
        L.sequence_softmax(v['x'], v['len']), v['w']), 'x2w'),
    'expand': (lambda L, v: L.sequence_expand(v['row'], v['x']), 'x3_row'),
    'reshape': (lambda L, v: L.sequence_reshape(v['x'], 10), 'x3w'),
    'concat': (lambda L, v: L.sequence_concat([v['x'], v['y']]), 'x3y3'),
    'slice': (lambda L, v: [L.sequence_slice(v['x'], 1, 3),
                            L.sequence_slice(v['x'], 4, 5)], 'x3'),
    'erase': (lambda L, v: _op(L, 'sequence_erase', {'X': v['ids']},
                               attrs={'tokens': [2, 5]}), 'ids'),
    'kmax_seq_score': (lambda L, v: _op(
        L, 'kmax_seq_score', {'X': v['x'], 'Length': v['len']},
        out_dtype='int64', attrs={'beam_size': 3}), 'x2'),
}

# a sum of n terms: (n, the magnitudes of its terms, per output and per
# feed's gradient) for check_parity
SEQ_SUMS = {
    'pool_average': (T, lambda f: ([np.abs(f['x']).sum(1) / T],
                                   {'x': np.ones(f['x'].shape)})),
    'pool_avg_no_length': (T, lambda f: ([np.abs(f['x']).sum(1) / T],
                                         {'x': np.ones(f['x'].shape)})),
    'pool_sum': (T, lambda f: ([np.abs(f['x']).sum(1)],
                               {'x': np.ones(f['x'].shape)})),
    'pool_sqrt': (T, lambda f: ([np.abs(f['x']).sum(1)],
                                {'x': np.ones(f['x'].shape)})),
}


def seq_feed(inputs, kind, seed=1):
    lens = _lens(kind)
    if inputs == 'ids':
        rng = np.random.RandomState(seed)
        return {'ids': rng.randint(0, 7, (B, T)).astype(np.int64)}
    if inputs in ('x2', 'x2w'):
        x = _float(kind, (B, T), seed)
        if kind == 'random':
            x[0, 1] = x[0, 4]       # a tie for kmax's order
        feed = {'x': x, 'len': lens}
        if inputs == 'x2w':
            feed['w'] = _float('random', (B, T), seed + 3)
        return feed
    if inputs == 'x3w':
        return {'x': _float(kind, (B, T, 2 * D), seed)}
    feed = {'x': _float(kind, (B, T, D), seed), 'len': lens}
    if inputs == 'x3_row':
        feed['row'] = _float(kind, (B, D), seed + 1)
        del feed['len']
    if inputs == 'x3y3':
        feed['y'] = _float(kind, (B, T, D), seed + 2)
        del feed['len']
    if kind == 'random' and inputs == 'x3':
        feed['x'][2, 1] = feed['x'][2, 0]   # a tie within a row for MAX
    return feed


# under bf16 AMP, each array of the case within this many bf16 ulps (2^-8)
# of its largest finite magnitude (the harness's CHAINED rule): the
# reference's bf16 softmax backward subtracts sum(s g) from g in bf16, a
# cancellation at the cotangent's scale (|g| up to 2 here) that torch runs
# in fp32; measured 0.0107 on a gradient of largest magnitude 0.3125
# (8.8 ulps of it)
SEQ_ULPS = {'softmax': 16}


@pytest.mark.parametrize('amp', [None, 'bf16'], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('kind', ['random', 'edge', 'empty'])
@pytest.mark.parametrize('case', sorted(SEQ))
def test_sequence_op_parity(case, kind, amp):
    build, inputs = SEQ[case]
    check_parity(build, seq_feed(inputs, kind), amp=amp,
                 sums=SEQ_SUMS.get(case), ulps=SEQ_ULPS.get(case))


# -------------------------------------------------- CTC, CRF and metrics
def _ctc(L, v):
    return L.warpctc(v['logits'], v['label'], blank=0,
                     input_length=v['t_len'], label_length=v['l_len'])


def _ctc_norm(L, v):
    return L.warpctc(v['logits'], v['label'], blank=2, norm_by_times=True,
                     input_length=v['t_len'], label_length=v['l_len'])


def _ctc_greedy(L, v):
    return list(L.ctc_greedy_decoder(v['logits'], 0, v['t_len']))


def _crf(L, v):
    cost = L.linear_chain_crf(v['emission'], v['tags'], length=v['len'],
                              param_attr=ParamAttr(name='crf_w'))
    path = L.crf_decoding(v['emission'], ParamAttr(name='crf_w'),
                          length=v['len'])
    hits = L.crf_decoding(v['emission'], ParamAttr(name='crf_w'),
                          label=v['tags'], length=v['len'])
    return [cost, path, hits]


def _crf_no_length(L, v):
    cost = L.linear_chain_crf(v['emission'], v['tags'],
                              param_attr=ParamAttr(name='crf_w'))
    return [cost, L.crf_decoding(v['emission'], ParamAttr(name='crf_w'))]


def _precision_recall(L, v):
    return list(L.precision_recall(v['idx'], v['lab'], C, weights=v['w'],
                                   states_info=v['states']))


def _pn_pair(L, v):
    return list(L.positive_negative_pair(
        v['score'], v['lab'], v['qid'], weight=v['w'], column=1,
        accum=(v['acc_p'], v['acc_n'], v['acc_u'])))


def _edit(L, v):
    return list(L.edit_distance(v['hyp'], v['ref'], input_length=v['hl'],
                                label_length=v['rl'])) + \
        [L.edit_distance(v['hyp'], v['ref'], normalized=False)[0]]


# CTC, the CRF and the context-window convolution (a product of 3 D or
# 4 D terms at each element)
RECURRENT = {'ctc': _ctc, 'ctc_norm_blank2': _ctc_norm, 'crf': _crf,
             'crf_no_length': _crf_no_length,
             'conv3': lambda L, v: L.sequence_conv(v['x'], 7, filter_size=3,
                                                   act='tanh'),
             'conv4_no_bias': lambda L, v: L.sequence_conv(
                 v['x'], 7, filter_size=4, bias_attr=False)}
OTHERS = {'ctc_greedy_decoder': _ctc_greedy,
          'precision_recall': _precision_recall,
          'positive_negative_pair': _pn_pair, 'edit_distance': _edit}


def decode_feed(case, kind, seed=2):
    rng = np.random.RandomState(seed)
    lens = _lens(kind)
    if case.startswith('conv'):
        return seq_feed('x3', kind)
    if case.startswith('ctc'):
        label = rng.randint(1, C, (B, 3)).astype(np.int64)
        label[0, 1] = label[0, 0]       # a repeat: a blank between
        return {'logits': _float(kind, (B, T, C), seed),
                'label': label, 't_len': lens,
                'l_len': np.minimum(np.array([3, 0, 2, 1]), lens)}
    if case.startswith('crf'):
        emission = _float(kind, (B, T, C), seed)
        if kind == 'random':
            emission[3, 0, 1] = emission[3, 0, 2]   # a tie for Viterbi
        return {'emission': emission,
                'tags': rng.randint(0, C, (B, T)).astype(np.int64),
                'len': lens}
    if case == 'precision_recall':
        n = 10
        return {'idx': rng.randint(0, C, (n, 1)).astype(np.int64),
                'lab': rng.randint(0, C, (n, 1)).astype(np.int64),
                'w': np.abs(_float('random', (n, 1), seed)),
                'states': np.abs(_float(kind, (C, 4), seed + 1))}
    if case == 'positive_negative_pair':
        n = 12
        score = _float(kind, (n, 2), seed)
        score[3, 1] = score[5, 1]       # a tie: neutral and negative
        return {'score': score,
                'lab': rng.randint(0, 3, (n, 1)).astype(np.float32),
                'qid': rng.randint(0, 3, (n, 1)).astype(np.int64),
                'w': np.abs(_float('random', (n, 1), seed + 1)),
                'acc_p': np.array([2.0], np.float32),
                'acc_n': np.array([1.0], np.float32),
                'acc_u': np.array([0.5], np.float32)}
    return {'hyp': rng.randint(0, 4, (B, T)).astype(np.int64),
            'ref': rng.randint(0, 4, (B, T - 1)).astype(np.int64),
            'hl': lens, 'rl': np.minimum(np.array([5, 2, 0, 4]), T - 1)}


@pytest.mark.parametrize('amp', [None, 'bf16'], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('kind', ['random', 'edge', 'empty'])
@pytest.mark.parametrize('case', sorted(RECURRENT))
def test_ctc_and_crf_parity(case, kind, amp):
    names, ref, got, _, _ = run_both(RECURRENT[case], decode_feed(case, kind),
                                     amp)
    for (op_type, name), r, g in zip(names, ref, got):
        diff = recurrence_difference(g, r, amp is not None and
                                     op_type == '@GRAD', op_type == '@GRAD')
        assert diff is None, '%s %s: %r\nref  %s\nport %s' % (
            op_type, name, diff, r, g)


@pytest.mark.parametrize('amp', [None, 'bf16'], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('kind', ['random', 'edge', 'empty'])
@pytest.mark.parametrize('case', sorted(OTHERS))
def test_decode_and_metric_op_parity(case, kind, amp):
    check_parity(OTHERS[case], decode_feed(case, kind), amp=amp)


def test_ctc_gradient_where_both_terms_are_minus_1e30():
    """logaddexp at two -1e30 terms: the reference's JVP gives each term
    the whole gradient (exp(x - out) with out = -1e30 + log 2 rounded to
    -1e30), torch's own logaddexp half of it; the port's is the
    reference's."""
    import torch
    from paddle_tpu_torch.ops.decode_ops import logaddexp
    a = torch.tensor([-1e30, -1e30, 0.0], requires_grad=True)
    b = torch.tensor([-1e30, 1.0, 0.0], requires_grad=True)
    ga, gb = torch.autograd.grad(logaddexp(a, b).sum(), (a, b))
    ja, jb = jax.grad(lambda x, y: jax.numpy.logaddexp(x, y).sum(),
                      argnums=(0, 1))(np.asarray(a.detach()),
                                      np.asarray(b.detach()))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(jb))
    assert ga[0] == 1.0 and gb[0] == 1.0


def test_chunk_eval_raises_as_the_reference_does():
    for pkg in (fluid, pt):
        with pytest.raises(NotImplementedError, match='ChunkEvaluator'):
            pkg.layers.chunk_eval(None, None, 'IOB', 2)


# ------------------------------------------------- metrics.py, evaluator.py
def _metric_arrays(seed):
    rng = np.random.RandomState(seed)
    preds = rng.rand(50).astype(np.float32)
    labels = (rng.rand(50) > 0.4).astype(np.int64)
    return preds, labels


def _metric_runs(pkg):
    """Every metric of metrics.py over the same batches: its eval()."""
    m = pkg.metrics
    out = {}
    for name in ('Precision', 'Recall', 'Auc'):
        metric = getattr(m, name)()
        for s in range(3):
            metric.update(*_metric_arrays(s))
        out[name] = metric.eval()
    acc = m.Accuracy()
    for s, v in enumerate((0.5, 0.75, 1.0)):
        acc.update(v, weight=s + 1)
    out['Accuracy'] = acc.eval()
    ed = m.EditDistance()
    ed.update(np.array([1.0, 2.0, 0.0]), seq_num=3)
    ed.update(np.array([4.0]))
    out['EditDistance'] = ed.eval()
    comp = m.CompositeMetric()
    comp.add_metric(m.Precision())
    comp.add_metric(m.Recall())
    comp.update(*_metric_arrays(4))
    out['Composite'] = comp.eval()
    dm = m.DetectionMAP(ap_version='11point')
    dm2 = m.DetectionMAP()
    rng = np.random.RandomState(9)
    for _ in range(3):
        gt = np.concatenate([rng.randint(0, 3, (4, 1)),
                             np.sort(rng.rand(4, 4), 1)], 1)
        det = np.concatenate([rng.randint(0, 3, (6, 1)), rng.rand(6, 1),
                              np.sort(rng.rand(6, 4), 1)], 1)
        dm.update(det, gt)
        dm2.update(det, gt)
    out['DetectionMAP'] = (dm.eval(), dm2.eval())
    return out


def test_metrics_match_the_reference():
    assert pt.metrics.__all__ == fluid.metrics.__all__
    ref, got = _metric_runs(fluid), _metric_runs(pt)
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert got[name] == ref[name], name


@pytest.mark.parametrize('scheme', ['IOB', 'IOE', 'IOBES', 'plain'])
def test_chunk_evaluator_matches_the_reference(scheme):
    """ChunkEvaluator over the same tag arrays (a type excluded), and the
    Accuracy evaluator's running mean, in both packages."""
    rng = np.random.RandomState(12)
    kinds = {'IOB': 2, 'IOE': 2, 'IOBES': 4, 'plain': 1}[scheme]
    results = []
    for pkg in (fluid, pt):
        ev = pkg.evaluator.ChunkEvaluator(chunk_scheme=scheme,
                                          num_chunk_types=3,
                                          excluded_chunk_types=[2])
        for _ in range(2):
            infer = rng.randint(0, 3 * kinds + 1, (5, 9))
            label = rng.randint(0, 3 * kinds + 1, (5, 9))
            ev.update(infer, label, np.array([9, 0, 4, 7, 1]))
        results.append((ev.num_infer_chunks, ev.num_label_chunks,
                        ev.num_correct_chunks, ev.eval()))
        rng = np.random.RandomState(12)
    assert results[0] == results[1]
    assert results[0][0] > 0


def test_accuracy_evaluator_matches_the_reference():
    got = []
    for pkg in (fluid, pt):
        pkg.reset_default_programs()
        with pkg.program_guard(pkg.Program(), pkg.Program()):
            x = pkg.layers.data(name='x', shape=[3], dtype='float32')
            y = pkg.layers.data(name='y', shape=[1], dtype='int64')
            ev = pkg.evaluator.Accuracy(input=x, label=y)
        for acc, n in ((0.5, 4), (1.0, 2), (0.25, 8)):
            ev.update(np.array([acc], np.float32), n)
        got.append((ev.eval(), ev.metrics[0].name))
        ev.reset()
        assert ev.eval() == 0.0
    assert got[0] == got[1]
