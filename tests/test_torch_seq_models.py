"""The sequence models, port vs reference, on the CPU: bench.py's
bench_rnn_lstm program (built in the reference through its v1
trainer_config_helpers shim, in the port through its own fluid layers:
models/seq_models.lstm_text_classifier), and the reference's
models/{linear,seq_models,srl}.py against the port's, each trained 3
steps in both packages from the reference startup's weights on the same
numpy feed, with ragged lengths (length 0 and full rows among them).

Tolerances: fp32 losses rtol 1e-5 (the same ops with sums in another
order). Each parameter's change over the steps (p - p0) against the
reference's change, leaf by leaf: within 2e-4 of the leaf's largest
reference change plus 4 float32 ulps of its largest magnitude (the
rounding of p itself, which both packages carry). Measured worst 5.0e-5
of the change under Adam (bench_rnn_lstm's lstm_0.w_0) and 1.0e-4 under
SGD (stacked_gru_tagger's fc_2.w_0, whose change of 7.4e-5 sits at the
rounding of p). Adam's step does not see a gradient's scale, so the
models also take 3 SGD steps, where the change is lr times the summed
gradients: a gradient off by any factor fails there. Under bf16 AMP the losses within 1e-2
(relative): the recurrences round every intermediate of a step to bf16 in
the reference and keep fp32 between the values they round in the port
(tests/test_torch_rnn.py); measured worst 1.8e-3 (stacked_lstm_net; the
bench_rnn_lstm program 1.5e-4).
"""

import json

import numpy as np
import pytest

import jax  # noqa: F401  (port tests import both frameworks)

import paddle_tpu as fluid
from paddle_tpu.core.serialize import program_to_dict as jax_to_dict

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.serialize import program_to_dict
from paddle_tpu_torch.weights import load_into_scope

STEPS = 3
BF16_RTOL = 1e-2


def _rnn_lstm_reference(vocab, hidden):
    """bench.py:336's bench_rnn_lstm program, verbatim through the v1
    shim (lstm_num=1)."""
    from paddle_tpu.trainer_config_helpers import (
        AdamOptimizer, L2Regularization, SoftmaxActivation,
        classification_cost, data_layer, embedding_layer, fc_layer,
        last_seq, settings, simple_lstm)
    net = data_layer('data', size=vocab, dtype='int64', seq_type=1)
    net = embedding_layer(input=net, size=128)
    net = simple_lstm(input=net, size=hidden)
    net = last_seq(input=net)
    net = fc_layer(input=net, size=2, act=SoftmaxActivation())
    lab = data_layer('label', 1, dtype='int64')
    loss = classification_cost(input=net, label=lab)
    settings(batch_size=8, learning_rate=2e-3,
             learning_method=AdamOptimizer(),
             regularization=L2Regularization(8e-4),
             gradient_clipping_threshold=25).minimize(loss)
    return loss


def _rnn_lstm_port(vocab, hidden):
    from paddle_tpu_torch.models import seq_models
    return seq_models.lstm_text_classifier(vocab, hidden_dim=hidden)[1]


def _programs(pkg, build):
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        loss = build()
    return main, startup, loss


def _without_provenance(d):
    for block in d['blocks']:
        for op in block['ops']:
            op.pop('provenance', None)
    return d


@pytest.mark.parametrize('hidden', [16, 128])
def test_rnn_lstm_program_is_the_shims(hidden):
    """The port's build holds the shim's program: the same ops in order
    with the same slots, var names and attributes (main and startup, as
    JSON carries them), and the same vars."""
    progs = []
    for pkg, build in ((fluid, _rnn_lstm_reference),
                       (pt, _rnn_lstm_port)):
        main, startup, _ = _programs(pkg, lambda: build(512, hidden))
        to_dict = jax_to_dict if pkg is fluid else program_to_dict
        progs.append([_without_provenance(json.loads(json.dumps(
            to_dict(p)))) for p in (main, startup)])
    ref, got = progs
    types = [op['type'] for op in ref[0]['blocks'][0]['ops']]
    assert types[:9] == ['lookup_table', 'mul', 'lstm', 'sequence_pool',
                         'mul', 'elementwise_add', 'softmax',
                         'cross_entropy', 'mean']
    assert types.count('clip') == 6 and types.count('adam') == 6
    assert got == ref


def _rnn_lstm_feed(batch=8, seq=16, vocab=512, seed=0):
    rng = np.random.RandomState(seed)
    return {'data': rng.randint(1, vocab, (batch, seq)).astype('int64'),
            'data_len': np.array([seq, 0, 5, 1, seq, 9, 3, 12][:batch],
                                 'int32'),
            'label': rng.randint(0, 2, (batch, 1)).astype('int64')}


def train_both(ref_build, port_build, feed, amp, steps=STEPS):
    """``steps`` steps in each package from the reference startup's
    weights: (reference losses, port losses, reference scope, port scope,
    the parameter names)."""
    jmain, jstart, jloss = _programs(fluid, ref_build)
    pmain, _, ploss = _programs(pt, port_build)
    jmain.amp = pmain.amp = amp
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(jscope):
        jexe.run(jstart)
    arrays = {n: np.asarray(jscope.find(n)) for n in jscope.keys()
              if jscope.find(n) is not None}
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    load_into_scope(arrays, pscope, pt.CPUPlace())
    ref, got = [], []
    for _ in range(steps):
        with fluid.scope_guard(jscope):
            ref.append(float(np.asarray(jexe.run(
                jmain, feed=feed, fetch_list=[jloss.name])[0],
                'float32').reshape(-1)[0]))
        with pt.scope_guard(pscope):
            got.append(float(np.asarray(pexe.run(
                pmain, feed=feed, fetch_list=[ploss.name])[0],
                'float32').reshape(-1)[0]))
    params = {p.name: arrays[p.name] for p in jmain.all_parameters()}
    return ref, got, jscope, pscope, params


def _check(ref, got, jscope, pscope, params, amp):
    """The losses, and under fp32 each parameter's change from its start
    value ``params[name]`` against the reference's."""
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    if amp is not None:
        np.testing.assert_allclose(got, ref, rtol=BF16_RTOL)
        return
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    for n, p0 in params.items():
        want = np.asarray(jscope.find(n), 'float64') - p0
        moved = pscope.numpy(n).astype('float64') - p0
        assert np.abs(want).max() > 0, n
        atol = (2e-4 * np.abs(want).max() +
                4 * 2.0 ** -23 * np.abs(p0).max())
        np.testing.assert_allclose(moved, want, rtol=0, atol=atol,
                                   err_msg=n)


@pytest.mark.parametrize('amp', [None, 'bf16'], ids=['fp32', 'bf16'])
def test_rnn_lstm_trains_as_the_reference(amp):
    """bench_rnn_lstm at batch 8 x seq 16 x vocab 512 (hidden 128, Adam
    2e-3 with L2Decay(8e-4) and element-wise clipping at 25): 3 steps."""
    res = train_both(lambda: _rnn_lstm_reference(512, 128),
                     lambda: _rnn_lstm_port(512, 128), _rnn_lstm_feed(), amp)
    _check(*res, amp=amp)
    assert res[1][-1] < res[1][0]


# ------------------------------------------ models/{linear,seq_models,srl}
T, VOCAB = 10, 50
LENS = np.array([10, 0, 4, 1, 7, 10], 'int64')


def _seq_data(pkg):
    L = pkg.layers
    return (L.data(name='words', shape=[T], dtype='int64'),
            L.data(name='label', shape=[1], dtype='int64'),
            L.data(name='length', shape=[], dtype='int64'))


def _conv_net(pkg):
    from importlib import import_module
    m = import_module(pkg.__name__ + '.models.seq_models')
    data, label, length = _seq_data(pkg)
    return m.convolution_net(data, label, VOCAB, emb_dim=8, hid_dim=12,
                             length=length)[1]


def _lstm_net(pkg):
    from importlib import import_module
    m = import_module(pkg.__name__ + '.models.seq_models')
    data, label, length = _seq_data(pkg)
    return m.stacked_lstm_net(data, label, VOCAB, emb_dim=8, hid_dim=12,
                              stacked_num=3, length=length)[1]


def _gru_tagger(pkg):
    from importlib import import_module
    m = import_module(pkg.__name__ + '.models.seq_models')
    L = pkg.layers
    word = L.data(name='words', shape=[T], dtype='int64')
    target = L.data(name='target', shape=[T, 1], dtype='int64')
    length = L.data(name='length', shape=[], dtype='int64')
    return m.stacked_gru_tagger(word, target, VOCAB, 5, emb_dim=8,
                                hidden_dim=12, depth=2, length=length)[1]


def _srl(pkg):
    from importlib import import_module
    m = import_module(pkg.__name__ + '.models.srl')
    L = pkg.layers
    word, mark, target = (L.data(name=n, shape=[T], dtype='int64')
                          for n in ('word', 'mark', 'target'))
    length = L.data(name='length', shape=[], dtype='int64')
    emission, _, avg = m.srl_tagger(word, mark, target, VOCAB, 5,
                                    emb_dim=8, hidden_dim=12, depth=2,
                                    length=length)
    m.srl_decode(emission, length=length)
    return avg


def _fit_a_line(pkg):
    from importlib import import_module
    return import_module(pkg.__name__ + '.models.linear').fit_a_line()[1]


def _feed(name, seed=3):
    rng = np.random.RandomState(seed)
    n = len(LENS)
    if name == 'fit_a_line':
        x = rng.randn(n, 13).astype('f')
        return {'x': x, 'y': (x.sum(1, keepdims=True) * 0.1).astype('f')}
    if name == 'srl':
        words = rng.randint(1, VOCAB, (n, T)).astype('int64')
        marks = (rng.rand(n, T) < 0.2).astype('int64')
        return {'word': words, 'mark': marks,
                'target': ((words + marks) % 5).astype('int64'),
                'length': LENS}
    feed = {'words': rng.randint(1, VOCAB, (n, T)).astype('int64'),
            'length': LENS}
    if name == 'stacked_gru_tagger':
        feed['target'] = rng.randint(0, 5, (n, T, 1)).astype('int64')
    else:
        feed['label'] = rng.randint(0, 2, (n, 1)).astype('int64')
    return feed


MODELS = {'convolution_net': _conv_net, 'stacked_lstm_net': _lstm_net,
          'stacked_gru_tagger': _gru_tagger, 'srl': _srl,
          'fit_a_line': _fit_a_line}
LR = 1e-2


@pytest.mark.parametrize('amp', [None, 'bf16'], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('model', sorted(MODELS))
def test_model_trains_as_the_reference(model, amp):
    """The reference's builder and the port's, 3 Adam steps in each."""
    build = MODELS[model]

    def with_adam(pkg):
        def run():
            loss = build(pkg)
            pkg.optimizer.Adam(learning_rate=LR).minimize(loss)
            return loss
        return run
    res = train_both(with_adam(fluid), with_adam(pt), _feed(model), amp)
    _check(*res, amp=amp)


@pytest.mark.parametrize('model', sorted(MODELS))
def test_model_sgd_steps_move_parameters_as_the_reference(model):
    """3 SGD steps in each package at fp32: every parameter moves by the
    reference's lr times its summed gradients."""
    build = MODELS[model]

    def with_sgd(pkg):
        def run():
            loss = build(pkg)
            pkg.optimizer.SGD(learning_rate=LR).minimize(loss)
            return loss
        return run
    res = train_both(with_sgd(fluid), with_sgd(pt), _feed(model), None)
    _check(*res, amp=None)


def test_srl_decode_matches_the_reference():
    """srl_decode's Viterbi paths after 3 SGD steps of srl_tagger: equal
    in both packages (fp32), 0 past each row's length."""
    paths = []
    for pkg in (fluid, pt):
        pkg.reset_default_programs()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            avg = _srl(pkg)
            pkg.optimizer.SGD(learning_rate=0.1).minimize(avg)
        decode = [op for op in main.global_block().ops
                  if op.type == 'crf_decoding'][0].output('ViterbiPath')
        paths.append((pkg, main, startup, avg, decode))
    jpkg, jmain, jstart, javg, jdec = paths[0]
    _, pmain, _, pavg, pdec = paths[1]
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(jscope):
        jexe.run(jstart)
    arrays = {n: np.asarray(jscope.find(n)) for n in jscope.keys()
              if jscope.find(n) is not None}
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    load_into_scope(arrays, pscope, pt.CPUPlace())
    feed = _feed('srl')
    for _ in range(STEPS):
        with fluid.scope_guard(jscope):
            want = jexe.run(jmain, feed=feed, fetch_list=[javg.name, jdec])
        with pt.scope_guard(pscope):
            got = pexe.run(pmain, feed=feed, fetch_list=[pavg.name, pdec])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        np.testing.assert_array_equal(got[1], want[1])
    assert (got[1][np.arange(T)[None] >= LENS[:, None]] == 0).all()
