"""The RNN-search seq2seq and its decode ops, port vs reference, on the
CPU: models/rnn_search.py trained 3 Adam steps in both packages from the
reference startup's weights (vocab 50, emb 16, hidden 16 and 64, batch 8,
ragged source lengths), then greedy and beam generation from each
package's trained scope; the reference's two end-to-end tests
(tests/test_models_e2e.py: it trains; the decodes reproduce training)
in the port; and generation_decode on the v1 seq2seq the JAX package's
trainer_config_helpers shim builds, serialized by the reference and
loaded by the port (the shim itself is not ported).

Tolerances: fp32 losses rtol 1e-5 and each parameter's change within
1e-3 of its largest reference change plus 4 float32 ulps of the
parameter (the same products summed in another order); bf16 AMP losses
rtol 2e-3 (the recurrences round at other points, tests/test_torch_rnn.py);
ids exact; beam scores atol 1e-5.
"""

import importlib
import json
import os

import numpy as np
import pytest

import jax  # noqa: F401  (port tests import both frameworks)

import paddle_tpu as fluid
from paddle_tpu.core.serialize import program_to_dict as jax_to_dict

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.serialize import program_from_dict
from paddle_tpu_torch.weights import load_into_scope

from test_torch_control_flow import run_both

VOCAB, EMB, BATCH, SRC, TRG = 50, 16, 8, 6, 5
LENS = np.array([6, 3, 1, 6, 2, 5, 4, 6], 'int32')

# the v1 generation program phase 20e of chip_smoke.py runs on the card
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       'fixtures', 'generation_decode_v1.json')


def _model(pkg):
    return importlib.import_module(pkg.__name__ + '.models.rnn_search')


def _feed(seed=0):
    feed = _model(fluid).make_fake_batch(BATCH, SRC, TRG, VOCAB, VOCAB,
                                         seed=seed)
    feed['src_len'] = LENS.copy()
    return feed


def _train(hidden, amp=None, steps=3):
    """3 Adam steps in each package: (reference losses, port losses,
    reference scope, port scope, the startup's arrays)."""
    def build(pkg):
        pkg.default_main_program().amp = amp
        return [_model(pkg).rnn_search(VOCAB, VOCAB, EMB, hidden)[0]]
    trace = []
    _, _, jscope, pscope, w0 = run_both(
        build, _feed(), steps=steps, trace=trace,
        optimizer=lambda pkg: pkg.optimizer.Adam(1e-3))
    ref = [float(r[0].reshape(-1)[0]) for r, _ in trace]
    got = [float(g[0].reshape(-1)[0]) for _, g in trace]
    return ref, got, jscope, pscope, w0


@pytest.mark.parametrize('hidden', [16, 64])
def test_rnn_search_trains_as_the_reference(hidden):
    """fp32: 3 Adam steps, the losses rtol 1e-5 and every parameter's
    change from the reference startup's value against the reference's."""
    ref, got, jscope, pscope, w0 = _train(hidden)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    params = [p.name for p in fluid.default_main_program().all_parameters()]
    assert len(params) == 18
    for n in params:
        want = np.asarray(jscope.find(n), 'float64') - w0[n]
        moved = pscope.numpy(n).astype('float64') - w0[n]
        assert np.abs(want).max() > 0, n
        atol = 1e-3 * np.abs(want).max() + \
            4 * 2.0 ** -23 * np.abs(w0[n]).max()
        np.testing.assert_allclose(moved, want, rtol=0, atol=atol,
                                   err_msg=n)


def test_rnn_search_trains_as_the_reference_bf16():
    """bf16 AMP, hidden 16: 3 Adam steps, the losses rtol 2e-3."""
    ref, got = _train(16, 'bf16')[:2]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=2e-3)


def _decode(pkg, scope, hidden, feed, max_out_len=TRG, beam=4):
    """Greedy ids, then beam ids and scores, of programs built fresh on
    ``scope``'s trained parameters."""
    m = _model(pkg)
    out = []
    for which in ('greedy', 'beam'):
        prog, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(prog, start):
            if which == 'greedy':
                fetch = [m.rnn_search_greedy_infer(
                    VOCAB, VOCAB, EMB, hidden, max_out_len=max_out_len)[0]]
            else:
                fetch = list(m.rnn_search_beam_infer(
                    VOCAB, VOCAB, EMB, hidden, max_out_len=max_out_len,
                    beam_size=beam)[:2])
        with pkg.scope_guard(scope):
            out += [np.asarray(v) for v in pkg.Executor(pkg.CPUPlace()).run(
                prog, feed={'src_word': feed['src_word'],
                            'src_len': feed['src_len']}, fetch_list=fetch)]
    return out


@pytest.mark.parametrize('hidden', [16, 64])
def test_rnn_search_decodes_match_the_reference(hidden):
    """From each package's scope after the 3 steps: greedy ids equal,
    beam ids equal and beam scores within 1e-5, max_out_len 7 (past the
    target length, so the EOS freeze shows)."""
    _, _, jscope, pscope, _ = _train(hidden)
    feed = _feed()
    ref = _decode(fluid, jscope, hidden, feed, max_out_len=7)
    got = _decode(pt, pscope, hidden, feed, max_out_len=7)
    assert got[0].shape == (BATCH, 7) and got[1].shape == (BATCH, 4, 7)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=1e-5)


def _port_trains(steps, lr, vocab, feed, hidden=16):
    pt.reset_default_programs()
    cost, _ = _model(pt).rnn_search(vocab, vocab, EMB, hidden)
    pt.optimizer.Adam(learning_rate=lr).minimize(cost)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    with pt.scope_guard(scope):
        exe.run(pt.default_startup_program())
        losses = [float(np.asarray(exe.run(feed=feed, fetch_list=[cost])[0])
                        .reshape(())) for _ in range(steps)]
    return losses, scope


def test_rnn_search_attention_seq2seq_trains():
    """tests/test_models_e2e.py's rnn_search case in the port: 40 Adam
    steps on the copy task, the loss below 0.6 of its first value."""
    losses, _ = _port_trains(40, 5e-3, VOCAB, _model(pt).make_fake_batch(
        8, 6, 5, VOCAB, VOCAB))
    assert losses[-1] < losses[0] * 0.6, losses


def test_rnn_search_decodes_reproduce_training():
    """tests/test_models_e2e.py's decode case in the port: after 200 Adam
    steps on the copy task, greedy reproduces the labels, the top beam
    equals greedy and the beam scores are sorted best first."""
    v = 30
    feed = _model(pt).make_fake_batch(8, 5, 5, v, v)
    _, scope = _port_trains(200, 8e-3, v, feed)
    m = _model(pt)
    gp, bp = pt.Program(), pt.Program()
    with pt.program_guard(gp, pt.Program()):
        gids, _ = m.rnn_search_greedy_infer(v, v, EMB, 16, max_out_len=5)
    with pt.program_guard(bp, pt.Program()):
        bids, bscores, _ = m.rnn_search_beam_infer(v, v, EMB, 16,
                                                   max_out_len=5,
                                                   beam_size=4)
    f = {'src_word': feed['src_word'], 'src_len': feed['src_len']}
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        g = np.asarray(exe.run(gp, feed=f, fetch_list=[gids])[0])
        bi, bs = (np.asarray(x) for x in
                  exe.run(bp, feed=f, fetch_list=[bids, bscores]))
    assert (g == feed['lbl_word']).mean() > 0.8
    assert (bi[:, 0, :] == g).mean() > 0.9
    assert np.all(np.diff(bs, axis=1) <= 1e-5)


# ------------------------------------------------------ generation_decode
V1 = dict(vocab=20, emb=12, hidden=16, t=5, batch=6, beam=4)


def _v1_generation_programs():
    """tests/test_v1_recurrent_group.py's seq2seq generation program
    (encoder, attention decoder step, beam_search with GeneratedInput
    feedback), built by the JAX package's v1 shim: (main, startup, ids,
    scores)."""
    from paddle_tpu.trainer_config_helpers import (
        GeneratedInput, StaticInput, beam_search, memory)
    from test_v1_recurrent_group import _build_encoder, _seq2seq_step
    v, e, h = V1['vocab'], V1['emb'], V1['hidden']
    fluid.reset_default_programs()
    main, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, start):
        enc, proj, boot = _build_encoder(v, e, h, src_name='src')

        def gen_step(enc_s, proj_s, boot_s, emb):
            state = memory(name='dec_state', size=h, boot_layer=boot_s)
            return _seq2seq_step(emb, state, v, h, encoded=enc_s,
                                 encoded_proj=proj_s)[0]

        ids = beam_search(
            step=gen_step,
            input=[StaticInput(enc, is_seq=True), StaticInput(proj),
                   StaticInput(boot), GeneratedInput(
                       size=v, embedding_name='trg_emb', embedding_size=e)],
            bos_id=1, eos_id=0, beam_size=V1['beam'], max_length=V1['t'])
        scores = ids._beam_scores
    return main, start, ids, scores


def _without_provenance(d):
    for block in d['blocks']:
        for op in block['ops']:
            op.pop('provenance', None)
    return d


def v1_generation_feed(batch=V1['batch'], seed=3):
    rng = np.random.RandomState(seed)
    return {'src': rng.randint(2, V1['vocab'], (batch, V1['t'])).astype(
                'int64'),
            'src_len': np.array([5, 2, 4, 5, 1, 3][:batch], 'int32')}


def test_generation_decode_matches_the_reference():
    """The v1 program through the reference's program dict (JSON) into the
    port, the reference startup's parameters copied: beam-4 sentences
    equal, scores within 1e-5. The test also writes the two program
    dicts as tests/fixtures/generation_decode_v1.json, the fixture
    chip_smoke.py's phase 20e runs on the card."""
    main, start, ids, scores = _v1_generation_programs()
    ops = [op.type for op in main.global_block().ops]
    assert ops.count('generation_decode') == 1
    fixture = {'main': _without_provenance(json.loads(json.dumps(
                   jax_to_dict(main)))),
               'startup': _without_provenance(json.loads(json.dumps(
                   jax_to_dict(start)))),
               'fetch': [ids.name, scores.name], 'v1': V1}
    text = json.dumps(fixture, sort_keys=True, indent=1)
    old = open(FIXTURE).read() if os.path.exists(FIXTURE) else None
    if old != text:
        os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
        with open(FIXTURE, 'w') as f:
            f.write(text)
    feed = v1_generation_feed()
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(jscope):
        jexe.run(start)
        ref = [np.asarray(v) for v in jexe.run(main, feed=feed,
                                               fetch_list=[ids, scores])]
    arrays = {n: np.asarray(jscope.find(n)) for n in jscope.keys()
              if jscope.find(n) is not None}
    pmain = program_from_dict(fixture['main'])
    pscope = pt.Scope()
    load_into_scope(arrays, pscope, pt.CPUPlace())
    with pt.scope_guard(pscope):
        got = [np.asarray(v) for v in pt.Executor(pt.CPUPlace()).run(
            pmain, feed=feed, fetch_list=fixture['fetch'])]
    assert got[0].shape == (V1['batch'], V1['beam'], V1['t'])
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-5)
    assert np.all(np.diff(got[1], axis=1) <= 1e-5)


def test_generation_fixture_runs_from_its_own_startup():
    """The fixture as phase 20e uses it, with no JAX package: the port
    runs its startup dict and then its generation program; sentences of
    the right shape, ids in the vocabulary, scores sorted best first."""
    if not os.path.exists(FIXTURE):
        test_generation_decode_matches_the_reference()
    with open(FIXTURE) as f:
        fixture = json.load(f)
    main = program_from_dict(fixture['main'])
    start = program_from_dict(fixture['startup'])
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    with pt.scope_guard(scope):
        exe.run(start)
        ids, scores = (np.asarray(v) for v in exe.run(
            main, feed=v1_generation_feed(), fetch_list=fixture['fetch']))
    assert ids.shape == (V1['batch'], V1['beam'], V1['t'])
    assert ids.min() >= 0 and ids.max() < V1['vocab']
    assert np.all(np.diff(scores, axis=1) <= 1e-5)
