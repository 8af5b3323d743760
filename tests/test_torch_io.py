"""Files across the two packages: the port's io writes and reads the JAX
package's on-disk format. Persistables and checkpoints written by either
package load into the other bit for bit (bf16 vars included); inference
models (fit_a_line and a tiny greedy Transformer) written by either give
the other's fetches; one Program built by both serializes to the same
dict; clone(for_test) and prune keep the same ops; torn checkpoints and
checkpoints of another topology are refused; restores write into the
scope's own tensors."""

import json
import os
import shutil

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as fluid
from paddle_tpu import io as jio
from paddle_tpu.core.serialize import program_to_dict as jax_to_dict
from paddle_tpu.models import transformer as JT

import paddle_tpu_torch as pt
from paddle_tpu_torch import io as pio
from paddle_tpu_torch.core.serialize import (program_from_dict,
                                             program_to_dict)
from paddle_tpu_torch.fault import CheckpointConfig, CheckpointManager
from paddle_tpu_torch.fault import inject
from paddle_tpu_torch.models import transformer as PT
from paddle_tpu_torch.weights import load_into_scope

BF16_VAR = 'bf16_state'


def _fit_a_line(pkg, opt='adam', lr=0.01):
    """fit_a_line (the README's first example) with Adam or SGD, plus one
    bfloat16 persistable: (main, startup, loss, pred)."""
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data(name='x', shape=[13], dtype='float32')
        y = pkg.layers.data(name='y', shape=[1], dtype='float32')
        pred = pkg.layers.fc(input=x, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        if opt == 'adam':
            pkg.optimizer.Adam(learning_rate=lr).minimize(loss)
        else:
            pkg.optimizer.SGD(learning_rate=lr).minimize(loss)
        main.global_block().create_var(name=BF16_VAR, shape=(3, 5),
                                       dtype='bfloat16', persistable=True)
    return main, startup, loss, pred


def _feed(seed, n=16):
    rng = np.random.RandomState(seed)
    xs = rng.randn(n, 13).astype('float32')
    return {'x': xs, 'y': (xs.sum(1, keepdims=True) * 0.1 + 0.5)
            .astype('float32')}


def _bf16_values(seed=3):
    return np.random.RandomState(seed).randn(3, 5).astype('float32')


def _jax_trained(steps=3):
    """The JAX package's fit_a_line + Adam after a few steps, with a bf16
    var in its scope: (scope, exe, main)."""
    main, startup, loss, _ = _fit_a_line(fluid)
    scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        for i in range(steps):
            exe.run(main, feed=_feed(i), fetch_list=[loss])
        scope.set(BF16_VAR, jnp.asarray(_bf16_values(), jnp.bfloat16))
    return scope, exe, main


def _port_trained(steps=3):
    main, startup, loss, _ = _fit_a_line(pt)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        exe.run(startup)
        for i in range(steps):
            exe.run(main, feed=_feed(i), fetch_list=[loss])
        scope.set(BF16_VAR, torch.from_numpy(_bf16_values())
                  .to(torch.bfloat16))
    return scope, exe, main


def _persistables(program):
    return sorted(v.name for v in program.list_vars()
                  if v.persistable and not v.is_data)


def _jax_bits(value):
    arr = np.asarray(value)
    if arr.dtype.name == 'bfloat16':
        return arr.view(np.uint16), 'bfloat16'
    return arr, arr.dtype.name


def _port_bits(value):
    if value.dtype == torch.bfloat16:
        return value.view(torch.int16).numpy().view(np.uint16), 'bfloat16'
    arr = value.numpy()
    return arr, arr.dtype.name


def _assert_same_bits(jscope, pscope, names):
    for name in names:
        jarr, jdt = _jax_bits(jscope.find(name))
        parr, pdt = _port_bits(pscope.find(name))
        if jdt == 'int32' and pdt == 'int64':
            # the JAX package runs without x64: its int64 vars are int32
            parr = parr.astype('int32')
        else:
            assert jdt == pdt, (name, jdt, pdt)
        np.testing.assert_array_equal(parr, jarr, err_msg=name)


@pytest.mark.parametrize('how', ['persistables', 'checkpoint'])
def test_jax_files_load_into_the_port_bit_for_bit(tmp_path, how):
    jscope, jexe, jmain = _jax_trained()
    d = str(tmp_path / 'ckpt')
    with fluid.scope_guard(jscope):
        if how == 'persistables':
            jio.save_persistables(jexe, d, jmain)
        else:
            jio.save_checkpoint(jexe, d, jmain, step=3)
    pmain = _fit_a_line(pt)[0]
    names = _persistables(pmain)
    assert BF16_VAR in names and len(names) >= 7
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pscope):
        if how == 'persistables':
            pio.load_persistables(pexe, d, pmain)
        else:
            assert pio.load_checkpoint(pexe, d, pmain) == 3
    assert pscope.find(BF16_VAR).dtype == torch.bfloat16
    _assert_same_bits(jscope, pscope, names)


@pytest.mark.parametrize('how', ['persistables', 'checkpoint'])
def test_port_files_load_into_jax_bit_for_bit(tmp_path, how):
    pscope, pexe, pmain = _port_trained()
    d = str(tmp_path / 'ckpt')
    with pt.scope_guard(pscope):
        if how == 'persistables':
            pio.save_persistables(pexe, d, pmain)
        else:
            pio.save_checkpoint(pexe, d, pmain, step=3)
    with open(os.path.join(d, 'manifest.json')) as f:
        assert json.load(f)[BF16_VAR] == {'dtype': 'bfloat16',
                                          'shape': [3, 5]}
    jmain = _fit_a_line(fluid)[0]
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(jscope):
        if how == 'persistables':
            jio.load_persistables(jexe, d, jmain)
        else:
            assert jio.load_checkpoint(jexe, d, jmain) == 3
    _assert_same_bits(jscope, pscope, _persistables(pmain))


def test_checkpoint_meta_is_the_reference_format(tmp_path):
    """checkpoint.json of both packages carries the same keys: format
    version 2, the all-ones mesh, one host, both sha1s, step, reader and
    trainer state."""
    pscope, pexe, pmain = _port_trained(1)
    jscope, jexe, jmain = _jax_trained(1)
    metas = []
    for name, scope_guard, save, scope, exe, main in (
            ('port', pt.scope_guard, pio.save_checkpoint, pscope, pexe,
             pmain),
            ('jax', fluid.scope_guard, jio.save_checkpoint, jscope, jexe,
             jmain)):
        d = str(tmp_path / name)
        with scope_guard(scope):
            save(exe, d, main, step=7,
                 trainer_state={'epoch': 1, 'epoch_step': 2})
        with open(os.path.join(d, 'checkpoint.json')) as f:
            metas.append(json.load(f))
    port, ref = metas
    assert sorted(port) == sorted(ref)
    for key in ('step', 'trainer', 'format_version', 'mesh', 'hosts'):
        assert port[key] == ref[key], key
    assert port['mesh'] == {'dp': 1, 'pp': 1, 'sp': 1, 'tp': 1, 'ep': 1}


def test_fit_a_line_inference_model_crosses_both_ways(tmp_path):
    """Each package's save_inference_model of fit_a_line (trained a few
    steps) loads through the other's load_inference_model and gives the
    writer's prediction within 1e-6."""
    feed = _feed(9)
    jscope, jexe, jmain = _jax_trained()
    pred_name = [op for op in jmain.global_block().ops
                 if op.type == 'square_error_cost'][0].input('X')
    d = str(tmp_path / 'from_jax')
    with fluid.scope_guard(jscope):
        jio.save_inference_model(d, ['x'], [jmain.global_block()
                                            .var(pred_name)], jexe, jmain)
        want = np.asarray(jexe.run(jmain, feed=feed,
                                   fetch_list=[pred_name])[0])
    with pt.scope_guard(pt.Scope()):
        pexe = pt.Executor(pt.CPUPlace())
        prog, feeds, fetch = pio.load_inference_model(d, pexe)
        assert feeds == ['x'] and [v.name for v in fetch] == [pred_name]
        assert 'backward_marker' not in [o.type for o in
                                         prog.global_block().ops]
        got = pexe.run(prog, feed={'x': feed['x']}, fetch_list=fetch)[0]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    pscope, pexe, pmain = _port_trained()
    d = str(tmp_path / 'from_port')
    with pt.scope_guard(pscope):
        pio.save_inference_model(d, ['x'], [pmain.global_block()
                                            .var(pred_name)], pexe, pmain)
        want = pexe.run(pmain, feed=feed, fetch_list=[pred_name])[0]
    with fluid.scope_guard(fluid.Scope()):
        jexe = fluid.Executor(fluid.CPUPlace())
        prog, feeds, fetch = jio.load_inference_model(d, jexe)
        got = np.asarray(jexe.run(prog, feed={'x': feed['x']},
                                  fetch_list=fetch)[0])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


GREEDY = dict(max_out_len=6, src_seq_len=8, n_layer=2, n_head=2, d_key=8,
              d_value=8, d_model=16, d_inner=32, bos_id=0, eos_id=1)
VOCAB = 24


def _greedy(pkg, model):
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        out, feeds = model.transformer_greedy_infer(VOCAB, VOCAB, **GREEDY)
    return main, startup, out, feeds


def _greedy_feed():
    rng = np.random.RandomState(4)
    return {'src_word': rng.randint(2, VOCAB, (3, 8)).astype('int64'),
            'src_length': np.array([8, 5, 3], 'int64')}


def test_greedy_transformer_inference_model_crosses_both_ways(tmp_path):
    """A tiny transformer_greedy_infer (unrolled) saved by the JAX package
    loads into the port and decodes the same tokens, and the port's file
    (from the same weights) loads into the JAX package the same way."""
    feed = _greedy_feed()
    jmain, jstart, jout, jfeeds = _greedy(fluid, JT)
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    d = str(tmp_path / 'from_jax')
    with fluid.scope_guard(jscope):
        jexe.run(jstart)
        want = np.asarray(jexe.run(jmain, feed=feed, fetch_list=[jout])[0])
        jio.save_inference_model(d, jfeeds, [jout], jexe, jmain)
    with pt.scope_guard(pt.Scope()):
        pexe = pt.Executor(pt.CPUPlace())
        prog, feeds, fetch = pio.load_inference_model(d, pexe)
        got = pexe.run(prog, feed=feed, fetch_list=fetch)[0]
    np.testing.assert_array_equal(got, want)

    weights = {n: np.asarray(jscope.find(n)) for n in jscope.keys()
               if jscope.find(n) is not None}
    pmain, _, pout, pfeeds = _greedy(pt, PT)
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    load_into_scope(weights, pscope, pt.CPUPlace())
    d = str(tmp_path / 'from_port')
    with pt.scope_guard(pscope):
        np.testing.assert_array_equal(
            pexe.run(pmain, feed=feed, fetch_list=[pout])[0], want)
        pio.save_inference_model(d, pfeeds, [pout], pexe, pmain)
    with fluid.scope_guard(fluid.Scope()):
        jexe = fluid.Executor(fluid.CPUPlace())
        prog, feeds, fetch = jio.load_inference_model(d, jexe)
        got = np.asarray(jexe.run(prog, feed=feed, fetch_list=fetch)[0])
    np.testing.assert_array_equal(got, want)


def _lifecycle_program(pkg, model):
    """A tiny Transformer with noam, a global-norm clip and L2 decay."""
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        avg_cost, _ = model.transformer_base(
            src_vocab_size=32, trg_vocab_size=32, src_seq_len=8,
            trg_seq_len=8, n_layer=1, d_model=16, d_inner=32, d_key=8,
            d_value=8, n_head=2, dropout_rate=0.1)
        pkg.clip.set_gradient_clip(pkg.clip.GradientClipByGlobalNorm(1.0))
        lr = pkg.learning_rate_decay.noam_decay(16, 4)
        pkg.optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.98,
                           epsilon=1e-9,
                           regularization=pkg.regularizer.L2Decay(1e-4)) \
            .minimize(avg_cost)
    return main, startup, avg_cost


@pytest.mark.parametrize('which', ['fit_a_line', 'transformer'])
def test_program_to_dict_equal_across_packages(which):
    """One Program built by both packages serializes to the same dict,
    each op's provenance (the test's own line that built it) included,
    and the port's dict loads back into the same dict."""
    if which == 'fit_a_line':
        jmain, pmain = _fit_a_line(fluid)[0], _fit_a_line(pt)[0]
    else:
        jmain = _lifecycle_program(fluid, JT)[0]
        pmain = _lifecycle_program(pt, PT)[0]
    ref = json.loads(json.dumps(jax_to_dict(jmain)))
    got = json.loads(json.dumps(program_to_dict(pmain)))
    assert got == ref
    again = json.loads(json.dumps(program_to_dict(program_from_dict(got))))
    assert again == got


def test_clone_for_test_and_prune_match_the_reference():
    (jmain, _, jcost), (pmain, _, pcost) = [
        _lifecycle_program(pkg, m) for pkg, m in ((fluid, JT), (pt, PT))]
    for for_test in (False, True):
        jc, pc = jmain.clone(for_test=for_test), pmain.clone(
            for_test=for_test)
        assert json.loads(json.dumps(jax_to_dict(jc))) == \
            json.loads(json.dumps(program_to_dict(pc)))
    pc = pmain.clone(for_test=True)
    assert 'backward_marker' not in [o.type for o in pc.global_block().ops]
    assert all(o.attrs['is_test'] for o in pc.global_block().ops
               if o.type == 'dropout')
    assert pcost.name == jcost.name
    jp, pp = jmain.prune([jcost]), pmain.prune([pcost])
    assert json.loads(json.dumps(jax_to_dict(jp))) == \
        json.loads(json.dumps(program_to_dict(pp)))
    kept = [o.type for o in pp.global_block().ops]
    assert 'adam' not in kept and 'backward_marker' in kept
    assert len(kept) < len(pmain.global_block().ops)


def _port_checkpoint(d, step=2):
    pscope, pexe, pmain = _port_trained(1)
    with pt.scope_guard(pscope):
        pio.save_checkpoint(pexe, d, pmain, step=step)
    return pscope, pexe, pmain


def test_torn_checkpoint_is_refused(tmp_path):
    d = str(tmp_path / 'c')
    pscope, pexe, pmain = _port_checkpoint(d)
    assert pio.verify_checkpoint(d)['step'] == 2
    inject.truncate_file(os.path.join(d, 'params.npz'))
    with pytest.raises(ValueError, match='torn'):
        pio.verify_checkpoint(d)
    with pt.scope_guard(pscope), pytest.raises(ValueError, match='torn'):
        pio.load_checkpoint(pexe, d, pmain)
    d = str(tmp_path / 'c2')
    _port_checkpoint(d)
    os.remove(os.path.join(d, 'manifest.json'))
    with pytest.raises(ValueError, match='missing'):
        pio.verify_checkpoint(d)


def test_manager_falls_back_past_a_torn_checkpoint(tmp_path):
    """The newest checkpoint torn after its commit: restore skips it and
    loads the previous one; with every one torn it raises."""
    pscope, pexe, pmain = _port_trained(1)
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path),
                                             async_save=False))
    with pt.scope_guard(pscope):
        mgr.save(pexe, pmain, step=1)
        w1 = pscope.numpy('fc_0.w_0')
        pexe.run(pmain, feed=_feed(5), fetch_list=[])
        mgr.save(pexe, pmain, step=2)
        inject.truncate_file(os.path.join(mgr.step_dir(2), 'params.npz'))
        with pytest.warns(UserWarning, match='unusable'):
            meta = mgr.restore(pexe, pmain)
        assert meta['step'] == 1
        np.testing.assert_array_equal(pscope.numpy('fc_0.w_0'), w1)
        inject.truncate_file(os.path.join(mgr.step_dir(1), 'params.npz'))
        from paddle_tpu_torch.fault import NoUsableCheckpointError
        with pytest.warns(UserWarning), \
                pytest.raises(NoUsableCheckpointError):
            mgr.restore(pexe, pmain)


@pytest.mark.parametrize('edit', [{'mesh': {'dp': 2, 'pp': 1, 'sp': 1,
                                            'tp': 1, 'ep': 1}},
                                  {'hosts': 2}])
def test_checkpoint_of_another_topology_raises(tmp_path, edit):
    d = str(tmp_path / 'c')
    pscope, pexe, pmain = _port_checkpoint(d)
    path = os.path.join(d, 'checkpoint.json')
    with open(path) as f:
        meta = json.load(f)
    meta.update(edit)
    with open(path, 'w') as f:
        json.dump(meta, f)
    with pt.scope_guard(pscope), \
            pytest.raises(NotImplementedError, match='Queue 1 item 9'):
        pio.load_checkpoint(pexe, d, pmain)


def test_restore_writes_into_the_scope_tensors(tmp_path):
    """load_checkpoint copies into the tensors the scope holds (their
    addresses stay: a captured graph keeps replaying), and values saved
    in another dtype (the JAX package's int32 counter) take the var's."""
    d = str(tmp_path / 'c')
    pscope, pexe, pmain = _port_checkpoint(d)
    saved = {n: pscope.numpy(n) for n in _persistables(pmain)}
    ptrs = {n: pscope.find(n).data_ptr() for n in saved}
    with pt.scope_guard(pscope):
        pexe.run(pmain, feed=_feed(7), fetch_list=[])
        assert not np.array_equal(pscope.numpy('fc_0.w_0'),
                                  saved['fc_0.w_0'])
        pio.load_checkpoint(pexe, d, pmain)
    for n in saved:
        assert pscope.find(n).data_ptr() == ptrs[n], n
        np.testing.assert_array_equal(pscope.numpy(n), saved[n])


def test_async_save_snapshots_before_returning(tmp_path):
    """save_checkpoint(async_save=True) copies every tensor before it
    returns: steps run while the write is in flight do not reach the
    file."""
    pscope, pexe, pmain = _port_trained(1)
    d = str(tmp_path / 'c')
    with pt.scope_guard(pscope):
        want = pscope.numpy('fc_0.w_0')
        handle = pio.save_checkpoint(pexe, d, pmain, step=1,
                                     async_save=True)
        for i in range(3):
            pexe.run(pmain, feed=_feed(10 + i), fetch_list=[])
        handle.result()
        assert handle.done()
        assert not np.array_equal(pscope.numpy('fc_0.w_0'), want)
        pio.load_checkpoint(pexe, d, pmain)
    np.testing.assert_array_equal(pscope.numpy('fc_0.w_0'), want)
    shutil.rmtree(d)
