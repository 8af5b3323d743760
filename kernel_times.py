#!/usr/bin/env python3
"""Device times of the layer norm (K1) and its backward, paged attention
(K4, and its quantized variant at int8 and e4m3), the flash-attention
forward (K2) and backward (K3) and the training
batch norm (K5) and its backward of one checkout of this repository, at
chip_smoke.py's phase-3 shapes, and SDPA's backward beside K3 (the same
inputs and mask, whatever the checkout). A kernel the checkout does not
have (a backward kernel before it was written) is reported as such.

    python3 kernel_times.py [DIR]           # on a machine with one CUDA card
    python3 kernel_times.py [DIR] --decode  # the decode step instead
    python3 kernel_times.py [DIR] --train   # the Transformer's steps instead
    python3 kernel_times.py [DIR] --write   # a layer's KV write and K4
    python3 kernel_times.py [DIR] --serve   # the engine's tokens/s, TTFT
    python3 kernel_times.py [DIR] --encoder # phase 16a's encoder layer
    python3 kernel_times.py [DIR] --rnn     # bench_rnn_lstm and its cells
    python3 kernel_times.py [DIR] --moe     # phase 18a's bench_moe steps
    python3 kernel_times.py [DIR] --seq2seq # phase 20's rnn_search, SSD
    python3 kernel_times.py [DIR] --pool    # the max pool and CNN steps
    python3 kernel_times.py [DIR] --cells   # the RNN cells at hidden 512
    python3 kernel_times.py [DIR] --gru     # the GRU at hidden 512, models

DIR (default: this checkout) holds the ``paddle_tpu_torch`` package to
time; the shapes, the inputs and the timer (CUDA-graph replay, CUDA events)
are this checkout's chip_smoke.py's. To compare two commits, unpack the
earlier one (``git archive <commit> | tar -x -C DIR``) and run both back to
back on the same card, each twice: earlier, this, this, earlier.

With --decode, it builds DIR's DecodeEngine at chip_smoke.py's full width
and profiles 20 decode steps with every slot busy on fp32 arenas, 20
verify steps (spec_k = 3) and 20 decode steps on int8 arenas, as
chip_smoke.py --profile does (wall, device busy, launches a step), in
place of the kernel cases.

With --train, it runs DIR's Transformer training at chip_smoke.py's
widths (bf16 AMP, dropout 0.1, Adam): the unrolled step and scan_layers
at batch 64 x seq 64 (phases 6, 6b) and the masked cell at batch 8 x seq
512 (phase 7), each 3 warm-up and 20 timed steps captured (ms a step on
the host clock, peak memory above what was allocated before the first
step), then profiles 5 steps of each as chip_smoke.py --profile does
(device busy time a step, by kernel family), and times DIR's keep-mask
kernel at the Transformer's two dropout shapes.

With --write, it times one decode layer's KV write and paged attention
on chip_smoke.py's write_inputs (the decode step's 16 rows at fp32, bf16,
int8 and e4m3 arenas, bf16 rows into the bf16 one, fp32 rows into the
others; the verify step's 64 rows and the 512-row prefill at fp32 and
int8) as DIR's decode op runs them: through its write_attend where it has
one (the write folded into K4's launch where the op folds it, else
kv_write then paged_attention), else kv_write then paged_attention; K4
alone on the same inputs; and, where DIR has paged_attention_write, that
launch on every case whose rows have the arena's dtype, the prefill's
among them.

With --serve, it builds DIR's DecodeEngine at chip_smoke.py's full width
on fp32 and on int8 arenas and serves chip_smoke.py's phase-4 requests
(32 prompts of 64-512 tokens, 64 new tokens) from 16 threads, as that
phase does, three times an engine: tokens/s and TTFT p50 and p99 on the
host's clock.

With --encoder, it runs DIR's encoder layer of public layers at
chip_smoke.py's phase-16a width (batch 64 x seq 64, d_model 512, 8
heads, d_inner 2048, SGD) at fp32 and under bf16 AMP: 3 warm-up and 20
timed steps captured (ms a step on the host clock), then profiles 5
steps of each as chip_smoke.py --profile does (device busy time a step,
by kernel family and by kernel).

With --rnn, it runs DIR's bench_rnn_lstm program at chip_smoke.py's
phase-19 width (batch 128 x seq 100, vocab 30000, hidden 128, bf16 AMP,
Adam with L2 decay and value clipping): 3 warm-up and 20 timed steps
captured (ms a step on the host clock, peak memory above what was
allocated before the first step), then profiles 5 steps as
chip_smoke.py --profile does (device busy time and kernels a step, by
family), then times the four cell kernels at its step (B 128, hidden
128, bf16, full lengths; a GRU step's two launches together) by graph
replay, the whole LSTM and GRU recurrences forward and backward
(LstmRecurrence, GruRecurrence) at that shape, and, where DIR has them,
the LSTM and GRU sequence kernels at that recurrence beside their plain
versions, the per-position path, their floor (T steps of the cluster's
exchanges alone at the same launch) and, for the LSTM, cuDNN's nn.LSTM at
fp16 (chip_smoke.py's _rnn_seq_case), then the sequence models of
chip_smoke.py's phase 19b that run a recurrence (stacked_lstm_net,
stacked_gru_tagger, srl_tagger at batch 64 x seq 100, fp32, SGD): 2
warm-up and 20 timed steps captured, ms a step on the host clock and
their recurrence launches. A checkout without the recurrent ops, the
cell kernels or the sequence kernels is reported as such.

With --moe, it runs DIR's bench_moe Switch-MoE LM at chip_smoke.py's
phase-18a width (batch 32 x seq 64, vocab 32000, 4 layers, 8 experts,
bf16 AMP, dropout 0.1, Adam), scan_layers and unrolled, each 3 warm-up
and 20 timed steps captured (ms a step on the host clock), then profiles
5 steps of each as chip_smoke.py --profile does (device busy time and
kernels a step, by family).

With --seq2seq, it runs DIR's models/rnn_search at chip_smoke.py's
phase-20a width (the v1 seqToseq demo's 512 / 512 / 30,000, batch 64 x
50, Adam, fp32), its greedy and beam-4 decoding of that batch at 50
positions, and models/ssd's training step and ssd_infer at phase 20d's
(3 x 128 x 128, 21 classes, max_gt 8, batch 32, Adam, fp32), each
captured: 20 timed calls after 3 (ms a call on the host clock), then 5
profiled as chip_smoke.py --profile does (wall, device busy time and
kernels a call, by family and by kernel). A
checkout without those models is reported as such.

With --pool, it times DIR's max pool through its ops/conv_ops.pool2d at
chip_smoke.py's pool_shapes and at ResNet-50's stem pool over 640² images
in fp32 NHWC (rows too wide to stage whole), so every checkout runs the
same calls: the
forward alone and the forward + backward under autograd (x needing a
gradient; torch.autograd.grad of one cotangent), each by CUDA-graph
replay, beside torch's F.max_pool2d forward + backward on the same x where
one F.max_pool2d call gives the pool (its ceil_mode included); then DIR's captured training steps of ResNet-50
(bench_resnet50: batch 64, NHWC, bf16, Momentum 0.1) and of VGG-16,
GoogLeNet and AlexNet (chip_smoke.py's phase 21b: batch 64 x 224², bf16,
Momentum 0.01): 3 warm-up and 20 timed steps each, ms a step on the host
clock and peak memory above what was allocated before the first step.

With --cells, it times DIR's LSTM and GRU cell kernels at the widths where
the cells run (the sequence kernels have no plan there): bench_rnn_lstm's
LSTM at hidden 512 (B 128, bf16), rnn_search's encoder GRU (B 64, hidden
512, fp32 and bf16) and stacked_gru_tagger's GRU (B 64, hidden 512,
fp32), forward and backward, each against its plain version and beside
its bound and torch's fused LSTM cell (chip_smoke.py's _rnn_cell_case,
timed).

With --gru, it times DIR's GRU at hidden 512, wherever DIR routes it
(the per-position cells before the wide kernels existed): GruRecurrence
forward and backward with dW and dbias at B 64 x T 100 x hidden 512 in
fp32 and bf16 by graph replay (chip_smoke.py's inputs of
_recurrence_vs_cudnn, full lengths), then captured training steps of
stacked_gru_tagger at hidden 512 (batch 64 x seq 100, fp32, SGD; 20 timed
after 2) and of models/rnn_search at phase 20a's width (the v1 seqToseq
demo's 512 / 512 / 30,000, batch 64 x 50, Adam) in fp32 and under bf16
AMP (20 timed after 3), ms a step on the host clock, each with the GRU
launches of its timed runs. Run it on the parent and on this tree in
turns (parent, this, this, parent) to compare them.

Nothing is checked here: chip_smoke.py holds each kernel against its plain
versions. Prints one line a case, then nvidia-smi's name and power limit,
then one JSON object {"port": DIR, "card": ..., "ms": {case: ms}}.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def encoder_steps(torch, smoke, card, steps=20):
    """--encoder: DIR's phase-16a encoder layer; returns {label: ms}."""
    import paddle_tpu_torch as pt
    dev = torch.device('cuda', 0)
    ms, jobs = {}, []
    for amp in (None, 'bf16'):
        label = 'encoder %s' % (amp or 'fp32')
        ms[label], tok_s, _, losses = smoke._encoder_timed(
            torch, pt, pt.CUDAPlace(0), card, True, smoke.ENC_DIMS, 64, 64,
            amp, 3, steps)
        print('%s: batch 64 x seq 64, %d steps after 3 warm-up: %.3f '
              'ms/step, %.1f tokens/s; loss first %.5f last %.5f [%s]'
              % (label, steps, ms[label], tok_s, losses[0], losses[-1],
                 card))
        main, startup, loss = smoke._encoder_program(
            pt, 64, 64, dropout=0.0, amp=amp, **smoke.ENC_DIMS)
        exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope()
        with pt.scope_guard(scope):
            exe.run(startup)
        feed = {n: torch.as_tensor(v).to(dev) for n, v in
                smoke._encoder_feed(64, 64, 512).items()}

        def step(exe=exe, scope=scope, main=main, feed=feed, loss=loss):
            with pt.scope_guard(scope):
                exe.run(main, feed=feed, fetch_list=[loss],
                        return_numpy=False)
        jobs.append(('5 %s steps' % label, step, 5, None))
    smoke.profile_steps(torch, card, jobs)
    return ms


def decode_step(torch, smoke, card):
    """Profile DIR's decode step at chip_smoke.py's engine width (fp32
    arenas), its verify step (spec_k = 3) and its decode step on int8
    arenas, one engine at a time."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.serving.decode import DecodeEngine, LMSpec
    spec = LMSpec(vocab_size=32000, n_layer=12, n_head=8, d_key=64,
                  d_value=64, d_model=512, d_inner=2048)
    weights = smoke.lm_weights(spec)
    for kw, k in ((dict(), 0), (dict(spec_k=3), 3),
                  (dict(kv_dtype='int8'), 0)):
        eng = DecodeEngine(spec, max_batch=16, block_size=32,
                           num_blocks=4096, pages_per_seq=64,
                           place=pt.CUDAPlace(0), weights=weights, **kw)
        eng.warmup()
        smoke.profile_steps(torch, card, [smoke._decode_job(eng, spec, k=k)])
        del eng
        torch.cuda.empty_cache()


def train_steps(torch, smoke, card, steps=20):
    """--train: DIR's Transformer training cells; returns {label: ms}."""
    import numpy as np
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.ops.kernels import random_bits as rb
    dev = torch.device('cuda', 0)
    ms = {}
    for shape in ((64, 64, 2048), (64, 64, 512)):
        step = torch.tensor(7, dtype=torch.int64, device=dev)
        label = 'keep_mask %s bfloat16' % list(shape)
        ms[label] = smoke.device_ms(torch, lambda: rb.keep_mask(
            shape, 0.9, 0x1234567, step, dev, torch.bfloat16))
        print('%s: kernel %.5f ms [%s]' % (label, ms[label], card))
    base = dict(n_layer=6, n_head=8, d_key=64, d_value=64, d_model=512,
                d_inner=2048)
    jobs = []
    for label, dims, batch, seq in (
            ('unrolled', base, 64, 64),
            ('scan_layers', dict(base, scan_layers=True), 64, 64),
            ('masked', base, 8, 512)):
        avg_cost = smoke._build_train(pt, smoke.VOCAB, seq, 0.1, 'bf16',
                                      **dims)
        program = pt.default_main_program()
        feed = T.make_fake_batch(batch, seq, seq, smoke.VOCAB, smoke.VOCAB,
                                 seed=0)
        if label == 'masked':
            lens = np.random.RandomState(0).randint(
                seq // 2, seq + 1, (batch,)).astype('int64')
            feed['src_length'] = lens
            feed['lbl_weight'] = (np.arange(seq)[None, :] <
                                  lens[:, None]).astype('float32')
        exe = pt.Executor(pt.CUDAPlace(0))
        scope = pt.Scope()
        with pt.scope_guard(scope):
            exe.run(pt.default_startup_program())
            feed = {n: torch.as_tensor(v).to(dev) for n, v in feed.items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            smoke._train_steps(torch, exe, feed, avg_cost, 3, True)
            secs, losses = smoke._train_steps(torch, exe, feed, avg_cost,
                                              steps, True)
            peak = torch.cuda.max_memory_allocated() - before
        ms['train ' + label] = secs * 1e3 / steps
        print('train %s: batch %d x seq %d, %d steps after 3 warm-up: %.3f '
              'ms/step, peak memory %.4f GB above what was allocated before '
              'the first step; loss first %.5f last %.5f [%s]'
              % (label, batch, seq, steps, ms['train ' + label], peak / 1e9,
                 losses[0], losses[-1], card))

        def step(exe=exe, scope=scope, program=program, feed=feed,
                 avg_cost=avg_cost):
            with pt.scope_guard(scope):
                exe.run(program, feed=feed, fetch_list=[avg_cost],
                        return_numpy=False)
        jobs.append(('5 train %s steps' % label, step, 5, None))
    smoke.profile_steps(torch, card, jobs)
    return ms


def write_layers(torch, smoke, card):
    """--write: DIR's KV write and attention of one layer; {label: ms}."""
    from paddle_tpu_torch.ops import paged_decode_ops as ops
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.ops.kernels.kv_write import kv_write
    fold = getattr(pa, 'paged_attention_write', None)
    gen = torch.Generator(device='cuda').manual_seed(5)
    ms = {}
    for kind, dtypes in (('decode', ('float32', 'bfloat16', 'int8',
                                     'float8_e4m3fn')),
                         ('verify', ('float32', 'int8')),
                         ('prefill512', ('float32', 'int8'))):
        for kv_dtype in dtypes:
            src = torch.bfloat16 if kv_dtype == 'bfloat16' else None
            t = smoke.write_inputs(torch, gen, kind, kv_dtype, src=src)
            kw = dict(k_scales=t['ks'], v_scales=t['vs'])
            direct = t['k_new'].dtype == t['kp'].dtype

            def k4():
                return pa.paged_attention(t['q'], t['kp'], t['vp'],
                                          t['tables'], t['lens'], **kw)
            if hasattr(ops, 'write_attend'):
                fresh = (t['fresh_lo'], t['fresh_src']) \
                    if kind != 'prefill512' and direct else None

                def layer():
                    return ops.write_attend(
                        t['q'], t['k_new'], t['v_new'], t['kp'], t['vp'],
                        t['tables'], t['lens'], t['phys'], t['off'],
                        t['keep'], fresh, t['ks'], t['vs'])
                how = 'one launch, the write folded in' if fresh \
                    else 'kv_write, then K4'
            else:
                def layer():
                    kv_write(t['k_new'], t['v_new'], t['kp'], t['vp'],
                             t['phys'], t['off'], t['keep'], t['ks'],
                             t['vs'])
                    return k4()
                how = 'kv_write, then K4'
            case = '%s %s' % (kind, kv_dtype)
            ms['layer ' + case] = smoke.device_ms(torch, layer)
            ms['K4 ' + case] = smoke.device_ms(torch, k4)
            line = ('layer %s (%s): %.5f ms; K4 alone %.5f ms; the write '
                    '%+.5f ms' % (case, how, ms['layer ' + case],
                                  ms['K4 ' + case],
                                  ms['layer ' + case] - ms['K4 ' + case]))
            if fold is not None and direct:
                args = smoke._write_args(t)
                ms['fused ' + case] = smoke.device_ms(
                    torch, lambda: fold(*args))
                line += '; paged_attention_write %.5f ms (%+.5f)' % (
                    ms['fused ' + case], ms['fused ' + case] -
                    ms['K4 ' + case])
            print('%s [%s]' % (line, card))
            del t
            torch.cuda.empty_cache()
    return ms


def serve(torch, smoke, card, rounds=3):
    """--serve: DIR's engine at chip_smoke.py's width, fp32 and int8
    arenas, phase 4's requests from 16 threads, ``rounds`` times an
    engine; {label: number}."""
    import threading
    import time
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.serving.decode import DecodeEngine, LMSpec
    spec = LMSpec(vocab_size=32000, n_layer=12, n_head=8, d_key=64,
                  d_value=64, d_model=512, d_inner=2048)
    weights = smoke.lm_weights(spec)
    reqs = smoke._requests(spec, 32, 64, 512, 64)
    out = {}
    for kv_dtype in ('float32', 'int8'):
        eng = DecodeEngine(spec, max_batch=16, block_size=32,
                           num_blocks=4096, pages_per_seq=64,
                           place=pt.CUDAPlace(0), weights=weights,
                           kv_dtype=kv_dtype)
        eng.warmup()
        eng.start()
        for rnd in range(rounds):
            ttft, n_tok, mu = [], [0], threading.Lock()
            steps0 = (eng.prefills, eng.decode_steps)

            def client(k):
                for i in range(k, len(reqs), 16):
                    t_sub = time.perf_counter()
                    first = None
                    toks = 0
                    for _ in eng.submit(**reqs[i]):
                        if first is None:
                            first = time.perf_counter() - t_sub
                        toks += 1
                    with mu:
                        ttft.append(first)
                        n_tok[0] += toks
            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(16)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            eng.drain(60)
            wall = time.perf_counter() - t0
            key = '%s %d' % (kv_dtype, rnd)
            out['tokens_per_s ' + key] = n_tok[0] / wall
            out['ttft_p50_ms ' + key] = 1e3 * smoke._pct(ttft, 50)
            out['ttft_p99_ms ' + key] = 1e3 * smoke._pct(ttft, 99)
            print('serve %s arenas, round %d: %d requests, %d tokens in '
                  '%.3f s: %.1f tokens/s; TTFT p50 %.1f ms, p99 %.1f ms; %d '
                  'prefills, %d decode steps [%s]'
                  % (kv_dtype, rnd, len(reqs), n_tok[0], wall,
                     out['tokens_per_s ' + key], out['ttft_p50_ms ' + key],
                     out['ttft_p99_ms ' + key], eng.prefills - steps0[0],
                     eng.decode_steps - steps0[1], card))
        eng.shutdown()
        del eng
        torch.cuda.empty_cache()
    return out


def rnn_steps(torch, smoke, card, steps=20):
    """--rnn: DIR's bench_rnn_lstm step and its cell kernels; returns
    {label: ms}."""
    import importlib
    import paddle_tpu_torch as pt
    ms = {}
    try:
        K = importlib.import_module('paddle_tpu_torch.ops.kernels.rnn_cell')
        from paddle_tpu_torch.models import seq_models
    except ImportError:
        print('no recurrent ops or cell kernels in this checkout')
        return ms
    dev = torch.device('cuda', 0)
    cfg = smoke.RNN_BENCH
    pt.reset_default_programs()
    _, avg = seq_models.lstm_text_classifier(cfg['vocab'],
                                             hidden_dim=cfg['hidden'])
    pt.default_main_program().amp = 'bf16'
    program = pt.default_main_program()
    exe = pt.Executor(pt.CUDAPlace(0))
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe.run(pt.default_startup_program())
        feed = {n: torch.as_tensor(v).to(dev) for n, v in
                smoke.rnn_lstm_feed(cfg['batch'], cfg['seq'],
                                    cfg['vocab']).items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        smoke._train_steps(torch, exe, feed, avg, 3, True)
        secs, losses = smoke._train_steps(torch, exe, feed, avg, steps, True)
        peak = torch.cuda.max_memory_allocated() - before
    ms['bench_rnn_lstm step'] = secs * 1e3 / steps
    print('bench_rnn_lstm: batch %d x seq %d, %d steps after 3 warm-up: '
          '%.3f ms/step, %.1f tokens/s, peak memory %.4f GB above what was '
          'allocated before the first step; loss first %.5f last %.5f [%s]'
          % (cfg['batch'], cfg['seq'], steps, ms['bench_rnn_lstm step'],
             cfg['batch'] * cfg['seq'] * steps / secs, peak / 1e9, losses[0],
             losses[-1], card))
    def step():
        with pt.scope_guard(scope):
            exe.run(program, feed=feed, fetch_list=[avg],
                    return_numpy=False)
    smoke.profile_steps(torch, card, [('5 bench_rnn_lstm steps', step, 5,
                                       None)])
    b, t, d = cfg['batch'], cfg['seq'], cfg['hidden']
    gen = torch.Generator(device='cuda').manual_seed(19)
    full = [t] * b
    for kind in ('lstm', 'gru'):
        v = smoke._rnn_cell_inputs(torch, kind, b, t, d, torch.bfloat16, gen,
                                   full)
        p, acts = v['pos'], (0, 1, 1) if kind == 'lstm' else (0, 1)
        x, hp, cp = v['x'][:, p], v['seq'][:, p - 1], v['cell'][:, p - 1]
        out = [torch.empty_like(v[k])[:, p] for k in ('seq', 'cell',
                                                      'gates')]
        if kind == 'lstm':
            def fwd():
                K.lstm_cell_fwd(x, v['mm'], v['bias'], hp, cp, v['length'],
                                p, *out, acts)

            def bwd():
                K.lstm_cell_bwd(v['dh'][:, p], None, v['dmm'], v['carry'],
                                v['carry2'], v['gates'][:, p],
                                v['cell'][:, p], cp, v['length'], p, out[2],
                                acts)
        else:
            def fwd():
                for phase, mm, dst in ((0, v['mm'], out[0]),
                                       (1, v['mm_c'], out[1])):
                    K.gru_cell_fwd(phase, x, v['bias'], mm, hp, v['length'],
                                   p, out[2], dst, acts)

            def bwd():
                for phase, dh, mm in ((0, v['dh'][:, p], v['dmm']),
                                      (1, None, v['mm_c'])):
                    K.gru_cell_bwd(phase, dh, mm, v['carry'],
                                   v['gates'][:, p], hp, v['length'], p,
                                   out[2], acts)
        for direction, fn in (('fwd', fwd), ('bwd', bwd)):
            label = '%s_cell_%s [%d, %d] bfloat16' % (kind, direction, b, d)
            ms[label] = smoke.device_ms(torch, fn)
            print('%s: kernel %.5f ms a step (%d launch%s) [%s]'
                  % (label, ms[label], 1 if kind == 'lstm' else 2,
                     '' if kind == 'lstm' else 'es', card))
    # the whole LSTM and GRU recurrences, forward and backward, as DIR's
    # LstmRecurrence and GruRecurrence run them at this shape
    for kind, g in (('lstm', 4), ('gru', 3)):
        x = (0.5 * torch.randn(b, t, g * d, generator=gen, device=dev)).to(
            torch.bfloat16).requires_grad_()
        w = (0.1 * torch.randn(d, g * d, generator=gen, device=dev)).to(
            torch.bfloat16).requires_grad_()
        h0 = torch.zeros(b, d, device=dev, dtype=torch.bfloat16)
        dy = torch.randn(b, t, d, generator=gen, device=dev).to(
            torch.bfloat16)

        def recurrence(kind=kind, x=x, w=w, h0=h0, dy=dy):
            if kind == 'lstm':
                h, _ = K.LstmRecurrence.apply(x, w, None, h0, h0, None,
                                              (0, 1, 1), False)
            else:
                h = K.GruRecurrence.apply(x, w, None, h0, None, (0, 1),
                                          False)
            torch.autograd.grad(h, (x, w), dy)
        label = '%sRecurrence fwd + bwd [%d, %d, %d] bfloat16' % (
            kind.capitalize(), b, t, d)
        ms[label] = smoke.device_ms(torch, recurrence, iters=5)
        print('%s: %.5f ms by graph replay [%s]' % (label, ms[label], card))
    for kind in ('lstm', 'gru'):
        if not hasattr(K, '%s_seq_fwd' % kind):
            print('no %s sequence kernels in this checkout' % kind.upper())
            continue
        for direction in ('fwd', 'bwd'):
            row = smoke._rnn_seq_case(torch, card, kind, direction,
                                      torch.bfloat16, 'bench', timed=True)
            for key in ('ms', 'floor_ms', 'plain_ms', 'positions_ms',
                        'library_ms'):
                ms['%s_seq_%s %s' % (kind, direction, key)] = row[key]
    builds = smoke.seq_model_builds(pt, 100)
    for model in smoke.seq_model_recurrences():
        feed = smoke.seq_model_feed(model, 64, 100)
        launches, ms[model], one = smoke._seq_model_timed(
            torch, pt, pt.CUDAPlace(0), True, builds[model], feed, steps)
        print('%s: batch 64 x seq 100, fp32, %d steps after 2 warm-up: '
              '%.4f ms a step (%s), recurrence launches %s [%s]'
              % (model, steps, ms[model], 'one graph' if one else
                 'NOT one graph', {k: v for k, v in launches.items()
                                   if 'lstm' in k or 'gru' in k}, card))
        torch.cuda.empty_cache()
    return ms


def moe_steps(torch, smoke, card, steps=20):
    """--moe: DIR's phase-18a bench_moe steps; returns {label: ms}."""
    import paddle_tpu_torch as pt
    ms, jobs = {}, []
    for scan in (True, False):
        _, row, job = smoke._moe_timed(
            torch, pt, pt.CUDAPlace(0), card, True, 32, 64, smoke.VOCAB,
            smoke.MOE_DIMS, scan, 3, steps)
        ms['moe %s step' % ('scan_layers' if scan else 'unrolled')] = \
            row['ms']
        jobs.append(job)
    smoke.profile_steps(torch, card, jobs)
    return ms


def seq2seq_steps(torch, smoke, card, steps=5):
    """--seq2seq: DIR's phase-20 rnn_search step, its two decoders and
    the SSD step and detection; returns {label: wall ms a call}."""
    import paddle_tpu_torch as pt
    try:
        from paddle_tpu_torch.models import rnn_search, ssd  # noqa: F401
    except ImportError:
        print('no rnn_search or ssd model in this checkout')
        return {}
    dev = torch.device('cuda', 0)
    exe = pt.Executor(pt.CUDAPlace(0))
    jobs = []

    def job(label, program, scope, feed, fetch):
        def step():
            with pt.scope_guard(scope):
                exe.run(program, feed=feed, fetch_list=fetch,
                        return_numpy=False)
        jobs.append((label, step, steps, None))

    dims = smoke.RNN_SEARCH_WIDTH
    avg = smoke._build_rnn_search(pt, dims)
    main, scope = pt.default_main_program(), pt.Scope()
    with pt.scope_guard(scope):
        exe.run(pt.default_startup_program())
    feed = {n: torch.as_tensor(v).to(dev) for n, v in
            smoke.rnn_search_feed(64, 50, dims['src_vocab']).items()}
    job('rnn_search training step, 64 x 50, fp32', main, scope, feed,
        [avg])
    src = {n: feed[n] for n in ('src_word', 'src_len')}
    for label, program, fetch in smoke.rnn_search_decoders(pt, dims, 50, 4):
        job('rnn_search %s decode, 64 x 50' % label, program, scope, src,
            fetch)
    avg = smoke._build_ssd(pt, 21, 128, 8)
    main, sscope = pt.default_main_program(), pt.Scope()
    with pt.scope_guard(sscope):
        exe.run(pt.default_startup_program())
    feed = {n: torch.as_tensor(v).to(dev) for n, v in
            smoke.ssd_feed(32, 128, 8, 21).items()}
    job('ssd training step, 32 x 3 x 128 x 128, fp32', main, sscope, feed,
        [avg])
    program, name = smoke._ssd_infer_program(pt, 21, 128)
    job('ssd_infer detection_output, 32 x 3 x 128 x 128', program, sscope,
        {'image': feed['image']}, [name])
    ms = {}
    for label, step, _, _ in jobs:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            step()
        torch.cuda.synchronize()
        ms[label] = (time.perf_counter() - t0) * 1e3 / 20
        print('%s: %.3f ms a call, 20 captured calls after 3 [%s]'
              % (label, ms[label], card))
    smoke.profile_steps(torch, card, jobs)
    return ms


def pool_steps(torch, smoke, card, steps=20):
    """--pool: DIR's max pool at pool_shapes and its CNN steps; returns
    {label: ms}."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.conv_ops import pool2d
    F = torch.nn.functional
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device='cuda').manual_seed(23)
    ms = {}
    # past pool_shapes: ResNet-50's stem pool at 640² images in fp32 NHWC,
    # whose rows of 64 channels are too wide to stage whole
    wide = ('ResNet-50 stem at 640² [16, 64, 320, 320] fp32 NHWC 3x3/2 '
            'pad 1', (16, 64, 320, 320), torch.float32, True, 3, 2, 1,
            False)
    for case in smoke.pool_shapes(torch) + [wide]:
        label, _, dtype, _, k, s, p, ceil = case
        x, geo = smoke.pool_case_inputs(torch, case, gen)
        x = x.detach().requires_grad_()
        dy = torch.randn(pool2d(x, 'max', [k, k], [s, s], [p, p], False,
                                ceil_mode=ceil).shape, generator=gen,
                         device=dev).to(dtype)

        def fwd(x=x, k=k, s=s, p=p, ceil=ceil):
            pool2d(x, 'max', [k, k], [s, s], [p, p], False, ceil_mode=ceil)

        def pair(x=x, k=k, s=s, p=p, ceil=ceil, dy=dy):
            torch.autograd.grad(pool2d(x, 'max', [k, k], [s, s], [p, p],
                                       False, ceil_mode=ceil), x, dy)
        ms[label + ' forward'] = smoke.device_ms(torch, fwd)
        ms[label + ' forward + backward'] = smoke.device_ms(torch, pair)
        note = 'torch n/a (padding past torch\'s)'
        args = smoke.torch_pool_args(geo, tuple(x.shape[2:]))
        if args is not None:
            def torch_pair(x=x, k=k, s=s, args=args, dy=dy):
                torch.autograd.grad(F.max_pool2d(x, k, s, args[0],
                                                 ceil_mode=args[1]), x, dy)
            ms[label + ' torch forward + backward'] = smoke.device_ms(
                torch, torch_pair)
            note = 'torch\'s F.max_pool2d forward + backward %.5f' % (
                ms[label + ' torch forward + backward'])
        print('max pool %s: forward %.5f ms, forward + backward %.5f ms '
              '(graph replay); %s [%s]'
              % (label, ms[label + ' forward'],
                 ms[label + ' forward + backward'], note, card))
        del x, dy
        torch.cuda.empty_cache()
    for label, builder, batch in (('ResNet-50', 'resnet', 64),
                                  ('VGG-16', 'vgg16', 64),
                                  ('GoogLeNet', 'googlenet', 64),
                                  ('AlexNet', 'alexnet', 64)):
        if builder == 'resnet':
            from paddle_tpu_torch.models import resnet as R
            avg = smoke._build_resnet(pt, 224, 1000, 'NHWC', 'bf16', 0.1)
            feed = R.make_fake_batch(batch, 224, 1000, seed=0)
        else:
            avg = smoke._conv_program(pt, builder, 224, 3, 1000, 'bf16',
                                      0.01)
            feed = smoke.conv_feed(builder, batch, 224, 3, 1000)
        exe = pt.Executor(pt.CUDAPlace(0))
        scope = pt.Scope()
        with pt.scope_guard(scope):
            exe.run(pt.default_startup_program())
            feed = {n: torch.as_tensor(v).to(dev) for n, v in feed.items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            smoke._train_steps(torch, exe, feed, avg, 3, True)
            secs, losses = smoke._train_steps(torch, exe, feed, avg, steps,
                                              True)
            peak = torch.cuda.max_memory_allocated() - before
        ms[label + ' step'] = secs * 1e3 / steps
        ms[label + ' peak GB'] = peak / 1e9
        print('%s: batch %d x 224 x 224, bf16, %d captured steps after 3: '
              '%.3f ms/step, peak memory %.4f GB above what was allocated '
              'before the first step; loss first %.5f last %.5f [%s]'
              % (label, batch, steps, ms[label + ' step'], peak / 1e9,
                 losses[0], losses[-1], card))
        del exe, scope, feed
        torch.cuda.empty_cache()
    return ms


def cell_steps(torch, smoke, card):
    """--cells: DIR's LSTM and GRU cell kernels at the widths where the
    cells run; returns {label: ms}."""
    import numpy as np
    gen = torch.Generator(device='cuda').manual_seed(19)
    ms = {}
    for what, kind, b, t, d, dtype in (
            ('bench_rnn_lstm', 'lstm', 128, 100, 512, torch.bfloat16),
            ('rnn_search encoder', 'gru', 64, 50, 512, torch.float32),
            ('rnn_search encoder', 'gru', 64, 50, 512, torch.bfloat16),
            ('stacked_gru_tagger', 'gru', 64, 100, 512, torch.float32)):
        for direction in ('fwd', 'bwd'):
            row = smoke._rnn_cell_case(
                torch, card, kind, direction, dtype, b, t, d, np.full(b, t),
                smoke.ACTS_OF[kind], gen, timed=True)
            key = '%s %s_cell_%s [%d, %d] %s' % (what, kind, direction, b, d,
                                                 str(dtype)[6:])
            for name in ('ms', 'plain_ms', 'bound_ms', 'library_ms'):
                ms['%s %s' % (key, name)] = row[name]
            print('%s: kernel %.5f ms a step, plain %.5f, bound %.6f (%s), '
                  'library %s [%s]'
                  % (key, row['ms'], row['plain_ms'], row['bound_ms'],
                     row['bound_by'], '%.5f' % row['library_ms']
                     if row['library_ms'] is not None else 'none', card))
        torch.cuda.empty_cache()
    return ms


def gru_steps(torch, smoke, card, steps=20):
    """--gru: DIR's GRU recurrence, stacked_gru_tagger and rnn_search at
    hidden 512; returns {label: ms}."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.kernels import rnn_cell as K
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev).manual_seed(23)
    b, t, d = 64, 100, 512
    ms = {}

    def gru_launches(before):
        now = smoke.read_launches()
        return {k: now[k] - before[k] for k in now
                if k.startswith('gru_') and now[k] != before[k]}
    for dt in (torch.float32, torch.bfloat16):
        x = (0.5 * torch.randn(b, t, 3 * d, generator=gen, device=dev)).to(dt)
        w = (0.1 * torch.randn(d, 3 * d, generator=gen, device=dev)).to(dt)
        leaves = [a.requires_grad_() for a in
                  (x, w, torch.zeros(3 * d, device=dev, dtype=dt))]
        h0 = torch.zeros(b, d, device=dev, dtype=dt)
        dy = torch.randn(b, t, d, generator=gen, device=dev).to(dt)

        def recurrence(leaves=leaves, h0=h0, dy=dy):
            h = K.GruRecurrence.apply(*leaves, h0, None, (0, 1), False)
            torch.autograd.grad(h, leaves, dy)
        before = smoke.read_launches()
        recurrence()
        torch.cuda.synchronize()
        moved = gru_launches(before)
        label = 'GruRecurrence fwd + bwd [%d, %d, %d] %s' % (b, t, d,
                                                          str(dt)[6:])
        ms[label] = smoke.device_ms(torch, recurrence, iters=5)
        print('%s: %.4f ms by graph replay, launches a call %s [%s]'
              % (label, ms[label], moved, card))
        del x, w, leaves, h0, dy
        torch.cuda.empty_cache()
    build = smoke.seq_model_builds(pt, t, gru_hidden=d)['stacked_gru_tagger']
    feed = smoke.seq_model_feed('stacked_gru_tagger', b, t)
    launches, step_ms, one_graph = smoke._seq_model_timed(
        torch, pt, pt.CUDAPlace(0), True, build, feed, steps)
    label = 'stacked_gru_tagger hidden %d, %d x %d fp32 step' % (d, b, t)
    ms[label] = step_ms
    print('%s: %.3f ms a step, %d captured after 2 (%s), GRU launches %s '
          '[%s]' % (label, step_ms, steps, 'one graph' if one_graph else
                    'NOT one graph', {k: v for k, v in launches.items()
                                      if k.startswith('gru_') and v}, card))
    torch.cuda.empty_cache()
    dims = smoke.RNN_SEARCH_WIDTH
    for amp in (None, 'bf16'):
        avg = smoke._build_rnn_search(pt, dims, amp)
        exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope()
        with pt.scope_guard(scope):
            exe.run(pt.default_startup_program())
            feed = {n: torch.as_tensor(v).to(dev) for n, v in
                    smoke.rnn_search_feed(64, 50, dims['src_vocab']).items()}
            smoke._train_steps(torch, exe, feed, avg, 3, True)
            before = smoke.read_launches()
            secs, _ = smoke._train_steps(torch, exe, feed, avg, steps, True)
            moved = gru_launches(before)
        label = 'rnn_search 512 / 512 / 30,000, 64 x 50 %s step' % (
            amp or 'fp32')
        ms[label] = secs * 1e3 / steps
        print('%s: %.3f ms a step, %d captured after 3 (%s), GRU launches '
              '%s [%s]' % (label, ms[label], steps, 'one graph' if
                           exe.last_captured and exe.captures == 1 else
                           'NOT one graph', moved, card))
        del exe, scope, feed
        torch.cuda.empty_cache()
    return ms


def main():
    args = [a for a in sys.argv[1:]
            if a not in ('--decode', '--train', '--write', '--serve',
                         '--encoder', '--rnn', '--moe', '--seq2seq',
                         '--pool', '--cells', '--gru')]
    port = os.path.abspath(args[0]) if args else REPO
    sys.path.insert(0, REPO)
    import chip_smoke as smoke
    sys.path.insert(0, port)
    import torch
    if not torch.cuda.is_available():
        smoke.fail('torch.cuda.is_available() is false: kernel_times.py '
                   'needs a CUDA card')
    from paddle_tpu_torch.ops.kernels import batch_norm as bn
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import layer_norm as ln
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    smoke.require(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(pa.__file__))))) == port,
        'paddle_tpu_torch was not imported from %s' % port)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0].strip()
    if '--decode' in sys.argv:
        decode_step(torch, smoke, card)
        print(card)
        return
    for flag, run in (('--train', train_steps), ('--write', write_layers),
                      ('--serve', serve), ('--encoder', encoder_steps),
                      ('--rnn', rnn_steps), ('--moe', moe_steps),
                      ('--seq2seq', seq2seq_steps), ('--pool', pool_steps),
                      ('--cells', cell_steps), ('--gru', gru_steps)):
        if flag in sys.argv:
            ms = run(torch, smoke, card)
            print(card)
            print(json.dumps({'port': port, 'card': card, 'ms': ms}))
            return
    dev = torch.device('cuda', 0)
    ms = {}

    gen = torch.Generator(device='cuda').manual_seed(0)
    for n, d in smoke.ln_shapes(torch):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(n, d, generator=gen, device=dev).to(dtype)
            g = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
            b = 0.1 * torch.randn(d, generator=gen, device=dev)
            gy = torch.randn(n, d, generator=gen, device=dev).to(dtype)
            label = 'layer_norm [%d, %d] %s' % (n, d, str(dtype)[6:])
            ms[label] = smoke.device_ms(
                torch, lambda: ln.fused_layer_norm(x, g, b, eps=1e-5))
            key = label + ' backward'
            if hasattr(ln, '_ln_bwd_cuda'):
                ms[key] = smoke.device_ms(
                    torch, lambda: ln._ln_bwd_cuda(x, g, gy, 1e-5))
                note = 'backward kernels %.5f ms' % ms[key]
            else:
                note = 'no backward kernel in this checkout'
            print('%s: kernel %.5f ms, %s [%s]' % (label, ms[label], note,
                                                   card))
    gen = torch.Generator(device='cuda').manual_seed(0)
    for _, label, dtype, n, lens, broadcast, empty in smoke.paged_shapes(
            torch):
        args = smoke._paged_inputs(torch, gen, n, lens, dtype, broadcast,
                                   empty=empty)
        ms[label] = smoke.device_ms(
            torch, lambda: pa.paged_attention(*args))
        print('%s: kernel %.5f ms [%s]' % (label, ms[label], card))
        del args
        torch.cuda.empty_cache()
    engine_lens = smoke.paged_shapes(torch)[-1][4]
    args = smoke._paged_inputs(torch, gen, 16, engine_lens, torch.float32,
                               False, verify=4)
    label = 'paged_attention verify N=64 float32'
    ms[label] = smoke.device_ms(torch, lambda: pa.paged_attention(*args))
    print('%s: kernel %.5f ms [%s]' % (label, ms[label], card))
    del args
    if hasattr(pa.paged_attention, 'launches_q8'):
        for kv_dtype in ('int8', 'float8_e4m3fn'):
            for _, what, n, lens, d, verify in smoke.paged_q8_shapes():
                q, kq, vq, t, sl, ks, vs = smoke._paged_inputs(
                    torch, gen, n, lens, kv_dtype, False, d=d, verify=verify)
                label = 'paged_attention %s %s' % (kv_dtype, what)
                ms[label] = smoke.device_ms(
                    torch, lambda: pa.paged_attention(
                        q, kq, vq, t, sl, k_scales=ks, v_scales=vs))
                print('%s: kernel %.5f ms [%s]' % (label, ms[label], card))
                del q, kq, vq, t, sl, ks, vs
                torch.cuda.empty_cache()
    else:
        print('paged_attention: no quantized variant in this checkout')

    gen = torch.Generator(device='cuda').manual_seed(1)
    for label, b, h, t, d, dtype, causal, lens in smoke.flash_shapes(torch):
        q, k, v, do = (torch.randn(b, h, t, d, generator=gen, device=dev)
                       .to(dtype) for _ in range(4))
        kv = None if lens is None else torch.tensor(lens, device=dev)
        ms[label] = smoke.device_ms(
            torch, lambda: fa.flash_attention_fwd(q, k, v, kv, causal),
            iters=50)
        out, lse = fa.flash_attention_fwd(q, k, v, kv, causal)
        key = label + ' backward'
        ms[key] = smoke.device_ms(
            torch, lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, kv,
                                                  causal), iters=50)
        mask = smoke.sdpa_mask(torch, t, kv, causal)
        sdpa, backend, _ = smoke.sdpa_bwd_ms(torch, q, k, v, do, mask,
                                             causal and mask is None)
        ms[key + ' SDPA'] = sdpa
        print('%s: forward kernel %.5f ms, backward kernels %.5f ms, SDPA '
              'backward (%s) %.5f ms [%s]'
              % (label, ms[label], ms[key], backend, sdpa, card))
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()

    gen = torch.Generator(device='cuda').manual_seed(3)
    for label, shape, dtype, layout, _ in smoke.bn_shapes(torch):
        x = (1.0 + 2.0 * torch.randn(shape, generator=gen, device=dev)) \
            .to(dtype)
        c = x.shape[1] if layout == 'NCHW' else x.shape[-1]
        g = 0.5 + torch.rand(c, generator=gen, device=dev)
        b = torch.randn(c, generator=gen, device=dev)
        ms[label] = smoke.device_ms(
            torch, lambda: bn.fused_batch_norm_train(x, g, b, 1e-5,
                                                     layout=layout),
            iters=20)
        note = 'no backward kernel in this checkout'
        if hasattr(bn, '_bn_bwd_cuda'):
            x4 = x.permute(0, 3, 1, 2) if layout == 'NHWC' else x
            x3 = x4.reshape(x4.shape[0], c, -1) if x.dim() == 4 \
                else x.unsqueeze(-1)
            _, m, v = bn._bn_cuda(x3, g, b, 1e-5)
            gy = torch.randn(x.shape, generator=gen, device=dev).to(dtype)
            g4 = gy.permute(0, 3, 1, 2) if layout == 'NHWC' else gy
            g3 = g4.reshape(x3.shape) if x.dim() == 4 else gy.unsqueeze(-1)
            key = label + ' backward'
            ms[key] = smoke.device_ms(
                torch, lambda: bn._bn_bwd_cuda(x3, g3, g, m, v, 1e-5),
                iters=20)
            note = 'backward kernel %.5f ms' % ms[key]
            del x3, x4, gy, g3, g4
        print('%s: kernel %.5f ms, %s [%s]' % (label, ms[label], note, card))
        del x
        torch.cuda.empty_cache()

    print(card)
    print(json.dumps({'port': port, 'card': card, 'ms': ms}))


if __name__ == '__main__':
    main()
