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

Nothing is checked here: chip_smoke.py holds each kernel against its plain
versions. Prints one line a case, then nvidia-smi's name and power limit,
then one JSON object {"port": DIR, "card": ..., "ms": {case: ms}}.
"""

import json
import os
import subprocess
import sys

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


def main():
    args = [a for a in sys.argv[1:]
            if a not in ('--decode', '--train', '--write', '--serve',
                         '--encoder')]
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
                      ('--serve', serve), ('--encoder', encoder_steps)):
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
