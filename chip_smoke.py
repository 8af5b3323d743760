#!/usr/bin/env python3
"""Chip smoke for paddle_tpu_torch: decode serving on one CUDA card.

    python3 chip_smoke.py                  # on a machine with one H100
    python3 chip_smoke.py --cpu-rehearsal  # phases 4-5 on the host, tiny LM

Phases (any fault exits non-zero; no phase is skipped over):

1. Device: name, count, nvidia-smi's name and power limit, TF32 flags
   (both set off: fp32 matmuls run in full fp32).
2. Build: both CUDA kernels from paddle_tpu_torch/csrc with one nvcc call;
   build time and ptxas's registers / shared memory per kernel.
3. Kernel vs plain version on the card at the main path's shapes, fp32
   and bf16, with the stated tolerance; device times of the kernel, the
   plain version and a library yardstick (CUDA-graph replay, CUDA
   events) beside each kernel's bound, and the kernel's eager time.
4. Engine: DecodeEngine at the documented serving configuration
   (docs/serving.md: vocab 32000, 12 layers, 8 heads, d_model 512,
   d_inner 2048; max_batch 16, block 32, 4096 pages, 64 pages a
   sequence; fp32 arena; random_weights(seed 0)). warmup(), start(), 32
   requests from 16 submitter threads (prompts 64-512 tokens, 64 new
   tokens, 28 greedy and 4 at temperature 0.7). Checks every stream
   completes, 4 greedy streams re-run alone equal their concurrent
   runs, pages return after drain, and the kernels' launch counters
   grew by 2*L (layer norm) and L (paged attention) per prefill and
   decode step of the run.
5. Card vs CPU: the same port on CPUPlace() (plain versions), 2 prompts x
   16 greedy tokens, must give the card's token streams.

The last line is {"ok": true, "device": {...}}; before it come one JSON
line with every kernel's numbers and nvidia-smi's name and power limit.
--cpu-rehearsal runs phases 4-5 at the tests' tiny LM with the plain
versions and never prints that last line.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def fail(msg):
    print('chip_smoke: FAIL: %s' % msg, file=sys.stderr)
    sys.exit(1)


def require(cond, msg):
    if not cond:
        fail(msg)


def bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits), elementwise, float64."""
    a = np.maximum(np.abs(np.asarray(x, dtype=np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _events_ms(torch, run, iters):
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    run()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def eager_ms(torch, fn, iters=100, warmup=10):
    """ms per call over ``iters`` back-to-back eager calls (CUDA events,
    after ``warmup`` calls). Small calls are bound by the host issuing
    them: the wrapper's Python, ctypes and the launch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
    return _events_ms(torch, run, iters)


def device_ms(torch, fn, iters=100):
    """Device ms per call: ``iters`` calls captured in one CUDA graph and
    replayed (after one warm replay), timed with CUDA events, so the
    host's cost of issuing each call is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _events_ms(torch, graph.replay, iters)
    del graph
    return ms


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


# ------------------------------------------------------------ phase 1
def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, 'nvidia-smi failed: %s' % smi.stderr)
    card = smi.stdout.strip().splitlines()[0].strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print('device: %s, count %d, torch %s, cuda %s'
          % (name, count, torch.__version__, torch.version.cuda))
    print('nvidia-smi: %s' % card)
    print('tf32: torch.backends.cuda.matmul.allow_tf32=%s '
          'torch.backends.cudnn.allow_tf32=%s'
          % (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32))
    return name, count, card


# ------------------------------------------------------------ phase 2
def phase_build():
    from paddle_tpu_torch.ops.kernels import build
    res = build.build()
    print('build: %.2f s (nvcc, one call, %s) -> %s'
          % (res.seconds, ' '.join(build.SOURCES),
             os.path.relpath(res.path, REPO)))
    for line in res.log.splitlines():
        if 'ptxas info' in line and ('Compiling' in line or 'Used' in line):
            print('  ' + line.strip())
    print('  paged_attention dynamic shared memory at bs=32, D=Dv=64: %d B'
          % build.library().ptt_paged_attention_smem_bytes(32, 64, 64))
    return res


# ------------------------------------------------------------ phase 3
def _ln_case(torch, card, n, d, dtype, gen):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import layer_norm as K
    dev = torch.device('cuda', 0)
    x = torch.randn(n, d, generator=gen, device=dev).to(dtype)
    g = (1.0 + 0.1 * torch.randn(d, generator=gen, device=dev))
    b = 0.1 * torch.randn(d, generator=gen, device=dev)
    y = K.fused_layer_norm(x, g, b, eps=1e-5)
    ref = K._ln_reference(x, g, b, 1e-5)
    torch.cuda.synchronize()
    yf, rf = y.float().cpu().numpy(), ref.float().cpu().numpy()
    err = float(np.max(np.abs(yf - rf)))
    if dtype == torch.float32:
        tol = 'fp32: |kernel - plain| <= 1e-5 + 1e-5*|plain|'
        ok = np.all(np.abs(yf - rf) <= 1e-5 + 1e-5 * np.abs(rf))
    else:
        tol = 'bf16: |kernel - plain| <= 1 bf16 ulp'
        ok = np.all(np.abs(yf - rf) <=
                    bf16_ulp(np.maximum(np.abs(yf), np.abs(rf))))
    item = x.element_size()
    n_bytes = 2 * n * d * item + 2 * d * 4
    lo, by = bound_ms(n_bytes, 8 * n * d)
    gl, bl = g.to(dtype), b.to(dtype)
    ms = device_ms(torch, lambda: K.fused_layer_norm(x, g, b, eps=1e-5))
    eager = eager_ms(torch, lambda: K.fused_layer_norm(x, g, b, eps=1e-5))
    plain = device_ms(torch, lambda: K._ln_reference(x, g, b, 1e-5))
    lib = device_ms(torch, lambda: F.layer_norm(x, (d,), gl, bl, 1e-5))
    label = 'layer_norm [%d, %d] %s' % (n, d, str(dtype)[6:])
    print('%s: max_abs_err %.3g (%s) %s; device ms: kernel %.5f, plain '
          '%.5f, F.layer_norm %.5f, bound %.6f (%s); kernel eager %.5f ms '
          '[%s]' % (label, err, tol, 'ok' if ok else 'MISMATCH', ms, plain,
                    lib, lo, by, eager, card))
    require(ok, '%s disagrees with its plain version' % label)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=lo,
                bound_by=by, library_ms=lib, eager_ms=eager)


def _paged_inputs(torch, gen, n, lens, dtype, broadcast, h=8, d=64, bs=32,
                  p=64, nb=4096, empty=()):
    dev = torch.device('cuda', 0)
    kp = torch.randn(nb, h, bs, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(nb, h, bs, d, generator=gen, device=dev).to(dtype)
    q = torch.randn(n, h, d, generator=gen, device=dev)
    perm = torch.randperm(nb, generator=gen, device=dev).to(torch.int32)
    if broadcast:
        row = perm[:p].clone()
        owned = -(-max(lens) // bs)
        row[owned:] = nb          # "no page" past the owned pages
        tables = row.expand(n, p)
    else:
        tables = perm[:n * p].reshape(n, p).clone()
        for i, ln in enumerate(lens):
            tables[i, -(-ln // bs):] = nb + 7
        for i in empty:
            tables[i] = nb        # empty decode slot: all entries >= NB
    seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kp, vp, tables, seq_lens


def _paged_case(torch, card, label, q, kp, vp, tables, lens):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import paged_attention as K
    out = K.paged_attention(q, kp, vp, tables, lens)
    ref = K.paged_attention_reference(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    of, rf = out.float().cpu().numpy(), ref.float().cpu().numpy()
    err = float(np.max(np.abs(of - rf)))
    if kp.dtype == torch.float32:
        tol = 'fp32: |kernel - plain| <= 5e-5'
        ok = err <= 5e-5
    else:
        tol = ('bf16: |kernel - plain| <= 2e-2 + 2e-2*|plain| (plain '
               'output rounded to bf16, 2^-7 at the top of a binade, and '
               'p rounded to bf16 at different points)')
        ok = np.all(np.abs(of - rf) <= 2e-2 + 2e-2 * np.abs(rf))
    nb, h, bs, d = kp.shape
    n, p = tables.shape
    lens_h = lens.cpu().numpy().astype(np.int64)
    tab_h = tables.cpu().numpy()
    npages = np.minimum(-(-lens_h // bs), p)
    pages = set()
    for i in range(n):
        pages.update(np.clip(tab_h[i, :npages[i]], 0, nb - 1).tolist())
    item = kp.element_size()
    n_bytes = (len(pages) * h * bs * 2 * d * item + 2 * n * h * d * 4 +
               int(npages.sum()) * 4 + n * 4)
    n_ops = int(lens_h.sum()) * h * (4 * d + 5)
    lo, by = bound_ms(n_bytes, n_ops)
    ms = device_ms(torch, lambda: K.paged_attention(q, kp, vp, tables,
                                                    lens))
    eager = eager_ms(torch, lambda: K.paged_attention(q, kp, vp, tables,
                                                      lens))
    plain = device_ms(torch, lambda: K.paged_attention_reference(
        q, kp, vp, tables, lens), iters=20)
    # yardstick: SDPA over K/V already gathered (the gather is not timed)
    idx = tables.long().clamp(0, nb - 1)
    kg = kp[idx].permute(0, 2, 1, 3, 4).reshape(n, h, p * bs, d)
    vg = vp[idx].permute(0, 2, 1, 3, 4).reshape(n, h, p * bs, d)
    mask = (torch.arange(p * bs, device=q.device)[None, :] <
            lens[:, None])[:, None, None, :]
    qd = q[:, :, None, :].to(kp.dtype)
    lib = device_ms(torch, lambda: F.scaled_dot_product_attention(
        qd, kg, vg, attn_mask=mask), iters=20)
    del kg, vg
    print('%s: max_abs_err %.3g (%s) %s; device ms: kernel %.5f, plain '
          '%.5f, SDPA(gathered) %.5f, bound %.6f (%s); kernel eager %.5f ms '
          '[%s]' % (label, err, tol, 'ok' if ok else 'MISMATCH', ms, plain,
                    lib, lo, by, eager, card))
    require(ok, '%s disagrees with its plain version' % label)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=lo,
                bound_by=by, library_ms=lib, eager_ms=eager)


def phase_kernels(torch, card):
    gen = torch.Generator(device='cuda').manual_seed(0)
    ln = {}
    for n, d in ((16, 512), (512, 512), (64, 2048)):
        for dtype in (torch.float32, torch.bfloat16):
            ln[(n, d, dtype)] = _ln_case(torch, card, n, d, dtype, gen)
    decode_lens = [1, 2, 31, 32, 33, 64, 65, 200, 576, 1000, 1500, 2047,
                   2048, 1, 1, 1]
    pa = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = _paged_inputs(torch, gen, 16, decode_lens, dtype, False,
                             empty=(13, 14, 15))
        pa[('decode', dtype)] = _paged_case(
            torch, card, 'paged_attention decode N=16 H=8 D=64 bs=32 P=64 '
            'NB=4096 lens 1..2048 + 3 empty rows %s' % str(dtype)[6:],
            *args)
        del args
        args = _paged_inputs(torch, gen, 128, list(range(1, 129)), dtype,
                             True)
        pa[('prefill', dtype)] = _paged_case(
            torch, card, 'paged_attention prefill N=128 broadcast table '
            'lens 1..128 %s' % str(dtype)[6:], *args)
        del args
        torch.cuda.empty_cache()
    # the engine run's own decode shape: 16 live rows, lengths across the
    # range its requests reach (prompts 64-512 plus up to 64 new tokens)
    engine_lens = np.linspace(64, 576, 16).astype(int).tolist()
    args = _paged_inputs(torch, gen, 16, engine_lens, torch.float32, False)
    pa['engine'] = _paged_case(
        torch, card, 'paged_attention decode N=16 lens 64..576 (the engine '
        'run\'s range) float32', *args)
    del args
    return ln[(16, 512, torch.float32)], pa['engine']


# ------------------------------------------------------------ phase 4
def _requests(spec, n, plen_lo, plen_hi, max_new, seed=1234):
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.randint(plen_lo, plen_hi + 1))
        sampled = i % 8 == 7            # 4 of 32 at temperature 0.7
        reqs.append(dict(prompt_ids=rng.randint(0, spec.vocab_size,
                                                plen).tolist(),
                         max_new_tokens=max_new,
                         temperature=0.7 if sampled else 0.0,
                         seed=1000 + i))
    return reqs


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if xs else float('nan')


def _profile_decode(torch, eng, spec, card, steps=20):
    """--profile: decode steps with every batch slot busy (lengths from
    300), run on this thread through the engine's decode program once the
    engine is shut down. Prints the wall time per step without the
    profiler, then, under torch.profiler, device busy time and share,
    device time by kernel and host time by op, per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    mb, pps, bs = eng.max_batch, eng.pages_per_seq, eng.block_size
    rng = np.random.RandomState(7)
    need = -(-(300 + 2 * steps + 8) // bs)
    tables = np.full((mb, pps), eng.num_blocks, 'int32')
    for i in range(mb):
        tables[i, :need] = eng.pool.alloc(need)
    state = {'tokens': rng.randint(0, spec.vocab_size, mb).astype('int64'),
             'lens': np.full((mb,), 300, 'int32')}
    zf, zi = np.zeros((mb,), 'float32'), np.zeros((mb,), 'int32')

    def step():
        nxt = eng._run_decode(state['tokens'], state['lens'], tables, zf, zi)
        state['tokens'] = nxt.astype('int64')
        state['lens'] = state['lens'] + 1

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kernels, host = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            c, t = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (c + 1, t + e.time_range.end -
                               e.time_range.start)
    for a in prof.key_averages():
        if a.device_type == DeviceType.CPU and a.self_cpu_time_total > 0:
            host[a.key] = (a.count, a.self_cpu_time_total)
    busy_ms = sum(t for _, t in kernels.values()) / steps / 1e3
    print('profile: %d decode steps x %d rows (lengths 300..%d): wall '
          '%.3f ms/step (no profiler), device busy %.3f ms/step, busy '
          'share %.3f [%s]' % (steps, mb, 300 + 2 * steps + 3, wall_ms,
                               busy_ms, busy_ms / wall_ms, card))
    for name, (c, t) in sorted(kernels.items(),
                               key=lambda kv: -kv[1][1])[:10]:
        print('  device %9.1f us/step %6.1f launches/step  %s'
              % (t / steps, c / steps, name[:90]))
    for name, (c, t) in sorted(host.items(), key=lambda kv: -kv[1][1])[:12]:
        print('  host   %9.1f us/step %6.1f calls/step     %s'
              % (t / steps, c / steps, name[:90]))
    for i in range(mb):
        eng.pool.free(tables[i, :need].tolist())


def phase_engine(torch, spec, engine_kw, reqs, place, card, on_card,
                 profile=False):
    from paddle_tpu_torch.ops.kernels.layer_norm import fused_layer_norm
    from paddle_tpu_torch.ops.kernels.paged_attention import paged_attention
    from paddle_tpu_torch.serving.decode import DecodeEngine, random_weights
    t0 = time.perf_counter()
    weights = random_weights(spec, seed=0)
    eng = DecodeEngine(spec, place=place, weights=weights, **engine_kw)
    t1 = time.perf_counter()
    n_shapes = eng.warmup()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t2 = time.perf_counter()
    print('engine: built + weights %.2f s, warmup %.2f s (%d shapes), '
          'kv %d B/token, %d pages x %d, place %r'
          % (t1 - t0, t2 - t1, n_shapes, eng.kv_bytes_per_token,
             eng.num_blocks, eng.block_size, eng.place))
    eng.start()

    n_threads = 16
    results = [None] * len(reqs)
    reasons = [None] * len(reqs)
    ttft, gaps, errors = [], [], []
    mu = threading.Lock()

    def client(k):
        try:
            for i in range(k, len(reqs), n_threads):
                t_sub = time.perf_counter()
                stream = eng.submit(**reqs[i])
                toks, last = [], None
                for tok in stream:
                    now = time.perf_counter()
                    with mu:
                        if last is None:
                            ttft.append(now - t_sub)
                        else:
                            gaps.append(now - last)
                    last = now
                    toks.append(tok)
                results[i] = stream.result(timeout=60)
                reasons[i] = stream.finish_reason
                if toks != results[i]:
                    raise AssertionError('request %d: streamed tokens '
                                         'differ from its result' % i)
        except Exception as e:  # reported and failed below
            with mu:
                errors.append(repr(e))

    # the main path's run: every launch counter starts at 0 here
    fused_layer_norm.launches = 0
    paged_attention.launches = 0
    pre0, dec0 = eng.prefills, eng.decode_steps
    t_run = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    require(not any(t.is_alive() for t in threads),
            'submitter threads still running after 600 s')
    require(eng.drain(60), 'engine did not drain')
    wall = time.perf_counter() - t_run
    launches = {'layer_norm': fused_layer_norm.launches,
                'paged_attention': paged_attention.launches}
    runs = (eng.prefills - pre0) + (eng.decode_steps - dec0)
    require(not errors, 'client errors: %s' % errors[:3])
    require(all(r is not None and len(r) == q['max_new_tokens']
                for r, q in zip(results, reqs)),
            'a stream did not complete with max_new_tokens tokens')
    require(all(r == 'max_tokens' for r in reasons),
            'finish reasons %s' % sorted(set(map(str, reasons))))
    require(eng.free_pages() == eng.num_blocks,
            'pages not reclaimed after drain: %d of %d free'
            % (eng.free_pages(), eng.num_blocks))
    n_tok = sum(len(r) for r in results)
    layers = spec.n_layer
    print('engine run: %d requests, %d tokens in %.3f s: %.1f tokens/s; '
          'TTFT p50 %.1f ms; inter-token p50 %.2f ms p99 %.2f ms; '
          '%d prefills + %d decode steps; %d preemptions [%s]'
          % (len(reqs), n_tok, wall, n_tok / wall, 1e3 * _pct(ttft, 50),
             1e3 * _pct(gaps, 50), 1e3 * _pct(gaps, 99),
             eng.prefills - pre0, eng.decode_steps - dec0,
             eng.preemptions, card))
    print('launches in the run: layer_norm %d (= 2*%d*%d runs: %s), '
          'paged_attention %d (= %d*%d runs: %s)'
          % (launches['layer_norm'], layers, runs,
             launches['layer_norm'] == 2 * layers * runs,
             launches['paged_attention'], layers, runs,
             launches['paged_attention'] == layers * runs))
    if on_card:
        print('max_memory_allocated: %.3f GB [%s]'
              % (torch.cuda.max_memory_allocated() / 1e9, card))
        require(launches['layer_norm'] > 0 and
                launches['paged_attention'] > 0,
                'a kernel of the path was never launched: %s' % launches)
        require(launches['layer_norm'] == 2 * layers * runs and
                launches['paged_attention'] == layers * runs,
                'launch counts %s do not match %d prefills + decode steps'
                % (launches, runs))

    greedy = [i for i, q in enumerate(reqs) if q['temperature'] == 0.0]
    for i in greedy[:4]:
        alone = eng.generate(timeout=120, **reqs[i])
        require(alone == results[i],
                'request %d: alone %s != concurrent %s'
                % (i, alone[:8], results[i][:8]))
    print('4 greedy streams re-run alone equal their concurrent runs')
    eng.shutdown()
    if profile:
        _profile_decode(torch, eng, spec, card)
    require(eng.free_pages() == eng.num_blocks, 'pages leaked after rerun')
    return results, launches


# ------------------------------------------------------------ phase 5
def phase_cpu_compare(spec, reqs, results, block_size, n_new):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.serving.decode import DecodeEngine, random_weights
    greedy = [i for i, q in enumerate(reqs) if q['temperature'] == 0.0]
    pick = sorted(greedy, key=lambda i: len(reqs[i]['prompt_ids']))[:2]
    longest = max(len(reqs[i]['prompt_ids']) for i in pick) + n_new
    pages = -(-longest // block_size)
    t0 = time.perf_counter()
    eng = DecodeEngine(spec, max_batch=2, block_size=block_size,
                       num_blocks=4 * pages, pages_per_seq=pages,
                       place=pt.CPUPlace(),
                       weights=random_weights(spec, seed=0))
    eng.start()
    streams = [eng.submit(reqs[i]['prompt_ids'], max_new_tokens=n_new)
               for i in pick]
    got = [s.result(timeout=600) for s in streams]
    eng.shutdown()
    for i, g in zip(pick, got):
        require(g == results[i][:n_new],
                'request %d: CPU %s != first run %s'
                % (i, g, results[i][:n_new]))
    print('CPUPlace engine (plain versions): %d prompts x %d greedy tokens '
          'equal the first run\'s streams (%.1f s)'
          % (len(pick), n_new, time.perf_counter() - t0))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--cpu-rehearsal', action='store_true',
                    help='run phases 4-5 on the host at the tests\' tiny '
                         'LM with the plain versions')
    ap.add_argument('--profile', action='store_true',
                    help='after the engine run, profile 20 decode steps '
                         'with every slot busy (torch.profiler) and print '
                         'where the time goes')
    args = ap.parse_args()
    t_start = time.perf_counter()
    import torch
    if not args.cpu_rehearsal and not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this smoke needs a CUDA '
             'card (use --cpu-rehearsal on the host)')
    sys.path.insert(0, REPO)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.serving.decode import LMSpec

    if args.cpu_rehearsal:
        spec = LMSpec(vocab_size=60, n_layer=2, n_head=2, d_key=8,
                      d_value=8, d_model=16, d_inner=32)
        reqs = _requests(spec, 32, 1, 9, 6)
        results, _ = phase_engine(
            torch, spec, dict(max_batch=4, block_size=4, num_blocks=64,
                              pages_per_seq=4),
            reqs, pt.CPUPlace(), 'host CPU, rehearsal', False)
        phase_cpu_compare(spec, reqs, results, 4, 4)
        print('cpu rehearsal ok in %.1f s' % (time.perf_counter() - t_start))
        return

    name, count, card = phase_device(torch)
    phase_build()
    ln, pa = phase_kernels(torch, card)
    spec = LMSpec(vocab_size=32000, n_layer=12, n_head=8, d_key=64,
                  d_value=64, d_model=512, d_inner=2048)
    reqs = _requests(spec, 32, 64, 512, 64)
    results, launches = phase_engine(
        torch, spec, dict(max_batch=16, block_size=32, num_blocks=4096,
                          pages_per_seq=64),
        reqs, pt.CUDAPlace(0), card, True, profile=args.profile)
    phase_cpu_compare(spec, reqs, results, 32, 16)

    kernels = [
        dict(name='layer_norm', route='cuda',
             source='paddle_tpu_torch/csrc/layer_norm.cu',
             replaces='paddle_tpu/ops/pallas/layer_norm.py:23',
             launches=launches['layer_norm'], **ln),
        dict(name='paged_attention', route='cuda',
             source='paddle_tpu_torch/csrc/paged_attention.cu',
             replaces='paddle_tpu/ops/pallas/paged_attention.py:86',
             launches=launches['paged_attention'], **pa),
    ]
    print('total %.1f s' % (time.perf_counter() - t_start))
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': name,
                                             'count': count}}))


if __name__ == '__main__':
    main()
