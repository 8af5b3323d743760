#!/usr/bin/env python3
"""Chip smoke for paddle_tpu_torch: decode serving, Transformer training
and ResNet-50 training on one CUDA card.

    python3 chip_smoke.py                  # on a machine with one H100
    python3 chip_smoke.py --cpu-rehearsal  # phases 4-10 on the host, tiny

Phases (any fault exits non-zero; no phase is skipped over):

1. Device: name, count, nvidia-smi's name and power limit, TF32 flags
   (both set off: fp32 matmuls and convolutions run in full fp32).
2. Build: every CUDA kernel from paddle_tpu_torch/csrc, one nvcc a
   source, all started together, then a link; build time and ptxas's
   registers / shared memory / spills per kernel.
3. Kernel vs plain version on the card at the main paths' shapes, fp32
   and bf16, with the stated tolerance; device times of the kernel, the
   plain version and a library yardstick (CUDA-graph replay, CUDA
   events) beside each kernel's bound, and the kernel's eager time.
   Layer norm (K1) and its two backward kernels (against autograd of the
   plain forward, twice for equal bits, beside F.layer_norm's backward),
   at [4096, 512] (the Transformer's) among others; paged attention (K4)
   against both its plain versions
   (one-pass softmax; per-chunk partials merged in split order) at the
   decode shapes (16 rows, lengths 1..2048 with empty slots; every row at
   2,048 tokens: every split live; the engine's range 64..576) and the
   prefill's broadcast table at 128 and 512 rows, fp32 and bf16, and a
   row-independence check: one row in a 16-row batch, alone and inside a
   128-row broadcast call gives the same bits, and its any-width kernel
   at bf16 d_key 36, fp32 d_key 30 and D = Dv = 192; flash attention
   forward
   (K2, against the whole-row and the 64-key tiled plain versions, each
   case run twice, the launch-variant counters read) and backward (K3:
   its tensor-core pair and, on copies one element into their storage,
   its SIMT pair, each run twice for equal bits, the variant counters
   read; SDPA's backward timed by graph replay beside it) at the
   training shapes: B=64 H=8 T=64 D=64 bf16
   non-causal and causal, B=8 H=8 T=512 causal with kv_len 256-512 and
   one row at 1, B=4 H=4 T=200 D=128 bf16 and B=64 T=64 fp32 (the SIMT
   kernels), and the inputs of the JAX op's default path: causal Tq=256
   Tk=512 and Tq=512 Tk=256 (bottom-right), kv_len-0 rows, D=256 bf16 and
   D=192 fp32; batch norm (K5, one launch a call, run twice for equal bits)
   at ResNet-50's stem, stage-1, stage-2 and stage-4 shapes in bf16 NHWC,
   two NCHW shapes, an fp32 and an odd shape, each staged on chip or read
   twice as its plan says (both happen in both orders), and its backward
   kernel at each shape (one launch, twice for equal bits, against
   batch_norm_reference_bwd, beside F.batch_norm's backward) and through
   autograd against autograd of the plain version.
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
6. Training: bench.py's bench_transformer through the port's user API
   (transformer_base at vocab 32000, 6+6 layers, d_model 512, dropout
   and label smoothing 0.1; Adam(1e-4).minimize; amp 'bf16';
   Executor(CUDAPlace(0)).run) on make_fake_batch(64, 64, 64, ...): 3
   warm-up and 20 timed steps. ms a step, tokens/s, MFU against 989
   TFLOP/s, the first and last loss (finite, falling), peak memory, and
   the launch counts of the timed steps (K2, both K3 kernels 18 a step,
   K1 30 a step and its backward 60; every flash launch through its
   tensor-core variant).
7. Masked training: 3 + 10 steps at bench_transformer_masked's shape
   (batch 8, seq 512, src_length uniform in [256, 512], lbl_weight
   masking the same positions): padded and real tokens/s.
8. Training card vs CPU: the same Program at batch 2 x seq 64, fp32,
   dropout 0, no amp; 3 Adam steps on CUDAPlace(0) and on CPUPlace()
   from the same weights: each loss within 1e-4 relative, every
   parameter within 2*lr*steps.
9. ResNet-50 training: bench.py's bench_resnet50 through the port's user
   API (resnet50_with_loss, NHWC; Momentum(0.1, 0.9).minimize; amp
   'bf16'; Executor(CUDAPlace(0)).run) at batch 64 x 3 x 224 x 224,
   1000 classes, on bench.py's RandomState(0) feed: 3 warm-up and 20
   timed steps. ms a step, images/s, MFU of the conv and fc FLOPs, the
   first and last loss (finite, falling), peak memory, K5 launches and
   its backward's (53 a step each), every running mean and variance
   moved and finite.
10. ResNet card vs CPU: ResNet-50 at 32x32, batch 8, 10 classes, NCHW,
   fp32, Momentum(0.01), 3 steps from the same weights on each place:
   the first loss within 1e-3 relative, the running statistics and
   gradients of the first step within stated bounds, later losses
   printed beside the host's own spread.

The last line is {"ok": true, "device": {...}}; before it come one JSON
line with every kernel's numbers and nvidia-smi's name and power limit.
--cpu-rehearsal runs phases 4-10 at tiny sizes with the plain versions
(phases 8 and 10 then compare the host with itself) and never prints
that last line. --profile adds, after every other phase, a torch.profiler
breakdown of decode steps, Transformer and ResNet-50 training steps.
--kernels-only stops after phase 3 (no verdict line). kernel_times.py
times K1, K4, K2, K3 and K5 and the backward kernels of any checkout of
this repository at phase 3's shapes.
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
BF16_FLOPS = 989e12
VOCAB = 32000


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


def bound_ms(n_bytes, n_ops, peak_ops=FP32_FLOPS):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


# the flash wrappers, which also count each of their two variants
VARIANTS = ('flash_attention_fwd', 'flash_attention_bwd_dkv',
            'flash_attention_bwd_dq')


def _counters():
    """[(name, wrapper, attribute)]: every launch count the smoke reads
    (each wrapper adds one where it launches its kernel), and the batch
    norm backward's copies of a gradient into x's layout."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels.batch_norm import fused_batch_norm_train
    from paddle_tpu_torch.ops.kernels.layer_norm import fused_layer_norm
    from paddle_tpu_torch.ops.kernels.paged_attention import paged_attention
    res = [('layer_norm', fused_layer_norm, 'launches'),
           ('layer_norm_bwd', fused_layer_norm, 'bwd_launches'),
           ('paged_attention', paged_attention, 'launches'),
           ('paged_attention_v16', paged_attention, 'launches_v16'),
           ('paged_attention_any', paged_attention, 'launches_any'),
           ('batch_norm', fused_batch_norm_train, 'launches'),
           ('batch_norm_bwd', fused_batch_norm_train, 'bwd_launches'),
           ('batch_norm_bwd_gy_copies', fused_batch_norm_train,
            'bwd_gy_copies')]
    for name, fn in zip(VARIANTS, (fa.flash_fwd_cuda, fa.flash_bwd_dkv_cuda,
                                   fa.flash_bwd_dq_cuda)):
        res += [(name, fn, 'launches'), (name + '_mma', fn, 'launches_mma'),
                (name + '_simt', fn, 'launches_simt')]
    return res


def reset_launches():
    """Every kernel wrapper's launch counts to 0."""
    for _, fn, attr in _counters():
        setattr(fn, attr, 0)


def read_launches():
    return {name: getattr(fn, attr) for name, fn, attr in _counters()}


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
    """Build, print ptxas's numbers, and fail unless its log shows the
    split-KV and the tensor-core kernels."""
    from paddle_tpu_torch.ops.kernels import build
    res = build.build()
    print('build: %.2f s (one nvcc a source, all started together, then a '
          'link: %s) -> %s' % (res.seconds, ' '.join(build.SOURCES),
                               os.path.relpath(res.path, REPO)))
    for line in res.log.splitlines():
        if 'ptxas info' in line and ('Compiling' in line or 'Used' in line):
            print('  ' + line.strip())
        elif 'spill' in line:   # the stack frame and spills of the above
            print('    ' + line.strip())
    lib = build.library()
    for kernel in ('paged_split_kernel', 'paged_merge_kernel',
                   'paged_split_any_kernel', 'flash_fwd_mma_kernel',
                   'flash_bwd_dkv_mma_kernel', 'flash_bwd_dq_mma_kernel',
                   'bn_train_kernel', 'bn_bwd_kernel', 'ln_warp_kernel',
                   'ln_bwd_rows_kernel', 'ln_bwd_cols_kernel'):
        require(kernel in res.log, 'ptxas\'s log does not show %s' % kernel)
    print('  flash attention dynamic shared memory at D=64: tensor-core '
          'forward %d B, SIMT forward %d B, SIMT dK/dV %d B, SIMT dQ %d B, '
          'tensor-core backward %d B'
          % tuple(lib.ptt_flash_smem_bytes(i, 64) for i in (3, 0, 1, 2, 4)))
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


def grad_ms(torch, fn, inputs, grad_out, iters=50):
    """The backward of ``fn(*inputs)`` under autograd: (device ms a call by
    CUDA-graph replay, the autograd node that ran it, eager ms). The forward
    runs once outside the graph, on the stream that then captures ``iters``
    calls of torch.autograd.grad of its output (autograd runs a backward on
    its forward's stream)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [x.detach().clone().requires_grad_() for x in inputs]
        out = fn(*leaves)

        def grad():
            return torch.autograd.grad(out, leaves, grad_out,
                                       retain_graph=True)

        for _ in range(3):
            grad()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(iters):
                grad()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    ms = _events_ms(torch, graph.replay, iters)
    del graph
    eager = eager_ms(torch, grad, iters=iters)
    return ms, out.grad_fn.name(), eager


GRAD_TOL = ('dx: bf16 within 1 bf16 ulp of max(|kernel|, |plain|) + 1e-6 '
            'max|dx|, fp32 max-norm relative 1e-5; parameter gradients '
            'max-norm relative 1e-5')


def grads_ok(torch, got, want, dtype):
    """(max abs errors, ok) of a backward kernel's outputs against its plain
    version's: dx in x's dtype first, then fp32 parameter gradients. bf16
    dx: within one bf16 ulp of max(|kernel|, |plain|), plus 1e-6 of the
    largest |dx| (fp32 sums taken in another order where dx cancels to
    near 0); fp32 dx and every parameter gradient: max-norm relative 1e-5
    (|kernel - plain| <= 1e-5 * max|plain|)."""
    errs, ok = [], True
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        diff = (g - w).abs()
        top = float(w.abs().max())
        errs.append(float(diff.max()))
        if i == 0 and dtype == torch.bfloat16:
            ok = ok and bool((diff <= bf16_ulp_t(torch, torch.maximum(
                g.abs(), w.abs())) + 1e-6 * top).all())
        else:
            ok = ok and errs[-1] <= 1e-5 * top
    return errs, ok


def _ln_bwd_case(torch, card, n, d, dtype, gen):
    """K1's backward kernels (row kernel + column sum) against
    layer_norm_reference_bwd (autograd through the plain forward), two
    runs for equal bits, and their times beside F.layer_norm's autograd
    backward."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import layer_norm as K
    dev = torch.device('cuda', 0)
    x = torch.randn(n, d, generator=gen, device=dev).to(dtype)
    g = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
    b = 0.1 * torch.randn(d, generator=gen, device=dev)
    gy = torch.randn(n, d, generator=gen, device=dev).to(dtype)
    before = K.fused_layer_norm.bwd_launches
    got = K._ln_bwd_cuda(x, g, gy, 1e-5)
    again = K._ln_bwd_cuda(x, g, gy, 1e-5)
    torch.cuda.synchronize()
    require(K.fused_layer_norm.bwd_launches == before + 4,
            'layer_norm backward: %d launches for 2 calls, want 4'
            % (K.fused_layer_norm.bwd_launches - before))
    require(all(torch.equal(a, r) for a, r in zip(got, again)),
            'layer_norm backward [%d, %d]: two runs differ' % (n, d))
    want = K.layer_norm_reference_bwd(x, g, b, gy, 1e-5)
    errs, ok = grads_ok(torch, got, want, dtype)
    item = x.element_size()
    lo, by = bound_ms(3 * n * d * item + 3 * d * 4, 12 * n * d)
    bwd = lambda: K._ln_bwd_cuda(x, g, gy, 1e-5)  # noqa: E731
    ms = device_ms(torch, bwd)
    eager = eager_ms(torch, bwd)
    plain = device_ms(torch, lambda: K.layer_norm_reference_bwd(
        x, g, b, gy, 1e-5), iters=20)
    lib, node, lib_eager = grad_ms(
        torch, lambda a, w, c: F.layer_norm(a, (d,), w, c, 1e-5),
        (x, g.to(dtype), b.to(dtype)), gy)
    label = 'layer_norm backward [%d, %d] %s' % (n, d, str(dtype)[6:])
    print('%s: max_abs_err dx %.3g, dgamma %.3g, dbeta %.3g (%s) %s; two '
          'launches a call, two runs bit-equal; device ms: kernels %.5f, '
          'plain %.5f, F.layer_norm backward %.5f (%s; eager %.5f), bound '
          '%.6f (%s); kernels eager %.5f ms [%s]'
          % (label, errs[0], errs[1], errs[2], GRAD_TOL,
             'ok' if ok else 'MISMATCH', ms, plain, lib, node, lib_eager, lo,
             by, eager, card))
    require(ok, '%s disagrees with its plain version' % label)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=lo,
                bound_by=by, library_ms=lib, eager_ms=eager)


def _paged_inputs(torch, gen, n, lens, dtype, broadcast, h=8, d=64, bs=32,
                  p=64, nb=4096, empty=(), dv=None):
    dev = torch.device('cuda', 0)
    dv = d if dv is None else dv
    kp = torch.randn(nb, h, bs, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(nb, h, bs, dv, generator=gen, device=dev).to(dtype)
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


def _paged_case(torch, card, label, q, kp, vp, tables, lens, heavy=False):
    """K4 against both its plain versions on one input, and its times.
    ``heavy`` (the 512-row prefill: the plain versions gather GBs) cuts
    the plain version's and the yardstick's timed calls to 5."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import paged_attention as K
    out = K.paged_attention(q, kp, vp, tables, lens)
    refs = [K.paged_attention_reference(q, kp, vp, tables, lens).float(),
            K.paged_attention_split_reference(q, kp, vp, tables, lens)]
    torch.cuda.synchronize()
    of = out.float().cpu().numpy()
    live = (lens > 0).cpu().numpy()    # an empty slot gives 0, no average
    require(np.all(of[~live] == 0), '%s: an empty row is not 0' % label)
    if kp.dtype == torch.float32:
        tol = 'fp32: |kernel - plain| <= 5e-5'
    else:
        tol = ('bf16: |kernel - plain| <= 2e-2 + 2e-2*|plain| (plain '
               'output rounded to bf16, 2^-7 at the top of a binade, and '
               'p rounded to bf16 at different points)')
    errs, ok = [], True
    for ref in refs:
        rf = ref.cpu().numpy()
        gap = np.abs(of - rf)[live]
        errs.append(float(gap.max()))
        if kp.dtype == torch.float32:
            ok = ok and errs[-1] <= 5e-5
        else:
            ok = ok and bool(np.all(gap <= 2e-2 + 2e-2 * np.abs(rf[live])))
    del refs
    err = max(errs)
    nb, h, bs, d = kp.shape
    n, p = tables.shape
    lens_h = lens.cpu().numpy().astype(np.int64)
    tab_h = tables.cpu().numpy()
    npages = np.minimum(-(-lens_h // bs), p)
    pages = set()
    for i in range(n):
        pages.update(np.clip(tab_h[i, :npages[i]], 0, nb - 1).tolist())
    item = kp.element_size()
    dv = vp.shape[-1]
    n_bytes = (len(pages) * h * bs * (d + dv) * item + n * h * (d + dv) * 4 +
               int(npages.sum()) * 4 + n * 4)
    n_ops = int(lens_h.sum()) * h * (2 * d + 2 * dv + 5)
    lo, by = bound_ms(n_bytes, n_ops)
    ms = device_ms(torch, lambda: K.paged_attention(q, kp, vp, tables,
                                                    lens))
    eager = eager_ms(torch, lambda: K.paged_attention(q, kp, vp, tables,
                                                      lens))
    few = 5 if heavy else 20
    plain = device_ms(torch, lambda: K.paged_attention_reference(
        q, kp, vp, tables, lens), iters=few)
    # yardstick: SDPA over K/V already gathered (the gather is not timed)
    idx = tables.long().clamp(0, nb - 1)
    kg = kp[idx].permute(0, 2, 1, 3, 4).reshape(n, h, p * bs, d)
    vg = vp[idx].permute(0, 2, 1, 3, 4).reshape(n, h, p * bs, dv)
    mask = (torch.arange(p * bs, device=q.device)[None, :] <
            lens[:, None])[:, None, None, :]
    qd = q[:, :, None, :].to(kp.dtype)
    lib = device_ms(torch, lambda: F.scaled_dot_product_attention(
        qd, kg, vg, attn_mask=mask), iters=few)
    del kg, vg
    print('%s: max_abs_err %s vs the one-pass and the split plain version '
          '(%s) %s; device ms: kernel %.5f, plain %.5f, SDPA(gathered) '
          '%.5f, bound %.6f (%s); kernel eager %.5f ms [%s]'
          % (label, ' / '.join('%.3g' % e for e in errs), tol,
             'ok' if ok else 'MISMATCH', ms, plain, lib, lo, by, eager,
             card))
    require(ok, '%s disagrees with its plain version' % label)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=lo,
                bound_by=by, library_ms=lib, eager_ms=eager)


def _paged_row_independence(torch, card, gen):
    """A row's output must be a pure function of its q, pages and length:
    the same row in a 16-row decode batch, alone in a 1-row call and
    inside a 128-row broadcast-table call, bit for bit, fp32 and bf16
    (the engine's concurrent-equals-alone and preempt-and-recompute
    invariants rest on it)."""
    from paddle_tpu_torch.ops.kernels import paged_attention as K
    dev = torch.device('cuda', 0)
    lens16 = [1, 33, 300, 2048, 257, 256, 576, 1000, 64, 65, 2047, 31, 512,
              700, 1500, 2]
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, tables, lens = _paged_inputs(torch, gen, 16, lens16,
                                                dtype, False)
        full = K.paged_attention(q, kp, vp, tables, lens)
        for i in (1, 2, 3, 4, 9, 13):
            alone = K.paged_attention(q[i:i + 1], kp, vp, tables[i:i + 1],
                                      lens[i:i + 1])
            qs = torch.randn(128, 8, 64, generator=gen, device=dev)
            qs[77] = q[i]
            ls = torch.randint(1, 2049, (128,), generator=gen,
                               device=dev).to(torch.int32)
            ls[77] = lens[i]
            row = tables[i].clone()
            row[row >= kp.shape[0]] = 5   # other rows read past this one
            many = K.paged_attention(qs, kp, vp, row.expand(128, 64), ls)
            torch.cuda.synchronize()
            require(torch.equal(alone[0], full[i]) and
                    torch.equal(many[77], full[i]),
                    'paged_attention %s: row %d (length %d) differs between '
                    'a 16-row batch, a 1-row call and a 128-row broadcast '
                    'call' % (str(dtype)[6:], i, lens16[i]))
        del q, kp, vp
        torch.cuda.empty_cache()
    print('paged_attention row independence: 6 rows x 2 dtypes bit-equal in '
          'a 16-row batch, alone and inside a 128-row broadcast-table call '
          '[%s]' % card)


def _live_pairs(b, tq, tk, lens, causal):
    """(query, key) pairs that attend, summed over the batch (per head;
    the causal band aligned bottom-right)."""
    rows = np.arange(tq)[:, None]
    cols = np.arange(tk)[None, :]
    live = 0
    for i in range(b):
        m = cols < (tk if lens is None else int(lens[i]))
        if causal:
            m = m & (cols <= rows + tk - tq)
        live += int(np.broadcast_to(m, (tq, tk)).sum())
    return live


def _flash_case(torch, card, label, b, h, t, d, dtype, causal, lens, gen,
                tk=None):
    """K2 and K3 against their plain versions on one input (Tq = t, Tk =
    tk, default t); returns the numbers of each (forward, backward)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as K
    dev = torch.device('cuda', 0)
    tk = t if tk is None else tk
    q, do = (torch.randn(b, h, t, d, generator=gen, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, h, tk, d, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    kv = None if lens is None else torch.tensor(lens, device=dev)
    fwd_count = K.flash_fwd_cuda
    before = (fwd_count.launches_mma, fwd_count.launches_simt)
    out, lse = K.flash_attention_fwd(q, k, v, kv, causal)
    # a second run must give the same bits: a copy that was not waited for
    # shows as rare wrong values, not as a fault
    out2, lse2 = K.flash_attention_fwd(q, k, v, kv, causal)
    torch.cuda.synchronize()
    require(torch.equal(out, out2) and torch.equal(lse, lse2),
            '%s: two runs of K2 differ' % label)
    del out2, lse2
    moved = (fwd_count.launches_mma - before[0],
             fwd_count.launches_simt - before[1])
    # the launchers' choice: bf16 with a head dim that is a multiple of 16
    # up to 128 on the tensor cores, everything else SIMT
    mma = dtype == torch.bfloat16 and d % 16 == 0 and d <= 128
    variant = 'tensor-core' if mma else 'SIMT'
    require(moved == ((2, 0) if mma else (0, 2)),
            '%s: K2 launched (tensor-core, SIMT) = %s, want the %s kernel '
            'twice' % (label, moved, variant))
    ref_out, ref_lse = K.flash_attention_reference_fwd(q, k, v, kv, causal)
    til_out, til_lse = K.flash_attention_tiled_reference_fwd(q, k, v, kv,
                                                             causal)
    # K3 twice on its own variant (the same bits), and for bf16 the SIMT
    # pair too, on copies that start one element into their storage
    variant_bwd = 'mma' if mma else 'simt'
    before = _bwd_counts(K)
    grads = K.flash_attention_bwd(q, k, v, out, lse, do, kv, causal)
    grads2 = K.flash_attention_bwd(q, k, v, out, lse, do, kv, causal)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(grads, grads2)),
            '%s: two runs of K3 differ' % label)
    require(_bwd_moved(K, before) == variant_bwd,
            '%s: K3 launched %s, want the %s pair twice'
            % (label, _bwd_moved(K, before), variant_bwd))
    del grads2
    ref_grads = K.flash_attention_reference_bwd(q, k, v, out, lse, do, kv,
                                                causal)
    simt_grads = None
    if mma:
        shifted = [_shifted(torch, x) for x in (q, k, v, out, do)]
        before = _bwd_counts(K)
        simt_grads = K.flash_attention_bwd(*shifted[:4], lse, shifted[4], kv,
                                           causal)
        again = K.flash_attention_bwd(*shifted[:4], lse, shifted[4], kv,
                                      causal)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(simt_grads, again)),
                '%s: two runs of the SIMT K3 pair differ' % label)
        require(_bwd_moved(K, before) == 'simt',
                '%s: K3 on misaligned copies launched %s, want the SIMT '
                'pair twice' % (label, _bwd_moved(K, before)))
        del shifted, again
    torch.cuda.synchronize()
    if dtype == torch.float32:
        tol = ('fp32: |kernel - plain| <= 1e-5 * max(1, max|plain|) (the '
               'same sums in another order)')
    else:
        tol = ('bf16: |kernel - plain| <= 1e-2 * max|plain| + 1e-2 * '
               '|plain| (outputs rounded to bf16; p rounded per tile '
               'against the running max, in the plain version against the '
               'row max)')

    def err_ok(got, want):
        g, w = got.float(), want.float()
        top = float(w.abs().max())
        diff = (g - w).abs()
        if dtype == torch.float32:
            ok = float(diff.max()) <= 1e-5 * max(top, 1.0)
        else:
            ok = bool((diff <= 1e-2 * top + 1e-2 * w.abs()).all())
        return float(diff.max()), ok

    fwd_err, fwd_ok = err_ok(out, ref_out)
    til_err, til_ok = err_ok(out, til_out)
    lse_err = max(float((lse - ref_lse).abs().max()),
                  float((lse - til_lse).abs().max()))
    fwd_ok = fwd_ok and til_ok and lse_err <= 1e-4
    del til_out, til_lse
    bwd = [err_ok(g, w) for g, w in zip(grads, ref_grads)]
    bwd_err = max(e for e, _ in bwd)
    bwd_ok = all(ok for _, ok in bwd)
    simt_note = ''
    if simt_grads is not None:
        simt = [err_ok(g, w) for g, w in zip(simt_grads, ref_grads)]
        simt_err = max(e for e, _ in simt)
        bwd_ok = bwd_ok and all(ok for _, ok in simt)
        simt_note = ', SIMT pair %.3g' % simt_err
        del simt_grads

    item = q.element_size()
    nq, nk = b * h * t * d * item, b * h * tk * d * item
    live = _live_pairs(b, t, tk, lens, causal) * h
    peak = BF16_FLOPS if mma else FP32_FLOPS
    fwd_bound = bound_ms(2 * nq + 2 * nk + b * h * t * 4, 4 * live * d,
                         peak)
    bwd_bound = bound_ms(4 * nq + 4 * nk + b * h * t * 4,
                         2.5 * 4 * live * d, peak)

    fwd = lambda: K.flash_attention_fwd(q, k, v, kv, causal)  # noqa: E731
    bwd_fn = lambda: K.flash_attention_bwd(  # noqa: E731
        q, k, v, out, lse, do, kv, causal)
    times = dict(
        fwd_ms=device_ms(torch, fwd, iters=50),
        fwd_eager=eager_ms(torch, fwd, iters=50),
        fwd_plain=device_ms(torch, lambda: K.flash_attention_reference_fwd(
            q, k, v, kv, causal), iters=10),
        bwd_ms=device_ms(torch, bwd_fn, iters=50),
        bwd_eager=eager_ms(torch, bwd_fn, iters=50),
        bwd_plain=device_ms(torch, lambda: K.flash_attention_reference_bwd(
            q, k, v, out, lse, do, kv, causal), iters=10))
    # yardstick: SDPA forward and its autograd backward (graph replay, as
    # the kernels; the backward also eager), on the same inputs and mask
    mask = sdpa_mask(torch, t, kv, causal, tk)
    sdpa_causal = causal and mask is None
    times['fwd_lib'] = device_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=sdpa_causal), iters=50)
    times['bwd_lib'], backend, times['bwd_lib_eager'] = sdpa_bwd_ms(
        torch, q, k, v, do, mask, sdpa_causal)
    print('%s: forward (%s kernel) max_abs_err %.3g vs the whole-row and '
          '%.3g vs the tiled plain version (lse %.3g, limit 1e-4), backward '
          '(%s pair) max_abs_err %.3g%s (%s) %s; device ms: forward kernel '
          '%.5f, plain %.5f, SDPA %.5f, bound %.6f (%s); backward kernels '
          '%.5f, plain %.5f, SDPA backward %.5f (%s; eager %.5f), bound '
          '%.6f (%s); eager ms: forward %.5f, backward %.5f [%s]'
          % (label, variant, fwd_err, til_err, lse_err,
             'tensor-core' if variant_bwd == 'mma' else 'SIMT', bwd_err,
             simt_note, tol, 'ok' if fwd_ok and bwd_ok else 'MISMATCH',
             times['fwd_ms'], times['fwd_plain'], times['fwd_lib'],
             fwd_bound[0], fwd_bound[1], times['bwd_ms'], times['bwd_plain'],
             times['bwd_lib'], backend, times['bwd_lib_eager'], bwd_bound[0],
             bwd_bound[1], times['fwd_eager'], times['bwd_eager'], card))
    require(fwd_ok, '%s: K2 disagrees with its plain version' % label)
    require(bwd_ok, '%s: K3 disagrees with its plain version' % label)
    fwd_rec = dict(max_abs_err=max(fwd_err, til_err, lse_err),
                   ms=times['fwd_ms'],
                   plain_ms=times['fwd_plain'], bound_ms=fwd_bound[0],
                   bound_by=fwd_bound[1], library_ms=times['fwd_lib'],
                   eager_ms=times['fwd_eager'])
    bwd_rec = dict(max_abs_err=bwd_err, ms=times['bwd_ms'],
                   plain_ms=times['bwd_plain'], bound_ms=bwd_bound[0],
                   bound_by=bwd_bound[1], library_ms=times['bwd_lib'],
                   eager_ms=times['bwd_eager'], library=backend,
                   library_eager_ms=times['bwd_lib_eager'])
    return fwd_rec, bwd_rec


def _bwd_counts(K):
    return [(w.launches_mma, w.launches_simt)
            for w in (K.flash_bwd_dq_cuda, K.flash_bwd_dkv_cuda)]


def _bwd_moved(K, before):
    """'mma' or 'simt' when each K3 kernel launched twice since ``before``,
    both on that variant; else the counts' moves."""
    moved = [(m - m0, n - n0)
             for (m, n), (m0, n0) in zip(_bwd_counts(K), before)]
    return {(2, 0): 'mma', (0, 2): 'simt'}.get(moved[0], moved) \
        if moved[0] == moved[1] else moved


def _shifted(torch, x):
    """A copy of x that starts one element into its storage: its 16-byte
    loads would be misaligned, so the flash launchers take the SIMT
    kernels."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    return view


def sdpa_mask(torch, t, kv, causal, tk=None):
    """SDPA's boolean mask for the flash cases' kv_len and causal band
    (aligned bottom-right, as the port's), or None where ``is_causal``
    alone says it (Tq = Tk, no kv_len). A row with no live key gives NaN
    there: SDPA is a yardstick of time only."""
    tk = t if tk is None else tk
    if kv is None and (not causal or tk == t):
        return None
    dev = kv.device if kv is not None else 'cuda'
    mask = torch.ones(1, 1, t, tk, dtype=torch.bool, device=dev)
    if kv is not None:
        mask = mask & (torch.arange(tk, device=dev)[None, :] <
                       kv[:, None])[:, None, None, :]
    if causal:
        mask = mask & torch.ones(t, tk, dtype=torch.bool,
                                 device=dev).tril(tk - t)
    return mask


def sdpa_bwd_ms(torch, q, k, v, do, mask, is_causal, iters=50):
    """SDPA's backward on these inputs: (device ms a call by CUDA-graph
    replay, as the kernels are timed, the backend's autograd node, eager
    ms), by grad_ms."""
    import torch.nn.functional as F
    return grad_ms(torch, lambda a, b, c: F.scaled_dot_product_attention(
        a, b, c, attn_mask=mask, is_causal=is_causal), (q, k, v), do,
        iters=iters)


def flash_shapes(torch):
    """Phase 3's flash-attention cases: (label, B, H, T, D, dtype, causal,
    kv_len or None). The first is the kernels line's."""
    rng = np.random.RandomState(0)
    masked = rng.randint(256, 513, 8)
    masked[-1] = 1
    return [
        ('flash_attention B=64 H=8 T=64 D=64 bf16 encoder (non-causal, '
         'kv_len full)', 64, 8, 64, 64, torch.bfloat16, False, [64] * 64),
        ('flash_attention B=64 H=8 T=64 D=64 bf16 decoder (causal)', 64, 8,
         64, 64, torch.bfloat16, True, None),
        ('flash_attention B=8 H=8 T=512 D=64 bf16 causal, kv_len %d-%d '
         'and one row at 1' % (masked[:-1].min(), masked[:-1].max()), 8, 8,
         512, 64, torch.bfloat16, True, masked.tolist()),
        ('flash_attention B=4 H=4 T=200 D=128 bf16 (non-causal, kv_len '
         '200, 131, 64, 1)', 4, 4, 200, 128, torch.bfloat16, False,
         [200, 131, 64, 1]),
        ('flash_attention B=64 H=8 T=64 D=64 float32 encoder', 64, 8, 64, 64,
         torch.float32, False, [64] * 64),
    ]


def flash_fault_shapes(torch):
    """Phase 3's cases of the inputs the JAX op's default path takes:
    (label, B, H, Tq, Tk, D, dtype, causal, kv_len or None)."""
    return [
        ('flash_attention B=8 H=8 Tq=256 Tk=512 D=64 bf16 causal '
         '(bottom-right: a chunk of queries after a 256-token prefix)', 8, 8,
         256, 512, 64, torch.bfloat16, True, None),
        ('flash_attention B=8 H=8 Tq=512 Tk=256 D=64 bf16 causal (the first '
         '256 rows see no key)', 8, 8, 512, 256, 64, torch.bfloat16, True,
         None),
        ('flash_attention B=8 H=8 T=512 D=64 bf16, kv_len 512, 300 and two '
         'rows at 0', 8, 8, 512, 512, 64, torch.bfloat16, False,
         [512, 300, 0, 512, 0, 512, 512, 512]),
        ('flash_attention B=4 H=8 T=512 D=256 bf16 causal (SIMT, query '
         'tiles of 32 in the backward)', 4, 8, 512, 512, 256,
         torch.bfloat16, True, None),
        ('flash_attention B=4 H=4 T=200 D=192 float32 kv_len 200, 131, 0, '
         '1', 4, 4, 200, 200, 192, torch.float32, False, [200, 131, 0, 1]),
    ]


def phase_flash_kernels(torch, card):
    gen = torch.Generator(device='cuda').manual_seed(1)
    res = []
    for label, b, h, t, d, dtype, causal, lens in flash_shapes(torch):
        res.append(_flash_case(torch, card, label, b, h, t, d, dtype,
                               causal, lens, gen))
        torch.cuda.empty_cache()
    for label, b, h, tq, tk, d, dtype, causal, lens in \
            flash_fault_shapes(torch):
        _flash_case(torch, card, label, b, h, tq, d, dtype, causal, lens,
                    gen, tk=tk)
        torch.cuda.empty_cache()
    return res[0]


def paged_shapes(torch):
    """Phase 3's paged-attention cases: (key, label, page dtype, rows,
    lengths, broadcast table, empty rows). 'engine' is the kernels line's."""
    decode_lens = [1, 2, 31, 32, 33, 64, 65, 200, 576, 1000, 1500, 2047,
                   2048, 1, 1, 1]
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        cases += [
            ('decode ' + name, 'paged_attention decode N=16 H=8 D=64 bs=32 '
             'P=64 NB=4096 lens 1..2048 + 3 empty rows ' + name, dtype, 16,
             decode_lens, False, (13, 14, 15)),
            ('full ' + name, 'paged_attention decode N=16, every row at 2048 '
             'tokens (every split live) ' + name, dtype, 16, [2048] * 16,
             False, ()),
            ('prefill ' + name, 'paged_attention prefill N=128 broadcast '
             'table lens 1..128 ' + name, dtype, 128, list(range(1, 129)),
             True, ()),
            ('prefill512 ' + name, 'paged_attention prefill N=512 broadcast '
             'table lens 1..512 ' + name, dtype, 512, list(range(1, 513)),
             True, ())]
    # the engine run's own decode shape: 16 live rows, lengths across the
    # range its requests reach (prompts 64-512 plus up to 64 new tokens)
    cases.append(('engine', 'paged_attention decode N=16 lens 64..576 (the '
                  'engine run\'s range) float32', torch.float32, 16,
                  np.linspace(64, 576, 16).astype(int).tolist(), False, ()))
    return cases


def paged_any_shapes(torch):
    """Phase 3's cases of K4's any-width variant: (label, page dtype, D,
    Dv), each at the decode shape (16 rows, lengths 1..2048, 3 empty)."""
    return [
        ('paged_attention any-width, bf16 d_key 36 (72-byte rows)',
         torch.bfloat16, 36, 36),
        ('paged_attention any-width, fp32 d_key 30 (120-byte rows)',
         torch.float32, 30, 30),
        ('paged_attention any-width, fp32 D = Dv = 192 (768-byte rows)',
         torch.float32, 192, 192),
    ]


def ln_shapes(torch):
    """Phase 3's layer-norm cases: (rows, d). [16, 512] is decode's (the
    kernels line's forward), [4096, 512] the Transformer training step's
    (the kernels line's backward, fp32: AMP keeps layer_norm fp32)."""
    return [(16, 512), (512, 512), (64, 2048), (4096, 512)]


def phase_kernels(torch, card):
    gen = torch.Generator(device='cuda').manual_seed(0)
    ln = {}
    for n, d in ln_shapes(torch):
        for dtype in (torch.float32, torch.bfloat16):
            ln[(n, d, dtype)] = _ln_case(torch, card, n, d, dtype, gen)
    ln_bwd = {}
    for n, d in ((4096, 512), (16, 512), (64, 2048)):
        for dtype in (torch.float32, torch.bfloat16):
            ln_bwd[(n, d, dtype)] = _ln_bwd_case(torch, card, n, d, dtype,
                                                 gen)
    pa = {}
    for key, label, dtype, n, lens, broadcast, empty in paged_shapes(torch):
        args = _paged_inputs(torch, gen, n, lens, dtype, broadcast,
                             empty=empty)
        pa[key] = _paged_case(torch, card, label, *args, heavy=n >= 512)
        del args
        torch.cuda.empty_cache()
    from paddle_tpu_torch.ops.kernels import paged_attention as K
    decode_lens = paged_shapes(torch)[0][4]
    for label, dtype, d, dv in paged_any_shapes(torch):
        args = _paged_inputs(torch, gen, 16, decode_lens, dtype, False,
                             d=d, dv=dv, empty=(13, 14, 15))
        before = K.paged_attention.launches_any
        _paged_case(torch, card, label, *args)
        require(K.paged_attention.launches_any > before,
                '%s: the any-width kernel did not run' % label)
        del args
        torch.cuda.empty_cache()
    _paged_row_independence(torch, card, gen)
    return (ln[(16, 512, torch.float32)], ln_bwd[(4096, 512, torch.float32)],
            pa['engine'])


def _bn_case(torch, card, label, x, layout, gen):
    """K5 against its plain version on x: errors of y, mean and var, the
    kernel's device and eager times, its bound, the plain version's time
    and one F.batch_norm call's on the same tensor (never called by the
    port)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import batch_norm as K
    c = x.shape[1] if layout == 'NCHW' else x.shape[-1]
    dev = x.device
    g = 0.5 + torch.rand(c, generator=gen, device=dev)
    b = torch.randn(c, generator=gen, device=dev)
    x4 = x.permute(0, 3, 1, 2) if layout == 'NHWC' else x
    x3 = x4.reshape(x4.shape[0], c, -1) if x.dim() == 4 else x.unsqueeze(-1)

    def kernel():
        return K.fused_batch_norm_train(x, g, b, 1e-5, layout=layout)

    plan = K.launch_plan(x3)
    before = K.fused_batch_norm_train.launches
    y, m, v = kernel()
    again = kernel()
    torch.cuda.synchronize()
    require(K.fused_batch_norm_train.launches == before + 2,
            '%s: %d launches for 2 calls'
            % (label, K.fused_batch_norm_train.launches - before))
    require(all(torch.equal(a, r) for a, r in zip((y, m, v), again)),
            '%s: two runs of K5 differ' % label)
    del again
    ry, rm, rv = K._bn_reference(x3, g, b, 1e-5)
    torch.cuda.synchronize()
    y4 = y.permute(0, 3, 1, 2) if layout == 'NHWC' else y
    y3 = y4.reshape(ry.shape) if x.dim() == 4 else y.unsqueeze(-1)
    err_y = float((y3.float() - ry.float()).abs().max())
    err_m = float((m - rm).abs().max())
    err_v = float((v - rv).abs().max())
    stats_ok = bool(((m - rm).abs() <= 1e-5 + 1e-5 * rm.abs()).all()) and \
        bool(((v - rv).abs() <= 1e-5 + 1e-4 * rv.abs()).all())
    if x.dtype == torch.float32:
        tol = ('fp32: y within 1e-4 + 1e-4*|plain|, mean 1e-5 and var 1e-4 '
               'relative (+1e-5)')
        ok = bool(((y3 - ry).abs() <= 1e-4 + 1e-4 * ry.abs()).all())
    else:
        tol = ('bf16: y within one bf16 ulp each of |x*a|, |b| and |y| (a, '
               'b from statistics 1e-6 apart may round to the neighbouring '
               'bf16 value); mean 1e-5, var 1e-4 relative (+1e-5)')
        a = g * torch.rsqrt(rv + 1e-5)
        bound = (bf16_ulp_t(torch, (x3.float() * a[:, None]).abs()) +
                 bf16_ulp_t(torch, (b - rm * a)[:, None].abs()) +
                 bf16_ulp_t(torch, ry.float().abs()))
        ok = bool(((y3.double() - ry.double()).abs() <= bound).all())
        del a, bound
    del ry, y3, y4
    ok = ok and stats_ok and \
        [st for st, n in zip(y.stride(), y.shape) if n > 1] == \
        [st for st, n in zip(x.stride(), x.shape) if n > 1]
    n = x.numel()
    item = x.element_size()
    lo, by = bound_ms(2 * n * item + 4 * c * 4, 6 * n)
    ms = device_ms(torch, kernel, iters=20)
    eager = eager_ms(torch, kernel, iters=20)
    plain = device_ms(torch, lambda: K._bn_reference(x3, g, b, 1e-5),
                      iters=5)
    xl = x4 if x.dim() == 4 else x
    lib = device_ms(torch, lambda: F.batch_norm(xl, None, None, g, b,
                                                training=True, eps=1e-5),
                    iters=20)
    print('%s: max_abs_err y %.3g, mean %.3g, var %.3g (%s) %s; one launch '
          'of %d blocks (the card holds %d), x %s, two runs bit-equal; '
          'device ms: kernel %.5f, plain %.5f, F.batch_norm %.5f, bound %.6f '
          '(%s); kernel eager %.5f ms [%s]'
          % (label, err_y, err_m, err_v, tol, 'ok' if ok else 'MISMATCH',
             plan['blocks'], plan['card_blocks'],
             'staged on chip (read once)' if plan['on_chip']
             else 'read twice (off chip)', ms, plain, lib, lo, by, eager,
             card))
    require(ok, '%s disagrees with its plain version' % label)
    fwd = dict(max_abs_err=max(err_y, err_m, err_v), ms=ms, plain_ms=plain,
               bound_ms=lo, bound_by=by, library_ms=lib, eager_ms=eager,
               on_chip=bool(plan['on_chip']))
    return fwd, _bn_bwd_case(torch, card, label, x, x3, layout, g, b, gen)


def _bn_bwd_case(torch, card, label, x, x3, layout, g, b, gen):
    """K5's backward kernel against batch_norm_reference_bwd on x (the
    forward's saved statistics, a gradient in x's layout), twice for equal
    bits, one launch a call, and its times beside F.batch_norm's autograd
    backward."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import batch_norm as K
    _, m, v = K._bn_cuda(x3, g, b, 1e-5)
    gy = torch.randn(x.shape, generator=gen, device=x.device).to(x.dtype)
    g4 = gy.permute(0, 3, 1, 2) if layout == 'NHWC' else gy
    g3 = g4.reshape(x3.shape) if x.dim() == 4 else gy.unsqueeze(-1)
    plan = K.launch_plan(x3, backward=True)
    before = (K.fused_batch_norm_train.bwd_launches,
              K.fused_batch_norm_train.bwd_gy_copies)
    got = K._bn_bwd_cuda(x3, g3, g, m, v, 1e-5)
    again = K._bn_bwd_cuda(x3, g3, g, m, v, 1e-5)
    torch.cuda.synchronize()
    require((K.fused_batch_norm_train.bwd_launches,
             K.fused_batch_norm_train.bwd_gy_copies) ==
            (before[0] + 2, before[1]),
            '%s backward: want 2 launches and no gradient copy for 2 calls'
            % label)
    require(all(torch.equal(a, r) for a, r in zip(got, again)),
            '%s backward: two runs differ' % label)
    del again
    want = K.batch_norm_reference_bwd(x3, g3, g, m, v, 1e-5)
    errs, ok = grads_ok(torch, got, want, x.dtype)
    del want, got
    n, c = x.numel(), g.shape[0]
    item = x.element_size()
    lo, by = bound_ms(3 * n * item + 5 * c * 4, 11 * n)
    bwd = lambda: K._bn_bwd_cuda(x3, g3, g, m, v, 1e-5)  # noqa: E731
    ms = device_ms(torch, bwd, iters=20)
    eager = eager_ms(torch, bwd, iters=20)
    plain = device_ms(torch, lambda: K.batch_norm_reference_bwd(
        x3, g3, g, m, v, 1e-5), iters=5)
    xl = x.permute(0, 3, 1, 2) if layout == 'NHWC' else x
    gl = gy.permute(0, 3, 1, 2) if layout == 'NHWC' else gy
    lib, node, lib_eager = grad_ms(
        torch, lambda a, w, c_: F.batch_norm(a, None, None, w, c_,
                                             training=True, eps=1e-5),
        (xl, g, b), gl, iters=20)
    print('%s backward: max_abs_err dx %.3g, dscale %.3g, dbias %.3g (%s) '
          '%s; one launch a call, x and gy %s, two runs bit-equal; device '
          'ms: kernel %.5f, plain %.5f, F.batch_norm backward %.5f (%s; '
          'eager %.5f), bound %.6f (%s); kernel eager %.5f ms [%s]'
          % (label, errs[0], errs[1], errs[2], GRAD_TOL,
             'ok' if ok else 'MISMATCH',
             'staged on chip (read once)' if plan['on_chip']
             else 'staged as far as they fit, the rest read twice', ms,
             plain, lib, node, lib_eager, lo, by, eager, card))
    require(ok, '%s backward disagrees with its plain version' % label)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=lo,
                bound_by=by, library_ms=lib, eager_ms=eager)


def bf16_ulp_t(torch, a):
    """One bf16 ulp (8 significant bits) at |a|, elementwise, float64."""
    a = a.double().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _bn_grad_check(torch, card, gen):
    """K5's autograd Function (the backward kernel) against autograd
    through the plain forward, fp32, at a stage-1 shape: 1e-4."""
    from paddle_tpu_torch.ops.kernels import batch_norm as K
    dev = torch.device('cuda', 0)
    x = torch.randn(16, 56, 56, 64, generator=gen, device=dev)
    s = 0.5 + torch.rand(64, generator=gen, device=dev)
    b = torch.randn(64, generator=gen, device=dev)
    gy = torch.randn(x.shape, generator=gen, device=dev)
    leaves = [t.clone().requires_grad_() for t in (x, s, b)]
    y, _, _ = K.fused_batch_norm_train(*leaves, 1e-5, layout='NHWC')
    got = torch.autograd.grad(y, leaves, gy)
    ref = [t.clone().requires_grad_() for t in (x, s, b)]
    ry, _, _ = K._bn_reference(ref[0].permute(0, 3, 1, 2).reshape(16, 64, -1),
                               ref[1], ref[2], 1e-5)
    want = torch.autograd.grad(ry, ref,
                               gy.permute(0, 3, 1, 2).reshape(16, 64, -1))
    errs = [float((a - w).abs().max()) for a, w in zip(got, want)]
    ok = all(bool(((a - w).abs() <= 1e-4 + 1e-4 * w.abs()).all())
             for a, w in zip(got, want))
    print('batch_norm backward [16, 56, 56, 64] fp32 NHWC vs autograd of the '
          'plain version: max_abs_err dx %.3g, dscale %.3g, dbias %.3g '
          '(1e-4 + 1e-4*|plain|) %s [%s]'
          % (errs[0], errs[1], errs[2], 'ok' if ok else 'MISMATCH', card))
    require(ok, 'batch_norm backward disagrees with autograd of the plain '
            'version')


def phase_bn_kernels(torch, card):
    """K5 at ResNet-50's shapes (batch 64, 224x224: the stem, stage 1's
    64-channel, stage 2's and stage 4's widest), NCHW, fp32 and an odd
    shape, each staged on chip or read twice as its plan says (checked:
    both happen in both orders), and the backward kernel at each; returns
    the stem's numbers (forward, backward)."""
    gen = torch.Generator(device='cuda').manual_seed(3)
    dev = torch.device('cuda', 0)
    res = []
    for label, shape, dtype, layout, on_chip in bn_shapes(torch):
        x = (1.0 + 2.0 * torch.randn(shape, generator=gen, device=dev)) \
            .to(dtype)
        res.append(_bn_case(torch, card, label, x, layout, gen))
        staged = res[-1][0].pop('on_chip')
        require(staged == on_chip, '%s: x staged on chip is %s, want %s'
                % (label, staged, on_chip))
        del x
        torch.cuda.empty_cache()
    _bn_grad_check(torch, card, gen)
    return res[0]


def bn_shapes(torch):
    """Phase 3's batch-norm cases: (label, shape, dtype, layout, x staged
    on chip). The first is the kernels line's."""
    return [
        ('batch_norm [802816, 64] bf16 NHWC (stem)', (64, 112, 112, 64),
         torch.bfloat16, 'NHWC', False),
        ('batch_norm [200704, 64] bf16 NHWC', (64, 56, 56, 64),
         torch.bfloat16, 'NHWC', True),
        ('batch_norm [50176, 512] bf16 NHWC', (64, 28, 28, 512),
         torch.bfloat16, 'NHWC', False),
        ('batch_norm [3136, 2048] bf16 NHWC', (64, 7, 7, 2048),
         torch.bfloat16, 'NHWC', True),
        ('batch_norm [64, 128, 28, 28] bf16 NCHW', (64, 128, 28, 28),
         torch.bfloat16, 'NCHW', True),
        ('batch_norm [64, 256, 56, 56] bf16 NCHW', (64, 256, 56, 56),
         torch.bfloat16, 'NCHW', False),
        ('batch_norm [200704, 256] fp32 NHWC', (64, 56, 56, 256),
         torch.float32, 'NHWC', False),
        ('batch_norm [1003, 100] fp32 (odd shape)', (1003, 100),
         torch.float32, 'NC', True),
    ]


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


def _decode_job(eng, spec, steps=20):
    """--profile job: a decode step with every batch slot busy (lengths
    from 300), run on this thread through the shut-down engine's decode
    program. Returns (label, step, steps, release)."""
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

    def release():
        for i in range(mb):
            eng.pool.free(tables[i, :need].tolist())
        require(eng.free_pages() == eng.num_blocks,
                'pages leaked after the decode profile')

    return ('%d decode steps x %d rows (lengths 300..%d)'
            % (steps, mb, 300 + 3 + 2 * steps), step, steps, release)


def _family(name):
    low = name.lower()
    if 'ptt::flash' in low:
        return 'flash attention (K2, K3)'
    if 'ptt::paged' in low:
        return 'paged attention (K4)'
    if 'ptt::ln_bwd' in low:
        return 'layer norm backward (K1 backward)'
    if 'ptt::ln_' in low:
        return 'layer norm (K1)'
    if 'ptt::bn_bwd' in low:
        return 'batch norm backward (K5 backward)'
    if 'ptt::bn_' in low:
        return 'batch norm (K5)'
    if any(w in low for w in ('fprop', 'dgrad', 'wgrad', 'conv', 'cudnn',
                              'implicit')):
        return 'convolution (cuDNN)'
    if any(w in low for w in ('gemm', 'xmma', 'nvjet', 'cutlass')):
        return 'matmul (cuBLAS)'
    if 'copy' in low or 'cast' in low:
        return 'copies and casts'
    return 'other elementwise / reductions'


# the executor's record_function ranges of a training step: on the device
# timeline each is one annotation span, which is not a kernel
SECTIONS = ('forward', 'optimizer')
# autograd nodes whose device time (their kernels') the profile reports
NODES = ('_BatchNormTrainBackward', '_LayerNormBackward')


def profile_steps(torch, card, jobs):
    """--profile: for each job (label, step, steps, release), the wall
    time a step without the profiler — every job's before any profiler
    starts, because CUPTI stays attached to the process afterwards and
    slows what follows — then, under torch.profiler, the device busy
    time and share, device time by kernel family and by kernel, and host
    time by op, a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for _, step, steps, _ in jobs:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / steps)
    for (label, step, steps, release), wall_ms in zip(jobs, walls):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
        kernels, host, families = {}, {}, {}
        spans, timed = {}, []
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            if e.name in SECTIONS:
                spans.setdefault(e.name, []).append(
                    (e.time_range.start, e.time_range.end))
                continue
            t = e.time_range.end - e.time_range.start
            timed.append((e.time_range.start, t))
            for table, key in ((kernels, e.name),
                               (families, _family(e.name))):
                c, total = table.get(key, (0, 0.0))
                table[key] = (c + 1, total + t)
        busy = sum(t for _, t in timed)
        # a kernel belongs to the section whose span holds its start; the
        # backward is what no span holds
        sections = {k: sum(t for s0, t in timed
                           if any(a <= s0 < b for a, b in spans[k]))
                    for k in SECTIONS if k in spans}
        if sections:
            sections['backward'] = busy - sum(sections.values())
        for a in prof.key_averages():
            if a.device_type == DeviceType.CPU and a.self_cpu_time_total > 0:
                host[a.key] = (a.count, a.self_cpu_time_total)
            if a.key in NODES:
                sections[a.key] = a.device_time_total
        busy_ms = busy / steps / 1e3
        launches = sum(c for k, (c, _) in host.items()
                       if k.startswith('cudaLaunchKernel'))
        copies = sum(c for k, (c, _) in kernels.items()
                     if 'direct_copy' in k)
        print('profile: %s: wall %.3f ms/step (no profiler), device busy '
              '%.3f ms/step, busy share %.3f; %.1f kernel launches/step, '
              '%.1f of them direct_copy [%s]'
              % (label, wall_ms, busy_ms, busy_ms / wall_ms,
                 launches / steps, copies / steps, card))
        if sections:
            print('  device time by section (us/step): %s'
                  % ', '.join('%s %.1f' % (k, t / steps)
                              for k, t in sections.items()))
        for title, table, n in (('family', families, 9),
                                ('device', kernels, 12)):
            for name, (c, t) in sorted(table.items(),
                                       key=lambda kv: -kv[1][1])[:n]:
                print('  %s %9.1f us/step %7.1f launches/step  %s'
                      % (title, t / steps, c / steps, name[:90]))
        for name, (c, t) in sorted(host.items(),
                                   key=lambda kv: -kv[1][1])[:12]:
            print('  host   %9.1f us/step %7.1f calls/step     %s'
                  % (t / steps, c / steps, name[:90]))
        if release is not None:
            release()


def phase_engine(torch, spec, engine_kw, reqs, place, card, on_card):
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
    reset_launches()
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
    require(eng.free_pages() == eng.num_blocks, 'pages leaked after rerun')
    return results, launches, eng


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


# ------------------------------------------------------- phases 6-8
def _build_train(pt, vocab, seq, dropout, amp, lr=1e-4, **dims):
    """bench_transformer's graph through the port's user API, on the
    default programs: transformer_base + Adam(lr).minimize, amp set on
    the main program."""
    from paddle_tpu_torch.models import transformer as T
    pt.reset_default_programs()
    avg_cost, _ = T.transformer_base(
        src_vocab_size=vocab, trg_vocab_size=vocab, src_seq_len=seq,
        trg_seq_len=seq, max_length=max(256, seq), dropout_rate=dropout,
        **dims)
    pt.optimizer.Adam(learning_rate=lr).minimize(avg_cost)
    pt.default_main_program().amp = amp
    return avg_cost


def _train_steps(torch, exe, feed, avg_cost, n, on_card):
    """n steps; returns (seconds, losses as floats)."""
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [exe.run(feed=feed, fetch_list=[avg_cost], return_numpy=False)[0]
           for _ in range(n)]
    if on_card:
        torch.cuda.synchronize()
    return time.perf_counter() - t0, [float(v.float()) for v in out]


def flash_want(layers, steps):
    """The flash kernels' launches in ``steps`` Transformer training steps:
    3 attentions a layer, each one forward and one of each backward kernel,
    all on their tensor-core variants."""
    n = 3 * layers * steps
    want = {}
    for name in VARIANTS:
        want.update({name: n, name + '_mma': n, name + '_simt': 0})
    return want


def phase_train(torch, pt, place, card, on_card, batch, seq, vocab, dims,
                warmup=3, steps=20):
    """Phase 6: bench_transformer through the port; returns the launch
    counts of the timed steps and a --profile job of 5 more steps."""
    from paddle_tpu_torch.models import transformer as T
    t0 = time.perf_counter()
    avg_cost = _build_train(pt, vocab, seq, 0.1, 'bf16', **dims)
    n_params = sum(int(np.prod(p.shape))
                   for p in pt.default_main_program().all_parameters())
    exe = pt.Executor(place)
    scope = pt.Scope()
    program = pt.default_main_program()
    with pt.scope_guard(scope):
        exe.run(pt.default_startup_program())
        feed = {n: torch.as_tensor(v).to(exe.device) for n, v in
                T.make_fake_batch(batch, seq, seq, vocab, vocab,
                                  seed=0).items()}
        base = 0
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        _, first = _train_steps(torch, exe, feed, avg_cost, warmup, on_card)
        reset_launches()
        secs, losses = _train_steps(torch, exe, feed, avg_cost, steps,
                                    on_card)
        launches = read_launches()

    def profile_step():
        with pt.scope_guard(scope):
            exe.run(program, feed=feed, fetch_list=[avg_cost],
                    return_numpy=False)

    losses = first + losses
    ms = secs * 1e3 / steps
    tok_s = batch * seq / secs * steps
    flops = T.train_step_flops(batch, seq, seq, vocab,
                               n_layer=dims.get('n_layer', 6),
                               n_head=dims.get('n_head', 8),
                               d_key=dims.get('d_key', 64),
                               d_model=dims.get('d_model', 512),
                               d_inner=dims.get('d_inner', 2048))
    layers = dims.get('n_layer', 6)
    want = flash_want(layers, steps)
    want['layer_norm'] = 5 * layers * steps
    want['layer_norm_bwd'] = 2 * 5 * layers * steps
    print('train: transformer_base vocab %d, %d params, batch %d x seq %d, '
          'amp bf16, dropout 0.1, Adam(1e-4); build + startup %.2f s; '
          'place %r' % (vocab, n_params, batch, seq, t1 - t0, place))
    print('train: %d timed steps after %d warm-up: %.3f ms/step, %.1f '
          'tokens/s, analytic %.4g TFLOP/step, MFU %.4f of %g TFLOP/s; loss '
          'first %.5f last %.5f [%s]'
          % (steps, warmup, ms, tok_s, flops / 1e12,
             flops / (ms / 1e3) / BF16_FLOPS, BF16_FLOPS / 1e12, losses[0],
             losses[-1], card))
    print('train: launches in the %d timed steps: %s (want %s: per layer '
          'and step, 3 of each flash kernel, every one through its '
          'tensor-core variant, 5 layer norms and their backward, 2 kernels '
          'each)' % (steps, {k: launches[k] for k in want}, want))
    require(np.isfinite(losses).all(), 'training loss not finite: %s'
            % losses)
    require(losses[-1] < losses[0], 'training loss did not fall: %s'
            % losses)
    if on_card:
        peak = torch.cuda.max_memory_allocated()
        print('train: max_memory_allocated %.3f GB, %.3f GB above what was '
              'allocated before the first step [%s]'
              % (peak / 1e9, (peak - base) / 1e9, card))
        require(all(launches[k] == n for k, n in want.items()),
                'training launch counts %s, want %s' % (launches, want))
    return launches, ('5 training steps', profile_step, 5, None)


def phase_train_masked(torch, pt, place, card, on_card, batch, seq, vocab,
                       dims, warmup=3, steps=10):
    """Phase 7: bench_transformer_masked's shape; returns the launch
    counts of the timed steps."""
    from paddle_tpu_torch.models import transformer as T
    avg_cost = _build_train(pt, vocab, seq, 0.1, 'bf16', **dims)
    rng = np.random.RandomState(0)
    feed = T.make_fake_batch(batch, seq, seq, vocab, vocab)
    lens = rng.randint(seq // 2, seq + 1, (batch,)).astype('int64')
    feed['src_length'] = lens
    feed['lbl_weight'] = (np.arange(seq)[None, :] <
                          lens[:, None]).astype('float32')
    exe = pt.Executor(place)
    with pt.scope_guard(pt.Scope()):
        exe.run(pt.default_startup_program())
        feed = {n: torch.as_tensor(v).to(exe.device) for n, v in feed.items()}
        _, first = _train_steps(torch, exe, feed, avg_cost, warmup, on_card)
        reset_launches()
        secs, losses = _train_steps(torch, exe, feed, avg_cost, steps,
                                    on_card)
        launches = read_launches()
    losses = first + losses
    print('train masked: batch %d x seq %d, src_length %d-%d (mean %.1f), '
          '%d timed steps: %.3f ms/step, padded %.1f tokens/s, real %.1f '
          'tokens/s; loss first %.5f last %.5f [%s]'
          % (batch, seq, lens.min(), lens.max(), lens.mean(), steps,
             secs * 1e3 / steps, batch * seq * steps / secs,
             float(lens.sum()) * steps / secs, losses[0], losses[-1], card))
    require(np.isfinite(losses).all(), 'masked loss not finite: %s' % losses)
    if on_card:
        layers = dims.get('n_layer', 6)
        want = flash_want(layers, steps)
        want['layer_norm'] = 5 * layers * steps
        want['layer_norm_bwd'] = 2 * 5 * layers * steps
        require(all(launches[k] == n for k, n in want.items()),
                'masked training launch counts %s, want %s'
                % (launches, want))
    return launches


def phase_train_compare(torch, pt, places, vocab, dims, lr=1e-4, steps=3):
    """Phase 8: the same Program, fp32, no dropout, no amp, 3 Adam steps
    from the same weights on each place."""
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.weights import load_into_scope
    t0 = time.perf_counter()
    avg_cost = _build_train(pt, vocab, 64, 0.0, None, lr=lr, **dims)
    main = pt.default_main_program()
    host = pt.Scope()
    with pt.scope_guard(host):
        pt.Executor(pt.CPUPlace()).run(pt.default_startup_program())
    weights = {n: host.numpy(n) for n in host.keys()}
    feed = T.make_fake_batch(2, 64, 64, vocab, vocab, seed=0)
    losses, scopes = [], []
    for place in places:
        scope = pt.Scope()
        load_into_scope(weights, scope, place)
        exe = pt.Executor(place)
        with pt.scope_guard(scope):
            losses.append([float(exe.run(main, feed=feed,
                                         fetch_list=[avg_cost])[0])
                           for _ in range(steps)])
        scopes.append(scope)
    names = [p.name for p in main.all_parameters() if p.trainable]
    gap = max(float(np.max(np.abs(scopes[0].numpy(n) - scopes[1].numpy(n))))
              for n in names)
    rel = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    print('train %r vs %r: batch 2 x seq 64, fp32, dropout 0, %d Adam steps '
          'from the same weights: losses %s vs %s (max rel %.3g, limit '
          '1e-4); max |param gap| %.3g over %d params (limit 2*lr*steps = '
          '%.3g) (%.1f s)'
          % (places[0], places[1], steps, ['%.6f' % v for v in losses[0]],
             ['%.6f' % v for v in losses[1]], rel, gap, len(names),
             2 * lr * steps, time.perf_counter() - t0))
    require(rel <= 1e-4, 'training losses differ across places')
    require(gap <= 2 * lr * steps, 'parameters differ across places')


# ------------------------------------------------------- phases 9-10
def _build_resnet(pt, image, class_dim, layout, amp, lr, small=False):
    """ResNet-50 (or, for the rehearsal, the tests' small bottleneck net)
    through the port's user API on the default programs:
    resnet50_with_loss + Momentum(lr, 0.9).minimize, amp on the main
    program."""
    from paddle_tpu_torch.models import resnet as R
    pt.reset_default_programs()
    if small:
        img = pt.layers.data(name='image', shape=[3, image, image],
                             dtype='float32')
        label = pt.layers.data(name='label', shape=[1], dtype='int64')
        h = pt.layers.transpose(img, [0, 2, 3, 1]) if layout == 'NHWC' \
            else img
        h = R.conv_bn_layer(h, 16, 3, 1, 1, data_format=layout)
        h = pt.layers.pool2d(h, pool_size=3, pool_type='max', pool_stride=2,
                             pool_padding=1, data_format=layout)
        h = R.layer_warp(R.bottleneck, h, 8, 2, 1, data_format=layout)
        h = R.layer_warp(R.bottleneck, h, 16, 2, 2, data_format=layout)
        h = pt.layers.pool2d(h, pool_type='avg', global_pooling=True,
                             data_format=layout)
        avg_cost = pt.layers.mean(pt.layers.cross_entropy(
            pt.layers.fc(h, size=class_dim, act='softmax'), label))
    else:
        _, avg_cost, _ = R.resnet50_with_loss(
            image_shape=(3, image, image), class_dim=class_dim,
            data_format=layout)
    pt.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(avg_cost)
    pt.default_main_program().amp = amp
    return avg_cost


def _running_stats(program):
    return [v.name for v in program.list_vars() if v.persistable and
            (v.name.endswith('.mean') or v.name.endswith('.variance'))]


def phase_resnet(torch, pt, place, card, on_card, batch, image, class_dim,
                 small=False, warmup=3, steps=20):
    """Phase 9: bench.py's bench_resnet50 through the port (batch 64,
    224x224, 1000 classes, NHWC, Momentum(0.1, 0.9), amp bf16); returns
    the launch counts of the timed steps and a --profile job of 5 more
    steps."""
    from paddle_tpu_torch.models import resnet as R
    t0 = time.perf_counter()
    avg_cost = _build_resnet(pt, image, class_dim, 'NHWC', 'bf16', 0.1,
                             small=small)
    program = pt.default_main_program()
    n_params = sum(int(np.prod(p.shape)) for p in program.all_parameters())
    n_bn = sum(op.type == 'batch_norm' for op in program.global_block().ops)
    flops = 3 * 2 * R.forward_macs_per_image(program) * batch
    stats = _running_stats(program)
    exe = pt.Executor(place)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe.run(pt.default_startup_program())
        before = {n: scope.numpy(n) for n in stats}
        feed = {n: torch.as_tensor(v).to(exe.device) for n, v in
                R.make_fake_batch(batch, image, class_dim, seed=0).items()}
        base = 0
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        _, first = _train_steps(torch, exe, feed, avg_cost, warmup, on_card)
        reset_launches()
        secs, losses = _train_steps(torch, exe, feed, avg_cost, steps,
                                    on_card)
        launches = read_launches()
        after = {n: scope.numpy(n) for n in stats}

    def profile_step():
        with pt.scope_guard(scope):
            exe.run(program, feed=feed, fetch_list=[avg_cost],
                    return_numpy=False)

    losses = first + losses
    ms = secs * 1e3 / steps
    moved = sum(not np.array_equal(before[n], after[n]) for n in stats)
    finite = all(np.isfinite(after[n]).all() for n in stats)
    print('resnet: %s, batch %d x 3 x %d x %d, %d classes, NHWC, amp bf16, '
          'Momentum(0.1, 0.9); %d params, %d batch norms; build + startup '
          '%.2f s; place %r; torch.backends.cudnn.benchmark=%s'
          % ('small bottleneck net' if small else 'ResNet-50', batch, image,
             image, class_dim, n_params, n_bn, t1 - t0, place,
             torch.backends.cudnn.benchmark))
    print('resnet: %d timed steps after %d warm-up: %.3f ms/step, %.1f '
          'images/s, %.4g TFLOP/step (conv + fc, 3x forward), MFU %.4f of %g '
          'TFLOP/s; loss first %.5f last %.5f; %d of %d running statistics '
          'moved, all finite: %s [%s]'
          % (steps, warmup, ms, batch * steps / secs, flops / 1e12,
             flops / (ms / 1e3) / BF16_FLOPS, BF16_FLOPS / 1e12, losses[0],
             losses[-1], moved, len(stats), finite, card))
    print('resnet: batch_norm launches in the %d timed steps: forward %d, '
          'backward %d (want %d each = %d a step); gradients copied into '
          'x\'s layout first: %d'
          % (steps, launches['batch_norm'], launches['batch_norm_bwd'],
             n_bn * steps, n_bn, launches['batch_norm_bwd_gy_copies']))
    require(np.isfinite(losses).all(), 'resnet loss not finite: %s' % losses)
    require(losses[-1] < losses[0], 'resnet loss did not fall: %s' % losses)
    require(finite and moved == len(stats),
            'running statistics: %d of %d moved, finite %s'
            % (moved, len(stats), finite))
    if on_card:
        peak = torch.cuda.max_memory_allocated()
        print('resnet: max_memory_allocated %.3f GB, %.3f GB above what was '
              'allocated before the first step [%s]'
              % (peak / 1e9, (peak - base) / 1e9, card))
        require(launches['batch_norm'] == n_bn * steps and
                launches['batch_norm_bwd'] == n_bn * steps,
                'resnet batch_norm launches %d forward, %d backward, want %d'
                % (launches['batch_norm'], launches['batch_norm_bwd'],
                   n_bn * steps))
    return launches, ('5 ResNet-50 training steps', profile_step, 5, None)


def phase_resnet_compare(torch, pt, places, lr=0.01, steps=3):
    """Phase 10: ResNet-50 at 32x32, batch 8, 10 classes, NCHW, fp32,
    Momentum(lr) for 3 steps from the same startup weights on each place.
    The first step is the one a tolerance can hold: its loss within 1e-3
    relative, the running statistics it leaves within 1e-3 of their
    largest entry, its gradient (the velocity after one step) within
    0.25 of its largest entry. Later steps are printed beside the host's
    own spread (the same steps on the host with the images scaled by
    1 + 2^-23): one training step of this net turns rounding into
    percent-level changes of the next loss."""
    from paddle_tpu_torch.models import resnet as R
    from paddle_tpu_torch.weights import load_into_scope
    t0 = time.perf_counter()
    avg_cost = _build_resnet(pt, 32, 10, 'NCHW', None, lr)
    main = pt.default_main_program()
    stats = _running_stats(main)
    params = [p.name for p in main.all_parameters()]
    host = pt.Scope()
    with pt.scope_guard(host):
        pt.Executor(pt.CPUPlace()).run(pt.default_startup_program())
    weights = {n: host.numpy(n) for n in host.keys()}
    feed = R.make_fake_batch(8, 32, 10, seed=0)
    nudged = dict(feed, image=feed['image'] * np.float32(1 + 2.0 ** -23))
    runs = []
    for place, f in ((places[0], feed), (places[1], feed),
                     (pt.CPUPlace(), nudged)):
        scope = pt.Scope()
        load_into_scope(weights, scope, place)
        exe = pt.Executor(place)
        losses, first = [], None
        with pt.scope_guard(scope):
            for _ in range(steps):
                losses.append(exe.run(main, feed=f,
                                      fetch_list=[avg_cost])[0].item())
                if first is None:
                    first = {n: scope.numpy(n) for n in
                             stats + [p + '_velocity_acc' for p in params]}
        runs.append((losses, first))
    (la, fa), (lb, fb), (lc, _) = runs

    def worst(names):
        return max(float(np.abs(fa[n] - fb[n]).max() /
                         max(np.abs(fb[n]).max(), 1e-30)) for n in names)

    rel = [abs(a - b) / abs(b) for a, b in zip(la, lb)]
    own = [abs(c - b) / abs(b) for b, c in zip(lb, lc)]
    stats_gap = worst(stats)
    grad_gap = worst([p + '_velocity_acc' for p in params])
    print('resnet %r vs %r: ResNet-50 32x32, batch 8, 10 classes, NCHW, '
          'fp32, Momentum(%g), %d steps from the same weights: losses %s vs '
          '%s; relative gaps %s (first step limit 1e-3); the host with its '
          'images scaled by 1 + 2^-23: %s; after the first step, running '
          'statistics within %.3g (limit 1e-3) and gradients within %.3g '
          '(limit 0.25) of their largest entry (%.1f s)'
          % (places[0], places[1], lr, steps, ['%.6f' % v for v in la],
             ['%.6f' % v for v in lb], ['%.3g' % v for v in rel],
             ['%.3g' % v for v in own], stats_gap, grad_gap,
             time.perf_counter() - t0))
    require(rel[0] <= 1e-3, 'resnet first-step losses differ across places')
    require(np.isfinite(la + lb).all(), 'resnet losses not finite')
    require(stats_gap <= 1e-3, 'running statistics differ across places')
    require(grad_gap <= 0.25, 'first-step gradients differ across places')


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--cpu-rehearsal', action='store_true',
                    help='run phases 4-10 on the host at tiny sizes with '
                         'the plain versions')
    ap.add_argument('--profile', action='store_true',
                    help='after every other phase, profile 20 decode '
                         'steps with every slot busy, 5 Transformer and 5 '
                         'ResNet-50 training steps (torch.profiler) and '
                         'print where the time goes')
    ap.add_argument('--kernels-only', action='store_true',
                    help='stop after phase 3 (kernels against their plain '
                         'versions, and their times); prints no verdict')
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
        results, _, _ = phase_engine(
            torch, spec, dict(max_batch=4, block_size=4, num_blocks=64,
                              pages_per_seq=4),
            reqs, pt.CPUPlace(), 'host CPU, rehearsal', False)
        phase_cpu_compare(spec, reqs, results, 4, 4)
        tiny = dict(n_layer=2, n_head=2, d_key=8, d_value=8, d_model=16,
                    d_inner=32)
        phase_train(torch, pt, pt.CPUPlace(), 'host CPU, rehearsal', False,
                    4, 8, 64, tiny, steps=6)
        phase_train_masked(torch, pt, pt.CPUPlace(), 'host CPU, rehearsal',
                           False, 4, 16, 64, tiny, steps=3)
        phase_train_compare(torch, pt, (pt.CPUPlace(), pt.CPUPlace()), 64,
                            tiny)
        phase_resnet(torch, pt, pt.CPUPlace(), 'host CPU, rehearsal', False,
                     8, 16, 10, small=True, steps=6)
        phase_resnet_compare(torch, pt, (pt.CPUPlace(), pt.CPUPlace()))
        print('cpu rehearsal ok in %.1f s' % (time.perf_counter() - t_start))
        return

    name, count, card = phase_device(torch)
    phase_build()
    ln, ln_bwd, pa = phase_kernels(torch, card)
    fa_fwd, fa_bwd = phase_flash_kernels(torch, card)
    bn, bn_bwd = phase_bn_kernels(torch, card)
    if args.kernels_only:
        print('kernels only: K1, K4, K2, K3 and K5 and the K1 and K5 '
              'backward kernels agree with their plain versions; no '
              'verdict. total %.1f s' % (time.perf_counter() - t_start))
        return
    spec = LMSpec(vocab_size=32000, n_layer=12, n_head=8, d_key=64,
                  d_value=64, d_model=512, d_inner=2048)
    reqs = _requests(spec, 32, 64, 512, 64)
    results, launches, eng = phase_engine(
        torch, spec, dict(max_batch=16, block_size=32, num_blocks=4096,
                          pages_per_seq=64),
        reqs, pt.CUDAPlace(0), card, True)
    phase_cpu_compare(spec, reqs, results, 32, 16)
    # the engine (and its 6.4 GB of arenas) stays only for --profile
    decode_job = _decode_job(eng, spec) if args.profile else None
    del eng
    torch.cuda.empty_cache()
    base = dict(n_layer=6, n_head=8, d_key=64, d_value=64, d_model=512,
                d_inner=2048)
    train, train_job = phase_train(torch, pt, pt.CUDAPlace(0), card, True,
                                   64, 64, VOCAB, base)
    torch.cuda.empty_cache()
    masked = phase_train_masked(torch, pt, pt.CUDAPlace(0), card, True, 8,
                                512, VOCAB, base)
    torch.cuda.empty_cache()
    phase_train_compare(torch, pt, (pt.CUDAPlace(0), pt.CPUPlace()), VOCAB,
                        base)
    torch.cuda.empty_cache()
    resnet, resnet_job = phase_resnet(torch, pt, pt.CUDAPlace(0), card, True,
                                      64, 224, 1000)
    torch.cuda.empty_cache()
    phase_resnet_compare(torch, pt, (pt.CUDAPlace(0), pt.CPUPlace()))
    if args.profile:
        profile_steps(torch, card, [decode_job, train_job, resnet_job])

    # launches: the sum over the main paths' runs (the engine run, the
    # timed Transformer, masked Transformer and ResNet-50 training steps),
    # each read after its counts were set to 0
    def runs(key):
        return sum(r.get(key, 0) for r in (launches, train, masked, resnet))

    kernels = [
        dict(name='layer_norm', route='cuda',
             source='paddle_tpu_torch/csrc/layer_norm.cu',
             replaces='paddle_tpu/ops/pallas/layer_norm.py:23',
             launches=runs('layer_norm'), **ln),
        dict(name='layer_norm_bwd', route='cuda',
             source='paddle_tpu_torch/csrc/layer_norm.cu',
             replaces='paddle_tpu/ops/pallas/layer_norm.py:91',
             launches=runs('layer_norm_bwd'), **ln_bwd),
        dict(name='paged_attention', route='cuda',
             source='paddle_tpu_torch/csrc/paged_attention.cu',
             replaces='paddle_tpu/ops/pallas/paged_attention.py:86',
             launches=runs('paged_attention'), **pa),
        dict(name='flash_attention_fwd', route='cuda',
             source='paddle_tpu_torch/csrc/flash_attention.cu',
             replaces='paddle_tpu/ops/pallas/flash_attention.py:141',
             launches=runs('flash_attention_fwd'), **fa_fwd),
        dict(name='flash_attention_bwd', route='cuda',
             source='paddle_tpu_torch/csrc/flash_attention.cu',
             replaces='paddle_tpu/ops/pallas/flash_attention.py:278',
             launches=min(runs('flash_attention_bwd_dkv'),
                          runs('flash_attention_bwd_dq')), **fa_bwd),
        dict(name='batch_norm', route='cuda',
             source='paddle_tpu_torch/csrc/batch_norm.cu',
             replaces='paddle_tpu/ops/pallas/batch_norm.py:52',
             launches=runs('batch_norm'), **bn),
        dict(name='batch_norm_bwd', route='cuda',
             source='paddle_tpu_torch/csrc/batch_norm.cu',
             replaces='paddle_tpu/ops/pallas/batch_norm.py:159',
             launches=runs('batch_norm_bwd'), **bn_bwd),
    ]
    print('total %.1f s' % (time.perf_counter() - t_start))
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': name,
                                             'count': count}}))


if __name__ == '__main__':
    main()
