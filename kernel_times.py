#!/usr/bin/env python3
"""Device times of the layer norm (K1) and its backward, paged attention
(K4), the flash-attention forward (K2) and backward (K3) and the training
batch norm (K5) and its backward of one checkout of this repository, at
chip_smoke.py's phase-3 shapes, and SDPA's backward beside K3 (the same
inputs and mask, whatever the checkout). A kernel the checkout does not
have (a backward kernel before it was written) is reported as such.

    python3 kernel_times.py [DIR]    # on a machine with one CUDA card

DIR (default: this checkout) holds the ``paddle_tpu_torch`` package to
time; the shapes, the inputs and the timer (CUDA-graph replay, CUDA events)
are this checkout's chip_smoke.py's. To compare two commits, unpack the
earlier one (``git archive <commit> | tar -x -C DIR``) and run both back to
back on the same card, each twice: earlier, this, this, earlier.

Nothing is checked here: chip_smoke.py holds each kernel against its plain
versions. Prints one line a case, then nvidia-smi's name and power limit,
then one JSON object {"port": DIR, "card": ..., "ms": {case: ms}}.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))


def main():
    port = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else REPO
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
