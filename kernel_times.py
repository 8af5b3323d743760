#!/usr/bin/env python3
"""Device times of paged attention (K4) and the flash-attention forward (K2)
of one checkout of this repository, at chip_smoke.py's phase-3 shapes.

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
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
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
        q, k, v = (torch.randn(b, h, t, d, generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
        kv = None if lens is None else torch.tensor(lens, device=dev)
        ms[label] = smoke.device_ms(
            torch, lambda: fa.flash_attention_fwd(q, k, v, kv, causal),
            iters=50)
        print('%s: forward kernel %.5f ms [%s]' % (label, ms[label], card))
        del q, k, v
        torch.cuda.empty_cache()

    print(card)
    print(json.dumps({'port': port, 'card': card, 'ms': ms}))


if __name__ == '__main__':
    main()
