"""Counter-based random bits for the per-step noise of a step: the dropout
keep mask (the CUDA kernel of ``csrc/random_bits.cu``, replacing the
``jax.random.bernoulli`` draw of paddle_tpu/ops/nn_ops.py ``_dropout``,
which has no Pallas kernel) beside its plain PyTorch version, and the
Gumbel noise of decode sampling (plain PyTorch on every device).

Every bit is a pure function of a 32-bit key and the element's index,
through ``core.registry.mix32``: element i of an op's mask keeps where
``mix32(i ^ mix32(key ^ step)) < keep * 2^32``, with ``key =
op_key(program seed, op index)`` and ``step`` a 0-dim int64 tensor on the
device. The step is read on the device, never on the host, so a CUDA graph
that captured the op draws a new mask at each replay: the mask of step s
is the same in an eager run, a captured one and ``run_steps``.

``keep_mask`` launches the kernel for a CUDA device and takes the plain
version only for the CPU; on a CUDA device it launches or raises.
``keep_mask.launches`` counts kernel launches.
"""

import ctypes

import torch

from ...core.registry import MASK32, mix32
from . import build

# the mask dtypes the kernel writes (bool as one byte 0 / 1)
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.bool: 2}


def keep_threshold(keep):
    """The uint32 threshold of keep probability ``keep``: an element is
    kept where its 32 random bits lie below it (2^32 keeps every one)."""
    return min(max(int(float(keep) * 4294967296.0), 0), 1 << 32)


def keep_mask_reference(shape, keep, key, step, device, dtype=torch.bool):
    """Plain version: the keep mask of ``shape`` in ``dtype`` (1 kept, 0
    dropped), computed with int64 tensor ops on ``device``."""
    n = 1
    for s in shape:
        n *= int(s)
    h = mix32((step.to(device=device, dtype=torch.int64) & MASK32) ^
              (int(key) & MASK32))
    i = torch.arange(n, dtype=torch.int64, device=device) & MASK32
    u = mix32(i ^ h)
    return (u < keep_threshold(keep)).reshape(tuple(shape)).to(dtype)


def _keep_mask_cuda(shape, keep, key, step, device, dtype):
    if dtype not in _CODES:
        raise TypeError('keep_mask kernel: writes float32, bfloat16 or bool, '
                        'got %s' % dtype)
    if step.dtype != torch.int64 or step.numel() != 1 or \
            step.device != device:
        raise ValueError('keep_mask kernel: step must be one int64 element '
                         'on %s, got %s on %s' % (device, step.dtype,
                                                  step.device))
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    n = out.numel()
    if n == 0:
        return out
    lib = build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.ptt_keep_mask(out.data_ptr(), n, _CODES[dtype],
                               ctypes.c_uint(int(key) & MASK32),
                               step.data_ptr(), keep_threshold(keep), stream)
    build.check(rc, 'ptt_keep_mask')
    keep_mask.launches += 1
    return out


def keep_mask(shape, keep, key, step, device, dtype=torch.bool):
    """The keep mask of ``shape`` with keep probability ``keep`` for the
    op key ``key`` at ``step`` (0-dim int64 tensor on ``device``)."""
    if device.type == 'cpu':
        return keep_mask_reference(shape, keep, key, step, device, dtype)
    return _keep_mask_cuda(shape, keep, key, step, device, dtype)


keep_mask.launches = 0


def uniform24(bits):
    """Uniform floats in (0, 1) from 32-bit values: the top 24 bits plus
    half a step, exact in fp32 (never 0, never 1)."""
    return ((bits >> 8).float() + 0.5) * (2.0 ** -24)


def gumbel_noise(seeds, positions, vocab):
    """[N, vocab] fp32 Gumbel noise -log(E), E = -log(U) ~ Exp(1), with U
    from the bits of (seed, position, vocab index) of each row: a row's
    noise depends on its own seed and position only, never on the batch.
    ``seeds`` and ``positions`` are [N] integer tensors on the device."""
    row = mix32(mix32(seeds.to(torch.int64).reshape(-1, 1) & MASK32) ^
                (positions.to(torch.int64).reshape(-1, 1) & MASK32))
    cols = torch.arange(vocab, dtype=torch.int64, device=seeds.device)
    u = uniform24(mix32(cols[None, :] ^ row))
    return -torch.log(-torch.log(u))
