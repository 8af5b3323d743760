"""Counter-based random bits for the per-step noise of a step: dropout
and its keep mask (the CUDA kernels of ``csrc/random_bits.cu``, replacing
the ``jax.random.bernoulli`` draw of paddle_tpu/ops/nn_ops.py ``_dropout``
and the products around it, which have no Pallas kernel) beside their
plain PyTorch versions, and the Gumbel noise of decode sampling (plain
PyTorch on every device).

Every bit is a pure function of a 32-bit key and the element's index,
through ``core.registry.mix32``: element i of a dropout site keeps where
``mix32(i ^ mix32(key ^ step)) < keep * 2^32``, with ``key =
op_key(program seed, op index)`` and ``step`` a 0-dim int64 tensor on the
device. The step is read on the device, never on the host, so a CUDA graph
that captured the op draws new bits at each replay: the bits of step s are
the same in an eager run, a captured one and ``run_steps``.

``DropoutApply`` is dropout on a training step: one fused pass that draws
the bits in registers and applies them (``fused_dropout``), whose backward
draws the same bits again from the saved step tensor. No mask is written,
and autograd holds no tensor of x's size for it. ``keep_mask`` writes the
mask itself, for a program that reads it (the dropout op's ``Mask``).

Both wrappers launch their kernel for a CUDA tensor and take the plain
version only for a CPU one; on a CUDA tensor they launch or raise.
``keep_mask.launches``, ``fused_dropout.launches`` and
``fused_dropout.bwd_launches`` count kernel launches.
"""

import ctypes

import numpy as np
import torch

from ...core.registry import MASK32, mix32
from . import build

# the mask dtypes the kernel writes (bool as one byte 0 / 1)
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.bool: 2}


def keep_threshold(keep):
    """The uint32 threshold of keep probability ``keep``: an element is
    kept where its 32 random bits lie below it (2^32 keeps every one)."""
    return min(max(int(float(keep) * 4294967296.0), 0), 1 << 32)


def keep_bits_reference(shape, keep, key, step, device):
    """Plain version of the bits: True where an element of ``shape`` is
    kept, computed with int64 tensor ops on ``device``."""
    n = 1
    for s in shape:
        n *= int(s)
    h = mix32((step.to(device=device, dtype=torch.int64) & MASK32) ^
              (int(key) & MASK32))
    i = torch.arange(n, dtype=torch.int64, device=device) & MASK32
    u = mix32(i ^ h)
    return (u < keep_threshold(keep)).reshape(tuple(shape))


def keep_mask_reference(shape, keep, key, step, device, dtype=torch.bool):
    """Plain version: the keep mask of ``shape`` in ``dtype`` (1 kept, 0
    dropped)."""
    return keep_bits_reference(shape, keep, key, step, device).to(dtype)


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


# the dropout modes: (mode, backward) -> the kernel's op (csrc/random_bits.cu)
_OPS = {('mul', False): 0, ('mul', True): 0, ('mul_div', False): 1,
        ('mul_div', True): 2, ('where_div', False): 3, ('where_div', True): 3}
MODES = ('mul', 'mul_div', 'where_div')


def dropout_reference(x, mode, keep, key, step, backward=False):
    """Plain version of ``fused_dropout``: the torch expression of
    ``mode`` over the keep bits ``m`` of (``key``, ``step``), ``keep`` a
    Python float. Forward (and, ``backward``, the gradient of x from
    ``x`` = dy, in autograd's order):
    'mul' (downgrade_in_infer): x * m, dy * m;
    'mul_div' (upscale_in_train): (x * m) / keep, (dy / keep) * m;
    'where_div' (the attention output): where(m, x / keep, +0), the same
    on dy."""
    m = keep_bits_reference(x.shape, keep, key, step, x.device)
    if mode == 'where_div':
        return torch.where(m, x / keep, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))
    m = m.to(x.dtype)
    if mode == 'mul':
        return x * m
    if mode == 'mul_div':
        return (x / keep) * m if backward else (x * m) / keep
    raise ValueError('dropout: mode must be one of %s, got %r'
                     % (MODES, mode))


def _dropout_cuda(x, mode, keep, key, step, backward):
    if (mode, backward) not in _OPS:
        raise ValueError('dropout kernel: mode must be one of %s, got %r'
                         % (MODES, mode))
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            not x.is_contiguous():
        raise TypeError('dropout kernel: takes contiguous float32 or '
                        'bfloat16, got %s (contiguous %s)'
                        % (x.dtype, x.is_contiguous()))
    if step.dtype != torch.int64 or step.numel() != 1 or \
            step.device != x.device:
        raise ValueError('dropout kernel: step must be one int64 element '
                         'on %s, got %s on %s' % (x.device, step.dtype,
                                                  step.device))
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    n = y.numel()
    if n == 0:
        return y
    # torch divides by a Python scalar on the card as a product with its
    # fp32 reciprocal; the kernel multiplies by the same one
    with np.errstate(divide='ignore'):
        inv = float(np.float32(1.0) / np.float32(keep))
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ptt_dropout(x.data_ptr(), y.data_ptr(), n,
                             build.dtype_code(x.dtype), _OPS[mode, backward],
                             ctypes.c_uint(int(key) & MASK32),
                             step.data_ptr(), keep_threshold(keep), inv,
                             stream)
    build.check(rc, 'ptt_dropout')
    if backward:
        fused_dropout.bwd_launches += 1
    else:
        fused_dropout.launches += 1
    return y


def fused_dropout(x, mode, keep, key, step, backward=False):
    """Dropout of ``x`` in one pass, its keep bits (keep probability
    ``keep``, op key ``key``, ``step`` a 0-dim int64 tensor on x's device)
    drawn in registers: the forward of ``mode`` (see dropout_reference),
    or with ``backward`` the gradient of x from ``x`` = dy. Returns a new
    tensor; no mask is written."""
    if x.device.type == 'cpu':
        return dropout_reference(x, mode, keep, key, step, backward)
    return _dropout_cuda(x, mode, keep, key, step, backward)


fused_dropout.launches = 0
fused_dropout.bwd_launches = 0


class DropoutApply(torch.autograd.Function):
    """Differentiable dropout on a training step: ``DropoutApply.apply(x,
    mode, keep, key, step)`` is fused_dropout(x, ...), and the backward
    launches the same kernel on dy, drawing the forward's bits again from
    the step tensor it saved (the executor advances the step only after
    the backward). It saves the step and the scalars, and no tensor of
    x's size."""

    @staticmethod
    def forward(ctx, x, mode, keep, key, step):
        ctx.save_for_backward(step)
        ctx.mode, ctx.keep, ctx.key = mode, keep, key
        return fused_dropout(x.contiguous(), mode, keep, key, step)

    @staticmethod
    def backward(ctx, dy):
        step, = ctx.saved_tensors
        return (fused_dropout(dy.contiguous(), ctx.mode, ctx.keep, ctx.key,
                              step, backward=True), None, None, None, None)


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
