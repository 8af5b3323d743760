"""The KV write of the paged decode ops: the CUDA kernel of
``csrc/kv_write.cu`` beside its plain PyTorch version
``kv_write_reference``.

One call writes one layer's new K and V rows ([N, H, D] and [N, H, Dv])
into the page arenas ([NB, H, bs, D*]) at (phys[i], :, off[i]) for every
row i whose ``keep`` bit is set, and drops the others: the reference's
``.at[...].set(new, mode='drop')`` (paddle_tpu/ops/paged_decode_ops.py
``_write_positions`` / ``_write_scales``). On int8 and float8_e4m3fn
arenas each written (token, head) row is quantized on its own, bit for bit
as ``quant.core.quantize_rows``, and its fp32 scale written beside it.

``kv_write`` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors; on a CUDA tensor it launches or raises. The
kernel never reads on the host which rows write, so a CUDA graph can hold
it; the plain version chooses the rows with ``torch.nonzero``.
``kv_write.launches`` counts kernel launches.
"""

import torch

from ...quant.core import kv_quantized, quantize_rows
from . import build


def _as_bytes(arena):
    """One-byte arenas are written through a uint8 view (the same bits)."""
    return arena.view(torch.uint8) if arena.element_size() == 1 else arena


def kv_write_reference(k_new, v_new, k_arena, v_arena, phys, off, keep,
                       k_scales=None, v_scales=None):
    """Plain version: quantize_rows (quantized arenas) and a scatter of the
    kept rows, in place."""
    rows = torch.nonzero(keep)[:, 0]
    w_phys = phys[rows].long()
    w_off = off[rows].long()
    kv_q = str(k_arena.dtype)[6:]
    if kv_quantized(kv_q):
        for arena, scales, new in ((k_arena, k_scales, k_new),
                                   (v_arena, v_scales, v_new)):
            q8, s8 = quantize_rows(new[rows], kv_q)
            _as_bytes(arena)[w_phys, :, w_off] = _as_bytes(q8)
            scales[w_phys, :, w_off] = s8
    else:
        k_arena[w_phys, :, w_off] = k_new[rows].to(k_arena.dtype)
        v_arena[w_phys, :, w_off] = v_new[rows].to(v_arena.dtype)


def _kv_write_cuda(k_new, v_new, k_arena, v_arena, phys, off, keep,
                   k_scales, v_scales):
    nb, h, bs, d = k_arena.shape
    dv = v_arena.shape[-1]
    n = keep.shape[0]
    dev = k_arena.device
    if tuple(k_new.shape) != (n, h, d) or tuple(v_new.shape) != (n, h, dv) \
            or k_new.dtype != v_new.dtype or not k_new.is_contiguous() or \
            not v_new.is_contiguous():
        raise ValueError('kv_write kernel: new rows must be contiguous '
                         '[%d, %d, %d] and [%d, %d, %d] of one dtype, got '
                         '%s %s' % (n, h, d, n, h, dv, tuple(k_new.shape),
                                    tuple(v_new.shape)))
    if k_arena.dtype != v_arena.dtype or \
            tuple(v_arena.shape[:3]) != (nb, h, bs) or \
            not (k_arena.is_contiguous() and v_arena.is_contiguous()):
        raise ValueError('kv_write kernel: arenas must be contiguous '
                         '[NB, H, bs, D] of one dtype')
    for t, dt in ((phys, torch.int32), (off, torch.int32),
                  (keep, torch.bool)):
        if t.dtype != dt or tuple(t.shape) != (n,) or not t.is_contiguous():
            raise ValueError('kv_write kernel: phys, off and keep must be '
                             'contiguous [%d] int32, int32 and bool' % n)
    quantized = kv_quantized(str(k_arena.dtype)[6:])
    scales = (k_scales, v_scales) if quantized else ()
    if quantized != (k_scales is not None) or \
            (k_scales is None) != (v_scales is None):
        raise ValueError('kv_write kernel: int8 and float8_e4m3fn arenas '
                         'take k_scales and v_scales, others none')
    for t in scales:
        if t.dtype != torch.float32 or tuple(t.shape) != (nb, h, bs) or \
                not t.is_contiguous():
            raise ValueError('kv_write kernel: scales must be contiguous '
                             'float32 [%d, %d, %d]' % (nb, h, bs))
    for t in (k_new, v_new, v_arena, phys, off, keep) + scales:
        if t.device != dev:
            raise ValueError('kv_write kernel: all inputs must be on %s, '
                             'got %s' % (dev, t.device))
    if n == 0:
        return
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ptt_kv_write(
            k_new.data_ptr(), v_new.data_ptr(), build.dtype_code(k_new.dtype),
            k_arena.data_ptr(), v_arena.data_ptr(),
            k_scales.data_ptr() if quantized else None,
            v_scales.data_ptr() if quantized else None,
            build.dtype_code(k_arena.dtype, quantized=True), phys.data_ptr(),
            off.data_ptr(), keep.data_ptr(), n, h, bs, d, dv, stream)
    build.check(rc, 'ptt_kv_write')
    kv_write.launches += 1


def kv_write(k_new, v_new, k_arena, v_arena, phys, off, keep, k_scales=None,
             v_scales=None):
    """Write the kept rows of ``k_new`` [N, H, D] and ``v_new`` [N, H, Dv]
    into ``k_arena`` [NB, H, bs, D] and ``v_arena`` at (phys, :, off), in
    place; ``phys``, ``off`` [N] int32 and ``keep`` [N] bool; int8 and
    float8_e4m3fn arenas come with their fp32 ``k_scales``/``v_scales``
    [NB, H, bs]."""
    if k_arena.device.type == 'cpu':
        kv_write_reference(k_new, v_new, k_arena, v_arena, phys, off, keep,
                           k_scales, v_scales)
        return
    _kv_write_cuda(k_new, v_new, k_arena, v_arena, phys, off, keep,
                   k_scales, v_scales)


kv_write.launches = 0
