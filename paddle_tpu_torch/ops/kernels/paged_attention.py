"""Ragged paged attention: the CUDA kernel ``csrc/paged_attention.cu`` (K4,
replacing ``_paged_kernel`` of paddle_tpu/ops/pallas/paged_attention.py)
and its plain PyTorch version ``paged_attention_reference``.

Layouts (the JAX package's):
    q            [B, H, D]      one query token per row, float32
    k/v_pages    [NB, H, bs, D] the pooled page arena of one layer
    block_tables [B, P] int32   physical page ids; >= NB means "no page"
    seq_lens     [B]  int32     live tokens (this token included)

``paged_attention`` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors; on a CUDA tensor it launches or
raises. ``paged_attention.launches`` counts kernel launches.
"""

import torch

from . import build

_NEG_INF = -1e9
_MAX_SMEM = 48 * 1024


def paged_attention_reference(q, k_pages, v_pages, block_tables, seq_lens,
                              sm_scale=None):
    """Plain version, a straight translation of the reference's gather
    path: gather each row's pages through its (clipped) table into
    [B, H, P*bs, D], mask columns >= seq_len with -1e9, fp32 softmax, and
    the weights rounded to the page dtype before w.v. Returns [B, H, Dv]
    in the page dtype. (A row with seq_len 0 averages every gathered
    column here, where the kernel returns 0; the decode ops never ask for
    length 0.)"""
    nb, h, bs, d = k_pages.shape
    b, p = block_tables.shape
    scale = sm_scale if sm_scale is not None else d ** -0.5
    tables = block_tables.long().clamp(0, nb - 1)
    # [B, P, H, bs, D] -> [B, H, P*bs, D]
    k = k_pages[tables].permute(0, 2, 1, 3, 4).reshape(b, h, p * bs, d)
    v = v_pages[tables].permute(0, 2, 1, 3, 4) \
        .reshape(b, h, p * bs, v_pages.shape[-1])
    qs = q * scale
    ct = torch.promote_types(qs.dtype, k.dtype)
    logits = torch.einsum('bhd,bhkd->bhk', qs.to(ct), k.to(ct))
    mask = torch.arange(p * bs, device=q.device)[None, :] < \
        seq_lens.reshape(-1, 1)
    logits = torch.where(mask[:, None, :], logits,
                         torch.full((), _NEG_INF, dtype=logits.dtype,
                                    device=q.device))
    w = torch.softmax(logits.float(), dim=-1)
    return torch.einsum('bhk,bhkd->bhd', w.to(v.dtype), v)


def _paged_cuda(q, k_pages, v_pages, block_tables, seq_lens, scale):
    nb, h, bs, d = k_pages.shape
    dv = v_pages.shape[-1]
    n, p = block_tables.shape
    dev = q.device
    if q.dtype != torch.float32 or tuple(q.shape) != (n, h, d) or \
            not q.is_contiguous():
        raise ValueError('paged_attention kernel: q must be a contiguous '
                         'float32 [%d, %d, %d] tensor, got %s %s'
                         % (n, h, d, q.dtype, tuple(q.shape)))
    if k_pages.dtype != v_pages.dtype or \
            tuple(v_pages.shape[:3]) != (nb, h, bs) or \
            not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError('paged_attention kernel: k/v pages must be '
                         'contiguous [NB, H, bs, D] of one dtype')
    if block_tables.dtype != torch.int32 or block_tables.stride(1) != 1:
        raise ValueError('paged_attention kernel: block_tables must be '
                         'int32 with unit column stride')
    if seq_lens.dtype != torch.int32 or tuple(seq_lens.shape) != (n,) or \
            not seq_lens.is_contiguous():
        raise ValueError('paged_attention kernel: seq_lens must be a '
                         'contiguous int32 [%d] tensor' % n)
    for t in (k_pages, v_pages, block_tables, seq_lens):
        if t.device != dev:
            raise ValueError('paged_attention kernel: all inputs must be '
                             'on %s, got %s' % (dev, t.device))
    if bs > 128 or dv > 128 or n > 65535:
        raise ValueError('paged_attention kernel: needs block size <= 128, '
                         'value head dim <= 128 and <= 65535 rows')
    lib = build.library()
    if lib.ptt_paged_attention_smem_bytes(bs, d, dv) > _MAX_SMEM:
        raise ValueError('paged_attention kernel: a %d x %d page tile does '
                         'not fit the 48 KB of shared memory' % (bs, d))
    out = torch.empty((n, h, dv), dtype=torch.float32, device=dev)
    if n == 0 or h == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ptt_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), block_tables.stride(0),
            seq_lens.data_ptr(), out.data_ptr(), n, h, nb, bs, d, dv, p,
            float(scale), build.dtype_code(k_pages.dtype), stream)
    build.check(rc, 'ptt_paged_attention')
    paged_attention.launches += 1
    return out


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens,
                    sm_scale=None):
    """Ragged paged attention: one query per row against its paged KV
    cache. q [B, H, D]; pages [NB, H, bs, D*]; block_tables [B, P] int32
    (entries >= NB mean "no page" and are never read; a broadcast table
    with row stride 0 is taken as it is); seq_lens [B] int32. Returns
    [B, H, Dv]: float32 from the kernel, the page dtype from the plain
    version."""
    d = k_pages.shape[-1]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    if q.device.type == 'cpu':
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                         seq_lens, sm_scale=scale)
    return _paged_cuda(q, k_pages, v_pages, block_tables, seq_lens, scale)


paged_attention.launches = 0
