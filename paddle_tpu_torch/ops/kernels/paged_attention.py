"""Ragged paged attention: the CUDA kernels of ``csrc/paged_attention.cu``
(K4, replacing ``_paged_kernel`` of
paddle_tpu/ops/pallas/paged_attention.py) and their plain PyTorch versions
``paged_attention_reference`` and ``paged_attention_split_reference``.

Layouts (the JAX package's):
    q            [B, H, D]      one query token per row, float32
    k/v_pages    [NB, H, bs, D] the pooled page arena of one layer
    block_tables [B, P] int32   physical page ids; >= NB means "no page"
    seq_lens     [B]  int32     live tokens (this token included)

The kernel splits a row over blocks: each takes a fixed chunk of
``CHUNK_TOKENS`` tokens and leaves a partial (acc, m, l) in a workspace
that a merge kernel combines in split order. The chunk is a constant, so a
row's result is a pure function of its q, pages and length, whatever batch
it is part of.

The split kernel comes in two hand-written variants: one with 16-byte
loads (key and value rows that are multiples of 16 bytes, at most 512
bytes, Dv <= 128, 16-byte aligned arenas: the decode path) and one for
rows of any width up to 256 elements (a bf16 arena with d_key 36, an fp32
one with d_key 30, Dv 192), with the widest load (8, 4 or 2 bytes) that
divides the rows. The launcher chooses and reports which it launched.

``paged_attention`` launches the kernels for CUDA tensors and takes the
plain version only for CPU tensors; on a CUDA tensor it launches or
raises. ``paged_attention.launches`` counts calls that launched,
``launches_v16`` and ``launches_any`` each variant.
"""

import ctypes

import torch

from . import build

_NEG_INF = -1e9
# tokens one split block of the kernel covers (kChunkTokens of the source)
CHUNK_TOKENS = 256
# the widest key or value row (elements) a kernel takes (kMaxAnyDim)
MAX_HEAD_DIM = 256
_LAUNCHED_V16, _LAUNCHED_ANY = 1, 2


def chunk_pages(block_size):
    """Pages of one split chunk at this block size (at least one)."""
    return max(1, CHUNK_TOKENS // block_size)


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


def paged_attention_split_reference(q, k_pages, v_pages, block_tables,
                                    seq_lens, sm_scale=None):
    """Plain version in the kernel's order of operations, for tests and
    the chip smoke: each chunk of ``chunk_pages(bs)`` pages gives a partial
    (m, l, acc) in fp32 (scale applied to q, masked columns at -1e9 with
    p = 0, p rounded to the page dtype before p.v); the partials of the
    chunks that start below ceil(len / bs) pages are combined in split
    order and divided by l (1 where l is 0: a row with no live chunk gives
    0). Dot products are elementwise products summed per row, so a row's
    bits do not depend on the rows around it. Returns [B, H, Dv] fp32."""
    nb, h, bs, d = k_pages.shape
    dv = v_pages.shape[-1]
    b, p = block_tables.shape
    scale = sm_scale if sm_scale is not None else d ** -0.5
    cp = chunk_pages(bs)
    nz = -(-p // cp)
    ct = cp * bs
    tables = block_tables.long().clamp(0, nb - 1)
    if nz * cp > p:          # pad the table to whole chunks (never live)
        pad = tables.new_zeros(b, nz * cp - p)
        tables = torch.cat([tables, pad], dim=1)
    # [B, Z*cp, H, bs, D] -> [B, H, Z, ct, D]
    k = k_pages[tables].permute(0, 2, 1, 3, 4).reshape(b, h, nz, ct, d)
    v = v_pages[tables].permute(0, 2, 1, 3, 4).reshape(b, h, nz, ct, dv)
    lens = seq_lens.reshape(b, 1, 1, 1).long().clamp(max=p * bs)
    qs = (q.float() * scale)[:, :, None, None, :]
    s = (qs * k.float()).sum(dim=-1)                      # [B, H, Z, ct]
    pos = torch.arange(nz * ct, device=q.device).reshape(1, 1, nz, ct)
    live = pos < lens
    neg = torch.full((), _NEG_INF, dtype=torch.float32, device=q.device)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    s = torch.where(live, s, neg)
    m = s.amax(dim=-1)                                    # [B, H, Z]
    pr = torch.where(live, torch.exp(s - m[..., None]), zero)
    l = pr.sum(dim=-1)
    acc = (pr.to(v.dtype).float()[..., None] * v.float()).sum(dim=-2)
    # chunk z is live where it starts below the row's page count
    npages = -(-lens.reshape(b) // bs)
    alive = (torch.arange(nz, device=q.device)[None, :] * cp <
             npages[:, None])[:, None, :].expand(b, h, nz)
    top = torch.where(alive, m, neg).amax(dim=-1)         # [B, H]
    l_sum = torch.zeros(b, h, dtype=torch.float32, device=q.device)
    out = torch.zeros(b, h, dv, dtype=torch.float32, device=q.device)
    for z in range(nz):                                   # split order
        f = torch.where(alive[..., z], torch.exp(m[..., z] - top), zero)
        l_sum = l_sum + l[..., z] * f
        out = out + torch.where(alive[..., z, None],
                                acc[:, :, z] * f[..., None], zero)
    return out / torch.where(l_sum == 0, torch.ones_like(l_sum),
                             l_sum)[..., None]


def _paged_cuda(q, k_pages, v_pages, block_tables, seq_lens, scale,
                workspace=None):
    """Launch K4. ``workspace`` (tests only) replaces the fp32
    [n, h, splits, dv + 2] scratch the call would allocate."""
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
    if max(d, dv) > MAX_HEAD_DIM or n > 65535:
        raise ValueError('paged_attention kernel: needs key and value head '
                         'dims <= %d and <= 65535 rows; got D %d, Dv %d, %d '
                         'rows' % (MAX_HEAD_DIM, d, dv, n))
    code = build.dtype_code(k_pages.dtype)
    out = torch.empty((n, h, dv), dtype=torch.float32, device=dev)
    if n == 0 or h == 0 or p == 0:
        return out.zero_()
    lib = build.library()
    nz = -(-p // chunk_pages(bs))   # the launcher refuses another count
    if workspace is None:
        workspace = torch.empty((n, h, nz, dv + 2), dtype=torch.float32,
                                device=dev)
    elif workspace.dtype != torch.float32 or workspace.device != dev or \
            tuple(workspace.shape) != (n, h, nz, dv + 2) or \
            not workspace.is_contiguous():
        raise ValueError('paged_attention kernel: workspace must be a '
                         'contiguous float32 [%d, %d, %d, %d] tensor'
                         % (n, h, nz, dv + 2))
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ptt_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), block_tables.stride(0),
            seq_lens.data_ptr(), workspace.data_ptr(), out.data_ptr(), n, h,
            nb, bs, d, dv, p, nz, float(scale), code,
            ctypes.byref(launched), stream)
    build.check(rc, 'ptt_paged_attention')
    paged_attention.launches += 1
    if launched.value == _LAUNCHED_V16:
        paged_attention.launches_v16 += 1
    elif launched.value == _LAUNCHED_ANY:
        paged_attention.launches_any += 1
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
paged_attention.launches_v16 = 0   # the 16-byte split kernel
paged_attention.launches_any = 0   # the any-width split kernel
