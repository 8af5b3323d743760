"""Ragged paged attention: the CUDA kernels of ``csrc/paged_attention.cu``
(K4, replacing ``_paged_kernel`` of
paddle_tpu/ops/pallas/paged_attention.py, and, for quantized pages, the
dequantizing gather path ``paged_attention_reference`` of the same file)
and their plain PyTorch versions ``paged_attention_reference`` and
``paged_attention_split_reference``.

Layouts (the JAX package's):
    q            [B, H, D]      one query token per row, float32
    k/v_pages    [NB, H, bs, D] the pooled page arena of one layer
    block_tables [B, P] int32   physical page ids; >= NB means "no page"
    seq_lens     [B]  int32     live tokens (this token included)
    k/v_scales   [NB, H, bs]    fp32, one scale a stored row: int8 and
                                float8_e4m3fn pages only

The kernel splits a row over blocks: each takes a fixed chunk of
``CHUNK_TOKENS`` tokens and leaves a partial (acc, m, l) in a workspace
that a merge kernel combines in split order. The chunk is a constant, so a
row's result is a pure function of its q, pages and length, whatever batch
it is part of.

The split kernel comes in two hand-written variants: one with 16-byte
loads (key and value rows that are multiples of 16 bytes, at most 512
bytes, Dv <= 128, 16-byte aligned arenas: the decode path) and one for
rows of any width (a bf16 arena with d_key 36, an fp32 one with d_key 30,
Dv 192, an int8 one with d_key 8; above 256 columns in chunks of 256,
each value chunk its own block), with the widest load
(8, 4, 2 or 1 bytes) that divides the rows. Both take fp32, bf16, int8 and
e4m3 pages; a quantized page is dequantized in registers (float(v) *
scale[row]), its p.v in fp32. The launcher chooses and reports which it
launched.

``paged_attention_write`` is the same launch with the decode ops' KV write
folded in (the reference's dropping scatter ``_write_positions`` of
paddle_tpu/ops/paged_decode_ops.py, then K4), for new rows of the arena's
own dtype (float32 into float32 pages, bfloat16 into bfloat16): each kept
row's new K and V rows are written into the arenas by the split block that
attends over the row's last position, and every position at or past a
row's ``fresh_lo`` is read from the input rows, never from the arena the
launch writes. Its plain version is the composition
``kv_write_reference`` then ``paged_attention_reference``;
``paged_attention_write_split_reference`` models the kernel's own order
(fresh keys from the input). Rows that must be converted (quantized or
rounded into the arena) take the stand-alone write, ``kv_write``.

``paged_attention`` and ``paged_attention_write`` launch the kernels for
CUDA tensors and take the plain versions only for CPU tensors; on a CUDA
tensor they launch or raise. ``paged_attention.launches`` counts calls
that launched (both functions), ``launches_v16`` and ``launches_any`` each
variant, ``launches_q8`` those on quantized pages and ``launches_write``
those that wrote.
"""

import ctypes

import torch

from ...quant.core import kv_quantized
from . import build
from .kv_write import kv_write_reference

_NEG_INF = -1e9
# tokens one split block of the kernel covers (kChunkTokens of the source)
CHUNK_TOKENS = 256
# the launcher's report: 1 the 16-byte kernel, 2 the any-width one, +2 for
# quantized pages, +8 where the launch wrote the new rows
_LAUNCHED_V16, _LAUNCHED_ANY, _LAUNCHED_Q8, _LAUNCHED_WRITE = 1, 2, 2, 8


def chunk_pages(block_size):
    """Pages of one split chunk at this block size (at least one)."""
    return max(1, CHUNK_TOKENS // block_size)


def _quantized(pages):
    return kv_quantized(str(pages.dtype)[6:])


def _gather(pages, tables):
    """pages[tables]; one-byte pages are gathered as bytes (the same bits)."""
    if _quantized(pages):
        return pages.view(torch.uint8)[tables].view(pages.dtype)
    return pages[tables]


def _gather_rows(pages, scales, tables, b, h, n_keys, width):
    """[B, H, n_keys, width] rows of ``tables``' pages, dequantized to
    fp32 (``float(v) * scale[row]``) when ``scales`` is given."""
    rows = _gather(pages, tables).permute(0, 2, 1, 3, 4) \
        .reshape(b, h, n_keys, width)
    if scales is None:
        return rows
    s = scales[tables].permute(0, 2, 1, 3).reshape(b, h, n_keys)
    return rows.float() * s[..., None]


def paged_attention_reference(q, k_pages, v_pages, block_tables, seq_lens,
                              sm_scale=None, k_scales=None, v_scales=None):
    """Plain version, a straight translation of the reference's gather
    path: gather each row's pages through its (clipped) table into
    [B, H, P*bs, D] (dequantized to fp32 through the scale arenas when
    they are given), mask columns >= seq_len with -1e9, fp32 softmax, and
    the weights rounded to the page dtype (fp32 after dequantization)
    before w.v. Returns [B, H, Dv] in that dtype. (A row with seq_len 0
    averages every gathered column here, where the kernel returns 0; the
    decode ops never ask for length 0.)"""
    nb, h, bs, d = k_pages.shape
    b, p = block_tables.shape
    dv = v_pages.shape[-1]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    tables = block_tables.long().clamp(0, nb - 1)
    k = _gather_rows(k_pages, k_scales, tables, b, h, p * bs, d)
    v = _gather_rows(v_pages, v_scales, tables, b, h, p * bs, dv)
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
                                    seq_lens, sm_scale=None, k_scales=None,
                                    v_scales=None):
    """Plain version in the kernel's order of operations, for tests and
    the chip smoke: each chunk of ``chunk_pages(bs)`` pages gives a partial
    (m, l, acc) in fp32 (scale applied to q, masked columns at -1e9 with
    p = 0, p rounded to the page dtype before p.v; quantized pages are
    dequantized first, float(v) * scale[row], and keep p in fp32); the
    partials of the chunks that start below ceil(len / bs) pages are
    combined in split order and divided by l (1 where l is 0: a row with
    no live chunk gives 0). Dot products are elementwise products summed
    per row, so a row's bits do not depend on the rows around it. Returns
    [B, H, Dv] fp32."""
    k, v, lens = _split_rows(k_pages, v_pages, block_tables, seq_lens,
                             k_scales, v_scales)
    return _split_attend(q, k, v, lens, k_pages.shape[2], sm_scale)


def _split_rows(k_pages, v_pages, block_tables, seq_lens, k_scales,
                v_scales):
    """Each row's keys and values [B, H, Z*ct, D*] through its table padded
    to whole chunks (dequantized to fp32 for quantized pages), and its
    length [B, 1, 1, 1] clamped to the table's capacity."""
    nb, h, bs, d = k_pages.shape
    dv = v_pages.shape[-1]
    b, p = block_tables.shape
    cp = chunk_pages(bs)
    nz = -(-p // cp)
    tables = block_tables.long().clamp(0, nb - 1)
    if nz * cp > p:          # pad the table to whole chunks (never live)
        pad = tables.new_zeros(b, nz * cp - p)
        tables = torch.cat([tables, pad], dim=1)
    k = _gather_rows(k_pages, k_scales, tables, b, h, nz * cp * bs, d)
    v = _gather_rows(v_pages, v_scales, tables, b, h, nz * cp * bs, dv)
    lens = seq_lens.reshape(b, 1, 1, 1).long().clamp(max=p * bs)
    return k, v, lens


def _split_attend(q, k, v, lens, bs, sm_scale):
    """The split order's math over gathered rows (``_split_rows``)."""
    b, h, keys, d = k.shape
    dv = v.shape[-1]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    cp = chunk_pages(bs)
    ct = cp * bs
    nz = keys // ct
    k = k.reshape(b, h, nz, ct, d)
    v = v.reshape(b, h, nz, ct, dv)
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


# ------------------------------------------------- the KV write folded in
def paged_attention_write_split_reference(q, k_new, v_new, k_pages, v_pages,
                                          block_tables, seq_lens, phys, off,
                                          keep, fresh_lo, fresh_src,
                                          sm_scale=None):
    """Plain version in the fused kernel's order, for tests and the chip
    smoke: writes the arenas as ``kv_write_reference`` does, and attends
    as ``paged_attention_split_reference`` with every position t in
    [fresh_lo[r], seq_lens[r]) of row r taken from input row fresh_src[r] +
    t - fresh_lo[r] (clamped to the N rows) instead of from the arena.
    Returns [B, H, Dv] fp32."""
    _check_direct(k_new, v_new, k_pages, v_pages)
    n = k_new.shape[0]
    kv_write_reference(k_new, v_new, k_pages, v_pages, phys, off, keep)
    k, v, lens = _split_rows(k_pages, v_pages, block_tables, seq_lens, None,
                             None)
    pos = torch.arange(k.shape[2], device=q.device)[None, :]
    lo = fresh_lo.reshape(-1, 1).long()
    fresh = (pos >= lo) & (pos < lens.reshape(-1, 1))         # [B, keys]
    src = (fresh_src.reshape(-1, 1).long() + pos - lo).clamp(0, n - 1)
    k = torch.where(fresh[:, None, :, None], k_new[src].transpose(1, 2), k)
    v = torch.where(fresh[:, None, :, None], v_new[src].transpose(1, 2), v)
    return _split_attend(q, k, v, lens, k_pages.shape[2], sm_scale)


def _check_direct(k_new, v_new, k_pages, v_pages):
    """The fold takes new rows of the arenas' own dtype, float32 or
    bfloat16 (anything to convert takes ``kv_write``)."""
    dt = k_pages.dtype
    if dt not in (torch.float32, torch.bfloat16) or \
            not k_new.dtype == v_new.dtype == v_pages.dtype == dt:
        raise ValueError('paged_attention_write: new rows must have the '
                         'arenas\' dtype, float32 or bfloat16; got %s and %s '
                         'rows into %s and %s pages (converting writes take '
                         'kv_write)' % (k_new.dtype, v_new.dtype, dt,
                                        v_pages.dtype))


def _check_write(write, n, h, d, dv, dev):
    """The folded write's tensors: new rows [n, h, d] and [n, h, dv]
    (their dtype checked by ``_check_direct``), phys, off, fresh_lo and
    fresh_src [n] int32 and keep [n] bool, contiguous, on ``dev``."""
    k_new, v_new, phys, off, keep, fresh_lo, fresh_src = write
    if tuple(k_new.shape) != (n, h, d) or tuple(v_new.shape) != (n, h, dv) \
            or not (k_new.is_contiguous() and v_new.is_contiguous()):
        raise ValueError('paged_attention_write kernel: new rows must be '
                         'contiguous [%d, %d, %d] and [%d, %d, %d]; got %s %s'
                         % (n, h, d, n, h, dv, tuple(k_new.shape),
                            tuple(v_new.shape)))
    for t, dt in ((phys, torch.int32), (off, torch.int32),
                  (keep, torch.bool), (fresh_lo, torch.int32),
                  (fresh_src, torch.int32)):
        if t.dtype != dt or tuple(t.shape) != (n,) or not t.is_contiguous():
            raise ValueError('paged_attention_write kernel: phys, off, '
                             'keep, fresh_lo and fresh_src must be '
                             'contiguous [%d] int32, int32, bool, int32 and '
                             'int32' % n)
    for t in write:
        if t.device != dev:
            raise ValueError('paged_attention_write kernel: all inputs must '
                             'be on %s, got %s' % (dev, t.device))


def _paged_cuda(q, k_pages, v_pages, block_tables, seq_lens, scale,
                workspace=None, k_scales=None, v_scales=None, write=None):
    """Launch K4. ``workspace`` (tests only) replaces the fp32
    [n, h, splits, dv + 2] scratch the call would allocate. ``write``:
    (k_new, v_new, phys, off, keep, fresh_lo, fresh_src), the folded KV
    write (``paged_attention_write``), or None."""
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
    quantized = _quantized(k_pages)
    if quantized != (k_scales is not None) or \
            (k_scales is None) != (v_scales is None):
        raise ValueError('paged_attention kernel: int8 and float8_e4m3fn '
                         'pages take k_scales and v_scales, other pages '
                         'none; got %s pages with%s scales'
                         % (k_pages.dtype, '' if k_scales is not None
                            else 'out'))
    scales = (k_scales, v_scales) if quantized else ()
    for t in scales:
        if t.dtype != torch.float32 or tuple(t.shape) != (nb, h, bs) or \
                not t.is_contiguous():
            raise ValueError('paged_attention kernel: scales must be '
                             'contiguous float32 [%d, %d, %d] tensors'
                             % (nb, h, bs))
    for t in (k_pages, v_pages, block_tables, seq_lens) + scales:
        if t.device != dev:
            raise ValueError('paged_attention kernel: all inputs must be '
                             'on %s, got %s' % (dev, t.device))
    if n > 65535:
        raise ValueError('paged_attention kernel: needs <= 65535 rows, got '
                         '%d' % n)
    if write is not None:
        _check_write(write, n, h, d, dv, dev)
    code = build.dtype_code(k_pages.dtype, quantized=True)
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
    ptrs = [None] * 7 if write is None else [t.data_ptr() for t in write]
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ptt_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr() if quantized else None,
            v_scales.data_ptr() if quantized else None,
            block_tables.data_ptr(), block_tables.stride(0),
            seq_lens.data_ptr(), workspace.data_ptr(), out.data_ptr(), n, h,
            nb, bs, d, dv, p, nz, float(scale), code, *ptrs,
            ctypes.byref(launched), stream)
    build.check(rc, 'ptt_paged_attention')
    paged_attention.launches += 1
    variant = launched.value
    if variant & _LAUNCHED_WRITE:
        paged_attention.launches_write += 1
        variant -= _LAUNCHED_WRITE
    if variant > _LAUNCHED_ANY:
        paged_attention.launches_q8 += 1
        variant -= _LAUNCHED_Q8
    if variant == _LAUNCHED_V16:
        paged_attention.launches_v16 += 1
    elif variant == _LAUNCHED_ANY:
        paged_attention.launches_any += 1
    return out


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens,
                    sm_scale=None, k_scales=None, v_scales=None):
    """Ragged paged attention: one query per row against its paged KV
    cache. q [B, H, D]; pages [NB, H, bs, D*]; block_tables [B, P] int32
    (entries >= NB mean "no page" and are never read; a broadcast table
    with row stride 0 is taken as it is); seq_lens [B] int32; int8 and
    float8_e4m3fn pages come with their fp32 row scales
    ``k_scales``/``v_scales`` [NB, H, bs]. Returns [B, H, Dv]: float32
    from the kernel, the page dtype (fp32 for quantized pages) from the
    plain version."""
    d = k_pages.shape[-1]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    if q.device.type == 'cpu':
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                         seq_lens, sm_scale=scale,
                                         k_scales=k_scales,
                                         v_scales=v_scales)
    return _paged_cuda(q, k_pages, v_pages, block_tables, seq_lens, scale,
                       k_scales=k_scales, v_scales=v_scales)


def paged_attention_write(q, k_new, v_new, k_pages, v_pages, block_tables,
                          seq_lens, phys, off, keep, fresh_lo, fresh_src,
                          sm_scale=None):
    """The decode ops' KV write and ragged paged attention in one launch.
    Writes the kept rows of ``k_new`` [B, H, D] and ``v_new`` [B, H, Dv]
    into the arenas at (phys, :, off), in place (``kv_write_reference``);
    the rows have the arenas' dtype, float32 or bfloat16 (a write that
    converts takes ``kv_write``: ValueError here); ``phys``, ``off`` [B]
    int32 and ``keep`` [B] bool, where row r's write is position
    seq_lens[r] - 1 of its table. Returns each row's attention over
    [0, seq_lens[r]) as ``paged_attention`` does, the positions from
    ``fresh_lo[r]`` on read from input rows ``fresh_src[r] + t -
    fresh_lo[r]`` ([B] int32 each).

    The caller promises the positions at or past a row's fresh_lo are
    exactly the rows this call writes for its sequence, and that no row
    reads, below its fresh_lo, a slot the call writes (the decode ops
    write only past a sequence's cached span, inside its own pages). A
    row then equals write-then-attend wherever every row it takes from
    the input is kept; the output of a row that reads a dropped row's
    position (an empty decode slot, a prefill row past its length)
    differs from the plain version's stale read, and no caller reads
    it."""
    _check_direct(k_new, v_new, k_pages, v_pages)
    d = k_pages.shape[-1]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    if q.device.type == 'cpu':
        kv_write_reference(k_new, v_new, k_pages, v_pages, phys, off, keep)
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                         seq_lens, sm_scale=scale)
    return _paged_cuda(q, k_pages, v_pages, block_tables, seq_lens, scale,
                       write=(k_new, v_new, phys, off, keep, fresh_lo,
                              fresh_src))


paged_attention.launches = 0
paged_attention.launches_v16 = 0   # the 16-byte split kernel
paged_attention.launches_any = 0   # the any-width split kernel
paged_attention.launches_q8 = 0    # either, on int8 or fp8 pages
paged_attention.launches_write = 0  # either, with the KV write folded in
