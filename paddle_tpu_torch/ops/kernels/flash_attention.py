"""Flash attention: the CUDA kernels of ``csrc/flash_attention.cu`` — K2,
the forward (replacing ``_fwd_kernel`` / ``_flash_fwd`` of
paddle_tpu/ops/pallas/flash_attention.py), and K3, the backward as two
kernels (replacing ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel`` /
``_flash_bwd``) — beside their plain PyTorch versions
``flash_attention_reference_fwd`` and ``flash_attention_reference_bwd``.

Layout is the JAX package's: q, k, v are [B, H, T, D] (any strides with D
contiguous, so head-split views need no copy) and ``kv_len`` is [B]. The
causal mask is aligned top-left (key col <= query row), so causal needs
Tq == Tk. A row with no live key gives out 0 and lse -1e30, as the kernels
do (the reference ``reference_attention`` would give the mean of V there;
the model never sends kv_len 0).

``flash_attention`` is the autograd entry point. On a CUDA tensor its
forward launches K2 and its backward launches both K3 kernels, or raises;
only a CPU tensor takes the plain versions. ``flash_fwd_cuda.launches``,
``flash_bwd_dkv_cuda.launches`` and ``flash_bwd_dq_cuda.launches`` count
kernel launches.

K2 and each K3 kernel come in two hand-written variants: a tensor-core
kernel (bf16, head dim a multiple of 16 up to 128, strides and base
pointers multiples of 8 elements: the training path) and a SIMT kernel
(fp32, and every other bf16 input). The launcher in the source chooses from
dtype, head dim, strides and pointers alone and reports the kernel it
launched; ``launches_mma`` and ``launches_simt`` on each of the three
wrappers count from that report.
``flash_attention_tiled_reference_fwd`` is a second plain version that
follows the tensor-core forward's order of operations.

delta = rowsum(dO * O) of the backward is computed inside K3's dQ kernel
(in fp32, for the rows it owns) and written to a [B*H, Tq] buffer that the
dK/dV kernel, launched after it on the same stream, reads: no torch kernel
computes it.
"""

import ctypes

import torch

from . import build

NEG_INF = -1e30
MAX_HEAD_DIM = 128


def _check(q, k, v, kv_len, causal):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError('flash_attention: q, k, v must be [B, H, T, D], '
                         'got %s %s %s' % (tuple(q.shape), tuple(k.shape),
                                           tuple(v.shape)))
    b, h, tq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError('flash_attention: k and v must be [%d, %d, Tk, %d] '
                         'alike, got %s %s' % (b, h, d, tuple(k.shape),
                                               tuple(v.shape)))
    if d > MAX_HEAD_DIM:
        raise ValueError('flash_attention: head dim %d > %d'
                         % (d, MAX_HEAD_DIM))
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError('flash_attention: q, k, v must all be float32 or '
                        'all bfloat16, got %s %s %s'
                        % (q.dtype, k.dtype, v.dtype))
    if k.device != q.device or v.device != q.device or \
            (kv_len is not None and kv_len.device != q.device):
        raise ValueError('flash_attention: inputs on different devices')
    if causal and tq != k.shape[2]:
        raise ValueError('flash_attention: causal needs Tq == Tk (the mask '
                         'is aligned top-left), got %d and %d'
                         % (tq, k.shape[2]))
    if kv_len is not None and tuple(kv_len.shape) != (b,):
        raise ValueError('flash_attention: kv_len must be [%d], got %s'
                         % (b, tuple(kv_len.shape)))


def _live(tq, tk, kv_len, causal, device):
    """[B or 1, 1, Tq, Tk] bool: the (query, key) pairs that attend."""
    cols = torch.arange(tk, device=device)
    if causal:
        live = cols[None, :] <= torch.arange(tq, device=device)[:, None]
    else:
        live = torch.ones(tq, tk, dtype=torch.bool, device=device)
    live = live[None, None]
    if kv_len is not None:
        live = live & (cols.reshape(1, 1, 1, tk) <
                       kv_len.reshape(-1, 1, 1, 1))
    return live


def _scores(q, k, scale, kv_len, causal):
    """fp32 scores of the inputs as given (bf16 values are exact in
    fp32, so this is an input-dtype product with fp32 accumulation), the
    masked entries at NEG_INF, and the live mask."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    live = _live(q.shape[2], k.shape[2], kv_len, causal, q.device)
    return s.masked_fill(~live, NEG_INF), live


def flash_attention_reference_fwd(q, k, v, kv_len=None, causal=False,
                                  scale=None):
    """Plain version of K2: (out [B, H, Tq, D] in q's dtype, lse
    [B, H, Tq] fp32). One softmax over the whole row; p is rounded to v's
    dtype before p.v, as the kernel rounds its per-tile p."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s, live = _scores(q, k, scale, kv_len, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), torch.zeros((), device=q.device))
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0, torch.ones((), device=q.device), denom)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / denom
    return out.to(q.dtype), (m + torch.log(denom)).squeeze(-1)


def flash_attention_tiled_reference_fwd(q, k, v, kv_len=None, causal=False,
                                        scale=None, tile=64):
    """Plain version of K2 in the tensor-core kernel's order of
    operations, for tests and the chip smoke: keys in tiles of 64, an
    online softmax with fp32 m, l and acc, and p rounded to v's dtype
    tile by tile against the running max (the kernel's packing of the
    score fragment). Masked entries get p = 0 explicitly, so a tile with
    no live key changes nothing and need not be skipped here. Returns
    (out in q's dtype, lse [B, H, Tq] fp32)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    b, h, tq, d = q.shape
    tk = k.shape[2]
    live_all = _live(tq, tk, kv_len, causal, q.device)
    zero = torch.zeros((), device=q.device)
    qf = q.float()
    m = torch.full((b, h, tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(b, h, tq, dtype=torch.float32, device=q.device)
    acc = torch.zeros(b, h, tq, d, dtype=torch.float32, device=q.device)
    for k0 in range(0, tk, tile):
        live = live_all[..., k0:k0 + tile]
        s = torch.matmul(qf, k[:, :, k0:k0 + tile].float()
                         .transpose(-1, -2)) * scale
        s = s.masked_fill(~live, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(live, torch.exp(s - m_new[..., None]), zero)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(
            p.to(v.dtype).float(), v[:, :, k0:k0 + tile].float())
        m = m_new
    denom = torch.where(l == 0, torch.ones((), device=q.device), l)
    return (acc / denom[..., None]).to(q.dtype), m + torch.log(denom)


def flash_attention_reference_bwd(q, k, v, o, lse, do, kv_len=None,
                                  causal=False, scale=None):
    """Plain version of K3: (dq, dk, dv) in the inputs' dtype. p is
    recomputed from lse, delta = rowsum(dO * O) in fp32, ds = p * (dp -
    delta) * scale, and p and ds are rounded to the input dtype before the
    dV, dK and dQ products."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s, live = _scores(q, k, scale, kv_len, causal)
    p = torch.where(live, torch.exp(s - lse.float().unsqueeze(-1)),
                    torch.zeros((), device=q.device))
    dof = do.float()
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    dq = torch.matmul(ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------ launchers
def _strides(*tensors):
    vals = []
    for t in tensors:
        if t.stride(3) != 1:
            raise ValueError('flash_attention kernel: the head dim must be '
                             'contiguous (stride %d)' % t.stride(3))
        vals.extend(t.stride()[:3])
    return (ctypes.c_longlong * len(vals))(*vals)


def _lens(kv_len):
    if kv_len is None:
        return None
    return kv_len.to(torch.int32).contiguous()


def _call(fn, name, *args):
    dev = args[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args], stream)
    build.check(rc, name)


def _dims(q, k, causal, scale):
    b, h, tq, d = q.shape
    return [b, h, tq, k.shape[2], d, int(bool(causal)), float(scale),
            build.dtype_code(q.dtype)]


# the launchers' report of the kernel they launched (0: none, an empty grid)
_LAUNCHED_SIMT, _LAUNCHED_MMA = 1, 2


def _launch(wrapper, entry, name, *args):
    """Call a launcher that reports the kernel it launched and count the
    launch on ``wrapper`` from that report."""
    launched = ctypes.c_int(0)
    _call(entry, name, *args, ctypes.byref(launched))
    wrapper.launches += 1
    if launched.value == _LAUNCHED_MMA:
        wrapper.launches_mma += 1
    elif launched.value == _LAUNCHED_SIMT:
        wrapper.launches_simt += 1


def flash_fwd_cuda(q, k, v, kv_len, causal, scale):
    """Launch K2: (out, lse [B, H, Tq] fp32)."""
    o = torch.empty_like(q)
    b, h, tq, _ = q.shape
    lse = torch.empty(b, h, tq, dtype=torch.float32, device=q.device)
    _launch(flash_fwd_cuda, build.library().ptt_flash_fwd, 'ptt_flash_fwd',
            q, k, v, o, lse, _lens(kv_len), _strides(q, k, v, o),
            *_dims(q, k, causal, scale))
    return o, lse


def flash_bwd_dq_cuda(q, k, v, do, o, lse, delta, kv_len, causal, scale):
    """Launch K3's dQ kernel; it also writes delta = rowsum(dO * O) (fp32
    [B, H, Tq]) into ``delta`` for the dK/dV kernel."""
    dq = torch.empty_like(q)
    _launch(flash_bwd_dq_cuda, build.library().ptt_flash_bwd_dq,
            'ptt_flash_bwd_dq', q, k, v, do, o, lse, delta, _lens(kv_len),
            dq, _strides(q, k, v, do, o, dq), *_dims(q, k, causal, scale))
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, kv_len, causal, scale):
    """Launch K3's dK/dV kernel; ``delta`` is what the dQ kernel wrote."""
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch(flash_bwd_dkv_cuda, build.library().ptt_flash_bwd_dkv,
            'ptt_flash_bwd_dkv', q, k, v, do, lse, delta, _lens(kv_len), dk,
            dv, _strides(q, k, v, do, dk, dv), *_dims(q, k, causal, scale))
    return dk, dv


for _wrapper in (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda):
    _wrapper.launches = 0
    _wrapper.launches_mma = 0      # the tensor-core kernel
    _wrapper.launches_simt = 0     # the SIMT kernel
del _wrapper


# ------------------------------------------------------------- dispatch
def flash_attention_fwd(q, k, v, kv_len=None, causal=False, scale=None):
    """(out, lse): K2 on a CUDA tensor, the plain version on a CPU one."""
    _check(q, k, v, kv_len, causal)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == 'cpu':
        return flash_attention_reference_fwd(q, k, v, kv_len, causal, scale)
    return flash_fwd_cuda(q, k, v, kv_len, causal, scale)


def flash_attention_bwd(q, k, v, o, lse, do, kv_len=None, causal=False,
                        scale=None):
    """(dq, dk, dv): both K3 kernels on a CUDA tensor (dQ first: it
    computes delta = rowsum(dO * O) for the dK/dV kernel), the plain
    version on a CPU one."""
    _check(q, k, v, kv_len, causal)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == 'cpu':
        return flash_attention_reference_bwd(q, k, v, o, lse, do, kv_len,
                                             causal, scale)
    if do.dtype != q.dtype or do.shape != q.shape:
        raise ValueError('flash_attention backward: dO must match q, got %s '
                         '%s' % (do.dtype, tuple(do.shape)))
    if o.dtype != q.dtype or o.shape != q.shape:
        raise ValueError('flash_attention backward: O must match q, got %s '
                         '%s' % (o.dtype, tuple(o.shape)))
    if do.stride(3) != 1:
        do = do.contiguous()
    if o.stride(3) != 1:
        o = o.contiguous()
    lse = lse.contiguous()
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    dq = flash_bwd_dq_cuda(q, k, v, do, o, lse, delta, kv_len, causal, scale)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, kv_len, causal,
                                scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, kv_len, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse, kv_len)
        ctx.causal = causal
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, kv_len = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, kv_len,
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=False, sm_scale=None, kv_len=None):
    """q, k, v: [B, H, T, D]; kv_len: optional [B] valid key counts.
    Differentiable in q, k and v. Returns [B, H, Tq, D]."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, kv_len, causal, float(scale))
