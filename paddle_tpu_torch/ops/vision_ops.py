"""Vision ops: lrn, roi_pool, crop, max_pool2d_with_index and unpool
(reference: paddle_tpu ops/vision_ops.py; fluid's lrn_op.cc,
roi_pool_op.cc, crop_op.cc, pool_with_index_op.cc, unpool_op.cc).

Every shape is static (pooled sizes, windows and crop shapes are
attributes) and no lowering reads a tensor's value on the host, so a step
that holds them is captured. Outside a window, and outside an ROI's bin,
the reference fills with the dtype's finfo.min, not -inf: a bin whose own
values are all -inf gives finfo.min, and its argmax is then the first
position outside it. Its max gradient is shared evenly among the elements
equal to the result (JAX's reduce_max rule), which these lowerings keep.
"""

import torch
import torch.nn.functional as F

from ..core.registry import register
from .pointwise import amax


@register('lrn')
def _lrn(ctx):
    """Local response normalization across the channels of an NCHW X
    (lrn_op.cc:30-56): mid = k + alpha·Σ x_c² over the n + 1 channels
    c - (n-1)/2 .. c + (n+1)/2 (the reference's window loop is inclusive
    at both ends), out = x·mid^-beta. The taps are added to k one after
    another in the reference's order; MidOut is written."""
    x = ctx.input('X')
    n = ctx.attr('n', 5)
    k = ctx.attr('k', 2.0)
    alpha = ctx.attr('alpha', 1e-4)
    beta = ctx.attr('beta', 0.75)
    c = x.shape[1]
    start = -(n - 1) // 2
    # channel c + off of the scaled squares, 0 past either end
    left, right = max(0, -start), max(0, start + n)
    asq = F.pad(alpha * (x * x), (0, 0, 0, 0, left, right))
    mid = torch.full_like(x, k)
    for off in range(start, start + n + 1):
        mid = mid + asq[:, left + off:left + off + c]
    ctx.set_output('MidOut', mid)
    ctx.set_output('Out', x * mid ** (-beta))


def _first(hit, dim):
    """The first index along ``dim`` where ``hit`` holds (its size where
    none does)."""
    size = hit.shape[dim]
    shape = [1] * hit.dim()
    shape[dim] = size
    pos = torch.arange(size, dtype=torch.int32,
                       device=hit.device).reshape(shape)
    return torch.where(hit, pos, size).amin(dim)


def _is_max(v, m):
    """v equals the max m, NaN matching NaN: the positions jnp.argmax may
    pick (it takes a NaN as the largest value)."""
    return (v == m) | (v.isnan() & m.isnan())


def _roi_bins(rois, scale, ph_n, pw_n, h, w):
    """Batch ids [R] and the clipped [start, end) rows [R, PH] and columns
    [R, PW] of every bin (roi_pool_op.h:60-120, in the reference's fp32
    arithmetic)."""
    bid = rois[:, 0].long()
    coords = torch.round(rois[:, 1:].float() * scale).int()
    x1, y1, x2, y2 = coords.unbind(1)
    # divided by a tensor: CUDA divides by a Python number as a product
    # with its reciprocal, which moves a bin edge 21 / 7 off 3
    roi_h = torch.clamp_min(y2 - y1 + 1, 1).float()
    roi_w = torch.clamp_min(x2 - x1 + 1, 1).float()
    roi_h = roi_h / torch.full_like(roi_h, ph_n)
    roi_w = roi_w / torch.full_like(roi_w, pw_n)
    ph = torch.arange(ph_n, dtype=torch.float32, device=rois.device)
    pw = torch.arange(pw_n, dtype=torch.float32, device=rois.device)

    def span(lo, bin_, idx, size):
        s = torch.floor(idx[None] * bin_[:, None]).int() + lo[:, None]
        e = torch.ceil((idx[None] + 1) * bin_[:, None]).int() + lo[:, None]
        return s.clamp(0, size), e.clamp(0, size)
    return bid, span(y1, roi_h, ph, h), span(x1, roi_w, pw, w)


class _RoiPool(torch.autograd.Function):
    """Out [R, C, PH, PW], Argmax (flattened h·W + w, -1 for an empty bin)
    and the gradient of the reference's masked max over the whole map,
    computed separably: for each bin row the max over its rows of every
    column (and the first row reaching it, and how many do), then over
    the bin's columns. No [R, C, PH, PW, H, W] tensor is made; max is
    exact, so Out and Argmax are the reference's bit for bit."""

    @staticmethod
    def forward(ctx, x, rois, ph_n, pw_n, scale):
        _, c, h, w = x.shape
        bid, (hs, he), (ws, we) = _roi_bins(rois, scale, ph_n, pw_n, h, w)
        feat = x[bid]                                         # [R, C, H, W]
        fmin = torch.finfo(x.dtype).min
        hpos = torch.arange(h, device=x.device)
        wpos = torch.arange(w, device=x.device)
        in_h = (hpos >= hs[..., None]) & (hpos < he[..., None])  # [R, PH, H]
        in_w = (wpos >= ws[..., None]) & (wpos < we[..., None])  # [R, PW, W]
        cols, first, count = [], [], []
        for p in range(ph_n):
            m = torch.where(in_h[:, p, None, :, None], feat, fmin)
            cm = m.amax(2)                                    # [R, C, W]
            cols.append(cm)
            first.append(_first(_is_max(m, cm[:, :, None]), 2))
            count.append((m == cm[:, :, None]).sum(2))
            del m
        cols = torch.stack(cols, 2)                           # [R, C, PH, W]
        first, count = torch.stack(first, 2), torch.stack(count, 2)
        inw = in_w[:, None, None]                             # [R,1,1,PW,W]
        m2 = torch.where(inw, cols[:, :, :, None], fmin)      # [R,C,PH,PW,W]
        out = m2.amax(-1)
        # a column outside the bin is fmin in each of its H rows
        key = torch.where(inw, first[:, :, :, None], 0) * w + wpos.int()
        arg = torch.where(_is_max(m2, out[..., None]), key, h * w).amin(-1)
        ties = torch.where(m2 == out[..., None],
                           torch.where(inw, count[:, :, :, None], h),
                           0).sum(-1)
        empty = ((hs >= he)[:, :, None] | (ws >= we)[:, None, :])[:, None]
        pooled = torch.where(empty, torch.zeros((), dtype=x.dtype,
                                                device=x.device), out)
        arg = torch.where(empty, -1, arg)
        ctx.save_for_backward(x, bid, in_h, in_w, cols, out, ties, empty)
        ctx.mark_non_differentiable(arg)
        return pooled, arg

    @staticmethod
    def backward(ctx, g, _garg):
        """Each bin's gradient over the elements of its rows and columns
        equal to its max, shared by their count (a NaN max passes none).
        The element (h, w) of a bin equals its max only where its column's
        max over the bin's rows does too, so the share is spread over each
        bin row's columns first, then down their rows."""
        x, bid, in_h, in_w, cols, out, ties, empty = ctx.saved_tensors
        share = torch.where(empty | (ties == 0), 0.0,
                            g / ties.to(g.dtype).clamp_min(1)).to(g.dtype)
        hit = in_w[:, None, None] & (cols[:, :, :, None] == out[..., None])
        per_col = torch.where(hit, share[..., None], 0).sum(3)  # [R,C,PH,W]
        feat = x[bid]
        grad = torch.zeros_like(feat)
        for p in range(in_h.shape[1]):
            on = in_h[:, p, None, :, None] & \
                (feat == cols[:, :, p, None, :])
            grad = grad + torch.where(on, per_col[:, :, p, None, :], 0)
        dx = torch.zeros_like(x).index_add_(0, bid, grad)
        return dx, None, None, None, None


@register('roi_pool')
def _roi_pool(ctx):
    """Max pool of every ROI (rows of ROIs [R, 5]: batch id, x1, y1, x2,
    y2, scaled by spatial_scale and rounded half to even) to a
    pooled_height x pooled_width grid: Out [R, C, PH, PW] and Argmax."""
    out, arg = _RoiPool.apply(ctx.input('X'), ctx.input('ROIs'),
                              ctx.attr('pooled_height', 1),
                              ctx.attr('pooled_width', 1),
                              ctx.attr('spatial_scale', 1.0))
    ctx.set_output('Out', out)
    ctx.set_output('Argmax', arg.long())


@register('crop')
def _crop(ctx):
    """X cropped to ``shape`` (or Y's shape) from ``offsets``. From an
    Offsets input the start is clamped into [0, dim - size] as
    lax.dynamic_slice clamps it, on the device: the crop is a gather along
    each axis, and no offset is read on the host."""
    x = ctx.input('X')
    shape = list(ctx.input('Y').shape) if ctx.has_input('Y') \
        else list(ctx.attr('shape'))
    if ctx.has_input('Offsets'):
        off = ctx.input('Offsets').long()
        out = x
        for d, size in enumerate(shape):
            start = off[d].clamp(0, x.shape[d] - size)
            idx = start + torch.arange(size, device=x.device)
            out = out.index_select(d, idx)
    else:
        offsets = ctx.attr('offsets') or [0] * x.dim()
        out = x[tuple(slice(o, o + s) for o, s in zip(offsets, shape))]
    ctx.set_output('Out', out)


def _pool_patches(x, ksize, strides, paddings):
    """[B, C, OH, OW, KH·KW] windows of an NCHW x, whether each tap is
    inside the map, and the flattened h·W + w of every tap (clipped into
    the map where it hangs in the padding), as the reference's
    _pool_patches builds them."""
    _, _, h, w = x.shape
    (kh, kw), (sh, sw), (ph, pw) = ksize, strides, paddings
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (w + 2 * pw - kw) // sw + 1
    dev = x.device
    h_idx = (torch.arange(oh, device=dev) * sh - ph)[:, None] + \
        torch.arange(kh, device=dev)[None]
    w_idx = (torch.arange(ow, device=dev) * sw - pw)[:, None] + \
        torch.arange(kw, device=dev)[None]
    ok = ((h_idx >= 0) & (h_idx < h))[:, None, :, None] & \
        ((w_idx >= 0) & (w_idx < w))[None, :, None, :]       # OH,OW,KH,KW
    hc, wc = h_idx.clamp(0, h - 1), w_idx.clamp(0, w - 1)
    patches = x[:, :, hc[:, :, None, None], wc[None, None]]  # B,C,OH,KH,OW,KW
    patches = patches.permute(0, 1, 2, 4, 3, 5).reshape(
        x.shape[0], x.shape[1], oh, ow, kh * kw)
    gidx = (hc[:, None, :, None] * w + wc[None, :, None, :])
    return patches, ok.reshape(oh, ow, kh * kw), gidx.reshape(oh, ow,
                                                               kh * kw)


@register('max_pool2d_with_index')
def _max_pool2d_with_index(ctx):
    """Max pool of an NCHW X (padding taps are finfo.min) with Mask, the
    flattened h·W + w of each window's first maximal tap (a NaN the
    largest); the gradient is shared among the taps equal to the max."""
    x = ctx.input('X')
    patches, ok, gidx = _pool_patches(x, ctx.attr('ksize'),
                                      ctx.attr('strides', [1, 1]),
                                      ctx.attr('paddings', [0, 0]))
    masked = torch.where(ok, patches, torch.finfo(patches.dtype).min)
    out = amax(masked, (masked.dim() - 1,))
    local = _first(_is_max(masked.detach(), out.detach()[..., None]), -1)
    mask = gidx.expand(masked.shape).gather(-1, local.long()[..., None])
    ctx.set_output('Out', out)
    ctx.set_output('Mask', mask.squeeze(-1).int())


@register('unpool')
def _unpool(ctx):
    """Each value of X written at its flattened h·W + w index (Indices) in
    a zero map of (in - 1)·stride - 2·pad + ksize. Where indices repeat,
    one write wins (which one is left to the scatter, as the reference
    leaves it to XLA's), and the gradient goes to the write that won, as
    JAX's scatter gradient does. A negative index counts from the
    end and one past the map is dropped, as in the reference."""
    x = ctx.input('X')
    idx = ctx.input('Indices')
    ksize = ctx.attr('ksize')
    strides = ctx.attr('strides', [1, 1])
    paddings = ctx.attr('paddings', [0, 0])
    b, c, ih, iw = x.shape
    oh = (ih - 1) * strides[0] - 2 * paddings[0] + ksize[0]
    ow = (iw - 1) * strides[1] - 2 * paddings[1] + ksize[1]
    n = oh * ow
    flat = idx.reshape(b * c, ih * iw).long()
    flat = torch.where(flat < 0, flat + n, flat)
    flat = torch.where((flat >= 0) & (flat < n), flat, n)
    src = torch.arange(ih * iw, device=x.device).expand(b * c, -1)
    winner = torch.full((b * c, n + 1), -1, dtype=torch.long,
                        device=x.device).scatter(1, flat, src)[:, :n]
    vals = x.reshape(b * c, ih * iw).gather(1, winner.clamp_min(0))
    out = torch.where(winner >= 0, vals, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))
    ctx.set_output('Out', out.reshape(b, c, oh, ow))
