"""2-D max pooling with the JAX package's picks: the CUDA kernels of
``csrc/max_pool.cu`` (replacing paddle_tpu/ops/conv_ops.py's reduce_window
max and the select_and_scatter that XLA makes of its VJP) beside their
plain PyTorch versions.

y is the window's max as the JAX package's reduce_window max gives it: NaN
where the window holds one, and +0 where it holds both zeros. Each window,
row-major with its padding counted as -inf, is scanned keeping the pick
while pick >= next. That is the first largest element,
but a NaN pick gives way to the next element, so in a window holding a NaN
the pick is the first largest element after its last NaN (the NaN itself
where it comes last). F.max_pool2d's backward would send the gradient to
the last NaN. An element picked by several windows gets the sum of their
gradients.

The forward writes y and, where asked, the picks: a window's row-major
place as a byte (255 for padding) where it has fewer than 255 places,
else the flat h·W + w of x's plane as an int32 (-1 for padding). The
gradient reads the picks and dy, never x.

``max_pool_fwd`` and ``max_pool_bwd`` launch their kernels for a CUDA
tensor and take the plain versions only for a CPU one; on a CUDA tensor
they launch or raise. Each counts one launch a call on the card
(``.launches``).
"""

import torch
import torch.nn.functional as F

from . import build


def pick_dtype(ksize):
    """The picks' dtype: a byte where a window has fewer than 255 places."""
    return torch.uint8 if ksize[0] * ksize[1] < 255 else torch.int32


def out_size(size, ksize, strides, pad):
    """(oh, ow) of a pool over an (h, w) map padded ``pad`` (left, right,
    top, bottom)."""
    return ((size[0] + pad[2] + pad[3] - ksize[0]) // strides[0] + 1,
            (size[1] + pad[0] + pad[1] - ksize[1]) // strides[1] + 1)


def memory_format(x):
    """channels_last where x is laid out so (and not also NCHW), else
    contiguous_format: the layout the kernels keep."""
    return torch.channels_last if (
        x.is_contiguous(memory_format=torch.channels_last) and
        not x.is_contiguous()) else torch.contiguous_format


def max_pool_fwd_reference(x, ksize, strides, pad, picks=True):
    """Plain version: (y, pick) of the max pool of x [N, C, H, W] over -inf
    padding ``pad`` (left, right, top, bottom) with windows ``ksize`` and
    ``strides``, by tensor ops over the unfolded windows (K = kh·kw times
    y's size); pick None unless ``picks``."""
    (kh, kw), (sh, sw), k = ksize, strides, ksize[0] * ksize[1]
    h, w = x.shape[2:]
    xp = F.pad(x, pad, value=float('-inf'))
    win = xp.unfold(2, kh, sh).unfold(3, kw, sw)
    n, c, oh, ow = win.shape[:4]
    win = win.reshape(n, c, oh, ow, k)
    y = win.amax(-1)
    # the reference's max counts -0 below +0; amax may keep either zero
    pos0 = ((win == 0) & ~win.signbit()).any(-1)
    y = torch.where(y == 0, torch.where(pos0, y.new_zeros(()),
                                        y.new_full((), -0.0)), y)
    if not picks:
        return y, None
    pos = torch.arange(k, device=x.device, dtype=torch.int32)
    last_nan = torch.where(win.isnan(), pos, -1).amax(-1, keepdim=True)
    after = pos > last_nan
    top = torch.where(after, win, float('-inf')).amax(-1, keepdim=True)
    at = (after & (win == top)).to(torch.uint8).argmax(-1, keepdim=True)
    at = torch.where(last_nan == k - 1, k - 1, at).squeeze(-1)
    row = torch.arange(oh, device=x.device)[:, None] * sh + at // kw - pad[2]
    col = torch.arange(ow, device=x.device) * sw + at % kw - pad[0]
    inside = (row >= 0) & (row < h) & (col >= 0) & (col < w)
    if k < 255:
        pick = torch.where(inside, at, 255).to(torch.uint8)
    else:
        pick = torch.where(inside, row * w + col, -1).to(torch.int32)
    return y, pick


def max_pool_bwd_reference(pick, dy, ksize, strides, pad, size):
    """Plain version: the gradient of x [N, C, *size] from dy [N, C, OH,
    OW] of its max pool (geometry as max_pool_fwd_reference) and that
    pool's picks: each window's dy put at its pick, the windows folded
    back onto x (K = kh·kw times dy's size)."""
    (kh, kw), (sh, sw), k = ksize, strides, ksize[0] * ksize[1]
    n, c, oh, ow = dy.shape
    h, w = size
    if k < 255:
        valid = pick != 255
        at = pick.long()
    else:
        valid = pick >= 0
        flat = pick.long().clamp_min(0)
        rows = torch.arange(oh, device=dy.device)[:, None] * sh
        cols = torch.arange(ow, device=dy.device) * sw
        at = (flat // w + pad[2] - rows) * kw + flat % w + pad[0] - cols
    at = torch.where(valid, at, 0).unsqueeze(-1)
    win = torch.zeros((n, c, oh, ow, k), dtype=dy.dtype, device=dy.device) \
        .scatter_(-1, at, torch.where(valid, dy, 0).unsqueeze(-1))
    dx = F.fold(win.permute(0, 1, 4, 2, 3).reshape(n, c * k, oh * ow),
                (h + pad[2] + pad[3], w + pad[0] + pad[1]), (kh, kw),
                stride=strides)
    return dx[:, :, pad[2]:pad[2] + h, pad[0]:pad[0] + w]


def _on_card(t, fmt):
    """t in ``fmt``, 16-byte aligned (the kernels' vector loads)."""
    t = t.contiguous(memory_format=fmt)
    return t.clone(memory_format=fmt) if t.data_ptr() % 16 else t


def _check(what, t, dtype=None):
    if t.dtype not in (torch.float32, torch.bfloat16) or (
            dtype is not None and t.dtype != dtype):
        raise TypeError('%s kernel: takes float32 or bfloat16%s, got %s'
                        % (what, '' if dtype is None else ' (%s)' % dtype,
                           t.dtype))
    if t.dim() != 4:
        raise ValueError('%s kernel: takes a 4-D tensor, got %s'
                         % (what, tuple(t.shape)))
    if t.numel() >= 2 ** 31:
        raise ValueError('%s kernel: indexes in 32 bits, got %d elements'
                         % (what, t.numel()))


def _geometry(n, c, h, w, oh, ow, ksize, strides, pad, fmt, dtype):
    return (n, c, h, w, oh, ow, ksize[0], ksize[1], strides[0], strides[1],
            pad[2], pad[0], int(fmt == torch.channels_last),
            build.dtype_code(dtype))


def _max_pool_fwd_cuda(x, ksize, strides, pad, picks):
    _check('max_pool_fwd', x)
    fmt = memory_format(x)
    x = _on_card(x, fmt)
    n, c, h, w = x.shape
    oh, ow = out_size((h, w), ksize, strides, pad)
    if oh < 1 or ow < 1 or min(pad) < 0:
        raise ValueError('max_pool_fwd kernel: no window fits %s with ksize '
                         '%s, strides %s, pad %s' % ((h, w), ksize, strides,
                                                     pad))
    y = torch.empty((n, c, oh, ow), device=x.device, dtype=x.dtype,
                    memory_format=fmt)
    pick = torch.empty((n, c, oh, ow), device=x.device,
                       dtype=pick_dtype(ksize),
                       memory_format=fmt) if picks else None
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ptt_max_pool_fwd(
            x.data_ptr(), y.data_ptr(),
            pick.data_ptr() if picks else None,
            *_geometry(n, c, h, w, oh, ow, ksize, strides, pad, fmt,
                       x.dtype), stream)
    build.check(rc, 'ptt_max_pool_fwd')
    max_pool_fwd.launches += 1
    return y, pick


def max_pool_fwd(x, ksize, strides, pad, picks=True):
    """(y, pick) of the max pool of x [N, C, H, W] (NCHW or channels-last;
    y and pick in x's layout) over -inf padding ``pad`` (left, right, top,
    bottom; the right and bottom ones as far as the windows reach),
    windows ``ksize`` and ``strides``; pick None unless ``picks``."""
    if x.device.type == 'cpu':
        return max_pool_fwd_reference(x, ksize, strides, pad, picks)
    return _max_pool_fwd_cuda(x, ksize, strides, pad, picks)


max_pool_fwd.launches = 0


def _max_pool_bwd_cuda(pick, dy, ksize, strides, pad, size, fmt):
    _check('max_pool_bwd', dy)
    if pick.dtype != pick_dtype(ksize) or pick.shape != dy.shape or \
            pick.device != dy.device:
        raise ValueError('max_pool_bwd kernel: pick must be %s of dy\'s '
                         'shape %s on its device, got %s %s'
                         % (pick_dtype(ksize), tuple(dy.shape), pick.dtype,
                            tuple(pick.shape)))
    pick = _on_card(pick, fmt)
    dy = _on_card(dy, fmt)
    n, c, oh, ow = dy.shape
    h, w = size
    if out_size(size, ksize, strides, pad) != (oh, ow) or min(pad) < 0:
        raise ValueError('max_pool_bwd kernel: dy %s is not the pool of an '
                         '%s map with ksize %s, strides %s, pad %s'
                         % (tuple(dy.shape), tuple(size), ksize, strides,
                            pad))
    dx = torch.empty((n, c, h, w), device=dy.device, dtype=dy.dtype,
                     memory_format=fmt)
    lib = build.library()
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream(dy.device).cuda_stream
        rc = lib.ptt_max_pool_bwd(
            pick.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            *_geometry(n, c, h, w, oh, ow, ksize, strides, pad, fmt,
                       dy.dtype), stream)
    build.check(rc, 'ptt_max_pool_bwd')
    max_pool_bwd.launches += 1
    return dx


def max_pool_bwd(pick, dy, ksize, strides, pad, size, fmt):
    """The gradient of x [N, C, *size] from dy of its max pool and that
    pool's picks (max_pool_fwd's geometry); on the card dx is laid out
    ``fmt``, x's layout (memory_format(x): the picks of a 1 x 1 output do
    not tell it)."""
    if dy.device.type == 'cpu':
        return max_pool_bwd_reference(pick, dy, ksize, strides, pad, size)
    return _max_pool_bwd_cuda(pick, dy, ksize, strides, pad, size, fmt)


max_pool_bwd.launches = 0
