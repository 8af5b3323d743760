"""The gradient of 2-D max pooling with the JAX package's picks (the CUDA
kernels of ``csrc/max_pool.cu``, replacing the select_and_scatter that
XLA makes of the VJP of paddle_tpu/ops/conv_ops.py's reduce_window max)
beside its plain PyTorch version.

Each window, row-major with its padding counted as -inf, is scanned
keeping the pick while pick >= next. That is the first largest element,
but a NaN pick gives way to the next element, so in a window holding a NaN
the pick is the first largest element after its last NaN (the NaN itself
where it comes last). F.max_pool2d's backward would send the gradient to
the last NaN. An element picked by several windows gets the sum of their
gradients.

``max_pool_bwd`` launches its kernels for a CUDA tensor and takes the
plain version only for a CPU one; on a CUDA tensor it launches or raises.
``max_pool_bwd.launches`` counts its calls on the card, each launching the
pick kernel and the gather kernel.
"""

import torch
import torch.nn.functional as F

from . import build


def max_pool_bwd_reference(x, dy, ksize, strides, pad):
    """Plain version: the gradient of x [N, C, H, W] from dy [N, C, OH,
    OW] of the max pool of x over -inf padding ``pad`` (left, right, top,
    bottom) with windows ``ksize`` and ``strides``, by tensor ops over the
    unfolded windows (K = kh·kw times dy's size)."""
    (kh, kw), k = ksize, ksize[0] * ksize[1]
    xp = F.pad(x, pad, value=float('-inf'))
    n, c, oh, ow = dy.shape
    win = xp.unfold(2, kh, strides[0]).unfold(3, kw, strides[1]) \
        .reshape(n, c, oh, ow, k)
    pos = torch.arange(k, device=x.device, dtype=torch.int32)
    last_nan = torch.where(win.isnan(), pos, -1).amax(-1, keepdim=True)
    after = pos > last_nan
    top = torch.where(after, win, float('-inf')).amax(-1, keepdim=True)
    pick = (after & (win == top)).to(torch.uint8).argmax(-1, keepdim=True)
    pick = torch.where(last_nan == k - 1, k - 1, pick)
    cols = torch.zeros(win.shape, dtype=dy.dtype, device=dy.device) \
        .scatter_(-1, pick, dy.unsqueeze(-1))
    dx = F.fold(cols.permute(0, 1, 4, 2, 3).reshape(n, c * k, oh * ow),
                xp.shape[2:], (kh, kw), stride=strides)
    h, w = x.shape[2:]
    return dx[:, :, pad[2]:pad[2] + h, pad[0]:pad[0] + w]


def _max_pool_bwd_cuda(x, dy, ksize, strides, pad):
    if x.dtype not in (torch.float32, torch.bfloat16) or dy.dtype != x.dtype:
        raise TypeError('max_pool_bwd kernel: takes float32 or bfloat16 x '
                        'and dy of its dtype, got %s and %s'
                        % (x.dtype, dy.dtype))
    if x.dim() != 4 or dy.dim() != 4 or dy.device != x.device:
        raise ValueError('max_pool_bwd kernel: x and dy must be 4-D on one '
                         'device')
    if x.numel() >= 2 ** 31 or dy.numel() >= 2 ** 31:
        raise ValueError('max_pool_bwd kernel: indexes in 32 bits, got %d '
                         'elements' % max(x.numel(), dy.numel()))
    fmt = torch.channels_last if (
        x.is_contiguous(memory_format=torch.channels_last) and
        not x.is_contiguous()) else torch.contiguous_format
    x = x.contiguous(memory_format=fmt)
    dy = dy.contiguous(memory_format=fmt)
    dx = torch.empty_like(x, memory_format=fmt)
    n, c, h, w = x.shape
    oh, ow = dy.shape[2:]
    # the kernels' scratch: a window's pick as a byte where it has fewer
    # than 255 places, else as an int32
    pick = torch.empty((n, c, oh, ow), device=x.device, dtype=torch.uint8
                       if ksize[0] * ksize[1] < 255 else torch.int32)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ptt_max_pool_bwd(
            x.data_ptr(), dy.data_ptr(), dx.data_ptr(), pick.data_ptr(), n,
            c, h, w, oh, ow, ksize[0], ksize[1], strides[0], strides[1],
            pad[2], pad[0], int(fmt == torch.channels_last),
            build.dtype_code(x.dtype), stream)
    build.check(rc, 'ptt_max_pool_bwd')
    max_pool_bwd.launches += 1
    return dx


def max_pool_bwd(x, dy, ksize, strides, pad):
    """The gradient of x [N, C, H, W] (NCHW or channels-last) from dy of
    its max pool over -inf padding ``pad`` (left, right, top, bottom; the
    right and bottom ones as far as dy's extent reaches), windows
    ``ksize`` and ``strides``, with the JAX package's picks."""
    if x.device.type == 'cpu':
        return max_pool_bwd_reference(x, dy, ksize, strides, pad)
    return _max_pool_bwd_cuda(x, dy, ksize, strides, pad)


max_pool_bwd.launches = 0
