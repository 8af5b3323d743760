"""Training batch norm: the CUDA kernels of ``csrc/batch_norm.cu`` — K5,
replacing ``_bn_kernel`` of paddle_tpu/ops/pallas/batch_norm.py, and its
backward, replacing the custom_vjp's ``_bn_vjp_bwd`` there — beside their
plain PyTorch versions ``_bn_reference`` and ``batch_norm_reference_bwd``.

``fused_batch_norm_train`` launches the kernel for CUDA tensors and takes
the plain version only for CPU tensors; on a CUDA tensor it launches or
raises (also when the card refuses the kernel's cooperative launch).
``fused_batch_norm_train.launches`` counts kernel launches: one a call, a
single cooperative kernel that computes the statistics, waits on a
grid-wide barrier and normalizes, reading x from device memory once where
it fits the blocks' shared memory.

Both work on the [N, C, S] view of the activation (S = H·W, or 1 for
[N, C]), so NHWC and NCHW reach the kernel without a transpose; y keeps
x's memory layout. It is differentiable in x, scale and bias:
``_BatchNormTrain`` is a torch.autograd.Function whose backward launches
the backward kernel on a CUDA tensor (one cooperative launch a call, counted
by ``fused_batch_norm_train.bwd_launches``: the deterministic [chunks, C]
partials of dbias and dscale, a grid barrier, dx) and takes
``batch_norm_reference_bwd`` only for a CPU tensor. A gradient whose
layout is not x's is copied into x's layout once first
(``fused_batch_norm_train.bwd_gy_copies`` counts those). mean and var are
not differentiable (they feed the detached running statistics).
"""

import ctypes

import torch

from . import build


def _bn_reference(x3, scale, bias, eps):
    """Plain version over the [N, C, S] view: the JAX package's
    _bn_reference (fp32 sum and sum of squares, var = E[x²] − mean², a =
    γ·rsqrt(var + eps), b = β − mean·a), with the kernel's clamp var ≥ 0
    and its rounding points for y: fp32 x gives x·a + b in fp32; bf16 x
    rounds a and b to bf16 and then the product and the sum, as the Pallas
    kernel does (batch_norm.py:92-94; rounding once in fp32 would differ by
    several bf16 ulps where x·a and b cancel)."""
    xf = x3.float()
    mean = xf.mean(dim=(0, 2))
    var = torch.clamp_min((xf * xf).mean(dim=(0, 2)) - mean * mean, 0.0)
    a = scale.float() * torch.rsqrt(var + eps)
    b = bias.float() - mean * a
    a, b = a[:, None], b[:, None]
    if x3.dtype == torch.float32:
        y = xf * a + b
    else:
        y = x3 * a.to(x3.dtype) + b.to(x3.dtype)
    return y, mean, var


def _channels_last(x3):
    """True when the [N, C, S] view is dense with channels innermost (the
    kernel's rows order), False when dense with S innermost (planes);
    raises for anything else."""
    if x3.shape[2] > 1 and x3.is_contiguous():
        return False
    if x3.transpose(1, 2).is_contiguous():
        return True
    raise ValueError('batch_norm kernel: x must be dense in NHWC or NCHW '
                     'order, got strides %s for [N, C, S] %s'
                     % (x3.stride(), tuple(x3.shape)))


def _bn_cuda(x3, scale, bias, eps):
    if x3.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError('batch_norm kernel: x must be float32 or bfloat16, '
                        'got %s' % x3.dtype)
    n, c, s = x3.shape
    for name, t in (('scale', scale), ('bias', bias)):
        if t.device != x3.device or t.dtype != torch.float32 or \
                t.shape != (c,) or not t.is_contiguous():
            raise ValueError('batch_norm kernel: %s must be a contiguous '
                             'float32 [%d] tensor on %s, got %s %s on %s'
                             % (name, c, x3.device, t.dtype, tuple(t.shape),
                                t.device))
    if n * s == 0:
        raise ValueError('batch_norm kernel: no elements to normalize over '
                         '(x %s)' % (tuple(x3.shape),))
    rows = _channels_last(x3)
    y = torch.empty_like(x3)     # x's strides: the same order
    mean = torch.empty(c, dtype=torch.float32, device=x3.device)
    var = torch.empty_like(mean)
    floats = _workspace(x3, y)
    work = torch.empty(floats, dtype=torch.float32, device=x3.device)
    with torch.cuda.device(x3.device):
        stream = torch.cuda.current_stream(x3.device).cuda_stream
        rc = build.library().ptt_batch_norm_train(
            x3.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            mean.data_ptr(), var.data_ptr(), work.data_ptr(), floats, n, c,
            s, int(rows), float(eps), build.dtype_code(x3.dtype), stream)
    build.check(rc, 'ptt_batch_norm_train')
    fused_batch_norm_train.launches += 1
    return y, mean, var


def _workspace(x3, y, plan=None, gy=None):
    """fp32 floats of workspace the forward kernel needs for x3 -> y on
    x3's card, or with ``gy`` the backward kernel for (x3, gy) -> dx = y
    (the launch's split written to ``plan``, a ctypes int[6], if given);
    raises when the card cannot launch the kernel cooperatively."""
    n, c, s = x3.shape
    with torch.cuda.device(x3.device):
        floats = build.library().ptt_batch_norm_workspace(
            x3.data_ptr(), y.data_ptr(),
            None if gy is None else gy.data_ptr(), n, c, s,
            int(_channels_last(x3)), build.dtype_code(x3.dtype), plan)
    if floats < 0:
        raise RuntimeError('batch_norm kernel: the device cannot launch it '
                           'cooperatively')
    return floats


def launch_plan(x3, backward=False):
    """How the forward kernel (or with ``backward`` the backward kernel,
    for a gradient in x's layout) splits the CUDA tensor x3 ([N, C, S]
    view) on its card: {'vec', 'chunks', 'items', 'blocks', 'on_chip',
    'card_blocks'} (on_chip: x, and gy, are staged in shared memory and
    read from device memory once), for outputs allocated as the wrappers
    allocate them."""
    plan = (ctypes.c_int * 6)()
    out = torch.empty_like(x3)
    _workspace(x3, out, plan, gy=torch.empty_like(x3) if backward else None)
    return dict(zip(('vec', 'chunks', 'items', 'blocks', 'on_chip',
                     'card_blocks'), plan))


def batch_norm_reference_bwd(x3, gy, scale, mean, var, eps):
    """Plain version of the backward kernel, the closed form of the JAX
    package's _bn_vjp_bwd over the [N, C, S] view, in fp32: dbias = Σ gy,
    dscale = Σ gy·x̂, dx = γ·inv·(gy − dbias/n − x̂·dscale/n). Returns (dx
    in x's dtype, dscale and dbias in scale's dtype)."""
    n = x3.shape[0] * x3.shape[2]
    inv = torch.rsqrt(var + eps)[:, None]
    gyf = gy.float()
    xhat = (x3.float() - mean[:, None]) * inv
    dbias = gyf.sum(dim=(0, 2))
    dscale = (gyf * xhat).sum(dim=(0, 2))
    dx = (scale.float()[:, None] * inv) * (
        gyf - dbias[:, None] / n - xhat * (dscale[:, None] / n))
    return (dx.to(x3.dtype), dscale.to(scale.dtype), dbias.to(scale.dtype))


def _bn_bwd_cuda(x3, gy, scale, mean, var, eps):
    """Launch the backward kernel: (dx in x's layout and dtype, dscale,
    dbias fp32 [C])."""
    n, c, s = x3.shape
    if gy.dtype != x3.dtype or gy.shape != x3.shape or \
            gy.device != x3.device:
        raise ValueError('batch_norm backward kernel: gy must match x, got '
                         '%s %s on %s' % (gy.dtype, tuple(gy.shape),
                                         gy.device))
    if scale.dtype != torch.float32:
        raise ValueError('batch_norm backward kernel: scale must be float32')
    if gy.stride() != x3.stride():
        # the kernel walks gy in x's order: one counted copy into it
        gy = torch.empty_like(x3).copy_(gy)
        fused_batch_norm_train.bwd_gy_copies += 1
    dx = torch.empty_like(x3)
    dscale = torch.empty(c, dtype=torch.float32, device=x3.device)
    dbias = torch.empty_like(dscale)
    floats = _workspace(x3, dx, gy=gy)
    work = torch.empty(floats, dtype=torch.float32, device=x3.device)
    with torch.cuda.device(x3.device):
        stream = torch.cuda.current_stream(x3.device).cuda_stream
        rc = build.library().ptt_batch_norm_bwd(
            x3.data_ptr(), gy.data_ptr(), scale.data_ptr(), mean.data_ptr(),
            var.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
            dbias.data_ptr(), work.data_ptr(), floats, n, c, s,
            int(_channels_last(x3)), float(eps), build.dtype_code(x3.dtype),
            stream)
    build.check(rc, 'ptt_batch_norm_bwd')
    fused_batch_norm_train.bwd_launches += 1
    return dx, dscale, dbias


def _bn_forward(x3, scale, bias, eps):
    if x3.device.type == 'cpu':
        return _bn_reference(x3, scale, bias, eps)
    return _bn_cuda(x3, scale, bias, eps)


class _BatchNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x3, scale, bias, eps):
        y, mean, var = _bn_forward(x3, scale, bias, eps)
        ctx.save_for_backward(x3, scale, mean, var)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        """_bn_vjp_bwd: the backward kernel on a CUDA tensor, the plain
        version on a CPU one."""
        x3, scale, mean, var = ctx.saved_tensors
        if x3.device.type == 'cpu':
            grads = batch_norm_reference_bwd(x3, gy, scale, mean, var,
                                             ctx.eps)
        else:
            grads = _bn_bwd_cuda(x3, gy, scale, mean, var, ctx.eps)
        return grads + (None,)


def fused_batch_norm_train(x, scale, bias, eps, layout='NHWC'):
    """Training-mode batch norm of x: [N, H, W, C] (NHWC), [N, C, H, W]
    (NCHW) or [N, C]. Returns (y, batch mean, biased batch variance): y in
    x's dtype, shape and memory layout, the statistics fp32 [C]."""
    if x.dim() == 2:
        x3 = x.unsqueeze(-1)
    else:
        x4 = x.permute(0, 3, 1, 2) if layout == 'NHWC' else x
        n, c, h, w = x4.shape
        x3 = x4.view(n, c, h * w)
    y3, mean, var = _BatchNormTrain.apply(x3, scale, bias, float(eps))
    if x.dim() == 2:
        return y3.squeeze(-1), mean, var
    y4 = y3.view(n, c, h, w)
    return (y4.permute(0, 2, 3, 1) if layout == 'NHWC' else y4), mean, var


fused_batch_norm_train.launches = 0
fused_batch_norm_train.bwd_launches = 0    # the backward kernel
fused_batch_norm_train.bwd_gy_copies = 0   # gradients copied to x's layout
