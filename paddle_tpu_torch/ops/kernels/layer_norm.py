"""Fused layer norm: the CUDA kernels of ``csrc/layer_norm.cu`` — K1,
replacing ``_ln_kernel`` of paddle_tpu/ops/pallas/layer_norm.py, and its
backward, replacing the custom_vjp's ``_ln_vjp_bwd`` there — beside their
plain PyTorch versions ``_ln_reference`` and ``layer_norm_reference_bwd``.

``fused_layer_norm`` launches the kernels for CUDA tensors and takes the
plain versions only for CPU tensors; on a CUDA tensor it launches or
raises. It is differentiable: ``_LayerNorm`` is a torch.autograd.Function
whose forward is K1 and whose backward is two kernels (a row kernel for dx
and fixed-order per-block partials of dgamma and dbeta, then a column kernel
that adds the partials). ``fused_layer_norm.launches`` counts forward
launches, ``fused_layer_norm.bwd_launches`` backward kernel launches (two a
call).
"""

import torch

from . import build


def _ln_reference(x2, gamma, beta, eps):
    """Plain version, a straight translation of the reference's
    _ln_reference: fp32 statistics, y in x's dtype."""
    x = x2.float()
    mean = x.mean(dim=-1, keepdim=True)
    xc = x - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * gamma + beta
    return y.to(x2.dtype)


def _ln_cuda(x2, gamma, beta, eps):
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError('layer_norm kernel: x must be float32 or bfloat16, '
                        'got %s' % x2.dtype)
    n, d = x2.shape
    for name, t in (('gamma', gamma), ('beta', beta)):
        if t.device != x2.device or t.dtype != torch.float32 or \
                t.shape != (d,) or not t.is_contiguous():
            raise ValueError('layer_norm kernel: %s must be a contiguous '
                             'float32 [%d] tensor on %s, got %s %s on %s'
                             % (name, d, x2.device, t.dtype,
                                tuple(t.shape), t.device))
    if not x2.is_contiguous():
        raise ValueError('layer_norm kernel: x must be contiguous')
    y = torch.empty_like(x2)
    if n == 0:
        return y
    lib = build.library()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        rc = lib.ptt_layer_norm(x2.data_ptr(), gamma.data_ptr(),
                                beta.data_ptr(), y.data_ptr(), n, d,
                                float(eps), build.dtype_code(x2.dtype),
                                stream)
    build.check(rc, 'ptt_layer_norm')
    fused_layer_norm.launches += 1
    return y


def _ln_forward(x2, gamma, beta, eps):
    if x2.device.type == 'cpu':
        return _ln_reference(x2, gamma, beta, eps)
    return _ln_cuda(x2, gamma, beta, eps)


def layer_norm_reference_bwd(x2, gamma, beta, gy, eps):
    """Plain version of the backward kernels: the JAX package's
    _ln_vjp_bwd, the gradient of _ln_reference rematerialised under
    autograd. Returns (dx in x's dtype, dgamma, dbeta)."""
    saved = [t.detach().requires_grad_() for t in (x2, gamma, beta)]
    with torch.enable_grad():
        y = _ln_reference(*saved, eps)
        return torch.autograd.grad(y, saved, gy)


def _ln_bwd_cuda(x2, gamma, gy, eps):
    """Launch the backward kernels: (dx, dgamma, dbeta fp32)."""
    n, d = x2.shape
    if gy.dtype != x2.dtype or gy.shape != x2.shape or \
            gy.device != x2.device:
        raise ValueError('layer_norm backward kernel: gy must match x, got '
                         '%s %s on %s' % (gy.dtype, tuple(gy.shape),
                                         gy.device))
    gy = gy.contiguous()
    dx = torch.empty_like(x2)
    dgamma = torch.empty(d, dtype=torch.float32, device=x2.device)
    dbeta = torch.empty_like(dgamma)
    if n == 0:
        return dx, dgamma.zero_(), dbeta.zero_()
    lib = build.library()
    floats = lib.ptt_layer_norm_bwd_workspace(n, d)
    work = torch.empty(floats, dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        rc = lib.ptt_layer_norm_bwd(
            x2.data_ptr(), gy.data_ptr(), gamma.data_ptr(), dx.data_ptr(),
            dgamma.data_ptr(), dbeta.data_ptr(), work.data_ptr(), n, d,
            float(eps), build.dtype_code(x2.dtype), stream)
    build.check(rc, 'ptt_layer_norm_bwd')
    fused_layer_norm.bwd_launches += 2   # the row and the column kernel
    return dx, dgamma, dbeta


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, gamma, beta, eps):
        ctx.save_for_backward(x2, gamma, beta)
        ctx.eps = eps
        return _ln_forward(x2, gamma, beta, eps)

    @staticmethod
    def backward(ctx, gy):
        """_ln_vjp_bwd: the backward kernels on a CUDA tensor, the plain
        version on a CPU one."""
        x2, gamma, beta = ctx.saved_tensors
        if x2.device.type == 'cpu':
            grads = layer_norm_reference_bwd(x2, gamma, beta, gy, ctx.eps)
        else:
            grads = _ln_bwd_cuda(x2, gamma, gy, ctx.eps)
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad[:3])) + (None,)


def fused_layer_norm(x, gamma, beta, eps=1e-5, begin_norm_axis=-1):
    """Normalize over the trailing dims from begin_norm_axis; gamma/beta
    are flat over the normalized extent. Differentiable in x, gamma and
    beta."""
    shape = x.shape
    if begin_norm_axis < 0:
        begin_norm_axis = x.dim() + begin_norm_axis
    d = 1
    for s in shape[begin_norm_axis:]:
        d *= s
    x2 = x.reshape(-1, d).contiguous()
    y = _LayerNorm.apply(x2, gamma.reshape(d), beta.reshape(d), float(eps))
    return y.reshape(shape)


fused_layer_norm.launches = 0
fused_layer_norm.bwd_launches = 0   # the backward's kernels, two a call
