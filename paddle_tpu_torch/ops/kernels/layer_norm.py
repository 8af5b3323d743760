"""Fused layer norm: the CUDA kernel ``csrc/layer_norm.cu`` (K1, replacing
``_ln_kernel`` of paddle_tpu/ops/pallas/layer_norm.py) and its plain
PyTorch version ``_ln_reference``.

``fused_layer_norm`` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors; on a CUDA tensor it launches or
raises. ``fused_layer_norm.launches`` counts kernel launches.
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


def fused_layer_norm(x, gamma, beta, eps=1e-5, begin_norm_axis=-1):
    """Normalize over the trailing dims from begin_norm_axis; gamma/beta
    are flat over the normalized extent."""
    shape = x.shape
    if begin_norm_axis < 0:
        begin_norm_axis = x.dim() + begin_norm_axis
    d = 1
    for s in shape[begin_norm_axis:]:
        d *= s
    x2 = x.reshape(-1, d)
    gamma = gamma.reshape(d)
    beta = beta.reshape(d)
    if x2.device.type == 'cpu':
        y = _ln_reference(x2, gamma, beta, eps)
    else:
        y = _ln_cuda(x2, gamma, beta, eps)
    return y.reshape(shape)


fused_layer_norm.launches = 0
