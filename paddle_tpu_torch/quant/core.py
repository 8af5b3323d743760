"""KV-arena dtype helpers and the per-row KV quantizer (reference:
paddle_tpu quant/core.py).

Per-row quantization (KV pages): one fp32 scale per written (token, head)
K/V row, so a page's content is a pure function of the tokens written into
it; batch composition, speculation depth and cache sharing cannot perturb
it. Rounding is deterministic for the same reason.

Knob: ``PADDLE_TPU_KV_DTYPE`` (read per call by ``resolve_kv_dtype``, never
at import).
"""

import os

import torch

QMAX_INT8 = 127.0
QMAX_FP8 = 448.0          # float8_e4m3fn finite max
_EPS = 1e-30              # scale floor: an all-zero row stays zero

__all__ = ['QMAX_INT8', 'QMAX_FP8', 'quantize_rows', 'resolve_kv_dtype',
           'kv_itemsize', 'kv_quantized', 'kv_fp8_supported']

_KV_ALIASES = {
    '': 'float32', 'fp32': 'float32', 'float32': 'float32',
    'f32': 'float32', 'bf16': 'bfloat16', 'bfloat16': 'bfloat16',
    'int8': 'int8', 'i8': 'int8',
    'fp8': 'float8_e4m3fn', 'f8': 'float8_e4m3fn',
    'float8': 'float8_e4m3fn', 'float8_e4m3fn': 'float8_e4m3fn',
}


def resolve_kv_dtype(arg=None):
    """Canonical KV-arena dtype: an explicit ``arg`` (engine constructor)
    wins, else ``PADDLE_TPU_KV_DTYPE`` (read here, per call), else fp32."""
    raw = arg if arg is not None else \
        os.environ.get('PADDLE_TPU_KV_DTYPE', '')
    key = str(raw).strip().lower()
    if key not in _KV_ALIASES:
        raise ValueError(
            'kv_dtype %r (expected fp32|bf16|int8|fp8)' % (raw,))
    out = _KV_ALIASES[key]
    if out == 'float8_e4m3fn' and not kv_fp8_supported():
        raise ValueError('kv_dtype fp8 requested but this torch build has '
                         'no float8_e4m3fn; use int8')
    return out


def kv_fp8_supported():
    return hasattr(torch, 'float8_e4m3fn')


def kv_itemsize(kv_dtype):
    return {'float32': 4, 'bfloat16': 2, 'int8': 1,
            'float8_e4m3fn': 1}[kv_dtype]


def kv_quantized(kv_dtype):
    """True when the arena dtype needs a scale arena alongside."""
    return kv_dtype in ('int8', 'float8_e4m3fn')


def quantize_rows(x, kv_dtype):
    """Quantize ``[..., D]`` rows independently: one fp32 scale per
    leading index. Returns ``(q, scales)``: q int8 (round half to even,
    clamped to +-127) or float8_e4m3fn, scales fp32 ``[...]``. Both
    divisions are true divisions, as the reference's, so both give the
    same bits (and so does the KV-write kernel, ops/kernels/kv_write.py)."""
    x = x.float()
    amax = torch.clamp(x.abs().amax(dim=-1), min=_EPS)
    # amax / qmax over a 0-dim tensor: torch divides a CUDA tensor by a
    # Python scalar as a product with its reciprocal, which rounds
    # otherwise than the division the reference (and the KV-write kernel)
    # takes
    if kv_dtype == 'int8':
        s = amax / amax.new_full((), QMAX_INT8)
        q = torch.clamp(torch.round(x / s[..., None]),
                        -QMAX_INT8, QMAX_INT8).to(torch.int8)
    elif kv_dtype == 'float8_e4m3fn':
        s = amax / amax.new_full((), QMAX_FP8)
        q = (x / s[..., None]).to(torch.float8_e4m3fn)
    else:
        raise ValueError('quantize_rows: %r is not a quantized kv dtype'
                         % (kv_dtype,))
    return q, s
