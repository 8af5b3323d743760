"""KV-arena dtype helpers (reference: paddle_tpu quant/core.py). The port
serves fp32 and bf16 arenas; the quantized (int8 / fp8) arenas and their
row quantizer belong to a later slice."""

_KV_ALIASES = {
    '': 'float32', 'fp32': 'float32', 'float32': 'float32',
    'f32': 'float32', 'bf16': 'bfloat16', 'bfloat16': 'bfloat16',
    'int8': 'int8', 'i8': 'int8',
    'fp8': 'float8_e4m3fn', 'f8': 'float8_e4m3fn',
    'float8': 'float8_e4m3fn', 'float8_e4m3fn': 'float8_e4m3fn',
}


def resolve_kv_dtype(arg=None):
    """Canonical KV-arena dtype of ``arg`` (None means fp32)."""
    key = '' if arg is None else str(arg).strip().lower()
    if key not in _KV_ALIASES:
        raise ValueError(
            'kv_dtype %r (expected fp32|bf16|int8|fp8)' % (arg,))
    return _KV_ALIASES[key]


def kv_itemsize(kv_dtype):
    return {'float32': 4, 'bfloat16': 2, 'int8': 1,
            'float8_e4m3fn': 1}[kv_dtype]


def kv_quantized(kv_dtype):
    """True when the arena dtype needs a scale arena alongside."""
    return kv_dtype in ('int8', 'float8_e4m3fn')
