"""Dtype handling for the IR.

The IR stores dtypes as canonical strings (the same strings as the
reference's ``data_type.h`` enum, with bfloat16 and float8_e4m3fn added);
execution converts them to torch dtypes.
"""

import numpy as np
import torch

_CANONICAL = {
    'float16': 'float16',
    'fp16': 'float16',
    'bfloat16': 'bfloat16',
    'bf16': 'bfloat16',
    'float32': 'float32',
    'fp32': 'float32',
    'float': 'float32',
    'float64': 'float64',
    'fp64': 'float64',
    'double': 'float64',
    'int8': 'int8',
    'uint8': 'uint8',
    'fp8': 'float8_e4m3fn',
    'float8': 'float8_e4m3fn',
    'float8_e4m3fn': 'float8_e4m3fn',
    'int16': 'int16',
    'int32': 'int32',
    'int': 'int32',
    'int64': 'int64',
    'long': 'int64',
    'bool': 'bool',
}

_TORCH = {
    'float16': torch.float16,
    'bfloat16': torch.bfloat16,
    'float32': torch.float32,
    'float64': torch.float64,
    'int8': torch.int8,
    'uint8': torch.uint8,
    'float8_e4m3fn': torch.float8_e4m3fn,
    'int16': torch.int16,
    'int32': torch.int32,
    'int64': torch.int64,
    'bool': torch.bool,
}


def canonical_dtype(dtype):
    """Normalize a user-provided dtype (string / numpy / torch dtype) to a
    canonical string."""
    if dtype is None:
        return 'float32'
    if isinstance(dtype, str):
        key = dtype.lower()
    elif isinstance(dtype, torch.dtype):
        key = str(dtype).replace('torch.', '')
    else:
        try:
            key = np.dtype(dtype).name
        except TypeError:
            key = str(dtype)
    if key not in _CANONICAL:
        raise ValueError('Unsupported dtype: %r' % (dtype,))
    return _CANONICAL[key]


def to_torch_dtype(dtype):
    """Canonical string (or anything canonical_dtype takes) -> torch.dtype."""
    return _TORCH[canonical_dtype(dtype)]

