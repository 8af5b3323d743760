"""Tensor layers (reference: paddle_tpu layers/tensor.py;
python/paddle/fluid/layers/tensor.py)."""

from ..core.dtypes import canonical_dtype
from ..param_attr import ParamAttr
from .helper import LayerHelper

__all__ = ['create_parameter', 'cast', 'concat', 'fill_constant',
           'fill_constant_batch_size_like', 'argmax']


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper('create_parameter', name=name)
    if attr is None:
        attr = ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def cast(x, dtype):
    helper = LayerHelper('cast')
    out = helper.create_variable_for_type_inference(
        dtype=canonical_dtype(dtype))
    out.shape = x.shape
    helper.append_op(type='cast', inputs={'X': [x]}, outputs={'Out': [out]},
                     attrs={'out_dtype': canonical_dtype(dtype)})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper('concat', name=name)
    out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    shapes = [list(v.shape) for v in input if v.shape is not None]
    if shapes:
        shape = list(shapes[0])
        ax = axis % len(shape)
        sizes = [s[ax] for s in shapes]
        shape[ax] = -1 if any(d is None or d < 0 for d in sizes) else \
            sum(sizes)
        out.shape = tuple(shape)
    helper.append_op(type='concat', inputs={'X': input},
                     outputs={'Out': [out]}, attrs={'axis': axis})
    return out


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper('fill_constant')
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype=canonical_dtype(dtype))
    out.shape = tuple(int(s) for s in shape)
    helper.append_op(type='fill_constant', outputs={'Out': [out]},
                     attrs={'shape': [int(s) for s in shape],
                            'value': float(value)})
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper('fill_constant_batch_size_like')
    out = helper.create_variable_for_type_inference(
        dtype=canonical_dtype(dtype))
    s = list(shape)
    if input.shape is not None:
        s[output_dim_idx] = input.shape[input_dim_idx]
    out.shape = tuple(s)
    helper.append_op(type='fill_constant_batch_size_like',
                     inputs={'Input': [input]}, outputs={'Out': [out]},
                     attrs={'shape': [int(v) for v in shape],
                            'value': float(value),
                            'input_dim_idx': input_dim_idx,
                            'output_dim_idx': output_dim_idx})
    return out


def argmax(x, axis=-1):
    helper = LayerHelper('argmax')
    out = helper.create_variable_for_type_inference(dtype='int64')
    if x.shape is not None:
        s = list(x.shape)
        s.pop(axis % len(s))
        out.shape = tuple(s)
    helper.append_op(type='argmax', inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'axis': axis})
    return out
