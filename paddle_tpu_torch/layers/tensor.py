"""Tensor layers (reference: paddle_tpu layers/tensor.py;
python/paddle/fluid/layers/tensor.py)."""

import numpy as np

from ..core.dtypes import canonical_dtype
from ..initializer import Constant
from ..param_attr import ParamAttr
from .helper import LayerHelper

__all__ = ['create_tensor', 'create_parameter', 'create_global_var', 'cast',
           'concat', 'sums', 'fill_constant_batch_size_like', 'fill_constant',
           'ones', 'zeros', 'argmax', 'zeros_like', 'ones_like', 'assign',
           'argmin', 'argsort', 'reverse', 'linspace']


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper('create_tensor', name=name)
    return helper.create_variable(name=helper.name, dtype=dtype,
                                  persistable=persistable)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper('create_parameter', name=name)
    if attr is None:
        attr = ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A global var filled with ``value`` by the startup program;
    ``force_cpu`` is accepted and ignored, as in the reference."""
    helper = LayerHelper('global_var', name=name)
    var = helper.create_global_variable(
        dtype=dtype, shape=shape, persistable=persistable, name=name)
    helper.set_variable_initializer(var, Constant(value=float(value)))
    return var


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


def sums(input, out=None):
    """The elementwise sum of the vars in ``input`` (one sum op)."""
    helper = LayerHelper('sum')
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype=input[0].dtype)
        out.shape = input[0].shape
    helper.append_op(type='sum', inputs={'X': input}, outputs={'Out': [out]})
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


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=1.0)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=0.0)


def _filled_like(layer_type, x, value, out):
    """x's shape filled with ``value`` at run time (the batch dim read from
    x by fill_constant_batch_size_like)."""
    helper = LayerHelper(layer_type)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.shape = x.shape
    helper.append_op(type='fill_constant_batch_size_like',
                     inputs={'Input': [x]}, outputs={'Out': [out]},
                     attrs={'shape': [int(s) if s and s > 0 else 1
                                      for s in (x.shape or [1])],
                            'value': value, 'input_dim_idx': 0,
                            'output_dim_idx': 0})
    return out


def zeros_like(x, out=None):
    return _filled_like('zeros_like', x, 0.0, out)


def ones_like(x, out=None):
    return _filled_like('ones_like', x, 1.0, out)


def assign(input, output=None):
    helper = LayerHelper('assign')
    if isinstance(input, np.ndarray) or isinstance(input, (list, tuple)):
        arr = np.asarray(input)
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=str(arr.dtype))
        output.shape = arr.shape
        helper.append_op(type='assign_value', outputs={'Out': [output]},
                         attrs={'values': arr.tolist(),
                                'shape': list(arr.shape)})
    else:
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=input.dtype)
        output.shape = input.shape
        helper.append_op(type='assign', inputs={'X': [input]},
                         outputs={'Out': [output]})
    return output


def argmin(x, axis=-1):
    helper = LayerHelper('argmin')
    out = helper.create_variable_for_type_inference(dtype='int64')
    if x.shape is not None:
        s = list(x.shape)
        s.pop(axis % len(s))
        out.shape = tuple(s)
    helper.append_op(type='argmin', inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'axis': axis})
    return out


def argsort(x, axis=-1):
    helper = LayerHelper('argsort')
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    ids = helper.create_variable_for_type_inference(dtype='int64')
    out.shape = x.shape
    ids.shape = x.shape
    helper.append_op(type='argsort', inputs={'X': [x]},
                     outputs={'Out': [out], 'Indices': [ids]},
                     attrs={'axis': axis})
    return out, ids


def reverse(x, axis):
    helper = LayerHelper('reverse')
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.shape = x.shape
    helper.append_op(type='reverse', inputs={'X': [x]},
                     outputs={'Out': [out]},
                     attrs={'axis': axis if isinstance(axis, (list, tuple))
                            else [axis]})
    return out


def linspace(start, stop, num, dtype='float32'):
    helper = LayerHelper('linspace')
    out = helper.create_variable_for_type_inference(
        dtype=canonical_dtype(dtype))
    out.shape = (int(num),)
    helper.append_op(type='linspace', outputs={'Out': [out]},
                     attrs={'start': float(start), 'stop': float(stop),
                            'num': int(num)})
    return out
