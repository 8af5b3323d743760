"""Tensor layers (reference: python/paddle/fluid/layers/tensor.py)."""

from ..core.dtypes import canonical_dtype
from ..param_attr import ParamAttr
from .helper import LayerHelper

__all__ = ['create_parameter', 'cast']


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
