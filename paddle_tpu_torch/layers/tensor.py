"""Tensor layers (reference: python/paddle/fluid/layers/tensor.py)."""

from ..param_attr import ParamAttr
from .helper import LayerHelper


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper('create_parameter', name=name)
    if attr is None:
        attr = ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)
