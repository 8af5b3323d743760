"""Data layers (reference: python/paddle/fluid/layers/io.py)."""

from ..core.dtypes import canonical_dtype
from .helper import LayerHelper

__all__ = ['data']


def data(name, shape, dtype='float32', lod_level=0, append_batch_size=True,
         stop_gradient=True):
    helper = LayerHelper('data', name=name)
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    var = helper.main_program.global_block().create_var(
        name=name, shape=tuple(shape), dtype=canonical_dtype(dtype),
        lod_level=lod_level, is_data=True)
    var.stop_gradient = stop_gradient
    return var
