"""Thin layers over one op each (reference: paddle_tpu layers/ops.py;
fluid/layers/ops.py): elementwise add, mul and div, reshape, scale and
mean."""

from .helper import LayerHelper

__all__ = ['elementwise_add', 'elementwise_mul', 'elementwise_div',
           'reshape', 'scale', 'mean']


def _single_op(op_type, x, attrs=None):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type=op_type, inputs={'X': [x]}, outputs={'Out': [out]},
                     attrs=attrs or {})
    return out


def _binary_op(op_type, x, y, axis=-1):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type=op_type, inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [out]}, attrs={'axis': axis})
    return out


def _maybe_act(out, act):
    return out if act is None else _single_op(act, out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _maybe_act(_binary_op('elementwise_add', x, y, axis), act)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _maybe_act(_binary_op('elementwise_mul', x, y, axis), act)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _maybe_act(_binary_op('elementwise_div', x, y, axis), act)


def mean(x, name=None):
    helper = LayerHelper('mean', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = (1,)
    helper.append_op(type='mean', inputs={'X': [x]}, outputs={'Out': [out]})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    """fluid reshape: 0 copies the input's dim, one -1 is inferred."""
    helper = LayerHelper('reshape', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    new_shape = list(shape)
    if x.shape is not None:
        for i, s in enumerate(new_shape):
            if s == 0:
                new_shape[i] = x.shape[i]
        if -1 in new_shape and all(d is not None and d >= 0
                                   for d in x.shape):
            total = 1
            for d in x.shape:
                total *= d
            known = 1
            for s in new_shape:
                if s != -1:
                    known *= s
            new_shape = [total // known if s == -1 else s
                         for s in new_shape]
        out.shape = tuple(new_shape)
    helper.append_op(type='reshape', inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'shape': list(shape)})
    return _maybe_act(out, act)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    out = _single_op('scale', x, {'scale': float(scale), 'bias': float(bias),
                                  'bias_after_scale': bias_after_scale})
    return _maybe_act(out, act)
