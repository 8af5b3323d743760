"""Thin layers over one op each (reference: paddle_tpu layers/ops.py;
fluid/layers/ops.py and layer_function_generator.py): the generated unary
activations, the elementwise and logical layers, mul, mean, reshape,
scale, the clips, softmax, cumsum, the sigmoid cross-entropy and the
random fills. The same names, signatures, ops and attributes as the JAX
package's."""

from ..core.dtypes import canonical_dtype
from .helper import LayerHelper

_UNARY_OPS = [
    'sigmoid', 'logsigmoid', 'exp', 'relu', 'tanh', 'tanh_shrink',
    'softshrink', 'sqrt', 'rsqrt', 'abs', 'ceil', 'floor', 'round',
    'reciprocal', 'log', 'square', 'softplus', 'softsign', 'brelu',
    'leaky_relu', 'soft_relu', 'elu', 'relu6', 'pow', 'stanh',
    'hard_shrink', 'thresholded_relu', 'hard_sigmoid', 'swish', 'gelu',
    'mish', 'sin', 'cos',
]

__all__ = list(_UNARY_OPS) + [
    'mean', 'mul', 'reshape', 'scale', 'sigmoid_cross_entropy_with_logits',
    'elementwise_add', 'elementwise_div', 'elementwise_sub',
    'elementwise_mul', 'elementwise_max', 'elementwise_min',
    'elementwise_pow', 'clip', 'clip_by_norm', 'softmax',
    'logical_and', 'logical_or', 'logical_xor', 'logical_not',
    'uniform_random', 'uniform_random_batch_size_like', 'gaussian_random',
    'gaussian_random_batch_size_like', 'cumsum',
]


def _single_op(op_type, x, attrs=None):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type=op_type, inputs={'X': [x]}, outputs={'Out': [out]},
                     attrs=attrs or {})
    return out


def _make_unary(op_type):
    def layer(x, name=None, **attrs):
        return _single_op(op_type, x, attrs)
    layer.__name__ = op_type
    layer.__doc__ = 'Elementwise %s (activation_op.cc); keyword arguments ' \
        'are the op\'s attributes.' % op_type
    return layer


_g = globals()
for _name in _UNARY_OPS:
    _g[_name] = _make_unary(_name)


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


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _maybe_act(_binary_op('elementwise_sub', x, y, axis), act)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _maybe_act(_binary_op('elementwise_mul', x, y, axis), act)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _maybe_act(_binary_op('elementwise_div', x, y, axis), act)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _maybe_act(_binary_op('elementwise_max', x, y, axis), act)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _maybe_act(_binary_op('elementwise_min', x, y, axis), act)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _maybe_act(_binary_op('elementwise_pow', x, y, axis), act)


def mean(x, name=None):
    helper = LayerHelper('mean', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = (1,)
    helper.append_op(type='mean', inputs={'X': [x]}, outputs={'Out': [out]})
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper('mul', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None and y.shape is not None:
        out.shape = tuple(x.shape[:x_num_col_dims]) + \
            tuple(y.shape[y_num_col_dims:])
    helper.append_op(type='mul', inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [out]},
                     attrs={'x_num_col_dims': x_num_col_dims,
                            'y_num_col_dims': y_num_col_dims})
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


def sigmoid_cross_entropy_with_logits(x, label, name=None):
    helper = LayerHelper('sigmoid_cross_entropy_with_logits', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type='sigmoid_cross_entropy_with_logits',
                     inputs={'X': [x], 'Label': [label]},
                     outputs={'Out': [out]})
    return out


def clip(x, min, max, name=None):
    return _single_op('clip', x, {'min': float(min), 'max': float(max)})


def clip_by_norm(x, max_norm, name=None):
    return _single_op('clip_by_norm', x, {'max_norm': float(max_norm)})


def softmax(input, name=None):
    return _single_op('softmax', input)


def _logical(op_type, x, y=None):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference('bool')
    out.shape = x.shape
    inputs = {'X': [x]} if y is None else {'X': [x], 'Y': [y]}
    helper.append_op(type=op_type, inputs=inputs, outputs={'Out': [out]})
    return out


def logical_and(x, y, out=None, name=None):
    return _logical('logical_and', x, y)


def logical_or(x, y, out=None, name=None):
    return _logical('logical_or', x, y)


def logical_xor(x, y, out=None, name=None):
    return _logical('logical_xor', x, y)


def logical_not(x, out=None, name=None):
    return _logical('logical_not', x)


def uniform_random(shape, dtype='float32', min=-1.0, max=1.0, seed=0):
    helper = LayerHelper('uniform_random')
    out = helper.create_variable_for_type_inference(canonical_dtype(dtype))
    out.shape = tuple(shape)
    helper.append_op(type='uniform_random', outputs={'Out': [out]},
                     attrs={'shape': list(shape), 'min': float(min),
                            'max': float(max), 'seed': seed})
    return out


def _random_batch_size_like(op_type, input, shape, dtype, input_dim_idx,
                            output_dim_idx, attrs):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(canonical_dtype(dtype))
    s = list(shape)
    if input.shape is not None:
        s[output_dim_idx] = input.shape[input_dim_idx]
    out.shape = tuple(s)
    attrs = dict(attrs, shape=list(shape), input_dim_idx=input_dim_idx,
                 output_dim_idx=output_dim_idx)
    helper.append_op(type=op_type, inputs={'Input': [input]},
                     outputs={'Out': [out]}, attrs=attrs)
    return out


def uniform_random_batch_size_like(input, shape, dtype='float32',
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    return _random_batch_size_like(
        'uniform_random_batch_size_like', input, shape, dtype,
        input_dim_idx, output_dim_idx,
        {'min': float(min), 'max': float(max), 'seed': seed})


def gaussian_random(shape, dtype='float32', mean=0.0, std=1.0, seed=0):
    helper = LayerHelper('gaussian_random')
    out = helper.create_variable_for_type_inference(canonical_dtype(dtype))
    out.shape = tuple(shape)
    helper.append_op(type='gaussian_random', outputs={'Out': [out]},
                     attrs={'shape': list(shape), 'mean': float(mean),
                            'std': float(std), 'seed': seed})
    return out


def gaussian_random_batch_size_like(input, shape, dtype='float32',
                                    input_dim_idx=0, output_dim_idx=0,
                                    mean=0.0, std=1.0, seed=0):
    return _random_batch_size_like(
        'gaussian_random_batch_size_like', input, shape, dtype,
        input_dim_idx, output_dim_idx,
        {'mean': float(mean), 'std': float(std), 'seed': seed})


def cumsum(x, axis=-1, exclusive=False, reverse=False):
    return _single_op('cumsum', x, {'axis': axis, 'exclusive': exclusive,
                                    'reverse': reverse})
