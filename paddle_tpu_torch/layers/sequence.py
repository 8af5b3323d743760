"""Sequence layers over padded batches with an optional length var
(reference: paddle_tpu layers/sequence.py; fluid's sequence_* layers over
LoD tensors): [batch, max_len, ...] arrays, the ops in
ops/sequence_ops.py."""

from .helper import LayerHelper

__all__ = [
    'sequence_pool', 'sequence_softmax', 'sequence_expand', 'sequence_conv',
    'sequence_first_step', 'sequence_last_step', 'sequence_reshape',
    'sequence_concat', 'sequence_slice',
]


def _seq_op(op_type, x, length=None, attrs=None, out_shape=None):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(x.dtype)
    if out_shape is not None:
        out.shape = out_shape
    inputs = {'X': [x]}
    if length is not None:
        inputs['Length'] = [length]
    helper.append_op(type=op_type, inputs=inputs, outputs={'Out': [out]},
                     attrs=attrs or {})
    return out


def sequence_pool(input, pool_type, length=None):
    shape = None
    if input.shape is not None and len(input.shape) >= 3:
        shape = (input.shape[0],) + tuple(input.shape[2:])
    return _seq_op('sequence_pool', input, length,
                   {'pooltype': pool_type.upper()}, shape)


def sequence_first_step(input, length=None):
    return sequence_pool(input, 'first', length)


def sequence_last_step(input, length=None):
    return sequence_pool(input, 'last', length)


def sequence_softmax(input, length=None):
    return _seq_op('sequence_softmax', input, length, None, input.shape)


def sequence_expand(x, y, ref_level=-1):
    helper = LayerHelper('sequence_expand')
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None and y.shape is not None and len(y.shape) >= 2:
        out.shape = (x.shape[0], y.shape[1], x.shape[-1])
    helper.append_op(type='sequence_expand', inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [out]}, attrs={'ref_level': ref_level})
    return out


def sequence_reshape(input, new_dim):
    helper = LayerHelper('sequence_reshape')
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape is not None:
        b, t, d = input.shape
        if t and t > 0 and d and d > 0:
            out.shape = (b, t * d // new_dim, new_dim)
    helper.append_op(type='sequence_reshape', inputs={'X': [input]},
                     outputs={'Out': [out]}, attrs={'new_dim': new_dim})
    return out


def sequence_concat(input, name=None):
    helper = LayerHelper('sequence_concat', name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type='sequence_concat', inputs={'X': input},
                     outputs={'Out': [out]})
    return out


def sequence_slice(input, offset, length, name=None):
    return _seq_op('sequence_slice', input, None,
                   {'offset': offset, 'length': length})


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  name=None):
    helper = LayerHelper('sequence_conv', **locals())
    dtype = input.dtype
    d = input.shape[-1]
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[filter_size * d, num_filters],
                                dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    if input.shape is not None:
        out.shape = (input.shape[0], input.shape[1], num_filters)
    helper.append_op(
        type='sequence_conv',
        inputs={'X': [input], 'Filter': [w]},
        outputs={'Out': [out]},
        attrs={'contextLength': filter_size,
               'contextStart': -(filter_size // 2),
               'contextStride': filter_stride})
    if bias_attr is not False:
        b = helper.create_parameter(attr=helper.bias_attr,
                                    shape=[num_filters], dtype=dtype,
                                    is_bias=True)
        tmp = helper.create_variable_for_type_inference(dtype)
        tmp.shape = out.shape
        helper.append_op(type='elementwise_add',
                         inputs={'X': [out], 'Y': [b]},
                         outputs={'Out': [tmp]}, attrs={'axis': -1})
        out = tmp
    return helper.append_activation(out)
