"""Neural-net layers the training path builds (reference: paddle_tpu
layers/nn.py; python/paddle/fluid/layers/nn.py). Same ops, slots and
attributes as the JAX package's layer functions."""

from ..initializer import Constant
from .helper import LayerHelper

__all__ = ['fc', 'embedding', 'layer_norm', 'dropout',
           'label_smoothed_cross_entropy', 'softmax_with_cross_entropy',
           'reduce_sum']


def _prod(xs):
    out = 1
    for x in xs:
        out *= x
    return out


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """Fully-connected layer: one mul op per input, their sum, a bias and
    an activation (reference fluid/layers/nn.py:fc)."""
    helper = LayerHelper('fc', **locals())
    dtype = helper.input_dtype()
    inputs = input if isinstance(input, (list, tuple)) else [input]
    param_attrs = helper.param_attr
    if not isinstance(param_attrs, list):
        param_attrs = [param_attrs] * len(inputs)

    mul_results = []
    for inp, pattr in zip(inputs, param_attrs):
        in_shape = inp.shape
        w = helper.create_parameter(
            attr=pattr, shape=[_prod(in_shape[num_flatten_dims:]), size],
            dtype=dtype)
        tmp = helper.create_variable_for_type_inference(dtype)
        tmp.shape = tuple(in_shape[:num_flatten_dims]) + (size,)
        helper.append_op(
            type='mul', inputs={'X': [inp], 'Y': [w]},
            outputs={'Out': [tmp]},
            attrs={'x_num_col_dims': num_flatten_dims, 'y_num_col_dims': 1})
        mul_results.append(tmp)

    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        pre_bias.shape = mul_results[0].shape
        helper.append_op(type='sum', inputs={'X': mul_results},
                         outputs={'Out': [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, [size], axis=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype='float32'):
    """Embedding lookup (lookup_table op). Its gradient is dense:
    ``is_sparse`` and ``is_distributed`` are recorded in the op's attrs
    but select no other path."""
    helper = LayerHelper('embedding', **locals())
    w = helper.create_parameter(attr=helper.param_attr, shape=size,
                                dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    in_shape = input.shape
    if in_shape is not None:
        base = in_shape[:-1] if in_shape[-1] == 1 else in_shape
        out.shape = tuple(base) + (size[1],)
    if padding_idx is None:
        padding_idx = -1
    elif padding_idx < 0:
        padding_idx = size[0] + padding_idx
    helper.append_op(
        type='lookup_table', inputs={'W': [w], 'Ids': [input]},
        outputs={'Out': [out]},
        attrs={'is_sparse': is_sparse, 'padding_idx': padding_idx})
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper('layer_norm', **locals())
    dtype = input.dtype
    norm_shape = [_prod(input.shape[begin_norm_axis:])]
    inputs = {'X': [input]}
    if scale:
        inputs['Scale'] = [helper.create_parameter(
            attr=helper.param_attr, shape=norm_shape, dtype=dtype,
            default_initializer=Constant(1.0))]
    if shift:
        inputs['Bias'] = [helper.create_parameter(
            attr=helper.bias_attr, shape=norm_shape, dtype=dtype,
            is_bias=True)]
    mean = helper.create_variable_for_type_inference(dtype)
    variance = helper.create_variable_for_type_inference(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = input.shape
    helper.append_op(type='layer_norm', inputs=inputs,
                     outputs={'Y': [out], 'Mean': [mean],
                              'Variance': [variance]},
                     attrs={'begin_norm_axis': begin_norm_axis,
                            'epsilon': epsilon})
    return helper.append_activation(out)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation='downgrade_in_infer'):
    helper = LayerHelper('dropout', **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    mask = helper.create_variable_for_type_inference(x.dtype)
    mask.stop_gradient = True
    helper.append_op(
        type='dropout', inputs={'X': [x]},
        outputs={'Out': [out], 'Mask': [mask]},
        attrs={'dropout_prob': dropout_prob, 'is_test': is_test,
               'seed': seed if seed is not None else 0,
               'dropout_implementation': dropout_implementation})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, return_softmax=False):
    helper = LayerHelper('softmax_with_cross_entropy')
    softmax = helper.create_variable_for_type_inference(logits.dtype)
    softmax.shape = logits.shape
    loss = helper.create_variable_for_type_inference(logits.dtype)
    if logits.shape is not None:
        loss.shape = tuple(logits.shape[:-1]) + (1,)
    helper.append_op(type='softmax_with_cross_entropy',
                     inputs={'Logits': [logits], 'Label': [label]},
                     outputs={'Softmax': [softmax], 'Loss': [loss]},
                     attrs={'soft_label': soft_label,
                            'ignore_index': ignore_index})
    if return_softmax:
        return loss, softmax
    return loss


def label_smoothed_cross_entropy(logits, label, epsilon=0.1, name=None):
    """Fused (1-eps)·CE + eps·uniform-KL loss over hard labels."""
    helper = LayerHelper(name or 'label_smoothed_cross_entropy')
    out = helper.create_variable_for_type_inference('float32')
    if logits.shape is not None:
        out.shape = tuple(logits.shape[:-1]) + (1,)
    helper.append_op(type='label_smoothed_cross_entropy',
                     inputs={'Logits': [logits], 'Label': [label]},
                     outputs={'Loss': [out]}, attrs={'epsilon': epsilon})
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper('reduce_sum', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    reduce_all = dim is None
    dims = dim if isinstance(dim, (list, tuple)) else \
        ([dim] if dim is not None else [0])
    if input.shape is not None:
        if reduce_all:
            out.shape = (1,) * len(input.shape) if keep_dim else ()
        else:
            s = list(input.shape)
            for ax in reversed(sorted(d % len(s) for d in dims)):
                if keep_dim:
                    s[ax] = 1
                else:
                    s.pop(ax)
            out.shape = tuple(s)
    helper.append_op(type='reduce_sum', inputs={'X': [input]},
                     outputs={'Out': [out]},
                     attrs={'dim': list(dims), 'keep_dim': keep_dim,
                            'reduce_all': reduce_all})
    return out
