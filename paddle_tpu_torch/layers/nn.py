"""Neural-net layers the training paths build (reference: paddle_tpu
layers/nn.py; python/paddle/fluid/layers/nn.py). Same ops, slots,
attributes, parameter names, shapes and initializers as the JAX package's
layer functions."""

from ..initializer import Constant, Normal
from .helper import LayerHelper

__all__ = ['fc', 'embedding', 'conv2d', 'pool2d', 'batch_norm',
           'layer_norm', 'dropout', 'cross_entropy',
           'label_smoothed_cross_entropy', 'softmax_with_cross_entropy',
           'accuracy', 'topk', 'reduce_sum', 'transpose', 'one_hot',
           'square_error_cost', 'cos_sim', 'autoincreased_step_counter']


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
    """Embedding lookup (lookup_table op).

    ``is_sparse`` / ``is_distributed`` flag the table for row-sparse
    gradients (``w.sparse_grad``): under an optimizer whose update takes
    them (SGD, Adagrad, lazy Adam and Momentum) and where the table is
    eligible (core/backward.py), its gradient is the [n_ids, dim] rows of
    this lookup, merged and applied by the sparse_rows kernel, never a
    dense [vocab, dim] gradient. Otherwise the gradient is dense."""
    helper = LayerHelper('embedding', **locals())
    w = helper.create_parameter(attr=helper.param_attr, shape=size,
                                dtype=dtype)
    if is_sparse or is_distributed:
        w.sparse_grad = True
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


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           use_mkldnn=False, act=None, name=None, data_format='NCHW'):
    """2-D convolution (conv2d op). data_format='NHWC' keeps the
    activations channels-last in the IR; the filter parameter stays OIHW
    either way, initialised N(0, sqrt(2 / (fh·fw·C_in)))."""
    helper = LayerHelper('conv2d', **locals())
    dtype = input.dtype
    groups = groups or 1
    nhwc = data_format == 'NHWC'
    num_channels = input.shape[3] if nhwc else input.shape[1]
    fh, fw = _pair(filter_size)
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    filter_shape = [num_filters, num_channels // groups, fh, fw]
    std = (2.0 / (fh * fw * num_channels)) ** 0.5
    w = helper.create_parameter(attr=helper.param_attr, shape=filter_shape,
                                dtype=dtype,
                                default_initializer=Normal(0.0, std))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    if nhwc:
        n, h, w_in, c = input.shape
    else:
        n, c, h, w_in = input.shape
    oh = (h + 2 * ph - (dh * (fh - 1) + 1)) // sh + 1 if h and h > 0 else h
    ow = (w_in + 2 * pw - (dw * (fw - 1) + 1)) // sw + 1 \
        if w_in and w_in > 0 else w_in
    pre_bias.shape = (n, oh, ow, num_filters) if nhwc \
        else (n, num_filters, oh, ow)
    helper.append_op(
        type='conv2d', inputs={'Input': [input], 'Filter': [w]},
        outputs={'Output': [pre_bias]},
        attrs={'strides': [sh, sw], 'paddings': [ph, pw],
               'dilations': [dh, dw], 'groups': groups,
               'data_format': data_format})
    pre_act = helper.append_bias_op(pre_bias, [num_filters],
                                    axis=3 if nhwc else 1)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type='max', pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, use_mkldnn=False, name=None, exclusive=True,
           data_format='NCHW'):
    helper = LayerHelper('pool2d', **locals())
    kh, kw = _pair(pool_size)
    sh, sw = _pair(pool_stride)
    ph, pw = _pair(pool_padding)
    out = helper.create_variable_for_type_inference(input.dtype)
    nhwc = data_format == 'NHWC'
    if nhwc:
        n, h, w, c = input.shape
    else:
        n, c, h, w = input.shape
    if global_pooling:
        out.shape = (n, 1, 1, c) if nhwc else (n, c, 1, 1)
    else:
        rnd = (lambda a, b: -(-a // b)) if ceil_mode else (lambda a, b: a // b)
        oh = rnd(h + 2 * ph - kh, sh) + 1 if h and h > 0 else -1
        ow = rnd(w + 2 * pw - kw, sw) + 1 if w and w > 0 else -1
        out.shape = (n, oh, ow, c) if nhwc else (n, c, oh, ow)
    helper.append_op(
        type='pool2d', inputs={'X': [input]}, outputs={'Out': [out]},
        attrs={'pooling_type': pool_type, 'ksize': [kh, kw],
               'strides': [sh, sw], 'paddings': [ph, pw],
               'global_pooling': global_pooling, 'ceil_mode': ceil_mode,
               'exclusive': exclusive, 'data_format': data_format})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout='NCHW',
               in_place=False, use_mkldnn=False, name=None,
               moving_mean_name=None, moving_variance_name=None,
               do_model_average_for_mean_and_var=False):
    """Batch normalization (batch_norm op). The running mean and variance
    are persistable, non-trainable vars set to 0 and 1 by the startup
    program; the op moves them in training."""
    helper = LayerHelper('batch_norm', **locals())
    dtype = input.dtype
    c = input.shape[1] if data_layout == 'NCHW' else input.shape[-1]
    scale = helper.create_parameter(attr=helper.param_attr, shape=[c],
                                    dtype=dtype,
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(attr=helper.bias_attr, shape=[c],
                                   dtype=dtype, is_bias=True)
    block = helper.main_program.global_block()
    mean = block.create_var(name=moving_mean_name or helper.name + '.mean',
                            shape=(c,), dtype=dtype, persistable=True)
    mean.stop_gradient = True
    variance = block.create_var(
        name=moving_variance_name or helper.name + '.variance', shape=(c,),
        dtype=dtype, persistable=True)
    variance.stop_gradient = True
    Constant(0.0)(mean)
    Constant(1.0)(variance)

    saved_mean = helper.create_variable_for_type_inference(dtype)
    saved_var = helper.create_variable_for_type_inference(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = input.shape
    helper.append_op(
        type='batch_norm',
        inputs={'X': [input], 'Scale': [scale], 'Bias': [bias],
                'Mean': [mean], 'Variance': [variance]},
        outputs={'Y': [out], 'MeanOut': [mean], 'VarianceOut': [variance],
                 'SavedMean': [saved_mean], 'SavedVariance': [saved_var]},
        attrs={'momentum': momentum, 'epsilon': epsilon, 'is_test': is_test,
               'data_layout': data_layout})
    return helper.append_activation(out)


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


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper('cross_entropy')
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape is not None:
        out.shape = tuple(input.shape[:-1]) + (1,)
    helper.append_op(type='cross_entropy',
                     inputs={'X': [input], 'Label': [label]},
                     outputs={'Y': [out]},
                     attrs={'soft_label': soft_label})
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


def accuracy(input, label, k=1, correct=None, total=None):
    """Classification accuracy: top_k, then the accuracy op."""
    helper = LayerHelper('accuracy')
    values, indices = topk(input, k=k)
    acc = helper.create_variable_for_type_inference('float32')
    acc.shape = (1,)
    if correct is None:
        correct = helper.create_variable_for_type_inference('int32')
    if total is None:
        total = helper.create_variable_for_type_inference('int32')
    correct.shape = (1,)
    total.shape = (1,)
    helper.append_op(type='accuracy',
                     inputs={'Out': [values], 'Indices': [indices],
                             'Label': [label]},
                     outputs={'Accuracy': [acc], 'Correct': [correct],
                              'Total': [total]})
    return acc


def topk(input, k=1, name=None):
    helper = LayerHelper('top_k', name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference('int64')
    if input.shape is not None:
        s = tuple(input.shape[:-1]) + (k,)
        values.shape = s
        indices.shape = s
    helper.append_op(type='top_k', inputs={'X': [input]},
                     outputs={'Out': [values], 'Indices': [indices]},
                     attrs={'k': k})
    return values, indices


def transpose(x, perm, name=None):
    helper = LayerHelper('transpose', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None:
        out.shape = tuple(x.shape[p] for p in perm)
    helper.append_op(type='transpose', inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'axis': list(perm)})
    return out


def one_hot(input, depth):
    helper = LayerHelper('one_hot')
    out = helper.create_variable_for_type_inference('float32')
    if input.shape is not None:
        base = input.shape[:-1] if input.shape[-1] == 1 else input.shape
        out.shape = tuple(base) + (depth,)
    helper.append_op(type='one_hot', inputs={'X': [input]},
                     outputs={'Out': [out]}, attrs={'depth': depth})
    return out


def square_error_cost(input, label):
    helper = LayerHelper('square_error_cost')
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(type='square_error_cost',
                     inputs={'X': [input], 'Y': [label]},
                     outputs={'Out': [out]})
    return out


def cos_sim(X, Y):
    """Row-wise cosine similarity [..., 1] of X and Y (reference:
    paddle_tpu layers/nn.py cos_sim); XNorm and YNorm are its side
    outputs."""
    helper = LayerHelper('cos_sim')
    out = helper.create_variable_for_type_inference(X.dtype)
    xn = helper.create_variable_for_type_inference(X.dtype)
    yn = helper.create_variable_for_type_inference(X.dtype)
    if X.shape is not None:
        out.shape = tuple(X.shape[:-1]) + (1,)
    helper.append_op(type='cos_sim', inputs={'X': [X], 'Y': [Y]},
                     outputs={'Out': [out], 'XNorm': [xn], 'YNorm': [yn]})
    return out


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """Persistable int64 counter, incremented once a run of its program
    (reference: paddle_tpu layers/nn.py autoincreased_step_counter): the
    startup sets it to begin - step, so the first run reads begin."""
    helper = LayerHelper('global_step_counter')
    name = counter_name or '@STEP_COUNTER@'
    block = helper.main_program.global_block()
    if block.has_var(name):
        return block.var(name)
    counter = block.create_var(name=name, dtype='int64', shape=(1,),
                               persistable=True)
    counter.stop_gradient = True
    Constant(float(begin - step))(counter)
    block.append_op(type='increment', inputs={'X': [counter]},
                    outputs={'Out': [counter]}, attrs={'step': float(step)})
    return counter
