"""Neural-net layers (reference: paddle_tpu
layers/nn.py; python/paddle/fluid/layers/nn.py). Same ops, slots,
attributes, parameter names, shapes and initializers as the JAX package's
layer functions."""

from ..initializer import Constant, Normal
from .helper import LayerHelper

__all__ = ['fc', 'embedding', 'conv2d', 'pool2d', 'batch_norm', 'layer_norm',
           'dropout', 'cross_entropy', 'label_smoothed_cross_entropy',
           'softmax_with_cross_entropy', 'accuracy', 'topk', 'matmul',
           'reduce_sum', 'reduce_mean', 'reduce_max', 'reduce_min',
           'reduce_prod', 'split', 'transpose', 'one_hot', 'square_error_cost',
           'cos_sim', 'relu_layer', 'dot', 'sign', 'l1_norm',
           'squared_l2_norm', 'squared_l2_distance',
           'autoincreased_step_counter', 'auc', 'l2_normalize', 'smooth_l1',
           'im2sequence', 'multiplex', 'label_smooth', 'pad', 'maxout',
           'bilinear_tensor_product', 'nce', 'huber_loss', 'rank_loss',
           'margin_rank_loss', 'hinge_loss', 'log_loss', 'resize_bilinear',
           'resize_nearest', 'modified_huber_loss']


def _prod(xs):
    out = 1
    for x in xs:
        out *= x
    return out


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, use_mkldnn=False, name=None):
    """Fully-connected layer: one mul op per input, their sum, a bias and
    an activation (reference fluid/layers/nn.py:fc). ``use_mkldnn`` is
    accepted and ignored, as in the reference."""
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


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper('matmul', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None and y.shape is not None:
        xs = list(x.shape)
        ys = list(y.shape)
        if transpose_x and len(xs) > 1:
            xs[-1], xs[-2] = xs[-2], xs[-1]
        if transpose_y and len(ys) > 1:
            ys[-1], ys[-2] = ys[-2], ys[-1]
        if len(xs) >= 2 and len(ys) >= 2:
            out.shape = tuple(xs[:-1] + ys[-1:])
    helper.append_op(type='matmul', inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [out]},
                     attrs={'transpose_X': transpose_x,
                            'transpose_Y': transpose_y, 'alpha': alpha})
    return out


def _reduce(op_type, input, dim, keep_dim, name):
    """One reduce op over ``dim`` (an int or a list), or over every axis
    where dim is None (``reduce_all``)."""
    helper = LayerHelper(op_type, name=name)
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
    helper.append_op(type=op_type, inputs={'X': [input]},
                     outputs={'Out': [out]},
                     attrs={'dim': list(dims), 'keep_dim': keep_dim,
                            'reduce_all': reduce_all})
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce('reduce_sum', input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce('reduce_mean', input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce('reduce_max', input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce('reduce_min', input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce('reduce_prod', input, dim, keep_dim, name)


def split(input, num_or_sections, dim=-1, name=None):
    """The pieces of ``input`` along ``dim``: ``num_or_sections`` equal
    ones (an int) or ones of the listed sizes."""
    helper = LayerHelper('split', name=name)
    in_shape = input.shape
    axis = dim % len(in_shape) if in_shape is not None else dim
    if isinstance(num_or_sections, int):
        num = num_or_sections
        sections = None
        sizes = [in_shape[axis] // num] * num if in_shape else None
    else:
        sections = list(num_or_sections)
        num = len(sections)
        sizes = sections
    outs = []
    for i in range(num):
        v = helper.create_variable_for_type_inference(input.dtype)
        if in_shape is not None and sizes is not None:
            s = list(in_shape)
            s[axis] = sizes[i]
            v.shape = tuple(s)
        outs.append(v)
    attrs = {'axis': axis}
    if sections is not None:
        attrs['sections'] = sections
    else:
        attrs['num'] = num
    helper.append_op(type='split', inputs={'X': [input]},
                     outputs={'Out': outs}, attrs=attrs)
    return outs


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


def relu_layer(x, name=None):
    from .ops import relu as _relu
    return _relu(x, name=name)


def dot(x, y, name=None):
    """Row-wise dot product over the last axis, [..., 1]."""
    helper = LayerHelper(name or 'dot')
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None:
        out.shape = tuple(x.shape[:-1]) + (1,)
    helper.append_op(type='dot', inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [out]}, attrs={})
    return out


def _one_op(op_type, x, shape):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = shape
    helper.append_op(type=op_type, inputs={'X': [x]},
                     outputs={'Out': [out]})
    return out


def sign(x):
    """Elementwise sign (sign_op.cc); NaN stays NaN."""
    return _one_op('sign', x, x.shape)


def l1_norm(x):
    """sum(|x|) over every element, [1] (l1_norm_op.cc)."""
    return _one_op('l1_norm', x, (1,))


def squared_l2_norm(x):
    """sum(x^2) over every element, [1] (squared_l2_norm_op.cc)."""
    return _one_op('squared_l2_norm', x, (1,))


def squared_l2_distance(x, y):
    """Row-wise sum((x - y)^2), [N, 1] (squared_l2_distance_op.cc)."""
    helper = LayerHelper('squared_l2_distance')
    out = helper.create_variable_for_type_inference(x.dtype)
    sub = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None:
        out.shape = (x.shape[0], 1)
    helper.append_op(type='squared_l2_distance',
                     inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [out], 'sub_result': [sub]})
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


def auc(input, label, curve='ROC', num_thresholds=200, topk=1):
    helper = LayerHelper('auc')
    out = helper.create_variable_for_type_inference('float32')
    out.shape = (1,)
    helper.append_op(type='auc',
                     inputs={'Predict': [input], 'Label': [label]},
                     outputs={'AUC': [out]})
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper('l2_normalize', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    norm = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type='l2_normalize', inputs={'X': [x]},
                     outputs={'Out': [out], 'Norm': [norm]},
                     attrs={'axis': axis, 'epsilon': epsilon})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None,
              last_dim_only=False):
    """last_dim_only=True sums over only the trailing axis (per-box loss
    for [B, N, 4] detection targets) instead of all non-batch axes."""
    helper = LayerHelper('smooth_l1_loss')
    diff = helper.create_variable_for_type_inference(x.dtype)
    loss = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None:
        loss.shape = tuple(x.shape[:-1]) if last_dim_only \
            else (x.shape[0], 1)
    inputs = {'X': [x], 'Y': [y]}
    if inside_weight is not None:
        inputs['InsideWeight'] = [inside_weight]
    if outside_weight is not None:
        inputs['OutsideWeight'] = [outside_weight]
    helper.append_op(type='smooth_l1_loss', inputs=inputs,
                     outputs={'Diff': [diff], 'Out': [loss]},
                     attrs={'sigma': sigma if sigma is not None else 1.0,
                            'last_dim_only': last_dim_only})
    return loss


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    helper = LayerHelper('im2sequence', name=name)
    kh, kw = _pair(filter_size)
    sh, sw = _pair(stride)
    pads = padding if isinstance(padding, (list, tuple)) and \
        len(padding) == 4 else _pair(padding) * 2
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type='im2sequence', inputs={'X': [input]},
                     outputs={'Out': [out]},
                     attrs={'kernels': [kh, kw], 'strides': [sh, sw],
                            'paddings': list(pads)})
    return out


def multiplex(inputs, index):
    helper = LayerHelper('multiplex')
    out = helper.create_variable_for_type_inference(inputs[0].dtype)
    out.shape = inputs[0].shape
    helper.append_op(type='multiplex',
                     inputs={'X': inputs, 'Ids': [index]},
                     outputs={'Out': [out]})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype='float32',
                 name=None):
    helper = LayerHelper('label_smooth', name=name)
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = label.shape
    inputs = {'X': [label]}
    if prior_dist is not None:
        inputs['PriorDist'] = [prior_dist]
    helper.append_op(type='label_smooth', inputs=inputs,
                     outputs={'Out': [out]}, attrs={'epsilon': epsilon})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper('pad', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None:
        s = list(x.shape)
        for i in range(len(s)):
            if s[i] is not None and s[i] >= 0:
                s[i] += paddings[2 * i] + paddings[2 * i + 1]
        out.shape = tuple(s)
    helper.append_op(type='pad', inputs={'X': [x]}, outputs={'Out': [out]},
                     attrs={'paddings': list(paddings),
                            'pad_value': float(pad_value)})
    return out


def maxout(x, groups, name=None):
    helper = LayerHelper('maxout', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None:
        n, c, h, w = x.shape
        out.shape = (n, c // groups, h, w)
    helper.append_op(type='maxout', inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'groups': groups})
    return out


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    helper = LayerHelper('bilinear_tensor_product', **locals())
    dtype = x.dtype
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[size, x.shape[-1], y.shape[-1]],
                                dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = (x.shape[0], size)
    inputs = {'X': [x], 'Y': [y], 'Weight': [w]}
    if bias_attr is not False:
        b = helper.create_parameter(attr=helper.bias_attr, shape=[1, size],
                                    dtype=dtype, is_bias=True)
        inputs['Bias'] = [b]
    helper.append_op(type='bilinear_tensor_product', inputs=inputs,
                     outputs={'Out': [out]})
    return helper.append_activation(out)


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=None, name=None):
    """NCE loss (reference nce_op.cc). TPU-native: sampled softmax using
    stateless uniform negative sampling fused into one XLA computation."""
    helper = LayerHelper('nce', **locals())
    dim = input.shape[-1]
    num_neg = num_neg_samples if num_neg_samples is not None else 10
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[num_total_classes, dim],
                                dtype=input.dtype)
    b = helper.create_parameter(attr=helper.bias_attr,
                                shape=[num_total_classes, 1],
                                dtype=input.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = (input.shape[0], 1)
    helper.append_op(type='nce',
                     inputs={'Input': [input], 'Label': [label],
                             'Weight': [w], 'Bias': [b]},
                     outputs={'Cost': [out]},
                     attrs={'num_total_classes': num_total_classes,
                            'num_neg_samples': num_neg})
    return out


def huber_loss(input, label, delta=1.0):
    helper = LayerHelper('huber_loss')
    residual = helper.create_variable_for_type_inference(input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape is not None:
        out.shape = tuple(input.shape)
    helper.append_op(type='huber_loss',
                     inputs={'X': [input], 'Y': [label]},
                     outputs={'Out': [out], 'Residual': [residual]},
                     attrs={'delta': delta})
    return out


def rank_loss(label, left, right, name=None):
    """RankNet pairwise loss (rank_loss_op.cc)."""
    helper = LayerHelper(name or 'rank_loss')
    out = helper.create_variable_for_type_inference(left.dtype)
    if left.shape is not None:
        out.shape = tuple(left.shape)
    helper.append_op(type='rank_loss',
                     inputs={'Label': [label], 'Left': [left],
                             'Right': [right]},
                     outputs={'Out': [out]}, attrs={})
    return out


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper(name or 'margin_rank_loss')
    out = helper.create_variable_for_type_inference(left.dtype)
    act = helper.create_variable_for_type_inference(left.dtype)
    if left.shape is not None:
        out.shape = tuple(left.shape)
    helper.append_op(type='margin_rank_loss',
                     inputs={'Label': [label], 'X1': [left],
                             'X2': [right]},
                     outputs={'Out': [out], 'Activated': [act]},
                     attrs={'margin': margin})
    return out


def hinge_loss(input, label, name=None):
    helper = LayerHelper(name or 'hinge_loss')
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape is not None:
        out.shape = tuple(input.shape)
    helper.append_op(type='hinge_loss',
                     inputs={'Logits': [input], 'Labels': [label]},
                     outputs={'Loss': [out]}, attrs={})
    return out


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper(name or 'log_loss')
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape is not None:
        out.shape = tuple(input.shape)
    helper.append_op(type='log_loss',
                     inputs={'Predicted': [input], 'Labels': [label]},
                     outputs={'Loss': [out]}, attrs={'epsilon': epsilon})
    return out


def resize_bilinear(input, out_shape, name=None):
    helper = LayerHelper(name or 'bilinear_interp')
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape is not None:
        out.shape = (input.shape[0], input.shape[1]) + tuple(out_shape)
    helper.append_op(type='bilinear_interp', inputs={'X': [input]},
                     outputs={'Out': [out]},
                     attrs={'out_h': out_shape[0], 'out_w': out_shape[1]})
    return out


def resize_nearest(input, out_shape, name=None):
    helper = LayerHelper(name or 'nearest_interp')
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape is not None:
        out.shape = (input.shape[0], input.shape[1]) + tuple(out_shape)
    helper.append_op(type='nearest_interp', inputs={'X': [input]},
                     outputs={'Out': [out]},
                     attrs={'out_h': out_shape[0], 'out_w': out_shape[1]})
    return out


def modified_huber_loss(x, y):
    """Binary-classification modified Huber loss
    (modified_huber_loss_op.h:37-72); y in {0, 1}."""
    helper = LayerHelper('modified_huber_loss', **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    inter = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type='modified_huber_loss',
                     inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [out], 'IntermediateVal': [inter]})
    return out
