"""Neural-net layers (reference: paddle_tpu
layers/nn.py; python/paddle/fluid/layers/nn.py). Same ops, slots,
attributes, parameter names, shapes and initializers as the JAX package's
layer functions."""

from ..initializer import Constant, Normal, Xavier
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
           'resize_nearest', 'modified_huber_loss', 'switch_moe',
           'chunk_eval', 'precision_recall', 'positive_negative_pair',
           'edit_distance', 'conv3d', 'conv2d_transpose', 'group_norm',
           'row_conv', 'conv_shift', 'spp', 'lrn', 'crop', 'roi_pool',
           'max_pool2d_with_index', 'unpool']


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



def conv3d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=None, param_attr=None, bias_attr=None,
           act=None, name=None):
    """3-D convolution of an NCDHW input (conv3d op); the filter is OIDHW,
    initialised N(0, sqrt(2 / (fd·fh·fw·C_in)))."""
    def _triple(v):
        return (v, v, v) if isinstance(v, int) else tuple(v)

    helper = LayerHelper('conv3d', **locals())
    dtype = input.dtype
    groups = groups or 1
    num_channels = input.shape[1]
    fd, fh, fw = _triple(filter_size)
    sd, sh, sw = _triple(stride)
    pd, ph, pw = _triple(padding)
    dd, dh, dw = _triple(dilation)
    filter_shape = [num_filters, num_channels // groups, fd, fh, fw]
    std = (2.0 / (fd * fh * fw * num_channels)) ** 0.5
    w = helper.create_parameter(attr=helper.param_attr, shape=filter_shape,
                                dtype=dtype,
                                default_initializer=Normal(0.0, std))
    out = helper.create_variable_for_type_inference(dtype)

    def _od(sz, p, d, f, s):
        return (sz + 2 * p - (d * (f - 1) + 1)) // s + 1 \
            if sz and sz > 0 else sz

    n, _, dep, h, w_in = input.shape
    out.shape = (n, num_filters, _od(dep, pd, dd, fd, sd),
                 _od(h, ph, dh, fh, sh), _od(w_in, pw, dw, fw, sw))
    helper.append_op(
        type='conv3d', inputs={'Input': [input], 'Filter': [w]},
        outputs={'Output': [out]},
        attrs={'strides': [sd, sh, sw], 'paddings': [pd, ph, pw],
               'dilations': [dd, dh, dw], 'groups': groups})
    pre_act = helper.append_bias_op(out, [num_filters], axis=1)
    return helper.append_activation(pre_act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, param_attr=None,
                     bias_attr=None, use_cudnn=True, act=None, name=None):
    """Transposed 2-D convolution of an NCHW input (conv2d_transpose op);
    the filter is [C_in, num_filters, fh, fw]. Without filter_size it is
    the size that maps the input to output_size: out - (in - 1)·stride +
    2·pad."""
    helper = LayerHelper('conv2d_transpose', **locals())
    dtype = input.dtype
    num_channels = input.shape[1]
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    if filter_size is None:
        if output_size is None:
            raise ValueError('output_size or filter_size must be set')
        oh, ow = _pair(output_size)
        h, w_in = input.shape[2], input.shape[3]
        fh = oh - (h - 1) * sh + 2 * ph
        fw = ow - (w_in - 1) * sw + 2 * pw
    else:
        fh, fw = _pair(filter_size)
    filter_shape = [num_channels, num_filters, fh, fw]
    w = helper.create_parameter(attr=helper.param_attr, shape=filter_shape,
                                dtype=dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    n, _, h, w_in = input.shape
    oh = (h - 1) * sh - 2 * ph + dh * (fh - 1) + 1 if h and h > 0 else h
    ow = (w_in - 1) * sw - 2 * pw + dw * (fw - 1) + 1 \
        if w_in and w_in > 0 else w_in
    pre_bias.shape = (n, num_filters, oh, ow)
    helper.append_op(
        type='conv2d_transpose', inputs={'Input': [input], 'Filter': [w]},
        outputs={'Output': [pre_bias]},
        attrs={'strides': [sh, sw], 'paddings': [ph, pw],
               'dilations': [dh, dw]})
    pre_act = helper.append_bias_op(pre_bias, [num_filters], axis=1)
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



def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, name=None):
    """Group normalization of an NCHW input (group_norm op): scale (1.0)
    and bias (0.0) of [C] unless param_attr / bias_attr is False."""
    helper = LayerHelper('group_norm', **locals())
    dtype = input.dtype
    c = input.shape[1]
    inputs = {'X': [input]}
    if param_attr is not False:
        inputs['Scale'] = [helper.create_parameter(
            attr=helper.param_attr, shape=[c], dtype=dtype,
            default_initializer=Constant(1.0))]
    if bias_attr is not False:
        inputs['Bias'] = [helper.create_parameter(
            attr=helper.bias_attr, shape=[c], dtype=dtype, is_bias=True)]
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = input.shape
    helper.append_op(type='group_norm', inputs=inputs,
                     outputs={'Y': [out]},
                     attrs={'groups': groups, 'epsilon': epsilon})
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


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None):
    """Chunk (NER) evaluation: computed on the host by
    evaluator.ChunkEvaluator, as the reference's layer says (it raises)."""
    raise NotImplementedError(
        'chunk_eval is computed by evaluator.ChunkEvaluator on host; '
        'see paddle_tpu_torch/evaluator.py')


def precision_recall(indices, labels, class_number, weights=None,
                     states_info=None):
    """Multi-class precision/recall/F1 metrics + TP/FP/TN/FN states
    (precision_recall_op.cc:95-140). Returns (batch_metrics [6],
    accum_metrics [6], accum_states [class_number, 4])."""
    helper = LayerHelper('precision_recall', **locals())
    batch = helper.create_variable_for_type_inference('float32')
    accum = helper.create_variable_for_type_inference('float32')
    states = helper.create_variable_for_type_inference('float32')
    batch.shape = accum.shape = (6,)
    states.shape = (class_number, 4)
    inputs = {'Indices': [indices], 'Labels': [labels]}
    if weights is not None:
        inputs['Weights'] = [weights]
    if states_info is not None:
        inputs['StatesInfo'] = [states_info]
    helper.append_op(
        type='precision_recall', inputs=inputs,
        outputs={'BatchMetrics': [batch], 'AccumMetrics': [accum],
                 'AccumStatesInfo': [states]},
        attrs={'class_number': class_number})
    return batch, accum, states


def positive_negative_pair(score, label, qid, weight=None, column=0,
                           accum=None):
    """Ranking pair counts per query (positive_negative_pair_op.cc:100-150).
    Returns (positive, negative, neutral) [1] each; pass accum=(p, n, u)
    to accumulate across batches."""
    helper = LayerHelper('positive_negative_pair', **locals())
    pos = helper.create_variable_for_type_inference('float32')
    neg = helper.create_variable_for_type_inference('float32')
    neu = helper.create_variable_for_type_inference('float32')
    pos.shape = neg.shape = neu.shape = (1,)
    inputs = {'Score': [score], 'Label': [label], 'QueryID': [qid]}
    if weight is not None:
        inputs['Weight'] = [weight]
    if accum is not None:
        inputs['AccumulatePositivePair'] = [accum[0]]
        inputs['AccumulateNegativePair'] = [accum[1]]
        inputs['AccumulateNeutralPair'] = [accum[2]]
    helper.append_op(
        type='positive_negative_pair', inputs=inputs,
        outputs={'PositivePair': [pos], 'NegativePair': [neg],
                 'NeutralPair': [neu]},
        attrs={'column': column})
    return pos, neg, neu


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    """Batched Levenshtein distance between padded hyp/ref id sequences
    (edit_distance_op.cc; lengths per the LoD pad+mask stance). Returns
    (distance [B, 1], sequence_num [1])."""
    helper = LayerHelper('edit_distance', **locals())
    out = helper.create_variable_for_type_inference('float32')
    seq_num = helper.create_variable_for_type_inference('int64')
    if input.shape is not None:
        out.shape = (input.shape[0], 1)
    seq_num.shape = (1,)
    inputs = {'Hyps': [input], 'Refs': [label]}
    if input_length is not None:
        inputs['HypsLength'] = [input_length]
    if label_length is not None:
        inputs['RefsLength'] = [label_length]
    helper.append_op(type='edit_distance', inputs=inputs,
                     outputs={'Out': [out], 'SequenceNum': [seq_num]},
                     attrs={'normalized': normalized})
    return out, seq_num


def switch_moe(input, num_experts, d_inner, capacity_factor=1.25,
               top_k=1, param_attr=None, name=None):
    """Mixture-of-experts FFN with a capacity limit and a load-balancing
    aux loss (ops/moe_ops.py): top_k=1 is Switch routing (the raw router
    probability as the gate), top_k >= 2 GShard's (renormalised gates,
    capacity filled choice-major). The expert weights are stacked
    [E, ...] and marked ``expert_shard`` as the reference marks them for
    its 'ep' mesh axis. Returns (out, aux_loss); add ``aux_weight *
    aux_loss`` (Switch uses 1e-2) to the training loss."""
    import copy
    from ..param_attr import ParamAttr
    if not 1 <= top_k <= num_experts:
        raise ValueError('switch_moe: top_k=%d must be in [1, '
                         'num_experts=%d]' % (top_k, num_experts))
    helper = LayerHelper('switch_moe', **locals())
    dtype = input.dtype
    d_model = input.shape[-1]
    weight_attr = ParamAttr.to_attr(param_attr) if param_attr is not None \
        else None
    base = (weight_attr.name if weight_attr is not None and
            weight_attr.name else name)

    def _attr(suffix, bias=False):
        # five parameters: a shared explicit name becomes a prefix; weight
        # attrs keep the caller's other fields, biases stay default
        a = ParamAttr() if (bias or weight_attr is None) \
            else copy.copy(weight_attr)
        a.name = '%s_%s' % (base, suffix) if base is not None else None
        return a

    gate_w = helper.create_parameter(
        attr=_attr('gate.w'), shape=[d_model, num_experts], dtype=dtype)
    w1 = helper.create_parameter(
        attr=_attr('1.w'), shape=[num_experts, d_model, d_inner],
        dtype=dtype,
        default_initializer=Xavier(uniform=True, fan_in=d_model,
                                   fan_out=d_inner))
    b1 = helper.create_parameter(attr=_attr('1.b', bias=True),
                                 shape=[num_experts, d_inner],
                                 dtype=dtype, is_bias=True)
    w2 = helper.create_parameter(
        attr=_attr('2.w'), shape=[num_experts, d_inner, d_model],
        dtype=dtype,
        default_initializer=Xavier(uniform=True, fan_in=d_inner,
                                   fan_out=d_model))
    b2 = helper.create_parameter(attr=_attr('2.b', bias=True),
                                 shape=[num_experts, d_model],
                                 dtype=dtype, is_bias=True)
    for p in (w1, b1, w2, b2):
        p.expert_shard = True
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = input.shape
    aux = helper.create_variable_for_type_inference('float32')
    aux.shape = ()
    helper.append_op(
        type='switch_moe',
        inputs={'X': [input], 'GateW': [gate_w], 'W1': [w1], 'B1': [b1],
                'W2': [w2], 'B2': [b2]},
        outputs={'Out': [out], 'AuxLoss': [aux]},
        attrs={'capacity_factor': capacity_factor, 'top_k': top_k})
    return out, aux


def row_conv(input, future_context_size, param_attr=None, act=None):
    """Lookahead row convolution of a padded [B, T, D] input (row_conv op;
    DeepSpeech2's streaming layer): a [future_context_size + 1, D]
    filter."""
    helper = LayerHelper('row_conv', **locals())
    dtype = input.dtype
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[future_context_size + 1, input.shape[-1]], dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    if input.shape is not None:
        out.shape = tuple(input.shape)
    helper.append_op(type='row_conv', inputs={'X': [input], 'Filter': [w]},
                     outputs={'Out': [out]}, attrs={})
    return helper.append_activation(out)


def conv_shift(x, y, name=None):
    """Circular convolution of x [b, m] with y [b, n] (conv_shift op; NTM
    addressing)."""
    helper = LayerHelper(name or 'conv_shift')
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None:
        out.shape = tuple(x.shape)
    helper.append_op(type='conv_shift', inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [out]}, attrs={})
    return out


def spp(input, pyramid_height=2, pool_type='max', name=None):
    """Spatial pyramid pooling (spp op)."""
    helper = LayerHelper(name or 'spp')
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type='spp', inputs={'X': [input]},
                     outputs={'Out': [out]},
                     attrs={'pyramid_height': pyramid_height,
                            'pooling_type': pool_type})
    return out


def lrn(input, n=5, k=2.0, alpha=1e-4, beta=0.75, name=None):
    """Local response normalization across channels (lrn op)."""
    helper = LayerHelper('lrn', **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    mid = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(type='lrn', inputs={'X': [input]},
                     outputs={'Out': [out], 'MidOut': [mid]},
                     attrs={'n': n, 'k': k, 'alpha': alpha, 'beta': beta})
    return out


def crop(x, shape=None, offsets=None, name=None):
    """x cropped to ``shape`` at ``offsets`` (crop op); ``shape`` may be a
    Variable whose shape is the target."""
    helper = LayerHelper('crop', **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {'X': [x]}
    attrs = {}
    if hasattr(shape, 'name'):
        inputs['Y'] = [shape]
        out.shape = shape.shape
    else:
        attrs['shape'] = list(shape)
        out.shape = tuple(shape)
    attrs['offsets'] = list(offsets) if offsets is not None else None
    helper.append_op(type='crop', inputs=inputs, outputs={'Out': [out]},
                     attrs=attrs)
    return out


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0):
    """Max pool of each ROI to a fixed grid (roi_pool op); rois: [R, 5]
    rows of (batch_id, x1, y1, x2, y2). Returns Out; Argmax is its second
    output."""
    helper = LayerHelper('roi_pool', **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    argmax = helper.create_variable_for_type_inference('int64')
    if rois.shape is not None and input.shape is not None:
        out.shape = (rois.shape[0], input.shape[1], pooled_height,
                     pooled_width)
    helper.append_op(
        type='roi_pool', inputs={'X': [input], 'ROIs': [rois]},
        outputs={'Out': [out], 'Argmax': [argmax]},
        attrs={'pooled_height': pooled_height, 'pooled_width': pooled_width,
               'spatial_scale': spatial_scale})
    return out


def max_pool2d_with_index(input, ksize, strides=None, paddings=None):
    """Max pool returning (out, the flattened h·W + w of each max)
    (max_pool2d_with_index op); the mask feeds unpool."""
    helper = LayerHelper('max_pool2d_with_index', **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    mask = helper.create_variable_for_type_inference('int32')
    helper.append_op(
        type='max_pool2d_with_index', inputs={'X': [input]},
        outputs={'Out': [out], 'Mask': [mask]},
        attrs={'ksize': list(ksize),
               'strides': list(strides or [1, 1]),
               'paddings': list(paddings or [0, 0])})
    return out, mask


def unpool(input, indices, ksize, strides=None, paddings=None):
    """Max-unpool: each value scattered to its recorded position (unpool
    op)."""
    helper = LayerHelper('unpool', **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type='unpool', inputs={'X': [input], 'Indices': [indices]},
        outputs={'Out': [out]},
        attrs={'ksize': list(ksize),
               'strides': list(strides or [1, 1]),
               'paddings': list(paddings or [0, 0])})
    return out
