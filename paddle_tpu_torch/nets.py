"""Composite networks (reference: paddle_tpu nets.py;
python/paddle/fluid/nets.py), built from the public layers: the same ops
as the JAX package's, which run as written (no pass rewrites them)."""

from . import layers

__all__ = ['simple_img_conv_pool', 'sequence_conv_pool', 'glu',
           'scaled_dot_product_attention', 'img_conv_group']


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act, param_attr=None,
                         pool_type='max', use_cudnn=True, use_mkldnn=False):
    conv_out = layers.conv2d(input=input, num_filters=num_filters,
                             filter_size=filter_size, param_attr=param_attr,
                             act=act)
    return layers.pool2d(input=conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type='max', use_cudnn=True,
                   use_mkldnn=False):
    """conv2d (+ batch_norm and dropout) for each entry of
    ``conv_num_filter``, then one pool2d; a per-conv argument may be a
    list."""
    tmp = input
    if isinstance(conv_num_filter, int):
        conv_num_filter = [conv_num_filter]

    def _ith(arg, i):
        if isinstance(arg, (list, tuple)):
            return arg[i]
        return arg

    for i in range(len(conv_num_filter)):
        local_conv_act = conv_act
        if conv_with_batchnorm:
            local_conv_act = None
        tmp = layers.conv2d(
            input=tmp, num_filters=conv_num_filter[i],
            filter_size=_ith(conv_filter_size, i),
            padding=_ith(conv_padding, i),
            param_attr=_ith(param_attr, i) if isinstance(param_attr, list)
            else param_attr,
            act=local_conv_act)
        if conv_with_batchnorm:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop_rate = _ith(conv_batchnorm_drop_rate, i)
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act='sigmoid', pool_type='max', length=None):
    """sequence_conv (a context window of ``filter_size``, then ``act``)
    and sequence_pool of ``pool_type`` over each row's ``length``."""
    conv_out = layers.sequence_conv(input=input, num_filters=num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr, act=act)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type,
                                length=length)


def glu(input, dim=-1):
    """Gated linear unit: a * sigmoid(b), a and b the halves of ``input``
    along ``dim``."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(x=a, y=layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled dot-product attention from public layers
    (reference: fluid nets.py, the function of this name): the heads
    split by reshape and transpose, q scaled by d_key^-0.5, matmul,
    softmax (and dropout), matmul, the heads merged again."""
    if queries.shape[-1] != keys.shape[-1]:
        raise ValueError('queries and keys must have the same hidden size')
    d_key = keys.shape[-1] // num_heads

    def _split_heads(x):
        if num_heads == 1:
            return x
        b, t, d = x.shape
        reshaped = layers.reshape(x=x, shape=[b if b and b > 0 else -1, t,
                                              num_heads, d // num_heads])
        return layers.transpose(x=reshaped, perm=[0, 2, 1, 3])

    def _combine_heads(x):
        if num_heads == 1:
            return x
        b, h, t, d = x.shape
        trans = layers.transpose(x=x, perm=[0, 2, 1, 3])
        return layers.reshape(x=trans, shape=[b if b and b > 0 else -1, t,
                                              h * d])

    q = _split_heads(queries)
    k = _split_heads(keys)
    v = _split_heads(values)
    scaled_q = layers.scale(x=q, scale=d_key ** -0.5)
    product = layers.matmul(x=scaled_q, y=k, transpose_y=True)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    ctx_multiheads = layers.matmul(weights, v)
    return _combine_heads(ctx_multiheads)
