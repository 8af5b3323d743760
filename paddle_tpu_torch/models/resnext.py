"""SE-ResNeXt (reference: paddle_tpu models/resnext.py; the
image-classification suite's SE_ResNeXt50/101/152): grouped 3x3 convs and
squeeze-and-excitation blocks (a global average pool, two fc layers and a
reshape broadcast by elementwise_mul), NCHW, the same layers, parameter
names and shapes. SE-ResNeXt-50 runs 53 batch norms a step, each on K5."""

from .. import layers


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None, is_test=False):
    conv = layers.conv2d(input=input, num_filters=num_filters,
                         filter_size=filter_size, stride=stride,
                         padding=(filter_size - 1) // 2, groups=groups,
                         act=None, bias_attr=False)
    return layers.batch_norm(input=conv, act=act, is_test=is_test)


def squeeze_excitation(input, num_channels, reduction_ratio=16):
    pool = layers.pool2d(input=input, pool_type='avg', global_pooling=True)
    squeeze = layers.fc(input=pool, size=num_channels // reduction_ratio,
                        act='relu')
    excitation = layers.fc(input=squeeze, size=num_channels, act='sigmoid')
    # scale channels: [N,C,H,W] * [N,C] broadcast on axis 0..1
    excitation = layers.reshape(x=excitation,
                                shape=[-1, num_channels, 1, 1])
    return layers.elementwise_mul(x=input, y=excitation)


def bottleneck_block(input, num_filters, stride, cardinality=32,
                     reduction_ratio=16, is_test=False):
    conv0 = conv_bn_layer(input, num_filters, 1, act='relu', is_test=is_test)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride,
                          groups=cardinality, act='relu', is_test=is_test)
    conv2 = conv_bn_layer(conv1, num_filters * 2, 1, act=None,
                          is_test=is_test)
    scaled = squeeze_excitation(conv2, num_filters * 2, reduction_ratio)

    ch_in = input.shape[1]
    if ch_in != num_filters * 2 or stride != 1:
        short = conv_bn_layer(input, num_filters * 2, 1, stride=stride,
                              is_test=is_test)
    else:
        short = input
    return layers.elementwise_add(x=short, y=scaled, act='relu')


def se_resnext(input, class_dim=1000, depth=50, cardinality=32,
               reduction_ratio=16, is_test=False):
    stages = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
    num_filters = [128, 256, 512, 1024]
    conv = conv_bn_layer(input, 64, 7, stride=2, act='relu', is_test=is_test)
    conv = layers.pool2d(input=conv, pool_size=3, pool_stride=2,
                         pool_padding=1, pool_type='max')
    for block in range(len(stages)):
        for i in range(stages[block]):
            conv = bottleneck_block(
                conv, num_filters[block],
                stride=2 if i == 0 and block != 0 else 1,
                cardinality=cardinality, reduction_ratio=reduction_ratio,
                is_test=is_test)
    pool = layers.pool2d(input=conv, pool_type='avg', global_pooling=True)
    drop = layers.dropout(x=pool, dropout_prob=0.5, is_test=is_test)
    out = layers.fc(input=drop, size=class_dim, act='softmax')
    return out


def se_resnext_with_loss(input=None, label=None, class_dim=1000,
                         image_shape=(3, 224, 224), depth=50, is_test=False):
    if input is None:
        input = layers.data(name='image', shape=list(image_shape),
                            dtype='float32')
    if label is None:
        label = layers.data(name='label', shape=[1], dtype='int64')
    predict = se_resnext(input, class_dim=class_dim, depth=depth,
                         is_test=is_test)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=predict, label=label)
    return predict, avg_cost, acc
