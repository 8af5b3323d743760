"""MobileNet v1 (reference: paddle_tpu models/mobilenet.py; the
image-classification suite's depthwise-separable net), built from the same
layers with the same parameter names and shapes. A depthwise conv is a
conv2d with groups = C (cuDNN's grouped convolution on the card); 27
batch norms a step, each on K5. data_format='NHWC' transposes the NCHW
feed once at the stem and keeps every activation channels-last."""

from .. import layers


def conv_bn(input, filter_size, num_filters, stride, padding, num_groups=1,
            act='relu', is_test=False, data_format='NCHW'):
    conv = layers.conv2d(input=input, num_filters=num_filters,
                         filter_size=filter_size, stride=stride,
                         padding=padding, groups=num_groups, act=None,
                         bias_attr=False, data_format=data_format)
    return layers.batch_norm(input=conv, act=act, is_test=is_test,
                             data_layout=data_format)


def depthwise_separable(input, num_filters1, num_filters2, num_groups,
                        stride, scale, is_test=False, data_format='NCHW'):
    depthwise = conv_bn(input=input, filter_size=3,
                        num_filters=int(num_filters1 * scale), stride=stride,
                        padding=1, num_groups=int(num_groups * scale),
                        is_test=is_test, data_format=data_format)
    pointwise = conv_bn(input=depthwise, filter_size=1,
                        num_filters=int(num_filters2 * scale), stride=1,
                        padding=0, is_test=is_test, data_format=data_format)
    return pointwise


def mobile_net(img, class_dim=1000, scale=1.0, is_test=False,
               data_format='NCHW'):
    if data_format == 'NHWC':
        img = layers.transpose(img, [0, 2, 3, 1])
    # conv1: 3x3 s2
    tmp = conv_bn(img, 3, int(32 * scale), 2, 1, is_test=is_test,
                  data_format=data_format)
    # (in, out, groups, stride) per depthwise-separable stage
    cfg = [(32, 64, 32, 1), (64, 128, 64, 2), (128, 128, 128, 1),
           (128, 256, 128, 2), (256, 256, 256, 1), (256, 512, 256, 2),
           (512, 512, 512, 1), (512, 512, 512, 1), (512, 512, 512, 1),
           (512, 512, 512, 1), (512, 512, 512, 1), (512, 1024, 512, 2),
           (1024, 1024, 1024, 1)]
    for f1, f2, g, s in cfg:
        tmp = depthwise_separable(tmp, f1, f2, g, s, scale, is_test=is_test,
                                  data_format=data_format)
    pool = layers.pool2d(input=tmp, pool_type='avg', global_pooling=True,
                         data_format=data_format)
    out = layers.fc(input=pool, size=class_dim, act='softmax')
    return out


def mobilenet_with_loss(input=None, label=None, class_dim=1000,
                        image_shape=(3, 224, 224), is_test=False,
                        data_format='NCHW'):
    if input is None:
        input = layers.data(name='image', shape=list(image_shape),
                            dtype='float32')
    if label is None:
        label = layers.data(name='label', shape=[1], dtype='int64')
    predict = mobile_net(input, class_dim=class_dim, is_test=is_test,
                         data_format=data_format)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=predict, label=label)
    return predict, avg_cost, acc
