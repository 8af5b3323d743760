"""VGG nets (reference: paddle_tpu models/vgg.py; the benchmark's VGG-16
and the image_classification chapter's CIFAR vgg_bn_drop, whose 14 batch
norms, one of them on the [N, 512] fc output, run on K5)."""

from .. import layers, nets
from ..param_attr import ParamAttr
from ..initializer import Normal


def vgg_bn_drop(input, class_dim=10):
    """CIFAR VGG with batch-norm + dropout conv groups (book chapter 03)."""

    def conv_block(ipt, num_filter, groups, dropouts):
        return nets.img_conv_group(
            input=ipt, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups, conv_filter_size=3,
            conv_act='relu', conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts, pool_type='max')

    conv1 = conv_block(input, 64, 2, [0.3, 0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0])

    drop = layers.dropout(x=conv5, dropout_prob=0.5)
    fc1 = layers.fc(input=drop, size=512, act=None)
    bn = layers.batch_norm(input=fc1, act='relu')
    drop2 = layers.dropout(x=bn, dropout_prob=0.5)
    fc2 = layers.fc(input=drop2, size=512, act=None)
    predict = layers.fc(input=fc2, size=class_dim, act='softmax')
    return predict


def vgg16(input, class_dim=1000):
    """Plain VGG-16 (benchmark/paddle vgg.py shape): 13 conv + 3 fc."""
    cfg = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
    tmp = input
    for num_filter, groups in cfg:
        tmp = nets.img_conv_group(
            input=tmp, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups, conv_filter_size=3,
            conv_act='relu', conv_with_batchnorm=False, pool_type='max')
    fc6 = layers.fc(input=tmp, size=4096, act='relu',
                    param_attr=ParamAttr(initializer=Normal(0.0, 0.01)))
    drop6 = layers.dropout(x=fc6, dropout_prob=0.5)
    fc7 = layers.fc(input=drop6, size=4096, act='relu',
                    param_attr=ParamAttr(initializer=Normal(0.0, 0.01)))
    drop7 = layers.dropout(x=fc7, dropout_prob=0.5)
    predict = layers.fc(input=drop7, size=class_dim, act='softmax')
    return predict


def vgg16_with_loss(input=None, label=None, class_dim=1000,
                    image_shape=(3, 224, 224)):
    if input is None:
        input = layers.data(name='image', shape=list(image_shape),
                            dtype='float32')
    if label is None:
        label = layers.data(name='label', shape=[1], dtype='int64')
    predict = vgg16(input, class_dim)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=predict, label=label)
    return predict, avg_cost, acc
