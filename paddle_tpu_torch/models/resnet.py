"""ResNet family (reference: paddle_tpu models/resnet.py; the benchmark's
ResNet-50/101/152 bottleneck nets and the image-classification chapter's
CIFAR resnet), built from the same layers with the same parameter names
and shapes.

data_format='NHWC' keeps every activation channels-last in the IR (one
transpose of the NCHW feed at the stem); filters stay OIHW either way.
bf16 is set by the caller through ``Program.amp``, not built into the
model.
"""

import numpy as np

from .. import layers


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act='relu',
                  is_test=False, data_format='NCHW'):
    conv = layers.conv2d(input=input, num_filters=ch_out,
                         filter_size=filter_size, stride=stride,
                         padding=padding, act=None, bias_attr=False,
                         data_format=data_format)
    return layers.batch_norm(input=conv, act=act, is_test=is_test,
                             data_layout=data_format)


def shortcut(input, ch_out, stride, is_test=False, data_format='NCHW'):
    ch_in = input.shape[3] if data_format == 'NHWC' else input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, 0, act=None,
                             is_test=is_test, data_format=data_format)
    return input


def basicblock(input, ch_out, stride, is_test=False, data_format='NCHW'):
    short = shortcut(input, ch_out, stride, is_test, data_format)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_test=is_test,
                          data_format=data_format)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None, is_test=is_test,
                          data_format=data_format)
    return layers.elementwise_add(x=short, y=conv2, act='relu')


def bottleneck(input, ch_out, stride, is_test=False, data_format='NCHW'):
    """1x1 (carrying the stride), 3x3, 1x1 to 4·ch_out, plus the
    shortcut."""
    short = shortcut(input, ch_out * 4, stride, is_test, data_format)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, is_test=is_test,
                          data_format=data_format)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, is_test=is_test,
                          data_format=data_format)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None,
                          is_test=is_test, data_format=data_format)
    return layers.elementwise_add(x=short, y=conv3, act='relu')


def layer_warp(block_func, input, ch_out, count, stride, is_test=False,
               data_format='NCHW'):
    res_out = block_func(input, ch_out, stride, is_test, data_format)
    for _ in range(1, count):
        res_out = block_func(res_out, ch_out, 1, is_test, data_format)
    return res_out


def resnet_imagenet(input, class_dim=1000, depth=50, is_test=False,
                    data_format='NCHW'):
    """ResNet-{50,101,152} bottleneck net for 224x224 ImageNet. ``input``
    is the NCHW feed; data_format='NHWC' transposes it once here."""
    cfg = {50: ([3, 4, 6, 3], bottleneck),
           101: ([3, 4, 23, 3], bottleneck),
           152: ([3, 8, 36, 3], bottleneck)}
    stages, block_func = cfg[depth]
    if data_format == 'NHWC':
        input = layers.transpose(input, [0, 2, 3, 1])
    conv1 = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2,
                          padding=3, is_test=is_test,
                          data_format=data_format)
    pool1 = layers.pool2d(input=conv1, pool_type='max', pool_size=3,
                          pool_stride=2, pool_padding=1,
                          data_format=data_format)
    res1 = layer_warp(block_func, pool1, 64, stages[0], 1, is_test,
                      data_format)
    res2 = layer_warp(block_func, res1, 128, stages[1], 2, is_test,
                      data_format)
    res3 = layer_warp(block_func, res2, 256, stages[2], 2, is_test,
                      data_format)
    res4 = layer_warp(block_func, res3, 512, stages[3], 2, is_test,
                      data_format)
    pool2 = layers.pool2d(input=res4, pool_size=7, pool_type='avg',
                          global_pooling=True, data_format=data_format)
    return layers.fc(input=pool2, size=class_dim, act='softmax')


def resnet_cifar10(input, depth=32, class_dim=10, is_test=False):
    """The CIFAR resnet: 6n+2 layers of basic blocks."""
    if (depth - 2) % 6 != 0:
        raise ValueError('resnet_cifar10 depth must be 6n+2, got %d' % depth)
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input, ch_out=16, filter_size=3, stride=1,
                          padding=1, is_test=is_test)
    res1 = layer_warp(basicblock, conv1, 16, n, 1, is_test)
    res2 = layer_warp(basicblock, res1, 32, n, 2, is_test)
    res3 = layer_warp(basicblock, res2, 64, n, 2, is_test)
    pool = layers.pool2d(input=res3, pool_size=8, pool_type='avg',
                         global_pooling=True)
    return layers.fc(input=pool, size=class_dim, act='softmax')


def resnet50_with_loss(input=None, label=None, class_dim=1000,
                       image_shape=(3, 224, 224), is_test=False,
                       data_format='NHWC'):
    """ResNet-50 with its loss and accuracy: (softmax output, mean
    cross-entropy, accuracy). The feed 'image' is NCHW float32, 'label'
    [N, 1] int64. NHWC, the default, is the layout in which cuDNN's bf16
    convolutions take their inputs as they are."""
    if input is None:
        input = layers.data(name='image', shape=list(image_shape),
                            dtype='float32')
    if label is None:
        label = layers.data(name='label', shape=[1], dtype='int64')
    predict = resnet_imagenet(input, class_dim=class_dim, is_test=is_test,
                              data_format=data_format)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=predict, label=label)
    return predict, avg_cost, acc


def make_fake_batch(batch, image=224, class_dim=1000, seed=0):
    """bench.py's ResNet feed: RandomState(seed) rand images [batch, 3,
    image, image] float32 in [0, 1) and randint labels [batch, 1] int64."""
    rng = np.random.RandomState(seed)
    return {'image': rng.rand(batch, 3, image, image).astype('float32'),
            'label': rng.randint(0, class_dim, (batch, 1)).astype('int64')}


def forward_macs_per_image(program):
    """Multiply-accumulates of one image's forward pass through the
    program's conv2d and mul ops, counted from the var shapes the layers
    recorded (batch dimension excluded)."""
    block = program.global_block()
    macs = 0
    for op in block.ops:
        if op.type == 'conv2d':
            out = block.var(op.output('Output')).shape
            w = block.var(op.input('Filter')).shape
            nhwc = op.attrs.get('data_format', 'NCHW') == 'NHWC'
            oh, ow = (out[1], out[2]) if nhwc else (out[2], out[3])
            macs += oh * ow * w[0] * w[1] * w[2] * w[3]
        elif op.type == 'mul':
            w = block.var(op.input('Y')).shape
            macs += w[0] * w[1]
    return macs
