"""GoogLeNet / Inception-v1 (reference: paddle_tpu models/googlenet.py;
benchmark/paddle/image/googlenet.py): the stem, nine inception modules
(four towers concatenated on the channel axis) in three stages, a global
average pool and one classifier; the benchmark config's auxiliary heads
are off, as there."""

from .. import layers


def inception(input, filter1, filter3r, filter3, filter5r, filter5, proj,
              name=None):
    """One inception module (googlenet.py inception2): 1x1, 1x1->3x3,
    1x1->5x5, and 3x3maxpool->1x1proj towers, channel-concatenated."""
    tower1 = layers.conv2d(input, num_filters=filter1, filter_size=1,
                           act='relu')
    tower3r = layers.conv2d(input, num_filters=filter3r, filter_size=1,
                            act='relu')
    tower3 = layers.conv2d(tower3r, num_filters=filter3, filter_size=3,
                           padding=1, act='relu')
    tower5r = layers.conv2d(input, num_filters=filter5r, filter_size=1,
                            act='relu')
    tower5 = layers.conv2d(tower5r, num_filters=filter5, filter_size=5,
                           padding=2, act='relu')
    towerp = layers.pool2d(input, pool_size=3, pool_stride=1,
                           pool_padding=1)
    towerproj = layers.conv2d(towerp, num_filters=proj, filter_size=1,
                              act='relu')
    return layers.concat([tower1, tower3, tower5, towerproj], axis=1)


def googlenet(input, class_dim=1000, is_test=False):
    """benchmark/paddle/image/googlenet.py topology; aux heads off."""
    # stem: conv7/2 - pool - conv1 - conv3 - pool
    conv1 = layers.conv2d(input, num_filters=64, filter_size=7, stride=2,
                          padding=3, act='relu')
    pool1 = layers.pool2d(conv1, pool_size=3, pool_stride=2)
    conv2r = layers.conv2d(pool1, num_filters=64, filter_size=1, act='relu')
    conv2 = layers.conv2d(conv2r, num_filters=192, filter_size=3, padding=1,
                          act='relu')
    pool2 = layers.pool2d(conv2, pool_size=3, pool_stride=2)

    ince3a = inception(pool2, 64, 96, 128, 16, 32, 32)
    ince3b = inception(ince3a, 128, 128, 192, 32, 96, 64)
    pool3 = layers.pool2d(ince3b, pool_size=3, pool_stride=2)

    ince4a = inception(pool3, 192, 96, 208, 16, 48, 64)
    ince4b = inception(ince4a, 160, 112, 224, 24, 64, 64)
    ince4c = inception(ince4b, 128, 128, 256, 24, 64, 64)
    ince4d = inception(ince4c, 112, 144, 288, 32, 64, 64)
    ince4e = inception(ince4d, 256, 160, 320, 32, 128, 128)
    pool4 = layers.pool2d(ince4e, pool_size=3, pool_stride=2)

    ince5a = inception(pool4, 256, 160, 320, 32, 128, 128)
    ince5b = inception(ince5a, 384, 192, 384, 48, 128, 128)

    pool5 = layers.pool2d(ince5b, pool_type='avg', global_pooling=True)
    drop = layers.dropout(pool5, dropout_prob=0.4, is_test=is_test)
    return layers.fc(input=drop, size=class_dim, act='softmax')
