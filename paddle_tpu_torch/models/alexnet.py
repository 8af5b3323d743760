"""AlexNet (reference: paddle_tpu models/alexnet.py;
benchmark/paddle/image/alexnet.py): five convs with cross-channel LRN after
the first two, three max pools and two dropout fc layers of 4096. The
6x6x256 flatten into the first fc needs a 224x224-class input (any size
whose conv stack keeps at least one spatial cell builds)."""

from .. import layers


def alexnet(input, class_dim=1000, is_test=False):
    """benchmark/paddle/image/alexnet.py topology (conv1 11x11/4 ...
    fc8), LRN with the benchmark's size-5 window."""
    conv1 = layers.conv2d(input, num_filters=96, filter_size=11, stride=4,
                          padding=1, act='relu')
    norm1 = layers.lrn(conv1, n=5, k=2.0, alpha=1e-4, beta=0.75)
    pool1 = layers.pool2d(norm1, pool_size=3, pool_stride=2)

    conv2 = layers.conv2d(pool1, num_filters=256, filter_size=5, padding=2,
                          groups=1, act='relu')
    norm2 = layers.lrn(conv2, n=5, k=2.0, alpha=1e-4, beta=0.75)
    pool2 = layers.pool2d(norm2, pool_size=3, pool_stride=2)

    conv3 = layers.conv2d(pool2, num_filters=384, filter_size=3, padding=1,
                          act='relu')
    conv4 = layers.conv2d(conv3, num_filters=384, filter_size=3, padding=1,
                          act='relu')
    conv5 = layers.conv2d(conv4, num_filters=256, filter_size=3, padding=1,
                          act='relu')
    pool3 = layers.pool2d(conv5, pool_size=3, pool_stride=2)

    fc6 = layers.fc(input=pool3, size=4096, act='relu')
    drop6 = layers.dropout(fc6, dropout_prob=0.5, is_test=is_test)
    fc7 = layers.fc(input=drop6, size=4096, act='relu')
    drop7 = layers.dropout(fc7, dropout_prob=0.5, is_test=is_test)
    return layers.fc(input=drop7, size=class_dim, act='softmax')
