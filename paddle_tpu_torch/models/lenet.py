"""MNIST digit recognition nets (reference: paddle_tpu models/lenet.py;
the recognize_digits chapter): softmax regression, the MLP and the
LeNet-5-style convnet over nets.simple_img_conv_pool."""

from .. import layers, nets


def softmax_regression(img=None, label=None):
    if img is None:
        img = layers.data(name='img', shape=[1, 28, 28], dtype='float32')
    if label is None:
        label = layers.data(name='label', shape=[1], dtype='int64')
    predict = layers.fc(input=img, size=10, act='softmax',
                        num_flatten_dims=1)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=predict, label=label)
    return predict, avg_cost, acc


def multilayer_perceptron(img=None, label=None):
    if img is None:
        img = layers.data(name='img', shape=[1, 28, 28], dtype='float32')
    if label is None:
        label = layers.data(name='label', shape=[1], dtype='int64')
    hidden = layers.fc(input=img, size=128, act='relu')
    hidden = layers.fc(input=hidden, size=64, act='relu')
    predict = layers.fc(input=hidden, size=10, act='softmax')
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=predict, label=label)
    return predict, avg_cost, acc


def convolutional_neural_network(img=None, label=None):
    """LeNet-5 style conv-pool x2 + fc, as in the reference chapter."""
    if img is None:
        img = layers.data(name='img', shape=[1, 28, 28], dtype='float32')
    if label is None:
        label = layers.data(name='label', shape=[1], dtype='int64')
    conv_pool_1 = nets.simple_img_conv_pool(
        input=img, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act='relu')
    conv_pool_2 = nets.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act='relu')
    predict = layers.fc(input=conv_pool_2, size=10, act='softmax')
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=predict, label=label)
    return predict, avg_cost, acc


lenet = convolutional_neural_network
