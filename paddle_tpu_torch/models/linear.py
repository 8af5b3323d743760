"""fit_a_line: linear regression on UCI housing (the reference's first book
chapter and smallest end-to-end config)."""

from .. import layers


def fit_a_line(x=None, y=None, feature_dim=13):
    """Build y_hat = xW + b with MSE loss. Returns (prediction, avg_loss)."""
    if x is None:
        x = layers.data(name='x', shape=[feature_dim], dtype='float32')
    if y is None:
        y = layers.data(name='y', shape=[1], dtype='float32')
    y_predict = layers.fc(input=x, size=1, act=None)
    cost = layers.square_error_cost(input=y_predict, label=y)
    avg_cost = layers.mean(cost)
    return y_predict, avg_cost
