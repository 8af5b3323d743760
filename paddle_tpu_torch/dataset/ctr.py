"""Synthetic CTR dataset for Wide&Deep (reference: paddle_tpu
dataset/ctr.py): the Criteo schema, 13 dense features and 26 categorical
hashes -> click, drawn from the reference's seeded generators (the same
items as the JAX package's)."""

import numpy as np

from . import common

DENSE_DIM = 13
SPARSE_SLOTS = 26
HASH_DIM = 10 ** 4
_TRAIN_N = 8192
_TEST_N = 1024


def _synthetic(split, n):
    r = common.rng('ctr', split)
    dense = r.rand(n, DENSE_DIM).astype('float32')
    sparse = r.randint(0, HASH_DIM, size=(n, SPARSE_SLOTS)).astype('int64')
    w_d = common.rng('ctr', 'wd').randn(DENSE_DIM) * 0.5
    w_s = common.rng('ctr', 'ws').randn(HASH_DIM) * 0.1
    logit = dense @ w_d + w_s[sparse].sum(axis=1) - 1.0
    click = (1.0 / (1.0 + np.exp(-logit)) > r.rand(n)).astype('int64')
    return dense, sparse, click


def _reader(split, n):
    def reader():
        dense, sparse, click = _synthetic(split, n)
        for i in range(n):
            yield dense[i], sparse[i], int(click[i])
    return reader


def train():
    """Reader of the 8,192 training items: (dense [13] float32, sparse [26]
    int64, click int)."""
    return _reader('train', _TRAIN_N)


def test():
    """Reader of the 1,024 test items."""
    return _reader('test', _TEST_N)
