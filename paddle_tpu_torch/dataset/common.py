"""Shared dataset helpers (reference: paddle_tpu dataset/common.py): the
seeded generator the synthetic data is drawn from."""

import hashlib

import numpy as np


def rng(name, split):
    """Deterministic per-(dataset, split) generator for synthetic data (the
    reference's seeds, so both packages draw the same data)."""
    seed = int(hashlib.md5(('%s/%s' % (name, split)).encode()).hexdigest()[:8],
               16)
    return np.random.RandomState(seed)
