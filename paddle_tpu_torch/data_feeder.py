"""DataFeeder (reference: paddle_tpu data_feeder.py;
python/paddle/fluid/data_feeder.py).

Converts reader minibatches (lists of example tuples) into the dense
numpy feed dict the Executor takes. LoD (ragged) slots are padded to the
batch's longest with an auxiliary '<name>_len' int32 vector, as in the
JAX package.
"""

import numpy as np

from .core.dtypes import canonical_dtype
from .core.program import Variable, default_main_program


__all__ = ['DataFeeder']


class DataFeeder(object):
    def __init__(self, feed_list, place=None, program=None):
        self.program = program if program is not None else \
            default_main_program()
        self.feed_vars = []
        for v in feed_list:
            if isinstance(v, str):
                v = self.program.global_block().var(v)
            if not isinstance(v, Variable):
                raise TypeError('feed_list items must be Variable or name')
            self.feed_vars.append(v)
        self.place = place

    def feed(self, iterable):
        rows = list(iterable)
        if not rows:
            raise ValueError('empty minibatch')
        feed = {}
        for i, var in enumerate(self.feed_vars):
            cols = [row[i] for row in rows]
            dtype = canonical_dtype(var.dtype)
            if var.lod_level and var.lod_level > 0:
                arrs = [np.asarray(c) for c in cols]
                max_len = max(a.shape[0] for a in arrs)
                tail = arrs[0].shape[1:]
                batch = np.zeros((len(arrs), max_len) + tail, dtype=dtype)
                lengths = np.zeros((len(arrs),), dtype='int32')
                for j, a in enumerate(arrs):
                    batch[j, :a.shape[0]] = a
                    lengths[j] = a.shape[0]
                feed[var.name] = batch
                feed[var.name + '_len'] = lengths
            else:
                arr = np.asarray(cols)
                shape = var.shape
                if shape is not None:
                    want = [s for s in shape]
                    # align trailing dims, e.g. label [-1, 1] from scalars
                    if len(arr.shape) < len(want) and want[-1] == 1:
                        arr = arr.reshape(arr.shape + (1,))
                feed[var.name] = arr.astype(dtype)
        return feed
