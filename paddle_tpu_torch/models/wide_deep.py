"""Wide&Deep CTR model (reference: paddle_tpu models/wide_deep.py; the ctr
demo: a wide logistic part over the sparse slots and a deep MLP over their
embeddings; BASELINE config 5).

Every table is ``is_sparse``: under SGD, Adagrad, or Adam and Momentum
with ``lazy_mode``, its gradient is the [batch, dim] rows of its lookup,
merged and applied in place by the sparse_rows kernel
(ops/kernels/sparse_rows.py), never a dense [vocab, dim] gradient.
"""

from .. import layers
from ..param_attr import ParamAttr


def wide_deep_net(sparse_ids, dense_feat, label, vocab_sizes,
                  embed_size=16, hidden_sizes=(64, 32), is_test=False):
    """sparse_ids: list of int64 id Variables (one per slot);
    dense_feat: float dense features [B, D]; label: int64 [B, 1].
    Returns (predict, avg_cost, acc)."""
    # ---- deep part: per-slot embeddings -> MLP
    embs = []
    for i, (ids, vocab) in enumerate(zip(sparse_ids, vocab_sizes)):
        embs.append(layers.embedding(
            input=ids, size=[vocab, embed_size], dtype='float32',
            is_sparse=True, param_attr=ParamAttr(name='emb_slot_%d' % i)))
    deep = layers.concat(input=embs + [dense_feat], axis=-1)
    for h in hidden_sizes:
        deep = layers.fc(input=deep, size=h, act='relu')

    # ---- wide part: one weight per id (linear over the sparse slots)
    wides = []
    for i, (ids, vocab) in enumerate(zip(sparse_ids, vocab_sizes)):
        wides.append(layers.embedding(
            input=ids, size=[vocab, 1], dtype='float32', is_sparse=True,
            param_attr=ParamAttr(name='wide_slot_%d' % i)))
    wide = layers.concat(input=wides + [dense_feat], axis=-1)

    merged = layers.concat(input=[wide, deep], axis=-1)
    predict = layers.fc(input=merged, size=2, act='softmax')
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=predict, label=label)
    return predict, avg_cost, acc


def build(num_slots=8, vocab_size=1000, dense_dim=13, embed_size=16):
    """The standard CTR layout: ``num_slots`` sparse slots (C0, C1, ...)
    of ``vocab_size`` rows and ``dense_dim`` dense features. Returns
    (predict, avg_cost, acc, feed names)."""
    sparse_ids = [layers.data(name='C%d' % i, shape=[1], dtype='int64')
                  for i in range(num_slots)]
    dense = layers.data(name='dense', shape=[dense_dim], dtype='float32')
    label = layers.data(name='label', shape=[1], dtype='int64')
    vocab_sizes = [vocab_size] * num_slots
    predict, avg_cost, acc = wide_deep_net(sparse_ids, dense, label,
                                           vocab_sizes, embed_size)
    feeds = ['C%d' % i for i in range(num_slots)] + ['dense', 'label']
    return predict, avg_cost, acc, feeds
