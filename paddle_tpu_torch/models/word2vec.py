"""word2vec N-gram language model (reference: paddle_tpu
models/word2vec.py; the word2vec book chapter on imikolov): 4 context
words -> one shared embedding -> concat -> hidden -> softmax over the
vocabulary.

The shared table is read by four lookups, so even with ``is_sparse=True``
it takes the dense gradient (core/backward.py: a row-sparse table has
exactly one lookup)."""

from .. import layers
from ..param_attr import ParamAttr

EMBED_SIZE = 32
HIDDEN_SIZE = 256
N = 5  # n-gram window


def inference_program(words, dict_size, embed_size=EMBED_SIZE,
                      hidden_size=HIDDEN_SIZE, is_sparse=False):
    """words: list of 4 int64 context-word Variables."""
    embs = []
    for w in words:
        embs.append(layers.embedding(
            input=w, size=[dict_size, embed_size], dtype='float32',
            is_sparse=is_sparse, param_attr=ParamAttr(name='shared_w')))
    concat_embed = layers.concat(input=embs, axis=-1)
    hidden1 = layers.fc(input=concat_embed, size=hidden_size, act='sigmoid')
    return layers.fc(input=hidden1, size=dict_size, act='softmax')


def train_program(dict_size, is_sparse=False):
    """Builds the data vars and the loss. Returns (avg_cost,
    feed_names)."""
    first = layers.data(name='firstw', shape=[1], dtype='int64')
    second = layers.data(name='secondw', shape=[1], dtype='int64')
    third = layers.data(name='thirdw', shape=[1], dtype='int64')
    fourth = layers.data(name='fourthw', shape=[1], dtype='int64')
    next_word = layers.data(name='nextw', shape=[1], dtype='int64')
    predict = inference_program([first, second, third, fourth], dict_size,
                                is_sparse=is_sparse)
    cost = layers.cross_entropy(input=predict, label=next_word)
    avg_cost = layers.mean(cost)
    return avg_cost, ['firstw', 'secondw', 'thirdw', 'fourthw', 'nextw']
