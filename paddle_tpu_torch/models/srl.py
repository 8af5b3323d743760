"""Semantic role labeling: stacked bi-GRU emissions + linear-chain CRF.

Reference: the label_semantic_roles book chapter (an 8-feature stacked
bidirectional LSTM feeding linear_chain_crf / crf_decoding over conll05).
Padded [B, T] grids with a per-example length vector: the CRF loss and
Viterbi decode are the log-domain recurrences of ops/decode_ops.py, so
train and decode both run in the captured step.
"""

from .. import layers
from ..param_attr import ParamAttr


def srl_tagger(word, mark, target, word_dict_len, label_dict_len,
               mark_dict_len=2, emb_dim=32, hidden_dim=64, depth=2,
               length=None):
    """Returns (emission, crf_cost, avg_cost). Feeds: word [B, T] int64,
    mark [B, T] int64 (predicate-position feature, the chapter's
    mark_dict role), target [B, T] int64, plus `length` [B] for padding.
    """
    word_emb = layers.embedding(input=word,
                                size=[word_dict_len, emb_dim],
                                dtype='float32')
    mark_emb = layers.embedding(input=mark,
                                size=[mark_dict_len, emb_dim // 2],
                                dtype='float32')
    hidden = layers.concat([word_emb, mark_emb], axis=2)
    for i in range(depth):
        # dynamic_gru consumes a 3h pre-projection of its input
        proj = layers.fc(input=hidden, size=hidden_dim * 3,
                         num_flatten_dims=2)
        hidden = layers.dynamic_gru(input=proj, size=hidden_dim,
                                    is_reverse=(i % 2) == 1,
                                    length=length)
    emission = layers.fc(input=hidden, size=label_dict_len,
                         num_flatten_dims=2,
                         param_attr=ParamAttr(name='srl_emission.w'))
    crf_cost = layers.linear_chain_crf(
        input=emission, label=target, length=length,
        param_attr=ParamAttr(name='srl_crf.w'))
    avg_cost = layers.mean(crf_cost)
    return emission, crf_cost, avg_cost


def srl_decode(emission, length=None):
    """Viterbi decode sharing the trained transition ('srl_crf.w')."""
    return layers.crf_decoding(
        input=emission, length=length,
        param_attr=ParamAttr(name='srl_crf.w'))
