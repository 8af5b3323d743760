"""Transformer NMT (reference: paddle_tpu models/transformer.py, the
benchmark Transformer "base" en-de configuration): the unrolled training
graph (``transformer``, ``transformer_base``, ``transformer_big``), its
synthetic feed (``make_fake_batch``), and the building blocks the decode
LM uses (the sinusoid position table and the [n_layer, ...]-stacked layer
parameters).

Attention is the ``fused_attention`` op (the flash attention kernels on
the card) with padding masks derived in-graph from a per-example length
vector; the position table is a non-trainable parameter sliced per step.
Parameter names equal the JAX package's, so its weights load as they are.
Not ported: the ``scan_layers`` layer stack and the inference graphs.
"""

import numpy as np

from .. import layers
from ..initializer import Constant, Normal, NumpyArrayInitializer, Xavier
from ..layers.helper import LayerHelper
from ..param_attr import ParamAttr

FEED_NAMES = ['src_word', 'src_length', 'trg_word', 'lbl_word', 'lbl_weight']


def position_encoding_table(max_length, d_model):
    """Sinusoidal position table [max_length, d_model] (host-computed once,
    lives on the device as a frozen parameter)."""
    pos = np.arange(max_length)[:, None].astype('float64')
    dim = np.arange(0, d_model, 2).astype('float64')
    inv = 1.0 / np.power(10000.0, dim / d_model)
    angles = pos * inv[None, :]
    table = np.zeros((max_length, d_model), dtype='float32')
    table[:, 0::2] = np.sin(angles)
    table[:, 1::2] = np.cos(angles)
    return table


def _multi_head_attention(queries, keys, values, d_key, d_value, d_model,
                          n_head, dropout_rate, causal=False,
                          key_length=None, name='attn'):
    q = layers.fc(input=queries, size=d_key * n_head, num_flatten_dims=2,
                  bias_attr=False, param_attr=ParamAttr(name=name + '_q.w'))
    k = layers.fc(input=keys, size=d_key * n_head, num_flatten_dims=2,
                  bias_attr=False, param_attr=ParamAttr(name=name + '_k.w'))
    v = layers.fc(input=values, size=d_value * n_head, num_flatten_dims=2,
                  bias_attr=False, param_attr=ParamAttr(name=name + '_v.w'))
    helper = LayerHelper('fused_attention', name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    if q.shape is not None:
        out.shape = (q.shape[0], q.shape[1], d_value * n_head)
    inputs = {'Q': [q], 'K': [k], 'V': [v]}
    if key_length is not None:
        inputs['KeyLength'] = [key_length]
    helper.append_op(type='fused_attention', inputs=inputs,
                     outputs={'Out': [out]},
                     attrs={'n_head': n_head, 'causal': causal,
                            'dropout_rate': dropout_rate})
    return layers.fc(input=out, size=d_model, num_flatten_dims=2,
                     bias_attr=False,
                     param_attr=ParamAttr(name=name + '_out.w'))


def _ffn(x, d_inner, d_model, dropout_rate, name='ffn'):
    hidden = layers.fc(input=x, size=d_inner, num_flatten_dims=2,
                       act='relu', param_attr=ParamAttr(name=name + '_1.w'),
                       bias_attr=ParamAttr(name=name + '_1.b'))
    if dropout_rate:
        hidden = layers.dropout(hidden, dropout_prob=dropout_rate)
    return layers.fc(input=hidden, size=d_model, num_flatten_dims=2,
                     param_attr=ParamAttr(name=name + '_2.w'),
                     bias_attr=ParamAttr(name=name + '_2.b'))


def _post_process(prev, out, dropout_rate, name='pp'):
    """dropout, residual add, layer_norm (the reference's "dan" chain)."""
    if dropout_rate:
        out = layers.dropout(out, dropout_prob=dropout_rate)
    added = layers.elementwise_add(x=out, y=prev)
    return layers.layer_norm(added, begin_norm_axis=len(added.shape) - 1,
                             param_attr=ParamAttr(name=name + '_ln.w'),
                             bias_attr=ParamAttr(name=name + '_ln.b'))


def _prepare_input(word_ids, vocab_size, d_model, max_length, dropout_rate,
                   emb_name, pos_table):
    emb = layers.embedding(
        input=word_ids, size=[vocab_size, d_model], dtype='float32',
        param_attr=ParamAttr(name=emb_name,
                             initializer=Normal(0., d_model ** -0.5)))
    if len(emb.shape) == 2:
        # a [B, 1] id column squeezes to [B, d]; keep the sequence axis
        emb = layers.reshape(x=emb, shape=[0, 1, d_model])
    emb = layers.scale(x=emb, scale=d_model ** 0.5)
    seq_len = word_ids.shape[1]
    pos_enc = layers.create_parameter(
        shape=[max_length, d_model], dtype='float32',
        name=emb_name + '_pos_enc',
        attr=ParamAttr(name=emb_name + '_pos_enc',
                       initializer=NumpyArrayInitializer(pos_table),
                       trainable=False))
    pos_slice = layers.slice(pos_enc, axes=[0], starts=[0], ends=[seq_len])
    pos_slice = layers.reshape(x=pos_slice, shape=[1, seq_len, d_model])
    out = layers.elementwise_add(x=emb, y=pos_slice)
    if dropout_rate:
        out = layers.dropout(out, dropout_prob=dropout_rate)
    return out


def encoder_layer(x, n_head, d_key, d_value, d_model, d_inner, dropout_rate,
                  src_length=None, name='enc'):
    attn = _multi_head_attention(x, x, x, d_key, d_value, d_model, n_head,
                                 dropout_rate, key_length=src_length,
                                 name=name + '_slf')
    x = _post_process(x, attn, dropout_rate, name=name + '_pp1')
    ffn = _ffn(x, d_inner, d_model, dropout_rate, name=name + '_ffn')
    return _post_process(x, ffn, dropout_rate, name=name + '_pp2')


def decoder_layer(x, enc_out, n_head, d_key, d_value, d_model, d_inner,
                  dropout_rate, src_length=None, name='dec'):
    slf = _multi_head_attention(x, x, x, d_key, d_value, d_model, n_head,
                                dropout_rate, causal=True,
                                name=name + '_slf')
    x = _post_process(x, slf, dropout_rate, name=name + '_pp1')
    cross = _multi_head_attention(x, enc_out, enc_out, d_key, d_value,
                                  d_model, n_head, dropout_rate,
                                  key_length=src_length,
                                  name=name + '_cross')
    x = _post_process(x, cross, dropout_rate, name=name + '_pp2')
    ffn = _ffn(x, d_inner, d_model, dropout_rate, name=name + '_ffn')
    return _post_process(x, ffn, dropout_rate, name=name + '_pp3')


def transformer(src_vocab_size, trg_vocab_size, max_length=256,
                n_layer=6, n_head=8, d_key=64, d_value=64, d_model=512,
                d_inner=2048, dropout_rate=0.1, label_smooth_eps=0.1,
                src_seq_len=None, trg_seq_len=None, batch_size=None,
                weight_sharing=False, scan_layers=None):
    """Build the training graph. Feeds: src_word [B, S] int64,
    src_length [B] int64, trg_word [B, T] int64 (decoder input), lbl_word
    [B, T] int64 (shifted target), lbl_weight [B, T] float32 (1 for real
    tokens, 0 for pads). Returns (avg_cost, logits). The layers are
    unrolled; ``scan_layers`` (one stacked layer op per side) is not
    ported and raises."""
    if scan_layers:
        raise NotImplementedError('transformer(scan_layers=True): the '
                                  'stacked layer op is not ported')
    src_word = layers.data(name='src_word', shape=[src_seq_len],
                           dtype='int64')
    src_length = layers.data(name='src_length', shape=[], dtype='int64')
    trg_word = layers.data(name='trg_word', shape=[trg_seq_len],
                           dtype='int64')
    lbl_word = layers.data(name='lbl_word', shape=[trg_seq_len],
                           dtype='int64')
    lbl_weight = layers.data(name='lbl_weight', shape=[trg_seq_len],
                             dtype='float32')
    pos_table = position_encoding_table(max_length, d_model)

    x = _prepare_input(src_word, src_vocab_size, d_model, max_length,
                       dropout_rate, 'src_emb', pos_table)
    for i in range(n_layer):
        x = encoder_layer(x, n_head, d_key, d_value, d_model, d_inner,
                          dropout_rate, src_length=src_length,
                          name='enc_%d' % i)
    enc_out = x

    y = _prepare_input(trg_word, trg_vocab_size, d_model, max_length,
                       dropout_rate,
                       'src_emb' if weight_sharing else 'trg_emb', pos_table)
    for i in range(n_layer):
        y = decoder_layer(y, enc_out, n_head, d_key, d_value, d_model,
                          d_inner, dropout_rate, src_length=src_length,
                          name='dec_%d' % i)

    logits = layers.fc(input=y, size=trg_vocab_size, num_flatten_dims=2,
                       bias_attr=False,
                       param_attr=ParamAttr(name='out_proj.w'))
    if label_smooth_eps:
        cost = layers.label_smoothed_cross_entropy(
            logits=logits, label=lbl_word, epsilon=label_smooth_eps)
    else:
        lbl3 = layers.unsqueeze(lbl_word, axes=[2])
        cost = layers.softmax_with_cross_entropy(logits=logits, label=lbl3)
    cost = layers.reshape(x=cost, shape=list(lbl_weight.shape))
    weighted = layers.elementwise_mul(x=cost, y=lbl_weight)
    sum_cost = layers.reduce_sum(weighted)
    token_count = layers.reduce_sum(lbl_weight)
    avg_cost = layers.elementwise_div(x=sum_cost, y=token_count)
    return avg_cost, logits


def transformer_base(src_vocab_size=32000, trg_vocab_size=32000,
                     src_seq_len=64, trg_seq_len=64, **overrides):
    """The reference "base" configuration."""
    cfg = dict(n_layer=6, n_head=8, d_key=64, d_value=64, d_model=512,
               d_inner=2048, dropout_rate=0.1, label_smooth_eps=0.1,
               src_seq_len=src_seq_len, trg_seq_len=trg_seq_len)
    cfg.update(overrides)
    return transformer(src_vocab_size, trg_vocab_size, **cfg)


def transformer_big(src_vocab_size=32000, trg_vocab_size=32000,
                    src_seq_len=64, trg_seq_len=64, **overrides):
    """The reference "big" configuration (d_model 1024, 16 heads,
    d_inner 4096, dropout 0.3)."""
    cfg = dict(n_layer=6, n_head=16, d_key=64, d_value=64, d_model=1024,
               d_inner=4096, dropout_rate=0.3, label_smooth_eps=0.1,
               src_seq_len=src_seq_len, trg_seq_len=trg_seq_len)
    cfg.update(overrides)
    return transformer(src_vocab_size, trg_vocab_size, **cfg)


def make_fake_batch(batch_size, src_seq_len, trg_seq_len, src_vocab_size,
                    trg_vocab_size, seed=0):
    """Synthetic feed dict (the JAX package's, draw for draw)."""
    rng = np.random.RandomState(seed)
    return {
        'src_word': rng.randint(1, src_vocab_size,
                                (batch_size, src_seq_len)).astype('int64'),
        'src_length': np.full((batch_size,), src_seq_len, dtype='int64'),
        'trg_word': rng.randint(1, trg_vocab_size,
                                (batch_size, trg_seq_len)).astype('int64'),
        'lbl_word': rng.randint(1, trg_vocab_size,
                                (batch_size, trg_seq_len)).astype('int64'),
        'lbl_weight': np.ones((batch_size, trg_seq_len), dtype='float32'),
    }


def train_step_flops(batch, src_len, trg_len, vocab, n_layer=6, n_head=8,
                     d_key=64, d_model=512, d_inner=2048):
    """Analytic matmul FLOPs of one training step at the padded shapes:
    the projections, the two attention products, the FFN and the logits
    of the forward, times 3 for forward + backward (the optimizer update
    is left out). The same accounting as the JAX package's bench.py
    ``_transformer_train_flops``, so MFU compares across the two."""
    B, S, T = float(batch), float(src_len), float(trg_len)

    def proj(tokens, din, dout):
        return 2.0 * tokens * din * dout

    enc = n_layer * (
        4 * proj(B * S, d_model, d_model)             # q, k, v, o
        + 2 * 2.0 * B * n_head * S * S * d_key        # q.k^T and p.v
        + 2 * proj(B * S, d_model, d_inner))          # both FFN matrices
    dec = n_layer * (
        4 * proj(B * T, d_model, d_model)             # self q, k, v, o
        + 2 * 2.0 * B * n_head * T * T * d_key
        + 2 * proj(B * T, d_model, d_model)           # cross q, o
        + 2 * proj(B * S, d_model, d_model)           # cross k, v
        + 2 * 2.0 * B * n_head * T * S * d_key
        + 2 * proj(B * T, d_model, d_inner))
    logits = proj(B * T, d_model, vocab)
    return 3.0 * (enc + dec + logits)


def _stack_param(name, shape, fan_in, fan_out, constant=None):
    """[n_layer, ...] stacked parameter. Xavier fans are passed explicitly
    (the leading layer axis must not enter the fan computation)."""
    init = Constant(constant) if constant is not None else \
        Xavier(uniform=True, fan_in=fan_in, fan_out=fan_out)
    return layers.create_parameter(
        shape=shape, dtype='float32', name=name,
        attr=ParamAttr(name=name, initializer=init))


def _stacked_layer_params(prefix, n_layer, n_head, d_key, d_value, d_model,
                          d_inner, decoder=False):
    """The layer stack's weight dict, stacked on a leading [n_layer] axis
    (ops/transformer_ops.py slot layout)."""
    L = n_layer
    p = {}

    def attn(pre):
        p[pre + '_q'] = _stack_param('%s_%s_q.w' % (prefix, pre),
                                     [L, d_model, d_key * n_head],
                                     d_model, d_key * n_head)
        p[pre + '_k'] = _stack_param('%s_%s_k.w' % (prefix, pre),
                                     [L, d_model, d_key * n_head],
                                     d_model, d_key * n_head)
        p[pre + '_v'] = _stack_param('%s_%s_v.w' % (prefix, pre),
                                     [L, d_model, d_value * n_head],
                                     d_model, d_value * n_head)
        p[pre + '_o'] = _stack_param('%s_%s_o.w' % (prefix, pre),
                                     [L, d_value * n_head, d_model],
                                     d_value * n_head, d_model)

    def ln(slot):
        p[slot + '_w'] = _stack_param('%s_%s.w' % (prefix, slot),
                                      [L, d_model], 0, 0, constant=1.0)
        p[slot + '_b'] = _stack_param('%s_%s.b' % (prefix, slot),
                                      [L, d_model], 0, 0, constant=0.0)

    attn('slf')
    ln('ln1')
    if decoder:
        attn('cross')
        ln('ln2')
    p['ffn_w1'] = _stack_param('%s_ffn_1.w' % prefix,
                               [L, d_model, d_inner], d_model, d_inner)
    p['ffn_b1'] = _stack_param('%s_ffn_1.b' % prefix, [L, d_inner],
                               0, 0, constant=0.0)
    p['ffn_w2'] = _stack_param('%s_ffn_2.w' % prefix,
                               [L, d_inner, d_model], d_inner, d_model)
    p['ffn_b2'] = _stack_param('%s_ffn_2.b' % prefix, [L, d_model],
                               0, 0, constant=0.0)
    ln('ln3' if decoder else 'ln2')
    return p
