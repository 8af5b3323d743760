"""Transformer NMT (reference: paddle_tpu models/transformer.py, the
benchmark Transformer "base" en-de configuration): the training graph
(``transformer``, ``transformer_base``, ``transformer_big``), unrolled or
with ``scan_layers`` (one transformer_layer_stack op a side over
[n_layer, ...]-stacked weights), its synthetic feed (``make_fake_batch``),
``stack_trained_weights`` (an unrolled-trained scope to the stacked
layout), and the inference graphs ``transformer_greedy_infer`` and
``transformer_beam_infer``: unrolled (the decoder re-run over the prefix
once a position) or, with ``incremental=True``, the KV-cached decode ops.

Attention is the ``fused_attention`` op (the flash attention kernels on
the card) with padding masks derived in-graph from a per-example length
vector; the position table is a non-trainable parameter sliced per step.
Parameter names equal the JAX package's, so its weights load as they are.
"""

import os
import re

import numpy as np
import torch

from .. import layers
from ..initializer import Constant, Normal, NumpyArrayInitializer, Xavier
from ..layers.helper import LayerHelper
from ..ops.transformer_ops import _slot_to_input
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


def _scan_layers(scan_layers):
    """The builders' scan_layers: None reads PADDLE_TPU_SCAN_LAYERS
    (default off)."""
    if scan_layers is None:
        return os.environ.get('PADDLE_TPU_SCAN_LAYERS') == '1'
    return scan_layers


def transformer(src_vocab_size, trg_vocab_size, max_length=256,
                n_layer=6, n_head=8, d_key=64, d_value=64, d_model=512,
                d_inner=2048, dropout_rate=0.1, label_smooth_eps=0.1,
                src_seq_len=None, trg_seq_len=None, batch_size=None,
                weight_sharing=False, scan_layers=None):
    """Build the training graph. Feeds: src_word [B, S] int64,
    src_length [B] int64, trg_word [B, T] int64 (decoder input), lbl_word
    [B, T] int64 (shifted target), lbl_weight [B, T] float32 (1 for real
    tokens, 0 for pads). Returns (avg_cost, logits).

    scan_layers: None reads PADDLE_TPU_SCAN_LAYERS (default off), as the
    JAX package does. When on, each side's n_layer layers are one
    transformer_layer_stack op over [n_layer, ...] stacked weights; it
    chooses the Program's layout, not a kernel or a device."""
    scan_layers = _scan_layers(scan_layers)
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

    dims = dict(n_layer=n_layer, n_head=n_head, d_key=d_key,
                d_value=d_value, d_model=d_model, d_inner=d_inner)
    x = _prepare_input(src_word, src_vocab_size, d_model, max_length,
                       dropout_rate, 'src_emb', pos_table)
    enc_out = _encoder(x, src_length, dims, dropout_rate, scan_layers)
    y = _prepare_input(trg_word, trg_vocab_size, d_model, max_length,
                       dropout_rate,
                       'src_emb' if weight_sharing else 'trg_emb', pos_table)
    y = _decoder(y, enc_out, src_length, dims, dropout_rate, scan_layers)

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


def _encoder(x, src_length, dims, dropout_rate, scan_layers):
    """The encoder's layers: unrolled, or one stack op over the
    'enc_stack_*' parameters."""
    if scan_layers:
        return _layer_stack(x, _stacked_layer_params('enc_stack', **dims),
                            dims['n_head'], dropout_rate,
                            src_length=src_length, name='enc_stack')
    for i in range(dims['n_layer']):
        x = encoder_layer(x, dims['n_head'], dims['d_key'], dims['d_value'],
                          dims['d_model'], dims['d_inner'], dropout_rate,
                          src_length=src_length, name='enc_%d' % i)
    return x


def _decoder(y, enc_out, src_length, dims, dropout_rate, scan_layers):
    """The decoder's layers: unrolled, or one stack op over the
    'dec_stack_*' parameters."""
    if scan_layers:
        return _layer_stack(y, _stacked_layer_params('dec_stack', **dims,
                                                     decoder=True),
                            dims['n_head'], dropout_rate, enc_out=enc_out,
                            src_length=src_length, name='dec_stack')
    for i in range(dims['n_layer']):
        y = decoder_layer(y, enc_out, dims['n_head'], dims['d_key'],
                          dims['d_value'], dims['d_model'], dims['d_inner'],
                          dropout_rate, src_length=src_length,
                          name='dec_%d' % i)
    return y


def _layer_stack(x, params, n_head, dropout_rate, enc_out=None,
                 src_length=None, name='stack'):
    """One transformer_layer_stack op over the stacked ``params``."""
    helper = LayerHelper('transformer_layer_stack', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    inputs = {'X': [x]}
    if enc_out is not None:
        inputs['EncOut'] = [enc_out]
    if src_length is not None:
        inputs['SrcLength'] = [src_length]
    for slot, param in params.items():
        inputs[_slot_to_input(slot)] = [param]
    helper.append_op(type='transformer_layer_stack', inputs=inputs,
                     outputs={'Out': [out]},
                     attrs={'n_head': n_head, 'dropout_rate': dropout_rate})
    return out


_UNROLLED_PARAM_RE = re.compile(
    r'^(enc|dec)_(\d+)_(slf|cross)_(q|k|v|out)\.w$|'
    r'^(enc|dec)_(\d+)_pp(\d)_ln\.(w|b)$|'
    r'^(enc|dec)_(\d+)_ffn_(1|2)\.(w|b)$')


def _unrolled_to_stacked_name(name):
    """An unrolled layer parameter's stacked name and layer index
    ('enc_0_slf_q.w' -> ('enc_stack_slf_q.w', 0), 'dec_3_pp1_ln.w' ->
    ('dec_stack_ln1.w', 3)); (None, None) for the others (embeddings,
    position tables, out_proj)."""
    m = _UNROLLED_PARAM_RE.match(name)
    if not m:
        return None, None
    if m.group(1):
        side, i = m.group(1), int(m.group(2))
        slot = '%s_%s.w' % (m.group(3),
                            'o' if m.group(4) == 'out' else m.group(4))
    elif m.group(5):
        side, i = m.group(5), int(m.group(6))
        slot = 'ln%s.%s' % (m.group(7), m.group(8))
    else:
        side, i = m.group(9), int(m.group(10))
        slot = 'ffn_%s.%s' % (m.group(11), m.group(12))
    return '%s_stack_%s' % (side, slot), i


def stack_trained_weights(scope, n_layer):
    """Stack an unrolled-trained scope's layer parameters onto the
    '[enc|dec]_stack_*' names the scan and incremental paths read
    (torch.stack on the scope's device; each name gets a new tensor, so a
    captured graph that read the old one is captured again). The other
    parameters share names already. Returns the stacked names."""
    stacks = {}
    for name in scope.keys():
        val = scope.find(name)
        if val is None:
            continue
        sname, i = _unrolled_to_stacked_name(name)
        if sname is not None:
            if i >= n_layer:
                raise ValueError(
                    'stack_trained_weights: %r has layer index %d but '
                    'n_layer=%d' % (name, i, n_layer))
            stacks.setdefault(sname, [None] * n_layer)[i] = val
    for sname, parts in stacks.items():
        missing = [i for i, p in enumerate(parts) if p is None]
        if missing:
            raise ValueError('stack_trained_weights: %r missing layers %s'
                             % (sname, missing))
        with torch.no_grad():
            scope.set(sname, torch.stack([torch.as_tensor(p) for p in parts]))
    return sorted(stacks)


# ---------------------------------------------------------------- inference
def _infer_cfg(src_vocab_size, trg_vocab_size, max_length, n_layer, n_head,
               d_key, d_value, d_model, d_inner, weight_sharing,
               scan_layers=None):
    scan_layers = _scan_layers(scan_layers)
    return dict(trg_vocab_size=trg_vocab_size, d_model=d_model,
                max_length=max_length, n_head=n_head,
                dims=dict(n_layer=n_layer, n_head=n_head, d_key=d_key,
                          d_value=d_value, d_model=d_model,
                          d_inner=d_inner),
                dec_emb_name='src_emb' if weight_sharing else 'trg_emb',
                pos_table=position_encoding_table(max_length, d_model),
                scan_layers=scan_layers)


def _decode_prefix(prefix_ids, enc_out, src_length, cfg):
    """The decoder stack over a [B*, t] prefix; returns the last
    position's logits [B*, V]. Parameter names are the training graph's
    (the stacked 'dec_stack_*' ones with cfg['scan_layers']), so a trained
    scope decodes as it is."""
    y = _prepare_input(prefix_ids, cfg['trg_vocab_size'], cfg['d_model'],
                       cfg['max_length'], 0.0, cfg['dec_emb_name'],
                       cfg['pos_table'])
    y = _decoder(y, enc_out, src_length, cfg['dims'], 0.0,
                 cfg['scan_layers'])
    logits = layers.fc(input=y, size=cfg['trg_vocab_size'],
                       num_flatten_dims=2, bias_attr=False,
                       param_attr=ParamAttr(name='out_proj.w'))
    t = prefix_ids.shape[1]
    last = layers.slice(logits, axes=[1], starts=[t - 1], ends=[t])
    return layers.reshape(x=last, shape=[0, cfg['trg_vocab_size']])


def _build_encoder(src_word, src_length, src_vocab_size, cfg):
    x = _prepare_input(src_word, src_vocab_size, cfg['d_model'],
                       cfg['max_length'], 0.0, 'src_emb', cfg['pos_table'])
    return _encoder(x, src_length, cfg['dims'], 0.0, cfg['scan_layers'])


def _incremental_decode_inputs(enc_out, src_length, cfg):
    """The KV-cached decode ops' inputs: the stacked decoder parameters
    ('dec_stack_*': a scan_layers-trained scope has them,
    stack_trained_weights makes them from an unrolled one) and the
    embedding, position table and output projection under the training
    graph's names."""
    emb = layers.create_parameter(
        shape=[cfg['trg_vocab_size'], cfg['d_model']], dtype='float32',
        name=cfg['dec_emb_name'],
        attr=ParamAttr(name=cfg['dec_emb_name'],
                       initializer=Normal(0., cfg['d_model'] ** -0.5)))
    pos_enc = layers.create_parameter(
        shape=[cfg['max_length'], cfg['d_model']], dtype='float32',
        name=cfg['dec_emb_name'] + '_pos_enc',
        attr=ParamAttr(name=cfg['dec_emb_name'] + '_pos_enc',
                       initializer=NumpyArrayInitializer(cfg['pos_table']),
                       trainable=False))
    wout = layers.create_parameter(
        shape=[cfg['d_model'], cfg['trg_vocab_size']], dtype='float32',
        name='out_proj.w', attr=ParamAttr(name='out_proj.w'))
    inputs = {'EncOut': [enc_out], 'Emb': [emb], 'PosEnc': [pos_enc],
              'OutProj': [wout]}
    if src_length is not None:
        inputs['SrcLength'] = [src_length]
    for slot, param in _stacked_layer_params('dec_stack', **cfg['dims'],
                                             decoder=True).items():
        inputs[_slot_to_input(slot)] = [param]
    return inputs


def _incremental_greedy(enc_out, src_length, cfg, max_out_len, bos_id,
                        eos_id):
    """The transformer_greedy_decode op: one position a step over
    key/value caches instead of max_out_len prefix re-runs."""
    inputs = _incremental_decode_inputs(enc_out, src_length, cfg)
    helper = LayerHelper('transformer_greedy_decode', name='greedy_decode')
    out = helper.create_variable_for_type_inference('int64')
    out.shape = (enc_out.shape[0], max_out_len)
    helper.append_op(type='transformer_greedy_decode', inputs=inputs,
                     outputs={'Out': [out]},
                     attrs={'n_head': cfg['n_head'],
                            'max_out_len': max_out_len,
                            'bos_id': bos_id, 'eos_id': eos_id})
    return out


def _incremental_beam(enc_out, src_length, cfg, beam_size, max_out_len,
                      bos_id, eos_id):
    """The transformer_beam_decode op (caches reordered by parent each
    step)."""
    inputs = _incremental_decode_inputs(enc_out, src_length, cfg)
    helper = LayerHelper('transformer_beam_decode', name='beam_decode')
    sent = helper.create_variable_for_type_inference('int64')
    sent.shape = (enc_out.shape[0], beam_size, max_out_len - 1)
    scores = helper.create_variable_for_type_inference('float32')
    scores.shape = (enc_out.shape[0], beam_size)
    steps = [helper.create_variable_for_type_inference('int64')
             for _ in range(2)]
    for v in steps:
        v.shape = (max_out_len - 1, enc_out.shape[0], beam_size)
    helper.append_op(type='transformer_beam_decode', inputs=inputs,
                     outputs={'SentenceIds': [sent],
                              'SentenceScores': [scores],
                              'StepIds': [steps[0]],
                              'StepParents': [steps[1]]},
                     attrs={'n_head': cfg['n_head'],
                            'max_out_len': max_out_len,
                            'beam_size': beam_size,
                            'bos_id': bos_id, 'eos_id': eos_id})
    return sent, scores


def transformer_greedy_infer(src_vocab_size, trg_vocab_size,
                             max_out_len=16, bos_id=0, eos_id=1,
                             src_seq_len=16, max_length=256, n_layer=6,
                             n_head=8, d_key=64, d_value=64, d_model=512,
                             d_inner=2048, weight_sharing=False,
                             scan_layers=None, incremental=False):
    """Greedy decode. incremental=False re-runs the decoder over the
    prefix once a position; incremental=True is the KV-cached
    transformer_greedy_decode op, which reads the decoder in the stacked
    layout (stack_trained_weights converts an unrolled-trained scope).
    Feeds: src_word [B, S], src_length [B]. Returns (out_ids [B, T], the
    feed names)."""
    cfg = _infer_cfg(src_vocab_size, trg_vocab_size, max_length, n_layer,
                     n_head, d_key, d_value, d_model, d_inner,
                     weight_sharing, scan_layers)
    src_word = layers.data(name='src_word', shape=[src_seq_len],
                           dtype='int64')
    src_length = layers.data(name='src_length', shape=[], dtype='int64')
    enc_out = _build_encoder(src_word, src_length, src_vocab_size, cfg)
    if incremental:
        ids = _incremental_greedy(enc_out, src_length, cfg, max_out_len,
                                  bos_id, eos_id)
        return ids, ['src_word', 'src_length']

    bos = layers.fill_constant_batch_size_like(
        src_word, shape=[1, 1], dtype='int64', value=bos_id)
    ids = bos
    for _t in range(1, max_out_len):
        logits = _decode_prefix(ids, enc_out, src_length, cfg)
        nxt = layers.argmax(logits, axis=-1)
        nxt = layers.reshape(x=nxt, shape=[0, 1])
        ids = layers.concat([ids, layers.cast(nxt, 'int64')], axis=1)
    # everything after the first EOS becomes EOS (the beam path has it
    # from beam_search_decode)
    eos = layers.fill_constant_batch_size_like(
        ids, shape=[1, max_out_len], dtype='int64', value=eos_id)
    is_eos = layers.cast(layers.equal(x=ids, y=eos), 'int64')
    before = layers.elementwise_sub(
        x=layers.cumsum(is_eos, axis=1), y=is_eos)   # EOS count before t
    zeros = layers.fill_constant_batch_size_like(
        ids, shape=[1, max_out_len], dtype='int64', value=0)
    after = layers.cast(layers.less_than(x=zeros, y=before), 'int64')
    keep = layers.elementwise_sub(
        x=layers.fill_constant_batch_size_like(
            ids, shape=[1, max_out_len], dtype='int64', value=1),
        y=after)
    ids = layers.elementwise_add(
        x=layers.elementwise_mul(x=ids, y=keep),
        y=layers.elementwise_mul(x=eos, y=after))
    return ids, ['src_word', 'src_length']


def transformer_beam_infer(src_vocab_size, trg_vocab_size, beam_size=4,
                           max_out_len=16, bos_id=0, eos_id=1,
                           src_seq_len=16, max_length=256, n_layer=6,
                           n_head=8, d_key=64, d_value=64, d_model=512,
                           d_inner=2048, weight_sharing=False,
                           scan_layers=None, incremental=False):
    """Beam-search decode. incremental=False re-runs the decoder over
    the prefixes once a position through the beam_search, beam_gather
    and beam_search_decode ops; incremental=True is the KV-cached
    transformer_beam_decode op (the same sentences). Returns
    ((sentence_ids [B, beam, T - 1], sentence_scores [B, beam]), the feed
    names)."""
    cfg = _infer_cfg(src_vocab_size, trg_vocab_size, max_length, n_layer,
                     n_head, d_key, d_value, d_model, d_inner,
                     weight_sharing, scan_layers)
    src_word = layers.data(name='src_word', shape=[src_seq_len],
                           dtype='int64')
    src_length = layers.data(name='src_length', shape=[], dtype='int64')
    enc_out = _build_encoder(src_word, src_length, src_vocab_size, cfg)
    if incremental:
        out = _incremental_beam(enc_out, src_length, cfg, beam_size,
                                max_out_len, bos_id, eos_id)
        return out, ['src_word', 'src_length']

    # the encoder state tiled over the beam: [B, S, D] -> [B*beam, S, D]
    enc_beam = layers.expand(layers.unsqueeze(enc_out, axes=[1]),
                             expand_times=[1, beam_size, 1, 1])
    enc_beam = layers.reshape(x=enc_beam, shape=[-1] +
                              [enc_out.shape[1], enc_out.shape[2]])
    len_beam = layers.expand(layers.unsqueeze(src_length, axes=[1]),
                             expand_times=[1, beam_size])
    len_beam = layers.reshape(x=len_beam, shape=[-1])

    bos = layers.fill_constant_batch_size_like(
        enc_beam, shape=[1, 1], dtype='int64', value=bos_id)
    prefix = bos                                   # [B*beam, t]
    pre_ids = layers.fill_constant_batch_size_like(
        src_word, shape=[1, beam_size], dtype='int64', value=bos_id)
    # only slot 0 is live at the start: (one_hot(0) - 1) * 1e9
    slot0 = layers.fill_constant(shape=[1, 1], dtype='int64', value=0)
    oh = layers.reshape(x=layers.one_hot(slot0, depth=beam_size),
                        shape=[1, beam_size])
    init_bias = layers.scale(oh, scale=1e9, bias=-1e9)
    ones = layers.fill_constant_batch_size_like(
        src_word, shape=[1, beam_size], dtype='float32', value=1.0)
    pre_scores = layers.elementwise_mul(x=ones, y=init_bias, axis=-1)

    step_ids, step_parents = [], []
    for _t in range(1, max_out_len):
        logits = _decode_prefix(prefix, enc_beam, len_beam, cfg)
        logp = layers.log_softmax(logits)          # [B*beam, V]
        top_scores, top_ids = layers.topk(logp, k=beam_size)
        cand_ids = layers.reshape(x=layers.cast(top_ids, 'int64'),
                                  shape=[-1, beam_size, beam_size])
        cand_scores = layers.reshape(x=top_scores,
                                     shape=[-1, beam_size, beam_size])
        sel_ids, sel_scores, parent = layers.beam_search(
            pre_ids, pre_scores, cand_ids, cand_scores,
            beam_size=beam_size, end_id=eos_id)
        # the prefixes realigned to the selected parents, then the new token
        prefix_b = layers.reshape(x=prefix, shape=[-1, beam_size,
                                                   prefix.shape[1]])
        prefix_b = layers.beam_gather(prefix_b, parent)
        prefix = layers.reshape(x=prefix_b, shape=[-1, prefix.shape[1]])
        nxt = layers.reshape(x=sel_ids, shape=[-1, 1])
        prefix = layers.concat([prefix, nxt], axis=1)
        pre_ids, pre_scores = sel_ids, sel_scores
        step_ids.append(sel_ids)
        step_parents.append(parent)

    stacked_ids = layers.stack(step_ids, axis=0)       # [T-1, B, beam]
    stacked_parents = layers.stack(step_parents, axis=0)
    sent, sent_scores = layers.beam_search_decode(
        stacked_ids, stacked_parents, final_scores=pre_scores,
        end_id=eos_id)
    return (sent, sent_scores), ['src_word', 'src_length']
