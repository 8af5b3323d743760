"""RNN encoder-decoder with attention: the machine_translation book
chapter's model (reference: paddle_tpu models/rnn_search.py; the v1
seqToseq demo, networks.py simple_attention + gru_group decoder).

The bidirectional GRU encoder is two layers.dynamic_gru recurrences (the
gru op: csrc/gru_seq.cu where rnn_cell.gru_seq_plan has a launch, else the
cells of csrc/rnn_cell.cu a position). The attention decoder is a
DynamicRNN whose step block (additive attention over the whole encoder
output, a gru_unit state update, the vocab projection) runs once a target
position (ops/control_ops.py); the encoder states are read from the
surrounding block. Greedy and beam generation are one op each
(rnn_search_greedy_decode, rnn_search_beam_decode) sharing the training
parameters by name.
"""

import numpy as np

from .. import layers
from ..param_attr import ParamAttr


def _p(name):
    return ParamAttr(name=name)


def encoder(src_word, src_len, src_vocab, emb_dim=64, hidden_dim=64):
    """Bi-GRU over the padded source: returns [B, Ts, 2H] states plus
    the backward direction's summary (decoder boot, per the chapter).
    All parameters are named so the infer graph shares them."""
    emb = layers.embedding(input=src_word, size=[src_vocab, emb_dim],
                           param_attr=_p('rnnsearch_src_emb'))
    fwd = layers.dynamic_gru(
        input=layers.fc(input=emb, size=hidden_dim * 3, bias_attr=False,
                        num_flatten_dims=2,
                        param_attr=_p('rnnsearch_enc_fwd.w')),
        size=hidden_dim, length=src_len,
        param_attr=_p('rnnsearch_enc_fwd_gru.w'),
        bias_attr=_p('rnnsearch_enc_fwd_gru.b'))
    bwd = layers.dynamic_gru(
        input=layers.fc(input=emb, size=hidden_dim * 3, bias_attr=False,
                        num_flatten_dims=2,
                        param_attr=_p('rnnsearch_enc_bwd.w')),
        size=hidden_dim, is_reverse=True, length=src_len,
        param_attr=_p('rnnsearch_enc_bwd_gru.w'),
        bias_attr=_p('rnnsearch_enc_bwd_gru.b'))
    encoded = layers.concat([fwd, bwd], axis=-1)          # [B, Ts, 2H]
    boot = layers.fc(input=layers.sequence_first_step(bwd, length=src_len),
                     size=hidden_dim, act='tanh',
                     param_attr=_p('rnnsearch_boot.w'),
                     bias_attr=_p('rnnsearch_boot.b'))     # [B, H]
    return encoded, boot


def additive_attention(encoded, encoded_proj, state, hidden_dim,
                       length=None, transform_param_attr=None,
                       score_param_attr=None):
    """Bahdanau additive attention over a padded sequence, built from
    fluid layers — safe inside a DynamicRNN step block. This is the ONE
    home of the attention math; the v1 shim's simple_attention
    (trainer_config_helpers/networks.py) delegates here. The param
    attrs carry ParamAttr names for weight sharing across graphs."""
    dec = layers.fc(input=state, size=hidden_dim, bias_attr=False,
                    param_attr=transform_param_attr)
    combined = layers.tanh(layers.elementwise_add(
        encoded_proj, layers.unsqueeze(dec, axes=[1])))
    scores = layers.fc(input=combined, size=1, num_flatten_dims=2,
                       bias_attr=False,
                       param_attr=score_param_attr)        # [B, Ts, 1]
    weights = layers.sequence_softmax(
        layers.squeeze(scores, axes=[2]), length=length)   # [B, Ts]
    ctx = layers.matmul(layers.unsqueeze(weights, axes=[1]), encoded)
    return layers.squeeze(ctx, axes=[1])                   # [B, ...]


def _build_inputs():
    src_word = layers.data(name='src_word', shape=[-1], dtype='int64',
                           lod_level=1)
    src_len = layers.data(name='src_len', shape=[], dtype='int32')
    return src_word, src_len


def rnn_search(src_vocab=1000, trg_vocab=1000, emb_dim=64, hidden_dim=64):
    """Training graph: teacher-forced attention decoder. Returns
    (avg_cost, feed names). Feeds: src_word [B,Ts] int64, src_len [B]
    int32, trg_word [B,Tt] int64 (decoder input, <s>-shifted), lbl_word
    [B,Tt] int64, lbl_mask [B,Tt] float32 (1 on real target steps)."""
    src_word, src_len = _build_inputs()
    trg_word = layers.data(name='trg_word', shape=[-1], dtype='int64',
                           lod_level=1)
    lbl_word = layers.data(name='lbl_word', shape=[-1], dtype='int64',
                           lod_level=1)
    lbl_mask = layers.data(name='lbl_mask', shape=[-1], dtype='float32',
                           lod_level=1)

    encoded, boot = encoder(src_word, src_len, src_vocab, emb_dim,
                            hidden_dim)
    # shared attention key projection, computed once outside the loop
    encoded_proj = layers.fc(input=encoded, size=hidden_dim,
                             bias_attr=False, num_flatten_dims=2,
                             param_attr=_p('rnnsearch_encproj.w'))
    trg_emb = layers.embedding(input=trg_word,
                               size=[trg_vocab, emb_dim],
                               param_attr=_p('rnnsearch_trg_emb'))

    drnn = layers.DynamicRNN()
    with drnn.block():
        emb_t = drnn.step_input(trg_emb)                   # [B, E]
        state = drnn.memory(init=boot)                     # [B, H]
        context = additive_attention(
            encoded, encoded_proj, state, hidden_dim, length=src_len,
            transform_param_attr=_p('rnnsearch_att_trans.w'),
            score_param_attr=_p('rnnsearch_att_score.w'))
        step_in = layers.fc(
            input=layers.concat([emb_t, context], axis=-1),
            size=hidden_dim * 3, bias_attr=False,
            param_attr=_p('rnnsearch_step.w'))
        new_state, _, _ = layers.gru_unit(
            step_in, state, size=hidden_dim * 3,
            param_attr=_p('rnnsearch_gru.w'),
            bias_attr=_p('rnnsearch_gru.b'))
        drnn.update_memory(state, new_state)
        logits = layers.fc(input=new_state, size=trg_vocab,
                           param_attr=_p('rnnsearch_out.w'),
                           bias_attr=_p('rnnsearch_out.b'))
        drnn.output(logits)
    logits = drnn()                                        # [B, Tt, V]

    cost = layers.softmax_with_cross_entropy(
        logits=logits, label=layers.unsqueeze(lbl_word, axes=[2]))
    cost = layers.squeeze(cost, axes=[2])                  # [B, Tt]
    weighted = layers.elementwise_mul(cost, lbl_mask)
    avg_cost = layers.elementwise_div(
        layers.reduce_sum(weighted),
        layers.reduce_sum(lbl_mask))
    return avg_cost, ['src_word', 'src_len', 'trg_word', 'lbl_word',
                      'lbl_mask']


def _decoder_param_inputs(encoded, encoded_proj, boot, src_len,
                          src_vocab, trg_vocab, emb_dim, hidden_dim):
    """Decode-op input dict: the training decoder's parameters,
    re-declared by NAME (first-init-wins keeps one init either build
    order; is_bias=True makes the bias init Constant(0) when the infer
    graph is built first)."""
    def param(name, shape, is_bias=False):
        return layers.create_parameter(shape=shape, dtype='float32',
                                       attr=_p(name), is_bias=is_bias)

    return {
        'EncOut': [encoded], 'EncProj': [encoded_proj], 'Boot': [boot],
        'SrcLen': [src_len],
        'TrgEmb': [param('rnnsearch_trg_emb', [trg_vocab, emb_dim])],
        'AttW': [param('rnnsearch_att_trans.w', [hidden_dim, hidden_dim])],
        'ScoreW': [param('rnnsearch_att_score.w', [hidden_dim, 1])],
        'StepW': [param('rnnsearch_step.w',
                        [emb_dim + 2 * hidden_dim, 3 * hidden_dim])],
        'GruW': [param('rnnsearch_gru.w', [hidden_dim, 3 * hidden_dim])],
        'GruB': [param('rnnsearch_gru.b', [1, 3 * hidden_dim],
                       is_bias=True)],
        'OutW': [param('rnnsearch_out.w', [hidden_dim, trg_vocab])],
        'OutB': [param('rnnsearch_out.b', [trg_vocab], is_bias=True)],
    }


def rnn_search_greedy_infer(src_vocab=1000, trg_vocab=1000, emb_dim=64,
                            hidden_dim=64, max_out_len=16, bos_id=1,
                            eos_id=0):
    """Inference graph: encoder (training parameters, shared by name) +
    ONE rnn_search_greedy_decode op, a loop with argmax feedback.
    Build under a program_guard on a fresh program; run with feeds
    src_word/src_len, fetch the returned [B, max_out_len] ids."""
    from ..layers.helper import LayerHelper
    src_word, src_len = _build_inputs()
    encoded, boot = encoder(src_word, src_len, src_vocab, emb_dim,
                            hidden_dim)
    encoded_proj = layers.fc(input=encoded, size=hidden_dim,
                             bias_attr=False, num_flatten_dims=2,
                             param_attr=_p('rnnsearch_encproj.w'))
    helper = LayerHelper('rnn_search_greedy_decode')
    inputs = _decoder_param_inputs(encoded, encoded_proj, boot, src_len,
                                   src_vocab, trg_vocab, emb_dim,
                                   hidden_dim)
    out = helper.create_variable_for_type_inference('int64')
    if encoded.shape is not None:
        out.shape = (encoded.shape[0], max_out_len)
    helper.append_op(type='rnn_search_greedy_decode', inputs=inputs,
                     outputs={'Out': [out]},
                     attrs={'max_out_len': max_out_len, 'bos_id': bos_id,
                            'eos_id': eos_id})
    return out, ['src_word', 'src_len']


def rnn_search_beam_infer(src_vocab=1000, trg_vocab=1000, emb_dim=64,
                          hidden_dim=64, max_out_len=16, beam_size=4,
                          bos_id=1, eos_id=0):
    """Beam-search generation (the seqToseq demo's mode): encoder +
    ONE rnn_search_beam_decode op. Returns (ids [B, beam, T] sorted
    best-first, scores [B, beam], feed names)."""
    from ..layers.helper import LayerHelper
    src_word, src_len = _build_inputs()
    encoded, boot = encoder(src_word, src_len, src_vocab, emb_dim,
                            hidden_dim)
    encoded_proj = layers.fc(input=encoded, size=hidden_dim,
                             bias_attr=False, num_flatten_dims=2,
                             param_attr=_p('rnnsearch_encproj.w'))
    helper = LayerHelper('rnn_search_beam_decode')
    inputs = _decoder_param_inputs(encoded, encoded_proj, boot, src_len,
                                   src_vocab, trg_vocab, emb_dim,
                                   hidden_dim)
    ids = helper.create_variable_for_type_inference('int64')
    scores = helper.create_variable_for_type_inference('float32')
    if encoded.shape is not None:
        ids.shape = (encoded.shape[0], beam_size, max_out_len)
        scores.shape = (encoded.shape[0], beam_size)
    helper.append_op(type='rnn_search_beam_decode', inputs=inputs,
                     outputs={'SentenceIds': [ids],
                              'SentenceScores': [scores]},
                     attrs={'max_out_len': max_out_len,
                            'beam_size': beam_size, 'bos_id': bos_id,
                            'eos_id': eos_id})
    return ids, scores, ['src_word', 'src_len']


def make_fake_batch(batch, src_seq, trg_seq, src_vocab, trg_vocab,
                    seed=0):
    """Synthetic copy-ish task feed (zero-egress environment)."""
    rng = np.random.RandomState(seed)
    src = rng.randint(2, src_vocab, (batch, src_seq)).astype('int64')
    lbl = (src[:, :trg_seq] % (trg_vocab - 2) + 2).astype('int64')
    trg = np.concatenate([np.ones((batch, 1), 'int64'),  # <s> = 1
                          lbl[:, :-1]], axis=1)
    return {'src_word': src,
            'src_len': np.full((batch,), src_seq, 'int32'),
            'trg_word': trg, 'lbl_word': lbl,
            'lbl_mask': np.ones((batch, trg_seq), 'float32')}
