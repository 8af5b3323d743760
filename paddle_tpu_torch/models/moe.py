"""Switch-Transformer language model (reference: paddle_tpu models/moe.py):
causal self-attention blocks with mixture-of-experts FFNs
(layers.switch_moe), unrolled or, with ``scan_layers=True``, as one
moe_layer_stack op over [n_layer, ...]-stacked weights (expert weights
[n_layer, E, ...]). ``stack_moe_trained_weights`` turns an unrolled
scope into the stacked layout. Parameter names equal the JAX package's, so
its weights load as they are.
"""

import re

import torch

from .. import layers
from ..initializer import Normal, NumpyArrayInitializer
from ..layers.helper import LayerHelper
from ..ops.transformer_ops import _slot_to_input
from ..param_attr import ParamAttr
from .transformer import (_multi_head_attention, _stack_param,
                          position_encoding_table)

_UNROLLED_MOE_RE = re.compile(
    r'^moe_(\d+)_(slf_(?:q|k|v)|slf_out)\.w$|'
    r'^moe_(\d+)_ln(\d)\.(w|b)$|'
    r'^moe_(\d+)_exp_(gate\.w|1\.w|1\.b|2\.w|2\.b)$')


def _unrolled_to_moe_stacked_name(name):
    """An unrolled MoE block parameter's stacked name and layer index
    ('moe_0_slf_q.w' -> ('moe_stack_slf_q.w', 0), 'moe_1_exp_1.w' ->
    ('moe_stack_1.w', 1)); (None, None) for the others (embedding,
    position table, output projection)."""
    m = _UNROLLED_MOE_RE.match(name)
    if not m:
        return None, None
    if m.group(1):
        slot = m.group(2).replace('slf_out', 'slf_o') + '.w'
        return 'moe_stack_%s' % slot, int(m.group(1))
    if m.group(3):
        return 'moe_stack_ln%s.%s' % (m.group(4), m.group(5)), \
            int(m.group(3))
    return 'moe_stack_%s' % m.group(7), int(m.group(6))


def stack_moe_trained_weights(scope, n_layer):
    """Stack an unrolled-trained switch_transformer_lm scope's block
    parameters onto the 'moe_stack_*' names the scan_layers=True graph
    reads (torch.stack on the scope's device; each name gets a new
    tensor, so a captured graph that read the old one is captured again).
    Returns the stacked names. To go on training under the scan graph,
    run its startup first (its optimizer state restarts cold)."""
    stacks = {}
    for name in scope.keys():
        val = scope.find(name)
        if val is None:
            continue
        sname, i = _unrolled_to_moe_stacked_name(name)
        if sname is not None:
            if i >= n_layer:
                raise ValueError(
                    'stack_moe_trained_weights: %r has layer index %d '
                    'but n_layer=%d' % (name, i, n_layer))
            stacks.setdefault(sname, [None] * n_layer)[i] = val
    for sname, parts in stacks.items():
        missing = [i for i, p in enumerate(parts) if p is None]
        if missing:
            raise ValueError('stack_moe_trained_weights: %r missing '
                             'layers %s' % (sname, missing))
        with torch.no_grad():
            scope.set(sname, torch.stack([torch.as_tensor(p) for p in parts]))
    return sorted(stacks)


def _stacked_moe_params(n_layer, n_head, d_model, d_inner, num_experts):
    """The moe_layer_stack op's weights (ops/transformer_ops.py MOE_SLOTS),
    stacked on a leading [n_layer] axis; the expert weights [n_layer, E,
    ...] are marked expert_shard with expert_shard_axis 1 (the expert
    axis, not the layer axis), as the reference marks them."""
    L, E = n_layer, num_experts
    hd = (d_model // n_head) * n_head
    p = {
        'slf_q': _stack_param('moe_stack_slf_q.w', [L, d_model, hd],
                              d_model, hd),
        'slf_k': _stack_param('moe_stack_slf_k.w', [L, d_model, hd],
                              d_model, hd),
        'slf_v': _stack_param('moe_stack_slf_v.w', [L, d_model, hd],
                              d_model, hd),
        'slf_o': _stack_param('moe_stack_slf_o.w', [L, hd, d_model],
                              hd, d_model),
        'ln1_w': _stack_param('moe_stack_ln1.w', [L, d_model], 0, 0,
                              constant=1.0),
        'ln1_b': _stack_param('moe_stack_ln1.b', [L, d_model], 0, 0,
                              constant=0.0),
        'gate_w': _stack_param('moe_stack_gate.w', [L, d_model, E],
                               d_model, E),
        'moe_w1': _stack_param('moe_stack_1.w', [L, E, d_model, d_inner],
                               d_model, d_inner),
        'moe_b1': _stack_param('moe_stack_1.b', [L, E, d_inner], 0, 0,
                               constant=0.0),
        'moe_w2': _stack_param('moe_stack_2.w', [L, E, d_inner, d_model],
                               d_inner, d_model),
        'moe_b2': _stack_param('moe_stack_2.b', [L, E, d_model], 0, 0,
                               constant=0.0),
        'ln2_w': _stack_param('moe_stack_ln2.w', [L, d_model], 0, 0,
                              constant=1.0),
        'ln2_b': _stack_param('moe_stack_ln2.b', [L, d_model], 0, 0,
                              constant=0.0),
    }
    for slot in ('moe_w1', 'moe_b1', 'moe_w2', 'moe_b2'):
        p[slot].expert_shard = True
        p[slot].expert_shard_axis = 1
    return p


def _moe_stack(x, params, n_head, dropout_rate, capacity_factor, top_k):
    """One moe_layer_stack op over the stacked ``params``: (out, summed
    aux loss)."""
    helper = LayerHelper('moe_layer_stack', name='moe_stack')
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    aux = helper.create_variable_for_type_inference('float32')
    aux.shape = ()
    inputs = {'X': [x]}
    for slot, param in params.items():
        inputs[_slot_to_input(slot)] = [param]
    helper.append_op(type='moe_layer_stack', inputs=inputs,
                     outputs={'Out': [out], 'AuxLoss': [aux]},
                     attrs={'n_head': n_head,
                            'dropout_rate': dropout_rate,
                            'capacity_factor': capacity_factor,
                            'top_k': top_k})
    return out, aux


def switch_transformer_lm(vocab_size, seq_len, n_layer=2, n_head=4,
                          d_model=64, d_inner=128, num_experts=4,
                          capacity_factor=1.25, top_k=1, aux_weight=1e-2,
                          dropout_rate=0.0, max_length=512,
                          scan_layers=False):
    """Causal LM: feeds word [B, T] int64 and label [B, T] int64; returns
    (avg_cost, logits). Every block: causal fused attention -> residual +
    layer norm -> Switch-MoE FFN -> residual + layer norm; the MoE aux
    losses are added to the cross entropy at ``aux_weight``.
    ``scan_layers=True`` runs the n_layer blocks as one moe_layer_stack op
    over stacked weights."""
    if not 1 <= top_k <= num_experts:
        raise ValueError('switch_transformer_lm: top_k=%d must be in '
                         '[1, num_experts=%d]' % (top_k, num_experts))
    word = layers.data(name='word', shape=[seq_len], dtype='int64')
    label = layers.data(name='label', shape=[seq_len], dtype='int64')

    emb = layers.embedding(
        input=word, size=[vocab_size, d_model], dtype='float32',
        param_attr=ParamAttr(name='moe_emb',
                             initializer=Normal(0., d_model ** -0.5)))
    pos = layers.create_parameter(
        shape=[max_length, d_model], dtype='float32', name='moe_pos_enc',
        attr=ParamAttr(name='moe_pos_enc',
                       initializer=NumpyArrayInitializer(
                           position_encoding_table(max_length, d_model)),
                       trainable=False))
    pos_slice = layers.reshape(
        x=layers.slice(pos, axes=[0], starts=[0], ends=[seq_len]),
        shape=[1, seq_len, d_model])
    x = layers.elementwise_add(x=emb, y=pos_slice)

    aux_losses = []
    if scan_layers:
        params = _stacked_moe_params(n_layer, n_head, d_model, d_inner,
                                     num_experts)
        x, aux = _moe_stack(x, params, n_head, dropout_rate,
                            capacity_factor, top_k)
        aux_losses.append(aux)
    for i in range(0 if scan_layers else n_layer):
        d_head = d_model // n_head
        proj = _multi_head_attention(
            x, x, x, d_head, d_head, d_model, n_head, dropout_rate,
            causal=True, name='moe_%d_slf' % i)
        x = layers.layer_norm(
            layers.elementwise_add(x=x, y=proj),
            begin_norm_axis=2,
            param_attr=ParamAttr(name='moe_%d_ln1.w' % i),
            bias_attr=ParamAttr(name='moe_%d_ln1.b' % i))
        ffn, aux = layers.switch_moe(
            x, num_experts=num_experts, d_inner=d_inner,
            capacity_factor=capacity_factor, top_k=top_k,
            param_attr=ParamAttr(name='moe_%d_exp' % i))
        aux_losses.append(aux)
        x = layers.layer_norm(
            layers.elementwise_add(x=x, y=ffn),
            begin_norm_axis=2,
            param_attr=ParamAttr(name='moe_%d_ln2.w' % i),
            bias_attr=ParamAttr(name='moe_%d_ln2.b' % i))

    logits = layers.fc(input=x, size=vocab_size, num_flatten_dims=2,
                       bias_attr=False,
                       param_attr=ParamAttr(name='moe_out.w'))
    lbl3 = layers.unsqueeze(label, axes=[2])
    ce = layers.softmax_with_cross_entropy(logits=logits, label=lbl3)
    avg_cost = layers.mean(ce)
    for aux in aux_losses:
        avg_cost = layers.elementwise_add(
            x=avg_cost, y=layers.scale(aux, scale=aux_weight))
    return avg_cost, logits

