"""The stacked transformer layers and the KV-cached NMT decode (reference:
paddle_tpu ops/transformer_ops.py).

``transformer_layer_stack`` runs n_layer identical encoder or decoder
layers over weights stacked on a leading [n_layer, ...] axis: a Python
loop over the layers, each the math of models/transformer.py's
encoder_layer / decoder_layer (fused attention, residual + layer norm, FFN,
residual + layer norm, dropout at the same places). Attention is the flash
attention Function (K2 forward, K3 backward on the card) and every layer
norm is K1 and its backward. Each layer has 4 dropout sites in the encoder
and 6 in the decoder; site s of layer l keeps where the counter-based bits
of key ``mix32(op_key(seed, op) ^ (l * n_sites + s))`` at the executor's
step say so (kernels/random_bits.py), drawn on the device inside one fused
dropout pass forward and again in the backward, so a captured step, an
eager one and run_steps draw the same bits and no mask is made.

``transformer_greedy_decode`` and ``transformer_beam_decode`` decode with
per-layer key/value caches: a Python loop over output positions, each
running the decoder layers for one new token. The caches are preallocated
and written in place at position t, the cross-attention keys and values
are computed once, and the beam's caches are reordered by parent after
each step. The one-query attention over a cache (``_mha_one_step``) is
plain torch, as it is an einsum outside any Pallas kernel in the JAX
package; the layer norms are K1.

``moe_layer_stack`` runs n_layer Switch-MoE blocks over weights stacked
the same way (expert weights [n_layer, E, ...]): a Python loop over the
layers, each the math of models/moe.py's unrolled block: causal fused
attention (K2 / K3), residual + layer norm (K1), the slot-form MoE FFN
(moe_ops.switch_moe_slots), residual + layer norm. Its one dropout site a
layer is the attention output's, as the reference's; the layers' aux
losses are summed in fp32.

Under a remat policy (memory_optimize) both stacks run each layer as its
own checkpoint (``ctx.checkpointed``), so the backward recomputes one
layer at a time and holds one layer's activations.

Not ported: the pipelined stack (the JAX package's GPipe schedule over a
'pp' mesh axis) and ring attention inside the stack (ROADMAP Queue 1
item 9).
"""

import torch

from ..core.registry import check_no_mesh, mix32, op_key, register
from .attention_ops import fused_attention
from .decode_ops import beam_backtrack, beam_search_step
from .kernels import random_bits
from .kernels.layer_norm import fused_layer_norm
from .moe_ops import moe_capacity, switch_moe_slots
from .pointwise import relu
from .tensor_ops import top_k

ENC_SLOTS = ('slf_q', 'slf_k', 'slf_v', 'slf_o', 'ln1_w', 'ln1_b',
             'ffn_w1', 'ffn_b1', 'ffn_w2', 'ffn_b2', 'ln2_w', 'ln2_b')
DEC_SLOTS = ('slf_q', 'slf_k', 'slf_v', 'slf_o', 'ln1_w', 'ln1_b',
             'cross_q', 'cross_k', 'cross_v', 'cross_o', 'ln2_w', 'ln2_b',
             'ffn_w1', 'ffn_b1', 'ffn_w2', 'ffn_b2', 'ln3_w', 'ln3_b')


def _slot_to_input(slot):
    """'slf_q' -> the op input slot name 'SlfQ'."""
    return ''.join(part.capitalize() for part in slot.split('_'))


def _per_layer(params):
    """[{slot: layer i's weight}] by one unbind a slot, whose backward is
    one stack (indexing layer by layer would add a full-size zero
    gradient a layer)."""
    slots = list(params)
    return [dict(zip(slots, ws))
            for ws in zip(*(params[s].unbind(0) for s in slots))]


def _amp_params(params, amp):
    """Under bf16 AMP the matmul weights go to bf16; the layer norms'
    stay fp32 (their statistics are fp32 in K1)."""
    if amp != 'bf16':
        return params
    return {s: v if s.startswith('ln') else v.to(torch.bfloat16)
            for s, v in params.items()}


class _Sites(object):
    """The dropout draws of one stack op: site s of layer l keeps with
    probability 1 - rate by the bits of its own key at the step."""

    def __init__(self, ctx, rate, n_sites):
        self.rate = rate
        self.n_sites = n_sites
        self.key = op_key(ctx.seed, ctx.op_index)
        self.step = ctx.step_tensor()

    def drop(self, x, layer, site, mode):
        """Site s of layer l's dropout of x in ``mode`` (kernels/
        random_bits.py DropoutApply): one fused pass, no mask made."""
        key = mix32(self.key ^ (layer * self.n_sites + site))
        return random_bits.DropoutApply.apply(x, mode, 1.0 - self.rate, key,
                                              self.step)


def _dropout(x, sites, layer, site, is_test):
    """layers.dropout's default (downgrade_in_infer): x * mask in
    training, x * (1 - rate) in test."""
    if sites is None:
        return x
    if is_test:
        return x * (1.0 - sites.rate)
    return sites.drop(x, layer, site, 'mul')


def _post_process(prev, out, p, sites, layer, site, is_test, ln_slot):
    out = _dropout(out, sites, layer, site, is_test)
    return fused_layer_norm(prev + out, p[ln_slot + '_w'], p[ln_slot + '_b'],
                            eps=1e-5, begin_norm_axis=-1)


def _attn(x, mem, p, pre, n_head, causal, key_length, sites, layer, site,
          is_test):
    out = fused_attention(x @ p[pre + '_q'], mem @ p[pre + '_k'],
                          mem @ p[pre + '_v'], n_head, causal=causal,
                          key_length=key_length)
    if sites is not None and not is_test:
        # the attention output's dropout scales by 1 / keep, as the
        # fused_attention op's does
        out = sites.drop(out, layer, site, 'where_div')
    return out @ p[pre + '_o']


def _ffn(x, p, sites, layer, site, is_test):
    h = relu(x @ p['ffn_w1'] + p['ffn_b1'])
    h = _dropout(h, sites, layer, site, is_test)
    return h @ p['ffn_w2'] + p['ffn_b2']


@register('transformer_layer_stack')
def _transformer_layer_stack(ctx):
    check_no_mesh(ctx)
    x = ctx.input('X')
    is_decoder = ctx.has_input('EncOut')
    enc_out = ctx.input('EncOut') if is_decoder else None
    key_length = ctx.input('SrcLength') if ctx.has_input('SrcLength') \
        else None
    n_head = ctx.attr('n_head', 1)
    rate = ctx.attr('dropout_rate', 0.0)
    is_test = ctx.attr('is_test', False) or ctx.is_test
    slots = DEC_SLOTS if is_decoder else ENC_SLOTS
    params = _amp_params({s: ctx.env[ctx.op.input(_slot_to_input(s))]
                          for s in slots}, ctx.amp)
    if ctx.amp == 'bf16':
        x = x.to(torch.bfloat16)
        if enc_out is not None:
            enc_out = enc_out.to(torch.bfloat16)
    sites = _Sites(ctx, rate, 6 if is_decoder else 4) if rate else None

    def layer(h, i, p):
        slf = _attn(h, h, p, 'slf', n_head, is_decoder,
                    None if is_decoder else key_length, sites, i, 0,
                    is_test)
        h = _post_process(h, slf, p, sites, i, 1, is_test, 'ln1')
        if is_decoder:
            cross = _attn(h, enc_out, p, 'cross', n_head, False, key_length,
                          sites, i, 4, is_test)
            h = _post_process(h, cross, p, sites, i, 5, is_test, 'ln2')
        ffn = _ffn(h, p, sites, i, 2, is_test)
        return _post_process(h, ffn, p, sites, i, 3, is_test,
                             'ln3' if is_decoder else 'ln2')

    h = x
    for i, p in enumerate(_per_layer(params)):
        h = ctx.checkpointed(layer, h, i, p)
    ctx.set_output('Out', h)


MOE_SLOTS = ('slf_q', 'slf_k', 'slf_v', 'slf_o', 'ln1_w', 'ln1_b',
             'gate_w', 'moe_w1', 'moe_b1', 'moe_w2', 'moe_b2',
             'ln2_w', 'ln2_b')


@register('moe_layer_stack')
def _moe_layer_stack(ctx):
    """n_layer MoE blocks over [n_layer, ...] stacked weights; Out and the
    layers' summed AuxLoss. Under bf16 AMP the router weight and the layer
    norms' parameters stay fp32. Capacity is that of b * t tokens."""
    check_no_mesh(ctx)
    n_head = ctx.attr('n_head', 1)
    rate = ctx.attr('dropout_rate', 0.0)
    k = ctx.attr('top_k', 1)
    is_test = ctx.attr('is_test', False) or ctx.is_test
    params = {s: ctx.env[ctx.op.input(_slot_to_input(s))]
              for s in MOE_SLOTS}
    x = ctx.input('X')
    if ctx.amp == 'bf16':
        x = x.to(torch.bfloat16)
        params = {s: v if s.startswith('ln') or s == 'gate_w'
                  else v.to(torch.bfloat16) for s, v in params.items()}
    b, t, d = x.shape
    capacity = moe_capacity(ctx.attr('capacity_factor', 1.25), k, b * t,
                            params['gate_w'].shape[-1])
    sites = _Sites(ctx, rate, 1) if rate else None
    def layer(h, i, p):
        slf = _attn(h, h, p, 'slf', n_head, True, None, sites, i, 0,
                    is_test)
        h = _post_process(h, slf, p, None, i, 0, is_test, 'ln1')
        out, aux, _, _ = switch_moe_slots(
            h.reshape(b * t, d), p['gate_w'], p['moe_w1'], p['moe_b1'],
            p['moe_w2'], p['moe_b2'], capacity, k)
        return _post_process(h, out.reshape(b, t, d), p, None, i, 0,
                             is_test, 'ln2'), aux

    h = x
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(_per_layer(params)):
        h, aux = ctx.checkpointed(layer, h, i, p)
        aux_sum = aux_sum + aux
    ctx.set_output('Out', h)
    ctx.set_output('AuxLoss', aux_sum)


# --------------------------------------------------------- incremental decode
def _heads(x, n_head):
    """[B, T, H*D] -> [B, H, T, D], contiguous: the layout the one-query
    attention reads without a copy."""
    b, t, hd = x.shape
    return x.view(b, t, n_head, hd // n_head).transpose(1, 2).contiguous()


def _mha_one_step(q1, k, v, live=None):
    """One-query attention. q1: [B, H*D]; k, v: [B, H, Tk, D] head-major
    (views whose batch and head dims merge into one stride, so neither
    product copies them); live: None (every key attends) or [B] live key
    counts, the rest masked at -1e9. fp32 softmax. Returns [B, H*Dv]."""
    with torch.profiler.record_function('one_query_attention'):
        b, h, tk, d = k.shape
        q = q1.view(b, h, 1, d)
        logits = torch.matmul(q * d ** -0.5, k.transpose(-1, -2))
        if live is not None:
            mask = torch.arange(tk, device=k.device)[None, :] < \
                live.reshape(-1, 1)
            logits = logits.masked_fill(~mask[:, None, None, :], -1e9)
        w = torch.softmax(logits.float(), dim=-1)
        return torch.matmul(w.to(v.dtype), v).reshape(b, -1)


def _incremental_layers(params, n_head, cross_live, x, kcs, vcs, ck, cv, t):
    """Position t through every decoder layer: this position's keys and
    values go into the caches at t, self-attention over positions 0..t,
    cross-attention over the encoder's keys and values, the FFN, and
    residual + layer norm (K1) as in decoder_layer. Returns h [B, d]."""
    def ln(h, p, slot):
        return fused_layer_norm(h, p[slot + '_w'], p[slot + '_b'], eps=1e-5,
                                begin_norm_axis=-1)

    h = x
    rows = h.shape[0]
    for i, p in enumerate(params):
        kcs[i, :, :, t] = (h @ p['slf_k']).view(rows, n_head, -1)
        vcs[i, :, :, t] = (h @ p['slf_v']).view(rows, n_head, -1)
        slf = _mha_one_step(h @ p['slf_q'], kcs[i, :, :, :t + 1],
                            vcs[i, :, :, :t + 1])
        h = ln(h + slf @ p['slf_o'], p, 'ln1')
        cross = _mha_one_step(h @ p['cross_q'], ck[i], cv[i], cross_live)
        h = ln(h + cross @ p['cross_o'], p, 'ln2')
        ffn = torch.relu(h @ p['ffn_w1'] + p['ffn_b1']) @ p['ffn_w2'] + \
            p['ffn_b2']
        h = ln(h + ffn, p, 'ln3')
    return h


def _decode_op_inputs(ctx):
    """The decode ops' inputs (the decoder's weights a dict a layer), the
    matmul weights and tables in bf16 under bf16 AMP."""
    enc_out = ctx.input('EncOut')
    src_len = ctx.input('SrcLength') if ctx.has_input('SrcLength') else None
    emb, pos, wout = ctx.input('Emb'), ctx.input('PosEnc'), \
        ctx.input('OutProj')
    params = _amp_params({s: ctx.env[ctx.op.input(_slot_to_input(s))]
                          for s in DEC_SLOTS}, ctx.amp)
    if ctx.amp == 'bf16':
        enc_out, emb, pos, wout = (t.to(torch.bfloat16)
                                   for t in (enc_out, emb, pos, wout))
    return enc_out, src_len, emb, pos, wout, _per_layer(params)


def _cross_kv(enc, params, n_head):
    """Per layer, the cross-attention keys and values of the encoder
    output, head-major: computed once for every position."""
    return ([_heads(enc @ p['cross_k'], n_head) for p in params],
            [_heads(enc @ p['cross_v'], n_head) for p in params])


def _caches(params, rows, t_max, n_head, dtype, device):
    """Zeroed key and value caches [n_layer, rows, H, t_max, D]."""
    return tuple(torch.zeros(len(params), rows, n_head, t_max,
                             params[0][s].shape[-1] // n_head, dtype=dtype,
                             device=device) for s in ('slf_k', 'slf_v'))


def _embed(emb, pos, ids, t):
    return emb[ids] * (emb.shape[-1] ** 0.5) + pos[t]


@register('transformer_greedy_decode')
def _transformer_greedy_decode(ctx):
    """KV-cached greedy decode over max_out_len - 1 positions after BOS;
    every id after a sentence's first EOS becomes EOS. Out: [B, T]
    int64."""
    enc_out, src_len, emb, pos, wout, params = _decode_op_inputs(ctx)
    n_head = ctx.attr('n_head', 1)
    t_max = ctx.attr('max_out_len')
    bos_id = ctx.attr('bos_id', 0)
    eos_id = ctx.attr('eos_id', 1)
    b, dev = enc_out.shape[0], enc_out.device
    ck, cv = _cross_kv(enc_out, params, n_head)
    kcs, vcs = _caches(params, b, t_max, n_head, enc_out.dtype, dev)
    ids = torch.full((b, t_max), bos_id, dtype=torch.int64, device=dev)
    for t in range(t_max - 1):
        h = _incremental_layers(params, n_head, src_len,
                                _embed(emb, pos, ids[:, t], t), kcs, vcs, ck,
                                cv, t)
        ids[:, t + 1] = torch.argmax((h @ wout).float(), dim=-1)
    # everything after the first EOS becomes EOS
    is_eos = (ids == eos_id).to(torch.int32)
    before = torch.cumsum(is_eos, dim=1) - is_eos
    ids = torch.where(before > 0, torch.full((), eos_id, dtype=torch.int64,
                                             device=dev), ids)
    ctx.set_output('Out', ids)


@register('transformer_beam_decode')
def _transformer_beam_decode(ctx):
    """KV-cached beam search: each step is the beam_search op's math
    (decode_ops.beam_search_step over fp32 log-probabilities and their
    top beam_size), the caches' rows reordered by parent, and the final
    backtrack is beam_search_decode's. SentenceIds [B, beam, T - 1] int64,
    SentenceScores [B, beam] fp32; StepIds and StepParents [T - 1, B, beam]
    int64, each step's selection (beam_search_decode's inputs)."""
    enc_out, src_len, emb, pos, wout, params = _decode_op_inputs(ctx)
    n_head = ctx.attr('n_head', 1)
    t_max = ctx.attr('max_out_len')
    beam = ctx.attr('beam_size', 4)
    bos_id = ctx.attr('bos_id', 0)
    eos_id = ctx.attr('eos_id', 1)
    b, dev = enc_out.shape[0], enc_out.device
    enc_beam = enc_out.repeat_interleave(beam, dim=0)
    cross_live = None if src_len is None else \
        src_len.reshape(-1).repeat_interleave(beam)
    ck, cv = _cross_kv(enc_beam, params, n_head)
    kcs, vcs = _caches(params, b * beam, t_max, n_head, enc_out.dtype, dev)
    last = torch.full((b * beam,), bos_id, dtype=torch.int64, device=dev)
    pre_ids = torch.full((b, beam), bos_id, dtype=torch.int64, device=dev)
    # only beam slot 0 is live at the start (all beams are the same)
    pre_scores = torch.where(torch.arange(beam, device=dev) == 0, 0.0,
                             -1e9).float().expand(b, beam)
    base = (torch.arange(b, device=dev) * beam)[:, None]
    step_ids, step_parents = [], []
    for t in range(t_max - 1):
        h = _incremental_layers(params, n_head, cross_live,
                                _embed(emb, pos, last, t), kcs, vcs, ck, cv,
                                t)
        logp = torch.log_softmax((h @ wout).float(), dim=-1)
        top_scores, top_ids = top_k(logp, beam)
        sel_ids, pre_scores, parent = beam_search_step(
            pre_ids, pre_scores, top_ids.reshape(b, beam, beam),
            top_scores.reshape(b, beam, beam), beam, eos_id)
        rows = (base + parent).reshape(-1)
        kcs[:, :, :, :t + 1] = kcs[:, rows, :, :t + 1]
        vcs[:, :, :, :t + 1] = vcs[:, rows, :, :t + 1]
        last = sel_ids.reshape(-1)
        pre_ids = sel_ids
        step_ids.append(sel_ids)
        step_parents.append(parent)
    step_ids, step_parents = torch.stack(step_ids), torch.stack(step_parents)
    ctx.set_output('SentenceIds', beam_backtrack(step_ids, step_parents,
                                                 eos_id))
    ctx.set_output('SentenceScores', pre_scores)
    ctx.set_output('StepIds', step_ids)
    ctx.set_output('StepParents', step_parents)
