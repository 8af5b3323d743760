"""Paged incremental-decode ops for the decode-serving engine (reference:
paddle_tpu ops/paged_decode_ops.py).

Two IR ops over a decoder-only (GPT-block) transformer whose KV cache
lives in a paged pool ([L, NB, H, bs, d] arenas):

- ``paged_prefill`` — extend a sequence whose first ``Cached`` tokens
  already have KV by a padded suffix [1, S]: write each suffix
  position's K/V into the sequence's pages through its block table,
  attend each suffix query at its own absolute length (one ragged
  paged-attention pass over S rows), and emit the next token.
- ``paged_decode_step`` — one token for every slot of the fixed-size
  decode batch [B]: append each row's K/V at its own position, ragged
  paged attention at per-row lengths, then greedy or temperature
  sampling per row. Empty slots feed all-NB tables, so their writes
  are dropped.

Both go through ``_extend_rows``, which per layer runs the paged
attention kernel once and the layer-norm kernel twice. Every per-row
computation is independent of the other rows, so a sequence's stream
does not depend on what else is in the batch.

Sampling: the token at position i is greedy at temp == 0, else the
Gumbel-max draw argmax(logits / temp - log(E)) with E ~ Exp(1) from a
torch.Generator seeded by (seed, i). A stream thus depends only on
(seed, positions), as in the reference, but the bits differ from
jax.random's: the two packages agree at temperature 0 only.
"""

import numpy as np
import torch

from ..core.registry import register
from .kernels.layer_norm import fused_layer_norm
from .kernels.paged_attention import paged_attention
from .transformer_ops import ENC_SLOTS, _slot_to_input

LM_SLOTS = ENC_SLOTS   # decoder-only block reuses the encoder slot layout


def _split_heads(x, n_head):
    """[..., H*D] -> [..., H, D]."""
    return x.reshape(x.shape[:-1] + (n_head, x.shape[-1] // n_head))


def _ln(h, p, slot):
    return fused_layer_norm(h, p[slot + '_w'], p[slot + '_b'], eps=1e-5,
                            begin_norm_axis=-1)


def _ffn(h, p):
    return torch.relu(h @ p['ffn_w1'] + p['ffn_b1']) @ p['ffn_w2'] + \
        p['ffn_b2']


def _sample_key(seed, pos):
    # torch's CPU generator seeds its mt19937 from the low 32 bits only, so
    # (seed, pos) is mixed into 32 bits rather than packed side by side
    return int(np.random.SeedSequence(
        [int(seed) & 0xffffffff, int(pos) & 0xffffffff]).generate_state(1)[0])


def _sample_tokens(logits, seeds, positions, temps):
    """logits [N, V] fp32 -> int64 tokens [N]. Rows with temp == 0 are
    greedy (first maximum, as jnp.argmax); the others draw with a
    generator keyed on (seed, position)."""
    out = torch.argmax(logits, dim=-1)
    temps_h = temps.reshape(-1).tolist()
    if not any(t > 0.0 for t in temps_h):
        return out
    seeds_h = seeds.reshape(-1).tolist()
    pos_h = positions.reshape(-1).tolist()
    vocab = logits.shape[-1]
    for i, t in enumerate(temps_h):
        if t <= 0.0:
            continue
        g = torch.Generator(device='cpu')
        g.manual_seed(_sample_key(seeds_h[i], pos_h[i]))
        noise = -torch.empty(vocab).exponential_(generator=g).log_()
        out[i] = torch.argmax(logits[i] / max(t, 1e-6) +
                              noise.to(logits.device))
    return out


def _lm_inputs(ctx):
    if ctx.has_input('KScale'):
        raise NotImplementedError(
            'quantized (int8/fp8) KV arenas belong to a later port slice')
    emb = ctx.input('Emb')
    pos_enc = ctx.input('PosEnc')
    wout = ctx.input('OutProj')
    params = {s: ctx.env[ctx.op.input(_slot_to_input(s))]
              for s in LM_SLOTS}
    kc = ctx.input('KCache')            # [L, NB, H, bs, dk]
    vc = ctx.input('VCache')
    return emb, pos_enc, wout, params, kc, vc


def _extend_rows(emb, pos_enc, wout, params, kcs, vcs, n_head,
                 tokens, pos, live, tables, out_rows=None):
    """Shared core of prefill and decode: write N new tokens' K/V at
    absolute positions ``pos`` through per-row block ``tables`` [N, P],
    attend each row at its own ragged length (``pos + 1``), and return
    fp32 logits for ``h[out_rows]`` (all rows when None). Rows that are
    not ``live``, sit past the table's capacity, or hit a table entry
    outside [0, NB) write nothing (padded tails / empty batch slots).

    The arenas ``kcs``/``vcs`` are the scope's tensors and are updated IN
    PLACE: the reference rebuilds them functionally and relies on buffer
    donation; a functional update here would copy the whole arena (6.4 GB
    at full width, fp32) on every layer of every step."""
    n_layer, nb, _, bs, _ = kcs.shape
    d_model = emb.shape[-1]
    n, p_cap = tables.shape

    logical = torch.clamp(pos // bs, 0, p_cap - 1)
    phys = torch.gather(tables, 1, logical[:, None].long())[:, 0]
    # the reference's scatter mode='drop': an out-of-range index in a CUDA
    # index_put_ is a device-side assert, so the rows that may write are
    # chosen once here (phys and off are the same for every layer)
    keep = (pos < p_cap * bs) & live & (phys >= 0) & (phys < nb)
    rows = torch.nonzero(keep)[:, 0]
    w_phys = phys[rows].long()
    w_off = (pos[rows] % bs).long()

    tok = tokens.long().clamp(0, emb.shape[0] - 1)
    x = emb[tok] * (d_model ** 0.5) + \
        pos_enc[pos.long().clamp(0, pos_enc.shape[0] - 1)]
    att_lens = (pos + 1).to(torch.int32)

    h = x
    for layer in range(n_layer):
        p = {s: params[s][layer] for s in LM_SLOTS}
        kc, vc = kcs[layer], vcs[layer]          # views into the arenas
        k_new = _split_heads(h @ p['slf_k'], n_head)       # [N, H, dk]
        v_new = _split_heads(h @ p['slf_v'], n_head)
        kc[w_phys, :, w_off] = k_new[rows].to(kc.dtype)
        vc[w_phys, :, w_off] = v_new[rows].to(vc.dtype)
        q = _split_heads(h @ p['slf_q'], n_head)
        attn = paged_attention(q, kc, vc, tables, att_lens)
        h = _ln(h + attn.reshape(n, -1).to(h.dtype) @ p['slf_o'], p, 'ln1')
        h = _ln(h + _ffn(h, p), p, 'ln2')
    if out_rows is not None:
        h = h[out_rows]
    return (h @ wout).float()


def _set_arena_outputs(ctx, kcs, vcs):
    ctx.set_output('KCacheOut', kcs)
    ctx.set_output('VCacheOut', vcs)


@register('paged_decode_step')
def _paged_decode_step(ctx):
    emb, pos_enc, wout, params, kcs, vcs = _lm_inputs(ctx)
    n_head = ctx.attr('n_head', 1)

    tokens = ctx.input('Tokens').reshape(-1)                       # [B]
    lens = ctx.input('SeqLens').reshape(-1).to(torch.int32)        # [B]
    tables = ctx.input('BlockTables').to(torch.int32)              # [B, P]
    temps = ctx.input('Temps').reshape(-1).float()
    seeds = ctx.input('Seeds').reshape(-1)

    # one new token per row at position lens (empty slots feed all-NB
    # tables, so every write of theirs is dropped)
    live = torch.ones_like(lens, dtype=torch.bool)
    logits = _extend_rows(emb, pos_enc, wout, params, kcs, vcs, n_head,
                          tokens, lens, live, tables)
    nxt = _sample_tokens(logits, seeds, lens + 1, temps)
    ctx.set_output('NextTokens', nxt.to(ctx.out_dtype('NextTokens',
                                                      'int64')))
    _set_arena_outputs(ctx, kcs, vcs)


@register('paged_prefill')
def _paged_prefill(ctx):
    emb, pos_enc, wout, params, kcs, vcs = _lm_inputs(ctx)
    n_head = ctx.attr('n_head', 1)

    ids = ctx.input('Ids').reshape(-1)                      # [S] (padded)
    length = int(ctx.input('Len').reshape(-1)[0])
    cached = int(ctx.input('Cached').reshape(-1)[0])
    table = ctx.input('BlockTable').to(torch.int32).reshape(-1)   # [P]
    temp = ctx.input('Temp').reshape(1).float()
    seed = ctx.input('Seed').reshape(1)
    s = ids.shape[0]

    # suffix position t lives at absolute position cached + t; its query
    # attends to everything at or below it through the table. The S rows
    # share one table row: a stride-0 view, never a copy.
    t_idx = torch.arange(s, dtype=torch.int32, device=ids.device)
    pos = cached + t_idx
    tables = table.expand(s, table.shape[0])
    last = max(length - 1, 0)
    logits = _extend_rows(emb, pos_enc, wout, params, kcs, vcs, n_head,
                          ids, pos, t_idx < length, tables,
                          out_rows=slice(last, last + 1))
    nxt = _sample_tokens(logits, seed, torch.tensor([cached + length]),
                         temp)
    ctx.set_output('NextToken',
                   nxt.reshape(1).to(ctx.out_dtype('NextToken', 'int64')))
    _set_arena_outputs(ctx, kcs, vcs)
