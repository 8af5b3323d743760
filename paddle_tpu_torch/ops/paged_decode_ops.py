"""Paged incremental-decode ops for the decode-serving engine (reference:
paddle_tpu ops/paged_decode_ops.py).

Three IR ops over a decoder-only (GPT-block) transformer whose KV cache
lives in a paged pool ([L, NB, H, bs, d] arenas):

- ``paged_prefill`` — extend a sequence whose first ``Cached`` tokens
  already have KV (a prefix-cache hit; 0 on a miss) by a padded suffix
  [1, S]: write each suffix position's K/V into the sequence's pages
  through its block table, attend each suffix query at its own absolute
  length (one ragged paged-attention pass over S rows), and emit the next
  token.
- ``paged_decode_step`` — one token for every slot of the fixed-size
  decode batch [B]: append each row's K/V at its own position, ragged
  paged attention at per-row lengths, then greedy or temperature
  sampling per row. Empty slots feed all-NB tables, so their writes
  are dropped.
- ``paged_spec_verify`` — speculative-decoding verification: score k+1
  tokens (the pending token and k drafts) for every slot of [B] in one
  ragged pass over B*(k+1) single-token rows; row (b, j) sits at position
  lens[b]+j and attends at length lens[b]+j+1. Writes K/V for all k+1
  positions; the engine's acceptance rule decides how many become real
  (the rest lie above the advanced cache_len and are overwritten).

All three go through ``_extend_rows``, which per layer runs the layer's
KV write and the paged attention kernel (``write_attend``) and the
layer-norm kernel twice. The decode and verify steps fold the write into
the attention's launch (``paged_attention_write``) where the new rows have
the arena's dtype (fp32 rows into fp32 arenas); the prefill, and arenas
that convert the rows (bf16, int8, fp8), launch the stand-alone write
(``kv_write``) before the attention: there the fold measured slower.
Every per-row
computation is independent of the other rows, so a sequence's stream does
not depend on what else is in the batch, on a cache hit, or on
speculation. The matrix products keep that too: they run in fixed tiles
of ``ROW_TILE`` rows (``_mm``), because cuBLAS chooses its fp32 algorithm
(its split-K) by the row count, and a row's bits then change with the
batch (chip_smoke.py phase 3 shows it on the card).

Quantized arenas (int8 / fp8, with fp32 scale arenas [L, NB, H, bs]): each
written K/V row is quantized on its own (quant.core.quantize_rows' bits,
one scale a (token, head) row) and the paged attention kernel dequantizes
in registers through the same tables, so every invariant above holds at
the quantized dtypes too.

The decode and verify steps name, for every row, the positions it writes
in this call: from ``fresh_lo`` up to the row's own, whose K/V are input
row ``fresh_src + position - fresh_lo`` (decode: the row's own position
and row; verify: row (b, j) from lens[b], rows b*(k+1) ...). The folded
launch reads those positions from the input, never from the arena it
writes.

Sampling: the token at position i is greedy at temp == 0, else the
Gumbel-max draw argmax(logits / temp - log(E)) with E ~ Exp(1) from the
counter-based bits of (seed, i, vocab index) (kernels/random_bits.py
``gumbel_noise``), computed on the device for every row. A stream thus
depends only on (seed, positions), as in the reference, but the bits differ
from jax.random's: the two packages agree at temperature 0 only.

Nothing here reads a device value on the host or copies from the host, so
the executor can capture each op in a CUDA graph: the rows that write
their K/V are chosen on the device (the paged-attention launch drops the
others), the prefill's length and cached span stay device tensors, and
its last row is picked with a device index.
"""

import torch

from ..core.registry import register
from ..quant.core import kv_quantized
from .kernels.kv_write import kv_write
from .kernels.layer_norm import fused_layer_norm
from .kernels.paged_attention import paged_attention, paged_attention_write
from .kernels.random_bits import gumbel_noise
from .transformer_ops import ENC_SLOTS, _slot_to_input

LM_SLOTS = ENC_SLOTS   # decoder-only block reuses the encoder slot layout
# rows of every matrix product of the LM: one GEMM shape for every call
ROW_TILE = 64


def _split_heads(x, n_head):
    """[..., H*D] -> [..., H, D]."""
    return x.reshape(x.shape[:-1] + (n_head, x.shape[-1] // n_head))


def _ln(h, p, slot):
    return fused_layer_norm(h, p[slot + '_w'], p[slot + '_b'], eps=1e-5,
                            begin_norm_axis=-1)


def _pad_rows(x, rows):
    """``x`` [n, ...] with zero rows appended up to ``rows``."""
    if x.shape[0] == rows:
        return x
    return torch.cat([x, x.new_zeros((rows - x.shape[0],) + x.shape[1:])])


def _mm(x, w):
    """``x @ w`` as products of ROW_TILE rows each (x's rows a multiple
    of it), so a row's bits depend only on the row and ``w``: every call
    of a given ``w`` is the same GEMM shape."""
    m = x.shape[0]
    if m == ROW_TILE:
        return x @ w
    out = x.new_empty((m, w.shape[1]))
    for i in range(0, m, ROW_TILE):
        torch.matmul(x[i:i + ROW_TILE], w, out=out[i:i + ROW_TILE])
    return out


def _ffn(h, p):
    return _mm(torch.relu(_mm(h, p['ffn_w1']) + p['ffn_b1']),
               p['ffn_w2']) + p['ffn_b2']


def _sample_tokens(logits, seeds, positions, temps):
    """logits [N, V] fp32 -> int64 tokens [N]. Rows with temp == 0 are
    greedy (first maximum, as jnp.argmax); the others take the Gumbel-max
    draw keyed on (seed, position). Every row is computed (no host read of
    the temperatures), each from its own row alone."""
    greedy = torch.argmax(logits, dim=-1)
    temps = temps.reshape(-1)
    noise = gumbel_noise(seeds.reshape(-1), positions.reshape(-1),
                         logits.shape[-1])
    drawn = torch.argmax(logits / torch.clamp(temps, min=1e-6)[:, None] +
                         noise, dim=-1)
    return torch.where(temps > 0.0, drawn, greedy)


def _lm_inputs(ctx):
    emb = ctx.input('Emb')
    pos_enc = ctx.input('PosEnc')
    wout = ctx.input('OutProj')
    params = {s: ctx.env[ctx.op.input(_slot_to_input(s))]
              for s in LM_SLOTS}
    kc = ctx.input('KCache')            # [L, NB, H, bs, dk]
    vc = ctx.input('VCache')
    ks = ctx.input('KScale') if ctx.has_input('KScale') else None
    vs = ctx.input('VScale') if ctx.has_input('VScale') else None
    return emb, pos_enc, wout, params, kc, vc, ks, vs


def write_slots(tables, pos, live, nb, bs):
    """Where each row writes its K/V: (phys, off, keep), [N] int32, int32
    and bool, the reference's scatter mode='drop' decided on the device. A
    row writes only inside its table's capacity, when ``live``, through a
    table entry inside the pool [0, ``nb``)."""
    p_cap = tables.shape[1]
    logical = torch.clamp(pos // bs, 0, p_cap - 1)
    phys = torch.gather(tables, 1, logical[:, None].long())[:, 0] \
        .to(torch.int32).contiguous()
    keep = ((pos < p_cap * bs) & live & (phys >= 0) & (phys < nb)) \
        .contiguous()
    off = (pos % bs).to(torch.int32).contiguous()
    return phys, off, keep


def write_attend(q, k_new, v_new, kc, vc, tables, lens, phys, off, keep,
                 fresh=None, ksc=None, vsc=None):
    """One layer's KV write (``write_slots``' rows) and paged attention at
    ``lens``: one launch, the write folded in (``paged_attention_write``),
    where ``fresh`` = (fresh_lo, fresh_src) names the rows' fresh positions
    (the decode and verify steps, new rows of the arena's dtype); else the
    stand-alone write, then the attention."""
    if fresh is not None:
        return paged_attention_write(q, k_new, v_new, kc, vc, tables, lens,
                                     phys, off, keep, *fresh)
    kv_write(k_new, v_new, kc, vc, phys, off, keep, ksc, vsc)
    return paged_attention(q, kc, vc, tables, lens, k_scales=ksc,
                           v_scales=vsc)


def _extend_rows(emb, pos_enc, wout, params, kcs, vcs, n_head,
                 tokens, pos, live, tables, fresh=None, kscales=None,
                 vscales=None, out_rows=None):
    """Shared core of the three ops: write N new tokens' K/V at absolute
    positions ``pos`` through per-row block ``tables`` [N, P], attend each
    row at its own ragged length (``pos + 1``), and return fp32 logits for
    ``h[out_rows]`` (all rows when None; else ``out_rows`` is a [1] device
    index). Rows that are not ``live``, sit past the table's capacity, or
    hit a table entry outside [0, NB) write nothing (padded tails / empty
    batch slots). Each layer's write and attention go through
    ``write_attend``. ``fresh`` (decode and verify): a function giving
    (fresh_lo, fresh_src), int32 [N] device tensors: row r's positions
    [``fresh_lo[r]``, ``pos[r]``] are this call's rows ``fresh_src[r]`` ...
    It is called, and the write folded into the attention's launch, where
    the new rows have the arena's dtype (fp32 rows into fp32 arenas); the
    folded launch reads those positions from the input rather than from
    the arena.

    Quantized arenas (``kscales``/``vscales`` [L, NB, H, bs] given): each
    new K/V row is quantized on its own (one fp32 scale a (token, head)
    row) and written with its scale; the attention dequantizes through the
    same tables.

    The arenas are the scope's tensors and are updated IN PLACE: the
    reference rebuilds them functionally and relies on buffer donation; a
    functional update here would copy the whole arena (6.4 GB at full
    width, fp32) on every layer of every step. So a page that another
    sequence shares (a published prefix-cache page) must never be a
    target: the engine writes only positions at or past a sequence's
    cached span, which lie in its own pages. That also keeps the folded
    launch free of races: no row reads from the arena a slot it writes."""
    n_layer, nb, _, bs, _ = kcs.shape
    d_model = emb.shape[-1]
    n = tables.shape[0]
    quantized = kv_quantized(str(kcs.dtype)[6:])
    m = -(-n // ROW_TILE) * ROW_TILE         # rows of every product

    # the same every layer
    phys, off, keep = write_slots(tables, pos, live, nb, bs)

    tok = tokens.long().clamp(0, emb.shape[0] - 1)
    x = emb[tok] * (d_model ** 0.5) + \
        pos_enc[pos.long().clamp(0, pos_enc.shape[0] - 1)]
    if fresh is not None and x.dtype == kcs.dtype:
        fresh = tuple(t.to(torch.int32).contiguous() for t in fresh())
    else:
        fresh = None
    att_lens = (pos + 1).to(torch.int32)

    h = _pad_rows(x, m)
    for layer in range(n_layer):
        p = {s: params[s][layer] for s in LM_SLOTS}
        kc, vc = kcs[layer], vcs[layer]          # views into the arenas
        k_new = _split_heads(_mm(h, p['slf_k'])[:n], n_head)   # [N, H, dk]
        v_new = _split_heads(_mm(h, p['slf_v'])[:n], n_head)
        ksc = vsc = None
        if quantized:
            ksc, vsc = kscales[layer], vscales[layer]
        q = _split_heads(_mm(h, p['slf_q'])[:n], n_head)
        attn = write_attend(q, k_new, v_new, kc, vc, tables, att_lens, phys,
                            off, keep, fresh, ksc, vsc)
        attn = _pad_rows(attn.reshape(n, -1).to(h.dtype), m)
        h = _ln(h + _mm(attn, p['slf_o']), p, 'ln1')
        h = _ln(h + _ffn(h, p), p, 'ln2')
    if out_rows is None:
        return _mm(h, wout)[:n].float()
    last = h.index_select(0, out_rows)
    return _mm(_pad_rows(last, ROW_TILE), wout)[:last.shape[0]].float()


def _set_arena_outputs(ctx, kcs, vcs, kss, vss):
    ctx.set_output('KCacheOut', kcs)
    ctx.set_output('VCacheOut', vcs)
    if kss is not None:
        ctx.set_output('KScaleOut', kss)
        ctx.set_output('VScaleOut', vss)


def _batch_inputs(ctx):
    tokens = ctx.input('Tokens')
    lens = ctx.input('SeqLens').reshape(-1).to(torch.int32)        # [B]
    tables = ctx.input('BlockTables').to(torch.int32)              # [B, P]
    temps = ctx.input('Temps').reshape(-1).float()
    seeds = ctx.input('Seeds').reshape(-1)
    return tokens, lens, tables, temps, seeds


@register('paged_decode_step')
def _paged_decode_step(ctx):
    emb, pos_enc, wout, params, kcs, vcs, kss, vss = _lm_inputs(ctx)
    n_head = ctx.attr('n_head', 1)
    tokens, lens, tables, temps, seeds = _batch_inputs(ctx)

    # one new token per row at position lens (empty slots feed all-NB
    # tables, so every write of theirs is dropped); each row's only fresh
    # position is its own
    live = torch.ones_like(lens, dtype=torch.bool)

    def fresh():
        return lens, torch.arange(lens.shape[0], dtype=torch.int32,
                                  device=lens.device)
    logits = _extend_rows(emb, pos_enc, wout, params, kcs, vcs, n_head,
                          tokens.reshape(-1), lens, live, tables, fresh,
                          kss, vss)
    nxt = _sample_tokens(logits, seeds, lens + 1, temps)
    ctx.set_output('NextTokens', nxt.to(ctx.out_dtype('NextTokens',
                                                      'int64')))
    _set_arena_outputs(ctx, kcs, vcs, kss, vss)


@register('paged_prefill')
def _paged_prefill(ctx):
    emb, pos_enc, wout, params, kcs, vcs, kss, vss = _lm_inputs(ctx)
    n_head = ctx.attr('n_head', 1)

    ids = ctx.input('Ids').reshape(-1)                      # [S] (padded)
    # [1] device tensors, never read on the host
    length = ctx.input('Len').reshape(1).to(torch.int32)
    cached = ctx.input('Cached').reshape(1).to(torch.int32)
    table = ctx.input('BlockTable').to(torch.int32).reshape(-1)   # [P]
    temp = ctx.input('Temp').reshape(1).float()
    seed = ctx.input('Seed').reshape(1)
    s = ids.shape[0]

    # suffix position t lives at absolute position cached + t; its query
    # attends to everything at or below it through the table: the cached
    # pages and this run's own earlier writes. The S rows share one table
    # row: a stride-0 view, never a copy.
    t_idx = torch.arange(s, dtype=torch.int32, device=ids.device)
    pos = cached + t_idx
    tables = table.expand(s, table.shape[0])
    last = torch.clamp(length - 1, min=0).long()
    logits = _extend_rows(emb, pos_enc, wout, params, kcs, vcs, n_head,
                          ids, pos, t_idx < length, tables,
                          kscales=kss, vscales=vss, out_rows=last)
    nxt = _sample_tokens(logits, seed, cached + length, temp)
    ctx.set_output('NextToken',
                   nxt.reshape(1).to(ctx.out_dtype('NextToken', 'int64')))
    _set_arena_outputs(ctx, kcs, vcs, kss, vss)


@register('paged_spec_verify')
def _paged_spec_verify(ctx):
    emb, pos_enc, wout, params, kcs, vcs, kss, vss = _lm_inputs(ctx)
    n_head = ctx.attr('n_head', 1)
    tokens, lens, tables, temps, seeds = _batch_inputs(ctx)   # tokens [B, K1]
    b, k1 = tokens.shape

    # B*K1 single-token rows: row (b, j) holds the j-th speculative token
    # at position lens[b] + j and attends at its own length (empty slots
    # ride along as in the decode step: all-NB tables drop every write)
    def rep(x):          # [B, ...] -> [B*K1, ...], each row K1 times
        return x[:, None].expand((b, k1) + tuple(x.shape[1:])) \
            .reshape((b * k1,) + tuple(x.shape[1:]))

    # Row (b, j)'s positions from lens[b] on are rows b*K1 ... b*K1 + j:
    # its own and its sequence's earlier drafts.
    j = torch.arange(k1, dtype=torch.int32, device=lens.device)
    pos = (lens[:, None] + j[None, :]).reshape(-1)              # [B*K1]
    live = torch.ones_like(pos, dtype=torch.bool)

    def fresh():
        return rep(lens), rep(torch.arange(0, b * k1, k1, dtype=torch.int32,
                                           device=lens.device))
    logits = _extend_rows(emb, pos_enc, wout, params, kcs, vcs, n_head,
                          tokens.reshape(-1), pos, live, rep(tables), fresh,
                          kss, vss)
    nxt = _sample_tokens(logits, rep(seeds), pos + 1, rep(temps))
    ctx.set_output('NextTokens', nxt.reshape(b, k1).to(
        ctx.out_dtype('NextTokens', 'int64')))
    _set_arena_outputs(ctx, kcs, vcs, kss, vss)
