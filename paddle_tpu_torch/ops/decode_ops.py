"""Beam search ops (reference: paddle_tpu ops/decode_ops.py; fluid's
beam_search_op, beam_search_decode_op). Static [B, beam] layout: one step
expands every live beam's candidates and keeps the best ``beam_size`` per
example; the decode backtracks the stacked steps into sentences. The
cores, ``beam_search_step`` and ``beam_backtrack``, are shared with the
KV-cached transformer_beam_decode op (ops/transformer_ops.py). CTC and
the linear-chain CRF of the reference module are not ported.
"""

import torch

from ..core.registry import register
from .tensor_ops import top_k

_NEG = -1e30


def beam_search_step(pre_ids, pre_scores, cand_ids, cand_scores, beam_size,
                     end_id):
    """One beam step. pre_ids, pre_scores: [B, beam]; cand_ids,
    cand_scores: [B, beam, K] (each beam's top-K). A finished beam (its
    last id is end_id) offers one candidate, end_id at its frozen score.
    Returns (sel_ids [B, beam] int64, sel_scores [B, beam], parent [B, beam]
    int64), the candidates in ``lax.top_k``'s order."""
    b, beam, k = cand_ids.shape
    finished = (pre_ids == end_id)[:, :, None]
    zero = torch.zeros((), dtype=cand_scores.dtype, device=cand_scores.device)
    total = pre_scores[:, :, None] + torch.where(finished, zero, cand_scores)
    cand_ids = torch.where(finished, torch.full((), end_id, dtype=torch.int64,
                                                device=cand_ids.device),
                           cand_ids.long())
    # a finished beam's duplicate candidates (every slot but 0) drop out
    dup = finished & (torch.arange(k, device=total.device) > 0)[None, None]
    total = total.masked_fill(dup, _NEG)
    top_scores, top_pos = top_k(total.reshape(b, beam * k), beam_size)
    sel_ids = cand_ids.reshape(b, beam * k).gather(1, top_pos)
    return sel_ids, top_scores, top_pos // k


def beam_backtrack(step_ids, step_parents, end_id):
    """Sentences [B, beam, T] from the stacked per-step selections
    step_ids, step_parents [T, B, beam]: a reversed walk of T gathers from
    each final slot through its parents; everything after a sentence's
    first end_id becomes end_id."""
    t, b, beam = step_ids.shape
    slot = torch.arange(beam, device=step_ids.device).expand(b, beam)
    toks = [None] * t
    for i in range(t - 1, -1, -1):
        toks[i] = step_ids[i].gather(1, slot)
        slot = step_parents[i].long().gather(1, slot)
    seq = torch.stack(toks, dim=-1).long()
    seen_end = torch.cumsum((seq == end_id).to(torch.int32), dim=-1)
    return torch.where((seen_end >= 1) & (seq != end_id),
                       torch.full((), end_id, dtype=seq.dtype,
                                  device=seq.device), seq)


@register('beam_search')
def _beam_search(ctx):
    sel_ids, sel_scores, parent = beam_search_step(
        ctx.input('pre_ids'), ctx.input('pre_scores'), ctx.input('ids'),
        ctx.input('scores'), ctx.attr('beam_size'), ctx.attr('end_id'))
    ctx.set_output('selected_ids', sel_ids)
    ctx.set_output('selected_scores', sel_scores)
    ctx.set_output('parent_idx', parent)


@register('beam_search_decode')
def _beam_search_decode(ctx):
    """StepIds / StepParents [T, B, beam] -> SentenceIds [B, beam, T]
    (end_id after the first end_id); SentenceScores passes FinalScores
    through."""
    ctx.set_output('SentenceIds', beam_backtrack(
        ctx.input('StepIds'), ctx.input('StepParents'), ctx.attr('end_id')))
    if ctx.has_input('FinalScores'):
        ctx.set_output('SentenceScores', ctx.input('FinalScores'))


@register('beam_gather')
def _beam_gather(ctx):
    """out[b, j, ...] = X[b, Index[b, j], ...]: per-beam state (token
    prefixes) reordered by parent after a beam_search step."""
    x = ctx.input('X')
    idx = ctx.input('Index').long()
    idx = idx.reshape(tuple(idx.shape) + (1,) * (x.dim() - 2))
    ctx.set_output('Out', x.gather(1, idx.expand(
        tuple(idx.shape[:2]) + tuple(x.shape[2:]))))
