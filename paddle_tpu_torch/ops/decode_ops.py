"""Structured prediction and decode ops (reference: paddle_tpu
ops/decode_ops.py; fluid's warpctc_op, ctc_align_op, linear_chain_crf_op,
crf_decoding_op, beam_search_op, beam_search_decode_op).

CTC and the linear-chain CRF are the reference's log-domain recurrences
over the padded time axis, batched over rows, with each row's values
frozen past its length and -1e30 for an impossible state; ``logaddexp``
has jnp.logaddexp's value and gradient (where both terms are -1e30 each
passes its whole gradient, as jax's JVP rule gives). Static [B, beam]
layout for beam search: one step expands every live beam's candidates and
keeps the best ``beam_size`` per example; the decode backtracks the
stacked steps into sentences. The cores, ``beam_search_step`` and
``beam_backtrack``, are shared with the KV-cached transformer_beam_decode
op (ops/transformer_ops.py). Every shape is static (ctc_align left-packs
into [B, T] with -1), so a captured step holds these ops.
"""

import torch

from ..core.registry import register
from . import pointwise
from .tensor_ops import top_k

_NEG = -1e30


def _finite_or_zero(x):
    return torch.where(torch.isinf(x), torch.zeros_like(x), x)


def _logaddexp_value(x1, x2):
    amax = torch.maximum(x1, x2)
    delta = x1 - x2
    return torch.where(torch.isnan(delta), x1 + x2,
                       amax + torch.log1p(torch.exp(-torch.abs(delta))))


_LOGADDEXP_GRADS = (
    lambda g, out, x1, x2: g * torch.exp(_finite_or_zero(x1) -
                                         _finite_or_zero(out)),
    lambda g, out, x1, x2: g * torch.exp(_finite_or_zero(x2) -
                                         _finite_or_zero(out)))


def logaddexp(x1, x2):
    """jnp.logaddexp with its JVP rule (torch's gives each term half of the
    gradient where both are equal)."""
    return pointwise.rule(_logaddexp_value, _LOGADDEXP_GRADS, x1, x2)


def logsumexp(a, dim, keepdim=False):
    """jax.scipy.special.logsumexp: log(sum(exp(a - amax))) + amax with
    amax a constant (0 where it is not finite), so the gradient is the
    softmax of a however large its values (torch.logsumexp's backward
    takes exp(a - result), which is 1 at every tie once the result has
    rounded to the largest term, beyond 2^24 in fp32)."""
    amax = a.detach().amax(dim, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    out = torch.log(torch.sum(torch.exp(a - amax), dim, keepdim=True)) + amax
    return out if keepdim else out.squeeze(dim)


def _log_softmax(x):
    return x - logsumexp(x, -1, keepdim=True)


def lengths_or_full(ctx, slot, batch, full):
    """The int64 [B] lengths of ``slot``, or ``full`` for every row."""
    if ctx.has_input(slot):
        return ctx.input(slot).reshape(-1).long()
    return torch.full((batch,), full, dtype=torch.int64,
                      device=ctx.device)


# --------------------------------------------------------------------- CTC
def ctc_loss(log_probs, label, t_len, l_len, blank):
    """-log p(label | logits) a row: log_probs [B, T, C] fp32, label
    [B, L] int, t_len and l_len [B] int64."""
    b, t, _ = log_probs.shape
    big_l = label.shape[1]
    s = 2 * big_l + 1
    dev = log_probs.device
    ext = torch.full((b, s), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = label.long()
    pos = torch.arange(s, device=dev)
    s_valid = pos[None, :] < (2 * l_len + 1)[:, None]
    ext_m2 = torch.cat([torch.full((b, 2), -1, dtype=torch.int64,
                                   device=dev), ext[:, :-2]], 1)
    can_skip = (pos % 2 == 1)[None, :] & (ext != ext_m2)
    neg = torch.full((), _NEG, device=dev)
    first = log_probs[:, 0].gather(1, ext)
    alpha = torch.where(pos[None, :] == 0, first, neg)
    if s > 1:
        alpha = torch.where((pos[None, :] == 1) & (l_len[:, None] > 0),
                            first, alpha)
    alpha = torch.where(s_valid, alpha, neg)
    negs = torch.full((b, 2), _NEG, device=dev)
    for step in range(1, t):
        prev1 = torch.cat([negs[:, :1], alpha[:, :-1]], 1)
        prev2 = torch.where(can_skip,
                            torch.cat([negs, alpha[:, :-2]], 1)[:, :s], neg)
        new = logaddexp(logaddexp(alpha, prev1), prev2) + \
            log_probs[:, step].gather(1, ext)
        new = torch.where(s_valid, new, neg)
        alpha = torch.where((step < t_len)[:, None], new, alpha)
    end1 = alpha.gather(1, (2 * l_len)[:, None])[:, 0]
    end2 = torch.where(l_len > 0, alpha.gather(
        1, torch.clamp(2 * l_len - 1, min=0)[:, None])[:, 0], neg)
    return -logaddexp(end1, end2)


@register('warpctc')
def _warpctc(ctx):
    """CTC loss [B, 1] of Logits [B, T, C] (log-softmax over C in fp32)
    against Label [B, L], with LogitsLength / LabelLength (default T and
    L); over the row's length with ``norm_by_times``."""
    logits = ctx.input('Logits')
    label = ctx.input('Label')
    b, t = logits.shape[0], logits.shape[1]
    t_len = lengths_or_full(ctx, 'LogitsLength', b, t)
    l_len = lengths_or_full(ctx, 'LabelLength', b, label.shape[1])
    loss = ctc_loss(_log_softmax(logits.float()), label, t_len, l_len,
                    ctx.attr('blank', 0))
    if ctx.attr('norm_by_times', False):
        loss = loss / torch.clamp(t_len.to(loss.dtype), min=1.0)
    ctx.set_output('Loss', loss.reshape(b, 1))


@register('ctc_align')
def _ctc_align(ctx):
    """Greedy CTC decode of Input [B, T] (argmaxed ids): repeats merged,
    blanks dropped, left-packed into [B, T] padded with -1; OutputLength
    [B, 1] int64."""
    ids = ctx.input('Input')
    blank = ctx.attr('blank', 0)
    b, t = ids.shape
    t_len = lengths_or_full(ctx, 'Length', b, t)
    prev = torch.cat([torch.full((b, 1), -1, dtype=ids.dtype,
                                 device=ids.device), ids[:, :-1]], 1)
    pos = torch.arange(t, device=ids.device)
    keep = (ids != blank) & (ids != prev) & (pos[None, :] < t_len[:, None])
    where = torch.where(keep, torch.cumsum(keep.long(), 1) - 1,
                        torch.full((), t, device=ids.device))
    # every dropped id lands in the spare column t, cut off after
    out = torch.full((b, t + 1), -1, dtype=ids.dtype, device=ids.device)
    out.scatter_(1, where, ids)
    ctx.set_output('Output', out[:, :t])
    ctx.set_output('OutputLength', keep.sum(1, keepdim=True).to(
        ctx.out_dtype('OutputLength', 'int64')))


# --------------------------------------------------------------------- CRF
def _crf_split(transition):
    """(start [C], stop [C], trans [C, C]) of the [C + 2, C] layout."""
    return transition[0], transition[1], transition[2:]


def crf_nll(emission, transition, label, length):
    """-log p(label | emission) under a linear-chain CRF a row:
    emission [B, T, C] fp32, transition [C + 2, C], label [B, T] int,
    length [B] int64."""
    b, t, c = emission.shape
    start, stop, trans = _crf_split(transition)
    alpha = start[None, :] + emission[:, 0]
    for step in range(1, t):
        scores = alpha[:, :, None] + trans[None] + emission[:, step][:, None]
        alpha = torch.where((step < length)[:, None], logsumexp(scores, 1),
                            alpha)
    log_z = logsumexp(alpha + stop[None, :], -1)
    label = label.long()
    alive = torch.arange(t, device=emission.device)[None, :] < \
        length[:, None]
    zero = torch.zeros((), device=emission.device)
    em = torch.where(alive, emission.gather(2, label[..., None])[..., 0],
                     zero).sum(1)
    tr = torch.where(alive[:, 1:], trans[label[:, :-1], label[:, 1:]],
                     zero).sum(1)
    last = label.gather(1, torch.clamp(length - 1, min=0)[:, None])[:, 0]
    return log_z - (start[label[:, 0]] + em + tr + stop[last])


@register('linear_chain_crf')
def _linear_chain_crf(ctx):
    """The CRF's negative log-likelihood [B, 1] of Label [B, T] (or
    [B, T, 1]) under Emission [B, T, C] and Transition [C + 2, C] (start
    row, stop row, then from-tag x to-tag), fp32."""
    emission = ctx.input('Emission')
    b, t = emission.shape[0], emission.shape[1]
    label = ctx.input('Label').reshape(b, t)
    nll = crf_nll(emission.float(), ctx.input('Transition').float(), label,
                  lengths_or_full(ctx, 'Length', b, t))
    ctx.set_output('LogLikelihood', nll.reshape(b, 1))


def viterbi(emission, transition, length):
    """The best tag path [B, T] int64 a row (0 past its length), ties to
    the first tag (argmax's first maximum)."""
    b, t, c = emission.shape
    start, stop, trans = _crf_split(transition)
    tags = torch.arange(c, device=emission.device)
    delta = start[None, :] + emission[:, 0]
    back = []
    for step in range(1, t):
        scores = delta[:, :, None] + trans[None] + emission[:, step][:, None]
        alive = (step < length)[:, None]
        back.append(torch.where(alive, torch.argmax(scores, 1),
                                tags[None, :]))
        delta = torch.where(alive, scores.amax(1), delta)
    tag = torch.argmax(delta + stop[None, :], -1)
    path = [None] * t
    for step in range(t - 1, 0, -1):
        path[step] = tag
        tag = back[step - 1].gather(1, tag[:, None])[:, 0]
    path[0] = tag
    path = torch.stack(path, 1)
    alive = torch.arange(t, device=emission.device)[None, :] < \
        length[:, None]
    return torch.where(alive, path, torch.zeros_like(path))


@register('crf_decoding')
def _crf_decoding(ctx):
    """Viterbi over Emission [B, T, C] with Transition: the path [B, T]
    int64 or, with Label, 1 where the path equals it (within the row's
    length)."""
    emission = ctx.input('Emission')
    b, t = emission.shape[0], emission.shape[1]
    length = lengths_or_full(ctx, 'Length', b, t)
    path = viterbi(emission.float(), ctx.input('Transition').float(), length)
    out = ctx.out_dtype('ViterbiPath', 'int64')
    if ctx.has_input('Label'):
        label = ctx.input('Label').reshape(b, t)
        alive = torch.arange(t, device=path.device)[None, :] < \
            length[:, None]
        ctx.set_output('ViterbiPath', ((path == label) & alive).to(out))
    else:
        ctx.set_output('ViterbiPath', path.to(out))


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
