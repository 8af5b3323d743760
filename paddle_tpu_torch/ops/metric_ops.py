"""Metric ops computed in the step (reference: paddle_tpu
ops/metric_ops.py; fluid's precision_recall_op, positive_negative_pair_op
and edit_distance_op): one-hot sums, an N x N pair matrix and a row
recurrence, every shape static, so a captured step holds them."""

import torch

from ..core.registry import register
from .decode_ops import lengths_or_full


def _prec(tp, fp):
    """tp / (tp + fp), 1 where nothing was counted (the reference's
    convention, precision_recall_op.h:102-113)."""
    denom = tp + fp
    one = torch.ones_like(denom)
    return torch.where(denom > 0, tp / torch.where(denom > 0, denom, one),
                       one)


def _f1(p, r):
    s = p + r
    return torch.where(s > 0, 2 * p * r / torch.where(s > 0, s,
                                                      torch.ones_like(s)),
                       torch.zeros_like(s))


def _metrics(states):
    """[C, 4] (TP FP TN FN) -> [macro P, R, F1, micro P, R, F1]."""
    tp, fp, fn = states[:, 0], states[:, 1], states[:, 3]
    macro_p, macro_r = _prec(tp, fp).mean(), _prec(tp, fn).mean()
    micro_p, micro_r = _prec(tp.sum(), fp.sum()), _prec(tp.sum(), fn.sum())
    return torch.stack([macro_p, macro_r, _f1(macro_p, macro_r), micro_p,
                        micro_r, _f1(micro_p, micro_r)])


@register('precision_recall')
def _precision_recall(ctx):
    """Multi-class (optionally weighted) precision, recall and F1 of
    Indices against Labels, with the TP / FP / TN / FN states [C, 4]
    added to StatesInfo (precision_recall_op.h:30-98)."""
    idx = ctx.input('Indices').reshape(-1).long()
    labels = ctx.input('Labels').reshape(-1).long()
    w = ctx.input('Weights').reshape(-1).float() \
        if ctx.has_input('Weights') else \
        torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    c = torch.arange(ctx.attr('class_number'), device=idx.device)
    is_idx = (idx[:, None] == c[None, :]).float()
    is_lab = (labels[:, None] == c[None, :]).float()
    correct = (idx == labels).float()
    tp = (w * correct) @ is_idx
    fp = (w * (1 - correct)) @ is_idx
    fn = (w * (1 - correct)) @ is_lab
    tn = w.sum() - w @ torch.maximum(is_idx, is_lab)
    batch = torch.stack([tp, fp, tn, fn], 1)
    ctx.set_output('BatchMetrics', _metrics(batch))
    accum = batch
    if ctx.has_input('StatesInfo'):
        accum = accum + ctx.input('StatesInfo').float()
    ctx.set_output('AccumStatesInfo', accum)
    ctx.set_output('AccumMetrics', _metrics(accum))


@register('positive_negative_pair')
def _positive_negative_pair(ctx):
    """Pairs of one query with differing labels (positive_negative_pair_op.
    h:36-101): positive where the scores' order agrees with the labels',
    else negative; equal scores count as neutral too (the reference counts
    such a pair neutral and negative). Pairs weigh the mean of their two
    weights; the Accumulate* inputs are added."""
    label = ctx.input('Label').reshape(-1).float()
    qid = ctx.input('QueryID').reshape(-1)
    s = ctx.input('Score')[:, ctx.attr('column', 0)].float()
    w = ctx.input('Weight').reshape(-1).float() \
        if ctx.has_input('Weight') else torch.ones_like(s)
    n = s.shape[0]
    upper = torch.ones((n, n), dtype=torch.bool, device=s.device).triu(1)
    dl = label[:, None] - label[None, :]
    ds = s[:, None] - s[None, :]
    pair_w = (w[:, None] + w[None, :]) * 0.5
    considered = (upper & (qid[:, None] == qid[None, :]) &
                  (dl != 0)).float() * pair_w
    pos = (considered * (ds * dl > 0)).sum()
    neg = (considered * (ds * dl <= 0)).sum()
    neu = (considered * (ds == 0)).sum()
    if ctx.has_input('AccumulatePositivePair'):
        pos = pos + ctx.input('AccumulatePositivePair').reshape(())
        neg = neg + ctx.input('AccumulateNegativePair').reshape(())
        neu = neu + ctx.input('AccumulateNeutralPair').reshape(())
    ctx.set_output('PositivePair', pos.reshape(1))
    ctx.set_output('NegativePair', neg.reshape(1))
    ctx.set_output('NeutralPair', neu.reshape(1))


@register('edit_distance')
def _edit_distance(ctx):
    """Levenshtein distance [B, 1] between Hyps [B, T1] and Refs [B, T2]
    (with HypsLength / RefsLength), over the reference's length with
    ``normalized``. The row recurrence runs over the hypothesis'
    positions; a row's insertions close as a prefix minimum (cummin of
    cand - j, plus j), so every row is one vector step."""
    hyp = ctx.input('Hyps').long()
    ref = ctx.input('Refs').long()
    b, t1 = hyp.shape
    t2 = ref.shape[1]
    dev = hyp.device
    hyp_len = lengths_or_full(ctx, 'HypsLength', b, t1)
    ref_len = lengths_or_full(ctx, 'RefsLength', b, t2)
    j = torch.arange(t2 + 1, dtype=torch.float32, device=dev)
    row = j[None, :].expand(b, t2 + 1)
    rows = [row]
    for i in range(t1):
        sub = (ref != hyp[:, i:i + 1]).float()
        tail = torch.minimum(row[:, 1:] + 1.0, row[:, :-1] + sub)
        cand = torch.cat([row[:, :1] + 1.0, tail], 1)
        row = torch.cummin(cand - j[None, :], 1).values + j[None, :]
        rows.append(row)
    table = torch.stack(rows, 0)                     # [T1 + 1, B, T2 + 1]
    d_row = table.gather(0, hyp_len.reshape(1, b, 1).expand(
        1, b, t2 + 1))[0]
    dist = d_row.gather(1, ref_len[:, None])
    if ctx.attr('normalized', True):
        dist = dist / torch.clamp(ref_len[:, None], min=1).float()
    ctx.set_output('Out', dist)
    ctx.set_output('SequenceNum', torch.full(
        (1,), b, dtype=ctx.out_dtype('SequenceNum', 'int64'), device=dev))
