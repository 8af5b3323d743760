"""Detection ops (reference: paddle_tpu ops/detection_ops.py;
paddle/fluid/operators/detection/{iou_similarity,box_coder,prior_box,
bipartite_match,target_assign,mine_hard_examples,multiclass_nms}_op.cc).

Ground-truth boxes are padded [B, M, 4] rows whose padding has zero IoU
with everything, so no op needs ragged sequences. The loops of the
reference's vmapped ``fori_loop``s (bipartite_match's M greedy picks,
multiclass_nms's suppression over nms_top_k candidates) are Python loops of
their static trip count over tensors batched over the examples (and, in
the NMS, the classes): no host read, so a step that holds them is
captured. The priors are computed on the device from the shapes and
attributes, in float64 as the reference's numpy computes them.
"""

import math

import torch

from ..core.registry import register
from .pointwise import amax, maximum, minimum
from .tensor_ops import top_k


def _at_least(x, v):
    """jnp.maximum(x, v): a tie splits the gradient (pointwise.maximum)."""
    return maximum(x, torch.full((), v, dtype=x.dtype, device=x.device))


def _iou_matrix(x, y):
    """IoU of every x box [..., N, 4] against every y box [M, 4] (corner
    boxes): [..., N, M]."""
    area_x = (x[..., 2] - x[..., 0]) * (x[..., 3] - x[..., 1])
    area_y = (y[:, 2] - y[:, 0]) * (y[:, 3] - y[:, 1])
    lt = maximum(x[..., :, None, :2], y[:, :2])
    rb = minimum(x[..., :, None, 2:], y[:, 2:])
    wh = _at_least(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_x[..., None] + area_y - inter
    return inter / _at_least(union, 1e-10)


@register('iou_similarity')
def _iou_similarity(ctx):
    """X [N, 4] or [B, N, 4], Y [M, 4] -> Out [(B,) N, M]."""
    ctx.set_output('Out', _iou_matrix(ctx.input('X'), ctx.input('Y')))


@register('box_coder')
def _box_coder(ctx):
    """encode_center_size (TargetBox [N, 4] against every prior: [N, M,
    4]), encode_aligned (TargetBox [..., M, 4], one box a prior) and
    decode_center_size (offsets [N, M, 4] or [M, 4] to corner boxes)."""
    prior = ctx.input('PriorBox')        # [M, 4]
    if ctx.has_input('PriorBoxVar'):
        var = ctx.input('PriorBoxVar')
    else:
        var = torch.stack([torch.full((prior.shape[0],), v,
                                      dtype=torch.float32,
                                      device=prior.device)
                           for v in (0.1, 0.1, 0.2, 0.2)], -1)
    target = ctx.input('TargetBox')
    code_type = ctx.attr('code_type', 'encode_center_size')
    pw = prior[:, 2] - prior[:, 0]
    ph = prior[:, 3] - prior[:, 1]
    pcx = prior[:, 0] + 0.5 * pw
    pcy = prior[:, 1] + 0.5 * ph
    if code_type == 'encode_center_size':
        tw = target[:, 2] - target[:, 0]
        th = target[:, 3] - target[:, 1]
        tcx = target[:, 0] + 0.5 * tw
        tcy = target[:, 1] + 0.5 * th
        out = torch.stack([
            (tcx[:, None] - pcx[None, :]) / pw[None, :] / var[:, 0],
            (tcy[:, None] - pcy[None, :]) / ph[None, :] / var[:, 1],
            torch.log(tw[:, None] / pw[None, :]) / var[:, 2],
            torch.log(th[:, None] / ph[None, :]) / var[:, 3],
        ], -1)
    elif code_type == 'encode_aligned':
        tw = _at_least(target[..., 2] - target[..., 0], 1e-6)
        th = _at_least(target[..., 3] - target[..., 1], 1e-6)
        tcx = target[..., 0] + 0.5 * tw
        tcy = target[..., 1] + 0.5 * th
        out = torch.stack([
            (tcx - pcx) / pw / var[:, 0],
            (tcy - pcy) / ph / var[:, 1],
            torch.log(tw / pw) / var[:, 2],
            torch.log(th / ph) / var[:, 3],
        ], -1)
    else:  # decode_center_size
        t = target if target.dim() != 2 else target[:, None, :]
        cx = var[:, 0] * t[..., 0] * pw + pcx
        cy = var[:, 1] * t[..., 1] * ph + pcy
        w = torch.exp(var[:, 2] * t[..., 2]) * pw
        h = torch.exp(var[:, 3] * t[..., 3]) * ph
        out = torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                           cx + 0.5 * w, cy + 0.5 * h], -1)
    ctx.set_output('OutputBox', out)


@register('prior_box')
def _prior_box(ctx):
    """Boxes, Variances [H, W, P, 4] of the feature map Input's H x W cells
    (NCHW) over the Image: for each min size, one box an aspect ratio
    (with its flips), then one box a max size."""
    x, image = ctx.input('Input'), ctx.input('Image')
    min_sizes = ctx.attr('min_sizes')
    max_sizes = ctx.attr('max_sizes', [])
    aspect_ratios = list(ctx.attr('aspect_ratios', [1.0]))
    if ctx.attr('flip', False):
        aspect_ratios = aspect_ratios + [1.0 / a for a in aspect_ratios
                                         if a != 1.0]
    variances = ctx.attr('variances', [0.1, 0.1, 0.2, 0.2])
    offset = ctx.attr('offset', 0.5)
    fh, fw = x.shape[2], x.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    steps = ctx.attr('steps', [0.0, 0.0])
    step_h = steps[1] or ih / fh
    step_w = steps[0] or iw / fw
    f64 = dict(dtype=torch.float64, device=ctx.device)
    cx = (torch.arange(fw, **f64) + offset) * step_w / iw
    cy = (torch.arange(fh, **f64) + offset) * step_h / ih
    cyg, cxg = torch.meshgrid(cy, cx, indexing='ij')

    def box(bw, bh):
        return torch.stack([cxg - bw, cyg - bh, cxg + bw, cyg + bh], -1)
    boxes = []
    for ms in min_sizes:
        for ar in aspect_ratios:
            boxes.append(box(ms * math.sqrt(ar) / iw / 2.0,
                             ms / math.sqrt(ar) / ih / 2.0))
        for mx in max_sizes:
            s = math.sqrt(ms * mx)
            boxes.append(box(s / iw / 2.0, s / ih / 2.0))
    out = torch.stack(boxes, 2)
    if ctx.attr('clip', False):
        out = torch.clamp(out, 0.0, 1.0)
    shape = (fh, fw, len(boxes))
    ctx.set_output('Boxes', out.float())
    ctx.set_output('Variances', torch.stack(
        [torch.full(shape, float(v), dtype=torch.float32,
                    device=ctx.device) for v in variances], -1))


@register('bipartite_match')
def _bipartite_match(ctx):
    """Greedy bipartite matching of DistMat [B, M, N] (gt rows against
    priors; padded gt rows all zero): M times, the largest remaining
    entry, if above 0, matches its row and column, which then drop out.
    ColToRowMatchIndices [B, N] (the gt row or -1), ColToRowMatchDist
    [B, N]; per_prediction then gives an unmatched prior its best row
    where that overlap exceeds dist_threshold."""
    dist = ctx.input('DistMat').float()
    b, m, n = dist.shape
    rows = torch.arange(m, device=dist.device)[None, :, None]
    cols = torch.arange(n, device=dist.device)[None, None, :]
    remaining = dist
    idx = torch.full((b, n), -1, dtype=torch.int64, device=dist.device)
    dval = torch.zeros((b, n), dtype=torch.float32, device=dist.device)
    for _ in range(m):
        flat = torch.argmax(remaining.reshape(b, m * n), 1)
        r, c = flat // n, flat % n
        best = remaining.reshape(b, m * n).gather(1, flat[:, None])[:, 0]
        do = best > 0.0
        at = do[:, None] & (cols[0] == c[:, None])
        idx = torch.where(at, r[:, None], idx)
        dval = torch.where(at, best[:, None], dval)
        gone = do[:, None, None] & ((rows == r[:, None, None]) |
                                    (cols == c[:, None, None]))
        remaining = torch.where(gone, torch.full((), -1.0,
                                                 device=dist.device),
                                remaining)
    if ctx.attr('match_type', 'bipartite') == 'per_prediction':
        best_val, best_gt = amax(dist, (1,)), torch.argmax(dist, 1)
        extra = (idx < 0) & (best_val > ctx.attr('dist_threshold', 0.5))
        idx = torch.where(extra, best_gt, idx)
        dval = torch.where(extra, best_val, dval)
    ctx.set_output('ColToRowMatchIndices',
                   idx.to(ctx.out_dtype('ColToRowMatchIndices', 'int64')))
    ctx.set_output('ColToRowMatchDist', dval)


@register('target_assign')
def _target_assign(ctx):
    """Out [B, N, K]: X [B, M, K]'s row MatchIndices [B, N] names, or
    mismatch_value where it is negative; OutWeight [B, N, 1]: 1 where
    matched."""
    x = ctx.input('X')
    match = ctx.input('MatchIndices')
    b, n, k = x.shape[0], match.shape[1], x.shape[2]
    safe = torch.clamp(match, min=0).long()
    out = x.gather(1, safe[:, :, None].expand(b, n, k))
    matched = (match >= 0)[:, :, None]
    out = torch.where(matched, out, torch.full(
        (), ctx.attr('mismatch_value', 0), dtype=x.dtype, device=x.device))
    ctx.set_output('Out', out)
    ctx.set_output('OutWeight', matched.float())


@register('mine_hard_examples')
def _mine_hard_examples(ctx):
    """Hard-negative mining (max_negative): the negatives of highest
    ClsLoss [B, N], neg_pos_ratio of them a positive (at most the
    negatives), stay -1 in UpdatedMatchIndices and the rest become -2;
    NegIndicesMask marks the kept ones. Ranks are a stable sort's."""
    cls_loss = ctx.input('ClsLoss')
    match = ctx.input('MatchIndices')
    n = cls_loss.shape[1]
    is_pos = match >= 0
    num_pos = is_pos.sum(1)
    num_neg = torch.minimum(
        (num_pos * ctx.attr('neg_pos_ratio', 3.0)).to(torch.int32),
        (n - num_pos).to(torch.int32))
    neg_loss = torch.where(is_pos, torch.full((), float('-inf'),
                                              dtype=cls_loss.dtype,
                                              device=cls_loss.device),
                           cls_loss)
    order = torch.argsort(-neg_loss, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    keep_neg = (~is_pos) & (rank < num_neg[:, None])
    out = ctx.out_dtype('UpdatedMatchIndices', 'int64')
    updated = torch.where(is_pos, match.to(out), torch.where(
        keep_neg, torch.full((), -1, dtype=out, device=match.device),
        torch.full((), -2, dtype=out, device=match.device)))
    ctx.set_output('UpdatedMatchIndices', updated)
    ctx.set_output('NegIndicesMask',
                   keep_neg.to(ctx.out_dtype('NegIndicesMask', 'int64')))


def _nms_iou(bb):
    """[..., K, K] IoU of K boxes [..., K, 4] with each other (areas of
    inverted boxes taken as 0)."""
    area = _at_least(bb[..., 2] - bb[..., 0], 0.0) * \
        _at_least(bb[..., 3] - bb[..., 1], 0.0)
    lt = maximum(bb[..., :, None, :2], bb[..., None, :, :2])
    rb = minimum(bb[..., :, None, 2:], bb[..., None, :, 2:])
    wh = _at_least(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / _at_least(area[..., :, None] + area[..., None, :] -
                             inter, 1e-10)


@register('multiclass_nms')
def _multiclass_nms(ctx):
    """Per-class NMS and a top-k across classes (multiclass_nms_op.cc).
    BBoxes [B, N, 4], Scores [B, C, N] -> Out [B, keep_top_k, 6] rows
    (label, score, x1, y1, x2, y2), label -1 on padding. Each class keeps
    its nms_top_k best boxes; in their order a kept box above the score
    threshold suppresses every later one whose IoU with it exceeds
    nms_threshold (all classes of all examples at once, k steps)."""
    boxes = ctx.input('BBoxes')
    scores = ctx.input('Scores')
    score_threshold = ctx.attr('score_threshold', 0.0)
    nms_threshold = ctx.attr('nms_threshold', 0.3)
    keep_top_k = ctx.attr('keep_top_k', 16)
    background = ctx.attr('background_label', 0)
    b, c, n = scores.shape
    k = min(ctx.attr('nms_top_k', 64), n)
    dev = scores.device
    top_s, top_i = top_k(scores, k)                           # [B, C, k]
    top_b = boxes[:, None].expand(b, c, n, 4).gather(
        2, top_i[..., None].expand(b, c, k, 4))              # [B, C, k, 4]
    mat = _nms_iou(top_b)                                     # [B, C, k, k]
    later = torch.arange(k, device=dev)
    keep = torch.ones((b, c, k), dtype=torch.bool, device=dev)
    for i in range(k):
        alive = keep[..., i] & (top_s[..., i] > score_threshold)
        sup = (mat[..., i, :] > nms_threshold) & (later > i)
        keep = torch.where(alive[..., None], keep & ~sup, keep)
    keep = keep & (top_s > score_threshold)
    minus = torch.full((), -1.0, dtype=top_s.dtype, device=dev)
    cls_s = torch.where(keep, top_s, minus)
    labels = torch.arange(c, device=dev)[:, None].expand(c, k).reshape(-1)
    flat_s = torch.where(labels == background, minus, cls_s.reshape(b, -1))
    flat_b = top_b.reshape(b, c * k, 4)
    sel_s, sel_i = top_k(flat_s, min(keep_top_k, c * k))
    sel_b = flat_b.gather(1, sel_i[..., None].expand(*sel_i.shape, 4))
    sel_l = torch.where(sel_s > 0, labels[sel_i],
                        torch.full((), -1, dtype=labels.dtype, device=dev))
    ctx.set_output('Out', torch.cat(
        [sel_l[..., None].to(boxes.dtype), sel_s[..., None], sel_b], -1))


@register('match_pos_mask')
def _match_pos_mask(ctx):
    ctx.set_output('Out', (ctx.input('MatchIndices') >= 0).float())
