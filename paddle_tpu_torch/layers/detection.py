"""Detection layers (reference: paddle_tpu layers/detection.py;
fluid/layers/detection.py, the SSD family), over the ops of
ops/detection_ops.py.

Ground-truth boxes and labels are padded [B, M_gt, ...] arrays whose
padding rows have zero IoU with everything, so the matching ops need no
ragged sequences.
"""

from .helper import LayerHelper

__all__ = ['box_coder', 'iou_similarity', 'prior_box', 'bipartite_match',
           'target_assign', 'mine_hard_examples', 'multi_box_head',
           'ssd_loss', 'detection_output', 'multiclass_nms']


def box_coder(prior_box, prior_box_var, target_box,
              code_type='encode_center_size', box_normalized=True,
              name=None):
    helper = LayerHelper('box_coder', name=name)
    out = helper.create_variable_for_type_inference(target_box.dtype)
    inputs = {'PriorBox': [prior_box], 'TargetBox': [target_box]}
    if prior_box_var is not None:
        inputs['PriorBoxVar'] = [prior_box_var]
    helper.append_op(type='box_coder',
                     inputs=inputs,
                     outputs={'OutputBox': [out]},
                     attrs={'code_type': code_type,
                            'box_normalized': box_normalized})
    return out


def iou_similarity(x, y, name=None):
    helper = LayerHelper('iou_similarity', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='iou_similarity', inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [out]})
    return out


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None):
    helper = LayerHelper('prior_box', name=name)
    boxes = helper.create_variable_for_type_inference(input.dtype)
    variances = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type='prior_box',
                     inputs={'Input': [input], 'Image': [image]},
                     outputs={'Boxes': [boxes], 'Variances': [variances]},
                     attrs={'min_sizes': list(min_sizes),
                            'max_sizes': list(max_sizes or []),
                            'aspect_ratios': list(aspect_ratios),
                            'variances': list(variance), 'flip': flip,
                            'clip': clip, 'steps': list(steps),
                            'offset': offset})
    return boxes, variances


def bipartite_match(dist_matrix, match_type='bipartite',
                    dist_threshold=0.5, name=None):
    """dist_matrix: [B, M_gt, N_prior] similarity. Returns
    (match_indices [B, N] int64, match_dist [B, N] float32)."""
    helper = LayerHelper('bipartite_match', name=name)
    idx = helper.create_variable_for_type_inference('int64')
    dist = helper.create_variable_for_type_inference('float32')
    if dist_matrix.shape is not None:
        idx.shape = (dist_matrix.shape[0], dist_matrix.shape[2])
        dist.shape = idx.shape
    helper.append_op(type='bipartite_match',
                     inputs={'DistMat': [dist_matrix]},
                     outputs={'ColToRowMatchIndices': [idx],
                              'ColToRowMatchDist': [dist]},
                     attrs={'match_type': match_type,
                            'dist_threshold': dist_threshold})
    return idx, dist


def target_assign(input, match_indices, mismatch_value=0, name=None):
    """Gather per-prior targets from per-gt values via match indices.
    input: [B, M, K]; match_indices: [B, N]. Returns (out [B, N, K],
    out_weight [B, N, 1])."""
    helper = LayerHelper('target_assign', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    weight = helper.create_variable_for_type_inference('float32')
    if input.shape is not None and match_indices.shape is not None:
        out.shape = (input.shape[0], match_indices.shape[1],
                     input.shape[2])
        weight.shape = (input.shape[0], match_indices.shape[1], 1)
    helper.append_op(type='target_assign',
                     inputs={'X': [input],
                             'MatchIndices': [match_indices]},
                     outputs={'Out': [out], 'OutWeight': [weight]},
                     attrs={'mismatch_value': mismatch_value})
    return out, weight


def mine_hard_examples(cls_loss, match_indices, neg_pos_ratio=3.0,
                       name=None):
    """Hard-negative mining: keeps the highest-loss negatives at
    neg_pos_ratio per positive. Returns (updated_match_indices,
    neg_mask)."""
    helper = LayerHelper('mine_hard_examples', name=name)
    updated = helper.create_variable_for_type_inference('int64')
    neg = helper.create_variable_for_type_inference('int64')
    if match_indices.shape is not None:
        updated.shape = tuple(match_indices.shape)
        neg.shape = tuple(match_indices.shape)
    helper.append_op(type='mine_hard_examples',
                     inputs={'ClsLoss': [cls_loss],
                             'MatchIndices': [match_indices]},
                     outputs={'UpdatedMatchIndices': [updated],
                              'NegIndicesMask': [neg]},
                     attrs={'neg_pos_ratio': neg_pos_ratio})
    return updated, neg


def multiclass_nms(bboxes, scores, score_threshold=0.0, nms_top_k=64,
                   keep_top_k=16, nms_threshold=0.3, background_label=0,
                   name=None):
    """bboxes: [B, N, 4]; scores: [B, C, N]. Returns [B, keep_top_k, 6]
    rows of (label, score, x1, y1, x2, y2), label -1 padding."""
    helper = LayerHelper('multiclass_nms', name=name)
    out = helper.create_variable_for_type_inference(bboxes.dtype)
    if bboxes.shape is not None:
        out.shape = (bboxes.shape[0], keep_top_k, 6)
    helper.append_op(type='multiclass_nms',
                     inputs={'BBoxes': [bboxes], 'Scores': [scores]},
                     outputs={'Out': [out]},
                     attrs={'score_threshold': score_threshold,
                            'nms_top_k': nms_top_k,
                            'keep_top_k': keep_top_k,
                            'nms_threshold': nms_threshold,
                            'background_label': background_label})
    return out


def multi_box_head(inputs, image, num_classes, min_sizes, max_sizes=None,
                   aspect_ratios=None, base_size=None, steps=None,
                   flip=True, clip=False, kernel_size=1, pad=0,
                   name=None):
    """SSD head over multiple feature maps (detection.py multi_box_head):
    per-map 3x3/1x1 convs produce loc + conf, concatenated over all
    priors. Returns (mbox_locs [B, N, 4], mbox_confs [B, N, C],
    prior_boxes [N, 4], prior_variances [N, 4])."""
    from .. import layers as L
    max_sizes = max_sizes or [None] * len(inputs)
    aspect_ratios = aspect_ratios or [[1.0]] * len(inputs)
    locs, confs, priors, prior_vars = [], [], [], []
    for i, x in enumerate(inputs):
        mins = min_sizes[i] if isinstance(min_sizes[i], (list, tuple)) \
            else [min_sizes[i]]
        maxs = max_sizes[i]
        maxs = [] if maxs is None else (
            maxs if isinstance(maxs, (list, tuple)) else [maxs])
        ars = aspect_ratios[i]
        step_i = steps[i] if steps else (0.0, 0.0)
        if not isinstance(step_i, (list, tuple)):
            step_i = (step_i, step_i)  # per-map scalar convention
        box, var = prior_box(x, image, mins, maxs, ars, flip=flip,
                             clip=clip, steps=step_i)
        num_priors_per_cell = (len(mins) * (len(ars) +
                               (len([a for a in ars if a != 1.0])
                                if flip else 0)) + len(mins) * len(maxs))
        loc = L.conv2d(input=x, num_filters=num_priors_per_cell * 4,
                       filter_size=kernel_size, padding=pad)
        conf = L.conv2d(input=x,
                        num_filters=num_priors_per_cell * num_classes,
                        filter_size=kernel_size, padding=pad)
        # NCHW -> [B, H*W*priors, 4 / C]
        loc = L.transpose(loc, perm=[0, 2, 3, 1])
        loc = L.reshape(loc, shape=[0, -1, 4])  # 0 = copy batch dim
        conf = L.transpose(conf, perm=[0, 2, 3, 1])
        conf = L.reshape(conf, shape=[0, -1, num_classes])
        locs.append(loc)
        confs.append(conf)
        priors.append(L.reshape(box, shape=[-1, 4]))
        prior_vars.append(L.reshape(var, shape=[-1, 4]))
    mbox_locs = L.concat(locs, axis=1)
    mbox_confs = L.concat(confs, axis=1)
    prior_boxes = L.concat(priors, axis=0)
    prior_variances = L.concat(prior_vars, axis=0)
    return mbox_locs, mbox_confs, prior_boxes, prior_variances


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, loc_loss_weight=1.0, conf_loss_weight=1.0,
             match_type='per_prediction', normalize=True, name=None):
    """SSD multibox loss (detection.py ssd_loss): match priors to gt,
    smooth-l1 localization loss on positives + softmax confidence loss on
    positives and mined hard negatives. location: [B, N, 4];
    confidence: [B, N, C]; gt_box: [B, M, 4]; gt_label: [B, M] int64;
    prior_box: [N, 4]. Returns per-example loss [B, 1]."""
    from .. import layers as L

    iou = iou_similarity(gt_box, prior_box)       # [B, M, N]
    match_idx, _ = bipartite_match(iou, match_type, overlap_threshold)

    # conf loss against assigned labels (background where unmatched)
    lbl_target, _ = target_assign(
        L.unsqueeze(gt_label, axes=[2]), match_idx,
        mismatch_value=background_label)          # [B, N, 1]
    conf_loss_all = L.softmax_with_cross_entropy(
        logits=confidence, label=lbl_target)      # [B, N, 1]
    conf_loss_2d = L.reshape(conf_loss_all, shape=[0, -1])
    updated_idx, neg_mask = mine_hard_examples(conf_loss_2d, match_idx,
                                               neg_pos_ratio)
    # positives: updated match >= 0; kept hard negatives: miner mask
    pos = pos_mask(updated_idx)                   # [B, N] float32
    neg = L.cast(neg_mask, 'float32')
    conf_weight = L.elementwise_add(x=pos, y=neg)
    conf_loss = L.reduce_sum(
        L.elementwise_mul(x=conf_loss_2d, y=conf_weight), dim=1,
        keep_dim=True)

    # loc loss on positives: encode assigned gt boxes against each prior
    loc_target, _ = target_assign(gt_box, match_idx)   # [B, N, 4] corners
    enc_target = box_coder(prior_box, prior_box_var, loc_target,
                           code_type='encode_aligned')
    loc_l = L.smooth_l1(x=location, y=enc_target, last_dim_only=True)
    loc_loss = L.reduce_sum(
        L.elementwise_mul(x=loc_l, y=pos), dim=1, keep_dim=True)

    total = L.elementwise_add(
        x=L.scale(loc_loss, scale=loc_loss_weight),
        y=L.scale(conf_loss, scale=conf_loss_weight))
    if normalize:
        denom = L.reduce_sum(pos, dim=1, keep_dim=True)
        denom = L.clip(denom, min=1.0, max=1e10)
        total = L.elementwise_div(x=total, y=denom)
    return total


def pos_mask(match_indices, name=None):
    """float32 mask of priors with a non-negative match index."""
    helper = LayerHelper('pos_mask', name=name)
    out = helper.create_variable_for_type_inference('float32')
    if match_indices.shape is not None:
        out.shape = tuple(match_indices.shape)
    helper.append_op(type='match_pos_mask',
                     inputs={'MatchIndices': [match_indices]},
                     outputs={'Out': [out]}, attrs={})
    return out


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=64,
                     keep_top_k=16, score_threshold=0.01, name=None):
    """Decode predicted offsets with priors and run multiclass NMS
    (detection.py detection_output). loc: [B, N, 4]; scores: [B, N, C]
    softmax probs. Returns [B, keep_top_k, 6]."""
    from .. import layers as L
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type='decode_center_size')
    scores_t = L.transpose(scores, perm=[0, 2, 1])   # [B, C, N]
    return multiclass_nms(decoded, scores_t,
                          score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold,
                          background_label=background_label)
