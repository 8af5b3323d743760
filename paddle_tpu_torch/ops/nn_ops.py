"""NN ops the training path runs: embedding lookup, dropout and the two
softmax cross-entropy losses (reference: paddle_tpu ops/nn_ops.py; fluid's
lookup_table_op, dropout_op, softmax_with_cross_entropy_op)."""

import torch

from ..core.registry import register


@register('lookup_table')
def _lookup_table(ctx):
    """Dense embedding lookup; its gradient is a dense [vocab, dim] table
    gradient. Rows looked up at padding_idx give 0 and pass no gradient,
    as in the reference (the output is masked after the gather)."""
    w = ctx.input('W')
    ids = ctx.input('Ids')
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    out = torch.nn.functional.embedding(ids.long(), w)
    padding_idx = ctx.attr('padding_idx', -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    ctx.set_output('Out', out)


def keep_mask(ctx, shape, keep, device):
    """Bernoulli(keep) bool mask from the op's per-step generator."""
    u = torch.rand(shape, generator=ctx.step_generator(), device=device)
    return u < keep


@register('dropout')
def _dropout(ctx):
    """dropout_op.cc semantics. downgrade_in_infer (the default): train
    out = x * mask, test out = x * (1 - p); upscale_in_train: train
    out = x * mask / (1 - p), test out = x. The mask is written by hand:
    torch's dropout always scales in training."""
    x = ctx.input('X')
    p = ctx.attr('dropout_prob', 0.5)
    impl = ctx.attr('dropout_implementation', 'downgrade_in_infer')
    if ctx.attr('is_test', False) or ctx.is_test:
        out = x * (1.0 - p) if impl == 'downgrade_in_infer' else x
        mask = torch.ones_like(x)
    else:
        mask = keep_mask(ctx, x.shape, 1.0 - p, x.device).to(x.dtype)
        out = x * mask
        if impl == 'upscale_in_train' and p < 1.0:
            out = out / (1.0 - p)
    ctx.set_output('Mask', mask)
    ctx.set_output('Out', out)


def _ls_ce_rows(logits, label):
    """(lse, logit at the label, mean logit) per row, in fp32."""
    m = logits.amax(dim=-1).float()
    se = torch.exp(logits.float() - m.unsqueeze(-1)).sum(dim=-1)
    lse = m + torch.log(se)
    x_y = logits.gather(-1, label.unsqueeze(-1)).squeeze(-1).float()
    x_mean = logits.float().mean(dim=-1)
    return lse, x_y, x_mean


class _LabelSmoothedCE(torch.autograd.Function):
    """loss = (1 - eps)·(lse - x[y]) + eps·(lse - mean(x)), the JAX
    package's _ls_ce_fused: the backward keeps only (logits, label, lse)
    and recomputes softmax from them, so no [.., V] log-prob tensor is
    saved across the step. The gradient has the logits' dtype."""

    @staticmethod
    def forward(ctx, logits, label, eps):
        lse, x_y, x_mean = _ls_ce_rows(logits, label)
        ctx.save_for_backward(logits, label, lse)
        ctx.eps = eps
        return (1.0 - eps) * (lse - x_y) + eps * (lse - x_mean)

    @staticmethod
    def backward(ctx, g):
        logits, label, lse = ctx.saved_tensors
        eps = ctx.eps
        # d loss / d x_j = p_j - (1-eps)·1[j=y] - eps/V
        dx = torch.exp(logits.float() - lse.unsqueeze(-1))
        dx.scatter_add_(-1, label.unsqueeze(-1),
                        torch.full(label.shape + (1,), -(1.0 - eps),
                                   device=dx.device))
        dx = dx - eps / logits.shape[-1]
        return (g.unsqueeze(-1).float() * dx).to(logits.dtype), None, None


def label_smoothed_ce(logits, label, eps):
    return _LabelSmoothedCE.apply(logits, label.long(), float(eps))


@register('label_smoothed_cross_entropy')
def _label_smoothed_xent(ctx):
    """Fused label-smoothed softmax CE over hard int labels."""
    logits = ctx.input('Logits')
    label = ctx.input('Label')
    if label.dim() == logits.dim():
        label = label.squeeze(-1)
    loss = label_smoothed_ce(logits, label, ctx.attr('epsilon', 0.1))
    ctx.set_output('Loss', loss.unsqueeze(-1))


@register('softmax_with_cross_entropy')
def _softmax_xent(ctx):
    logits = ctx.input('Logits')
    label = ctx.input('Label')
    if ctx.attr('soft_label', False):
        log_probs = torch.log_softmax(logits, dim=-1)
        if ctx.output_read('Softmax'):
            ctx.set_output('Softmax', torch.exp(log_probs))
        ctx.set_output('Loss', -(label * log_probs).sum(dim=-1,
                                                        keepdim=True))
        return
    if label.dim() == logits.dim() and label.shape[-1] == 1:
        label = label.squeeze(-1)
    # hard labels: the eps = 0 point of the fused label-smoothed CE; both
    # outputs keep the logits' dtype
    loss = label_smoothed_ce(logits, label, 0.0).unsqueeze(-1) \
        .to(logits.dtype)
    ignore_index = ctx.attr('ignore_index', -100)
    if ignore_index is not None and ignore_index >= 0:
        loss = loss * (label.unsqueeze(-1) != ignore_index).to(loss.dtype)
    if ctx.output_read('Softmax'):
        ctx.set_output('Softmax', torch.softmax(logits.float(), dim=-1)
                       .to(logits.dtype))
    ctx.set_output('Loss', loss)
