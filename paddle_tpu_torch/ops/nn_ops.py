"""NN ops the training paths run: embedding lookup, dropout, the two
softmax cross-entropy losses, cross_entropy over probabilities, accuracy,
square_error_cost and sigmoid_cross_entropy_with_logits (reference:
paddle_tpu ops/nn_ops.py; fluid's lookup_table_op, dropout_op,
softmax_with_cross_entropy_op, cross_entropy_op, accuracy_op,
square_error_cost, sigmoid_cross_entropy_with_logits_op)."""

import torch

from ..core.backward import SPARSE_SEED_PREFIX
from ..core.registry import op_key, register
from .kernels import random_bits
from . import pointwise


@register('lookup_table')
def _lookup_table(ctx):
    """Embedding lookup (lookup_table_op.cc). Rows looked up at
    padding_idx give 0 and pass no gradient, as in the reference (the
    output is masked after the gather).

    Row-sparse gradients (reference: paddle_tpu ops/nn_ops.py
    lookup_table): when the executor planted a zero row seed for this
    lookup's output (an is_sparse table under an update that takes row
    gradients, core/backward.py), the table is no autograd leaf and the
    seed, [n_ids, dim], is added to the gathered rows: the seed's gradient
    is the row gradient, and no [vocab, dim] gradient is made. The padding
    mask applies after the seed, so padding rows' row gradients are 0 as
    the dense gradient's rows are."""
    w = ctx.input('W')
    ids = ctx.input('Ids')
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    seed = ctx.env.get(SPARSE_SEED_PREFIX + ctx.op.output('Out'))
    out = torch.nn.functional.embedding(ids.long(), w)
    if seed is not None:
        out = out + seed.reshape(out.shape)
    padding_idx = ctx.attr('padding_idx', -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    ctx.set_output('Out', out)


@register('dropout')
def _dropout(ctx):
    """dropout_op.cc semantics. downgrade_in_infer (the default): train
    out = x * mask, test out = x * (1 - p); upscale_in_train: train
    out = x * mask / (1 - p), test out = x. In training the keep bits are
    the counter-based ones of kernels/random_bits.py, a pure function of
    (program seed, step, op index, element index), the step read on the
    device: one fused pass draws and applies them, and the backward draws
    them again, so no mask is made. The Mask output is written only where
    something reads it (a later op, a fetch or the scope), with the same
    bits, in x's dtype."""
    x = ctx.input('X')
    p = ctx.attr('dropout_prob', 0.5)
    impl = ctx.attr('dropout_implementation', 'downgrade_in_infer')
    if ctx.attr('is_test', False) or ctx.is_test:
        out = x * (1.0 - p) if impl == 'downgrade_in_infer' else x
        ctx.set_output('Mask', torch.ones_like(x))
        ctx.set_output('Out', out)
        return
    key, step = op_key(ctx.seed, ctx.op_index), ctx.step_tensor()
    mode = 'mul_div' if impl == 'upscale_in_train' and p < 1.0 else 'mul'
    ctx.set_output('Out', random_bits.DropoutApply.apply(x, mode, 1.0 - p,
                                                         key, step))
    if ctx.output_read('Mask'):
        ctx.set_output('Mask', random_bits.keep_mask(
            x.shape, 1.0 - p, key, step, x.device, x.dtype))


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


@register('cross_entropy')
def _cross_entropy(ctx):
    """-log(p[label] + 1e-8) over probabilities X; soft labels give
    -Σ label·log(X + 1e-8) (cross_entropy_op.cc)."""
    x = ctx.input('X')
    label = ctx.input('Label')
    eps = 1e-8
    if ctx.attr('soft_label', False):
        loss = -(label * torch.log(x + eps)).sum(dim=-1, keepdim=True)
    else:
        if label.dim() == x.dim() and label.shape[-1] == 1:
            label = label.squeeze(-1)
        loss = -torch.log(x.gather(-1, label.long().unsqueeze(-1)) + eps)
    ctx.set_output('Y', loss)


@register('accuracy')
def _accuracy(ctx):
    """The share of rows whose top-k indices hold the label
    (accuracy_op.cc), with the int32 Correct and Total counts."""
    indices = ctx.input('Indices')
    label = ctx.input('Label')
    if not (label.dim() == 2 and label.shape[-1] == 1):
        label = label.unsqueeze(-1)
    correct = (indices == label).any(dim=-1)
    ctx.set_output('Accuracy', correct.float().mean().reshape(1))
    ctx.set_output('Correct', correct.sum(dtype=torch.int32).reshape(1))
    # a fill on the device: no host-to-device copy, so a graph can hold it
    ctx.set_output('Total', torch.full((1,), indices.shape[0],
                                       dtype=torch.int32,
                                       device=indices.device))


@register('square_error_cost')
def _square_error_cost(ctx):
    """(x - y)², element by element (fit_a_line's loss)."""
    ctx.set_output('Out', torch.square(ctx.input('X') - ctx.input('Y')))


@register('sigmoid_cross_entropy_with_logits')
def _sigmoid_xent(ctx):
    """max(x, 0) - x * label + log1p(exp(-|x|)), element by element, with
    jax's gradients of the maximum (halves at x = 0) and of |x| (+1 at
    0)."""
    x = ctx.input('X')
    label = ctx.input('Label')
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    ctx.set_output('Out', pointwise.maximum(x, zero) - x * label +
                   torch.log1p(torch.exp(-pointwise.abs(x))))
