"""NN ops: embedding lookup, dropout, the two softmax cross-entropy
losses, cross_entropy over probabilities, accuracy, square_error_cost,
sigmoid_cross_entropy_with_logits, auc, nce, l2_normalize, maxout,
im2sequence, label_smooth, pixel_shuffle, bilinear_tensor_product and the
losses smooth_l1, huber, rank, margin_rank, hinge, log and modified_huber
(reference: paddle_tpu ops/nn_ops.py; fluid's lookup_table_op, dropout_op,
softmax_with_cross_entropy_op, cross_entropy_op, accuracy_op, auc_op,
nce_op, ... of the same names). Each is the reference's expression; where
a maximum, an abs or a select meets a tie or 0, the gradient is jax's
(ops/pointwise.py)."""

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


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _const(v, x):
    """The number v as a 0-dim tensor of x's dtype: jax rounds a Python
    number to the array's dtype (bf16 too), torch would keep it in fp32
    beside a bf16 tensor."""
    return torch.full((), v, dtype=x.dtype, device=x.device)


@register('smooth_l1_loss')
def _smooth_l1(ctx):
    """d = (x - y) [* InsideWeight]; 0.5 sigma^2 d^2 where |d| < 1 /
    sigma^2, else |d| - 0.5 / sigma^2 [* OutsideWeight]; Out sums every
    axis but the first ([n, 1]), or the last alone with last_dim_only;
    Diff is d."""
    sigma = ctx.attr('sigma', 1.0)
    sigma2 = sigma * sigma
    diff = ctx.input('X') - ctx.input('Y')
    if ctx.has_input('InsideWeight'):
        diff = diff * ctx.input('InsideWeight')
    absd = pointwise.abs(diff)
    loss = torch.where(absd < 1.0 / sigma2,
                       0.5 * sigma2 * torch.square(diff),
                       absd - 0.5 / sigma2)
    if ctx.has_input('OutsideWeight'):
        loss = loss * ctx.input('OutsideWeight')
    ctx.set_output('Diff', diff)
    if ctx.attr('last_dim_only', False):
        out = loss.sum(-1)
    elif loss.dim() > 1:
        out = loss.sum(tuple(range(1, loss.dim()))).unsqueeze(-1)
    else:
        out = loss
    ctx.set_output('Out', out)


@register('auc')
def _auc(ctx):
    """The batch's rank AUC (auc_op.cc's role, no streaming state):
    P(score of a positive > score of a negative), a tie counting 1/2, over
    every pair, O(b^2)."""
    probs = ctx.input('Predict')
    label = ctx.input('Label').reshape(-1)
    score = probs[:, 1] if probs.dim() == 2 and probs.shape[1] == 2 \
        else probs.reshape(-1)
    pos = label.float()
    neg = 1.0 - pos
    diff = score[:, None] - score[None, :]
    wins = (diff > 0).float() + 0.5 * (diff == 0)
    num = torch.sum(wins * pos[:, None] * neg[None, :])
    den = torch.sum(pos) * torch.sum(neg)
    ctx.set_output('AUC', (num / torch.clamp(den, min=1.0)).reshape(1))


@register('nce', host_bound=True)
def _nce(ctx):
    """NCE with uniform negative sampling (nce_op.cc), the reference's
    sampled form: -log sigmoid(s_pos) - sum_k log sigmoid(-s_neg_k). The
    num_neg_samples negative classes are drawn on the host from the op's
    generator keyed by the step, as the random ops draw (they differ from
    the reference's draws by design), so the op is host-bound."""
    x = ctx.input('Input')
    w = ctx.input('Weight')
    b = ctx.input('Bias').reshape(-1)
    ids = ctx.input('Label').reshape(-1).long()
    s_pos = torch.sum(x * w[ids], dim=-1) + b[ids]
    neg = torch.randint(0, ctx.attr('num_total_classes'),
                        (ctx.attr('num_neg_samples', 10),),
                        generator=ctx.generator(step=True)).to(x.device)
    s_neg = x @ w[neg].T + b[neg]
    loss = -torch.nn.functional.logsigmoid(s_pos) - torch.sum(
        torch.nn.functional.logsigmoid(-s_neg), dim=-1)
    ctx.set_output('Cost', loss[:, None])


@register('l2_normalize')
def _l2_normalize(ctx):
    """x / max(||x||, epsilon) along ``axis``; Norm is ||x||."""
    x = ctx.input('X')
    norm = torch.sqrt(torch.sum(torch.square(x), dim=ctx.attr('axis', -1),
                                keepdim=True))
    eps = torch.full((), ctx.attr('epsilon', 1e-12), dtype=x.dtype,
                     device=x.device)
    ctx.set_output('Out', x / pointwise.maximum(norm, eps))
    ctx.set_output('Norm', norm)


@register('maxout')
def _maxout(ctx):
    """NCHW: the largest of each ``groups`` consecutive channels (a tie
    shares the gradient, as jax's max)."""
    x = ctx.input('X')
    groups = ctx.attr('groups')
    n, c, h, w = x.shape
    ctx.set_output('Out', pointwise.amax(
        x.reshape(n, c // groups, groups, h, w), dim=(2,)))


@register('im2sequence')
def _im2sequence(ctx):
    """im2sequence_op.cc: the NCHW input padded (top, left, bottom, right)
    and cut into kernel-sized patches, one row a patch, [n * oh * ow,
    c * kh * kw], the patches of an image in row-major order and each
    patch channel-major. The reference takes the patches with
    conv_general_dilated_patches, a convolution with one-hot filters, so
    each value of a patch is itself plus 0 times the patch's other values
    of its channel: NaN where another one is not finite, and +0 for -0.
    Here the same values come from strided views of x (a copy, no
    multiply)."""
    x = ctx.input('X')
    kh, kw = ctx.attr('kernels')
    sh, sw = ctx.attr('strides', [1, 1])
    ph0, pw0, ph1, pw1 = ctx.attr('paddings', [0, 0, 0, 0])
    x = torch.nn.functional.pad(x, [pw0, pw1, ph0, ph1])
    # [n, c, oh, ow, kh, kw], a view of x
    patches = x.unfold(2, kh, sh).unfold(3, kw, sw)
    with torch.no_grad():
        bad = ~torch.isfinite(patches)
        others = bad.sum((4, 5), keepdim=True) - bad.to(torch.int64) > 0
        nan = torch.where(others, torch.full((), float('nan'),
                                             dtype=x.dtype, device=x.device),
                          _zero(x))
    patches = (patches + nan).permute(0, 2, 3, 1, 4, 5)
    ctx.set_output('Out', patches.reshape(-1, x.shape[1] * kh * kw))


@register('label_smooth')
def _label_smooth(ctx):
    """(1 - epsilon) x + epsilon * PriorDist, or epsilon / k without one;
    the constants in x's dtype, as jax takes a Python number beside a bf16
    array."""
    x = ctx.input('X')
    eps = ctx.attr('epsilon', 0.1)
    if ctx.has_input('PriorDist'):
        out = _const(1.0 - eps, x) * x + \
            _const(eps, x) * ctx.input('PriorDist')
    else:
        out = _const(1.0 - eps, x) * x + _const(eps / x.shape[-1], x)
    ctx.set_output('Out', out)


@register('huber_loss')
def _huber_loss(ctx):
    """r = y - x; 0.5 r^2 where |r| <= delta, else delta (|r| - 0.5
    delta); Residual is r."""
    delta = ctx.attr('delta', 1.0)
    r = ctx.input('Y') - ctx.input('X')
    absr = pointwise.abs(r)
    ctx.set_output('Residual', r)
    ctx.set_output('Out', torch.where(absr <= delta, 0.5 * torch.square(r),
                                      delta * (absr - 0.5 * delta)))


@register('rank_loss')
def _rank_loss(ctx):
    """RankNet: log(1 + exp(left - right)) - label (left - right)."""
    left, right = ctx.input('Left'), ctx.input('Right')
    ctx.set_output('Out', torch.log1p(torch.exp(left - right)) -
                   ctx.input('Label') * (left - right))


@register('margin_rank_loss')
def _margin_rank_loss(ctx):
    """max(0, -label (x1 - x2) + margin); Activated is 1 where that is
    positive."""
    x1 = ctx.input('X1')
    t = -ctx.input('Label') * (x1 - ctx.input('X2')) + \
        ctx.attr('margin', 0.0)
    out = pointwise.maximum(_zero(t), t)
    ctx.set_output('Out', out)
    ctx.set_output('Activated', (out > 0).to(x1.dtype))


@register('hinge_loss')
def _hinge_loss(ctx):
    """max(0, 1 - (2 label - 1) logits)."""
    t = 1.0 - (2.0 * ctx.input('Labels') - 1.0) * ctx.input('Logits')
    ctx.set_output('Loss', pointwise.maximum(_zero(t), t))


@register('log_loss')
def _log_loss(ctx):
    """-label log(pred + eps) - (1 - label) log(1 - pred + eps), eps in
    pred's dtype (as label_smooth) and the second sum in the order the
    reference's compiled program takes it."""
    pred = ctx.input('Predicted')
    label = ctx.input('Labels')
    eps = _const(ctx.attr('epsilon', 1e-7), pred)
    # at fp32 XLA folds 1 - pred + eps into (1 + eps) - pred
    rest = (_const(1.0, pred) + eps) - pred \
        if pred.dtype == torch.float32 else (1.0 - pred) + eps
    ctx.set_output('Loss', -label * torch.log(pred + eps) -
                   (1.0 - label) * torch.log(rest))


@register('bilinear_tensor_product')
def _bilinear_tensor_product(ctx):
    """out[b, k] = x[b] W[k] y[b] (+ Bias)."""
    out = torch.einsum('bm,kmn,bn->bk', ctx.input('X'), ctx.input('Weight'),
                       ctx.input('Y'))
    if ctx.has_input('Bias'):
        out = out + ctx.input('Bias')
    ctx.set_output('Out', out)


@register('pixel_shuffle')
def _pixel_shuffle(ctx):
    """NCHW [n, c r^2, h, w] -> [n, c, h r, w r]."""
    x = ctx.input('X')
    r = ctx.attr('upscale_factor')
    n, c, h, w = x.shape
    out = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    ctx.set_output('Out', out.reshape(n, c // (r * r), h * r, w * r))


@register('modified_huber_loss')
def _modified_huber_loss(ctx):
    """z = x (2y - 1); -4z where z < -1, (1 - z)^2 where z < 1, else 0
    (modified_huber_loss_op.h:37-72); IntermediateVal is z."""
    x = ctx.input('X')
    z = x * (2.0 * ctx.input('Y').to(x.dtype) - 1.0)
    zero = _zero(z)
    ctx.set_output('IntermediateVal', z)
    ctx.set_output('Out', torch.where(
        z < -1.0, -4.0 * z,
        torch.where(z < 1.0, torch.square(1.0 - z), zero)))
