"""Optimizer update ops (reference: paddle_tpu ops/optimizer_ops.py;
fluid's sgd_op, momentum_op, adam_op, adagrad_op, adamax_op, adadelta_op,
decayed_adagrad_op, rmsprop_op, ftrl_op, proximal_gd_op and
proximal_adagrad_op).

The executor runs them under ``torch.no_grad()`` after the gradients
exist. Each updates its Param and accumulators in place (ParamOut and the
*Out slots name the same persistable vars), so a step allocates no second
copy of the parameters or moments.

A row-sparse gradient (the Grad var carries ``sparse_ids``,
core/backward.py) takes the sparse branch of sgd, adagrad, momentum and
adam: the sparse_rows kernel merges the rows by id and updates the touched
rows in place (ops/kernels/sparse_rows.py), where the reference sorts,
segment-sums and scatters with XLA. Momentum and Adam update lazily there:
untouched rows keep their state, as the reference's ``lazy_mode`` does.
Inside an executor's run the branch does not launch: it hands its table to
the run's ``SparseUpdates`` (``ctx.sparse_updates``), which applies every
held table in one grouped call per (kind, dtype, lr tensor,
hyperparameters) when the executor flushes it; called with no
``SparseUpdates`` it applies its table at once.
"""

import torch

from ..core.registry import register
from .kernels.sparse_rows import SparseTable, sparse_rows_grouped


class SparseUpdates(object):
    """One run's row-sparse updates, held until a flush: the executor
    flushes before any op that writes what a held update reads (its table,
    accumulators, gradient rows, ids, lr or beta pows) or reads or writes
    what it writes (the table and accumulators), at the end of each
    section of the run, so every op sees the values the per-op order gives,
    bit for bit (the tables are disjoint). A flush makes one
    ``sparse_rows_grouped`` call per (kind, dtype, lr tensor,
    hyperparameters)."""

    def __init__(self):
        self._groups = {}
        self._reads = set()
        self._writes = set()

    def add(self, op, ids_name, kind, table, lr, hyper):
        key = (kind, table.param.dtype, id(lr), tuple(sorted(hyper.items())))
        group = self._groups.get(key)
        if group is None:
            group = self._groups[key] = (kind, lr, hyper, [])
        group[3].append(table)
        self._reads.update(op.input_names())
        self._reads.add(ids_name)
        self._writes.update(op.output_names())

    def conflicts(self, op):
        """Whether ``op`` must wait for the held updates."""
        if not self._groups:
            return False
        return any(n in self._writes or n in self._reads
                   for n in op.output_names()) or \
            any(n in self._writes for n in op.input_names())

    def flush(self):
        groups = list(self._groups.values())
        self._groups.clear()
        self._reads.clear()
        self._writes.clear()
        for kind, lr, hyper, tables in groups:
            sparse_rows_grouped(kind, tables, lr, **hyper)


def _lr(ctx):
    return ctx.input('LearningRate').reshape(())


def _inplace(ctx, in_slot, out_slot):
    """The tensor to update for out_slot: in_slot's own tensor when both
    slots name one var (the optimizer's layout), else a copy."""
    t = ctx.input(in_slot)
    return t if ctx.op.output(out_slot) == ctx.op.input(in_slot) \
        else t.clone()


def _sparse_rows(ctx):
    """(flat ids, rows, the ids var's name) when this op's Grad is a
    row-sparse embedding gradient (the grad var's ``sparse_ids``), else
    None. rows: [n_ids, dim], one gradient row an id occurrence; duplicates
    are legal."""
    gvar = ctx.block._find_var_recursive(ctx.op.input('Grad'))
    ids_name = getattr(gvar, 'sparse_ids', None) if gvar is not None \
        else None
    if ids_name is None:
        return None
    flat = ctx.env[ids_name].reshape(-1).long()
    return flat, ctx.input('Grad').reshape(flat.shape[0], -1), ids_name


def _sparse_update(ctx, kind, sparse, state_slots=(), beta_pows=(),
                   **hyper):
    """The sparse branch: Param and the accumulators in ``state_slots``
    ((in, out) pairs) updated in place by the sparse_rows kernel, at the
    run's next flush (at once without ``ctx.sparse_updates``)."""
    flat, rows, ids_name = sparse
    p = _inplace(ctx, 'Param', 'ParamOut')
    state = [_inplace(ctx, i, o) for i, o in state_slots]
    table = SparseTable(p, rows.contiguous(), flat.contiguous(), state,
                        [ctx.input(b) for b in beta_pows])
    lr = ctx.input('LearningRate')
    pending = ctx.sparse_updates
    if pending is None:
        sparse_rows_grouped(kind, [table], lr, **hyper)
    else:
        pending.add(ctx.op, ids_name, kind, table, lr, hyper)
    ctx.set_output('ParamOut', p)
    for (_, o), t in zip(state_slots, state):
        ctx.set_output(o, t)


@register('sgd')
def _sgd(ctx):
    sparse = _sparse_rows(ctx)
    if sparse is not None:
        _sparse_update(ctx, 'sgd', sparse)
        return
    p = _inplace(ctx, 'Param', 'ParamOut')
    p.sub_((_lr(ctx) * ctx.input('Grad')).to(p.dtype))
    ctx.set_output('ParamOut', p)


@register('momentum')
def _momentum(ctx):
    """v = mu·v + g; p -= lr·v, or with use_nesterov p -= (g + mu·v)·lr.
    Row-sparse: the same on the touched rows only (lazy_mode)."""
    mu = ctx.attr('mu', 0.9)
    sparse = _sparse_rows(ctx)
    if sparse is not None:
        _sparse_update(ctx, 'momentum', sparse,
                       (('Velocity', 'VelocityOut'),), mu=mu,
                       use_nesterov=bool(ctx.attr('use_nesterov', False)))
        return
    g = ctx.input('Grad')
    p = _inplace(ctx, 'Param', 'ParamOut')
    v = _inplace(ctx, 'Velocity', 'VelocityOut')
    v.mul_(mu).add_(g)
    if ctx.attr('use_nesterov', False):
        step = (g + mu * v) * _lr(ctx)
    else:
        step = _lr(ctx) * v
    p.sub_(step.to(p.dtype))
    ctx.set_output('VelocityOut', v)
    ctx.set_output('ParamOut', p)


@register('adam')
def _adam(ctx):
    """m = b1·m + (1-b1)·g; v = b2·v + (1-b2)·g²;
    p -= lr·sqrt(1-b2^t)/(1-b1^t) · m / (sqrt(v) + eps). Row-sparse: the
    same on the touched rows only (lazy_mode)."""
    b1 = ctx.attr('beta1', 0.9)
    b2 = ctx.attr('beta2', 0.999)
    eps = ctx.attr('epsilon', 1e-8)
    sparse = _sparse_rows(ctx)
    if sparse is not None:
        _sparse_update(ctx, 'adam', sparse,
                       (('Moment1', 'Moment1Out'), ('Moment2', 'Moment2Out')),
                       ('Beta1Pow', 'Beta2Pow'), epsilon=eps, beta1=b1,
                       beta2=b2)
        return
    g = ctx.input('Grad')
    p = _inplace(ctx, 'Param', 'ParamOut')
    m = _inplace(ctx, 'Moment1', 'Moment1Out')
    v = _inplace(ctx, 'Moment2', 'Moment2Out')
    lr_t = _lr(ctx) * torch.sqrt(1.0 - ctx.input('Beta2Pow').reshape(())) / \
        (1.0 - ctx.input('Beta1Pow').reshape(()))
    m.mul_(b1).add_(g, alpha=1.0 - b1)
    v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
    step = torch.div(m, v.sqrt().add_(eps)).mul_(lr_t)
    p.sub_(step.to(p.dtype))
    ctx.set_output('Moment1Out', m)
    ctx.set_output('Moment2Out', v)
    ctx.set_output('ParamOut', p)


@register('adam_beta_pow_update')
def _adam_beta_pow_update(ctx):
    b1p = _inplace(ctx, 'Beta1Pow', 'Beta1PowOut')
    b2p = _inplace(ctx, 'Beta2Pow', 'Beta2PowOut')
    b1p.mul_(ctx.attr('beta1', 0.9))
    b2p.mul_(ctx.attr('beta2', 0.999))
    ctx.set_output('Beta1PowOut', b1p)
    ctx.set_output('Beta2PowOut', b2p)


@register('adagrad')
def _adagrad(ctx):
    """m += g²; p -= lr·g / (sqrt(m) + eps). Row-sparse: duplicate ids
    merged first, then the same on the touched rows (exact against the
    dense update)."""
    eps = ctx.attr('epsilon', 1e-6)
    sparse = _sparse_rows(ctx)
    if sparse is not None:
        _sparse_update(ctx, 'adagrad', sparse, (('Moment', 'MomentOut'),),
                       epsilon=eps)
        return
    g = ctx.input('Grad')
    p = _inplace(ctx, 'Param', 'ParamOut')
    m = _inplace(ctx, 'Moment', 'MomentOut')
    m.add_((g * g).to(m.dtype))
    p.sub_((_lr(ctx) * g / (torch.sqrt(m) + eps)).to(p.dtype))
    ctx.set_output('MomentOut', m)
    ctx.set_output('ParamOut', p)


@register('adamax')
def _adamax(ctx):
    """m = b1·m + (1-b1)·g; u = max(b2·u, |g| + eps);
    p -= lr/(1-b1^t) · m / u."""
    g = ctx.input('Grad')
    p = _inplace(ctx, 'Param', 'ParamOut')
    m = _inplace(ctx, 'Moment', 'MomentOut')
    u = _inplace(ctx, 'InfNorm', 'InfNormOut')
    b1 = ctx.attr('beta1', 0.9)
    b2 = ctx.attr('beta2', 0.999)
    eps = ctx.attr('epsilon', 1e-8)
    m.copy_(b1 * m + (1.0 - b1) * g)
    u.copy_(torch.maximum(b2 * u, torch.abs(g) + eps))
    lr_t = _lr(ctx) / (1.0 - ctx.input('Beta1Pow').reshape(()))
    p.copy_(p - lr_t * m / u)
    ctx.set_output('MomentOut', m)
    ctx.set_output('InfNormOut', u)
    ctx.set_output('ParamOut', p)


@register('beta_pow_update')
def _beta_pow_update(ctx):
    bp = _inplace(ctx, 'BetaPow', 'BetaPowOut')
    bp.mul_(ctx.attr('beta', 0.9))
    ctx.set_output('BetaPowOut', bp)


@register('decayed_adagrad')
def _decayed_adagrad(ctx):
    """m = decay·m + (1-decay)·g²; p -= lr·g / (sqrt(m) + eps)."""
    g = ctx.input('Grad')
    p = _inplace(ctx, 'Param', 'ParamOut')
    m = _inplace(ctx, 'Moment', 'MomentOut')
    decay = ctx.attr('decay', 0.95)
    eps = ctx.attr('epsilon', 1e-6)
    m.copy_(decay * m + (1.0 - decay) * (g * g))
    p.copy_(p - _lr(ctx) * g / (torch.sqrt(m) + eps))
    ctx.set_output('MomentOut', m)
    ctx.set_output('ParamOut', p)


@register('adadelta')
def _adadelta(ctx):
    """E[g²] = rho·E[g²] + (1-rho)·g²; dx = -sqrt((E[dx²] + eps) /
    (E[g²] + eps))·g; E[dx²] = rho·E[dx²] + (1-rho)·dx²; p += dx."""
    g = ctx.input('Grad')
    p = _inplace(ctx, 'Param', 'ParamOut')
    asg = _inplace(ctx, 'AvgSquaredGrad', 'AvgSquaredGradOut')
    asu = _inplace(ctx, 'AvgSquaredUpdate', 'AvgSquaredUpdateOut')
    rho = ctx.attr('rho', 0.95)
    eps = ctx.attr('epsilon', 1e-6)
    asg.copy_(rho * asg + (1.0 - rho) * (g * g))
    update = -torch.sqrt((asu + eps) / (asg + eps)) * g
    asu.copy_(rho * asu + (1.0 - rho) * (update * update))
    p.copy_(p + update)
    ctx.set_output('AvgSquaredGradOut', asg)
    ctx.set_output('AvgSquaredUpdateOut', asu)
    ctx.set_output('ParamOut', p)


@register('rmsprop')
def _rmsprop(ctx):
    """ms = rho·ms + (1-rho)·g²; mom = momentum·mom + lr·g / sqrt(ms +
    eps); p -= mom."""
    g = ctx.input('Grad')
    p = _inplace(ctx, 'Param', 'ParamOut')
    ms = _inplace(ctx, 'MeanSquare', 'MeanSquareOut')
    mom = _inplace(ctx, 'Moment', 'MomentOut')
    rho = ctx.attr('decay', 0.9)
    eps = ctx.attr('epsilon', 1e-10)
    momentum = ctx.attr('momentum', 0.0)
    ms.copy_(rho * ms + (1.0 - rho) * (g * g))
    mom.copy_(momentum * mom + _lr(ctx) * g / torch.sqrt(ms + eps))
    p.copy_(p - mom)
    ctx.set_output('MeanSquareOut', ms)
    ctx.set_output('MomentOut', mom)
    ctx.set_output('ParamOut', p)


@register('ftrl')
def _ftrl(ctx):
    """FTRL-proximal (ftrl_op.h): n' = n + g²; z += g - (n'^-k - n^-k) /
    lr · p with k = lr_power; p = (l1·sign(z) - z) / (n'^-k / lr + 2·l2)
    where |z| > l1, else 0."""
    g = ctx.input('Grad')
    p = _inplace(ctx, 'Param', 'ParamOut')
    sq = _inplace(ctx, 'SquaredAccumulator', 'SquaredAccumOut')
    lin = _inplace(ctx, 'LinearAccumulator', 'LinearAccumOut')
    lr = _lr(ctx)
    l1 = ctx.attr('l1', 0.0)
    l2 = ctx.attr('l2', 0.0)
    lr_power = ctx.attr('lr_power', -0.5)
    new_sq = sq + g * g
    lin.copy_(lin + g - (torch.pow(new_sq, -lr_power) -
                         torch.pow(sq, -lr_power)) / lr * p)
    x = l1 * torch.sign(lin) - lin
    y = torch.pow(new_sq, -lr_power) / lr + 2.0 * l2
    p.copy_(torch.where(torch.abs(lin) > l1, x / y, torch.zeros_like(p)))
    sq.copy_(new_sq)
    ctx.set_output('SquaredAccumOut', sq)
    ctx.set_output('LinearAccumOut', lin)
    ctx.set_output('ParamOut', p)


def _proximal(prox, lr_t, l1, l2):
    """sign(x)·max(|x| - lr·l1, 0) / (1 + lr·l2)."""
    return torch.sign(prox) * torch.clamp(torch.abs(prox) - lr_t * l1,
                                          min=0.0) / (1.0 + lr_t * l2)


@register('proximal_gd')
def _proximal_gd(ctx):
    """p = prox(p - lr·g) with the l1/l2 proximal operator."""
    g = ctx.input('Grad')
    p = _inplace(ctx, 'Param', 'ParamOut')
    lr = _lr(ctx)
    p.copy_(_proximal(p - lr * g, lr, ctx.attr('l1', 0.0),
                      ctx.attr('l2', 0.0)))
    ctx.set_output('ParamOut', p)


@register('proximal_adagrad')
def _proximal_adagrad(ctx):
    """An Adagrad step followed by the proximal l1/l2 operator
    (proximal_adagrad_op.h): m += g²; lr_t = lr / sqrt(m);
    p = prox(p - lr_t·g)."""
    g = ctx.input('Grad')
    p = _inplace(ctx, 'Param', 'ParamOut')
    m = _inplace(ctx, 'Moment', 'MomentOut')
    m.add_(g * g)
    lr_t = _lr(ctx) / torch.sqrt(m)
    p.copy_(_proximal(p - lr_t * g, lr_t, ctx.attr('l1', 0.0),
                      ctx.attr('l2', 0.0)))
    ctx.set_output('MomentOut', m)
    ctx.set_output('ParamOut', p)
