"""Recurrent ops over padded [B, T, ...] batches with an optional length
vector (reference: paddle_tpu ops/rnn_ops.py; fluid's lstm_op, lstmp_op,
gru_op, lstm_unit_op and gru_unit_op). Gate layouts are the reference's:
the LSTM's projected input and weight hold [i, f, g (candidate), o], the
GRU's [u (update), r (reset), c (candidate)] with
h = u * h_prev + (1 - u) * c. A position past a row's length carries h
(and c) unchanged; a reverse recurrence walks the padded axis from its
end.

``lstm`` and ``gru`` run as one autograd Function each over the sequence
(ops/kernels/rnn_cell.py): a torch.mm and one cell kernel a step (the
GRU's cell in two launches around its second product), the backward the
cells in reverse. ``simple_rnn``, ``lstmp``'s recurrence (its projection
sits inside the step) and the single-step ``lstm_unit`` and ``gru_unit``
are plain torch ops: no main path runs them. Every float input is taken
in the projected input's dtype, which is the carry's (the reference pins
the carry to h0's, which is x's unless H0 is fed in another dtype).
The rnn_search decode ops and generation_decode of the reference module
are not ported (ROADMAP, the control-flow slice)."""

import torch

from ..core.registry import register
from . import pointwise
from .kernels.rnn_cell import (ACTS, GruRecurrence, LstmRecurrence,
                               positions)

_TORCH_ACTS = {'sigmoid': torch.sigmoid, 'tanh': torch.tanh,
               'relu': pointwise.relu, 'identity': lambda x: x}


def _codes(ctx, *names):
    out = []
    for attr, default in names:
        name = ctx.attr(attr, default)
        if name not in ACTS:
            raise ValueError('%s: activation %r is not one of %s'
                             % (ctx.op.type, name, sorted(ACTS)))
        out.append(ACTS[name])
    return tuple(out)


def _optional(ctx, slot):
    return ctx.input(slot) if ctx.has_input(slot) else None


def _length(ctx, batch):
    if not ctx.has_input('Length'):
        return None
    return ctx.input('Length').reshape(batch).to(torch.int32).contiguous()


def _state(ctx, slot, batch, d, dtype, device):
    v = _optional(ctx, slot)
    if v is None:
        return torch.zeros((batch, d), dtype=dtype, device=device)
    return v.to(dtype)


@register('lstm')
def _lstm(ctx):
    """Input [B, T, 4D], Weight [D, 4D], Bias [1, 4D], H0 / C0 [B, D],
    Length [B] -> Hidden, Cell [B, T, D]. ``use_peepholes`` is ignored, as
    the reference op ignores it."""
    x = ctx.input('Input').contiguous()
    dtype = x.dtype
    w = ctx.input('Weight').to(dtype)
    bias = _optional(ctx, 'Bias')
    b, d = x.shape[0], w.shape[0]
    hidden, cell = LstmRecurrence.apply(
        x, w, None if bias is None else bias.reshape(-1).to(dtype),
        _state(ctx, 'H0', b, d, dtype, x.device),
        _state(ctx, 'C0', b, d, dtype, x.device), _length(ctx, b),
        _codes(ctx, ('gate_activation', 'sigmoid'),
               ('cell_activation', 'tanh'),
               ('candidate_activation', 'tanh')),
        bool(ctx.attr('is_reverse', False)))
    ctx.set_output('Hidden', hidden)
    ctx.set_output('Cell', cell)


@register('gru')
def _gru(ctx):
    """Input [B, T, 3D], Weight [D, 3D] (W[:, :2D] the update and reset
    weights, W[:, 2D:] the candidate's, applied to r * h_prev), Bias
    [1, 3D], H0 [B, D], Length [B] -> Hidden [B, T, D]."""
    x = ctx.input('Input').contiguous()
    dtype = x.dtype
    w = ctx.input('Weight').to(dtype)
    bias = _optional(ctx, 'Bias')
    b, d = x.shape[0], w.shape[0]
    hidden = GruRecurrence.apply(
        x, w, None if bias is None else bias.reshape(-1).to(dtype),
        _state(ctx, 'H0', b, d, dtype, x.device), _length(ctx, b),
        _codes(ctx, ('gate_activation', 'sigmoid'), ('activation', 'tanh')),
        bool(ctx.attr('is_reverse', False)))
    ctx.set_output('Hidden', hidden)


def _step_masks(length, t, dtype):
    """[T] of [B, 1] masks in ``dtype`` (None without lengths)."""
    if length is None:
        return [None] * t
    return [(p < length).to(dtype)[:, None] for p in range(t)]


def _blend(m, new, prev):
    return new if m is None else m * new + (1 - m) * prev


@register('simple_rnn')
def _simple_rnn(ctx):
    """h_t = act(x_t + h_{t-1} @ W + b) over Input [B, T, D] (projected),
    Weight [D, D]: the v1 recurrent_layer."""
    x = ctx.input('Input')
    dtype = x.dtype
    w = ctx.input('Weight').to(dtype)
    bias = _optional(ctx, 'Bias')
    b, t = x.shape[0], x.shape[1]
    act = _TORCH_ACTS[ctx.attr('activation', 'tanh')]
    masks = _step_masks(_length(ctx, b), t, dtype)
    hp = _state(ctx, 'H0', b, w.shape[0], dtype, x.device)
    outs = [None] * t
    for p in positions(t, ctx.attr('is_reverse', False)):
        pre = x[:, p] + hp @ w
        if bias is not None:
            pre = pre + bias.reshape(1, -1).to(dtype)
        hp = outs[p] = _blend(masks[p], act(pre), hp).to(dtype)
    ctx.set_output('Hidden', torch.stack(outs, 1) if t else
                   x.new_zeros((b, 0, w.shape[0])))


@register('lstmp')
def _lstmp(ctx):
    """The LSTM with a recurrent projection (lstmp_op.cc): the recurrence
    runs over r = proj_act((o * cell_act(c)) @ ProjWeight) [B, P]; Input
    [B, T, 4D], Weight [P, 4D], ProjWeight [D, P] -> Projection [B, T, P],
    Cell [B, T, D]."""
    x = ctx.input('Input')
    dtype = x.dtype
    w = ctx.input('Weight').to(dtype)
    w_proj = ctx.input('ProjWeight').to(dtype)
    bias = _optional(ctx, 'Bias')
    b, t = x.shape[0], x.shape[1]
    d, p_dim = w_proj.shape
    gate = _TORCH_ACTS[ctx.attr('gate_activation', 'sigmoid')]
    cell_act = _TORCH_ACTS[ctx.attr('cell_activation', 'tanh')]
    cand = _TORCH_ACTS[ctx.attr('candidate_activation', 'tanh')]
    proj_act = _TORCH_ACTS[ctx.attr('proj_activation', 'tanh')]
    masks = _step_masks(_length(ctx, b), t, dtype)
    rp = x.new_zeros((b, p_dim))
    cp = x.new_zeros((b, d))
    rs, cs = [None] * t, [None] * t
    for p in positions(t, ctx.attr('is_reverse', False)):
        gates = x[:, p] + rp @ w
        if bias is not None:
            gates = gates + bias.reshape(1, -1).to(dtype)
        i, f, g, o = gates.split(d, dim=-1)
        c = gate(f) * cp + gate(i) * cand(g)
        r = proj_act((gate(o) * cell_act(c)) @ w_proj)
        rp = rs[p] = _blend(masks[p], r, rp).to(dtype)
        cp = cs[p] = _blend(masks[p], c, cp).to(dtype)
    ctx.set_output('Projection', torch.stack(rs, 1) if t else
                   x.new_zeros((b, 0, p_dim)))
    ctx.set_output('Cell', torch.stack(cs, 1) if t else
                   x.new_zeros((b, 0, d)))


@register('lstm_unit')
def _lstm_unit(ctx):
    """One LSTM step on projected gates X [B, 4D] (lstm_unit_op.cc):
    c = sigmoid(f + forget_bias) * C_prev + sigmoid(i) * tanh(g),
    h = sigmoid(o) * tanh(c)."""
    gates = ctx.input('X')
    c_prev = ctx.input('C_prev')
    i, f, g, o = gates.split(gates.shape[-1] // 4, dim=-1)
    c = torch.sigmoid(f + ctx.attr('forget_bias', 0.0)) * c_prev + \
        torch.sigmoid(i) * torch.tanh(g)
    ctx.set_output('C', c)
    ctx.set_output('H', torch.sigmoid(o) * torch.tanh(c))


def gru_step(x, h_prev, w, bias, gate=torch.sigmoid, cand=torch.tanh):
    """One GRU step on a projected input x [B, 3D] (the reference's
    gru_step). Returns (h, u, r, c)."""
    d = h_prev.shape[-1]
    if bias is not None:
        x = x + bias.reshape(1, -1)
    ur = gate(x[:, :2 * d] + h_prev @ w[:, :2 * d])
    u, r = ur[:, :d], ur[:, d:]
    c = cand(x[:, 2 * d:] + (r * h_prev) @ w[:, 2 * d:])
    return u * h_prev + (1 - u) * c, u, r, c


@register('gru_unit')
def _gru_unit(ctx):
    """One GRU step (gru_unit_op.cc): Gate [u, r, c], ResetHiddenPrev
    r * h_prev, Hidden."""
    h_prev = ctx.input('HiddenPrev')
    bias = _optional(ctx, 'Bias')
    h, u, r, c = gru_step(
        ctx.input('Input'), h_prev, ctx.input('Weight'), bias,
        _TORCH_ACTS[ctx.attr('gate_activation', 'sigmoid')],
        _TORCH_ACTS[ctx.attr('activation', 'tanh')])
    ctx.set_output('Gate', torch.cat([u, r, c], -1))
    ctx.set_output('ResetHiddenPrev', r * h_prev)
    ctx.set_output('Hidden', h)
