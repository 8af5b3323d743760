"""Switch-style mixture-of-experts FFN (reference: paddle_tpu
ops/moe_ops.py).

The router is the reference's: fp32 logits of the tokens against the gate
weight, a softmax, the top k experts in ``lax.top_k``'s order (ties to the
lower index), the k gates renormalised for k >= 2, and a per-expert
capacity filled choice-major (every first choice takes its slot before any
second choice). An assignment over capacity is dropped: the surrounding
residual carries its token.

``switch_moe_reference`` is the plain version: the reference's dense
dispatch and combine einsums over [S, E, C] one-hot tensors, word for
word. The tests hold the lowering against it; nothing on the main path
calls it.

The lowering (``switch_moe_slots``) computes the same function by slots.
Each kept (token, choice) gets its slot ``e * C + c``; the tokens are
copied into a zero-filled [E * C + 1, D] buffer (dropped ones into the
spare last row, sliced off), the expert FFN runs over the [E, C, D] buffer
as two ``torch.bmm``s with their biases and ReLU, and each token reads its
k slots back, times its gates. No [S, E, C] tensor is made, no value is
read on the host (a CUDA graph captures it), and no float is added
atomically: the slots are written with unique indices, and the read's
backward (``_SlotGather``) writes each gradient row into its slot the same
way, so the step's bits do not vary.

The dense einsums multiply every token by every slot's zero weight, so a
NaN or inf token turns its whole column of the experts' input, and then of
the output, into NaN, and the gradients spread the same way. The lowering
adds the same zero-weighted sums ((0 * x).sum(0) to the experts' input,
(0 * gates) x the experts' output summed over the slots to the output), so
its values and gradients on non-finite feeds are the dense form's.

Not ported: ``constrain_experts`` (the 'ep' sharding constraint; without a
mesh it passes its tensors through). An op on a program with a mesh raises
(ROADMAP Queue 1 item 9).
"""

import torch

from ..core.registry import check_no_mesh, register
from .pointwise import relu
from .tensor_ops import top_k


def moe_capacity(cap_factor, k, s, e):
    """ceil(cap_factor * k * S / E), floor 1: the per-expert slot budget
    shared by every MoE lowering."""
    return max(1, int(cap_factor * k * s / e + 0.999999))


def one_hot(idx, e):
    """[S] ids -> [S, E] int64 by a comparison (F.one_hot checks its
    ids' range on the host)."""
    return (idx.unsqueeze(-1) ==
            torch.arange(e, device=idx.device)).to(torch.int64)


def _router(x2, gate_w, k):
    """(fp32 probabilities [S, E], gates [S, k] fp32, expert ids [S, k]
    int64). The logits are the reference's ``(x2 @ gate_w).astype(f32)``:
    computed in the promoted dtype of the two (bf16 tokens against an
    fp32 gate weight in fp32), then fp32. The gates are picked by a
    one-hot product and a sum (the same values: the other terms are 0),
    whose backward is a product where a gather's adds atomically."""
    dt = torch.promote_types(x2.dtype, gate_w.dtype)
    logits = (x2.to(dt) @ gate_w.to(dt)).float()
    probs = torch.softmax(logits, dim=-1)
    _, idx = top_k(probs.detach(), k)
    e = probs.shape[-1]
    gates = torch.stack([(probs * one_hot(idx[:, j], e)).sum(-1)
                         for j in range(k)], 1)
    if k > 1:
        gates = gates / gates.sum(-1, keepdim=True)
    return probs, gates, idx


def _aux_loss(probs, first):
    """E * sum_e frac_e * mean_s probs[s, e]; frac (the share of first
    choices an expert takes) carries no gradient."""
    e = probs.shape[-1]
    frac = one_hot(first, e).float().mean(0)
    return e * torch.sum(frac * probs.mean(0))


def route(idx, e, capacity):
    """Slot of every (token, choice), [S, k] int64: ``e * C + c`` where
    the assignment keeps slot c of expert e, ``E * C`` (the spare row)
    where it is over capacity. Positions fill choice-major: the used
    counts carry over from one choice to the next. The running count is
    an [E, S] cumsum along its inner axis (a scan along the outer axis of
    [S, E] runs E columns in a few threads)."""
    s, k = idx.shape
    experts = torch.arange(e, device=idx.device)
    counts = torch.zeros((e,), dtype=torch.int64, device=idx.device)
    slots = []
    for j in range(k):
        mask = (experts[:, None] == idx[None, :, j]).to(torch.int64)
        pos = torch.cumsum(mask, 1).gather(0, idx[None, :, j])[0] - 1 + \
            counts.gather(0, idx[:, j])
        slots.append(torch.where(pos < capacity, idx[:, j] * capacity + pos,
                                 e * capacity))
        counts = counts + mask.sum(1)
    return torch.stack(slots, 1)


class _SlotGather(torch.autograd.Function):
    """rows[slots] whose backward writes each gradient row into its slot
    (index_copy): the kept slots are unique, so no two rows are added and
    the bits are the same on every run. Every dropped assignment writes
    the spare last row, a constant zero row whose gradient is dropped."""

    @staticmethod
    def forward(ctx, rows, slots):
        ctx.save_for_backward(slots)
        ctx.n = rows.shape[0]
        return rows.index_select(0, slots)

    @staticmethod
    def backward(ctx, g):
        slots, = ctx.saved_tensors
        out = g.new_zeros((ctx.n,) + tuple(g.shape[1:]))
        out.index_copy_(0, slots, g)
        return out, None


class _Dispatch(torch.autograd.Function):
    """The dense dispatch einsum 'sec,sd->ecd' by slots: the expert
    buffer [E * C, D] with each kept token in its slot, and its NaN
    places. A slot of the dense form is its own token (1 * x) plus every
    other token times 0, so a column turns NaN where another token is
    inf or NaN there, and an inf token's own slot stays inf. The
    backward is the same sum the other way: a token's gradient is its
    slots' rows plus 0 times every other slot's row."""

    @staticmethod
    def forward(ctx, x2, slots, n_rows):
        s, k = slots.shape
        d = x2.shape[1]
        flat = slots.reshape(-1)
        src = x2 if k == 1 else x2.unsqueeze(1).expand(s, k, d).reshape(-1, d)
        buf = x2.new_zeros((n_rows + 1, d)).index_copy(0, flat, src)[:-1]
        ctx.save_for_backward(slots)
        # a slot's own token is the value in it
        return _other_nan(buf, _nonfinite(x2).sum(0), _nonfinite(buf))

    @staticmethod
    def backward(ctx, g):
        slots, = ctx.saved_tensors
        s, k = slots.shape
        d = g.shape[1]
        flat = slots.reshape(-1)
        rows = torch.cat([g, g.new_zeros((1, d))])
        bad = _nonfinite(rows)
        dx = rows.index_select(0, flat)
        own = bad.index_select(0, flat)
        if k > 1:
            dx = dx.view(s, k, d).sum(1)
            own = own.view(s, k, d).sum(1)
        return _other_nan(dx, bad.sum(0), own), None, None


def _nonfinite(x):
    """1 where x is inf or NaN: 0 * x is NaN exactly there."""
    z = x * 0
    return z != z


def _other_nan(v, count, own):
    """v + 0 (the dense form's sum of zeros turns a -0 into +0), NaN in
    each column where ``count`` (the column's non-finite terms) exceeds
    ``own`` (those of the row's own term)."""
    return (v + 0).masked_fill_(count > own, float('nan'))


def switch_moe_slots(x2, gate_w, w1, b1, w2, b2, capacity, k=1):
    """The slot form on flattened tokens x2 [S, D] (fp32, or bf16 with
    bf16 expert weights under AMP; gate_w fp32). Returns (out [S, D] in
    x2's dtype, aux loss fp32 scalar, expert ids [S, k], slots [S, k])."""
    s, d = x2.shape
    e = gate_w.shape[-1]
    probs, gates, idx = _router(x2, gate_w, k)
    slots = route(idx, e, capacity)
    flat = slots.reshape(-1)
    expert_in = _Dispatch.apply(x2, slots, e * capacity).view(e, capacity, d)
    h = relu(torch.bmm(expert_in, w1) + b1.unsqueeze(1))
    expert_out = torch.bmm(h, w2) + b2.unsqueeze(1)
    rows = torch.cat([expert_out.reshape(e * capacity, d),
                      expert_out.new_zeros((1, d))])
    picked = _SlotGather.apply(rows, flat).view(s, k, d)
    # the gates rounded to x2's dtype, as the reference's combine is; the
    # products of bf16 values are exact in fp32, summed there and rounded
    # once, as its einsum accumulates
    g = gates.to(x2.dtype)
    out = (g.float().unsqueeze(-1) * picked.float()).sum(1)
    zero = (0 * g.float().sum(1, keepdim=True)) * \
        expert_out.sum((0, 1), dtype=torch.float32)
    out = (out + zero).to(x2.dtype)
    return out, _aux_loss(probs, idx[:, 0]), idx, slots


def switch_moe_reference(x2, gate_w, w1, b1, w2, b2, capacity, k=1):
    """The plain version: the reference's dense dispatch and combine
    einsums on x2 [S, D]. Returns (out [S, D], aux loss, expert ids)."""
    s, d = x2.shape
    e = gate_w.shape[-1]
    probs, top_gates, top_idx = _router(x2, gate_w, k)
    dispatch = torch.zeros((s, e, capacity), dtype=torch.float32,
                           device=x2.device)
    combine = torch.zeros_like(dispatch)
    counts = torch.zeros((e,), dtype=torch.float32, device=x2.device)
    first_mask = None
    for j in range(k):
        mask = one_hot(top_idx[:, j], e).float()
        if first_mask is None:
            first_mask = mask
        pos = (torch.cumsum(mask, 0) - 1.0) * mask + counts[None] * mask
        keep = mask * (pos < capacity)
        disp = keep[:, :, None] * one_hot(
            pos.sum(-1).long(), capacity).float()[:, None, :]
        dispatch = dispatch + disp
        combine = combine + disp * top_gates[:, j][:, None, None]
        counts = counts + mask.sum(0)
    dtype = x2.dtype
    expert_in = torch.einsum('sec,sd->ecd', dispatch.to(dtype), x2)
    h = relu(torch.einsum('ecd,edh->ech', expert_in, w1) + b1[:, None, :])
    expert_out = torch.einsum('ech,ehd->ecd', h, w2) + b2[:, None, :]
    out = torch.einsum('sec,ecd->sd', combine.to(dtype), expert_out)
    frac = first_mask.mean(0)
    aux = e * torch.sum(frac * probs.mean(0))
    return out, aux, top_idx


@register('switch_moe')
def _switch_moe(ctx):
    """Under bf16 AMP the tokens and the expert weights go to bf16; the
    router weight is read from the env, outside AMP's casts, and stays
    fp32."""
    check_no_mesh(ctx)
    gate_w = ctx.env[ctx.op.input('GateW')]
    x, w1, b1, w2, b2 = (ctx.input(s) for s in ('X', 'W1', 'B1', 'W2',
                                                'B2'))
    if ctx.amp == 'bf16':
        x, w1, b1, w2, b2 = (t.to(torch.bfloat16)
                             for t in (x, w1, b1, w2, b2))
    k = ctx.attr('top_k', 1)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    capacity = moe_capacity(ctx.attr('capacity_factor', 1.25), k,
                            x2.shape[0], gate_w.shape[-1])
    out, aux, _, _ = switch_moe_slots(x2, gate_w, w1, b1, w2, b2, capacity,
                                      k)
    ctx.set_output('Out', out.reshape(shape))
    ctx.set_output('AuxLoss', aux)
