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
are plain torch ops (``gru_unit`` runs a position at a time inside the
RNN-search decoder's DynamicRNN step). Every float input is taken in the
projected input's dtype, which is the carry's (the reference pins the
carry to h0's, which is x's unless H0 is fed in another dtype).

The decode ops ``rnn_search_greedy_decode``, ``rnn_search_beam_decode``
and ``generation_decode`` loop over a static ``max_out_len`` with no host
read, so a program that holds them is captured."""

import torch

from ..core.registry import register
from . import pointwise
from .tensor_ops import top_k
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


# ------------------------------------------------- the seq2seq decode ops
def _rnn_search_params(ctx):
    """The rnn_search decode ops' inputs (models/rnn_search.py)."""
    return dict(
        enc=ctx.input('EncOut'), proj=ctx.input('EncProj'),
        state0=ctx.input('Boot'), src_len=_optional(ctx, 'SrcLen'),
        emb=ctx.input('TrgEmb'), att_w=ctx.input('AttW'),
        score_w=ctx.input('ScoreW'), step_w=ctx.input('StepW'),
        gru_w=ctx.input('GruW'), gru_b=ctx.input('GruB'),
        out_w=ctx.input('OutW'), out_b=ctx.input('OutB'))


def _rnn_search_step(last_ids, state, enc, proj, kmask, p):
    """One decoder step of models/rnn_search.py: the additive attention
    over the source (masked past each row's length), gru_step over
    [embedding, context] @ StepW, and the vocab projection. Returns
    (new state, logits). The greedy and beam decode ops share it."""
    dec = state @ p['att_w']
    combined = torch.tanh(proj + dec[:, None, :])
    scores = (combined @ p['score_w'])[..., 0]
    if kmask is not None:
        scores = torch.where(kmask, scores, torch.full(
            (), -1e9, dtype=scores.dtype, device=scores.device))
    weights = torch.softmax(scores, -1)
    context = torch.einsum('bs,bsd->bd', weights, enc)
    xt = torch.cat([p['emb'][last_ids], context], -1) @ p['step_w']
    new_state = gru_step(xt, state, p['gru_w'], p['gru_b'])[0]
    return new_state, new_state @ p['out_w'] + p['out_b']


def _key_mask(src_len, ts, repeat=1):
    """[B * repeat, Ts] True on each row's source positions, or None."""
    if src_len is None:
        return None
    lens = src_len.reshape(-1)
    if repeat > 1:
        lens = lens.repeat_interleave(repeat)
    return torch.arange(ts, device=lens.device)[None, :] < lens[:, None]


@register('rnn_search_greedy_decode')
def _rnn_search_greedy_decode(ctx):
    """Greedy generation for the RNN-search seq2seq: max_out_len decoder
    steps with argmax feedback (ties to the lower id) from BOS; every id
    after a row's first EOS is EOS. A loop of static length with no host
    read: captured."""
    p = _rnn_search_params(ctx)
    t_max = ctx.attr('max_out_len')
    eos_id = ctx.attr('eos_id', 0)
    enc, state = p['enc'], p['state0']
    b, ts = enc.shape[0], enc.shape[1]
    kmask = _key_mask(p['src_len'], ts)
    ids = torch.full((b,), ctx.attr('bos_id', 1), dtype=torch.int64,
                     device=enc.device)
    steps = []
    for _ in range(t_max):
        state, logits = _rnn_search_step(ids, state, enc, p['proj'], kmask,
                                         p)
        ids = torch.argmax(logits, -1)
        steps.append(ids)
    ids = torch.stack(steps, 1)
    is_eos = (ids == eos_id).to(torch.int32)
    before = torch.cumsum(is_eos, 1) - is_eos
    ids = torch.where(before > 0, torch.full((), eos_id, dtype=ids.dtype,
                                             device=ids.device), ids)
    ctx.set_output('Out', ids.to(ctx.out_dtype('Out', 'int64')))


def _beam_loop(step, b, beam, t_max, bos_id, eos_id, device):
    """The beam search both beam decoders run: ``step(last [B * beam],
    parent [B, beam] or None)`` advances the beams' state and returns each
    beam's log-probabilities [B * beam, V]; the top ``beam`` of each beam
    become the candidates (decode_ops.beam_search_step), and the chosen
    beams' parents reorder the state at the next step. Returns (sentences
    [B, beam, T], final scores [B, beam])."""
    from .decode_ops import beam_backtrack, beam_search_step
    last = torch.full((b * beam,), bos_id, dtype=torch.int64, device=device)
    pre_ids = torch.full((b, beam), bos_id, dtype=torch.int64, device=device)
    # only slot 0 alive at first, so the first expansion draws each
    # candidate once
    pre_scores = torch.full((b, beam), -1e9, dtype=torch.float32,
                            device=device)
    pre_scores[:, 0] = 0.0
    parent = None
    step_ids, step_parents = [], []
    for _ in range(t_max):
        logp = step(last, parent)
        k = min(beam, logp.shape[-1])
        top_scores, top_ids = top_k(logp, k)
        pre_ids, pre_scores, parent = beam_search_step(
            pre_ids, pre_scores, top_ids.reshape(b, beam, k),
            top_scores.reshape(b, beam, k), beam, eos_id)
        last = pre_ids.reshape(-1)
        step_ids.append(pre_ids)
        step_parents.append(parent)
    seq = beam_backtrack(torch.stack(step_ids), torch.stack(step_parents),
                         eos_id)
    return seq, pre_scores


def _reorder(x, parent, b, beam):
    """Rows [B * beam, ...] taken from each beam's parent."""
    if parent is None:
        return x
    rest = tuple(x.shape[1:])
    idx = parent.reshape((b, beam) + (1,) * len(rest)).expand(
        (b, beam) + rest)
    return x.reshape((b, beam) + rest).gather(1, idx).reshape(
        (b * beam,) + rest)


@register('rnn_search_beam_decode')
def _rnn_search_beam_decode(ctx):
    """Beam search for the RNN-search seq2seq (the seqToseq demo's
    generation): the beams fold into the batch for the shared decoder
    step, candidates are each beam's top beam_size by log-softmax
    (tensor_ops.top_k, ties to the lower id), pruned by
    decode_ops.beam_search_step and walked back by beam_backtrack.
    SentenceIds [B, beam, max_out_len] best first, SentenceScores
    [B, beam]. A loop of static length with no host read: captured."""
    p = _rnn_search_params(ctx)
    beam = ctx.attr('beam_size', 4)
    enc = p['enc']
    b, ts = enc.shape[0], enc.shape[1]
    enc_b = enc.repeat_interleave(beam, 0)
    proj_b = p['proj'].repeat_interleave(beam, 0)
    kmask = _key_mask(p['src_len'], ts, beam)
    state = [p['state0'].repeat_interleave(beam, 0)]

    def step(last, parent):
        cur = _reorder(state[0], parent, b, beam)
        state[0], logits = _rnn_search_step(last, cur, enc_b, proj_b, kmask,
                                            p)
        return torch.log_softmax(logits.float(), -1)

    seq, scores = _beam_loop(step, b, beam, ctx.attr('max_out_len'),
                             ctx.attr('bos_id', 1), ctx.attr('eos_id', 0),
                             enc.device)
    ctx.set_output('SentenceIds',
                   seq.to(ctx.out_dtype('SentenceIds', 'int64')))
    ctx.set_output('SentenceScores', scores)


@register('generation_decode')
def _generation_decode(ctx):
    """Step-function generation for the v1 recurrent_group / beam_search
    (reference trainer_config_helpers/layers.py:4406): the step sub-block
    runs once a position (control_ops._run_block_ops, is_test) with the
    beams folded into the batch, fed the last ids and its memories; its
    probabilities' log gives each beam's candidates, pruned and walked
    back as in rnn_search_beam_decode. beam_size 1 is greedy. The
    batch-shaped outer vars the step reads (attr batch_var_names) are
    repeated for the beams once; parameters are read as they are."""
    from .control_ops import _run_block_ops
    block = ctx.block.program.block(ctx.attr('sub_block'))
    memory_names = ctx.attr('memory_names')      # [(pre, cur), ...]
    id_pre_name = ctx.attr('id_pre_name')
    prob_name = ctx.attr('prob_name')
    beam = ctx.attr('beam_size', 1)
    n_results = ctx.attr('num_results', beam)
    outer_env = dict(ctx.env)
    for name in ctx.attr('batch_var_names'):
        if name in outer_env:
            outer_env[name] = outer_env[name].repeat_interleave(beam, 0)
    b = ctx.input('BatchRef').shape[0]
    mems = [m.repeat_interleave(beam, 0)
            for m in ctx.input_list('BootMemories')]

    def step(last, parent):
        if parent is not None:
            for i, m in enumerate(mems):
                mems[i] = _reorder(m, parent, b, beam)
        env = dict(outer_env)
        env[id_pre_name] = last
        for (pre, _), mem in zip(memory_names, mems):
            env[pre] = mem
        env = _run_block_ops(block, env, ctx, is_test=True)
        for i, ((_, cur), mem) in enumerate(zip(memory_names, mems)):
            mems[i] = env[cur].to(mem.dtype)
        prob = env[prob_name].float()
        return torch.log(torch.clamp(prob, min=1e-20))

    seq, scores = _beam_loop(step, b, beam, ctx.attr('max_out_len'),
                             ctx.attr('bos_id', 0), ctx.attr('eos_id', 1),
                             ctx.device)
    ctx.set_output('SentenceIds', seq[:, :n_results].to(
        ctx.out_dtype('SentenceIds', 'int64')))
    ctx.set_output('SentenceScores', scores[:, :n_results])
