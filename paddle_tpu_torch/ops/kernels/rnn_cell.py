"""The LSTM and GRU cells and sequence kernels: the CUDA kernels of
``csrc/rnn_cell.cu``, ``csrc/lstm_seq.cu``, ``csrc/gru_seq.cu`` and
``csrc/gru_wide.cu`` beside their plain PyTorch versions, and the
recurrences built on them.

The kernels replace no Pallas kernel: the JAX package runs each
recurrence as one ``lax.scan`` (paddle_tpu/ops/rnn_ops.py ``lstm_scan``,
``gru_scan`` with ``gru_step``), which XLA compiles into one loop fusion a
step around the recurrent product.

``lstm_seq_fwd`` / ``lstm_seq_bwd`` and ``gru_seq_fwd`` / ``gru_seq_bwd``
run a whole recurrence in one launch each way (W's slices resident in a
thread-block cluster's shared memory, h and the gates' gradients exchanged
between its CTAs; the GRU's second product, (r * h_prev) @ W_c, inside the
cluster too), on every shape ``lstm_seq_plan`` / ``gru_seq_plan`` finds
room for. A GRU too wide for a cluster runs ``gru_wide_fwd`` /
``gru_wide_bwd`` where ``gru_wide_plan`` has a launch: one launch each way
too, W's slices over (almost) every SM and each step's values exchanged
through L2. Wider recurrences take the per-position path: a ``torch.mm``
and a cell launch (``lstm_cell_fwd`` / ``lstm_cell_bwd``) a position each
way, for the GRU two of each (``gru_cell_fwd`` / ``gru_cell_bwd``, around
its second product).

Every wrapper launches its kernel for CUDA tensors (and counts it in
``.launches``) and takes its plain version (``*_reference``) for CPU
tensors; on a CUDA tensor it launches or raises. ``LstmRecurrence`` and
``GruRecurrence`` are one torch.autograd.Function each over the whole
sequence; their backward takes dW as one product over all steps, dbias as
a sum, and the input's gradient is the cells' dgates.

Semantics are the reference's (rnn_ops.py): gate layouts [i, f, g, o] and
[u, r, c], a position past a row's length carries h (and c) unchanged,
reverse walks positions T-1 .. 0 over the padded axis, and every carry is
in the input's dtype. The arithmetic is fp32; the values the reference
holds in the carry's dtype and the backward reads again (the activated
gates, the cell, r * h_prev, the recurrent products) are rounded to it
where they are made.
"""

import torch

from . import build

# rnn_ops.py's _ACTS, as the kernels' codes
ACTS = {'sigmoid': 0, 'tanh': 1, 'relu': 2, 'identity': 3}


def _act(code, x):
    if code == 0:
        return torch.sigmoid(x)
    if code == 1:
        return torch.tanh(x)
    if code == 2:
        # jnp.maximum(x, 0): a NaN stays NaN
        return torch.where(x < 0, torch.zeros_like(x), x)
    return x


def _dact(code, y):
    """The activation's derivative from its output."""
    if code == 0:
        return y * (1.0 - y)
    if code == 1:
        return 1.0 - y * y
    if code == 2:
        return (y > 0).to(y.dtype)
    return torch.ones_like(y)


def _rnd(v, dtype):
    """v rounded to ``dtype`` and widened back to fp32."""
    return v.to(dtype).float()


def step_mask(length, pos, batch, device):
    """[B, 1] fp32: 1 where ``pos`` is below the row's length (all 1 with
    no lengths)."""
    if length is None:
        return torch.ones((batch, 1), dtype=torch.float32, device=device)
    return (pos < length).to(torch.float32).reshape(batch, 1)


# ------------------------------------------------------------ plain versions
def lstm_cell_reference(x, hw, bias, hp, cp, m, acts, dtype):
    """One LSTM step, the kernel's arithmetic: x [B, 4D] the projected
    input, hw = hp @ W, bias [4D] or None, hp / cp the carries, m [B, 1].
    Returns (h, c, gates [i, f, g, o]) in ``dtype``."""
    ga, ca, na = acts
    d = hp.shape[-1]
    a = x.float() + hw.float()
    if bias is not None:
        a = a + bias.float().reshape(1, -1)
    ai, af, ag, ao = a.split(d, dim=-1)
    i, f, o = (_rnd(_act(ga, v), dtype) for v in (ai, af, ao))
    g = _rnd(_act(na, ag), dtype)
    hpf, cpf = hp.float(), cp.float()
    cn = _rnd(f * cpf + i * g, dtype)
    hn = o * _act(ca, cn)
    h = m * hn + (1.0 - m) * hpf
    c = m * cn + (1.0 - m) * cpf
    return h.to(dtype), c.to(dtype), torch.cat([i, f, g, o], -1).to(dtype)


def lstm_cell_reference_bwd(dh_out, dc_out, dh_mm, dh_pass, dc_carry, gates,
                            c, cp, m, acts, dtype):
    """One LSTM step's backward, the kernel's arithmetic. dh_out / dc_out:
    the outputs' gradients (None: zero); dh_mm: the later step's
    dgates @ W^T (None: zero); dh_pass, dc_carry: the fp32 carries.
    Returns (dgates in ``dtype``, dh_pass, dc_carry) with the new fp32
    carries."""
    ga, ca, na = acts
    d = c.shape[-1]
    zero = torch.zeros_like(dh_pass)
    dh = (zero if dh_out is None else dh_out.float()) + \
        (zero if dh_mm is None else dh_mm.float()) + dh_pass
    dc = (zero if dc_out is None else dc_out.float()) + dc_carry
    gi, gf, gg, go = gates.float().split(d, dim=-1)
    dhn = m * dh
    ac = _act(ca, c.float())
    dcn = m * dc + dhn * go * _dact(ca, ac)
    dcp = dcn * gf + (1.0 - m) * dc
    da = torch.cat([dcn * gg * _dact(ga, gi), dcn * cp.float() * _dact(ga, gf),
                    dcn * gi * _dact(na, gg), dhn * ac * _dact(ga, go)], -1)
    return da.to(dtype), (1.0 - m) * dh, dcp


def gru_cell_reference(phase, x, bias, mm, hp, gates, m, acts, dtype):
    """One GRU step's phase, the kernel's arithmetic. Phase 0: mm = hp @
    W[:, :2D]; returns (u and r [B, 2D], r * hp). Phase 1: mm = (r * hp) @
    W[:, 2D:], gates holds u; returns (c, h). All in ``dtype``."""
    ga, na = acts
    d = hp.shape[-1]
    xb = x.float()
    if bias is not None:
        xb = xb + bias.float().reshape(1, -1)
    hpf = hp.float()
    if phase == 0:
        ur = _rnd(_act(ga, xb[:, :2 * d] + mm.float()), dtype)
        return ur.to(dtype), (ur[:, d:] * hpf).to(dtype)
    c = _rnd(_act(na, xb[:, 2 * d:] + mm.float()), dtype)
    u = gates[:, :d].float()
    h = m * (u * hpf + (1.0 - u) * c) + (1.0 - m) * hpf
    return c.to(dtype), h.to(dtype)


def gru_cell_reference_bwd(phase, dh_out, mm, dhc, gates, hp, m, acts,
                           dtype):
    """One GRU step's backward phase, the kernel's arithmetic. Phase 0:
    dh_out (None: zero), mm = the later step's (da_u, da_r) @ W[:, :2D]^T
    (None: zero); returns ((da_u, da_c) in ``dtype``, the fp32 carry).
    Phase 1: mm = drh; returns (da_r, the carry)."""
    ga, na = acts
    d = hp.shape[-1]
    hpf = hp.float()
    g = gates.float()
    zero = torch.zeros_like(dhc)
    dmm = zero if mm is None else mm.float()
    if phase == 0:
        u, c = g[:, :d], g[:, 2 * d:]
        dh = (zero if dh_out is None else dh_out.float()) + dmm + dhc
        dhn = m * dh
        du = dhn * (hpf - c) * _dact(ga, u)
        dc = dhn * (1.0 - u) * _dact(na, c)
        return (du.to(dtype), dc.to(dtype)), (1.0 - m) * dh + dhn * u
    r = g[:, d:2 * d]
    return (dmm * hpf * _dact(ga, r)).to(dtype), dhc + dmm * r


# ------------------------------------------------------------- the wrappers
def _check(what, dtype, device, rows, tensors):
    """Each tensor (None allowed): on ``device``, of ``dtype``, ``rows``
    rows and its last dim contiguous."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError('%s kernel: float32 or bfloat16, got %s'
                        % (what, dtype))
    for name, t in tensors:
        if t is None:
            continue
        if t.device != device or t.dtype != dtype or t.shape[0] != rows or \
                t.stride(-1) != 1:
            raise ValueError(
                '%s kernel: %s must be a %s tensor on %s with %d rows and a '
                'contiguous last dim, got %s %s on %s strides %s'
                % (what, name, dtype, device, rows, t.dtype, tuple(t.shape),
                   t.device, tuple(t.stride())))


def _stride(t):
    return 0 if t is None else t.stride(0)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _lengths(length, device, rows):
    if length is None:
        return None
    if length.device != device or length.dtype != torch.int32 or \
            length.numel() != rows or not length.is_contiguous():
        raise ValueError('rnn cell kernel: lengths must be a contiguous int32 '
                         '[%d] tensor on %s, got %s %s on %s'
                         % (rows, device, length.dtype,
                            tuple(length.shape), length.device))
    return length


def _fp32(what, device, rows, d, tensors):
    for name, t in tensors:
        if t.device != device or t.dtype != torch.float32 or \
                tuple(t.shape) != (rows, d) or not t.is_contiguous():
            raise ValueError('%s kernel: %s must be a contiguous float32 '
                             '[%d, %d] tensor on %s' % (what, name, rows, d,
                                                        device))


def _lstm_cell_fwd_plain(x, hw, bias, hp, cp, length, pos, h, c, gates,
                         acts):
    m = step_mask(length, pos, hp.shape[0], x.device)
    outs = lstm_cell_reference(x, hw, bias, hp, cp, m, acts, x.dtype)
    for out, v in zip((h, c, gates), outs):
        out.copy_(v)


def _lstm_cell_bwd_plain(dh_out, dc_out, dh_mm, dh_pass, dc_carry, gates, c,
                         cp, length, pos, dg, acts):
    m = step_mask(length, pos, c.shape[0], c.device)
    da, hp_new, cc_new = lstm_cell_reference_bwd(
        dh_out, dc_out, dh_mm, dh_pass, dc_carry, gates, c, cp, m, acts,
        c.dtype)
    dg.copy_(da)
    dh_pass.copy_(hp_new)
    dc_carry.copy_(cc_new)


def lstm_cell_fwd(x, hw, bias, hp, cp, length, pos, h, c, gates, acts):
    """One LSTM step at position ``pos``: writes h, c and the activated
    gates (views [B, D], [B, D], [B, 4D] of the sequence tensors). x:
    the projected input at pos [B, 4D]; hw = hp @ W; bias [4D] or None;
    length int32 [B] or None; acts the (gate, cell, candidate) codes."""
    b, d = hp.shape
    if x.device.type == 'cpu':
        _lstm_cell_fwd_plain(x, hw, bias, hp, cp, length, pos, h, c, gates,
                             acts)
        return
    _check('lstm_cell', x.dtype, x.device, b,
           [('x', x), ('hw', hw), ('hp', hp), ('cp', cp), ('h', h),
            ('c', c), ('gates', gates)])
    if hw.stride(0) != 4 * d or h.stride(0) != c.stride(0) or \
            (bias is not None and not bias.is_contiguous()):
        raise ValueError('lstm_cell kernel: hw [B, 4D] and bias must be '
                         'contiguous, h and c share a row stride')
    length = _lengths(length, x.device, b)
    if b == 0 or d == 0:
        return
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ptt_lstm_cell_fwd(
            x.data_ptr(), x.stride(0), hw.data_ptr(), _ptr(bias),
            hp.data_ptr(), hp.stride(0), cp.data_ptr(), cp.stride(0),
            _ptr(length), int(pos), h.data_ptr(), c.data_ptr(),
            h.stride(0), gates.data_ptr(), gates.stride(0), b, d,
            build.dtype_code(x.dtype), *acts, stream)
    build.check(rc, 'ptt_lstm_cell_fwd')
    lstm_cell_fwd.launches += 1


def lstm_cell_bwd(dh_out, dc_out, dh_mm, dh_pass, dc_carry, gates, c, cp,
                  length, pos, dg, acts):
    """One LSTM step's backward at ``pos``: writes dg (the pre-activations'
    gradient, a [B, 4D] view) and updates the fp32 carries dh_pass and
    dc_carry [B, D] in place. dh_out / dc_out: the outputs' gradients at
    pos (None: zero); dh_mm: the later step's dgates @ W^T (None: zero)."""
    b, d = c.shape
    if c.device.type == 'cpu':
        _lstm_cell_bwd_plain(dh_out, dc_out, dh_mm, dh_pass, dc_carry, gates,
                             c, cp, length, pos, dg, acts)
        return
    _check('lstm_cell_bwd', c.dtype, c.device, b,
           [('dh_out', dh_out), ('dc_out', dc_out), ('dh_mm', dh_mm),
            ('gates', gates), ('c', c), ('cp', cp), ('dg', dg)])
    _fp32('lstm_cell_bwd', c.device, b, d, [('dh_pass', dh_pass),
                                            ('dc_carry', dc_carry)])
    if dh_mm is not None and not dh_mm.is_contiguous():
        raise ValueError('lstm_cell_bwd kernel: dh_mm must be contiguous')
    length = _lengths(length, c.device, b)
    if b == 0 or d == 0:
        return
    lib = build.library()
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        rc = lib.ptt_lstm_cell_bwd(
            _ptr(dh_out), _stride(dh_out), _ptr(dc_out), _stride(dc_out),
            _ptr(dh_mm), dh_pass.data_ptr(), dc_carry.data_ptr(),
            gates.data_ptr(), gates.stride(0), c.data_ptr(), c.stride(0),
            cp.data_ptr(), cp.stride(0), _ptr(length), int(pos),
            dg.data_ptr(), dg.stride(0), b, d, build.dtype_code(c.dtype),
            *acts, stream)
    build.check(rc, 'ptt_lstm_cell_bwd')
    lstm_cell_bwd.launches += 1


def _gru_cell_fwd_plain(phase, x, bias, mm, hp, length, pos, gates, out,
                        acts):
    b, d = hp.shape
    m = step_mask(length, pos, b, x.device)
    first, second = gru_cell_reference(phase, x, bias, mm, hp, gates, m, acts,
                                       x.dtype)
    if phase == 0:
        gates[:, :2 * d].copy_(first)
    else:
        gates[:, 2 * d:].copy_(first)
    out.copy_(second)


def _gru_cell_bwd_plain(phase, dh_out, mm, dhc, gates, hp, length, pos, dg,
                        acts):
    b, d = hp.shape
    m = step_mask(length, pos, b, hp.device)
    da, carry = gru_cell_reference_bwd(phase, dh_out, mm, dhc, gates, hp, m,
                                       acts, hp.dtype)
    if phase == 0:
        dg[:, :d].copy_(da[0])
        dg[:, 2 * d:].copy_(da[1])
    else:
        dg[:, d:2 * d].copy_(da)
    dhc.copy_(carry)


def gru_cell_fwd(phase, x, bias, mm, hp, length, pos, gates, out, acts):
    """One GRU step's phase at ``pos``. Phase 0: mm = hp @ W[:, :2D]
    ([B, 2D]); writes u, r into gates and r * hp into out. Phase 1: mm =
    (r * hp) @ W[:, 2D:] ([B, D]); writes c into gates and h into out. x:
    the projected input at pos [B, 3D]; gates: a [B, 3D] view; acts the
    (gate, candidate) codes."""
    b, d = hp.shape
    if x.device.type == 'cpu':
        _gru_cell_fwd_plain(phase, x, bias, mm, hp, length, pos, gates, out,
                            acts)
        return
    _check('gru_cell', x.dtype, x.device, b,
           [('x', x), ('mm', mm), ('hp', hp), ('gates', gates),
            ('out', out)])
    if not mm.is_contiguous() or (bias is not None and
                                  not bias.is_contiguous()):
        raise ValueError('gru_cell kernel: mm and bias must be contiguous')
    length = _lengths(length, x.device, b)
    if b == 0 or d == 0:
        return
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ptt_gru_cell_fwd(
            int(phase), x.data_ptr(), x.stride(0), _ptr(bias), mm.data_ptr(),
            hp.data_ptr(), hp.stride(0), _ptr(length), int(pos),
            gates.data_ptr(), gates.stride(0), out.data_ptr(), out.stride(0),
            b, d, build.dtype_code(x.dtype), *acts, stream)
    build.check(rc, 'ptt_gru_cell_fwd')
    gru_cell_fwd.launches += 1


def gru_cell_bwd(phase, dh_out, mm, dhc, gates, hp, length, pos, dg, acts):
    """One GRU step's backward phase at ``pos``: phase 0 writes da_u and
    da_c into dg (a [B, 3D] view) and sets the fp32 carry dhc [B, D];
    phase 1 (mm = drh) writes da_r and adds to dhc. dh_out: the output's
    gradient at pos (phase 0; None: zero); mm None: zero."""
    b, d = hp.shape
    if hp.device.type == 'cpu':
        _gru_cell_bwd_plain(phase, dh_out, mm, dhc, gates, hp, length, pos,
                            dg, acts)
        return
    _check('gru_cell_bwd', hp.dtype, hp.device, b,
           [('dh_out', dh_out), ('mm', mm), ('gates', gates), ('hp', hp),
            ('dg', dg)])
    _fp32('gru_cell_bwd', hp.device, b, d, [('dhc', dhc)])
    if mm is not None and not mm.is_contiguous():
        raise ValueError('gru_cell_bwd kernel: mm must be contiguous')
    length = _lengths(length, hp.device, b)
    if b == 0 or d == 0:
        return
    lib = build.library()
    with torch.cuda.device(hp.device):
        stream = torch.cuda.current_stream(hp.device).cuda_stream
        rc = lib.ptt_gru_cell_bwd(
            int(phase), _ptr(dh_out), _stride(dh_out), _ptr(mm),
            dhc.data_ptr(), gates.data_ptr(), gates.stride(0), hp.data_ptr(),
            hp.stride(0), _ptr(length), int(pos), dg.data_ptr(),
            dg.stride(0), b, d, build.dtype_code(hp.dtype), *acts, stream)
    build.check(rc, 'ptt_gru_cell_bwd')
    gru_cell_bwd.launches += 1


lstm_cell_fwd.launches = 0
lstm_cell_bwd.launches = 0
gru_cell_fwd.launches = 0    # two a step: phase 0 and phase 1
gru_cell_bwd.launches = 0    # two a step


# ------------------------------------------------------------ recurrences
def positions(t, reverse):
    """The positions in the order the recurrence visits them."""
    return list(range(t - 1, -1, -1)) if reverse else list(range(t))


def _previous(h0, seq, reverse):
    """[B, T, D]: the carry each position read, h0 at the first."""
    if seq.shape[1] == 0:
        return seq
    if reverse:
        return torch.cat([seq[:, 1:], h0[:, None]], 1)
    return torch.cat([h0[:, None], seq[:, :-1]], 1)


def lstm_positions_fwd(x, w, bias, h0, c0, length, acts, reverse,
                       plain=False):
    """The LSTM forward a position at a time: ``torch.mm(hp, w)`` then a
    cell, T times. ``plain``: the plain cell (``lstm_cell_reference``),
    else ``lstm_cell_fwd`` (its kernel on a CUDA tensor). Returns (hidden,
    cell, gates) [B, T, D], [B, T, D], [B, T, 4D] in x's dtype."""
    b, t, d4 = x.shape
    step = _lstm_cell_fwd_plain if plain else lstm_cell_fwd
    hidden = x.new_empty((b, t, d4 // 4))
    cell = x.new_empty((b, t, d4 // 4))
    gates = x.new_empty((b, t, d4))
    hw = x.new_empty((b, d4))
    hp, cp = h0, c0
    for p in positions(t, reverse):
        torch.mm(hp, w, out=hw)
        step(x[:, p], hw, bias, hp, cp, length, p, hidden[:, p], cell[:, p],
             gates[:, p], acts)
        hp, cp = hidden[:, p], cell[:, p]
    return hidden, cell, gates


def lstm_positions_bwd(dhidden, dcell, w, gates, cell, c0, length, acts,
                       reverse, plain=False):
    """The LSTM backward a position at a time, in reverse order: a cell then
    ``torch.mm(dgates, w.t())`` for the earlier position. dhidden / dcell
    [B, T, D] or None (zero); gates and cell the forward's. Returns (dx
    [B, T, 4D], dh0, dc0) in the dtype, dh0 = the first position's dgates
    @ W^T + the fp32 carry."""
    b, t, d = cell.shape
    step = _lstm_cell_bwd_plain if plain else lstm_cell_bwd
    dx = torch.empty_like(gates)
    dh_pass = torch.zeros((b, d), dtype=torch.float32, device=cell.device)
    dc_carry = torch.zeros_like(dh_pass)
    order = positions(t, reverse)
    wt = w.t()
    buf = cell.new_empty((b, d))
    dh_mm = None
    for k in range(t - 1, -1, -1):
        p = order[k]
        cp = c0 if k == 0 else cell[:, order[k - 1]]
        step(None if dhidden is None else dhidden[:, p],
             None if dcell is None else dcell[:, p], dh_mm, dh_pass,
             dc_carry, gates[:, p], cell[:, p], cp, length, p, dx[:, p],
             acts)
        torch.mm(dx[:, p], wt, out=buf)
        dh_mm = buf
    dh0 = dh_pass if dh_mm is None else dh_mm.float() + dh_pass
    return dx, dh0.to(cell.dtype), dc_carry.to(cell.dtype)


def lstm_seq_fwd_reference(x, w, bias, h0, c0, length, acts, reverse):
    """``lstm_seq_fwd``'s plain version: the positions with plain cells."""
    return lstm_positions_fwd(x, w, bias, h0, c0, length, acts, reverse,
                              plain=True)


def lstm_seq_bwd_reference(dhidden, dcell, w, gates, cell, c0, length, acts,
                           reverse):
    """``lstm_seq_bwd``'s plain version: the positions with plain cells."""
    return lstm_positions_bwd(dhidden, dcell, w, gates, cell, c0, length,
                              acts, reverse, plain=True)


def gru_positions_fwd(x, w, bias, h0, length, acts, reverse, plain=False):
    """The GRU forward a position at a time: ``torch.mm(hp, w[:, :2D])``,
    the cell's phase 0, ``torch.mm(r * hp, w[:, 2D:])``, its phase 1, T
    times. ``plain``: the plain cell (``gru_cell_reference``), else
    ``gru_cell_fwd`` (its kernel on a CUDA tensor). Returns (hidden, gates,
    rh) [B, T, D], [B, T, 3D], [B, T, D] in x's dtype."""
    b, t, d3 = x.shape
    d = d3 // 3
    step = _gru_cell_fwd_plain if plain else gru_cell_fwd
    hidden = x.new_empty((b, t, d))
    gates = x.new_empty((b, t, d3))
    rh = x.new_empty((b, t, d))
    w_ur, w_c = w[:, :2 * d], w[:, 2 * d:]
    mm_ur = x.new_empty((b, 2 * d))
    mm_c = x.new_empty((b, d))
    hp = h0
    for p in positions(t, reverse):
        torch.mm(hp, w_ur, out=mm_ur)
        step(0, x[:, p], bias, mm_ur, hp, length, p, gates[:, p], rh[:, p],
             acts)
        torch.mm(rh[:, p], w_c, out=mm_c)
        step(1, x[:, p], bias, mm_c, hp, length, p, gates[:, p],
             hidden[:, p], acts)
        hp = hidden[:, p]
    return hidden, gates, rh


def gru_positions_bwd(dhidden, w, gates, hidden, h0, length, acts, reverse,
                      plain=False):
    """The GRU backward a position at a time, in reverse order: the cell's
    phase 0, ``drh = torch.mm(da_c, w[:, 2D:].t())``, its phase 1, then
    ``g1 = torch.mm((da_u, da_r), w[:, :2D].t())`` for the earlier
    position. dhidden [B, T, D] or None (zero); gates and hidden the
    forward's. Returns (dx [B, T, 3D], dh0) in the dtype, dh0 = the first
    position's g1 + the fp32 carry."""
    b, t, d = hidden.shape
    step = _gru_cell_bwd_plain if plain else gru_cell_bwd
    dx = torch.empty_like(gates)
    dhc = torch.zeros((b, d), dtype=torch.float32, device=hidden.device)
    order = positions(t, reverse)
    wt_ur, wt_c = w[:, :2 * d].t(), w[:, 2 * d:].t()
    drh = hidden.new_empty((b, d))
    buf = hidden.new_empty((b, d))
    g1 = None
    for k in range(t - 1, -1, -1):
        p = order[k]
        hp = h0 if k == 0 else hidden[:, order[k - 1]]
        step(0, None if dhidden is None else dhidden[:, p], g1, dhc,
             gates[:, p], hp, length, p, dx[:, p], acts)
        torch.mm(dx[:, p, 2 * d:], wt_c, out=drh)
        step(1, None, drh, dhc, gates[:, p], hp, length, p, dx[:, p], acts)
        torch.mm(dx[:, p, :2 * d], wt_ur, out=buf)
        g1 = buf
    dh0 = dhc if g1 is None else g1.float() + dhc
    return dx, dh0.to(hidden.dtype)


def gru_seq_fwd_reference(x, w, bias, h0, length, acts, reverse):
    """``gru_seq_fwd``'s plain version: the positions with plain cells."""
    return gru_positions_fwd(x, w, bias, h0, length, acts, reverse,
                             plain=True)


def gru_seq_bwd_reference(dhidden, w, gates, hidden, h0, length, acts,
                          reverse):
    """``gru_seq_bwd``'s plain version: the positions with plain cells."""
    return gru_positions_bwd(dhidden, w, gates, hidden, h0, length, acts,
                             reverse, plain=True)


SEQ_ROWS = 16             # batch rows a cluster (an mma's m16)
SEQ_THREADS = 256         # a CTA
SEQ_MAX_UNITS = 64        # a CTA's cells, 16 x units, 4 a thread at most
SEQ_MAX_CLUSTER = 8       # the portable cluster size
SEQ_SMEM_LIMIT = 232448   # 227 KB of shared memory a block on the H100


def _up(v, m):
    return -(-v // m) * m


def _seq_plan(batch, d, dtype, smem):
    """A sequence kernel's launch for hidden ``d`` in ``dtype``, or None:
    C <= 8 CTAs of ``units`` (a multiple of 8, at most 64) cover d;
    ``smem(units, bf16)`` gives the forward's and backward's shared memory
    bytes a CTA, which must fit 227 KB."""
    if d < 1 or dtype not in (torch.float32, torch.bfloat16):
        return None
    units = _up(-(-d // SEQ_MAX_CLUSTER), 8)
    if units > SEQ_MAX_UNITS:
        return None
    fwd, bwd = smem(units, dtype == torch.bfloat16)
    if max(fwd, bwd) > SEQ_SMEM_LIMIT:
        return None
    cluster = -(-d // units)
    return dict(rows=SEQ_ROWS, cluster=cluster, units=units,
                threads=SEQ_THREADS, smem_fwd=fwd, smem_bwd=bwd,
                grid=cluster * -(-batch // SEQ_ROWS))


def lstm_seq_plan(batch, d, dtype):
    """The LSTM sequence kernels' launch for a [batch, T, 4d] recurrence in
    ``dtype``, or None where W's slices do not fit a cluster's shared memory
    (or the dtype is neither float32 nor bfloat16): {'rows', 'cluster',
    'units', 'threads', 'smem_fwd', 'smem_bwd', 'grid'}. A cluster of
    ``cluster`` CTAs (at most 8) owns 16 rows; a CTA of 256 threads owns
    ``units`` hidden units (a multiple of 8, at most 64), a warp the
    product of 8 of them, every thread the cells of one (row, unit) (four
    at 64 units). The bytes are csrc/lstm_seq.cu's layout: forward W's
    gate columns of the CTA's units and two h buffers [16, D]; backward W's
    rows of its units and two dgates buffers [16, 4D] (each gate block
    rounded up to an even width); bf16 rows padded by 8 elements, fp32 by
    4; the product staged in fp32 for the cells ([16, 4 units] forward,
    [16, units] backward); the buffers' two mbarriers."""
    def smem(units, bf16):
        kf, kb = _up(d, 16), _up(4 * _up(d, 2), 64)
        if bf16:
            fwd = (4 * units + 2 * SEQ_ROWS) * (kf + 8) * 2
            bwd = (units + 2 * SEQ_ROWS) * (kb + 8) * 2
        else:
            fwd = (kf * 4 * units + 2 * SEQ_ROWS * (kf + 4)) * 4
            bwd = (kb * units + 2 * SEQ_ROWS * (kb + 4)) * 4
        return (fwd + 4 * SEQ_ROWS * 4 * units + 16,
                bwd + 4 * SEQ_ROWS * units + 16)
    return _seq_plan(batch, d, dtype, smem)


def gru_seq_plan(batch, d, dtype):
    """The GRU sequence kernels' launch for a [batch, T, 3d] recurrence in
    ``dtype``, or None, as ``lstm_seq_plan`` (the same geometry). The bytes
    are csrc/gru_seq.cu's layout, each gate block d rounded up to 16:
    forward W's u, r and c columns of the CTA's units and four buffers
    [16, d] (h and r * h_prev, each double-buffered); backward W's rows of
    its units and two buffers [16, 3d] (da_u, da_r, da_c); bf16 rows padded
    by 8 elements, fp32 by 4; the products staged in fp32 ([16, 2 units]
    forward, [16, units] backward); four mbarriers."""
    def smem(units, bf16):
        dk = _up(d, 16)
        if bf16:
            fwd = (3 * units + 4 * SEQ_ROWS) * (dk + 8) * 2
            bwd = (units + 2 * SEQ_ROWS) * (3 * dk + 8) * 2
        else:
            fwd = (dk * 3 * units + 4 * SEQ_ROWS * (dk + 4)) * 4
            bwd = (3 * dk * units + 2 * SEQ_ROWS * (3 * dk + 4)) * 4
        return (fwd + 4 * SEQ_ROWS * 2 * units + 32,
                bwd + 4 * SEQ_ROWS * units + 32)
    return _seq_plan(batch, d, dtype, smem)


WIDE_UNITS = (8, 16, 32, 64)  # a CTA's units on the wide plan
WIDE_MAX_GRID = 132           # the H100 SXM's SMs: at most one CTA an SM


def gru_wide_plan(batch, d, dtype):
    """The wide GRU kernels' launch (csrc/gru_wide.cu) for a [batch, T, 3d]
    recurrence in ``dtype``, or None: {'rows', 'groups', 'units',
    'slices', 'cluster', 'threads', 'smem_fwd', 'smem_bwd', 'grid'}. A CTA
    of 256 threads owns 16 rows (one of ``groups`` row groups) and
    ``units`` hidden units (the fewest of 8, 16, 32 or 64 with which the
    grid of ``groups`` x ``slices`` CTAs, slices = ceil(d / units), stays
    within one CTA an SM), launched cooperatively in clusters of
    ``cluster`` CTAs: 2 where slices is even and a row of d is 16-byte
    aligned (each CTA of the pair copies half the staged rows into both),
    else 1. The bytes a CTA are csrc/gru_wide.cu's layout, each gate block
    d rounded up to dk = d rounded up to 16: forward W's u, r and c
    columns of its units (bf16 [3 units][dk + 8], fp32 [dk][3 units]) and
    one staging buffer [16, dk] (bf16 rows padded by 8 elements, fp32 by
    4); backward W's rows of its units (bf16 [units][3 dk + 8], fp32 [3
    dk][units]) and one buffer [16, 2 dk] padded alike; then the widest
    product's fp32 pieces [slice][16][n] (n = 2 units forward, units
    backward; max(8, n / 8) slices x 8 columns) and one mbarrier (16
    bytes). None where either direction exceeds 227
    KB, no unit count keeps the grid within 132 CTAs, or the dtype is
    neither float32 nor bfloat16."""
    if batch < 1 or d < 1 or dtype not in (torch.float32, torch.bfloat16):
        return None
    groups = -(-batch // SEQ_ROWS)
    for units in WIDE_UNITS:
        slices = -(-d // units)
        if groups * slices <= WIDE_MAX_GRID:
            break
    else:
        return None
    bf16 = dtype == torch.bfloat16
    dk = _up(d, 16)

    def parts(n):
        return 4 * SEQ_ROWS * 8 * max(8, n // 8)
    if bf16:
        fwd = (3 * units + SEQ_ROWS) * (dk + 8) * 2
        bwd = (units * (3 * dk + 8) + SEQ_ROWS * (2 * dk + 8)) * 2
    else:
        fwd = (dk * 3 * units + SEQ_ROWS * (dk + 4)) * 4
        bwd = (3 * dk * units + SEQ_ROWS * (2 * dk + 4)) * 4
    fwd += parts(2 * units) + 16
    bwd += parts(units) + 16
    if max(fwd, bwd) > SEQ_SMEM_LIMIT:
        return None
    cluster = 2 if slices % 2 == 0 and d * (2 if bf16 else 4) % 16 == 0 \
        else 1
    return dict(rows=SEQ_ROWS, groups=groups, units=units, slices=slices,
                cluster=cluster, threads=SEQ_THREADS, smem_fwd=fwd,
                smem_bwd=bwd, grid=groups * slices)


def _need_plan(what, plan_of, dtype, b, d):
    plan = plan_of(b, d, dtype)
    if plan is None:
        raise ValueError('%s kernel: no launch plan for batch %d, hidden %d '
                         'in %s (W\'s slices and the staged rows exceed '
                         'the shared memory it spreads them over); another '
                         'path takes it' % (what, b, d, dtype))
    return plan


def _contiguous(what, dtype, device, tensors):
    for name, t, shape in tensors:
        if t is None:
            continue
        if t.device != device or t.dtype != dtype or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError('%s kernel: %s must be a contiguous %s %s tensor '
                             'on %s, got %s %s on %s'
                             % (what, name, dtype, shape, device, t.dtype,
                                tuple(t.shape), t.device))


def lstm_seq_fwd(x, w, bias, h0, c0, length, acts, reverse):
    """The whole LSTM forward in one launch: x [B, T, 4D] (projected, last
    dim contiguous), w [D, 4D], bias [4D] or None, h0 / c0 [B, D], length
    int32 [B] or None, acts the (gate, cell, candidate) codes, reverse.
    Returns (hidden, cell, gates) as ``lstm_seq_fwd_reference``. A CUDA
    tensor needs ``lstm_seq_plan``'s launch, else this raises."""
    if x.device.type == 'cpu':
        return lstm_seq_fwd_reference(x, w, bias, h0, c0, length, acts,
                                      reverse)
    b, t, d4 = x.shape
    d = d4 // 4
    _check('lstm_seq', x.dtype, x.device, b, [('x', x), ('h0', h0),
                                               ('c0', c0)])
    plan = _need_plan('lstm_seq', lstm_seq_plan, x.dtype, b, d)
    _contiguous('lstm_seq', x.dtype, x.device,
                [('w', w, (d, d4)), ('bias', bias, (d4,))])
    length = _lengths(length, x.device, b)
    hidden = x.new_empty((b, t, d))
    cell = x.new_empty((b, t, d))
    gates = x.new_empty((b, t, d4))
    if b == 0 or t == 0:
        return hidden, cell, gates
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ptt_lstm_seq_fwd(
            x.data_ptr(), x.stride(0), x.stride(1), w.data_ptr(), _ptr(bias),
            h0.data_ptr(), h0.stride(0), c0.data_ptr(), c0.stride(0),
            _ptr(length), hidden.data_ptr(), cell.data_ptr(),
            gates.data_ptr(), b, t, d, plan['cluster'], plan['units'],
            int(bool(reverse)), build.dtype_code(x.dtype), *acts, stream)
    build.check(rc, 'ptt_lstm_seq_fwd')
    lstm_seq_fwd.launches += 1
    return hidden, cell, gates


def lstm_seq_bwd(dhidden, dcell, w, gates, cell, c0, length, acts, reverse):
    """The whole LSTM backward in one launch, positions in reverse order:
    dhidden / dcell [B, T, D] or None (zero), w [D, 4D], gates [B, T, 4D]
    and cell [B, T, D] the forward's, c0 [B, D]. Returns (dx [B, T, 4D],
    dh0, dc0) as ``lstm_seq_bwd_reference``; dh0 is the kernel's dh_mm of
    the first position plus its fp32 carry, as there. A CUDA tensor needs
    ``lstm_seq_plan``'s launch, else this raises."""
    if cell.device.type == 'cpu':
        return lstm_seq_bwd_reference(dhidden, dcell, w, gates, cell, c0,
                                      length, acts, reverse)
    b, t, d = cell.shape
    dt, dev = cell.dtype, cell.device
    _check('lstm_seq_bwd', dt, dev, b, [('c0', c0)])
    plan = _need_plan('lstm_seq_bwd', lstm_seq_plan, dt, b, d)
    _contiguous('lstm_seq_bwd', dt, dev,
                [('dhidden', dhidden, (b, t, d)), ('dcell', dcell, (b, t, d)),
                 ('w', w, (d, 4 * d)), ('gates', gates, (b, t, 4 * d)),
                 ('cell', cell, (b, t, d))])
    length = _lengths(length, dev, b)
    dx = torch.empty_like(gates)
    dh_mm = cell.new_zeros((b, d))
    dh_pass = torch.zeros((b, d), dtype=torch.float32, device=dev)
    dc_carry = torch.zeros_like(dh_pass)
    if b > 0 and t > 0:
        lib = build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.ptt_lstm_seq_bwd(
                _ptr(dhidden), _ptr(dcell), w.data_ptr(), gates.data_ptr(),
                cell.data_ptr(), c0.data_ptr(), c0.stride(0), _ptr(length),
                dx.data_ptr(), dh_mm.data_ptr(), dh_pass.data_ptr(),
                dc_carry.data_ptr(), b, t, d, plan['cluster'],
                plan['units'], int(bool(reverse)), build.dtype_code(dt),
                *acts, stream)
        build.check(rc, 'ptt_lstm_seq_bwd')
        lstm_seq_bwd.launches += 1
        dh0 = dh_mm.float() + dh_pass
    else:
        dh0 = dh_pass
    return dx, dh0.to(dt), dc_carry.to(dt)


lstm_seq_fwd.launches = 0
lstm_seq_bwd.launches = 0


def gru_seq_fwd(x, w, bias, h0, length, acts, reverse):
    """The whole GRU forward in one launch: x [B, T, 3D] (projected, last
    dim contiguous), w [D, 3D], bias [3D] or None, h0 [B, D], length int32
    [B] or None, acts the (gate, candidate) codes, reverse. Returns
    (hidden, gates, rh) as ``gru_seq_fwd_reference``. A CUDA tensor needs
    ``gru_seq_plan``'s launch, else this raises."""
    if x.device.type == 'cpu':
        return gru_seq_fwd_reference(x, w, bias, h0, length, acts, reverse)
    b, t, d3 = x.shape
    d = d3 // 3
    _check('gru_seq', x.dtype, x.device, b, [('x', x), ('h0', h0)])
    plan = _need_plan('gru_seq', gru_seq_plan, x.dtype, b, d)
    _contiguous('gru_seq', x.dtype, x.device,
                [('w', w, (d, d3)), ('bias', bias, (d3,))])
    length = _lengths(length, x.device, b)
    hidden = x.new_empty((b, t, d))
    gates = x.new_empty((b, t, d3))
    rh = x.new_empty((b, t, d))
    if b == 0 or t == 0:
        return hidden, gates, rh
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ptt_gru_seq_fwd(
            x.data_ptr(), x.stride(0), x.stride(1), w.data_ptr(), _ptr(bias),
            h0.data_ptr(), h0.stride(0), _ptr(length), hidden.data_ptr(),
            gates.data_ptr(), rh.data_ptr(), b, t, d, plan['cluster'],
            plan['units'], int(bool(reverse)), build.dtype_code(x.dtype),
            *acts, stream)
    build.check(rc, 'ptt_gru_seq_fwd')
    gru_seq_fwd.launches += 1
    return hidden, gates, rh


def gru_seq_bwd(dhidden, w, gates, hidden, h0, length, acts, reverse):
    """The whole GRU backward in one launch, positions in reverse order:
    dhidden [B, T, D] or None (zero), w [D, 3D], gates [B, T, 3D] and
    hidden [B, T, D] the forward's, h0 [B, D]. Returns (dx [B, T, 3D],
    dh0) as ``gru_seq_bwd_reference``; dh0 is the kernel's g1 of the first
    position plus its fp32 carry, as there. A CUDA tensor needs
    ``gru_seq_plan``'s launch, else this raises."""
    if hidden.device.type == 'cpu':
        return gru_seq_bwd_reference(dhidden, w, gates, hidden, h0, length,
                                     acts, reverse)
    b, t, d = hidden.shape
    dt, dev = hidden.dtype, hidden.device
    _check('gru_seq_bwd', dt, dev, b, [('h0', h0)])
    plan = _need_plan('gru_seq_bwd', gru_seq_plan, dt, b, d)
    _contiguous('gru_seq_bwd', dt, dev,
                [('dhidden', dhidden, (b, t, d)), ('w', w, (d, 3 * d)),
                 ('gates', gates, (b, t, 3 * d)),
                 ('hidden', hidden, (b, t, d))])
    length = _lengths(length, dev, b)
    dx = torch.empty_like(gates)
    dh_mm = hidden.new_zeros((b, d))
    dhc = torch.zeros((b, d), dtype=torch.float32, device=dev)
    if b == 0 or t == 0:
        return dx, dhc.to(dt)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ptt_gru_seq_bwd(
            _ptr(dhidden), w.data_ptr(), gates.data_ptr(), hidden.data_ptr(),
            h0.data_ptr(), h0.stride(0), _ptr(length), dx.data_ptr(),
            dh_mm.data_ptr(), dhc.data_ptr(), b, t, d, plan['cluster'],
            plan['units'], int(bool(reverse)), build.dtype_code(dt), *acts,
            stream)
    build.check(rc, 'ptt_gru_seq_bwd')
    gru_seq_bwd.launches += 1
    return dx, (dh_mm.float() + dhc).to(dt)


gru_seq_fwd.launches = 0
gru_seq_bwd.launches = 0


def gru_wide_fwd(x, w, bias, h0, length, acts, reverse):
    """The whole GRU forward in one launch spread over the card (W's slices
    on every CTA of ``gru_wide_plan``, h and r * h_prev exchanged through
    L2): arguments and results as ``gru_seq_fwd``. A CUDA tensor needs
    ``gru_wide_plan``'s launch, else this raises."""
    if x.device.type == 'cpu':
        return gru_seq_fwd_reference(x, w, bias, h0, length, acts, reverse)
    b, t, d3 = x.shape
    d = d3 // 3
    _check('gru_wide', x.dtype, x.device, b, [('x', x), ('h0', h0)])
    plan = _need_plan('gru_wide', gru_wide_plan, x.dtype, b, d)
    _contiguous('gru_wide', x.dtype, x.device,
                [('w', w, (d, d3)), ('bias', bias, (d3,))])
    length = _lengths(length, x.device, b)
    hidden = x.new_empty((b, t, d))
    gates = x.new_empty((b, t, d3))
    rh = x.new_empty((b, t, d))
    if t == 0:
        return hidden, gates, rh
    # the row groups' arrival counters, zeroed on the stream (a memset in a
    # captured graph) before every launch
    count = torch.zeros(plan['groups'], dtype=torch.int32, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ptt_gru_wide_fwd(
            x.data_ptr(), x.stride(0), x.stride(1), w.data_ptr(), _ptr(bias),
            h0.data_ptr(), h0.stride(0), _ptr(length), hidden.data_ptr(),
            gates.data_ptr(), rh.data_ptr(), count.data_ptr(), b, t, d,
            plan['units'], plan['cluster'], int(bool(reverse)),
            build.dtype_code(x.dtype), *acts, stream)
    build.check(rc, 'ptt_gru_wide_fwd')
    gru_wide_fwd.launches += 1
    return hidden, gates, rh


def gru_wide_bwd(dhidden, w, gates, hidden, h0, length, acts, reverse):
    """The whole GRU backward in one launch spread over the card, positions
    in reverse order ((da_u, da_c), then da_r, exchanged through L2):
    arguments and results as ``gru_seq_bwd``. A CUDA tensor needs
    ``gru_wide_plan``'s launch, else this raises."""
    if hidden.device.type == 'cpu':
        return gru_seq_bwd_reference(dhidden, w, gates, hidden, h0, length,
                                     acts, reverse)
    b, t, d = hidden.shape
    dt, dev = hidden.dtype, hidden.device
    _check('gru_wide_bwd', dt, dev, b, [('h0', h0)])
    plan = _need_plan('gru_wide_bwd', gru_wide_plan, dt, b, d)
    _contiguous('gru_wide_bwd', dt, dev,
                [('dhidden', dhidden, (b, t, d)), ('w', w, (d, 3 * d)),
                 ('gates', gates, (b, t, 3 * d)),
                 ('hidden', hidden, (b, t, d))])
    length = _lengths(length, dev, b)
    dx = torch.empty_like(gates)
    dh_mm = hidden.new_zeros((b, d))
    dhc = torch.zeros((b, d), dtype=torch.float32, device=dev)
    if t == 0:
        return dx, dhc.to(dt)
    count = torch.zeros(plan['groups'], dtype=torch.int32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ptt_gru_wide_bwd(
            _ptr(dhidden), w.data_ptr(), gates.data_ptr(), hidden.data_ptr(),
            h0.data_ptr(), h0.stride(0), _ptr(length), dx.data_ptr(),
            dh_mm.data_ptr(), dhc.data_ptr(), count.data_ptr(), b, t, d,
            plan['units'], plan['cluster'], int(bool(reverse)),
            build.dtype_code(dt), *acts, stream)
    build.check(rc, 'ptt_gru_wide_bwd')
    gru_wide_bwd.launches += 1
    return dx, (dh_mm.float() + dhc).to(dt)


gru_wide_fwd.launches = 0
gru_wide_bwd.launches = 0


def gru_path(batch, d, dtype):
    """The card's path for a [batch, T, 3d] GRU recurrence in ``dtype``:
    'seq' where ``gru_seq_plan`` has a launch (W in one cluster), else
    'wide' where ``gru_wide_plan`` has one (W over the card), else 'cells'
    (the products and cell launches a position)."""
    if gru_seq_plan(batch, d, dtype) is not None:
        return 'seq'
    if gru_wide_plan(batch, d, dtype) is not None:
        return 'wide'
    return 'cells'


def _gru_path(h0):
    # a CPU tensor runs the plain versions, which the 'seq' wrappers take
    return 'seq' if h0.device.type == 'cpu' else gru_path(*h0.shape,
                                                          h0.dtype)


GRU_PATHS = {'seq': (gru_seq_fwd, gru_seq_bwd),
             'wide': (gru_wide_fwd, gru_wide_bwd),
             'cells': (gru_positions_fwd, gru_positions_bwd)}


def _lstm_per_position(h0):
    """True where a CUDA LSTM recurrence (h0 its [B, D] carry) has no
    ``lstm_seq_plan``."""
    return h0.device.type != 'cpu' and \
        lstm_seq_plan(h0.shape[0], h0.shape[1], h0.dtype) is None


class LstmRecurrence(torch.autograd.Function):
    """(hidden, cell) [B, T, D] of an LSTM over x [B, T, 4D] (projected),
    w [D, 4D], bias [4D] or None, h0 and c0 [B, D], length int32 [B] or
    None; every float tensor in one dtype. ``acts``: the (gate, cell,
    candidate) codes. On the card the sequence kernels run it where
    ``lstm_seq_plan`` has a launch, else the per-position path."""

    @staticmethod
    def forward(ctx, x, w, bias, h0, c0, length, acts, reverse):
        w = w.contiguous()
        args = (x, w, bias, h0, c0, length, acts, reverse)
        if _lstm_per_position(h0):
            hidden, cell, gates = lstm_positions_fwd(*args)
        else:
            hidden, cell, gates = lstm_seq_fwd(*args)
        ctx.save_for_backward(w, h0, c0, hidden, cell, gates, length)
        ctx.acts, ctx.reverse, ctx.has_bias = acts, reverse, bias is not None
        return hidden, cell

    @staticmethod
    def backward(ctx, dhidden, dcell):
        w, h0, c0, hidden, cell, gates, length = ctx.saved_tensors
        b, t, d = hidden.shape
        dhidden = None if dhidden is None else dhidden.contiguous()
        dcell = None if dcell is None else dcell.contiguous()
        args = (dhidden, dcell, w, gates, cell, c0, length, ctx.acts,
                ctx.reverse)
        if _lstm_per_position(h0):
            dx, dh0, dc0 = lstm_positions_bwd(*args)
        else:
            dx, dh0, dc0 = lstm_seq_bwd(*args)
        need = ctx.needs_input_grad
        dw = dbias = None
        if need[1]:
            prev = _previous(h0, hidden, ctx.reverse)
            dw = torch.mm(prev.reshape(-1, d).t(), dx.reshape(-1, 4 * d))
        if ctx.has_bias and need[2]:
            dbias = dx.sum((0, 1))
        return dx, dw, dbias, dh0, dc0, None, None, None


class GruRecurrence(torch.autograd.Function):
    """hidden [B, T, D] of a GRU over x [B, T, 3D] (projected), w [D, 3D],
    bias [3D] or None, h0 [B, D], length int32 [B] or None; every float
    tensor in one dtype. ``acts``: the (gate, candidate) codes. On the card
    the path is ``gru_path``'s: the cluster's sequence kernels where
    ``gru_seq_plan`` has a launch, else the wide ones where
    ``gru_wide_plan`` has one, else the per-position path."""

    @staticmethod
    def forward(ctx, x, w, bias, h0, length, acts, reverse):
        w = w.contiguous()
        args = (x, w, bias, h0, length, acts, reverse)
        hidden, gates, rh = GRU_PATHS[_gru_path(h0)][0](*args)
        ctx.save_for_backward(w, h0, hidden, gates, rh, length)
        ctx.acts, ctx.reverse, ctx.has_bias = acts, reverse, bias is not None
        return hidden

    @staticmethod
    def backward(ctx, dhidden):
        w, h0, hidden, gates, rh, length = ctx.saved_tensors
        b, t, d = hidden.shape
        dhidden = None if dhidden is None else dhidden.contiguous()
        args = (dhidden, w, gates, hidden, h0, length, ctx.acts, ctx.reverse)
        dx, dh0 = GRU_PATHS[_gru_path(h0)][1](*args)
        need = ctx.needs_input_grad
        dw = dbias = None
        if need[1]:
            prev = _previous(h0, hidden, ctx.reverse).reshape(-1, d)
            dx2 = dx.reshape(-1, 3 * d)
            dw = torch.cat([torch.mm(prev.t(), dx2[:, :2 * d]),
                            torch.mm(rh.reshape(-1, d).t(), dx2[:, 2 * d:])],
                           1)
        if ctx.has_bias and need[2]:
            dbias = dx.sum((0, 1))
        return dx, dw, dbias, dh0, None, None, None
