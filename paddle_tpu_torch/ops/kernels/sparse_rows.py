"""The row-sparse embedding update: the CUDA kernel of
``csrc/sparse_rows.cu`` beside its plain PyTorch version
``sparse_rows_reference``.

One call takes one table's step: its [n, dim] gradient rows (one an id
occurrence of the lookup), the ids in stable-sorted order and the
permutation that sorted them (``sort_ids``), and updates the touched rows of
the table and of its accumulators in place, as the sparse branches of the
JAX package's ``sgd``, ``adagrad``, ``momentum`` and ``adam`` ops do
(paddle_tpu/ops/optimizer_ops.py:39-215): ``sgd`` applies each occurrence
in turn in sorted order; the others merge each run of equal ids into its
sum, taken in sorted order, and apply the reference's formulas to that row
(``momentum`` and ``adam`` lazily: untouched rows keep their state). Every
new value enters as ``old + T(new - old)`` and the parameter as
``p + T(-dp)``, as the reference's scatter-adds write them; T rounds to the
table's type. Ids outside [0, vocab) are dropped.

``sparse_rows`` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors; on a CUDA tensor it launches or raises. The
kernel reads nothing on the host, so a CUDA graph can hold it; the plain
version counts the longest run with a host read. ``sparse_rows.launches``
counts kernel launches.
"""

import torch

from . import build

KINDS = {'sgd': 0, 'adagrad': 1, 'momentum': 2, 'adam': 3}
# accumulators each kind updates, in the kernel's order
N_STATE = {'sgd': 0, 'adagrad': 1, 'momentum': 1, 'adam': 2}


def sort_ids(flat):
    """(sorted ids, order) of the flat int64 ids: the stable sort whose runs
    the update merges (a library sort; it stays on the device)."""
    return torch.sort(flat, stable=True)


def _check(kind, param, rows, sids, order, state, beta_pows):
    if kind not in KINDS:
        raise ValueError('sparse_rows: kind must be one of %s, got %r'
                         % (sorted(KINDS), kind))
    if param.dim() != 2:
        raise ValueError('sparse_rows: the table must be [vocab, dim], got '
                         '%s' % (tuple(param.shape),))
    n = sids.shape[0]
    if tuple(rows.shape) != (n, param.shape[1]) or \
            tuple(order.shape) != (n,) or sids.dim() != 1:
        raise ValueError('sparse_rows: rows [%d, %d], sorted ids and order '
                         '[%d] expected, got %s, %s and %s'
                         % (n, param.shape[1], n, tuple(rows.shape),
                            tuple(sids.shape), tuple(order.shape)))
    if len(state) != N_STATE[kind] or (kind == 'adam') != bool(beta_pows):
        raise ValueError('sparse_rows %s: %d accumulators%s expected'
                         % (kind, N_STATE[kind],
                            ' and the two beta pows' if kind == 'adam'
                            else ''))
    for s in state:
        if s.shape != param.shape or s.dtype != param.dtype:
            raise ValueError('sparse_rows: accumulators must match the '
                             'table, %s %s' % (tuple(param.shape),
                                               param.dtype))


def _runs(sids):
    """(run index of each sorted position, position inside its run, index
    of each run's first position)."""
    n = sids.shape[0]
    start = torch.ones(n, dtype=torch.bool, device=sids.device)
    start[1:] = sids[1:] != sids[:-1]
    run = torch.cumsum(start.long(), 0) - 1
    first = torch.nonzero(start)[:, 0]
    pos = torch.arange(n, device=sids.device) - first[run]
    return run, pos, first


def _sqrt(x):
    """fp32 sqrt correctly rounded on every device, as the kernel's
    __fsqrt_rn: torch's vectorised CPU sqrt is not (about 0.7 % of fp32
    values land one ulp off); a float64 sqrt rounded to fp32 is."""
    return torch.sqrt(x.double()).float()


def sparse_rows_reference(kind, param, rows, sids, order, lr, state=(),
                          beta_pows=(), epsilon=1e-6, mu=0.9,
                          use_nesterov=False, beta1=0.9, beta2=0.999):
    """Plain version, in place: the runs' k-th occurrences are applied (sgd)
    or added (the others) in round k, so each run sees its rows in sorted
    order, with the kernel's fp32 operations in the kernel's order."""
    _check(kind, param, rows, sids, order, state, beta_pows)
    n = sids.shape[0]
    if n == 0:
        return
    vocab = param.shape[0]
    dtype = param.dtype

    def rt(x):   # rounded to the table's type, kept in fp32
        return x.to(dtype).float()

    run, pos, first = _runs(sids)
    rep = sids[first]
    ok = (rep >= 0) & (rep < vocab)
    src = rows[order].float()
    lr = lr.reshape(()).float()
    rounds = int(pos.max()) + 1
    if kind == 'sgd':
        acc = param[rep.clamp(0, vocab - 1)].float()
        for k in range(rounds):
            at = torch.nonzero(pos == k)[:, 0]
            r = run[at]
            acc[r] = rt(acc[r] + rt(-lr * src[at]))
        param[rep[ok]] = acc[ok].to(dtype)
        return
    merged = torch.zeros(first.shape[0], param.shape[1],
                         dtype=torch.float32, device=param.device)
    for k in range(rounds):
        at = torch.nonzero(pos == k)[:, 0]
        r = run[at]
        merged[r] = merged[r] + src[at]
    ids = rep[ok]
    g = merged[ok]
    old_p = param[ids].float()
    olds = [s[ids].float() for s in state]
    if kind == 'adagrad':
        new = [olds[0] + g * g]
        dp = (lr * g) / (_sqrt(new[0]) + epsilon)
    elif kind == 'momentum':
        new = [mu * olds[0] + g]
        dp = (g + mu * new[0]) * lr if use_nesterov else lr * new[0]
    else:
        b1p, b2p = (b.reshape(()).float() for b in beta_pows)
        lr_t = lr * _sqrt(1.0 - b2p) / (1.0 - b1p)
        new = [beta1 * olds[0] + (1.0 - beta1) * g,
               beta2 * olds[1] + (1.0 - beta2) * (g * g)]
        dp = (lr_t * new[0]) / (_sqrt(new[1]) + epsilon)
    for s, old, nv in zip(state, olds, new):
        s[ids] = (old + rt(nv - old)).to(dtype)
    param[ids] = (old_p + -rt(dp)).to(dtype)


def _sparse_rows_cuda(kind, param, rows, sids, order, lr, state, beta_pows,
                      epsilon, mu, use_nesterov, beta1, beta2):
    _check(kind, param, rows, sids, order, state, beta_pows)
    dev = param.device
    code = build.dtype_code(param.dtype)
    if rows.dtype != param.dtype:
        raise TypeError('sparse_rows kernel: rows are %s, the table %s'
                        % (rows.dtype, param.dtype))
    tensors = (param, rows) + tuple(state)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('sparse_rows kernel: the table, its accumulators '
                         'and the rows must be contiguous')
    for t in (sids, order):
        if t.dtype != torch.int64 or not t.is_contiguous():
            raise ValueError('sparse_rows kernel: sorted ids and order must '
                             'be contiguous int64')
    scalars = (lr,) + tuple(beta_pows)
    for t in scalars:
        if t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError('sparse_rows kernel: lr and the beta pows must '
                             'be one float32 each')
    for t in tensors + (sids, order) + scalars:
        if t.device != dev:
            raise ValueError('sparse_rows kernel: all inputs must be on %s, '
                             'got %s' % (dev, t.device))
    n = sids.shape[0]
    if n == 0:
        return
    s1 = state[0].data_ptr() if len(state) > 0 else None
    s2 = state[1].data_ptr() if len(state) > 1 else None
    b1p = beta_pows[0].data_ptr() if beta_pows else None
    b2p = beta_pows[1].data_ptr() if beta_pows else None
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ptt_sparse_rows(
            KINDS[kind], code, param.data_ptr(), s1, s2, sids.data_ptr(),
            order.data_ptr(), rows.data_ptr(), lr.data_ptr(), b1p, b2p, n,
            param.shape[0], param.shape[1], epsilon, mu, int(use_nesterov),
            beta1, 1.0 - beta1, beta2, 1.0 - beta2, stream)
    build.check(rc, 'ptt_sparse_rows')
    sparse_rows.launches += 1


def sparse_rows(kind, param, rows, sids, order, lr, state=(), beta_pows=(),
                epsilon=1e-6, mu=0.9, use_nesterov=False, beta1=0.9,
                beta2=0.999):
    """Update the table ``param`` [vocab, dim] (and its accumulators
    ``state``: adagrad's moment, momentum's velocity, adam's two moments)
    in place from ``rows`` [n, dim] at the ids ``sids`` [n] (sorted, int64)
    with ``order`` [n] the permutation that sorted them (``sort_ids``);
    ``lr`` and adam's ``beta_pows`` are one float32 each."""
    if param.device.type == 'cpu':
        sparse_rows_reference(kind, param, rows, sids, order, lr, state,
                              beta_pows, epsilon, mu, use_nesterov, beta1,
                              beta2)
        return
    _sparse_rows_cuda(kind, param, rows, sids, order, lr, state, beta_pows,
                      epsilon, mu, use_nesterov, beta1, beta2)


sparse_rows.launches = 0
