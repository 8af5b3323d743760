"""The row-sparse embedding update: the CUDA kernel of
``csrc/sparse_rows.cu`` beside its plain PyTorch versions
``sparse_rows_reference`` (one table) and ``sparse_rows_grouped_reference``
(a group of tables).

A table's step is its [n, dim] gradient rows (one an id occurrence of the
lookup) and the lookup's flat ids; the update changes the touched rows of
the table and of its accumulators in place, as the sparse branches of the
JAX package's ``sgd``, ``adagrad``, ``momentum`` and ``adam`` ops do
(paddle_tpu/ops/optimizer_ops.py:39-215): ``sgd`` applies each occurrence
in turn in stable-sorted order; the others merge each run of equal ids into
its sum, taken in sorted order, and apply the reference's formulas to that
row (``momentum`` and ``adam`` lazily: untouched rows keep their state).
Every new value enters as ``old + T(new - old)`` and the parameter as
``p + T(-dp)``, as the reference's scatter-adds write them; T rounds to the
table's type. Ids outside [0, vocab) are dropped.

``sparse_rows_grouped`` updates a group of tables (``SparseTable``s of one
kind and dtype, sharing one ``lr`` tensor and one set of hyperparameters)
in one launch: the kernel sorts each table's ids itself, one block a table,
for tables of up to 8,192 ids; larger tables are sorted by ``sort_ids`` and
take the kernel's presorted variant, one more launch for all of them.
``sparse_rows`` takes one table whose ids are already sorted (``sort_ids``)
and launches the presorted variant. Both launch the kernel for CUDA tensors
and take the plain versions only for CPU tensors; on a CUDA tensor they
launch or raise. The kernel reads nothing on the host, so a CUDA graph can
hold it; the plain versions count the longest run with a host read.
``sparse_rows.launches`` counts kernel launches, ``sparse_rows.tables`` the
tables they updated.
"""

import ctypes
from collections import namedtuple

import torch

from . import build

KINDS = {'sgd': 0, 'adagrad': 1, 'momentum': 2, 'adam': 3}
# accumulators each kind updates, in the kernel's order
N_STATE = {'sgd': 0, 'adagrad': 1, 'momentum': 1, 'adam': 2}


def sort_ids(flat):
    """(sorted ids, order) of the flat int64 ids: the stable sort whose runs
    the update merges (a library sort; it stays on the device)."""
    return torch.sort(flat, stable=True)


def _check(kind, param, rows, ids, order, state, beta_pows):
    """Shapes and kinds; ``ids`` sorted with their ``order``, or the
    lookup's flat ids with ``order`` None."""
    if kind not in KINDS:
        raise ValueError('sparse_rows: kind must be one of %s, got %r'
                         % (sorted(KINDS), kind))
    if param.dim() != 2:
        raise ValueError('sparse_rows: the table must be [vocab, dim], got '
                         '%s' % (tuple(param.shape),))
    n = ids.shape[0]
    if tuple(rows.shape) != (n, param.shape[1]) or ids.dim() != 1 or \
            (order is not None and tuple(order.shape) != (n,)):
        raise ValueError('sparse_rows: rows [%d, %d] and ids (and order) '
                         '[%d] expected, got %s, %s and %s'
                         % (n, param.shape[1], n, tuple(rows.shape),
                            tuple(ids.shape), None if order is None else
                            tuple(order.shape)))
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


class SparseTable(namedtuple('SparseTable',
                               'param rows ids state beta_pows')):
    """One table's step: the table ``param`` [vocab, dim], its ``rows``
    [n, dim] in the lookup's order, the lookup's flat ``ids`` [n] (int64,
    unsorted), its accumulators ``state`` (adagrad's moment, momentum's
    velocity, adam's two moments) and, for adam, its two ``beta_pows``."""

    def __new__(cls, param, rows, ids, state=(), beta_pows=()):
        return super(SparseTable, cls).__new__(
            cls, param, rows, ids, tuple(state), tuple(beta_pows))


def sparse_rows_grouped_reference(kind, tables, lr, epsilon=1e-6, mu=0.9,
                                  use_nesterov=False, beta1=0.9,
                                  beta2=0.999):
    """Plain version of the grouped update: each table in turn, its ids
    stably sorted and applied by ``sparse_rows_reference``. The tables are
    disjoint, so this equals one call per table bit for bit."""
    for t in tables:
        _check(kind, t.param, t.rows, t.ids, None, t.state, t.beta_pows)
        sids, order = sort_ids(t.ids)
        sparse_rows_reference(kind, t.param, t.rows, sids, order, lr,
                              t.state, t.beta_pows, epsilon, mu,
                              use_nesterov, beta1, beta2)


class _TableArg(ctypes.Structure):
    """One table as ptt_sparse_rows_group takes it (SparseTableArg)."""
    _fields_ = [(f, ctypes.c_void_p) for f in
                ('p', 's1', 's2', 'ids', 'order', 'rows', 'b1p', 'b2p')] + \
        [(f, ctypes.c_longlong) for f in ('n', 'vocab', 'dim')]


def _check_cuda(dev, dtype, param, rows, ids, order, state, beta_pows):
    if rows.dtype != dtype or param.dtype != dtype:
        raise TypeError('sparse_rows kernel: one dtype a group (%s), got a '
                        'table of %s with rows of %s'
                        % (dtype, param.dtype, rows.dtype))
    tensors = (param, rows) + tuple(state)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('sparse_rows kernel: the table, its accumulators '
                         'and the rows must be contiguous')
    index = (ids,) if order is None else (ids, order)
    for t in index:
        if t.dtype != torch.int64 or not t.is_contiguous():
            raise ValueError('sparse_rows kernel: ids and order must be '
                             'contiguous int64')
    for t in beta_pows:
        if t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError('sparse_rows kernel: the beta pows must be one '
                             'float32 each')
    for t in tensors + index + tuple(beta_pows):
        if t.device != dev:
            raise ValueError('sparse_rows kernel: all inputs must be on %s, '
                             'got %s' % (dev, t.device))
    if param.shape[0] >= 2 ** 31 - 1:
        raise ValueError('sparse_rows kernel: tables of up to 2^31 - 2 rows, '
                         'got %d' % param.shape[0])


def _launch(kind, items, lr, presorted, epsilon, mu, use_nesterov, beta1,
            beta2):
    """One launch for ``items``: (param, rows, ids, order, state,
    beta_pows), checked, each with n >= 1; ``order`` None unless
    ``presorted``."""
    lib = build.library()
    dev = items[0][0].device
    code = build.dtype_code(items[0][0].dtype)
    args = (_TableArg * len(items))()
    for a, (param, rows, ids, order, state, pows) in zip(args, items):
        a.p, a.rows, a.ids = param.data_ptr(), rows.data_ptr(), \
            ids.data_ptr()
        a.order = order.data_ptr() if order is not None else None
        a.s1 = state[0].data_ptr() if len(state) > 0 else None
        a.s2 = state[1].data_ptr() if len(state) > 1 else None
        a.b1p = pows[0].data_ptr() if pows else None
        a.b2p = pows[1].data_ptr() if pows else None
        a.n, a.vocab, a.dim = rows.shape[0], param.shape[0], param.shape[1]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ptt_sparse_rows_group(
            KINDS[kind], code, int(presorted), ctypes.addressof(args),
            len(items), lr.data_ptr(), epsilon, mu, int(use_nesterov), beta1,
            1.0 - beta1, beta2, 1.0 - beta2, stream)
    build.check(rc, 'ptt_sparse_rows_group')
    sparse_rows.launches += 1
    sparse_rows.tables += len(items)


def _launch_all(kind, items, lr, presorted, hyper):
    """``items`` in launches of at most the kernel's table limit."""
    most = build.library().ptt_sparse_rows_limits(0)
    for i in range(0, len(items), most):
        _launch(kind, items[i:i + most], lr, presorted, *hyper)


def _check_lr(lr, dev):
    if lr.dtype != torch.float32 or lr.numel() != 1 or lr.device != dev:
        raise ValueError('sparse_rows kernel: lr must be one float32 on %s'
                         % dev)


def sparse_rows_grouped(kind, tables, lr, epsilon=1e-6, mu=0.9,
                        use_nesterov=False, beta1=0.9, beta2=0.999):
    """Update every ``SparseTable`` of ``tables`` (one kind, one dtype) in
    place, with one ``lr`` (one float32) and one set of hyperparameters:
    one launch for the tables of up to 8,192 ids, one more for the larger
    ones (each sorted by ``sort_ids`` first). Empty tables are skipped."""
    tables = list(tables)
    if not tables:
        return
    hyper = (epsilon, mu, use_nesterov, beta1, beta2)
    devices = {t.param.device for t in tables}
    if devices == {torch.device('cpu')}:
        sparse_rows_grouped_reference(kind, tables, lr, *hyper)
        return
    if len(devices) != 1:
        raise ValueError('sparse_rows: the tables of a group lie on %s'
                         % sorted(str(d) for d in devices))
    dev = devices.pop()
    dtype = tables[0].param.dtype
    _check_lr(lr, dev)
    small, large = [], []
    most = build.library().ptt_sparse_rows_limits(1)
    for t in tables:
        _check(kind, t.param, t.rows, t.ids, None, t.state, t.beta_pows)
        _check_cuda(dev, dtype, t.param, t.rows, t.ids, None, t.state,
                    t.beta_pows)
        n = t.ids.shape[0]
        if n == 0:
            continue
        if n <= most:
            small.append((t.param, t.rows, t.ids, None, t.state,
                          t.beta_pows))
        else:
            sids, order = sort_ids(t.ids)
            large.append((t.param, t.rows, sids, order, t.state,
                          t.beta_pows))
    if small:
        _launch_all(kind, small, lr, False, hyper)
    if large:
        _launch_all(kind, large, lr, True, hyper)


def sparse_rows(kind, param, rows, sids, order, lr, state=(), beta_pows=(),
                epsilon=1e-6, mu=0.9, use_nesterov=False, beta1=0.9,
                beta2=0.999):
    """Update the table ``param`` [vocab, dim] (and its accumulators
    ``state``: adagrad's moment, momentum's velocity, adam's two moments)
    in place from ``rows`` [n, dim] at the ids ``sids`` [n] (sorted, int64)
    with ``order`` [n] the permutation that sorted them (``sort_ids``);
    ``lr`` and adam's ``beta_pows`` are one float32 each. On the card: one
    launch of the kernel's presorted variant."""
    if param.device.type == 'cpu':
        sparse_rows_reference(kind, param, rows, sids, order, lr, state,
                              beta_pows, epsilon, mu, use_nesterov, beta1,
                              beta2)
        return
    _check(kind, param, rows, sids, order, state, beta_pows)
    dev = param.device
    _check_lr(lr, dev)
    _check_cuda(dev, param.dtype, param, rows, sids, order, state,
                beta_pows)
    if sids.shape[0] == 0:
        return
    _launch(kind, [(param, rows, sids, order, tuple(state),
                    tuple(beta_pows))], lr, True, epsilon, mu, use_nesterov,
            beta1, beta2)


sparse_rows.launches = 0
sparse_rows.tables = 0
