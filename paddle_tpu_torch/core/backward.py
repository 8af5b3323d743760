"""append_backward (reference: python/paddle/fluid/backward.py).

The reference appends one grad op per forward op. Here, as in the JAX
package, append_backward records a single ``backward_marker`` op carrying
(loss, params, grad var names); the Executor splits the op list there, runs
the ops before it with the trainable parameters as leaf tensors, takes the
gradients with ``torch.autograd.grad``, and binds ``p@GRAD`` for the ops
after it (the optimizer's update ops).

Row-sparse embedding gradients (the reference's SelectedRows,
lookup_table_op.cc:119-127): when the optimizer's update op can consume
them, an eligible ``is_sparse`` table is no leaf. The executor plants a zero
"row seed" shaped like its lookup's output instead, and the seed's gradient,
[n_ids, dim], is bound as ``p@GRAD``: no [vocab, dim] gradient is made.
"""

from .program import Parameter

GRAD_SUFFIX = '@GRAD'

# env key prefix of the zero row seed added to a sparse-grad lookup's output
# (core/executor.py plants it, ops/nn_ops.py lookup_table adds it)
SPARSE_SEED_PREFIX = '~sparse_seed~'


def grad_var_name(name):
    return name + GRAD_SUFFIX


def _sparse_grad_lookups(block, params):
    """{param name: {'ids', 'out'}} for every parameter eligible for
    row-sparse gradients (reference: paddle_tpu core/backward.py
    _sparse_grad_lookups): flagged by layers.embedding(is_sparse=True),
    read by exactly ONE lookup_table op, counted across all blocks, whose
    Ids are fed data or persistable, with no per-param regularizer or clip
    and no program-level clip (optimizer-level regularization is checked by
    the caller). Ineligible tables silently take the dense path."""
    eligible = {}
    program = block.program
    program_clip = getattr(program, '_gradient_clip_attr', None)
    flagged = {p.name for p in params if getattr(p, 'sparse_grad', False)
               and p.regularizer is None and program_clip is None
               and getattr(p, 'gradient_clip_attr', None) is None}
    if not flagged:
        return eligible
    uses = {}
    for b in program.blocks:
        for op in b.ops:
            for n in op.input_names():
                if n in flagged:
                    uses.setdefault(n, []).append(op)
    for name, ops in uses.items():
        if len(ops) != 1 or ops[0].type != 'lookup_table':
            continue
        op = ops[0]
        ids_name = op.inputs['Ids'][0]
        ids_var = block._find_var_recursive(ids_name)
        if ids_var is None or not (ids_var.is_data or ids_var.persistable):
            continue
        eligible[name] = {'ids': ids_name, 'out': op.outputs['Out'][0]}
    return eligible


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, sparse_supported=False):
    """Append the backward section for ``loss``. Returns a list of
    (param_var, grad_var) like the reference.

    ``sparse_supported``: the calling optimizer's update op consumes
    row-sparse gradients (SGD, Adagrad, and Adam and Momentum with
    ``lazy_mode``). Each eligible table's ``p@GRAD`` is then [n_ids, dim]
    with ``sparse_ids`` naming its Ids var, and the marker's
    ``sparse_grads`` maps it to {'ids', 'out'}; every other gradient is
    dense, shaped like its parameter."""
    program = loss.block.program
    block = program.global_block()
    no_grad_names = set(v if isinstance(v, str) else v.name
                        for v in (no_grad_set or []))

    if parameter_list is not None:
        names = [p if isinstance(p, str) else p.name for p in parameter_list]
        params = [block.var(n) for n in names]
    else:
        params = program.all_parameters()
    params = [p for p in params
              if isinstance(p, Parameter) and p.trainable
              and not p.stop_gradient and p.name not in no_grad_names]
    if not params:
        raise ValueError('append_backward: no trainable parameters found')

    sparse = _sparse_grad_lookups(block, params) if sparse_supported else {}

    params_and_grads = []
    for p in params:
        if p.name in sparse:
            # runtime shape is [n_ids, dim] (batch-dependent)
            g = block.create_var(name=grad_var_name(p.name),
                                 shape=(-1, p.shape[-1]), dtype=p.dtype)
            g.sparse_ids = sparse[p.name]['ids']
        else:
            g = block.create_var(name=grad_var_name(p.name), shape=p.shape,
                                 dtype=p.dtype)
        g.stop_gradient = True
        params_and_grads.append((p, g))

    block.append_op(
        type='backward_marker',
        inputs={'Loss': [loss.name]},
        outputs={'Grads': [g.name for _, g in params_and_grads]},
        attrs={'param_names': [p.name for p, _ in params_and_grads],
               'grad_names': [g.name for _, g in params_and_grads],
               'loss_name': loss.name,
               'sparse_grads': sparse})
    return params_and_grads
