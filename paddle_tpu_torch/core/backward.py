"""append_backward (reference: python/paddle/fluid/backward.py).

The reference appends one grad op per forward op. Here, as in the JAX
package, append_backward records a single ``backward_marker`` op carrying
(loss, params, grad var names); the Executor splits the op list there, runs
the ops before it with the trainable parameters as leaf tensors, takes the
gradients with ``torch.autograd.grad``, and binds ``p@GRAD`` for the ops
after it (the optimizer's update ops). Gradients are dense: the row-sparse
embedding gradients of the JAX package's SGD/Adagrad path are not ported.
"""

from .program import Parameter

GRAD_SUFFIX = '@GRAD'


def grad_var_name(name):
    return name + GRAD_SUFFIX


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, sparse_supported=False):
    """Append the backward section for ``loss``. Returns a list of
    (param_var, grad_var) like the reference. ``sparse_supported`` is
    accepted for the reference's signature; gradients are always dense."""
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

    params_and_grads = []
    for p in params:
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
               'sparse_grads': {}})
    return params_and_grads
