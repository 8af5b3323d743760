"""memory_optimize (reference: paddle_tpu memory_optimize.py;
python/paddle/fluid/memory_optimization_transpiler.py).

The caching allocator reuses a step's buffers already, and persistable
state is updated in place, so what is left to choose is
rematerialisation: memory_optimize sets the program's ``remat_policy`` and
the Executor runs the forward section as checkpointed segments of about
sqrt(n) ops, a layer stack checkpointing each layer (core/executor.py),
trading the forward's recomputation in the backward for the activations
it no longer keeps: the backward holds one segment's at a time.
"""

__all__ = ['memory_optimize', 'release_memory', 'REMAT_POLICIES']

REMAT_POLICIES = ('none', 'full', 'dots_saveable', 'nothing_saveable')


def memory_optimize(input_program=None, print_log=False, level=0,
                    policy=None):
    """level 0 -> 'dots_saveable' (the matmul and convolution outputs
    are kept, the rest of the forward recomputed); level 1 -> 'full'
    (everything recomputed). ``policy`` names one of REMAT_POLICIES
    instead."""
    from .core.program import default_main_program
    program = input_program or default_main_program()
    if policy is None:
        policy = 'dots_saveable' if level == 0 else 'full'
    if policy not in REMAT_POLICIES:
        raise ValueError('unknown remat policy %r (choose from %s)'
                         % (policy, REMAT_POLICIES))
    program.remat_policy = None if policy == 'none' else policy
    if print_log:
        print('memory_optimize: remat policy = %s' % policy)
    return program


def release_memory(input_program=None, skip_opt_set=None):
    """The reference's API, kept for ported scripts: the allocator frees a
    step's buffers itself, so there is nothing to release."""
    return input_program
