"""memory_optimize (reference: paddle_tpu memory_optimize.py). The JAX
package sets a rematerialisation policy on the Program; the port has no
rematerialising backward yet (it would be torch.utils.checkpoint over
the forward section), so asking for one raises."""

__all__ = ['memory_optimize']


def memory_optimize(input_program=None, print_log=False, level=0,
                    policy=None):
    """Only ``policy='none'`` (no rematerialisation) is supported."""
    if policy == 'none':
        return input_program
    raise NotImplementedError('memory_optimize: rematerialisation is not '
                              'ported to paddle_tpu_torch')
