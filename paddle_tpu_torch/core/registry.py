"""Op lowering registry.

Reference analog: paddle/fluid/framework/op_registry.h (REGISTER_OP_KERNEL).
Each op type registers ONE lowering: a function that reads torch tensors
from the context's environment and writes its outputs back. The Executor
calls the lowerings of a Program's ops one after another, eagerly.
"""

import numpy as np
import torch

from .dtypes import to_torch_dtype

OP_LOWERINGS = {}


def register(op_type):
    def deco(fn):
        if op_type in OP_LOWERINGS:
            raise ValueError('duplicate lowering for op %r' % op_type)
        OP_LOWERINGS[op_type] = fn
        return fn
    return deco


def get_lowering(op_type):
    fn = OP_LOWERINGS.get(op_type)
    if fn is None:
        raise NotImplementedError(
            'No torch lowering registered for op type %r. Known ops: %s' %
            (op_type, ', '.join(sorted(OP_LOWERINGS))))
    return fn


class LoweringContext(object):
    """Execution context handed to each op lowering.

    env      : dict var name -> torch tensor
    op       : the Operator being run
    block    : Block for var metadata lookups
    device   : torch.device every output lives on
    seed     : the program's random seed (random ops derive their
               generators from it and the op's index)
    """

    def __init__(self, env, op, block, op_index, device, seed=0):
        self.env = env
        self.op = op
        self.block = block
        self.op_index = op_index
        self.device = device
        self.seed = int(seed)

    # ---- inputs / outputs ----
    def input(self, slot):
        name = self.op.input(slot)
        if name is None:
            return None
        return self.env[name]

    def has_input(self, slot):
        names = self.op.inputs.get(slot, [])
        return bool(names) and names[0] in self.env

    def set_output(self, slot, value):
        name = self.op.output(slot)
        if name is not None:
            self.env[name] = value

    def attr(self, name, default=None):
        return self.op.attrs.get(name, default)

    def out_var(self, slot):
        name = self.op.output(slot)
        return self.block._find_var_recursive(name) if name else None

    def out_dtype(self, slot, default='float32'):
        var = self.out_var(slot)
        return to_torch_dtype(var.dtype if var is not None else default)

    # ---- randomness ----
    def generator(self, seed=0):
        """A CPU torch.Generator for this op: seeded by ``seed`` when it is
        nonzero (an initializer's explicit seed), else by the program seed
        and the op's index. Random values are drawn on the host and then
        moved, so a CPU and a CUDA run of one startup program give the
        same parameters."""
        g = torch.Generator(device='cpu')
        if seed:
            g.manual_seed(int(seed))
        else:
            # the CPU generator keeps only the low 32 bits of a seed, so
            # the pair is mixed into 32 bits
            g.manual_seed(int(np.random.SeedSequence(
                [self.seed & 0xffffffff, self.op_index]).generate_state(1)[0]))
        return g
