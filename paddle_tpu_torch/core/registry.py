"""Op lowering registry.

Reference analog: paddle/fluid/framework/op_registry.h (REGISTER_OP_KERNEL).
Each op type registers ONE lowering: a function that reads torch tensors
from the context's environment and writes its outputs back. The Executor
calls the lowerings of a Program's ops one after another, eagerly; in a
training step it runs the forward ops with autograd recording.
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


# AMP 'bf16' dtype policy (the JAX package's lists): whitelist ops compute
# in bfloat16, blacklist ops are numerically sensitive and force fp32; all
# others run in whatever dtype arrives (type promotion resolves mixes).
AMP_WHITELIST = {
    'mul', 'matmul', 'conv2d', 'conv2d_transpose', 'fused_attention',
    'sequence_conv', 'row_conv',
    'lstm', 'lstmp', 'gru', 'simple_rnn', 'gru_unit', 'lstm_unit',
}
AMP_BLACKLIST = {
    'softmax', 'softmax_with_cross_entropy', 'cross_entropy',
    'layer_norm', 'batch_norm', 'mean', 'reduce_sum', 'reduce_mean',
    'exp', 'log', 'square_error_cost', 'l2_normalize', 'cos_sim',
    'clip_by_norm', 'linear_chain_crf', 'nce',
}

# Normalization ops compute their statistics in fp32 (blacklist above) but
# hand the activation back to the bf16 stream: op type -> the output slots
# the executor casts back to bf16 after the op.
AMP_BF16_OUT_SLOTS = {
    'batch_norm': ('Y',),
    'layer_norm': ('Y',),
    'group_norm': ('Y',),
}


def _mix(*words):
    """One 32-bit seed from a tuple of integers (a torch CPU generator
    keeps only the low 32 bits of a seed)."""
    return int(np.random.SeedSequence(
        [int(w) & 0xffffffff for w in words]).generate_state(1)[0])


class LoweringContext(object):
    """Execution context handed to each op lowering.

    env      : dict var name -> torch tensor
    op       : the Operator being run
    block    : Block for var metadata lookups
    device   : torch.device every output lives on
    seed     : the program's random seed
    step     : this executor's run count (dropout masks differ per step)
    is_test  : the op's own is_test attr
    amp      : None or 'bf16' — input() casts per the policy above
    reads    : names read by a later op or fetched (None: all of them)
    """

    def __init__(self, env, op, block, op_index, device, seed=0, step=0,
                 is_test=False, amp=None, reads=None):
        self.env = env
        self.op = op
        self.block = block
        self.op_index = op_index
        self.device = device
        self.seed = int(seed)
        self.step = int(step)
        self.is_test = is_test
        self.amp = amp
        self._reads = reads

    def _autocast(self, value):
        if self.amp != 'bf16' or value is None:
            return value
        if self.op.type in AMP_WHITELIST and value.dtype == torch.float32:
            return value.to(torch.bfloat16)
        if self.op.type in AMP_BLACKLIST and value.dtype == torch.bfloat16:
            return value.float()
        return value

    # ---- inputs / outputs ----
    def input(self, slot):
        name = self.op.input(slot)
        if name is None:
            return None
        return self._autocast(self.env[name])

    def input_list(self, slot):
        return [self._autocast(self.env[n])
                for n in self.op.inputs.get(slot, [])]

    def has_input(self, slot):
        names = self.op.inputs.get(slot, [])
        return bool(names) and names[0] in self.env

    def set_output(self, slot, value):
        name = self.op.output(slot)
        if name is None:
            return
        var = self.block._find_var_recursive(name)
        if var is not None and var.stop_gradient and \
                isinstance(value, torch.Tensor):
            value = value.detach()
        self.env[name] = value

    def output_read(self, slot):
        """Whether anything reads this output slot: a later op, a fetch,
        or the scope (persistable)."""
        name = self.op.output(slot)
        if name is None:
            return False
        if self._reads is None or name in self._reads:
            return True
        var = self.block._find_var_recursive(name)
        return var is not None and var.persistable

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
        g.manual_seed(int(seed) if seed else _mix(self.seed, self.op_index))
        return g

    def step_generator(self):
        """A torch.Generator on the op's device for per-step noise
        (dropout), keyed by (program seed, step, op index): every step
        and every op draws its own mask, reproducibly."""
        g = torch.Generator(device=self.device)
        g.manual_seed(_mix(self.seed, self.step, self.op_index))
        return g
