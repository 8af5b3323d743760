"""Op lowering registry.

Reference analog: paddle/fluid/framework/op_registry.h (REGISTER_OP_KERNEL).
Each op type registers ONE lowering: a function that reads torch tensors
from the context's environment and writes its outputs back. The Executor
calls the lowerings of a Program's ops one after another; in a training
step it runs the forward ops with autograd recording. On a CUDA place it
captures a plan's ops into a CUDA graph (core/executor.py), so a lowering
may not read a tensor's value on the host, copy from pageable host memory
or key its work on a Python value that changes from step to step. The ops
that must (``register(..., host_bound=True)``: the startup ops that draw
initial values on the host) keep every plan that holds them eager.
"""

import functools

import numpy as np
import torch

from .dtypes import to_torch_dtype

OP_LOWERINGS = {}
# op types whose lowering works on the host (drawn initial values): a plan
# that holds one is never captured into a CUDA graph
HOST_BOUND = set()


def register(op_type, host_bound=False):
    def deco(fn):
        if op_type in OP_LOWERINGS:
            raise ValueError('duplicate lowering for op %r' % op_type)
        OP_LOWERINGS[op_type] = fn
        if host_bound:
            HOST_BOUND.add(op_type)
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


# The counter-based hash behind the per-step noise (dropout masks, decode
# sampling): a 32-bit mixer (two multiply-xorshift rounds) evaluated the
# same way on Python ints, on int64 tensors (values kept in [0, 2^32), each
# product below 2^63) and in the CUDA kernels (csrc/random_bits.cu, on
# uint32), so the three give the same bits.
MASK32 = 0xffffffff
_MUL1 = 0x21f0aaad
_MUL2 = 0x735a2d97


def mix32(x):
    """The mixer on a Python int or an int64 tensor of values in
    [0, 2^32)."""
    x = x ^ (x >> 16)
    x = (x * _MUL1) & MASK32
    x = x ^ (x >> 15)
    x = (x * _MUL2) & MASK32
    return x ^ (x >> 15)


def op_key(seed, op_index):
    """The 32-bit key of one op of a program: mix32 over (seed, op)."""
    return mix32(mix32(int(seed) & MASK32) ^ (int(op_index) & MASK32))


def check_no_mesh(ctx):
    """The expert-parallel and pipelined schedules need a mesh, which the
    port does not have yet."""
    program = ctx.block.program
    if getattr(program, 'pipeline', None) or \
            getattr(program, 'mesh', None) is not None:
        raise NotImplementedError(
            '%s: programs on a mesh (expert parallelism, the pipelined '
            'stack, ring attention) are not ported; ROADMAP Queue 1 item 9'
            % ctx.op.type)


# aten ops whose outputs the 'dots_saveable' remat policy keeps (what
# jax.checkpoint_policies.dots_saveable keeps: the dot products and the
# convolutions)
_DOTS = ('mm', 'addmm', 'bmm', 'baddbmm', 'matmul', 'convolution')


def checkpointed(policy, fn, *args):
    """fn(*args) under torch.utils.checkpoint (non-reentrant) with a remat
    policy (memory_optimize): 'full' and 'nothing_saveable' save nothing,
    'dots_saveable' keeps the matmul-class and convolution outputs through
    selective checkpointing. The kernels launched through ctypes are no aten ops:
    their autograd Functions run again in the recompute under every
    policy. No RNG state is saved: the dropout bits are keyed on the step
    tensor, and reading the CUDA generator would break a capture."""
    from torch.utils import checkpoint as ckpt
    context = ckpt.noop_context_fn
    if policy == 'dots_saveable':
        dots = {getattr(torch.ops.aten, n) for n in _DOTS}

        def save_dots(ctx, op, *a, **kw):
            return ckpt.CheckpointPolicy.MUST_SAVE \
                if getattr(op, 'overloadpacket', op) in dots \
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE
        context = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                    save_dots)
    return ckpt.checkpoint(fn, *args, use_reentrant=False,
                           preserve_rng_state=False, context_fn=context)


class LoweringContext(object):
    """Execution context handed to each op lowering.

    env      : dict var name -> torch tensor
    op       : the Operator being run
    block    : Block for var metadata lookups
    device   : torch.device every output lives on
    seed     : the program's random seed
    step     : this executor's run count, a 0-dim int64 tensor on the
               device (dropout masks differ per step; a captured graph
               reads it at replay)
    is_test  : the op's own is_test attr
    amp      : None or 'bf16' — input() casts per the policy above
    reads    : names read by a later op or fetched (None: all of them)
    sparse_updates : the run's held row-sparse updates
               (ops/optimizer_ops.SparseUpdates), or None: a sparse
               update op then applies its table at once
    remat    : the program's remat policy while the forward of a training
               step runs under it (memory_optimize), else None: an op
               writes no persistable in place (the backward's recompute
               would write it again), and a layer stack checkpoints each
               layer (``checkpointed``)
    """

    def __init__(self, env, op, block, op_index, device, seed=0, step=0,
                 is_test=False, amp=None, reads=None, sparse_updates=None,
                 remat=None):
        self.env = env
        self.op = op
        self.block = block
        self.op_index = op_index
        self.device = device
        self.seed = int(seed)
        self.step = step
        self.is_test = is_test
        self.amp = amp
        self._reads = reads
        self.sparse_updates = sparse_updates
        self.remat = remat

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

    def _set(self, name, value):
        var = self.block._find_var_recursive(name)
        if var is not None and var.stop_gradient and \
                isinstance(value, torch.Tensor):
            value = value.detach()
        self.env[name] = value

    def set_output(self, slot, value):
        name = self.op.output(slot)
        if name is not None:
            self._set(name, value)

    def set_output_list(self, slot, values):
        """One value for each var of the slot, in order."""
        for name, value in zip(self.op.outputs.get(slot, []), values):
            self._set(name, value)

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

    def checkpointed(self, fn, *args):
        """fn(*args), under the remat policy's checkpoint when there is
        one."""
        if self.remat is None:
            return fn(*args)
        return checkpointed(self.remat, fn, *args)

    # ---- randomness ----
    def generator(self, seed=0, step=False):
        """A CPU torch.Generator for this op: seeded by ``seed`` when it is
        nonzero (an initializer's explicit seed), else by the program seed
        and the op's index, and with ``step`` by the step index too (a
        host read: only host-bound ops draw). Random values are drawn on
        the host and then moved, so a CPU and a CUDA run of one program
        give the same values."""
        g = torch.Generator(device='cpu')
        if seed:
            g.manual_seed(int(seed))
        elif step:
            g.manual_seed(_mix(self.seed, self.op_index, int(self.step)))
        else:
            g.manual_seed(_mix(self.seed, self.op_index))
        return g

    def step_tensor(self):
        """The step as a 0-dim int64 tensor on the op's device."""
        step = self.step
        if not isinstance(step, torch.Tensor):
            step = torch.tensor(int(step), dtype=torch.int64)
        return step.to(self.device)
