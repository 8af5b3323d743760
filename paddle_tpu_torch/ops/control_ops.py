"""Control-flow ops (reference: paddle_tpu ops/control_ops.py;
paddle/fluid/operators/{recurrent_op,while_op}.cc).

A sub-block's ops run through the same lowerings as the main block's
(``_run_block_ops``), each at op index 10,000 * (block + 1) + i, so an op
of a step block never shares a dropout key with one of the main block.

``static_rnn`` and ``dynamic_rnn`` are a Python loop over the static T of
their step inputs: the step block runs once a position, the memories carry
from one position to the next, and the lengths mask them on the device
(no host read), so a step stays one captured graph and its gradients come
from autograd through the loop. ``while`` reads its condition on the host
each turn: it is host-bound, so a plan that holds it runs eagerly and is
never captured; like the reference's ``lax.while_loop`` it is forward
only (it runs under no_grad). ``if_else`` runs both branches on the whole
batch and merges their outputs row by row. The tensor arrays are dense
[capacity, ...] buffers, the capacity 64 by default, fixed at the first
write, as the reference's are.
"""

import torch

from ..core.registry import LoweringContext, register


def _run_block_ops(block, env, ctx, is_test=False):
    """Run ``block``'s ops over ``env`` under the context ``ctx`` of the op
    that owns the block (its device, seed, step and AMP mode); a var with
    an error_clip gets its gradient clamped, as in the main block."""
    from ..clip import error_clip_grad
    from ..core.executor import collect_error_clips, lower_op
    clips = collect_error_clips(block, block.ops)
    for i, op in enumerate(block.ops):
        sub = LoweringContext(
            env, op, block, 10_000 * (block.idx + 1) + i, ctx.device,
            ctx.seed, ctx.step,
            is_test=is_test or bool(op.attrs.get('is_test', False)),
            amp=ctx.amp)
        lower_op(sub)
        if clips and torch.is_grad_enabled():
            for name in op.output_names():
                if name in clips and name in env:
                    env[name] = error_clip_grad(env[name], *clips[name])
    return env


def _scan_rnn(ctx, length):
    """StaticRNN (``length`` None) and DynamicRNN (a [B] length vector:
    past a row's end its memories keep their value and its outputs are
    zero) over padded [B, T, ...] step inputs."""
    block = ctx.block.program.block(ctx.attr('sub_block'))
    step_input_names = ctx.attr('step_input_names')
    memory_names = ctx.attr('memory_names')  # [(pre, cur), ...]
    output_names = ctx.attr('output_names')
    seq_inputs = ctx.input_list('Inputs')
    mems = ctx.input_list('BootMemories')
    outer_env = dict(ctx.env)
    steps = seq_inputs[0].shape[1]

    def masked(t, new, old):
        if length is None:
            return new
        alive = (length > t).reshape((-1,) + (1,) * (new.dim() - 1))
        return torch.where(alive, new,
                           torch.zeros_like(new) if old is None else old)

    outs = [[] for _ in output_names]
    for t in range(steps):
        env = dict(outer_env)
        for name, x in zip(step_input_names, seq_inputs):
            env[name] = x[:, t]
        for (pre, _), mem in zip(memory_names, mems):
            env[pre] = mem
        env = _run_block_ops(block, env, ctx, is_test=ctx.is_test)
        # each memory keeps its boot dtype: under AMP a whitelisted step
        # op (gru_unit) returns bf16 against an fp32 boot memory
        mems = [masked(t, env[cur], mem).to(mem.dtype)
                for (_, cur), mem in zip(memory_names, mems)]
        for acc, name in zip(outs, output_names):
            acc.append(masked(t, env[name], None))
    ctx.set_output_list('Outputs', [torch.stack(o, 1) for o in outs])
    ctx.set_output_list('FinalMemories', mems)


@register('static_rnn')
def _static_rnn(ctx):
    _scan_rnn(ctx, length=None)


@register('dynamic_rnn')
def _dynamic_rnn(ctx):
    """StaticRNN with per-row lengths (the reference DynamicRNN walks LoD
    levels; here a mask on dense [B, T, ...] inputs)."""
    length = ctx.input('Length') if ctx.has_input('Length') else None
    _scan_rnn(ctx, None if length is None else length.reshape(-1))


@register('while', host_bound=True)
def _while(ctx):
    """The reference's loop state: every var the body reads and writes,
    the condition, and every var it writes that exists before the loop;
    the condition, one element, is read on the host before each turn."""
    block = ctx.block.program.block(ctx.attr('sub_block'))
    cond_name = ctx.op.input('Condition')
    read, written = set(), set()
    for op in block.ops:
        for n in op.input_names():
            if n not in written:
                read.add(n)
        written.update(op.output_names())
    state_names = sorted((read & written) | {cond_name} |
                         {n for n in written if n in ctx.env})
    state_names = [n for n in state_names if n in ctx.env]
    outer_env = {k: v for k, v in ctx.env.items() if k not in state_names}
    state = [ctx.env[n] for n in state_names]

    def go():
        if cond_name not in state_names:
            return False
        return bool(state[state_names.index(cond_name)].reshape(()))

    with torch.no_grad():
        while go():
            env = dict(outer_env)
            env.update(zip(state_names, state))
            env = _run_block_ops(block, env, ctx, is_test=ctx.is_test)
            # loop-carried values keep their dtype (see _scan_rnn)
            state = [env[n].to(s.dtype) if isinstance(env[n], torch.Tensor)
                     else env[n] for n, s in zip(state_names, state)]
    for n, v in zip(state_names, state):
        ctx.env[n] = v


@register('is_empty')
def _is_empty(ctx):
    x = ctx.input('X')
    ctx.set_output('Out', torch.full((1,), x.numel() == 0, dtype=torch.bool,
                                     device=ctx.device))


def _index(ctx, n):
    """The I input as a [1] int64 index, clamped into [0, n) as the
    reference's dynamic index is."""
    return ctx.input('I').reshape(1).long().clamp(0, n - 1)


# the capacity a tensor array takes at its first write
ARRAY_CAPACITY = 64


@register('array_write')
def _array_write(ctx):
    x = ctx.input('X')
    name = ctx.op.output('Out')
    arr = ctx.env.get(name)
    if not isinstance(arr, torch.Tensor) or arr.dim() != x.dim() + 1:
        arr = torch.zeros((ARRAY_CAPACITY,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
    ctx.env[name] = arr.index_copy(0, _index(ctx, arr.shape[0]),
                                   x.unsqueeze(0).to(arr.dtype))


@register('array_read')
def _array_read(ctx):
    arr = ctx.input('X')
    ctx.set_output('Out', arr.index_select(0, _index(ctx, arr.shape[0]))[0])


@register('array_length')
def _array_length(ctx):
    """The array's capacity, as the reference gives it (not a count of
    writes)."""
    arr = ctx.input('X')
    ctx.set_output('Out', torch.full((1,), arr.shape[0],
                                     dtype=ctx.out_dtype('Out', 'int64'),
                                     device=ctx.device))


@register('if_else')
def _if_else(ctx):
    """Both branch blocks run on the whole batch; each output takes the
    true branch's row where Cond [B, 1] holds, else the false branch's
    (if_else_op.cc gathers the two sub-batches instead)."""
    cond = ctx.input('Cond')
    program = ctx.block.program
    env_t = _run_block_ops(program.block(ctx.attr('true_block')),
                           dict(ctx.env), ctx, is_test=ctx.is_test)
    env_f = _run_block_ops(program.block(ctx.attr('false_block')),
                           dict(ctx.env), ctx, is_test=ctx.is_test)
    outs = []
    for tn, fn in zip(ctx.attr('true_names'), ctx.attr('false_names')):
        tv, fv = env_t[tn], env_f[fn]
        c = cond.reshape(tuple(cond.shape[:1]) + (1,) * (tv.dim() - 1))
        outs.append(torch.where(c.bool(), tv, fv))
    ctx.set_output_list('Outs', outs)
