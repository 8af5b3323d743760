"""Control-flow layers (reference: paddle_tpu layers/control_flow.py;
fluid/layers/control_flow.py): increment, equal and less_than, Print, the
loop constructs (While, StaticRNN, DynamicRNN), IfElse, Switch, is_empty
and the tensor arrays. A loop or branch body is built into a child Block
that its op (ops/control_ops.py) runs: StaticRNN and DynamicRNN as a loop
over the static T of their step inputs (captured), IfElse as both
branches on the whole batch merged by the condition, While with its
condition read on the host each turn (a plan that holds it runs
eagerly)."""

import contextlib

from ..core.program import default_main_program
from .helper import LayerHelper

__all__ = [
    'increment', 'less_than', 'equal', 'array_write', 'array_read',
    'create_array', 'array_length', 'While', 'StaticRNN', 'Switch',
    'Print', 'is_empty', 'IfElse', 'DynamicRNN',
]


@contextlib.contextmanager
def _in_parent_block(program):
    """Emit ops into the parent of the current (sub-)block: a loop
    memory's boot value must live where the loop op reads it."""
    sub_idx = program.current_block_idx
    program.current_block_idx = max(program.block(sub_idx).parent_idx, 0)
    try:
        yield
    finally:
        program.current_block_idx = sub_idx


def increment(x, value=1.0, in_place=True):
    """x + value, written into x itself with ``in_place``."""
    helper = LayerHelper('increment')
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(x.dtype)
        out.shape = x.shape
    helper.append_op(type='increment', inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'step': float(value)})
    return out


def _compare(op_type, x, y, cond):
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_variable_for_type_inference('bool')
        cond.shape = x.shape
    helper.append_op(type=op_type, inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [cond]})
    return cond


def less_than(x, y, cond=None):
    return _compare('less_than', x, y, cond)


def equal(x, y, cond=None):
    return _compare('equal', x, y, cond)


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase='both'):
    helper = LayerHelper('print')
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(type='print', inputs={'In': [input]},
                     outputs={'Out': [out]},
                     attrs={'message': message or ''})
    return out


def is_empty(x, cond=None):
    helper = LayerHelper('is_empty')
    if cond is None:
        cond = helper.create_variable_for_type_inference('bool')
        cond.shape = (1,)
    helper.append_op(type='is_empty', inputs={'X': [x]},
                     outputs={'Out': [cond]})
    return cond


# --- tensor array emulation -------------------------------------------------
# The reference framework's LoDTensorArray is a dynamic list; here, as in
# the JAX package, an array is a dense [capacity, ...] tensor written and
# read at a tensor index (ops/control_ops.py).

def create_array(dtype):
    helper = LayerHelper('array')
    out = helper.create_variable_for_type_inference(dtype)
    out.is_tensor_array = True
    return out


def array_write(x, i, array=None):
    helper = LayerHelper('array_write')
    if array is None:
        array = create_array(x.dtype)
    helper.append_op(type='array_write',
                     inputs={'X': [x], 'I': [i]},
                     outputs={'Out': [array]})
    return array


def array_read(array, i):
    helper = LayerHelper('array_read')
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op(type='array_read', inputs={'X': [array], 'I': [i]},
                     outputs={'Out': [out]})
    return out


def array_length(array):
    helper = LayerHelper('array_length')
    out = helper.create_variable_for_type_inference('int64')
    out.shape = (1,)
    helper.append_op(type='array_length', inputs={'X': [array]},
                     outputs={'Out': [out]})
    return out


class While(object):
    """While loop (reference control_flow.py:While); its op reads the
    condition on the host each turn, so a plan holding it runs eagerly.

    Body ops are captured in a child block; loop-carried state is every
    persistable/outer var both read and written by the body.
    """

    def __init__(self, cond, name=None):
        self.helper = LayerHelper('while', name=name)
        self.cond_var = cond
        self.program = default_main_program()

    class _Guard(object):
        def __init__(self, owner):
            self.owner = owner

        def __enter__(self):
            self.owner.block = self.owner.program.create_block()
            return self

        def __exit__(self, *exc):
            self.owner.program.rollback()
            block = self.owner.block
            parent = self.owner.program.current_block()
            written = []
            for op in block.ops:
                for n in op.output_names():
                    var = parent._find_var_recursive(n)
                    if var is not None and n not in written:
                        written.append(n)
            out_vars = [parent._find_var_recursive(n) for n in written]
            parent.append_op(
                type='while',
                inputs={'Condition': [self.owner.cond_var]},
                outputs={'Out': out_vars},
                attrs={'sub_block': block.idx})
            return False

    def block(self):
        return While._Guard(self)


class StaticRNN(object):
    """Static RNN (reference control_flow.py:StaticRNN): its op loops over
    the step inputs' T."""

    def __init__(self, name=None):
        self.helper = LayerHelper('static_rnn', name=name)
        self.program = default_main_program()
        self._inputs = []
        self._memories = []
        self._outputs = []
        self._sub_block = None

    class _Guard(object):
        def __init__(self, rnn):
            self.rnn = rnn

        def __enter__(self):
            self.rnn._sub_block = self.rnn.program.create_block()
            return self

        def __exit__(self, *exc):
            self.rnn.program.rollback()
            parent = self.rnn.program.current_block()
            parent.append_op(
                type='static_rnn',
                inputs={'Inputs': [v for v, _ in self.rnn._inputs],
                        'BootMemories': [m['init'] for m in
                                         self.rnn._memories]},
                outputs={'Outputs': self.rnn._outputs},
                attrs={'sub_block': self.rnn._sub_block.idx,
                       'step_input_names': [s for _, s in self.rnn._inputs],
                       'memory_names': [(m['pre'], m['cur'])
                                        for m in self.rnn._memories],
                       'output_names': [o.name for o in self.rnn._outputs]})
            return False

    def step(self):
        return StaticRNN._Guard(self)

    def step_input(self, x):
        helper = LayerHelper('rnn_step_input')
        step = helper.create_variable_for_type_inference(x.dtype)
        if x.shape is not None and len(x.shape) >= 2:
            step.shape = (x.shape[0],) + tuple(x.shape[2:])
        self._inputs.append((x, step.name))
        return step

    def memory(self, init=None, shape=None, value=0.0, batch_ref=None,
               dtype='float32'):
        helper = LayerHelper('rnn_memory')
        if init is None:
            if batch_ref is None:
                raise ValueError('memory needs init or batch_ref')
            from .tensor import fill_constant_batch_size_like
            with _in_parent_block(self.program):
                init = fill_constant_batch_size_like(
                    batch_ref, [1] + list(shape), dtype, value)
        pre = helper.create_variable_for_type_inference(init.dtype)
        pre.shape = init.shape
        self._memories.append({'init': init, 'pre': pre.name, 'cur': None})
        return pre

    def update_memory(self, mem, var):
        for m in self._memories:
            if m['pre'] == mem.name:
                m['cur'] = var.name
                return
        raise ValueError('unknown rnn memory %r' % mem.name)

    def step_output(self, o):
        self._outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def __call__(self):
        return self._outputs[0] if len(self._outputs) == 1 else self._outputs


class Switch(object):
    """Switch (control_flow.py:Switch): as in the JAX package, a context
    whose cases emit their ops unconditionally; no op of its own."""

    def __init__(self, name=None):
        self.helper = LayerHelper('switch', name=name)
        self.cases = []
        self.default_ops = None

    def case(self, condition):
        @contextlib.contextmanager
        def _case():
            yield
        return _case()

    def default(self):
        return self.case(None)


class IfElse(object):
    """Per-example branch select (reference control_flow.py:IfElse).

    The reference gathers the true/false sub-batches and runs each branch
    on its slice; here, as in the JAX package, both branches run on the
    full batch and the outputs merge by the mask. API-compatible:

        ie = IfElse(cond)               # cond: [B, 1] bool
        with ie.true_block():
            ie.output(a)
        with ie.false_block():
            ie.output(b)
        out, = ie()
    """

    def __init__(self, cond, name=None):
        self.helper = LayerHelper('if_else', name=name)
        self.cond = cond
        self.program = default_main_program()
        self._blocks = {}          # 'true' / 'false' -> block idx
        self._outputs = {'true': [], 'false': []}
        self._current = None

    class _Guard(object):
        def __init__(self, owner, which):
            self.owner, self.which = owner, which

        def __enter__(self):
            self.owner._current = self.which
            block = self.owner.program.create_block()
            self.owner._blocks[self.which] = block.idx
            return self

        def __exit__(self, *exc):
            self.owner.program.rollback()
            self.owner._current = None
            return False

    def true_block(self):
        return IfElse._Guard(self, 'true')

    def false_block(self):
        return IfElse._Guard(self, 'false')

    def input(self, x):
        # reference slices x to the branch sub-batch; full-batch here
        return x

    def output(self, *outs):
        if self._current is None:
            raise ValueError('IfElse.output() must be called inside '
                             'true_block()/false_block()')
        self._outputs[self._current].extend(outs)

    def __call__(self):
        t_outs = self._outputs['true']
        f_outs = self._outputs['false']
        if len(t_outs) != len(f_outs):
            raise ValueError(
                'IfElse branches declared %d vs %d outputs; they must '
                'match pairwise' % (len(t_outs), len(f_outs)))
        parent = self.program.current_block()
        merged = []
        for tv in t_outs:
            var = self.helper.create_variable_for_type_inference(tv.dtype)
            if tv.shape is not None:
                var.shape = tuple(tv.shape)
            merged.append(var)
        parent.append_op(
            type='if_else',
            inputs={'Cond': [self.cond]},
            outputs={'Outs': merged},
            attrs={'true_block': self._blocks['true'],
                   'false_block': self._blocks['false'],
                   'true_names': [v.name for v in t_outs],
                   'false_names': [v.name for v in f_outs]})
        return merged


class DynamicRNN(object):
    """Length-masked RNN over padded [B, T, ...] inputs (reference
    control_flow.py:DynamicRNN over LoD). step_input takes the padded
    sequence; pass `length` to mask updates past each sequence end."""

    def __init__(self, length=None, name=None):
        self.helper = LayerHelper('dynamic_rnn', name=name)
        self.program = default_main_program()
        self.length = length
        self._inputs = []
        self._memories = []
        self._outputs = []
        self._sub_block = None

    class _Guard(object):
        def __init__(self, rnn):
            self.rnn = rnn

        def __enter__(self):
            self.rnn._sub_block = self.rnn.program.create_block()
            return self

        def __exit__(self, *exc):
            self.rnn.program.rollback()
            rnn = self.rnn
            parent = rnn.program.current_block()
            out_vars = []
            for o in rnn._outputs:
                var = rnn.helper.create_variable_for_type_inference(o.dtype)
                if o.shape is not None:
                    var.shape = (o.shape[0], None) + tuple(o.shape[1:])
                out_vars.append(var)
            final_mems = []
            for m in rnn._memories:
                var = rnn.helper.create_variable_for_type_inference(
                    m['init'].dtype)
                if m['init'].shape is not None:
                    var.shape = tuple(m['init'].shape)
                final_mems.append(var)
            inputs = {'Inputs': [v for v, _ in rnn._inputs],
                      'BootMemories': [m['init'] for m in rnn._memories]}
            if rnn.length is not None:
                inputs['Length'] = [rnn.length]
            parent.append_op(
                type='dynamic_rnn',
                inputs=inputs,
                outputs={'Outputs': out_vars, 'FinalMemories': final_mems},
                attrs={'sub_block': rnn._sub_block.idx,
                       'step_input_names': [s for _, s in rnn._inputs],
                       'memory_names': [(m['pre'], m['cur'])
                                        for m in rnn._memories],
                       'output_names': [o.name for o in rnn._outputs]})
            rnn._out_vars = out_vars
            return False

    def block(self):
        return DynamicRNN._Guard(self)

    def step_input(self, x):
        helper = LayerHelper('drnn_step_input')
        step = helper.create_variable_for_type_inference(x.dtype)
        if x.shape is not None and len(x.shape) >= 2:
            step.shape = (x.shape[0],) + tuple(x.shape[2:])
        self._inputs.append((x, step.name))
        return step

    def memory(self, init=None, shape=None, value=0.0, batch_ref=None,
               dtype='float32'):
        helper = LayerHelper('drnn_memory')
        if init is None:
            if batch_ref is None and not self._inputs:
                raise ValueError('memory needs init or batch_ref')
            from .tensor import fill_constant_batch_size_like
            ref = batch_ref if batch_ref is not None else self._inputs[0][0]
            with _in_parent_block(self.program):
                init = fill_constant_batch_size_like(
                    ref, [1] + list(shape), dtype, value)
        pre = helper.create_variable_for_type_inference(init.dtype)
        pre.shape = init.shape
        self._memories.append({'init': init, 'pre': pre.name, 'cur': None})
        return pre

    def update_memory(self, mem, var):
        for m in self._memories:
            if m['pre'] == mem.name:
                m['cur'] = var.name
                return
        raise ValueError('unknown dynamic_rnn memory %r' % mem.name)

    def output(self, *outputs):
        self._outputs.extend(outputs)

    def __call__(self):
        vars_ = self._out_vars
        return vars_[0] if len(vars_) == 1 else vars_

