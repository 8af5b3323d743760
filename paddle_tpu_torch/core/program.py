"""Program IR: Variable / Operator / Block / Program.

Reference: python/paddle/fluid/framework.py (Program/Block/Variable/Operator)
and paddle/fluid/framework/{program_desc,block_desc,op_desc}.{h,cc}.

The Program is a pure description: nothing executes at build time. The
Executor walks its ops through the registered torch lowerings. Mutating a
Program bumps its version so the executor's per-program caches
invalidate.
"""

import contextlib

from . import unique_name
from .dtypes import canonical_dtype


class Variable(object):
    """A named tensor slot inside a Block.

    shape uses -1 for the (leading) batch dimension of data vars; concrete
    shapes come from the feed at run time.
    """

    def __init__(self, block, name, shape=None, dtype='float32', lod_level=0,
                 persistable=False, stop_gradient=False, is_data=False,
                 trainable=False):
        self.block = block
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = canonical_dtype(dtype)
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.trainable = trainable

    @property
    def program(self):
        return self.block.program

    def __repr__(self):
        return 'Variable(%s, shape=%s, dtype=%s%s)' % (
            self.name, self.shape, self.dtype,
            ', persistable' if self.persistable else '')


class Parameter(Variable):
    """A trainable persistable Variable (reference: framework.py Parameter).
    The optimizer reads ``trainable``, ``optimize_attr`` (the learning-rate
    multiplier), ``regularizer`` and ``gradient_clip_attr``."""

    def __init__(self, block, name, shape, dtype, **kwargs):
        super(Parameter, self).__init__(
            block, name, shape=shape, dtype=dtype, persistable=True,
            trainable=kwargs.pop('trainable', True),
            lod_level=kwargs.get('lod_level', 0))
        self.optimize_attr = kwargs.get('optimize_attr', {'learning_rate': 1.0})
        self.regularizer = kwargs.get('regularizer', None)
        self.gradient_clip_attr = kwargs.get('gradient_clip_attr', None)
        self.do_model_average = kwargs.get('do_model_average', None)
        self.initializer = kwargs.get('initializer', None)


class Operator(object):
    """One op invocation. inputs/outputs map slot name -> list of var names."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})

    def input(self, slot):
        names = self.inputs.get(slot, [])
        return names[0] if names else None

    def output(self, slot):
        names = self.outputs.get(slot, [])
        return names[0] if names else None

    def input_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    def output_names(self):
        return [n for ns in self.outputs.values() for n in ns]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def __repr__(self):
        return 'Op(%s, in=%s, out=%s)' % (self.type, self.inputs,
                                          self.outputs)


def _to_name_list(value):
    """Normalize op input/output values to a list of variable names."""
    if value is None:
        return []
    if isinstance(value, (Variable, str)):
        value = [value]
    return [v.name if isinstance(v, Variable) else v for v in value]


class Block(object):
    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}
        self.ops = []

    @property
    def parent(self):
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    def create_var(self, name=None, **kwargs):
        if name is None:
            name = unique_name.generate('tmp')
        if name in self.vars:
            return self.vars[name]
        var = Variable(self, name, **kwargs)
        self.vars[name] = var
        self.program._bump_version()
        return var

    def create_parameter(self, name, shape, dtype, **kwargs):
        if name in self.vars:
            return self.vars[name]
        param = Parameter(self, name, shape, dtype, **kwargs)
        self.vars[name] = param
        self.program._bump_version()
        return param

    def var(self, name):
        v = self._find_var_recursive(name)
        if v is None:
            raise KeyError('Variable %r not found in block %d' % (name, self.idx))
        return v

    def _find_var_recursive(self, name):
        if name in self.vars:
            return self.vars[name]
        if self.parent is not None:
            return self.parent._find_var_recursive(name)
        return None

    def has_var(self, name):
        return self._find_var_recursive(name) is not None

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        inputs = {k: _to_name_list(v) for k, v in (inputs or {}).items()}
        outputs = {k: _to_name_list(v) for k, v in (outputs or {}).items()}
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump_version()
        return op

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def __repr__(self):
        return 'Block(%d, %d vars, %d ops)' % (self.idx, len(self.vars),
                                               len(self.ops))


class Program(object):
    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self._version = 0
        self._seed = None
        # the startup Program holding this program's param-init ops
        # (recorded by LayerHelper.create_parameter)
        self._startup_ref = None
        # mixed precision: None (fp32) or 'bf16' — matmul-class ops cast
        # their inputs to bfloat16 while parameters, gradients, optimizer
        # state and loss-class ops stay fp32 (registry.AMP_*)
        self.amp = None

    def _bump_version(self):
        self._version += 1

    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def block(self, idx):
        return self.blocks[idx]

    def all_parameters(self):
        params = []
        for b in self.blocks:
            params.extend(b.all_parameters())
        return params

    def list_vars(self):
        for b in self.blocks:
            for v in b.vars.values():
                yield v

    @property
    def random_seed(self):
        return self._seed

    @random_seed.setter
    def random_seed(self, seed):
        self._seed = seed

    def to_string(self, throw_on_error=False):
        lines = []
        for b in self.blocks:
            lines.append('-- block %d (parent %d) --' % (b.idx, b.parent_idx))
            for name, v in b.vars.items():
                lines.append('  var %s : %s %s%s' % (
                    name, v.dtype, v.shape,
                    ' [persistable]' if v.persistable else ''))
            for op in b.ops:
                lines.append('  %r' % (op,))
        return '\n'.join(lines)

    __str__ = to_string


_main_program = Program()
_startup_program = Program()


def default_main_program():
    return _main_program


def default_startup_program():
    return _startup_program


def switch_main_program(program):
    global _main_program
    old = _main_program
    _main_program = program
    return old


def switch_startup_program(program):
    global _startup_program
    old = _startup_program
    _startup_program = program
    return old


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)


def reset_default_programs():
    global _main_program, _startup_program
    _main_program = Program()
    _startup_program = Program()
    unique_name.reset()
