"""Program IR: Variable / Operator / Block / Program.

Reference: python/paddle/fluid/framework.py (Program/Block/Variable/Operator)
and paddle/fluid/framework/{program_desc,block_desc,op_desc}.{h,cc}.

The Program is a pure description: nothing executes at build time. The
Executor walks its ops through the registered torch lowerings. Mutating a
Program bumps its version so the executor's per-program caches
invalidate.
"""

import contextlib
import os
import sys

from . import unique_name
from .dtypes import canonical_dtype

# Root of the package: frames under it are framework machinery, frames
# outside it are the user code an op's provenance points at
# (core/program.py -> core -> paddle_tpu_torch).
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep


def _capture_provenance():
    """'file.py:line' of the nearest frame outside the package on the
    stack: the user statement that (through any layers) appended the op.
    One short frame walk an append_op; PADDLE_TPU_PROVENANCE=0 turns it
    off (None is stored). None too where the whole stack is the
    package's own (programs built by clone and serialize keep the
    original op's provenance instead)."""
    if os.environ.get('PADDLE_TPU_PROVENANCE') == '0':
        return None
    f = sys._getframe(2)   # skip this function and append/prepend_op
    depth = 0
    while f is not None and depth < 40:
        filename = f.f_code.co_filename
        if not filename.startswith(_PKG_DIR) and \
                not filename.startswith('<'):
            return '%s:%d' % (filename, f.f_lineno)
        f = f.f_back
        depth += 1
    return None


class Variable(object):
    """A named tensor slot inside a Block.

    shape uses -1 for the (leading) batch dimension of data vars; concrete
    shapes come from the feed at run time.
    """

    def __init__(self, block, name, shape=None, dtype='float32', lod_level=0,
                 persistable=False, stop_gradient=False, is_data=False,
                 trainable=False, error_clip=None):
        self.block = block
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = canonical_dtype(dtype)
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.trainable = trainable
        self._error_clip = error_clip

    @property
    def error_clip(self):
        """An ``ErrorClipByValue`` clamping the gradient that flows back
        through this var (the executor applies it), or None."""
        return self._error_clip

    @error_clip.setter
    def error_clip(self, value):
        # the executor keys its plans and graphs on the program version: a
        # clip set after a run must not be ignored by them
        self._error_clip = value
        if self.block is not None and self.block.program is not None:
            self.block.program._bump_version()

    @property
    def program(self):
        return self.block.program

    def __repr__(self):
        return 'Variable(%s, shape=%s, dtype=%s%s)' % (
            self.name, self.shape, self.dtype,
            ', persistable' if self.persistable else '')

    # Arithmetic sugar (reference: fluid/layers/math_op_patch.py
    # monkey_patch_variable), through the layers, imported late: they
    # import this module. A number becomes a [1] fill_constant of this
    # var's dtype. == and < keep their identity meaning (use
    # layers.equal / layers.less_than), so vars stay usable in sets and
    # dicts.
    def _binary(self, other, op, reverse=False):
        from ..layers import tensor as _tensor
        if not isinstance(other, Variable):
            other = _tensor.fill_constant(
                shape=[1], dtype=self.dtype, value=float(other))
        a, b = (other, self) if reverse else (self, other)
        return op(a, b)

    def __add__(self, other):
        from ..layers import ops as _ops
        return self._binary(other, _ops.elementwise_add)

    __radd__ = __add__

    def __sub__(self, other):
        from ..layers import ops as _ops
        return self._binary(other, _ops.elementwise_sub)

    def __rsub__(self, other):
        from ..layers import ops as _ops
        return self._binary(other, _ops.elementwise_sub, reverse=True)

    def __mul__(self, other):
        from ..layers import ops as _ops
        return self._binary(other, _ops.elementwise_mul)

    __rmul__ = __mul__

    def __truediv__(self, other):
        from ..layers import ops as _ops
        return self._binary(other, _ops.elementwise_div)

    def astype(self, dtype):
        from ..layers import tensor as _tensor
        return _tensor.cast(self, dtype)


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
    """One op invocation. inputs/outputs map slot name -> list of var names.

    ``provenance`` is the 'file.py:line' of the user statement that built
    the op (captured by Block.append_op; None with
    PADDLE_TPU_PROVENANCE=0 or for ops the package built on its own).
    """

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None,
                 provenance=None):
        self.block = block
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        self.provenance = provenance

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
        where = ' @ %s' % self.provenance if self.provenance else ''
        return 'Op(%s, in=%s, out=%s%s)' % (self.type, self.inputs,
                                            self.outputs, where)


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
        op = Operator(self, type, inputs, outputs, attrs,
                      provenance=_capture_provenance())
        self.ops.append(op)
        self.program._bump_version()
        return op

    def prepend_op(self, type, inputs=None, outputs=None, attrs=None):
        inputs = {k: _to_name_list(v) for k, v in (inputs or {}).items()}
        outputs = {k: _to_name_list(v) for k, v in (outputs or {}).items()}
        op = Operator(self, type, inputs, outputs, attrs,
                      provenance=_capture_provenance())
        self.ops.insert(0, op)
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

    def create_block(self, parent_idx=None):
        """A new block (child of ``parent_idx``, by default of the current
        block), made the current one."""
        parent_idx = self.current_block_idx if parent_idx is None \
            else parent_idx
        block = Block(self, len(self.blocks), parent_idx)
        self.blocks.append(block)
        self.current_block_idx = block.idx
        self._bump_version()
        return block

    def rollback(self):
        """Make the current block's parent the current block again."""
        self.current_block_idx = max(self.current_block().parent_idx, 0)

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

    def clone(self, for_test=False):
        """A copy of the program (reference: paddle_tpu core/program.py
        Program.clone). ``for_test=True`` drops the backward marker and
        every op after it (the backward and the update) and sets is_test
        on the ops that have it, dropout and batch_norm among them."""
        p = Program()
        p._seed = self._seed
        for i, b in enumerate(self.blocks):
            nb = p.blocks[0] if i == 0 else Block(p, i, b.parent_idx)
            if i:
                p.blocks.append(nb)
            for name, v in b.vars.items():
                if isinstance(v, Parameter):
                    nv = Parameter(nb, name, v.shape, v.dtype,
                                   trainable=v.trainable,
                                   optimize_attr=dict(v.optimize_attr),
                                   regularizer=v.regularizer,
                                   gradient_clip_attr=v.gradient_clip_attr,
                                   initializer=v.initializer)
                    nv.stop_gradient = v.stop_gradient
                else:
                    nv = Variable(nb, name, shape=v.shape, dtype=v.dtype,
                                  lod_level=v.lod_level,
                                  persistable=v.persistable,
                                  stop_gradient=v.stop_gradient,
                                  is_data=v.is_data, trainable=v.trainable)
                nv._error_clip = v._error_clip
                # the row-sparse annotations: an is_sparse table's flag
                # and its gradient's Ids (core/backward.py)
                for extra in ('sparse_grad', 'sparse_ids'):
                    if hasattr(v, extra):
                        setattr(nv, extra, getattr(v, extra))
                nb.vars[name] = nv
            for op in b.ops:
                if for_test and op.type == 'backward_marker':
                    break   # everything after the backward trains
                attrs = dict(op.attrs)
                if for_test and ('is_test' in attrs or
                                 op.type in ('dropout', 'batch_norm')):
                    attrs['is_test'] = True
                # the original construction site, not the clone call
                nb.append_op(op.type, op.inputs, op.outputs,
                             attrs).provenance = op.provenance
        p.current_block_idx = 0
        return p

    def prune(self, targets):
        """A clone keeping only the ops the target vars need (reference:
        paddle_tpu core/program.py Program.prune; framework/prune.cc)."""
        target_names = set(t.name if isinstance(t, Variable) else t
                           for t in targets)
        p = self.clone()
        b = p.global_block()
        needed = set(target_names)
        kept = []
        for op in reversed(b.ops):
            if set(op.output_names()) & needed or \
                    op.type == 'backward_marker':
                kept.append(op)
                needed.update(op.input_names())
        b.ops = list(reversed(kept))
        p._bump_version()
        return p

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
