"""LayerHelper (reference: python/paddle/fluid/layer_helper.py).

Creates parameters (with startup-program init ops), temp output vars, and
appends ops to the current main program block.
"""

from ..core import unique_name
from ..core.program import default_main_program, default_startup_program
from ..initializer import Constant, Xavier
from ..param_attr import ParamAttr


def _startup_has(name):
    """True iff the default startup program already initializes `name`
    (every initializer create_var()s its target there first)."""
    return name in default_startup_program().global_block().vars


class LayerHelper(object):
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get('name', None)
        self.name = name if name is not None else \
            unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def append_op(self, *args, **kwargs):
        return self.block.append_op(*args, **kwargs)

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        if attr is False:
            return None
        attr = ParamAttr.to_attr(attr)
        if default_initializer is None:
            default_initializer = Constant(0.0) if is_bias else Xavier()
        attr.set_default_initializer(default_initializer)
        name = attr.name if attr.name is not None else \
            unique_name.generate('%s.w' % self.name if not is_bias
                                 else '%s.b' % self.name)
        block = self.main_program.global_block()
        kwargs = attr.to_kwargs(with_initializer=True)
        kwargs.pop('name', None)
        param = block.create_parameter(
            name, shape=[int(s) for s in shape], dtype=dtype, **kwargs)
        # A parameter shared by name across programs keeps its FIRST init
        # op: a second, later one would win by running later.
        if not _startup_has(name):
            attr.initializer(param)
        self.main_program._startup_ref = self.startup_program
        return param

    def create_variable_for_type_inference(self, dtype=None):
        if dtype is None:
            dtype = 'float32'
        return self.block.create_var(
            name=unique_name.generate('.'.join([self.name, 'tmp'])),
            dtype=dtype)
