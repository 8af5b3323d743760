"""LayerHelper (reference: python/paddle/fluid/layer_helper.py).

Creates parameters (with startup-program init ops), temp output vars, and
appends ops to the current main program block.
"""

from ..core import unique_name
from ..core.dtypes import canonical_dtype
from ..core.program import default_main_program, default_startup_program
from ..initializer import Constant, Xavier
from ..param_attr import ParamAttr, WeightNormParamAttr


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

    def multiple_input(self, input_param_name='input'):
        inputs = self.kwargs.get(input_param_name, [])
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        return list(inputs)

    def input(self, input_param_name='input'):
        inputs = self.multiple_input(input_param_name)
        if len(inputs) != 1:
            raise ValueError('%s layer needs exactly one input' %
                             self.layer_type)
        return inputs[0]

    @property
    def param_attr(self):
        return ParamAttr.to_attr(self.kwargs.get('param_attr', None))

    @property
    def bias_attr(self):
        return ParamAttr.to_attr(self.kwargs.get('bias_attr', None))

    def input_dtype(self, input_param_name='input'):
        dtype = None
        for v in self.multiple_input(input_param_name):
            if dtype is None:
                dtype = v.dtype
            elif canonical_dtype(dtype) != canonical_dtype(v.dtype):
                raise ValueError('mixed input dtypes: %s vs %s' %
                                 (dtype, v.dtype))
        return dtype

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
        if isinstance(attr, WeightNormParamAttr):
            return self._create_weight_normalized(attr, name, shape, dtype)
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

    def _create_weight_normalized(self, attr, name, shape, dtype):
        """w = g * v / ||v||, the norm over every axis but attr.dim (one
        weight_norm op; g set to ||v|| by a startup weight_norm_g_init op,
        so training starts at v). v and g are the trainable parameters;
        the returned w is computed in the graph at every step."""
        dim = attr.dim
        shape = [int(s) for s in shape]
        if dim is not None:
            if not -len(shape) <= dim < len(shape):
                raise ValueError(
                    'WeightNormParamAttr: dim=%d out of range for a '
                    '%d-D weight' % (dim, len(shape)))
            dim = dim % len(shape)  # -1 on the wire means every axis
        block = self.main_program.global_block()
        v_kwargs = attr.to_kwargs(with_initializer=True)
        v_kwargs.pop('name', None)
        v = block.create_parameter(name + '.wn_v', shape=shape,
                                   dtype=dtype, **v_kwargs)
        if not _startup_has(v.name):    # the first init wins
            attr.initializer(v)
        g_shape = [1] if dim is None else [shape[dim]]
        # g takes every training attr of the ParamAttr but its initializer
        g_kwargs = attr.to_kwargs()
        g_kwargs.pop('name', None)
        g = block.create_parameter(name + '.wn_g', shape=g_shape,
                                   dtype=dtype, **g_kwargs)
        sb = self.startup_program.global_block()
        if g.name not in sb.vars:       # the first init wins
            sb.create_var(name=g.name, shape=tuple(g_shape), dtype=dtype,
                          persistable=True)
            sb.append_op(type='weight_norm_g_init', inputs={'V': [v]},
                         outputs={'G': [g]},
                         attrs={'dim': -1 if dim is None else int(dim)})
        self.main_program._startup_ref = self.startup_program
        w = self.block.create_var(name=name, dtype=dtype)
        w.shape = tuple(shape)
        w.stop_gradient = False
        self.block.append_op(
            type='weight_norm', inputs={'V': [v], 'G': [g]},
            outputs={'W': [w]},
            attrs={'dim': -1 if dim is None else int(dim)})
        return w

    def create_variable_for_type_inference(self, dtype=None):
        if dtype is None:
            dtype = 'float32'
        return self.block.create_var(
            name=unique_name.generate('.'.join([self.name, 'tmp'])),
            dtype=dtype)

    create_tmp_variable = create_variable_for_type_inference

    def create_variable(self, *args, **kwargs):
        return self.block.create_var(*args, **kwargs)

    def create_global_variable(self, persistable=False, *args, **kwargs):
        block = self.main_program.global_block()
        return block.create_var(
            *args, persistable=persistable,
            name=kwargs.pop('name', unique_name.generate('.'.join(
                [self.name, 'tmp']))), **kwargs)

    def set_variable_initializer(self, var, initializer):
        initializer(var)

    def append_bias_op(self, input_var, size, axis=1):
        """input + bias (a new [size] parameter from bias_attr), or input
        itself when bias_attr is False."""
        bias_attr = self.bias_attr
        if bias_attr is False:
            return input_var
        b = self.create_parameter(attr=bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        tmp = self.create_variable_for_type_inference(input_var.dtype)
        tmp.shape = input_var.shape
        self.append_op(type='elementwise_add',
                       inputs={'X': [input_var], 'Y': [b]},
                       outputs={'Out': [tmp]}, attrs={'axis': axis})
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get('act', None)
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {'type': act}
        act = dict(act)
        act_type = act.pop('type')
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        tmp.shape = input_var.shape
        self.append_op(type=act_type, inputs={'X': [input_var]},
                       outputs={'Out': [tmp]}, attrs=act)
        return tmp
