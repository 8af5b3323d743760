"""Control-flow layers (reference: paddle_tpu layers/control_flow.py;
fluid/layers/control_flow.py): increment, equal and less_than (the two
comparisons the unrolled greedy decode builds) and Print. The loop
constructs (While, StaticRNN, DynamicRNN, IfElse, Switch), is_empty and
the array layers are not ported."""

from .helper import LayerHelper

__all__ = ['increment', 'less_than', 'equal', 'Print']


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
