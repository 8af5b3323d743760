"""Comparison layers (reference: paddle_tpu layers/control_flow.py;
fluid/layers/control_flow.py): equal and less_than, the two the
unrolled greedy decode builds. The loop constructs (While, StaticRNN,
DynamicRNN, IfElse, Switch) are not ported."""

from .helper import LayerHelper

__all__ = ['less_than', 'equal']


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
