"""Recurrent layers (reference: paddle_tpu layers/rnn.py; fluid's
dynamic_lstm, dynamic_gru, ...): padded [batch, time, dim] sequences with
an optional ``length`` Variable, the ops in ops/rnn_ops.py."""

from .helper import LayerHelper

__all__ = ['dynamic_lstm', 'dynamic_lstmp', 'dynamic_gru', 'gru_unit',
           'lstm_unit', 'simple_rnn']


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=False, is_reverse=False,
                 gate_activation='sigmoid', cell_activation='tanh',
                 candidate_activation='tanh', dtype='float32', name=None,
                 length=None):
    """LSTM over a padded batch. `input` is the pre-projected [B, T, 4D]
    (apply an fc of size 4*hidden first, exactly like the reference
    fluid/layers/nn.py:dynamic_lstm). `size` is 4*hidden_dim."""
    helper = LayerHelper('lstm', **locals())
    hidden_dim = size // 4
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[hidden_dim, 4 * hidden_dim],
                                dtype=dtype)
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    if input.shape is not None:
        hidden.shape = (input.shape[0], input.shape[1], hidden_dim)
        cell.shape = hidden.shape
    inputs = {'Input': [input], 'Weight': [w]}
    if bias_attr is not False:
        bias = helper.create_parameter(attr=helper.bias_attr,
                                       shape=[1, 4 * hidden_dim],
                                       dtype=dtype, is_bias=True)
        inputs['Bias'] = [bias]
    if h_0 is not None:
        inputs['H0'] = [h_0]
    if c_0 is not None:
        inputs['C0'] = [c_0]
    if length is not None:
        inputs['Length'] = [length]
    helper.append_op(
        type='lstm', inputs=inputs,
        outputs={'Hidden': [hidden], 'Cell': [cell]},
        attrs={'use_peepholes': use_peepholes, 'is_reverse': is_reverse,
               'gate_activation': gate_activation,
               'cell_activation': cell_activation,
               'candidate_activation': candidate_activation})
    return hidden, cell


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=False, is_reverse=False,
                  gate_activation='sigmoid', cell_activation='tanh',
                  candidate_activation='tanh', proj_activation='tanh',
                  dtype='float32', name=None, length=None):
    """Projected LSTM (reference dynamic_lstmp / lstmp_op.cc)."""
    helper = LayerHelper('lstmp', **locals())
    hidden_dim = size // 4
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[proj_size, 4 * hidden_dim],
                                dtype=dtype)
    w_proj = helper.create_parameter(attr=helper.param_attr,
                                     shape=[hidden_dim, proj_size],
                                     dtype=dtype)
    proj = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    if input.shape is not None:
        proj.shape = (input.shape[0], input.shape[1], proj_size)
        cell.shape = (input.shape[0], input.shape[1], hidden_dim)
    inputs = {'Input': [input], 'Weight': [w], 'ProjWeight': [w_proj]}
    if bias_attr is not False:
        bias = helper.create_parameter(attr=helper.bias_attr,
                                       shape=[1, 4 * hidden_dim],
                                       dtype=dtype, is_bias=True)
        inputs['Bias'] = [bias]
    if length is not None:
        inputs['Length'] = [length]
    helper.append_op(
        type='lstmp', inputs=inputs,
        outputs={'Projection': [proj], 'Cell': [cell]},
        attrs={'use_peepholes': use_peepholes, 'is_reverse': is_reverse,
               'gate_activation': gate_activation,
               'cell_activation': cell_activation,
               'candidate_activation': candidate_activation,
               'proj_activation': proj_activation})
    return proj, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation='sigmoid',
                candidate_activation='tanh', h_0=None, name=None,
                length=None):
    """GRU over a padded batch; `input` is pre-projected [B, T, 3*size]."""
    helper = LayerHelper('gru', **locals())
    dtype = input.dtype
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[size, 3 * size], dtype=dtype)
    hidden = helper.create_variable_for_type_inference(dtype)
    if input.shape is not None:
        hidden.shape = (input.shape[0], input.shape[1], size)
    inputs = {'Input': [input], 'Weight': [w]}
    if bias_attr is not False:
        bias = helper.create_parameter(attr=helper.bias_attr,
                                       shape=[1, 3 * size], dtype=dtype,
                                       is_bias=True)
        inputs['Bias'] = [bias]
    if h_0 is not None:
        inputs['H0'] = [h_0]
    if length is not None:
        inputs['Length'] = [length]
    helper.append_op(
        type='gru', inputs=inputs, outputs={'Hidden': [hidden]},
        attrs={'is_reverse': is_reverse,
               'gate_activation': gate_activation,
               'activation': candidate_activation})
    return hidden


def simple_rnn(input, act='tanh', is_reverse=False, param_attr=None,
               bias_attr=None, h_0=None, name=None, length=None):
    """Elman RNN h_t = act(x_t + h_{t-1} @ W + b) over a padded
    [B, T, D] batch (the v1 recurrent_layer; no fluid analog — the
    reference serves this via recurrent_group + mixed steps)."""
    helper = LayerHelper('simple_rnn', **locals())
    dtype = input.dtype
    d = int(input.shape[-1])
    w = helper.create_parameter(attr=helper.param_attr, shape=[d, d],
                                dtype=dtype)
    hidden = helper.create_variable_for_type_inference(dtype)
    hidden.shape = tuple(input.shape)
    inputs = {'Input': [input], 'Weight': [w]}
    if bias_attr is not False:
        bias = helper.create_parameter(attr=helper.bias_attr, shape=[1, d],
                                       dtype=dtype, is_bias=True)
        inputs['Bias'] = [bias]
    if h_0 is not None:
        inputs['H0'] = [h_0]
    if length is not None:
        inputs['Length'] = [length]
    helper.append_op(type='simple_rnn', inputs=inputs,
                     outputs={'Hidden': [hidden]},
                     attrs={'activation': act, 'is_reverse': is_reverse})
    return hidden


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation='tanh', gate_activation='sigmoid'):
    """One GRU step (reference nn.py:gru_unit). `size` is 3*hidden_dim."""
    helper = LayerHelper('gru_unit', **locals())
    dtype = input.dtype
    hidden_dim = size // 3
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[hidden_dim, 3 * hidden_dim],
                                dtype=dtype)
    gate = helper.create_variable_for_type_inference(dtype)
    reset_hidden_prev = helper.create_variable_for_type_inference(dtype)
    updated = helper.create_variable_for_type_inference(dtype)
    if hidden.shape is not None:
        updated.shape = hidden.shape
        gate.shape = (hidden.shape[0], 3 * hidden_dim)
        reset_hidden_prev.shape = hidden.shape
    _gru_unit_inputs = {'Input': [input], 'HiddenPrev': [hidden],
                        'Weight': [w]}
    if bias_attr is not False:
        bias = helper.create_parameter(attr=helper.bias_attr,
                                       shape=[1, 3 * hidden_dim],
                                       dtype=dtype, is_bias=True)
        _gru_unit_inputs['Bias'] = [bias]
    helper.append_op(
        type='gru_unit',
        inputs=_gru_unit_inputs,
        outputs={'Gate': [gate], 'ResetHiddenPrev': [reset_hidden_prev],
                 'Hidden': [updated]},
        attrs={'activation': activation, 'gate_activation': gate_activation})
    return updated, reset_hidden_prev, gate


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step (reference nn.py:lstm_unit): fc over [x, h] then gate
    math via the lstm_unit op."""
    from . import nn as _nn
    from .tensor import concat
    helper = LayerHelper('lstm_unit', **locals())
    size = cell_t_prev.shape[-1]
    concat_in = concat([x_t, hidden_t_prev], axis=-1)
    fc_out = _nn.fc(input=concat_in, size=4 * size, param_attr=param_attr,
                    bias_attr=bias_attr)
    c = helper.create_variable_for_type_inference(x_t.dtype)
    h = helper.create_variable_for_type_inference(x_t.dtype)
    c.shape = cell_t_prev.shape
    h.shape = hidden_t_prev.shape
    helper.append_op(type='lstm_unit',
                     inputs={'X': [fc_out], 'C_prev': [cell_t_prev]},
                     outputs={'C': [c], 'H': [h]},
                     attrs={'forget_bias': float(forget_bias)})
    return h, c
