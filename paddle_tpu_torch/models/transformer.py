"""Transformer building blocks the decode LM uses (reference: paddle_tpu
models/transformer.py): the sinusoid position table and the
[n_layer, ...]-stacked layer parameters."""

import numpy as np

from .. import layers
from ..initializer import Constant, Xavier
from ..param_attr import ParamAttr


def position_encoding_table(max_length, d_model):
    """Sinusoidal position table [max_length, d_model] (host-computed once,
    lives on the device as a frozen parameter)."""
    pos = np.arange(max_length)[:, None].astype('float64')
    dim = np.arange(0, d_model, 2).astype('float64')
    inv = 1.0 / np.power(10000.0, dim / d_model)
    angles = pos * inv[None, :]
    table = np.zeros((max_length, d_model), dtype='float32')
    table[:, 0::2] = np.sin(angles)
    table[:, 1::2] = np.cos(angles)
    return table


def _stack_param(name, shape, fan_in, fan_out, constant=None):
    """[n_layer, ...] stacked parameter. Xavier fans are passed explicitly
    (the leading layer axis must not enter the fan computation)."""
    init = Constant(constant) if constant is not None else \
        Xavier(uniform=True, fan_in=fan_in, fan_out=fan_out)
    return layers.create_parameter(
        shape=shape, dtype='float32', name=name,
        attr=ParamAttr(name=name, initializer=init))


def _stacked_layer_params(prefix, n_layer, n_head, d_key, d_value, d_model,
                          d_inner, decoder=False):
    """The layer stack's weight dict, stacked on a leading [n_layer] axis
    (ops/transformer_ops.py slot layout)."""
    L = n_layer
    p = {}

    def attn(pre):
        p[pre + '_q'] = _stack_param('%s_%s_q.w' % (prefix, pre),
                                     [L, d_model, d_key * n_head],
                                     d_model, d_key * n_head)
        p[pre + '_k'] = _stack_param('%s_%s_k.w' % (prefix, pre),
                                     [L, d_model, d_key * n_head],
                                     d_model, d_key * n_head)
        p[pre + '_v'] = _stack_param('%s_%s_v.w' % (prefix, pre),
                                     [L, d_model, d_value * n_head],
                                     d_model, d_value * n_head)
        p[pre + '_o'] = _stack_param('%s_%s_o.w' % (prefix, pre),
                                     [L, d_value * n_head, d_model],
                                     d_value * n_head, d_model)

    def ln(slot):
        p[slot + '_w'] = _stack_param('%s_%s.w' % (prefix, slot),
                                      [L, d_model], 0, 0, constant=1.0)
        p[slot + '_b'] = _stack_param('%s_%s.b' % (prefix, slot),
                                      [L, d_model], 0, 0, constant=0.0)

    attn('slf')
    ln('ln1')
    if decoder:
        attn('cross')
        ln('ln2')
    p['ffn_w1'] = _stack_param('%s_ffn_1.w' % prefix,
                               [L, d_model, d_inner], d_model, d_inner)
    p['ffn_b1'] = _stack_param('%s_ffn_1.b' % prefix, [L, d_inner],
                               0, 0, constant=0.0)
    p['ffn_w2'] = _stack_param('%s_ffn_2.w' % prefix,
                               [L, d_inner, d_model], d_inner, d_model)
    p['ffn_b2'] = _stack_param('%s_ffn_2.b' % prefix, [L, d_model],
                               0, 0, constant=0.0)
    ln('ln3' if decoder else 'ln2')
    return p
