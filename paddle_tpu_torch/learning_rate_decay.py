"""Learning-rate schedules (reference: paddle_tpu learning_rate_decay.py;
python/paddle/fluid/learning_rate_decay.py).

Each schedule is one ``lr_decay`` op (ops/lr_ops.py) reading the
program's ``@LR_DECAY_COUNTER@``, a persistable int64 step counter that an
``increment`` op advances once a run; pass the returned Variable as an
optimizer's ``learning_rate``."""

from .layers import nn as _nn
from .layers.helper import LayerHelper

__all__ = ['exponential_decay', 'natural_exp_decay', 'inverse_time_decay',
           'polynomial_decay', 'piecewise_decay', 'cosine_decay',
           'noam_decay']


def _decay_op(attrs):
    helper = LayerHelper('lr_decay')
    step = _nn.autoincreased_step_counter(counter_name='@LR_DECAY_COUNTER@',
                                          begin=0)
    out = helper.create_variable_for_type_inference('float32')
    out.shape = (1,)
    out.stop_gradient = True
    helper.append_op(type='lr_decay', inputs={'Step': [step]},
                     outputs={'Out': [out]}, attrs=attrs)
    return out


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    return _decay_op({'kind': 'exponential',
                      'learning_rate': float(learning_rate),
                      'decay_steps': decay_steps, 'decay_rate': decay_rate,
                      'staircase': staircase})


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    return _decay_op({'kind': 'natural_exp',
                      'learning_rate': float(learning_rate),
                      'decay_steps': decay_steps, 'decay_rate': decay_rate,
                      'staircase': staircase})


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    return _decay_op({'kind': 'inverse_time',
                      'learning_rate': float(learning_rate),
                      'decay_steps': decay_steps, 'decay_rate': decay_rate,
                      'staircase': staircase})


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    return _decay_op({'kind': 'polynomial',
                      'learning_rate': float(learning_rate),
                      'decay_steps': decay_steps,
                      'end_learning_rate': end_learning_rate,
                      'power': power, 'cycle': cycle})


def piecewise_decay(boundaries, values):
    if len(values) - len(boundaries) != 1:
        raise ValueError('len(values) must be len(boundaries) + 1')
    return _decay_op({'kind': 'piecewise',
                      'learning_rate': float(values[0]),
                      'boundaries': [float(b) for b in boundaries],
                      'values': [float(v) for v in values]})


def cosine_decay(learning_rate, step_each_epoch, epochs):
    return _decay_op({'kind': 'cosine',
                      'learning_rate': float(learning_rate),
                      'total_steps': float(step_each_epoch * epochs)})


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    return _decay_op({'kind': 'noam', 'learning_rate': float(learning_rate),
                      'd_model': float(d_model),
                      'warmup_steps': float(warmup_steps)})
