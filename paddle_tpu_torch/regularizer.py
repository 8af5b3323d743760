"""Weight-decay regularizers (reference: paddle_tpu regularizer.py;
python/paddle/fluid/regularizer.py).

Appended as ops that turn ``p@GRAD`` into the decayed gradient between
the backward marker and the optimizer update, as in the reference:
L2 adds coeff · p, L1 adds coeff · sign(p)."""

from .layers.helper import LayerHelper

__all__ = ['append_regularization_ops', 'L1Decay', 'L2Decay',
           'L1DecayRegularizer', 'L2DecayRegularizer']


class WeightDecayRegularizer(object):
    def append_ops(self, param, grad, helper):
        raise NotImplementedError


def _grad_like(helper, grad):
    out = helper.create_variable_for_type_inference(grad.dtype)
    out.shape = grad.shape
    out.stop_gradient = True
    return out


def _add_decay(helper, grad, decayed):
    out = _grad_like(helper, grad)
    helper.append_op(type='elementwise_add',
                     inputs={'X': [grad], 'Y': [decayed]},
                     outputs={'Out': [out]}, attrs={'axis': -1})
    return out


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def append_ops(self, param, grad, helper):
        decayed = _grad_like(helper, grad)
        helper.append_op(type='scale', inputs={'X': [param]},
                         outputs={'Out': [decayed]},
                         attrs={'scale': self._coeff})
        return _add_decay(helper, grad, decayed)


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def append_ops(self, param, grad, helper):
        sign = _grad_like(helper, grad)
        helper.append_op(type='sign', inputs={'X': [param]},
                         outputs={'Out': [sign]})
        decayed = _grad_like(helper, grad)
        helper.append_op(type='scale', inputs={'X': [sign]},
                         outputs={'Out': [decayed]},
                         attrs={'scale': self._coeff})
        return _add_decay(helper, grad, decayed)


def append_regularization_ops(parameters_and_grads, regularization=None):
    """[(param, grad)] with each regularized parameter's gradient
    replaced by the decayed one (the parameter's own regularizer first,
    else the optimizer's)."""
    helper = LayerHelper('regularization')
    result = []
    for param, grad in parameters_and_grads:
        regularizer = getattr(param, 'regularizer', None) or regularization
        if grad is None or regularizer is None:
            result.append((param, grad))
            continue
        result.append((param, regularizer.append_ops(param, grad, helper)))
    return result


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
