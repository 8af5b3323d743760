"""Optimizers (reference: paddle_tpu optimizer.py;
python/paddle/fluid/optimizer.py): Optimizer, SGD and Adam.

minimize() appends the backward marker, then one update op per
parameter; the Executor runs the update ops in place after the
gradients exist. Gradient clipping and regularization are not ported: a
parameter or optimizer that sets either raises NotImplementedError.
"""

from .core import unique_name
from .core.backward import append_backward
from .core.program import (Variable, default_main_program,
                           default_startup_program, program_guard)
from .initializer import Constant
from .layers.helper import LayerHelper

__all__ = ['SGD', 'Adam', 'SGDOptimizer', 'AdamOptimizer', 'Optimizer']


def append_gradient_clip_ops(param_grads):
    """Pass-through while no gradient clip is set."""
    program_clip = getattr(default_main_program(), '_gradient_clip_attr',
                           None)
    for p, _ in param_grads:
        if getattr(p, 'gradient_clip_attr', None) or program_clip:
            raise NotImplementedError(
                'gradient clipping is not ported to paddle_tpu_torch '
                '(parameter %r)' % p.name)
    return param_grads


def append_regularization_ops(param_grads, regularization=None):
    """Pass-through while no regularizer is set."""
    for p, _ in param_grads:
        if getattr(p, 'regularizer', None) or regularization:
            raise NotImplementedError(
                'weight regularization is not ported to paddle_tpu_torch '
                '(parameter %r)' % p.name)
    return param_grads


class Optimizer(object):
    def __init__(self, learning_rate, regularization=None, name=None):
        if not isinstance(learning_rate, (float, Variable)):
            raise TypeError('learning_rate must be float or Variable')
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._name = name
        self._accumulators = {}
        self._learning_rate_var = None
        self.helper = None

    # ---------------------------------------------------------------- lr
    def _create_global_learning_rate(self):
        if self._learning_rate_var is not None:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_var = self._learning_rate
            return
        helper = LayerHelper('learning_rate')
        var = helper.main_program.global_block().create_var(
            name=unique_name.generate('learning_rate'), shape=(1,),
            dtype='float32', persistable=True)
        var.stop_gradient = True
        Constant(float(self._learning_rate))(var)
        self._learning_rate_var = var

    def _create_param_lr(self, param_and_grad):
        mult = getattr(param_and_grad[0], 'optimize_attr', {}).get(
            'learning_rate', 1.0)
        if mult == 1.0:
            return self._learning_rate_var
        helper = LayerHelper('param_lr')
        out = helper.create_variable_for_type_inference('float32')
        out.shape = (1,)
        out.stop_gradient = True
        helper.append_op(type='scale',
                         inputs={'X': [self._learning_rate_var]},
                         outputs={'Out': [out]}, attrs={'scale': mult})
        return out

    # ------------------------------------------------------- accumulators
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if (name, param.name) in self._accumulators:
            raise ValueError('accumulator %s for %s exists' %
                             (name, param.name))
        var = default_main_program().global_block().create_var(
            name='%s_%s_acc' % (param.name, name),
            shape=tuple(shape) if shape is not None else param.shape,
            dtype=dtype or param.dtype, persistable=True)
        var.stop_gradient = True
        Constant(float(fill_value))(var)
        self._accumulators[(name, param.name)] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[(name, param.name)]

    # ----------------------------------------------------------- hooks
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block):
        pass

    # --------------------------------------------------------- minimize
    def _create_optimization_pass(self, parameters_and_grads, loss,
                                  startup_program=None):
        block = loss.block.program.global_block()
        self.helper = LayerHelper(self.__class__.__name__)
        self._create_global_learning_rate()
        self._create_accumulators(block,
                                  [p for p, _ in parameters_and_grads])
        optimize_ops = []
        for param_and_grad in parameters_and_grads:
            if param_and_grad[1] is None or not param_and_grad[0].trainable:
                continue
            optimize_ops.append(
                self._append_optimize_op(block, param_and_grad))
        self._finish_update(block)
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """Append backward + update ops to the loss's program (and their
        initializers to its startup program). Returns (optimize_ops,
        params_grads)."""
        main_program = loss.block.program
        if startup_program is None:
            startup_program = main_program._startup_ref or \
                default_startup_program()
        with program_guard(main_program, startup_program):
            params_grads = append_backward(loss, parameter_list,
                                           no_grad_set)
            params_grads = append_gradient_clip_ops(params_grads)
            params_grads = append_regularization_ops(params_grads,
                                                     self.regularization)
            optimize_ops = self._create_optimization_pass(
                params_grads, loss, startup_program)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        return block.append_op(
            type='sgd',
            inputs={'Param': [param], 'Grad': [grad],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param]})


class AdamOptimizer(Optimizer):
    _moment1_acc_str = 'moment1'
    _moment2_acc_str = 'moment2'

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        """Dense Adam. ``lazy_mode`` (the JAX package's row-sparse
        embedding update) is not ported and raises."""
        if lazy_mode:
            raise NotImplementedError(
                'AdamOptimizer(lazy_mode=True) needs row-sparse gradients, '
                'which paddle_tpu_torch does not port')
        super(AdamOptimizer, self).__init__(learning_rate, **kwargs)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._beta1_pow = None
        self._beta2_pow = None

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment1_acc_str, p)
            self._add_accumulator(self._moment2_acc_str, p)
        main = default_main_program().global_block()
        for attr, beta in (('_beta1_pow', self._beta1),
                           ('_beta2_pow', self._beta2)):
            var = main.create_var(
                name=unique_name.generate(attr[1:] + '_acc'), shape=(1,),
                dtype='float32', persistable=True)
            var.stop_gradient = True
            Constant(beta)(var)
            setattr(self, attr, var)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment1 = self._get_accumulator(self._moment1_acc_str, param)
        moment2 = self._get_accumulator(self._moment2_acc_str, param)
        return block.append_op(
            type='adam',
            inputs={'Param': [param], 'Grad': [grad],
                    'Moment1': [moment1], 'Moment2': [moment2],
                    'Beta1Pow': [self._beta1_pow],
                    'Beta2Pow': [self._beta2_pow],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param], 'Moment1Out': [moment1],
                     'Moment2Out': [moment2]},
            attrs={'beta1': self._beta1, 'beta2': self._beta2,
                   'epsilon': self._epsilon})

    def _finish_update(self, block):
        block.append_op(
            type='adam_beta_pow_update',
            inputs={'Beta1Pow': [self._beta1_pow],
                    'Beta2Pow': [self._beta2_pow]},
            outputs={'Beta1PowOut': [self._beta1_pow],
                     'Beta2PowOut': [self._beta2_pow]},
            attrs={'beta1': self._beta1, 'beta2': self._beta2})


SGD = SGDOptimizer
Adam = AdamOptimizer
