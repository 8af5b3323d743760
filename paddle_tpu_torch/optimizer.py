"""Optimizers (reference: paddle_tpu optimizer.py;
python/paddle/fluid/optimizer.py): Optimizer, SGD, Momentum and Adam.

minimize() appends, in the reference's order, the backward marker, the
gradient clips (clip.py: a parameter's ``gradient_clip_attr`` or the
program's ``set_gradient_clip``), the regularizers (regularizer.py: a
parameter's ``regularizer`` or the optimizer's ``regularization``) and
one update op per parameter; the Executor runs the ops after the marker
in place once the gradients exist. The learning rate is a float or a
Variable (a learning_rate_decay schedule), read as a device tensor.
Row-sparse updates (``lazy_mode``) are not ported and raise.
"""

from .clip import append_gradient_clip_ops
from .core import unique_name
from .core.backward import append_backward
from .core.program import (Variable, default_main_program,
                           default_startup_program, program_guard)
from .initializer import Constant
from .layers.helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = ['SGD', 'Momentum', 'Adam', 'SGDOptimizer', 'MomentumOptimizer',
           'AdamOptimizer', 'Optimizer']


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


class MomentumOptimizer(Optimizer):
    _velocity_acc_str = 'velocity'

    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 lazy_mode=False, **kwargs):
        """Dense momentum, one velocity accumulator a parameter set to 0 by
        the startup program. ``lazy_mode`` (the JAX package's row-sparse
        update) is not ported and raises."""
        if lazy_mode:
            raise NotImplementedError(
                'MomentumOptimizer(lazy_mode=True) needs row-sparse '
                'gradients, which paddle_tpu_torch does not port')
        super(MomentumOptimizer, self).__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        velocity = self._get_accumulator(self._velocity_acc_str, param)
        return block.append_op(
            type='momentum',
            inputs={'Param': [param], 'Grad': [grad],
                    'Velocity': [velocity],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param], 'VelocityOut': [velocity]},
            attrs={'mu': self._momentum,
                   'use_nesterov': self._use_nesterov})


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
Momentum = MomentumOptimizer
Adam = AdamOptimizer
