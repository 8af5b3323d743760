"""Optimizers (reference: paddle_tpu optimizer.py;
python/paddle/fluid/optimizer.py): SGD, Momentum, Adagrad, Adam, Adamax,
DecayedAdagrad, Adadelta, RMSProp, Ftrl and ProximalAdagrad, and the
GradientAccumulator wrapper.

minimize() appends, in the reference's order, the backward marker, the
gradient clips (clip.py: a parameter's ``gradient_clip_attr`` or the
program's ``set_gradient_clip``), the regularizers (regularizer.py: a
parameter's ``regularizer`` or the optimizer's ``regularization``) and
one update op per parameter; the Executor runs the ops after the marker
in place once the gradients exist. The learning rate is a float or a
Variable (a learning_rate_decay schedule), read as a device tensor.

Row-sparse embedding gradients: SGD and Adagrad take them (exact against
the dense update), and Momentum and Adam with ``lazy_mode=True`` (touched
rows only); an ``is_sparse`` table that is eligible (core/backward.py) then
gets [n_ids, dim] row gradients, unless the optimizer has a
``regularization``. Accumulator names are the reference's, so checkpoints
cross between the packages both ways.
"""

from .clip import append_gradient_clip_ops
from .core import unique_name
from .core.backward import append_backward
from .core.program import (Variable, default_main_program,
                           default_startup_program, program_guard)
from .initializer import Constant
from .layers.helper import LayerHelper
from .regularizer import append_regularization_ops


class Optimizer(object):
    # True on optimizers whose update op consumes row-sparse embedding
    # gradients (ops/optimizer_ops.py's sparse branches): SGD and Adagrad,
    # and Momentum and Adam with lazy_mode
    _supports_sparse_update = False

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

    def _minimize_prologue(self, loss, startup_program, parameter_list,
                           no_grad_set):
        """The front half of minimize: resolve the programs, append the
        backward, clip and regularization ops. Returns (main_program,
        startup_program, params_grads)."""
        main_program = loss.block.program
        if startup_program is None:
            startup_program = main_program._startup_ref or \
                default_startup_program()
        with program_guard(main_program, startup_program):
            # optimizer-level regularization applies to every parameter
            # and is written against the dense gradient: sparse goes off
            params_grads = append_backward(
                loss, parameter_list, no_grad_set,
                sparse_supported=(self._supports_sparse_update and
                                  self.regularization is None))
            params_grads = append_gradient_clip_ops(params_grads)
            params_grads = append_regularization_ops(params_grads,
                                                     self.regularization)
        return main_program, startup_program, params_grads

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """Append backward + update ops to the loss's program (and their
        initializers to its startup program). Returns (optimize_ops,
        params_grads)."""
        main_program, startup_program, params_grads = \
            self._minimize_prologue(loss, startup_program, parameter_list,
                                    no_grad_set)
        with program_guard(main_program, startup_program):
            optimize_ops = self._create_optimization_pass(
                params_grads, loss, startup_program)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    _supports_sparse_update = True

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
        """One velocity accumulator a parameter, set to 0 by the startup
        program. ``lazy_mode=True``: row-sparse embedding gradients update
        the parameter and velocity only on the rows touched this step
        (untouched rows skip the mu-decay dense momentum applies), as the
        reference's lazy mode does."""
        super(MomentumOptimizer, self).__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = use_nesterov
        if lazy_mode:
            self._supports_sparse_update = True

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


def _beta_pow_var(name, beta):
    """A persistable [1] float32 beta-power accumulator starting at beta."""
    var = default_main_program().global_block().create_var(
        name=unique_name.generate(name), shape=(1,),
        dtype='float32', persistable=True)
    var.stop_gradient = True
    Constant(beta)(var)
    return var


class AdamOptimizer(Optimizer):
    _moment1_acc_str = 'moment1'
    _moment2_acc_str = 'moment2'

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        """``lazy_mode=True``: row-sparse embedding gradients take the
        lazy-Adam path, moments decaying and the parameter moving only on
        the rows touched this step (the reference's lazy mode; dense Adam
        decays every row every step)."""
        super(AdamOptimizer, self).__init__(learning_rate, **kwargs)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._beta1_pow = None
        self._beta2_pow = None
        if lazy_mode:
            self._supports_sparse_update = True

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment1_acc_str, p)
            self._add_accumulator(self._moment2_acc_str, p)
        self._beta1_pow = _beta_pow_var('beta1_pow_acc', self._beta1)
        self._beta2_pow = _beta_pow_var('beta2_pow_acc', self._beta2)

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


class AdagradOptimizer(Optimizer):
    """m += g²; p -= lr·g / (sqrt(m) + eps). Takes row-sparse gradients
    exactly (duplicate ids merged first)."""
    _supports_sparse_update = True
    _moment_acc_str = 'moment'

    def __init__(self, learning_rate, epsilon=1e-6, **kwargs):
        super(AdagradOptimizer, self).__init__(learning_rate, **kwargs)
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator(self._moment_acc_str, param)
        return block.append_op(
            type='adagrad',
            inputs={'Param': [param], 'Grad': [grad], 'Moment': [moment],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param], 'MomentOut': [moment]},
            attrs={'epsilon': self._epsilon})


class AdamaxOptimizer(Optimizer):
    _moment_acc_str = 'moment'
    _inf_norm_acc_str = 'inf_norm'

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super(AdamaxOptimizer, self).__init__(learning_rate, **kwargs)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._beta1_pow = None

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)
            self._add_accumulator(self._inf_norm_acc_str, p)
        self._beta1_pow = _beta_pow_var('beta1_pow_acc', self._beta1)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator(self._moment_acc_str, param)
        inf_norm = self._get_accumulator(self._inf_norm_acc_str, param)
        return block.append_op(
            type='adamax',
            inputs={'Param': [param], 'Grad': [grad], 'Moment': [moment],
                    'InfNorm': [inf_norm],
                    'Beta1Pow': [self._beta1_pow],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param], 'MomentOut': [moment],
                     'InfNormOut': [inf_norm]},
            attrs={'beta1': self._beta1, 'beta2': self._beta2,
                   'epsilon': self._epsilon})

    def _finish_update(self, block):
        block.append_op(type='beta_pow_update',
                        inputs={'BetaPow': [self._beta1_pow]},
                        outputs={'BetaPowOut': [self._beta1_pow]},
                        attrs={'beta': self._beta1})


class DecayedAdagradOptimizer(Optimizer):
    _moment_acc_str = 'moment'

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super(DecayedAdagradOptimizer, self).__init__(learning_rate,
                                                      **kwargs)
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator(self._moment_acc_str, param)
        return block.append_op(
            type='decayed_adagrad',
            inputs={'Param': [param], 'Grad': [grad], 'Moment': [moment],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param], 'MomentOut': [moment]},
            attrs={'decay': self._decay, 'epsilon': self._epsilon})


class AdadeltaOptimizer(Optimizer):
    _avg_squared_grad_acc_str = '_avg_squared_grad'
    _avg_squared_update_acc_str = '_avg_squared_update'

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super(AdadeltaOptimizer, self).__init__(learning_rate, **kwargs)
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._avg_squared_grad_acc_str, p)
            self._add_accumulator(self._avg_squared_update_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        asg = self._get_accumulator(self._avg_squared_grad_acc_str, param)
        asu = self._get_accumulator(self._avg_squared_update_acc_str, param)
        return block.append_op(
            type='adadelta',
            inputs={'Param': [param], 'Grad': [grad],
                    'AvgSquaredGrad': [asg], 'AvgSquaredUpdate': [asu]},
            outputs={'ParamOut': [param], 'AvgSquaredGradOut': [asg],
                     'AvgSquaredUpdateOut': [asu]},
            attrs={'epsilon': self._epsilon, 'rho': self._rho})


class RMSPropOptimizer(Optimizer):
    _momentum_acc_str = 'momentum'
    _mean_square_acc_str = 'mean_square'

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 **kwargs):
        super(RMSPropOptimizer, self).__init__(learning_rate, **kwargs)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._momentum_acc_str, p)
            self._add_accumulator(self._mean_square_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        momentum = self._get_accumulator(self._momentum_acc_str, param)
        mean_square = self._get_accumulator(self._mean_square_acc_str, param)
        return block.append_op(
            type='rmsprop',
            inputs={'Param': [param], 'Grad': [grad],
                    'Moment': [momentum], 'MeanSquare': [mean_square],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param], 'MomentOut': [momentum],
                     'MeanSquareOut': [mean_square]},
            attrs={'epsilon': self._epsilon, 'decay': self._rho,
                   'momentum': self._momentum})


class FtrlOptimizer(Optimizer):
    _squared_acc_str = 'squared'
    _linear_acc_str = 'linear'

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super(FtrlOptimizer, self).__init__(learning_rate, **kwargs)
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._squared_acc_str, p)
            self._add_accumulator(self._linear_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        sq = self._get_accumulator(self._squared_acc_str, param)
        lin = self._get_accumulator(self._linear_acc_str, param)
        return block.append_op(
            type='ftrl',
            inputs={'Param': [param], 'Grad': [grad],
                    'SquaredAccumulator': [sq], 'LinearAccumulator': [lin],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param], 'SquaredAccumOut': [sq],
                     'LinearAccumOut': [lin]},
            attrs={'l1': self._l1, 'l2': self._l2,
                   'lr_power': self._lr_power})


class ProximalAdagradOptimizer(Optimizer):
    """Adagrad with the proximal l1/l2 operator
    (proximal_adagrad_op.{cc,h})."""
    _moment_acc_str = 'moment'

    def __init__(self, learning_rate, l1=0.0, l2=0.0, **kwargs):
        super(ProximalAdagradOptimizer, self).__init__(learning_rate,
                                                       **kwargs)
        self._l1 = l1
        self._l2 = l2

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator(self._moment_acc_str, param)
        return block.append_op(
            type='proximal_adagrad',
            inputs={'Param': [param], 'Grad': [grad], 'Moment': [moment],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param], 'MomentOut': [moment]},
            attrs={'l1': self._l1, 'l2': self._l2})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
ProximalAdagrad = ProximalAdagradOptimizer


class GradientAccumulator(object):
    """Gradient accumulation (reference: paddle_tpu optimizer.py
    GradientAccumulator): wraps any optimizer so that its update applies
    every ``accum_steps`` executor steps, with the mean of the gradients
    accumulated over them: the effective batch is accum_steps x the
    micro-batch without the memory of the large batch.

    No host branch: every step runs the same ops (one CUDA graph on the
    card, and ``run_steps`` chains it). For each (param, grad), acc +=
    grad and the inner update reads acc / accum_steps; every persistable
    var the inner update writes (parameters, moments, beta pows) is copied
    before the update ops (``assign``, a copy: the update works in place)
    and blended back as ``snap + (new - snap) * flag``, flag = [phase ==
    accum_steps - 1]; the accumulators and the phase reset on the apply
    step. Row-sparse gradients cannot accumulate (each step's rows index
    other ids), so the wrapped region takes dense gradients.

    As in the reference: a clip or regularizer of the inner optimizer
    applies to each micro gradient; a learning-rate schedule's counter
    advances every micro step, while a ``global_step`` counter written
    inside the inner update counts applied updates."""

    def __init__(self, optimizer, accum_steps):
        if int(accum_steps) != accum_steps or accum_steps < 1:
            raise ValueError('accum_steps must be a positive integer, '
                             'got %r' % (accum_steps,))
        self._inner = optimizer
        self._k = int(accum_steps)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from . import layers as _layers
        inner = self._inner
        k = self._k
        if k == 1:
            return inner.minimize(loss, startup_program, parameter_list,
                                  no_grad_set)
        # the dense path for the gated region: an instance-level value
        # (lazy_mode sets one) is saved and restored, not popped
        had = '_supports_sparse_update' in inner.__dict__
        saved = inner.__dict__.get('_supports_sparse_update')
        inner.__dict__['_supports_sparse_update'] = False
        try:
            main_program, startup_program, params_grads = \
                inner._minimize_prologue(loss, startup_program,
                                         parameter_list, no_grad_set)
        finally:
            if had:
                inner.__dict__['_supports_sparse_update'] = saved
            else:
                inner.__dict__.pop('_supports_sparse_update', None)
        block = main_program.global_block()
        with program_guard(main_program, startup_program):
            helper = LayerHelper('grad_accum')
            phase = block.create_var(name=unique_name.generate(
                'grad_accum_phase'), shape=(1,), dtype='float32',
                persistable=True)
            phase.stop_gradient = True
            Constant(0.0)(phase)
            boundary = _layers.fill_constant(shape=[1], dtype='float32',
                                             value=float(k - 1))
            flag = _layers.cast(_layers.equal(x=phase, y=boundary),
                                'float32')            # 1.0 on apply steps
            keep = _layers.scale(flag, scale=-1.0, bias=1.0)

            # acc += grad; the inner update reads the mean gradient
            accs = []
            for p, g in params_grads:
                acc = block.create_var(
                    name=unique_name.generate(p.name + '_grad_acc'),
                    shape=p.shape, dtype=p.dtype, persistable=True)
                acc.stop_gradient = True
                Constant(0.0)(acc)
                helper.append_op(type='elementwise_add',
                                 inputs={'X': [acc], 'Y': [g]},
                                 outputs={'Out': [acc]})
                helper.append_op(type='scale', inputs={'X': [acc]},
                                 outputs={'Out': [g]},
                                 attrs={'scale': 1.0 / k})
                accs.append(acc)

            mark = len(block.ops)
            optimize_ops = inner._create_optimization_pass(
                params_grads, loss, startup_program)

            # every persistable var the inner update wrote: a copy before
            # the update ops, the blend after them
            written, seen = [], set()
            for op in block.ops[mark:]:
                for n in op.output_names():
                    v = block._find_var_recursive(n)
                    if v is not None and v.persistable and n not in seen:
                        seen.add(n)
                        written.append(v)
            insert_at = mark
            snaps = {}
            for v in written:
                snap = helper.create_variable_for_type_inference(v.dtype)
                snap.shape = v.shape
                helper.append_op(type='assign', inputs={'X': [v]},
                                 outputs={'Out': [snap]})
                block.ops.insert(insert_at, block.ops.pop())
                insert_at += 1
                snaps[v.name] = snap
            for v in written:
                snap = snaps[v.name]
                delta = _layers.elementwise_sub(x=v, y=snap)
                gated = _layers.elementwise_mul(x=delta, y=flag)
                helper.append_op(type='elementwise_add',
                                 inputs={'X': [snap], 'Y': [gated]},
                                 outputs={'Out': [v]})
            for acc in accs:  # reset on apply steps
                helper.append_op(type='elementwise_mul',
                                 inputs={'X': [acc], 'Y': [keep]},
                                 outputs={'Out': [acc]})
            bumped = _layers.scale(phase, scale=1.0, bias=1.0)
            gated_phase = _layers.elementwise_mul(x=bumped, y=keep)
            helper.append_op(type='assign',
                             inputs={'X': [gated_phase]},
                             outputs={'Out': [phase]})
        return optimize_ops, params_grads
