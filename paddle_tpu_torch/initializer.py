"""Parameter initializers (reference: python/paddle/fluid/initializer.py).

Each initializer appends ONE op to the startup program that produces the
parameter value; the Executor runs the startup program once, on the
place's device.
"""

import contextlib
import math

import numpy as np

from .core.program import default_startup_program


class Initializer(object):
    def __call__(self, var, block=None):
        raise NotImplementedError

    @staticmethod
    def _startup_block(block):
        return block if block is not None else \
            default_startup_program().global_block()

    @staticmethod
    def _fan_in_out(var):
        shape = var.shape
        if len(shape) < 2:
            return (shape[0] if shape else 1,) * 2
        if len(shape) == 2:
            return shape[0], shape[1]
        receptive = 1
        for s in shape[2:]:
            receptive *= s
        # conv OIHW: fan_in = I*r, fan_out = O*r
        return shape[1] * receptive, shape[0] * receptive

    def _append(self, var, block, op_type, attrs):
        b = self._startup_block(block)
        b.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                     persistable=True)
        b.append_op(type=op_type, outputs={'Out': [var.name]}, attrs=attrs)


class ConstantInitializer(Initializer):
    """Fills the var with ``value``; ``force_cpu`` is accepted and ignored,
    as in the reference."""

    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def __call__(self, var, block=None):
        self._append(var, block, 'fill_constant',
                     {'shape': list(var.shape), 'value': self.value})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block=None):
        self._append(var, block, 'uniform_random',
                     {'shape': list(var.shape), 'min': self.low,
                      'max': self.high, 'seed': self.seed})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block=None):
        self._append(var, block, 'gaussian_random',
                     {'shape': list(var.shape), 'mean': self.loc,
                      'std': self.scale, 'seed': self.seed})


class TruncatedNormalInitializer(Initializer):
    """A normal truncated to [loc - 2 scale, loc + 2 scale]; ``seed`` is
    accepted and, as in the reference, not read."""

    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block=None):
        self._append(var, block, 'truncated_gaussian_random',
                     {'shape': list(var.shape), 'mean': self.loc,
                      'std': self.scale, 'seed': self.seed})


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in, self.fan_out, self.seed = fan_in, fan_out, seed

    def __call__(self, var, block=None):
        fan_in, fan_out = self._fan_in_out(var)
        fan_in = self.fan_in if self.fan_in is not None else fan_in
        fan_out = self.fan_out if self.fan_out is not None else fan_out
        if self.uniform:
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fan_in + fan_out))
            NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    """He initialization: uniform in +-sqrt(6 / fan_in), or a normal of std
    sqrt(2 / fan_in)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block=None):
        fan_in, _ = self._fan_in_out(var)
        fan_in = self.fan_in if self.fan_in is not None else fan_in
        if self.uniform:
            limit = math.sqrt(6.0 / fan_in)
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / fan_in)
            NormalInitializer(0.0, std, self.seed)(var, block)


class BilinearInitializer(Initializer):
    """The bilinear upsampling filter for a conv_transpose weight [c_out,
    c_in, h, w], on the diagonal channels, as an assign_value op."""

    def __call__(self, var, block=None):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError('Bilinear initializer needs a 4-D weight')
        c_out, c_in, h, w = shape
        f = np.ceil(w / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        weight = np.zeros(shape, dtype='float32')
        og = np.ogrid[:h, :w]
        filt = (1 - abs(og[0] / f - c)) * (1 - abs(og[1] / f - c))
        diag = range(min(c_out, c_in))
        weight[diag, diag, :, :] = filt
        self._append(var, block, 'assign_value',
                     {'values': weight.tolist(), 'shape': list(shape)})


class NumpyArrayInitializer(Initializer):
    """The array rides the op's ``values`` attr as a numpy array (the
    reference converts it to a nested list)."""

    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block=None):
        self._append(var, block, 'assign_value',
                     {'values': self.value,
                      'shape': list(self.value.shape)})


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer


def force_init_on_cpu():
    """False: the startup program runs on the executor's place."""
    return False


@contextlib.contextmanager
def init_on_cpu():
    """Accepted for the reference's scripts; the initializers run where
    the startup program runs."""
    yield
