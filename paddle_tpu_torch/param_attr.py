"""ParamAttr (reference: python/paddle/fluid/param_attr.py)."""


class ParamAttr(object):
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None,
                 do_model_average=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average

    @staticmethod
    def to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr.to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, bool):
            return ParamAttr() if arg else False
        if isinstance(arg, (int, float)):
            return ParamAttr(learning_rate=float(arg))
        from .initializer import Initializer
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        raise TypeError('Cannot convert %r to ParamAttr' % (arg,))

    def set_default_initializer(self, initializer):
        if self.initializer is None:
            self.initializer = initializer

    def to_kwargs(self, with_initializer=False):
        kwargs = {
            'name': self.name,
            'optimize_attr': {'learning_rate': self.learning_rate},
            'regularizer': self.regularizer,
            'trainable': self.trainable,
            'gradient_clip_attr': self.gradient_clip,
            'do_model_average': self.do_model_average,
        }
        if with_initializer:
            kwargs['initializer'] = self.initializer
        return kwargs


class WeightNormParamAttr(ParamAttr):
    """Weight normalization (reference: param_attr.py
    WeightNormParamAttr): the layer's weight is w = g * v / ||v||, the norm
    over every axis but ``dim`` (None: every axis, one scalar g). The
    helper makes ``<name>.wn_v`` (the direction, under the layer's
    initializer) and ``<name>.wn_g`` (the magnitude, set to ||v|| at
    startup, so training starts at v) and one weight_norm op; the
    gradients reach v and g."""

    def __init__(self, dim=None, **kwargs):
        super(WeightNormParamAttr, self).__init__(**kwargs)
        self.dim = dim
