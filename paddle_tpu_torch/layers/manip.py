"""Tensor-manipulation layers (reference: paddle_tpu layers/manip.py):
slice, unsqueeze, expand, stack, log_softmax, prelu, gather, scatter,
squeeze, where, shape, range, isfinite and pixel_shuffle."""

from ..initializer import Constant
from .helper import LayerHelper

__all__ = ['slice', 'unsqueeze', 'expand', 'stack', 'log_softmax', 'prelu',
           'gather', 'scatter', 'squeeze', 'where', 'shape', 'range',
           'isfinite', 'pixel_shuffle']


def slice(input, axes, starts, ends, name=None):
    helper = LayerHelper('slice', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape is not None:
        s = list(input.shape)
        for ax, st, en in zip(axes, starts, ends):
            dim = s[ax]
            if dim is not None and dim >= 0:
                lo = st if st >= 0 else max(dim + st, 0)
                hi = min(en if en >= 0 else dim + en, dim)
                s[ax] = max(hi - lo, 0)
        out.shape = tuple(s)
    helper.append_op(type='slice', inputs={'Input': [input]},
                     outputs={'Out': [out]},
                     attrs={'axes': list(axes), 'starts': list(starts),
                            'ends': list(ends)})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper('unsqueeze', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape is not None:
        s = list(input.shape)
        for ax in sorted(a % (len(s) + 1) for a in axes):
            s.insert(ax, 1)
        out.shape = tuple(s)
    helper.append_op(type='unsqueeze', inputs={'X': [input]},
                     outputs={'Out': [out]}, attrs={'axes': list(axes)})
    return out


def expand(x, expand_times, name=None):
    helper = LayerHelper('expand', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None:
        out.shape = tuple(d * t if d and d > 0 else d
                          for d, t in zip(x.shape, expand_times))
    helper.append_op(type='expand', inputs={'X': [x]},
                     outputs={'Out': [out]},
                     attrs={'expand_times': list(expand_times)})
    return out


def stack(x, axis=0, name=None):
    helper = LayerHelper('stack', name=name)
    xs = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(xs[0].dtype)
    if xs[0].shape is not None:
        s = list(xs[0].shape)
        s.insert(axis % (len(s) + 1), len(xs))
        out.shape = tuple(s)
    helper.append_op(type='stack', inputs={'X': list(xs)},
                     outputs={'Out': [out]}, attrs={'axis': axis})
    return out


def log_softmax(x, axis=-1, name=None):
    helper = LayerHelper('log_softmax', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type='log_softmax', inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'axis': axis})
    return out


def prelu(x, mode='all', param_attr=None, name=None):
    """where(x > 0, x, alpha * x) with a learnt alpha (0.25 at first): one
    value ('all'), one a channel of an NC... layout ('channel') or one an
    element of a row ('element')."""
    helper = LayerHelper('prelu', **locals())
    if mode == 'all':
        alpha_shape = [1]
    elif mode == 'channel':
        alpha_shape = [x.shape[1]]
    else:
        alpha_shape = list(x.shape[1:])
    alpha = helper.create_parameter(attr=helper.param_attr,
                                    shape=alpha_shape, dtype=x.dtype,
                                    default_initializer=Constant(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type='prelu', inputs={'X': [x], 'Alpha': [alpha]},
                     outputs={'Out': [out]}, attrs={'mode': mode})
    return out


def gather(input, index, name=None):
    helper = LayerHelper('gather', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape is not None and index.shape is not None:
        out.shape = (index.shape[0],) + tuple(input.shape[1:])
    helper.append_op(type='gather', inputs={'X': [input], 'Index': [index]},
                     outputs={'Out': [out]})
    return out


def scatter(input, index, updates, name=None):
    helper = LayerHelper('scatter', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(type='scatter',
                     inputs={'X': [input], 'Ids': [index],
                             'Updates': [updates]},
                     outputs={'Out': [out]})
    return out


def squeeze(input, axes, name=None):
    helper = LayerHelper('squeeze', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape is not None:
        if axes:
            drop = set(a % len(input.shape) for a in axes)
            s = [d for i, d in enumerate(input.shape) if i not in drop]
        else:
            # empty axes squeezes every unit dim (matches the lowering)
            s = [d for d in input.shape if d != 1]
        out.shape = tuple(s)
    helper.append_op(type='squeeze', inputs={'X': [input]},
                     outputs={'Out': [out]}, attrs={'axes': list(axes)})
    return out


def where(condition, x, y, name=None):
    helper = LayerHelper('where', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type='where',
                     inputs={'Condition': [condition], 'X': [x], 'Y': [y]},
                     outputs={'Out': [out]})
    return out


def shape(input, name=None):
    helper = LayerHelper('shape', name=name)
    out = helper.create_variable_for_type_inference('int32')
    if input.shape is not None:
        out.shape = (len(input.shape),)
    helper.append_op(type='shape', inputs={'X': [input]},
                     outputs={'Out': [out]})
    return out


def range(start, end, step, dtype='int64', name=None):
    helper = LayerHelper('range', name=name)
    out = helper.create_variable_for_type_inference(dtype)
    if all(isinstance(v, (int, float)) for v in (start, end, step)):
        import math
        out.shape = (max(int(math.ceil((end - start) / step)), 0),)
    helper.append_op(type='range', inputs={},
                     outputs={'Out': [out]},
                     attrs={'start': start, 'end': end, 'step': step})
    return out


def isfinite(x, name=None):
    helper = LayerHelper('isfinite', name=name)
    out = helper.create_variable_for_type_inference('bool')
    out.shape = (1,)
    helper.append_op(type='isfinite', inputs={'X': [x]},
                     outputs={'Out': [out]})
    return out


def pixel_shuffle(x, upscale_factor, name=None):
    helper = LayerHelper('pixel_shuffle', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None:
        n, c, h, w = x.shape
        r = upscale_factor
        out.shape = (n, c // (r * r), h * r, w * r)
    helper.append_op(type='pixel_shuffle', inputs={'X': [x]},
                     outputs={'Out': [out]},
                     attrs={'upscale_factor': upscale_factor})
    return out
