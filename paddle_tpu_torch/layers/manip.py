"""Tensor-manipulation layers the training and inference paths build
(reference: paddle_tpu layers/manip.py): slice, unsqueeze, expand, stack
and log_softmax."""

from .helper import LayerHelper

__all__ = ['slice', 'unsqueeze', 'expand', 'stack', 'log_softmax']


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
