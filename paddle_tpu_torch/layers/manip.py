"""Tensor-manipulation layers the training path builds (reference:
paddle_tpu layers/manip.py): slice and unsqueeze."""

from .helper import LayerHelper

__all__ = ['slice', 'unsqueeze']


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
