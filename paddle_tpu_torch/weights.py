"""Carry parameters across from the JAX package.

``from_numpy`` takes parameters as ``{name: np.ndarray}`` — what
paddle_tpu's ``DecodeEngine.export_weights()`` or ``random_weights``
return — and gives the port's tensors. ``load_into_scope`` puts such a
dict (for example every parameter of a JAX scope after its startup
program ran) into a port Scope, so that both packages train from the same
weights. Parameter names are the same in both packages.
"""

import numpy as np
import torch


def from_numpy(named_arrays, place):
    """{name: array} -> {name: float32 torch tensor on the place's
    device}."""
    device = place.device()
    return {name: torch.from_numpy(np.array(arr, dtype='float32')).to(device)
            for name, arr in named_arrays.items()}


def load_into_scope(named_arrays, scope, place):
    """Set each {name: array} in ``scope`` as a tensor on the place's
    device, keeping the array's dtype (a copy: later in-place updates of
    the scope leave the arrays alone)."""
    device = place.device()
    for name, arr in named_arrays.items():
        scope.set(name, torch.from_numpy(np.array(arr)).to(device))
