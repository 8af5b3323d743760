"""Carry parameters across from the JAX package.

``from_numpy`` takes parameters as ``{name: np.ndarray}`` — what
paddle_tpu's ``DecodeEngine.export_weights()`` or ``random_weights``
return — and gives the port's tensors. Parameter names are the same in
both packages.
"""

import numpy as np
import torch


def from_numpy(named_arrays, place):
    """{name: array} -> {name: float32 torch tensor on the place's
    device}."""
    device = place.device()
    return {name: torch.from_numpy(np.array(arr, dtype='float32')).to(device)
            for name, arr in named_arrays.items()}
