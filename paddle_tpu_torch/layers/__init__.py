"""The layers the port's model code uses (a subset of paddle_tpu.layers, at
the same names, slots and attributes): data and parameters, the
Transformer training graph's fc, embedding, layer_norm, dropout, losses,
reductions, elementwise and reshaping layers, and ResNet's conv2d,
pool2d, batch_norm, cross_entropy, accuracy, topk and transpose."""

from . import helper  # noqa: F401
from .io import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .manip import *  # noqa: F401,F403

from . import io, manip, nn, ops, tensor  # noqa: F401
