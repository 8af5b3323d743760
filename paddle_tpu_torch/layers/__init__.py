"""The layers the port's model code uses (a subset of paddle_tpu.layers, at
the same names, slots and attributes): data and parameters, the
Transformer training graph's fc, embedding, layer_norm, dropout, losses,
reductions, elementwise and reshaping layers, ResNet's conv2d, pool2d,
batch_norm, cross_entropy, accuracy, topk and transpose, and the NMT
inference graphs' fills, concat, argmax, comparisons, cumsum, expand,
stack, one_hot, log_softmax and beam search layers."""

from . import helper  # noqa: F401
from .io import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .manip import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .decode import *  # noqa: F401,F403

from . import control_flow, decode, io, manip, nn, ops, tensor  # noqa: F401
