"""The public layers (145 of paddle_tpu.layers' 200 names, at the same
names, slots and attributes): data and parameters, fills, the
elementwise, activation, reduction, reshaping and indexing layers, the
losses and metrics, fc, embedding, conv2d, pool2d, the norms, dropout,
resizes, Print, and the NMT inference graphs' beam search layers. The
loop constructs, the sequence, RNN and detection layers and the conv
path's rest are not ported (ROADMAP Queue 1 items 5-7)."""

from . import helper  # noqa: F401
from .io import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .manip import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .decode import *  # noqa: F401,F403

from . import control_flow, decode, io, manip, nn, ops, tensor  # noqa: F401
