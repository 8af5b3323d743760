"""The public layers (all 200 of paddle_tpu.layers' names, at the same
names, slots and attributes): data and parameters, fills, the
elementwise, activation, reduction, reshaping and indexing layers, the
losses and metrics, fc, embedding, the convolutions (conv2d, conv3d,
conv2d_transpose, row_conv, conv_shift), the poolings (pool2d, spp,
roi_pool, max_pool2d_with_index, unpool), lrn, crop, the norms, dropout,
resizes, Print, switch_moe, the sequence and recurrent layers, CTC and
the linear-chain CRF, the NMT inference graphs' beam search layers, the
control flow (While, StaticRNN, DynamicRNN, IfElse, Switch, the tensor
arrays) and the detection layers."""

from . import helper  # noqa: F401
from .io import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .manip import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .decode import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403

from . import control_flow, decode, detection, io, manip, nn, ops, rnn, \
    sequence, tensor  # noqa: F401
