"""Op lowerings. Importing this package registers every op the port runs:
the startup ops, the paged decode ops, the training paths' ops, the NMT
inference ops, the sequence, recurrent, CTC / CRF and metric ops, the
control-flow ops, the detection ops and the conv path's convolution,
normalization and vision ops."""

from . import activation_ops  # noqa: F401
from . import attention_ops  # noqa: F401
from . import control_ops  # noqa: F401
from . import conv_ops  # noqa: F401
from . import decode_ops  # noqa: F401
from . import detection_ops  # noqa: F401
from . import lr_ops  # noqa: F401
from . import math_ops  # noqa: F401
from . import metric_ops  # noqa: F401
from . import misc_ops  # noqa: F401
from . import moe_ops  # noqa: F401
from . import nn_ops  # noqa: F401
from . import norm_ops  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import paged_decode_ops  # noqa: F401
from . import random_ops  # noqa: F401
from . import rnn_ops  # noqa: F401
from . import sequence_ops  # noqa: F401
from . import tensor_ops  # noqa: F401
from . import transformer_ops  # noqa: F401
from . import vision_ops  # noqa: F401
