"""Op lowerings. Importing this package registers every op the port runs:
the startup ops, the paged decode ops, the training paths' ops and the
NMT inference ops."""

from . import activation_ops  # noqa: F401
from . import attention_ops  # noqa: F401
from . import conv_ops  # noqa: F401
from . import decode_ops  # noqa: F401
from . import lr_ops  # noqa: F401
from . import math_ops  # noqa: F401
from . import misc_ops  # noqa: F401
from . import nn_ops  # noqa: F401
from . import norm_ops  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import paged_decode_ops  # noqa: F401
from . import random_ops  # noqa: F401
from . import tensor_ops  # noqa: F401
from . import transformer_ops  # noqa: F401
