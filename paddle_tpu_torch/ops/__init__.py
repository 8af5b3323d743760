"""Op lowerings. Importing this package registers every op the port runs:
the startup ops and the paged decode ops."""

from . import paged_decode_ops  # noqa: F401
from . import random_ops  # noqa: F401
from . import tensor_ops  # noqa: F401
