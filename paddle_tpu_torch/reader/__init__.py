"""Reader framework (reference: paddle_tpu reader/;
python/paddle/v2/reader).

A reader is a nullary callable returning an iterator of examples; the
decorators compose readers, and ``checkpointable`` makes a stream's
position part of a checkpoint. The native recordio reader, the staging
ring and ``prefetch_to_device`` are not ported (ROADMAP Queue 1 items 2
and 11).
"""

from .decorator import (batch, buffered, cache, chain, compose,  # noqa
                        firstn, map_readers, prefetch_to_device, retry,
                        shard, shuffle, xmap_readers)
from .state import CheckpointableReader, checkpointable  # noqa: F401
from . import creator  # noqa: F401
