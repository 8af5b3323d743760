"""Reader framework (reference: paddle_tpu reader/;
python/paddle/v2/reader).

A reader is a nullary callable returning an iterator of examples; the
decorators compose readers, and ``checkpointable`` makes a stream's
position part of a checkpoint. ``staged_superbatch`` packs windows of
batches through the native staging ring (reader/staging.py) and
``prefetch_to_device`` moves the next batch to the card while the current
one trains. The native recordio reader is not ported (ROADMAP Queue 1
item 11).
"""

from .decorator import (batch, buffered, cache, chain, compose,  # noqa
                        firstn, map_readers, prefetch_to_device, retry,
                        shard, shuffle, xmap_readers)
from .staging import staged_superbatch  # noqa: F401
from .state import CheckpointableReader, checkpointable  # noqa: F401
from . import creator  # noqa: F401
