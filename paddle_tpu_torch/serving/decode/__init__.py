"""Continuous-batching decode serving over a paged KV cache, with a
global prefix cache, speculative decoding and quantized KV arenas."""

from .engine import DecodeEngine
from .kv_pool import BlockTable, KVPool
from .model import (LMSpec, build_lm_programs, kv_page_bytes,
                    random_weights)
from .prefix_cache import PrefixCache
from .scheduler import GenerationStream, Scheduler, Sequence
from .spec import NgramDraft, accept_drafts

__all__ = ['DecodeEngine', 'BlockTable', 'KVPool', 'LMSpec',
           'build_lm_programs', 'kv_page_bytes', 'random_weights',
           'PrefixCache', 'GenerationStream', 'Scheduler', 'Sequence',
           'NgramDraft', 'accept_drafts']
