"""Continuous-batching decode serving over a paged KV cache."""

from .engine import DecodeEngine
from .kv_pool import BlockTable, KVPool
from .model import LMSpec, build_lm_programs, random_weights
from .scheduler import GenerationStream, Scheduler, Sequence

__all__ = ['DecodeEngine', 'BlockTable', 'KVPool', 'LMSpec',
           'build_lm_programs', 'random_weights', 'GenerationStream',
           'Scheduler', 'Sequence']
