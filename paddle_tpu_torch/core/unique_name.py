"""Unique name generator (reference: python/paddle/fluid/unique_name.py)."""

import collections
import contextlib

_generator_counters = collections.defaultdict(int)


def generate(key):
    _generator_counters[key] += 1
    return '%s_%d' % (key, _generator_counters[key] - 1)


def reset():
    _generator_counters.clear()


@contextlib.contextmanager
def guard(new_counters=None):
    global _generator_counters
    old = _generator_counters
    _generator_counters = new_counters if new_counters is not None \
        else collections.defaultdict(int)
    try:
        yield
    finally:
        _generator_counters = old
