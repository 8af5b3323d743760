"""Datasets (reference: paddle_tpu dataset/): the synthetic CTR data of the
Criteo schema (``ctr``), drawn from a seeded generator, nothing
downloaded."""

from . import common, ctr  # noqa: F401
