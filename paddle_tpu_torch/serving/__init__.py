"""Serving: the continuous-batching decode engine (``serving.decode``) and
the priority classes it schedules by (``serving.tenancy``)."""

from .engine import EngineClosedError, QueueFullError

__all__ = ['EngineClosedError', 'QueueFullError']
