"""Serving: the continuous-batching decode engine (``serving.decode``)."""

from .engine import EngineClosedError, QueueFullError

__all__ = ['EngineClosedError', 'QueueFullError']
