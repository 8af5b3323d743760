"""Serving errors shared by the engines (reference: paddle_tpu
serving/engine.py). The bucket ServingEngine belongs to a later slice."""


class QueueFullError(RuntimeError):
    """submit() found max_queue_depth requests already waiting — the
    engine is saturated; shed load or retry with backoff."""


class EngineClosedError(RuntimeError):
    """submit() after shutdown(), or a queued request abandoned by a
    non-draining shutdown."""
