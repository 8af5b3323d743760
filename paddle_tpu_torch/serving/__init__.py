"""Serving: the continuous-batching decode engine (``serving.decode``), the
priority classes it schedules by (``serving.tenancy``), and the
disaggregated fleet: prefill replicas feeding decode replicas through the
KV page handoff (``serving.handoff``), placed by ``PhaseRouter``
(``serving.router``) and driven by ``serving.loadgen``. The bucket
``ServingEngine``, the single-phase ``Router``, ``FleetController`` and
the RPC transport belong to a later slice."""

from .engine import EngineClosedError, QueueFullError
from .handoff import (HandoffError, KVDtypeMismatchError, KVGeometryError,
                      KVPacket)
from .router import NoReplicaAvailableError, PhaseRouter, SLOShedError

__all__ = ['EngineClosedError', 'QueueFullError', 'HandoffError',
           'KVDtypeMismatchError', 'KVGeometryError', 'KVPacket',
           'NoReplicaAvailableError', 'PhaseRouter', 'SLOShedError']
