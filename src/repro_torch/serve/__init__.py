"""Serving — location-aware engines and routing on the port's model.

Engine/router machinery from :mod:`repro_torch.serve.engine` plus the shared
:class:`ServingConfig`. (Trace generation and the discrete-event driver come
with a later slice.)
"""

from repro_torch.core.config import ServingConfig
from repro_torch.serve.engine import (EngineJoinReport, FailoverReport,
                                      KVSlice, RouteDecision, Router,
                                      ServingEngine, Session,
                                      TorchComputeBackend)

__all__ = ["ServingConfig", "EngineJoinReport", "FailoverReport", "KVSlice",
           "RouteDecision", "Router", "ServingEngine", "Session",
           "TorchComputeBackend"]
