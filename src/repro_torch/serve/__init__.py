"""Serving — location-aware engines, routing, and trace-driven evaluation.

Engine/router machinery from :mod:`repro_torch.serve.engine`, traffic
generation and the discrete-event driver from :mod:`repro_torch.serve.traffic`,
plus the shared :class:`ServingConfig`.
"""

from repro_torch.core.config import ServingConfig
from repro_torch.serve.engine import (EngineJoinReport, FailoverReport,
                                      KVSlice, RouteDecision, Router,
                                      ServingEngine, Session,
                                      TorchComputeBackend)
from repro_torch.serve.traffic import (CostModel, InterArrivalPredictor,
                                       Request, SyntheticBackend, TraceConfig,
                                       TraceDriver, TraceReport,
                                       build_trace_stack, generate_trace,
                                       latency_percentiles, trace_stats)

__all__ = ["ServingConfig", "EngineJoinReport", "FailoverReport", "KVSlice",
           "RouteDecision", "Router", "ServingEngine", "Session",
           "TorchComputeBackend",
           "CostModel", "InterArrivalPredictor", "Request", "SyntheticBackend",
           "TraceConfig", "TraceDriver", "TraceReport", "build_trace_stack",
           "generate_trace", "latency_percentiles", "trace_stats"]
