"""Core — the paper's cross-layer contribution as a composable library.

Layers (paper §B):
  * storage:   :mod:`repro_torch.core.locstore` — location-aware store + location service
  * compiler:  :mod:`repro_torch.core.hints` + :mod:`repro_torch.core.wfcompiler`
  * runtime:   :mod:`repro_torch.core.scheduler` + :mod:`repro_torch.core.prefetch`
               + :mod:`repro_torch.core.executor` (real) / :mod:`repro_torch.core.simulator`
"""

from repro_torch.core.config import ServingConfig, SimConfig
from repro_torch.core.dag import DataSpec, TaskGraph, TaskSpec
from repro_torch.core.executor import WorkflowExecutor
from repro_torch.core.hints import Complexity, TaskHints, size_hint, task
from repro_torch.core.locstore import (DropReport, FLAT_HIERARCHY, JoinReport,
                                       LocationService, LocStore,
                                       Placement, REMOTE_TIER, SimObject,
                                       StorageHierarchy, TierHop, TierSpec,
                                       Transfer, WriteBackEntry,
                                       WriteBackQueue, tiered_hierarchy)
from repro_torch.core.prefetch import PrefetchEngine
from repro_torch.core.scheduler import (Assignment, FCFSScheduler,
                                        LocalityScheduler, PrefetchRequest,
                                        ProactiveScheduler)
from repro_torch.core.simulator import SimResult, WorkflowSimulator, simulate
from repro_torch.core.topology import ClusterTopology, NodeProfile
from repro_torch.core.wfcompiler import (CompiledWorkflow, H100_SXM,
                                         HardwareModel, HPC_CLUSTER, TPU_V5E,
                                         compile_workflow)

__all__ = [
    "DataSpec", "TaskGraph", "TaskSpec",
    "Complexity", "TaskHints", "size_hint", "task",
    "LocationService", "LocStore", "Placement", "REMOTE_TIER", "SimObject",
    "Transfer", "TierHop", "TierSpec", "StorageHierarchy", "FLAT_HIERARCHY",
    "tiered_hierarchy", "WriteBackEntry", "WriteBackQueue",
    "DropReport", "JoinReport",
    "CompiledWorkflow", "HardwareModel", "H100_SXM", "HPC_CLUSTER", "TPU_V5E",
    "compile_workflow", "ClusterTopology", "NodeProfile",
    "Assignment", "FCFSScheduler", "LocalityScheduler", "PrefetchRequest",
    "ProactiveScheduler",
    "PrefetchEngine", "WorkflowExecutor",
    "ServingConfig", "SimConfig", "SimResult", "WorkflowSimulator", "simulate",
]
