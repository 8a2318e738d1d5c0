"""Frozen configuration objects for the two big entry points.

:class:`SimConfig` consolidates :class:`~repro_torch.core.simulator.WorkflowSimulator`'s
dozen keyword knobs; :class:`ServingConfig` does the same for the
:class:`~repro_torch.serve.engine.ServingEngine` / ``Router`` constructor
keywords. Both entry points take ``config=`` as the documented path while
still accepting the legacy keywords, which are mapped through
``from_kwargs``.

The dataclasses are frozen so a config can be shared across engines, stored
on the object that consumed it, and compared/hashed in tests without
aliasing surprises.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from repro_torch.core.locstore import StorageHierarchy
from repro_torch.core.topology import ClusterTopology
from repro_torch.core.wfcompiler import H100_SXM, HardwareModel

__all__ = ["ServingConfig", "SimConfig"]


def _check_known(cls: type, kw: dict) -> None:
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(kw) - known)
    if unknown:
        raise TypeError(f"{cls.__name__}: unknown knob(s) {unknown}; "
                        f"known: {sorted(known)}")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Every :class:`WorkflowSimulator` knob in one frozen object.

    ``WorkflowSimulator(wf, sched, config=SimConfig(...))`` and
    ``simulate(wf, factory, config=...)`` are the documented spelling; the
    legacy flat keywords still work and are routed through
    :meth:`from_kwargs` (passing both is a ``TypeError``).
    """

    n_nodes: int = 64
    hw: HardwareModel = H100_SXM
    # Explicit link graph + per-node profiles (repro_torch.core.topology). When
    # set, the simulator charges transfers per traversed link and the
    # schedulers/store see topology-backed costs; a *flat* topology
    # (ClusterTopology.one_switch) is bit-identical to topology=None.
    topology: ClusterTopology | None = None
    # False: the *simulator* still charges real per-link costs but the
    # scheduler/store keep the flat scalar view — the topology-blind
    # ablation.
    topology_aware: bool = True
    # Predictive re-replication (health-monitor model): when True, each
    # scheduled failure is flagged ``predict_lead_s`` seconds ahead and the
    # suspect node's sole-copy data is re-replicated to a different rack
    # (any other node when flat) before the failure lands, under a
    # ``predict_rereplicate_bytes`` budget per warning.
    predict_failures: bool = False
    predict_lead_s: float = 3.0
    predict_rereplicate_bytes: float = float("inf")
    speeds: Mapping[int, float] | None = None
    failures: tuple[tuple[float, int], ...] = ()
    joins: tuple[tuple[float, int], ...] = ()
    join_rereplicate_bytes: float = float("inf")
    external_loc: str = "remote"            # "remote" | "scattered"
    proactive: bool | None = None
    hierarchy: StorageHierarchy | None = None
    write_policy: str = "through"
    coordinated_eviction: bool = False
    # False: never honor compiler write-mode pins; True: honor them all
    # (the legacy behaviour); "auto" (default): honor exactly the pins the
    # analyzer proves safe (repro_torch.analysis.lint.safe_write_modes), and only
    # in configurations where write-around can pay off (a finite node tier,
    # a locality-aware scheduler, stable membership).
    honor_write_modes: bool | str = "auto"
    durability: str = "none"
    barrier_every: int = 1
    indexed: bool = True
    # None: follow the REPRO_SANITIZE env var; True/False: force. When on,
    # every incremental structure is cross-checked against a from-scratch
    # rebuild every ``sanitize_every`` events (repro_torch.analysis.sanitize).
    sanitize: bool | None = None
    sanitize_every: int = 64

    @classmethod
    def from_kwargs(cls, **kw) -> "SimConfig":
        """Map the legacy keyword spelling onto a config (TypeError on an
        unknown knob — same failure mode the old signature had)."""
        _check_known(cls, kw)
        failures: Sequence[tuple[float, int]] | None = kw.get("failures")
        if failures is not None:
            kw["failures"] = tuple((float(t), int(n)) for t, n in failures)
        joins: Sequence[tuple[float, int]] | None = kw.get("joins")
        if joins is not None:
            kw["joins"] = tuple((float(t), int(n)) for t, n in joins)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Shared knobs of the serving stack: engine geometry plus the router's
    park/pricing policy. One object configures both ``ServingEngine`` (which
    reads the geometry fields) and ``Router`` (which reads the policy
    fields), so the two layers can never disagree about the workload shape.

    ``resume_bias`` scales the priced resume cost against the measured
    migrate-and-re-prefill cost: > 1 makes the router migrate earlier,
    < 1 makes it cling to locality harder.
    """

    max_batch: int = 4
    max_seq: int = 128
    eos_id: int = -1
    idle_tier: str = "bb"
    allow_park: bool = True
    resume_bias: float = 1.0
    # None: follow REPRO_SANITIZE; True/False: force slot/placeholder
    # invariant checks at every engine/router transition
    sanitize: bool | None = None

    @classmethod
    def from_kwargs(cls, **kw) -> "ServingConfig":
        _check_known(cls, kw)
        return cls(**kw)
