"""Cluster topology — heterogeneous nodes and an explicit per-link network.

The paper's cross-layer argument needs the hardware layer to expose *where*
data sits relative to compute. A flat :class:`~repro_torch.core.wfcompiler.
HardwareModel` collapses that to a boolean (same pod / different pod); this
module replaces it with an explicit node -> ToR -> spine link graph plus
per-node profiles (mixed-generation compute speeds, per-node NIC bandwidth,
spot-class markers), mirroring the Helix cluster simulator's mixed-machine
model:

* every transfer has a *path* (source NIC, the racks' ToR uplinks when it
  crosses the spine, the PFS attachment for remote-tier traffic);
* ``link_gbps`` is the **max-utilized link on the path** — the minimum
  capacity along it, with each ToR uplink contributing its fair-share
  per-flow bandwidth (``nic / oversubscription``: what a flow can count on
  when the rack's offered load saturates the uplink);
* the simulator turns each link into a transfer *lane*, so concurrent
  transfers through a shared uplink genuinely contend (per-NIC lanes are the
  degenerate single-link case).

**Flat-equivalence guarantee.** ``ClusterTopology.one_switch(n)`` is the
degenerate topology: every node on one ToR, infinite-capacity links, and
``flat=True``. A flat topology contributes *structure only* — the
HardwareModel keeps its scalar ICI/DCN/remote link model and the simulator
keeps its per-NIC lanes, so a flat-topology run is bit-identical to a
scalar-HardwareModel run (pinned by tests/test_sched_equivalence.py).

This module is imported by ``wfcompiler`` (the HardwareModel carries an
optional topology) and must not import any other core module.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

__all__ = ["NodeProfile", "ClusterTopology"]

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class NodeProfile:
    """Per-node hardware profile (mixed-generation / spot-class clusters).

    ``speed`` is the node's relative compute throughput (1.0 = nominal —
    feeds ``ClusterView.worker_speed`` and the speed-aware schedulers).
    ``nic_gbps`` overrides the topology's default NIC capacity for this node
    (an older generation's slower network). ``cls`` tags the node's class:
    ``"spot"`` nodes are preemption-prone — the predictive re-replication
    trigger treats their sole-copy data as at-risk.
    """

    speed: float = 1.0
    cls: str = "standard"            # "standard" | "spot" | generation tag
    nic_gbps: float | None = None


@dataclasses.dataclass(frozen=True)
class ClusterTopology:
    """Node -> ToR -> spine link graph with per-node profiles.

    ``rack_of[node]`` assigns each node to a ToR switch; each rack has one
    uplink to the spine, and the PFS hangs off the spine behind its own
    link. ``up_gbps[r]`` is the *effective per-flow* bandwidth through rack
    ``r``'s uplink (``nic / oversubscription`` for :meth:`two_tier`);
    ``up_capacity_gbps[r]`` is the uplink's nominal capacity (what the
    ``oversubscribed-link`` lint rule budgets against).

    Nodes that join beyond the configured size (elastic growth) fall back to
    round-robin rack assignment and the default NIC/profile, so a frozen
    topology keeps answering for a growing cluster.
    """

    n_nodes: int
    rack_of: tuple[int, ...]
    nic_gbps: tuple[float, ...]
    up_gbps: tuple[float, ...]              # per-flow share through each uplink
    up_capacity_gbps: tuple[float, ...]     # nominal uplink capacity
    oversub: tuple[float, ...]              # nominal oversubscription per rack
    pfs_gbps: float = 0.5e9
    default_nic_gbps: float = 1.25e9
    profiles: tuple[NodeProfile, ...] = ()
    flat: bool = False

    def __post_init__(self) -> None:
        if self.n_nodes <= 0:
            raise ValueError(f"n_nodes must be positive, got {self.n_nodes}")
        if len(self.rack_of) != self.n_nodes:
            raise ValueError(f"rack_of covers {len(self.rack_of)} nodes, "
                             f"n_nodes={self.n_nodes}")
        if len(self.nic_gbps) != self.n_nodes:
            raise ValueError(f"nic_gbps covers {len(self.nic_gbps)} nodes, "
                             f"n_nodes={self.n_nodes}")
        n_racks = len(self.up_gbps)
        if len(self.up_capacity_gbps) != n_racks \
                or len(self.oversub) != n_racks:
            raise ValueError("up_gbps / up_capacity_gbps / oversub must all "
                             "cover the same rack count")
        if self.profiles and len(self.profiles) != self.n_nodes:
            raise ValueError(f"profiles covers {len(self.profiles)} nodes, "
                             f"n_nodes={self.n_nodes}")
        bad = [r for r in self.rack_of if not 0 <= r < n_racks]
        if bad:
            raise ValueError(f"rack id {bad[0]} out of range for "
                             f"{n_racks} rack(s)")

    # -------------------------------------------------------- constructors
    @classmethod
    def one_switch(cls, n_nodes: int, *,
                   profiles: Sequence[NodeProfile] = ()) -> "ClusterTopology":
        """The degenerate flat topology: one ToR, infinite links.

        ``flat=True`` means the HardwareModel keeps its scalar link model and
        the simulator keeps its legacy per-NIC lanes — a run under this
        topology is bit-identical to a run without one (the equivalence
        suite pins it). Profiles still apply (per-node speeds)."""
        return cls(n_nodes=n_nodes, rack_of=(0,) * n_nodes,
                   nic_gbps=(_INF,) * n_nodes, up_gbps=(_INF,),
                   up_capacity_gbps=(_INF,), oversub=(1.0,),
                   pfs_gbps=_INF, default_nic_gbps=_INF,
                   profiles=tuple(profiles), flat=True)

    @classmethod
    def two_tier(cls, n_racks: int, nodes_per_rack: int, *,
                 nic_gbps: float = 1.25e9, oversubscription: float = 1.0,
                 pfs_gbps: float = 0.5e9,
                 profiles: Sequence[NodeProfile] = ()) -> "ClusterTopology":
        """A classic two-tier fabric: ``n_racks`` ToRs of ``nodes_per_rack``
        nodes each, every uplink oversubscribed ``oversubscription``:1.

        Per-node NIC overrides come from ``profiles`` (mixed generations);
        each uplink's effective per-flow bandwidth is
        ``nic_gbps / oversubscription`` and its nominal capacity is
        ``nodes_per_rack * nic_gbps / oversubscription``."""
        if oversubscription <= 0:
            raise ValueError("oversubscription must be positive")
        n = n_racks * nodes_per_rack
        profs = tuple(profiles)
        nics = tuple(
            (profs[i].nic_gbps if i < len(profs)
             and profs[i].nic_gbps is not None else nic_gbps)
            for i in range(n))
        share = nic_gbps / oversubscription
        cap = nodes_per_rack * nic_gbps / oversubscription
        return cls(n_nodes=n,
                   rack_of=tuple(i // nodes_per_rack for i in range(n)),
                   nic_gbps=nics, up_gbps=(share,) * n_racks,
                   up_capacity_gbps=(cap,) * n_racks,
                   oversub=(float(oversubscription),) * n_racks,
                   pfs_gbps=pfs_gbps, default_nic_gbps=nic_gbps,
                   profiles=profs)

    # ------------------------------------------------------------- accessors
    @property
    def n_racks(self) -> int:
        return len(self.up_gbps)

    def rack(self, node: int) -> int:
        """Rack of ``node`` — growth joins beyond the configured size get a
        deterministic round-robin assignment."""
        if 0 <= node < len(self.rack_of):
            return self.rack_of[node]
        return node % self.n_racks

    def nic(self, node: int) -> float:
        if 0 <= node < len(self.nic_gbps):
            return self.nic_gbps[node]
        return self.default_nic_gbps

    def speed(self, node: int) -> float:
        if 0 <= node < len(self.profiles):
            return self.profiles[node].speed
        return 1.0

    def node_class(self, node: int) -> str:
        if 0 <= node < len(self.profiles):
            return self.profiles[node].cls
        return "standard"

    def same_rack(self, a: int, b: int) -> bool:
        """True when ``a`` and ``b`` share a ToR (negative ids — the PFS —
        are in no rack)."""
        if a < 0 or b < 0:
            return False
        return self.rack(a) == self.rack(b)

    # ------------------------------------------------------------ path model
    def links(self, src: int, dst: int) -> tuple[object, ...]:
        """Lane keys of every link a ``src -> dst`` transfer occupies:
        node NICs are bare ints, ToR uplinks ``("up", rack)``, the PFS
        attachment ``("pfs",)``. Order: NICs, uplinks, PFS."""
        keys: list[object] = [n for n in (src, dst) if n >= 0]
        racks = sorted({self.rack(n) for n in (src, dst) if n >= 0})
        if src < 0 or dst < 0:                       # remote-tier endpoint
            keys.extend(("up", r) for r in racks)
            keys.append(("pfs",))
        elif len(racks) > 1:                         # crosses the spine
            keys.extend(("up", r) for r in racks)
        return tuple(keys)

    def up(self, rack: int) -> float:
        return self.up_gbps[rack] if 0 <= rack < len(self.up_gbps) else _INF

    def link_gbps(self, src: int, dst: int) -> float:
        """End-to-end bandwidth of one flow: the max-utilized (minimum
        effective capacity) link on the path."""
        if src == dst:
            return _INF
        bw = _INF
        racks = []
        for node in (src, dst):
            if node >= 0:
                bw = min(bw, self.nic(node))
                racks.append(self.rack(node))
        if src < 0 or dst < 0:
            for r in racks:
                bw = min(bw, self.up(r))
            bw = min(bw, self.pfs_gbps)
        elif len(racks) == 2 and racks[0] != racks[1]:
            for r in racks:
                bw = min(bw, self.up(r))
        return bw

    def speeds(self) -> dict[int, float]:
        """Per-node speed overrides derived from the profiles (only the
        non-nominal ones) — the simulator's default ``speeds`` mapping."""
        return {i: p.speed for i, p in enumerate(self.profiles)
                if p.speed != 1.0}
