"""Hint-assisted workflow compiler (paper §B, second component).

Input: a :class:`~repro_torch.core.dag.TaskGraph` whose tasks carry
:class:`~repro_torch.core.hints.TaskHints` and whose external inputs carry ``@size``
hints. Output: the same graph with the "rich metadata" the paper describes —

  * every dataset's size propagated through ``@input-output-ratio``,
  * every task's estimated FLOPs (``@compute-complexity`` applied to its
    now-known input bytes) and estimated runtime (FLOPs / node throughput),
  * topological order, earliest start times, upward ranks (longest path to the
    final task) — the priorities handed to the runtime scheduler.

The hardware model doubles as a roofline calculator: it knows per-node
compute throughput, memory bandwidth, and link bandwidths of the target (one
NVIDIA H100 SXM per node by default; the paper's HPC-cluster numbers and the
JAX package's TPU preset are configs).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.core.dag import TaskGraph
from repro_torch.core.locstore import REMOTE_TIER
from repro_torch.core.topology import ClusterTopology

__all__ = ["HardwareModel", "H100_SXM", "TPU_V5E", "HPC_CLUSTER",
           "CompiledWorkflow", "compile_workflow"]


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Per-node hardware constants used for static cost estimation.

    ``link_gbps(src, dst)`` distinguishes the intra-pod link (``ici_gbps``:
    NVLink inside one 8-GPU H100 node) from the cross-pod network
    (``dcn_gbps``) by pod index (node // nodes_per_pod) — the accelerator
    analogue of the paper's node-to-node vs node-to-Lustre asymmetry.

    The defaults are one NVIDIA H100 SXM5 per node, from NVIDIA's published
    data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s of HBM3, 900 GB/s of NVLink
    within an 8-GPU node, and one 400 Gb/s NDR port between nodes.

    ``tier_gbps`` names the sustained media bandwidth of each storage tier
    (device HBM / host DRAM / burst buffer / remote PFS); ``tier_bw`` and
    ``move_seconds_tiered`` are the tier-aware cost model the compiler and
    the schedulers rank candidate workers with. ``None`` entries fall back to
    the scalar fields, so flat two-tier configs keep their original costs.

    ``topology`` optionally replaces the scalar pod arithmetic with an
    explicit :class:`~repro_torch.core.topology.ClusterTopology` link graph:
    ``link_gbps`` then charges the max-utilized (minimum-capacity) link on
    the node -> ToR -> spine path. A *flat* topology (``topo.flat``,
    e.g. ``ClusterTopology.one_switch``) contributes structure only — the
    scalar model keeps answering, so costs stay bit-identical.
    """

    name: str = "h100-sxm"
    peak_flops: float = 989e12          # dense bf16 FLOP/s per GPU
    hbm_gbps: float = 3.35e12           # HBM3 bytes/s per GPU
    ici_gbps: float = 900e9             # NVLink bytes/s within a node
    dcn_gbps: float = 50e9              # 400 Gb/s NDR port between nodes
    remote_tier_gbps: float = 2.0e9     # parallel-FS tier (Lustre analogue)
    nodes_per_pod: int = 8              # GPUs on one NVLink node
    efficiency: float = 0.5             # sustained fraction of peak for estimates
    tier_gbps: Mapping[str, float] | None = None
    topology: ClusterTopology | None = None

    def link_gbps(self, src: int, dst: int) -> float:
        topo = self.topology
        if topo is not None and not topo.flat:
            return topo.link_gbps(src, dst)
        if src == dst:
            return float("inf")
        if src < 0 or dst < 0:          # negative node id == remote tier
            return self.remote_tier_gbps
        if src // self.nodes_per_pod == dst // self.nodes_per_pod:
            return self.ici_gbps
        return self.dcn_gbps

    def with_topology(self, topo: ClusterTopology | None) -> "HardwareModel":
        """This model with ``topo`` attached (``None`` detaches)."""
        if topo is self.topology:
            return self
        return dataclasses.replace(self, topology=topo)

    def tier_bw(self, tier: str) -> float:
        """Media bandwidth of one storage tier (bytes/s)."""
        if self.tier_gbps is not None and tier in self.tier_gbps:
            return self.tier_gbps[tier]
        defaults = {"hbm": self.hbm_gbps, "bb": self.hbm_gbps / 100.0,
                    "remote": self.remote_tier_gbps}
        # "host"/"node" and unknown tiers are free in the flat model: the
        # link bandwidth already is the end-to-end number there.
        return defaults.get(tier, float("inf"))

    def est_task_seconds(self, flops: float, procs: int = 1) -> float:
        return flops / (self.peak_flops * self.efficiency * max(procs, 1))

    def move_seconds(self, nbytes: float, src: int, dst: int) -> float:
        bw = self.link_gbps(src, dst)
        return 0.0 if bw == float("inf") else nbytes / bw

    def _media_seconds(self, nbytes: float, tier: str | None) -> float:
        if tier is None:
            return 0.0
        bw = self.tier_bw(tier)
        return 0.0 if bw == float("inf") else nbytes / bw

    def move_seconds_tiered(self, nbytes: float, src: int, dst: int,
                            src_tier: str | None = None,
                            dst_tier: str | None = None) -> float:
        """Link time plus the media time of reading the source tier and
        writing the destination tier — the full per-hop cost of one fetch
        through the storage hierarchy."""
        return (self.move_seconds(nbytes, src, dst)
                + self._media_seconds(nbytes, src_tier)
                + self._media_seconds(nbytes, dst_tier))


H100_SXM = HardwareModel()
# The JAX package's default target, kept as a named preset so both packages
# can be compiled against the same constants.
TPU_V5E = HardwareModel(
    name="tpu-v5e", peak_flops=197e12, hbm_gbps=819e9, ici_gbps=50e9,
    dcn_gbps=6.4e9, nodes_per_pod=256,
)
# The paper's prototype platform class: commodity cluster, Hercules over
# 10GbE, Lustre behind ~1 GB/s per client.
HPC_CLUSTER = HardwareModel(
    name="hpc-cluster", peak_flops=1e12, hbm_gbps=100e9, ici_gbps=1.25e9,
    dcn_gbps=1.25e9, remote_tier_gbps=0.5e9, nodes_per_pod=1 << 30,
)

_DEFAULT_EXTERNAL_BYTES = 1 << 20  # 1 MiB when no @size hint was given


@dataclasses.dataclass
class CompiledWorkflow:
    """The compiler's product: the annotated graph + its static analyses."""

    graph: TaskGraph
    hw: HardwareModel
    topo: list[str]
    sizes: dict[str, float]             # dataset name -> bytes
    est_flops: dict[str, float]         # task -> flops
    est_seconds: dict[str, float]       # task -> seconds
    earliest_start: dict[str, float]
    upward_rank: dict[str, float]
    critical_path: list[str]
    critical_seconds: float
    # task -> est. seconds to stage its still-on-PFS external inputs through
    # the storage hierarchy (remote read + link + top-tier write). The
    # ProactiveScheduler feeds it into preplace to pick the prefetch tier per
    # dataset (hot inputs -> hbm, bulk -> bb); benchmarks report it.
    est_stage_seconds: dict[str, float] = dataclasses.field(default_factory=dict)
    # external dataset -> est. seconds to stage IT alone into fast memory —
    # the per-dataset term est_stage_seconds sums; the scheduler compares it
    # against the consumer's compute time to classify hot vs bulk inputs.
    stage_seconds: dict[str, float] = dataclasses.field(default_factory=dict)
    # dataset -> write-mode pin ("around" for run-once streaming outputs whose
    # single consumer is predicted to run on the producing node — they never
    # need to occupy node tiers for anyone else). The runtime decides whether
    # to honor these (simulator/executor: honor_write_modes=True).
    write_modes: dict[str, str] = dataclasses.field(default_factory=dict)

    def input_bytes(self, tid: str) -> float:
        return sum(self.sizes[n] for n in self.graph.tasks[tid].inputs)

    def output_bytes(self, tid: str) -> float:
        return sum(self.sizes[n] for n in self.graph.tasks[tid].outputs)

    def summary(self) -> Mapping[str, float]:
        return {
            "tasks": len(self.graph.tasks),
            "datasets": len(self.graph.data),
            "total_bytes": sum(self.sizes.values()),
            "total_flops": sum(self.est_flops.values()),
            "critical_seconds": self.critical_seconds,
        }


def compile_workflow(graph: TaskGraph, hw: HardwareModel = H100_SXM, *,
                     strict: bool = False) -> CompiledWorkflow:
    """Run the paper's static-analysis passes over ``graph``.

    Mutates ``graph`` in place (fills ``DataSpec.size_bytes``,
    ``TaskSpec.est_flops``, ``TaskSpec.est_seconds``) and returns the bundled
    :class:`CompiledWorkflow`. ``strict=True`` refuses consumed external
    inputs without ``@size`` hints instead of defaulting them to 1 MiB.
    """
    graph.validate(strict=strict)  # cycles; size hints when strict
    topo = graph.topo_order()

    # -- pass 1: dataset size propagation via @size + @input-output-ratio ----
    sizes: dict[str, float] = {}
    for d in graph.data.values():
        if d.is_external:
            sizes[d.name] = (float(d.size_bytes) if d.size_bytes is not None
                             else float(_DEFAULT_EXTERNAL_BYTES))
    for tid in topo:
        t = graph.tasks[tid]
        in_bytes = sum(sizes[n] for n in t.inputs)
        for out in t.outputs:
            d = graph.data[out]
            if d.size_bytes is not None:        # explicit @size wins
                sizes[out] = float(d.size_bytes)
            else:
                per_out = in_bytes / max(len(t.outputs), 1)
                sizes[out] = t.hints.ratio_for(out) * (
                    per_out if len(t.outputs) > 1 else in_bytes)
            d.size_bytes = sizes[out]

    # -- pass 2: task cost estimation via @compute-complexity + @task -------
    est_flops: dict[str, float] = {}
    est_seconds: dict[str, float] = {}
    for tid in topo:
        t = graph.tasks[tid]
        in_bytes = sum(sizes[n] for n in t.inputs)
        f = t.hints.compute.flops(in_bytes)
        est_flops[tid] = f
        s = (t.hints.est_seconds if t.hints.est_seconds is not None
             else hw.est_task_seconds(f, t.hints.procs))
        est_seconds[tid] = s
        t.est_flops, t.est_seconds = f, s

    # -- pass 3: schedule-facing analyses ------------------------------------
    cost = lambda tid: est_seconds[tid]  # noqa: E731
    earliest = graph.earliest_start(cost)
    rank = graph.upward_rank(cost)
    cpath, cseconds = graph.critical_path()

    # -- pass 4: tier-aware stage-in estimates -------------------------------
    # External inputs start on the remote PFS; what does it cost each task to
    # pull them up the storage hierarchy into fast memory? (The per-tier
    # bandwidths live in the HardwareModel, so one config covers compiler,
    # schedulers and simulator.)
    external = {d.name for d in graph.external_inputs()}
    ds_stage = {n: hw.move_seconds_tiered(sizes[n], REMOTE_TIER, 0,
                                          "remote", "hbm")
                for n in external}
    stage: dict[str, float] = {}
    for tid in topo:
        t = graph.tasks[tid]
        stage[tid] = sum(ds_stage[n] for n in t.inputs if n in external)

    # -- pass 5: per-dataset write-mode pins ---------------------------------
    # A produced dataset with exactly ONE consumer whose locality-bound node
    # is the producing node is a write-around candidate: no other node will
    # ever read it, so it need not occupy node tiers on anyone's behalf.
    # Co-location is predicted statically the way the LocalityScheduler binds
    # tasks — the consumer runs where the majority of its input bytes sit, so
    # the pin fires only when this producer made a strict majority of them.
    write_modes: dict[str, str] = {}
    for d in graph.data.values():
        if d.is_external or len(d.consumers) != 1:
            continue
        consumer = graph.tasks[d.consumers[0]]
        total_in = sum(sizes[n] for n in consumer.inputs)
        from_producer = sum(sizes[n] for n in consumer.inputs
                            if graph.data[n].producer == d.producer)
        if total_in > 0 and from_producer * 2 > total_in:
            write_modes[d.name] = "around"
            d.xattr["write_mode"] = "around"

    return CompiledWorkflow(
        graph=graph, hw=hw, topo=topo, sizes=sizes,
        est_flops=est_flops, est_seconds=est_seconds,
        earliest_start=earliest, upward_rank=rank,
        critical_path=cpath, critical_seconds=cseconds,
        est_stage_seconds=stage, stage_seconds=ds_stage,
        write_modes=write_modes,
    )
