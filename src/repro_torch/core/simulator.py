"""Discrete-event cluster simulator — how we evaluate the paper's schedulers at
1000+ node scale inside a CPU-only container.

Models exactly the quantities the paper's argument rests on:

* workers (one task slot each, optional per-node speed factors = stragglers),
* the tiered LocStore (per-node HBM/DRAM/burst-buffer capacities + the remote
  parallel-FS tier; default: the paper's flat two-tier model), with every byte
  fetched across the network — and every capacity-pressure demotion —
  accounted,
* per-destination NIC serialization (transfers to one node queue up),
* per-task **I/O wait** (assignment -> inputs resident), the number the paper's
  proactive pipelining is designed to drive to ~zero,
* node failures (re-run lost producers, reschedule the running task) so the
  fault-tolerance story is testable.

The same :class:`~repro_torch.core.scheduler.SchedulerBase` objects drive this
simulator and the real executor — the simulator is not a re-implementation
of the policy, only of the cluster.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
import itertools
from typing import Callable, Mapping, Sequence

from repro_torch.core.config import SimConfig
from repro_torch.core.locstore import (DropReport, JoinReport, LocStore, Placement,
                                 REMOTE_TIER, SimObject, _stable_hash)
from repro_torch.core.scheduler import (Assignment, ClusterView, LocalityScheduler,
                                  ProactiveScheduler, SchedulerBase)
from repro_torch.core.topology import ClusterTopology
from repro_torch.core.wfcompiler import CompiledWorkflow, HardwareModel

__all__ = ["SimConfig", "SimResult", "SimCluster", "WorkflowSimulator",
           "simulate"]


@dataclasses.dataclass
class SimResult:
    makespan: float
    bytes_moved: float            # network bytes on the critical fetch path
    bytes_prefetched: float       # network bytes moved ahead of time
    bytes_local: float            # bytes served without the network
    io_wait_total: float          # sum of per-task input-stall seconds
    io_wait_max: float
    tasks_done: int
    reruns: int                   # failure-induced re-executions
    task_records: dict[str, dict] = dataclasses.field(default_factory=dict)
    remote_bytes: float = 0.0     # network bytes to/from the PFS tier
    bytes_demoted: float = 0.0    # capacity-pressure eviction traffic
    demotions: int = 0
    promotions: int = 0
    writebacks: int = 0           # async dirty flushes to the PFS
    writeback_bytes: float = 0.0
    clean_drops: int = 0          # free evictions (PFS already had the copy)
    coord_drops: int = 0          # free evictions (duplicate elsewhere)
    pin_protected_evictions: int = 0  # evictions a do-not-evict pin diverted
    # durability / failure accounting
    fsyncs: int = 0               # synchronous durability flushes
    fsync_bytes: float = 0.0
    dirty_lost: int = 0           # lost objects a tighter window would've kept
    phantom_durable: int = 0      # laundered drains (must stay 0)
    prefetch_aborts: int = 0      # in-flight transfers whose src node died
    # elastic membership accounting
    joins: int = 0                # nodes (re)admitted mid-run
    rereplications: int = 0       # sole-copy objects staged toward newcomers
    bytes_rereplicated: float = 0.0
    # topology accounting (stays 0/empty on flat configs)
    cross_spine_bytes: float = 0.0   # bytes that traversed any ToR uplink
    predictive_rereplications: int = 0  # sole copies drained off suspects
    bytes_predictively_rereplicated: float = 0.0
    drop_reports: list[DropReport] = dataclasses.field(default_factory=list)
    join_reports: list[JoinReport] = dataclasses.field(default_factory=list)
    # per-link cumulative bytes under a real topology: NIC lanes keyed by
    # node id, uplinks by ("up", rack), the PFS attachment by ("pfs",)
    link_bytes: dict = dataclasses.field(default_factory=dict)

    @property
    def locality_hit_rate(self) -> float:
        tot = self.bytes_local + self.bytes_moved
        return self.bytes_local / tot if tot else 1.0

    def summary(self) -> Mapping[str, float]:
        return {
            "makespan_s": self.makespan,
            "bytes_moved": self.bytes_moved,
            "bytes_prefetched": self.bytes_prefetched,
            "locality_hit_rate": self.locality_hit_rate,
            "io_wait_total_s": self.io_wait_total,
            "io_wait_max_s": self.io_wait_max,
            "tasks": float(self.tasks_done),
            "reruns": float(self.reruns),
            "remote_bytes": self.remote_bytes,
            "bytes_demoted": self.bytes_demoted,
            "demotions": float(self.demotions),
            "promotions": float(self.promotions),
            "writebacks": float(self.writebacks),
            "writeback_bytes": self.writeback_bytes,
            "clean_drops": float(self.clean_drops),
            "coord_drops": float(self.coord_drops),
            "fsyncs": float(self.fsyncs),
            "fsync_bytes": self.fsync_bytes,
            "dirty_lost": float(self.dirty_lost),
            "phantom_durable": float(self.phantom_durable),
            "prefetch_aborts": float(self.prefetch_aborts),
            "joins": float(self.joins),
            "rereplications": float(self.rereplications),
            "bytes_rereplicated": self.bytes_rereplicated,
            "cross_spine_bytes": self.cross_spine_bytes,
            "predictive_rereplications": float(self.predictive_rereplications),
            "bytes_predictively_rereplicated":
                self.bytes_predictively_rereplicated,
        }


class _LinkLanes:
    """One priority class of transfer lanes over the network.

    Flat model (``topo is None``): one lane per node NIC — exactly the
    legacy per-destination ``nic_free`` lists, bit-identical. Real topology:
    a transfer occupies **every link on its path** (endpoint NICs, the
    racks' ToR uplinks, the PFS attachment), so concurrent transfers
    through a shared uplink or the PFS link genuinely contend — the
    per-NIC lanes are the degenerate single-link special case.
    """

    __slots__ = ("topo", "node", "extra")

    def __init__(self, topo: ClusterTopology | None, n_nodes: int,
                 t0: float = 0.0) -> None:
        self.topo = topo                  # None => legacy per-NIC lanes
        self.node = [t0] * n_nodes        # NIC lane per node
        self.extra: dict = {}             # ("up", rack)/("pfs",) -> busy-until

    def __len__(self) -> int:
        return len(self.node)

    def avail(self, path) -> float:
        """Earliest instant every link on ``path`` is free."""
        t = 0.0
        for k in path:
            v = self.node[k] if isinstance(k, int) else self.extra.get(k, 0.0)
            if v > t:
                t = v
        return t

    def occupy(self, path, until: float) -> None:
        for k in path:
            if isinstance(k, int):
                self.node[k] = until
            else:
                self.extra[k] = until

    def reset_node(self, node: int, t0: float) -> None:
        """A dead/rejoining node's NIC serves nothing: its lane restarts at
        ``t0``. Shared uplink/PFS lanes keep their queued traffic — the
        fabric does not forget other tenants' transfers."""
        self.node[node] = t0

    def grow_to(self, n: int, t0: float) -> None:
        while len(self.node) < n:
            self.node.append(t0)


class SimCluster(ClusterView):
    """ClusterView over simulator state (free set, store, link model).

    ``free_workers()``/``alive_nodes()`` are cached between mutations — the
    schedulers call them every tick, and re-sorting a 4096-entry set per call
    was a measurable slice of per-decision cost. Mutate through
    :meth:`acquire`/:meth:`release`/:meth:`fail` so the caches invalidate.
    """

    def __init__(self, n_nodes: int, hw: HardwareModel, store: LocStore,
                 speeds: Mapping[int, float] | None = None) -> None:
        self.n_nodes = n_nodes
        self.hw = hw
        self.store = store
        self.speeds = dict(speeds or {})
        self.free: set[int] = set(range(n_nodes))
        self.failed: set[int] = set()
        self._free_cache: list[int] | None = None
        self._alive_cache: list[int] | None = None
        # per-source link-bandwidth rows for batched candidate scoring:
        # bandwidths are static per HardwareModel, so each row is built once
        self._link_rows: dict[int, tuple[list[float], float | None]] = {}
        # topology-aware runs attach the simulator's demand lanes + clock so
        # the schedulers can route around saturated links (node_queue_seconds)
        self.now = 0.0
        self._lanes: _LinkLanes | None = None

    def attach_lanes(self, lanes: _LinkLanes) -> None:
        self._lanes = lanes

    def node_queue_seconds(self, node: int) -> float:
        """Seconds of already-queued demand traffic a new transfer to/from
        ``node`` would wait behind — the max backlog over the node's NIC and
        its rack's ToR uplink. 0.0 on flat topologies (no lanes attached),
        which keeps flat scheduling decisions identical."""
        lanes = self._lanes
        if lanes is None:
            return 0.0
        q = lanes.node[node] - self.now if node < len(lanes.node) else 0.0
        topo = lanes.topo
        if topo is not None:
            up = lanes.extra.get(("up", topo.rack(node)), 0.0) - self.now
            if up > q:
                q = up
        return q if q > 0.0 else 0.0

    def acquire(self, node: int) -> None:
        """A task started on ``node`` — it is no longer free."""
        self.free.discard(node)
        self._free_cache = None

    def release(self, node: int) -> None:
        """A task finished on ``node`` — free again unless it failed."""
        if node not in self.failed:
            self.free.add(node)
            self._free_cache = None

    def fail(self, node: int) -> None:
        self.failed.add(node)
        self.free.discard(node)
        self._free_cache = None
        self._alive_cache = None

    def join(self, node: int) -> None:
        """Absorb a (re)joining node into the cached views incrementally —
        no rescan: the sorted free/alive caches get a bisect-insort, and on
        growth every cached link row is extended in place (bandwidths are
        static per HardwareModel, so appending the new destinations keeps
        each row exact)."""
        grew = node >= self.n_nodes
        if grew:
            old_n = self.n_nodes
            self.n_nodes = node + 1
            # skipped ids in a gapped growth join never joined: mark them
            # failed so an eventual cache rebuild agrees with the
            # incremental inserts below (alive + failed partitions
            # range(n_nodes), exactly as in LocStore.join_node)
            self.failed.update(range(old_n, node))
            for src, (row, _uniform) in list(self._link_rows.items()):
                row.extend(self.hw.link_gbps(src, dst)
                           for dst in range(old_n, self.n_nodes))
                vals = set(row[:src] + row[src + 1:]
                           if 0 <= src < self.n_nodes else row)
                uniform = vals.pop() if len(vals) == 1 else None
                self._link_rows[src] = (row, uniform)
        was_failed = node in self.failed
        self.failed.discard(node)
        if not (was_failed or grew):
            return          # already a live member (possibly busy): no-op
        self.free.add(node)
        for cache in (self._free_cache, self._alive_cache):
            if cache is not None:
                i = bisect.bisect_left(cache, node)
                if i == len(cache) or cache[i] != node:
                    cache.insert(i, node)

    def free_workers(self) -> Sequence[int]:
        if self._free_cache is None:
            self._free_cache = sorted(self.free - self.failed)
        return self._free_cache

    def alive_nodes(self) -> Sequence[int]:
        if self._alive_cache is None:
            self._alive_cache = [n for n in range(self.n_nodes)
                                 if n not in self.failed]
        return self._alive_cache

    def link_row(self, src: int) -> tuple[list[float], float | None]:
        info = self._link_rows.get(src)
        if info is None:
            row = [self.hw.link_gbps(src, dst) for dst in range(self.n_nodes)]
            # uniform = the single off-diagonal bandwidth, if there is one
            # (the src->src entry is inf and never consulted by the scorer)
            vals = set(row[:src] + row[src + 1:]
                       if 0 <= src < self.n_nodes else row)
            uniform = vals.pop() if len(vals) == 1 else None
            info = (row, uniform)
            self._link_rows[src] = info
        return info

    def locate(self, data_name: str) -> Placement | None:
        return self.store.loc.lookup(data_name)

    def is_durable(self, data_name: str) -> bool:
        return self.store.durable(data_name)

    def link_gbps(self, src: int, dst: int) -> float:
        return self.hw.link_gbps(src, dst)

    def tier_gbps(self, tier: str) -> float:
        return self.store.hierarchy.bw(tier)

    def top_tier(self) -> str:
        return self.store.hierarchy.top

    def bulk_tier(self) -> str:
        return self.store.hierarchy.bottom

    def worker_speed(self, node: int) -> float:
        return self.speeds.get(node, 1.0)


# event kinds, ordered so same-time finishes are processed before starts
_TASK_FINISH = 0
_XFER_DONE = 1
_FAIL = 2
_WB_FLUSH = 3
_JOIN = 4
_PREDICT = 5        # health monitor flags a node ahead of its failure


class WorkflowSimulator:
    def __init__(
        self,
        wf: CompiledWorkflow,
        scheduler: SchedulerBase,
        *,
        config: SimConfig | None = None,
        **legacy,
    ) -> None:
        # documented path: one frozen SimConfig. Legacy path: the original
        # flat keywords (n_nodes=, hierarchy=, write_policy=, ...), mapped
        # through SimConfig.from_kwargs — the pinned equivalence test proves
        # both spellings produce identical SimResults. Mixing them is a
        # config-aliasing bug waiting to happen, so it is rejected.
        if config is None:
            config = SimConfig.from_kwargs(**legacy)
        elif legacy:
            raise TypeError("WorkflowSimulator: pass config= OR the legacy "
                            f"keywords, not both: {sorted(legacy)}")
        self.config = config
        self.wf = wf
        self.sched = scheduler
        topo = config.topology
        if topo is not None and topo.n_nodes != config.n_nodes:
            raise ValueError(f"topology covers {topo.n_nodes} nodes, "
                             f"n_nodes={config.n_nodes}")
        # the *charging* model: with a topology attached, move_seconds prices
        # the max-utilized link on the node->ToR->spine path (flat topologies
        # keep the scalar arithmetic, so costs are bit-identical)
        self.hw = config.hw.with_topology(topo) if topo is not None \
            else config.hw
        # a real (non-flat) topology switches the NIC lanes to per-link lanes
        self._topo_real = topo if topo is not None and not topo.flat else None
        # the schedulers'/store's *view*: topology_aware=False is the blind
        # ablation — the simulator still charges real per-link costs, but
        # placement decisions see only the flat scalar model
        view_hw = self.hw if config.topology_aware else config.hw
        store_topo = topo if config.topology_aware else None
        # per-node speeds: topology profiles supply the defaults
        # (mixed-generation clusters); explicit config.speeds overrides win
        speeds: dict[int, float] = dict(topo.speeds()) if topo is not None \
            else {}
        if config.speeds:
            speeds.update(config.speeds)
        self.n_nodes = config.n_nodes
        self.store = LocStore(config.n_nodes, hierarchy=config.hierarchy,
                              write_policy=config.write_policy,
                              coordinated_eviction=config.coordinated_eviction,
                              durability=config.durability,
                              topology=store_topo)
        # fsync_on_barrier: a store barrier (flush everything dirty) fires
        # every `barrier_every` task finishes — the workflow's sync points
        self.barrier_every = max(int(config.barrier_every), 1)
        self.cluster = SimCluster(config.n_nodes, view_hw, self.store,
                                  speeds or None)
        self.failures = sorted(config.failures)
        self.joins = sorted(config.joins)
        self.join_rereplicate_bytes = config.join_rereplicate_bytes
        self.proactive = (isinstance(scheduler, ProactiveScheduler)
                          if config.proactive is None else config.proactive)
        # honor the compiler's per-dataset write-mode pins (pass 5): outputs
        # pinned "around" stream straight to the PFS instead of landing in
        # node tiers — trading the consumer's (remote) read for zero tier
        # occupancy, which only pays off under capacity pressure. False:
        # never; True: all pins, unconditionally (legacy opt-in); "auto"
        # (default): only the pins repro_torch.analysis proves safe, and only in
        # configurations where the trade can win (finite node tier, a
        # locality-aware scheduler, stable membership).
        hwm = config.honor_write_modes
        if hwm not in (False, True, "auto"):
            raise ValueError(f"honor_write_modes must be True, False or "
                             f"'auto', got {hwm!r}")
        self.honor_write_modes = hwm
        # in auto mode the put path additionally diverts a pin whose consumer
        # is already bound to a DIFFERENT node at put time; explicit True
        # keeps the unguarded semantics
        self._write_mode_guard = hwm == "auto"
        if hwm is True:
            self._write_modes: dict[str, str] = dict(wf.write_modes)
        elif hwm == "auto":
            self._write_modes = self._auto_write_modes(wf, config, scheduler)
        else:
            self._write_modes = {}
        # runtime invariant sanitizer (repro_torch.analysis.sanitize): opt-in via
        # config or the REPRO_SANITIZE env var; checks every incremental
        # structure against a from-scratch rebuild every sanitize_every events
        if config.sanitize is None:
            from repro_torch.analysis.sanitize import env_enabled
            self.sanitize = env_enabled()
        else:
            self.sanitize = bool(config.sanitize)
        self.sanitize_every = max(int(config.sanitize_every), 1)
        # prefetched replicas pinned do-not-evict until their consumer runs
        self._task_pins: dict[str, list[tuple[str, int]]] = {}
        # wire the scheduler to the store's metadata events. indexed=True
        # turns on the incremental decision path (placement mirror, term
        # cache, ready heap, pending-candidate index); indexed=False is the
        # decision-identical full-rescan reference the equivalence tests
        # compare against — the event wiring itself stays on in both modes
        # (the proactive pre-assignment/prefetch invalidation depends on it).
        self.indexed = config.indexed
        scheduler.attach_store(self.store, indexed=config.indexed)
        # place external inputs: remote tier (paper's parallel FS) or scattered
        for d in wf.graph.external_inputs():
            if config.external_loc == "remote":
                loc = Placement(nodes=(REMOTE_TIER,), tier="remote")
            else:
                # content-stable hash: scattered placement must not depend
                # on the process's string-hash salt (reproducible runs)
                loc = Placement(nodes=(_stable_hash(d.name)
                                       % config.n_nodes,))
            self.store.put(d.name, SimObject(wf.sizes[d.name]), loc=loc)

    # ------------------------------------------------------------------ run
    def run(self) -> SimResult:
        wf, sched = self.wf, self.sched
        now = 0.0
        seq = itertools.count()
        events: list[tuple[float, int, int, object]] = []
        for t, node in self.failures:
            heapq.heappush(events, (t, next(seq), _FAIL, node))
        # joins pushed after failures: a same-instant fail-then-join cycle
        # processes the failure first (seq breaks the time tie in push order)
        for t, node in self.joins:
            heapq.heappush(events, (t, next(seq), _JOIN, node))
        if self.config.predict_failures:
            # health-monitor model: each scheduled failure is flagged
            # predict_lead_s ahead, giving the predictive re-replication
            # trigger time to drain the suspect's sole copies
            lead = max(float(self.config.predict_lead_s), 0.0)
            for t, node in self.failures:
                heapq.heappush(events,
                               (max(t - lead, 0.0), next(seq), _PREDICT, node))

        unfinished_preds = {tid: sum(1 for _ in wf.graph.predecessors(tid))
                            for tid in wf.graph.tasks}
        state = {tid: "pending" for tid in wf.graph.tasks}  # pending|ready|running|done
        running_at: dict[str, int] = {}
        # per-task run generation: a failure requeues the task and a new
        # attempt may start before the OLD attempt's finish event pops — the
        # stale event must not complete the new run early
        run_gen: dict[str, int] = {}
        # Per-link transfer lanes, two priority classes: demand fetches queue
        # only behind demand; prefetch is preemptible background traffic that
        # fills idle network time (the paper pipelines "while predecessors
        # run"). Flat configs get one lane per destination NIC (the legacy
        # model, bit-identical); a real topology adds ToR-uplink and PFS
        # lanes, so transfers through a shared spine contend (_LinkLanes).
        topo = self._topo_real
        nic_free = _LinkLanes(topo, self.n_nodes)     # demand channel
        nic_bg_free = _LinkLanes(topo, self.n_nodes)  # background (prefetch)
        if topo is not None and self.config.topology_aware:
            self.cluster.attach_lanes(nic_free)
        # (src, dst) -> lane-key path, memoized (rebuilt-from-scratch by the
        # sanitizer's check_link_paths at checkpoints)
        self._path_cache: dict[tuple[int, int], tuple] = {}
        path_cache = self._path_cache
        link_bytes: dict = {}
        cross_spine_bytes = 0.0
        io_wait: dict[str, float] = {}
        bytes_prefetched = 0.0
        reruns = 0
        dirty_lost = 0
        prefetch_aborts = 0
        joins_done = 0
        rereplications = 0
        bytes_rereplicated = 0.0
        predictive_rereps = 0
        bytes_predictive = 0.0

        def lane_path(src: int, dst: int, endpoint: int) -> tuple:
            """Lane keys a src->dst transfer occupies. Flat model: just the
            charged endpoint's NIC (legacy semantics)."""
            if topo is None:
                return (endpoint,)
            key = (src, dst)
            p = path_cache.get(key)
            if p is None:
                p = topo.links(src, dst)
                path_cache[key] = p
            return p

        def note_bytes(path: tuple, nbytes: float) -> None:
            """Per-link byte accounting (real topologies only): every link on
            the path carries the payload; a transfer counts toward
            cross_spine_bytes once if it traversed any ToR uplink."""
            nonlocal cross_spine_bytes
            if topo is None:
                return
            crossed = False
            for k in path:
                link_bytes[k] = link_bytes.get(k, 0.0) + nbytes
                if k.__class__ is tuple and k[0] == "up":
                    crossed = True
            if crossed:
                cross_spine_bytes += nbytes
        drop_reports: list[DropReport] = []
        join_reports: list[JoinReport] = []
        records: dict[str, dict] = {}
        done = 0
        total = len(wf.graph.tasks)
        xfer_cursor = 0               # store.transfers scanned so far

        ready: set[str] = {tid for tid, n in unfinished_preds.items() if n == 0}
        for tid in ready:
            state[tid] = "ready"

        def data_available(name: str) -> bool:
            return self.store.exists(name)

        # -- pending-candidate index (indexed mode) -------------------------
        # preplace() wants every PENDING task with >= 1 materialized input.
        # The reference path rescans all tasks x inputs each tick; here we
        # keep a per-task materialized-input count, maintained from the
        # store's record/drop events via the dataset consumer lists, plus a
        # bisect-sorted (graph-order, tid) list of current members — the same
        # order ``state.items()`` yields, so preplace's stable rank sort
        # breaks ties identically. Membership changes on: a dataset
        # (dis)appearing (store event), a task leaving "pending" (the
        # finish-unlock loop below), or a failure rollback (rare; we rebuild).
        use_index = (self.indexed and self.proactive
                     and isinstance(sched, ProactiveScheduler))
        order = {tid: i for i, tid in enumerate(wf.graph.tasks)}
        exists_mirror: set[str] = set()
        avail_count: dict[str, int] = {}
        cand_list: list[tuple[int, str]] = []
        cand_set: set[str] = set()

        def cand_check(tid: str) -> None:
            should = state[tid] == "pending" and avail_count[tid] > 0
            if should and tid not in cand_set:
                cand_set.add(tid)
                bisect.insort(cand_list, (order[tid], tid))
            elif not should and tid in cand_set:
                cand_set.remove(tid)
                cand_list.remove((order[tid], tid))

        def cand_rebuild() -> None:
            """Recompute index membership from scratch (after a failure's
            state rollbacks). avail_count stays event-maintained — exact,
            since ``exists()`` is lookup()-is-not-None and every lookup
            change funnels through a record/drop event."""
            cand_list.clear()
            cand_set.clear()
            for tid in wf.graph.tasks:
                if state[tid] == "pending" and avail_count[tid] > 0:
                    cand_set.add(tid)
                    cand_list.append((order[tid], tid))

        def on_store_event(event: str, key: str, placement: object) -> None:
            if event == "record":
                if key not in exists_mirror:
                    exists_mirror.add(key)
                    d = wf.graph.data.get(key)
                    if d is not None:
                        for c in d.consumers:
                            avail_count[c] += 1
                            cand_check(c)
            elif event == "drop":
                if key in exists_mirror:
                    exists_mirror.discard(key)
                    d = wf.graph.data.get(key)
                    if d is not None:
                        for c in d.consumers:
                            avail_count[c] -= 1
                            cand_check(c)

        if use_index:
            exists_mirror.update(self.store.loc.names())
            for tid, t in wf.graph.tasks.items():
                avail_count[tid] = sum(1 for n in t.inputs
                                       if n in exists_mirror)
            cand_rebuild()
            self.store.loc.subscribe(on_store_event)

        def on_pin_event(event: str, key: object, placement: object) -> None:
            # keep _task_pins mirroring the store's pin table: delete() and
            # drop_node() release pins INSIDE the store, so the task-finish
            # unpin for a stale mirror entry would decrement a fresh pin
            # someone re-acquired for the same (name, node) later
            if event == "drop":
                for pins in self._task_pins.values():
                    if pins:
                        pins[:] = [p for p in pins if p[0] != key]
            elif event == "drop_node":
                for pins in self._task_pins.values():
                    if pins:
                        pins[:] = [p for p in pins if p[1] != key]

        self.store.loc.subscribe(on_pin_event)

        n_events = 0
        if self.sanitize:
            from repro_torch.analysis import sanitize as _san

        def sanitize_check() -> None:
            _san.check_membership(self.store, self.cluster)
            _san.check_tier_usage(self.store)
            _san.check_ledger(self.store)
            _san.check_pin_conservation(self.store, self._task_pins)
            _san.check_placement_mirror(sched, self.store)
            _san.check_term_cache(sched, self.cluster)
            _san.check_proactive(sched, self.cluster)
            _san.check_link_rows(self.cluster)
            _san.check_link_paths(path_cache, topo)
            if use_index:
                _san.check_candidate_index(
                    state=state, avail_count=avail_count,
                    cand_list=cand_list, cand_set=cand_set,
                    exists_mirror=exists_mirror, order=order,
                    store=self.store, graph=wf.graph)

        def fetch_time(name: str, dst: int, t0: float) -> float:
            """Queue one input fetch on dst's NIC; returns completion time.

            A local hit still costs its resident tier's media time (reading a
            burst-buffer replica is not free, just cheaper than the PFS); a
            network fetch pays link + per-tier-hop media time.
            """
            value, tr = self.store.get(name, at=dst)
            if tr is None:
                return t0
            if tr.local:
                return t0 + tr.est_seconds
            dur = self.hw.move_seconds(tr.nbytes, tr.src, dst) + tr.est_seconds
            path = lane_path(tr.src, dst, dst)
            start = max(nic_free.avail(path), t0)
            nic_free.occupy(path, start + dur)
            note_bytes(path, tr.nbytes)
            return start + dur

        def drain_eviction_traffic(t0: float) -> None:
            """Charge PFS-bound eviction traffic to the evicting node's NIC.

            Write-through spills (kind demote/spill) are synchronous — they
            occupy the DEMAND lane, so the fetches tasks are waiting on queue
            behind them: that is the critical-path cost async write-back
            exists to remove. Write-back flushes and write-around streams
            (kind writeback/writearound) overlap compute on the background
            lane, competing only with prefetch for idle network time."""
            nonlocal xfer_cursor
            new = self.store.transfers[xfer_cursor:]
            xfer_cursor = len(self.store.transfers)
            for tr in new:
                if tr.dst != REMOTE_TIER or not (0 <= tr.src < self.n_nodes):
                    continue
                dur = (self.hw.move_seconds(tr.nbytes, tr.src, REMOTE_TIER)
                       + tr.est_seconds)
                path = lane_path(tr.src, REMOTE_TIER, tr.src)
                if tr.kind in ("demote", "spill", "fsync"):
                    # fsync is ack/barrier-blocking by design: it rides the
                    # demand lane, so the durability window's cost is real —
                    # fetches queue behind the eager flush
                    end = max(nic_free.avail(path), t0) + dur
                    nic_free.occupy(path, end)
                    note_bytes(path, tr.nbytes)
                elif tr.kind == "writearound":
                    end = max(nic_bg_free.avail(path), t0) + dur
                    nic_bg_free.occupy(path, end)
                    note_bytes(path, tr.nbytes)
                elif tr.kind == "writeback":
                    # the flush becomes durable when the background lane
                    # finishes it, not at enqueue — the queue is FIFO and
                    # transfers are scanned in enqueue order, so one
                    # flush-done event per transfer drains the right entry
                    end = max(nic_bg_free.avail(path), t0) + dur
                    nic_bg_free.occupy(path, end)
                    note_bytes(path, tr.nbytes)
                    heapq.heappush(events, (end, next(seq), _WB_FLUSH, None))

        def start_assignment(a: Assignment, t0: float) -> None:
            nonlocal done
            tid = a.tid
            state[tid] = "running"
            running_at[tid] = a.node
            self.cluster.acquire(a.node)
            t_inputs = t0
            for name in wf.graph.tasks[tid].inputs:
                t_inputs = max(t_inputs, fetch_time(name, a.node, t0))
            io_wait[tid] = t_inputs - t0
            dur = wf.est_seconds[tid] / max(self.cluster.worker_speed(a.node), 1e-6)
            finish = t_inputs + dur
            records[tid] = {"node": a.node, "assigned": t0, "start": t_inputs,
                            "finish": finish, "io_wait": t_inputs - t0,
                            "move_est": a.move_seconds}
            run_gen[tid] = run_gen.get(tid, 0) + 1
            heapq.heappush(events, (finish, next(seq), _TASK_FINISH,
                                    (tid, run_gen[tid])))

        def schedule_pass(t0: float) -> None:
            nonlocal bytes_prefetched
            drain_eviction_traffic(t0)
            self.cluster.now = t0   # node_queue_seconds measures backlog
            if ready and self.cluster.free_workers():
                for a in sched.select(sorted(ready), self.cluster):
                    ready.discard(a.tid)
                    start_assignment(a, t0)
            if self.proactive and isinstance(sched, ProactiveScheduler):
                if use_index:
                    candidates = [tid for _, tid in cand_list]
                else:
                    candidates = [tid for tid, st in state.items()
                                  if st == "pending"
                                  and any(data_available(n)
                                          for n in wf.graph.tasks[tid].inputs)]
                for req in sched.preplace(candidates, self.cluster, running_at):
                    p = self.store.loc.lookup(req.data_name)
                    if p is None or p.resident_on(req.dst):
                        continue
                    src = p.real_loc
                    hier = self.store.hierarchy
                    dst_tier = hier.normalize(req.tier)
                    dur = (self.hw.move_seconds(req.est_bytes, src, req.dst)
                           + hier.media_seconds(req.est_bytes, p.tier_on(src))
                           + hier.media_seconds(req.est_bytes, dst_tier))
                    path = lane_path(src, req.dst, req.dst)
                    start = max(nic_bg_free.avail(path),
                                nic_free.avail(path), t0)
                    nic_bg_free.occupy(path, start + dur)
                    note_bytes(path, req.est_bytes)
                    bytes_prefetched += req.est_bytes
                    heapq.heappush(events, (start + dur, next(seq), _XFER_DONE,
                                            (req.data_name, src, req.dst,
                                             dst_tier, req.for_task)))

        def fail_node(node: int, t0: float) -> None:
            nonlocal reruns, dirty_lost
            # charge transfers issued before the failure to the NIC model
            # first, so the lane reset below cannot erase pre-failure traffic
            drain_eviction_traffic(t0)
            self.cluster.fail(node)
            # the dead node's NIC lanes serve nothing anymore: reset them so
            # later accounting cannot queue behind (or charge) a dead queue
            # (shared uplink/PFS lanes keep other tenants' queued traffic)
            nic_free.reset_node(node, t0)
            nic_bg_free.reset_node(node, t0)
            # requeue the running task and release its prefetch pins — the
            # task-finish unpin will never fire for a failure-cancelled task
            for tid, n in list(running_at.items()):
                if n == node:
                    running_at.pop(tid)
                    state[tid] = "ready"
                    ready.add(tid)
                    reruns += 1
                    for pname, pdst in self._task_pins.pop(tid, []):
                        self.store.unpin(pname, pdst)
            # one atomic storage-layer drop: forget the node's replicas,
            # cancel in-flight write-back flushes sourced on it (a later
            # drain must not mark a lost object durable), clear its pins
            report = self.store.drop_node(node)
            drop_reports.append(report)
            dirty_lost += len(report.dirty_lost)
            nonlocal done
            for name in report.lost:   # data gone: re-run the producers
                prod = wf.graph.data[name].producer
                if prod is None:       # external input: remote tier still has it
                    self.store.put(name, SimObject(wf.sizes[name]),
                                   loc=Placement((REMOTE_TIER,), tier="remote"))
                    continue
                if state[prod] == "done":
                    reruns += 1
                    done -= self._invalidate(prod, state, unfinished_preds,
                                             ready, running_at)
            if use_index:
                # the requeue/rollback above moved tasks between pending and
                # ready in bulk — failures are rare, recompute membership
                cand_rebuild()

        def join_node(node: int, t0: float) -> None:
            nonlocal joins_done, rereplications, bytes_rereplicated
            # charge pre-join traffic before touching the newcomer's lanes
            drain_eviction_traffic(t0)
            grew = node >= len(nic_free)
            was_failed = node in self.cluster.failed
            nic_free.grow_to(node + 1, t0)
            nic_bg_free.grow_to(node + 1, t0)
            if was_failed:
                # a rejoining node's NIC starts idle at the join instant
                # (an already-alive node keeps its queued traffic)
                nic_free.reset_node(node, t0)
                nic_bg_free.reset_node(node, t0)
            # storage layer first: clears the failed mark, reopens default
            # placement, and fires ("join_node", node, None) so the indexed
            # scheduler and preplace eligibility absorb the newcomer
            report = self.store.join_node(node)
            join_reports.append(report)
            self.cluster.join(node)
            if report.grew:
                self.n_nodes = self.store.n_nodes
            joins_done += 1
            # re-replicate toward the newcomer: sole-copy objects, dirty
            # first (the write side of risk_aware) — staged as background
            # transfers so the copies pay real network/media time and only
            # materialize when the lane delivers them (_XFER_DONE with no
            # consuming task: replicate without a pin)
            bulk = self.store.hierarchy.bottom
            for name, src, src_tier, nbytes in \
                    self.store.rereplication_candidates(
                        node, max_bytes=self.join_rereplicate_bytes):
                dur = (self.hw.move_seconds(nbytes, src, node)
                       + self.store.hierarchy.media_seconds(nbytes, src_tier)
                       + self.store.hierarchy.media_seconds(nbytes, bulk))
                path = lane_path(src, node, node)
                start = max(nic_bg_free.avail(path), t0)
                nic_bg_free.occupy(path, start + dur)
                note_bytes(path, nbytes)
                rereplications += 1
                bytes_rereplicated += nbytes
                heapq.heappush(events, (start + dur, next(seq), _XFER_DONE,
                                        (name, src, node, bulk, None)))

        def predict_node(suspect: int, t0: float) -> None:
            """The health monitor flagged ``suspect``: drain its sole-copy
            data (dirty first) to a target in a *different rack* before the
            failure lands — the predictive trigger the reactive join-time
            re-replication (join_node above) cannot match, because it only
            runs after the data is already gone. The copies ride the
            background lanes; ones still in flight when the failure hits are
            aborted by the _XFER_DONE dead-source guard."""
            nonlocal predictive_rereps, bytes_predictive
            if suspect in self.cluster.failed or suspect >= self.n_nodes:
                return
            target = self._predict_target(suspect)
            if target is None:
                return
            drain_eviction_traffic(t0)
            bulk = self.store.hierarchy.bottom
            for name, src, src_tier, nbytes in \
                    self.store.rereplication_candidates(
                        target,
                        max_bytes=self.config.predict_rereplicate_bytes,
                        only_src=suspect):
                dur = (self.hw.move_seconds(nbytes, src, target)
                       + self.store.hierarchy.media_seconds(nbytes, src_tier)
                       + self.store.hierarchy.media_seconds(nbytes, bulk))
                path = lane_path(src, target, target)
                start = max(nic_bg_free.avail(path), t0)
                nic_bg_free.occupy(path, start + dur)
                note_bytes(path, nbytes)
                predictive_rereps += 1
                bytes_predictive += nbytes
                heapq.heappush(events, (start + dur, next(seq), _XFER_DONE,
                                        (name, src, target, bulk, None)))

        schedule_pass(0.0)
        while events:
            now, _, kind, payload = heapq.heappop(events)
            if kind == _TASK_FINISH:
                tid, gen = payload  # type: ignore[misc]
                if state.get(tid) != "running" or gen != run_gen.get(tid):
                    continue    # cancelled by a failure / stale prior attempt
                node = running_at.pop(tid)
                state[tid] = "done"
                done += 1
                for pname, pdst in self._task_pins.pop(tid, []):
                    self.store.unpin(pname, pdst)
                self.cluster.release(node)
                for out in wf.graph.tasks[tid].outputs:
                    pin = wf.graph.data[out].pinned_loc
                    loc = pin if pin is not None else node
                    mode = (self._write_modes.get(out)
                            if pin is None else None)
                    if mode == "around" and self._write_mode_guard:
                        # auto mode's runtime guard: the analyzer proved the
                        # consumer SHOULD land on the producing node, but if
                        # the scheduler has already bound it elsewhere (a
                        # running attempt or a proactive preassignment), the
                        # prediction is void for this put — fall back to the
                        # normal write path rather than strand the consumer
                        # behind a guaranteed remote read
                        cs = wf.graph.data[out].consumers
                        ctid = cs[0] if len(cs) == 1 else None
                        cnode = running_at.get(ctid) if ctid else None
                        if cnode is None and ctid is not None \
                                and isinstance(sched, ProactiveScheduler):
                            cnode = sched.preassignment.get(ctid)
                        if cnode is not None and cnode != node:
                            mode = None
                    if not self.store.exists(out):
                        self.store.put(out, SimObject(self.wf.sizes[out]),
                                       loc=loc, mode=mode)
                for s in wf.graph.successors(tid):
                    unfinished_preds[s] -= 1
                    if unfinished_preds[s] == 0 and state[s] == "pending":
                        state[s] = "ready"
                        ready.add(s)
                        if use_index and s in cand_set:
                            cand_check(s)   # left "pending": out of the index
                if (self.store.durability == "fsync_on_barrier"
                        and done % self.barrier_every == 0):
                    # workflow sync point: close the durability window. The
                    # fsync transfers ride the demand NIC lane (see
                    # drain_eviction_traffic) — that contention is the cost
                    # this policy pays for bounding the rerun exposure.
                    self.store.barrier()
            elif kind == _XFER_DONE:
                name, src, dst, dst_tier, for_task = payload  # type: ignore[misc]
                if src in self.cluster.failed:
                    # the source died mid-flight: the bytes never finished
                    # crossing — without this guard a transfer could "arrive"
                    # from a dead node and materialize a replica of data that
                    # may no longer exist anywhere
                    prefetch_aborts += 1
                elif self.store.exists(name) and dst not in self.cluster.failed:
                    self.store.replicate(name, [dst], tier=dst_tier)
                    # shield the fresh replica from (coordinated) eviction
                    # until its consumer has run — prefetch work must not be
                    # undone by capacity pressure at comfortable occupancy
                    if state.get(for_task) not in ("done", None):
                        self.store.pin(name, dst)
                        self._task_pins.setdefault(for_task, []).append(
                            (name, dst))
            elif kind == _WB_FLUSH:
                self.store.drain_writebacks(max_entries=1)
            elif kind == _FAIL:
                fail_node(payload, now)  # type: ignore[arg-type]
            elif kind == _JOIN:
                join_node(payload, now)  # type: ignore[arg-type]
            elif kind == _PREDICT:
                predict_node(payload, now)  # type: ignore[arg-type]
            schedule_pass(now)
            if self.sanitize:
                n_events += 1
                if n_events % self.sanitize_every == 0:
                    sanitize_check()
            if done == total and not any(st == "running" for st in state.values()):
                # drain queued failures/transfers without extending makespan
                break
        if self.sanitize:
            sanitize_check()   # final checkpoint at quiescence
        if use_index:
            self.store.loc.unsubscribe(on_store_event)
        self.store.loc.unsubscribe(on_pin_event)

        if done != total:
            missing = [t for t, st in state.items() if st != "done"]
            raise RuntimeError(f"simulation deadlock: {len(missing)} tasks "
                               f"unfinished, e.g. {missing[:5]}")
        self.store.drain_writebacks()   # flush stragglers (already charged)
        rep = self.store.movement_report()
        return SimResult(
            makespan=now,
            bytes_moved=rep["bytes_moved"],
            bytes_prefetched=bytes_prefetched,
            bytes_local=rep["bytes_local"],
            io_wait_total=sum(io_wait.values()),
            io_wait_max=max(io_wait.values(), default=0.0),
            tasks_done=done,
            reruns=reruns,
            task_records=records,
            remote_bytes=rep["remote_bytes"],
            bytes_demoted=rep["bytes_demoted"],
            demotions=int(rep["demotions"]),
            promotions=int(rep["promotions"]),
            writebacks=int(rep["writebacks"]),
            writeback_bytes=rep["writeback_bytes"],
            clean_drops=int(rep["clean_drops"]),
            coord_drops=int(rep["coord_drops"]),
            pin_protected_evictions=int(rep["pin_protected_evictions"]),
            fsyncs=int(rep["fsyncs"]),
            fsync_bytes=rep["fsync_bytes"],
            dirty_lost=dirty_lost,
            phantom_durable=int(rep["phantom_durable"]),
            prefetch_aborts=prefetch_aborts,
            joins=joins_done,
            rereplications=rereplications,
            bytes_rereplicated=bytes_rereplicated,
            cross_spine_bytes=cross_spine_bytes,
            predictive_rereplications=predictive_rereps,
            bytes_predictively_rereplicated=bytes_predictive,
            drop_reports=drop_reports,
            join_reports=join_reports,
            link_bytes=link_bytes,
        )

    def _predict_target(self, suspect: int) -> int | None:
        """Where to drain a suspect node's sole copies: the lowest-id alive
        node in a *different rack* (failure-domain diversity); any other
        alive node when the topology is flat or single-rack."""
        topo = self.config.topology
        best: int | None = None
        best_key: tuple[int, int] | None = None
        for n in self.cluster.alive_nodes():
            if n == suspect:
                continue
            same = 1
            if topo is not None and not topo.flat:
                same = 1 if topo.same_rack(n, suspect) else 0
            key = (same, n)
            if best_key is None or key < best_key:
                best_key, best = key, n
        return best

    @staticmethod
    def _auto_write_modes(wf: CompiledWorkflow, config: SimConfig,
                          scheduler: SchedulerBase) -> dict[str, str]:
        """The analyzer-gated default: honor exactly the write-mode
        pins ``repro_torch.analysis.lint.safe_write_modes`` proves safe, and only
        when the configuration lets write-around pay off — at least one
        finite node tier (otherwise there is no occupancy to save), a
        locality-aware scheduler (the co-scheduling proof assumes one), and
        stable membership (failures/joins void the static prediction).
        Everything else behaves exactly like ``honor_write_modes=False``."""
        if not wf.write_modes or config.failures or config.joins:
            return {}
        if not isinstance(scheduler, LocalityScheduler):
            return {}
        hier = config.hierarchy
        if hier is None or not any(t.capacity_bytes != float("inf")
                                   for t in hier.tiers):
            return {}
        from repro_torch.analysis.lint import safe_write_modes
        return safe_write_modes(wf)

    def _invalidate(self, tid: str, state: dict, unfinished_preds: dict,
                    ready: set, running_at: dict) -> int:
        """Roll a completed task (and stale successors) back to pending/ready.
        Returns how many previously-done tasks were rolled back (the caller
        must subtract from its completion counter)."""
        rolled = 0
        if state[tid] == "running":
            running_at.pop(tid, None)
        if state[tid] == "done":
            rolled = 1
            for s in self.wf.graph.successors(tid):
                unfinished_preds[s] += 1
                if state[s] == "ready":
                    state[s] = "pending"
                    ready.discard(s)
        npred = sum(1 for p in self.wf.graph.predecessors(tid)
                    if state[p] != "done")
        unfinished_preds[tid] = npred
        if npred == 0:
            state[tid] = "ready"
            ready.add(tid)
        else:
            state[tid] = "pending"
        return rolled


def simulate(wf: CompiledWorkflow,
             scheduler_factory: Callable[[CompiledWorkflow], SchedulerBase],
             *, config: SimConfig | None = None, **kw) -> SimResult:
    """One-call helper: build scheduler, run, return the result.

    ``config=SimConfig(...)`` is the documented spelling; the legacy flat
    keywords are still accepted (but not both at once)."""
    return WorkflowSimulator(wf, scheduler_factory(wf), config=config,
                             **kw).run()
