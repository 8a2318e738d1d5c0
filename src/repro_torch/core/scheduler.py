"""Workflow schedulers — the paper's runtime layer (§B, third component).

Three schedulers, in the order the paper presents them:

* :class:`FCFSScheduler` — the baseline: "the scheduler in most cases works in
  a first-come-first-serve way". Ignores locality entirely.
* :class:`LocalityScheduler` — the paper's heuristic: each READY task gets a
  priority = (a) length of the longest path from it to the final task (upward
  rank, from the compiler) and is then bound to the available worker with the
  lowest data-movement cost for its inputs.
* :class:`ProactiveScheduler` — the paper's second algorithm: NON-ready tasks
  (even with only part of their inputs materialized) are *pre-assigned* using
  estimated movement costs, and prefetch requests are emitted so the store can
  pipeline inputs to the target node while predecessors still run.

Schedulers are pure decision engines over an abstract :class:`ClusterView`, so
the same code drives both the discrete-event simulator (1000+ nodes) and the
real executor.

**Indexed decision path.** The paper's cross-layer argument only holds if the
scheduler itself stays off the data path at 1000+-node scale — per-decision
cost must be microseconds, not milliseconds. ``attach_store(store)`` wires the
scheduler to the store's metadata-change events
(:meth:`~repro_torch.core.locstore.LocationService.subscribe`) and switches the
decision loop to incremental, event-invalidated structures that are
**decision-identical** to the rescanning path:

* a **placement mirror** (dataset -> Placement) maintained from
  record/drop events, so candidate generation and cost scoring stop paying a
  hash + shard lock per ``locate()`` per input per candidate;
* a **per-(input, node) move-cost term cache**: ``move_seconds`` sums cached
  per-input terms and recomputes only the terms whose dataset's placement
  changed since the last decision;
* a **ready-queue priority heap** updated by deltas (task became ready,
  at-risk bytes of an input changed) instead of re-sorting the whole ready
  set every scheduling tick. Queue keys are unique (FIFO arrival breaks
  ties), so heap order is exactly the full-sort order.

``attach_store(store, indexed=False)`` keeps the event wiring (which also
drives the pre-assignment/prefetch-marker invalidation bugfixes) but decides
via the original full-rescan path — the reference the equivalence tests
compare against. Event callbacks run on the mutating thread and only touch
plain dicts/sets (atomic under the GIL); decisions themselves are
single-threaded in both the simulator and the executor's scheduling loop.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import TYPE_CHECKING, Iterable, Iterator, Protocol, Sequence

from repro_torch.core.locstore import Placement, REMOTE_TIER
from repro_torch.core.wfcompiler import CompiledWorkflow

if TYPE_CHECKING:                      # pragma: no cover - typing only
    from repro_torch.core.locstore import LocStore

__all__ = ["ClusterView", "Assignment", "PrefetchRequest", "SchedulerBase",
           "FCFSScheduler", "LocalityScheduler", "ProactiveScheduler"]


class ClusterView(Protocol):
    """What a scheduler may observe about the cluster ("dynamic available
    workers and the data movement cost", per the paper)."""

    def free_workers(self) -> Sequence[int]: ...
    def locate(self, data_name: str) -> Placement | None: ...
    def link_gbps(self, src: int, dst: int) -> float: ...
    def is_durable(self, data_name: str) -> bool:
        """True when the PFS holds the current version of ``data_name`` (it
        would survive any node failure). Views may omit this — risk-aware
        priority then treats everything as durable (no reordering)."""
        ...
    def worker_speed(self, node: int) -> float:
        """Relative throughput (1.0 = nominal). Stragglers report < 1."""
        ...
    def tier_gbps(self, tier: str) -> float:
        """Sustained media bandwidth of a storage tier (inf = free). Views
        without a storage hierarchy may omit this — costs fall back to the
        flat link-only model."""
        ...
    def top_tier(self) -> str:
        """Name of the fastest node-local tier (where fetches land). Views
        may omit this; the cost model assumes "hbm"."""
        ...
    def bulk_tier(self) -> str:
        """Name of the slowest (largest) node-local tier — where bulk
        prefetches stage. Views may omit this; tier pinning assumes "bb"
        (a hierarchy without one normalizes it to its top tier)."""
        ...
    def alive_nodes(self) -> Sequence[int]:
        """Every non-failed node, free or busy. Views may omit this —
        proactive pre-placement then skips ticks with no free worker
        instead of guessing a node."""
        ...
    def link_row(self, src: int) -> "tuple[Sequence[float], float | None] | None":
        """``(row, uniform)`` where ``row[dst] == link_gbps(src, dst)`` for
        every node, and ``uniform`` is the single off-diagonal bandwidth when
        the row has one (None for non-uniform rows). Views may omit this (or
        return None) — batched scoring then calls ``link_gbps`` per node.
        Under a topology-backed view the row carries real path bandwidths
        (rack-local > cross-spine), which is how candidate scoring prefers
        rack-local replicas with no scheduler-side topology code."""
        ...
    def node_queue_seconds(self, node: int) -> float:
        """Seconds of already-queued demand traffic behind ``node``'s NIC
        and its rack uplink — lets placement route around saturated links.
        Views may omit this (or return 0.0, as every flat view does): the
        penalty is only added when positive, so flat decisions are
        unchanged."""
        ...


@dataclasses.dataclass(frozen=True)
class Assignment:
    tid: str
    node: int
    rank: float
    move_seconds: float


@dataclasses.dataclass(frozen=True)
class PrefetchRequest:
    """"Tell the file system to start pipelining the data to the target
    server" — one input dataset to stage onto ``dst``, into ``tier`` (device
    prefetch = promote to "hbm"; a flat store clamps to its top tier)."""

    data_name: str
    dst: int
    for_task: str
    est_bytes: float
    tier: str = "hbm"


class SchedulerBase:
    def __init__(self, wf: CompiledWorkflow) -> None:
        self.wf = wf
        self._arrival: dict[str, int] = {}
        self._counter = 0
        # -- indexed decision path (attach_store) -----------------------------
        self._store: "LocStore | None" = None
        self._indexed = False
        # event-maintained mirror of LocationService.lookup — kept whenever a
        # store is attached (cheap; the bugfix invalidations diff it), but
        # consulted by _locate only when indexed
        self._placements: dict[str, Placement] = {}
        # per-(input dataset, node) move-cost terms, invalidated whole-dataset
        # on any record/drop event for that dataset
        self._term_cache: dict[str, dict[int, float]] = {}

    # -- store wiring ---------------------------------------------------------
    def attach_store(self, store: "LocStore", *, indexed: bool = True) -> None:
        """Subscribe to ``store``'s metadata-change events.

        ``indexed=True`` (default) switches decisions to the incremental
        indexed structures; ``indexed=False`` keeps the original full-rescan
        decision path but still wires the events (pre-assignment and
        prefetch-marker invalidation depend on them) — the reference mode the
        equivalence tests compare against.
        """
        if self._store is not None:
            self._store.loc.unsubscribe(self._on_store_event)
        self._store = store
        self._indexed = indexed
        self._placements = {}
        self._term_cache = {}
        self._reset_index()
        store.loc.subscribe(self._on_store_event)
        for name in store.loc.names():     # snapshot pre-attach placements
            p = store.loc.lookup(name)
            if p is not None:
                # replay as a record event so every subclass index (mirror,
                # availability counts, risk keys) initializes uniformly
                self._on_store_event("record", name, p)

    def detach_store(self) -> None:
        if self._store is not None:
            self._store.loc.unsubscribe(self._on_store_event)
        self._store = None
        self._indexed = False
        self._placements = {}
        self._term_cache = {}
        self._reset_index()

    def _reset_index(self) -> None:
        """Subclass hook: clear decision-path indexes on (re-)attach."""

    def _on_store_event(self, event: str, key, placement) -> None:
        if event == "record":
            self._placements[key] = placement
            self._term_cache.pop(key, None)
        elif event == "drop":
            self._placements.pop(key, None)
            self._term_cache.pop(key, None)

    def _locate(self, cluster: ClusterView, name: str) -> Placement | None:
        """``cluster.locate`` via the event-maintained mirror when indexed —
        the mirror holds the exact Placement objects the LocationService
        would return, so the two paths are decision-identical."""
        if self._indexed and self._store is not None:
            return self._placements.get(name)
        return cluster.locate(name)

    # -- bookkeeping ---------------------------------------------------------
    def note_ready(self, tid: str) -> None:
        """Record FIFO arrival order (what FCFS schedules by)."""
        if tid not in self._arrival:
            self._arrival[tid] = self._counter
            self._counter += 1

    # -- costs ----------------------------------------------------------------
    @staticmethod
    def _tier_seconds(cluster: ClusterView, tier: str | None,
                      size: float) -> float:
        """Media time of reading ``size`` bytes out of ``tier`` — 0 when the
        cluster view exposes no storage hierarchy (flat two-tier model)."""
        if tier is None:
            return 0.0
        fn = getattr(cluster, "tier_gbps", None)
        if fn is None:
            return 0.0
        bw = fn(tier)
        return 0.0 if bw == float("inf") else size / bw

    def move_seconds(self, tid: str, node: int, cluster: ClusterView,
                     *, assume: dict[str, int] | None = None) -> float:
        """Data-movement cost of running ``tid`` on ``node`` (paper's second
        scoring term), tier-aware: a replica on ``node`` but parked in a slow
        tier (burst buffer) still costs its media read time, and a remote
        fetch pays the source tier's media time on top of the link. Missing
        inputs fall back to ``assume`` (estimated producer locations) or the
        remote tier — "estimated and not accurate".

        The cost is a sum of independent per-(input, node) terms; when a
        store is attached (indexed mode) each term is cached and only
        recomputed after a store event touched that input's placement.
        ``assume``-derived terms depend on the caller's estimate, not the
        store, and are never cached.
        """
        # fetched data lands in the destination's top tier; mirror the store's
        # Transfer.est_seconds (src read + link + dst write) so the estimate
        # matches what the simulator charges
        dst_tier = getattr(cluster, "top_tier", lambda: "hbm")()
        cache = (self._term_cache
                 if self._indexed and self._store is not None else None)
        total = 0.0
        for name in self.wf.graph.tasks[tid].inputs:
            if cache is not None:
                terms = cache.get(name)
                if terms is not None:
                    cached = terms.get(node)
                    if cached is not None:
                        total += cached
                        continue
            p = self._locate(cluster, name)
            size = self.wf.sizes.get(name, 0.0)
            if p is not None and p.resident_on(node):
                term = self._tier_seconds(cluster, p.tier_on(node), size)
            else:
                src_tier: str | None = None
                if p is not None:
                    src = p.real_loc
                    src_tier = p.tier_on(src)
                elif assume and name in assume:
                    if assume[name] == node:
                        continue
                    src = assume[name]
                else:
                    src = REMOTE_TIER
                    src_tier = "remote"
                term = self._one_term(cluster, size,
                                      cluster.link_gbps(src, node),
                                      src_tier, dst_tier)
                if p is None:
                    # unplaced input: the term depends on the CALLER's
                    # ``assume`` estimate (or its absence), which the cache
                    # key cannot see — a REMOTE-fallback term cached here
                    # would be served to a later call whose assume covers the
                    # dataset. Never cache; a record event re-enables caching.
                    total += term
                    continue
            if cache is not None:
                cache.setdefault(name, {})[node] = term
            total += term
        return total

    @staticmethod
    def _one_term(cluster: ClusterView, size: float, bw: float,
                  src_tier: str | None, dst_tier: str | None) -> float:
        """One input's fetch term — the exact arithmetic (same operation
        order) ``move_seconds`` uses, shared so batched scoring is bitwise
        identical to the per-node path."""
        term = 0.0
        if bw != float("inf"):
            term += size / bw
        term += SchedulerBase._tier_seconds(cluster, src_tier, size)
        term += SchedulerBase._tier_seconds(cluster, dst_tier, size)
        return term

    def _score_nodes(self, tid: str, nodes: Sequence[int],
                     cluster: ClusterView,
                     assume: dict[str, int] | None = None) -> list[float]:
        """``[move_seconds(tid, n, cluster, assume=assume) for n in nodes]``,
        computed input-major so shared per-input work (locate, source tier,
        the remote fetch term) is hoisted out of the per-node loop.

        Bitwise-identical to the per-node path: per node, terms accumulate in
        the same input order with the same grouping, and a remote term is
        reused across nodes only when their link bandwidths are EQUAL (same
        operands -> same float). With a uniform link row (``link_row``) the
        whole remote column collapses to one C-level list add, which is what
        makes scoring ~250 candidates x 256 inputs per decision affordable.
        """
        dst_tier = getattr(cluster, "top_tier", lambda: "hbm")()
        totals = [0.0] * len(nodes)
        idx = {node: i for i, node in enumerate(nodes)}
        row_fn = getattr(cluster, "link_row", None)
        for name in self.wf.graph.tasks[tid].inputs:
            p = self._locate(cluster, name)
            size = self.wf.sizes.get(name, 0.0)
            # exceptions: candidate indices whose term is NOT the shared
            # remote fetch term (resident replicas; the assume==node skip)
            exc: dict[int, float | None] = {}
            src_tier: str | None = None
            if p is not None:
                src = p.real_loc
                src_tier = p.tier_on(src)
                for rn in p.nodes:
                    i = idx.get(rn)
                    if i is not None:
                        exc[i] = self._tier_seconds(cluster, p.tier_on(rn),
                                                    size)
            elif assume and name in assume:
                src = assume[name]
                i = idx.get(src)
                if i is not None:
                    exc[i] = None          # runs where the input appears: 0
            else:
                src = REMOTE_TIER
                src_tier = "remote"
            rowinfo = row_fn(src) if row_fn is not None else None
            uniform = rowinfo[1] if rowinfo is not None else None
            if uniform is not None:
                rt = self._one_term(cluster, size, uniform, src_tier,
                                    dst_tier)
                if exc:
                    fix = [(i, totals[i]) for i in exc]
                    totals = [t + rt for t in totals]
                    for i, prev in fix:
                        lt = exc[i]
                        totals[i] = prev if lt is None else prev + lt
                else:
                    totals = [t + rt for t in totals]
                continue
            row = rowinfo[0] if rowinfo is not None else None
            rt_by_bw: dict[float, float] = {}
            for i, node in enumerate(nodes):
                if i in exc:
                    lt = exc[i]
                    if lt is not None:
                        totals[i] += lt
                    continue
                bw = row[node] if row is not None else cluster.link_gbps(
                    src, node)
                r = rt_by_bw.get(bw)
                if r is None:
                    r = self._one_term(cluster, size, bw, src_tier, dst_tier)
                    rt_by_bw[bw] = r
                totals[i] += r
        return totals

    # -- interface -------------------------------------------------------------
    def select(self, ready: Sequence[str], cluster: ClusterView) -> list[Assignment]:
        raise NotImplementedError


class FCFSScheduler(SchedulerBase):
    """Paper baseline: first-come-first-serve onto the next available worker.

    Workers are taken round-robin, which is how a locality-oblivious load
    balancer (Swift/T's ADLB) spreads tasks; picking lowest-id-free instead
    would hand FCFS accidental locality that the real system does not have.
    The rotor strides over the tick's *stable* free-worker ordering —
    indexing a list that shrinks as the loop assigns (the old code) made the
    effective stride drift within a multi-assignment tick and biased
    placement toward low node ids.
    """

    def __init__(self, wf: CompiledWorkflow) -> None:
        super().__init__(wf)
        self._rr = 0

    def select(self, ready: Sequence[str], cluster: ClusterView) -> list[Assignment]:
        for tid in ready:
            self.note_ready(tid)
        free = sorted(cluster.free_workers())
        if not free:
            return []
        queue = sorted(ready, key=lambda t: self._arrival[t])
        out: list[Assignment] = []
        n = len(free)
        for i, tid in enumerate(queue[:n]):
            # consecutive rotor positions over the tick-stable list: ≤ n
            # assignments hit n distinct nodes, with a uniform stride of 1
            node = free[(self._rr + i) % n]
            out.append(Assignment(tid, node, self.wf.upward_rank[tid],
                                  self.move_seconds(tid, node, cluster)))
        self._rr += len(out)
        return out


class LocalityScheduler(SchedulerBase):
    """Paper heuristic: upward-rank priority, then min-movement worker.

    ``speed_aware`` additionally penalizes stragglers by the estimated compute
    time on that worker (beyond-paper; off by default to keep the faithful
    reproduction exact).
    """

    def __init__(self, wf: CompiledWorkflow, *, speed_aware: bool = False,
                 max_candidates: int = 32, risk_aware: bool = False) -> None:
        super().__init__(wf)
        self.speed_aware = speed_aware
        # [beyond-paper] durability as a scheduling signal: among equal-rank
        # ready tasks, run the ones whose inputs are a sole, non-durable copy
        # first — consuming at-risk data is the scheduler's contribution to
        # shrinking the durability window the storage layer leaves open (a
        # node failure before the consumer runs re-runs the producer; after,
        # only the consumer's own output is exposed).
        self.risk_aware = risk_aware
        # [beyond-paper] 1000+-node scalability: evaluating the movement cost
        # on EVERY free worker is O(N) per task. Instead score the free
        # workers that HOLD an input (locality candidates, the only nodes
        # where the cost can be zero) plus a strided sample of the rest
        # (power-of-k-choices for load). Decision cost becomes O(k).
        self.max_candidates = max_candidates
        # ready-queue priority heap (indexed mode): entries (key, seq, tid),
        # one live seq per tid; stale entries are skipped lazily at pop.
        # Queue keys end in the unique FIFO arrival counter, so pop order ==
        # full-sort order and the heap is decision-identical to sorted().
        self._heap: list[tuple[tuple, int, str]] = []
        self._heap_seq: dict[str, int] = {}
        self._heap_counter = 0
        # tids whose queue key may have changed (a store event touched one of
        # their inputs — only at-risk bytes can move; rank and arrival are
        # static). Their heap entries are re-keyed at the next select().
        self._key_dirty: set[str] = set()

    def _reset_index(self) -> None:
        self._heap = []
        self._heap_seq = {}
        self._key_dirty = set()

    def _on_store_event(self, event: str, key, placement) -> None:
        if self.risk_aware and event in ("record", "drop"):
            d = self.wf.graph.data.get(key)
            if d is not None:
                self._key_dirty.update(d.consumers)
        super()._on_store_event(event, key, placement)

    def _candidates(self, tid: str, free: list[int],
                    cluster: ClusterView) -> list[int]:
        if len(free) <= self.max_candidates:
            return free
        free_set = set(free)
        cands: dict[int, None] = {}
        for name in self.wf.graph.tasks[tid].inputs:
            p = self._locate(cluster, name)
            if p is not None:
                for n in p.nodes:
                    if n in free_set:
                        cands[n] = None
        stride = max(len(free) // self.max_candidates, 1)
        for n in free[::stride]:
            cands[n] = None
            if len(cands) >= self.max_candidates:
                break
        return list(cands)

    def _at_risk_bytes(self, tid: str, cluster: ClusterView) -> float:
        """Bytes of ``tid``'s inputs living as a sole node-local, non-durable
        copy — one node failure re-runs their producers (0.0 when the view
        exposes no durability signal)."""
        fn = getattr(cluster, "is_durable", None)
        if fn is None:
            return 0.0
        total = 0.0
        for name in self.wf.graph.tasks[tid].inputs:
            p = self._locate(cluster, name)
            if p is None:
                continue
            nodes = [n for n in p.nodes if n != REMOTE_TIER]
            if len(nodes) == 1 and len(p.nodes) == 1 and not fn(name):
                total += self.wf.sizes.get(name, 0.0)
        return total

    def _queue_key(self, tid: str, cluster: ClusterView) -> tuple:
        """Ready-queue priority: critical path first, then (risk-aware only)
        most at-risk bytes, then FIFO arrival."""
        risk = self._at_risk_bytes(tid, cluster) if self.risk_aware else 0.0
        return (-self.wf.upward_rank[tid], -risk, self._arrival[tid])

    def _ordered_ready(self, ready: Sequence[str],
                       cluster: ClusterView) -> Iterator[str]:
        """Ready tasks in queue-priority order.

        Indexed mode maintains the order in a persistent heap updated by
        deltas: only newly-ready tasks and tasks whose key a store event
        dirtied are (re-)pushed; everything else keeps its entry across
        ticks. Popped-but-unassigned tasks (the caller ran out of workers)
        simply lose their entry and are re-pushed at the next call.
        """
        if not (self._indexed and self._store is not None):
            yield from sorted(ready, key=lambda t: self._queue_key(t, cluster))
            return
        for tid in ready:
            if tid not in self._heap_seq or tid in self._key_dirty:
                self._heap_counter += 1
                self._heap_seq[tid] = self._heap_counter
                heapq.heappush(self._heap, (self._queue_key(tid, cluster),
                                            self._heap_counter, tid))
        self._key_dirty.clear()
        ready_set = set(ready)
        heap = self._heap
        while heap:
            _key, seq, tid = heap[0]
            if self._heap_seq.get(tid) != seq:
                heapq.heappop(heap)        # superseded by a re-keyed entry
                continue
            heapq.heappop(heap)
            del self._heap_seq[tid]
            if tid not in ready_set:
                continue                   # left the ready set since pushed
            yield tid

    def _pick_node(self, tid: str, free: list[int], cluster: ClusterView,
                   assume: dict[str, int] | None = None) -> tuple[int, float]:
        free = self._candidates(tid, free, cluster)
        costs = self._score_nodes(tid, free, cluster, assume)
        best, best_cost = free[0], float("inf")
        est = self.wf.est_seconds[tid] if self.speed_aware else 0.0
        qfn = getattr(cluster, "node_queue_seconds", None)
        for node, c in zip(free, costs):
            if self.speed_aware:
                c += est / max(cluster.worker_speed(node), 1e-6)
            if qfn is not None:
                # route around saturated links: a candidate behind a backed-up
                # NIC/uplink pays its queue delay. Flat views report 0.0 or
                # None — a Protocol subclass inherits the stub body — (the
                # guard skips the add), so flat decisions are bit-identical.
                q = qfn(node) or 0.0
                if q > 0.0:
                    c += q
            if c < best_cost:
                best, best_cost = node, c
        return best, best_cost

    def select(self, ready: Sequence[str], cluster: ClusterView) -> list[Assignment]:
        for tid in ready:
            self.note_ready(tid)
        free = list(cluster.free_workers())
        # highest upward rank first — critical path tasks must not wait
        out: list[Assignment] = []
        for tid in self._ordered_ready(ready, cluster):
            if not free:
                break
            node, cost = self._pick_node(tid, free, cluster)
            free.remove(node)
            out.append(Assignment(tid, node, self.wf.upward_rank[tid], cost))
        return out


class ProactiveScheduler(LocalityScheduler):
    """Locality scheduling + the paper's proactive pre-scheduling.

    ``preplace`` may be called at any scheduling tick with the set of tasks
    that are NOT ready but have >= ``min_inputs_ready`` materialized inputs.
    It (1) picks a tentative node per task using *estimated* movement costs
    (unknown inputs assumed to appear where their producer runs), (2) records
    the pre-assignment, and (3) returns the prefetch requests for every
    already-materialized input that is not resident on the target — each
    pinned to a storage tier chosen from the compiler's ``est_stage_seconds``
    (hot inputs -> the top tier, bulk -> the burst buffer; see ``_pin_tier``).

    ``select`` then honours pre-assignments when the node is still free —
    by construction its inputs are (being) pipelined there.

    With an attached store, the per-(dataset, node) prefetch markers and the
    pre-assignments are *invalidated by store events*: a prefetched replica
    that is later evicted or demoted off its target node (or lost with the
    node) becomes re-prefetchable, and pre-assignments pointing at a failed
    node are purged instead of emitting prefetches toward a dead NIC.
    """

    def __init__(self, wf: CompiledWorkflow, *, speed_aware: bool = False,
                 min_inputs_ready: int = 1, horizon: int = 64,
                 prefetch_tier: str = "auto",
                 bulk_stage_ratio: float = 1.0,
                 risk_aware: bool = False) -> None:
        super().__init__(wf, speed_aware=speed_aware, risk_aware=risk_aware)
        self.min_inputs_ready = min_inputs_ready
        self.horizon = horizon
        # "auto" = tier pinning from the compiler's est_stage_seconds (hot
        # inputs -> the top tier, bulk -> the burst buffer); a tier name pins
        # every prefetch to that tier (the behaviour before tier pinning).
        self.prefetch_tier = prefetch_tier
        self.bulk_stage_ratio = bulk_stage_ratio
        self.preassignment: dict[str, int] = {}
        # dataset -> nodes a prefetch was already emitted toward (pruned by
        # store events; without the pruning a once-prefetched-then-evicted
        # replica could never be prefetched again)
        self._prefetched: dict[str, set[int]] = {}
        # indexed mode: task -> number of its inputs currently materialized
        # (the min_inputs_ready gate without rescanning), and preassigned
        # task -> inputs whose prefetch should be emitted at the next
        # preplace tick. Both are event-maintained; the reference path
        # derives the same facts by rescanning every tick.
        self._avail: dict[str, int] = {}
        self._eligible: dict[str, set[str]] = {}

    def _reset_index(self) -> None:
        super()._reset_index()
        self._avail = {}
        self._eligible = {}

    def _on_store_event(self, event: str, key, placement) -> None:
        if event == "record":
            prev = self._placements.get(key) if self._store is not None else None
            if prev is not None:
                gone = set(prev.nodes) - set(placement.nodes)
                if gone:
                    fetched = self._prefetched.get(key)
                    if fetched:    # replica left those nodes: re-prefetchable
                        fetched -= gone
            elif self._indexed:    # dataset newly materialized
                d = self.wf.graph.data.get(key)
                if d is not None:
                    for c in d.consumers:
                        self._avail[c] = self._avail.get(c, 0) + 1
        elif event == "drop":
            self._prefetched.pop(key, None)
            if self._indexed and key in self._placements:
                d = self.wf.graph.data.get(key)
                if d is not None:
                    for c in d.consumers:
                        self._avail[c] = self._avail.get(c, 1) - 1
        elif event == "drop_node":
            for fetched in self._prefetched.values():
                fetched.discard(key)
            for tid in [t for t, n in self.preassignment.items() if n == key]:
                del self.preassignment[tid]
                self._eligible.pop(tid, None)
        elif event == "join_node":
            # deliberate no-op: a joining node holds no data, so no
            # placement mirror / prefetch marker / preassignment refers to
            # it (drop_node purged them at failure time). Its eligibility
            # as a preplace target flows from the cluster views the caller
            # passes per tick — nothing here to index.
            pass
        super()._on_store_event(event, key, placement)
        if self._indexed and event in ("record", "drop"):
            self._refresh_eligible(key)

    def _refresh_eligible(self, key: str) -> None:
        """Re-derive, for every preassigned consumer of ``key``, whether its
        prefetch should be (re-)emitted — after ``key``'s placement or
        prefetch markers changed. Mirrors the reference path's per-tick
        check: materialized, not resident on the target, marker clear."""
        d = self.wf.graph.data.get(key)
        if d is None:
            return
        p = self._placements.get(key)
        fetched = self._prefetched.get(key, ())
        for tid in d.consumers:
            elig = self._eligible.get(tid)
            if elig is None:
                continue
            node = self.preassignment.get(tid)
            if (node is not None and p is not None
                    and not p.resident_on(node) and node not in fetched):
                elig.add(key)
            else:
                elig.discard(key)

    def _mark_emitted(self, name: str, node: int) -> None:
        """A prefetch of ``name`` toward ``node`` was just emitted: every
        consumer preassigned to that node loses its pending emission."""
        d = self.wf.graph.data.get(name)
        if d is None:
            return
        for c in d.consumers:
            if self.preassignment.get(c) == node:
                e = self._eligible.get(c)
                if e is not None:
                    e.discard(name)

    def _pin_tier(self, name: str, tid: str, cluster: ClusterView) -> str:
        """The storage tier a prefetch of ``name`` for ``tid`` should land in.

        Feeds the compiler's stage estimates back into placement: an input
        whose PFS stage-in time is hideable within its consumer's compute
        time is *hot* — pin it to the fastest tier so the task reads it at
        HBM speed. An input whose staging dominates the consumer (bulk) would
        squat scarce fast memory for longer than it helps — stage it into the
        burst buffer instead (a flat store normalizes that to its only tier).
        """
        if self.prefetch_tier != "auto":
            return self.prefetch_tier
        top = getattr(cluster, "top_tier", lambda: "hbm")()
        stage = self.wf.stage_seconds.get(name)
        if stage is None:
            # internal dataset: produced on a node, cheap to pin fast
            return top
        # per-dataset: THIS input's staging time vs its consumer's compute
        # (a task with nine hot inputs and one bulk one pins nine fast)
        compute = self.wf.est_seconds.get(tid, 0.0)
        if stage > self.bulk_stage_ratio * compute:
            return getattr(cluster, "bulk_tier", lambda: "bb")()
        return top

    # -- proactive pass --------------------------------------------------------
    def preplace(self, candidates: Iterable[str], cluster: ClusterView,
                 running_at: dict[str, int] | None = None) -> list[PrefetchRequest]:
        running_at = running_at or {}
        indexed = self._indexed and self._store is not None
        # estimated location of not-yet-materialized data = where its producer
        # runs (or is pre-assigned) — the paper's "estimated and not accurate".
        # Built lazily: only a NEW pre-assignment needs it, and the snapshot at
        # first use equals the snapshot at entry (pre-assignments added later
        # this tick were never visible to the eager build either).
        assume: dict[str, int] | None = None

        workers = list(cluster.free_workers())
        if not workers:
            # every worker is busy: pre-assign onto any *alive* node (the old
            # `or [0]` fallback pre-assigned node 0 even when node 0 was the
            # failed one, emitting prefetches toward a dead NIC). With no
            # alive-node signal, skip picking NEW pre-assignments this tick —
            # already pre-assigned tasks still pipeline their inputs below.
            alive = getattr(cluster, "alive_nodes", None)
            nodes = alive() if alive is not None else None
            workers = list(nodes) if nodes is not None else []
        reqs: list[PrefetchRequest] = []
        ranked = sorted(candidates, key=lambda t: -self.wf.upward_rank[t])
        for tid in ranked[: self.horizon]:
            t = self.wf.graph.tasks[tid]
            if indexed:
                if self._avail.get(tid, 0) < self.min_inputs_ready:
                    continue
            else:
                ready_inputs = [n for n in t.inputs
                                if self._locate(cluster, n) is not None]
                if len(ready_inputs) < self.min_inputs_ready:
                    continue
            node = self.preassignment.get(tid)
            if node is None:
                if not workers:
                    continue
                if assume is None:
                    assume = {}
                    for atid, anode in {**self.preassignment,
                                        **running_at}.items():
                        for out in self.wf.graph.tasks[atid].outputs:
                            assume[out] = anode
                node, _ = self._pick_node(tid, workers, cluster, assume=assume)
                self.preassignment[tid] = node
            if indexed:
                elig = self._eligible.get(tid)
                if elig is None:
                    # first tick with this pre-assignment (or a manually poked
                    # one): derive the pending-emission set once; events keep
                    # it current from here on
                    elig = set()
                    for name in t.inputs:
                        p = self._placements.get(name)
                        if (p is not None and not p.resident_on(node)
                                and node not in self._prefetched.get(name, ())):
                            elig.add(name)
                    self._eligible[tid] = elig
                if elig:
                    # iterate t.inputs, not elig, to preserve the reference
                    # path's emission order (inputs order, filtered)
                    for name in t.inputs:
                        if name in elig:
                            self._prefetched.setdefault(name, set()).add(node)
                            reqs.append(PrefetchRequest(
                                data_name=name, dst=node, for_task=tid,
                                est_bytes=self.wf.sizes.get(name, 0.0),
                                tier=self._pin_tier(name, tid, cluster)))
                            self._mark_emitted(name, node)
                continue
            for name in ready_inputs:
                p = self._locate(cluster, name)
                if p is not None and not p.resident_on(node):
                    fetched = self._prefetched.setdefault(name, set())
                    if node not in fetched:
                        fetched.add(node)
                        reqs.append(PrefetchRequest(
                            data_name=name, dst=node, for_task=tid,
                            est_bytes=self.wf.sizes.get(name, 0.0),
                            tier=self._pin_tier(name, tid, cluster)))
        return reqs

    # -- ready-task pass --------------------------------------------------------
    def select(self, ready: Sequence[str], cluster: ClusterView) -> list[Assignment]:
        for tid in ready:
            self.note_ready(tid)
        free = list(cluster.free_workers())
        free_set = set(free)
        out: list[Assignment] = []
        for tid in self._ordered_ready(ready, cluster):
            if not free:
                break
            pre = self.preassignment.get(tid)
            if pre is not None and pre in free_set:
                node, cost = pre, self.move_seconds(tid, pre, cluster)
            else:
                node, cost = self._pick_node(tid, free, cluster)
            free.remove(node)
            free_set.discard(node)
            self.preassignment.pop(tid, None)
            self._eligible.pop(tid, None)
            out.append(Assignment(tid, node, self.wf.upward_rank[tid], cost))
        return out
