"""Runtime invariant sanitizer.

The hot paths run on event-driven incremental caches — the
scheduler's placement mirror and move-cost term cache, the simulator's
pending-candidate index, the cluster's free/alive views, the store's
per-(node,tier) usage and pin refcounts — that are only *test-pinned* equal
to from-scratch rebuilds. A drift introduced by any later change would silently
corrupt scheduling decisions long before an equivalence test notices. This
module cross-checks every incremental structure against a from-scratch
rebuild of the same fact, raising a structured :class:`SanitizerError` that
names the first divergent entry.

Opt-in (the rebuilds are O(cluster) per checkpoint): set ``sanitize=True`` on
:class:`~repro_torch.core.config.SimConfig` / ``ServingConfig``, or export
``REPRO_SANITIZE=1``.
Checkpoint frequency for the simulator is ``SimConfig.sanitize_every`` (every
N-th event) — the invariants hold at *every* event boundary, the knob only
trades coverage for speed.

Like the linter, this module never imports the simulator or the serving
stack; callers hand their structures in. Checks degrade to no-ops when the
structure they audit is absent (e.g. a scheduler with no attached store has
no mirror to drift).
"""

from __future__ import annotations

import math
import os
from collections import Counter
from typing import Any, Iterable, Mapping

from repro_torch.core.locstore import REMOTE_TIER, LocStore

__all__ = ["SanitizerError", "env_enabled", "check_placement_mirror",
           "check_membership", "check_tier_usage", "check_pin_conservation",
           "check_candidate_index", "check_ledger", "check_term_cache",
           "check_proactive", "check_engine", "check_router",
           "check_link_rows", "check_link_paths"]


class SanitizerError(AssertionError):
    """An incremental structure diverged from its from-scratch rebuild.

    Carries the failing ``check``, the first divergent ``key`` (entries are
    visited in sorted order, so the report is deterministic), and the
    ``expected`` (rebuilt) vs ``actual`` (incremental) values."""

    def __init__(self, check: str, key: Any, expected: Any, actual: Any):
        self.check = check
        self.key = key
        self.expected = expected
        self.actual = actual
        super().__init__(
            f"sanitizer[{check}] divergent entry {key!r}: "
            f"rebuild says {expected!r}, incremental state says {actual!r}")


def env_enabled() -> bool:
    """``REPRO_SANITIZE`` truthiness — the process-wide opt-in used when a
    config object leaves ``sanitize`` unset."""
    return os.environ.get("REPRO_SANITIZE", "").strip().lower() \
        not in ("", "0", "false", "no", "off")


def _fail(check: str, key: Any, expected: Any, actual: Any) -> None:
    raise SanitizerError(check, key, expected, actual)


def _close(a: float, b: float) -> bool:
    # float counters accumulate chronologically; rebuilds sum in ledger
    # order — allow for the differing association, nothing more
    return math.isclose(a, b, rel_tol=1e-6, abs_tol=1e-6)


# ------------------------------------------------------------------- storage
def check_membership(store: LocStore, cluster: Any = None) -> None:
    """``alive + failed == range(n_nodes)`` — in the store AND (when given)
    the SimCluster, including their materialized sorted caches."""
    alive = list(store._alive)
    failed = set(store._failed_nodes)
    if alive != sorted(alive):
        _fail("membership", "store._alive", sorted(alive), alive)
    if set(alive) & failed:
        _fail("membership", "alive∩failed", set(),
              sorted(set(alive) & failed))
    want = set(range(store.n_nodes))
    got = set(alive) | failed
    if got != want:
        missing = sorted(want - got) + sorted(got - want)
        _fail("membership", f"node{missing[0]}",
              "alive + failed == range(n_nodes)",
              f"n_nodes={store.n_nodes} alive={alive} failed={sorted(failed)}")
    if cluster is None:
        return
    if cluster.n_nodes != store.n_nodes:
        _fail("membership", "cluster.n_nodes", store.n_nodes,
              cluster.n_nodes)
    if set(cluster.failed) != failed:
        diff = sorted(set(cluster.failed) ^ failed)
        _fail("membership", f"node{diff[0]}",
              f"store failed {sorted(failed)}",
              f"cluster failed {sorted(cluster.failed)}")
    free_cache = getattr(cluster, "_free_cache", None)
    if free_cache is not None:
        want_free = sorted(cluster.free - cluster.failed)
        if free_cache != want_free:
            _fail("membership", "cluster._free_cache", want_free, free_cache)
    alive_cache = getattr(cluster, "_alive_cache", None)
    if alive_cache is not None:
        want_alive = [n for n in range(cluster.n_nodes)
                      if n not in cluster.failed]
        if alive_cache != want_alive:
            _fail("membership", "cluster._alive_cache", want_alive,
                  alive_cache)


def check_tier_usage(store: LocStore) -> None:
    """Per-(node, tier) byte usage vs a rebuild from the residency map —
    the O(1) ``tier_used`` fast path must agree with what is actually
    resident (``_drop_replica`` clamps at zero, so a leak shows up here as
    incremental > rebuilt)."""
    want: dict[tuple[int, str], float] = {}
    for name, res in store._residency.items():
        size = store._sizes.get(name, 0.0)
        for node, tier in res.items():
            if node == REMOTE_TIER:     # PFS copies are not tier-accounted
                continue
            key = (node, tier)
            want[key] = want.get(key, 0.0) + size
    for key in sorted(set(want) | set(store._usage)):
        w = want.get(key, 0.0)
        g = store._usage.get(key, 0.0)
        if abs(w - g) > max(1.0, 1e-9 * max(w, g)):
            _fail("tier-usage", key, w, g)


def check_pin_conservation(store: LocStore,
                           task_pins: Mapping[str, Iterable[tuple[str, int]]],
                           ) -> None:
    """Every positive pin refcount in the store is owed to exactly that many
    live prefetch holds in the simulator's ``_task_pins`` (and vice versa).
    A leak here means evict-protection outlives the task that asked for it —
    or a stale unpin released somebody else's pin."""
    got = Counter({k: v for k, v in store._pins.items() if v > 0})
    want: Counter = Counter()
    for pins in task_pins.values():
        want.update(tuple(p) for p in pins)
    if got != want:
        diffs = sorted(set(got) | set(want),
                       key=lambda k: (k[0], k[1]))
        for key in diffs:
            if got.get(key, 0) != want.get(key, 0):
                _fail("pin-conservation", key, want.get(key, 0),
                      got.get(key, 0))


def check_ledger(store: LocStore) -> None:
    """Scalar movement counters vs a full recomputation from the Transfer
    ledger (runnable at every checkpoint). Mirrors
    ``tests/test_sim_accounting.recompute_from_transfers`` exactly."""
    spill_kinds = ("demote", "spill", "writeback", "writearound")
    fetches = [t for t in store.transfers if t.kind == "fetch"]
    migrates = [t for t in store.transfers if t.kind == "migrate"]
    # every PFS-bound write (spills AND durability fsyncs) lands in
    # bytes_moved/remote_bytes via _record_pfs_write
    spills = [t for t in store.transfers
              if t.kind in spill_kinds + ("fsync",) and t.dst == REMOTE_TIER]
    demotes = [t for t in store.transfers if t.kind == "demote"]
    writebacks = [t for t in store.transfers if t.kind == "writeback"]
    fsyncs = [t for t in store.transfers if t.kind == "fsync"]
    want: dict[str, float] = {
        "bytes_local": sum(t.nbytes for t in fetches if t.local),
        "bytes_moved": (sum(t.nbytes for t in fetches if not t.local)
                        + sum(t.nbytes for t in migrates)
                        + sum(t.nbytes for t in spills)),
        "remote_bytes": (sum(t.nbytes for t in fetches if not t.local
                             and (t.src == REMOTE_TIER
                                  or t.dst == REMOTE_TIER))
                         + sum(t.nbytes for t in migrates
                               if t.src == REMOTE_TIER
                               or t.dst == REMOTE_TIER)
                         + sum(t.nbytes for t in spills)),
        "bytes_demoted": (sum(t.nbytes for t in demotes)
                          + sum(t.nbytes for t in writebacks)),
        "writeback_bytes": sum(t.nbytes for t in writebacks),
        "fsync_bytes": sum(t.nbytes for t in fsyncs),
    }
    rep = store.movement_report()
    for key in sorted(want):
        if not _close(rep[key], want[key]):
            _fail("ledger", key, want[key], rep[key])
    for key, value in (("demotions", len(demotes) + len(writebacks)),
                       ("writebacks", len(writebacks)),
                       ("fsyncs", len(fsyncs))):
        if int(rep[key]) != value:
            _fail("ledger", key, value, int(rep[key]))
    tier_reads: dict[str, float] = {}
    for t in fetches:
        tier_reads[t.src_tier] = tier_reads.get(t.src_tier, 0.0) + t.nbytes
    for tier in sorted(set(tier_reads) | set(store.tier_reads)):
        if not _close(tier_reads.get(tier, 0.0),
                      store.tier_reads.get(tier, 0.0)):
            _fail("ledger", f"tier_reads[{tier}]",
                  tier_reads.get(tier, 0.0), store.tier_reads.get(tier, 0.0))


# ----------------------------------------------------------------- scheduler
def check_placement_mirror(sched: Any, store: LocStore) -> None:
    """Scheduler's event-maintained placement mirror vs
    ``LocationService.lookup`` for every known dataset, both directions."""
    if not getattr(sched, "_indexed", False) or sched._store is None:
        return
    mirror = sched._placements
    truth_names = store.loc.names()
    for name in sorted(truth_names):
        truth = store.loc.lookup(name)
        got = mirror.get(name)
        want_key = (truth.nodes, truth.tier, truth.tiers)
        got_key = None if got is None else (got.nodes, got.tier, got.tiers)
        if got_key != want_key:
            _fail("placement-mirror", name, want_key, got_key)
    for name in sorted(set(mirror) - set(truth_names)):
        _fail("placement-mirror", name, None,
              (mirror[name].nodes, mirror[name].tier, mirror[name].tiers))


def check_term_cache(sched: Any, cluster: Any) -> None:
    """Every cached move-cost term vs the exact arithmetic ``move_seconds``
    would run today. Terms are only cached for *placed* inputs, so the
    comparison is == (identical code path), not approx."""
    if not getattr(sched, "_indexed", False) or sched._store is None:
        return
    dst_tier = getattr(cluster, "top_tier", lambda: "hbm")()
    for name in sorted(sched._term_cache):
        p = sched._placements.get(name)
        if p is None:
            _fail("term-cache", name, "no cached terms for unplaced input",
                  sorted(sched._term_cache[name]))
        size = sched.wf.sizes.get(name, 0.0)
        for node in sorted(sched._term_cache[name]):
            if p.resident_on(node):
                want = sched._tier_seconds(cluster, p.tier_on(node), size)
            else:
                src = p.real_loc
                want = sched._one_term(cluster, size,
                                       cluster.link_gbps(src, node),
                                       p.tier_on(src), dst_tier)
            got = sched._term_cache[name][node]
            if got != want:
                _fail("term-cache", (name, node), want, got)


def check_link_rows(cluster: Any) -> None:
    """Every cached link-bandwidth row (and its uniform-collapse marker) vs
    a from-scratch rebuild through ``hw.link_gbps`` — with a topology
    attached the rows carry real path bandwidths, and the elastic-growth
    in-place row extension (SimCluster.join) is exactly the kind of
    incremental update that can drift. The divergent key is ``(src, dst)``
    (or ``(src, "uniform")`` for the collapse marker)."""
    rows = getattr(cluster, "_link_rows", None)
    if not rows:
        return
    hw = cluster.hw
    for src in sorted(rows):
        row, uniform = rows[src]
        if len(row) != cluster.n_nodes:
            _fail("link-row", (src, "len"), cluster.n_nodes, len(row))
        for dst in range(cluster.n_nodes):
            want = hw.link_gbps(src, dst)
            if row[dst] != want:
                _fail("link-row", (src, dst), want, row[dst])
        vals = set(row[:src] + row[src + 1:]
                   if 0 <= src < cluster.n_nodes else row)
        want_uniform = vals.pop() if len(vals) == 1 else None
        if uniform != want_uniform:
            _fail("link-row", (src, "uniform"), want_uniform, uniform)


def check_link_paths(path_cache: Mapping | None, topo: Any) -> None:
    """Every memoized (src, dst) -> lane-key path vs a fresh
    ``topo.links()`` walk of the link graph — the path table feeds the
    per-link lane charging, so a stale entry would mischarge contention.
    No-op without a real topology (flat runs never populate the cache)."""
    if topo is None:
        if path_cache:
            _fail("link-path", sorted(path_cache)[0],
                  "empty path cache without a topology",
                  path_cache[sorted(path_cache)[0]])
        return
    for key in sorted(path_cache or {}):
        want = topo.links(*key)
        got = path_cache[key]
        if got != want:
            _fail("link-path", key, want, got)


def check_proactive(sched: Any, cluster: Any) -> None:
    """ProactiveScheduler extras: no preassignment to a dead/unknown node,
    the per-task placed-input counter vs a recount over the mirror, and no
    prefetch marker for a dataset the store no longer knows. Prefetch
    markers on nodes the dataset has not REACHED yet are legal (the marker
    is set when the transfer is emitted, not when it lands)."""
    preassignment = getattr(sched, "preassignment", None)
    if preassignment is None:
        return
    for tid in sorted(preassignment):
        node = preassignment[tid]
        if node in cluster.failed or not 0 <= node < cluster.n_nodes:
            _fail("proactive", tid, "preassignment to a live node",
                  f"node {node} (failed={node in cluster.failed})")
    if not getattr(sched, "_indexed", False) or sched._store is None:
        return
    mirror = sched._placements
    for tid in sorted(sched.wf.graph.tasks):
        t = sched.wf.graph.tasks[tid]
        want = sum(1 for n in t.inputs if n in mirror)
        got = sched._avail.get(tid, 0)
        if got != want:
            _fail("proactive", f"_avail[{tid}]", want, got)
    for name in sorted(sched._prefetched):
        if sched._prefetched[name] and name not in mirror:
            _fail("proactive", f"_prefetched[{name}]",
                  "markers only for datasets in the mirror",
                  sorted(sched._prefetched[name]))


# ----------------------------------------------------------------- simulator
def check_candidate_index(*, state: Mapping[str, str],
                          avail_count: Mapping[str, int],
                          cand_list: list, cand_set: set,
                          exists_mirror: set, order: Mapping[str, int],
                          store: LocStore, graph: Any) -> None:
    """The simulator's pending-candidate index vs a full rescan:
    the existence mirror, the per-task materialized-input counters, and the
    sorted candidate list/set must all match what the store actually holds."""
    truth = set(store.loc.names())
    for name in sorted(truth ^ exists_mirror):
        _fail("candidate-index", f"exists[{name}]",
              name in truth, name in exists_mirror)
    want_avail = {tid: sum(1 for n in t.inputs if n in truth)
                  for tid, t in graph.tasks.items()}
    for tid in sorted(want_avail):
        got = avail_count.get(tid, 0)
        if got != want_avail[tid]:
            _fail("candidate-index", f"avail[{tid}]", want_avail[tid], got)
    want_set = {tid for tid in graph.tasks
                if state.get(tid) == "pending" and want_avail[tid] > 0}
    for tid in sorted(want_set ^ cand_set):
        _fail("candidate-index", f"candidate[{tid}]",
              tid in want_set, tid in cand_set)
    want_list = sorted((order[tid], tid) for tid in want_set)
    if cand_list != want_list:
        i = next(i for i, (a, b) in enumerate(
            zip(cand_list + [None], want_list + [None])) if a != b)
        _fail("candidate-index", f"cand_list[{i}]",
              want_list[i] if i < len(want_list) else None,
              cand_list[i] if i < len(cand_list) else None)


# ------------------------------------------------------------------- serving
def check_engine(engine: Any) -> None:
    """Slot bookkeeping: ``_slotted`` is exactly the slot-holding sessions,
    used and free slots partition ``range(max_batch)``, and every slotted
    session still has its KV placeholder in the store."""
    want_slotted = {sid: s for sid, s in engine.sessions.items()
                    if s.slot is not None}
    for sid in sorted(set(want_slotted) ^ set(engine._slotted)):
        _fail("engine-slots", f"session{sid}",
              sid in want_slotted, sid in engine._slotted)
    used = [s.slot for s in engine._slotted.values()]
    free = list(engine._free_slots)
    if len(set(used)) != len(used):
        dup = sorted(s for s in used if used.count(s) > 1)
        _fail("engine-slots", f"slot{dup[0]}", "one session per slot",
              f"{used.count(dup[0])} sessions share it")
    overlap = set(used) & set(free)
    if overlap:
        _fail("engine-slots", f"slot{sorted(overlap)[0]}",
              "slot is used xor free", "both used and free")
    want_all = set(range(engine.max_batch))
    got_all = set(used) | set(free)
    if got_all != want_all or len(free) != len(set(free)):
        _fail("engine-slots", "partition", sorted(want_all),
              f"used={sorted(used)} free={sorted(free)}")
    if engine.store is not None:
        from repro_torch.serve.engine import _cache_name
        for sid in sorted(engine._slotted):
            if not engine.store.exists(_cache_name(sid)):
                _fail("engine-slots", f"kv[{sid}]",
                      "placeholder replica for every slotted session",
                      "missing from store")


def check_router(router: Any) -> None:
    """Failover bookkeeping: a deferred (unhomed) session must not
    simultaneously be registered live on a surviving engine."""
    for sid in sorted(getattr(router, "_unhomed", {})):
        for node in sorted(router.engines):
            if sid in router.engines[node].sessions:
                _fail("router", f"session{sid}",
                      "unhomed sessions live nowhere",
                      f"registered on engine at node {node}")
    for node in sorted(router.engines):
        check_engine(router.engines[node])
