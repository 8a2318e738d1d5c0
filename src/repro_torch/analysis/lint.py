"""Workflow/config linter — the "prove it before running" half of the paper's
compiler/runtime co-design.

The compiler already sees the whole workflow (sizes, producers, consumers,
predicted placement); this module turns that visibility into pre-execution
proofs: races and broken happens-before edges, producerless inputs, dead
datasets, capacity infeasibility, durability hazards, unsafe ``mode="around"``
write pins, and cluster-config mistakes (zero-bandwidth links, zero-capacity
tiers, gapped membership schedules).

Usage::

    from repro_torch.analysis import lint
    findings = lint.lint(wf, config=SimConfig(...), name="montage")
    for f in findings:
        print(f)

Every rule is registered in :data:`RULES` with an id and a default severity.
Findings can be *suppressed* with a reasoned allow-list entry (an entry
without a reason is refused)::

    [{"rule": "dead-dataset", "target": "random_layered:d*",
      "reason": "random fan-in leaves unsampled layer outputs by design"}]

``target`` patterns are ``fnmatch``-style over ``"<workflow>:<target>"``; the
``reason`` field is mandatory — a suppression nobody can explain is a bug
magnet. ``python -m repro_torch.analysis`` lints the built-in workloads and exits
non-zero on any unsuppressed WARNING-or-worse finding (the CI gate).

This module deliberately never imports the simulator or the serving stack —
the runtime imports *us* (``safe_write_modes`` gates the simulator's
``honor_write_modes="auto"`` default), so the dependency must stay one-way.
"""

from __future__ import annotations

import dataclasses
import enum
import fnmatch
import json
import os
from typing import Callable, Iterable, Iterator

from repro_torch.core.config import SimConfig
from repro_torch.core.dag import CycleError, TaskGraph
from repro_torch.core.wfcompiler import CompiledWorkflow

__all__ = ["Severity", "Finding", "Rule", "RULES", "lint", "lint_graph",
           "safe_write_modes", "load_allowlist", "apply_allowlist",
           "default_allowlist_path"]


class Severity(enum.IntEnum):
    """Ordered so gates can compare: ``f.severity >= Severity.WARNING``."""

    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self) -> str:  # "WARNING", not "Severity.WARNING"
        return self.name


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint result: which rule fired, on what, and why."""

    rule: str
    severity: Severity
    workflow: str
    target: str            # dataset / task / config element the rule fired on
    message: str
    suppressed: bool = False
    reason: str | None = None     # the allow-list entry's reason, if suppressed

    def __str__(self) -> str:
        sup = f" (suppressed: {self.reason})" if self.suppressed else ""
        return (f"[{self.rule}] {self.severity} {self.workflow}:{self.target}"
                f" — {self.message}{sup}")


@dataclasses.dataclass
class LintContext:
    """What a rule function gets to look at. ``wf``/``config`` are optional —
    structural rules work on a bare :class:`TaskGraph`; cost/placement rules
    return nothing when the context they need is missing."""

    graph: TaskGraph
    wf: CompiledWorkflow | None
    config: SimConfig | None
    name: str
    # per-run rule knobs (e.g. "oversub-factor"); rules read with .get()
    params: dict = dataclasses.field(default_factory=dict)
    _rule: "Rule | None" = None

    def finding(self, target: str, message: str,
                severity: Severity | None = None) -> Finding:
        assert self._rule is not None
        return Finding(rule=self._rule.id,
                       severity=self._rule.severity if severity is None
                       else severity,
                       workflow=self.name, target=target, message=message)

    def sizes(self) -> dict[str, float]:
        """Best-known dataset sizes: the compiler's propagated table when
        compiled, else whatever ``@size`` hints the graph carries."""
        if self.wf is not None:
            return self.wf.sizes
        return {d.name: float(d.size_bytes)
                for d in self.graph.data.values() if d.size_bytes is not None}


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    severity: Severity
    summary: str
    fn: Callable[[LintContext], Iterator[Finding]]


RULES: dict[str, Rule] = {}


def _rule(rid: str, severity: Severity, summary: str):
    def deco(fn: Callable[[LintContext], Iterator[Finding]]):
        RULES[rid] = Rule(rid, severity, summary, fn)
        return fn
    return deco


# --------------------------------------------------------------- structural
@_rule("waw-race", Severity.ERROR,
       "cycles, self-reads, duplicate writers, broken happens-before edges")
def _waw_race(ctx: LintContext) -> Iterator[Finding]:
    g = ctx.graph
    # self-referential tasks first: the most precise diagnosis of the
    # smallest cycle (a task that reads its own output races with itself)
    for tid, t in g.tasks.items():
        overlap = sorted(set(t.inputs) & set(t.outputs))
        if overlap:
            yield ctx.finding(tid, f"task reads its own output(s) "
                                   f"{overlap}: write-after-read on the same "
                                   f"dataset can never be ordered")
    # general cycles: run Kahn ourselves so we can NAME the stuck tasks
    # (topo_order raises without saying which). Edges naming phantom tasks —
    # the broken-edge findings below — are skipped so they cannot crash or
    # masquerade as cycles here.
    indeg = {tid: sum(1 for p in g.predecessors(tid) if p in g.tasks)
             for tid in g.tasks}
    queue = sorted(tid for tid, d in indeg.items() if d == 0)
    seen = 0
    while queue:
        tid = queue.pop()
        seen += 1
        for s in g.successors(tid):
            if s not in indeg:
                continue
            indeg[s] -= 1
            if indeg[s] == 0:
                queue.append(s)
    if seen != len(g.tasks):
        stuck = sorted(tid for tid, d in indeg.items() if d > 0)
        yield ctx.finding(stuck[0],
                          f"workflow graph contains a cycle through "
                          f"{len(stuck)} task(s): {stuck[:5]}")
    # duplicate writers / broken producer edges. TaskGraph.add_task rejects a
    # second producer, but a hand-mutated DataSpec (or a graph assembled from
    # parts) can still disagree — and a scheduler trusting d.producer would
    # then order a WAW race wrong.
    for tid, t in g.tasks.items():
        for out in t.outputs:
            d = g.data.get(out)
            if d is None:
                yield ctx.finding(out, f"task {tid!r} writes dataset "
                                       f"{out!r} that was never declared")
            elif d.producer != tid:
                yield ctx.finding(out,
                                  f"WAW race: dataset produced by both "
                                  f"{d.producer!r} and {tid!r} — no "
                                  f"happens-before edge orders the writes")
    for d in g.data.values():
        if d.producer is not None:
            p = g.tasks.get(d.producer)
            if p is None or d.name not in p.outputs:
                yield ctx.finding(d.name,
                                  f"missing happens-before edge: recorded "
                                  f"producer {d.producer!r} does not declare "
                                  f"{d.name!r} as an output")
        for c in d.consumers:
            t = g.tasks.get(c)
            if t is None or d.name not in t.inputs:
                yield ctx.finding(d.name,
                                  f"missing happens-before edge: consumer "
                                  f"{c!r} recorded on {d.name!r} does not "
                                  f"list it as an input")
    for tid, t in g.tasks.items():
        for name in t.inputs:
            d = g.data.get(name)
            if d is not None and tid not in d.consumers:
                yield ctx.finding(name,
                                  f"missing happens-before edge: task "
                                  f"{tid!r} reads {name!r} but is absent "
                                  f"from its consumer list — schedulers "
                                  f"walking consumers will miss the "
                                  f"dependency")


@_rule("missing-producer", Severity.WARNING,
       "consumed datasets with no producer and no @size hint")
def _missing_producer(ctx: LintContext) -> Iterator[Finding]:
    for d in ctx.graph.data.values():
        if d.is_external and d.consumers and d.size_bytes is None:
            yield ctx.finding(d.name,
                              f"consumed by {sorted(set(d.consumers))[:3]} "
                              f"but has no producer task and no @size hint "
                              f"— a missing producer or an empty external "
                              f"source (the compiler will guess 1 MiB)")


@_rule("dead-dataset", Severity.WARNING,
       "produced datasets nobody consumes and nobody marked as a sink")
def _dead_dataset(ctx: LintContext) -> Iterator[Finding]:
    for d in ctx.graph.data.values():
        if not d.is_external and not d.consumers and not d.xattr.get("sink"):
            yield ctx.finding(d.name,
                              f"produced by {d.producer!r} but never "
                              f"consumed and not marked as a workflow sink "
                              f"(graph.mark_sink) — wasted compute and tier "
                              f"occupancy")


# ------------------------------------------------------------- cost/capacity
def _finite_node_capacity(config: SimConfig | None) -> float | None:
    """Total per-node tier capacity when EVERY node tier is finite, else None
    (an unbounded tier means capacity can never be infeasible)."""
    if config is None or config.hierarchy is None:
        return None
    caps = [t.capacity_bytes for t in config.hierarchy.tiers]
    if not caps or any(c == float("inf") for c in caps):
        return None
    return float(sum(caps))


@_rule("capacity-infeasible", Severity.WARNING,
       "working sets that cannot fit the configured tier capacities")
def _capacity_infeasible(ctx: LintContext) -> Iterator[Finding]:
    wf, config = ctx.wf, ctx.config
    node_cap = _finite_node_capacity(config)
    if wf is None or node_cap is None:
        return
    gib = float(1 << 30)
    # per-task: a task whose inputs+outputs exceed one node's total finite
    # capacity is guaranteed to spill mid-task, whatever the scheduler does
    worst: list[tuple[float, str]] = []
    for tid in wf.topo:
        ws = wf.input_bytes(tid) + wf.output_bytes(tid)
        if ws > node_cap:
            worst.append((ws, tid))
    worst.sort(reverse=True)
    for ws, tid in worst[:5]:
        yield ctx.finding(tid,
                          f"working set {ws / gib:.2f} GiB exceeds one "
                          f"node's total tier capacity "
                          f"{node_cap / gib:.2f} GiB — forced PFS spill on "
                          f"every run")
    if len(worst) > 5:
        yield ctx.finding("…", f"{len(worst) - 5} more task(s) exceed the "
                               f"per-node capacity (showing the worst 5)")
    # cluster-level: sweep the compiled schedule (earliest_start + est
    # durations, unlimited workers) and find the peak bytes of live
    # intermediates; above the cluster's total finite capacity the store
    # MUST demote to the PFS no matter how placement shuffles replicas.
    assert config is not None
    finish = {tid: wf.earliest_start[tid] + wf.est_seconds[tid]
              for tid in wf.topo}
    events: list[tuple[float, float]] = []   # (time, +/- bytes)
    for d in wf.graph.data.values():
        if d.is_external or d.producer not in finish:
            continue
        born = finish[d.producer]
        ends = [finish[c] for c in d.consumers if c in finish]
        died = max(ends) if ends else max(finish.values())
        if died <= born:
            continue
        size = wf.sizes.get(d.name, 0.0)
        events.append((born, size))
        events.append((died, -size))
    live = peak = 0.0
    for _, delta in sorted(events):
        live += delta
        peak = max(peak, live)
    cluster_cap = node_cap * max(config.n_nodes, 1)
    if peak > cluster_cap:
        yield ctx.finding("cluster",
                          f"peak live intermediate bytes "
                          f"{peak / gib:.2f} GiB exceed the cluster's total "
                          f"tier capacity {cluster_cap / gib:.2f} GiB "
                          f"({config.n_nodes} nodes × "
                          f"{node_cap / gib:.2f} GiB) — capacity-pressure "
                          f"demotions to the PFS are unavoidable")


@_rule("durability-hazard", Severity.WARNING,
       "sole-copy intermediates exposed to injected failures")
def _durability_hazard(ctx: LintContext) -> Iterator[Finding]:
    wf, config = ctx.wf, ctx.config
    if wf is None or config is None or not config.failures:
        return
    if config.durability != "none":
        return
    at_risk = [d.name for d in wf.graph.data.values()
               if not d.is_external and d.consumers
               and wf.write_modes.get(d.name) != "around"]
    if not at_risk:
        return
    first_fail = min(t for t, _ in config.failures)
    yield ctx.finding("config",
                      f"durability='none' with {len(config.failures)} "
                      f"injected failure(s) (first at t={first_fail:g}s): "
                      f"{len(at_risk)} intermediate dataset(s) are "
                      f"sole-copy and non-durable — losing their node "
                      f"re-runs the producers (durability="
                      f"'fsync_on_barrier' bounds the exposure)")


# --------------------------------------------------------------- write modes
def _around_unsafe_reason(graph: TaskGraph, sizes: dict[str, float],
                          name: str) -> str | None:
    """None when honoring ``mode="around"`` for ``name`` is provably safe
    (the single consumer is predicted to be co-scheduled with the producer at
    put time — the LocalityScheduler binds a task to the node holding the
    strict majority of its input bytes); else a human-readable reason."""
    d = graph.data.get(name)
    if d is None:
        return "dataset not in the graph"
    if d.is_external:
        return "external datasets have no producing task to co-schedule with"
    if d.pinned_loc is not None:
        return ("an explicit placement pin overrides the write mode "
                "(the runtime ignores modes on pinned datasets)")
    if len(d.consumers) != 1:
        return (f"{len(d.consumers)} consumers — write-around keeps the only "
                f"copy on the PFS, so every non-co-scheduled reader pays a "
                f"remote fetch")
    consumer = graph.tasks.get(d.consumers[0])
    if consumer is None:
        return f"consumer {d.consumers[0]!r} is not a task in the graph"
    total = sum(sizes.get(n, 0.0) for n in consumer.inputs)
    from_producer = sum(sizes.get(n, 0.0) for n in consumer.inputs
                        if graph.data[n].producer == d.producer)
    if not (total > 0 and from_producer * 2 > total):
        return (f"producer {d.producer!r} supplies "
                f"{from_producer / total if total else 0.0:.0%} of consumer "
                f"{d.consumers[0]!r}'s input bytes — no strict majority, so "
                f"the consumer is not predicted to land on the producing "
                f"node at put time")
    return None


def safe_write_modes(wf: CompiledWorkflow) -> dict[str, str]:
    """The subset of ``wf.write_modes`` whose ``"around"`` pins the linter
    can prove safe to honor (consumer co-scheduled with producer at put
    time). This is the gate behind the simulator's
    ``honor_write_modes="auto"`` default — re-proving the compiler's pass-5
    condition here means a hand-edited or stale ``write_modes`` dict cannot
    smuggle an unsafe pin past the runtime."""
    out: dict[str, str] = {}
    for name, mode in wf.write_modes.items():
        if mode != "around":
            out[name] = mode
        elif _around_unsafe_reason(wf.graph, wf.sizes, name) is None:
            out[name] = mode
    return out


@_rule("unsafe-write-around", Severity.WARNING,
       "mode='around' pins whose consumer is not provably co-scheduled")
def _unsafe_write_around(ctx: LintContext) -> Iterator[Finding]:
    sizes = ctx.sizes()
    marked = {d.name for d in ctx.graph.data.values()
              if d.xattr.get("write_mode") == "around"}
    if ctx.wf is not None:
        marked.update(n for n, m in ctx.wf.write_modes.items()
                      if m == "around")
    for name in sorted(marked):
        reason = _around_unsafe_reason(ctx.graph, sizes, name)
        if reason is not None:
            yield ctx.finding(name, f"unsafe write-around pin: {reason}")


# ------------------------------------------------------------ cluster config
@_rule("unreachable-node", Severity.ERROR,
       "zero-bandwidth links or dead-weight nodes in the cluster config")
def _unreachable_node(ctx: LintContext) -> Iterator[Finding]:
    config = ctx.config
    if config is None:
        return
    hw, n = config.hw, config.n_nodes
    pods = (n + hw.nodes_per_pod - 1) // hw.nodes_per_pod if n else 0
    if n > 1 and hw.nodes_per_pod > 1 and hw.ici_gbps <= 0:
        yield ctx.finding("hw.ici_gbps",
                          "intra-pod link bandwidth is 0 — nodes in the same "
                          "pod cannot exchange data (and a fetch divides by "
                          "this bandwidth at runtime)")
    if pods > 1 and hw.dcn_gbps <= 0:
        yield ctx.finding("hw.dcn_gbps",
                          f"cross-pod bandwidth is 0 with {pods} pods — "
                          f"cross-pod placements are unreachable")
    has_external = any(d.is_external for d in ctx.graph.data.values())
    if hw.remote_tier_gbps <= 0 and has_external \
            and config.external_loc == "remote":
        yield ctx.finding("hw.remote_tier_gbps",
                          "remote/PFS bandwidth is 0 but external inputs "
                          "start on the remote tier — they can never be "
                          "staged in")
    for node, speed in sorted((config.speeds or {}).items()):
        if not 0 <= node < n:
            yield ctx.finding(f"node{node}",
                              f"speed override for node {node} is outside "
                              f"the cluster (n_nodes={n}) and silently "
                              f"ignored", severity=Severity.WARNING)
        elif speed <= 0:
            yield ctx.finding(f"node{node}",
                              f"node {node} has speed {speed:g} — any task "
                              f"placed there effectively never finishes",
                              severity=Severity.WARNING)
    # link-graph reachability: with an explicit topology a node is
    # unreachable when its NIC, its rack's uplink, or the PFS attachment it
    # depends on has zero bandwidth (link_gbps divides by these at runtime)
    topo = getattr(config, "topology", None)
    if topo is None:
        return
    if topo.n_nodes != n:
        yield ctx.finding("topology.n_nodes",
                          f"topology describes {topo.n_nodes} node(s) but "
                          f"the config runs {n} — the simulator refuses the "
                          f"mismatch")
    remote_externals = has_external and config.external_loc == "remote"
    for node in range(min(topo.n_nodes, n)):
        if topo.nic(node) <= 0:
            yield ctx.finding(f"node{node}",
                              f"node {node}'s NIC bandwidth is 0 — no path "
                              f"to any peer or to the PFS")
    for r in range(topo.n_racks):
        if topo.up(r) <= 0 and (topo.n_racks > 1 or remote_externals):
            yield ctx.finding(f"rack{r}",
                              f"rack {r}'s ToR uplink bandwidth is 0 — its "
                              f"nodes cannot reach other racks or the PFS")
    if topo.pfs_gbps <= 0 and remote_externals:
        yield ctx.finding("topology.pfs_gbps",
                          "PFS attachment bandwidth is 0 but external "
                          "inputs start on the remote tier — they can "
                          "never be staged in")


@_rule("oversubscribed-link", Severity.WARNING,
       "compiled transfer demand exceeding a shared link's capacity budget")
def _oversubscribed_link(ctx: LintContext) -> Iterator[Finding]:
    """Budget the compiled external stage-in plan against the shared links.

    Over the schedule's critical-path window, every byte staged in from the
    remote tier crosses the PFS attachment once and a ToR uplink once; when
    that demand exceeds ``capacity * critical_seconds * factor`` the link is
    the bottleneck no matter how the scheduler places tasks. ``factor``
    (default 1.0) comes from ``lint(..., params={"oversub-factor": ...})`` —
    raise it to only flag gross oversubscription."""
    wf, config = ctx.wf, ctx.config
    if wf is None or config is None:
        return
    topo = getattr(config, "topology", None)
    if topo is None or topo.flat:
        return
    crit = max((wf.earliest_start[t] + wf.est_seconds[t] for t in wf.topo),
               default=0.0)
    if crit <= 0.0:
        return
    ext_bytes = sum(wf.sizes.get(d.name, 0.0)
                    for d in ctx.graph.data.values() if d.is_external)
    if ext_bytes <= 0.0:
        return
    factor = float(ctx.params.get("oversub-factor", 1.0))
    gib = float(1 << 30)
    if config.external_loc == "remote" and topo.pfs_gbps > 0:
        budget = topo.pfs_gbps * crit * factor
        if ext_bytes > budget:
            yield ctx.finding(
                "pfs",
                f"remote stage-in plan moves {ext_bytes / gib:.2f} GiB "
                f"through the PFS link but its budget over the "
                f"{crit:.1f}s critical path is {budget / gib:.2f} GiB "
                f"(factor {factor:g}) — stage-in serializes behind the "
                f"PFS attachment")
    per_rack = ext_bytes / max(topo.n_racks, 1)
    for r in range(topo.n_racks):
        cap = topo.up_capacity_gbps[r]
        if cap <= 0 or cap == float("inf"):
            continue
        budget = cap * crit * factor
        if per_rack > budget:
            yield ctx.finding(
                f"rack{r}",
                f"stage-in plan pushes ~{per_rack / gib:.2f} GiB through "
                f"rack {r}'s uplink but its budget over the {crit:.1f}s "
                f"critical path is {budget / gib:.2f} GiB (capacity "
                f"{cap / 1e9:.2f} GB/s, factor {factor:g}) — the "
                f"oversubscribed uplink is the bottleneck")


@_rule("zero-capacity-tier", Severity.ERROR,
       "tiers that can hold nothing or have zero media bandwidth")
def _zero_capacity_tier(ctx: LintContext) -> Iterator[Finding]:
    config = ctx.config
    if config is None or config.hierarchy is None:
        return
    hier = config.hierarchy
    for spec in list(hier.tiers) + [hier.remote]:
        if spec.capacity_bytes <= 0:
            yield ctx.finding(spec.name,
                              f"tier {spec.name!r} has capacity "
                              f"{spec.capacity_bytes:g} bytes — nothing can "
                              f"be admitted; every put cascades straight "
                              f"past it")
        if spec.gbps <= 0:
            yield ctx.finding(spec.name,
                              f"tier {spec.name!r} has media bandwidth "
                              f"{spec.gbps:g} B/s — media_seconds divides "
                              f"by it at runtime")


@_rule("gapped-membership", Severity.WARNING,
       "join schedules that skip node ids, failures of never-members")
def _gapped_membership(ctx: LintContext) -> Iterator[Finding]:
    config = ctx.config
    if config is None:
        return
    cur_max = config.n_nodes
    for t, node in sorted(config.joins):
        if node > cur_max:
            yield ctx.finding(f"node{node}",
                              f"join of node {node} at t={t:g}s skips ids "
                              f"{cur_max}..{node - 1} — gapped growth marks "
                              f"the skipped ids failed (alive + failed must "
                              f"partition range(n_nodes)); renumber unless "
                              f"intentional")
        cur_max = max(cur_max, node + 1)
    for t, node in sorted(config.failures):
        admitted = node < config.n_nodes or any(
            tj <= t and nj >= node for tj, nj in config.joins)
        if not admitted:
            yield ctx.finding(f"node{node}",
                              f"failure of node {node} at t={t:g}s names a "
                              f"node never admitted to the cluster "
                              f"(n_nodes={config.n_nodes}, no earlier join "
                              f"covers it)", severity=Severity.ERROR)


# -------------------------------------------------------------- entry point
def lint(wf: CompiledWorkflow | TaskGraph, *,
         config: SimConfig | None = None, name: str = "workflow",
         rules: Iterable[str] | None = None,
         allowlist: "list[dict] | None" = None,
         params: dict | None = None) -> list[Finding]:
    """Run every registered rule (or the ``rules`` subset) over a workflow.

    ``wf`` may be a bare :class:`TaskGraph` (structural rules only) or a
    :class:`CompiledWorkflow` (adds the size/placement/cost rules).
    ``config`` unlocks the cluster/capacity/durability rules. Findings
    matching ``allowlist`` entries come back with ``suppressed=True``.
    ``params`` carries per-run rule knobs (e.g. ``{"oversub-factor": 2.0}``
    for the ``oversubscribed-link`` budget)."""
    if isinstance(wf, TaskGraph):
        graph, compiled = wf, None
    else:
        graph, compiled = wf.graph, wf
    ctx = LintContext(graph=graph, wf=compiled, config=config, name=name,
                      params=dict(params or {}))
    findings: list[Finding] = []
    for rid in (rules if rules is not None else RULES):
        r = RULES[rid]
        ctx._rule = r
        findings.extend(r.fn(ctx))
    order = {rid: i for i, rid in enumerate(RULES)}
    findings.sort(key=lambda f: (-int(f.severity), order.get(f.rule, 99),
                                 f.target))
    if allowlist:
        findings = apply_allowlist(findings, allowlist)
    return findings


def lint_graph(graph: TaskGraph, **kw) -> list[Finding]:
    """Structural lint of an uncompiled graph (alias of :func:`lint`)."""
    return lint(graph, **kw)


# -------------------------------------------------------------- suppressions
def default_allowlist_path() -> str:
    """``analysis_allowlist.json`` at the repo root (three levels above this
    package), where the benchmarks' trend allow-list convention lives too."""
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(os.path.dirname(os.path.dirname(here)))
    return os.path.join(root, "analysis_allowlist.json")


def load_allowlist(path: str | None = None) -> list[dict]:
    """Reasoned suppressions: ``[{"rule", "target", "reason"}, ...]``.
    ``target`` is an fnmatch pattern over ``"<workflow>:<target>"``. A
    missing file is an empty list; an entry without a non-empty ``reason``
    is a :class:`ValueError` (same contract as the trend allow-list)."""
    path = path or default_allowlist_path()
    if not os.path.exists(path):
        return []
    with open(path) as f:
        entries = json.load(f)
    for e in entries:
        if not e.get("reason", "").strip():
            raise ValueError(f"analysis allow-list entry {e.get('rule')!r}:"
                             f"{e.get('target')!r} has no reason")
        if not e.get("rule") or not e.get("target"):
            raise ValueError(f"analysis allow-list entry needs rule and "
                             f"target: {e!r}")
    return entries


def apply_allowlist(findings: list[Finding],
                    entries: list[dict]) -> list[Finding]:
    """Mark findings matching an allow-list entry as suppressed (carrying the
    entry's reason). Unmatched findings pass through untouched."""
    out: list[Finding] = []
    for f in findings:
        key = f"{f.workflow}:{f.target}"
        hit = next((e for e in entries
                    if fnmatch.fnmatchcase(f.rule, e["rule"])
                    and fnmatch.fnmatchcase(key, e["target"])), None)
        if hit is not None:
            f = dataclasses.replace(f, suppressed=True, reason=hit["reason"])
        out.append(f)
    return out


def gate(findings: list[Finding],
         threshold: Severity = Severity.WARNING) -> list[Finding]:
    """The CI contract: findings that should fail a build — unsuppressed and
    at least ``threshold`` severe."""
    return [f for f in findings
            if not f.suppressed and f.severity >= threshold]
