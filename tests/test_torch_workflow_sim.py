"""The port's schedulers, event simulator and sanitizer against the
reference.

The simulator runs the reference's equivalence matrix
(``tests/test_sched_equivalence.py``: 3 schedulers x 2 workflows x the
indexed and full-rescan decision paths x healthy / failures / a membership
cycle, on its tight tier hierarchy with write-back, coordinated eviction and
fsync-on-barrier durability), with the sanitizer off and on, in both
packages: ``dataclasses.asdict(SimResult)`` must be equal with ``==``, bit
for bit. Then topology-backed, predictive and write-mode runs. Last, every
corruption that the reference's sanitizer tests plant is planted in both
packages' structures, and the port's check must raise the reference's error:
the same check, divergent entry and values.
"""

import dataclasses

import pytest
import torch

import repro.analysis.sanitize as R_san
import repro.core as R
import repro.core.workloads as RW
import repro_torch.analysis.sanitize as T_san
import repro_torch.core as T
import repro_torch.core.workloads as TW

PKGS = {"ref": (R, RW, R_san), "port": (T, TW, T_san)}

FAILURES = [(20.0, 1), (60.0, 3)]
MEMBERSHIP = {"failures": [(4.0, 1), (12.0, 3)],
              "joins": [(8.0, 1), (16.0, 9)]}


def tight_hierarchy(P):
    return P.StorageHierarchy(
        [P.TierSpec("hbm", 6e9, 800e9), P.TierSpec("bb", 12e9, 10e9)],
        remote=P.TierSpec("remote", float("inf"), 0.5e9))


def build_workflow(P, W, kind):
    if kind == "mapreduce":
        g = W.mapreduce_workflow(12, 6, 2e9, flops_per_byte=4.0)
    elif kind == "random_layered":
        g = W.random_layered_workflow(6, 10, seed=3, fan_in=3)
    else:
        g = W.pipeline_chain_workflow(8, 6)
    return P.compile_workflow(g, P.HPC_CLUSTER)


def build_scheduler(P, kind, wf):
    if kind == "proactive":
        return P.ProactiveScheduler(wf, risk_aware=True)
    if kind == "locality":
        return P.LocalityScheduler(wf, speed_aware=True)
    return P.FCFSScheduler(wf)


def run_once(pkg, wf_kind, sched_kind, *, indexed=True, failures=(),
             joins=(), topology=None, sanitize=False, **kw):
    P, W, _ = PKGS[pkg]
    wf = build_workflow(P, W, wf_kind)
    base = dict(n_nodes=8, hw=P.HPC_CLUSTER, indexed=indexed,
                failures=list(failures), joins=list(joins),
                hierarchy=tight_hierarchy(P), write_policy="back",
                coordinated_eviction=True, durability="fsync_on_barrier",
                topology=topology, sanitize=sanitize, sanitize_every=1)
    base.update(kw)
    sim = P.WorkflowSimulator(wf, build_scheduler(P, sched_kind, wf), **base)
    return sim, sim.run()


def same_result(wf_kind, sched_kind, topology=None, **kw):
    _, ref = run_once("ref", wf_kind, sched_kind,
                      topology=topology and topology(R), **kw)
    _, port = run_once("port", wf_kind, sched_kind,
                       topology=topology and topology(T), **kw)
    got, want = dataclasses.asdict(port), dataclasses.asdict(ref)
    assert got.keys() == want.keys()
    assert [k for k in want if got[k] != want[k]] == []
    assert got == want
    return port


@pytest.mark.parametrize("sanitize", [False, True], ids=["plain", "sanitized"])
@pytest.mark.parametrize("mode", ["healthy", "failures", "membership"])
@pytest.mark.parametrize("indexed", [True, False], ids=["indexed", "rescan"])
@pytest.mark.parametrize("wf_kind", ["mapreduce", "random_layered"])
@pytest.mark.parametrize("sched_kind", ["proactive", "locality", "fcfs"])
def test_sim_result_is_the_references(sched_kind, wf_kind, indexed, mode,
                                      sanitize):
    kw = {"healthy": {}, "failures": {"failures": FAILURES},
          "membership": MEMBERSHIP}[mode]
    r = same_result(wf_kind, sched_kind, indexed=indexed, sanitize=sanitize,
                    **kw)
    assert r.tasks_done > 0
    if mode == "membership":
        assert r.joins == 2 and [j.node for j in r.join_reports] == [1, 9]


@pytest.mark.parametrize("aware", [True, False], ids=["aware", "blind"])
@pytest.mark.parametrize("sched_kind", ["proactive", "locality"])
def test_sim_result_is_the_references_on_a_topology(sched_kind, aware):
    """A two-rack fabric with 4:1 oversubscribed uplinks, inputs scattered
    over the nodes: per-link lanes and rack-aware costs (aware) or the flat
    view with real per-link charges (blind)."""
    r = same_result(
        "mapreduce", sched_kind,
        topology=lambda P: P.ClusterTopology.two_tier(
            2, 4, nic_gbps=1.25e9, oversubscription=4.0),
        topology_aware=aware, external_loc="scattered", sanitize=True,
        write_policy="through", coordinated_eviction=False,
        durability="none", **MEMBERSHIP)
    assert r.cross_spine_bytes > 0 and r.link_bytes


def test_flat_topology_is_the_references():
    r = same_result("random_layered", "proactive", sanitize=True,
                    topology=lambda P: P.ClusterTopology.one_switch(8),
                    **MEMBERSHIP)
    assert r.link_bytes == {}


@pytest.mark.parametrize("predict", [True, False], ids=["predict", "react"])
def test_predictive_rereplication_is_the_references(predict):
    """A failure flagged ahead of time (``tests/test_topology.py``'s
    predictive run): the predictive re-replication moves the same sole
    copies as the reference's."""
    r = same_result(
        "pipeline_chain", "proactive", n_nodes=4, failures=[(8.0, 1)],
        predict_failures=predict, predict_lead_s=3.0, sanitize=True,
        write_policy="through", coordinated_eviction=False,
        durability="none")
    assert (r.predictive_rereplications > 0) == predict


def test_spot_profiles_on_a_topology_are_the_references():
    """Spot-class and slow nodes on a two-rack fabric with a flagged
    failure: speeds, rack diversity and the spot marker steer the same
    decisions as the reference's."""
    r = same_result(
        "pipeline_chain", "proactive", n_nodes=4, failures=[(8.0, 1)],
        predict_failures=True, predict_lead_s=3.0, sanitize=True,
        topology=lambda P: P.ClusterTopology.two_tier(
            2, 2, profiles=[P.NodeProfile(), P.NodeProfile(cls="spot"),
                            P.NodeProfile(speed=0.5), P.NodeProfile()]))
    assert r.tasks_done > 0


@pytest.mark.parametrize("honor", [True, False, "auto"])
def test_write_mode_pins_are_the_references(honor):
    r = same_result("mapreduce", "locality", honor_write_modes=honor,
                    sanitize=True)
    assert r.tasks_done > 0


def test_simulate_helper_and_config_spelling_are_the_references():
    def run(P, W):
        wf = P.compile_workflow(W.fig2_workflow(flops_per_byte=20_000),
                                P.HPC_CLUSTER)
        a = P.simulate(wf, P.ProactiveScheduler, n_nodes=16, hw=P.HPC_CLUSTER)
        b = P.simulate(wf, P.ProactiveScheduler,
                       config=P.SimConfig(n_nodes=16, hw=P.HPC_CLUSTER))
        assert a == b
        with pytest.raises(TypeError):
            P.simulate(wf, P.ProactiveScheduler, n_nodes=16,
                       config=P.SimConfig())
        return dataclasses.asdict(a)

    assert run(T, TW) == run(R, RW)


def test_indexed_is_the_default():
    wf = build_workflow(T, TW, "mapreduce")
    assert T.WorkflowSimulator(wf, T.ProactiveScheduler(wf), n_nodes=8,
                               hw=T.HPC_CLUSTER).indexed is True


# ----------------------------------------------------------------- sanitizer
def _sanitized_pair(kind):
    """Each package's simulator after a clean run, as the reference's
    sanitizer tests leave it."""
    out = {}
    for pkg, (P, W, _) in PKGS.items():
        if kind == "topology":
            wf = P.compile_workflow(
                W.mapreduce_workflow(12, 6, 2e9, flops_per_byte=4.0),
                P.HPC_CLUSTER)
            sim = P.WorkflowSimulator(
                wf, P.LocalityScheduler(wf, speed_aware=True), n_nodes=8,
                hw=P.HPC_CLUSTER, topology=P.ClusterTopology.two_tier(
                    2, 4, nic_gbps=1.25e9, oversubscription=4.0),
                external_loc="scattered", hierarchy=tight_hierarchy(P),
                sanitize=True, sanitize_every=1)
        else:
            wf = P.compile_workflow(W.mapreduce_workflow(8, 4),
                                    P.HPC_CLUSTER)
            sim = P.WorkflowSimulator(
                wf, P.ProactiveScheduler(wf), config=P.SimConfig.from_kwargs(
                    n_nodes=4, hw=P.HPC_CLUSTER,
                    hierarchy=tight_hierarchy(P), write_policy="back",
                    coordinated_eviction=True))
        sim.run()
        out[pkg] = sim
    return out


@pytest.fixture(scope="module")
def ran():
    return _sanitized_pair("store")


@pytest.fixture(scope="module")
def ran_topology():
    return _sanitized_pair("topology")


def _membership(sim, san):
    sim.store._failed_nodes.add(2)
    try:
        san.check_membership(sim.store, sim.cluster)
    finally:
        sim.store._failed_nodes.discard(2)


def _tier_usage(sim, san):
    store = sim.store
    key = sorted(store._usage)[0]
    store._usage[key] += 123456.0
    try:
        san.check_tier_usage(store)
    finally:
        store._usage[key] -= 123456.0


def _ledger(sim, san):
    sim.store.bytes_moved += 1e9
    try:
        san.check_ledger(sim.store)
    finally:
        sim.store.bytes_moved -= 1e9


def _pin_leak(sim, san):
    store = sim.store
    name = sorted(store._sizes)[0]
    store._pins[(name, 0)] = store._pins.get((name, 0), 0) + 1
    try:
        san.check_pin_conservation(store, {})
    finally:
        store._pins[(name, 0)] -= 1


def _placement_mirror(sim, san):
    sched = sim.sched
    san.check_placement_mirror(sched, sim.store)       # clean before
    name = sorted(sched._placements)[0]
    stash = sched._placements.pop(name)
    try:
        san.check_placement_mirror(sched, sim.store)
    finally:
        sched._placements[name] = stash


def _term_cache(sim, san):
    sched = sim.sched
    name = sorted(n for n in sched._term_cache if sched._term_cache[n])[0]
    node = sorted(sched._term_cache[name])[0]
    sched._term_cache[name][node] += 1.0
    try:
        san.check_term_cache(sched, sim.cluster)
    finally:
        sched._term_cache[name][node] -= 1.0


def _proactive(sim, san):
    sched = sim.sched
    tid = sorted(sched.wf.graph.tasks)[0]
    old = sched._avail.get(tid, 0)
    sched._avail[tid] = old + 7
    try:
        san.check_proactive(sched, sim.cluster)
    finally:
        sched._avail[tid] = old


def _link_path(sim, san):
    cache = sim._path_cache
    san.check_link_paths(cache, sim._topo_real)         # clean before
    key = sorted(cache)[0]
    stash = cache[key]
    cache[key] = stash + (("up", 99),)
    try:
        san.check_link_paths(cache, sim._topo_real)
    finally:
        cache[key] = stash


def _link_path_without_topology(sim, san):
    san.check_link_paths({(0, 1): (0, 1)}, None)


def _link_row(sim, san):
    rows = sim.cluster._link_rows
    san.check_link_rows(sim.cluster)                    # clean before
    src = sorted(rows)[0]
    row, _ = rows[src]
    dst = (src + 1) % sim.cluster.n_nodes
    row[dst] += 1.0
    try:
        san.check_link_rows(sim.cluster)
    finally:
        row[dst] -= 1.0


def _link_row_uniform(sim, san):
    rows = sim.cluster._link_rows
    src = sorted(rows)[0]
    row, uniform = rows[src]
    rows[src] = (row, 123.456)
    try:
        san.check_link_rows(sim.cluster)
    finally:
        rows[src] = (row, uniform)


def _candidate_index(sim, san):
    """The simulator's pending-candidate index, rebuilt from the finished
    run's store, with one task's materialized-input count off by one."""
    graph, store = sim.wf.graph, sim.store
    truth = set(store.loc.names())
    avail = {tid: sum(1 for n in t.inputs if n in truth)
             for tid, t in graph.tasks.items()}
    state = {tid: "pending" for tid in graph.tasks}
    order = {tid: i for i, tid in enumerate(sorted(graph.tasks))}
    cand = sorted((order[t], t) for t in graph.tasks if avail[t] > 0)
    kw = dict(state=state, avail_count=avail, cand_list=cand,
              cand_set={t for _, t in cand}, exists_mirror=set(truth),
              order=order, store=store, graph=graph)
    san.check_candidate_index(**kw)                     # clean before
    tid = sorted(graph.tasks)[-1]
    avail[tid] += 1
    san.check_candidate_index(**kw)


PLANTS = {
    "membership": (_membership, "store"),
    "tier-usage": (_tier_usage, "store"),
    "ledger": (_ledger, "store"),
    "pin-conservation": (_pin_leak, "store"),
    "placement-mirror": (_placement_mirror, "store"),
    "term-cache": (_term_cache, "store"),
    "proactive": (_proactive, "store"),
    "candidate-index": (_candidate_index, "store"),
    "link-path": (_link_path, "topology"),
    "link-path-no-topology": (_link_path_without_topology, "topology"),
    "link-row": (_link_row, "topology"),
    "link-row-uniform": (_link_row_uniform, "topology"),
}


@pytest.mark.parametrize("plant", list(PLANTS))
def test_planted_corruption_is_caught_as_the_reference_catches_it(
        plant, ran, ran_topology):
    fn, kind = PLANTS[plant]
    sims = ran if kind == "store" else ran_topology
    caught = {}
    for pkg, (_, _, san) in PKGS.items():
        with pytest.raises(san.SanitizerError) as ei:
            fn(sims[pkg], san)
        e = ei.value
        caught[pkg] = (e.check, e.key, e.expected, e.actual, str(e))
    assert caught["port"] == caught["ref"]
    assert caught["port"][0] == plant.replace("-no-topology", "").replace(
        "-uniform", "")


def test_sanitizer_is_an_observer_and_follows_the_env(monkeypatch):
    def run(sanitize):
        wf = T.compile_workflow(TW.mapreduce_workflow(8, 4), T.HPC_CLUSTER)
        sim = T.WorkflowSimulator(wf, T.ProactiveScheduler(wf),
                                  config=T.SimConfig.from_kwargs(
                                      n_nodes=4, hw=T.HPC_CLUSTER,
                                      hierarchy=tight_hierarchy(T),
                                      sanitize=sanitize, sanitize_every=1))
        return sim, sim.run()

    assert run(True)[1] == run(False)[1]
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert T_san.env_enabled() and run(None)[0].sanitize
    assert not run(False)[0].sanitize
    for off in ("", "0", "false", "off", "no"):
        monkeypatch.setenv("REPRO_SANITIZE", off)
        assert not T_san.env_enabled()
    err = T_san.SanitizerError("ledger", "bytes_moved", 1.0, 2.0)
    assert isinstance(err, AssertionError)
    assert str(err) == str(R_san.SanitizerError("ledger", "bytes_moved",
                                                1.0, 2.0))


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_checkpoint_loop_catches_live_drift(pkg):
    """A scheduler that drops one entry of its own placement mirror mid-run
    is stopped by the per-event checkpoint with that entry; without the
    sanitizer the same run completes."""
    P, W, san = PKGS[pkg]

    class Drifting(P.LocalityScheduler):
        def select(self, ready, cluster):
            out = super().select(ready, cluster)
            if self._placements and not getattr(self, "_hit", False):
                self._hit = True
                self._dropped = next(iter(self._placements))
                del self._placements[self._dropped]
            return out

    def sim(sanitize):
        wf = P.compile_workflow(W.pipeline_chain_workflow(2, 3),
                                P.HPC_CLUSTER)
        sched = Drifting(wf)
        return sched, P.WorkflowSimulator(wf, sched, config=P.SimConfig(
            n_nodes=4, hw=P.HPC_CLUSTER, hierarchy=tight_hierarchy(P),
            write_policy="back", coordinated_eviction=True,
            sanitize=sanitize, sanitize_every=1))

    sched, s = sim(True)
    with pytest.raises(san.SanitizerError) as ei:
        s.run()
    assert (ei.value.check, ei.value.key) == ("placement-mirror",
                                              sched._dropped)
    _, s = sim(False)
    assert s.run().tasks_done == len(s.wf.graph.tasks)


def test_engine_slot_desync_is_caught_by_the_port():
    """The serving corruption of the reference's sanitizer tests: a slotted
    session dropped from the engine's slot table."""
    from repro_torch.configs import get_smoke
    from repro_torch.core.config import ServingConfig
    from repro_torch.models import init_params
    from repro_torch.serve.engine import ServingEngine

    cfg = dataclasses.replace(get_smoke("granite-3-2b"), dtype="float32")
    torch.manual_seed(0)
    eng = ServingEngine(cfg, init_params(cfg, 0, device="cpu"), device="cpu",
                        config=ServingConfig(max_batch=2, max_seq=64,
                                             sanitize=True))
    sid = eng.submit([1, 2, 3])
    eng.submit([4, 5])
    eng.step()
    eng._slotted.pop(sid)
    with pytest.raises(T_san.SanitizerError) as ei:
        eng.step()
    assert (ei.value.check, ei.value.key) == ("engine-slots",
                                              f"session{sid}")
