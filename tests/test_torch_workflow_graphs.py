"""The port's compiler layer against the reference: hinted graphs, the
workflow compiler, the cluster topology, the workflow lint and its
``__main__``, and the port's H100 defaults.

Each test builds the same inputs in both packages (``repro.core`` and
``repro_torch.core``) and compares what comes out: exactly, because the
port's copies keep the reference's logic line for line and involve no
floating-point reordering.
"""

import contextlib
import dataclasses
import importlib
import inspect
import io
import itertools
import json
import random
import subprocess
import sys
from pathlib import Path

import pytest

import repro.analysis.__main__ as R_main
import repro.core as R
import repro.core.dag as R_dag
import repro.core.workloads as RW
import repro_torch.analysis.__main__ as T_main
import repro_torch.core as T
import repro_torch.core.dag as T_dag
import repro_torch.core.workloads as TW
from repro.configs import get_smoke as r_smoke
from repro.data.pipeline import epoch_workflow as r_epoch
from repro_torch.configs import get_smoke as t_smoke
from repro_torch.data.pipeline import epoch_workflow as t_epoch

# the packages export a function ``lint`` that shadows the module
R_lint = importlib.import_module("repro.analysis.lint")
T_lint = importlib.import_module("repro_torch.analysis.lint")
ROOT = Path(__file__).resolve().parents[1]
GB = float(1 << 30)

# every built-in workload, at its defaults and at a second set of arguments
WORKLOADS = {
    "fig2": lambda W: W.fig2_workflow(),
    "fig2-small": lambda W: W.fig2_workflow(64 * 1024 * 1024,
                                            flops_per_byte=20_000),
    "mapreduce": lambda W: W.mapreduce_workflow(),
    "mapreduce-12x6": lambda W: W.mapreduce_workflow(12, 6, 2e9,
                                                     flops_per_byte=4.0),
    "montage": lambda W: W.montage_workflow(),
    "montage-8": lambda W: W.montage_workflow(8, 1e8),
    "random_layered": lambda W: W.random_layered_workflow(seed=0),
    "random_layered-s3": lambda W: W.random_layered_workflow(6, 10, seed=3,
                                                             fan_in=3),
    "serving_session": lambda W: W.serving_session_workflow(),
    "pipeline_chain": lambda W: W.pipeline_chain_workflow(),
    "pipeline_chain-2x3": lambda W: W.pipeline_chain_workflow(2, 3),
    "training_epoch": lambda W: W.training_epoch_workflow(),
    "training_epoch-5": lambda W: W.training_epoch_workflow(5, 2,
                                                            ckpt_every=2),
}


def epoch_pair(n_steps=4, n_dp=4, batch=8, seq=4096, step_flops=1e15):
    kw = dict(n_steps=n_steps, n_dp=n_dp, batch=batch, seq=seq,
              step_flops=step_flops)
    return (r_epoch(r_smoke("granite-3-2b"), **kw),
            t_epoch(t_smoke("granite-3-2b"), **kw))


def graph_pair(name):
    if name == "epoch_workflow":
        return epoch_pair()
    if name == "epoch_workflow-2x2":
        return epoch_pair(2, 2, 4, 64, 1e9)
    return WORKLOADS[name](RW), WORKLOADS[name](TW)


GRAPHS = list(WORKLOADS) + ["epoch_workflow", "epoch_workflow-2x2"]


def facts(g):
    """Everything a graph says, as plain data: tasks with their inputs,
    outputs, hints and attributes, datasets with their sizes, producers,
    consumers and attributes, and the topological order."""
    tasks = {tid: (t.inputs, t.outputs, dataclasses.asdict(t.hints),
                   t.fn is None, t.est_flops, t.est_seconds, t.attrs)
             for tid, t in g.tasks.items()}
    data = {n: (d.size_bytes, d.producer, list(d.consumers), d.pinned_loc,
                d.xattr)
            for n, d in g.data.items()}
    return {"tasks": tasks, "data": data, "topo": g.topo_order(),
            "sources": g.sources(), "sinks": g.sinks()}


@pytest.mark.parametrize("name", GRAPHS)
def test_graphs_are_the_references(name):
    rg, tg = graph_pair(name)
    assert facts(tg) == facts(rg)
    assert len(tg) == len(rg) > 0


def test_epoch_workflow_shape():
    """4 steps over 4 shards: 16 loads and a chain of 4 steps, each step
    reading the previous parameters and its step's 4 batches of
    2 x 4097 int32 tokens."""
    _, g = epoch_pair()
    assert sorted(g.tasks) == sorted(
        [f"load_{s}_{d}" for s in range(4) for d in range(4)]
        + [f"step_{s}" for s in range(4)])
    assert g.tasks["step_2"].inputs == ("params2", "batch_2_0", "batch_2_1",
                                        "batch_2_2", "batch_2_3")
    wf = T.compile_workflow(g)
    assert wf.sizes["batch_0_0"] == 2 * 4097 * 4
    assert wf.critical_path[0].startswith("load_0_")
    assert wf.critical_path[1:] == ["step_0", "step_1", "step_2", "step_3"]


def test_cycles_are_refused_the_same_way():
    def cyclic(P):
        g = P.TaskGraph()
        g.add_data("ext", size_bytes=P.size_hint(GB))
        g.add_task("a", inputs=("ext", "y"), outputs=("x",))
        g.add_task("b", inputs=("x",), outputs=("y",))
        return g

    errors = []
    for P, dag in ((R, R_dag), (T, T_dag)):
        with pytest.raises(dag.CycleError) as ei:
            P.compile_workflow(cyclic(P), P.HPC_CLUSTER)
        errors.append(str(ei.value))
        with pytest.raises(dag.CycleError):
            cyclic(P).topo_order()
    assert errors[0] == errors[1]


@pytest.mark.parametrize("case", ["dup-task", "dup-producer", "dup-data",
                                  "strict", "size-hint", "mark-sink"])
def test_graph_errors_are_the_references(case):
    def attempt(P):
        g = P.TaskGraph()
        g.add_data("ext")
        g.add_task("t", inputs=("ext",), outputs=("o",))
        try:
            if case == "dup-task":
                g.add_task("t", inputs=("ext",), outputs=("o2",))
            elif case == "dup-producer":
                g.add_task("u", inputs=("ext",), outputs=("o",))
            elif case == "dup-data":
                g.add_data("ext")
            elif case == "strict":
                P.compile_workflow(g, P.HPC_CLUSTER, strict=True)
            elif case == "size-hint":
                P.size_hint(-1)
            else:
                g.mark_sink("nope")
        except (ValueError, KeyError) as e:
            return type(e).__name__, str(e)
        return None

    want = attempt(R)
    assert want is not None
    assert attempt(T) == want


# ------------------------------------------------------------------ compiler
def compiled_facts(wf):
    return {"topo": wf.topo, "sizes": wf.sizes, "flops": wf.est_flops,
            "seconds": wf.est_seconds, "earliest": wf.earliest_start,
            "rank": wf.upward_rank, "critical_path": wf.critical_path,
            "critical_seconds": wf.critical_seconds,
            "stage": wf.est_stage_seconds, "stage_ds": wf.stage_seconds,
            "write_modes": wf.write_modes, "summary": dict(wf.summary()),
            "graph": facts(wf.graph)}


@pytest.mark.parametrize("hw", ["HPC_CLUSTER", "TPU_V5E"])
@pytest.mark.parametrize("name", GRAPHS)
def test_compiler_is_the_references(name, hw):
    rg, tg = graph_pair(name)
    rwf = R.compile_workflow(rg, getattr(R, hw))
    twf = T.compile_workflow(tg, getattr(T, hw))
    assert compiled_facts(twf) == compiled_facts(rwf)
    assert dataclasses.asdict(twf.hw) == dataclasses.asdict(rwf.hw)


def test_compiler_with_a_topology_and_tier_rates():
    """A HardwareModel carrying a two-tier topology and per-tier rates
    costs moves as the reference does."""
    def hw(P):
        topo = P.ClusterTopology.two_tier(2, 4, oversubscription=4.0)
        return dataclasses.replace(P.HPC_CLUSTER, topology=topo,
                                   tier_gbps={"hbm": 800e9, "bb": 10e9})
    rh, th = hw(R), hw(T)
    for src, dst in itertools.product(range(-1, 9), repeat=2):
        for tiers in ((None, None), ("remote", "hbm"), ("bb", "host")):
            assert th.move_seconds_tiered(1e9, src, dst, *tiers) == \
                rh.move_seconds_tiered(1e9, src, dst, *tiers)
    rg, tg = graph_pair("mapreduce-12x6")
    assert compiled_facts(T.compile_workflow(tg, th)) == \
        compiled_facts(R.compile_workflow(rg, rh))


# ------------------------------------------------------------------ topology
def topologies(P):
    profs = [P.NodeProfile(speed=0.5, cls="old-gen", nic_gbps=0.625e9),
             P.NodeProfile(), P.NodeProfile(cls="spot"), P.NodeProfile()]
    return {
        "two_tier-2x2-profiles": P.ClusterTopology.two_tier(2, 2,
                                                            profiles=profs),
        "two_tier-2x4-oversub4": P.ClusterTopology.two_tier(
            2, 4, nic_gbps=1.25e9, oversubscription=4.0),
        "two_tier-2x2-deadpfs": P.ClusterTopology.two_tier(2, 2,
                                                           pfs_gbps=0.0),
        "one_switch-4": P.ClusterTopology.one_switch(4),
        "explicit": P.ClusterTopology(
            n_nodes=4, rack_of=(0, 0, 1, 1), nic_gbps=(0.0, 1e9, 1e9, 1e9),
            up_gbps=(1e9, 0.0), up_capacity_gbps=(4e9, 0.0),
            oversub=(1.0, 1.0)),
    }


@pytest.mark.parametrize("name", list(topologies(R)))
def test_topology_links_and_paths_are_the_references(name):
    rt, tt = topologies(R)[name], topologies(T)[name]
    assert dataclasses.asdict(tt) == dataclasses.asdict(rt)
    rng = random.Random(0)
    # seeded pairs over configured nodes, the PFS (-1) and grown nodes
    pairs = [(rng.randrange(-1, 2 * rt.n_nodes),
              rng.randrange(-1, 2 * rt.n_nodes)) for _ in range(200)]
    for src, dst in pairs:
        assert tt.link_gbps(src, dst) == rt.link_gbps(src, dst)
        assert tt.links(src, dst) == rt.links(src, dst)
        assert tt.same_rack(src, dst) == rt.same_rack(src, dst)
    for n in range(-1, 2 * rt.n_nodes):
        assert (tt.rack(n) if n >= 0 else None) == \
            (rt.rack(n) if n >= 0 else None)
        assert (tt.nic(n), tt.speed(n), tt.node_class(n)) == \
            (rt.nic(n), rt.speed(n), rt.node_class(n))
    assert tt.speeds() == rt.speeds()
    hr = R.HPC_CLUSTER.with_topology(rt)
    ht = T.HPC_CLUSTER.with_topology(tt)
    for src, dst in pairs:
        assert ht.link_gbps(src, dst) == hr.link_gbps(src, dst)


def test_topology_validation_is_the_references():
    def errors(P):
        out = []
        for kw in (dict(n_nodes=2, rack_of=(0,), nic_gbps=(1e9, 1e9)),
                   dict(n_nodes=2, rack_of=(0, 5), nic_gbps=(1e9, 1e9)),
                   dict(n_nodes=0, rack_of=(), nic_gbps=())):
            with pytest.raises(ValueError) as ei:
                P.ClusterTopology(up_gbps=(1e9,), up_capacity_gbps=(1e9,),
                                  oversub=(1.0,), **kw)
            out.append(str(ei.value))
        with pytest.raises(ValueError) as ei:
            P.ClusterTopology.two_tier(2, 2, oversubscription=0.0)
        return out + [str(ei.value)]

    assert errors(T) == errors(R)


# ---------------------------------------------------------------------- lint
def finding_facts(findings):
    return [(f.rule, str(f.severity), int(f.severity), f.workflow, f.target,
             f.message, f.suppressed, f.reason) for f in findings]


def lint_configs(P):
    tiny = P.StorageHierarchy([P.TierSpec("host", 1e6, 100e9)],
                              remote=P.TierSpec("remote", float("inf"), 1e9))
    topo = P.ClusterTopology.two_tier(2, 4, pfs_gbps=1e4)
    return {
        "main": P.SimConfig(n_nodes=8, hw=P.HPC_CLUSTER),
        "tiny-risky": P.SimConfig(n_nodes=2, hw=P.HPC_CLUSTER,
                                  hierarchy=tiny, failures=((5.0, 1),),
                                  joins=((6.0, 9),), durability="none"),
        "topology-remote": P.SimConfig.from_kwargs(
            n_nodes=8, hw=P.HPC_CLUSTER, topology=topo,
            external_loc="remote", speeds={12: 1.0, 1: 0.0}),
    }


@pytest.mark.parametrize("config", ["main", "tiny-risky", "topology-remote"])
@pytest.mark.parametrize("name", sorted(R_main.BUILTINS))
def test_lint_findings_are_the_references(name, config):
    assert sorted(T_main.BUILTINS) == sorted(R_main.BUILTINS)
    rwf = R.compile_workflow(R_main.BUILTINS[name](), R.HPC_CLUSTER)
    twf = T.compile_workflow(T_main.BUILTINS[name](), T.HPC_CLUSTER)
    rf = R_lint.lint(rwf, config=lint_configs(R)[config], name=name,
                     allowlist=R_lint.load_allowlist())
    tf = T_lint.lint(twf, config=lint_configs(T)[config], name=name,
                     allowlist=T_lint.load_allowlist())
    assert finding_facts(tf) == finding_facts(rf)
    assert T_lint.safe_write_modes(twf) == R_lint.safe_write_modes(rwf)
    assert [str(f) for f in tf] == [str(f) for f in rf]


def test_lint_rules_and_allowlist_are_the_references():
    assert [(r.id, int(r.severity), r.summary)
            for r in T_lint.RULES.values()] == \
        [(r.id, int(r.severity), r.summary) for r in R_lint.RULES.values()]
    assert T_lint.default_allowlist_path() == \
        R_lint.default_allowlist_path() == str(ROOT / "analysis_allowlist.json")
    assert T_lint.load_allowlist() == R_lint.load_allowlist()


def test_lint_of_an_uncompiled_cyclic_graph_is_the_references():
    def run(P, lint_mod):
        g = P.TaskGraph()
        g.add_task("loop", inputs=("x",), outputs=("x",))
        g.add_task("a", inputs=("y",), outputs=("z",))
        g.add_task("b", inputs=("z",), outputs=("y",))
        return finding_facts(lint_mod.lint_graph(g))

    assert run(T, T_lint) == run(R, R_lint)


ARGVS = [[], ["--workload", "fig2"], ["--workload", "random_layered",
                                      "--workload", "montage"],
         ["--fail-on", "INFO"], ["--fail-on", "ERROR"], ["--allowlist"]]


@pytest.mark.parametrize("argv", ARGVS, ids=["all", "fig2", "two", "info",
                                             "error", "no-allowlist"])
def test_lint_main_is_the_references(argv, capsys, tmp_path):
    if argv == ["--allowlist"]:
        empty = tmp_path / "allow.json"
        empty.write_text(json.dumps([]))
        argv = ["--allowlist", str(empty)]
    rc_r = R_main.main(argv)
    out_r = capsys.readouterr().out
    rc_t = T_main.main(argv)
    out_t = capsys.readouterr().out
    assert (rc_t, out_t) == (rc_r, out_r)
    assert out_t.strip()


def test_python_m_repro_torch_analysis_runs_alone():
    """``python -m repro_torch.analysis`` in a fresh interpreter with jax
    and the reference blocked prints what the reference's gate prints."""
    code = "\n".join([
        "import runpy, sys",
        "sys.modules['jax'] = None",
        "sys.modules['repro'] = None",
        f"sys.path.insert(0, {str(ROOT / 'src')!r})",
        "sys.argv = ['python -m repro_torch.analysis']",
        "runpy.run_module('repro_torch.analysis', run_name='__main__')",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = R_main.main([])
    assert rc == 0
    assert out.stdout == buf.getvalue()


# ------------------------------------------------------------------ defaults
def test_default_hardware_is_the_h100():
    h = T.H100_SXM
    assert h.name == "h100-sxm"
    assert (h.peak_flops, h.hbm_gbps, h.ici_gbps, h.dcn_gbps,
            h.nodes_per_pod) == (989e12, 3.35e12, 900e9, 50e9, 8)
    # efficiency and the parallel-FS rate stay the reference's
    assert (h.efficiency, h.remote_tier_gbps) == \
        (R.TPU_V5E.efficiency, R.TPU_V5E.remote_tier_gbps)
    assert T.HardwareModel() == h
    assert T.SimConfig().hw is h
    assert inspect.signature(T.compile_workflow).parameters["hw"].default is h
    assert inspect.signature(
        T.WorkflowExecutor).parameters["hw"].default is h
    assert T.compile_workflow(TW.fig2_workflow()).hw is h
    # the reference's preset is kept by name, with the reference's numbers
    assert dataclasses.asdict(T.TPU_V5E) == dataclasses.asdict(R.TPU_V5E)
    assert dataclasses.asdict(T.HPC_CLUSTER) == \
        dataclasses.asdict(R.HPC_CLUSTER)
    # H100 costs: NVLink inside a node of 8, the NDR port across nodes
    assert h.link_gbps(0, 7) == 900e9 and h.link_gbps(0, 8) == 50e9
    assert h.link_gbps(3, -1) == h.remote_tier_gbps
    assert h.est_task_seconds(989e12) == 1.0 / h.efficiency


@pytest.mark.parametrize("kw", [
    {},
    {"n_nodes": 8, "failures": [(4, 1), (12.5, 3)], "joins": [[8, 1]]},
    {"sanitize": True, "sanitize_every": 1, "indexed": False,
     "honor_write_modes": True, "write_policy": "back"},
], ids=["defaults", "schedules", "knobs"])
def test_simconfig_from_kwargs_is_simconfig(kw):
    c = T.SimConfig.from_kwargs(**dict(kw))
    want = {**kw}
    for key in ("failures", "joins"):
        if key in want:
            want[key] = tuple((float(t), int(n)) for t, n in want[key])
    assert c == T.SimConfig(**want)
    fields_t = [f.name for f in dataclasses.fields(T.SimConfig)]
    assert fields_t == [f.name for f in dataclasses.fields(R.SimConfig)]
    r = R.SimConfig.from_kwargs(**dict(kw))
    for f in fields_t:
        if f != "hw":
            assert getattr(c, f) == getattr(r, f), f
    with pytest.raises(TypeError, match="unknown knob"):
        T.SimConfig.from_kwargs(bogus=1)
