"""CPU rehearsal of the harness: every cell found by name, the result line's
shape, a new configuration, mix and metric picked up without an edit, no
result without a card or without the program, the import guard, and the
drivers run end to end at smoke sizes on an explicit CPU device, where a
planted fault in the timed path turns ``correct`` false."""

import ast
import copy
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

import harness
import run
from drivers import serving

ROOT = harness.ROOT
SPEC = harness.load_json(ROOT / "BENCHMARK.json")
SMOKE_MODEL = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                   d_ff=256, vocab=512)



def _cell(name: str) -> harness.Cell:
    """The committed cell with its model and traffic cut to smoke size
    (its limits as committed)."""
    c = copy.deepcopy(harness.load_cell(name))
    c.config["model"].update(SMOKE_MODEL)
    mix = c.mix
    if mix["driver"] == "serve_open":
        mix["engine"].update(slots=4, max_seq=256)
        mix["trace"].update(req_rate=4.0, prompt_median=24, max_prompt=96,
                            followup_median=8, output_median=6, max_output=24)
        mix.update(history_s=20, tail_s=2, pace_tokens_per_s=20.0,
                   think_s=0.2, max_parked=12, drain_s=20, trace_seconds=1.0)
    elif mix["driver"] == "serve_closed":
        mix["engine"].update(slots=4, max_seq=256)
        mix["trace"].update(prompt_median=96, max_prompt=160,
                            output_median=8, max_output=24)
        mix.update(warm_s=0.5, trace_seconds=1.0)
    return c


def _run(cell, seed=2**31 + 77, trace=False):
    return run.run_cell(cell, seed, 2.0, trace, "cpu", time.time())


WORKLOADS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_found_by_name(name):
    c = harness.load_cell(name)
    assert (harness.BENCH / "drivers" / f"{c.driver}.py").exists()
    for m in c.per_layer:
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()
    conf = next(x for x in SPEC["configs"]
                if x["name"] == next(w for w in SPEC["workloads"]
                                     if w["name"] == name)["config"])
    assert c.config["name"] == conf["name"]
    assert c.config["source"] == conf["source"]
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    assert all(m["moves"] in names for m in c.per_layer)


def test_result_line_shape():
    rec = harness.Record(values={"setup_s": 1.5})
    rec.check("gap", 0.1, 0.5, True)
    rec.attempted = 3
    line = harness.result_line(
        rec, {"setup_s": {"value": 1.5, "unit": "s"}},
        {"platform": "gpu", "kind": "x", "count": 1,
         "memory_peak_bytes": 5}, {"device_ops": [], "idle_gaps": []})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "limits"]
    assert out["correct"] is True and out["limits"]["gap"]["limit"] == 0.5
    assert harness.check_lines(rec) == ["check gap: 0.1 limit 0.5 ok"]


def test_new_config_mix_and_metric_need_no_edit(tmp_path):
    bench = tmp_path / "bench"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = copy.deepcopy(SPEC)
    conf = harness.load_json(bench / "configs" / "granite-3-2b.json")
    conf["name"] = "other-model"
    (bench / "configs" / "other-model.json").write_text(json.dumps(conf))
    mix = harness.load_json(bench / "mixes" / "longdoc.json")
    mix["trace"]["prompt_median"] = 1024
    (bench / "mixes" / "shortdoc.json").write_text(json.dumps(mix))
    (bench / "metrics" / "served_requests.serve.py").write_text(
        "def read(rec):\n    return rec.counters.get('requests_done')\n")
    spec["configs"].append({"name": "other-model", "source": "x",
                            "file": "bench/configs/other-model.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "other-model.shortdoc",
                              "config": "other-model",
                              "traffic": "shortdoc", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "served_requests.serve", "unit": "1",
                              "better": "higher", "source": "program_counter",
                              "layer": "ServingEngine",
                              "moves": "served_tok_per_s"})
    spec["end_to_end"] = [dict(m, workloads=m["workloads"]
                               + ["other-model.shortdoc"])
                          if m["name"] == "served_tok_per_s" else m
                          for m in spec["end_to_end"]]
    c = harness.load_cell("other-model.shortdoc", spec, bench=bench)
    assert c.config["name"] == "other-model" and c.driver == "serve_closed"
    assert c.mix["trace"]["prompt_median"] == 1024
    assert "served_requests.serve" in [m["name"] for m in c.per_layer]
    rec = harness.Record(counters={"requests_done": 7})
    got = harness.per_layer_values(
        harness.Cell("x", 1, {}, {}, [], [m for m in c.per_layer if m[
            "name"] == "served_requests.serve"]), rec, bench=bench)
    assert got == {"served_requests.serve": {"value": 7.0, "unit": "1"}}


def test_no_card_means_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(harness.BENCH / "run.py"),
                        "--workload", WORKLOADS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        WORKLOADS[0], "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, cwd=tmp_path,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_modules_by_whole_top_level_name():
    mods = {"jax.numpy": 1, "repro_torch.models": 1, "repro": 1,
            "jaxlib": 1, "flaxen": 1, "numpy": 1}
    assert harness.forbidden_loaded(mods) == ["jax", "jaxlib", "repro"]
    assert harness.forbidden_loaded({"repro_torch": 1, "torch": 1}) == []


@pytest.mark.parametrize("path", sorted((harness.BENCH / "reference")
                                        .glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("name", WORKLOADS)
def test_driver_runs_on_cpu(name):
    c = _cell(name)
    rec, metrics, _ = _run(c)
    assert rec.correct, rec.checks
    assert set(metrics) == {m["name"] for m in c.end_to_end}
    assert all(v > 0 for v in rec.values.values())
    rec, metrics, breakdown = _run(c, trace=True)
    assert rec.correct and breakdown is not None
    assert set(metrics) <= {m["name"] for m in c.per_layer}


def test_chat_rebuilds_a_conversation_without_cache():
    """A follow-up whose conversation lost its cache (never held at set-up,
    or finished under ``max_parked``) prefills the whole conversation, is
    checked like every other turn, and counts in reprefill_share.chat."""
    c = _cell("granite-3-2b.chat")
    c.mix["max_parked"] = 2
    rec, _, _ = run.run_cell(c, 2**31 + 77, 3.0, False, "cpu", time.time())
    n = rec.counters
    assert rec.correct, rec.checks
    assert n["rebuilds"] == n.get("rebuilt_capped", 0) \
        + n.get("rebuilt_unpopulated", 0) + n.get("rebuilt_done", 0) > 0
    assert "rebuild" in rec.notes["sample_kinds"]
    reader = harness.load_module(
        harness.BENCH / "metrics" / "reprefill_share.chat.py", "rs")
    assert reader.read(rec) == pytest.approx(
        100.0 * (n["migrations"] + n["rebuilds"])
        / (n["followups"] + n["rebuilds"]))


# ------------------------------------------------------------ planted faults
def _serve_cells():
    return [n for n in WORKLOADS
            if harness.load_cell(n).driver.startswith("serve")]


def _altered_token(mp):
    from repro_torch.serve import engine
    plain = engine.TorchComputeBackend.decode

    def decode(self, params, state, tokens):
        arg, state = plain(self, params, state, tokens)
        return (arg + 1) % self.cfg.vocab, state
    mp.setattr(engine.TorchComputeBackend, "decode", decode)


def _state_unchanged(mp):
    from repro_torch.models import model as M
    plain = M.decode_step

    def step(cfg, model, state, tokens):
        scratch = {k: v.clone() for k, v in state.items()}
        logits, _ = plain(cfg, model, scratch, tokens)
        return logits, state
    mp.setattr(M, "decode_step", step)


def _half_batch(mp):
    from repro_torch.serve import engine
    plain = engine.TorchComputeBackend.decode

    def decode(self, params, state, tokens):
        arg, state = plain(self, params, state, tokens)
        half = len(arg) // 2
        arg[half:] = tokens[half:, 0]           # the rest left undecoded
        return arg, state
    mp.setattr(engine.TorchComputeBackend, "decode", decode)


@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged,
                                   _half_batch],
                         ids=["token_altered", "state_unchanged",
                              "half_batch"])
@pytest.mark.parametrize("name", _serve_cells())
def test_serving_fault_turns_correct_false(name, fault, monkeypatch):
    c = _cell(name)
    fault(monkeypatch)
    rec, _, _ = _run(c)
    assert not rec.correct, rec.checks


def test_check_reads_the_served_tokens(monkeypatch):
    """The comparison judges what the program served: the samples it is
    handed are the tokens the engine produced."""
    seen = []
    plain = serving.check_served

    def spy(rec, config, w, samples, limit):
        seen.extend(samples)
        plain(rec, config, w, samples, limit)
    monkeypatch.setattr(serving, "check_served", spy)
    _run(_cell(_serve_cells()[0]))
    assert seen and all(0 < a < b <= len(t) for t, a, b in seen)
