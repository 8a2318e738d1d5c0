"""The port's examples (``repro_torch.examples``) on the CPU, held to the
reference's ``examples/`` scripts, which run in a subprocess as a user runs
them. Where an example has weights, the port runs the reference's, carried
across by ``_bridge.from_reference``."""

import dataclasses
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import init_params as jax_init_params
from repro_torch._bridge import from_reference
from repro_torch.examples import (elastic_restart, quickstart, serve_routed,
                                  train_lm)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _run_reference(name: str) -> str:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / name)],
                         capture_output=True, text=True, timeout=600,
                         env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _reference_params(cfg):
    return jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(0)))


def test_quickstart_equals_the_reference(capsys):
    ref = _run_reference("quickstart.py")
    res = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    want = float(re.search(r"executed: out=([0-9.]+)", ref).group(1))
    # printed to 0.1; the f32 sums run in another order
    assert res["out"] == pytest.approx(want, rel=1e-4, abs=0.05)
    sim = [ln for ln in ref.splitlines() if "makespan=" in ln]
    assert len(sim) == 3 and res["simulation"] == sim
    for line in ("critical path:", "dataset sizes:"):
        assert next(ln for ln in ref.splitlines() if ln.startswith(line)) \
            == next(ln for ln in out.splitlines() if ln.startswith(line))


def test_serve_routed_equals_the_reference(capsys):
    ref = _run_reference("serve_routed.py")
    cfg = serve_routed.config()
    jcfg = dataclasses.replace(jax_smoke("granite-3-2b"), dtype="float32")
    model = from_reference(cfg, _reference_params(jcfg), device=CPU)
    res = serve_routed.run(CPU, model=model)
    out = capsys.readouterr().out
    hits, misses = map(int, re.search(r"routing: (\d+) hits, (\d+) misses",
                                      ref).groups())
    prefills = int(re.search(r"prefills run: (\d+)", ref).group(1))
    assert (res["hits"], res["misses"], res["prefills"]) == \
        (hits, misses, prefills) == (12, 0, 4)
    # session ids count up per process: compare the turns without them
    def turns(text):
        return [re.sub(r"session \d+", "session", ln.strip())
                for ln in text.splitlines() if "turn " in ln]

    assert turns(ref) == turns(out) and len(turns(ref)) == 12


def test_serve_routed_main_on_the_cpu(capsys):
    res = serve_routed.main(["--device", "cpu"])
    assert (res["hits"], res["misses"], res["prefills"]) == (12, 0, 4)
    vocab = serve_routed.config().vocab
    assert len(res["tokens"]) == 4     # 1 + 2 steps a turn per engine, 3 turns
    assert all(len(t) == 7 and all(0 <= x < vocab for x in t)
               for t in res["tokens"].values())


def test_train_lm_keeps_the_reference_config():
    """Every field of the reference's config equal; the fields only the
    port has (the hybrid family's published Zamba2 options) at their
    defaults."""
    spec = importlib.util.spec_from_file_location(
        "ref_train_lm", ROOT / "examples" / "train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    port, ref = (dataclasses.asdict(train_lm.CFG_100M),
                 dataclasses.asdict(mod.CFG_100M))
    assert {k: port[k] for k in ref} == ref
    defaults = {f.name: f.default
                for f in dataclasses.fields(type(train_lm.CFG_100M))}
    assert {k: v for k, v in port.items() if k not in ref} == \
        {k: defaults[k] for k in port if k not in ref}


def test_train_lm_reduces_the_loss_and_restarts_once(capsys):
    """A few steps of a narrow copy of the example's model, with the
    failure after the third: the loop restarts once (from the seeded init:
    no checkpoint yet) and the loss falls."""
    cfg = dataclasses.replace(train_lm.CFG_100M, n_layers=2, d_model=64,
                              n_heads=4, n_kv_heads=2, d_ff=128, vocab=512)
    r = train_lm.run(cfg, steps=8, batch=4, seq=32, fail_at=4, device=CPU)
    assert r.restarts == 1 and r.steps_done == 8
    assert r.losses[-1] < r.losses[0]
    assert "1 failure-restart(s)" in capsys.readouterr().out


def test_elastic_restart_equals_the_reference(capsys):
    ref = _run_reference("elastic_restart.py")
    cfg = jax_smoke("granite-3-2b")
    from repro_torch.configs import get_smoke
    model = from_reference(get_smoke("granite-3-2b"),
                           _reference_params(cfg), device=CPU)
    res = elastic_restart.run(CPU, model=model)
    out = capsys.readouterr().out
    assert res == {"step": 40, "leaves": 12, "identical": True}
    for line in ("restored step", "content identical", "restarting on mesh"):
        assert next(ln for ln in ref.splitlines() if ln.startswith(line)) \
            == next(ln for ln in out.splitlines() if ln.startswith(line))
    assert "Shard(dim=1), Shard(dim=2)" in out     # PartitionSpec(None,
    assert "PartitionSpec(None, 'data', 'model')" in ref  # 'data', 'model')


def test_elastic_restart_main_on_the_cpu():
    import torch.distributed as dist
    assert elastic_restart.main(["--device", "cpu"])["identical"]
    assert not dist.is_initialized()


@pytest.mark.parametrize("name", ["quickstart", "serve_routed", "train_lm",
                                  "elastic_restart"])
def test_examples_refuse_the_cpu_by_default(name):
    """Each example's default device is the card; with none it raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    mod = {"quickstart": quickstart, "serve_routed": serve_routed,
           "train_lm": train_lm, "elastic_restart": elastic_restart}[name]
    kw = {"cfg": dataclasses.replace(train_lm.CFG_100M, n_layers=1),
          "steps": 1} if name == "train_lm" else {}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.run(**kw)
