"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports jax or anything of the reference package, and its
entry points refuse to run on the CPU unless asked to."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT_LINE = re.compile(
    r"^\s*(import\s+(jax|repro)(\s|\.|,|$)|from\s+(jax|repro)(\s|\.))",
    re.MULTILINE)


def _port_modules() -> list[str]:
    import repro_torch
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]


def test_every_module_imports_with_jax_and_repro_blocked():
    mods = _port_modules()
    assert {"repro_torch.serve.engine", "repro_torch.serve.traffic",
            "repro_torch.models.moe", "repro_torch.models.mla",
            "repro_torch.models.ssm", "repro_torch.models.rwkv",
            "repro_torch.train.optimizer", "repro_torch.train.train_step",
            "repro_torch.train.checkpoint", "repro_torch.train.loop",
            "repro_torch.data.pipeline",
            "repro_torch.launch.train",
            "repro_torch.core.hints", "repro_torch.core.dag",
            "repro_torch.core.topology", "repro_torch.core.wfcompiler",
            "repro_torch.core.scheduler", "repro_torch.core.simulator",
            "repro_torch.core.executor", "repro_torch.core.workloads",
            "repro_torch.analysis.lint",
            "repro_torch.analysis.__main__",
            "repro_torch.dist", "repro_torch.dist.sharding",
            "repro_torch.dist.hints", "repro_torch.dist.compression",
            "repro_torch.dist.collectives", "repro_torch.launch.mesh",
            "repro_torch.launch.specs", "repro_torch.train.elastic",
            "repro_torch.launch.dryrun", "repro_torch.launch.op_analysis",
            "repro_torch.launch.profile_cell", "repro_torch.examples",
            "repro_torch.examples.quickstart",
            "repro_torch.examples.serve_routed",
            "repro_torch.examples.train_lm",
            "repro_torch.examples.elastic_restart",
            "repro_torch.kernels.ops", "repro_torch.models.layers",
            "repro_torch.models.model"} <= set(mods)
    assert len(mods) > 20
    code = "\n".join([
        "import importlib, sys",
        "sys.modules['jax'] = None",
        "sys.modules['repro'] = None",
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]",
        f"for m in {mods!r} + ['chip_smoke']:",
        "    importlib.import_module(m)",
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))",
        "               for k in sys.modules if sys.modules[k] is not None)",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_the_sharded_step_runs_with_jax_and_repro_blocked():
    """The sharded step's entry points (``shard_model``, the placed state,
    the kernel ops on DTensors) on a one-rank gloo mesh, in a process where
    jax and the reference cannot be imported."""
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "sys.modules['repro'] = None",
        f"sys.path[:0] = [{str(ROOT / 'src')!r}]",
        "import torch",
        "from repro_torch.configs import get_smoke",
        "from repro_torch.dist.sharding import shard_model",
        "from repro_torch.launch.mesh import make_local_mesh",
        "from repro_torch.models import active_param_count, model as M",
        "from repro_torch.train.train_step import make_prefill_step, "
        "make_serve_step",
        "cfg = get_smoke('granite-3-2b')",
        "mesh = make_local_mesh(1, 1, device_type='cpu')",
        "model = shard_model(cfg, M.init_params(cfg, 0, device='cpu'), mesh)",
        "tok = torch.zeros((2, 8), dtype=torch.int32)",
        "logits, state = make_prefill_step(cfg, 16)(model, {'tokens': tok})",
        "step, _ = make_serve_step(cfg)(model, state, tok[:, :1])",
        "assert type(step).__name__ == 'DTensor'",
        "assert active_param_count(cfg) == M.param_count(cfg)",
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))",
        "               for k in sys.modules if sys.modules[k] is not None)",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_no_source_line_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in _IMPORT_LINE.finditer(f.read_text())]
    assert bad == []


def test_pattern_catches_what_it_must():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import x",
                 "import repro", "from repro.core import y", "  import repro.x"):
        assert _IMPORT_LINE.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import y",
                 "from jaxlib import z", "# import jax is forbidden here"):
        assert not _IMPORT_LINE.search(line), line


def test_default_device_refuses_to_run_on_cpu():
    from repro_torch.configs import get_smoke
    from repro_torch.serve.engine import TorchComputeBackend
    cfg = get_smoke("granite-3-2b")
    if torch.cuda.is_available():
        assert TorchComputeBackend(cfg, 32).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchComputeBackend(cfg, 32)


def test_train_entry_points_refuse_to_run_on_cpu():
    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import PrefetchingLoader
    from repro_torch.train.loop import TrainConfig, train
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(get_smoke("granite-3-2b"), TrainConfig(steps=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PrefetchingLoader(iter([]))


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo the
    script exits non-zero and prints no result."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
