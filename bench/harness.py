"""What every cell shares: the spec, the run's record, the result line.

``BENCHMARK.json`` names each cell's configuration and traffic; the
configuration's sizes are ``bench/configs/<config>.json``, the traffic's
parameters ``bench/mixes/<traffic>.json``, whose ``driver`` names the loop
in ``bench/drivers/<driver>.py``; each per-layer metric is read by
``bench/metrics/<metric>.py``; what the benchmark knows of the model's
family (its weights' init, its FLOPs, its attention calls) is
``bench/families/<family>.py``. Nothing here names a cell or a family: a
later cell, metric or family is a new file and a new entry.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names the run may not hold once its window has closed:
# the JAX reference package and JAX itself (compared whole: the port's
# name begins with the reference's)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of the benchmark by its file (metric files carry dots in
    their names, so they are not importable by name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of the spec with everything it names, loaded."""

    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def driver(self) -> str:
        return self.mix["driver"]


def load_cell(name: str, spec: dict | None = None, bench: Path = BENCH
              ) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its config, its mix,
    and the metrics it reports: the end-to-end metrics listed for it (or
    for every cell), and the per-layer metrics whose ``workloads`` list it
    (or, without the key, whose end-to-end metric it reports)."""
    spec = spec if spec is not None else load_json(bench.parent
                                                   / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({sorted(cells)})")
    w = cells[name]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = load_json(bench.parent / conf["file"])
    family_rules(config["model"], bench / "families")
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return Cell(name=name, chips=int(w["chips"]),
                config=config,
                mix=load_json(bench / "mixes" / f"{w['traffic']}.json"),
                end_to_end=e2e, per_layer=layer)


def family_rules(model: dict, families: Path = BENCH / "families"):
    """The module ``<families>/<family>.py`` of the configuration's model
    family (``model["family"]``). It imports nothing of the program and
    defines:

    - ``leaf_init(name, shape, model) -> (scale, shift)``: the leaf is drawn
      from N(shift, scale^2), a constant ``shift`` where scale is 0; a leaf
      it has no rule for raises ValueError;
    - ``serve_flops(model, prefill_lengths, decode_tokens, decode_ctx)``:
      the model FLOPs of a serving window;
    - ``attention_calls(model) -> [(Hq, Hkv, hd, dv, window), ...]``: the
      K1 calls of one prefill, which are the K2 calls of one decode step,
      one entry a call.

    Raises FileNotFoundError, naming the file to add, where there is none.
    """
    path = families / f"{model['family']}.py"
    if not path.is_file():
        raise FileNotFoundError(
            f"no rules for model family {model['family']!r}: add {path} "
            f"(leaf_init, serve_flops, attention_calls)")
    return load_module(path, "bench_family_" + model["family"])


@dataclasses.dataclass
class Record:
    """What a driver hands to the metric readers and the result line.

    ``values``: the end-to-end metrics it measured by name. ``spans``:
    host seconds of each call of a named boundary in the window.
    ``counters``: counts over the window. ``profile``: the traced slice
    (:class:`bench.work.busy.TraceSlice`) or None. ``work``: the shapes
    the window dispatched (K1 cases, K2 cases with their lengths, FLOPs).
    ``checks``: (name, value, limit, passed) of every number compared."""

    values: dict[str, float] = dataclasses.field(default_factory=dict)
    spans: dict[str, list[float]] = dataclasses.field(default_factory=dict)
    counters: dict[str, float] = dataclasses.field(default_factory=dict)
    profile: Any = None
    work: dict[str, Any] = dataclasses.field(default_factory=dict)
    checks: list[tuple[str, float, float, bool]] = dataclasses.field(
        default_factory=list)
    attempted: int = 0
    failed: int = 0
    window_s: float = 0.0
    memory_peak_bytes: int = 0
    notes: dict[str, Any] = dataclasses.field(default_factory=dict)

    def check(self, name: str, value: float, limit: float, passed: bool
              ) -> None:
        self.checks.append((name, float(value), float(limit), bool(passed)))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c[3] for c in self.checks)


def per_layer_values(cell: Cell, rec: Record, bench: Path = BENCH
                     ) -> dict[str, dict]:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        reader = load_module(bench / "metrics" / f"{m['name']}.py",
                             "bench_metric_" + m["name"].replace(".", "_"))
        v = reader.read(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_loaded(modules=None) -> list[str]:
    """Top-level names in ``sys.modules`` that the run may not hold."""
    mods = sys.modules if modules is None else modules
    tops = {k.split(".", 1)[0] for k in mods}
    return sorted(tops & set(FORBIDDEN))


def result_line(rec: Record, metrics: dict, device: dict,
                breakdown: dict | None) -> str:
    """The last line of standard output. ``limits`` comes last: each
    number compared with its limit."""
    out = {"correct": rec.correct, "attempted": int(rec.attempted),
           "failed": int(rec.failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["limits"] = {name: {"value": v, "limit": lim, "ok": ok}
                     for name, v, lim, ok in rec.checks}
    return json.dumps(out)


def check_lines(rec: Record) -> list[str]:
    """The compared numbers, one a line, for the end of standard error."""
    return [f"check {name}: {v!r} limit {lim!r} {'ok' if ok else 'FAIL'}"
            for name, v, lim, ok in rec.checks]
