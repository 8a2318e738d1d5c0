"""The benchmark of ``repro_torch`` on one NVIDIA H100: one cell, one run.

    python3 bench/run.py --workload granite-3-2b.chat --seed 7 --seconds 51 --trace 0

Reads the cell from ``BENCHMARK.json``, makes its inputs and weights from
``--seed``, sets up (counted in ``setup_s``), measures for ``--seconds``,
checks what the timed path produced against the plain reference, and
prints one JSON line last on standard output: the end-to-end metrics with
``--trace 0``, the per-layer metrics (from a profiled slice of the window)
with ``--trace 1``. Each number compared is printed beside its limit at the
end of standard error and under ``limits`` in that line.

No result is printed, and the exit code is not 0, when there is no CUDA
card (or fewer than the cell asks for), when the program is missing, or
when the process holds ``jax``, ``jaxlib``, ``flax`` or ``repro`` once the
window has closed.
"""

from __future__ import annotations

import time

T0_WALL = time.time()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
# every cache of a run stays at a fixed path inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
# one process, few threads: the host's other work is the noise of a run
os.environ.setdefault("OMP_NUM_THREADS", "1")

import harness  # noqa: E402


@dataclasses.dataclass
class Ctx:
    """What a driver gets: the cell, the run's arguments, the device."""

    cell: harness.Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t0_wall: float


def run_cell(cell: harness.Cell, seed: int, seconds: float, trace: bool,
             device: str, t0_wall: float) -> tuple[harness.Record, dict,
                                                   dict | None]:
    """Drive one run of ``cell`` on ``device``; returns the record, the
    metrics of the result line and the breakdown (traced runs)."""
    driver = importlib.import_module(f"drivers.{cell.driver}")
    rec = driver.run(Ctx(cell, seed, seconds, trace, device, t0_wall))
    if not trace:
        metrics = {m["name"]: {"value": rec.values[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in rec.values}
        return rec, metrics, None
    metrics = harness.per_layer_values(cell, rec)
    prof = rec.profile
    breakdown = None if prof is None else {
        "device_ops": prof.top_kernels(10), "idle_gaps": prof.top_idle(10)}
    return rec, metrics, breakdown


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    import repro_torch  # noqa: F401  (the program under test)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"no result: {args.workload} needs {cell.chips} CUDA card(s), "
              f"this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    rec, metrics, breakdown = run_cell(cell, args.seed, args.seconds,
                                       bool(args.trace), "cuda", T0_WALL)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"no result: the process holds {bad} after the window",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(rec.memory_peak_bytes)}
    if args.trace:
        prof = rec.profile
        device["busy_s"] = prof.busy_s if prof is not None else 0.0
        device["window_s"] = prof.window_s if prof is not None else 0.0
    device["card"] = _power_limit()
    for k, v in sorted(rec.counters.items()):
        print(f"count {k}: {v}", file=sys.stderr)
    for k, v in sorted(rec.notes.items()):
        print(f"note {k}: {v}", file=sys.stderr)
    for line in harness.check_lines(rec):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(rec, metrics, device, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
