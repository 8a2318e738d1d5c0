"""Quickstart: the paper's cross-layer stack in one run (the port of
``examples/quickstart.py``).

Build a hinted workflow (compiler layer), run it through the location-aware
store and the proactive scheduler (storage and runtime layers) with torch
bodies on the device, and compare the schedulers on the paper's Figure-2
scenario in the simulator.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

``quickstart_workflow``, ``quickstart_bodies`` and ``run_quickstart`` are the
graph and bodies ``chip_smoke.py``'s workflow phase runs on the card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import core as C
from repro_torch import resolve_device
from repro_torch.core.workloads import fig2_workflow

RAW_BYTES = 64 * 1024 * 1024          # the graph's @size of ``raw``


def quickstart_workflow() -> C.CompiledWorkflow:
    """The four-task graph (split, two FFTs, merge) with the paper's @
    annotations, compiled for the port's default hardware (one H100 per
    node)."""
    g = C.TaskGraph()
    g.add_data("raw", size_bytes=C.size_hint(RAW_BYTES))          # @size
    g.add_task("split", inputs=("raw",), outputs=("a", "b"),
               hints=C.task(compute="linear", io_ratio=0.5))      # @ratios
    g.add_task("fft_a", inputs=("a",), outputs=("fa",),
               hints=C.task(compute="nlogn", io_ratio=1.0))       # @complexity
    g.add_task("fft_b", inputs=("b",), outputs=("fb",),
               hints=C.task(compute="nlogn", io_ratio=1.0))
    g.add_task("merge", inputs=("fa", "fb"), outputs=("out",),
               hints=C.task(compute="linear", io_ratio=0.5))
    return C.compile_workflow(g)


def quickstart_bodies(dev: torch.device) -> dict:
    """The bodies as torch ops on ``dev``: the split (after one copy of
    ``raw`` to ``dev``), ``torch.fft.rfft`` and the merge's sum."""
    def split(raw):
        r = raw.to(dev, non_blocking=True)
        half = r.numel() // 2
        return {"a": r[:half], "b": r[half:]}

    return {
        "split": split,
        "fft_a": lambda a: {"fa": torch.fft.rfft(a).real.contiguous()},
        "fft_b": lambda b: {"fb": torch.fft.rfft(b).real.contiguous()},
        "merge": lambda fa, fb: {
            "out": float(fa.abs().sum() + fb.abs().sum())},
    }


def run_quickstart(raw: torch.Tensor, dev: torch.device, device_of=None):
    """(executor, result) of the graph through the proactive scheduler on
    2 nodes, its bodies on ``dev`` (``device_of`` maps a node to its
    device, as ``WorkflowExecutor`` takes it)."""
    wf = quickstart_workflow()
    for tid, fn in quickstart_bodies(dev).items():
        wf.graph.tasks[tid].fn = fn
    ex = C.WorkflowExecutor(wf, C.ProactiveScheduler(wf), n_nodes=2,
                            device_of=device_of,
                            inject_inputs={"raw": raw})
    return ex, ex.run()


def simulate_schedulers() -> list[str]:
    """The paper's comparison at cluster scale: Figure 2's workflow on 16
    nodes under FCFS, locality and proactive scheduling (the simulator's
    lines, as the reference prints them)."""
    wf_big = C.compile_workflow(fig2_workflow(flops_per_byte=20_000),
                                C.HPC_CLUSTER)
    lines = []
    for name, factory in [("fcfs      ", C.FCFSScheduler),
                          ("locality  ", C.LocalityScheduler),
                          ("proactive ", C.ProactiveScheduler)]:
        r = C.simulate(wf_big, factory, n_nodes=16, hw=C.HPC_CLUSTER)
        lines.append(f"  {name} makespan={r.makespan:7.1f}s  "
                     f"moved={r.bytes_moved/2**30:5.2f}GiB  "
                     f"hit={r.locality_hit_rate:5.1%}  "
                     f"io_wait={r.io_wait_total:6.1f}s")
    return lines


def run(device: str | torch.device | None = None) -> dict:
    """The quickstart on ``device``: 2^16 f32 values from seed 0 through the
    graph (both nodes on the device), then the simulated comparison."""
    dev = resolve_device(device)
    wf = quickstart_workflow()
    print("critical path:", " -> ".join(wf.critical_path))
    print("dataset sizes:",
          {k: f"{v/2**20:.0f}MiB" for k, v in wf.sizes.items()})
    raw = torch.from_numpy(np.random.default_rng(0).standard_normal(1 << 16)
                           .astype(np.float32))
    if dev.type == "cuda":
        raw = raw.pin_memory()
    device_of = None if dev.type == "cpu" else (lambda node: dev)
    _, res = run_quickstart(raw, dev, device_of)
    print(f"\nexecuted on {dev}: out={res.outputs['out']:.1f}  "
          f"wall={res.wall_seconds:.3f}s  "
          f"locality hit rate={res.locality_hit_rate:.0%}")
    print("\n16-node simulation (paper's comparison):")
    lines = simulate_schedulers()
    for line in lines:
        print(line)
    return {"out": res.outputs["out"], "wall_s": res.wall_seconds,
            "locality_hit_rate": res.locality_hit_rate,
            "critical_path": list(wf.critical_path), "simulation": lines}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
