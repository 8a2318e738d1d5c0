"""Canonical scientific-workflow DAGs used by tests and benchmarks.

``fig2_workflow`` reproduces the shape of the paper's Fig. 2 example (a Swift/T
script: two parallel analysis chains over a shared input, merged at the end).
The others are the standard shapes from the workflow-scheduling literature the
paper positions against: map-reduce, montage-like (diamond fan-in/out), and
random layered DAGs for property tests and scale sweeps.

All generators take sizes in bytes and return an *uncompiled* TaskGraph; run
:func:`repro_torch.core.wfcompiler.compile_workflow` to fill the rich metadata.

``flops_per_byte`` sets the compute intensity of every task. Scientific
kernels are O(10^3) FLOP/byte; the 2000 default puts task runtimes in the
seconds-per-GB regime the paper's platform operates in (so data movement is
meaningful but hideable — the regime the paper targets).
"""

from __future__ import annotations

import random

from repro_torch.core.dag import TaskGraph
from repro_torch.core.hints import Complexity, size_hint, task

__all__ = ["fig2_workflow", "mapreduce_workflow", "montage_workflow",
           "pipeline_chain_workflow", "random_layered_workflow",
           "serving_session_workflow", "training_epoch_workflow"]

MB = float(1 << 20)
GB = float(1 << 30)


def fig2_workflow(input_bytes: float = 4 * GB, *,
                  flops_per_byte: float = 2000.0) -> TaskGraph:
    """The paper's Fig. 2 script shape: read -> two parallel chains -> merge."""
    C = lambda law: Complexity(law, flops_per_byte=flops_per_byte)  # noqa: E731
    g = TaskGraph()
    g.add_data("raw", size_bytes=size_hint(input_bytes))
    g.add_task("split", inputs=("raw",), outputs=("part_a", "part_b"),
               hints=task(compute=C("linear"), io_ratio=0.5))
    g.add_task("filter_a", inputs=("part_a",), outputs=("fa",),
               hints=task(compute=C("linear"), io_ratio=0.25))
    g.add_task("filter_b", inputs=("part_b",), outputs=("fb",),
               hints=task(compute=C("linear"), io_ratio=0.25))
    g.add_task("analyze_a", inputs=("fa",), outputs=("ra",),
               hints=task(compute=C("nlogn"), io_ratio=0.1))
    g.add_task("analyze_b", inputs=("fb",), outputs=("rb",),
               hints=task(compute=C("nlogn"), io_ratio=0.1))
    g.add_task("merge", inputs=("ra", "rb"), outputs=("result",),
               hints=task(compute=C("linear"), io_ratio=1.0))
    g.mark_sink("result")
    return g


def mapreduce_workflow(n_map: int = 64, n_reduce: int = 8,
                       shard_bytes: float = 512 * MB, *,
                       flops_per_byte: float = 2000.0) -> TaskGraph:
    C = lambda law: Complexity(law, flops_per_byte=flops_per_byte)  # noqa: E731
    g = TaskGraph()
    for i in range(n_map):
        g.add_data(f"shard{i}", size_bytes=size_hint(shard_bytes))
        g.add_task(f"map{i}", inputs=(f"shard{i}",),
                   outputs=tuple(f"m{i}_r{j}" for j in range(n_reduce)),
                   hints=task(compute=C("linear"), io_ratio=0.2))
    for j in range(n_reduce):
        g.add_task(f"reduce{j}",
                   inputs=tuple(f"m{i}_r{j}" for i in range(n_map)),
                   outputs=(f"out{j}",),
                   hints=task(compute=C("linear"), io_ratio=0.05))
    g.add_task("collect", inputs=tuple(f"out{j}" for j in range(n_reduce)),
               outputs=("final",), hints=task(compute=C("linear")))
    g.mark_sink("final")
    return g


def montage_workflow(width: int = 32, tile_bytes: float = 256 * MB, *,
                     flops_per_byte: float = 2000.0) -> TaskGraph:
    """Montage-like mosaic: project each tile, pairwise-diff neighbours,
    fit a background model, correct every tile, then co-add."""
    C = lambda law: Complexity(law, flops_per_byte=flops_per_byte)  # noqa: E731
    g = TaskGraph()
    for i in range(width):
        g.add_data(f"tile{i}", size_bytes=size_hint(tile_bytes))
        g.add_task(f"project{i}", inputs=(f"tile{i}",), outputs=(f"proj{i}",),
                   hints=task(compute=C("linear"), io_ratio=1.2))
    for i in range(width - 1):
        g.add_task(f"diff{i}", inputs=(f"proj{i}", f"proj{i+1}"),
                   outputs=(f"fit{i}",), hints=task(compute=C("linear"),
                                                    io_ratio=0.01))
    g.add_task("bgmodel", inputs=tuple(f"fit{i}" for i in range(width - 1)),
               outputs=("model",), hints=task(compute=C("nlogn"), io_ratio=1.0))
    for i in range(width):
        g.add_task(f"correct{i}", inputs=(f"proj{i}", "model"),
                   outputs=(f"corr{i}",), hints=task(compute=C("linear"),
                                                     io_ratio=1.0))
    g.add_task("coadd", inputs=tuple(f"corr{i}" for i in range(width)),
               outputs=("mosaic",), hints=task(compute=C("linear"), io_ratio=0.5))
    g.mark_sink("mosaic")
    return g


def random_layered_workflow(n_layers: int = 8, width: int = 16, *,
                            seed: int = 0, fan_in: int = 3,
                            bytes_lo: float = 16 * MB,
                            bytes_hi: float = 2 * GB,
                            flops_per_byte: float = 2000.0) -> TaskGraph:
    """Random layered DAG (each task reads 1..fan_in outputs from the previous
    layer) — the adversarial shape for property tests."""
    rng = random.Random(seed)
    C = lambda law: Complexity(law, flops_per_byte=flops_per_byte)  # noqa: E731
    g = TaskGraph()
    prev: list[str] = []
    for i in range(width):
        name = f"ext{i}"
        g.add_data(name, size_bytes=size_hint(rng.uniform(bytes_lo, bytes_hi)))
        prev.append(name)
    for layer in range(n_layers):
        cur: list[str] = []
        for i in range(width):
            k = rng.randint(1, min(fan_in, len(prev)))
            ins = tuple(rng.sample(prev, k))
            out = f"d{layer}_{i}"
            g.add_task(f"t{layer}_{i}", inputs=ins, outputs=(out,),
                       hints=task(compute=C(rng.choice(["linear", "nlogn"])),
                                  io_ratio=rng.uniform(0.05, 1.5)))
            cur.append(out)
        prev = cur
    g.add_task("sink", inputs=tuple(prev), outputs=("final",),
               hints=task(compute=C("linear"), io_ratio=0.01))
    # only the last layer feeds the sink; unsampled d<layer>_<i> outputs are
    # intentionally dead (see analysis_allowlist.json)
    g.mark_sink("final")
    return g


def serving_session_workflow(n_sessions: int = 8, n_turns: int = 4, *,
                             kv_bytes: float = 256 * MB,
                             prompt_bytes: float = 64 * 1024.0,
                             flops_per_byte: float = 2000.0,
                             compute_skew: float = 0.35) -> TaskGraph:
    """Multi-turn serving AS a workflow — a session's KV cache is the paper's
    "file". Per session: a ``prefill`` task turns the first prompt into
    ``kv_<s>_0``; each follow-up ``turn`` task consumes the previous turn's
    KV cache plus a fresh (tiny, external) prompt and produces the next KV
    cache. The KV chain is what a locality scheduler must keep on one node:
    every migrated turn re-moves ``kv_bytes``, the sim analogue of the
    serving engine's re-prefill. ``compute_skew`` spreads per-session turn
    durations (session s runs at ``1 + s*skew`` relative cost) so turn
    completions desynchronize — with identical durations every chain's next
    turn is the only ready task the moment its producer's node frees up, and
    even FCFS gets accidental 100% locality."""
    g = TaskGraph()
    for s in range(n_sessions):
        C = lambda law: Complexity(law, flops_per_byte=flops_per_byte  # noqa: E731,E501
                                   * (1.0 + s * compute_skew))
        g.add_data(f"prompt{s}_0", size_bytes=size_hint(prompt_bytes))
        g.add_data(f"kv{s}_0", size_bytes=size_hint(kv_bytes))
        g.add_task(f"prefill{s}", inputs=(f"prompt{s}_0",),
                   outputs=(f"kv{s}_0",), hints=task(compute=C("linear")))
        for t in range(1, n_turns):
            g.add_data(f"prompt{s}_{t}", size_bytes=size_hint(prompt_bytes))
            g.add_data(f"kv{s}_{t}", size_bytes=size_hint(kv_bytes))
            g.add_task(f"turn{s}_{t}",
                       inputs=(f"kv{s}_{t-1}", f"prompt{s}_{t}"),
                       outputs=(f"kv{s}_{t}",),
                       hints=task(compute=C("linear")))
        g.mark_sink(f"kv{s}_{n_turns - 1}")   # last turn's KV is the result
    return g


def pipeline_chain_workflow(n_chains: int = 8, depth: int = 6, *,
                            stage_bytes: float = 512 * MB,
                            flops_per_byte: float = 2000.0) -> TaskGraph:
    """Parallel deep pipelines — the failure-sensitivity stress shape.

    Each chain is ``depth`` sequential stages, every intermediate consumed by
    exactly one successor, so under compute-on-data-path each stage's output
    is a *sole copy* on the node that produced it: losing that node before
    the next stage reads it re-runs the producer. The rerun exposure of a
    durability window is therefore proportional to how many stages sit
    un-flushed when a failure hits — the quantity a failure sweep varies.
    A final sink joins the chains (one task; its fan-in is not the point)."""
    C = lambda law: Complexity(law, flops_per_byte=flops_per_byte)  # noqa: E731
    g = TaskGraph()
    finals = []
    for c in range(n_chains):
        g.add_data(f"src{c}", size_bytes=size_hint(stage_bytes))
        prev = f"src{c}"
        for s in range(depth):
            out = f"c{c}_s{s}"
            g.add_task(f"stage{c}_{s}", inputs=(prev,), outputs=(out,),
                       hints=task(compute=C("linear"), io_ratio=0.3))
            prev = out
        finals.append(prev)
    g.add_task("join", inputs=tuple(finals), outputs=("final",),
               hints=task(compute=C("linear"), io_ratio=0.05))
    g.mark_sink("final")
    return g


def training_epoch_workflow(n_steps: int = 8, n_dp: int = 4, *,
                            batch_bytes: float = 64 * MB,
                            ckpt_every: int = 4,
                            step_flops: float = 1e12) -> TaskGraph:
    """A training epoch AS a workflow — how the framework itself uses the
    paper's machinery: per-step data-load tasks feeding per-shard train tasks,
    periodic checkpoint tasks consuming the updated state."""
    g = TaskGraph()
    g.add_data("corpus", size_bytes=size_hint(n_steps * n_dp * batch_bytes))
    g.add_data("params0", size_bytes=size_hint(2 * GB))
    prev_params = "params0"
    for s in range(n_steps):
        batches = []
        for d in range(n_dp):
            b = f"batch_{s}_{d}"
            g.add_task(f"load_{s}_{d}", inputs=("corpus",), outputs=(b,),
                       hints=task(compute="const",
                                  io_ratio=1.0 / (n_steps * n_dp)))
            batches.append(b)
        new_params = f"params{s+1}"
        g.add_task(f"step_{s}", inputs=(prev_params, *batches),
                   outputs=(new_params,),
                   hints=task(compute=Complexity("const",
                                                 flops_per_byte=step_flops),
                              io_ratio=1.0, procs=n_dp))
        if (s + 1) % ckpt_every == 0:
            g.add_task(f"ckpt_{s}", inputs=(new_params,),
                       outputs=(f"ckpt_file_{s}",),
                       hints=task(compute="const", io_ratio=1.0))
            g.mark_sink(f"ckpt_file_{s}")
        prev_params = new_params
    if not g.data[prev_params].consumers:   # epoch length not a ckpt multiple
        g.mark_sink(prev_params)
    return g
