"""Per-cell profiler on the card: one (arch x shape) cell's step at
published width, and which ops it spends its time in (the counterpart of
``repro.launch.profile_cell``).

The reference compiles one dry-run cell and prints its top collectives and
top dot instructions with their while-loop multiplicities. This module runs
the port's step for the cell on ``cuda:0``, at one data rank's share of the
chosen mesh (the batch ``dryrun.data_rank_batch`` gives), with random weights
from ``--seed``, and prints:

  * the step's wall time and the device's busy time, the union of the
    device events' spans under ``torch.profiler`` (:func:`busy_ms`), and the
    idle share;
  * the top kernels by device time, each with its count per step;
  * what the step dispatches (:mod:`launch.op_analysis`): its matmul FLOPs
    with the attention kernels' own work, the top matmul groups with their
    multiplicities, and the collectives (none on one card);
  * K1 and K2 launches per step, the cell's peak memory (the most the
    caching allocator held above what the process held before the cell was
    built), and the MFU against 989 TFLOP/s (H100 SXM dense bf16).

Depth is cut only with ``--layers``; microbatches are raised only with
``--microbatches`` (where one card cannot hold the cell); both are printed
as ``reduced``. ``--device cpu`` runs the family's smoke config at a small
batch and sequence, for the tests.

  python -m repro_torch.launch.profile_cell --arch granite-3-2b --shape decode_32k
  python -m repro_torch.launch.profile_cell --arch granite-3-2b --shape train_4k --layers 4
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import SHAPES, get_config, get_smoke
from repro_torch.launch import dryrun
from repro_torch.launch import op_analysis as OA

PEAK_BF16_FLOPS = 989e12          # H100 SXM dense bf16 (NVIDIA data sheet)
# record_function ranges of the port's steps (the plain attention backward,
# AdamW): their device spans cover other events and the gaps between them
RANGES = ("flash_attention_bwd_plain", "adamw_update")
_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                 "cuLaunchKernelEx")


# ---------------------------------------------------------- device time
def busy_ms(intervals) -> float:
    """Length of the union of ``[start, end)`` intervals (the device's busy
    time, in the intervals' unit): an instant covered by two events (a copy
    on a side stream under a kernel) counts once."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def device_intervals(prof) -> list[tuple[float, float]]:
    """The profiled device events' spans in ms (kernels, copies, memsets);
    the annotation ranges' device spans, which cover other events and the
    gaps between them, are left out."""
    from torch.autograd import DeviceType
    return [(e.time_range.start / 1e3, e.time_range.end / 1e3)
            for e in prof.events()
            if getattr(e, "device_type", DeviceType.CPU) != DeviceType.CPU
            and not getattr(e, "is_user_annotation", False)
            and e.key not in RANGES]


def profile(what: str, fn, reps: int, top: int = 8,
            warmup: bool = True) -> dict:
    """Device time by kernel over ``reps`` calls of ``fn`` (torch.profiler),
    the host-side kernel launches per call, and the device's idle share
    against the calls' wall time measured without the profiler; busy time is
    the union of the device events' spans (``busy_ms``). One call warms up
    first unless the caller has made one (``warmup=False``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    if warmup:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    prof_wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    # device events only (kernels, copies): an aten op's self device time
    # is that of the kernels it launched, which are listed as well
    averages = prof.key_averages()
    rows = [(e.key, e.count) for e in averages]
    dev = [(e.key, e.self_device_time_total / 1e3 / reps, e.count / reps)
           for e in averages
           if getattr(e, "device_type", DeviceType.CPU) != DeviceType.CPU
           and e.self_device_time_total > 0 and e.key not in RANGES]
    dev.sort(key=lambda r: -r[1])
    busy = busy_ms(device_intervals(prof)) / reps
    launches = sum(c for k, c in rows if k in _LAUNCH_CALLS) / reps
    out = {"device_busy_ms": busy, "wall_ms": wall,
           "device_event_sum_ms": sum(t for _, t, _ in dev),
           "wall_ms_under_profiler": prof_wall_ms,
           "idle_share": (1.0 - busy / wall) if wall > 0 else None,
           "host_launches": launches,
           "top": [(k[:60], round(t, 4), round(n, 1)) for k, t, n in dev[:top]]}
    if busy == 0.0:
        print(f"  profile {what}: the profiler saw no device time "
              f"(not measured)", flush=True)
    else:
        print(f"  profile {what}: device busy {busy:.3f} ms of {wall:.3f} "
              f"ms wall (idle share {out['idle_share']:.3f}); "
              f"{launches:.0f} kernel launches per call", flush=True)
        for k, t, n in dev[:top]:
            print(f"    {t:9.4f} ms  x{n:6.1f}  {k[:90]}", flush=True)
    return out


# ----------------------------------------------------------------- a cell
def cell_config(arch: str, shape_name: str, *, device: str = "cuda",
                layers: int | None = None, mesh: str = "pod1"):
    """``(cfg, shape, B, reduced)``: the cell's config, shape and data rank's
    batch, and the cuts as text. On the CPU: the family's smoke config at a
    sequence of 64 and a batch of one row a microbatch (at least 2)."""
    full = get_config(arch)
    shape = SHAPES[shape_name]
    B = dryrun.data_rank_batch(full, shape, dryrun.abstract_mesh(mesh))
    reduced = []
    cfg = full
    if torch.device(device).type == "cpu":
        cfg = get_smoke(arch)
        b = max(2, dryrun.microbatches_for(full, shape)[0])
        reduced += [f"smoke config ({cfg.name})", f"seq {shape.seq_len} -> 64"]
        reduced += [f"batch {B} -> {b}"] if b != B else []
        shape = dataclasses.replace(shape, seq_len=64)
        B = b
    if layers is not None and layers != cfg.n_layers:
        reduced.append(f"layers {cfg.n_layers} -> {layers}")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg, shape, B, reduced


def profile_cell(arch: str, shape_name: str, mesh: str = "pod1", *,
                 device: str | torch.device = "cuda", seed: int = 0,
                 layers: int | None = None, microbatches: int | None = None,
                 top: int = 14) -> dict:
    """Runs and measures one cell (see the module's docstring) and returns
    what it printed as a dict. The step is called once under the op
    counter (on ``cuda`` that call is the warm-up), then timed and profiled
    (``reps`` calls each: 5 for a decode step, else 1; on the CPU one
    timed call)."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    dev = resolve_device(device)
    cfg, shape, B, reduced = cell_config(arch, shape_name, device=dev.type,
                                         layers=layers, mesh=mesh)
    mb_recipe = dryrun.microbatches_for(get_config(arch), SHAPES[shape_name])[0]
    mb = microbatches or mb_recipe
    if shape.kind == "train" and mb != mb_recipe:
        reduced.append(f"microbatches {mb_recipe} -> {mb}")
    reps = 5 if shape.kind == "decode" else 1
    on_card = dev.type == "cuda"
    print(f"== {arch} {shape_name} {mesh} on {dev}: {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, batch {B} (one data rank's), seq "
          f"{shape.seq_len}" + (f", {mb} microbatches" if shape.kind ==
                                "train" else "")
          + f"; reduced: {reduced or 'nothing'}", flush=True)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        held_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cell = dryrun.cell_step(cfg, shape, B, device=dev, seed=seed,
                            microbatches=mb)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    res = {"arch": arch, "shape": shape_name, "mesh": mesh, "device": str(dev),
           "reduced": reduced, "layers": cfg.n_layers, "batch": B,
           "seq": shape.seq_len, "microbatches": mb if shape.kind == "train"
           else 1, "setup_s": setup_s}

    flash_attention.launches = 0
    decode_attention.launches = 0
    a = OA.analyze(cell.run, params=cell.model, live_rows=cell.live_rows)
    out = a.pop("out")
    logits = out[0] if isinstance(out, tuple) else out["loss"]
    res["finite"] = bool(torch.isfinite(logits.float()).all())
    del out, logits
    res.update(dot_flops=a["dot_flops"], result_bytes=a["result_bytes"],
               collective_total=a["collective_total"],
               top_dots=OA.top_dots(a, top),
               top_collectives=OA.top_collectives(a, top))
    if on_card:                         # the counted call was the warm-up
        prof = profile(f"one {shape.kind} step", cell.run, reps, top=top,
                       warmup=False)
        calls = 1 + 2 * reps
        res.update(wall_ms=prof["wall_ms"], device_busy_ms=prof["device_busy_ms"],
                   idle_share=prof["idle_share"],
                   host_launches=prof["host_launches"],
                   top_kernels=prof["top"])
    else:
        t0 = time.perf_counter()
        cell.run()
        res["wall_ms"] = 1e3 * (time.perf_counter() - t0)
        calls = 2
    res["launches"] = {"flash_attention": flash_attention.launches / calls,
                       "decode_attention": decode_attention.launches / calls}
    if on_card:
        res["held_before_bytes"] = held_before
        res["peak_memory_bytes"] = torch.cuda.max_memory_allocated() \
            - held_before
        wall_s = res["wall_ms"] / 1e3
        res["dispatched_tflops"] = a["dot_flops"] / wall_s / 1e12
        res["mfu"] = a["dot_flops"] / (wall_s * PEAK_BF16_FLOPS)
        if shape.kind == "train":
            model_flops = 3 * OA.forward_flops(cfg, B, shape.seq_len)
            res["model_flops"] = model_flops
            res["mfu_model_flops"] = model_flops / (wall_s * PEAK_BF16_FLOPS)
    _print(res)
    return res


def _print(res: dict) -> None:
    if "device_busy_ms" in res:
        print(f"step wall {res['wall_ms']:.3f} ms, device busy "
              f"{res['device_busy_ms']:.3f} ms, idle share "
              f"{res['idle_share']:.4f}; the cell's peak memory "
              f"{res['peak_memory_bytes'] / 2**30:.2f} GiB (above "
              f"{res['held_before_bytes'] / 2**30:.2f} GiB held before)",
              flush=True)
        print(f"dot_flops {res['dot_flops']:.6e} ({res['dispatched_tflops']:.1f}"
              f" TFLOP/s dispatched; MFU {res['mfu']:.4f} against "
              f"{PEAK_BF16_FLOPS:.3g})" + (
                  f"; model FLOPs 3 x forward {res['model_flops']:.6e}, MFU "
                  f"{res['mfu_model_flops']:.4f}" if "model_flops" in res
                  else ""), flush=True)
    else:
        print(f"step wall {res['wall_ms']:.3f} ms on the CPU; dot_flops "
              f"{res['dot_flops']:.6e}", flush=True)
    print(f"launches per step: K1 flash_attention "
          f"{res['launches']['flash_attention']:g}, K2 decode_attention "
          f"{res['launches']['decode_attention']:g}; output finite: "
          f"{res['finite']}", flush=True)
    print("top dots (FLOPs over the step x runs):", flush=True)
    for row in res["top_dots"]:
        print("  " + row, flush=True)
    if res["top_collectives"]:
        print("top collectives:", flush=True)
        for row in res["top_collectives"]:
            print("  " + row, flush=True)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=tuple(SHAPES))
    ap.add_argument("--mesh", default="pod1", choices=("pod1", "pod2"))
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="raise the train step's microbatches (memory)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=14)
    args = ap.parse_args(argv)
    return profile_cell(args.arch, args.shape, args.mesh, device=args.device,
                        seed=args.seed, layers=args.layers,
                        microbatches=args.microbatches, top=args.top)


if __name__ == "__main__":
    main()
