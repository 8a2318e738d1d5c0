#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one H100 and check every kernel on its path.

    python3 chip_smoke.py                          # the whole check
    python3 chip_smoke.py --sweep-decode-chunks    # decode chunk sizes only
    python3 chip_smoke.py --probe-consistency      # zamba2 decode vs prefill
    python3 chip_smoke.py --train-phase ARCH B S   # one family's train phase

Run from the root of a checkout, on a machine with one CUDA card. It imports
nothing of JAX and nothing of the reference package ``repro``; it builds the
port's kernels from ``src/repro_torch/kernels/csrc`` with nvcc and then:

1. prints the card (``nvidia-smi`` name and power limit, torch's device name
   and count);
2. prints the build (seconds, and ptxas' registers / spills per kernel);
3. holds each kernel against its plain PyTorch version on the card, in f32
   and bf16, at every serving path's shapes and every train step's (K1 at
   granite's B4 S4096 and the other families' train shapes), the
   reference's edge shapes and
   the redesigned kernels' own edges (ragged tiles, offsets, windows that cut
   a tile or a chunk), and times kernel, plain version and PyTorch library
   calls (``scaled_dot_product_attention``, a yardstick only) on the device:
   each timed loop is captured in a CUDA graph and replayed between two
   events, so the host's enqueue work is not in the time; the host enqueue
   time per wrapper call is printed on its own line;
4. serves granite-3-2b at full published width (40 layers, bf16, random
   weights from a seed) with two ServingEngines on one tiered LocStore behind
   the Router: 12 sessions, 32 pooled decode steps, a park + warm + resume
   checked token for token against a never-parked control, and two
   follow-ups; the kernels' launch counts over that run must equal what the
   path implies (40 per prefill, 40 per decode step);
5. serves gemma3-12b at full width with its depth cut to 6 layers (one 5:1
   local:global group) so the run stays inside its time limit: one engine, a
   1536-token prompt (longer than the 1024 window), 16 decode steps;
6. serves whisper-medium at its published width and depth (2 engines x 8
   slots, max_seq 448, seeded frames), llama-3.2-vision-90b at published
   width cut to 10 layers (2 groups of 4 self + 1 cross, gates opened,
   seeded patches) and deepseek-v3-671b at published width cut to 4 layers
   (3 dense + 1 MoE of 256 experts): per phase TTFT, decode step wall and
   device time, the kernels' launches per prefill and per step (checked
   against the path), KV bytes per session, peak memory, and a parked
   session resumed token for token against a never-parked control; each
   phase's models, engines and stores are freed before the next;
7. serves the recurrent families at published width and full depth, the
   same way: zamba2-7b (81 Mamba2 layers, the one shared attention block
   applied at 13 points: 13 flash launches per prefill, 13 decode launches
   per step, at head dim 112) and rwkv6-1.6b (no attention: no kernel
   launch; a session's state is the same 12,976,132 bytes at any length);
8. drives a short seeded trace through the port's TraceDriver over two
   granite-3-2b engines (real prefills, modeled service times) and prints
   its TraceReport beside the measured prefill seconds;
9. trains granite-3-2b at published width and depth (40 layers, bf16
   weights, f32 AdamW moments, random weights from a seed) through
   ``repro_torch.train.loop.train``: 3 steps of 8 x 4096 tokens in 2
   microbatches, the flash kernel as the forward of its autograd node (160
   launches a step: forward and per-layer recompute, 40 layers, 2
   microbatches; no plain attention forward), the plain chunked backward
   (80 a step); the same steps with f32 weights as a witness of the bf16
   losses; then one step under the profiler (device busy time as the union
   of the device events' spans, idle share, time of K1, GEMMs, the plain
   backward and AdamW), the gradient check against ``impl="plain"`` (depth
   2, f32 and bf16; a forward with a planted fault must fail it) and the
   restart check (depth 4, checkpoints every 2 steps, a failure at step 5);
10. trains the other families at published width (``TRAIN_PHASES``):
   whisper-medium (24 + 24 layers, B8 S448 with seeded frames), llama-3.2-
   vision-90b (5 layers: one group, gates opened, B2 S1024 with seeded
   patches, bf16 moments), deepseek-v3-671b (4 layers + MTP, B1 S1024; the
   loss and its gradient only: one card cannot hold its AdamW state),
   zamba2-7b (81 + 13 shared-block applications, B2 S2048, bf16 moments)
   and rwkv6-1.6b (24 layers, B64 S64: its token-by-token scan launches
   per token, so the same 4,096 tokens as B4 S1024 in 1/16 of the
   launches): 3 steps each, the third profiled;
   K1 launches checked every step against 2 x attention applications (+1
   for MTP), plain backwards against the applications, no plain forward and
   no decode kernel; the step's model FLOPs from its matmuls
   (``forward_flops``); a gradient check per family with attention at
   published width and a small depth (f32 and bf16, the planted fault
   failing it), every binding of ``attention_op`` swapped;
11. runs the paper's workflow layer on the card through
   ``repro_torch.core.WorkflowExecutor`` and the ProactiveScheduler. The
   quickstart's four-task graph (split, two FFTs, merge) over 64 MiB of
   pinned f32 on 2 nodes mapped to cuda:0, its bodies torch ops on the
   card, held to the same graph with CPU bodies (rtol 1e-4); then a
   training epoch as a workflow: ``epoch_workflow`` for granite-3-2b at
   published width, depth cut to 4, 4 steps of 8 x 4096 tokens in 2
   microbatches, each step's batch loaded by 4 tasks as pinned host rows,
   on 4 nodes mapped to cuda:0 and a store whose top tier is the card's
   HBM, so the scheduler's prefetches stage batches to the card on a side
   stream while a step computes. Its losses must equal ``train()``'s over
   the same corpus, seed and optimizer (rtol 1e-5; bit-identity printed),
   K1 must launch 16 times a step with no plain forward and no K2, bytes
   must be prefetched and at least one batch must reach its step through
   ``device_copy``; each task's io_wait and run, the workflow's and the
   loop's walls, and the store's movement report are printed;
12. runs ``repro_torch.dist`` on a one-rank NCCL group and a ("data",
   "model") 1x1 DeviceMesh on cuda:0 (``dist_phase``): deepseek-v3-671b at
   published width, 4 layers + MTP, B1 S1024, its loss and gradient once
   unmeshed (the global MoE path) and once under ``sharding_rules(mesh)``
   (the sharded path; K1 9 launches, K2 none), held bit for
   bit by per-leaf fingerprints computed on the card (the router, norm and
   attention leaves also whole on the host) or else by the bf16
   gradient-check bound; granite-3-2b at published width, 4 layers, two
   AdamW steps of 8 x 4096 tokens in 2 microbatches with ``grad_specs``
   under the rules against the same steps unmeshed, bit for bit (K1 16 a
   step, K2 none); ``wrap_grads`` of a gradient over the NCCL "data" group (mean +
   new_err against g, and its device time and wire bytes beside a bf16
   all-reduce of the same tree); that state saved in the reference's format
   and restored with ``elastic_restore`` onto the mesh, bit for bit with
   ``param_specs``' placements; the sharded step (``dist_tp``):
   granite-3-2b (4 layers) through ``shard_model``, two AdamW steps of
   8 x 4096 in 2 microbatches, a prefill of 4 x 1024 and 8 decode steps on
   DTensors bit for bit against the unmeshed run, K1 / K2 launches equal
   (16 a step, 4 a prefill, K2 4 a decode step), a decode step's host wall
   DTensor against plain, and deepseek-v3's gradient once more through
   ``shard_model`` (``run_sharded``), bit for bit against the unmeshed one;
   and the host cost of the ``hint`` and
   ``tp_divides`` sites in one granite-3-2b decode step (``hint_sites``);
   (before it, 11a and 11b:)
11a. the launch phase (``launch_phase``): ``python -m
   repro_torch.launch.dryrun --arch granite-3-2b --mesh pod1`` as a
   subprocess (a fake 512-rank group on meta tensors), its three records
   ``ok`` with the sharded step's per-device fields printed beside the
   data rank's; then ``repro_torch.launch.profile_cell`` on cuda:0 for each of
   those cells at published width and depth, one data rank's batch:
   train_4k (16 x 4096, the recipe's 2 microbatches), prefill_32k (B2,
   max_seq 32768), decode_32k (B8 over a 32,768-row cache); K1 160 a train
   step, 40 a prefill, K2 40 and K1 0 a decode step, and the card's
   dispatched matmul FLOPs equal to the dry run's meta count (FLOPS_RTOL);
   wall, busy time, idle share, MFU, top kernels and peak memory against
   the dry run's estimate are printed. The kernel phase (3) also holds K1
   at prefill_32k's shape (on its first and last 1,024 query rows) and K2
   at decode_32k's to their plain versions and times them;
11b. the examples phase (``examples_phase``): ``repro_torch.examples``'
   quickstart, serve_routed, train_lm (the 100M model, 300 steps, a
   failure at step 150) and elastic_restart on the card with their
   defaults, their own assertions the checks;
13. prints the kernels' JSON line, the card line again, and last
   ``{"ok": true, "device": {...}}``.

With ``--sweep-decode-chunks`` it only times the decode kernel at the path's
shapes at each chunk size of CHUNKS_TRIED (how ``chunk_size`` was chosen);
with ``--probe-consistency`` it only compares zamba2-7b's decode step with
its prefill layer by layer (``probe_consistency``); with ``--train-phase``
it only runs one family's train phase of TRAIN_PHASES at B x S tokens a
step (``--train-phase rwkv6-1.6b 4 1024``). None prints a result line.

Any failure exits non-zero before the last line. Without a CUDA device, or
without the repository around it, it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
PEAK_F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12            # H100 SXM HBM3
TOL = {"float32": 2e-5, "bfloat16": 0.05}
# bf16 is held element by element as well, to BF16_ATOL + BF16_RTOL * |plain|:
# kernel and plain version each round the output to bf16 (one ulp, 2^-7
# relative, apart at most) and the flash kernel rounds P to bf16 before P V.
# The flat 0.05 alone is the size of a long row's outputs (std sqrt(e / n) for
# n keys) and would let a fault that touches only long rows through; PERF.md
# section 6 shows planted faults failing this check.
BF16_ATOL, BF16_RTOL = 4e-3, 2.0 ** -6
# f32 sum order: the kernels accumulate the online softmax tile by tile and
# the plain version sums the materialised row at once; both are f32 and the
# measured gap stays far inside 2e-5 (no wider tolerance is needed).
CONSISTENCY_TOL = 0.15          # bf16: see check_consistency


class SmokeFailure(Exception):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    need(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
def time_ms(torch, fn, calls: int, reps: int = 5) -> float:
    """Mean device milliseconds per call of ``fn``: ``calls`` calls (each on
    the next rotating input set) are captured in one CUDA graph, which is
    replayed ``reps`` times between two CUDA events. The host work of a call
    (checks, allocation, the ctypes call) is not in the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    e1.synchronize()
    del graph
    return e0.elapsed_time(e1) / (reps * calls)


def host_us(torch, fn, calls: int = 50) -> float:
    """Host microseconds to enqueue one call of ``fn`` (no synchronisation
    inside the loop; the device queue is far from full at this count)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def rotating(n: int):
    """Cycle over ``n`` input sets, so a timed loop does not re-read one set
    out of the 50 MB L2 (each layer of the path reads its own cache)."""
    return itertools.cycle(range(n)).__next__


# ------------------------------------------------------------------ kernel phase
FLASH_CASES = [
    # B, Sq, Sk, Hq, Hkv, hd, causal, window, off  (tests/test_kernels.py)
    (2, 128, 128, 4, 2, 64, True, 0, 0),
    (1, 100, 100, 4, 4, 72, True, 0, 0),
    (2, 64, 192, 8, 2, 64, True, 0, 128),
    (2, 256, 256, 4, 2, 64, True, 64, 0),
    (1, 96, 160, 2, 2, 48, False, 0, 0),
    (1, 64, 64, 8, 1, 128, True, 0, 0),
    (2, 80, 80, 6, 3, 240, True, 0, 0),
]
DECODE_CASES = [
    # B, S, Hq, Hkv, hd, window  (tests/test_kernels.py)
    (2, 256, 4, 2, 64, 0),
    (2, 300, 8, 8, 80, 0),
    (3, 512, 4, 2, 64, 128),
    (1, 64, 2, 1, 32, 16),
    (2, 1024, 16, 2, 128, 0),
]
# the serving and training paths' shapes: (name, case); the first of each
# list is the main path's (its times go in the kernels' JSON line)
FLASH_PATH = [
    ("granite-3-2b", (1, 1024, 1024, 32, 8, 64, True, 0, 0)),
    ("gemma3-12b local", (1, 1536, 1536, 16, 8, 240, True, 1024, 0)),
    # whisper-medium: encoder self attention over the 1500 frames, and the
    # decoder's cross attention of a 256-token prompt (MHA, non-causal)
    ("whisper encoder", (1, 1500, 1500, 16, 16, 64, False, 0, 0)),
    ("whisper cross", (1, 256, 1500, 16, 16, 64, False, 0, 0)),
    # llama-3.2-vision-90b: self and cross attention of a 512-token prompt
    # over the 1601 patches
    ("vision self", (1, 512, 512, 64, 8, 128, True, 0, 0)),
    ("vision cross", (1, 512, 1601, 64, 8, 128, False, 0, 0)),
    # deepseek-v3 MLA prefill: q/k 192 columns, v padded from 128 to 192
    ("deepseek MLA", (1, 1024, 1024, 128, 128, 192, True, 0, 0)),
    # zamba2-7b's shared attention block: hd 112 (3584 / 32), MHA
    ("zamba2 shared", (1, 1024, 1024, 32, 32, 112, True, 0, 0)),
    # the train step's forwards: granite-3-2b, a microbatch of 4 x 4096
    ("train granite-3-2b", (4, 4096, 4096, 32, 8, 64, True, 0, 0)),
    # the other families' train steps (deepseek's MLA at B1 S1024 is the
    # "deepseek MLA" shape above)
    ("train whisper encoder", (8, 1500, 1500, 16, 16, 64, False, 0, 0)),
    ("train whisper cross", (8, 448, 1500, 16, 16, 64, False, 0, 0)),
    ("train vision self", (2, 1024, 1024, 64, 8, 128, True, 0, 0)),
    ("train vision cross", (2, 1024, 1601, 64, 8, 128, False, 0, 0)),
    ("train zamba2 shared", (2, 2048, 2048, 32, 32, 112, True, 0, 0)),
]
# V's own width where the path zero-pads V to the q/k head dim: the timed
# kernel reads the padded V, the bound and the library call the unpadded one
FLASH_PATH_DV = {"deepseek MLA": 128}
# (name, case, lengths): "random" = path_lengths(SEED), in 1..S with the
# first S and the last 1; "full" = S for every row (cross attention reads the
# whole cache). Each timed shape draws its lengths and tensors from SEED
# alone, so adding a shape never moves another's inputs.
DECODE_PATH = [
    ("granite-3-2b", (8, 2048, 32, 8, 64, 0), "random"),
    ("gemma3-12b local", (8, 2048, 16, 8, 240, 1024), "random"),
    ("whisper self", (8, 448, 16, 16, 64, 0), "random"),
    ("whisper cross", (8, 1500, 16, 16, 64, 0), "full"),
    ("vision self", (4, 2048, 64, 8, 128, 0), "random"),
    ("vision cross", (4, 1601, 64, 8, 128, 0), "full"),
    ("zamba2 shared", (4, 2048, 32, 32, 112, 0), "random"),
]
# the redesigned kernels' own edges (tests/test_torch_kernels.py)
FLASH_EDGE = [
    # B, Sq, Sk, Hq, Hkv, hd, causal, window, off
    (1, 130, 130, 2, 2, 48, True, 0, 0),
    (2, 70, 200, 4, 2, 80, True, 0, 130),
    (1, 77, 77, 8, 2, 168, True, 0, 0),
    (1, 200, 200, 4, 2, 72, True, 50, 0),
    (1, 150, 150, 2, 1, 240, True, 100, 0),
    (2, 33, 97, 4, 4, 64, False, 0, 0),
    (1, 64, 300, 8, 2, 64, True, 37, 236),
    (1, 140, 140, 4, 2, 176, True, 0, 0),
    (1, 40, 150, 4, 4, 64, False, 0, 0),
    (1, 70, 201, 8, 1, 128, False, 0, 0),
    (1, 96, 96, 4, 4, 192, True, 0, 0),
]
DECODE_EDGE = [
    # B, S, Hq, Hkv, hd, window, lengths (decode chunk 192 at hd <= 128)
    (4, 600, 8, 2, 64, 0, [1, 192, 193, 5000]),
    (2, 1024, 4, 2, 64, 100, [250, 650]),
    (2, 2048, 4, 2, 240, 50, [100, 1900]),
    (3, 700, 16, 2, 128, 0, [700, 1, 513]),
    (2, 512, 24, 2, 64, 0, [512, 130]),
    (3, 500, 8, 8, 64, 0, [500, 500, 500]),
]
# the production cells' shapes (granite-3-2b at one data rank's share of the
# pod1 mesh): K1 at prefill_32k's (B2, S 32768) and K2 at decode_32k's (B8,
# a 32,768-row cache, lengths from path_lengths). The plain K1 materialises
# the f32 score square (B Hq S^2 x 4 B = 275 GB here), so the kernel's output
# is held to it on slices of FLASH_LONG_ROWS query rows (the first and the
# last, via q_offset, against all keys); the timed call is the whole shape,
# and the plain version's time is that of the last slice (labelled so)
FLASH_LONG = ("prefill_32k granite-3-2b",
              (2, 32768, 32768, 32, 8, 64, True, 0, 0))
FLASH_LONG_ROWS = 1024
DECODE_LONG = ("decode_32k granite-3-2b", (8, 32768, 32, 8, 64, 0))
DESIGN = {"flash_attention": "wgmma+tma", "decode_attention": "chunked-v16"}
CHUNKS_TRIED = (128, 192, 256, 320, 384, 512)   # --sweep-decode-chunks


def path_lengths(torch, B: int, S: int, seed: int):
    """Seeded decode lengths in 1..S, the first S and the last 1."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    lens = torch.randint(1, S + 1, (B,), generator=gen, device="cuda",
                         dtype=torch.int32)
    lens[0] = S
    lens[-1] = 1
    return lens


def compare(torch, out, want) -> tuple[float, float | None, bool]:
    """(max |out - plain|, worst |out - plain| / (BF16_ATOL + BF16_RTOL *
    |plain|) for bf16, within tolerance). NaN anywhere fails."""
    diff = (out.float() - want.float()).abs()
    err = diff.max().item()
    ok = math.isfinite(err) and err <= TOL[str(out.dtype).removeprefix("torch.")]
    ratio = None
    if out.dtype == torch.bfloat16:
        ratio = (diff / (BF16_ATOL + BF16_RTOL * want.float().abs())).max().item()
        ok = ok and ratio <= 1.0
    return err, ratio, ok


def bound_ms(ops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    from repro_torch.launch.profile_cell import PEAK_BF16_FLOPS
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_FLOPS
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def kernel_phase(torch, kern) -> dict:
    from repro_torch.launch.op_analysis import decode_work, flash_work
    ref, flash, decode = kern["ref"], kern["flash"], kern["decode"]
    F = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def mk(shape, dt):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    def lens_for(B, S, mode):
        if mode == "full":
            return torch.full((B,), S, dtype=torch.int32, device="cuda")
        return path_lengths(torch, B, S, SEED)

    worst = {"flash_attention": 0.0, "decode_attention": 0.0}
    failed = []

    def check(name, label, dt, out, want):
        """Prints one comparison; a failure is listed, and the phase stops
        once every comparison of its loop was printed."""
        err, ratio, ok = compare(torch, out, want)
        rel = "" if ratio is None else \
            f" err/(atol+rtol|plain|)={ratio:.3f}"
        print(f"  {name:16s} {label:40s} {str(dt)[6:]:8s} "
              f"max_abs_err={err:.3e}{rel} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failed.append(f"{name} {label} {dt}")
        worst[name] = max(worst[name], err)
        return err

    print("[kernels] each kernel against its plain version on the card",
          flush=True)
    for dt in (torch.float32, torch.bfloat16):
        for label, case in [(f"case{i}", c) for i, c in enumerate(FLASH_CASES)] \
                + [(f"edge{i}", c) for i, c in enumerate(FLASH_EDGE)] \
                + FLASH_PATH:
            B, Sq, Sk, Hq, Hkv, hd, causal, window, off = case
            q, k, v = mk((B, Sq, Hq, hd), dt), mk((B, Sk, Hkv, hd), dt), \
                mk((B, Sk, Hkv, hd), dt)
            kw = dict(causal=causal, window=window, q_offset=off)
            out = flash(q, k, v, **kw)
            torch.cuda.synchronize()
            check("flash_attention", f"{label} {case}", dt, out,
                  ref.flash_attention_ref(q, k, v, **kw))
        for label, case, mode in \
                [(f"case{i}", c, "random") for i, c in enumerate(DECODE_CASES)] \
                + DECODE_PATH:
            B, S, Hq, Hkv, hd, window = case
            q = mk((B, Hq, hd), dt)
            kc, vc = mk((B, S, Hkv, hd), dt), mk((B, S, Hkv, hd), dt)
            lens = lens_for(B, S, mode)
            out = decode(q, kc, vc, lens, window=window)
            torch.cuda.synchronize()
            check("decode_attention", f"{label} {case}", dt, out,
                  ref.decode_attention_ref(q, kc, vc, lens, window=window))
        for i, (B, S, Hq, Hkv, hd, window, lens) in enumerate(DECODE_EDGE):
            q = mk((B, Hq, hd), dt)
            kc, vc = mk((B, S, Hkv, hd), dt), mk((B, S, Hkv, hd), dt)
            lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
            out = decode(q, kc, vc, lt, window=window)
            torch.cuda.synchronize()
            check("decode_attention", f"edge{i} {(B, S, Hq, Hkv, hd, window)} "
                  f"lengths {lens}", dt, out,
                  ref.decode_attention_ref(q, kc, vc, lt, window=window))
        # the length-1 edge and lengths past the cache (clamped to S)
        q = mk((2, 4, 64), dt)
        kc, vc = mk((2, 128, 2, 64), dt), mk((2, 128, 2, 64), dt)
        for label, lens in (("length 1", [1, 1]), ("lengths > S", [129, 5000])):
            lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
            out = decode(q, kc, vc, lt)
            torch.cuda.synchronize()
            check("decode_attention", label, dt, out,
                  ref.decode_attention_ref(q, kc, vc, lt))
    need(not failed, f"{len(failed)} kernel checks failed: {failed}")

    print("[kernels] times at the serving path's shapes (bf16; CUDA graph of "
          "calls over rotating input sets, replayed between CUDA events)",
          flush=True)
    rows, paths = {}, []
    for name, case in FLASH_PATH:
        B, Sq, Sk, Hq, Hkv, hd, causal, window, off = case
        dt = torch.bfloat16
        dv = FLASH_PATH_DV.get(name, hd)
        ops, nbytes = flash_work(case, 2, dv)
        n = max(1, min(8, math.ceil(100e6 / nbytes)))
        gen.manual_seed(SEED)
        sets = []                       # (q, k, V as the kernel reads it, V)
        for _ in range(n):
            q, k, v = mk((B, Sq, Hq, hd), dt), mk((B, Sk, Hkv, hd), dt), \
                mk((B, Sk, Hkv, dv), dt)
            sets.append((q, k, v if dv == hd else F.pad(v, (0, hd - dv)), v))
        kw = dict(causal=causal, window=window, q_offset=off)
        qpos = off + torch.arange(Sq, device="cuda")[:, None]
        kpos = torch.arange(Sk, device="cuda")[None, :]
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device="cuda")
        if causal:
            mask &= kpos <= qpos
        if window > 0:
            mask &= qpos - kpos < window
        nxt = rotating(n)

        # the library call takes V at its own width (SDPA allows dv != hd)
        def lib_mask(s):
            q, k, _, v = s
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, enable_gqa=True).transpose(1, 2)

        def lib_causal(s):
            q, k, _, v = s
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True).transpose(1, 2)

        def lib_full(s):
            q, k, _, v = s
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                enable_gqa=True).transpose(1, 2)

        libs = [("scaled_dot_product_attention(attn_mask, enable_gqa)",
                 lib_mask)]
        if causal and window == 0 and off == 0 and Sq == Sk:
            libs.append(("scaled_dot_product_attention(is_causal, enable_gqa)",
                         lib_causal))
        if not causal and window == 0:
            libs.append(("scaled_dot_product_attention(enable_gqa)", lib_full))
        q, k, v, _ = sets[0]
        want = ref.flash_attention_ref(q, k, v, **kw)
        err = check("flash_attention", f"timed {name}", dt, flash(q, k, v, **kw),
                    want)
        need(not failed, f"kernel check failed: {failed}")
        t_k = time_ms(torch, lambda: flash(*sets[nxt()][:3], **kw), 20)
        t_p = time_ms(torch, lambda: ref.flash_attention_ref(*sets[nxt()][:3],
                                                             **kw), 4)
        lib_times = []
        for call, lib in libs:
            lib_err = (lib(sets[0]).float()
                       - want[..., :dv].float()).abs().max().item()
            t_l = time_ms(torch, lambda: lib(sets[nxt()]), 20)
            print(f"  flash_attention  {name:18s} library {call}: {t_l:.4f} ms "
                  f"(err {lib_err:.2e})", flush=True)
            lib_times.append((t_l, call))
        t_l, lib_call = min(lib_times)
        h_us = host_us(torch, lambda: flash(q, k, v, **kw))
        b_ms, b_by = bound_ms(ops, nbytes, "bfloat16")
        print(f"  flash_attention  {name:18s} kernel_ms={t_k:.4f} "
              f"plain_ms={t_p:.4f} library_ms={t_l:.4f} bound_ms={b_ms:.5f} "
              f"by {b_by} ({ops:.3e} op, {nbytes:.3e} B, V {dv} columns); "
              f"kernel at {ops / t_k / 1e9:.1f} TFLOP/s", flush=True)
        print(f"  flash_attention  {name:18s} host enqueue {h_us:.1f} us per "
              f"wrapper call", flush=True)
        paths.append(dict(kernel="flash_attention", path=name, case=case,
                          v_cols=dv, ms=t_k, plain_ms=t_p, library_ms=t_l,
                          library_call=lib_call, bound_ms=b_ms, bound_by=b_by,
                          max_abs_err=err, host_us=h_us))
        rows.setdefault("flash_attention", dict(paths[-1]))
    for name, case, mode in DECODE_PATH:
        B, S, Hq, Hkv, hd, window = case
        dt = torch.bfloat16
        gen.manual_seed(SEED)
        lens = lens_for(B, S, mode)
        ops, nbytes = decode_work(case, lens.tolist(), 2)
        n = max(1, min(8, math.ceil(100e6 / (4 * B * S * Hkv * hd))))
        sets = [(mk((B, Hq, hd), dt), mk((B, S, Hkv, hd), dt),
                 mk((B, S, Hkv, hd), dt)) for _ in range(n)]
        kpos = torch.arange(S, device="cuda")[None, :]
        ln = lens.clamp(max=S)[:, None]
        mask = kpos < ln
        if window > 0:
            mask &= (ln - 1 - kpos) < window
        mask = None if mode == "full" else mask[:, None, None, :]
        nxt = rotating(n)
        lib_call = "scaled_dot_product_attention(enable_gqa)" \
            if mask is None else \
            "scaled_dot_product_attention(attn_mask, enable_gqa)"

        def lib(s):
            q, kc, vc = s
            return F.scaled_dot_product_attention(
                q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)[:, :, 0]

        q, kc, vc = sets[0]
        want = ref.decode_attention_ref(q, kc, vc, lens, window=window)
        err = check("decode_attention", f"timed {name}", dt,
                    decode(q, kc, vc, lens, window=window), want)
        need(not failed, f"kernel check failed: {failed}")
        lib_err = (lib(sets[0]).float() - want.float()).abs().max().item()
        t_k = time_ms(torch, lambda: decode(*sets[nxt()], lens, window=window),
                      50)
        t_p = time_ms(torch, lambda: ref.decode_attention_ref(
            *sets[nxt()], lens, window=window), 10)
        t_l = time_ms(torch, lambda: lib(sets[nxt()]), 50)
        h_us = host_us(torch, lambda: decode(q, kc, vc, lens, window=window))
        b_ms, b_by = bound_ms(ops, nbytes, "bfloat16")
        print(f"  decode_attention {name:18s} kernel_ms={t_k:.4f} "
              f"plain_ms={t_p:.4f} library_ms={t_l:.4f} (library err "
              f"{lib_err:.2e}) bound_ms={b_ms:.5f} by {b_by} lengths="
              f"{lens.tolist()} ({ops:.3e} op, {nbytes:.3e} B); kernel at "
              f"{nbytes / t_k / 1e6:.0f} GB/s, chunk {kern['chunk_size'](hd)}",
              flush=True)
        print(f"  decode_attention {name:18s} host enqueue {h_us:.1f} us per "
              f"wrapper call", flush=True)
        paths.append(dict(kernel="decode_attention", path=name, case=case,
                          lengths=mode, ms=t_k, plain_ms=t_p, library_ms=t_l,
                          library_call=lib_call, bound_ms=b_ms, bound_by=b_by,
                          max_abs_err=err, host_us=h_us))
        rows.setdefault("decode_attention", dict(paths[-1]))
    paths += production_shapes(torch, kern, mk, check)
    need(not failed, f"kernel check failed: {failed}")
    for name in rows:
        rows[name]["max_abs_err"] = worst[name]
    print("[paths] " + json.dumps({"path_shapes": paths}), flush=True)
    return rows


def production_shapes(torch, kern, mk, check) -> list[dict]:
    """K1 at FLASH_LONG and K2 at DECODE_LONG: f32 and bf16 checks against
    the plain version (K1 on its first and last FLASH_LONG_ROWS query rows),
    then the bf16 kernel's time, the plain version's (K1: the last slice
    alone), scaled_dot_product_attention's and the bound. Returns their
    ``[paths]`` entries."""
    from repro_torch.launch.op_analysis import decode_work, flash_work
    ref, flash, decode = kern["ref"], kern["flash"], kern["decode"]
    F = torch.nn.functional
    out = []
    name, case = FLASH_LONG
    B, Sq, Sk, Hq, Hkv, hd, causal, window, off = case
    R = FLASH_LONG_ROWS
    kw = dict(causal=causal, window=window, q_offset=off)
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = mk((B, Sq, Hq, hd), dt), mk((B, Sk, Hkv, hd), dt), \
            mk((B, Sk, Hkv, hd), dt)
        o = flash(q, k, v, **kw)
        torch.cuda.synchronize()
        for lo in (0, Sq - R):
            want = ref.flash_attention_ref(q[:, lo:lo + R], k, v,
                                           causal=causal, window=window,
                                           q_offset=off + lo)
            err = max(err, check("flash_attention",
                                 f"{name} {case} rows {lo}..{lo + R - 1}",
                                 dt, o[:, lo:lo + R], want))
            del want
        del q, k, v, o
        free_cuda(torch)
    ops, nbytes = flash_work(case, 2)
    dt = torch.bfloat16
    q, k, v = mk((B, Sq, Hq, hd), dt), mk((B, Sk, Hkv, hd), dt), \
        mk((B, Sk, Hkv, hd), dt)
    t_k = time_ms(torch, lambda: flash(q, k, v, **kw), 2)
    t_p = events_ms(torch, lambda: ref.flash_attention_ref(
        q[:, Sq - R:], k, v, causal=causal, window=window,
        q_offset=off + Sq - R), 2)
    lib_call = "scaled_dot_product_attention(is_causal, enable_gqa)"
    t_l = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True), 2)
    h_us = host_us(torch, lambda: flash(q, k, v, **kw), 10)
    b_ms, b_by = bound_ms(ops, nbytes, "bfloat16")
    print(f"  flash_attention  {name} kernel_ms={t_k:.4f} plain_ms(last "
          f"{R} rows only)={t_p:.4f} library_ms={t_l:.4f} bound_ms="
          f"{b_ms:.5f} by {b_by} ({ops:.3e} op, {nbytes:.3e} B); kernel at "
          f"{ops / t_k / 1e9:.1f} TFLOP/s; host enqueue {h_us:.1f} us",
          flush=True)
    out.append(dict(kernel="flash_attention", path=name, case=case, ms=t_k,
                    plain_ms=None, plain_rows_ms=t_p, plain_rows=R,
                    library_ms=t_l, library_call=lib_call, bound_ms=b_ms,
                    bound_by=b_by, max_abs_err=err, host_us=h_us))
    del q, k, v
    free_cuda(torch)

    name, case = DECODE_LONG
    B, S, Hq, Hkv, hd, window = case
    lens = path_lengths(torch, B, S, SEED)
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        q, kc, vc = mk((B, Hq, hd), dt), mk((B, S, Hkv, hd), dt), \
            mk((B, S, Hkv, hd), dt)
        o = decode(q, kc, vc, lens, window=window)
        torch.cuda.synchronize()
        err = max(err, check("decode_attention", f"{name} {case} lengths "
                             f"{lens.tolist()}", dt, o, ref.decode_attention_ref(
                                 q, kc, vc, lens, window=window)))
        del q, kc, vc, o
    free_cuda(torch)
    ops, nbytes = decode_work(case, lens.tolist(), 2)
    dt = torch.bfloat16
    q, kc, vc = mk((B, Hq, hd), dt), mk((B, S, Hkv, hd), dt), \
        mk((B, S, Hkv, hd), dt)
    kpos = torch.arange(S, device="cuda")[None, :]
    mask = (kpos < lens.clamp(max=S)[:, None])[:, None, None, :]
    lib_call = "scaled_dot_product_attention(attn_mask, enable_gqa)"
    t_k = time_ms(torch, lambda: decode(q, kc, vc, lens, window=window), 20)
    t_p = time_ms(torch, lambda: ref.decode_attention_ref(
        q, kc, vc, lens, window=window), 4)
    t_l = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
        attn_mask=mask, enable_gqa=True), 20)
    h_us = host_us(torch, lambda: decode(q, kc, vc, lens, window=window))
    b_ms, b_by = bound_ms(ops, nbytes, "bfloat16")
    print(f"  decode_attention {name} kernel_ms={t_k:.4f} plain_ms={t_p:.4f}"
          f" library_ms={t_l:.4f} bound_ms={b_ms:.5f} by {b_by} lengths="
          f"{lens.tolist()} ({ops:.3e} op, {nbytes:.3e} B); kernel at "
          f"{nbytes / t_k / 1e6:.0f} GB/s, chunk {kern['chunk_size'](hd)}; "
          f"host enqueue {h_us:.1f} us", flush=True)
    out.append(dict(kernel="decode_attention", path=name, case=case,
                    lengths="random", ms=t_k, plain_ms=t_p, library_ms=t_l,
                    library_call=lib_call, bound_ms=b_ms, bound_by=b_by,
                    max_abs_err=err, host_us=h_us))
    del q, kc, vc
    free_cuda(torch)
    return out


def sweep_decode_chunks(torch, ref) -> None:
    """Device ms of the decode kernel at each of CHUNKS_TRIED keys per block,
    at the serving path's shapes, bf16, for three seeded length sets; each
    output is held to the plain version first."""
    from repro_torch.kernels import decode_attention as dmod
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    print("[sweep] decode_attention device ms by chunk size (CUDA graph of "
          "calls over rotating input sets)", flush=True)
    for name, (B, S, Hq, Hkv, hd, window), mode in DECODE_PATH:
        if mode != "random":
            continue
        n = max(1, min(8, math.ceil(100e6 / (4 * B * S * Hkv * hd))))
        sets = [tuple(torch.randn(s, generator=gen, device="cuda")
                      .to(torch.bfloat16)
                      for s in ((B, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
                for _ in range(n)]
        nxt = rotating(n)
        scale = hd ** -0.5
        for seed in (SEED, SEED + 1, SEED + 2):
            lens = path_lengths(torch, B, S, seed)
            want = ref.decode_attention_ref(*sets[0], lens, window=window)
            dmod.decode_attention(*sets[0], lens, window=window)  # its checks
            tried = []
            for chunk in CHUNKS_TRIED:
                err, ratio, ok = compare(torch, dmod._launch(
                    *sets[0], lens, window, scale, chunk), want)
                need(ok, f"decode chunk {chunk} {name}: err {err}, ratio "
                     f"{ratio}")
                tried.append((chunk, time_ms(torch, lambda: dmod._launch(
                    *sets[nxt()], lens, window, scale, chunk), 50)))
            print(f"  {name:18s} lengths {lens.tolist()} (chunk_size "
                  f"{dmod.chunk_size(hd)}): " + ", ".join(
                      f"{c}: {t:.4f}" for c, t in tried), flush=True)


# ------------------------------------------------------------------ serve phases
def check_consistency(torch, M, cfg, model, prompt: list[int], steps: int,
                      label: str, extra: dict | None = None,
                      gate: bool = True) -> float:
    """Ties K1 to K2: decode step t's logits (K2 over the prefilled cache)
    must match the last-position logits of a prefill (K1) of the prompt plus
    the t tokens. Compared as log-probabilities; the two paths round bf16 at
    different places (one position's activations vs a whole sequence's
    matmuls), through every layer, so the bound is stated for bf16:
    CONSISTENCY_TOL on the max |difference| of the top-32 log-probs.
    ``extra`` (frames or patches) goes into every prefill's batch. With
    ``gate=False`` the figure is printed and returned, not checked."""
    dev = model.device
    extra = extra or {}
    with torch.no_grad():
        tok = torch.tensor([prompt], device=dev)
        logits, state = M.prefill(cfg, model, {"tokens": tok, **extra},
                                  len(prompt) + steps + 1)
        seq = list(prompt)
        nxt = int(logits[0, -1].argmax())
        worst = 0.0
        for _ in range(steps):
            seq.append(nxt)
            step_logits, state = M.decode_step(
                cfg, model, state, torch.tensor([[nxt]], device=dev))
            full, _ = M.prefill(
                cfg, model, {"tokens": torch.tensor([seq], device=dev),
                             **extra}, len(seq))
            a = torch.log_softmax(step_logits[0, -1].float(), -1)
            b = torch.log_softmax(full[0, -1].float(), -1)
            need(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
                 f"{label}: non-finite logits")
            top = torch.topk(b, 32).indices
            worst = max(worst, (a[top] - b[top]).abs().max().item())
            nxt = int(step_logits[0, -1].argmax())
    ok = worst <= CONSISTENCY_TOL
    verdict = ("ok" if ok else "FAIL") if gate else \
        f"{'within' if ok else 'over'} tol, reported only"
    print(f"  consistency {label} {str(model.final_norm.dtype)[6:]}: decode "
          f"step vs prefill of prompt+t ({steps} steps) max |dlogp| over "
          f"top-32 = {worst:.4f} tol={CONSISTENCY_TOL} {verdict}", flush=True)
    if gate:
        need(ok, f"{label}: decode/prefill logits disagree by {worst}")
    return worst


def probe_consistency(torch) -> None:
    """Where zamba2-7b's decode step and its chunked prefill part: the
    consistency check's prompt (the first 256 tokens of the serve phase's
    first prompt) and 3 decode steps, at full width, in bf16 with cuBLAS
    allowed reduced-precision (bf16) split-K reductions (torch's default),
    in bf16 without them, and in f32 (weights drawn from the same seed).
    Prints the worst |dlogp| over the top 32 as check_consistency does, and
    for the first step the relative difference max|a - b| / max|b| of each
    layer's normed input at the new position (every Mamba2 layer and each
    application of the shared block, in order); granite-3-2b's consistency
    under both bf16 settings is printed beside it."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import ssm
    rec: list[torch.Tensor] = []
    orig = (ssm.mamba2_block, ssm.mamba2_step, M._attn_prefill,
            M._attn_decode)

    def recorded(fn, at):
        def wrapper(cfg_, p, *args, **kw):
            rec.append(args[at][0, -1].float())
            return fn(cfg_, p, *args, **kw)
        return wrapper

    ssm.mamba2_block = recorded(orig[0], 0)
    ssm.mamba2_step = recorded(orig[1], 1)
    M._attn_prefill = recorded(orig[2], 0)
    M._attn_decode = recorded(orig[3], 0)
    print("[probe] decode step vs prefill of prompt+t, layer by layer",
          flush=True)
    try:
        for name, steps, per_layer in (("zamba2-7b", 3, True),
                                       ("granite-3-2b", 3, False)):
            full = get_config(name)
            prompt = seeded_prompts(full, [1024])[0][:256]
            for dtype, reduced in (("bfloat16", True), ("bfloat16", False),
                                   ("float32", False)):
                if dtype == "float32" and not per_layer:
                    continue
                torch.backends.cuda.matmul \
                    .allow_bf16_reduced_precision_reduction = reduced
                cfg = dataclasses.replace(full, dtype=dtype)
                model = M.init_params(cfg, SEED, device="cuda")
                worst, rel = 0.0, []
                with torch.no_grad():
                    logits, state = M.prefill(cfg, model, {
                        "tokens": torch.tensor([prompt], device="cuda")},
                        len(prompt) + steps + 1)
                    seq, nxt = list(prompt), int(logits[0, -1].argmax())
                    for t in range(steps):
                        seq.append(nxt)
                        rec.clear()
                        a, state = M.decode_step(cfg, model, state,
                                                 torch.tensor([[nxt]],
                                                              device="cuda"))
                        dec = list(rec)
                        rec.clear()
                        b, _ = M.prefill(cfg, model, {"tokens": torch.tensor(
                            [seq], device="cuda")}, len(seq))
                        if t == 0:
                            rel = [((x - y).abs().max()
                                    / y.abs().max().clamp(min=1e-30)).item()
                                   for x, y in zip(dec, rec)]
                        la = torch.log_softmax(a[0, -1].float(), -1)
                        lb = torch.log_softmax(b[0, -1].float(), -1)
                        top = torch.topk(lb, 32).indices
                        worst = max(worst, (la[top] - lb[top]).abs().max()
                                    .item())
                        nxt = int(a[0, -1].argmax())
                print(f"  {name} {dtype} reduced-precision split-K "
                      f"{'allowed' if reduced else 'off'}: max |dlogp| over "
                      f"top-32 = {worst:.4f} (tol {CONSISTENCY_TOL})",
                      flush=True)
                if per_layer:
                    print(f"    per layer (step 1, {len(rel)} inputs): "
                          + " ".join(f"{r:.1e}" for r in rel), flush=True)
                del model, state
                free_cuda(torch)
    finally:
        ssm.mamba2_block, ssm.mamba2_step, M._attn_prefill, \
            M._attn_decode = orig
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            True


def seeded_prompts(cfg, lens: list[int]) -> list[list[int]]:
    """One prompt of each length, tokens from default_rng(SEED)."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, cfg.vocab, size=n).tolist() for n in lens]


def serve_family(torch, kern, cfg, *, label: str, n_engines: int,
                 max_batch: int, max_seq: int, prompts: list[list[int]],
                 steps: int, flash_per_prefill: int, decode_per_step: int,
                 kv_bytes: int, park_at: int | None = None,
                 gates: bool = False,
                 consistency: tuple[int, int, int] | None = None,
                 consistency_dtype: str | None = None,
                 live_follow_up: bool = False, check_warm: bool = False,
                 profile_prompt: list[int] | None = None) -> dict:
    """Serve ``cfg`` (random weights from SEED) through ServingEngines on
    one tiered LocStore behind the Router: one session per prompt, each with
    its own seeded frames or patches, plus a never-parked control of the
    first; ``steps`` pooled decode steps, with the first session parked,
    warmed and resumed by a follow-up before step ``park_at`` (default
    halfway). Checks the kernels' launch counts against what the path
    implies (``flash_per_prefill`` per prefill, ``decode_per_step`` per
    pooled step: 0 where the path has no such kernel), the resumed session
    against its control token for token, every session's tokens, and the
    slot bytes against ``kv_bytes``. Optional checks: ``live_follow_up``
    (a follow-up of the second session is a live hit, no prefill),
    ``check_warm`` (Router.warm promotes the parked session) and
    ``consistency`` = (session, prompt tokens, steps), the decode path
    against the prefill path, checked in ``consistency_dtype`` when given (a
    second model from the same seed, whose weights round to the served
    ones; the served dtype's figure is then printed beside it, unchecked);
    ``profile_prompt`` adds a profiled prefill."""
    from repro_torch.core.config import ServingConfig
    from repro_torch.core.locstore import LocStore, tiered_hierarchy
    from repro_torch.core.prefetch import PrefetchEngine
    from repro_torch.launch.profile_cell import profile
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Router, ServingEngine
    park_at = steps // 2 if park_at is None else park_at
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = M.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"  params {M.param_count(cfg):,} initialised in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    if gates:
        open_gates(torch, model)
        print("  cross-attention gates set to 0.5 (tanh 0.462) in every "
              "group", flush=True)
    store = LocStore(n_engines, hierarchy=tiered_hierarchy())
    config = ServingConfig(max_batch=max_batch, max_seq=max_seq)
    engines = [ServingEngine(cfg, model, config=config, node=i, store=store)
               for i in range(n_engines)]
    prefetch = PrefetchEngine(store)
    router = Router(engines, store, prefetch=prefetch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    key = M._EXTRAS.get(cfg.family)
    n_extra = cfg.n_frames if key == "frames" else cfg.n_patches

    def extras():
        if key is None:
            return None
        return {key: torch.randn((1, n_extra, cfg.d_model), generator=gen,
                                 device="cuda").to(torch.bfloat16)}

    ex = [extras() for _ in prompts]
    if key is not None:
        print(f"  seeded {key} (1, {n_extra}, {cfg.d_model}) bf16 for every "
              f"session", flush=True)

    flash, decode = kern["flash"], kern["decode"]
    flash.launches = 0
    decode.launches = 0
    # ------------------------------------------------------------ main path
    ttft, placed = [], []
    for p, e in zip(prompts, ex):
        t = time.perf_counter()
        eng = router.engine_for()
        sid = eng.submit(p, e)
        ttft.append(time.perf_counter() - t)
        placed.append((eng, sid))
    a_eng, a_sid = placed[0]
    c_eng = next((e for e in engines if e is not a_eng), a_eng)
    t = time.perf_counter()
    c_sid = c_eng.submit(prompts[0], ex[0])     # the never-parked control
    ttft.append(time.perf_counter() - t)
    placed.append((c_eng, c_sid))
    step_wall, n_tokens, d1, d2, warmed = [], 0, None, None, None
    for i in range(steps):
        if i == park_at:
            a_eng.park(a_sid)
            warmed = router.warm(a_sid)
            prefetch.drain()
            d1 = router.follow_up(a_sid, a_eng.sessions[a_sid].tokens)
            if live_follow_up:
                b_eng, b_sid = placed[1]
                d2 = router.follow_up(b_sid, b_eng.sessions[b_sid].tokens)
        t = time.perf_counter()
        for e in engines:
            n_tokens += len(e.step())
        torch.cuda.synchronize()
        step_wall.append(time.perf_counter() - t)
    k1, k2 = flash.launches, decode.launches
    # ------------------------------------------------------------ checks
    prefills = sum(e.prefills for e in engines)
    n_steps = sum(e.steps for e in engines)
    print(f"  launches: flash_attention {k1} ({flash_per_prefill} x "
          f"{prefills} prefills = {flash_per_prefill * prefills}), "
          f"decode_attention {k2} ({decode_per_step} x {n_steps} decode steps "
          f"= {decode_per_step * n_steps})", flush=True)
    need((k1 > 0 or flash_per_prefill == 0)
         and (k2 > 0 or decode_per_step == 0),
         f"{label}: a kernel of the path was never launched")
    need(k1 == flash_per_prefill * prefills,
         f"{label}: flash launches {k1} != {flash_per_prefill} x {prefills}")
    need(k2 == decode_per_step * n_steps,
         f"{label}: decode launches {k2} != {decode_per_step} x {n_steps}")
    need(d1 is not None and d1.kind == "hit_parked" and d1.resumed
         and not d1.prefilled, f"{label}: park/resume follow-up went {d1}")
    if live_follow_up:
        need(d2.kind == "hit_live" and not d2.prefilled,
             f"{label}: live follow-up went {d2}")
    if check_warm:
        need(warmed, f"{label}: Router.warm did not promote the parked "
             f"session")
    a_tok = a_eng.sessions[a_sid].tokens
    c_tok = c_eng.sessions[c_sid].tokens
    print(f"  park/resume: resumed session {len(a_tok)} tokens, last 6 "
          f"{a_tok[-6:]}; control last 6 {c_tok[-6:]}", flush=True)
    need(a_tok == c_tok, f"{label}: resumed session diverged from its "
         f"never-parked control")
    for e, sid in placed:
        toks = e.sessions[sid].tokens
        need(len(toks) == steps + 1 and all(0 <= x < cfg.vocab for x in toks),
             f"{label}: session {sid} tokens {toks}")
    kv = engines[0].slot_bytes()
    need(kv == kv_bytes, f"{label}: slot bytes {kv} != {kv_bytes}")
    ttft_sorted = sorted(ttft)
    t_dec = sum(step_wall)
    res = {"ttft_s_p50": ttft_sorted[len(ttft) // 2],
           "ttft_s_max": ttft_sorted[-1],
           "prefill_seconds": [e.prefill_seconds for e in engines],
           "prompt_tokens": sum(len(p) for p in prompts) + len(prompts[0]),
           "decode_steps": n_steps,
           "decode_step_wall_ms": 1e3 * sorted(step_wall)[len(step_wall) // 2]
           / n_engines,
           "decode_tokens": n_tokens, "decode_seconds": t_dec,
           "decode_tokens_per_s": n_tokens / t_dec,
           "kv_bytes_per_session": kv,
           "router": {k: getattr(router, k) for k in (
               "locality_hits", "locality_misses", "locality_evictions",
               "migrations", "warmups")},
           "engines": [{"prefills": e.prefills, "steps": e.steps,
                        "parks": e.parks, "resumes": e.resumes}
                       for e in engines],
           "launches": {"flash_attention": k1, "decode_attention": k2},
           "launches_per_prefill": {"flash_attention": k1 / prefills,
                                    "decode_attention": 0},
           "launches_per_step": {"flash_attention": 0,
                                 "decode_attention": k2 / n_steps},
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    print("  " + json.dumps(res), flush=True)
    prefetch.shutdown()
    # where the time goes, and K1/K2 consistency (after every count was read)
    res["profile_decode"] = profile(
        f"one pooled decode step (B={max_batch})",
        lambda: engines[-1].step(), 2)
    if profile_prompt is not None:
        p_eng = next((e for e in engines if e.can_admit()), None)
        need(p_eng is not None, f"{label}: no free slot for the profiled "
             f"prefill")
        res["profile_prefill"] = profile(
            f"one {len(profile_prompt)}-token prefill",
            lambda: p_eng.finish(p_eng.submit(profile_prompt)), 1)
    if consistency is not None:
        i, n, k = consistency
        gated = (cfg, model)
        if consistency_dtype is not None:
            res["consistency_served_dtype"] = check_consistency(
                torch, M, cfg, model, prompts[i][:n], k, label, ex[i],
                gate=False)
            c2 = dataclasses.replace(cfg, dtype=consistency_dtype)
            gated = (c2, M.init_params(c2, SEED, device="cuda"))
        res["consistency"] = check_consistency(
            torch, M, *gated, prompts[i][:n], k, label, ex[i])
        del gated
    res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    print(f"  peak memory {res['peak_memory_bytes'] / 2**30:.2f} GiB",
          flush=True)
    return res


def serve_granite(torch, kern) -> dict:
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config("granite-3-2b")
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab} (padded {M.padded_vocab(cfg)}), "
          f"{cfg.dtype}, random weights seed {SEED}", flush=True)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).tolist()
               for n in rng.integers(128, 1025, size=11)]
    # 80 KiB of K and V per token (2 x 40 layers x 8 heads x 64 x 2 B) per
    # position of max_seq, plus the slot's 4-byte int32 position
    return serve_family(
        torch, kern, cfg, label=cfg.name, n_engines=2, max_batch=8,
        max_seq=2048, prompts=prompts, steps=40, park_at=32,
        flash_per_prefill=cfg.n_layers, decode_per_step=cfg.n_layers,
        kv_bytes=2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * 2 * 2048 + 4,
        consistency=(1, 256, 4), live_follow_up=True, check_warm=True,
        profile_prompt=rng.integers(0, cfg.vocab, size=1024).tolist())


def serve_gemma(torch, kern) -> dict:
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.config import ServingConfig
    from repro_torch.core.locstore import LocStore, tiered_hierarchy
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServingEngine
    full = get_config("gemma3-12b")
    # depth cut to one 5:1 local:global group so the script fits its limit
    cfg = dataclasses.replace(full, n_layers=6)
    print(f"[serve] {full.name} at full width (d_model {cfg.d_model}, hd "
          f"{cfg.hd}, window {cfg.sliding_window}), depth cut "
          f"{full.n_layers} -> {cfg.n_layers} layers, {cfg.dtype}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    model = M.init_params(cfg, SEED, device="cuda")
    store = LocStore(1, hierarchy=tiered_hierarchy())
    eng = ServingEngine(cfg, model, node=0, store=store,
                        config=ServingConfig(max_batch=2, max_seq=2048))
    rng = np.random.default_rng(SEED + 1)
    prompt = rng.integers(0, cfg.vocab, size=1536).tolist()
    flash, decode = kern["flash"], kern["decode"]
    flash.launches = 0
    decode.launches = 0
    t = time.perf_counter()
    sid = eng.submit(prompt)
    ttft = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(16):
        eng.step()
    t_dec = time.perf_counter() - t
    torch.cuda.synchronize()
    k1, k2 = flash.launches, decode.launches
    print(f"  launches: flash_attention {k1} (6 x {eng.prefills} prefill), "
          f"decode_attention {k2} (6 x {eng.steps} steps)", flush=True)
    need(k1 == cfg.n_layers * eng.prefills and k1 > 0, "gemma flash launches")
    need(k2 == cfg.n_layers * eng.steps and k2 > 0, "gemma decode launches")
    toks = eng.sessions[sid].tokens
    need(len(toks) == 17 and all(0 <= x < cfg.vocab for x in toks),
         f"gemma tokens {toks}")
    res = {"ttft_s": ttft, "prefill_seconds": eng.prefill_seconds,
           "decode_steps": eng.steps, "decode_seconds": t_dec,
           "decode_step_ms": 1e3 * t_dec / 16,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "launches": {"flash_attention": k1, "decode_attention": k2}}
    print("  " + json.dumps(res), flush=True)
    res["consistency"] = check_consistency(torch, M, cfg, model, prompt[:1100],
                                           4, f"{full.name} (6 layers)")
    del eng, store, model
    torch.cuda.empty_cache()
    return res


def free_cuda(torch) -> None:
    """Return a finished phase's memory to the card before the next one
    (called once the phase's function has returned and dropped its
    models, engines and stores)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def serve_whisper(torch, kern) -> dict:
    from repro_torch.configs import get_config
    cfg = get_config("whisper-medium")
    L, E, kvw = cfg.n_layers, cfg.encoder_layers, cfg.n_kv_heads * cfg.hd
    print(f"[serve] {cfg.name} at published width and depth ({E} encoder + "
          f"{L} decoder layers, d_model {cfg.d_model}, {cfg.n_heads} heads, "
          f"vocab {cfg.vocab}, {cfg.n_frames} frames), max_seq 448 (its text "
          f"context), {cfg.dtype}", flush=True)
    lens = [256, 200, 160, 128, 96, 64, 48, 32, 240, 180, 120]
    return serve_family(
        torch, kern, cfg, label=cfg.name, n_engines=2, max_batch=8,
        max_seq=448, prompts=seeded_prompts(cfg, lens), steps=16,
        flash_per_prefill=E + 2 * L, decode_per_step=2 * L,
        kv_bytes=2 * L * (448 + cfg.n_frames) * kvw * 2 + 4,
        consistency=(0, 128, 3))


def serve_vision(torch, kern) -> dict:
    from repro_torch.configs import get_config
    full = get_config("llama-3.2-vision-90b")
    # depth cut to 2 groups of (4 self + 1 cross): G > 1, inside the limit
    cfg = dataclasses.replace(full, n_layers=10)
    G, kvw = cfg.n_layers // cfg.cross_every, cfg.n_kv_heads * cfg.hd
    print(f"[serve] {full.name} at published width (d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, "
          f"{cfg.n_patches} patches), depth cut {full.n_layers} -> "
          f"{cfg.n_layers} layers ({G} groups of 4 self + 1 cross), "
          f"{cfg.dtype}", flush=True)
    return serve_family(
        torch, kern, cfg, label=f"{full.name} (10 layers)", n_engines=1,
        max_batch=4, max_seq=2048,
        prompts=seeded_prompts(cfg, [512, 384, 200]), steps=8,
        flash_per_prefill=cfg.n_layers, decode_per_step=cfg.n_layers,
        kv_bytes=2 * (G * 4 * 2048 + G * cfg.n_patches) * kvw * 2 + 4,
        gates=True, consistency=(0, 256, 3))


def serve_deepseek(torch, kern) -> dict:
    from repro_torch.configs import get_config
    full = get_config("deepseek-v3-671b")
    # depth cut to the 3 dense layers and 1 MoE layer (256 experts, 22.5 GB)
    cfg = dataclasses.replace(full, n_layers=4)
    m = cfg.mla
    print(f"[serve] {full.name} at published width (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, MLA ranks {m.q_lora_rank}/{m.kv_lora_rank}, "
          f"{cfg.n_experts} experts top-{cfg.experts_per_token}, d_ff "
          f"{cfg.d_ff}/{cfg.moe_d_ff}), depth cut {full.n_layers} -> "
          f"{cfg.n_layers} layers ({cfg.first_dense_layers} dense + 1 MoE), "
          f"{cfg.dtype}; MLA decode and the experts are torch matmuls",
          flush=True)
    # no decode-vs-prefill consistency here: prefill drops tokens at the
    # experts' capacity (counted over the whole prompt) and decode does not
    return serve_family(
        torch, kern, cfg, label=f"{full.name} (4 layers)", n_engines=1,
        max_batch=4, max_seq=2048,
        prompts=seeded_prompts(cfg, [1024, 300, 64]), steps=8,
        flash_per_prefill=cfg.n_layers, decode_per_step=0,
        kv_bytes=cfg.n_layers * 2048 * m.cache_dim * 2 + 4)


def serve_zamba2(torch, kern) -> dict:
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    cfg = get_config("zamba2-7b")
    G, tail = divmod(cfg.n_layers, cfg.attn_every)
    d_in, H, P, N = ssm.ssm_dims(cfg)
    print(f"[serve] {cfg.name} at published width and depth ({cfg.n_layers} "
          f"Mamba2 layers = {G} groups of {cfg.attn_every} + {tail}, each "
          f"group followed by the one shared attention block; d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, "
          f"SSM {H} heads x {P} x state {N}), {cfg.dtype}", flush=True)
    # 6 sessions and the control take 7 of the 2 x 4 slots; the profiled
    # prefill takes the last
    lens = [1024, 700, 512, 384, 256, 128]
    rng = np.random.default_rng(SEED + 2)
    return serve_family(
        torch, kern, cfg, label=cfg.name, n_engines=2, max_batch=4,
        max_seq=2048, prompts=seeded_prompts(cfg, lens), steps=16,
        flash_per_prefill=G, decode_per_step=G,
        # the 13 application points' K/V, every layer's f32 SSM state and
        # conv window, the 4-byte position
        kv_bytes=2 * G * 2048 * cfg.n_kv_heads * cfg.hd * 2
        + cfg.n_layers * H * P * N * 4
        + cfg.n_layers * (cfg.ssm_conv - 1) * (d_in + 2 * N) * 4 + 4,
        # in bf16 the two paths round at other places through 94 blocks and
        # part by more than CONSISTENCY_TOL (0.158 on an H100); in f32 they
        # agree (0.0000, each layer within 2.6e-5: --probe-consistency,
        # PERF.md section 6), so the check runs on the f32 model and the
        # bf16 figure is printed beside it
        consistency=(0, 256, 3), consistency_dtype="float32",
        profile_prompt=rng.integers(0, cfg.vocab, size=1024).tolist())


def serve_rwkv(torch, kern) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import rwkv
    cfg = get_config("rwkv6-1.6b")
    H, K = rwkv.rwkv_dims(cfg)
    print(f"[serve] {cfg.name} at published width and depth ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {H} WKV heads of {K}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}), {cfg.dtype}; attention-free: no "
          f"kernel of the port runs on this path", flush=True)
    lens = [512, 448, 384, 320, 256, 200, 160, 128, 96, 80, 64]
    return serve_family(
        torch, kern, cfg, label=cfg.name, n_engines=2, max_batch=8,
        max_seq=2048, prompts=seeded_prompts(cfg, lens), steps=16,
        flash_per_prefill=0, decode_per_step=0,
        # f32 WKV states and both token-shift inputs per layer, at any length
        kv_bytes=cfg.n_layers * H * K * K * 4 + 2 * cfg.n_layers
        * cfg.d_model * 4 + 4,
        consistency=(0, 128, 3))


def trace_granite(torch, kern) -> dict:
    """A short seeded trace through the port's TraceDriver over two granite
    engines with the torch backend: every admission and migration is a real
    prefill on the card (40 flash launches each), service times stay the
    CostModel's. Prints the TraceReport and the measured prefill seconds
    beside the modeled ones."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.config import ServingConfig
    from repro_torch.core.locstore import LocStore, StorageHierarchy, TierSpec
    from repro_torch.models import model as M
    from repro_torch.serve.engine import (Router, ServingEngine,
                                          TorchComputeBackend)
    from repro_torch.serve.traffic import (CostModel, TraceConfig, TraceDriver,
                                           generate_trace)
    cfg = get_config("granite-3-2b")
    max_seq, max_batch = 1024, 4
    tcfg = TraceConfig(n_sessions=24, followups_per_session=1.5,
                       req_rate=40.0, arrival="bursty", max_prompt=384,
                       max_output=128, seed=SEED)
    trace = generate_trace(tcfg)
    print(f"[trace] {cfg.name} full width, 2 engines x {max_batch} slots, "
          f"max_seq {max_seq}: {len(trace)} requests over "
          f"{tcfg.n_sessions} sessions (bursty, seed {SEED}, prompts <= "
          f"{tcfg.max_prompt}, outputs <= {tcfg.max_output}); histories are "
          f"capped at max_seq", flush=True)
    torch.cuda.reset_peak_memory_stats()
    model = M.init_params(cfg, SEED, device="cuda")
    config = ServingConfig(max_batch=max_batch, max_seq=max_seq)
    kv = TorchComputeBackend(cfg, max_seq).slot_nbytes()
    # HBM holds the live slots, the burst buffer 6 parked sessions a node
    hier = StorageHierarchy(
        [TierSpec("hbm", max_batch * kv, 3.35e12), TierSpec("bb", 6 * kv, 8e9)],
        remote=TierSpec("remote", float("inf"), 2e9))
    store = LocStore(2, hierarchy=hier, write_policy="back")
    engines = [ServingEngine(cfg, model, config=config, node=i, store=store)
               for i in range(2)]
    router = Router(engines, store)
    cost = CostModel()
    flash, decode = kern["flash"], kern["decode"]
    flash.launches = 0
    decode.launches = 0
    t0 = time.perf_counter()
    rep = TraceDriver(router, trace, cost=cost, warm=True,
                      max_history=max_seq).run()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    k1, k2 = flash.launches, decode.launches
    s = rep.summary()
    prefills = sum(e.prefills for e in engines)
    print(f"  report: " + json.dumps(s), flush=True)
    print(f"  {prefills} real prefills (new {s['new_sessions']:.0f} + lost "
          f"{s['lost_reprefills']:.0f} + migrations {s['migrations']:.0f}), "
          f"{s['resumes']:.0f} resumes, {sum(e.parks for e in engines)} "
          f"parks; flash_attention launches {k1} (40 x {prefills}); "
          f"decode_attention launches {k2}; driver wall {wall:.2f}s",
          flush=True)
    need(k1 > 0 and k1 == cfg.n_layers * prefills,
         f"trace: flash launches {k1} != 40 x {prefills}")
    need(prefills == s["new_sessions"] + s["lost_reprefills"]
         + s["migrations"], "trace: prefills do not match the report")
    need(s["requests"] == len(trace) and s["engine_full_errors"] == 0,
         f"trace: {s['requests']} requests, "
         f"{s['engine_full_errors']} engine-full errors")
    mean_prompt = float(np.mean([r.prompt_len for r in trace]))
    measured = [e.prefill_seconds for e in engines]
    print(f"  prefill seconds: measured (EMA per engine) {measured}; "
          f"CostModel at the mean prompt ({mean_prompt:.0f} tokens) "
          f"{cost.prefill_seconds(int(mean_prompt)):.4f}", flush=True)
    res = {"report": s, "prefills": prefills,
           "launches": {"flash_attention": k1, "decode_attention": k2},
           "prefill_seconds_measured": measured,
           "prefill_seconds_model": cost.prefill_seconds(int(mean_prompt)),
           "driver_wall_s": wall,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    return res


# ------------------------------------------------------------------ train phase
# gradient check: relative error norm per leaf, K1 under autograd against
# torch autograd of the plain version. f32: K1 f32 is within 2e-5 of the
# plain output (the kernel phase), so the gradients part by f32 noise that a
# 2-layer pass grows to ~1e-5 (read: 4.8e-6). bf16: the bf16 model's
# gradients move by ~1e-2 in every leaf under any one-rounding change of the
# attention output. K1 rounds P to bf16 before P V; the plain version with
# that one rounding reads 1.8e-2 against the plain one, as K1 does, and K1
# against it 1.4e-2 (K1 rounds at its running max, not the final one). A
# forward that drops one tile of keys (FAULT_TILE) reads 0.21. The limit
# sits between, ~3x from each (PERF.md section 6, PR 15).
GRAD_TOL = {"float32": 1e-4, "bfloat16": 6e-2}
# bf16 leaves whose gradient is a sum of cancelling terms (the vlm gates,
# zamba2's A_log) move under one rounding of P by more than GRAD_TOL; such a
# leaf's limit is this factor times that move (granite's leaves read
# <= 1.8e-2, so their limit stays GRAD_TOL)
ROUNDING_FACTOR = 3.0
# the planted fault the gradient check must see: a forward that skips the
# first 128-key tile (K1's bf16 tile at hd 64) for the query rows that see
# 8 tiles or more (causal S1024: rows 896..; non-causal over 1,500 frames or
# 1,601 patches: every row)
FAULT_TILE, FAULT_FROM_TILES = 128, 8
RESTART_RTOL = 2e-2             # the reference's own (tests/test_train.py)
# the f32 witness holds the bf16 run's losses to the same rtol as two runs
# of the reference (read: 1.5e-5, 2.7e-3, 1.1e-2 at steps 1-3)
WITNESS_RTOL = RESTART_RTOL


class _CountPlain:
    """Counts calls of the attention ops' plain versions while it is
    entered (the train path must run none: its forwards are the kernel's,
    its backward the chunked VJP, which calls neither)."""

    def __init__(self, ref) -> None:
        self.ref, self.calls = ref, 0

    def __enter__(self):
        self.orig = (self.ref.flash_attention_ref,
                     self.ref.decode_attention_ref)

        def counted(fn):
            def wrapper(*a, **k):
                self.calls += 1
                return fn(*a, **k)
            return wrapper

        self.ref.flash_attention_ref = counted(self.orig[0])
        self.ref.decode_attention_ref = counted(self.orig[1])
        return self

    def __exit__(self, *exc):
        self.ref.flash_attention_ref, self.ref.decode_attention_ref = \
            self.orig


def train_profiler(torch):
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    return torch_profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA], acc_events=True)


def profile_train_step(torch, fn) -> dict:
    """One warm-up and one timed call of ``fn`` (a train step ending in a
    host read of its loss), then one under torch.profiler
    (``train_profile``)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    with train_profiler(torch) as prof:
        fn()
        torch.cuda.synchronize()
    return train_profile(torch, prof, wall)


def train_profile(torch, prof, wall: float) -> dict:
    """A profiled train step against ``wall`` (the same step's wall in ms,
    timed without the profiler): device busy time (the union of the device
    events' spans, ``busy_ms``) and idle share, and the device time of K1,
    of every GEMM kernel, and of the two annotated ranges (the plain
    attention backward, AdamW)."""
    from torch.autograd import DeviceType

    from repro_torch.launch.profile_cell import (RANGES, busy_ms,
                                                 device_intervals)
    avg = prof.key_averages()
    dev = [(e.key, e.self_device_time_total / 1e3, e.count) for e in avg
           if getattr(e, "device_type", DeviceType.CPU) != DeviceType.CPU
           and e.self_device_time_total > 0 and e.key not in RANGES]
    dev.sort(key=lambda r: -r[1])
    busy = busy_ms(device_intervals(prof))
    ranges = {r: sum(e.device_time_total / 1e3 for e in avg if e.key == r
                     and getattr(e, "device_type", DeviceType.CPU)
                     == DeviceType.CPU) for r in RANGES}
    k1 = sum(t for k, t, _ in dev if "flash_tc_kernel" in k
             or "flash_kernel" in k)
    gemm = sum(t for k, t, _ in dev
               if re.search(r"gemm|xmma|nvjet|cutlass", k, re.I))
    launches = sum(e.count for e in avg if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
        "cuLaunchKernelEx"))
    out = {"wall_ms": wall, "device_busy_ms": busy,
           "device_event_sum_ms": sum(t for _, t, _ in dev),
           "idle_share": 1.0 - busy / wall if busy else None,
           "k1_forward_ms": k1, "gemm_kernels_ms": gemm,
           "plain_attention_backward_ms": ranges["flash_attention_bwd_plain"],
           "optimizer_ms": ranges["adamw_update"], "host_launches": launches,
           "top": [(k[:60], round(t, 3), n) for k, t, n in dev[:10]]}
    if busy == 0.0:
        print("  profile one train step: the profiler saw no device time "
              "(not measured)", flush=True)
        return out
    print(f"  profile one train step: device busy {busy:.1f} ms (union of "
          f"the device events; their sum {out['device_event_sum_ms']:.1f} "
          f"ms) of {wall:.1f} ms wall (idle share {out['idle_share']:.3f}); "
          f"{launches} kernel launches; K1 forward {k1:.1f} ms, plain "
          f"attention backward {out['plain_attention_backward_ms']:.1f} ms "
          f"(range), GEMM kernels {gemm:.1f} ms (all, the backward's f32 "
          f"products included), AdamW {out['optimizer_ms']:.1f} ms (range)",
          flush=True)
    for k, t, n in dev[:10]:
        print(f"    {t:9.2f} ms  x{n:5d}  {k[:90]}", flush=True)
    return out


def plain_attention(torch, q, k, v, *, causal: bool = True, window: int = 0,
                    softmax_scale: float | None = None, round_p: bool = False,
                    drop_tile: bool = False):
    """The plain attention in f32 (``ref.flash_attention_ref``'s math) with
    two options: ``round_p`` makes K1's one extra rounding (P = exp(s - max)
    rounded to bf16 before P V, its row sum taken in f32 before the
    rounding); ``drop_tile`` plants the fault of FAULT_TILE /
    FAULT_FROM_TILES."""
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    scale = hd ** -0.5 if softmax_scale is None else softmax_scale
    qf = q.float().reshape(B, Sq, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= qpos - kpos < window
    if drop_tile:
        seen = ok.sum(-1, keepdim=True)          # keys each row can see
        ok &= ~((seen > FAULT_TILE * (FAULT_FROM_TILES - 1))
                & (kpos < FAULT_TILE))
    s = s.masked_fill(~ok, -math.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    if round_p:
        p = p.to(torch.bfloat16).float()
    o = torch.einsum("bhgqk,bkhd->bqhgd", p / l, v.float())
    return o.reshape(B, Sq, Hq, v.shape[-1]).to(q.dtype)


def plain_forward_node(torch, ref, **opts):
    """``attention_op`` for the model: FlashAttentionFunction with the plain
    attention of ``opts`` as its forward; the same plain chunked backward."""

    class Node(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, window, softmax_scale):
            ctx.save_for_backward(q, k, v)
            ctx.opts = dict(causal=causal, window=window,
                            softmax_scale=softmax_scale)
            return plain_attention(torch, q, k, v, **ctx.opts, **opts)

        @staticmethod
        def backward(ctx, do):
            q, k, v = ctx.saved_tensors
            return (*ref.flash_attention_bwd_ref(q, k, v, do, **ctx.opts),
                    None, None, None)

    return lambda q, k, v, causal=True, window=0, softmax_scale=None: \
        Node.apply(q, k, v, causal, window, softmax_scale)


@contextlib.contextmanager
def attention_forward(op):
    """Every module's binding of ``attention_op`` (the model's self
    attention, ``layers.cross_attend``'s, MLA's) swapped for ``op``."""
    from repro_torch.models import layers, mla
    from repro_torch.models import model as M
    mods = (M, layers, mla)
    orig = [m.attention_op for m in mods]
    for m in mods:
        m.attention_op = op
    try:
        yield
    finally:
        for m, o in zip(mods, orig):
            m.attention_op = o


NORM_LEAVES = ("ln", "ln1", "ln2", "lnx", "norm", "final_norm", "enc_norm",
               "q_norm", "kv_norm")


def attention_norm_gate_leaf(name: str) -> bool:
    """The leaves a gradient check keeps where every leaf's gradient, four
    times over, does not fit the card: attention projections (GQA, cross,
    MLA), norm gains and the vlm gates."""
    leaf = name.split(".")[-1]
    return (".attn." in f".{name}" or ".xattn." in f".{name}"
            or leaf in NORM_LEAVES or leaf in ("gate", "gate_mlp"))


def seeded_batch(torch, cfg, B: int, S: int, seed: int = SEED) -> dict:
    """Tokens and next-token labels from default_rng(seed), and the family's
    frames / patches drawn on the card from a generator seeded with it."""
    import numpy as np
    from repro_torch.models import model as M
    x = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1))
    x = torch.from_numpy(x.astype(np.int32)).cuda()
    batch = {"tokens": x[:, :-1].contiguous(), "labels": x[:, 1:].contiguous()}
    key = M._EXTRAS.get(cfg.family)
    if key is not None:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        n = cfg.n_frames if key == "frames" else cfg.n_patches
        batch[key] = torch.randn((B, n, cfg.d_model), generator=gen,
                                 device="cuda")
    return batch


def open_gates(torch, model) -> None:
    """The vlm gates start at 0, and tanh(0) = 0 cuts the cross layers out
    of the path, the loss and every gradient behind them: set them to 0.5
    (tanh 0.462)."""
    with torch.no_grad():
        for xp in model.cross_blocks:
            xp["gate"].fill_(0.5)
            xp["gate_mlp"].fill_(0.5)


def grad_check(torch, kern, label: str, cfg, B: int, S: int, *,
               all_leaves: bool = True) -> dict:
    """``cfg`` (published width, a small depth): the gradient of the loss
    with K1 under autograd against the same with the plain forward (torch
    autograd of ``impl="plain"``) at every binding of ``attention_op``; the
    worst per-leaf relative error norm is checked against GRAD_TOL. The same
    reading of a forward with a planted fault (FAULT_TILE) must exceed
    GRAD_TOL. In bf16 the reading of a plain forward that rounds P as K1
    does (same backward) is printed beside K1's: it is the size of one such
    rounding. K1 must launch in the kernel's run and in no other. Without
    ``all_leaves`` the gradient is taken of the attention, norm and gate
    leaves only (``attention_norm_gate_leaf``)."""
    import functools

    from repro_torch.kernels import ops, ref
    from repro_torch.models import model as M
    dtype = cfg.dtype
    flash = kern["flash"]
    model = M.make_trainable(cfg, M.init_params(cfg, SEED, device="cuda"))
    if cfg.family == "vlm":
        open_gates(torch, model)
    batch = seeded_batch(torch, cfg, B, S)
    names, params = zip(*[(n, p) for n, p in model.named_parameters()
                          if all_leaves or attention_norm_gate_leaf(n)])
    forwards = {"kernel": ops.attention_op,
                "plain": functools.partial(ops.attention_op, impl="plain"),
                "tile dropped": plain_forward_node(torch, ref,
                                                   drop_tile=True)}
    if dtype == "bfloat16":
        forwards["plain, P in bf16"] = plain_forward_node(torch, ref,
                                                          round_p=True)
    loss, g, k1 = {}, {}, {}
    for name, op in forwards.items():
        n0 = flash.launches
        with attention_forward(op):
            out, _ = M.loss_fn(cfg, model, batch)
            loss[name] = out.item()
            g[name] = torch.autograd.grad(out, params)
        k1[name] = flash.launches - n0
        del out
    need(k1["kernel"] > 0 and all(n == 0 for f, n in k1.items()
                                  if f != "kernel"),
         f"grad check {label} {dtype}: K1 launches by forward {k1}")

    def rel(a_label, b_label):
        out = {}
        for n, a, b in zip(names, g[a_label], g[b_label]):
            den = b.float().norm().item()
            num = (a.float() - b.float()).norm().item()
            out[n] = num / den if den > 0 else num
            need(math.isfinite(out[n]),
                 f"grad check {label} {dtype}: {n} not finite ({a_label})")
        return out

    tol = GRAD_TOL[dtype]
    per_leaf = rel("kernel", "plain")
    # bf16: a leaf may move by up to ROUNDING_FACTOR x what one rounding of
    # P (the plain forward that rounds P as K1 does) moves it, never less
    # than GRAD_TOL (scalar leaves such as the vlm gates sum cancelling terms
    # and move more under one rounding than a weight matrix does)
    rounding = rel("plain, P in bf16", "plain") if "plain, P in bf16" in g \
        else {}
    limit = {n: max(tol, ROUNDING_FACTOR * rounding.get(n, 0.0))
             for n in names}
    ratio = {n: per_leaf[n] / limit[n] for n in names}
    worst_name = max(ratio, key=ratio.get)
    worst = per_leaf[worst_name]
    ok = ratio[worst_name] <= 1.0
    leaves = "every leaf" if all_leaves else \
        "the attention, norm and gate leaves"
    print(f"  grad check {label} {dtype} (B{B} S{S}; {leaves}, "
          f"{len(names)}): loss kernel {loss['kernel']:.6f} plain "
          f"{loss['plain']:.6f}; K1 launches {k1['kernel']}; worst per-leaf "
          f"relative error norm {worst:.3e} at {worst_name} against its "
          f"limit {limit[worst_name]:.3e} (GRAD_TOL {tol}; largest limit "
          f"{max(limit.values()):.3e}) {'ok' if ok else 'FAIL'}", flush=True)
    top = sorted(per_leaf.items(), key=lambda kv: -kv[1])[:12]
    print("    worst leaves, kernel vs plain: " + ", ".join(
        f"{n} {r:.2e}" for n, r in top), flush=True)
    res = {"worst": worst, "worst_leaf": worst_name,
           "worst_over_limit": ratio[worst_name], "leaves": len(names),
           "largest_limit": max(limit.values()), "k1_launches": k1["kernel"]}
    for a_label, against in (("plain, P in bf16", "plain"),
                             ("kernel", "plain, P in bf16"),
                             ("tile dropped", "plain")):
        if a_label not in g or against not in g:
            continue
        r = rel(a_label, against)
        n = max(r, key=r.get)
        res[f"{a_label} vs {against}"] = r[n]
        print(f"    {a_label} vs {against}: worst {r[n]:.3e} at {n}",
              flush=True)
    fault = rel("tile dropped", "plain")
    fault_name = max(names, key=lambda n: fault[n] / limit[n])
    fault_ratio = fault[fault_name] / limit[fault_name]
    res["fault_over_limit"] = fault_ratio
    print(f"    the planted fault reads {fault_ratio:.1f}x its leaf's limit "
          f"(at {fault_name}), the kernel {ratio[worst_name]:.2f}x",
          flush=True)
    need(ok, f"grad check {label} {dtype}: {worst_name} relative error "
         f"{worst} > {limit[worst_name]}")
    need(fault_ratio > 1.0, f"grad check {label} {dtype}: a forward that "
         f"drops a tile stays within every leaf's limit: the check cannot "
         f"see it")
    del model, g, params
    free_cuda(torch)
    return res


def f32_witness(torch, cfg, losses: list[float], B: int, S: int,
                steps: int) -> dict:
    """The train phase's steps again with f32 weights, gradients and
    moments (the same seed, so the bf16 run's weights are these rounded;
    the same corpus and schedule), in 4 microbatches of 2 so that the f32
    state and activations fit the card: a witness of the bf16 run's losses
    that makes none of its bf16 roundings (update, accumulation, the
    forward's activations), held to WITNESS_RTOL at every step."""
    from repro_torch.train.loop import TrainConfig, train
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    norms = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = train(cfg32, TrainConfig(steps=steps, batch=B, seq=S, microbatches=4,
                                 seed=SEED),
              device="cuda", on_step=lambda step, m: norms.append(
                  (m["grad_norm"].item(), m["lr"].item())))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, r.losses)]
    print(f"  f32 witness ({steps} steps of {B} x {S} in 4 microbatches, "
          f"f32 weights and moments, {wall:.1f}s, peak {peak / 2**30:.2f} "
          f"GiB): losses {[round(x, 6) for x in r.losses]} against bf16 "
          f"{[round(x, 6) for x in losses]} (relative difference "
          f"{[f'{x:.2e}' for x in rel]}); (grad norm, lr) "
          f"{[(round(g, 4), lr) for g, lr in norms]}", flush=True)
    need(len(r.losses) == steps and all(math.isfinite(x) for x in r.losses),
         f"f32 witness losses {r.losses}")
    need(max(rel) <= WITNESS_RTOL, f"f32 witness: bf16 losses {losses} vs "
         f"f32 {r.losses}, relative difference {rel} > {WITNESS_RTOL}")
    out = {"losses": r.losses, "relative_difference": rel, "wall_s": wall,
           "peak_memory_bytes": peak}
    del r
    return out


def train_granite(torch, kern) -> dict:
    """granite-3-2b at published width and depth, bf16 weights, f32 AdamW
    moments: three optimizer steps at seq 4096, a global batch of 8 in 2
    microbatches, through ``repro_torch.train.loop.train``; then a profiled
    step, the gradient check and the restart check."""
    import tempfile

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.kernels import ref
    from repro_torch.launch.profile_cell import PEAK_BF16_FLOPS
    from repro_torch.models import model as M
    from repro_torch.train.loop import TrainConfig, train
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    cfg = get_config("granite-3-2b")
    B, S, MB, STEPS = 8, 4096, 2, 3
    n_params = M.param_count(cfg)
    per_step = 2 * cfg.n_layers * MB
    print(f"[train] {cfg.name} at published width and depth ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads, hd {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab} padded "
          f"{M.padded_vocab(cfg)}; {n_params:,} params), {cfg.dtype} weights, "
          f"f32 moments and accumulator: {STEPS} steps of {B} x {S} tokens "
          f"in {MB} microbatches, per-layer recompute, random weights seed "
          f"{SEED}", flush=True)
    flash, decode = kern["flash"], kern["decode"]
    bwd = ref.flash_attention_bwd_ref
    marks, k1_steps, bwd_steps, norms = [], [], [], []

    def on_step(step, metrics):
        marks.append(time.perf_counter())
        k1_steps.append(flash.launches - sum(k1_steps))
        bwd_steps.append(bwd.calls - sum(bwd_steps))
        norms.append((metrics["grad_norm"].item(), metrics["lr"].item()))

    torch.cuda.reset_peak_memory_stats()
    flash.launches = 0
    decode.launches = 0
    bwd.calls = 0
    t0 = time.perf_counter()
    with _CountPlain(ref) as plain:
        r = train(cfg, TrainConfig(steps=STEPS, batch=B, seq=S,
                                   microbatches=MB, seed=SEED),
                  device="cuda", on_step=on_step)
    t_train = time.perf_counter() - t0
    k1, k2, n_bwd = flash.launches, decode.launches, bwd.calls
    peak = torch.cuda.max_memory_allocated()
    walls = [b - a for a, b in zip(marks, marks[1:])]
    print(f"  losses {[round(x, 6) for x in r.losses]}; (grad norm, lr) "
          f"{[(round(g, 4), lr) for g, lr in norms]}; train() wall "
          f"{t_train:.2f}s; steady step walls {[round(w, 4) for w in walls]}"
          f" s; data waits {r.data_waits}", flush=True)
    print(f"  launches: flash_attention {k1} ({k1_steps} per step, designed "
          f"2 x {cfg.n_layers} layers x {MB} microbatches = {per_step}); "
          f"decode_attention {k2}; plain attention backward {n_bwd} "
          f"({bwd_steps} per step); plain attention forwards {plain.calls}",
          flush=True)
    need(all(math.isfinite(x) for x in r.losses) and len(r.losses) == STEPS,
         f"train losses {r.losses}")
    need(k1 > 0 and k1_steps == [per_step] * STEPS,
         f"train: flash launches per step {k1_steps} != {per_step}")
    need(k2 == 0, f"train: decode launches {k2}")
    need(bwd_steps == [cfg.n_layers * MB] * STEPS,
         f"train: plain backwards per step {bwd_steps}")
    need(plain.calls == 0, f"train: {plain.calls} plain attention forwards")
    step_s = float(np.median(walls))
    tokens = B * S
    mfu = 6 * n_params * tokens / (step_s * PEAK_BF16_FLOPS)
    print(f"  step wall {step_s:.4f} s (median of steps 2-{STEPS}), "
          f"{tokens / step_s:.0f} tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB ({peak:,} B); model FLOPs utilisation "
          f"6 N tokens / (wall x {PEAK_BF16_FLOPS:.3g}) = {mfu:.4f} on "
          f"{card_line()}", flush=True)
    res = {"losses": r.losses, "step_wall_s": step_s, "step_walls_s": walls,
           "tokens_per_s": tokens / step_s, "peak_memory_bytes": peak,
           "mfu": mfu, "params": n_params,
           "launches": {"flash_attention": k1_steps[-1],
                        "decode_attention": 0},
           "plain_backward_per_step": bwd_steps[-1]}
    del r
    free_cuda(torch)
    res["f32_witness"] = f32_witness(torch, cfg, res["losses"], B, S, STEPS)
    free_cuda(torch)

    # one step of the same path under the profiler (fresh weights, seed
    # SEED; the corpus's first batch)
    model = M.make_trainable(cfg, M.init_params(cfg, SEED, device="cuda"))
    oc = OptConfig(warmup_steps=10, total_steps=STEPS)
    state = {"opt": init_opt_state(oc, dict(model.named_parameters()))}
    step_fn = make_train_step(cfg, oc, microbatches=MB)
    b = next(SyntheticCorpus(cfg.vocab, seed=SEED).batches(B, S))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
             for k, v in b.items()}

    def one():
        _, state["opt"], m = step_fn(model, state["opt"], batch)
        m["loss"].item()

    res["profile"] = profile_train_step(torch, one)
    del model, state, step_fn
    free_cuda(torch)

    res["grad_check"] = {dt: grad_check(
        torch, kern, cfg.name, dataclasses.replace(cfg, n_layers=2, dtype=dt),
        2, 1024) for dt in ("float32", "bfloat16")}
    free_cuda(torch)

    # restart: depth 4, checkpoints every 2 steps, a failure at step 5
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    tc = dict(steps=6, batch=4, seq=1024, ckpt_every=2, seed=SEED)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        failed = train(cfg4, TrainConfig(ckpt_dir=d, simulate_failure_at=5,
                                         **tc), device="cuda")
    base = train(cfg4, TrainConfig(**tc), device="cuda")
    diff = abs(failed.losses[-1] - base.losses[-1])
    same = failed.losses[-1] == base.losses[-1]
    ok = failed.restarts == 1 and failed.steps_done == 6 \
        and diff <= RESTART_RTOL * abs(base.losses[-1])
    print(f"  restart check (4 layers, B4 S1024, checkpoints every 2 steps, "
          f"failure at step 5, {time.perf_counter() - t0:.1f}s): final loss "
          f"{failed.losses[-1]:.6f} vs {base.losses[-1]:.6f} without failure "
          f"(|diff| {diff:.3e}, rtol {RESTART_RTOL}; "
          f"{'bit-identical' if same else 'not bit-identical'}); first loss "
          f"{base.losses[0]:.6f}, last {base.losses[-1]:.6f}; restarts "
          f"{failed.restarts} {'ok' if ok else 'FAIL'}", flush=True)
    need(ok, f"restart check: {failed.losses} vs {base.losses}")
    res["restart"] = {"failed_losses": failed.losses,
                      "base_losses": base.losses, "abs_diff": diff,
                      "bit_identical": same}
    print("  " + json.dumps({k: v for k, v in res.items()
                             if k not in ("profile",)}), flush=True)
    return res


# ------------------------------------------------------------ family training
def attention_applications(cfg) -> int:
    """Attention applications of one pass that are recomputed in training:
    every encoder, decoder self and cross layer (encdec), every layer (vlm,
    moe), each application of the shared block (hybrid), none (rwkv). The
    moe family's MTP block adds one, not recomputed."""
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "rwkv":
        return 0
    return cfg.n_layers


# The five families' train phases: published width, the depth one card
# holds; steps 1 (warm-up), 2 (timed) and 3 (profiled); the gradient check
# at published width and a small depth (the config fields in "cut"; B, S),
# on every leaf or on the attention, norm and gate leaves where four sets of
# every leaf's gradient do not fit. rwkv has no attention and no check; its
# scan runs token by token, ~43 launches per token and layer a step
# (1.05 million a step at B4 S1024, 40.4 s: PERF.md), so it trains the same
# 4,096 tokens a step as B64 S64 (``--train-phase rwkv6-1.6b 4 1024`` runs
# the B4 S1024 step).
TRAIN_PHASES = [
    dict(arch="whisper-medium", layers=None, B=8, S=448, moments="float32",
         check=dict(cut=dict(n_layers=2, encoder_layers=2), B=2, S=448,
                    all_leaves=True)),
    dict(arch="llama-3.2-vision-90b", layers=5, B=2, S=1024,
         moments="bfloat16", check=dict(cut=dict(n_layers=5), B=1, S=1024,
                                        all_leaves=False)),
    dict(arch="deepseek-v3-671b", layers=4, B=1, S=1024, moments=None,
         check=dict(cut=dict(n_layers=3), B=1, S=1024, all_leaves=False)),
    dict(arch="zamba2-7b", layers=None, B=2, S=2048, moments="bfloat16",
         check=dict(cut=dict(n_layers=12), B=1, S=2048, all_leaves=True)),
    dict(arch="rwkv6-1.6b", layers=None, B=64, S=64, moments="float32",
         check=None),
]
TRAIN_STEPS = 3


@contextlib.contextmanager
def gates_opened(torch, M):
    """``init_params`` of a vlm model opens its gates (``open_gates``), so
    that ``train()`` trains the cross layers from its first step."""
    orig = M.init_params

    def init(cfg, *a, **kw):
        model = orig(cfg, *a, **kw)
        if cfg.family == "vlm":
            open_gates(torch, model)
        return model

    M.init_params = init
    try:
        yield
    finally:
        M.init_params = orig


def train_family(torch, kern, spec: dict) -> dict:
    """One family's train phase: TRAIN_STEPS steps of ``spec`` through
    ``repro_torch.train.loop.train`` (deepseek: the loss and its gradient,
    no optimizer, as one card cannot hold its AdamW state), the third under
    the profiler; K1 launches and plain backwards checked every step, no
    plain forward and no decode kernel; then the gradient check in f32 and
    bf16."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.kernels import ref
    from repro_torch.launch.op_analysis import forward_flops
    from repro_torch.launch.profile_cell import PEAK_BF16_FLOPS
    from repro_torch.models import model as M
    from repro_torch.train.loop import TrainConfig, train
    from repro_torch.train.optimizer import OptConfig
    full = get_config(spec["arch"])
    cfg = full if spec["layers"] is None else \
        dataclasses.replace(full, n_layers=spec["layers"])
    B, S, steps = spec["B"], spec["S"], TRAIN_STEPS
    apps, mtp = attention_applications(cfg), cfg.mtp_depth
    k1_design, bwd_design = 2 * apps + mtp, apps + mtp
    n_params = M.param_count(cfg)
    optimizer = spec["moments"] is not None
    depth = f"depth cut {full.n_layers} -> {cfg.n_layers}" \
        if cfg.n_layers != full.n_layers else "published depth"
    print(f"[train] {full.name} at published width, {depth} ({n_params:,} "
          f"params, {cfg.dtype} weights; "
          + (f"AdamW with {spec['moments']} moments" if optimizer else
             "loss and gradient only, no optimizer step")
          + f"): {steps} steps of {B} x {S} tokens, one microbatch, per-layer "
          f"recompute, random weights seed {SEED}; K1 designed "
          f"2 x {apps} applications" + (f" + {mtp} (MTP)" if mtp else "")
          + f" = {k1_design} a step", flush=True)
    flash, decode = kern["flash"], kern["decode"]
    bwd = ref.flash_attention_bwd_ref
    marks, k1_steps, bwd_steps, metrics_read = [], [], [], []
    prof = train_profiler(torch)

    def on_step(step, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        k1_steps.append(flash.launches - sum(k1_steps))
        bwd_steps.append(bwd.calls - sum(bwd_steps))
        metrics_read.append({k: float(v) for k, v in metrics.items()})
        if step == steps - 1:
            prof.start()
        elif step == steps:
            prof.stop()

    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    flash.launches = 0
    decode.launches = 0
    bwd.calls = 0
    t0 = time.perf_counter()
    with _CountPlain(ref) as plain, gates_opened(torch, M):
        if optimizer:
            oc = OptConfig(warmup_steps=10, total_steps=steps,
                           moment_dtype=spec["moments"])
            r = train(cfg, TrainConfig(steps=steps, batch=B, seq=S,
                                       seed=SEED), oc, on_step=on_step,
                      device="cuda")
            losses, waits = r.losses, r.data_waits
            del r
        else:
            model = M.make_trainable(cfg, M.init_params(cfg, SEED,
                                                        device="cuda"))
            params = [p for _, p in model.named_parameters()]
            it = SyntheticCorpus(cfg.vocab, seed=SEED).batches(B, S)
            losses, waits = [], 0
            for step in range(1, steps + 1):
                batch = {k: torch.from_numpy(v).cuda()
                         for k, v in next(it).items()}
                loss, metrics = M.loss_fn(cfg, model, batch)
                grads = torch.autograd.grad(loss, params)
                losses.append(loss.item())
                del loss, grads
                on_step(step, metrics)
            del model, params
    t_train = time.perf_counter() - t0
    k2 = decode.launches
    peak = torch.cuda.max_memory_allocated()
    walls = [b - a for a, b in zip(marks, marks[1:])]
    print(f"  losses {[round(x, 6) for x in losses]}; metrics "
          f"{[{k: round(v, 6) for k, v in m.items()} for m in metrics_read]}"
          f"; {t_train:.2f}s; step walls {[round(w, 4) for w in walls]} s "
          f"(the last profiled); data waits {waits}", flush=True)
    print(f"  launches: flash_attention {k1_steps} per step (designed "
          f"{k1_design}); decode_attention {k2}; plain attention backward "
          f"{bwd_steps} per step (designed {bwd_design}); plain attention "
          f"forwards {plain.calls}", flush=True)
    need(len(losses) == steps and all(math.isfinite(x) for x in losses),
         f"train {cfg.name}: losses {losses}")
    need(k1_steps == [k1_design] * steps and (k1_design > 0 or apps == 0),
         f"train {cfg.name}: flash launches per step {k1_steps} != "
         f"{k1_design}")
    need(bwd_steps == [bwd_design] * steps,
         f"train {cfg.name}: plain backwards per step {bwd_steps} != "
         f"{bwd_design}")
    need(k2 == 0, f"train {cfg.name}: decode launches {k2}")
    need(plain.calls == 0, f"train {cfg.name}: {plain.calls} plain attention "
         f"forwards")
    step_s = walls[0]
    tokens = B * S
    flops = 3 * forward_flops(cfg, B, S)
    mfu = flops / (step_s * PEAK_BF16_FLOPS)
    six_n = 6 * n_params * tokens / (step_s * PEAK_BF16_FLOPS)
    card = card_line()
    print(f"  step wall {step_s:.4f} s (step 2), {tokens / step_s:.0f} "
          f"tokens/s, peak memory {peak / 2**30:.2f} GiB ({peak:,} B); "
          f"model FLOPs a step {flops:.4e} (3 x the forward's matmul FLOPs; "
          f"the recompute not counted), MFU {mfu:.4f} (6 N tokens would "
          f"say {six_n:.4f}) on {card}", flush=True)
    res = {"losses": losses, "step_wall_s": step_s, "step_walls_s": walls,
           "tokens_per_s": tokens / step_s, "peak_memory_bytes": peak,
           "model_flops": flops, "mfu": mfu, "mfu_6n": six_n,
           "params": n_params,
           "launches": {"flash_attention": k1_steps[-1],
                        "decode_attention": 0},
           "plain_backward_per_step": bwd_steps[-1]}
    res["profile"] = train_profile(torch, prof, 1e3 * step_s)
    del prof
    free_cuda(torch)
    chk = spec["check"]
    if chk is None:
        print(f"  no gradient check: {cfg.name} runs no attention, so the "
              f"kernel's and the plain forward's runs are the same run",
              flush=True)
    else:
        cut = ", ".join(f"{k} {v}" for k, v in chk["cut"].items())
        res["grad_check"] = {dt: grad_check(
            torch, kern, f"{full.name} ({cut})",
            dataclasses.replace(full, dtype=dt, **chk["cut"]),
            chk["B"], chk["S"], all_leaves=chk["all_leaves"])
            for dt in ("float32", "bfloat16")}
    print("  " + json.dumps({k: v for k, v in res.items()
                             if k not in ("profile",)}), flush=True)
    return res


# ------------------------------------------------------------------ main
# ------------------------------------------------------------- workflows
# the quickstart's result on the card against the same graph with CPU bodies:
# two f32 FFTs of 8 Mi points and sums over 4 Mi magnitudes, whose order of
# summation differs between the two (read: ~1e-7)
QUICKSTART_RTOL = 1e-4
# the epoch workflow: granite-3-2b at published width, depth cut to 4 (as
# the restart check), 4 steps of 8 x 4096 tokens in 2 microbatches, each
# step's batch loaded as 4 shards of 2 rows
EPOCH = dict(n_steps=4, n_dp=4, batch=8, seq=4096, microbatches=2)
EPOCH_LAYERS = 4
EPOCH_RTOL = 1e-5                     # its losses against train()'s


def workflow_quickstart(torch, kern) -> dict:
    """The quickstart's graph on the card: 64 MiB of seeded f32 as a pinned
    host tensor, bodies on cuda:0, both nodes mapped to cuda:0; held to the
    same graph run with CPU bodies. The card run is made twice: the first
    pays cuFFT's plans and the workers' first CUDA calls, the second is
    the one reported in full, with the kernels' launches counted (the
    graph has no attention: both counts must stay 0). The graph and its
    bodies are the quickstart example's."""
    import numpy as np

    from repro_torch.examples.quickstart import RAW_BYTES, run_quickstart
    raw = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        RAW_BYTES // 4).astype(np.float32)).pin_memory()
    _, cpu = run_quickstart(raw, torch.device("cpu"))
    dev = torch.device("cuda", 0)
    flash, decode = kern["flash"], kern["decode"]
    _, first = run_quickstart(raw, dev, lambda node: dev)
    flash.launches = 0
    decode.launches = 0
    ex, res = run_quickstart(raw, dev, lambda node: dev)
    torch.cuda.synchronize()
    launches = {"flash_attention": flash.launches,
                "decode_attention": decode.launches}
    need(first.outputs["out"] == res.outputs["out"],
         f"workflow quickstart: two card runs give {first.outputs['out']} "
         f"and {res.outputs['out']}")
    out, want = res.outputs["out"], cpu.outputs["out"]
    rel = abs(out - want) / abs(want)
    recs = res.task_records
    per_task = {t: (r["node"], round(r["io_wait"] * 1e3, 3),
                    round(r["run"] * 1e3, 3)) for t, r in sorted(recs.items())}
    split_at = recs["split"]["node"]
    homes = {n: ex.store.stat(n).real_loc for n in ("a", "b")}
    print(f"[workflow] quickstart (split, fft_a, fft_b, merge over "
          f"{RAW_BYTES:,} B of pinned f32; ProactiveScheduler, 2 nodes"
          f" on cuda:0): out {out!r} vs CPU bodies {want!r} (rel {rel:.3e},"
          f" rtol {QUICKSTART_RTOL}); wall {res.wall_seconds * 1e3:.3f} ms "
          f"(first card run {first.wall_seconds * 1e3:.3f} ms; CPU bodies "
          f"{cpu.wall_seconds * 1e3:.3f} ms); io_wait "
          f"{res.io_wait_total * 1e3:.3f} ms; split ran at node {split_at},"
          f" its outputs at {homes}; launches {launches}; tasks "
          f"{per_task} "
          f"(node, io_wait ms, run ms) on {card_line()}", flush=True)
    need(math.isfinite(out) and rel <= QUICKSTART_RTOL,
         f"workflow quickstart: out {out} vs {want} (rel {rel:.3e})")
    need(sorted(recs) == ["fft_a", "fft_b", "merge", "split"],
         f"workflow quickstart: tasks that ran {sorted(recs)}")
    need(all(v == split_at for v in homes.values()),
         f"workflow quickstart: split ran at {split_at}, outputs at {homes}")
    need(launches == {"flash_attention": 0, "decode_attention": 0},
         f"workflow quickstart: attention kernels launched {launches}")
    return {"out": out, "cpu_out": want, "rel": rel,
            "wall_s": res.wall_seconds, "first_wall_s": first.wall_seconds,
            "cpu_wall_s": cpu.wall_seconds, "launches": launches}


def epoch_bodies(torch, cfg, opt_cfg, *, n_steps: int, n_dp: int,
                 batch: int, seq: int, microbatches: int, device,
                 record: dict) -> dict:
    """Bodies of ``epoch_workflow``'s tasks. ``load_s_d`` yields rows
    ``[d * batch / n_dp, (d + 1) * batch / n_dp)`` of step ``s``'s
    ``SyntheticCorpus.batches(batch, seq)`` batch as one (rows, seq + 1)
    int32 tensor (pinned on a CUDA run); ``step_s`` concatenates its parts
    and runs ``make_train_step`` on the model and optimizer state it
    received as ``params{s}``. ``record`` gets each step's loss, its K1
    launches and how many of its parts arrived on the card."""
    import numpy as np
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.train.train_step import make_train_step
    step_fn = make_train_step(cfg, opt_cfg, microbatches=microbatches)
    rows = batch // n_dp
    pin = device.type == "cuda"
    for key in ("losses", "k1", "parts_on_card"):
        record[key] = [None] * n_steps

    def load(s: int, d: int):
        def body(corpus):
            b = next(corpus.batches(batch, seq, start_step=s))
            x = np.concatenate([b["tokens"], b["labels"][:, -1:]], axis=1)
            t = torch.from_numpy(np.ascontiguousarray(
                x[d * rows:(d + 1) * rows]))
            return {f"batch_{s}_{d}": t.pin_memory() if pin else t}
        return body

    def step(s: int):
        def body(**inputs):
            state = inputs[f"params{s}"]
            parts = [inputs[f"batch_{s}_{d}"] for d in range(n_dp)]
            record["parts_on_card"][s] = sum(p.is_cuda for p in parts)
            x = torch.cat([p.to(device, non_blocking=True) for p in parts])
            tokens = {"tokens": x[:, :-1].contiguous(),
                      "labels": x[:, 1:].contiguous()}
            n0 = flash_attention.launches
            model, opt, metrics = step_fn(state["model"], state["opt"],
                                          tokens)
            record["losses"][s] = float(metrics["loss"])
            record["k1"][s] = flash_attention.launches - n0
            return {f"params{s + 1}": {"model": model, "opt": opt}}
        return body

    bodies = {f"step_{s}": step(s) for s in range(n_steps)}
    bodies.update({f"load_{s}_{d}": load(s, d) for s in range(n_steps)
                   for d in range(n_dp)})
    return bodies


def run_epoch_workflow(torch, cfg, opt_cfg, *, seed: int, device,
                       record: dict, **epoch):
    """(executor, result) of a training epoch as a workflow: the port's
    ``epoch_workflow`` through the ProactiveScheduler on ``n_dp`` nodes,
    all mapped to ``device``, on a store whose top tier is the device's
    HBM, from the seeded init ``train()`` starts from."""
    from repro_torch import core as C
    from repro_torch.data.pipeline import SyntheticCorpus, epoch_workflow
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import init_opt_state
    tokens = epoch["batch"] * epoch["seq"]
    g = epoch_workflow(cfg, n_steps=epoch["n_steps"], n_dp=epoch["n_dp"],
                       batch=epoch["batch"], seq=epoch["seq"],
                       step_flops=6 * M.param_count(cfg) * tokens)
    wf = C.compile_workflow(g)
    for tid, fn in epoch_bodies(torch, cfg, opt_cfg, device=device,
                                record=record, **epoch).items():
        wf.graph.tasks[tid].fn = fn
    model = M.make_trainable(cfg, M.init_params(cfg, seed, device=device))
    opt = init_opt_state(opt_cfg, dict(model.named_parameters()))
    ex = C.WorkflowExecutor(
        wf, C.ProactiveScheduler(wf), n_nodes=epoch["n_dp"],
        hierarchy=C.tiered_hierarchy(), device_of=lambda node: device,
        inject_inputs={"corpus": SyntheticCorpus(cfg.vocab, seed=seed),
                       "params0": {"model": model, "opt": opt}})
    del model, opt
    return ex, ex.run()


def workflow_epoch(torch, kern) -> dict:
    """A training epoch of granite-3-2b (published width, 4 layers) as a
    workflow on the card, against ``train()`` over the same corpus, seed,
    OptConfig and microbatches. The two run in the order loop, workflow,
    workflow, loop, so that neither wall is read only first or only last;
    each workflow run is held to the loop's losses and counted alone."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.train.loop import TrainConfig, train
    from repro_torch.train.optimizer import OptConfig
    cfg = dataclasses.replace(get_config("granite-3-2b"),
                              n_layers=EPOCH_LAYERS)
    n_steps, mb = EPOCH["n_steps"], EPOCH["microbatches"]
    per_step = 2 * cfg.n_layers * mb
    oc = OptConfig(warmup_steps=10, total_steps=n_steps)
    dev = torch.device("cuda", 0)
    flash, decode = kern["flash"], kern["decode"]
    print(f"[workflow] epoch: {cfg.name} at published width (d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, hd "
          f"{cfg.hd}), depth cut to {cfg.n_layers}; {n_steps} steps of "
          f"{EPOCH['batch']} x {EPOCH['seq']} tokens in {mb} microbatches, "
          f"{EPOCH['n_dp']} loads a step; ProactiveScheduler, "
          f"{EPOCH['n_dp']} nodes on cuda:0, tiered store (hbm top); order "
          f"loop, workflow, workflow, loop", flush=True)
    torch.cuda.reset_peak_memory_stats()

    def run_loop():
        marks = []
        t0 = time.perf_counter()
        loop = train(cfg, TrainConfig(steps=n_steps, batch=EPOCH["batch"],
                                      seq=EPOCH["seq"], microbatches=mb,
                                      seed=SEED), oc, device="cuda",
                     on_step=lambda step, m: marks.append(
                         time.perf_counter()))
        wall = time.perf_counter() - t0
        out = {"losses": loop.losses, "wall_s": loop.wall_seconds,
               "init_wall_s": wall,
               "step_s": [b - a for a, b in zip(marks, marks[1:])]}
        del loop
        free_cuda(torch)
        return out

    def run_workflow():
        record: dict = {}
        flash.launches = 0
        decode.launches = 0
        with _CountPlain(ref) as plain:
            t0 = time.perf_counter()
            ex, res = run_epoch_workflow(torch, cfg, oc, seed=SEED,
                                         device=dev, record=record, **EPOCH)
            wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        recs = res.task_records
        steps = [f"step_{s}" for s in range(n_steps)]
        out = {"losses": record["losses"], "wall_s": res.wall_seconds,
               "init_wall_s": wall, "k1": flash.launches,
               "k2": decode.launches, "plain": plain.calls,
               "k1_per_step": record["k1"],
               "parts_on_card": record["parts_on_card"],
               "step_s": [recs[t]["run"] for t in steps[1:]],
               "step_io_wait_s": [recs[t]["io_wait"] for t in steps],
               "step_run_s": [recs[t]["run"] for t in steps],
               "io_wait_s": res.io_wait_total,
               "bytes_prefetched": res.bytes_prefetched,
               "locality_hit_rate": res.locality_hit_rate,
               "prefetch": ex.prefetch.report(),
               "tasks": {t: [r["node"], r["io_wait"], r["run"]]
                         for t, r in sorted(recs.items())},
               "movement": ex.store.movement_report()}
        del ex, res
        free_cuda(torch)
        return out

    loops = [run_loop()]
    wfs = [run_workflow(), run_workflow()]
    loops.append(run_loop())
    want = loops[0]["losses"]
    n_parts = n_steps * EPOCH["n_dp"]
    for i, w in enumerate(wfs):
        losses = w["losses"]
        w["worst"] = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        w["taken"] = sum(w["parts_on_card"])
        print(f"  workflow run {i + 1}: losses {losses} vs train() {want}: "
              f"max rel {w['worst']:.3e} (rtol {EPOCH_RTOL}; "
              f"{'bit-identical' if losses == want else 'not bit-identical'}"
              f"); launches: flash_attention {w['k1']} ({w['k1_per_step']} "
              f"per step, designed 2 x {cfg.n_layers} layers x {mb} "
              f"microbatches = {per_step}); decode_attention {w['k2']}; "
              f"plain attention forwards {w['plain']}; batch inputs taken "
              f"through device_copy: {w['taken']} of {n_parts} "
              f"({w['parts_on_card']} per step); prefetch {w['prefetch']}; "
              f"bytes_prefetched {w['bytes_prefetched']:,.0f}; locality hit "
              f"rate {w['locality_hit_rate']:.4f}", flush=True)
    print(f"  wall (executor run / train(), without the model's init): "
          f"loop {loops[0]['wall_s']:.4f} s, workflow {wfs[0]['wall_s']:.4f}"
          f" s, workflow {wfs[1]['wall_s']:.4f} s, loop "
          f"{loops[1]['wall_s']:.4f} s (with the init: "
          f"{[round(r['init_wall_s'], 4) for r in (loops[0], *wfs, loops[1])]}"
          f" s) for the same {n_steps} steps; steps 2-{n_steps}: workflow "
          f"{[[round(x, 4) for x in w['step_s']] for w in wfs]} s (task run),"
          f" loop {[[round(x, 4) for x in r['step_s']] for r in loops]} s "
          f"(between on_step calls); peak memory "
          f"{torch.cuda.max_memory_allocated():,} B on {card_line()}",
          flush=True)
    last = wfs[-1]
    print(f"  run 2: io_wait total {last['io_wait_s']:.6f} s; step io_wait "
          f"{[round(x, 6) for x in last['step_io_wait_s']]} s, run "
          f"{[round(x, 4) for x in last['step_run_s']]} s", flush=True)
    print("  run 2 tasks (node, io_wait s, run s): "
          + json.dumps(last["tasks"]), flush=True)
    print("  run 2 movement_report: " + json.dumps(last["movement"]),
          flush=True)
    need(loops[1]["losses"] == want,
         f"workflow epoch: train() gave {want}, then {loops[1]['losses']}")
    for i, w in enumerate(wfs, 1):
        losses = w["losses"]
        need(all(x is not None and math.isfinite(x) for x in losses),
             f"workflow epoch run {i}: losses {losses}")
        need(w["worst"] <= EPOCH_RTOL,
             f"workflow epoch run {i}: losses {losses} vs train() {want}")
        need(w["k1_per_step"] == [per_step] * n_steps
             and w["k1"] == per_step * n_steps,
             f"workflow epoch run {i}: K1 launches {w['k1']}, per step "
             f"{w['k1_per_step']} != {per_step}")
        need(w["k2"] == 0 and w["plain"] == 0,
             f"workflow epoch run {i}: {w['k2']} decode launches, "
             f"{w['plain']} plain forwards")
        need(w["bytes_prefetched"] > 0,
             f"workflow epoch run {i}: nothing was prefetched")
        need(w["taken"] >= 1, f"workflow epoch run {i}: no batch input came "
                              f"through device_copy")
    return {"losses": last["losses"], "loop_losses": want,
            "bit_identical": [w["losses"] == want for w in wfs],
            "max_rel": max(w["worst"] for w in wfs),
            "wall_s": [w["wall_s"] for w in wfs],
            "loop_wall_s": [r["wall_s"] for r in loops],
            "step_s": [w["step_s"] for w in wfs],
            "loop_step_s": [r["step_s"] for r in loops],
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "io_wait_s": last["io_wait_s"],
            "parts_on_card": [w["taken"] for w in wfs],
            "bytes_prefetched": last["bytes_prefetched"],
            "device_hits": last["prefetch"]["device_hits"],
            "launches": {"flash_attention": last["k1_per_step"][-1],
                         "decode_attention": last["k2"]}}


# ------------------------------------------------------------------- dist
# the dist phase: one rank of NCCL on cuda:0, a ("data", "model") 1x1 mesh.
# deepseek-v3 as in TRAIN_PHASES (published width, 4 layers: 3 dense + 1
# MoE, + MTP; B1 S1024): its loss and gradient through the global MoE path
# unmeshed and through the sharded path under the rules. granite-3-2b at
# published width, depth 4 (as the restart check): two AdamW steps of
# 8 x 4096 tokens in 2 microbatches with grad_specs under the rules, and the
# same two steps unmeshed.
DIST_DEEPSEEK = dict(arch="deepseek-v3-671b", layers=4, B=1, S=1024)
DIST_GRANITE = dict(arch="granite-3-2b", layers=4, B=8, S=4096,
                    microbatches=2, steps=2)
# the reference's own tolerance for mean + err against x
# (tests/test_compression.py)
COMPRESS_TOL = 1e-6
FP_CHUNK = 1 << 26                    # elements per fingerprint slice


@contextlib.contextmanager
def moe_paths():
    """Counts calls of the MoE layer's global and sharded paths."""
    from repro_torch.models import moe
    calls = {"global": 0, "sharded": 0}
    orig = (moe._moe_ffn_global, moe._moe_ffn_sharded)

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    moe._moe_ffn_global = counted("global", orig[0])
    moe._moe_ffn_sharded = counted("sharded", orig[1])
    try:
        yield calls
    finally:
        moe._moe_ffn_global, moe._moe_ffn_sharded = orig


def fingerprint(torch, g, seed: int) -> tuple[float, float, float]:
    """(sum, sum of squares, a seeded random projection) of a gradient leaf,
    in f64 on the card, slice by slice (a whole f64 copy of an expert leaf
    would not fit): the same bits give the same three numbers."""
    f = g.reshape(-1)
    gen = torch.Generator(device=g.device)
    gen.manual_seed(seed)
    acc = torch.zeros(3, dtype=torch.float64, device=g.device)
    for i in range(0, f.numel(), FP_CHUNK):
        c = f[i:i + FP_CHUNK].double()
        r = torch.randn(c.numel(), generator=gen, device=g.device,
                        dtype=torch.float32)
        acc += torch.stack([c.sum(), (c * c).sum(), (c * r).sum()])
    return tuple(acc.tolist())


def dist_deepseek(torch, kern, mesh) -> dict:
    """deepseek-v3's loss and gradient twice, unmeshed (global MoE path)
    and under sharding_rules(mesh) (sharded path, its collectives on NCCL).
    The first gradient is fingerprinted per leaf and freed before the second
    (one gradient peaked at 61.10 GiB); the router, norm and attention
    leaves are also copied to the host whole."""
    from repro_torch.configs import get_config
    from repro_torch.dist.hints import sharding_rules
    from repro_torch.models import model as M
    spec = DIST_DEEPSEEK
    cfg = dataclasses.replace(get_config(spec["arch"]),
                              n_layers=spec["layers"])
    flash, decode = kern["flash"], kern["decode"]
    apps = attention_applications(cfg)
    k1_design = 2 * apps + cfg.mtp_depth
    print(f"[dist] {cfg.name} at published width, depth cut to "
          f"{cfg.n_layers} (+ MTP), B{spec['B']} S{spec['S']}: loss and "
          f"gradient unmeshed (global MoE path) and under the rules of the "
          f"1x1 mesh (sharded path); K1 designed {k1_design} a gradient",
          flush=True)
    t0 = time.perf_counter()
    model = M.make_trainable(cfg, M.init_params(cfg, SEED, device="cuda"))
    batch = seeded_batch(torch, cfg, spec["B"], spec["S"])
    names, params = zip(*model.named_parameters())
    whole = [n for n in names if attention_norm_gate_leaf(n)
             or n.endswith(".router")]
    torch.cuda.synchronize()
    print(f"  {M.param_count(cfg):,} params initialised in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)

    def rules(meshed: bool):
        return sharding_rules(mesh) if meshed else contextlib.nullcontext()

    # one gradient each way first: the walls below time the gradient, not
    # the first call's lazy set-up (the backward's GEMM handles and
    # workspaces, imports)
    for meshed in (False, True):
        with rules(meshed):
            loss, _ = M.loss_fn(cfg, model, batch)
            torch.autograd.grad(loss, params)
        del loss
        free_cuda(torch)

    def run(meshed: bool) -> dict:
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        flash.launches = 0
        decode.launches = 0
        t0 = time.perf_counter()
        with moe_paths() as calls, rules(meshed):
            loss, _ = M.loss_fn(cfg, model, batch)
            grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k2 = flash.launches, decode.launches
        out = {"loss": loss.item(), "k1": k1, "k2": k2,
               "calls": dict(calls), "wall_s": wall,
               "peak": torch.cuda.max_memory_allocated(),
               "fp": {n: fingerprint(torch, g, SEED + i)
                      for i, (n, g) in enumerate(zip(names, grads))},
               "host": {n: g.cpu() for n, g in zip(names, grads)
                        if n in whole}}
        del loss, grads
        free_cuda(torch)
        return out

    a = run(False)
    b = run(True)
    c = run_sharded(torch, cfg, model, batch, mesh, kern, whole)
    for label, r in (("unmeshed", a), ("meshed", b), ("sharded", c)):
        print(f"  {label}: loss {r['loss']!r}; K1 launches {r['k1']}, K2 "
              f"{r['k2']}; MoE "
              f"paths {r['calls']}; {r['wall_s']:.3f}s; peak "
              f"{r['peak'] / 2**30:.2f} GiB", flush=True)
    n_moe = 2 * (cfg.n_layers - cfg.first_dense_layers)   # + recompute
    need(a["calls"] == {"global": n_moe, "sharded": 0},
         f"dist deepseek unmeshed: MoE paths {a['calls']}")
    need(b["calls"] == {"global": 0, "sharded": n_moe},
         f"dist deepseek meshed: MoE paths {b['calls']} (the sharded path "
         f"was not taken)")
    need(a["k1"] == k1_design and b["k1"] == k1_design,
         f"dist deepseek: K1 launches {a['k1']}, {b['k1']} != {k1_design}")
    need(a["k2"] == 0 and b["k2"] == 0,
         f"dist deepseek: decode launches {a['k2']}, {b['k2']}")
    need(math.isfinite(a["loss"]) and math.isfinite(b["loss"]),
         f"dist deepseek: losses {a['loss']}, {b['loss']}")
    same_fp = [n for n in names if a["fp"][n] == b["fp"][n]]
    same_host = [n for n in whole if torch.equal(a["host"][n],
                                                 b["host"][n])]
    bits = a["loss"] == b["loss"] and len(same_fp) == len(names) \
        and len(same_host) == len(whole)
    tol = GRAD_TOL["bfloat16"]
    worst, worst_name = 0.0, None
    if not bits:
        # the bf16 gradient-check bound: each whole leaf's relative error
        # norm; a fingerprinted leaf's from its projection (one draw) and
        # its norm
        for n in names:
            if n in whole:
                x, y = a["host"][n].float(), b["host"][n].float()
                den = y.norm().item()
                r = (x - y).norm().item() / den if den > 0 else 0.0
            else:
                (_, sq_a, p_a), (_, sq_b, p_b) = a["fp"][n], b["fp"][n]
                nb = math.sqrt(sq_b)
                r = max(abs(p_a - p_b), abs(math.sqrt(sq_a) - nb)) / nb \
                    if nb > 0 else 0.0
            if r > worst:
                worst, worst_name = r, n
    held = "bit-identical" if bits else \
        f"within the bf16 gradient-check bound {tol}"
    print(f"  meshed vs unmeshed: loss {'equal' if a['loss'] == b['loss'] else 'differs'}; "
          f"fingerprints equal on {len(same_fp)}/{len(names)} leaves, whole "
          f"leaves equal {len(same_host)}/{len(whole)}; "
          + ("bit-identical" if bits else
             f"worst relative error {worst:.3e} at {worst_name} "
             f"(bound {tol})"), flush=True)
    need(bits or worst <= tol,
         f"dist deepseek: meshed gradient differs beyond {tol} ({worst} at "
         f"{worst_name})")
    same_c = [n for n in names if a["fp"][n] == c["fp"][n]]
    same_c_host = [n for n in whole if torch.equal(a["host"][n],
                                                   c["host"][n])]
    print(f"  sharded (shard_model, DTensors) vs unmeshed: loss "
          f"{'equal' if a['loss'] == c['loss'] else 'differs'}; fingerprints "
          f"equal on {len(same_c)}/{len(names)} leaves, whole leaves equal "
          f"{len(same_c_host)}/{len(whole)}; K1 {c['k1']}", flush=True)
    need(a["loss"] == c["loss"] and len(same_c) == len(names)
         and len(same_c_host) == len(whole) and c["k1"] == k1_design
         and c["calls"] == {"global": 0, "sharded": n_moe},
         f"dist deepseek: the sharded gradient differs from the unmeshed "
         f"one (loss {c['loss']} vs {a['loss']}; leaves "
         f"{[n for n in names if n not in same_c][:5]}; K1 {c['k1']}; MoE "
         f"paths {c['calls']})")
    del model, params, batch
    return {"loss": [a["loss"], b["loss"], c["loss"]], "held": held,
            "sharded_bit_identical": True, "sharded_grad_wall_s": c["wall_s"],
            "tp_launches": {"flash_attention": c["k1"],
                            "decode_attention": c["k2"]},
            "bit_identical": bits, "worst": worst,
            "k1_launches": [a["k1"], b["k1"]], "moe_paths": b["calls"],
            "grad_wall_s": [a["wall_s"], b["wall_s"]],
            "peak_memory_bytes": max(a["peak"], b["peak"]),
            "leaves": len(names), "whole_leaves": len(whole),
            "launches": {"flash_attention": b["k1"],
                         "decode_attention": b["k2"]}}


def run_sharded(torch, cfg, model, batch, mesh, kern, whole) -> dict:
    """deepseek's loss and gradient once more with ``model`` sharded in
    place by ``shard_model`` (on the 1x1 mesh each DTensor's shard is the
    whole weight: no copy) and the batch placed by ``batch_specs``: the
    gradient's leaves fingerprinted as ``dist_deepseek``'s runs."""
    from repro_torch.dist.sharding import shard_batch, shard_model
    from repro_torch.models import model as M
    flash, decode = kern["flash"], kern["decode"]
    shard_model(cfg, model, mesh)
    names, params = zip(*model.named_parameters())
    placed = shard_batch(cfg, batch, mesh)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    flash.launches = 0
    decode.launches = 0
    t0 = time.perf_counter()
    with moe_paths() as calls, M.sharded_pass(model):
        loss, _ = M.loss_fn(cfg, model, placed)
        grads = torch.autograd.grad(loss, params)
        grads = [g.redistribute(mesh, p.placements).to_local()
                 for g, p in zip(grads, params)]
    torch.cuda.synchronize()
    out = {"loss": loss.full_tensor().item(), "k1": flash.launches,
           "k2": decode.launches, "calls": dict(calls),
           "wall_s": time.perf_counter() - t0,
           "peak": torch.cuda.max_memory_allocated(),
           "fp": {n: fingerprint(torch, g, SEED + i)
                  for i, (n, g) in enumerate(zip(names, grads))},
           "host": {n: g.cpu() for n, g in zip(names, grads) if n in whole}}
    del loss, grads, params
    free_cuda(torch)
    return out


def events_ms(torch, fn, reps: int = 5) -> float:
    """Mean device milliseconds of ``fn`` between two CUDA events on the
    current stream, after one warm-up (collectives are not captured in a
    graph here)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def dist_granite(torch, kern, mesh) -> dict:
    """granite-3-2b (published width, 4 layers): two AdamW steps with
    grad_specs under the rules of the 1x1 mesh and the same two steps
    unmeshed, bit for bit; wrap_grads of a gradient over the NCCL "data"
    group against a bf16 all-reduce of it; the state saved in the
    reference's format and restored with elastic_restore onto the mesh."""
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from repro_torch import _bridge
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.dist import compression as comp
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.hints import sharding_rules
    from repro_torch.launch.specs import params_specs_for
    from repro_torch.models import model as M
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.elastic import elastic_restore
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    spec = DIST_GRANITE
    cfg = dataclasses.replace(get_config(spec["arch"]),
                              n_layers=spec["layers"])
    B, S, mb, steps = spec["B"], spec["S"], spec["microbatches"], \
        spec["steps"]
    oc = OptConfig(warmup_steps=10, total_steps=steps)
    flash, decode = kern["flash"], kern["decode"]
    per_step = 2 * cfg.n_layers * mb
    print(f"[dist] {cfg.name} at published width, depth cut to "
          f"{cfg.n_layers}: {steps} AdamW steps of {B} x {S} tokens in {mb} "
          f"microbatches with grad_specs under the rules of the 1x1 mesh, "
          f"and unmeshed; K1 designed {per_step} a step", flush=True)
    it = SyntheticCorpus(cfg.vocab, seed=SEED).batches(B, S)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in next(it).items()}
               for _ in range(steps)]
    specs = shd.named_param_specs(cfg, mesh)

    def run(meshed: bool) -> dict:
        model = M.make_trainable(cfg, M.init_params(cfg, SEED, device="cuda"))
        opt = init_opt_state(oc, dict(model.named_parameters()))
        step = make_train_step(cfg, oc, microbatches=mb,
                               grad_specs=specs if meshed else None)
        losses, k1, k2, walls = [], [], [], []
        for b in batches:
            torch.cuda.synchronize()
            flash.launches = 0
            decode.launches = 0
            t0 = time.perf_counter()
            with (sharding_rules(mesh) if meshed
                  else contextlib.nullcontext()):
                _, opt, m = step(model, opt, b)
            losses.append(m["loss"].item())
            walls.append(time.perf_counter() - t0)
            k1.append(flash.launches)
            k2.append(decode.launches)
        return {"model": model, "opt": opt, "losses": losses, "k1": k1,
                "k2": k2, "walls": walls}

    a = run(False)
    b = run(True)
    for label, r in (("unmeshed", a), ("grad_specs", b)):
        print(f"  {label}: losses {r['losses']!r}; K1 per step {r['k1']}, "
              f"K2 {r['k2']}; "
              f"step walls {[round(w, 4) for w in r['walls']]} s", flush=True)
    pa, pb = dict(a["model"].named_parameters()), \
        dict(b["model"].named_parameters())
    differ = [k for k in pa if not torch.equal(pa[k], pb[k])
              or not torch.equal(a["opt"]["m"][k], b["opt"]["m"][k])
              or not torch.equal(a["opt"]["v"][k], b["opt"]["v"][k])]
    print(f"  grad_specs vs unmeshed: losses "
          f"{'equal' if a['losses'] == b['losses'] else 'differ'}; params "
          f"and moments bit-identical on {len(pa) - len(differ)}/{len(pa)} "
          f"leaves", flush=True)
    need(a["losses"] == b["losses"] and not differ,
         f"dist granite: grad_specs steps differ from the unmeshed steps "
         f"(losses {a['losses']} vs {b['losses']}; leaves {differ[:5]})")
    need(all(math.isfinite(x) for x in b["losses"]),
         f"dist granite: losses {b['losses']}")
    need(a["k1"] == [per_step] * steps and b["k1"] == [per_step] * steps,
         f"dist granite: K1 per step {a['k1']}, {b['k1']} != {per_step}")
    need(a["k2"] == [0] * steps and b["k2"] == [0] * steps,
         f"dist granite: decode launches per step {a['k2']}, {b['k2']}")
    model, opt = b["model"], b["opt"]
    del a, pa, pb
    free_cuda(torch)

    # wrap_grads over NCCL: one microbatch's gradient, accumulated in f32 as
    # the train step accumulates it
    micro = {k: v[:B // mb] for k, v in batches[0].items()}
    names, params = zip(*model.named_parameters())
    loss, _ = M.loss_fn(cfg, model, micro)
    g16 = dict(zip(names, torch.autograd.grad(loss, params)))
    del loss
    g32 = {k: g.float() for k, g in g16.items()}
    group = mesh.get_group("data")
    with sharding_rules(mesh):
        means, errs = comp.wrap_grads(g32, "data", None)
        bad = [k for k in names if not torch.allclose(
            means[k] + errs[k], g32[k], rtol=COMPRESS_TOL, atol=COMPRESS_TOL)]
        worst = max(((means[k] + errs[k] - g32[k]).abs().max().item()
                     for k in names))
        t_comp = events_ms(torch, lambda: comp.wrap_grads(g32, "data", None))
    copies = {k: g.clone() for k, g in g16.items()}

    def all_reduce_bf16():
        for t in copies.values():
            dist.all_reduce(t, group=group)

    t_ar = events_ms(torch, all_reduce_bf16)
    ratios = {"bf16": comp.compression_ratio(g16),
              "f32": comp.compression_ratio(g32)}
    n_elems = sum(g.numel() for g in g16.values())
    int8_bytes = sum(g.numel() + 4 for g in g16.values())
    bf16_bytes = 2 * n_elems
    card = card_line()
    print(f"  wrap_grads over the NCCL \"data\" group ({dist.get_world_size(group)} "
          f"rank): {len(names)} leaves, {n_elems:,} elements; mean + new_err "
          f"against g + err: worst |diff| {worst:.3e} (rtol = atol = "
          f"{COMPRESS_TOL}), {len(bad)} leaves outside; device time "
          f"{t_comp:.4f} ms a call vs {t_ar:.4f} ms for the bf16 all-reduce "
          f"of the same tree; wire bytes a rank: int8 + scales {int8_bytes:,}, "
          f"bf16 {bf16_bytes:,}; compression_ratio {ratios['bf16']:.4f} "
          f"(bf16 tree), {ratios['f32']:.4f} (f32 tree) on {card}",
          flush=True)
    need(not bad, f"dist granite: wrap_grads' mean + err differs from the "
         f"gradient at {bad[:5]}")
    del means, errs, g16, g32, copies, params
    free_cuda(torch)

    # the state in the reference's format, restored onto the mesh
    tree = {"p": _bridge.to_reference(cfg, model),
            "o": _bridge.opt_state_to_reference(cfg, model, opt)}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = ckpt.save(tree, d, steps)
        t_save = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in Path(path).iterdir())
        t0 = time.perf_counter()
        p2, o2, step = elastic_restore(cfg, oc, d, mesh)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
    want_spec = _bridge._flat(shd.param_specs(cfg, params_specs_for(cfg),
                                              mesh))
    got = _bridge._flat({"p": p2, "o": o2})
    saved = _bridge._flat(tree)
    wrong = []
    for k, v in got.items():
        leaf = k.split("/", 1)[1]
        if k.startswith("o/m/") or k.startswith("o/v/"):
            leaf = leaf.split("/", 1)[1]
        pl = shd.placements(mesh, want_spec[leaf]) if k != "o/step" \
            else shd.placements(mesh, shd.P())
        if list(v.placements) != list(pl) or v.dtype != saved[k].dtype \
                or not torch.equal(v.full_tensor(), saved[k]):
            wrong.append(k)
    print(f"  elastic restore: {len(got)} leaves ({size:,} B on disk) saved "
          f"in {t_save:.3f}s, restored onto the mesh in "
          f"{t_restore:.3f}s at step {step}; bit-identical with param_specs' "
          f"placements on {len(got) - len(wrong)}/{len(got)}", flush=True)
    need(step == steps and not wrong and set(got) == set(saved),
         f"dist granite: elastic restore differs at {wrong[:5]} (step "
         f"{step})")
    del tree, p2, o2, model, opt
    return {"losses": b["losses"], "step_walls_s": b["walls"],
            "k1_per_step": b["k1"],
            "wrap_grads_ms": t_comp, "bf16_all_reduce_ms": t_ar,
            "wrap_grads_worst": worst, "int8_bytes": int8_bytes,
            "bf16_bytes": bf16_bytes, "compression_ratio": ratios,
            "ckpt_bytes": size, "save_s": t_save, "restore_s": t_restore,
            "launches": {"flash_attention": b["k1"][-1],
                         "decode_attention": b["k2"][-1]}}


# the sharded step's check: granite at published width, depth cut to 4, two
# AdamW steps of 8 x 4096 in 2 microbatches, a prefill of 4 x 1024 and 8
# decode steps, sharded (DTensors) and unmeshed
DIST_TP = dict(arch="granite-3-2b", layers=4, B=8, S=4096, microbatches=2,
               steps=2, prefill_B=4, prefill_S=1024, decode_steps=8)


def dist_tp(torch, kern, mesh) -> dict:
    """The sharded step (``shard_model``: DTensor params and activations, K1
    and K2 under ``local_map``) on the 1x1 NCCL mesh against the unmeshed
    run of the same seeds: granite's losses, params, moments, prefill
    logits and every decode step's logits bit for bit, K1 / K2 launches
    equal (16 a train step, 4 a prefill, K2 4 a decode step); the decode
    step's host wall, DTensor against plain."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.dist.sharding import shard_model
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import (make_prefill_step,
                                              make_serve_step,
                                              make_train_step)
    spec = DIST_TP
    cfg = dataclasses.replace(get_config(spec["arch"]),
                              n_layers=spec["layers"])
    B, S, mb, steps = spec["B"], spec["S"], spec["microbatches"], \
        spec["steps"]
    Bp, Sp, n_dec = spec["prefill_B"], spec["prefill_S"], \
        spec["decode_steps"]
    oc = OptConfig(warmup_steps=10, total_steps=steps)
    flash, decode = kern["flash"], kern["decode"]
    want = {"train": (2 * cfg.n_layers * mb, 0), "prefill": (cfg.n_layers, 0),
            "decode": (0, cfg.n_layers)}
    print(f"[dist] tp: {cfg.name} at published width, depth cut to "
          f"{cfg.n_layers}: {steps} AdamW steps of {B} x {S} in {mb} "
          f"microbatches, a prefill of {Bp} x {Sp} and {n_dec} decode steps, "
          f"sharded by shard_model on the 1x1 mesh and unmeshed; launches "
          f"designed {want}", flush=True)
    it = SyntheticCorpus(cfg.vocab, seed=SEED).batches(B, S)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in next(it).items()}
               for _ in range(steps)]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab, (Bp, Sp), generator=gen,
                           device="cuda", dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab, (n_dec, Bp, 1), generator=gen,
                         device="cuda", dtype=torch.int32)

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def counted(fn):
        torch.cuda.synchronize()
        flash.launches = 0
        decode.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (flash.launches, decode.launches), \
            time.perf_counter() - t0

    def run(sharded: bool) -> dict:
        model = M.make_trainable(cfg, M.init_params(cfg, SEED, device="cuda"))
        if sharded:
            shard_model(cfg, model, mesh)
        opt = init_opt_state(oc, dict(model.named_parameters()))
        step = make_train_step(cfg, oc, microbatches=mb)
        out = {"losses": [], "launches": {}, "walls": {}}
        for i, b in enumerate(batches):
            (_, opt, m), n, w = counted(lambda: step(model, opt, b))
            out["losses"].append(m["loss"].item())
            out["launches"][f"train{i}"], out["walls"][f"train{i}"] = n, w
        out["params"] = {k: whole(p.detach()).cpu()
                         for k, p in model.named_parameters()}
        out["moments"] = {k: (whole(opt["m"][k]).cpu(),
                              whole(opt["v"][k]).cpu()) for k in opt["m"]}
        del opt
        free_cuda(torch)
        (logits, state), n, w = counted(
            lambda: make_prefill_step(cfg, Sp + n_dec)(model,
                                                       {"tokens": prompt}))
        out["launches"]["prefill"], out["walls"]["prefill"] = n, w
        out["logits"] = [whole(logits).cpu()]
        serve = make_serve_step(cfg)
        for i in range(n_dec):
            (logits, state), n, w = counted(lambda: serve(model, state,
                                                          toks[i]))
            out["logits"].append(whole(logits).cpu())
            out["launches"][f"decode{i}"], out["walls"][f"decode{i}"] = n, w
        del model, state, logits
        free_cuda(torch)
        return out

    a = run(False)
    b = run(True)
    bad = [k for k in a["params"] if not torch.equal(a["params"][k],
                                                     b["params"][k])
           or not all(torch.equal(x, y) for x, y in zip(a["moments"][k],
                                                        b["moments"][k]))]
    bad_logits = [i for i, (x, y) in enumerate(zip(a["logits"], b["logits"]))
                  if not torch.equal(x, y)]
    dec_a = [a["walls"][f"decode{i}"] * 1e3 for i in range(1, n_dec)]
    dec_b = [b["walls"][f"decode{i}"] * 1e3 for i in range(1, n_dec)]
    host = {"plain_ms": sum(dec_a) / len(dec_a),
            "dtensor_ms": sum(dec_b) / len(dec_b)}
    for label, r in (("unmeshed", a), ("sharded", b)):
        print(f"  {label}: losses {r['losses']!r}; launches "
              f"{r['launches']}; walls (s) "
              f"{ {k: round(v, 4) for k, v in r['walls'].items()} }",
              flush=True)
    print(f"  sharded vs unmeshed: losses "
          f"{'equal' if a['losses'] == b['losses'] else 'differ'}; params "
          f"and moments bit-identical on {len(a['params']) - len(bad)}/"
          f"{len(a['params'])} leaves; prefill and decode logits "
          f"bit-identical on {len(a['logits']) - len(bad_logits)}/"
          f"{len(a['logits'])}; a decode step's wall (steps 2..{n_dec}, "
          f"synchronised) {host['plain_ms']:.3f} ms plain, "
          f"{host['dtensor_ms']:.3f} ms on DTensors on {card_line()}",
          flush=True)
    need(a["losses"] == b["losses"] and not bad and not bad_logits,
         f"dist tp: the sharded run differs from the unmeshed run (losses "
         f"{a['losses']} vs {b['losses']}; leaves {bad[:5]}; logits "
         f"{bad_logits})")
    need(all(math.isfinite(x) for x in b["losses"]),
         f"dist tp: losses {b['losses']}")
    for r in (a, b):
        for k, n in r["launches"].items():
            kind = "decode" if k.startswith("decode") else \
                "prefill" if k == "prefill" else "train"
            need(n == want[kind], f"dist tp: launches at {k} {n} != "
                 f"{want[kind]}")
    return {"losses": b["losses"], "launches_per_phase": b["launches"],
            "walls_s": b["walls"], "unmeshed_walls_s": a["walls"],
            "decode_host_ms": host,
            "launches": {"flash_attention": b["launches"]["prefill"][0],
                         "decode_attention": b["launches"]["decode0"][1]}}


def dist_phase(torch, kern) -> dict:
    """The dist phase on a one-rank NCCL group and a ("data", "model") 1x1
    DeviceMesh on cuda:0; the group is destroyed when it ends."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(1, 1)
    try:
        need(dist.get_backend() == "nccl",
             f"dist: backend {dist.get_backend()}")
        # each mesh dim's communicator starts at its first collective: start
        # them here, outside the timed runs
        t0 = time.perf_counter()
        for name in mesh.mesh_dim_names:
            dist.all_reduce(torch.ones(1, device="cuda"),
                            group=mesh.get_group(name))
        torch.cuda.synchronize()
        print(f"[dist] mesh {mesh} on a one-rank {dist.get_backend()} group; "
              f"the first all_reduce of each mesh dim (its communicator's "
              f"start) took {time.perf_counter() - t0:.3f}s", flush=True)
        t0 = time.perf_counter()
        deepseek = dist_deepseek(torch, kern, mesh)
        free_cuda(torch)
        print(f"[dist] deepseek done in {time.perf_counter() - t0:.1f}s",
              flush=True)
        t0 = time.perf_counter()
        granite = dist_granite(torch, kern, mesh)
        free_cuda(torch)
        print(f"[dist] granite done in {time.perf_counter() - t0:.1f}s",
              flush=True)
        t0 = time.perf_counter()
        tp = dist_tp(torch, kern, mesh)
        free_cuda(torch)
        print(f"[dist] tp done in {time.perf_counter() - t0:.1f}s",
              flush=True)
    finally:
        dist.destroy_process_group()
    sites = hint_sites(torch)
    free_cuda(torch)
    res = {"deepseek": deepseek, "granite": granite, "tp": tp,
           "hint_sites": sites}
    print("  " + json.dumps(res), flush=True)
    return res


# ------------------------------------------------------------------ launch
# granite-3-2b's three production cells: the dry run's records on the pod1
# mesh, then each cell on cuda:0 at published width and depth, one data
# rank's batch (train_4k 16 x 4096 in the recipe's 2 microbatches,
# prefill_32k B2 S32768, decode_32k B8 over a 32,768-row cache)
LAUNCH_ARCH = "granite-3-2b"
LAUNCH_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
# the card's dispatched matmul FLOPs against the dry run's meta count: the
# same ops with the same shapes, summed in the same order
FLOPS_RTOL = 1e-9


def launch_phase(torch, kern) -> dict:
    """``python -m repro_torch.launch.dryrun --arch granite-3-2b --mesh
    pod1`` in a subprocess (its fake 512-rank group never meets this
    process's NCCL group), its three records required ``ok``; then
    ``profile_cell`` for each cell on the card: K1 / K2 launches per step
    against the path (K1 80 x microbatches a train step, 40 a prefill; K2
    40 and K1 0 a decode step), the dispatched matmul FLOPs against the dry
    run's meta count (FLOPS_RTOL), finite outputs; peak memory, wall, busy
    time, idle share, MFU and the top kernels are reported."""
    import os

    from repro_torch.configs import get_config
    from repro_torch.launch.profile_cell import profile_cell
    cfg = get_config(LAUNCH_ARCH)
    out = ROOT / "build" / "dryrun_granite.jsonl"
    out.parent.mkdir(exist_ok=True)
    out.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", LAUNCH_ARCH, "--mesh", "pod1", "--out",
                           str(out)], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=900)
    dry_s = time.perf_counter() - t0
    for ln in proc.stdout.splitlines():
        print(f"[launch] dryrun: {ln}", flush=True)
    need(proc.returncode == 0, f"dry run exited {proc.returncode}: "
         f"{proc.stderr[-2000:]}")
    recs = {r["shape"]: r for r in map(json.loads,
                                       out.read_text().splitlines())}
    need(sorted(recs) == sorted(LAUNCH_SHAPES)
         and all(r["ok"] for r in recs.values()),
         f"dry run records: {[(r['shape'], r['ok'], r.get('error')) for r in recs.values()]}")
    print(f"[launch] dry run of {LAUNCH_ARCH} on pod1 (16 x 16, a fake group "
          f"of 512 ranks, meta tensors) took {dry_s:.1f}s on this host's "
          f"CPU", flush=True)
    for shape in LAUNCH_SHAPES:
        r = recs[shape]
        print(f"[launch] dryrun {shape}: per device arguments "
              f"{r['argument_size_in_bytes']:,} B (the sharded step's rank "
              f"0 holds {r['device_argument_bytes']:,} B), outputs "
              f"{r['output_size_in_bytes']:,} B; per device (sharded step, "
              f"tp_on_activations {r['tp_on_activations']}): dot_flops "
              f"{r['dot_flops_per_device']:.6e}, result bytes "
              f"{r['result_bytes_per_device']:.6e}, collectives "
              f"{r['collective_total']:,.0f} B in {r['collective_count']}, "
              f"activation peak {r['activation_peak_bytes']:,} B, "
              f"fits_h100_80gb {r['fits_h100_80gb']}; one data rank (batch "
              f"{r['batch_per_data_rank']}, unsharded): dot_flops "
              f"{r['dot_flops_per_data_rank']:.6e}, activation peak "
              f"{r['data_rank_activation_peak_bytes']:,} B, one-card "
              f"estimate {r['one_card_estimate_bytes'] / 2**30:.2f} GiB; "
              f"{r['seconds']}s", flush=True)
        need(r["device_argument_bytes"] == r["argument_size_in_bytes"]
             and r["tp_on_activations"] and r["dot_flops_per_device"] > 0,
             f"dry run {shape}: the sharded step's record {r}")
    card = card_line()
    res = {"dryrun_s": dry_s}
    for shape in LAUNCH_SHAPES:
        r = recs[shape]
        print(f"[launch] {LAUNCH_ARCH} {shape} on cuda:0 (profile_cell)",
              flush=True)
        t0 = time.perf_counter()
        p = profile_cell(LAUNCH_ARCH, shape, "pod1", device="cuda", top=8)
        p["seconds"] = time.perf_counter() - t0
        k1, k2 = p["launches"]["flash_attention"], \
            p["launches"]["decode_attention"]
        want = {"train": (2 * cfg.n_layers * p["microbatches"], 0),
                "prefill": (cfg.n_layers, 0),
                "decode": (0, cfg.n_layers)}[r["kind"]]
        rel = abs(p["dot_flops"] - r["dot_flops_per_data_rank"]) \
            / r["dot_flops_per_data_rank"]
        print(f"[launch] {shape}: launches per step K1 {k1:g} K2 {k2:g} "
              f"(designed {want}); dot_flops card {p['dot_flops']:.9e} vs "
              f"dry run {r['dot_flops_per_data_rank']:.9e} (rel {rel:.2e}); "
              f"the cell's peak memory {p['peak_memory_bytes'] / 2**30:.2f} "
              f"GiB (above {p['held_before_bytes'] / 2**30:.2f} GiB held "
              f"before) vs the dry run's one-card estimate "
              f"{r['one_card_estimate_bytes'] / 2**30:.2f} GiB; wall "
              f"{p['wall_ms']:.3f} ms, busy {p['device_busy_ms']:.3f} ms, "
              f"idle share {p['idle_share']:.4f}, MFU {p['mfu']:.4f}; reduced "
              f"{p['reduced'] or 'nothing'}; {p['seconds']:.1f}s on {card}",
              flush=True)
        need((k1, k2) == want, f"launch {shape}: launches per step "
             f"{(k1, k2)} != {want}")
        need(rel <= FLOPS_RTOL, f"launch {shape}: dot_flops {p['dot_flops']}"
             f" vs the dry run's {r['dot_flops_per_data_rank']}")
        need(p["finite"], f"launch {shape}: the step's output is not finite")
        p["dryrun"] = {k: r[k] for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "dot_flops_per_data_rank", "dot_flops_per_device",
            "result_bytes_per_device", "activation_peak_bytes",
            "data_rank_activation_peak_bytes", "collective_total",
            "fits_h100_80gb", "one_card_estimate_bytes",
            "data_rank_argument_bytes", "seconds")}
        res[shape] = p
        free_cuda(torch)
    return res


def examples_phase(torch, kern) -> dict:
    """The four examples on the card with their default arguments (their
    own assertions are the checks: the routing's hits and prefills, the
    loss falling over train_lm's 300 steps with its failure and restart at
    step 150, the content identical after the elastic reshard); K1 / K2
    launches counted per example."""
    from repro_torch.examples import (elastic_restart, quickstart,
                                      serve_routed, train_lm)
    flash, decode = kern["flash"], kern["decode"]
    res = {}
    for name, mod in (("quickstart", quickstart),
                      ("serve_routed", serve_routed),
                      ("train_lm", train_lm),
                      ("elastic_restart", elastic_restart)):
        print(f"[examples] python -m repro_torch.examples.{name} (defaults, "
              f"on cuda)", flush=True)
        flash.launches = 0
        decode.launches = 0
        t0 = time.perf_counter()
        try:
            r = mod.main([])
        except AssertionError as exc:
            raise SmokeFailure(f"example {name}: {exc}") from exc
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {"flash_attention": flash.launches,
                    "decode_attention": decode.launches}
        print(f"[examples] {name} done in {dt:.1f}s; launches {launches}",
              flush=True)
        res[name] = {"seconds": dt, "launches": launches}
        if name == "quickstart":
            need(math.isfinite(r["out"]), f"quickstart: out {r['out']}")
        elif name == "train_lm":
            need(r.restarts == 1 and launches["flash_attention"] > 0,
                 f"train_lm: {r.restarts} restarts, launches {launches}")
            res[name]["losses"] = [r.losses[0], r.losses[-1]]
        elif name == "serve_routed":
            need(launches["flash_attention"] > 0
                 and launches["decode_attention"] > 0,
                 f"serve_routed: launches {launches}")
        del r
        free_cuda(torch)
    return res


def ptxas_summary(lines: list[str]) -> list[str]:
    """ptxas' registers, spills and warnings per kernel instance."""
    args = {"f": "f32", "13__nv_bfloat16": "bf16"}
    out, name = [], None
    for ln in lines:
        m = re.search(r"(flash_tc_kernel|flash_kernel|decode_chunk_kernel|"
                      r"decode_merge_kernel)I((?:Li\d+E|f|13__nv_bfloat16)+)E",
                      ln)
        if m:
            parts = re.findall(r"Li(\d+)E|(f|13__nv_bfloat16)", m.group(2))
            name = f"{m.group(1)}<" + ",".join(
                a or args[t] for a, t in parts) + ">"
        elif "warning" in ln:
            out.append(ln)
        elif name and ("Used" in ln or "spill" in ln):
            out.append(f"{name}: {ln.replace('ptxas info    : ', '')}")
    return out


def hint_sites(torch) -> dict:
    """Host cost of the hint sites in one granite-3-2b decode step
    (published width, 40 layers, B 8): the calls of ``hint`` and
    ``tp_divides`` counted at the model's bindings over one step, times the
    host cost of one call of each, timed in a loop here."""
    import timeit

    from repro_torch.configs import get_config
    from repro_torch.dist import hints as H
    from repro_torch.models import layers
    from repro_torch.models import model as M
    cfg = get_config("granite-3-2b")
    model = M.init_params(cfg, SEED, device="cuda")
    state = M.init_decode_state(cfg, 8, 2048, device="cuda")
    tok = torch.zeros((8, 1), dtype=torch.int32, device="cuda")
    counts = {"hint": 0, "tp_divides": 0}

    def counted(name, fn):
        def wrapper(*a):
            counts[name] += 1
            return fn(*a)
        return wrapper

    orig = {m: (m.hint, m.tp_divides) for m in (M, layers)}
    for m, (h, t) in orig.items():
        m.hint, m.tp_divides = counted("hint", h), counted("tp_divides", t)
    try:
        with torch.no_grad():
            M.decode_step(cfg, model, state, tok)
        torch.cuda.synchronize()
    finally:
        for m, (h, t) in orig.items():
            m.hint, m.tp_divides = h, t
    x = torch.zeros((8, 1, cfg.d_model), device="cuda")
    n = 200_000
    ns_hint = 1e9 * timeit.timeit(lambda: H.hint(x, "dp", None, "tp"),
                                  number=n) / n
    ns_tp = 1e9 * timeit.timeit(lambda: H.tp_divides(cfg.n_kv_heads),
                                number=n) / n
    us = 1e-3 * (counts["hint"] * ns_hint + counts["tp_divides"] * ns_tp)
    print(f"[dist] hint sites of one {cfg.name} decode step (B 8, outside "
          f"rules): {counts['hint']} hint and {counts['tp_divides']} "
          f"tp_divides calls; {ns_hint:.1f} ns and {ns_tp:.1f} ns a call on "
          f"this host: {us:.1f} us a step", flush=True)
    del model, state
    return {"calls": counts, "ns_hint": ns_hint, "ns_tp_divides": ns_tp,
            "us_per_step": us}


def main(argv: list[str]) -> int:
    sweep = argv == ["--sweep-decode-chunks"]
    probe = argv == ["--probe-consistency"]
    phase = None
    if argv[:1] == ["--train-phase"] and len(argv) == 4 \
            and argv[2].isdigit() and argv[3].isdigit():
        phase = next((dict(p, B=int(argv[2]), S=int(argv[3]))
                      for p in TRAIN_PHASES if p["arch"] == argv[1]), None)
    if argv and not (sweep or probe or phase):
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no repro_torch package under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import repro_torch.serve.engine  # noqa: F401 - the whole serving path
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.decode_attention import (chunk_size,
                                                      decode_attention)
    from repro_torch.kernels.flash_attention import flash_attention
    need("jax" not in sys.modules and "repro" not in sys.modules,
         "the port pulled in jax or the reference package")

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[card] {card}", flush=True)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device 0 {kind}; {count} device(s)", flush=True)

    info = _build.build_info()
    print(f"[build] {'compiled' if info.compiled else 'reused'} "
          f"{info.path.relative_to(ROOT)} in {info.seconds:.2f}s", flush=True)
    for ln in ptxas_summary(info.ptxas):
        print(f"[build] {ln}", flush=True)
    lib = _build.load()
    print(f"[build] dynamic shared memory per block: flash_attention bf16 "
          f"hd 64 {lib.repro_flash_attention_smem(64, 1)} B, hd 240 "
          f"{lib.repro_flash_attention_smem(240, 1)} B; f32 hd 64 "
          f"{lib.repro_flash_attention_smem(64, 0)} B", flush=True)
    sass = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"),
                           "-sass", str(info.path)], capture_output=True,
                          text=True)
    n_gmma = sass.stdout.count("HGMMA")
    print(f"[build] tensor-core wgmma (HGMMA) instructions in the library's "
          f"SASS: {n_gmma}", flush=True)
    need(n_gmma > 0, "the bf16 flash kernel has no wgmma in its SASS")

    kern = {"ref": ref, "flash": flash_attention, "decode": decode_attention,
            "chunk_size": chunk_size}
    if sweep:
        sweep_decode_chunks(torch, ref)
        return 0
    if probe:
        probe_consistency(torch)
        return 0
    if phase:
        train_family(torch, kern, phase)
        return 0
    t0 = time.perf_counter()
    rows = kernel_phase(torch, kern)
    print(f"[kernels] phase done in {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    granite = serve_granite(torch, kern)
    free_cuda(torch)
    print(f"[serve] granite phase done in {time.perf_counter() - t0:.1f}s",
          flush=True)
    t0 = time.perf_counter()
    gemma = serve_gemma(torch, kern)
    free_cuda(torch)
    print(f"[serve] gemma phase done in {time.perf_counter() - t0:.1f}s",
          flush=True)
    by_path = {"granite-3-2b": granite["launches"],
               "gemma3-12b": gemma["launches"]}
    for name, phase in (("whisper-medium", serve_whisper),
                        ("llama-3.2-vision-90b", serve_vision),
                        ("deepseek-v3-671b", serve_deepseek),
                        ("zamba2-7b", serve_zamba2),
                        ("rwkv6-1.6b", serve_rwkv)):
        t0 = time.perf_counter()
        by_path[name] = phase(torch, kern)["launches"]
        free_cuda(torch)
        print(f"[serve] {name} phase done in {time.perf_counter() - t0:.1f}s",
              flush=True)
    t0 = time.perf_counter()
    trace = trace_granite(torch, kern)
    free_cuda(torch)
    by_path["trace granite-3-2b"] = trace["launches"]
    print(f"[trace] phase done in {time.perf_counter() - t0:.1f}s",
          flush=True)
    t0 = time.perf_counter()
    trained = train_granite(torch, kern)
    free_cuda(torch)
    by_path["train granite-3-2b"] = trained["launches"]
    print(f"[train] phase done in {time.perf_counter() - t0:.1f}s",
          flush=True)
    for spec in TRAIN_PHASES:
        t0 = time.perf_counter()
        by_path[f"train {spec['arch']}"] = train_family(torch, kern,
                                                        spec)["launches"]
        free_cuda(torch)
        print(f"[train] {spec['arch']} phase done in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    by_path["workflow quickstart"] = workflow_quickstart(
        torch, kern)["launches"]
    free_cuda(torch)
    print(f"[workflow] quickstart phase done in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    by_path["workflow epoch granite-3-2b"] = workflow_epoch(
        torch, kern)["launches"]
    free_cuda(torch)
    print(f"[workflow] epoch phase done in {time.perf_counter() - t0:.1f}s",
          flush=True)
    t0 = time.perf_counter()
    launch = launch_phase(torch, kern)
    for shape in LAUNCH_SHAPES:
        by_path[f"launch {LAUNCH_ARCH} {shape}"] = launch[shape]["launches"]
    print(f"[launch] phase done in {time.perf_counter() - t0:.1f}s",
          flush=True)
    t0 = time.perf_counter()
    examples = examples_phase(torch, kern)
    for name in ("serve_routed", "train_lm"):
        by_path[f"example {name}"] = examples[name]["launches"]
    print(f"[examples] phase done in {time.perf_counter() - t0:.1f}s",
          flush=True)
    t0 = time.perf_counter()
    dist_res = dist_phase(torch, kern)
    by_path["dist deepseek-v3-671b"] = dist_res["deepseek"]["launches"]
    by_path["dist granite-3-2b"] = dist_res["granite"]["launches"]
    by_path["dist tp granite-3-2b"] = dist_res["tp"]["launches"]
    by_path["dist tp deepseek-v3-671b"] = dist_res["deepseek"]["tp_launches"]
    free_cuda(torch)
    print(f"[dist] phase done in {time.perf_counter() - t0:.1f}s", flush=True)

    src_of = {"flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                  "src/repro/kernels/flash_attention.py:127"),
              "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                                   "src/repro/kernels/decode_attention.py:101")}
    kernels = []
    for name, (source, replaces) in src_of.items():
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": granite["launches"][name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "library_call": r["library_call"],
                        "design": DESIGN[name], "host_us": r["host_us"],
                        "launches_by_path": {k: v[name]
                                             for k, v in by_path.items()}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        rc = 1
    sys.exit(rc)
