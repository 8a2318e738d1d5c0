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
11. prints the kernels' JSON line, the card line again, and last
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
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 (NVIDIA data sheet)
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


def flash_work(case, itemsize: int, dv: int | None = None) -> tuple[float, float]:
    """(operations, bytes) the function needs: 2 * (hd + dv) per visible
    (q, k) pair per q-head; q, k, v read once and o written once. ``dv`` is
    V's and the output's width (default hd)."""
    B, Sq, Sk, Hq, Hkv, hd, causal, window, off = case
    dv = hd if dv is None else dv
    pairs = 0
    for i in range(Sq):
        qp = off + i
        hi = min(Sk - 1, qp) if causal else Sk - 1
        lo = max(0, qp - window + 1) if window > 0 else 0
        pairs += max(0, hi - lo + 1)
    ops = 2.0 * B * Hq * (hd + dv) * pairs
    nbytes = itemsize * (B * Sq * Hq * (hd + dv) + B * Sk * Hkv * (hd + dv))
    return ops, nbytes


def decode_work(case, lengths: list[int], itemsize: int) -> tuple[float, float]:
    """(operations, bytes) for these lengths: only the live rows of the cache
    are read (clamped to S, cut to the window)."""
    B, S, Hq, Hkv, hd, window = case
    live = [min(n, S) if window <= 0 else min(min(n, S), window)
            for n in lengths]
    ops = 4.0 * Hq * hd * sum(live)
    nbytes = itemsize * (2 * Hkv * hd * sum(live) + 2 * B * Hq * hd) \
        + 4 * B
    return ops, nbytes


def bound_ms(ops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_FLOPS
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def kernel_phase(torch, kern) -> dict:
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
    for name in rows:
        rows[name]["max_abs_err"] = worst[name]
    print("[paths] " + json.dumps({"path_shapes": paths}), flush=True)
    return rows


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
        torch, f"one pooled decode step (B={max_batch})",
        lambda: engines[-1].step(), 2)
    if profile_prompt is not None:
        p_eng = next((e for e in engines if e.can_admit()), None)
        need(p_eng is not None, f"{label}: no free slot for the profiled "
             f"prefill")
        res["profile_prefill"] = profile(
            torch, f"one {len(profile_prompt)}-token prefill",
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


def device_intervals(torch, prof) -> list[tuple[float, float]]:
    """The profiled device events' spans in ms (kernels, copies, memsets);
    the annotation ranges' device spans, which cover other events and the
    gaps between them, are left out."""
    from torch.autograd import DeviceType
    return [(e.time_range.start / 1e3, e.time_range.end / 1e3)
            for e in prof.events()
            if getattr(e, "device_type", DeviceType.CPU) != DeviceType.CPU
            and not getattr(e, "is_user_annotation", False)
            and e.key not in TRAIN_RANGES]


def profile(torch, what: str, fn, reps: int) -> dict:
    """Device time by kernel over ``reps`` calls of ``fn`` (torch.profiler),
    the host-side kernel launches per call, and the device's idle share
    against the calls' wall time measured without the profiler; busy time is
    the union of the device events' spans (``busy_ms``)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    fn()                                          # warm-up
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
    from torch.autograd import DeviceType
    averages = prof.key_averages()
    rows = [(e.key, e.count) for e in averages]
    dev = [(e.key, e.self_device_time_total / 1e3 / reps, e.count / reps)
           for e in averages
           if getattr(e, "device_type", DeviceType.CPU) != DeviceType.CPU
           and e.self_device_time_total > 0]
    dev.sort(key=lambda r: -r[1])
    busy = busy_ms(device_intervals(torch, prof)) / reps
    launches = sum(c for k, c in rows
                   if k in ("cudaLaunchKernel", "cuLaunchKernel",
                            "cudaLaunchKernelExC", "cuLaunchKernelEx")) / reps
    out = {"device_busy_ms": busy, "wall_ms": wall,
           "device_event_sum_ms": sum(t for _, t, _ in dev),
           "wall_ms_under_profiler": prof_wall_ms,
           "idle_share": (1.0 - busy / wall) if wall > 0 else None,
           "host_launches": launches,
           "top": [(k[:60], round(t, 4), round(n, 1)) for k, t, n in dev[:8]]}
    if busy == 0.0:
        print(f"  profile {what}: the profiler saw no device time "
              f"(not measured)", flush=True)
    else:
        print(f"  profile {what}: device busy {busy:.3f} ms of {wall:.3f} "
              f"ms wall (idle share {out['idle_share']:.3f}); "
              f"{launches:.0f} kernel launches per call", flush=True)
        for k, t, n in dev[:8]:
            print(f"    {t:9.4f} ms  x{n:6.1f}  {k[:90]}", flush=True)
    return out


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
    flash = kern["flash"]
    flash.launches = 0
    t0 = time.perf_counter()
    rep = TraceDriver(router, trace, cost=cost, warm=True,
                      max_history=max_seq).run()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    k1 = flash.launches
    s = rep.summary()
    prefills = sum(e.prefills for e in engines)
    print(f"  report: " + json.dumps(s), flush=True)
    print(f"  {prefills} real prefills (new {s['new_sessions']:.0f} + lost "
          f"{s['lost_reprefills']:.0f} + migrations {s['migrations']:.0f}), "
          f"{s['resumes']:.0f} resumes, {sum(e.parks for e in engines)} "
          f"parks; flash_attention launches {k1} (40 x {prefills}); driver "
          f"wall {wall:.2f}s", flush=True)
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
    res = {"report": s, "prefills": prefills, "launches": k1,
           "prefill_seconds_measured": measured,
           "prefill_seconds_model": cost.prefill_seconds(int(mean_prompt)),
           "driver_wall_s": wall,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    return res


# ------------------------------------------------------------------ train phase
TRAIN_RANGES = ("flash_attention_bwd_plain", "adamw_update")
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
    avg = prof.key_averages()
    dev = [(e.key, e.self_device_time_total / 1e3, e.count) for e in avg
           if getattr(e, "device_type", DeviceType.CPU) != DeviceType.CPU
           and e.self_device_time_total > 0 and e.key not in TRAIN_RANGES]
    dev.sort(key=lambda r: -r[1])
    busy = busy_ms(device_intervals(torch, prof))
    ranges = {r: sum(e.device_time_total / 1e3 for e in avg if e.key == r
                     and getattr(e, "device_type", DeviceType.CPU)
                     == DeviceType.CPU) for r in TRAIN_RANGES}
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


def forward_flops(cfg, B: int, S: int) -> float:
    """Matmul FLOPs (2 per multiply-add) of one forward pass over B x S
    tokens: every projection on the tokens it is applied to (whisper's
    encoder on its frames, the cross K/V on the frames or patches), QK^T and
    PV over the pairs a mask lets through (MLA's PV at V's own 128 columns),
    the router and the experts each token is routed to (top-k routed plus
    the shared ones), the SSD's chunk products, the WKV state products, and
    the head."""
    from repro_torch.models import model as M
    from repro_torch.models import rwkv, ssm
    T, d, H, Hkv, hd = B * S, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def lin(t, i, o):
        return 2.0 * t * i * o

    def attn(sq, sk, causal, dqk=hd, dv=hd):
        pairs = sq * (sq + 1) / 2 if causal else sq * sk
        return 2.0 * B * H * (dqk + dv) * pairs

    def gqa(t, tk=None, tq_len=S, tk_len=None, causal=True):
        tk = t if tk is None else tk
        tk_len = tq_len if tk_len is None else tk_len
        return (lin(t, d, H * hd) + lin(t, H * hd, d) + 2 * lin(tk, d, Hkv * hd)
                + attn(tq_len, tk_len, causal))

    def mlp(t, ff, gated=True):
        return (3 if gated else 2) * lin(t, d, ff)

    head = lin(T, d, M.padded_vocab(cfg))
    fam = cfg.family
    if fam in ("dense", "localglobal"):
        return cfg.n_layers * (gqa(T) + mlp(T, cfg.d_ff)) + head
    if fam == "encdec":
        F, E = cfg.n_frames, cfg.encoder_layers
        enc = E * (gqa(B * F, tq_len=F, causal=False)
                   + mlp(B * F, cfg.d_ff, False))
        dec = cfg.n_layers * (gqa(T) + gqa(T, B * F, tk_len=F, causal=False)
                              + mlp(T, cfg.d_ff, False))
        return enc + dec + head
    if fam == "vlm":
        G, per = M._vlm_layout(cfg)
        P = cfg.n_patches
        return (G * per * (gqa(T) + mlp(T, cfg.d_ff))
                + G * (gqa(T, B * P, tk_len=P, causal=False)
                       + mlp(T, cfg.d_ff)) + head)
    if fam == "moe":
        m = cfg.mla
        if m is None:
            attn_f = gqa(T)
        else:
            attn_f = (lin(T, d, m.q_lora_rank)
                      + lin(T, m.q_lora_rank, H * m.qk_head_dim)
                      + lin(T, d, m.kv_lora_rank + m.qk_rope_head_dim)
                      + lin(T, m.kv_lora_rank,
                            H * (m.qk_nope_head_dim + m.v_head_dim))
                      + lin(T, H * m.v_head_dim, d)
                      + attn(S, S, True, m.qk_head_dim, m.v_head_dim))
        dense = attn_f + mlp(T, cfg.d_ff)
        routed = (lin(T, d, cfg.n_experts)
                  + 3 * lin(T * cfg.experts_per_token, d, cfg.moe_d_ff)
                  + 3 * lin(T, d, cfg.moe_d_ff * cfg.n_shared_experts)
                  + (mlp(T, cfg.d_ff) if cfg.dense_residual else 0.0))
        n_dense = cfg.first_dense_layers
        total = n_dense * dense + (cfg.n_layers - n_dense) * (attn_f + routed)
        if cfg.mtp_depth:
            total += lin(T, 2 * d, d) + dense + head
        return total + head
    if fam == "hybrid":
        d_in, Hs, P, N = ssm.ssm_dims(cfg)
        Q = min(ssm.CHUNK, S)
        nc = -(-S // Q)
        ssd = B * nc * (2.0 * Q * Q * N + 2.0 * Hs * Q * Q * P
                        + 4.0 * Q * Hs * P * N)
        mamba = lin(T, d, 2 * d_in + 2 * N + Hs) + lin(T, d_in, d) + ssd
        G = cfg.n_layers // cfg.attn_every
        return (cfg.n_layers * mamba + G * (gqa(T) + mlp(T, cfg.d_ff))
                + head)
    Hr, K = rwkv.rwkv_dims(cfg)                                 # rwkv
    tm = (lin(T, d, 5 * rwkv.TM_LORA) + 5 * lin(T, rwkv.TM_LORA, d)
          + lin(T, d, rwkv.W_LORA) + lin(T, rwkv.W_LORA, d) + 5 * lin(T, d, d)
          + 4.0 * T * Hr * K * K)
    cm = lin(T, d, cfg.d_ff) + lin(T, cfg.d_ff, d) + lin(T, d, d)
    return cfg.n_layers * (tm + cm) + head


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
    by_path["trace granite-3-2b"] = {"flash_attention": trace["launches"],
                                     "decode_attention": 0}
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
