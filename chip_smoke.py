#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one H100 and check every kernel on its path.

    python3 chip_smoke.py                          # the whole check
    python3 chip_smoke.py --sweep-decode-chunks    # decode chunk sizes only

Run from the root of a checkout, on a machine with one CUDA card. It imports
nothing of JAX and nothing of the reference package ``repro``; it builds the
port's kernels from ``src/repro_torch/kernels/csrc`` with nvcc and then:

1. prints the card (``nvidia-smi`` name and power limit, torch's device name
   and count);
2. prints the build (seconds, and ptxas' registers / spills per kernel);
3. holds each kernel against its plain PyTorch version on the card, in f32
   and bf16, at the serving path's shapes, the reference's edge shapes and
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
6. prints the kernels' JSON line, the card line again, and last
   ``{"ok": true, "device": {...}}``.

With ``--sweep-decode-chunks`` it only times the decode kernel at the path's
shapes at each chunk size of CHUNKS_TRIED (how ``chunk_size`` was chosen) and
prints no result line.

Any failure exits non-zero before the last line. Without a CUDA device, or
without the repository around it, it exits non-zero at once.
"""

from __future__ import annotations

import dataclasses
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
# the serving path's shapes: (name, case)
FLASH_PATH = [("granite-3-2b", (1, 1024, 1024, 32, 8, 64, True, 0, 0)),
              ("gemma3-12b local", (1, 1536, 1536, 16, 8, 240, True, 1024, 0))]
DECODE_PATH = [("granite-3-2b", (8, 2048, 32, 8, 64, 0)),
               ("gemma3-12b local", (8, 2048, 16, 8, 240, 1024))]
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
]
DECODE_EDGE = [
    # B, S, Hq, Hkv, hd, window, lengths (decode chunk 192 at hd <= 128)
    (4, 600, 8, 2, 64, 0, [1, 192, 193, 5000]),
    (2, 1024, 4, 2, 64, 100, [250, 650]),
    (2, 2048, 4, 2, 240, 50, [100, 1900]),
    (3, 700, 16, 2, 128, 0, [700, 1, 513]),
    (2, 512, 24, 2, 64, 0, [512, 130]),
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


def flash_work(case, itemsize: int) -> tuple[float, float]:
    """(operations, bytes) the function needs: 4 * hd per visible (q, k) pair
    per q-head; q, k, v read once and o written once."""
    B, Sq, Sk, Hq, Hkv, hd, causal, window, off = case
    pairs = 0
    for i in range(Sq):
        qp = off + i
        hi = min(Sk - 1, qp) if causal else Sk - 1
        lo = max(0, qp - window + 1) if window > 0 else 0
        pairs += max(0, hi - lo + 1)
    ops = 4.0 * B * Hq * hd * pairs
    nbytes = itemsize * (2 * B * Sq * Hq * hd + 2 * B * Sk * Hkv * hd)
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

    def lens_for(B, S):
        lens = torch.randint(1, S + 1, (B,), generator=gen, device="cuda",
                             dtype=torch.int32)
        lens[0] = S
        lens[-1] = 1
        return lens

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
        for label, case in [(f"case{i}", c) for i, c in enumerate(DECODE_CASES)] \
                + DECODE_PATH:
            B, S, Hq, Hkv, hd, window = case
            q = mk((B, Hq, hd), dt)
            kc, vc = mk((B, S, Hkv, hd), dt), mk((B, S, Hkv, hd), dt)
            lens = lens_for(B, S)
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
    rows = {}
    for name, case in FLASH_PATH:
        B, Sq, Sk, Hq, Hkv, hd, causal, window, off = case
        dt = torch.bfloat16
        ops, nbytes = flash_work(case, 2)
        n = max(1, min(8, math.ceil(100e6 / nbytes)))
        sets = [(mk((B, Sq, Hq, hd), dt), mk((B, Sk, Hkv, hd), dt),
                 mk((B, Sk, Hkv, hd), dt)) for _ in range(n)]
        kw = dict(causal=causal, window=window, q_offset=off)
        qpos = off + torch.arange(Sq, device="cuda")[:, None]
        kpos = torch.arange(Sk, device="cuda")[None, :]
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device="cuda")
        if causal:
            mask &= kpos <= qpos
        if window > 0:
            mask &= qpos - kpos < window
        nxt = rotating(n)

        def lib_mask(s):
            q, k, v = s
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, enable_gqa=True).transpose(1, 2)

        def lib_causal(s):
            q, k, v = s
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True).transpose(1, 2)

        libs = [("scaled_dot_product_attention(attn_mask, enable_gqa)",
                 lib_mask)]
        if causal and window == 0 and off == 0 and Sq == Sk:
            libs.append(("scaled_dot_product_attention(is_causal, enable_gqa)",
                         lib_causal))
        q, k, v = sets[0]
        want = ref.flash_attention_ref(q, k, v, **kw)
        err = check("flash_attention", f"timed {name}", dt, flash(q, k, v, **kw),
                    want)
        need(not failed, f"kernel check failed: {failed}")
        t_k = time_ms(torch, lambda: flash(*sets[nxt()], **kw), 20)
        t_p = time_ms(torch, lambda: ref.flash_attention_ref(*sets[nxt()], **kw), 4)
        lib_times = []
        for call, lib in libs:
            lib_err = (lib(sets[0]).float() - want.float()).abs().max().item()
            t_l = time_ms(torch, lambda: lib(sets[nxt()]), 20)
            print(f"  flash_attention  {name:18s} library {call}: {t_l:.4f} ms "
                  f"(err {lib_err:.2e})", flush=True)
            lib_times.append((t_l, call))
        t_l, lib_call = min(lib_times)
        h_us = host_us(torch, lambda: flash(q, k, v, **kw))
        b_ms, b_by = bound_ms(ops, nbytes, "bfloat16")
        print(f"  flash_attention  {name:18s} kernel_ms={t_k:.4f} "
              f"plain_ms={t_p:.4f} library_ms={t_l:.4f} bound_ms={b_ms:.5f} "
              f"by {b_by} ({ops:.3e} op, {nbytes:.3e} B); kernel at "
              f"{ops / t_k / 1e9:.1f} TFLOP/s", flush=True)
        print(f"  flash_attention  {name:18s} host enqueue {h_us:.1f} us per "
              f"wrapper call", flush=True)
        rows.setdefault("flash_attention", dict(
            ms=t_k, plain_ms=t_p, library_ms=t_l, library_call=lib_call,
            bound_ms=b_ms, bound_by=b_by, shape_err=err, host_us=h_us))
    for name, case in DECODE_PATH:
        B, S, Hq, Hkv, hd, window = case
        dt = torch.bfloat16
        lens = lens_for(B, S)
        ops, nbytes = decode_work(case, lens.tolist(), 2)
        n = max(1, min(8, math.ceil(100e6 / (4 * B * S * Hkv * hd))))
        sets = [(mk((B, Hq, hd), dt), mk((B, S, Hkv, hd), dt),
                 mk((B, S, Hkv, hd), dt)) for _ in range(n)]
        kpos = torch.arange(S, device="cuda")[None, :]
        ln = lens.clamp(max=S)[:, None]
        mask = kpos < ln
        if window > 0:
            mask &= (ln - 1 - kpos) < window
        mask = mask[:, None, None, :]
        nxt = rotating(n)
        lib_call = "scaled_dot_product_attention(attn_mask, enable_gqa)"

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
        rows.setdefault("decode_attention", dict(
            ms=t_k, plain_ms=t_p, library_ms=t_l, library_call=lib_call,
            bound_ms=b_ms, bound_by=b_by, shape_err=err, host_us=h_us))
    for name in rows:
        rows[name]["max_abs_err"] = worst[name]
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
    for name, (B, S, Hq, Hkv, hd, window) in DECODE_PATH:
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
                      label: str) -> float:
    """Ties K1 to K2: decode step t's logits (K2 over the prefilled cache)
    must match the last-position logits of a prefill (K1) of the prompt plus
    the t tokens. Compared as log-probabilities; the two paths round bf16 at
    different places (one position's activations vs a whole sequence's
    matmuls), through every layer, so the bound is stated for bf16:
    CONSISTENCY_TOL on the max |difference| of the top-32 log-probs."""
    dev = model.device
    with torch.no_grad():
        tok = torch.tensor([prompt], device=dev)
        logits, state = M.prefill(cfg, model, {"tokens": tok},
                                  len(prompt) + steps + 1)
        seq = list(prompt)
        nxt = int(logits[0, -1].argmax())
        worst = 0.0
        for _ in range(steps):
            seq.append(nxt)
            step_logits, state = M.decode_step(
                cfg, model, state, torch.tensor([[nxt]], device=dev))
            full, _ = M.prefill(
                cfg, model, {"tokens": torch.tensor([seq], device=dev)},
                len(seq))
            a = torch.log_softmax(step_logits[0, -1].float(), -1)
            b = torch.log_softmax(full[0, -1].float(), -1)
            need(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
                 f"{label}: non-finite logits")
            top = torch.topk(b, 32).indices
            worst = max(worst, (a[top] - b[top]).abs().max().item())
            nxt = int(step_logits[0, -1].argmax())
    ok = worst <= CONSISTENCY_TOL
    print(f"  consistency {label}: decode step vs prefill of prompt+t "
          f"({steps} steps) max |dlogp| over top-32 = {worst:.4f} "
          f"tol={CONSISTENCY_TOL} {'ok' if ok else 'FAIL'}", flush=True)
    need(ok, f"{label}: decode/prefill logits disagree by {worst}")
    return worst


def serve_granite(torch, kern) -> dict:
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.config import ServingConfig
    from repro_torch.core.locstore import LocStore, tiered_hierarchy
    from repro_torch.core.prefetch import PrefetchEngine
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Router, ServingEngine
    cfg = get_config("granite-3-2b")
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab} (padded {M.padded_vocab(cfg)}), "
          f"{cfg.dtype}, random weights seed {SEED}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = M.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"  params {M.param_count(cfg):,} initialised in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    store = LocStore(2, hierarchy=tiered_hierarchy())
    config = ServingConfig(max_batch=8, max_seq=2048)
    engines = [ServingEngine(cfg, model, config=config, node=i, store=store)
               for i in range(2)]
    prefetch = PrefetchEngine(store)
    router = Router(engines, store, prefetch=prefetch)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).tolist()
               for n in rng.integers(128, 1025, size=11)]

    flash, decode = kern["flash"], kern["decode"]
    flash.launches = 0
    decode.launches = 0
    # ------------------------------------------------------------ main path
    ttft, placed = [], []
    for p in prompts:
        t = time.perf_counter()
        eng = router.engine_for()
        sid = eng.submit(p)
        ttft.append(time.perf_counter() - t)
        placed.append((eng, sid))
    a_eng, a_sid = placed[0]
    c_eng = next(e for e in engines if e is not a_eng)
    t = time.perf_counter()
    c_sid = c_eng.submit(prompts[0])           # the never-parked control
    ttft.append(time.perf_counter() - t)
    placed.append((c_eng, c_sid))
    n_tokens, t_dec = 0, 0.0
    for _ in range(32):
        t = time.perf_counter()
        for e in engines:
            n_tokens += len(e.step())
        t_dec += time.perf_counter() - t
    a_eng.park(a_sid)
    warmed = router.warm(a_sid)
    prefetch.drain()
    d1 = router.follow_up(a_sid, a_eng.sessions[a_sid].tokens)
    b_eng, b_sid = placed[1]
    d2 = router.follow_up(b_sid, b_eng.sessions[b_sid].tokens)
    for _ in range(8):
        t = time.perf_counter()
        for e in engines:
            n_tokens += len(e.step())
        t_dec += time.perf_counter() - t
    torch.cuda.synchronize()
    k1, k2 = flash.launches, decode.launches
    # ------------------------------------------------------------ checks
    prefills = sum(e.prefills for e in engines)
    steps = sum(e.steps for e in engines)
    print(f"  launches: flash_attention {k1} (40 x {prefills} prefills = "
          f"{40 * prefills}), decode_attention {k2} (40 x {steps} decode "
          f"steps = {40 * steps})", flush=True)
    need(k1 > 0 and k2 > 0, "a kernel of the path was never launched")
    need(k1 == cfg.n_layers * prefills, "flash launches != 40 x prefills")
    need(k2 == cfg.n_layers * steps, "decode launches != 40 x decode steps")
    need(d1.kind == "hit_parked" and d1.resumed and not d1.prefilled,
         f"park/resume follow-up went {d1}")
    need(d2.kind == "hit_live" and not d2.prefilled,
         f"live follow-up went {d2}")
    need(warmed, "Router.warm did not promote the parked session")
    a_tok = a_eng.sessions[a_sid].tokens
    c_tok = c_eng.sessions[c_sid].tokens
    print(f"  park/resume: parked session {len(a_tok)} tokens, last 8 "
          f"{a_tok[-8:]}; control last 8 {c_tok[-8:]}", flush=True)
    need(a_tok == c_tok, "resumed session diverged from its never-parked "
         "control")
    for e, s in placed:
        toks = e.sessions[s].tokens
        need(all(0 <= x < cfg.vocab for x in toks),
             f"session {s}: token outside the vocab")
    peak = torch.cuda.max_memory_allocated()
    kv = engines[0].slot_bytes()
    # 80 KiB of K and V per token (2 x 40 layers x 8 heads x 64 x 2 B) per
    # position of max_seq, plus the slot's 4-byte int32 position
    need(kv == 2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * 2 * 2048 + 4,
         f"slot bytes {kv} != 80 KiB x max_seq + 4")
    ttft_sorted = sorted(ttft)
    res = {
        "prefill_seconds": [e.prefill_seconds for e in engines],
        "ttft_s_p50": ttft_sorted[len(ttft) // 2], "ttft_s_max": ttft_sorted[-1],
        "prompt_tokens": sum(len(p) for p in prompts) + len(prompts[0]),
        "decode_tokens": n_tokens, "decode_seconds": t_dec,
        "decode_tokens_per_s": n_tokens / t_dec,
        "kv_bytes_per_session": kv, "peak_memory_bytes": peak,
        "router": {k: getattr(router, k) for k in (
            "locality_hits", "locality_misses", "locality_evictions",
            "migrations", "warmups")},
        "engines": [{"prefills": e.prefills, "steps": e.steps,
                     "parks": e.parks, "resumes": e.resumes} for e in engines],
        "launches": {"flash_attention": k1, "decode_attention": k2},
    }
    print("  " + json.dumps(res), flush=True)
    prefetch.shutdown()
    # consistency of K1 and K2 (after the counts were read)
    res["consistency"] = check_consistency(torch, M, cfg, model,
                                           prompts[1][:256], 4, cfg.name)
    # where the time goes (after every count and check above was read)
    res["profile_decode"] = profile(torch, "one pooled decode step (B=8)",
                                    lambda: engines[1].step(), 2)
    res["profile_prefill"] = profile(
        torch, "one 1024-token prefill", lambda: engines[0].finish(
            engines[0].submit(rng.integers(0, cfg.vocab, size=1024).tolist())),
        1)
    del engines, router, store, model
    torch.cuda.empty_cache()
    return res


def profile(torch, what: str, fn, reps: int) -> dict:
    """Device time by kernel over ``reps`` calls of ``fn`` (torch.profiler),
    the host-side kernel launches per call, and the device's idle share
    against the calls' wall time measured without the profiler."""
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
    rows = [(e.key, getattr(e, "self_device_time_total", 0.0), e.count)
            for e in prof.key_averages()]
    dev = [(k, t / 1e3 / reps, n / reps) for k, t, n in rows if t > 0]
    dev.sort(key=lambda r: -r[1])
    busy_ms = sum(t for _, t, _ in dev)
    launches = sum(c for k, _, c in rows
                   if k in ("cudaLaunchKernel", "cuLaunchKernel",
                            "cudaLaunchKernelExC", "cuLaunchKernelEx")) / reps
    out = {"device_busy_ms": busy_ms, "wall_ms": wall,
           "wall_ms_under_profiler": prof_wall_ms,
           "idle_share": (1.0 - busy_ms / wall) if wall > 0 else None,
           "host_launches": launches,
           "top": [(k[:60], round(t, 4), round(n, 1)) for k, t, n in dev[:8]]}
    if busy_ms == 0.0:
        print(f"  profile {what}: the profiler saw no device time "
              f"(not measured)", flush=True)
    else:
        print(f"  profile {what}: device busy {busy_ms:.3f} ms of {wall:.3f} "
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
    if argv and not sweep:
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
    t0 = time.perf_counter()
    rows = kernel_phase(torch, kern)
    print(f"[kernels] phase done in {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    granite = serve_granite(torch, kern)
    print(f"[serve] granite phase done in {time.perf_counter() - t0:.1f}s",
          flush=True)
    t0 = time.perf_counter()
    serve_gemma(torch, kern)
    print(f"[serve] gemma phase done in {time.perf_counter() - t0:.1f}s",
          flush=True)

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
                        "design": DESIGN[name], "host_us": r["host_us"]})
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
