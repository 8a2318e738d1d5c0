"""Closed-loop serving on one engine, in real time: one client per slot,
one turn per request, so nothing is parked, resumed or routed.

Each client sends its next job (a prompt and an output length from
:func:`traffic.closed_jobs`) as soon as its previous answer is complete.
The loop is the engine's: ``submit`` every job that has a free slot (its
prefill gives the first token), then one pooled ``ServingEngine.step``;
a request whose output is complete is finished. Set-up runs the loop for
``warm_s`` seconds, so the window starts with every slot busy.
``served_tok_per_s`` is the prompt tokens prefilled plus the tokens
produced in the window, over the window.
"""

from __future__ import annotations

import time

import torch

import traffic as T
from drivers import serving as S
from harness import Record
from work.busy import TraceSlice

WARM_KEY = 1 << 40          # prompt keys of the warm-up, past any job's


def run(ctx) -> Record:
    from repro_torch.core.config import ServingConfig
    from repro_torch.serve.engine import ServingEngine

    mix, config, dev, seed = ctx.cell.mix, ctx.cell.config, ctx.device, \
        ctx.seed
    seconds = float(ctx.seconds)
    E = mix["engine"]
    rec = Record()
    phases = rec.notes["setup_phases_s"] = {}

    def phase(name: str) -> None:
        """Seconds from process start to the end of a set-up phase."""
        S.sync(dev)
        phases[name] = time.time() - ctx.t0_wall

    phase("imports")
    cfg, model, w = S.make_model(config, seed, dev)
    phase("weights")
    eng = ServingEngine(cfg, model, config=ServingConfig(
        max_batch=E["slots"], max_seq=E["max_seq"]), device=dev)
    ledger = S.Ledger()
    jobs = T.closed_jobs(mix, seed, mix["jobs"])
    max_prompt = max(p for p, _ in jobs)

    def tokens(key: int, n: int) -> list[int]:
        return T.session_tokens(seed, key, n, cfg.vocab)

    # ---------------------------------------------------------- warm-up
    sid = eng.submit(tokens(WARM_KEY, max_prompt))
    eng.step()
    eng.finish(sid)
    phase("warm_up")

    want: dict[int, int] = {}             # sid -> tokens it is owed
    n_job = 0
    tally = {"prefill_tokens": 0, "tokens": 0, "attn_ctx": 0,
             "prefills": 0, "requests_done": 0}
    prefill_dt: list[float] = []
    prefill_len: list[int] = []
    steps_s: list[float] = []
    work_k1: list[int] = []
    work_k2: list[list[int]] = []
    slice_ = TraceSlice() if ctx.trace else None
    state = {"counting": False, "t_end": None}

    def admit() -> None:
        nonlocal n_job
        while eng.can_admit():
            plen, olen = jobs[n_job % len(jobs)]
            key = n_job
            n_job += 1
            prompt = tokens(key, plen)
            before = eng.prefill_seconds
            with S.host_range("bench.submit"):
                s = eng.submit(prompt)
            done_t = time.perf_counter()
            ledger.opened(s, prompt, eng)
            want[s] = olen - 1
            if state["counting"] and done_t < state["t_end"]:
                # the prefill's own seconds, as TorchComputeBackend.prefill
                # measured them: the engine keeps their mean 0.5 / 0.5
                dt = eng.prefill_seconds if before is None \
                    else 2.0 * eng.prefill_seconds - before
                prefill_dt.append(dt)
                prefill_len.append(plen)
                tally["prefill_tokens"] += plen
                tally["tokens"] += 1
                tally["prefills"] += 1
            if slice_ is not None and slice_.active:
                work_k1.append(plen)
            if want[s] <= 0:
                finish(s)

    def finish(s: int) -> None:
        toks = eng.sessions[s].tokens
        ledger.pieces.append(S.Piece(s, 0, len(toks), "job"))
        with S.host_range("bench.finish"):
            eng.finish(s)
        del want[s]
        if state["counting"]:
            tally["requests_done"] += 1

    def step() -> None:
        if slice_ is not None and slice_.active:
            work_k2.append((eng.state["pos"] + 1).tolist())
        t0 = time.perf_counter()
        with S.host_range("bench.step"):
            out = eng.step()
        t1 = time.perf_counter()
        counting = state["counting"] and t1 < state["t_end"]
        if counting:
            steps_s.append(t1 - t0)
        for s in out:
            want[s] -= 1
            if counting:
                tally["tokens"] += 1
                tally["attn_ctx"] += len(ledger.prompt[s]) \
                    + len(eng.sessions[s].tokens) - 1
            if want[s] <= 0 or eng.sessions[s].done:
                finish(s)

    t_warm = time.perf_counter() + float(mix["warm_s"])
    while time.perf_counter() < t_warm:
        admit()
        step()
    phase("fill")
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()
    rec.values["setup_s"] = time.time() - ctx.t0_wall
    t_w = time.perf_counter()
    state.update(counting=True, t_end=t_w + seconds)
    trace_from = t_w + seconds - float(mix.get("trace_seconds", 2.0))
    while True:
        now = time.perf_counter()
        if slice_ is not None and not slice_.active and now >= trace_from \
                and now < state["t_end"]:
            slice_.start()
        if now >= state["t_end"]:
            break
        admit()
        step()
    if slice_ is not None and slice_.active:
        slice_.stop()
    S.sync(dev)
    rec.memory_peak_bytes = (torch.cuda.max_memory_allocated()
                             if dev != "cpu" else 0)

    # ------------------------------------------------------------ results
    served = tally["prefill_tokens"] + tally["tokens"]
    rec.values["served_tok_per_s"] = served / seconds
    rec.window_s = seconds
    rec.attempted = tally["prefills"]
    rec.failed = 0
    rec.spans["decode_step"] = steps_s
    rec.spans["prefill"] = prefill_dt
    rec.counters.update(tally)
    rec.counters["steps"] = len(steps_s)
    rec.profile = slice_
    rec.work = {"k1_prompts": work_k1, "k2_lengths": work_k2,
                "model": config["model"], "slots": E["slots"],
                "max_seq": E["max_seq"], "prefill_lengths": prefill_len,
                "decode_tokens": tally["tokens"] - tally["prefills"],
                "decode_ctx": tally["attn_ctx"]}
    rec.check("requests_finished", tally["requests_done"], 1,
              tally["requests_done"] >= 1)

    picks = S.pick_samples(ledger, [p for p in ledger.pieces if p.b > p.a],
                           mix["check"]["requests"], seed)
    samples = [ledger.sample(p) for p in picks]
    rec.notes["sample_tokens"] = sum(p.b - p.a for p in picks)
    del eng, model, ledger
    S.free_program(dev)
    S.check_served(rec, config, w, samples, mix["check"]["gap_limit"])
    return rec
