"""Open-loop chat through the Router and the LocStore, in real time.

The loop is the one ``repro_torch.launch.serve`` runs: route a turn, then
``submit`` or ``Router.follow_up``, then ``ServingEngine.step`` round robin
across the engines. Turns arrive on the schedule of
:func:`traffic.chat_schedule` whatever the system's speed (open loop); a
turn waits for a free slot and for its session's previous turn, and its
time to first token runs from its scheduled arrival. A session is parked
when its turn's output is complete and finished after its last turn; a
turn that would take its conversation past ``max_seq`` finishes the session
and opens a new one with its own prompt. Set-up prefills the most recent
``max_parked`` conversations that the schedule's history left open, each
at its length so far, and parks them, so the window starts with follow-ups
to resume. A follow-up whose conversation has no cache (one of the older
open conversations that set-up did not hold, or one finished to keep the
parked slices under ``max_parked``) is served as a new session whose
prompt is the whole conversation: its history, then the turn's prompt.

A follow-up that the Router resumes continues the session's cache (the
program does not prefill the turn's prompt on that path); one that it
migrates re-prefills the session's prompt, its tokens and the turn's
prompt on the other engine. A session the Router parks to make room in
the middle of a turn waits for a slot and continues its turn.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import torch

import traffic as T
from drivers import serving as S
from harness import Record
from work.busy import TraceSlice


@dataclasses.dataclass
class Turn:
    req: T.Request
    first: float | None = None          # window clock of its first token
    left: int = 0                       # tokens still to serve
    piece: S.Piece | None = None


@dataclasses.dataclass
class _Conv:
    """One conversation of the trace: its program session (None when it
    has none open), the turn in progress, and turns waiting for it."""

    sid: int | None = None
    hist: int = 0                       # tokens of the conversation so far
    lost: str | None = None             # why it has no cache: unpopulated,
    busy: Turn | None = None            # capped or done
    waiting: collections.deque = dataclasses.field(
        default_factory=collections.deque)


WARM_KEY = 1 << 40          # prompt keys of the warm-up, past any session's
HIST_KEY = 1 << 41          # prompt keys of a conversation's history


def _key(session: int, turn: int) -> int:
    return session * 65536 + turn


def run(ctx) -> Record:
    from repro_torch.core.config import ServingConfig
    from repro_torch.core.locstore import LocStore, tiered_hierarchy
    from repro_torch.serve.engine import Router, ServingEngine

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
    sched = T.chat_schedule(mix, seconds)
    cfg, model, w = S.make_model(config, seed, dev)
    phase("weights")
    scfg = ServingConfig(max_batch=E["slots"], max_seq=E["max_seq"],
                         idle_tier=E["idle_tier"])
    store = LocStore(E["engines"], hierarchy=tiered_hierarchy(**mix["tiers"]))
    engines = [ServingEngine(cfg, model, config=scfg, node=i, store=store,
                             device=dev) for i in range(E["engines"])]
    router = Router(engines, store, config=scfg)
    ledger = S.Ledger()
    max_seq, vocab = E["max_seq"], cfg.vocab

    def tokens(key: int, n: int) -> list[int]:
        return T.session_tokens(seed, key, n, vocab)

    # ---------------------------------------------------------- warm-up
    # the longest prefill the window can ask for, a pooled decode step,
    # a park and a resume on every engine
    for i, eng in enumerate(engines):
        sid = eng.submit(tokens(WARM_KEY + i, max_seq - 4 - E["warm_steps"]))
        for _ in range(E["warm_steps"]):
            eng.step()
        eng.park(sid)
        eng.resume(sid)
        eng.finish(sid)
    phase("warm_up")

    convs: dict[int, _Conv] = collections.defaultdict(_Conv)
    counts = collections.Counter()

    def parked() -> list[tuple[int, object]]:
        return [(sid, e) for e in engines for sid in e.parked_sids()]

    def cap_parked() -> None:
        """Finish the least recently active parked sessions past the mix's
        ``max_parked``: their slices stay on the card, which holds so many
        beside the slots and the weights."""
        ps = parked()
        extra = len(ps) - mix["max_parked"]
        if extra <= 0:
            return
        ps.sort(key=lambda p: p[1].sessions[p[0]].last_active)
        for sid, e in ps[:extra]:
            e.finish(sid)
            for c in convs.values():
                if c.sid == sid:
                    c.sid, c.lost = None, "capped"
            counts["force_finished"] += 1

    # -------------------------------------------- set-up: the population
    # every open conversation keeps its length; the most recently active
    # ones the card can hold are prefilled and parked, least recent first
    # (prefilling the older ones would only feed the cap)
    held = len(sched.population) - mix["max_parked"]
    for i, (session, hist) in enumerate(sched.population):
        conv = convs[session]
        conv.hist = hist
        if i < held:
            conv.lost = "unpopulated"
            continue
        prompt = tokens(HIST_KEY + _key(session, 0), hist)
        eng = router.engine_for()
        sid = eng.submit(prompt)
        eng.park(sid)
        ledger.opened(sid, prompt, eng)
        conv.sid = sid
        cap_parked()
    phase("population")
    counts.clear()

    active: dict[int, Turn] = {}
    admit: collections.deque[Turn] = collections.deque()
    suspended: collections.deque[Turn] = collections.deque()
    arrivals = collections.deque(sched.window)
    window_turns: list[Turn] = []
    steps_ms: list[float] = []
    slice_ = TraceSlice() if ctx.trace else None
    trace_from = seconds - float(mix.get("trace_seconds", 2.0))
    snap: dict[str, float] = {}

    def router_counts() -> dict[str, float]:
        return {"followups": router.locality_hits + router.locality_misses,
                "migrations": router.migrations,
                "locality_evictions": router.locality_evictions,
                "prefills": sum(e.prefills for e in engines),
                "resumes": sum(e.resumes for e in engines),
                "parks": sum(e.parks for e in engines),
                "steps": sum(e.steps for e in engines)}

    def begin(turn: Turn, sid: int, eng, kind: str, first_now: bool,
              now: float) -> None:
        toks = eng.sessions[sid].tokens
        if first_now:
            turn.piece = S.Piece(sid, len(toks) - 1, len(toks), kind)
            if turn.first is None:
                turn.first = now
            turn.left -= 1
        else:
            turn.piece = S.Piece(sid, len(toks), len(toks), kind)
        active[sid] = turn
        if turn.left <= 0:
            complete(turn, eng)

    def new_session(prompt: list[int]) -> tuple[int, object]:
        with S.host_range("bench.route"):
            eng = router.engine_for()
        with S.host_range("bench.submit"):
            sid = eng.submit(prompt)
        ledger.opened(sid, prompt, eng)
        return sid, eng

    def check_victims() -> None:
        for sid, turn in list(active.items()):
            s = ledger.engine[sid].sessions[sid]
            if s.slot is None and not s.done:      # parked by the Router
                del active[sid]
                ledger.pieces.append(turn.piece)
                suspended.append(turn)
        cap_parked()

    def start(turn: Turn, now_fn) -> None:
        r = turn.req
        conv = convs[r.session]
        turn.left = r.output_len
        prompt = tokens(_key(r.session, r.turn), r.prompt_len)
        if r.turn == 0 or not T.fits(conv.hist, r.prompt_len, r.output_len,
                                     max_seq):
            if conv.sid is not None:
                ledger.engine[conv.sid].finish(conv.sid)
                conv.sid = None
            if r.turn > 0:
                counts["reopened_at_max_seq"] += 1
            conv.hist, conv.lost = 0, None
            kind = "new" if r.turn == 0 else "reopen"
        elif conv.sid is not None:
            cur = conv.sid
            eng = ledger.engine[cur]
            history = ledger.prompt[cur] + eng.sessions[cur].tokens + prompt
            conv.hist += r.prompt_len
            with S.host_range("bench.follow_up"):
                d = router.follow_up(cur, history)
            if d.prefilled:
                ledger.opened(d.sid, history, d.engine)
                conv.sid = d.sid
                begin(turn, d.sid, d.engine, "migrate", True, now_fn())
            else:
                begin(turn, cur, d.engine, "resume", False, now_fn())
            check_victims()
            return
        else:
            # no cache: the whole conversation is the prompt
            counts[f"rebuilt_{conv.lost or 'done'}"] += 1
            counts["rebuilds"] += 1
            prompt = tokens(HIST_KEY + _key(r.session, r.turn),
                            conv.hist) + prompt
            kind = "rebuild"
        conv.hist += r.prompt_len
        sid, eng = new_session(prompt)
        conv.sid, conv.lost = sid, None
        begin(turn, sid, eng, kind, True, now_fn())

    def restart(turn: Turn, now_fn) -> None:
        """A turn whose session the Router parked mid-turn takes a slot
        again: resumed in place, or migrated."""
        cur = turn.piece.sid
        eng = ledger.engine[cur]
        history = ledger.prompt[cur] + eng.sessions[cur].tokens
        with S.host_range("bench.follow_up"):
            d = router.follow_up(cur, history)
        conv = convs[turn.req.session]
        if d.prefilled:
            ledger.opened(d.sid, history, d.engine)
            conv.sid = d.sid
            begin(turn, d.sid, d.engine, "migrate", True, now_fn())
        else:
            begin(turn, cur, d.engine, "resume", False, now_fn())
        counts["restarts"] += 1
        check_victims()

    def complete(turn: Turn, eng) -> None:
        sid = turn.piece.sid
        active.pop(sid, None)
        ledger.pieces.append(turn.piece)
        conv = convs[turn.req.session]
        conv.hist += turn.req.output_len
        if not eng.sessions[sid].done:
            with S.host_range("bench.park"):
                if turn.req.final:
                    eng.finish(sid)
                else:
                    eng.park(sid)
        if turn.req.final or eng.sessions[sid].done:
            conv.sid, conv.lost = None, "done"
        conv.busy = None
        if conv.waiting:
            conv.busy = conv.waiting.popleft()
            admit.append(conv.busy)
        cap_parked()

    # ------------------------------------------------------------- window
    S.sync(dev)
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()
    rec.values["setup_s"] = time.time() - ctx.t0_wall
    t_w = time.perf_counter()

    def now() -> float:
        return time.perf_counter() - t_w

    drain_cap = seconds + float(mix["drain_s"])
    backlog: list[int] = []              # turns waiting, every 5 s
    while True:
        t = now()
        if t >= 5.0 * len(backlog) and t < seconds:
            backlog.append(len(admit) + len(suspended)
                           + sum(len(c.waiting) for c in convs.values()))
        if slice_ is not None and not slice_.active and not snap \
                and t >= trace_from:
            slice_.start()
        if t >= seconds and not snap:
            if slice_ is not None and slice_.active:
                slice_.stop()
            snap = {**router_counts(), **counts}
        while arrivals and arrivals[0].t <= t:
            r = arrivals.popleft()
            turn = Turn(r)
            if r.t < seconds:
                window_turns.append(turn)
            conv = convs[r.session]
            if conv.busy is None:
                conv.busy = turn
                admit.append(turn)
            else:
                conv.waiting.append(turn)
        n_susp = len(suspended)
        while (n_susp or admit) and any(e.can_admit() for e in engines):
            if n_susp:
                n_susp -= 1
                restart(suspended.popleft(), now)
            else:
                start(admit.popleft(), now)
        stepped = False
        for eng in engines:
            if not eng._slotted:
                continue
            t0 = time.perf_counter()
            with S.host_range("bench.step"):
                out = eng.step()
            t1 = time.perf_counter()
            if t0 - t_w < seconds:
                steps_ms.append(1e3 * (t1 - t0))
            stepped = True
            for sid in out:
                turn = active[sid]
                turn.piece.b += 1
                if turn.first is None:
                    turn.first = t1 - t_w
                turn.left -= 1
                if turn.left <= 0 or eng.sessions[sid].done:
                    complete(turn, eng)
        t = now()
        if t >= seconds and all(x.first is not None for x in window_turns):
            break
        if t >= drain_cap:
            break
        if not stepped and not admit and arrivals:
            with S.host_range("bench.wait"):
                time.sleep(max(0.0, min(arrivals[0].t - t, 0.002)))
    if slice_ is not None and slice_.active:
        slice_.stop()
    if not snap:
        snap = {**router_counts(), **counts}
    rec.memory_peak_bytes = (torch.cuda.max_memory_allocated()
                             if dev != "cpu" else 0)

    # ------------------------------------------------------------ results
    ttft = [x.first - x.req.t if x.first is not None else float("inf")
            for x in window_turns]
    rec.attempted = len(window_turns)
    rec.failed = sum(x.first is None for x in window_turns)
    rec.window_s = seconds
    if window_turns and rec.failed == 0:
        rec.values["ttft_p90_s"] = S.percentile(ttft, 90)
        rec.notes["ttft_p50_s"] = S.percentile(ttft, 50)
    rec.spans["decode_step"] = [m / 1e3 for m in steps_ms]
    rec.counters.update(snap)
    rec.counters["window_turns"] = len(window_turns)
    rec.profile = slice_
    rec.notes["population"] = min(len(sched.population), mix["max_parked"])
    rec.notes["open_at_start"] = len(sched.population)
    rec.notes["backlog_every_5s"] = backlog
    rec.check("window_turns_unanswered", rec.failed, 0, rec.failed == 0)

    done = [p for p in ledger.pieces if p.b > p.a]
    picks = S.pick_samples(ledger, done, mix["check"]["requests"], seed)
    samples = [ledger.sample(p) for p in picks]
    rec.notes["sample_kinds"] = [p.kind for p in picks]
    rec.notes["sample_tokens"] = sum(p.b - p.a for p in picks)
    del engines, router, store, model, ledger, active, convs, eng, \
        suspended, admit
    S.free_program(dev)
    S.check_served(rec, config, w, samples, mix["check"]["gap_limit"])
    return rec
