"""Trace-driven serving: realistic traffic at 10^5-session scale.

The port of ``repro.serve.traffic``: the module is numpy only, and is kept
line for line with the imports pointed at the port's engine and store, so a
seed gives the same trace, report and counters in both packages. Driven
through engines with a :class:`~repro_torch.serve.engine.TorchComputeBackend`
each admission is a real prefill on the card, while the driver's service
times stay modeled (:class:`CostModel`).

Two halves, both seeded and wall-clock-free:

* :func:`generate_trace` — a request-trace generator with the workload shape
  the serving literature actually measures against (the depsched simulator's
  ``init_req_queue(req_rate, zipf=...)`` idiom): **Zipf** session popularity
  (a few hot conversations get most follow-ups), **Poisson** or **bursty**
  (2-state Markov-modulated) arrivals, and **heavy-tailed** (lognormal)
  prompt/output lengths.

* :class:`TraceDriver` — a discrete-event driver that pushes the trace
  through the full :class:`~repro_torch.serve.engine.Router` /
  :class:`~repro_torch.serve.engine.ServingEngine` park/resume/warm/failover
  lifecycle in *virtual* time, recording per-request TTFT, resume latency and
  queue delay with p50/p95/p99 summaries. It is also ``Router.warm()``'s
  missing caller: per-session inter-arrival EMAs
  (:class:`InterArrivalPredictor`) schedule warms ahead of predicted
  follow-ups, and the driver reports how much resume latency the warms
  actually hid (warm-hit rate, wasted warms).

Compute is replaced by :class:`SyntheticBackend` — a tiny numpy pytree whose
*modeled* KV byte size is what the store accounts — so 10^5+ sessions are
tractable while the storage layer (true byte capacities, tier residency,
eviction cascades, write-back) behaves exactly as with the torch backend.
Service times come from :class:`CostModel` plus the hierarchy's media times,
never the wall clock, so every run is bit-reproducible.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
from typing import Callable, Mapping, Sequence

import numpy as np

from repro_torch.core.config import ServingConfig
from repro_torch.core.locstore import LocStore, StorageHierarchy, TierSpec
from repro_torch.serve.engine import Router, ServingEngine, _cache_name

MiB = float(1 << 20)
GiB = float(1 << 30)


# --------------------------------------------------------------------- trace
@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Knobs of the request-trace generator (all defaults are modest; the
    benchmark scales ``n_sessions`` to 10^5 in full mode)."""

    n_sessions: int = 10_000
    followups_per_session: float = 1.5   # mean follow-up turns per session
    req_rate: float = 200.0              # mean arrivals per virtual second
    arrival: str = "poisson"             # "poisson" | "bursty"
    burst_factor: float = 8.0            # in-burst rate multiplier
    burst_fraction: float = 0.1          # stationary fraction of time in burst
    burst_persistence: float = 0.98      # P(stay in burst at each arrival)
    zipf_alpha: float = 1.1              # session-popularity skew
    prompt_median: float = 96.0          # lognormal median, first-turn prompt
    prompt_sigma: float = 0.9
    followup_median: float = 24.0        # lognormal median, follow-up prompt
    followup_sigma: float = 0.6
    output_median: float = 48.0          # lognormal median, output length
    output_sigma: float = 0.7
    max_prompt: int = 2048
    max_output: int = 1024
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class Request:
    """One arrival in the trace. ``session`` is the trace-level conversation
    id (0 = first conversation opened, also the most popular under Zipf);
    ``turn`` 0 is the opening request. ``final`` marks the session's last
    trace appearance so the driver can release its slot/cache."""

    rid: int
    t: float
    session: int
    turn: int
    prompt_len: int
    output_len: int
    final: bool = False


def _lengths(rng: np.random.Generator, n: int, median: float, sigma: float,
             cap: int) -> np.ndarray:
    """Heavy-tailed token counts: lognormal with the given median, clipped
    to [1, cap]."""
    raw = rng.lognormal(mean=float(np.log(median)), sigma=sigma, size=n)
    return np.clip(raw, 1, cap).astype(np.int64)


def _arrival_times(cfg: TraceConfig, rng: np.random.Generator,
                   n: int) -> np.ndarray:
    """Cumulative arrival times for ``n`` requests at mean rate
    ``req_rate``. Bursty mode modulates a 2-state Markov chain whose
    stationary burst share is ``burst_fraction``; the base rate is scaled so
    the *long-run* mean rate still equals ``req_rate``."""
    if cfg.arrival == "poisson":
        gaps = rng.exponential(1.0 / cfg.req_rate, n)
    elif cfg.arrival == "bursty":
        bf, factor = cfg.burst_fraction, cfg.burst_factor
        # the chain's stationary burst share bf is per-*event*, so the
        # long-run mean gap is ((1-bf) + bf/factor) / base — scale base so
        # that equals 1/req_rate
        base = cfg.req_rate * ((1.0 - bf) + bf / factor)
        stay = min(max(cfg.burst_persistence, 0.0), 1.0)
        # enter-prob chosen so the chain's stationary burst share is bf
        p_enter = min(1.0, bf * (1.0 - stay) / max(1.0 - bf, 1e-12))
        u = rng.random(n)
        rates = np.empty(n)
        in_burst = False
        for i in range(n):
            in_burst = (u[i] < stay) if in_burst else (u[i] < p_enter)
            rates[i] = base * factor if in_burst else base
        gaps = rng.exponential(1.0, n) / rates
    else:
        raise ValueError(f"unknown arrival process {cfg.arrival!r}")
    return np.cumsum(gaps)


def generate_trace(cfg: TraceConfig) -> list[Request]:
    """Deterministic (seeded) request trace: ``n_sessions`` openings plus
    ``round(n_sessions * followups_per_session)`` follow-ups, interleaved
    uniformly over one arrival process. Follow-ups target sessions by Zipf
    rank over the sessions opened *so far* (rank 0 = the oldest session),
    so popularity is skewed and every targeted session already exists."""
    rng = np.random.default_rng(cfg.seed)
    n_follow = int(round(cfg.n_sessions * cfg.followups_per_session))
    n = cfg.n_sessions + n_follow
    times = _arrival_times(cfg, rng, n)

    # bounded-Zipf inverse CDF over session popularity ranks
    weights = 1.0 / np.arange(1, cfg.n_sessions + 1) ** cfg.zipf_alpha
    cdf = np.cumsum(weights)
    cdf /= cdf[-1]
    ranks = np.searchsorted(cdf, rng.random(n), side="right")

    new_flag = np.zeros(n, bool)
    new_flag[rng.choice(n, cfg.n_sessions, replace=False)] = True
    if not new_flag[0]:                       # slot 0 must open a session
        j = int(np.argmax(new_flag))
        new_flag[[0, j]] = new_flag[[j, 0]]

    prompts = _lengths(rng, n, cfg.prompt_median, cfg.prompt_sigma,
                       cfg.max_prompt)
    follows = _lengths(rng, n, cfg.followup_median, cfg.followup_sigma,
                       cfg.max_prompt)
    outputs = _lengths(rng, n, cfg.output_median, cfg.output_sigma,
                       cfg.max_output)

    reqs: list[Request] = []
    turns: dict[int, int] = {}
    opened = 0
    for i in range(n):
        if new_flag[i]:
            sess = opened
            opened += 1
            plen = int(prompts[i])
        else:
            sess = int(min(ranks[i], opened - 1))
            plen = int(follows[i])
        turn = turns.get(sess, -1) + 1
        turns[sess] = turn
        reqs.append(Request(rid=i, t=float(times[i]), session=sess, turn=turn,
                            prompt_len=plen, output_len=int(outputs[i])))
    last = {r.session: r.rid for r in reqs}
    return [dataclasses.replace(r, final=last[r.session] == r.rid)
            for r in reqs]


def trace_stats(trace: Sequence[Request]) -> dict[str, float]:
    """Summary statistics the tests sanity-check the generator against."""
    times = np.array([r.t for r in trace])
    gaps = np.diff(times)
    counts: dict[int, int] = {}
    for r in trace:
        counts[r.session] = counts.get(r.session, 0) + 1
    ordered = sorted(counts.values(), reverse=True)
    total = float(len(trace))
    mean_gap = float(gaps.mean()) if len(gaps) else 0.0
    cv = float(gaps.std() / mean_gap) if mean_gap else 0.0
    top10 = max(1, len(ordered) // 10)
    return {
        "requests": total,
        "sessions": float(len(counts)),
        "followups": total - len(counts),
        "mean_gap": mean_gap,
        "cv_gap": cv,
        "top1_share": ordered[0] / total,
        "top10pct_share": sum(ordered[:top10]) / total,
        "duration": float(times[-1]) if len(times) else 0.0,
    }


def latency_percentiles(values: Sequence[float],
                        qs: Sequence[float] = (50.0, 95.0, 99.0)
                        ) -> dict[str, float]:
    """{"p50": ..., "p95": ..., "p99": ...} over ``values`` (0.0 when
    empty); linear-interpolation percentiles, same convention as numpy."""
    if len(values) == 0:
        return {f"p{q:g}": 0.0 for q in qs}
    arr = np.asarray(values, float)
    return {f"p{q:g}": float(np.percentile(arr, q)) for q in qs}


# ----------------------------------------------------------------- predictor
class InterArrivalPredictor:
    """Per-session EMA of inter-arrival gaps, with a global-EMA prior for
    sessions seen once — the learning half of predictive warming."""

    def __init__(self, alpha: float = 0.4) -> None:
        self.alpha = alpha
        self._last: dict[int, float] = {}
        self._ema: dict[int, float] = {}
        self._global: float | None = None

    def observe(self, session: int, t: float) -> float | None:
        """Record an arrival; returns the observed gap (None on first)."""
        last = self._last.get(session)
        self._last[session] = t
        if last is None:
            return None
        gap = t - last
        ema = self._ema.get(session)
        self._ema[session] = (gap if ema is None
                              else self.alpha * gap + (1 - self.alpha) * ema)
        self._global = (gap if self._global is None
                        else 0.05 * gap + 0.95 * self._global)
        return gap

    def predict(self, session: int) -> float | None:
        """Predicted gap to the session's next arrival (global prior until a
        per-session gap has been seen; None before any gap at all)."""
        return self._ema.get(session, self._global)

    def last_seen(self, session: int) -> float | None:
        """Timestamp of the session's last observed arrival (None if never
        seen) — lets a late subscriber (e.g. a joining engine seeding warms
        for migrated sessions) anchor ``predict()`` to the real clock."""
        return self._last.get(session)


# ----------------------------------------------------------------- synthetic
@dataclasses.dataclass(frozen=True)
class CostModel:
    """Modeled service times (seconds) — stands in for the measured
    prefill/decode at trace scale. Values approximate a mid-size model on a
    single accelerator; only their *ratios* to the hierarchy's media times
    matter for routing decisions."""

    prefill_base_s: float = 0.012
    prefill_per_token_s: float = 0.00035
    decode_per_token_s: float = 0.010
    # cold-start cost of an engine joining mid-trace: loading model params
    # onto the accelerator before the first request can be served
    join_params_load_s: float = 8.0

    def prefill_seconds(self, n_tokens: int) -> float:
        return self.prefill_base_s + self.prefill_per_token_s * n_tokens

    def decode_seconds(self, n_tokens: int) -> float:
        return self.decode_per_token_s * n_tokens


class SyntheticBackend:
    """Compute-free :class:`~repro_torch.serve.engine.ServingEngine` backend.

    State is a tiny numpy pytree (a per-slot prompt fingerprint + step
    counter) and decode is a pure function of it, so park/resume and
    cross-engine failover stay **bit-identical** exactly as with the torch
    backend — while ``slot_nbytes`` reports the *modeled* KV size
    (``kv_bytes``), which is what the store's capacity accounting and
    eviction see. ``prefill`` returns modeled seconds from ``prefill_cost``
    so the router's migrate pricing works on the same scale as the
    hierarchy's media times.
    """

    def __init__(self, *, kv_bytes: float = 64 * MiB, vocab: int = 32_768,
                 width: int = 4,
                 prefill_cost: Callable[[int], float] | None = None) -> None:
        self.kv_bytes = float(kv_bytes)
        self.vocab = vocab
        self.width = width
        self.prefill_cost = prefill_cost or CostModel().prefill_seconds
        self._template: dict[str, np.ndarray] | None = None

    def init_state(self, batch: int) -> dict[str, np.ndarray]:
        return {"fp": np.zeros((batch, self.width), np.int64),
                "step": np.zeros((batch, 1), np.int32)}

    def slot_template(self) -> dict[str, np.ndarray]:
        if self._template is None:
            self._template = self.init_state(1)
        return self._template

    def slot_nbytes(self) -> float:
        return self.kv_bytes

    def prefill(self, params, prompt: list[int],
                extras) -> tuple[int, dict[str, np.ndarray], float]:
        arr = np.asarray(prompt, np.int64)
        fp = int((int(arr.sum()) * 1_000_003 + len(prompt) * 8191
                  + (int(arr[0]) + 1) * 131 + int(arr[-1]) + 1)
                 % (1 << 31))
        state = {"fp": np.full((1, self.width), fp, np.int64),
                 "step": np.full((1, 1), len(prompt), np.int32)}
        return fp % self.vocab, state, self.prefill_cost(len(prompt))

    def decode(self, params, state: dict[str, np.ndarray],
               tokens: np.ndarray) -> tuple[np.ndarray, dict[str, np.ndarray]]:
        out = (state["fp"][:, 0] * 31 + tokens[:, 0].astype(np.int64)
               + state["step"][:, 0] * 7) % self.vocab
        state["step"] = state["step"] + 1
        return out, state

    @staticmethod
    def write_slot(pooled: dict, single: dict, slot: int) -> dict:
        for k, p in pooled.items():
            s = single[k]
            if p.shape == s.shape:
                p[...] = s
            else:
                p[slot:slot + 1] = s
        return pooled

    @staticmethod
    def read_slot(pooled: dict, template: dict, slot: int) -> dict:
        out = {}
        for k, p in pooled.items():
            if p.shape == template[k].shape:
                out[k] = p.copy()
            else:
                out[k] = p[slot:slot + 1].copy()
        return out


def build_trace_stack(*, n_engines: int = 4, max_batch: int = 8,
                      kv_bytes: float = 64 * MiB, tiered: bool = True,
                      bb_slots_per_node: int = 64,
                      cost: CostModel | None = None,
                      allow_park: bool | None = None,
                      write_policy: str = "back",
                      durability: str = "none",
                      topology=None) -> tuple[Router, LocStore]:
    """A synthetic-backend serving cluster sized for trace runs.

    ``tiered=True``: per-node HBM holding exactly the live slots + a burst
    buffer holding ``bb_slots_per_node`` parked sessions, spilling to a
    2 GB/s remote PFS — the memory-pressure regime where parking pays.
    ``tiered=False``: the flat unbounded store (flat pinning baseline);
    parking is disabled unless ``allow_park`` overrides. Pass
    ``durability="flush_before_ack"`` when the trace includes node failures
    and parked sessions should survive them (a park then always leaves a
    PFS copy behind, so ``Router.fail_engine`` can re-home them).
    ``topology`` (a ``ClusterTopology``, duck-typed: the port has no
    topology module yet) makes the
    router's resume-vs-migrate pricing and failover re-homing charge real
    network paths; ``None`` or a flat topology keeps legacy pricing.
    """
    cost = cost or CostModel()
    if tiered:
        hier = StorageHierarchy(
            [TierSpec("hbm", max_batch * kv_bytes, 819e9),
             TierSpec("bb", bb_slots_per_node * kv_bytes, 8e9)],
            remote=TierSpec("remote", float("inf"), 2e9))
        store = LocStore(n_engines, hierarchy=hier, write_policy=write_policy,
                         durability=durability, topology=topology)
    else:
        store = LocStore(n_engines, topology=topology)
    cfg = ServingConfig(max_batch=max_batch, max_seq=1 << 20,
                        allow_park=tiered if allow_park is None else allow_park)
    engines = [ServingEngine(None, None, config=cfg, node=i, store=store,
                             backend=SyntheticBackend(
                                 kv_bytes=kv_bytes,
                                 prefill_cost=cost.prefill_seconds))
               for i in range(n_engines)]
    router = Router(engines, store, config=cfg)
    return router, store


# -------------------------------------------------------------------- driver
_ARRIVAL, _WARM, _FAIL, _WAKE, _JOIN, _JOIN_READY = 0, 1, 2, 3, 4, 5


@dataclasses.dataclass
class _SessState:
    sid: int | None = None        # engine session id (changes on migration)
    history: int = 0              # conversation tokens accumulated so far
    done_t: float = 0.0           # virtual time the previous answer finishes
    warm_done: float | None = None   # pending predictive warm completes at
    warm_src: str | None = None      # tier the warm promoted from
    alive: bool = False
    # follow-ups whose trace timestamp lands before the previous answer
    # finished decoding: the client hasn't seen the answer yet, so the turn
    # is deferred (FIFO per session) and woken at ``done_t`` — otherwise a
    # hot session's self-wait would drag the engine busy-clock into the
    # future and head-of-line-block every unrelated arrival behind it
    pending: collections.deque = dataclasses.field(
        default_factory=collections.deque)
    waking: bool = False          # a _WAKE event for this session is queued


@dataclasses.dataclass
class TraceReport:
    """Everything one trace run measured; ``summary()`` flattens it into the
    ``key=value`` metrics the benchmark rows and trend gate consume."""

    requests: int
    sessions: int
    sim_seconds: float
    ttft_ms: dict[str, float]          # p50/p95/p99 time-to-first-token
    queue_ms: dict[str, float]         # p50/p95/p99 queueing delay
    resume_ms: dict[str, float]        # p50/p95/p99 over resumed turns only
    counters: Mapping[str, float]

    def summary(self) -> dict[str, float]:
        out: dict[str, float] = {
            "requests": float(self.requests),
            "sessions": float(self.sessions),
            "sim_seconds": self.sim_seconds,
        }
        for label, series in (("ttft", self.ttft_ms), ("queue", self.queue_ms),
                              ("resume", self.resume_ms)):
            for q, v in series.items():
                out[f"{q}_{label}_ms"] = v
        out.update({k: float(v) for k, v in self.counters.items()})
        warms = out.get("warms", 0.0)
        hits = out.get("warm_hits", 0.0)
        out["warm_hit_rate"] = hits / warms if warms else 0.0
        out["wasted_warms"] = max(warms - hits, 0.0)
        return out


def _tokens(n: int, session: int, turn: int) -> list[int]:
    """A deterministic ``n``-token prompt for (session, turn) — content only
    matters for the synthetic fingerprint, length for the modeled cost."""
    v = (session * 2_654_435_761 + turn * 97 + 13) % 32_000 + 7
    return [v] * max(int(n), 1)


class TraceDriver:
    """Discrete-event serving driver over virtual time.

    Engines are modeled as serial admission resources (prefill and resume
    occupy the engine; decode overlaps via continuous batching), sessions
    serialize their own turns, and every service time is modeled
    (:class:`CostModel` + the hierarchy's media times) — never measured — so
    runs are deterministic and wall-clock-free.

    Per request it records **queue delay** (arrival -> service start),
    **TTFT** (arrival -> first new token: queue + prefill-or-resume + one
    decode step) and, for resumed turns, **resume latency** (media time to
    bring the parked KV slice back to the top tier, minus whatever a
    completed predictive warm already hid).
    """

    def __init__(self, router: Router, trace: Sequence[Request], *,
                 cost: CostModel | None = None, warm: bool = False,
                 predictor: InterArrivalPredictor | None = None,
                 warm_lead: float = 0.05,
                 failures: Sequence[tuple[float, int]] = (),
                 joins: Sequence[tuple[float, int]] = (),
                 engine_factory: Callable[[int], ServingEngine] | None = None,
                 drain_every: int = 256, max_history: int = 2048) -> None:
        self.router = router
        self.store = router.store
        self.hier = self.store.hierarchy
        self.trace = trace
        self.cost = cost or CostModel()
        self.warm_enabled = warm
        self.predictor = predictor or InterArrivalPredictor()
        self.warm_lead = warm_lead
        self.failures = list(failures)
        self.joins = list(joins)
        self.engine_factory = engine_factory
        self.drain_every = drain_every
        self.max_history = max_history
        any_engine = next(iter(router.engines.values()))
        # template for join-built engines — captured now so joins still work
        # in the all-engines-down window
        self._engine_template = any_engine
        self.kv = any_engine.slot_bytes()
        self._sess: dict[int, _SessState] = {}
        self._by_sid: dict[int, int] = {}
        self._busy: dict[int, float] = {}
        self._events: list[tuple[float, int, int, object]] = []
        self._seq = itertools.count()
        self._ttft: list[float] = []
        self._queue: list[float] = []
        self._resume: list[float] = []
        # (effective issue time, ttft seconds) per request, in completion
        # order — the recovery-window analysis in bench_membership needs the
        # time series, not just end-of-run percentiles
        self.samples: list[tuple[float, float]] = []
        self._t_end = 0.0
        self.counters: dict[str, float] = {
            k: 0.0 for k in ("new_sessions", "followups", "live_hits",
                             "resumes", "migrations", "lost_reprefills",
                             "finished", "force_finished",
                             "engine_full_errors", "warms", "warm_hits",
                             "resume_hidden_s", "failover_resumed",
                             "failover_lost", "failover_deferred",
                             "joins", "adopted_on_join", "rebalanced")}

    # ------------------------------------------------------------- plumbing
    def _media(self, tier: str) -> float:
        return self.hier.media_seconds(self.kv, tier)

    def _force_finish_lru(self) -> bool:
        """Flat-pinning relief valve: evict (finish) the cluster-wide LRU
        slotted session so admission can proceed — its conversation cache is
        gone; a later follow-up pays a full history re-prefill."""
        best: tuple[ServingEngine, object] | None = None
        for e in self.router.engines.values():
            for sess in e._slotted.values():
                if best is None or sess.last_active < best[1].last_active:
                    best = (e, sess)
        if best is None:
            return False
        eng, sess = best
        eng.finish(sess.sid)
        tsid = self._by_sid.get(sess.sid)
        if tsid is not None:
            st = self._sess.get(tsid)
            if st is not None and st.sid == sess.sid:
                st.alive = False
        self.counters["force_finished"] += 1
        return True

    def _admit(self, prompt: list[int]) -> tuple[ServingEngine, int]:
        while True:
            try:
                eng = self.router.engine_for()
                return eng, eng.submit(prompt)
            except RuntimeError:
                self.counters["engine_full_errors"] += 1
                if not self._force_finish_lru():
                    raise

    def _follow_up(self, sid: int, history: list[int]):
        while True:
            try:
                return self.router.follow_up(sid, history)
            except RuntimeError:
                self.counters["engine_full_errors"] += 1
                if not self._force_finish_lru():
                    raise

    def _record(self, t_eff: float, start: float, svc: float,
                resume_lat: float | None) -> None:
        """Latency is measured from ``t_eff`` — the *effective* issue time.
        A follow-up whose trace timestamp lands before the session's
        previous answer finished decoding cannot have been sent yet (the
        client is still reading); that shift is think time, not server
        latency. ``start - t_eff`` is therefore pure engine-queue wait."""
        self._queue.append(start - t_eff)
        ttft = (start - t_eff) + svc + self.cost.decode_seconds(1)
        self._ttft.append(ttft)
        self.samples.append((t_eff, ttft))
        if resume_lat is not None:
            self._resume.append(resume_lat)

    # --------------------------------------------------------------- events
    def _handle_fail(self, t: float, node: int) -> None:
        if node not in self.router.engines:
            return
        rep = self.router.fail_engine(node)
        self._busy.pop(node, None)
        self.counters["failover_resumed"] += len(rep.resumed)
        self.counters["failover_lost"] += len(rep.lost)
        self.counters["failover_deferred"] += len(rep.deferred)

    def _make_engine(self, node: int) -> ServingEngine:
        """Build the engine for a join: the caller's factory, or a clone of
        the construction-time template (same config/params/backend, fresh
        per-engine state) bound to the joining node."""
        if self.engine_factory is not None:
            return self.engine_factory(node)
        ref = self._engine_template
        return ServingEngine(ref.cfg, ref.params, config=ref.config,
                             node=node, store=self.store,
                             backend=ref.backend)

    def _handle_join(self, t: float, node: int) -> None:
        """The node announces itself: its params load starts now, but
        membership flips only when the load completes (saxml-style — a
        server is not routable until the model is resident). Joining the
        router at announce time would let the rebalance yank sessions onto
        a cold engine whose queue then head-of-line-blocks behind the whole
        params load."""
        if node in self.router.engines:
            return                       # already a live member
        heapq.heappush(self._events,
                       (t + self.cost.join_params_load_s, next(self._seq),
                        _JOIN_READY, node))

    def _handle_join_ready(self, t: float, node: int) -> None:
        if node in self.router.engines:
            return                       # already a live member
        eng = self._make_engine(node)
        rep = self.router.join_engine(node, eng)
        self.counters["joins"] += 1
        self.counters["adopted_on_join"] += len(rep.adopted)
        self.counters["rebalanced"] += len(rep.rebalanced)
        if not self.warm_enabled:
            return
        # seed the warm predictor for migrated sessions: their next arrival
        # is predicted from the pre-failure issue pattern, anchored at the
        # last observed arrival
        for sid in (*rep.adopted, *rep.rebalanced):
            session = self._by_sid.get(sid)
            if session is None:
                continue
            st = self._sess.get(session)
            if st is None or not st.alive or st.sid != sid:
                continue
            gap = self.predictor.predict(session)
            if gap is None:
                continue
            last = self.predictor.last_seen(session)
            anchor = last if last is not None else t
            tw = max(anchor + gap - self.warm_lead, t + 1e-6)
            heapq.heappush(self._events,
                           (tw, next(self._seq), _WARM, session))

    def _handle_warm(self, t: float, session: int) -> None:
        s = self._sess.get(session)
        if s is None or not s.alive or s.sid is None:
            return
        name = _cache_name(s.sid)
        if not self.store.exists(name):
            return
        node = self.store.getxattr(name, "engine")
        p = self.store.stat(name)
        src = p.tier_on(node) if p.resident_on(node) else "remote"
        if src == self.hier.top:
            return                       # already in the top tier
        if self.router.warm(s.sid):
            self.counters["warms"] += 1
            s.warm_done = t + self._media(src) + self._media(self.hier.top)
            s.warm_src = src

    def _handle_arrival(self, t: float, req: Request) -> None:
        s = self._sess.setdefault(req.session, _SessState())
        self.predictor.observe(req.session, t)   # the client's issue pattern
        if s.pending or t < s.done_t:
            # previous answer still decoding — the client hasn't seen it,
            # so this turn can't have been issued yet; defer it (FIFO)
            s.pending.append(req)
            if not s.waking:
                s.waking = True
                heapq.heappush(self._events,
                               (s.done_t, next(self._seq), _WAKE,
                                req.session))
            return
        self._process(t, req)

    def _handle_wake(self, t: float, session: int) -> None:
        s = self._sess[session]
        s.waking = False
        if not s.pending:
            return
        self._process(t, s.pending.popleft())
        if s.pending:
            s.waking = True
            heapq.heappush(self._events,
                           (s.done_t, next(self._seq), _WAKE, session))

    def _process(self, t: float, req: Request) -> None:
        s = self._sess[req.session]
        t_eff = max(t, s.done_t)
        if not s.alive:
            # opening turn — or a force-finished/failed session coming back:
            # then the whole conversation history is re-prefilled (the cost
            # flat pinning pays for every one of its evictions)
            lost = s.history > 0
            plen = (min(s.history, self.max_history) if lost
                    else req.prompt_len)
            eng, sid = self._admit(_tokens(plen, req.session, req.turn))
            self._by_sid[sid] = req.session
            s.sid = sid
            s.alive = True
            svc = self.cost.prefill_seconds(plen)
            resume_lat = None
            self.counters["lost_reprefills" if lost else "new_sessions"] += 1
        else:
            self.counters["followups"] += 1
            name = _cache_name(s.sid)
            tier_before = None
            if self.store.exists(name):
                node = self.store.getxattr(name, "engine")
                p = self.store.stat(name)
                tier_before = (p.tier_on(node) if p.resident_on(node)
                               else "remote")
            hist = _tokens(min(s.history, self.max_history),
                           req.session, req.turn)
            d = self._follow_up(s.sid, hist)
            eng = d.engine
            if d.prefilled:
                self.counters["migrations"] += 1
                self._by_sid[d.sid] = req.session
                s.sid = d.sid
                svc = self.cost.prefill_seconds(len(hist))
                resume_lat = None
            elif d.resumed:
                self.counters["resumes"] += 1
                top = self.hier.top
                src = tier_before or top
                base = self._media(src) + self._media(top)
                if (s.warm_done is not None and s.warm_src is not None
                        and tier_before == top):
                    # predictive warm promoted the slice before we arrived;
                    # pay only the in-flight remainder (if any) + top media
                    would = self._media(s.warm_src) + self._media(top)
                    resume_lat = (max(0.0, s.warm_done - t_eff)
                                  + self._media(top))
                    self.counters["warm_hits"] += 1
                    self.counters["resume_hidden_s"] += max(
                        0.0, would - resume_lat)
                else:
                    resume_lat = base
                svc = resume_lat
            else:                         # hit_live: still in its slot
                self.counters["live_hits"] += 1
                svc = 0.0
                resume_lat = None
        s.warm_done = s.warm_src = None
        start = max(t_eff, self._busy.get(eng.node, 0.0))
        self._busy[eng.node] = start + svc
        self._record(t_eff, start, svc, resume_lat)
        s.done_t = start + svc + self.cost.decode_seconds(req.output_len)
        s.history += req.prompt_len + req.output_len
        self._t_end = max(self._t_end, s.done_t)
        if req.final:
            eng.finish(s.sid)
            s.alive = False
            self.counters["finished"] += 1
        elif self.warm_enabled:
            gap = self.predictor.predict(req.session)
            if gap is not None:
                tw = max(t + gap - self.warm_lead, s.done_t, t + 1e-6)
                heapq.heappush(self._events,
                               (tw, next(self._seq), _WARM, req.session))

    # ------------------------------------------------------------------ run
    def run(self) -> TraceReport:
        self._events = [(r.t, next(self._seq), _ARRIVAL, r)
                        for r in self.trace]
        for t, node in self.failures:
            self._events.append((float(t), next(self._seq), _FAIL, int(node)))
        # joins pushed after failures: a same-instant fail-then-join cycle
        # processes the failure first (seq breaks the time tie)
        for t, node in self.joins:
            self._events.append((float(t), next(self._seq), _JOIN, int(node)))
        heapq.heapify(self._events)
        processed = 0
        while self._events:
            t, _, kind, payload = heapq.heappop(self._events)
            if kind == _ARRIVAL:
                self._handle_arrival(t, payload)
            elif kind == _WARM:
                self._handle_warm(t, payload)
            elif kind == _WAKE:
                self._handle_wake(t, payload)
            elif kind == _JOIN:
                self._handle_join(t, payload)
            elif kind == _JOIN_READY:
                self._handle_join_ready(t, payload)
            else:
                self._handle_fail(t, payload)
            processed += 1
            if self.drain_every and processed % self.drain_every == 0:
                self.store.drain_writebacks()
                # the per-transfer ledger is for small-run tests; at 10^5+
                # sessions it is pure memory growth (counters are separate)
                del self.store.transfers[:]
        self.store.drain_writebacks()
        sessions = len({r.session for r in self.trace})
        return TraceReport(
            requests=len(self.trace), sessions=sessions,
            sim_seconds=self._t_end,
            ttft_ms={k: v * 1e3
                     for k, v in latency_percentiles(self._ttft).items()},
            queue_ms={k: v * 1e3
                      for k, v in latency_percentiles(self._queue).items()},
            resume_ms={k: v * 1e3
                       for k, v in latency_percentiles(self._resume).items()},
            counters=dict(self.counters),
        )
