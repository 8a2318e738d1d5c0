"""The benchmark's traffic: one general generator that every mix file feeds.

``TraceConfig``, ``Request``, ``_lengths``, ``_arrival_times`` and
``generate_trace`` are copies of ``repro_torch.serve.traffic`` (seeded Zipf
sessions, Poisson or bursty arrivals, lognormal lengths; numpy only), kept
here so that the yardstick cannot move with the program;
``bench/tests/test_bench_traffic.py`` holds them equal to the program's.

On top of the copied generator (all deterministic in the seed):

* :func:`fixed_work` gives every seed the same multiset of prompt lengths,
  output lengths and arrival gaps, each value replaced by the quantile of
  its rank, so a seed changes the order of the work and not its amount;
* :func:`space_turns` sends a session's next turn no earlier than its
  previous answer could have been read (its output at a nominal pace plus a
  think time): a client does not ask again before it has its answer;
* :func:`chat_schedule` cuts the mix's one trace (drawn from its
  ``trace_seed``, so every run serves the same turns) into the history
  before the measured window (sessions opened and still open at its start, each with the length
  of its conversation so far) and the turns that arrive inside it;
* :func:`closed_jobs` draws the fixed job list of a closed-loop mix.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np


# ------------------------------------------- copied from the program's traffic
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


# ------------------------------------------------------- the benchmark's own
def _quantile_ranks(values: np.ndarray, quantile) -> np.ndarray:
    """Each value replaced by ``quantile((rank + 0.5) / n)`` of its rank
    (ties broken by position): the multiset depends on ``n`` alone."""
    n = len(values)
    out = np.empty(n)
    order = np.argsort(values, kind="stable")
    out[order] = quantile((np.arange(n) + 0.5) / n)
    return out


def _lognormal_q(median: float, sigma: float, cap: int):
    from statistics import NormalDist
    z = NormalDist()

    def q(u):
        raw = median * np.exp(sigma * np.array([z.inv_cdf(float(x))
                                                for x in u]))
        return np.clip(raw, 1, cap).astype(np.int64)
    return q


def fixed_work(trace: Sequence[Request], cfg: TraceConfig) -> list[Request]:
    """The trace with every seed's work made equal: opening prompts,
    follow-up prompts, outputs and arrival gaps each replaced by the
    quantile of their rank within their kind (lognormal lengths, Poisson
    gaps). The seed keeps deciding which request is long and which gap is
    short; the sizes and the total time are the same for every seed."""
    reqs = list(trace)
    opening = np.array([r.turn == 0 for r in reqs])
    plen = np.array([r.prompt_len for r in reqs], float)
    out = np.array([r.output_len for r in reqs], float)
    new_plen = np.empty(len(reqs), np.int64)
    new_plen[opening] = _quantile_ranks(
        plen[opening], _lognormal_q(cfg.prompt_median, cfg.prompt_sigma,
                                    cfg.max_prompt))
    new_plen[~opening] = _quantile_ranks(
        plen[~opening], _lognormal_q(cfg.followup_median, cfg.followup_sigma,
                                     cfg.max_prompt))
    new_out = _quantile_ranks(out, _lognormal_q(
        cfg.output_median, cfg.output_sigma, cfg.max_output)).astype(np.int64)
    times = np.array([r.t for r in reqs])
    gaps = np.diff(np.concatenate([[0.0], times]))
    if cfg.arrival == "poisson":
        gaps = _quantile_ranks(gaps, lambda u: -np.log1p(-u) / cfg.req_rate)
    new_t = np.cumsum(gaps)
    return [dataclasses.replace(r, t=float(new_t[i]),
                                prompt_len=int(new_plen[i]),
                                output_len=int(new_out[i]))
            for i, r in enumerate(reqs)]


def space_turns(trace: Sequence[Request], pace_tokens_per_s: float,
                think_s: float) -> list[Request]:
    """Each turn of a session sent no earlier than the previous one's
    arrival plus its output read at ``pace_tokens_per_s`` plus ``think_s``:
    the Zipf-hot sessions, which the generator would send a turn every few
    seconds, keep their order but wait for their answers. Returned in time
    order."""
    ready: dict[int, float] = {}
    out = []
    for r in sorted(trace, key=lambda r: (r.session, r.turn)):
        t = max(r.t, ready.get(r.session, -math.inf))
        ready[r.session] = t + r.output_len / pace_tokens_per_s + think_s
        out.append(dataclasses.replace(r, t=t))
    return sorted(out, key=lambda r: (r.t, r.rid))


def trace_config(mix: dict, seed: int, n_sessions: int) -> TraceConfig:
    """The generator's config from a mix file's ``trace`` block."""
    keys = {f.name for f in dataclasses.fields(TraceConfig)}
    t = {k: v for k, v in mix["trace"].items() if k in keys}
    return TraceConfig(**t, n_sessions=n_sessions, seed=seed)


def fits(history: int, prompt: int, output: int, max_seq: int) -> bool:
    """Whether a turn of ``prompt`` and ``output`` tokens fits after a
    conversation of ``history`` tokens in a slot of ``max_seq``; a turn that
    does not opens a new conversation with its own prompt alone."""
    return history + prompt + output + 2 <= max_seq


def conversation_lengths(trace: Sequence[Request], max_seq: int
                         ) -> dict[int, int]:
    """Each session's conversation length after the trace's turns: its
    prompts and outputs since it last opened (a turn that would pass
    ``max_seq`` opens it anew, :func:`fits`)."""
    hist: dict[int, int] = {}
    for r in sorted(trace, key=lambda r: (r.t, r.rid)):
        h = hist.get(r.session, 0) if r.turn > 0 else 0
        if not fits(h, r.prompt_len, r.output_len, max_seq):
            h = 0
        hist[r.session] = h + r.prompt_len + r.output_len
    return hist


@dataclasses.dataclass
class ChatSchedule:
    """``population``: (session, conversation length) of every session
    opened before the window and still open at its start, the least
    recently active first;
    ``window``: the turns whose arrival lies in ``[0, seconds)`` (times
    relative to the window's start) and the later turns up to ``tail_s``
    past it, which keep the load on while the window's turns finish."""

    population: list[tuple[int, int]]
    window: list[Request]
    seconds: float


def chat_schedule(mix: dict, seconds: float) -> ChatSchedule:
    """The chat mix's schedule: the copied generator from the mix's
    ``trace_seed``, fixed work, spaced turns; the first ``history_s``
    seconds of trace time are history (set-up prefills the conversations
    still open at its end and parks them), the next ``seconds`` the
    measured window. The run's own seed draws the prompts' tokens, not the
    schedule: which conversations are open, and which follow-ups find no
    cache, moved the tail from seed to seed far more than the host did."""
    tr = mix["trace"]
    rate = float(tr["req_rate"])
    span = mix["history_s"] + seconds + mix["tail_s"]
    per_session = 1.0 + float(tr["followups_per_session"])
    n_sessions = int(math.ceil(1.5 * rate * span / per_session)) + 8
    cfg = trace_config(mix, int(mix["trace_seed"]), n_sessions)
    trace = space_turns(fixed_work(generate_trace(cfg), cfg),
                        mix["pace_tokens_per_s"], mix["think_s"])
    t0 = float(mix["history_s"])
    before = [r for r in trace if r.t < t0]
    finished = {r.session for r in before if r.final}
    length = conversation_lengths(before, mix["engine"]["max_seq"])
    last = {r.session: r.t for r in before}
    population = [(s, length[s]) for s in sorted(length, key=last.get)
                  if s not in finished]
    window = [dataclasses.replace(r, t=r.t - t0) for r in trace
              if t0 <= r.t < t0 + seconds + mix["tail_s"]]
    return ChatSchedule(population, window, seconds)


def closed_jobs(mix: dict, seed: int, n: int) -> list[tuple[int, int]]:
    """``n`` (prompt length, output length) jobs of a closed-loop mix, the
    same multiset for every seed (lognormal quantiles), in an order drawn
    from the seed."""
    tr = mix["trace"]
    u = (np.arange(n) + 0.5) / n
    prompts = _lognormal_q(tr["prompt_median"], tr["prompt_sigma"],
                           tr["max_prompt"])(u)
    outputs = _lognormal_q(tr["output_median"], tr["output_sigma"],
                           tr["max_output"])(u)
    rng = np.random.default_rng(seed)
    return list(zip(prompts[rng.permutation(n)].tolist(),
                    outputs[rng.permutation(n)].tolist()))


def session_tokens(seed: int, key: int, n: int, vocab: int) -> list[int]:
    """``n`` token ids for one prompt, drawn from (seed, key): the same
    seed and key give the same prompt."""
    rng = np.random.default_rng([seed, key])
    return rng.integers(0, vocab, size=n).tolist()
