"""The benchmark's copy of the program's trace generator stays equal to it,
and the benchmark's own shaping keeps every seed's work the same."""

import collections
import dataclasses

import numpy as np
import pytest

import traffic as T
from repro_torch.serve import traffic as P


@pytest.mark.parametrize("kw", [
    {}, {"arrival": "bursty", "req_rate": 3.0, "n_sessions": 300},
    {"n_sessions": 500, "followups_per_session": 3.0, "zipf_alpha": 1.1,
     "prompt_median": 1024, "max_prompt": 3072, "seed": 2**31 + 17},
])
def test_generate_trace_equals_program(kw):
    kw = {"n_sessions": 200, **kw}
    a = T.generate_trace(T.TraceConfig(**kw))
    b = P.generate_trace(P.TraceConfig(**kw))
    assert [dataclasses.astuple(r) for r in a] == \
        [dataclasses.astuple(r) for r in b]


@pytest.mark.parametrize("seed", [0, 5, 2**33 + 1])
def test_helpers_equal_program(seed):
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    assert np.array_equal(T._lengths(r1, 1000, 64.0, 0.8, 500),
                          P._lengths(r2, 1000, 64.0, 0.8, 500))
    for arrival in ("poisson", "bursty"):
        c1 = T.TraceConfig(arrival=arrival, req_rate=4.0)
        c2 = P.TraceConfig(arrival=arrival, req_rate=4.0)
        assert np.array_equal(T._arrival_times(c1, r1, 500),
                              P._arrival_times(c2, r2, 500))


def _mix():
    return {"trace": {"req_rate": 2.0, "arrival": "poisson",
                      "followups_per_session": 3.0, "zipf_alpha": 1.1,
                      "prompt_median": 256, "prompt_sigma": 0.9,
                      "max_prompt": 1024, "followup_median": 32,
                      "followup_sigma": 0.6, "output_median": 32,
                      "output_sigma": 0.7, "max_output": 128},
            "engine": {"max_seq": 2048}, "trace_seed": 2**31 + 11,
            "history_s": 60, "tail_s": 5, "pace_tokens_per_s": 6.0,
            "think_s": 2.0, "trace_seconds": 2.0}


def test_fixed_work_same_multiset_for_every_seed():
    cfg = T.TraceConfig(n_sessions=120, followups_per_session=3.0,
                        req_rate=2.0, prompt_median=256, max_prompt=1024)
    sets = []
    for seed in (1, 2, 2**31 + 3):
        tr = T.fixed_work(T.generate_trace(dataclasses.replace(cfg,
                                                               seed=seed)),
                          cfg)
        sets.append((sorted(r.output_len for r in tr),
                     sorted(r.prompt_len for r in tr if r.turn == 0),
                     round(tr[-1].t, 9)))
    assert sets[0] == sets[1] == sets[2]


def test_space_turns_waits_for_answers():
    cfg = T.TraceConfig(n_sessions=80, followups_per_session=3.0,
                        req_rate=5.0)
    tr = T.space_turns(T.generate_trace(cfg), 6.0, 2.0)
    by = collections.defaultdict(list)
    for r in tr:
        by[r.session].append(r)
    for turns in by.values():
        for a, b in zip(turns, turns[1:]):
            assert b.turn == a.turn + 1
            assert b.t >= a.t + a.output_len / 6.0 + 2.0 - 1e-9
    assert [r.t for r in tr] == sorted(r.t for r in tr)


def test_chat_schedule_is_deterministic_and_consistent():
    a = T.chat_schedule(_mix(), 20.0)
    b = T.chat_schedule(_mix(), 20.0)
    assert a.population == b.population and a.window == b.window
    c = T.chat_schedule(dict(_mix(), trace_seed=5), 20.0)
    assert c.window != a.window
    opened = {s for s, _ in a.population}
    for r in a.window:
        assert 0 <= r.t < 25.0
        assert r.turn == 0 or r.session in opened or any(
            q.session == r.session and q.turn == 0 for q in a.window)


def test_conversation_lengths_follow_the_turns():
    R = T.Request
    tr = [R(0, 0.0, 1, 0, 100, 20), R(1, 1.0, 2, 0, 50, 10),
          R(2, 2.0, 1, 1, 30, 40), R(3, 3.0, 2, 1, 960, 60),
          R(4, 4.0, 1, 2, 10, 5)]
    # session 2's second turn would pass 1024: it opens anew
    assert T.conversation_lengths(tr, 1024) == {1: 205, 2: 1020}
    assert T.fits(960, 60, 2, 1024) and not T.fits(960, 60, 3, 1024)


def test_population_carries_each_conversation_so_far():
    """Set-up holds each open conversation at its length so far (prompts
    and answers), never past the slot."""
    mix = _mix()
    sched = T.chat_schedule(mix, 20.0)
    lengths = [n for _, n in sched.population]
    assert lengths and max(lengths) <= mix["engine"]["max_seq"] - 2
    assert np.median(lengths) > mix["trace"]["prompt_median"] \
        + mix["trace"]["output_median"]


def test_closed_jobs_same_multiset_other_order():
    mix = {"trace": {"prompt_median": 3072, "prompt_sigma": 0.2,
                     "max_prompt": 3840, "output_median": 32,
                     "output_sigma": 0.5, "max_output": 128}}
    a, b = T.closed_jobs(mix, 1, 256), T.closed_jobs(mix, 2, 256)
    assert a != b
    assert sorted(p for p, _ in a) == sorted(p for p, _ in b)
    assert sorted(o for _, o in a) == sorted(o for _, o in b)
    assert max(p + o for p, o in a) <= 3840 + 128
