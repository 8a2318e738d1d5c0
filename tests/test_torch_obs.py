"""The port's tracer (``repro_torch.obs``) and its spans on the serving path.

A cycle of submit, steps, park, a follow-up that resumes (parking a victim),
a follow-up that migrates and finish runs on the smoke granite model on the
CPU: off, it records nothing; on (``obs.enable()`` or under
``torch.profiler``), it records exactly the spans of the serving path, with
their parents and their attributes, and serves the same tokens either way.
"""

import dataclasses
from collections import Counter

import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_smoke
from repro_torch.core.locstore import LocStore, tiered_hierarchy
from repro_torch.models import init_params
from repro_torch.serve.engine import Router, ServingEngine

MAX_SEQ = 64
PA, PB, PC = [5, 6, 7, 8], [9, 8], [3, 1, 4, 1, 5]


@pytest.fixture(autouse=True)
def clean_tracer():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_smoke("granite-3-2b"), dtype="float32")
    return cfg, init_params(cfg, 0, device="cpu")


def _engines(model):
    cfg, params = model
    kv = ServingEngine(cfg, params, max_batch=2, max_seq=MAX_SEQ,
                       device="cpu").slot_bytes()
    store = LocStore(2, hierarchy=tiered_hierarchy(
        hbm_bytes=2 * kv, host_bytes=2 * kv, bb_bytes=float(1 << 30)))
    engines = [ServingEngine(cfg, params, max_batch=2, max_seq=MAX_SEQ,
                             node=i, store=store, device="cpu")
               for i in range(2)]
    return engines, Router(engines, store)


def cycle(model):
    """Submit, steps, park, a resuming follow-up on a full engine (a victim
    is parked), a migrating follow-up, finish. Returns the sids in order of
    opening (``a``, ``b``, ``c``, the migrated ``a``) and every session's
    tokens."""
    (e0, e1), router = _engines(model)
    a = e0.submit(PA)
    e0.step()
    e0.step()
    e0.park(a)
    b = e0.submit(PB)
    c = e0.submit(PC)
    e0.step()
    d = router.follow_up(a, PA)               # e0 full: parks b, resumes a
    assert d.kind == "hit_parked" and d.resumed
    e0.step()
    e0.finish(a)
    history = PA + e0.sessions[a].tokens
    m = router.follow_up(a, history)          # its cache is gone: migrate
    assert m.kind == "migrate" and m.prefilled
    m.engine.step()
    for e in (e0, e1):
        for sid in list(e.sessions):
            e.finish(sid)
    tokens = [e0.sessions[s].tokens for s in (a, b, c)] \
        + [m.engine.sessions[m.sid].tokens]
    return (a, b, c, m.sid), tokens


def _kv(rows: int) -> tuple[int, int]:
    """(bytes, live_bytes) of one slot of the smoke granite model in f32 by
    hand: k and v of (layers, 1, max_seq, kv heads, head dim), and pos."""
    cfg = get_smoke("granite-3-2b")
    row = cfg.n_layers * cfg.n_kv_heads * cfg.hd * 4
    return 2 * row * MAX_SEQ + 4, 2 * row * min(rows, MAX_SEQ) + 4


EXPECTED = Counter({"prefill": 4, "prefill.launch": 4, "engine.step": 5,
                    "decode.upload": 5, "decode.launch": 5,
                    "decode.readback": 5, "engine.park": 2,
                    "engine.resume": 1, "router.follow_up": 2})


def test_off_records_nothing_and_tokens_match_on(model):
    _, off = cycle(model)
    assert obs.records().spans == () and obs.records().dropped == 0
    obs.enable()
    _, on = cycle(model)
    assert on == off
    assert obs.records().spans


def test_on_records_the_spans_with_parents_and_attributes(model):
    obs.enable()
    (a, b, c, a2), tokens = cycle(model)
    spans = obs.records().spans
    assert Counter(r.name for r in spans) == EXPECTED
    by_id = {r.id: r for r in spans}

    def parent(r):
        return by_id[r.parent].name if r.parent is not None else None

    for r in spans:
        want = {"decode.upload": "engine.step", "decode.launch": "engine.step",
                "decode.readback": "engine.step",
                "prefill.launch": "prefill"}.get(r.name)
        if want is not None:
            assert parent(r) == want, r
        assert by_id.get(r.parent) is None or \
            by_id[r.parent].start_ns <= r.start_ns <= r.end_ns \
            <= by_id[r.parent].end_ns
    follow = [r for r in spans if r.name == "router.follow_up"]
    assert [(r.attrs["sid"], r.attrs["kind"]) for r in follow] == \
        [(a, 1), (a, 2)]
    resume, = [r for r in spans if r.name == "engine.resume"]
    assert by_id[resume.parent] is follow[0]
    parks = [r for r in spans if r.name == "engine.park"]
    assert parks[0].parent is None and by_id[parks[1].parent] is follow[0]
    prefills = [r for r in spans if r.name == "prefill"]
    assert [parent(r) for r in prefills] == [None, None, None,
                                             "router.follow_up"]
    assert by_id[prefills[3].parent] is follow[1]

    # attributes, by hand
    assert [r.attrs["tokens"] for r in prefills] == \
        [len(PA), len(PB), len(PC), len(PA) + 4]
    steps = [r for r in spans if r.name == "engine.step"]
    assert [(r.attrs["live"], r.attrs["slots"]) for r in steps] == \
        [(1, 2), (1, 2), (2, 2), (2, 2), (1, 2)]
    # a parked after its prompt and 3 tokens; the victim b after 2 tokens;
    # a resumed with the 3 tokens it was parked with
    victim = parks[1].attrs["sid"]
    assert victim == b
    assert [(p.attrs["sid"], p.attrs["bytes"], p.attrs["live_bytes"])
            for p in parks] == [(a, *_kv(len(PA) + 3)),
                                (b, *_kv(len(PB) + 2))]
    assert (resume.attrs["sid"], resume.attrs["bytes"],
            resume.attrs["live_bytes"]) == (a, *_kv(len(PA) + 3))
    assert len(tokens[3]) == 2 and a2 != a


def test_under_the_profiler_spans_are_recorded_as_ranges(model):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cycle(model)
    spans = obs.records().spans
    assert Counter(r.name for r in spans) == EXPECTED
    events = list(prof.events())
    ranges = {n: [e for e in events if e.name == n] for n in EXPECTED}
    assert {n: len(v) for n, v in ranges.items()} == dict(EXPECTED)
    aten = [e for e in events if e.name.startswith("aten::")]

    def encloses(name: str, op: str) -> bool:
        return all(any(x.name == op and x.thread == r.thread
                       and r.time_range.start <= x.time_range.start
                       and x.time_range.end <= r.time_range.end
                       for x in aten) for r in ranges[name])

    assert encloses("decode.launch", "aten::mm")
    assert encloses("prefill.launch", "aten::mm")
    # after the profile, tracing is off again
    obs.reset()
    cycle(model)
    assert obs.records().spans == ()


def _rec(name, id_, parent, start, end, **attrs):
    return obs.SpanRecord(name, id_, parent, start, end, attrs)


def test_summary_self_time_on_hand_built_spans(monkeypatch):
    spans = (
        _rec("child", 2, 1, 10, 30, bytes=5),
        _rec("child", 3, 1, 50, 60, bytes=7),
        _rec("grandchild", 4, 3, 52, 55),
        _rec("root", 1, None, 0, 100, sid=9),
        _rec("root", 5, None, 200, 240, sid=9),
    )
    monkeypatch.setattr(obs, "records", lambda: obs.Records(spans, 0))
    s = obs.summary()
    assert s["root"]["count"] == 2
    assert s["root"]["seconds"] == pytest.approx(140e-9)
    assert s["root"]["self_seconds"] == pytest.approx(110e-9)
    assert s["child"]["self_seconds"] == pytest.approx(27e-9)
    assert s["child"]["attrs"] == {"bytes": 12}
    assert s["grandchild"]["self_seconds"] == pytest.approx(3e-9)
    assert s["root"]["attrs"] == {"sid": 18}


def test_full_buffer_counts_dropped(monkeypatch):
    monkeypatch.setattr(obs, "CAPACITY", 3)
    obs.enable()
    for i in range(5):
        with obs.span("x") as sp:
            sp.set(i=i)
    r = obs.records()
    assert [s.attrs["i"] for s in r.spans] == [0, 1, 2] and r.dropped == 2
    obs.reset()
    assert obs.records() == obs.Records((), 0)


def test_off_path_is_one_shared_object():
    a, b = obs.span("engine.step"), obs.span("decode.launch")
    assert a is b and not a.on
    with a as sp:
        sp.set(live=1)
        sp.at(0, 1)
    assert obs.records().spans == ()
    obs.enable()
    on = obs.span("engine.step")
    assert on.on and on is not obs.span("engine.step")
    obs.disable()
    assert obs.span("engine.step") is a


def test_at_pins_the_callers_clock_reads():
    obs.enable()
    with obs.span("prefill") as sp:
        sp.at(100, 250)
    r, = obs.records().spans
    assert (r.start_ns, r.end_ns, r.seconds) == (100, 250, 150e-9)
