"""The readers of the program's spans (``bench/work/spans.py`` and the nine
metrics that read ``repro_torch.obs``): each from hand-built records, None
without records or with spans dropped, and every one present in a traced
CPU rehearsal of its cell's driver."""

import time

import pytest

import harness
import run
from test_bench_harness import _cell

from repro_torch import obs

READERS = {
    "granite-3-2b.chat": ["step_launch_ms.chat", "step_wait_ms.chat",
                          "step_live_share.chat", "route_ms.chat",
                          "kv_move_ms.chat", "kv_copy_live_share.chat"],
    "granite-3-2b.longdoc": ["step_launch_ms.serve", "step_wait_ms.serve",
                             "prefill_launch_share.serve"],
}
ALL = [m for ms in READERS.values() for m in ms]
MS = 1_000_000


def _reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py",
                               "bench_metric_" + name.replace(".", "_"))


def _r(name, id_, parent, start_ms, end_ms, **attrs):
    return obs.SpanRecord(name, id_, parent, int(start_ms * MS),
                          int(end_ms * MS), attrs)


# two pooled steps on a 4-slot engine, a follow-up that parks a victim and
# resumes its session, a migrate that prefills, and a prefill on its own
SPANS = (
    _r("decode.upload", 2, 1, 0, 1),
    _r("decode.launch", 3, 1, 1, 41),
    _r("decode.readback", 4, 1, 41, 44),
    _r("engine.step", 1, None, 0, 45, live=1, slots=4),
    _r("decode.upload", 6, 5, 50, 52),
    _r("decode.launch", 7, 5, 52, 112),
    _r("decode.readback", 8, 5, 112, 114),
    _r("engine.step", 5, None, 50, 115, live=3, slots=4),
    _r("engine.park", 10, 9, 120, 122, sid=1, bytes=100, live_bytes=30),
    _r("engine.resume", 11, 9, 123, 127, sid=2, bytes=100, live_bytes=50),
    _r("router.follow_up", 9, None, 119, 130, sid=2, kind=1),
    _r("prefill.launch", 14, 13, 141, 146),
    _r("prefill", 13, 12, 140, 160, tokens=900),
    _r("router.follow_up", 12, None, 138, 161, sid=3, kind=2),
    _r("prefill.launch", 16, 15, 170, 172),
    _r("prefill", 15, None, 170, 180, tokens=300),
)
EXPECTED = {
    "step_launch_ms.chat": 50.0, "step_launch_ms.serve": 50.0,
    "step_wait_ms.chat": 4.0, "step_wait_ms.serve": 4.0,
    "step_live_share.chat": 50.0,
    "route_ms.chat": (11 - 6 + 23 - 20) / 2,
    "kv_move_ms.chat": 3.0,
    "kv_copy_live_share.chat": 40.0,
    "prefill_launch_share.serve": 100.0 * 7 / 30,
}


@pytest.fixture(autouse=True)
def clean_tracer():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


@pytest.mark.parametrize("name", ALL)
def test_reader_on_hand_built_records(name, monkeypatch):
    monkeypatch.setattr(obs, "records", lambda: obs.Records(SPANS, 0))
    assert _reader(name).read(harness.Record()) == \
        pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", ALL)
def test_reader_none_without_records_or_with_drops(name, monkeypatch):
    rec = harness.Record()
    assert _reader(name).read(rec) is None
    monkeypatch.setattr(obs, "records", lambda: obs.Records(SPANS, 1))
    assert _reader(name).read(rec) is None


def test_reader_none_without_the_tracer(monkeypatch):
    """A program without ``repro_torch.obs`` (an older checkout) gives
    None, and no error."""
    import sys

    import repro_torch
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    monkeypatch.delattr(repro_torch, "obs")
    for name in ALL:
        assert _reader(name).read(harness.Record()) is None


def test_every_new_metric_is_listed_for_its_cell():
    for cell, names in READERS.items():
        listed = [m["name"] for m in harness.load_cell(cell).per_layer]
        assert set(names) <= set(listed)


@pytest.mark.parametrize("name", list(READERS))
def test_traced_rehearsal_reports_every_span_metric(name):
    """The cell's driver at smoke size on the CPU, traced over its whole
    window: every span metric of the cell is in the result; a run without
    the trace records no span."""
    c = _cell(name)
    c.mix["trace_seconds"] = 3.0
    rec, metrics, breakdown = run.run_cell(c, 2**31 + 91, 3.0, True, "cpu",
                                           time.time())
    assert rec.correct, rec.checks
    for m in READERS[name]:
        assert metrics.get(m, {}).get("value") is not None, (m, metrics)
    assert {"idle_gaps", "device_ops"} <= set(breakdown)
    obs.reset()
    rec, metrics, _ = run.run_cell(c, 2**31 + 91, 3.0, False, "cpu",
                                   time.time())
    assert rec.correct and obs.records().spans == ()
