"""The readers of ``decode_graphed_share.chat`` and ``.serve``: the share of
the pooled decode steps that replayed the engine's captured CUDA graph,
read from the ``graphed`` and ``steps`` attributes of the ``decode.launch``
spans. Each from planted records, None without records, with spans dropped
or without the attributes, and present in a traced CPU rehearsal of its
cell's driver (where every step runs op by op, so it reads 0)."""

import time

import pytest

import harness
import run
from test_bench_harness import _cell

from repro_torch import obs

READERS = {"granite-3-2b.chat": "decode_graphed_share.chat",
           "granite-3-2b.longdoc": "decode_graphed_share.serve"}
NAMES = list(READERS.values())
MS = 1_000_000


def _reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py",
                               "bench_metric_" + name.replace(".", "_"))


def _launches(*graphed):
    """One ``decode.launch`` span a step, under its ``engine.step``; a
    ``None`` in ``graphed`` plants a span without the attributes."""
    out = []
    for i, g in enumerate(graphed):
        attrs = {} if g is None else {"graphed": g, "steps": 1}
        base = 10 * i
        out.append(obs.SpanRecord("decode.launch", 2 * i + 2, 2 * i + 1,
                                  (base + 1) * MS, (base + 5) * MS, attrs))
        out.append(obs.SpanRecord("engine.step", 2 * i + 1, None,
                                  base * MS, (base + 6) * MS,
                                  {"live": 1, "slots": 4}))
    return tuple(out)


@pytest.fixture(autouse=True)
def clean_tracer():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("graphed,share", [((1, 1, 1), 100.0),
                                           ((0, 0, 0), 0.0),
                                           ((0, 1), 50.0)])
def test_graphed_share_on_planted_steps(name, graphed, share, monkeypatch):
    """Every step replayed reads 100, every step op by op 0, the first
    step op by op and the second a replay 50."""
    monkeypatch.setattr(obs, "records",
                        lambda: obs.Records(_launches(*graphed), 0))
    assert _reader(name).read(harness.Record()) == pytest.approx(share)


@pytest.mark.parametrize("name", NAMES)
def test_graphed_share_none_without_attributes_records_or_with_drops(
        name, monkeypatch):
    """An older program's spans carry no ``graphed``: None, and no error;
    likewise no records at all, or a trace that dropped spans."""
    rec = harness.Record()
    assert _reader(name).read(rec) is None
    monkeypatch.setattr(obs, "records",
                        lambda: obs.Records(_launches(None, None), 0))
    assert _reader(name).read(rec) is None
    monkeypatch.setattr(obs, "records",
                        lambda: obs.Records(_launches(1, 1), 1))
    assert _reader(name).read(rec) is None


def test_graphed_share_none_without_the_tracer(monkeypatch):
    """A program without ``repro_torch.obs`` gives None, and no error."""
    import sys

    import repro_torch
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    monkeypatch.delattr(repro_torch, "obs")
    for name in NAMES:
        assert _reader(name).read(harness.Record()) is None


def test_graphed_share_is_listed_for_its_cell():
    for cell, name in READERS.items():
        listed = [m["name"] for m in harness.load_cell(cell).per_layer]
        assert name in listed


@pytest.mark.parametrize("cell", list(READERS))
def test_traced_rehearsal_reports_graphed_share(cell):
    """The cell's driver at smoke size on the CPU, traced: the share is in
    the result and reads 0, since a CPU engine never captures a graph."""
    c = _cell(cell)
    c.mix["trace_seconds"] = 3.0
    rec, metrics, _ = run.run_cell(c, 2**31 + 93, 3.0, True, "cpu",
                                   time.time())
    assert rec.correct, rec.checks
    assert metrics.get(READERS[cell], {}).get("value") == 0.0, metrics
