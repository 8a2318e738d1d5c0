"""The reader of ``ssd_kernel_share.hybrid``: the share of the prefills'
Mamba2-layer tokens whose chunked SSD ran in the CUDA kernels, read from the
``fused_tokens`` and ``tokens`` attributes of the ``mamba.prefill`` spans.
From planted records, None without records, with spans dropped or without
the tracer, listed for the zamba2 cell only, and present in a traced CPU
rehearsal of that cell (where the kernels never engage, so it reads 0)."""

import sys
import time

import pytest

import harness
import run
from test_bench_hybrid import _small

from repro_torch import obs

CELL = "zamba2-7b.longdoc"
NAME = "ssd_kernel_share.hybrid"
MS = 1_000_000


def _reader():
    return harness.load_module(harness.BENCH / "metrics" / f"{NAME}.py",
                               "bench_metric_" + NAME.replace(".", "_"))


def _layers(*fused):
    """One ``mamba.prefill`` span of 900 tokens a layer under one
    ``prefill``, ``fused_tokens`` 900 where ``fused`` is true, else 0."""
    out = [obs.SpanRecord("prefill", 1, None, 0, 100 * MS, {"tokens": 900})]
    for i, f in enumerate(fused):
        out.append(obs.SpanRecord(
            "mamba.prefill", i + 2, 1, (3 * i + 1) * MS, (3 * i + 3) * MS,
            {"tokens": 900, "chunks": 8, "fused_tokens": 900 if f else 0}))
    return tuple(out)


@pytest.fixture(autouse=True)
def clean_tracer():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


@pytest.mark.parametrize("fused,share", [((True, True, True), 100.0),
                                         ((False, False), 0.0),
                                         ((True, False), 50.0)])
def test_ssd_kernel_share_on_planted_layers(fused, share, monkeypatch):
    """Every layer in the kernels reads 100, none 0, one of two 50."""
    monkeypatch.setattr(obs, "records",
                        lambda: obs.Records(_layers(*fused), 0))
    assert _reader().read(harness.Record()) == pytest.approx(share)


def test_ssd_kernel_share_none_without_records_or_with_drops(monkeypatch):
    rec = harness.Record()
    assert _reader().read(rec) is None
    monkeypatch.setattr(obs, "records", lambda: obs.Records(_layers(), 0))
    assert _reader().read(rec) is None
    monkeypatch.setattr(obs, "records",
                        lambda: obs.Records(_layers(True, True), 1))
    assert _reader().read(rec) is None


def test_ssd_kernel_share_none_without_the_tracer(monkeypatch):
    """A program without ``repro_torch.obs`` gives None, and no error."""
    import repro_torch
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    monkeypatch.delattr(repro_torch, "obs")
    assert _reader().read(harness.Record()) is None


def test_ssd_kernel_share_is_listed_for_the_zamba2_cell_only():
    cells = [w["name"] for w in harness.load_json(
        harness.BENCH.parent / "BENCHMARK.json")["workloads"]]
    listing = [c for c in cells
               if NAME in [m["name"] for m in harness.load_cell(c).per_layer]]
    assert listing == [CELL]


def test_traced_rehearsal_reports_ssd_kernel_share():
    """The cell at a small size on the CPU, traced: the share is in the
    result and reads 0, since the kernels engage only on the card."""
    rec, metrics, _ = run.run_cell(_small(), 2**31 + 93, 3.0, True, "cpu",
                                   time.time())
    assert rec.correct, rec.checks
    assert metrics.get(NAME, {}).get("value") == 0.0, metrics
