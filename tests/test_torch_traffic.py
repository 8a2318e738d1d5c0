"""The port's trace generator and trace driver against the reference.

``repro_torch.serve.traffic`` is numpy only, so one seed must give the same
trace, the same ``TraceReport`` and the same counters in both packages —
compared exactly, field by field, over the scenarios of tests/test_traffic.py
(pressure, deterministic rerun, predictive warming, flat pinning, failover
mid-trace, tier usage, bytes promoted). A real-model run closes the file:
the driver admits through ``TorchComputeBackend`` engines (real prefills on
the CPU here) and keeps the synthetic run's report shape.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.serve import traffic as jt
from repro.serve.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_smoke
from repro_torch.core.locstore import LocStore, tiered_hierarchy
from repro_torch.models import init_params
from repro_torch.serve import traffic as tt
from repro_torch.serve.engine import Router, ServingEngine


def _trace_tuples(trace):
    return [dataclasses.astuple(r) for r in trace]


@pytest.mark.parametrize("kw", [
    dict(n_sessions=300, seed=11, arrival="bursty"),
    dict(n_sessions=400, followups_per_session=2.0, seed=3),
    dict(n_sessions=500, req_rate=500.0, zipf_alpha=1.2, seed=5,
         prompt_sigma=1.0, max_prompt=512, max_output=64),
])
def test_generate_trace_identical(kw):
    mine = tt.generate_trace(tt.TraceConfig(**kw))
    ref = jt.generate_trace(jt.TraceConfig(**kw))
    assert _trace_tuples(mine) == _trace_tuples(ref)
    assert tt.trace_stats(mine) == jt.trace_stats(ref)


def test_percentiles_and_predictor_match_reference():
    vals = list(np.random.default_rng(0).lognormal(size=333))
    assert tt.latency_percentiles(vals) == jt.latency_percentiles(vals)
    assert tt.latency_percentiles([]) == jt.latency_percentiles([])
    mine, ref = tt.InterArrivalPredictor(0.3), jt.InterArrivalPredictor(0.3)
    rng = np.random.default_rng(1)
    for t in np.cumsum(rng.exponential(1.0, 50)):
        s = int(rng.integers(0, 5))
        assert mine.observe(s, float(t)) == ref.observe(s, float(t))
        assert mine.predict(s) == ref.predict(s)
        assert mine.last_seen(s) == ref.last_seen(s)


def test_synthetic_backend_park_resume_bit_identical():
    """The port's engine drives the synthetic backend as the reference's
    does: park/resume reproduces the uninterrupted stream, the slot holds the
    modeled bytes, and both packages emit the same tokens."""
    kv = 4 * tt.MiB
    streams = []
    for mod, Engine in ((tt, ServingEngine), (jt, JaxEngine)):
        router, store = mod.build_trace_stack(n_engines=1, max_batch=2,
                                              kv_bytes=kv, bb_slots_per_node=4)
        (eng,) = router.engines.values()
        control = Engine(None, None, node=0,
                         backend=mod.SyntheticBackend(kv_bytes=kv))
        sid, cid = eng.submit([5, 6, 7]), control.submit([5, 6, 7])
        for _ in range(3):
            eng.step()
            control.step()
        eng.park(sid)
        assert store.tier_used(0, "bb") >= kv
        eng.resume(sid)
        for _ in range(3):
            eng.step()
            control.step()
        assert eng.sessions[sid].tokens == control.sessions[cid].tokens
        assert eng.slot_bytes() == kv
        streams.append(eng.sessions[sid].tokens)
    assert streams[0] == streams[1]


def test_route_decision_kinds_match_reference():
    kinds = []
    for mod in (tt, jt):
        router, _ = mod.build_trace_stack(n_engines=2, max_batch=2)
        e0 = router.engines[0]
        seq = [router.route(None).kind]
        sid = e0.submit([1, 2, 3])
        d = router.follow_up(sid, [1, 2, 3])
        seq.append((d.kind, d.resumed, d.prefilled))
        e0.park(sid)
        d = router.follow_up(sid, [1, 2, 3])
        seq.append((d.kind, d.resumed, d.prefilled))
        kinds.append(seq)
    assert kinds[0] == kinds[1]
    assert kinds[0][1:] == [("hit_live", False, False),
                            ("hit_parked", True, False)]


# --------------------------------------------------------------------- driver
def _run(mod, n_sessions=250, *, warm=False, tiered=True, failures=(),
         seed=21, bb=8, engines=2, batch=4, followups=2.0, rate=60.0,
         durability="none"):
    trace = mod.generate_trace(mod.TraceConfig(
        n_sessions=n_sessions, followups_per_session=followups,
        req_rate=rate, arrival="bursty", seed=seed))
    router, store = mod.build_trace_stack(n_engines=engines, max_batch=batch,
                                          kv_bytes=8 * mod.MiB, tiered=tiered,
                                          bb_slots_per_node=bb,
                                          durability=durability)
    drv = mod.TraceDriver(router, trace, warm=warm, failures=failures)
    return drv.run(), router, store, drv


def _engine_counters(router):
    return {n: (e.prefills, e.steps, e.parks, e.resumes, e.rehydrates)
            for n, e in sorted(router.engines.items())}


_ROUTER_COUNTERS = ("locality_hits", "locality_misses", "locality_evictions",
                    "migrations", "warmups", "failover_resumes",
                    "failover_lost", "failover_deferred")


def _both(**kw):
    """Run one scenario in both packages and hold everything equal."""
    mine = _run(tt, **kw)
    ref = _run(jt, **kw)
    (rep, router, store, drv), (jrep, jrouter, jstore, jdrv) = mine, ref
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    assert rep.summary() == jrep.summary()
    assert drv.counters == jdrv.counters
    assert drv.samples == jdrv.samples
    assert _engine_counters(router) == _engine_counters(jrouter)
    assert {k: getattr(router, k) for k in _ROUTER_COUNTERS} == \
        {k: getattr(jrouter, k) for k in _ROUTER_COUNTERS}
    assert store.movement_report() == jstore.movement_report()
    return mine


def test_driver_lifecycle_under_pressure_matches_reference():
    rep, router, _, _ = _both()
    s = rep.summary()
    assert s["requests"] == 750 and s["sessions"] == 250
    assert s["engine_full_errors"] == 0 and s["resumes"] > 0
    assert sum(e.parks for e in router.engines.values()) > 0
    assert (s["new_sessions"] + s["lost_reprefills"] + s["followups"]
            == rep.requests)


def test_driver_deterministic_rerun():
    a = _run(tt, warm=True)[0]
    b = _run(tt, warm=True)[0]
    assert a.summary() == b.summary()


def test_predictive_warming_matches_reference():
    cold = _both(warm=False, seed=33)[0].summary()
    warm = _both(warm=True, seed=33)[0].summary()
    assert warm["warms"] > 0 and warm["warm_hits"] > 0
    assert warm["resume_hidden_s"] > 0
    assert warm["p99_resume_ms"] <= cold["p99_resume_ms"] * 1.05


def test_flat_pinning_matches_reference():
    tiered = _both(seed=44, warm=True)[0].summary()
    flat = _both(seed=44, tiered=False)[0].summary()
    assert flat["force_finished"] > 0 and flat["lost_reprefills"] > 0
    assert tiered["p99_ttft_ms"] < flat["p99_ttft_ms"]


def test_driver_failover_mid_trace_matches_reference():
    trace = tt.generate_trace(tt.TraceConfig(
        n_sessions=200, followups_per_session=2.0, req_rate=50.0, seed=8))
    t_mid = trace[len(trace) // 2].t
    rep, router, _, _ = _both(n_sessions=200, failures=((t_mid, 0),), seed=8,
                              rate=50.0, durability="flush_before_ack")
    s = rep.summary()
    assert 0 not in router.engines
    assert s["failover_resumed"] > 0 and s["engine_full_errors"] == 0
    assert rep.requests == 600


def test_tier_usage_matches_reference():
    _, router, store, _ = _both(n_sessions=120, seed=13)
    for node in router.engines:
        rep = store.tier_report(node=node)
        for tier in ("hbm", "bb"):
            assert store.tier_used(node, tier) == rep[tier]["resident_bytes"]


def test_bytes_promoted_matches_reference():
    _, _, store, _ = _both(n_sessions=120, warm=True, seed=13)
    mv = store.movement_report()
    assert mv["bytes_promoted"] > 0 and mv["promotions"] > 0
    store.reset_accounting()
    assert store.movement_report()["bytes_promoted"] == 0.0


# --------------------------------------------------------- real-model driver
def test_driver_admits_through_the_torch_backend():
    """A short trace through two granite smoke engines on the CPU: every
    admission and migration is a real prefill (counted by the engines), the
    report keeps the synthetic run's shape, and tokens stay in the vocab.
    The driver's prompts hold token ids up to 32,006, so the smoke model
    takes a vocab that reaches them (granite's own 49,155 does)."""
    cfg = dataclasses.replace(get_smoke("granite-3-2b"), dtype="float32",
                              vocab=32_768)
    model = init_params(cfg, 0, device="cpu")
    max_seq = 96
    store = LocStore(2, hierarchy=tiered_hierarchy())
    engines = [ServingEngine(cfg, model, max_batch=2, max_seq=max_seq, node=i,
                             store=store, device="cpu") for i in range(2)]
    router = Router(engines, store)
    trace = tt.generate_trace(tt.TraceConfig(
        n_sessions=6, followups_per_session=1.0, req_rate=20.0, seed=4,
        prompt_median=12, followup_median=4, output_median=6, max_prompt=24,
        max_output=12))
    drv = tt.TraceDriver(router, trace, warm=True, max_history=max_seq)
    with torch.no_grad():
        rep = drv.run()
    s = rep.summary()
    assert s["requests"] == len(trace) and s["engine_full_errors"] == 0
    prefills = sum(e.prefills for e in engines)
    assert prefills == s["new_sessions"] + s["lost_reprefills"] \
        + s["migrations"] > 0
    assert s["p99_ttft_ms"] >= s["p50_ttft_ms"] > 0
    for e in engines:
        for sess in e.sessions.values():
            assert all(0 <= t < cfg.vocab for t in sess.tokens)
