"""The port's serving engine and router against the reference, token for token.

Each test of tests/test_serving.py is mirrored on the port, and wherever the
test generates tokens the same prompts also run through the reference engine
on the same params (bridged from ``jax.random``), in f32: the two must emit
the same tokens and the same counters. Session ids come from a class-level
counter in each package, so sids are never compared across packages.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.core.locstore import LocStore as JaxLocStore
from repro.core.locstore import tiered_hierarchy as jax_tiered
from repro.models import init_decode_state as jax_init_state
from repro.models import init_params as jax_init_params
from repro.serve.engine import ServingEngine as JaxEngine
from repro_torch._bridge import from_reference, state_from_reference, to_numpy
from repro_torch.analysis.sanitize import SanitizerError
from repro_torch.configs import get_smoke
from repro_torch.core.locstore import (LocStore, StorageHierarchy, TierSpec,
                                       tiered_hierarchy)
from repro_torch.core.prefetch import PrefetchEngine
from repro_torch.models import decode_step, init_decode_state, prefill
from repro_torch.serve.engine import (KVSlice, Router, ServingEngine,
                                      TorchComputeBackend, _cache_name,
                                      _read_slot, _write_slot)


@pytest.fixture(scope="module")
def setup():
    """(port cfg, port model, reference cfg, reference params), f32."""
    jcfg = dataclasses.replace(jax_smoke("granite-3-2b"), dtype="float32")
    cfg = dataclasses.replace(get_smoke("granite-3-2b"), dtype="float32")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = from_reference(cfg, jax.tree.map(np.asarray, jp), "cpu")
    return cfg, model, jcfg, jp


def engine(setup, **kw):
    cfg, model, _, _ = setup
    return ServingEngine(cfg, model, device="cpu", **kw)


def jax_engine(setup, **kw):
    _, _, jcfg, jp = setup
    return JaxEngine(jcfg, jp, **kw)


def test_generate_deterministic_and_matches_reference(setup):
    out1 = engine(setup, max_batch=2, max_seq=64).generate([5, 6, 7], max_new=6)
    out2 = engine(setup, max_batch=2, max_seq=64).generate([5, 6, 7], max_new=6)
    assert out1 == out2 and len(out1) == 6
    assert out1 == jax_engine(setup, max_batch=2, max_seq=64).generate(
        [5, 6, 7], max_new=6)


def test_batched_sessions_isolated(setup):
    """Two concurrent sessions decode as if they were alone (slot masking),
    and as the reference's batched engine does."""
    a_solo = engine(setup, max_batch=1, max_seq=64).generate([1, 2, 3, 4],
                                                             max_new=5)
    outs = []
    for eng in (engine(setup, max_batch=2, max_seq=64),
                jax_engine(setup, max_batch=2, max_seq=64)):
        sa = eng.submit([1, 2, 3, 4])
        sb = eng.submit([9, 8, 7])
        for _ in range(4):
            eng.step()
        outs.append((eng.sessions[sa].tokens, eng.sessions[sb].tokens))
    assert outs[0][0][:5] == a_solo[:5]
    assert outs[0] == outs[1]


def test_write_slot_roundtrip(setup):
    cfg, model, _, _ = setup
    pooled = init_decode_state(cfg, 4, 32, device="cpu")
    toks = torch.tensor([[3, 1, 4, 1, 5]])
    _, single = prefill(cfg, model, {"tokens": toks}, 32)
    merged = _write_slot(pooled, single, 2)
    assert merged["k"] is pooled["k"]                 # written in place
    l_single, _ = decode_step(cfg, model,
                              {k: v.clone() for k, v in single.items()},
                              torch.tensor([[7]]))
    toks4 = torch.zeros((4, 1), dtype=torch.long)
    toks4[2, 0] = 7
    l_merged, _ = decode_step(cfg, model, merged, toks4)
    torch.testing.assert_close(l_merged[2], l_single[0], rtol=2e-4, atol=2e-4)


def test_read_slot_inverts_write_slot(setup):
    cfg, model, _, _ = setup
    pooled = init_decode_state(cfg, 4, 32, device="cpu")
    template = init_decode_state(cfg, 1, 32, device="meta")
    _, single = prefill(cfg, model, {"tokens": torch.tensor([[3, 1, 4]])}, 32)
    back = _read_slot(_write_slot(pooled, single, 2), template, 2)
    for key in single:
        assert torch.equal(back[key], single[key])


def test_parked_slice_is_not_changed_by_later_steps(setup):
    """The clone trap: the slot read at park time must be a copy, or the next
    in-place decode step would rewrite the parked session's cache."""
    store = _tiered_store(1, engine(setup, max_batch=2, max_seq=64).slot_bytes())
    eng = engine(setup, max_batch=2, max_seq=64, node=0, store=store)
    sid = eng.submit([5, 6, 7])
    other = eng.submit([1, 2])
    eng.step()
    eng.park(sid)
    parked = store.get(_cache_name(sid))[0].state
    snapshot = {k: v.clone() for k, v in parked.items()}
    for _ in range(3):
        eng.step()                    # `other` keeps decoding in place
    s2 = eng.submit([9, 9, 9])        # ... and a new session takes the slot
    eng.step()
    for key in snapshot:
        assert torch.equal(parked[key], snapshot[key])
    assert eng.sessions[other].slot is not None and s2 != sid


def test_slots_recycled(setup):
    eng = engine(setup, max_batch=1, max_seq=64)
    s1 = eng.submit([1, 2])
    slot1 = eng.sessions[s1].slot
    eng.finish(s1)
    s2 = eng.submit([3, 4])
    assert eng.sessions[s2].slot == slot1
    assert eng.sessions[s1].slot is None


def test_step_past_max_seq_with_a_free_slot_matches_reference(setup):
    """A freed slot keeps its position and the pooled step keeps advancing
    it past max_seq: the port drops those cache writes as JAX does, and the
    live session's tokens stay the reference's."""
    outs = []
    for mk in (engine, jax_engine):
        eng = mk(setup, max_batch=2, max_seq=16)
        short = eng.submit(list(range(1, 13)))     # finishes at pos 14
        live = eng.submit([4, 5])
        while not eng.sessions[short].done:
            eng.step()
        for _ in range(8):                          # the free slot overruns
            eng.step()
        outs.append((eng.sessions[short].tokens, eng.sessions[live].tokens,
                     eng.steps))
    assert outs[0] == outs[1]


def _tiered_store(n_nodes, kv_bytes, slots_per_node=2, jax=False):
    """hbm holds exactly the live slots; parked sessions land in bb."""
    mk, tiers = (JaxLocStore, jax_tiered) if jax else (LocStore,
                                                         tiered_hierarchy)
    return mk(n_nodes, hierarchy=tiers(
        hbm_bytes=slots_per_node * kv_bytes,
        host_bytes=slots_per_node * kv_bytes,
        bb_bytes=float(1 << 30), hbm_gbps=3.35e12, host_gbps=100e9,
        bb_gbps=8e9, remote_gbps=2e9), write_policy="back")


def test_submit_registers_true_kv_bytes(setup):
    kv = engine(setup, max_batch=2, max_seq=64).slot_bytes()
    assert kv == jax_engine(setup, max_batch=2, max_seq=64).slot_bytes()
    store = _tiered_store(1, kv)
    eng = engine(setup, max_batch=2, max_seq=64, node=0, store=store)
    sid = eng.submit([1, 2, 3])
    name = _cache_name(sid)
    assert store.getxattr(name, "size") == kv
    assert store.tier_report()["hbm"]["resident_bytes"] == kv
    assert store.stat(name).tier_on(0) == "hbm"
    sid2 = eng.submit([4, 5])
    assert store.tier_report()["hbm"]["resident_bytes"] == 2 * kv
    eng.finish(sid)
    eng.finish(sid2)
    assert store.tier_report()["hbm"]["resident_bytes"] == 0.0


def test_slot_signature_matches_bridged_reference_state(setup):
    eng = engine(setup, max_batch=2, max_seq=64)
    _, _, jcfg, _ = setup
    ref_slot = state_from_reference(
        jax.tree.map(np.asarray, jax_init_state(jcfg, 1, 64)), "cpu")
    assert eng.compatible_state(ref_slot)
    assert not eng.compatible_state(
        state_from_reference(jax.tree.map(np.asarray,
                                          jax_init_state(jcfg, 1, 32)), "cpu"))
    assert not eng.compatible_state({"pos": object()})


def test_session_lifecycle_submit_park_resume_finish(setup):
    """Park -> resume re-hydrates without a prefill and decodes bit-identically
    to a never-parked control, and to the reference's same lifecycle."""
    kv = engine(setup, max_batch=2, max_seq=64).slot_bytes()
    runs = []
    for mk, jx in ((engine, False), (jax_engine, True)):
        store = _tiered_store(1, kv, jax=jx)
        eng = mk(setup, max_batch=2, max_seq=64, node=0, store=store)
        control = mk(setup, max_batch=2, max_seq=64)
        sid = eng.submit([5, 6, 7])
        c_sid = control.submit([5, 6, 7])
        for _ in range(2):
            eng.step()
            control.step()
        eng.park(sid)
        name = _cache_name(sid)
        assert eng.sessions[sid].slot is None and eng.can_admit()
        assert store.stat(name).tier_on(0) == "bb"
        assert store.tier_report()["bb"]["resident_bytes"] == kv
        prefills_before = eng.prefills
        assert eng.resume(sid)
        assert eng.prefills == prefills_before and eng.rehydrates == 1
        assert store.stat(name).tier_on(0) == "hbm"
        for _ in range(2):
            eng.step()
            control.step()
        assert eng.sessions[sid].tokens == control.sessions[c_sid].tokens
        runs.append(list(eng.sessions[sid].tokens))
        eng.finish(sid)
        assert not store.exists(name)
        assert store.tier_report()["hbm"]["resident_bytes"] == 0.0
    assert runs[0] == runs[1]


def test_park_idle_sweep(setup):
    store = _tiered_store(1, engine(setup, max_batch=2, max_seq=64).slot_bytes())
    eng = engine(setup, max_batch=2, max_seq=64, node=0, store=store)
    s1 = eng.submit([1, 2])
    s2 = eng.submit([3, 4])
    assert eng.park_idle(max_idle=0) == [s1]
    assert eng.sessions[s1].slot is None
    assert eng.sessions[s2].slot is not None


def test_router_routes_to_cache_holder(setup):
    store = LocStore(2)
    engines = [engine(setup, max_batch=2, max_seq=64, node=i, store=store)
               for i in range(2)]
    router = Router(engines, store)
    eng = router.engine_for()
    sid = eng.submit([1, 2, 3])
    assert router.engine_for(sid).node == eng.node
    assert router.locality_hits == 1
    other = router.engine_for(99_999)
    assert router.locality_misses == 1
    assert other.can_admit()


def test_router_full_engine_locality_hit_falls_through(setup):
    kv = engine(setup, max_batch=1, max_seq=64).slot_bytes()
    store = _tiered_store(2, kv, slots_per_node=1)
    e0, e1 = [engine(setup, max_batch=1, max_seq=64, node=i, store=store)
              for i in range(2)]
    warm = e1.submit([7, 7])
    e1.finish(warm)
    router = Router([e0, e1], store, allow_park=False)
    sid = e0.submit([1, 2, 3])
    e0.park(sid)
    blocker = e0.submit([9, 9])
    assert not e0.can_admit()
    assert router.engine_for(sid) is e1
    assert router.locality_evictions == 1 and router.locality_hits == 0
    d = router.follow_up(sid, list(e0.sessions[sid].tokens))
    assert d.engine is e1 and d.sid != sid
    assert d.kind == "migrate" and d.prefilled and not d.resumed
    assert router.migrations == 1
    assert e0.sessions[sid].done
    assert e0.sessions[blocker].slot is not None


def test_router_resumes_parked_session_by_parking_victim(setup):
    kv = engine(setup, max_batch=1, max_seq=64).slot_bytes()
    store = _tiered_store(2, kv, slots_per_node=1)
    e0, e1 = [engine(setup, max_batch=1, max_seq=64, node=i, store=store)
              for i in range(2)]
    router = Router([e0, e1], store)
    sid = e0.submit([1, 2, 3])
    e0.park(sid)
    blocker = e0.submit([9, 9])
    prefills = e0.prefills
    d = router.follow_up(sid, [1, 2, 3])
    assert d.engine is e0 and d.sid == sid
    assert d.kind == "hit_parked" and d.resumed and not d.prefilled
    assert e0.sessions[sid].slot is not None
    assert e0.sessions[blocker].slot is None
    assert e0.prefills == prefills
    assert router.locality_hits == 1 and e0.resumes == 1


def test_router_pressure_prefers_fast_migrate(setup):
    kv = engine(setup, max_batch=1, max_seq=64).slot_bytes()
    store = LocStore(2, hierarchy=StorageHierarchy(
        [TierSpec("hbm", kv, 3.35e12), TierSpec("bb", float(1 << 30), 10.0)],
        remote=TierSpec("remote", float("inf"), 2e9)))
    e0, e1 = [engine(setup, max_batch=1, max_seq=64, node=i, store=store)
              for i in range(2)]
    warm = e1.submit([7, 7])
    e1.finish(warm)
    router = Router([e0, e1], store)
    sid = e0.submit([1, 2, 3])
    e0.park(sid)
    assert e0.can_admit()
    assert router.engine_for(sid) is e1
    assert router.locality_evictions == 1


def test_router_warm_promotes_parked_cache(setup):
    store = _tiered_store(1, engine(setup, max_batch=2, max_seq=64).slot_bytes())
    eng = engine(setup, max_batch=2, max_seq=64, node=0, store=store)
    prefetch = PrefetchEngine(store)
    router = Router([eng], store, prefetch=prefetch)
    sid = eng.submit([1, 2, 3])
    eng.park(sid)
    assert store.stat(_cache_name(sid)).tier_on(0) == "bb"
    assert router.warm(sid)
    prefetch.drain()
    assert store.stat(_cache_name(sid)).tier_on(0) == "hbm"
    assert router.warmups == 1
    assert not router.warm(99_999)
    prefetch.shutdown()


def test_prefetch_device_copy_only_for_values_with_tensors():
    """The device path copies every tensor of a value; a placeholder with no
    tensor gets no device copy (an explicit check, not a swallowed error)."""
    store = LocStore(1)
    store.put("parked", KVSlice({"k": torch.ones(2, 3)}, 24.0), loc=0)
    store.put("live", KVSlice(None, 24.0), loc=0)
    pf = PrefetchEngine(store, device_of=lambda node: torch.device("cpu"))
    pf.submit("parked", 0).result(timeout=10)
    pf.submit("live", 0).result(timeout=10)
    copy = pf.device_copy("parked", 0)
    assert isinstance(copy, KVSlice) and torch.equal(copy.state["k"],
                                                     torch.ones(2, 3))
    assert pf.device_copy("live", 0) is None
    pf.shutdown()


def test_sanitizer_runs_clean_and_catches_a_desync(setup):
    store = _tiered_store(1, engine(setup, max_batch=2, max_seq=64).slot_bytes())
    eng = engine(setup, max_batch=2, max_seq=64, node=0, store=store)
    eng._sanitize = True
    sid = eng.submit([1, 2, 3])
    eng.step()
    eng.park(sid)
    eng.resume(sid)
    eng._free_slots.append(eng.sessions[sid].slot)      # inject a desync
    with pytest.raises(SanitizerError, match="engine-slots"):
        eng.step()


def test_backend_default_device_is_cuda(setup):
    cfg = setup[0]
    if torch.cuda.is_available():
        assert TorchComputeBackend(cfg, 64).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchComputeBackend(cfg, 64)
    with pytest.raises(TypeError, match="backend= OR device="):
        ServingEngine(cfg, setup[1], device="cpu",
                      backend=TorchComputeBackend(cfg, 64, device="cpu"))


def test_parked_slice_bridges_to_numpy(setup):
    eng = engine(setup, max_batch=2, max_seq=32)
    sid = eng.submit([2, 3, 4])
    single = eng.backend.read_slot(eng.state, eng._slot_template(),
                                   eng.sessions[sid].slot)
    arr = {k: to_numpy(v) for k, v in single.items()}
    assert arr["k"].shape == (4, 1, 32, 2, 16) and arr["pos"].tolist() == [3]


def test_failover_resumes_bit_identical_no_prefill(setup):
    """Router.fail_engine re-homes a durably parked slice onto the surviving
    engine with no prefill; decode continues as the never-failed control
    (mirrors tests/test_failures.py on the port)."""
    kv = engine(setup, max_batch=2, max_seq=64).slot_bytes()

    def store_():
        return LocStore(2, hierarchy=tiered_hierarchy(
            hbm_bytes=2 * kv, host_bytes=2 * kv, bb_bytes=float(1 << 30)),
            write_policy="back", durability="flush_before_ack")

    ctrl = engine(setup, max_batch=2, max_seq=64, node=0, store=store_())
    sid_c = ctrl.submit([5, 6, 7])
    for _ in range(3):
        ctrl.step()
    ctrl.park(sid_c)
    ctrl.resume(sid_c)
    for _ in range(3):
        ctrl.step()
    store = store_()
    a, b = [engine(setup, max_batch=2, max_seq=64, node=i, store=store)
            for i in range(2)]
    router = Router([a, b], store)
    sid = a.submit([5, 6, 7])
    for _ in range(3):
        a.step()
    a.park(sid)
    assert store.durable(_cache_name(sid))
    rep = router.fail_engine(0)
    assert rep.resumed == (sid,) and rep.lost == ()
    assert a.prefills + b.prefills == 1 and b.sessions[sid].slot is not None
    for _ in range(3):
        b.step()
    assert b.sessions[sid].tokens[:7] == ctrl.sessions[sid_c].tokens[:7]
    assert store.getxattr(_cache_name(sid), "engine") == 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_engine_on_card_matches_reference(setup, cuda):
    """Park / resume on the card, token for token with the reference (run on
    the CPU, as here)."""
    cfg, _, jcfg, jp = setup
    model = from_reference(cfg, jax.tree.map(np.asarray, jp), cuda)
    kv = engine(setup, max_batch=2, max_seq=64).slot_bytes()
    cpu = jax.devices("cpu")[0]
    jp = jax.device_put(jp, cpu)
    runs = []
    for mk, jx in ((lambda **kw: ServingEngine(cfg, model, device=cuda, **kw),
                    False),
                   (lambda **kw: JaxEngine(jcfg, jp, **kw), True)):
        with jax.default_device(cpu):
            eng = mk(max_batch=2, max_seq=64, node=0,
                     store=_tiered_store(1, kv, jax=jx))
            sid = eng.submit([5, 6, 7])
            other = eng.submit([1, 2, 3, 4])
            for _ in range(2):
                eng.step()
            eng.park(sid)
            eng.step()
            eng.resume(sid)
            for _ in range(3):
                eng.step()
        runs.append((eng.sessions[sid].tokens, eng.sessions[other].tokens))
    assert runs[0] == runs[1]
