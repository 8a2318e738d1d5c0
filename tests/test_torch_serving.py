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
from repro_torch import obs
from repro_torch._bridge import from_reference, state_from_reference, to_numpy
from repro_torch.analysis.sanitize import SanitizerError
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.config import ServingConfig
from repro_torch.core.locstore import (LocStore, StorageHierarchy, TierSpec,
                                       tiered_hierarchy)
from repro_torch.core.prefetch import PrefetchEngine
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import decode_step, init_decode_state, init_params
from repro_torch.models import model as M
from repro_torch.models import prefill
from repro_torch.serve.engine import (KVSlice, Router, ServingEngine,
                                      TorchComputeBackend, _cache_name,
                                      _leaves, _read_slot, _write_slot)


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


def test_cpu_engine_steps_eagerly(setup):
    """On the CPU the pooled step is never captured: every
    ``decode.launch`` span carries ``graphed`` 0 and ``steps`` 1."""
    eng = engine(setup, max_batch=2, max_seq=64)
    eng.submit([5, 6, 7])
    obs.reset()
    obs.enable()
    try:
        for _ in range(3):
            eng.step()
        launches = [r.attrs for r in obs.records().spans
                    if r.name == "decode.launch"]
    finally:
        obs.disable()
        obs.reset()
    assert launches == [{"graphed": 0, "steps": 1}] * 3
    assert eng.backend.graph_captures == eng.backend.graph_replays == 0
    assert eng.backend._graph is None


def test_state_leaves_stay_the_same_tensors(setup):
    """Submit, steps, park, resume, finish and a submit into the freed slot
    write the pooled state in place: every leaf, ``pos`` included, is the
    tensor ``init_state`` made, and ``pos`` holds each live session's
    length."""
    store = _tiered_store(1, engine(setup, max_batch=2,
                                     max_seq=64).slot_bytes())
    eng = engine(setup, max_batch=2, max_seq=64, node=0, store=store)
    leaves = _leaves(eng.state)
    a = eng.submit([5, 6, 7])
    b = eng.submit([1, 2])
    for _ in range(2):
        eng.step()
    eng.park(a)
    eng.step()
    eng.resume(a)
    eng.step()
    eng.finish(b)
    c = eng.submit([9, 8, 7, 6])
    eng.step()
    assert all(x is y for x, y in zip(_leaves(eng.state), leaves, strict=True))
    for sid in (a, c):
        s = eng.sessions[sid]
        assert int(eng.state["pos"][s.slot]) \
            == s.prompt_len + len(s.tokens) - 1


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


# a smoke config of each family
FAMILY_ARCHS = ["granite-3-2b", "gemma3-12b", "whisper-medium",
                "llama-3.2-vision-90b", "deepseek-v3-671b", "zamba2-7b",
                "rwkv6-1.6b"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_every_family_steps_its_state_in_place(arch):
    """Each family's pooled step writes the state it was given: after
    submits, steps and a finish every leaf is the tensor ``init_state``
    made (a leaf ``decode_step`` replaced is copied back), and ``pos`` holds
    each live session's length."""
    cfg = get_smoke(arch)
    eng = ServingEngine(cfg, init_params(cfg, 0, device="cpu"), max_batch=3,
                        max_seq=64, device="cpu")
    leaves = _leaves(eng.state)
    a, b = eng.submit([5, 6, 7]), eng.submit([1, 2])
    eng.step()
    eng.finish(b)
    eng.step()
    assert all(x is y for x, y in zip(_leaves(eng.state), leaves, strict=True))
    s = eng.sessions[a]
    assert int(eng.state["pos"][s.slot]) == s.prompt_len + len(s.tokens) - 1


class _EagerBackend(TorchComputeBackend):
    """Every pooled step op by op: the control of the captured step."""

    def _graph_key(self, params, state, tokens):
        return None


# each family's smoke config, and granite-3-2b at published width cut to 4
# layers and 16 slots
CARD_CASES = FAMILY_ARCHS + ["granite-3-2b-4x16"]


def _card_case(name):
    """(cfg, max_batch, max_seq, prompt lengths, launches by design: (K1 a
    prefill, K2 a pooled step, SSD kernels a prefill)). K1 runs once per
    attention layer (whisper: each encoder layer, and each decoder layer's
    self and cross attention; zamba2: each application of the shared
    block), K2 once per attention layer with a cache (whisper: a decoder
    layer's self and cross; none under MLA), the SSD three kernels per
    Mamba2 layer; rwkv launches none."""
    if name == "granite-3-2b-4x16":
        cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=4)
        B, S, lens = 16, 2048, [700, 300, 1024, 50, 900]
    else:
        cfg, B, S, lens = get_smoke(name), 4, 128, [20, 9, 33, 14]
    L = cfg.n_layers
    k1, k2, k3 = {"encdec": (cfg.encoder_layers + 2 * L, 2 * L, 0),
                  "rwkv": (0, 0, 0),
                  "hybrid": (L // max(cfg.attn_every, 1),
                             L // max(cfg.attn_every, 1), 3 * L),
                  "moe": (L, 0 if cfg.mla is not None else L, 0)
                  }.get(cfg.family, (L, L, 0))
    return cfg, B, S, lens, (k1, k2, k3)


def _card_inputs(cfg, lens, device):
    """The card case's model (vlm gates opened: tanh(0) would cut the cross
    layers), one seeded prompt of each length, and each prompt's seeded
    frames or patches (None where the family takes neither)."""
    model = init_params(cfg, 0, device=device)
    if cfg.family == "vlm":
        with torch.no_grad():
            for xp in model.cross_blocks:
                xp["gate"].fill_(0.5)
                xp["gate_mlp"].fill_(0.5)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist() for n in lens]
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    key = M._EXTRAS.get(cfg.family)
    n_extra = cfg.n_frames if key == "frames" else cfg.n_patches
    extras = [None if key is None else
              {key: torch.randn((1, n_extra, cfg.d_model), generator=gen,
                                device=device).to(torch.bfloat16)}
              for _ in prompts]
    return model, prompts, extras


@pytest.mark.gpu
@pytest.mark.parametrize("name", CARD_CASES)
def test_captured_step_equals_eager_bit_for_bit(name, cuda):
    """One engine replays the captured pooled step, one runs it op by op,
    both driven alike: submits, 64 steps with a park, a resume, a finish
    and a submit into the freed slot. Tokens are equal at every step, the
    pooled states bit for bit at the end; each replay counts the decode
    kernel's launches it ran; a new state is captured again."""
    cfg, B, S, lens, (_, k2, _) = _card_case(name)
    model, prompts, extras = _card_inputs(cfg, lens, cuda)
    kv = TorchComputeBackend(cfg, S, device=cuda).slot_nbytes()
    engines = [ServingEngine(cfg, model, backend=b, node=0,
                             store=_tiered_store(1, kv, slots_per_node=B),
                             config=ServingConfig(max_batch=B, max_seq=S))
               for b in (TorchComputeBackend(cfg, S, device=cuda),
                         _EagerBackend(cfg, S, device=cuda))]
    sids = [[e.submit(p, x) for p, x in zip(prompts[:3], extras[:3])]
            for e in engines]
    for i in range(64):
        for e, s in zip(engines, sids):
            if i == 16:
                e.park(s[0])
            elif i == 24:
                assert e.resume(s[0])
            elif i == 32:
                e.finish(s[1])
                s.append(e.submit(prompts[3], extras[3]))
        seen = []
        for e, s in zip(engines, sids):
            n = decode_attention.launches
            out = e.step()
            seen.append(([out.get(x) for x in s],
                         decode_attention.launches - n))
        assert seen[0] == seen[1], (i, seen)
        assert seen[0][1] == k2, (i, seen)
    g, ctrl = engines
    assert g.backend.graph_captures == 1
    assert g.backend.graph_replays == g.steps - 1 == 63
    assert ctrl.backend.graph_captures == 0
    for x, y in zip(_leaves(g.state), _leaves(ctrl.state), strict=True):
        assert torch.equal(x, y)
    # a new state: one eager step, then a capture of its own
    tokens = np.zeros((B, 1), np.int32)
    b, old = g.backend, g.backend._graph.key
    state = b.init_state(B)
    b.decode(model, state, tokens)
    assert b.graph_captures == 1
    b.decode(model, state, tokens)
    assert b.graph_captures == 2 and b._graph.key != old


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_router_on_card_launches_and_resumes_as_designed(arch, cuda):
    """Two engines on one tiered store behind the Router on the card, each
    family's smoke config (gemma3's prompts of 20 and 33 tokens run past
    its 16-token window): over 16 pooled steps the kernels launch as the
    path implies (K1 and the SSD kernels a prefill, K2 a pooled step). A
    session parked, promoted to hbm by ``Router.warm`` through the
    PrefetchEngine and resumed by a follow-up without a prefill emits the
    tokens of a never-parked control of its prompt on the other engine; a
    live session's follow-up is a hit without a prefill; every session
    emits a token a step, each in the vocab."""
    cfg, B, S, lens, (k1, k2, k3) = _card_case(arch)
    model, prompts, extras = _card_inputs(cfg, lens[:3], cuda)
    kv = TorchComputeBackend(cfg, S, device=cuda).slot_nbytes()
    store = _tiered_store(2, kv, slots_per_node=B)
    engines = [ServingEngine(cfg, model, device=cuda, node=i, store=store,
                             config=ServingConfig(max_batch=B, max_seq=S))
               for i in range(2)]
    prefetch = PrefetchEngine(store)
    router = Router(engines, store, prefetch=prefetch)
    n0 = (flash_attention.launches, decode_attention.launches,
          ssd_scan.launches)
    try:
        placed = []
        for p, x in zip(prompts, extras):
            eng = router.engine_for()
            placed.append((eng, eng.submit(p, x)))
        (a_eng, a_sid), (b_eng, b_sid) = placed[:2]
        c_eng = next(e for e in engines if e is not a_eng)
        placed.append((c_eng, c_eng.submit(prompts[0], extras[0])))
        for i in range(16):
            if i == 8:
                a_eng.park(a_sid)
                assert router.warm(a_sid)
                prefetch.drain()
                assert store.stat(_cache_name(a_sid)).tier_on(
                    a_eng.node) == "hbm"
                d = router.follow_up(a_sid, a_eng.sessions[a_sid].tokens)
                assert d.kind == "hit_parked" and d.resumed \
                    and not d.prefilled, d
                d = router.follow_up(b_sid, b_eng.sessions[b_sid].tokens)
                assert d.kind == "hit_live" and not d.prefilled, d
            for e in engines:
                e.step()
        torch.cuda.synchronize()
    finally:
        prefetch.shutdown()
    prefills = sum(e.prefills for e in engines)
    steps = sum(e.steps for e in engines)
    assert prefills == 4 and steps == 32
    assert (flash_attention.launches - n0[0], decode_attention.launches
            - n0[1], ssd_scan.launches - n0[2]) \
        == (k1 * prefills, k2 * steps, k3 * prefills)
    assert a_eng.sessions[a_sid].tokens == \
        c_eng.sessions[placed[-1][1]].tokens
    for e, sid in placed:
        toks = e.sessions[sid].tokens
        assert len(toks) == 17 and all(0 <= t < cfg.vocab for t in toks)
