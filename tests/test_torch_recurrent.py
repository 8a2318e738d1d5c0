"""The port's recurrent families against the reference, in f32: hybrid
(zamba2-7b: Mamba2 layers and one shared attention block) and rwkv
(rwkv6-1.6b).

The reference's params are bridged into the port
(``repro_torch._bridge.from_reference``) and inputs come from a numpy seed.
Tolerances, from the worst errors measured here (f32 on the CPU): logits
1e-4 (worst ~7e-6); Mamba2 conv / SSM states and zamba2's caches 1e-5
(worst ~9e-6); rwkv's WKV states 1e-4 (worst ~3e-5: they sum k v^T over
every token, so they grow with the length). Only summation order differs:
the port computes every chunk's intra-chunk terms at once where the
reference scans chunk by chunk, and contracts no einsum of more than two
operands.

Mamba2 runs at S = 2 (shorter than the conv window: the tail is
left-padded), 24 (one chunk) and 300 (three chunks of 128, the last one
padded). The engine is held token for token to the reference's engine, with
park/resume and its slot bytes.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.core.locstore import LocStore as JaxLocStore
from repro.models import decode_step as jax_decode_step
from repro.models import init_decode_state as jax_init_state
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.models import param_count as jax_param_count
from repro.models import prefill as jax_prefill
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro.serve.engine import ServingEngine as JaxEngine
from repro.serve.engine import _state_signature as jax_signature
from repro_torch._bridge import (from_reference, state_from_reference,
                                 state_to_numpy, to_numpy, to_torch)
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.locstore import LocStore
from repro_torch.models import (decode_step, init_decode_state, init_params,
                                loss_fn, param_count, prefill)
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm
from repro_torch.serve.engine import (ServingEngine, TorchComputeBackend,
                                      _leaves, _read_slot, _state_signature,
                                      _write_slot)

ARCHS = ["zamba2-7b", "rwkv6-1.6b"]
LOGIT_TOL, STATE_TOL, WKV_TOL = 1e-4, 1e-5, 1e-4
S, B = 24, 2


def f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


@functools.lru_cache(maxsize=None)
def _reference(arch):
    jcfg, tcfg = f32(jax_smoke(arch)), f32(get_smoke(arch))
    return jcfg, tcfg, jax_init_params(jcfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference cfg, port cfg, reference params, port model) in f32."""
    jcfg, tcfg, jp = _reference(request.param)
    return jcfg, tcfg, jp, from_reference(tcfg, jax.tree.map(np.asarray, jp),
                                          "cpu")


def tokens(cfg, seed=0, seq=S, batch=B):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (batch, seq)) \
        .astype(np.int32)


def close(t, j, tol):
    np.testing.assert_allclose(to_numpy(t), np.asarray(j, np.float32),
                               rtol=0, atol=tol)


def close_states(tst, jst):
    """Every leaf of the two decode states, in the same (sorted) order; the
    WKV states to WKV_TOL, the rest to STATE_TOL."""
    names = sorted(tst)
    assert names == sorted(jst)
    for name in names:
        tleaves, jleaves = _leaves(tst[name]), jax.tree.leaves(jst[name])
        assert len(tleaves) == len(jleaves)
        for t, j in zip(tleaves, jleaves):
            assert tuple(t.shape) == tuple(j.shape), name
            assert t.dtype == (torch.int32 if name == "pos" else torch.float32)
            close(t, j, WKV_TOL if name == "wkv" else STATE_TOL)


def _np(x):
    return np.asarray(x, np.float32)


# ------------------------------------------------------------------ Mamba2
def _mamba_case():
    jcfg, tcfg, jp = _reference("zamba2-7b")
    p = jax.tree.map(lambda a: a[0, 0], jp["groups"]["mamba"])
    return jcfg, tcfg, p, {k: to_torch(np.asarray(a), "cpu")
                           for k, a in p.items()}


@pytest.mark.parametrize("seq", [2, 24, 300])
def test_mamba2_block_and_step_match_reference(seq):
    """The chunked pass's output and its {conv, ssm} state, then two
    recurrent steps from that state (the conv window's f32 -> activation
    dtype cast, the SSM update)."""
    jcfg, tcfg, p, tp = _mamba_case()
    rng = np.random.default_rng(seq)
    x = rng.normal(size=(B, seq, jcfg.d_model)).astype(np.float32)
    want, jst = jssm.mamba2_block(jcfg, p, jnp.asarray(x), return_state=True)
    got, tst = tssm.mamba2_block(tcfg, tp, torch.from_numpy(x),
                                 return_state=True)
    close(got, want, 1e-5)
    for k in ("conv", "ssm"):
        assert tst[k].dtype == torch.float32
        close(tst[k], jst[k], STATE_TOL)
    for _ in range(2):
        x1 = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
        want, jst = jssm.mamba2_step(jcfg, p, jst, jnp.asarray(x1))
        got, tst = tssm.mamba2_step(tcfg, tp, tst, torch.from_numpy(x1))
        close(got, want, 1e-5)
        for k in ("conv", "ssm"):
            close(tst[k], jst[k], STATE_TOL)


def test_mamba2_conv_tail_is_the_conv_inputs():
    """The decode conv state is the last K-1 rows of the conv's INPUT (x, B,
    C of the projection, before the conv and the silu), left-padded with
    zeros when the sequence is shorter."""
    _, tcfg, _, tp = _mamba_case()
    d_in, H, P, N = tssm.ssm_dims(tcfg)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 5, tcfg.d_model)).astype(np.float32))
    _, xc, Bc, Cc, _ = tssm._split_proj(tcfg, x @ tp["in_proj"])
    conv_in = torch.cat([xc, Bc, Cc], dim=-1)
    for n in (5, 2):
        _, st = tssm.mamba2_block(tcfg, tp, x[:, :n], return_state=True)
        want = conv_in[:, max(0, n - 3):n]
        assert torch.equal(st["conv"][:, 3 - want.shape[1]:], want)
        assert not st["conv"][:, :3 - want.shape[1]].any()


def test_mamba2_state_neutral_padding():
    """S = 130 pads the second chunk with 126 rows; the state after the
    padded pass equals the state after 130 recurrent steps."""
    _, tcfg, _, tp = _mamba_case()
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 130, tcfg.d_model)).astype(np.float32))
    _, st = tssm.mamba2_block(tcfg, tp, x, return_state=True)
    step = tssm.mamba2_init_state(tcfg, 1)
    for t in range(130):
        _, step = tssm.mamba2_step(tcfg, tp, step, x[:, t:t + 1])
    for k in ("conv", "ssm"):
        torch.testing.assert_close(st[k], step[k], rtol=0, atol=1e-5)


# ------------------------------------------------------------------ RWKV
def _rwkv_case():
    jcfg, tcfg, jp = _reference("rwkv6-1.6b")
    p = jax.tree.map(lambda a: a[0], jp["blocks"])
    return jcfg, tcfg, p, jax.tree.map(lambda a: to_torch(np.asarray(a),
                                                          "cpu"), p)


@pytest.mark.parametrize("carried", [False, True])
def test_time_mix_and_channel_mix_match_reference(carried):
    """Both mixes from a zero start and with a carried token-shift input and
    WKV state."""
    jcfg, tcfg, p, tp = _rwkv_case()
    rng = np.random.default_rng(3 + carried)
    H, K = trwkv.rwkv_dims(tcfg)
    x = rng.normal(size=(B, 9, jcfg.d_model)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if carried:
        last = rng.normal(size=(B, jcfg.d_model)).astype(np.float32)
        st = rng.normal(size=(B, H, K, K)).astype(np.float32)
        kw_j = dict(last_x=jnp.asarray(last), state=jnp.asarray(st))
        kw_t = dict(last_x=torch.from_numpy(last), state=torch.from_numpy(st))
    jo, jlast, jst = jrwkv.time_mix(jcfg, p["tm"], jnp.asarray(x), **kw_j)
    to, tlast, tst = trwkv.time_mix(tcfg, tp["tm"], torch.from_numpy(x), **kw_t)
    close(to, jo, 1e-5)
    close(tlast, jlast, 0)
    close(tst, jst, WKV_TOL)
    if carried:
        assert torch.equal(kw_t["state"], torch.from_numpy(st))  # not written
    jo, jlast = jrwkv.channel_mix(jcfg, p["cm"], jnp.asarray(x),
                                  last_x=kw_j.get("last_x"))
    to, tlast = trwkv.channel_mix(tcfg, tp["cm"], torch.from_numpy(x),
                                  last_x=kw_t.get("last_x"))
    close(to, jo, 1e-5)
    close(tlast, jlast, 0)


def test_group_norm_uses_population_variance():
    """The reference's ``var`` divides by n; torch's default by n - 1."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    gain = rng.normal(size=(32,)).astype(np.float32) * 0.1
    got = trwkv._group_norm(torch.from_numpy(x), torch.from_numpy(gain), 4,
                            1e-6)
    close(got, jrwkv._group_norm(jnp.asarray(x), jnp.asarray(gain), 4, 1e-6),
          1e-5)
    xh = torch.from_numpy(x).reshape(2, 3, 4, 8)
    sample = (xh - xh.mean(-1, keepdim=True)) / torch.sqrt(
        xh.var(-1, keepdim=True) + 1e-6)
    wrong = sample.reshape(2, 3, 32) * (1 + torch.from_numpy(gain))
    assert (wrong - got).abs().max() > 1e-2


# ------------------------------------------------------------------ models
def test_param_count_matches_reference(pair):
    jcfg, tcfg, _, model = pair
    assert param_count(tcfg) == jax_param_count(jcfg)
    assert sum(p.numel() for p in model.parameters()) == param_count(tcfg)


@pytest.mark.parametrize("arch,n", [("zamba2-7b", 6_751_130_832),
                                    ("rwkv6-1.6b", 1_599_670_272)])
def test_published_sizes(arch, n):
    """Parameter counts and one session's state bytes at the published
    configs (zamba2: 13 shared-attention caches at max_seq 2048, 81 conv and
    SSM states; rwkv: the same bytes at any length)."""
    cfg = get_config(arch)
    assert param_count(cfg) == n
    kv = TorchComputeBackend(cfg, 2048, device="cpu").slot_nbytes()
    assert kv == {"zamba2-7b": 537_409_028, "rwkv6-1.6b": 12_976_132}[arch]


def test_prefill_and_decode_match_reference(pair):
    """Prefill logits and every state leaf, then 4 decode steps of logits
    and state."""
    jcfg, tcfg, jp, model = pair
    toks = tokens(jcfg)
    max_seq = S + 8
    jl_, jst = jax_prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, max_seq)
    tl_, tst = prefill(tcfg, model, {"tokens": torch.from_numpy(toks).long()},
                       max_seq)
    close(tl_, jl_, LOGIT_TOL)
    close_states(tst, jst)
    rng = np.random.default_rng(5)
    for _ in range(4):
        tok = rng.integers(0, jcfg.vocab, (B, 1)).astype(np.int32)
        jl_, jst = jax_decode_step(jcfg, jp, jst, jnp.asarray(tok))
        before = _leaves(dict(tst, pos=None))
        tl_, tst = decode_step(tcfg, model, tst, torch.from_numpy(tok).long())
        close(tl_, jl_, LOGIT_TOL)
        # the caches and recurrent states are written in place
        after = _leaves(dict(tst, pos=None))
        assert all(a is b for a, b in zip(after, before) if a is not None)
    close_states(tst, jst)


def test_prefill_plus_decode_matches_reference_prefill(pair):
    """decode(prefill(S-1), tok_{S-1}) in the port == the reference's
    prefill(S): the chunked pass's exported state continues exactly."""
    jcfg, tcfg, jp, model = pair
    toks = tokens(jcfg, seed=7)
    full, _ = jax_prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, S + 8)
    _, st = prefill(tcfg, model,
                    {"tokens": torch.from_numpy(toks[:, :S - 1]).long()}, S + 8)
    step, _ = decode_step(tcfg, model, st,
                          torch.from_numpy(toks[:, S - 1:S]).long())
    close(step, full, LOGIT_TOL)


def test_rwkv_multi_token_decode_step():
    """rwkv's decode step takes S >= 1 tokens, returns the logits of each
    and advances ``pos`` by S, as the reference's."""
    jcfg, tcfg, jp = _reference("rwkv6-1.6b")
    model = from_reference(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    toks = tokens(jcfg, seed=8, seq=6)
    _, jst = jax_prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, 16)
    _, tst = prefill(tcfg, model, {"tokens": torch.from_numpy(toks).long()}, 16)
    more = tokens(jcfg, seed=9, seq=5)
    jl_, jst = jax_decode_step(jcfg, jp, jst, jnp.asarray(more))
    tl_, tst = decode_step(tcfg, model, tst, torch.from_numpy(more).long())
    assert tuple(tl_.shape) == tuple(jl_.shape) == (B, 5, 512)
    close(tl_, jl_, LOGIT_TOL)
    close_states(tst, jst)
    assert tst["pos"].tolist() == [11, 11]


def test_decode_state_bridges_both_ways(pair):
    """A reference decode state steps identically in the port, and the
    port's state goes back to numpy leaf for leaf."""
    jcfg, tcfg, jp, model = pair
    _, jst = jax_prefill(jcfg, jp, {"tokens": jnp.asarray(
        tokens(jcfg, seed=6, seq=9))}, 16)
    tst = state_from_reference(jax.tree.map(np.asarray, jst), "cpu")
    tok = np.asarray([[3], [4]], np.int32)
    jl_, jst = jax_decode_step(jcfg, jp, jst, jnp.asarray(tok))
    tl_, tst = decode_step(tcfg, model, tst, torch.from_numpy(tok).long())
    close(tl_, jl_, LOGIT_TOL)
    back = state_to_numpy(tst)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jst))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jst)):
        np.testing.assert_allclose(a, _np(b), atol=WKV_TOL)


def test_loss_matches_reference(pair):
    """Forward loss over every position (rwkv from a zero state)."""
    jcfg, tcfg, jp, model = pair
    toks = tokens(jcfg, seed=10)
    labels = np.roll(toks, -1, axis=1)
    jloss, _ = jax_loss_fn(jcfg, jp, {"tokens": jnp.asarray(toks),
                                      "labels": jnp.asarray(labels)})
    tloss, tm = loss_fn(tcfg, model, {"tokens": torch.from_numpy(toks).long(),
                                      "labels": torch.from_numpy(labels).long()})
    assert set(tm) == {"loss"}
    assert abs(float(tloss) - float(jloss)) < 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_model_runs_and_keeps_f32_states(arch):
    """In bf16 (the served dtype) the mixed bf16 / f32 products go through
    (torch refuses mixed dtypes where JAX promotes), the recurrent states stay
    f32 and a decode step agrees with a longer prefill within bf16's
    rounding."""
    cfg = get_smoke(arch)
    model = init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(tokens(cfg, seed=11, seq=20)).long()
    _, st = prefill(cfg, model, {"tokens": toks[:, :19]}, 32)
    assert all(t.dtype in (torch.int32, torch.float32, torch.bfloat16)
               for t in _leaves(st))
    recurrent = {"zamba2-7b": ("groups", "tail"),
                 "rwkv6-1.6b": ("tm_x", "cm_x", "wkv")}[arch]
    assert all(t.dtype == torch.float32 for k in recurrent
               for t in _leaves(st[k]))
    step, _ = decode_step(cfg, model, st, toks[:, 19:20])
    full, _ = prefill(cfg, model, {"tokens": toks}, 32)
    assert torch.isfinite(step).all()
    a = torch.log_softmax(step[:, -1].float(), -1)
    b = torch.log_softmax(full[:, -1].float(), -1)
    assert float((a - b).abs().max()) < 0.15


# ------------------------------------------------------------------ serving
MAX_SEQ = 40


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    jcfg, tcfg, jp = _reference(request.param)
    return jcfg, tcfg, jp, from_reference(tcfg, jax.tree.map(np.asarray, jp),
                                          "cpu")


def _lifecycle(eng):
    """Two sessions, a park, the slot reused by a third, a resume; returns
    both sessions' tokens."""
    sid = eng.submit([5, 6, 7])
    other = eng.submit([1, 2, 3, 4])
    for _ in range(2):
        eng.step()
    eng.park(sid)
    third = eng.submit([4, 4])
    eng.step()
    eng.finish(third)
    eng.resume(sid)
    for _ in range(3):
        eng.step()
    return eng.sessions[sid].tokens, eng.sessions[other].tokens


def test_engine_matches_reference_engine(served):
    """The port's engine and the reference's, token for token through a
    park, a slot reuse and a resume, with the same slot bytes."""
    jcfg, tcfg, jp, model = served
    eng = ServingEngine(tcfg, model, device="cpu", max_batch=2,
                        max_seq=MAX_SEQ, node=0, store=LocStore(1))
    ref = JaxEngine(jcfg, jp, max_batch=2, max_seq=MAX_SEQ, node=0,
                    store=JaxLocStore(1))
    assert _lifecycle(eng) == _lifecycle(ref)
    assert eng.slot_bytes() == ref.slot_bytes()
    assert eng.compatible_state(state_from_reference(
        jax.tree.map(np.asarray, jax_init_state(jcfg, 1, MAX_SEQ)), "cpu"))


def test_park_resume_bit_identical(served):
    """A parked slice (recurrent states and, for zamba2, the shared block's
    caches) resumes into a slot and decodes bit-identically to a
    never-parked control; the parked slice is a copy the next steps do not
    touch."""
    _, tcfg, _, model = served

    def mk(**kw):
        return ServingEngine(tcfg, model, device="cpu", max_batch=2,
                             max_seq=MAX_SEQ, **kw)

    store = LocStore(1)
    eng, control = mk(node=0, store=store), mk()
    sid, cid = eng.submit([3, 1, 4, 1, 5]), control.submit([3, 1, 4, 1, 5])
    for _ in range(2):
        eng.step()
        control.step()
    eng.park(sid)
    parked, _ = store.get(f"kvcache:session:{sid}")
    snapshot = [t.clone() for t in _leaves(parked.state)]
    assert store.getxattr(f"kvcache:session:{sid}", "size") == eng.slot_bytes()
    blocker = eng.submit([2, 7])
    for _ in range(2):
        eng.step()
    assert all(torch.equal(a, b) for a, b in zip(_leaves(parked.state),
                                                 snapshot))
    eng.finish(blocker)
    prefills = eng.prefills
    assert eng.resume(sid) and eng.prefills == prefills
    for _ in range(3):
        eng.step()
        control.step()
    assert eng.sessions[sid].tokens == control.sessions[cid].tokens


def test_slot_state_round_trip_and_signature(served):
    """The batch axis of every recurrent leaf is axis 1 (after the stacked
    layers): a prefilled batch-1 state written into slot 1 of a pooled
    state reads back bit for bit, leaves the other slots alone, and the
    slot signature's leaves are the reference's."""
    jcfg, tcfg, jp, model = served
    _, single = prefill(tcfg, model, {"tokens": torch.tensor([[1, 2, 3]])},
                        MAX_SEQ)
    pooled = init_decode_state(tcfg, 3, MAX_SEQ, device="cpu")
    _write_slot(pooled, single, 1)
    back = _read_slot(pooled, init_decode_state(tcfg, 1, MAX_SEQ,
                                                device="meta"), 1)
    for a, b, p in zip(_leaves(back), _leaves(single), _leaves(pooled)):
        assert torch.equal(a, b)
        if p.ndim > 1:
            assert not p.narrow(1, 0, 1).any() and not p.narrow(1, 2, 1).any()
    # the leaves' (shape, dtype) in the reference's order (its tree part is
    # a jax PyTreeDef, the port's a nested tuple)
    assert _state_signature(single)[1] == jax_signature(
        jax_init_state(jcfg, 1, MAX_SEQ))[1]


# ------------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda")


# zamba2-7b's shared attention: hd 112 (3584 / 32), MHA
HD112_FLASH = [(1, 300, 300, 4, 4, 112, True, 0, 0),
               (2, 130, 130, 32, 32, 112, True, 0, 0)]
HD112_DECODE = [(4, 700, 32, 32, 112, [700, 1, 193, 450])]


@pytest.mark.gpu
@pytest.mark.parametrize("case", HD112_FLASH)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_kernel_at_hd112_on_card(cuda, case, dtype):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    B, Sq, Sk, Hq, Hkv, hd, causal, win, off = case
    g = torch.Generator(device=cuda).manual_seed(3)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dt)
               for s in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd)))
    kw = dict(causal=causal, window=win, q_offset=off)
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    _close_on_card(out, ref.flash_attention_ref(q, k, v, **kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("case", HD112_DECODE)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decode_kernel_at_hd112_on_card(cuda, case, dtype):
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    B, S_, Hq, Hkv, hd, lens = case
    g = torch.Generator(device=cuda).manual_seed(4)
    dt = getattr(torch, dtype)
    q = torch.randn((B, Hq, hd), generator=g, device=cuda).to(dt)
    kc, vc = (torch.randn((B, S_, Hkv, hd), generator=g, device=cuda).to(dt)
              for _ in range(2))
    lt = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out = decode_attention(q, kc, vc, lt)
    torch.cuda.synchronize()
    _close_on_card(out, ref.decode_attention_ref(q, kc, vc, lt), dtype)


def _close_on_card(out, want, dtype):
    """As tests/test_torch_kernels.py: f32 2e-5; bf16 0.05 and every element
    within 4e-3 + 2^-6 |plain|."""
    diff = (out.float() - want.float()).abs()
    assert float(diff.max()) < {"float32": 2e-5, "bfloat16": 0.05}[dtype]
    if dtype == "bfloat16":
        bound = 4e-3 + 2.0 ** -6 * want.float().abs()
        assert bool((diff <= bound).all()), float((diff / bound).max())


@pytest.mark.gpu
def test_zamba2_on_card_matches_cpu(cuda):
    """The zamba2 smoke model on the card (shared attention through the
    hand-written kernels, f32, no TF32) against the same model on the CPU:
    prefill, 4 decode steps, every state leaf; K1 and K2 launch once per
    application point."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    jcfg, tcfg, jp = _reference("zamba2-7b")
    cpu = from_reference(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    card = from_reference(tcfg, jax.tree.map(np.asarray, jp), cuda)
    G = tcfg.n_layers // tcfg.attn_every
    toks = torch.from_numpy(tokens(tcfg, seed=12)).long()
    n1, n2 = flash_attention.launches, decode_attention.launches
    a, sa = prefill(tcfg, cpu, {"tokens": toks}, S + 4)
    b, sb = prefill(tcfg, card, {"tokens": toks.to(cuda)}, S + 4)
    assert flash_attention.launches == n1 + G
    close(b, to_numpy(a), LOGIT_TOL)
    for step in range(4):
        tok = torch.full((B, 1), step + 3, dtype=torch.long)
        a, sa = decode_step(tcfg, cpu, sa, tok)
        b, sb = decode_step(tcfg, card, sb, tok.to(cuda))
        close(b, to_numpy(a), LOGIT_TOL)
    assert decode_attention.launches == n2 + 4 * G
    for x, y in zip(_leaves(sb), _leaves(sa)):
        close(x, to_numpy(y), STATE_TOL)
