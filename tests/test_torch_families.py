"""The port's encdec, vlm and moe families against the reference, in f32.

Models: whisper-medium, llama-3.2-vision-90b, deepseek-v3-671b and
arctic-480b smoke configs, with the reference's params bridged into the port
(``repro_torch._bridge.from_reference``) and inputs from a numpy seed.
Logits agree to 1e-4 and every cache leaf to 1e-5 (the f32 bounds of
tests/test_torch_model.py: summation order and the attention spelling are all
that differ).

Two traps are set on purpose:

* the vlm gates start at zero (``tanh(0) = 0``) and the engine's default
  patches are zeros, either of which makes a wrong cross attention pass every
  check — so the reference's params get non-zero gates before bridging and
  every vlm input has seeded patches;
* patches arrive in bf16 whatever ``cfg.dtype`` (the engine hands them over
  so), and an f32 model promotes them at its projections as JAX does.

Serving (whisper, vision, deepseek): the port's engine and router, token for
token against the reference model run greedily on the same prompts and
extras. The reference's engine serves vlm and deepseek in f32 and is compared
directly; its encdec prefill refuses the engine's bf16 frames in an f32 model
(ROADMAP.md Queue 3), so whisper's oracle is the reference model fed the same
frames in f32, which is what the port's encoder computes.
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
from repro.models import layers as jl
from repro.models import loss_fn as jax_loss_fn
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models import param_count as jax_param_count
from repro.models import prefill as jax_prefill
from repro.serve.engine import Router as JaxRouter
from repro.serve.engine import ServingEngine as JaxEngine
from repro.serve.engine import _write_slot as jax_write_slot
from repro_torch._bridge import (from_reference, state_from_reference,
                                 state_to_numpy, to_numpy, to_torch)
from repro_torch.configs import get_smoke
from repro_torch.core.locstore import LocStore
from repro_torch.models import (decode_step, init_decode_state, loss_fn,
                                param_count, prefill)
from repro_torch.models import layers as tl
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.serve.engine import (Router, ServingEngine, _leaves,
                                      _read_slot, _write_slot)

ARCHS = ["whisper-medium", "llama-3.2-vision-90b", "deepseek-v3-671b",
         "arctic-480b"]
SERVE_ARCHS = ARCHS[:3]
LOGIT_TOL, STATE_TOL = 1e-4, 1e-5
S, B = 24, 2
EXTRA = {"encdec": "frames", "vlm": "patches"}


def f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def nonzero_gates(jp, cfg):
    """The vlm gates are initialised to zero; parity needs them open."""
    if cfg.family == "vlm":
        G = cfg.n_layers // cfg.cross_every
        cb = jp["cross_blocks"]
        cb["gate"] = jnp.linspace(0.4, 0.9, G, dtype=jnp.float32)
        cb["gate_mlp"] = jnp.linspace(-0.7, 0.5, G, dtype=jnp.float32)
    return jp


@functools.lru_cache(maxsize=None)
def _reference(arch):
    jcfg, tcfg = f32(jax_smoke(arch)), f32(get_smoke(arch))
    jp = nonzero_gates(jax_init_params(jcfg, jax.random.PRNGKey(0)), jcfg)
    return jcfg, tcfg, jp


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference cfg, port cfg, reference params, port model) in f32."""
    jcfg, tcfg, jp = _reference(request.param)
    model = from_reference(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, model


def extra_input(cfg, batch, seed):
    """Seeded frames (f32: the reference's encoder takes its model's dtype)
    or patches (bf16: the engine's dtype) as (reference array, port tensor),
    or (None, None) for a family without a frontend."""
    key = EXTRA.get(cfg.family)
    if key is None:
        return None, None
    n = cfg.n_frames if key == "frames" else cfg.n_patches
    x = np.random.default_rng(seed).normal(size=(batch, n, cfg.d_model))
    j = jnp.asarray(x, jnp.float32 if key == "frames" else jnp.bfloat16)
    return j, to_torch(np.asarray(j), "cpu")


def batches(cfg, toks, seed=0):
    labels = np.roll(toks, -1, axis=1)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long()}
    je, te = extra_input(cfg, toks.shape[0], seed)
    if je is not None:
        jb[EXTRA[cfg.family]], tb[EXTRA[cfg.family]] = je, te
    return jb, tb


def tokens(cfg, seed=0, seq=S, batch=B):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (batch, seq)) \
        .astype(np.int32)


def close(t, j, tol):
    np.testing.assert_allclose(to_numpy(t), np.asarray(j, np.float32),
                               rtol=0, atol=tol)


def close_states(tst, jst, tol=STATE_TOL):
    """Every leaf of the two decode states, in the same (sorted) order."""
    tleaves, jleaves = _leaves(tst), jax.tree.leaves(jst)
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        assert tuple(t.shape) == tuple(j.shape)
        close(t, j, tol)


# ------------------------------------------------------------------ models
def test_param_count_matches_reference(pair):
    jcfg, tcfg, _, model = pair
    assert param_count(tcfg) == jax_param_count(jcfg)
    assert sum(p.numel() for p in model.parameters()) == param_count(tcfg)


def test_prefill_and_decode_match_reference(pair):
    """Prefill logits and every cache leaf, then 8 decode steps of logits and
    state (self and cross caches, MLA latents, moe cache pairs)."""
    jcfg, tcfg, jp, model = pair
    jb, tb = batches(jcfg, tokens(jcfg))
    max_seq = S + 12
    jl_, jst = jax_prefill(jcfg, jp, jb, max_seq)
    tl_, tst = prefill(tcfg, model, tb, max_seq)
    close(tl_, jl_, LOGIT_TOL)
    close_states(tst, jst)
    if jcfg.family == "vlm":               # bf16 patches, f32 cross caches
        assert tb["patches"].dtype == torch.bfloat16
        assert tst["xk"].dtype == torch.float32
    rng = np.random.default_rng(5)
    for _ in range(8):
        tok = rng.integers(0, jcfg.vocab, (B, 1)).astype(np.int32)
        jl_, jst = jax_decode_step(jcfg, jp, jst, jnp.asarray(tok))
        tl_, tst = decode_step(tcfg, model, tst, torch.from_numpy(tok).long())
        close(tl_, jl_, LOGIT_TOL)
    close_states(tst, jst)


def test_decode_state_bridges_both_ways(pair):
    """A reference decode state steps identically in the port, and the
    port's state goes back to numpy leaf for leaf."""
    jcfg, tcfg, jp, model = pair
    jb, _ = batches(jcfg, tokens(jcfg, seed=6, seq=9), seed=6)
    _, jst = jax_prefill(jcfg, jp, jb, 16)
    tst = state_from_reference(jax.tree.map(np.asarray, jst), "cpu")
    tok = np.asarray([[3], [4]], np.int32)
    jl_, jst = jax_decode_step(jcfg, jp, jst, jnp.asarray(tok))
    tl_, tst = decode_step(tcfg, model, tst, torch.from_numpy(tok).long())
    close(tl_, jl_, LOGIT_TOL)
    back = state_to_numpy(tst)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jst))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jst)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=STATE_TOL)


def test_prefill_plus_decode_matches_reference_prefill(pair):
    """decode(prefill(S-1), tok_{S-1}) in the port == the reference's
    prefill(S): the cache invariant across packages (the reference has no
    full-sequence forward that returns logits for these families). MoE runs
    with a capacity that drops nothing, as tests/test_models.py does: drops
    are counted over the whole prefill batch and never at decode, so only
    the cache path is under test here."""
    jcfg, tcfg, jp, model = pair
    if jcfg.is_moe:
        jcfg = dataclasses.replace(jcfg, capacity_factor=8.0)
        tcfg = dataclasses.replace(tcfg, capacity_factor=8.0)
        model = from_reference(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    toks = tokens(jcfg, seed=7)
    jb, tb = batches(jcfg, toks, seed=7)
    full, _ = jax_prefill(jcfg, jp, jb, S + 8)
    tb = dict(tb, tokens=tb["tokens"][:, :S - 1])
    _, st = prefill(tcfg, model, tb, S + 8)
    step, _ = decode_step(tcfg, model, st,
                          torch.from_numpy(toks[:, S - 1:S]).long())
    close(step, full, LOGIT_TOL)


def test_loss_matches_reference(pair):
    """Forward loss and metrics (moe: xent + router aux + 0.3 x MTP)."""
    jcfg, tcfg, jp, model = pair
    jb, tb = batches(jcfg, tokens(jcfg, seed=8))
    jloss, jm = jax_loss_fn(jcfg, jp, jb)
    tloss, tm = loss_fn(tcfg, model, tb)
    assert set(tm) == set(jm)
    for k in jm:
        assert abs(float(tm[k]) - float(jm[k])) < 1e-5, k
    if jcfg.mtp_depth:
        assert float(tm["mtp"]) > 0


# ------------------------------------------------------- traps, per module
def test_cross_attention_block_matches_reference():
    """Non-causal, Sq != Sk, Sk not a multiple of any tile, GQA: the
    flash-attention op against the reference's XLA spelling."""
    rng = np.random.default_rng(9)
    dims = jl.AttnDims(32, 4, 2, 8)
    p = {k: rng.normal(size=s).astype(np.float32) * 0.3 for k, s in
         (("wq", (32, 32)), ("wk", (32, 16)), ("wv", (32, 16)),
          ("wo", (32, 32)))}
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    src = rng.normal(size=(2, 37, 32)).astype(np.float32)
    want = jl.cross_attention_block({k: jnp.asarray(a) for k, a in p.items()},
                                    jnp.asarray(x), jnp.asarray(src), dims)
    got = tl.cross_attention_block(
        {k: torch.from_numpy(a) for k, a in p.items()}, torch.from_numpy(x),
        torch.from_numpy(src), tl.AttnDims(32, 4, 2, 8))
    close(got, want, 1e-5)


def test_non_gated_mlp_is_tanh_gelu():
    """whisper's MLP is jax.nn.gelu's default, the tanh approximation."""
    rng = np.random.default_rng(10)
    p = {"w1": rng.normal(size=(16, 32)).astype(np.float32),
         "w2": rng.normal(size=(32, 16)).astype(np.float32)}
    x = rng.normal(size=(3, 16)).astype(np.float32)
    got = tl.mlp_block({k: torch.from_numpy(a) for k, a in p.items()},
                       torch.from_numpy(x))
    close(got, jl.mlp_block({k: jnp.asarray(a) for k, a in p.items()},
                            jnp.asarray(x)), 1e-5)
    w = {k: torch.from_numpy(a) for k, a in p.items()}
    exact = torch.nn.functional.gelu(torch.from_numpy(x) @ w["w1"]) @ w["w2"]
    assert (got - exact).abs().max() > 1e-4


def test_zero_gates_or_zero_patches_hide_cross_attention():
    """Why the parity tests open the gates and seed the patches: with the
    reference's zero gates the logits do not depend on the patches at all,
    and with open gates they do."""
    jcfg, tcfg, jp = _reference("llama-3.2-vision-90b")
    toks = torch.from_numpy(tokens(jcfg, seed=11)).long()
    _, seeded = extra_input(jcfg, B, 11)
    zeros = torch.zeros_like(seeded)
    closed = jax.tree.map(np.asarray, jp)
    closed["cross_blocks"]["gate"] = np.zeros_like(closed["cross_blocks"]["gate"])
    closed["cross_blocks"]["gate_mlp"] = np.zeros_like(
        closed["cross_blocks"]["gate_mlp"])
    for params, differs in ((closed, False),
                            (jax.tree.map(np.asarray, jp), True)):
        model = from_reference(tcfg, params, "cpu")
        a = model(toks, seeded)
        b = model(toks, zeros)
        assert bool((a - b).abs().max() > 1e-3) == differs


def test_reference_encoder_refuses_frames_of_another_dtype():
    """The reference's encdec prefill fails on bf16 frames in an f32 model
    (its encoder scan's carry turns f32 at the first residual), which is
    what its engine hands over; the port takes the frames in the model's
    dtype: bf16 frames give the answer of their exact f32 values."""
    jcfg, tcfg, jp = _reference("whisper-medium")
    toks = tokens(jcfg, seed=12)
    frames = jnp.asarray(np.random.default_rng(12).normal(
        size=(B, jcfg.n_frames, jcfg.d_model)), jnp.bfloat16)
    with pytest.raises(TypeError, match="carry"):
        jax_prefill(jcfg, jp, {"tokens": jnp.asarray(toks), "frames": frames},
                    S)
    model = from_reference(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    t = torch.from_numpy(toks).long()
    bf = to_torch(np.asarray(frames), "cpu")
    a, _ = prefill(tcfg, model, {"tokens": t, "frames": bf}, S)
    b, _ = prefill(tcfg, model, {"tokens": t, "frames": bf.float()}, S)
    assert torch.equal(a, b)
    want, _ = jax_prefill(jcfg, jp, {"tokens": jnp.asarray(toks),
                                     "frames": frames.astype(jnp.float32)}, S)
    close(a, want, LOGIT_TOL)


def test_mla_prefill_and_decode_match_reference():
    """MLA's prefill runs through the flash op with V zero-padded from 16 to
    24 columns and the scale passed explicitly; decode is the absorbed form
    against the latent cache."""
    jcfg, tcfg, jp = _reference("deepseek-v3-671b")
    p = jax.tree.map(lambda a: a[0], jp["moe_blocks"]["attn"])
    tp = {k: to_torch(np.asarray(a), "cpu") for k, a in p.items()}
    x = np.random.default_rng(13).normal(size=(B, 11, jcfg.d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (B, 11)).copy()
    want = jmla.mla_attention(jcfg, p, jnp.asarray(x), jnp.asarray(pos))
    got = tmla.mla_attention(tcfg, tp, torch.from_numpy(x),
                             torch.from_numpy(pos))
    close(got, want, 1e-5)
    jcache = jmla.mla_prefill_cache(jcfg, p, jnp.asarray(x), jnp.asarray(pos),
                                    16)
    tcache = tmla.mla_prefill_cache(tcfg, tp, torch.from_numpy(x),
                                    torch.from_numpy(pos), 16)
    for k in ("c_kv", "k_rope"):
        close(tcache[k], jcache[k], 1e-5)
    step = x[:, :1] * 0.5
    at = np.asarray([11, 15], np.int32)    # the second row writes the last slot
    jo, jnew = jmla.mla_decode(jcfg, p, jnp.asarray(step), jcache,
                               jnp.asarray(at))
    to, tnew = tmla.mla_decode(tcfg, tp, torch.from_numpy(step), tcache,
                               torch.from_numpy(at))
    close(to, jo, 1e-5)
    for k in ("c_kv", "k_rope"):
        close(tnew[k], jnew[k], 1e-5)
        assert tnew[k] is tcache[k]                    # written in place


def _moe_case(arch):
    jcfg, tcfg, jp = _reference(arch)
    p = jax.tree.map(lambda a: a[0], jp["moe_blocks"]["moe"])
    tp = jax.tree.map(lambda a: to_torch(np.asarray(a), "cpu"), p)
    return jcfg, tcfg, p, tp


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "arctic-480b"])
def test_moe_capacity_drop_matches_reference(arch):
    """Tokens that all lean towards the same experts overflow the capacity:
    the dropped (token, slot) pairs add zeros into the sink and weigh zero in
    the combine, as in the reference."""
    jcfg, tcfg, p, tp = _moe_case(arch)
    rng = np.random.default_rng(14)
    base = rng.normal(size=(1, 1, jcfg.d_model))
    x = (base + 0.05 * rng.normal(size=(2, 40, jcfg.d_model))) \
        .astype(np.float32)
    T = x.shape[0] * x.shape[1]
    C = tmoe._capacity(tcfg, T)
    assert C == jmoe._capacity(jcfg, T)
    logits = x.reshape(T, -1) @ np.asarray(p["router"])
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :jcfg.experts_per_token]
    assert np.bincount(top.ravel(), minlength=jcfg.n_experts).max() > C
    want, jaux = jmoe._moe_ffn_global(jcfg, p, jnp.asarray(x))
    got, aux = tmoe.moe_ffn(tcfg, tp, torch.from_numpy(x))
    close(got, want, 1e-5)
    assert abs(float(aux) - float(jaux)) < 1e-7


def test_moe_ties_take_the_lower_experts_first():
    """jax.lax.top_k breaks ties by the lower index. Experts 0, 1 and 2 get
    the same router column, far above the others, so every token ties three
    ways for its two slots: both packages must route to experts 0 and 1
    (expert 2 has other weights, so a wrong pick changes the output)."""
    jcfg, tcfg, p, _ = _moe_case("arctic-480b")
    p = dict(p)
    r = np.asarray(p["router"]).copy()
    r[:, :3] = 0.0
    r[0, :3] = 5.0
    p["router"] = jnp.asarray(r)
    tp = jax.tree.map(lambda a: to_torch(np.asarray(a), "cpu"), p)
    x = np.random.default_rng(15).normal(size=(1, 12, jcfg.d_model)) \
        .astype(np.float32)
    x[..., 0] += 3.0
    want, _ = jmoe._moe_ffn_global(jcfg, p, jnp.asarray(x))
    got, _ = tmoe.moe_ffn(tcfg, tp, torch.from_numpy(x))
    close(got, want, 1e-5)
    swapped = dict(tp, w1=tp["w1"][[2, 1, 0] + list(range(3, jcfg.n_experts))])
    other, _ = tmoe.moe_ffn(tcfg, swapped, torch.from_numpy(x))
    assert (other - got).abs().max() > 1e-3     # expert 2 would differ


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "arctic-480b"])
def test_long_repetitive_prompt_drops_tokens_and_matches(arch, monkeypatch):
    """A 64-token prompt of one repeated token: every MoE layer sees nearly
    equal rows, its experts overflow (checked), and the model still agrees
    with the reference."""
    jcfg, tcfg, jp = _reference(arch)
    model = from_reference(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    seen = []
    inner = tmoe._moe_ffn_global

    def spy(cfg, p, x):
        T = x.shape[0] * x.shape[1]
        probs = torch.softmax(x.reshape(T, -1).float() @ p["router"], -1)
        top = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
        counts = torch.bincount(top[:, :cfg.experts_per_token].reshape(-1),
                                minlength=cfg.n_experts)
        seen.append(int(counts.max()) > tmoe._capacity(cfg, T))
        return inner(cfg, p, x)

    monkeypatch.setattr(tmoe, "_moe_ffn_global", spy)
    toks = np.full((B, 64), 17, np.int32)
    jl_, jst = jax_prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, 72)
    tl_, tst = prefill(tcfg, model, {"tokens": torch.from_numpy(toks).long()},
                       72)
    assert seen and all(seen)
    close(tl_, jl_, LOGIT_TOL)
    close_states(tst, jst)


def test_write_slot_finds_the_vlm_batch_axis():
    """The vlm self cache is (G, S_per, B, S, Hkv, hd): its batch axis is at
    index 2. Slot writes and reads find it (the first axis where the pooled
    and batch-1 shapes differ), as the reference's do."""
    jcfg, tcfg, jp = _reference("llama-3.2-vision-90b")
    model = from_reference(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    jb, tb = batches(jcfg, tokens(jcfg, seed=16, seq=5, batch=1), seed=16)
    jpooled = jax_init_state(jcfg, 3, 16)
    _, jsingle = jax_prefill(jcfg, jp, jb, 16)
    want = jax_write_slot(jpooled, jsingle, 1)
    pooled = init_decode_state(tcfg, 3, 16, device="cpu")
    _, single = prefill(tcfg, model, tb, 16)
    got = _write_slot(pooled, single, 1)
    close_states(got, want)
    back = _read_slot(got, init_decode_state(tcfg, 1, 16, device="meta"), 1)
    for a, b in zip(_leaves(back), _leaves(single)):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ serving
MAX_SEQ = 40


@functools.lru_cache(maxsize=None)
def _ref_fns(arch, max_seq):
    jcfg, _, _ = _reference(arch)
    return (jax.jit(lambda p, b: jax_prefill(jcfg, p, b, max_seq)),
            jax.jit(lambda p, s, t: jax_decode_step(jcfg, p, s, t)))


def ref_generate(arch, prompt, extra, n, max_seq=MAX_SEQ):
    """The reference model's greedy tokens for one session alone: the
    engine's first token from the prefill, then one per decode step. Frames
    go in as f32 (their values are the engine's bf16), patches as bf16."""
    jcfg, _, jp = _reference(arch)
    pre, dec = _ref_fns(arch, max_seq)
    batch = {"tokens": jnp.asarray([prompt], jnp.int32)}
    key = EXTRA.get(jcfg.family)
    if key is not None:
        e = np.asarray(extra, np.float32)
        batch[key] = jnp.asarray(
            jnp.asarray(e, jnp.bfloat16),
            jnp.float32 if key == "frames" else jnp.bfloat16)
    logits, st = pre(jp, batch)
    out = [int(jnp.argmax(logits[0, -1]))]
    for _ in range(n - 1):
        logits, st = dec(jp, st, jnp.asarray([[out[-1]]], jnp.int32))
        out.append(int(jnp.argmax(logits[0, -1])))
    return out


@pytest.fixture(scope="module", params=SERVE_ARCHS)
def served(request):
    arch = request.param
    jcfg, tcfg, jp = _reference(arch)
    model = from_reference(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return arch, jcfg, tcfg, jp, model


def engine(served, **kw):
    _, _, tcfg, _, model = served
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq", MAX_SEQ)
    return ServingEngine(tcfg, model, device="cpu", **kw)


def seeded_extras(cfg, seed):
    """An ``extras`` dict for submit (f32 numpy: the engine rounds it to
    bf16), or None for a family without a frontend."""
    key = EXTRA.get(cfg.family)
    if key is None:
        return None
    n = cfg.n_frames if key == "frames" else cfg.n_patches
    return {key: np.random.default_rng(seed).normal(
        size=(1, n, cfg.d_model)).astype(np.float32)}


def _extra_of(extras):
    return None if extras is None else next(iter(extras.values()))


def test_submit_with_extras_batched_matches_reference(served):
    """Two sessions with their own prompts and extras decode in one pooled
    state as each does alone in the reference."""
    arch, jcfg, tcfg, _, _ = served
    eng = engine(served)
    ea, eb = seeded_extras(tcfg, 1), seeded_extras(tcfg, 2)
    pa, pb = [5, 6, 7, 8, 9], [9, 8, 7, 1, 2]
    sa, sb = eng.submit(pa, ea), eng.submit(pb, eb)
    for _ in range(5):
        eng.step()
    assert eng.sessions[sa].tokens == ref_generate(arch, pa, _extra_of(ea), 6)
    assert eng.sessions[sb].tokens == ref_generate(arch, pb, _extra_of(eb), 6)


def _lifecycle(eng, tcfg):
    """Two sessions, a park, the slot reused by a third, a resume; returns
    both sessions' tokens."""
    sid = eng.submit([5, 6, 7], seeded_extras(tcfg, 3))
    other = eng.submit([1, 2, 3, 4], seeded_extras(tcfg, 4))
    for _ in range(2):
        eng.step()
    eng.park(sid)
    third = eng.submit([4, 4], seeded_extras(tcfg, 5))
    eng.step()
    eng.finish(third)
    eng.resume(sid)
    for _ in range(3):
        eng.step()
    return eng.sessions[sid].tokens, eng.sessions[other].tokens


def test_engine_matches_reference_engine(served):
    """The port's engine against the reference model, and for vlm and
    deepseek against the reference engine itself; whisper's reference
    engine cannot prefill an f32 model (see the module docstring)."""
    arch, jcfg, tcfg, jp, _ = served
    got = _lifecycle(engine(served, node=0, store=LocStore(1)), tcfg)
    assert got == (ref_generate(arch, [5, 6, 7],
                                _extra_of(seeded_extras(tcfg, 3)), 6),
                   ref_generate(arch, [1, 2, 3, 4],
                                _extra_of(seeded_extras(tcfg, 4)), 7))
    ref_engine = JaxEngine(jcfg, jp, max_batch=2, max_seq=MAX_SEQ, node=0,
                           store=JaxLocStore(1))
    if jcfg.family == "encdec":
        with pytest.raises(TypeError, match="carry"):
            ref_engine.submit([5, 6, 7], seeded_extras(tcfg, 3))
    else:
        assert got == _lifecycle(ref_engine, tcfg)


def test_park_resume_bit_identical(served):
    """A parked slice (self and cross caches, latents) resumes into a slot
    and decodes bit-identically to a never-parked control."""
    arch, _, tcfg, _, _ = served
    kv = engine(served).slot_bytes()
    store = LocStore(1)
    eng, control = engine(served, node=0, store=store), engine(served)
    ex = seeded_extras(tcfg, 6)
    sid, cid = eng.submit([3, 1, 4, 1, 5], ex), control.submit([3, 1, 4, 1, 5],
                                                                ex)
    for _ in range(2):
        eng.step()
        control.step()
    eng.park(sid)
    assert store.getxattr(f"kvcache:session:{sid}", "size") == kv
    blocker = eng.submit([2, 7], seeded_extras(tcfg, 7))
    eng.step()
    eng.finish(blocker)
    prefills = eng.prefills
    assert eng.resume(sid) and eng.prefills == prefills
    for _ in range(3):
        eng.step()
        control.step()
    assert eng.sessions[sid].tokens == control.sessions[cid].tokens
    assert eng.sessions[sid].tokens == ref_generate(arch, [3, 1, 4, 1, 5],
                                                    _extra_of(ex), 6)


def test_router_locality_and_migrate_drop_extras(served):
    """A follow-up lands on the engine holding the session; when that engine
    is full and the session parked, the router migrates it and re-prefills
    the history WITHOUT the session's frames or patches — the reference's
    behaviour (its ``follow_up`` calls ``submit(history)``), kept for
    parity: the migrated session continues as if its extras were zeros."""
    arch, jcfg, tcfg, jp, _ = served
    out = []
    for jx in (False, True):
        if jx and jcfg.family == "encdec":
            continue                      # the reference engine refuses f32
        mk = (lambda **kw: JaxEngine(jcfg, jp, max_seq=MAX_SEQ, **kw)) if jx \
            else (lambda **kw: engine(served, **kw))
        store = (JaxLocStore if jx else LocStore)(2)
        e0, e1 = [mk(max_batch=1, node=i, store=store) for i in range(2)]
        router = (JaxRouter if jx else Router)([e0, e1], store,
                                               allow_park=False)
        sid = router.engine_for().submit([5, 6, 7, 8], seeded_extras(tcfg, 8))
        holder = e0 if sid in e0.sessions else e1
        assert router.engine_for(sid) is holder and router.locality_hits == 1
        d = router.follow_up(sid, [5, 6, 7, 8])
        assert d.kind == "hit_live" and d.engine is holder
        holder.park(sid)
        holder.submit([9, 9], seeded_extras(tcfg, 9))     # fills the holder
        other = e1 if holder is e0 else e0
        history = list(holder.sessions[sid].tokens) + [5, 6, 7, 8]
        d = router.follow_up(sid, history)
        assert d.kind == "migrate" and d.prefilled and d.engine is other
        for _ in range(3):
            other.step()
        out.append(other.sessions[d.sid].tokens)
    zeros = None if tcfg.family not in EXTRA else np.zeros_like(
        _extra_of(seeded_extras(tcfg, 8)))
    assert out[0] == ref_generate(arch, history, zeros, 4)
    if len(out) == 2:
        assert out[0] == out[1]


def test_slot_bytes_are_the_state_leaves(served):
    """A session's KV bytes are the sum of its batch-1 state's leaves (the
    MLA latents at deepseek), equal to the reference's, and a bridged
    reference slot is compatible with the port's engine."""
    arch, jcfg, tcfg, _, model = served
    eng = engine(served)
    ex = seeded_extras(tcfg, 10)
    batch = {"tokens": torch.tensor([[1, 2, 3]])}
    if ex is not None:
        key, val = next(iter(ex.items()))
        batch[key] = torch.from_numpy(val).to(torch.bfloat16)
    _, single = prefill(tcfg, model, batch, MAX_SEQ)
    ref_slot = jax_init_state(jcfg, 1, MAX_SEQ)
    assert eng.slot_bytes() == sum(t.nbytes for t in _leaves(single)) \
        == sum(a.nbytes for a in jax.tree.leaves(ref_slot))
    assert eng.compatible_state(single)
    assert eng.compatible_state(state_from_reference(
        jax.tree.map(np.asarray, ref_slot), "cpu"))
    assert not eng.compatible_state(state_from_reference(
        jax.tree.map(np.asarray, jax_init_state(jcfg, 1, MAX_SEQ + 8)), "cpu"))


# ------------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_model_on_card_matches_reference(pair, cuda):
    """Prefill and 4 decode steps on the card, attention through the
    hand-written kernels (f32, no TF32), against the reference on the CPU."""
    jcfg, tcfg, jp, _ = pair
    model = from_reference(tcfg, jax.tree.map(np.asarray, jp), cuda)
    jb, tb = batches(jcfg, tokens(jcfg, seed=17), seed=17)
    tb = {k: v.to(cuda) for k, v in tb.items()}
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        jp = jax.device_put(jp, cpu)
        jl_, jst = jax_prefill(jcfg, jp, jb, S + 4)
        tl_, tst = prefill(tcfg, model, tb, S + 4)
        close(tl_, jl_, LOGIT_TOL)
        for step in range(4):
            tok = np.full((B, 1), step + 3, np.int32)
            jl_, jst = jax_decode_step(jcfg, jp, jst, jnp.asarray(tok))
            tl_, tst = decode_step(tcfg, model, tst,
                                   torch.from_numpy(tok).long().to(cuda))
            close(tl_, jl_, LOGIT_TOL)
        close_states(tst, jst)


@pytest.mark.gpu
def test_engine_on_card_matches_reference(served, cuda):
    """Two sessions with extras, a park and a resume on the card, token for
    token with the reference model run on the CPU."""
    arch, _, tcfg, jp, _ = served
    model = from_reference(tcfg, jax.tree.map(np.asarray, jp), cuda)
    eng = ServingEngine(tcfg, model, device=cuda, max_batch=2,
                        max_seq=MAX_SEQ, node=0, store=LocStore(1))
    ea, eb = seeded_extras(tcfg, 18), seeded_extras(tcfg, 19)
    sa, sb = eng.submit([5, 6, 7], ea), eng.submit([1, 2, 3, 4], eb)
    for _ in range(2):
        eng.step()
    eng.park(sa)
    eng.step()
    eng.resume(sa)
    for _ in range(3):
        eng.step()
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        assert eng.sessions[sa].tokens == ref_generate(arch, [5, 6, 7],
                                                       _extra_of(ea), 6)
        assert eng.sessions[sb].tokens == ref_generate(arch, [1, 2, 3, 4],
                                                       _extra_of(eb), 7)
