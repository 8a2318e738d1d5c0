"""The port's dense / localglobal model against the reference, in f32.

The reference's params (``jax.random``) are bridged into the port as numpy
arrays (``repro_torch._bridge.from_reference``); inputs come from a numpy
seed. In f32 the two packages differ only by summation order and by the
attention spelling (the reference model runs the XLA chunked attention, the
port runs the kernels' plain versions on the CPU), so logits agree to 1e-4
absolute — a few hundred f32 ulps at these logit magnitudes, through 4-6
layers — and caches to 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import layers as jl
from repro.models import active_param_count as jax_active_param_count
from repro.models import param_count as jax_param_count
from repro.models import prefill as jax_prefill
from repro_torch._bridge import (from_reference, state_from_reference,
                                 state_to_numpy, to_numpy, to_torch)
from repro_torch.configs import ARCH_NAMES, get_smoke
from repro_torch.models import (active_param_count, decode_step,
                                init_decode_state, init_params, loss_fn,
                                padded_vocab, param_count, prefill)
from repro_torch.models import layers as tl

ARCHS = ["granite-3-2b", "gemma3-12b"]
LOGIT_TOL = 1e-4
S, B = 24, 2


def f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference cfg, port cfg, reference params, port model) in f32."""
    jcfg = f32(jax_smoke(request.param))
    tcfg = f32(get_smoke(request.param))
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = from_reference(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, model


def tokens(cfg, seed=0, seq=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, seq)) \
        .astype(np.int32)


def close(t, j, tol):
    np.testing.assert_allclose(to_numpy(t), np.asarray(j, np.float32),
                               rtol=0, atol=tol)


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 1e-2)])
def test_rms_norm_matches_reference(dtype, tol):
    """f32 statistics, cast before the (1 + gamma) product: bf16 agrees to
    one bf16 rounding of values of order 1 (2^-7)."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(2, 5, 64)), dtype)
    g = jnp.asarray(rng.normal(size=(64,)) * 0.1, dtype)
    want = jl.rms_norm(x, g, 1e-6)
    got = tl.rms_norm(to_torch(np.asarray(x), "cpu"),
                      to_torch(np.asarray(g), "cpu"), 1e-6)
    assert got.dtype == getattr(torch, dtype)
    close(got, want, tol)


def test_apply_rope_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    close(got, want, 2e-4)      # f32 sin/cos of angles up to 4000 rad


@pytest.mark.parametrize("window", [0, 5])
def test_chunked_attention_matches_reference(window):
    """Sq > q_chunk: the chunk loop and the remainder chunk both run."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 40, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 40, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 40, 2, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40)).copy()
    want = jl.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        q_pos=jnp.asarray(pos), k_pos=jnp.asarray(pos),
                        window=window, q_chunk=16)
    t = [torch.from_numpy(a) for a in (q, k, v, pos)]
    got = tl.attention(t[0], t[1], t[2], q_pos=t[3], k_pos=t[3],
                       window=window, q_chunk=16)
    close(got, want, 1e-5)


@pytest.mark.parametrize("window", [0, 7])
def test_grouped_decode_attention_matches_reference(window):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(3, 1, 8, 16)).astype(np.float32)
    kc = rng.normal(size=(3, 32, 2, 16)).astype(np.float32)
    vc = rng.normal(size=(3, 32, 2, 16)).astype(np.float32)
    pos = np.asarray([0, 13, 31], np.int32)
    want = jl.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), q_pos=jnp.asarray(pos),
                               window=window)
    got = tl.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc),
                              q_pos=torch.from_numpy(pos), window=window)
    close(got, want, 1e-5)


def test_mlp_and_xent_match_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    p = {k: rng.normal(size=s).astype(np.float32) * 0.2
         for k, s in (("w1", (16, 32)), ("w2", (32, 16)), ("w3", (16, 32)))}
    for gated in (True, False):
        pp = p if gated else {k: p[k] for k in ("w1", "w2")}
        want = jl.mlp_block({k: jnp.asarray(a) for k, a in pp.items()},
                            jnp.asarray(x))
        got = tl.mlp_block({k: torch.from_numpy(a) for k, a in pp.items()},
                           torch.from_numpy(x))
        close(got, want, 1e-5)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
    labels = rng.integers(-1, 11, (2, 5)).astype(np.int32)
    want = jl.softmax_xent(jnp.asarray(logits), jnp.asarray(labels))
    got = tl.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels))
    assert abs(float(got) - float(want)) < 1e-5


# ------------------------------------------------------------------ model
def test_param_count_matches_reference(pair):
    jcfg, tcfg, _, model = pair
    assert param_count(tcfg) == jax_param_count(jcfg)
    assert sum(p.numel() for p in model.parameters()) == param_count(tcfg)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_active_param_count_matches_reference(arch):
    """The published configs' active params (MoE: k routed experts of E),
    from shapes alone on both sides."""
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config
    assert active_param_count(get_config(arch)) == \
        jax_active_param_count(jax_config(arch))


def test_prefill_and_decode_match_reference(pair):
    """Prefill logits and state, then 8 decode steps of logits and state."""
    jcfg, tcfg, jp, model = pair
    toks = tokens(jcfg)
    max_seq = S + 12
    jl_, jst = jax_prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, max_seq)
    tl_, tst = prefill(tcfg, model, {"tokens": torch.from_numpy(toks).long()},
                       max_seq)
    close(tl_, jl_, LOGIT_TOL)
    for key in ("k", "v"):
        close(tst[key], jst[key], 1e-5)
    np.testing.assert_array_equal(to_numpy(tst["pos"]), np.asarray(jst["pos"]))
    rng = np.random.default_rng(5)
    for _ in range(8):
        tok = rng.integers(0, jcfg.vocab, (B, 1)).astype(np.int32)
        jl_, jst = jax_decode_step(jcfg, jp, jst, jnp.asarray(tok))
        tl_, tst = decode_step(tcfg, model, tst, torch.from_numpy(tok).long())
        close(tl_, jl_, LOGIT_TOL)
    for key in ("k", "v"):
        close(tst[key], jst[key], 1e-5)
    np.testing.assert_array_equal(to_numpy(tst["pos"]), np.asarray(jst["pos"]))


def test_decode_state_bridges_both_ways(pair):
    """A reference decode state steps identically in the port."""
    jcfg, tcfg, jp, model = pair
    toks = tokens(jcfg, seed=6, seq=9)
    _, jst = jax_prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, 16)
    tst = state_from_reference(jax.tree.map(np.asarray, jst), "cpu")
    tok = np.asarray([[3], [4]], np.int32)
    jl_, jst = jax_decode_step(jcfg, jp, jst, jnp.asarray(tok))
    tl_, tst = decode_step(tcfg, model, tst, torch.from_numpy(tok).long())
    close(tl_, jl_, LOGIT_TOL)
    back = state_to_numpy(tst)
    for key in ("k", "v"):
        np.testing.assert_allclose(back[key], np.asarray(jst[key]), atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_plus_decode_matches_full_prefill(arch):
    """decode(prefill(S-1), tok_{S-1}) == prefill(S) — the cache invariant
    (mirrors tests/test_models.py on the port alone)."""
    cfg = f32(get_smoke(arch))
    model = init_params(cfg, 1, device="cpu")
    toks = torch.from_numpy(tokens(cfg, seed=7)).long()
    full, _ = prefill(cfg, model, {"tokens": toks}, S + 8)
    _, st = prefill(cfg, model, {"tokens": toks[:, :S - 1]}, S + 8)
    step, _ = decode_step(cfg, model, st, toks[:, S - 1:S])
    a = full[:, -1] - full[:, -1].max(-1, keepdim=True).values
    b = step[:, -1] - step[:, -1].max(-1, keepdim=True).values
    torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3)


def test_vocab_padding_masks_logits():
    """granite's smoke vocab 503 -> padded 512; pad logits are -inf-ish."""
    cfg = get_smoke("granite-3-2b")
    model = init_params(cfg, 0, device="cpu")
    st = init_decode_state(cfg, B, 8, device="cpu")
    logits, _ = decode_step(cfg, model, st, torch.zeros((B, 1), dtype=torch.long))
    assert logits.shape == (B, 1, 512)
    assert (logits[..., cfg.vocab:].float() < -1e20).all()


def test_sliding_window_differs_from_full():
    """gemma local layers actually mask: a long-range key must not attend."""
    cfg = f32(get_smoke("gemma3-12b"))
    cfg_full = dataclasses.replace(cfg, sliding_window=10_000)
    model = init_params(cfg, 0, device="cpu")
    model_full = init_params(cfg_full, 0, device="cpu")
    toks = torch.from_numpy(tokens(cfg, seed=0, seq=40)).long()
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    l1, _ = loss_fn(cfg, model, batch)
    l2, _ = loss_fn(cfg_full, model_full, batch)
    assert torch.isfinite(l1) and abs(float(l1) - float(l2)) > 1e-6


def test_out_of_range_decode_writes_are_dropped(pair):
    """An idle slot whose pos reached max_seq: JAX drops the cache write;
    the port must too (torch would raise on the CPU and assert on CUDA).
    The whole state matches the reference's, and the in-range row's logits
    too."""
    jcfg, tcfg, jp, model = pair
    max_seq = 10
    _, jst = jax_prefill(jcfg, jp, {"tokens": jnp.asarray(tokens(jcfg, 8, 9))},
                         max_seq)
    jst = dict(jst, pos=jnp.asarray([max_seq - 1, max_seq], jnp.int32))
    tst = state_from_reference(jax.tree.map(np.asarray, jst), "cpu")
    before = tst["k"][:, 1].clone()
    tok = np.asarray([[1], [2]], np.int32)
    jl_, jst2 = jax_decode_step(jcfg, jp, jst, jnp.asarray(tok))
    tl_, tst2 = decode_step(tcfg, model, tst, torch.from_numpy(tok).long())
    assert torch.equal(tst2["k"][:, 1], before)      # the write was dropped
    for key in ("k", "v"):
        close(tst2[key], jst2[key], 1e-5)
    np.testing.assert_array_equal(to_numpy(tst2["pos"]),
                                  np.asarray(jst2["pos"]))
    close(tl_[0], jl_[0], LOGIT_TOL)
    assert torch.isfinite(tl_).all()


def test_bf16_prefill_matches_reference_within_bf16_tolerance():
    """bf16 rounds at other places in the two packages (the reference casts
    the probabilities to bf16 before the PV product, the port's attention
    stays in f32), so bf16 parity has its own bound: 0.05 on the logits."""
    jcfg = jax_smoke("granite-3-2b")
    tcfg = get_smoke("granite-3-2b")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = from_reference(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    toks = tokens(jcfg, seed=9)
    jl_, _ = jax_prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, S)
    tl_, _ = prefill(tcfg, model, {"tokens": torch.from_numpy(toks).long()}, S)
    assert tl_.dtype == torch.bfloat16
    live = slice(0, tcfg.vocab)
    close(tl_[..., live], np.asarray(jl_, np.float32)[..., live], 0.05)


def test_default_device_is_cuda():
    cfg = get_smoke("granite-3-2b")
    if torch.cuda.is_available():
        assert init_params(cfg, 0).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_params(cfg, 0)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_family_builds_on_cpu(arch):
    """Every architecture of the registry builds, prefills (with zero frames
    or patches where its frontend is stubbed) and takes a decode step on the
    CPU: no family is left unported."""
    cfg = get_smoke(arch)
    model = init_params(cfg, 0, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == param_count(cfg)
    batch = {"tokens": torch.tensor([[3, 1, 4, 1, 5]])}
    key = {"encdec": "frames", "vlm": "patches"}.get(cfg.family)
    if key is not None:
        n = cfg.n_frames if key == "frames" else cfg.n_patches
        batch[key] = torch.zeros((1, n, cfg.d_model), dtype=torch.bfloat16)
    logits, st = prefill(cfg, model, batch, 8)
    assert tuple(logits.shape) == (1, 1, padded_vocab(cfg))
    logits, st = decode_step(cfg, model, st, torch.tensor([[2]]))
    assert tuple(logits.shape) == (1, 1, padded_vocab(cfg))
    assert torch.isfinite(logits[..., :cfg.vocab]).all()
    assert st["pos"].tolist() == [6]


# ------------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_model_on_card_matches_reference(pair, cuda):
    """The same parity as on the CPU, with the attention going through the
    hand-written kernels (f32 products, no TF32: torch's default). The
    reference runs on the CPU, as here: where jax sees the card it would
    take its f32 products in TF32 by default."""
    jcfg, tcfg, jp, _ = pair
    model = from_reference(tcfg, jax.tree.map(np.asarray, jp), cuda)
    toks = tokens(jcfg, seed=10)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        jp = jax.device_put(jp, cpu)
        jl_, jst = jax_prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, S + 4)
        tl_, tst = prefill(tcfg, model, {
            "tokens": torch.from_numpy(toks).long().to(cuda)}, S + 4)
        close(tl_, jl_, LOGIT_TOL)
        for step in range(4):
            tok = np.full((B, 1), step + 3, np.int32)
            jl_, jst = jax_decode_step(jcfg, jp, jst, jnp.asarray(tok))
            tl_, tst = decode_step(tcfg, model, tst,
                                   torch.from_numpy(tok).long().to(cuda))
            close(tl_, jl_, LOGIT_TOL)
        for key in ("k", "v"):
            close(tst[key], jst[key], 1e-5)
