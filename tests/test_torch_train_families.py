"""Training of the encdec, vlm, moe, hybrid and rwkv families against the
reference's.

* Two f32 train steps of the port's ``make_train_step`` against the
  reference's, at 1 and 2 microbatches, for whisper, vision (its zero gates
  opened by ``_bridged``'s random draw), deepseek (MLA, MTP and the router
  aux), arctic (GQA with the dense residual), zamba2 and rwkv, with seeded
  frames and patches in the batch: loss, grad norm, lr, every param and
  both AdamW moments within ``STEP_TOL`` of each tensor's largest magnitude
  (as ``test_torch_train.py::test_train_step_matches_reference``). For the
  moe family the two routers' top-k choices are compared first, on each
  package's own MoE inputs: a near-tie flipped by an f32 ulp would show
  there as a routing difference, not as a gradient mismatch. rwkv's params
  and moments are held to ``RWKV_STEP_TOL``: its smoke model is
  ill-conditioned in f32, so a one-ulp change of its params moves the
  port's own gradients by more than ``STEP_TOL`` (measured 1.0e-4), while
  the two packages' gradients part by less than that (3e-5); a test pins
  both readings.
* Per-layer recompute: the kernel's autograd node runs its forward twice per
  attention application (forward and recompute; once for the MTP block,
  which is not recomputed) and its plain backward once; the recurrent
  layers run twice; the loss equals the no-grad loss bit for bit.
* Checkpoints of every family cross between the packages both ways, bit for
  bit; the decay mask is the reference's in every family.
* A defect of the reference pinned: its bf16 encdec / vlm loss raises on
  the f32 frames and patches its own loop makes (``extras_fn``), and runs on
  bf16 ones; the port casts the extras to the model's dtype, so its loss is
  the same for both.

Tests marked ``gpu`` count the kernel's launches in a train step of each
family's smoke config on the card; they decide inside a fixture whether
there is a card and skip here.
"""

import dataclasses
import math
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as JAX_ARCHS
from repro.configs import get_smoke as jax_smoke
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.models import moe as jmoe
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train.loop import extras_fn as jax_extras_fn
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch._bridge import (from_reference, load_reference,
                                 opt_state_from_reference,
                                 opt_state_to_reference, reference_ndims,
                                 to_numpy, to_reference, to_torch)
from repro_torch.configs import get_smoke
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (FlashAttentionFunction,
                                                 flash_attention)
from repro_torch.launch import train as train_cli
from repro_torch.models import init_params, loss_fn, make_trainable
from repro_torch.models import model as M
from repro_torch.models import moe as tmoe
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import extras_fn
from repro_torch.train.optimizer import OptConfig, _decay_mask, init_opt_state
from repro_torch.train.train_step import make_train_step
from test_torch_train import STEP_TOL, _bridged, bits, f32, flat_np, max_rel

# rwkv: 2x the port's own gradient spread under a one-ulp change of its
# params (1.0e-4; test_rwkv_f32_gradients_part_by_less_than_one_ulp_moves)
RWKV_STEP_TOL = 2e-4
FAMILY_ARCHS = ["whisper-medium", "llama-3.2-vision-90b", "deepseek-v3-671b",
                "arctic-480b", "zamba2-7b", "rwkv6-1.6b"]
B, S = 4, 16


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def np_batch(cfg, rng, batch=B, seq=S, extras_dtype=np.float32) -> dict:
    """Tokens, next-token labels and the family's frames / patches (seeded
    normal draws, as the reference's loop attaches them)."""
    x = rng.integers(0, cfg.vocab, (batch, seq + 1)).astype(np.int32)
    out = jax_extras_fn(cfg, {"tokens": np.ascontiguousarray(x[:, :-1]),
                              "labels": np.ascontiguousarray(x[:, 1:])}, rng)
    return {k: v.astype(extras_dtype) if v.dtype == np.float32 else v
            for k, v in out.items()}


def torch_batch(batch: dict) -> dict:
    return {k: to_torch(v, "cpu") for k, v in batch.items()}


def applications(cfg) -> int:
    """Attention applications of one pass that are recomputed: every
    encoder, decoder self and cross layer (encdec), every layer (vlm, moe),
    each application of the shared block (hybrid); none in rwkv. The moe
    family's MTP block adds one more, not recomputed."""
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "rwkv":
        return 0
    return cfg.n_layers


# ------------------------------------------------------------- train step
class _Routing:
    """Records each MoE layer's top-k expert choices, in both packages, over
    one un-differentiated loss of each (the reference's through an ordered
    debug callback inside its scan)."""

    def __init__(self, cfg, monkeypatch) -> None:
        self.k, self.port, self.ref = cfg.experts_per_token, [], []
        port_ffn, ref_ffn = tmoe.moe_ffn, jmoe.moe_ffn

        def port_spy(c, p, x):
            probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                                  @ p["router"], dim=-1)
            self.port.append(torch.sort(probs, dim=-1, descending=True,
                                        stable=True)[1][:, :self.k].numpy())
            return port_ffn(c, p, x)

        def ref_spy(c, p, x):
            probs = jax.nn.softmax(x.reshape(-1, x.shape[-1]).astype(
                jnp.float32) @ p["router"], axis=-1)
            jax.debug.callback(lambda i: self.ref.append(np.asarray(i)),
                               jax.lax.top_k(probs, self.k)[1], ordered=True)
            return ref_ffn(c, p, x)

        monkeypatch.setattr(tmoe, "moe_ffn", port_spy)
        monkeypatch.setattr(jmoe, "moe_ffn", ref_spy)

    def check(self, tcfg, model, jcfg, jp, tb, jb) -> None:
        self.port.clear()
        self.ref.clear()
        with torch.no_grad():
            loss_fn(tcfg, model, tb)
        jax.block_until_ready(jax_loss_fn(jcfg, jp, jb))
        jax.effects_barrier()
        assert len(self.port) == len(self.ref) > 0
        for a, b in zip(self.port, self.ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_step_matches_reference(arch, microbatches, monkeypatch):
    jcfg, tcfg, jp, np_p = _bridged(arch)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
              eps=1e-3)
    joc, toc = jopt.OptConfig(**kw), OptConfig(**kw)
    routing = _Routing(tcfg, monkeypatch) if tcfg.family == "moe" else None
    jstep = jax.jit(jax_make_train_step(jcfg, joc, microbatches=microbatches))
    tstep = make_train_step(tcfg, toc, microbatches=microbatches)
    model = make_trainable(tcfg, from_reference(tcfg, np_p, "cpu"))
    jst = jopt.init_opt_state(joc, jp)
    tst = init_opt_state(toc, dict(model.named_parameters()))
    rng = np.random.default_rng(7)
    for _ in range(2):
        batch = np_batch(tcfg, rng)
        tb = torch_batch(batch)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        if routing is not None:
            routing.check(tcfg, model, jcfg, jp, tb, jb)
        jp, jst, jm = jstep(jp, jst, jb)
        model, tst, tm = tstep(model, tst, tb)
        assert set(tm) == set(jm)
        for key in jm:
            assert float(tm[key]) == pytest.approx(float(jm[key]),
                                                   rel=STEP_TOL), key
    assert int(tst["step"]) == int(jst["step"]) == 2
    tol = RWKV_STEP_TOL if tcfg.family == "rwkv" else STEP_TOL
    o_ref = opt_state_to_reference(tcfg, model, tst)
    for name, got, want in (
            [("p/" + k, v, flat_np(jp)[k])
             for k, v in flat_np(to_reference(tcfg, model)).items()]
            + [(f"{m}/" + k, v, flat_np(jst[m])[k]) for m in ("m", "v")
               for k, v in flat_np(o_ref[m]).items()]):
        assert max_rel(to_numpy(got), np.asarray(want)) <= tol, name


def test_rwkv_f32_gradients_part_by_less_than_one_ulp_moves():
    """Why rwkv's step is held to RWKV_STEP_TOL: with the bridged f32 smoke
    params, multiplying every param by (1 + 1e-7 N(0, 1)), about one ulp,
    moves the port's own gradients by more than STEP_TOL of a leaf's
    largest magnitude; the reference's gradients (jax.grad, same params and
    batch) part from the port's by less than that move."""
    from repro_torch._bridge import _stack
    jcfg, tcfg, jp, np_p = _bridged("rwkv6-1.6b")
    batch = np_batch(tcfg, np.random.default_rng(7))

    def port_grads(params):
        model = make_trainable(tcfg, from_reference(tcfg, params, "cpu"))
        loss, _ = loss_fn(tcfg, model, torch_batch(batch))
        loss.backward()
        return flat_np(_stack({n: p.grad for n, p in
                               model.named_parameters()}, None))

    rng = np.random.default_rng(1)
    moved = jax.tree.map(lambda a: (a * (1 + 1e-7 * rng.standard_normal(
        a.shape))).astype(np.float32), np_p)
    base, other = port_grads(np_p), port_grads(moved)
    jg = flat_np(jax.tree.map(np.asarray, jax.grad(lambda p: jax_loss_fn(
        jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()})[0])(jp)))
    spread = max(max_rel(other[k], base[k]) for k in base)
    apart = max(max_rel(base[k], jg[k]) for k in base)
    assert STEP_TOL < spread <= RWKV_STEP_TOL / 2
    assert apart < spread


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_remat_recomputes_each_layer_and_keeps_the_loss(arch, monkeypatch):
    """With grad every layer runs under torch.utils.checkpoint: the kernel's
    node forward twice per attention application (+1 for the MTP block),
    its plain backward once per application; the Mamba2 and RWKV layers run
    twice; the loss equals the no-grad loss."""
    cfg = f32(get_smoke(arch))
    model = make_trainable(cfg, init_params(cfg, 0, device="cpu"))
    tb = torch_batch(np_batch(cfg, np.random.default_rng(0), batch=2))
    with torch.no_grad():
        want, _ = loss_fn(cfg, model, tb)
    calls = {"attn": 0, "mamba": 0, "rwkv": 0}

    def counted(key, fn):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(FlashAttentionFunction, "forward", staticmethod(
        counted("attn", FlashAttentionFunction.forward)))
    monkeypatch.setattr(tssm, "mamba2_block",
                        counted("mamba", tssm.mamba2_block))
    monkeypatch.setattr(trwkv, "time_mix", counted("rwkv", trwkv.time_mix))
    n = ref.flash_attention_bwd_ref.calls
    loss, _ = loss_fn(cfg, model, tb)
    loss.backward()
    apps, mtp = applications(cfg), cfg.mtp_depth
    assert calls["attn"] == 2 * apps + mtp
    assert ref.flash_attention_bwd_ref.calls == n + apps + mtp
    recurrent = {"hybrid": "mamba", "rwkv": "rwkv"}.get(cfg.family)
    for key in ("mamba", "rwkv"):
        assert calls[key] == (2 * cfg.n_layers if key == recurrent else 0)
    assert float(loss.detach()) == float(want)
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())


# ------------------------------------------------------- reference layout
@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_decay_mask_is_the_references(arch):
    """The port's decay mask (``reference_ndims``) is the reference's
    ``_decay_mask`` of its stacked tree, leaf for leaf."""
    cfg = get_smoke(arch)
    model = init_params(cfg, 0, device="cpu")
    shapes = jax.eval_shape(lambda: jax_init_params(jax_smoke(arch),
                                                    jax.random.PRNGKey(0)))
    want = flat_np(jax.tree.map(
        lambda m: m, jopt._decay_mask(shapes)))
    got = _decay_mask(reference_ndims(model))
    tree = to_reference(cfg, model)
    stacked = {k: float(v.ndim >= 2) for k, v in flat_np(tree).items()}
    assert stacked == {k: float(v) for k, v in want.items()}
    from repro_torch._bridge import reference_key
    for name, m in got.items():
        assert m == stacked[reference_key(name)[0]], name
    named = dict(model.named_parameters())
    if cfg.family == "hybrid":
        assert got["shared_attn.ln"] == 0.0 and got["groups.0.0.norm"] == 1.0
        assert got["shared_attn.attn.wq"] == 1.0
    if cfg.family == "vlm":
        assert named["cross_blocks.0.gate"].ndim == 0
        assert got["cross_blocks.0.gate"] == got["cross_blocks.1.gate_mlp"] \
            == 0.0
    if cfg.family == "rwkv":
        for leaf in ("tm.u", "tm.w0", "tm.mu", "cm.mu_k", "cm.mu_r", "ln1"):
            assert got[f"blocks.0.{leaf}"] == 1.0, leaf
    if cfg.family == "moe" and cfg.mtp_depth:
        assert got["mtp.norm"] == got["mtp.block.ln1"] == 0.0


def _port_state(cfg, seed=0):
    """A port model and an AdamW state with nonzero moments (one step on a
    batch with the family's extras)."""
    model = make_trainable(cfg, init_params(cfg, seed, device="cpu"))
    oc = OptConfig(moment_dtype="float32")
    st = init_opt_state(oc, dict(model.named_parameters()))
    tb = torch_batch(np_batch(cfg, np.random.default_rng(seed), batch=2,
                              seq=8))
    model, st, m = make_train_step(cfg, oc)(model, st, tb)
    assert math.isfinite(float(m["loss"]))
    return model, oc, st


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_port_checkpoint_restores_through_the_reference(arch):
    """bf16 weights, f32 moments after one port step: the reference's
    restore (target from jax.eval_shape) reads the port's checkpoint bit for
    bit, and the port's restore reads it back into a model."""
    tcfg, jcfg = get_smoke(arch), jax_smoke(arch)
    model, oc, st = _port_state(tcfg)
    tree = {"p": to_reference(tcfg, model),
            "o": opt_state_to_reference(tcfg, model, st)}
    tgt_p = jax.eval_shape(lambda: jax_init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    tgt_o = jax.eval_shape(lambda: jopt.init_opt_state(jopt.OptConfig(),
                                                       tgt_p))
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(tree, d, 3)
        out = jckpt.restore(d, target={"p": tgt_p, "o": tgt_o})
        back = ckpt.restore(d)
    got = flat_np(jax.tree.map(np.asarray, out))
    want = flat_np(tree)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(bits(got[k]), bits(want[k]), err_msg=k)
    other = load_reference(tcfg, init_params(tcfg, 1, device="cpu"),
                           back["p"])
    ost = opt_state_from_reference(tcfg, other, back["o"])
    named = dict(other.named_parameters())
    for n, a in model.named_parameters():
        assert torch.equal(a, named[n]), n
        for m in ("m", "v"):
            assert torch.equal(st[m][n], ost[m][n]), (m, n)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_reference_checkpoint_restores_into_the_port(arch):
    """The reference's bf16 params and bf16 moments, saved by the reference,
    restored by the port and loaded into a port model: bit for bit what the
    bridge carries over, and back to the reference's layout unchanged."""
    tcfg, jcfg = get_smoke(arch), jax_smoke(arch)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jst = {"m": jax.tree.map(lambda p: (p * 3 + 1).astype(jnp.bfloat16), jp),
           "v": jax.tree.map(lambda p: (p * p).astype(jnp.bfloat16), jp),
           "step": jnp.asarray(4, jnp.int32)}
    with tempfile.TemporaryDirectory() as d:
        jckpt.save({"p": jp, "o": jst}, d, 4)
        out = ckpt.restore(d)
    model = load_reference(tcfg, init_params(tcfg, 1, device="cpu"),
                           out["p"])
    want = dict(from_reference(tcfg, jax.tree.map(np.asarray, jp),
                               "cpu").named_parameters())
    for n, a in model.named_parameters():
        np.testing.assert_array_equal(bits(a), bits(want[n]), err_msg=n)
    st = opt_state_from_reference(tcfg, model, out["o"])
    assert int(st["step"]) == 4
    back = opt_state_to_reference(tcfg, model, st)
    for m in ("m", "v"):
        for k, v in flat_np(back[m]).items():
            np.testing.assert_array_equal(
                bits(v), bits(np.asarray(flat_np(jst[m])[k])), err_msg=k)


# ------------------------------------------------- the reference's defect
@pytest.mark.parametrize("arch", ["whisper-medium", "llama-3.2-vision-90b"])
def test_reference_bf16_loss_refuses_its_loops_f32_extras(arch):
    """The reference's loop attaches f32 frames / patches (``extras_fn``);
    its bf16 encdec / vlm loss raises on them (the f32 cross K/V promote the
    bf16 residual inside the layer scan) and runs on bf16 ones. The port
    casts the extras to the model's dtype: its bf16 loss is the same for the
    f32 extras and for their bf16 rounding."""
    jcfg, tcfg = jax_smoke(arch), get_smoke(arch)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    batch = np_batch(tcfg, np.random.default_rng(3), batch=2, seq=8)
    key = M._EXTRAS[tcfg.family]
    rounded = dict(batch, **{key: batch[key].astype(jnp.bfloat16)})
    with pytest.raises(TypeError, match="carry"):
        jax.eval_shape(lambda p: jax_loss_fn(
            jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}), jp)
    jloss, _ = jax_loss_fn(jcfg, jp, {k: jnp.asarray(v)
                                      for k, v in rounded.items()})
    assert np.isfinite(float(jloss))
    model = from_reference(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    with torch.no_grad():
        a, _ = loss_fn(tcfg, model, torch_batch(batch))
        b, _ = loss_fn(tcfg, model, torch_batch(rounded))
    assert torch_batch(rounded)[key].dtype == torch.bfloat16
    assert float(a) == float(b)
    # the port's loop makes the reference's f32 extras, and trains on them
    made = extras_fn(tcfg, {"tokens": batch["tokens"]},
                     np.random.default_rng(0))
    assert made[key].dtype == np.float32


# ----------------------------------------------------------- the launcher
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_launcher_trains_every_family_on_cpu(arch, capsys):
    r = train_cli.main(["--device", "cpu", "--arch", arch, "--steps", "3",
                        "--batch", "2", "--seq", "16"])
    assert r.steps_done == 3 and len(r.losses) == 3
    assert all(math.isfinite(x) for x in r.losses)
    assert "done: 3 steps" in capsys.readouterr().out


# --------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_step_launches_the_kernel_as_designed_on_card(cuda, arch):
    """One train step of the smoke config (bf16, 2 microbatches) on the
    card: K1 launches 2 x applications (+1 for MTP) per microbatch, the
    plain backward once per application, no plain attention forward and no
    decode kernel; the loss is finite."""
    from repro_torch.kernels.decode_attention import decode_attention
    cfg = get_smoke(arch)
    model = make_trainable(cfg, init_params(cfg, 0, device=cuda))
    oc = OptConfig()
    st = init_opt_state(oc, dict(model.named_parameters()))
    batch = {k: v.to(cuda) for k, v in torch_batch(
        np_batch(cfg, np.random.default_rng(0))).items()}
    step = make_train_step(cfg, oc, microbatches=2)
    n, nb = flash_attention.launches, ref.flash_attention_bwd_ref.calls
    nd = decode_attention.launches
    orig, plain_calls = ref.flash_attention_ref, []
    ref.flash_attention_ref = lambda *a, **k: plain_calls.append(1) \
        or orig(*a, **k)
    try:
        _, _, m = step(model, st, batch)
    finally:
        ref.flash_attention_ref = orig
    apps = applications(cfg)
    assert flash_attention.launches - n == (2 * apps + cfg.mtp_depth) * 2
    assert ref.flash_attention_bwd_ref.calls - nb == (apps + cfg.mtp_depth) * 2
    assert decode_attention.launches == nd
    assert plain_calls == []
    assert bool(torch.isfinite(m["loss"]))
