"""The port's training path against the reference's.

* The flash kernel's autograd node (``FlashAttentionFunction``): its dq, dk,
  dv against torch autograd of the plain version and ``jax.vjp`` of the
  reference's oracle, over the reference kernel tests' cases, at the default
  query chunk and at a chunk of 48 rows (ragged chunk seams), f32: 2e-5
  absolute, the kernel tests' f32 tolerance (the same f32 math summed in
  another order).
* AdamW and the train step against ``repro.train``: the same f32 smoke
  params (bridged from the reference, norm gains drawn at random so that
  their decay shows) and the same numpy batches, two steps with 1 and 2
  microbatches. Loss, grad norm, lr, params and both moments agree to
  ``STEP_TOL`` of each tensor's largest magnitude: f32 sums in another
  order through 3-6 layers, a softmax and the backward. ``eps`` is 1e-3 in
  those runs: the update m / (sqrt v + eps) moves by up to 1 / eps per unit
  of gradient error, and a gradient that is a sum of cancelling terms
  carries f32 noise of ~1e-8 absolute. At the default 1e-8 the first update
  is sign(g), a step function, and such an element flips by 2 lr; at 1e-3
  the noise moves a param by ~1e-7 at lr 1e-2.
* Checkpoints cross between the packages in both directions, bit for bit
  (bf16 included); the corpus yields the reference's tokens; the loop
  passes the reference's loop tests on the CPU.

Tests marked ``gpu`` hold the autograd node to the plain version on the
card and count the kernel's launches in a train step; they decide inside a
fixture whether there is a card and skip here.
"""

import dataclasses
import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as JAX_ARCHS
from repro.configs import get_smoke as jax_smoke
from repro.data.pipeline import SyntheticCorpus as JaxCorpus
from repro.kernels import ref as jref
from repro.models import init_params as jax_init_params
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch._bridge import (from_reference, load_reference,
                                 opt_state_from_reference,
                                 opt_state_to_reference, reference_key,
                                 reference_ndims, to_numpy, to_reference,
                                 to_torch)
from repro_torch.configs import get_smoke
from repro_torch.core.locstore import LocStore
from repro_torch.data.pipeline import PrefetchingLoader, SyntheticCorpus
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (FlashAttentionFunction,
                                                 flash_attention)
from repro_torch.launch import train as train_cli
from repro_torch.models import init_params, loss_fn, make_trainable
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import TrainConfig, train
from repro_torch.train.optimizer import (OptConfig, _decay_mask, adamw_update,
                                         global_norm, init_opt_state,
                                         schedule)
from repro_torch.train.train_step import (make_prefill_step, make_serve_step,
                                          make_train_step)

F32_TOL = 2e-5
STEP_TOL = 2e-5
FLASH_CASES = [
    # B, Sq, Sk, Hq, Hkv, hd, causal, window, off  (as tests/test_kernels.py)
    (2, 128, 128, 4, 2, 64, True, 0, 0),
    (1, 100, 100, 4, 4, 72, True, 0, 0),       # unaligned seq + head dim
    (2, 64, 192, 8, 2, 64, True, 0, 128),      # suffix prefill offset
    (2, 256, 256, 4, 2, 64, True, 64, 0),      # sliding window (gemma local)
    (1, 96, 160, 2, 2, 48, False, 0, 0),       # bidirectional (encoder)
    (1, 64, 64, 8, 1, 128, True, 0, 0),        # MQA
    (2, 80, 80, 6, 3, 240, True, 0, 0),        # gemma3-12b head dim
    # the backward's own edge: rows 17-23 sit past the keys' window and see
    # no key (their softmax is uniform over all keys)
    (1, 24, 20, 4, 2, 16, False, 8, 10),
]


@pytest.fixture(autouse=True)
def _few_threads():
    """Smoke-sized eager steps are dominated by per-op overhead, which more
    intra-op threads only add to (and the suite runs in several workers):
    two threads per test, the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def max_rel(a, b) -> float:
    """max |a - b| over max |b| (0 when both are 0)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale > 0 \
        else float(np.abs(a).max())


def flat_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_np(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def bits(a) -> np.ndarray:
    """An array's raw bits (bf16 as uint16), for bit-for-bit comparison."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


# ------------------------------------------------------------ autograd node
def _attn_inputs(case, dtype=torch.float32):
    B, Sq, Sk, Hq, Hkv, hd, causal, win, off = case
    rng = np.random.default_rng([int(x) for x in case])
    return [torch.tensor(rng.normal(size=s), dtype=torch.float32).to(dtype)
            for s in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd),
                      (B, Sq, Hq, hd))]


@pytest.mark.parametrize("q_chunk", [ref.BWD_Q_CHUNK, 48])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[f"flash{i}" for i in range(len(FLASH_CASES))])
def test_flash_backward_matches_autograd_and_jax(case, q_chunk):
    B, Sq, Sk, Hq, Hkv, hd, causal, win, off = case
    kw = dict(causal=causal, window=win, q_offset=off)
    q, k, v, do = _attn_inputs(case)
    qs, ks, vs = (x.clone().requires_grad_(True) for x in (q, k, v))
    ref.flash_attention_ref(qs, ks, vs, **kw).backward(do)
    got = ref.flash_attention_bwd_ref(q, k, v, do, q_chunk=q_chunk, **kw)
    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(a, b, c, **kw),
                     *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    want_jax = vjp(jnp.asarray(do.numpy()))
    for g, w, wj in zip(got, (qs.grad, ks.grad, vs.grad), want_jax):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert float((g - w).abs().max()) < F32_TOL
        assert float(np.abs(g.numpy() - np.asarray(wj)).max()) < F32_TOL


@pytest.mark.parametrize("case", FLASH_CASES[:4],
                         ids=[f"flash{i}" for i in range(4)])
def test_attention_op_records_the_autograd_node(case):
    """With grad, ``attention_op`` goes through FlashAttentionFunction (the
    wrapper forward, the chunked backward); under no_grad it returns the
    wrapper's output with no graph; ``impl="plain"`` is torch autograd of
    the plain version, and the two agree."""
    B, Sq, Sk, Hq, Hkv, hd, causal, win, off = case
    kw = dict(causal=causal, window=win, q_offset=off)
    q, k, v, do = _attn_inputs(case)
    with torch.no_grad():
        assert ops.attention_op(q, k, v, **kw).grad_fn is None
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    n = ref.flash_attention_bwd_ref.calls
    out = ops.attention_op(*leaves, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    out.backward(do)
    assert ref.flash_attention_bwd_ref.calls == n + 1
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ops.attention_op(*plain, impl="plain", **kw).backward(do)
    for a, b in zip(leaves, plain):
        assert float((a.grad - b.grad).abs().max()) < F32_TOL
    # the node's forward is the wrapper's output, bit for bit
    with torch.no_grad():
        want = flash_attention(q, k, v, **kw)
    assert torch.equal(FlashAttentionFunction.apply(*leaves, causal, win,
                                                    off, None).detach(), want)


def test_flash_backward_bf16_rounds_like_autograd():
    """bf16 inputs: both compute in f32 and round the gradients to bf16 once;
    they differ by at most one bf16 ulp of the larger element (2^-7 of the
    gradient's magnitude)."""
    case = FLASH_CASES[0]
    kw = dict(causal=True, window=0, q_offset=0)
    q, k, v, do = _attn_inputs(case, torch.bfloat16)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref.flash_attention_ref(*leaves, **kw).backward(do)
    for g, w in zip(ref.flash_attention_bwd_ref(q, k, v, do, q_chunk=48, **kw),
                    (x.grad for x in leaves)):
        assert g.dtype == torch.bfloat16
        diff = (g.float() - w.float()).abs()
        assert bool((diff <= 2.0 ** -7 * w.float().abs() + 1e-6).all())


# ------------------------------------------------------------------ AdamW
def own_ndims(params):
    """The decay mask's dims of a flat dict with no stacked layout: its
    own (the reference's tree of the same leaves has the same dims)."""
    return {k: p.ndim for k, p in params.items()}


class TestOptimizer:
    """Mirrors tests/test_train.py::TestOptimizer, each against the
    reference's function on the same values."""

    def test_schedule_warmup_and_decay(self):
        oc = OptConfig(lr=1.0, warmup_steps=10, total_steps=100)
        assert float(schedule(oc, 0)) == 0.0
        assert float(schedule(oc, 10)) == pytest.approx(1.0)
        assert float(schedule(oc, 100)) == pytest.approx(0.1)
        joc = jopt.OptConfig(lr=3e-4, warmup_steps=10, total_steps=100)
        toc = OptConfig(lr=3e-4, warmup_steps=10, total_steps=100)
        for s in (0, 1, 5, 10, 11, 37, 99, 100, 150):
            # f32 both sides; cos from two libms: a few f32 ulps
            assert float(schedule(toc, torch.tensor(s, dtype=torch.int32))) \
                == pytest.approx(float(jopt.schedule(joc, jnp.asarray(s))),
                                 rel=1e-6)

    def test_clipping_bounds_update(self):
        oc = OptConfig(lr=1e-2, clip_norm=1.0, weight_decay=0.0)
        params = {"w": torch.zeros((4, 4))}
        st = init_opt_state(oc, params)
        huge = {"w": torch.full((4, 4), 1e6)}
        new_p, st, m = adamw_update(oc, huge, st, params, own_ndims(params))
        assert float(m["grad_norm"]) > 1e5
        assert float(new_p["w"].abs().max()) < 1.0
        joc = jopt.OptConfig(lr=1e-2, clip_norm=1.0, weight_decay=0.0)
        jp, jst, jm = jopt.adamw_update(
            joc, {"w": jnp.full((4, 4), 1e6)},
            jopt.init_opt_state(joc, {"w": jnp.zeros((4, 4))}),
            {"w": jnp.zeros((4, 4))})
        np.testing.assert_allclose(new_p["w"].numpy(), np.asarray(jp["w"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(st["m"]["w"].numpy(),
                                   np.asarray(jst["m"]["w"]), rtol=1e-6)

    def test_no_decay_on_vectors(self):
        oc = OptConfig(lr=1e-1, weight_decay=1.0)
        params = {"w": torch.ones((4, 4)), "g": torch.ones((4,))}
        st = init_opt_state(oc, params)
        zeros = {k: torch.zeros_like(p) for k, p in params.items()}
        new_p, _, _ = adamw_update(oc, zeros, st, params,
                                   own_ndims(params))
        assert float(new_p["w"][0, 0]) < 1.0
        assert float(new_p["g"][0]) == pytest.approx(1.0)

    def test_moment_dtype_bf16(self):
        oc = OptConfig(moment_dtype="bfloat16")
        st = init_opt_state(oc, {"w": torch.zeros((2, 2),
                                                  dtype=torch.bfloat16)})
        assert st["m"]["w"].dtype == torch.bfloat16
        assert st["step"].dtype == torch.int32 and st["step"].shape == ()

    def test_global_norm(self):
        t = {"a": torch.ones((3,)), "b": torch.ones((4,))}
        assert float(global_norm(t)) == pytest.approx(np.sqrt(7.0))
        rng = np.random.default_rng(0)
        arrs = {k: rng.normal(size=s).astype(np.float32)
                for k, s in (("a", (3, 5)), ("b", (7,)), ("c", (2, 2, 2)))}
        assert float(global_norm({k: torch.from_numpy(v)
                                  for k, v in arrs.items()})) \
            == pytest.approx(float(jopt.global_norm(arrs)), rel=1e-6)

    @pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                        ("bfloat16", "bfloat16")],
                             ids=["f32", "bf16-params-bf16-moments"])
    def test_three_updates_match_reference(self, dtypes):
        """Three AdamW steps on random params and grads, clipping active:
        bf16 rounds the params and moments at the same places in both."""
        p_dt, m_dt = dtypes
        rng = np.random.default_rng(3)
        shapes = {"w": (8, 6), "g": (6,), "s": ()}
        jp = {k: jnp.asarray(rng.normal(size=s), p_dt)
              for k, s in shapes.items()}
        tp = {k: to_torch(np.asarray(v), "cpu") for k, v in jp.items()}
        kw = dict(lr=5e-2, warmup_steps=1, total_steps=5, clip_norm=2.0,
                  moment_dtype=m_dt, eps=1e-5)
        joc, toc = jopt.OptConfig(**kw), OptConfig(**kw)
        jst, tst = jopt.init_opt_state(joc, jp), init_opt_state(toc, tp)
        for _ in range(3):
            jg = {k: jnp.asarray(rng.normal(size=s) * 3, p_dt)
                  for k, s in shapes.items()}
            tg = {k: to_torch(np.asarray(v), "cpu") for k, v in jg.items()}
            jp, jst, jm = jopt.adamw_update(joc, jg, jst, jp)
            tp, tst, tm = adamw_update(toc, tg, tst, tp, own_ndims(tp))
        tol = 1e-6 if p_dt == "float32" else 2.0 ** -8
        for k in shapes:
            for a, b in ((tp[k], jp[k]), (tst["m"][k], jst["m"][k]),
                         (tst["v"][k], jst["v"][k])):
                assert a.dtype == getattr(torch, str(b.dtype))
                assert max_rel(to_numpy(a), np.asarray(b, np.float32)) <= tol
        assert int(tst["step"]) == int(jst["step"]) == 3
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)

    def test_bf16_updates_at_the_train_phase_recipe_match_reference(self):
        """The card's train phase: bf16 params at init scale (std 0.02 and
        zero norm gains, decayed as stacked), f32 moments, OptConfig with
        warmup 10 (lr 3e-5, 6e-5, 9e-5), grads clipped from norms in the
        hundreds. Most of these updates are below half a bf16 ulp of the
        param and round away; the reference rounds the same elements. Each
        param is within one bf16 ulp of the reference's; f32 ops in another
        order may flip a rounding tie, so at most 1e-3 of them differ."""
        rng = np.random.default_rng(5)
        shapes = {"w": (64, 96), "ln": (3, 96)}
        jp = {"w": jnp.asarray(rng.normal(size=shapes["w"]) * 0.02,
                               "bfloat16"),
              "ln": jnp.zeros(shapes["ln"], "bfloat16")}
        tp = {k: to_torch(np.asarray(v), "cpu") for k, v in jp.items()}
        kw = dict(warmup_steps=10, total_steps=3)
        joc, toc = jopt.OptConfig(**kw), OptConfig(**kw)
        jst, tst = jopt.init_opt_state(joc, jp), init_opt_state(toc, tp)
        p0 = to_numpy(tp["w"]).astype(np.float32)
        for _ in range(3):
            jg = {k: jnp.asarray(rng.normal(size=s) * 5, "bfloat16")
                  for k, s in shapes.items()}
            tg = {k: to_torch(np.asarray(v), "cpu") for k, v in jg.items()}
            jp, jst, jm = jopt.adamw_update(joc, jg, jst, jp)
            tp, tst, tm = adamw_update(toc, tg, tst, tp, own_ndims(tp))
            assert float(tm["grad_norm"]) > 100 * toc.clip_norm
        for k in shapes:
            a = to_numpy(tp[k]).astype(np.float32)
            b = np.asarray(jp[k], np.float32)
            ulp = np.maximum(np.abs(b), 2.0 ** -126) * 2.0 ** -7
            assert bool((np.abs(a - b) <= ulp).all())
            assert float(np.mean(a != b)) <= 1e-3
            # f32 moments: the clip scale comes from two f32 global norms
            # summed in other orders (~10 f32 ulps apart at these norms)
            for x, y in ((tst["m"][k], jst["m"][k]),
                         (tst["v"][k], jst["v"][k])):
                assert max_rel(to_numpy(x), np.asarray(y)) <= 1e-5
        moved = float(np.mean(to_numpy(tp["w"]).astype(np.float32) != p0))
        assert 0.0 < moved < 1.0          # some updates round away
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)

    def test_decay_mask_reads_the_stacked_layout(self):
        """A layer's norm gain is (d,) in the port and (L, d) in the
        reference, which decays it; final_norm (d,) is not decayed in
        either."""
        cfg = get_smoke("granite-3-2b")
        model = init_params(cfg, 0, device="cpu")
        mask = _decay_mask(reference_ndims(model))
        assert model.blocks[0].ln1.ndim == 1
        assert mask["blocks.0.ln1"] == mask["blocks.3.ln2"] == 1.0
        assert mask["final_norm"] == 0.0
        assert mask["blocks.0.attn.wq"] == mask["embed.tok"] == 1.0


# -------------------------------------------------------- reference layout
@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_to_reference_has_the_reference_keys_and_shapes(arch):
    """Every family's port model stacks into the reference's param tree:
    the same key paths, shapes and dtypes as ``jax.eval_shape`` of the
    reference's init, and loading it back gives the same weights."""
    cfg = get_smoke(arch)
    model = init_params(cfg, 0, device="cpu")
    tree = to_reference(cfg, model)
    jshapes = jax.eval_shape(
        lambda: jax_init_params(jax_smoke(arch), jax.random.PRNGKey(0)))
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in flat_np(
        jax.tree.map(lambda x: x, jshapes,
                     is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    ).items()}
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in flat_np(tree).items()}
    assert got == want
    other = dict(load_reference(cfg, init_params(cfg, 1, device="cpu"),
                                tree).named_parameters())
    for n, a in model.named_parameters():
        assert torch.equal(a, other[n]), n


def test_reference_key_names_stack_positions():
    assert reference_key("blocks.3.attn.wq") == ("blocks/attn/wq", (3,))
    assert reference_key("self_groups.1.2.ln1") == ("self_groups/ln1", (1, 2))
    assert reference_key("final_norm") == ("final_norm", ())
    assert reference_key("embed.tok") == ("embed/tok", ())


# ------------------------------------------------------------- train step
def _bridged(arch, seed=0):
    """(reference cfg, port cfg, reference params, numpy params) in f32, the
    all-zero leaves (norm gains) drawn at random."""
    jcfg, tcfg = f32(jax_smoke(arch)), f32(get_smoke(arch))
    jp = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    np_p = jax.tree.map(
        lambda a: (rng.normal(size=a.shape) * 0.2).astype(np.float32)
        if not np.any(a) else np.asarray(a), jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, np_p), np_p


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma3-12b"])
def test_train_step_matches_reference(arch, microbatches):
    jcfg, tcfg, jp, np_p = _bridged(arch)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
              eps=1e-3)
    joc, toc = jopt.OptConfig(**kw), OptConfig(**kw)
    jstep = jax.jit(jax_make_train_step(jcfg, joc, microbatches=microbatches))
    tstep = make_train_step(tcfg, toc, microbatches=microbatches)
    model = make_trainable(tcfg, from_reference(tcfg, np_p, "cpu"))
    jst = jopt.init_opt_state(joc, jp)
    tst = init_opt_state(toc, dict(model.named_parameters()))
    rng = np.random.default_rng(7)
    for _ in range(2):
        x = rng.integers(0, tcfg.vocab, (4, 17)).astype(np.int32)
        batch = {"tokens": x[:, :-1], "labels": x[:, 1:]}
        jp, jst, jm = jstep(jp, jst, batch)
        model, tst, tm = tstep(model, tst, {k: torch.from_numpy(
            np.ascontiguousarray(v)) for k, v in batch.items()})
        for key in ("loss", "grad_norm", "lr"):
            assert float(tm[key]) == pytest.approx(float(jm[key]),
                                                   rel=STEP_TOL), key
    assert int(tst["step"]) == int(jst["step"]) == 2
    o_ref = opt_state_to_reference(tcfg, model, tst)
    for name, got, want in (
            [("p/" + k, v, flat_np(jp)[k])
             for k, v in flat_np(to_reference(tcfg, model)).items()]
            + [(f"{m}/" + k, v, flat_np(jst[m])[k]) for m in ("m", "v")
               for k, v in flat_np(o_ref[m]).items()]):
        assert max_rel(to_numpy(got), np.asarray(want)) <= STEP_TOL, name


def test_train_step_refuses_frozen_models_and_grad_specs():
    cfg = f32(get_smoke("granite-3-2b"))
    step = make_train_step(cfg, OptConfig())
    model = init_params(cfg, 0, device="cpu")
    x = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="frozen"):
        step(model, init_opt_state(OptConfig(), dict(
            model.named_parameters())), {"tokens": x, "labels": x})
    with pytest.raises(NotImplementedError, match="dist/"):
        make_train_step(cfg, OptConfig(), grad_specs={})
    for arch in JAX_ARCHS:                 # every family trains
        assert callable(make_train_step(get_smoke(arch), OptConfig()))


def test_remat_recomputes_each_layer_and_keeps_the_loss():
    """With grad the dense layers run under torch.utils.checkpoint: the
    attention forward runs twice a layer (forward + recompute) and the
    plain backward once; the loss equals the no-grad loss."""
    cfg = f32(get_smoke("gemma3-12b"))
    model = make_trainable(cfg, init_params(cfg, 0, device="cpu"))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 33)).astype(np.int32))
    batch = {"tokens": x[:, :-1], "labels": x[:, 1:]}
    with torch.no_grad():
        want, _ = loss_fn(cfg, model, batch)
    calls = {"fwd": 0}
    orig = FlashAttentionFunction.forward

    def counted(*a, **k):
        calls["fwd"] += 1
        return orig(*a, **k)

    n = ref.flash_attention_bwd_ref.calls
    FlashAttentionFunction.forward = staticmethod(counted)
    try:
        loss, _ = loss_fn(cfg, model, batch)
        loss.backward()
    finally:
        FlashAttentionFunction.forward = staticmethod(orig)
    assert calls["fwd"] == 2 * cfg.n_layers
    assert ref.flash_attention_bwd_ref.calls == n + cfg.n_layers
    assert float(loss.detach()) == float(want)


def test_serve_and_prefill_steps_run_without_grad():
    cfg = f32(get_smoke("granite-3-2b"))
    model = make_trainable(cfg, init_params(cfg, 0, device="cpu"))
    tok = torch.zeros((1, 5), dtype=torch.long)
    logits, state = make_prefill_step(cfg, 8)(model, {"tokens": tok})
    logits2, _ = make_serve_step(cfg)(model, state, tok[:, :1])
    assert logits.grad_fn is None and logits2.grad_fn is None


# ------------------------------------------------------------- checkpoints
def _port_state(cfg, seed=0):
    """A port model and an AdamW state with nonzero moments (one step)."""
    model = make_trainable(cfg, init_params(cfg, seed, device="cpu"))
    oc = OptConfig(moment_dtype="float32")
    st = init_opt_state(oc, dict(model.named_parameters()))
    x = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (2, 9)).astype(np.int32))
    model, st, _ = make_train_step(cfg, oc)(
        model, st, {"tokens": x[:, :-1], "labels": x[:, 1:]})
    return model, oc, st


def test_port_checkpoint_restores_through_the_reference():
    """bf16 weights, f32 moments: the reference's restore (target from
    jax.eval_shape) reads the port's checkpoint bit for bit."""
    tcfg, jcfg = get_smoke("granite-3-2b"), jax_smoke("granite-3-2b")
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
    got = flat_np(jax.tree.map(np.asarray, out))
    want = flat_np(tree)
    assert set(got) == set(want)
    assert str(got["p/blocks/attn/wq"].dtype) == "bfloat16"
    for k in want:
        np.testing.assert_array_equal(bits(got[k]), bits(want[k]), err_msg=k)


def test_reference_checkpoint_restores_into_the_port():
    """The reference's bf16 params and moments, saved by the reference,
    restored by the port (no ml_dtypes on its side) and loaded into a port
    model: bit for bit what the bridge carries over."""
    tcfg, jcfg = get_smoke("gemma3-12b"), jax_smoke("gemma3-12b")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    joc = jopt.OptConfig(moment_dtype="bfloat16")
    jst = jopt.init_opt_state(joc, jp)
    jst = {"m": jax.tree.map(lambda p: (p * 3).astype(jnp.bfloat16), jp),
           "v": jax.tree.map(lambda p: (p * p).astype(jnp.bfloat16), jp),
           "step": jnp.asarray(4, jnp.int32)}
    with tempfile.TemporaryDirectory() as d:
        jckpt.save({"p": jp, "o": jst}, d, 4)
        assert ckpt.latest_step(d) == 4
        out = ckpt.restore(d)
    model = init_params(tcfg, 1, device="cpu")
    load_reference(tcfg, model, out["p"])
    want = dict(from_reference(tcfg, jax.tree.map(np.asarray, jp),
                               "cpu").named_parameters())
    for n, a in model.named_parameters():
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(bits(a), bits(want[n]), err_msg=n)
    st = opt_state_from_reference(tcfg, model, out["o"])
    assert int(st["step"]) == 4 and st["step"].dtype == torch.int32
    back = opt_state_to_reference(tcfg, model, st)
    for m in ("m", "v"):
        for k, v in flat_np(back[m]).items():
            np.testing.assert_array_equal(
                bits(v), bits(np.asarray(flat_np(jst[m])[k])), err_msg=k)


class TestCheckpoint:
    """Mirrors tests/test_train.py::TestCheckpoint on the port."""

    def test_roundtrip_bf16(self):
        tree = {"a": torch.ones((4, 4), dtype=torch.bfloat16) * 1.5,
                "b": {"c": torch.arange(6, dtype=torch.int32)}}
        with tempfile.TemporaryDirectory() as d:
            ckpt.save(tree, d, 3)
            assert ckpt.latest_step(d) == 3
            tgt = {"a": torch.empty((4, 4), dtype=torch.bfloat16,
                                    device="meta"),
                   "b": {"c": torch.empty(6, dtype=torch.int32,
                                          device="meta")}}
            out = ckpt.restore(d, target=tgt)
        assert out["a"].dtype == torch.bfloat16
        assert torch.equal(out["a"], tree["a"])
        assert torch.equal(out["b"]["c"], tree["b"]["c"])

    def test_latest_pointer_tracks_newest(self):
        with tempfile.TemporaryDirectory() as d:
            ckpt.save({"x": torch.zeros(2)}, d, 1)
            ckpt.save({"x": torch.ones(2)}, d, 2)
            assert ckpt.latest_step(d) == 2
            assert torch.equal(ckpt.restore(d)["x"], torch.ones(2))

    def test_async_checkpointer(self):
        with tempfile.TemporaryDirectory() as d:
            ac = ckpt.AsyncCheckpointer(d)
            x = torch.ones((128, 128))
            ac.save_async({"x": x}, 5)
            x.zero_()            # the snapshot was taken on this thread
            ac.wait()
            assert ckpt.latest_step(d) == 5
            assert float(ckpt.restore(d)["x"].min()) == 1.0

    def test_atomicity_no_tmp_left(self):
        with tempfile.TemporaryDirectory() as d:
            ckpt.save({"x": torch.zeros(3)}, d, 7)
            assert not any(p.endswith(".tmp") for p in os.listdir(d))

    def test_target_mismatch_raises(self):
        with tempfile.TemporaryDirectory() as d:
            ckpt.save({"x": torch.zeros(3)}, d, 1)
            with pytest.raises(ValueError, match="mismatch"):
                ckpt.restore(d, target={"y": torch.zeros(3)})

    def test_store_records_placement(self):
        store = LocStore(2)
        with tempfile.TemporaryDirectory() as d:
            path = ckpt.save({"x": torch.zeros(3)}, d, 2, store=store, node=1)
            name = f"ckpt:{os.path.basename(d)}:2"
            assert store.exists(name)
            assert store.getxattr(name, "path") == path
            assert store.getxattr(name, "size") == 12
            assert store.getxattr(name, "step") == 2


# -------------------------------------------------------------------- data
class TestCorpus:
    """The corpus is the reference's, token for token (mirrors
    tests/test_data_and_prefetch.py::TestCorpus)."""

    def test_shards_equal_the_reference(self):
        for seed, i in ((5, 3), (0, 0), (7, 11)):
            np.testing.assert_array_equal(
                SyntheticCorpus(1000, seed=seed).shard(i),
                JaxCorpus(1000, seed=seed).shard(i))

    def test_batches_and_restart_equal_the_reference(self):
        c, j = SyntheticCorpus(503, seed=1), JaxCorpus(503, seed=1)
        full = [b for _, b in zip(range(8), c.batches(4, 32))]
        ref_full = [b for _, b in zip(range(8), j.batches(4, 32))]
        resumed = [b for _, b in zip(range(3), c.batches(4, 32,
                                                         start_step=5))]
        for a, b in zip(full, ref_full):
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(a[k], b[k])
        for a, b in zip(full[5:], resumed):
            np.testing.assert_array_equal(a["tokens"], b["tokens"])

    def test_labels_are_next_tokens(self):
        b = next(SyntheticCorpus(1000).batches(2, 16))
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


class TestPrefetchingLoader:
    def test_yields_all_and_counts_waits(self):
        def gen():
            for i in range(5):
                yield {"x": np.full((2,), i)}

        loader = PrefetchingLoader(gen(), depth=2, device="cpu")
        got = [int(b["x"][0]) for b in loader]
        assert got == [0, 1, 2, 3, 4]
        assert loader.loads == 5

    def test_places_contiguous_tensors(self):
        x = np.arange(12, dtype=np.int32).reshape(3, 4)
        loader = PrefetchingLoader(iter([{"t": x[:, :-1]}]), device="cpu")
        b = next(loader)
        assert b["t"].dtype == torch.int32 and b["t"].is_contiguous()
        np.testing.assert_array_equal(b["t"].numpy(), x[:, :-1])
        loader.close()

    def test_prefetch_hides_producer_latency(self):
        def gen(delay):
            for _ in range(6):
                time.sleep(delay)
                yield {"x": np.zeros(1)}

        t0 = time.perf_counter()
        loader = PrefetchingLoader(gen(0.05), depth=3, device="cpu")
        for _ in loader:
            time.sleep(0.05)      # consumer work overlaps producer
        overlapped = time.perf_counter() - t0
        assert overlapped < 2 * 6 * 0.05 + 0.2   # far below serial 0.6s


# -------------------------------------------------------------------- loop
def test_loss_decreases():
    cfg = get_smoke("granite-3-2b")
    r = train(cfg, TrainConfig(steps=25, batch=4, seq=32), device="cpu")
    assert r.steps_done == 25
    assert r.losses[-1] < r.losses[0] * 0.9


def test_failure_restart_reaches_same_final_loss():
    """Restart replays the same batches: final loss must match no-failure."""
    cfg = get_smoke("minitron-8b")
    with tempfile.TemporaryDirectory() as d1:
        base = train(cfg, TrainConfig(steps=20, batch=4, seq=32,
                                      ckpt_every=10, ckpt_dir=d1),
                     device="cpu")
    with tempfile.TemporaryDirectory() as d2:
        failed = train(cfg, TrainConfig(steps=20, batch=4, seq=32,
                                        ckpt_every=10, ckpt_dir=d2,
                                        simulate_failure_at=15),
                       device="cpu")
    assert failed.restarts == 1
    np.testing.assert_allclose(base.losses[-1], failed.losses[-1],
                               rtol=2e-2)


def test_failure_before_first_checkpoint_cold_restarts():
    cfg = get_smoke("granite-3-2b")
    with tempfile.TemporaryDirectory() as d:
        r = train(cfg, TrainConfig(steps=12, batch=2, seq=32, ckpt_every=50,
                                   ckpt_dir=d, simulate_failure_at=5),
                  device="cpu")
    assert r.restarts == 1 and r.steps_done == 12


def test_loop_microbatches_and_launcher(capsys):
    """Accumulating 2 microbatches trains from the same init to the same
    first loss (the mean over the global batch); the launcher trains on
    the CPU when asked."""
    cfg = f32(get_smoke("granite-3-2b"))
    one = train(cfg, TrainConfig(steps=2, batch=4, seq=16), device="cpu")
    two = train(cfg, TrainConfig(steps=2, batch=4, seq=16, microbatches=2),
                device="cpu")
    assert two.losses[0] == pytest.approx(one.losses[0], rel=1e-5)
    train_cli.main(["--device", "cpu", "--arch", "gemma3-12b", "--steps", "2",
                    "--batch", "2", "--seq", "16", "--layers", "3"])
    assert "done: 2 steps" in capsys.readouterr().out


# ------------------------------------------------- the profile's busy time
def _chip_smoke():
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("intervals, want", [
    ([(0.0, 4.0), (2.0, 6.0)], 6.0),                  # a known overlap
    ([(0.0, 10.0), (2.0, 3.0), (4.0, 9.5)], 10.0),    # nested intervals
    ([(5.0, 7.0), (0.0, 1.0), (2.0, 2.5)], 3.5),      # disjoint, unsorted
    ([(0.0, 1.0), (1.0, 2.0), (3.0, 3.0)], 2.0),      # touching, empty
    ([], 0.0),
], ids=["overlap", "nested", "disjoint", "touching", "none"])
def test_busy_time_is_the_union_of_device_intervals(intervals, want):
    """``chip_smoke.busy_ms``: the device is busy for the union of its
    events' spans, so a copy on a side stream under a kernel counts once
    (their sum would count it twice and can exceed the wall)."""
    assert _chip_smoke().busy_ms(intervals) == pytest.approx(want)


# --------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda")


CARD_CASES = [
    # B, Sq, Sk, Hq, Hkv, hd, causal, window, off, V's own width (V padded
    # to hd outside the node, the scale hd_qk ** -0.5 passed: MLA) or None
    (2, 1100, 1100, 32, 8, 64, True, 0, 0, None),  # the train shape's heads
    (1, 1536, 1536, 16, 8, 240, True, 1024, 0, None),  # gemma3-12b local
    (1, 600, 700, 16, 16, 64, False, 0, 0, None),  # non-causal (encoder)
    (2, 448, 1500, 16, 16, 64, False, 0, 0, None),  # cross, G 1 (whisper)
    (1, 300, 1601, 64, 8, 128, False, 0, 0, None),  # cross, G 8 (vision)
    (1, 700, 700, 32, 32, 112, True, 0, 0, None),  # hd 112 (zamba2)
    (1, 600, 600, 16, 16, 192, True, 0, 0, 128),   # MLA hd 192, V 128
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES,
                         ids=["train-gqa4", "gemma3-window", "noncausal",
                              "cross-g1", "cross-g8", "hd112", "mla-hd192"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_node_matches_plain_on_card(cuda, case, dtype):
    """K1 under autograd against torch autograd of the plain version on the
    card: forward through the kernel (one launch), backward through the
    chunked plain VJP (both in f32 math; bf16 rounds each gradient once, so
    they part by at most one bf16 ulp, 2^-7 relative, plus f32 noise). The
    MLA case pads V outside the node, as the model does, so the gradient of
    V's own columns is compared."""
    B, Sq, Sk, Hq, Hkv, hd, causal, win, off, dv = case
    kw = dict(causal=causal, window=win, q_offset=off)
    if dv is not None:
        kw["softmax_scale"] = hd ** -0.5
    g = torch.Generator(device=cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(s, generator=g, device=cuda).to(dt)
                   for s in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd),
                             (B, Sk, Hkv, dv or hd), (B, Sq, Hq, dv or hd)))

    def run(leaves, **impl):
        qq, kk, vv = leaves
        if dv is None:
            return ops.attention_op(qq, kk, vv, **kw, **impl)
        vv = torch.nn.functional.pad(vv, (0, hd - dv))
        return ops.attention_op(qq, kk, vv, **kw, **impl)[..., :dv]

    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    n = flash_attention.launches
    out = run(leaves)
    assert flash_attention.launches == n + 1
    out.backward(do)
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    run(plain, impl="plain").backward(do)
    torch.cuda.synchronize()
    for a, b in zip(leaves, plain):
        diff = (a.grad.float() - b.grad.float()).abs()
        w = b.grad.float().abs()
        if dtype == "float32":
            assert float(diff.max()) <= 1e-5 * max(float(w.max()), 1.0)
        else:
            assert bool((diff <= 2.0 ** -7 * w + 1e-5 * float(w.max())).all())


@pytest.mark.gpu
def test_wrapper_refuses_inputs_that_need_a_gradient_on_card(cuda):
    q = torch.randn((1, 64, 4, 64), device=cuda, requires_grad=True)
    k = torch.randn((1, 64, 2, 64), device=cuda)
    with pytest.raises(RuntimeError, match="no gradient"):
        flash_attention(q, k, k)
    with torch.no_grad():
        assert flash_attention(q, k, k).grad_fn is None


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_launches_the_kernel_twice_per_layer_on_card(cuda, dtype):
    """A train step with 2 microbatches: 2 x layers x 2 K1 launches (forward
    and recompute), layers x 2 plain backwards, no plain forward."""
    cfg = dataclasses.replace(get_smoke("granite-3-2b"), dtype=dtype)
    model = make_trainable(cfg, init_params(cfg, 0, device=cuda))
    oc = OptConfig()
    st = init_opt_state(oc, dict(model.named_parameters()))
    x = torch.randint(0, cfg.vocab, (4, 65), device=cuda, dtype=torch.int32)
    step = make_train_step(cfg, oc, microbatches=2)
    n, nb = flash_attention.launches, ref.flash_attention_bwd_ref.calls
    orig, plain_calls = ref.flash_attention_ref, []
    ref.flash_attention_ref = lambda *a, **k: plain_calls.append(1) \
        or orig(*a, **k)
    try:
        _, _, m = step(model, st, {"tokens": x[:, :-1], "labels": x[:, 1:]})
    finally:
        ref.flash_attention_ref = orig
    assert flash_attention.launches - n == 2 * cfg.n_layers * 2
    assert ref.flash_attention_bwd_ref.calls - nb == cfg.n_layers * 2
    assert plain_calls == []
    assert bool(torch.isfinite(m["loss"]))
