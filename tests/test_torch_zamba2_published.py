"""The published Zamba2 block (``hybrid_layer_ids`` set) against the plain
reference ``bench/reference/hybrid.py`` and against ``transformers``'
``Zamba2ForCausalLM``, at a small size in f32; today's zamba2 block kept as
it was; on the card, K1 and K2 at hd 224 and the captured decode step.

The small model keeps the published block's shape: 2 blocks used in turn,
MLP adapters of rank 8, 2 groups of B and C, the block before layers 1, 2
and 5 of 7 (unevenly spaced), attention over ``concat[h, e]`` at hd 32
(2 d / heads, as 224 is 2 x 3584 / 32), gated GELU, a tied head. Its 1-D
leaves (norm gains, conv bias, ``dt_bias``, ``A_log``, ``D``) are drawn
away from their inits so that each enters the comparison.

Tolerances. Logits 2e-4 absolute (they are ~1 in size): only the
summation order differs (the port's SSD computes every chunk of 128 at
once, the reference's runs chunks of 64 with the state carried, and
``transformers`` runs chunks of its own with 6-operand products); the worst
measured here is ~2e-6, and one bf16 rounding of the activations moves
them by ~1e-2. The SSD against its recurrence 1e-5 (worst ~1e-6).
"""

import dataclasses
import hashlib
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import zamba2_7b
from repro_torch.configs.base import ModelConfig
from repro_torch.core.config import ServingConfig
from repro_torch.models import model as M
from repro_torch.serve.engine import (ServingEngine, TorchComputeBackend,
                                      _leaves)

ROOT = Path(__file__).resolve().parents[1]
LOGIT_TOL, SSD_TOL = 2e-4, 1e-5


def _load_reference():
    path = ROOT / "bench" / "reference" / "hybrid.py"
    spec = importlib.util.spec_from_file_location("bench_reference_hybrid",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load_reference()

SMALL = ModelConfig(
    name="zamba2-published-small", family="hybrid", n_layers=7, d_model=64,
    n_heads=4, n_kv_heads=4, head_dim=32, d_ff=96, vocab=512,
    ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_head_dim=16,
    mamba_ngroups=2, hybrid_layer_ids=(1, 2, 5), num_mem_blocks=2,
    adapter_rank=8, dtype="float32", norm_eps=1e-5, tie_embeddings=True)


def _seeded(cfg=SMALL, seed=0, device="cpu"):
    """The program's model at ``seed``, its 1-D leaves redrawn: gains and
    the conv bias N(0, 0.1^2), ``dt_bias`` N(-1, 0.5^2), ``A_log``
    N(log 4, 0.5^2), ``D`` N(1, 0.1^2)."""
    model = M.init_params(cfg, seed, device=device)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    shift = {"dt_bias": (-1.0, 0.5), "A_log": (math.log(4.0), 0.5),
             "D": (1.0, 0.1)}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 1:
                mu, sd = shift.get(name.rsplit(".", 1)[-1], (0.0, 0.1))
                p.copy_(mu + sd * torch.randn(p.shape, generator=g,
                                              device=device))
    return model


def _flat(model) -> dict:
    return {n: p.detach() for n, p in model.named_parameters()}


def _dims(cfg=SMALL) -> dict:
    return REF.dims_of(dataclasses.asdict(cfg))


def _tokens(n, seed=0, batch=2, vocab=SMALL.vocab):
    return torch.from_numpy(np.random.default_rng(seed)
                            .integers(0, vocab, (batch, n)))


def _ref_logits(model, row) -> torch.Tensor:
    return REF.logits_at(_flat(model), _dims(), row.tolist(),
                         list(range(len(row))))


# ------------------------------------------------------------ the program
def test_published_block_matches_reference():
    """A full causal pass over 150 tokens (two of the port's SSD chunks,
    three of the reference's) against the reference, every position."""
    model = _seeded()
    toks = _tokens(150)
    with torch.no_grad():
        got = model(toks)
    for b in range(toks.shape[0]):
        want = _ref_logits(model, toks[b])
        torch.testing.assert_close(got[b], want, rtol=0, atol=LOGIT_TOL)


def test_prefill_then_decode_matches_reference():
    """Prefill 140 tokens, then 10 decode steps through the cache: each
    step's logits against the reference's full forward, and the decode
    state in the published layout."""
    model = _seeded(seed=3)
    toks = _tokens(150, seed=3)
    with torch.no_grad():
        lg, st = M.prefill(SMALL, model, {"tokens": toks[:, :140]}, 160)
        steps = [lg[:, -1]]
        for t in range(140, 149):
            lg, st = M.decode_step(SMALL, model, st, toks[:, t:t + 1])
            steps.append(lg[:, -1])
    got = torch.stack(steps, dim=1)                          # (B, 10, V)
    for b in range(toks.shape[0]):
        want = REF.logits_at(_flat(model), _dims(), toks[b].tolist(),
                             list(range(139, 149)))
        torch.testing.assert_close(got[b], want, rtol=0, atol=LOGIT_TOL)
    L, n_apps = SMALL.n_layers, len(SMALL.hybrid_layer_ids)
    assert sorted(st) == ["attn_k", "attn_v", "conv", "pos", "ssm"]
    assert tuple(st["conv"].shape) == (L, 2, 3, 128 + 2 * 2 * 16)
    assert tuple(st["ssm"].shape) == (L, 2, 8, 16, 16)
    assert tuple(st["attn_k"].shape) == (n_apps, 2, 160, 4, 32)
    assert st["pos"].tolist() == [149, 149]


def test_reference_ssd_matches_recurrence():
    """The reference's chunked SSD (chunks of 64 over 150 steps, 2 groups)
    against ``s_t = exp(dt_t A) s_{t-1} + dt_t x_t B_t^T``, ``y_t = s_t
    C_t``, one step at a time in f64."""
    g = torch.Generator().manual_seed(5)
    S, H, P, G, N = 150, 6, 4, 2, 8
    x = torch.randn(S, H, P, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(S, H, generator=g) - 1)
    A = -torch.exp(torch.randn(H, generator=g))
    Bm, Cm = (torch.randn(S, G, N, generator=g) for _ in range(2))
    got = REF.ssd(x, dt, A, Bm, Cm, chunk=64)
    s = torch.zeros(H, P, N, dtype=torch.float64)
    want = torch.empty(S, H, P, dtype=torch.float64)
    grp = torch.arange(H) // (H // G)
    for t in range(S):
        a = torch.exp(dt[t].double() * A.double())
        s = a[:, None, None] * s + (dt[t].double()[:, None] * x[t].double()
                                    )[..., None] * Bm[t, grp].double()[:, None]
        want[t] = torch.einsum("hpn,hn->hp", s, Cm[t, grp].double())
    torch.testing.assert_close(got.double(), want, rtol=0, atol=SSD_TOL)


def test_matches_transformers_zamba2():
    """The same small model in ``transformers``' ``Zamba2ForCausalLM``
    (its plain torch path, eager attention, the published chunk_size 256),
    weights mapped by name: a norm's weight is ``1 + gain``, a projection
    its transpose, the conv's weight (channels, 1, K); 300 tokens, two of
    its chunks, the second padded. ``time_step_min`` is set below any
    ``dt`` the model draws: the published kernels floor nothing
    (``time_step_limit`` null), the plain path clamps at
    ``time_step_min``."""
    tr = pytest.importorskip("transformers")
    ids = SMALL.hybrid_layer_ids
    hcfg = tr.Zamba2Config(
        vocab_size=SMALL.vocab, hidden_size=SMALL.d_model,
        num_hidden_layers=SMALL.n_layers,
        layers_block_type=["hybrid" if i in ids else "mamba"
                           for i in range(SMALL.n_layers)],
        mamba_d_state=SMALL.ssm_state, mamba_d_conv=SMALL.ssm_conv,
        mamba_expand=SMALL.ssm_expand, mamba_ngroups=SMALL.mamba_ngroups,
        n_mamba_heads=SMALL.ssm_expand * SMALL.d_model // SMALL.ssm_head_dim,
        chunk_size=256, intermediate_size=SMALL.d_ff, hidden_act="gelu",
        num_attention_heads=SMALL.n_heads, num_key_value_heads=SMALL.n_kv_heads,
        num_mem_blocks=SMALL.num_mem_blocks, use_shared_attention_adapter=False,
        adapter_rank=SMALL.adapter_rank, use_mem_rope=True, rope_theta=1e4,
        rms_norm_eps=SMALL.norm_eps, time_step_min=1e-12,
        tie_word_embeddings=True, pad_token_id=None)
    hcfg._attn_implementation = "eager"
    assert hcfg.hybrid_layer_ids == list(ids)
    assert hcfg.attention_head_dim == SMALL.hd
    hf = tr.Zamba2ForCausalLM(hcfg).eval()
    model = _seeded(seed=7)
    w = _flat(model)

    def put(param, value):
        assert tuple(param.shape) == tuple(value.shape)
        with torch.no_grad():
            param.copy_(value)

    def mamba(layer, i):
        p = f"layers.{i}."
        mx = layer.mamba
        put(layer.input_layernorm.weight, 1 + w[p + "norm"])
        put(mx.in_proj.weight, w[p + "mamba.in_proj"].T)
        put(mx.conv1d.weight, w[p + "mamba.conv_w"].T[:, None, :])
        put(mx.conv1d.bias, w[p + "mamba.conv_b"])
        for n in ("dt_bias", "A_log", "D"):
            put(getattr(mx, n), w[p + "mamba." + n])
        put(mx.norm.weight, 1 + w[p + "mamba.norm"])
        put(mx.out_proj.weight, w[p + "mamba.out_proj"].T)

    put(hf.model.embed_tokens.weight, w["embed.tok"])
    put(hf.model.final_layernorm.weight, 1 + w["final_norm"])
    for i, layer in enumerate(hf.model.layers):
        if i not in ids:
            mamba(layer, i)
            continue
        k = ids.index(i)
        b, a = f"blocks.{k % SMALL.num_mem_blocks}.", f"apps.{k}."
        mamba(layer.mamba_decoder, i)
        put(layer.linear.weight, w[a + "linear"].T)
        st = layer.shared_transformer
        assert st.block_id == k % SMALL.num_mem_blocks
        put(st.input_layernorm.weight, 1 + w[b + "ln"])
        put(st.pre_ff_layernorm.weight, 1 + w[b + "ln2"])
        for n in ("q", "k", "v", "o"):
            put(getattr(st.self_attn, n + "_proj").weight,
                w[b + "attn.w" + n].T)
        put(st.feed_forward.gate_up_proj.weight, w[b + "mlp.fc1"].T)
        put(st.feed_forward.down_proj.weight, w[b + "mlp.fc2"].T)
        ad = st.feed_forward.gate_up_proj_adapter_list[k]
        put(ad[0].weight, w[a + "adapter_in"].T)
        put(ad[1].weight, w[a + "adapter_out"].T)
    assert hf.lm_head.weight.data_ptr() == \
        hf.model.embed_tokens.weight.data_ptr()
    toks = _tokens(300, seed=7)
    with torch.no_grad():
        want = hf(input_ids=toks, use_cache=False).logits
        got = model(toks)
    torch.testing.assert_close(got, want, rtol=0, atol=LOGIT_TOL)


# the zamba2-7b smoke model (seed 0, f32) before the published block's
# options existed: its leaves' (name, shape), sorted, hashed; its logits
# over ``tokens = arange(150) * 37 % 512``, and after prefilling 140 of them
# and 10 decode steps
SMOKE_TREE = (84, "e6fd60951f8b55af2f35e6c1e242d44eddc9867e8932988e2bad465fa"
                  "8ad26e1")
SMOKE_FULL = (60944.8828125, [-0.4086858332157135, -1.550623893737793,
                              -0.07209086418151855])
SMOKE_LAST = (411.8662414550781, [0.2911628782749176, -0.600760281085968,
                                  0.4819377660751343])


def test_todays_block_is_unchanged():
    """``zamba2_7b.smoke()`` builds the same tree and the same logits as
    before the published block's options (rtol 1e-5: f32 products may sum
    in another order with another thread count; a changed equation moves
    these sums by far more)."""
    cfg = dataclasses.replace(zamba2_7b.smoke(), dtype="float32")
    assert not cfg.published_zamba2 and cfg.mamba_ngroups == 1
    model = M.init_params(cfg, 0, device="cpu")
    names = sorted((n, tuple(p.shape)) for n, p in model.named_parameters())
    assert (len(names), hashlib.sha256(repr(names).encode()).hexdigest()) \
        == SMOKE_TREE
    assert type(model) is M.HybridLM
    tok = (torch.arange(150) * 37 % cfg.vocab).view(1, 150)
    with torch.no_grad():
        full = model(tok)
        lg, st = M.prefill(cfg, model, {"tokens": tok[:, :140]}, 160)
        for t in range(140, 150):
            lg, st = M.decode_step(cfg, model, st, tok[:, t:t + 1])
    for got, (total, picks) in (
            ((full.abs().sum(), full[0, [0, 75, 149], [3, 100, 511]]),
             SMOKE_FULL),
            ((lg.abs().sum(), lg[0, 0, [0, 7, 300]]), SMOKE_LAST)):
        assert math.isclose(float(got[0]), total, rel_tol=1e-5)
        np.testing.assert_allclose(got[1].numpy(), picks, rtol=1e-5,
                                   atol=1e-6)
    assert sorted(st) == ["attn_k", "attn_v", "groups", "pos", "tail"]


def test_published_options_need_hybrid_layer_ids():
    with pytest.raises(AssertionError, match="hybrid_layer_ids"):
        dataclasses.replace(zamba2_7b.smoke(), adapter_rank=8).validate()
    cfg = dataclasses.replace(SMALL, hybrid_layer_ids=[1, 2, 5])
    assert cfg.hybrid_layer_ids == (1, 2, 5) and hash(cfg) == hash(SMALL)


def test_published_sizes():
    """The configuration the benchmark runs: 81 Mamba2 layers and 13
    applications of 2 blocks at the published widths; 7.36 B weights; a
    slot of 1.68 GB at 4,096 positions."""
    cfg = _published()
    assert M.param_count(cfg) == 7_356_749_648
    be = TorchComputeBackend(cfg, 4096, device="cpu")
    assert be.slot_nbytes() == 1_682_578_436


def _published() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
        n_heads=32, n_kv_heads=32, head_dim=224, d_ff=14336, vocab=32000,
        ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
        mamba_ngroups=2,
        hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
        num_mem_blocks=2, adapter_rank=128, norm_eps=1e-5, tie_embeddings=True)


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda")


# the published block's attention: hd 224, 32 heads, MHA, at the cell's
# lengths (prompts of ~3,072 up to 3,840; slots of 4,096)
HD224_FLASH = [(1, 3840, 3840, 32, 32, 224, True, 0, 0),
               (1, 3072, 3072, 32, 32, 224, True, 0, 0),
               (2, 77, 77, 32, 32, 224, True, 0, 0)]
HD224_DECODE = [(32, 4096, 32, 32, 224,
                 [3968, 1, 2500, 4096, 3100] + [3072 + 25 * i
                                                for i in range(27)])]


def _close_on_card(out, want, dtype):
    """As tests/test_torch_kernels.py: f32 2e-5; bf16 0.05 and every element
    within 4e-3 + 2^-6 |plain|."""
    diff = (out.float() - want.float()).abs()
    assert float(diff.max()) < {"float32": 2e-5, "bfloat16": 0.05}[dtype]
    if dtype == "bfloat16":
        bound = 4e-3 + 2.0 ** -6 * want.float().abs()
        assert bool((diff <= bound).all()), float((diff / bound).max())


@pytest.mark.gpu
@pytest.mark.parametrize("case", HD224_FLASH)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_kernel_at_hd224_on_card(cuda, case, dtype):
    """K1 at the published block's shapes and softmax scale (hd / 2) **
    -0.5 against the plain version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    B, Sq, Sk, Hq, Hkv, hd, causal, win, off = case
    g = torch.Generator(device=cuda).manual_seed(5)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dt)
               for s in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd)))
    kw = dict(causal=causal, window=win, q_offset=off,
              softmax_scale=(hd / 2) ** -0.5)
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    _close_on_card(out, ref.flash_attention_ref(q, k, v, **kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("case", HD224_DECODE)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decode_kernel_at_hd224_on_card(cuda, case, dtype):
    """K2 over 32 slots of 4,096 at hd 224 (its wide chunk) against the
    plain version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    B, S_, Hq, Hkv, hd, lens = case
    g = torch.Generator(device=cuda).manual_seed(6)
    dt = getattr(torch, dtype)
    q = torch.randn((B, Hq, hd), generator=g, device=cuda).to(dt)
    kc, vc = (torch.randn((B, S_, Hkv, hd), generator=g, device=cuda).to(dt)
              for _ in range(2))
    lt = torch.tensor(lens, dtype=torch.int32, device=cuda)
    kw = dict(softmax_scale=(hd / 2) ** -0.5)
    out = decode_attention(q, kc, vc, lt, **kw)
    torch.cuda.synchronize()
    _close_on_card(out, ref.decode_attention_ref(q, kc, vc, lt, **kw), dtype)


class _EagerBackend(TorchComputeBackend):
    """Every pooled step op by op: the control of the captured step."""

    def _graph_key(self, params, state, tokens):
        return None


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["small", "published-8x4"])
def test_captured_step_equals_eager_bit_for_bit(name, cuda):
    """The published block's pooled decode step replayed as the engine's
    CUDA graph against the same step op by op: tokens equal at every one
    of 48 steps (with a finish and a submit into the freed slot), the
    pooled states bit for bit at the end; each replay counts one decode
    kernel launch an application. ``published-8x4``: the published widths
    (hd 224, 2 groups, rank-128 adapters) at 8 layers, applications before
    layers 2 and 5, 4 slots of 1,024."""
    if name == "small":
        cfg, B, S, lens = dataclasses.replace(SMALL, dtype="bfloat16"), 4, \
            128, [20, 9, 33, 14]
    else:
        cfg = dataclasses.replace(_published(), n_layers=8,
                                  hybrid_layer_ids=(2, 5))
        B, S, lens = 4, 1024, [700, 300, 1000, 50]
    from repro_torch.kernels.decode_attention import decode_attention
    model = _seeded(cfg, 0, cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist() for n in lens]
    engines = [ServingEngine(cfg, model, backend=b,
                             config=ServingConfig(max_batch=B, max_seq=S))
               for b in (TorchComputeBackend(cfg, S, device=cuda),
                         _EagerBackend(cfg, S, device=cuda))]
    sids = [[e.submit(p) for p in prompts[:3]] for e in engines]
    k2 = len(cfg.hybrid_layer_ids)
    for i in range(48):
        if i == 20:
            for e, s in zip(engines, sids):
                e.finish(s[1])
                s.append(e.submit(prompts[3]))
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
    assert g.backend.graph_replays == g.steps - 1 == 47
    assert ctrl.backend.graph_captures == 0
    for x, y in zip(_leaves(g.state), _leaves(ctrl.state), strict=True):
        assert torch.equal(x, y)
