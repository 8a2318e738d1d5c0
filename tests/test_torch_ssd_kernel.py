"""The chunked SSD's CUDA kernels (``kernels/ssd_scan.py``) against the
plain version (``models.ssm._ssd_plain``, around ``_ssd_scan``) on the same
card tensors (the tests marked ``gpu``; they skip without a card), and on
the CPU the wrapper's refusal of CPU tensors, its meta path, the engage
rule and how the model reports where the SSD ran.

Tolerance: 1e-4 of each output's largest magnitude (``TOL``). The kernels
compute the same f32 products as the plain version, in another order: a y
element sums at most 128 intra-chunk terms, 64 terms of the carried state
and, through it, every earlier chunk's 128-term increment (30 chunks at
3,840 tokens), each term rounded at f32's unit 2^-24 (6e-8). Two orders of
such sums differ by about sqrt(terms) x 2^-24 of the terms' size, ~4e-6 of
the output's largest magnitude at the longest chain, 25x inside TOL. A
single TF32 pass (unit 2^-11) or bf16 pass (2^-8) over the f32-valued
operands moves the result by ~5e-4 to 4e-3 of it, outside TOL. The
cumulative log-decay is a sequential f32 sum in both versions (the plain
version's ``torch.cumsum`` along a non-inner dimension on the card), so
both take the same decays. The kernels also sum each product in the plain
version's order where its GEMMs run one chain over the contraction, and on
an H100 the two have agreed bit for bit at every case here; TOL does not
count on that.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_zamba2_published import _published

from repro_torch.kernels import ssd_scan as ssd_kernel
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import model as M
from repro_torch.models import ssm

TOL = 1e-4
GAP_LIMIT = 0.6        # zamba2-7b.longdoc's limit on served_logit_gap_max
CEILING = 64 << 20     # scratch of one 3,072-token layer's SSD, bytes

# name: (heads h, head dim P, state N, groups G, heads in the layer H, h0)
SHAPES = {
    "zamba2-7b": (112, 64, 64, 2, 112, 0),        # the published layer
    "smoke-g1": (4, 32, 16, 1, 4, 0),             # zamba2-7b's smoke block
    "slice": (56, 64, 64, 2, 112, 28),            # h0 28: across the groups
}
LENGTHS = [1, 77, 128, 3000, 3072, 3840]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda")


def _inputs(device, shape: str, S: int, dtype=torch.bfloat16, seed=0, B=1):
    """The SSD's inputs as the prefill makes them: ``xbc`` the conv's silu
    output in the model's dtype, dt a softplus, the log-decay -exp(A_log)
    dt with A_log ~ N(log 4, 0.5^2), D ~ N(1, 0.1^2)."""
    h, P, N, G, H, h0 = SHAPES[shape]
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=g, device=device)

    xbc = torch.nn.functional.silu(randn(B, S, h * P + 2 * G * N)).to(dtype)
    dt = torch.nn.functional.softplus(randn(B, S, h) * 0.5 - 1.0)
    loga = -torch.exp(np.log(4.0) + 0.5 * randn(h)) * dt
    D = 1.0 + 0.1 * randn(h)
    kw = dict(h0=h0, heads_per_group=H // G, head_dim=P, state=N)
    return (xbc, dt, loga, D), kw


def _close(out, want):
    err = float((out - want).abs().max())
    scale = float(want.abs().max())
    assert err <= TOL * scale, (err, scale, err / scale)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_wrapper_refuses_cpu_tensors(shape):
    """The wrapper takes CUDA tensors only (the model runs the plain version
    elsewhere); a CPU call raises and launches nothing."""
    args, kw = _inputs(torch.device("cpu"), shape, 200)
    n = ssd_scan.launches
    with pytest.raises(ValueError, match="unsupported device"):
        ssd_scan(*args, **kw)
    assert ssd_scan.launches == n


def test_wrapper_on_meta_returns_empties():
    """The dry run's meta tensors: outputs of the kernels' shapes, f32."""
    h, P, N, G, H, h0 = SHAPES["slice"]
    xbc = torch.empty((2, 300, h * P + 2 * G * N), dtype=torch.bfloat16,
                      device="meta")
    dt = torch.empty((2, 300, h), device="meta")
    n = ssd_scan.launches
    y, hs = ssd_scan(xbc, dt, dt, torch.empty((h,), device="meta"), h0=h0,
                     heads_per_group=H // G, head_dim=P, state=N)
    assert ssd_scan.launches == n
    assert (y.shape, hs.shape) == ((2, 300, h * P), (2, h, P, N))
    assert y.dtype == hs.dtype == torch.float32 and y.is_meta


def test_kernel_chunk_is_the_models():
    assert ssd_kernel.CHUNK == ssm.CHUNK


def test_cpu_tensors_take_the_plain_version():
    """The engage rule on observable inputs: CPU tensors never fuse, with
    or without a gradient."""
    t = torch.ones(2, requires_grad=True)
    assert not ssm._fused(t)
    with torch.no_grad():
        assert not ssm._fused(t)


@pytest.mark.parametrize("fused", [False, True])
def test_prefill_span_reports_where_the_ssd_ran(fused, monkeypatch):
    """``mamba2_block`` decides once and reports it beside the state; the
    span ``mamba.prefill`` counts the layer's tokens as ``fused_tokens``
    when the kernels ran. On the CPU the rule says plain; planted True, a
    stand-in for the wrapper (the plain version, counted) runs instead."""
    from repro_torch import obs
    from repro_torch.configs import get_smoke
    cfg = get_smoke("zamba2-7b")
    model = M.init_params(cfg, 0, device="cpu")
    calls = []
    if fused:
        monkeypatch.setattr(ssm, "_fused", lambda *ts: True)
        monkeypatch.setattr(ssd_kernel, "ssd_scan", lambda *a, **kw: (
            calls.append(1), ssm._ssd_plain(*a, **kw))[1])
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (1, 40)))
    obs.reset()
    obs.enable()
    try:
        with torch.no_grad():
            M.prefill(cfg, model, {"tokens": toks}, 64)
        spans = [r for r in obs.records().spans if r.name == "mamba.prefill"]
    finally:
        obs.disable()
        obs.reset()
    assert len(spans) == cfg.n_layers == len(calls) + (0 if fused else
                                                       cfg.n_layers)
    assert all(r.attrs["fused_tokens"] == (40 if fused else 0)
               and r.attrs["tokens"] == 40 for r in spans)


@pytest.mark.gpu
@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_ssd_kernel_matches_plain(cuda, shape, S):
    """y and the final state at TOL of the plain version, bf16 x, B and C;
    an S below 128 is one masked chunk, 3,000 and 3,840 end ragged."""
    args, kw = _inputs(cuda, shape, S)
    y, hs = ssd_scan(*args, **kw)
    want_y, want_hs = ssm._ssd_plain(*args, **kw)
    torch.cuda.synchronize()
    assert y.shape == want_y.shape and hs.shape == want_hs.shape
    _close(y, want_y)
    _close(hs, want_hs)


@pytest.mark.gpu
def test_ssd_kernel_f32_and_batch(cuda):
    """f32 x, B and C (an f32 model's prefill) over two rows."""
    args, kw = _inputs(cuda, "zamba2-7b", 700, torch.float32, seed=3, B=2)
    y, hs = ssd_scan(*args, **kw)
    want_y, want_hs = ssm._ssd_plain(*args, **kw)
    _close(y, want_y)
    _close(hs, want_hs)


@pytest.mark.gpu
def test_ssd_kernel_is_deterministic_and_counted(cuda):
    """Two runs give equal bits (no atomics); a call counts its three
    kernels."""
    args, kw = _inputs(cuda, "zamba2-7b", 3000, seed=1)
    n = ssd_scan.launches
    a = ssd_scan(*args, **kw)
    assert ssd_scan.launches == n + 3
    b = ssd_scan(*args, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _extra_bytes(fn, args, kw) -> int:
    """Peak bytes one call allocates above its inputs and its outputs."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    y, hs = fn(*args, **kw)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base - y.nbytes - hs.nbytes


@pytest.mark.gpu
def test_ssd_kernel_memory_ceiling(cuda):
    """One 3,072-token layer of zamba2-7b: the kernels' scratch (the chunk
    states, 44 MB, and the log-decays) stays under 64 MB; the plain
    version's (its (chunk, head, 128, 128) decay and weights and their
    copies) is printed beside it."""
    args, kw = _inputs(cuda, "zamba2-7b", 3072, seed=2)
    kernel = _extra_bytes(ssd_scan, args, kw)
    plain = _extra_bytes(ssm._ssd_plain, args, kw)
    print(f"ssd scratch at 3072 tokens: kernels {kernel} B, plain {plain} B")
    assert 0 < kernel < CEILING
    assert plain > CEILING


@pytest.mark.gpu
def test_gradient_goes_through_the_plain_version(cuda):
    """A CUDA mixer whose inputs ask for a gradient runs ``_ssd_plain`` (no
    kernel launch) and its gradient flows; the same call under no_grad
    launches the kernels."""
    cfg = dataclasses.replace(_published(), n_layers=1, d_model=256,
                              hybrid_layer_ids=())
    g = torch.Generator(device=cuda).manual_seed(4)
    p = {k: v.float().requires_grad_()
         for k, v in ssm.init_mamba2(g, cfg, torch.float32,
                                     device=cuda).items()}
    x = torch.randn((2, 300, cfg.d_model), generator=g, device=cuda,
                    requires_grad=True)
    n = ssd_scan.launches
    out, st = ssm.mamba2_block(cfg, p, x, return_state=True)
    out.square().mean().backward()
    assert ssd_scan.launches == n and not st["fused"]
    for t in (x.grad, p["A_log"].grad, p["in_proj"].grad):
        assert t is not None and bool(torch.isfinite(t).all())
        assert float(t.abs().max()) > 0
    with torch.no_grad():
        fused, st = ssm.mamba2_block(cfg, p, x, return_state=True)
    assert ssd_scan.launches == n + 3 and st["fused"]
    _close(fused, out.detach())


def _prompt(cfg, S: int, device) -> torch.Tensor:
    rng = np.random.default_rng(7)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (1, S))).to(device)


@pytest.mark.gpu
def test_prefill_and_decode_through_the_kernels(cuda, monkeypatch):
    """The published block at 8 layers (applications before layers 2 and
    5) in bf16: a 1,000-token prefill and 32 greedy decode steps through the
    kernels, and the same tokens fed to the model with ``_ssd_plain`` (and
    so ``_ssd_scan``) patched in: at every position the kernels' token lies
    within the cell's gap limit of the plain run's best logit. The first
    layer's state (same input in both runs) agrees at TOL."""
    cfg = dataclasses.replace(_published(), n_layers=8,
                              hybrid_layer_ids=(2, 5))
    model = M.init_params(cfg, 0, device=cuda)
    S, steps = 1000, 32
    toks = _prompt(cfg, S, cuda)

    def run(feed=None):
        out, picked = [], []
        with torch.no_grad():
            logits, state = M.prefill(cfg, model, {"tokens": toks}, S + steps)
            first = state["ssm"][0].clone()
            for i in range(steps + 1):
                out.append(logits[:, -1].float())
                picked.append(int(logits[0, -1].argmax()))
                if i == steps:
                    break
                nxt = picked[-1] if feed is None else feed[i]
                logits, state = M.decode_step(
                    cfg, model, state,
                    torch.tensor([[nxt]], dtype=torch.long, device=cuda))
        return out, picked, first

    n = ssd_scan.launches
    fused, tokens, first = run()
    assert ssd_scan.launches == n + 3 * cfg.n_layers
    monkeypatch.setattr(ssm, "_fused", lambda *ts: False)
    plain, _, first_plain = run(feed=tokens)
    assert ssd_scan.launches == n + 3 * cfg.n_layers
    gaps = [float(p[0].max() - p[0, t]) for p, t in zip(plain, tokens)]
    assert max(gaps) < GAP_LIMIT, gaps
    _close(first, first_plain)


@pytest.mark.gpu
def test_prefill_states_agree_in_f32(cuda, monkeypatch):
    """The same model in f32 (the decode-vs-prefill check's dtype): every
    layer's post-prefill SSM state through the kernels at TOL of the plain
    run's."""
    cfg = dataclasses.replace(_published(), n_layers=8,
                              hybrid_layer_ids=(2, 5), dtype="float32")
    model = M.init_params(cfg, 0, device=cuda)
    toks = _prompt(cfg, 1000, cuda)
    with torch.no_grad():
        _, fused = M.prefill(cfg, model, {"tokens": toks}, 1024)
        monkeypatch.setattr(ssm, "_fused", lambda *ts: False)
        _, plain = M.prefill(cfg, model, {"tokens": toks}, 1024)
    assert fused["ssm"].shape[0] == cfg.n_layers
    for a, b in zip(fused["ssm"], plain["ssm"]):
        _close(a, b)
