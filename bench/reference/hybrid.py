"""Plain reference of the published Zamba2 block that the zamba2-7b
configuration runs (``bench/configs/zamba2-7b.json`` states its equations
and departures): f32 throughout, TF32 off, one layer at a time, no kernels,
no cache, no batching. It imports nothing of the program: it reads the
benchmark's weights by name (``embed.tok``, ``final_norm``,
``layers.<i>.{norm, mamba.{in_proj, conv_w, conv_b, A_log, dt_bias, D,
norm, out_proj}}``, ``blocks.<b>.{ln, attn.{wq, wk, wv, wo}, ln2,
mlp.{fc1, fc2}}``, ``apps.<k>.{linear, adapter_in, adapter_out}``, each
projection ``(d_in, d_out)``, ``conv_w`` ``(K, channels)``) and computes
from the tokens.

With ``e`` the token embedding and ``h = e``, layer i = 0 .. L-1 runs:
where i is the k-th entry of ``hybrid_layer_ids``, first block ``b = k mod
num_mem_blocks``: ``a = norm(concat[h, e])``; q, k, v ``= a W`` with RoPE
on the two halves of each head; causal softmax attention scaled by ``(hd /
2) ** -0.5``; ``o = attn W_o``; ``m = norm(o)``; ``g, u`` the halves of
``m fc1 + (m A_k) B_k``; ``t = ((act(g) * u) fc2) linear_k``. Then the
Mamba2 layer: ``h += mamba2(norm(h + t))`` (``t = 0`` where no block ran).
Mamba2: ``in_proj`` to ``[z, xBC, dt]``; a causal depthwise conv with bias
over xBC, then SiLU; ``x, B, C`` with B and C of G groups of N;
``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the SSD recurrence
``s_t = exp(dt_t A) s_{t-1} + dt_t x_t B_t^T``, ``y_t = s_t C_t + D x_t``,
head j reading group ``j // (H / G)``; ``y * silu(z)`` normed over each
group's d_inner / G channels; ``out_proj``. Logits: ``norm(h) @ tok^T``
over the first ``vocab`` columns. RMSNorm: ``x / sqrt(mean(x^2) + eps) *
(1 + gain)``.

The SSD is computed chunk by chunk, the state carried between chunks
(:func:`ssd`); ``tests/`` hold it to the step-by-step recurrence.

``quant="fp8"`` is the control: every product with a weight computed from
float8 (e4m3) operands, the weight scaled per output column and the
activation per row.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def exact_f32():
    """TF32 off for the reference's products (restored after)."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with a scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(a: torch.Tensor, w: torch.Tensor, quant: str | None) -> torch.Tensor:
    w = w.float()
    if quant == "fp8":
        return _fp8(a, -1) @ _fp8(w, 0)
    if quant is not None:
        raise ValueError(f"unknown quant {quant!r}")
    return a @ w


def _norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * (1.0 + gain.float())


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (S, H, hd) at positions 0..S-1."""
    S, hd = x.shape[0], x.shape[-1]
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, scale: float, q_chunk: int = 1024) -> torch.Tensor:
    """Causal attention over (S, H, hd) f32, KV head ``h // (Hq / Hkv)``;
    queries in chunks of rows."""
    S, Hq, _ = q.shape
    G = Hq // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    out = torch.empty(S, Hq, v.shape[-1], dtype=q.dtype, device=q.device)
    pos = torch.arange(S, device=q.device)
    for i in range(0, S, q_chunk):
        j = min(S, i + q_chunk)
        s = torch.einsum("qhd,khd->hqk", q[i:j], k[:j]) * scale
        s = s.masked_fill(pos[None, :j] > pos[i:j, None], float("-inf"))
        out[i:j] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v[:j])
    return out


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """The SSD recurrence of one sequence, chunk by chunk: ``x`` (S, H, P),
    ``dt`` (S, H), ``A`` (H,) (negative), ``Bm`` / ``Cm`` (S, G, N), head j
    reading group ``j // (H / G)``. Returns ``y_t = s_t C_t`` (S, H, P),
    without the ``D x`` term. Inside a chunk the outputs are the masked
    quadratic form ``y_t = sum_{s <= t} exp(c_t - c_s) (C_t . B_s) dt_s
    x_s`` (``c`` the chunk's cumulative ``dt A``) plus the carried state
    seen from t, ``exp(c_t) s C_t``; the state then moves to the chunk's
    end."""
    S, H, P = x.shape
    G, N = Bm.shape[1:]
    Bh = Bm.repeat_interleave(H // G, dim=1)                  # (S, H, N)
    Ch = Cm.repeat_interleave(H // G, dim=1)
    state = torch.zeros(H, P, N, dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(S, c0 + chunk))
        cum = torch.cumsum(dt[sl] * A, dim=0)                  # (Q, H)
        Q = cum.shape[0]
        seg = cum[:, None, :] - cum[None, :, :]                # (t, s, H)
        keep = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(seg.masked_fill(~keep[..., None], float("-inf")))
        cb = torch.einsum("thn,shn->tsh", Ch[sl], Bh[sl])
        y[sl] = torch.einsum("tsh,shp->thp", cb * decay * dt[sl][None],
                             x[sl])
        y[sl] += torch.exp(cum)[..., None] \
            * torch.einsum("thn,hpn->thp", Ch[sl], state)
        to_end = torch.exp(cum[-1][None] - cum) * dt[sl]       # (Q, H)
        state = torch.exp(cum[-1])[:, None, None] * state \
            + torch.einsum("sh,shp,shn->hpn", to_end, x[sl], Bh[sl])
    return y


def mamba2(w: dict, p: str, x: torch.Tensor, dims: dict,
           quant: str | None = None) -> torch.Tensor:
    """The Mamba2 mixer of layer prefix ``p`` on its normed input (S, d)."""
    S = x.shape[0]
    d_in, H, P = dims["d_inner"], dims["ssm_heads"], dims["ssm_head_dim"]
    G, N = dims["ngroups"], dims["ssm_state"]
    proj = _mm(x, w[p + "in_proj"], quant)
    z, xbc, dt = torch.split(proj, [d_in, d_in + 2 * G * N, H], dim=-1)
    cw = w[p + "conv_w"].float()                               # (K, C)
    K = cw.shape[0]
    xp = torch.cat([xbc.new_zeros(K - 1, xbc.shape[1]), xbc])
    conv = sum(xp[i:i + S] * cw[i] for i in range(K)) \
        + w[p + "conv_b"].float()
    xs, Bm, Cm = torch.split(F.silu(conv), [d_in, G * N, G * N], dim=-1)
    dt = F.softplus(dt + w[p + "dt_bias"].float())
    A = -torch.exp(w[p + "A_log"].float())
    xh = xs.view(S, H, P)
    y = ssd(xh, dt, A, Bm.view(S, G, N), Cm.view(S, G, N)) \
        + w[p + "D"].float()[:, None] * xh
    y = (y.reshape(S, d_in) * F.silu(z)).view(S, G, d_in // G)
    y = _norm(y, w[p + "norm"].view(G, d_in // G), dims["norm_eps"])
    return _mm(y.reshape(S, d_in), w[p + "out_proj"], quant)


def shared_block(w: dict, k: int, h: torch.Tensor, e: torch.Tensor,
                 dims: dict, quant: str | None = None) -> torch.Tensor:
    """Application k of its shared block: what it adds to the next Mamba2
    layer's input (S, d)."""
    b = f"blocks.{k % dims['num_mem_blocks']}."
    a = f"apps.{k}."
    S = h.shape[0]
    H, Hkv, hd = dims["n_heads"], dims["n_kv_heads"], dims["hd"]
    n = _norm(torch.cat([h, e], dim=-1), w[b + "ln"], dims["norm_eps"])
    q = _mm(n, w[b + "attn.wq"], quant).view(S, H, hd)
    kk = _mm(n, w[b + "attn.wk"], quant).view(S, Hkv, hd)
    v = _mm(n, w[b + "attn.wv"], quant).view(S, Hkv, hd)
    q, kk = _rope(q, dims["rope_theta"]), _rope(kk, dims["rope_theta"])
    o = _attention(q, kk, v, (hd / 2) ** -0.5).reshape(S, H * hd)
    m = _norm(_mm(o, w[b + "attn.wo"], quant), w[b + "ln2"],
              dims["norm_eps"])
    gu = _mm(m, w[b + "mlp.fc1"], quant) \
        + _mm(_mm(m, w[a + "adapter_in"], quant), w[a + "adapter_out"], quant)
    g, u = gu.chunk(2, dim=-1)
    t = _mm(F.gelu(g) * u, w[b + "mlp.fc2"], quant)
    return _mm(t, w[a + "linear"], quant)


def head(w: dict, x: torch.Tensor, dims: dict,
         quant: str | None = None) -> torch.Tensor:
    """Logits over the first ``vocab`` columns of final-normed ``x``."""
    n = _norm(x, w["final_norm"], dims["norm_eps"])
    table = w["embed.head"] if "embed.head" in w else w["embed.tok"].T
    return _mm(n, table[:, :dims["vocab"]], quant)


@torch.no_grad()
def logits_at(w: dict, dims: dict, tokens: list[int], at: list[int],
              quant: str | None = None) -> torch.Tensor:
    """f32 logits (len(at), vocab) at positions ``at`` of one causal pass
    over ``tokens``: the logits that predict ``tokens[i + 1]`` sit at
    ``i``."""
    dev = w["embed.tok"].device
    apps = {i: k for k, i in enumerate(dims["hybrid_layer_ids"])
            if i < dims["n_layers"]}
    with exact_f32():
        ids = torch.tensor(tokens, dtype=torch.long, device=dev)
        e = w["embed.tok"].float()[ids]
        h = e
        for i in range(dims["n_layers"]):
            x = h
            if i in apps:
                x = h + shared_block(w, apps[i], h, e, dims, quant)
            p = f"layers.{i}."
            h = h + mamba2(w, p + "mamba.",
                           _norm(x, w[p + "norm"], dims["norm_eps"]), dims,
                           quant)
        rows = torch.tensor(at, dtype=torch.long, device=dev)
        return head(w, h[rows], dims, quant)


def dims_of(model: dict) -> dict:
    """The reference's sizes from a configuration file's ``model`` block."""
    d = model["d_model"]
    hd = model.get("head_dim") or d // model["n_heads"]
    d_in = model.get("ssm_expand", 2) * d
    P = model.get("ssm_head_dim", 64)
    return {"n_layers": model["n_layers"], "d_model": d,
            "n_heads": model["n_heads"], "n_kv_heads": model["n_kv_heads"],
            "hd": hd, "d_ff": model["d_ff"], "vocab": model["vocab"],
            "rope_theta": float(model.get("rope_theta", 1e4)),
            "norm_eps": float(model.get("norm_eps", 1e-6)),
            "d_inner": d_in, "ssm_heads": d_in // P, "ssm_head_dim": P,
            "ssm_state": model["ssm_state"],
            "ngroups": model.get("mamba_ngroups", 1),
            "hybrid_layer_ids": list(model["hybrid_layer_ids"]),
            "num_mem_blocks": model.get("num_mem_blocks", 1)}
