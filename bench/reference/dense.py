"""Plain reference of the dense GQA decoder that the granite-3-2b
configuration runs (``bench/configs/granite-3-2b.json`` states its
equations): f32 throughout, TF32 off, one layer at a time, no kernels, no
cache, no batching. It imports nothing of the program: it reads the
benchmark's weights by name (``embed.tok``, ``embed.head``, ``final_norm``,
``blocks.<l>.{ln1, ln2, attn.{wq, wk, wv, wo}, mlp.{w1, w2, w3}}``, each
projection ``(d_in, d_out)``) and computes from the tokens.

The layer: ``x += attn(norm(x))``; ``x += w2(silu(w1 n) * w3 n)`` with
``n = norm(x)``; RMSNorm ``x / sqrt(mean(x^2) + eps) * (1 + gain)``; RoPE
on the two halves of each head (``theta ** (-i / (hd / 2))``); causal
softmax attention scaled by ``hd ** -0.5``, query head ``h`` reading KV
head ``h // (Hq / Hkv)``; logits ``norm(x) @ head`` over the first
``vocab`` columns.

``quant="fp8"`` is the control: every product with a weight computed from
float8 (e4m3) operands, the weight scaled per output column and the
activation per row.
"""

from __future__ import annotations

import contextlib

import torch


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
    """x: (..., S, H, hd) at positions 0..S-1."""
    S, hd = x.shape[-3], x.shape[-1]
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, q_chunk: int) -> torch.Tensor:
    """Causal GQA over (B, S, H, hd) f32; queries in chunks of rows."""
    B, S, Hq, hd = q.shape
    G = Hq // k.shape[2]
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    out = torch.empty_like(q)
    pos = torch.arange(S, device=q.device)
    for i in range(0, S, q_chunk):
        j = min(S, i + q_chunk)
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, i:j], k[:, :j]) * hd ** -0.5
        s = s.masked_fill(pos[None, :j] > pos[i:j, None], float("-inf"))
        out[:, i:j] = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1),
                                   v[:, :j])
    return out


def layer(w: dict, l: int, x: torch.Tensor, dims: dict,
          quant: str | None = None, q_chunk: int = 1024) -> torch.Tensor:
    """One decoder layer on f32 ``x`` (B, S, d)."""
    p = f"blocks.{l}."
    H, Hkv, hd = dims["n_heads"], dims["n_kv_heads"], dims["hd"]
    B, S, _ = x.shape
    n = _norm(x, w[p + "ln1"], dims["norm_eps"])
    q = _mm(n, w[p + "attn.wq"], quant).view(B, S, H, hd)
    k = _mm(n, w[p + "attn.wk"], quant).view(B, S, Hkv, hd)
    v = _mm(n, w[p + "attn.wv"], quant).view(B, S, Hkv, hd)
    q, k = _rope(q, dims["rope_theta"]), _rope(k, dims["rope_theta"])
    o = _attention(q, k, v, q_chunk).reshape(B, S, H * hd)
    x = x + _mm(o, w[p + "attn.wo"], quant)
    n = _norm(x, w[p + "ln2"], dims["norm_eps"])
    g = torch.nn.functional.silu(_mm(n, w[p + "mlp.w1"], quant)) \
        * _mm(n, w[p + "mlp.w3"], quant)
    return x + _mm(g, w[p + "mlp.w2"], quant)


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
    with exact_f32():
        ids = torch.tensor(tokens, dtype=torch.long, device=dev)
        x = w["embed.tok"].float()[ids][None]
        for l in range(dims["n_layers"]):
            x = layer(w, l, x, dims, quant)
        rows = torch.tensor(at, dtype=torch.long, device=dev)
        return head(w, x[0, rows], dims, quant)


def dims_of(model: dict) -> dict:
    """The reference's sizes from a configuration file's ``model`` block."""
    hd = model.get("head_dim") or model["d_model"] // model["n_heads"]
    return {"n_layers": model["n_layers"], "d_model": model["d_model"],
            "n_heads": model["n_heads"], "n_kv_heads": model["n_kv_heads"],
            "hd": hd, "d_ff": model["d_ff"], "vocab": model["vocab"],
            "rope_theta": float(model.get("rope_theta", 1e4)),
            "norm_eps": float(model.get("norm_eps", 1e-6))}
