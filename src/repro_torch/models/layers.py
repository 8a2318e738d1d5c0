"""Model primitives shared by the ported families.

Plain functions on tensors, one per reference primitive in
``repro.models.layers``, with the same shapes and dtype policy: params and
activations in ``cfg.dtype``, softmax/norm statistics in f32. Sharding hints
are not part of the port yet (the reference's ``hint`` is a no-op without a
mesh).

``attention`` and ``decode_attention`` are the reference's XLA spellings
(chunked GQA, grouped decode), kept for parity tests; the model itself, and
``cross_attention_block`` here, call the kernel ops in
:mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import attention_op

NEG_INF = -1e30
_CHUNK_ELEMS = 1 << 28          # f32 draws above 1 GiB go in slices of dim 0


# --------------------------------------------------------------------- init
def uniform_scale_init(gen: torch.Generator | None, shape: tuple[int, ...],
                       dtype, scale: float = 0.02) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in f32 from ``gen`` on its device. A tensor
    larger than 1 GiB in f32 (deepseek's stacked experts) is drawn slice by
    slice along its first dim, so the f32 draw never exists whole.
    ``gen=None`` gives an empty tensor on the meta device (shapes only)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    n = 1
    for s in shape:
        n *= s
    if n <= _CHUNK_ELEMS or len(shape) < 2:
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device)
        return (scale * x).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    step = max(1, _CHUNK_ELEMS * shape[0] // n)
    for i in range(0, shape[0], step):
        x = torch.randn((min(step, shape[0] - i),) + tuple(shape[1:]),
                        generator=gen, dtype=torch.float32, device=gen.device)
        out[i:i + step] = (scale * x).to(dtype)
    return out


def init_linear(gen: torch.Generator | None, d_in: int, d_out: int, dtype,
                scale: float | None = None) -> torch.Tensor:
    s = scale if scale is not None else 1.0 / d_in ** 0.5
    return uniform_scale_init(gen, (d_in, d_out), dtype, s)


# --------------------------------------------------------------------- norm
def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """f32 statistics; the normalised value is cast to ``x.dtype`` BEFORE the
    ``(1 + gamma)`` product, as the reference does (bf16 parity needs it)."""
    h = x.float()
    var = torch.mean(h * h, dim=-1, keepdim=True)
    return (h * torch.rsqrt(var + eps)).to(x.dtype) * (1.0 + gamma.to(x.dtype))


# --------------------------------------------------------------------- rope
def rope_frequencies(hd: int, theta: float,
                     device: torch.device | None = None) -> torch.Tensor:
    """Inverse frequencies for the even half of the head dim (f32)."""
    half = hd // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate (…, S, H, hd) by per-position angles. ``positions``: (…, S)."""
    hd = x.shape[-1]
    inv = rope_frequencies(hd, theta, x.device)                # (hd/2,)
    ang = positions[..., :, None].float() * inv                # (..., S, hd/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention
def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
               window: int) -> torch.Tensor:
    """Additive mask bias (f32) of shape (…, Sq, Sk); ``window <= 0`` means
    unwindowed."""
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(dq.shape, dk.shape),
                    dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= dk <= dq
    if window > 0:
        ok &= dq - dk < window
    return torch.where(ok, 0.0, NEG_INF).float()


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool = True,
              window: int = 0, q_chunk: int = 512,
              softmax_scale: float | None = None) -> torch.Tensor:
    """GQA attention, computed in query chunks.

    q: (B, Sq, Hq, hd) — k/v: (B, Sk, Hkv, hd), Hq % Hkv == 0; positions are
    absolute. KV heads are expanded to Hq; scores are f32, and the
    probabilities are cast to ``v.dtype`` before the PV product (where bf16
    rounds differently from the kernels, which stay in f32).
    """
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    if G > 1:
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)

    def chunk_attn(q_c: torch.Tensor, qp_c: torch.Tensor) -> torch.Tensor:
        s = torch.einsum("bchd,bshd->bhcs", q_c.float(), k.float()) * scale
        s = s + _mask_bias(qp_c, k_pos, causal=causal,
                           window=window)[:, None, :, :]
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhcs,bshd->bchd", p.to(v.dtype), v)

    outs = [chunk_attn(q[:, i:i + q_chunk], q_pos[:, i:i + q_chunk])
            for i in range(0, Sq, q_chunk)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(B, Sq, Hq, v.shape[-1])


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, q_pos: torch.Tensor,
                     window: int = 0,
                     softmax_scale: float | None = None) -> torch.Tensor:
    """Single-position attention against a (possibly longer) KV cache.

    q: (B, 1, Hq, hd); caches: (B, S, Hkv, hd); q_pos: (B,) absolute position.
    Entries with k_pos > q_pos (unwritten cache slots) are masked out.
    Grouped form throughout (no kv expansion).
    """
    B, _, Hq, hd = q.shape
    S = k_cache.shape[1]
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    k_pos = torch.arange(S, device=q.device)[None, :]
    qg = q.reshape(B, Hkv, G, hd)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_cache.float()) * scale
    ok = k_pos <= q_pos[:, None]
    if window > 0:
        ok &= q_pos[:, None] - k_pos < window
    s = s + torch.where(ok, 0.0, NEG_INF)[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, 1, Hq, v_cache.shape[-1])


# --------------------------------------------------------------------- GQA block
@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    n_heads: int
    n_kv_heads: int
    hd: int


def init_attn(gen: torch.Generator | None, dims: AttnDims, dtype,
              n_layers: int = 1) -> dict[str, torch.Tensor]:
    d, H, Hkv, hd = dims.d_model, dims.n_heads, dims.n_kv_heads, dims.hd
    out_scale = 1.0 / (H * hd) ** 0.5 / (2.0 * n_layers) ** 0.5
    return {"wq": init_linear(gen, d, H * hd, dtype),
            "wk": init_linear(gen, d, Hkv * hd, dtype),
            "wv": init_linear(gen, d, Hkv * hd, dtype),
            "wo": init_linear(gen, H * hd, d, dtype, scale=out_scale)}


def cross_kv(p, kv_src: torch.Tensor,
             dims: AttnDims) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention keys and values of an encoder output / patch batch:
    (B, Sk, Hkv, hd) each, no rope."""
    B, Sk, _ = kv_src.shape
    k = (kv_src @ p["wk"]).reshape(B, Sk, dims.n_kv_heads, dims.hd)
    v = (kv_src @ p["wv"]).reshape(B, Sk, dims.n_kv_heads, dims.hd)
    return k, v


def cross_attend(p, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 dims: AttnDims) -> torch.Tensor:
    """The query side of cross attention against precomputed ``k``/``v``:
    no rope and no mask (the reference's zero positions with
    ``causal=False``), through the flash-attention op."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, dims.n_heads, dims.hd)
    o = attention_op(q, k, v, causal=False)
    return o.reshape(B, S, dims.n_heads * dims.hd) @ p["wo"]


def cross_attention_block(p, x: torch.Tensor, kv_src: torch.Tensor,
                          dims: AttnDims) -> torch.Tensor:
    """Encoder-decoder / VLM cross attention (no rope, no mask)."""
    k, v = cross_kv(p, kv_src, dims)
    return cross_attend(p, x, k, v, dims)


# ----------------------------------------------------------------------- MLP
def init_mlp(gen: torch.Generator | None, d: int, d_ff: int, dtype,
             n_layers: int = 1, gated: bool = True) -> dict[str, torch.Tensor]:
    out_scale = 1.0 / d_ff ** 0.5 / (2.0 * n_layers) ** 0.5
    p = {"w1": init_linear(gen, d, d_ff, dtype),
         "w2": init_linear(gen, d_ff, d, dtype, scale=out_scale)}
    if gated:
        p["w3"] = init_linear(gen, d, d_ff, dtype)
    return p


def mlp_block(p, x: torch.Tensor) -> torch.Tensor:
    """Gated SiLU MLP when ``w3`` is present, else tanh-GELU (the reference's
    ``jax.nn.gelu`` default)."""
    if "w3" in p:
        return (F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]
    return F.gelu(x @ p["w1"], approximate="tanh") @ p["w2"]


# ------------------------------------------------------------------ embedding
def embed_tokens(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens]


def unembed(p, h: torch.Tensor) -> torch.Tensor:
    w = p["head"] if "head" in p else p["tok"].T
    return h @ w


# -------------------------------------------------------------------- losses
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 ignore_id: int = -1) -> torch.Tensor:
    """Mean next-token cross entropy in f32; ``labels`` already shifted."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp(min=0)[..., None].long())[..., 0]
    mask = (labels != ignore_id).float()
    return torch.sum((lse - gold) * mask) / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------- kv caches
def cache_update(cache_k: torch.Tensor, cache_v: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor,
                 pos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Write one step (B, 1, ...) at per-batch position ``pos`` (B,) into
    caches (B, S, ...) — GQA's (B, S, Hkv, hd) or MLA's latent (B, S, c) —
    IN PLACE, and return the two caches.

    A row whose ``pos`` lies outside ``[0, S)`` is dropped, as JAX drops an
    out-of-range scatter (an idle serving slot's position runs past the
    cache). The write is branch-free and never synchronises with the device:
    an out-of-range row rewrites the value already at its clamped index.
    """
    B, S = cache_k.shape[:2]
    bidx = torch.arange(B, device=cache_k.device)
    ok = ((pos >= 0) & (pos < S)).reshape((B,) + (1,) * (k.ndim - 2))
    idx = pos.clamp(0, S - 1).long()
    cache_k[bidx, idx] = torch.where(ok, k[:, 0], cache_k[bidx, idx])
    cache_v[bidx, idx] = torch.where(ok, v[:, 0], cache_v[bidx, idx])
    return cache_k, cache_v
