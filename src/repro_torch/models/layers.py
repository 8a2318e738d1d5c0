"""Model primitives shared by the ported families.

Plain functions on tensors, one per reference primitive in
``repro.models.layers``, with the same shapes and dtype policy: params and
activations in ``cfg.dtype``, softmax/norm statistics in f32. The
reference's sharding hints sit at the same sites (``dist.hints.hint``: the
argument itself outside ``sharding_rules``; under rules a DTensor is
redistributed and a plain tensor passes through); at the kernel ops the
kernel's inputs and output are hinted, never inside the wrapper.

``attention`` and ``decode_attention`` are the reference's XLA spellings
(chunked GQA, grouped decode), kept for parity tests; the model itself, and
``cross_attention_block`` here, call the kernel ops in
:mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.dist.hints import hint, tp_divides
from repro_torch.dist.sharding import (gather_dim, local_along, local_offset,
                                       shards)
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
    if not tp_divides(Hq):
        # heads can't shard on model -> q shards on SEQ ('sq'): one
        # seq-sharded piece instead of a chunk loop that re-cuts it
        q_chunk = max(q_chunk, Sq)
    q = hint(q, "dp", "sq", "tp", None)
    if G > 1:
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    k = hint(k, "dp", "sp", "tp", None)
    v = hint(v, "dp", "sp", "tp", None)

    def chunk_attn(q_c: torch.Tensor, qp_c: torch.Tensor) -> torch.Tensor:
        s = torch.einsum("bchd,bshd->bhcs", q_c.float(), k.float()) * scale
        s = hint(s, "dp", "tp", "sq", None)
        s = s + _mask_bias(qp_c, k_pos, causal=causal,
                           window=window)[:, None, :, :]
        p = torch.softmax(s, dim=-1)
        return hint(torch.einsum("bhcs,bshd->bchd", p.to(v.dtype), v),
                    "dp", "sq", "tp", None)

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
    kv_tp = tp_divides(Hkv)   # can the STORED cache shard its kv heads?
    qg = q.reshape(B, Hkv, G, hd)
    if kv_tp:                 # heads-local: cache kv -> model
        qg = hint(qg, "dp", "tp", None, None)
        k_cache = hint(k_cache, "dp", "sp", "tp", None)
        v_cache = hint(v_cache, "dp", "sp", "tp", None)
    else:                     # the cache lives seq-sharded
        qg = hint(qg, "dp", None, None, None)
        k_cache = hint(k_cache, "dp", "seq", None, None)
        v_cache = hint(v_cache, "dp", "seq", None, None)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_cache.float()) * scale
    s = hint(s, "dp", "tp", None, None) if kv_tp \
        else hint(s, "dp", None, None, "seq")
    ok = k_pos <= q_pos[:, None]
    if window > 0:
        ok &= q_pos[:, None] - k_pos < window
    s = s + torch.where(ok, 0.0, NEG_INF)[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, 1, Hq, v_cache.shape[-1])


# --------------------------------------------------------------------- GQA block
def split_heads(x: torch.Tensor, H: int, hd: int) -> torch.Tensor:
    """(…, H * hd) as (…, H, hd). A DTensor whose last dim is sharded into
    a number of blocks that H does not divide is gathered along it first:
    DTensor cannot cut a head across ranks (XLA reshards it silently)."""
    if isinstance(x, DTensor) and H % shards(x, x.ndim - 1):
        x = gather_dim(x, x.ndim - 1)
    return x.reshape(*x.shape[:-1], H, hd)



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


def merge_heads(o: torch.Tensor) -> torch.Tensor:
    """(…, H, hd) as (…, H * hd). On a DTensor the gradient is split back
    into heads through :func:`split_heads`, which gathers a dim whose
    blocks would cut a head (DTensor's own view backward raises there)."""
    if isinstance(o, DTensor):
        return _MergeHeads.apply(o)
    return o.reshape(*o.shape[:-2], -1)


class _MergeHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, o):
        ctx.heads = tuple(o.shape[-2:])
        return o.reshape(*o.shape[:-2], -1)

    @staticmethod
    def backward(ctx, g):
        return split_heads(g, *ctx.heads)


def cross_kv(p, kv_src: torch.Tensor,
             dims: AttnDims) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention keys and values of an encoder output / patch batch:
    (B, Sk, Hkv, hd) each, no rope."""
    k = split_heads(kv_src @ p["wk"], dims.n_kv_heads, dims.hd)
    v = split_heads(kv_src @ p["wv"], dims.n_kv_heads, dims.hd)
    return k, v


def cross_attend(p, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 dims: AttnDims) -> torch.Tensor:
    """The query side of cross attention against precomputed ``k``/``v``:
    no rope and no mask (the reference's zero positions with
    ``causal=False``), through the flash-attention op."""
    q = hint(split_heads(x @ p["wq"], dims.n_heads, dims.hd),
             "dp", "sq", "tp", None)
    k = hint(k, "dp", "sp", "tp", None)
    v = hint(v, "dp", "sp", "tp", None)
    o = hint(attention_op(q, k, v, causal=False), "dp", "sq", "tp", None)
    return merge_heads(o) @ p["wo"]


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
    roles = ("dp",) + (None,) * (x.ndim - 2) + ("tp",)
    if "w3" in p:
        h = hint(F.silu(x @ p["w1"]) * (x @ p["w3"]), *roles)
        return h @ p["w2"]
    return hint(F.gelu(x @ p["w1"], approximate="tanh"), *roles) @ p["w2"]


# ------------------------------------------------------------------ embedding
def embed_tokens(p, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings ``tok[tokens]``; a DTensor table goes through
    :func:`_vocab_parallel_embed`."""
    tok = p["tok"]
    if isinstance(tok, DTensor):
        return _vocab_parallel_embed(tokens, tok)
    return tok[tokens]


def _vocab_parallel_embed(tokens, tok):
    """Megatron's vocab-parallel lookup: the table's model dim is gathered
    (FSDP's weight gather) and its vocab shards kept; each rank looks up
    the tokens in its rows (zeros elsewhere) on its batch shard, and the
    output is a partial sum over the vocab ranks. Runs under ``local_map``
    on plain local tensors: no DTensor strategy of an indexed read or of
    its gradient (an accumulating ``index_put``, which has none that works
    in some releases) is needed."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = tok.device_mesh
    if not isinstance(tokens, DTensor):       # the same on every rank
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    tok = gather_dim(tok, 1)
    lo = local_offset(tok, 0)
    out_pl, grad_pl = [], []
    for wp, tp in zip(tok.placements, tokens.placements):
        vocab = getattr(wp, "dim", None) == 0
        if vocab and not isinstance(tp, Replicate):
            raise NotImplementedError("embedding: tokens sharded on the "
                                      "vocab's mesh dim")
        out_pl.append(Partial() if vocab else tp)
        grad_pl.append(Partial() if not isinstance(tp, Replicate) else wp)

    def local(t, w):
        idx = t - lo
        ok = (idx >= 0) & (idx < w.shape[0])
        return w[idx.clamp(0, w.shape[0] - 1)] * ok[..., None].to(w.dtype)

    return local_map(local, out_placements=(tuple(out_pl),),
                     in_placements=(tuple(tokens.placements),
                                    tuple(tok.placements)),
                     in_grad_placements=(tuple(tokens.placements),
                                         tuple(grad_pl)),
                     device_mesh=mesh)(tokens, tok)


def unembed(p, h: torch.Tensor) -> torch.Tensor:
    """The logits ``h @ head`` (``tok.T`` when tied). A DTensor head's
    contraction dim is gathered first (FSDP's weight gather), its vocab
    shards kept, so the product splits the tokens and the vocab and no
    rank holds all the tokens' logits."""
    w = p["head"] if "head" in p else p["tok"].T
    if isinstance(w, DTensor):
        w = gather_dim(w, 0)
    return h @ w


# -------------------------------------------------------------------- losses
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 ignore_id: int = -1) -> torch.Tensor:
    """Mean next-token cross entropy in f32; ``labels`` already shifted.
    Logits whose vocab is split across ranks (DTensor) take the
    log-sum-exp spelled out (max, then the sum of exponentials), which
    reduces across the ranks instead of gathering the logits, and the gold
    logit picked on each rank's own columns (:func:`_vocab_parallel_pick`);
    both partial sums are all-reduced onto the rows' placements (a
    reduce-scatter over the rows would carry their gradients back through
    an all-to-all of the vocab-wide ones)."""
    lf = logits.float()
    idx = labels.clamp(min=0)[..., None].long()
    if isinstance(lf, DTensor):
        last = lf.ndim - 1
        rows = [Replicate() if getattr(p, "dim", None) == last else p
                for p in lf.placements]
        if shards(lf, last) > 1:
            m = lf.amax(dim=-1, keepdim=True).detach()
            se = torch.exp(lf - m).sum(dim=-1).redistribute(
                lf.device_mesh, rows)
            lse = torch.log(se) + m[..., 0]
        else:
            lse = torch.logsumexp(lf, dim=-1)
        gold = _vocab_parallel_pick(lf, idx).redistribute(lf.device_mesh,
                                                          rows)
    else:
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, idx)[..., 0]
    mask = (labels != ignore_id).float()
    return torch.sum((lse - gold) * mask) / torch.clamp(mask.sum(), min=1.0)


def _vocab_parallel_pick(lf, idx):
    """``lf``'s value at column ``idx`` (…, 1) of each row, each rank
    picking from its own vocab columns (zero elsewhere): a partial sum over
    the vocab ranks, under ``local_map``."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = lf.device_mesh
    last = lf.ndim - 1
    idx = idx.redistribute(mesh, [Replicate() if getattr(pl, "dim", None)
                                  == last else pl for pl in lf.placements])
    lo = local_offset(lf, last)
    out_pl = tuple(Partial() if getattr(pl, "dim", None) == last else pl
                   for pl in lf.placements)

    def local(x, i):
        j = i - lo
        ok = (j >= 0) & (j < x.shape[-1])
        return (torch.gather(x, -1, j.clamp(0, x.shape[-1] - 1))
                * ok.to(x.dtype))[..., 0]

    return local_map(local, out_placements=(out_pl,),
                     in_placements=(tuple(lf.placements),
                                    tuple(idx.placements)),
                     in_grad_placements=(tuple(lf.placements),
                                         tuple(idx.placements)),
                     device_mesh=mesh)(lf, idx)


# ---------------------------------------------------------------- kv caches
def write_rows(cache: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``cache[:, :S] = x`` for ``x`` (B, S, ...), IN PLACE: on a DTensor
    cache each rank writes the rows of ``x`` that fall in its block of the
    cache's rows. Returns the cache."""
    S = x.shape[1]
    if not isinstance(cache, DTensor):
        cache[:, :S] = x
        return cache
    off = local_offset(cache, 1)
    local = cache.to_local()
    lo, hi = max(off, 0), min(off + local.shape[1], S)
    if hi > lo:
        xl = local_along(cache, x, set(range(x.ndim)) - {1})
        local[:, lo - off:hi - off] = xl[:, lo:hi]
    return cache


def write_state(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst.copy_(src)``, IN PLACE (a recurrent state of the same shape):
    on a DTensor ``dst`` each rank writes its block of ``src``, taken where
    ``dst``'s block lies (no gather). Returns ``dst``."""
    if not isinstance(dst, DTensor):
        return dst.copy_(src)
    dst.to_local().copy_(local_along(dst, src, set(range(src.ndim))))
    return dst


def cache_update(cache_k: torch.Tensor, cache_v: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor,
                 pos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Write one step (B, 1, ...) at per-batch position ``pos`` (B,) into
    caches (B, S, ...) — GQA's (B, S, Hkv, hd) or MLA's latent (B, S, c) —
    IN PLACE, and return the two caches.

    A row whose ``pos`` lies outside ``[0, S)`` is dropped, as JAX drops an
    out-of-range scatter (an idle serving slot's position runs past the
    cache). The write is branch-free and never synchronises with the device:
    an out-of-range row rewrites the value already at its clamped index. On
    DTensor caches each rank writes into its block of the rows, at ``pos``
    less the block's first row.
    """
    if isinstance(cache_k, DTensor):
        off = local_offset(cache_k, 1)
        rest = set(range(k.ndim)) - {1}
        _update_rows(cache_k.to_local(), cache_v.to_local(),
                     local_along(cache_k, k, rest),
                     local_along(cache_v, v, rest),
                     local_along(cache_k, pos, {0}) - off)
        return cache_k, cache_v
    _update_rows(cache_k, cache_v, k, v, pos)
    return cache_k, cache_v


def _update_rows(cache_k, cache_v, k, v, pos) -> None:
    B, S = cache_k.shape[:2]
    bidx = torch.arange(B, device=cache_k.device)
    ok = ((pos >= 0) & (pos < S)).reshape((B,) + (1,) * (k.ndim - 2))
    idx = pos.clamp(0, S - 1).long()
    cache_k[bidx, idx] = torch.where(ok, k[:, 0], cache_k[bidx, idx])
    cache_v[bidx, idx] = torch.where(ok, v[:, 0], cache_v[bidx, idx])
