"""Multi-head Latent Attention (DeepSeek-V3), the port of ``repro.models.mla``.

Prefill: the latent ``c_kv`` is expanded to per-head keys/values (standard
formulation) and attended through the flash-attention op. The reference calls
its attention with q/k head dim ``dqk = nope + rope`` (192) and v head dim
``dv`` (128); the kernel takes one head dim for q, k and v, so V is
zero-padded to ``dqk`` columns, the scale ``dqk ** -0.5`` is passed
explicitly, and the output is cut back to ``dv`` columns — the same function
(the padded columns of P V are zeros that nobody reads).

Decode: the **absorbed** formulation — queries are folded through ``W_uk``
into latent space, so the per-token cache is only ``kv_lora_rank +
rope_dim`` values (576 at deepseek-v3's width) and attention runs directly
against the latent cache, in torch matmuls as in the reference (the latent
width is past the decode kernel's 256 columns). The cache rows are written
IN PLACE (an out-of-range position is dropped, as JAX drops it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.hints import hint
from repro_torch.kernels.ops import attention_op
from repro_torch.models.layers import (NEG_INF, apply_rope, cache_update,
                                       init_linear, merge_heads, rms_norm,
                                       split_heads)


def init_mla(gen: torch.Generator | None, cfg: ModelConfig, dtype,
             n_layers: int = 1, *, device=None) -> dict[str, torch.Tensor]:
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    dev = "meta" if gen is None else device

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=dev)

    return {
        "wq_a": init_linear(gen, d, m.q_lora_rank, dtype),
        "q_norm": zeros(m.q_lora_rank),
        "wq_b": init_linear(gen, m.q_lora_rank, H * m.qk_head_dim, dtype),
        "wkv_a": init_linear(gen, d, m.kv_lora_rank + m.qk_rope_head_dim,
                             dtype),
        "kv_norm": zeros(m.kv_lora_rank),
        "wkv_b": init_linear(gen, m.kv_lora_rank,
                             H * (m.qk_nope_head_dim + m.v_head_dim), dtype),
        "wo": init_linear(gen, H * m.v_head_dim, d, dtype,
                          scale=1.0 / (H * m.v_head_dim) ** 0.5
                          / (2.0 * n_layers) ** 0.5),
    }


def _queries(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor):
    m, H = cfg.mla, cfg.n_heads
    cq = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    q = split_heads(cq @ p["wq_b"], H, m.qk_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _latents(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor):
    m = cfg.mla
    kv_a = x @ p["wkv_a"]
    c_kv, k_rope = kv_a.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope                        # (B,S,kv_lora), (B,S,rope)


def mla_attention(cfg: ModelConfig, p, x: torch.Tensor,
                  positions: torch.Tensor, *, latents=None) -> torch.Tensor:
    """Full-sequence causal MLA (train / prefill). ``latents`` may carry the
    ``(c_kv, k_rope)`` of ``x`` already computed for the cache."""
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    q_nope, q_rope = _queries(cfg, p, x, positions)
    c_kv, k_rope = latents if latents is not None \
        else _latents(cfg, p, x, positions)
    kv = split_heads(c_kv @ p["wkv_b"], H, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    v = F.pad(v, (0, m.qk_head_dim - m.v_head_dim))      # dv -> dqk columns
    q = hint(q, "dp", "sq", "tp", None)
    k = hint(k, "dp", "sp", "tp", None)
    v = hint(v, "dp", "sp", "tp", None)
    o = hint(attention_op(q, k, v, causal=True,
                          softmax_scale=m.qk_head_dim ** -0.5),
             "dp", "sq", "tp", None)
    return merge_heads(o[..., :m.v_head_dim]) @ p["wo"]


def mla_prefill_cache(cfg: ModelConfig, p, x: torch.Tensor,
                      positions: torch.Tensor, max_seq: int) -> dict:
    """Latent cache for decode, zero-padded to ``max_seq``."""
    S = x.shape[1]
    c_kv, k_rope = _latents(cfg, p, x, positions)
    pad = max_seq - S
    return {"c_kv": F.pad(c_kv, (0, 0, 0, pad)),
            "k_rope": F.pad(k_rope, (0, 0, 0, pad))}


def mla_init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                   device=None) -> dict:
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, max_seq, m.kv_lora_rank), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, max_seq, m.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


def mla_decode(cfg: ModelConfig, p, x: torch.Tensor, cache: dict,
               pos: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Absorbed-form single-token decode. x: (B, 1, d); pos: (B,). Writes
    the new latent row into ``cache`` in place and returns it."""
    m, H = cfg.mla, cfg.n_heads
    B = x.shape[0]
    positions = pos[:, None]
    q_nope, q_rope = _queries(cfg, p, x, positions)      # (B,1,H,·)
    c_new, kr_new = _latents(cfg, p, x, positions)       # (B,1,·)
    c_kv, k_rope = cache_update(cache["c_kv"], cache["k_rope"],
                                c_new.to(cache["c_kv"].dtype),
                                kr_new.to(cache["k_rope"].dtype), pos)

    # absorb W_uk into the query: q~_h = q_nope_h @ W_uk_h  -> latent space
    wkv_b = split_heads(p["wkv_b"], H, m.qk_nope_head_dim + m.v_head_dim)
    w_uk = wkv_b[:, :, :m.qk_nope_head_dim]              # (c, H, nope)
    w_uv = wkv_b[:, :, m.qk_nope_head_dim:]              # (c, H, v)
    q_lat = torch.einsum("bhd,chd->bhc", q_nope[:, 0], w_uk)

    S = c_kv.shape[1]
    scores = (torch.einsum("bhc,bsc->bhs", q_lat.float(), c_kv.float())
              + torch.einsum("bhr,bsr->bhs", q_rope[:, 0].float(),
                             k_rope.float()))
    scores = scores * (m.qk_head_dim ** -0.5)
    valid = torch.arange(S, device=x.device)[None, :] <= pos[:, None]
    scores = scores + torch.where(valid, 0.0, NEG_INF)[:, None, :]
    probs = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhs,bsc->bhc", probs.to(c_kv.dtype), c_kv)
    o = torch.einsum("bhc,chv->bhv", o_lat, w_uv)        # (B,H,v)
    out = o.reshape(B, 1, H * m.v_head_dim) @ p["wo"]
    return out, {"c_kv": c_kv, "k_rope": k_rope}
