"""Plain PyTorch versions of the attention kernels.

Self-contained (no imports from repro_torch.models) so a kernel test failure
is attributable to the kernel alone. Math is the plain materialised-scores
formulation in f32 — the slowest, most obviously-correct spelling. The CPU
path runs these; on the card they are the yardstick the kernels are held to.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0,
                        softmax_scale: float | None = None) -> torch.Tensor:
    """q: (B, Sq, Hq, hd); k/v: (B, Sk, Hkv, hd); GQA via Hq % Hkv == 0.

    ``q_offset`` places query i at absolute position q_offset + i (for
    suffix/chunked prefill); keys are at absolute positions 0..Sk-1.
    """
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    qf = q.float().reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= qpos - kpos < window
    s = torch.where(ok[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, v.shape[-1]).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths: torch.Tensor, *,
                         window: int = 0,
                         softmax_scale: float | None = None) -> torch.Tensor:
    """Single-token attention vs a cache.

    q: (B, Hq, hd); caches: (B, S, Hkv, hd); lengths: (B,) — number of valid
    cache entries (query sits at position lengths-1). A length beyond S is
    clamped to S, as the kernel clamps it.
    """
    B, Hq, hd = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    lengths = lengths.to(q.device).clamp(max=S)
    qf = q.float().reshape(B, Hkv, G, hd)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float()) * scale
    kpos = torch.arange(S, device=q.device)[None, :]
    ok = kpos < lengths[:, None]
    if window > 0:
        ok &= (lengths[:, None] - 1 - kpos) < window
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(B, Hq, v_cache.shape[-1]).to(q.dtype)
