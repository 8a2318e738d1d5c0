"""Mixture-of-Experts layer — capacity-based token-choice dispatch, the port
of ``repro.models.moe`` (its single-device global path).

Covers both MoE architectures:
  * deepseek-v3-671b: 1 shared expert + 256 routed, top-8, softmax router
    with renormalized top-k weights, first 3 layers dense;
  * arctic-480b: 128 routed top-2 + a *dense residual* FFN in parallel.

Dispatch is the GShard/Switch capacity scheme as the reference spells it:
top-k per token, position within its expert from a stable sort of the flat
expert ids, a capacity drop, scatter-add into ``(E * C, d)``, three expert
products, then gather back and weight. The reference's sharded path (local
dispatch per mesh shard, ``moe.py:138``) waits for the port's ``dist/``; with
no mesh the reference runs the global path too.

Semantics kept from JAX: ``jax.lax.top_k`` puts the lower index first among
equal probabilities — a stable descending sort does the same; the drop sink
``E * C - 1`` takes added zeros (``index_add_``, not a copy that would
overwrite the token parked there); a gather past the buffer clamps, as a JAX
gather does (its weight is zero either way). The router runs in f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import init_linear, uniform_scale_init


def init_moe(gen: torch.Generator | None, cfg: ModelConfig, dtype,
             n_layers: int = 1) -> dict:
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    out_scale = 1.0 / ff ** 0.5 / (2.0 * n_layers) ** 0.5
    p = {"router": init_linear(gen, d, E, torch.float32),   # router in f32
         "w1": uniform_scale_init(gen, (E, d, ff), dtype, 0.02),
         "w3": uniform_scale_init(gen, (E, d, ff), dtype, 0.02),
         "w2": uniform_scale_init(gen, (E, ff, d), dtype, out_scale)}
    if cfg.n_shared_experts:
        ff_s = ff * cfg.n_shared_experts
        p["shared"] = {"w1": init_linear(gen, d, ff_s, dtype),
                       "w3": init_linear(gen, d, ff_s, dtype),
                       "w2": init_linear(gen, ff_s, d, dtype, scale=out_scale)}
    return p


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(math.ceil(cfg.capacity_factor * n_tokens * cfg.experts_per_token
                      / cfg.n_experts))
    return max(8, int(math.ceil(c / 8)) * 8)


def moe_ffn(cfg: ModelConfig, p, x: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), router aux loss scalar f32). The port
    has no mesh yet, so this is always the global path."""
    return _moe_ffn_global(cfg, p, x)


def _moe_ffn_global(cfg: ModelConfig, p, x: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.experts_per_token
    C = _capacity(cfg, T)
    xt = x.reshape(T, d)

    logits = xt.float() @ p["router"]                          # (T, E) f32
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :k], topi[:, :k]                      # (T, k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    # position of each (token, slot) inside its expert: one stable sort over
    # the T*k flat assignments, positions from the segment starts
    e_flat = topi.reshape(-1)                                  # (T*k,)
    order = torch.argsort(e_flat, stable=True)
    counts = torch.bincount(e_flat, minlength=E)
    seg_start = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(T * k, device=x.device) - seg_start[e_flat[order]]
    pos_flat = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos_flat < C                                        # capacity drop

    # scatter tokens -> (E*C, d); dropped rows add zeros into the sink
    flat_idx = e_flat * C + pos_flat                           # (T*k,)
    src = torch.repeat_interleave(xt, k, dim=0) * keep[:, None].to(x.dtype)
    disp = torch.zeros((E * C, d), dtype=x.dtype, device=x.device)
    disp.index_add_(0, torch.where(keep, flat_idx, E * C - 1),
                    torch.where(keep[:, None], src, torch.zeros_like(src)))
    disp = disp.reshape(E, C, d)

    # expert FFN, batched over experts
    h = torch.bmm(disp, p["w1"])
    g = torch.bmm(disp, p["w3"])
    y = torch.bmm(F.silu(h) * g, p["w2"])

    # gather back with the routing weights (dropped slots weigh zero)
    picked = y.reshape(E * C, d)[flat_idx.clamp(max=E * C - 1)]  # (T*k, d)
    w = (topw.reshape(-1) * keep).to(x.dtype)
    out = (picked * w[:, None]).reshape(T, k, d).sum(dim=1)

    # load-balancing aux loss (Switch): E * sum_e f_e * P_e
    frac = counts.float() / max(T * k, 1)
    aux = E * torch.sum(frac * probs.mean(0)) * cfg.router_aux_weight

    if "shared" in p:
        sp = p["shared"]
        out = out + (F.silu(xt @ sp["w1"]) * (xt @ sp["w3"])) @ sp["w2"]
    return out.reshape(B, S, d), aux
