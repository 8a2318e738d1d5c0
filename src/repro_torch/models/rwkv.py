"""RWKV-6 "Finch" block — attention-free, data-dependent decay; the port of
``repro.models.rwkv``.

Token shift with a data-dependent (low-rank) lerp, a per-channel decay
``w = exp(-exp(.))`` from a LoRA head computed in f32, the WKV matrix-state
recurrence with the first-token bonus ``u``, a per-head group norm
(population variance), a silu gate, and the squared-ReLU channel mix.

The recurrence runs one token at a time on an f32 (B, H, K, V) state, as the
reference's ``lax.scan`` does; it has no Pallas kernel in the reference, so
it is plain torch here. Decode is the same step applied to each new token.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import init_linear, uniform_scale_init

TM_LORA = 32      # token-shift lerp low-rank
W_LORA = 64       # decay low-rank


def rwkv_dims(cfg: ModelConfig) -> tuple[int, int]:
    K = cfg.rwkv_head_dim
    assert cfg.d_model % K == 0
    return cfg.d_model // K, K      # (heads, head_dim)


def init_rwkv_block(gen: torch.Generator | None, cfg: ModelConfig, dtype,
                    n_layers: int = 1, *, device=None) -> dict:
    """The reference's init scales, drawn from ``gen`` (``None``: meta)."""
    d = cfg.d_model
    H, K = rwkv_dims(cfg)
    dev = "meta" if gen is None else device
    out_scale = 1.0 / d ** 0.5 / (2.0 * n_layers) ** 0.5
    return {
        "tm": {  # time mix (wkv)
            "mu": uniform_scale_init(gen, (5, d), dtype, 0.5),
            "tm_w1": init_linear(gen, d, 5 * TM_LORA, dtype),
            "tm_w2": uniform_scale_init(gen, (5, TM_LORA, d), dtype),
            "w0": torch.full((d,), -2.0, dtype=torch.float32, device=dev),
            "w_w1": init_linear(gen, d, W_LORA, dtype),
            "w_w2": uniform_scale_init(gen, (W_LORA, d), dtype),
            "wr": init_linear(gen, d, d, dtype),
            "wk": init_linear(gen, d, d, dtype),
            "wv": init_linear(gen, d, d, dtype),
            "wg": init_linear(gen, d, d, dtype),
            "u": uniform_scale_init(gen, (H, K), torch.float32, 0.3),
            "gn": torch.zeros((d,), dtype=dtype, device=dev),
            "wo": init_linear(gen, d, d, dtype, scale=out_scale),
        },
        "cm": {  # channel mix
            "mu_k": uniform_scale_init(gen, (d,), dtype, 0.5),
            "mu_r": uniform_scale_init(gen, (d,), dtype, 0.5),
            "wk": init_linear(gen, d, cfg.d_ff, dtype),
            "wv": init_linear(gen, cfg.d_ff, d, dtype, scale=out_scale),
            "wr": init_linear(gen, d, d, dtype),
        },
    }


def _shift(x: torch.Tensor, last: torch.Tensor | None = None) -> torch.Tensor:
    """x_{t-1} along the sequence; ``last`` (B, d) carries across calls."""
    pad = torch.zeros_like(x[:, :1]) if last is None \
        else last[:, None, :].to(x.dtype)
    return torch.cat([pad, x[:, :-1]], dim=1)


def _ddlerp(p, x: torch.Tensor, xp: torch.Tensor) -> list[torch.Tensor]:
    """Data-dependent lerp producing the 5 mixed inputs (r, k, v, w, g)."""
    delta = xp - x
    base = x + delta * p["mu"][0]                              # shared pre-mix
    lora = torch.tanh(base @ p["tm_w1"])                       # (B,S,5*rank)
    lora = lora.reshape(*lora.shape[:-1], 5, TM_LORA)
    adj = torch.einsum("bsfr,frd->bsfd", lora, p["tm_w2"])     # (B,S,5,d)
    mixed = x[..., None, :] + delta[..., None, :] * (p["mu"] + adj)
    return list(mixed.unbind(dim=-2))                          # r,k,v,w,g


def _wkv_scan(r, k, v, w, u, state):
    """WKV recurrence. r/k/w: (B,S,H,K); v: (B,S,H,V); state: (B,H,K,V) f32.

    out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T

    Returns (final state, outputs (B,S,H,V)); the state passed in is not
    written."""
    uu = u[None, :, :, None]
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]        # (B,H,K,V)
        outs.append(r[:, t, :, None, :] @ torch.addcmul(state, uu, kv))
        state = torch.addcmul(kv, w[:, t, :, :, None], state)
    return state, torch.cat(outs, dim=2).transpose(1, 2)      # (B,S,H,V)


def _group_norm(x: torch.Tensor, gain: torch.Tensor, H: int,
                eps: float) -> torch.Tensor:
    """Per-head layer norm (population variance) of (B, S, d) viewed as
    (B, S, H, K)."""
    B, S, d = x.shape
    xh = x.reshape(B, S, H, d // H).float()
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, correction=0)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(B, S, d) * (1.0 + gain.float())).to(x.dtype)


def time_mix(cfg: ModelConfig, p, x: torch.Tensor, *,
             last_x: torch.Tensor | None = None,
             state: torch.Tensor | None = None):
    """RWKV time mix. Returns (out, new last_x in x's dtype, new state)."""
    B, S, d = x.shape
    H, K = rwkv_dims(cfg)
    xr, xk, xv, xw, xg = _ddlerp(p, x, _shift(x, last_x))
    f32 = torch.float32
    r = (xr @ p["wr"]).reshape(B, S, H, K)
    k = (xk @ p["wk"]).reshape(B, S, H, K)
    v = (xv @ p["wv"]).reshape(B, S, H, K)
    g = F.silu(xg @ p["wg"])
    w_log = p["w0"] + torch.tanh(xw @ p["w_w1"]).to(f32) @ p["w_w2"].to(f32)
    w = torch.exp(-torch.exp(w_log)).reshape(B, S, H, K)      # (0, 1)
    if state is None:
        state = torch.zeros((B, H, K, K), dtype=f32, device=x.device)
    state, out = _wkv_scan(r.to(f32), k.to(f32), v.to(f32), w, p["u"], state)
    out = _group_norm(out.reshape(B, S, d).to(x.dtype), p["gn"], H,
                      cfg.norm_eps) * g
    return out @ p["wo"], x[:, -1, :], state


def channel_mix(cfg: ModelConfig, p, x: torch.Tensor, *,
                last_x: torch.Tensor | None = None):
    """``sigmoid(xr @ wr) * (relu(xk @ wk)**2 @ wv)``; returns (out, new
    last_x in x's dtype)."""
    xp = _shift(x, last_x)
    xk = x + (xp - x) * p["mu_k"]
    xr = x + (xp - x) * p["mu_r"]
    k = torch.square(F.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"]), x[:, -1, :]
