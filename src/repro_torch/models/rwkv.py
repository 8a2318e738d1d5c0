"""RWKV-6 "Finch" block — attention-free, data-dependent decay; the port of
``repro.models.rwkv``.

Token shift with a data-dependent (low-rank) lerp, a per-channel decay
``w = exp(-exp(.))`` from a LoRA head computed in f32, the WKV matrix-state
recurrence with the first-token bonus ``u``, a per-head group norm
(population variance), a silu gate, and the squared-ReLU channel mix.

The recurrence runs one token at a time on an f32 (B, H, K, V) state, as the
reference's ``lax.scan`` does; it has no Pallas kernel in the reference, so
it is plain torch here. Decode is the same step applied to each new token.

On DTensors (a sharded model) the projections are DTensor matmuls and the
scan and the per-head group norm run under ``local_map`` on each rank's
plain tensors: its batch rows on the DP axes and its heads on "model" where
they divide it (:func:`_wkv_on_heads`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding as shd
from repro_torch.models.layers import (init_linear, split_heads,
                                       uniform_scale_init)

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
    """x_{t-1} along the sequence; ``last`` (B, d) carries across calls (a
    DTensor ``last`` is first placed as ``x``'s rows)."""
    if last is None:
        pad = torch.zeros_like(x[:, :1])
    else:
        if isinstance(last, DTensor):
            from torch.distributed.tensor import Replicate, Shard
            last = last.redistribute(last.device_mesh, [
                {0: Shard(0), 2: Shard(1)}.get(getattr(pl, "dim", None),
                                               Replicate())
                for pl in x.placements])
        pad = last[:, None, :].to(x.dtype)
    return torch.cat([pad, x[:, :-1]], dim=1)


def _ddlerp(p, x: torch.Tensor, xp: torch.Tensor) -> list[torch.Tensor]:
    """Data-dependent lerp producing the 5 mixed inputs (r, k, v, w, g)."""
    delta = xp - x
    base = x + delta * p["mu"][0]                              # shared pre-mix
    lora = split_heads(torch.tanh(base @ p["tm_w1"]), 5, TM_LORA)
    adj = _mix_adjust(lora, p["tm_w2"])                        # (B,S,5,d)
    mixed = x[..., None, :] + delta[..., None, :] * (p["mu"] + adj)
    return list(mixed.unbind(dim=-2))                          # r,k,v,w,g


def _mix_adjust(lora: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """``einsum("bsfr,frd->bsfd")``. On DTensors each rank multiplies its
    batch rows (``lora``'s placement on the DP axes, whole elsewhere) by
    the whole ``w2``, under ``local_map``: the five mixes and the rows are
    not split over "model", where the reference computes this product whole
    (DTensor would cut the five mixes unevenly over it)."""
    if not isinstance(lora, DTensor):
        return torch.einsum("bsfr,frd->bsfd", lora, w2)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = lora.device_mesh
    rows = tuple(pl if getattr(pl, "dim", None) == 0 else Replicate()
                 for pl in lora.placements)
    whole = tuple(Replicate() for _ in rows)
    w2_grad = tuple(Partial() if getattr(pl, "dim", None) == 0 else pl
                    for pl in rows)
    return local_map(lambda a, w: torch.einsum("bsfr,frd->bsfd", a, w),
                     out_placements=(rows,), in_placements=(rows, whole),
                     in_grad_placements=(rows, w2_grad),
                     device_mesh=mesh)(lora.redistribute(mesh, rows),
                                       w2.redistribute(mesh, whole))


def _wkv_scan(r, k, v, w, u, state):
    """WKV recurrence. r/k/w: (B,S,H,K); v: (B,S,H,V); state: (B,H,K,V) f32.

    out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T

    Returns (final state, outputs (B,S,H,V)); the state passed in is not
    written. Plain tensors only: on a sharded model it runs on each rank's
    rows and heads."""
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


def _wkv_heads(r, k, v, w, u, gn, state, eps: float, dtype):
    """The WKV scan and the group norm of the heads that r/k/v/w (B, S, h,
    K) hold, on plain tensors: ``u`` (h, K) and ``gn`` (h K) are those
    heads'; ``state`` (B, h, K, K) f32, or None for zeros. Returns (out (B,
    S, h K) in ``dtype``, the new state)."""
    B, S, h, K = r.shape
    f32 = torch.float32
    if state is None:
        state = torch.zeros((B, h, K, K), dtype=f32, device=r.device)
    state, out = _wkv_scan(r.to(f32), k.to(f32), v.to(f32), w, u, state)
    return _group_norm(out.reshape(B, S, h * K).to(dtype), gn, h, eps), state


def _wkv_on_heads(cfg: ModelConfig, r, k, v, w, u, gn, state, dtype):
    """:func:`_wkv_heads` under ``local_map`` on each rank's batch rows
    (the DP axes) and heads ("model", where the heads divide it; else every
    rank scans them all): r, k, v, w, ``state`` and the output placed so,
    ``u`` and ``gn`` cut to the rank's heads (their gradients a partial sum
    over the rows' ranks). The scan's token loop sees no DTensor."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = r.device_mesh
    B, _, H, _ = r.shape
    b, _, hx, _ = shd.attention_layout(mesh, B, H, H, None)

    def pl(*spec):
        return tuple(shd.placements(mesh, shd.P(*spec)))

    def rows_partial(placed):
        return tuple(Partial() if a in shd._axes(b) else p
                     for a, p in zip(mesh.mesh_dim_names, placed))

    seq, heads, u_pl, gn_pl = (pl(b, None, hx, None), pl(b, hx, None, None),
                               pl(hx, None), pl(hx))
    ins = [t.redistribute(mesh, seq) for t in (r, k, v, w)] + [
        u.redistribute(mesh, u_pl), gn.redistribute(mesh, gn_pl),
        None if state is None else state.redistribute(mesh, heads)]
    st_pl = None if state is None else heads
    return local_map(
        lambda *t: _wkv_heads(*t, cfg.norm_eps, dtype),
        out_placements=(pl(b, None, hx), heads),
        in_placements=(seq,) * 4 + (u_pl, gn_pl, st_pl),
        in_grad_placements=(seq,) * 4 + (rows_partial(u_pl),
                                         rows_partial(gn_pl), st_pl),
        device_mesh=mesh)(*ins)


def time_mix(cfg: ModelConfig, p, x: torch.Tensor, *,
             last_x: torch.Tensor | None = None,
             state: torch.Tensor | None = None):
    """RWKV time mix. Returns (out, new last_x in x's dtype, new state)."""
    H, K = rwkv_dims(cfg)
    xr, xk, xv, xw, xg = _ddlerp(p, x, _shift(x, last_x))
    f32 = torch.float32
    r = split_heads(xr @ p["wr"], H, K)
    k = split_heads(xk @ p["wk"], H, K)
    v = split_heads(xv @ p["wv"], H, K)
    g = F.silu(xg @ p["wg"])
    w_log = p["w0"] + torch.tanh(xw @ p["w_w1"]).to(f32) @ p["w_w2"].to(f32)
    w = split_heads(torch.exp(-torch.exp(w_log)), H, K)       # (0, 1)
    if isinstance(r, DTensor):
        out, state = _wkv_on_heads(cfg, r, k, v, w, p["u"], p["gn"], state,
                                   x.dtype)
    else:
        out, state = _wkv_heads(r, k, v, w, p["u"], p["gn"], state,
                                cfg.norm_eps, x.dtype)
    return (out * g) @ p["wo"], x[:, -1, :], state


def channel_mix(cfg: ModelConfig, p, x: torch.Tensor, *,
                last_x: torch.Tensor | None = None):
    """``sigmoid(xr @ wr) * (relu(xk @ wk)**2 @ wv)``; returns (out, new
    last_x in x's dtype)."""
    xp = _shift(x, last_x)
    xk = x + (xp - x) * p["mu_k"]
    xr = x + (xp - x) * p["mu_r"]
    k = torch.square(F.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"]), x[:, -1, :]
