"""Mamba2 (SSD) block — the zamba2-7b backbone, the port of
``repro.models.ssm``.

Chunked SSD (Dao & Gu, 2024) as the reference spells it: the sequence is cut
into chunks of ``CHUNK``; inside a chunk the recurrence is a masked quadratic
form, and a small f32 state (B, H, P, N) links the chunks. The decay matrix
is ``exp(l_t - l_s)`` with ``l`` the within-chunk cumulative log-decay,
masked to -1e30 BEFORE the exp (the s > t half has positive differences).

The reference carries the state through a ``lax.scan`` over chunks and
computes each chunk's terms inside the step. Here every chunk's intra-chunk
output and state increment are computed at once (they do not depend on the
carried state), and only the carry ``h <- exp(l_last) h + increment`` runs
chunk by chunk; the inter-chunk term then reads each chunk's starting state.
The same products in the same dtypes, in fewer launches. There is no Pallas
kernel here in the reference: these are plain torch ops, products in
``torch.matmul``. Mixed bf16/f32 products, which JAX promotes inside
``einsum``, are cast to f32 explicitly (bf16 -> f32 is exact), and no
``einsum`` takes more than two operands, so the contraction order does not
depend on whether ``opt_einsum`` is installed.

Decode is the O(1) recurrent step on (conv window, SSM state).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (NEG_INF, init_linear, rms_norm,
                                       uniform_scale_init)

CHUNK = 128


def ssm_dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    """(d_inner, n_heads, head_dim P, state N)."""
    d_in = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    assert d_in % P == 0
    return d_in, d_in // P, P, cfg.ssm_state


def init_mamba2(gen: torch.Generator | None, cfg: ModelConfig, dtype,
                n_layers: int = 1, *, device=None) -> dict[str, torch.Tensor]:
    """The reference's init scales, drawn from ``gen`` (``None``: meta)."""
    d = cfg.d_model
    d_in, H, P, N = ssm_dims(cfg)
    conv_ch = d_in + 2 * N
    dev = "meta" if gen is None else device
    f32 = torch.float32
    return {
        # fused input projection: [z, x, B, C, dt]
        "in_proj": init_linear(gen, d, 2 * d_in + 2 * N + H, dtype),
        "conv_w": uniform_scale_init(gen, (cfg.ssm_conv, conv_ch), dtype, 0.1),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=f32,
                                          device=dev)),
        "dt_bias": torch.zeros((H,), dtype=f32, device=dev),
        "D": torch.ones((H,), dtype=f32, device=dev),
        "norm": torch.zeros((d_in,), dtype=dtype, device=dev),
        "out_proj": init_linear(gen, d_in, d, dtype,
                                scale=1.0 / d_in ** 0.5
                                / (2.0 * n_layers) ** 0.5),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    """(z, x, B, C, dt) of the fused input projection."""
    d_in, H, P, N = ssm_dims(cfg)
    return torch.split(proj, [d_in, d_in, N, N, H], dim=-1)


def _conv1d(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
            state: torch.Tensor | None = None):
    """Depthwise causal conv, width K. x: (B, S, C); state: (B, K-1, C) (f32,
    cast to x's dtype first). The K taps are added in x's dtype in the
    reference's order, ``sum(xp[:, i:i+S] * w[i]) + b``. Returns (out, the
    last K-1 inputs)."""
    K, S = w.shape[0], x.shape[1]
    if state is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    out = out + b
    return out, (xp[:, -(K - 1):] if K > 1 else pad)


def mamba2_block(cfg: ModelConfig, p, x: torch.Tensor,
                 return_state: bool = False):
    """Full-sequence (prefill) Mamba2 mixer. x: (B, S, d) -> (B, S, d).

    With ``return_state`` also returns the exact decode state {conv, ssm}
    after the last token: ``conv`` holds the last K-1 conv INPUTS (before the
    conv and the silu) in f32, left-padded with zeros when S < K-1; padding
    the sequence to a chunk multiple is state-neutral (padded ``loga`` and
    ``dt`` are zero: decay 1, no input)."""
    B, S, _ = x.shape
    d_in, H, P, N = ssm_dims(cfg)
    f32 = torch.float32
    z, xc, Bc, Cc, dt = _split_proj(cfg, x @ p["in_proj"])
    conv_in = torch.cat([xc, Bc, Cc], dim=-1)
    Kc = cfg.ssm_conv - 1
    if S >= Kc:
        conv_tail = conv_in[:, S - Kc:].to(f32)
    else:                                          # tiny test sequences
        conv_tail = F.pad(conv_in.to(f32), (0, 0, Kc - S, 0))
    conv_out, _ = _conv1d(p["conv_w"], p["conv_b"], conv_in)
    xc, Bc, Cc = torch.split(F.silu(conv_out), [d_in, N, N], dim=-1)

    dt = F.softplus(dt.to(f32) + p["dt_bias"])                   # (B,S,H)
    loga = -torch.exp(p["A_log"]) * dt                            # <= 0

    # pad to a chunk multiple and cut into nc chunks of Q
    Q = min(CHUNK, S)
    pad = (-S) % Q
    Sp = S + pad
    nc = Sp // Q

    def chunks(a: torch.Tensor, *tail: int) -> torch.Tensor:
        if pad:
            a = F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
        return a.reshape(B, nc, Q, *tail)

    xs = chunks(xc, H, P)                                  # x's dtype
    xf = xs.to(f32)
    Bg, Cg = chunks(Bc.to(f32), N), chunks(Cc.to(f32), N)  # (B,nc,Q,N)
    dtg, lg = chunks(dt, H), chunks(loga, H)               # (B,nc,Q,H)

    l = torch.cumsum(lg, dim=2)                            # inclusive
    # decay matrix exp(l_t - l_s), s <= t, as (B, nc, H, t, s); the mask
    # comes BEFORE the exp (s > t differences are positive and overflow)
    lh = l.transpose(2, 3)                                 # (B,nc,H,Q)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(causal, lh[..., :, None] - lh[..., None, :],
                              NEG_INF))
    cb = Cg @ Bg.transpose(-1, -2)                         # (B,nc,Q,Q) t,s
    # intra-chunk: y[t] = sum_s cb[t,s] L[h,t,s] dt[s,h] x[s,h,:]
    W = cb[:, :, None] * L * dtg.transpose(2, 3)[:, :, :, None, :]
    y = W @ xf.permute(0, 1, 3, 2, 4)                      # (B,nc,H,Q,P)
    # each chunk's own contribution to the state at its end
    decay_to_end = torch.exp(l[:, :, -1:] - l)             # (B,nc,Q,H)
    dx = xf * (dtg * decay_to_end)[..., None]              # (B,nc,Q,H,P)
    inc = torch.einsum("bcshp,bcsn->bchpn", dx, Bg)        # (B,nc,H,P,N)
    chunk_decay = torch.exp(l[:, :, -1])[..., None, None]  # (B,nc,H,1,1)
    h = torch.zeros((B, H, P, N), dtype=f32, device=x.device)
    starts = []
    for c in range(nc):                  # the reference's scan carry
        starts.append(h)
        h = chunk_decay[:, c] * h + inc[:, c]
    h0 = torch.stack(starts, dim=1)                        # (B,nc,H,P,N)
    # inter-chunk: the carried state seen from each position
    y = y + torch.einsum("bctn,bchpn->bchtp", Cg, h0) \
        * torch.exp(lh)[..., None]
    y = y.permute(0, 1, 3, 2, 4).reshape(B, Sp, H, P)[:, :S]
    y = y + p["D"][:, None] * xs.reshape(B, Sp, H, P)[:, :S]
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if return_state:
        return out, {"conv": conv_tail, "ssm": h}
    return out


def mamba2_init_state(cfg: ModelConfig, batch: int, *,
                      device=None) -> dict[str, torch.Tensor]:
    d_in, H, P, N = ssm_dims(cfg)
    f32 = torch.float32
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, d_in + 2 * N),
                                dtype=f32, device=device),
            "ssm": torch.zeros((batch, H, P, N), dtype=f32, device=device)}


def mamba2_step(cfg: ModelConfig, p, state: dict,
                x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One-token decode. x: (B, 1, d). Returns (out, new state); the new
    state is fresh tensors (the model writes them into its cache)."""
    B = x.shape[0]
    d_in, H, P, N = ssm_dims(cfg)
    f32 = torch.float32
    z, xc, Bc, Cc, dt = _split_proj(cfg, x @ p["in_proj"])
    conv_in = torch.cat([xc, Bc, Cc], dim=-1)                     # (B,1,C)
    conv_out, conv_state = _conv1d(p["conv_w"], p["conv_b"], conv_in,
                                   state["conv"])
    xc, Bc, Cc = torch.split(F.silu(conv_out), [d_in, N, N], dim=-1)

    dt = F.softplus(dt[:, 0].to(f32) + p["dt_bias"])              # (B,H)
    a = torch.exp(-torch.exp(p["A_log"]) * dt)                    # (B,H)
    xh = xc[:, 0].reshape(B, H, P).to(f32)
    Bv, Cv = Bc[:, 0].to(f32), Cc[:, 0].to(f32)                   # (B,N)
    h = state["ssm"] * a[:, :, None, None] \
        + (xh * dt[:, :, None])[..., None] * Bv[:, None, None, :]
    y = (h @ Cv[:, None, :, None])[..., 0]                        # (B,H,P)
    y = y + p["D"][:, None] * xh
    y = y.reshape(B, 1, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], {"conv": conv_state.to(f32), "ssm": h}
