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

On the card a prefill's SSD runs in hand-written CUDA kernels instead
(``kernels/ssd_scan.py``), which keep the (chunk, head, Q, Q) decay and
weight tensors out of device memory: wherever the tensors lie on a CUDA
device and no gradient is asked of them (:func:`_fused`). The plain version
(:func:`_ssd_plain` around :func:`_ssd_scan`) runs on the CPU, on meta
tensors and under autograd, and is what the kernels are tested against.

With ``mamba_ngroups`` G > 1 the fused projection carries G groups of B
and C, group g read by heads [g H/G, (g+1) H/G), and the gated RMSNorm
before ``out_proj`` normalises each group's d_inner/G channels on its own
(Zamba2's ``RMSNormGated``); G = 1 is the reference's form, unchanged.

Decode is the O(1) recurrent step on (conv window, SSM state).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding as shd
from repro_torch.kernels import ssd_scan as ssd_kernel
from repro_torch.models.layers import (NEG_INF, init_linear, rms_norm,
                                       uniform_scale_init)

CHUNK = 128


def ssm_dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    """(d_inner, n_heads, head_dim P, state N)."""
    d_in = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    assert d_in % P == 0
    return d_in, d_in // P, P, cfg.ssm_state


def n_chunks(S: int) -> int:
    """Chunks of the prefill's SSD over S tokens."""
    return -(-S // min(CHUNK, S))


def init_mamba2(gen: torch.Generator | None, cfg: ModelConfig, dtype,
                n_layers: int = 1, *, device=None) -> dict[str, torch.Tensor]:
    """The reference's init scales, drawn from ``gen`` (``None``: meta)."""
    d = cfg.d_model
    d_in, H, P, N = ssm_dims(cfg)
    GN = cfg.mamba_ngroups * N
    conv_ch = d_in + 2 * GN
    dev = "meta" if gen is None else device
    f32 = torch.float32
    return {
        # fused input projection: [z, x, B, C, dt]
        "in_proj": init_linear(gen, d, 2 * d_in + 2 * GN + H, dtype),
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
    """(z, x, B, C, dt) of the fused input projection; B and C hold every
    group's N columns."""
    d_in, H, P, N = ssm_dims(cfg)
    GN = cfg.mamba_ngroups * N
    return torch.split(proj, [d_in, d_in, GN, GN, H], dim=-1)


def _segments(cfg: ModelConfig, h0: int, h: int) -> list[tuple[int, int,
                                                               int]]:
    """(group, first, end) of heads [h0, h0 + h) by B/C group, ``first``
    and ``end`` counted from h0."""
    return _group_segments(ssm_dims(cfg)[1] // cfg.mamba_ngroups, h0, h)


def _group_segments(per: int, h0: int, h: int) -> list[tuple[int, int, int]]:
    """:func:`_segments` at ``per`` heads a group."""
    out, a = [], h0
    while a < h0 + h:
        g = a // per
        b = min(h0 + h, (g + 1) * per)
        out.append((g, a - h0, b - h0))
        a = b
    return out


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


def _heads(cfg: ModelConfig, proj: torch.Tensor, h0: int, h: int):
    """(z, x, B, C, dt) of the fused projection ``proj`` (its whole
    columns): z, x and dt of heads [h0, h0 + h), B and C (every group)
    whole."""
    d_in, H, P, N = ssm_dims(cfg)
    z, xc, Bc, Cc, dt = _split_proj(cfg, proj)
    if h == H:
        return z, xc, Bc, Cc, dt
    cols = slice(h0 * P, (h0 + h) * P)
    return z[..., cols], xc[..., cols], Bc, Cc, dt[..., h0:h0 + h]


def _channels(cfg: ModelConfig, t: torch.Tensor, h0: int, h: int):
    """The conv channels (last dim) of heads [h0, h0 + h)'s x and of B, C."""
    d_in, H, P, _ = ssm_dims(cfg)
    if h == H:
        return t
    return torch.cat([t[..., h0 * P:(h0 + h) * P], t[..., d_in:]], dim=-1)


def _ssd_scan(xs, Bg, Cg, dtg, lg, segs):
    """The chunked SSD of chunks (B, nc, Q, ...): x (h, P) in its dtype,
    B / C (G, N) in f32, dt and the log-decay (h) in f32; ``segs`` the
    (group, first, end) of the heads (:func:`_segments`). Returns y (B, nc,
    h, Q, P) and the state (B, h, P, N) after the last chunk, in f32. Plain
    tensors only: on a sharded model it runs on each rank's heads."""
    B, nc, Q, h, P = xs.shape
    N = Bg.shape[-1]
    f32 = torch.float32
    xf = xs.to(f32)
    l = torch.cumsum(lg, dim=2)                            # inclusive
    # decay matrix exp(l_t - l_s), s <= t, as (B, nc, h, t, s); the mask
    # comes BEFORE the exp (s > t differences are positive and overflow)
    lh = l.transpose(2, 3)                                 # (B,nc,h,Q)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xs.device).tril()
    L = torch.exp(torch.where(causal, lh[..., :, None] - lh[..., None, :],
                              NEG_INF))
    # each chunk's own contribution to the state at its end
    decay_to_end = torch.exp(l[:, :, -1:] - l)             # (B,nc,Q,h)
    dx = xf * (dtg * decay_to_end)[..., None]              # (B,nc,Q,h,P)
    ys, incs = [], []
    for g, a, b in segs:                 # heads [a, b) read group g
        cb = Cg[..., g, :] @ Bg[..., g, :].transpose(-1, -2)   # (B,nc,Q,Q)
        # intra-chunk: y[t] = sum_s cb[t,s] L[h,t,s] dt[s,h] x[s,h,:]
        W = cb[:, :, None] * L[:, :, a:b] \
            * dtg[..., a:b].transpose(2, 3)[:, :, :, None, :]
        ys.append(W @ xf[..., a:b, :].permute(0, 1, 3, 2, 4))  # (B,nc,h,Q,P)
        incs.append(torch.einsum("bcshp,bcsn->bchpn", dx[..., a:b, :],
                                 Bg[..., g, :]))               # (B,nc,h,P,N)
    y, inc = (ys[0], incs[0]) if len(segs) == 1 else \
        (torch.cat(ys, dim=2), torch.cat(incs, dim=2))
    chunk_decay = torch.exp(l[:, :, -1])[..., None, None]  # (B,nc,h,1,1)
    hs = torch.zeros((B, h, P, N), dtype=f32, device=xs.device)
    starts = []
    for c in range(nc):                  # the reference's scan carry
        starts.append(hs)
        hs = chunk_decay[:, c] * hs + inc[:, c]
    h0 = torch.stack(starts, dim=1)                        # (B,nc,h,P,N)
    # inter-chunk: the carried state seen from each position
    seen = [torch.einsum("bctn,bchpn->bchtp", Cg[..., g, :], h0[:, :, a:b])
            for g, a, b in segs]
    y = y + (seen[0] if len(segs) == 1 else torch.cat(seen, dim=2)) \
        * torch.exp(lh)[..., None]
    return y, hs


def _ssd_plain(xbc, dt, loga, D, *, h0: int, heads_per_group: int,
               head_dim: int, state: int):
    """The SSD of a whole prefill of heads [h0, h0 + h) in plain torch ops,
    the plain version of :func:`repro_torch.kernels.ssd_scan.ssd_scan` (same
    arguments): ``xbc`` (B, S, h P + 2 G N) the conv's silu output (x, then
    every group's B and C), ``dt`` and the log-decay ``loga`` (B, S, h) f32,
    ``D`` (h,). Pads to a chunk multiple, runs :func:`_ssd_scan` and adds
    ``D x``. Returns y (B, S, h P) and the final state (B, h, P, N), f32."""
    B, S, _ = xbc.shape
    h, P, N = dt.shape[-1], head_dim, state
    G = (xbc.shape[-1] - h * P) // (2 * N)
    f32 = torch.float32
    xc, Bc, Cc = torch.split(xbc, [h * P, G * N, G * N], dim=-1)

    # pad to a chunk multiple and cut into nc chunks of Q
    Q = min(CHUNK, S)
    pad = (-S) % Q
    Sp = S + pad
    nc = Sp // Q

    def chunks(a: torch.Tensor, *rest: int) -> torch.Tensor:
        if pad:
            a = F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
        return a.reshape(B, nc, Q, *rest)

    xs = chunks(xc, h, P)                                  # x's dtype
    y, hs = _ssd_scan(xs, chunks(Bc.to(f32), G, N),
                      chunks(Cc.to(f32), G, N), chunks(dt, h),
                      chunks(loga, h), _group_segments(heads_per_group, h0,
                                                       h))
    y = y.permute(0, 1, 3, 2, 4).reshape(B, Sp, h, P)[:, :S]
    y = y + D[:, None] * xs.reshape(B, Sp, h, P)[:, :S]
    return y.reshape(B, S, h * P), hs


def _fused(*ts: torch.Tensor) -> bool:
    """Whether the SSD runs in the card's kernels: the tensors lie on a CUDA
    device and autograd records nothing (no gradient is asked of them)."""
    return ts[0].is_cuda and not (torch.is_grad_enabled()
                                  and any(t.requires_grad for t in ts))


def _block_local(cfg: ModelConfig, proj, conv_w, conv_b, dt_bias, A_log, D,
                 h0: int, h: int, return_state: bool, fused: bool):
    """The prefill mixer of heads [h0, h0 + h) on plain tensors, from the
    whole columns of the fused projection (B, S, 2 d_in + 2GN + H): the
    gated output ``y * silu(z)`` (B, S, h P) (:func:`_gate`), the SSD state
    (B, h, P, N) and, with ``return_state``, the last K-1 conv inputs of
    every channel (B, K-1, d_in + 2GN) in f32. The SSD runs in the card's
    kernels with ``fused`` (:func:`_fused` of the mixer's inputs), else in
    :func:`_ssd_plain`."""
    B, S, _ = proj.shape
    d_in, H, P, N = ssm_dims(cfg)
    G = cfg.mamba_ngroups
    f32 = torch.float32
    z, xc, Bc, Cc, dt = _heads(cfg, proj, h0, h)
    tail = None
    if return_state:
        conv_all = proj[..., d_in:2 * d_in + 2 * G * N]    # x | B | C
        Kc = cfg.ssm_conv - 1
        if S >= Kc:
            tail = conv_all[:, S - Kc:].to(f32)
        else:                                      # tiny test sequences
            tail = F.pad(conv_all.to(f32), (0, 0, Kc - S, 0))
    conv_in = torch.cat([xc, Bc, Cc], dim=-1)
    conv_out, _ = _conv1d(_channels(cfg, conv_w, h0, h),
                          _channels(cfg, conv_b, h0, h), conv_in)
    xbc = F.silu(conv_out)                          # (B, S, h P + 2GN)

    dt = F.softplus(dt.to(f32) + dt_bias[h0:h0 + h])             # (B,S,h)
    loga = -torch.exp(A_log[h0:h0 + h]) * dt                      # <= 0
    Dh = D[h0:h0 + h]
    ssd = ssd_kernel.ssd_scan if fused else _ssd_plain
    y, hs = ssd(xbc, dt, loga, Dh, h0=h0, heads_per_group=H // G,
                head_dim=P, state=N)
    return _gate(cfg, y, z), hs, tail


def _gate(cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``y * silu(z)`` of the f32 scan output ``y``: in z's dtype (G = 1,
    the reference's form), or in f32 (G > 1, Zamba2's ``RMSNormGated``,
    which gates and takes its statistics in f32)."""
    if cfg.mamba_ngroups == 1:
        return y.to(z.dtype) * F.silu(z)
    return y * F.silu(z.float())


def _gated_norm(cfg: ModelConfig, gain: torch.Tensor, y: torch.Tensor,
                dtype) -> torch.Tensor:
    """The RMSNorm before ``out_proj`` of the gated output ``y``, in
    ``dtype``: over all of d_inner (G = 1), or over each group's d_inner / G
    channels (G > 1), statistics in f32 and the gain entering as
    ``1 + gain``, as :func:`rms_norm`."""
    G = cfg.mamba_ngroups
    if G == 1:
        return rms_norm(y, gain, cfg.norm_eps)
    yg = y.float().reshape(*y.shape[:-1], G, -1)
    var = torch.mean(yg * yg, dim=-1, keepdim=True)
    n = (yg * torch.rsqrt(var + cfg.norm_eps)).reshape(y.shape).to(dtype)
    return n * (1.0 + gain.to(dtype))


def _step_local(cfg: ModelConfig, proj, conv, ssm, conv_w, conv_b, dt_bias,
                A_log, D, h0: int, h: int):
    """One decode token of heads [h0, h0 + h) on plain tensors: ``proj``
    (B, 1, ...) whole columns, ``conv`` (B, K-1, d_in + 2GN) every channel,
    ``ssm`` (B, h, P, N) the heads' state. Returns the gated output (B, 1,
    h P), the new conv window (every channel, f32) and the new state."""
    B = proj.shape[0]
    d_in, _, P, N = ssm_dims(cfg)
    GN = cfg.mamba_ngroups * N
    f32 = torch.float32
    z, _, _, _, dt = _heads(cfg, proj, h0, h)
    conv_out, conv_state = _conv1d(conv_w, conv_b,
                                   proj[..., d_in:2 * d_in + 2 * GN], conv)
    xc, Bc, Cc = torch.split(F.silu(conv_out), [d_in, GN, GN], dim=-1)
    xc = xc[..., h0 * P:(h0 + h) * P]

    dt = F.softplus(dt[:, 0].to(f32) + dt_bias[h0:h0 + h])        # (B,h)
    a = torch.exp(-torch.exp(A_log[h0:h0 + h]) * dt)              # (B,h)
    xh = xc[:, 0].reshape(B, h, P).to(f32)
    Bv, Cv = Bc[:, 0].to(f32), Cc[:, 0].to(f32)                   # (B,GN)
    if GN == N:                          # one group: every head reads it
        Bh, Ch = Bv[:, None, None, :], Cv[:, None, :, None]
    else:                                # each head its group's B and C
        Bh, Ch = (torch.cat([t.view(B, -1, N)[:, g:g + 1].expand(B, b - a, N)
                             for g, a, b in _segments(cfg, h0, h)], dim=1)
                  for t in (Bv, Cv))
        Bh, Ch = Bh[:, :, None, :], Ch[..., None]
    hs = ssm * a[:, :, None, None] + (xh * dt[:, :, None])[..., None] * Bh
    y = (hs @ Ch)[..., 0]                                         # (B,h,P)
    y = y + D[h0:h0 + h][:, None] * xh
    return _gate(cfg, y.reshape(B, 1, h * P), z), conv_state.to(f32), hs


def mamba2_block(cfg: ModelConfig, p, x: torch.Tensor,
                 return_state: bool = False):
    """Full-sequence (prefill) Mamba2 mixer. x: (B, S, d) -> (B, S, d).

    With ``return_state`` also returns the exact decode state {conv, ssm}
    after the last token: ``conv`` holds the last K-1 conv INPUTS (before the
    conv and the silu) in f32, left-padded with zeros when S < K-1; padding
    the sequence to a chunk multiple is state-neutral (padded ``loga`` and
    ``dt`` are zero: decay 1, no input). Beside them, ``fused`` says whether
    the SSD ran in the card's kernels (:func:`_fused`, decided here once for
    every rank's heads).

    On DTensors (a sharded model) the mixer runs on each rank's batch rows
    and SSM heads (:func:`_on_heads`); the gated norm's statistics reduce
    over the heads' ranks, and ``out_proj``'s result is a partial sum over
    them, as the dense family's ``wo``."""
    proj = x @ p["in_proj"]
    args = (proj, p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"], p["D"])
    fused = _fused(*args)
    if isinstance(proj, DTensor):
        y, hs, tail = _on_heads(cfg, _block_local, args,
                                (return_state, fused), tail=return_state)
    else:
        y, hs, tail = _block_local(cfg, *args, 0, ssm_dims(cfg)[1],
                                   return_state, fused)
    out = _gated_norm(cfg, p["norm"], y, proj.dtype) @ p["out_proj"]
    if return_state:
        return out, {"conv": tail, "ssm": hs, "fused": fused}
    return out


def mamba2_init_state(cfg: ModelConfig, batch: int, *,
                      device=None) -> dict[str, torch.Tensor]:
    d_in, H, P, N = ssm_dims(cfg)
    f32 = torch.float32
    conv_ch = d_in + 2 * cfg.mamba_ngroups * N
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch),
                                dtype=f32, device=device),
            "ssm": torch.zeros((batch, H, P, N), dtype=f32, device=device)}


def mamba2_step(cfg: ModelConfig, p, state: dict,
                x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One-token decode. x: (B, 1, d). Returns (out, new state); the new
    state is fresh tensors (the model writes them into its cache). On
    DTensors each rank steps its batch rows and SSM heads, from the conv
    window of every channel."""
    proj = x @ p["in_proj"]
    args = (proj, state["conv"], state["ssm"], p["conv_w"], p["conv_b"],
            p["dt_bias"], p["A_log"], p["D"])
    if isinstance(proj, DTensor):
        y, conv, hs = _on_heads(cfg, _step_local, args, (), step=True)
    else:
        y, conv, hs = _step_local(cfg, *args, 0, ssm_dims(cfg)[1])
    y = _gated_norm(cfg, p["norm"], y, proj.dtype)
    return y @ p["out_proj"], {"conv": conv, "ssm": hs}


def _on_heads(cfg: ModelConfig, fn, args, extra, *, tail: bool = False,
              step: bool = False):
    """``fn`` (:func:`_block_local` or :func:`_step_local`) under
    ``local_map`` on each rank's plain tensors: its batch rows on the DP
    axes and, where they divide "model", its SSM heads. The fused
    projection's columns, the conv window's and ``conv_w``'s channels are
    gathered whole (their blocks cut z | x | B | C | dt across heads), so
    each rank takes its heads' z, x and dt and the B and C that every head
    reads; the SSD's loops see no DTensor. The gradient of a whole input is
    a partial sum over "model" (each rank's heads) and over the DP axes
    that split the rows (each rank's rows)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = args[0].device_mesh
    names = mesh.mesh_dim_names
    H = ssm_dims(cfg)[1]
    b, _, hx, _ = shd.attention_layout(mesh, args[0].shape[0], H, H, None)
    coord = dict(zip(names, mesh.get_coordinate()))
    h = H // shd.axis_size(mesh, hx)
    h0 = coord[hx] * h if hx is not None else 0

    def pl(*spec):
        return tuple(shd.placements(mesh, shd.P(*spec)))

    def grad_of(placed, over):
        return tuple(Partial() if a in over else p
                     for a, p in zip(names, placed))

    rows = pl(b, None, None)
    ins = [args[0].redistribute(mesh, rows)]
    in_pl, grad_pl = [rows], [grad_of(rows, shd._axes(hx))]
    if step:                                  # the conv window, the state
        in_pl += [rows, pl(b, hx, None, None)]
        grad_pl += in_pl[1:]
        ins += [t.redistribute(mesh, p) for t, p in zip(args[1:3],
                                                       in_pl[1:])]
    whole = tuple(Replicate() for _ in names)
    for w in args[len(ins):]:
        ins.append(w.redistribute(mesh, whole))
        in_pl.append(whole)
        grad_pl.append(grad_of(whole, shd._axes(b) + shd._axes(hx)))
    heads = pl(b, hx, None, None)
    out_pl = (pl(b, None, hx),) + ((rows, heads) if step else
                                   (heads, rows if tail else None))
    return local_map(lambda *t: fn(cfg, *t, h0, h, *extra),
                     out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl),
                     device_mesh=mesh)(*ins)
