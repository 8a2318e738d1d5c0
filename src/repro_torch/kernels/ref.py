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


BWD_Q_CHUNK = 512               # query rows per step of the plain backward


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            q_offset: int = 0,
                            softmax_scale: float | None = None,
                            q_chunk: int = BWD_Q_CHUNK):
    """(dq, dk, dv): the VJP of :func:`flash_attention_ref` at ``do``, in
    the inputs' dtypes, computed in f32 ``q_chunk`` query rows at a time.

    The reference has no backward kernel: it trains through XLA's autodiff
    of the same attention, so this is the plain math, chunked so that the
    f32 scores never exist whole (B 4, 32 heads, 4096 x 4096 would be 8.6 GB
    a tensor). A chunk reads only the keys some row of it can see (causal:
    up to its last row; window: from its first row's window start); the
    keys it skips have probability exactly 0 in the full row. A chunk with a
    row that sees no key at all (a window past the keys' end) takes every
    key, as the full row's uniform softmax does. dk and dv sum over each
    GQA group's query heads.
    """
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    dv_cols = v.shape[-1]
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    kf, vf = k.float(), v.float()
    dq = torch.empty((B, Sq, Hkv, G, hd), dtype=torch.float32,
                     device=q.device)
    dk = torch.zeros((B, Sk, Hkv, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, Sk, Hkv, dv_cols), dtype=torch.float32,
                     device=q.device)
    for i0 in range(0, Sq, q_chunk):
        i1 = min(Sq, i0 + q_chunk)
        lo, hi = 0, Sk
        if causal:
            hi = min(Sk, q_offset + i1)
        if window > 0:
            lo = max(0, q_offset + i0 - window + 1)
            if q_offset + i1 - 1 >= Sk + window - 1:    # a row sees no key
                lo, hi = 0, Sk
        qc = q[:, i0:i1].float().reshape(B, i1 - i0, Hkv, G, hd)
        doc = do[:, i0:i1].float().reshape(B, i1 - i0, Hkv, G, dv_cols)
        kc, vc = kf[:, lo:hi], vf[:, lo:hi]
        qpos = q_offset + torch.arange(i0, i1, device=q.device)[:, None]
        kpos = torch.arange(lo, hi, device=q.device)[None, :]
        ok = torch.ones((i1 - i0, hi - lo), dtype=torch.bool, device=q.device)
        if causal:
            ok &= kpos <= qpos
        if window > 0:
            ok &= qpos - kpos < window
        # scores, probabilities and their gradient are the chunk's large
        # (B, Hkv, G, rows, keys) f32 tensors: each is written once and
        # updated in place; the scale is applied to q and to dq / dk
        s = torch.einsum("bqhgd,bkhd->bhgqk", qc * scale, kc)
        if causal or window > 0:
            s.masked_fill_(~ok, NEG_INF)
        p = torch.softmax(s, dim=-1)
        del s
        dv[:, lo:hi] += torch.einsum("bhgqk,bqhgd->bkhd", p, doc)
        # softmax VJP: ds = p * (dp - rowsum(p * dp)), and rowsum(p * dp) =
        # do . o with o = p v (the chunk's f32 output): a product, not a
        # pass over the scores
        o = torch.einsum("bhgqk,bkhd->bhgqd", p, vc)
        delta = torch.einsum("bhgqd,bqhgd->bhgq", o, doc)
        ds = torch.einsum("bqhgd,bkhd->bhgqk", doc, vc)
        ds.sub_(delta[..., None]).mul_(p)
        del p
        if lo == 0 and hi == Sk and window > 0:   # rows that see no key:
            ds.masked_fill_(~ok, 0.0)             # their p is not 0 there
        dq[:, i0:i1] = torch.einsum("bhgqk,bkhd->bqhgd", ds, kc) * scale
        dk[:, lo:hi] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qc) * scale
    flash_attention_bwd_ref.calls += 1
    return (dq.reshape(B, Sq, Hq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


flash_attention_bwd_ref.calls = 0   # calls; callers reset it to 0


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
