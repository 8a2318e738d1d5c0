"""Public attention ops: pick the implementation.

``attention_op`` / ``decode_attention_op`` take ``impl``:
  * ``impl="kernel"`` (default) — the kernel's wrapper: the hand-written
    Hopper kernel for a CUDA tensor, the plain version for a CPU tensor.
    Where autograd needs the output's gradient (grad enabled and an input
    that requires it), ``attention_op`` runs the wrapper as the forward of
    ``FlashAttentionFunction``, whose backward is the plain chunked VJP
    (``ref.flash_attention_bwd_ref``); serving, under ``torch.no_grad()``,
    calls the wrapper directly. The decode kernel has no such node: nothing
    trains through a decode step;
  * ``impl="plain"`` — the plain PyTorch version on any device (the yardstick
    the card tests and ``chip_smoke.py`` hold the kernels to; nothing on the
    serving path passes it).

While a dispatch mode that observes them is active (``launch/op_analysis``'s
counter, see ``observer``), each op hands it the call instead of making it,
so the count sees the kernel's own work on every device: a CUDA kernel
dispatches no aten op, and the plain version on the CPU would count its
masked square.

On DTensor inputs (the sharded step, ``dist.sharding.shard_model``) each op
first redistributes its inputs to what the kernel can compute on one rank:
the batch on the data-parallel axes, the query heads on "model" where they
divide it (else the query rows take it, with ``q_offset`` at the rank's
first row), K/V's rows and the decode cache's rows whole (gathered), their
heads on "model" only where both head counts divide it. Then
``torch.distributed.tensor.experimental.local_map`` runs the wrapper (or
``FlashAttentionFunction`` under autograd) on each rank's local shard, which
gets exactly the kv heads its query heads read (the GQA group kept), and the
observer sees that local call. Mixed DTensor and plain inputs raise.

``window_slice`` is the reference's decode-side cut of the cache for
sliding-window layers, kept with the same slice and lengths. The decode
kernel does not need it (its key loop starts at the window's first live row),
so the model does not call it.
"""

from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from repro_torch.dist import sharding as shd
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import (FlashAttentionFunction,
                                                 flash_attention)

IMPLS = ("kernel", "plain")


def observer():
    """The innermost active dispatch mode with ``observe_kernel_ops`` set,
    else None. The dispatch mode stack is per thread, and autograd carries
    it into the threads that run a CUDA backward, where a recompute calls
    these ops again."""
    if torch._C._len_torch_dispatch_stack() == 0:
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if getattr(mode, "observe_kernel_ops", False):
            return mode
    return None


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; want one of {IMPLS}")


def attention_op(q, k, v, *, causal: bool = True, window: int = 0,
                 q_offset: int = 0, softmax_scale: float | None = None,
                 impl: str = "kernel"):
    _check_impl(impl)
    if _sharded(q, k, v):
        return _sharded_attention(q, k, v, causal, window, q_offset,
                                  softmax_scale, impl)
    return _local_attention(q, k, v, causal, window, q_offset, softmax_scale,
                            impl)


def _local_attention(q, k, v, causal, window, q_offset, softmax_scale, impl):
    obs = observer()
    if obs is not None:
        return obs.flash(functools.partial(
            _attention, q, k, v, causal, window, q_offset, softmax_scale,
            impl), q, k, v, causal, window, q_offset)
    return _attention(q, k, v, causal, window, q_offset, softmax_scale, impl)


def _attention(q, k, v, causal, window, q_offset, softmax_scale, impl):
    if impl == "kernel" and (q.requires_grad or k.requires_grad
                             or v.requires_grad) and torch.is_grad_enabled():
        return FlashAttentionFunction.apply(q, k, v, causal, window, q_offset,
                                            softmax_scale)
    fn = ref.flash_attention_ref if impl == "plain" else flash_attention
    return fn(q, k, v, causal=causal, window=window, q_offset=q_offset,
              softmax_scale=softmax_scale)


def decode_attention_op(q, k_cache, v_cache, lengths, *, window: int = 0,
                        softmax_scale: float | None = None,
                        impl: str = "kernel"):
    _check_impl(impl)
    if _sharded(q, k_cache, v_cache, lengths):
        return _sharded_decode(q, k_cache, v_cache, lengths, window,
                               softmax_scale, impl)
    return _local_decode(q, k_cache, v_cache, lengths, window, softmax_scale,
                         impl)


def _local_decode(q, k_cache, v_cache, lengths, window, softmax_scale, impl):
    fn = ref.decode_attention_ref if impl == "plain" else decode_attention
    run = functools.partial(fn, q, k_cache, v_cache, lengths, window=window,
                            softmax_scale=softmax_scale)
    obs = observer()
    return run() if obs is None else obs.decode(run, q, k_cache, v_cache,
                                                lengths, window)


# ---------------------------------------------------------- DTensor inputs
def _sharded(*ts) -> bool:
    """True where every input is a DTensor, False where none is."""
    n = sum(isinstance(t, DTensor) for t in ts)
    if 0 < n < len(ts):
        raise TypeError("attention op: mixed DTensor and plain tensor inputs")
    return n > 0


def _grad_placements(q_pl, kv_pl) -> tuple:
    """K/V's gradient placements: a partial sum over every mesh dim that
    splits the queries but not K/V (each rank's queries read every key)."""
    from torch.distributed.tensor import Partial, Replicate
    return tuple(Partial() if isinstance(b, Replicate)
                 and not isinstance(a, Replicate) else b
                 for a, b in zip(q_pl, kv_pl))


def _kv_heads(k: torch.Tensor, Hq: int, h0: int, hq: int) -> torch.Tensor:
    """The kv heads that query heads [h0, h0 + hq) of Hq read, from all of
    k's (…, Hkv, hd) heads: a run of whole groups, or the one group they
    sit in (the local group size is then hq), else k expanded to one kv
    head per query head."""
    G = Hq // k.shape[-2]
    if h0 % G == 0 and hq % G == 0:
        return k[..., h0 // G:(h0 + hq) // G, :].contiguous()
    if h0 // G == (h0 + hq - 1) // G:
        return k[..., h0 // G:h0 // G + 1, :].contiguous()
    return torch.repeat_interleave(k, G, dim=-2)[..., h0:h0 + hq, :] \
        .contiguous()


def _to(x, mesh, spec):
    return x.redistribute(mesh, shd.placements(mesh, spec))


def _sharded_attention(q, k, v, causal, window, q_offset, softmax_scale,
                       impl):
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    B, Sq, Hq, _ = q.shape
    Hkv = k.shape[2]
    b, s, h, kvh = shd.attention_layout(mesh, B, Hq, Hkv, Sq)
    q_spec, kv_spec = shd.P(b, s, h, None), shd.P(b, None, kvh, None)
    q, k, v = _to(q, mesh, q_spec), _to(k, mesh, kv_spec), \
        _to(v, mesh, kv_spec)
    q_pl, kv_pl = tuple(q.placements), tuple(k.placements)
    h0, row0 = shd.local_offset(q, 2), shd.local_offset(q, 1)
    pick = h is not None and kvh is None

    def local(ql, kl, vl):
        if pick:
            kl, vl = (_kv_heads(kl, Hq, h0, ql.shape[2]),
                      _kv_heads(vl, Hq, h0, ql.shape[2]))
        return _local_attention(ql.contiguous(), kl.contiguous(),
                                vl.contiguous(), causal, window,
                                q_offset + row0, softmax_scale, impl)

    kv_grad = _grad_placements(q_pl, kv_pl)
    return local_map(local, out_placements=(q_pl,),
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh)(q, k, v)


def _sharded_decode(q, k_cache, v_cache, lengths, window, softmax_scale,
                    impl):
    """K2 on each rank's batch rows and query heads against the whole
    cache rows: a cache whose rows are sharded is gathered (the rank's
    softmax is not merged across ranks)."""
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    B, Hq, _ = q.shape
    Hkv = k_cache.shape[2]
    b, _, h, kvh = shd.attention_layout(mesh, B, Hq, Hkv, None)
    kv_spec = shd.P(b, None, kvh, None)
    q = _to(q, mesh, shd.P(b, h, None))
    k_cache, v_cache = _to(k_cache, mesh, kv_spec), _to(v_cache, mesh,
                                                        kv_spec)
    lengths = _to(lengths, mesh, shd.P(b))
    q_pl, kv_pl = tuple(q.placements), tuple(k_cache.placements)
    h0 = shd.local_offset(q, 1)
    pick = h is not None and kvh is None

    def local(ql, kl, vl, ll):
        if pick:
            kl, vl = (_kv_heads(kl, Hq, h0, ql.shape[1]),
                      _kv_heads(vl, Hq, h0, ql.shape[1]))
        return _local_decode(ql.contiguous(), kl.contiguous(),
                             vl.contiguous(), ll.contiguous(), window,
                             softmax_scale, impl)

    return local_map(local, out_placements=(q_pl,),
                     in_placements=(q_pl, kv_pl, kv_pl,
                                    tuple(lengths.placements)),
                     device_mesh=mesh)(q, k_cache, v_cache, lengths)


def window_slice(cache: torch.Tensor, lengths: torch.Tensor, window: int,
                 block: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """Slice the last ``window`` (block-aligned) cache entries per batch row.

    cache: (B, S, H, hd); returns (sliced (B, W', H, hd), new lengths).
    W' = window rounded up to ``block`` + one extra block of slack so the
    slice start can be block-aligned.
    """
    B, S, H, hd = cache.shape
    Wp = min(S, ((window + block - 1) // block + 1) * block)
    start = torch.clamp(lengths - window, min=0)
    start = torch.div(start, block, rounding_mode="floor") * block
    start = torch.clamp(start, 0, S - Wp)
    idx = start[:, None].long() + torch.arange(Wp, device=cache.device)[None]
    rows = torch.arange(B, device=cache.device)[:, None]
    return cache[rows, idx], lengths - start
