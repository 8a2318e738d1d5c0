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

``window_slice`` is the reference's decode-side cut of the cache for
sliding-window layers, kept with the same slice and lengths. The decode
kernel does not need it (its key loop starts at the window's first live row),
so the model does not call it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import (FlashAttentionFunction,
                                                 flash_attention)

IMPLS = ("kernel", "plain")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; want one of {IMPLS}")


def attention_op(q, k, v, *, causal: bool = True, window: int = 0,
                 q_offset: int = 0, softmax_scale: float | None = None,
                 impl: str = "kernel"):
    _check_impl(impl)
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
    fn = ref.decode_attention_ref if impl == "plain" else decode_attention
    return fn(q, k_cache, v_cache, lengths, window=window,
              softmax_scale=softmax_scale)


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
