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

``window_slice`` is the reference's decode-side cut of the cache for
sliding-window layers, kept with the same slice and lengths. The decode
kernel does not need it (its key loop starts at the window's first live row),
so the model does not call it.
"""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

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
    fn = ref.decode_attention_ref if impl == "plain" else decode_attention
    run = functools.partial(fn, q, k_cache, v_cache, lengths, window=window,
                            softmax_scale=softmax_scale)
    obs = observer()
    return run() if obs is None else obs.decode(run, q, k_cache, v_cache,
                                                lengths, window)


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
