"""Blockwise fused attention (prefill) — the Hopper kernel's wrapper.

The kernel is ``csrc/flash_attention.cu``; it replaces the TPU kernel in the
reference's ``kernels/flash_attention.py``. For a CUDA tensor this wrapper
launches it or raises; for a CPU tensor it returns the plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`).

The kernel is chosen by dtype: bfloat16 (the serving path) runs on the
tensor cores (``wgmma``) fed by TMA, which reads q, k and v through the
tensor maps this wrapper describes (:func:`tma_args`) and so needs
hd % 8 == 0 and 16-byte aligned inputs; float32 runs on the CUDA cores,
because tensor-core f32 is TF32 and would miss the 2e-5 f32 tolerance.

The kernel has no gradient of its own, and neither has the TPU kernel it
replaces. Training calls it as the forward of :class:`FlashAttentionFunction`,
whose backward is the plain chunked VJP
(:func:`repro_torch.kernels.ref.flash_attention_bwd_ref`). The wrapper refuses
to run the kernel where autograd would need a gradient of its output, so an
output without a gradient path cannot reach a training step.

For a ``meta`` tensor (the dry run) the wrapper returns an empty output of the
kernel's shape and dtype: it launches nothing and leaves the count alone.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

MAX_HD = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
Q_ROWS = 64                       # query rows per TMA box: one warpgroup's


def block_k(hd: int) -> int:
    """Keys per K/V tile (and TMA box) of the bf16 kernel at head dim hd. The
    launch refuses boxes that are not the tile it was compiled for."""
    return 128 if hd <= 64 else 64


def tensor_map_geometry(shape: tuple[int, int, int, int],
                        rows: int) -> tuple[tuple[int, ...], tuple[int, ...],
                                            tuple[int, ...]]:
    """The TMA view of a contiguous bf16 tensor of ``shape`` (B, S, H, hd)
    read in boxes of ``rows`` rows: dims innermost first (hd, H, S, B), byte
    strides of dims 1..3, and the box (64 columns, 1 head, rows, 1 batch).
    TMA wants every stride a multiple of 16 bytes."""
    B, S, H, hd = shape
    e = 2
    return ((hd, H, S, B), (e * hd, e * hd * H, e * hd * H * S),
            (64, 1, rows, 1))


@functools.lru_cache(maxsize=256)
def tma_args(q_shape: tuple[int, ...],
             kv_shape: tuple[int, ...]) -> ctypes.Array:
    """What the bf16 launch encodes its tensor maps from: q's geometry in
    boxes of Q_ROWS rows, then k's and v's in boxes of block_k(hd) rows, each
    as dims, strides, box (11 numbers)."""
    geo = (tensor_map_geometry(q_shape, Q_ROWS),
           tensor_map_geometry(kv_shape, block_k(q_shape[3])))
    flat = [x for g in geo for part in g for x in part]
    return (ctypes.c_ulonglong * len(flat))(*flat)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    softmax_scale: float | None = None) -> torch.Tensor:
    """q: (B, Sq, Hq, hd); k/v: (B, Sk, Hkv, hd). Returns (B, Sq, Hq, hd)."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset,
                                       softmax_scale=softmax_scale)
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if (q.requires_grad or k.requires_grad or v.requires_grad) \
            and torch.is_grad_enabled():
        raise RuntimeError("flash_attention: the kernel has no gradient; "
                           "inputs that require grad go through "
                           "FlashAttentionFunction (ops.attention_op)")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, Sq, Hq, hd = q.shape
    Bk, Sk, Hkv, hdk = k.shape
    if Bk != B or hdk != hd or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: q{tuple(q.shape)} does not match "
                         f"k{tuple(k.shape)} (GQA needs Hq % Hkv == 0)")
    if not 0 < hd <= MAX_HD:
        raise ValueError(f"flash_attention: head dim {hd} not in 1..{MAX_HD}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes float32 or bfloat16")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if Sq == 0 or Sk == 0 or B == 0:
        raise ValueError("flash_attention: empty input")
    if q.dtype == torch.bfloat16:
        if hd % 8:
            raise ValueError(f"flash_attention: bf16 head dim {hd} is not a "
                             f"multiple of 8 (TMA needs 16-byte strides)")
        if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
            raise ValueError("flash_attention: bf16 q, k, v must start on a "
                             "16-byte boundary (TMA)")
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    tma = tma_args(tuple(q.shape), tuple(k.shape)) \
        if q.dtype == torch.bfloat16 else None
    lib = _build.load()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, Hq, Hkv, hd, int(causal), int(window), int(q_offset),
            ctypes.c_float(scale), _DTYPES[q.dtype], tma,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0      # kernel launches; callers reset it to 0


class FlashAttentionFunction(torch.autograd.Function):
    """The kernel as the forward of an autograd node: forward launches it
    through :func:`flash_attention` (the plain version for CPU tensors),
    backward runs the plain chunked VJP on the saved q, k, v. Under
    per-layer recompute the forward runs twice a layer and the backward
    once."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_offset: int,
                softmax_scale: float | None):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset,
                        softmax_scale=softmax_scale)
        return flash_attention(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        with torch.autograd.profiler.record_function(
                "flash_attention_bwd_plain"):
            dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, do, **ctx.opts)
        return dq, dk, dv, None, None, None, None
