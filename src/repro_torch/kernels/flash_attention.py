"""Blockwise fused attention (prefill) — the Hopper kernel's wrapper.

The kernel is ``csrc/flash_attention.cu``; it replaces the TPU kernel in the
reference's ``kernels/flash_attention.py``. For a CUDA tensor this wrapper
launches it or raises; for a CPU tensor it returns the plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

MAX_HD = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    softmax_scale: float | None = None) -> torch.Tensor:
    """q: (B, Sq, Hq, hd); k/v: (B, Sk, Hkv, hd). Returns (B, Sq, Hq, hd)."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset,
                                       softmax_scale=softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
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
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    lib = _build.load()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, Hq, Hkv, hd, int(causal), int(window), int(q_offset),
            ctypes.c_float(scale), _DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0      # kernel launches; callers reset it to 0
