"""Single-token decode attention vs a KV cache — the Hopper kernel's wrapper.

The kernel is ``csrc/decode_attention.cu``; it replaces the TPU kernel in the
reference's ``kernels/decode_attention.py``. For a CUDA tensor this wrapper
launches it or raises; for a CPU tensor it returns the plain version
(:func:`repro_torch.kernels.ref.decode_attention_ref`).

The kernel's grid is fixed by the cache length: one block per
:func:`chunk_size` keys of each (b, kv-head) (:func:`chunk_grid`). A block
streams the live rows of its chunk and a second small kernel merges the
chunks' partial softmax states in chunk order.

For a ``meta`` tensor (the dry run) the wrapper returns an empty output of the
kernel's shape and dtype: it launches nothing and leaves the count alone.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

MAX_HD = 256
CHUNK = 192            # keys per block at hd <= 128 } tried on the card:
CHUNK_WIDE = 128       # keys per block at hd > 128  } PERF.md, section 6
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}   # elements in a 16-byte load


def chunk_size(hd: int) -> int:
    """Keys per block: a wide row (hd > 128) fills a warp on its own and takes
    a shorter chunk, so that as many blocks stream."""
    return CHUNK if hd <= 128 else CHUNK_WIDE


def chunk_grid(S: int, chunk: int = CHUNK) -> int:
    """Blocks per (b, kv-head): the grid's first dimension, fixed by S."""
    return -(-S // chunk)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     window: int = 0,
                     softmax_scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, hd); caches: (B, S, Hkv, hd); lengths: (B,) int32.

    Returns (B, Hq, hd). The query sits at absolute position lengths-1;
    lengths beyond S are clamped to S.
    """
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, lengths,
                                        window=window,
                                        softmax_scale=softmax_scale)
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if q.ndim != 3 or k_cache.ndim != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k_cache.shape)} v{tuple(v_cache.shape)}")
    B, Hq, hd = q.shape
    Bk, S, Hkv, hdk = k_cache.shape
    if Bk != B or hdk != hd or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"decode_attention: q{tuple(q.shape)} does not match "
                         f"cache{tuple(k_cache.shape)} (GQA needs Hq % Hkv == 0)")
    if not 0 < hd <= MAX_HD:
        raise ValueError(f"decode_attention: head dim {hd} not in 1..{MAX_HD}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention: dtypes {q.dtype}/{k_cache.dtype}/"
                        f"{v_cache.dtype}; the kernel takes float32 or "
                        f"bfloat16")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise TypeError(f"decode_attention: lengths must be ({B},) int32, got "
                        f"{tuple(lengths.shape)} {lengths.dtype}")
    if not all(t.device == q.device for t in (k_cache, v_cache, lengths)):
        raise ValueError("decode_attention: inputs on different devices")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, lengths)):
        raise ValueError("decode_attention: inputs must be contiguous")
    if B == 0 or S == 0:
        raise ValueError("decode_attention: empty input")
    vec = _VEC[q.dtype]
    if hd % vec:
        raise ValueError(f"decode_attention: head dim {hd} is not a multiple "
                         f"of {vec}: the kernel reads 16-byte vectors of "
                         f"{q.dtype}")
    if (q.data_ptr() | k_cache.data_ptr() | v_cache.data_ptr()) % 16:
        raise ValueError("decode_attention: q and the caches must start on a "
                         "16-byte boundary (the kernel's vector loads)")
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    # one block per chunk_size(hd) keys; the chunks' partial states: acc
    # (n_part, hd) then (m, l) (n_part, 2)
    chunk = chunk_size(hd)
    lib = _build.load()
    n_part = chunk_grid(S, chunk) * B * Hq
    out = torch.empty_like(q)
    part = torch.empty(n_part * (hd + 2), dtype=torch.float32,
                       device=q.device)
    with torch.cuda.device(q.device):
        err = lib.repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
            part.data_ptr() + 4 * n_part * hd, B, S, Hq, Hkv, hd, int(window),
            ctypes.c_float(scale), chunk, _DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0     # kernel launches; callers reset it to 0
