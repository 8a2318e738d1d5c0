"""Single-token decode attention vs a KV cache — the Hopper kernel's wrapper.

The kernel is ``csrc/decode_attention.cu``; it replaces the TPU kernel in the
reference's ``kernels/decode_attention.py``. For a CUDA tensor this wrapper
launches it or raises; for a CPU tensor it returns the plain version
(:func:`repro_torch.kernels.ref.decode_attention_ref`).

The wrapper splits each (b, kv-head)'s live key range over ``nsplit`` blocks
when ``B * Hkv`` blocks alone would leave most of the card's SMs idle; the
kernel then merges the partial softmax states in a second pass.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

MAX_HD = 256
MAX_SMEM = 227 * 1024          # dynamic shared memory one block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _hd_bucket(hd: int) -> int:
    return 64 if hd <= 64 else 128 if hd <= 128 else 256


def _block_k(hd: int) -> int:
    return 32 if _hd_bucket(hd) == 256 else 64


def n_splits(B: int, Hkv: int, S: int, hd: int, n_sms: int) -> int:
    """Blocks per (b, kv-head): enough for two blocks per SM, but never more
    than the cache has key tiles."""
    want = -(-2 * n_sms // (B * Hkv))
    return max(1, min(want, -(-S // _block_k(hd))))


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
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    lib = _build.load()
    G = Hq // Hkv
    smem = lib.repro_decode_attention_smem(G, hd)
    if smem > MAX_SMEM:
        raise ValueError(f"decode_attention: group size {G} at head dim {hd} "
                         f"needs {smem} B of shared memory (> {MAX_SMEM})")
    n_sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    nsplit = n_splits(B, Hkv, S, hd, n_sms)
    out = torch.empty_like(q)
    if nsplit > 1:
        part_acc = torch.empty((nsplit, B * Hkv, G, _hd_bucket(hd)),
                               dtype=torch.float32, device=q.device)
        part_ml = torch.empty((nsplit, B * Hkv, G, 2), dtype=torch.float32,
                              device=q.device)
        pa, pm = part_acc.data_ptr(), part_ml.data_ptr()
    else:
        pa = pm = None
    with torch.cuda.device(q.device):
        err = lib.repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), pa, pm, B, S, Hq, Hkv, hd,
            int(window), ctypes.c_float(scale), nsplit, _DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0     # kernel launches; callers reset it to 0
