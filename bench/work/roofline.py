"""Operations and bytes of the program's two attention kernels from their
shapes: copies of ``repro_torch.launch.op_analysis.flash_work`` (K1,
``kernels/flash_attention.py``) and ``decode_work`` (K2,
``kernels/decode_attention.py``); ``bench/tests/test_bench_work.py`` holds
them equal to the program's."""

from __future__ import annotations

import numpy as np


def flash_work(case, itemsize: int, dv: int | None = None
               ) -> tuple[float, float]:
    """(operations, bytes) K1 needs for ``case`` = (B, Sq, Sk, Hq, Hkv, hd,
    causal, window, q_offset): 2 * (hd + dv) per visible (q, k) pair per
    q-head; q, k, v read once and o written once. ``dv`` is V's and the
    output's width (default hd)."""
    B, Sq, Sk, Hq, Hkv, hd, causal, window, off = case
    dv = hd if dv is None else dv
    qp = off + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(Sk - 1, qp) if causal else np.full(Sq, Sk - 1, np.int64)
    lo = np.maximum(0, qp - window + 1) if window > 0 else 0
    pairs = int(np.maximum(0, hi - lo + 1).sum())
    ops = 2.0 * B * Hq * (hd + dv) * pairs
    nbytes = itemsize * (B * Sq * Hq * (hd + dv) + B * Sk * Hkv * (hd + dv))
    return ops, nbytes


def decode_work(case, lengths: list[int], itemsize: int
                ) -> tuple[float, float]:
    """(operations, bytes) K2 needs for ``case`` = (B, S, Hq, Hkv, hd,
    window) at these lengths: only the live rows of the cache are read
    (clamped to S, cut to the window)."""
    B, S, Hq, Hkv, hd, window = case
    live = [min(n, S) if window <= 0 else min(min(n, S), window)
            for n in lengths]
    ops = 4.0 * Hq * hd * sum(live)
    nbytes = itemsize * (2 * Hkv * hd * sum(live) + 2 * B * Hq * hd) \
        + 4 * B
    return ops, nbytes
