"""Reductions the per-layer metric files share: each metric file names its
inputs and calls one of these. A reader that finds nothing returns None."""

from __future__ import annotations

from work import peaks, roofline


def share(num: float | None, den: float | None) -> float | None:
    """``num / den`` in percent, None without a base."""
    if num is None or not den:
        return None
    return 100.0 * num / den


def mean_ms(seconds: list[float] | None) -> float | None:
    return 1e3 * sum(seconds) / len(seconds) if seconds else None


def idle_share(rec) -> float | None:
    """Percent of the traced slice's wall in which no device event ran."""
    p = rec.profile
    if p is None or p.window_s <= 0 or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)


def _itemsize(model: dict) -> int:
    return 2 if model.get("dtype", "bfloat16") in ("bfloat16", "float16") \
        else 4


def _dims(model: dict) -> tuple[int, int, int]:
    hd = model.get("head_dim") or model["d_model"] // model["n_heads"]
    return model["n_heads"], model["n_kv_heads"], hd


def k1_roofline(rec, kernels, cases) -> float | None:
    """Percent: the least time of the K1 calls ``cases`` (flash_work's
    operations and bytes at the card's peaks) over the device time of the
    traced slice's events named by ``kernels``."""
    p = rec.profile
    if p is None or not cases:
        return None
    t = p.kernel_seconds(kernels)
    if t <= 0:
        return None
    size = _itemsize(rec.work["model"])
    least = sum(peaks.least_seconds(*roofline.flash_work(c, size))
                for c in cases)
    return 100.0 * least / t


def prefill_cases(rec, prompts) -> list[tuple]:
    """K1's case for each prefill of ``prompts`` tokens: one call a layer
    (causal, no window)."""
    model = rec.work["model"]
    Hq, Hkv, hd = _dims(model)
    return [(1, S, S, Hq, Hkv, hd, True, 0, 0)
            for S in prompts for _ in range(model["n_layers"])]


def k2_roofline(rec, kernels) -> float | None:
    """Percent: decode_work's least time of every K2 call of the traced
    slice (one a layer, each step at its slots' lengths)
    over the device time of the events named by ``kernels``."""
    p = rec.profile
    steps = rec.work.get("k2_lengths")
    if p is None or not steps:
        return None
    t = p.kernel_seconds(kernels)
    if t <= 0:
        return None
    model = rec.work["model"]
    Hq, Hkv, hd = _dims(model)
    size = _itemsize(model)
    per = model["n_layers"]
    least = 0.0
    for lengths in steps:
        case = (len(lengths), rec.work["max_seq"], Hq, Hkv, hd, 0)
        least += per * peaks.least_seconds(
            *roofline.decode_work(case, lengths, size))
    return 100.0 * least / t
