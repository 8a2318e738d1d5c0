"""Reductions the per-layer metric files share: each metric file names its
inputs and calls one of these. A reader that finds nothing returns None."""

from __future__ import annotations

import collections

import harness
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


def _attention_calls(model: dict) -> list[tuple]:
    """The family's (Hq, Hkv, hd, dv, window) of each attention call."""
    return harness.family_rules(model).attention_calls(model)


def k1_roofline(rec, kernels, cases) -> float | None:
    """Percent: the least time of the K1 calls ``cases``, each a
    (flash_work case, dv) pair (flash_work's operations and bytes at the
    card's peaks), over the device time of the traced slice's events named
    by ``kernels``."""
    p = rec.profile
    if p is None or not cases:
        return None
    t = p.kernel_seconds(kernels)
    if t <= 0:
        return None
    size = _itemsize(rec.work["model"])
    least = sum(peaks.least_seconds(*roofline.flash_work(c, size, dv))
                for c, dv in cases)
    return 100.0 * least / t


def prefill_cases(rec, prompts) -> list[tuple]:
    """K1's (case, dv) for each prefill of ``prompts`` tokens: each of the
    family's attention calls, causal, at the prompt's length."""
    calls = _attention_calls(rec.work["model"])
    return [((1, S, S, Hq, Hkv, hd, True, window, 0), dv)
            for S in prompts for Hq, Hkv, hd, dv, window in calls]


def k2_roofline(rec, kernels) -> float | None:
    """Percent: decode_work's least time of every K2 call of the traced
    slice (each of the family's attention calls, each step at its slots'
    lengths; K2 reads V at hd) over the device time of the events named by
    ``kernels``."""
    p = rec.profile
    steps = rec.work.get("k2_lengths")
    if p is None or not steps:
        return None
    t = p.kernel_seconds(kernels)
    if t <= 0:
        return None
    model = rec.work["model"]
    size = _itemsize(model)
    calls = collections.Counter((Hq, Hkv, hd, window) for Hq, Hkv, hd, _,
                                window in _attention_calls(model))
    least = 0.0
    for lengths in steps:
        for (Hq, Hkv, hd, window), n in calls.items():
            case = (len(lengths), rec.work["max_seq"], Hq, Hkv, hd, window)
            least += n * peaks.least_seconds(
                *roofline.decode_work(case, lengths, size))
    return 100.0 * least / t
