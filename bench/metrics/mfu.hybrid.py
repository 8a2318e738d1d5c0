"""Whole step (``models/model.py``), hybrid cell: model FLOPs of the tokens
prefilled and decoded in the window (``bench/families/hybrid.py``: 2 FLOPs
a weight a token, the SSD's products and attention from the shapes) over
the window's seconds at 989 TFLOP/s, in percent. Moves served_tok_per_s."""

from work import flops, peaks


def read(rec):
    w = rec.work
    if not rec.window_s or "prefill_lengths" not in w:
        return None
    f = flops.serve_flops(w["model"], w["prefill_lengths"],
                          w["decode_tokens"], w["decode_ctx"])
    return 100.0 * f / (rec.window_s * peaks.PEAK_BF16_FLOPS)
