"""Model FLOPs of the work a window did, from the configuration's sizes: the
family's ``serve_flops`` (``bench/families/<family>.py``)."""

from __future__ import annotations

import harness


def serve_flops(model: dict, prefill_lengths, decode_tokens: int,
                decode_ctx: int) -> float:
    """The FLOPs of the window's prefills of ``prefill_lengths`` tokens and
    of ``decode_tokens`` decoded tokens, which read ``decode_ctx`` cached
    rows in all."""
    return harness.family_rules(model).serve_flops(
        model, prefill_lengths, decode_tokens, decode_ctx)
