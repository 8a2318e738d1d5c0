"""Mamba2 + shared block: percent of the prefills' Mamba2-layer tokens whose
chunked SSD ran in the hand-written CUDA kernels: the attribute
``fused_tokens`` (the layer's tokens when the kernels computed its SSD, 0
when the plain version did) summed over the ``mamba.prefill`` spans, over
their ``tokens``. The records cover the traced slice of a --trace 1 run,
not the whole window; a program whose spans carry no ``fused_tokens``
reads 0, and one without the spans or the tracer gives None. Moves
served_tok_per_s."""

from work import spans


def read(rec):
    s = spans.records()
    if s is None:
        return None
    return spans.attr_share(s, "fused_tokens", "tokens", "mamba.prefill")
