"""Mamba2 + shared block: percent of a prefill's host wall spent in its
Mamba2 layers: the spans ``mamba.prefill`` (one a Mamba2 layer, attributes
``tokens`` and ``chunks``) summed, over the spans ``prefill`` summed. The
records cover the traced slice of a --trace 1 run, not the whole window; a
program without such spans gives None. Moves served_tok_per_s."""

from work import spans
from work.readers import share


def read(rec):
    s = spans.records()
    if s is None:
        return None
    part = spans.named(s, "mamba.prefill")
    if not part:
        return None
    return share(sum(spans.seconds(x) for x in part),
                 sum(spans.seconds(x) for x in spans.named(s, "prefill")))
