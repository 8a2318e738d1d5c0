"""ServingEngine: percent of the pooled decode steps that replayed the
engine's captured CUDA graph: the attribute ``graphed`` (1 for a replay, 0
for a step run op by op) summed over the ``decode.launch`` spans, over
their ``steps``. The records cover the traced slice of a --trace 1 run,
not the whole window; a program whose spans carry no such attribute gives
None. Moves served_tok_per_s."""

from work import spans


def read(rec):
    s = spans.records()
    if s is None:
        return None
    return spans.attr_share(s, "graphed", "steps", "decode.launch")
