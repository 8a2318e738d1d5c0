"""ServingEngine / TorchComputeBackend: the mean host wall of the span
``decode.launch`` (from after the tokens' upload to before the argmax's
read-back: ``M.decode_step`` and the argmax enqueued), ms. The records cover
the traced slice of a --trace 1 run (the profiler is active only there), not
the whole window. Moves served_tok_per_s."""

from work import spans
from work.readers import mean_ms


def read(rec):
    s = spans.records()
    if s is None:
        return None
    return mean_ms([spans.seconds(x) for x in spans.named(s, "decode.launch")])
