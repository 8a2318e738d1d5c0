"""ServingEngine / TorchComputeBackend: percent of a prefill's host wall spent
enqueuing it: the span ``prefill.launch`` (``M.prefill`` and the argmax
enqueued) summed, over the span ``prefill`` (between the two syncs around
it, the seconds ``TorchComputeBackend.prefill`` returns) summed. The records
cover the traced slice of a --trace 1 run (the profiler is active only
there), not the whole window. Moves served_tok_per_s."""

from work import spans
from work.readers import share


def read(rec):
    s = spans.records()
    if s is None:
        return None
    return share(sum(spans.seconds(x)
                     for x in spans.named(s, "prefill.launch")),
                 sum(spans.seconds(x) for x in spans.named(s, "prefill")))
