"""ServingEngine: percent of the pooled decode step's slots that held a live
session: the attribute ``live`` summed over the ``engine.step`` spans, over
their ``slots`` (each engine's ``max_batch``). The records cover the traced
slice of a --trace 1 run (the profiler is active only there), not the whole
window. Moves ttft_p90_s."""

from work import spans


def read(rec):
    s = spans.records()
    if s is None:
        return None
    return spans.attr_share(s, "live", "slots", "engine.step")
