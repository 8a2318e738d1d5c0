"""Router + LocStore: the mean host wall of a park or a resume, the spans
``engine.park`` (the slot read, ``store.put``, bookkeeping) and
``engine.resume`` (``store.get``, the slot write, ``store.put``), ms. The
records cover the traced slice of a --trace 1 run (the profiler is active
only there), not the whole window. Moves ttft_p90_s."""

from work import spans
from work.readers import mean_ms


def read(rec):
    s = spans.records()
    if s is None:
        return None
    return mean_ms([spans.seconds(x)
                    for x in spans.named(s, "engine.park", "engine.resume")])
