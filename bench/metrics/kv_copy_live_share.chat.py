"""Router + LocStore: percent of the bytes that parks and resumes copy (a whole
slot each) that hold the session's live rows: the attribute ``live_bytes``
summed over the ``engine.park`` and ``engine.resume`` spans, over their
``bytes``. The records cover the traced slice of a --trace 1 run (the
profiler is active only there), not the whole window. Moves ttft_p90_s."""

from work import spans


def read(rec):
    s = spans.records()
    if s is None:
        return None
    return spans.attr_share(s, "live_bytes", "bytes", "engine.park",
                            "engine.resume")
