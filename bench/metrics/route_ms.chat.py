"""Router + LocStore: the mean self time of the span ``router.follow_up``
(``Router.follow_up``'s host wall less its child spans: a resume, a victim's
park, a migrate's prefill), ms: the routing decision, the store's lookups
and the bookkeeping. The records cover the traced slice of a --trace 1 run
(the profiler is active only there), not the whole window. Moves ttft_p90_s."""

from work import spans
from work.readers import mean_ms


def read(rec):
    s = spans.records()
    if s is None:
        return None
    return mean_ms(spans.self_seconds(s, "router.follow_up"))
