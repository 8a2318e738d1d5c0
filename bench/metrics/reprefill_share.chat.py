"""Router + LocStore: percent of the follow-up turns whose history was
prefilled again, over the window: those the Router sent to a
migrate-and-re-prefill (its ``migrations`` over its locality hits and
misses) and those whose cache was gone before they came (the conversation
finished to keep the parked slices on the card under the mix's
``max_parked``, or never held), counted by the benchmark as ``rebuilds``.
Moves ttft_p90_s."""

from work.readers import share


def read(rec):
    c = rec.counters
    if c.get("followups") is None:
        return None
    rebuilt = c.get("rebuilds", 0)
    return share(c.get("migrations", 0) + rebuilt, c["followups"] + rebuilt)
