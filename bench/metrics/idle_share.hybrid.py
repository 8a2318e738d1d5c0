"""Device, hybrid cell: percent of the traced slice with no device event
running (1 - the union of the profiler's device spans over the slice's
wall). Moves served_tok_per_s."""

from work.readers import idle_share


def read(rec):
    return idle_share(rec)
