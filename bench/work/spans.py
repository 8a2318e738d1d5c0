"""The program's own spans, as the metric readers take them.

``repro_torch.obs`` records a span at each boundary of the serving path
while a ``torch.profiler`` profile is active: in a ``--trace 1`` run that is
the traced slice (:class:`work.busy.TraceSlice`) and nothing else, so these
readings cover the slice, not the whole window. A program without the
tracer, a run with no records, or a buffer that dropped any span, gives
None.
"""

from __future__ import annotations


def records():
    """The spans the program recorded, or None (no tracer, no spans, or
    spans dropped)."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    r = obs.records()
    if not r.spans or r.dropped:
        return None
    return r.spans


def named(spans, *names: str) -> list:
    return [s for s in spans if s.name in names]


def seconds(s) -> float:
    return (s.end_ns - s.start_ns) / 1e9


def self_seconds(spans, name: str) -> list[float]:
    """Each ``name`` span's duration less the part its children cover."""
    kids: dict[int, list] = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault(s.parent, []).append(s)
    out = []
    for s in named(spans, name):
        covered, end = 0, s.start_ns
        for c in sorted(kids.get(s.id, ()), key=lambda c: c.start_ns):
            a, b = max(c.start_ns, end), min(c.end_ns, s.end_ns)
            if b > a:
                covered += b - a
                end = b
        out.append((s.end_ns - s.start_ns - covered) / 1e9)
    return out


def attr_share(spans, num: str, den: str, *names: str) -> float | None:
    """Percent: attribute ``num`` summed over the ``names`` spans, over
    ``den`` summed over them; None without a base."""
    sel = named(spans, *names)
    d = sum(s.attrs.get(den, 0) for s in sel)
    if not d:
        return None
    return 100.0 * sum(s.attrs.get(num, 0) for s in sel) / d
