"""The port's tracer: named, nested host spans with integer attributes.

    from repro_torch import obs

    with obs.span("engine.step") as sp:
        ...
        if sp.on:                      # attributes cost only while tracing
            sp.set(live=n, slots=m)

Tracing is on while a ``torch.profiler`` profile is active, or between
:func:`enable` and :func:`disable` (an operator's switch). Off, :func:`span`
reads one module flag and the profiler's flag, and returns one shared object
whose methods do nothing: no allocation, no torch call.

On, a span reads ``time.perf_counter_ns()`` as it opens and as it closes,
remembers the span open on its thread when it began (its parent), and keeps
integer attributes (``sid``, ``tokens``, ``live``, ``slots``, ``bytes``,
``live_bytes``, ...). While a profiler is active it also opens a
``record_function`` range of its name, so the span lies on the profiler's
timeline, on the clock of the device's events. A closed span goes to a
buffer of :data:`CAPACITY` records; past that it is counted as dropped and
not stored.

Readers: :func:`records` (the buffer, for the benchmark), :func:`summary`
(per name: count, seconds, self seconds, attribute sums, for an operator),
:func:`reset`.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import defaultdict

import torch.autograd.profiler as _profiler

CAPACITY = 1 << 16              # records kept; later spans are only counted

_on = False                     # enable() / disable()
_lock = threading.Lock()
_buffer: list[SpanRecord] = []
_dropped = 0
_ids = itertools.count(1)
_open = threading.local()       # .stack: the spans open on this thread


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One closed span: ``start_ns`` / ``end_ns`` on
    ``time.perf_counter_ns``'s clock; ``parent`` is the ``id`` of the span
    open on the same thread when it began (None at the top)."""

    name: str
    id: int
    parent: int | None
    start_ns: int
    end_ns: int
    attrs: dict[str, int]

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclasses.dataclass(frozen=True)
class Records:
    """The buffer's spans in the order they closed, and how many closed
    spans found it full."""

    spans: tuple[SpanRecord, ...]
    dropped: int


class _Off:
    """What :func:`span` returns while tracing is off: one shared object."""

    __slots__ = ()
    on = False

    def __enter__(self) -> _Off:
        return self

    def __exit__(self, typ, val, tb) -> None:
        return None

    def set(self, **attrs: int) -> None:
        pass

    def at(self, start_ns: int, end_ns: int) -> None:
        pass


_OFF = _Off()


class _Span:
    """An open span while tracing is on; closed, it becomes a
    :class:`SpanRecord` in the buffer."""

    __slots__ = ("name", "id", "parent", "start_ns", "end_ns", "attrs",
                 "_range", "_pinned")
    on = True

    def __init__(self, name: str) -> None:
        self.name = name
        self.attrs: dict[str, int] = {}
        self._range = None
        self._pinned = False

    def __enter__(self) -> _Span:
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        stack.append(self)
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, typ, val, tb) -> None:
        if not self._pinned:
            self.end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(typ, val, tb)
        _open.stack.pop()
        _store(SpanRecord(self.name, self.id, self.parent, self.start_ns,
                          self.end_ns, self.attrs))

    def set(self, **attrs: int) -> None:
        """Integer attributes of the span (its counters)."""
        for k, v in attrs.items():
            self.attrs[k] = int(v)

    def at(self, start_ns: int, end_ns: int) -> None:
        """Take the caller's own clock reads (``time.perf_counter_ns``) as
        the span's start and end, so that a time the caller reports and the
        span's are one measurement."""
        self.start_ns, self.end_ns, self._pinned = start_ns, end_ns, True


def _store(rec: SpanRecord) -> None:
    global _dropped
    with _lock:
        if len(_buffer) < CAPACITY:
            _buffer.append(rec)
        else:
            _dropped += 1


def span(name: str):
    """A context manager that records the span ``name`` while tracing is
    on, and the shared no-op object while it is off. It takes no
    attributes: a ``**attrs`` parameter would build a dict on every call,
    off or on; :meth:`set` takes them once the span is open."""
    if not (_on or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name)


def enable() -> None:
    """Record spans whether or not a profiler is active."""
    global _on
    _on = True


def disable() -> None:
    """Record spans only while a profiler is active."""
    global _on
    _on = False


def records() -> Records:
    with _lock:
        return Records(tuple(_buffer), _dropped)


def reset() -> None:
    """Empty the buffer and zero the dropped count."""
    global _dropped
    with _lock:
        _buffer.clear()
        _dropped = 0


def summary() -> dict[str, dict]:
    """Per span name: ``count``, ``seconds`` (summed durations),
    ``self_seconds`` (each duration less the part its children cover) and
    ``attrs`` (each attribute summed)."""
    recs = records().spans
    children: dict[int, list[SpanRecord]] = defaultdict(list)
    for r in recs:
        if r.parent is not None:
            children[r.parent].append(r)
    out: dict[str, dict] = {}
    for r in recs:
        s = out.setdefault(r.name, {"count": 0, "seconds": 0.0,
                                    "self_seconds": 0.0, "attrs": {}})
        s["count"] += 1
        s["seconds"] += r.seconds
        s["self_seconds"] += r.seconds - _covered_ns(r, children[r.id]) / 1e9
        for k, v in r.attrs.items():
            s["attrs"][k] = s["attrs"].get(k, 0) + v
    return out


def _covered_ns(r: SpanRecord, kids: list[SpanRecord]) -> int:
    """Nanoseconds of ``r`` that the union of its children's spans
    covers."""
    total, end = 0, r.start_ns
    for c in sorted(kids, key=lambda c: c.start_ns):
        a, b = max(c.start_ns, end), min(c.end_ns, r.end_ns)
        if b > a:
            total += b - a
            end = b
    return total
