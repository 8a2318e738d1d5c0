"""Device time from a ``torch.profiler`` trace of a slice of the window.

``busy_ms``, ``device_intervals``, ``range_events`` and ``range_busy_ms``
are copies of ``repro_torch.launch.profile_cell`` (device busy as the union
of the device events' spans; a record_function range's time by the kernels
it launched); ``bench/tests/test_bench_work.py`` holds them equal to the
program's. :class:`TraceSlice` profiles one stretch of a run and keeps what
the metric readers and the result line's breakdown need.
"""

from __future__ import annotations

import bisect
import math
import time
from collections import defaultdict

# record_function ranges of the program's train step (the plain attention
# backward, AdamW): their own device spans cover other events and the gaps
# between them, so a range's device time is read from the events it
# launched (:func:`range_busy_ms`)
RANGES = ("flash_attention_bwd_plain", "adamw_update")


def busy_ms(intervals) -> float:
    """Length of the union of ``[start, end)`` intervals (the device's busy
    time, in the intervals' unit): an instant covered by two events (a copy
    on a side stream under a kernel) counts once."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def device_intervals(prof) -> list[tuple[float, float]]:
    """The profiled device events' spans in ms (kernels, copies, memsets);
    the annotation ranges' device spans, which cover other events and the
    gaps between them, are left out."""
    from torch.autograd import DeviceType
    return [(e.time_range.start / 1e3, e.time_range.end / 1e3)
            for e in prof.events()
            if getattr(e, "device_type", DeviceType.CPU) != DeviceType.CPU
            and not getattr(e, "is_user_annotation", False)
            and e.key not in RANGES]


def range_events(prof) -> list:
    """A finished ``torch.profiler.profile``'s raw (Kineto) events, the
    input of :func:`range_busy_ms`: they carry the correlation ids that
    link a device event to the host op that launched it."""
    return list(prof.profiler.kineto_results.events())


def range_busy_ms(events, name: str) -> float:
    """Device busy time of the record_function range ``name``: the union
    (:func:`busy_ms`) of the spans of the device events that the host ops
    inside the range launched, matched by correlation id (a device event's
    ``linked_correlation_id()`` is the ``correlation_id()`` of the host op
    that launched it), over every call of the range. Not the range's own
    device span, which also covers other threads' and streams' kernels and
    the gaps between the range's kernels. ``events``: Kineto events
    (:func:`range_events`)."""
    from torch.autograd import DeviceType
    by_thread: dict = defaultdict(list)       # (start, end, id) a thread
    calls, device = [], []
    for e in events:
        span = (e.start_ns(), e.end_ns())
        if e.device_type() != DeviceType.CPU:
            if e.name() != name:              # not the range's own span
                device.append((span, e.linked_correlation_id()))
            continue
        by_thread[e.start_thread_id()].append(span + (e.correlation_id(),))
        if e.name() == name:
            calls.append((span, e.start_thread_id()))
    for ops in by_thread.values():
        ops.sort()
    launched: set = set()
    for (a, b), thread in calls:
        ops = by_thread[thread]
        i = bisect.bisect_left(ops, (a,))
        while i < len(ops) and ops[i][0] <= b:
            if ops[i][1] <= b:
                launched.add(ops[i][2])
            i += 1
    launched.discard(0)                   # device events linked to no op
    return busy_ms([(a / 1e6, b / 1e6) for (a, b), link in device
                    if link in launched])


# ------------------------------------------------------- the benchmark's own
def _merged(intervals):
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class TraceSlice:
    """``torch.profiler`` over one stretch of a run: ``start()`` and
    ``stop()`` bracket it (the device is synchronised at both ends, so the
    stretch's wall clock holds all of its device work). After ``stop()``:

    * ``window_s``: the stretch's host wall seconds; ``busy_s``: the union
      of its device events' spans;
    * ``kernel_s``: device seconds by event name;
    * ``idle_by_host``: idle device seconds by the innermost host
      annotation (``bench.*`` ranges the drivers open) at each gap.
    """

    def __init__(self) -> None:
        self._prof = None
        self.window_s = 0.0
        self.busy_s = 0.0
        self.kernel_s: dict[str, float] = {}
        self.idle_by_host: dict[str, float] = {}
        self.active = False

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            # the profiler's own buffers need room beside the cached blocks
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts, acc_events=True)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        self.active = True

    def stop(self) -> None:
        import torch
        from torch.autograd import DeviceType
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        self.active = False
        prof = self._prof
        events = prof.events()
        dev = device_intervals(prof)
        self.busy_s = busy_ms(dev) / 1e3
        by_name: dict[str, float] = defaultdict(float)
        for e in events:
            if getattr(e, "device_type", DeviceType.CPU) != DeviceType.CPU \
                    and not getattr(e, "is_user_annotation", False) \
                    and e.key not in RANGES:
                by_name[e.key] += (e.time_range.end
                                   - e.time_range.start) / 1e6
        self.kernel_s = dict(by_name)
        host = sorted(((e.time_range.start / 1e3, e.time_range.end / 1e3,
                        e.key) for e in events
                       if getattr(e, "device_type", DeviceType.CPU)
                       == DeviceType.CPU and e.key.startswith("bench.")),
                      key=lambda x: x[0])
        merged = _merged(dev)
        idle: dict[str, float] = defaultdict(float)
        open_: list[tuple[float, float, str]] = []    # host ranges begun
        j = 0
        for (_, a1), (b0, _) in zip(merged, merged[1:]):
            mid = (a1 + b0) / 2               # gaps come in time order
            while j < len(host) and host[j][0] <= mid:
                open_.append(host[j])
                j += 1
            open_ = [h for h in open_ if h[1] >= mid]
            label = (min(open_, key=lambda h: h[1] - h[0])[2] if open_
                     else "host outside the benchmark's calls")
            idle[label] += (b0 - a1) / 1e3
        self.idle_by_host = dict(idle)
        self._prof = None

    def top_kernels(self, n: int = 10) -> list[list]:
        return [[k, v] for k, v in sorted(self.kernel_s.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def top_idle(self, n: int = 10) -> list[list]:
        return [[k, v] for k, v in sorted(self.idle_by_host.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def kernel_seconds(self, needles) -> float:
        """Device seconds of the events whose names hold any of
        ``needles``."""
        return sum(v for k, v in self.kernel_s.items()
                   if any(s in k for s in needles))
