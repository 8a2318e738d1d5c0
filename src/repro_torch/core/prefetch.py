"""Asynchronous data-pipelining engine — the mechanism behind the paper's
"tell the file system to start pipelining the data to the target server".

Two modes, one interface:

* **host objects** (numpy arrays, bytes, pytrees): a background thread copies
  the object and registers the replica with the LocStore, so by the time the
  consumer task starts, ``store.get(name, at=node)`` is a local hit.
* **torch tensors**: every host tensor of the value goes through
  :func:`stage`, which :class:`~repro_torch.data.pipeline.PrefetchingLoader`
  uses for its batches too: copied into pinned memory, then to the device
  with ``non_blocking=True`` on a side stream of that device, with an event
  recorded after the copy. :meth:`PrefetchEngine.device_copy` hands the
  value out through :func:`take`, which makes the *calling* thread's
  current stream wait on that event and marks each tensor as used by that
  stream (``record_stream``), so the consumer never reads a copy before it
  lands and the caching allocator does not reuse its memory while the
  consumer reads it. The wait happens where the consumer takes the value,
  because the executor's task bodies run on other threads than the stage.
  Tensors already on the device pass through as they are; a tensor on
  another card is refused. A failed stage raises in ``wait()``/``drain()``:
  nothing is swallowed.

Every prefetch targets a storage **tier** on the destination node: ``"hbm"``
means device prefetch (the replica is promoted into device memory and, when a
``device_of`` map is present, its tensors are copied to that device; a value
that holds no tensor gets no device copy); lower tiers stage into
host DRAM or the burst buffer without occupying device memory. A flat store
clamps unknown tiers to its top tier, so the engine works unchanged against
the original two-tier model.

The engine is deliberately small: policy lives in the ProactiveScheduler; this
is only the data plane.
"""

from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Iterator

import torch

from repro_torch.core.locstore import LocStore

__all__ = ["PrefetchEngine", "stage", "take"]


def _tensors(value: Any) -> Iterator[torch.Tensor]:
    """Every tensor in ``value`` (through dicts, lists, tuples and
    dataclasses)."""
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            yield from _tensors(getattr(value, f.name))


def _has_tensor(value: Any) -> bool:
    return next(_tensors(value), None) is not None


def _map_tensors(value: Any, fn: Callable[[torch.Tensor], torch.Tensor]
                 ) -> Any:
    """``value`` with ``fn`` applied to every tensor in it (dicts, lists,
    tuples and dataclasses are rebuilt; anything else is kept as is)."""
    if isinstance(value, torch.Tensor):
        return fn(value)
    if isinstance(value, dict):
        return {k: _map_tensors(v, fn) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_map_tensors(v, fn) for v in value)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return dataclasses.replace(value, **{
            f.name: _map_tensors(getattr(value, f.name), fn)
            for f in dataclasses.fields(value) if f.init})
    return value


def stage(value: Any, dev: torch.device, side: Any) -> tuple[Any, Any]:
    """``value`` with its tensors copied to ``dev``, and the event recorded
    after the copies (None off CUDA, where ``.to`` is synchronous). On CUDA
    each host tensor is pinned and copied with ``non_blocking=True`` on the
    stream ``side`` of ``dev``; hand the result to a consumer through
    :func:`take`."""
    if dev.type != "cuda":
        return _map_tensors(value, lambda t: t.to(dev)), None
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    def copy(t: torch.Tensor) -> torch.Tensor:
        if t.device == dev:
            return t
        if t.device.type != "cpu":
            raise ValueError(f"cannot stage a tensor on {t.device} to {dev}:"
                             f" only host tensors are staged")
        t = t if t.is_pinned() else t.pin_memory()
        return t.to(dev, non_blocking=True)

    with torch.cuda.stream(side):
        out = _map_tensors(value, copy)
        done = torch.cuda.Event()
        done.record(side)
    return out, done


def take(value: Any, done: Any) -> Any:
    """``value`` as :func:`stage` left it, made safe to read on the calling
    thread's current stream: that stream waits on ``done``, and each CUDA
    tensor of ``value`` is marked as used by it."""
    if done is None:
        return value
    waited: dict[torch.device, Any] = {}
    for t in _tensors(value):
        if t.device.type != "cuda":
            continue
        stream = waited.get(t.device)
        if stream is None:
            stream = waited[t.device] = torch.cuda.current_stream(t.device)
            stream.wait_event(done)
        t.record_stream(stream)
    return value


class PrefetchEngine:
    def __init__(self, store: LocStore, *, max_workers: int = 4,
                 device_of: Callable[[int], Any] | None = None) -> None:
        """``device_of(node) -> torch.device`` enables device-level prefetch;
        without it the engine replicates at host level only."""
        self.store = store
        self.device_of = device_of
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="xflow-prefetch")
        self._inflight: dict[tuple[str, int], Future] = {}
        # (name, node) -> (device copy, event after its copy or None)
        self._device_copies: dict[tuple[str, int], tuple[Any, Any]] = {}
        self._side_streams: dict[torch.device, Any] = {}
        # consumer task -> replicas pinned do-not-evict on its behalf
        self._pins_for: dict[str, list[tuple[str, int]]] = {}
        self._lock = threading.Lock()
        self.submitted = 0
        self.completed = 0
        self.skipped_read_once = 0
        self.bytes_prefetched = 0.0
        self.device_hits = 0      # device copies handed to a consumer
        # failure hygiene: a dead node's in-flight handles, device copies and
        # pin records describe replicas that no longer exist — purge them on
        # the store's drop events so a later submit() re-stages instead of
        # returning a handle to vanished data, and release() does not unpin
        # replicas the store already forgot.
        store.loc.subscribe(self._on_store_event)

    def _on_store_event(self, event: str, key: Any, placement: Any) -> None:
        if event == "drop_node":
            with self._lock:
                for k in [k for k in self._inflight if k[1] == key]:
                    del self._inflight[k]
                for k in [k for k in self._device_copies if k[1] == key]:
                    del self._device_copies[k]
                for pins in self._pins_for.values():
                    pins[:] = [p for p in pins if p[1] != key]
        elif event == "drop":
            with self._lock:
                for k in [k for k in self._inflight if k[0] == key]:
                    del self._inflight[k]
                for k in [k for k in self._device_copies if k[0] == key]:
                    del self._device_copies[k]
                for pins in self._pins_for.values():
                    pins[:] = [p for p in pins if p[0] != key]

    # ------------------------------------------------------------------ api
    def submit(self, name: str, dst: int, *, tier: str = "hbm",
               pin_for: str | None = None) -> Future:
        """Start pipelining ``name`` to node ``dst``'s ``tier``.

        Idempotent per (name, dst) while a stage is in flight — but once the
        previous stage has landed, a request for a tier *faster* than where
        the replica sits NOW re-submits (a session cache parked back into
        the burst buffer must still be promotable to HBM by every later
        warm-up; the store may also have demoted or overwritten the replica
        since the last stage, so the decision reads live placement, not a
        recorded snapshot). ``pin_for`` names the consuming task: the
        replica is pinned do-not-evict in the store until :meth:`release` is
        called for that task, so capacity pressure cannot undo the prefetch
        before its consumer runs."""
        key = (name, dst)
        with self._lock:
            fut = self._inflight.get(key)
            if fut is not None and not self._should_restage(fut, name, dst,
                                                            tier):
                if pin_for is not None:
                    self._pin(name, dst, pin_for)
                return fut
            fut = self._pool.submit(self._stage, name, dst, tier)
            self._inflight[key] = fut
            self.submitted += 1
            if pin_for is not None:
                self._pin(name, dst, pin_for)
            return fut

    def _should_restage(self, fut: Future, name: str, dst: int,
                        tier: str) -> bool:
        """A completed stage is stale when the replica is gone from ``dst``
        or parked below the requested tier (read-once objects never
        re-stage — their mode exists to avoid exactly that)."""
        if not fut.done():
            return False
        mode_of = getattr(self.store, "write_mode", None)
        if mode_of is not None and mode_of(name) == "around":
            return False
        hier = self.store.hierarchy
        p = self.store.loc.lookup(name)
        if p is None:
            return False                       # object deleted: nothing to do
        if not p.resident_on(dst):
            return True                        # evicted off the node entirely
        return hier.rank(hier.normalize(tier)) < hier.rank(p.tier_on(dst))

    def _pin(self, name: str, dst: int, for_task: str) -> None:
        """Caller holds the lock. Pin once per (task, name, dst)."""
        if (name, dst) in self._pins_for.setdefault(for_task, []):
            return
        self.store.pin(name, dst)
        self._pins_for[for_task].append((name, dst))

    def release(self, for_task: str) -> int:
        """Unpin every replica pinned on behalf of ``for_task`` (the consumer
        finished — the prefetched copies are fair eviction game again).
        Returns how many pins were released."""
        with self._lock:
            pinned = self._pins_for.pop(for_task, [])
        for name, dst in pinned:
            self.store.unpin(name, dst)
        return len(pinned)

    def _stage(self, name: str, dst: int, tier: str) -> Any:
        value, tr = self.store.get(name)  # metadata read, no accounting
        mode_of = getattr(self.store, "write_mode", None)
        if mode_of is not None and mode_of(name) == "around":
            # write-around objects are read exactly once: caching a replica
            # ahead of time would waste the tier the mode exists to protect
            with self._lock:
                self.completed += 1
                self.skipped_read_once += 1
            return value
        if tier == "hbm" and self.device_of is not None \
                and _has_tensor(value):
            dev = self.device_of(dst)
            if dev is not None:
                dev = torch.device(dev)
                side = self.side_stream(dev) if dev.type == "cuda" else None
                value, done = stage(value, dev, side)
                with self._lock:
                    self._device_copies[(name, dst)] = (value, done)
        placement = self.store.replicate(name, [dst], tier=tier)
        with self._lock:
            self.completed += 1
            self.bytes_prefetched += float(placement.xattr.get("size", 0.0))
        return value

    def side_stream(self, dev: torch.device) -> Any:
        """This engine's side stream of the card ``dev`` (made on first
        use): every stage to ``dev`` is queued on it."""
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        with self._lock:
            side = self._side_streams.get(dev)
            if side is None:
                side = self._side_streams[dev] = torch.cuda.Stream(dev)
        return side

    def wait(self, name: str, dst: int, timeout: float | None = None) -> bool:
        """Block until a previously-submitted prefetch lands; False if none."""
        key = (name, dst)
        with self._lock:
            fut = self._inflight.get(key)
        if fut is None:
            return False
        fut.result(timeout=timeout)
        return True

    def device_copy(self, name: str, dst: int) -> Any | None:
        """The device-resident replica, if device-level prefetch ran. The
        calling thread's current stream waits for the staged copy, and each
        of its tensors is marked as used by that stream."""
        with self._lock:
            entry = self._device_copies.get((name, dst))
            if entry is not None:
                self.device_hits += 1
        if entry is None:
            return None
        return take(*entry)

    def drain(self) -> None:
        with self._lock:
            futs = list(self._inflight.values())
        for f in futs:
            f.result()

    def shutdown(self) -> None:
        self.drain()
        self._pool.shutdown(wait=True)

    # ------------------------------------------------------------ reporting
    def report(self) -> dict[str, float]:
        with self._lock:
            pins = sum(len(v) for v in self._pins_for.values())
        return {"submitted": float(self.submitted),
                "completed": float(self.completed),
                "skipped_read_once": float(self.skipped_read_once),
                "pins_held": float(pins),
                "device_hits": float(self.device_hits),
                "bytes_prefetched": self.bytes_prefetched}
