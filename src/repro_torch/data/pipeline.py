"""Deterministic corpus and a prefetching loader (the port of
``repro.data.pipeline``).

* :class:`SyntheticCorpus` — copied from the reference: seeded token shards
  (shard i is always the same tokens), so a restart at step k replays the
  exact batches, and the two packages yield the same tokens bit for bit.

* :class:`PrefetchingLoader` — a background thread materialises batches
  k+1..k+depth while step k computes. On a CUDA device each batch is copied
  from pinned host memory with ``non_blocking=True`` on a side stream, and an
  event records the copy; the consumer's stream waits on that event when it
  takes the batch, and each tensor is marked as used by that stream
  (``record_stream``), so a step never reads a batch before it lands and the
  caching allocator does not hand its memory to the side stream while the
  step still reads it. The staging is the prefetch engine's
  (:func:`~repro_torch.core.prefetch.stage` and
  :func:`~repro_torch.core.prefetch.take`).

* :func:`epoch_workflow` — a training epoch as a hinted
  :class:`~repro_torch.core.dag.TaskGraph` (per-step load tasks feeding the
  step), copied from the reference, for the workflow executor and the
  simulator.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.dag import TaskGraph
from repro_torch.core.hints import Complexity, size_hint, task
from repro_torch.core.prefetch import stage, take


class SyntheticCorpus:
    """Deterministic sharded token stream."""

    def __init__(self, vocab: int, shard_tokens: int = 1 << 16,
                 seed: int = 0) -> None:
        self.vocab = vocab
        self.shard_tokens = shard_tokens
        self.seed = seed

    def shard(self, i: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, i))
        # zipf-ish marginal so the loss curve is non-trivial
        z = rng.zipf(1.3, self.shard_tokens).astype(np.int64)
        return (z % self.vocab).astype(np.int32)

    def batches(self, batch: int, seq: int, start_step: int = 0
                ) -> Iterator[dict[str, np.ndarray]]:
        need = batch * (seq + 1)
        per_shard = self.shard_tokens // need
        step = start_step
        while True:
            sid, off = divmod(step, max(per_shard, 1))
            data = self.shard(sid)[off * need:(off + 1) * need]
            if len(data) < need:
                step += 1
                continue
            x = data.reshape(batch, seq + 1)
            yield {"tokens": x[:, :-1], "labels": x[:, 1:]}
            step += 1


def _placer(device: torch.device) -> Callable[[dict], Any]:
    """numpy batch -> (tensors on ``device``, the copy's event or None)."""
    side = torch.cuda.Stream(device) if device.type == "cuda" else None
    return lambda b: stage({k: torch.from_numpy(np.ascontiguousarray(v))
                            for k, v in b.items()}, device, side)


class PrefetchingLoader:
    """Depth-N background loader placing each numpy batch on ``device``
    (default ``cuda``; ``"cpu"`` for the CPU)."""

    def __init__(self, it: Iterator[dict[str, np.ndarray]], *,
                 depth: int = 2,
                 device: str | torch.device | None = None) -> None:
        self.it = it
        self._place = _placer(resolve_device(device))
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.waits = 0            # times the consumer found the queue empty
        self.loads = 0
        self._thread = threading.Thread(target=self._work, daemon=True,
                                        name="xflow-data-prefetch")
        self._thread.start()

    def _work(self) -> None:
        try:
            for batch in self.it:
                if self._stop.is_set():
                    return
                self.q.put(self._place(batch))
                self.loads += 1
        finally:
            self.q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        if self.q.empty():
            self.waits += 1
        item = self.q.get()
        if item is None:
            raise StopIteration
        return take(*item)

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass


def epoch_workflow(cfg: ModelConfig, *, n_steps: int, n_dp: int,
                   batch: int, seq: int, step_flops: float) -> TaskGraph:
    """A training epoch as a hinted TaskGraph (consumed by core/scheduler)."""
    g = TaskGraph()
    batch_bytes = batch // n_dp * (seq + 1) * 4
    g.add_data("corpus", size_bytes=size_hint(n_steps * n_dp * batch_bytes))
    g.add_data("params0", size_bytes=size_hint(2e9))
    prev = "params0"
    for s in range(n_steps):
        parts = []
        for d in range(n_dp):
            b = f"batch_{s}_{d}"
            g.add_task(f"load_{s}_{d}", inputs=("corpus",), outputs=(b,),
                       hints=task(compute="const",
                                  io_ratio=1.0 / (n_steps * n_dp)))
            parts.append(b)
        out = f"params{s + 1}"
        g.add_task(f"step_{s}", inputs=(prev, *parts), outputs=(out,),
                   hints=task(procs=n_dp, io_ratio=1.0,
                              compute=Complexity("const",
                                                 flops_per_byte=step_flops)))
        prev = out
    return g
