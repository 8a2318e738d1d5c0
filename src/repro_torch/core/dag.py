"""Task DAG — the structure the workflow compiler annotates and the scheduler walks.

Mirrors the Swift/T compiler output in the paper (Fig. 2): a directed acyclic
graph whose nodes are *tasks* and whose edges pass through named *datasets*
(task -> dataset -> task), because the paper's whole point is that datasets are
first-class: they have sizes, locations, and movement costs.

Pure Python; no torch. The graph is deliberately O(V+E) for every analysis pass
so it stays usable at 10^5-task scale (1000+-node clusters).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Iterable, Iterator, Mapping

from repro_torch.core.hints import TaskHints

__all__ = ["DataSpec", "TaskSpec", "TaskGraph", "CycleError"]


class CycleError(ValueError):
    """Raised when the workflow graph is not acyclic."""


@dataclasses.dataclass
class DataSpec:
    """A named dataset flowing through the workflow (the paper's "file").

    ``size_bytes`` is None until known — either from a ``@size`` hint (external
    inputs) or propagated by the workflow compiler via ``@input-output-ratio``.
    ``pinned_loc`` mirrors the paper's ``S_LOC`` explicit-placement request.
    """

    name: str
    size_bytes: float | None = None
    producer: str | None = None           # task id, None for external inputs
    consumers: list[str] = dataclasses.field(default_factory=list)
    pinned_loc: Any | None = None
    xattr: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def is_external(self) -> bool:
        return self.producer is None


@dataclasses.dataclass
class TaskSpec:
    """One workflow task.

    ``fn`` is the executable body (``fn(**inputs) -> dict[output_name, value]``)
    for real execution; the simulator and compiler only need the metadata.
    """

    tid: str
    inputs: tuple[str, ...]
    outputs: tuple[str, ...]
    hints: TaskHints = dataclasses.field(default_factory=TaskHints)
    fn: Callable[..., Mapping[str, Any]] | None = None
    # filled by the workflow compiler:
    est_flops: float | None = None
    est_seconds: float | None = None
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)


class TaskGraph:
    """Mutable task/dataset DAG with the analyses the paper's compiler needs.

    Construction::

        g = TaskGraph()
        g.add_data("raw", size_bytes=size_hint(1 << 30))     # @size
        g.add_task("split", inputs=("raw",), outputs=("a", "b"),
                   hints=task(io_ratio=0.5))
    """

    def __init__(self) -> None:
        self.tasks: dict[str, TaskSpec] = {}
        self.data: dict[str, DataSpec] = {}

    # ------------------------------------------------------------- building
    def add_data(
        self,
        name: str,
        *,
        size_bytes: float | None = None,
        pinned_loc: Any | None = None,
        **xattr: Any,
    ) -> DataSpec:
        if name in self.data:
            raise ValueError(f"dataset {name!r} already declared")
        d = DataSpec(name=name, size_bytes=size_bytes, pinned_loc=pinned_loc,
                     xattr=dict(xattr))
        self.data[name] = d
        return d

    def add_task(
        self,
        tid: str,
        *,
        inputs: Iterable[str] = (),
        outputs: Iterable[str] = (),
        hints: TaskHints | None = None,
        fn: Callable[..., Mapping[str, Any]] | None = None,
        **attrs: Any,
    ) -> TaskSpec:
        if tid in self.tasks:
            raise ValueError(f"task {tid!r} already declared")
        inputs = tuple(inputs)
        outputs = tuple(outputs)
        t = TaskSpec(tid=tid, inputs=inputs, outputs=outputs,
                     hints=hints or TaskHints(), fn=fn, attrs=dict(attrs))
        for name in inputs:
            if name not in self.data:
                self.add_data(name)
            self.data[name].consumers.append(tid)
        for name in outputs:
            if name not in self.data:
                self.add_data(name)
            d = self.data[name]
            if d.producer is not None:
                raise ValueError(
                    f"dataset {name!r} already produced by {d.producer!r}")
            d.producer = tid
        self.tasks[tid] = t
        return t

    # ------------------------------------------------------------ structure
    def predecessors(self, tid: str) -> Iterator[str]:
        """Tasks whose outputs this task consumes."""
        seen: set[str] = set()
        for name in self.tasks[tid].inputs:
            p = self.data[name].producer
            if p is not None and p not in seen:
                seen.add(p)
                yield p

    def successors(self, tid: str) -> Iterator[str]:
        """Tasks consuming this task's outputs."""
        seen: set[str] = set()
        for name in self.tasks[tid].outputs:
            for c in self.data[name].consumers:
                if c not in seen:
                    seen.add(c)
                    yield c

    def external_inputs(self) -> list[DataSpec]:
        return [d for d in self.data.values() if d.is_external]

    def sinks(self) -> list[str]:
        return [tid for tid in self.tasks
                if not any(True for _ in self.successors(tid))]

    def sources(self) -> list[str]:
        return [tid for tid in self.tasks
                if not any(True for _ in self.predecessors(tid))]

    # ------------------------------------------------------------- analyses
    def topo_order(self) -> list[str]:
        """Kahn topological order; raises :class:`CycleError` on cycles."""
        indeg = {tid: sum(1 for _ in self.predecessors(tid)) for tid in self.tasks}
        q = deque(sorted(tid for tid, d in indeg.items() if d == 0))
        order: list[str] = []
        while q:
            tid = q.popleft()
            order.append(tid)
            for s in self.successors(tid):
                indeg[s] -= 1
                if indeg[s] == 0:
                    q.append(s)
        if len(order) != len(self.tasks):
            raise CycleError("workflow graph contains a cycle")
        return order

    def upward_rank(self, cost: Callable[[str], float] | None = None) -> dict[str, float]:
        """Length of the longest path from each task to a sink (inclusive).

        The paper: "it first calculates the length of the longest path from the
        final task to current task. Longer distance usually indicates a higher
        priority". ``cost(tid)`` weights each node (default: est_seconds if the
        compiler filled it, else 1.0 == pure hop count).
        """
        if cost is None:
            def cost(tid: str) -> float:  # noqa: ANN001
                est = self.tasks[tid].est_seconds
                return est if est is not None else 1.0
        rank: dict[str, float] = {}
        for tid in reversed(self.topo_order()):
            succ = [rank[s] for s in self.successors(tid)]
            rank[tid] = cost(tid) + (max(succ) if succ else 0.0)
        return rank

    def earliest_start(self, cost: Callable[[str], float] | None = None) -> dict[str, float]:
        """Earliest start time per task with unlimited workers (compiler pass)."""
        if cost is None:
            def cost(tid: str) -> float:  # noqa: ANN001
                est = self.tasks[tid].est_seconds
                return est if est is not None else 1.0
        est: dict[str, float] = {}
        for tid in self.topo_order():
            preds = [est[p] + cost(p) for p in self.predecessors(tid)]
            est[tid] = max(preds) if preds else 0.0
        return est

    def critical_path(self) -> tuple[list[str], float]:
        """(task chain, total weight) of the longest path through the DAG."""
        rank = self.upward_rank()
        if not rank:
            return [], 0.0
        cur = max(rank, key=lambda t: rank[t])
        total = rank[cur]
        path = [cur]
        while True:
            succ = list(self.successors(cur))
            if not succ:
                break
            cur = max(succ, key=lambda t: rank[t])
            path.append(cur)
        return path, total

    # ------------------------------------------------------------ utilities
    def validate(self, *, strict: bool = False) -> None:
        """Raise on cycles; with ``strict=True``, also raise on consumed
        external inputs that carry no ``@size`` hint (the compiler would
        silently guess a 1 MiB default, which poisons every size-derived
        estimate downstream)."""
        self.topo_order()  # raises on cycles
        for d in self.data.values():
            if d.is_external and d.size_bytes is None and d.consumers:
                if strict:
                    raise ValueError(
                        f"external input {d.name!r} is consumed by "
                        f"{sorted(set(d.consumers))} but has no size_bytes "
                        f"hint (strict validation; add @size or pass "
                        f"strict=False to accept the compiler's default)")

    def mark_sink(self, *names: str) -> None:
        """Declare datasets as intended workflow outputs. The dead-dataset
        lint flags produced-but-never-consumed datasets unless they carry
        this mark."""
        for name in names:
            if name not in self.data:
                raise KeyError(f"dataset {name!r} not declared")
            self.data[name].xattr["sink"] = True

    def __len__(self) -> int:
        return len(self.tasks)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"TaskGraph(tasks={len(self.tasks)}, data={len(self.data)}, "
                f"sinks={len(self.sinks())})")
