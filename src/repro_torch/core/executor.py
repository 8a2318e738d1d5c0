"""Workflow executor — really runs a TaskGraph, closing the paper's loop.

This is the runtime that puts the three layers together on actual hardware
(here: CPU threads standing in for nodes; on a GPU host: one executor per
host, ``device_of`` mapping each node to a ``torch.device`` of its cards):

  compiler (CompiledWorkflow)  ->  scheduler (policy)  ->  executor (this)
                                        |                        |
                                        v                        v
                    prefetch engine  <-  feedback  ->  LocStore placement

After every placement decision the executor *feeds back* to the storage layer
(the paper's missing challenge #3): task outputs are put AT the node that
produced them, and proactive pre-assignments trigger pipelining of inputs.

Task bodies are ``fn(**inputs) -> dict[output_name, value]``. Bodies run on a
thread pool with one logical slot per node; torch computations inside bodies
are free to use devices — the executor only manages placement + ordering. An
input that the prefetch engine staged to the node's device is handed to the
body as its device copy, after the body's thread's stream waits for that copy.

``device_of`` is how the caller puts the run on the card: it maps each node
to a ``torch.device``, and only with it does an ``"hbm"`` prefetch copy the
tensors of a value to that device. Without it (the default, as in the
reference) the executor never touches a card: an ``"hbm"`` prefetch stays a
host replica, and the bodies alone decide where they compute.
A body that raises — or an input whose stage or device copy failed — fails
the run: :meth:`WorkflowExecutor.run` re-raises the first error.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Mapping, Sequence

from repro_torch.core.dag import TaskGraph
from repro_torch.core.locstore import LocStore, Placement, StorageHierarchy
from repro_torch.core.prefetch import PrefetchEngine
from repro_torch.core.scheduler import (Assignment, ClusterView, ProactiveScheduler,
                                  SchedulerBase)
from repro_torch.core.wfcompiler import CompiledWorkflow, H100_SXM, HardwareModel

__all__ = ["ExecResult", "WorkflowExecutor"]


@dataclasses.dataclass
class ExecResult:
    wall_seconds: float
    io_wait_total: float
    bytes_moved: float
    bytes_local: float
    bytes_prefetched: float
    outputs: dict[str, Any]
    task_records: dict[str, dict]
    remote_bytes: float = 0.0
    bytes_demoted: float = 0.0
    demotions: int = 0
    promotions: int = 0
    writebacks: int = 0
    writeback_bytes: float = 0.0
    clean_drops: int = 0
    coord_drops: int = 0

    @property
    def locality_hit_rate(self) -> float:
        tot = self.bytes_local + self.bytes_moved
        return self.bytes_local / tot if tot else 1.0


class _ExecCluster(ClusterView):
    def __init__(self, ex: "WorkflowExecutor") -> None:
        self.ex = ex

    def free_workers(self) -> Sequence[int]:
        with self.ex._lock:
            return sorted(self.ex._free)

    def locate(self, data_name: str) -> Placement | None:
        return self.ex.store.loc.lookup(data_name)

    def is_durable(self, data_name: str) -> bool:
        return self.ex.store.durable(data_name)

    def link_gbps(self, src: int, dst: int) -> float:
        return self.ex.hw.link_gbps(src, dst)

    def tier_gbps(self, tier: str) -> float:
        return self.ex.store.hierarchy.bw(tier)

    def top_tier(self) -> str:
        return self.ex.store.hierarchy.top

    def bulk_tier(self) -> str:
        return self.ex.store.hierarchy.bottom

    def worker_speed(self, node: int) -> float:
        return 1.0

    def alive_nodes(self) -> Sequence[int]:
        # the executor has no failure model: every node is alive
        return range(self.ex.n_nodes)


class WorkflowExecutor:
    def __init__(
        self,
        wf: CompiledWorkflow,
        scheduler: SchedulerBase,
        *,
        n_nodes: int = 4,
        hw: HardwareModel = H100_SXM,
        store: LocStore | None = None,
        hierarchy: StorageHierarchy | None = None,
        device_of: Callable[[int], Any] | None = None,
        inject_inputs: Mapping[str, Any] | None = None,
        write_policy: str = "through",
        coordinated_eviction: bool = False,
        durability: str = "none",
    ) -> None:
        if store is not None and hierarchy is not None:
            raise ValueError("pass either store= or hierarchy=, not both — "
                             "an explicit store already owns its hierarchy")
        if store is not None and (write_policy != "through"
                                  or coordinated_eviction
                                  or durability != "none"):
            raise ValueError("write_policy/coordinated_eviction/durability "
                             "configure the executor-built store — an "
                             "explicit store already owns its policies")
        self.wf = wf
        self.sched = scheduler
        self.hw = hw
        self.n_nodes = n_nodes
        self.store = store or LocStore(n_nodes, hierarchy=hierarchy,
                                       write_policy=write_policy,
                                       coordinated_eviction=coordinated_eviction,
                                       durability=durability)
        self.prefetch = PrefetchEngine(self.store, device_of=device_of)
        # same event wiring the simulator uses: placement mirror + move-cost
        # term cache for decisions, and event-driven invalidation of the
        # proactive pre-assignments/prefetch markers (a replica evicted off
        # its prefetch target becomes re-prefetchable). Events fire on the
        # mutating worker thread; the mirror dicts are plain dicts (atomic
        # under the GIL), so decision reads are no racier than the direct
        # ``loc.lookup`` they replace.
        scheduler.attach_store(self.store, indexed=True)
        self.cluster = _ExecCluster(self)
        self._free: set[int] = set(range(n_nodes))
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._running_at: dict[str, int] = {}
        self._records: dict[str, dict] = {}
        self._io_wait = 0.0
        self._wb_stop = threading.Event()
        for name, value in (inject_inputs or {}).items():
            if not self.store.exists(name):
                self.store.put(name, value)

    def _wb_drainer(self) -> None:
        """Background flusher: drains the store's write-back queue while the
        workers compute — spill-to-PFS never blocks a task body."""
        while not self._wb_stop.wait(0.002):
            self.store.drain_writebacks()
        self.store.drain_writebacks()

    # ------------------------------------------------------------------ run
    def run(self) -> ExecResult:
        wf = self.wf
        g: TaskGraph = wf.graph
        unfinished = {tid: sum(1 for _ in g.predecessors(tid)) for tid in g.tasks}
        state = {tid: "pending" for tid in g.tasks}
        ready = {tid for tid, n in unfinished.items() if n == 0}
        for tid in ready:
            state[tid] = "ready"
        pool = ThreadPoolExecutor(max_workers=self.n_nodes,
                                  thread_name_prefix="xflow-worker")
        wb_thread = threading.Thread(target=self._wb_drainer, daemon=True,
                                     name="xflow-writeback")
        wb_thread.start()
        t0 = time.perf_counter()
        done_total = 0
        errors: list[BaseException] = []

        def body(a: Assignment) -> None:
            nonlocal done_total
            tid = a.tid
            t_assign = time.perf_counter()
            t_start = t_assign
            try:
                # the input fetch is inside the try: a failed stage or device
                # copy fails the task (an escaped error would leave the run
                # waiting forever for a task that never finishes)
                inputs: dict[str, Any] = {}
                for name in g.tasks[tid].inputs:
                    # prefer a device/prefetched replica; else located get
                    self.prefetch.wait(name, a.node, timeout=None) if \
                        (name, a.node) in self.prefetch._inflight else None
                    dev = self.prefetch.device_copy(name, a.node)
                    if dev is not None:
                        inputs[name] = dev
                        self.store.get(name, at=a.node)  # accounting: hit
                    else:
                        inputs[name], _ = self.store.get(name, at=a.node)
                t_start = time.perf_counter()
                fn = g.tasks[tid].fn
                out = fn(**inputs) if fn is not None else {}
                for oname in g.tasks[tid].outputs:
                    val = out.get(oname) if isinstance(out, Mapping) else None
                    pin = g.data[oname].pinned_loc
                    self.store.put(oname, val,
                                   loc=pin if pin is not None else a.node,
                                   xattr={"producer": tid})
                if self.store.durability == "fsync_on_barrier":
                    # task finish is the executor's sync point: everything
                    # still dirty (this task's outputs included) becomes
                    # durable before successors are released
                    self.store.barrier()
            except BaseException as e:  # noqa: BLE001 - propagated below
                errors.append(e)
            self.prefetch.release(tid)
            t_end = time.perf_counter()
            with self._cv:
                self._io_wait += t_start - t_assign
                self._records[tid] = {"node": a.node, "io_wait": t_start - t_assign,
                                      "run": t_end - t_start}
                self._running_at.pop(tid, None)
                self._free.add(a.node)
                state[tid] = "done"
                done_total += 1
                for s in g.successors(tid):
                    unfinished[s] -= 1
                    if unfinished[s] == 0 and state[s] == "pending":
                        state[s] = "ready"
                        ready.add(s)
                self._cv.notify_all()

        with self._cv:
            while done_total < len(g.tasks) and not errors:
                if ready and self._free:
                    assignments = self.sched.select(sorted(ready), self.cluster)
                    for a in assignments:
                        ready.discard(a.tid)
                        state[a.tid] = "running"
                        self._running_at[a.tid] = a.node
                        self._free.discard(a.node)
                        pool.submit(body, a)
                    if isinstance(self.sched, ProactiveScheduler):
                        cands = [tid for tid, st in state.items()
                                 if st == "pending" and any(
                                     self.store.exists(n)
                                     for n in g.tasks[tid].inputs)]
                        for req in self.sched.preplace(cands, self.cluster,
                                                       dict(self._running_at)):
                            # pinned do-not-evict until for_task finishes, so
                            # capacity pressure cannot undo the prefetch
                            self.prefetch.submit(req.data_name, req.dst,
                                                 tier=req.tier,
                                                 pin_for=req.for_task)
                    if assignments:
                        continue
                self._cv.wait(timeout=0.5)
        try:
            pool.shutdown(wait=True)
            self.prefetch.drain()
        finally:
            self._wb_stop.set()
            wb_thread.join(timeout=5.0)
        if errors:
            raise errors[0]
        wall = time.perf_counter() - t0
        rep = self.store.movement_report()
        sink_outputs = {}
        for tid in g.sinks():
            for oname in g.tasks[tid].outputs:
                sink_outputs[oname], _ = self.store.get(oname)
        return ExecResult(
            wall_seconds=wall,
            io_wait_total=self._io_wait,
            bytes_moved=rep["bytes_moved"],
            bytes_local=rep["bytes_local"],
            bytes_prefetched=self.prefetch.bytes_prefetched,
            outputs=sink_outputs,
            task_records=self._records,
            remote_bytes=rep["remote_bytes"],
            bytes_demoted=rep["bytes_demoted"],
            demotions=int(rep["demotions"]),
            promotions=int(rep["promotions"]),
            writebacks=int(rep["writebacks"]),
            writeback_bytes=rep["writeback_bytes"],
            clean_drops=int(rep["clean_drops"]),
            coord_drops=int(rep["coord_drops"]),
        )
