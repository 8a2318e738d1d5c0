"""Location-aware store — the paper's file-system layer (§B, first component).

Reproduces, on top of PyTorch/host memory instead of Memcached, the three file
system extensions the paper proposes for Hercules:

1. **Placement control at create** — ``LocStore.put(name, value, loc=...)`` is
   ``OPEN(..., O_CREAT | S_LOC)``: the caller pins where the object lives. With
   no ``loc``, the store falls back to its default policy (consistent hash over
   nodes — what Hercules/Memcached would do).
2. **Location in extended attributes** — every object carries a
   :class:`Placement` with an ``xattr`` dict; ``stat``/``getxattr`` expose it.
3. **Distributed location service** — :class:`LocationService` shards the
   name -> real-loc mapping by consistent hash into ``n_shards`` independent
   metadata shards (one per metadata server in a real deployment), so lookups
   scale with the cluster instead of bottlenecking on one server. The runtime
   may re-pin ("real-loc") any object at any time via ``migrate`` — this is the
   channel the scheduler uses for its feedback (paper challenge #3).

Beyond the flat "compute node vs Lustre" split, each node exposes an ordered
**storage hierarchy** (:class:`StorageHierarchy`): device HBM over host DRAM
over burst buffer, with the shared parallel-FS ``remote`` tier at the bottom.
Every node-local tier has a per-node capacity and a sustained bandwidth; when
a tier fills, the store *demotes* the eviction victim one tier down (never
dropping data — the bottom of the cascade is the infinite remote tier), and
``get(name, at=node)`` *promotes* what it touches back to the top tier. The
default hierarchy is :data:`FLAT_HIERARCHY` (one infinite host tier), which
reproduces the paper's original two-tier behaviour exactly; pass
``tiered_hierarchy()`` to turn capacity pressure on.

**Write policies.** Demotion off the bottom node tier — the spill to the
parallel FS — supports three modes (``write_policy=`` / ``put(..., mode=)``):

* ``"through"`` (default, the original behaviour): the spill is a synchronous
  PFS write on the eviction path — the simulator charges it to the demand NIC
  lane, so it contends with the fetches tasks are waiting on.
* ``"back"``: per-replica **dirty bits** track whether the PFS already holds
  the current version. A *clean* victim is simply dropped (the durable copy
  exists — zero traffic); a *dirty* victim is enqueued on the
  :class:`WriteBackQueue` and flushed asynchronously (simulator: background
  NIC lane; executor: drainer thread) so the spill overlaps compute.
* ``"around"``: run-once streaming outputs are written straight to the PFS,
  never occupying node tiers, and reads are **read-once** — no replica is
  cached and ``replicate`` is a no-op for them.

**Coordinated eviction** (``coordinated_eviction=True``): ``_victim`` consults
the :class:`LocationService` so replicated objects are evicted before sole
copies, and a replica that is duplicated anywhere else in the cluster is
*dropped* (free) instead of demoted — node A never writes the last fast-tier
copy to the PFS while node B holds a cold duplicate. Sole copies are always
demoted down-tier, never dropped.

**Do-not-evict pins** (``pin``/``unpin``): the scheduler marks a prefetched
replica do-not-evict for its consumer's lifetime, so coordinated eviction at
comfortable capacity cannot undo prefetch work by dropping the duplicate it
just paid to create. Pins are per (name, node) and counted (two consumers may
pin the same replica); a fully-pinned tier stops evicting and runs overfull
rather than dropping pinned data.

**Durability windows** (``durability=``): compute-on-data-path keeps fresh
output on the node that produced it, which means a node failure can take the
*only* copy of a dataset down with it. The store models where in that window
each object sits — ``durable(name)`` is True exactly when the PFS holds the
current version — and offers three policies for closing it:

* ``"none"`` (default): dirty data reaches the PFS only when capacity
  pressure evicts it (and, under write-back, the queue drains). The window is
  unbounded: a failure re-runs the producer.
* ``"flush_before_ack"``: ``put`` is not acknowledged until the PFS write
  completes (``kind="fsync"`` transfer on the producer's demand NIC lane).
  Window = zero; cost = every byte eagerly crosses the network.
* ``"fsync_on_barrier"``: the runtime calls :meth:`barrier` at workflow sync
  points (task finishes, every ``barrier_every`` in the simulator); the
  barrier fsyncs everything still dirty. Window = one barrier interval.

**Failure handling** (``drop_node``): one atomic operation forgets every
replica on the dead node, *cancels pending write-back flushes sourced on it*
(the flush will never happen — without the cancel a later drain would mark
the lost object durable on the strength of a phantom PFS copy), revokes the
logical remote residency those flushes pre-recorded, and clears the node's
pin refcounts. Objects whose last copy died are deleted so ``exists()``
turns False and the caller can re-run the producer.

**Elastic membership** (``join_node``/``revive_node``): the arrival half of
the lifecycle, modeled on the saxml join protocol (the node announces
itself; the admin side updates membership). ``join_node`` clears the node
from the failed set (or grows ``n_nodes`` for a brand-new id), reopens
default placement to it, and publishes a ``("join_node", node, None)``
event so event-driven subscribers (indexed schedulers, the simulator's
candidate index, cached cluster views) absorb the newcomer without a
rescan. ``rereplication_candidates``/``rereplicate_to`` then close the
at-risk window the write side of ``risk_aware`` worries about: objects
whose ONLY node-local copy sits on one surviving node — dirty (no durable
PFS version: losing that node loses the data) first — are copied toward
the newcomer.

Values can be anything sized: torch tensors (``.nbytes``), numpy arrays, bytes, or
:class:`SimObject` stand-ins for the simulator. ``get(name, at=node)`` returns
the value AND a :class:`Transfer` record of the bytes that had to move — with
per-tier-hop accounting (:class:`TierHop`) — the numbers every benchmark in
this repo is built on.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import hashlib
import threading
import time
from typing import Any, Iterable, Mapping, Sequence

__all__ = ["Placement", "SimObject", "Transfer", "TierHop", "TierSpec",
           "StorageHierarchy", "FLAT_HIERARCHY", "tiered_hierarchy",
           "LocationService", "LocStore", "REMOTE_TIER",
           "WriteBackEntry", "WriteBackQueue", "WRITE_POLICIES",
           "DURABILITY_POLICIES", "DropReport", "JoinReport"]

WRITE_POLICIES = ("through", "back", "around")
DURABILITY_POLICIES = ("none", "flush_before_ack", "fsync_on_barrier")

REMOTE_TIER = -1  # node id of the remote parallel-FS tier (Lustre analogue)

GiB = float(1 << 30)


def _stable_hash(name: str) -> int:
    return int.from_bytes(hashlib.blake2b(name.encode(), digest_size=8).digest(),
                          "big")


# --------------------------------------------------------------------- tiers
@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One level of the per-node storage hierarchy.

    ``capacity_bytes`` is PER NODE (``inf`` = unbounded); ``gbps`` is the
    sustained read/write bandwidth of the medium in bytes/s (``inf`` = free,
    which is how the flat hierarchy keeps the original two-tier cost model).
    """

    name: str
    capacity_bytes: float = float("inf")
    gbps: float = float("inf")


class StorageHierarchy:
    """Ordered node-local tiers (fastest first) + the shared remote PFS tier.

    The hierarchy answers three questions for the store: where does a fresh
    object land (``top``), where does an eviction victim go (``next_down`` —
    ``None`` past the last node tier, meaning "spill to remote"), and how fast
    is a tier's medium (``bw``).
    """

    def __init__(self, tiers: Sequence[TierSpec],
                 remote: TierSpec | None = None) -> None:
        if not tiers:
            raise ValueError("need at least one node-local tier")
        self.tiers = tuple(tiers)
        self.remote = remote or TierSpec("remote")
        names = [t.name for t in self.tiers] + [self.remote.name]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names: {names}")
        self._spec = {t.name: t for t in self.tiers}
        self._spec[self.remote.name] = self.remote
        self._order = {t.name: i for i, t in enumerate(self.tiers)}
        self._rank = dict(self._order)
        self._rank[self.remote.name] = len(self.tiers)

    @property
    def top(self) -> str:
        return self.tiers[0].name

    @property
    def bottom(self) -> str:
        """The slowest (largest) node-local tier — bulk staging target."""
        return self.tiers[-1].name

    def names(self) -> tuple[str, ...]:
        return tuple(t.name for t in self.tiers) + (self.remote.name,)

    def is_node_tier(self, tier: str) -> bool:
        return tier in self._order

    def normalize(self, tier: str | None) -> str:
        """Map legacy/foreign tier names onto this hierarchy's node tiers."""
        if tier is None or tier == "node" or tier == self.remote.name:
            return self.top
        if tier in self._order:
            return tier
        # e.g. a scheduler asking for "hbm" against the flat hierarchy
        return self.top

    def spec(self, tier: str) -> TierSpec:
        return self._spec[tier]

    def capacity(self, tier: str) -> float:
        return self._spec[tier].capacity_bytes

    def bw(self, tier: str) -> float:
        spec = self._spec.get(tier)
        return spec.gbps if spec is not None else float("inf")

    def rank(self, tier: str) -> int:
        """Position in the hierarchy (0 = fastest; unknown sorts below all)."""
        return self._rank.get(tier, len(self._rank))

    def next_down(self, tier: str) -> str | None:
        """The demotion target below ``tier`` (None = spill to remote)."""
        i = self._order[tier]
        if i + 1 < len(self.tiers):
            return self.tiers[i + 1].name
        return None

    def media_seconds(self, nbytes: float, tier: str) -> float:
        bw = self.bw(tier)
        return 0.0 if bw == float("inf") else nbytes / bw


#: The original two-tier model: one unbounded, free host tier per node plus
#: the remote PFS. All existing cost accounting reduces to link bandwidths.
FLAT_HIERARCHY = StorageHierarchy([TierSpec("host")])


def tiered_hierarchy(*, hbm_bytes: float = 80e9,
                     host_bytes: float = 64 * GiB,
                     bb_bytes: float = 256 * GiB,
                     hbm_gbps: float = 3.35e12, host_gbps: float = 100e9,
                     bb_gbps: float = 8e9, remote_gbps: float = 2e9,
                     ) -> StorageHierarchy:
    """Device-HBM / host-DRAM / burst-buffer / PFS — the HPC storage gradient.

    The ``hbm`` defaults are one NVIDIA H100 SXM's device memory: 80 GB at
    3.35 TB/s (NVIDIA's H100 data sheet). The lower tiers are the same
    modeled cluster media as the JAX package's."""
    return StorageHierarchy(
        [TierSpec("hbm", hbm_bytes, hbm_gbps),
         TierSpec("host", host_bytes, host_gbps),
         TierSpec("bb", bb_bytes, bb_gbps)],
        remote=TierSpec("remote", float("inf"), remote_gbps))


@dataclasses.dataclass
class Placement:
    """Where an object lives: one or more node ids (+ the remote tier).

    ``nodes`` is a tuple because the store supports replication; the paper's
    ``real-loc`` is ``nodes[0]``. ``xattr`` is the extended-attribute dict the
    paper stores location metadata in. ``tiers``, when set by a tiered store,
    is aligned with ``nodes`` and names the storage tier of each replica;
    ``tier`` alone describes the primary replica (kept for the two-tier API).
    """

    nodes: tuple[int, ...]
    tier: str = "host"                      # tier of nodes[0]
    xattr: dict[str, Any] = dataclasses.field(default_factory=dict)
    tiers: tuple[str, ...] | None = None    # per-replica tiers (tiered store)

    @property
    def real_loc(self) -> int:
        return self.nodes[0]

    def resident_on(self, node: int) -> bool:
        return node in self.nodes

    def tier_on(self, node: int) -> str:
        """Tier of the replica on ``node`` (falls back to ``tier``/remote)."""
        if self.tiers is not None:
            for n, t in zip(self.nodes, self.tiers):
                if n == node:
                    return t
        if node == REMOTE_TIER:
            return "remote"
        return self.tier


@dataclasses.dataclass(frozen=True)
class SimObject:
    """A sized placeholder used by the simulator (no actual payload)."""

    nbytes: float


@dataclasses.dataclass(frozen=True)
class TierHop:
    """One hop of a movement through the storage hierarchy."""

    src_node: int
    src_tier: str
    dst_node: int
    dst_tier: str
    nbytes: float
    est_seconds: float


@dataclasses.dataclass(frozen=True)
class Transfer:
    """One data movement the store performed (fetch, demotion, promotion).

    ``hops`` itemizes the path through the hierarchy; ``est_seconds`` is the
    storage-layer media time (tier read + write) — the network link time on
    top of it is the hardware model's business (simulator/compiler add it).
    """

    name: str
    nbytes: float
    src: int
    dst: int
    src_tier: str = "host"
    dst_tier: str = "host"
    est_seconds: float = 0.0
    # fetch | demote | promote | migrate (runtime re-pin) |
    # spill (put overflow straight to the PFS) |
    # writeback (async dirty flush) | writearound (streaming PFS write) |
    # fsync (durability-policy flush: synchronous, ack- or barrier-blocking)
    kind: str = "fetch"
    hops: tuple[TierHop, ...] = ()

    @property
    def local(self) -> bool:
        return self.src == self.dst

    @property
    def remote(self) -> bool:
        return self.src == REMOTE_TIER or self.dst == REMOTE_TIER


def sizeof(value: Any) -> float:
    nb = getattr(value, "nbytes", None)
    if nb is not None:
        return float(nb)
    if isinstance(value, (bytes, bytearray, memoryview)):
        return float(len(value))
    return float(64)  # opaque python object — metadata-sized


# ---------------------------------------------------------------- write-back
@dataclasses.dataclass(frozen=True)
class WriteBackEntry:
    """One dirty replica spilled off the node tiers, awaiting its PFS flush."""

    name: str
    node: int                 # node the replica was evicted from
    src_tier: str             # tier it was evicted out of
    nbytes: float
    est_seconds: float        # media time of the flush (tier read + PFS write)
    seq: int                  # enqueue order (drain is FIFO)


class WriteBackQueue:
    """FIFO of pending asynchronous PFS writes.

    The store *enqueues* when a dirty victim falls off the bottom node tier;
    the runtime *drains* off the critical path (simulator: background NIC
    lane, executor: drainer thread). Draining an entry is what makes the PFS
    copy durable — :meth:`LocStore.drain_writebacks` clears the dirty bits.
    Entries for overwritten/deleted objects are cancelled, not flushed.
    """

    def __init__(self) -> None:
        self._q: collections.deque[WriteBackEntry] = collections.deque()
        self._lock = threading.Lock()
        self._seq = 0
        # cancelled entries stay queued as tombstones so every queue slot is
        # consumed by exactly one pop — the simulator pairs one flush-done
        # event with one slot, and removal would shift later flushes onto
        # earlier events' completion times
        self._cancelled: set[int] = set()
        self.enqueued = 0
        self.drained = 0
        self.cancelled = 0
        self.bytes_enqueued = 0.0
        self.bytes_drained = 0.0

    def push(self, name: str, node: int, src_tier: str, nbytes: float,
             est_seconds: float) -> WriteBackEntry:
        with self._lock:
            entry = WriteBackEntry(name, node, src_tier, nbytes, est_seconds,
                                   self._seq)
            self._seq += 1
            self._q.append(entry)
            self.enqueued += 1
            self.bytes_enqueued += nbytes
            return entry

    def pop(self) -> tuple[WriteBackEntry, bool] | None:
        """Consume one queue slot: (entry, live). ``live=False`` means the
        entry was cancelled — the caller must not flush it, but the slot
        still pairs with its scheduled completion."""
        with self._lock:
            if not self._q:
                return None
            entry = self._q.popleft()
            if entry.seq in self._cancelled:
                self._cancelled.discard(entry.seq)
                return entry, False
            self.drained += 1
            self.bytes_drained += entry.nbytes
            return entry, True

    def cancel(self, name: str) -> int:
        """Tombstone pending flushes of ``name`` (its version is gone).
        Returns how many entries were cancelled."""
        with self._lock:
            n = 0
            for e in self._q:
                if e.name == name and e.seq not in self._cancelled:
                    self._cancelled.add(e.seq)
                    n += 1
            self.cancelled += n
            return n

    def cancel_node(self, node: int) -> list[WriteBackEntry]:
        """Tombstone every pending flush *sourced* on ``node`` (the node
        died: the bytes will never cross the network). Returns the cancelled
        entries so the caller can revoke the logical PFS residency each one
        pre-recorded."""
        with self._lock:
            out: list[WriteBackEntry] = []
            for e in self._q:
                if e.node == node and e.seq not in self._cancelled:
                    self._cancelled.add(e.seq)
                    out.append(e)
            self.cancelled += len(out)
            return out

    def pending_for(self, name: str) -> list[WriteBackEntry]:
        with self._lock:
            return [e for e in self._live() if e.name == name]

    def _live(self) -> list[WriteBackEntry]:
        return [e for e in self._q if e.seq not in self._cancelled]

    def has(self, name: str) -> bool:
        with self._lock:
            return any(e.name == name for e in self._live())

    def pending_bytes(self) -> float:
        with self._lock:
            return sum(e.nbytes for e in self._live())

    def __len__(self) -> int:
        with self._lock:
            return len(self._live())

    def report(self) -> Mapping[str, float]:
        with self._lock:
            return {"enqueued": float(self.enqueued),
                    "drained": float(self.drained),
                    "cancelled": float(self.cancelled),
                    "pending": float(len(self._live())),
                    "bytes_enqueued": self.bytes_enqueued,
                    "bytes_drained": self.bytes_drained}


@dataclasses.dataclass(frozen=True)
class DropReport:
    """What :meth:`LocStore.drop_node` did when a node failed.

    ``lost`` names lost their last copy (the caller must re-run producers);
    ``dirty_lost`` is the subset that was dirty — the rerun cost a tighter
    durability window would have avoided. ``survived`` kept a replica
    elsewhere (another node or a *real* — drained — PFS copy).
    ``cancelled_flushes`` counts pending write-backs sourced on the dead node
    that were tombstoned, and ``phantom_remote_revoked`` the logical PFS
    residencies those flushes had pre-recorded but never delivered."""

    node: int
    lost: tuple[str, ...]
    survived: tuple[str, ...]
    dirty_lost: tuple[str, ...]
    cancelled_flushes: int
    phantom_remote_revoked: int
    released_pins: int


@dataclasses.dataclass(frozen=True)
class JoinReport:
    """What :meth:`LocStore.join_node` did when a node (re)joined.

    ``rejoined`` means the id was in the failed set (a revival — its tiers
    start empty, its pin refcounts were already released by ``drop_node``);
    ``grew`` means the id was beyond ``n_nodes`` and the cluster was
    extended to absorb it (scale-out)."""

    node: int
    rejoined: bool
    grew: bool


class LocationService:
    """Distributed location-metadata service (consistent-hash sharded).

    Each shard is an independent dict + lock — the in-process model of one
    metadata server. ``shard_of`` is deterministic so any client can route a
    lookup without coordination. Counters let the benchmarks report per-shard
    load balance (the scalability argument for "distributed" in the paper).

    **Change events.** ``subscribe(fn)`` registers a listener called as
    ``fn(event, key, placement)`` on every metadata change:

    * ``("record", name, placement)`` — ``name`` now resolves to ``placement``
      (creation, replication, demotion, promotion, migration, drain, ...);
    * ``("drop", name, None)`` — ``name`` no longer exists;
    * ``("drop_node", node, None)`` — a whole node failed (relayed by
      :meth:`LocStore.drop_node` after the per-name events).

    This is the scheduler's cache-invalidation channel: an indexed scheduler
    mirrors the name -> Placement map from these events instead of paying a
    hash + shard lock per ``lookup``. Listeners run on the mutating thread
    and may hold the store lock — they must only touch their own state and
    never call back into the store.
    """

    def __init__(self, n_shards: int = 16) -> None:
        if n_shards < 1:
            raise ValueError("need at least one metadata shard")
        self.n_shards = n_shards
        self._shards: list[dict[str, Placement]] = [{} for _ in range(n_shards)]
        self._locks = [threading.Lock() for _ in range(n_shards)]
        self._listeners: list[Any] = []
        self.lookups = [0] * n_shards
        self.records = [0] * n_shards

    def subscribe(self, fn: Any) -> None:
        """Register ``fn(event, key, placement)`` for metadata-change events."""
        self._listeners.append(fn)

    def unsubscribe(self, fn: Any) -> None:
        try:
            self._listeners.remove(fn)
        except ValueError:
            pass

    def notify(self, event: str, key: Any, placement: "Placement | None") -> None:
        for fn in self._listeners:
            fn(event, key, placement)

    def shard_of(self, name: str) -> int:
        return _stable_hash(name) % self.n_shards

    def record(self, name: str, placement: Placement) -> None:
        s = self.shard_of(name)
        with self._locks[s]:
            self._shards[s][name] = placement
            self.records[s] += 1
        self.notify("record", name, placement)

    def lookup(self, name: str) -> Placement | None:
        s = self.shard_of(name)
        with self._locks[s]:
            self.lookups[s] += 1
            return self._shards[s].get(name)

    def drop(self, name: str) -> None:
        s = self.shard_of(name)
        with self._locks[s]:
            self._shards[s].pop(name, None)
        self.notify("drop", name, None)

    def names(self) -> list[str]:
        out: list[str] = []
        for s, lock in zip(self._shards, self._locks):
            with lock:
                out.extend(s.keys())
        return out

    def load_balance(self) -> Mapping[str, Any]:
        sizes = [len(s) for s in self._shards]
        return {"shards": self.n_shards, "entries": sum(sizes),
                "max_shard": max(sizes, default=0),
                "min_shard": min(sizes, default=0),
                "lookups": sum(self.lookups)}


class LocStore:
    """The location-aware compute-node-side store.

    ``nodes`` are integer ids 0..N-1 (plus :data:`REMOTE_TIER`). Thread-safe:
    the executor's worker threads and the prefetch engine hit it concurrently.

    With a capacity-bounded ``hierarchy``, each replica lives in one tier of
    its node; admitting past a tier's capacity demotes the eviction victim
    (``eviction_policy``: "lru", or "cost" = largest-coldest-first) down-tier,
    spilling to the remote PFS only below the last node tier. Reads promote
    the touched object back to the top tier (``promote_on_access``).

    ``write_policy`` sets how that spill happens ("through" = synchronous,
    "back" = dirty-tracked async write-back via :attr:`writeback`); a per-put
    ``mode=`` overrides it ("around" = stream straight to the PFS, read-once).
    ``coordinated_eviction`` makes ``_victim`` consult the LocationService:
    replicas duplicated elsewhere in the cluster are evicted (dropped, free)
    before sole copies, which are demoted down-tier and never dropped.
    """

    def __init__(self, n_nodes: int, *, n_meta_shards: int = 16,
                 default_policy: str = "hash",
                 hierarchy: StorageHierarchy | None = None,
                 eviction_policy: str = "lru",
                 promote_on_access: bool = True,
                 write_policy: str = "through",
                 coordinated_eviction: bool = False,
                 durability: str = "none",
                 topology: Any | None = None) -> None:
        if n_nodes < 1:
            raise ValueError("need at least one node")
        if eviction_policy not in ("lru", "cost"):
            raise ValueError(f"unknown eviction policy {eviction_policy!r}")
        if write_policy not in ("through", "back"):
            raise ValueError(f"store-wide write policy must be 'through' or "
                             f"'back', not {write_policy!r} — 'around' is "
                             f"per-object (put(..., mode='around'))")
        if durability not in DURABILITY_POLICIES:
            raise ValueError(f"unknown durability policy {durability!r} "
                             f"(want one of {DURABILITY_POLICIES})")
        self.n_nodes = n_nodes
        self.durability = durability
        # optional repro_torch.core.topology.ClusterTopology: placement
        # spreads across racks (failure domains), reads prefer rack-local
        # replicas, and re-replication favors rack diversity. None or a
        # *flat* topology keeps every decision identical to the flat model.
        self.topology = topology
        self._topo_real = (topology if topology is not None
                           and not topology.flat else None)
        self.loc = LocationService(n_meta_shards)
        self.default_policy = default_policy
        self.hierarchy = hierarchy or FLAT_HIERARCHY
        self.eviction_policy = eviction_policy
        self.promote_on_access = promote_on_access
        self.write_policy = write_policy
        self.coordinated_eviction = coordinated_eviction
        self.writeback = WriteBackQueue()
        self._values: dict[str, Any] = {}
        self._sizes: dict[str, float] = {}
        # replica map: name -> {node: tier} (insertion order = primary first)
        self._residency: dict[str, dict[int, str]] = {}
        self._usage: dict[tuple[int, str], float] = {}
        self._last_access: dict[tuple[int, str], dict[str, int]] = {}
        # dirty objects: the current version has no durable PFS backing yet.
        # Replicas never diverge (a put replaces every copy), so the object
        # bit + the residency map IS the per-replica dirty state —
        # ``is_dirty(name, node)`` reads it per replica.
        self._dirty: set[str] = set()
        self._mode: dict[str, str] = {}       # per-object write mode
        # do-not-evict pin counts per (name, node) — the scheduler's shield
        # around prefetched replicas until their consumer has run
        self._pins: dict[tuple[str, int], int] = {}
        self._clock = 0
        self._lock = threading.RLock()
        self._rr = 0
        # accounting
        self.transfers: list[Transfer] = []
        self.bytes_moved = 0.0
        self.bytes_local = 0.0
        self.remote_bytes = 0.0        # network bytes touching the PFS tier
        self.bytes_demoted = 0.0
        self.demotions = 0
        self.promotions = 0
        self.bytes_promoted = 0.0      # bytes moved up-tier (warm/prefetch wins)
        self.migrations = 0
        self.tier_reads: dict[str, float] = {}
        # write-back / coordinated-eviction accounting
        self.writebacks = 0
        self.writeback_bytes = 0.0     # dirty bytes queued for async flush
        self.clean_drops = 0           # clean victims dropped (PFS had them)
        self.bytes_clean_dropped = 0.0
        self.coord_drops = 0           # replicated victims dropped, not moved
        self.bytes_coord_dropped = 0.0
        self.coordination_violations = 0   # a drop would have lost data (never)
        self.pin_protected_evictions = 0   # evictions a pin actually diverted
        # durability / failure accounting
        self.fsyncs = 0                # synchronous durability flushes
        self.fsync_bytes = 0.0
        self.phantom_durable = 0       # drains that would have laundered a
        # dead node's un-flushed bytes into a "durable" PFS copy (always 0
        # when failures go through drop_node — this is defense in depth)
        # membership / re-replication accounting
        self.rereplications = 0
        self.bytes_rereplicated = 0.0
        self._failed_nodes: set[int] = set()
        # sorted alive-node ids — default placement maps over this list so
        # hash/rr mass redistributes uniformly when nodes fail (no linear
        # probing, which would dump a dead run's mass on its first survivor)
        self._alive: list[int] = list(range(n_nodes))

    # ------------------------------------------------------------ placement
    def _default_placement(self, name: str) -> Placement:
        """Map over the *alive* list, not the full id range: indexing
        ``alive[h % len(alive)]`` keeps placement near-uniform across
        survivors no matter which nodes are down. (The old linear probe
        ``(node + 1) % n_nodes`` handed a dead run's entire hash/rr mass to
        its first surviving successor.) With nothing failed the alive list
        is ``range(n_nodes)`` and the mapping is identical to the original.

        Under a real topology the alive list is re-ordered rack-interleaved
        (:meth:`_spread_order`), so consecutive hash/rr indices land in
        different racks — default placement spreads across failure domains.
        With one rack (flat/one-switch) the interleave is the identity, so
        flat placement stays bit-identical."""
        with self._lock:
            alive = self._alive
            if not alive:
                raise RuntimeError("every node has failed")
            if self._topo_real is not None:
                alive = self._spread_order()
            if self.default_policy == "hash":   # Hercules/Memcached behaviour
                node = alive[_stable_hash(name) % len(alive)]
            elif self.default_policy == "rr":
                node = alive[self._rr % len(alive)]
                self._rr += 1
            else:
                raise ValueError(
                    f"unknown default policy {self.default_policy!r}")
        return Placement(nodes=(node,), tier=self.hierarchy.top)

    def _spread_order(self) -> list[int]:
        """The alive nodes re-ordered rack-interleaved: position-within-rack
        major, rack minor — walking the list round-robins the racks, so any
        consecutive window of default placements spans as many failure
        domains as possible. Cached per alive-list generation (membership
        changes are rare next to placements)."""
        alive = self._alive
        key = (len(alive), alive[0] if alive else -1, alive[-1] if alive else -1)
        cached = getattr(self, "_spread_cache", None)
        if cached is not None and cached[0] == key and cached[1] == alive:
            return cached[2]
        topo = self._topo_real
        seen: dict[int, int] = {}
        keyed: list[tuple[int, int, int]] = []
        for n in alive:
            r = topo.rack(n)
            k = seen.get(r, 0)
            seen[r] = k + 1
            keyed.append((k, r, n))
        keyed.sort()
        order = [n for _, _, n in keyed]
        self._spread_cache = (key, list(alive), order)
        return order

    def _norm_loc(self, loc: Any) -> Placement:
        if isinstance(loc, Placement):
            return loc
        if isinstance(loc, int):
            return Placement(nodes=(loc,), tier=self.hierarchy.top)
        if isinstance(loc, (tuple, list)):
            return Placement(nodes=tuple(int(n) for n in loc),
                             tier=self.hierarchy.top)
        raise TypeError(f"cannot interpret location {loc!r}")

    # ------------------------------------------------- tier admission (LRU)
    def _touch(self, name: str, node: int, tier: str) -> None:
        self._clock += 1
        self._last_access.setdefault((node, tier), {})[name] = self._clock

    # ------------------------------------------------------- dirty tracking
    def is_dirty(self, name: str, node: int | None = None) -> bool:
        """True if ``name`` (or specifically its replica on ``node``) lacks a
        durable PFS copy of the current version."""
        with self._lock:
            if name not in self._dirty:
                return False
            if node is None:
                return True
            return node in self._residency.get(name, {})

    def write_mode(self, name: str) -> str:
        """Effective write policy of one object ("through"/"back"/"around")."""
        return self._mode.get(name, self.write_policy)

    def durable(self, name: str) -> bool:
        """True when the PFS holds the *current* version of ``name`` — the
        object would survive losing every node-local replica. A pending
        (undrained) write-back does NOT make an object durable: the bytes
        have not crossed the network yet."""
        with self._lock:
            return name in self._values and name not in self._dirty

    @property
    def failed_nodes(self) -> frozenset[int]:
        with self._lock:
            return frozenset(self._failed_nodes)

    # -------------------------------------------------- do-not-evict pinning
    def pin(self, name: str, node: int) -> None:
        """Mark ``name``'s replica on ``node`` do-not-evict (refcounted).

        The ProactiveScheduler pins a replica it prefetched until the
        consuming task finishes, so capacity pressure elsewhere on the node
        cannot drop the duplicate it just created (the "prefetch undone by
        coordinated eviction at comfortable capacity" ROADMAP bug)."""
        with self._lock:
            key = (name, node)
            self._pins[key] = self._pins.get(key, 0) + 1

    def unpin(self, name: str, node: int) -> None:
        """Release one pin; unknown pins are ignored (the replica may have
        been deleted or its node failed while pinned)."""
        with self._lock:
            key = (name, node)
            n = self._pins.get(key, 0) - 1
            if n > 0:
                self._pins[key] = n
            else:
                self._pins.pop(key, None)

    def is_pinned(self, name: str, node: int) -> bool:
        with self._lock:
            return self._pins.get((name, node), 0) > 0

    # --------------------------------------------------------------- victims
    def _replicas_elsewhere(self, name: str,
                            node: int, tier: str) -> list[tuple[int, str]]:
        """Other replicas of ``name`` beyond the one at (node, tier), per the
        LocationService — the cluster-wide view coordinated eviction ranks
        victims by. Falls back to the residency map if the service has no
        record (mid-update)."""
        p = self.loc.lookup(name)
        if p is not None and p.tiers is not None:
            pairs = list(zip(p.nodes, p.tiers))
        else:
            pairs = list(self._residency.get(name, {}).items())
        return [(n, t) for n, t in pairs if not (n == node and t == tier)]

    def _victim(self, node: int, tier: str, protect: str) -> str | None:
        recency = self._last_access.get((node, tier), {})
        everyone = [n for n in recency if n != protect]
        candidates = [n for n in everyone if not self._pins.get((n, node))]
        if self.eviction_policy == "cost":
            # cost-aware: large, stale objects go first — freeing the most
            # capacity for the least loss of hot data (GreedyDual-Size-ish;
            # with equal sizes it degrades to plain LRU).
            base = lambda n: -(self._sizes.get(n, 0.0)          # noqa: E731
                               * (self._clock - recency[n] + 1))
        else:
            base = lambda n: recency[n]                         # noqa: E731
        if self.coordinated_eviction:
            # Cluster-coordinated: consult the LocationService and evict
            # replicated objects before sole copies. Class 0: another
            # replica in an equal-or-faster tier exists somewhere (this copy
            # is fully redundant). Class 1: only colder duplicates elsewhere
            # (this is the last fast-tier copy — evicting it is still free,
            # but the dataset goes cold). Class 2: sole copy — demoting it
            # moves real bytes.
            my_rank = self.hierarchy.rank(tier)

            def klass(n: str) -> int:
                others = self._replicas_elsewhere(n, node, tier)
                if not others:
                    return 2
                if any(self.hierarchy.rank(t) <= my_rank for _, t in others):
                    return 0
                return 1

            key = lambda n: (klass(n), base(n))                 # noqa: E731
        else:
            key = base
        if not candidates:
            if everyone:        # only pinned choices: the pins blocked this
                self.pin_protected_evictions += 1
            return None
        choice = min(candidates, key=key)
        if len(candidates) != len(everyone):
            # count a protection only when a pin CHANGED the outcome — the
            # unpinned ranking would have evicted a pinned replica instead
            if min(everyone, key=key) != choice:
                self.pin_protected_evictions += 1
        return choice

    def _evict(self, victim: str, node: int, tier: str,
               hops: list[TierHop] | None) -> None:
        """Evict one replica: coordinated mode drops replicas that are
        duplicated elsewhere (free — a copy survives), everything else is
        demoted down-tier. Sole copies are NEVER dropped."""
        if self.coordinated_eviction:
            others = self._replicas_elsewhere(victim, node, tier)
            # belt and braces: only drop when the residency map agrees a
            # duplicate survives — the LocationService can lag mid-update
            live = [n for n, t in self._residency.get(victim, {}).items()
                    if not (n == node and t == tier)]
            if others and live:
                self._drop_replica(victim, node, tier)
                self.coord_drops += 1
                self.bytes_coord_dropped += self._sizes.get(victim, 0.0)
                return
            if others and not live:
                self.coordination_violations += 1   # lagging metadata — demote
        self._demote(victim, node, tier, hops)

    def _drop_replica(self, name: str, node: int, tier: str) -> None:
        res = self._residency.get(name)
        if res is None or res.get(node) != tier:
            return
        del res[node]
        key = (node, tier)
        self._usage[key] = max(self._usage.get(key, 0.0)
                               - self._sizes.get(name, 0.0), 0.0)
        self._last_access.get(key, {}).pop(name, None)

    def _record_pfs_write(self, name: str, node: int, src_tier: str,
                          nbytes: float, kind: str,
                          hops: list[TierHop] | None, *,
                          read_src_tier: bool = False) -> None:
        """The one place PFS-bound writes hit the ledger AND the scalars —
        a hand-copied variant of this block once let the spill accounting
        drift from the ledger. ``read_src_tier`` adds the media time of reading
        the evicted tier (a spill of data that never resided there, e.g. a
        put overflow, pays only the PFS write). Caller holds the lock."""
        est = self.hierarchy.media_seconds(nbytes, "remote")
        if read_src_tier:
            est += self.hierarchy.media_seconds(nbytes, src_tier)
        hop = TierHop(node, src_tier, REMOTE_TIER, "remote", nbytes, est)
        if hops is not None:
            hops.append(hop)
        self.bytes_moved += nbytes
        self.remote_bytes += nbytes
        self.transfers.append(Transfer(
            name, nbytes, node, REMOTE_TIER, src_tier=src_tier,
            dst_tier="remote", est_seconds=est, kind=kind, hops=(hop,)))

    def _admit(self, name: str, node: int, tier: str,
               hops: list[TierHop] | None = None, *,
               spill: bool = False, record_spill: bool = False,
               origin_tier: str | None = None) -> str:
        """Place ``name``'s replica at (node, tier), evicting victims to fit.

        Returns the tier the object actually landed in (an object larger than
        every node tier cascades straight down to the remote PFS). Caller
        holds the lock. Demotion hops are appended to ``hops`` and recorded as
        ``kind="demote"`` transfers. ``spill=True`` means landing on the
        remote tier is capacity-forced data movement (counted in
        ``bytes_moved``/``remote_bytes``), not a caller-pinned PFS placement;
        ``record_spill=True`` additionally logs that crossing as a
        ``kind="spill"`` Transfer (``_demote`` records its own transfer, so it
        passes False). A synchronous landing on the PFS makes the durable
        copy current, clearing the object's dirty bit.
        """
        nbytes = self._sizes.get(name, 0.0)
        if node == REMOTE_TIER or not self.hierarchy.is_node_tier(tier):
            res = self._residency.setdefault(name, {})
            if spill and REMOTE_TIER not in res:
                if record_spill and node != REMOTE_TIER:
                    self._record_pfs_write(
                        name, node, origin_tier or self.hierarchy.top,
                        nbytes, "spill", hops)
                else:       # _demote records its own transfer for this spill
                    self.bytes_moved += nbytes
                    self.remote_bytes += nbytes
            res[REMOTE_TIER] = "remote"
            self._dirty.discard(name)          # PFS now holds this version
            return "remote"
        cap = self.hierarchy.capacity(tier)
        if nbytes > cap:                       # cannot ever fit: skip down
            down = self.hierarchy.next_down(tier)
            return self._admit(name, node,
                               down if down is not None else "remote", hops,
                               spill=spill, record_spill=record_spill,
                               origin_tier=origin_tier or tier)
        res = self._residency.setdefault(name, {})
        old = res.get(node)
        if old == tier:
            self._touch(name, node, tier)
            return tier
        if old is not None:                    # moving between tiers on-node
            self._drop_replica(name, node, old)
        key = (node, tier)
        self._usage[key] = self._usage.get(key, 0.0) + nbytes
        res[node] = tier
        self._touch(name, node, tier)
        # cascade-evict until this tier fits again
        while self._usage.get(key, 0.0) > cap:
            victim = self._victim(node, tier, protect=name)
            if victim is None:
                break
            self._evict(victim, node, tier, hops)
            self._sync_placement(victim)
        return tier

    def _demote(self, name: str, node: int, tier: str,
                hops: list[TierHop] | None = None) -> None:
        """Move one replica a tier down (to the remote PFS past the bottom).

        Past the bottom node tier the object's write policy decides the spill:
        write-through moves the bytes synchronously; write-back drops clean
        victims for free (the PFS already holds them) and enqueues dirty ones
        on the :class:`WriteBackQueue` for an asynchronous flush.
        """
        nbytes = self._sizes.get(name, 0.0)
        down = self.hierarchy.next_down(tier)
        while down is not None and nbytes > self.hierarchy.capacity(down):
            down = self.hierarchy.next_down(down)
        if down is None:                       # next stop: the parallel FS
            if (REMOTE_TIER in self._residency.get(name, {})
                    and name not in self._dirty):
                # the PFS already holds this exact version — eviction is a
                # free drop, not a second write (both policies agree; a
                # second write here would split the ledger from the scalars)
                self._drop_replica(name, node, tier)
                self.clean_drops += 1
                self.bytes_clean_dropped += nbytes
                return
            if self.write_mode(name) == "back":
                self._writeback_evict(name, node, tier, nbytes, hops)
                return
        self._drop_replica(name, node, tier)
        landed = self._admit(name, node,
                             down if down is not None else "remote", hops,
                             spill=True)
        if landed == "remote":
            dst_node, dst_tier = REMOTE_TIER, "remote"
        else:
            dst_node, dst_tier = node, landed
        est = (self.hierarchy.media_seconds(nbytes, tier)
               + self.hierarchy.media_seconds(nbytes, dst_tier))
        hop = TierHop(node, tier, dst_node, dst_tier, nbytes, est)
        if hops is not None:
            hops.append(hop)
        self.bytes_demoted += nbytes
        self.demotions += 1
        self.transfers.append(Transfer(
            name, nbytes, node, dst_node, src_tier=tier, dst_tier=dst_tier,
            est_seconds=est, kind="demote", hops=(hop,)))

    def _writeback_evict(self, name: str, node: int, tier: str,
                         nbytes: float, hops: list[TierHop] | None) -> None:
        """Evict a dirty replica past the bottom node tier, write-back style:
        record the (logical) move to the remote tier now, enqueue the flush;
        the bytes cross the network when the runtime drains the queue, off
        the critical path. Caller holds the lock (clean replicas were already
        dropped for free by ``_demote``)."""
        self._drop_replica(name, node, tier)
        res = self._residency.setdefault(name, {})
        res[REMOTE_TIER] = "remote"
        if self.writeback.has(name):           # flush of this version pending
            return
        self._record_pfs_write(name, node, tier, nbytes, "writeback", hops,
                               read_src_tier=True)
        self.bytes_demoted += nbytes
        self.demotions += 1
        self.writebacks += 1
        self.writeback_bytes += nbytes
        self.writeback.push(name, node, tier, nbytes,
                            self.transfers[-1].est_seconds)

    def drain_writebacks(self, max_entries: int | None = None
                         ) -> list[WriteBackEntry]:
        """Flush pending asynchronous PFS writes, FIFO.

        The runtime calls this off the critical path (simulator: when it
        charges the background NIC lane; executor: drainer thread). Each
        drained entry makes the PFS copy durable, clearing the object's dirty
        bit. Entries whose object was deleted meanwhile are skipped (their
        enqueue-time accounting stands — the modelled bytes were in flight).
        """
        out: list[WriteBackEntry] = []
        consumed = 0
        while max_entries is None or consumed < max_entries:
            # pop under the store lock: put()/delete() cancel stale entries
            # while holding it, so an overwrite can never slip between the
            # pop and the dirty-bit clear and get its NEW version marked
            # durable on the strength of the OLD version's flush
            with self._lock:
                popped = self.writeback.pop()
                if popped is None:
                    break
                consumed += 1
                entry, live = popped
                if not live:            # tombstone: consume the slot only
                    continue
                if entry.node in self._failed_nodes:
                    # defense in depth: drop_node tombstones these, but a
                    # flush sourced on a dead node must NEVER launder the
                    # lost bytes into a "durable" PFS copy
                    self.phantom_durable += 1
                    continue
                if entry.name in self._values:
                    self._dirty.discard(entry.name)
                    res = self._residency.setdefault(entry.name, {})
                    res[REMOTE_TIER] = "remote"
                    self._sync_placement(entry.name)
            out.append(entry)
        return out

    # ------------------------------------------------- durability / failure
    def _fsync_object(self, name: str) -> bool:
        """Synchronously make ``name``'s current version durable on the PFS
        (``kind="fsync"`` transfer — the runtime charges it to the demand NIC
        lane: an ack/barrier waits on it). Supersedes any pending async
        flush. Caller holds the lock. Returns True if bytes moved."""
        if name not in self._dirty or name not in self._values:
            return False
        res = self._residency.setdefault(name, {})
        srcs = [n for n in res if n != REMOTE_TIER
                and n not in self._failed_nodes]
        if srcs:
            src = min(srcs, key=lambda n: self.hierarchy.rank(res[n]))
            src_tier = res[src]
        else:
            # writeback-evicted: the only residency is the flush's logical
            # REMOTE promise — the bytes still sit on the evicting node's
            # tier (that is what the queue entry records) until flushed
            pend = [e for e in self.writeback.pending_for(name)
                    if e.node not in self._failed_nodes]
            if not pend:
                return False               # no live replica to read from
            src, src_tier = pend[0].node, pend[0].src_tier
        nbytes = self._sizes.get(name, 0.0)
        self.writeback.cancel(name)        # the fsync IS the flush
        self._record_pfs_write(name, src, src_tier, nbytes, "fsync", None,
                               read_src_tier=True)
        res[REMOTE_TIER] = "remote"
        self._dirty.discard(name)
        self.fsyncs += 1
        self.fsync_bytes += nbytes
        self._sync_placement(name)
        return True

    def fsync(self, names: Iterable[str] | None = None) -> int:
        """Force-flush dirty objects to the PFS (all of them, or ``names``).
        Returns how many objects moved bytes."""
        with self._lock:
            todo = list(names) if names is not None else list(self._dirty)
            return sum(self._fsync_object(n) for n in todo)

    def barrier(self) -> int:
        """The ``fsync_on_barrier`` sync point: everything dirty becomes
        durable now. The runtime calls this at workflow barriers (simulator:
        every ``barrier_every`` task finishes; executor: after each task's
        outputs are put)."""
        return self.fsync()

    def drop_node(self, node: int) -> DropReport:
        """Atomically handle the failure of ``node``.

        One lock hold: (1) cancel pending write-back flushes sourced on the
        node and revoke the logical PFS residency they pre-recorded (the
        flush never delivered — leaving it would let a later drain mark the
        lost object durable: the phantom-PFS-copy bug), (2) forget every
        replica the node held, (3) clear the node's pin refcounts, then
        delete objects whose last copy died so ``exists()`` turns False and
        the caller can re-run producers."""
        with self._lock:
            self._failed_nodes.add(node)
            i = bisect.bisect_left(self._alive, node)
            if i < len(self._alive) and self._alive[i] == node:
                del self._alive[i]
            lost: list[str] = []
            survived: list[str] = []
            dirty_lost: list[str] = []
            # (1) in-flight flushes sourced on the dead node will never land
            phantom = 0
            cancelled = self.writeback.cancel_node(node)
            for e in cancelled:
                if e.name not in self._dirty:
                    continue               # a later fsync already delivered
                res = self._residency.get(e.name)
                if res is not None and res.get(REMOTE_TIER) == "remote":
                    del res[REMOTE_TIER]   # the promised PFS copy is a lie
                    phantom += 1
                    if not res:
                        # the phantom was the only residency: the dirty
                        # version lived nowhere but the dead node's queue
                        lost.append(e.name)
                        dirty_lost.append(e.name)
            # (2) replicas on the dead node
            for name in list(self._residency):
                res = self._residency[name]
                if node not in res:
                    continue
                self._drop_replica(name, node, res[node])
                if res:
                    survived.append(name)
                elif name not in lost:
                    lost.append(name)
                    if name in self._dirty:
                        dirty_lost.append(name)
            # (3) the node's pin refcounts shield nothing anymore
            released = 0
            for key in [k for k in self._pins if k[1] == node]:
                released += self._pins.pop(key)
            for name in lost:
                self.delete(name)          # data gone: producers must re-run
            for name in survived:
                self._sync_placement(name)
        # after the per-name record/drop events: one node-level event so
        # subscribers (schedulers) can purge per-node caches — stale
        # pre-assignments and prefetched-replica markers for the dead node
        self.loc.notify("drop_node", node, None)
        return DropReport(node=node, lost=tuple(lost),
                          survived=tuple(survived),
                          dirty_lost=tuple(dirty_lost),
                          cancelled_flushes=len(cancelled),
                          phantom_remote_revoked=phantom,
                          released_pins=released)

    def join_node(self, node: int) -> JoinReport:
        """Admit ``node`` into the cluster (saxml-style join: the node
        announces itself, the admin side updates membership).

        Handles both halves of elasticity: a *rejoin* clears the failed
        mark left by :meth:`drop_node` (the node returns with empty tiers —
        its data died with it), and a *growth* join extends ``n_nodes`` for
        a brand-new id. Either way the node re-enters default placement and
        a ``("join_node", node, None)`` event is published so event-driven
        subscribers (indexed scheduler mirrors, preplace eligibility, the
        simulator's candidate index and cached cluster views) absorb the
        newcomer without a rescan."""
        if node < 0:
            raise ValueError(f"node id must be >= 0, got {node}")
        with self._lock:
            rejoined = node in self._failed_nodes
            grew = node >= self.n_nodes
            self._failed_nodes.discard(node)
            if grew:
                # a gapped growth join (node 5 into a 4-node cluster) must
                # NOT silently admit the skipped ids: mark them failed so
                # alive + failed always partitions range(n_nodes) and a
                # later join_node/revive_node can admit them explicitly
                self._failed_nodes.update(range(self.n_nodes, node))
                self.n_nodes = node + 1
            i = bisect.bisect_left(self._alive, node)
            if i == len(self._alive) or self._alive[i] != node:
                self._alive.insert(i, node)
            # a rejoining node starts cold: defensively purge any residual
            # per-node state (drop_node already cleared these — this guards
            # against a join for a node that never went through drop_node)
            for key in [k for k in self._usage if k[0] == node]:
                del self._usage[key]
            for key in [k for k in self._last_access if k[0] == node]:
                del self._last_access[key]
            for key in [k for k in self._pins if k[1] == node]:
                del self._pins[key]
        self.loc.notify("join_node", node, None)
        return JoinReport(node=node, rejoined=rejoined, grew=grew)

    def revive_node(self, node: int) -> JoinReport:
        """Re-admit a node that previously failed (strict :meth:`join_node`:
        raises if ``node`` is not currently in the failed set)."""
        with self._lock:
            if node not in self._failed_nodes:
                raise ValueError(f"node {node} is not failed — use "
                                 f"join_node() for growth joins")
        return self.join_node(node)

    def rereplication_candidates(self, node: int, *,
                                 max_bytes: float = float("inf"),
                                 only_src: int | None = None
                                 ) -> list[tuple[str, int, str, float]]:
        """Objects worth copying toward ``node``, riskiest first.

        A candidate has exactly ONE node-local replica (a real PFS copy
        does not count — re-replication is about node-local locality and
        loss exposure), lives on a surviving node other than ``node``, and
        is not write-around (those are never replicated). Ordering is the
        write side of ``risk_aware``: *dirty* sole copies first (no durable
        PFS version — losing that node loses the data), then clean sole
        copies; under a real topology, sources in a *different rack* than
        ``node`` rank first within each class (copying them to ``node``
        buys rack-domain diversity — flat topologies make this component
        constant, keeping the order unchanged); largest-first next, name as
        the deterministic tiebreak. ``max_bytes`` caps the greedy budget
        (too-big entries are skipped, smaller ones keep filling).

        ``only_src`` restricts candidates to sole copies living on that one
        node — the predictive trigger draining a straggling/flaky suspect
        before its failure (the budget then applies to the suspect alone).

        Returns ``(name, src_node, src_tier, nbytes)`` tuples."""
        topo = self._topo_real
        out: list[tuple[int, int, float, str, int, str]] = []
        with self._lock:
            for name, res in self._residency.items():
                locals_ = [(n, t) for n, t in res.items() if n != REMOTE_TIER]
                if len(locals_) != 1:
                    continue
                src, src_tier = locals_[0]
                if src == node or src in self._failed_nodes:
                    continue
                if only_src is not None and src != only_src:
                    continue
                if self._mode.get(name, self.write_policy) == "around":
                    continue
                nbytes = self._sizes.get(name, 0.0)
                risk = 0 if name in self._dirty else 1
                diverse = (1 if topo is not None
                           and topo.same_rack(src, node) else 0)
                out.append((risk, diverse, -nbytes, name, src, src_tier))
        out.sort()
        picked: list[tuple[str, int, str, float]] = []
        budget = max_bytes
        for risk, _diverse, neg, name, src, src_tier in out:
            nbytes = -neg
            if nbytes > budget:
                continue
            budget -= nbytes
            picked.append((name, src, src_tier, nbytes))
        return picked

    def rereplicate_to(self, node: int, *, max_bytes: float = float("inf"),
                       tier: str | None = None,
                       only_src: int | None = None) -> tuple[str, ...]:
        """Copy sole-copy objects (dirty first) onto ``node`` — close the
        at-risk window a newcomer opens the capacity to close. ``tier`` is
        the landing tier on the newcomer (default: the hierarchy's bottom —
        bulk re-replication must not shoulder warm data out of fast tiers).
        ``only_src`` drains a single suspect node (predictive trigger)."""
        want = tier if tier is not None else self.hierarchy.bottom
        done: list[str] = []
        for name, _src, _src_tier, nbytes in self.rereplication_candidates(
                node, max_bytes=max_bytes, only_src=only_src):
            self.replicate(name, [node], tier=want)
            self.rereplications += 1
            self.bytes_rereplicated += nbytes
            done.append(name)
        return tuple(done)

    def _sync_placement(self, name: str) -> None:
        """Re-record the LocationService entry from the residency map."""
        res = self._residency.get(name)
        if not res:
            return
        prev = self.loc.lookup(name)
        nodes = tuple(res.keys())
        tiers = tuple(res.values())
        self.loc.record(name, Placement(
            nodes=nodes, tier=tiers[0], tiers=tiers,
            xattr=prev.xattr if prev is not None else {}))

    # ------------------------------------------------------------------ api
    def put(self, name: str, value: Any, *, loc: Any | None = None,
            tier: str | None = None,
            xattr: Mapping[str, Any] | None = None,
            mode: str | None = None) -> Placement:
        """Create an object; ``loc`` is the paper's ``S_LOC`` pinned placement.

        ``tier`` pins the starting tier on every node of the placement
        (default: the hierarchy's top tier — fresh output lands in the fastest
        memory and capacity pressure demotes it from there). ``mode``
        overrides the store's write policy for this object: ``"around"``
        streams it straight to the PFS (run-once output — it never occupies
        node tiers and reads are never cached).
        """
        if mode is not None and mode not in WRITE_POLICIES:
            raise ValueError(f"unknown write mode {mode!r}")
        eff_mode = mode or self.write_policy
        placement = (self._norm_loc(loc) if loc is not None
                     else self._default_placement(name))
        if eff_mode == "around" and (tier is not None
                                     or len(placement.nodes) > 1):
            # the object will live on the PFS only — a tier pin or a
            # multi-node placement contradicts the mode; reject rather than
            # silently drop the caller's pins
            raise ValueError("mode='around' streams to the PFS: it cannot "
                             "honor a tier= pin or a multi-node placement "
                             "(loc names the single producer node)")
        for n in placement.nodes:
            if n != REMOTE_TIER and not (0 <= n < self.n_nodes):
                raise ValueError(f"node {n} out of range for {self.n_nodes} nodes")
        placement.xattr.update(xattr or {})
        placement.xattr.setdefault("ctime", time.time())
        placement.xattr.setdefault("size", sizeof(value))
        want = self.hierarchy.normalize(tier if tier is not None
                                        else placement.tier)
        with self._lock:
            if name in self._residency:      # overwrite: clear old replicas
                for n, t in list(self._residency[name].items()):
                    self._drop_replica(name, n, t)
                self._residency.pop(name, None)
                self._dirty.discard(name)
                self.writeback.cancel(name)  # stale version: never flush it
            self._values[name] = value
            nbytes = sizeof(value)
            self._sizes[name] = nbytes
            self._mode[name] = eff_mode
            if eff_mode == "around":
                # streaming output: written straight past the node tiers to
                # the PFS. A node placement names the producer, so the bytes
                # cross the network now; a PFS placement is the data's origin.
                src = placement.nodes[0]
                res = self._residency.setdefault(name, {})
                res[REMOTE_TIER] = "remote"
                if src != REMOTE_TIER:
                    self._record_pfs_write(name, src, self.hierarchy.top,
                                           nbytes, "writearound", None)
            else:
                for n in placement.nodes:
                    # an explicit PFS placement is where the data starts, not
                    # a movement; a node placement that cascades to the PFS is
                    self._admit(name, n,
                                "remote" if n == REMOTE_TIER else want,
                                spill=n != REMOTE_TIER, record_spill=True,
                                origin_tier=want)
            if REMOTE_TIER in self._residency[name]:
                self._dirty.discard(name)    # the PFS holds this version
            else:
                self._dirty.add(name)        # fresh data, no durable PFS copy
                if self.durability == "flush_before_ack":
                    # the ack is gated on durability: the PFS write happens
                    # NOW (kind="fsync", producer's demand NIC lane)
                    self._fsync_object(name)
            nodes = tuple(self._residency[name].keys())
            tiers = tuple(self._residency[name].values())
        final = Placement(nodes=nodes, tier=tiers[0], tiers=tiers,
                          xattr=placement.xattr)
        self.loc.record(name, final)
        return final

    def exists(self, name: str) -> bool:
        return self.loc.lookup(name) is not None

    def stat(self, name: str) -> Placement:
        p = self.loc.lookup(name)
        if p is None:
            raise KeyError(name)
        return p

    def getxattr(self, name: str, key: str) -> Any:
        """POSIX ``getxattr`` equivalent, incl. the location metadata."""
        p = self.stat(name)
        if key == "real_loc":
            return p.real_loc
        if key == "nodes":
            return p.nodes
        if key == "tier":
            return p.tier
        return p.xattr[key]

    def get(self, name: str, *, at: int | None = None) -> tuple[Any, Transfer | None]:
        """Read an object from node ``at``; returns (value, movement record).

        If the object is resident on ``at`` the movement record is a local hit
        (``Transfer.local``) whose ``est_seconds`` is the resident tier's media
        time, and the replica is promoted back to the top tier; otherwise the
        nearest (highest-tier, then closest) replica is the source and the
        store notes a network transfer. ``at=None`` skips accounting
        (metadata read).
        """
        self.stat(name)                       # raises KeyError if unknown
        with self._lock:
            value = self._values[name]
            if at is None:
                return value, None
            nbytes = self._sizes.get(name, sizeof(value))
            res = self._residency.get(name, {})
            if at in res:
                src_tier = res[at]
                hops: list[TierHop] = [TierHop(at, src_tier, at, src_tier,
                                               nbytes,
                                               self.hierarchy.media_seconds(
                                                   nbytes, src_tier))]
                self._touch(name, at, src_tier)
                dst_tier = src_tier
                if (self.promote_on_access
                        and self.hierarchy.is_node_tier(src_tier)
                        and src_tier != self.hierarchy.top):
                    # victim demotions this admit causes are recorded as
                    # their own kind="demote" transfers, not in our hops
                    landed = self._admit(name, at, self.hierarchy.top)
                    if landed != src_tier:
                        self.promotions += 1
                        self.bytes_promoted += nbytes
                        hops.append(TierHop(
                            at, src_tier, at, landed, nbytes,
                            self.hierarchy.media_seconds(nbytes, landed)))
                        dst_tier = landed
                    self._sync_placement(name)
                t = Transfer(name, nbytes, at, at, src_tier=src_tier,
                             dst_tier=dst_tier,
                             est_seconds=hops[0].est_seconds,
                             kind="fetch", hops=tuple(hops))
                self.bytes_local += nbytes
                self.tier_reads[src_tier] = (self.tier_reads.get(src_tier, 0.0)
                                             + nbytes)
                self.transfers.append(t)
                return value, t
            # remote replica: prefer non-PFS, then the fastest tier, then
            # near — under a real topology "near" means rack-local first
            # (a same-ToR replica skips the spine); the rack component is
            # constant on flat topologies, so flat choices are unchanged
            topo = self._topo_real
            if topo is None:
                src = min(res, key=lambda n: (n == REMOTE_TIER,
                                              self.hierarchy.rank(res[n]),
                                              abs(n - at)))
            else:
                src = min(res, key=lambda n: (n == REMOTE_TIER,
                                              self.hierarchy.rank(res[n]),
                                              0 if topo.same_rack(n, at) else 1,
                                              abs(n - at)))
            src_tier = res[src]
            dst_tier = self.hierarchy.top
            est = (self.hierarchy.media_seconds(nbytes, src_tier)
                   + self.hierarchy.media_seconds(nbytes, dst_tier))
            hop = TierHop(src, src_tier, at, dst_tier, nbytes, est)
            t = Transfer(name, nbytes, src, at, src_tier=src_tier,
                         dst_tier=dst_tier, est_seconds=est, kind="fetch",
                         hops=(hop,))
            self._touch(name, src, src_tier)
            self.bytes_moved += nbytes
            if src == REMOTE_TIER:
                self.remote_bytes += nbytes
            self.tier_reads[src_tier] = (self.tier_reads.get(src_tier, 0.0)
                                         + nbytes)
            self.transfers.append(t)
        return value, t

    def promote(self, name: str, node: int, tier: str | None = None) -> Placement:
        """Explicitly move a replica already resident on ``node`` to ``tier``
        (default: top) — the storage half of a device-targeted prefetch. Use
        :meth:`replicate` to create a replica on a new node."""
        want = self.hierarchy.normalize(tier)
        with self._lock:
            res = self._residency.get(name)
            if res is None or node not in res:
                raise KeyError(f"{name!r} has no replica on node {node}")
            have = res[node]
            if have != want:
                if self.hierarchy.rank(want) < self.hierarchy.rank(have):
                    self.promotions += 1       # moved up-tier; down is a pin
                    self.bytes_promoted += self._sizes.get(name, 0.0)
                self._admit(name, node, want)
            self._sync_placement(name)
        return self.stat(name)

    def migrate(self, name: str, loc: Any) -> Transfer:
        """Re-pin an object (the runtime->FS feedback channel).

        Returns the transfer that re-pinning implies. The value itself stays in
        the in-process dict (host RAM) — on a real deployment this issues the
        copy; device-resident arrays are re-placed by the executor.
        """
        p = self.stat(name)
        new = self._norm_loc(loc)
        new.xattr.update(p.xattr)
        new.xattr["migrated_from"] = p.nodes
        with self._lock:
            nbytes = self._sizes.get(name, 0.0)
            src = p.real_loc
            self.migrations += 1
            if not set(new.nodes) & set(p.nodes):
                self.bytes_moved += nbytes
                if src == REMOTE_TIER or REMOTE_TIER in new.nodes:
                    self.remote_bytes += nbytes
            for n, t in list(self._residency.get(name, {}).items()):
                self._drop_replica(name, n, t)
            self._residency.pop(name, None)
            self._residency[name] = {}
            want = self.hierarchy.normalize(new.tier)
            for n in new.nodes:
                self._admit(name, n, "remote" if n == REMOTE_TIER else want,
                            spill=n != REMOTE_TIER, record_spill=True,
                            origin_tier=want)
            if REMOTE_TIER in self._residency[name]:
                self._dirty.discard(name)
            elif name in self._values:
                # the re-pin dropped the PFS replica: no durable copy anymore
                # (a pending flush, if any, will restore one when drained)
                self._dirty.add(name)
                if self.durability == "flush_before_ack":
                    self._fsync_object(name)   # the window must stay closed
            nodes = tuple(self._residency[name].keys())
            tiers = tuple(self._residency[name].values())
        final = Placement(nodes=nodes, tier=tiers[0], tiers=tiers,
                          xattr=new.xattr)
        self.loc.record(name, final)
        tr = Transfer(name, nbytes, src, final.real_loc,
                      src_tier=p.tier, dst_tier=final.tier, kind="migrate")
        if not set(final.nodes) & set(p.nodes):
            with self._lock:
                self.transfers.append(tr)      # the copy the re-pin implies
        return tr

    def replicate(self, name: str, extra_nodes: Iterable[int],
                  tier: str | None = None) -> Placement:
        """Add replicas (used by the prefetch engine: the original stays).

        ``tier`` targets a tier on the new nodes (default: top — a prefetch
        is supposed to land the data in the fastest memory). Write-around
        objects are read exactly once: replicating them is a no-op — their
        only home is the PFS.
        """
        self.stat(name)                       # raises KeyError if unknown
        if self.write_mode(name) == "around":
            return self.stat(name)
        want = self.hierarchy.normalize(tier)
        with self._lock:
            for n in extra_nodes:
                self._admit(name, int(n),
                            "remote" if int(n) == REMOTE_TIER else want,
                            spill=int(n) != REMOTE_TIER, record_spill=True,
                            origin_tier=want)
            self._sync_placement(name)
        return self.stat(name)

    def delete(self, name: str) -> None:
        with self._lock:
            self._values.pop(name, None)
            for n, t in list(self._residency.get(name, {}).items()):
                self._drop_replica(name, n, t)
            self._residency.pop(name, None)
            self._sizes.pop(name, None)
            self._dirty.discard(name)
            self._mode.pop(name, None)
            for key in [k for k in self._pins if k[0] == name]:
                del self._pins[key]
            self.writeback.cancel(name)
        self.loc.drop(name)

    def forget_replica(self, name: str, node: int) -> None:
        """Drop one node's replica from the residency map (failure handling).

        Dropping the LAST replica deletes the object entirely — the data is
        lost and ``exists()`` turns False so the caller can re-run the
        producer (what the simulator's failure path does)."""
        with self._lock:
            res = self._residency.get(name)
            if res is None or node not in res:
                return
            self._drop_replica(name, node, res[node])
            if res:
                self._sync_placement(name)
            else:
                self.delete(name)

    # ------------------------------------------------------------ reporting
    def movement_report(self) -> Mapping[str, float]:
        total = self.bytes_moved + self.bytes_local
        return {
            "bytes_moved": self.bytes_moved,
            "bytes_local": self.bytes_local,
            "locality_hit_rate": (self.bytes_local / total) if total else 1.0,
            "remote_bytes": self.remote_bytes,
            "bytes_demoted": self.bytes_demoted,
            "demotions": float(self.demotions),
            "promotions": float(self.promotions),
            "bytes_promoted": self.bytes_promoted,
            "migrations": float(self.migrations),
            "transfers": float(len(self.transfers)),
            "writebacks": float(self.writebacks),
            "writeback_bytes": self.writeback_bytes,
            "writeback_pending": float(len(self.writeback)),
            "clean_drops": float(self.clean_drops),
            "bytes_clean_dropped": self.bytes_clean_dropped,
            "coord_drops": float(self.coord_drops),
            "bytes_coord_dropped": self.bytes_coord_dropped,
            "pin_protected_evictions": float(self.pin_protected_evictions),
            "pins": float(len(self._pins)),
            "fsyncs": float(self.fsyncs),
            "fsync_bytes": self.fsync_bytes,
            "phantom_durable": float(self.phantom_durable),
            "rereplications": float(self.rereplications),
            "bytes_rereplicated": self.bytes_rereplicated,
        }

    def tier_used(self, node: int, tier: str | None = None) -> float:
        """Resident bytes in one node's ``tier`` (default: top) — the O(1)
        admission-pressure probe. ``tier_report`` walks every replica in the
        store to build its full per-tier table, which is fine for end-of-run
        reporting but not for a router pricing every follow-up at 10^5
        sessions; this reads the maintained usage counter directly."""
        t = self.hierarchy.normalize(tier)
        with self._lock:
            return self._usage.get((node, t), 0.0)

    def tier_report(self, node: int | None = None
                    ) -> Mapping[str, Mapping[str, float]]:
        """Per-tier residency and read traffic; ``node`` narrows residency to
        one node (bytes_read stays cluster-wide — reads are not attributed
        per node), which is how the serving Router measures an engine's
        tier pressure."""
        out: dict[str, dict[str, float]] = {
            t: {"resident_bytes": 0.0, "bytes_read": 0.0, "replicas": 0.0}
            for t in self.hierarchy.names()}
        with self._lock:
            for (n, tier), used in self._usage.items():
                if node is not None and n != node:
                    continue
                out.setdefault(tier, {"resident_bytes": 0.0, "bytes_read": 0.0,
                                      "replicas": 0.0})
                out[tier]["resident_bytes"] += used
            for res in self._residency.values():
                for n, tier in res.items():
                    if node is None or n == node:
                        out[tier]["replicas"] += 1
            for tier, nb in self.tier_reads.items():
                out[tier]["bytes_read"] += nb
        return out

    def reset_accounting(self) -> None:
        with self._lock:
            self.transfers.clear()
            self.bytes_moved = 0.0
            self.bytes_local = 0.0
            self.remote_bytes = 0.0
            self.bytes_demoted = 0.0
            self.demotions = 0
            self.promotions = 0
            self.bytes_promoted = 0.0
            self.migrations = 0
            self.tier_reads.clear()
            self.writebacks = 0
            self.writeback_bytes = 0.0
            self.clean_drops = 0
            self.bytes_clean_dropped = 0.0
            self.coord_drops = 0
            self.bytes_coord_dropped = 0.0
            self.pin_protected_evictions = 0
            self.fsyncs = 0
            self.fsync_bytes = 0.0
            self.phantom_durable = 0
            self.rereplications = 0
            self.bytes_rereplicated = 0.0
