"""A model of PyTorch's CUDA caching allocator, to replay a step's
allocations (recorded on meta tensors by ``launch.op_analysis``) and read
the peaks a card would report.

The dry run counts the bytes of the storages alive at once. A card's
allocator holds more: it rounds every request up, serves it from the
smallest cached block that fits (splitting it only where enough is left
over), and keeps freed blocks cached instead of returning them. This
module follows ``c10/cuda/CUDACachingAllocator.cpp`` with its default
settings (one stream, no ``max_split_size``, no expandable segments, no
power-of-two rounding):

  * a request is rounded up to a multiple of 512 bytes (512 at least);
  * requests of at most 1 MiB come from the small pool, larger ones from
    the large pool;
  * a request takes the smallest free block of its pool that is large
    enough (the lowest address among equal sizes);
  * without one, a new segment is reserved: 2 MiB for a small request,
    20 MiB for a large one under 10 MiB, else the request rounded up to
    2 MiB;
  * a block is split where the rest is at least 512 bytes (small pool) or
    more than 1 MiB (large pool); else the whole block is allocated, and
    counts as allocated;
  * a freed block merges with free neighbours in its segment and stays
    cached: reserved memory only grows.

``allocated`` is what ``torch.cuda.max_memory_allocated`` reads (the sizes
of the allocated blocks), ``reserved`` what ``max_memory_reserved`` reads
(the segments).
"""

from __future__ import annotations

import bisect
import dataclasses

MIN_BLOCK = 512
SMALL_SIZE = 1 << 20            # largest request of the small pool
SMALL_BUFFER = 2 << 20          # a small pool's segment
LARGE_BUFFER = 20 << 20         # a large pool's segment for requests < 10 MiB
MIN_LARGE_ALLOC = 10 << 20
ROUND_LARGE = 2 << 20


def round_size(n: int) -> int:
    """A request's size as the allocator rounds it."""
    return MIN_BLOCK if n < MIN_BLOCK else -(-n // MIN_BLOCK) * MIN_BLOCK


def segment_size(n: int) -> int:
    """The segment reserved for a rounded request ``n`` no cached block
    fits."""
    if n <= SMALL_SIZE:
        return SMALL_BUFFER
    if n < MIN_LARGE_ALLOC:
        return LARGE_BUFFER
    return -(-n // ROUND_LARGE) * ROUND_LARGE


@dataclasses.dataclass
class _Block:
    addr: int
    size: int
    segment: int
    small: bool
    free: bool = True


class CachingAllocator:
    """The allocator's state: ``malloc(key, nbytes)`` and ``free(key)``
    replay one allocation and one free; ``allocated`` / ``reserved`` and
    their peaks ``peak_allocated`` / ``peak_reserved`` are in bytes."""

    def __init__(self) -> None:
        self.pools: dict[bool, list[tuple[int, int]]] = {True: [],
                                                          False: []}
        self.at: dict[int, _Block] = {}          # block by start address
        self.ends: dict[int, _Block] = {}        # block by end address
        self.live: dict = {}                     # key -> allocated block
        self.allocated = self.reserved = 0
        self.peak_allocated = self.peak_reserved = 0
        self._top = 0                            # next segment's address
        self._segments = 0

    def _insert(self, b: _Block) -> None:
        b.free = True
        self.at[b.addr], self.ends[b.addr + b.size] = b, b
        bisect.insort(self.pools[b.small], (b.size, b.addr))

    def _take(self, b: _Block) -> None:
        pool = self.pools[b.small]
        del pool[bisect.bisect_left(pool, (b.size, b.addr))]

    def _forget(self, b: _Block) -> None:
        del self.at[b.addr], self.ends[b.addr + b.size]

    def malloc(self, key, nbytes: int) -> None:
        if nbytes <= 0:
            return                               # no block for 0 bytes
        size = round_size(nbytes)
        small = size <= SMALL_SIZE
        pool = self.pools[small]
        i = bisect.bisect_left(pool, (size, -1))
        if i < len(pool):
            b = self.at[pool[i][1]]
            self._take(b)
        else:                                    # a new segment
            seg = segment_size(size)
            b = _Block(self._top, seg, self._segments, small)
            self._top += seg + SMALL_BUFFER      # segments never touch
            self._segments += 1
            self.at[b.addr], self.ends[b.addr + seg] = b, b
            self.reserved += seg
            self.peak_reserved = max(self.peak_reserved, self.reserved)
        rest = b.size - size
        if (rest >= MIN_BLOCK) if small else (rest > SMALL_SIZE):
            self._forget(b)
            tail = _Block(b.addr + size, rest, b.segment, small)
            b = _Block(b.addr, size, b.segment, small)
            self.at[b.addr], self.ends[b.addr + size] = b, b
            self._insert(tail)
        b.free = False
        self.live[key] = b
        self.allocated += b.size
        self.peak_allocated = max(self.peak_allocated, self.allocated)

    def free(self, key) -> None:
        b = self.live.pop(key, None)
        if b is None:
            return
        self.allocated -= b.size
        self._forget(b)
        addr, size = b.addr, b.size
        nxt = self.at.get(addr + size)
        if nxt is not None and nxt.free and nxt.segment == b.segment:
            self._take(nxt)
            self._forget(nxt)
            size += nxt.size
        prv = self.ends.get(addr)
        if prv is not None and prv.free and prv.segment == b.segment:
            self._take(prv)
            self._forget(prv)
            addr, size = prv.addr, size + prv.size
        self._insert(_Block(addr, size, b.segment, b.small))


def replay(events, held=()) -> dict[str, int]:
    """Peaks of the allocator after allocating ``held`` (byte sizes, kept
    throughout: the step's arguments) and replaying ``events``: ``("a",
    key, nbytes)`` an allocation, ``("f", key)`` a free."""
    a = CachingAllocator()
    for i, n in enumerate(held):
        a.malloc(("held", i), n)
    for ev in events:
        if ev[0] == "a":
            a.malloc(ev[1], ev[2])
        else:
            a.free(ev[1])
    return {"peak_allocated": a.peak_allocated,
            "peak_reserved": a.peak_reserved}
