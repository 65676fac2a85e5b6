"""In-flight write extent cache (ExtentCache equivalent).

Port of ``ceph_tpu/osd/extent_cache.py``.

Reference: src/osd/ExtentCache.h (491 LoC).  During an EC read-modify-write
the primary pins the logical extents a write op will touch; ops whose
extents overlap an in-flight pin must wait for it to release, and RMW reads
of recently written extents are served from the primary's cache instead of
re-reading shards.  Two roles here:

* ``pin(oid, start, end)`` — async context manager serializing overlapping
  writes per object (the reference defers conflicting ops on the pinned
  extent set);
* a bounded read-through cache of committed logical bytes, consulted by
  the RMW read so a write immediately following another does not fan out a
  shard read for data the primary just encoded.

All writes flow through the primary, so the cache is coherent by
construction; killing/recovering OSDs never bypasses it.
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional, Tuple


class _ObjectState:
    def __init__(self) -> None:
        #: active pins as (start, end) half-open logical intervals
        self.pins: List[Tuple[int, int]] = []
        self.cond: Optional[asyncio.Condition] = None
        #: coroutines blocked in cond.wait() — idle state (no pins, no
        #: waiters, no cached bytes) is pruned so the per-oid dict does not
        #: grow without bound over a cluster's lifetime
        self.waiters = 0
        #: committed cache: sorted non-overlapping (start, bytes)
        self.extents: List[Tuple[int, bytes]] = []

    def idle(self) -> bool:
        return not self.pins and self.waiters == 0 and not self.extents

    def condition(self) -> asyncio.Condition:
        if self.cond is None:
            self.cond = asyncio.Condition()
        return self.cond


class _Pin:
    def __init__(self, cache: "ExtentCache", oid: str, start: int, end: int):
        self._cache = cache
        self._oid = oid
        self._span = (start, end)

    async def __aenter__(self) -> "_Pin":
        await self._cache._acquire(self._oid, self._span)
        return self

    async def __aexit__(self, *exc) -> bool:
        await self._cache._release(self._oid, self._span)
        return False

    def commit(self, offset: int, data: bytes) -> None:
        """Publish the written logical bytes to the read-through cache."""
        self._cache._insert(self._oid, offset, data)


class ExtentCache:
    def __init__(self, max_object_bytes: int = 4 << 20,
                 max_cached_objects: int = 256):
        self._objects: Dict[str, _ObjectState] = {}
        self.max_object_bytes = max_object_bytes
        self.max_cached_objects = max_cached_objects
        self.hits = 0
        self.misses = 0

    def _state(self, oid: str) -> _ObjectState:
        if oid not in self._objects:
            self._objects[oid] = _ObjectState()
        return self._objects[oid]

    # -- pinning (write-write serialization) --------------------------------

    def pin(self, oid: str, start: int, end: int) -> _Pin:
        return _Pin(self, oid, start, end)

    @staticmethod
    def _overlaps(a: Tuple[int, int], b: Tuple[int, int]) -> bool:
        return a[0] < b[1] and b[0] < a[1]

    async def _acquire(self, oid: str, span: Tuple[int, int]) -> None:
        st = self._state(oid)
        cond = st.condition()
        try:
            async with cond:
                while any(self._overlaps(span, p) for p in st.pins):
                    st.waiters += 1
                    try:
                        await cond.wait()
                    finally:
                        st.waiters -= 1
                st.pins.append(span)
        except BaseException:
            # a cancelled waiter may be the last reference to this state
            if st.idle() and self._objects.get(oid) is st:
                self._objects.pop(oid, None)
            raise

    async def _release(self, oid: str, span: Tuple[int, int]) -> None:
        st = self._state(oid)
        st.pins.remove(span)
        cond = st.condition()
        async with cond:
            cond.notify_all()
        # woken waiters still count in st.waiters until they resume, so
        # this only fires once the object is truly quiescent
        if st.idle():
            self._objects.pop(oid, None)

    # -- committed-byte cache ----------------------------------------------

    def _insert(self, oid: str, offset: int, data: bytes) -> None:
        st = self._state(oid)
        end = offset + len(data)
        merged: List[Tuple[int, bytes]] = []
        for s, buf in st.extents:
            e = s + len(buf)
            if e <= offset or s >= end:
                merged.append((s, buf))
                continue
            # trim the old extent around the new write (newest wins)
            if s < offset:
                merged.append((s, buf[: offset - s]))
            if e > end:
                merged.append((end, buf[end - s :]))
        merged.append((offset, bytes(data)))
        merged.sort()
        # bound memory: drop lowest-offset extents beyond the cap
        total = sum(len(b) for _, b in merged)
        while merged and total > self.max_object_bytes:
            s, b = merged.pop(0)
            total -= len(b)
        st.extents = merged
        # bound the object population too: evict other objects' cached
        # bytes LRU-ish (pin state is kept — only cache memory is freed)
        cached = [o for o, s in self._objects.items() if s.extents and o != oid]
        while len(cached) + 1 > self.max_cached_objects:
            victim = cached.pop(0)
            vs = self._objects[victim]
            vs.extents = []
            if vs.idle():
                self._objects.pop(victim, None)

    def get(self, oid: str, offset: int, length: int) -> Optional[bytes]:
        """The cached bytes for [offset, offset+length) iff fully covered
        by one committed extent; None on any gap."""
        st = self._objects.get(oid)
        if st is None:
            self.misses += 1
            return None
        end = offset + length
        for s, buf in st.extents:
            if s <= offset and s + len(buf) >= end:
                self.hits += 1
                return buf[offset - s : end - s]
        self.misses += 1
        return None

    def invalidate(self, oid: str) -> None:
        """Drop cached bytes only — active pin/waiter state must survive
        (popping the whole object state would orphan in-flight pins and
        break overlap serialization)."""
        st = self._objects.get(oid)
        if st is not None:
            st.extents = []
            if st.idle():
                self._objects.pop(oid, None)
