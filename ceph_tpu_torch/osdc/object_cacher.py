"""ObjectCacher: client-side object data cache.

Port of ``ceph_tpu/osdc/object_cacher.py``, over any backend with
``read_range``/``write_range`` (the port's ``ECCluster.backend``).

Reference: src/osdc/ObjectCacher.{h,cc} -- the buffer cache librbd and
the CephFS client put in front of the Objecter: reads fill
BufferHead-style extents, repeated reads hit memory, writes either
write-through (update cache + RADOS synchronously) or write-back (dirty
extents flushed later); total size is bounded with LRU eviction and
``flush``/``invalidate`` give the consistency hooks (librbd invalidates
on image refresh, the fs client on cap revoke).

The cache is per-object at extent granularity: each object holds a
sorted list of clean/dirty byte extents; reads coalesce hits and fetch
only the holes.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple


class _Extent:
    __slots__ = ("off", "data", "dirty")

    def __init__(self, off: int, data: bytearray, dirty: bool):
        self.off = off
        self.data = data
        self.dirty = dirty

    @property
    def end(self) -> int:
        return self.off + len(self.data)


class ObjectCacher:
    def __init__(self, backend, max_bytes: int = 32 << 20,
                 write_back: bool = False):
        self.backend = backend
        self.max_bytes = max_bytes
        self.write_back = write_back
        #: oid -> sorted extents; OrderedDict is the LRU (move_to_end on
        #: touch, evict from the front)
        self._objects: "OrderedDict[str, List[_Extent]]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    # -- internals ---------------------------------------------------------

    def _touch(self, oid: str) -> List[_Extent]:
        exts = self._objects.setdefault(oid, [])
        self._objects.move_to_end(oid)
        return exts

    def _account(self, delta: int) -> None:
        self._bytes += delta

    async def _evict_to_fit(self) -> None:
        while self._bytes > self.max_bytes and self._objects:
            oid, exts = next(iter(self._objects.items()))
            if any(e.dirty for e in exts):
                await self._flush_object(oid, exts)
            self._account(-sum(len(e.data) for e in exts))
            del self._objects[oid]

    def _insert(self, exts: List[_Extent], off: int, data: bytes,
                dirty: bool) -> None:
        """Merge [off, off+len) into the extent list (new data wins).

        Clean and dirty extents never merge with each other (the
        reference keeps separate clean/dirty BufferHeads): folding a
        clean neighbour into a dirty write would make flush write back
        bytes the client never modified -- write amplification, and a
        lost-update hazard for a shared image."""
        new = _Extent(off, bytearray(data), dirty)
        out: List[_Extent] = []
        self._account(len(data))
        for e in exts:
            if e.dirty == new.dirty:
                if e.end < new.off or e.off > new.end:
                    out.append(e)
                    continue
                # same state, overlap/adjacent: merge (new bytes win)
                if e.off < new.off:
                    head = e.data[: new.off - e.off]
                    merged = _Extent(e.off, bytearray(head) + new.data,
                                     new.dirty)
                    self._account(len(merged.data) - len(new.data))
                    new = merged
                if e.end > new.end:
                    tail = e.data[new.end - e.off:]
                    self._account(len(tail))
                    new.data.extend(tail)
                self._account(-len(e.data))
                continue
            # different clean/dirty state: never merge; trim the old
            # extent around the new bytes (new data wins the overlap)
            if e.end <= new.off or e.off >= new.end:
                out.append(e)
                continue
            if e.off < new.off:
                head = e.data[: new.off - e.off]
                out.append(_Extent(e.off, bytearray(head), e.dirty))
                self._account(len(head))
            if e.end > new.end:
                tail = e.data[new.end - e.off:]
                out.append(_Extent(new.end, bytearray(tail), e.dirty))
                self._account(len(tail))
            self._account(-len(e.data))
        out.append(new)
        out.sort(key=lambda e: e.off)
        exts[:] = out

    # -- read path (ObjectCacher::readx) -----------------------------------

    async def read(self, oid: str, off: int, length: int) -> bytes:
        exts = self._touch(oid)
        out = bytearray(length)
        pos = off
        end = off + length
        holes: List[Tuple[int, int]] = []
        for e in sorted(exts, key=lambda e: e.off):
            if e.end <= pos or e.off >= end:
                continue
            if e.off > pos:
                holes.append((pos, e.off - pos))
            lo, hi = max(pos, e.off), min(end, e.end)
            out[lo - off:hi - off] = e.data[lo - e.off:hi - e.off]
            self.hits += 1
            pos = hi
        if pos < end:
            holes.append((pos, end - pos))
        for h_off, h_len in holes:
            self.misses += 1
            data = await self.backend.read_range(oid, h_off, h_len)
            data = data.ljust(h_len, b"\0")  # short read: zeros
            out[h_off - off:h_off - off + h_len] = data
            self._insert(exts, h_off, data, dirty=False)
        await self._evict_to_fit()
        return bytes(out)

    # -- write path (writex: write-through or write-back) ------------------

    async def write(self, oid: str, off: int, data: bytes) -> None:
        exts = self._touch(oid)
        self._insert(exts, off, data, dirty=self.write_back)
        if not self.write_back:
            await self.backend.write_range(oid, off, data)
        await self._evict_to_fit()

    # -- consistency hooks -------------------------------------------------

    async def _flush_object(self, oid: str, exts: List[_Extent]) -> None:
        for e in exts:
            if e.dirty:
                await self.backend.write_range(oid, e.off, bytes(e.data))
                e.dirty = False

    async def flush(self, oid: Optional[str] = None) -> None:
        """Write every dirty extent back (ObjectCacher::flush_set)."""
        targets = [oid] if oid is not None else list(self._objects)
        for o in targets:
            exts = self._objects.get(o)
            if exts:
                await self._flush_object(o, exts)

    async def invalidate(self, oid: Optional[str] = None) -> None:
        """Drop cached extents (dirty ones are flushed first -- the
        librbd invalidate-on-refresh contract)."""
        await self.flush(oid)
        targets = [oid] if oid is not None else list(self._objects)
        for o in targets:
            exts = self._objects.pop(o, None)
            if exts:
                self._account(-sum(len(e.data) for e in exts))

    @property
    def cached_bytes(self) -> int:
        return self._bytes
