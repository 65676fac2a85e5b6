"""RBD object map + fast-diff (reference src/librbd/ObjectMap.cc,
src/cls/rbd/cls_rbd.cc object_map_* ops).

Port of ``ceph_tpu/rbd/objectmap.py``.

The object map tracks one state per data object of an image so the I/O
and diff paths can answer "does block N exist / did it change?" without
a round trip per object -- the feature that makes snapshots, clones and
mirroring cheap at scale.  States follow the reference's constants:

* ``OBJECT_NONEXISTENT`` (0) -- no data object;
* ``OBJECT_EXISTS`` (1) -- exists and was modified since the last
  snapshot (the fast-diff "dirty" state);
* ``OBJECT_PENDING`` (2) -- reserved (in-flight delete in the
  reference; unused here);
* ``OBJECT_EXISTS_CLEAN`` (3) -- exists, unmodified since the last
  snapshot (fast-diff).

Storage reduction (documented): one byte per object in a plain RADOS
object ``rbd_object_map.<image>[.<snap_id>]`` instead of the reference's
2-bit packing + cls-side update ops.  Semantics -- head map maintained
by the write path, a frozen per-snapshot copy taken at snap_create
BEFORE the dirty->clean sweep (so each snapshot map's EXISTS set is
exactly "modified since the previous snapshot", which is what fast-diff
unions) -- match the reference.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

OBJECT_NONEXISTENT = 0
OBJECT_EXISTS = 1
OBJECT_PENDING = 2
OBJECT_EXISTS_CLEAN = 3

FEATURE_OBJECT_MAP = "object-map"
FEATURE_FAST_DIFF = "fast-diff"


def map_oid(name: str, snap_id: Optional[int] = None) -> str:
    base = f"rbd_object_map.{name}"
    return f"{base}.{snap_id}" if snap_id is not None else base


class ObjectMap:
    """One image's (or one snapshot's) object-state map."""

    def __init__(self, backend, name: str,
                 snap_id: Optional[int] = None):
        self.backend = backend
        self.oid = map_oid(name, snap_id)
        self.states = bytearray()

    async def load(self, n_objects: int) -> None:
        try:
            raw = await self.backend.read(self.oid)
        except (FileNotFoundError, IOError):
            raw = b""
        self.states = bytearray(raw[:n_objects])
        if len(self.states) < n_objects:
            self.states += bytes(n_objects - len(self.states))

    async def save(self) -> None:
        """Full rewrite (resize / rebuild / snapshot sweep)."""
        await self.backend.write(self.oid, bytes(self.states))

    async def remove(self) -> None:
        try:
            await self.backend.remove_object(self.oid)
        except (FileNotFoundError, IOError):
            pass

    def state(self, object_no: int) -> int:
        if object_no >= len(self.states):
            return OBJECT_NONEXISTENT
        return self.states[object_no]

    def exists(self, object_no: int) -> bool:
        return self.state(object_no) in (OBJECT_EXISTS, OBJECT_EXISTS_CLEAN)

    async def update(self, object_no: int, state: int) -> None:
        """Point update, persisted only on a real transition (the steady
        state -- rewriting an already-EXISTS object -- costs nothing,
        the reference's ObjectMap::aio_update fast path)."""
        if object_no >= len(self.states):
            self.states += bytes(object_no + 1 - len(self.states))
        if self.states[object_no] == state:
            return
        self.states[object_no] = state
        await self.backend.write_range(
            self.oid, object_no, bytes([state]))

    def dirty_objects(self) -> List[int]:
        """Objects modified since the last snapshot (fast-diff)."""
        return [o for o, s in enumerate(self.states) if s == OBJECT_EXISTS]

    async def snapshot_to(self, snap_id: int) -> "ObjectMap":
        """Freeze the current state as the snapshot's map, then sweep
        EXISTS -> EXISTS_CLEAN in this (head) map -- the reference's
        object_map_snap_add + rbd::object_map::SnapshotCreateRequest."""
        name = self.oid[len("rbd_object_map."):]
        snap_map = ObjectMap(self.backend, name, snap_id)
        snap_map.states = bytearray(self.states)
        await snap_map.save()
        changed = False
        for o, s in enumerate(self.states):
            if s == OBJECT_EXISTS:
                self.states[o] = OBJECT_EXISTS_CLEAN
                changed = True
        if changed:
            await self.save()
        return snap_map

    async def resize(self, n_objects: int) -> None:
        if n_objects < len(self.states):
            self.states = self.states[:n_objects]
            await self.save()
        elif n_objects > len(self.states):
            self.states += bytes(n_objects - len(self.states))
            await self.save()


async def rebuild(backend, name: str, n_objects: int,
                  data_oid_fn) -> ObjectMap:
    """Reconstruct the head map by statting every data object (feature
    enable on an existing image / repair after out-of-band writes --
    the rbd_object_map_rebuild role, reference
    src/librbd/object_map/RebuildRequest.cc)."""
    m = ObjectMap(backend, name)
    m.states = bytearray(n_objects)
    for object_no in range(n_objects):
        try:
            size, hinfo = await backend.stat(data_oid_fn(object_no))
            present = not (size == 0 and hinfo is None)
        except (FileNotFoundError, IOError):
            present = False
        m.states[object_no] = OBJECT_EXISTS if present else OBJECT_NONEXISTENT
    await m.save()
    return m


async def fast_diff(backend, name: str, snaps: dict, head_map: ObjectMap,
                    object_size: int, image_size: int,
                    from_snap: Optional[str] = None,
                    ) -> List[Tuple[int, int, bool]]:
    """Changed extents since ``from_snap`` (None = since creation) from
    the object maps alone -- no data reads (the fast-diff promise;
    reference diff_iterate whole_object path over object map states).

    Returns [(offset, length, exists), ...] per changed object, where
    ``exists`` False marks an object deleted since the snapshot."""
    if from_snap is not None and from_snap not in snaps:
        raise FileNotFoundError(from_snap)
    from_id = snaps[from_snap]["id"] if from_snap is not None else 0

    async def read_map(snap_id):
        try:
            return await backend.read(map_oid(name, snap_id))
        except (FileNotFoundError, IOError):
            return b""

    changed = set()
    # each later snapshot map's EXISTS set = modified in its interval
    for ent in snaps.values():
        if ent["id"] <= from_id:
            continue
        for o, s in enumerate(await read_map(ent["id"])):
            if s == OBJECT_EXISTS:
                changed.add(o)
    changed.update(head_map.dirty_objects())
    if from_snap is None:
        # diff from empty: every currently-existing object counts
        for o in range(len(head_map.states)):
            if head_map.exists(o):
                changed.add(o)
        from_exists = {}
    else:
        raw = await read_map(from_id)
        from_exists = {
            o: s in (OBJECT_EXISTS, OBJECT_EXISTS_CLEAN)
            for o, s in enumerate(raw)
        }
        # existence flips (created/deleted across the span)
        for o in range(max(len(raw), len(head_map.states))):
            if head_map.exists(o) != from_exists.get(o, False):
                changed.add(o)
    out = []
    for o in sorted(changed):
        off = o * object_size
        exists = head_map.exists(o)
        if exists:
            if off >= image_size:
                continue  # map tail beyond the shrunk image
            length = min(object_size, image_size - off)
        else:
            length = object_size  # deleted block: its former span
        out.append((off, length, exists))
    return out
