"""Incremental per-PG statistics (the pg_stat_t / PGMap-feed role).

Port of ``ceph_tpu/osd/pg_stats.py``.

Reference: src/osd/osd_types.h pg_stat_t -- every PG maintains its
object/degraded/misplaced counts and state bits *where the events
happen* (apply, peering, recovery completion) and ships them to the mgr
in MPGStats; nobody ever walks the object store to answer ``ceph -s``.

The seed's ``ClusterState.degraded_objects()`` did exactly that walk --
O(objects x shards) per prometheus scrape.  This tracker replaces it:

* **mutation seams** -- a write that missed a down shard already adds
  the oid to the engine's ``_dirty`` set (pg.py); dirty objects ARE
  degraded objects, so no extra bookkeeping is needed there;
* **liveness seams** -- the cluster harness marks a killed/wiped OSD's
  former holdings as down-victims (``note_down_victims``) once per
  event, with the reason recorded so a revive clears exactly what the
  kill caused;
* **peering** -- ``note_recovering`` marks the pass's action objects
  while they rebuild (``_peering_apply``), ``note_backfilling`` brackets
  the full-scan path, and ``end_pass`` drops every tracked object that
  finished the pass clean;
* **recovery completions** -- the batched plane (osd/recovery.py) and
  the per-object windowed path call ``note_recovered`` per object, so
  the degraded count *drains monotonically* while a rebuild runs -- the
  signal the chaos health gate asserts.

``degraded_oids()`` is the union of those sources; computing it is
O(degraded), never O(objects).  ``pg_stat()`` renders the ceph-style
state-bit string for the report frame.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Set


class PGStats:
    """Incremental stats for one hosted (pool, primary-engine) slice."""

    def __init__(self, backend):
        self._backend = backend
        #: oid -> liveness reasons ("osd.3", "wipe:osd.1") that made it
        #: degraded; cleared per-reason on revive, per-oid on a clean
        #: peering pass
        self._down_victims: Dict[str, Set[str]] = {}
        #: liveness events noted so far, and oid -> the event that last
        #: marked it: a peering pass clears only what was marked before
        #: it began (its view of the stores predates later events)
        self.events = 0
        self._victim_event: Dict[str, int] = {}
        #: objects a running peering pass is actively rebuilding
        self._recovering: Set[str] = set()
        #: objects whose data exists but (at least partly) on
        #: non-acting holders -- remap leftovers awaiting backfill
        self.misplaced: Set[str] = set()
        #: the full-scan (backfill) peering path is in flight
        self.backfilling = False

    # -- event seams -------------------------------------------------------

    def note_down_victims(self, reason: str, oids: Iterable[str]) -> None:
        """A liveness event (kill/wipe/out) cost these objects a copy."""
        self.events += 1
        for oid in oids:
            self._down_victims.setdefault(oid, set()).add(reason)
            self._victim_event[oid] = self.events

    def clear_down_reason(self, reason: str) -> None:
        """The event was undone (revive): drop exactly its markings."""
        for oid in list(self._down_victims):
            reasons = self._down_victims[oid]
            reasons.discard(reason)
            if not reasons:
                del self._down_victims[oid]
                self._victim_event.pop(oid, None)

    def note_recovering(self, oids: Iterable[str]) -> None:
        self._recovering.update(oids)

    def note_recovered(self, oid: str) -> None:
        """One object's rebuild completed: the draining tick."""
        self._recovering.discard(oid)
        self._down_victims.pop(oid, None)
        self._victim_event.pop(oid, None)
        self.misplaced.discard(oid)

    def end_pass(self, tracked: Iterable[str],
                 still_dirty: Iterable[str],
                 since: Optional[int] = None) -> None:
        """Peering-pass epilogue, mirroring the engine's dirty-set
        maintenance: tracked objects that ended the pass clean drop
        every degraded marking; unfinished ones stay.  ``since`` is
        ``events`` when the pass began: a victim marked by a later event
        stays, because the pass saw the stores before that event."""
        dirty = set(still_dirty)
        for oid in tracked:
            if oid not in dirty:
                if since is None or self._victim_event.get(oid, 0) <= since:
                    self._down_victims.pop(oid, None)
                    self._victim_event.pop(oid, None)
                self.misplaced.discard(oid)
            self._recovering.discard(oid)

    # -- read side ---------------------------------------------------------

    def degraded_oids(self) -> Set[str]:
        """Objects currently degraded from this primary's view: the
        engine's dirty sets (writes that missed shards, pending
        recoveries) + liveness victims + in-flight rebuilds."""
        b = self._backend
        return (set(self._down_victims) | self._recovering
                | b._dirty | b._dirty_meta)

    def degraded_count(self) -> int:
        return len(self.degraded_oids())

    def state_bits(self) -> list:
        """ceph-style PG state bits for this slice."""
        b = self._backend
        shard = getattr(b, "_host_shard", None)
        bits = []
        pool = b.pool_name
        if shard is not None and \
                shard.pg_states.get(pool) == "peering":
            bits.append("peering")
        else:
            bits.append("active")
        undersized = any(
            b.messenger.is_down(f"osd.{i}") for i in range(len(b.osds))
        )
        if undersized:
            bits.append("undersized")
        if self.degraded_count():
            bits.append("degraded")
        if self.misplaced:
            bits.append("remapped")
        if self.backfilling:
            bits.append("backfilling")
        elif self._recovering:
            bits.append("recovering")
        if not bits[1:] and bits[0] == "active":
            bits.append("clean")
        return bits

    def pg_stat(self) -> dict:
        """The per-PG slice of a MgrReport frame (value()-encodable)."""
        return {
            "state": "+".join(self.state_bits()),
            "degraded": self.degraded_count(),
            "misplaced": len(self.misplaced),
            "recovering": len(self._recovering),
            "scrub_errors": len(self._backend.scrub_errors),
        }
