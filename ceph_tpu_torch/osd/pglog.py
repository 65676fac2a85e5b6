"""PG log: per-OSD sequence-numbered op log powering delta peering and
divergent-entry rollback.

Port of ``ceph_tpu/osd/pglog.py``.

Reference: src/osd/PGLog.{h,cc} and the EC rollback design
(doc/dev/osd_internals/erasure_coding/ecbackend.rst:9-27, ECSubWrite
trim_to/roll_forward_to ECMsgTypes.h:33-35).  Two roles:

* **Delta peering** (the GetLog/missing-set exchange of src/osd/PG.cc):
  every applied sub-write gets a per-OSD monotonic sequence number; a
  primary remembers the last sequence it processed per peer and fetches
  only ``entries_after(watermark)`` -- peering traffic proportional to
  new writes, zero on a clean cluster.  A watermark below ``tail_seq``
  means the log was trimmed past the gap: the peer must be backfilled
  (full scan), the reference's log-vs-backfill distinction.

* **Rollback** (divergent entries): each entry snapshots the pre-apply
  state (size, version/size/hash attrs, existence) of the shard object.
  EC writes are creates/appends in the default append-only mode, so a
  torn write (landed on < k shards) rolls back locally by truncating and
  restoring attrs -- no network push needed.  Overwrite-style entries
  (bytes below the prior size modified) are marked non-rollbackable and
  fall back to a recovery push from the authoritative shards.

* **Reqid dup detection** (the pg_log_dup_t role, src/osd/osd_types.h):
  every applied client op records its reqid ``(client, incarnation,
  tid)`` and client-visible result as a dup entry.  A resent op whose
  reqid is already recorded is answered with the original result
  instead of re-executing -- the exactly-once guarantee across primary
  failover.  Dups live OUTSIDE the entry list: ``trim()`` never drops
  them (the reference keeps a separate dups list past log trim,
  bounded by ``osd_pg_log_dups_tracked``); divergent-entry rollback
  prunes the dups of the rolled-back versions so a torn write's replay
  re-executes instead of reporting a success that was undone.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional

from ceph_tpu_torch.osd.types import Transaction

#: attr key holding the version tuple in prior_attrs snapshots (matches
#: ecbackend.VERSION_KEY; duplicated to avoid the import cycle)
_VERSION_ATTR = "_version"


@dataclasses.dataclass
class PGLogEntry:
    seq: int  # per-OSD monotonic sequence (assigned by PGLog.append)
    oid: str  # shard object id ("base@shard" or "base@meta")
    op: str  # "write" | "delete"
    obj_version: tuple  # version tuple this entry stamped
    existed: bool = True  # object existed before this entry
    prior_size: int = 0  # rollback point for appends
    prior_attrs: Optional[Dict[str, object]] = None  # pre-apply attr snapshot
    rollbackable: bool = True


@dataclasses.dataclass
class PGLogDup:
    """One replayed-op detection record (pg_log_dup_t role): the reqid
    that stamped a client op, the client-visible result it produced, and
    the object/version it landed on (for rollback pruning)."""

    seq: int  # per-OSD monotonic dup sequence (peering delta exchange)
    reqid: tuple  # (client name, incarnation, tid)
    result: object = None  # wire-encodable client_reply result
    oid: str = ""  # base object id the op mutated
    version: Optional[tuple] = None  # version tuple the op stamped


class PGLog:
    """Ordered per-OSD log with head/tail, delta queries, trim,
    per-object rollback, and the reqid dup registry."""

    def __init__(self, trim_target: int = 1000,
                 dups_tracked: Optional[int] = None):
        self.entries: List[PGLogEntry] = []
        #: newest sequence dropped by trim (entries <= tail_seq are gone)
        self.tail_seq = 0
        self._next_seq = 0
        self.trim_target = trim_target
        #: reqid -> PGLogDup, insertion-ordered for bounded eviction;
        #: NOT touched by trim() (see module docstring)
        self.dups: "OrderedDict[tuple, PGLogDup]" = OrderedDict()
        self._dup_seq = 0
        #: None = read osd_pg_log_dups_tracked per insert (runtime
        #: changes honored); an explicit bound pins it (tests)
        self._dups_tracked = dups_tracked

    @property
    def head_seq(self) -> int:
        return self.entries[-1].seq if self.entries else self._next_seq

    def append(self, oid: str, op: str, obj_version: tuple, *,
               existed: bool = True, prior_size: int = 0,
               prior_attrs: Optional[dict] = None,
               rollbackable: bool = True) -> PGLogEntry:
        self._next_seq += 1
        e = PGLogEntry(
            seq=self._next_seq, oid=oid, op=op, obj_version=obj_version,
            existed=existed, prior_size=prior_size, prior_attrs=prior_attrs,
            rollbackable=rollbackable,
        )
        self.entries.append(e)
        return e

    # -- reqid dup registry (pg_log_dup_t role) ---------------------------

    def _dup_bound(self) -> int:
        if self._dups_tracked is not None:
            return self._dups_tracked
        from ceph_tpu_torch.utils.config import get_config

        return int(get_config().get_val("osd_pg_log_dups_tracked"))

    def record_dup(self, reqid, result=None, *, oid: str = "",
                   version: Optional[tuple] = None) -> PGLogDup:
        """Remember that the op identified by ``reqid`` applied here.
        Idempotent: a reqid seen twice keeps its first record, except a
        None result is upgraded once the full client-visible result is
        known (the sub-op fan-out records before the primary learns the
        final result of e.g. an exec)."""
        reqid = tuple(reqid)
        ent = self.dups.get(reqid)
        if ent is not None:
            if ent.result is None and result is not None:
                ent.result = result
            return ent
        self._dup_seq += 1
        ent = PGLogDup(
            seq=self._dup_seq, reqid=reqid, result=result, oid=oid,
            version=tuple(version) if version is not None else None,
        )
        self.dups[reqid] = ent
        bound = self._dup_bound()
        while len(self.dups) > max(1, bound):
            self.dups.popitem(last=False)  # oldest first
        return ent

    def lookup_dup(self, reqid) -> Optional[PGLogDup]:
        return self.dups.get(tuple(reqid))

    def lookup_dups_batch(self, reqids) -> List[Optional[PGLogDup]]:
        """Batch dup resolution for the OSD's array-batched client-op
        fast path (osd/shard.py): one bound-method fetch + one pass of
        dict gets over the whole batch instead of a ``lookup_dup`` call
        per op.  ``None`` rows (non-dedupable ops) pass through as
        ``None`` misses; semantics per row are exactly
        :meth:`lookup_dup`."""
        get = self.dups.get
        return [None if r is None else get(tuple(r)) for r in reqids]

    @property
    def dup_head_seq(self) -> int:
        return self._dup_seq

    def dups_after(self, seq: int) -> List[PGLogDup]:
        """Dup entries newer than ``seq`` (peering delta exchange; the
        whole registry is bounded, so seq 0 fetches everything)."""
        return [d for d in self.dups.values() if d.seq > seq]

    def merge_dup(self, reqid, result, oid: str,
                  version: Optional[tuple]) -> None:
        """Adopt a peer's dup entry (peering exchange).  The entry gets
        a LOCAL seq -- dup sequences are per-OSD, never forwarded."""
        self.record_dup(reqid, result, oid=oid, version=version)

    # -- delta peering queries --------------------------------------------

    def entries_after(self, seq: int) -> List[PGLogEntry]:
        return [e for e in self.entries if e.seq > seq]

    def covers(self, seq: int) -> bool:
        """True if the log retains every entry above ``seq`` (a primary
        holding watermark ``seq`` can delta-sync; False -> backfill)."""
        return seq >= self.tail_seq

    # -- trim --------------------------------------------------------------

    def trim(self, to_seq: int) -> None:
        """Drop entries <= to_seq (durable everywhere); trimmed entries
        can no longer be rolled back or delta-served
        (reference ECSubWrite.trim_to).  Dup entries are NOT trimmed:
        replay detection must outlive the log window (a client may
        resend long after the write became durable everywhere), so dups
        ride their own osd_pg_log_dups_tracked bound instead."""
        keep = [e for e in self.entries if e.seq > to_seq]
        if len(keep) != len(self.entries):
            self.tail_seq = max(self.tail_seq, to_seq)
            self.entries = keep

    def maybe_trim(self) -> None:
        if len(self.entries) > self.trim_target:
            self.trim(self.entries[-self.trim_target].seq)

    # -- rollback ----------------------------------------------------------

    def object_entries(self, oid: str) -> List[PGLogEntry]:
        return [e for e in self.entries if e.oid == oid]

    def rollback_object_to(self, oid: str, to_version: tuple,
                           store) -> bool:
        """Undo this object's entries newer than ``to_version`` by applying
        their inverses (truncate to prior size, restore attr snapshot,
        remove a rolled-back create).  Returns True on success; False if
        the log cannot prove a clean rollback (missing/trimmed history or
        a non-rollbackable overwrite) -- caller falls back to a recovery
        push.  Reference: PGLog divergent-entry handling via the rollback
        info EC transactions record (src/osd/ECTransaction.cc:97)."""
        to_version = tuple(to_version)
        doomed = [e for e in self.object_entries(oid)
                  if tuple(e.obj_version) > to_version]
        if not doomed or not all(e.rollbackable for e in doomed):
            return False
        # the oldest doomed entry must sit exactly on the rollback target,
        # else history between them was trimmed and the snapshot is wrong
        oldest = min(doomed, key=lambda e: e.seq)
        if oldest.existed:
            prior_ver = (oldest.prior_attrs or {}).get(_VERSION_ATTR)
            if tuple(prior_ver or ()) != to_version:
                return False
        elif to_version != (0, ""):
            # a create entry proves rollback only to NON-EXISTENCE; if the
            # authoritative version is real history this shard never had
            # (it was down for it), only a recovery push can restore it
            return False
        for e in sorted(doomed, key=lambda e: e.seq, reverse=True):
            if not e.existed:
                store.queue_transaction(Transaction().remove(e.oid))
                continue
            txn = Transaction().truncate(e.oid, e.prior_size)
            for key, val in (e.prior_attrs or {}).items():
                txn = txn.setattr(e.oid, key, val)
            store.queue_transaction(txn)
        doomed_ids = {id(e) for e in doomed}
        self.entries = [e for e in self.entries if id(e) not in doomed_ids]
        # the rolled-back versions' dup records must go with them: a
        # replay of an op peering just proved torn has to RE-EXECUTE,
        # not report a success that was undone (the reference prunes
        # divergent entries' dups the same way, src/osd/PGLog.cc)
        base = oid.rpartition("@")[0] or oid
        dead = [
            r for r, d in self.dups.items()
            if d.oid == base and d.version is not None
            and tuple(d.version) > to_version
        ]
        for r in dead:
            del self.dups[r]
        return True
