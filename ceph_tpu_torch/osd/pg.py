"""PG-generic primary engine: the machinery every pool type shares.

Port of ``ceph_tpu/osd/pg.py``.

Reference layering: src/osd/PG.{h,cc} (peering, log, scrub scheduling,
snapshot bookkeeping) + src/osd/PrimaryLogPG.cc (client-op execution,
make_writeable, find_object_context) + the PGBackend seam
(src/osd/PGBackend.h:1, built per pool type by build_pg_backend,
src/osd/PGBackend.cc:533-570).  The storage *strategy* -- how object
bytes map onto per-OSD shard objects -- lives in the subclasses:

* ``ceph_tpu_torch.osd.ecbackend.ECBackend`` -- k+m erasure-coded chunks
  (reference src/osd/ECBackend.cc);
* ``ceph_tpu_torch.osd.replicated.ReplicatedBackend`` -- full copies on
  every acting replica (reference src/osd/ReplicatedBackend.cc).

Strategy hooks a subclass must provide (the PGBackend virtuals):

* ``_write_pinned(oid, data, snapc)`` -- full-object write fan-out;
* ``_write_range_pinned(oid, offset, data, pin, snapc)`` -- extent write;
* ``_pin_bounds(offset, length)`` -- extent-cache pin span for the above;
* ``read(oid)`` / ``read_range(oid, off, len)`` -- read paths;
* ``_min_sources(want_shards, up_shards)`` -- recovery source set;
* ``_rebuild_shard(chunks, shard)`` -- reconstruct one shard's bytes;
* ``_shard_bytes_total(logical_size)`` -- stored bytes per shard object;
* ``_scrub_verify(chunks, report)`` -- cross-shard consistency check;
* ``_destroy_object(oid, up, acting)`` -- plain (snap-less) removal.

plus the sizing attributes ``k`` (shards needed to assemble a version),
``km`` (placed positions), ``m`` (= km - k), ``min_size`` (write quorum
floor) and ``sinfo`` (stripe algebra; identity for replicated pools).
"""

from __future__ import annotations

import asyncio
import contextvars
import time
from contextlib import asynccontextmanager
from typing import Dict, List, Optional, Tuple

import numpy as np

from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.osd.messenger import Messenger
from ceph_tpu_torch.osd.types import (
    ECSubRead,
    ECSubReadReply,
    ECSubWrite,
    ECSubWriteReply,
    LogEntry,
    Transaction,
)
from ceph_tpu_torch.utils import trace
from ceph_tpu_torch.utils.perf import PerfCounters, stage_histogram
from ceph_tpu_torch.utils.unported import refuse

SIZE_KEY = "_size"
#: per-shard object version xattr (the object_info_t version role): every
#: write stamps it, reads drop shards whose version lags the newest seen,
#: so a shard that missed updates while down can never contribute a stale
#: chunk to a decode (the PG-log/peering consistency guarantee, reduced
#: to a read-time check)
VERSION_KEY = "_version"
#: per-object snapshot set xattr (the SnapSet role, src/osd/osd_types.h):
#: {"seq": newest snap context seen, "clones": [{"id", "size"}, ...]}
SNAPSET_KEY = "_snapset"
#: head deleted under a snap context but clones survive (the snapdir
#: object role, src/osd/PrimaryLogPG.cc)
WHITEOUT_KEY = "_whiteout"
#: pool-membership tag: multiple pools share one OSD's flat store (the
#: reference separates them by PG collection, pgid embedding the pool id,
#: src/osd/osd_types.h spg_t) -- the tag keeps one pool's scrub/peering
#: from "repairing" another pool's objects.  Absent on legacy/standalone
#: writes, which only exist in single-pool clusters.
POOL_KEY = "_pool"


def shard_oid(oid: str, shard: int) -> str:
    return f"{oid}@{shard}"


def snap_oid(oid: str, clone_id: int) -> str:
    """Clone object name; '~' is reserved so clones co-place with their
    head (placement strips the suffix, mirroring how the reference keeps
    clones in the head's PG via the ghobject snap field)."""
    return f"{oid}~{clone_id}"


def vt(v) -> tuple:
    """Order object/metadata versions.  Stored/wire form is
    ``(counter, writer)`` (legacy plain ints order as writer "").  The
    writer name breaks ties when two primaries race to the same counter:
    every shard/replica then picks the SAME winner and two writes can
    never share a version, so a read-time consistent cut cannot mix
    chunks from different writes (the role the reference gets from one
    primary OSD serializing the PG, src/osd/ECBackend.h:522-573)."""
    if v is None:
        return (0, "")
    if isinstance(v, int):
        return (v, "")
    return (v[0], v[1])


#: backward-compatible name (the metadata plane used this first)
meta_vt = vt


#: osd_client_op_priority / osd_recovery_op_priority defaults
OP_PRIORITY = {"client": 63, "recovery": 10, "scrub": 5}

#: client-op kinds whose OWN fan-out (sub-writes / meta applies) carries
#: the op's reqid, so every applying replica records the dup entry in
#: the same step as the mutation -- a zero-width dup-detection window.
#: These are exactly the kinds whose client-visible result is None or
#: rides the fan-out itself (omap_cas piggybacks its result on the
#: replication meta_apply).  ``exec`` and ``snap_trim`` compose several
#: internal mutations with a result known only at the end; their dups
#: are recorded by an explicit awaited ``dup_record`` fan-out instead
#: (see OSDShard._run_client_op_inner), so their internals stay
#: reqid-free -- an internal sub-op's dup must never masquerade as the
#: composite op's result.
REQID_FANOUT_KINDS = frozenset({
    "write", "write_range", "remove", "snap_rollback",
    "omap_set", "omap_rm", "omap_clear", "omap_cas",
})

#: the in-flight client op's reqid, visible to the fan-out helpers of
#: THIS task only (client ops run as separate tasks; contextvars keep
#: concurrent ops' reqids apart without threading a parameter through
#: every strategy signature)
_OP_REQID: "contextvars.ContextVar[Optional[tuple]]" = \
    contextvars.ContextVar("ceph_tpu_op_reqid", default=None)

#: the in-flight client op's QoS sub-class (gold/bulk/... from the
#: Objecter's qos_class; docs/qos.md), stamped onto the op's own
#: sub-ops so RECEIVING shards queue them under the same class --
#: end-to-end reservations need the replica hop, not just the
#: primary's admission, to honor the tags
_OP_QOS: "contextvars.ContextVar[Optional[str]]" = \
    contextvars.ContextVar("ceph_tpu_op_qos", default=None)

#: mclock_opclass-style defaults: (reservation, weight, limit) items/sec;
#: clients get a floor and most of the weight.  Recovery carries NO hard
#: limit: a degraded cluster must re-reach full
#: redundancy as fast as spare capacity allows (time degraded == the
#: data-loss risk window), so contention control is the 10:1
#: client:recovery weight here plus the primary-side BackgroundThrottle
#: (osd/recovery.py) backing batches off while the client queue is
#: saturated.  Scrub keeps its cap: it is periodic and never urgent.
MCLOCK_DEFAULTS = {
    "client": (1000.0, 100.0, 0.0),
    "recovery": (100.0, 10.0, 0.0),
    "scrub": (50.0, 5.0, 1000.0),
}


class WriteConflict(IOError):
    """A shard refused a client write as stale: a racing primary committed
    a newer version first.  Carries the winning version tuple."""

    def __init__(self, winner: tuple):
        super().__init__(f"write lost to concurrent version {winner}")
        self.winner = winner


class ObjectIncomplete(IOError):
    """The newest observed version might have been acked but cannot
    assemble k chunks from up shards — serving an older version would be a
    read-after-ack consistency violation (the reference's peering would
    block or mark the PG incomplete, src/osd/PG.cc)."""


class PG:
    """Pool-type-agnostic primary engine (hosted inside the primary OSD
    daemon via ``OSDShard.host_pool``, or standalone for race tests).

    Subclasses fill in the storage strategy; everything here -- version
    counters, per-object write serialization, commit-quorum accounting,
    the replicated metadata plane, watch/notify, snapshots, scrub
    scheduling, delta peering and the recovery driver -- is shared so the
    two pool types cannot drift apart (the reason the reference splits
    PG / PGBackend / {Replicated,EC}Backend, src/osd/PG.h:1)."""

    # sizing attributes set by subclasses before PG.__init__ runs:
    k: int
    km: int
    m: int
    min_size: int
    sinfo: ecutil.StripeInfo

    def __init__(
        self,
        osds: List,
        messenger: Messenger,
        name: str = "client",
        placement=None,
        register: bool = True,
        tid_alloc=None,
        perf: Optional[PerfCounters] = None,
    ):
        self.osds = osds
        self.messenger = messenger
        self.name = name
        #: pool this engine serves when hosted (set by OSDShard.host_pool);
        #: stamps every written shard with POOL_KEY and scopes peering
        self.pool_name: Optional[str] = None
        # a hosted engine shares its OSD's counter instance (one daemon,
        # one perf registry entry -- the reference's per-daemon logger)
        self.perf = perf if perf is not None else PerfCounters(name)
        self._tid = 0
        #: co-hosted backends on one OSD share a tid space so replies
        #: forwarded to every pool match exactly one pending op
        self._tid_alloc = tid_alloc
        self._pending: Dict[int, dict] = {}
        if register:
            messenger.register(name, self.dispatch)
        # per-object version counter (pg-log-lite); bounded: entries are
        # evicted LRU and relearned via _stat on the next touch
        from collections import OrderedDict

        self._versions: "OrderedDict[str, int]" = OrderedDict()
        #: high-water mark of every version ever assigned or learned --
        #: survives _versions eviction so the pg-wide counter (the
        #: eversion role) never regresses
        self._version_head = 0
        self.log: List[LogEntry] = []
        # in-flight RMW extent pinning + read-through byte cache
        # (reference src/osd/ExtentCache.h)
        from ceph_tpu_torch.osd.extent_cache import ExtentCache

        self.extent_cache = ExtentCache()
        #: per-object write mutex: version-assignment + fan-out + commit
        #: wait run under it, so writes to one object from this primary
        #: complete in version order (the reference's in-order write
        #: pipeline, ECBackend.h:522-541).  Entries are refcounted and
        #: dropped when uncontended.
        self._oid_locks: Dict[str, asyncio.Lock] = {}
        self._oid_lock_refs: Dict[str, int] = {}
        #: replicated-metadata version sequence per oid (meta plane is
        #: versioned separately from the chunk plane)
        self._meta_versions: Dict[str, int] = {}
        #: oid -> callback for watch/notify events
        self._watch_callbacks: Dict[str, object] = {}
        # CRUSH placement engine (ceph_tpu_torch.osd.placement.CrushPlacement);
        # None falls back to the seeded-permutation CRUSH-lite below.
        self.placement = placement
        #: placement epoch this engine last peered against: a CRUSH
        #: change (osd add/rm/out/reweight) moves acting sets without
        #: writing any pg log, so delta peering alone would never
        #: discover the re-placed (misplaced) objects -- an epoch skew
        #: forces the backfill scan exactly once per map change
        self._placement_epoch = getattr(placement, "epoch", None)
        # -- delta peering state (pg_missing_t / peer_info roles) ----------
        #: last log sequence processed per peer OSD; a peer whose head
        #: equals its watermark contributes zero peering traffic
        self._peer_seq: Dict[str, int] = {}
        #: last reqid-dup sequence fetched per peer OSD (dup sequences
        #: are per-OSD, so the watermark is too); peers whose dup head
        #: matches contribute zero dup traffic
        self._peer_dup_seq: Dict[str, int] = {}
        #: last incarnation nonce seen per peer (OSDShard.boot_id): a
        #: change invalidates both watermarks above -- see peering_pass
        self._peer_boot: Dict[str, str] = {}
        #: the hosting OSD's PGLog (OSDShard.host_pool wires it): where
        #: peering-fetched dup entries are merged so THIS OSD, once
        #: promoted primary, answers replayed ops from the log.  None
        #: for standalone engines (no daemon, no replay surface).
        self._host_pglog = None
        #: objects known to need attention (writes that missed shards,
        #: recoveries pending on down OSDs) -- the pg_missing_t analogue
        self._dirty: set = set()
        #: replicated-metadata objects in the same state
        self._dirty_meta: set = set()
        #: incremental per-PG statistics (pg_stat_t role): degraded /
        #: misplaced / state bits maintained at the mutation, peering
        #: and recovery-completion seams -- what MgrReport frames and
        #: the mgr's ClusterState read instead of scanning stores
        from ceph_tpu_torch.osd.pg_stats import PGStats

        self.pg_stats = PGStats(self)
        #: last inconsistent deep-scrub reports (ScrubStore role);
        #: cleared when a re-scrub comes back clean
        self.scrub_errors: Dict[str, dict] = {}
        #: per-object SnapSet cache learned via _stat:
        #: {"seq", "clones", "exists", "size"}
        self._snapsets: Dict[str, dict] = {}
        # -- device cache tier hookup (ceph_tpu_torch/tier/) ---------------
        #: the hosting OSD's DeviceTierStore (OSDShard.host_pool wires
        #: it; a standalone engine keeps the tier off)
        self._tier = None
        #: per-pool cache mode: "writeback" | "readproxy" | "none"
        #: (flows from the mon's `osd tier cache-mode` via the osdmap,
        #: or ECCluster.set_tier_mode in-process)
        self.tier_mode = "none"
        #: hit-set feeds (late-bound to the hosting OSD's tracker so a
        #: test swapping shard.hitsets is picked up)
        self._hitset_record = None
        self._hitset_temp = None
        #: per-stage latency observers (lazy; shared per daemon name via
        #: perf.stage_histogram): sub-op round-trip wire time, measured
        #: fan-out-send -> commit-ack arrival on this primary
        self._h_wire_rtt = None

    # -- placement (CRUSH-lite) --------------------------------------------

    def acting_set(self, oid: str) -> List[int]:
        """Stable pseudorandom placement of the km shard positions over
        OSDs (full copies for replicated pools ride the same machinery:
        each "shard position" holds a whole copy).

        Clone objects ("oid~<cloneid>") place WITH their head object --
        the suffix is stripped before hashing -- so snapshots live in the
        head's PG exactly like the reference's ghobject snap ids.

        With a CrushPlacement attached this is the real thing: oid -> pg ->
        crush rule over the map (src/crush/mapper.c crush_choose_indep;
        src/osd/OSDMap.cc _pg_to_raw_osds).  The fallback is a
        deterministic permutation seeded by the object name."""
        oid = oid.split("~", 1)[0]
        if self.placement is not None:
            return self.placement.acting(oid)
        from ceph_tpu_torch.osd.placement import fallback_acting

        # stable: down OSDs keep their slot (degraded) until recovery moves
        # the shard, mirroring up/acting set semantics
        return fallback_acting(oid, len(self.osds), self.km)

    def _pool_stamp(self, txn: Transaction, soid: str) -> Transaction:
        """Tag a written shard with its pool so co-hosted pools' scrub and
        peering never claim each other's objects (see POOL_KEY)."""
        if self.pool_name is not None:
            txn.setattr(soid, POOL_KEY, self.pool_name)
        return txn

    def _pool_match(self, tag) -> bool:
        """Does an object tagged ``tag`` belong to this engine's pool?
        Untagged objects (legacy / standalone writes) and un-pooled
        engines accept everything -- the single-pool behavior."""
        return tag is None or self.pool_name is None or tag == self.pool_name

    def _tier_invalidate(self, oid: str) -> None:
        """Drop any device-resident copy of ``oid`` (called by every
        mutation path the tier cannot refresh in place: RMW extents,
        removals, snapset restamps).  No-op without a tier."""
        if self._tier is not None:
            self._tier.invalidate(self.pool_name, oid)

    def _shard_up(self, acting, s: int) -> bool:
        """A shard position is usable iff it mapped (no CRUSH hole) and its
        OSD is not down."""
        return acting[s] is not None and not self.messenger.is_down(
            f"osd.{acting[s]}"
        )

    async def _reconfirm_up(self, acting, up_shards):
        """Probe down-looking acting holders (concurrently, at most once
        per second) and return the refreshed up set.  No-op on
        messengers without a probe (the in-process bus's is_down is
        authoritative).  A genuinely-dead cluster pays one probe round
        per second, not one per read."""
        probe = getattr(self.messenger, "probe", None)
        if probe is None:
            return up_shards
        now = asyncio.get_event_loop().time()
        if now - getattr(self, "_last_reconfirm", 0.0) < 1.0:
            # rate-limit the probe I/O only -- the liveness VIEW must
            # still be recomputed, or an op arriving just after another
            # op's probe round would fail on the stale argument even
            # though that round (or a background reprobe) healed it
            return [s for s in range(self.km)
                    if self._shard_up(acting, s)]
        self._last_reconfirm = now

        async def one(entity):
            try:
                # generous timeout: under host load this process's
                # event loop can stall past a short deadline while the
                # peer is perfectly alive
                await probe(entity, timeout=2.5)
            except TypeError:
                await probe(entity)
            except (OSError, asyncio.TimeoutError):
                pass

        await asyncio.gather(*(
            one(f"osd.{acting[s]}") for s in range(self.km)
            if s not in up_shards and acting[s] is not None
        ))
        return [s for s in range(self.km) if self._shard_up(acting, s)]

    # -- reply plumbing ----------------------------------------------------

    async def dispatch(self, src: str, msg) -> None:
        if isinstance(msg, dict):
            op = msg.get("op")
            if op in ("meta_get_reply", "meta_apply_reply",
                      "omap_cas_reply", "watch_reply", "notify_reply",
                      "pg_list_reply", "pg_log_info_reply",
                      "pg_log_entries_reply", "pg_rollback_reply",
                      "obj_versions_reply", "dup_record_reply",
                      "pg_dups_reply"):
                state = self._pending.get(msg.get("tid"))
                if state is not None:
                    state["replies"][src] = msg
                    state["outstanding"].discard(src)
                    if not state["outstanding"] and not state["done"].done():
                        state["done"].set_result(True)
                return
            if op == "notify_event":
                from ceph_tpu_torch.osd.objecter import deliver_notify_event

                deliver_notify_event(
                    self.messenger, self.name, self._watch_callbacks,
                    src, msg,
                )
                return
            # monitor traffic (command replies, osdmap broadcasts)
            hook = getattr(self, "mon_hook", None)
            if hook is not None:
                await hook(msg)
            return
        if isinstance(msg, ECSubWriteReply):
            state = self._pending.get(msg.tid)
            if state is None:
                return
            t_sent = state.get("t_sent")
            if t_sent is not None:
                # per-sub-op wire round trip (send -> commit-ack here):
                # the "wire" attribution of the op timeline, exposed as
                # a prometheus histogram through the mgr module
                if self._h_wire_rtt is None:
                    self._h_wire_rtt = stage_histogram(
                        f"{self.name}.wire_rtt_usec")
                self._h_wire_rtt.inc(
                    (time.monotonic() - t_sent) * 1e6,
                    state.get("nbytes", 0))
            if msg.missed:
                # the shard skipped an incremental write (missed base):
                # degrade the fan-out as if it were down — it must not
                # count toward the quorum, and _await_commits verifies
                # enough real appliers remain
                state["expected"].discard(src)
                if (
                    state["committed"] >= state["expected"]
                    and not state["done"].done()
                ):
                    state["done"].set_result(True)
                return
            if not msg.committed and msg.current_version is not None:
                # stale-write refusal: a racing primary won this object.
                # Fail the op now so the writer retries at a higher
                # version; waiting out the commit quorum would hang.
                if not state["done"].done():
                    state["done"].set_exception(
                        WriteConflict(vt(msg.current_version))
                    )
                return
            if msg.committed:
                state["committed"].add(src)
            if state["committed"] >= state["expected"]:
                if not state["done"].done():
                    state["done"].set_result(True)
        elif isinstance(msg, ECSubReadReply):
            state = self._pending.get(msg.tid)
            if state is None:
                return
            state["replies"][msg.from_shard] = msg
            state["outstanding"].discard(msg.from_shard)
            if not state["outstanding"] and not state["done"].done():
                state["done"].set_result(True)

    def _new_tid(self) -> int:
        if self._tid_alloc is not None:
            return self._tid_alloc()
        self._tid += 1
        return self._tid

    @asynccontextmanager
    async def _object_lock(self, oid: str):
        """Acquire the per-object write mutex; the entry is dropped once
        no writer holds or waits for it (bounded state).  With the
        ``lockdep`` option on, acquisition order is tracked per lock
        class ("object:head" vs "object:clone" -- the legitimate nesting
        direction) and cycles raise before they can deadlock."""
        lock = self._oid_locks.get(oid)
        if lock is None:
            from ceph_tpu_torch.utils import lockdep

            if lockdep.enabled():
                cls = "object:clone" if "~" in oid else "object:head"
                lock = self._oid_locks[oid] = lockdep.TrackedLock(cls)
            else:
                lock = self._oid_locks[oid] = asyncio.Lock()
        self._oid_lock_refs[oid] = self._oid_lock_refs.get(oid, 0) + 1
        try:
            async with lock:
                yield
        finally:
            refs = self._oid_lock_refs[oid] - 1
            if refs:
                self._oid_lock_refs[oid] = refs
            else:
                del self._oid_lock_refs[oid]
                self._oid_locks.pop(oid, None)

    #: bound on the per-object version cache; evicted oids are relearned
    #: from shard attrs by _stat on the next write
    _VERSION_CACHE_MAX = 8192

    def _next_version(self, oid: str) -> tuple:
        """pg-wide dense version counter + this primary's name: the
        eversion analogue with a writer tiebreak (see vt())."""
        self._version_head += 1
        self._versions[oid] = self._version_head
        self._versions.move_to_end(oid)
        while len(self._versions) > self._VERSION_CACHE_MAX:
            self._versions.popitem(last=False)
        return (self._version_head, self.name)

    def _learn_version(self, oid: str, seen: tuple) -> None:
        if seen[0] > self._versions.get(oid, 0):
            self._versions[oid] = seen[0]
            self._versions.move_to_end(oid)
            # the read/stat path inserts here too: enforce the cap on
            # every insert, not just on writes
            while len(self._versions) > self._VERSION_CACHE_MAX:
                self._versions.popitem(last=False)
        if seen[0] > self._version_head:
            self._version_head = seen[0]

    # -- write entry points (strategy does the fan-out) --------------------

    async def write(self, oid: str, data: bytes, snapc=None) -> None:
        """Full-object write (create or replace).

        ``snapc`` = {"seq": int, "snaps": [ids]} (librados SnapContext):
        when seq is newer than the object's SnapSet seq, the current head
        is cloned shard-by-shard in the SAME transaction before the new
        bytes land (PrimaryLogPG::make_writeable).

        A WriteConflict (a shard refused the version as stale) propagates
        to the caller; the Objecter retries once after the refusal
        teaches this primary the winning version."""
        # serialize writes per object (in-order pipeline) and conflict with
        # any in-flight RMW on the object via the whole-object pin
        async with self._object_lock(oid):
            async with self.extent_cache.pin(oid, 0, 1 << 62):
                try:
                    await self._write_pinned(oid, data, snapc)
                except WriteConflict as wc:
                    # adopt the winning version so a retry lands on top
                    self._learn_version(oid, wc.winner)
                    self.perf.inc("write_conflict")
                    raise
                finally:
                    # invalidate even on a partial/failed replace: some
                    # shards may have applied, so cached pre-replace
                    # bytes are stale
                    self.extent_cache.invalidate(oid)

    async def write_range(self, oid: str, offset: int, data: bytes,
                          snapc=None) -> None:
        """Partial write; the strategy decides between RMW (EC) and a
        direct extent fan-out (replicated)."""
        # serialize per object: version-assignment + fan-out + commit wait
        # must not interleave with another write's (in-order pipeline)
        async with self._object_lock(oid):
            # pin the write span: publishes committed bytes for read-through
            lo_pin, hi_pin = self._pin_bounds(offset, len(data))
            async with self.extent_cache.pin(oid, lo_pin, hi_pin) as pin:
                try:
                    await self._write_range_pinned(
                        oid, offset, data, pin, snapc
                    )
                except WriteConflict as wc:
                    # this primary's version view was cold (see write());
                    # learn the winner so the Objecter-level retry replays
                    # the WHOLE RMW (re-stat, re-read, re-merge) on top
                    self._learn_version(oid, wc.winner)
                    self.extent_cache.invalidate(oid)
                    self.perf.inc("write_conflict")
                    raise
                except Exception:
                    # a partially-acked write leaves shard state ahead
                    # of the cache: cached pre-write bytes would serve
                    # stale reads
                    self.extent_cache.invalidate(oid)
                    raise

    async def _await_commits(
        self, oid: str, tid: int, done: "asyncio.Future", min_acks: int
    ) -> None:
        """Wait for the fan-out's commit acks, pruning shards discovered
        dead during the send (e.g. a TCP connect refused) so the op
        completes on the surviving set.  Skipped shards hold stale bytes
        until recovered -- the VERSION_KEY read-time cut keeps them out of
        decodes.  If fewer than ``min_acks`` shard targets survive, the op
        fails.  A write that already fully committed (done resolved) is
        never failed by late deaths.  Shared by every fan-out path (full
        write, RMW write, recovery push)."""
        state = self._pending[tid]
        orig_expected = set(state["expected"])
        try:
            if not done.done():
                state["expected"] = {
                    n for n in state["expected"]
                    if not self.messenger.is_down(n)
                }
                if len(state["expected"]) < min_acks:
                    raise IOError(
                        f"write {oid} lost shards mid-flight: "
                        f"only {len(state['expected'])} up"
                    )
                if state["committed"] >= state["expected"]:
                    done.set_result(True)
            from ceph_tpu_torch.utils.config import get_config as _gc

            await asyncio.wait_for(
                done, timeout=float(_gc().get_val(
                    "osd_client_op_commit_timeout"))
            )
            # shards may have dropped out mid-op (missed-base skips): the
            # write only durably exists if enough shards actually applied
            if len(state["committed"]) < min_acks:
                raise IOError(
                    f"write {oid}: only {len(state['committed'])} shards "
                    f"applied (need {min_acks})"
                )
        finally:
            # pg_missing_t bookkeeping: any fan-out that did not reach its
            # full expected set leaves a shard behind -- remember the
            # object so event-driven peering probes it without a scan
            if state["committed"] != orig_expected:
                self._dirty.add(oid)
            del self._pending[tid]

    async def _up_for_write(self, oid: str, acting, need: int):
        """Write-quorum gate shared by every mutation path: the up set,
        re-probed once if it looks too small (stale liveness), failing
        below ``need`` (min_size semantics); marks the object dirty when
        writing degraded (down holders will miss this version)."""
        up = [s for s in range(self.km) if self._shard_up(acting, s)]
        if len(up) < need:
            up = await self._reconfirm_up(acting, up)
        if len(up) < need:
            raise IOError(f"cannot write {oid}: only {len(up)} shards up")
        if len(up) < len(
            [s for s in range(self.km) if acting[s] is not None]
        ):
            self._dirty.add(oid)
        return up

    async def _fanout_commit(self, oid: str, tid: int, subs, expected,
                             min_acks: int) -> None:
        """Register the pending op, send every (target, sub) pair, and
        wait out the commit quorum -- the one fan-out/ack sequence every
        mutation shares, so commit accounting cannot drift between the
        pool strategies."""
        # exactly-once: stamp the in-flight client op's reqid onto its
        # own client-class sub-writes so every applying shard records
        # the dup entry in the same step as the mutation (recovery and
        # scrub pushes, and internal ops of composite kinds, stay bare)
        rid = _OP_REQID.get()
        if rid is not None:
            for _dst, sub in subs:
                if getattr(sub, "op_class", "client") == "client" and \
                        getattr(sub, "reqid", None) is None:
                    sub.reqid = rid
        # QoS: the op's client sub-class rides its own sub-writes so
        # the applying shards' op queues order them under it (trailing
        # optional field, like the reqid; scheduling only -- op_class
        # keeps the version-gate/dup semantics)
        qcls = _OP_QOS.get()
        if qcls is not None:
            for _dst, sub in subs:
                if getattr(sub, "op_class", "client") == "client" and \
                        getattr(sub, "qos_class", None) is None:
                    sub.qos_class = qcls
        # trace stitching: the in-flight op's wire context rides every
        # sub-op of its own fan-out (trailing optional field, like the
        # reqid), so the applying shards' sub-write spans join the
        # client's trace.  Unsampled ops stamp nothing.
        wire_ctx = trace.current_wire()
        if wire_ctx is not None:
            for _dst, sub in subs:
                if getattr(sub, "trace", None) is None:
                    sub.trace = wire_ctx
        done = asyncio.get_event_loop().create_future()
        self._pending[tid] = {
            "committed": set(),
            "expected": set(expected),
            "done": done,
            "t_sent": time.monotonic(),
            "nbytes": sum(
                len(top.data)
                for _dst, sub in subs
                for top in sub.transaction.ops
            ),
        }
        # mesh-local vs wire routing split (osd_mesh_data_plane in the
        # JAX package, ceph_tpu/parallel/mesh_plane.py): a sub-write to
        # an OSD bound to the process mesh carries a delivery-board
        # reference instead of its chunk payload.  The port has no mesh
        # plane yet (ROADMAP.md queue 1 item 7): every peer gets the
        # full payload frame.
        # one multi-destination submit for the whole k+m fan-out: the
        # TCP messenger's per-peer cork queues gather each peer's share
        # into a single scatter-gather burst (one writev + one drain per
        # peer instead of one per sub-op)
        await self.messenger.send_messages(self.name, subs)
        trace.event("fanout_sent")
        await self._await_commits(oid, tid, done, min_acks=min_acks)
        trace.event("commit")

    # -- shard read plumbing -----------------------------------------------

    async def _read_shards(
        self,
        oid: str,
        shards: List[int],
        acting: List[int],
        extents: Optional[List[Tuple[int, int]]] = None,
        op_class: str = "client",
    ) -> Dict[int, ECSubReadReply]:
        shards = [s for s in shards if acting[s] is not None]
        tid = self._new_tid()
        done = asyncio.get_event_loop().create_future()
        self._pending[tid] = {
            "replies": {},
            "outstanding": set(shards),
            "done": done,
        }
        # multi-destination submit: the sub-read fan-out corks per peer
        # exactly like the write fan-out.  The in-flight op's trace
        # context rides each sub-read so the serving shards' spans
        # stitch into the same trace.
        wire_ctx = trace.current_wire()
        qcls = _OP_QOS.get() if op_class == "client" else None
        await self.messenger.send_messages(self.name, [
            (f"osd.{acting[s]}", ECSubRead(
                from_shard=s,
                tid=tid,
                to_read={oid: list(extents) if extents else [(0, -1)]},
                attrs_to_read=[oid],
                op_class=op_class,
                trace=wire_ctx,
                qos_class=qcls,
            ))
            for s in shards
        ])
        trace.event("gather_sent")
        try:
            # config-driven (osd_op_thread_timeout role): give revived
            # stragglers the headroom the client op budget already allows
            from ceph_tpu_torch.utils.config import get_config

            await asyncio.wait_for(done, timeout=float(
                get_config().get_val("osd_read_gather_timeout")))
        except asyncio.TimeoutError:
            pass  # missing shards handled by the caller
        trace.event("gather_done")
        state = self._pending.pop(tid)
        return state["replies"]

    @staticmethod
    def _collect_read(replies, oid, chunks, versions, sizes, failed,
                      attrmap=None) -> None:
        """Merge one _read_shards round into per-shard chunk/version/size
        maps (absent VERSION_KEY decodes as vt(0): pre-versioning or
        never-written objects).  ``attrmap`` additionally captures each
        shard's full attr dict (hinfo / snapset / whiteout) so recovery
        can re-stamp them on the rebuilt shard."""
        for s, reply in replies.items():
            if oid in reply.errors:
                failed.append(s)
                continue
            bufs = reply.buffers_read.get(oid)
            if bufs:
                chunks[s] = np.frombuffer(bufs[0][1], dtype=np.uint8)
            attrs = reply.attrs_read.get(oid) or {}
            if attrs.get(SIZE_KEY) is not None:
                sizes[s] = attrs[SIZE_KEY]
            if attrmap is not None and attrs:
                attrmap[s] = attrs
            versions[s] = vt(attrs.get(VERSION_KEY))

    async def _gather_consistent(
        self, oid, shards, acting, extents=None, op_class="client",
        up_shards=None, allow_incomplete=False,
    ):
        """Version-authoritative gather, shared by read / read_range /
        recovery so the staleness rules cannot diverge between them.

        Round 1 reads data from ``shards`` and, concurrently, version
        attrs from EVERY other up shard -- the minimum data set alone
        cannot establish the authoritative version (it might consist
        entirely of same-version stale shards that missed a degraded
        write).  Versions are tried newest first.  A version that cannot
        assemble k chunks is skipped ONLY if it provably was never acked
        (its up holders plus every unreachable shard still total < k
        commits — a write that died mid-flight below min_size; log
        rollback semantics).  If it MIGHT have been acked, the object is
        reported incomplete instead of silently serving older data — the
        read-after-ack guarantee.  Recovery passes ``allow_incomplete``
        to reconstruct the newest assemblable version (its job is exactly
        to repair such objects).

        Returns (chunks, size_hint, attrs_hint, version_tuple);
        attrs_hint is a full attr dict from one holder of the chosen
        version (hinfo / snapset / whiteout), or None."""
        if up_shards is None:
            up_shards = [
                s for s in range(self.km) if self._shard_up(acting, s)
            ]
        chunks: Dict[int, np.ndarray] = {}
        versions: Dict[int, tuple] = {}
        sizes: Dict[int, int] = {}
        attrmap: Dict[int, dict] = {}
        failed: List[int] = []
        others = [s for s in up_shards if s not in shards]
        data_coro = self._read_shards(
            oid, shards, acting, extents=extents, op_class=op_class
        )
        if others:
            attr_coro = self._read_shards(
                oid, others, acting, extents=[(0, 0)], op_class=op_class
            )
            data_replies, attr_replies = await asyncio.gather(
                data_coro, attr_coro
            )
        else:
            data_replies, attr_replies = await data_coro, {}
        self._collect_read(data_replies, oid, chunks, versions, sizes,
                           failed, attrmap)
        # attr-only round: versions/sizes/attrs, never chunk content
        attr_chunks: Dict[int, np.ndarray] = {}
        self._collect_read(attr_replies, oid, attr_chunks, versions, sizes,
                           failed, attrmap)

        counts: Dict[tuple, int] = {}
        for s, v in versions.items():
            if s not in failed:
                counts[v] = counts.get(v, 0) + 1
        if not counts:
            return {}, None, None, (0, "")
        # shards that might hold a newer version we cannot see: mapped
        # positions whose OSD is down/unreachable, plus shards that
        # errored (their stamp is unknown)
        unseen = sum(
            1 for s in range(self.km)
            if acting[s] is not None and s not in versions
        )

        ordered = sorted(counts, reverse=True)
        last = ordered[-1]
        for target in ordered:
            if counts[target] < self.k and target != last:
                if counts[target] + unseen >= self.k and not allow_incomplete:
                    # might have reached k commits (the missing holders
                    # may be among the unreachable shards): serving an
                    # older version could violate read-after-ack
                    raise ObjectIncomplete(
                        f"{oid}: newest version {target} has only "
                        f"{counts[target]} reachable holders (+{unseen} "
                        f"unreachable); refusing possibly-stale read"
                    )
                # provably never acked (< k commits possible): the write
                # died mid-flight below min_size — roll back to the
                # previous version
                self.perf.inc("rolled_back_version_skipped")
                continue
            holders = [
                s for s in up_shards
                if versions.get(s) == target and s not in failed
            ]
            need = [s for s in holders if s not in chunks]
            if need:
                self.perf.inc("degraded_read")
                more = await self._read_shards(
                    oid, need, acting, extents=extents, op_class=op_class
                )
                self._collect_read(more, oid, chunks, versions, sizes,
                                   failed, attrmap)
            have = {
                s: chunks[s] for s in holders
                if s in chunks and versions.get(s) == target
            }
            if len(have) >= self.k or target == last:
                if len(chunks) != len(have):
                    self.perf.inc("stale_shards_dropped")
                size = next(
                    (sizes[s] for s in holders if sizes.get(s) is not None),
                    None,
                )
                attrs = next(
                    (attrmap[s] for s in holders if s in attrmap), None
                )
                return have, size, attrs, target
            if not allow_incomplete:
                # the candidate had >= k stamped holders but fewer than k
                # produced chunks (read failures mid-gather): it may have
                # been acked, so do not fall through to older data
                raise ObjectIncomplete(
                    f"{oid}: version {target} assembled only "
                    f"{len(have)}/{self.k} chunks"
                )
        return {}, None, None, (0, "")  # unreachable: loop always returns

    async def _stat(self, oid: str) -> Tuple[int, Optional[dict]]:
        """(logical size, hinfo dict) from shard attrs; size 0 if absent.

        Queries every up shard's attrs in one parallel round and answers
        from the highest-versioned reply: a shard that was down during
        writes may hold stale size/hinfo, and planning an RMW from stale
        metadata would corrupt the object.  Also teaches this primary the
        object's current version (``self._versions``) so a fresh client
        process continues the version sequence instead of restarting it
        (which the shards' stale-write gate would silently discard)."""
        acting = self.acting_set(oid)
        up = [
            s
            for s in range(self.km)
            if self._shard_up(acting, s)
        ]
        replies = await self._read_shards(oid, up, acting, extents=[(0, 0)])
        best = None  # (version_tuple, size, hinfo, snapset, whiteout)
        for r in replies.values():
            attrs = r.attrs_read.get(oid) or {}
            if attrs.get(SIZE_KEY) is None:
                continue
            ver = vt(attrs.get(VERSION_KEY))
            if best is None or ver > best[0]:
                best = (ver, attrs[SIZE_KEY], attrs.get(ecutil.HINFO_KEY),
                        attrs.get(SNAPSET_KEY), attrs.get(WHITEOUT_KEY))
        if best is None:
            self._snapsets[oid] = {"seq": 0, "clones": [],
                                   "exists": False, "size": 0}
            return 0, None
        self._learn_version(oid, best[0])
        ss = best[3] or {"seq": 0, "clones": []}
        self._snapsets[oid] = {
            "seq": ss["seq"], "clones": list(ss["clones"]),
            "exists": not best[4], "size": best[1],
        }
        if best[4]:
            return 0, None  # whiteout head: absent to plain stat/readers
        return best[1], best[2]

    async def stat(self, oid: str):
        """Public stat: (logical size, hinfo dict | None) -- the same
        surface the Objecter exposes, so rbd/cls callers work against
        either a local engine or the remote-routed client."""
        return await self._stat(oid)

    # -- removal -----------------------------------------------------------

    async def remove_object(self, oid: str, snapc=None) -> None:
        """Delete every shard of an object (librados remove role).

        Under a snap context newer than the SnapSet seq the head is
        cloned first and then WHITEOUT'd (truncated to zero with the
        whiteout attr) instead of removed, so snap reads keep resolving
        through the head's SnapSet -- the reference's snapdir object.
        The whiteout disappears when snap_trim drops the last clone."""
        async with self._object_lock(oid):
            await self._remove_object_locked(oid, snapc)

    async def _remove_object_locked(self, oid: str, snapc=None) -> None:
        acting = self.acting_set(oid)
        up = [s for s in range(self.km) if self._shard_up(acting, s)]
        if not up:
            raise IOError(f"cannot remove {oid}: no shards up")
        if len(up) < len([s for s in range(self.km) if acting[s] is not None]):
            self._dirty.add(oid)  # down holders keep a doomed copy
        if oid not in self._versions or (
            snapc and oid not in self._snapsets
        ):
            await self._stat(oid)
        snapset, clone_id = self._snap_prepare(oid, snapc)
        if clone_id is not None:
            # snap-preserving delete: clone + whiteout in one transaction
            if len(up) < self.min_size:
                raise IOError(f"cannot remove {oid}: only {len(up)} up")
            version = self._next_version(oid)
            tid = self._new_tid()
            subs = []
            for s in up:
                soid = shard_oid(oid, s)
                txn = self._pool_stamp(
                    Transaction()
                    .clone(soid, shard_oid(snap_oid(oid, clone_id), s))
                    .truncate(soid, 0)
                    .setattr(soid, SIZE_KEY, 0)
                    .setattr(soid, VERSION_KEY, version)
                    .setattr(soid, WHITEOUT_KEY, True)
                    .setattr(soid, SNAPSET_KEY, snapset),
                    soid,
                )
                subs.append((f"osd.{acting[s]}", ECSubWrite(
                    from_shard=s, tid=tid, oid=oid,
                    transaction=txn, at_version=version)))
            await self._fanout_commit(
                oid, tid, subs, {f"osd.{acting[s]}" for s in up},
                min_acks=self.min_size,
            )
            self._snap_committed(oid, snapset, 0, exists=False)
            self.extent_cache.invalidate(oid)
            self._tier_invalidate(oid)
            return
        self._snapsets.pop(oid, None)
        # tombstone the meta twin BEFORE destroying data: if the
        # tombstone cannot land anywhere the remove fails cleanly with
        # the object intact, instead of leaving deleted data whose
        # stale omap resurrects at the next recovery pass (the
        # reference orders its delete the same way: the PG-log entry
        # is durable before the objects go)
        await self._meta_remove(oid)
        await self._destroy_object(oid, up, acting)
        self.extent_cache.invalidate(oid)
        self._tier_invalidate(oid)

    # -- metadata plane: replicated omap / CAS / watch-notify / cls --------
    #
    # The reference keeps object metadata (cls state, rbd headers, locks)
    # in omap on replicated pools and runs cls methods + watch/notify on
    # the primary OSD.  Here the metadata object "<oid>@meta" is fully
    # replicated to every up shard OSD (metadata is small; survival under
    # any k-available scenario matters more than space), versioned on its
    # own sequence; the acting[0] OSD is the atomicity (CAS) and
    # watch/notify authority.

    def _meta_targets(self, oid: str, mark_dirty: bool = False):
        acting = self.acting_set(oid)
        up = [
            f"osd.{acting[s]}"
            for s in range(self.km)
            if self._shard_up(acting, s)
        ]
        if not up:
            raise IOError(f"no up OSDs for {oid} metadata")
        if mark_dirty and len(up) < len(
            [s for s in range(self.km) if acting[s] is not None]
        ):
            self._dirty_meta.add(oid)  # down replicas miss this version
        return up

    async def _meta_roundtrip(self, targets, payload: dict,
                              timeout: float = 5.0) -> Dict[str, dict]:
        """Send one dict op to each target, gather replies by sender.
        Mutating meta ops carry this engine's pool so the stored twin is
        membership-tagged like any shard object (see POOL_KEY)."""
        if self.pool_name is not None and payload.get("op") in (
            "meta_apply", "omap_cas"
        ):
            payload = dict(payload, pool=self.pool_name)
        # exactly-once: metadata-plane mutations carry the client op's
        # reqid so every applying replica records the dup entry with the
        # mutation itself (see REQID_FANOUT_KINDS)
        rid = _OP_REQID.get()
        if rid is not None and payload.get("op") in (
            "meta_apply", "omap_cas"
        ) and "reqid" not in payload:
            payload = dict(payload, reqid=list(rid))
        tid = self._new_tid()
        done = asyncio.get_event_loop().create_future()
        self._pending[tid] = {
            "replies": {}, "outstanding": set(targets), "done": done,
        }
        for t in targets:
            await self.messenger.send_message(
                self.name, t, dict(payload, tid=tid)
            )
        try:
            await asyncio.wait_for(done, timeout=timeout)
        except asyncio.TimeoutError:
            pass
        state = self._pending.pop(tid)
        return state["replies"]

    async def _meta_read_full(self, oid: str):
        """(omap, version, removed) of the highest-versioned replica
        (+ learn the version).  A removed tombstone reads as empty."""
        targets = self._meta_targets(oid)
        replies = await self._meta_roundtrip(
            targets, {"op": "meta_get", "oid": oid}
        )
        best_ver, best, removed = 0, None, False
        for r in replies.values():
            if r.get("omap") is not None and r["version"] >= best_ver:
                best_ver, best = r["version"], r["omap"]
                removed = bool(r.get("removed"))
        if best_ver > self._meta_versions.get(oid, 0):
            self._meta_versions[oid] = best_ver
        if removed or best is None:
            return {}, best_ver, removed
        return best, best_ver, removed

    async def _meta_read(self, oid: str) -> Dict[str, bytes]:
        omap, _ver, _removed = await self._meta_read_full(oid)
        return omap

    async def _meta_write(self, oid: str, sets=None, rms=None,
                          clear=False) -> None:
        """Read-modify-write of the FULL replicated omap.  Full-state
        replication lets a replica that missed versions converge in one
        step; concurrent plain writers are last-writer-wins (atomic
        read-modify-write goes through omap_cas / cls methods, as in the
        reference)."""
        targets = self._meta_targets(oid, mark_dirty=True)
        omap = {} if clear else await self._meta_read(oid)
        if rms:
            for k in rms:
                omap.pop(k, None)
        if sets:
            omap.update(sets)
        ver = self._meta_versions.get(oid, 0) + 1
        self._meta_versions[oid] = ver
        replies = await self._meta_roundtrip(targets, {
            "op": "meta_apply", "oid": oid, "version": ver, "omap": omap,
        })
        if not replies:
            raise IOError(f"metadata write for {oid} reached no OSD")
        if len(replies) < len(targets):
            self._dirty_meta.add(oid)  # a replica missed this version

    #: tombstones jump a whole version GENERATION: a down replica whose
    #: solo-acked writes put it a few versions ahead of what the remover
    #: could read must still lose to the tombstone under highest-version
    #: recovery.  Packing the generation into the integer keeps every
    #: existing comparison (peering tuples included) working unchanged.
    TOMBSTONE_GEN = 1 << 32

    async def _meta_remove(self, oid: str) -> None:
        """Tombstone the meta twin on every replica (object removal).
        Versioned like any meta write so a replica that missed it is
        repaired by highest-version-wins recovery -- towards the
        tombstone, never back to the deleted keys."""
        targets = self._meta_targets(oid, mark_dirty=True)
        await self._meta_read(oid)  # learn the current version
        ver = self._meta_versions.get(oid, 0) + self.TOMBSTONE_GEN
        self._meta_versions[oid] = ver
        replies = await self._meta_roundtrip(targets, {
            "op": "meta_apply", "oid": oid, "version": ver,
            "remove": True, "omap": {},
        })
        if not replies:
            raise IOError(f"metadata remove for {oid} reached no OSD")
        if len(replies) < len(targets):
            self._dirty_meta.add(oid)  # a replica missed the tombstone

    async def omap_set(self, oid: str, kvs: Dict[str, bytes]) -> None:
        await self._meta_write(oid, sets=dict(kvs))

    async def omap_rm(self, oid: str, keys) -> None:
        await self._meta_write(oid, rms=list(keys))

    async def omap_clear(self, oid: str) -> None:
        await self._meta_write(oid, clear=True)

    async def omap_get(self, oid: str, keys=None) -> Dict[str, bytes]:
        omap = await self._meta_read(oid)
        if keys is None:
            return omap
        return {k: omap[k] for k in keys if k in omap}

    async def omap_cas(self, oid: str, key: str, expect, new):
        """Atomic compare-and-swap on the primary-shard OSD, then
        replicate the outcome to the remaining replicas."""
        acting = self.acting_set(oid)
        primary = None
        for s in range(self.km):
            if self._shard_up(acting, s):
                primary = f"osd.{acting[s]}"
                break
        if primary is None:
            raise IOError(f"no up OSDs for {oid} CAS")
        replies = await self._meta_roundtrip(
            [primary],
            {"op": "omap_cas", "oid": oid, "key": key,
             "expect": expect, "new": new},
        )
        r = replies.get(primary)
        if r is None:
            raise IOError(f"CAS on {oid} got no reply from {primary}")
        if r["success"]:
            # propagate the authority's full state to the other replicas
            self._meta_versions[oid] = r["version"]
            others = [t for t in self._meta_targets(oid) if t != primary]
            if others:
                # the CAS outcome rides the replication fan-out as a
                # dup result: any replica that may be promoted primary
                # can then answer a replayed CAS with the ORIGINAL
                # (success, current) instead of re-comparing against
                # post-apply state (which would report a false failure)
                await self._meta_roundtrip(others, {
                    "op": "meta_apply", "oid": oid,
                    "version": r["version"], "omap": r["omap"],
                    "dup_result": [r["success"], r["current"]],
                })
        return r["success"], r["current"]

    async def watch(self, oid: str, callback=None, watcher: str = None) -> None:
        """Register for notify events on oid (librados watch role).

        ``watcher`` names the entity that receives notify events; when a
        client routes its watch through the primary OSD (the reference
        path), it is the *client's* messenger name and events go to it
        directly, bypassing this engine."""
        targets = self._meta_targets(oid)[:1]
        watcher = watcher or self.name
        if watcher == self.name:
            self._watch_callbacks[oid] = callback
        replies = await self._meta_roundtrip(
            targets, {"op": "watch", "oid": oid, "watcher": watcher}
        )
        if not replies:
            self._watch_callbacks.pop(oid, None)
            raise IOError(f"watch {oid}: no reply")

    async def unwatch(self, oid: str, watcher: str = None) -> None:
        targets = self._meta_targets(oid)[:1]
        watcher = watcher or self.name
        if watcher == self.name:
            self._watch_callbacks.pop(oid, None)
        await self._meta_roundtrip(
            targets, {"op": "unwatch", "oid": oid, "watcher": watcher}
        )

    async def notify(self, oid: str, payload=None, timeout: float = 5.0):
        """Notify every watcher; returns {"acks": [...], "timeouts": [...]}
        once all ack or the timeout passes (librados notify role)."""
        targets = self._meta_targets(oid)[:1]
        replies = await self._meta_roundtrip(
            targets,
            {"op": "notify", "oid": oid, "payload": payload,
             "timeout": timeout},
            # the OSD gathers watcher acks for up to ``timeout`` before it
            # replies; give the round-trip headroom past that
            timeout=timeout + 2.0,
        )
        for r in replies.values():
            return {"acks": r["acks"], "timeouts": r["timeouts"]}
        raise IOError(f"notify {oid}: no reply")

    async def exec(self, oid: str, cls: str, method: str, inp: bytes = b""):
        """Run a server-side object class method (cls exec role).

        The reference dlopens cls plugins on the OSD (ClassHandler); our
        primary engine hosts the class registry and methods run against
        this backend's object surface, with omap_cas as the atomicity
        primitive where a method needs read-modify-write.  The port has
        no object classes yet: this raises."""
        refuse(f"exec {cls}.{method}", "cls")

    # -- snapshots (SnapMapper / make_writeable roles) ---------------------

    def _snap_prepare(self, oid: str, snapc):
        """(new snapset attr value, clone id) for a write under ``snapc``;
        (None, None) when no snap context.  Must run after _stat primed
        the SnapSet cache.  Reference: PrimaryLogPG::make_writeable."""
        if not snapc:
            return None, None
        cur = self._snapsets.get(oid) or {
            "seq": 0, "clones": [], "exists": False, "size": 0
        }
        snapset = {"seq": max(cur["seq"], snapc["seq"]),
                   "clones": list(cur["clones"])}
        clone_id = None
        if cur.get("exists") and snapc["seq"] > cur["seq"]:
            clone_id = snapc["seq"]
            snapset["clones"].append(
                {"id": clone_id, "size": cur.get("size", 0)}
            )
        return snapset, clone_id

    def _snap_committed(self, oid: str, snapset, new_size: int,
                        exists: bool = True) -> None:
        """Update the SnapSet cache after a committed snap-context op."""
        if snapset is None:
            ent = self._snapsets.get(oid)
            if ent is not None:
                ent["exists"] = exists
                ent["size"] = new_size
            return
        self._snapsets[oid] = {
            "seq": snapset["seq"], "clones": list(snapset["clones"]),
            "exists": exists, "size": new_size,
        }

    async def resolve_snap(self, oid: str, snap: int) -> str:
        """Object name serving reads at snap id ``snap``: the oldest clone
        whose id >= snap, else the head (librados snap read resolution,
        SnapSet::get_clone_bytes / PrimaryLogPG::find_object_context)."""
        if oid not in self._snapsets:
            await self._stat(oid)
        ss = self._snapsets.get(oid)
        if not ss or not ss["clones"]:
            return oid
        cands = sorted(c["id"] for c in ss["clones"] if c["id"] >= snap)
        return snap_oid(oid, cands[0]) if cands else oid

    async def list_snaps(self, oid: str) -> dict:
        """The object's SnapSet (rados listsnaps role)."""
        await self._stat(oid)  # refresh
        ss = self._snapsets.get(oid) or {"seq": 0, "clones": [],
                                         "exists": False}
        return {"seq": ss["seq"], "clones": list(ss["clones"]),
                "head_exists": bool(ss.get("exists"))}

    async def snap_rollback(self, oid: str, snap: int, snapc=None) -> None:
        """Restore the head to its state at ``snap`` (librados
        selfmanaged_snap_rollback; reference PrimaryLogPG::_rollback_to).
        Implemented as read-at-snap + write-as-new-version, so the
        rollback itself is snapshotted under ``snapc`` like any write."""
        src = await self.resolve_snap(oid, snap)
        if src == oid:
            return  # head already is the snap state
        data = await self.read(src)
        await self.write(oid, data, snapc=snapc)

    async def snap_trim(self, oid: str, live_snaps) -> int:
        """Drop clones no longer needed by any live snap (SnapMapper +
        snap trim role).  A clone with id C covers snaps in
        (previous clone id, C]; when none of those are alive the clone is
        removed and the head's SnapSet shrinks.  A whiteout head whose
        last clone goes is removed outright.  Returns clones dropped."""
        await self._stat(oid)
        cur = self._snapsets.get(oid)
        if not cur or not cur["clones"]:
            return 0
        live = sorted(live_snaps)
        keep, drop = [], []
        prev = 0
        for c in sorted(cur["clones"], key=lambda c: c["id"]):
            if any(prev < sn <= c["id"] for sn in live):
                keep.append(c)
            else:
                drop.append(c)
            prev = c["id"]
        if not drop:
            return 0
        # the whole read-modify-write of the SnapSet runs under the head's
        # object lock so a concurrent snap-context write cannot append a
        # clone entry that the stale stamp below would erase
        async with self._object_lock(oid):
            cur = self._snapsets.get(oid) or cur  # re-read under the lock
            keep = [c for c in cur["clones"]
                    if not any(d["id"] == c["id"] for d in drop)]
            for c in drop:
                try:
                    await self.remove_object(snap_oid(oid, c["id"]))
                except IOError:
                    pass  # already gone; peering will converge
            self.perf.inc("snap_trim", len(drop))
            if not keep and not cur.get("exists"):
                # whiteout head, no clones left: the object is fully dead
                await self._remove_object_locked(oid)
                self._snapsets.pop(oid, None)
                return len(drop)
            new_ss = {"seq": cur["seq"], "clones": keep}
            await self._set_snapset_locked(oid, new_ss)
        return len(drop)

    async def _set_snapset_locked(self, oid: str, snapset: dict) -> None:
        """Attr-only fan-out updating the head's SnapSet (version-stamped
        so the stale gates order it like any write).  Caller holds the
        object lock."""
        acting = self.acting_set(oid)
        up = [s for s in range(self.km) if self._shard_up(acting, s)]
        if len(up) < self.min_size:
            raise IOError(f"cannot update snapset of {oid}")
        version = self._next_version(oid)
        tid = self._new_tid()
        subs = []
        for s in up:
            soid = shard_oid(oid, s)
            txn = (
                Transaction()
                .setattr(soid, SNAPSET_KEY, snapset)
                .setattr(soid, VERSION_KEY, version)
            )
            subs.append((f"osd.{acting[s]}", ECSubWrite(
                from_shard=s, tid=tid, oid=oid,
                transaction=txn, at_version=version)))
        await self._fanout_commit(
            oid, tid, subs, {f"osd.{acting[s]}" for s in up},
            min_acks=self.min_size,
        )
        ent = self._snapsets.get(oid)
        if ent is not None:
            ent["seq"] = snapset["seq"]
            ent["clones"] = list(snapset["clones"])
        # the bytes are unchanged but the version moved: a resident tier
        # copy would read as stale forever, so drop it now
        self._tier_invalidate(oid)

    # -- scrub -------------------------------------------------------------

    async def deep_scrub(self, oid: str) -> dict:
        """Read every shard, verify per-shard crc32c and cross-shard
        consistency (``_scrub_verify``: parity re-encode for EC, copy
        comparison for replicated) -- the deep-scrub role (reference: PG
        scrub + backend-specific checks; inconsistency report shape
        follows ScrubStore's per-object errors).  The
        reads ride the batched background lane with a chunked cursor
        (see :meth:`deep_scrub_many`)."""
        return (await self.deep_scrub_many([oid]))[oid]

    async def deep_scrub_many(self, oids: List[str]) -> Dict[str, dict]:
        """Batched deep scrub: every object's shard reads ride the
        chunked background cursor (``osd_scrub_chunk_max`` bytes per
        shard per round, one corked multi-read burst per round for the
        WHOLE set -- osd/recovery.py scrub_read_many) instead of one
        whole-shard fan-out per object; verification is per object as
        before.  Returns {oid: report}."""
        from ceph_tpu_torch.osd.recovery import scrub_read_many

        gathered = await scrub_read_many(self, list(oids))
        reports = {}
        for oid in oids:
            acting = self.acting_set(oid)
            up = [
                s for s in range(self.km) if self._shard_up(acting, s)
            ]
            reports[oid] = self._scrub_report(
                oid, up, gathered.get(oid, {}))
        return reports

    def _scrub_report(self, oid: str, up: List[int],
                      shards: Dict[int, dict]) -> dict:
        """Classify one object's gathered shard cuts into the scrub
        report (shared by the batched and single-object entry points)."""
        report = {
            "oid": oid,
            "crc_errors": [],
            "missing": [],
            "parity_mismatch": [],
            "ok": True,
        }
        chunks: Dict[int, np.ndarray] = {}
        seen_versions = set()
        for s in up:
            slot = shards.get(s)
            if slot is None:
                report["missing"].append(s)  # the shard never answered
                continue
            if slot.get("error") is not None:
                report["crc_errors"].append(s)
                continue
            seen_versions |= slot.get("versions") or {vt(None)}
            if slot.get("had_buf"):
                chunks[s] = np.frombuffer(slot["data"], dtype=np.uint8)
            else:
                report["missing"].append(s)
        if len(seen_versions) > 1:
            # mixed versions: an in-flight write or a stale shard --
            # that is peering's jurisdiction, not a scrub inconsistency;
            # report clean-with-deferral instead of a false parity error
            # (the reference scrubber blocks on in-progress writes)
            self.perf.inc("scrub_deferred")
            report["deferred"] = True
            self.scrub_errors.pop(oid, None)
            return report
        self._scrub_verify(chunks, report)
        report["ok"] = not (
            report["crc_errors"] or report["missing"] or report["parity_mismatch"]
        )
        if report["ok"]:
            self.scrub_errors.pop(oid, None)
        else:
            self.scrub_errors[oid] = report
            self.perf.inc("scrub_inconsistent")
        self.perf.inc("deep_scrub")
        return report

    async def scrub_repair(self, oid: str, report: dict) -> int:
        """Repair every shard a deep scrub flagged (crc error / missing /
        parity mismatch) by reconstructing it from the consistent set and
        pushing it back -- the scrub-driven auto-repair loop (reference:
        PG repair + qa/standalone/erasure-code/test-erasure-eio.sh)."""
        acting = self.acting_set(oid)
        bad = sorted(
            set(report["crc_errors"]) | set(report["missing"])
            | set(report["parity_mismatch"])
        )
        repaired = 0
        for s in bad:
            if not self._shard_up(acting, s):
                continue
            try:
                await self.recover_shard(oid, s, acting[s], rollback=True)
                repaired += 1
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 -- a failed repair stays in
                # scrub_errors/_dirty; the next scrub or peering retries
                self.perf.inc("scrub_repair_failed")
                self._dirty.add(oid)
        if repaired:
            self.perf.inc("scrub_repair", repaired)
            # confirm: a clean re-scrub clears the error record
            report2 = await self.deep_scrub(oid)
            if report2["ok"]:
                self.scrub_errors.pop(oid, None)
        return repaired

    # -- recovery ----------------------------------------------------------

    def _recovery(self):
        """Lazy per-PG RecoveryCoalescer (the batched background data
        plane, osd/recovery.py); shared by recovery and the scrub
        cursor so one throttle governs all background I/O."""
        rc = getattr(self, "_recovery_coalescer", None)
        if rc is None:
            from ceph_tpu_torch.osd.recovery import RecoveryCoalescer

            rc = self._recovery_coalescer = RecoveryCoalescer(self)
        return rc

    def _use_batched_recovery(self) -> bool:
        """Batched recovery serves EC engines (the codec's fused decode
        is the win); replicated pools keep the per-object path."""
        from ceph_tpu_torch.utils.config import get_config

        return getattr(self, "ec", None) is not None and bool(
            get_config().get_val("osd_recovery_batched"))

    async def _recovery_pace(self) -> None:
        """Awaited pacing between background recovery windows
        (osd_recovery_sleep; 0 still yields so client ops interleave
        -- the async-background-unthrottled discipline)."""
        from ceph_tpu_torch.utils.config import get_config

        await asyncio.sleep(
            float(get_config().get_val("osd_recovery_sleep")))

    async def recover_shard(
        self, oid: str, shard: int, target_osd: int, rollback: bool = False,
        sources: Optional[Dict[int, int]] = None,
    ) -> None:
        """Reconstruct one lost/stale shard and push it to the target OSD
        in bounded windows (the READING->WRITING recovery state machine,
        ECBackend.h:256-300, chunked like get_recovery_chunk_size :213 so
        a 64 MiB object never needs 64 MiB of primary memory).  A client
        write landing mid-recovery changes the object version; that is
        detected at the next window's gather and the recovery restarts.
        ``rollback=True`` lets the final stamp overwrite a torn
        higher-versioned copy (peering's divergent-entry rollback).

        The whole recovery holds the object's write lock, so client
        writes to a HOT object queue briefly behind the push instead of
        restarting it forever (the reference pins the object context for
        the duration of the push, src/osd/ECBackend.cc:535-700).  The
        version-moved restart loop remains as a safety net for writes
        from a racing primary, which does not share this lock.

        ``sources`` maps shard position -> OSD id holding that shard's
        authoritative copy on a NON-acting OSD (a remap leftover): the
        gather reads those positions from the named holders instead of
        the acting slots.  This is the backfill/relocation data path of
        elastic membership -- after a CRUSH remap the acting set may
        hold fewer than k shards, so reconstruction must read from
        wherever the copies actually are."""
        from ceph_tpu_torch.utils.config import get_config

        window = max(1, int(get_config().get_val("osd_recovery_max_chunk")))
        async with self._object_lock(oid):
            for attempt in range(3):
                if await self._recover_shard_once(
                    oid, shard, target_osd, window, rollback,
                    sources=sources,
                ):
                    self.perf.inc("recover")
                    return
                self.perf.inc("recover_restart")
        raise IOError(
            f"recovery of {oid}@{shard} kept losing to concurrent writes"
        )

    async def _recover_shard_once(
        self, oid: str, shard: int, target_osd: int, window: int,
        rollback: bool, sources: Optional[Dict[int, int]] = None,
    ) -> bool:
        """One windowed recovery attempt; False = restart (the object's
        version moved under us)."""
        acting = self.acting_set(oid)
        if sources:
            # relocation gather: read positions from the remap-leftover
            # holders, not the (possibly empty) acting slots
            acting = list(acting)
            for pos, holder in sources.items():
                acting[pos] = holder
        up_shards = [
            s
            for s in range(self.km)
            if (s != shard or (sources and s in sources))
            and self._shard_up(acting, s)
        ]
        src = self._min_sources([shard], up_shards)
        cs = self.sinfo.chunk_size
        # per-source-chunk bytes per round, whole per-stripe chunks only
        # (a stripe decodes independently for every technique)
        win = max(cs, (window // self.k) // cs * cs)
        chunks, logical_size, attrs_hint, vmax = await self._gather_consistent(
            oid, src, acting, extents=[(0, win)], op_class="recovery",
            up_shards=up_shards, allow_incomplete=True,
        )
        if len(chunks) < self.k:
            raise IOError(f"cannot recover {oid}@{shard}: too few sources")
        if logical_size is None:
            raise IOError(f"cannot recover {oid}@{shard}: no size metadata")
        chunk_total = self._shard_bytes_total(logical_size)
        soid = shard_oid(oid, shard)
        off = 0
        while True:
            piece = self._rebuild_shard(chunks, shard)
            last = off + len(piece) >= chunk_total
            if not last and not piece:
                # sources hold less data than the size metadata claims
                # (inconsistent mid-write state): restart, don't spin
                return False
            txn = Transaction().write(soid, off, piece)
            if last:
                # attrs (incl. the version stamp) land ONLY on the final
                # window: a half-recovered shard must never claim the
                # authoritative version.  Truncate drops any longer stale
                # tail from a shrinking overwrite the target missed.
                # SnapSet/whiteout re-stamp from the sources so a
                # recovered shard keeps serving snap resolution.
                attrs_hint = attrs_hint or {}
                txn = self._pool_stamp(
                    txn.truncate(soid, chunk_total)
                    .setattr(soid, ecutil.HINFO_KEY,
                             attrs_hint.get(ecutil.HINFO_KEY))
                    .setattr(soid, SIZE_KEY, logical_size)
                    .setattr(soid, VERSION_KEY, vmax)
                    .setattr(soid, SNAPSET_KEY,
                             attrs_hint.get(SNAPSET_KEY))
                    .setattr(soid, WHITEOUT_KEY,
                             attrs_hint.get(WHITEOUT_KEY)),
                    soid,
                )
            tid = self._new_tid()
            sub = ECSubWrite(
                from_shard=shard,
                tid=tid,
                oid=oid,
                transaction=txn,
                # the consistent sources' version, NOT this primary's
                # possibly cold _versions map: a lower number would be
                # silently no-op'd by the target's stale-write gate
                at_version=vmax,
                op_class="recovery",
                rollback=rollback,
            )
            # min_acks=1: the push has exactly one target; if it died,
            # fail loudly instead of reporting a recovery that never ran
            await self._fanout_commit(
                oid, tid, [(f"osd.{target_osd}", sub)],
                {f"osd.{target_osd}"}, min_acks=1,
            )
            self.perf.inc("recover_window")
            if sources:
                # relocation pushes are backfill data movement by
                # definition: account them for the elastic bench's
                # data-moved gate
                self.perf.inc("recovery_backfill_bytes", len(piece))
            if last:
                return True
            await self._recovery_pace()
            off += len(piece)
            chunks, _, _, v2 = await self._gather_consistent(
                oid, src, acting, extents=[(off, win)], op_class="recovery",
                up_shards=up_shards, allow_incomplete=True,
            )
            if v2 != vmax or len(chunks) < self.k:
                return False

    # -- peering (PG.h:2122 Peering + start_recovery_ops role) -------------

    def _peering_authoritative(self, counts: Dict[tuple, int],
                               unseen: int,
                               counts_any: Optional[Dict[tuple, int]] = None,
                               all_visible: bool = False,
                               ) -> Optional[tuple]:
        """Pick the version to recover toward from placed-copy counts.

        Newest version with >= k placed holders wins (assemblable).  A
        newer version with fewer holders is either *possibly acked*
        (holders + unreporting placed positions could reach k) -- then we
        must NOT recover toward older data, return None and wait -- or
        *provably torn* (could never have reached k commits), in which
        case its copies are divergent log entries to roll back.  This is
        the log-authority computation of peering
        (doc/dev/osd_internals/log_based_pg.rst).  For replicated pools
        k == 1, so any visible copy of the newest version is immediately
        authoritative (a full copy is always assemblable)."""
        for v in sorted(counts, reverse=True):
            if counts[v] >= self.k:
                return v
            if counts[v] + unseen >= self.k:
                return None  # possibly acked, unassemblable now: wait
        # No acting version is assemblable.  Before declaring the object
        # absent, consult copies on up-but-NON-acting holders (remap
        # leftovers): if any version could have reached k commits counting
        # those, the write was real -- wait for remap recovery instead of
        # destroying the surviving copies.
        if counts_any:
            for v, n in counts_any.items():
                if n + unseen >= self.k:
                    return None
        if not all_visible:
            # an unreporting OSD anywhere in the cluster could hide
            # committed copies (e.g. remap sources that died): the torn
            # proof is incomplete -- wait, never destroy
            return None
        # every observed version is PROVABLY torn (could not have reached
        # k commits even counting non-acting holders and unreporting
        # placed holders, with every cluster OSD visible): the object's
        # authoritative state is "absent".  Divergent creates and remove
        # leftovers roll back / get removed (the reference rolls back
        # divergent log entries the same way).
        return (0, "")

    def _remap_sources(
        self, shardmap: Dict[int, Dict[str, tuple]], reporting,
    ) -> Tuple[Optional[tuple], Dict[int, int]]:
        """Newest version visible on any up holder and, per shard
        position, one up holder of that version -- the read-source map
        for remap relocation.  Holders that stopped reporting are
        excluded (their copies cannot be read)."""
        vstar = None
        for holders in shardmap.values():
            for holder, v in holders.items():
                if holder in reporting and (vstar is None or v > vstar):
                    vstar = v
        src: Dict[int, int] = {}
        if vstar is not None:
            for s, holders in shardmap.items():
                for holder in sorted(holders):
                    if holder in reporting and holders[holder] == vstar:
                        src[s] = int(holder.split(".", 1)[1])
                        break
        return vstar, src

    async def peering_pass(self, max_active: int = None,
                           backfill: bool = False) -> int:
        """One event/delta-driven peering + recovery round for objects
        whose PRIMARY this engine's OSD currently is.

        Three stages mirroring the reference peering state machine
        (src/osd/PG.cc GetInfo -> GetLog -> GetMissing -> recovery):

        1. **GetInfo**: poll every up OSD's pg-log head/tail (O(1) each).
           Peers whose head equals this primary's watermark contribute
           nothing further -- a clean, quiet cluster costs one tiny
           round-trip per OSD and NO object traffic.
        2. **GetLog**: for peers that advanced, fetch only the log entries
           above the watermark; the named objects (plus the engine's own
           missing-set of writes that skipped down shards) are the only
           candidates.  A watermark below the peer's log tail means the
           history was trimmed: fall back to a full ``pg_list`` scan --
           the reference's log-recovery vs backfill distinction.
        3. **GetMissing/recover**: probe versions for candidate objects
           only (``obj_versions``), compute the authoritative version,
           then roll back divergent (torn) entries via the target's own
           PG log where possible and push full shards otherwise.

        Returns the number of recovery actions attempted (0 == clean from
        this primary's perspective)."""
        from ceph_tpu_torch.utils.config import get_config

        if max_active is None:
            max_active = int(get_config().get_val("osd_recovery_max_active"))
        n_osds = len(self.osds)
        up_osds = [
            f"osd.{i}" for i in range(n_osds)
            if not self.messenger.is_down(f"osd.{i}")
        ]

        # -- stage 1: GetInfo ---------------------------------------------
        infos = await self._meta_roundtrip(
            up_osds, {"op": "pg_log_info"}, timeout=3.0
        )
        self.perf.inc("peering_info_poll")
        # incarnation check BEFORE any watermark is consulted (dup
        # watermarks included): a peer whose boot_id changed is a
        # RESTARTED process -- its log/dup sequence spaces are new, so
        # our per-peer watermarks against the old incarnation are
        # meaningless.  Reset them and force the backfill path; a
        # memstore daemon revived empty would otherwise read as a
        # "quiet peer" (head 0 <= watermark) and its lost shards would
        # never be discovered (the multi-process wipe case).
        restarted = False
        for osd_name, info in infos.items():
            bid = info.get("boot_id")
            if bid is None:
                continue  # pre-boot-id peer: legacy watermark rules
            known = self._peer_boot.get(osd_name)
            if known is not None and known != bid:
                self._peer_seq.pop(osd_name, None)
                self._peer_dup_seq.pop(osd_name, None)
                restarted = True
                self.perf.inc("peering_peer_restarted")
            self._peer_boot[osd_name] = bid
        # reqid-dup exchange rides GetInfo (both the delta and backfill
        # flows pass through here): fetch peers' dup entries above our
        # per-peer watermark so a just-promoted primary answers replayed
        # client ops with their original results (pg_log_dup_t exchange)
        await self._sync_dups(infos)
        candidates = set(self._dirty)
        meta_candidates = set(self._dirty_meta)
        pre_heads: Dict[str, int] = {}
        need_backfill = backfill or restarted
        # CRUSH epoch skew: the map changed since this engine last
        # peered (osd add/rm/out/reweight remapped acting sets with NO
        # log traffic) -- only a full scan finds the misplaced objects
        placement_epoch = getattr(self.placement, "epoch", None)
        if placement_epoch != self._placement_epoch:
            need_backfill = True
        fetches = []
        for osd_name, info in infos.items():
            head, tail = info["head_seq"], info["tail_seq"]
            pre_heads[osd_name] = head
            last = self._peer_seq.get(osd_name)
            if last is not None and head <= last:
                continue  # quiet peer
            if last is None:
                if head == 0 and not info.get("nonempty"):
                    self._peer_seq[osd_name] = 0  # brand-new empty OSD
                    continue
                need_backfill = True  # unknown history (daemon restart on
                continue              # a persistent store, revived peer)
            if last < tail:
                need_backfill = True  # log trimmed past the watermark
                continue
            fetches.append((osd_name, last))

        # -- stage 2: GetLog deltas (independent peers, one round-trip) ---
        if not need_backfill and fetches:
            results = await asyncio.gather(*(
                self._meta_roundtrip(
                    [osd_name],
                    {"op": "pg_log_entries", "from_seq": last},
                    timeout=3.0,
                )
                for osd_name, last in fetches
            ))
            for (osd_name, last), r in zip(fetches, results):
                rep = r.get(osd_name)
                if rep is None:
                    continue  # peer died mid-pass; the event retries
                if not rep["complete"]:
                    need_backfill = True
                    break
                maxseq = last
                for seq, base, tag, ver in rep["entries"]:
                    if tag == "meta":
                        meta_candidates.add(base)
                    else:
                        candidates.add(base)
                    maxseq = max(maxseq, seq)
                self._peer_seq[osd_name] = maxseq
                self.perf.inc("peering_delta_entries", len(rep["entries"]))

        if need_backfill:
            n = await self._peering_backfill(up_osds, max_active, pre_heads)
            # the scan covered the re-placed objects for THIS epoch;
            # advance only after it completes so a failed pass rescans.
            # Deliberately the CAPTURED epoch, not the live one: remaps
            # committed during the scan were not covered, and writing
            # the stale value forces the next pass to rescan them
            self._placement_epoch = placement_epoch  # cephlint: disable=async-rmw-across-await
            return n

        if not candidates and not meta_candidates:
            self.perf.inc("peering_pass")
            return 0

        # -- stage 3: targeted probe --------------------------------------
        oids = sorted(candidates | meta_candidates)
        replies = await self._meta_roundtrip(
            up_osds, {"op": "obj_versions", "oids": oids, "km": self.km},
            timeout=3.0,
        )
        self.perf.inc("peering_probe")
        have: Dict[str, Dict[int, Dict[str, tuple]]] = {}
        meta: Dict[str, Dict[str, int]] = {}
        for osd_name, r in replies.items():
            for base, info in r.get("objects", {}).items():
                if not self._pool_match(info.get("pool")):
                    continue  # another co-hosted pool's object
                for sh, ver in info["shards"].items():
                    have.setdefault(base, {}).setdefault(int(sh), {})[
                        osd_name
                    ] = vt(tuple(ver))
                if info["meta"] is not None and base in meta_candidates:
                    meta.setdefault(base, {})[osd_name] = info["meta"]
        # candidate objects with no copies anywhere (e.g. fully removed)
        for base in candidates:
            have.setdefault(base, {})
        return await self._peering_apply(
            have, meta, set(replies), max_active,
            tracked=candidates, tracked_meta=meta_candidates,
        )

    async def _sync_dups(self, infos: Dict[str, dict]) -> int:
        """Fetch and merge peers' reqid-dup entries newer than our
        per-peer watermarks into the hosting OSD's PG log (the peering
        dup exchange; reference: pg_log_dup_t travels with the log in
        GetLog, src/osd/PGLog.cc merge_log).  Returns entries merged."""
        if self._host_pglog is None:
            return 0
        fetches = [
            (osd_name, self._peer_dup_seq.get(osd_name, 0))
            for osd_name, info in infos.items()
            if osd_name != self.name
            and int(info.get("dup_head", 0)) >
            self._peer_dup_seq.get(osd_name, 0)
        ]
        if not fetches:
            return 0
        results = await asyncio.gather(*(
            self._meta_roundtrip(
                [osd_name], {"op": "pg_dups", "from_seq": last},
                timeout=3.0,
            )
            for osd_name, last in fetches
        ))
        merged = 0
        # merge + watermark advance are one indivisible step: a
        # concurrent peering pass that observes the advanced
        # _peer_dup_seq must be able to rely on these entries already
        # sitting in the host log -- a task switch between them would
        # let that pass skip (and never re-fetch) the gap.
        # cephlint: atomic-section peering-dup-merge
        for (osd_name, last), r in zip(fetches, results):
            rep = r.get(osd_name)
            if rep is None:
                continue  # peer died mid-pass; the next event retries
            maxseq = last
            for seq, reqid, result, d_oid, version in rep["dups"]:
                self._host_pglog.merge_dup(
                    tuple(reqid), result, d_oid,
                    tuple(version) if version is not None else None,
                )
                maxseq = max(maxseq, seq)
                merged += 1
            self._peer_dup_seq[osd_name] = max(
                maxseq, int(rep.get("head", 0)))
        # cephlint: end-atomic-section
        if merged:
            self.perf.inc("dup_entries_merged", merged)
        return merged

    async def _peering_backfill(self, up_osds, max_active,
                                pre_heads: Dict[str, int]) -> int:
        """Full-scan peering (the backfill path): every up OSD serializes
        its holdings via ``pg_list``.  Needed when the log cannot prove
        completeness -- primary restart, revived peer, trimmed log.  On
        success the per-peer watermarks jump to the pre-scan log heads, so
        subsequent passes are delta-driven again."""
        self.perf.inc("peering_backfill")
        self.pg_stats.backfilling = True
        replies = await self._meta_roundtrip(
            up_osds, {"op": "pg_list"}, timeout=3.0
        )
        have: Dict[str, Dict[int, Dict[str, tuple]]] = {}
        meta: Dict[str, Dict[str, int]] = {}
        for osd_name, r in replies.items():
            for ent in r.get("objects", []):
                # (base, shard, ver) untagged / (base, shard, ver, pool)
                base, shard, ver = ent[0], ent[1], ent[2]
                if len(ent) > 3 and not self._pool_match(ent[3]):
                    continue  # another co-hosted pool's object
                if shard == -1:
                    meta.setdefault(base, {})[osd_name] = ver[0]
                else:
                    have.setdefault(base, {}).setdefault(shard, {})[
                        osd_name
                    ] = vt(tuple(ver))
        try:
            n = await self._peering_apply(
                have, meta, set(replies), max_active,
                tracked=set(have) | self._dirty,
                tracked_meta=set(meta) | self._dirty_meta,
            )
        finally:
            self.pg_stats.backfilling = False
        # entries at or below the pre-scan heads are covered by the scan
        for osd_name in replies:
            h = pre_heads.get(osd_name)
            if h is not None:
                self._peer_seq[osd_name] = max(
                    self._peer_seq.get(osd_name, 0), h
                )
        return n

    async def _peering_apply(self, have, meta, reporting, max_active,
                             tracked=frozenset(),
                             tracked_meta=frozenset()) -> int:
        """Authoritative-version election + recovery execution over the
        gathered shard/meta version maps; maintains the engine's dirty
        sets (objects in ``tracked``/``tracked_meta`` that end the pass
        clean are dropped; unfinished ones are kept for the next event)."""

        def is_my_object(acting) -> bool:
            for s in range(self.km):
                if self._shard_up(acting, s):
                    return f"osd.{acting[s]}" == self.name
            return False

        actions = []  # (oid, shard, target_osd, authoritative, rollback)
        # relocation actions carry a 6th element: {position: holder_osd}
        # read-source overrides for shards living on non-acting OSDs
        reloc_actions = []
        unfinished: set = set()
        for oid in sorted(have):
            acting = self.acting_set(oid)
            if not is_my_object(acting):
                continue  # another OSD is this object's primary
            shardmap = have[oid]
            # placed copies only: a copy on a non-acting OSD (remap
            # leftover) cannot feed _gather_consistent
            counts: Dict[tuple, int] = {}
            unseen = 0
            placed: Dict[int, Optional[tuple]] = {}
            placed_down = False
            for s in range(self.km):
                if acting[s] is None:
                    continue
                holder = f"osd.{acting[s]}"
                if holder not in reporting:
                    unseen += 1
                    placed_down = True
                    continue
                v = shardmap.get(s, {}).get(holder)
                placed[s] = v
                if v is not None:
                    counts[v] = counts.get(v, 0) + 1
            # every copy anywhere (incl. non-acting remap leftovers), one
            # per distinct shard position, for the absent-object proof
            counts_any: Dict[tuple, int] = {}
            for s, holders in shardmap.items():
                best = max(holders.values(), default=None)
                if best is not None:
                    counts_any[best] = counts_any.get(best, 0) + 1
            if placed_down:
                unfinished.add(oid)  # probe again when the holder returns
            if not counts and not counts_any:
                continue
            authoritative = None
            if counts:
                authoritative = self._peering_authoritative(
                    counts, unseen, counts_any,
                    all_visible=len(reporting) >= len(self.osds),
                )
            # remap relocation (the backfill data plane of elastic
            # membership): the acting set cannot assemble the newest
            # version, but every up holder anywhere -- including
            # non-acting remap leftovers -- can.  With no acting holder
            # unreachable (nothing newer can be hiding), recover toward
            # that version reading from wherever the shards actually
            # are.  Without this, an object whose CRUSH placement moved
            # >= m+1 slots in one map change waits forever: the election
            # keeps answering "wait for remap recovery" and no such
            # mechanism would exist.
            relocate_src: Optional[Dict[int, int]] = None
            if authoritative is None and not placed_down:
                vstar, src = self._remap_sources(shardmap, reporting)
                if vstar is not None and len(src) >= self.k:
                    authoritative = vstar
                    relocate_src = src
            if authoritative is None:
                self.perf.inc("peering_wait")
                unfinished.add(oid)
                continue
            for s, cur in placed.items():
                if cur == authoritative:
                    continue
                if cur is None and tuple(authoritative) == (0, ""):
                    continue  # absent object, absent copy: nothing to do
                if cur is None and any(
                    holder not in (f"osd.{acting[s]}",)
                    for holder in shardmap.get(s, {})
                ):
                    # the acting slot lost the shard but a copy still
                    # exists on a non-acting holder (remap leftover):
                    # data is safe, just in the wrong place -- the
                    # pg_stat_t misplaced (not degraded) distinction
                    self.pg_stats.misplaced.add(oid)
                if relocate_src is not None:
                    reloc_actions.append(
                        (oid, s, acting[s], authoritative,
                         cur is not None and cur > authoritative,
                         relocate_src)
                    )
                else:
                    actions.append(
                        (oid, s, acting[s], authoritative,
                         cur is not None and cur > authoritative)
                    )

        meta_actions = []  # (oid, stale_targets)
        unfinished_meta: set = set()
        for oid, holders in meta.items():
            acting = self.acting_set(oid)
            if not is_my_object(acting):
                continue
            newest = max(holders.values())
            try:
                targets = self._meta_targets(oid)
            except IOError:
                unfinished_meta.add(oid)
                continue
            if any(
                acting[s] is not None and not self._shard_up(acting, s)
                for s in range(self.km)
            ):
                unfinished_meta.add(oid)  # a down replica will need this
            stale = [t for t in targets if holders.get(t, 0) < newest]
            if stale:
                meta_actions.append((oid, stale))

        # in-flight rebuild accounting: the action objects count as
        # degraded from here until their recovery completes (the
        # per-object note_recovered calls below and in osd/recovery.py
        # drain the count monotonically while a rebuild runs)
        action_oids = {a[0] for a in actions} | \
            {a[0] for a in reloc_actions} | \
            {m[0] for m in meta_actions}
        self.pg_stats.note_recovering(action_oids)
        failed: set = set()
        if actions and self._use_batched_recovery():
            # the batched background data plane (osd/recovery.py):
            # corked multi-read gather, fused decode, corked multi-push
            # -- throttled against client traffic; objects it cannot
            # prove consistent fall back to the per-object path inside
            failed |= await self._recovery().recover_actions(actions)
            actions = []
        if actions or reloc_actions or meta_actions:
            sem = asyncio.Semaphore(max_active)

            async def recover_one(oid, s, target, authoritative, rb,
                                  sources=None):
                async with sem:
                    try:
                        if rb and await self._try_log_rollback(
                            oid, s, target, authoritative
                        ):
                            self.pg_stats.note_recovered(oid)
                            return
                        if tuple(authoritative) == (0, ""):
                            # no assemblable object behind the torn copy:
                            # nothing to reconstruct, just drop it
                            await self._remove_shard_copy(oid, s, target)
                            self.pg_stats.note_recovered(oid)
                            return
                        await self.recover_shard(
                            oid, s, target, rollback=rb, sources=sources
                        )
                        self.pg_stats.note_recovered(oid)
                    except asyncio.CancelledError:
                        raise
                    except Exception:  # noqa: BLE001 -- a failed recovery
                        # stays pending; the next peering pass retries
                        self.perf.inc("recover_failed")
                        failed.add(oid)

            async def recover_meta(oid, stale):
                async with sem:
                    try:
                        # full-state re-apply: replicas converge in one
                        # step; a removal tombstone propagates AS a
                        # tombstone (re-applying it as a plain write
                        # would resurrect the deleted name)
                        omap, ver, removed = await self._meta_read_full(oid)
                        await self._meta_roundtrip(stale, {
                            "op": "meta_apply", "oid": oid,
                            "version": ver, "omap": omap,
                            "remove": removed,
                        })
                        self.pg_stats.note_recovered(oid)
                    except asyncio.CancelledError:
                        raise
                    except Exception:  # noqa: BLE001
                        self.perf.inc("recover_failed")
                        failed.add(oid)

            await asyncio.gather(
                *(recover_one(*a) for a in actions),
                *(recover_one(*a) for a in reloc_actions),
                *(recover_meta(*m) for m in meta_actions),
            )

        # dirty-set maintenance (pg_missing_t bookkeeping)
        for oid in tracked:
            if oid in unfinished or oid in failed:
                self._dirty.add(oid)
            else:
                self._dirty.discard(oid)
        for oid in tracked_meta:
            if oid in unfinished_meta or oid in failed:
                self._dirty_meta.add(oid)
            else:
                self._dirty_meta.discard(oid)
        # pg-stat epilogue mirroring the dirty maintenance: tracked
        # objects that ended the pass clean drop their degraded
        # markings (liveness victims included); unfinished ones stay
        self.pg_stats.end_pass(
            set(tracked) | set(tracked_meta) | action_oids,
            unfinished | unfinished_meta | failed,
        )
        self.perf.inc("peering_pass")
        return len(actions) + len(reloc_actions) + len(meta_actions)

    async def _remove_shard_copy(self, oid: str, s: int,
                                 target: int) -> None:
        """Remove a provably-torn or leftover shard copy whose object has
        no assemblable authoritative version (divergent create / remove
        leftover): the rollback target is non-existence."""
        soid = shard_oid(oid, s)
        tid = self._new_tid()
        sub = ECSubWrite(
            from_shard=s, tid=tid, oid=oid,
            transaction=Transaction().remove(soid),
            at_version=(0, ""), op_class="recovery", rollback=True,
        )
        await self._fanout_commit(
            oid, tid, [(f"osd.{target}", sub)], {f"osd.{target}"},
            min_acks=1,
        )
        self.perf.inc("remove_torn_copy")

    async def _try_log_rollback(self, oid: str, s: int, target: int,
                                to_version: tuple) -> bool:
        """Ask the divergent shard's OSD to roll its torn entries back
        from its own PG log (truncate + attr restore); True on success.
        False (missing/trimmed/overwrite history) -> caller re-pushes the
        shard.  Reference: divergent-entry rollback,
        src/osd/PGLog.h / ECTransaction rollback records."""
        r = await self._meta_roundtrip(
            [f"osd.{target}"],
            {"op": "pg_rollback", "soid": shard_oid(oid, s),
             "to_version": tuple(to_version)},
            timeout=3.0,
        )
        rep = r.get(f"osd.{target}")
        return bool(rep and rep.get("ok"))

    # -- client-op service (the PrimaryLogPG do_op role) -------------------

    async def client_op(self, msg: dict):
        """Execute one client op routed here by an Objecter.

        Reference: PrimaryLogPG::do_op (src/osd/PrimaryLogPG.cc:1844) --
        the primary OSD owns the PG and executes the op, fanning sub-ops
        to the acting set.  Returns the op's wire-encodable result."""
        kind = msg["kind"]
        reqid = msg.get("reqid")
        qtoken = None
        if msg.get("qos_class"):
            # the op's QoS sub-class travels to its own fan-outs (every
            # kind: reads schedule under the class too)
            qtoken = _OP_QOS.set(msg["qos_class"])
        try:
            if reqid is not None and kind in REQID_FANOUT_KINDS:
                # visible to this op's own fan-outs only (task-scoped);
                # composite kinds (exec/snap_trim) run reqid-free
                # internals
                token = _OP_REQID.set(tuple(reqid))
                try:
                    return await self._client_op_inner(msg)
                finally:
                    _OP_REQID.reset(token)
            return await self._client_op_inner(msg)
        finally:
            if qtoken is not None:
                _OP_QOS.reset(qtoken)

    async def _client_op_inner(self, msg: dict):
        kind = msg["kind"]
        oid = msg.get("oid", "")
        snap = msg.get("snap")
        if snap is not None and kind in ("read", "read_range", "stat"):
            # snap reads resolve to the serving clone (find_object_context)
            oid = await self.resolve_snap(oid, snap)
        if kind == "write":
            await self.write(oid, msg["data"], snapc=msg.get("snapc"))
        elif kind == "read":
            return await self.read(oid)
        elif kind == "write_range":
            await self.write_range(oid, msg["offset"], msg["data"],
                                   snapc=msg.get("snapc"))
        elif kind == "read_range":
            return await self.read_range(oid, msg["offset"], msg["length"])
        elif kind == "remove":
            await self.remove_object(oid, snapc=msg.get("snapc"))
        elif kind == "stat":
            size, hinfo = await self._stat(oid)
            return (size, hinfo)
        elif kind == "snap_rollback":
            await self.snap_rollback(oid, msg["snapid"],
                                     snapc=msg.get("snapc"))
        elif kind == "snap_trim":
            return await self.snap_trim(oid, msg["live_snaps"])
        elif kind == "list_snaps":
            return await self.list_snaps(oid)
        elif kind == "scrub":
            return await self.deep_scrub(oid)
        elif kind == "recover":
            await self.recover_shard(oid, msg["shard"], msg["target"])
        elif kind == "omap_set":
            await self.omap_set(oid, msg["kvs"])
        elif kind == "omap_get":
            return await self.omap_get(oid, msg.get("keys"))
        elif kind == "omap_rm":
            await self.omap_rm(oid, msg["keys"])
        elif kind == "omap_clear":
            await self.omap_clear(oid)
        elif kind == "omap_cas":
            ok, cur = await self.omap_cas(
                oid, msg["key"], msg["expect"], msg["new"]
            )
            return (ok, cur)
        elif kind == "exec":
            ret, out = await self.exec(
                oid, msg["cls"], msg["method"], msg["inp"]
            )
            return (ret, out)
        elif kind == "watch":
            await self.watch(oid, watcher=msg["watcher"])
        elif kind == "unwatch":
            await self.unwatch(oid, watcher=msg["watcher"])
        elif kind == "notify":
            return await self.notify(
                oid, msg.get("payload"),
                msg.get("timeout_ms", 5000) / 1000.0,
            )
        else:
            raise ValueError(f"unknown client op {kind!r}")
        return None
