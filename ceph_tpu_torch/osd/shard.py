"""OSD daemon shard: op queue, sub-op service, ticks (the OSD role).

Port of ``ceph_tpu/osd/shard.py``.

Reference: src/osd/OSD.{h,cc} -- ShardedOpWQ dispatch (OSD.h:1566), the
tick loop (OSD::tick), scrub scheduling, heartbeat fast-dispatch -- plus
the replica-side sub-op handlers (ECBackend::handle_sub_write/:922,
handle_sub_read/:987, which are strategy-agnostic here: a replicated
pool's full-copy sub-ops ride the same version-gated transaction apply).

Kept apart from ecbackend.py so the primary-engine strategies
(EC / replicated) and the daemon role can evolve independently -- the
reference's OSD vs PG/PGBackend layering (src/osd/PGBackend.cc:533).
"""

from __future__ import annotations

import asyncio
import os
import time
from typing import Dict

from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.osd.messenger import Messenger
from ceph_tpu_torch.osd.pg import (
    MCLOCK_DEFAULTS,
    OP_PRIORITY,
    POOL_KEY,
    SIZE_KEY,
    SNAPSET_KEY,
    VERSION_KEY,
    WHITEOUT_KEY,
    shard_oid,
    vt,
)
from ceph_tpu_torch.osd.types import (
    ECSubRead,
    ECSubReadReply,
    ECSubWrite,
    ECSubWriteReply,
    Transaction,
)
from ceph_tpu_torch.native.gf_native import crc32c
from ceph_tpu_torch.profiling import ledger as _profiler
from ceph_tpu_torch.utils import trace
from ceph_tpu_torch.utils.perf import PerfCounters, stage_histogram

#: wire-tax cost centers for the OSD execution seam (fetched once; a
#: global-bool branch when profiling is off).  ``osd.op_exec`` bills the
#: per-op bookkeeping sections of the one-at-a-time path;
#: ``osd.batch_exec`` bills the array passes of the batched fast path --
#: the pair is what the bench's OSD-exec share A/B compares.  Markers
#: never span an await (exclusive-time protocol).
_PS_OP = _profiler.stage("osd.op_exec")
_PS_BATCH = _profiler.stage("osd.batch_exec")

#: client-op kinds subject to reqid dup detection: every kind that
#: mutates state (re-executing a replay would double-apply or return a
#: post-apply answer).  Reads and watch bookkeeping stay dedup-free,
#: like the reference (only logged ops get pg_log_dup_t entries).
MUTATING_KINDS = frozenset({
    "write", "write_range", "remove", "snap_rollback", "snap_trim",
    "omap_set", "omap_rm", "omap_clear", "omap_cas", "exec",
})

#: composite kinds whose result is only known at completion: their dup
#: entries are pushed to the acting set by an explicit awaited
#: ``dup_record`` fan-out before the reply (everything else records
#: dups on the fan-out that performs the mutation -- zero extra RTT)
_RESULT_FANOUT_KINDS = frozenset({"exec", "snap_trim"})


class OSDShard:
    """One OSD daemon holding one shard position per object it stores.

    Incoming EC sub-ops pass through a QoS op queue served by a worker
    loop — the ShardedOpWQ role (reference src/osd/OSD.h:1566), with the
    queue discipline selected like ``osd_op_queue``: ``wpq`` (default) or
    ``mclock`` (src/osd/mClockOpClassQueue).  Heartbeat pings bypass the
    queue (the reference's fast-dispatch path).
    """

    def __init__(self, osd_id: int, messenger: Messenger,
                 op_queue: str = "wpq", objectstore: str = "memstore",
                 data_path: str = "", device="cuda"):
        from ceph_tpu_torch.osd.opqueue import MClockQueue, WeightedPriorityQueue
        from ceph_tpu_torch.osd.pglog import PGLog
        from ceph_tpu_torch.utils.optracker import OpTracker

        self.osd_id = osd_id
        self.name = f"osd.{osd_id}"
        #: per-incarnation nonce (the reference's up_from epoch role):
        #: carried in pg_log_info replies so peers detect a RESTARTED
        #: daemon -- its in-memory log sequence space is new, so their
        #: watermarks against the old incarnation are meaningless and
        #: peering must take the backfill path (the multi-process
        #: kill+revive wipe case: a memstore daemon revives empty with
        #: head_seq 0, which would otherwise read as "quiet peer")
        self.boot_id = os.urandom(8).hex()
        # reference ObjectStore::create (src/os/ObjectStore.cc:63): backend
        # chosen by name, data under the osd's own dir.  An empty data_path
        # propagates as-is so the factory rejects pathless persistent
        # backends instead of writing under the filesystem root.
        from ceph_tpu_torch import objectstore as os_mod

        self.store = os_mod.create(
            objectstore, f"{data_path}/osd.{osd_id}" if data_path else ""
        )
        self.messenger = messenger
        self.perf = PerfCounters(f"osd.{osd_id}")
        self.pglog = PGLog()
        #: per-shard-object applied version tuple (counter, writer): the
        #: QoS queue may legally reorder a low-priority recovery push
        #: behind a newer client write, and racing primaries may deliver
        #: writes out of version order, so applies are version-gated
        #: (reference: recovery pushes carry the object version and PG
        #: logic discards stale ones; primaries racing is impossible in
        #: the reference because one primary OSD serializes a PG)
        self._applied_version: Dict[str, tuple] = {}
        #: watch/notify state (reference src/osd/Watch.cc): oid -> watchers
        self.watches: Dict[str, Dict[str, bool]] = {}
        self._notify_seq = 0
        self._notify_pending: Dict[int, tuple] = {}
        #: OSD-side meta_apply fan-out acks (CAS replication authority)
        self._meta_tid = 0
        self._meta_pending: Dict[int, tuple] = {}
        self.optracker = OpTracker(perf=self.perf, name=self.name)
        #: peer name -> last heartbeat pong time (handle_osd_ping role)
        self.hb_pongs: Dict[str, float] = {}
        #: entity -> OSDCap; entities absent here run with the open
        #: default (client.admin allow *).  Populated via
        #: set_client_caps from keyring "caps osd" strings.
        self.client_caps: Dict[str, object] = {}
        # 2D latency x size grid (PerfHistogram<2>, dumped by the
        # admin-socket `perf histogram dump` like l_osd_op_*_lat_*)
        from ceph_tpu_torch.utils.perf import HistogramAxis, PerfHistogram

        self.op_hist = PerfHistogram(
            f"osd.{osd_id}.op_latency_size",
            HistogramAxis("latency_usec", 0, 64, 32, "log2"),
            HistogramAxis("size_bytes", 0, 512, 24, "log2"),
        )
        # per-stage latency attribution (docs/observability.md): these
        # feed the prometheus _bucket/_sum/_count series the mgr module
        # exposes, and mirror the trace-span segments
        self.h_queue_wait = stage_histogram(
            f"osd.{osd_id}.op_queue_wait_usec")
        self.h_dispatch = stage_histogram(
            f"osd.{osd_id}.op_dispatch_usec")
        # object-access temperature tracking (src/osd/HitSet.h; feeds
        # the tiering-agent role and the admin-socket hit_set commands)
        from ceph_tpu_torch.osd.hitset import HitSetTracker

        self.hitsets = HitSetTracker()
        # device-resident cache tier (ceph_tpu_torch/tier/): hot objects'
        # encoded shards stay in device memory (on ``device``: the card
        # unless the caller asked for the CPU), byte-budgeted against
        # the process-wide device ledger; the agent (tier_tick) promotes
        # / flushes / evicts by hit-set temperature.  temp_fn late-binds
        # through self so a swapped tracker is picked up.
        from ceph_tpu_torch.tier.device_tier import DeviceTierStore

        self.tier = DeviceTierStore(
            perf=self.perf,
            temp_fn=lambda pool, oid: self.hitsets.temperature(oid),
            device=device,
        )
        self.tier_agent = None  # built lazily on the first active tick
        self.op_queue_type = op_queue
        if op_queue == "mclock":
            # the base classes keep their legacy 4KiB-unit rates; the
            # osd_qos_profile's EXTRA classes (client sub-classes like
            # gold/bulk) join scaled from MiB/s to 4KiB units so one
            # profile string governs both the op queue and the unified
            # admission layer
            from ceph_tpu_torch.osd.qos import parse_profile

            classes = dict(MCLOCK_DEFAULTS)
            for kname, (res, wgt, lim) in parse_profile().items():
                if kname not in classes:
                    classes[kname] = (res * 256.0, wgt, lim * 256.0)
            self.opq = MClockQueue(classes)
        else:
            self.opq = WeightedPriorityQueue()
        # unified QoS admission (osd/qos.py, osd_qos_unified): the
        # dmClock tags become the data plane's admission stage --
        # ``qos`` grants BATCH dispatches (coalesced client encodes,
        # recovery cycles, scrub rounds; counted per batch for the
        # recovery/scrub classes), ``qos_ops`` grants client-op
        # execution slots in tag order by the op's qos_class (counted
        # per op).  Two slot pools, one profile: an op holding an
        # execution slot may wait on a batch slot but never the other
        # way around, so no admission cycle can form.
        from ceph_tpu_torch.utils.config import get_config as _get_config

        self.qos = None
        self.qos_ops = None
        if bool(_get_config().get_val("osd_qos_unified")):
            from ceph_tpu_torch.osd.qos import (QoSAdmission, parse_profile,
                                          profile_bytes_per_s)

            qclasses = profile_bytes_per_s(parse_profile())
            self.qos = QoSAdmission(
                classes=qclasses, perf=self.perf,
                perf_classes={"recovery", "scrub"},
            )
            self.qos_ops = QoSAdmission(
                slots=int(_get_config().get_val("osd_qos_op_slots")),
                classes=qclasses, perf=self.perf,
                perf_classes=set(qclasses) - {"recovery", "scrub"},
            )
        self._op_event = asyncio.Event()
        #: background-scrub rotating cursor (PG scrub scheduling role)
        self._scrub_cursor = 0
        #: simulates a hung daemon: alive on the wire but never responding
        #: (what OSD heartbeats exist to catch, reference OSD.cc:4612
        #: handle_osd_ping / HeartbeatMap suicide timeouts)
        self.frozen = False
        #: pools this OSD can act as PRIMARY for: pool name -> hosted
        #: ECBackend engine (the PrimaryLogPG role; reference
        #: src/osd/PGBackend.cc:533 build_pg_backend per PG)
        self.pools: Dict[str, "ECBackend"] = {}
        #: per-pool PG activity state ("active" | "peering"): while a
        #: pool is peering after a liveness event, client ops get an
        #: explicit ``backoff`` reply instead of queueing (the RADOS PG
        #: backoff protocol, src/osd/osd_types.h Backoff); engaged only
        #: while the background tick loop runs (see request_peering)
        self.pg_states: Dict[str, str] = {}
        #: pool -> client entities holding a backoff, released with one
        #: ``backoff_release`` each when the pool reactivates
        self._backoffs: Dict[str, set] = {}
        #: shared tid space across hosted backends so a forwarded reply
        #: matches exactly one engine's pending op
        self._host_tid = 0
        #: bound on concurrently executing client ops (the osd_op_tp
        #: thread-count role)
        self._cop_sem = asyncio.Semaphore(64)
        self._cop_seq = 0
        #: array-batched client-op execution (osd_op_batch_exec): the
        #: worker drains same-kind client-op RUNS off the queue and runs
        #: their bookkeeping as batch passes -- one optracker request,
        #: one dups-registry scan, per-class amortized QoS admission,
        #: one corked reply burst (resolved once per daemon; the bench
        #: builds a fresh harness per A/B mode)
        self._batch_exec = bool(_get_config().get_val("osd_op_batch_exec"))
        self._batch_max = max(1, int(_get_config().get_val(
            "osd_op_batch_max")))
        #: queued-or-executing client ops (the background throttle's
        #: saturation signal: recovery/scrub batches back off while
        #: this is high -- osd/recovery.py BackgroundThrottle)
        self._client_ops_queued = 0
        messenger.register(self.name, self.dispatch)
        messenger.adopt_task(
            f"{self.name}.opwq",
            asyncio.get_event_loop().create_task(self._op_worker()),
        )

    def _next_host_tid(self) -> int:
        self._host_tid += 1
        return self._host_tid

    def host_pool(self, pool: str, ec, n_osds: int, placement=None,
                  pool_type: str = "erasure", size: int = 3,
                  min_size=None):
        """Attach a primary engine for ``pool`` to this OSD.  Every OSD in
        the cluster hosts one; clients route each op to the object's
        current primary (first up shard of the acting set).

        ``pool_type`` selects the PGBackend strategy like the reference's
        build_pg_backend switch (src/osd/PGBackend.cc:533-570):
        "erasure" -> ECBackend driven by the ``ec`` codec;
        "replicated" -> ReplicatedBackend with ``size`` full copies
        (``ec`` is ignored)."""
        if pool_type == "replicated":
            from ceph_tpu_torch.osd.replicated import ReplicatedBackend

            backend = ReplicatedBackend(
                size, list(range(n_osds)), self.messenger, name=self.name,
                placement=placement, register=False,
                tid_alloc=self._next_host_tid, perf=self.perf,
                min_size=min_size,
            )
        else:
            from ceph_tpu_torch.osd.ecbackend import ECBackend

            backend = ECBackend(
                ec, list(range(n_osds)), self.messenger, name=self.name,
                placement=placement, register=False,
                tid_alloc=self._next_host_tid, perf=self.perf,
                min_size=min_size,
            )
        backend.pool_name = pool
        # exactly-once hookup: the engine's peering pass merges peers'
        # reqid-dup entries into THIS daemon's PG log, so a promotion
        # to primary answers replayed client ops from the log
        backend._host_pglog = self.pglog
        self.pg_states[pool] = "active"
        # cache-tier hookup: the engine serves tier hits / write-through
        # updates against this OSD's store, and feeds the hit sets the
        # agent ranks temperature from (late-bound lambdas: replacing
        # self.hitsets mid-test must redirect the feeds too)
        backend._tier = self.tier
        backend._hitset_record = lambda oid: self.hitsets.record(oid)
        backend._hitset_temp = lambda oid: self.hitsets.temperature(oid)
        # background-throttle hookup: the engine's recovery/scrub
        # batches consult THIS daemon's client-queue depth to back off
        # under saturation (osd/recovery.py BackgroundThrottle)
        backend._host_shard = self
        # unified QoS hookup: the engine's codec coalescers admit each
        # fused batch through this daemon's dmClock slots (the
        # batching-and-QoS-as-one-layer fusion, osd/qos.py); the
        # recovery/scrub paths reach the same admission via
        # _host_shard.qos inside the BackgroundThrottle
        if self.qos is not None:
            for co in (getattr(backend, "_enc_coalescer", None),
                       getattr(backend, "_dec_coalescer", None)):
                if co is not None:
                    co.admission = self.qos
        # mesh data plane membership (osd_mesh_data_plane): bind this
        # daemon to a mesh device slot so its PG-shard slice lives on
        # (and its inbound chunks are delivered through) the device
        # plane; daemons past the slot count stay out-of-mesh and keep
        # the wire path
        from ceph_tpu_torch.parallel import mesh_plane as mesh_mod

        plane = mesh_mod.current_plane()
        if plane is not None:
            plane.bind(self.name)
        self.pools[pool] = backend
        return backend

    def set_client_caps(self, entity: str, caps: str) -> None:
        """Confine ``entity``'s client ops to an OSDCap string (the
        keyring 'caps osd' line, ref src/osd/OSDCap.h)."""
        from ceph_tpu_torch.auth.caps import OSDCap

        self.client_caps[entity] = OSDCap.parse(caps)

    # -- background tick: peering-driven recovery (OSD::tick role) ---------

    def start_tick(self, interval: float = None) -> None:
        """Start the background tick loop (reference OSD::tick,
        src/osd/OSD.cc): each tick runs a peering pass over the hosted
        pools, auto-recovering missing/stale shards.  Idempotent."""
        if getattr(self, "_tick_task", None) is not None:
            return
        if interval is None:
            from ceph_tpu_torch.utils.config import get_config

            interval = float(get_config().get_val("osd_tick_interval"))
        self._tick_interval = interval
        self._peer_event = asyncio.Event()
        self._tick_task = asyncio.get_event_loop().create_task(
            self._tick_loop()
        )
        self.messenger.adopt_task(f"{self.name}.tick", self._tick_task)

    def request_peering(self) -> None:
        """Wake the peering loop NOW (event-driven peering: OSDMap epoch
        change, OSD up/down -- the reference re-peers on every map change,
        src/osd/PG.cc peering state machine, instead of waiting out a
        timer).  No-op until start_tick has run.

        While the loop is running, a liveness event also flips every
        hosted pool to "peering": client ops arriving before the next
        pass completes get an explicit backoff instead of racing the
        role handoff (the RADOS PG backoff protocol; a replayed op must
        not be served until the dup exchange and divergent-entry
        rollback of peering have run)."""
        ev = getattr(self, "_peer_event", None)
        if ev is not None:
            for pool in self.pools:
                if self.pg_states.get(pool) != "peering":
                    self.pg_states[pool] = "peering"
                    self.perf.inc("pg_peering")
            ev.set()

    async def _tick_loop(self) -> None:
        while True:
            try:
                await self.peering_tick()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 -- a failed pass must not
                # kill the loop; state is retried next tick
                import sys
                import traceback

                traceback.print_exc(file=sys.stderr)
            # sleep until the next scheduled tick OR a peering event
            # (up/down/map change) -- whichever comes first
            try:
                await asyncio.wait_for(
                    self._peer_event.wait(), timeout=self._tick_interval
                )
            except asyncio.TimeoutError:
                pass
            self._peer_event.clear()

    async def peering_tick(self) -> int:
        """One peering round over every hosted pool, then a rate-limited
        background deep-scrub slice; returns the number of recovery
        actions attempted."""
        if self.frozen or self.messenger.is_down(self.name):
            return 0
        total = 0
        for pool, backend in list(self.pools.items()):
            total += await backend.peering_pass()
            # the pass completed (dup exchange + authority election +
            # recovery kickoff): the pool is active again -- release
            # every client parked on a backoff so their ops resend the
            # moment the PG is serviceable (RADOS backoff_release)
            if self.pg_states.get(pool) == "peering":
                await self._activate_pool(pool)
        total += await self.scrub_tick()
        total += await self.tier_tick()
        return total

    async def _activate_pool(self, pool: str) -> None:
        self.pg_states[pool] = "active"
        for client in sorted(self._backoffs.pop(pool, ())):
            await self.messenger.send_message(self.name, client, {
                "op": "backoff_release", "pool": pool, "from": self.name,
            })
            self.perf.inc("backoff_release_sent")

    def _scrub_base_list(self):
        """Base-oid list for the scrub cursor; rebuilt only when the
        cursor wraps (a fresh listing every tick would pay O(objects)
        to pick osd_scrub_objects_per_tick of them)."""
        cached = getattr(self, "_scrub_bases", None)
        if cached is None or self._scrub_cursor == 0 or                 self._scrub_cursor >= len(cached):
            bases = set()
            tags: Dict[str, object] = {}
            for stored in self.store.list_objects():
                base, _, tag = stored.rpartition("@")
                if base and tag.isdigit():
                    bases.add(base)
                    if base not in tags:
                        # pool membership of the base (co-hosted pools
                        # must not scrub each other's objects)
                        tags[base] = self.store.getattr(stored, POOL_KEY)
            cached = sorted(bases)
            self._scrub_bases = cached
            self._scrub_pool_tags = tags
            self._scrub_cursor = min(self._scrub_cursor, len(cached))                 if cached else 0
        return cached

    async def scrub_tick(self) -> int:
        """Background deep-scrub scheduler (reference: PG scrub
        reservation/scheduling, src/osd/PG.cc): each tick deep-scrubs up
        to ``osd_scrub_objects_per_tick`` objects this OSD is currently
        PRIMARY for (rotating cursor over the local store), tagged with
        the mClock ``scrub`` op class, and feeds any inconsistency
        straight into shard recovery -- the cluster heals silent
        corruption with no manual call (qa test-erasure-eio role)."""
        from ceph_tpu_torch.utils.config import get_config

        limit = int(get_config().get_val("osd_scrub_objects_per_tick"))
        if limit <= 0 or not self.pools:
            return 0
        # error records for objects this OSD no longer leads pin mgr
        # health forever (the new primary re-detects real damage): drop
        for backend in self.pools.values():
            for e_oid in list(backend.scrub_errors):
                e_acting = backend.acting_set(e_oid)
                lead = None
                for sh in range(backend.km):
                    if backend._shard_up(e_acting, sh):
                        lead = f"osd.{e_acting[sh]}"
                        break
                if lead != self.name:
                    backend.scrub_errors.pop(e_oid, None)
        bases = self._scrub_base_list()
        if not bases:
            return 0
        repaired = 0
        scanned = 0
        n = len(bases)
        # phase 1 -- candidate collection (no awaits: the cursor walk
        # stays consistent); the slice's objects then ride ONE batched
        # chunk-cursor read per backend instead of one whole-shard
        # fan-out each (the background data plane)
        slices: Dict[object, list] = {}
        for _ in range(n):
            if scanned >= limit:
                break
            base = bases[self._scrub_cursor % n]
            self._scrub_cursor = (self._scrub_cursor % n + 1) % n
            base_tag = getattr(self, "_scrub_pool_tags", {}).get(base)
            for backend in self.pools.values():
                if not backend._pool_match(base_tag):
                    continue  # another co-hosted pool's object
                acting = backend.acting_set(base)
                primary = None
                for sh in range(backend.km):
                    if backend._shard_up(acting, sh):
                        primary = f"osd.{acting[sh]}"
                        break
                if primary != self.name:
                    continue
                scanned += 1
                slices.setdefault(id(backend), (backend, []))[1].append(
                    base)
                break
        # phase 2 -- batched scrub + repair per backend
        for backend, oids in slices.values():
            try:
                reports = await backend.deep_scrub_many(oids)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 -- scrub must not kill
                # the tick (e.g. a degraded object mid-recovery)
                self.perf.inc("scrub_failed")
                continue
            for base in oids:
                report = reports.get(base)
                if report is None or report["ok"]:
                    continue
                try:
                    repaired += await backend.scrub_repair(base, report)
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 -- a failed repair
                    # stays in scrub_errors; the next slice retries
                    self.perf.inc("scrub_failed")
        return repaired

    async def tier_tick(self) -> int:
        """Cache-tier agent slice (peer of scrub_tick; the reference's
        agent_work runs on the same background cadence): flush abandoned
        dirty entries, promote hot objects this OSD leads in one batched
        device transfer, evict back under osd_tier_hbm_bytes.  No-op
        until some hosted pool's cache mode is writeback/readproxy.
        Returns objects promoted (the tick's action count)."""
        if not any(
            getattr(b, "tier_mode", "none") != "none"
            for b in self.pools.values()
        ):
            return 0
        if self.tier_agent is None:
            from ceph_tpu_torch.tier.agent import TierAgent

            self.tier_agent = TierAgent(self)
        try:
            stats = await self.tier_agent.tick()
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 -- a failed agent round must
            # not kill the tick loop; the next tick retries
            self.perf.inc("tier_agent_failed")
            return 0
        return int(stats.get("promoted", 0))

    def mgr_report_stats(self) -> dict:
        """The MgrReport payload for this daemon (mgr/report.py schema).

        Everything here is O(counters): store totals are maintained
        incrementally by the object stores, per-PG degraded/misplaced
        counts by the pg_stats seams -- building a report NEVER walks
        the object store (tests/test_torch_mgr.py pins it with a store
        whose listing raises).

        The ``residency`` slice is the port's transfer ledger, which
        counts ``library_builds`` where the JAX package's counts
        ``jit_retraces``.  It is read without a guard: the ledger is a
        port module, and a failed read must show, not vanish from the
        report.
        """
        from ceph_tpu_torch import profiling
        from ceph_tpu_torch.analysis import residency
        from ceph_tpu_torch.mgr.report import (REPORT_SCHEMA_VERSION,
                                               filter_counters)
        from ceph_tpu_torch.utils.perf import histogram_marginals

        tier = self.tier.status()
        stats = {
            "v": REPORT_SCHEMA_VERSION,
            "kind": "osd",
            "boot_id": self.boot_id,
            "store": dict(self.store.stats()),
            "perf": filter_counters(self.perf.snapshot()),
            "pgs": {
                pool: backend.pg_stats.pg_stat()
                for pool, backend in self.pools.items()
            },
            "ops_in_flight": self.optracker.num_inflight(),
            # scalar tier residency only (the full per-object listing
            # stays an admin-socket affair)
            "tier": {key: tier[key] for key in
                     ("resident_bytes", "budget", "entries", "dirty",
                      "hit", "miss")},
            "hist": histogram_marginals(f"osd.{self.osd_id}."),
            # residency-ledger counters ride along; co-located daemons
            # share one process ledger, so the mgr labels but does not
            # sum these across daemons of one process
            "residency": dict(residency.counters().snapshot()),
        }
        # stage-profiler slice: per-stage ns + loop/GC scalars; None
        # (omitted) when profile_mode is off.  Same one-ledger-per-process
        # caveat as residency.
        prof_slice = profiling.report_slice()
        if prof_slice is not None:
            stats["profile"] = prof_slice
        return stats

    def _op_cost(self, msg) -> int:
        if isinstance(msg, ECSubWrite):
            return max(
                1,
                sum(len(op.data) for op in msg.transaction.ops) // 4096,
            )
        return 1

    async def dispatch(self, src: str, msg) -> None:
        if self.frozen:
            return
        if msg == "ping":
            # fast dispatch: heartbeats never sit behind the op queue
            await self.messenger.send_message(self.name, src, ("pong", self.name))
            return
        if isinstance(msg, tuple) and msg and msg[0] == "pong":
            # peer heartbeat answer (the mon-integrated daemon's
            # heartbeat loop reads these timestamps)
            self.hb_pongs[msg[1]] = asyncio.get_event_loop().time()
            return
        if isinstance(msg, (ECSubWriteReply, ECSubReadReply)):
            # this OSD is acting as a primary: forward sub-op replies to
            # the hosted engines (shared tid space -> exactly one matches)
            for backend in self.pools.values():
                await backend.dispatch(src, msg)
            return
        if isinstance(msg, dict) and "op" in msg:
            op = msg["op"]
            if op == "client_op":
                # RADOS PG backoff: while the pool is peering after a
                # liveness event, answer with an explicit backoff frame
                # instead of queueing -- the client parks the op and
                # resends on our backoff_release, rather than burning
                # probe slices against a PG mid-role-handoff (reference
                # src/osd/PrimaryLogPG.cc maybe_add_backoff).  The
                # dispatch-throttle budget is never claimed here, so the
                # transport's own release path returns it.
                pool = msg.get("pool") or ""
                if pool not in self.pools and self.pools:
                    pool = next(iter(self.pools))
                if self.pg_states.get(pool) == "peering":
                    self._backoffs.setdefault(pool, set()).add(src)
                    self.perf.inc("backoff_sent")
                    await self.messenger.send_message(self.name, src, {
                        "op": "backoff", "tid": msg.get("tid"),
                        "pool": pool, "from": self.name,
                    })
                    return
                # a client op lands in the QoS queue like any other work
                # (reference: ms_fast_dispatch -> enqueue_op, OSD.cc:6439)
                claim = msg.pop("_budget_claim", None)
                if claim is not None:
                    # keep the messenger's dispatch-throttle budget held
                    # until the op EXECUTES (released in _run_client_op)
                    # so queued bytes stay under the daemon's cap
                    claim()
                cost = max(1, len(msg.get("data") or b"") // 4096)
                # queue-entry stamp only (no allocation): the TrackedOp
                # and its span are minted at dequeue BACKDATED to this
                # stamp, so queue wait is attributed per op without a
                # tracker object per queued message
                msg["_queued_mono"] = time.monotonic()
                if self.op_queue_type == "mclock":
                    # client sub-class (gold/bulk/... from the op's
                    # qos_class field) when the profile names it;
                    # plain "client" otherwise
                    klass = msg.get("qos_class") or "client"
                    if klass not in self.opq.classes:
                        klass = "client"
                    self.opq.enqueue(klass, cost, (src, msg))
                else:
                    self.opq.enqueue(
                        OP_PRIORITY["client"], cost, (src, msg)
                    )
                self._client_ops_queued += 1
                msg["_client_gauge"] = True
                self.perf.inc("queued_client_op")
                self._op_event.set()
                return
            if op.endswith("_reply"):
                # meta-plane replies for a hosted primary engine
                for backend in self.pools.values():
                    await backend.dispatch(src, msg)
                return
            await self._handle_meta_op(src, msg)
            return
        if isinstance(msg, dict):
            # monitor traffic (command replies, osdmap broadcasts): a
            # mon-integrated daemon wires its MonClient handler here
            hook = getattr(self, "mon_hook", None)
            if hook is not None:
                await hook(src, msg)
            return
        if isinstance(msg, (ECSubWrite, ECSubRead)):
            klass = getattr(msg, "op_class", "client")
            # a client sub-op carrying its originating op's QoS
            # sub-class queues under THAT class (end-to-end tags: the
            # replica hop honors the same reservation/weight/limit
            # triple as the primary's admission); unknown classes ride
            # the base op_class
            qcls = getattr(msg, "qos_class", None)
            cost = self._op_cost(msg)
            # queue-entry stamp (see the client-op path above)
            msg._queued_mono = time.monotonic()
            if self.op_queue_type == "mclock":
                if qcls is not None and klass == "client" and \
                        qcls in self.opq.classes:
                    klass = qcls
                self.opq.enqueue(klass, cost, (src, msg))
            else:
                self.opq.enqueue(OP_PRIORITY.get(klass, 63), cost, (src, msg))
            self.perf.inc(f"queued_{klass}")
            self._op_event.set()

    async def _handle_meta_op(self, src: str, msg: dict) -> None:
        """Metadata-plane ops served fast-dispatch (single-threaded, so
        compare-and-swap is atomic without extra locking):

        * ``omap_cas`` -- the atomicity primitive cls_lock-style classes
          need: this OSD (the object's primary-shard holder) is the CAS
          authority (the reference runs cls methods on the primary OSD,
          src/osd/ClassHandler.cc; our primary engine is client-side, so
          atomic read-modify-write is delegated here).
        * ``watch`` / ``unwatch`` / ``notify`` -- watch/notify semantics
          (reference src/osd/Watch.cc): watchers register here; notify
          fans an event to every watcher and gathers acks.
        * ``meta_get`` -- omap + xattrs + meta version for the replicated
          metadata object.
        """
        op = msg["op"]
        oid = msg.get("oid", "")
        soid = f"{oid}@meta"
        if op == "pg_log_info":
            # O(1) peering poll: log head/tail only.  A primary whose
            # watermark is current skips this OSD entirely (reference
            # GetInfo, src/osd/PG.cc peering).  "nonempty" distinguishes a
            # brand-new OSD from one RESTARTED on a persistent store whose
            # in-memory log is empty but whose holdings need a backfill
            # comparison (memoized once true; a stale true only costs an
            # extra backfill).
            if not getattr(self, "_store_nonempty", False):
                self._store_nonempty = bool(self.store.list_objects())
            self.perf.inc("pg_log_info_serve")
            await self.messenger.send_message(self.name, src, {
                "op": "pg_log_info_reply", "tid": msg["tid"],
                "from": self.name,
                "head_seq": self.pglog.head_seq,
                "tail_seq": self.pglog.tail_seq,
                "dup_head": self.pglog.dup_head_seq,
                "nonempty": self._store_nonempty,
                # incarnation nonce: pre-boot-id peers just .get() None
                "boot_id": self.boot_id,
            })
            return
        if op == "pg_dups":
            # peering dup exchange: reqid dup entries above the
            # requester's per-peer watermark (bounded by
            # osd_pg_log_dups_tracked, so worst case is one small full
            # sweep per new primary)
            ents = [
                (d.seq, list(d.reqid), d.result, d.oid,
                 list(d.version) if d.version is not None else None)
                for d in self.pglog.dups_after(int(msg.get("from_seq", 0)))
            ]
            self.perf.inc("pg_dups_serve")
            await self.messenger.send_message(self.name, src, {
                "op": "pg_dups_reply", "tid": msg["tid"],
                "from": self.name, "dups": ents,
                "head": self.pglog.dup_head_seq,
            })
            return
        if op == "dup_record":
            # a primary pushing a completed composite op's result
            # (exec/snap_trim) into our log before it replies to the
            # client -- the awaited leg of the exactly-once protocol
            self.pglog.record_dup(
                tuple(msg["reqid"]), msg.get("result"),
                oid=msg.get("oid", ""),
            )
            self.perf.inc("dup_record")
            await self.messenger.send_message(self.name, src, {
                "op": "dup_record_reply", "tid": msg["tid"],
                "from": self.name, "ok": True,
            })
            return
        if op == "pg_log_entries":
            # delta peering: entries above the requester's watermark
            # (reference GetLog / missing-set computation).  complete=False
            # means the log was trimmed past the gap -> backfill.
            from_seq = int(msg.get("from_seq", 0))
            complete = self.pglog.covers(from_seq)
            ents = []
            if complete:
                for e in self.pglog.entries_after(from_seq):
                    base, _, tag = e.oid.rpartition("@")
                    ents.append((e.seq, base, tag, tuple(e.obj_version)))
            self.perf.inc("pg_log_entries_serve")
            await self.messenger.send_message(self.name, src, {
                "op": "pg_log_entries_reply", "tid": msg["tid"],
                "from": self.name, "complete": complete,
                "head_seq": self.pglog.head_seq, "entries": ents,
            })
            return
        if op == "pg_rollback":
            # divergent-entry rollback: undo this shard's torn entries
            # locally from the log instead of re-pushing the whole shard
            # (reference PGLog rollback via EC transaction rollback info,
            # src/osd/ECTransaction.cc:97).
            target_soid = msg["soid"]
            to_version = vt(tuple(msg["to_version"]))
            ok = self.pglog.rollback_object_to(
                target_soid, to_version, self.store
            )
            # a rolled-back shard invalidates any resident copy of its
            # base object (the device block was built pre-rollback)
            base = target_soid.rpartition("@")[0] or target_soid
            self.tier.invalidate_oid(base)
            if ok:
                try:
                    self.store.stat(target_soid)
                    self._applied_version[target_soid] = to_version
                except FileNotFoundError:
                    self._applied_version.pop(target_soid, None)
                self.perf.inc("pglog_rollback")
            await self.messenger.send_message(self.name, src, {
                "op": "pg_rollback_reply", "tid": msg["tid"],
                "from": self.name, "ok": ok,
            })
            return
        if op == "obj_versions":
            # targeted peering probe: versions for NAMED objects only
            # (per-object GetInfo; the clean-path replacement for the
            # pg_list full scan).
            out = {}
            for base in msg.get("oids", []):
                shards = {}
                pool_tag = None
                for s in range(msg.get("km", 0)):
                    so = shard_oid(base, s)
                    try:
                        self.store.stat(so)
                    except FileNotFoundError:
                        continue
                    # string key: the wire encoder (utils/encoding
                    # value()) rejects int dict keys, so an int here
                    # crashed every delta-peering probe REPLY on the
                    # real-TCP path (in-process delivery hid it); the
                    # consumer int()s the key either way
                    shards[str(s)] = tuple(
                        vt(self.store.getattr(so, VERSION_KEY)))
                    if pool_tag is None:
                        pool_tag = self.store.getattr(so, POOL_KEY)
                mv = None
                try:
                    self.store.stat(f"{base}@meta")
                    mv = self.store.getattr(f"{base}@meta", "_meta_version") or 0
                    if pool_tag is None:
                        pool_tag = self.store.getattr(
                            f"{base}@meta", POOL_KEY)
                except FileNotFoundError:
                    pass
                out[base] = {"shards": shards, "meta": mv,
                             "pool": pool_tag}
            self.perf.inc("obj_versions_serve")
            await self.messenger.send_message(self.name, src, {
                "op": "obj_versions_reply", "tid": msg["tid"],
                "from": self.name, "objects": out,
            })
            return
        if op == "pg_list":
            self.perf.inc("pg_list_serve")
            # peering scan: report every shard object this OSD holds with
            # its version stamp (the role of the peering Query/log+missing
            # exchange, reference src/osd/PG.cc GetInfo/GetLog).  Shard
            # entries are (oid, shard, (counter, writer)); meta replicas
            # report shard -1 with their meta version.
            objects = []
            for stored in self.store.list_objects():
                base, _, tag = stored.rpartition("@")
                if not base:
                    continue
                if tag == "meta":
                    mv = self.store.getattr(stored, "_meta_version") or 0
                    objects.append((base, -1, (mv, ""),
                                    self.store.getattr(stored, POOL_KEY)))
                else:
                    try:
                        shard = int(tag)
                    except ValueError:
                        continue
                    ver = vt(self.store.getattr(stored, VERSION_KEY))
                    objects.append((base, shard, tuple(ver),
                                    self.store.getattr(stored, POOL_KEY)))
            await self.messenger.send_message(self.name, src, {
                "op": "pg_list_reply", "tid": msg["tid"],
                "from": self.name, "objects": objects,
            })
        elif op == "meta_get":
            try:
                omap = self.store.omap_get(soid)
                ver = self.store.getattr(soid, "_meta_version") or 0
                removed = bool(self.store.getattr(soid, "_meta_removed"))
            except FileNotFoundError:
                omap, ver, removed = None, 0, False
            await self.messenger.send_message(self.name, src, {
                "op": "meta_get_reply", "tid": msg["tid"],
                "omap": omap, "version": ver, "removed": removed,
                "from": self.name,
            })
        elif op == "meta_apply":
            # replicated metadata write: the message carries the FULL
            # resulting omap, not a delta, so a replica that missed any
            # number of earlier versions (it was down) converges to the
            # complete state in one application -- a delta under a
            # version-gap gate would either be rejected forever or stamp
            # a newer version over incomplete contents
            ver = msg["version"]
            if msg.get("reqid") is not None:
                # exactly-once: the originating client op's dup entry
                # lands with the replicated state (recorded even when
                # the version gate below refuses a stale re-apply --
                # the op itself DID happen cluster-wide).  dup_result
                # carries the client-visible outcome where one exists
                # (a replicated CAS); plain omap writes answer None.
                # version stays None: meta versions live on their own
                # sequence and must never be pruned by a CHUNK-plane
                # rollback of the same base oid.
                self.pglog.record_dup(
                    tuple(msg["reqid"]), msg.get("dup_result"), oid=oid,
                )
            try:
                cur = self.store.getattr(soid, "_meta_version") or 0
            except FileNotFoundError:
                cur = 0
            if msg.get("remove"):
                # object removal leaves a VERSIONED TOMBSTONE (cleared
                # omap + removed flag), not a bare delete: a replica
                # that missed the remove holds the old keys at a lower
                # version, and highest-version-wins recovery must
                # propagate the removal, never resurrect the keys.
                # Written even when no twin exists here: the removal
                # record must survive somewhere, or a down replica's
                # stale keys would be the only (hence winning) state
                # when it revives.
                if ver >= cur:
                    self.pglog.append(soid, "remove", (ver, ""),
                                      rollbackable=False)
                    self.pglog.maybe_trim()
                    txn = (
                        Transaction()
                        .omap_clear(soid)
                        .setattr(soid, "_meta_version", ver)
                        .setattr(soid, "_meta_removed", True)
                    )
                    if msg.get("pool") is not None:
                        txn.setattr(soid, POOL_KEY, msg["pool"])
                    self.store.queue_transaction(txn)
                await self.messenger.send_message(self.name, src, {
                    "op": "meta_apply_reply", "tid": msg["tid"],
                    "from": self.name, "applied": ver >= cur,
                })
                return
            if ver >= cur:
                txn = (
                    Transaction()
                    .omap_clear(soid)
                    .omap_setkeys(soid, msg["omap"])
                    .setattr(soid, "_meta_version", ver)
                    .setattr(soid, "_meta_removed", False)
                )
                if msg.get("pool") is not None:
                    txn.setattr(soid, POOL_KEY, msg["pool"])
                # log the apply so delta peering discovers meta staleness
                # the same way it does chunk staleness (full-state omap
                # replication is not log-rollbackable; peering re-applies
                # the newest replica instead)
                self.pglog.append(
                    soid, "write", (ver, ""), rollbackable=False,
                )
                self.pglog.maybe_trim()
                self.store.queue_transaction(txn)
            await self.messenger.send_message(self.name, src, {
                "op": "meta_apply_reply", "tid": msg["tid"],
                "from": self.name, "applied": ver >= cur,
            })
        elif op == "omap_cas":
            key, expect, new = msg["key"], msg["expect"], msg["new"]
            try:
                omap = self.store.omap_get(soid)
            except FileNotFoundError:
                omap = {}
            reqid = msg.get("reqid")
            if reqid is not None:
                hit = self.pglog.lookup_dup(reqid)
                if hit is not None and hit.result is not None:
                    # replayed CAS: the compare already ran and (maybe)
                    # swapped -- re-comparing against post-apply state
                    # would report a false failure.  Answer the original
                    # outcome; the current full state rides along for
                    # the caller's replication fan-out as usual.
                    self.perf.inc("dup_op_hit")
                    ver = (self.store.getattr(soid, "_meta_version") or 0
                           if self.store.exists(soid) else 0)
                    await self.messenger.send_message(self.name, src, {
                        "op": "omap_cas_reply", "tid": msg["tid"],
                        "success": hit.result[0],
                        "current": hit.result[1],
                        "version": ver, "omap": omap,
                    })
                    return
            # The PR-5 exactly-once invariant, machine-enforced: the
            # compare, the dup record, the swap and the transaction
            # queue are ONE indivisible step (the "zero-width
            # dup-detection window").  An await slipped inside lets a
            # replayed CAS re-run the compare against post-apply state
            # (false failure) or apply twice before the dup lands.
            # cephlint: atomic-section omap-cas-dup-with-apply
            cur = omap.get(key)
            success = cur == expect
            ver = (self.store.getattr(soid, "_meta_version") or 0
                   if self.store.exists(soid) else 0)
            if reqid is not None:
                # recorded with the compare itself; the result is
                # final whether or not the swap applied
                self.pglog.record_dup(reqid, [success, cur], oid=oid)
            if success:
                ver += 1
                if new is None:
                    omap.pop(key, None)
                else:
                    omap[key] = new
                txn = (
                    Transaction()
                    .omap_clear(soid)
                    .omap_setkeys(soid, omap)
                    .setattr(soid, "_meta_version", ver)
                )
                if msg.get("pool") is not None:
                    txn.setattr(soid, POOL_KEY, msg["pool"])
                self.store.queue_transaction(txn)
            # cephlint: end-atomic-section
            await self.messenger.send_message(self.name, src, {
                "op": "omap_cas_reply", "tid": msg["tid"],
                "success": success, "current": cur, "version": ver,
                # full state for replication fan-out by the caller
                "omap": omap,
            })
        elif op == "watch":
            self.watches.setdefault(oid, {})[msg["watcher"]] = True
            await self.messenger.send_message(self.name, src, {
                "op": "watch_reply", "tid": msg["tid"], "ok": True,
            })
        elif op == "unwatch":
            self.watches.get(oid, {}).pop(msg["watcher"], None)
            await self.messenger.send_message(self.name, src, {
                "op": "watch_reply", "tid": msg["tid"], "ok": True,
            })
        elif op == "notify":
            self._notify_seq += 1
            notify_id = self._notify_seq
            watchers = list(self.watches.get(oid, {}))
            if not watchers:
                await self.messenger.send_message(self.name, src, {
                    "op": "notify_reply", "tid": msg["tid"],
                    "acks": [], "timeouts": [],
                })
                return
            pending = set(watchers)
            acked: list = []
            fut = asyncio.get_event_loop().create_future()
            self._notify_pending[notify_id] = (pending, acked, fut)
            for w in watchers:
                await self.messenger.send_message(self.name, w, {
                    "op": "notify_event", "oid": oid,
                    "payload": msg.get("payload"),
                    "notify_id": notify_id, "notifier": self.name,
                })

            async def gather_acks(tid=msg["tid"]):
                # runs as its own task: the dispatch loop must stay free
                # to deliver the very notify_acks being awaited here
                try:
                    await asyncio.wait_for(
                        fut, timeout=msg.get("timeout", 5.0)
                    )
                except asyncio.TimeoutError:
                    pass
                self._notify_pending.pop(notify_id, None)
                await self.messenger.send_message(self.name, src, {
                    "op": "notify_reply", "tid": tid,
                    "acks": list(acked), "timeouts": sorted(pending),
                })

            self.messenger.adopt_task(
                f"{self.name}.notify{notify_id}",
                asyncio.get_event_loop().create_task(gather_acks()),
            )
        elif op == "notify_ack":
            state = self._notify_pending.get(msg["notify_id"])
            if state is not None:
                pending, acked, fut = state
                if msg["watcher"] in pending:
                    pending.discard(msg["watcher"])
                    acked.append(msg["watcher"])
                if not pending and not fut.done():
                    fut.set_result(True)

    async def _op_worker(self) -> None:
        """Dequeue-and-execute loop (the osd_op_tp worker thread role)."""
        while True:
            await self._op_event.wait()
            self._op_event.clear()
            while True:
                if self.op_queue_type == "mclock":
                    item = self.opq.dequeue()
                    if item is None:
                        # next_ready-based idle wakeup: sleep until the
                        # earliest queued tag comes due OR a new arrival
                        # (whose reservation may be eligible right away)
                        # -- the queue's OWN injected clock times both
                        # sides, so no mixed-domain drift can strand a
                        # tag (the polling fallback is gone)
                        delay = self.opq.idle_for()
                        if delay is None:
                            break
                        try:
                            await asyncio.wait_for(
                                self._op_event.wait(), timeout=delay,
                            )
                            self._op_event.clear()
                        except asyncio.TimeoutError:
                            pass
                        continue
                else:
                    if self.opq.empty():
                        break
                    item = self.opq.dequeue()
                # a daemon frozen or marked down after enqueue must not
                # execute (a "hung" OSD mutating its store would defeat
                # the fault model the flag simulates)
                if self.frozen or self.messenger.is_down(self.name):
                    # a dropped op must still return its claimed
                    # dispatch-throttle budget or repeated freeze cycles
                    # would shrink the messenger's byte cap forever
                    dropped = item[1]
                    if isinstance(dropped, dict):
                        release = dropped.pop("_budget_release", None)
                        if release is not None:
                            release()
                        if dropped.pop("_client_gauge", None):
                            self._client_ops_queued -= 1
                    continue
                src, msg = item
                singles = [(src, msg)]
                if (self._batch_exec and isinstance(msg, dict)
                        and msg.get("op") == "client_op"
                        and not self.client_caps):
                    # batched fast path: the decoded burst's client ops
                    # are all buffered in the queue already (the
                    # dispatch loop drains a corked burst before this
                    # worker wakes), so the RUN gathered here is real.
                    # Entities with registered caps keep the per-op
                    # path (op_capable stays per-op audited).
                    batch, spill = self._gather_client_run(src, msg)
                    if len(batch) > 1:
                        # ONE task for the whole batch (vs one per op):
                        # the gathered backend calls still land in the
                        # same event-loop tick, so the codec coalescer
                        # sees the identical fan-in
                        self._cop_seq += 1
                        self.messenger.adopt_task(
                            f"{self.name}.cob{self._cop_seq}",
                            asyncio.get_event_loop().create_task(
                                self._run_client_op_batch(batch)),
                        )
                        singles = []
                    else:
                        singles = batch
                    if spill is not None:
                        singles.append(spill)
                for one_src, one_msg in singles:
                    try:
                        await self._execute_op(one_src, one_msg)
                    except asyncio.CancelledError:
                        raise
                    except Exception:  # noqa: BLE001 — op failure must
                        # not kill the worker; log and keep serving (the
                        # reference logs and drops misbehaving ops too)
                        import sys
                        import traceback

                        traceback.print_exc(file=sys.stderr)

    def _gather_client_run(self, src: str, msg: dict):
        """Drain the client-op RUN already buffered behind ``msg`` (up
        to ``osd_op_batch_max``).  Sync -- no awaits, so no state
        (frozen / mark_down / caps) can change mid-gather.  Returns
        ``(batch, spill)``: the first non-client item dequeued ends the
        run and is handed back for ordinary execution."""
        batch = [(src, msg)]
        spill = None
        while len(batch) < self._batch_max:
            if self.op_queue_type == "mclock":
                nxt = self.opq.dequeue()
            else:
                nxt = None if self.opq.empty() else self.opq.dequeue()
            if nxt is None:
                break
            nmsg = nxt[1]
            if isinstance(nmsg, dict) and nmsg.get("op") == "client_op":
                batch.append(nxt)
            else:
                spill = nxt
                break
        return batch, spill

    async def _run_client_op_batch(self, items) -> None:
        """Array-batched client-op execution (osd_op_batch_exec, the
        post-codec fast path): the per-op bookkeeping the
        wire-tax profiler ranked as the residual wall -- optracker
        stamping, reqid/dup lookups, QoS slot admission, perf/hitset
        accounting, reply sends -- runs as BATCH passes over the run
        instead of per-op dict walks:

        * one tracked request + one trace span for the batch (queue-wait
          attribution stays per op);
        * the dups registry is scanned in ONE pass over the batch's
          reqids; hits answer with the original result exactly like the
          per-op path (exactly-once unchanged);
        * QoS execution slots are claimed once per (class) group with
          the SUMMED byte cost -- the coalescer's admission discipline;
        * the backend calls run CONCURRENTLY (gather), so the codec
          coalescer gathers the same one-tick fan-in as per-op tasks;
        * counters, the latency grid, hit sets and budget releases fold
          into one array pass; replies go out as one corked burst.

        Semantics are the per-op path's exactly: dup answers, typed
        error replies, composite-kind dup fan-out, apply-window kills
        (a fired kill marks this daemon down and suppresses the batch's
        replies -- the client resends and is answered from the dups
        registry)."""
        t_exec = time.monotonic()
        n = len(items)
        with _PS_BATCH:
            qats = [m.pop("_queued_mono", None) for _, m in items]
            t0 = min((q for q in qats if q is not None), default=t_exec)
            op = self.optracker.create_request(
                f"client_op_batch(n={n})",
                span=trace.join(None, "osd:client_op_batch", t0=t0),
                t0=t0,
            )
            sizes = [len(m.get("data") or b"") for _, m in items]
            self.h_queue_wait.inc_pairs([
                ((t_exec - (qat if qat is not None else t_exec)) * 1e6, sz)
                for qat, sz in zip(qats, sizes)])
            op.mark_event("dequeued")
            replies = [{"op": "client_reply", "tid": m["tid"]}
                       for _, m in items]
            default_pool = next(iter(self.pools)) if self.pools else None
            backends = []
            for _, m in items:
                b = self.pools.get(m.get("pool") or "")
                if b is None and default_pool is not None:
                    b = self.pools[default_pool]
                backends.append(b)
            kinds = [m.get("kind", "") for _, m in items]
            reqids = [m.get("reqid") for _, m in items]
            dedupable = [r is not None and k in MUTATING_KINDS
                         for r, k in zip(reqids, kinds)]
            # one-pass batch dup scan (the per-op path pays a lookup per
            # op; here the registry dict is touched once per batch row)
            hits = self.pglog.lookup_dups_batch(
                [reqids[i] if dedupable[i] else None for i in range(n)])
            run = []
            dup_hits = 0
            for i in range(n):
                if backends[i] is None:
                    replies[i].update(
                        ok=False, etype="IOError",
                        error=f"{self.name} hosts no pool")
                elif hits[i] is not None:
                    replies[i].update(ok=True, result=hits[i].result)
                    dup_hits += 1
                else:
                    run.append(i)
            if dup_hits:
                self.perf.inc("dup_op_hit", dup_hits)
            groups: Dict[str, list] = {}
            for i in run:
                klass = items[i][1].get("qos_class") or "client"
                if self.qos_ops is None or \
                        klass not in self.qos_ops.classes:
                    klass = "client"
                groups.setdefault(klass, []).append(i)
        op.mark_event("started")

        async def _exec_one(i):
            reply = replies[i]
            try:
                reply.update(
                    ok=True, result=await backends[i].client_op(items[i][1]))
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 -- every failure
                # travels back to the client as a typed error
                reply.update(ok=False, etype=type(e).__name__, error=str(e))

        async def _exec_group(klass, idxs):
            # amortized admission: ONE slot claim per class with the
            # summed cost (per-op pays a tag + slot round trip each)
            cost = sum(max(4096, sizes[i]) for i in idxs)
            if self.qos_ops is not None and klass in self.qos_ops.classes:
                guard = self.qos_ops.slot(klass, cost)
            else:
                guard = self._cop_sem
            async with guard:
                await asyncio.gather(*(_exec_one(i) for i in idxs))

        try:
            with trace.use_span(op.span):
                if groups:
                    await asyncio.gather(*(
                        _exec_group(k, idxs) for k, idxs in groups.items()))
                for i in run:
                    if not (dedupable[i] and replies[i].get("ok")):
                        continue
                    m = items[i][1]
                    if kinds[i] in _RESULT_FANOUT_KINDS:
                        # composite kinds keep the awaited acting-set
                        # dup fan-out (result only exists at completion)
                        await self._record_op_dup(
                            backends[i], m, replies[i].get("result"))
                    else:
                        self.pglog.record_dup(
                            reqids[i], replies[i].get("result"),
                            oid=m.get("oid", ""))
            op.mark_event("replied")
        finally:
            dur_us = (time.monotonic() - t_exec) * 1e6
            with _PS_BATCH:
                n_ok = wr = rd = 0
                oids = []
                for (_, m), reply, size in zip(items, replies, sizes):
                    if reply.get("ok"):
                        n_ok += 1
                        wr += size
                        result = reply.get("result")
                        if isinstance(result, (bytes, bytearray)):
                            rd += len(result)
                    if m.get("oid"):
                        oids.append(m["oid"])
                    release = m.pop("_budget_release", None)
                    if release is not None:
                        release()
                    if m.pop("_client_gauge", None):
                        self._client_ops_queued -= 1
                # the latency grids take the whole run in one locked
                # pass each; the hit set rolls once for the run
                self.op_hist.inc_many(dur_us, sizes)
                self.h_dispatch.inc_many(dur_us, sizes)
                if oids:
                    self.hitsets.record_many(oids)
                if n_ok:
                    self.perf.inc("client_ops", n_ok)
                if wr:
                    self.perf.inc("client_wr_bytes", wr)
                if rd:
                    self.perf.inc("client_rd_bytes", rd)
            op.finish()
        fault = getattr(self.messenger, "fault", None)
        if fault is not None:
            for i in range(n):
                if (replies[i].get("ok") and dedupable[i]
                        and fault.kill_after_apply_fire(kinds[i])):
                    # injected dup-detection window: the whole batch
                    # applied (dup entries recorded above) but this
                    # primary dies before its reply burst -- the client
                    # resends and is answered from a surviving PG log
                    self.messenger.mark_down(self.name)
                    return
        if self.frozen or self.messenger.is_down(self.name):
            return
        await self.messenger.send_messages(
            self.name, [(items[i][0], replies[i]) for i in range(n)])

    async def _execute_op(self, src: str, msg) -> None:
        if isinstance(msg, dict):
            # client op: runs as its own task -- it awaits sub-ops that
            # this very worker loop must stay free to execute (the
            # reference gets the same effect from multiple osd_op_tp
            # threads; concurrency is bounded by _cop_sem)
            self._cop_seq += 1
            task = asyncio.get_event_loop().create_task(
                self._run_client_op(src, msg)
            )
            self.messenger.adopt_task(f"{self.name}.cop{self._cop_seq}", task)
            return
        kind = "sub_write" if isinstance(msg, ECSubWrite) else "sub_read"
        t_exec = time.monotonic()
        cost_bytes = self._op_cost(msg) * 4096
        qat = getattr(msg, "_queued_mono", None)
        # the span joins the originating op's trace (trailing wire
        # field) so the cross-daemon timeline stitches client ->
        # primary -> sub-op; the op backdates to queue entry
        op = self.optracker.create_request(
            f"{kind}(tid={msg.tid} oid={next(iter(msg.to_read), '?') if isinstance(msg, ECSubRead) else msg.oid} shard={msg.from_shard})",
            span=trace.join(getattr(msg, "trace", None),
                            f"{self.name}:{kind}", t0=qat),
            t0=qat,
        )
        # queue wait = enqueue stamp -> here
        self.h_queue_wait.inc(
            (t_exec - (qat if qat is not None else t_exec)) * 1e6,
            cost_bytes)
        op.mark_event("dequeued")
        try:
            with trace.use_span(op.span):
                if isinstance(msg, ECSubWrite):
                    await self.handle_sub_write(src, msg)
                else:
                    await self.handle_sub_read(src, msg)
            op.mark_event("replied")
        finally:
            self.h_dispatch.inc(
                (time.monotonic() - t_exec) * 1e6, cost_bytes)
            op.finish()

    async def _run_client_op(self, src: str, msg: dict) -> None:
        """Execute one client op on the hosted primary engine and reply.

        Reference: the osd_op_tp worker calling PrimaryLogPG::do_request
        -> do_op -> execute_ctx, with the MOSDOpReply back to the client
        (src/osd/OSD.cc:9072, src/osd/PrimaryLogPG.cc:1649)."""
        t_exec = time.monotonic()
        qat = msg.pop("_queued_mono", None)
        with _PS_OP:
            # the op backdates to its queue-entry stamp; its span (when
            # the client's trace context rode the op) starts there too,
            # so the timeline's first segment is the true queue wait
            op = self.optracker.create_request(
                f"client_op({msg.get('kind')} oid={msg.get('oid')} "
                f"from={src})",
                span=trace.join(msg.get("trace"), f"osd:{msg.get('kind')}",
                                t0=qat),
                t0=qat,
            )
            self.h_queue_wait.inc(
                (t_exec - (qat if qat is not None else t_exec)) * 1e6,
                len(msg.get("data") or b""))
            op.mark_event("dequeued")
            reply = {"op": "client_reply", "tid": msg["tid"]}
        try:
            # the op span is task-current for the whole execution: the
            # engine's fan-outs stamp it onto sub-ops and the coalescer
            # links its batch fan-in span to it
            with trace.use_span(op.span):
                await self._run_client_op_inner(src, msg, op, reply)
        finally:
            with _PS_OP:
                self.h_dispatch.inc(
                    (time.monotonic() - t_exec) * 1e6,
                    len(msg.get("data") or b""))
                release = msg.pop("_budget_release", None)
                if release is not None:
                    release()  # claimed dispatch-throttle budget
                if msg.pop("_client_gauge", None):
                    self._client_ops_queued -= 1
                op.finish()

    async def _run_client_op_inner(self, src: str, msg: dict, op,
                                   reply: dict) -> None:
        # execution-slot admission: under unified QoS the op claims its
        # slot in dmClock tag order for its client class (the op's
        # qos_class field, plain "client" otherwise) with cost = payload
        # bytes (4 KiB floor for metadata ops) -- freed slots go to the
        # class the tags elect, not to semaphore-FIFO order.  Fallback:
        # the legacy _cop_sem (osd_qos_unified=false).
        klass = msg.get("qos_class") or "client"
        if self.qos_ops is not None and \
                klass not in self.qos_ops.classes:
            klass = "client"  # unknown sub-class rides the base class
        if self.qos_ops is not None and klass in self.qos_ops.classes:
            guard = self.qos_ops.slot(
                klass, max(4096, len(msg.get("data") or b"")),
            )
        else:
            guard = self._cop_sem
        async with guard:
            # the sync bookkeeping head is a declared wire-tax cost
            # center (osd.op_exec): what the batched fast path amortizes
            with _PS_OP:
                op.mark_event("started")
                pool_name = msg.get("pool") or ""
                backend = self.pools.get(pool_name)
                if backend is None and self.pools:
                    # fall back to the hosted pool -- and make the cap
                    # check below use the pool the op will actually RUN
                    # on, never the requested name (a grant on an
                    # unhosted name must not leak onto the hosted pool)
                    pool_name = next(iter(self.pools))
                    backend = self.pools[pool_name]
                cap = self.client_caps.get(src.split("[")[0])
                if cap is not None and backend is not None:
                    # OSDCap enforcement (PrimaryLogPG
                    # op_has_sufficient_caps): an entity with registered
                    # caps is confined to them; unregistered entities
                    # keep the open-cluster default (client.admin
                    # allow *)
                    from ceph_tpu_torch.auth.caps import op_capable

                    if not op_capable(cap, pool_name, msg.get("oid", ""),
                                      msg.get("kind", "")):
                        reply.update(
                            ok=False, etype="PermissionError",
                            error=f"{src} caps do not permit "
                                  f"{msg.get('kind')} on {msg.get('oid')}",
                        )
                        backend = None
                        self.perf.inc("cap_denied")
                kind = msg.get("kind", "")
                reqid = msg.get("reqid")
                dedupable = reqid is not None and kind in MUTATING_KINDS
                execute = False
                if backend is None and "etype" not in reply:
                    reply.update(
                        ok=False, etype="IOError",
                        error=f"{self.name} hosts no pool",
                    )
                elif backend is not None and dedupable and (
                    (hit := self.pglog.lookup_dup(reqid)) is not None
                ):
                    # replay of an op this PG already applied (the
                    # client resent after a failover): answer with the
                    # ORIGINAL result from the log instead of
                    # re-executing -- the exactly-once guarantee
                    # (reference: PrimaryLogPG::do_op eversion/reqid
                    # check via pg_log_dup_t, src/osd/osd_types.h)
                    reply.update(ok=True, result=hit.result)
                    self.perf.inc("dup_op_hit")
                elif backend is not None:
                    execute = True
            if execute:
                try:
                    reply.update(ok=True, result=await backend.client_op(msg))
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 -- every failure
                    # travels back to the client as a typed error
                    reply.update(
                        ok=False, etype=type(e).__name__, error=str(e)
                    )
                if dedupable and reply.get("ok"):
                    await self._record_op_dup(
                        backend, msg, reply.get("result"))
            op.mark_event("replied")
        op.finish()
        with _PS_OP:
            self.op_hist.inc(op.duration * 1e6,
                             len(msg.get("data") or b""))
            if reply.get("ok"):
                # rate-engine feed (mgr/pgmap.py): consecutive MgrReport
                # deltas of these become the `ceph -s` io block (client
                # ops/s + throughput, distinct from recovery_bytes)
                self.perf.inc("client_ops")
                wr = len(msg.get("data") or b"")
                if wr:
                    self.perf.inc("client_wr_bytes", wr)
                result = reply.get("result")
                if isinstance(result, (bytes, bytearray)):
                    self.perf.inc("client_rd_bytes", len(result))
            if msg.get("oid"):
                self.hitsets.record(msg["oid"])
        fault = getattr(self.messenger, "fault", None)
        if (
            fault is not None and reply.get("ok") and dedupable
            and fault.kill_after_apply_fire(kind)
        ):
            # injected dup-detection window: the op applied (and its
            # dup entries reached the acting set above) but this
            # primary dies before the reply frame -- the client must
            # resend and be answered from a surviving PG log
            self.messenger.mark_down(self.name)
            return
        if self.frozen or self.messenger.is_down(self.name):
            return
        await self.messenger.send_message(self.name, src, reply)

    async def _record_op_dup(self, backend, msg: dict, result) -> None:
        """Persist a completed client op's reqid + result as a PG-log
        dup entry on this primary, and -- for composite kinds whose
        result only exists at completion (exec, snap_trim) -- push it to
        the rest of the acting set with an AWAITED ``dup_record``
        fan-out before the client reply can go out.  Single-fan-out
        kinds already recorded their dups on the mutating sub-ops
        themselves (see pg.REQID_FANOUT_KINDS), so they pay no extra
        round trip here."""
        reqid = msg.get("reqid")
        oid = msg.get("oid", "")
        # None-result upgrade: the fan-out-recorded entry learns the
        # final client-visible result (exec's (ret, out), snap_trim's
        # dropped-clone count, omap_cas's (success, current))
        self.pglog.record_dup(reqid, result, oid=oid)
        if msg.get("kind") not in _RESULT_FANOUT_KINDS:
            return
        try:
            acting = backend.acting_set(oid)
        except Exception:  # noqa: BLE001 -- placement failure: the
            # local record above still covers the common replay path
            return
        targets = [
            f"osd.{acting[s]}"
            for s in range(backend.km)
            if backend._shard_up(acting, s)
            and f"osd.{acting[s]}" != self.name
        ]
        if not targets:
            return
        await backend._meta_roundtrip(targets, {
            "op": "dup_record", "reqid": list(reqid),
            "result": result, "oid": oid,
        }, timeout=3.0)

    async def handle_sub_write(self, src: str, msg: ECSubWrite) -> None:
        """reference ECBackend::handle_sub_write (:922): log the operation,
        then apply the transaction (log_operation + queue_transactions)."""
        if any(op.op == "write_ref" for op in msg.transaction.ops):
            # mesh-delivered payload (osd_mesh_data_plane): the chunk
            # bytes rode the device plane and the frame carried board
            # references -- claim them back (crc-checked) before the
            # version gate sees the transaction.  A failed claim
            # (evicted / foreign reference) refuses the sub-write:
            # no ack, no apply; peering recovery repairs the shard.
            from ceph_tpu_torch.parallel import mesh_plane as mesh_mod

            plane = mesh_mod.current_plane()
            if plane is None or \
                    not plane.resolve_transaction(msg.transaction):
                self.perf.inc("mesh_claim_miss")
                await self.messenger.send_message(
                    self.name, src, ECSubWriteReply(
                        from_shard=msg.from_shard, tid=msg.tid,
                        committed=False, applied=False,
                    ))
                return
        soid = shard_oid(msg.oid, msg.from_shard)
        new_vt = vt(msg.at_version)
        cur_vt = self._applied_version.get(soid)
        if cur_vt is None:
            # fresh process (daemon restart): the applied version lives in
            # the object's xattr, not just this map — the gate must
            # survive restarts on persistent stores
            try:
                cur_vt = vt(self.store.getattr(soid, VERSION_KEY))
            except FileNotFoundError:
                cur_vt = vt(None)
        if (
            msg.prev_version is not None
            and cur_vt[0] != vt(msg.prev_version)[0]
            and new_vt >= cur_vt
        ):
            # incremental (RMW extent) write, but this shard is not on the
            # base version it was computed against: it missed history
            # (down/revived hollow).  Applying just the extent would stamp
            # the new version over mostly-stale bytes.  Skip; the shard
            # stays behind until peering recovers it (pg_missing_t role).
            self.perf.inc("sub_write_missed_base")
            await self.messenger.send_message(self.name, src, ECSubWriteReply(
                from_shard=msg.from_shard, tid=msg.tid,
                committed=False, applied=False, missed=True,
            ))
            return
        if msg.rollback and msg.op_class == "recovery":
            # peering proved this shard's newer copy a torn write (held by
            # < k shards): the primary rolls it back to the authoritative
            # version, bypassing the stale gate (divergent-entry rollback)
            self.perf.inc("sub_write_rollback")
        elif new_vt < cur_vt:
            # dequeued behind a newer write to the same object (priority
            # reordering or a racing primary).  Applying would clobber
            # newer bytes with stale ones.
            self.perf.inc("sub_write_stale")
            if msg.op_class == "client":
                # a racing client write lost: refuse loudly so the writer
                # retries at a higher version instead of believing a
                # commit that never applied (split-brain fix)
                reply = ECSubWriteReply(
                    from_shard=msg.from_shard, tid=msg.tid,
                    committed=False, applied=False,
                    current_version=cur_vt,
                )
            else:
                # a recovery/scrub push made obsolete by a newer client
                # write is genuinely done: the shard holds newer data
                reply = ECSubWriteReply(
                    from_shard=msg.from_shard, tid=msg.tid,
                    committed=True, applied=False,
                )
            await self.messenger.send_message(self.name, src, reply)
            return
        # From the version stamp to queue_transaction is ONE indivisible
        # apply step: the stale gate above was evaluated against
        # _applied_version, and a task switch before the transaction
        # lands would let a racing sub-write interleave between gate
        # and apply (clobbering newer bytes) or observe the version
        # advanced with the dup entry/log append missing.
        # cephlint: atomic-section sub-write-apply
        self._applied_version[soid] = new_vt
        # device-tier coherence: an applied sub-write proves any resident
        # copy stale UNLESS it belongs to this very write (the primary's
        # own write-through put carries the same version and survives;
        # a racing primary's write carries a different one and evicts).
        # A same-versioned RECOVERY push is a refresh, not a mutation:
        # the shard is being rebuilt toward the version the resident
        # copy already holds, so the copy stays valid AND in-flight
        # promotions of the rebuilt object must not be dropped (the
        # rebuilt-object-goes-cold bug: the unconditional invalidate
        # notified the agent's watchers even when the entry survived)
        if not (msg.op_class in ("recovery", "scrub")
                and self.tier.recovery_refresh(msg.oid, new_vt)):
            self.tier.invalidate_oid(msg.oid, keep_version=new_vt)
        # log_operation before queue_transactions (reference order,
        # ECBackend.cc:922): snapshot the pre-apply state so a torn write
        # can be rolled back locally (divergent-entry rollback) and give
        # the entry this OSD's monotonic sequence for delta peering.
        try:
            prior = self.store.stat(soid)
            existed = True
        except FileNotFoundError:
            prior = 0
            existed = False
        prior_attrs: Dict[str, object] = {}
        rollbackable = True
        for top in msg.transaction.ops:
            if top.op == "setattr" and top.oid == soid:
                prior_attrs[top.attr_name] = (
                    self.store.getattr(soid, top.attr_name) if existed
                    else None
                )
            elif existed and top.op == "write" and top.offset < prior:
                rollbackable = False  # overwrites prior bytes: needs push
            elif existed and top.op == "truncate" and top.offset < prior:
                rollbackable = False
            elif top.op in ("remove", "omap_set", "omap_rm", "omap_clear"):
                rollbackable = False
        self.pglog.append(
            soid, "write", new_vt,
            existed=existed, prior_size=prior,
            prior_attrs=prior_attrs or None, rollbackable=rollbackable,
        )
        if msg.reqid is not None and msg.op_class == "client":
            # exactly-once: the dup entry lands in the SAME step as the
            # mutation, so there is no window in which this shard holds
            # the write but could not detect its replay (the reference
            # writes pg_log_dup_t with the log entry).  Result None is
            # exact for every reqid-carrying fan-out kind; composite
            # ops upgrade it via dup_record (see _record_op_dup).
            self.pglog.record_dup(msg.reqid, None, oid=msg.oid,
                                  version=new_vt)
        self.pglog.maybe_trim()
        self.store.queue_transaction(msg.transaction)
        # cephlint: end-atomic-section
        self.perf.inc("sub_write")
        reply = ECSubWriteReply(
            from_shard=msg.from_shard, tid=msg.tid, committed=True, applied=True
        )
        await self.messenger.send_message(self.name, src, reply)

    def _serve_regen_helpers(
        self, msg: ECSubRead, regen: Dict[str, list],
        reply: ECSubReadReply,
    ) -> None:
        """Regenerating-code repair lane (plugins/regen.py): for each
        ``regen`` oid, dot our stored shard's alpha sub-chunks with the
        wire-carried phi_f coefficients and reply the beta-sized helper
        symbol instead of raw extents -- d helpers of chunk/alpha bytes
        replace k whole-chunk reads at the primary.  All oids of the
        message sharing a coefficient signature fuse into ONE batched
        GF(2^8) matmul dispatch, on the device of the pool codec that
        advertises fractional repair."""
        import numpy as np

        from ceph_tpu_torch.device import codec_device
        from ceph_tpu_torch.plugins import regen as regen_mod

        ec = next((b.ec for b in self.pools.values()
                   if getattr(b.ec, "fractional_repair", False)), None)
        device = codec_device(ec)
        groups: Dict[tuple, list] = {}
        for oid, coeffs in regen.items():
            soid = shard_oid(oid, msg.from_shard)
            try:
                data = self.store.read(soid)
                # same integrity gate as the extent path: a full-shard
                # helper computed from silently-corrupt bytes would
                # poison the regenerated shard undetectably
                hinfo_d = self.store.getattr(soid, ecutil.HINFO_KEY)
            except FileNotFoundError:
                reply.errors[oid] = -2  # ENOENT
                continue
            if hinfo_d is not None:
                hinfo = ecutil.HashInfo.from_dict(hinfo_d)
                if (hinfo.has_chunk_hash()
                        and len(data) == hinfo.get_total_chunk_size()
                        and crc32c(data) != hinfo.get_chunk_hash(
                            msg.from_shard)):
                    self.perf.inc("read_crc_error")
                    reply.errors[oid] = -5  # EIO
                    continue
            key = (tuple(int(c) for c in coeffs), len(data))
            groups.setdefault(key, []).append(
                (oid, np.frombuffer(data, dtype=np.uint8)))
        for (coeffs, _nbytes), members in groups.items():
            try:
                helpers = regen_mod.compute_helpers(
                    coeffs, [arr for _, arr in members],
                    slot_name=self.name, device=device)
            except ValueError:
                for oid, _ in members:
                    reply.errors[oid] = -22  # EINVAL: shard/coeff shape
                continue
            for (oid, _), h in zip(members, helpers):
                reply.buffers_read[oid] = [(0, h.tobytes())]
            self.perf.inc("regen_helpers_served", len(members))

    async def handle_sub_read(self, src: str, msg: ECSubRead) -> None:
        """reference ECBackend::handle_sub_read (:987): serve extents and
        crc-verify full-shard reads against HashInfo."""
        reply = ECSubReadReply(from_shard=msg.from_shard, tid=msg.tid)
        regen = msg.regen if isinstance(msg.regen, dict) else {}
        if regen:
            self._serve_regen_helpers(msg, regen, reply)
        for oid, extents in msg.to_read.items():
            if oid in regen:
                continue  # served as a helper symbol, never raw extents
            soid = shard_oid(oid, msg.from_shard)
            try:
                bufs = []
                for off, length in extents:
                    data = self.store.read(soid, off, length)
                    bufs.append((off, data))
                # full-shard read -> verify cumulative crc (ECBackend.cc:1054)
                hinfo_d = self.store.getattr(soid, ecutil.HINFO_KEY)
                if hinfo_d is not None:
                    hinfo = ecutil.HashInfo.from_dict(hinfo_d)
                    # overwrites clear chunk hashes (ec_overwrites mode):
                    # only crc-check shards that still track them
                    if hinfo.has_chunk_hash():
                        full = self.store.read(soid)
                        if len(full) == hinfo.get_total_chunk_size():
                            if crc32c(full) != hinfo.get_chunk_hash(
                                msg.from_shard
                            ):
                                self.perf.inc("read_crc_error")
                                reply.errors[oid] = -5  # EIO
                                continue
                reply.buffers_read[oid] = bufs
            except FileNotFoundError:
                reply.errors[oid] = -2  # ENOENT
        for oid in msg.attrs_to_read:
            soid = shard_oid(oid, msg.from_shard)
            try:
                reply.attrs_read[oid] = {
                    ecutil.HINFO_KEY: self.store.getattr(soid, ecutil.HINFO_KEY),
                    SIZE_KEY: self.store.getattr(soid, SIZE_KEY),
                    VERSION_KEY: self.store.getattr(soid, VERSION_KEY),
                    SNAPSET_KEY: self.store.getattr(soid, SNAPSET_KEY),
                    WHITEOUT_KEY: self.store.getattr(soid, WHITEOUT_KEY),
                    POOL_KEY: self.store.getattr(soid, POOL_KEY),
                }
            except FileNotFoundError:
                pass
        self.perf.inc("sub_read")
        await self.messenger.send_message(self.name, src, reply)
