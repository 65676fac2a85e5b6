"""Mini EC cluster harness (vstart.sh / ceph-helpers.sh analogue).

Port of ``ceph_tpu/osd/cluster.py``.

Boots N in-process OSD shard daemons on an async messenger, creates an EC
"pool" from a profile via the plugin registry, and exposes the client write/
read/recover surface.  The reference equivalent is a vstart cluster plus the
qa standalone helpers (reference: src/vstart.sh, qa/standalone/
ceph-helpers.sh:417 run_mon / :571 run_osd / :507 create_pool) reduced to
the EC data path.

The port's entry points run on the card unless asked for the CPU: the
default ``plugin`` is ``"cuda"`` (the JAX package's is ``"jerasure"``), and
a caller asks for the CPU with ``plugin="jerasure"`` or the profile key
``device=cpu``; the mon-backed cluster (``create_with_mons``) keeps that
default.  Each OSD's device cache tier lives
on the pool codec's device: the card, or the CPU where the caller asked for
it.
"""

from __future__ import annotations

import asyncio
import os
from typing import Dict, List, Optional

from ceph_tpu_torch.device import codec_device
from ceph_tpu_torch.osd.ecbackend import ECBackend, OSDShard
from ceph_tpu_torch.osd.messenger import FaultInjector, Messenger
from ceph_tpu_torch.osd.objecter import Objecter
from ceph_tpu_torch.plugins import registry as registry_mod

#: the plugin a pool gets when neither ``plugin`` nor the profile names
#: one: the card (the JAX package defaults to "jerasure")
DEFAULT_PLUGIN = "cuda"




class ECCluster:
    """Every OSD hosts a primary engine for the
    pool (``OSDShard.host_pool``); ``self.backend`` is a thin Objecter
    that routes each op to the object's current primary OSD, which fans
    out sub-ops -- the reference's client/primary split (SURVEY.md §3.2).
    """

    def __init__(
        self,
        n_osds: int,
        profile: Dict[str, str],
        plugin: Optional[str] = None,
        fault: Optional[FaultInjector] = None,
        use_crush: bool = True,
        hosts=None,
        op_queue: str = "wpq",
        objectstore: str = "memstore",
        data_path: str = "",
        pool: str = "ecpool",
        pool_type: str = "erasure",
        min_size: Optional[int] = None,
    ):
        self.messenger = Messenger(fault)
        self.pool_type = pool_type
        if pool_type == "replicated":
            # TYPE_REPLICATED pool: profile carries {"size": N}
            # (reference build_pg_backend, src/osd/PGBackend.cc:533-570)
            self.ec = None
            km = int(profile.get("size", 3))
        else:
            plugin = plugin or profile.pop("plugin", DEFAULT_PLUGIN)
            registry = registry_mod.instance()
            self.ec = registry.factory(plugin, profile)
            km = self.ec.get_chunk_count()
        # kept for elastic add_osd: new daemons clone the boot shape
        self._op_queue = op_queue
        self._objectstore = objectstore
        self._data_path = data_path
        self._device = codec_device(self.ec)
        self.osds: List[OSDShard] = [
            OSDShard(i, self.messenger, op_queue=op_queue,
                     objectstore=objectstore, data_path=data_path,
                     device=self._device)
            for i in range(n_osds)
        ]
        placement = None
        if use_crush:
            from ceph_tpu_torch.osd.placement import CrushPlacement

            placement = CrushPlacement(n_osds, km, hosts=hosts)
        self.placement = placement
        self.pool = pool
        # one primary engine per OSD; in-process they share the codec and
        # the placement object (weight updates propagate to everyone)
        for osd in self.osds:
            osd.host_pool(pool, self.ec, n_osds, placement,
                          pool_type=pool_type, size=km, min_size=min_size)
        self.backend = Objecter(
            self.messenger, km, n_osds, placement=placement, pool=pool,
        )

    def primary_backend(self, oid: str) -> ECBackend:
        """The hosted primary engine currently serving ``oid`` (test and
        introspection hook)."""
        acting = self.backend.acting_set(oid)
        for s in range(self.backend.km):
            if self.backend._shard_up(acting, s):
                return self.osds[acting[s]].pools[self.pool]
        raise IOError(f"no up primary for {oid}")

    def add_pool(self, name: str, profile: Optional[Dict[str, str]] = None,
                 pool_type: str = "erasure", size: int = 3,
                 hosts=None) -> Objecter:
        """Host an ADDITIONAL pool on the same OSD daemons and return an
        Objecter bound to it -- the reference's normal shape (every OSD
        serves PGs of many pools; metadata pools replicated, data pools
        EC).  Object pool-membership tags (osd/pg.py POOL_KEY)
        keep the co-hosted pools' scrub/peering disjoint."""
        if name in (self.pool,) or any(
            name in osd.pools for osd in self.osds
        ):
            raise ValueError(f"pool {name} exists")
        if pool_type == "replicated":
            ec = None
            km = int((profile or {}).get("size", size))
        else:
            prof = dict(profile or {})
            plugin = prof.pop("plugin", DEFAULT_PLUGIN)
            ec = registry_mod.instance().factory(plugin, prof)
            km = ec.get_chunk_count()
        placement = None
        if self.placement is not None:
            from ceph_tpu_torch.osd.placement import CrushPlacement

            placement = CrushPlacement(len(self.osds), km, hosts=hosts)
        for osd in self.osds:
            osd.host_pool(name, ec, len(self.osds), placement,
                          pool_type=pool_type, size=km)
        return Objecter(
            self.messenger, km, len(self.osds), placement=placement,
            pool=name, name=f"client.{name}",
            # distinct stored-object namespace per additional pool: the
            # flat per-OSD stores would otherwise collide on "oid@shard"
            oid_prefix=f"{name}/",
        )

    def set_tier_mode(self, mode: str, pool: Optional[str] = None) -> None:
        """Configure a pool's device cache-tier mode on every hosted
        engine -- the in-process analogue of the mon's
        ``osd tier cache-mode`` (writeback | readproxy | none)."""
        from ceph_tpu_torch.tier import CACHE_MODES

        if mode not in CACHE_MODES:
            raise ValueError(f"bad cache mode {mode!r}")
        pool = pool or self.pool
        for osd in self.osds:
            backend = osd.pools.get(pool)
            if backend is not None:
                backend.tier_mode = mode

    def new_client(self, name: str) -> Objecter:
        """A second client handle on the same cluster (librados: another
        Rados instance)."""
        return Objecter(
            self.messenger, self.backend.km, len(self.osds),
            placement=self.placement, name=name, pool=self.pool,
        )

    # -- client surface ----------------------------------------------------

    async def write(self, oid: str, data: bytes) -> None:
        await self.backend.write(oid, data)

    async def read(self, oid: str) -> bytes:
        return await self.backend.read(oid)

    async def write_range(self, oid: str, offset: int, data: bytes) -> None:
        await self.backend.write_range(oid, offset, data)

    async def read_range(self, oid: str, offset: int, length: int) -> bytes:
        return await self.backend.read_range(oid, offset, length)

    # -- auto recovery (peering-driven; qa wait_for_clean surface) ---------

    def start_auto_recovery(self, interval: float = None) -> None:
        """Enable background peering + recovery on every OSD (daemons run
        this by default; the in-process harness opts in so unit tests can
        hold a cluster in a degraded state deliberately)."""
        for osd in self.osds:
            osd.start_tick(interval)

    async def degraded_report(self) -> List[str]:
        """Objects with a missing/stale placed copy relative to the
        authoritative (assemblable) version -- the PG_DEGRADED accounting
        the qa helpers' wait_for_clean polls.  Mirrors the peering
        authority rules so 'clean' here == 'no actions' there."""
        from ceph_tpu_torch.osd.ecbackend import VERSION_KEY, shard_oid, vt
        from ceph_tpu_torch.osd.pg import POOL_KEY

        km = self.backend.km
        k = 1 if self.ec is None else self.ec.get_data_chunk_count()
        degraded = []
        oids = set()
        metas = set()
        for osd in self.osds:
            if self.messenger.is_down(osd.name):
                continue
            for stored in osd.store.list_objects():
                base, _, tag = stored.rpartition("@")
                if not base:
                    continue
                # report on THIS (default) pool only; co-hosted pools'
                # objects (meta twins included) carry their POOL_KEY tag
                ptag = osd.store.getattr(stored, POOL_KEY)
                if ptag is not None and ptag != self.pool:
                    continue
                (metas if tag == "meta" else oids).add(base)
        for oid in sorted(oids):
            acting = self.backend.acting_set(oid)
            counts: Dict[tuple, int] = {}
            unseen = 0
            placed: Dict[int, tuple] = {}
            for s in range(km):
                if acting[s] is None:
                    continue
                osd = self.osds[acting[s]]
                if self.messenger.is_down(osd.name):
                    unseen += 1
                    continue
                try:
                    v = vt(osd.store.getattr(shard_oid(oid, s), VERSION_KEY))
                except FileNotFoundError:
                    placed[s] = None
                    continue
                placed[s] = v
                counts[v] = counts.get(v, 0) + 1
            if not counts:
                continue
            authoritative = None
            for v in sorted(counts, reverse=True):
                if counts[v] >= k:
                    authoritative = v
                    break
                if counts[v] + unseen >= k:
                    break
            if authoritative is None:
                continue  # incomplete/debris: not recoverable right now
            if any(cur != authoritative for cur in placed.values()):
                degraded.append(oid)
        for oid in sorted(metas):
            acting = self.backend.acting_set(oid)
            vers = []
            for s in range(km):
                if acting[s] is None:
                    continue
                osd = self.osds[acting[s]]
                if self.messenger.is_down(osd.name):
                    continue
                try:
                    vers.append(
                        osd.store.getattr(f"{oid}@meta", "_meta_version") or 0
                    )
                except FileNotFoundError:
                    vers.append(0)
            if vers and min(vers) != max(vers):
                degraded.append(f"{oid}@meta")
        return degraded

    # -- failure control (thrasher surface) --------------------------------

    def _notify_peering(self) -> None:
        """OSD up/down/weight events wake every peering loop immediately
        (event-driven peering; the reference re-peers on OSDMap change)."""
        for osd in self.osds:
            osd.request_peering()

    def _primary_backend_for(self, pool: str, oid: str):
        """The hosted engine currently leading ``oid`` in ``pool``
        (None while no up OSD can lead it)."""
        for osd in self.osds:
            b = osd.pools.get(pool)
            if b is None:
                continue
            acting = b.acting_set(oid)
            for s in range(b.km):
                if b._shard_up(acting, s):
                    return self.osds[acting[s]].pools.get(pool)
            return None
        return None

    def _mark_down_victims(self, osd_id: int, reason: str) -> None:
        """Liveness-event degraded accounting: walk the victim OSD's
        holdings ONCE (event time, never scrape time) and record each
        base object on its current primary's incremental pg_stats.
        This is what keeps ``ClusterState.degraded_objects()`` O(degraded)
        per call -- the per-object census happens only when an OSD
        actually dies or loses its disk."""
        from ceph_tpu_torch.osd.pg import POOL_KEY

        osd = self.osds[osd_id]
        for stored in osd.store.list_objects():
            base, _, tag = stored.rpartition("@")
            if not base:
                continue
            pool = osd.store.getattr(stored, POOL_KEY) or self.pool
            primary = self._primary_backend_for(pool, base)
            if primary is not None:
                primary.pg_stats.note_down_victims(reason, [base])

    def note_remap(self, before: Dict[int, list]) -> None:
        """Event-time misplaced census after a CRUSH change (the
        discipline: account where the event happens, never at
        scrape time).  ``before`` is the default pool's pg->acting
        snapshot taken BEFORE the map mutated; every stored object whose
        pg moved is marked misplaced on its (new) primary, so the
        misplaced peak is visible the moment the map commits and drains
        monotonically as backfill completes."""
        if self.placement is None:
            return
        from ceph_tpu_torch.osd.placement import movement_plan
        from ceph_tpu_torch.osd.pg import POOL_KEY

        moved_pgs = {
            pg for pg, _pos, _src, _dst
            in movement_plan(before, self.placement.pg_actings())
        }
        if not moved_pgs:
            return
        seen: set = set()
        for osd in self.osds:
            if self.messenger.is_down(osd.name):
                continue
            for stored in osd.store.list_objects():
                base, _, tag = stored.rpartition("@")
                if not base or tag == "meta" or base in seen:
                    continue
                ptag = osd.store.getattr(stored, POOL_KEY)
                if ptag is not None and ptag != self.pool:
                    continue  # other pools have their own placements
                if self.placement.pg_of(base) not in moved_pgs:
                    continue
                seen.add(base)
                primary = self._primary_backend_for(self.pool, base)
                if primary is not None:
                    primary.pg_stats.misplaced.add(base)

    def kill_osd(self, osd_id: int) -> None:
        self.messenger.mark_down(f"osd.{osd_id}")
        self._mark_down_victims(osd_id, f"osd.{osd_id}")
        self._notify_peering()

    def wipe_osd(self, osd_id: int) -> None:
        """Replacement-disk semantics: empty the OSD's object store and
        device tier (its PG log survives -- the daemon kept running,
        the disk was swapped), and reset every peer engine's watermark
        for it (the new-incarnation signal an osdmap epoch bump carries
        in the reference).  The next peering pass then takes the
        backfill path and discovers every shard the OSD lost, which is
        exactly the 'rebuild a killed OSD' scenario the recovery-path
        bench and thrash tests drive."""
        from ceph_tpu_torch.osd.types import Transaction

        osd = self.osds[osd_id]
        # the lost holdings become degraded the moment the disk is
        # swapped (recorded BEFORE the store empties; cleared per object
        # as recovery completes, so the count drains monotonically)
        self._mark_down_victims(osd_id, f"wipe:osd.{osd_id}")
        txn = Transaction()
        for stored in osd.store.list_objects():
            txn.remove(stored)
        osd.store.queue_transaction(txn)
        osd._applied_version.clear()
        osd.tier.clear()
        osd._store_nonempty = False
        osd._scrub_bases = None
        # a replaced disk is a new incarnation: a peering pass already in
        # flight stores its watermark for this OSD after the pops below,
        # and only the boot_id change makes its next pass backfill
        osd.boot_id = os.urandom(8).hex()
        for other in self.osds:
            for backend in other.pools.values():
                backend._peer_seq.pop(osd.name, None)
                backend._peer_dup_seq.pop(osd.name, None)
        self._notify_peering()

    def revive_osd(self, osd_id: int) -> None:
        self.messenger.mark_up(f"osd.{osd_id}")
        # the revived OSD's copies are back: drop exactly the degraded
        # markings its death caused (wipe markings stay -- that data is
        # genuinely gone until recovery rebuilds it)
        for osd in self.osds:
            for backend in osd.pools.values():
                backend.pg_stats.clear_down_reason(f"osd.{osd_id}")
        self._notify_peering()

    def out_osd(self, osd_id: int) -> None:
        """Mark an OSD out: CRUSH remaps its shards (weight -> 0)."""
        if self.placement is not None:
            before = self.placement.pg_actings()
            self.placement.mark_out(osd_id)
            self.note_remap(before)
        self._notify_peering()

    def in_osd(self, osd_id: int, weight: float = 1.0) -> None:
        if self.placement is not None:
            before = self.placement.pg_actings()
            self.placement.mark_in(osd_id, weight)
            self.note_remap(before)
        self._notify_peering()

    # -- elastic membership (online add/remove) ----------------------------

    def add_osd(self, weight: float = 1.0,
                update_placement: bool = True) -> int:
        """Online expansion: spawn a new OSD daemon, host every existing
        pool on it, and widen every engine's membership view -- all while
        the cluster keeps serving.  With ``update_placement`` the shared
        CRUSH map grows and the osd weights in immediately (harness
        mode); mon-backed clusters pass False and let the ``osd add``
        broadcast drive placement growth through apply_map_view's epoch
        gate, so data only moves once the committed map says so."""
        new_id = len(self.osds)
        shard = OSDShard(
            new_id, self.messenger, op_queue=self._op_queue,
            objectstore=self._objectstore, data_path=self._data_path,
            device=self._device,
        )
        # engines first, membership second: peering must never route to
        # an id whose daemon has no engine for the pool yet
        template = self.osds[0]
        for pool_name, b in template.pools.items():
            ec = getattr(b, "ec", None)
            if ec is not None:
                shard.host_pool(pool_name, ec, new_id + 1, b.placement,
                                pool_type="erasure", size=b.km,
                                min_size=b.min_size)
            else:
                shard.host_pool(pool_name, None, new_id + 1, b.placement,
                                pool_type="replicated", size=b.size,
                                min_size=b.min_size)
            shard.pools[pool_name].tier_mode = b.tier_mode
        self.osds.append(shard)
        for osd in self.osds[:-1]:
            for b in osd.pools.values():
                if new_id not in b.osds:
                    b.osds.append(new_id)
        self.backend.n_osds = len(self.osds)
        if update_placement and self.placement is not None:
            before = self.placement.pg_actings()
            self.placement.add_osd(new_id, weight)
            self.note_remap(before)
        self._notify_peering()
        return new_id

    def drain_osd(self, osd_id: int) -> None:
        """Begin graceful contraction: the osd's CRUSH weight drops to 0
        so every PG it serves remaps (primaries hand off first in map
        order); data migrates off via backfill while the daemon keeps
        answering, so clients never see its departure."""
        if self.placement is not None:
            before = self.placement.pg_actings()
            self.placement.remove_osd(osd_id)
            self.note_remap(before)
        self._notify_peering()

    def retire_osd(self, osd_id: int) -> None:
        """Final departure of a DRAINED osd: mark it down without the
        degraded census kill_osd runs -- its acting positions were
        already handed off, so nothing it still stores is load-bearing."""
        self.messenger.mark_down(f"osd.{osd_id}")
        self._notify_peering()

    # -- monitor-backed cluster (mon quorum owns the osdmap) ---------------

    @classmethod
    async def create_with_mons(
        cls,
        n_osds: int,
        profile: Dict[str, str],
        n_mons: int = 3,
        pool: str = "ecpool",
        plugin: Optional[str] = None,
        fault: Optional[FaultInjector] = None,
        hosts=None,
        op_queue: str = "wpq",
        objectstore: str = "memstore",
        data_path: str = "",
    ) -> "ECCluster":
        """Full control-plane bring-up: elect a mon quorum, register OSDs,
        validate + store the EC profile, create the pool — all through
        paxos-committed osdmap epochs — then attach the data path with
        placement driven by mon map broadcasts.

        Reference flow: vstart.sh boots mons before osds; pools/profiles
        are created via `ceph osd ...` commands that OSDMonitor validates
        and commits (SURVEY.md §3.5)."""
        from ceph_tpu_torch.mon.monitor import MonClient, MonCluster

        plugin = plugin or dict(profile).pop("plugin", DEFAULT_PLUGIN)
        profile = {k: v for k, v in profile.items() if k != "plugin"}
        self = cls(
            n_osds, dict(profile), plugin=plugin, fault=fault,
            use_crush=True, hosts=hosts, op_queue=op_queue,
            objectstore=objectstore, data_path=data_path,
        )
        self.mons = MonCluster(n_mons, self.messenger)
        await self.mons.form_quorum()
        self.monc = MonClient(self.messenger, n_mons, self.backend.name)
        # route mon replies and map broadcasts through the client dispatcher
        backend = self.backend

        map_state: Dict = {}

        async def mon_hook(msg: dict) -> None:
            if await self.monc.handle_reply(msg):
                return
            if msg.get("type") == "osdmap" and backend.placement is not None:
                from ceph_tpu_torch.mon.osdmap import apply_map_view

                # pg->acting snapshot BEFORE the epoch applies: if the
                # map moved acting sets, the diff drives the event-time
                # misplaced census (O(changes) accounting)
                before = backend.placement.pg_actings()
                # messenger=None: the in-process harness owns its own
                # liveness view (kill_osd/revive_osd mark it directly)
                if apply_map_view(msg["map"], map_state, None,
                                  placements=[backend.placement]):
                    self.note_remap(before)
                    self._notify_peering()  # re-peer on every map epoch
        backend.mon_hook = mon_hook
        full_profile = dict(profile)
        full_profile["plugin"] = plugin
        for cmd in (
            {"prefix": "osd create", "n": n_osds},
            {
                "prefix": "osd erasure-code-profile set",
                "name": f"{pool}-profile",
                "profile": full_profile,
            },
            {
                "prefix": "osd pool create",
                "name": pool,
                "profile": f"{pool}-profile",
                "hosts": hosts,
            },
        ):
            rc, out = await self.monc.command(cmd)
            if rc != 0:
                raise RuntimeError(f"bootstrap {cmd['prefix']}: {out}")
        await self.monc.subscribe()
        return self

    async def mon_command(self, cmd: Dict) -> tuple:
        return await self.monc.command(cmd)

    async def recover_object_shard(
        self, oid: str, shard: int, target_osd: int
    ) -> None:
        await self.backend.recover_shard(oid, shard, target_osd)

    async def deep_scrub(self, oid: str) -> dict:
        return await self.backend.deep_scrub(oid)

    # -- failure detection (OSD heartbeat / mon mark-down analogue) --------

    async def heartbeat_round(self, timeout: float = 0.2) -> list:
        """Ping every OSD; mark unresponsive ones down and return them
        (the OSD↔OSD heartbeat + OSDMonitor mark-down roles, reference
        src/osd/OSD.cc:4612 handle_osd_ping, failure reports to the mon)."""
        import asyncio as _asyncio

        name = "heartbeat-monitor"
        self._hb_pongs: set = set()
        if name not in self.messenger._queues:

            async def collect(src, msg):
                if isinstance(msg, tuple) and msg[0] == "pong":
                    self._hb_pongs.add(msg[1])

            self.messenger.register(name, collect)
        for osd in self.osds:
            await self.messenger.send_message(name, osd.name, "ping")
        await _asyncio.sleep(timeout)
        newly_down = []
        for osd in self.osds:
            if (
                osd.name not in self._hb_pongs
                and not self.messenger.is_down(osd.name)
            ):
                self.messenger.mark_down(osd.name)
                newly_down.append(osd.osd_id)
        return newly_down

    async def shutdown(self) -> None:
        await self.messenger.shutdown()
        for osd in self.osds:
            # settle the shared device ledger: a dead daemon's resident
            # tier bytes must not stay charged against live ones
            osd.tier.clear()
            umount = getattr(osd.store, "umount", None)
            if umount is not None:
                umount()
