"""ScenarioRunner: scenario-diverse scale runs over the real-TCP path.

Port of ``ceph_tpu/loadgen/scenario.py``.  One deliberate difference:
after the run the settle step marks every (revived) OSD up in every
hub's view before the exactly-once audit, where the JAX package leaves
the hubs' demotions (a timed-out probe on a loaded host) in place and
counts the counters it then cannot read as mismatches.  The pool's codec
follows
``profile`` laid over reed_sol_van ``k``/``m``: the ``cuda`` plugin by
default, on the card (the JAX package's runner hard-codes ``jerasure`` on
the host), and on the CPU only where ``profile`` says ``device=cpu``.
Each OSD's device cache tier lives on the codec's device.

One scenario = a real localhost-TCP cluster (every byte through
``msg/tcp.py``), N client groups (each a profile + arrival process +
QoS class), and a chaos set running CONCURRENTLY with the load:

* ``thrash``  -- true TCP kills: a victim OSD's listener is closed and
  its sockets torn, so clients discover the death by failed probes and
  fail over, exactly-once gated by the reqid dup machinery;
* ``rebuild`` -- one OSD's store is wiped mid-run (replacement-disk
  semantics) and the batched background recovery plane rebuilds it
  under load, admitted through the unified QoS layer;
* ``promote`` -- pools run in writeback tier mode, so hot objects
  promote into the device tier during the run (tier ticks);
* ``churn``   -- elastic membership under load (docs/elasticity.md): a
  victim OSD is weighted OUT of CRUSH mid-run while its daemon keeps
  serving -- data drains off through the placement-epoch-skew backfill
  on the peering tick -- then weighted back IN, migrating everything
  home again.  Both remaps run concurrently with the client load and
  the exactly-once audit.

Scale machinery: thousands of Objecters multiplex over a handful of
client-hub messengers via the ``<name>@<hub>`` entity aliasing
(msg/tcp.py ``_node_of``), so a 1000-client run costs tens of sockets,
not thousands; per-client in-flight budgets bound harness memory.

Results: per-group throughput/latency percentiles, per-class fairness
spread (max/min achieved per-client ops within a group -- published to
the prometheus gauge via osd/qos.py), pooled saturation p99, and the
exactly-once audit: every transactional client's counters are read
back and must equal its acked successes (bounded only by explicitly
booked indeterminate outcomes).
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import random
import time
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.loadgen.arrival import ClosedLoop, OpenLoop
from ceph_tpu_torch.loadgen.clients import LoadClient
from ceph_tpu_torch.loadgen.profiles import PROFILES
from ceph_tpu_torch.utils.encoding import Decoder

#: clients per hub messenger (bounds sockets AND dispatch-loop tasks
#: per hub); hubs = ceil(clients / HUB_FANOUT), capped.  The cap
#: clears the 10^4-client stage (qos_bench scale10x): 10_000 / 256 =
#: 40 hubs, still just tens of sockets against the cluster
HUB_FANOUT = 256
MAX_HUBS = 40


@dataclasses.dataclass(frozen=True)
class ClientGroup:
    count: int
    profile: str = "rgw"
    qos_class: Optional[str] = None
    mode: str = "closed"          # "closed" | "open"
    rate_ops_s: float = 2.0       # per client, open-loop only
    think_s: float = 0.0          # closed-loop think time
    #: closed-loop vectorized submit: > 1 drives put/get through
    #: Objecter.submit_many in chunks of this many sampled ops (one
    #: submit stage crossing + one wire burst per chunk)
    batch_ops: int = 1


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    duration_s: float
    groups: Tuple[ClientGroup, ...]
    chaos: Tuple[str, ...] = ()
    seed: int = 1234


@dataclasses.dataclass
class ScenarioResult:
    scenario: str
    wall_s: float
    n_clients: int
    ops: int
    errors: int
    ops_per_s: float
    p50_ms: float
    p99_ms: float
    groups: List[dict]
    cas_clients: int
    cas_exact: bool
    cas_mismatches: int
    #: exec counters that overshot acked successes within the
    #: DOCUMENTED mid-method replay window (docs/resilience.md Limits:
    #: a primary dying between a cls method's internal mutations and
    #: its awaited dup_record fan-out re-executes the method) -- only
    #: accepted when the owning client demonstrably failed over
    exec_replays: int
    client_resends: int
    indeterminate: int
    arrivals_shed: int
    inflight_hwm: int
    dup_op_hits: int
    kills: int
    wipes: int
    qos_counters: Dict[str, int]
    #: wire-fed telemetry gate fields (telemetry=True runs an mgr
    #: endpoint fed by per-OSD ReportSenders over the same real TCP and
    #: samples cluster health during the run): the degraded-objects
    #: series around a chaos wipe, its peak, whether it drained
    #: monotonically (bounded transient upticks from concurrent load),
    #: and the final health status
    health_timeline: List[tuple] = dataclasses.field(default_factory=list)
    degraded_max: int = 0
    degraded_final: int = 0
    degraded_monotonic_violations: int = 0
    health_final: str = ""
    #: chaos=churn: CRUSH weight flips applied mid-run (out + back in)
    churn_events: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _pct(samples: List[float], q: float) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(len(s) - 1, int(q * len(s)))]


class ScenarioRunner:
    """Boots the TCP cluster, drives one Scenario, collects results."""

    #: config shrunk to the mini-cluster's chaos time scale for the
    #: run's duration (restored on shutdown)
    TUNING = {
        "client_probe_grace": 0.15,
        "client_probe_retries": 1,
        "client_backoff_base": 0.02,
        "client_backoff_max": 0.4,
        "osd_client_op_commit_timeout": 3.0,
        "osd_read_gather_timeout": 3.0,
        # a saturated scale run holds thousands of ops past the default
        # 5s complaint time; per-op WARNING logging at that volume is
        # its own load source (the forensics ring still records them)
        "osd_op_complaint_time": 60.0,
    }

    def __init__(self, scenario: Scenario, *, n_osds: int = 6,
                 k: int = 2, m: int = 1, op_queue: str = "mclock",
                 pool: str = "lgpool", op_timeout: float = 20.0,
                 tuning: Optional[Dict[str, object]] = None,
                 telemetry: bool = False,
                 profile: Optional[Dict[str, str]] = None):
        # at scale the probe grace must sit ABOVE the loaded op p50:
        # a probe tears down the hub's SHARED connection to re-test the
        # wire, so a grace below typical queueing latency makes every
        # queued op probe, killing the socket 250 other clients are
        # multiplexed over -- a self-inflicted livelock.  Scenarios
        # with heavy closed-loop overload pass a larger grace via
        # ``tuning``; chaos failover then costs ~grace to detect, which
        # is the honest price of not lying to the failure detector.
        self.tuning = dict(self.TUNING)
        self.telemetry = telemetry
        if telemetry:
            # wire-fed health must react on the chaos time scale
            self.tuning.update({
                "mgr_beacon_interval": 0.1,
                "mgr_report_interval": 0.2,
                "mgr_daemon_beacon_grace": 1.0,
                "mgr_pg_stale_grace": 2.0,
            })
        if tuning:
            self.tuning.update(tuning)
        self.scenario = scenario
        self.n_osds = n_osds
        self.k = k
        self.m = m
        self.op_queue = op_queue
        self.pool = pool
        self.op_timeout = op_timeout
        self.profile = dict(profile or {})
        self.osds = []
        self.osd_messengers = []
        self.hubs = []
        self.clients: List[LoadClient] = []
        self._client_groups: List[Tuple[ClientGroup, List[LoadClient]]] = []
        self.kills = 0
        self.wipes = 0
        self._churn_events = 0
        self._prior_cfg: Dict[str, object] = {}
        self._rng = random.Random(scenario.seed)
        self.perf = None
        self.placement = None
        self.ec = None
        self.mgr = None
        self._mgr_messenger = None
        self._reporters: List[object] = []
        self._health_samples: List[tuple] = []

    # -- cluster lifecycle --------------------------------------------------

    async def start(self) -> None:
        from ceph_tpu_torch.device import codec_device
        from ceph_tpu_torch.msg.cluster_bench import free_ports
        from ceph_tpu_torch.osd.cluster import DEFAULT_PLUGIN
        from ceph_tpu_torch.msg.fault import FaultInjector
        from ceph_tpu_torch.msg.tcp import TCPMessenger
        from ceph_tpu_torch.osd.placement import CrushPlacement
        from ceph_tpu_torch.osd.shard import OSDShard
        from ceph_tpu_torch.plugins import registry as registry_mod
        from ceph_tpu_torch.utils.config import get_config
        from ceph_tpu_torch.utils.perf import PerfCounters

        cfg = get_config()
        for key, val in self.tuning.items():
            self._prior_cfg[key] = cfg.get_val(key)
        cfg.apply_changes(dict(self.tuning))

        self.perf = PerfCounters("loadgen")
        profile = dict({"k": str(self.k), "m": str(self.m),
                        "technique": "reed_sol_van"}, **self.profile)
        plugin = profile.pop("plugin", DEFAULT_PLUGIN)
        self.ec = registry_mod.instance().factory(plugin, profile)
        device = codec_device(self.ec)
        km = self.ec.get_chunk_count()
        n_clients = sum(g.count for g in self.scenario.groups)
        n_hubs = min(MAX_HUBS, max(1, -(-n_clients // HUB_FANOUT)))
        n_mgrs = 1 if self.telemetry else 0
        ports = free_ports(self.n_osds + n_hubs + n_mgrs)
        addr = {f"osd.{i}": ("127.0.0.1", ports[i])
                for i in range(self.n_osds)}
        for h in range(n_hubs):
            addr[f"lg{h}"] = ("127.0.0.1", ports[self.n_osds + h])
        if n_mgrs:
            addr["mgr.0"] = ("127.0.0.1", ports[self.n_osds + n_hubs])
        self.placement = CrushPlacement(self.n_osds, km)
        for i in range(self.n_osds):
            mess = TCPMessenger(f"osd.{i}", addr, fault=FaultInjector())
            await mess.start()
            shard = OSDShard(i, mess, op_queue=self.op_queue, device=device)
            shard.host_pool(self.pool, self.ec, self.n_osds,
                            self.placement)
            if "promote" in self.scenario.chaos:
                shard.pools[self.pool].tier_mode = "writeback"
            # event-driven peering/scrub/tier ticks: chaos recovery and
            # tier promotion both ride these
            shard.start_tick(0.25)
            self.osd_messengers.append(mess)
            self.osds.append(shard)
        if self.telemetry:
            # the wire-fed telemetry plane rides the SAME real TCP: one
            # mgr endpoint, every OSD running its MgrClient report loop
            from ceph_tpu_torch.mgr.pgmap import MgrServer
            from ceph_tpu_torch.mgr.report import ReportSender

            self._mgr_messenger = TCPMessenger("mgr.0", addr)
            await self._mgr_messenger.start()
            self.mgr = MgrServer("mgr.0", self._mgr_messenger,
                                 addr_map=addr)
            for shard, mess in zip(self.osds, self.osd_messengers):
                sender = ReportSender(shard.name, mess,
                                      shard.mgr_report_stats, ["mgr.0"],
                                      perf=shard.perf)
                sender.start()
                self._reporters.append(sender)
        for h in range(n_hubs):
            hub = TCPMessenger(f"lg{h}", addr, fault=FaultInjector())
            await hub.start()
            self.hubs.append(hub)
        self._build_clients(km, n_hubs)

    def _build_clients(self, km: int, n_hubs: int) -> None:
        from ceph_tpu_torch.osd.objecter import Objecter

        seq = 0
        for group in self.scenario.groups:
            members: List[LoadClient] = []
            for _ in range(group.count):
                hub_i = seq % n_hubs
                name = f"c{seq}@lg{hub_i}"
                seq += 1
                objecter = Objecter(
                    self.hubs[hub_i], km, self.n_osds,
                    placement=self.placement, name=name, pool=self.pool,
                    op_timeout=self.op_timeout,
                    qos_class=group.qos_class,
                )
                arrival = (OpenLoop(group.rate_ops_s)
                           if group.mode == "open"
                           else ClosedLoop(group.think_s))
                client = LoadClient(
                    objecter, PROFILES[group.profile],
                    random.Random(self.scenario.seed * 1000 + seq),
                    arrival=arrival, perf=self.perf,
                    batch_ops=group.batch_ops,
                )
                members.append(client)
                self.clients.append(client)
            self._client_groups.append((group, members))

    async def shutdown(self) -> None:
        from ceph_tpu_torch.utils.config import get_config

        for sender in self._reporters:
            sender.stop()
        if self.mgr is not None:
            await self.mgr.stop()
        messengers = self.hubs + self.osd_messengers
        if self._mgr_messenger is not None:
            messengers.append(self._mgr_messenger)
        for mess in messengers:
            await mess.shutdown()
        for osd in self.osds:
            # settle the shared device ledger: the writeback tier's
            # resident bytes go with the cluster
            osd.tier.clear()
        if self._prior_cfg:
            get_config().apply_changes(self._prior_cfg)

    # -- chaos --------------------------------------------------------------

    async def _kill_osd(self, idx: int) -> None:
        """True TCP death: stop accepting, tear every socket, stop
        executing.  Clients discover it by failed probes (connection
        refused) and fail over; in-flight acks are simply lost."""
        osd = self.osds[idx]
        mess = self.osd_messengers[idx]
        osd.frozen = True
        if self._reporters:
            # a dead daemon must stop beaconing, or the wire-fed map
            # would keep reading it as alive (outbound sends still
            # work after the listener teardown below)
            self._reporters[idx].stop()
        if mess._server is not None:
            mess._server.close()
        for conn in list(mess._conns.values()):
            try:
                conn[1].close()
            except Exception:  # noqa: BLE001 -- already-dead socket
                pass
        mess._conns.clear()
        for task in list(mess._serve_tasks):
            task.cancel()
        self.kills += 1

    async def _revive_osd(self, idx: int) -> None:
        osd = self.osds[idx]
        mess = self.osd_messengers[idx]
        await mess.start()
        osd.frozen = False
        mess.mark_up(osd.name)
        if self._reporters:
            self._reporters[idx].start()
        for shard in self.osds:
            shard.request_peering()

    def _wipe_osd(self, idx: int) -> None:
        """Replacement-disk semantics mid-run (mirrors
        ECCluster.wipe_osd for the TCP harness)."""
        from ceph_tpu_torch.osd.types import Transaction

        osd = self.osds[idx]
        # degraded accounting, event time: the lost holdings land on
        # their primaries' incremental pg_stats BEFORE the store
        # empties, so the wire-fed map shows PG_DEGRADED immediately
        # and drains as the batched rebuild completes objects
        for stored in osd.store.list_objects():
            base, _, _tag = stored.rpartition("@")
            if not base:
                continue
            for other in self.osds:
                b = other.pools.get(self.pool)
                if b is None:
                    continue
                acting = b.acting_set(base)
                for s in range(b.km):
                    if b._shard_up(acting, s):
                        self.osds[acting[s]].pools[
                            self.pool].pg_stats.note_down_victims(
                            f"wipe:{osd.name}", [base])
                        break
                break
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
        for shard in self.osds:
            shard.request_peering()
        self.wipes += 1

    async def _chaos_task(self, stop: asyncio.Event) -> None:
        duration = self.scenario.duration_s
        thrash = "thrash" in self.scenario.chaos
        rebuild = "rebuild" in self.scenario.chaos
        churn = "churn" in self.scenario.chaos
        loop = asyncio.get_event_loop()
        t0 = loop.time()
        wiped = False
        down: Optional[int] = None
        churn_out: Optional[int] = None
        churn_done = False
        while not stop.is_set():
            try:
                await asyncio.wait_for(stop.wait(),
                                       timeout=max(0.2, duration / 8))
                break
            except asyncio.TimeoutError:
                pass
            elapsed = loop.time() - t0
            if rebuild and not wiped and elapsed >= duration / 4:
                self._wipe_osd(self._rng.randrange(self.n_osds))
                wiped = True
                continue
            if churn and not churn_done:
                if churn_out is None and elapsed >= duration / 4:
                    # elastic membership drain (docs/elasticity.md):
                    # weight the victim OUT of CRUSH while its daemon
                    # keeps serving; every engine's next peering tick
                    # sees the epoch skew and backfills the remap
                    churn_out = self._rng.randrange(self.n_osds)
                    self.placement.mark_out(churn_out)
                    self._churn_events += 1
                    continue
                if churn_out is not None and elapsed >= duration * 0.6:
                    self.placement.mark_in(churn_out)
                    self._churn_events += 1
                    churn_out = None
                    churn_done = True
                    continue
            if not thrash:
                continue
            if down is not None:
                await self._revive_osd(down)
                down = None
            elif elapsed < duration * 0.75:
                # stay within the failure budget: one OSD down at a
                # time, and none in the final quarter so the run can
                # settle for the exactly-once audit
                down = self._rng.randrange(self.n_osds)
                await self._kill_osd(down)
        if down is not None:
            await self._revive_osd(down)
        if churn_out is not None:
            # never leave the victim weighted out past the run: the
            # settle window needs the full width for the audit
            self.placement.mark_in(churn_out)
            self._churn_events += 1

    # -- the run ------------------------------------------------------------

    async def _health_sampler(self, stop: asyncio.Event) -> None:
        """Sample the wire-fed map during the run (telemetry=True): the
        chaos gate's degraded-drain series comes from here."""
        loop = asyncio.get_event_loop()
        t0 = loop.time()
        while not stop.is_set():
            await asyncio.sleep(0.2)
            health = self.mgr.pgmap.health()
            degraded = self.mgr.pgmap.totals()["degraded"]
            self._health_samples.append(
                (round(loop.time() - t0, 3), health["status"], degraded))

    async def run(self) -> ScenarioResult:
        stop = asyncio.Event()
        chaos = asyncio.get_event_loop().create_task(
            self._chaos_task(stop))
        sampler = None
        if self.mgr is not None:
            sampler = asyncio.get_event_loop().create_task(
                self._health_sampler(stop))
        t0 = time.perf_counter()
        drivers = [
            asyncio.get_event_loop().create_task(client.run(stop))
            for client in self.clients
        ]
        await asyncio.sleep(self.scenario.duration_s)
        stop.set()
        done, pending = await asyncio.wait(
            drivers, timeout=max(5.0, self.op_timeout))
        for task in pending:
            task.cancel()
        if pending:
            await asyncio.wait(pending, timeout=5.0)
        await chaos
        wall = time.perf_counter() - t0
        # settle: every OSD back up before the audit reads
        for i, osd in enumerate(self.osds):
            if osd.frozen:
                await self._revive_osd(i)
        # ... and up in every hub's view: a probe that timed out on a
        # loaded host demoted a live OSD on its hub, and with every shard
        # of an object demoted the objecter refuses before it sends, so
        # the audit would count a counter it never read as a mismatch
        for hub in self.hubs:
            for osd in self.osds:
                hub.mark_up(osd.name)
        if sampler is not None:
            # keep sampling the drain until the map reads clean (or a
            # bounded settle window expires): the health gate asserts
            # wipe -> degraded>0 -> monotone drain -> HEALTH_OK
            drain_stop = asyncio.Event()
            sampler2 = asyncio.get_event_loop().create_task(
                self._health_sampler(drain_stop))
            deadline = time.perf_counter() + max(20.0, self.op_timeout)
            while time.perf_counter() < deadline:
                await asyncio.sleep(0.25)
                if self.mgr.pgmap.totals()["degraded"] == 0 and \
                        self.mgr.pgmap.health()["status"] == "HEALTH_OK":
                    break
            drain_stop.set()
            await sampler2
            await sampler
        return await self._collect(wall)

    # -- results ------------------------------------------------------------

    async def _collect(self, wall: float) -> ScenarioResult:
        from ceph_tpu_torch.osd import qos as qos_mod

        pooled: List[float] = []
        groups_out: List[dict] = []
        total_ops = total_errors = total_shed = total_indet = 0
        for group, members in self._client_groups:
            ops = [c.stats.ops for c in members]
            lat: List[float] = []
            for c in members:
                lat.extend(c.stats.latencies)
            pooled.extend(lat)
            total_ops += sum(ops)
            total_errors += sum(c.stats.errors for c in members)
            total_shed += sum(c.stats.arrivals_shed for c in members)
            total_indet += sum(c.stats.indeterminate for c in members)
            lo, hi = (min(ops), max(ops)) if ops else (0, 0)
            spread = (hi / lo) if lo > 0 else None
            label = group.qos_class or group.profile
            if spread is not None:
                qos_mod.set_fairness_spread(label, spread)
            groups_out.append({
                "profile": group.profile,
                "qos_class": group.qos_class,
                "mode": group.mode,
                "clients": group.count,
                "ops": sum(ops),
                "errors": sum(c.stats.errors for c in members),
                "ops_per_s": round(sum(ops) / wall, 3),
                "client_ops_min": lo,
                "client_ops_max": hi,
                "clients_at_zero": sum(1 for n in ops if n == 0),
                "fairness_spread": round(spread, 3) if spread else None,
                "p50_ms": round(_pct(lat, 0.50) * 1e3, 3),
                "p99_ms": round(_pct(lat, 0.99) * 1e3, 3),
            })
        cas_clients, mismatches, exec_replays = \
            await self._audit_exactly_once()
        dup_hits = sum(
            osd.perf.snapshot().get("dup_op_hit", 0) for osd in self.osds)
        resends = sum(
            c.objecter.perf.snapshot().get("op_resend", 0)
            for c in self.clients)
        qos_counters: Dict[str, int] = {}
        for osd in self.osds:
            for key, val in osd.perf.snapshot().items():
                if key.startswith("qos_") and isinstance(val, int):
                    qos_counters[key] = qos_counters.get(key, 0) + val
        samples = list(self._health_samples)
        degraded_series = [d for _, _, d in samples]
        degraded_max = max(degraded_series, default=0)
        violations = 0
        if degraded_max:
            # monotone-drain check from the peak: concurrent client
            # writes against a half-rebuilt object can re-dirty it, so
            # bounded transient upticks are tolerated by the caller --
            # the count is reported, the gate decides
            peak_at = degraded_series.index(degraded_max)
            prev = degraded_max
            for d in degraded_series[peak_at:]:
                if d > prev:
                    violations += 1
                prev = d
        return ScenarioResult(
            scenario=self.scenario.name,
            wall_s=round(wall, 3),
            n_clients=len(self.clients),
            ops=total_ops,
            errors=total_errors,
            ops_per_s=round(total_ops / wall, 3),
            p50_ms=round(_pct(pooled, 0.50) * 1e3, 3),
            p99_ms=round(_pct(pooled, 0.99) * 1e3, 3),
            groups=groups_out,
            cas_clients=cas_clients,
            cas_exact=mismatches == 0,
            cas_mismatches=mismatches,
            exec_replays=exec_replays,
            client_resends=resends,
            indeterminate=total_indet,
            arrivals_shed=total_shed,
            inflight_hwm=self.perf.snapshot().get(
                "client_inflight_hwm", 0),
            dup_op_hits=dup_hits,
            kills=self.kills,
            wipes=self.wipes,
            qos_counters=qos_counters,
            health_timeline=samples,
            degraded_max=degraded_max,
            degraded_final=degraded_series[-1] if degraded_series else 0,
            degraded_monotonic_violations=violations,
            health_final=(self.mgr.pgmap.health()["status"]
                          if self.mgr is not None else ""),
            churn_events=self._churn_events,
        )

    async def _audit_exactly_once(self) -> Tuple[int, int, int]:
        """Read every transactional client's counters back: each must
        equal its acked successes exactly, widened only by explicitly
        booked indeterminate outcomes (ops whose ack was lost to a
        chaos window).  A value past that bound is a double-apply; one
        below it is a lost acked op -- both count as mismatches.

        One DOCUMENTED exception (docs/resilience.md Limits): ``exec``
        composes engine ops without a transaction, so a primary dying
        mid-method -- after the internal mutations, before the awaited
        ``dup_record`` fan-out -- re-executes on replay.  An exec
        counter overshooting its acked successes is therefore accepted
        (and counted as an ``exec_replay``) iff the owning client
        demonstrably failed over (op_resend > 0) and the overshoot
        stays within that resend budget; omap_cas has a zero-width
        dup window and gets no such allowance."""
        from ceph_tpu_torch.osd.objecter import Objecter

        verifier = Objecter(
            self.hubs[0], self.ec.get_chunk_count(), self.n_osds,
            placement=self.placement, name=f"auditor@{self.hubs[0].node}",
            pool=self.pool, op_timeout=self.op_timeout,
        )
        checked = 0
        mismatches = 0
        exec_replays = 0
        for client in self.clients:
            st = client.stats
            if st.cas_ok or st.cas_indet:
                checked += 1
                base = client.name.split("@")[0]
                try:
                    raw = (await verifier.omap_get(
                        f"{base}-cnt", ["n"])).get("n")
                    val = Decoder(raw).value() if raw else 0
                except Exception:  # noqa: BLE001 -- an unreadable
                    # counter IS an audit failure
                    mismatches += 1
                    continue
                if not (st.cas_ok <= val <= st.cas_ok + st.cas_indet):
                    mismatches += 1
            if st.exec_ok or st.exec_indet:
                checked += 1
                base = client.name.split("@")[0]
                try:
                    ret, out = await verifier.exec(
                        f"{base}-exn", "version", "get")
                    val = Decoder(out).value() if ret == 0 else -1
                except Exception:  # noqa: BLE001
                    mismatches += 1
                    continue
                hi = st.exec_ok + st.exec_indet
                resends = client.objecter.perf.snapshot().get(
                    "op_resend", 0)
                if st.exec_ok <= val <= hi:
                    pass
                elif hi < val <= hi + resends:
                    # the documented exec mid-method replay window
                    exec_replays += val - hi
                else:
                    mismatches += 1
        return checked, mismatches, exec_replays


async def run_scenario(scenario: Scenario, **kw) -> ScenarioResult:
    """Boot, run, audit, shutdown -- the one-call surface the bench and
    tests use."""
    runner = ScenarioRunner(scenario, **kw)
    await runner.start()
    try:
        return await runner.run()
    finally:
        await runner.shutdown()
