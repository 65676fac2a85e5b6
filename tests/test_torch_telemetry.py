"""The port's wire-fed telemetry and its bench (``mgr/report.py``,
``mgr/pgmap.py``, ``mgr/telemetry_bench.py``), on the CPU.

Mirrors the JAX package's ``tests/test_telemetry.py`` at its sizes:
beacon and report frames on the wire (and a pre-lag peer's), an old
daemon dropping them over TCP, the report schema filter, the PGMap's
staleness, rate, degraded and lag health, the scrape round trip, the
incremental degraded accounting that never walks a store, MemStore's
incremental stats, a restarted daemon forcing backfill discovery, the
wipe-to-clean transition over real TCP and the bench's smoke shape.
Every pool is the ``cuda`` plugin's codec on the CPU (``device=cpu``).
Against the JAX package: the frames' bytes, the schema filter, the
PGMap's health, rates, stats and exposition fed the same frames on the
same virtual clock, ``_parse_prometheus`` on the same text and MemStore's
stats after the same transactions.  Beside them: ``ec_benchmark -w
telemetry-path --smoke`` and the bench's vstart smoke over daemon
processes, both on the CPU.
"""

from __future__ import annotations

import asyncio
import json

import pytest

from ceph_tpu.mgr import pgmap as j_pgmap
from ceph_tpu.mgr import report as j_report
from ceph_tpu.mgr import telemetry_bench as j_bench
from ceph_tpu.msg import wire as j_wire
from ceph_tpu.osd import memstore as j_memstore
from ceph_tpu.osd import types as j_types
from ceph_tpu_torch.mgr import pgmap, report
from ceph_tpu_torch.mgr import telemetry_bench as bench
from ceph_tpu_torch.mgr.pgmap import PGMap
from ceph_tpu_torch.mgr.report import (MgrBeacon, MgrReport, ReportSender,
                                       counter_reported, filter_counters)
from ceph_tpu_torch.msg.wire import decode_message, encode_message
from ceph_tpu_torch.osd import memstore, types
from ceph_tpu_torch.utils.config import get_config
from ceph_tpu_torch.utils.encoding import Encoder
from torch_verify import port_verifiers

CPU = {"device": "cpu"}
#: exposition families the port renames or leaves out, by design
#: (``ceph_library_builds_total`` for ``ceph_jit_retraces_total``; no
#: native-codec gauge in the mgr's fold)
RENAMED = {"ceph_jit_retraces_total": "ceph_library_builds_total"}


@pytest.fixture(autouse=True)
def _loop_policy():
    """Both packages' loops run under the port's verifiers
    (``tests/torch_verify.py``): its atomic-section verifier, which holds
    both packages' sections, and its residency verifier."""
    with port_verifiers():
        yield

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread in this worker while the test runs (the CPU
    codec's products are small; the tier-1 run's other workers share the
    host's cores), restored afterwards."""
    import torch

    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


@pytest.fixture(autouse=True)
def _fairness_gauges():
    """The scenario runner publishes its per-class fairness gauges
    process-wide (``osd/qos.py``): put them back as they were, so no
    later test's exposition carries this one's classes."""
    from ceph_tpu_torch.osd import qos

    prior = qos.fairness_spreads()
    yield
    for klass in qos.fairness_spreads():
        qos.set_fairness_spread(klass, prior.get(klass))



def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


class VirtualClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def _report(name, seq, *, perf=None, pgs=None, lag=None, store=None,
            interval=1.0, R=report):
    stats = {"v": 1, "kind": name.split(".")[0],
             "perf": perf or {}, "pgs": pgs or {}}
    if store:
        stats["store"] = store
    return R.MgrReport(name=name, seq=seq, interval=interval, stats=stats,
                       lag_ms=lag)


class _Both:
    """One PGMap in each package on one virtual clock; ``beacon`` and
    ``report`` feed both the same frame."""

    def __init__(self, expected):
        self.clock = VirtualClock()
        self.port = PGMap(expected=expected, clock=self.clock)
        self.jax = j_pgmap.PGMap(expected=expected, clock=self.clock)

    def beacon(self, name, seq, lag):
        self.port.apply(MgrBeacon(name, seq, lag))
        self.jax.apply(j_report.MgrBeacon(name, seq, lag))

    def report(self, name, seq, **kw):
        self.port.apply(_report(name, seq, **kw))
        self.jax.apply(_report(name, seq, R=j_report, **kw))

    def same(self, what):
        got = getattr(self.port, what)()
        assert got == getattr(self.jax, what)(), what
        return got


# -- wire frames ------------------------------------------------------------


def test_beacon_report_wire_roundtrip():
    beacon = MgrBeacon("osd.3", 17, 2.5)
    rep = _report(
        "osd.3", 18, perf={"client_ops": 9, "recover": {
            "avgcount": 2, "sum": 0.25}},
        pgs={"p": {"state": "active+clean", "degraded": 0}},
        store={"objects": 4, "bytes": 4096}, lag=0.125)
    jrep = _report(
        "osd.3", 18, perf={"client_ops": 9, "recover": {
            "avgcount": 2, "sum": 0.25}},
        pgs={"p": {"state": "active+clean", "degraded": 0}},
        store={"objects": 4, "bytes": 4096}, lag=0.125, R=j_report)
    # the same bytes on the wire in both packages
    assert encode_message(beacon) == j_wire.encode_message(
        j_report.MgrBeacon("osd.3", 17, 2.5))
    assert encode_message(rep) == j_wire.encode_message(jrep)
    b = decode_message(encode_message(beacon))
    assert (b.name, b.seq, b.lag_ms) == ("osd.3", 17, 2.5)
    r = decode_message(encode_message(rep))
    assert r.name == "osd.3" and r.seq == 18
    assert r.stats["perf"]["client_ops"] == 9
    assert r.stats["pgs"]["p"]["state"] == "active+clean"
    assert r.lag_ms == 0.125
    assert isinstance(r.interval, float)


def test_pre_lag_sender_interops():
    """The trailing-optional evolution: a pre-lag peer's beacon/report
    ends before the lag tail; the decoder reads None."""
    enc = Encoder()
    enc.u8(5).string("osd.9").varint(4)  # _MSG_MGR_BEACON, no lag tail
    b = decode_message(enc.bytes())
    assert isinstance(b, MgrBeacon)
    assert (b.name, b.seq, b.lag_ms) == ("osd.9", 4, None)
    enc = Encoder()
    enc.u8(6).string("osd.9").varint(5)  # _MSG_MGR_REPORT
    enc.value(1.0).value({"v": 1, "pgs": {}})
    r = decode_message(enc.bytes())
    assert isinstance(r, MgrReport) and r.lag_ms is None


def test_old_daemon_ignores_report_frames_over_tcp():
    """Forward compat the other way: a peer that predates the report
    frames (its decode_message raises on the new kinds) must DROP them
    -- counted, connection intact, later traffic still delivered."""
    from ceph_tpu_torch.msg import tcp as tcp_mod
    from ceph_tpu_torch.msg.cluster_bench import free_ports
    from ceph_tpu_torch.msg.tcp import TCPMessenger

    async def main():
        ports = free_ports(2)
        addr = {"a": ("127.0.0.1", ports[0]),
                "b": ("127.0.0.1", ports[1])}
        sender = TCPMessenger("a", addr)
        receiver = TCPMessenger("b", addr)
        await sender.start()
        await receiver.start()
        got = []

        async def dispatch(src, msg):
            got.append(msg)

        receiver.register("b", dispatch)
        # the simulated old build predates the native codec too: pin
        # the receiver to the Python decode seam this test patches
        receiver._native = None
        real_decode = tcp_mod.decode_message

        def pre_report_decode(body):
            kind = body[0]
            if kind in (5, 6):  # this "old build" has no mgr frames
                raise ValueError(f"unknown message type {kind}")
            return real_decode(body)

        tcp_mod.decode_message = pre_report_decode
        try:
            await sender.send_message("a", "b", MgrBeacon("a", 1, 0.0))
            await sender.send_message(
                "a", "b", _report("a", 2, perf={"client_ops": 1}))
            await sender.send_message("a", "b", {"op": "after"})
            for _ in range(100):
                if got:
                    break
                await asyncio.sleep(0.02)
        finally:
            tcp_mod.decode_message = real_decode
        assert got == [{"op": "after"}], got
        assert receiver.counters["unknown_msg_dropped"] == 2
        await sender.shutdown()
        await receiver.shutdown()

    run(main())


def test_report_schema_filter():
    for key in ("client_ops", "qos_gold_bytes", "some_private_counter",
                "tier_hit", "recover"):
        assert counter_reported(key) == j_report.counter_reported(key), key
    assert counter_reported("client_ops")
    assert counter_reported("qos_gold_bytes")
    assert not counter_reported("some_private_counter")
    snap = {"client_ops": 3, "private": 9, "tier_hit": 2,
            "recover": {"avgcount": 1, "sum": 0.5}}
    assert set(filter_counters(snap)) == {"client_ops", "tier_hit",
                                          "recover"}
    assert filter_counters(snap) == j_report.filter_counters(snap)


# -- the PGMap fold, both packages on one clock -----------------------------


def test_pgmap_staleness_osd_down_and_pg_stale():
    m = _Both(["osd.0", "osd.1", "mon.0"])
    # nothing has beaconed yet: every expected daemon is down
    health = m.same("health")
    assert health["status"] == "HEALTH_WARN"
    assert "OSD_DOWN" in health["checks"]
    assert "MON_DOWN" in health["checks"]
    for name in ("osd.0", "osd.1", "mon.0"):
        m.beacon(name, 1, 0.0)
    m.report("osd.0", 2, pgs={"p": {"state": "active+clean",
                                    "degraded": 0}})
    assert m.same("health")["status"] == "HEALTH_OK"
    # beacon silence past the grace: down again (advanced past the pg
    # grace too, so the dead primary's slice reads stale)
    m.clock.now += max(m.port.beacon_grace, m.port.pg_stale_grace) + 0.1
    m.beacon("osd.1", 2, 0.0)
    m.beacon("mon.0", 2, 0.0)
    health = m.same("health")
    assert "OSD_DOWN" in health["checks"]
    assert "osd.0" in health["checks"]["OSD_DOWN"]["summary"]
    assert ("p", "osd.0") in m.same("stale_pgs")
    assert "PG_STALE" in health["checks"]
    assert "stale+active+clean" in m.same("pg_states")


def test_pgmap_rate_engine_and_restart_reset():
    m = _Both(["osd.0"])
    m.report("osd.0", 1, perf={
        "client_ops": 100, "client_wr_bytes": 1 << 20,
        "recovery_bytes": 0})
    m.clock.now += 2.0
    m.report("osd.0", 2, perf={
        "client_ops": 300, "client_wr_bytes": 5 << 20,
        "recovery_bytes": 1 << 20})
    io = m.same("io_rates")
    assert io["client_ops_per_sec"] == pytest.approx(100.0)
    assert io["client_wr_bytes_per_sec"] == pytest.approx(2 << 20)
    assert io["recovery_bytes_per_sec"] == pytest.approx((1 << 20) / 2)
    # daemon restart: counters regress -> rate resets to 0, no negatives
    m.clock.now += 1.0
    m.report("osd.0", 1, perf={"client_ops": 5})
    assert m.same("io_rates")["client_ops_per_sec"] == 0.0


def test_pgmap_degraded_totals_and_health():
    m = _Both(["osd.0"])
    m.report("osd.0", 1, pgs={
        "p": {"state": "active+undersized+degraded+recovering",
              "degraded": 7, "misplaced": 2, "recovering": 3,
              "scrub_errors": 0}})
    health = m.same("health")
    assert "PG_DEGRADED" in health["checks"]
    assert "OBJECT_MISPLACED" in health["checks"]
    assert m.same("totals")["degraded"] == 7
    stat = m.same("pg_stat")
    assert stat["degraded"] == 7 and stat["recovering"] == 3
    # scrub errors escalate to HEALTH_ERR
    m.report("osd.0", 2, pgs={
        "p": {"state": "active+clean", "degraded": 0, "scrub_errors": 1}})
    assert m.same("health")["status"] == "HEALTH_ERR"


def test_daemon_lag_health_requires_sustained_lag():
    m = _Both(["osd.0"])
    warn = m.port.lag_warn_ms
    assert (warn, m.port.lag_sustain) == (m.jax.lag_warn_ms,
                                          m.jax.lag_sustain)
    # one spike: no check (a GC pause must not page an operator)
    m.beacon("osd.0", 1, warn * 2)
    assert "DAEMON_LAG" not in m.same("health")["checks"]
    m.beacon("osd.0", 2, 0.0)  # recovered: streak resets
    for seq in range(3, 3 + m.port.lag_sustain):
        m.beacon("osd.0", seq, warn * 2)
    health = m.same("health")
    assert "DAEMON_LAG" in health["checks"]
    assert "osd.0" in health["checks"]["DAEMON_LAG"]["summary"]


def test_pgmap_prometheus_scrape_roundtrip():
    m = _Both(["osd.0", "osd.1"])
    m.report("osd.0", 1, perf={"client_ops": 10, "sub_write": 4},
             pgs={"p": {"state": "active+degraded", "degraded": 3}},
             store={"objects": 6, "bytes": 12345}, lag=1.5)
    text, jtext = m.port.prometheus_text(), m.jax.prometheus_text()
    samples = bench._parse_prometheus(text)
    # the parse half of the round trip agrees with the JAX package's on
    # both texts, and the two expositions carry the same samples
    assert samples == j_bench._parse_prometheus(text)
    jsamples = {key.replace(old, new): val
                for key, val in j_bench._parse_prometheus(jtext).items()
                for old, new in [next(((o, n) for o, n in RENAMED.items()
                                       if key.startswith(o)), ("", ""))]}
    assert samples == jsamples
    assert samples['ceph_osd_up{ceph_daemon="osd.0"}'] == 1
    assert samples['ceph_osd_up{ceph_daemon="osd.1"}'] == 0
    assert samples["ceph_degraded_objects"] == 3
    assert samples['ceph_pg_degraded{pool="p",ceph_daemon="osd.0"}'] == 3
    assert samples['ceph_osd_bytes_used{ceph_daemon="osd.0"}'] == 12345
    assert samples[
        'ceph_osd_perf{ceph_daemon="osd.0",counter="sub_write"}'] == 4
    assert samples['ceph_daemon_lag_ms{ceph_daemon="osd.0"}'] == 1.5
    assert "ceph_client_ops_per_sec" in samples
    with pytest.raises(ValueError):
        bench._parse_prometheus("ceph_broken notanumber")


# -- incremental degraded accounting (the full-scan kill) -------------------


def test_incremental_degraded_matches_deep_scan_and_never_walks_stores():
    from ceph_tpu_torch.mgr.mgr import ClusterState, health_checks
    from ceph_tpu_torch.osd.cluster import ECCluster

    async def main():
        c = ECCluster(6, {"k": "2", "m": "1", "device": "cpu"})
        for i in range(12):
            await c.write(f"o{i}", bytes([i]) * 3000)
        cs = ClusterState(c)
        assert cs.degraded_objects() == []
        assert cs.degraded_objects(deep=True) == []
        acting = c.backend.acting_set("o5")
        c.kill_osd(acting[0])
        inc = set(cs.degraded_objects())
        deep = set(cs.degraded_objects(deep=True))
        assert deep and deep <= inc, (deep, inc)
        health = health_checks(cs.dump())
        assert {"OSD_DOWN", "PG_DEGRADED"} <= set(health["checks"])
        c.revive_osd(acting[0])
        assert cs.degraded_objects() == []
        assert health_checks(cs.dump())["status"] == "HEALTH_OK"
        # wipe markings drain only when recovery rebuilds
        c.wipe_osd(acting[0])
        assert cs.degraded_objects()
        await c.shutdown()

    run(main())


def test_scrape_cost_does_not_grow_with_object_count():
    """ClusterState.dump() and OSDShard.mgr_report_stats() perform ZERO
    object-store walks, at any object count."""
    from ceph_tpu_torch.mgr.mgr import ClusterState
    from ceph_tpu_torch.osd.cluster import ECCluster

    async def walks_during_scrape(n_objects: int) -> int:
        c = ECCluster(4, {"k": "2", "m": "1", "device": "cpu"})
        for i in range(n_objects):
            await c.write(f"o{i}", b"x" * 1024)
        cs = ClusterState(c)
        calls = {"n": 0}
        orig = memstore.MemStore.list_objects

        def counting(self):
            calls["n"] += 1
            return orig(self)

        memstore.MemStore.list_objects = counting
        try:
            cs.dump()
            for osd in c.osds:
                osd.mgr_report_stats()
        finally:
            memstore.MemStore.list_objects = orig
        await c.shutdown()
        return calls["n"]

    async def main():
        assert await walks_during_scrape(4) == 0
        assert await walks_during_scrape(40) == 0

    run(main())


def test_memstore_stats_incremental_exactness():
    stores = (memstore.MemStore(), j_memstore.MemStore())
    for store, T in zip(stores, (types.Transaction, j_types.Transaction)):
        store.queue_transaction(
            T().write("a@0", 0, b"x" * 100).write("a@1", 0, b"y" * 50))
        store.queue_transaction(T().omap_setkeys("a@meta", {"k": b"v"}))
    assert stores[0].stats() == stores[1].stats() == \
        {"objects": 3, "shards": 2, "metas": 1, "bytes": 150}
    steps = (lambda T: T().write("a@0", 0, b"z" * 300),
             lambda T: T().truncate("a@0", 10),
             lambda T: T().remove("a@1"))
    for step in steps:
        for store, T in zip(stores, (types.Transaction,
                                     j_types.Transaction)):
            store.queue_transaction(step(T))
        assert stores[0].stats() == stores[1].stats()
    st = stores[0].stats()
    assert st["shards"] == 1 and st["bytes"] == 10
    # exactness against the ground-truth scan (a@meta has no data bytes)
    truth = sum(stores[0].stat(oid) for oid in stores[0].list_objects())
    assert st["bytes"] == truth
    assert st["objects"] == len(stores[0].list_objects())


def test_boot_id_change_forces_backfill_discovery():
    """An OSD 'process restart' (fresh OSDShard, empty store, NEW
    boot_id, same entity) must force peers off their watermarks onto the
    backfill path so the lost shards are rediscovered and rebuilt."""
    from ceph_tpu_torch.osd.cluster import ECCluster
    from ceph_tpu_torch.osd.shard import OSDShard

    async def main():
        c = ECCluster(4, {"k": "2", "m": "1", "device": "cpu"})
        for i in range(8):
            await c.write(f"o{i}", bytes([i]) * 4000)
        for osd in c.osds:
            for b in osd.pools.values():
                await b.peering_pass()
        victim = c.osds[1]
        held = [s for s in victim.store.list_objects()
                if not s.endswith("@meta")]
        assert held, "victim held no shards; pick another topology"
        replacement = OSDShard(1, c.messenger, device="cpu")
        replacement.host_pool(c.pool, c.ec, 4, c.placement)
        c.osds[1] = replacement
        assert replacement.boot_id != victim.boot_id
        restarted = 0
        for osd in c.osds:
            if osd is replacement:
                continue
            for b in osd.pools.values():
                await b.peering_pass()
                restarted += b.perf.snapshot().get(
                    "peering_peer_restarted", 0)
        assert restarted > 0, "no peer noticed the new incarnation"
        deadline = 40
        while deadline and await c.degraded_report():
            for osd in c.osds:
                for b in osd.pools.values():
                    await b.peering_pass()
            deadline -= 1
        assert not await c.degraded_report()
        for s in held:
            assert replacement.store.exists(s), f"{s} never rebuilt"
        for i in range(8):
            assert await c.read(f"o{i}") == bytes([i]) * 4000
        await c.shutdown()

    run(main())


# -- end to end over real TCP ----------------------------------------------


def test_wire_fed_health_wipe_to_clean_over_tcp():
    """HEALTH_OK from wire-fed reports -> wipe -> PG_DEGRADED with
    degraded > 0 -> monotone drain -> HEALTH_OK, every byte of telemetry
    across a socket as a typed beacon/report frame."""
    from ceph_tpu_torch.mgr.pgmap import MgrServer
    from ceph_tpu_torch.msg.cluster_bench import free_ports
    from ceph_tpu_torch.msg.tcp import TCPMessenger
    from ceph_tpu_torch.osd.objecter import Objecter
    from ceph_tpu_torch.osd.placement import CrushPlacement
    from ceph_tpu_torch.osd.shard import OSDShard
    from ceph_tpu_torch.osd.types import Transaction
    from ceph_tpu_torch.plugins import registry as registry_mod

    cfg = get_config()
    tuned = {"mgr_beacon_interval": 0.05, "mgr_report_interval": 0.05,
             "mgr_daemon_beacon_grace": 1.0, "mgr_pg_stale_grace": 2.0,
             "osd_tick_interval": 0.25, "osd_recovery_sleep": 0.05,
             "osd_recovery_batch_bytes": 256 << 10}
    prior = {k: cfg.get_val(k) for k in tuned}

    async def main():
        n = 4
        ec = registry_mod.instance().factory(
            "cuda", {"k": "2", "m": "1", "technique": "reed_sol_van",
                     "device": "cpu"})
        km = ec.get_chunk_count()
        ports = free_ports(n + 2)
        addr = {f"osd.{i}": ("127.0.0.1", ports[i]) for i in range(n)}
        addr["mgr.0"] = ("127.0.0.1", ports[n])
        addr["client"] = ("127.0.0.1", ports[n + 1])
        placement = CrushPlacement(n, km)
        shards, messengers, senders = [], [], []
        for i in range(n):
            mess = TCPMessenger(f"osd.{i}", addr)
            await mess.start()
            shard = OSDShard(i, mess, device="cpu")
            shard.host_pool("p", ec, n, placement)
            shard.start_tick(0.25)
            sender = ReportSender(shard.name, mess,
                                  shard.mgr_report_stats, ["mgr.0"],
                                  perf=shard.perf)
            sender.start()
            shards.append(shard)
            messengers.append(mess)
            senders.append(sender)
        mgr_mess = TCPMessenger("mgr.0", addr)
        await mgr_mess.start()
        mgr = MgrServer("mgr.0", mgr_mess, addr_map=addr)
        client_mess = TCPMessenger("client", addr)
        await client_mess.start()
        client = Objecter(client_mess, km, n, placement=placement,
                          pool="p")
        for i in range(24):
            await client.write(f"w{i}", bytes([i]) * (256 << 10))
        # up to 30 s (the JAX test waits 6 s): on a loaded host the first
        # reports can lag the beacon grace
        for _ in range(300):
            await asyncio.sleep(0.1)
            if mgr.pgmap.health()["status"] == "HEALTH_OK" and \
                    mgr.pgmap.reports_folded > n:
                break
        assert mgr.pgmap.health()["status"] == "HEALTH_OK", \
            mgr.pgmap.health()
        # -- wipe osd.1 in place (replacement disk) --------------------
        victim = shards[1]
        for other in shards:
            b = other.pools["p"]
            for stored in victim.store.list_objects():
                base = stored.rpartition("@")[0]
                if base:
                    acting = b.acting_set(base)
                    for s in range(b.km):
                        if b._shard_up(acting, s):
                            shards[acting[s]].pools[
                                "p"].pg_stats.note_down_victims(
                                "wipe:osd.1", [base])
                            break
            break
        txn = Transaction()
        for stored in victim.store.list_objects():
            txn.remove(stored)
        victim.store.queue_transaction(txn)
        victim._applied_version.clear()
        victim._store_nonempty = False
        victim._scrub_bases = None
        for other in shards:
            for b in other.pools.values():
                b._peer_seq.pop(victim.name, None)
                b._peer_dup_seq.pop(victim.name, None)
        for shard in shards:
            shard.request_peering()
        series = []
        for _ in range(400):
            await asyncio.sleep(0.05)
            series.append(mgr.pgmap.totals()["degraded"])
            if series[-1] == 0 and max(series) > 0 and \
                    mgr.pgmap.health()["status"] == "HEALTH_OK":
                break
        assert max(series) > 0, f"wipe raised no degraded: {series}"
        assert series[-1] == 0, f"never drained: {series[-10:]}"
        peak = series.index(max(series))
        upticks = sum(1 for a, b2 in zip(series[peak:],
                                         series[peak + 1:]) if b2 > a)
        assert upticks <= 1, f"drain not monotone: {series[peak:]}"
        assert mgr.pgmap.health()["status"] == "HEALTH_OK"
        for i in range(24):
            assert await client.read(f"w{i}") == bytes([i]) * (256 << 10)
        text = mgr.pgmap.prometheus_text()
        assert "ceph_degraded_objects 0" in text
        assert 'ceph_osd_up{ceph_daemon="osd.1"} 1' in text
        for sender in senders:
            sender.stop()
        await mgr.stop()
        for mess in messengers + [mgr_mess, client_mess]:
            await mess.shutdown()

    cfg.apply_changes(tuned)
    try:
        run(main())
    finally:
        cfg.apply_changes(prior)


def test_telemetry_bench_smoke():
    result = bench.run_telemetry_bench(smoke=True, profile=CPU)
    assert result["telemetry_overhead_pct"] <= result[
        "overhead_limit_pct"]
    assert result["reports_folded"] > 0
    assert result["chaos"]["degraded_max"] > 0
    assert result["chaos"]["health_final"] == "HEALTH_OK"
    assert result["scrape"]["series_parsed"] > 10


def test_ec_benchmark_telemetry_path_smoke_on_cpu(capsys):
    from ceph_tpu_torch.tools import ec_benchmark

    assert ec_benchmark.main(["-w", "telemetry-path", "--smoke",
                              "-P", "device=cpu"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["overhead_limit_pct"] == 25.0
    assert (result["n_objects"], result["obj_bytes"]) == (16, 8 << 10)
    assert result["chaos"]["health_final"] == "HEALTH_OK"


def test_vstart_smoke_over_daemon_processes(monkeypatch):
    """The bench's real-process arm: OSD and mgr daemons (``python -m
    ceph_tpu_torch.daemon.*``) on the CPU, HEALTH_OK from wire-fed
    reports, an OSD SIGKILLed (OSD_DOWN) and revived empty, the degraded
    count rising then draining to HEALTH_OK over the mgr's admin
    socket."""
    from torch_process_lock import one_cluster_at_a_time

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with one_cluster_at_a_time():
        result = bench.run_vstart_smoke(profile=CPU, wait=60.0)
    assert result["degraded_max"] > 0
    assert result["upticks"] <= 1
    assert result["degraded_series"][-1] == 0
    assert result["health_final"] == "HEALTH_OK"


def test_report_frames_fold_across_packages():
    """A port daemon's frames fold in the JAX package's PGMap and the
    JAX package's in the port's, through each other's wire codec."""
    port, jax = PGMap(expected=["osd.0"]), j_pgmap.PGMap(expected=["osd.0"])
    rep = _report("osd.0", 1, pgs={"p": {"state": "active+clean",
                                         "degraded": 0}})
    jrep = _report("osd.0", 1, pgs={"p": {"state": "active+clean",
                                          "degraded": 0}}, R=j_report)
    jax.apply(j_wire.decode_message(encode_message(rep)))
    port.apply(decode_message(j_wire.encode_message(jrep)))
    assert port.pg_stat() == jax.pg_stat()
    assert port.totals() == jax.totals()
    assert pgmap.fold_health({}) == j_pgmap.fold_health({})
