"""Elastic membership (``osd/elastic_bench.py``, ``-w elastic-path``) and
the failover bench (``osd/failover_bench.py``) of the port against the
JAX package's.

Each case of the JAX package's ``tests/test_elastic.py`` runs as the same
script through both packages in one process: the JAX package's
mon-backed cluster on its default plugin (``jerasure``, on the host), the
port's on the ``cuda`` plugin with ``device=cpu`` (the kernels' plain
versions).  Placements, movement plans, every mon command's ``(rc,
out)``, the reads and the moved bytes must be equal.  The elastic bench's
smoke shape runs in both packages: the moved PG set of the +2 expansion
(the ``movement_plan`` between the placements around the map change),
the moved-bytes ratio and every count the bench reports must be equal,
and every gate passes in both.  Times (client latencies, time to clean)
are compared with the gates only.  ``failover_bench`` runs at the tiny
shape of the JAX package's ``tests/test_exactly_once.py`` in both
packages: every kill fires, replays are answered from the PG log, and no
acknowledged write is lost or duplicated.
"""

import asyncio
import types

import numpy as np
import pytest

from ceph_tpu.mon import osdmap as j_osdmap
from ceph_tpu.osd import cluster as j_cluster
from ceph_tpu.osd import elastic_bench as j_elastic_bench
from ceph_tpu.osd import failover_bench as j_failover_bench
from ceph_tpu.osd import placement as j_placement
from ceph_tpu.utils import config as j_config
from ceph_tpu.utils.perf import PerfCounters as JPerfCounters
from ceph_tpu_torch.mon import osdmap
from ceph_tpu_torch.osd import (cluster, elastic_bench, failover_bench,
                                placement)
from ceph_tpu_torch.utils import config
from ceph_tpu_torch.utils.perf import PerfCounters
from torch_verify import port_verifiers

PROFILE = {"k": "2", "m": "1"}
PORT = types.SimpleNamespace(
    name="port", placement=placement, osdmap=osdmap, config=config,
    elastic_bench=elastic_bench, failover_bench=failover_bench,
    PerfCounters=PerfCounters,
    elastic_profile=dict(elastic_bench.PROFILE, device="cpu"),
    failover_profile=dict(failover_bench.PROFILE, device="cpu"),
    with_mons=lambda n, **kw: cluster.ECCluster.create_with_mons(
        n, dict(PROFILE, plugin="cuda", device="cpu"), **kw))
JAX = types.SimpleNamespace(
    name="jax", placement=j_placement, osdmap=j_osdmap, config=j_config,
    elastic_bench=j_elastic_bench, failover_bench=j_failover_bench,
    PerfCounters=JPerfCounters,
    with_mons=lambda n, **kw: j_cluster.ECCluster.create_with_mons(
        n, dict(PROFILE, plugin="jerasure"), **kw))
BOTH = (PORT, JAX)


@pytest.fixture(autouse=True)
def _loop_policy():
    """Both packages' loops run under the port's verifiers
    (``tests/torch_verify.py``): its atomic-section verifier, which holds
    both packages' sections, and its residency verifier."""
    with port_verifiers():
        yield


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _both(scenario):
    """``scenario(P, log)`` (async) in each package; both logs equal."""
    logs = {}
    for P in BOTH:
        P.PerfCounters.reset_all()
        log = []
        _run(scenario(P, log))
        logs[P.name] = log
    assert logs["port"] == logs["jax"]
    return logs["port"]


async def _converge(cluster, max_rounds: int = 20) -> int:
    """Peering rounds until two consecutive all-clean rounds; returns
    rounds used."""
    zero = 0
    for rnd in range(max_rounds):
        n = 0
        for osd in cluster.osds:
            if cluster.messenger.is_down(osd.name):
                continue
            for backend in osd.pools.values():
                n += await backend.peering_pass()
        mis = sum(len(b.pg_stats.misplaced)
                  for o in cluster.osds for b in o.pools.values())
        if n == 0 and mis == 0:
            zero += 1
            if zero >= 2:
                return rnd + 1
        else:
            zero = 0
    return max_rounds


#: seconds the tests' own mon commands, and the JAX package's elastic
#: bench, wait for an answer.  On a loaded CPU a map that leaves 2 OSDs
#: for 3 positions makes every subscriber's CRUSH retry each PG, and the
#: lease ticks then call elections: at the client's 2 s default the JAX
#: package's client can exhaust every mon (-11 'no leader') or resend a
#: committed ``osd add`` (-17 EEXIST; the port's mon answers a resend
#: from its reqid record).  The port's bench runs at the 2 s default.
TEST_MON_WAIT_S = 30.0


async def _cmd(cluster, cmd):
    """A mon command with ``TEST_MON_WAIT_S`` to answer."""
    return await cluster.monc.command(cmd, timeout=TEST_MON_WAIT_S)


async def _wait_weight(cluster, osd_id, nonzero=True):
    for _ in range(100):
        w = (cluster.placement.weights[osd_id]
             if osd_id < len(cluster.placement.weights) else 0)
        if bool(w) == nonzero:
            return
        await asyncio.sleep(0.02)
    raise AssertionError(f"osd.{osd_id}'s weight never applied")


# -- placement growth / movement accounting --------------------------------


def test_placement_grows_and_movement_is_bounded():
    out = {}
    for P in BOTH:
        p = P.placement.CrushPlacement(6, 3)
        before = p.pg_actings()
        wb = list(p.weights)
        p.add_osd(6)
        p.add_osd(7)
        after = p.pg_actings()
        plan = P.placement.movement_plan(before, after)
        floor = P.placement.theoretical_min_moved(wb, p.weights, 128 * 3)
        e0 = p.epoch
        p.remove_osd(7)
        out[P.name] = (plan, floor, list(p.weights), p.epoch - e0,
                       p.pg_actings())
    assert out["port"] == out["jax"]
    plan, floor, weights, bumped, actings = out["port"]
    assert plan and floor > 0 and len(plan) <= 2.0 * floor
    assert weights[7] == 0 and bumped == 1
    assert all(7 not in acting for acting in actings.values())


def test_apply_map_view_grows_placement_for_new_osd():
    def m(epoch, n):
        return {"epoch": epoch,
                "up": {str(i): True for i in range(n)},
                "weights": {str(i): 0x10000 for i in range(n)},
                "max_osd": 6}

    out = {}
    for P in BOTH:
        p = P.placement.CrushPlacement(4, 3)
        state: dict = {}
        log = [P.osdmap.apply_map_view(m(5, 6), state, None,
                                       placements=[p]),
               p.n_osds, list(p.weights), p.pg_actings()]
        log.append(P.osdmap.apply_map_view(m(6, 5), state, None,
                                           placements=[p]))
        log += [list(p.weights),
                P.osdmap.apply_map_view(m(5, 6), state, None,
                                        placements=[p])]
        out[P.name] = log
    assert out["port"] == out["jax"]
    grew, n, weights, actings, shrank, weights2, stale = out["port"]
    assert grew and n == 6 and weights[5] == 0x10000
    assert any(4 in a or 5 in a for a in actings.values())
    assert shrank and weights2[5] == 0 and not stale


# -- mon command negative paths --------------------------------------------


def test_mon_osd_add_rm_negative_paths():
    """The JAX test's commands, each given ``TEST_MON_WAIT_S`` to answer
    (the constant says why)."""
    async def scenario(P, log):
        c = await P.with_mons(3)
        try:
            log.append(await _cmd(c, {"prefix": "osd add", "osd": 1}))
            log.append(await _cmd(c, {"prefix": "osd rm", "osd": 9}))
            log.append(await _cmd(c, {"prefix": "osd rm", "osd": 2}))
            await _wait_weight(c, 2, nonzero=False)
            log.append(await _cmd(c, {"prefix": "osd rm", "osd": 1}))
            log.append(await _cmd(c, {"prefix": "osd out", "osd": 1}))
            new_id = c.add_osd(update_placement=False)
            log.append(await _cmd(c, {"prefix": "osd add",
                                      "osd": new_id}))
            await _wait_weight(c, new_id)
            log.append(await _cmd(c, {"prefix": "osd rm", "osd": 1}))
            log.append(list(c.placement.weights))
        finally:
            await c.shutdown()

    log = _both(scenario)
    assert log[0][0] == -17 and "exists" in log[0][1]
    assert log[1][0] == -2 and "does not exist" in log[1][1]
    assert log[2][0] == 0
    assert log[3][0] == -16 and "min_size" in log[3][1]
    assert log[4][0] == -16 and "min_size" in log[4][1]
    assert log[5][0] == 0 and log[6][0] == 0


# -- relocation recovery (the multi-slot remap case) -----------------------


def test_expansion_relocates_multi_slot_movers():
    async def scenario(P, log):
        c = await P.with_mons(10, pool="elastic")
        try:
            payloads = {}
            oids = [f"eo{i}" for i in range(24)]
            for oid in oids:
                payloads[oid] = (oid * 997).encode()[:4096]
                await c.write(oid, payloads[oid])
            before = {o: list(c.placement.acting(o)) for o in oids}
            for _ in range(2):
                osd_id = c.add_osd(update_placement=False)
                log.append(await c.mon_command(
                    {"prefix": "osd add", "osd": osd_id}))
            await _wait_weight(c, 11)
            multi = sorted(
                o for o in oids
                if sum(1 for a, b in zip(before[o], c.placement.acting(o))
                       if a != b) >= 2)
            log.append(multi)
            log.append(await _converge(c))
            log.append([await c.read(oid) == payloads[oid] for oid in oids])
            log.append(sum(osd.perf.snapshot().get(
                "recovery_backfill_bytes", 0) for osd in c.osds))
        finally:
            await c.shutdown()

    log = _both(scenario)
    multi, rounds, exact, moved = log[2:]
    assert multi, "topology no longer produces multi-slot movers"
    assert rounds < 20 and all(exact) and moved > 0


# -- backfill preemption under client pressure -----------------------------


def test_backfill_preemption_under_expansion():
    async def scenario(P, log):
        cfg = P.config.get_config()
        prior = cfg.get_val("osd_qos_unified")
        cfg.apply_changes({"osd_qos_unified": False})
        c = await P.with_mons(10, pool="elastic")
        try:
            payloads = {f"eo{i}": (f"eo{i}" * 500).encode()[:2048]
                        for i in range(16)}
            for oid, data in payloads.items():
                await c.write(oid, data)
            osd_id = c.add_osd(update_placement=False)
            log.append(await c.mon_command({"prefix": "osd add",
                                            "osd": osd_id}))
            await _wait_weight(c, osd_id)
            for osd in c.osds:
                osd._client_ops_queued = 999
            try:
                log.append(await _converge(c))
            finally:
                for osd in c.osds:
                    osd._client_ops_queued = 0
            log.append(sum(osd.perf.snapshot().get("recovery_preempted", 0)
                           for osd in c.osds) > 0)
            log.append([await c.read(oid) == data
                        for oid, data in payloads.items()])
        finally:
            cfg.apply_changes({"osd_qos_unified": prior})
            await c.shutdown()

    log = _both(scenario)
    assert log[0][0] == 0 and log[1] < 20 and log[2] is True
    assert all(log[3])


# -- the full elastic-path stage (tier-1 smoke shape) ----------------------


#: the bench's results that are times, or counts of client ops that ran
#: while those times passed
TIMED = ("time_to_clean_s", "client_p99_during_expansion_ms",
         "client_ops_total")


def test_elastic_path_bench_smoke(monkeypatch):
    """Both packages' bench at its smoke shape.  The port's bench waits
    the mon client's 2 s default for each mon command; the JAX package's
    cluster is given ``TEST_MON_WAIT_S`` here, so that a reply held past
    2 s cannot turn its resent ``osd add`` into EEXIST."""
    async def mon_command(self, cmd):
        return await self.monc.command(cmd, timeout=TEST_MON_WAIT_S)

    monkeypatch.setattr(j_cluster.ECCluster, "mon_command", mon_command)
    moved, results = {}, {}
    for P in BOTH:
        harness = P.elastic_bench._Harness
        plans = moved.setdefault(P.name, {})

        def init(self, cluster, payload_bytes, _orig=harness.__init__,
                 plans=plans):
            _orig(self, cluster, payload_bytes)
            plans["before"] = cluster.placement.pg_actings()

        async def converge(self, *a, _orig=harness.converge, plans=plans,
                           P=P, **kw):
            if "plan" not in plans:
                plans["plan"] = P.placement.movement_plan(
                    plans["before"], self.cluster.placement.pg_actings())
            return await _orig(self, *a, **kw)

        monkeypatch.setattr(harness, "__init__", init)
        monkeypatch.setattr(harness, "converge", converge)
        kw = {"profile": P.elastic_profile} if P is PORT else {}
        results[P.name] = P.elastic_bench.run_elastic_path_bench(
            smoke=True, **kw)
    mine, theirs = results["port"], results["jax"]
    assert moved["port"]["plan"] == moved["jax"]["plan"]
    assert sorted({pg for pg, *_ in moved["port"]["plan"]})
    assert mine.pop("steady_library_builds") == 0
    for key in TIMED:
        mine.pop(key), theirs.pop(key)
    assert mine == theirs
    assert mine["bit_exact"] is True
    assert mine["data_moved_ratio"] <= 1.25
    assert 0 < mine["misplaced_peak"] and mine["misplaced_upticks"] <= 2
    assert mine["chaos"]["target_kill"]["killed_mid_migration"]
    assert mine["chaos"]["flap"]["residue"] == 0
    assert mine["audited_writes"] > 0


def test_elastic_path_bench_runs_the_card_plugin_by_default():
    """Without ``device`` the bench's pool is the card's: without CUDA
    it raises at the pool's creation instead of running on the CPU."""
    import torch

    assert elastic_bench.PROFILE == dict(j_elastic_bench.PROFILE,
                                         plugin="cuda")
    assert failover_bench.PROFILE == dict(j_failover_bench.PROFILE,
                                          plugin="cuda")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        elastic_bench.run_elastic_path_bench(smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        failover_bench.run_failover_bench(n_osds=6, n_objects=6,
                                          obj_bytes=2048, kills=2)


def test_elastic_path_cli_smoke(capsys):
    from ceph_tpu_torch.tools import ec_benchmark

    assert ec_benchmark.main(["-w", "elastic-path", "--smoke",
                              "-P", "device=cpu"]) == 0
    out, err = capsys.readouterr()
    import json

    result = json.loads(out.strip().splitlines()[-1])
    assert result["bit_exact"] is True and result["n_objects"] == 24
    assert "elastic-path 10osd 24x4096B 8cl: moved ratio" in err


# -- the failover bench (tests/test_exactly_once.py's smoke shape) --------


def test_failover_bench_smoke(monkeypatch):
    """Both packages' failover bench at the JAX smoke shape; before each
    cluster shuts down, every object reads back as its acknowledged
    payload and the stores (each shard's version stamp included) are
    captured: the port's equal the JAX package's, so each replayed write
    was applied exactly as often in both."""
    from ceph_tpu_torch.osd import cluster_bench

    out, stores = {}, {}
    for P, ECCluster in ((PORT, cluster.ECCluster),
                         (JAX, j_cluster.ECCluster)):
        orig = ECCluster.shutdown

        async def shutdown(self, _orig=orig, P=P):
            reads = [await self.read(f"fo{i}") for i in range(6)]
            stores[P.name] = (reads, cluster_bench.store_snapshot(self))
            await _orig(self)

        monkeypatch.setattr(ECCluster, "shutdown", shutdown)
        P.PerfCounters.reset_all()
        # the JAX package's bench has its profile fixed (jerasure)
        kw = {"profile": P.failover_profile} if P is PORT else {}
        out[P.name] = P.failover_bench.run_failover_bench(
            n_osds=6, n_objects=6, obj_bytes=2048, kills=2, **kw)
        monkeypatch.setattr(ECCluster, "shutdown", orig)
    for name, r in out.items():
        assert r["kills"] == 2, name
        assert r["dup_op_hit"] >= 1, name
        assert r["ttfs_mean_ms"] > 0 and r["steady_p99_ms"] > 0, name
        assert stores[name][0] == [b"f" * 2048] * 6, name
    counts = ("kills", "op_resend", "dup_op_hit")
    assert {k: out["port"][k] for k in counts} == \
        {k: out["jax"][k] for k in counts}
    assert stores["port"][1] == stores["jax"][1]
