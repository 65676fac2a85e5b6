"""The port's replicated pools (``osd/replicated.py``) against the JAX
package's.

Each case of the JAX package's ``tests/test_replicated.py`` runs as the
same script of calls through both packages' clusters in one process, with
payloads made with numpy from a seed: what each call returns, and every
stored object's data, attrs and omap in every OSD's store afterwards, must
be identical (zero tolerance: these are stored bytes).  Co-hosted pools run
the port's EC pool on the ``cuda`` plugin with profile ``device=cpu`` and
the JAX package's on ``jerasure``: the same code, the same shard bytes.
The JAX package's two ``Rados``-level cases (``ceph_tpu/client``, not
ported) run here through the objecter, the layer ``Rados`` wraps.
"""

import asyncio
import types

import numpy as np
import pytest

from ceph_tpu.osd import cluster as j_cluster
from ceph_tpu.osd import pg as j_pg
from ceph_tpu.osd import replicated as j_replicated
from ceph_tpu.osd import types as j_types
from ceph_tpu.utils import config as j_config
from ceph_tpu.utils.perf import PerfCounters as JPerfCounters
from ceph_tpu_torch.osd import cluster, cluster_bench, pg, replicated
from ceph_tpu_torch.osd import types as t_types
from ceph_tpu_torch.utils import config
from ceph_tpu_torch.utils.perf import PerfCounters
from torch_verify import port_verifiers

EC_PROFILE = {"k": "4", "m": "2", "technique": "reed_sol_van"}

PORT = types.SimpleNamespace(
    name="port", ECCluster=cluster.ECCluster, pg=pg, REMOVED=replicated.REMOVED,
    ReplicatedBackend=replicated.ReplicatedBackend,
    Transaction=t_types.Transaction, config=config, PerfCounters=PerfCounters,
    make_ec=lambda n, prof: cluster.ECCluster(
        n, dict(prof, device="cpu"), plugin="cuda"))
JAX = types.SimpleNamespace(
    name="jax", ECCluster=j_cluster.ECCluster, pg=j_pg,
    REMOVED=j_replicated.REMOVED,
    ReplicatedBackend=j_replicated.ReplicatedBackend,
    Transaction=j_types.Transaction, config=j_config,
    PerfCounters=JPerfCounters,
    make_ec=lambda n, prof: j_cluster.ECCluster(
        n, dict(prof), plugin="jerasure"))


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


def _bytes(rng, n):
    return rng.randint(0, 256, size=n, dtype=np.uint8).tobytes()


def make_cluster(P, n_osds=5, size=3, **kw):
    return P.ECCluster(n_osds, {"size": str(size)}, pool_type="replicated",
                       **kw)


async def _raises(coro):
    try:
        await coro
        return "no error"
    except Exception as exc:  # noqa: BLE001 -- the outcome is compared
        return type(exc).__name__


# -- the cases of the JAX package's tests/test_replicated.py ---------------


async def _write_read_roundtrip(P, rng):
    c = make_cluster(P)
    payload = _bytes(rng, 100_000)
    await c.write("obj", payload)
    seen = [await c.read("obj") == payload]
    await c.write("obj", b"short")  # overwrite shrinks
    seen.append(await c.read("obj") == b"short")
    return c, seen


async def _every_replica_full_copy(P, rng):
    c = make_cluster(P)
    data = _bytes(rng, 900)
    await c.write("obj", data)
    acting = c.backend.acting_set("obj")
    copies = [c.osds[acting[s]].store.read(P.pg.shard_oid("obj", s)) == data
              for s in range(c.backend.km) if acting[s] is not None]
    return c, [copies == [True] * 3, acting]


async def _write_range_read_range(P, rng):
    c = make_cluster(P)
    await c.write("obj", b"A" * 10_000)
    await c.write_range("obj", 5_000, b"B" * 2_000)
    seen = [await c.read("obj") == b"A" * 5_000 + b"B" * 2_000 + b"A" * 3_000,
            await c.read_range("obj", 4_999, 3) == b"ABB"]
    await c.write_range("obj", 10_000, b"C" * 100)  # append extends
    seen += [(await c.backend.stat("obj"))[0] == 10_100,
             await c.read_range("obj", 10_090, 20) == b"C" * 10]
    return c, seen


async def _remove_then_read_raises(P, rng):
    c = make_cluster(P)
    await c.write("obj", b"doomed")
    await c.backend.remove_object("obj")
    seen = [await _raises(c.read("obj")) == "OSError"]
    size, hinfo = await c.backend.stat("obj")
    return c, seen + [size == 0 and hinfo is None]


async def _degraded_write_read(P, rng):
    """size=3 min_size=2: one dead replica must not block I/O."""
    c = make_cluster(P)
    await c.write("obj", b"x" * 50_000)
    acting = c.backend.acting_set("obj")
    c.kill_osd(acting[0])  # kill the primary holder
    data = _bytes(rng, 50_000)
    await c.write("obj", data)  # degraded write, new primary
    return c, [await c.read("obj") == data]


async def _stale_replica_never_serves_old(P, rng):
    c = make_cluster(P)
    await c.write("obj", b"v1" * 1000)
    acting = c.backend.acting_set("obj")
    c.kill_osd(acting[0])
    await c.write("obj", b"v2" * 1000)
    c.revive_osd(acting[0])
    return c, [await c.read("obj") == b"v2" * 1000]


async def _peering_recovers_stale_replica(P, rng):
    c = make_cluster(P)
    await c.write("obj", b"p1" * 4096)
    acting = c.backend.acting_set("obj")
    c.kill_osd(acting[1])
    await c.write("obj", b"p2" * 4096)
    c.revive_osd(acting[1])
    await c.primary_backend("obj").peering_pass(backfill=True)
    stale = c.osds[acting[1]].store.read(P.pg.shard_oid("obj", 1))
    return c, [stale == b"p2" * 4096, await c.degraded_report() == []]


async def _removal_tombstone(P, rng):
    """A replica down through the removal must not bring the object back
    when it revives."""
    c = make_cluster(P)
    await c.write("obj", b"ghost" * 1000)
    acting = c.backend.acting_set("obj")
    c.kill_osd(acting[2])
    await c.backend.remove_object("obj")
    c.revive_osd(acting[2])
    seen = [await _raises(c.read("obj")) == "OSError"]
    await c.primary_backend("obj").peering_pass(backfill=True)
    soid = P.pg.shard_oid("obj", 2)
    store = c.osds[acting[2]].store
    seen += [store.getattr(soid, P.pg.WHITEOUT_KEY) == P.REMOVED,
             store.read(soid) == b"",
             await _raises(c.read("obj")) == "OSError"]
    return c, seen


async def _scrub_repairs_divergent_copy(P, rng):
    c = make_cluster(P)
    await c.write("obj", b"S" * 8192)
    acting = c.backend.acting_set("obj")
    soid = P.pg.shard_oid("obj", 1)
    store = c.osds[acting[1]].store
    store.queue_transaction(P.Transaction().write(soid, 0, b"ROT!"))
    report = await c.deep_scrub("obj")
    seen = [not report["ok"],
            1 in (report["crc_errors"] + report["parity_mismatch"])]
    repaired = await c.primary_backend("obj").scrub_repair("obj", report)
    seen += [repaired >= 1, (await c.deep_scrub("obj"))["ok"],
             store.read(soid) == b"S" * 8192]
    return c, seen


async def _snapshots_clone_and_read(P, rng):
    c = make_cluster(P)
    await c.write("obj", b"gen0")
    snapc = {"seq": 1, "snaps": [1]}
    await c.backend.write("obj", b"gen1", snapc=snapc)
    seen = [await c.read("obj") == b"gen1",
            await c.backend.read("obj", snap=1) == b"gen0"]
    ss = await c.backend.list_snaps("obj")
    seen.append([cl["id"] for cl in ss["clones"]] == [1])
    await c.backend.snap_rollback("obj", 1)
    return c, seen + [await c.read("obj") == b"gen0"]


async def _min_size_blocks_writes(P, rng):
    c = make_cluster(P, n_osds=3, size=3)
    await c.write("obj", b"ok")
    acting = c.backend.acting_set("obj")
    c.kill_osd(acting[1])
    c.kill_osd(acting[2])
    return c, [await _raises(c.write("obj", b"blocked")) == "OSError"]


async def _cohosted_pools_disjoint(P, rng):
    c = P.make_ec(6, EC_PROFILE)
    rio = c.add_pool("meta", pool_type="replicated", size=3)
    ec_data, rp_data = _bytes(rng, 10_000), _bytes(rng, 1400)
    await c.write("obj", ec_data)
    await rio.write("obj", rp_data)
    seen = [await c.read("obj") == ec_data, await rio.read("obj") == rp_data,
            (await c.deep_scrub("obj"))["ok"]]
    P.config.get_config().set_val("osd_scrub_objects_per_tick", "16")
    try:
        for osd in c.osds:
            await osd.scrub_tick()
    finally:
        P.config.get_config().set_val("osd_scrub_objects_per_tick", "2")
    seen += [await c.read("obj") == ec_data, await rio.read("obj") == rp_data]
    for osd in c.osds:
        for backend in osd.pools.values():
            await backend.peering_pass(backfill=True)
    seen += [await c.read("obj") == ec_data, await rio.read("obj") == rp_data]
    return c, seen


async def _cohosted_meta_not_cross_claimed(P, rng):
    c = P.make_ec(6, EC_PROFILE)
    rio = c.add_pool("rgw.index", pool_type="replicated", size=3)
    await rio.omap_set("users", {"alice": b"secret"})
    index_meta = "rgw.index/users@meta"
    before = {o.osd_id for o in c.osds if o.store.exists(index_meta)}
    for osd in c.osds:
        for backend in osd.pools.values():
            await backend.peering_pass(backfill=True)
    after = {o.osd_id for o in c.osds if o.store.exists(index_meta)}
    return c, [len(before) == 3, after == before,
               await rio.omap_get("users") == {"alice": b"secret"}]


async def _stat_after_replicated_remove(P, rng):
    """The removal tombstone stats as absent through the objecter (the JAX
    package's ``Rados.stat`` raises FileNotFoundError on it)."""
    c = P.make_ec(5, {"k": "2", "m": "1"})
    rio = c.add_pool("rp", pool_type="replicated", size=3)
    await rio.write("obj", b"hello")
    seen = [(await rio.stat("obj"))[0] == 5]
    await rio.remove_object("obj")
    size, hinfo = await rio.stat("obj")
    return c, seen + [size == 0 and hinfo is None,
                      await _raises(rio.read("obj")) == "OSError"]


async def _omap_only_object(P, rng):
    """An omap-only object (no data write) is stored on its replicas (the
    JAX package's ``rados ls`` lists it)."""
    c = P.make_ec(5, {"k": "2", "m": "1"})
    rio = c.add_pool("rp", pool_type="replicated", size=3)
    await rio.omap_set("cfg", {"a": b"1"})
    holders = [o.osd_id for o in c.osds if o.store.exists("rp/cfg@meta")]
    return c, [await rio.omap_get("cfg") == {"a": b"1"}, len(holders) == 3]


async def _read_refuses_hidden_acked_write(P, rng):
    """With >= min_size placed replicas unreachable the newest acked write
    may be invisible: the read must refuse, never serve the older bytes."""
    c = make_cluster(P, n_osds=3, size=3)
    await c.write("obj", b"v1" * 100)
    acting = c.backend.acting_set("obj")
    c.kill_osd(acting[2])
    await c.write("obj", b"v2" * 100)  # acked by replicas 0,1 only
    c.kill_osd(acting[0])
    c.kill_osd(acting[1])
    c.revive_osd(acting[2])
    seen = [await _raises(c.read("obj")) in ("ObjectIncomplete", "OSError")]
    c.revive_osd(acting[0])
    return c, seen + [await c.read("obj") == b"v2" * 100]


async def _small_objects_with_omap(P, rng):
    """The shape of an RGW bucket index: many small objects with omap in a
    size=3 pool beside an EC pool, read with one replica down; every
    replica's copy equal."""
    c = P.make_ec(8, EC_PROFILE)
    rio = c.add_pool("meta", pool_type="replicated", size=3)
    objs = {f"idx{i}": _bytes(rng, 200 + i) for i in range(24)}
    for oid, data in objs.items():
        await rio.write(oid, data)
        await rio.omap_set(oid, {f"k{i}": data[:8] for i in range(3)})
    c.kill_osd(3)
    seen = [all([await rio.read(oid) == data for oid, data in objs.items()])]
    c.revive_osd(3)
    same = True
    for oid in objs:
        acting = rio.acting_set(oid)
        copies = {c.osds[acting[s]].store.read(f"meta/{oid}@{s}")
                  for s in range(3)}
        same = same and copies == {objs[oid]}
    return c, seen + [same]


SCENARIOS = {
    "write_read_roundtrip": _write_read_roundtrip,
    "every_replica_full_copy": _every_replica_full_copy,
    "write_range_read_range": _write_range_read_range,
    "remove_then_read_raises": _remove_then_read_raises,
    "degraded_write_read": _degraded_write_read,
    "stale_replica_never_serves_old": _stale_replica_never_serves_old,
    "peering_recovers_stale_replica": _peering_recovers_stale_replica,
    "removal_tombstone": _removal_tombstone,
    "scrub_repairs_divergent_copy": _scrub_repairs_divergent_copy,
    "snapshots_clone_and_read": _snapshots_clone_and_read,
    "min_size_blocks_writes": _min_size_blocks_writes,
    "cohosted_pools_disjoint": _cohosted_pools_disjoint,
    "cohosted_meta_not_cross_claimed": _cohosted_meta_not_cross_claimed,
    "stat_after_replicated_remove": _stat_after_replicated_remove,
    "omap_only_object": _omap_only_object,
    "read_refuses_hidden_acked_write": _read_refuses_hidden_acked_write,
    "small_objects_with_omap": _small_objects_with_omap,
}


def _scenario(P, name):
    async def main():
        P.PerfCounters.reset_all()
        c, seen = await SCENARIOS[name](P, np.random.RandomState(31))
        snap = cluster_bench.store_snapshot(c)
        await c.shutdown()
        return seen, snap

    return _run(main())


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_replicated_scenario_matches_jax(name):
    seen, snap = _scenario(PORT, name)
    want_seen, want_snap = _scenario(JAX, name)
    assert seen == want_seen
    assert snap == want_snap
    assert snap
    assert all(x for x in seen if isinstance(x, bool)), seen


def test_replicated_pools_are_ported():
    async def main():
        c = make_cluster(PORT)
        assert c.ec is None and c.pool_type == "replicated"
        backend = c.osds[0].pools[c.pool]
        assert isinstance(backend, replicated.ReplicatedBackend)
        assert (backend.size, backend.k, backend.km, backend.min_size) == \
            (3, 1, 3, 2)
        assert all(o.tier.device.type == "cpu" for o in c.osds)
        await c.shutdown()
        ec = PORT.make_ec(6, {"k": "2", "m": "1"})
        rio = ec.add_pool("meta", pool_type="replicated", size=3)
        assert rio.km == 3
        assert isinstance(ec.osds[0].pools["meta"],
                          replicated.ReplicatedBackend)
        assert isinstance(ec.osds[0].host_pool(
            "meta2", None, 6, pool_type="replicated", size=2),
            replicated.ReplicatedBackend)
        await ec.shutdown()

    _run(main())
