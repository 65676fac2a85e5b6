"""The port's EC cluster (``osd/{cluster,shard,pg,ecbackend,objecter,
recovery}.py``) against the JAX package's.

Every case runs the same script of calls, with the same payloads made with
numpy from a seed, through two clusters in one process: the JAX package's
with the ``tpu`` plugin (on the CPU) and the port's with the ``cuda``
plugin on profile ``device=cpu`` (the kernels' plain versions).  The
tolerance is zero: every stored object's data, attrs and omap in every
OSD's store must be identical, and every read returns the same bytes.  No
attr holds a time, a nonce or a client id (``_version`` is the version
counter and the primary's name, the same in both), so nothing is compared
by type only.  The snapshot paths of ``pg.py`` are not driven here.

The port refuses no path of the in-process cluster.  The paths it once
refused -- the regenerating-repair lane, the mon quorum, OSD caps,
replicated pools, the persistent object stores, the mesh data plane,
object classes and the mgr report -- run here, and are compared with the
JAX package's in full in tests/test_torch_mon.py,
tests/test_torch_replicated.py, tests/test_torch_objectstore.py,
tests/test_torch_mesh_plane.py, tests/test_torch_cls.py and
tests/test_torch_mgr.py.  The device tier is compared in
tests/test_torch_tier.py.
"""

import asyncio
import types

import numpy as np
import pytest

from ceph_tpu.msg.fault import FaultInjector as JFaultInjector
from ceph_tpu.osd import cluster as j_cluster
from ceph_tpu.osd import ecbackend as j_ecbackend
from ceph_tpu.osd import placement as j_placement
from ceph_tpu.osd import types as j_types
from ceph_tpu.utils.perf import PerfCounters as JPerfCounters
from ceph_tpu_torch import objectstore
from ceph_tpu_torch.msg.fault import FaultInjector
from ceph_tpu_torch.osd import cluster, cluster_bench, ecbackend, placement
from ceph_tpu_torch.osd import types as t_types
from ceph_tpu_torch.osd.shard import OSDShard
from ceph_tpu_torch.plugins import registry as registry_mod
from ceph_tpu_torch.utils import config
from ceph_tpu_torch.utils.perf import PerfCounters
from torch_verify import port_verifiers

CODES = {
    "rs_w8": {"technique": "reed_sol_van"},
    "rs_w16": {"technique": "reed_sol_van", "w": "16"},
    "cauchy_good": {"technique": "cauchy_good", "packetsize": "64"},
}


@pytest.fixture(autouse=True)
def _loop_policy():
    """Both packages' loops run under the port's verifiers
    (``tests/torch_verify.py``): its atomic-section verifier, which holds
    both packages' sections, and its residency verifier."""
    with port_verifiers():
        yield


#: the two packages behind one namespace each, so a scenario is written once
PORT = types.SimpleNamespace(
    name="port",
    make=lambda n, extra, **kw: cluster.ECCluster(
        n, dict(extra, device="cpu"), plugin="cuda", **kw),
    ECBackend=ecbackend.ECBackend, CrushPlacement=placement.CrushPlacement,
    FaultInjector=FaultInjector, Transaction=t_types.Transaction,
    ECSubWrite=t_types.ECSubWrite, shard_oid=ecbackend.shard_oid,
    VERSION_KEY=ecbackend.VERSION_KEY, PerfCounters=PerfCounters)
JAX = types.SimpleNamespace(
    name="jax",
    make=lambda n, extra, **kw: j_cluster.ECCluster(
        n, dict(extra), plugin="tpu", **kw),
    ECBackend=j_ecbackend.ECBackend,
    CrushPlacement=j_placement.CrushPlacement,
    FaultInjector=JFaultInjector, Transaction=j_types.Transaction,
    ECSubWrite=j_types.ECSubWrite, shard_oid=j_ecbackend.shard_oid,
    VERSION_KEY=j_ecbackend.VERSION_KEY, PerfCounters=JPerfCounters)


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _bytes(rng, n):
    return rng.randint(0, 256, size=n, dtype=np.uint8).tobytes()


# -- the storage cycle ------------------------------------------------------


@pytest.mark.parametrize("code", sorted(CODES))
def test_storage_cycle_stores_match_jax(code):
    """The storage cycle of the JAX package's dry run (write, kill, write
    while degraded, read, revive, recover, read) at k=4 m=2 on 8 OSDs:
    the stores after the writes, after the degraded writes and after
    recovery are identical to the JAX package's, and every read returns
    its payload."""
    rng = np.random.RandomState(11)
    payloads = {f"obj{i}": _bytes(rng, 16_000 + 97 * i) for i in range(3)}
    overwrites = {oid: _bytes(rng, 18_000) for oid in payloads}
    extra = dict(CODES[code], k="4", m="2")
    snaps = {}

    def hook(tag):
        def snap(c, step, when):
            if when == "end" and step in ("write", "degraded_write", "read"):
                snaps[tag, step] = cluster_bench.store_snapshot(c)
        return snap

    results = {
        pkg.name: cluster_bench.run_storage_cycle(
            lambda pkg=pkg: pkg.make(8, extra), payloads, overwrites,
            hook=hook(pkg.name), deadline_s=30.0)
        for pkg in (PORT, JAX)}
    mine, theirs = results["port"], results["jax"]
    assert type(mine["cluster"].ec).__module__ == \
        "ceph_tpu_torch.plugins.cuda"
    for step in ("write", "degraded_write", "read"):
        assert snaps["port", step] == snaps["jax", step], step
    assert len(snaps["port", "read"]) == len(payloads) * 6
    assert mine["victim"] == theirs["victim"]
    assert mine["rebuilt_bytes"] == theirs["rebuilt_bytes"] > 0
    assert mine["final"] == overwrites


def test_cycle_overwrites_a_quarter_and_counts_ops():
    rng_payloads = cluster_bench.make_payloads(8, 4096, seed=3)
    over = cluster_bench.make_overwrites(rng_payloads, 4, seed=4)
    assert sorted(over) == ["obj0", "obj4"]
    assert all(len(v) == 4096 for v in over.values())
    r = cluster_bench.run_storage_cycle(
        lambda: PORT.make(8, dict(CODES["rs_w8"], k="4", m="2")),
        rng_payloads, over, writers=3)
    assert list(r["steps_s"]) == list(cluster_bench.STEPS)
    assert r["op_ms"]["write"]["ops"] == 8
    assert r["op_ms"]["degraded_write"]["ops"] == 2
    assert r["op_ms"]["degraded_read"]["ops"] == 8
    assert r["op_ms"]["read"]["ops"] == 8
    assert r["final"]["obj0"] == over["obj0"]
    assert r["final"]["obj1"] == rng_payloads["obj1"]


# -- the OSD scenarios of the JAX package's tests, side by side --------------

PROFILE = {"k": "4", "m": "2", "technique": "reed_sol_van"}


async def _roundtrip(pkg, rng):
    c = pkg.make(8, PROFILE)
    payloads = {f"obj{i}": _bytes(rng, 1000 * i + 13) for i in range(1, 6)}
    for oid, data in payloads.items():
        await c.write(oid, data)
    got = [await c.read(oid) == data for oid, data in payloads.items()]
    acting = c.backend.acting_set("obj1")
    return c, [got, len(set(acting)), acting]


async def _degraded_read(pkg, rng):
    c = pkg.make(8, PROFILE)
    data = _bytes(rng, 50000)
    await c.write("obj", data)
    acting = c.backend.acting_set("obj")
    c.kill_osd(acting[0])
    c.kill_osd(acting[3])
    return c, [await c.read("obj") == data, acting]


async def _crc_scrub_eio(pkg, rng):
    c = pkg.make(8, PROFILE)
    data = _bytes(rng, 30000)
    await c.write("obj", data)
    acting = c.backend.acting_set("obj")
    shard_osd = c.osds[acting[1]]
    shard_osd.store.corrupt("obj@1", 5)
    ok = await c.read("obj") == data
    eio = shard_osd.perf.snapshot().get("read_crc_error", 0) >= 1
    return c, [ok, eio]


async def _recovery(pkg, rng):
    c = pkg.make(8, PROFILE)
    data = _bytes(rng, 40000)
    await c.write("obj", data)
    acting = c.backend.acting_set("obj")
    victim = c.osds[acting[2]]
    victim.store.queue_transaction(pkg.Transaction().remove("obj@2"))
    gone = not victim.store.exists("obj@2")
    await c.recover_object_shard("obj", 2, acting[2])
    back = victim.store.exists("obj@2")
    for other in (0, 1, 3, 4, 5):
        c.kill_osd(acting[other])
        if sum(c.messenger.is_down(f"osd.{acting[s]}")
               for s in range(6)) > 2:
            c.revive_osd(acting[other])
    return c, [gone, back, await c.read("obj") == data]


async def _fault_injection(pkg, rng, **fault):
    c = pkg.make(8, PROFILE, fault=pkg.FaultInjector(seed=7, **fault))
    data = _bytes(rng, 700)
    await c.write("x", data)
    return c, [await c.read("x") == data, c.messenger.fault.dropped]


async def _range_read_and_rmw(pkg, rng):
    c = pkg.make(8, PROFILE)
    data = bytearray(_bytes(rng, 100000))
    await c.write("obj", bytes(data))
    seen = []
    for off, ln in [(0, 10), (4096, 4096), (33333, 12345), (99990, 100)]:
        seen.append(await c.read_range("obj", off, ln)
                    == bytes(data[off:off + ln]))
    seen.append(await c.read_range("obj", 99000, 5000) == bytes(data[99000:]))
    patch = _bytes(rng, 7777)
    await c.write_range("obj", 12345, patch)
    data[12345:12345 + 7777] = patch
    seen.append(await c.read("obj") == bytes(data))
    tail = _bytes(rng, 5000)
    await c.write_range("obj", len(data), tail)
    data.extend(tail)
    seen.append(await c.read("obj") == bytes(data))
    acting = c.backend.acting_set("obj")
    c.kill_osd(acting[1])
    seen.append(await c.read_range("obj", 50000, 20000)
                == bytes(data[50000:70000]))
    return c, seen


async def _write_range_from_scratch(pkg, rng):
    c = pkg.make(8, PROFILE)
    blob = _bytes(rng, 30000)
    await c.write_range("fresh", 0, blob)
    return c, [await c.read("fresh") == blob]


async def _stale_shard_after_revive(pkg, rng):
    c = pkg.make(6, {"k": "2", "m": "1"})
    old, new = _bytes(rng, 3300), _bytes(rng, 3000)
    await c.write("obj", old)
    victim = c.backend.acting_set("obj")[0]
    c.kill_osd(victim)
    await c.write("obj", new)
    c.revive_osd(victim)
    seen = [await c.read("obj") == new]
    await c.backend.recover_shard("obj", 0, victim)
    seen.append(await c.read("obj") == new)
    return c, seen


async def _new_primary_learns_version(pkg, rng):
    c = pkg.make(6, {"k": "2", "m": "1"})
    for i in range(5):
        await c.write("obj", _bytes(rng, 600 + i))
    b2 = pkg.ECBackend(c.ec, c.osds, c.messenger, name="client2",
                       placement=pkg.CrushPlacement(
                           6, c.ec.get_chunk_count()))
    final = _bytes(rng, 1600)
    await b2.write("obj", final)
    return c, [await c.read("obj") == final, await b2.read("obj") == final]


async def _partial_write_falls_back(pkg, rng):
    c = pkg.make(6, {"k": "2", "m": "1"})
    committed = _bytes(rng, 3000)
    await c.write("obj", committed)
    acting = c.backend.acting_set("obj")
    v_next = c.primary_backend("obj")._versions["obj"] + 1
    soid = pkg.shard_oid("obj", 0)
    torn = pkg.ECSubWrite(
        from_shard=0, tid=77777, oid="obj",
        transaction=(pkg.Transaction().write(soid, 0, b"T" * 100)
                     .truncate(soid, 100)
                     .setattr(soid, pkg.VERSION_KEY, v_next)),
        at_version=v_next)
    await c.osds[acting[0]].handle_sub_write("osd.client", torn)
    return c, [await c.read("obj") == committed]


async def _cold_primary_recovery(pkg, rng):
    c = pkg.make(6, {"k": "2", "m": "1"})
    for i in range(3):
        await c.write("obj", _bytes(rng, 1800))
    acting = c.backend.acting_set("obj")
    victim = acting[0]
    c.kill_osd(victim)
    final = _bytes(rng, 2040)
    await c.write("obj", final)
    c.revive_osd(victim)
    b2 = pkg.ECBackend(c.ec, c.osds, c.messenger, name="client2",
                       placement=pkg.CrushPlacement(
                           6, c.ec.get_chunk_count()))
    await b2.recover_shard("obj", 0, victim)
    same = (c.osds[victim].store.getattr(pkg.shard_oid("obj", 0),
                                         "_version")
            == c.osds[acting[1]].store.getattr(pkg.shard_oid("obj", 1),
                                               "_version"))
    return c, [same, await b2.read("obj") == final]


async def _stale_minimum_set(pkg, rng):
    c = pkg.make(8, {"k": "2", "m": "2"}, min_size=2)
    old, new = _bytes(rng, 3000), _bytes(rng, 2400)
    await c.write("obj", old)
    acting = c.backend.acting_set("obj")
    c.kill_osd(acting[0])
    c.kill_osd(acting[1])
    await c.write("obj", new)
    c.revive_osd(acting[0])
    c.revive_osd(acting[1])
    return c, [await c.read("obj") == new]


async def _deep_scrub(pkg, rng):
    c = pkg.make(8, PROFILE)
    await c.write("obj", _bytes(rng, 20000))
    first = await c.deep_scrub("obj")
    acting = c.backend.acting_set("obj")
    c.osds[acting[4]].store.corrupt("obj@4", 3)
    second = await c.deep_scrub("obj")
    return c, [first["ok"], not second["ok"],
               4 in second["crc_errors"] or 4 in second["parity_mismatch"]]


SCENARIOS = {
    "roundtrip": _roundtrip,
    "degraded_read": _degraded_read,
    "crc_scrub_eio": _crc_scrub_eio,
    "recovery": _recovery,
    "fault_injection": _fault_injection,
    "fault_injection_delays": lambda pkg, rng: _fault_injection(
        pkg, rng, delay_probability=0.5, max_delay=0.002),
    "range_read_and_rmw": _range_read_and_rmw,
    "write_range_from_scratch": _write_range_from_scratch,
    "stale_shard_after_revive": _stale_shard_after_revive,
    "new_primary_learns_version": _new_primary_learns_version,
    "partial_write_falls_back": _partial_write_falls_back,
    "cold_primary_recovery": _cold_primary_recovery,
    "stale_minimum_set": _stale_minimum_set,
    "deep_scrub": _deep_scrub,
}


def _scenario(pkg, name):
    async def main():
        pkg.PerfCounters.reset_all()
        c, seen = await SCENARIOS[name](pkg, np.random.RandomState(21))
        snap = cluster_bench.store_snapshot(c)
        await c.shutdown()
        return seen, snap

    return _run(main())


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_osd_scenario_matches_jax(name):
    seen, snap = _scenario(PORT, name)
    want_seen, want_snap = _scenario(JAX, name)
    assert seen == want_seen
    assert snap == want_snap
    assert snap
    # every check of the scenario held (the JAX package's own tests
    # assert the same of its side)
    flat = [x for x in seen if isinstance(x, bool)] + [
        y for x in seen if isinstance(x, list) for y in x
        if isinstance(y, bool)]
    assert all(flat), seen


# -- paths the port once refused ----------------------------------------------


def _in_loop(fn):
    async def main():
        return fn()

    return _run(main())


def _port_cluster():
    return PORT.make(6, {"k": "2", "m": "1"})


def test_set_tier_mode_refuses_every_mode_but_none():
    """Since the port has the device tier, set_tier_mode takes the JAX
    package's three cache modes and refuses only any other name; every
    OSD keeps its tier on the codec's device, and a tick runs the
    agent."""
    async def main():
        c = _port_cluster()
        with pytest.raises(ValueError):
            c.set_tier_mode("sideways")
        for mode in ("writeback", "readproxy", "none"):
            c.set_tier_mode(mode)
            assert all(o.pools[c.pool].tier_mode == mode for o in c.osds)
        assert all(o.tier.device.type == "cpu" for o in c.osds)
        c.set_tier_mode("writeback")
        assert await c.osds[0].tier_tick() == 0  # nothing hot yet
        await c.shutdown()

    _run(main())


def test_create_with_mons_and_mon_command_refuse():
    """Lifted since the port has the mon quorum: ``create_with_mons``
    brings the cluster up through paxos-committed commands and
    ``mon_command`` reaches the quorum (a plain cluster has none)."""
    async def main():
        c = await cluster.ECCluster.create_with_mons(
            6, {"k": "2", "m": "1", "device": "cpu"})
        rc, st = await c.mon_command({"prefix": "status"})
        assert rc == 0 and st["pools"] == ["ecpool"] and st["num_osds"] == 6
        await c.write("obj", b"via-mons" * 100)
        assert await c.read("obj") == b"via-mons" * 100
        await c.shutdown()
        plain = _port_cluster()
        with pytest.raises(AttributeError):
            await plain.mon_command({"prefix": "status"})
        await plain.shutdown()

    _run(main())


def test_client_caps_and_mgr_report_refuse():
    """Both lifted: ``set_client_caps`` (the port has ``auth/caps.py``)
    and the mgr report (``mgr/``), whose payload carries the JAX
    package's report keys and equals its report of the same writes but
    for the times, the boot nonce and the ledger's one renamed key
    (compared in full in tests/test_torch_mgr.py)."""
    async def main():
        c = _port_cluster()
        await c.write("obj", b"payload")
        for osd in c.osds:
            osd.set_client_caps("client.x", "allow r pool=" + c.pool)
        assert type(c.osds[0].client_caps["client.x"]).__module__ == \
            "ceph_tpu_torch.auth.caps"
        ro = c.new_client("client.x")
        assert await ro.read("obj") == b"payload"
        with pytest.raises(PermissionError):
            await ro.write("obj", b"no")
        report = c.osds[0].mgr_report_stats()
        await c.shutdown()
        return report

    mine = _run(main())

    async def theirs():
        c = JAX.make(6, {"k": "2", "m": "1"})
        await c.write("obj", b"payload")
        report = c.osds[0].mgr_report_stats()
        await c.shutdown()
        return report

    ref = _run(theirs())
    assert set(mine) == set(ref)
    assert mine["v"] == 1 and mine["kind"] == "osd"
    assert (mine["store"], mine["pgs"], mine["tier"]) == \
        (ref["store"], ref["pgs"], ref["tier"])
    assert set(mine["residency"]) ^ set(ref["residency"]) == \
        {"library_builds", "jit_retraces"}


def test_replicated_pools_refuse():
    """Lifted since the port has ``osd/replicated.py``: a replicated
    cluster, an added replicated pool and ``host_pool`` each build a
    ReplicatedBackend."""
    from ceph_tpu_torch.osd.replicated import ReplicatedBackend

    async def main():
        rc = cluster.ECCluster(6, {"size": "3"}, pool_type="replicated")
        await rc.write("obj", b"r" * 999)
        assert await rc.read("obj") == b"r" * 999
        await rc.shutdown()
        c = _port_cluster()
        rio = c.add_pool("meta", {"size": "3"}, pool_type="replicated")
        await rio.write("obj", b"m" * 99)
        assert await rio.read("obj") == b"m" * 99
        assert isinstance(c.osds[0].host_pool(
            "meta2", None, 6, pool_type="replicated"), ReplicatedBackend)
        await c.shutdown()

    _run(main())


def test_exec_refuses_on_client_and_primary():
    """Lifted since the port has ``cls/``: ``exec`` runs on the client
    (sent to the primary) and on the primary itself, with the JAX
    package's return codes and output bytes (every class is compared in
    tests/test_torch_cls.py)."""
    from ceph_tpu_torch.utils.encoding import Encoder

    def req(locker):
        return Encoder().value({"name": "l", "locker": locker,
                                "type": "exclusive"}).bytes()

    async def main(P):
        c = P.make(6, {"k": "2", "m": "1"})
        await c.write("o", b"x" * 100)
        out = [await c.backend.exec("o", "lock", "lock", req("a")),
               await c.primary_backend("o").exec("o", "lock", "lock",
                                                 req("b")),
               await c.backend.exec("o", "lock", "get_info",
                                    Encoder().value({"name": "l"}).bytes()),
               await c.backend.exec("o", "nope", "nah"),
               await c.read("o")]
        await c.shutdown()
        return out

    mine, theirs = _run(main(PORT)), _run(main(JAX))
    assert mine == theirs
    assert [r[0] for r in mine[:4]] == [0, -16, 0, -8]
    assert mine[4] == b"x" * 100


REGEN = {"k": "4", "m": "3", "plugin": "regen"}


#: a regen pool of each package (the port's on ``device=cpu``), built
#: inside the running loop
REGEN_MAKERS = (lambda: cluster.ECCluster(8, dict(REGEN, device="cpu")),
                lambda: j_cluster.ECCluster(8, dict(REGEN)))


def test_regen_lane_refuses():
    """Since the port has the regenerating codec, the shard's helper lane
    no longer refuses: it serves each requested oid's helper symbol (its
    stored shard dotted with phi_f), the same bytes as the JAX package's
    shard, and an unknown oid gets ENOENT in both."""
    def serve(make, types_mod):
        async def main():
            c = make()
            payload = np.random.RandomState(4).randint(
                0, 256, 40000, dtype=np.uint8).tobytes()
            await c.write("o", payload)
            acting = c.backend.acting_set("o")
            osd = c.osds[acting[2]]
            coeffs = c.ec.repair_coeffs(0)
            msg = types_mod.ECSubRead(
                from_shard=2, tid=1, to_read={"o": [(0, 8)]},
                attrs_to_read=[], regen={"o": coeffs, "nope": coeffs})
            reply = types_mod.ECSubReadReply(from_shard=2, tid=1)
            osd._serve_regen_helpers(msg, msg.regen, reply)
            served = osd.perf.snapshot().get("regen_helpers_served", 0)
            await c.shutdown()
            return dict(reply.buffers_read), dict(reply.errors), served

        return _run(main())

    make_mine, make_theirs = REGEN_MAKERS
    got, want = serve(make_mine, t_types), serve(make_theirs, j_types)
    assert got == want
    buffers, errors, served = got
    assert errors == {"nope": -2} and served == 1
    chunk = registry_mod.instance().factory(
        "regen", {"k": "4", "m": "3", "device": "cpu"}).get_chunk_size(40000)
    assert len(buffers["o"][0][1]) * 3 == chunk


def test_regen_lane_refuses_in_recovery_planning():
    """Since the port has the regenerating codec, the batched recovery
    planner no longer refuses a codec that advertises fractional repair:
    a lost shard is rebuilt from d helper symbols, with the JAX package's
    stores, gathered bytes and bytes saved."""
    def rebuild(make, coalescer_cls):
        async def main():
            c = make()
            payload = np.random.RandomState(5).randint(
                0, 256, 40000, dtype=np.uint8).tobytes()
            await c.write("o", payload)
            acting = c.backend.acting_set("o")
            c.kill_osd(acting[1])
            c.wipe_osd(acting[1])
            c.revive_osd(acting[1])
            rc = coalescer_cls(c.primary_backend("o"))
            fell_back = await rc._recover_batch(
                {"o": [(1, acting[1], False)]})
            backend = c.primary_backend("o")
            out = (sorted(fell_back), cluster_bench.store_snapshot(c),
                   {key: backend.perf.snapshot().get(key, 0)
                    for key in ("recovery_gather_bytes",
                                "recovery_bytes_saved", "recovery_bytes")},
                   await c.read("o") == payload)
            await c.shutdown()
            return out

        return _run(main())

    from ceph_tpu.osd.recovery import RecoveryCoalescer as JCoalescer
    from ceph_tpu_torch.osd.recovery import RecoveryCoalescer

    make_mine, make_theirs = REGEN_MAKERS
    got = rebuild(make_mine, RecoveryCoalescer)
    want = rebuild(make_theirs, JCoalescer)
    assert got == want
    fell_back, _stores, counters, read_back = got
    assert fell_back == [] and read_back
    assert counters["recovery_bytes_saved"] > 0


def test_mesh_plane_is_off_and_its_option_undeclared():
    """Lifted since the port has the mesh data plane: its four options
    are declared as the JAX package declares them, the plane is off by
    default (every backend single-device), and with the gate on every
    OSD's backend takes the process plane, bound to a slot."""
    from ceph_tpu.utils import config as j_config
    from ceph_tpu_torch import parallel
    from ceph_tpu_torch.parallel import mesh_plane

    for name in ("osd_mesh_data_plane", "osd_mesh_devices",
                 "osd_mesh_scatter", "osd_mesh_board_bytes"):
        opt, ref = config.OPTIONS[name], j_config.OPTIONS[name]
        assert (opt.type, opt.default, opt.level, opt.see_also) == \
            (ref.type, ref.default, ref.level, ref.see_also), name
    cfg = config.get_config()
    assert cfg.get_val("osd_mesh_data_plane") is False

    async def main():
        c = _port_cluster()
        assert all(o.pools[c.pool]._mesh_plane() is None for o in c.osds)
        await c.shutdown()
        cfg.set_val("osd_mesh_data_plane", True)
        parallel.configure_devices(["cpu"] * 4)
        try:
            c = _port_cluster()
            planes = {id(o.pools[c.pool]._mesh_plane()) for o in c.osds}
            plane = mesh_plane.current_plane()
            assert planes == {id(plane)}
            assert plane.status()["members"] == {
                f"osd.{i}": i for i in range(4)}
            await c.write("o", b"m" * 5000)
            assert await c.read("o") == b"m" * 5000
            assert plane.counters["mesh_wire_bytes_avoided"] > 0
            await c.shutdown()
        finally:
            cfg.set_val("osd_mesh_data_plane", False)
            parallel.configure_devices(None)
            mesh_plane.reset()

    _run(main())


@pytest.mark.parametrize("kind", ["filestore", "kstore", "blockstore",
                                  "blockstore:zlib"])
def test_persistent_object_stores_refuse(kind, tmp_path):
    """Lifted since the port has the persistent engines: an OSD on each
    engine stores a shard, and the JAX package's engine of the same kind,
    given the same transaction, leaves the same file tree."""
    from ceph_tpu import objectstore as j_objectstore

    async def main():
        from ceph_tpu_torch.osd.messenger import Messenger

        osd = OSDShard(0, Messenger(), objectstore=kind,
                       data_path=str(tmp_path / "port"), device="cpu")
        osd.store.queue_transaction(t_types.Transaction()
                                    .write("obj@0", 0, b"s" * 5000)
                                    .setattr("obj@0", "_v", (1, "c")))
        osd.store.umount()

    _run(main())
    theirs = j_objectstore.create(kind, str(tmp_path / "jax" / "osd.0"))
    theirs.queue_transaction(j_types.Transaction()
                             .write("obj@0", 0, b"s" * 5000)
                             .setattr("obj@0", "_v", (1, "c")))
    theirs.umount()
    mine = {p.relative_to(tmp_path / "port"): p.read_bytes()
            for p in sorted((tmp_path / "port").rglob("*")) if p.is_file()}
    want = {p.relative_to(tmp_path / "jax"): p.read_bytes()
            for p in sorted((tmp_path / "jax").rglob("*")) if p.is_file()}
    assert mine == want and mine
    with pytest.raises(ValueError):
        objectstore.create("tape")
    with pytest.raises(ValueError):
        objectstore.create(kind)  # a persistent engine needs a path
    assert isinstance(objectstore.create("memstore"), objectstore.MemStore)


def test_default_plugin_is_the_card():
    assert cluster.DEFAULT_PLUGIN == "cuda"

    async def main():
        c = cluster.ECCluster(6, {"k": "2", "m": "1", "device": "cpu"})
        assert type(c.ec).__module__ == "ceph_tpu_torch.plugins.cuda"
        await c.shutdown()
        asked = cluster.ECCluster(6, {"k": "2", "m": "1"},
                                  plugin="jerasure")
        assert type(asked.ec).__module__ == "ceph_tpu_torch.plugins.jerasure"
        await asked.shutdown()

    _run(main())


def test_trace_cluster_path_splits_host_time_by_layer():
    """``trace_main_path --cluster-path``'s rows, on the CPU at a small
    size: a write pass and a recovery, each traced and split by layer."""
    from ceph_tpu_torch.tools import trace_main_path

    rows = trace_main_path.cluster_path(
        {"technique": "reed_sol_van", "k": "4", "m": "2", "device": "cpu"},
        4, 16 << 10, 0, None, "cpu")
    calls = [r["call"] for r in rows]
    assert calls == ["cluster_path_write", "cluster_path_write_cprofile",
                     "cluster_path_recovery",
                     "cluster_path_recovery_cprofile"]
    for row in rows[1::2]:
        layers = row["layers_s"]
        assert set(layers) <= set(trace_main_path.LAYERS) | {"other"}
        assert {"shard_op_queue", "messenger", "commit"} <= set(layers)
        assert 0.5 < sum(layers.values()) / row["wall_s"] <= 1.05
    assert rows[0]["device_idle_share"] == 1.0  # no card here
    assert trace_main_path._layer("/x/ceph_tpu_torch/osd/objecter.py") == \
        "objecter"
    assert trace_main_path._layer("/x/ceph_tpu_torch/ops/cuda_gf.py") == \
        "codec"
