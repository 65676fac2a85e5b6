"""The port's librados surface (``client.py``: ``Rados`` / ``IoCtx``)
against the JAX package's.

Each case of the JAX package's ``tests/test_client.py``, and its
``test_ioctx_omap_exec_lock_surface`` from ``tests/test_cls.py``, runs as
the same script through both packages in one process, with payloads made
with numpy from a seed.  The JAX package's pools take the profiles its
tests give (``jerasure``, on the host); the port's take the same
technique, k and m on the ``cuda`` plugin with ``device=cpu`` (the
kernels' plain versions), and its lrc pool the same lrc profile.  Every
read, stat, listing, snapshot listing and ``exec`` result must be equal,
and so must every OSD's store of every pool at the end of a case.
"""

import asyncio
import types

import numpy as np
import pytest
import torch

from ceph_tpu import client as j_client
from ceph_tpu.osd import cluster as j_cluster
from ceph_tpu.plugins.interface import ErasureCodeError as JErasureCodeError
from ceph_tpu.utils import config as j_config
from ceph_tpu.utils.encoding import Encoder as JEncoder
from ceph_tpu.utils.perf import PerfCounters as JPerfCounters
from ceph_tpu_torch import client
from ceph_tpu_torch.osd import cluster, cluster_bench
from ceph_tpu_torch.plugins.interface import ErasureCodeError
from ceph_tpu_torch.utils import config
from ceph_tpu_torch.utils.encoding import Encoder
from ceph_tpu_torch.utils.perf import PerfCounters
from torch_verify import port_verifiers


def _port_profile(prof):
    """The JAX test's profile on the port: a jerasure profile becomes the
    card's plugin on the CPU; another plugin keeps its profile."""
    if prof is None:
        return None
    if prof.get("plugin", "jerasure") == "jerasure":
        return dict(prof, plugin="cuda", device="cpu")
    return dict(prof)


PORT = types.SimpleNamespace(
    name="port", Rados=client.Rados, PerfCounters=PerfCounters,
    ErasureCodeError=ErasureCodeError, config=config, Encoder=Encoder,
    profile=_port_profile,
    make=lambda n, prof: cluster.ECCluster(n, _port_profile(prof)))
JAX = types.SimpleNamespace(
    name="jax", Rados=j_client.Rados, PerfCounters=JPerfCounters,
    ErasureCodeError=JErasureCodeError, config=j_config, Encoder=JEncoder,
    profile=lambda prof: None if prof is None else dict(prof),
    make=lambda n, prof: j_cluster.ECCluster(n, dict(prof)))
BOTH = (PORT, JAX)
DEFAULT_TEXT = "technique=reed_sol_van k=2 m=1"


@pytest.fixture(autouse=True)
def _loop_policy():
    """Both packages' loops run under the port's verifiers
    (``tests/torch_verify.py``): its atomic-section verifier, which holds
    both packages' sections, and its residency verifier."""
    with port_verifiers():
        yield


def _bytes(seed, n):
    return np.random.RandomState(seed).randint(
        0, 256, size=n, dtype=np.uint8).tobytes()


def _stores(rados):
    """Every pool's stores: pool -> ``cluster_bench.store_snapshot``."""
    return {name: cluster_bench.store_snapshot(c)
            for name, c in sorted(rados._pools.items())}


def _both_rados(scenario, n_osds=8):
    """``scenario(P, rados, log)`` on a fresh ``Rados`` of each package;
    the logs and the stores at its end must be equal."""
    out = {}
    for P in BOTH:
        P.PerfCounters.reset_all()
        r = P.Rados(n_osds=n_osds)
        log = []
        try:
            scenario(P, r, log)
            out[P.name] = (log, _stores(r))
        finally:
            r.shutdown()
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    return out["port"][0]


def test_pool_lifecycle():
    data = _bytes(1, 12345)

    def scenario(P, rados, log):
        io = rados.pool_create("ecpool", P.profile(
            {"plugin": "jerasure", "k": "4", "m": "2",
             "technique": "reed_sol_van"}))
        log.append(rados.list_pools())
        io.write_full("obj", data)
        log += [io.read("obj"), io.stat("obj"), io.list_objects()]
        scrub = io.scrub("obj")
        log.append(scrub["ok"])
        log.append(_stores(rados))
        io.remove("obj")
        log.append(io.list_objects())
        rados.pool_delete("ecpool")
        log.append(rados.list_pools())

    log = _both_rados(scenario)
    assert log[:4] == [["ecpool"], data, 12345, ["obj"]]
    assert log[4] is True and log[6:] == [[], []]


def test_default_profile_pool():
    """The port's default pool profile is the JAX package's text with the
    card's plugin; a default pool on the CPU (``device=cpu`` appended)
    stores the bytes the JAX package's default pool stores."""
    mine = config.get_config().get_val(
        "osd_pool_default_erasure_code_profile")
    theirs = j_config.get_config().get_val(
        "osd_pool_default_erasure_code_profile")
    assert mine == "plugin=cuda " + DEFAULT_TEXT
    assert theirs == "plugin=jerasure " + DEFAULT_TEXT
    if not torch.cuda.is_available():
        r = client.Rados(n_osds=4)
        try:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                r.pool_create("defaultpool")
            assert r.list_pools() == []
        finally:
            r.shutdown()
    cfg = config.get_config()
    cfg.set_val("osd_pool_default_erasure_code_profile",
                mine + " device=cpu")
    plugins = {}

    def scenario(P, rados, log):
        io = rados.pool_create("defaultpool")
        plugins[P.name] = type(io._cluster.ec).__module__
        for i in range(4):
            io.write_full(f"a{i}", b"hello world" * (1 + 300 * i))
        log.append([io.read(f"a{i}") for i in range(4)])

    try:
        log = _both_rados(scenario)
    finally:
        cfg.set_val("osd_pool_default_erasure_code_profile", mine)
    assert log == [[b"hello world" * (1 + 300 * i) for i in range(4)]]
    assert plugins == {"port": "ceph_tpu_torch.plugins.cuda",
                       "jax": "ceph_tpu.plugins.jerasure"}


def test_invalid_profile_rejected():
    def scenario(P, rados, log):
        with pytest.raises(P.ErasureCodeError):
            rados.pool_create("bad", P.profile(
                {"plugin": "jerasure", "k": "2", "m": "1",
                 "technique": "reed_sol_van", "w": "9"}))
        log.append(rados.list_pools())

    assert _both_rados(scenario) == [[]]


def test_lrc_pool():
    data = _bytes(2, 5000)

    def scenario(P, rados, log):
        io = rados.pool_create("lrcpool", P.profile(
            {"plugin": "lrc", "k": "4", "m": "2", "l": "3"}))
        io.write_full("x", data)
        log += [io.read("x"), io.stat("x"), io.list_objects()]

    assert _both_rados(scenario) == [data, 5000, ["x"]]


def _both_cluster(scenario):
    """``scenario(P, cluster, log)`` on a 4-OSD k=2 m=1 cluster of each
    package (jerasure on the JAX package, the card's plugin on the CPU on
    the port); logs and final stores equal."""
    out = {}
    for P in BOTH:
        P.PerfCounters.reset_all()
        log = []

        async def main(P=P, log=log):
            c = P.make(4, {"plugin": "jerasure", "k": "2", "m": "1"})
            try:
                await scenario(P, c, log)
                return cluster_bench.store_snapshot(c)
            finally:
                await c.shutdown()

        loop = asyncio.new_event_loop()
        try:
            out[P.name] = (log, loop.run_until_complete(main()))
        finally:
            loop.close()
    assert out["port"] == out["jax"]
    return out["port"][0]


def test_remove_drops_omap_with_object():
    async def scenario(P, c, log):
        await c.backend.write("obj", b"data")
        await c.backend.omap_set("obj", {"k": b"v"})
        await c.backend.remove_object("obj")
        for osd in c.osds:
            for stored in osd.store.list_objects():
                if stored == "obj@meta":
                    assert osd.store.getattr(stored, "_meta_removed")
                    assert osd.store.omap_get(stored) == {}
                else:
                    assert not stored.startswith("obj@"), stored
        await c.backend.write("obj", b"fresh")
        log.append(await c.backend.omap_get("obj"))
        log.append(await c.read("obj"))

    assert _both_cluster(scenario) == [{}, b"fresh"]


def test_removed_omap_never_resurrects_from_stale_replica():
    async def scenario(P, c, log):
        await c.backend.write("obj", b"data")
        for i in range(3):
            await c.backend.omap_set("obj", {"k": f"v{i}".encode()})
        meta_holder = c.backend.acting_set("obj")[0]
        holder = meta_holder if meta_holder is not None else 0
        c.kill_osd(holder)
        await c.backend.remove_object("obj")
        c.revive_osd(holder)
        await c.backend.write("obj", b"fresh")
        await c.backend.omap_set("obj", {"new": b"x"})
        log.append(await c.backend.omap_get("obj"))

    assert _both_cluster(scenario) == [{"new": b"x"}]


def test_tombstone_outranks_higher_versioned_stale_replica():
    async def scenario(P, c, log):
        await c.backend.write("obj", b"data")
        await c.backend.omap_set("obj", {"k": b"v1"})
        acting = [a for a in c.backend.acting_set("obj") if a is not None]
        survivor, others = acting[0], acting[1:]
        for o in others:
            c.kill_osd(o)
        await c.backend.omap_set("obj", {"k": b"v2-solo"})
        for o in others:
            c.revive_osd(o)
        c.kill_osd(survivor)
        await c.backend.remove_object("obj")
        c.revive_osd(survivor)
        fresh = c.new_client("client.fresh")
        await fresh.write("obj", b"new life")
        await fresh.omap_set("obj", {"n": b"1"})
        log.append(await fresh.omap_get("obj"))
        log.append(await c.backend.omap_get("obj"))

    assert _both_cluster(scenario) == [{"n": b"1"}, {"n": b"1"}]


def test_replicated_pool_lifecycle():
    data = _bytes(3, 54321)

    def scenario(P, rados, log):
        io = rados.pool_create("rpool", pool_type="replicated", size=3)
        log.append(rados.list_pools())
        io.write_full("obj", data)
        log += [io.read("obj"), io.stat("obj"), io.scrub("obj")["ok"]]
        io.omap_set("obj", {"key": b"val"})
        log.append(io.omap_get("obj"))
        log.append(_stores(rados))
        io.remove("obj")
        log.append(io.list_objects())
        with pytest.raises(ValueError):
            rados.pool_create("toobig", pool_type="replicated", size=99)
        rados.pool_delete("rpool")
        log.append(rados.list_pools())

    log = _both_rados(scenario)
    assert log[:5] == [["rpool"], data, 54321, True, {"key": b"val"}]
    assert log[6:] == [[], []]


def test_mixed_pool_types_coexist():
    def scenario(P, rados, log):
        ec_io = rados.pool_create("data", P.profile(
            {"plugin": "jerasure", "k": "4", "m": "2",
             "technique": "reed_sol_van"}))
        r_io = rados.pool_create("meta", pool_type="replicated", size=3)
        ec_io.write_full("obj", b"ec bytes")
        r_io.write_full("obj", b"replicated bytes")
        log += [ec_io.read("obj"), r_io.read("obj"),
                ec_io.list_objects(), r_io.list_objects()]

    assert _both_rados(scenario) == [b"ec bytes", b"replicated bytes",
                                     ["obj"], ["obj"]]


def test_ioctx_omap_exec_lock_surface():
    def scenario(P, rados, log):
        io = rados.pool_create("meta", P.profile(
            {"plugin": "jerasure", "k": "2", "m": "1"}))
        io.omap_set("o", {"x": b"1"})
        log.append(io.omap_get("o"))
        log.append(io.lock_exclusive("o", "l", "cookie-1"))
        log.append(io.lock_exclusive("o", "l", "cookie-2"))
        log.append(io.exec("o", "lock", "get_info",
                           P.Encoder().value({"name": "l"}).bytes()))
        log.append(io.unlock("o", "l", "cookie-1"))
        log.append(io.lock_exclusive("o", "l", "cookie-2"))
        log.append(io.exec("o", "version", "inc"))
        io.omap_rm("o", ["x"])
        log.append(io.omap_get("o"))

    log = _both_rados(scenario, n_osds=6)
    assert log[0] == {"x": b"1"} and log[1:3] == [0, -16]
    assert log[4:6] == [0, 0] and log[6][0] == 0


def test_ioctx_watch_notify_and_aio():
    data = _bytes(4, 30_000)

    def scenario(P, rados, log):
        io = rados.pool_create("ec", P.profile(
            {"plugin": "jerasure", "k": "4", "m": "2",
             "technique": "reed_sol_van"}))
        got = []
        io.watch("hdr", lambda oid, payload: got.append((oid, payload)))
        res = io.notify("hdr", {"event": "resize"})
        log.append((res["acks"], res["timeouts"], got))
        io.unwatch("hdr")
        rados._run(io.aio_write_full("a", data))
        log.append(rados._run(io.aio_read("a")))

    log = _both_rados(scenario)
    assert log[0] == (["client"], [], [("hdr", {"event": "resize"})])
    assert log[1] == data


def test_ioctx_selfmanaged_snaps():
    """Self-managed snapshots through ``IoCtx``: COW clones on the first
    write after a snap, reads at a snap, rollback and trim; every read,
    listing and store equal."""
    v1, v2, v3 = _bytes(5, 9000), _bytes(6, 9000), _bytes(7, 7000)

    def scenario(P, rados, log):
        io = rados.pool_create("snappy", P.profile(
            {"plugin": "jerasure", "k": "2", "m": "1"}))
        io.write_full("obj", v1)
        s1 = io.selfmanaged_snap_create()
        io.write_full("obj", v2)
        s2 = io.selfmanaged_snap_create()
        io.write_full("obj", v3)
        log.append((s1, s2, io.read("obj")))
        io.set_snap_read(s1)
        log.append(io.read("obj"))
        io.set_snap_read(s2)
        log.append(io.read("obj"))
        io.set_snap_read(None)
        log.append(io.list_snaps("obj"))
        io.selfmanaged_snap_rollback("obj", s1)
        log.append(io.read("obj"))
        io.selfmanaged_snap_remove(s1)
        log.append(io.list_snaps("obj"))
        log.append(io.list_objects())

    log = _both_rados(scenario, n_osds=6)
    assert log[0] == (1, 2, v3) and log[1] == v1 and log[2] == v2
    assert log[4] == v1
