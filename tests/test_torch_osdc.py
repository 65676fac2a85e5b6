"""The port's client libraries (``osdc/``) against the JAX package's.

The striper's extent math is compared with ``ceph_tpu.osdc.striper`` over
many layouts (hypothesis).  Each library case then runs as the same
script through both packages in one process: the JAX package's
``ECCluster`` on its default plugin (``jerasure``, on the host) and the
port's on its default, the ``cuda`` plugin, with the profile key
``device=cpu`` (the kernels' plain versions).  Every value a script
reads back (file bytes, journal entries and positions, cache reads and
counters, key-value scans) must be equal, and so must every OSD's store
at the end: the shards, xattrs and omap of every object the library
wrote.  Inputs are made from numpy seeds; the tolerance is byte
equality.
"""

import asyncio
import types

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from ceph_tpu.osd import cluster as j_cluster
from ceph_tpu.osdc import journaler as j_journaler
from ceph_tpu.osdc import kv_store as j_kv_store
from ceph_tpu.osdc import object_cacher as j_object_cacher
from ceph_tpu.osdc import rados_striper as j_rados_striper
from ceph_tpu.osdc import striper as j_striper
from ceph_tpu.utils.perf import PerfCounters as JPerfCounters
from ceph_tpu_torch.osd import cluster, cluster_bench
from ceph_tpu_torch.osdc import (journaler, kv_store, object_cacher,
                                 rados_striper, striper)
from ceph_tpu_torch.utils.perf import PerfCounters
from torch_verify import port_verifiers

PORT = types.SimpleNamespace(
    name="port", journaler=journaler, kv_store=kv_store,
    object_cacher=object_cacher, rados_striper=rados_striper,
    PerfCounters=PerfCounters,
    make=lambda n, prof: cluster.ECCluster(n, dict(prof, device="cpu")))
JAX = types.SimpleNamespace(
    name="jax", journaler=j_journaler, kv_store=j_kv_store,
    object_cacher=j_object_cacher, rados_striper=j_rados_striper,
    PerfCounters=JPerfCounters,
    make=lambda n, prof: j_cluster.ECCluster(n, dict(prof)))
BOTH = (PORT, JAX)
PROFILE = {"k": "2", "m": "1"}


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


def _both(scenario, n_osds=4):
    """Run ``scenario(P, c, log)`` in each package; assert equal logs and
    equal final stores; return the port's log."""
    out = {}
    for P in BOTH:
        P.PerfCounters.reset_all()
        log = []

        async def main(P=P, log=log):
            c = P.make(n_osds, PROFILE)
            try:
                await scenario(P, c, log)
                return cluster_bench.store_snapshot(c)
            finally:
                await c.shutdown()

        out[P.name] = (log, _run(main()))
    (log, snap), (want_log, want_snap) = out["port"], out["jax"]
    assert log == want_log
    assert snap == want_snap
    return log


def _bytes(seed: int, n: int) -> bytes:
    return np.random.RandomState(seed).randint(
        0, 256, n, dtype=np.uint8).tobytes()


# -- striper extents ---------------------------------------------------------


@settings(max_examples=200, deadline=None)
@given(su_kib=st.sampled_from([1, 4, 16, 64, 512]),
       units=st.integers(1, 8), sc=st.integers(1, 6),
       offset=st.integers(0, 1 << 24), length=st.integers(0, 1 << 22))
def test_striper_extents_equal_jax(su_kib, units, sc, offset, length):
    su = su_kib << 10
    mine = striper.Striper(striper.FileLayout(su * units, su, sc))
    theirs = j_striper.Striper(j_striper.FileLayout(su * units, su, sc))
    ext = mine.map_extent(offset, length)
    assert ext == theirs.map_extent(offset, length)
    assert mine.coalesce(ext) == theirs.coalesce(ext)
    assert sum(n for _o, _off, n in ext) == length
    assert mine.object_count(offset + length) == \
        theirs.object_count(offset + length)


def test_striper_layout_rejects_what_jax_rejects():
    for args in ((3 << 10, 2 << 10, 1), (4 << 10, 1 << 10, 0)):
        with pytest.raises(ValueError):
            striper.FileLayout(*args)
        with pytest.raises(ValueError):
            j_striper.FileLayout(*args)


# -- RadosStriper ------------------------------------------------------------


def test_rados_striper_write_read_stat_equal_jax():
    payload = _bytes(1, 300_000)

    async def scenario(P, c, log):
        rs = P.rados_striper.RadosStriper(
            c.backend, object_size=64 << 10, stripe_unit=16 << 10,
            stripe_count=3)
        await rs.write("blob", payload)
        log.append(await rs.read("blob") == payload)
        log.append(await rs.stat("blob"))
        log.append(await c.backend.read_range(f"blob.{1:016x}", 0, 16 << 10))
        log.append(await rs.read("blob", 5000, offset=100_000))
        await rs.write("blob", _bytes(2, 40_000), 290_000)
        log.append(await rs.read("blob", 60_000, offset=270_000))
        log.append(await rs.list_striped())

    log = _both(scenario)
    assert log[0] is True and log[1] == 300_000
    assert log[2] == payload[16 << 10:32 << 10]


def test_rados_striper_append_truncate_remove_equal_jax():
    async def scenario(P, c, log):
        rs = P.rados_striper.RadosStriper(
            c.backend, object_size=32 << 10, stripe_unit=8 << 10,
            stripe_count=2)
        await rs.write("f", b"A" * 10_000)
        await rs.append("f", _bytes(3, 70_000))
        log.append(await rs.stat("f"))
        await rs.truncate("f", 12_000)
        log.append(await rs.read("f"))
        await rs.truncate("f", 20_000)
        log.append(await rs.read("f"))
        await rs.write_full("g", _bytes(4, 5000))
        log.append(await rs.list_striped())
        await rs.remove("f")
        log.append(await rs.list_striped())
        with pytest.raises(FileNotFoundError):
            await rs.read("f")

    log = _both(scenario)
    assert log[0] == 80_000 and log[2][12_000:] == bytes(8_000)
    assert log[3] == ["f", "g"] and log[4] == ["g"]


def test_rados_striper_degraded_reads_equal_jax():
    payload = _bytes(5, 200_000)

    async def scenario(P, c, log):
        rs = P.rados_striper.RadosStriper(
            c.backend, object_size=64 << 10, stripe_unit=16 << 10,
            stripe_count=4)
        await rs.write("d", payload)
        c.kill_osd(c.backend.acting_set("d." + "0" * 16)[0])
        log.append(await rs.read("d") == payload)
        log.append(await rs.read("d", 30_000, offset=70_000))
        # a second OSD down leaves some stripe objects below k: EIO,
        # never zeros
        for osd in range(4):
            c.kill_osd(osd)
        with pytest.raises(IOError):
            await rs.read("d")

    log = _both(scenario)
    assert log[0] is True and log[1] == payload[70_000:100_000]


# -- Journaler ---------------------------------------------------------------


def test_journaler_append_replay_commit_trim_equal_jax():
    async def scenario(P, c, log):
        j = P.journaler.Journaler(c.backend, "mdlog", object_size=4096)
        await j.open()
        rs = np.random.RandomState(7)
        for i in range(30):
            pad = rs.randint(0, 256, 400, dtype=np.uint8).tobytes()
            log.append(await j.append({"op": "event", "n": i, "pad": pad}))
        j2 = P.journaler.Journaler(c.backend, "mdlog", object_size=4096)
        await j2.open()
        log.append(await j2.replay())
        await j2.register_client("mirror", log[15])
        await j2.committed(log[20])
        log.append(await j2.clients())
        log.append(await j2.trim())  # pinned by the mirror client
        await j2.committed(log[25], client="mirror")
        log.append(await j2.trim())
        j3 = P.journaler.Journaler(c.backend, "mdlog", object_size=4096)
        await j3.open()
        log.append(await j3.replay_entries())
        log.append((j3.write_pos, j3.expire_pos, j3.commit_pos))

    log = _both(scenario)
    assert [e["n"] for _p, e in log[30]] == list(range(30))
    assert log[33] >= 1 and [e["n"] for _s, _e, e in log[34]] == \
        list(range(20, 30))


def test_journaler_torn_tail_equal_jax():
    async def scenario(P, c, log):
        j = P.journaler.Journaler(c.backend, "j", object_size=4096)
        await j.open()
        await j.append({"n": 1})
        await j.append({"n": 2})
        objno, off = divmod(j.write_pos, 4096)
        await c.backend.write_range(f"j.journal.{objno:08x}", off,
                                    b"\x01\x02\x03")
        j.write_pos += 40
        await c.backend.omap_set("j.journal", {
            "write_pos": P.journaler._enc(j.write_pos)})
        j2 = P.journaler.Journaler(c.backend, "j", object_size=4096)
        await j2.open()
        log.append(await j2.replay())

    log = _both(scenario)
    assert [e["n"] for _p, e in log[0]] == [1, 2]


# -- ObjectCacher ------------------------------------------------------------


def test_object_cacher_write_through_and_reads_equal_jax():
    async def scenario(P, c, log):
        await c.write("o", _bytes(8, 20_000))
        oc = P.object_cacher.ObjectCacher(c.backend, max_bytes=1 << 20)
        log.append(await oc.read("o", 1000, 4000))
        log.append(await oc.read("o", 2000, 1000))  # a hit
        await oc.write("o", 3000, b"W" * 5000)
        log.append(await c.backend.read("o"))
        log.append(await oc.read("o", 0, 12_000))
        log.append((oc.hits, oc.misses, oc.cached_bytes))

    _both(scenario)


def test_object_cacher_write_back_flush_evict_equal_jax():
    async def scenario(P, c, log):
        oc = P.object_cacher.ObjectCacher(c.backend, max_bytes=64 << 10,
                                          write_back=True)
        rs = np.random.RandomState(9)
        for i in range(24):
            oid = f"wb{i % 6}"
            data = rs.randint(0, 256, 8 << 10, dtype=np.uint8).tobytes()
            await oc.write(oid, (i // 6) * (8 << 10), data)
        log.append(oc.cached_bytes)
        await oc.flush("wb5")
        log.append(await c.backend.read("wb5"))
        await oc.invalidate()
        log.append(oc.cached_bytes)
        for i in range(6):
            log.append(await oc.read(f"wb{i}", 0, 32 << 10))
        log.append((oc.hits, oc.misses))

    _both(scenario)


# -- KvStore -----------------------------------------------------------------


def test_kv_store_split_scan_merge_equal_jax():
    keys = [f"key{int(i):05d}" for i in
            np.random.RandomState(10).permutation(120)]

    async def scenario(P, c, log):
        kv = P.kv_store.KvStore(c.backend, "idx", max_per_bucket=16)
        for i, key in enumerate(keys):
            await kv.set(key, _bytes(100 + i, 24))
        log.append(await kv.stats())
        log.append(await kv.get(keys[7]))
        log.append(await kv.keys("key000"))
        log.append(await kv.items("key01"))
        for key in sorted(keys)[:40]:
            await kv.remove(key)
        log.append(await kv.stats())
        log.append(await kv.keys())
        with pytest.raises(KeyError):
            await kv.get(sorted(keys)[0])

    log = _both(scenario)
    assert log[0]["entries"] == 120 and log[0]["buckets"] > 1
    assert log[5] == sorted(keys)[40:]
