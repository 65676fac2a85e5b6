"""The port's CephFS (``mds/``) against the JAX package's.

Each case of the JAX package's ``tests/test_cephfs.py`` runs as the same
script through both packages in one process: the JAX package's
``ECCluster`` on its default plugin (``jerasure``, on the host) and the
port's on its default, the ``cuda`` plugin, with the profile key
``device=cpu`` (the kernels' plain versions).  Every value a script reads
back (file bytes, ``readdir``, ``stat`` and ``lstat`` dentries, xattrs,
flock results, journal replay counts, balancer decisions, exceptions and
their errnos) must be equal, and so must every OSD's store at the end:
the shards, xattrs and omap of every object.  The MDS writes the clock
into its dentries (``mds/mds.py``'s ``int(time.time())``); both
packages' ``time.time`` is frozen at one value for each case.  Inputs
are made from numpy seeds; the tolerance is byte equality.
"""

import asyncio
import types

import numpy as np
import pytest

from ceph_tpu import mds as j_mds
from ceph_tpu.mds import mds as j_mds_mod
from ceph_tpu.mds import multimds as j_multimds
from ceph_tpu.osd import cluster as j_cluster
from ceph_tpu.utils.perf import PerfCounters as JPerfCounters
from ceph_tpu_torch import mds
from ceph_tpu_torch.mds import mds as mds_mod
from ceph_tpu_torch.mds import multimds
from ceph_tpu_torch.osd import cluster, cluster_bench
from ceph_tpu_torch.utils.perf import PerfCounters
from torch_verify import port_verifiers, verifying_policy

PORT = types.SimpleNamespace(
    name="port", mds=mds, mds_mod=mds_mod, multimds=multimds,
    PerfCounters=PerfCounters,
    make=lambda n, prof: cluster.ECCluster(n, dict(prof, device="cpu")))
JAX = types.SimpleNamespace(
    name="jax", mds=j_mds, mds_mod=j_mds_mod, multimds=j_multimds,
    PerfCounters=JPerfCounters,
    make=lambda n, prof: j_cluster.ECCluster(n, dict(prof)))
BOTH = (PORT, JAX)
PROFILE = {"k": "2", "m": "1"}
#: the frozen clock (seconds since the epoch) both packages' MDS read
CLOCK = 1_767_225_600.0


@pytest.fixture(autouse=True)
def _frozen_clock(monkeypatch):
    """Both MDS modules read ``time.time`` only; each gets a clock that
    stands still."""
    for mod in (mds_mod, j_mds_mod):
        monkeypatch.setattr(mod, "time",
                            types.SimpleNamespace(time=lambda: CLOCK))


@pytest.fixture(autouse=True)
def _loop_policy():
    """Both packages' loops run under the port's verifiers
    (``tests/torch_verify.py``): its atomic-section verifier, which holds
    both packages' sections, and its residency verifier."""
    with port_verifiers():
        yield


def _run(coro, P=None):
    """Run ``coro`` on a new loop: the port's under this file's policy,
    the JAX package's (``P`` is ``JAX``) under the port's verifying
    policy, which holds the JAX package's sections too, for this call
    alone."""
    saved = asyncio.get_event_loop_policy()
    if P is JAX:
        asyncio.set_event_loop_policy(verifying_policy())
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()
        asyncio.set_event_loop_policy(saved)


def _both(scenario, n_osds=5):
    """Run ``scenario(P, mk, log)`` in each package (``mk()`` makes a
    cluster); assert equal logs and equal final stores of every cluster
    made; return the port's log."""
    out = {}
    for P in BOTH:
        P.PerfCounters.reset_all()
        log = []

        async def main(P=P, log=log):
            made = []

            def mk(n=n_osds):
                made.append(P.make(n, PROFILE))
                return made[-1]

            try:
                await scenario(P, mk, log)
                return [cluster_bench.store_snapshot(c) for c in made]
            finally:
                for c in made:
                    await c.shutdown()

        out[P.name] = (log, _run(main(), P))
    (log, snaps), (want_log, want_snaps) = out["port"], out["jax"]
    assert log == want_log
    assert len(snaps) == len(want_snaps)
    for snap, want in zip(snaps, want_snaps):
        assert snap == want
    return log


async def _raises(log, exc, coro):
    """Await ``coro``, which must raise ``exc``; log the exception."""
    with pytest.raises(exc) as info:
        await coro
    log.append((type(info.value).__name__, str(info.value)))


def _bytes(seed: int, n: int) -> bytes:
    return np.random.RandomState(seed).randint(
        0, 256, n, dtype=np.uint8).tobytes()




async def _mkfs(P, mk):
    c = mk()
    return c, await P.mds.CephFS.mount(c.backend)


def _errno(P, e):
    return (type(e).__name__, e.errno, str(e))


async def _fs_raises(P, log, coro):
    """Await ``coro``, which must raise the package's ``FSError``."""
    with pytest.raises(P.mds_mod.FSError) as info:
        await coro
    log.append(_errno(P, info.value))


async def _names(c) -> list:
    return sorted({name.rsplit("@", 1)[0] for osd in c.osds
                   for name in osd.store.list_objects()})


async def _forge(P, c, mds_, ev, journal=None):
    """Journal ``ev`` without applying it, as a dying MDS would."""
    mds_._journal_seq += 1
    await c.backend.omap_set(journal or mds_.journal_oid, {
        f"{mds_._journal_seq:016d}": P.mds_mod._enc(ev)})


def test_namespace_crud_equal_jax():
    async def scenario(P, mk, log):
        c, fs = await _mkfs(P, mk)
        await fs.mkdirs("/a/b/c")
        log.append((await fs.readdir("/"), await fs.readdir("/a")))
        await fs.write_file("/a/b/c/hello.txt", b"hello world")
        log.append((await fs.readdir("/a/b/c"),
                    await fs.stat("/a/b/c/hello.txt"),
                    await fs.read_file("/a/b/c/hello.txt")))
        await fs.rename("/a/b/c/hello.txt", "/a/moved.txt")
        log.append((await fs.read_file("/a/moved.txt"),
                    await fs.readdir("/a/b/c"), await fs.readdir("/a")))
        await fs.unlink("/a/moved.txt")
        await _fs_raises(P, log, fs.stat("/a/moved.txt"))
        await fs.rmdir("/a/b/c")
        await _fs_raises(P, log, fs.rmdir("/a"))
        await _fs_raises(P, log, fs.mkdir("/a/b"))

    log = _both(scenario)
    assert log[0] == (["a"], ["b"])
    assert log[1][1]["type"] == "f" and log[1][1]["size"] == 11
    assert log[1][1]["mtime"] == int(CLOCK)
    assert log[2][0] == b"hello world" and log[2][1] == []
    assert [e[1] for e in log[3:]] == [2, 39, 17]


def test_large_file_stripes_over_objects_equal_jax():
    blob = _bytes(20, 3 * (1 << 20) + 12345)

    async def scenario(P, mk, log):
        c, fs = await _mkfs(P, mk)
        await fs.write_file("/big.bin", blob)
        log.append(await fs.read_file("/big.bin") == blob)
        for off, ln in ((0, 100), ((1 << 20) - 50, 100),
                        (2 * (1 << 20) + 7, 4096), (len(blob) - 10, 100)):
            log.append(await fs.read_file("/big.bin", off, ln))
        ino = (await fs.stat("/big.bin"))["ino"]
        log.append([n for n in await _names(c)
                    if n.startswith(f"{ino:x}.") and not n.endswith(".dir")])
        await fs.write_file("/big.bin", b"XYZ", offset=(1 << 20) - 1)
        log.append(await fs.read_file("/big.bin", (1 << 20) - 2, 6))

    log = _both(scenario)
    assert log[0] is True and log[2] == blob[(1 << 20) - 50:(1 << 20) + 50]
    assert len(log[5]) == 4
    assert log[6] == blob[(1 << 20) - 2:(1 << 20) - 1] + b"XYZ" + \
        blob[(1 << 20) + 2:(1 << 20) + 4]


def test_truncate_and_sparse_equal_jax():
    async def scenario(P, mk, log):
        c, fs = await _mkfs(P, mk)
        await fs.write_file("/f", b"Q" * 50_000)
        await fs.truncate("/f", 10_000)
        log.append(((await fs.stat("/f"))["size"], await fs.read_file("/f")))
        await fs.write_file("/f", b"tail", offset=2_000_000)
        log.append(await fs.read_file("/f", 1_999_990, 14))

    log = _both(scenario)
    assert log[0] == (10_000, b"Q" * 10_000)
    assert log[1] == bytes(10) + b"tail"


def test_mds_journal_replay_on_takeover_equal_jax():
    async def scenario(P, mk, log):
        c, fs = await _mkfs(P, mk)
        await fs.mkdir("/dir")
        await fs.write_file("/dir/file", b"payload")
        mds_ = fs.mds
        await _forge(P, c, mds_, {
            "op": "link", "dir": (await mds_.stat("/dir"))["ino"],
            "name": "ghost.txt",
            "dentry": mds_._mkdentry(424242, "f", size=0)})
        log.append(await fs.readdir("/dir"))
        fs2 = await P.mds.CephFS.mount(c.backend)
        log.append((fs2.mds.replayed, await fs2.readdir("/dir"),
                    await fs2.read_file("/dir/file")))
        log.append(await c.backend.omap_get(P.mds_mod.JOURNAL))

    log = _both(scenario)
    assert log[0] == ["file"]
    assert log[1] == (1, ["file", "ghost.txt"], b"payload")
    assert [k for k in log[2] if k != "_committed"] == []


def test_cephfs_survives_osd_failure_equal_jax():
    blob = _bytes(21, 150_000)

    async def scenario(P, mk, log):
        c, fs = await _mkfs(P, mk)
        await fs.mkdirs("/deep/tree")
        await fs.write_file("/deep/tree/data.bin", blob)
        victim = c.backend.acting_set("1.dir")[0]
        c.kill_osd(victim)
        log.append(await fs.read_file("/deep/tree/data.bin") == blob)
        await fs.write_file("/deep/tree/new.txt", b"degraded write")
        log.append(await fs.readdir("/deep/tree"))
        c.revive_osd(victim)
        c.start_auto_recovery(interval=0.05)
        deadline = asyncio.get_event_loop().time() + 30.0
        while await c.degraded_report():
            assert asyncio.get_event_loop().time() < deadline, \
                "cephfs objects never recovered"
            await asyncio.sleep(0.05)
        log.append(await fs.read_file("/deep/tree/new.txt"))

    log = _both(scenario)
    assert log == [True, ["data.bin", "new.txt"], b"degraded write"]


def test_inode_allocation_is_collision_free_equal_jax():
    async def scenario(P, mk, log):
        c, fs = await _mkfs(P, mk)
        for i in range(20):
            log.append((await fs.mds.create(f"/f{i}"))["ino"])

    log = _both(scenario)
    assert len(set(log)) == 20


def test_truncate_shrink_then_grow_reads_zeros_equal_jax():
    async def scenario(P, mk, log):
        c, fs = await _mkfs(P, mk)
        await fs.write_file("/f", b"Q" * 50_000)
        await fs.truncate("/f", 10)
        await fs.truncate("/f", 100)
        log.append(await fs.read_file("/f"))

    assert _both(scenario)[0] == b"Q" * 10 + bytes(90)


def test_journal_seq_survives_clean_restart_equal_jax():
    async def scenario(P, mk, log):
        c, fs = await _mkfs(P, mk)
        await fs.mkdir("/d1")
        await fs.mkdir("/d2")
        fs2 = await P.mds.CephFS.mount(c.backend)
        mds_ = fs2.mds
        log.append(mds_._journal_seq)
        await _forge(P, c, mds_, {"op": "link", "dir": 1,
                                  "name": "late.txt",
                                  "dentry": mds_._mkdentry(555, "f")})
        fs3 = await P.mds.CephFS.mount(c.backend)
        log.append((fs3.mds.replayed, await fs3.readdir("/")))

    log = _both(scenario)
    assert log[1] == (1, ["d1", "d2", "late.txt"])


def test_symlinks_follow_and_lstat_equal_jax():
    async def scenario(P, mk, log):
        c, fs = await _mkfs(P, mk)
        await fs.mkdirs("/data/real")
        await fs.write_file("/data/real/file.txt", b"through the link")
        await fs.symlink("/shortcut", "/data/real")
        log.append((await fs.read_file("/shortcut/file.txt"),
                    await fs.stat("/shortcut"), await fs.lstat("/shortcut"),
                    await fs.readlink("/shortcut")))
        await fs.unlink("/shortcut")
        log.append(await fs.read_file("/data/real/file.txt"))
        await fs.symlink("/a", "/b")
        await fs.symlink("/b", "/a")
        with pytest.raises(OSError) as info:
            await fs.stat("/a")
        log.append(_errno(P, info.value))

    log = _both(scenario)
    assert log[0][0] == b"through the link" and log[0][1]["type"] == "d"
    assert log[0][2]["type"] == "l" and log[0][3] == "/data/real"
    assert log[1] == b"through the link" and log[2][1] in (2, 40)


def test_xattrs_journal_and_survive_mds_takeover_equal_jax():
    async def scenario(P, mk, log):
        c, fs = await _mkfs(P, mk)
        await fs.write_file("/doc", b"x")
        await fs.setxattr("/doc", "user.owner", b"alice")
        await fs.setxattr("/doc", "user.tag", b"blue")
        log.append((await fs.getxattr("/doc", "user.owner"),
                    await fs.listxattr("/doc")))
        await fs.removexattr("/doc", "user.tag")
        log.append(await fs.listxattr("/doc"))
        await _fs_raises(P, log, fs.getxattr("/doc", "user.tag"))
        fs2 = await P.mds.CephFS.mount(c.backend)
        log.append((await fs2.getxattr("/doc", "user.owner"),
                    await fs2.stat("/doc")))

    log = _both(scenario)
    assert log[0] == (b"alice", ["user.owner", "user.tag"])
    assert log[1] == ["user.owner"] and log[2][1] == 61
    assert log[3][0] == b"alice"


def test_flock_shared_exclusive_semantics_equal_jax():
    async def scenario(P, mk, log):
        c, fs = await _mkfs(P, mk)
        await fs.write_file("/db", b"data")
        ino = (await fs.stat("/db"))["ino"]
        await fs.flock("/db", "client.a", exclusive=True)
        await _raises(log, BlockingIOError,
                      fs.flock("/db", "client.b", exclusive=True))
        await _raises(log, BlockingIOError,
                      fs.flock("/db", "client.b", exclusive=False))
        await fs.funlock("/db", "client.a")
        await fs.flock("/db", "client.a", exclusive=False)
        await fs.flock("/db", "client.b", exclusive=False)
        log.append(await c.backend.omap_get(f"{ino:x}.flock"))
        await _raises(log, BlockingIOError,
                      fs.flock("/db", "client.c", exclusive=True))
        await fs.funlock("/db", "client.b")
        await fs.flock("/db", "client.a", exclusive=True)
        log.append(await c.backend.omap_get(f"{ino:x}.flock"))

    log = _both(scenario)
    assert len(log) == 5 and log[0][0] == "BlockingIOError"


def test_write_through_symlink_updates_real_file_equal_jax():
    async def scenario(P, mk, log):
        c, fs = await _mkfs(P, mk)
        await fs.mkdirs("/data")
        await fs.write_file("/data/file.txt", b"")
        await fs.symlink("/link", "/data/file.txt")
        await fs.write_file("/link", b"written via link")
        log.append((await fs.read_file("/data/file.txt"),
                    await fs.stat("/data/file.txt")))
        await fs.setxattr("/link", "user.k", b"v")
        log.append(await fs.getxattr("/data/file.txt", "user.k"))

    log = _both(scenario)
    assert log[0][0] == b"written via link" and log[0][1]["size"] == 16
    assert log[1] == b"v"


def test_rename_cycle_guard_sees_through_symlinks_equal_jax():
    async def scenario(P, mk, log):
        c, fs = await _mkfs(P, mk)
        await fs.mkdirs("/data/sub")
        await fs.symlink("/alias", "/data")
        with pytest.raises(OSError) as info:
            await fs.rename("/data", "/alias/trap")
        log.append(_errno(P, info.value))
        await fs.write_file("/data/sub/ok", b"alive")
        log.append(await fs.read_file("/data/sub/ok"))

    log = _both(scenario)
    assert log[0][1] == 22 and log[1] == b"alive"


def test_unlink_purges_flock_state_equal_jax():
    async def scenario(P, mk, log):
        c, fs = await _mkfs(P, mk)
        await fs.write_file("/f", b"x")
        ino = (await fs.stat("/f"))["ino"]
        await fs.flock("/f", "holder")
        await fs.unlink("/f")
        log.append(await c.backend.omap_get(f"{ino:x}.flock"))

    assert _both(scenario) == [{}]


def test_rmdir_on_symlink_is_enotdir_equal_jax():
    async def scenario(P, mk, log):
        c, fs = await _mkfs(P, mk)
        await fs.mkdir("/real")
        await fs.symlink("/alias", "/real")
        with pytest.raises(OSError) as info:
            await fs.rmdir("/alias")
        log.append(_errno(P, info.value))
        log.append(((await fs.stat("/real"))["type"],
                    (await fs.lstat("/alias"))["type"]))

    log = _both(scenario)
    assert log[0][1] == 20 and log[1] == ("d", "l")


# -- multi-active MDS ---------------------------------------------------------


def test_multimds_subtree_partitioning_equal_jax():
    async def scenario(P, mk, log):
        c = mk()
        fs = P.multimds.MultiMDS(c.backend, n_ranks=2)
        await fs.start()
        await fs.mkdir("/hot")
        await fs.mkdir("/cold")
        await fs.export_subtree("/hot", 1)
        log.append((fs.rank_of("/hot/x"), fs.rank_of("/cold/x")))
        await fs.create("/hot/a")
        await fs.create("/cold/b")
        log.append(sorted(await fs.readdir("/hot")))
        fs2 = P.multimds.MultiMDS(c.backend, n_ranks=2)
        await fs2.start()
        log.append(fs2.rank_of("/hot/x"))
        await fs.rename("/hot/a", "/cold/a2")
        log.append((sorted(await fs.readdir("/cold")),
                    sorted(await fs.readdir("/hot")),
                    await fs.stat("/cold/a2")))

    log = _both(scenario)
    assert log[0] == (1, 0) and log[1] == ["a"] and log[2] == 1
    assert log[3][0] == ["a2", "b"] and log[3][1] == []
    assert log[3][2]["type"] == "f"


def test_multimds_balancer_exports_hot_subtree_equal_jax():
    async def scenario(P, mk, log):
        c = mk()
        fs = P.multimds.MultiMDS(c.backend, n_ranks=2,
                                 rebalance_factor=2.0)
        await fs.start()
        await fs.mkdir("/busy")
        await fs.mkdir("/quiet")
        for i in range(20):
            await fs.create(f"/busy/f{i}")
        log.append(await fs.balance())
        log.append(fs.rank_of("/busy/x"))
        await fs.create("/busy/after")
        log.append(sorted(await fs.readdir("/busy")))
        log.append(await fs.balance())

    log = _both(scenario)
    assert log[0] == "busy" and log[1] == 1
    assert "after" in log[2] and log[3] is None


def test_multimds_per_rank_journal_replay_equal_jax():
    async def scenario(P, mk, log):
        c = mk()
        fs = P.multimds.MultiMDS(c.backend, n_ranks=2)
        await fs.start()
        await fs.mkdir("/t")
        await fs.export_subtree("/t", 1)
        mds1 = fs.ranks[1]
        ino = await mds1._alloc_ino()
        tdir = await mds1._resolve_dir("/t")
        await _forge(P, c, mds1, {"op": "link", "dir": tdir,
                                  "name": "ghost",
                                  "dentry": mds1._mkdentry(ino, "f")})
        standby = P.mds.MDS(c.backend, rank=1)
        await standby.start()
        log.append((standby.replayed, sorted(await standby.readdir("/t"))))
        standby0 = P.mds.MDS(c.backend, rank=0)
        await standby0.start()
        log.append(standby0.replayed)

    log = _both(scenario)
    assert log == [(1, ["ghost"]), 0]


def test_unreadable_object_fails_the_read_where_jax_reads_zeros():
    """Queue 3 item 8: with two of a file object's three shards down,
    the port's ``read_file`` raises, the JAX package's returns zeros; a
    sparse hole reads as zeros in both."""
    got = {}
    for P in BOTH:
        P.PerfCounters.reset_all()

        async def main(P=P):
            c = P.make(4, PROFILE)
            try:
                fs = await P.mds.CephFS.mount(c.backend)
                await fs.write_file("/f", _bytes(22, 5000))
                await fs.write_file("/f", b"tail", offset=3 << 20)
                ino = (await fs.stat("/f"))["ino"]
                for osd in c.backend.acting_set(
                        P.mds_mod.data_oid(ino, 0))[:2]:
                    c.kill_osd(osd)
                hole = await fs.read_file("/f", 2 << 20, 100)
                try:
                    return hole, await fs.read_file("/f", 0, 100)
                except IOError as e:
                    return hole, (type(e).__name__, str(e))
            finally:
                await c.shutdown()

        got[P.name] = _run(main(), P)
    assert got["port"][0] == got["jax"][0] == bytes(100)
    assert got["jax"][1] == bytes(100)
    assert got["port"][1][0] == "OSError" and "decode" in got["port"][1][1]
