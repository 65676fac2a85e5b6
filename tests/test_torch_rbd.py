"""The port's RBD (``rbd/``, ``tools/rbd_cli.py``) against the JAX package's.

Each case of the JAX package's ``tests/test_rbd.py`` runs as the same
script through both packages in one process: the JAX package's
``ECCluster`` on its default plugin (``jerasure``, on the host) and the
port's on its default, the ``cuda`` plugin, with the profile key
``device=cpu`` (the kernels' plain versions).  Every value a script reads
back (image and snapshot bytes, sizes, snapshot lists, object-map states,
``fast_diff`` extents, exceptions, NBD reply bytes, CLI output) must be
equal, and so must every OSD's store at the end: the shards, xattrs and
omap of every object of every cluster the script made.  Inputs are made
from numpy seeds; the tolerance is byte equality.
"""

import asyncio
import struct
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from ceph_tpu import rbd as j_rbd
from ceph_tpu.osd import cluster as j_cluster
from ceph_tpu.osd import ecbackend as j_ecbackend
from ceph_tpu.osd import placement as j_placement
from ceph_tpu.osdc import striper as j_striper
from ceph_tpu.rbd import nbd as j_nbd
from ceph_tpu.rbd import objectmap as j_objectmap
from ceph_tpu.rbd import replay as j_replay
from ceph_tpu.utils.perf import PerfCounters as JPerfCounters
from ceph_tpu_torch import rbd
from ceph_tpu_torch.osd import cluster, cluster_bench, ecbackend, placement
from ceph_tpu_torch.osdc import striper
from ceph_tpu_torch.rbd import nbd, objectmap, replay
from ceph_tpu_torch.tools import rbd_cli
from ceph_tpu_torch.utils.perf import PerfCounters

PORT = types.SimpleNamespace(
    name="port", rbd=rbd, nbd=nbd, objectmap=objectmap, replay=replay,
    PerfCounters=PerfCounters, ECBackend=ecbackend.ECBackend,
    CrushPlacement=placement.CrushPlacement,
    make=lambda n, prof: cluster.ECCluster(n, dict(prof, device="cpu")))
JAX = types.SimpleNamespace(
    name="jax", rbd=j_rbd, nbd=j_nbd, objectmap=j_objectmap,
    replay=j_replay, PerfCounters=JPerfCounters,
    ECBackend=j_ecbackend.ECBackend,
    CrushPlacement=j_placement.CrushPlacement,
    make=lambda n, prof: j_cluster.ECCluster(n, dict(prof)))
BOTH = (PORT, JAX)
PROFILE = {"k": "2", "m": "1"}
REPO = Path(__file__).resolve().parent.parent


def _policy_runs_tasks() -> bool:
    """Whether the current event-loop policy's loops can run a task (the
    tier-1 conftest's atomic-section verifier cannot under Python 3.12)."""
    async def nothing():
        return None

    coro = nothing()
    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(coro)
        return True
    except TypeError:
        coro.close()
        return False
    finally:
        loop.close()


@pytest.fixture(autouse=True)
def _loop_policy():
    """Keep the conftest's verifying policy where it can run a task;
    where it cannot, both packages' loops run under asyncio's default
    policy."""
    if _policy_runs_tasks():
        yield
        return
    saved = asyncio.get_event_loop_policy()
    asyncio.set_event_loop_policy(asyncio.DefaultEventLoopPolicy())
    yield
    asyncio.set_event_loop_policy(saved)


def _run(coro, P=None):
    """Run ``coro`` on a new loop: the port's under this file's policy,
    the JAX package's (``P`` is ``JAX``) under asyncio's default policy
    for this call alone (its atomic sections would trip the conftest's
    verifier)."""
    saved = asyncio.get_event_loop_policy()
    if P is JAX:
        asyncio.set_event_loop_policy(asyncio.DefaultEventLoopPolicy())
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()
        asyncio.set_event_loop_policy(saved)


def _both(scenario, n_osds=6):
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


# -- Striper (the layouts of the JAX package's striper cases) ---------------


@pytest.mark.parametrize("layout,extents", [
    ((1 << 20, 1 << 20, 1), ((100, 50), ((1 << 20) - 10, 20))),
    ((256 << 10, 64 << 10, 3), tuple((u * (64 << 10), 64 << 10)
                                     for u in range(13))),
    ((128 << 10, 32 << 10, 2), ((0, 1_000_000),)),
], ids=["simple", "raid0_round_robin", "reassembly"])
def test_striper_extents_equal_jax(layout, extents):
    mine = striper.Striper(striper.FileLayout(*layout))
    theirs = j_striper.Striper(j_striper.FileLayout(*layout))
    for off, length in extents:
        ext = mine.map_extent(off, length)
        assert ext == theirs.map_extent(off, length)
        assert mine.coalesce(ext) == theirs.coalesce(ext)
        assert sum(e[2] for e in ext) == length
        for spans in mine.coalesce(ext).values():
            for (a, al), (b, _) in zip(spans, spans[1:]):
                assert a + al <= b
    if layout[2] == 1:
        assert mine.map_extent((1 << 20) - 10, 20) == \
            [(0, (1 << 20) - 10, 10), (1, 0, 10)]
    if layout[2] == 3:
        su = 64 << 10
        for u in range(12):
            [(obj, off, _ln)] = mine.map_extent(u * su, su)
            assert (obj, off) == (u % 3, (u // 3) * su)
        assert mine.map_extent(12 * su, su)[0][:2] == (3, 0)


def test_striper_object_count_equal_jax():
    mine = striper.Striper(striper.FileLayout(4, 2, 2))
    theirs = j_striper.Striper(j_striper.FileLayout(4, 2, 2))
    for total in range(0, 40):
        assert mine.object_count(total) == theirs.object_count(total)
        if total:
            touched = {e[0] for e in mine.map_extent(0, total)}
            assert mine.object_count(total) == len(touched), total
    assert [mine.object_count(n) for n in (0, 1, 3, 6, 9)] == \
        [0, 1, 2, 2, 3]


# -- images --------------------------------------------------------------


def test_create_list_info_remove_equal_jax():
    async def scenario(P, mk, log):
        c = mk()
        r = P.rbd.RBD(c.backend)
        await r.create("img1", 1 << 24, order=20)
        await r.create("img2", 1 << 22)
        log.append(await r.list())
        img = await P.rbd.Image.open(c.backend, "img1")
        log.append((img.size, img.order))
        await _raises(log, FileExistsError, r.create("img1", 1))
        await r.remove("img2")
        log.append(await r.list())
        await _raises(log, FileNotFoundError,
                      P.rbd.Image.open(c.backend, "img2"))

    log = _both(scenario)
    assert log[0] == ["img1", "img2"] and log[1] == (1 << 24, 20)
    assert log[3] == ["img1"]


def test_io_across_objects_equal_jax():
    payload = _bytes(1, 76_800)

    async def scenario(P, mk, log):
        c = mk()
        await P.rbd.RBD(c.backend).create("img", 200 << 10, order=16)
        img = await P.rbd.Image.open(c.backend, "img")
        off = (64 << 10) - 1000  # straddles the object 0/1 boundary
        await img.write(off, payload)
        log.append(await img.read(off, len(payload)))
        log.append(await img.read(0, 100))
        await img.write(off + 5000, b"X" * 100)
        log.append(await img.read(off, len(payload)))
        log.append(await img.read(0, 200 << 10))

    log = _both(scenario)
    exp = bytearray(payload)
    exp[5000:5100] = b"X" * 100
    assert log[0] == payload and log[1] == bytes(100)
    assert log[2] == bytes(exp)


def test_write_past_end_rejected_equal_jax():
    async def scenario(P, mk, log):
        c = mk()
        await P.rbd.RBD(c.backend).create("img", 1000)
        img = await P.rbd.Image.open(c.backend, "img")
        await _raises(log, IOError, img.write(990, b"x" * 20))
        await img.write(990, b"y" * 10)
        log.append(await img.read(980, 40))

    log = _both(scenario)
    assert log[1] == bytes(10) + b"y" * 10


def test_resize_notifies_other_clients_equal_jax():
    async def scenario(P, mk, log):
        c = mk()
        await P.rbd.RBD(c.backend).create("img", 1 << 20)
        img = await P.rbd.Image.open(c.backend, "img")
        b2 = P.ECBackend(c.ec, c.osds, c.messenger, name="client2",
                         placement=P.CrushPlacement(
                             6, c.ec.get_chunk_count()))
        img2 = await P.rbd.Image.open(b2, "img")
        refreshed = asyncio.Event()
        seen = []

        async def on_header(oid, payload):
            seen.append((oid, payload))
            await img2.refresh()
            refreshed.set()

        await img2.watch_header(on_header)
        await img.resize(1 << 21)
        await asyncio.wait_for(refreshed.wait(), 5)
        log.append((img2.size, seen))
        await img2.unwatch_header()

    log = _both(scenario)
    assert log[0][0] == 1 << 21


def test_snapshots_metadata_equal_jax():
    async def scenario(P, mk, log):
        c = mk()
        await P.rbd.RBD(c.backend).create("img", 1 << 20)
        img = await P.rbd.Image.open(c.backend, "img")
        log.append(await img.snap_create("s1"))
        log.append(await img.snap_create("s2"))
        log.append(img.snap_list())
        await img.snap_remove("s1")
        log.append((img.snap_list(), img.snaps, img.snap_seq))

    log = _both(scenario)
    assert log[:3] == [1, 2, ["s1", "s2"]] and log[3][0] == ["s2"]


def test_exclusive_lock_equal_jax():
    async def scenario(P, mk, log):
        c = mk()
        await P.rbd.RBD(c.backend).create("img", 1 << 20)
        img = await P.rbd.Image.open(c.backend, "img")
        await img.lock_acquire("client-A")
        await _raises(log, BlockingIOError, img.lock_acquire("client-B"))
        await img.lock_release("client-A")
        await img.lock_acquire("client-B")
        log.append(await c.backend.omap_get("rbd_header.img"))

    _both(scenario)


def _reference_rbd_cli():
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import rbd_cli as j_rbd_cli
    finally:
        sys.path.remove(str(REPO / "tools"))
    return j_rbd_cli


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_rbd_cli_roundtrip_equal_jax(tmp_path, capsys):
    src = tmp_path / "src.bin"
    src.write_bytes(_bytes(2, 512_000))
    runs = {}
    for name, tool, extra in (("port", rbd_cli, ["--device", "cpu"]),
                              ("jax", _reference_rbd_cli(), [])):
        data = tmp_path / name / "data"
        dst = tmp_path / name / "dst.bin"
        base = ["--data-path", str(data), "--osds", "4", *extra]
        rcs = [tool.main(["import", str(src), "disk1", "--order", "16",
                          *base]),
               tool.main(["ls", *base]), tool.main(["info", "disk1", *base]),
               tool.main(["snap", "create", "disk1@s1", *base]),
               tool.main(["snap", "ls", "disk1", *base]),
               tool.main(["export", "disk1", str(dst), *base])]
        out = capsys.readouterr().out.replace(str(tmp_path / name), "<run>")
        runs[name] = (rcs, out, dst.read_bytes(), _tree(data))
    assert runs["port"] == runs["jax"]
    rcs, out, exported, tree = runs["port"]
    assert rcs == [0] * 6 and "disk1" in out and "s1" in out
    assert exported == src.read_bytes() and tree


def test_image_snapshot_data_readback_equal_jax():
    v1, v2 = _bytes(3, 200 << 10), _bytes(4, 200 << 10)

    async def scenario(P, mk, log):
        c = mk()
        await P.rbd.RBD(c.backend).create("disk", 512 << 10, order=16)
        img = await P.rbd.Image.open(c.backend, "disk")
        await img.write(0, v1)
        await img.snap_create("s1")
        await img.write(0, v2)
        log.append(await img.read(0, 200 << 10))
        view = await P.rbd.Image.open(c.backend, "disk", snap="s1")
        log.append(await view.read(0, 200 << 10))
        await img.snap_rollback("s1")
        log.append(await img.read(0, 200 << 10))
        await img.snap_remove("s1")
        log.append(img.snap_list())

    log = _both(scenario)
    assert log == [v2, v1, v1, []]


def test_clone_cow_layering_and_copyup_equal_jax():
    golden = _bytes(5, 256 << 10)

    async def scenario(P, mk, log):
        c = mk()
        r = P.rbd.RBD(c.backend)
        await r.create("base", 256 << 10, order=16)
        base = await P.rbd.Image.open(c.backend, "base")
        await base.write(0, golden)
        await base.snap_create("gold")
        await _raises(log, PermissionError, r.clone("base", "gold", "vm1"))
        await base.snap_protect("gold")
        await r.clone("base", "gold", "vm1")
        child = await P.rbd.Image.open(c.backend, "vm1")
        log.append(child.parent)
        log.append(await child.read(0, 256 << 10))
        await base.write(0, b"\xFF" * (64 << 10))
        log.append(await child.read(0, 64 << 10))
        await child.write(100, b"CHILD")
        log.append(await child.read(0, 64 << 10))
        await _raises(log, BlockingIOError, base.snap_unprotect("gold"))
        await child.flatten()
        log.append((child.parent,
                    (await P.rbd.Image.open(c.backend, "vm1")).parent))
        log.append(await child.read(0, 256 << 10))
        await base.snap_unprotect("gold")
        await base.snap_remove("gold")
        log.append(await base.read(0, 256 << 10))

    log = _both(scenario)
    assert log[1]["image"] == "base" and log[2] == golden
    assert log[3] == golden[:64 << 10]
    assert log[4] == golden[:100] + b"CHILD" + golden[105:64 << 10]
    assert log[6] == (None, None)
    assert log[7][64 << 10:] == golden[64 << 10:]


def test_clone_remove_ordering_equal_jax():
    async def scenario(P, mk, log):
        c = mk()
        r = P.rbd.RBD(c.backend)
        await r.create("p", 128 << 10, order=16)
        p = await P.rbd.Image.open(c.backend, "p")
        await p.write(0, b"P" * (128 << 10))
        await p.snap_create("s")
        await p.snap_protect("s")
        await r.clone("p", "s", "kid")
        await _raises(log, IOError, r.remove("p"))
        await r.remove("kid")
        await p.snap_unprotect("s")
        await p.snap_remove("s")
        await r.remove("p")
        log.append(await r.list())

    assert _both(scenario)[-1] == []


def test_clone_shrink_regrow_reads_zeros_equal_jax():
    async def scenario(P, mk, log):
        c = mk()
        r = P.rbd.RBD(c.backend)
        await r.create("pp", 192 << 10, order=16)
        p = await P.rbd.Image.open(c.backend, "pp")
        await p.write(0, b"P" * (192 << 10))
        await p.snap_create("s")
        await p.snap_protect("s")
        await r.clone("pp", "s", "cc")
        child = await P.rbd.Image.open(c.backend, "cc")
        await child.resize(64 << 10)
        await child.resize(192 << 10)
        log.append((child.parent, await child.read(0, 192 << 10)))

    (parent, data), = _both(scenario)
    assert parent["overlap"] == 64 << 10
    assert data == b"P" * (64 << 10) + bytes(128 << 10)


def test_remove_image_with_snaps_refused_equal_jax():
    async def scenario(P, mk, log):
        c = mk()
        r = P.rbd.RBD(c.backend)
        await r.create("im", 64 << 10, order=16)
        img = await P.rbd.Image.open(c.backend, "im")
        await img.write(0, b"z" * 1000)
        await img.snap_create("keep")
        await _raises(log, IOError, r.remove("im"))
        await img.snap_remove("keep")
        await r.remove("im")
        log.append(await r.list())

    assert _both(scenario)[-1] == []


class _StepClock:
    """A ``time`` stand-in whose ``perf_counter`` moves 0.25 ms a
    reading: the same calls read the same times in both packages."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self) -> float:
        self.now += 0.00025
        return self.now


def test_rbd_replay_reproduces_image_state_equal_jax(tmp_path, monkeypatch):
    """The trace's time stamps (``rbd/replay.py``'s ``perf_counter``) are
    pinned in both packages, so whole traces compare."""
    blob = _bytes(6, 150_000)
    traces = {}
    for mod in (replay, j_replay):
        monkeypatch.setattr(mod, "time", _StepClock())

    async def scenario(P, mk, log):
        c, c2 = mk(), mk()
        await P.rbd.RBD(c.backend).create("orig", 1 << 20, order=16)
        rec = P.replay.RecordingImage(
            await P.rbd.Image.open(c.backend, "orig"))
        await rec.write(0, blob)
        await rec.write(70_000, b"OVERWRITE" * 100)
        await rec.discard(10_000, 5_000)
        await rec.snap_create("s1")
        await rec.write(0, b"post-snap")
        await rec.resize(2 << 20)
        log.append(await rec.read(0, 9))
        path = str(tmp_path / f"trace-{P.name}.jsonl")
        rec.save(path)
        actions = P.replay.load_trace(path)
        traces[P.name] = actions
        await P.rbd.RBD(c2.backend).create("copy", 1 << 20, order=16)
        stats = await P.replay.replay(
            await P.rbd.Image.open(c2.backend, "copy"), actions)
        log.append(stats["ops"])
        for name, cl in (("orig", c), ("copy", c2)):
            img = await P.rbd.Image.open(cl.backend, name)
            snap = await P.rbd.Image.open(cl.backend, name, snap="s1")
            log.append((img.size, await img.read(0, 160_000),
                        await snap.read(0, 160_000)))

    log = _both(scenario)
    assert traces["port"] == traces["jax"]
    assert log[0] == b"post-snap"
    assert log[1]["write"] == 3 and log[1]["resize"] == 1
    assert log[2] == log[3] and log[2][0] == 2 << 20


# -- object map + fast-diff ---------------------------------------------------


def test_object_map_maintained_by_writes_equal_jax():
    async def scenario(P, mk, log):
        c = mk()
        await P.rbd.RBD(c.backend).create(
            "om", 8 << 20, order=20, features=["object-map", "fast-diff"])
        img = await P.rbd.Image.open(c.backend, "om")
        log.append(img.object_map_states())
        await img.write(0, b"a" * 100)
        await img.write(3 << 20, _bytes(7, 1 << 20))
        log.append(img.object_map_states())
        log.append((await P.rbd.Image.open(c.backend, "om"))
                   .object_map_states())
        await img.snap_create("s1")
        log.append(img.object_map_states())
        log.append(await c.backend.read(P.objectmap.map_oid("om", 1)))

    log = _both(scenario)
    ex, clean = objectmap.OBJECT_EXISTS, objectmap.OBJECT_EXISTS_CLEAN
    assert log[0] == bytes(8) and log[1] == log[2]
    assert log[1][0] == ex and log[1][3] == ex and log[1][1] == 0
    assert log[3][0] == clean and log[3][3] == clean


def test_fast_diff_extents_equal_jax():
    async def scenario(P, mk, log):
        c = mk()
        await P.rbd.RBD(c.backend).create(
            "fd", 8 << 20, order=20, features=["object-map", "fast-diff"])
        img = await P.rbd.Image.open(c.backend, "fd")
        await img.write(0, b"x" * 10)
        await img.write(5 << 20, b"y" * 10)
        await img.snap_create("s1")
        await img.write(2 << 20, b"z" * 10)
        await img.write(5 << 20, b"Y" * 10)
        log.append(await img.diff("s1"))
        log.append(await img.diff())
        await img.snap_create("s2")
        await img.write(7 << 20, b"w" * 10)
        log.append(await img.diff("s1"))
        log.append(await img.diff("s2"))
        await _raises(log, FileNotFoundError, img.diff("nope"))

    log = _both(scenario)
    assert [(off >> 20, ex) for off, _ln, ex in log[0]] == [(2, True),
                                                            (5, True)]
    assert sorted(off >> 20 for off, _ln, _ex in log[1]) == [0, 2, 5]
    assert sorted(off >> 20 for off, _ln, _ex in log[2]) == [2, 5, 7]
    assert [off >> 20 for off, _ln, _ex in log[3]] == [7]


def test_object_map_enable_rebuilds_and_serves_absence_equal_jax():
    async def scenario(P, mk, log):
        c = mk()
        await P.rbd.RBD(c.backend).create("re", 4 << 20, order=20)
        img = await P.rbd.Image.open(c.backend, "re")
        await img.write(1 << 20, b"pre-existing")
        await img.update_features(enable=["object-map"])
        log.append(img.object_map_states())
        calls = {"n": 0}
        orig = img.backend.stat

        async def counting_stat(oid):
            calls["n"] += 1
            return await orig(oid)

        img.backend.stat = counting_stat
        log.append((await img._object_absent("rbd_data.re.%016x" % 0),
                    await img._object_absent("rbd_data.re.%016x" % 1),
                    calls["n"]))
        img.backend.stat = orig
        await _raises(log, ValueError, img.update_features(
            enable=["fast-diff"], disable=["object-map"]))
        await img.update_features(disable=["object-map"])
        with pytest.raises(ValueError):
            img.object_map_states()
        log.append(img.features)

    log = _both(scenario)
    assert log[0][1] == objectmap.OBJECT_EXISTS and log[0][0] == 0
    assert log[1] == (True, False, 0)


# -- rbd-nbd ---------------------------------------------------------------


def test_nbd_export_protocol_roundtrip_equal_jax():
    data = _bytes(8, 70_000)

    async def scenario(P, mk, log):
        c = mk()
        await P.rbd.RBD(c.backend).create("disk", 4 << 20, order=20)
        srv = P.nbd.NBDServer(c.backend)
        port = await srv.start()
        r, w = await asyncio.open_connection("127.0.0.1", port)
        log.append(await r.readexactly(18))
        w.write(struct.pack(">I", 2))  # client flags: NO_ZEROES
        w.write(struct.pack(">QII", 0x49484156454F5054, 3, 0))  # LIST
        await w.drain()
        head = await r.readexactly(20)
        body = await r.readexactly(struct.unpack(">QIII", head)[3])
        log.append((head, body, await r.readexactly(20)))
        w.write(struct.pack(">QII", 0x49484156454F5054, 1, 4) + b"disk")
        await w.drain()
        log.append(await r.readexactly(10))

        async def cmd(ctype, offset, length, payload=b"", handle=7):
            w.write(struct.pack(">IHHQQI", 0x25609513, 0, ctype, handle,
                                offset, length) + payload)
            await w.drain()
            if ctype == 2:
                return b""  # DISC has no reply
            reply = await r.readexactly(16)
            if ctype == 0 and struct.unpack(">IIQ", reply)[1] == 0:
                reply += await r.readexactly(length)
            return reply

        for args in ((1, 1 << 20, 5, b"hello"), (0, 1 << 20, 5),
                     (1, (1 << 20) - 3000, len(data), data),
                     (0, (1 << 20) - 3000, len(data)), (3, 0, 0),
                     (4, 1 << 20, 5), (0, 1 << 20, 5), (0, 4 << 20, 16),
                     (2, 0, 0)):
            log.append(await cmd(*args))
        w.close()
        img = await P.rbd.Image.open(c.backend, "disk")
        log.append(await img.read((1 << 20) - 3000, len(data)))
        log.append(dict(srv.stats))
        await srv.stop()

    log = _both(scenario)
    assert struct.unpack(">QQH", log[0])[0] == 0x4E42444D41474943
    assert log[1][1][4:] == b"disk"
    assert struct.unpack(">QH", log[2])[0] == 4 << 20
    assert log[4][16:] == b"hello" and log[9][16:] == bytes(5)
    assert struct.unpack(">IIQ", log[10])[1] == 22  # past end: EINVAL
    assert log[12][:3000] == data[:3000] and log[12][3005:] == data[3005:]
    assert log[13]["write"] == 2 and log[13]["disc"] == 1


def test_kernel_library_that_fails_to_load_is_no_missing_object(
        monkeypatch, tmp_path):
    """An image read treats an ``IOError`` as a missing object (zeros, as
    the JAX package does); a kernel library that cannot load must raise
    something else, so no read carries on without its kernel."""
    from ceph_tpu_torch.ops import cuda_gf

    monkeypatch.setattr(cuda_gf, "_libs", {})
    monkeypatch.setattr(cuda_gf, "build",
                        lambda source, generated=None: tmp_path / "gone.so")
    with pytest.raises(RuntimeError, match="cannot load") as info:
        cuda_gf.load(cuda_gf.SOURCE.name, {})
    assert not isinstance(info.value, OSError)


def test_unreadable_object_fails_the_read_where_jax_reads_zeros():
    """Queue 3 item 8: with two of an object's three shards down nothing
    can decode it; the port's image read raises, the JAX package's reads
    the block as zeros.  A never-written block reads as zeros in both."""
    block = _bytes(12, 70_000)
    got = {}
    for P in BOTH:
        P.PerfCounters.reset_all()

        async def main(P=P):
            c = P.make(4, PROFILE)
            try:
                await P.rbd.RBD(c.backend).create("img", 1 << 20, order=16)
                img = await P.rbd.Image.open(c.backend, "img")
                await img.write(0, block)
                for osd in c.backend.acting_set(
                        "rbd_data.img.0000000000000000")[:2]:
                    c.kill_osd(osd)
                hole = await img.read(5 << 16, 1000)
                try:
                    return hole, await img.read(0, 1000)
                except IOError as e:
                    return hole, (type(e).__name__, str(e))
            finally:
                await c.shutdown()

        got[P.name] = _run(main(), P)
    assert got["port"][0] == got["jax"][0] == bytes(1000)
    assert got["jax"][1] == bytes(1000)
    assert got["port"][1][0] == "OSError" and "decode" in got["port"][1][1]


def test_cli_raises_without_cuda_unless_asked_for_the_cpu(tmp_path):
    """``rbd_cli`` builds its pool on the ``cuda`` plugin: on a host
    without a card it raises, and ``--device cpu`` runs it there."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    base = ["--data-path", str(tmp_path / "data"), "--osds", "4"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rbd_cli.main(["ls", *base])
    assert rbd_cli.main(["ls", *base, "--device", "cpu"]) == 0
