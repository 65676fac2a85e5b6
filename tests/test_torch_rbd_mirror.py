"""The port's image journaling and rbd-mirror against the JAX package's.

Each case of the JAX package's ``tests/test_rbd_mirror.py`` runs as the
same script through both packages in one process: the JAX package's
``ECCluster`` on its default plugin (``jerasure``, on the host) and the
port's on its default, the ``cuda`` plugin, with the profile key
``device=cpu`` (the kernels' plain versions).  Every value a script reads
back (image and snapshot bytes, journal entries and positions, trim
results, mirror lists, status and applied counts, exceptions) must be
equal, and so must every OSD's store at the end, in every cluster the
script made (source and destination): the shards, xattrs and omap of
every object.  Inputs are made from numpy seeds; the tolerance is byte
equality.
"""

import asyncio
import types

import numpy as np
import pytest

from ceph_tpu import rbd as j_rbd
from ceph_tpu.osd import cluster as j_cluster
from ceph_tpu.osdc import journaler as j_journaler
from ceph_tpu.rbd import journal as j_journal
from ceph_tpu.rbd import mirror as j_mirror
from ceph_tpu.utils.perf import PerfCounters as JPerfCounters
from ceph_tpu_torch import rbd
from ceph_tpu_torch.osd import cluster, cluster_bench
from ceph_tpu_torch.osdc import journaler
from ceph_tpu_torch.rbd import journal, mirror
from ceph_tpu_torch.utils.perf import PerfCounters
from torch_verify import port_verifiers, verifying_policy

PORT = types.SimpleNamespace(
    name="port", rbd=rbd, journal=journal, mirror=mirror,
    journaler=journaler, PerfCounters=PerfCounters,
    make=lambda n, prof: cluster.ECCluster(n, dict(prof, device="cpu")))
JAX = types.SimpleNamespace(
    name="jax", rbd=j_rbd, journal=j_journal, mirror=j_mirror,
    journaler=j_journaler, PerfCounters=JPerfCounters,
    make=lambda n, prof: j_cluster.ECCluster(n, dict(prof)))
BOTH = (PORT, JAX)
PROFILE = {"k": "2", "m": "1"}
JOURNALING = rbd.FEATURE_JOURNALING
assert JOURNALING == j_rbd.FEATURE_JOURNALING


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


def _both(scenario, n_osds=4):
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




async def _image(P, c, name="img", size=1 << 20, journaled=True):
    await P.rbd.RBD(c.backend).create(
        name, size, order=16, features=[JOURNALING] if journaled else None)
    return await P.rbd.Image.open(c.backend, name)


async def _journal(P, c, name="img"):
    jr = P.rbd.ImageJournal(c.backend, name)
    await jr.open()
    return jr


def _entries(got):
    """Journal entries as plain values (start, end, event)."""
    return [(s, e, ev) for s, e, ev in got]


# -- Journaler client registry ------------------------------------------------


def test_journaler_named_clients_pin_trim_equal_jax():
    pads = [_bytes(10 + i, 300) for i in range(20)]

    async def scenario(P, mk, log):
        c = mk()
        j = P.journaler.Journaler(c.backend, "log", object_size=2048)
        await j.open()
        for i in range(20):
            await j.append({"n": i, "pad": pads[i]})
        await j.register_client("peer", 0)
        await j.committed(j.write_pos)
        log.append(await j.trim())
        entries = await j.replay_entries(0)
        mid = entries[len(entries) // 2][1]
        await j.committed(mid, client="peer")
        log.append((await j.trim(), j.expire_pos, mid))
        rest = await j.replay_entries(await j.client_pos("peer"))
        log.append(_entries(rest))
        await j.unregister_client("peer")
        log.append((await j.trim(), await j.clients()))

    log = _both(scenario)
    assert log[0] == 0 and log[1][0] > 0 and log[1][1] <= log[1][2]
    assert [e["n"] for _, _, e in log[2]] == list(range(11, 20))
    assert log[3][0] > 0


# -- image journaling ---------------------------------------------------------


def test_journaled_image_records_and_replays_on_crash_equal_jax():
    async def scenario(P, mk, log):
        c = mk()
        img = await _image(P, c)
        log.append(img._journal is not None)
        await img.write(1000, b"hello journal")
        log.append(await img.read(1000, 13))
        jr = await _journal(P, c)
        log.append(await jr.append(
            {"op": "write", "off": 5000, "data": b"recovered"}))
        log.append(await img.read(5000, 9))
        img2 = await P.rbd.Image.open(c.backend, "img")
        log.append((await img2.read(5000, 9), await img2.read(1000, 13)))
        log.append(_entries(await (await _journal(P, c)).uncommitted()))

    log = _both(scenario)
    assert log[0] is True and log[1] == b"hello journal"
    assert log[3] == bytes(9)
    assert log[4] == (b"recovered", b"hello journal") and log[5] == []


def test_crash_replay_journals_no_event_again_equal_jax():
    """``rbd/image.py``'s ``_REPLAYING``: the events a crash replay
    re-applies are not journaled a second time, while a write that
    another task makes through the same handle during the replay
    journals once (each task carries its own copy of the context)."""
    pieces = [_bytes(40 + i, 700) for i in range(6)]

    async def scenario(P, mk, log):
        c = mk()
        img = await _image(P, c)
        await img.write(0, b"base")
        jr = await _journal(P, c)
        for i, piece in enumerate(pieces[:4]):
            await jr.append({"op": "write", "off": 4096 * (i + 1),
                             "data": piece})
        await jr.append({"op": "discard", "off": 1, "len": 2})
        await jr.append({"op": "snap_create", "name": "r1"})
        end = jr.j.write_pos
        opened = await P.rbd.Image.open(c.backend, "img")
        log.append((len(await jr.uncommitted()),
                    _entries(await opened._journal.j.replay_entries(end))))
        for i, piece in enumerate(pieces[4:], 5):
            await opened._journal.append({"op": "write", "off": 4096 * i,
                                          "data": piece})
        end = opened._journal.j.write_pos
        await asyncio.gather(opened._crash_replay(),
                             opened.write(60_000, b"concurrent"))
        log.append(_entries(await opened._journal.j.replay_entries(end)))
        log.append(_entries(await opened._journal.uncommitted()))
        log.append((await opened.read(0, 4096 * 6 + 700),
                    await opened.read(60_000, 10), opened.snap_list()))

    log = _both(scenario)
    assert log[0] == (6, [])
    assert [ev for _s, _e, ev in log[1]] == [
        {"op": "write", "off": 60_000, "data": b"concurrent"}]
    assert log[2] == []
    data, tail, snaps = log[3]
    assert data[:4] == b"b\0\0e" and tail == b"concurrent"
    assert all(data[4096 * i:4096 * i + 700] == piece
               for i, piece in enumerate(pieces, 1)) and snaps == ["r1"]


def test_journaled_snap_and_resize_events_replay_idempotently_equal_jax():
    async def scenario(P, mk, log):
        c = mk()
        img = await _image(P, c)
        await img.write(0, b"v1")
        await img.snap_create("s1")
        await img.write(0, b"v2")
        await img.resize(2 << 20)
        snap = await P.rbd.Image.open(c.backend, "img", snap="s1")
        log.append((img.size, img.snap_list(), await img.read(0, 2),
                    await snap.read(0, 2)))
        jr = await _journal(P, c)
        await jr.append({"op": "snap_create", "name": "s1"})
        img3 = await P.rbd.Image.open(c.backend, "img")
        log.append((img3.snap_list(), img3.snaps))
        log.append(_entries(await jr.j.replay_entries(0)))

    log = _both(scenario)
    assert log[0] == (2 << 20, ["s1"], b"v2", b"v1")
    assert log[1][0] == ["s1"]


def test_feature_toggle_enables_and_disables_journaling_equal_jax():
    async def scenario(P, mk, log):
        c = mk()
        img = await _image(P, c, journaled=False)
        log.append(img._journal is None)
        await img.update_features(enable=[JOURNALING])
        log.append(img.features)
        await img.write(0, b"journaled")
        log.append((await _journal(P, c)).j.write_pos)
        await img.update_features(disable=[JOURNALING])
        log.append(img._journal is None)
        await img.write(0, b"plain few")
        img2 = await P.rbd.Image.open(c.backend, "img")
        log.append((img2._journal is None, await img2.read(0, 9)))

    log = _both(scenario)
    assert log[0] is True and JOURNALING in log[1] and log[2] > 0
    assert log[3] is True and log[4] == (True, b"plain few")


def test_refresh_attaches_journal_enabled_by_other_handle_equal_jax():
    async def scenario(P, mk, log):
        c = mk()
        h1 = await _image(P, c, journaled=False)
        h2 = await P.rbd.Image.open(c.backend, "img")
        await h2.update_features(enable=[JOURNALING])
        await h1.refresh()
        log.append(h1._journal is not None)
        await h1.write(0, b"via h1")
        jr = await _journal(P, c)
        log.append((jr.j.write_pos, _entries(await jr.j.replay_entries(0))))

    log = _both(scenario)
    assert log[0] is True and log[1][0] > 0
    assert log[1][1][0][2] == {"op": "write", "off": 0, "data": b"via h1"}


def test_discard_zeroes_range_equal_jax():
    pattern = bytes(range(256)) * 16

    async def scenario(P, mk, log):
        c = mk()
        img = await _image(P, c, size=256 << 10)
        await img.write(0, pattern)
        await img.discard(100, 1000)
        log.append(await img.read(0, 4096))
        log.append(_entries(await (await _journal(P, c)).j.replay_entries(0)))

    log = _both(scenario)
    assert log[0] == pattern[:100] + bytes(1000) + pattern[1100:]


# -- rbd-mirror ---------------------------------------------------------------


def test_mirror_requires_journaling_equal_jax():
    async def scenario(P, mk, log):
        c = mk()
        await _image(P, c, "plain", journaled=False)
        await _raises(log, IOError, P.rbd.mirror_enable(c.backend, "plain"))
        log.append(await P.rbd.mirror_list(c.backend))

    assert _both(scenario)[-1] == []


def test_mirror_bootstrap_and_steady_state_replay_equal_jax():
    async def scenario(P, mk, log):
        src, dst = mk(), mk()
        img = await _image(P, src)
        await img.write(0, b"pre-mirror data")
        await P.rbd.mirror_enable(src.backend, "img")
        log.append(await P.rbd.mirror_list(src.backend))
        daemon = P.rbd.MirrorDaemon(src.backend, dst.backend)
        log.append(await daemon.run_once())
        dimg = await P.rbd.Image.open(dst.backend, "img")
        log.append(await dimg.read(0, 15))
        await img.write(70000, b"incremental")
        await img.snap_create("s1")
        await img.write(70000, b"INCREMENTAL")
        await img.resize(2 << 20)
        log.append(await daemon.run_once())
        dimg = await P.rbd.Image.open(dst.backend, "img")
        dsnap = await P.rbd.Image.open(dst.backend, "img", snap="s1")
        log.append((dimg.size, dimg.snap_list(),
                    await dimg.read(0, 2 << 20),
                    await dsnap.read(0, 1 << 20)))
        log.append(await daemon.status())

    log = _both(scenario)
    assert log[0] == ["img"] and log[2] == b"pre-mirror data"
    assert log[3]["img"] >= 4
    size, snaps, head, snap = log[4]
    assert size == 2 << 20 and snaps == ["s1"]
    assert head[70000:70011] == b"INCREMENTAL"
    assert snap[70000:70011] == b"incremental"
    assert log[5]["img"] == {"state": "up+replaying", "entries_behind": 0}


def test_mirror_peer_position_survives_daemon_restart_equal_jax():
    async def scenario(P, mk, log):
        src, dst = mk(), mk()
        img = await _image(P, src)
        await P.rbd.mirror_enable(src.backend, "img")
        d1 = P.rbd.MirrorDaemon(src.backend, dst.backend)
        log.append(await d1.run_once())
        await img.write(0, b"first")
        log.append(await d1.run_once())
        await img.write(0, b"SECON")
        d2 = P.rbd.MirrorDaemon(src.backend, dst.backend)
        log.append(await d2.run_once())
        dimg = await P.rbd.Image.open(dst.backend, "img")
        log.append(await dimg.read(0, 5))
        log.append(await (await _journal(P, src)).j.clients())

    log = _both(scenario)
    assert log[2]["img"] >= 1 and log[3] == b"SECON"


def test_journaled_snap_create_duplicate_still_raises_equal_jax():
    async def scenario(P, mk, log):
        c = mk()
        img = await _image(P, c)
        log.append(await img.snap_create("s1"))
        await _raises(log, IOError, img.snap_create("s1"))
        await _raises(log, IOError, img.snap_remove("nope"))
        log.append(_entries(await (await _journal(P, c)).j.replay_entries(0)))

    log = _both(scenario)
    assert log[1] == ("OSError", "snap_create rc=-17")
    assert len(log[3]) == 1


def test_remove_journaled_image_drops_journal_equal_jax():
    async def scenario(P, mk, log):
        c = mk()
        img = await _image(P, c)
        await img.write(0, b"doomed data")
        jr = await _journal(P, c)
        await jr.append({"op": "write", "off": 64, "data": b"ghost"})
        await P.rbd.RBD(c.backend).remove("img")
        img2 = await _image(P, c)
        log.append((await img2.read(0, 11), await img2.read(64, 5)))

    assert _both(scenario)[0] == (bytes(11), bytes(5))


def test_disable_journaling_refused_while_mirrored_then_cleans_up_equal_jax():
    async def scenario(P, mk, log):
        c = mk()
        img = await _image(P, c)
        await img.write(0, b"x" * 4096)
        await P.rbd.mirror_enable(c.backend, "img")
        await _raises(log, BlockingIOError,
                      img.update_features(disable=[JOURNALING]))
        await P.rbd.mirror_disable(c.backend, "img")
        await img.update_features(disable=[JOURNALING])
        try:
            left = await c.backend.omap_get(
                f"{P.journal.journal_name('img')}.journal")
        except (FileNotFoundError, IOError):
            left = {}
        log.append((left, img.features))

    assert _both(scenario)[-1][0] == {}


def test_daemon_restart_skips_bootstrap_copy_equal_jax(monkeypatch):
    async def scenario(P, mk, log):
        src, dst = mk(), mk()
        img = await _image(P, src)
        await P.rbd.mirror_enable(src.backend, "img")
        log.append(await P.rbd.MirrorDaemon(src.backend,
                                            dst.backend).run_once())

        async def boom(self):
            raise AssertionError("re-bootstrap after restart")

        with monkeypatch.context() as m:
            m.setattr(P.mirror.ImageReplayer, "bootstrap", boom)
            await img.write(0, b"after restart")
            log.append(await P.rbd.MirrorDaemon(src.backend,
                                                dst.backend).run_once())
        dimg = await P.rbd.Image.open(dst.backend, "img")
        log.append(await dimg.read(0, 13))

    assert _both(scenario)[-1] == b"after restart"


def test_mirror_peer_pins_journal_trim_equal_jax():
    block = _bytes(11, 65536)

    async def scenario(P, mk, log):
        src = mk()
        img = await _image(P, src)
        jr = await _journal(P, src)
        await jr.register_peer("mirror-peer", 0)
        for _ in range(40):
            await img.write(0, block)
        await jr.open()
        log.append((jr.j.commit_pos, jr.j.write_pos, await jr.trim()))
        await jr.unregister_peer("mirror-peer")
        log.append((await jr.trim(), jr.j.expire_pos))

    log = _both(scenario)
    assert log[0][0] == log[0][1] > 0 and log[0][2] == 0
    assert log[1][0] > 0


def test_mirror_promote_demote_failover_equal_jax():
    async def scenario(P, mk, log):
        a, b = mk(), mk()
        img_a = await _image(P, a)
        await img_a.write(0, b"from A")
        await P.rbd.mirror_enable(a.backend, "img")
        log.append(await P.rbd.mirror_is_primary(a.backend, "img"))
        daemon_ab = P.rbd.MirrorDaemon(a.backend, b.backend)
        log.append(await daemon_ab.run_once())
        img_b = await P.rbd.Image.open(b.backend, "img")
        log.append(img_b._primary)
        await _raises(log, PermissionError, img_b.write(0, b"illegal"))
        await _raises(log, IOError, P.rbd.mirror_promote(a.backend, "img"))
        await P.rbd.mirror_demote(a.backend, "img")
        img_a = await P.rbd.Image.open(a.backend, "img")
        await _raises(log, PermissionError, img_a.write(0, b"demoted"))
        await P.rbd.mirror_promote(b.backend, "img")
        img_b = await P.rbd.Image.open(b.backend, "img")
        await img_b.write(0, b"from B")
        log.append(await daemon_ab.status())
        log.append(await daemon_ab.run_once())
        await _raises(log, IOError, daemon_ab.replayers["img"].bootstrap())
        await img_b.update_features(enable=[JOURNALING])
        img_b = await P.rbd.Image.open(b.backend, "img")
        await img_b.write(6, b" again")
        log.append(await P.rbd.MirrorDaemon(b.backend, a.backend).run_once())
        img_a = await P.rbd.Image.open(a.backend, "img")
        log.append((await img_a.read(0, 12),
                    await P.rbd.mirror_is_primary(a.backend, "img"),
                    await P.rbd.mirror_list(a.backend),
                    await P.rbd.mirror_list(b.backend)))

    log = _both(scenario)
    assert log[0] is True and log[2] is False
    assert log[6]["img"]["state"] == "stopped" and log[7] == {"img": 0}
    assert log[-1][:2] == (b"from B again", False)
