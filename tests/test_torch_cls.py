"""The port's object classes (``cls/``) against the JAX package's.

Each cluster case of the JAX package's ``tests/test_cls.py`` runs as the
same script through both packages in one process: the JAX package's
``ECCluster`` on its default plugin (``jerasure``, on the host) and the
port's on its default, the ``cuda`` plugin, with the profile key
``device=cpu`` (the kernels' plain versions).  Every ``exec``'s
``(rc, out)`` must be equal byte for byte, and so must every OSD's store
at the end: the shards, xattrs and omap of every object a method wrote.
Methods run on the client's objecter (``exec`` is sent to the primary)
and, where a case says so, straight on the primary's ``ECBackend``.
"""

import asyncio
import types

import numpy as np
import pytest

from ceph_tpu import cls as j_cls
from ceph_tpu.osd import cluster as j_cluster
from ceph_tpu.osd import ecbackend as j_ecbackend
from ceph_tpu.osd import placement as j_placement
from ceph_tpu.utils.encoding import Decoder as JDecoder
from ceph_tpu.utils.encoding import Encoder as JEncoder
from ceph_tpu.utils.perf import PerfCounters as JPerfCounters
from ceph_tpu_torch import cls
from ceph_tpu_torch.osd import cluster, cluster_bench, ecbackend, placement
from ceph_tpu_torch.utils.encoding import Decoder, Encoder
from ceph_tpu_torch.utils.perf import PerfCounters
from torch_verify import port_verifiers

PORT = types.SimpleNamespace(
    name="port", cls=cls, Encoder=Encoder, Decoder=Decoder,
    PerfCounters=PerfCounters, ECBackend=ecbackend.ECBackend,
    CrushPlacement=placement.CrushPlacement,
    make=lambda n, prof: cluster.ECCluster(n, dict(prof, device="cpu")))
JAX = types.SimpleNamespace(
    name="jax", cls=j_cls, Encoder=JEncoder, Decoder=JDecoder,
    PerfCounters=JPerfCounters, ECBackend=j_ecbackend.ECBackend,
    CrushPlacement=j_placement.CrushPlacement,
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


def _both(scenario):
    """Run ``scenario(P, log)`` (an async function of one package) in
    each package; return each package's log and final stores."""
    out = {}
    for P in BOTH:
        P.PerfCounters.reset_all()
        log = []

        async def main(P=P, log=log):
            c = P.make(6, PROFILE)
            try:
                await scenario(P, c, log)
                return cluster_bench.store_snapshot(c)
            finally:
                await c.shutdown()

        out[P.name] = (log, _run(main()))
    return out


def _same(out):
    (log, snap), (want_log, want_snap) = out["port"], out["jax"]
    assert log == want_log
    assert snap == want_snap
    return log


def _enc(P, v) -> bytes:
    return P.Encoder().value(v).bytes()


def _dec(P, b):
    return P.Decoder(b).value() if b else None


# -- replicated omap plane -------------------------------------------------


def test_omap_set_get_rm_roundtrip():
    async def scenario(P, c, log):
        b = c.backend
        await b.omap_set("obj", {"a": b"1", "b": b"2"})
        log.append(await b.omap_get("obj"))
        log.append(await b.omap_get("obj", ["b"]))
        await b.omap_rm("obj", ["a"])
        log.append(await b.omap_get("obj"))
        await b.omap_clear("obj")
        log.append(await b.omap_get("obj"))

    log = _same(_both(scenario))
    assert log == [{"a": b"1", "b": b"2"}, {"b": b"2"}, {"b": b"2"}, {}]


def test_omap_survives_primary_shard_osd_loss():
    """Metadata is replicated to every up shard: losing the CAS
    authority OSD loses no omap, in either package."""
    async def scenario(P, c, log):
        b = c.backend
        await b.omap_set("obj", {"k": b"v"})
        acting = b.acting_set("obj")
        c.kill_osd(acting[0])
        log.append(await b.omap_get("obj"))
        await b.omap_set("obj", {"k2": b"v2"})
        log.append(await b.omap_get("obj"))

    log = _same(_both(scenario))
    assert log[0] == {"k": b"v"} and log[1]["k2"] == b"v2"


def test_omap_cas_contention_single_winner():
    async def scenario(P, c, log):
        b = c.backend
        results = await asyncio.gather(*[
            b.omap_cas("obj", "owner", None, f"client-{i}".encode())
            for i in range(8)
        ])
        log.append([ok for ok, _ in results])
        log.append((await b.omap_get("obj", ["owner"]))["owner"])

    log = _same(_both(scenario))
    assert sum(log[0]) == 1
    assert log[1] == f"client-{log[0].index(True)}".encode()


# -- cls classes -----------------------------------------------------------


@pytest.mark.parametrize("where", ["client", "primary"])
def test_cls_lock_exclusive_and_unlock(where):
    async def scenario(P, c, log):
        b = c.backend if where == "client" else c.primary_backend("obj")
        for method, req in (
            ("lock", {"name": "rbd_lock", "locker": "me",
                      "type": "exclusive"}),
            ("lock", {"name": "rbd_lock", "locker": "other",
                      "type": "exclusive"}),
            ("get_info", {"name": "rbd_lock"}),
            ("unlock", {"name": "rbd_lock", "locker": "me"}),
            ("unlock", {"name": "rbd_lock", "locker": "me"}),
            ("lock", {"name": "rbd_lock", "locker": "other",
                      "type": "exclusive"}),
            ("break_lock", {"name": "rbd_lock"}),
            ("get_info", {"name": "rbd_lock"}),
        ):
            log.append(await b.exec("obj", "lock", method, _enc(P, req)))

    log = _same(_both(scenario))
    assert [rc for rc, _ in log] == [0, -16, 0, 0, -2, 0, 0, 0]
    assert _dec(PORT, log[2][1])["lockers"] == ["me"]
    assert _dec(PORT, log[7][1]) == {"lockers": [], "type": None}


def test_cls_lock_shared():
    async def scenario(P, c, log):
        b = c.backend
        for who in ("r1", "r2", "r1"):
            log.append(await b.exec("obj", "lock", "lock", _enc(
                P, {"name": "l", "locker": who, "type": "shared"})))
        log.append(await b.exec("obj", "lock", "lock", _enc(
            P, {"name": "l", "locker": "w", "type": "exclusive"})))
        log.append(await b.exec("obj", "lock", "get_info",
                                _enc(P, {"name": "l"})))

    log = _same(_both(scenario))
    assert [rc for rc, _ in log] == [0, 0, 0, -16, 0]
    assert sorted(_dec(PORT, log[-1][1])["lockers"]) == ["r1", "r2"]


def test_cls_version_inc_and_check():
    async def scenario(P, c, log):
        b = c.backend
        log.append(await b.exec("obj", "version", "inc"))
        log.append(await b.exec("obj", "version", "get"))
        log.append(await b.exec("obj", "version", "check",
                                _enc(P, {"ver": 1})))
        log.append(await b.exec("obj", "version", "check",
                                _enc(P, {"ver": 9})))
        log.append(await b.exec("obj", "version", "set",
                                _enc(P, {"ver": 41})))
        log.append(await b.exec("obj", "version", "inc"))

    log = _same(_both(scenario))
    assert [rc for rc, _ in log] == [0, 0, 0, -125, 0, 0]
    assert _dec(PORT, log[0][1]) == 1 and _dec(PORT, log[-1][1]) == 42


def test_cls_unknown_method_returns_enoexec():
    async def scenario(P, c, log):
        log.append(await c.backend.exec("obj", "nope", "nah"))
        log.append(await c.primary_backend("obj").exec("obj", "lock",
                                                       "nah"))

    assert _same(_both(scenario)) == [(-8, b""), (-8, b"")]


def test_cls_registries_list_the_same_methods():
    assert cls.list_methods() == j_cls.list_methods()
    assert len([m for m in cls.list_methods() if m[0] == "rbd"]) == 16


def test_cls_rbd_header_lifecycle():
    """Every one of the 16 header methods, in the order librbd calls
    them for create, snapshot, protect, clone and teardown."""
    async def scenario(P, c, log):
        b = c.backend
        hdr = "rbd_header.img"

        async def call(method, req=None):
            rc, out = await b.exec(hdr, "rbd", method,
                                   b"" if req is None else _enc(P, req))
            log.append((method, rc, out))

        await call("get_metadata")
        await call("create", {"size": 1 << 26, "order": 20,
                              "features": ["layering"]})
        await call("create", {"size": 1})
        await call("get_metadata")
        await call("set_size", {"size": 1 << 27})
        await call("snap_add", {"name": "s1"})
        await call("snap_add", {"name": "s1"})
        await call("snap_add", {"name": "s2"})
        await call("snap_protect", {"name": "s1"})
        await call("add_child", {"snap_id": 1, "child": "clone1"})
        await call("add_child", {"snap_id": 1, "child": "clone0"})
        await call("get_children", {"snap_id": 1})
        await call("snap_unprotect", {"name": "s1"})
        await call("remove_child", {"snap_id": 1, "child": "clone1"})
        await call("remove_child", {"snap_id": 1, "child": "clone0"})
        await call("snap_unprotect", {"name": "s1"})
        await call("set_features", {"enable": ["journaling"],
                                    "disable": ["layering"]})
        await call("metadata_set", {"conf_rbd_cache": b"false"})
        await call("metadata_get", {"key": "conf_rbd_cache"})
        await call("metadata_get", {"key": "absent"})
        await call("get_parent")
        await call("set_parent", {"image": "parent", "snap_id": 3,
                                  "snap_name": "base", "overlap": 4096})
        await call("get_parent")
        await call("remove_parent")
        await call("get_parent")
        await call("snap_remove", {"name": "s1"})
        await call("snap_remove", {"name": "s1"})
        await call("get_metadata")

    log = _same(_both(scenario))
    rcs = [rc for _, rc, _ in log]
    assert rcs == [-2, 0, -17, 0, 0, 0, -17, 0, 0, 0, 0, 0, -16, 0, 0, 0,
                   0, 0, 0, -2, -2, 0, 0, 0, -2, 0, -2, 0]
    md = _dec(PORT, log[-1][2])
    assert md["size"] == 1 << 27 and md["order"] == 20
    assert md["snap_seq"] == 2 and list(md["snaps"]) == ["s2"]
    assert md["features"] == ["journaling"]
    assert _dec(PORT, log[11][2]) == ["clone0", "clone1"]


def test_cls_create_race_single_winner():
    """Racing ``rbd create``s get exactly one winner (the create is a
    CAS from absent), and racing ``version inc``s count every one."""
    async def scenario(P, c, log):
        b = c.backend
        rcs = await asyncio.gather(*[
            b.exec("rbd_header.r", "rbd", "create",
                   _enc(P, {"size": 4096 * (i + 1)})) for i in range(6)])
        log.append([rc for rc, _ in rcs])
        outs = await asyncio.gather(*[
            b.exec("ver", "version", "inc") for _ in range(5)])
        log.append(sorted(_dec(P, out) for _, out in outs))

    log = _same(_both(scenario))
    assert log[0].count(0) == 1 and log[0].count(-17) == 5
    assert log[1] == [1, 2, 3, 4, 5]


def _register_rewrite(P):
    """A class method that moves the object's bytes through the codec:
    ``read`` the object, ``write_full`` its bytes reversed, ``stat`` it
    (the same method in each package's registry)."""
    async def rewrite(ctx, inp):
        data = await ctx.read()
        await ctx.write_full(bytes(reversed(data)) + inp)
        return 0, P.Encoder().value(await ctx.stat()).bytes()

    P.cls.register("torch_test", "rewrite")(rewrite)


def test_cls_method_moves_object_bytes_through_the_codec():
    payload = np.random.RandomState(5).randint(
        0, 256, 50_000, dtype=np.uint8).tobytes()

    async def scenario(P, c, log):
        _register_rewrite(P)
        await c.write("big", payload)
        log.append(await c.backend.exec("big", "torch_test", "rewrite",
                                        b"tail"))
        log.append(await c.read("big"))
        c.kill_osd(c.backend.acting_set("big")[0])
        log.append(await c.backend.exec("big", "torch_test", "rewrite"))
        log.append(await c.read("big"))

    log = _same(_both(scenario))
    assert log[1] == bytes(reversed(payload)) + b"tail"
    assert _dec(PORT, log[0][1]) == len(payload) + 4
    assert log[3] == b"liat" + payload


# -- watch / notify --------------------------------------------------------


def test_watch_notify_ack_roundtrip():
    async def scenario(P, c, log):
        got, got2 = [], []
        await c.backend.watch("obj", lambda oid, p: got.append((oid, p)))
        b2 = P.ECBackend(c.ec, c.osds, c.messenger, name="client2",
                         placement=P.CrushPlacement(
                             6, c.ec.get_chunk_count()))
        await b2.watch("obj", lambda oid, p: got2.append((oid, p)))
        res = await c.backend.notify("obj", {"event": "resized"})
        log.append((sorted(res["acks"]), res["timeouts"]))
        await c.backend.unwatch("obj")
        res = await b2.notify("obj")
        log.append((res["acks"], res["timeouts"]))
        log.append((got, got2))

    log = _same(_both(scenario))
    assert log[0] == (["client", "client2"], [])
    assert log[1] == (["client2"], [])
    assert log[2] == ([("obj", {"event": "resized"})],
                      [("obj", {"event": "resized"}), ("obj", None)])


def test_notify_timeout_on_dead_watcher():
    async def scenario(P, c, log):
        b2 = P.ECBackend(c.ec, c.osds, c.messenger, name="client2",
                         placement=P.CrushPlacement(
                             6, c.ec.get_chunk_count()))
        await b2.watch("obj", lambda oid, p: None)
        c.messenger.mark_down("client2")
        res = await c.backend.notify("obj", timeout=0.3)
        log.append((res["acks"], res["timeouts"]))

    assert _same(_both(scenario)) == [([], ["client2"])]
