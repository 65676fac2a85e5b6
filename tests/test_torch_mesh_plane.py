"""The port's mesh data plane (``parallel/mesh_plane.py``,
``osd_mesh_data_plane``) against the JAX package's, on the CPU.

Counterparts of ``tests/test_mesh_plane.py`` (all but its two tests of
``msg.wire`` / ``msg.tcp``, which the port does not have yet).  The JAX
plane spans the conftest's 8 virtual CPU devices; the port's plane
``parallel.configure_devices([cpu] * 8)``.  Both are configured to the
same slot count, 1, 2, 4 or 8, and fed the same bytes made with numpy
from a seed.  Compared byte for byte: chunk maps of both dispatch lanes,
``decode_maps``, the scatter parity, ``decode_concat_many``, the
counters, ``status()``, the board's bounds and crc, the tier's per-slice
keying, and the stored shards of plane-on clusters (with the plane off,
and the JAX package's with its plane on).
"""

import asyncio
import os
import random

import jax
import numpy as np
import pytest
import torch

from ceph_tpu.osd import cluster as j_cluster
from ceph_tpu.osd import ecutil as j_ecutil
from ceph_tpu.osd import types as j_types
from ceph_tpu.parallel import mesh_plane as j_mesh_plane
from ceph_tpu.plugins import registry as j_registry
from ceph_tpu.tier.device_tier import DeviceTierStore as JDeviceTierStore
from ceph_tpu.utils.config import get_config as j_get_config
from ceph_tpu_torch import parallel
from ceph_tpu_torch.analysis import residency
from ceph_tpu_torch.msg.fault import FaultInjector
from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.osd.cluster import ECCluster
from ceph_tpu_torch.parallel import mesh_plane
from ceph_tpu_torch.plugins import registry as registry_mod
from ceph_tpu_torch.tier.device_tier import DeviceTierStore
from ceph_tpu_torch.utils.config import get_config
from ceph_tpu_torch.utils.encoding import Decoder, Encoder
from ceph_tpu_torch.utils.perf import PerfCounters
from torch_verify import port_verifiers


@pytest.fixture(autouse=True, scope="module")
def cpu_slots():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    parallel.configure_devices([torch.device("cpu")] * 8)
    yield
    parallel.configure_devices(None)
    mesh_plane.reset()
    j_mesh_plane.reset()


@pytest.fixture(autouse=True)
def _loop_policy():
    """Both packages' loops run under the port's verifiers
    (``tests/torch_verify.py``): its atomic-section verifier, which holds
    both packages' sections, and its residency verifier."""
    with port_verifiers():
        yield


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _factory(plugin, k, m):
    prof = {"technique": "reed_sol_van", "k": str(k), "m": str(m)}
    if plugin == "tpu":
        return j_registry.instance().factory("tpu", prof, "")
    if plugin == "cuda":
        prof["device"] = "cpu"
    return registry_mod.instance().factory(plugin, prof)


def _planes(n):
    return mesh_plane.configure(n), j_mesh_plane.configure(n)


@pytest.fixture
def plane_on():
    """Gate both packages' mesh planes on for one test, restoring the
    default-off state (and dropping plane/board state) afterwards."""
    cfgs = (get_config(), j_get_config())
    prior = [bool(c.get_val("osd_mesh_data_plane")) for c in cfgs]
    for c in cfgs:
        c.set_val("osd_mesh_data_plane", True)
    try:
        yield cfgs[0]
    finally:
        for c, p in zip(cfgs, prior):
            c.set_val("osd_mesh_data_plane", p)
        mesh_plane.reset()
        j_mesh_plane.reset()


@pytest.fixture
def scatter():
    """Set ``osd_mesh_scatter`` in both packages for one test."""
    cfgs = (get_config(), j_get_config())
    prior = [c.get_val("osd_mesh_scatter") for c in cfgs]

    def set_mode(mode):
        for c in cfgs:
            c.set_val("osd_mesh_scatter", mode)

    try:
        yield set_mode
    finally:
        for c, p in zip(cfgs, prior):
            c.set_val("osd_mesh_scatter", p)


def _same_maps(a, b, what):
    assert sorted(a) == sorted(b), what
    for c in a:
        assert np.array_equal(a[c], b[c]), (what, c)


# -- bit-exactness across mesh shapes x k/m x widths ------------------------


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
@pytest.mark.parametrize("km", [(2, 2), (4, 2), (8, 4)])
def test_plane_encode_decode_bit_exact(n_devices, km):
    k, m = km
    plane, jplane = _planes(n_devices)
    mine, theirs = _factory("cuda", k, m), _factory("tpu", k, m)
    cpu = _factory("jerasure", k, m)
    rng = np.random.RandomState(5)
    # a pow2 sub-rung, an off-rung width (pad+trim inside the plane), and
    # one just past the 16 KiB rung boundary
    widths = (4096, 14976, 16448)
    blocks = [rng.randint(0, 256, size=(k, bs), dtype=np.uint8)
              for bs in widths]
    pgids = [3, 11, 40]
    encs = plane.encode_shard_major_many(mine, blocks, pgids)
    jencs = jplane.encode_shard_major_many(theirs, blocks, pgids)
    for b, enc, jenc in zip(blocks, encs, jencs):
        ref = cpu.encode(set(range(k + m)), b.reshape(-1))
        _same_maps(enc, ref, (n_devices, km))
        _same_maps(enc, jenc, (n_devices, km))
    # primary-slot lane: the whole batch on one slot, same bytes
    slot = min(1, n_devices - 1)
    encs_slot = plane.encode_shard_major_many(mine, blocks, pgids, slot=slot)
    jplane.encode_shard_major_many(theirs, blocks, pgids, slot=slot)
    for a, b in zip(encs, encs_slot):
        _same_maps(a, b, "slot lane")
    # a full batch over every slot rides the fused lane
    many = [rng.randint(0, 256, size=(k, 8192), dtype=np.uint8)
            for _ in range(2 * n_devices)]
    got = plane.encode_shard_major_many(mine, many)
    jgot = jplane.encode_shard_major_many(theirs, many)
    for a, b in zip(got, jgot):
        _same_maps(a, b, "fused lane")
    # degraded decode: drop one data + one parity chunk per map
    maps = [{c: a for c, a in enc.items() if c not in (0, k)}
            for enc in encs]
    full = plane.decode_maps(mine, maps)
    jfull = jplane.decode_maps(theirs, maps)
    for enc, out, jout in zip(encs, full, jfull):
        _same_maps(out, enc, "decode")
        _same_maps(out, jout, "decode")
    assert plane.counters == jplane.counters
    assert plane.counters["mesh_fused_dispatches"] > 0
    st, jst = plane.status(), jplane.status()
    for key in ("n_devices", "n_pg", "n_shard", "members", "board",
                "counters"):
        assert st[key] == jst[key], key
    mesh_plane.reset()
    j_mesh_plane.reset()


@pytest.mark.parametrize("n_devices,km", [
    (8, (4, 4)), (4, (8, 4)), (2, (4, 2)), (4, (8, 2)), (8, (4, 2))])
def test_plane_scatter_parity_bit_exact(n_devices, km, scatter):
    """The in-collective parity path (a reduce-scatter over the shard
    axis) gives the same bytes as the slot-local lane, the oracle and the
    JAX package's psum_scatter; where k or m does not divide the shard
    axis, both packages keep the slot-local lane."""
    k, m = km
    plane, jplane = _planes(n_devices)
    mine, theirs = _factory("cuda", k, m), _factory("tpu", k, m)
    cpu = _factory("jerasure", k, m)
    rng = np.random.RandomState(6)
    blocks = [rng.randint(0, 256, size=(k, 8192), dtype=np.uint8)
              for _ in range(4)]
    scatter("on")
    encs = plane.encode_shard_major_many(mine, blocks, [0, 1, 2, 3])
    jencs = jplane.encode_shard_major_many(theirs, blocks, [0, 1, 2, 3])
    for b, enc, jenc in zip(blocks, encs, jencs):
        _same_maps(enc, cpu.encode(set(range(k + m)), b.reshape(-1)), "ref")
        _same_maps(enc, jenc, "jax")
    codec, jcodec = plane._codec(mine), jplane._codec(theirs)
    ns = plane.n_shard
    assert ns == jplane.n_shard
    if k % ns or m % ns:
        assert codec.scatter_codec() is None
        assert jcodec.scatter_codec() is None
    else:
        owners = codec.scatter_codec().parity_owner_slots()
        assert list(owners) == list(jcodec.scatter_codec()
                                    .parity_owner_slots())
        assert len(owners) == m and sorted(set(owners)) == list(range(ns))
    assert plane.counters == jplane.counters
    scatter("off")
    again = plane.encode_shard_major_many(mine, blocks, [0, 1, 2, 3])
    for a, b in zip(encs, again):
        _same_maps(a, b, "slot-local lane")
    mesh_plane.reset()
    j_mesh_plane.reset()


def test_scatter_auto_is_on_for_cuda_slots_only(scatter):
    scatter("auto")
    plane = mesh_plane.configure(4)
    assert plane._scatter_on() is False  # CPU slots
    scatter("on")
    assert plane._scatter_on() is True
    mesh_plane.reset()


def test_plane_decode_concat_matches_single_device():
    """decode_concat_many through the plane reassembles the same logical
    bytes as the single-device ecutil path and the JAX package's plane."""
    plane, jplane = _planes(4)
    k, m = 4, 2
    mine, theirs = _factory("cuda", k, m), _factory("tpu", k, m)
    sinfo = ecutil.StripeInfo(k, k * mine.get_chunk_size(1))
    jsinfo = j_ecutil.StripeInfo(k, k * theirs.get_chunk_size(1))
    rng = np.random.RandomState(9)
    payloads = [rng.randint(0, 256, size=sinfo.stripe_width * 4,
                            dtype=np.uint8) for _ in range(3)]
    maps = []
    for p in payloads:
        enc = ecutil.encode(sinfo, mine, p, range(k + m))
        maps.append({c: a for c, a in enc.items() if c != 1})
    got = plane.decode_concat_many(sinfo, mine, maps)
    assert got == ecutil.decode_concat_many(sinfo, mine, maps)
    assert got == jplane.decode_concat_many(jsinfo, theirs, maps)
    assert got == [p.tobytes() for p in payloads]
    mesh_plane.reset()
    j_mesh_plane.reset()


# -- cluster integration ----------------------------------------------------


async def _cluster_cycle(make, n_objects=5, k=4, m=2, seed=31,
                         kill_one=False):
    c = make(k + m, {"technique": "reed_sol_van", "k": str(k),
                     "m": str(m)})
    rng = random.Random(seed)
    payloads = {
        f"mo{i}": bytes(rng.getrandbits(8) for _ in range(9000 + 211 * i))
        for i in range(n_objects)
    }
    for oid, p in payloads.items():
        await c.write(oid, p)
    if kill_one:
        victim = c.backend.acting_set("mo0")[0]
        c.kill_osd(victim)
    got = {oid: await c.read(oid) for oid in payloads}
    shards = {}
    for osd in c.osds:
        for soid in osd.store.list_objects():
            if soid.rpartition("@")[2] != "meta":
                shards[(osd.osd_id, soid)] = osd.store.read(soid)
    await c.shutdown()
    assert got == payloads
    return shards


def _port(n, prof):
    return ECCluster(n, dict(prof, device="cpu"), plugin="cuda")


def _jax_cluster(n, prof):
    return j_cluster.ECCluster(n, dict(prof), plugin="tpu")


def test_cluster_mesh_vs_off_identical_shards(plane_on):
    """The gated plane is invisible in the stored bytes: the same writes
    produce byte-identical shard stores with the plane on, off, and
    degraded (a lost in-mesh shard decodes through the plane), and equal
    to the JAX package's with its plane on."""
    plane, jplane = _planes(8)
    with_plane = run(_cluster_cycle(_port))
    assert plane.counters["mesh_wire_bytes_avoided"] > 0
    assert plane.counters["mesh_encode_stripes"] > 0
    assert plane.board.stats()["misses"] == 0
    assert run(_cluster_cycle(_jax_cluster)) == with_plane
    assert plane.counters == jplane.counters
    assert plane.board.stats() == jplane.board.stats()
    assert plane.status()["members"] == jplane.status()["members"]
    decode_before = plane.counters["mesh_decode_stripes"]
    degraded = run(_cluster_cycle(_port, kill_one=True))
    assert plane.counters["mesh_decode_stripes"] > decode_before, \
        "degraded reads must reconstruct through the plane"
    plane_on.set_val("osd_mesh_data_plane", False)
    mesh_plane.reset()
    without = run(_cluster_cycle(_port))
    assert with_plane == without
    for key, data in degraded.items():
        assert without.get(key) == data


def test_gate_off_fallback():
    """osd_mesh_data_plane=false (the default): no plane exists, the
    backend routes single-device, and nothing binds."""
    assert bool(get_config().get_val("osd_mesh_data_plane")) is False
    assert mesh_plane.current_plane() is None
    shards = run(_cluster_cycle(_port, n_objects=2))
    assert shards == run(_cluster_cycle(_jax_cluster, n_objects=2))


def test_gate_on_without_a_device_list_raises(plane_on):
    """No quiet fallback: with the gate on, a plane that has no devices
    (no CUDA, no list) raises instead of running single-device."""
    parallel.configure_devices(None)
    mesh_plane.reset()
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                mesh_plane.current_plane()
    finally:
        parallel.configure_devices([torch.device("cpu")] * 8)
    assert mesh_plane.current_plane().n_devices == 8


def test_kill_mesh_resident_osd_mid_burst_exactly_once(plane_on):
    """Thrash gate: primaries whose shards are MESH-RESIDENT are killed
    in the apply/reply window with non-idempotent omap_cas traffic in
    flight; the exactly-once accounting must hold (counter advances
    exactly once per acked success, replays answered from the PG-log
    dups) -- mesh delivery must not weaken any of it."""
    async def main():
        PerfCounters.reset_all()
        plane = mesh_plane.configure(8)
        fault = FaultInjector(seed=17)
        cluster = ECCluster(
            6, {"k": "4", "m": "2", "technique": "reed_sol_van",
                "device": "cpu"}, plugin="cuda", fault=fault)
        cfg = get_config()
        cfg.apply_changes({"client_probe_grace": 0.1})
        try:
            rng = random.Random(29)
            down = []
            cas_ok = 0
            kills_armed = 0
            await cluster.backend.omap_set("cas-cnt", {})
            # burst writes so the killed OSD's shard really is
            # mesh-delivered state, not just metadata
            for i in range(4):
                await cluster.write(f"burst{i}", os.urandom(12000))
            for _round in range(24):
                if down and rng.random() < 0.5:
                    cluster.revive_osd(down.pop())
                primary = cluster.backend.primary_of("cas-cnt")
                victim = int(primary.split(".")[1])
                if not down and rng.random() < 0.4 and \
                        not cluster.messenger.is_down(primary):
                    assert plane.covers(primary), \
                        "victim must be mesh-bound for this gate"
                    fault.schedule_kill_after_apply("omap_cas")
                    kills_armed += 1
                    down.append(victim)
                cur = (await cluster.backend.omap_get(
                    "cas-cnt", ["n"])).get("n")
                nxt = Encoder().value(
                    (Decoder(cur).value() if cur else 0) + 1).bytes()
                ok, _seen = await cluster.backend.omap_cas(
                    "cas-cnt", "n", cur, nxt)
                if ok:
                    cas_ok += 1
                if down and down[-1] == victim and \
                        not cluster.messenger.is_down(primary):
                    down.pop()
            for osd in list(down):
                cluster.revive_osd(osd)
            assert kills_armed >= 3, "the kill window was never armed"
            raw = (await cluster.backend.omap_get(
                "cas-cnt", ["n"])).get("n")
            assert (Decoder(raw).value() if raw else 0) == cas_ok, \
                "double-apply or lost apply under mesh delivery"
            for i in range(4):
                assert len(await cluster.read(f"burst{i}")) == 12000
            assert plane.counters["mesh_wire_bytes_avoided"] > 0
        finally:
            cfg.apply_changes({"client_probe_grace": 1.0})
        await cluster.shutdown()

    run(main())


def test_write_ref_claim_miss_refuses_unacked(plane_on):
    """A sub-write whose board reference cannot be claimed is refused
    unacked and unapplied (counted as ``mesh_claim_miss`` by the plane and
    the shard); one whose reference resolves applies the claimed bytes
    and acks -- in both packages alike."""
    from ceph_tpu.osd import ecbackend as j_ecbackend
    from ceph_tpu_torch.osd import ecbackend

    async def drive(mod, make, types, shard_oid):
        plane = mod.configure(8)
        c = make(6, {"technique": "reed_sol_van", "k": "4", "m": "2"})
        osd = c.osds[1]
        sent = []
        orig_send = c.messenger.send_message

        async def capture(src, dst, msg):
            sent.append((src, dst, type(msg).__name__, msg.committed,
                         msg.applied))

        c.messenger.send_message = capture
        try:
            out = []
            for lose in (True, False):
                txn = types.Transaction().write(
                    shard_oid("o", 1), 0, bytes(range(256)) * 16)
                sub = types.ECSubWrite(from_shard=1, tid=7 + lose, oid="o",
                                       transaction=txn,
                                       at_version=(1 + lose, "osd.0"))
                assert plane.detach_sub_write(sub) == 4096
                if lose:
                    plane.board.claim(txn.ops[0].attr_value[0])
                await osd.handle_sub_write("osd.0", sub)
                out.append((sent.pop(), shard_oid("o", 1) in
                            osd.store.list_objects()))
            stored = osd.store.read(shard_oid("o", 1))
        finally:
            c.messenger.send_message = orig_send
        out.append((stored, plane.counters["mesh_claim_miss"],
                    osd.perf.snapshot().get("mesh_claim_miss", 0)))
        await c.shutdown()
        mod.reset()
        return out

    from ceph_tpu_torch.osd import types as t_types

    mine = run(drive(mesh_plane, _port, t_types, ecbackend.shard_oid))
    theirs = run(drive(j_mesh_plane, _jax_cluster, j_types,
                       j_ecbackend.shard_oid))
    assert mine == theirs
    (refused, applied_first), (acked, applied), (stored, misses, perf) = mine
    assert refused == ("osd.1", "osd.0", "ECSubWriteReply", False, False)
    assert not applied_first
    assert acked[3] is True and applied
    assert stored == bytes(range(256)) * 16
    assert misses == perf == 1


# -- delivery board / wire form --------------------------------------------


def _board_script(mod, types):
    board = mod.DeliveryBoard(cap_bytes=8192)
    k1, n1, c1 = board.deposit(b"a" * 4096)
    k2, _n2, _c2 = board.deposit(b"b" * 4096)
    # over the cap: the oldest unclaimed deposit drops
    k3, _n3, c3 = board.deposit(b"c" * 4096)
    log = [(k1, n1, c1), (k3, c3), board.claim(k1), board.claim(k2),
           board.claim(k2), board.claim(k3), board.stats()]
    plane = mod.configure(2)
    txn = types.Transaction().write("o@0", 0, b"x" * 4096)
    sub = types.ECSubWrite(from_shard=0, tid=1, oid="o", transaction=txn,
                           at_version=(1, "w"))
    log.append(plane.detach_sub_write(sub))
    op = txn.ops[0]
    log.append((op.op, op.data, op.attr_value))
    log.append(plane.resolve_transaction(txn))
    log.append((op.op, op.data))
    log.append(plane.resolve_transaction(txn))
    txn2 = types.Transaction().write("o@1", 0, b"y" * 4096)
    sub2 = types.ECSubWrite(from_shard=1, tid=2, oid="o", transaction=txn2,
                            at_version=(1, "w"))
    plane.detach_sub_write(sub2)
    plane.board.claim(txn2.ops[0].attr_value[0])  # steal the deposit
    log.append(plane.resolve_transaction(txn2))
    # a payload that fails its crc on claim is refused too
    txn4 = types.Transaction().write("o@3", 0, b"w" * 4096)
    sub4 = types.ECSubWrite(from_shard=3, tid=4, oid="o", transaction=txn4,
                            at_version=(1, "w"))
    plane.detach_sub_write(sub4)
    key, nbytes, crc = txn4.ops[0].attr_value
    txn4.ops[0].attr_value = (key, nbytes, crc ^ 1)
    log.append(plane.resolve_transaction(txn4))
    txn3 = types.Transaction().write("o@2", 0, b"z" * 100)
    sub3 = types.ECSubWrite(from_shard=2, tid=3, oid="o", transaction=txn3,
                            at_version=(1, "w"))
    log.append(plane.detach_sub_write(sub3))
    log.append(txn3.ops[0].op)
    log.append(plane.status()["counters"])
    log.append(plane.board.stats())
    mod.reset()
    return log


def test_board_bounds_claim_and_crc():
    from ceph_tpu_torch.osd import types as t_types

    mine = _board_script(mesh_plane, t_types)
    assert mine == _board_script(j_mesh_plane, j_types)
    assert mine[2] is None and mine[3] == b"b" * 4096 and mine[4] is None
    assert mine[6]["evictions"] == 1 and mine[6]["misses"] == 2
    assert mine[6]["pending_bytes"] == 0
    assert mine[7] == 4096 and mine[8][0] == "write_ref"
    assert mine[9] is True and mine[10] == ("write", b"x" * 4096)
    assert mine[12] is False and mine[13] is False
    assert mine[14] == 0 and mine[15] == "write"
    assert mine[16]["mesh_claim_miss"] == 2


def test_board_cap_is_read_from_config():
    cfg = get_config()
    prior = cfg.get_val("osd_mesh_board_bytes")
    cfg.set_val("osd_mesh_board_bytes", 4096)
    try:
        board = mesh_plane.DeliveryBoard()
        k1, _n, _c = board.deposit(b"a" * 4096)
        board.deposit(b"b" * 2048)
        assert board.claim(k1) is None and board.stats()["evictions"] == 1
    finally:
        cfg.set_val("osd_mesh_board_bytes", prior)


# -- steady state: cached placement objects, zero library builds ------------


def test_sharding_cache_and_zero_steady_retraces():
    plane = mesh_plane.configure(4)
    s1 = plane.sharding(("pg", "shard"), None, None)
    s2 = plane.sharding(("pg", "shard"), None, None)
    assert s1 is s2 and len(s1.devices) == 4
    assert plane.sharding(None, None, None).devices == \
        (torch.device("cpu"),)
    mine = _factory("cuda", 4, 2)
    rng = np.random.RandomState(12)
    blocks = [rng.randint(0, 256, size=(4, 8192), dtype=np.uint8)
              for _ in range(8)]
    # warm BOTH dispatch lanes (fused + primary-slot) once
    plane.encode_shard_major_many(mine, blocks, list(range(8)))
    plane.encode_shard_major_many(mine, blocks, list(range(8)), slot=2)
    builds = plane.sharding_builds
    before = residency.counters().snapshot()
    for _ in range(3):
        plane.encode_shard_major_many(mine, blocks, list(range(8)))
        plane.encode_shard_major_many(mine, blocks, list(range(8)),
                                      slot=2)
    after = residency.counters().snapshot()
    assert after["library_builds"] == before["library_builds"], \
        "steady-state mesh dispatch must build no library"
    assert plane.sharding_builds == builds, \
        "steady-state dispatch built a placement object"
    # per-mesh-axis ledger accounting moved
    assert after.get("mesh_pg_dispatches", 0) > \
        before.get("mesh_pg_dispatches", 0)
    assert after["mesh_pg_bytes"] - before.get("mesh_pg_bytes", 0) == \
        3 * 2 * (8 * 4 * 8192)
    assert after["mesh_shard_dispatches"] - \
        before.get("mesh_shard_dispatches", 0) == 3
    with pytest.raises(ValueError, match="no placement"):
        plane.sharding("pg", None, None)
    mesh_plane.reset()


def test_accounted_matrix_device_keyed_cache():
    """The coding tables are uploaded once per slot device: the same bytes
    on the same device are one entry, on another device another (the JAX
    package keys them by sharding)."""
    from ceph_tpu_torch.ops.pipeline import accounted_device_matrix

    plane = mesh_plane.configure(4)
    tab = np.arange(64, dtype=np.uint8).reshape(4, 16)
    a = accounted_device_matrix(tab, plane.devices[0])
    b = accounted_device_matrix(tab, plane.devices[1])
    c = accounted_device_matrix(tab, torch.device("meta"))
    assert a is b  # slots on one device share the upload
    assert c is not a and c.device.type == "meta"
    mesh_plane.reset()


# -- tier residency keyed by owning mesh slice ------------------------------


def test_tier_mesh_slice_keying():
    mine = DeviceTierStore(budget=1 << 20, device="cpu")
    theirs = JDeviceTierStore(budget=1 << 20)
    block = np.zeros((6, 1024), dtype=np.uint8)
    for store in (mine, theirs):
        store.put("p", "a", block, (1, "w"), 4096, mesh_slice=2)
        store.put("p", "b", block, (1, "w"), 4096, mesh_slice=2)
        store.put("p", "c", block, (1, "w"), 4096)
        store.put_many([("p", "d", block, (1, "w"), 4096)])
    st, jst = mine.status(), theirs.status()
    assert st["by_mesh_slice"] == jst["by_mesh_slice"] == {
        "2": 2 * 6 * 1024, "unsliced": 2 * 6 * 1024}
    assert [o["mesh_slice"] for o in st["objects"]] == \
        [o["mesh_slice"] for o in jst["objects"]] == [2, 2, None, None]
    ent = mine.lookup("p", "a")
    assert ent is not None and ent.mesh_slice == 2
    mine.clear()
    theirs.clear()


def test_tier_write_keys_the_owner_slot(plane_on):
    """A writeback pool's promote-on-write entry carries the slot that
    owns the object's PG (``ECBackend._tier_write_update``)."""
    plane = mesh_plane.configure(4)

    async def main():
        c = _port(6, {"technique": "reed_sol_van", "k": "4", "m": "2"})
        c.set_tier_mode("writeback")
        for _ in range(3):
            await c.write("hot", b"h" * 8192)
            await c.read("hot")
        ents = [(o.tier.lookup(c.pool, "hot") or
                 o.tier._entries.get((c.pool, "hot"))) for o in c.osds]
        ents = [e for e in ents if e is not None]
        backend = c.primary_backend("hot")
        want = plane.owner_slot(backend._pg_of("hot"))
        await c.shutdown()
        return ents, want

    ents, want = run(main())
    assert ents and all(e.mesh_slice == want for e in ents)


def test_owner_slot_and_bind_capacity():
    for mod in (mesh_plane, j_mesh_plane):
        plane = mod.configure(2)
        assert plane.bind("osd.0") == 0
        assert plane.bind("osd.1") == 1
        assert plane.bind("osd.2") is None  # past the device count
        assert plane.bind("osd.0") == 0  # idempotent
        assert plane.covers("osd.1") and not plane.covers("osd.2")
        assert plane.slot_of("osd.1") == 1 and plane.slot_of("x") is None
        assert plane.owner_slot(5) == 1
        mod.reset()
    for n, factors in ((1, (1, 1)), (2, (1, 2)), (4, (1, 4)), (6, (3, 2)),
                       (8, (2, 4))):
        plane, jplane = _planes(n)
        assert (plane.n_pg, plane.n_shard) == factors == \
            (jplane.n_pg, jplane.n_shard)
    cfg, jcfg = get_config(), j_get_config()
    prior = (cfg.get_val("osd_mesh_devices"), jcfg.get_val("osd_mesh_devices"))
    cfg.set_val("osd_mesh_devices", 3)
    jcfg.set_val("osd_mesh_devices", 3)
    try:
        assert mesh_plane.MeshDataPlane().n_devices == \
            j_mesh_plane.MeshDataPlane().n_devices == 3
        cfg.set_val("osd_mesh_devices", 64)  # clamps to the list
        assert mesh_plane.MeshDataPlane().n_devices == 8
    finally:
        cfg.set_val("osd_mesh_devices", prior[0])
        jcfg.set_val("osd_mesh_devices", prior[1])
    mesh_plane.reset()
    j_mesh_plane.reset()


# -- the mesh-path stage (the dry run's; the JAX bench needs msg.tcp) -------


def test_mesh_path_bench_smoke(plane_on):
    """The dry run's mesh stage at mesh sizes 1 and 2 in both packages:
    every gate (bit-exactness at each size, zero steady library builds
    and placement builds, wire bytes avoided, no claim miss) runs for
    real and the wire bytes avoided match the JAX package's; the stage
    restores the gate it found (the fixture set it on)."""
    from ceph_tpu_torch import entry

    import __graft_entry__ as j_entry

    avoided = {}
    for n in (1, 2):
        line = entry._mesh_plane_stage(n)
        jline = j_entry._mesh_plane_stage(n)
        avoided[n] = int(line.split("wire bytes avoided ")[1].split(",")[0])
        assert f"wire bytes avoided {avoided[n]}," in jline
        assert line.endswith("0 steady library builds")
    assert avoided[2] >= avoided[1] > 0
    assert bool(get_config().get_val("osd_mesh_data_plane")) is True
