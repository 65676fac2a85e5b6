"""The port's daemons in processes of their own (``ceph_tpu_torch/daemon/``,
``tools/vstart.py``), on the CPU.

Mirrors the JAX package's ``tests/test_standalone.py`` at its sizes: the
EC sub-op messages on the wire (the port's bytes against the JAX
package's), then real ``python -m ceph_tpu_torch.daemon.osd`` processes
on loopback ports booted by the port's ``vstart``: a round trip with
partial I/O, a degraded read after SIGKILL, a write while down then a
revive and recovery, a primary failover, a filestore cluster surviving a
restart of every daemon, the admin socket, random kills and revives
under auto recovery, and the mon-integrated boot with heartbeat
mark-down.  Every pool is the ``cuda`` plugin's codec on the CPU
(``device=cpu``); children run with ``OMP_NUM_THREADS=1`` and give up on
a dead peer's sub-ops after 6 s (``DAEMON_ENV``).
"""

import asyncio
import os
import random
import shutil
import signal
import tempfile
import time

import pytest

from ceph_tpu.msg import wire as j_wire
from ceph_tpu.osd import types as j_types
from ceph_tpu_torch.daemon.client import RemoteClient
from ceph_tpu_torch.msg.wire import decode_message, encode_message
from ceph_tpu_torch.osd.types import (ECSubRead, ECSubReadReply, ECSubWrite,
                                      ECSubWriteReply, LogEntry, Transaction)
from ceph_tpu_torch.tools import vstart
from ceph_tpu_torch.utils.admin_socket import admin_command
from torch_process_lock import one_cluster_at_a_time
from torch_verify import port_verifiers

PROFILE = {"k": "2", "m": "1", "device": "cpu"}


#: the daemons' settings for these tests (their environment layer):
#: sub-op gathers and commits give up on a dead peer after 6 s (the
#: scenario runner's chaos time scale, ``loadgen.ScenarioRunner.TUNING``,
#: is 3 s; 6 s leaves a live peer time on a loaded host), not the 15 s
#: defaults a kill would otherwise cost every degraded op
DAEMON_ENV = {"OMP_NUM_THREADS": "1",
              "CEPH_TPU_TORCH_OSD_READ_GATHER_TIMEOUT": "6.0",
              "CEPH_TPU_TORCH_OSD_CLIENT_OP_COMMIT_TIMEOUT": "6.0"}


@pytest.fixture(autouse=True)
def _loop_policy(monkeypatch):
    """Children get ``DAEMON_ENV`` (this process keeps its own settings:
    its config exists before the environment changes); both packages' loops run under the port's verifiers
    (``tests/torch_verify.py``)."""
    from ceph_tpu_torch.utils.config import get_config

    get_config()
    for key, val in DAEMON_ENV.items():
        monkeypatch.setenv(key, val)
    with port_verifiers():
        yield

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread in this worker while the test runs (the CPU
    codec's products are small; the tier-1 run's other workers share the
    host's cores), restored afterwards."""
    import torch

    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)



def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


@pytest.fixture
def run_dir():
    """A short run directory (an admin socket's path must fit in 107
    bytes), removed afterwards; the test holds the process-cluster lock
    (``torch_process_lock``) meanwhile."""
    path = tempfile.mkdtemp(prefix="ct-sa-")
    with one_cluster_at_a_time():
        yield path
    shutil.rmtree(path, ignore_errors=True)


# -- wire codec ------------------------------------------------------------


def _sub_write(T):
    txn = (
        T.Transaction()
        .write("o@1", 0, b"chunkdata")
        .truncate("o@1", 9)
        .setattr("o@1", "hinfo_key", {"total_chunk_size": 9,
                                      "cumulative_shard_hashes": [1, 2]})
    )
    return T.ECSubWrite(
        from_shard=1, tid=42, oid="o", transaction=txn, at_version=7,
        log_entries=[T.LogEntry(version=7, oid="o@1", op="append",
                                prior_size=0)],
        op_class="recovery",
    )


def _sub_msgs(T):
    return [
        T.ECSubRead(from_shard=0, tid=1, to_read={"o": [(0, -1), (128, 64)]},
                    attrs_to_read=["o"], op_class="scrub"),
        T.ECSubReadReply(from_shard=0, tid=1,
                         buffers_read={"o": [(0, b"bytes")]},
                         attrs_read={"o": {"_size": 11}},
                         errors={"bad": -5}),
        T.ECSubWriteReply(from_shard=3, tid=9, committed=True,
                          applied=False),
        "ping",
        ("pong", "osd.3"),
        {"cmd": "status", "epoch": 12},
    ]


class _PortTypes:
    Transaction, ECSubWrite, LogEntry = Transaction, ECSubWrite, LogEntry
    ECSubRead, ECSubReadReply = ECSubRead, ECSubReadReply
    ECSubWriteReply = ECSubWriteReply


def test_wire_roundtrip_sub_write():
    msg = _sub_write(_PortTypes)
    out = decode_message(encode_message(msg))
    assert out == msg
    assert encode_message(msg) == j_wire.encode_message(_sub_write(j_types))


def test_wire_roundtrip_sub_read_and_replies():
    for msg, jmsg in zip(_sub_msgs(_PortTypes), _sub_msgs(j_types)):
        assert decode_message(encode_message(msg)) == msg
        assert encode_message(msg) == j_wire.encode_message(jmsg)


# -- real processes --------------------------------------------------------


@pytest.fixture
def cluster(run_dir):
    vstart.start_cluster(run_dir, 4, PROFILE, objectstore="memstore",
                         wait=60.0, n_mgrs=0)
    yield run_dir
    vstart.stop_cluster(run_dir)


def _connect(run_dir):
    return RemoteClient.connect(
        os.path.join(run_dir, "addr_map.json"), PROFILE
    )


def test_process_cluster_write_read(cluster):
    async def go():
        c = await _connect(cluster)
        payload = bytes(range(256)) * 40
        await c.write("obj", payload)
        assert await c.read("obj") == payload
        # partial I/O over the wire too
        await c.write_range("obj", 100, b"X" * 50)
        got = await c.read_range("obj", 90, 70)
        exp = bytearray(payload[90:160])
        exp[10:60] = b"X" * 50
        assert got == bytes(exp)
        await c.close()

    run(go())


def test_process_cluster_degraded_read_after_sigkill(cluster):
    async def go():
        c = await _connect(cluster)
        payload = b"degraded-path" * 300
        await c.write("obj", payload)
        victim = c.backend.acting_set("obj")[0]
        assert vstart.kill_osd(cluster, victim, sig=signal.SIGKILL)
        await c.probe_osds()  # heartbeat: discover the death
        assert c.messenger.is_down(f"osd.{victim}")
        assert await c.read("obj") == payload  # reconstruct
        await c.close()

    run(go())


def test_process_cluster_write_while_down_then_revive(cluster):
    async def go():
        c = await _connect(cluster)
        acting = c.backend.acting_set("obj2")
        victim = acting[1]
        vstart.kill_osd(cluster, victim)
        await c.probe_osds()
        payload = b"written-degraded" * 100
        await c.write("obj2", payload)  # k shards up -> accepted
        assert await c.read("obj2") == payload
        # revive: a fresh process takes over the same identity/port
        vstart.revive_osd(cluster, victim)
        await c.probe_osds()
        assert not c.messenger.is_down(f"osd.{victim}")
        await c.backend.recover_shard("obj2", acting.index(victim), victim)
        assert await c.read("obj2") == payload
        await c.close()

    run(go())


def test_process_cluster_primary_failover(cluster):
    """Kill the PRIMARY OSD without telling the client: the next op
    discovers the death mid-op and fails over; a revived old primary
    relearns the version sequence from shard attrs."""

    async def go():
        c = await _connect(cluster)
        await c.write("fo-obj", b"before-failover" * 200)
        primary = c.backend.primary_of("fo-obj")
        victim = int(primary.split(".")[1])
        assert vstart.kill_osd(cluster, victim, sig=signal.SIGKILL)
        payload2 = b"after-failover" * 220
        await c.write("fo-obj", payload2)
        assert c.backend.primary_of("fo-obj") != primary
        assert await c.read("fo-obj") == payload2
        vstart.revive_osd(cluster, victim)
        await c.probe_osds()
        payload3 = b"after-revival" * 240
        await c.write("fo-obj", payload3)
        assert c.backend.primary_of("fo-obj") == primary
        assert await c.read("fo-obj") == payload3
        await c.close()

    run(go())


def test_process_cluster_persistent_store_survives_restart(run_dir):
    vstart.start_cluster(run_dir, 4, PROFILE, objectstore="filestore",
                         wait=60.0, n_mgrs=0)
    try:
        async def phase1():
            c = await _connect(run_dir)
            await c.write("durable", b"survives-process-death" * 50)
            await c.close()

        run(phase1())
        # hard-restart every OSD process
        for i in range(4):
            vstart.kill_osd(run_dir, i)
        for i in range(4):
            vstart.revive_osd(run_dir, i)

        async def phase2():
            c = await _connect(run_dir)
            await c.probe_osds()
            assert await c.read("durable") == \
                b"survives-process-death" * 50
            await c.close()

        run(phase2())
    finally:
        vstart.stop_cluster(run_dir)


def test_admin_socket_perf_config_ops(cluster):
    path = os.path.join(cluster, "data", "osd.0.asok")
    deadline = time.time() + 10
    while not os.path.exists(path):
        assert time.time() < deadline, "admin socket never appeared"
        time.sleep(0.05)

    async def go():
        helps = await admin_command(path, "help")
        assert {"perf dump", "config show", "residency status",
                "profile status", "profile reset", "cpu_profiler"} \
            <= set(helps)
        assert isinstance(await admin_command(path, "perf dump"), dict)
        cfg = await admin_command(path, "config show")
        assert "osd_tick_interval" in cfg and cfg["gc_freeze_on_start"]
        st = await admin_command(path, "status")
        assert st["name"] == "osd.0" and st["pools"] == ["ecpool"]
        assert "num_ops" in await admin_command(path, "ops")
        res = await admin_command(path, "residency status")
        assert set(res["counters"]) >= {"h2d_ops", "d2h_ops",
                                        "library_builds"}
        prof = await admin_command(path, "profile status")
        assert prof["name"] == "osd.0" and prof["mode"] == "off"
        assert (await admin_command(path, "profile reset"))["reset"]
        bad = await admin_command(path, "no such thing")
        assert "error" in bad

    run(go())


def test_process_cluster_thrash_with_auto_recovery(run_dir):
    """Random SIGKILL/revive of OSD processes while a client keeps
    writing, each daemon's background peering+recovery tick live: every
    object readable and current at the end, no manual recovery."""
    rng = random.Random(0xCE9B)
    vstart.start_cluster(run_dir, 5, PROFILE, objectstore="filestore",
                         wait=60.0, n_mgrs=0)

    async def go():
        c = await _connect(run_dir)
        expected = {}
        down = set()
        try:
            for _round in range(6):
                for _ in range(4):
                    oid = f"thrash-{rng.randrange(8)}"
                    payload = bytes([rng.randrange(256)]) * \
                        rng.randrange(2000, 60000)
                    for _attempt in range(10):
                        try:
                            await c.write(oid, payload)
                            break
                        except IOError:
                            await asyncio.sleep(1.0)
                            await c.probe_osds()
                    else:
                        raise AssertionError(f"write {oid} never landed")
                    expected[oid] = payload
                # at most ONE osd down at a time (k=2 m=1)
                if not down and rng.random() < 0.8:
                    victim = rng.randrange(5)
                    vstart.kill_osd(run_dir, victim, sig=signal.SIGKILL)
                    down.add(victim)
                elif down and rng.random() < 0.7:
                    vstart.revive_osd(run_dir, down.pop())
                    await asyncio.sleep(1.0)
                    await c.probe_osds()
            for osd in sorted(down):
                vstart.revive_osd(run_dir, osd)
            down.clear()
            await asyncio.sleep(1.0)
            await c.probe_osds()
            deadline = time.time() + 45
            while True:
                try:
                    for oid, payload in expected.items():
                        assert await c.read(oid) == payload
                    break
                except (IOError, AssertionError):
                    if time.time() > deadline:
                        raise
                    await asyncio.sleep(2.0)
            assert expected
        finally:
            await c.close()

    try:
        run(go())
    finally:
        vstart.stop_cluster(run_dir)


def test_mon_integrated_boot_heartbeat_markdown(run_dir):
    """OSD daemons boot INTO the mon quorum, the pool flows mon ->
    daemons, SIGKILLing an OSD is detected by PEER HEARTBEATS whose
    failure reports make the mon mark it down, and a revived daemon's
    ``osd boot`` marks it up again."""
    from ceph_tpu_torch.mon.monitor import MonClient
    from ceph_tpu_torch.msg.tcp import TCPMessenger
    from ceph_tpu_torch.utils import aio

    vstart.start_cluster(run_dir, 5, PROFILE, objectstore="memstore",
                         wait=60.0, n_mons=3, n_mgrs=0)

    async def mon_client(addr_map):
        ms = TCPMessenger("client", addr_map)
        await ms.start()
        monc = MonClient(ms, 3, "client")

        async def dispatch(src, msg):
            if isinstance(msg, dict):
                await monc.handle_reply(msg)

        ms.register("client", dispatch)
        return ms, monc

    async def wait_for(monc, pred, what):
        t0 = time.time()
        while True:
            rc, st = await monc.command({"prefix": "status"}, timeout=5.0)
            if rc == 0 and pred(st):
                return st
            assert time.time() - t0 < 60, f"{what}: {st}"
            await asyncio.sleep(0.5)

    async def go():
        addr_map = {
            k: tuple(v) for k, v in
            (await aio.read_json(
                os.path.join(run_dir, "addr_map.json"))).items()
        }
        ms, monc = await mon_client(addr_map)
        # a peon may answer before the pool's commit reaches it
        st = await wait_for(monc, lambda s: "ecpool" in s["pools"],
                            "the pool never reached the mons")
        assert st["up_osds"] == [0, 1, 2, 3, 4]
        epoch0 = st["osdmap_epoch"]
        vstart.kill_osd(run_dir, 2)  # SIGKILL, no mon/test involvement
        st = await wait_for(monc, lambda s: 2 not in s["up_osds"],
                            "mon never marked down")
        assert st["osdmap_epoch"] > epoch0
        rc, log = await monc.command(
            {"prefix": "log last", "num": 5}, timeout=5.0)
        assert rc == 0 and any(
            "osd.2 failed" in e["message"] for e in log)
        await ms.shutdown()  # frees the shared client port

        c = await _connect(run_dir)
        payload = b"post-markdown" * 100
        await c.write("survivor", payload)
        assert await c.read("survivor") == payload
        await c.close()

        vstart.revive_osd(run_dir, 2)
        ms2, monc2 = await mon_client(addr_map)
        await wait_for(monc2, lambda s: 2 in s["up_osds"],
                       "revived osd never marked up")
        await ms2.shutdown()

    try:
        run(go())
    finally:
        vstart.stop_cluster(run_dir)
