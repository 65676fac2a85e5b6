"""The port's monitor quorum (``mon/{monitor,paxos,osdmap,services}.py``),
its caps (``auth/caps.py``) and the mon-backed cluster
(``ECCluster.create_with_mons``) against the JAX package's.

Each case of the JAX package's ``tests/test_mon.py``,
``tests/test_mon_services.py``, ``tests/test_mon_store.py``, the mon half
of ``tests/test_tier.py`` and the caps cases of ``tests/test_common.py``
runs as the same script through both packages in one process: its own
assertions hold in each, and every command's ``(rc, out)`` and the
leader's osdmap dict at the end are the same in both.  Results are
compared, never timings.  A minted auth key is random and a cluster-log
stamp is a time, so those two fields are compared by type.  Each package's
mon mints and revokes keys in its own package's ``KeyRing``
(``auth/cephx.py``); the offline store tool of each package is held to
the other's in ``tests/test_torch_tools.py``.
"""

import asyncio
import types

import numpy as np
import pytest

from ceph_tpu.auth import KeyRing as JKeyRing
from ceph_tpu.auth import caps as j_caps
from ceph_tpu.mon import monitor as j_monitor
from ceph_tpu.mon import osdmap as j_osdmap
from ceph_tpu.mon import services as j_services
from ceph_tpu.osd import cluster as j_cluster
from ceph_tpu.osd import messenger as j_messenger
from ceph_tpu.utils import config as j_config
from ceph_tpu.utils.perf import PerfCounters as JPerfCounters
from ceph_tpu_torch.auth import KeyRing, caps
from ceph_tpu_torch.mon import monitor, osdmap, services
from ceph_tpu_torch.osd import cluster, cluster_bench, messenger
from ceph_tpu_torch.utils import config
from ceph_tpu_torch.utils.perf import PerfCounters
from torch_verify import port_verifiers

PORT = types.SimpleNamespace(
    name="port", MonCluster=monitor.MonCluster, MonClient=monitor.MonClient,
    OSDMap=osdmap.OSDMap, ClusterLog=services.ClusterLog,
    LogClient=services.LogClient, Messenger=messenger.Messenger,
    caps=caps, config=config, PerfCounters=PerfCounters,
    ECCluster=cluster.ECCluster, KeyRing=KeyRing,
    # the port's mon-backed cluster runs the card's plugin, on the CPU
    # where the profile asks for it
    with_mons=lambda n, prof, **kw: cluster.ECCluster.create_with_mons(
        n, dict(prof, device="cpu"), plugin="cuda", **kw),
    make=lambda n, prof, **kw: cluster.ECCluster(
        n, dict(prof, device="cpu"), plugin="cuda", **kw))
JAX = types.SimpleNamespace(
    name="jax", MonCluster=j_monitor.MonCluster,
    MonClient=j_monitor.MonClient, OSDMap=j_osdmap.OSDMap,
    ClusterLog=j_services.ClusterLog, LogClient=j_services.LogClient,
    Messenger=j_messenger.Messenger, caps=j_caps, config=j_config,
    PerfCounters=JPerfCounters, ECCluster=j_cluster.ECCluster,
    KeyRing=JKeyRing,
    with_mons=lambda n, prof, **kw: j_cluster.ECCluster.create_with_mons(
        n, dict(prof), plugin="jerasure", **kw),
    make=lambda n, prof, **kw: j_cluster.ECCluster(
        n, dict(prof), plugin="jerasure", **kw))
BOTH = (PORT, JAX)


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


def mask(out):
    """``out`` with the random (``key``) and clock (``stamp``) fields
    replaced by their type names."""
    if isinstance(out, dict):
        return {k: (type(v).__name__ if k in ("key", "stamp") else mask(v))
                for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(mask(v) for v in out)
    return out


class Logged:
    """A MonClient whose every command's ``(rc, out)`` lands in ``log``."""

    def __init__(self, client, log):
        self.client, self.log = client, log

    async def command(self, cmd, **kw):
        rc, out = await self.client.command(cmd, **kw)
        self.log.append((cmd.get("prefix"), rc, mask(out)))
        return rc, out

    def __getattr__(self, name):
        return getattr(self.client, name)


def _client(P, ms, log, name="client0", extra=None):
    cl = P.MonClient(ms, 3, name)

    async def dispatch(src, msg):
        if isinstance(msg, dict) and not await cl.handle_reply(msg) \
                and extra is not None:
            extra.append(msg)

    ms.register(name, dispatch)
    return Logged(cl, log)


def _both(scenario, *args):
    """Run ``scenario(P, log, *args)`` in each package; the logs (every
    command's result and what the scenario recorded) must be equal."""
    logs = {}
    for P in BOTH:
        log = []
        _run(scenario(P, log, *args))
        logs[P.name] = log
    assert logs["port"] == logs["jax"]
    assert logs["port"]
    return logs["port"]


# -- elections, paxos, failover (tests/test_mon.py) --------------------------


async def _election_lowest_rank_wins(P, log):
    ms = P.Messenger()
    mc = P.MonCluster(3, ms)
    await mc.form_quorum()
    await asyncio.sleep(0.2)
    leader = await mc.wait_for_leader()
    assert leader.rank == 0 and 0 in leader.quorum
    log.append((leader.rank, sorted(leader.quorum)))
    await ms.shutdown()


async def _paxos_replicates_commits(P, log):
    ms = P.Messenger()
    mc = P.MonCluster(3, ms)
    leader = await mc.form_quorum()
    for i in range(5):
        assert await leader._propose({"op": "create_osds", "n": i + 1})
    await asyncio.sleep(0.1)
    for mon in mc.mons:
        assert mon.paxos.store.last_committed == 5
        assert mon.osdmap.epoch == 5 and mon.osdmap.max_osd == 5
        log.append(mon.osdmap.to_dict())
    await ms.shutdown()


async def _leader_failover(P, log):
    ms = P.Messenger()
    mc = P.MonCluster(3, ms)
    leader = await mc.form_quorum()
    assert await leader._propose({"op": "create_osds", "n": 4})
    mc.kill(leader.rank)
    new_leader = await mc.form_quorum()
    assert new_leader.rank != leader.rank
    assert new_leader.osdmap.max_osd == 4
    assert await new_leader._propose(
        {"op": "profile_set", "name": "p", "profile": {"k": "2", "m": "1"}})
    await asyncio.sleep(0.1)
    for mon in mc.mons:
        if mon.rank != leader.rank:
            assert mon.osdmap.ec_profiles.get("p") == {"k": "2", "m": "1"}
    mc.revive(leader.rank)
    relead = await mc.form_quorum()
    assert relead.rank == leader.rank
    await asyncio.sleep(0.2)
    assert relead.osdmap.ec_profiles.get("p") == {"k": "2", "m": "1"}
    log.append((new_leader.rank, relead.rank, relead.osdmap.to_dict()))
    await ms.shutdown()


async def _minority_cannot_commit(P, log):
    ms = P.Messenger()
    mc = P.MonCluster(3, ms)
    leader = await mc.form_quorum()
    mc.kill(1)
    mc.kill(2)
    ok = await leader.paxos.propose(
        {"inc": {"op": "create_osds", "n": 9}}, leader.quorum, timeout=0.3)
    assert not ok
    assert leader.osdmap.max_osd == 0
    log.append((ok, leader.osdmap.to_dict()))
    await ms.shutdown()


async def _command_validation_and_flows(P, log):
    ms = P.Messenger()
    mc = P.MonCluster(3, ms)
    await mc.form_quorum()
    extra = []
    cl = _client(P, ms, log, extra=extra)
    assert (await cl.command({"prefix": "osd create", "n": 6}))[0] == 0
    rc, out = await cl.command({
        "prefix": "osd erasure-code-profile set", "name": "bad",
        "profile": {"plugin": "jerasure", "k": "0", "m": "1"}})
    assert rc == -22 and "invalid" in str(out)
    assert (await cl.command({
        "prefix": "osd erasure-code-profile set", "name": "good",
        "profile": {"plugin": "jerasure", "k": "2", "m": "1"}}))[0] == 0
    rc, pool = await cl.command(
        {"prefix": "osd pool create", "name": "pl", "profile": "good"})
    assert rc == 0 and pool["k"] == 2 and pool["m"] == 1
    assert (await cl.command({"prefix": "osd pool create", "name": "pl",
                              "profile": "good"}))[0] == -17
    assert (await cl.command({"prefix": "osd pool create", "name": "p2",
                              "profile": "nope"}))[0] == -2
    assert (await cl.command({"prefix": "osd erasure-code-profile rm",
                              "name": "good"}))[0] == -16
    await cl.command({"prefix": "osd erasure-code-profile ls"})
    await cl.command({"prefix": "osd erasure-code-profile get",
                      "name": "good"})
    rc, st = await cl.command({"prefix": "status"})
    assert rc == 0 and st["pools"] == ["pl"] and st["num_osds"] == 6
    await cl.subscribe()
    await asyncio.sleep(0.1)
    epochs = [m["map"]["epoch"] for m in extra if m.get("type") == "osdmap"]
    assert epochs and max(epochs) == st["osdmap_epoch"]
    log.append((await mc.wait_for_leader()).osdmap.to_dict())
    await ms.shutdown()


async def _forwarded_command(P, log):
    ms = P.Messenger()
    mc = P.MonCluster(3, ms)
    await mc.form_quorum()
    cl = P.MonClient(ms, 3, "client1")

    async def dispatch(src, msg):
        if isinstance(msg, dict):
            await cl.handle_reply(msg)

    ms.register("client1", dispatch)
    # address mon.2 (a peon) directly: it forwards to the leader
    cl._id += 1
    fut = asyncio.get_event_loop().create_future()
    cl._replies[cl._id] = fut
    await ms.send_message("client1", "mon.2", {
        "type": "mon_command", "cmd": {"prefix": "status"}, "id": cl._id})
    rc, st = await asyncio.wait_for(fut, 2)
    assert rc == 0 and st["leader"] == 0
    log.append((rc, st))
    await ms.shutdown()


async def _replicated_pool_create(P, log):
    ms = P.Messenger()
    mc = P.MonCluster(3, ms)
    await mc.form_quorum()
    cl = _client(P, ms, log)
    assert (await cl.command({"prefix": "osd create", "n": 6}))[0] == 0
    rc, pool = await cl.command({
        "prefix": "osd pool create", "name": "rpool",
        "pool_type": "replicated", "size": 3})
    assert rc == 0 and pool["pool_type"] == "replicated"
    assert pool["size"] == 3 and pool["min_size"] == 2
    for bad in ({"size": 0}, {"size": 3, "min_size": 99},
                {"size": 3, "min_size": 0}):
        rc, _ = await cl.command(dict({
            "prefix": "osd pool create", "name": "bad",
            "pool_type": "replicated"}, **bad))
        assert rc == -22
    leader = next(m for m in mc.mons if m.is_leader())
    info = leader.osdmap.pools["rpool"]
    assert info.pool_type == "replicated" and info.size == 3
    m2 = P.OSDMap.from_dict(leader.osdmap.to_dict())
    assert m2.pools["rpool"].pool_type == "replicated"
    assert m2.pools["rpool"].min_size == 2
    log.append(m2.to_dict())
    await ms.shutdown()


async def _osd_boot_and_failure_reports(P, log):
    """`osd boot` marks an OSD up; `osd failure` marks it down only at
    mon_osd_min_down_reporters distinct reporters."""
    ms = P.Messenger()
    mc = P.MonCluster(3, ms)
    await mc.form_quorum()
    cl = _client(P, ms, log)
    await cl.command({"prefix": "osd create", "n": 4})
    await cl.command({"prefix": "osd boot", "osd": 2})
    await cl.command({"prefix": "osd boot", "osd": 2})
    await cl.command({"prefix": "osd boot", "osd": 6})
    rc, out = await cl.command({"prefix": "osd failure", "osd": 2,
                                "from": "osd.0"})
    assert out == {"reports": 1, "need": 2}
    await cl.command({"prefix": "osd failure", "osd": 2, "from": "osd.0"})
    rc, out = await cl.command({"prefix": "osd failure", "osd": 2,
                                "from": "osd.1"})
    assert out == {"marked_down": True}
    await cl.command({"prefix": "osd failure", "osd": 2, "from": "osd.3"})
    log.append((await mc.wait_for_leader()).osdmap.to_dict())
    await ms.shutdown()


MON_CASES = {
    "election_lowest_rank_wins": _election_lowest_rank_wins,
    "paxos_replicates_commits": _paxos_replicates_commits,
    "leader_failover": _leader_failover,
    "minority_cannot_commit": _minority_cannot_commit,
    "command_validation_and_flows": _command_validation_and_flows,
    "forwarded_command": _forwarded_command,
    "replicated_pool_create": _replicated_pool_create,
    "osd_boot_and_failure_reports": _osd_boot_and_failure_reports,
}


@pytest.mark.parametrize("case", sorted(MON_CASES))
def test_mon_case_matches_jax(case):
    _both(MON_CASES[case])


# -- the PaxosService family (tests/test_mon_services.py) -------------------


async def _config_key_store(P, log):
    ms = P.Messenger()
    mc = P.MonCluster(3, ms)
    await mc.form_quorum()
    cl = _client(P, ms, log)
    assert (await cl.command({"prefix": "config-key set",
                              "key": "mgr/dash/ssl", "value": "no"}))[0] == 0
    assert (await cl.command({"prefix": "config-key set",
                              "key": "rgw/zone", "value": "za"}))[0] == 0
    assert await cl.command({"prefix": "config-key get",
                             "key": "rgw/zone"}) == (0, "za")
    rc, out = await cl.command({"prefix": "config-key ls"})
    assert out == ["mgr/dash/ssl", "rgw/zone"]
    await asyncio.sleep(0.1)
    for mon in mc.mons:
        assert mon.kvstore.kv["rgw/zone"] == "za"
    mc.kill(0)
    await mc.mons[1].start_election()
    leader = await mc.wait_for_leader()
    assert leader.rank == 1
    assert await cl.command({"prefix": "config-key get",
                             "key": "mgr/dash/ssl"}) == (0, "no")
    assert (await cl.command({"prefix": "config-key rm",
                              "key": "rgw/zone"}))[0] == 0
    assert (await cl.command({"prefix": "config-key exists",
                              "key": "rgw/zone"}))[0] == -2
    await ms.shutdown()


async def _centralized_config(P, log):
    ms = P.Messenger()
    mc = P.MonCluster(3, ms)
    await mc.form_quorum()
    extra = []
    cl = _client(P, ms, log, extra=extra)
    await cl.subscribe()
    await asyncio.sleep(0.05)
    extra.clear()
    for who, name, value in [
        ("global", "debug_level", "1"),
        ("osd", "osd_recovery_max_chunk", "1048576"),
        ("osd.3", "osd_recovery_max_chunk", "65536"),
        ("osd", "debug_level", "5"),
    ]:
        assert (await cl.command({"prefix": "config set", "who": who,
                                  "name": name, "value": value}))[0] == 0
    rc, view = await cl.command({"prefix": "config get", "who": "osd.3"})
    assert view == {"debug_level": "5", "osd_recovery_max_chunk": "65536"}
    rc, view = await cl.command({"prefix": "config get", "who": "osd.7"})
    assert view == {"debug_level": "5",
                    "osd_recovery_max_chunk": "1048576"}
    rc, view = await cl.command({"prefix": "config get", "who": "mon.0"})
    assert view == {"debug_level": "1"}
    await asyncio.sleep(0.1)
    pushes = [m for m in extra if m.get("type") == "config"]
    assert pushes
    assert pushes[-1]["sections"]["osd.3"] == \
        {"osd_recovery_max_chunk": "65536"}
    log.append(pushes[-1]["sections"])
    assert (await cl.command({"prefix": "config rm", "who": "osd.3",
                              "name": "osd_recovery_max_chunk"}))[0] == 0
    rc, dump = await cl.command({"prefix": "config dump"})
    assert "osd.3" not in dump
    await ms.shutdown()


async def _cluster_log(P, log):
    ms = P.Messenger()
    mc = P.MonCluster(3, ms)
    await mc.form_quorum()
    cl = _client(P, ms, log)
    clog = P.LogClient(cl, "osd.1")
    await clog.info("osd.1 booted")
    await clog.warn("slow request")
    await clog.error("chunk crc mismatch on shard 2")
    rc, out = await cl.command({"prefix": "log last", "num": 10})
    assert [e["message"] for e in out] == [
        "osd.1 booted", "slow request", "chunk crc mismatch on shard 2"]
    assert [e["seq"] for e in out] == [1, 2, 3]
    rc, out = await cl.command({"prefix": "log last", "num": 10,
                                "level": "error"})
    assert [e["message"] for e in out] == ["chunk crc mismatch on shard 2"]
    await asyncio.sleep(0.1)
    assert all(mon.clog.seq == 3 for mon in mc.mons)
    saved = P.ClusterLog.MAX_ENTRIES
    P.ClusterLog.MAX_ENTRIES = 5
    try:
        for i in range(8):
            await clog.info(f"spam {i}")
        leader = await mc.wait_for_leader()
        assert len(leader.clog.entries) == 5
        assert leader.clog.entries[-1]["message"] == "spam 7"
        log.append(mask(leader.clog.entries))
    finally:
        P.ClusterLog.MAX_ENTRIES = saved
    await ms.shutdown()


async def _auth_key_lifecycle(P, log):
    ms = P.Messenger()
    mc = P.MonCluster(3, ms)
    await mc.form_quorum()
    cl = _client(P, ms, log)
    rc, out = await cl.command({
        "prefix": "auth get-or-create", "entity": "client.rgw",
        "caps": {"osd": "allow rwx pool=rgw"}})
    assert rc == 0
    key1 = out["key"]
    rc, out = await cl.command({"prefix": "auth get-or-create",
                                "entity": "client.rgw"})
    assert rc == 0 and out["key"] == key1
    rc, out = await cl.command({"prefix": "auth get",
                                "entity": "client.rgw"})
    assert rc == 0 and out["caps"] == {"osd": "allow rwx pool=rgw"}
    assert (await cl.command({"prefix": "auth caps", "entity": "client.rgw",
                              "caps": {"osd": "allow r"}}))[0] == 0
    rc, out = await cl.command({"prefix": "auth rotate",
                                "entity": "client.rgw"})
    assert rc == 0 and out["key"] != key1
    for m in mc.mons:
        assert m.authdb.entities["client.rgw"]["key"] == out["key"]
    rc, out = await cl.command({"prefix": "auth list"})
    assert rc == 0 and "key" not in out["client.rgw"]
    assert (await cl.command({"prefix": "auth rm",
                              "entity": "client.rgw"}))[0] == 0
    assert (await cl.command({"prefix": "auth get",
                              "entity": "client.rgw"}))[0] == -2
    await ms.shutdown()


async def _mgr_failover(P, log):
    ms = P.Messenger()
    mc = P.MonCluster(3, ms)
    await mc.form_quorum()
    cl = _client(P, ms, log)
    rc, mm = await cl.command({"prefix": "mgr beacon", "name": "x"})
    assert rc == 0 and mm["active"] == "x"
    rc, mm = await cl.command({"prefix": "mgr beacon", "name": "y"})
    assert mm["active"] == "x" and mm["standbys"] == ["y"]
    rc, mm = await cl.command({"prefix": "mgr fail"})
    assert mm["active"] == "y" and mm["standbys"] == []
    await cl.command({"prefix": "mgr beacon", "name": "x"})
    P.config.get_config().set_val("mon_mgr_beacon_grace", "0.05")
    try:
        await asyncio.sleep(0.1)
        rc, mm = await cl.command({"prefix": "mgr beacon", "name": "x"})
        assert rc == 0 and mm["active"] == "x"
    finally:
        P.config.get_config().set_val("mon_mgr_beacon_grace", "30.0")
    await ms.shutdown()


async def _mds_fsmap(P, log):
    ms = P.Messenger()
    mc = P.MonCluster(3, ms)
    await mc.form_quorum()
    cl = _client(P, ms, log)
    for name in ("a", "b", "c"):
        assert (await cl.command({"prefix": "mds beacon",
                                  "name": name}))[0] == 0
    rc, fm = await cl.command({"prefix": "fs new", "name": "cephfs",
                               "max_mds": 2})
    assert fm["filesystems"]["cephfs"]["ranks"] == {"0": "a", "1": "b"}
    assert fm["standbys"] == ["c"]
    rc, fm = await cl.command({"prefix": "mds fail", "name": "a"})
    assert fm["filesystems"]["cephfs"]["ranks"] == {"0": "c", "1": "b"}
    rc, fm = await cl.command({"prefix": "mds beacon", "name": "a"})
    assert fm["standbys"] == ["a"]
    rc, fm = await cl.command({"prefix": "fs set max_mds",
                               "name": "cephfs", "max_mds": 1})
    assert fm["filesystems"]["cephfs"]["ranks"] == {"0": "c"}
    assert sorted(fm["standbys"]) == ["a", "b"]
    assert await cl.command({"prefix": "fs ls"}) == (0, ["cephfs"])
    await ms.shutdown()


async def _auth_rm_revokes_keyring(P, log):
    ms = P.Messenger()
    mc = P.MonCluster(3, ms)
    await mc.form_quorum()
    ms.keyring = P.KeyRing()
    provisioned = ms.keyring.add("mon.1")
    cl = _client(P, ms, log)
    rc, out = await cl.command({"prefix": "auth get-or-create",
                                "entity": "osd.9"})
    assert rc == 0 and ms.keyring.get("osd.9") == bytes.fromhex(out["key"])
    assert (await cl.command({"prefix": "auth rm",
                              "entity": "osd.9"}))[0] == 0
    assert ms.keyring.get("osd.9") is None
    # an entity the AuthDB never managed is -ENOENT and keeps its key
    assert (await cl.command({"prefix": "auth rm",
                              "entity": "mon.1"}))[0] == -2
    assert ms.keyring.get("mon.1") == provisioned
    await ms.shutdown()


async def _auth_mutations_gated(P, log):
    ms = P.Messenger()
    mc = P.MonCluster(3, ms)
    await mc.form_quorum()
    admin = _client(P, ms, log)
    assert (await admin.command({
        "prefix": "auth get-or-create", "entity": "osd.9",
        "caps": {"osd": "allow *"}}))[0] == 0
    assert (await admin.command({
        "prefix": "auth get-or-create", "entity": "client.ops",
        "caps": {"mon": "allow profile admin", "osd": "allow *"}}))[0] == 0
    await asyncio.sleep(0.05)
    svc = _client(P, ms, log, name="osd.9")
    for cmd in (
        {"prefix": "auth get-or-create", "entity": "client.evil"},
        {"prefix": "auth rotate", "entity": "client.ops"},
        {"prefix": "auth rm", "entity": "client.ops"},
        {"prefix": "auth caps", "entity": "osd.9",
         "caps": {"mon": "allow *"}},
    ):
        rc, out = await svc.command(cmd)
        assert rc == -13, (cmd, rc, out)
    assert (await svc.command({"prefix": "auth get",
                               "entity": "osd.9"}))[0] == 0
    leader = await mc.wait_for_leader()
    assert "client.evil" not in leader.authdb.entities

    async def drop(src, msg):
        pass

    ms.register("osd.9b", drop)
    assert (await admin.command({
        "prefix": "auth get-or-create", "entity": "osd.9b",
        "caps": {"osd": "allow *"}}))[0] == 0
    await asyncio.sleep(0.05)
    await ms.send_message("osd.9b", f"mon.{leader.rank}", {
        "type": "mon_command", "id": 1, "reply_to": "client.admin",
        "cmd": {"prefix": "auth rm", "entity": "client.ops"}})
    await asyncio.sleep(0.2)
    assert "client.ops" in leader.authdb.entities
    ops = _client(P, ms, log, name="client.ops")
    assert (await ops.command({"prefix": "auth rotate",
                               "entity": "osd.9"}))[0] == 0
    log.append(sorted(leader.clog.entries[-1]))
    await ms.shutdown()


SERVICE_CASES = {
    "config_key_store": _config_key_store,
    "centralized_config": _centralized_config,
    "cluster_log": _cluster_log,
    "auth_key_lifecycle": _auth_key_lifecycle,
    "mgr_failover": _mgr_failover,
    "mds_fsmap": _mds_fsmap,
    "auth_rm_revokes_keyring": _auth_rm_revokes_keyring,
    "auth_mutations_gated": _auth_mutations_gated,
}


@pytest.mark.parametrize("case", sorted(SERVICE_CASES))
def test_mon_service_matches_jax(case):
    _both(SERVICE_CASES[case])


# -- the durable store (tests/test_mon_store.py) ---------------------------


async def _survives_full_restart(P, log, path):
    ms = P.Messenger()
    mc = P.MonCluster(3, ms, store_dir=path)
    await mc.form_quorum()
    cl = _client(P, ms, log)
    assert (await cl.command({"prefix": "osd create", "n": 5}))[0] == 0
    assert (await cl.command({
        "prefix": "osd erasure-code-profile set", "name": "p42",
        "profile": {"plugin": "jerasure", "k": "4", "m": "2"}}))[0] == 0
    assert (await cl.command({"prefix": "config-key set", "key": "survives",
                              "value": "restart"}))[0] == 0
    leader = await mc.wait_for_leader()
    epoch, pn = leader.osdmap.epoch, leader.paxos.store.accepted_pn
    await ms.shutdown()
    mc.close_stores()
    ms2 = P.Messenger()
    mc2 = P.MonCluster(3, ms2, store_dir=path)
    for mon in mc2.mons:
        assert mon.osdmap.epoch == epoch and mon.osdmap.max_osd == 5
        assert "p42" in mon.osdmap.ec_profiles
        assert mon.kvstore.kv["survives"] == "restart"
        assert mon.paxos.store.accepted_pn >= pn
    await mc2.form_quorum()
    cl2 = _client(P, ms2, log, name="client1")
    rc, out = await cl2.command({"prefix": "status"})
    assert rc == 0 and out["osdmap_epoch"] == epoch
    assert (await cl2.command({"prefix": "config-key set", "key": "post",
                               "value": "1"}))[0] == 0
    log.append((await mc2.wait_for_leader()).osdmap.to_dict())
    await ms2.shutdown()
    mc2.close_stores()


async def _minority_survivor_recovers(P, log, path):
    ms = P.Messenger()
    mc = P.MonCluster(3, ms, store_dir=path)
    await mc.form_quorum()
    cl = _client(P, ms, log)
    await cl.command({"prefix": "osd create", "n": 3})
    mc.kill(2)
    await cl.command({"prefix": "config-key set", "key": "a", "value": "1"})
    await cl.command({"prefix": "config-key set", "key": "b", "value": "2"})
    mc.revive(2)
    await mc.mons[0].start_election()
    await mc.wait_for_leader()
    await asyncio.sleep(0.2)
    assert mc.mons[2].paxos.store.last_committed == 3
    assert mc.mons[2].kvstore.kv == {"a": "1", "b": "2"}
    await ms.shutdown()
    mc.close_stores()


async def _clog_float_stamp_persists(P, log, path):
    ms = P.Messenger()
    mc = P.MonCluster(3, ms, store_dir=path)
    await mc.form_quorum()
    cl = _client(P, ms, log)
    assert (await cl.command({
        "prefix": "log", "who": "osd.0", "level": "warn",
        "message": "slow request", "stamp": 1234.5678}))[0] == 0
    rc, out = await cl.command({"prefix": "log last", "num": 5})
    assert out[-1]["stamp"] == 1234.5678
    await ms.shutdown()
    mc.close_stores()
    ms2 = P.Messenger()
    mc2 = P.MonCluster(3, ms2, store_dir=path)
    assert mc2.mons[0].clog.entries[-1]["stamp"] == 1234.5678
    assert mc2.mons[0].clog.entries[-1]["message"] == "slow request"
    await ms2.shutdown()
    mc2.close_stores()


STORE_CASES = {
    "survives_full_restart": _survives_full_restart,
    "minority_survivor_recovers": _minority_survivor_recovers,
    "clog_float_stamp_persists": _clog_float_stamp_persists,
}


@pytest.mark.parametrize("case", sorted(STORE_CASES))
def test_mon_store_matches_jax(case, tmp_path):
    logs = {}
    for P in BOTH:
        log = []
        _run(STORE_CASES[case](P, log, str(tmp_path / P.name)))
        logs[P.name] = log
    assert logs["port"] == logs["jax"]


def test_paxos_store_is_cross_readable(tmp_path):
    """The mon store is the port's LSM over its encoding: the JAX
    package's mons restart on the stores the port's mons wrote, and the
    reverse, with the same committed state."""
    async def write(P, path):
        ms = P.Messenger()
        mc = P.MonCluster(3, ms, store_dir=path)
        await mc.form_quorum()
        cl = _client(P, ms, [])
        await cl.command({"prefix": "osd create", "n": 7})
        await cl.command({"prefix": "config-key set", "key": "x",
                          "value": "y"})
        await asyncio.sleep(0.1)
        await ms.shutdown()
        mc.close_stores()

    def state(Q, path):
        mc = Q.MonCluster(3, Q.Messenger(), store_dir=path)
        out = [(m.osdmap.to_dict(), m.kvstore.kv,
                m.paxos.store.last_committed) for m in mc.mons]
        mc.close_stores()
        return out

    for P, Q in ((PORT, JAX), (JAX, PORT)):
        path = str(tmp_path / P.name)
        _run(write(P, path))
        mine, theirs = state(P, path), state(Q, path)
        assert mine == theirs
        assert mine[0][0]["max_osd"] == 7 and mine[0][1] == {"x": "y"}


# -- the tier's commands through the mon (tests/test_tier.py) ---------------


async def _mon_tier_commands(P, log):
    ms = P.Messenger()
    mons = P.MonCluster(3, ms, tick=False)
    leader = await mons.form_quorum()

    async def do(cmd):
        rc, out = await leader.do_command(cmd)
        log.append((cmd["prefix"], rc, out))
        return rc, out

    await do({"prefix": "osd create", "n": 3})
    await do({"prefix": "osd erasure-code-profile set", "name": "prof",
              "profile": {"plugin": "jerasure", "k": "2", "m": "1"}})
    assert (await do({"prefix": "osd pool create", "name": "p1",
                      "profile": "prof"}))[0] == 0
    assert leader.osdmap.pools["p1"].cache_mode == "none"
    rc, out = await do({"prefix": "osd tier cache-mode", "pool": "p1",
                        "mode": "writeback"})
    assert rc == 0 and out["cache_mode"] == "writeback"
    for _ in range(100):
        if all(m.osdmap.pools.get("p1") is not None
               and m.osdmap.pools["p1"].cache_mode == "writeback"
               for m in mons.mons):
            break
        await asyncio.sleep(0.01)
    assert all(m.osdmap.pools["p1"].cache_mode == "writeback"
               for m in mons.mons)
    rc, st = await do({"prefix": "osd tier status"})
    assert st["pools"]["p1"]["cache_mode"] == "writeback"
    assert st["hbm_budget_bytes"] > 0
    assert (await do({"prefix": "osd tier cache-mode", "pool": "nope",
                      "mode": "writeback"}))[0] == -2
    assert (await do({"prefix": "osd tier cache-mode", "pool": "p1",
                      "mode": "turbo"}))[0] == -22
    m2 = P.OSDMap.from_dict(leader.osdmap.to_dict())
    assert m2.pools["p1"].cache_mode == "writeback"
    log.append(m2.to_dict())
    await ms.shutdown()


def test_mon_tier_commands_match_jax():
    _both(_mon_tier_commands)


# -- the mon-backed cluster ----------------------------------------------


def _profile_plugin_free(d):
    """An osdmap dict with each profile's ``plugin`` and ``device`` keys
    dropped: the port's pools run ``cuda`` with ``device=cpu`` here, the
    JAX package's ``jerasure``; everything else must match."""
    d = dict(d)
    d["ec_profiles"] = {
        name: {k: v for k, v in prof.items() if k not in ("plugin", "device")}
        for name, prof in d["ec_profiles"].items()}
    return d


async def _cluster_with_mons(P, log, kind, path):
    P.PerfCounters.reset_all()
    c = await P.with_mons(8, {"k": "3", "m": "2"}, n_mons=3,
                          objectstore=kind, data_path=path)
    rng = np.random.RandomState(41)
    payload = rng.randint(0, 256, size=16384, dtype=np.uint8).tobytes()
    await c.write("obj", payload)
    acting = c.backend.acting_set("obj")
    victim = acting[2]
    rc, _ = await c.mon_command({"prefix": "osd out", "osd": victim})
    assert rc == 0
    await asyncio.sleep(0.2)
    assert victim not in c.backend.acting_set("obj")
    assert await c.read("obj") == payload
    # a mon dying does not affect the data path; quorum survives
    c.mons.kill(2)
    rc, st = await c.mon_command({"prefix": "status"})
    assert rc == 0
    assert await c.read("obj") == payload
    # the leader dies: a survivor takes the lease, commands keep flowing
    c.mons.revive(2)
    c.mons.kill(0)
    rc, st = await c.mon_command({"prefix": "status"})
    # EAGAIN ("no leader"): the survivors' election is still running when
    # the client has asked each mon once; ask again, as a hunting client
    # does, until the new leader answers
    loop = asyncio.get_running_loop()
    deadline = loop.time() + 30.0
    while rc == -11 and loop.time() < deadline:
        await asyncio.sleep(0.05)
        rc, st = await c.mon_command({"prefix": "status"})
    assert rc == 0 and st["leader"] in (1, 2), st
    second = rng.randint(0, 256, size=9000, dtype=np.uint8).tobytes()
    await c.write("obj2", second)
    assert await c.read("obj2") == second
    leader = await c.mons.wait_for_leader()
    log.append((st["leader"], acting, _profile_plugin_free(
        leader.osdmap.to_dict())))
    if kind == "memstore":
        log.append(cluster_bench.store_snapshot(c))
    else:
        log.append({o.osd_id: {
            oid: (o.store.read(oid), o.store._get_onode(oid)["attrs"],
                  o.store.omap_get(oid))
            for oid in o.store.list_objects()} for o in c.osds})
    await c.shutdown()


@pytest.mark.parametrize("kind", ["memstore", "blockstore"])
def test_create_with_mons_end_to_end_matches_jax(kind, tmp_path):
    """``create_with_mons`` with the port's ``cuda`` plugin (profile
    ``device=cpu``): bring-up through paxos-committed commands, a write,
    ``osd out`` through the mon and the remap it broadcasts, a mon's
    death, the leader's death and the lease's failover; the stored bytes
    (on memstore and on blockstore) and the osdmap equal the JAX
    package's."""
    logs = {}
    for P in BOTH:
        log = []
        _run(_cluster_with_mons(P, log, kind, str(tmp_path / P.name)))
        logs[P.name] = log
    assert logs["port"] == logs["jax"]
    assert logs["port"][-1]


def test_create_with_mons_runs_the_card_plugin_by_default():
    async def main():
        c = await cluster.ECCluster.create_with_mons(
            6, {"k": "2", "m": "1", "device": "cpu"})
        assert type(c.ec).__module__ == "ceph_tpu_torch.plugins.cuda"
        rc, prof = await c.mon_command({
            "prefix": "osd erasure-code-profile get",
            "name": "ecpool-profile"})
        assert rc == 0 and prof["plugin"] == "cuda"
        # a profile that names no plugin is validated with the card's
        rc, _ = await c.mon_command({
            "prefix": "osd erasure-code-profile set", "name": "bare",
            "profile": {"k": "2", "m": "1", "device": "cpu"}})
        assert rc == 0
        rc, pool = await c.mon_command({
            "prefix": "osd pool create", "name": "p2", "profile": "bare"})
        assert rc == 0 and (pool["k"], pool["m"]) == (2, 1)
        assert await c.mon_command({"prefix": "osd tier status"}) == (
            0, {"hbm_budget_bytes":
                config.get_config().get_val("osd_tier_hbm_bytes"),
                "pools": {"ecpool": {"cache_mode": "none"},
                          "p2": {"cache_mode": "none"}}})
        await c.shutdown()

    _run(main())
    # nothing of the in-process cluster is refused any more: the module
    # that listed the refusals is gone
    with pytest.raises(ImportError):
        import ceph_tpu_torch.utils.unported  # noqa: F401


# -- caps (tests/test_common.py) ------------------------------------------


def _osdcap_checks(C):
    out = []
    cap = C.OSDCap.parse("allow r pool=data, allow rw pool=rbd")
    out += [cap.is_capable("data", "x", need_r=True),
            cap.is_capable("data", "x", need_w=True),
            cap.is_capable("rbd", "x", need_r=True, need_w=True),
            cap.is_capable("other", "x", need_r=True)]
    star = C.OSDCap.parse("allow *")
    out.append(star.is_capable("anything", "y", need_r=True, need_w=True,
                               need_x=True))
    pre = C.OSDCap.parse("allow rwx pool=rbd object_prefix rbd_header.")
    out += [pre.is_capable("rbd", "rbd_header.img", need_w=True),
            pre.is_capable("rbd", "rbd_data.img.0", need_w=True)]
    for bad in ("deny rw", "allow q", "allow rw foo=bar", ""):
        try:
            C.OSDCap.parse(bad)
            out.append("parsed")
        except ValueError:
            out.append("ValueError")
    r = C.OSDCap.parse("allow r pool=p")
    rx = C.OSDCap.parse("allow rx pool=p")
    out += [C.op_capable(r, "p", "o", kind)
            for kind in ("read", "stat", "write", "exec", "omap_set")]
    out.append(C.op_capable(rx, "p", "o", "exec"))
    for text in ("allow *", "allow all", "allow profile admin",
                 "allow profile osd", "allow r", "", None,
                 "allow r, allow *"):
        out.append(C.MonCap.parse(text).is_admin())
    return out


def test_caps_match_jax():
    mine, theirs = _osdcap_checks(caps), _osdcap_checks(j_caps)
    assert mine == theirs
    assert mine[:7] == [True, False, True, False, True, True, False]
    assert mine[7:11] == ["ValueError"] * 4
    assert mine[11:17] == [True, True, False, False, False, True]
    assert mine[17:] == [True, True, True, False, False, False, False, True]


async def _cluster_enforces_caps(P, log):
    P.PerfCounters.reset_all()
    c = P.make(4, {"k": "2", "m": "1"})
    await c.write("obj", b"payload")
    ro = c.new_client("client.reader")
    for osd in c.osds:
        osd.set_client_caps("client.reader", "allow r pool=" + c.pool)
    assert await ro.read("obj") == b"payload"
    with pytest.raises(PermissionError):
        await ro.write("obj", b"overwrite")
    await c.write("obj", b"admin-write")
    assert await c.read("obj") == b"admin-write"
    log.append(sum(o.perf.snapshot().get("cap_denied", 0) for o in c.osds))
    log.append(cluster_bench.store_snapshot(c))
    await c.shutdown()


def test_cluster_enforces_caps_matches_jax():
    log = _both(_cluster_enforces_caps)
    assert log[0] >= 1


# -- the options the slice reads -----------------------------------------

MON_OPTIONS = ("osd_heartbeat_grace", "mon_osd_min_down_reporters",
               "mon_mgr_beacon_grace")


@pytest.mark.parametrize("name", MON_OPTIONS)
def test_new_option_equals_the_jax_schema_entry(name):
    mine, theirs = config.OPTIONS[name], j_config.OPTIONS[name]
    assert (mine.name, mine.type, mine.default, mine.level) == \
        (theirs.name, theirs.type, theirs.default, theirs.level)
    assert config.get_config().get_val(name) == theirs.default
