"""A resent mon command is idempotent in the port (``mon/monitor.py``).

``MonClient.command`` keeps one request id, ``(client name,
incarnation, tid)``, across every resend; every mon that applies the
command's commit records ``(reqid, command digest) -> (rc, out)``, the
reqid bound to the authenticated caller; a mon that receives a recorded
key answers the record once the caller passes the command's cap check,
and a proposal whose key was already applied applies as a no-op.  This
is the port's one deliberate difference from the JAX package's mon,
whose client resends with a new id: there a reply held past the
client's wait turns a committed ``osd add`` into -17 EEXIST, and the
case below shows both.  Where every first send is
answered in time, ``(rc, out)`` and the osdmap are the JAX package's.
"""

import asyncio
import types

import pytest

from ceph_tpu.osd import cluster as j_cluster
from ceph_tpu_torch.mon import monitor
from ceph_tpu_torch.osd import cluster, messenger

#: both clusters' pool runs the numpy plugin, so that the two osdmaps,
#: profiles included, can be compared whole (the mon is the subject)
PORT = types.SimpleNamespace(
    name="port",
    with_mons=lambda n, **kw: cluster.ECCluster.create_with_mons(
        n, {"k": "2", "m": "1"}, plugin="jerasure", **kw))
JAX = types.SimpleNamespace(
    name="jax",
    with_mons=lambda n, **kw: j_cluster.ECCluster.create_with_mons(
        n, {"k": "2", "m": "1"}, plugin="jerasure", **kw))

#: the client's wait in these cases, and how long a held reply waits
WAIT_S, HOLD_S = 0.3, 1.0


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
    """Keep the conftest's verifying policy where it can run a task; where
    it cannot, this file's loops, the JAX package's included, run under
    asyncio's default policy."""
    if _policy_runs_tasks():
        yield
        return
    saved = asyncio.get_event_loop_policy()
    asyncio.set_event_loop_policy(asyncio.DefaultEventLoopPolicy())
    yield
    asyncio.set_event_loop_policy(saved)


def _reqids(records):
    """The reqids of a mon's records, oldest first (each key is the
    reqid and the command's digest)."""
    return [key[:3] for key in records]


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _hold_jax_reply(c, src: str) -> None:
    """The JAX package's injector has no per-sender hold: wrap its bus so
    that ``src``'s next command reply waits ``HOLD_S`` (what the port's
    ``FaultInjector.schedule_send_hold`` does)."""
    send = c.messenger.send_message
    armed = [True]

    async def held(s, dst, msg):
        if armed[0] and s == src and isinstance(msg, dict) and \
                msg.get("type") == "mon_command_reply":
            armed[0] = False
            await asyncio.sleep(HOLD_S)
        await send(s, dst, msg)

    c.messenger.send_message = held


async def _late_reply_osd_add(P):
    c = await P.with_mons(3, n_mons=3)
    try:
        leader = await c.mons.wait_for_leader()
        assert leader.rank == 0
        epoch0 = leader.osdmap.epoch
        new_id = c.add_osd(update_placement=False)
        if P is PORT:
            c.messenger.fault.schedule_send_hold(
                "mon.0", HOLD_S, kind="mon_command_reply")
        else:
            _hold_jax_reply(c, "mon.0")
        rc, out = await c.monc.command(
            {"prefix": "osd add", "osd": new_id}, timeout=WAIT_S)
        await asyncio.sleep(HOLD_S + 0.2)  # the held reply lands, unused
        maps = [mon.osdmap for mon in c.mons.mons]
        return {
            "rc": rc, "out": out, "new_id": new_id,
            "epoch": leader.osdmap.epoch,
            "epochs": [m.epoch - epoch0 for m in maps],
            "holds": [sorted(m.up).count(new_id) for m in maps],
            "fired": (c.messenger.fault.send_holds if P is PORT else 1),
        }
    finally:
        await c.shutdown()


def test_late_reply_osd_add_answers_the_first_commit():
    port = _run(_late_reply_osd_add(PORT))
    assert port["fired"] == 1, port
    # the first commit's answer, from the mon the resend reached
    assert port["rc"] == 0 and port["out"] == {"epoch": port["epoch"]}, port
    # the map holds the OSD once, from one commit on every mon
    assert port["holds"] == [1, 1, 1], port
    assert port["epochs"] == [1, 1, 1], port
    # the JAX package's client resends with a new id: a resend that
    # reaches the leader after the commit answers EEXIST, one that races
    # it applies the add a second time (the difference this repair makes)
    jax = _run(_late_reply_osd_add(JAX))
    assert (jax["rc"] == -17 and "exists" in jax["out"]
            and jax["epochs"] == [1, 1, 1]) or \
        (jax["rc"] == 0 and jax["epochs"] == [2, 2, 2]), jax


def test_resend_racing_the_first_commit_applies_once():
    """Two sends of one reqid reach the leader before either commits:
    the second proposal applies as a no-op and both answer the first
    commit's result."""
    async def main():
        bus = messenger.Messenger()
        mons = monitor.MonCluster(3, bus, tick=False)
        leader = await mons.form_quorum()
        replies = []

        async def client(src, msg):
            replies.append(msg)

        bus.register("client.x", client)
        rc, _ = await leader.do_command({"prefix": "osd create", "n": 3})
        assert rc == 0
        epoch0 = leader.osdmap.epoch
        msg = {"type": "mon_command", "cmd": {"prefix": "osd add",
                                              "osd": 3},
               "reqid": ["client.x", 7, 1]}
        await asyncio.gather(
            leader._handle_command("client.x", dict(msg, id=1)),
            leader._handle_command("client.x", dict(msg, id=2)))
        for _ in range(50):
            if len(replies) == 2:
                break
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.05)
        out = {
            "replies": sorted((r["id"], r["rc"], str(r["out"]))
                              for r in replies),
            "epochs": [m.osdmap.epoch - epoch0 for m in mons.mons],
            "recorded": [_reqids(m._reqid_results) for m in mons.mons],
            "values": sum("reqid" in v for v in
                          leader.paxos.store.values.values()),
        }
        await bus.shutdown()
        return out

    out = _run(main())
    (_, rc1, out1), (_, rc2, out2) = out["replies"]
    assert rc1 == rc2 == 0 and out1 == out2, out
    assert out["epochs"] == [1, 1, 1], out  # applied once on every mon
    assert out["values"] == 2, out  # two commits, the second a no-op
    assert out["recorded"] == [[("client.x", 7, 1)]] * 3, out


def test_read_only_commands_are_not_recorded():
    async def main():
        bus = messenger.Messenger()
        mons = monitor.MonCluster(3, bus, tick=False)
        await mons.form_quorum()
        monc = monitor.MonClient(bus, 3, "client.y")

        async def client(src, msg):
            await monc.handle_reply(msg)

        bus.register("client.y", client)
        got = [await monc.command({"prefix": "status"}),
               await monc.command({"prefix": "config-key ls"}),
               await monc.command({"prefix": "config-key set", "key": "a",
                                   "value": "1"}),
               await monc.command({"prefix": "config-key get",
                                   "key": "a"})]
        recorded = [dict(m._reqid_results) for m in mons.mons]
        await bus.shutdown()
        return got, recorded, monc.incarnation

    got, recorded, inc = _run(main())
    assert [rc for rc, _ in got] == [0, 0, 0, 0] and got[3][1] == "1", got
    # only the set (the client's third command) is recorded, everywhere
    for rec in recorded:
        assert _reqids(rec) == [("client.y", inc, 3)], recorded
        assert list(rec.values()) == [(0, "")], recorded


def test_recorded_results_are_bounded(monkeypatch):
    monkeypatch.setattr(monitor, "REQIDS_TRACKED", 3)

    async def main():
        bus = messenger.Messenger()
        mons = monitor.MonCluster(3, bus, tick=False)
        await mons.form_quorum()
        monc = monitor.MonClient(bus, 3, "client.z")

        async def client(src, msg):
            await monc.handle_reply(msg)

        bus.register("client.z", client)
        for i in range(5):
            rc, out = await monc.command(
                {"prefix": "config-key set", "key": f"k{i}", "value": i})
            assert (rc, out) == (0, ""), (rc, out)
        recorded = [_reqids(m._reqid_results) for m in mons.mons]
        await bus.shutdown()
        return recorded, monc.incarnation

    recorded, inc = _run(main())
    for rec in recorded:
        assert rec == [("client.z", inc, 3), ("client.z", inc, 4),
                       ("client.z", inc, 5)]


def test_store_replay_rebuilds_the_records(tmp_path):
    """A mon restarted on its LSM store answers a resend from the
    replayed record, as it rebuilds every other slice of its state."""
    async def main():
        bus = messenger.Messenger()
        mons = monitor.MonCluster(3, bus, tick=False,
                                  store_dir=str(tmp_path))
        await mons.form_quorum()
        monc = monitor.MonClient(bus, 3, "client.w")

        async def client(src, msg):
            await monc.handle_reply(msg)

        bus.register("client.w", client)
        first = await monc.command({"prefix": "osd create", "n": 2})
        second = await monc.command({"prefix": "auth get-or-create",
                                     "entity": "client.q"})
        recorded = dict(mons.mons[1]._reqid_results)
        await bus.shutdown()
        mons.close_stores()
        bus2 = messenger.Messenger()
        again = monitor.Monitor(1, 3, bus2,
                                store_path=str(tmp_path / "mon.1"))
        replayed = dict(again._reqid_results)
        again.close_store()
        await bus2.shutdown()
        return first, second, recorded, replayed, monc.incarnation

    first, second, recorded, replayed, inc = _run(main())
    assert first == (0, "created 2 osds")
    assert second[0] == 0 and second[1]["entity"] == "client.q"
    assert replayed == recorded
    assert _reqids(replayed) == [("client.w", inc, 1), ("client.w", inc, 2)]
    assert list(replayed.values()) == [first, second]


def _clients(bus, name, n):
    """``n`` MonClients that share ``name`` on ``bus``; each reply is
    offered to all of them, and the one waiting on its id takes it."""
    clients = [monitor.MonClient(bus, 3, name) for _ in range(n)]

    async def route(src, msg):
        for c in clients:
            await c.handle_reply(msg)

    bus.register(name, route)
    return clients


def test_clients_sharing_a_name_get_their_own_answers():
    """Three MonClients under one name each send tid 1 on one quorum: a
    mutation, a read and another mutation each get their own answer,
    and each mutation is applied."""
    async def main():
        bus = messenger.Messenger()
        mons = monitor.MonCluster(3, bus, tick=False)
        await mons.form_quorum()
        a, b, c = _clients(bus, "client.s", 3)
        got = [await a.command({"prefix": "osd create", "n": 5}),
               await b.command({"prefix": "status"}),
               await c.command({"prefix": "config-key set", "key": "k",
                                "value": "c"}),
               await c.command({"prefix": "config-key get", "key": "k"})]
        recorded = [_reqids(m._reqid_results) for m in mons.mons]
        incs = [x.incarnation for x in (a, b, c)]
        await bus.shutdown()
        return got, recorded, incs

    got, recorded, incs = _run(main())
    assert len(set(incs)) == 3, incs
    assert got[0] == (0, "created 5 osds"), got
    assert got[1][0] == 0 and got[1][1]["num_osds"] == 5, got
    assert got[2] == (0, "") and got[3] == (0, "c"), got
    for rec in recorded:
        assert rec == [("client.s", incs[0], 1), ("client.s", incs[2], 1)]


def test_a_new_client_after_a_restart_gets_its_own_answer(tmp_path):
    """A quorum restarted from its LSM stores keeps its records; a new
    client under the old client's name sends tid 1 again and gets the
    answer to its own command, not the record of the old one's."""
    async def first_life():
        bus = messenger.Messenger()
        mons = monitor.MonCluster(3, bus, tick=False,
                                  store_dir=str(tmp_path))
        await mons.form_quorum()
        (old,) = _clients(bus, "client.r", 1)
        got = await old.command({"prefix": "osd create", "n": 5})
        await bus.shutdown()
        mons.close_stores()
        return got

    async def second_life():
        bus = messenger.Messenger()
        mons = monitor.MonCluster(3, bus, tick=False,
                                  store_dir=str(tmp_path))
        await mons.form_quorum()
        replayed = [len(m._reqid_results) for m in mons.mons]
        (new,) = _clients(bus, "client.r", 1)
        got = [await new.command({"prefix": "status"}),
               await new.command({"prefix": "config-key set", "key": "k",
                                  "value": "v"}),
               await new.command({"prefix": "config-key get", "key": "k"})]
        await bus.shutdown()
        mons.close_stores()
        return replayed, got

    assert _run(first_life()) == (0, "created 5 osds")
    replayed, got = _run(second_life())
    assert replayed == [1, 1, 1], replayed
    assert got[0][0] == 0 and got[0][1]["num_osds"] == 5, got
    assert got[1] == (0, "") and got[2] == (0, "v"), got


def test_a_record_answers_only_its_own_command():
    """One reqid sent with three different commands: each runs and
    gets its own answer."""
    async def main():
        bus = messenger.Messenger()
        mons = monitor.MonCluster(3, bus, tick=False)
        leader = await mons.form_quorum()
        replies = []

        async def client(src, msg):
            replies.append(msg)

        bus.register("client.x", client)
        base = {"type": "mon_command", "reqid": ["client.x", 3, 1]}
        for i, cmd in enumerate([
                {"prefix": "config-key set", "key": "k", "value": "1"},
                {"prefix": "status"},
                {"prefix": "config-key set", "key": "k", "value": "2"},
                {"prefix": "config-key set", "key": "k", "value": "1"}]):
            await leader._handle_command("client.x",
                                         dict(base, id=i, cmd=cmd))
        for _ in range(50):
            if len(replies) == 4:
                break
            await asyncio.sleep(0.01)
        out = (sorted((r["id"], r["rc"], r["out"]) for r in replies
                      if r["id"] != 1),
               [r["out"] for r in replies if r["id"] == 1],
               [m.kvstore.kv.get("k") for m in mons.mons])
        await bus.shutdown()
        return out

    replies, status, values = _run(main())
    assert replies == [(0, 0, ""), (2, 0, ""), (3, 0, "")], replies
    assert len(status) == 1 and isinstance(status[0], dict), status
    # the fourth send repeats the first command under its reqid: the
    # record answers it and nothing is applied, so "2" stays
    assert values == ["2", "2", "2"], values


def test_a_replayed_reqid_does_not_bypass_the_cap_check():
    """An entity without mon admin caps sends an admin's ``auth
    get-or-create`` reqid, to the leader and through a peon, and gets
    -13, not the key; nor does its own recorded mutation answer from the
    record once its caps are cut."""
    async def main():
        bus = messenger.Messenger()
        mons = monitor.MonCluster(3, bus, tick=False)
        await mons.form_quorum()
        (admin,) = _clients(bus, "client.admin", 1)
        mint = {"prefix": "auth get-or-create", "entity": "client.q",
                "caps": {"mon": "allow *"}}
        minted = await admin.command(mint)
        replies = {}

        async def eve(src, msg):
            replies[msg["id"]] = (msg["rc"], msg["out"])

        bus.register("client.eve", eve)
        # eve, not yet in the AuthDB, holds the open default and mints
        own = {"prefix": "auth get-or-create", "entity": "client.e2"}
        await bus.send_message("client.eve", "mon.0", {
            "type": "mon_command", "cmd": own, "id": 1,
            "reqid": ["client.eve", 9, 1]})
        for _ in range(100):
            if 1 in replies:
                break
            await asyncio.sleep(0.01)
        capped = await admin.command({
            "prefix": "auth get-or-create", "entity": "client.eve",
            "caps": {"mon": "allow r"}})
        stolen = {"type": "mon_command", "cmd": mint,
                  "reqid": ["client.admin", admin.incarnation, 1]}
        await bus.send_message("client.eve", "mon.0", dict(stolen, id=2))
        await bus.send_message("client.eve", "mon.1", dict(stolen, id=3))
        await bus.send_message("client.eve", "mon.1", {
            "type": "mon_command", "cmd": own, "id": 4,
            "reqid": ["client.eve", 9, 1]})
        for _ in range(100):
            if len(replies) == 4:
                break
            await asyncio.sleep(0.01)
        await bus.shutdown()
        return minted, replies[1], capped, [replies.get(i)
                                            for i in (2, 3, 4)]

    minted, own, capped, denied = _run(main())
    assert minted[0] == 0 and minted[1]["entity"] == "client.q", minted
    assert own[0] == 0 and capped[0] == 0, (own, capped)
    for rc, out in denied:
        assert rc == -13 and "access denied" in out, denied
        assert minted[1]["key"] not in out and own[1]["key"] not in out


def test_commands_answered_in_time_match_jax():
    """The JAX package's answers and osdmap for a script of mutating and
    read-only commands, each answered within the client's 2 s default
    wait: three mons on the in-process bus, no OSD daemon (so no
    subscriber remaps and no lease ticks hold a reply back)."""
    script = [
        {"prefix": "osd create", "n": 3},
        {"prefix": "osd add", "osd": 3},
        {"prefix": "osd add", "osd": 3},
        {"prefix": "osd erasure-code-profile set", "name": "p2",
         "profile": {"plugin": "jerasure", "k": "2", "m": "1"}},
        {"prefix": "osd pool create", "name": "pool2", "profile": "p2"},
        {"prefix": "osd pool create", "name": "pool2", "profile": "p2"},
        {"prefix": "osd out", "osd": 3},
        {"prefix": "osd in", "osd": 3},
        {"prefix": "config set", "who": "osd", "name": "debug_osd",
         "value": "5"},
        {"prefix": "config-key set", "key": "k", "value": "v"},
        {"prefix": "config-key rm", "key": "k"},
        {"prefix": "log", "message": "hello", "level": "info"},
        {"prefix": "fs new", "name": "fs1"},
        {"prefix": "fs new", "name": "fs1"},
        {"prefix": "osd rm", "osd": 3},
        {"prefix": "osd rm", "osd": 3},
        {"prefix": "status"},
    ]

    async def main(mon_mod, messenger_mod):
        bus = messenger_mod.Messenger()
        mons = mon_mod.MonCluster(3, bus, tick=False)
        leader = await mons.form_quorum()
        monc = mon_mod.MonClient(bus, 3, "client.t")

        async def client(src, msg):
            await monc.handle_reply(msg)

        bus.register("client.t", client)
        log = [await monc.command(cmd) for cmd in script]
        out = log, leader.osdmap.to_dict(), leader.fsmap.to_dict()
        await bus.shutdown()
        return out

    from ceph_tpu.mon import monitor as j_monitor
    from ceph_tpu.osd import messenger as j_messenger

    port = _run(main(monitor, messenger))
    jax = _run(main(j_monitor, j_messenger))
    assert port == jax
    log = port[0]
    assert log[1][0] == 0 and log[2][0] == -17 and log[5][0] == -17
    assert log[14][0] == 0 and log[15][0] == -2
