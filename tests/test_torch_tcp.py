"""The port's TCP messenger (``msg/tcp.py``) and dispatch throttle
(``utils/throttle.py``).

Mirrors, on the port, the JAX package's TCP cases: replay across an
outage, dedup of replayed duplicates and lossy client connections
(``tests/test_messenger.py``); a mid-burst kill replayed in exact
sequence with and without cork, no standalone acks on a busy duplex,
digests once per burst element (``tests/test_msgr_cork.py``); the
dispatch throttle backpressuring without deadlock
(``tests/test_common.py``); the envelope head cache
(``tests/test_mesh_plane.py``); the reqid riding the wire
(``tests/test_exactly_once.py``).  Where a frame stream is
deterministic -- a queued message's frames with and without the
piggyback ack and the signature, the banner, the ack and session frames
-- the port's bytes are compared with the JAX package's, and a port
messenger and a JAX package messenger exchange lossless, signed streams
over one socket.  The throttle runs the same script in both packages.
Every case runs the Python wire codec (``osd_wire_codec_native=false``)
but the codec-gate case: a default configuration runs the native C codec
and puts the Python codec's bytes on the wire
(``tests/test_torch_wire_native.py`` drives that codec through every
seam).
"""

import asyncio
import collections
import os
import socket

import numpy as np
import pytest
import torch

from ceph_tpu.msg import tcp as j_tcp
from ceph_tpu.utils import throttle as j_throttle
from ceph_tpu.utils.encoding import frame as j_frame
from ceph_tpu_torch import parallel
from ceph_tpu_torch.auth.cephx import KeyRing, sign, sign_parts, verify
from ceph_tpu_torch.msg import FaultInjector, TCPMessenger
from ceph_tpu_torch.msg import tcp
from ceph_tpu_torch.native import wire_codec
from ceph_tpu_torch.native.gf_native import crc32c
from ceph_tpu_torch.utils import throttle
from ceph_tpu_torch.utils.config import get_config
from ceph_tpu_torch.utils.encoding import (Encoder, crc32c_parts, frame,
                                           frame_parts, unframe)
from torch_verify import port_verifiers, verifying_policy


@pytest.fixture(autouse=True)
def _loop_policy():
    """Both packages' loops run under the port's verifiers
    (``tests/torch_verify.py``): its atomic-section verifier, which holds
    both packages' sections, and its residency verifier."""
    with port_verifiers():
        yield


@pytest.fixture(autouse=True)
def _python_codec():
    cfg = get_config()
    prior = cfg.get_val("osd_wire_codec_native")
    cfg.set_val("osd_wire_codec_native", False)
    yield
    cfg.set_val("osd_wire_codec_native", prior)


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _pair(cork=None, keyring=None):
    pa, pb = _free_ports(2)
    addr = {"osd.0": ("127.0.0.1", pa), "osd.1": ("127.0.0.1", pb)}
    a = TCPMessenger("osd.0", addr, fault=FaultInjector(), cork=cork,
                     keyring=keyring)
    b = TCPMessenger("osd.1", addr, fault=FaultInjector(), cork=cork,
                     keyring=keyring)
    return a, b


async def _until(pred, rounds=100, step=0.05):
    for _ in range(rounds):
        if pred():
            return True
        await asyncio.sleep(step)
    return pred()


# -- the native-codec gate ----------------------------------------------------


def test_default_config_refuses_naming_16b():
    """The codec gate (the name is the one the case had while the port
    refused the native codec): a default-config messenger runs the native
    codec, and its frames -- per entry with and without the piggyback
    ack, and a burst sealed in one C call -- equal the Python codec's
    byte for byte.  ``native`` off alone, or the option off, runs the
    Python codec, as the JAX package does."""
    cfg = get_config()
    addr = {"osd.0": ("127.0.0.1", 1)}
    cfg.set_val("osd_wire_codec_native", True)
    assert cfg.get_val("native") is True
    nat = TCPMessenger("osd.0", addr)
    assert nat._native is not None and nat._native is wire_codec.native()
    cfg.set_val("native", False)
    try:
        assert TCPMessenger("osd.0", addr)._native is None
    finally:
        cfg.set_val("native", True)
    cfg.set_val("osd_wire_codec_native", False)
    py = TCPMessenger("osd.0", addr)
    assert py._native is None
    rs = np.random.RandomState(16)
    msgs = ["heartbeat", ("committed", 17), {"k": [1, 2], "n": None},
            {"op": "client_op", "tid": 5,
             "data": rs.randint(0, 256, 70000, dtype=np.uint8).tobytes()},
            rs.randint(0, 256, 300, dtype=np.uint8).tobytes()]
    n_entries = [nat._msg_entry("osd.0", "osd.1", i + 1, m)
                 for i, m in enumerate(msgs)]
    p_entries = [py._msg_entry("osd.0", "osd.1", i + 1, m)
                 for i, m in enumerate(msgs)]
    assert all(e.crc is not None for e in n_entries)  # folded at encode
    for ack in (0, 77):
        for ne, pe in zip(n_entries, p_entries):
            assert b"".join(bytes(b) for b in nat._entry_frames(
                ne, None, ack)) == b"".join(bytes(b) for b in py._entry_frames(
                    pe, None, ack))
        bufs, nbytes = nat._native.seal_frames(n_entries, ack)
        want = b"".join(
            bytes(b) for i, e in enumerate(p_entries)
            for b in py._entry_frames(
                e, None, ack if i == len(p_entries) - 1 else 0))
        assert b"".join(bytes(b) for b in bufs) == want
        assert nbytes == len(want)


# -- tests/test_messenger.py -------------------------------------------------


def test_lossless_peer_replays_across_outage():
    async def main():
        a, b = _pair()
        await a.start()
        await b.start()
        got = []

        async def sink(src, msg):
            got.append(msg)

        b.register("osd.1", sink)
        for i in range(3):
            await a.send_message("osd.0", "osd.1", f"m{i}")
        await _until(lambda: len(got) == 3)
        assert got == ["m0", "m1", "m2"]
        conn = a._conns.pop("osd.1", None)
        if conn is not None:
            conn[1].close()
        await asyncio.sleep(0.1)
        b._server.close()
        await b._server.wait_closed()
        for i in range(3, 7):
            await a.send_message("osd.0", "osd.1", f"m{i}")
        await asyncio.sleep(0.3)
        assert got == ["m0", "m1", "m2"]  # nothing lost, nothing dup'd
        assert a._sessions["osd.1"].sent  # queued for replay
        await b.start()
        await _until(lambda: got == [f"m{i}" for i in range(7)], 60, 0.1)
        assert got == [f"m{i}" for i in range(7)]
        await a.send_message("osd.0", "osd.1", "tail")
        await _until(lambda: not a._sessions["osd.1"].sent)
        assert not a._sessions["osd.1"].sent
        await a.shutdown()
        await b.shutdown()

    _run(main())


def test_lossless_receiver_dedups_replayed_duplicates():
    async def main():
        a, b = _pair()
        await a.start()
        await b.start()
        got = []

        async def sink(src, msg):
            got.append(msg)

        b.register("osd.1", sink)
        for i in range(4):
            await a.send_message("osd.0", "osd.1", f"d{i}")
        await _until(lambda: len(got) == 4)
        assert got == ["d0", "d1", "d2", "d3"]
        sess = a._sessions["osd.1"]
        sess.acked = 0
        sess.sent = collections.deque(
            a._msg_entry("osd.0", "osd.1", seq, f"d{seq - 1}")
            for seq in range(1, 5))
        sess.sent_bytes = sum(e.nbytes for e in sess.sent)
        conn = a._conns.pop("osd.1", None)
        if conn is not None:
            conn[1].close()
        await a.send_message("osd.0", "osd.1", "d4")  # triggers establish
        await asyncio.sleep(0.4)
        assert got == ["d0", "d1", "d2", "d3", "d4"]  # no duplicates
        await a.shutdown()
        await b.shutdown()

    _run(main())


def test_client_connections_stay_lossy():
    async def main():
        pa, pb = _free_ports(2)
        addr = {"client": ("127.0.0.1", pa), "osd.1": ("127.0.0.1", pb)}
        c = TCPMessenger("client", addr)
        await c.start()
        await c.send_message("client", "osd.1", "gone")
        assert not c._sessions
        assert c.is_down("osd.1")
        await c.shutdown()

    _run(main())


# -- tests/test_msgr_cork.py -------------------------------------------------


@pytest.mark.parametrize("cork", [True, False], ids=["corked", "per-msg"])
def test_mid_burst_conn_kill_replays_sequence_exact(cork):
    async def main():
        a, b = _pair(cork)
        await a.start()
        await b.start()
        got = []

        async def sink(src, msg):
            got.append(msg)

        b.register("osd.1", sink)
        for i in range(4):
            await a.send_message("osd.0", "osd.1", f"m{i}")
        await _until(lambda: len(got) == 4, 40)
        assert got == [f"m{i}" for i in range(4)]
        a.fault.schedule_conn_kill(2)
        await a.send_messages(
            "osd.0", [("osd.1", f"m{i}") for i in range(4, 12)])
        await _until(lambda: len(got) == 12)
        assert got == [f"m{i}" for i in range(12)]  # exact, no dups
        assert a.fault.conn_kills == 1
        await a.send_message("osd.0", "osd.1", "tail")
        await _until(lambda: not a._sessions["osd.1"].sent, 60)
        assert not a._sessions["osd.1"].sent
        await a.shutdown()
        await b.shutdown()

    _run(main())


@pytest.mark.parametrize("cork", [True, False], ids=["corked", "per-msg"])
def test_replay_across_outage_with_and_without_cork(cork):
    async def main():
        a, b = _pair(cork)
        await a.start()
        await b.start()
        got = []

        async def sink(src, msg):
            got.append(msg)

        b.register("osd.1", sink)
        for i in range(3):
            await a.send_message("osd.0", "osd.1", f"r{i}")
        await _until(lambda: len(got) == 3, 40)
        assert got == ["r0", "r1", "r2"]
        conn = a._conns.pop("osd.1", None)
        if conn is not None:
            conn[1].close()
        await asyncio.sleep(0.1)
        b._server.close()
        await b._server.wait_closed()
        for i in range(3, 6):
            await a.send_message("osd.0", "osd.1", f"r{i}")
        await asyncio.sleep(0.3)
        assert got == ["r0", "r1", "r2"]
        assert a._sessions["osd.1"].sent
        await b.start()
        await _until(lambda: got == [f"r{i}" for i in range(6)], 80, 0.1)
        assert got == [f"r{i}" for i in range(6)]
        await a.shutdown()
        await b.shutdown()

    _run(main())


def test_busy_duplex_stream_has_no_standalone_acks():
    async def main():
        a, b = _pair(True)
        await a.start()
        await b.start()
        rounds = 150
        done = asyncio.get_event_loop().create_future()
        received = [0]

        async def echo(src, msg):
            await b.send_message("osd.1", src, ("reply", msg[1]))

        async def collect(src, msg):
            received[0] += 1
            if received[0] >= rounds and not done.done():
                done.set_result(True)

        b.register("osd.1", echo)
        a.register("osd.0", collect)
        for i in range(rounds):
            await a.send_message("osd.0", "osd.1", ("req", i))
            if i % 10 == 0:
                await asyncio.sleep(0)
        await asyncio.wait_for(done, 30)
        stand = a.counters["acks_standalone"] + b.counters["acks_standalone"]
        piggy = a.counters["acks_piggybacked_recv"] + \
            b.counters["acks_piggybacked_recv"]
        assert stand == 0, (dict(a.counters), dict(b.counters))
        assert piggy > 0
        await _until(lambda: not a._sessions["osd.1"].sent
                     and not b._sessions["osd.0"].sent, 80)
        assert not a._sessions["osd.1"].sent
        assert not b._sessions["osd.0"].sent
        await a.shutdown()
        await b.shutdown()

    _run(main())


def test_digests_once_per_burst_element_and_equivalent():
    rng = np.random.RandomState(5)
    big = rng.randint(0, 256, size=16384, dtype=np.uint8).tobytes()
    parts = [b"head", big, b"tail"]
    joined = b"".join(parts)
    assert crc32c_parts(parts) == crc32c(joined)
    assert crc32c(b"tail", crc32c(b"head" + big)) == crc32c(joined)
    assert b"".join(frame_parts(parts)) == frame(joined) == j_frame(joined)
    rec, _pos = unframe(b"".join(frame_parts(parts)), 0)
    assert rec == joined
    key = b"k" * 32
    assert sign_parts(key, parts) == sign(key, joined)
    assert verify(key, joined, sign_parts(key, parts))
    entry = tcp._QueuedMsg(7, list(parts))
    ack = 12345
    m = TCPMessenger.__new__(TCPMessenger)  # no loop needed for framing
    bufs = m._entry_frames(entry, key, ack)
    sealed = joined + tcp._varint_bytes(ack)
    sealed = sealed + sign(key, sealed)
    assert b"".join(bytes(p) for p in bufs) == frame(sealed)
    assert entry.crc == crc32c(joined)  # cached once, payload-only
    bufs2 = m._entry_frames(entry, None, 0)
    assert b"".join(bytes(p) for p in bufs2) == frame(joined)
    # the JAX package's seal of the same entry, byte for byte
    j_entry = j_tcp._QueuedMsg(7, list(parts))
    jm = j_tcp.TCPMessenger.__new__(j_tcp.TCPMessenger)
    assert b"".join(bytes(p) for p in jm._entry_frames(j_entry, key, ack)) \
        == b"".join(bytes(p) for p in bufs)


# -- deterministic frames against the JAX package's ---------------------------


def _corpus(mod_types, seed):
    rng = np.random.RandomState(seed)
    T = mod_types
    return [
        "ping", ("reply", 3), {"op": "client_op", "tid": 4,
                               "data": rng.bytes(9000)},
        T.ECSubWrite(from_shard=2, tid=9, oid="o",
                     transaction=T.Transaction().write(
                         "o@2", 0, rng.bytes(int(rng.randint(1, 20000)))),
                     at_version=(1, "client"), reqid=("client", 1, 1)),
        T.ECSubWriteReply(from_shard=2, tid=9, committed=True),
    ]


@pytest.mark.parametrize("seed", [0, 1])
def test_queued_frames_equal_jax(seed):
    """A queued message's transmit frames (with and without the
    piggyback ack and the signature) are the JAX package's bytes."""
    from ceph_tpu.osd import types as j_types
    from ceph_tpu_torch.osd import types as t_types

    m = TCPMessenger("osd.0", {"osd.0": ("127.0.0.1", 1)})
    jm = j_tcp.TCPMessenger.__new__(j_tcp.TCPMessenger)
    jm._head_cache, jm._native = {}, None
    key = np.random.RandomState(seed).bytes(32)
    for seq, (mine, theirs) in enumerate(
            zip(_corpus(t_types, seed), _corpus(j_types, seed)), 1):
        e = m._msg_entry("osd.0", "osd.3", seq, mine)
        je = jm._msg_entry("osd.0", "osd.3", seq, theirs)
        assert b"".join(map(bytes, e.parts)) == \
            b"".join(map(bytes, je.parts))
        assert e.nbytes == je.nbytes
        for skey, ack in ((None, 0), (None, 77), (key, 0), (key, 1 << 20)):
            assert b"".join(map(bytes, m._entry_frames(e, skey, ack))) == \
                b"".join(map(bytes, jm._entry_frames(je, skey, ack)))
        assert tcp.TCPMessenger._join_entry(e) == \
            j_tcp.TCPMessenger._join_entry(je)
    assert m._head_cache == jm._head_cache
    assert tcp._varint_bytes(300) == j_tcp._varint_bytes(300)
    for skey in (None, key):
        assert TCPMessenger._seal(b"payload", skey) == \
            j_tcp.TCPMessenger._seal(b"payload", skey)
    assert (tcp._PROTOCOL_VERSION, tcp._MIN_PROTOCOL_VERSION, tcp._BANNER,
            tcp._SIG_LEN, tcp._K_MSG, tcp._K_ACK, tcp._K_SESSION) == \
        (j_tcp._PROTOCOL_VERSION, j_tcp._MIN_PROTOCOL_VERSION,
         j_tcp._BANNER, j_tcp._SIG_LEN, j_tcp._K_MSG, j_tcp._K_ACK,
         j_tcp._K_SESSION)


def _jax_pair_config(on: bool):
    from ceph_tpu.utils.config import get_config as j_get_config

    cfg = j_get_config()
    prior = cfg.get_val("osd_wire_codec_native")
    cfg.set_val("osd_wire_codec_native", on)
    return cfg, prior


@pytest.mark.parametrize("signed", [False, True], ids=["plain", "cephx"])
def test_port_and_jax_messengers_share_a_socket(signed):
    """A port messenger and a JAX package messenger, each an OSD, run the
    banner, the handshake and lossless sessions both ways over real
    sockets: every message arrives once and in order, and acks drain
    both unacked queues.  The loop runs under the port's verifying
    policy (the JAX package's messenger runs in it)."""
    from ceph_tpu.auth.cephx import KeyRing as JKeyRing
    from ceph_tpu.msg.fault import FaultInjector as JFaultInjector

    keys = {"osd.0": os.urandom(32), "osd.1": os.urandom(32)}
    pa, pb = _free_ports(2)
    addr = {"osd.0": ("127.0.0.1", pa), "osd.1": ("127.0.0.1", pb)}
    jcfg, prior = _jax_pair_config(False)

    async def main():
        a = TCPMessenger("osd.0", addr, fault=FaultInjector(),
                         keyring=KeyRing(keys) if signed else None)
        b = j_tcp.TCPMessenger("osd.1", addr, fault=JFaultInjector(),
                               keyring=JKeyRing(keys) if signed else None)
        await a.start()
        await b.start()
        at_a, at_b = [], []

        async def sink_a(src, msg):
            at_a.append(msg)

        async def sink_b(src, msg):
            at_b.append(msg)
            await b.send_message("osd.1", "osd.0", ("echo", msg))

        a.register("osd.0", sink_a)
        b.register("osd.1", sink_b)
        sent = [f"m{i}" for i in range(40)] + [b"x" * 70000, {"k": [1, 2]}]
        for msg in sent:
            await a.send_message("osd.0", "osd.1", msg)
        await _until(lambda: len(at_a) == len(sent), 100)
        await _until(lambda: not a._sessions["osd.1"].sent
                     and not b._sessions["osd.0"].sent, 80)
        out = (list(at_b), list(at_a), bool(a._sessions["osd.1"].sent),
               bool(b._sessions["osd.0"].sent))
        await a.shutdown()
        await b.shutdown()
        return sent, out

    saved = asyncio.get_event_loop_policy()
    asyncio.set_event_loop_policy(verifying_policy())
    try:
        sent, (at_b, at_a, a_left, b_left) = _run(main())
    finally:
        asyncio.set_event_loop_policy(saved)
        jcfg.set_val("osd_wire_codec_native", prior)
    assert at_b == sent
    assert at_a == [("echo", m) for m in sent]
    assert not a_left and not b_left


def test_signed_frames_refuse_a_wrong_key():
    """A peer without the right key is refused at the handshake: the
    send is dropped and the peer marked unreachable, nothing delivered."""
    async def main():
        pa, pb = _free_ports(2)
        addr = {"client": ("127.0.0.1", pa), "osd.1": ("127.0.0.1", pb)}
        server_ring = KeyRing({"client": os.urandom(32)})
        client_ring = KeyRing({"client": os.urandom(32)})
        b = TCPMessenger("osd.1", addr, keyring=server_ring)
        c = TCPMessenger("client", addr, keyring=client_ring)
        await b.start()
        await c.start()
        got = []

        async def sink(src, msg):
            got.append(msg)

        b.register("osd.1", sink)
        await c.send_message("client", "osd.1", "hello")
        await asyncio.sleep(0.3)
        down = c.is_down("osd.1")
        await c.shutdown()
        await b.shutdown()
        return got, down

    got, down = _run(main())
    assert got == [] and down


# -- tests/test_common.py: the dispatch throttle ------------------------------


def test_tcp_dispatch_throttle_backpressures_without_deadlock():
    async def main():
        pa, pb = _free_ports(2)
        addr = {"a": ("127.0.0.1", pa), "b": ("127.0.0.1", pb)}
        ma = TCPMessenger("a", addr)
        mb = TCPMessenger("b", addr)
        await ma.start()
        await mb.start()
        mb.dispatch_throttle.set_max(5000)
        got = []
        done = asyncio.Event()

        async def dispatch(src, msg):
            got.append(msg)
            await asyncio.sleep(0.002)  # slow consumer holds budget
            if len(got) == 20:
                done.set()

        mb.register("b", dispatch)
        ma.register("a", lambda s, m: asyncio.sleep(0))
        for i in range(20):
            await ma.send_message(
                "a", "b", {"op": "client_op", "n": i, "pad": b"x" * 2000})
        await asyncio.wait_for(done.wait(), 10.0)
        assert [m["n"] for m in got] == list(range(20))
        assert mb.dispatch_throttle.n_waits > 0  # it really throttled
        assert mb.dispatch_throttle.count == 0   # all budget returned
        await ma.shutdown()
        await mb.shutdown()

    _run(main())


def test_throttle_script_matches_jax():
    """FIFO grants, oversized requests, cancellation and the backoff
    ramp: the same script, the same grants and counters in both."""
    async def script(mod):
        log = []
        t = mod.Throttle("t", 10)
        await t.get(6)
        log.append(t.get_or_fail(5))
        order = []

        async def taker(n, tag):
            await t.get(n)
            order.append(tag)

        tasks = [asyncio.ensure_future(taker(n, tag))
                 for n, tag in ((8, "big"), (1, "small"), (20, "huge"))]
        await asyncio.sleep(0)
        log.append((t.count, len(t._waiters)))
        t.put(6)
        await asyncio.sleep(0)
        log.append((list(order), t.count))
        t.put(9)
        await asyncio.sleep(0)
        log.append((list(order), t.count, t.past_midpoint()))
        t.put(20)
        await asyncio.gather(*tasks)
        log.append((list(order), t.count, t.n_gets, t.n_waits))
        # a cancelled waiter returns no budget it never took
        await t.get(10)
        w = asyncio.ensure_future(t.get(5))
        await asyncio.sleep(0)
        w.cancel()
        await asyncio.gather(w, return_exceptions=True)
        t.put(10)
        log.append((t.count, len(t._waiters), t.get_or_fail(10)))
        t.set_max(0)
        log.append(t.get_or_fail(1 << 30))
        b = mod.BackoffThrottle("b", 100, max_delay=0.001)
        for c in (10, 45, 30, 10):
            log.append(round(b._delay(), 9))
            await b.get(c)
        b.put(1000)
        log.append(b.count)
        return log

    mine = _run(script(throttle))
    saved = asyncio.get_event_loop_policy()
    asyncio.set_event_loop_policy(verifying_policy())
    try:
        theirs = _run(script(j_throttle))
    finally:
        asyncio.set_event_loop_policy(saved)
    assert mine == theirs
    assert mine[3][0] == ["big", "small", "huge"]


# -- tests/test_mesh_plane.py: the head cache --------------------------------


def test_head_cache_covers_mesh_delivery_frames():
    from ceph_tpu_torch.osd.types import ECSubWrite, Transaction
    from ceph_tpu_torch.parallel import mesh_plane

    parallel.configure_devices([torch.device("cpu")] * 8)
    try:
        msgr = TCPMessenger("osd.0", {"osd.0": ("127.0.0.1", 1)})
        plane = mesh_plane.configure(2)
        for i in range(4):
            txn = Transaction().write("o@1", 0, os.urandom(4096))
            sub = ECSubWrite(from_shard=1, tid=i, oid="o", transaction=txn,
                             at_version=(i, "w"))
            if i % 2:
                plane.detach_sub_write(sub)
            msgr._msg_entry("osd.0", "osd.1", i + 1, sub)
        assert len(msgr._head_cache) == 1
        assert msgr._head_cache[("osd.0", "osd.1")] == \
            Encoder().u8(tcp._K_MSG).string("osd.0").string("osd.1").bytes()
    finally:
        mesh_plane.reset()
        parallel.configure_devices(None)


# -- tests/test_exactly_once.py: the reqid rides the wire ---------------------


def test_subwrite_reqid_rides_the_wire():
    from ceph_tpu_torch.msg.wire import decode_message, encode_message
    from ceph_tpu_torch.osd.types import ECSubWrite, Transaction

    sub = ECSubWrite(
        from_shard=1, tid=7, oid="x",
        transaction=Transaction().write("x@1", 0, b"d"),
        at_version=(3, "client"), reqid=("client", 2, 9),
    )
    back = decode_message(encode_message(sub))
    assert tuple(back.reqid) == ("client", 2, 9)
    sub.reqid = None
    assert decode_message(encode_message(sub)).reqid is None

    async def main():
        a, b = _pair()
        await a.start()
        await b.start()
        got = []

        async def sink(src, msg):
            got.append(msg)

        b.register("osd.1", sink)
        sub.reqid = ("client", 4, 1)
        await a.send_message("osd.0", "osd.1", sub)
        await _until(lambda: got)
        await a.shutdown()
        await b.shutdown()
        return got

    got = _run(main())
    assert len(got) == 1 and tuple(got[0].reqid) == ("client", 4, 1)
    assert got[0].transaction.ops[0].data == b"d"
