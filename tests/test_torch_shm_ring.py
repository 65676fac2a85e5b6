"""The port's shared-memory frame rings (``msg/shm_ring.py``) against the
JAX package's.

The cases of the JAX package's ``tests/test_shm_ring.py`` run on both
packages: the same records pushed and popped through wraparound leave
byte-identical ring buffers (header and data) after every step; a torn
record, a stuck odd seqlock and an impossible length each raise
``RingTear`` in both; the stream adapters carry bytes, EOF and aborts
alike; and at the messenger level colocated daemons ride rings with
stores byte-identical to TCP mode (and to the JAX package's), an
injected ring tear and a mid-burst connection kill both heal through
session replay.  Records are made with numpy from a seed.
"""

from __future__ import annotations

import asyncio
import struct
import types

import numpy as np
import pytest

from ceph_tpu.msg import shm_ring as j_ring
from ceph_tpu_torch.msg import shm_ring
from ceph_tpu_torch.msg.cluster_bench import (ClusterHarness, make_payloads,
                                              python_wire_codec)
from ceph_tpu_torch.utils.config import get_config

PORT = types.SimpleNamespace(name="port", ring=shm_ring)
JAX = types.SimpleNamespace(name="jax", ring=j_ring)
BOTH = (PORT, JAX)


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
    it cannot, this file's loops run under asyncio's default policy."""
    if _policy_runs_tasks():
        yield
        return
    saved = asyncio.get_event_loop_policy()
    asyncio.set_event_loop_policy(asyncio.DefaultEventLoopPolicy())
    yield
    asyncio.set_event_loop_policy(saved)


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _records(seed, n=200, unit=131):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size=unit * int(rng.randint(1, 10)),
                        dtype=np.uint8).tobytes() for _ in range(n)]


# -- ring level --------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_ring_bytes_identical_through_wraparound(seed):
    msgs = _records(seed)
    rings = [P.ring.ShmRing(1 << 12) for P in BOTH]  # tiny: wraps often
    outs = [[], []]
    for m in msgs:
        for ring, out in zip(rings, outs):
            while not ring.try_push(m):
                out.append(ring.pop())
        assert bytes(rings[0]._buf) == bytes(rings[1]._buf)
    for ring, out in zip(rings, outs):
        while (r := ring.pop()) is not None:
            out.append(r)
    assert outs[0] == outs[1] == msgs
    assert bytes(rings[0]._buf) == bytes(rings[1]._buf)
    for ring in rings:
        assert ring.pushes == ring.pops == len(msgs)
        assert ring.bytes_pushed == sum(len(m) for m in msgs)
        assert 0 < ring.hwm_used <= ring.capacity
        assert ring.tears == 0
    assert rings[0].hwm_used == rings[1].hwm_used


@pytest.mark.parametrize("P", BOTH, ids=lambda P: P.name)
def test_ring_backpressure_and_oversize(P):
    ring = P.ring.ShmRing(1 << 10)
    assert ring.try_push(b"a" * 900)
    assert not ring.try_push(b"b" * 900)  # refused, nothing written
    with pytest.raises(ValueError):
        ring.try_push(b"c" * (ring.capacity + 1))
    assert ring.pop() == b"a" * 900
    assert ring.pop() is None
    assert ring.try_push(b"b" * 900)
    assert ring.pop() == b"b" * 900
    with pytest.raises(ValueError):
        P.ring.ShmRing(4)


def test_torn_record_same_bytes_and_ring_tear():
    """A producer crash mid-memcpy: the same torn ring in both packages,
    records already out served intact, then ``RingTear``."""
    rings = []
    for P in BOTH:
        ring = P.ring.ShmRing(1 << 12)
        assert ring.try_push(b"clean-record")
        assert ring.try_push(b"x" * 512, torn=True)
        rings.append(ring)
    assert bytes(rings[0]._buf) == bytes(rings[1]._buf)
    for P, ring in zip(BOTH, rings):
        assert ring.pop() == b"clean-record"
        with pytest.raises(P.ring.RingTear):
            ring.pop()
        assert ring.tears == 1
    assert issubclass(shm_ring.RingTear, ConnectionResetError)


@pytest.mark.parametrize("P", BOTH, ids=lambda P: P.name)
def test_stuck_odd_seqlock_surfaces_ring_tear(P):
    ring = P.ring.ShmRing(1 << 12)
    ring.try_push(b"whatever")
    head, tail, wseq = struct.unpack_from("<QQQ", ring._buf, 0)
    struct.pack_into("<QQQ", ring._buf, 0, head, tail, wseq + 1)
    with pytest.raises(P.ring.RingTear):
        ring.pop()
    assert ring.tears == 1


@pytest.mark.parametrize("P", BOTH, ids=lambda P: P.name)
def test_impossible_length_surfaces_ring_tear(P):
    ring = P.ring.ShmRing(1 << 12)
    ring.try_push(b"y" * 64)
    struct.pack_into("<I", ring._buf, 24, 1 << 30)
    with pytest.raises(P.ring.RingTear):
        ring.pop()


@pytest.mark.parametrize("P", BOTH, ids=lambda P: P.name)
def test_conduit_stream_adapters_roundtrip_eof_abort(P):
    async def main():
        accepted = []
        P.ring.register(("t-ring", 7), lambda r, w: accepted.append((r, w)),
                        ring_bytes=1 << 16)
        try:
            client = P.ring.connect(("t-ring", 7))
            assert client is not None
            cr, cw = client
            sr, sw = accepted[0]
            cw.writelines([b"he", b"llo", b" ring"])
            await cw.drain()
            assert await sr.readexactly(10) == b"hello ring"
            big_read = asyncio.ensure_future(cr.readexactly(70000))
            sw.write(b"A" * 70000)
            await sw.drain()
            assert await big_read == b"A" * 70000
            cw.close()
            assert await sr.read(1) == b""  # clean EOF, not an error
            sw.transport.abort()
            with pytest.raises(ConnectionResetError):
                await cr.read(1)
        finally:
            P.ring.unregister(("t-ring", 7))

    run(main())


def test_drain_waits_for_room_the_record_needs():
    """A record larger than the ring's free space: ``drain`` waits for
    the consumer instead of spinning (the JAX package's writer re-loops
    on any free byte and never yields to a consumer on the same loop, so
    this case runs on the port alone)."""
    async def main():
        accepted = []
        shm_ring.register(("t-room", 1), lambda r, w: accepted.append((r, w)),
                          ring_bytes=4096)
        try:
            cr, cw = shm_ring.connect(("t-room", 1))
            sr, _sw = accepted[0]
            first, second = b"a" * 3000, b"b" * 3000
            cw.write(first)
            cw.write(second)  # 1088 bytes free: the record waits
            assert cw._pending and cw._c.rings[0].free() > 8
            reader = asyncio.ensure_future(sr.readexactly(6000))
            await asyncio.wait_for(cw.drain(), 5)
            assert await asyncio.wait_for(reader, 5) == first + second
        finally:
            shm_ring.unregister(("t-room", 1))

    run(main())


def test_records_waiting_for_room_go_out_without_a_drain():
    """Records a full ring refused are pushed by the writer's flusher as
    the consumer frees room, with no ``drain`` call (a socket transport
    sends its buffer the same way), and ``close()`` closes the direction
    after the last of them: the reader gets every byte, then EOF."""
    async def main():
        accepted = []
        shm_ring.register(("t-flush", 1),
                          lambda r, w: accepted.append((r, w)),
                          ring_bytes=4096)
        try:
            cr, cw = shm_ring.connect(("t-flush", 1))
            sr, _sw = accepted[0]
            payload = [bytes([i]) * 2500 for i in range(4)]
            for rec in payload:
                cw.write(rec)
            assert len(cw._pending) == 3
            got = await asyncio.wait_for(sr.readexactly(10000), 5)
            assert got == b"".join(payload) and not cw._pending
            cw.write(b"x" * 3000)
            cw.write(b"y" * 3000)  # waits: nobody reads now
            flusher = cw._flusher
            assert flusher is not None and not flusher.done()
            cw.close()
            assert cw.is_closing() and not cw._c.closed[0]
            with pytest.raises(ConnectionResetError):
                cw.write(b"z")
            got = await asyncio.wait_for(sr.readexactly(6000), 5)
            assert got == b"x" * 3000 + b"y" * 3000
            assert await asyncio.wait_for(sr.read(1), 5) == b""  # EOF
            assert flusher.done() and cw._c.closed[0]
        finally:
            shm_ring.unregister(("t-flush", 1))

    run(main())


@pytest.mark.parametrize("P", BOTH, ids=lambda P: P.name)
def test_connect_unregistered_falls_back_none(P):
    assert P.ring.connect(("nobody-home", 1)) is None


def test_default_ring_bytes_and_smoke():
    assert shm_ring.DEFAULT_RING_BYTES == j_ring.DEFAULT_RING_BYTES
    assert shm_ring.main(["--smoke"]) == 0


# -- messenger level ---------------------------------------------------------


class _Config:
    def __init__(self, **overrides):
        self.overrides = overrides

    def __enter__(self):
        self.cfg = get_config()
        self.prior = {k: self.cfg.get_val(k) for k in self.overrides}
        self.cfg.apply_changes(dict(self.overrides))
        return self

    def __exit__(self, *exc):
        self.cfg.apply_changes(self.prior)
        return False


def _ec():
    from ceph_tpu_torch.plugins import registry as registry_mod

    return registry_mod.instance().factory(
        "cuda", {"k": "2", "m": "1", "technique": "reed_sol_van",
                 "device": "cpu"})


def _j_ec():
    from ceph_tpu.plugins import registry as registry_mod

    return registry_mod.instance().factory(
        "jerasure", {"k": "2", "m": "1", "technique": "reed_sol_van"})


def test_ring_transport_end_to_end_byte_identical_to_tcp_and_jax():
    """Same payloads over ring mode and TCP mode: colocated connections
    ride rings, stores are byte-identical to TCP mode and to the JAX
    package's ring mode (run under asyncio's default policy, so the
    verifier cannot fail this test for the JAX package's own sections)."""
    payloads = make_payloads(16, 1536, seed=23)

    async def one_mode(harness_cls, ec, ring_on: bool, cfg):
        prior = cfg.get_val("osd_msgr_shm_ring")
        cfg.apply_changes({"osd_msgr_shm_ring": ring_on})
        try:
            h = harness_cls(ec, 3, cork=True, pool=f"rt{int(ring_on)}")
            await h.start()
            try:
                await h.run_writes(payloads, writers=2, batch=8)
                _, got = await h.run_reads(payloads, readers=2, batch=8)
                assert got == payloads
                counters = h.wire_counters()
                if ring_on:
                    assert counters.get("ring_conns", 0) > 0
                else:
                    assert counters.get("ring_conns", 0) == 0
                    assert counters.get("tcp_conns", 0) > 0
                return h.shard_bytes()
            finally:
                await h.shutdown()
        finally:
            cfg.apply_changes({"osd_msgr_shm_ring": prior})

    async def port():
        tcp = await one_mode(ClusterHarness, _ec(), False, get_config())
        ring = await one_mode(ClusterHarness, _ec(), True, get_config())
        return tcp, ring

    with python_wire_codec():
        tcp, ring = run(port())
    assert tcp == ring, "ring transport stored different bytes"

    from ceph_tpu.msg.cluster_bench import ClusterHarness as JHarness
    from ceph_tpu.utils.config import get_config as j_get_config

    saved = asyncio.get_event_loop_policy()
    asyncio.set_event_loop_policy(asyncio.DefaultEventLoopPolicy())
    try:
        jring = run(one_mode(JHarness, _j_ec(), True, j_get_config()))
    finally:
        asyncio.set_event_loop_policy(saved)
    assert ring == jring, "the port's ring stored other bytes than JAX's"


def test_ring_tear_heals_through_session_replay():
    payloads = make_payloads(12, 1024, seed=31)

    async def main():
        with _Config(osd_msgr_shm_ring=True):
            h = ClusterHarness(_ec(), 3, cork=True, pool="rtear")
            await h.start()
            try:
                assert h.client.fault is not None
                h.client.fault.schedule_ring_tear(after_records=3)
                await h.run_writes(payloads, writers=2, batch=6)
                assert h.client.fault.ring_tears == 1, \
                    "tear never fired (armed countdown unconsumed)"
                _, got = await h.run_reads(payloads, readers=2, batch=6)
                assert got == payloads
                assert h.wire_counters().get("ring_conns", 0) > 0
            finally:
                await h.shutdown()

    with python_wire_codec():
        run(main())


def test_conn_kill_over_ring_heals_like_tcp():
    payloads = make_payloads(12, 1024, seed=37)

    async def main():
        with _Config(osd_msgr_shm_ring=True):
            h = ClusterHarness(_ec(), 3, cork=True, pool="rkill")
            await h.start()
            try:
                h.client.fault.schedule_conn_kill(after_frames=5)
                await h.run_writes(payloads, writers=2, batch=6)
                _, got = await h.run_reads(payloads, readers=2, batch=6)
                assert got == payloads
                assert h.client.fault.conn_kills == 1
            finally:
                await h.shutdown()

    with python_wire_codec():
        run(main())
