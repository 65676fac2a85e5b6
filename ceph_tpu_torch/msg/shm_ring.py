"""Shared-memory frame rings: the byte transport between mesh-colocated
daemons.

Port of ``ceph_tpu/msg/shm_ring.py``: the same record layout, seqlock
protocol and tear semantics, over the port's crc32c
(``native/gf_native.py``) and stage ledger (``profiling/ledger.py``).
Three repairs of the writer make it carry records near the ring's size
(a 4 MiB client op on the default 4 MiB ring): ``drain`` waits for the
room the next record needs (the JAX package's spins while any byte is
free, starving the consumer on the same loop), records a full ring
refused go out by a flusher task without a ``drain`` call, and
``close()`` closes the direction only after them (the JAX package's
drops them).  The ring's bytes are the JAX package's either way.

Reference: the reference messenger's unix-domain / loopback fast paths
(msg/async/PosixStack.cc keeps the full protocol and swaps the byte
transport) and crimson's SPSC ring queues (crimson/common shared queues).
The mesh plane's DeliveryBoard proved the colocated-handoff idea for chunk
payloads; this module generalizes it to WHOLE FRAME BURSTS: everything
the TCP messenger ships -- client ops, sub-writes, acks, peering,
MgrReports -- can ride a seqlock'd shared-memory byte ring instead of the
localhost TCP hop, while the protocol layer above (banner, cephx auth,
session watermarks, cumulative acks, frame crcs, replay) runs UNCHANGED.

Design: the ring is a TRANSPORT SUBSTRATE, not a second protocol.
:class:`RingReader` / :class:`RingWriter` implement the exact asyncio
stream subset ``msg/tcp.py``'s ``TCPMessenger`` uses (``read``/``readexactly``;
``write``/``writelines``/``drain``/``close``/``is_closing``/
``transport.abort``), so the messenger's connect path branches onto a
ring pair and every byte of the existing framing -- including
FaultInjector's mid-burst ``conn_kill_split`` tears and the
session-handshake replay that heals them -- flows through untouched.

Layout (models a real shm segment; header and data live in ONE
``bytearray`` so torn-producer injection is honest):

  [u64 head][u64 tail][u64 wseq] [data: capacity bytes, modular]

``head``/``tail`` are MONOTONIC byte offsets (consumer / producer);
``wseq`` is the seqlock generation -- odd while a producer is
mid-publish, bumped to even when the record is out.  Records are
``[u32 len][u32 crc32c(payload)][payload]`` laid out byte-modular in the
data region.  A reader that observes an odd ``wseq`` (producer
mid-write) backs off; a crc mismatch or impossible length means the
producer died mid-record -- a TORN RING -- and surfaces as
``RingTear`` (a ``ConnectionResetError``), which the messenger's
reconnect + session-replay machinery handles exactly like a TCP RST.

In-process scope: daemons here are asyncio tasks in one process, so the
"shared memory" is a shared ``bytearray`` and cross-daemon wakeups are
``asyncio.Event``s.  The byte layout, seqlock protocol and tear
semantics are the ones a real MAP_SHARED segment would use; only the
wakeup primitive would change (futex/eventfd).
"""

from __future__ import annotations

import argparse
import asyncio
import struct
from typing import Callable, Dict, List, Optional, Tuple

from ceph_tpu_torch.native.gf_native import crc32c
from ceph_tpu_torch.profiling import ledger as _profiler

#: ring cost centers (fetched once at import; native Stage twins when the
#: extension is loaded).  ``ring.push`` nests inside ``wire.writelines``
#: and ``ring.pop`` inside the frame-read loop -- exclusive accounting
#: splits the shm copy from the framing above it.
_PS_PUSH = _profiler.stage("ring.push")
_PS_POP = _profiler.stage("ring.pop")

_HDR = struct.Struct("<QQQ")  # head, tail, wseq
_REC = struct.Struct("<II")  # payload len, payload crc32c
_HDR_BYTES = _HDR.size
_REC_BYTES = _REC.size

#: default ring capacity when no config is consulted (tests); the
#: messenger passes ``osd_shm_ring_bytes``
DEFAULT_RING_BYTES = 4 << 20


class RingTear(ConnectionResetError):
    """The producer died mid-record (crc mismatch / impossible length /
    stuck-odd seqlock).  A ``ConnectionResetError`` subclass so the
    messenger's existing drop-reconnect-replay path fires unchanged."""


class ShmRing:
    """Seqlock'd SPSC byte ring over one contiguous buffer.

    Single producer, single consumer (one ring per direction per
    conduit).  ``try_push`` is synchronous and non-blocking (returns
    False when the record does not fit -- the writer adapter queues and
    retries on consumer progress); ``pop`` is synchronous and returns
    ``None`` on empty."""

    __slots__ = ("capacity", "_buf", "_view", "pushes", "pops",
                 "bytes_pushed", "tears", "hwm_used")

    def __init__(self, capacity: int = DEFAULT_RING_BYTES) -> None:
        if capacity < _REC_BYTES + 1:
            raise ValueError(f"ring capacity {capacity} too small")
        self.capacity = int(capacity)
        self._buf = bytearray(_HDR_BYTES + self.capacity)
        self._view = memoryview(self._buf)
        _HDR.pack_into(self._buf, 0, 0, 0, 0)
        self.pushes = 0
        self.pops = 0
        self.bytes_pushed = 0
        self.tears = 0
        self.hwm_used = 0

    # -- header accessors (the shm fields) --------------------------------

    def _load(self) -> Tuple[int, int, int]:
        return _HDR.unpack_from(self._buf, 0)

    def _store(self, head: int, tail: int, wseq: int) -> None:
        _HDR.pack_into(self._buf, 0, head, tail, wseq)

    def used(self) -> int:
        head, tail, _ = self._load()
        return tail - head

    def free(self) -> int:
        return self.capacity - self.used()

    # -- modular byte copies ----------------------------------------------

    def _copy_in(self, off: int, data) -> None:
        pos = off % self.capacity
        n = len(data)
        first = min(n, self.capacity - pos)
        base = _HDR_BYTES
        self._view[base + pos:base + pos + first] = data[:first]
        if first < n:
            self._view[base:base + (n - first)] = data[first:]

    def _copy_out(self, off: int, n: int) -> bytes:
        pos = off % self.capacity
        first = min(n, self.capacity - pos)
        base = _HDR_BYTES
        out = bytes(self._view[base + pos:base + pos + first])
        if first < n:
            out += bytes(self._view[base:base + (n - first)])
        return out

    # -- producer ----------------------------------------------------------

    def try_push(self, payload, *, torn: bool = False) -> bool:
        """Publish one record.  Returns False when it does not fit.

        ``torn=True`` models a producer crash mid-publish (FaultInjector
        ring-tear): the record header goes out and the tail advances,
        but only half the payload body lands and the seqlock is left
        where a dead producer would leave it -- the consumer's crc check
        turns this into :class:`RingTear`."""
        with _PS_PUSH:
            n = len(payload)
            need = _REC_BYTES + n
            if need > self.capacity:
                raise ValueError(
                    f"record {need}B exceeds ring capacity {self.capacity}B")
            head, tail, wseq = self._load()
            if need > self.capacity - (tail - head):
                return False
            # seqlock publish: odd while the body is in flight
            self._store(head, tail, wseq + 1)
            self._copy_in(tail, _REC.pack(n, crc32c(payload)))
            if torn:
                # producer "dies" here: half a body, tail published so
                # the consumer attempts the record, generation left even
                # (the crash happened after the bump in this interleaving)
                self._copy_in(tail + _REC_BYTES, payload[: n // 2])
                self._store(head, tail + need, wseq + 2)
                return True
            self._copy_in(tail + _REC_BYTES, payload)
            self._store(head, tail + need, wseq + 2)
            self.pushes += 1
            self.bytes_pushed += n
            used = (tail + need) - head
            if used > self.hwm_used:
                self.hwm_used = used
            return True

    # -- consumer ----------------------------------------------------------

    def pop(self) -> Optional[bytes]:
        """Consume one record.  ``None`` on empty; :class:`RingTear` on a
        torn record (crc mismatch / impossible length / stuck-odd
        seqlock -- the producer is gone and the ring is garbage)."""
        with _PS_POP:
            for _ in range(8):  # seqlock read retries (spurious in-process)
                head, tail, wseq = self._load()
                if tail == head:
                    return None
                if wseq & 1:
                    continue  # producer mid-publish; next iteration reloads
                avail = tail - head
                if avail < _REC_BYTES:
                    self.tears += 1
                    raise RingTear("torn ring: truncated record header")
                n, crc = _REC.unpack(self._copy_out(head, _REC_BYTES))
                if _REC_BYTES + n > avail or _REC_BYTES + n > self.capacity:
                    self.tears += 1
                    raise RingTear(
                        f"torn ring: record length {n} exceeds published "
                        f"bytes")
                payload = self._copy_out(head + _REC_BYTES, n)
                h2, _, w2 = self._load()
                if h2 != head or w2 != wseq:
                    continue  # raced a concurrent publish; re-read
                if crc32c(payload) != crc:
                    self.tears += 1
                    raise RingTear("torn ring: record crc mismatch")
                self._store(head + _REC_BYTES + n, tail, wseq)
                self.pops += 1
                return payload
            self.tears += 1
            raise RingTear("torn ring: seqlock stuck odd (producer died)")


class _RingTransport:
    """The ``writer.transport`` surface the messenger touches:
    ``abort()`` (conn_kill_split's hard kill)."""

    __slots__ = ("_conduit",)

    def __init__(self, conduit: "RingConduit") -> None:
        self._conduit = conduit

    def abort(self) -> None:
        self._conduit.kill()


class RingConduit:
    """One bidirectional colocated connection: two SPSC rings plus the
    wakeup events a shm segment would carry as futexes."""

    def __init__(self, capacity: int = DEFAULT_RING_BYTES) -> None:
        self.rings = (ShmRing(capacity), ShmRing(capacity))  # a->b, b->a
        self.data_evt = (asyncio.Event(), asyncio.Event())
        self.space_evt = (asyncio.Event(), asyncio.Event())
        self.closed = [False, False]  # writer side a / b closed cleanly
        self.killed = False

    def kill(self) -> None:
        """Hard abort (transport.abort / peer death): both directions
        fail immediately -- readers raise, writers raise."""
        self.killed = True
        for e in self.data_evt:
            e.set()
        for e in self.space_evt:
            e.set()

    def close_dir(self, d: int) -> None:
        self.closed[d] = True
        self.data_evt[d].set()

    def pair(self, *, fault=None) -> Tuple[Tuple["RingReader", "RingWriter"],
                                           Tuple["RingReader", "RingWriter"]]:
        """(reader, writer) endpoint tuples for side A and side B.
        ``fault`` (a FaultInjector) arms ring-tear injection on side A's
        writer -- the CONNECTING messenger's outbound direction."""
        a = (RingReader(self, 1), RingWriter(self, 0, fault=fault))
        b = (RingReader(self, 0), RingWriter(self, 1))
        return a, b


class RingReader:
    """The ``asyncio.StreamReader`` subset the messenger's frame loop
    uses.  Pops ring records and serves them as a byte stream."""

    def __init__(self, conduit: RingConduit, direction: int) -> None:
        self._c = conduit
        self._d = direction
        self._buf = bytearray()

    def _fill_from_ring(self) -> bool:
        """Drain every ready record into the local buffer (sync).
        Returns True if any bytes arrived."""
        ring = self._c.rings[self._d]
        got = False
        while True:
            try:
                rec = ring.pop()
            except RingTear:
                self._c.kill()
                raise
            if rec is None:
                return got
            self._buf += rec
            got = True
            self._c.space_evt[self._d].set()

    async def _wait_bytes(self) -> bool:
        """Block until bytes are buffered; False means clean EOF."""
        while not self._buf:
            if self._fill_from_ring():
                break
            if self._c.killed:
                raise ConnectionResetError("ring conduit aborted")
            if self._c.closed[self._d] and self._c.rings[self._d].used() == 0:
                return False
            self._c.data_evt[self._d].clear()
            # re-check after clear: a push between fill and clear would
            # otherwise be missed (the classic lost-wakeup window)
            if self._c.rings[self._d].used() or self._c.killed \
                    or self._c.closed[self._d]:
                continue
            await self._c.data_evt[self._d].wait()
        return True

    async def read(self, n: int) -> bytes:
        if n <= 0:
            return b""
        if not await self._wait_bytes():
            return b""
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    async def readexactly(self, n: int) -> bytes:
        while len(self._buf) < n:
            self._fill_from_ring()
            if len(self._buf) >= n:
                break
            if self._c.killed:
                raise ConnectionResetError("ring conduit aborted")
            if self._c.closed[self._d] and self._c.rings[self._d].used() == 0:
                raise asyncio.IncompleteReadError(bytes(self._buf), n)
            self._c.data_evt[self._d].clear()
            # re-check after clear (lost-wakeup window)
            if self._c.rings[self._d].used() or self._c.killed \
                    or self._c.closed[self._d]:
                continue
            await self._c.data_evt[self._d].wait()
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out


class RingWriter:
    """The ``asyncio.StreamWriter`` subset the messenger's flush paths
    use.  One ``writelines`` burst becomes ONE ring record (the shm
    analogue of one scatter-gather syscall); oversized bursts split at
    ring capacity.  Records a full ring refuses are pushed by a flusher
    task as the consumer frees room, as a socket transport sends its
    buffer without waiting for ``drain()``, and ``close()`` closes the
    direction after the last of them, as a transport flushes before it
    closes (the JAX package's writer leaves refused records until the
    next write or drain on the conduit, which a last reply may never
    get, and drops them at ``close()``: a frame cut short there is lost
    to a lossy peer)."""

    def __init__(self, conduit: RingConduit, direction: int,
                 *, fault=None) -> None:
        self._c = conduit
        self._d = direction
        self._pending: List[bytes] = []  # records awaiting ring space
        self._fault = fault
        self._broken = False  # producer "crashed" after a torn record
        self._flusher: Optional[asyncio.Task] = None
        self._closing = False  # close() called; refused records still out
        self.transport = _RingTransport(conduit)

    # -- internals ---------------------------------------------------------

    def _check_open(self) -> None:
        if self._c.killed or self._broken:
            raise ConnectionResetError("ring conduit aborted")
        if self._closing or self._c.closed[self._d]:
            raise ConnectionResetError("ring writer closed")

    def _records_of(self, data: bytes) -> List[bytes]:
        ring = self._c.rings[self._d]
        limit = ring.capacity - _REC_BYTES
        if len(data) <= limit:
            return [data]
        return [data[i:i + limit] for i in range(0, len(data), limit)]

    def _push_now(self) -> None:
        """Sync best-effort flush of pending records into the ring."""
        ring = self._c.rings[self._d]
        while self._pending:
            rec = self._pending[0]
            torn = False
            if self._fault is not None and self._fault.ring_tear_fire():
                torn = True
            if not ring.try_push(rec, torn=torn):
                if torn:
                    # re-arm style: a tear that found no space still
                    # counts as the producer dying -- kill outright
                    self._broken = True
                    self._c.kill()
                    return
                return  # backpressure: wait for consumer progress
            self._pending.pop(0)
            self._c.data_evt[self._d].set()
            if torn:
                # the producer died mid-record: nothing further is ever
                # written on this conduit
                self._broken = True
                self._c.kill()
                return

    # -- StreamWriter subset ----------------------------------------------

    def _flush_later(self) -> None:
        """Start the flusher when records wait for ring space."""
        if self._pending and (self._flusher is None or self._flusher.done()):
            self._flusher = asyncio.get_event_loop().create_task(
                self._flush_pending())

    async def _flush_pending(self) -> None:
        try:
            await self.drain()
        except ConnectionResetError:
            pass  # the conduit died: the reader side reports it
        finally:
            if self._closing:
                self._c.close_dir(self._d)

    def write(self, data) -> None:
        self._check_open()
        self._pending.extend(self._records_of(bytes(data)))
        self._push_now()
        if self._broken:
            raise ConnectionResetError("ring torn mid-record")
        self._flush_later()

    def writelines(self, bufs) -> None:
        self._check_open()
        self._pending.extend(self._records_of(b"".join(
            bytes(b) if not isinstance(b, bytes) else b for b in bufs)))
        self._push_now()
        if self._broken:
            raise ConnectionResetError("ring torn mid-record")
        self._flush_later()

    async def drain(self) -> None:
        while self._pending:
            if self._c.killed or self._broken:
                raise ConnectionResetError("ring conduit aborted")
            if self._c.closed[self._d]:
                raise ConnectionResetError("ring writer closed")
            self._push_now()
            if not self._pending:
                break
            self._c.space_evt[self._d].clear()
            # re-check after clear (lost-wakeup window) -- but only for
            # room the head record fits in.  The JAX package re-loops on
            # any free byte: a record larger than the free space then
            # spins here without ever yielding to the consumer, which
            # runs on this same loop (a livelock once records near the
            # ring's capacity, as 4 MiB client ops do on a 4 MiB ring)
            need = _REC_BYTES + len(self._pending[0])
            if self._c.rings[self._d].free() >= need \
                    or self._c.killed or self._broken:
                continue
            await self._c.space_evt[self._d].wait()

    def close(self) -> None:
        if self._closing or self._c.closed[self._d]:
            return
        self._closing = True
        self._push_now()
        if self._pending and not (self._c.killed or self._broken):
            self._flush_later()  # its last step closes the direction
        else:
            self._c.close_dir(self._d)

    def is_closing(self) -> bool:
        return (self._closing or self._c.closed[self._d] or self._c.killed
                or self._broken)

    async def wait_closed(self) -> None:
        return None


# -- colocated endpoint registry ------------------------------------------
#
# Keyed by the node's BOUND (host, port) -- unique per harness (ports come
# from free_ports) where node NAMES ("osd.0") repeat across sequentially
# created harnesses in one process.

class RingEndpoint:
    def __init__(self, addr: Tuple[str, int],
                 accept_cb: Callable[["RingReader", "RingWriter"], None],
                 ring_bytes: int) -> None:
        self.addr = addr
        self.accept_cb = accept_cb
        self.ring_bytes = ring_bytes
        self.conduits: List[RingConduit] = []

    def close(self) -> None:
        for c in self.conduits:
            c.kill()
        self.conduits.clear()


_ENDPOINTS: Dict[Tuple[str, int], RingEndpoint] = {}


def register(addr: Tuple[str, int],
             accept_cb: Callable[["RingReader", "RingWriter"], None],
             *, ring_bytes: int = DEFAULT_RING_BYTES) -> None:
    """Announce a messenger's accept endpoint as ring-reachable.
    ``accept_cb(reader, writer)`` is invoked (sync; it should spawn the
    serve task) when a colocated peer connects."""
    _ENDPOINTS[tuple(addr)] = RingEndpoint(tuple(addr), accept_cb,
                                           ring_bytes)


def unregister(addr: Tuple[str, int]) -> None:
    ep = _ENDPOINTS.pop(tuple(addr), None)
    if ep is not None:
        ep.close()


def lookup(addr: Tuple[str, int]) -> Optional[RingEndpoint]:
    return _ENDPOINTS.get(tuple(addr))


def connect(addr: Tuple[str, int], *, fault=None
            ) -> Optional[Tuple["RingReader", "RingWriter"]]:
    """Open a ring conduit to a registered colocated endpoint.  Returns
    the CLIENT side (reader, writer), or ``None`` when the address is
    not ring-reachable (caller falls back to TCP).  ``fault`` arms
    ring-tear injection on the client's outbound direction."""
    ep = _ENDPOINTS.get(tuple(addr))
    if ep is None:
        return None
    conduit = RingConduit(ep.ring_bytes)
    ep.conduits.append(conduit)
    client, server = conduit.pair(fault=fault)
    ep.accept_cb(server[0], server[1])
    return client


# -- smoke (python -m ceph_tpu_torch.msg.shm_ring --smoke) ----------------

async def _smoke() -> int:
    ring = ShmRing(1 << 16)
    msgs = [bytes([i & 0xFF]) * (997 * (i % 7 + 1)) for i in range(64)]
    out = []
    i = 0
    # interleaved push/pop forces wraparound several times over
    for m in msgs:
        while not ring.try_push(m):
            out.append(ring.pop())
        while len(out) < i - 2 and (r := ring.pop()) is not None:
            out.append(r)
        i += 1
    while (r := ring.pop()) is not None:
        out.append(r)
    assert out == msgs, "ring byte fidelity"
    assert ring.hwm_used <= ring.capacity

    # torn record -> RingTear
    ring2 = ShmRing(1 << 12)
    ring2.try_push(b"ok-record")
    ring2.try_push(b"x" * 512, torn=True)
    assert ring2.pop() == b"ok-record"
    try:
        ring2.pop()
    except RingTear:
        pass
    else:
        raise AssertionError("torn record not detected")

    # conduit echo through the stream adapters
    server_side = []
    register(("smoke", 1), lambda r, w: server_side.append((r, w)),
             ring_bytes=1 << 16)
    try:
        client = connect(("smoke", 1))
        assert client is not None
        cr, cw = client
        sr, sw = server_side[0]
        cw.write(b"ping" * 100)
        await cw.drain()
        got = await sr.readexactly(400)
        assert got == b"ping" * 100
        sw.writelines([b"po", b"ng"])
        await sw.drain()
        assert await cr.readexactly(4) == b"pong"
        cw.close()
        assert await sr.read(1) == b""  # clean EOF
        # abort surfaces as ConnectionResetError on the peer reader
        sw.transport.abort()
        try:
            await cr.read(1)
        except ConnectionResetError:
            pass
        else:
            raise AssertionError("abort not surfaced")
    finally:
        unregister(("smoke", 1))
    print("shm_ring smoke: OK "
          f"(pushes={ring.pushes} wraps_hwm={ring.hwm_used})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="shm ring smoke")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    if args.smoke:
        return asyncio.run(_smoke())
    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
