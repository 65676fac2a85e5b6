"""TCP messenger: the in-process bus semantics over real sockets.

Port of ``ceph_tpu/msg/tcp.py`` on the pure-Python wire codec
(``msg/wire.py``).  The frames on the socket are the JAX package's, byte
for byte: banner, cephx handshake, signed frames, session watermarks,
cumulative and piggybacked acks.  The JAX package's batched C codec
(``native/wire_codec.py``) is not ported yet (ROADMAP.md queue 1 item
16b): where the configuration asks for it (``native`` and
``osd_wire_codec_native`` both true, the defaults) the constructor
raises :class:`WireCodecNotPorted`; with ``osd_wire_codec_native=false``
the Python codec runs, as the JAX package runs it under that setting.

Reference: src/msg/async/AsyncMessenger.{h,cc} with the posix NetworkStack
(src/msg/async/Stack.h:287, PosixStack.h) -- a listening socket per
daemon, cached outgoing connections, a banner handshake naming the peer
node, framed messages.

Two policies, as in the reference (src/msg/Policy.h):

* **lossy** (client connections): a send to an unreachable peer is
  dropped and the peer marked unreachable; later sends retry the
  connect, so a restarted daemon becomes reachable again.
* **lossless peer** (OSD<->OSD): every message to a lossless
  peer carries a per-direction sequence number and stays on the sender's
  unacked queue until the receiver acks it; a connection drop triggers
  reconnect + REPLAY of everything past the peer's delivered watermark,
  and the receiver dedups by sequence -- the Pipe.cc connect/replay
  protocol (src/msg/simple/Pipe.cc:1040-1260 connect(), got_ack,
  in_seq/out_seq exchange).  Receive state is keyed by the sender's
  per-process INSTANCE id (the reference's connect nonce), so a
  restarted sender starts a fresh stream instead of colliding with its
  predecessor's watermark.  Like the reference, delivery across a
  RECEIVER restart degrades to at-least-once (unacked messages are
  retransmitted to the fresh process; the version-gated OSD apply paths
  make redelivery idempotent, the reqid-dedup role).

One ``TCPMessenger`` per process ("node").  A node hosts one or more
named entities (e.g. ``osd.3``); the address book maps every entity name
in the cluster to its node's (host, port).  Entity names co-hosted on
this node short-circuit delivery in process (the reference's local
fast-dispatch for self-sends, ECBackend.cc:2025-2032).

Frames on the socket are ``encoding.frame`` records (magic+len+crc32c);
payloads start with a kind byte: MSG (src|dst|seq|body[|ack]), ACK
(cumulative seq), or SESSION (the reconnect watermark exchange).  The
first frame on every outgoing connection is a banner naming the sender
node, protocol version, and instance id (Pipe.cc banner exchange).

Corked zero-copy send path (protocol v4): outgoing frames queue per peer and flush at
end-of-tick (queue-drain, the ``osd/coalescer.py`` discipline) or past
a byte threshold, as ONE ``writer.writelines`` scatter-gather burst --
synchronously, straight into the transport buffer: no per-message task,
no per-message ``drain()``.  ``drain()`` becomes what it actually is,
flow control, awaited only once ``osd_msgr_cork_bytes`` have been
written since the last drain.  Message payloads are part lists
(``Encoder.parts``); large bodies are referenced, never joined, and
each payload's crc32c is computed once and only EXTENDED over the
per-transmission tail (piggyback ack + signature) on (re)transmit --
crc32c chains, see ``encoding.crc32c_parts``.  Delivery acks piggyback
as a trailing cumulative varint on outgoing MSG frames (v3 receivers
ignore trailing bytes); with no reverse traffic a receiver writes one
cumulative ACK frame per burst window instead of one frame + drain per
message.  The receive side parses every frame already buffered in one
wakeup (``_FrameReader``) instead of two ``readexactly`` awaits per
frame.  A flush failure falls back to the lossless reconnect/replay
machinery unchanged -- coalescing never weakens the delivery guarantee,
it only changes the syscall shape.
"""

from __future__ import annotations

import asyncio
import os
import struct
import time as _time
from collections import deque
from typing import Awaitable, Callable, Dict, Iterable, List, Optional, \
    Tuple

from ceph_tpu_torch.msg import shm_ring as _shm
from ceph_tpu_torch.msg.fault import FaultInjector
from ceph_tpu_torch.msg.wire import decode_message, message_encoder
from ceph_tpu_torch.native.gf_native import crc32c
from ceph_tpu_torch.profiling import ledger as _profiler
from ceph_tpu_torch.utils.encoding import Decoder, Encoder, crc32c_parts, \
    frame, frame_parts, unframe

#: wire-tax profiler cost centers (ceph_tpu_torch/profiling/): markers are
#: fetched ONCE here so the per-frame cost is the `with` protocol on a
#: preallocated object -- one global-bool branch when profiling is off.
#: Stage blocks are yield-free by construction (a stage spanning an
#: await would bill other tasks' work to itself).
_PS_ENCODE = _profiler.stage("wire.encode")        # envelope + part list
_PS_SEAL = _profiler.stage("wire.crc_seal")        # crc fold + sign + frame
_PS_CORK = _profiler.stage("wire.cork_append")     # cork-queue append
_PS_WRITE = _profiler.stage("wire.writelines")     # the send syscall
_PS_PARSE = _profiler.stage("wire.parse")          # _FrameReader frame scan
_PS_ENVELOPE = _profiler.stage("wire.envelope")    # inbound head/seq/ack
_PS_FANIN = _profiler.stage("wire.dispatch_fanin")  # per-msg dispatch prep
_PS_DECODE = _profiler.stage("wire.decode_body")   # typed body decode

#: v4 adds the trailing piggyback-ack varint on MSG frames and corked
#: multi-frame bursts; acceptors take any version in
#: [_MIN_PROTOCOL_VERSION, _PROTOCOL_VERSION] (banner negotiation --
#: v3 peers interop)
_PROTOCOL_VERSION = 4
_MIN_PROTOCOL_VERSION = 3
_BANNER = "ceph-tpu-msgr"
_SIG_LEN = 16

# frame kinds (payload byte 0)
_K_MSG = 0
_K_ACK = 1
_K_SESSION = 2

#: seconds a receiver waits before writing a standalone cumulative ACK
#: frame: long enough for same-op REPLY traffic to piggyback the
#: watermark on its own data frames (acks gate nothing but unacked-queue
#: pruning, so the latency is free), short enough to bound sender memory
_ACK_DELAY = 0.025

#: message payloads smaller than this are joined into one buffer at
#: enqueue (a short memcpy beats per-part crc/digest bookkeeping);
#: larger payloads stay scatter-gather so big blobs cross by reference
_JOIN_BELOW = 4096

#: serve-loop sentinel for an inbound body this build cannot decode
#: (a newer peer's frame kind): distinct from None, which is a
#: perfectly legal MSG_VALUE payload
_UNDECODABLE = object()


class WireCodecNotPorted(RuntimeError):
    """The configuration asks for the native wire codec, which the port
    does not have yet (ROADMAP.md queue 1 item 16b)."""


def check_wire_codec(cfg) -> None:
    """Refuse a configuration that asks for the native wire codec: the
    JAX package would run its C extension there, and the port runs the
    Python codec only where it is asked for by name."""
    if bool(cfg.get_val("native")) and \
            bool(cfg.get_val("osd_wire_codec_native")):
        raise WireCodecNotPorted(
            "TCPMessenger: the native wire codec (osd_wire_codec_native="
            "true with native=true) is not ported yet -- ROADMAP.md queue "
            "1 item 16b; set osd_wire_codec_native=false to run the "
            "Python codec")


def _varint_bytes(v: int) -> bytes:
    """LEB128 unsigned varint as standalone bytes (the piggyback-ack
    tail appended to queued MSG payloads at transmit time)."""
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


class _QueuedMsg:
    """One unsealed MSG payload: a scatter-gather part list plus its
    payload crc32c, computed once on first transmit and cached.  Signing
    and the piggyback-ack tail are per-transmission (fresh session key
    per connection), so frames seal at (re)transmit time by EXTENDING
    the cached crc over the tail instead of re-digesting the payload."""

    __slots__ = ("seq", "parts", "crc", "nbytes", "t_enq")

    def __init__(self, seq: int, parts: List, crc: Optional[int] = None,
                 nbytes: Optional[int] = None):
        self.seq = seq
        self.parts = parts
        #: payload crc32c, computed lazily on first transmit
        #: (_entry_frames) and extended over each transmission's tail
        self.crc = crc
        self.nbytes = sum(len(p) for p in parts) if nbytes is None \
            else nbytes
        #: enqueue stamp: ack-lag (enqueue -> delivery-ack prune) feeds
        #: the per-node ack_lag latency histogram (observability)
        self.t_enq = _time.monotonic()


class _SendSession:
    """Per-lossless-peer send state (the Pipe out_seq/sent-queue role)."""

    __slots__ = ("out_seq", "acked", "sent", "sent_bytes", "reconnecting")

    def __init__(self):
        self.out_seq = 0
        self.acked = 0
        #: unacked _QueuedMsg oldest first; payloads are kept UNSEALED --
        #: signing is per-connection (fresh session key on every
        #: reconnect), so frames seal at (re)transmit time
        self.sent: deque = deque()
        self.sent_bytes = 0
        self.reconnecting = False

    def prune(self, acked_seq: int) -> None:
        self.acked = max(self.acked, acked_seq)
        while self.sent and self.sent[0].seq <= self.acked:
            entry = self.sent.popleft()
            self.sent_bytes -= entry.nbytes


class _CorkQueue:
    """Per-peer-node outgoing frame queue (cork/flush state)."""

    __slots__ = ("entries", "nbytes", "flushing", "scheduled",
                 "since_drain", "draining")

    def __init__(self):
        self.entries: List[_QueuedMsg] = []
        self.nbytes = 0
        self.flushing = False   # an async (slow-path) flusher owns the queue
        self.scheduled = False  # an end-of-tick flush callback is pending
        self.since_drain = 0    # bytes written since the last flow-control drain
        self.draining = False


class _AckBatch:
    """Per-inbound-connection cumulative-ack batching state."""

    __slots__ = ("flushed", "scheduled")

    def __init__(self):
        self.flushed = 0
        self.scheduled = False


class _FrameReader:
    """Buffered frame parser: one ``read()`` wakeup drains every frame
    already buffered on the socket (a corked burst arrives as one TCP
    segment run), instead of two ``readexactly`` awaits per frame.

    ``buffered=False`` reproduces the per-message receive shape (one
    header ``readexactly`` + one payload ``readexactly`` per frame) --
    the other half of the ``osd_msgr_cork`` baseline toggle, so the
    cluster-path bench A/Bs the whole wire architecture, not just the
    send side."""

    __slots__ = ("_reader", "_buf", "_pos", "_buffered")

    def __init__(self, reader: asyncio.StreamReader, buffered: bool = True):
        self._reader = reader
        self._buf = b""
        self._pos = 0
        self._buffered = buffered

    async def _next_frame_per_message(self) -> Optional[bytes]:
        try:
            header = await self._reader.readexactly(12)
        except (asyncio.IncompleteReadError, ConnectionError):
            return None
        _magic, length, _crc = struct.unpack("<III", header)
        try:
            payload = await self._reader.readexactly(length)
        except (asyncio.IncompleteReadError, ConnectionError):
            return None
        rec, _pos = unframe(header + payload, 0)
        return rec  # None if magic/crc check failed

    async def next_frame(self) -> Optional[bytes]:
        """The next framed record; None on EOF or a corrupt frame (the
        caller drops the connection either way)."""
        if not self._buffered:
            return await self._next_frame_per_message()
        while True:
            buf, pos = self._buf, self._pos
            if len(buf) - pos >= 12:
                with _PS_PARSE:
                    _magic, length, _crc = struct.unpack_from(
                        "<III", buf, pos)
                    if len(buf) - pos >= 12 + length:
                        rec, _next = unframe(buf, pos)  # magic+crc checked
                        if rec is None:
                            return None  # corrupt/forged: drop the conn
                        pos += 12 + length
                        if pos >= len(buf):
                            self._buf, self._pos = b"", 0
                        else:
                            self._pos = pos
                        return rec
            try:
                chunk = await self._reader.read(1 << 16)
            except (ConnectionError, OSError):
                return None
            if not chunk:
                return None
            self._buf = buf[pos:] + chunk if pos < len(buf) else chunk
            self._pos = 0


async def _read_frame(framer) -> Optional[bytes]:
    """Read one framed record; None on EOF/corruption.  Accepts a
    :class:`_FrameReader` (the messenger's connections) or a bare
    StreamReader (compat for direct callers)."""
    if isinstance(framer, asyncio.StreamReader):
        framer = _FrameReader(framer)
    return await framer.next_frame()


class TCPMessenger:
    """API-compatible with ``osd.messenger.Messenger`` so OSDShard /
    ECBackend run unchanged over real sockets."""

    def __init__(
        self,
        node: str,
        addr_map: Dict[str, Tuple[str, int]],
        fault: Optional[FaultInjector] = None,
        keyring=None,
        cork: Optional[bool] = None,
    ):
        #: this process's node name; must appear in addr_map for serving
        self.node = node
        self.addr_map = dict(addr_map)
        self.fault = fault if fault is not None else \
            FaultInjector.from_config()
        #: cephx-style auth: when a KeyRing is given, every connection
        #: must pass the mutual challenge-response handshake and every
        #: frame is signed with the derived session key (ms_sign_messages)
        self.keyring = keyring
        self._local_queues: Dict[str, asyncio.Queue] = {}
        self._dispatchers: Dict[str, Callable] = {}
        self._tasks: Dict[str, asyncio.Task] = {}
        #: cached outgoing connections per peer node:
        #: (framer, writer, lock, session_key)
        self._conns: Dict[str, Tuple] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        #: administratively dead entities (mark_down -- the thrasher hook)
        self._marked_down: set = set()
        #: peers whose last connect/send failed, with WHEN it failed:
        #: unreachability is a cached observation, not a verdict, and it
        #: expires -- a revived daemon whose boot races one failed
        #: connect must not be treated as down forever (its primary
        #: would otherwise refuse reads with "only N shards" while every
        #: peer is in fact alive)
        self._unreachable: dict = {}
        self._unreachable_ttl = 3.0
        self._reprobing: set = set()
        #: live incoming-connection handler tasks (cancelled on shutdown;
        #: Server.wait_closed would otherwise block on them forever)
        self._serve_tasks: set = set()
        #: inbound dispatch byte budget (DispatchThrottler /
        #: osd_client_message_size_cap, default 500 MiB): budget is held
        #: from socket read until the dispatcher finishes, so a flood of
        #: large messages back-pressures the senders' sockets instead of
        #: ballooning memory
        from ceph_tpu_torch.utils.config import get_config
        from ceph_tpu_torch.utils.throttle import Throttle

        cfg = get_config()
        check_wire_codec(cfg)
        try:
            cap = int(cfg.get_val("osd_client_message_size_cap"))
        except (KeyError, ValueError, TypeError):
            cap = 500 * 1024 * 1024
        self.dispatch_throttle = Throttle(f"{node}.msgr-dispatch", cap)
        #: corked send path (osd_msgr_cork): queue outgoing frames per
        #: connection, flush as one writelines burst; off = one
        #: write/drain per message (the per-message baseline)
        self.cork = bool(cfg.get_val("osd_msgr_cork")) if cork is None \
            else bool(cork)
        self.cork_bytes = int(cfg.get_val("osd_msgr_cork_bytes"))
        #: shared-memory frame rings (osd_msgr_shm_ring): colocated
        #: peers whose accept endpoint is ring-registered in THIS
        #: process get a seqlock'd byte-ring conduit instead of the
        #: localhost TCP hop; the whole protocol above the byte
        #: transport (banner, auth, sessions, acks, replay) is
        #: unchanged.  False (default) = TCP everywhere, the A/B
        #: baseline.
        try:
            self.shm_ring = bool(cfg.get_val("osd_msgr_shm_ring"))
            self.ring_bytes = int(cfg.get_val("osd_shm_ring_bytes"))
        except KeyError:
            self.shm_ring = False
            self.ring_bytes = _shm.DEFAULT_RING_BYTES
        self._ring_registered = False
        self._cork_queues: Dict[str, _CorkQueue] = {}
        self._cork_seq = 0
        #: (src entity, dst entity) -> encoded kind|src|dst MSG head
        self._head_cache: Dict[tuple, bytes] = {}
        #: highest reverse-stream watermark piggybacked to each peer node
        #: on our own data frames (lets the inbound-side ack batcher skip
        #: standalone ACK frames the peer has already seen)
        self._piggy_acked: Dict[str, int] = {}
        #: wire-shape counters (the cluster-path bench trend metrics):
        #: frames per burst = frames_sent/bursts, bytes per drain =
        #: bytes_sent/max(drains,1), piggyback ratio =
        #: piggybacked/(piggybacked+standalone)
        self.counters: Dict[str, int] = {
            "msgs_sent": 0, "frames_sent": 0, "bursts": 0, "drains": 0,
            "bytes_sent": 0, "acks_piggybacked": 0, "acks_standalone": 0,
            "acks_elided": 0, "acks_piggybacked_recv": 0,
            "unknown_msg_dropped": 0, "ring_conns": 0, "tcp_conns": 0,
        }
        #: ack-lag attribution (observability): enqueue -> delivery-ack
        #: latency per pruned message, a prometheus histogram family
        from ceph_tpu_torch.utils.perf import stage_histogram

        self._h_ack_lag = stage_histogram(f"{node}.ack_lag_usec")
        #: per-process instance id (the Pipe connect nonce): receive
        #: state is keyed by it, so a restarted peer's fresh stream
        #: never collides with its predecessor's sequence watermark
        self.instance_id = os.urandom(8)
        #: lossless-peer send sessions: peer node -> _SendSession
        self._sessions: Dict[str, _SendSession] = {}
        self._connect_locks: Dict[str, asyncio.Lock] = {}
        #: last instance id seen from each peer node (inbound banners):
        #: an accept pops our cached outgoing conn only on a CHANGE
        #: (peer restart), never on ordinary bidirectional traffic
        self._peer_instances: Dict[str, bytes] = {}
        self._closing = False
        #: receive watermarks: (peer node, instance id) -> delivered seq
        self._in_seqs: Dict[tuple, int] = {}
        #: backlog cap per lossless peer (beyond it, NEW messages drop
        #: like lossy sends -- an honest bound; the reference relies on
        #: its throttles for the same purpose)
        self.lossless_max_backlog = 64 << 20

    def _lossless(self, node: str) -> bool:
        """Lossless-peer policy: OSD<->OSD connections (the reference's
        cluster-messenger policy, src/msg/Policy.h lossless_peer);
        everything else is a lossy client."""
        return self.node.startswith("osd.") and node.startswith("osd.")

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        host, port = self.addr_map[self.node]
        self._server = await asyncio.start_server(
            self._serve_connection, host, port
        )
        if self.shm_ring:
            # announce our accept endpoint as ring-reachable: colocated
            # peers dialing (host, port) get a ring conduit whose server
            # side enters the SAME accept path as a TCP connection
            _shm.register((host, port), self._accept_ring,
                          ring_bytes=self.ring_bytes)
            self._ring_registered = True

    def _accept_ring(self, reader, writer) -> None:
        """Ring-conduit accept: the colocated analogue of the
        ``asyncio.start_server`` callback -- same serve coroutine, ring
        stream adapters instead of sockets."""
        self.adopt_task(
            f"ring-accept.{id(reader)}",
            asyncio.get_event_loop().create_task(
                self._serve_connection(reader, writer)))

    async def shutdown(self) -> None:
        self._closing = True  # stops lossless reconnect loops
        if self._ring_registered:
            _shm.unregister(tuple(self.addr_map[self.node]))
            self._ring_registered = False
        if self._server is not None:
            self._server.close()
        for conn in self._conns.values():
            conn[1].close()
        self._conns.clear()
        # cancel in ROUNDS (mirrors the in-process Messenger.shutdown):
        # under py<3.11 asyncio.wait_for can swallow a cancellation that
        # races its future's completion (bpo-42130); a tick loop that
        # lost its one cancel that way keeps running and a single
        # unbounded `await task` here then wedges the daemon inside its
        # SIGTERM handler -- the process never exits and the caller's
        # waitpid hangs.  Re-cancelling lands the next CancelledError at
        # the task's next await point; bounded rounds keep shutdown
        # finite no matter what.
        pending = [
            t for t in list(self._tasks.values()) + list(self._serve_tasks)
            if not t.done()
        ]
        for _ in range(50):
            if not pending:
                break
            for task in pending:
                task.cancel()
            _done, still = await asyncio.wait(pending, timeout=0.5)
            pending = list(still)
        if self._server is not None:
            await self._server.wait_closed()

    # -- entity registration (same surface as the in-process bus) ----------

    def register(
        self, name: str, dispatcher: Callable[[str, object], Awaitable[None]]
    ) -> None:
        self._local_queues[name] = asyncio.Queue()
        self._dispatchers[name] = dispatcher
        self._tasks[name] = asyncio.get_event_loop().create_task(
            self._dispatch_loop(name)
        )

    def adopt_task(self, name: str, task: "asyncio.Task") -> None:
        # completed tasks prune themselves (per-op tasks would otherwise
        # accumulate without bound on a long-lived daemon) and log any
        # unhandled exception on the way out
        from ceph_tpu_torch.utils.aio import log_task_exception

        self._tasks[name] = task

        def _done(t, name=name):
            log_task_exception(t, name)
            if self._tasks.get(name) is t:
                self._tasks.pop(name, None)

        task.add_done_callback(_done)

    async def _dispatch_loop(self, name: str) -> None:
        queue = self._local_queues[name]
        while True:
            item = await queue.get()
            more = True
            while more:
                await self._dispatch_one(name, item)
                # drain everything already buffered without paying an
                # await round per item (a corked burst delivers as one)
                if queue.empty():
                    more = False
                else:
                    item = queue.get_nowait()

    async def _dispatch_one(self, name: str, item) -> None:
        # the fan-in bookkeeping (budget hand-off plumbing) is a
        # declared cost center; the dispatcher's own execution is the
        # event-loop arm's territory (it awaits)
        with _PS_FANIN:
            src, msg = item[0], item[1]
            cost = item[2] if len(item) > 2 else 0
            release = None
            claimed = [False]
            if cost:
                released = [False]

                def release(released=released, cost=cost):
                    if not released[0]:
                        released[0] = True
                        self.dispatch_throttle.put(cost)

                if isinstance(msg, dict) and "op" in msg:
                    # budget hand-off: a dispatcher that only ENQUEUES
                    # the op (OSDShard's QoS queue) may claim the budget
                    # and release it when the op actually executes --
                    # that is what makes the byte cap a real memory
                    # bound for daemons instead of a transit-only
                    # throttle.  Blocking here instead would deadlock:
                    # sub-op replies for in-flight ops arrive through
                    # this same loop.
                    msg["_budget_release"] = release
                    msg["_budget_claim"] = (
                        lambda claimed=claimed:
                        claimed.__setitem__(0, True))
        try:
            if name not in self._marked_down:
                try:
                    await self._dispatchers[name](src, msg)
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 -- a dispatcher crash
                    # must not kill the loop (reference logs and drops)
                    import sys
                    import traceback

                    traceback.print_exc(file=sys.stderr)
        finally:
            if isinstance(msg, dict):
                msg.pop("_budget_claim", None)
            if cost and not claimed[0]:
                if isinstance(msg, dict):
                    msg.pop("_budget_release", None)
                release()

    # -- server side -------------------------------------------------------

    async def _serve_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        task = asyncio.current_task()
        self._serve_tasks.add(task)
        try:
            await self._serve_connection_inner(reader, writer)
        except (ConnectionError, OSError):
            pass  # peer vanished mid-serve (restart/teardown): normal
        finally:
            self._serve_tasks.discard(task)
            writer.close()

    async def _serve_connection_inner(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        framer = _FrameReader(reader, buffered=self.cork)
        banner = await framer.next_frame()
        if banner is None:
            writer.close()
            return
        dec = Decoder(banner)
        if dec.string() != _BANNER:
            writer.close()
            return
        # banner negotiation: accept any peer whose dialect we can parse
        # (>= _MIN).  Old kinds keep their layout; the v4 additions are
        # a TRAILING field old receivers never read and a cumulative ACK
        # frame old senders already handle (prune() is cumulative), so a
        # v3 peer interops without a feature exchange.
        if not (_MIN_PROTOCOL_VERSION <= dec.varint() <= _PROTOCOL_VERSION):
            writer.close()  # unparseable dialect: refuse (reference -EXDEV)
            return
        peer_node = dec.string()
        client_nonce = dec.blob()
        peer_instance = dec.blob()
        session_key = None
        if self.keyring is not None:
            session_key = await self._auth_accept(
                framer, writer, peer_node, client_nonce
            )
            if session_key is None:
                writer.close()  # failed handshake: refuse (-EACCES)
                return
        self._unreachable.pop(peer_node, None)
        # the peer RESTARTED (new instance id): any cached outgoing
        # connection targets its dead predecessor (writes into it are
        # silently buffered by TCP, losing replies) -- drop it so the
        # next send dials the live process (Pipe.cc replaces the old
        # session on accept).  Same instance = ordinary bidirectional
        # traffic: the healthy outgoing conn must survive the accept,
        # or two chatty OSDs would tear each other's sessions down
        # forever.
        prev_instance = self._peer_instances.get(peer_node)
        self._peer_instances[peer_node] = peer_instance
        if prev_instance != peer_instance:
            # first contact or a restart: drop the (possibly stale)
            # cached conn once; repeat accepts from the SAME instance
            # leave it alone.  _drop_conn re-arms the reconnect loop if
            # unacked lossless traffic is pending (a popped conn's ack
            # reader cannot, its currency check fails by then), and
            # dead-instance receive watermarks are pruned with their
            # incarnation.
            self._drop_conn(peer_node)
            for key in [k for k in self._in_seqs
                        if k[0] == peer_node and k[1] != peer_instance]:
                del self._in_seqs[key]
        in_key = (peer_node, peer_instance)
        acks = _AckBatch()
        #: known kind|src|dst frame heads on this connection: the prefix
        #: is byte-identical for every message of one (src, dst) stream,
        #: so after the first frame the envelope parse is one startswith
        heads: List[tuple] = []
        while True:
            rec = await framer.next_frame()
            if rec is None:
                break
            if session_key is not None:
                try:
                    rec = self._unseal(rec, session_key)
                except OSError:
                    break  # short/forged/tampered frame: drop the conn
            if not rec:
                break
            kind = rec[0]
            if kind == _K_SESSION:
                await self._reply_session(writer, session_key, in_key)
                continue
            if kind != _K_MSG:
                continue  # ACK frames never arrive on an inbound socket
            with _PS_ENVELOPE:
                for head, hsrc, hdst in heads:
                    if rec.startswith(head):
                        src, dst = hsrc, hdst
                        hlen = len(head)
                        break
                else:
                    dec = Decoder(rec, 1)
                    src = dec.string()
                    dst = dec.string()
                    heads.append((rec[:dec._pos], src, dst))
                    hlen = dec._pos
            # envelope tail + typed body.  ``msg is _UNDECODABLE`` =
            # unknown body kind: the watermark still advances and the
            # frame is counted-and-dropped -- forward compat for newer
            # peers' frame kinds.
            with _PS_ENVELOPE:
                dec = Decoder(rec, hlen)
                seq = dec.varint()
                body = dec.blob()
                # v4 piggyback: a trailing cumulative ack for OUR
                # reverse stream to this peer rides the data frame (v3
                # senders never append it; v3 receivers never read this
                # far)
                back_ack = dec.varint() if dec.remaining() else None
            try:
                with _PS_DECODE:
                    msg = decode_message(body)
            except ValueError:
                # a frame kind this build does not know (a NEWER peer's
                # message type): ignore-and-count below, after the
                # watermark bookkeeping
                msg = _UNDECODABLE
            if back_ack:
                sess = self._sessions.get(peer_node)
                if sess is not None:
                    self._prune_acked(sess, back_ack)
                self.counters["acks_piggybacked_recv"] += 1
            if seq:
                # lossless stream (in order per TCP connection).  A dst
                # we do not host YET (the boot window between
                # messenger.start and entity registration) must NOT be
                # acked -- break the connection instead, so the sender
                # replays once the entity exists.  A marked-down dst is
                # an intentional kill: ack-and-drop.
                if dst not in self._local_queues and \
                        dst not in self._marked_down:
                    break
                if self.cork:
                    # batched cumulative ack: at most one ACK frame per
                    # _ACK_DELAY window, elided entirely when our own
                    # outgoing data frames piggyback the watermark first
                    if not acks.scheduled:
                        acks.scheduled = True
                        asyncio.get_event_loop().call_later(
                            _ACK_DELAY, self._ack_tick, acks, writer,
                            session_key, peer_node, in_key)
                else:
                    await self._ack_now(writer, session_key, seq)
                # the dup check and the watermark advance are one
                # indivisible step, AFTER every await that can tear this
                # connection down (the per-message ack drain above).  An
                # await slipped between them lets the conn die with the
                # watermark past an undelivered message, so the
                # reconnect replay skips it -- silent loss.
                if seq <= self._in_seqs.get(in_key, 0):
                    continue  # duplicate from a replay: already delivered
                self._in_seqs[in_key] = seq
            if msg is _UNDECODABLE:
                # unknown frame kind (e.g. mgr report frames reaching a
                # pre-report daemon): the watermark already advanced, so
                # ignore-and-count is exactly "old daemon ignores report
                # frames" forward compat; tearing the connection down
                # here would make every protocol addition a flag day
                self.counters["unknown_msg_dropped"] += 1
                continue
            queue = self._local_queues.get(dst)
            if queue is not None and dst not in self._marked_down:
                if isinstance(msg, dict) and msg.get("op") == "client_op":
                    # throttle CLIENT ops only (the reference's
                    # DispatchThrottler guards the client messenger):
                    # sub-op replies must NEVER block here, or claimed
                    # client budget could wait on replies that are
                    # themselves stuck behind the throttle -- a
                    # distributed deadlock
                    cost = len(rec)
                    # deliberate budget HAND-OFF, not a leak: the cost
                    # rides the queue item and _dispatch_one releases
                    # it (or passes release to the claiming OSD) after
                    # the dispatcher runs -- that hand-off is what
                    # makes the byte cap a real memory bound
                    await self.dispatch_throttle.get(cost)  # cephlint: disable=async-lock-across-await
                    queue.put_nowait((src, msg, cost))
                else:
                    # unbounded queue: put() never blocks, put_nowait
                    # skips one coroutine round per delivered message
                    queue.put_nowait((src, msg))
        writer.close()

    async def _reply_session(self, writer, session_key, in_key) -> None:
        """Answer a reconnect watermark exchange (Pipe.cc connect reply):
        tell the peer what we have DELIVERED from this instance, so it
        replays everything after.  Once per (re)connect, never per
        message -- hence its own drain."""
        reply = Encoder().u8(_K_SESSION).varint(
            self._in_seqs.get(in_key, 0)).bytes()
        writer.write(frame(self._seal(reply, session_key)))
        await writer.drain()

    async def _ack_now(self, writer, session_key, seq: int) -> None:
        """Per-message ack write+drain (the uncorked / pre-v4 shape)."""
        ack = Encoder().u8(_K_ACK).varint(seq).bytes()
        writer.write(frame(self._seal(ack, session_key)))
        await writer.drain()
        self.counters["acks_standalone"] += 1

    def _ack_tick(self, acks: _AckBatch, writer, session_key,
                  peer_node: str, in_key: tuple) -> None:
        """Deferred cumulative ack (sync timer callback): skipped when a
        piggybacked watermark on our own data frames already covered it;
        otherwise one small ACK frame, written without a drain (acks
        gate nothing but sender-side queue pruning)."""
        acks.scheduled = False
        seq = self._in_seqs.get(in_key, 0)
        if seq <= acks.flushed:
            return
        if self._piggy_acked.get(peer_node, 0) >= seq:
            acks.flushed = seq  # rode one of our outgoing data frames
            self.counters["acks_elided"] += 1
            return
        acks.flushed = seq
        if self._closing or writer.is_closing():
            return  # sender reconnects and re-handshakes
        ack = Encoder().u8(_K_ACK).varint(seq).bytes()
        try:
            writer.write(frame(self._seal(ack, session_key)))
        except (ConnectionError, OSError, RuntimeError):
            return
        self.counters["acks_standalone"] += 1

    async def _auth_accept(self, framer, writer, peer_node: str,
                           client_nonce: bytes):
        """Acceptor half of the cephx-style handshake; returns the
        session key, or None to refuse."""
        from ceph_tpu_torch.auth.cephx import AuthHandshake

        secret = self.keyring.get(peer_node)
        if secret is None or not client_nonce:
            return None  # unknown entity / peer not speaking auth
        hs = AuthHandshake(secret, client_nonce, AuthHandshake.new_nonce())
        writer.write(frame(
            Encoder().blob(hs.server_nonce).blob(hs.server_proof()).bytes()
        ))
        await writer.drain()
        reply = await framer.next_frame()
        if reply is None:
            return None
        if not hs.verify_client(Decoder(reply).blob()):
            return None
        return hs.session_key()

    # -- client side -------------------------------------------------------

    def _node_of(self, entity: str) -> Optional[str]:
        """The node hosting an entity: itself if it has an address,
        else -- for hub-multiplexed entities named ``<name>@<node>``
        (the loadgen scale harness: thousands of client Objecters
        sharing a handful of client-hub messengers/ports) -- the node
        after the ``@``.  A reply to ``c137@lg0`` then rides the ONE
        cached connection to node ``lg0`` instead of opening a socket
        per client, and the hub's dispatch fans it to the registered
        entity queue by full name."""
        if entity in self.addr_map:
            return entity
        if "@" in entity:
            node = entity.rsplit("@", 1)[1]
            if node in self.addr_map:
                return node
        return None

    async def _connect(self, node: str):
        from ceph_tpu_torch.auth.cephx import AuthHandshake

        host, port = self.addr_map[node]
        ring = _shm.connect((host, port), fault=self.fault) \
            if self.shm_ring else None
        if ring is not None:
            reader, writer = ring
            self.counters["ring_conns"] += 1
        else:
            reader, writer = await asyncio.open_connection(host, port)
            self.counters["tcp_conns"] += 1
        framer = _FrameReader(reader, buffered=self.cork)
        nonce = AuthHandshake.new_nonce() if self.keyring is not None else b""
        banner = (
            Encoder().string(_BANNER).varint(_PROTOCOL_VERSION)
            .string(self.node).blob(nonce).blob(self.instance_id).bytes()
        )
        writer.write(frame(banner))
        await writer.drain()
        session_key = None
        if self.keyring is not None:
            secret = self.keyring.get(self.node)
            if secret is None:
                writer.close()
                raise OSError(f"no key for {self.node} in keyring")
            try:
                # a no-auth peer never answers the handshake: time out
                # with a clear error instead of hanging every send
                reply = await asyncio.wait_for(framer.next_frame(), 3.0)
            except asyncio.TimeoutError:
                writer.close()
                raise OSError(
                    f"{node} did not answer the auth handshake "
                    "(auth-mode mismatch?)"
                )
            if reply is None:
                writer.close()
                raise OSError(f"auth refused by {node}")
            dec = Decoder(reply)
            server_nonce = dec.blob()
            hs = AuthHandshake(secret, nonce, server_nonce)
            if not hs.verify_server(dec.blob()):
                writer.close()
                raise OSError(f"{node} failed to prove keyring knowledge")
            writer.write(frame(Encoder().blob(hs.client_proof()).bytes()))
            await writer.drain()
            session_key = hs.session_key()
        return framer, writer, asyncio.Lock(), session_key

    def _drop_conn(self, node: str) -> None:
        """Pop + close the cached conn to ``node``; if unacked lossless
        traffic is queued, re-arm the reconnect loop (the popped conn's
        own ack reader can no longer do it -- its currency check fails
        once the conn left the cache)."""
        conn = self._conns.pop(node, None)
        if conn is not None:
            conn[1].close()
        # piggybacked acks recorded against the dead conn may never have
        # arrived: forget them so the ack batcher sends a standalone
        # cumulative ack on the next inbound traffic instead of assuming
        # coverage (the peer's unacked queue must not pin entries)
        self._piggy_acked.pop(node, None)
        sess = self._sessions.get(node)
        if sess is not None and sess.sent and not self._closing \
                and node not in self._marked_down:
            self._spawn_reconnect(node)

    def _conn_lock(self, node: str) -> asyncio.Lock:
        lock = self._connect_locks.get(node)
        if lock is None:
            lock = self._connect_locks[node] = asyncio.Lock()
        return lock

    async def _try_establish(self, node: str):
        """Connect to ``node`` and cache the connection; for a lossless
        peer, run the session watermark exchange + replay first (the
        Pipe.cc connect() path).  Returns the conn or None (peer down,
        unreachable mark refreshed).  Serialized per node so concurrent
        senders share one connection."""
        async with self._conn_lock(node):
            conn = self._conns.get(node)
            if conn is not None:
                return conn
            try:
                conn = await self._connect(node)
            except OSError:
                self._unreachable[node] = asyncio.get_event_loop().time()
                return None
            if self._lossless(node):
                try:
                    await self._session_handshake(node, conn)
                except (OSError, ConnectionError, asyncio.TimeoutError):
                    conn[1].close()
                    self._unreachable[node] = \
                        asyncio.get_event_loop().time()
                    return None
                except BaseException:
                    # cancellation (e.g. a probe's outer wait_for): the
                    # already-open socket must not leak
                    conn[1].close()
                    raise
                self._spawn_ack_reader(node, conn)
            self._conns[node] = conn
            self._unreachable.pop(node, None)
            return conn

    async def _session_handshake(self, node: str, conn) -> None:
        """Exchange delivered-watermarks with the peer and retransmit
        everything it has not delivered (Pipe.cc connect/replay).  The
        whole replay burst goes out as one scatter-gather writelines
        with a single drain per snapshot round."""
        framer, writer, lock, skey = conn
        sess = self._sessions.setdefault(node, _SendSession())
        writer.write(frame(self._seal(
            Encoder().u8(_K_SESSION).bytes(), skey)))
        await writer.drain()
        rec = await asyncio.wait_for(framer.next_frame(), 3.0)
        if rec is None:
            raise OSError(f"{node}: session handshake EOF")
        dec = Decoder(self._unseal(rec, skey))
        if dec.u8() != _K_SESSION:
            raise OSError(f"{node}: bad session reply")
        self._prune_acked(sess, dec.varint())  # peer delivered these
        async with lock:
            # re-snapshot until stable: a send that lands while the
            # drain below is awaiting appends to sess.sent and is
            # caught by the next iteration
            sent_upto = 0
            while True:
                pending = [e for e in sess.sent if e.seq > sent_upto]
                if not pending:
                    break
                bufs: List = []
                for entry in pending:
                    bufs.extend(self._entry_frames(entry, skey, 0))
                    sent_upto = entry.seq
                writer.writelines(bufs)
                await writer.drain()

    def _spawn_ack_reader(self, node: str, conn) -> None:
        """Consume ACK frames off a lossless outgoing connection,
        pruning the unacked queue; on EOF drop the cached conn and, if
        traffic is pending, start the reconnect loop."""

        async def ack_loop():
            framer, skey = conn[0], conn[3]
            while True:
                rec = await framer.next_frame()
                if rec is None:
                    break
                try:
                    dec = Decoder(self._unseal(rec, skey))
                except OSError:
                    break
                if dec.u8() == _K_ACK:
                    sess = self._sessions.get(node)
                    if sess is not None:
                        self._prune_acked(sess, dec.varint())
            if self._conns.get(node) is conn:
                self._drop_conn(node)
            else:
                conn[1].close()  # superseded conn: just release it

        self.adopt_task(
            f"ack.{node}.{id(conn)}",
            asyncio.get_event_loop().create_task(ack_loop()),
        )

    def _spawn_reconnect(self, node: str) -> None:
        """Lossless-peer reconnect loop: keep dialing (bounded backoff)
        until the peer answers and the queued messages replay, or the
        peer is administratively down / the queue drains."""
        sess = self._sessions.setdefault(node, _SendSession())
        if sess.reconnecting:
            return
        sess.reconnecting = True

        async def reconnect_loop():
            try:
                delay = 0.2
                while True:
                    if (self._closing or node in self._marked_down
                            or not sess.sent):
                        return
                    if self._conns.get(node) is not None:
                        return  # re-established elsewhere (replay done)
                    if await self._try_establish(node) is not None:
                        return
                    await asyncio.sleep(delay)
                    delay = min(delay * 1.7, 2.0)
            finally:
                sess.reconnecting = False

        self.adopt_task(
            f"reconnect.{node}",
            asyncio.get_event_loop().create_task(reconnect_loop()),
        )

    def _prune_acked(self, sess: _SendSession, acked_seq: int) -> None:
        """Observe delivery-ack lag (enqueue -> cumulative-ack arrival)
        for every entry this ack releases, then prune the unacked
        queue -- the "ack" leg of the op timeline at the wire layer."""
        target = max(sess.acked, acked_seq)
        now = _time.monotonic()
        for entry in sess.sent:
            if entry.seq > target:
                break
            self._h_ack_lag.inc((now - entry.t_enq) * 1e6, entry.nbytes)
        sess.prune(acked_seq)

    # -- frame assembly (zero-copy seal/frame at transmit time) ------------

    def _msg_entry(self, src: str, dst: str, seq: int, msg: object
                   ) -> _QueuedMsg:
        """Encode one MSG payload as a part list: the wire body's parts
        nest into the transport envelope by reference (a large blob --
        EC shard bytes -- is never joined or copied; sub-4 KiB payloads
        collapse into one buffer, where a short memcpy beats per-part
        bookkeeping)."""
        # the kind|src|dst head is byte-identical for every message on
        # one (src, dst) stream: encode it once and reuse (entity names
        # are a small fixed set per daemon)
        with _PS_ENCODE:
            head = self._head_cache.get((src, dst))
            if head is None:
                head = self._head_cache[(src, dst)] = (
                    Encoder().u8(_K_MSG).string(src).string(dst).bytes())
            body_parts = message_encoder(msg)._parts
            body_len = sum(map(len, body_parts))
            pre = head + _varint_bytes(seq) + _varint_bytes(body_len)
            if len(pre) + body_len <= _JOIN_BELOW:
                entry = _QueuedMsg(seq, [b"".join([pre, *body_parts])])
            else:
                enc = Encoder()
                enc._parts = [pre] + body_parts
                entry = _QueuedMsg(seq, enc.parts(_JOIN_BELOW))
            _PS_ENCODE.add_bytes(entry.nbytes)
            return entry

    # The per-frame seal/flush seams below are wire hot sections:
    # payloads cross as part lists (the zero-copy contract) -- no
    # per-frame bytes concatenation inside.
    def _entry_frames(self, entry: _QueuedMsg, session_key,
                      ack: int) -> List:
        """On-wire buffer list for one queued message: cached payload
        parts + per-transmission tail (piggyback ack, signature), with
        the frame crc EXTENDED over the tail instead of recomputed over
        the payload (the double-crc audit: each digest runs once per
        burst element, retransmits included)."""
        with _PS_SEAL:
            crc = entry.crc
            if crc is None:
                crc = entry.crc = crc32c_parts(entry.parts)
            parts = entry.parts
            if ack:
                tail = _varint_bytes(ack)
                parts = parts + [tail]
                crc = crc32c(tail, crc)
            if session_key is not None:
                from ceph_tpu_torch.auth.cephx import sign_parts

                sig = sign_parts(session_key, parts)
                parts = parts + [sig]
                crc = crc32c(sig, crc)
            _PS_SEAL.add_bytes(entry.nbytes)
            return frame_parts(parts, crc)

    def _piggy_ack_value(self, node: str) -> int:
        """Cumulative delivered watermark of the reverse stream from
        ``node`` (what a data frame to it may piggyback)."""
        inst = self._peer_instances.get(node)
        if inst is None:
            return 0
        return self._in_seqs.get((node, inst), 0)

    # -- corked send queue (cork/flush; the wire-level coalescer) ----------

    def _enqueue_cork(self, node: str, entry: _QueuedMsg) -> None:
        """Queue one frame for ``node``; flush fires at end-of-tick
        (queue-drain: every already-runnable sender joins the burst) or
        immediately past the byte threshold -- the osd/coalescer.py
        flush discipline applied to the wire.  Deadlock-free for the
        same reason: a flush depends only on the event loop running,
        never on another message's completion."""
        with _PS_CORK:
            q = self._cork_queues.get(node)
            if q is None:
                q = self._cork_queues[node] = _CorkQueue()
            q.entries.append(entry)
            q.nbytes += entry.nbytes
            self.counters["msgs_sent"] += 1
            if q.flushing:
                return  # the slow-path flusher re-checks after its drain
            if q.nbytes >= self.cork_bytes:
                self._flush_now(node, q)
            elif not q.scheduled:
                q.scheduled = True
                asyncio.get_event_loop().call_soon(self._cork_tick, node)

    def _cork_tick(self, node: str) -> None:
        q = self._cork_queues.get(node)
        if q is None:
            return
        q.scheduled = False
        if q.entries and not q.flushing:
            self._flush_now(node, q)

    def _flush_now(self, node: str, q: _CorkQueue) -> None:
        """Synchronous fast path: seal + ``writelines`` the whole queue
        straight into the transport buffer -- no task, no lock, no
        drain.  ``drain()`` is flow control and runs (as a task) only
        once ``cork_bytes`` have been written since the last one.  Falls
        back to the async flusher when the connection is missing, mid-
        handshake (lock held: a replay is writing -- interleaving fresh
        seqs into a replay would break the receiver's dedup watermark),
        or already closing."""
        if self._closing:
            q.entries.clear()
            q.nbytes = 0
            return
        conn = self._conns.get(node)
        if conn is None or self._conn_lock(node).locked() or \
                conn[2].locked() or conn[1].is_closing():
            self._spawn_cork_flush(node)
            return
        batch, q.entries = q.entries, []
        q.nbytes = 0
        _framer, writer, _lock, skey = conn
        lossless = self._lossless(node)
        ack = self._piggy_ack_value(node) if lossless else 0
        last = len(batch) - 1
        bufs: List = []
        split = self.fault.conn_kill_split(len(batch))
        if split >= 0:
            # injected mid-burst kill: a prefix of the burst reaches the
            # wire, then the transport dies under the sender
            for entry in batch[:split]:
                bufs.extend(self._entry_frames(entry, skey, 0))
            if bufs:
                writer.writelines(bufs)
            writer.transport.abort()
            self._conn_failed(node, writer, lossless)
            self._requeue_lossy(node, q, batch, lossless)
            return
        prof_on = _profiler.enabled()
        t_burst = _time.perf_counter_ns() if prof_on else 0
        for i, entry in enumerate(batch):
            # the cumulative piggyback rides the LAST frame of the
            # burst; the receiver processes in order, one watermark
            # covers every earlier frame too
            bufs.extend(self._entry_frames(
                entry, skey, ack if i == last else 0))
        try:
            with _PS_WRITE:
                writer.writelines(bufs)
        except (ConnectionError, OSError, RuntimeError):
            self._conn_failed(node, writer, lossless)
            self._requeue_lossy(node, q, batch, lossless)
            return
        nbytes = sum(len(b) for b in bufs)
        if prof_on:
            # per-connection per-burst sub-accounting: frames/burst,
            # bytes/burst, ns/frame percentiles (the decomposition's
            # syscall-shape evidence)
            _profiler.note_burst(node, len(batch), nbytes,
                                 _time.perf_counter_ns() - t_burst)
        self.counters["bursts"] += 1
        self.counters["frames_sent"] += len(batch)
        self.counters["bytes_sent"] += nbytes
        if ack:
            self._piggy_acked[node] = max(
                self._piggy_acked.get(node, 0), ack)
            self.counters["acks_piggybacked"] += 1
        q.since_drain += nbytes
        if q.since_drain >= self.cork_bytes and not q.draining:
            q.draining = True
            self._cork_seq += 1
            task = asyncio.get_event_loop().create_task(
                self._drain_conn(node, q, conn))
            self.adopt_task(f"drain.{node}.{self._cork_seq}", task)

    def _requeue_lossy(self, node: str, q: _CorkQueue, batch,
                       lossless: bool) -> None:
        """A LOSSY conn died mid-burst in the sync fast path: hand the
        batch back to the queue and the slow-path flusher, which
        re-establishes and retries once before dropping -- the same
        one-shot redelivery courtesy ``_cork_flush`` already gives its
        own failures.  Without this the fast path silently loses the
        unsent tail of the burst while the peer stays up, and the
        client's probe loop -- which only demotes DEAD primaries --
        waits out the whole op deadline (the ring transport made this
        reachable: conns establish fast enough that the sync path, not
        the slow path, consumes mid-burst kills).  Lossless conns skip
        this: their entries live on ``sess.sent`` and the session
        replay machinery owns redelivery."""
        if lossless or self._closing:
            return
        q.entries = batch + q.entries
        q.nbytes = sum(e.nbytes for e in q.entries)
        self._spawn_cork_flush(node)

    def _conn_failed(self, node: str, writer, lossless: bool) -> None:
        """Shared dead-connection handling for the sync send path."""
        self._conns.pop(node, None)
        writer.close()
        self._piggy_acked.pop(node, None)
        self._unreachable[node] = asyncio.get_event_loop().time()
        if lossless:
            # unacked entries live on sess.sent: replay redelivers
            self._spawn_reconnect(node)

    async def _drain_conn(self, node: str, q: _CorkQueue, conn) -> None:
        """Flow-control drain: awaited once per ``cork_bytes`` written,
        not once per message."""
        try:
            await conn[1].drain()
            self.counters["drains"] += 1
            q.since_drain = 0
        except (ConnectionError, OSError):
            if self._conns.get(node) is conn:
                self._conn_failed(node, conn[1], self._lossless(node))
        finally:
            q.draining = False

    def _spawn_cork_flush(self, node: str) -> None:
        self._cork_seq += 1
        task = asyncio.get_event_loop().create_task(self._cork_flush(node))
        self.adopt_task(f"cork.{node}.{self._cork_seq}", task)

    async def _cork_flush(self, node: str) -> None:
        """Slow-path flusher (first contact, contended lock): drains the
        cork queue under the connection lock with a drain per pass;
        messages enqueued while a pass awaits are picked up by the next
        pass."""
        q = self._cork_queues.get(node)
        if q is None or q.flushing:
            return
        q.flushing = True
        lossless = self._lossless(node)
        attempts = 0
        try:
            while q.entries and not self._closing:
                conn = self._conns.get(node)
                if conn is None:
                    conn = await self._try_establish(node)
                if conn is None:
                    # peer down: lossy frames drop (lossy policy);
                    # lossless ones already sit on sess.sent -- the
                    # reconnect loop replays them
                    q.entries.clear()
                    q.nbytes = 0
                    if lossless:
                        self._spawn_reconnect(node)
                    return
                batch, q.entries = q.entries, []
                q.nbytes = 0
                _framer, writer, lock, skey = conn
                ack = self._piggy_ack_value(node) if lossless else 0
                last = len(batch) - 1
                try:
                    async with lock:
                        split = self.fault.conn_kill_split(len(batch))
                        if split >= 0:
                            prefix: List = []
                            for entry in batch[:split]:
                                prefix.extend(
                                    self._entry_frames(entry, skey, 0))
                            if prefix:
                                writer.writelines(prefix)
                            writer.transport.abort()
                            raise ConnectionResetError(
                                "injected mid-burst connection kill")
                        prof_on = _profiler.enabled()
                        t_burst = _time.perf_counter_ns() if prof_on \
                            else 0
                        bufs: List = []
                        for i, entry in enumerate(batch):
                            bufs.extend(self._entry_frames(
                                entry, skey, ack if i == last else 0))
                        with _PS_WRITE:
                            writer.writelines(bufs)
                        if prof_on:
                            _profiler.note_burst(
                                node, len(batch),
                                sum(len(b) for b in bufs),
                                _time.perf_counter_ns() - t_burst)
                        await writer.drain()
                except (ConnectionError, OSError, RuntimeError):
                    self._conn_failed(node, writer, lossless)
                    if lossless:
                        q.entries.clear()
                        q.nbytes = 0
                        return  # replay machinery owns redelivery
                    attempts += 1
                    if attempts > 1:
                        return  # lossy: one reconnect retry, then drop
                    q.entries = batch + q.entries
                    q.nbytes = sum(e.nbytes for e in q.entries)
                    continue
                self._unreachable.pop(node, None)
                self.counters["bursts"] += 1
                self.counters["drains"] += 1
                self.counters["frames_sent"] += len(batch)
                self.counters["bytes_sent"] += sum(len(b) for b in bufs)
                if ack:
                    self._piggy_acked[node] = max(
                        self._piggy_acked.get(node, 0), ack)
                    self.counters["acks_piggybacked"] += 1
        finally:
            q.flushing = False

    # -- send surface ------------------------------------------------------

    async def send_message(self, src: str, dst: str, msg: object) -> None:
        if src in self._marked_down or dst in self._marked_down:
            return
        hold = self.fault.send_hold(src, msg)
        if hold:
            await asyncio.sleep(hold)
        # local short-circuit
        queue = self._local_queues.get(dst)
        if queue is not None:
            if self.fault.maybe_drop():
                return
            if self.fault.delay_probability:
                await self.fault.maybe_delay()
            queue.put_nowait((src, msg))
            return
        node = self._node_of(dst)
        if node is None:
            return  # unknown peer: lossy
        if self.fault.maybe_drop():
            return
        if self.fault.delay_probability:
            await self.fault.maybe_delay()
        lossless = self._lossless(node)
        if not self.cork:
            # per-message baseline: join, seal, frame, write, drain --
            # one write + one drain per message (the pre-v4 shape)
            if lossless:
                await self._send_lossless(src, dst, node, msg)
            else:
                entry = self._msg_entry(src, dst, 0, msg)
                await self._send_lossy(node, self._join_entry(entry))
            return
        if lossless:
            sess = self._sessions.setdefault(node, _SendSession())
            if sess.sent_bytes >= self.lossless_max_backlog:
                return  # honest bound: beyond the backlog, drop
            sess.out_seq += 1
            entry = self._msg_entry(src, dst, sess.out_seq, msg)
            sess.sent.append(entry)
            sess.sent_bytes += entry.nbytes
        else:
            entry = self._msg_entry(src, dst, 0, msg)
        if self._conns.get(node) is None:
            # first contact (or a dropped conn): establish NOW so a down
            # peer is discovered -- and marked unreachable -- by the
            # send that hit it, exactly like the per-message path
            if await self._try_establish(node) is None:
                if lossless:
                    self._spawn_reconnect(node)  # queued; keep dialing
                return
            # the establishing handshake may already have replayed a
            # lossless entry (it was queued first); the receiver's
            # watermark swallows the duplicate -- double-send is safe,
            # silent loss is not
        self._enqueue_cork(node, entry)

    async def send_messages(
        self, src: str, pairs: Iterable[Tuple[str, object]]
    ) -> None:
        """Multi-destination submit: publish a whole fan-out (every EC
        sub-op of one client write) in one call.  Sequential enqueues
        stay within one event-loop tick once connections exist, so each
        peer's cork queue gathers its share of the fan-out into a single
        burst."""
        for dst, msg in pairs:
            await self.send_message(src, dst, msg)

    @staticmethod
    def _join_entry(entry: _QueuedMsg) -> bytes:
        return b"".join(
            p if type(p) is bytes else bytes(p) for p in entry.parts)

    async def _send_lossy(self, node: str, payload: bytes) -> None:
        conn = self._conns.get(node)
        if conn is None:
            conn = await self._try_establish(node)
            if conn is None:
                return
        _, writer, lock, skey = conn
        rec = frame(self._seal(payload, skey))
        async with lock:
            try:
                writer.write(rec)
                await writer.drain()
                self._count_single(len(rec))
                self._unreachable.pop(node, None)
            except (ConnectionError, OSError):
                self._conns.pop(node, None)
                writer.close()
                # one reconnect attempt (peer may have restarted)
                conn = await self._try_establish(node)
                if conn is None:
                    return
                try:
                    rec = frame(self._seal(payload, conn[3]))
                    conn[1].write(rec)
                    await conn[1].drain()
                    self._count_single(len(rec))
                except (ConnectionError, OSError):
                    self._conns.pop(node, None)
                    conn[1].close()
                    self._unreachable[node] = \
                        asyncio.get_event_loop().time()

    async def _send_lossless(self, src: str, dst: str, node: str,
                             msg: object) -> None:
        """Queue-then-send with replay-on-reconnect (lossless peer);
        per-message write+drain -- the uncorked baseline path."""
        sess = self._sessions.setdefault(node, _SendSession())
        if sess.sent_bytes >= self.lossless_max_backlog:
            return  # honest bound: beyond the backlog, drop like lossy
        sess.out_seq += 1
        entry = self._msg_entry(src, dst, sess.out_seq, msg)
        sess.sent.append(entry)
        sess.sent_bytes += entry.nbytes
        payload = self._join_entry(entry)
        conn = self._conns.get(node)
        if conn is None:
            conn = await self._try_establish(node)
            if conn is None:
                # queued; keep dialing in the background
                self._spawn_reconnect(node)
                return
            # fall through and send: the establishing handshake may
            # already have replayed this payload (it was queued first),
            # in which case the receiver's watermark swallows the
            # duplicate -- double-send is safe, silent loss is not
        _, writer, lock, skey = conn
        async with lock:
            try:
                if self.fault.conn_kill_split(1) == 0:
                    writer.transport.abort()
                    raise ConnectionResetError("injected connection kill")
                rec = frame(self._seal(payload, skey))
                writer.write(rec)
                await writer.drain()
                self._count_single(len(rec))
                self._unreachable.pop(node, None)
            except (ConnectionError, OSError):
                self._conns.pop(node, None)
                writer.close()
                self._unreachable[node] = asyncio.get_event_loop().time()
                self._spawn_reconnect(node)

    def _count_single(self, nbytes: int) -> None:
        """Counter update for a one-frame write+drain (baseline path)."""
        self.counters["msgs_sent"] += 1
        self.counters["frames_sent"] += 1
        self.counters["bursts"] += 1
        self.counters["drains"] += 1
        self.counters["bytes_sent"] += nbytes

    @staticmethod
    def _seal(payload: bytes, session_key) -> bytes:
        if session_key is None:
            return payload
        from ceph_tpu_torch.auth.cephx import sign

        return payload + sign(session_key, payload)

    @staticmethod
    def _unseal(rec: bytes, session_key) -> bytes:
        if session_key is None:
            return rec
        from ceph_tpu_torch.auth.cephx import verify as _verify

        if len(rec) < _SIG_LEN:
            raise OSError("short signed frame")
        body, sig = rec[:-_SIG_LEN], rec[-_SIG_LEN:]
        if not _verify(session_key, body, sig):
            raise OSError("bad frame signature")
        return body

    async def probe(self, entity: str, timeout: float = 1.0) -> bool:
        """Liveness probe: can we (re)connect to the entity's node?
        Updates the unreachable set -- the heartbeat role."""
        node = self._node_of(entity)
        if node is None or entity in self._marked_down:
            return False
        # drop any cached connection: it may be a dead socket whose peer
        # was SIGKILLed -- a probe must test the wire, not the cache
        self._drop_conn(node)
        try:
            conn = await asyncio.wait_for(
                self._try_establish(node), timeout)
        except asyncio.TimeoutError:
            self._unreachable[node] = asyncio.get_event_loop().time()
            return False
        return conn is not None

    # -- liveness view (thrasher + _shard_up hooks) ------------------------

    def mark_down(self, name: str) -> None:
        self._marked_down.add(name)

    def mark_up(self, name: str) -> None:
        self._marked_down.discard(name)
        self._unreachable.pop(self._node_of(name) or name, None)

    def is_down(self, name: str) -> bool:
        if name in self._marked_down:
            return True
        node = self._node_of(name)
        if node is None:
            return False
        t = self._unreachable.get(node)
        if t is None:
            return False
        if asyncio.get_event_loop().time() - t > self._unreachable_ttl:
            # stale observation: still report down (a genuinely dead
            # peer must not flap back up on a timer) but re-probe in the
            # background -- a live peer clears itself, a dead one
            # refreshes the timestamp
            self._schedule_reprobe(node)
        return True

    def _schedule_reprobe(self, node: str) -> None:
        if node in self._reprobing:
            return
        self._reprobing.add(node)

        async def reprobe():
            try:
                await self.probe(node)
            finally:
                self._reprobing.discard(node)

        task = asyncio.get_event_loop().create_task(reprobe())
        self.adopt_task(f"reprobe.{node}", task)
