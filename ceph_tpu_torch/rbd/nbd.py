"""rbd-nbd: expose an RBD image as an NBD block export.

Port of ``ceph_tpu/rbd/nbd.py``.

Reference: src/tools/rbd_nbd/rbd-nbd.cc -- the reference maps an image
into the kernel's nbd driver; here the same role is a standalone NBD
SERVER speaking the standard fixed-newstyle protocol, so any NBD client
(kernel nbd-client, qemu-nbd, nbdfuse) can attach an image as a block
device.  This also covers the rbd_fuse role (the other file/block
attachment surface) without requiring a FUSE runtime in the image.

Protocol per the canonical NBD spec (the same wire format
rbd-nbd.cc:307-340 services from the kernel side):

* handshake: ``NBDMAGIC`` + ``IHAVEOPT`` + handshake flags; client
  flags; option haggling (LIST / ABORT / EXPORT_NAME);
* transmission: 28-byte requests (magic 0x25609513) for
  READ/WRITE/DISC/FLUSH/TRIM, 16-byte simple replies (magic
  0x67446698).

WRITE and TRIM run through ``Image.write``/``Image.discard`` (snapshot
COW, object map, journaling all apply); FLUSH is a no-op acknowledgment
because every write is already durable at reply time (RADOS commit
semantics) -- the reference acks flush the same way after rbd_flush.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Dict, Optional

from ceph_tpu_torch.rbd.image import Image

NBDMAGIC = 0x4E42444D41474943        # "NBDMAGIC"
IHAVEOPT = 0x49484156454F5054        # "IHAVEOPT"
REP_MAGIC = 0x3E889045565A9

FLAG_FIXED_NEWSTYLE = 1 << 0
FLAG_NO_ZEROES = 1 << 1

OPT_EXPORT_NAME = 1
OPT_ABORT = 2
OPT_LIST = 3

REP_ACK = 1
REP_SERVER = 2
REP_ERR_UNSUP = (1 << 31) | 1

# transmission flags
FLAG_HAS_FLAGS = 1 << 0
FLAG_SEND_FLUSH = 1 << 2
FLAG_SEND_TRIM = 1 << 5

REQ_MAGIC = 0x25609513
REPLY_MAGIC = 0x67446698

CMD_READ = 0
CMD_WRITE = 1
CMD_DISC = 2
CMD_FLUSH = 3
CMD_TRIM = 4

EIO = 5
EINVAL = 22

#: largest request payload honored (the NBD spec's recommended cap;
#: without it a single 32-bit length field could make the server
#: buffer 4 GiB -- the dispatch-throttle class of problem)
MAX_PAYLOAD = 32 << 20

#: flow-control high-water mark: drain() is awaited only once this many
#: bytes sit unflushed on the transport.  Replies reach the wire
#: asynchronously as soon as they are written; a per-reply drain is one
#: coroutine round of pure overhead per request (the corked-
#: messenger discipline: drain is backpressure, not delivery)
DRAIN_HIWAT = 1 << 20


class NBDServer:
    """Serve the pool's RBD images over NBD (one export per image)."""

    def __init__(self, backend, host: str = "127.0.0.1", port: int = 0):
        self.backend = backend
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._serve_tasks: set = set()
        #: requests served, by command name (introspection/test hook)
        self.stats: Dict[str, int] = {}

    async def start(self) -> int:
        self._server = await asyncio.start_server(
            self._serve, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # 3.12's wait_closed waits on live handlers: cancel attached
            # clients first (kernel nbd-clients hold the device open)
            for task in list(self._serve_tasks):
                task.cancel()
            for task in list(self._serve_tasks):
                try:
                    await task
                except (asyncio.CancelledError, Exception):
                    pass
            await self._server.wait_closed()

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._serve_tasks.add(task)
        try:
            await self._serve_inner(reader, writer)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            self._serve_tasks.discard(task)
            writer.close()

    @staticmethod
    async def _pace(writer) -> None:
        """Backpressure only: a slow or stalled client eventually fills
        the transport buffer and this parks the handler until it
        drains, bounding per-connection memory.  Everything below the
        high-water mark flushes asynchronously without costing a
        coroutine round per reply."""
        if writer.transport.get_write_buffer_size() >= DRAIN_HIWAT:
            await writer.drain()

    async def _serve_inner(self, reader, writer) -> None:
        # -- fixed-newstyle handshake --------------------------------------
        writer.write(struct.pack(
            ">QQH", NBDMAGIC, IHAVEOPT,
            FLAG_FIXED_NEWSTYLE | FLAG_NO_ZEROES))
        await writer.drain()
        (client_flags,) = struct.unpack(
            ">I", await reader.readexactly(4))
        img: Optional[Image] = None
        while img is None:
            magic, opt, datalen = struct.unpack(
                ">QII", await reader.readexactly(16))
            data = await reader.readexactly(datalen) if datalen else b""
            if magic != IHAVEOPT:
                return
            if opt == OPT_EXPORT_NAME:
                name = data.decode()
                try:
                    img = await Image.open(self.backend, name)
                except FileNotFoundError:
                    return  # EXPORT_NAME has no error reply: disconnect
                flags = FLAG_HAS_FLAGS | FLAG_SEND_FLUSH | FLAG_SEND_TRIM
                out = struct.pack(">QH", img.size, flags)
                if not client_flags & FLAG_NO_ZEROES:
                    out += bytes(124)
                writer.write(out)
                await self._pace(writer)
            elif opt == OPT_LIST:
                from ceph_tpu_torch.rbd.image import RBD

                for name in await RBD(self.backend).list():
                    payload = struct.pack(">I", len(name)) + name.encode()
                    writer.write(struct.pack(
                        ">QIII", REP_MAGIC, opt, REP_SERVER, len(payload)
                    ) + payload)
                writer.write(struct.pack(">QIII", REP_MAGIC, opt,
                                         REP_ACK, 0))
                await self._pace(writer)
            elif opt == OPT_ABORT:
                writer.write(struct.pack(">QIII", REP_MAGIC, opt,
                                         REP_ACK, 0))
                return  # close() flushes the ack on the way out
            else:
                writer.write(struct.pack(">QIII", REP_MAGIC, opt,
                                         REP_ERR_UNSUP, 0))
                await self._pace(writer)

        # -- transmission phase --------------------------------------------
        while True:
            hdr = await reader.readexactly(28)
            magic, _flags, cmd, handle, offset, length = struct.unpack(
                ">IHHQQI", hdr)
            if magic != REQ_MAGIC:
                return
            if length > MAX_PAYLOAD:
                if cmd == CMD_WRITE:
                    return  # cannot resync past an absurd payload: drop
                writer.write(struct.pack(
                    ">IIQ", REPLY_MAGIC, EINVAL, handle))
                await self._pace(writer)
                continue
            payload = (await reader.readexactly(length)
                       if cmd == CMD_WRITE else b"")
            if cmd == CMD_DISC:
                self._count("disc")
                return
            err, out = 0, b""
            try:
                if cmd == CMD_READ:
                    self._count("read")
                    if offset + length > img.size:
                        err = EINVAL
                    else:
                        out = await img.read(offset, length)
                elif cmd == CMD_WRITE:
                    self._count("write")
                    if offset + length > img.size:
                        err = EINVAL
                    else:
                        await img.write(offset, payload)
                elif cmd == CMD_FLUSH:
                    self._count("flush")  # writes are already durable
                elif cmd == CMD_TRIM:
                    self._count("trim")
                    await img.discard(offset, length)
                else:
                    err = EINVAL
            except Exception:  # noqa: BLE001 -- a failed op answers EIO,
                # it must not kill the device (rbd-nbd.cc error path)
                err = EIO
            writer.write(struct.pack(">IIQ", REPLY_MAGIC, err, handle))
            if cmd == CMD_READ and not err:
                writer.write(out)
            await self._pace(writer)

    def _count(self, op: str) -> None:
        self.stats[op] = self.stats.get(op, 0) + 1
