"""Journaler: the append-journal client library.

Port of ``ceph_tpu/osdc/journaler.py``: the same objects, omap keys and
framed entries, through the port's ``utils/encoding.py``.

Reference: src/osdc/Journaler.{h,cc} (CephFS MDLog's transport) and
src/journal (librbd journaling) -- a logical byte/entry stream striped
over numbered RADOS objects with four persisted pointers kept in a
header object: write_pos, expire_pos (trim), and the reader's committed
position.  Writers append framed entries; readers replay from the
committed position; trim drops whole journal objects behind expire_pos.

Layout: header omap on ``<name>.journal`` {write_pos, expire_pos,
commit_pos}; entry data appended to ``<name>.journal.<objno>`` objects
of ``object_size`` bytes.  Entries are crc-framed with the shared
encoding framework, so a torn tail (partial append at crash) is
detected and replay stops cleanly at it -- the same guarantee the
reference gets from its entry headers.

Named clients: src/journal's JournalMetadata keeps a registry of
clients (the image itself plus mirror peers), each with its own commit
position; trim may only advance past what EVERY client has consumed
(src/journal/JournalMetadata.cc client_s / committed()).  Here clients
live in the same header omap under ``client.<id>`` keys and
``trim()`` takes the minimum over the master commit position and all
registered clients.
"""

from __future__ import annotations

import asyncio
from typing import List, Optional, Tuple

from ceph_tpu_torch.utils.encoding import Decoder, Encoder, frame, unframe


def _enc(v) -> bytes:
    return Encoder().value(v).bytes()


def _dec(b):
    return Decoder(b).value() if b else None


class Journaler:
    def __init__(self, backend, name: str, object_size: int = 1 << 22):
        self.backend = backend
        self.name = name
        self.object_size = object_size
        self.write_pos = 0
        self.expire_pos = 0
        self.commit_pos = 0
        #: serializes append(): two concurrent appenders would read the
        #: same write_pos, stripe both records over the same extent and
        #: lose one (a read-modify-write across an await; the reference
        #: Journaler serializes appends on its lock too)
        self._append_lock = asyncio.Lock()

    @property
    def _header(self) -> str:
        return f"{self.name}.journal"

    def _data(self, objno: int) -> str:
        return f"{self.name}.journal.{objno:08x}"

    # -- header ------------------------------------------------------------

    async def create(self) -> None:
        await self.backend.omap_set(self._header, {
            "write_pos": _enc(0), "expire_pos": _enc(0),
            "commit_pos": _enc(0),
        })

    async def open(self) -> None:
        omap = await self.backend.omap_get(self._header)
        if "write_pos" not in omap:
            await self.create()
            return
        self.write_pos = _dec(omap["write_pos"])
        self.expire_pos = _dec(omap["expire_pos"])
        self.commit_pos = _dec(omap["commit_pos"])

    # -- append (Journaler::append_entry + flush) --------------------------

    async def append(self, entry) -> int:
        """Append one entry (any encodable value); returns its start
        position.  The entry never splits an object boundary mid-frame
        the hard way: a frame that would cross pads to the next object
        (the reference pads with a skip entry at object boundaries)."""
        rec = frame(_enc(entry))
        osz = self.object_size
        async with self._append_lock:
            start = self.write_pos
            if start // osz != (start + len(rec) - 1) // osz:
                start = ((start // osz) + 1) * osz  # next object
            objno, off = divmod(start, osz)
            await self.backend.write_range(self._data(objno), off, rec)
            self.write_pos = start + len(rec)
            # persist only the field this writer owns: the header is
            # shared with committers and trimmers (e.g. a mirror
            # daemon) whose in-memory copies of the OTHER pointers may
            # be stale
            await self.backend.omap_set(
                self._header, {"write_pos": _enc(self.write_pos)})
        return start

    # -- replay (Journaler::read_entry loop) -------------------------------

    async def replay(self, from_pos: Optional[int] = None
                     ) -> List[Tuple[int, object]]:
        """Entries from ``from_pos`` (default: commit_pos) to the write
        head; a torn tail (crashed writer) ends replay cleanly."""
        return [(start, entry) for start, _end, entry in
                await self.replay_entries(from_pos)]

    async def replay_entries(self, from_pos: Optional[int] = None
                             ) -> List[Tuple[int, int, object]]:
        """Like replay but yields (start, end, entry) -- consumers that
        track their own commit position (mirror peers) need the end
        offset of each entry to advance past it."""
        pos = self.commit_pos if from_pos is None else from_pos
        pos = max(pos, self.expire_pos)
        out: List[Tuple[int, int, object]] = []
        osz = self.object_size
        cached_objno, blob = None, b""
        while pos < self.write_pos:
            objno, off = divmod(pos, osz)
            if objno != cached_objno:
                try:
                    blob = await self.backend.read(self._data(objno))
                except IOError:
                    break  # trimmed/missing object
                cached_objno = objno
            rec, newoff = unframe(bytes(blob), off)
            if rec is None:
                # torn or padded tail: skip to the next object if the
                # writer did, else stop (crash tail)
                next_obj = (objno + 1) * osz
                if next_obj < self.write_pos:
                    pos = next_obj
                    continue
                break
            end = objno * osz + newoff
            out.append((pos, end, _dec(rec)))
            pos = end
        return out

    # -- client registry (src/journal JournalMetadata clients) -------------

    async def register_client(self, client_id: str,
                              pos: Optional[int] = None) -> int:
        """Register a named consumer (e.g. a mirror peer) at ``pos``
        (default: the current write head).  Idempotent: re-registering
        returns the existing position."""
        key = f"client.{client_id}"
        omap = await self.backend.omap_get(self._header)
        if key in omap:
            return _dec(omap[key])
        start = self.write_pos if pos is None else pos
        await self.backend.omap_set(self._header, {key: _enc(start)})
        return start

    async def unregister_client(self, client_id: str) -> None:
        await self.backend.omap_rm(self._header, [f"client.{client_id}"])

    async def client_pos(self, client_id: str) -> Optional[int]:
        omap = await self.backend.omap_get(self._header)
        raw = omap.get(f"client.{client_id}")
        return None if raw is None else _dec(raw)

    async def clients(self) -> dict:
        omap = await self.backend.omap_get(self._header)
        return {k[len("client."):]: _dec(v) for k, v in omap.items()
                if k.startswith("client.")}

    # -- commit / trim (Journaler::set_expire_pos + trim) ------------------

    async def committed(self, pos: int,
                        client: Optional[str] = None) -> None:
        """The reader durably applied everything below ``pos``.  With
        ``client`` set, advances that registered client's position
        instead of the master commit pointer."""
        if client is not None:
            cur = await self.client_pos(client)
            if cur is None or pos > cur:
                await self.backend.omap_set(
                    self._header, {f"client.{client}": _enc(pos)})
            return
        self.commit_pos = max(self.commit_pos, pos)
        await self.backend.omap_set(
            self._header, {"commit_pos": _enc(self.commit_pos)})

    async def trim(self) -> int:
        """Drop whole journal objects below the commit position
        (expire); returns objects removed.  A lagging registered client
        pins the journal: trim never passes the slowest consumer.

        Re-reads the header first and writes back only expire_pos:
        trimmers (a mirror daemon tick) share the header with the live
        appender, and persisting stale write/commit pointers here would
        roll back committed appends."""
        await self.open()
        osz = self.object_size
        floor = min([self.commit_pos]
                    + list((await self.clients()).values()))
        target = (floor // osz) * osz
        removed = 0
        for objno in range(self.expire_pos // osz, target // osz):
            try:
                await self.backend.remove_object(self._data(objno))
                removed += 1
            except IOError:
                pass
        if target > self.expire_pos:
            self.expire_pos = target
            await self.backend.omap_set(
                self._header, {"expire_pos": _enc(target)})
        return removed
