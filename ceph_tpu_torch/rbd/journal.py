"""RBD image journaling (reference: src/librbd/Journal.cc over
src/journal).

Port of ``ceph_tpu/rbd/journal.py``.

With the ``journaling`` feature enabled, every mutating image op is
recorded as a typed event in a per-image journal (``rbd_journal.<name>``
striped over RADOS objects via the shared Journaler) BEFORE it is
applied to the image, and the master commit position advances only
after the data path accepted it.  Two consumers read this stream:

- crash replay: ``Image.open`` re-applies any events between the commit
  position and the write head (the reference's librbd::Journal replay
  on open when the journal is not clean);
- rbd-mirror: a peer registered as a named journal client tails the
  stream into a remote image (``ceph_tpu_torch.rbd.mirror``) and its commit
  position pins trim, exactly like the reference's mirror-peer client
  in src/journal/JournalMetadata.

Events mirror librbd::journal::EventType (AioWriteEvent, ResizeEvent,
SnapCreateEvent, SnapRemoveEvent, SnapRollbackEvent, FlattenEvent).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ceph_tpu_torch.osdc.journaler import Journaler

FEATURE_JOURNALING = "journaling"
MASTER_CLIENT = ""  # the image's own replay uses the master commit_pos

# pool-level mirroring directory (lives here, not in mirror.py, so the
# image layer can refuse feature changes that would break mirroring
# without a circular import)
MIRROR_DIR_OID = "rbd_mirroring"


def journal_name(image: str) -> str:
    return f"rbd_journal.{image}"


async def destroy_journal(backend, image: str) -> None:
    """Remove an image's journal: every data object plus the header
    (reference: librbd::Journal::remove on feature disable / image
    removal)."""
    j = Journaler(backend, journal_name(image))
    await j.open()
    osz = j.object_size
    for objno in range(j.expire_pos // osz, j.write_pos // osz + 1):
        try:
            await backend.remove_object(j._data(objno))
        except (FileNotFoundError, IOError):
            pass
    try:
        await backend.omap_clear(j._header)  # pointers live in omap
        await backend.remove_object(j._header)
    except (FileNotFoundError, IOError):
        pass


class ImageJournal:
    """Typed-event wrapper over a Journaler for one image."""

    def __init__(self, backend, image: str, object_size: int = 1 << 20):
        self.j = Journaler(backend, journal_name(image),
                           object_size=object_size)

    async def open(self) -> None:
        await self.j.open()

    # -- append (librbd::Journal::append_io_event / append_op_event) ------

    async def append(self, event: dict) -> Tuple[int, int]:
        """Append one event; returns (start, end) stream positions."""
        start = await self.j.append(event)
        return start, self.j.write_pos

    async def commit(self, end_pos: int) -> None:
        await self.j.committed(end_pos)

    # -- replay -----------------------------------------------------------

    async def uncommitted(self) -> List[Tuple[int, int, dict]]:
        """Events appended but not yet committed (crash tail)."""
        return await self.j.replay_entries()

    # -- mirror-peer client registry --------------------------------------

    async def register_peer(self, peer_id: str,
                            pos: Optional[int] = None) -> int:
        return await self.j.register_client(peer_id, pos)

    async def unregister_peer(self, peer_id: str) -> None:
        await self.j.unregister_client(peer_id)

    async def peer_entries(self, peer_id: str
                           ) -> List[Tuple[int, int, dict]]:
        """Pending entries for a REGISTERED peer; an unknown peer gets
        nothing (registration is bootstrap's job -- auto-registering
        here would both skip bootstrap and pin trim at 0)."""
        pos = await self.j.client_pos(peer_id)
        if pos is None or pos >= self.j.write_pos:
            return []
        return await self.j.replay_entries(pos)

    async def peer_committed(self, peer_id: str, end_pos: int) -> None:
        await self.j.committed(end_pos, client=peer_id)

    async def trim(self) -> int:
        return await self.j.trim()


async def apply_event(image, event: dict) -> None:
    """Apply one journal event to an image through the plain data path
    (journaling suppressed by the caller).  Snapshot events tolerate
    already-applied states so replay after a crash between apply and
    commit is idempotent (the reference checks applied op return codes
    the same way, librbd::journal::Replay)."""
    op = event["op"]
    if op == "write":
        await image.write(event["off"], event["data"])
    elif op == "discard":
        await image.discard(event["off"], event["len"])
    elif op == "resize":
        await image.resize(event["size"])
    elif op == "snap_create":
        try:
            await image.snap_create(event["name"])
        except IOError:
            pass  # -EEXIST: applied before the crash
    elif op == "snap_remove":
        try:
            await image.snap_remove(event["name"])
        except PermissionError:
            raise  # protected snap: real divergence, never swallow
        except (IOError, FileNotFoundError):
            pass  # -ENOENT: applied before the crash
    elif op == "snap_protect":
        await image.snap_protect(event["name"])  # idempotent in cls_rbd
    elif op == "snap_unprotect":
        await image.snap_unprotect(event["name"])
    elif op == "snap_rollback":
        await image.snap_rollback(event["name"])
    elif op == "flatten":
        await image.flatten()
    else:
        raise ValueError(f"unknown journal event {op!r}")
