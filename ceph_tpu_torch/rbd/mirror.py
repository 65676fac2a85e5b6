"""rbd-mirror: journal-based image replication between clusters.

Port of ``ceph_tpu/rbd/mirror.py``.

Reference: src/tools/rbd_mirror -- a daemon that, for every
mirror-enabled image in a peer cluster, registers itself as a client on
the image's journal (src/journal JournalMetadata client registry),
bootstraps a local copy, then tails the journal and re-applies each
event locally (ImageReplayer), advancing its commit position on the
remote journal so trim cannot outrun it.

Reductions vs the reference (documented): pool-level peer config is a
constructor argument instead of mon-stored peer records; no
promotion/demotion tags (the source is always primary).  Bootstrap
deep-copies the snapshot history oldest-first and then the head (the
reference's image-sync snapshot walk); later events flow through the
journal.  The replay core -- client registry, positional restart,
idempotent event application, trim pinning -- matches the reference's
semantics and is what the tests exercise.
"""

from __future__ import annotations

from typing import Dict, List

from ceph_tpu_torch.rbd.image import RBD, Image, _data_oid
from ceph_tpu_torch.rbd.journal import (FEATURE_JOURNALING, MIRROR_DIR_OID,
                                        ImageJournal, apply_event)


# -- pool-level mirroring directory (cls_rbd mirror_image_* analogue) -------


async def mirror_enable(backend, image: str, primary: bool = True) -> None:
    """Mark an image for mirroring.  Requires the journaling feature
    (the reference refuses too: no journal, nothing to replay).  The
    enabling side starts PRIMARY (it owns the write role -- the
    reference's journal tag holds the owning mirror_uuid,
    src/librbd/Journal.cc allocate_tag); a replayer's destination copy
    is enabled non-primary."""
    img = await Image.open(backend, image)
    if FEATURE_JOURNALING not in img.features:
        raise IOError(f"image {image} does not have journaling enabled")
    state = b"enabled:primary" if primary else b"enabled:non-primary"
    await backend.omap_set(MIRROR_DIR_OID, {f"image_{image}": state})


async def mirror_is_primary(backend, image: str) -> bool:
    """Does the local copy own the write role?  Unmirrored images are
    always writable (the gate only exists for mirrored pairs)."""
    try:
        got = await backend.omap_get(MIRROR_DIR_OID, [f"image_{image}"])
    except FileNotFoundError:
        return True
    val = got.get(f"image_{image}")
    return val is None or b"non-primary" not in val


async def mirror_promote(backend, image: str, force: bool = False) -> None:
    """Take the write role for the local copy (`rbd mirror image
    promote`, reference src/tools/rbd_mirror + librbd Journal tag
    ownership): the normal failover is demote-old-primary first; with
    the old primary unreachable ``force=True`` promotes anyway
    (split-brain is then the operator's to resolve, as in the
    reference)."""
    key = f"image_{image}"
    try:
        got = await backend.omap_get(MIRROR_DIR_OID, [key])
    except FileNotFoundError:
        got = {}
    if key not in got:
        raise IOError(f"image {image} is not mirror-enabled")
    if b"non-primary" not in got[key] and not force:
        raise IOError(f"image {image} is already primary")
    await backend.omap_set(MIRROR_DIR_OID, {key: b"enabled:primary"})


async def mirror_demote(backend, image: str) -> None:
    """Release the write role (`rbd mirror image demote`): client
    writes refuse until a later promote, while a peer replayer keeps
    applying events."""
    key = f"image_{image}"
    try:
        got = await backend.omap_get(MIRROR_DIR_OID, [key])
    except FileNotFoundError:
        got = {}
    if key not in got:
        raise IOError(f"image {image} is not mirror-enabled")
    await backend.omap_set(MIRROR_DIR_OID, {key: b"enabled:non-primary"})


async def mirror_disable(backend, image: str,
                         peer_id: str = "mirror-peer") -> None:
    """Stop mirroring an image AND deregister the peer's journal
    client -- a stale client position would pin journal trim forever
    (the reference removes the peer client on disable too)."""
    await backend.omap_rm(MIRROR_DIR_OID, [f"image_{image}"])
    jr = ImageJournal(backend, image)
    await jr.open()
    await jr.unregister_peer(peer_id)


async def mirror_list(backend) -> List[str]:
    try:
        omap = await backend.omap_get(MIRROR_DIR_OID)
    except FileNotFoundError:
        return []
    return sorted(k[len("image_"):] for k in omap
                  if k.startswith("image_"))


# -- per-image replayer ------------------------------------------------------


class ImageReplayer:
    """Tail one image's journal from the source pool into the
    destination pool (rbd_mirror::ImageReplayer)."""

    def __init__(self, src_backend, dst_backend, image: str,
                 peer_id: str = "mirror-peer"):
        self.src = src_backend
        self.dst = dst_backend
        self.image = image
        self.peer_id = peer_id
        self._bootstrapped = False
        self.last_error: str = ""

    async def bootstrap(self) -> None:
        """Create the local image, deep-copy the snapshot history
        (oldest first, snapping the copy after each state -- the
        reference's image-sync snapshot walk), then copy the head.

        The journal position is captured BEFORE the copy starts but the
        peer client registers only AFTER the copy completes: the
        registration is the durable bootstrapped marker (a crashed
        half-bootstrap redoes the copy; a finished one is never
        repeated), and replay starts from the captured position so
        events racing the copy are still applied -- positional writes
        make double-application idempotent (the reference gets the same
        guarantee from its sync-point snapshot)."""
        # capture the replay start BEFORE reading the source metadata:
        # an event landing between the two is then merely replayed onto
        # state that may already include it (idempotent), never lost
        jr = ImageJournal(self.src, self.image)
        await jr.open()
        start_pos = jr.j.write_pos
        src_img = await Image.open(self.src, self.image)
        dst_rbd = RBD(self.dst)
        fresh = True
        try:
            await dst_rbd.create(self.image, src_img.size,
                                 order=src_img.order)
        except FileExistsError:
            # a prior partial bootstrap may have left data: every block
            # must be rewritten, including zeros over stale bytes
            fresh = False
        dst_img = await Image.open(self.dst, self.image)
        dst_dir = await self._dst_mirror_dir()
        ent = dst_dir.get(f"image_{self.image}")
        if ent is not None and b"non-primary" not in ent:
            # the destination copy owns the write role (it was promoted):
            # replaying onto it would silently destroy its writes --
            # the reference's split-brain detection refuses the same way
            raise IOError(
                f"destination image {self.image} is primary; refusing "
                "to replay onto it (demote it or force-resync)")
        dst_img._mirror_bypass = True
        for name, ent in sorted(src_img.snaps.items(),
                                key=lambda kv: kv[1]["id"]):
            view = await Image.open(self.src, self.image, snap=name)
            await self._copy_content(view, dst_img, fresh)
            fresh = False
            try:
                await dst_img.snap_create(name)
            except IOError:
                pass  # re-bootstrap after a partial earlier run
            if ent.get("protected"):
                await dst_img.snap_protect(name)
        await self._copy_content(src_img, dst_img, fresh)
        await jr.register_peer(self.peer_id, start_pos)
        # the destination copy is mirror-tracked NON-PRIMARY: client
        # writes there refuse until an operator promotes it (failover)
        await self.dst.omap_set(
            MIRROR_DIR_OID, {f"image_{self.image}": b"enabled:non-primary"})
        self._bootstrapped = True

    async def _dst_mirror_dir(self) -> dict:
        try:
            return await self.dst.omap_get(MIRROR_DIR_OID)
        except FileNotFoundError:
            return {}

    async def _copy_content(self, view: Image, dst_img: Image,
                            fresh: bool) -> None:
        """Copy one image state into dst.  On a fresh (never-written)
        destination all-zero blocks are skipped; on later passes every
        block is written so data deleted between snapshots does not
        survive as stale bytes."""
        if dst_img.size != view.size:
            await dst_img.resize(view.size)
        osz = 1 << view.order
        for object_no in range(view.striper.object_count(view.size)):
            # head-object stat is only a safe absence proxy when reading
            # the head itself (a snap view may be served by COW clones)
            if fresh and view.parent is None and view.read_snap_id is None:
                try:
                    sz, hinfo = await self.src.stat(
                        _data_oid(self.image, object_no))
                except (FileNotFoundError, IOError):
                    continue
                if sz == 0 and hinfo is None:
                    continue  # never written, nothing to copy
            base = object_no * osz
            span = min(osz, view.size - base)
            if span <= 0:
                continue
            block = await view.read(base, span)
            if block.strip(b"\0") or not fresh:
                await dst_img.write(base, block)

    async def replay_once(self) -> int:
        """Apply every pending journal event; returns how many."""
        jr = ImageJournal(self.src, self.image)
        await jr.open()
        if not self._bootstrapped:
            # a registered peer client IS the durable bootstrap marker:
            # a restarted daemon resumes from the persisted position
            # instead of re-copying the whole image
            if await jr.j.client_pos(self.peer_id) is not None:
                # one-way latch: every writer stores True, so two
                # replay_once calls racing this window agree on the
                # value -- nothing to clobber
                self._bootstrapped = True  # cephlint: disable=async-rmw-across-await
            else:
                await self.bootstrap()
        entries = await jr.peer_entries(self.peer_id)
        if entries:
            dst_img = await Image.open(self.dst, self.image)
            if dst_img._primary is not False:
                # split-brain guard (see bootstrap): never replay onto a
                # copy that owns the write role
                raise IOError(
                    f"destination image {self.image} is primary; "
                    "refusing to replay onto it")
            dst_img._mirror_bypass = True
            for _start, end, ev in entries:
                await apply_event(dst_img, ev)
                await jr.peer_committed(self.peer_id, end)
        await jr.trim()  # reuse this handle; consumed objects can go
        return len(entries)

    async def entries_behind(self) -> int:
        """Pending-event count.  peer_entries short-circuits the caught-
        up case on positions alone; a genuinely lagging peer pays one
        decode pass (the same I/O the next replay_once needs anyway)."""
        jr = ImageJournal(self.src, self.image)
        await jr.open()
        return len(await jr.peer_entries(self.peer_id))


# -- the daemon --------------------------------------------------------------


class MirrorDaemon:
    """One direction of an rbd-mirror daemon: replays every
    mirror-enabled image of ``src_backend`` into ``dst_backend``."""

    def __init__(self, src_backend, dst_backend,
                 peer_id: str = "mirror-peer"):
        self.src = src_backend
        self.dst = dst_backend
        self.peer_id = peer_id
        self.replayers: Dict[str, ImageReplayer] = {}

    async def run_once(self) -> Dict[str, int]:
        """One tick: pick up newly-enabled images, replay all pending
        events, trim consumed journal objects.  Returns events applied
        per image."""
        applied: Dict[str, int] = {}
        for image in await mirror_list(self.src):
            if not await mirror_is_primary(self.src, image):
                # this side's copy is demoted: the replication direction
                # reversed (failover) -- stop pulling from it
                applied[image] = 0
                continue
            rep = self.replayers.get(image)
            if rep is None:
                rep = self.replayers[image] = ImageReplayer(
                    self.src, self.dst, image, self.peer_id)
            try:
                applied[image] = await rep.replay_once()
                rep.last_error = ""
            except (FileNotFoundError, IOError) as e:
                # one broken image (deleted source, unreachable pool)
                # must not abort replay of every other image this tick
                rep.last_error = str(e) or type(e).__name__
                applied[image] = 0
        return applied

    async def status(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for image in await mirror_list(self.src):
            if not await mirror_is_primary(self.src, image):
                out[image] = {"state": "stopped", "reason": "non-primary"}
                continue
            rep = self.replayers.get(image)
            if rep is not None and rep.last_error:
                out[image] = {"state": "error", "error": rep.last_error}
            elif rep is None or not rep._bootstrapped:
                out[image] = {"state": "starting_replay"}
            else:
                behind = await rep.entries_behind()
                out[image] = {
                    "state": "replaying" if behind else "up+replaying",
                    "entries_behind": behind,
                }
        return out
