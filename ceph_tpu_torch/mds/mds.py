"""MDS rank 0: the metadata server (reference src/mds).

Port of ``ceph_tpu/mds/mds.py``.

State layout in the metadata pool (all through an Objecter, so the
namespace inherits EC durability, recovery and scrub):

* ``mds0_inotable``       omap {"next": int}        InoTable role
* ``mds0_journal``        omap {seq16: event}       MDLog/LogEvent role
*                         omap {"_committed": seq}  expire pointer
* ``<ino-hex>.dir``       omap {name: dentry}       CDir role

A dentry embeds its inode (CephFS primary-dentry embedding):
``{"ino", "type": "f"|"d", "size", "mtime", "layout": [su, sc, osz]}``.

Every mutation is journaled before application and applied with
idempotent operations, so replay after a crash (or by a standby taking
over) converges -- the up:replay state.  A single MDS serializes
mutations behind one asyncio lock (the reference serializes through the
MDCache locker at rank granularity).
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.utils.encoding import Decoder, Encoder

ROOT_INO = 1
#: rank-0 names kept for compatibility; instances use their
#: own self.journal_oid / self.inotable_oid (per-rank MDLog)
INOTABLE = "mds0_inotable"
JOURNAL = "mds0_journal"
COMMITTED_KEY = "_committed"
DEFAULT_LAYOUT = (1 << 20, 1, 1 << 20)  # (stripe_unit, count, object_size)


def dir_oid(ino: int) -> str:
    return f"{ino:x}.dir"


def data_oid(ino: int, objno: int) -> str:
    return f"{ino:x}.{objno:08x}"


def _enc(v) -> bytes:
    return Encoder().value(v).bytes()


def _dec(b: bytes):
    return Decoder(b).value()


class FSError(OSError):
    pass


class MDS:
    """One metadata-server rank over a RADOS backend (an Objecter).

    Rank 0 is the historical single-MDS shape; a multi-active cluster
    (``ceph_tpu_torch.mds.multimds.MultiMDS``) runs several ranks, each with
    its own journal and ino table (``mds<rank>_journal`` /
    ``mds<rank>_inotable`` -- the reference's per-rank MDLog and
    InoTable, src/mds/MDLog.cc, src/mds/InoTable.cc), serialized
    independently, with the namespace partitioned by subtree."""

    def __init__(self, backend, rank: int = 0):
        self.backend = backend
        self.rank = rank
        self.journal_oid = f"mds{rank}_journal"
        self.inotable_oid = f"mds{rank}_inotable"
        self._mutate_lock = asyncio.Lock()
        self._journal_seq = 0
        self.replayed = 0  # events replayed at the last start()
        self.op_count = 0  # balancer load metric (MDBalancer mds_load)

    # -- boot / journal replay (up:replay -> up:active) --------------------

    async def start(self) -> None:
        """Create the root on a fresh filesystem; replay the journal
        tail left by a crashed predecessor; trim it."""
        omap = await self.backend.omap_get(self.journal_oid)
        committed = int(
            _dec(omap[COMMITTED_KEY]) if COMMITTED_KEY in omap else 0
        )
        events = sorted(
            (int(k), _dec(v)) for k, v in omap.items()
            if k != COMMITTED_KEY
        )
        self.replayed = 0
        # new seqs must stay above the committed pointer even when the
        # journal is empty, else a fresh MDS reuses low seqs and its own
        # crash-recovery filter would skip them (review finding)
        self._journal_seq = max(self._journal_seq, committed)
        for seq, ev in events:
            self._journal_seq = max(self._journal_seq, seq)
            if seq > committed:
                await self._apply(ev)
                self.replayed += 1
        if events:
            await self._trim(max(s for s, _ in events))
        root = await self.backend.omap_get(dir_oid(ROOT_INO))
        if "." not in root:
            await self.backend.omap_set(dir_oid(ROOT_INO), {
                ".": _enc(self._mkdentry(ROOT_INO, "d")),
            })

    # -- inode allocation (InoTable) ---------------------------------------

    async def _alloc_ino(self) -> int:
        while True:
            cur = await self.backend.omap_get(self.inotable_oid, ["next"])
            have = int(_dec(cur["next"])) if "next" in cur else ROOT_INO + 1
            ok, _ = await self.backend.omap_cas(
                self.inotable_oid, "next",
                cur.get("next"), _enc(have + 1),
            )
            if ok:
                return have

    # -- journal -----------------------------------------------------------

    async def _journal_and_apply(self, ev: dict) -> None:
        """MDLog contract: the event is durable in the journal BEFORE the
        directory objects change; apply is idempotent for replay."""
        self._journal_seq += 1
        seq = self._journal_seq
        await self.backend.omap_set(self.journal_oid,
                                    {f"{seq:016d}": _enc(ev)})
        await self._apply(ev)
        await self._trim(seq, keys=[f"{seq:016d}"])

    async def _trim(self, upto: int, keys=None) -> None:
        """Advance the committed pointer and drop applied events (MDLog
        trim/expire).  The hot path passes the exact keys it just
        journaled; replay passes None and pays one full scan."""
        if keys is None:
            omap = await self.backend.omap_get(self.journal_oid)
            keys = [k for k in omap
                    if k != COMMITTED_KEY and int(k) <= upto]
        await self.backend.omap_set(self.journal_oid,
                                    {COMMITTED_KEY: _enc(upto)})
        if keys:
            await self.backend.omap_rm(self.journal_oid, keys)

    async def _apply(self, ev: dict) -> None:
        op = ev["op"]
        if op == "link":  # create dentry (mkdir/create/rename-target)
            await self.backend.omap_set(
                dir_oid(ev["dir"]), {ev["name"]: _enc(ev["dentry"])}
            )
            if ev["dentry"]["type"] == "d":
                await self.backend.omap_set(dir_oid(ev["dentry"]["ino"]), {
                    ".": _enc(self._mkdentry(ev["dentry"]["ino"], "d")),
                })
        elif op == "unlink":
            await self.backend.omap_rm(dir_oid(ev["dir"]), [ev["name"]])
        elif op == "setattr":
            cur = await self.backend.omap_get(dir_oid(ev["dir"]),
                                              [ev["name"]])
            if ev["name"] in cur:
                d = _dec(cur[ev["name"]])
                d.update(ev["attrs"])
                await self.backend.omap_set(
                    dir_oid(ev["dir"]), {ev["name"]: _enc(d)}
                )
        elif op == "xattr":
            # user xattrs ride in the dentry next to the embedded inode
            # (the reference's CInode xattr map); idempotent merge/erase
            cur = await self.backend.omap_get(dir_oid(ev["dir"]),
                                              [ev["name"]])
            if ev["name"] in cur:
                d = _dec(cur[ev["name"]])
                xattrs = d.get("xattrs", {})
                xattrs.update(ev.get("set", {}))
                for k in ev.get("rm", []):
                    xattrs.pop(k, None)
                d["xattrs"] = xattrs
                await self.backend.omap_set(
                    dir_oid(ev["dir"]), {ev["name"]: _enc(d)}
                )
        else:
            raise ValueError(f"unknown journal op {op!r}")

    # -- path resolution (MDCache::path_traverse) --------------------------

    @staticmethod
    def _split(path: str) -> List[str]:
        return [p for p in path.split("/") if p and p != "."]

    def _mkdentry(self, ino: int, typ: str, size: int = 0,
                  layout=DEFAULT_LAYOUT) -> dict:
        return {"ino": ino, "type": typ, "size": size,
                "mtime": int(time.time()), "layout": list(layout)}

    async def resolve(self, path: str, follow: bool = True,
                      _depth: int = 0) -> Tuple[int, Optional[dict]]:
        """-> (parent dir ino, dentry|None for the final component)."""
        parent, _name, dentry = await self.resolve_full(
            path, follow=follow, _depth=_depth)
        return parent, dentry

    async def resolve_full(self, path: str, follow: bool = True,
                           _depth: int = 0,
                           _chain: Optional[List[int]] = None
                           ) -> Tuple[int, str, Optional[dict]]:
        """-> (parent dir ino, RESOLVED final name, dentry|None); the
        root resolves to (ROOT_INO, ".", its self dentry).  Symlinks in
        the MIDDLE of a path are always followed; a final-component
        symlink only when ``follow`` (lstat vs stat).  Mutators MUST
        journal under the resolved name: after following a final
        symlink the real dentry lives in the TARGET's directory under
        the TARGET's name, and journaling the original link name would
        silently no-op on replay."""
        if _depth > 8:
            raise FSError(40, f"too many symlinks resolving {path!r}")
        parts = self._split(path)
        if _chain is not None and ROOT_INO not in _chain:
            _chain.append(ROOT_INO)  # collects every traversed dir ino
        if not parts:
            root = await self.backend.omap_get(dir_oid(ROOT_INO), ["."])
            return ROOT_INO, ".", _dec(root["."])
        cur = ROOT_INO
        for i, name in enumerate(parts):
            ent = await self.backend.omap_get(dir_oid(cur), [name])
            if name not in ent:
                if i == len(parts) - 1:
                    return cur, name, None
                raise FSError(2, f"no such directory: {name!r} in {path!r}")
            dentry = _dec(ent[name])
            last = i == len(parts) - 1
            if dentry["type"] == "l" and (follow or not last):
                rest = "/".join(parts[i + 1:])
                target = dentry["target"]
                newpath = target + ("/" + rest if rest else "")
                return await self.resolve_full(newpath, follow=follow,
                                               _depth=_depth + 1,
                                               _chain=_chain)
            if last:
                return cur, name, dentry
            if dentry["type"] != "d":
                raise FSError(20, f"not a directory: {name!r}")
            cur = dentry["ino"]
            if _chain is not None:
                _chain.append(cur)
        raise AssertionError("unreachable")

    async def _resolve_dir(self, path: str) -> int:
        _, dentry = await self.resolve(path)
        if dentry is None:
            raise FSError(2, f"no such file or directory: {path!r}")
        if dentry["type"] != "d":
            raise FSError(20, f"not a directory: {path!r}")
        return dentry["ino"]

    # -- metadata ops (Server::handle_client_request dispatch) -------------

    async def mkdir(self, path: str) -> int:
        async with self._mutate_lock:
            parent, name, existing = await self.resolve_full(path)
            if existing is not None:
                raise FSError(17, f"exists: {path!r}")
            ino = await self._alloc_ino()
            dentry = self._mkdentry(ino, "d")
            await self._journal_and_apply(
                {"op": "link", "dir": parent, "name": name,
                 "dentry": dentry}
            )
            return ino

    async def create(self, path: str, layout=DEFAULT_LAYOUT) -> dict:
        async with self._mutate_lock:
            parent, name, existing = await self.resolve_full(path)
            if existing is not None:
                if existing["type"] == "d":
                    raise FSError(21, f"is a directory: {path!r}")
                return existing  # open-existing semantics
            if not name or name == ".":
                raise FSError(22, "empty file name")
            ino = await self._alloc_ino()
            dentry = self._mkdentry(ino, "f", layout=layout)
            await self._journal_and_apply(
                {"op": "link", "dir": parent, "name": name,
                 "dentry": dentry}
            )
            return dentry

    async def readdir(self, path: str) -> Dict[str, dict]:
        ino = await self._resolve_dir(path)
        omap = await self.backend.omap_get(dir_oid(ino))
        return {
            name: _dec(raw) for name, raw in omap.items() if name != "."
        }

    async def stat(self, path: str) -> dict:
        _, dentry = await self.resolve(path)
        if dentry is None:
            raise FSError(2, f"no such file or directory: {path!r}")
        return dentry

    async def set_size(self, path: str, size: int) -> None:
        async with self._mutate_lock:
            parent, name, dentry = await self.resolve_full(path)
            if dentry is None:
                raise FSError(2, f"no such file: {path!r}")
            await self._journal_and_apply({
                "op": "setattr", "dir": parent, "name": name,
                "attrs": {"size": size, "mtime": int(time.time())},
            })

    async def unlink(self, path: str) -> dict:
        """Remove a FILE (or symlink) dentry; returns it (caller purges
        data objects -- the reference strays/purge queue role lives
        client-side here).  Never follows a final symlink: unlink
        removes the link, not its target."""
        async with self._mutate_lock:
            parent, name, dentry = await self.resolve_full(
                path, follow=False)
            if dentry is None:
                raise FSError(2, f"no such file: {path!r}")
            if dentry["type"] == "d":
                raise FSError(21, f"is a directory: {path!r}")
            await self._journal_and_apply(
                {"op": "unlink", "dir": parent, "name": name}
            )
            if dentry["type"] == "f":
                await self._purge_flock(dentry["ino"])
            return dentry

    async def rmdir(self, path: str) -> dict:
        """Remove an empty directory; returns its dentry.  Never
        follows a final symlink: POSIX rmdir on a symlink is ENOTDIR,
        not a deletion of the target directory."""
        async with self._mutate_lock:
            parent, name, dentry = await self.resolve_full(
                path, follow=False)
            if dentry is None:
                raise FSError(2, f"no such directory: {path!r}")
            if dentry["type"] != "d":
                raise FSError(20, f"not a directory: {path!r}")
            entries = await self.backend.omap_get(dir_oid(dentry["ino"]))
            if set(entries) - {"."}:
                raise FSError(39, f"directory not empty: {path!r}")
            await self._journal_and_apply(
                {"op": "unlink", "dir": parent, "name": name}
            )
            await self._purge_flock(dentry["ino"])
            return dentry

    async def symlink(self, path: str, target: str) -> None:
        """Create a symbolic link (Server::handle_client_symlink).
        Targets are absolute paths within this filesystem."""
        async with self._mutate_lock:
            parent, name, existing = await self.resolve_full(
                path, follow=False)
            if existing is not None:
                raise FSError(17, f"exists: {path!r}")
            ino = await self._alloc_ino()
            dentry = self._mkdentry(ino, "l")
            dentry["target"] = target
            await self._journal_and_apply(
                {"op": "link", "dir": parent, "name": name,
                 "dentry": dentry}
            )

    async def readlink(self, path: str) -> str:
        _, dentry = await self.resolve(path, follow=False)
        if dentry is None:
            raise FSError(2, f"no such file or directory: {path!r}")
        if dentry["type"] != "l":
            raise FSError(22, f"not a symlink: {path!r}")
        return dentry["target"]

    # -- user xattrs (CInode xattr map; Server::handle_set/removexattr) ----

    async def setxattr(self, path: str, name: str, value: bytes) -> None:
        async with self._mutate_lock:
            parent, rname, dentry = await self.resolve_full(path)
            if dentry is None:
                raise FSError(2, f"no such file or directory: {path!r}")
            await self._journal_and_apply({
                "op": "xattr", "dir": parent, "name": rname,
                "set": {name: bytes(value)},
            })

    async def removexattr(self, path: str, name: str) -> None:
        async with self._mutate_lock:
            parent, rname, dentry = await self.resolve_full(path)
            if dentry is None:
                raise FSError(2, f"no such file or directory: {path!r}")
            if name not in dentry.get("xattrs", {}):
                raise FSError(61, f"no xattr {name!r} on {path!r}")
            await self._journal_and_apply({
                "op": "xattr", "dir": parent, "name": rname,
                "rm": [name],
            })

    async def getxattrs(self, path: str) -> Dict[str, bytes]:
        _, dentry = await self.resolve(path)
        if dentry is None:
            raise FSError(2, f"no such file or directory: {path!r}")
        return dict(dentry.get("xattrs", {}))

    # -- advisory file locks (reference src/mds/flock.cc, setfilelock) -----

    def _flock_oid(self, ino: int) -> str:
        return f"{ino:x}.flock"

    async def _purge_flock(self, ino: int) -> None:
        """Drop an inode's lock object with it (runs under the mutate
        lock, so a racing flock cannot recreate it after the purge)."""
        try:
            await self.backend.omap_clear(self._flock_oid(ino))
            await self.backend.remove_object(self._flock_oid(ino))
        except (FileNotFoundError, IOError):
            pass  # never locked

    async def flock(self, path: str, owner: str,
                    exclusive: bool = True) -> None:
        """Acquire an advisory lock; -EAGAIN (BlockingIOError) on
        conflict -- shared locks coexist, exclusive conflicts with
        everything (the ceph_flock semantics, non-blocking form).
        Serialized under the mutate lock so a lock can never be taken
        on (or recreated for) an inode mid-unlink."""
        async with self._mutate_lock:
            await self._flock_locked(path, owner, exclusive)

    async def _flock_locked(self, path: str, owner: str,
                            exclusive: bool) -> None:
        _, dentry = await self.resolve(path)
        if dentry is None:
            raise FSError(2, f"no such file: {path!r}")
        oid = self._flock_oid(dentry["ino"])
        for _ in range(16):
            cur = await self.backend.omap_get(oid)
            raw = cur.get("holders")
            holders = _dec(raw) if raw else {}
            mode = "x" if exclusive else "s"
            others = {o: m for o, m in holders.items() if o != owner}
            if mode == "x" and others:
                raise BlockingIOError(
                    11, f"{path!r} locked by {sorted(others)}")
            if mode == "s" and any(m == "x" for m in others.values()):
                raise BlockingIOError(
                    11, f"{path!r} exclusively locked")
            holders[owner] = mode
            ok, _ = await self.backend.omap_cas(
                oid, "holders", raw, _enc(holders))
            if ok:
                return
        raise FSError(11, f"flock contended on {path!r}")

    async def funlock(self, path: str, owner: str) -> None:
        async with self._mutate_lock:
            await self._funlock_locked(path, owner)

    async def _funlock_locked(self, path: str, owner: str) -> None:
        _, dentry = await self.resolve(path)
        if dentry is None:
            raise FSError(2, f"no such file: {path!r}")
        oid = self._flock_oid(dentry["ino"])
        for _ in range(16):
            cur = await self.backend.omap_get(oid)
            raw = cur.get("holders")
            holders = _dec(raw) if raw else {}
            if owner not in holders:
                return
            del holders[owner]
            ok, _ = await self.backend.omap_cas(
                oid, "holders", raw, _enc(holders))
            if ok:
                return
        raise FSError(11, f"funlock contended on {path!r}")

    async def rename(self, src: str, dst: str) -> None:
        """Journaled as link(dst)+unlink(src): replay-idempotent and in
        that order, so a crash between them leaves a hard-link-like
        state, never a lost file (the reference journals both halves in
        one EUpdate)."""
        async with self._mutate_lock:
            sparent, sname, sdentry = await self.resolve_full(
                src, follow=False)
            if sdentry is None:
                raise FSError(2, f"no such file or directory: {src!r}")
            dparent, dname, ddentry = await self.resolve_full(
                dst, follow=False)
            if ddentry is not None:
                raise FSError(17, f"exists: {dst!r}")
            if sdentry["type"] == "d":
                # moving a directory under itself would orphan the
                # whole subtree behind an unreachable cycle (POSIX
                # EINVAL).  Checked on the RESOLVED ancestor-inode
                # chain of dst (symlink-proof, O(path depth)) -- a
                # textual prefix test would be defeated by an alias,
                # and a subtree scan would pay one read per
                # descendant directory.
                chain: List[int] = []
                await self.resolve_full(dst, follow=False, _chain=chain)
                if dparent == sdentry["ino"] or sdentry["ino"] in chain:
                    raise FSError(22, f"cannot move {src!r} into itself")
            await self._journal_and_apply({
                "op": "link", "dir": dparent,
                "name": dname, "dentry": sdentry,
            })
            await self._journal_and_apply({
                "op": "unlink", "dir": sparent, "name": sname,
            })

