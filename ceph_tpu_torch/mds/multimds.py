"""Multi-active MDS cluster: subtree partitioning + balancer.

Port of ``ceph_tpu/mds/multimds.py``.

Reference: a multi-MDS CephFS partitions the directory tree over active
ranks by SUBTREE AUTHORITY (src/mds/MDCache.cc subtree map, exports via
src/mds/Migrator.cc) and rebalances hot subtrees between ranks with the
MDBalancer (src/mds/MDBalancer.cc mds_load / try_rebalance).

This subset keeps the same authority model over the shared metadata
pool: every rank is a full ``MDS`` with its OWN journal and ino table
(``mds<rank>_*``), mutations on a path are serialized by the rank that
owns its subtree, and the subtree map itself is a replicated omap object
so a restarted coordinator (or a standby taking over a rank) sees the
same partition.  Cross-subtree renames journal the unlink in the source
rank and the link in the destination rank under both ranks' locks in
rank order (the reference's two-phase Migrator rename, reduced: our
dentries live in shared RADOS omaps, so no inode data moves).

The balancer is the MDBalancer reduced to its decision rule: per-subtree
request counters; when the busiest rank carries more than
``rebalance_factor`` times the load of the idlest, its hottest
non-root subtree is exported to the idlest rank.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ceph_tpu_torch.mds.mds import MDS, _dec, _enc

SUBTREE_MAP_OID = "mds_subtree_map"


class MultiMDS:
    """N active MDS ranks over one metadata pool."""

    def __init__(self, backend, n_ranks: int = 2,
                 rebalance_factor: float = 2.0):
        assert n_ranks >= 1
        self.backend = backend
        self.ranks: List[MDS] = [MDS(backend, rank=r)
                                 for r in range(n_ranks)]
        #: subtree authority: top-level path prefix -> rank ("" = root,
        #: always rank 0 -- the reference pins root to rank 0 too)
        self.subtrees: Dict[str, int] = {"": 0}
        #: per-subtree request counters (MDBalancer mds_load input)
        self.load: Dict[str, int] = {}
        self.rebalance_factor = rebalance_factor

    async def start(self) -> None:
        # rank 0 creates the root; later ranks only replay their journal
        for mds in self.ranks:
            await mds.start()
        try:
            raw = await self.backend.omap_get(SUBTREE_MAP_OID)
        except (FileNotFoundError, IOError):
            raw = {}
        for prefix, rank_b in raw.items():
            rank = int(_dec(rank_b))
            if rank < len(self.ranks):
                self.subtrees["" if prefix == "/" else prefix] = rank

    # -- subtree authority (MDCache subtree map role) ----------------------

    @staticmethod
    def _top(path: str) -> str:
        parts = [p for p in path.split("/") if p and p != "."]
        return parts[0] if parts else ""

    def rank_of(self, path: str) -> int:
        """The rank with authority over ``path``'s subtree."""
        return self.subtrees.get(self._top(path), self.subtrees[""])

    def _route(self, path: str) -> MDS:
        top = self._top(path)
        self.load[top] = self.load.get(top, 0) + 1
        mds = self.ranks[self.rank_of(path)]
        mds.op_count += 1
        return mds

    async def export_subtree(self, path: str, rank: int) -> None:
        """Move a top-level subtree's authority to ``rank`` (the
        Migrator export, reduced to an authority handoff: dentries live
        in shared RADOS omaps, so no data migrates)."""
        if not 0 <= rank < len(self.ranks):
            raise ValueError(f"no rank {rank}")
        top = self._top(path)
        if not top:
            raise ValueError("root stays on rank 0")
        # serialize against in-flight ops of the CURRENT authority: an
        # export mid-mutation would let two ranks mutate one subtree
        old = self.ranks[self.rank_of(path)]
        async with old._mutate_lock:
            self.subtrees[top] = rank
            await self.backend.omap_set(
                SUBTREE_MAP_OID, {top: _enc(rank)})

    async def balance(self) -> Optional[str]:
        """One MDBalancer pass: if the busiest rank carries >
        rebalance_factor x the idlest's load, export its hottest
        subtree there.  Returns the exported subtree or None."""
        per_rank: Dict[int, int] = {r: 0 for r in range(len(self.ranks))}
        for top, n in self.load.items():
            per_rank[self.subtrees.get(top, 0)] += n
        busiest = max(per_rank, key=per_rank.get)
        idlest = min(per_rank, key=per_rank.get)
        if busiest == idlest or per_rank[busiest] <= \
                self.rebalance_factor * max(1, per_rank[idlest]):
            return None
        candidates = [
            (n, top) for top, n in self.load.items()
            if top and self.subtrees.get(top, 0) == busiest
        ]
        if not candidates:
            return None
        _n, top = max(candidates)
        await self.export_subtree(top, idlest)
        self.load[top] = 0  # exported load starts fresh on the new rank
        return top

    # -- the FS surface, routed by subtree authority -----------------------

    async def mkdir(self, path: str) -> int:
        return await self._route(path).mkdir(path)

    async def create(self, path: str, **kw) -> dict:
        return await self._route(path).create(path, **kw)

    async def readdir(self, path: str):
        return await self._route(path).readdir(path)

    async def stat(self, path: str) -> dict:
        return await self._route(path).stat(path)

    async def set_size(self, path: str, size: int) -> None:
        await self._route(path).set_size(path, size)

    async def unlink(self, path: str) -> dict:
        return await self._route(path).unlink(path)

    async def rmdir(self, path: str) -> dict:
        return await self._route(path).rmdir(path)

    async def symlink(self, path: str, target: str) -> None:
        await self._route(path).symlink(path, target)

    async def readlink(self, path: str) -> str:
        return await self._route(path).readlink(path)

    async def setxattr(self, path: str, name: str, value: bytes) -> None:
        await self._route(path).setxattr(path, name, value)

    async def getxattrs(self, path: str):
        return await self._route(path).getxattrs(path)

    async def resolve_full(self, path: str, **kw):
        return await self._route(path).resolve_full(path, **kw)

    async def rename(self, src: str, dst: str) -> None:
        """Same-subtree renames run on the owning rank; cross-subtree
        renames take both ranks' mutation locks in rank order and
        journal the unlink on the source rank, the link on the
        destination rank (the Migrator rename, reduced -- see module
        docstring)."""
        a, b = self.rank_of(src), self.rank_of(dst)
        if a == b:
            await self._route(src).rename(src, dst)
            return
        from ceph_tpu_torch.mds.mds import FSError

        src_mds, dst_mds = self.ranks[a], self.ranks[b]
        first, second = sorted((src_mds, dst_mds), key=lambda m: m.rank)
        async with first._mutate_lock:
            async with second._mutate_lock:
                src_dir, src_name, dent = await src_mds.resolve_full(
                    src, follow=False)
                if dent is None:
                    raise FSError(
                        2, f"no such file or directory: {src!r}")
                dst_dir, dst_name, existing = await dst_mds.resolve_full(
                    dst, follow=False)
                if existing is not None:
                    raise FSError(17, f"exists: {dst!r}")
                # destination link journals on the DESTINATION rank,
                # then the source unlink on the SOURCE rank -- the same
                # link-before-unlink crash ordering as a local rename
                await dst_mds._journal_and_apply({
                    "op": "link", "dir": dst_dir, "name": dst_name,
                    "dentry": dent,
                })
                await src_mds._journal_and_apply({
                    "op": "unlink", "dir": src_dir, "name": src_name,
                })
