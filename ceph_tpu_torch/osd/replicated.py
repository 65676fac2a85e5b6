"""Replicated (primary-copy) storage strategy for the PG engine.

Port of ``ceph_tpu/osd/replicated.py``.

Reference: src/osd/ReplicatedBackend.{h,cc} + the TYPE_REPLICATED arm of
build_pg_backend (src/osd/PGBackend.cc:533-570).  Every acting position
holds a FULL copy of the object; writes fan the same bytes to every up
replica and commit at ``min_size`` acks (pool min_size semantics,
src/osd/osd_types.h pg_pool_t); reads are served from one replica with
the shared version-authoritative gather falling back to newer holders
when the chosen copy is stale.

The machinery -- version gates, per-object write serialization, the
replicated metadata plane, snapshots, scrub scheduling, delta peering,
windowed recovery -- is ``osd.pg.PG``, shared with ECBackend,
parameterized by ``k = 1`` (any single full copy is assemblable): the
peering authority election then degenerates to newest-visible-copy-wins,
which is sound precisely because a full copy needs no quorum to decode.

Removal uses a version-stamped WHITEOUT tombstone ("removed") instead of
a bare delete: with k = 1 a single stale surviving copy would otherwise
win the authority election and resurrect the object (the EC strategy
caps survivors below k via its m+1 delete quorum; a replicated pool has
no such arithmetic, so the tombstone IS the guard -- the role the
reference's logged delete + PG-log replay plays, src/osd/PGLog.cc).

Exactly-once replay protection is inherited whole from the shared PG
engine: full-copy sub-writes and tombstone fan-outs are stamped with the
client op's reqid by ``PG._fanout_commit`` exactly like EC sub-writes,
so every applying replica records the PG-log dup entry with the
mutation and a replayed op after primary failover is answered from the
log on whichever replica is promoted (docs/resilience.md)."""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional

import numpy as np

from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.osd.messenger import Messenger
from ceph_tpu_torch.osd.pg import (
    PG,
    SIZE_KEY,
    SNAPSET_KEY,
    VERSION_KEY,
    WHITEOUT_KEY,
    ObjectIncomplete,
    shard_oid,
    snap_oid,
)
from ceph_tpu_torch.osd.types import ECSubWrite, LogEntry, Transaction
from ceph_tpu_torch.utils.perf import PerfCounters

#: WHITEOUT_KEY value marking a plain removal (vs True: a snap whiteout
#: that keeps clones readable).  Any truthy value reads as absent.
REMOVED = "removed"


class ReplicatedBackend(PG):
    """Primary engine for replicated pools: ``size`` full copies."""

    def __init__(
        self,
        size: int,
        osds: List,
        messenger: Messenger,
        name: str = "client",
        placement=None,
        register: bool = True,
        tid_alloc=None,
        perf: Optional[PerfCounters] = None,
        min_size: Optional[int] = None,
    ):
        assert size >= 1
        self.size = size
        self.k = 1          # one full copy assembles the object
        self.km = size      # placed positions
        self.m = size - 1
        # pool min_size default: size - size/2 (reference
        # OSDMonitor::prepare_new_pool / pg_pool_t), i.e. 2 for size=3
        self.min_size = min_size if min_size is not None else max(
            1, size - size // 2
        )
        # identity stripe algebra: a replica stores logical bytes as-is
        self.sinfo = ecutil.StripeInfo(1, 1)
        super().__init__(
            osds, messenger, name=name, placement=placement,
            register=register, tid_alloc=tid_alloc, perf=perf,
        )

    # -- write path --------------------------------------------------------

    def _full_copy_hinfo(self, buf: np.ndarray) -> ecutil.HashInfo:
        """Per-replica crc32c of the full copy (every position stores the
        same bytes, so every cumulative hash is the same)."""
        hinfo = ecutil.HashInfo(self.km)
        if len(buf):
            hinfo.append(0, {s: buf for s in range(self.km)})
        return hinfo

    async def _write_pinned(self, oid: str, data: bytes,
                            snapc=None) -> None:
        """Full-object write: the same bytes to every up replica
        (ReplicatedBackend::submit_transaction -> MOSDRepOp fan-out,
        src/osd/ReplicatedBackend.cc:1 issue_op)."""
        if oid not in self._versions or (
            snapc and oid not in self._snapsets
        ):
            await self._stat(oid)
        snapset, clone_id = self._snap_prepare(oid, snapc)
        version = self._next_version(oid)
        buf = np.frombuffer(data, dtype=np.uint8)
        hinfo = self._full_copy_hinfo(buf)

        acting = self.acting_set(oid)
        up = await self._up_for_write(oid, acting, self.min_size)
        tid = self._new_tid()
        entry = LogEntry(version=version[0], oid=oid, op="write",
                         prior_size=0)
        self.log.append(entry)
        payload = buf.tobytes()
        subs = []
        for s in range(self.km):
            if acting[s] is None:
                continue  # CRUSH hole
            soid = shard_oid(oid, s)
            txn = Transaction()
            if clone_id is not None:
                txn.clone(soid, shard_oid(snap_oid(oid, clone_id), s))
            txn = (
                txn
                .write(soid, 0, payload)
                .truncate(soid, len(payload))
                .setattr(soid, ecutil.HINFO_KEY, hinfo.to_dict())
                .setattr(soid, SIZE_KEY, len(data))
                .setattr(soid, VERSION_KEY, version)
                .setattr(soid, WHITEOUT_KEY, None)
            )
            self._pool_stamp(txn, soid)
            if snapset is not None:
                txn.setattr(soid, SNAPSET_KEY, snapset)
            subs.append((f"osd.{acting[s]}", ECSubWrite(
                from_shard=s, tid=tid, oid=oid, transaction=txn,
                at_version=version, log_entries=[entry])))
        self.perf.inc("write")
        await self._fanout_commit(
            oid, tid, subs, {f"osd.{acting[s]}" for s in up},
            min_acks=self.min_size,
        )
        self._snap_committed(oid, snapset, len(data))

    # -- read path ---------------------------------------------------------

    def _read_quorum_check(self, oid: str, acting, up) -> None:
        """Read-after-ack guard for k=1: every
        acked write reached >= min_size placed replicas, so a NEWER acked
        version can hide entirely among the unreachable holders only if
        >= min_size of them are unreachable.  In that regime the newest
        visible copy may be stale -- refuse, like the reference's PG
        going inactive below min_size, instead of serving silently."""
        placed = sum(1 for s in range(self.km) if acting[s] is not None)
        unseen = placed - len(up)
        if unseen >= self.min_size:
            raise ObjectIncomplete(
                f"{oid}: {unseen} of {placed} replicas unreachable "
                f"(>= min_size {self.min_size}); the newest acked write "
                "may be invisible -- refusing possibly-stale read"
            )

    async def read(self, oid: str) -> bytes:
        """Serve from one replica; the shared gather falls back to newer
        holders if the chosen copy is stale (the primary-read role,
        src/osd/PrimaryLogPG.cc do_osd_ops CEPH_OSD_OP_READ)."""
        acting = self.acting_set(oid)
        up = [s for s in range(self.km) if self._shard_up(acting, s)]
        if not up:
            up = await self._reconfirm_up(acting, up)
        if not up:
            raise IOError(f"cannot read {oid}: no replicas up")
        self._read_quorum_check(oid, acting, up)
        chunks, logical_size, attrs, _ = await self._gather_consistent(
            oid, up[:1], acting, up_shards=up
        )
        if not chunks:
            raise IOError(f"cannot read {oid}: only 0 replicas")
        if (attrs or {}).get(WHITEOUT_KEY) == REMOVED:
            raise IOError(f"cannot read {oid}: removed")
        if logical_size is None:
            raise IOError(f"no size metadata for {oid}")
        data = next(iter(chunks.values())).tobytes()
        self.perf.inc("read")
        return data[:logical_size]

    async def read_range(self, oid: str, offset: int, length: int) -> bytes:
        """Extent read from one replica -- no stripe algebra, the copy IS
        the logical byte stream."""
        size, _ = await self._stat(oid)
        if offset >= size:
            return b""
        length = min(length, size - offset)
        cached = self.extent_cache.get(oid, offset, length)
        if cached is not None:
            self.perf.inc("read_cache_hit")
            return cached
        acting = self.acting_set(oid)
        up = [s for s in range(self.km) if self._shard_up(acting, s)]
        if not up:
            raise IOError(f"cannot range-read {oid}: no replicas up")
        self._read_quorum_check(oid, acting, up)
        chunks, _, _, _ = await self._gather_consistent(
            oid, up[:1], acting, extents=[(offset, length)], up_shards=up,
        )
        if not chunks:
            raise IOError(f"cannot range-read {oid}")
        self.perf.inc("read_range")
        return next(iter(chunks.values())).tobytes()[:length]

    def _pin_bounds(self, offset: int, length: int):
        return offset, offset + max(1, length)

    async def _write_range_pinned(
        self, oid: str, offset: int, data: bytes, pin, snapc=None
    ) -> None:
        """Direct extent fan-out: replicas apply the same extent, gated on
        the base version so a replica that missed history skips (and is
        later recovered) instead of patching stale bytes -- no RMW read
        needed, the defining efficiency of replicated pools."""
        size, hinfo_d = await self._stat(oid)
        snapset, clone_id = self._snap_prepare(oid, snapc)
        base_version = self._versions.get(oid, 0)
        new_size = max(size, offset + len(data))
        buf = np.frombuffer(data, dtype=np.uint8)
        if offset == size and hinfo_d is not None and \
                ecutil.HashInfo.from_dict(hinfo_d).has_chunk_hash():
            hinfo = ecutil.HashInfo.from_dict(hinfo_d)
            hinfo.append(size, {s: buf for s in range(self.km)})
        elif offset == 0 and size == 0:
            hinfo = self._full_copy_hinfo(buf)
        else:
            # overwrite / gap: sizes only, hashes cleared (the
            # ec_overwrites-style reduction the EC strategy also uses)
            hinfo = ecutil.HashInfo(0)
            hinfo.total_chunk_size = new_size

        version = self._next_version(oid)
        acting = self.acting_set(oid)
        up = await self._up_for_write(oid, acting, self.min_size)
        tid = self._new_tid()
        entry = LogEntry(version=version[0], oid=oid, op="write",
                         prior_size=size)
        self.log.append(entry)
        subs = []
        for s in range(self.km):
            if acting[s] is None:
                continue
            soid = shard_oid(oid, s)
            txn = Transaction()
            if clone_id is not None:
                txn.clone(soid, shard_oid(snap_oid(oid, clone_id), s))
            txn = (
                txn
                .write(soid, offset, data)
                .setattr(soid, ecutil.HINFO_KEY, hinfo.to_dict())
                .setattr(soid, SIZE_KEY, new_size)
                .setattr(soid, VERSION_KEY, version)
                .setattr(soid, WHITEOUT_KEY, None)
            )
            self._pool_stamp(txn, soid)
            if snapset is not None:
                txn.setattr(soid, SNAPSET_KEY, snapset)
            subs.append((f"osd.{acting[s]}", ECSubWrite(
                from_shard=s, tid=tid, oid=oid, transaction=txn,
                at_version=version, log_entries=[entry],
                prev_version=base_version)))
        self.perf.inc("write_range")
        await self._fanout_commit(
            oid, tid, subs, {f"osd.{acting[s]}" for s in up},
            min_acks=self.min_size,
        )
        self._snap_committed(oid, snapset, new_size)
        pin.commit(offset, data)

    # -- removal strategy --------------------------------------------------

    async def _destroy_object(self, oid: str, up, acting) -> None:
        """Plain removal via version-stamped tombstone (see module
        docstring): truncate to zero + WHITEOUT "removed" at a NEW
        version, so a revived replica's stale full copy loses the
        authority election to the tombstone instead of resurrecting the
        object.  Recovery then propagates the tombstone (whiteout attr
        included) to stale replicas like any newest-version state."""
        version = self._next_version(oid)
        hinfo = ecutil.HashInfo(self.km)
        tid = self._new_tid()
        subs = []
        for s in up:
            soid = shard_oid(oid, s)
            txn = self._pool_stamp(
                Transaction()
                .truncate(soid, 0)
                .setattr(soid, ecutil.HINFO_KEY, hinfo.to_dict())
                .setattr(soid, SIZE_KEY, 0)
                .setattr(soid, VERSION_KEY, version)
                .setattr(soid, WHITEOUT_KEY, REMOVED)
                .setattr(soid, SNAPSET_KEY, None),
                soid,
            )
            subs.append((f"osd.{acting[s]}", ECSubWrite(
                from_shard=s, tid=tid, oid=oid,
                transaction=txn, at_version=version)))
        await self._fanout_commit(
            oid, tid, subs, {f"osd.{acting[s]}" for s in up},
            min_acks=self.min_size,
        )

    # -- scrub / recovery strategy hooks -----------------------------------

    def _scrub_verify(self, chunks: Dict[int, np.ndarray],
                      report: dict) -> None:
        """Copies must be byte-identical; replicas differing from the
        majority content are flagged (the replicated deep-scrub
        object-compare, reference src/osd/PG.cc scrub_compare_maps /
        be_select_auth_object)."""
        if len(chunks) < 2:
            return
        votes: Dict[bytes, list] = {}
        for s, arr in chunks.items():
            votes.setdefault(arr.tobytes(), []).append(s)
        if len(votes) == 1:
            return
        # majority wins; ties break toward the group containing the
        # lowest shard position (a deterministic auth pick, like the
        # reference's auth-object selection)
        auth = max(votes.values(), key=lambda g: (len(g), -min(g)))
        for group in votes.values():
            if group is not auth:
                report["parity_mismatch"].extend(group)
        report["parity_mismatch"].sort()

    def _min_sources(self, want_shards, up_shards):
        """Any single up replica rebuilds any other."""
        return list(up_shards[:1])

    def _rebuild_shard(self, chunks: Dict[int, np.ndarray],
                       shard: int) -> bytes:
        return next(iter(chunks.values())).tobytes()

    def _shard_bytes_total(self, logical_size: int) -> int:
        """A replica stores exactly the logical bytes."""
        return logical_size
