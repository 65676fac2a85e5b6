"""Erasure-coded storage strategy for the PG engine.

Port of ``ceph_tpu/osd/ecbackend.py``.

Reference: src/osd/ECBackend.{h,cc} reduced to the EC essentials:

* writes are append-only (the reference's default without ec_overwrites,
  src/osd/osd_types.h:1516) and run a fan-out/2-phase-ack pipeline with
  in-order completion (ECBackend.h:522-573 write pipeline,
  ECBackend.cc:1976-2030 sub-write fan-out, :2043 try_finish_rmw);
* reads pick the cheapest shard set via minimum_to_decode and reconstruct
  when degraded (ECBackend.cc:2284 objects_read_and_reconstruct, :1569
  get_min_avail_to_read_shards);
* every shard read cross-checks the stored per-shard crc32c
  (handle_sub_read, ECBackend.cc:1054-1076) and reports EIO on mismatch,
  which the primary treats as a missing shard;
* recovery reconstructs lost shards from the minimum available set and
  pushes them to the replacement OSD (continue_recovery_op,
  ECBackend.cc:535-700);
* client-class sub-writes carry the originating op's reqid (stamped by
  the shared ``PG._fanout_commit``), so every applying shard records a
  PG-log dup entry with the mutation itself -- the exactly-once replay
  guard across primary failover (docs/resilience.md).

Shard objects are stored as "<oid>@<shard>" in each OSD's store with the
HashInfo + logical size as xattrs.

The PG-generic machinery (versioning, locks, the metadata
plane, snapshots, scrub scheduling, peering, the recovery driver) lives
in ``ceph_tpu_torch.osd.pg.PG`` -- the reference's PG / PGBackend layering
(src/osd/PG.h:1, src/osd/PGBackend.h:1) -- and this module holds only
the EC strategy.  The OSD daemon role moved to ``ceph_tpu_torch.osd.shard``.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, List, Optional

import numpy as np

from ceph_tpu_torch.ops.pipeline import uncached_uploads
from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.osd.messenger import Messenger
from ceph_tpu_torch.osd.pg import (  # noqa: F401  (compat re-exports)
    MCLOCK_DEFAULTS,
    OP_PRIORITY,
    PG,
    SIZE_KEY,
    SNAPSET_KEY,
    VERSION_KEY,
    WHITEOUT_KEY,
    ObjectIncomplete,
    WriteConflict,
    meta_vt,
    shard_oid,
    snap_oid,
    vt,
)
from ceph_tpu_torch.osd.shard import OSDShard  # noqa: F401  (compat re-export)
from ceph_tpu_torch.osd.types import ECSubWrite, LogEntry, Transaction
from ceph_tpu_torch.utils import trace
from ceph_tpu_torch.utils.perf import PerfCounters, stage_histogram


class ECBackend(PG):
    """EC primary engine: placement, write pipeline, read/reconstruct.

    This engine is HOSTED INSIDE the primary OSD daemon
    (``OSDShard.host_pool``) -- the reference architecture, where the
    client's Objecter sends one op to the primary OSD which owns the PG
    and fans out sub-ops (src/osd/PrimaryLogPG.cc, dispatch at
    src/osd/OSD.cc:6439, fan-out src/osd/ECBackend.cc:1976-2030).  A
    standalone client-side instance (``register=True``) remains possible
    and is what the multi-primary race tests exercise.
    """

    def __init__(
        self,
        ec,
        osds: List,
        messenger: Messenger,
        name: str = "client",
        placement=None,
        register: bool = True,
        tid_alloc=None,
        perf: Optional[PerfCounters] = None,
        min_size: Optional[int] = None,
        coalesce: Optional[bool] = None,
    ):
        self.ec = ec
        self.k = ec.get_data_chunk_count()
        self.km = ec.get_chunk_count()
        self.m = self.km - self.k
        #: write-acceptance floor: the reference defaults EC min_size to
        #: k + min(1, m-1) (OSDMonitor::prepare_new_pool pg_pool_t) --
        #: accepting a write with exactly k shards up would commit it
        #: with zero redundancy.  m == 1 keeps k (no redundancy exists
        #: to demand); an explicit pool min_size overrides.
        self.min_size = min_size if min_size is not None else (
            self.k + min(1, max(0, self.m - 1))
        )
        stripe_width = self.k * ec.get_chunk_size(1)
        self.sinfo = ecutil.StripeInfo(self.k, stripe_width)
        super().__init__(
            osds, messenger, name=name, placement=placement,
            register=register, tid_alloc=tid_alloc, perf=perf,
        )
        # per-PG codec coalescers: concurrent CLIENT ops gather their
        # encode/decode work into batched dispatches (recovery, scrub
        # and peering keep direct codec calls -- the client-op-only
        # scoping that keeps the batching deadlock-free, see
        # ceph_tpu_torch/osd/coalescer.py)
        if coalesce is None:
            from ceph_tpu_torch.utils.config import get_config

            coalesce = bool(get_config().get_val("osd_ec_op_coalesce"))
        from ceph_tpu_torch.osd.coalescer import BatchCoalescer

        self._enc_coalescer = BatchCoalescer(
            self._encode_dispatch, perf=self.perf,
            counter="ec_encode_coalesce",
        ) if coalesce else None
        self._dec_coalescer = BatchCoalescer(
            self._decode_dispatch, perf=self.perf,
            counter="ec_decode_coalesce",
        ) if coalesce else None

    # -- batched codec dispatch (the stripe-batching pipeline seam) --------

    def _mesh_plane(self):
        """The process mesh data plane, iff gated on AND this pool's
        codec can ride it (matrix technique, w=8) -- the coalescer then
        dispatches its fused batches PG-sliced over the mesh instead of
        single-device (ceph_tpu_torch/parallel/mesh_plane.py)."""
        from ceph_tpu_torch.parallel import mesh_plane as mesh_mod

        plane = mesh_mod.current_plane()
        if plane is None or not plane.can_encode(self.ec):
            return None
        return plane

    def _encode_dispatch(self, items):
        """items: (shard-major block, want_resident, pgid) triples from
        :meth:`_encode_op`; one fused, bucketed pipeline dispatch covers
        the whole batch.  Returns (chunk_map, device_block) per item --
        the device block is the still-resident [k+m, bs] encode output
        for stripes the tier wants hot (promote-from-encode).  With the
        mesh data plane up, the batch instead rides ONE PG-sliced
        dispatch (each stripe placed on the mesh slot owning its PG,
        parity scattered in-collective where the devices allow)."""
        blocks = [b for b, _keep, _pg in items]
        plane = self._mesh_plane()
        if plane is not None:
            # a coalesced batch belongs to THIS primary: encode it on
            # the primary's own mesh slot (different primaries' batches
            # land on different slots and overlap); an unbound
            # primary (client-side engine) spreads by PG ownership
            encs = plane.encode_shard_major_many(
                self.ec, blocks, [pg for _b, _keep, pg in items],
                slot=plane.slot_of(self.name))
            return [(enc, None) for enc in encs]
        keep = [keep for _b, keep, _pg in items]
        encs, devs = ecutil.encode_shard_major_many_resident(
            self.ec, blocks, range(self.km), keep)
        return list(zip(encs, devs))

    def _decode_dispatch(self, maps):
        plane = self._mesh_plane()
        if plane is not None:
            return plane.decode_concat_many(
                self.sinfo, self.ec, maps,
                slot=plane.slot_of(self.name))
        return ecutil.decode_concat_many(self.sinfo, self.ec, maps)

    def _pg_of(self, oid: str) -> int:
        """The object's PG id (the mesh plane's slice-ownership key);
        0 without CRUSH placement (mod-placement clusters slice by
        batch order instead)."""
        if self.placement is None:
            return 0
        return self.placement.pg_of(oid)

    async def _encode_op(self, buf, want_resident: bool = False,
                         oid: str = ""):
        """Client-op encode: the transpose runs per op (cheap host view
        work), the codec dispatch batches with every other client op in
        flight this tick.  Returns ``(chunk_map, device_block)`` --
        the device block is None unless ``want_resident`` and the codec
        composed one on device."""
        block = ecutil.to_shard_major(self.sinfo, self.k, buf)
        pgid = self._pg_of(oid) if oid else 0
        if self._enc_coalescer is None:
            # direct (uncoalesced) path: same timeline events as the
            # coalescer records, batch of one
            trace.event("encode_submit")
            items = [(block, want_resident, pgid)]
            out = self._encode_dispatch(items)[0]
            trace.event("encode_done")
            return out
        return await self._enc_coalescer.submit(
            (block, want_resident, pgid), block.nbytes)

    async def _decode_op(self, chunks) -> bytes:
        """Client-op decode: stripes sharing an erasure signature ride
        one fused reconstruction dispatch."""
        if self._dec_coalescer is None:
            trace.event("decode_submit")
            out = ecutil.decode_concat(self.sinfo, self.ec, chunks)
            trace.event("decode_done")
            return out
        nbytes = sum(c.nbytes for c in chunks.values())
        return await self._dec_coalescer.submit(chunks, nbytes)

    # -- device cache tier (ceph_tpu_torch/tier/) --------------------------

    def _tier_read(self, oid: str, offset: Optional[int] = None,
                   length: Optional[int] = None) -> Optional[bytes]:
        """Hit path: serve the logical bytes straight from the resident
        shard-major device block -- one D2H of the data rows + the
        logical transpose; no sub-read fan-out, no frombuffer ingest,
        and no decode even when the acting set is degraded (all km
        positions are resident).  With ``offset``/``length`` the column
        selection ALSO happens on device: only the covering stripes'
        chunk columns cross the bus, and the returned bytes are exactly
        the requested extent.  None = miss / tier off / stale."""
        tier = self._tier
        if tier is None or self.tier_mode not in ("writeback", "readproxy"):
            return None
        ent = tier.lookup(self.pool_name, oid)
        if ent is None:
            return None
        known = self._versions.get(oid)
        if known is not None and ent.version[0] < known:
            # this primary already assigned/learned a newer version:
            # the resident block predates it
            tier.invalidate(self.pool_name, oid)
            self.perf.inc("tier_stale_drop")
            return None
        from ceph_tpu_torch.analysis.residency import (device_get,
                                                       resident_section)

        start = 0
        if offset is not None:
            if offset >= ent.logical_size:
                return b""
            length = min(length, ent.logical_size - offset)
            start, span = self.sinfo.offset_len_to_stripe_bounds(
                offset, length)
            chunk_off = self.sinfo.aligned_logical_offset_to_chunk_offset(
                start)
            chunk_len = (span // self.sinfo.stripe_width) * \
                self.sinfo.chunk_size
        pos = ecutil.data_positions(self.ec)
        # row (and, for extents, chunk-column) selection happens ON
        # DEVICE; the declared region pins the hit path's contract --
        # exactly one D2H (the seam below), of only the bytes a read
        # needs
        # cephlint: device-resident-section tier-hit-read
        with resident_section("tier-hit-read"):
            if pos == list(range(self.k)):
                # the common layout: data rows lead -- D2H only those
                dev_rows = ent.block[:self.k]
                remap = None
            else:
                dev_rows = ent.block  # remapped chunks: whole block
                remap = pos
            if offset is not None:
                hi = min(chunk_off + chunk_len, dev_rows.shape[1])
                dev_rows = dev_rows[:, chunk_off:hi]
        # cephlint: end-device-resident-section
        host = device_get(dev_rows)  # the hit path's ONE designed D2H
        rows = host if remap is None else np.stack([host[p] for p in remap])
        from ceph_tpu_torch.tier.device_tier import reassemble_data_rows

        data = reassemble_data_rows(rows, self.sinfo.chunk_size)
        self.perf.inc("tier_hit_read")
        if offset is None:
            return data[:ent.logical_size]
        lo = offset - start
        return data[lo:lo + length]

    def _tier_hist(self, which: str):
        """Lazy tier read-latency observers (hit vs miss), shared per
        daemon name -- the ``ceph_hist_tier_read_{hit,miss}_usec``
        prometheus families."""
        attr = f"_h_tier_{which}"
        h = getattr(self, attr, None)
        if h is None:
            h = stage_histogram(f"{self.name}.tier_read_{which}_usec")
            setattr(self, attr, h)
        return h

    def _tier_hot(self, oid: str) -> bool:
        if self._hitset_temp is None:
            return False
        from ceph_tpu_torch.utils.config import get_config

        return self._hitset_temp(oid) >= float(
            get_config().get_val("osd_tier_promote_temp")
        )

    def _promote_from_encode_on(self) -> bool:
        """Promote-from-encode toggle: hand the tier the still-resident
        encode output instead of re-uploading the host copy."""
        if self._tier is None or self.tier_mode != "writeback":
            return False
        from ceph_tpu_torch.utils.config import get_config

        return bool(get_config().get_val("osd_tier_promote_from_encode"))

    def _want_resident(self, oid: str, logical: int) -> bool:
        """Should this write's encode keep its device block for the
        tier?  Mirrors :meth:`_tier_write_update`'s put predicate so the
        block is composed exactly when it will be inserted."""
        return bool(logical) and self._promote_from_encode_on() and (
            self._tier.contains(self.pool_name, oid) or self._tier_hot(oid)
        )

    def _tier_write_update(self, oid: str, encoded, version,
                           logical: int, dev_block=None) -> bool:
        """Write-through tier update: in writeback mode a hot (or
        already-resident) object's freshly encoded block -- the very
        arrays the coalescer's batched dispatch just produced -- replaces
        the resident copy, marked DIRTY until the fan-out commits
        (promote-on-write).  With ``dev_block`` (promote-from-encode)
        the insert is the encode pipeline's still-resident [k+m, bs]
        device output: ZERO re-upload -- otherwise the host arrays ride
        one device_put.  Any other resident copy is invalidated
        (readproxy/cold writes must not serve pre-write bytes)."""
        tier = self._tier
        if tier is None or self.tier_mode == "none":
            return False
        resident = tier.contains(self.pool_name, oid)
        if self.tier_mode == "writeback" and logical and (
            resident or self._tier_hot(oid)
        ):
            # resident blocks are keyed by the mesh slice owning the
            # object's PG (None off-plane): the tier's per-slice
            # accounting is how "which device holds what" stays a
            # ledger fact once the plane slices ownership
            plane = self._mesh_plane()
            mesh_slice = plane.owner_slot(self._pg_of(oid)) \
                if plane is not None else None
            if dev_block is not None:
                tier.put(self.pool_name, oid, dev_block, version, logical,
                         dirty=True, resident_origin=True,
                         mesh_slice=mesh_slice)
                return True
            block = np.stack([
                np.asarray(encoded[s], dtype=np.uint8)
                for s in range(self.km)
            ])
            tier.put(self.pool_name, oid, block, version, logical,
                     dirty=True, mesh_slice=mesh_slice)
            return True
        if resident:
            tier.invalidate(self.pool_name, oid)
        return False

    # -- write path --------------------------------------------------------

    async def _write_pinned(self, oid: str, data: bytes,
                            snapc=None) -> None:
        # a primary that has never touched this object must learn its
        # current version first: overwriting with a regressed version
        # would be refused by the shards' stale-write gate
        if oid not in self._versions or (
            snapc and oid not in self._snapsets
        ):
            await self._stat(oid)
        snapset, clone_id = self._snap_prepare(oid, snapc)
        version = self._next_version(oid)
        logical = len(data)
        padded_len = self.sinfo.logical_to_next_stripe_offset(logical)
        buf = np.zeros(padded_len, dtype=np.uint8)
        buf[:logical] = np.frombuffer(data, dtype=np.uint8)

        dev_block = None
        if padded_len:
            # decide promote-from-encode BEFORE dispatch so the pipeline
            # composes the [k+m, bs] device block exactly when the tier
            # will insert it (and exempts that granule from donation)
            encoded, dev_block = await self._encode_op(
                buf, self._want_resident(oid, logical), oid=oid)
        else:
            # zero-byte object (S3 markers, touch): no stripes to encode
            encoded = [np.zeros(0, dtype=np.uint8) for _ in range(self.km)]
        hinfo = ecutil.HashInfo(self.km)
        if padded_len:
            hinfo.append(0, encoded)

        acting = self.acting_set(oid)
        # min_size: write acceptance needs min_size live shards (commit
        # quorum below stays k -- acceptance, not completion, is gated)
        up = await self._up_for_write(oid, acting, self.min_size)
        tid = self._new_tid()
        entry = LogEntry(version=version[0], oid=oid, op="append",
                         prior_size=0)
        self.log.append(entry)
        subs = []
        for s in range(self.km):
            if acting[s] is None:
                continue  # CRUSH hole: no device for this position
            soid = shard_oid(oid, s)
            txn = Transaction()
            if clone_id is not None:
                txn.clone(soid, shard_oid(snap_oid(oid, clone_id), s))
            txn = (
                txn
                .write(soid, 0, encoded[s].tobytes())
                .truncate(soid, len(encoded[s]))
                .setattr(soid, ecutil.HINFO_KEY, hinfo.to_dict())
                .setattr(soid, SIZE_KEY, logical)
                .setattr(soid, VERSION_KEY, version)
            )
            txn.setattr(soid, WHITEOUT_KEY, None)
            self._pool_stamp(txn, soid)
            if snapset is not None:
                txn.setattr(soid, SNAPSET_KEY, snapset)
            subs.append((f"osd.{acting[s]}", ECSubWrite(
                from_shard=s,
                tid=tid,
                oid=oid,
                transaction=txn,
                at_version=version,
                log_entries=[entry],
            )))
        self.perf.inc("write")
        # write-through tier update BEFORE the fan-out: the block rides
        # dirty (unreadable) until the commit below confirms it
        tier_put = self._tier_write_update(oid, encoded, version, logical,
                                           dev_block)
        try:
            await self._fanout_commit(
                oid, tid, subs, {f"osd.{acting[s]}" for s in up},
                min_acks=self.k,
            )
            self._snap_committed(oid, snapset, logical)
            if tier_put:
                self._tier.mark_clean(self.pool_name, oid, version)
        except BaseException:
            if tier_put:
                # the fan-out failed: the device copy is unconfirmed
                self._tier.invalidate(self.pool_name, oid)
            raise

    # -- read path ---------------------------------------------------------

    async def read(self, oid: str) -> bytes:
        """objects_read_and_reconstruct: minimum shards, degraded
        fallback -- after consulting the device tier (a hit costs one
        D2H + transpose, no fan-out and no decode)."""
        if self._hitset_record is not None:
            # reads heat the hit sets too (the tier agent's temperature
            # source; write-only recording would never promote a
            # read-hot object)
            self._hitset_record(oid)
        t0 = time.monotonic()
        cached = self._tier_read(oid)
        if cached is not None:
            # tier-hit attribution: one D2H + transpose, no fan-out --
            # the histogram pair the mgr exposes as hit-vs-miss read
            self._tier_hist("hit").inc(
                (time.monotonic() - t0) * 1e6, len(cached))
            trace.event("tier_hit")
            self.perf.inc("read")
            return cached
        tiered = self.tier_mode in ("writeback", "readproxy")
        if tiered:
            trace.event("tier_miss")
        acting = self.acting_set(oid)
        up_shards = [
            s
            for s in range(self.km)
            if self._shard_up(acting, s)
        ]
        if len(up_shards) < self.k:
            # don't fail on a possibly-stale liveness view: probe the
            # down-looking holders once (the reference re-peers on
            # heartbeat recovery; a just-revived primary's messenger may
            # carry unreachable marks from boot-time connect races)
            up_shards = await self._reconfirm_up(acting, up_shards)
        want = ecutil.data_positions(self.ec)
        minimum = self.ec.minimum_to_decode(want, up_shards)
        chunks, logical_size, _, _ = await self._gather_consistent(
            oid, sorted(minimum.keys()), acting, up_shards=up_shards
        )
        if len(chunks) < self.k:
            raise IOError(f"cannot read {oid}: only {len(chunks)} shards")
        if logical_size is None:
            raise IOError(f"no size metadata for {oid}")
        data = await self._decode_op(chunks)
        if tiered:
            # miss attribution: the full fan-out + decode the resident
            # block would have saved
            self._tier_hist("miss").inc(
                (time.monotonic() - t0) * 1e6, logical_size)
        self.perf.inc("read")
        return data[:logical_size]

    # -- partial I/O (ECTransaction write plan + sub-chunk range reads) ----

    async def read_range(self, oid: str, offset: int, length: int) -> bytes:
        """Read only the stripes covering [offset, offset+length)
        (reference: get_write_plan stripe algebra + sub-chunk reads,
        ECBackend.cc:1021-1037 fragmented shard reads)."""
        if self._hitset_record is not None:
            self._hitset_record(oid)
        t0 = time.monotonic()
        cached = self._tier_read(oid, offset, length)
        if cached is not None:
            # whole-object residency serves any extent without a stat
            # round-trip; the stripe/chunk column selection happened ON
            # DEVICE, so only the covering stripes' bytes crossed the bus
            self._tier_hist("hit").inc(
                (time.monotonic() - t0) * 1e6, len(cached))
            trace.event("tier_hit")
            self.perf.inc("read_range")
            return cached
        size, _ = await self._stat(oid)
        if offset >= size:
            return b""
        length = min(length, size - offset)
        cached = self.extent_cache.get(oid, offset, length)
        if cached is not None:
            self.perf.inc("read_cache_hit")
            return cached
        start, span = self.sinfo.offset_len_to_stripe_bounds(offset, length)
        chunk_off = self.sinfo.aligned_logical_offset_to_chunk_offset(start)
        chunk_len = (span // self.sinfo.stripe_width) * self.sinfo.chunk_size

        acting = self.acting_set(oid)
        up = [
            s
            for s in range(self.km)
            if self._shard_up(acting, s)
        ]
        want = ecutil.data_positions(self.ec)
        minimum = self.ec.minimum_to_decode(want, up)
        chunks, _, _, _ = await self._gather_consistent(
            oid, sorted(minimum.keys()), acting,
            extents=[(chunk_off, chunk_len)], up_shards=up,
        )
        if len(chunks) < self.k:
            raise IOError(f"cannot range-read {oid}")
        data = await self._decode_op(chunks)
        lo = offset - start
        self.perf.inc("read_range")
        return data[lo : lo + length]

    def _pin_bounds(self, offset: int, length: int):
        """Extent-cache pin span for an RMW: whole covering stripes."""
        lo_pin, _ = self.sinfo.offset_len_to_stripe_bounds(
            offset, max(1, length)
        )
        hi_pin = self.sinfo.logical_to_next_stripe_offset(offset + length)
        return lo_pin, hi_pin

    async def _write_range_pinned(
        self, oid: str, offset: int, data: bytes, pin, snapc=None
    ) -> None:
        from ceph_tpu_torch.osd.ectransaction import get_write_plan

        size, hinfo_d = await self._stat(oid)
        snapset, clone_id = self._snap_prepare(oid, snapc)
        # the version counter this RMW is computed on top of: shards not
        # on this base missed history and must skip the extent write
        base_version = self._versions.get(oid, 0)
        plan = get_write_plan(self.sinfo, size, offset, len(data))
        start, span = plan.will_write

        buf = np.zeros(span, dtype=np.uint8)
        if plan.to_read is not None:
            r_off, r_len = plan.to_read
            old = await self.read_range(oid, r_off, r_len)
            buf[r_off - start : r_off - start + len(old)] = np.frombuffer(
                old, dtype=np.uint8
            )
        buf[offset - start : offset - start + len(data)] = np.frombuffer(
            data, dtype=np.uint8
        )

        # an RMW's resident block is dropped below, so never keep one
        encoded, _dev = await self._encode_op(buf, oid=oid)
        chunk_off = self.sinfo.aligned_logical_offset_to_chunk_offset(start)

        if plan.is_append and hinfo_d is not None and chunk_off == (
            ecutil.HashInfo.from_dict(hinfo_d).get_total_chunk_size()
        ):
            hinfo = ecutil.HashInfo.from_dict(hinfo_d)
            hinfo.append(chunk_off, encoded)
        elif plan.is_append and hinfo_d is None and chunk_off == 0:
            hinfo = ecutil.HashInfo(self.km)
            hinfo.append(0, encoded)
        else:
            # overwrite: sizes only, hashes cleared (ec_overwrites semantics)
            hinfo = ecutil.HashInfo(0)
            hinfo.total_chunk_size = max(
                chunk_off + len(encoded[0]),
                ecutil.HashInfo.from_dict(hinfo_d).get_total_chunk_size()
                if hinfo_d
                else 0,
            )

        version = self._next_version(oid)
        # an RMW rewrites only the covered stripes: the resident block
        # cannot be refreshed in place, so drop it (reads fall back to
        # the shards; the agent re-promotes if the object stays hot)
        self._tier_invalidate(oid)
        acting = self.acting_set(oid)
        up = await self._up_for_write(oid, acting, self.min_size)
        tid = self._new_tid()
        entry = LogEntry(version=version[0], oid=oid, op="append",
                         prior_size=size)
        self.log.append(entry)
        subs = []
        for s in range(self.km):
            soid = shard_oid(oid, s)
            txn = Transaction()
            if clone_id is not None:
                txn.clone(soid, shard_oid(snap_oid(oid, clone_id), s))
            txn = (
                txn
                .write(soid, chunk_off, encoded[s].tobytes())
                .setattr(soid, ecutil.HINFO_KEY, hinfo.to_dict())
                .setattr(soid, SIZE_KEY, plan.new_size)
                .setattr(soid, VERSION_KEY, version)
                .setattr(soid, WHITEOUT_KEY, None)
            )
            self._pool_stamp(txn, soid)
            if snapset is not None:
                txn.setattr(soid, SNAPSET_KEY, snapset)
            subs.append((f"osd.{acting[s]}", ECSubWrite(
                from_shard=s, tid=tid, oid=oid, transaction=txn,
                at_version=version, log_entries=[entry],
                prev_version=base_version,
            )))
        self.perf.inc("write_range")
        await self._fanout_commit(
            oid, tid, subs, {f"osd.{acting[s]}" for s in up},
            min_acks=self.k,
        )
        self._snap_committed(oid, snapset, plan.new_size)
        # publish committed bytes for read-through (padding included: those
        # bytes are logically zero up to new_size and real data below it)
        pin.commit(start, buf.tobytes())

    # -- removal strategy --------------------------------------------------

    async def _destroy_object(self, oid: str, up, acting) -> None:
        """Plain (snap-less) removal: delete every shard object.

        Resurrection guard: a removal acked by fewer than m+1 shards
        could leave >= k same-version chunks on revived OSDs, making a
        "removed" object readable again.  m+1 deletions cap survivors
        at k-1 (the reference gets this from PG-log replay at peering)."""
        version = self._next_version(oid)
        tid = self._new_tid()
        subs = [
            (f"osd.{acting[s]}", ECSubWrite(
                from_shard=s, tid=tid, oid=oid,
                transaction=Transaction().remove(shard_oid(oid, s)),
                at_version=version,
            ))
            for s in up
        ]
        await self._fanout_commit(
            oid, tid, subs, {f"osd.{acting[s]}" for s in up},
            min_acks=self.m + 1,
        )

    # -- scrub / recovery strategy hooks -----------------------------------

    def _scrub_verify(self, chunks: Dict[int, np.ndarray],
                      report: dict) -> None:
        """Re-encode the data shards and compare the stored coding shards
        (the EC deep-scrub consistency check, reference ECBackend crc +
        parity verification).  Each object's bytes pass through once,
        so the re-encode uploads them unhashed (``uncached_uploads``)."""
        dpos = ecutil.data_positions(self.ec)
        if all(p in chunks for p in dpos):
            data = np.stack([chunks[p] for p in dpos])
            with uncached_uploads():
                fresh = self.ec.encode(set(range(self.km)),
                                       data.reshape(-1))
            for s in range(self.km):
                if s in dpos:
                    continue
                if s in chunks and not np.array_equal(fresh[s], chunks[s]):
                    report["parity_mismatch"].append(s)

    def _min_sources(self, want_shards, up_shards):
        """Cheapest source set able to rebuild ``want_shards``
        (ECBackend.cc:1569 get_min_avail_to_read_shards)."""
        minimum = self.ec.minimum_to_decode(list(want_shards), up_shards)
        return sorted(minimum.keys())

    def _rebuild_shard(self, chunks: Dict[int, np.ndarray],
                       shard: int) -> bytes:
        """Reconstruct one shard's bytes from k source chunks (the
        per-object recovery; its sources upload unhashed)."""
        with uncached_uploads():
            rec = ecutil.decode_shards(self.ec, chunks, [shard])
        return rec[shard].tobytes()

    def _shard_bytes_total(self, logical_size: int) -> int:
        """Stored bytes per shard object: the stripe-rounded chunk span."""
        return self.sinfo.aligned_logical_offset_to_chunk_offset(
            self.sinfo.logical_to_next_stripe_offset(logical_size)
        )
