"""Mesh-sliced OSD data plane: PG-sliced encode + in-collective delivery.

Port of ``ceph_tpu/parallel/mesh_plane.py``.  A process-wide
:class:`MeshDataPlane` over the device list (``parallel.local_devices``,
one stream per slot) that

* **slices PG ownership over the mesh's ``pg`` axis** -- each device slot
  hosts the PG-shard slice of one in-mesh OSD (``bind``/``owner_slot``)
  and the per-PG coalescer's fused encode batches are placed segment by
  segment (a cached :class:`Placement`), so every slot encodes the
  stripes of the PGs it owns, on its own device and stream;
* **scatters parity in-collective where the devices allow** -- with
  ``osd_mesh_scatter`` on (``auto``: on CUDA devices), the GF(2^8) product
  additionally splits the chunk axis over the mesh's ``shard`` axis and a
  reduce-scatter lands each parity slice on its owner slot
  (``parallel/distributed.py`` ``encode_scatter``);
* **delivers in-mesh chunk payloads off the wire** -- a sub-write whose
  destination OSD is mesh-bound carries a tiny board reference instead
  of the chunk bytes; the messenger still frames/orders/replays the
  sub-op, but the payload never crosses it.  Out-of-mesh peers keep the
  full wire path, chosen per chunk from CRUSH placement.

Every product runs ``gf2_matrix_w8`` (``ops/cuda_gf.py``; its plain twin
on a CPU slot).  Gated by ``osd_mesh_data_plane`` (default off -- the
single-device path is the A/B baseline).  Steady state builds no
placement object and no library: placements are cached content-keyed
(:meth:`MeshDataPlane.sharding`, counted in ``sharding_builds``), coding
tables ride the accounted matrix cache (``ops/pipeline.py``) once per
slot device, and batch/width shapes are bucketed (pow2 rows per slot x
the shared rung ladder).  Each dispatch ends with its slots' streams
synchronized, so a board deposit or a D2H never reads a buffer a slot's
stream is still writing.
"""

from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ceph_tpu_torch.native.gf_native import crc32c
from ceph_tpu_torch.parallel import (local_devices, new_stream, on_stream,
                                     synchronize, wait_current)

#: payloads below this stay inline on the wire: a board round-trip
#: (deposit + claim + crc) costs more than serializing a few bytes
MIN_DETACH_BYTES = 1024


def _pow2ceil(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class DeliveryBoard:
    """Process-wide in-collective chunk handoff between in-mesh OSDs.

    The primary deposits a chunk's bytes (conceptually: the slice the
    collective left on the owner's device) and the sub-write frame
    carries only ``(key, nbytes, crc32c)``; the receiving OSD claims the
    bytes at apply time.  Byte-bounded (``osd_mesh_board_bytes``):
    beyond the cap the oldest unclaimed deposits drop and the affected
    sub-write fails over to recovery -- the same lossy-bound stance the
    messenger takes on its lossless backlog."""

    def __init__(self, cap_bytes: Optional[int] = None):
        self._lock = threading.Lock()
        self._entries: "Dict[int, bytes]" = {}
        self._order: List[int] = []
        self._bytes = 0
        self._next_key = 0
        self._cap = cap_bytes
        self.deposits = 0
        self.claims = 0
        self.claimed_bytes = 0
        self.misses = 0
        self.evictions = 0

    def _cap_bytes(self) -> int:
        if self._cap is not None:
            return self._cap
        from ceph_tpu_torch.utils.config import get_config

        return int(get_config().get_val("osd_mesh_board_bytes"))

    def deposit(self, data) -> Tuple[int, int, int]:
        """Park one chunk payload; returns ``(key, nbytes, crc32c)`` --
        the reference the mesh-delivery frame carries instead of the
        bytes."""
        buf = bytes(data)
        crc = crc32c(buf)
        with self._lock:
            self._next_key += 1
            key = self._next_key
            self._entries[key] = buf
            self._order.append(key)
            self._bytes += len(buf)
            self.deposits += 1
            cap = self._cap_bytes()
            while self._bytes > cap and self._order:
                old = self._order.pop(0)
                dropped = self._entries.pop(old, None)
                if dropped is not None:
                    self._bytes -= len(dropped)
                    self.evictions += 1
        return key, len(buf), crc

    def claim(self, key: int) -> Optional[bytes]:
        """Pop a deposited payload (single-shot); None when evicted or
        never deposited in this process (an out-of-mesh replay)."""
        with self._lock:
            buf = self._entries.pop(key, None)
            if buf is None:
                self.misses += 1
                return None
            self._bytes -= len(buf)
            self.claims += 1
            self.claimed_bytes += len(buf)
        return buf

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "deposits": self.deposits,
                "claims": self.claims,
                "claimed_bytes": self.claimed_bytes,
                "misses": self.misses,
                "evictions": self.evictions,
                "pending_bytes": self._bytes,
            }


class Tables(NamedTuple):
    """A GF(2^8) matrix as ``gf2_matrix_w8`` reads it: the nibble tables
    of ``rows`` output rows over ``k`` inputs (the JAX package's
    [rows, k, 256] row tables, in the port's kernel form)."""
    host: np.ndarray
    k: int
    rows: int


def gf8_tables(matrix: np.ndarray) -> Tables:
    """[rows, k] GF(2^8) matrix -> its :class:`Tables`."""
    from ceph_tpu_torch.matrices.bitmatrix import matrix_to_bitmatrix
    from ceph_tpu_torch.ops import cuda_gf

    mat = np.asarray(matrix, dtype=np.uint32)
    rows, k = mat.shape
    return Tables(cuda_gf.prep_matrix_w8(matrix_to_bitmatrix(mat, 8), k),
                  k, rows)


class Placement(NamedTuple):
    """Where each segment of a placed batch lives: ``devices[i]`` and
    ``streams[i]`` hold segment i (the counterpart of a
    ``NamedSharding``; a replicated placement has one segment per
    distinct device)."""
    axes: tuple
    devices: tuple
    streams: tuple


def _apply(tab: Tables, tab_dev: torch.Tensor,
           words: torch.Tensor) -> torch.Tensor:
    """[b, k, n] u8 on a slot's device -> [b, rows, n] u8: the whole
    batch as one ``gf2_matrix_w8`` launch over chunk-major lanes."""
    from ceph_tpu_torch.ops import cuda_gf

    b, kk, n = words.shape
    flat = words.permute(1, 0, 2).reshape(kk, b * n).contiguous()
    out = cuda_gf.matrix_encode_w8(tab_dev, flat.view(torch.int32),
                                   kk, tab.rows)
    return out.view(torch.uint8).view(tab.rows, b, n).permute(1, 0, 2)


class _PoolCodec:
    """Per-(coding matrix) sliced programs on the plane's slots.

    Local mode (the default off CUDA): the batch axis is split over BOTH
    mesh axes (pure PG slicing) and each slot runs ``gf2_matrix_w8`` on
    its segment -- encode is entirely slot-local, no reduction.  Scatter
    mode (``osd_mesh_scatter``): the chunk axis splits over the ``shard``
    axis and parity is reduce-scattered to its owner slot
    (``DistributedCodec.encode_scatter``)."""

    def __init__(self, plane: "MeshDataPlane", matrix: np.ndarray,
                 k: int, m: int, w: int):
        self.plane = plane
        self.k, self.m, self.w = k, m, w
        self.matrix = np.asarray(matrix, dtype=np.uint32)
        #: the coding matrix's kernel tables, uploaded once per slot
        #: device through the accounted cache
        self._enc_tab = gf8_tables(self.matrix)
        self._scatter_codec = None

    def _tab_on(self, tab: Tables, device: torch.device) -> torch.Tensor:
        from ceph_tpu_torch.ops.pipeline import accounted_device_matrix

        return accounted_device_matrix(tab.host, device)

    def _tabs(self, tab: Tables) -> Dict[torch.device, torch.Tensor]:
        """``tab`` on every slot device (the replicated placement), then
        every slot stream waits for the uploads."""
        plane = self.plane
        out = {dev: self._tab_on(tab, dev)
               for dev in plane.sharding(None, None, None).devices}
        wait_current(plane.devices, plane.streams)
        return out

    def scatter_codec(self):
        """The reduce-scatter path (``parallel/distributed.py``) on the
        plane's collective mesh; None when k/m do not divide the shard
        axis (the local path covers those pools)."""
        if self._scatter_codec is None:
            mesh = self.plane.collective_mesh
            ns = mesh.shape["shard"]
            if self.k % ns or self.m % ns:
                return None
            from ceph_tpu_torch.parallel.distributed import DistributedCodec

            self._scatter_codec = DistributedCodec(
                self.matrix, self.w, mesh)
        return self._scatter_codec

    # -- dispatch ----------------------------------------------------------

    def apply_fused(self, tab: Tables, stacks: np.ndarray) -> np.ndarray:
        """Run ``tab`` over ``stacks`` ([B, k, n] u8, B pre-bucketed to
        the mesh batch granularity) -- one fused dispatch, PG-sliced over
        the slots: segment i on slot i, each on its own stream."""
        from ceph_tpu_torch.analysis import residency

        plane = self.plane
        place = plane.sharding(("pg", "shard"), None, None)
        tabs = self._tabs(tab)
        rows = stacks.shape[0] // len(place.devices)
        outs = []
        for i, (dev, st) in enumerate(zip(place.devices, place.streams)):
            with on_stream(st):
                d = residency.device_put(stacks[i * rows:(i + 1) * rows],
                                         dev)
                outs.append(_apply(tab, tabs[dev], d))
        synchronize(plane.devices)
        host = np.concatenate([residency.device_get(o) for o in outs])
        ctr = residency.counters()
        ctr.note_mesh("pg", stacks.nbytes)
        if plane.n_shard > 1:
            ctr.note_mesh("shard", stacks.nbytes // plane.n_shard)
        return host

    def run_tab(self, tab: Tables, blocks: Sequence[np.ndarray],
                pgids: Sequence[int], bs_pad: int,
                slot: Optional[int] = None) -> List[np.ndarray]:
        """Apply ``tab`` to every [k, bs] block, PG-sliced.

        ``slot`` set = the PRIMARY-slot lane: the whole batch is one
        dispatch on that slot's device (a coalescer batch belongs to
        one primary OSD, whose slot owns every PG it leads -- the per-PG
        mesh slicing emerges because DIFFERENT primaries' fused batches
        land on different slots and their streams overlap).
        ``slot=None`` spreads by per-stripe PG ownership: a batch
        covering every mesh slot rides the fused lane, a partial one
        dispatches per owner slot.  Returns one [rows_out, bs_pad] host
        array per block, input order."""
        from ceph_tpu_torch.analysis import residency

        plane = self.plane
        k = blocks[0].shape[0]
        per_slot: Dict[int, List[int]] = {}
        if slot is not None:
            per_slot[slot % plane.n_devices] = list(range(len(blocks)))
        else:
            for i, pg in enumerate(pgids):
                per_slot.setdefault(plane.owner_slot(pg), []).append(i)
        if len(per_slot) == plane.n_devices:
            stacks, where = plane._stack_pg_sliced(blocks, pgids, bs_pad)
            host = self.apply_fused(tab, stacks)
            plane.counters["mesh_fused_dispatches"] += 1
            return [host[row] for row, _bs in where]
        # partial batch: per-slot dispatch -- each slot's launch rides
        # its own stream, so distinct slots' kernels overlap
        ctr = residency.counters()
        tabs = self._tabs(tab)
        outs: Dict[int, torch.Tensor] = {}
        total = 0
        for s, idxs in per_slot.items():
            rows = plane._bucket_batch(len(idxs))
            arr = np.zeros((rows, k, bs_pad), dtype=np.uint8)
            for j, i in enumerate(idxs):
                b = blocks[i]
                arr[j, :, :b.shape[1]] = b
            dev = plane.devices[s]
            with on_stream(plane.streams[s]):
                d = residency.device_put(arr, dev)
                outs[s] = _apply(tab, tabs[dev], d)
            total += arr.nbytes
        synchronize(plane.devices)
        ctr.note_mesh("pg", total)
        plane.counters["mesh_local_dispatches"] += len(per_slot)
        results: List[Optional[np.ndarray]] = [None] * len(blocks)
        for s, idxs in per_slot.items():
            host = residency.device_get(outs[s])
            for j, i in enumerate(idxs):
                results[i] = host[j]
        return results  # type: ignore[return-value]

    def encode_scatter(self, stacks: np.ndarray) -> Optional[np.ndarray]:
        """In-collective parity scatter: [B, k, n] -> [B, m, n] with the
        parity computed by a shard-axis reduce-scatter (each owner slot
        receives exactly its slice).  None when the pool shape cannot
        ride the collective mesh."""
        codec = self.scatter_codec()
        if codec is None:
            return None
        from ceph_tpu_torch.analysis import residency

        parity = codec.encode_scatter(stacks)
        ctr = residency.counters()
        ctr.note_mesh("pg", stacks.nbytes)
        ctr.note_mesh("shard", stacks.nbytes)
        return parity


class MeshDataPlane:
    """Process-wide mesh over the local devices: PG-slice ownership,
    sliced codec dispatch, and the in-collective delivery board."""

    def __init__(self, n_devices: Optional[int] = None):
        devs = local_devices()
        if n_devices is None:
            from ceph_tpu_torch.utils.config import get_config

            n_devices = int(get_config().get_val("osd_mesh_devices"))
        n = len(devs) if not n_devices else min(int(n_devices), len(devs))
        self.devices = list(devs[:max(1, n)])
        self.n_devices = len(self.devices)
        #: one stream per slot: a device named twice gets two
        self.streams = [new_stream(d) for d in self.devices]
        # (pg, shard) factoring: the shard axis exists for the
        # in-collective parity scatter; pools whose k/m do not divide
        # it ride the pg axis alone (the batch splits over BOTH axes)
        n_shard = 1
        for cand in (4, 2):
            if self.n_devices % cand == 0:
                n_shard = cand
                break
        self.n_shard = n_shard
        self.n_pg = self.n_devices // n_shard
        mesh = np.empty(self.n_devices, dtype=object)
        mesh[:] = self.devices
        self.mesh = mesh.reshape(self.n_pg, self.n_shard)
        self._collective_mesh = None
        #: content-keyed placement cache: steady-state dispatch builds
        #: ZERO placement objects per op
        self._shardings: Dict[tuple, Placement] = {}
        self.sharding_builds = 0
        #: in-mesh OSD membership: name -> device slot (one OSD per
        #: slot; late binders past the slot count stay out-of-mesh and
        #: keep the wire path)
        self._members: Dict[str, int] = {}
        self._codecs: Dict[tuple, _PoolCodec] = {}
        self._lock = threading.Lock()
        self.board = DeliveryBoard()
        self.counters: Dict[str, int] = {
            "mesh_encode_stripes": 0,
            "mesh_encode_dispatches": 0,
            "mesh_fused_dispatches": 0,
            "mesh_local_dispatches": 0,
            "mesh_decode_stripes": 0,
            "mesh_deliver_chunks": 0,
            "mesh_wire_bytes_avoided": 0,
            "mesh_claim_miss": 0,
        }

    # -- placement cache (content-keyed, built once) -----------------------

    def sharding(self, *axes) -> Placement:
        """The cached placement of a batch whose axis 0 is split over
        ``axes[0]``: ``("pg", "shard")`` puts segment i on slot i; None
        replicates (one segment per distinct device)."""
        place = self._shardings.get(axes)
        if place is None:
            if axes[0] is None:
                devs = tuple(dict.fromkeys(self.devices))
                streams = (None,) * len(devs)
            elif axes[0] == ("pg", "shard"):
                devs, streams = tuple(self.devices), tuple(self.streams)
            else:
                raise ValueError(f"no placement for axes {axes}")
            place = self._shardings[axes] = Placement(axes, devs, streams)
            self.sharding_builds += 1
        return place

    @property
    def collective_mesh(self):
        """(data, shard, sub) view of the same slots and streams for the
        ``DistributedCodec`` scatter path."""
        if self._collective_mesh is None:
            from ceph_tpu_torch.parallel.distributed import make_mesh

            self._collective_mesh = make_mesh(
                n_data=self.n_pg, n_shard=self.n_shard, n_sub=1,
                devices=self.devices, streams=self.streams,
            )
        return self._collective_mesh

    # -- membership / PG-slice ownership -----------------------------------

    def bind(self, name: str) -> Optional[int]:
        """Attach an OSD to the mesh; returns its slot, or None once
        every slot hosts an OSD (the overflow stays out-of-mesh).
        Idempotent per name."""
        with self._lock:
            slot = self._members.get(name)
            if slot is not None:
                return slot
            if len(self._members) >= self.n_devices:
                return None
            slot = len(self._members)
            self._members[name] = slot
            return slot

    def covers(self, name: str) -> bool:
        return name in self._members

    def slot_of(self, name: str) -> Optional[int]:
        return self._members.get(name)

    def owner_slot(self, pgid: int) -> int:
        """The mesh slot owning a PG's shard slice."""
        return int(pgid) % self.n_devices

    # -- codec plumbing ----------------------------------------------------

    def can_encode(self, ec) -> bool:
        return bool(getattr(ec, "mesh_plane_capable", False))

    def _codec(self, ec) -> _PoolCodec:
        matrix = np.asarray(ec.matrix, dtype=np.uint32)
        key = (matrix.shape, matrix.tobytes(), int(ec.w))
        with self._lock:
            codec = self._codecs.get(key)
            if codec is None:
                codec = self._codecs[key] = _PoolCodec(
                    self, matrix, ec.get_data_chunk_count(),
                    ec.get_chunk_count() - ec.get_data_chunk_count(),
                    int(ec.w),
                )
            return codec

    def _scatter_on(self) -> bool:
        from ceph_tpu_torch.utils.config import get_config

        mode = str(get_config().get_val("osd_mesh_scatter"))
        if mode == "on":
            return True
        if mode == "off":
            return False
        # auto: where the reduction rides device-to-device copies
        return self.devices[0].type == "cuda"

    def _bucket_batch(self, count_per_slot: int) -> int:
        """Rows-per-slot bucket (pow2) so the shape set stays bounded no
        matter how the coalescer's batch sizes wander."""
        return _pow2ceil(max(1, count_per_slot))

    @staticmethod
    def _bucket_bs(bs: int) -> int:
        """Stripe-width bucket: the shared rung ladder
        (``ops/bucketing.py``) extended downward with pow2 sub-rungs --
        the plane's unit is one stripe's chunk (KiBs), not the
        pipeline's fused granule (the ladder starts at 16 KiB), and
        padding a 4 KiB chunk 4x would waste sliced compute."""
        from ceph_tpu_torch.ops import bucketing

        floor = bucketing.ladder()[0]
        if bs >= floor:
            return bucketing.bucket_bytes(bs)
        return min(floor, max(1024, _pow2ceil(bs)))

    def _stack_pg_sliced(
        self, blocks: Sequence[np.ndarray], pgids: Sequence[int],
        bs_pad: int,
    ) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
        """Arrange ``blocks`` ([k, bs] u8) into the PG-sliced batch
        array [n_devices * rows, k, bs_pad]: stripe i lands in its
        owning slot's row segment, so the placement puts each stripe on
        the slot that owns its PG.  Returns the array and each stripe's
        (global row, true width)."""
        k = blocks[0].shape[0]
        per_slot: Dict[int, List[int]] = {}
        for i, pg in enumerate(pgids):
            per_slot.setdefault(self.owner_slot(pg), []).append(i)
        rows = self._bucket_batch(
            max(len(v) for v in per_slot.values()))
        arr = np.zeros((self.n_devices * rows, k, bs_pad), dtype=np.uint8)
        where: List[Tuple[int, int]] = [(0, 0)] * len(blocks)
        for slot, idxs in per_slot.items():
            for j, i in enumerate(idxs):
                b = blocks[i]
                arr[slot * rows + j, :, :b.shape[1]] = b
                where[i] = (slot * rows + j, b.shape[1])
        return arr, where

    # -- encode (the coalescer's fused dispatch target) --------------------

    def encode_shard_major_many(
        self, ec, blocks: Sequence[np.ndarray],
        pgids: Optional[Sequence[int]] = None,
        slot: Optional[int] = None,
    ) -> List[Dict[int, np.ndarray]]:
        """ONE PG-sliced dispatch per (bucketed width) group over the
        whole coalesced batch: [k, bs] shard-major blocks in, full chunk
        maps out -- bit-exact with the single-device path and the
        jerasure oracle."""
        codec = self._codec(ec)
        k, m = codec.k, codec.m
        # trace attribution: the coalescer's fan-in span is task-current
        # during dispatch -- mark which lane the shared stage took
        from ceph_tpu_torch.utils import trace as _trace

        _trace.tag("lane", "mesh_spmd" if slot is None
                   else f"mesh_primary_slot_{slot}")
        _trace.tag("mesh_devices", self.n_devices)
        if pgids is None:
            pgids = list(range(len(blocks)))
        out: List[Optional[Dict[int, np.ndarray]]] = [None] * len(blocks)
        groups: Dict[int, List[int]] = {}
        for i, b in enumerate(blocks):
            if b.shape[1] == 0:
                out[i] = {ec.chunk_index(j): np.zeros(0, np.uint8)
                          for j in range(k + m)}
                continue
            groups.setdefault(self._bucket_bs(b.shape[1]), []).append(i)
        scatter = self._scatter_on()
        for bs_pad, idxs in groups.items():
            blocks_l = [np.asarray(blocks[i], dtype=np.uint8)
                        for i in idxs]
            pgids_l = [pgids[i] for i in idxs]
            rows_l = None
            if scatter:
                stacks, where = self._stack_pg_sliced(
                    blocks_l, pgids_l, bs_pad)
                parity = codec.encode_scatter(stacks)
                if parity is not None:
                    rows_l = [parity[row] for row, _bs in where]
            if rows_l is None:
                rows_l = codec.run_tab(
                    codec._enc_tab, blocks_l, pgids_l, bs_pad,
                    slot=slot)
            for i, pr in zip(idxs, rows_l):
                b = blocks[i]
                bs = b.shape[1]
                enc = {ec.chunk_index(j): b[j] for j in range(k)}
                for j in range(m):
                    enc[ec.chunk_index(k + j)] = np.ascontiguousarray(
                        pr[j, :bs])
                out[i] = enc
            self.counters["mesh_encode_dispatches"] += 1
            self.counters["mesh_encode_stripes"] += len(idxs)
        return out  # type: ignore[return-value]

    # -- decode (degraded reads through the same sliced plane) -------------

    def decode_maps(
        self, ec, maps: Sequence[Dict[int, np.ndarray]],
        slot: Optional[int] = None,
    ) -> List[Dict[int, np.ndarray]]:
        """Reconstruct every missing chunk of every map; signature
        groups share one composed row matrix and one sliced dispatch
        per width group (the decode twin of the encode path)."""
        from ceph_tpu_torch.ops.pipeline import matrix_reconstruct_rows

        codec = self._codec(ec)
        k, m = codec.k, codec.m
        km = k + m
        results: List[Optional[Dict[int, np.ndarray]]] = [None] * len(maps)
        groups: Dict[tuple, List[int]] = {}
        for i, cm in enumerate(maps):
            groups.setdefault(tuple(sorted(cm.keys())), []).append(i)
        for sig, idxs in groups.items():
            erased = [c for c in range(km) if c not in sig]
            if not erased:
                for i in idxs:
                    results[i] = {c: np.asarray(a, dtype=np.uint8)
                                  for c, a in maps[i].items()}
                continue
            if len(sig) < k:
                raise ValueError("not enough chunks to decode")
            sel, rows = matrix_reconstruct_rows(
                codec.matrix, k, m, codec.w, list(sig), erased)
            tab = gf8_tables(rows)
            by_size: Dict[int, List[int]] = {}
            for i in idxs:
                bs = len(next(iter(maps[i].values())))
                by_size.setdefault(bs, []).append(i)
            for bs, sized in by_size.items():
                bs_pad = self._bucket_bs(bs)
                rec_l = codec.run_tab(
                    tab,
                    [np.stack([np.asarray(maps[i][c], dtype=np.uint8)
                               for c in sel]) for i in sized],
                    list(range(len(sized))), bs_pad, slot=slot)
                for i, rec in zip(sized, rec_l):
                    full = {c: np.asarray(a, dtype=np.uint8)
                            for c, a in maps[i].items()}
                    for j, e in enumerate(erased):
                        full[e] = np.ascontiguousarray(rec[j, :bs])
                    results[i] = full
                self.counters["mesh_decode_stripes"] += len(sized)
        return results  # type: ignore[return-value]

    def decode_concat_many(self, sinfo, ec, maps,
                           slot: Optional[int] = None) -> List[bytes]:
        """``ecutil.decode_concat_many`` with the reconstruction routed
        through the sliced plane (the read-path coalescer's dispatch)."""
        from ceph_tpu_torch.osd import ecutil
        from ceph_tpu_torch.utils import trace as _trace

        _trace.tag("lane", "mesh_spmd" if slot is None
                   else f"mesh_primary_slot_{slot}")
        results: List[bytes] = [b""] * len(maps)
        need = [i for i, cm in enumerate(maps)
                if cm and len(next(iter(cm.values()))) > 0]
        if not need:
            return results
        full = self.decode_maps(ec, [maps[i] for i in need], slot=slot)
        for i, out in zip(need, full):
            results[i] = ecutil._reassemble(sinfo, ec, out)
        return results

    # -- in-collective delivery (the wire split's board half) --------------

    def detach_sub_write(self, sub) -> int:
        """Replace a sub-write transaction's chunk payloads with board
        references (the mesh-delivery frame: the bytes ride the device
        plane, the messenger frames only the envelope).  Returns the
        payload bytes taken off the wire."""
        txn = getattr(sub, "transaction", None)
        if txn is None:
            return 0
        moved = 0
        for op in txn.ops:
            if op.op == "write" and len(op.data) >= MIN_DETACH_BYTES:
                key, nbytes, crc = self.board.deposit(op.data)
                op.op = "write_ref"
                op.data = b""
                op.attr_value = (key, nbytes, crc)
                moved += nbytes
        if moved:
            self.counters["mesh_deliver_chunks"] += 1
            self.counters["mesh_wire_bytes_avoided"] += moved
        return moved

    def resolve_transaction(self, txn) -> bool:
        """Claim every board reference back into payload bytes before
        the transaction applies (crc-checked, like the wire frame the
        bytes skipped).  False = a reference was evicted/foreign; the
        caller refuses the sub-write and recovery repairs the shard."""
        for op in txn.ops:
            if op.op != "write_ref":
                continue
            key, nbytes, crc = op.attr_value
            data = self.board.claim(key)
            if data is None or len(data) != nbytes or crc32c(data) != crc:
                self.counters["mesh_claim_miss"] += 1
                return False
            op.op = "write"
            op.data = data
            op.attr_value = None
        return True

    def status(self) -> dict:
        return {
            "n_devices": self.n_devices,
            "n_pg": self.n_pg,
            "n_shard": self.n_shard,
            "members": dict(self._members),
            "sharding_builds": self.sharding_builds,
            "board": self.board.stats(),
            "counters": dict(self.counters),
        }


_plane: Optional[MeshDataPlane] = None
_plane_lock = threading.Lock()


def configure(n_devices: Optional[int] = None) -> MeshDataPlane:
    """(Re)build the process plane over ``n_devices`` (None/0 = every
    local device) -- the bench sweep's knob.  Drops prior membership
    and board state (a mesh reshape is a process event, like an osdmap
    epoch)."""
    global _plane
    with _plane_lock:
        _plane = MeshDataPlane(n_devices)
        return _plane


def reset() -> None:
    global _plane
    with _plane_lock:
        _plane = None


def current_plane() -> Optional[MeshDataPlane]:
    """The process plane iff ``osd_mesh_data_plane`` is on; None
    otherwise (callers take the single-device / full-wire path).  With
    the gate on, a plane that cannot be built (no CUDA and no device
    list, ``parallel.configure_devices``) raises: the port does not
    quietly fall back."""
    from ceph_tpu_torch.utils.config import get_config

    if not bool(get_config().get_val("osd_mesh_data_plane")):
        return None
    global _plane
    plane = _plane
    if plane is not None:
        return plane
    with _plane_lock:
        if _plane is None:
            _plane = MeshDataPlane()
        return _plane
