"""Multi-device erasure coding over a (data, shard, sub) grid of devices.

Port of ``ceph_tpu/parallel/distributed.py``.  The reference distributes EC
over OSD processes with hand-built fan-out / gather on its messenger
(reference: src/osd/ECBackend.cc:1976-2030 write fan-out, :1142-1313 read
gather).  Here the same roles map onto the axes of a device grid:

    data  axis -- stripe batches (the PG/data-parallel analogue)
    shard axis -- the k chunk dimension (the acting-set/OSD analogue):
                  each cell multiplies its k/s input chunks by its block
                  of k/s matrix columns, and the partial parities are
                  XOR-reduced over the shard axis
    sub   axis -- positions *within* a chunk (the sub-chunk / sequence-
                  parallel analogue, ErasureCodeInterface.h:251-300)

The JAX package runs this as one SPMD program whose GF(2) partial sums
ride a ``psum`` (or ``psum_scatter``) and are taken mod 2 afterwards.
The port gets the same bits with GF(2^8) arithmetic throughout: every
cell runs ``gf2_matrix_w8`` (``ops/cuda_gf.py``; its plain twin on a CPU
device) on its slice, and the partial parities -- sums in GF(2^8), i.e.
XORs -- are copied device to device and XORed.  Each cell launches on its
own stream, and a reduction waits on the events of the cells it reads.
A call returns host arrays once every stream it used has finished, so no
tensor of the call is freed while a stream still reads it.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ceph_tpu_torch.analysis import residency
from ceph_tpu_torch.matrices.bitmatrix import matrix_to_bitmatrix
from ceph_tpu_torch.ops import cuda_gf
from ceph_tpu_torch.parallel import (local_devices, new_stream, on_stream,
                                     record, synchronize, wait_current)

AXES = ("data", "shard", "sub")


class Mesh:
    """A grid of devices with named axes and one stream per cell (the
    counterpart of ``jax.sharding.Mesh``; a device may fill several
    cells)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 streams: Optional[np.ndarray] = None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        if streams is None:
            streams = np.empty(devices.shape, dtype=object)
            for cell in np.ndindex(*devices.shape):
                streams[cell] = new_stream(devices[cell])
        self.streams = streams

    def cells(self):
        return np.ndindex(*self.devices.shape)


def make_mesh(n_data: int = 1, n_shard: int = 1, n_sub: int = 1,
              devices=None, streams: Optional[Sequence] = None) -> Mesh:
    """Build a (data, shard, sub) mesh from the first devices of
    ``devices`` (default :func:`parallel.local_devices`)."""
    if devices is None:
        devices = local_devices()
    need = n_data * n_shard * n_sub
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    dev = np.empty(need, dtype=object)
    dev[:] = list(devices[:need])
    st = None
    if streams is not None:
        st = np.empty(need, dtype=object)
        st[:] = list(streams[:need])
        st = st.reshape(n_data, n_shard, n_sub)
    return Mesh(dev.reshape(n_data, n_shard, n_sub), AXES, st)


def to_lanes(x, device: torch.device, width: int) -> torch.Tensor:
    """[b, c, n] bytes (numpy or a tensor) -> [c, b * width / 4] int32
    lanes on ``device`` (chunk-major, each stripe's n bytes zero-padded to
    ``width``, a multiple of 4): the layout ``gf2_matrix_w8`` takes for
    the whole batch at once."""
    b, c, n = x.shape
    if isinstance(x, np.ndarray):
        host = np.zeros((c, b, width), dtype=np.uint8)
        host[:, :, :n] = x.transpose(1, 0, 2)
        dev = residency.device_put(host, device)
    else:
        t = x.to(device, non_blocking=True)
        dev = torch.zeros((c, b, width), dtype=torch.uint8, device=device)
        dev[:, :, :n] = t.permute(1, 0, 2)
    return dev.view(torch.int32).view(c, b * width // 4)


def from_lanes(out: torch.Tensor, b: int, width: int) -> torch.Tensor:
    """[r, b * width / 4] int32 -> [b, r, width] uint8 (a view)."""
    return out.view(torch.uint8).view(out.shape[0], b, width).permute(1, 0, 2)


class DistributedCodec:
    """A w=8 matrix code over a (data, shard, sub) mesh.

    Data layout: words [batch, k, n] with batch split over 'data', k over
    'shard', n over 'sub'.  Parity and reconstruction are GF(2^8) products
    over the split k axis, XOR-reduced over the shard axis."""

    def __init__(self, matrix: np.ndarray, w: int, mesh: Mesh):
        self.m, self.k = np.asarray(matrix).shape
        self.w = w
        self.mesh = mesh
        if w != 8:
            raise ValueError(f"DistributedCodec supports w=8, not w={w}")
        self.matrix = np.asarray(matrix, dtype=np.uint32)
        self.B = matrix_to_bitmatrix(self.matrix, w)
        n_shard = mesh.shape["shard"]
        if self.k % n_shard:
            raise ValueError(
                f"k={self.k} must divide over shard axis {n_shard}"
            )
        self._tables = self._block_tables(self.B)
        #: decode-row signature -> its block tables
        self._rows_tables: Dict[bytes, List[np.ndarray]] = {}

    # -- the sliced product ----------------------------------------------

    def _block_tables(self, bits: np.ndarray) -> List[np.ndarray]:
        """``gf2_matrix_w8`` tables of each shard cell's block of k/s
        matrix columns (the bitmatrix columns ``P(None, "shard")`` gives
        a device in the JAX package)."""
        ns = self.mesh.shape["shard"]
        ks = self.k // ns
        cols = ks * self.w
        return [cuda_gf.prep_matrix_w8(bits[:, s * cols:(s + 1) * cols], ks)
                for s in range(ns)]

    def _partials(self, tables: List[np.ndarray], rows: int, words):
        """Every cell's partial product: {cell: [b/d, rows, width]} on the
        cell's device, with the event that marks it done.  ``width`` is
        the cell's n/u bytes rounded up to whole lanes."""
        from ceph_tpu_torch.ops.pipeline import accounted_device_matrix

        mesh = self.mesh
        nd, ns, nb = (mesh.shape[a] for a in AXES)
        b, k, n = words.shape
        if k != self.k:
            raise ValueError(f"words have {k} chunks, the code {self.k}")
        if b % nd or n % nb:
            raise ValueError(f"[{b}, {k}, {n}] does not split over the "
                             f"(data={nd}, sub={nb}) axes")
        bl, ks, nl = b // nd, k // ns, n // nb
        width = -(-nl // 4) * 4
        tabs = {(s, mesh.devices[d, s, u]): None
                for d, s, u in mesh.cells()}
        for s, dev in tabs:
            tabs[s, dev] = accounted_device_matrix(tables[s], dev)
        wait_current(mesh.devices.flat, mesh.streams.flat)
        parts, events = {}, {}
        for cell in mesh.cells():
            d, s, u = cell
            st = mesh.streams[cell]
            with on_stream(st):
                dev = mesh.devices[cell]
                lanes = to_lanes(words[d * bl:(d + 1) * bl,
                                       s * ks:(s + 1) * ks,
                                       u * nl:(u + 1) * nl], dev, width)
                out = cuda_gf.matrix_encode_w8(tabs[s, dev], lanes, ks, rows)
                parts[cell] = from_lanes(out, bl, width)
                events[cell] = record(st)
        return parts, events, (bl, nl)

    def _reduce(self, parts, events, target, rows: slice) -> torch.Tensor:
        """XOR of every shard cell's partial (rows ``rows``) of the
        target's (data, sub) position, on the target cell's device and
        stream: device-to-device copies plus an XOR."""
        mesh = self.mesh
        d, _s, u = target
        dev = mesh.devices[target]
        st = mesh.streams[target]
        acc = None
        with on_stream(st):
            for s in range(mesh.shape["shard"]):
                src = (d, s, u)
                part = parts[src][:, rows]
                if part.device == dev:
                    if st is not None:
                        st.wait_event(events[src])
                    x = part
                else:
                    # a peer copy runs on the source device's current
                    # stream and fences it against the target's both
                    # ways: make the source cell's stream current there
                    with on_stream(mesh.streams[src]):
                        x = part.to(dev, non_blocking=True)
                acc = x.clone() if acc is None else acc.bitwise_xor_(x)
        return acc

    def _all_reduce(self, tables, rows: int, words):
        """The partial products reduced onto every shard device: {cell:
        [b/d, rows, n/u]} (the JAX package's ``psum`` over 'shard')."""
        parts, events, (bl, nl) = self._partials(tables, rows, words)
        totals = {cell: self._reduce(parts, events, cell, slice(None))
                  for cell in self.mesh.cells()}
        return parts, {cell: t[:, :, :nl] for cell, t in totals.items()}

    def _gather(self, totals, b: int, rows: int, n: int) -> np.ndarray:
        """[b, rows, n] on the host from the first shard cell of each
        (data, sub) position, once every stream has finished."""
        mesh = self.mesh
        nd, nb = mesh.shape["data"], mesh.shape["sub"]
        synchronize(mesh.devices.flat)
        out = np.empty((b, rows, n), dtype=np.uint8)
        bl, nl = b // nd, n // nb
        for d, u in itertools.product(range(nd), range(nb)):
            out[d * bl:(d + 1) * bl, :, u * nl:(u + 1) * nl] = \
                residency.device_get(totals[d, 0, u])
        return out

    # -- encode: parity = M . data, XOR-reduced over 'shard' ---------------

    def encode(self, words) -> np.ndarray:
        """words [batch, k, n] (a host array or a tensor) -> parity
        [batch, m, n] (reduced onto every shard device; gathered from
        the first)."""
        b, _k, n = words.shape
        _parts, totals = self._all_reduce(self._tables, self.m, words)
        return self._gather(totals, b, self.m, n)

    # -- scatter variant: each device ends up owning its parity slice ------

    def _scatter_rows(self) -> Optional[int]:
        n_shard = self.mesh.shape["shard"]
        if self.m % n_shard:
            return None
        return self.m // n_shard

    def encode_scatter_shards(self, words) -> List[Tuple[tuple, tuple,
                                                         torch.Tensor]]:
        """The reduce-scatter: each shard cell receives only its parity
        slice, rows ``s*m/ns .. (s+1)*m/ns`` (the byte rows the JAX
        package's ``psum_scatter`` over the m*w bit-rows leaves it).
        Returns ``(cell, (batch, rows, n) slices, tensor)`` per cell, the
        tensor on the cell's device."""
        per = self._scatter_rows()
        if per is None:
            raise ValueError("m must divide the shard axis size")
        parts, events, (bl, nl) = self._partials(self._tables, self.m, words)
        out = []
        for cell in self.mesh.cells():
            d, s, u = cell
            t = self._reduce(parts, events, cell,
                             slice(s * per, (s + 1) * per))[:, :, :nl]
            out.append((cell, (slice(d * bl, (d + 1) * bl),
                               slice(s * per, (s + 1) * per),
                               slice(u * nl, (u + 1) * nl)), t))
        synchronize(self.mesh.devices.flat)
        return out

    def encode_scatter(self, words) -> np.ndarray:
        """words [batch, k, n] -> parity [batch, m, n], computed with the
        m axis split over 'shard' (each device owns its parity rows)
        and gathered from the owners: a reduce-scatter instead of an
        all-reduce, each owner receiving only its slice."""
        b, _k, n = words.shape
        out = np.empty((b, self.m, n), dtype=np.uint8)
        for _cell, index, t in self.encode_scatter_shards(words):
            out[index] = residency.device_get(t)
        return out

    def parity_owner_slots(self) -> Sequence[int]:
        """Shard-axis device index each parity row is BORN on under the
        :meth:`encode_scatter` layout (parity row j lands on device
        ``j // (m / n_shard)``).  The mesh data plane's delivery split
        uses this to decide which chunks are already resident on their
        owner and can skip the wire."""
        per = self._scatter_rows()
        if per is None:
            raise ValueError("m must divide the shard axis size")
        return [j // per for j in range(self.m)]

    # -- scrub: recompute parity, compare against stored (deep-scrub role) --

    def verify(self, words, parity) -> np.ndarray:
        """Per-stripe bool [batch]: the stored parity equals a fresh
        encode (compared on every cell's device)."""
        mesh = self.mesh
        nd, ns, nb = (mesh.shape[a] for a in AXES)
        b, _k, n = words.shape
        _parts, totals = self._all_reduce(self._tables, self.m, words)
        bl, nl = b // nd, n // nb
        ok = np.ones(b, dtype=bool)
        same = {}
        for cell, t in totals.items():
            d, _s, u = cell
            with on_stream(mesh.streams[cell]):
                ref = parity[d * bl:(d + 1) * bl, :, u * nl:(u + 1) * nl]
                ref = residency.device_put(ref, t.device) \
                    if isinstance(ref, np.ndarray) \
                    else ref.to(t.device, non_blocking=True)
                same[cell] = (t == ref).flatten(1).all(1)
        synchronize(mesh.devices.flat)
        for (d, _s, _u), eq in same.items():
            ok[d * bl:(d + 1) * bl] &= residency.device_get(eq)
        return ok

    # -- reconstruct: decode rows are another GF(2^8) product ----------------

    def reconstruct(self, rows: np.ndarray, survivors) -> np.ndarray:
        """Apply host-computed decode rows [e, k] to survivor words
        [batch, k, n] (the degraded-read / recovery path,
        reference ECBackend.cc:2284 objects_read_and_reconstruct)."""
        rows = np.asarray(rows, dtype=np.uint32)
        key = rows.tobytes() + bytes(rows.shape)
        tables = self._rows_tables.get(key)
        if tables is None:
            if len(self._rows_tables) >= 128:
                self._rows_tables.pop(next(iter(self._rows_tables)))
            tables = self._rows_tables[key] = self._block_tables(
                matrix_to_bitmatrix(rows, self.w))
        b, _k, n = survivors.shape
        e = rows.shape[0]
        _parts, totals = self._all_reduce(tables, e, survivors)
        return self._gather(totals, b, e, n)
