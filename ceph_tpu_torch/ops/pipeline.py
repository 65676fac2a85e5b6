"""Stripe-batching device pipeline for the CUDA codec plugin.

Port of ``ceph_tpu/ops/pipeline.py``: the seam between the reference's
synchronous per-call codec contract (ErasureCodeInterface encode/decode
return completed buffers) and a device that wants large, overlapped,
asynchronously-completed transfers.

* **Persistent device state**: the coding matrix is prepared and uploaded
  once per codec instance and reused by every call.
* **Granule fusing**: stripes are accumulated and fused along the lane axis
  into granules of up to the top rung of the ladder (``ops/bucketing.py``).
  Stripes wider than the top rung are split into column segments (parity
  is columnwise, so the split is exact).  A granule is as wide as the
  columns its stripes fill: the reference pads it up to a rung to bound
  the number of XLA compilations, but a CUDA launch compiles nothing per
  shape, and PyTorch's caching allocators already round the staging and
  output buffers to reusable sizes, so padding would only add copy bytes
  and kernel work.
* **Bounded in-flight depth**: a granule's upload is issued on a side copy
  stream from pinned host staging, its kernel on the current stream after
  the upload's event, and its result copied back into pinned host memory
  with an event to wait on.  Up to ``depth`` granules are in flight, and
  the kernel of granule N is issued once the upload of granule N+1 is
  queued, so copies ride under compute.

On the CPU (``device="cpu"``) the same code runs synchronously, with each
kernel's plain PyTorch version.

Decode reconstruction is fused to ONE device product per erasure
signature: every erased chunk (data or parity) is expressed as a GF-linear
combination of the k selected survivors, composed on host, and the rows are
cached per signature like the reference ISA plugin's decode-table LRU
(ErasureCodeIsaTableCache.h:48).

The reference's content-addressed H2D cache and its HBM ledger are not part
of this port yet; every granule is uploaded.
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ceph_tpu_torch.analysis import residency
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.matrices.bitmatrix import (
    invert_bitmatrix,
    matrix_to_bitmatrix,
)
from ceph_tpu_torch.ops import bucketing, cuda_gf, torch_gf
from ceph_tpu_torch.ops.gf import gf

_DEFAULT_DEPTH = 3
#: staged uploads before the oldest one's kernel is issued (two slots:
#: upload N+1 is queued before compute N)
_OVERLAP = 2

_stats_lock = threading.Lock()
_granules_dispatched = 0


def granules_dispatched() -> int:
    """Process-wide count of fused granule dispatches -- the residency
    ledger's denominator: h2d_ops_delta / granules_delta is the
    "<= 1 H2D per granule" number the storage-path benchmark reports."""
    with _stats_lock:
        return _granules_dispatched


def _note_granule() -> None:
    global _granules_dispatched
    with _stats_lock:
        _granules_dispatched += 1


class DeviceStream:
    """One uploaded GF(2) matrix + the kernel that applies it.

    kind="matrix": B is a jerasure-layout bitmatrix [R*w, k*w] applied to
    w-bit words riding byte lanes (R output chunks from k input chunks).
    kind="packet": B is a packetized bitmatrix [R, C] applied to packet rows
    (cauchy/liberation family).

    Modes: ``w8``/``w16`` (the matrix kernels), ``packet`` (the packet
    kernel), all on int32 lanes; ``words`` (w=32 matrix codes, the plain
    words program, on bytes -- the reference has no TPU kernel for w=32
    either).  The resident operand ``_B`` is the kernel's prepared form of
    B: nibble tables (w8 and w16), per-row lists of ones
    (packet), or B itself (words).
    """

    def __init__(self, kind: str, B: np.ndarray, k: int, rows_out: int,
                 w: int, packetsize: int = 0, device="cuda"):
        self.kind = kind
        self.k = k
        self.rows_out = rows_out
        self.w = w
        self.packetsize = packetsize
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        if kind == "matrix" and w == 8:
            self._mode, arr = "w8", cuda_gf.prep_matrix_w8(B, k)
        elif kind == "matrix" and w == 16:
            self._mode, arr = "w16", cuda_gf.prep_matrix_w16(B, k)
        elif kind == "matrix":
            self._mode, arr = "words", np.asarray(B, np.uint8)
        else:
            self._mode, arr = "packet", cuda_gf.prep_packet(B)
        self._B = residency.device_put(arr, self.device)
        self._copy_stream = torch.cuda.Stream(self.device) \
            if self._cuda else None

    # -- host-side layout ---------------------------------------------------

    def cols_of(self, bs: int) -> int:
        """Device columns contributed by one stripe of chunk size bs."""
        if self._mode == "words":
            return bs
        if self.kind == "matrix":
            return bs // cuda_gf.LANE_BYTES
        # packet rows: [k*w, bs/w] bytes -> int32 lanes
        return bs // (self.w * cuda_gf.LANE_BYTES)

    def _row_dtype(self):
        return np.uint8 if self._mode == "words" else np.int32

    def rows_in(self) -> int:
        return self.k if self.kind == "matrix" else self.k * self.w

    def pack_into(self, out: np.ndarray, col0: int, data: np.ndarray) -> None:
        """Place one stripe's [k, bs] u8 chunk block at column offset col0
        of the granule staging buffer (device columns)."""
        ncols = self.cols_of(data.shape[1])
        if self.kind == "matrix":
            rows = np.ascontiguousarray(data)
        else:
            rows = np.ascontiguousarray(torch_gf._to_packet_rows(
                np.ascontiguousarray(data), self.w, self.packetsize))
        out[:, col0:col0 + ncols] = rows.view(self._row_dtype())

    def unpack(self, out_host: np.ndarray, col0: int, bs: int) -> np.ndarray:
        """Extract one stripe's [rows_out, bs] u8 result block."""
        ncols = self.cols_of(bs)
        block = np.ascontiguousarray(out_host[:, col0:col0 + ncols])
        if self.kind == "matrix":
            return block.view(np.uint8).reshape(self.rows_out, bs)
        rows = block.view(np.uint8).reshape(self.rows_out * self.w,
                                            bs // self.w)
        return torch_gf._from_packet_rows(rows, self.w, self.packetsize)

    def seg_align_bytes(self) -> int:
        """Stripe column-segment boundaries must fall on whole lanes
        (matrix codes) or on whole packet groups whose packet rows are
        whole lanes (packet codes)."""
        if self.kind == "matrix":
            return cuda_gf.LANE_BYTES
        return math.lcm(self.w * self.packetsize,
                        self.w * cuda_gf.LANE_BYTES)

    # -- device dispatch ----------------------------------------------------

    def staging(self, cols: int) -> torch.Tensor:
        """Host buffer for one granule's packed input; pinned when the
        stream feeds the card, so its upload can be asynchronous."""
        dtype = torch.uint8 if self._mode == "words" else torch.int32
        return torch.empty((self.rows_in(), cols), dtype=dtype,
                           pin_memory=self._cuda)

    def upload(self, buf: torch.Tensor):
        """H2D slot: queue the granule's upload on the copy stream.
        Returns ``(device tensor, ready event or None)``."""
        residency.note_h2d(buf.nbytes)
        if not self._cuda:
            return buf, None
        with torch.cuda.stream(self._copy_stream):
            d = buf.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return d, ready

    def compute(self, d: torch.Tensor, ready=None) -> torch.Tensor:
        """Kernel slot: apply the resident matrix to the uploaded granule
        on the current stream, after the upload's event."""
        if ready is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ready)
            d.record_stream(cur)
        if self._mode == "w8":
            return cuda_gf.matrix_encode_w8(self._B, d, self.k, self.rows_out)
        if self._mode == "w16":
            return cuda_gf.matrix_encode_w16(self._B, d, self.k,
                                             self.rows_out)
        if self._mode == "packet":
            return cuda_gf.packet_encode(self._B, d, self.rows_out * self.w)
        return torch_gf._encode_words(self._B, d, self.w)

    def start_d2h(self, out: torch.Tensor):
        """Queue the result's copy into pinned host memory.  Returns
        ``(host tensor, done event or None)``."""
        residency.note_d2h(out.nbytes)
        if not self._cuda:
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def device_block(self, d_in, out, col0: int, blen: int):
        """The ``[k+m, blen]`` uint8 device block of the stripe at granule
        column ``col0``: data rows sliced from the uploaded input, parity
        rows from the kernel output, concatenated on the device.  None when
        the layout's device bytes are not plain shard bytes (packet codes
        scramble bytes into packet rows)."""
        if self.kind != "matrix" or d_in is None:
            return None
        ncols = self.cols_of(blen)
        block = torch.cat(
            [d_in[:, col0:col0 + ncols], out[:, col0:col0 + ncols]])
        return block.view(torch.uint8)


class _Granule:
    __slots__ = ("host", "done", "out", "entries", "d_in")

    def __init__(self, host, done, out, entries, d_in=None):
        self.host = host  # pinned host tensor, filled when `done` fires
        self.done = done
        self.out = out  # device result, retained only for keep_device
        self.entries = entries  # [(ticket, granule_col0, stripe_b0, seg_bytes)]
        self.d_in = d_in  # uploaded input, retained only for keep_device


class EncodePipeline:
    """Accumulation queue -> fused granule dispatch -> async completion.

    submit() buffers a stripe; granules dispatch when full (or on flush).
    Stripes larger than the top granule rung are split into column segments
    and re-assembled on completion.  result(ticket) blocks only until that
    stripe's last granule lands; up to `depth` granules are in flight at
    once.  Thread-safe; unclaimed results are held until result() or
    discard() -- callers that abandon a ticket must discard it.

    The dispatch is a two-slot pipeline: a granule's upload is queued at
    dispatch time but its kernel is issued only when the NEXT granule's
    upload is queued (or at flush/claim).
    """

    def __init__(self, stream: DeviceStream, depth: int = _DEFAULT_DEPTH,
                 max_granule: Optional[int] = None):
        self.stream = stream
        self.depth = depth
        if max_granule is None:
            max_granule = bucketing.DEFAULT_RUNGS[-1]
        align = stream.seg_align_bytes()
        self._max_seg_bytes = max(align, max_granule - max_granule % align)
        self._max_cols = stream.cols_of(self._max_seg_bytes)
        self._lock = threading.RLock()
        self._pending: List[Tuple[int, np.ndarray, int, int]] = []
        self._pending_cols = 0
        #: uploaded granules whose kernel has not been issued yet
        self._staged: deque = deque()
        self._inflight: deque[_Granule] = deque()
        self._parts: Dict[int, Dict[int, np.ndarray]] = {}
        self._need: Dict[int, Tuple[int, int]] = {}  # ticket -> (bs, nsegs)
        self._done: Dict[int, np.ndarray] = {}
        self._keep: set = set()  # tickets wanting a resident device block
        self._dev_parts: Dict[int, Dict[int, object]] = {}
        self._dev_done: Dict[int, object] = {}
        self._next_ticket = 0

    def submit(self, data: np.ndarray, keep_device: bool = False) -> int:
        """data: [k, bs] uint8 (the k prepared data chunks of one stripe).

        ``keep_device=True`` additionally composes the stripe's
        [k+m, bs] block on the device at landing time (claim with
        :meth:`device_result` after :meth:`result`)."""
        with self._lock:
            t = self._next_ticket
            self._next_ticket += 1
            bs = data.shape[1]
            segs = []
            b0 = 0
            while b0 < bs:
                take = min(self._max_seg_bytes, bs - b0)
                segs.append((b0, take))
                b0 += take
            self._need[t] = (bs, len(segs))
            self._parts[t] = {}
            if keep_device:
                self._keep.add(t)
                self._dev_parts[t] = {}
            for b0, blen in segs:
                seg_cols = self.stream.cols_of(blen)
                if self._pending and \
                        self._pending_cols + seg_cols > self._max_cols:
                    self._dispatch_pending()
                self._pending.append((t, data, b0, blen))
                self._pending_cols += seg_cols
                if self._pending_cols >= self._max_cols:
                    self._dispatch_pending()
            return t

    def flush(self) -> None:
        with self._lock:
            if self._pending:
                self._dispatch_pending()
            while self._staged:
                self._issue_compute()

    def _dispatch_pending(self) -> None:
        # caller holds self._lock
        stream = self.stream
        entries = []
        col0 = 0
        for t, data, b0, blen in self._pending:
            entries.append((t, col0, b0, blen))
            col0 += stream.cols_of(blen)
        # whole 4-lane (16-byte) vectors, the kernels' fast instantiation
        buf = stream.staging(col0 + (-col0) % 4)
        host = buf.numpy()
        host[:, col0:] = 0
        for (t, c0, b0, blen), (_t, data, _b0, _bl) in zip(
                entries, self._pending):
            stream.pack_into(host, c0, data[:, b0:b0 + blen])
        keep = any(t in self._keep for t, _c0, _b0, _bl in entries)
        d, ready = stream.upload(buf)
        self._staged.append((d, ready, keep, entries))
        self._pending.clear()
        self._pending_cols = 0
        while len(self._staged) >= _OVERLAP:
            self._issue_compute()
        while len(self._inflight) > self.depth:
            self._land(self._inflight.popleft())

    def _issue_compute(self) -> None:
        # caller holds self._lock: kernel slot of the two-slot pipeline
        d, ready, keep, entries = self._staged.popleft()
        out = self.stream.compute(d, ready)
        host, done = self.stream.start_d2h(out)
        _note_granule()
        self._inflight.append(_Granule(host, done, out if keep else None,
                                       entries, d if keep else None))

    def _land(self, g: _Granule) -> None:
        # caller holds self._lock
        if g.done is not None:
            g.done.synchronize()
        host = g.host.numpy()
        for t, c0, b0, blen in g.entries:
            if t not in self._need:
                continue  # discarded
            parts = self._parts[t]
            parts[b0] = self.stream.unpack(host, c0, blen)
            if t in self._keep:
                self._dev_parts[t][b0] = self.stream.device_block(
                    g.d_in, g.out, c0, blen)
            bs, nsegs = self._need[t]
            if len(parts) == nsegs:
                if nsegs == 1:
                    self._done[t] = parts[0]
                else:
                    whole = np.empty((self.stream.rows_out, bs), np.uint8)
                    for pb0, block in parts.items():
                        whole[:, pb0:pb0 + block.shape[1]] = block
                    self._done[t] = whole
                if t in self._keep:
                    self._dev_done[t] = self._compose_device(t, nsegs)
                del self._parts[t]
                del self._need[t]

    def _compose_device(self, ticket: int, nsegs: int):
        """Join a keep_device ticket's per-segment device blocks along the
        byte axis (still on the device); None when any segment's layout
        could not be composed."""
        dsegs = self._dev_parts.pop(ticket, {})
        if len(dsegs) != nsegs or any(b is None for b in dsegs.values()):
            return None
        return torch.cat([dsegs[b0] for b0 in sorted(dsegs)], dim=1)

    def result(self, ticket: int) -> np.ndarray:
        """Parity/reconstruction rows for the given stripe: [rows_out, bs]."""
        with self._lock:
            if ticket not in self._done:
                self.flush()
            while ticket not in self._done and self._inflight:
                self._land(self._inflight.popleft())
            return self._done.pop(ticket)

    def device_result(self, ticket: int):
        """Still-resident [k+m, bs] uint8 device block for a
        ``keep_device`` ticket, or None when the stream's layout could not
        compose one.  Claim after :meth:`result`; single-shot."""
        with self._lock:
            self._keep.discard(ticket)
            return self._dev_done.pop(ticket, None)

    def discard(self, ticket: int) -> None:
        """Abandon a ticket: its result will not be retained."""
        with self._lock:
            self._done.pop(ticket, None)
            self._parts.pop(ticket, None)
            self._need.pop(ticket, None)
            self._keep.discard(ticket)
            self._dev_parts.pop(ticket, None)
            self._dev_done.pop(ticket, None)

    def drain(self) -> None:
        with self._lock:
            self.flush()
            while self._inflight:
                self._land(self._inflight.popleft())

    def encode_many(self, stripes: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Pipelined convenience: [k,bs] blocks in -> [rows_out,bs] out."""
        tickets = [self.submit(s) for s in stripes]
        self.flush()
        return [self.result(t) for t in tickets]


# ---------------------------------------------------------------------------
# reconstruction-row composition (host, tiny): every erasure from k survivors
# ---------------------------------------------------------------------------


def matrix_reconstruct_rows(
    matrix: np.ndarray, k: int, m: int, w: int,
    available: Sequence[int], erased: Sequence[int],
) -> Tuple[List[int], np.ndarray]:
    """GF(2^w) rows expressing every erased chunk (data AND parity) as a
    combination of the k selected survivors, composed into one product."""
    F = gf(w)
    sel = sorted(available)[:k]
    A = np.zeros((k, k), dtype=np.uint32)
    for r, cid in enumerate(sel):
        if cid < k:
            A[r, cid] = 1
        else:
            A[r, :] = matrix[cid - k, :]
    inv = F.mat_invert(A)  # data_chunks = inv @ survivors
    rows = np.zeros((len(erased), k), dtype=np.uint32)
    for i, e in enumerate(erased):
        if e < k:
            rows[i, :] = inv[e, :]
        else:
            rows[i, :] = F.mat_mul(matrix[e - k: e - k + 1, :], inv)[0]
    return sel, rows


def bitmatrix_reconstruct_rows(
    bitmatrix: np.ndarray, k: int, m: int, w: int,
    available: Sequence[int], erased: Sequence[int],
) -> Tuple[List[int], np.ndarray]:
    """GF(2) analogue of matrix_reconstruct_rows for packetized codes."""
    sel = sorted(available)[:k]
    A = np.zeros((k * w, k * w), dtype=np.uint8)
    for r, cid in enumerate(sel):
        if cid < k:
            A[r * w:(r + 1) * w, cid * w:(cid + 1) * w] = np.eye(
                w, dtype=np.uint8)
        else:
            A[r * w:(r + 1) * w, :] = bitmatrix[
                (cid - k) * w:(cid - k + 1) * w, :]
    inv = invert_bitmatrix(A)
    rows = np.zeros((len(erased) * w, k * w), dtype=np.uint8)
    for i, e in enumerate(erased):
        if e < k:
            rows[i * w:(i + 1) * w, :] = inv[e * w:(e + 1) * w, :]
        else:
            rows[i * w:(i + 1) * w, :] = (
                bitmatrix[(e - k) * w:(e - k + 1) * w, :].astype(np.uint32)
                @ inv.astype(np.uint32)
            ) % 2
    return sel, rows.astype(np.uint8)


# ---------------------------------------------------------------------------
# per-codec device state: encode stream + signature-keyed decode stream LRU
# ---------------------------------------------------------------------------


class DeviceCodec:
    """Persistent device pipelines for one codec instance.

    Built from the technique's GF(2^w) ``matrix`` or packetized
    ``bitmatrix`` -- the numpy arrays a codec of either package holds, so
    a test can hand the JAX codec's arrays to the port.  Holds the encode
    stream and an LRU of reconstruction streams keyed by (available,
    erased) signature.
    """

    DECODE_LRU = 64

    def __init__(self, *, matrix: Optional[np.ndarray] = None,
                 bitmatrix: Optional[np.ndarray] = None,
                 k: int, m: int, w: int, packetsize: int = 0,
                 device="cuda"):
        self.k, self.m, self.w = k, m, w
        self.packetsize = packetsize
        self.device = resolve_device(device)
        self.matrix = matrix
        if matrix is not None:
            self._enc_B = matrix_to_bitmatrix(np.asarray(matrix, np.uint32), w)
            self.kind = "matrix"
        else:
            self._enc_B = np.asarray(bitmatrix, np.uint8)
            self.kind = "packet"
        self._encode_stream: Optional[DeviceStream] = None
        self._decode_streams: OrderedDict[
            Tuple, Tuple[List[int], DeviceStream]] = OrderedDict()
        self._lock = threading.Lock()

    def encode_stream(self) -> DeviceStream:
        with self._lock:
            if self._encode_stream is None:
                self._encode_stream = DeviceStream(
                    self.kind, self._enc_B, self.k, self.m, self.w,
                    self.packetsize, self.device)
            return self._encode_stream

    def decode_stream(
        self, available: Sequence[int], erased: Sequence[int]
    ) -> Tuple[List[int], DeviceStream]:
        sig = (tuple(sorted(available)), tuple(sorted(erased)))
        with self._lock:
            hit = self._decode_streams.get(sig)
            if hit is not None:
                self._decode_streams.move_to_end(sig)
                return hit
        if self.kind == "matrix":
            sel, rows = matrix_reconstruct_rows(
                self.matrix, self.k, self.m, self.w, available, erased)
            stream = DeviceStream("matrix", matrix_to_bitmatrix(rows, self.w),
                                  self.k, len(erased), self.w,
                                  device=self.device)
        else:
            sel, rows = bitmatrix_reconstruct_rows(
                self._enc_B, self.k, self.m, self.w, available, erased)
            stream = DeviceStream("packet", rows, self.k, len(erased),
                                  self.w, self.packetsize, self.device)
        with self._lock:
            self._decode_streams[sig] = (sel, stream)
            while len(self._decode_streams) > self.DECODE_LRU:
                self._decode_streams.popitem(last=False)
        return sel, stream

    # -- one-shot conveniences (the sync plugin contract) -------------------

    def encode(self, data: np.ndarray) -> np.ndarray:
        """[k, bs] u8 -> [m, bs] u8, single fused dispatch."""
        pipe = EncodePipeline(self.encode_stream(), depth=0)
        return pipe.result(pipe.submit(data))

    def decode(self, have: Dict[int, np.ndarray],
               blocksize: int) -> Dict[int, np.ndarray]:
        """Reconstruct every missing chunk in one fused dispatch."""
        available = sorted(have.keys())
        erased = [i for i in range(self.k + self.m) if i not in have]
        out = {i: np.asarray(have[i], dtype=np.uint8) for i in available}
        if not erased:
            return out
        if len(available) < self.k:
            raise ValueError("not enough chunks to decode")
        sel, stream = self.decode_stream(available, erased)
        survivors = np.stack([out[c] for c in sel])
        pipe = EncodePipeline(stream, depth=0)
        rec = pipe.result(pipe.submit(survivors))
        for i, e in enumerate(erased):
            out[e] = rec[i]
        return out
