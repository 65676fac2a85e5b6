"""Binary encode/decode framework (denc-lite).

Port of ``ceph_tpu/utils/encoding.py``: the same wire and on-disk format,
byte for byte, over the port's crc32c (``native/gf_native.py``, built
from ``native/crc32c.c`` at first use, no fallback).

Reference: src/include/encoding.h (1364 LoC) / src/include/denc.h -- every
persistent or wire struct in the reference serializes through one small
framework with explicit little-endian integer widths, length-prefixed
blobs, and crc-guarded envelopes.  This is the same idea reduced to what
the framework persists: journal records, KV log records and object
metadata.

Value model (self-describing, tagged):
  None, bool, int (u64/zigzag-s64), bytes, str, list, tuple,
  dict[str, value].  Lists and tuples round-trip as distinct types.

Framed records (``frame``/``unframe``) carry ``MAGIC | len | crc32c |
payload`` so torn tail writes after a crash are detected and discarded --
the role of the reference's per-entry crcs in the FileStore journal
(src/os/filestore/FileJournal.cc) and the message envelope crcs
(src/msg/Message.cc).

Zero-copy output mode: an ``Encoder`` holds a PART LIST, not a
growing buffer.  ``bytes`` objects handed to :meth:`Encoder.blob` are
referenced (immutable -- no copy is ever needed); mutable buffers are
defensively copied unless the caller uses :meth:`Encoder.blob_ref`,
which references a ``memoryview`` under the contract that the caller
MUST NOT mutate the buffer until the encoded record has been fully
written out (the bufferlist discipline of src/include/buffer.h -- the
reference also shares raw pointers along the write path and relies on
the same contract).  ``parts()``/``frame_parts()`` emit a header + part
list suitable for ``writer.writelines`` scatter-gather sends, and
``crc32c_parts`` folds the frame crc over the parts incrementally
(crc32c chains: ``crc(a||b) == crc(b, crc(a))``), so a large payload
crosses the messenger with zero intermediate concatenations.
"""

from __future__ import annotations

import os
import struct
from typing import Any, List, Optional, Tuple

import numpy as np

from ceph_tpu_torch.native.gf_native import crc32c
from ceph_tpu_torch.profiling import ledger as _profiler

#: wire-tax cost center for the incremental frame digest (one marker,
#: fetched once; a global-bool branch when profiling is off)
_PS_CRC = _profiler.stage("wire.crc32c")

_MAGIC = 0xCE9B10C5

# value tags
_T_NONE, _T_FALSE, _T_TRUE, _T_INT, _T_NEGINT, _T_BYTES, _T_STR, _T_LIST, \
    _T_DICT, _T_TUPLE, _T_FLOAT = range(11)


#: single-byte cache: u8 and small-varint emission without a
#: struct.pack call each (the wire codec runs per message on the hot
#: path; these micro-ops showed up as whole percents of the cluster
#: bench wall)
_B1 = [bytes([i]) for i in range(256)]


class Encoder:
    def __init__(self) -> None:
        self._parts: List[bytes] = []

    def u8(self, v: int) -> "Encoder":
        self._parts.append(_B1[v])
        return self

    def u32(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<I", v))
        return self

    def u64(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<Q", v))
        return self

    def varint(self, v: int) -> "Encoder":
        """LEB128 unsigned varint (denc.h uses the same shape)."""
        assert v >= 0
        if v < 0x80:  # the overwhelmingly common case on this wire
            self._parts.append(_B1[v])
            return self
        out = bytearray()
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                out.append(b | 0x80)
            else:
                out.append(b)
                break
        self._parts.append(bytes(out))
        return self

    def blob(self, data: bytes) -> "Encoder":
        self.varint(len(data))
        # immutable bytes are referenced as-is (zero-copy); mutable
        # buffers (bytearray/memoryview) are defensively copied -- use
        # blob_ref to opt out of the copy under the no-mutation contract
        self._parts.append(data if type(data) is bytes else bytes(data))
        return self

    def blob_parts(self, parts) -> "Encoder":
        """Length-prefixed blob whose CONTENT is an already-encoded part
        list (e.g. another Encoder's :meth:`parts`): the parts are
        referenced, not joined -- how the messenger nests a wire message
        body into a transport frame with zero copies."""
        self.varint(sum(len(p) for p in parts))
        self._parts.extend(parts)
        return self

    def blob_ref(self, data) -> "Encoder":
        """Length-prefixed blob that REFERENCES the caller's buffer
        (no copy, even for mutable bytearray/memoryview/ndarray views).
        Contract: the caller must not mutate the buffer until the
        encoded record has been written out."""
        view = data if isinstance(data, memoryview) else memoryview(data)
        view = view.cast("B") if view.format != "B" else view
        self.varint(view.nbytes)
        self._parts.append(view)
        return self

    def string(self, s: str) -> "Encoder":
        return self.blob(s.encode("utf-8"))

    def value(self, v: Any) -> "Encoder":
        """Tagged self-describing value
        (None/bool/int/bytes/str/list/tuple/dict)."""
        if v is None:
            self.u8(_T_NONE)
        elif v is True:
            self.u8(_T_TRUE)
        elif v is False:
            self.u8(_T_FALSE)
        elif type(v) is int:  # before the np.integer ABC walk: plain
            # ints are the hot case (versions, seqs, crc lists)
            if v >= 0:
                self.u8(_T_INT).varint(v)
            else:
                self.u8(_T_NEGINT).varint(-v)
        elif type(v) is bytes:
            self.u8(_T_BYTES).blob(v)
        elif type(v) is str:
            self.u8(_T_STR).string(v)
        elif isinstance(v, np.integer):
            self.value(int(v))
        elif isinstance(v, int):
            if v >= 0:
                self.u8(_T_INT).varint(v)
            else:
                self.u8(_T_NEGINT).varint(-v)
        elif isinstance(v, float):
            self.u8(_T_FLOAT)
            self._parts.append(struct.pack("<d", v))
        elif isinstance(v, (bytes, bytearray, memoryview)):
            self.u8(_T_BYTES).blob(bytes(v))
        elif isinstance(v, str):
            self.u8(_T_STR).string(v)
        elif isinstance(v, tuple):
            self.u8(_T_TUPLE).varint(len(v))
            for item in v:
                self.value(item)
        elif isinstance(v, list):
            self.u8(_T_LIST).varint(len(v))
            for item in v:
                self.value(item)
        elif isinstance(v, dict):
            self.u8(_T_DICT).varint(len(v))
            for k in v:
                if not isinstance(k, str):
                    raise TypeError(f"dict keys must be str, got {type(k)}")
                self.string(k)
                self.value(v[k])
        else:
            raise TypeError(f"unencodable type {type(v)}")
        return self

    def bytes(self) -> bytes:
        return b"".join(self._parts)

    def nbytes(self) -> int:
        """Total encoded length without joining."""
        return sum(len(p) for p in self._parts)

    def parts(self, small: int = 2048) -> List:
        """The encoded record as a buffer list for scatter-gather output
        (``writer.writelines`` / ``os.writev``).  Runs of parts smaller
        than ``small`` are joined so the vector stays short (tag bytes
        and varints collapse into one buffer between large blobs); large
        blobs are REFERENCED, never copied."""
        ps = self._parts
        if sum(map(len, ps)) <= small:
            # whole record below the scatter threshold: one join beats
            # any per-part bookkeeping (the hot shape -- sub-op frames)
            return [b"".join(ps)] if len(ps) > 1 else list(ps)
        out: List = []
        run: List[bytes] = []
        for p in ps:
            if len(p) < small:
                run.append(p if type(p) is bytes else bytes(p))
            else:
                if run:
                    out.append(run[0] if len(run) == 1 else b"".join(run))
                    run = []
                out.append(p)
        if run:
            out.append(run[0] if len(run) == 1 else b"".join(run))
        return out


class Decoder:
    def __init__(self, data: bytes, pos: int = 0) -> None:
        self._data = data
        self._pos = pos

    def remaining(self) -> int:
        return len(self._data) - self._pos

    def _take(self, n: int) -> bytes:
        if self._pos + n > len(self._data):
            raise ValueError("decode past end of buffer")
        out = self._data[self._pos : self._pos + n]
        self._pos += n
        return out

    def u8(self) -> int:
        pos = self._pos
        if pos >= len(self._data):
            raise ValueError("decode past end of buffer")
        self._pos = pos + 1
        return self._data[pos]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def varint(self) -> int:
        data, pos = self._data, self._pos
        if pos < len(data) and not data[pos] & 0x80:  # 1-byte fast path
            self._pos = pos + 1
            return data[pos]
        v = 0
        shift = 0
        while True:
            b = self.u8()
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
            if shift > 63:
                raise ValueError("varint too long")

    def blob(self) -> bytes:
        return self._take(self.varint())

    def string(self) -> str:
        return self.blob().decode("utf-8")

    def value(self) -> Any:
        tag = self.u8()
        # ordered by wire frequency: ints, blobs and strings dominate
        if tag == _T_INT:
            return self.varint()
        if tag == _T_BYTES:
            return self.blob()
        if tag == _T_STR:
            return self.string()
        if tag == _T_NONE:
            return None
        if tag == _T_TRUE:
            return True
        if tag == _T_FALSE:
            return False
        if tag == _T_NEGINT:
            return -self.varint()
        if tag == _T_LIST:
            return [self.value() for _ in range(self.varint())]
        if tag == _T_TUPLE:
            return tuple(self.value() for _ in range(self.varint()))
        if tag == _T_DICT:
            return {self.string(): self.value() for _ in range(self.varint())}
        if tag == _T_FLOAT:
            return struct.unpack("<d", self._take(8))[0]
        raise ValueError(f"bad value tag {tag}")


def crc32c_parts(parts, crc: Optional[int] = None) -> int:
    """crc32c of the concatenation of ``parts`` WITHOUT concatenating:
    castagnoli chains, so ``crc(a||b) == crc32c(b, crc32c(a))``.  Pass
    ``crc`` to continue a digest already folded over earlier parts (the
    messenger caches each queued message's payload crc once and only
    folds the per-transmission tail on retransmit).

    A wire-tax cost center (``wire.crc32c``): runs once per burst
    element, nested inside the messenger's ``wire.crc_seal`` stage --
    exclusive accounting splits the digest from the seal bookkeeping."""
    with _PS_CRC:
        for p in parts:
            crc = crc32c(p) if crc is None else crc32c(p, crc)
        return crc32c(b"") if crc is None else crc


def frame(payload: bytes) -> bytes:
    """MAGIC | u32 len | u32 crc32c(payload) | payload."""
    return struct.pack("<III", _MAGIC, len(payload), crc32c(payload)) + payload


def frame_parts(parts, crc: Optional[int] = None) -> List:
    """Scatter-gather :func:`frame`: header + payload part list, no
    concatenation.  ``crc`` short-circuits the digest when the caller
    already holds crc32c over exactly these parts (cached per burst
    element -- the double-crc audit); when absent it is folded
    incrementally via :func:`crc32c_parts`."""
    length = sum(len(p) for p in parts)
    if crc is None:
        crc = crc32c_parts(parts)
    return [struct.pack("<III", _MAGIC, length, crc)] + list(parts)


def unframe(data: bytes, pos: int) -> Tuple[Optional[bytes], int]:
    """Decode one framed record at ``pos``.

    Returns (payload, next_pos); (None, pos) on a torn/corrupt/short record
    -- the caller treats that as end-of-log (crash-recovery semantics).
    """
    if pos + 12 > len(data):
        return None, pos
    magic, length, crc = struct.unpack_from("<III", data, pos)
    if magic != _MAGIC or pos + 12 + length > len(data):
        return None, pos
    payload = data[pos + 12 : pos + 12 + length]
    if crc32c(payload) != crc:
        return None, pos
    return payload, pos + 12 + length


def cut_torn_tail(path: str, pos: int, size: int) -> None:
    """Cut a log's torn tail off at ``pos`` before it is appended to.

    Replay stops at the first torn record; a record appended after the
    garbage would never replay, so an acknowledged (synced) write made
    after one crash would be lost at the next.  The JAX package appends
    after the garbage; the port truncates (and fsyncs) first, which
    changes the file only where a torn tail was found."""
    if pos < size:
        with open(path, "r+b") as f:
            f.truncate(pos)
            f.flush()
            os.fsync(f.fileno())
