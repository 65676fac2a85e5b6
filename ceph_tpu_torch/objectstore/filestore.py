"""File-backed ObjectStore with a write-ahead journal (FileStore-lite).

Port of ``ceph_tpu/objectstore/filestore.py``.

Reference: src/os/filestore/FileStore.cc (6050 LoC) + FileJournal -- object
data lives in ordinary files, every transaction is journaled first
(write-ahead), then applied to the filesystem; on mount the journal is
replayed past the last committed sequence.  Same contract here:

* ``queue_transaction``: encode the transaction, append one crc-framed
  record ``(seq, txn)`` to ``journal``, fsync, then apply to files;
* a ``COMMITTED`` marker file records the last applied seq (written
  atomically via rename after each apply -- the reference's
  ``commit_op_seq``); on mount, journal records with seq > committed are
  re-applied (apply is idempotent), torn tails are discarded;
* the journal is truncated once it exceeds ``journal_trim_bytes``
  (sync + trim, reference FileStore::sync_entry).

Objects are files named by an escaped oid under ``path/objects/``; xattrs
live in one sidecar KV file per object dir chunk -- kept simple: a single
``attrs`` LSM-free framed dict per object alongside the data file.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from ceph_tpu_torch.objectstore.statfs import ScanStatsMixin
from ceph_tpu_torch.osd.types import Transaction, TxnOp
from ceph_tpu_torch.utils.encoding import (Decoder, Encoder, cut_torn_tail,
                                          frame, unframe)


def _escape(oid: str) -> str:
    """Filesystem-safe object name (reference LFNIndex escaping role)."""
    out = []
    for ch in oid:
        if ch.isalnum() or ch in "._-":
            out.append(ch)
        else:
            out.append(f"%{ord(ch):02x}")
    return "".join(out)


def _unescape(name: str) -> str:
    out = []
    i = 0
    while i < len(name):
        if name[i] == "%":
            out.append(chr(int(name[i + 1 : i + 3], 16)))
            i += 3
        else:
            out.append(name[i])
            i += 1
    return "".join(out)


def _encode_txn(seq: int, txn: Transaction) -> bytes:
    enc = Encoder()
    enc.u64(seq)
    enc.varint(len(txn.ops))
    for op in txn.ops:
        enc.string(op.op).string(op.oid).varint(op.offset)
        enc.blob(op.data)
        enc.string(op.attr_name)
        enc.value(op.attr_value)
    return enc.bytes()


def _decode_txn(payload: bytes):
    dec = Decoder(payload)
    seq = dec.u64()
    txn = Transaction()
    for _ in range(dec.varint()):
        op = dec.string()
        oid = dec.string()
        offset = dec.varint()
        data = dec.blob()
        attr_name = dec.string()
        attr_value = dec.value()
        txn.ops.append(
            TxnOp(op, oid=oid, offset=offset, data=data,
                  attr_name=attr_name, attr_value=attr_value)
        )
    return seq, txn


class FileStore(ScanStatsMixin):
    def __init__(self, path: str, journal_trim_bytes: int = 8 << 20):
        self.path = path
        self.journal_trim_bytes = journal_trim_bytes
        self._objdir = os.path.join(path, "objects")
        self._journal_path = os.path.join(path, "journal")
        self._committed_path = os.path.join(path, "COMMITTED")
        self._journal = None
        self._seq = 0
        self.mount()

    # -- lifecycle ---------------------------------------------------------

    def mount(self) -> None:
        os.makedirs(self._objdir, exist_ok=True)
        committed = 0
        if os.path.exists(self._committed_path):
            with open(self._committed_path, "rb") as f:
                payload, _ = unframe(f.read(), 0)
            if payload is not None:
                committed = Decoder(payload).u64()
        self._seq = committed
        # replay journal records past the committed seq
        if os.path.exists(self._journal_path):
            with open(self._journal_path, "rb") as f:
                data = f.read()
            pos = 0
            while True:
                payload, pos = unframe(data, pos)
                if payload is None:
                    break
                seq, txn = _decode_txn(payload)
                if seq > committed:
                    self._apply(txn)
                    self._seq = seq
            cut_torn_tail(self._journal_path, pos, len(data))
            self._write_committed()
        self._journal = open(self._journal_path, "ab")

    def umount(self) -> None:
        if self._journal is not None:
            self._journal.flush()
            os.fsync(self._journal.fileno())
            self._journal.close()
            self._journal = None

    # -- transaction path --------------------------------------------------

    def queue_transaction(self, txn: Transaction) -> None:
        self._seq += 1
        record = frame(_encode_txn(self._seq, txn))
        self._journal.write(record)
        self._journal.flush()
        os.fsync(self._journal.fileno())
        self._apply(txn)
        self._write_committed()
        if self._journal.tell() > self.journal_trim_bytes:
            self._trim_journal()
        self._stats_invalidate()

    def _write_committed(self) -> None:
        tmp = self._committed_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(frame(Encoder().u64(self._seq).bytes()))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._committed_path)

    def _trim_journal(self) -> None:
        self._journal.close()
        self._journal = open(self._journal_path, "wb")

    # -- apply (idempotent: safe to replay) --------------------------------

    def _data_path(self, oid: str) -> str:
        return os.path.join(self._objdir, _escape(oid) + ".data")

    def _attr_path(self, oid: str) -> str:
        return os.path.join(self._objdir, _escape(oid) + ".attr")

    def _omap_path(self, oid: str) -> str:
        return os.path.join(self._objdir, _escape(oid) + ".omap")

    def _read_omap(self, oid: str) -> Dict[str, bytes]:
        p = self._omap_path(oid)
        if not os.path.exists(p):
            return {}
        with open(p, "rb") as f:
            payload, _ = unframe(f.read(), 0)
        if payload is None:
            return {}
        return Decoder(payload).value()  # type: ignore[return-value]

    def _write_omap(self, oid: str, omap: Dict[str, bytes]) -> None:
        tmp = self._omap_path(oid) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(frame(Encoder().value(omap).bytes()))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._omap_path(oid))

    def _read_attrs(self, oid: str) -> Dict[str, object]:
        p = self._attr_path(oid)
        if not os.path.exists(p):
            return {}
        with open(p, "rb") as f:
            payload, _ = unframe(f.read(), 0)
        if payload is None:
            return {}
        return Decoder(payload).value()  # type: ignore[return-value]

    def _write_attrs(self, oid: str, attrs: Dict[str, object]) -> None:
        tmp = self._attr_path(oid) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(frame(Encoder().value(attrs).bytes()))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._attr_path(oid))

    def _apply(self, txn: Transaction) -> None:
        for op in txn.ops:
            if op.op == "write":
                p = self._data_path(op.oid)
                mode = "r+b" if os.path.exists(p) else "w+b"
                with open(p, mode) as f:
                    f.seek(0, os.SEEK_END)
                    size = f.tell()
                    if size < op.offset:
                        f.write(b"\0" * (op.offset - size))
                    f.seek(op.offset)
                    f.write(op.data)
                    f.flush()
                    os.fsync(f.fileno())
            elif op.op == "truncate":
                p = self._data_path(op.oid)
                if not os.path.exists(p):
                    open(p, "wb").close()
                with open(p, "r+b") as f:
                    f.truncate(op.offset)
                    f.flush()
                    os.fsync(f.fileno())
            elif op.op == "setattr":
                attrs = self._read_attrs(op.oid)
                attrs[op.attr_name] = op.attr_value
                self._write_attrs(op.oid, attrs)
                # setattr on a fresh object must create it (MemStore does)
                p = self._data_path(op.oid)
                if not os.path.exists(p):
                    open(p, "wb").close()
            elif op.op == "clone":
                import shutil

                sp = self._data_path(op.oid)
                dp = self._data_path(op.attr_name)
                if os.path.exists(dp):
                    # journal-replay idempotency: later ops in the same
                    # txn mutate the source (truncate/overwrite), so
                    # re-cloning on replay would capture post-txn bytes
                    # and destroy the snapshot.  Clone targets are
                    # create-once (unique snap seq), so an existing dst
                    # means the op already applied.
                    continue
                if not os.path.exists(sp):
                    raise FileNotFoundError(op.oid)
                shutil.copyfile(sp, dp)
                self._write_attrs(op.attr_name, self._read_attrs(op.oid))
            elif op.op == "remove":
                for p in (self._data_path(op.oid), self._attr_path(op.oid),
                          self._omap_path(op.oid)):
                    try:
                        os.remove(p)
                    except FileNotFoundError:
                        pass
            elif op.op == "omap_set":
                omap = self._read_omap(op.oid)
                omap.update(op.attr_value)
                self._write_omap(op.oid, omap)
                p = self._data_path(op.oid)
                if not os.path.exists(p):
                    open(p, "wb").close()
            elif op.op == "omap_rm":
                omap = self._read_omap(op.oid)
                for k in op.attr_value:
                    omap.pop(k, None)
                self._write_omap(op.oid, omap)
            elif op.op == "omap_clear":
                try:
                    os.remove(self._omap_path(op.oid))
                except FileNotFoundError:
                    pass
            else:
                raise ValueError(f"unknown op {op.op}")

    # -- reads (MemStore API) ----------------------------------------------

    def read(self, oid: str, offset: int = 0, length: int = -1) -> bytes:
        p = self._data_path(oid)
        if not os.path.exists(p):
            raise FileNotFoundError(oid)
        with open(p, "rb") as f:
            f.seek(offset)
            return f.read() if length < 0 else f.read(length)

    def getattr(self, oid: str, name: str):
        if not os.path.exists(self._data_path(oid)):
            raise FileNotFoundError(oid)
        return self._read_attrs(oid).get(name)

    def omap_get(self, oid: str, keys: Optional[List[str]] = None
                 ) -> Dict[str, bytes]:
        if not os.path.exists(self._data_path(oid)):
            raise FileNotFoundError(oid)
        omap = self._read_omap(oid)
        if keys is None:
            return omap
        return {k: omap[k] for k in keys if k in omap}

    def stat(self, oid: str) -> int:
        p = self._data_path(oid)
        if not os.path.exists(p):
            raise FileNotFoundError(oid)
        return os.path.getsize(p)

    def exists(self, oid: str) -> bool:
        return os.path.exists(self._data_path(oid))

    def list_objects(self) -> List[str]:
        names = []
        for name in os.listdir(self._objdir):
            if name.endswith(".data"):
                names.append(_unescape(name[: -len(".data")]))
        return sorted(names)

    # test hook (scrub/EIO-path tests)
    def corrupt(self, oid: str, offset: int) -> None:
        with open(self._data_path(oid), "r+b") as f:
            f.seek(offset)
            b = f.read(1)
            f.seek(offset)
            f.write(bytes([b[0] ^ 0xFF]))
