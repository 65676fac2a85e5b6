"""Persistent KeyValueDB: write-ahead log + sorted-table LSM.

Port of ``ceph_tpu/kv/lsm.py``.

The reference embeds RocksDB (src/kv/RocksDBStore.cc) for BlueStore
metadata and the monitor store.  Vendoring RocksDB is neither possible nor
idiomatic here; this is a small LSM with the same durability contract:

* every ``submit_transaction`` appends one crc-framed record to the WAL
  and hands it to the OS (fsync when ``sync=True`` -- the
  `submit_transaction_sync` path);
* the memtable absorbs writes; at ``memtable_limit`` bytes it is flushed
  to an immutable sorted table file (SSTable) and the WAL is truncated;
* ``open`` loads SSTables then replays the WAL, cutting a torn tail
  record off (crash recovery);
* reads consult memtable, then SSTables newest-first; tombstones shadow
  older values; ``compact`` folds all tables into one and drops
  tombstones.

File layout under ``path/``:  ``wal.log``, ``sst.<n>`` (n increasing),
``CURRENT`` (framed manifest listing live tables -- written atomically via
rename, the manifest role of RocksDB's MANIFEST).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

from ceph_tpu_torch.kv.keyvaluedb import KeyValueDB, KVTransaction
from ceph_tpu_torch.utils.encoding import (Decoder, Encoder, cut_torn_tail,
                                          frame, unframe)

#: memtable tombstone marker (values are bytes; None marks deletion)
_TOMBSTONE = None


def _encode_txn(txn: KVTransaction) -> bytes:
    enc = Encoder()
    enc.varint(len(txn.ops))
    for op in txn.ops:
        enc.string(op[0])
        if op[0] == "set":
            enc.string(op[1]).string(op[2]).blob(op[3])
        elif op[0] == "rm":
            enc.string(op[1]).string(op[2])
        else:  # rm_prefix
            enc.string(op[1])
    return enc.bytes()


def _decode_txn(payload: bytes) -> KVTransaction:
    dec = Decoder(payload)
    txn = KVTransaction()
    for _ in range(dec.varint()):
        kind = dec.string()
        if kind == "set":
            txn.set(dec.string(), dec.string(), dec.blob())
        elif kind == "rm":
            txn.rmkey(dec.string(), dec.string())
        else:
            txn.rmkeys_by_prefix(dec.string())
    return txn


class _SSTable:
    """Immutable sorted (prefix, key) -> value-or-tombstone file."""

    def __init__(self, path: str):
        self.path = path
        self._index: Dict[Tuple[str, str], Tuple[int, int, bool]] = {}
        self._load()

    def _load(self) -> None:
        with open(self.path, "rb") as f:
            data = f.read()
        payload, _ = unframe(data, 0)
        if payload is None:
            raise IOError(f"corrupt sstable {self.path}")
        dec = Decoder(payload)
        for _ in range(dec.varint()):
            prefix = dec.string()
            key = dec.string()
            is_tomb = dec.u8() == 1
            blob = dec.blob()
            # values stored inline in the single frame; remember directly
            self._index[(prefix, key)] = blob if not is_tomb else _TOMBSTONE  # type: ignore[assignment]

    @staticmethod
    def write(path: str, items: List[Tuple[Tuple[str, str], Optional[bytes]]]) -> None:
        enc = Encoder()
        enc.varint(len(items))
        for (prefix, key), value in sorted(items):
            enc.string(prefix).string(key)
            if value is _TOMBSTONE:
                enc.u8(1).blob(b"")
            else:
                enc.u8(0).blob(value)  # type: ignore[arg-type]
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(frame(enc.bytes()))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def get(self, prefix: str, key: str, default=KeyError):
        try:
            return self._index[(prefix, key)]
        except KeyError:
            return default

    def items(self) -> Iterator[Tuple[Tuple[str, str], Optional[bytes]]]:
        return iter(sorted(self._index.items()))


class LSMStore(KeyValueDB):
    def __init__(self, path: str, memtable_limit: int = 4 << 20):
        self.path = path
        self.memtable_limit = memtable_limit
        self._mem: Dict[Tuple[str, str], Optional[bytes]] = {}
        self._mem_bytes = 0
        self._tables: List[_SSTable] = []  # oldest .. newest
        self._wal = None
        self._next_sst = 0
        self._opened = False

    # -- lifecycle ---------------------------------------------------------

    def open(self) -> None:
        os.makedirs(self.path, exist_ok=True)
        current = os.path.join(self.path, "CURRENT")
        names: List[str] = []
        if os.path.exists(current):
            with open(current, "rb") as f:
                payload, _ = unframe(f.read(), 0)
            if payload is not None:
                names = Decoder(payload).value()  # type: ignore[assignment]
        for name in names:
            self._tables.append(_SSTable(os.path.join(self.path, name)))
            self._next_sst = max(self._next_sst, int(name.split(".")[1]) + 1)
        # replay WAL (torn tail ends replay -- crash semantics)
        wal_path = os.path.join(self.path, "wal.log")
        if os.path.exists(wal_path):
            with open(wal_path, "rb") as f:
                data = f.read()
            pos = 0
            while True:
                payload, pos = unframe(data, pos)
                if payload is None:
                    break
                self._apply_mem(_decode_txn(payload))
            cut_torn_tail(wal_path, pos, len(data))
        self._wal = open(wal_path, "ab")
        self._opened = True

    def close(self) -> None:
        if self._wal is not None:
            self._wal.flush()
            os.fsync(self._wal.fileno())
            self._wal.close()
            self._wal = None
        self._opened = False

    # -- writes ------------------------------------------------------------

    def _apply_mem(self, txn: KVTransaction) -> None:
        for op in txn.ops:
            if op[0] == "set":
                self._mem[(op[1], op[2])] = op[3]
                self._mem_bytes += len(op[2]) + len(op[3])
            elif op[0] == "rm":
                self._mem[(op[1], op[2])] = _TOMBSTONE
            else:  # rm_prefix: tombstone every visible key under the prefix
                for pfx, key in list(self._visible_keys(op[1])):
                    self._mem[(pfx, key)] = _TOMBSTONE

    def submit_transaction(self, txn: KVTransaction, sync: bool = False) -> None:
        assert self._opened, "LSMStore used before open()"
        self._wal.write(frame(_encode_txn(txn)))
        # every record reaches the OS before the call returns, so a
        # process that dies after it loses nothing it submitted (the JAX
        # package leaves unsynced records in the file object's buffer);
        # only ``sync`` makes it survive the machine's loss
        self._wal.flush()
        if sync:
            os.fsync(self._wal.fileno())
        self._apply_mem(txn)
        if self._mem_bytes >= self.memtable_limit:
            self.flush()

    def flush(self) -> None:
        """Freeze the memtable into a new SSTable and truncate the WAL."""
        if not self._mem:
            return
        name = f"sst.{self._next_sst}"
        self._next_sst += 1
        _SSTable.write(
            os.path.join(self.path, name), list(self._mem.items())
        )
        self._tables.append(_SSTable(os.path.join(self.path, name)))
        self._write_manifest()
        self._mem.clear()
        self._mem_bytes = 0
        self._wal.close()
        self._wal = open(os.path.join(self.path, "wal.log"), "wb")

    def _write_manifest(self) -> None:
        names = [os.path.basename(t.path) for t in self._tables]
        tmp = os.path.join(self.path, "CURRENT.tmp")
        with open(tmp, "wb") as f:
            f.write(frame(Encoder().value(names).bytes()))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.path, "CURRENT"))

    def compact(self) -> None:
        """Fold everything into one table, dropping tombstones."""
        merged: Dict[Tuple[str, str], Optional[bytes]] = {}
        for table in self._tables:  # oldest first: newer wins
            for k, v in table.items():
                merged[k] = v
        merged.update(self._mem)
        live = [(k, v) for k, v in sorted(merged.items()) if v is not _TOMBSTONE]
        old = list(self._tables)
        name = f"sst.{self._next_sst}"
        self._next_sst += 1
        _SSTable.write(os.path.join(self.path, name), live)
        self._tables = [_SSTable(os.path.join(self.path, name))]
        self._write_manifest()
        self._mem.clear()
        self._mem_bytes = 0
        self._wal.close()
        self._wal = open(os.path.join(self.path, "wal.log"), "wb")
        for t in old:
            try:
                os.remove(t.path)
            except OSError:
                pass

    # -- reads -------------------------------------------------------------

    def get(self, prefix: str, key: str) -> Optional[bytes]:
        pk = (prefix, key)
        if pk in self._mem:
            v = self._mem[pk]
            return None if v is _TOMBSTONE else v
        for table in reversed(self._tables):
            v = table.get(prefix, key)
            if v is not KeyError:
                return None if v is _TOMBSTONE else v
        return None

    def _visible_keys(self, prefix: str) -> Iterator[Tuple[str, str]]:
        seen: Dict[str, bool] = {}
        for pk, v in self._mem.items():
            if pk[0] == prefix:
                seen[pk[1]] = v is not _TOMBSTONE
        for table in reversed(self._tables):
            for pk, v in table.items():
                if pk[0] == prefix and pk[1] not in seen:
                    seen[pk[1]] = v is not _TOMBSTONE
        for key in sorted(k for k, live in seen.items() if live):
            yield prefix, key

    def get_iterator(self, prefix: str) -> Iterator[Tuple[str, bytes]]:
        for _, key in self._visible_keys(prefix):
            v = self.get(prefix, key)
            if v is not None:
                yield key, v
