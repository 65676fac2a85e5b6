"""KV sub-layer (reference: src/kv -- KeyValueDB with RocksDB/LevelDB/
MemDB backends behind one interface, src/kv/KeyValueDB.h).

Port of ``ceph_tpu/kv/``."""

from ceph_tpu_torch.kv.keyvaluedb import KeyValueDB, KVTransaction, MemDB
from ceph_tpu_torch.kv.lsm import LSMStore


def create(kind: str, path: str = "") -> KeyValueDB:
    """KeyValueDB::create analogue (src/kv/KeyValueDB.cc): pick a backend
    by name.  ``memdb`` is RAM-only; ``lsm`` is the persistent
    WAL+SSTable store (our rocksdb-equivalent)."""
    if kind == "memdb":
        return MemDB()
    if kind == "lsm":
        if not path:
            raise ValueError("lsm KeyValueDB needs a path")
        return LSMStore(path)
    raise ValueError(f"unknown KeyValueDB backend {kind!r}")


__all__ = ["KeyValueDB", "KVTransaction", "MemDB", "LSMStore", "create"]
