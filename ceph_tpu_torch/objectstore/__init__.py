"""Storage engines (reference: src/os -- the ObjectStore layer).

Port of ``ceph_tpu/objectstore/__init__.py``.  ``ObjectStore.create``
(src/os/ObjectStore.cc:63) selects a backend by name.  All backends share
MemStore's API surface (queue_transaction / read / getattr / stat /
exists / list_objects), which is the subset of ObjectStore the EC path
uses; the persistent ones write the same file trees, byte for byte, as the
JAX package's, so either package mounts the other's stores:

* ``memstore``  -- RAM, test-grade (src/os/memstore/MemStore.cc)
* ``filestore`` -- files + crc-framed WAL journal, crash-safe
  (src/os/filestore/FileStore.cc + FileJournal)
* ``kstore``    -- everything in a KeyValueDB (src/os/kstore/KStore.cc);
  pairs with the ``lsm`` KeyValueDB for persistence
* ``blockstore`` -- raw-block data + LSM metadata + deferred-write WAL,
  the BlueStore-class production engine (src/os/bluestore/BlueStore.cc)
"""

from __future__ import annotations

from ceph_tpu_torch.objectstore.blockstore import BlockStore
from ceph_tpu_torch.objectstore.filestore import FileStore
from ceph_tpu_torch.objectstore.kstore import KStore
from ceph_tpu_torch.osd.memstore import MemStore


def create(kind: str, path: str = "", **kw):
    """``kind`` may carry a compression suffix for blockstore
    ("blockstore:zlib" -- the bluestore_compression_algorithm role)."""
    kind, _, alg = kind.partition(":")
    if kind == "memstore":
        return MemStore()
    if kind == "filestore":
        if not path:
            raise ValueError("filestore needs a data path")
        return FileStore(path)
    if kind == "kstore":
        if not path:
            raise ValueError("kstore needs a data path")
        return KStore(path)
    if kind == "blockstore":
        if not path:
            raise ValueError("blockstore needs a data path")
        kw_alg = kw.pop("compression", None)  # pop BEFORE the or-else:
        # a short-circuit would leave a duplicate kwarg in **kw
        return BlockStore(path, compression=alg or kw_alg, **kw)
    raise ValueError(f"unknown objectstore backend {kind!r}")


__all__ = ["create", "MemStore", "FileStore", "KStore", "BlockStore"]
