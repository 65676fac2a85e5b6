"""In-memory ObjectStore (MemStore equivalent).

Port of ``ceph_tpu/osd/memstore.py``.

Reference: src/os/memstore/MemStore.cc -- the in-RAM ObjectStore used by
unit tests; transactions apply atomically (reference ObjectStore semantics:
a queued transaction either fully commits or not at all).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.osd.types import Transaction


class MemObject:
    def __init__(self):
        self.data = bytearray()
        self.xattrs: Dict[str, object] = {}
        self.omap: Dict[str, bytes] = {}


class MemStore:
    def __init__(self):
        self._objects: Dict[str, MemObject] = {}
        self._lock = threading.Lock()
        # incremental usage totals (the ObjectStore statfs role):
        # maintained at the transaction swap so stats() is O(1) -- the
        # mgr report loop reads it every interval and MUST NOT pay
        # O(objects) per report (tests/test_telemetry.py pins this)
        self._n_shards = 0
        self._n_metas = 0
        self._bytes = 0

    # -- transactions ------------------------------------------------------

    def queue_transaction(self, txn: Transaction) -> None:
        """Apply atomically (all ops under one lock, staged then swapped)."""
        with self._lock:
            staged: Dict[str, Optional[MemObject]] = {}

            def obj_for(oid: str) -> MemObject:
                if oid not in staged:
                    existing = self._objects.get(oid)
                    clone = MemObject()
                    if existing is not None:
                        clone.data = bytearray(existing.data)
                        clone.xattrs = dict(existing.xattrs)
                        clone.omap = dict(existing.omap)
                    staged[oid] = clone
                return staged[oid]  # type: ignore[return-value]

            for op in txn.ops:
                if op.op == "write":
                    o = obj_for(op.oid)
                    end = op.offset + len(op.data)
                    if len(o.data) < end:
                        o.data.extend(b"\0" * (end - len(o.data)))
                    o.data[op.offset : end] = op.data
                elif op.op == "setattr":
                    obj_for(op.oid).xattrs[op.attr_name] = op.attr_value
                elif op.op == "truncate":
                    o = obj_for(op.oid)
                    if op.offset < len(o.data):
                        del o.data[op.offset :]
                    else:
                        o.data.extend(b"\0" * (op.offset - len(o.data)))
                elif op.op == "clone":
                    src = staged[op.oid] if op.oid in staged \
                        else self._objects.get(op.oid)
                    if src is None:
                        raise FileNotFoundError(op.oid)
                    dst = MemObject()
                    dst.data = bytearray(src.data)
                    dst.xattrs = dict(src.xattrs)
                    staged[op.attr_name] = dst
                elif op.op == "remove":
                    staged[op.oid] = None
                elif op.op == "omap_set":
                    obj_for(op.oid).omap.update(op.attr_value)
                elif op.op == "omap_rm":
                    o = obj_for(op.oid)
                    for k in op.attr_value:
                        o.omap.pop(k, None)
                elif op.op == "omap_clear":
                    obj_for(op.oid).omap.clear()
                else:
                    raise ValueError(f"unknown op {op.op}")
            for oid, obj in staged.items():
                prior = self._objects.get(oid)
                is_meta = oid.endswith("@meta")
                if prior is not None:
                    self._bytes -= len(prior.data)
                    if is_meta:
                        self._n_metas -= 1
                    else:
                        self._n_shards -= 1
                if obj is None:
                    self._objects.pop(oid, None)
                else:
                    self._objects[oid] = obj
                    self._bytes += len(obj.data)
                    if is_meta:
                        self._n_metas += 1
                    else:
                        self._n_shards += 1

    # -- reads -------------------------------------------------------------

    def read(self, oid: str, offset: int = 0, length: int = -1) -> bytes:
        with self._lock:
            obj = self._objects.get(oid)
            if obj is None:
                raise FileNotFoundError(oid)
            if length < 0:
                return bytes(obj.data[offset:])
            return bytes(obj.data[offset : offset + length])

    def getattr(self, oid: str, name: str):
        with self._lock:
            obj = self._objects.get(oid)
            if obj is None:
                raise FileNotFoundError(oid)
            return obj.xattrs.get(name)

    def omap_get(self, oid: str, keys: Optional[List[str]] = None
                 ) -> Dict[str, bytes]:
        with self._lock:
            obj = self._objects.get(oid)
            if obj is None:
                raise FileNotFoundError(oid)
            if keys is None:
                return dict(obj.omap)
            return {k: obj.omap[k] for k in keys if k in obj.omap}

    def stat(self, oid: str) -> int:
        with self._lock:
            obj = self._objects.get(oid)
            if obj is None:
                raise FileNotFoundError(oid)
            return len(obj.data)

    def exists(self, oid: str) -> bool:
        with self._lock:
            return oid in self._objects

    def list_objects(self) -> List[str]:
        with self._lock:
            return sorted(self._objects.keys())

    def stats(self) -> Dict[str, int]:
        """O(1) usage totals (statfs role): stored names split into
        data/parity shard objects ("oid@N") and replicated meta twins
        ("oid@meta"), plus total data bytes."""
        with self._lock:
            return {
                "objects": self._n_shards + self._n_metas,
                "shards": self._n_shards,
                "metas": self._n_metas,
                "bytes": self._bytes,
            }

    # test hook: corrupt a byte (scrub/EIO-path tests)
    def corrupt(self, oid: str, offset: int) -> None:
        with self._lock:
            self._objects[oid].data[offset] ^= 0xFF
