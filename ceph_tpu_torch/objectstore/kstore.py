"""KV-backed ObjectStore (KStore equivalent).

Port of ``ceph_tpu/objectstore/kstore.py``.

Reference: src/os/kstore/KStore.cc (3358 LoC) -- object data and metadata
both live in the KeyValueDB: data is chunked into fixed-size stripes under
a per-object key prefix, metadata (size, xattrs) under another.  Pairs
with the ``lsm`` KeyValueDB for a fully persistent store, or ``memdb``
for a RAM one.

Key layout (prefix, key):
  ("M", oid)            -> framed {size, xattrs} metadata
  ("D", f"{oid}.{n:08d}") -> data stripe n (stripe_size bytes, tail short)
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ceph_tpu_torch import kv as kv_mod
from ceph_tpu_torch.kv.keyvaluedb import KeyValueDB, KVTransaction
from ceph_tpu_torch.objectstore.statfs import ScanStatsMixin
from ceph_tpu_torch.osd.types import Transaction
from ceph_tpu_torch.utils.encoding import Decoder, Encoder


class KStore(ScanStatsMixin):
    def __init__(self, path: str, db: Optional[KeyValueDB] = None,
                 stripe_size: int = 64 * 1024):
        self.stripe_size = stripe_size
        self.db = db if db is not None else kv_mod.create("lsm", path)
        self.db.open()

    def umount(self) -> None:
        self.db.close()

    # -- metadata helpers --------------------------------------------------

    def _get_meta(self, oid: str) -> Optional[dict]:
        raw = self.db.get("M", oid)
        if raw is None:
            return None
        return Decoder(raw).value()  # type: ignore[return-value]

    @staticmethod
    def _meta_bytes(meta: dict) -> bytes:
        return Encoder().value(meta).bytes()

    def _stripe_key(self, oid: str, n: int) -> str:
        return f"{oid}.{n:08d}"

    def _omap_key(self, oid: str, key: str) -> str:
        return f"{oid}\x00{key}"

    def _omap_db_keys(self, oid: str) -> List[str]:
        prefix = oid + "\x00"
        return [
            k[len(prefix):]
            for k, _ in self.db.get_iterator("O")
            if k.startswith(prefix)
        ]

    # -- transaction path --------------------------------------------------

    def queue_transaction(self, txn: Transaction) -> None:
        """Stage everything, then one atomic KV batch (the reference's
        one-rocksdb-WriteBatch-per-transaction contract)."""
        batch = KVTransaction()
        metas: Dict[str, Optional[dict]] = {}
        stripes: Dict[str, Dict[int, bytearray]] = {}
        #: staged omap mutations per oid: key -> bytes (set) | None (rm)
        omaps: Dict[str, Dict[str, Optional[bytes]]] = {}
        removed: set = set()  # oids removed earlier in this txn

        def meta_for(oid: str) -> dict:
            if oid not in metas:
                metas[oid] = self._get_meta(oid) or {"size": 0, "xattrs": {}}
            m = metas[oid]
            if m is None:  # removed earlier in this txn, then recreated
                m = {"size": 0, "xattrs": {}}
                metas[oid] = m
            return m

        def stripe_for(oid: str, n: int) -> bytearray:
            obj = stripes.setdefault(oid, {})
            if n not in obj:
                raw = (
                    None if oid in removed
                    else self.db.get("D", self._stripe_key(oid, n))
                )
                obj[n] = bytearray(raw) if raw is not None else bytearray()
            return obj[n]

        for op in txn.ops:
            if op.op == "write":
                meta = meta_for(op.oid)
                end = op.offset + len(op.data)
                pos = op.offset
                dpos = 0
                while pos < end:
                    n, off = divmod(pos, self.stripe_size)
                    take = min(self.stripe_size - off, end - pos)
                    st = stripe_for(op.oid, n)
                    if len(st) < off + take:
                        st.extend(b"\0" * (off + take - len(st)))
                    st[off : off + take] = op.data[dpos : dpos + take]
                    pos += take
                    dpos += take
                meta["size"] = max(meta["size"], end)
            elif op.op == "truncate":
                meta = meta_for(op.oid)
                old_size = meta["size"]
                meta["size"] = op.offset
                if op.offset < old_size:
                    first_dead = (
                        op.offset + self.stripe_size - 1
                    ) // self.stripe_size
                    for n in range(first_dead,
                                   (old_size // self.stripe_size) + 1):
                        stripes.setdefault(op.oid, {})[n] = bytearray()
                    ln, loff = divmod(op.offset, self.stripe_size)
                    if loff:
                        st = stripe_for(op.oid, ln)
                        del st[loff:]
            elif op.op == "setattr":
                meta_for(op.oid)["xattrs"][op.attr_name] = op.attr_value
            elif op.op == "clone":
                src_meta = metas[op.oid] if op.oid in metas \
                    else self._get_meta(op.oid)
                if src_meta is None:
                    raise FileNotFoundError(op.oid)
                dst = op.attr_name
                metas[dst] = {"size": src_meta["size"],
                              "xattrs": dict(src_meta["xattrs"])}
                removed.discard(dst)
                for n in range(src_meta["size"] // self.stripe_size + 1):
                    st = stripes.get(op.oid, {}).get(n)
                    if st is None:
                        raw = self.db.get("D", self._stripe_key(op.oid, n))
                        st = bytearray(raw) if raw is not None else None
                    if st is not None:
                        stripes.setdefault(dst, {})[n] = bytearray(st)
            elif op.op == "remove":
                # dead-stripe range must cover the ON-DISK size too: a
                # shrink staged earlier in this txn would otherwise leave
                # orphan stripes beyond the staged size, and their stale
                # bytes could resurface in a later sparse write
                staged = metas.get(op.oid)
                disk = self._get_meta(op.oid)
                max_size = max(
                    (m["size"] for m in (staged, disk) if m), default=0
                )
                metas[op.oid] = None
                stripes.pop(op.oid, None)
                omaps.pop(op.oid, None)
                removed.add(op.oid)
                batch.rmkey("M", op.oid)
                for n in range(max_size // self.stripe_size + 1):
                    batch.rmkey("D", self._stripe_key(op.oid, n))
                for k in self._omap_db_keys(op.oid):
                    batch.rmkey("O", self._omap_key(op.oid, k))
            elif op.op == "omap_set":
                meta_for(op.oid)
                omaps.setdefault(op.oid, {}).update(op.attr_value)
            elif op.op == "omap_rm":
                staged_omap = omaps.setdefault(op.oid, {})
                for k in op.attr_value:
                    staged_omap[k] = None
            elif op.op == "omap_clear":
                staged_omap = omaps.setdefault(op.oid, {})
                staged_omap.clear()
                keys = (
                    [] if op.oid in removed else self._omap_db_keys(op.oid)
                )
                for k in keys:
                    staged_omap[k] = None
            else:
                raise ValueError(f"unknown op {op.op}")

        for oid, meta in metas.items():
            if meta is None:
                continue
            batch.set("M", oid, self._meta_bytes(meta))
        for oid, obj in stripes.items():
            if metas.get(oid, True) is None:
                continue
            for n, st in obj.items():
                if st:
                    batch.set("D", self._stripe_key(oid, n), bytes(st))
                else:
                    batch.rmkey("D", self._stripe_key(oid, n))
        for oid, staged_omap in omaps.items():
            if metas.get(oid, True) is None:
                continue
            for k, v in staged_omap.items():
                if v is None:
                    batch.rmkey("O", self._omap_key(oid, k))
                else:
                    batch.set("O", self._omap_key(oid, k), v)
        self.db.submit_transaction(batch, sync=True)
        self._stats_invalidate()

    # -- reads (MemStore API) ----------------------------------------------

    def read(self, oid: str, offset: int = 0, length: int = -1) -> bytes:
        meta = self._get_meta(oid)
        if meta is None:
            raise FileNotFoundError(oid)
        size = meta["size"]
        end = size if length < 0 else min(size, offset + length)
        if offset >= end:
            return b""
        out = bytearray(end - offset)
        pos = offset
        while pos < end:
            n, off = divmod(pos, self.stripe_size)
            take = min(self.stripe_size - off, end - pos)
            raw = self.db.get("D", self._stripe_key(oid, n)) or b""
            chunk = raw[off : off + take]
            out[pos - offset : pos - offset + len(chunk)] = chunk
            pos += take
        return bytes(out)

    def getattr(self, oid: str, name: str):
        meta = self._get_meta(oid)
        if meta is None:
            raise FileNotFoundError(oid)
        return meta["xattrs"].get(name)

    def omap_get(self, oid: str, keys: Optional[List[str]] = None
                 ) -> Dict[str, bytes]:
        if self._get_meta(oid) is None:
            raise FileNotFoundError(oid)
        if keys is not None:
            out = {}
            for k in keys:
                v = self.db.get("O", self._omap_key(oid, k))
                if v is not None:
                    out[k] = v
            return out
        return {
            k: self.db.get("O", self._omap_key(oid, k))
            for k in self._omap_db_keys(oid)
        }

    def stat(self, oid: str) -> int:
        meta = self._get_meta(oid)
        if meta is None:
            raise FileNotFoundError(oid)
        return meta["size"]

    def exists(self, oid: str) -> bool:
        return self._get_meta(oid) is not None

    def list_objects(self) -> List[str]:
        return sorted(k for k, _ in self.db.get_iterator("M"))

    # test hook (scrub/EIO-path tests)
    def corrupt(self, oid: str, offset: int) -> None:
        n, off = divmod(offset, self.stripe_size)
        key = self._stripe_key(oid, n)
        raw = bytearray(self.db.get("D", key))
        raw[off] ^= 0xFF
        batch = KVTransaction().set("D", key, bytes(raw))
        self.db.submit_transaction(batch, sync=True)
