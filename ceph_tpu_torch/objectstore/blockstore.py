"""BlockStore: raw-block backend -- the BlueStore-analogue engine.

Port of ``ceph_tpu/objectstore/blockstore.py``.

Reference: src/os/bluestore/BlueStore.cc (role, not design): data lives on
a raw block "device" (a flat file) carved into fixed allocation units;
ALL metadata -- onodes (size, xattrs, extent map), omap, deferred-write
records -- lives in the LSM KeyValueDB (kv/lsm.py), whose WAL
makes every ObjectStore transaction atomic (the one-RocksDB-WriteBatch
contract, BlueStore::queue_transactions).

Write strategy (BlueStore's two paths, simplified to allocation-unit
granularity):

* **COW big writes**: new/changed units are written to FRESHLY allocated
  units *before* the KV commit references them, so a crash mid-write
  leaves the old onode pointing at intact old data (BlueStore's
  write-new-blob path).
* **Deferred small overwrites**: a sub-threshold overwrite of an already
  allocated unit rides INSIDE the KV transaction as a deferred record
  (phys offset + bytes), is applied in place after the commit, and is
  replayed idempotently at mount -- BlueStore's deferred-write WAL
  (bluestore_prefer_deferred_size).

The allocator is an in-memory free-set rebuilt at mount by scanning
onode extent maps + pending deferred records -- BlueStore's
NCB/allocation-from-onodes recovery mode rather than a persisted
freelist.

Compression (BlueStore blob compression, src/os/bluestore/BlueStore.cc
_do_write_data compress path): big writes covering >= 2 full allocation
units may be stored as one compressed blob -- fewer physical units than
the logical span, a crc32 over the compressed payload (the blob csum
role), and the onode extent map pointing at the blob.  A partial
overwrite of a compressed span first decompresses it back to plain
units (BlueStore's blob rewrite on overlap); reads verify the csum and
raise EIO-style on mismatch.

KV prefixes: "O" onodes, "M" omap ("<oid>\\x00<key>"), "D" deferred
records keyed by monotonic sequence.
"""

from __future__ import annotations

import os
import zlib as _zlib
from typing import Dict, List, Optional

from ceph_tpu_torch import compressor as compressor_mod
from ceph_tpu_torch.kv import lsm as lsm_mod
from ceph_tpu_torch.kv.keyvaluedb import KVTransaction
from ceph_tpu_torch.objectstore.statfs import ScanStatsMixin
from ceph_tpu_torch.osd.types import Transaction
from ceph_tpu_torch.utils.encoding import Decoder, Encoder


class BlockStore(ScanStatsMixin):
    def __init__(self, path: str, alloc_unit: int = 64 * 1024,
                 deferred_threshold: int = 32 * 1024,
                 compression: Optional[str] = None):
        if not path:
            raise ValueError("blockstore needs a data path")
        os.makedirs(path, exist_ok=True)
        self.alloc_unit = alloc_unit
        self.deferred_threshold = min(deferred_threshold, alloc_unit)
        self._comp = (compressor_mod.create(compression)
                      if compression and compression != "none" else None)
        self.db = lsm_mod.LSMStore(os.path.join(path, "kv"))
        self.db.open()
        self.block_path = os.path.join(path, "block")
        if not os.path.exists(self.block_path):
            with open(self.block_path, "wb"):
                pass
        self._dev = open(self.block_path, "r+b")
        self._free: set = set()
        self._high_water = 0
        self._deferred_seq = 0
        self._onode_cache: Dict[str, dict] = {}
        self._mount()

    # -- mount / crash recovery -------------------------------------------

    def _mount(self) -> None:
        """Replay deferred writes, rebuild the allocator from onodes."""
        used = set()
        for oid, raw in self.db.get_iterator("O"):
            onode = Decoder(raw).value()
            used.update(onode["extents"].values())
            for blob in onode.get("cblobs", {}).values():
                used.update(blob["phys"])
        replayed = KVTransaction()
        n_deferred = 0
        for seq, raw in self.db.get_iterator("D"):
            rec = Decoder(raw).value()
            # idempotent in-place replay (BlueStore deferred replay)
            self._dev_write(rec["pofs"], rec["data"])
            replayed.rmkey("D", seq)
            n_deferred += 1
            self._deferred_seq = max(self._deferred_seq, int(seq) + 1)
        if n_deferred:
            self._dev.flush()
            self.db.submit_transaction(replayed)
        self._high_water = (max(used) + 1) if used else 0
        self._free = set(range(self._high_water)) - used

    def umount(self) -> None:
        self.db.close()
        self._dev.close()

    # -- device helpers ----------------------------------------------------

    def _dev_write(self, pofs: int, data: bytes) -> None:
        self._dev.seek(pofs)
        self._dev.write(data)

    def _dev_read(self, unit: int) -> bytes:
        self._dev.seek(unit * self.alloc_unit)
        buf = self._dev.read(self.alloc_unit)
        return buf.ljust(self.alloc_unit, b"\x00")

    def _alloc(self) -> int:
        if self._free:
            u = min(self._free)
            self._free.discard(u)
            return u
        u = self._high_water
        self._high_water += 1
        return u

    # -- onode helpers -----------------------------------------------------

    def _get_onode(self, oid: str) -> Optional[dict]:
        if oid in self._onode_cache:
            return self._onode_cache[oid]
        raw = self.db.get("O", oid)
        if raw is None:
            return None
        onode = Decoder(raw).value()
        # extent keys round-trip as strings; normalize to int logical units
        onode["extents"] = {int(k): v for k, v in onode["extents"].items()}
        onode["cblobs"] = {int(k): v for k, v in
                           onode.get("cblobs", {}).items()}
        self._onode_cache[oid] = onode
        return onode

    @staticmethod
    def _onode_bytes(onode: dict) -> bytes:
        enc = dict(onode)
        enc["extents"] = {str(k): v for k, v in onode["extents"].items()}
        enc["cblobs"] = {str(k): v for k, v in
                         onode.get("cblobs", {}).items()}
        return Encoder().value(enc).bytes()

    # -- compressed blobs (BlueStore blob compression) ---------------------

    def _read_blob(self, blob: dict) -> bytes:
        """Reassemble + verify + decompress one blob; csum failure is
        the EIO the scrub path expects from a bad device."""
        comp = b"".join(self._dev_read(p) for p in blob["phys"])
        comp = comp[: blob["clen"]]
        if _zlib.crc32(comp) != blob["csum"]:
            raise IOError(
                f"compressed blob csum mismatch (span {blob['span']})")
        return compressor_mod.create(blob["alg"]).decompress(comp)

    # -- transaction path --------------------------------------------------

    def queue_transaction(self, txn: Transaction) -> None:
        """Stage data writes (COW units to the device first), then one
        atomic KV batch carrying onodes + omap + deferred records, then
        apply deferred in-place writes."""
        batch = KVTransaction()
        onodes: Dict[str, Optional[dict]] = {}
        deferred: List[dict] = []
        freed: List[int] = []

        def onode_for(oid: str) -> dict:
            if oid in onodes and onodes[oid] is not None:
                return onodes[oid]  # type: ignore[return-value]
            cur = None if onodes.get(oid, "?") is None else self._get_onode(oid)
            if cur is None:
                cur = {"size": 0, "attrs": {}, "extents": {}, "cblobs": {}}
            else:
                cur = {"size": cur["size"], "attrs": dict(cur["attrs"]),
                       "extents": dict(cur["extents"]),
                       "cblobs": {k: dict(v) for k, v in
                                  cur.get("cblobs", {}).items()}}
            onodes[oid] = cur
            return cur

        def explode_blobs(onode: dict, u_lo: int, u_hi: int) -> None:
            """Rewrite compressed blobs overlapping logical units
            [u_lo, u_hi] as plain COW units (BlueStore decompresses and
            rewrites a blob a write lands inside)."""
            au = self.alloc_unit
            for b0 in sorted(onode["cblobs"]):
                blob = onode["cblobs"][b0]
                if b0 > u_hi or b0 + blob["span"] - 1 < u_lo:
                    continue
                data = self._read_blob(blob)
                del onode["cblobs"][b0]
                freed.extend(blob["phys"])
                for i in range(blob["span"]):
                    new_phys = self._alloc()
                    self._dev_write(
                        new_phys * au,
                        data[i * au:(i + 1) * au].ljust(au, b"\x00"))
                    onode["extents"][b0 + i] = new_phys

        def write_units(onode: dict, offset: int, data: bytes) -> None:
            au = self.alloc_unit
            end = offset + len(data)
            u0, u1 = offset // au, (end - 1) // au
            explode_blobs(onode, u0, u1)
            if self._comp is not None:
                # blob compression for the aligned full-unit core of a
                # big write: stored only when it saves whole units
                core_lo = (offset + au - 1) // au
                core_hi = end // au
                n = core_hi - core_lo
                if n >= 2:
                    span = data[core_lo * au - offset:core_hi * au - offset]
                    comp = self._comp.compress(span)
                    units_needed = (len(comp) + au - 1) // au
                    if units_needed < n:
                        phys = []
                        for i in range(units_needed):
                            p = self._alloc()
                            self._dev_write(
                                p * au,
                                comp[i * au:(i + 1) * au].ljust(au, b"\0"))
                            phys.append(p)
                        for u in range(core_lo, core_hi):
                            old = onode["extents"].pop(u, None)
                            if old is not None:
                                freed.append(old)
                        onode["cblobs"][core_lo] = {
                            "phys": phys, "span": n, "clen": len(comp),
                            "alg": self._comp.name,
                            "csum": _zlib.crc32(comp),
                        }
                        # head/tail partial pieces go the plain path
                        if offset < core_lo * au:
                            write_units(onode, offset,
                                        data[: core_lo * au - offset])
                        if core_hi * au < end:
                            write_units(onode, core_hi * au,
                                        data[core_hi * au - offset:])
                        return
            for u in range(u0, u1 + 1):
                lo = max(offset, u * au)
                hi = min(end, (u + 1) * au)
                piece = data[lo - offset:hi - offset]
                old_phys = onode["extents"].get(u)
                full_unit = (lo == u * au and hi == (u + 1) * au)
                if (
                    old_phys is not None and not full_unit
                    and len(piece) <= self.deferred_threshold
                ):
                    # deferred small overwrite: bytes ride the KV commit
                    deferred.append({
                        "pofs": old_phys * au + (lo - u * au),
                        "data": piece,
                    })
                    continue
                # COW: merge with old unit content (zeros for holes),
                # write to a freshly allocated unit
                if full_unit:
                    buf = piece
                else:
                    base = (
                        bytearray(self._dev_read(old_phys))
                        if old_phys is not None
                        else bytearray(au)
                    )
                    if old_phys is not None:
                        # earlier ops in THIS txn may have staged deferred
                        # pieces against this unit that are not on the
                        # device yet: fold them into the merge base
                        p0 = old_phys * au
                        for rec in deferred:
                            if p0 <= rec["pofs"] < p0 + au:
                                off = rec["pofs"] - p0
                                base[off:off + len(rec["data"])] = rec["data"]
                    base[lo - u * au:hi - u * au] = piece
                    buf = bytes(base)
                new_phys = self._alloc()
                self._dev_write(new_phys * au, buf)
                onode["extents"][u] = new_phys
                if old_phys is not None:
                    freed.append(old_phys)

        def truncate_to(onode: dict, size: int) -> None:
            au = self.alloc_unit
            old_size = onode["size"]
            if size < old_size:
                keep_units = (size + au - 1) // au if size else 0
                for b0 in sorted(onode["cblobs"]):
                    blob = onode["cblobs"][b0]
                    if b0 >= keep_units:
                        freed.extend(blob["phys"])
                        del onode["cblobs"][b0]
                    elif size < (b0 + blob["span"]) * au:
                        # the cut lands inside the blob (incl. inside
                        # its LAST unit): back to plain units so the
                        # tail logic below can zero/free them
                        explode_blobs(onode, b0, b0 + blob["span"] - 1)
                for u in list(onode["extents"]):
                    if u >= keep_units:
                        freed.append(onode["extents"].pop(u))
                # zero the stale tail of the last kept unit via COW so a
                # later re-grow reads zeros there
                if size % au and (size // au) in onode["extents"]:
                    u = size // au
                    base = bytearray(self._dev_read(onode["extents"][u]))
                    base[size % au:] = bytes(au - size % au)
                    new_phys = self._alloc()
                    self._dev_write(new_phys * au, bytes(base))
                    freed.append(onode["extents"][u])
                    onode["extents"][u] = new_phys
            onode["size"] = size

        for op in txn.ops:
            if op.op == "write":
                onode = onode_for(op.oid)
                write_units(onode, op.offset, op.data)
                onode["size"] = max(onode["size"], op.offset + len(op.data))
            elif op.op == "truncate":
                truncate_to(onode_for(op.oid), op.offset)
            elif op.op == "setattr":
                onode_for(op.oid)["attrs"][op.attr_name] = op.attr_value
            elif op.op == "clone":
                src_exists = (
                    onodes.get(op.oid) is not None
                    if op.oid in onodes else self._get_onode(op.oid)
                )
                if not src_exists:
                    raise FileNotFoundError(op.oid)
                src = onode_for(op.oid)
                au = self.alloc_unit
                dst = {"size": src["size"], "attrs": dict(src["attrs"]),
                       "extents": {}, "cblobs": {}}
                for u, phys in src["extents"].items():
                    base = bytearray(self._dev_read(phys))
                    p0 = phys * au
                    for rec in deferred:
                        if p0 <= rec["pofs"] < p0 + au:
                            off = rec["pofs"] - p0
                            base[off:off + len(rec["data"])] = rec["data"]
                    new_phys = self._alloc()
                    self._dev_write(new_phys * au, bytes(base))
                    dst["extents"][u] = new_phys
                for b0, blob in src["cblobs"].items():
                    phys = []
                    for p in blob["phys"]:
                        np_ = self._alloc()
                        self._dev_write(np_ * au, self._dev_read(p))
                        phys.append(np_)
                    dst["cblobs"][b0] = dict(blob, phys=phys)
                # a clone earlier staged under this name is replaced
                old = onodes.get(op.attr_name)
                if old:
                    freed.extend(old["extents"].values())
                    for blob in old["cblobs"].values():
                        freed.extend(blob["phys"])
                onodes[op.attr_name] = dst
            elif op.op == "remove":
                cur = onode_for(op.oid)
                freed.extend(cur["extents"].values())
                for blob in cur["cblobs"].values():
                    freed.extend(blob["phys"])
                onodes[op.oid] = None
                for k in self._omap_db_keys(op.oid):
                    batch.rmkey("M", f"{op.oid}\x00{k}")
            elif op.op == "omap_set":
                onode_for(op.oid)  # touch/create like the other stores
                for k, v in op.attr_value.items():
                    batch.set("M", f"{op.oid}\x00{k}", v)
            elif op.op == "omap_rm":
                onode_for(op.oid)
                for k in op.attr_value:
                    batch.rmkey("M", f"{op.oid}\x00{k}")
            elif op.op == "omap_clear":
                onode_for(op.oid)
                for k in self._omap_db_keys(op.oid):
                    batch.rmkey("M", f"{op.oid}\x00{k}")
            else:
                raise ValueError(f"unknown txn op {op.op!r}")

        # data first, then the metadata commit that references it
        self._dev.flush()
        for oid, onode in onodes.items():
            if onode is None:
                batch.rmkey("O", oid)
                self._onode_cache.pop(oid, None)
            else:
                batch.set("O", oid, self._onode_bytes(onode))
                self._onode_cache[oid] = onode
        cleanup = KVTransaction()
        for rec in deferred:
            key = f"{self._deferred_seq:016d}"
            self._deferred_seq += 1
            batch.set("D", key, Encoder().value(rec).bytes())
            cleanup.rmkey("D", key)
        self.db.submit_transaction(batch)
        # deferred applies land in place only after their records are
        # durable; a crash between is covered by mount-time replay
        if deferred:
            for rec in deferred:
                self._dev_write(rec["pofs"], rec["data"])
            self._dev.flush()
            self.db.submit_transaction(cleanup)
        self._free.update(freed)
        self._stats_invalidate()

    # -- reads -------------------------------------------------------------

    def read(self, oid: str, offset: int = 0, length: int = -1) -> bytes:
        onode = self._get_onode(oid)
        if onode is None:
            raise FileNotFoundError(oid)
        size = onode["size"]
        if length < 0:
            length = max(0, size - offset)
        end = min(offset + length, size)
        if end <= offset:
            return b""
        au = self.alloc_unit
        out = bytearray(end - offset)
        for u in range(offset // au, (end - 1) // au + 1):
            phys = onode["extents"].get(u)
            if phys is None:
                continue  # hole or compressed blob (filled below)
            unit = self._dev_read(phys)
            lo = max(offset, u * au)
            hi = min(end, (u + 1) * au)
            out[lo - offset:hi - offset] = unit[lo - u * au:hi - u * au]
        for b0, blob in onode.get("cblobs", {}).items():
            blo, bhi = b0 * au, (b0 + blob["span"]) * au
            if bhi <= offset or blo >= end:
                continue
            data = self._read_blob(blob)  # one decompress per blob
            lo = max(offset, blo)
            hi = min(end, bhi)
            out[lo - offset:hi - offset] = \
                data[lo - blo:hi - blo].ljust(hi - lo, b"\x00")
        return bytes(out)

    def getattr(self, oid: str, name: str):
        onode = self._get_onode(oid)
        if onode is None:
            raise FileNotFoundError(oid)
        return onode["attrs"].get(name)

    def _omap_db_keys(self, oid: str) -> List[str]:
        prefix = oid + "\x00"
        return [
            k[len(prefix):]
            for k, _ in self.db.get_iterator("M")
            if k.startswith(prefix)
        ]

    def omap_get(self, oid: str, keys: Optional[List[str]] = None
                 ) -> Dict[str, bytes]:
        if self._get_onode(oid) is None:
            raise FileNotFoundError(oid)
        out = {}
        prefix = oid + "\x00"
        for k, v in self.db.get_iterator("M"):
            if k.startswith(prefix):
                name = k[len(prefix):]
                if keys is None or name in keys:
                    out[name] = v
        return out

    def stat(self, oid: str) -> int:
        onode = self._get_onode(oid)
        if onode is None:
            raise FileNotFoundError(oid)
        return onode["size"]

    def exists(self, oid: str) -> bool:
        return self._get_onode(oid) is not None

    def list_objects(self) -> List[str]:
        return sorted(k for k, _ in self.db.get_iterator("O"))

    # -- fault injection (store_test corrupt hook) -------------------------

    def corrupt(self, oid: str, offset: int) -> None:
        onode = self._get_onode(oid)
        if onode is None:
            raise FileNotFoundError(oid)
        au = self.alloc_unit
        u = offset // au
        phys = onode["extents"].get(u)
        if phys is None:
            # the unit may live in a compressed blob: flip a payload
            # byte so the blob csum (and hence the read) fails -- the
            # EIO surface scrub repairs from
            for b0, blob in onode.get("cblobs", {}).items():
                if b0 <= u < b0 + blob["span"]:
                    phys = blob["phys"][0]
                    break
            if phys is None:
                return
            pofs = phys * au
        else:
            pofs = phys * au + offset % au
        self._dev.seek(pofs)
        b = self._dev.read(1)
        self._dev.seek(pofs)
        self._dev.write(bytes([b[0] ^ 0xFF]))
        self._dev.flush()
