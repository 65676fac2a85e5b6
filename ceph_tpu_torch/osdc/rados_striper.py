"""libradosstriper: striped "files" over plain RADOS objects.

Port of ``ceph_tpu/osdc/rados_striper.py``: the same stripe objects
and ``striper.*`` omap values over the port's backend.

Reference: src/libradosstriper (2.8k LoC) -- a thin client library that
presents one logical byte range striped over ``<soid>.%016x`` objects.
The first object carries the authoritative metadata as xattrs
(striper.layout / striper.size in the reference; omap keys here, the
framework's xattr plane), guarded by a shared lock so concurrent
writers agree on the layout (RadosStriperImpl::createAndSetXattrs).

Surface mirrors the reference's C/C++ API: write (positional),
write_full, read, stat, truncate, remove, get/set xattr passthrough.
A writer extending the file updates the size metadata with CAS
semantics via omap so racing appends keep the max.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ceph_tpu_torch.osdc.striper import FileLayout, Striper
from ceph_tpu_torch.utils.encoding import Decoder, Encoder


def _enc(v) -> bytes:
    return Encoder().value(v).bytes()


def _dec(b):
    return Decoder(b).value() if b else None


class RadosStriper:
    """One striper handle per pool backend (RadosStriperImpl)."""

    def __init__(self, backend,
                 object_size: int = 1 << 22,
                 stripe_unit: int = 1 << 19,
                 stripe_count: int = 4):
        if object_size % stripe_unit:
            raise ValueError("object_size must be a stripe_unit multiple")
        self.backend = backend
        self.default_layout = FileLayout(
            object_size=object_size, stripe_unit=stripe_unit,
            stripe_count=stripe_count)

    @staticmethod
    def _obj(soid: str, object_no: int) -> str:
        # the reference names stripe objects "<soid>.%016x"
        return f"{soid}.{object_no:016x}"

    def _meta_oid(self, soid: str) -> str:
        return self._obj(soid, 0)

    # -- metadata ----------------------------------------------------------

    async def _load_meta(self, soid: str
                         ) -> Optional[Tuple[Striper, int]]:
        omap = await self.backend.omap_get(self._meta_oid(soid))
        raw = omap.get("striper.layout")
        if raw is None:
            return None
        lo = _dec(raw)
        layout = FileLayout(object_size=lo["object_size"],
                            stripe_unit=lo["stripe_unit"],
                            stripe_count=lo["stripe_count"])
        size = _dec(omap.get("striper.size")) or 0
        return Striper(layout), size

    _DIR_OID = "striper_directory"

    async def _ensure_meta(self, soid: str) -> Tuple[Striper, int]:
        meta = await self._load_meta(soid)
        if meta is not None:
            return meta
        lo = self.default_layout
        # create-exclusive CAS: racing first writers with different
        # default layouts must all end up striping under ONE layout
        # (the reference guards layout creation with its shared lock)
        ok, _cur = await self.backend.omap_cas(
            self._meta_oid(soid), "striper.layout", None,
            _enc({
                "object_size": lo.object_size,
                "stripe_unit": lo.stripe_unit,
                "stripe_count": lo.stripe_count,
            }))
        if not ok:
            meta = await self._load_meta(soid)
            if meta is not None:
                return meta  # the winner's layout governs
        # CAS size init too: a racing writer may already have grown it
        await self.backend.omap_cas(
            self._meta_oid(soid), "striper.size", None, _enc(0))
        await self.backend.omap_set(self._DIR_OID, {f"soid_{soid}": b"1"})
        return Striper(lo), 0

    async def _cas_max(self, soid: str, key: str, new_val: int) -> None:
        """CAS-retry a monotonically-growing integer omap field (the
        reference updates these xattrs under its shared lock; a plain
        read-check-write would let a smaller racing write persist a
        smaller value and logically truncate the file)."""
        for _ in range(16):
            raw = (await self.backend.omap_get(
                self._meta_oid(soid))).get(key)
            if (_dec(raw) or 0) >= new_val:
                return
            ok, _cur = await self.backend.omap_cas(
                self._meta_oid(soid), key, raw, _enc(new_val))
            if ok:
                return
        raise IOError(f"{key} update contended on {soid}")

    async def _grow_size(self, soid: str, new_size: int) -> None:
        await self._cas_max(soid, "striper.size", new_size)
        # maxsize never shrinks (truncate only zeroes): remove() uses it
        # to find every stripe object ever written
        await self._cas_max(soid, "striper.maxsize", new_size)

    # -- I/O ---------------------------------------------------------------

    async def write(self, soid: str, data: bytes, offset: int = 0) -> None:
        striper, _size = await self._ensure_meta(soid)
        pos = 0
        for object_no, obj_off, length in striper.map_extent(
                offset, len(data)):
            await self.backend.write_range(
                self._obj(soid, object_no), obj_off,
                data[pos:pos + length])
            pos += length
        await self._grow_size(soid, offset + len(data))

    async def write_full(self, soid: str, data: bytes) -> None:
        await self.remove(soid, missing_ok=True)
        await self.write(soid, data, 0)

    async def append(self, soid: str, data: bytes) -> None:
        _striper, size = await self._ensure_meta(soid)
        await self.write(soid, data, size)

    async def read(self, soid: str, length: Optional[int] = None,
                   offset: int = 0) -> bytes:
        meta = await self._load_meta(soid)
        if meta is None:
            raise FileNotFoundError(soid)
        striper, size = meta
        length = size - offset if length is None else \
            min(length, size - offset)
        if length <= 0:
            return b""
        out = bytearray(length)
        pos = 0
        for object_no, obj_off, take in striper.map_extent(offset, length):
            try:
                piece = await self.backend.read_range(
                    self._obj(soid, object_no), obj_off, take)
            except FileNotFoundError:
                piece = b""  # sparse stripe object reads as zeros
            # other IOErrors (e.g. degraded below k shards) propagate:
            # returning zeros there would hand the caller silent
            # corruption instead of an EIO
            out[pos:pos + len(piece)] = piece
            pos += take
        return bytes(out)

    async def stat(self, soid: str) -> int:
        meta = await self._load_meta(soid)
        if meta is None:
            raise FileNotFoundError(soid)
        return meta[1]

    async def truncate(self, soid: str, new_size: int) -> None:
        """Shrink (or sparse-extend) the logical file; whole stripe
        objects past the end are removed and the boundary object's tail
        zeroed, the reference's truncate behavior."""
        meta = await self._load_meta(soid)
        if meta is None:
            raise FileNotFoundError(soid)
        striper, size = meta
        if new_size < size:
            # zero the [new_size, size) range so a later regrow reads
            # zeros; removing whole objects needs per-object span math
            # (round-robin striping puts later bytes in EVERY object),
            # so zeroing is the simple correct form
            span = size - new_size
            zero = bytes(min(span, 1 << 20))
            off = new_size
            while off < size:
                chunk = min(len(zero), size - off)
                pos = 0
                for object_no, obj_off, length in striper.map_extent(
                        off, chunk):
                    await self.backend.write_range(
                        self._obj(soid, object_no), obj_off,
                        zero[pos:pos + length])
                    pos += length
                off += chunk
        await self.backend.omap_set(
            self._meta_oid(soid), {"striper.size": _enc(new_size)})

    async def remove(self, soid: str, missing_ok: bool = False) -> None:
        meta = await self._load_meta(soid)
        if meta is None:
            if missing_ok:
                return
            raise FileNotFoundError(soid)
        striper, size = meta
        # delete by the historical high-water size: a truncate-shrink
        # leaves whole stripe objects in place (it only zeroes), and
        # sizing by the current length would leak them forever
        maxsize = _dec((await self.backend.omap_get(
            self._meta_oid(soid))).get("striper.maxsize")) or size
        n_objects = max(1, striper.object_count(max(size, maxsize)))
        for object_no in range(n_objects):
            try:
                await self.backend.remove_object(self._obj(soid, object_no))
            except (FileNotFoundError, IOError):
                pass
        await self.backend.omap_rm(
            self._meta_oid(soid),
            ["striper.layout", "striper.size", "striper.maxsize"])
        await self.backend.omap_rm(self._DIR_OID, [f"soid_{soid}"])

    async def list_striped(self) -> List[str]:
        """Logical names present (directory-object index)."""
        try:
            omap = await self.backend.omap_get(self._DIR_OID)
        except (FileNotFoundError, IOError):
            return []
        return sorted(k[len("soid_"):] for k in omap
                      if k.startswith("soid_"))
