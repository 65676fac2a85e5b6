"""Server-side object classes (reference: src/cls + src/osd/ClassHandler).

Port of ``ceph_tpu/cls/__init__.py``: the same registry, context and
return codes.  Methods are host code; the bytes they read or write go
through the pool's codec like any client op.

The reference dlopens ``libcls_*.so`` plugins into the OSD; RADOS clients
invoke their methods with ``exec(oid, cls, method, input)`` and methods
mutate the object atomically on the primary.  Here the registry lives in
the primary EC engine (which is where our primary logic runs); methods
get a context exposing the object surface (read/stat/omap/xattr) and the
``omap_cas`` primitive served by the primary-shard OSD for atomic
read-modify-write.

Registering a class:

    @register("lock", "lock")
    async def lock(ctx, inp): ...

Method input/output are bytes (the reference's bufferlist in/out); the
encoding framework's tagged values are the usual payload format.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

#: (cls, method) -> coroutine fn(ctx, input bytes) -> (int ret, bytes out)
_METHODS: Dict[Tuple[str, str], Callable] = {}


def register(cls: str, method: str):
    def deco(fn):
        _METHODS[(cls, method)] = fn
        return fn
    return deco


def list_methods():
    return sorted(_METHODS)


class ClsContext:
    """What a method may touch -- the cls_cxx_* surface."""

    def __init__(self, backend, oid: str):
        self.backend = backend
        self.oid = oid

    async def read(self) -> bytes:
        return await self.backend.read(self.oid)

    async def stat(self) -> int:
        size, _ = await self.backend._stat(self.oid)
        return size

    async def write_full(self, data: bytes) -> None:
        await self.backend.write(self.oid, data)

    async def omap_get(self, keys=None):
        return await self.backend.omap_get(self.oid, keys)

    async def omap_set(self, kvs) -> None:
        await self.backend.omap_set(self.oid, kvs)

    async def omap_rm(self, keys) -> None:
        await self.backend.omap_rm(self.oid, keys)

    async def omap_cas(self, key, expect, new):
        return await self.backend.omap_cas(self.oid, key, expect, new)


async def call_method(backend, oid: str, cls: str, method: str,
                      inp: bytes) -> Tuple[int, bytes]:
    fn = _METHODS.get((cls, method))
    if fn is None:
        return -8, b""  # -ENOEXEC: unknown class/method (reference rc)
    ctx = ClsContext(backend, oid)
    return await fn(ctx, inp)


# importing the package loads the in-tree classes (the reference preloads
# via osd_class_load_list)
from ceph_tpu_torch.cls import cls_lock, cls_rbd, cls_version  # noqa: E402,F401
