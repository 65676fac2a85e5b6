"""Storage engines (reference: src/os -- the ObjectStore layer).

Port of ``ceph_tpu/objectstore/__init__.py``.  ``ObjectStore.create``
(src/os/ObjectStore.cc:63) selects a backend by name.  The port has the
RAM engine only:

* ``memstore``  -- RAM, test-grade (src/os/memstore/MemStore.cc)

The JAX package's persistent engines (``filestore``, ``kstore``,
``blockstore``) are not ported yet (ROADMAP.md queue 1 item 11); asking
for one raises ``ValueError``.
"""

from __future__ import annotations

from ceph_tpu_torch.osd.memstore import MemStore
from ceph_tpu_torch.utils.unported import message

#: the JAX package's persistent engines, which the port does not have
UNPORTED = ("filestore", "kstore", "blockstore")


def create(kind: str, path: str = "", **kw):
    """``kind`` may carry a compression suffix in the JAX package
    ("blockstore:zlib"); only ``memstore`` is ported."""
    kind, _, _alg = kind.partition(":")
    if kind == "memstore":
        return MemStore()
    if kind in UNPORTED:
        raise ValueError(message(f"objectstore backend {kind!r}",
                                 "objectstore"))
    raise ValueError(f"unknown objectstore backend {kind!r}")


__all__ = ["create", "MemStore"]
