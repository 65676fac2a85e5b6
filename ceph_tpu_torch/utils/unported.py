"""Refusals of the paths whose JAX-package module the port has not copied.

A port module keeps the reference's code paths, but a path that needs a
module of ``ceph_tpu/`` that ``ceph_tpu_torch/`` does not have yet raises
at once, naming the missing module and the ROADMAP.md queue item that
ports it.  It never falls back to another path.
"""

from __future__ import annotations

from typing import NoReturn

#: missing module -> (what it is, ROADMAP.md queue 1 item that ports it)
MISSING = {
    "native": ("ceph_tpu/ops/native_engine.py and ceph_tpu/native/ "
               "(the native engine and plugin loading)", 6),
    "mesh": ("ceph_tpu/parallel/mesh_plane.py (the mesh data plane)", 7),
    "replicated": ("ceph_tpu/osd/replicated.py (replicated pools)", 10),
    "objectstore": ("ceph_tpu/objectstore/ persistent engines", 11),
    "mon": ("ceph_tpu/mon/ (the monitor quorum)", 12),
    "auth": ("ceph_tpu/auth/ (OSD caps)", 13),
    "cls": ("ceph_tpu/cls/ (object classes)", 14),
    "mgr": ("ceph_tpu/mgr/ (the manager's report schema)", 15),
}


class NotPortedError(NotImplementedError):
    """A path that needs a JAX-package module the port does not have."""


def message(path: str, key: str) -> str:
    module, item = MISSING[key]
    return (f"{path} needs {module}, which ceph_tpu_torch does not port "
            f"yet (ROADMAP.md queue 1 item {item})")


def refuse(path: str, key: str) -> NoReturn:
    raise NotPortedError(message(path, key))
