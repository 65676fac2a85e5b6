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
    "mesh": ("ceph_tpu/parallel/mesh_plane.py (the mesh data plane)", 7),
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
