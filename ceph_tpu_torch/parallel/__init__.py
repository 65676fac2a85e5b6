"""Multi-device (mesh) erasure coding: the sliced codec and the OSD data
plane built on it (port of ``ceph_tpu/parallel/``).

* ``distributed`` -- :class:`DistributedCodec`: a w=8 matrix code over a
  ``(data, shard, sub)`` grid of devices, each cell running the
  ``gf2_matrix_w8`` kernel on its slice and the partial parities
  XOR-reduced over the shard axis (device-to-device copies).
* ``mesh_plane`` -- :class:`MeshDataPlane`: PG-slice ownership over the
  device list, the coalescer's sliced encode dispatch, and the delivery
  board (``osd_mesh_data_plane``).

One process drives every device, as the JAX package's single-process
``jax.devices()`` mesh does: each slot of the device list gets its own
CUDA stream, so a list may name one card several times
(:func:`configure_devices`), the counterpart of the JAX package's virtual
CPU devices.  There is no CPU fallback: the CPU runs only when the caller
names CPU devices.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Sequence

import torch

_lock = threading.Lock()
#: the process device list set by :func:`configure_devices` (None: every
#: card the process sees)
_override: Optional[List[torch.device]] = None


def configure_devices(devices: Optional[Sequence] = None) -> None:
    """Set the list :func:`local_devices` returns, e.g. ``[cpu] * 8`` on
    the CPU or ``[cuda:0] * 4`` on one card; a device may repeat.  None
    goes back to every card the process sees."""
    global _override
    with _lock:
        if devices is None:
            _override = None
            return
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("configure_devices needs at least one device")
        for d in devs:
            if d.type not in ("cpu", "cuda"):
                raise ValueError(f"unsupported device {d}")
            if d.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("CUDA is not available; name CPU "
                                   "devices to run on the CPU")
        if len({d.type for d in devs}) > 1:
            raise ValueError("a device list is all CPU or all CUDA")
        _override = [torch.device("cuda", d.index or 0)
                     if d.type == "cuda" else d for d in devs]


def local_devices() -> List[torch.device]:
    """The devices a mesh spans (the counterpart of ``jax.devices()``):
    the list :func:`configure_devices` set, else every ``cuda:i`` the
    process sees.  Raises without CUDA and without a list."""
    with _lock:
        if _override is not None:
            return list(_override)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; configure_devices([torch.device('cpu')]"
            " * n) runs the mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def new_stream(device: torch.device):
    """A fresh CUDA stream on ``device`` (one per mesh slot), None on the
    CPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.Stream(device=device)


def on_stream(stream):
    """Make ``stream`` current on its device (a no-op for None)."""
    return torch.cuda.stream(stream) if stream is not None \
        else contextlib.nullcontext()


def record(stream):
    """An event recorded on ``stream`` (None on the CPU)."""
    if stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def wait_current(devices, streams) -> None:
    """Each slot stream waits for what its device's current stream has
    queued (uploads made before the slots launch)."""
    for dev, st in zip(devices, streams):
        if st is not None:
            st.wait_stream(torch.cuda.current_stream(dev))


def synchronize(devices) -> None:
    """Wait for every stream of every CUDA device in ``devices`` (each
    once): a dispatch's results are then safe to read from any stream
    or the host, and its temporaries safe to free."""
    for dev in dict.fromkeys(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
