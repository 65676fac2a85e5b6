"""Counted host<->device transfer seams (port of the counter half of
``ceph_tpu/analysis/residency.py``).

Every transfer the codec stack performs goes through :func:`device_put`
/ :func:`device_get`, or through the direct :func:`note_h2d` /
:func:`note_d2h` hooks at call sites that issue their own asynchronous
copies (the pipeline's pinned staging).  They land in one process-wide
ledger of h2d/d2h ops and bytes, which the benchmark snapshots around
a stage.  The reference's device-resident-section verifier and lint
wait for a later slice.

The reference also counts ``jit_retraces``: a JAX program is compiled
once per shape.  A CUDA library is built once per source, so the port
counts ``library_builds`` instead (:func:`note_library_build`, called
where a kernel library -- or the host crc32c library -- is built or first
loaded in the process): setup work that must not recur on a steady-state
hot path.
"""

from __future__ import annotations

import threading
from typing import Dict

import numpy as np
import torch


class ResidencyCounters:
    """Process-wide transfer ledger (thread-safe)."""

    __slots__ = ("_lock", "h2d_ops", "h2d_bytes", "d2h_ops", "d2h_bytes",
                 "library_builds")

    def __init__(self):
        self._lock = threading.Lock()
        self.h2d_ops = 0
        self.h2d_bytes = 0
        self.d2h_ops = 0
        self.d2h_bytes = 0
        self.library_builds = 0

    def note_h2d(self, nbytes: int) -> None:
        with self._lock:
            self.h2d_ops += 1
            self.h2d_bytes += int(nbytes)

    def note_d2h(self, nbytes: int) -> None:
        with self._lock:
            self.d2h_ops += 1
            self.d2h_bytes += int(nbytes)

    def note_library_build(self) -> None:
        with self._lock:
            self.library_builds += 1

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "h2d_ops": self.h2d_ops,
                "h2d_bytes": self.h2d_bytes,
                "d2h_ops": self.d2h_ops,
                "d2h_bytes": self.d2h_bytes,
                "library_builds": self.library_builds,
            }


_COUNTERS = ResidencyCounters()


def counters() -> ResidencyCounters:
    """The process ledger."""
    return _COUNTERS


def device_put(arr, device: torch.device) -> torch.Tensor:
    """Counted H2D seam: a numpy array or host tensor onto ``device``."""
    t = arr if isinstance(arr, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(arr))
    out = t.to(device)
    _COUNTERS.note_h2d(t.nbytes)
    return out


def note_h2d(nbytes: int) -> None:
    """Direct H2D accounting hook for call sites that issue their own
    (asynchronous) upload."""
    _COUNTERS.note_h2d(nbytes)


def device_get(t) -> np.ndarray:
    """Counted D2H seam: the sanctioned way the codec stack pulls a
    tensor to a host numpy array (numpy arrays pass uncounted)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    _COUNTERS.note_d2h(t.nbytes)
    return t.detach().cpu().numpy()


def note_d2h(nbytes: int) -> None:
    """Direct D2H accounting hook (asynchronous copies into pinned
    host buffers)."""
    _COUNTERS.note_d2h(nbytes)



def note_library_build() -> None:
    """Count one library built or first loaded in this process."""
    _COUNTERS.note_library_build()
