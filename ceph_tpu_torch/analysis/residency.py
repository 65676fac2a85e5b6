"""Counted host<->device transfer seams and the device-resident-section
verifier (port of ``ceph_tpu/analysis/residency.py``).

* **Counters** -- every transfer the storage layer performs goes through
  :func:`device_put` / :func:`device_get`, or through the direct
  :func:`note_h2d` / :func:`note_d2h` hooks at call sites that issue their
  own asynchronous copies (the pipeline's pinned staging).  They land in
  one process-wide ledger of h2d/d2h ops and bytes, which the benchmarks
  snapshot around a stage (:meth:`ResidencyCounters.delta`).
* **Sections** -- :func:`resident_section` is the runtime guard paired
  with the ``# cephlint: device-resident-section`` comment markers: with
  a verifier installed (:func:`install`), a seam D2H inside an open
  section is a violation, raised at the offending call (``raise`` mode)
  or appended to :attr:`ResidencyVerifier.violations` (``record`` mode).
  The reference also runs a raise-mode section body under JAX's
  device-to-host transfer guard; PyTorch has no such guard, so in the
  port the seams are the verifier.  No verifier is installed by default:
  a section then costs one attribute probe.

The reference also counts ``jit_retraces``: a JAX program is compiled
once per shape.  A CUDA library is built once per source, so the port
counts ``library_builds`` instead (:func:`note_library_build`, called
where a kernel library -- or the host crc32c library -- is built or first
loaded in the process): setup work that must not recur on a steady-state
hot path.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Dict, List, Optional

import numpy as np
import torch


class ResidencyCounters:
    """Process-wide transfer ledger (thread-safe)."""

    __slots__ = ("_lock", "h2d_ops", "h2d_bytes", "d2h_ops", "d2h_bytes",
                 "library_builds", "mesh_axes")

    def __init__(self):
        self._lock = threading.Lock()
        self.h2d_ops = 0
        self.h2d_bytes = 0
        self.d2h_ops = 0
        self.d2h_bytes = 0
        self.library_builds = 0
        #: per-mesh-axis sliced-dispatch accounting (the mesh data
        #: plane's slice of the ledger): axis name -> [dispatches,
        #: bytes placed along that axis].  Keyed dynamically so new
        #: axes (pg/shard/sub) need no schema change.
        self.mesh_axes: Dict[str, List[int]] = {}

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

    def note_mesh(self, axis: str, nbytes: int) -> None:
        """One sliced dispatch placing ``nbytes`` along mesh ``axis``
        (the mesh plane calls this per axis of every encode/decode
        dispatch, so "how much work rides each mesh axis" is a ledger
        number like the transfer counters)."""
        with self._lock:
            ent = self.mesh_axes.setdefault(axis, [0, 0])
            ent[0] += 1
            ent[1] += int(nbytes)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            out = {
                "h2d_ops": self.h2d_ops,
                "h2d_bytes": self.h2d_bytes,
                "d2h_ops": self.d2h_ops,
                "d2h_bytes": self.d2h_bytes,
                "library_builds": self.library_builds,
            }
            for axis, (ops, nbytes) in self.mesh_axes.items():
                out[f"mesh_{axis}_dispatches"] = ops
                out[f"mesh_{axis}_bytes"] = nbytes
            return out

    @staticmethod
    def delta(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
        return {k: after[k] - before.get(k, 0) for k in after}


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
    """Counted D2H seam: the sanctioned way the storage path pulls a
    tensor to a host numpy array (numpy arrays pass uncounted).  Inside
    an open resident section this is a violation (recorded or raised per
    the verifier mode)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    _note_d2h_checked(t.nbytes, "device_get")
    return t.detach().cpu().numpy()


def note_d2h(nbytes: int, what: str = "d2h") -> None:
    """Direct D2H accounting hook (asynchronous copies into pinned
    host buffers), section-checked like the seam."""
    _note_d2h_checked(nbytes, what)


def _note_d2h_checked(nbytes: int, what: str) -> None:
    _COUNTERS.note_d2h(nbytes)
    stack = getattr(_tls, "sections", None)
    if stack:
        verifier, name = stack[-1]
        verifier._on_violation(name, what, nbytes)


def note_library_build() -> None:
    """Count one library built or first loaded in this process."""
    _COUNTERS.note_library_build()


# -- the section verifier ---------------------------------------------------


class ResidencyViolation:
    """One observed D2H inside a declared device-resident section."""

    __slots__ = ("section", "what", "nbytes")

    def __init__(self, section: str, what: str, nbytes: int):
        self.section = section
        self.what = what
        self.nbytes = nbytes

    def __repr__(self) -> str:
        return (f"D2H transfer ({self.what}, {self.nbytes} bytes) inside "
                f"device-resident section {self.section!r}")


class ResidencySectionError(AssertionError):
    """Raised (raise mode) when a D2H lands inside a resident section."""


_tls = threading.local()


class ResidencyVerifier:
    """Section registry + the runtime guard modes.

    ``mode``: ``"record"`` -- seam violations are appended to
    :attr:`violations`; ``"raise"`` -- seam violations raise
    :class:`ResidencySectionError` at the offending call.
    """

    def __init__(self, mode: str = "raise"):
        if mode not in ("record", "raise"):
            raise ValueError(f"residency verifier mode {mode!r}")
        self.mode = mode
        self.violations: List[ResidencyViolation] = []
        #: section names entered at least once (observability)
        self.sections_entered: Dict[str, int] = {}

    def _on_violation(self, section: str, what: str, nbytes: int) -> None:
        v = ResidencyViolation(section, what, nbytes)
        self.violations.append(v)
        if self.mode == "raise":
            raise ResidencySectionError(repr(v))

    @contextlib.contextmanager
    def section(self, name: str):
        stack = getattr(_tls, "sections", None)
        if stack is None:
            stack = _tls.sections = []
        stack.append((self, name))
        self.sections_entered[name] = self.sections_entered.get(name, 0) + 1
        try:
            yield
        finally:
            stack.pop()

    def status(self) -> dict:
        return {
            "mode": self.mode,
            "sections_entered": dict(self.sections_entered),
            "violations": [repr(v) for v in self.violations],
        }


#: process-global verifier; tests that provoke violations on purpose
#: build private instances instead
_GLOBAL: Optional[ResidencyVerifier] = None


def install(mode: str = "raise") -> ResidencyVerifier:
    """Install the global verifier (idempotent per process)."""
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = ResidencyVerifier(mode)
    return _GLOBAL


#: the ``residency_verify`` option's environment layer
MODE_ENV = "CEPH_TPU_TORCH_RESIDENCY_VERIFY"


def mode_from_env() -> Optional[str]:
    """The verifier mode the test suite installs: ``"raise"`` (the
    default), ``"record"``, or None when ``CEPH_TPU_TORCH_RESIDENCY_VERIFY``
    is ``0``/``off``."""
    value = os.environ.get(MODE_ENV, "1")
    if value in ("0", "off"):
        return None
    return "record" if value == "record" else "raise"


def global_verifier() -> Optional[ResidencyVerifier]:
    return _GLOBAL


def violations() -> List[ResidencyViolation]:
    return list(_GLOBAL.violations) if _GLOBAL is not None else []


@contextlib.contextmanager
def resident_section(name: str):
    """The runtime guard paired with a ``# cephlint:
    device-resident-section <name>`` comment region.  A no-op when no
    verifier is installed (the default), so the hot path pays one
    attribute probe when the machinery is off."""
    v = _GLOBAL
    if v is None:
        yield
        return
    with v.section(name):
        yield


def status() -> dict:
    """Admin-socket ``residency status`` payload: the ledger plus the
    verifier state."""
    out: dict = {"counters": _COUNTERS.snapshot()}
    if _GLOBAL is not None:
        out.update(_GLOBAL.status())
    else:
        out.update({"mode": "off", "sections_entered": {},
                    "violations": []})
    return out
