"""The stage cost ledger: exclusive-time cost centers for the wire loop.

Port of ``ceph_tpu/profiling/ledger.py``; the port keeps its own copy (its
own globals), so a process that imports both packages does not cross-feed
them.

The wire loop's host cost is decomposed into NAMED costs here; this
ledger is the attribution substrate.  The discipline is
the one PAPERS "Accelerating XOR-based Erasure Coding using Program
Optimization Techniques" applied to the coding loop: measure the loop's
schedule first, then re-arrange it.

Design constraints (all load-bearing):

* **Markers are cached and reusable.**  ``stage(name)`` returns ONE
  marker per name for the process lifetime; instrumented modules fetch
  their markers at import time, so the per-frame cost is the ``with``
  protocol on a preallocated object -- no dict lookup, no allocation
  on the hot path.  The marker is ``_wire_native.Stage`` (C: two
  ``clock_gettime`` reads + struct-field math) when the native wire codec
  is loaded (both its gates on at import; a failed build raises), and
  the pure-Python :class:`StageMarker` twin otherwise -- identical
  semantics, selected once at import.
* **Off is (allocation-)free.**  Disabled markers take one global-bool
  branch in ``__enter__``/``__exit__`` and allocate NOTHING -- the
  wire-tax bench's off-mode pin (``profiling/wire_tax_bench.py``)
  asserts a zero ``sys.getallocatedblocks`` delta across thousands of
  enter/exit cycles on every run.
* **Exclusive time.**  Stages nest (``wire.crc32c`` runs inside
  ``wire.crc_seal``); on child entry the parent's elapsed-so-far is
  banked and its clock pauses, so every nanosecond lands in exactly one
  stage and the decomposition sums without double counting.  Markers
  are NOT re-entrant (a stage nested inside itself would clobber the
  start stamp) and must never span an ``await`` -- a suspended stage
  would bill other tasks' work to itself.  The cephlint rule
  ``profile-stage-unpaired`` guards the paired-call form; the seams use
  yield-free blocks by construction.
* **Single event-loop thread.**  The wire loop is asyncio-single-
  threaded; the ledger inherits that and takes no locks on the hot
  path.  ``snapshot()`` reads are torn-tolerant (counters only grow).

Per-connection per-burst sub-accounting rides the same ledger:
``note_burst(node, frames, nbytes, ns)`` feeds a per-peer table and an
ns/frame histogram (the existing :class:`HistogramAxis` bucketing), so
the decomposition can say not just "writelines cost X" but "at N
frames/burst and P50/P99 ns/frame".
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ceph_tpu_torch.utils.perf import HistogramAxis

_now_ns = time.perf_counter_ns

#: master switch, flipped only by profiling.configure(); module-global
#: so marker enter/exit pay one LOAD_GLOBAL + branch when off
_enabled = False

#: innermost active stage marker of the event-loop thread (exclusive
#: accounting + the sampler's attribution read; None between stages)
_current: Optional["StageMarker"] = None

#: name -> StageMarker (process-wide; markers live forever)
_markers: Dict[str, "StageMarker"] = {}

#: per-peer-node burst table: node -> [bursts, frames, bytes, ns]
_bursts: Dict[str, List[int]] = {}

#: ns-per-frame histogram axis: log2 buckets from 256ns up (~2^40ns
#: overflow bucket) -- the burst sub-accounting percentile source
_NSF_AXIS = HistogramAxis("ns_per_frame", 0, 256, 40, "log2")
_nsf_counts = [0] * _NSF_AXIS.buckets
_nsf_sum = 0
_nsf_n = 0


class StageMarker:
    """One named cost center; use as ``with stage("wire.encode"):``.

    ``ns``/``calls``/``nbytes`` accumulate for the process lifetime
    (reset() zeroes them).  ``add_bytes`` attributes payload bytes to
    the stage (callers pass what they already know -- no len() walks).
    """

    __slots__ = ("name", "ns", "calls", "nbytes", "_t0", "_parent")

    def __init__(self, name: str):
        self.name = name
        self.ns = 0
        self.calls = 0
        self.nbytes = 0
        self._t0 = 0
        self._parent: Optional["StageMarker"] = None

    def __enter__(self):
        if not _enabled:
            return self
        global _current
        now = _now_ns()
        parent = _current
        if parent is not None:
            # bank the parent's elapsed and pause its clock: exclusive
            # time, every nanosecond in exactly one stage
            parent.ns += now - parent._t0
        self._parent = parent
        self._t0 = now
        _current = self
        return self

    def __exit__(self, *exc):
        if not _enabled:
            return False
        global _current
        now = _now_ns()
        self.ns += now - self._t0
        self.calls += 1
        parent = self._parent
        _current = parent
        if parent is not None:
            parent._t0 = now  # restart the parent's exclusive clock
        return False

    def add_bytes(self, n: int) -> None:
        if _enabled:
            self.nbytes += n


#: the marker hot path in C with the native wire extension
#: (_wire_native.Stage -- identical exclusive-time semantics at
#: clock_gettime cost).  Selected ONCE at profiler import: against the
#: native codec's wire wall the Python markers' ~0.6us/pair is a >3%
#: enabled overhead, failing the wire-tax stage's own gate.  Python
#: markers carry the ledger where a gate (``native``,
#: ``osd_wire_codec_native``) is off at import; reset()/snapshot()/
#: gc_credit speak to both through the same attribute surface.
from ceph_tpu_torch.native import wire_codec as _wire_codec  # noqa: E402

_native_stages = _wire_codec.native()


def stage(name: str) -> StageMarker:
    """The process-wide marker for ``name`` (created on first use;
    instrumented modules call this once at import)."""
    m = _markers.get(name)
    if m is None:
        impl = StageMarker if _native_stages is None \
            else _native_stages.Stage
        m = _markers[name] = impl(name)
    return m


def marker_class() -> type:
    """The class of this process's markers (C or Python)."""
    return StageMarker if _native_stages is None else _native_stages.Stage


# -- the paired-call form ----------------------------------------------------
#
# For seams where a `with` block cannot bracket the work (a dispatch
# whose result may be a coroutine that must be awaited OUTSIDE the
# stage), `stage_enter(marker)`/`stage_exit(marker)` are the explicit
# pair.  Every enter MUST reach an exit on every control-flow path --
# the cephlint rule `profile-stage-unpaired` walks the CFG for exactly
# this contract.

def stage_enter(marker: StageMarker) -> StageMarker:
    return marker.__enter__()


def stage_exit(marker: StageMarker) -> None:
    marker.__exit__(None, None, None)


def gc_credit(ns: int) -> None:
    """Credit a GC pause OUT of the stage it interrupted: the stage's
    clock ran through the collector, so pushing its start stamp forward
    by the pause keeps stage time and gc time disjoint (the
    decomposition sums without double counting)."""
    if _native_stages is not None:
        _native_stages.stage_gc_credit(ns)
        return
    cur = _current
    if cur is not None:
        cur._t0 += ns


def current_stage_name() -> Optional[str]:
    """The innermost active stage (the sampler's attribution read;
    racy by design -- a sample is a sample)."""
    if _native_stages is not None:
        return _native_stages.stage_current_name()
    cur = _current
    return cur.name if cur is not None else None


# -- burst sub-accounting ----------------------------------------------------

def note_burst(node: str, frames: int, nbytes: int, ns: int) -> None:
    """One corked flush burst to ``node``: frames/bytes/ns roll into the
    per-connection table and the ns/frame histogram."""
    if not _enabled or not frames:
        return
    row = _bursts.get(node)
    if row is None:
        row = _bursts[node] = [0, 0, 0, 0]
    row[0] += 1
    row[1] += frames
    row[2] += nbytes
    row[3] += ns
    global _nsf_sum, _nsf_n
    per = ns // frames
    _nsf_counts[_NSF_AXIS.bucket_for(per)] += 1
    _nsf_sum += per
    _nsf_n += 1


def _nsf_percentile(p: float) -> Optional[int]:
    """Inclusive upper bound of the bucket holding the p-quantile
    ns/frame observation (None with no data)."""
    total = _nsf_n
    if not total:
        return None
    want = p * total
    bounds = _NSF_AXIS.upper_bounds()
    cum = 0
    for b, count in enumerate(_nsf_counts):
        cum += count
        if cum >= want:
            return bounds[b] if b < len(bounds) else bounds[-1] * 2
    return bounds[-1] * 2


# -- views -------------------------------------------------------------------

def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    """Flip the master switch (profiling.configure() is the public
    surface).  Turning off mid-stage abandons the open stage's tail --
    acceptable: enable/disable are test/bench boundaries, not hot ops."""
    global _enabled, _current
    _enabled = bool(on)
    if not on:
        _current = None
    if _native_stages is not None:
        _native_stages.stage_set_enabled(_enabled)


def stages_snapshot() -> Dict[str, dict]:
    """Per-stage accumulators (ns exclusive, calls, bytes)."""
    return {
        name: {"ns": m.ns, "calls": m.calls, "bytes": m.nbytes}
        for name, m in sorted(_markers.items())
        if m.calls or m.ns
    }


def bursts_snapshot() -> dict:
    """Per-connection burst table + ns/frame percentiles."""
    by_conn = {}
    for node, (bursts, frames, nbytes, ns) in sorted(_bursts.items()):
        by_conn[node] = {
            "bursts": bursts,
            "frames": frames,
            "bytes": nbytes,
            "ns": ns,
            "frames_per_burst": round(frames / bursts, 2) if bursts else 0,
            "bytes_per_burst": round(nbytes / bursts, 1) if bursts else 0,
        }
    return {
        "by_connection": by_conn,
        "ns_per_frame_p50": _nsf_percentile(0.50),
        "ns_per_frame_p99": _nsf_percentile(0.99),
        "frames_observed": _nsf_n,
        "ns_per_frame_mean": round(_nsf_sum / _nsf_n) if _nsf_n else None,
    }


def reset() -> None:
    global _nsf_sum, _nsf_n, _current
    for m in _markers.values():
        m.ns = 0
        m.calls = 0
        m.nbytes = 0
    _bursts.clear()
    for i in range(len(_nsf_counts)):
        _nsf_counts[i] = 0
    _nsf_sum = 0
    _nsf_n = 0
    _current = None
