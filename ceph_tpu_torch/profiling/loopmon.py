"""Event-loop + GC arm: scheduler and collector time as cost centers.

Port of ``ceph_tpu/profiling/loopmon.py``; the port keeps its own copy
(its own globals), so a process that imports both packages does not cross-
feed them.

The stage ledger attributes the wire loop's DECLARED seams; this module
closes the residual: every asyncio callback's duration (the scheduler's
whole working set -- task steps, timer callbacks, reader wakeups), the
scheduling latency of timer callbacks (the sleep-drift signal
``LoopLagProbe`` used to sample with its own sleeper task), and GC
pauses via ``gc.callbacks``.

Instrumentation point: ``asyncio.events.Handle._run`` -- the one
choke point every callback of every pure-Python event loop passes
through.  The wrapper is installed class-wide while the monitor is
active and removed on uninstall, so the disabled state runs the stock
asyncio code with zero residue.  Per-callback cost while enabled: two
``perf_counter_ns`` reads, one isinstance check, slot arithmetic.

``LoopLagProbe`` (mgr/report.py) treats an active monitor as THE lag
source: its sampled-sleeper task is the fallback when profiling is off,
so a daemon never runs two lag estimators (the round-19 fold -- one lag
number feeds both the MgrReport ``lag_ms`` field and this ledger).

Callback top-K: resolving a callback's qualname per run would dominate
the callback itself, so names are resolved ONLY for callbacks slower
than ``TOPK_MIN_NS`` -- the slow tail is the actionable set anyway.
"""

from __future__ import annotations

import asyncio
import gc
import time
from typing import Dict, Optional

_now_ns = time.perf_counter_ns

#: callbacks faster than this never pay the name lookup (100us)
TOPK_MIN_NS = 100_000
#: hard bound on distinct top-K callback names retained
_TOPK_CAP = 256

_orig_handle_run = None
_installed: Optional["LoopMonitor"] = None


def active() -> Optional["LoopMonitor"]:
    """The installed monitor, or None (profiling off / loop arm off)."""
    return _installed


class LoopMonitor:
    """Process-wide asyncio + GC instrumentation (one per process;
    install()/uninstall() bracket the enabled window)."""

    def __init__(self, alpha: float = 0.25):
        self.alpha = alpha
        #: total ns spent INSIDE loop callbacks (the scheduler's whole
        #: execution share of wall time -- the coverage denominator's
        #: complement is selector idle)
        self.callback_ns = 0
        self.callbacks = 0
        #: EWMA of timer-callback scheduling latency (the LoopLagProbe
        #: semantics: how late a due callback actually ran), plus hwm
        self.lag_ms = 0.0
        self.lag_hwm_ms = 0.0
        self.timer_lags = 0
        #: scheduling-latency histogram (log2 usec buckets)
        from ceph_tpu_torch.utils.perf import HistogramAxis

        self._lag_axis = HistogramAxis("sched_lag_usec", 0, 64, 32, "log2")
        self.lag_counts = [0] * self._lag_axis.buckets
        #: slow-callback top-K: qualname -> [ns, calls]
        self.topk: Dict[str, list] = {}
        self.topk_overflow = 0
        #: GC pause accounting (gc.callbacks start/stop pairs)
        self.gc_ns = 0
        self.gc_collections = 0
        self.gc_pause_hwm_ns = 0
        self._gc_t0 = 0

    # -- the Handle._run wrapper -------------------------------------------

    def _timed_run(self, handle) -> None:
        t0 = _now_ns()
        if isinstance(handle, asyncio.TimerHandle):
            # scheduling latency: how far past its due time this timer
            # actually ran -- the event-loop stall signal
            try:
                lag_s = handle._loop.time() - handle._when
            except AttributeError:
                lag_s = 0.0
            if lag_s > 0:
                lag_ms = lag_s * 1e3
                self.lag_ms += self.alpha * (lag_ms - self.lag_ms)
                if lag_ms > self.lag_hwm_ms:
                    self.lag_hwm_ms = lag_ms
                self.lag_counts[
                    self._lag_axis.bucket_for(lag_s * 1e6)] += 1
                self.timer_lags += 1
        try:
            _orig_handle_run(handle)
        finally:
            dt = _now_ns() - t0
            self.callback_ns += dt
            self.callbacks += 1
            if dt >= TOPK_MIN_NS:
                self._note_slow(handle, dt)

    def _note_slow(self, handle, dt: int) -> None:
        cb = handle._callback
        name = getattr(cb, "__qualname__", None)
        if name is None:
            func = getattr(cb, "func", None)  # functools.partial
            name = getattr(func, "__qualname__", type(cb).__name__)
        row = self.topk.get(name)
        if row is None:
            if len(self.topk) >= _TOPK_CAP:
                self.topk_overflow += 1
                return
            row = self.topk[name] = [0, 0]
        row[0] += dt
        row[1] += 1

    # -- GC callbacks -------------------------------------------------------

    def _gc_cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t0 = _now_ns()
        elif phase == "stop" and self._gc_t0:
            dt = _now_ns() - self._gc_t0
            self._gc_t0 = 0
            self.gc_ns += dt
            self.gc_collections += 1
            if dt > self.gc_pause_hwm_ns:
                self.gc_pause_hwm_ns = dt
            # the pause ran inside whatever stage was open: credit it
            # out so stage time and gc time stay disjoint
            from ceph_tpu_torch.profiling import ledger

            ledger.gc_credit(dt)

    # -- lifecycle ----------------------------------------------------------

    def install(self) -> None:
        global _orig_handle_run, _installed
        if _installed is self:
            return
        if _installed is not None:
            _installed.uninstall()
        _orig_handle_run = asyncio.events.Handle._run
        monitor = self

        def _run(handle_self):
            monitor._timed_run(handle_self)

        asyncio.events.Handle._run = _run
        gc.callbacks.append(self._gc_cb)
        _installed = self

    def uninstall(self) -> None:
        global _orig_handle_run, _installed
        if _installed is not self:
            return
        if _orig_handle_run is not None:
            asyncio.events.Handle._run = _orig_handle_run
            _orig_handle_run = None
        try:
            gc.callbacks.remove(self._gc_cb)
        except ValueError:
            pass
        _installed = None

    # -- views --------------------------------------------------------------

    def lag_histogram(self) -> dict:
        return {
            "bounds_usec": self._lag_axis.upper_bounds(),
            "counts": list(self.lag_counts),
            "samples": self.timer_lags,
        }

    def top_callbacks(self, limit: int = 20) -> list:
        rows = sorted(self.topk.items(), key=lambda kv: -kv[1][0])
        return [{"callback": name, "ns": ns, "calls": calls}
                for name, (ns, calls) in rows[:limit]]

    def snapshot(self) -> dict:
        return {
            "callback_ns": self.callback_ns,
            "callbacks": self.callbacks,
            "lag_ms": round(self.lag_ms, 3),
            "lag_hwm_ms": round(self.lag_hwm_ms, 3),
            "sched_lag_histogram": self.lag_histogram(),
            "top_callbacks": self.top_callbacks(),
            "topk_overflow": self.topk_overflow,
            "gc_ns": self.gc_ns,
            "gc_collections": self.gc_collections,
            "gc_pause_hwm_ns": self.gc_pause_hwm_ns,
        }

    def reset(self) -> None:
        self.callback_ns = 0
        self.callbacks = 0
        self.lag_ms = 0.0
        self.lag_hwm_ms = 0.0
        self.timer_lags = 0
        for i in range(len(self.lag_counts)):
            self.lag_counts[i] = 0
        self.topk.clear()
        self.topk_overflow = 0
        self.gc_ns = 0
        self.gc_collections = 0
        self.gc_pause_hwm_ns = 0
