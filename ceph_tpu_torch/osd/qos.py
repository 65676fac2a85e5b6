"""Unified QoS admission: dmClock tags in front of the batched data plane.

Port of ``ceph_tpu/osd/qos.py``.

Rounds 6-15 built two uncoordinated control layers on the OSD: the
WPQ/mClock op queues (``osd/opqueue.py``) order sub-ops INTO the shard
worker, while the per-PG coalescer (``osd/coalescer.py``) and the
BackgroundThrottle decide which fused batches actually reach
the device -- so a dequeue was a QoS decision the batching layer then
ignored.  This module fuses them: the dmClock tag
scheduler becomes the coalescer's ADMISSION stage, so a dispatched
batch IS a QoS decision.

Model (docs/qos.md):

* Every batched dispatch -- a coalesced client encode/decode batch, a
  recovery gather/decode/push cycle, a scrub read round -- first claims
  one of ``osd_qos_slots`` admission slots under its op class
  (``client`` / ``recovery`` / ``scrub`` by default; the profile string
  can add client sub-classes).  Cost is the batch's STRIPE BYTES, and
  the per-class (reservation, weight, limit) triple from
  ``osd_qos_profile`` (MiB/s) spaces the dmClock tags.
* When slots are free and no limit binds, admission is work-conserving:
  a grant costs one tag update, no waiting, no task switch.  Under
  contention the freed slot goes to the eligible class by dmClock
  phase order -- reservation tags first (the floor), then spare
  capacity by proportional tag (weights), limit tags gating both.
* This REPLACES the BackgroundThrottle preemption gauge
  (``_client_ops_queued > 16`` + bounded backoff rounds): recovery is
  now just a class with a small weight, so it yields to client bursts
  by tag order but can never be starved (its proportional tag is always
  finite) -- the non-starvation property the gauge's MAX_PREEMPT_ROUNDS
  hack approximated.

Deadlock-freedom: a slot holder never waits on another class's grant --
slots are released by the dispatch that claimed them, grants wait only
on slot releases and the injected clock, and the coalescer's dispatch
functions never re-enter admission.  Time comes from ONE injected
monotonic clock (shared with ``MClockQueue``), so tag ordering survives
wall-clock regressions and tests can drive a virtual clock.
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable, Dict, Optional, Tuple

from ceph_tpu_torch.osd.opqueue import MClockQueue
from ceph_tpu_torch.utils.perf import PerfCounters

#: default per-class (reservation MiB/s, weight, limit MiB/s): client
#: traffic owns the weight, recovery holds a small reservation so a
#: rebuild always progresses (the data-loss window argument from round
#: 14), scrub trickles.  0 reservation/limit = none.
DEFAULT_PROFILE = "client:0:100:0,recovery:4:10:0,scrub:1:5:0"

_MIB = float(1 << 20)

#: process-wide fairness gauges (per class), set by the qos bench /
#: scenario runner and exposed by the prometheus mgr module as
#: ``ceph_qos_fairness_spread{qos_class=...}``: max/min achieved
#: per-client throughput within the class (1.0 = perfectly fair)
_fairness_spread: Dict[str, float] = {}


def set_fairness_spread(klass: str, spread: Optional[float]) -> None:
    if spread is None:
        _fairness_spread.pop(klass, None)
    else:
        _fairness_spread[klass] = float(spread)


def fairness_spreads() -> Dict[str, float]:
    return dict(_fairness_spread)


def parse_profile(text: Optional[str] = None
                  ) -> Dict[str, Tuple[float, float, float]]:
    """``osd_qos_profile`` -> {class: (res MiB/s, weight, lim MiB/s)}.

    Grammar: comma/space-separated ``name:res:weight:limit`` entries;
    malformed entries are skipped (config must never wedge a daemon)."""
    if text is None:
        from ceph_tpu_torch.utils.config import get_config

        text = str(get_config().get_val("osd_qos_profile")) or ""
    text = text.strip() or DEFAULT_PROFILE
    out: Dict[str, Tuple[float, float, float]] = {}
    for entry in text.replace(",", " ").split():
        parts = entry.split(":")
        if len(parts) != 4:
            continue
        name, res, wgt, lim = parts
        try:
            out[name] = (float(res), float(wgt), float(lim))
        except ValueError:
            continue
    return out or parse_profile(DEFAULT_PROFILE)


def profile_bytes_per_s(profile: Dict[str, Tuple[float, float, float]]
                        ) -> Dict[str, Tuple[float, float, float]]:
    """MiB/s rates -> bytes/s (the admission layer's cost unit)."""
    return {
        name: (res * _MIB, wgt, lim * _MIB)
        for name, (res, wgt, lim) in profile.items()
    }


class QoSAdmission:
    """dmClock slot admission for batched dispatches (one per OSDShard).

    ``slot(klass, cost_bytes)`` is an async context manager: entering
    claims an admission slot in dmClock tag order, exiting releases it.
    ``admit(klass, cost_bytes)`` is the transient form (claim + release
    immediately): pure ordering/pacing for stages whose occupancy is
    bounded elsewhere (the scrub chunk cursor).

    Not thread-safe; single event loop by construction (the OSD data
    path).  With ``schedule_timers=False`` (virtual-clock tests) the
    caller drives eligibility by calling :meth:`poll` after advancing
    the injected clock.
    """

    def __init__(self, *, slots: Optional[int] = None,
                 classes: Optional[Dict[str, tuple]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 perf: Optional[PerfCounters] = None,
                 perf_classes: Optional[set] = None,
                 schedule_timers: bool = True):
        if slots is None:
            from ceph_tpu_torch.utils.config import get_config

            slots = int(get_config().get_val("osd_qos_slots"))
        if classes is None:
            classes = profile_bytes_per_s(parse_profile())
        self.classes = dict(classes)
        self.slots = max(1, int(slots))
        self._free = self.slots
        self._clock = clock
        self._q = MClockQueue(self.classes, clock=clock)
        self.perf = perf
        #: classes whose grants land in the shared qos_<class>_* perf
        #: namespace (None = all): the op-level and batch-level
        #: instances on one shard share a PerfCounters, so each class
        #: is counted at exactly ONE layer (client classes per op,
        #: recovery/scrub per batch -- docs/qos.md)
        self.perf_classes = perf_classes
        self._timers = schedule_timers
        self._timer_handle = None
        #: per-class QoS-attributed admission-wait histograms (the
        #: per-stage discipline: prometheus _bucket/_sum/_count
        #: series named <daemon>.qos_wait_<class>_usec)
        self._wait_hist: Dict[str, object] = {}
        #: grants since construction, per class (introspection + tests)
        self.granted: Dict[str, int] = {}
        self.granted_bytes: Dict[str, int] = {}

    # -- introspection ------------------------------------------------------

    def status(self) -> dict:
        return {
            "slots": self.slots,
            "free": self._free,
            "queued": len(self._q),
            "classes": {k: list(v) for k, v in self.classes.items()},
            "granted": dict(self.granted),
            "granted_bytes": dict(self.granted_bytes),
        }

    # -- the admission surface ---------------------------------------------

    def slot(self, klass: str, cost_bytes: int) -> "_Slot":
        """Claim-one-slot context manager (batch dispatches)."""
        return _Slot(self, klass, cost_bytes)

    async def admit(self, klass: str, cost_bytes: int) -> None:
        """Transient admission: tag-ordered grant, slot returned at
        once (ordering + limit pacing without occupancy tracking)."""
        if await self.acquire(klass, cost_bytes):
            self.release_slot()

    async def acquire(self, klass: str, cost_bytes: int) -> bool:
        """Claim a slot under ``klass``; True iff a slot is actually
        held (an unregistered class is counted, never throttled, and
        owes no release) -- the token-free half of :meth:`slot` for
        callers like the BackgroundThrottle whose acquire and release
        sites are different methods."""
        await self._acquire(klass, cost_bytes)
        return klass in self.classes

    def release_slot(self) -> None:
        """Return a slot claimed by :meth:`acquire`."""
        self._release()

    async def _acquire(self, klass: str, cost_bytes: int) -> None:
        if klass not in self.classes:
            # unregistered class: counted, never throttled (the open
            # default -- QoS confines only what the profile names)
            self._count(klass, cost_bytes, waited=False)
            return
        loop = asyncio.get_event_loop()
        fut = loop.create_future()
        self._q.enqueue(klass, max(1, int(cost_bytes)), (fut, klass))
        self.poll()
        if fut.done():
            self._count(klass, cost_bytes, waited=False)
            return
        self._count(klass, cost_bytes, waited=True)
        t0 = self._clock()
        try:
            await fut
        except asyncio.CancelledError:
            # the waiter died before its grant: if the grant already
            # landed, hand the slot straight back (never leak one)
            if fut.done() and not fut.cancelled():
                self._release()
            raise
        if self._counted(klass) and self.perf is not None:
            waited_s = self._clock() - t0
            self.perf.tinc(f"qos_{klass}_wait", waited_s)
            hist = self._wait_hist.get(klass)
            if hist is None:
                from ceph_tpu_torch.utils.perf import stage_histogram

                hist = self._wait_hist[klass] = stage_histogram(
                    f"{self.perf.name}.qos_wait_{klass}_usec")
            hist.inc(waited_s * 1e6, cost_bytes)

    def _release(self) -> None:
        self._free += 1
        self.poll()

    def _counted(self, klass: str) -> bool:
        return self.perf_classes is None or klass in self.perf_classes

    def _count(self, klass: str, cost_bytes: int, waited: bool) -> None:
        self.granted[klass] = self.granted.get(klass, 0) + 1
        self.granted_bytes[klass] = \
            self.granted_bytes.get(klass, 0) + int(cost_bytes)
        if self.perf is not None and self._counted(klass):
            self.perf.inc(f"qos_{klass}_ops")
            self.perf.inc(f"qos_{klass}_bytes", int(cost_bytes))
            if waited:
                self.perf.inc(f"qos_{klass}_throttle_waits")

    # -- the grant pump -----------------------------------------------------

    def poll(self) -> int:
        """Grant eligible waiters into free slots (dmClock phase order);
        returns grants made.  Re-arms the idle timer for limit-blocked
        heads.  Safe to call any time (tests drive it manually after
        advancing a virtual clock)."""
        granted = 0
        while self._free > 0:
            item = self._q.dequeue()
            if item is None:
                break
            fut, _klass = item
            if fut.cancelled():
                continue
            self._free -= 1
            fut.set_result(None)
            granted += 1
        self._arm_timer()
        return granted

    def _arm_timer(self) -> None:
        if not self._timers:
            return
        if self._timer_handle is not None:
            self._timer_handle.cancel()
            self._timer_handle = None
        if self._free <= 0:
            return  # a release will pump; no clock wait is pending
        delay = self._q.idle_for()
        if delay is None or delay <= 0:
            return
        try:
            loop = asyncio.get_event_loop()
        except RuntimeError:
            return
        self._timer_handle = loop.call_later(delay, self._on_timer)

    def _on_timer(self) -> None:
        self._timer_handle = None
        self.poll()


class _Slot:
    """The ``async with admission.slot(...)`` guard."""

    __slots__ = ("_adm", "_klass", "_cost", "_held")

    def __init__(self, adm: QoSAdmission, klass: str, cost: int):
        self._adm = adm
        self._klass = klass
        self._cost = cost
        self._held = False

    async def __aenter__(self):
        # unregistered classes never take a slot; only a real grant
        # owes a release
        self._held = await self._adm.acquire(self._klass, self._cost)
        return self

    async def __aexit__(self, *exc):
        if self._held:
            self._held = False
            self._adm.release_slot()
        return False
