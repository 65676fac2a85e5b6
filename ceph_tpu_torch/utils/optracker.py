"""In-flight + historic op tracking (OpTracker/TrackedOp equivalent).

Port of ``ceph_tpu/utils/optracker.py``.

Reference: src/common/TrackedOp.{h,cc} and the OSD admin-socket commands
``dump_ops_in_flight`` / ``dump_historic_ops`` /
``dump_historic_slow_ops`` (src/osd/OSD.cc:2188-2222).  Each tracked op
records a timestamped event timeline (queued, dequeued, sub-op sent,
commit...); completed ops roll into a bounded historic ring kept by
slowest-first so the worst ops survive.

A TrackedOp carries a trace span (utils/trace.py): its
events ARE the span's timeline, so ``dump_historic_ops`` returns the
same decomposed queue-wait / batch-encode (amortized) / wire / ack /
commit segments the trace collector stitches across daemons.  Ops
slower than ``osd_op_complaint_time`` log a slow-op warning WITH that
decomposition (the "where did this one op spend its time" forensic the
aggregate bench numbers cannot answer) and are counted + retained for
``dump_historic_slow_ops``.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ceph_tpu_torch.utils import trace

log = logging.getLogger("ceph_tpu_torch.optracker")


def _cfg_val(name: str, default):
    try:
        from ceph_tpu_torch.utils.config import get_config

        return get_config().get_val(name)
    except Exception:  # noqa: BLE001 -- tracking must never fail an op
        return default


class TrackedOp:
    def __init__(self, tracker: "OpTracker", opid: int, desc: str,
                 span=None, t0: Optional[float] = None):
        self._tracker = tracker
        self.opid = opid
        self.desc = desc
        #: wall clock for display only; durations/ranking use monotonic so
        #: an NTP step cannot produce negative ages or mis-rank slow ops.
        #: ``t0`` backdates initiation to queue entry (queue wait is part
        #: of the op's life without allocating a TrackedOp per enqueue)
        self.initiated_at = time.time()
        self._t0 = t0 if t0 is not None else time.monotonic()
        self.events: List[tuple] = [(0.0, "initiated")]
        self.finished_at: Optional[float] = None
        self._t_end: Optional[float] = None
        #: the op's trace span (trace.NULL_SPAN when unsampled): events
        #: mirror into it so the span timeline IS the op timeline
        self.span = span if span is not None else trace.NULL_SPAN

    def mark_event(self, name: str, t: Optional[float] = None) -> None:
        """Timestamped event; ``t`` backdates (a monotonic stamp taken
        before this op object existed, e.g. queue entry)."""
        stamp = t if t is not None else time.monotonic()
        self.events.append((stamp - self._t0, name))
        self.span.event(name, t=stamp)

    def finish(self) -> None:
        if self.finished_at is None:
            self.finished_at = time.time()
            self._t_end = time.monotonic()
            self.events.append((self._t_end - self._t0, "done"))
            self.span.finish()
            self._tracker._finish(self)

    @property
    def duration(self) -> float:
        end = self._t_end if self._t_end is not None else time.monotonic()
        return end - self._t0

    def timeline(self) -> dict:
        """Decomposed per-stage latency segments (trace.op_timeline on
        the span when sampled, raw event deltas otherwise) -- segments
        sum to the op's end-to-end duration by construction."""
        if self.span.sampled:
            return trace.op_timeline(self.span)
        total = self.duration
        points = sorted(self.events) + [(total, "end")]
        segments = []
        for (t0, a), (t1, b) in zip(points, points[1:]):
            ms = max(0.0, (t1 - t0) * 1000)
            if ms > 0:
                segments.append(
                    {"segment": f"{a}->{b}", "ms": round(ms, 6)})
        return {"total_ms": round(total * 1000, 6), "segments": segments}

    def to_dict(self) -> dict:
        out = {
            "opid": self.opid,
            "description": self.desc,
            "initiated_at": self.initiated_at,
            "age": self.duration,
            "type_data": {
                "events": [
                    {"time": self.initiated_at + t, "event": name}
                    for t, name in self.events
                ]
            },
        }
        if self.span.sampled:
            out["trace_id"] = self.span.trace_id
            out["span_id"] = self.span.span_id
            out["timeline"] = self.timeline()
        return out


class OpTracker:
    def __init__(self, history_size: Optional[int] = None,
                 history_slow_size: Optional[int] = None, perf=None,
                 name: str = ""):
        if history_size is None:
            history_size = int(_cfg_val("osd_op_history_size", 20))
        if history_slow_size is None:
            history_slow_size = int(
                _cfg_val("osd_op_history_slow_size", 20))
        self._lock = threading.Lock()
        self._next_id = 0
        self._inflight: Dict[int, TrackedOp] = {}
        self._historic: deque = deque(maxlen=history_size)
        #: slowest completed ops, kept sorted by duration
        self._slowest: List[TrackedOp] = []
        self.history_slow_size = history_slow_size
        #: optional PerfCounters for the slow_ops counter
        self.perf = perf
        self.name = name
        self.slow_ops = 0

    def create_request(self, desc: str, span=None,
                       t0: Optional[float] = None) -> TrackedOp:
        with self._lock:
            self._next_id += 1
            op = TrackedOp(self, self._next_id, desc, span=span, t0=t0)
            self._inflight[op.opid] = op
            return op

    def complaint_time(self) -> float:
        return float(_cfg_val("osd_op_complaint_time", 5.0))

    def _finish(self, op: TrackedOp) -> None:
        with self._lock:
            self._inflight.pop(op.opid, None)
            self._historic.append(op)
            slowest = self._slowest
            # only contenders pay the sort (most finishes are fast ops
            # below the retained floor -- this runs per op)
            if len(slowest) < self.history_slow_size or \
                    op.duration > slowest[-1].duration:
                slowest.append(op)
                slowest.sort(key=lambda o: -o.duration)
                del slowest[self.history_slow_size :]
        complaint = self.complaint_time()
        if complaint > 0 and op.duration >= complaint:
            self._note_slow(op, complaint)

    def _note_slow(self, op: TrackedOp, complaint: float) -> None:
        """Slow-op forensics: count it and log the full decomposed
        timeline (the reference's cluster-log 'slow request' complaint,
        upgraded with per-stage attribution)."""
        self.slow_ops += 1
        if self.perf is not None:
            self.perf.inc("slow_ops")
        tl = op.timeline()
        segs = ", ".join(
            f"{s['segment']}={s['ms']:.1f}ms" for s in tl.get(
                "segments", []))
        log.warning(
            "slow op%s: %s took %.3fs (complaint %.3fs): %s",
            f" [{self.name}]" if self.name else "", op.desc,
            op.duration, complaint, segs or "no timeline recorded",
        )

    def num_inflight(self) -> int:
        """In-flight op count without rendering op dicts (the per-report
        gauge: dump_ops_in_flight builds a full description per op)."""
        with self._lock:
            return len(self._inflight)

    def dump_ops_in_flight(self) -> dict:
        with self._lock:
            ops = [op.to_dict() for op in self._inflight.values()]
        return {"num_ops": len(ops), "ops": ops}

    def dump_historic_ops(self) -> dict:
        with self._lock:
            ops = [op.to_dict() for op in self._historic]
        return {"num_ops": len(ops), "ops": ops}

    def dump_historic_slow_ops(self) -> dict:
        """Slowest retained ops that crossed osd_op_complaint_time
        (worst-first; falls back to the slowest ring when nothing
        crossed -- the operator asked 'show me the worst')."""
        complaint = self.complaint_time()
        with self._lock:
            slow = [op for op in self._slowest
                    if complaint > 0 and op.duration >= complaint]
            ops = [op.to_dict() for op in (slow or self._slowest)]
        return {"num_ops": len(ops), "ops": ops,
                "complaint_time": complaint,
                "slow_ops_counted": self.slow_ops}
