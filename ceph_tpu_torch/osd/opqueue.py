"""QoS op queues: weighted-priority and mClock (dmClock) scheduling.

Port of ``ceph_tpu/osd/opqueue.py``.

Reference: the OSD's pluggable op queue (``osd_op_queue`` =
``wpq`` | ``mclock_opclass`` | ``mclock_client``):

* ``WeightedPriorityQueue`` — src/common/WeightedPriorityQueue.h: ops at or
  above a strict-priority cutoff are served in strict priority order;
  lower-priority buckets are served weighted-round-robin with throughput
  proportional to their priority value.
* ``MClockQueue`` — src/osd/mClock*.{h,cc} over the vendored dmClock
  library (src/dmclock): each op class has a (reservation, weight, limit)
  triple in ops/sec; tag-based scheduling guarantees the reservation floor,
  splits spare capacity by weight, and enforces the limit ceiling
  [Gulati et al., mClock, OSDI'10 — the algorithm dmClock implements].

Both queues are cost-aware: an item's cost scales its tag spacing (a
4 MiB write consumes more of a class's rate than a 4 KiB one).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, Optional, Tuple


class WeightedPriorityQueue:
    """Strict above the cutoff, weighted round-robin below."""

    def __init__(self, strict_cutoff: int = 196):
        self.strict_cutoff = strict_cutoff
        self._strict: Dict[int, deque] = {}
        self._weighted: Dict[int, deque] = {}
        #: deficit-round-robin credit per weighted bucket
        self._credit: Dict[int, float] = {}
        self._rr: deque = deque()  # round-robin order of weighted priorities
        self._len = 0

    def enqueue(self, priority: int, cost: int, item) -> None:
        buckets = (
            self._strict if priority >= self.strict_cutoff else self._weighted
        )
        if priority not in buckets:
            buckets[priority] = deque()
            if buckets is self._weighted:
                self._rr.append(priority)
                self._credit.setdefault(priority, 0.0)
        buckets[priority].append((max(1, cost), item))
        self._len += 1

    def __len__(self) -> int:
        return self._len

    def empty(self) -> bool:
        return self._len == 0

    def dequeue(self):
        if self._strict:
            prio = max(self._strict)
            q = self._strict[prio]
            cost, item = q.popleft()
            if not q:
                del self._strict[prio]
            self._len -= 1
            return item
        # weighted: deficit round robin, quantum proportional to priority.
        # A bucket serves while its credit lasts; when the head item costs
        # more than the remaining credit, the bucket receives one quantum
        # (= its priority) and the turn passes on, so each full rotation
        # serves ~priority-proportional cost from every bucket.
        while self._rr:
            prio = self._rr[0]
            q = self._weighted.get(prio)
            if not q:
                self._rr.popleft()
                self._weighted.pop(prio, None)
                self._credit.pop(prio, None)
                continue
            cost, item = q[0]
            if self._credit[prio] >= cost:
                self._credit[prio] -= cost
                q.popleft()
                self._len -= 1
                if not q:
                    self._rr.popleft()
                    del self._weighted[prio]
                    self._credit[prio] = 0.0
                return item
            self._credit[prio] += max(1, prio)  # prio<=0 must still progress
            self._rr.rotate(-1)
        raise IndexError("dequeue from empty queue")


class MClockQueue:
    """dmClock tag scheduler over named op classes.

    ``classes`` maps class name -> (reservation, weight, limit) in
    cost-units/sec; reservation/limit of 0 mean none.  Time comes from
    ONE injected monotonic ``clock`` (default ``time.monotonic``) read
    inside every operation -- callers no longer supply ``now`` floats,
    so mixed clock domains (event-loop time vs wall time vs a test's
    virtual clock) can never corrupt tag ordering, and a wall-clock
    regression cannot re-order tags minted under the old time.
    ``dequeue()`` returns the next eligible item or None if every queued
    class is at its limit; ``next_ready()`` says when one becomes
    eligible (absolute, in the injected clock's domain -- compare
    against ``self.clock()``).
    """

    def __init__(self, classes: Dict[str, Tuple[float, float, float]],
                 clock: Callable[[], float] = time.monotonic):
        self.classes = dict(classes)
        self.clock = clock
        self._queues: Dict[str, deque] = {}
        #: per-class last-assigned tags (reservation, proportional, limit)
        self._tags: Dict[str, Tuple[float, float, float]] = {}

    def _params(self, klass: str) -> Tuple[float, float, float]:
        return self.classes.get(klass, (0.0, 1.0, 0.0))

    def enqueue(self, klass: str, cost: int, item) -> None:
        now = self.clock()
        res, wgt, lim = self._params(klass)
        cost = max(1, cost)
        prev = self._tags.get(klass)
        if prev is None:
            # a class's first request is eligible immediately (dmClock
            # initializes tags to the arrival time, not one period out)
            r = now if res > 0 else float("inf")
            p = now
            l = now
        else:
            lr, lp, ll = prev
            r = max(now, lr + cost / res) if res > 0 else float("inf")
            p = max(now, lp + cost / max(wgt, 1e-9))
            l = max(now, ll + cost / lim) if lim > 0 else now
        self._queues.setdefault(klass, deque()).append((r, p, l, item))
        self._tags[klass] = (r, p, l)

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def empty(self) -> bool:
        return not any(self._queues.values())

    def _heads(self):
        for klass, q in self._queues.items():
            if q:
                yield klass, q[0]

    def dequeue(self):
        now = self.clock()
        # phase 1: honor reservations whose tag has come due
        best = None
        for klass, (r, p, l, item) in self._heads():
            if r <= now and (best is None or r < best[0]):
                best = (r, klass)
        if best is not None:
            return self._pop(best[1])
        # phase 2: spare capacity by proportional tag, limit permitting
        best = None
        for klass, (r, p, l, item) in self._heads():
            if l <= now and (best is None or p < best[0]):
                best = (p, klass)
        if best is not None:
            return self._pop(best[1])
        return None

    def _pop(self, klass: str):
        r, p, l, item = self._queues[klass].popleft()
        return item

    def next_ready(self) -> Optional[float]:
        """Earliest time a queued item becomes eligible (None if empty;
        absolute in the injected clock's domain)."""
        t = None
        for klass, (r, p, l, item) in self._heads():
            cand = min(r, l)
            if t is None or cand < t:
                t = cand
        return t

    def idle_for(self) -> Optional[float]:
        """Seconds until the next queued item becomes eligible: the
        shard worker's event-driven idle wakeup (sleep exactly this
        long, or until a new arrival, instead of polling).  None when
        the queue is empty; 0.0 when something is eligible right now."""
        nxt = self.next_ready()
        if nxt is None:
            return None
        return max(0.0, nxt - self.clock())
