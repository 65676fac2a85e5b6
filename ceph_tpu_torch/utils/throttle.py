"""Throttle: budgeted flow control (reference: src/common/Throttle.{h,cc}).

Port of ``ceph_tpu/utils/throttle.py``.

The reference's Throttle is a counted budget: ``get(c)`` blocks while
the budget is exhausted (in FIFO order -- each waiter queues a cond),
``put(c)`` returns budget and wakes waiters; ``get_or_fail`` is the
non-blocking form.  Used all over the daemons: messenger dispatch
byte caps (osd_client_message_size_cap), journal bytes, objecter
in-flight ops.  BackoffThrottle adds a probabilistic delay ramp as the
budget approaches full instead of a hard wall.

Async re-design: waiters are asyncio futures served strictly FIFO, so
one large request cannot be starved by a stream of small ones (the
reference has the same fairness via its cond queue).
"""

from __future__ import annotations

import asyncio
from collections import deque
from typing import Deque, Optional, Tuple


class Throttle:
    def __init__(self, name: str, max_budget: int):
        self.name = name
        self.max = max_budget
        self.count = 0
        self._waiters: Deque[Tuple[int, asyncio.Future]] = deque()
        # observability (PerfCounters-lite, matching l_throttle_*)
        self.n_gets = 0
        self.n_waits = 0

    def _should_wait(self, c: int) -> bool:
        if self.max <= 0:
            return False  # unlimited
        # a request larger than max is allowed through alone (the
        # reference admits oversized requests when the budget is empty)
        if c >= self.max:
            return self.count > 0
        return self.count + c > self.max

    def _wake(self) -> None:
        while self._waiters:
            c, fut = self._waiters[0]
            if self._should_wait(c):
                break
            self._waiters.popleft()
            if not fut.done():
                self.count += c
                fut.set_result(True)

    async def get(self, c: int = 1) -> None:
        """Take ``c`` budget; FIFO-blocks while exhausted."""
        self.n_gets += 1
        if not self._waiters and not self._should_wait(c):
            self.count += c
            return
        self.n_waits += 1
        fut = asyncio.get_event_loop().create_future()
        self._waiters.append((c, fut))
        try:
            await fut
        except asyncio.CancelledError:
            if fut.cancelled():
                # never granted (task cancellation cancels the future
                # itself): just dequeue -- putting here would return
                # budget that was never taken and over-admit past max
                try:
                    self._waiters.remove((c, fut))
                except ValueError:
                    pass
                self._wake()  # we may have been the FIFO head blocking
                # smaller requests behind us
            else:
                # granted (set_result) between the cancel and here
                self.put(c)
            raise

    def get_or_fail(self, c: int = 1) -> bool:
        self.n_gets += 1
        if self._waiters or self._should_wait(c):
            return False
        self.count += c
        return True

    def put(self, c: int = 1) -> None:
        self.count = max(0, self.count - c)
        self._wake()

    def set_max(self, m: int) -> None:
        self.max = m
        self._wake()

    def past_midpoint(self) -> bool:
        return self.max > 0 and self.count >= self.max // 2


class BackoffThrottle:
    """Delay-ramp throttle (src/common/Throttle.h BackoffThrottle):
    below ``low`` utilization no delay; between low and high the delay
    ramps linearly to ``max_delay``; above high it's the full delay.
    Used by BlueStore to pace deferred writes without a hard wall."""

    def __init__(self, name: str, max_budget: int,
                 low: float = 0.5, high: float = 0.9,
                 max_delay: float = 0.05):
        self.name = name
        self.max = max_budget
        self.count = 0
        self.low = low
        self.high = high
        self.max_delay = max_delay

    def _delay(self) -> float:
        if self.max <= 0:
            return 0.0
        util = self.count / self.max
        if util < self.low:
            return 0.0
        if util >= self.high:
            return self.max_delay
        return self.max_delay * (util - self.low) / (self.high - self.low)

    async def get(self, c: int = 1) -> float:
        d = self._delay()
        if d > 0:
            await asyncio.sleep(d)
        self.count += c
        return d

    def put(self, c: int = 1) -> None:
        self.count = max(0, self.count - c)
