"""Arrival processes for the load generator.

Port of ``ceph_tpu/loadgen/arrival.py``.

Two families (the open/closed distinction matters for what a benchmark
can claim -- an open-loop process keeps arriving while the system
stalls, so it measures queueing honestly; a closed-loop process models
a bounded client population):

* :class:`ClosedLoop` -- each client issues its next op when the
  previous completes, optionally separated by exponentially-distributed
  think time (mean ``think_s``).
* :class:`OpenLoop` -- Poisson arrivals at ``rate_ops_s`` per client:
  inter-arrival gaps are exponential and arrivals do NOT wait for
  completions (in-flight ops bounded by the client's budget semaphore;
  an arrival that finds the budget exhausted parks and is counted as
  shed -- the bounded-memory contract).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ClosedLoop:
    think_s: float = 0.0

    def gap(self, rng) -> float:
        if self.think_s <= 0:
            return 0.0
        return rng.expovariate(1.0 / self.think_s)


@dataclasses.dataclass(frozen=True)
class OpenLoop:
    rate_ops_s: float

    def gap(self, rng) -> float:
        if self.rate_ops_s <= 0:
            return 0.0
        return rng.expovariate(self.rate_ops_s)
