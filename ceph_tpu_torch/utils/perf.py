"""Perf counters + admin-socket-style dump (PerfCounters equivalent).

Port of ``ceph_tpu/utils/perf.py``; the port keeps its own copy (its own
globals), so a process that imports both packages does not cross-feed
them.

Reference: src/common/perf_counters.h:53 PerfCountersBuilder and the
admin-socket ``perf dump`` command (src/common/admin_socket.cc).  Counters
are typed (counts, sums, time averages); every subsystem instance registers
in a process-wide collection that ``dump()`` serializes like
``ceph daemon <sock> perf dump``.
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict
from typing import Dict


class PerfCounters:
    _collection: Dict[str, "PerfCounters"] = {}
    _collection_lock = threading.Lock()

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = defaultdict(int)
        self._sums: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        with PerfCounters._collection_lock:
            PerfCounters._collection[name] = self

    def inc(self, key: str, amount: int = 1) -> None:
        with self._lock:
            self._counters[key] += amount

    def hwm(self, key: str, value: int) -> None:
        """High-water-mark counter: keeps the max ever reported (the
        reference's PERFCOUNTER_U64 gauges used as peaks, e.g. resident
        cache-tier bytes)."""
        with self._lock:
            if value > self._counters[key]:
                self._counters[key] = value

    def tinc(self, key: str, seconds: float) -> None:
        """Time/average counter (latency style)."""
        with self._lock:
            self._sums[key] += seconds
            self._counts[key] += 1

    def time(self, key: str):
        """Context manager measuring a code block into a tinc counter."""
        outer = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                outer.tinc(key, time.perf_counter() - self.t0)
                return False

        return _Timer()

    def snapshot(self) -> dict:
        with self._lock:
            out: dict = dict(self._counters)
            for key in self._sums:
                out[key] = {
                    "avgcount": self._counts[key],
                    "sum": self._sums[key],
                }
            return out

    @classmethod
    def dump(cls) -> str:
        """The `perf dump` admin-socket command."""
        with cls._collection_lock:
            return json.dumps(
                {name: pc.snapshot() for name, pc in cls._collection.items()},
                indent=2,
                sort_keys=True,
            )

    @classmethod
    def reset_all(cls) -> None:
        with cls._collection_lock:
            cls._collection.clear()
            PerfHistogram._collection.clear()


class HistogramAxis:
    """One axis of a 2D perf histogram (src/perf_histogram.h
    axis_config_d): ``scale`` is "linear" or "log2"; values below
    ``min`` land in bucket 0, values past the last bucket in the last
    (the reference's underflow/overflow buckets)."""

    def __init__(self, name: str, min_value: int, quant_size: int,
                 buckets: int, scale: str = "log2"):
        if scale not in ("linear", "log2"):
            raise ValueError(f"unknown axis scale {scale!r}")
        self.name = name
        self.min = min_value
        self.quant = quant_size
        self.buckets = buckets
        self.scale = scale

    def bucket_for(self, value: float) -> int:
        if value < self.min:
            return 0
        off = value - self.min
        if self.scale == "linear":
            b = 1 + int(off // self.quant)
        else:
            # closed form of the doubling walk (b doublings cover
            # quant*(2^b - 1)): O(1) -- this runs on every data-path
            # latency observation, a Python loop here was measurable
            b = (int(off) // self.quant + 1).bit_length()
        return min(b, self.buckets - 1)

    def upper_bounds(self) -> list:
        """Inclusive upper bound of every bucket but the last (whose
        bound is +Inf) -- the prometheus ``le`` values this axis maps
        onto.  Bucket 0 is the underflow bucket (< min)."""
        if self.scale == "linear":
            return [self.min + self.quant * b
                    for b in range(self.buckets - 1)]
        out = [self.min]
        acc = 0
        for b in range(1, self.buckets - 1):
            acc += self.quant * (2 ** (b - 1))
            out.append(self.min + acc)
        return out

    def to_dict(self) -> dict:
        return {"name": self.name, "min": self.min, "quant_size": self.quant,
                "buckets": self.buckets, "scale_type": self.scale}


class PerfHistogram:
    """2D counter grid (src/perf_histogram.h PerfHistogram<2>): e.g.
    request latency x request size, dumped by ``perf histogram dump``.
    Cells are x-major."""

    _collection: Dict[str, "PerfHistogram"] = {}

    def __init__(self, name: str, x: HistogramAxis, y: HistogramAxis):
        self.name = name
        self.x = x
        self.y = y
        self._lock = threading.Lock()
        self._values = [0] * (x.buckets * y.buckets)
        #: running sum of raw x observations (the prometheus ``_sum``
        #: series; the grid alone only preserves bucketed counts)
        self._x_sum = 0.0
        self._count = 0
        with PerfCounters._collection_lock:
            PerfHistogram._collection[name] = self

    def inc(self, x_value: float, y_value: float, amount: int = 1) -> None:
        bx = self.x.bucket_for(x_value)
        by = self.y.bucket_for(y_value)
        with self._lock:
            self._values[bx * self.y.buckets + by] += amount
            self._x_sum += x_value * amount
            self._count += amount

    def inc_many(self, x_value: float, y_values, amount: int = 1) -> None:
        """Batch form of :meth:`inc` for one shared x observation over a
        run of y values (the OSD's array-batched op path): the x bucket
        is computed once and the whole run folds in under ONE lock
        acquisition instead of one per observation."""
        base = self.x.bucket_for(x_value) * self.y.buckets
        bucket_y = self.y.bucket_for
        n = 0
        with self._lock:
            for y in y_values:
                self._values[base + bucket_y(y)] += amount
                n += 1
            self._x_sum += x_value * amount * n
            self._count += amount * n

    def inc_pairs(self, pairs) -> None:
        """Batch form of :meth:`inc` for (x, y) observation pairs: one
        lock acquisition for the whole run."""
        bucket_x = self.x.bucket_for
        bucket_y = self.y.bucket_for
        yb = self.y.buckets
        with self._lock:
            n = 0
            for x, y in pairs:
                self._values[bucket_x(x) * yb + bucket_y(y)] += 1
                self._x_sum += x
                n += 1
            self._count += n

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "axes": [self.x.to_dict(), self.y.to_dict()],
                "values": list(self._values),
                "x_sum": self._x_sum,
                "count": self._count,
            }

    def x_marginal(self) -> list:
        """Per-x-bucket counts summed over the y axis (the 1-D latency
        distribution a prometheus histogram series exposes)."""
        with self._lock:
            vals = list(self._values)
        yb = self.y.buckets
        return [sum(vals[bx * yb:(bx + 1) * yb])
                for bx in range(self.x.buckets)]

    @classmethod
    def get_or_create(cls, name: str, x_factory, y_factory
                      ) -> "PerfHistogram":
        """Idempotent registration: per-stage latency observers share
        one histogram per (daemon, stage) name no matter which engine
        touches it first."""
        with PerfCounters._collection_lock:
            h = cls._collection.get(name)
        if h is not None:
            return h
        cls(name, x_factory(), y_factory())
        with PerfCounters._collection_lock:
            return cls._collection[name]

    @classmethod
    def dump(cls) -> str:
        """The ``perf histogram dump`` admin-socket command."""
        with PerfCounters._collection_lock:
            return json.dumps(
                {name: h.snapshot() for name, h in cls._collection.items()},
                indent=2, sort_keys=True,
            )


def stage_histogram(name: str) -> PerfHistogram:
    """The shared per-stage latency observer: a latency(usec, log2) x
    size(bytes, log2) grid under ``name`` (one per daemon per stage --
    queue-wait, dispatch, wire-rtt, ack-lag, tier hit/miss read), the
    PerfHistogram the prometheus module exposes as real
    ``_bucket``/``_sum``/``_count`` series."""
    return PerfHistogram.get_or_create(
        name,
        lambda: HistogramAxis("latency_usec", 0, 64, 32, "log2"),
        lambda: HistogramAxis("size_bytes", 0, 512, 24, "log2"),
    )


def histogram_marginals(prefix: str = "") -> Dict[str, dict]:
    """Per-histogram x-axis marginal + bounds + sum/count, the compact
    form MgrReport frames ship (a full 2-D grid per report would be
    ~25x the bytes for no exposition gain: the prometheus series only
    ever render the latency marginal)."""
    with PerfCounters._collection_lock:
        hists = list(PerfHistogram._collection.items())
    out: Dict[str, dict] = {}
    for name, h in hists:
        if prefix and not name.startswith(prefix):
            continue
        snap = h.snapshot()
        out[name] = {
            "bounds": h.x.upper_bounds(),
            "marginal": h.x_marginal(),
            "sum": snap["x_sum"],
            "count": snap["count"],
        }
    return out


def histograms_prometheus_text() -> str:
    """Every registered PerfHistogram as prometheus histogram series:
    cumulative ``_bucket{le=...}`` over the x (latency) marginal, plus
    ``_sum`` (raw x sum) and ``_count``.  Instances named
    ``<daemon>.<stage>`` (daemon like ``osd.0`` / ``client``) share one
    metric family per stage with a ``ceph_daemon`` label."""
    with PerfCounters._collection_lock:
        hists = list(PerfHistogram._collection.items())
    families: Dict[str, list] = {}
    for name, h in sorted(hists):
        parts = name.split(".")
        if len(parts) >= 3 and parts[0] == "osd" and parts[1].isdigit():
            daemon, family = f"{parts[0]}.{parts[1]}", ".".join(parts[2:])
        elif len(parts) >= 2:
            daemon, family = parts[0], ".".join(parts[1:])
        else:
            daemon, family = "", name
        metric = "ceph_hist_" + "".join(
            c if c.isalnum() else "_" for c in family)
        families.setdefault(metric, []).append((daemon, h))
    lines = []
    for metric in sorted(families):
        lines.append(f"# HELP {metric} per-stage latency histogram "
                     "(PerfHistogram x-axis marginal; le in the axis "
                     "unit)")
        lines.append(f"# TYPE {metric} histogram")
        for daemon, h in families[metric]:
            label = f'{{ceph_daemon="{daemon}",le=' if daemon \
                else "{le="
            marginal = h.x_marginal()
            bounds = h.x.upper_bounds()
            cum = 0
            for ub, count in zip(bounds, marginal):
                cum += count
                lines.append(f'{metric}_bucket{label}"{ub}"}} {cum}')
            cum += sum(marginal[len(bounds):])
            lines.append(f'{metric}_bucket{label}"+Inf"}} {cum}')
            snap = h.snapshot()
            tail = f'{{ceph_daemon="{daemon}"}}' if daemon else ""
            lines.append(f"{metric}_sum{tail} {snap['x_sum']}")
            lines.append(f"{metric}_count{tail} {snap['count']}")
    return "\n".join(lines)
