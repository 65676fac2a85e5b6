"""MgrClient-style daemon telemetry: beacon + report frames.

Port of ``ceph_tpu/mgr/report.py``.  :class:`ReportSender` runs over the
in-process messenger (``osd/messenger.py``); the TCP messenger and its
wire codecs are ROADMAP.md queue 1 item 16, so the frames here are
Python objects on that messenger, not encoded bytes.

Reference: src/mgr/MgrClient.cc -- every daemon opens a session to the
active mgr and ships (a) a lightweight beacon proving liveness and (b) a
periodic ``MMgrReport`` carrying its perf-counter deltas and, for OSDs,
``MPGStats`` per-PG statistics.  The mgr's DaemonServer folds those into
the PGMap; health is derived from the *wire-fed* map, never from
in-process introspection -- which is what lets ``ceph -s`` work against
a cluster of separate processes.

Same split here:

* :class:`MgrBeacon` / :class:`MgrReport` -- typed messages (the JAX
  package also encodes them with its ``msg/wire.py`` codecs) with the
  repo's trailing-optional-field compat discipline: the ``lag_ms`` tail is
  remaining()-guarded, so pre-lag peers interop both ways (the
  reqid/trace/qos_class pattern).
* :class:`ReportSender` -- the per-daemon report loop: one beacon per
  ``mgr_beacon_interval``, one report per ``mgr_report_interval``, both
  to every ``mgr.*`` entity in the address map.  Lossy by design: a
  dead mgr costs nothing but the send attempt, and a restarted mgr
  rebuilds its map from the next round of reports.
* :class:`LoopLagProbe` -- the sampled event-loop lag gauge shipped in
  every beacon/report: a sleeper task measures its own scheduling
  drift (requested vs actual sleep), EWMA-smoothed.  This is the
  direct per-daemon forcing metric for the Python-wire-loop ceiling
  (ROADMAP item 2): under loadgen saturation the lag attributes the
  stall to a specific daemon.

The ``REPORTED_COUNTERS`` / ``REPORTED_COUNTER_PREFIXES`` tables below
are the report *schema*: the subset of each daemon's perf counters that
ships in report frames (bounded frame size) and therefore reaches the
aggregated mgr exposition.  The cephlint rule ``perf-counter-unexported``
(analysis/rules_perf.py) enforces that every counter a daemon increments
is either named here, matches a prefix, or carries a justified inline
disable -- so new counters cannot silently stay invisible to operators
(the port's lint is ROADMAP.md queue 1 item 21).
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Callable, Dict, Iterable, List, Optional

#: report schema version (bumped when the ``stats`` dict shape changes;
#: the decoder keeps old fields readable -- consumers .get() everything)
REPORT_SCHEMA_VERSION = 1

#: exact counter names shipped in MgrReport frames.  The PGMap rate
#: engine reads client_ops / client_wr_bytes / client_rd_bytes /
#: recovery_bytes deltas for the ``ceph -s`` io block.
REPORTED_COUNTERS = frozenset({
    "client_ops", "client_wr_bytes", "client_rd_bytes",
    "sub_write", "sub_read", "sub_write_stale", "sub_write_missed_base",
    "sub_write_rollback",
    "write", "read", "write_range", "read_range", "read_cache_hit",
    "write_conflict", "degraded_read", "stale_shards_dropped",
    "rolled_back_version_skipped", "remove_torn_copy",
    "read_crc_error", "deep_scrub", "snap_trim",
    "slow_ops", "cap_denied", "queued_client_op",
    "mesh_claim_miss", "pglog_rollback", "obj_versions_serve",
    # regenerating-repair lane: beta-sized helper symbols computed by
    # survivors (the repair-bandwidth story's survivor-side half)
    "regen_helpers_served",
    # client-side Objecter counters (exported through the in-process
    # ClusterState client_perf block and any client-side scrape)
    "primary_failover", "write_conflict_retry", "client_inflight_hwm",
})

#: counter-name prefixes shipped wholesale (whole families: QoS classes,
#: recovery/scrub/tier/peering/backoff/dup machinery, op-queue kinds)
REPORTED_COUNTER_PREFIXES = (
    "qos_", "recovery_", "recover", "scrub_", "tier_", "peering_",
    "pg_", "backoff_", "dup_", "queued_", "op_", "notify_", "watch_",
    "probe_", "false_demotion", "loop_lag_",
)


def counter_reported(key: str) -> bool:
    """Is ``key`` part of the report schema (ships in MgrReport frames)?"""
    return key in REPORTED_COUNTERS or key.startswith(
        REPORTED_COUNTER_PREFIXES)


def filter_counters(snapshot: Dict[str, object]) -> Dict[str, object]:
    """The report-schema slice of a PerfCounters snapshot (plain ints
    and tinc {avgcount, sum} dicts only -- everything value()-encodable)."""
    out: Dict[str, object] = {}
    for key, val in snapshot.items():
        if not counter_reported(key):
            continue
        if isinstance(val, (int, float)) or (
            isinstance(val, dict)
            and set(val) <= {"avgcount", "sum"}
        ):
            out[key] = val
    return out


# -- typed wire messages ----------------------------------------------------


@dataclasses.dataclass
class MgrBeacon:
    """Liveness proof (the MMgrBeacon role): tiny, frequent, lossy.
    ``lag_ms`` is a trailing optional wire field -- pre-lag senders end
    at ``seq`` and pre-lag decoders ignore the tail."""

    name: str
    seq: int
    lag_ms: Optional[float] = None


@dataclasses.dataclass
class MgrReport:
    """Periodic daemon statistics (MMgrReport + MPGStats in one frame).

    ``stats`` is the schema-versioned payload dict -- per-PG stats under
    ``"pgs"``, store totals under ``"store"``, the perf-counter slice
    under ``"perf"``, histogram marginals under ``"hist"`` (see
    ``OSDShard.mgr_report_stats``).  ``lag_ms`` is the same trailing
    optional tail as the beacon's."""

    name: str
    seq: int
    interval: float
    stats: dict
    lag_ms: Optional[float] = None


# -- the sampled event-loop lag probe ---------------------------------------


class LoopLagProbe:
    """Event-loop lag gauge with ONE source of truth per daemon.

    When the wire-tax profiler's event-loop arm is active
    (``profile_mode`` on, ``ceph_tpu_torch/profiling/loopmon.py``), the
    probe reads ITS scheduling-latency EWMA -- every timer callback's
    oversleep, not a 10 Hz sample -- and spawns nothing: one lag number
    feeds both the MgrReport ``lag_ms`` field and the profiler ledger,
    and there is no second sampled-sleep task competing with the loop
    it measures.  With profiling off, the round-18 sampled sleeper is
    the fallback: sleep ``interval``, measure oversleep, EWMA-smooth.

    Oversleep is exactly the time this daemon's event loop spent unable
    to schedule a ready task -- the per-daemon Python-wire-loop stall
    metric.  The hwm also lands in the perf registry
    (``loop_lag_hwm_us``) so it rides the normal counter plumbing."""

    def __init__(self, perf=None, interval: float = 0.1,
                 alpha: float = 0.25):
        self.perf = perf
        self.interval = interval
        self.alpha = alpha
        self._lag_ms = 0.0
        self._lag_hwm_ms = 0.0
        self._task: Optional[asyncio.Task] = None

    @staticmethod
    def _monitor():
        from ceph_tpu_torch import profiling

        return profiling.loop_monitor()

    @property
    def lag_ms(self) -> float:
        mon = self._monitor()
        return mon.lag_ms if mon is not None else self._lag_ms

    @property
    def lag_hwm_ms(self) -> float:
        mon = self._monitor()
        return mon.lag_hwm_ms if mon is not None else self._lag_hwm_ms

    async def _run(self) -> None:
        loop = asyncio.get_event_loop()
        while True:
            t0 = loop.time()
            await asyncio.sleep(self.interval)
            if self._monitor() is not None:
                continue  # the profiler arm took over mid-run: idle
            drift_ms = max(0.0, (loop.time() - t0 - self.interval) * 1e3)
            self._lag_ms += self.alpha * (drift_ms - self._lag_ms)
            if drift_ms > self._lag_hwm_ms:
                self._lag_hwm_ms = drift_ms
                if self.perf is not None:
                    self.perf.hwm("loop_lag_hwm_us", int(drift_ms * 1e3))

    def start(self, messenger=None, name: str = "lagprobe") -> None:
        if self._task is not None:
            return
        if self._monitor() is not None:
            return  # profiler loop arm active: it IS the lag source
        self._task = asyncio.get_event_loop().create_task(self._run())
        if messenger is not None:
            messenger.adopt_task(f"{name}.lagprobe", self._task)

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None


# -- the per-daemon report loop ---------------------------------------------


class ReportSender:
    """The MgrClient role: beacon + report loop for one daemon.

    ``build_stats`` returns the report payload dict (must contain only
    value()-encodable data); it runs once per report interval, so it
    must stay O(counters), never O(objects) -- the incremental per-PG
    accounting exists precisely so this holds."""

    def __init__(self, name: str, messenger,
                 build_stats: Callable[[], dict],
                 mgr_targets: Iterable[str],
                 perf=None, lag_probe: Optional[LoopLagProbe] = None):
        from ceph_tpu_torch.utils.config import get_config

        self.name = name
        self.messenger = messenger
        self.build_stats = build_stats
        self.targets: List[str] = sorted(mgr_targets)
        cfg = get_config()
        self.beacon_interval = float(cfg.get_val("mgr_beacon_interval"))
        self.report_interval = float(cfg.get_val("mgr_report_interval"))
        self.lag_probe = lag_probe or LoopLagProbe(perf=perf)
        self._seq = 0
        self._task: Optional[asyncio.Task] = None

    async def _send(self, msg) -> None:
        for target in self.targets:
            try:
                await self.messenger.send_message(self.name, target, msg)
            except (OSError, asyncio.TimeoutError):
                pass  # mgr down: beacons/reports are lossy by contract

    async def send_report_now(self) -> None:
        """One report frame immediately (tests + the pre-shutdown
        flush)."""
        self._seq += 1
        await self._send(MgrReport(
            name=self.name, seq=self._seq,
            interval=self.report_interval,
            stats=self.build_stats(),
            lag_ms=round(self.lag_probe.lag_ms, 3),
        ))

    async def _run(self) -> None:
        last_report = 0.0
        loop = asyncio.get_event_loop()
        while True:
            await asyncio.sleep(self.beacon_interval)
            self._seq += 1
            await self._send(MgrBeacon(
                name=self.name, seq=self._seq,
                lag_ms=round(self.lag_probe.lag_ms, 3),
            ))
            now = loop.time()
            if now - last_report >= self.report_interval:
                last_report = now
                await self.send_report_now()

    def start(self) -> None:
        """Start the loop (idempotent); the task is adopted by the
        messenger so shutdown cancels it with everything else."""
        if self._task is not None or not self.targets:
            return
        self.lag_probe.start(self.messenger, self.name)
        self._task = asyncio.get_event_loop().create_task(self._run())
        self.messenger.adopt_task(f"{self.name}.mgr-report", self._task)

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        self.lag_probe.stop()


def mgr_targets_from(addr_map: Dict[str, object]) -> List[str]:
    """The mgr entities a daemon should report to (``mgr.*`` keys of the
    cluster address book; empty = telemetry off, zero overhead)."""
    return sorted(k for k in addr_map if k.startswith("mgr."))
