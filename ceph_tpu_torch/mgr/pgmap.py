"""Wire-fed cluster map: PGMap fold + the mgr daemon server role.

Port of ``ceph_tpu/mgr/pgmap.py``.  In the port the frames arrive over
the in-process messenger (the TCP messenger is ROADMAP.md queue 1 item
16); the fold, the rates, the staleness rules and every rendering are
the JAX package's.

Reference: src/mon/PGMap.{h,cc} + src/mgr/DaemonServer.cc -- the mgr
folds every daemon's MMgrReport/MPGStats into an INCREMENTAL PGMap
(apply_incremental), derives health from the map plus staleness rules
(an OSD whose beacon went silent is down; a PG whose stats stopped
arriving is stale), and computes the ``ceph -s`` io block from
consecutive report deltas.  Nothing here ever touches another process's
memory: the map is built purely from :class:`~ceph_tpu_torch.mgr.report`
frames arriving over the messenger, which is what makes health work
against a real multi-process cluster (daemon/, vstart, loadgen).

* :class:`PGMap` -- the fold + rate engine + staleness health.
  Staleness is evaluated lazily against the injected clock at read
  time, so there is no tick task to leak and tests drive it with a
  virtual clock.
* :class:`MgrServer` -- binds a PGMap to a messenger entity
  (``mgr.N``), serves /metrics /health /status over HTTP and the
  pg-stat/health verbs over the admin socket (daemon/mgr.py wires
  them), and renders the aggregated one-scrape-per-cluster prometheus
  exposition from the per-daemon report series.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from typing import Dict, List, Optional

from ceph_tpu_torch.mgr.report import MgrBeacon, MgrReport


class ClusterLog:
    """Bounded mgr-local cluster event log (the ``clog`` analogue).

    Health transitions and slow-op WARNINGs append here as they are
    OBSERVED by the mgr (health is computed lazily at read time, so a
    transition lands on the first health read that sees it; slow-op
    deltas land at report fold).  Mgr-local only -- no new wire frames;
    ``rados_cli log last [n]`` renders it over the admin socket."""

    def __init__(self, keep: int = 256, clock=None):
        self.clock = clock if clock is not None else time.time
        self._ring: deque = deque(maxlen=keep)
        self._seq = 0

    def append(self, severity: str, message: str) -> None:
        self._seq += 1
        self._ring.append({
            "seq": self._seq,
            "stamp": round(self.clock(), 3),
            "severity": severity,  # INF | WRN | ERR
            "message": message,
        })

    def last(self, n: int = 20) -> List[dict]:
        entries = list(self._ring)
        return entries[-max(0, int(n)):]

    def __len__(self) -> int:
        return len(self._ring)

#: perf counters whose per-interval deltas become rates (the io block):
#: key -> (rate name, unit scale note)
RATE_COUNTERS = ("client_ops", "client_wr_bytes", "client_rd_bytes",
                 "recovery_bytes")


def fold_health(checks: Dict[str, dict]) -> dict:
    """Severity fold shared by the in-process health_checks and the
    wire-fed map (src/mon/health_check.h semantics)."""
    status = "HEALTH_OK"
    for c in checks.values():
        if c["severity"] == "HEALTH_ERR":
            status = "HEALTH_ERR"
            break
        status = "HEALTH_WARN"
    return {"status": status, "checks": checks}


class _DaemonState:
    __slots__ = ("name", "kind", "last_beacon", "last_report", "seq",
                 "lag_ms", "lag_over", "stats", "rates", "prev",
                 "slow_ops_seen")

    def __init__(self, name: str):
        self.name = name
        self.kind = name.split(".", 1)[0]
        self.last_beacon: float = 0.0
        self.last_report: float = 0.0
        self.seq = 0
        self.lag_ms: float = 0.0
        #: consecutive over-threshold lag samples (DAEMON_LAG sustain)
        self.lag_over = 0
        self.stats: dict = {}
        self.rates: Dict[str, float] = {}
        #: (clock, {rate counter: value}) of the previous report
        self.prev: Optional[tuple] = None
        #: slow_ops counter watermark (clog slow-op WARNING deltas)
        self.slow_ops_seen = 0


class PGMap:
    """Incremental cluster map folded from beacon/report frames."""

    def __init__(self, expected=None, clock=None):
        from ceph_tpu_torch.utils.config import get_config

        cfg = get_config()
        self.beacon_grace = float(cfg.get_val("mgr_daemon_beacon_grace"))
        self.pg_stale_grace = float(cfg.get_val("mgr_pg_stale_grace"))
        self.lag_warn_ms = float(cfg.get_val("mgr_lag_warn_ms"))
        self.lag_sustain = int(cfg.get_val("mgr_lag_sustain"))
        self.clock = clock if clock is not None else time.monotonic
        #: daemons that SHOULD be beaconing (the cluster address book):
        #: one that never has is down, not unknown -- health cannot be
        #: OK before every expected daemon has proven liveness
        self.expected = set(expected or ())
        self.daemons: Dict[str, _DaemonState] = {}
        #: pool -> reporting daemon -> {pg stat fields + "t" fold time}
        self.pgs: Dict[str, Dict[str, dict]] = {}
        self.reports_folded = 0
        self.beacons_folded = 0
        #: mgr-local cluster event log: health transitions + slow-op
        #: warnings (rados_cli `log last [n]`)
        self.clog = ClusterLog()
        #: last health view this map rendered (transition detection)
        self._health_prev: Dict[str, str] = {}
        self._status_prev: Optional[str] = None

    # -- fold ---------------------------------------------------------------

    def _daemon(self, name: str) -> _DaemonState:
        d = self.daemons.get(name)
        if d is None:
            d = self.daemons[name] = _DaemonState(name)
        return d

    def _note_lag(self, d: _DaemonState, lag_ms) -> None:
        if lag_ms is None:
            return
        d.lag_ms = float(lag_ms)
        if d.lag_ms >= self.lag_warn_ms:
            d.lag_over += 1
        else:
            d.lag_over = 0

    def apply(self, msg) -> bool:
        """Fold one beacon/report frame; False for foreign messages."""
        now = self.clock()
        if isinstance(msg, MgrBeacon):
            d = self._daemon(msg.name)
            d.last_beacon = now
            d.seq = max(d.seq, msg.seq)
            self._note_lag(d, msg.lag_ms)
            self.beacons_folded += 1
            return True
        if isinstance(msg, MgrReport):
            d = self._daemon(msg.name)
            d.last_beacon = now  # a report proves liveness too
            d.last_report = now
            d.seq = max(d.seq, msg.seq)
            d.stats = msg.stats or {}
            self._note_lag(d, msg.lag_ms)
            self._fold_rates(d, now)
            # slow-op WARNINGs ride the event log: a report whose
            # slow_ops counter advanced logs the delta (counter going
            # BACKWARD = daemon restart: re-baseline silently)
            slow = (d.stats.get("perf") or {}).get("slow_ops", 0)
            if isinstance(slow, (int, float)):
                if slow > d.slow_ops_seen:
                    self.clog.append(
                        "WRN",
                        f"{int(slow - d.slow_ops_seen)} slow op(s) on "
                        f"{msg.name} ({int(slow)} total)")
                d.slow_ops_seen = slow
            for pool, stat in (d.stats.get("pgs") or {}).items():
                entry = dict(stat)
                entry["t"] = now
                self.pgs.setdefault(pool, {})[msg.name] = entry
            self.reports_folded += 1
            return True
        return False

    def _fold_rates(self, d: _DaemonState, now: float) -> None:
        """The time-series rate engine: consecutive report deltas of the
        RATE_COUNTERS become this daemon's ops/s + B/s contributions
        (the `ceph -s` io block).  A counter that went BACKWARD means
        the daemon restarted: reset the baseline, report zero."""
        perf = d.stats.get("perf") or {}
        cur = {k: perf.get(k, 0) for k in RATE_COUNTERS
               if isinstance(perf.get(k, 0), (int, float))}
        if d.prev is not None:
            t0, old = d.prev
            dt = now - t0
            if dt > 0:
                for key, val in cur.items():
                    delta = val - old.get(key, 0)
                    d.rates[key] = max(0.0, delta) / dt
        d.prev = (now, cur)

    # -- staleness ----------------------------------------------------------

    def daemon_up(self, name: str, now: Optional[float] = None) -> bool:
        d = self.daemons.get(name)
        if d is None or d.last_beacon == 0.0:
            return False
        now = self.clock() if now is None else now
        return (now - d.last_beacon) < self.beacon_grace

    def down_daemons(self, kind: Optional[str] = None) -> List[str]:
        now = self.clock()
        names = set(self.expected) | set(self.daemons)
        out = []
        for name in sorted(names):
            if kind is not None and not name.startswith(kind + "."):
                continue
            if name.startswith("mgr."):
                continue  # we ARE the mgr
            if not self.daemon_up(name, now):
                out.append(name)
        return out

    def stale_pgs(self) -> List[tuple]:
        """(pool, daemon) slices whose per-PG stats stopped arriving."""
        now = self.clock()
        out = []
        for pool, by_daemon in sorted(self.pgs.items()):
            for name, entry in sorted(by_daemon.items()):
                if now - entry["t"] >= self.pg_stale_grace:
                    out.append((pool, name))
        return out

    # -- aggregation --------------------------------------------------------

    def totals(self) -> Dict[str, int]:
        agg = {"degraded": 0, "misplaced": 0, "recovering": 0,
               "scrub_errors": 0}
        for by_daemon in self.pgs.values():
            for entry in by_daemon.values():
                for key in agg:
                    agg[key] += int(entry.get(key, 0) or 0)
        return agg

    def pg_states(self) -> Dict[str, int]:
        """ceph-style state histogram ("active+clean" -> count)."""
        out: Dict[str, int] = {}
        stale = set(self.stale_pgs())
        for pool, by_daemon in self.pgs.items():
            for name, entry in by_daemon.items():
                state = entry.get("state", "unknown")
                if (pool, name) in stale:
                    state = "stale+" + state
                out[state] = out.get(state, 0) + 1
        return out

    def io_rates(self) -> Dict[str, float]:
        agg = {k: 0.0 for k in RATE_COUNTERS}
        for d in self.daemons.values():
            for key, val in d.rates.items():
                agg[key] += val
        return {
            "client_ops_per_sec": round(agg["client_ops"], 3),
            "client_wr_bytes_per_sec": round(agg["client_wr_bytes"], 1),
            "client_rd_bytes_per_sec": round(agg["client_rd_bytes"], 1),
            "recovery_bytes_per_sec": round(agg["recovery_bytes"], 1),
        }

    def store_totals(self) -> Dict[str, int]:
        agg = {"objects": 0, "shards": 0, "metas": 0, "bytes": 0}
        for d in self.daemons.values():
            store = d.stats.get("store") or {}
            for key in agg:
                agg[key] += int(store.get(key, 0) or 0)
        return agg

    # -- health -------------------------------------------------------------

    def health(self) -> dict:
        checks: Dict[str, dict] = {}
        for kind, check in (("osd", "OSD_DOWN"), ("mon", "MON_DOWN")):
            down = self.down_daemons(kind)
            if down:
                checks[check] = {
                    "severity": "HEALTH_WARN",
                    "summary": f"{len(down)} {kind} daemons down or "
                               f"beacon-silent past "
                               f"{self.beacon_grace:g}s: "
                               + " ".join(down),
                }
        stale = self.stale_pgs()
        if stale:
            checks["PG_STALE"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(stale)} pg slices have stale reports "
                           "(primary not reporting)",
            }
        agg = self.totals()
        if agg["degraded"]:
            checks["PG_DEGRADED"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{agg['degraded']} objects degraded "
                           f"({agg['recovering']} rebuilding)",
            }
        if agg["misplaced"]:
            checks["OBJECT_MISPLACED"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{agg['misplaced']} objects misplaced",
            }
        if agg["scrub_errors"]:
            checks["OSD_SCRUB_ERRORS"] = {
                "severity": "HEALTH_ERR",
                "summary": f"{agg['scrub_errors']} scrub inconsistencies",
            }
        lagging = sorted(
            d.name for d in self.daemons.values()
            if d.lag_over >= self.lag_sustain
        )
        if lagging:
            checks["DAEMON_LAG"] = {
                "severity": "HEALTH_WARN",
                "summary": f"event-loop lag >= {self.lag_warn_ms:g}ms "
                           f"sustained on: " + " ".join(lagging),
            }
        folded = fold_health(checks)
        self._note_health_transitions(folded)
        return folded

    def _note_health_transitions(self, folded: dict) -> None:
        """Append health-state changes to the event log.  Health is
        computed lazily, so a transition lands on the first health read
        that observes it; repeated reads of the same state append
        nothing (idempotent by construction)."""
        checks = folded["checks"]
        cur = {name: chk["summary"] for name, chk in checks.items()}
        for name in sorted(set(cur) - set(self._health_prev)):
            sev = "ERR" if checks[name]["severity"] == "HEALTH_ERR" \
                else "WRN"
            self.clog.append(sev, f"{name}: {cur[name]}")
        for name in sorted(set(self._health_prev) - set(cur)):
            self.clog.append("INF", f"{name} cleared")
        self._health_prev = cur
        status = folded["status"]
        if status != self._status_prev:
            if self._status_prev is not None:
                self.clog.append(
                    "INF" if status == "HEALTH_OK" else "WRN",
                    f"cluster health {self._status_prev} -> {status}")
            self._status_prev = status

    # -- renderings ---------------------------------------------------------

    def dump(self) -> dict:
        now = self.clock()
        osds = {}
        for name, d in sorted(self.daemons.items()):
            osds[name] = {
                "kind": d.kind,
                "up": self.daemon_up(name, now),
                "beacon_age_s": round(now - d.last_beacon, 3)
                if d.last_beacon else None,
                "lag_ms": round(d.lag_ms, 3),
                "seq": d.seq,
                "store": d.stats.get("store"),
                "tier": d.stats.get("tier"),
                "ops_in_flight": d.stats.get("ops_in_flight"),
                "rates": {k: round(v, 3) for k, v in d.rates.items()},
            }
        return {
            "daemons": osds,
            "expected": sorted(self.expected),
            "down": self.down_daemons(),
            "pgs": {pool: {name: dict(entry)
                           for name, entry in by_daemon.items()}
                    for pool, by_daemon in self.pgs.items()},
            "pg_states": self.pg_states(),
            "totals": self.totals(),
            "io": self.io_rates(),
            "store": self.store_totals(),
            "health": self.health(),
            "reports_folded": self.reports_folded,
            "beacons_folded": self.beacons_folded,
        }

    def pg_stat(self) -> dict:
        """The ``ceph pg stat`` one-liner's data."""
        states = self.pg_states()
        agg = self.totals()
        return {
            "num_pg_slices": sum(states.values()),
            "by_state": states,
            "degraded": agg["degraded"],
            "misplaced": agg["misplaced"],
            "recovering": agg["recovering"],
            "io": self.io_rates(),
        }

    def status_text(self) -> str:
        """`ceph -s`-shaped plain text (rados_cli status renders it)."""
        health = self.health()
        states = self.pg_states()
        agg = self.totals()
        io = self.io_rates()
        store = self.store_totals()
        osd_names = [n for n in (set(self.expected) | set(self.daemons))
                     if n.startswith("osd.")]
        mon_names = [n for n in (set(self.expected) | set(self.daemons))
                     if n.startswith("mon.")]
        up_osds = [n for n in osd_names if self.daemon_up(n)]
        lines = ["  cluster:",
                 f"    health: {health['status']}"]
        for name, chk in sorted(health["checks"].items()):
            lines.append(f"            {name}: {chk['summary']}")
        lines.append("  services:")
        if mon_names:
            up_mons = [n for n in mon_names if self.daemon_up(n)]
            lines.append(f"    mon: {len(mon_names)} daemons, "
                         f"{len(up_mons)} up")
        lines.append(f"    osd: {len(osd_names)} osds: "
                     f"{len(up_osds)} up")
        lines.append("  data:")
        lines.append(f"    shards: {store['shards']} shard objects, "
                     f"{store['bytes']} bytes")
        pg_bits = ", ".join(f"{n} {state}"
                            for state, n in sorted(states.items()))
        lines.append(f"    pgs: {pg_bits or 'none reported'}")
        if agg["degraded"] or agg["misplaced"]:
            lines.append(f"    degraded: {agg['degraded']} objects; "
                         f"misplaced: {agg['misplaced']}")
        lines.append("  io:")
        lines.append(
            f"    client: {io['client_ops_per_sec']} op/s, "
            f"{io['client_wr_bytes_per_sec']} B/s wr, "
            f"{io['client_rd_bytes_per_sec']} B/s rd")
        lines.append(
            f"    recovery: {io['recovery_bytes_per_sec']} B/s")
        return "\n".join(lines) + "\n"

    def prometheus_text(self) -> str:
        """ONE cluster scrape aggregated from the per-daemon report
        series (the reference prometheus module reads the mgr's PGMap
        the same way -- daemons are never scraped individually)."""
        now = self.clock()
        lines = ["# HELP ceph_osd_up daemon liveness from beacon "
                 "staleness (wire-fed)",
                 "# TYPE ceph_osd_up gauge"]
        names = sorted(set(self.expected) | set(self.daemons))
        for name in names:
            if not name.startswith("osd."):
                continue
            lines.append(f'ceph_osd_up{{ceph_daemon="{name}"}} '
                         f"{1 if self.daemon_up(name, now) else 0}")
        lines += ["# HELP ceph_daemon_lag_ms sampled event-loop "
                  "sleep-drift EWMA per daemon",
                  "# TYPE ceph_daemon_lag_ms gauge"]
        for name, d in sorted(self.daemons.items()):
            lines.append(f'ceph_daemon_lag_ms{{ceph_daemon="{name}"}} '
                         f"{round(d.lag_ms, 3)}")
        lines += ["# HELP ceph_osd_bytes_used bytes stored per OSD "
                  "(incremental store totals)",
                  "# TYPE ceph_osd_bytes_used gauge",
                  "# HELP ceph_osd_num_shards shard objects per OSD",
                  "# TYPE ceph_osd_num_shards gauge"]
        for name, d in sorted(self.daemons.items()):
            store = d.stats.get("store")
            if store:
                lines.append(
                    f'ceph_osd_bytes_used{{ceph_daemon="{name}"}} '
                    f"{store.get('bytes', 0)}")
                lines.append(
                    f'ceph_osd_num_shards{{ceph_daemon="{name}"}} '
                    f"{store.get('objects', 0)}")
        agg = self.totals()
        lines += [
            "# HELP ceph_degraded_objects objects with missing/stale "
            "copies (incremental per-PG counters, wire-fed)",
            "# TYPE ceph_degraded_objects gauge",
            f"ceph_degraded_objects {agg['degraded']}",
            "# HELP ceph_misplaced_objects objects whose copies live "
            "on non-acting OSDs",
            "# TYPE ceph_misplaced_objects gauge",
            f"ceph_misplaced_objects {agg['misplaced']}",
        ]
        for pool, by_daemon in sorted(self.pgs.items()):
            for name, entry in sorted(by_daemon.items()):
                lines.append(
                    f'ceph_pg_degraded{{pool="{pool}",'
                    f'ceph_daemon="{name}"}} '
                    f"{entry.get('degraded', 0)}")
        io = self.io_rates()
        lines += [
            "# HELP ceph_client_ops_per_sec cluster client op rate "
            "(consecutive-report deltas)",
            "# TYPE ceph_client_ops_per_sec gauge",
            f"ceph_client_ops_per_sec {io['client_ops_per_sec']}",
            "# HELP ceph_client_bytes_per_sec cluster client "
            "throughput by direction",
            "# TYPE ceph_client_bytes_per_sec gauge",
            f'ceph_client_bytes_per_sec{{direction="wr"}} '
            f"{io['client_wr_bytes_per_sec']}",
            f'ceph_client_bytes_per_sec{{direction="rd"}} '
            f"{io['client_rd_bytes_per_sec']}",
            "# HELP ceph_recovery_bytes_per_sec cluster rebuild "
            "throughput",
            "# TYPE ceph_recovery_bytes_per_sec gauge",
            f"ceph_recovery_bytes_per_sec "
            f"{io['recovery_bytes_per_sec']}",
        ]
        # elastic-membership migration traffic: bytes re-pushed because
        # the copy sat on a non-acting osd (expansion/contraction
        # backfill), distinct from rebuild bytes after data loss
        lines += [
            "# HELP ceph_osd_backfill_bytes_moved_total bytes migrated "
            "by backfill to re-placed acting positions (wire-fed)",
            "# TYPE ceph_osd_backfill_bytes_moved_total counter",
        ]
        for name, d in sorted(self.daemons.items()):
            moved = (d.stats.get("perf") or {}).get(
                "recovery_backfill_bytes")
            if isinstance(moved, (int, float)):
                lines.append(
                    f'ceph_osd_backfill_bytes_moved_total{{'
                    f'ceph_daemon="{name}"}} {moved}')
        # per-daemon perf counters, flattened (the report-schema slice)
        lines += ["# HELP ceph_osd_perf per-daemon perf counters "
                  "(report-schema slice)",
                  "# TYPE ceph_osd_perf counter"]
        for name, d in sorted(self.daemons.items()):
            for counter, value in sorted(
                    (d.stats.get("perf") or {}).items()):
                if isinstance(value, (int, float)):
                    lines.append(
                        f'ceph_osd_perf{{ceph_daemon="{name}",'
                        f'counter="{counter}"}} {value}')
        lines.extend(self._histogram_lines())
        lines.extend(self._profile_lines())
        return "\n".join(lines) + "\n"

    def _profile_lines(self) -> List[str]:
        """Wire-fed wire-tax profiler exposition: per-daemon per-stage
        cumulative seconds from the report frames' ``profile`` slice
        (daemons with profiling off ship no slice and render nothing)."""
        lines: List[str] = []
        rows = []
        for name, d in sorted(self.daemons.items()):
            prof = d.stats.get("profile")
            if not isinstance(prof, dict):
                continue
            for stage, ns in sorted((prof.get("stages") or {}).items()):
                if isinstance(ns, (int, float)):
                    rows.append((name, stage, ns))
        if not rows:
            return lines
        lines += [
            "# HELP ceph_profile_stage_seconds_total exclusive seconds "
            "per wire-tax profiler stage (wire-fed report slice)",
            "# TYPE ceph_profile_stage_seconds_total counter",
        ]
        for name, stage, ns in rows:
            lines.append(
                f'ceph_profile_stage_seconds_total{{'
                f'ceph_daemon="{name}",stage="{stage}"}} '
                f"{ns / 1e9:.6f}")
        return lines

    def _histogram_lines(self) -> List[str]:
        """Reported histogram marginals as real prometheus histogram
        series, family-grouped like utils/perf.py's in-process
        renderer (``osd.N.stage`` -> family ``ceph_hist_stage`` with a
        ceph_daemon label)."""
        families: Dict[str, List[tuple]] = {}
        for name, d in sorted(self.daemons.items()):
            for hname, h in sorted((d.stats.get("hist") or {}).items()):
                parts = hname.split(".")
                if len(parts) >= 3 and parts[0] == "osd" and \
                        parts[1].isdigit():
                    daemon = f"{parts[0]}.{parts[1]}"
                    family = ".".join(parts[2:])
                elif len(parts) >= 2:
                    daemon, family = parts[0], ".".join(parts[1:])
                else:
                    daemon, family = name, hname
                metric = "ceph_hist_" + "".join(
                    c if c.isalnum() else "_" for c in family)
                families.setdefault(metric, []).append((daemon, h))
        lines: List[str] = []
        for metric in sorted(families):
            lines.append(f"# HELP {metric} per-stage latency histogram "
                         "(wire-fed marginal)")
            lines.append(f"# TYPE {metric} histogram")
            for daemon, h in families[metric]:
                marginal = list(h.get("marginal") or ())
                bounds = list(h.get("bounds") or ())
                cum = 0
                for ub, count in zip(bounds, marginal):
                    cum += count
                    lines.append(
                        f'{metric}_bucket{{ceph_daemon="{daemon}",'
                        f'le="{ub}"}} {cum}')
                cum += sum(marginal[len(bounds):])
                lines.append(
                    f'{metric}_bucket{{ceph_daemon="{daemon}",'
                    f'le="+Inf"}} {cum}')
                lines.append(f'{metric}_sum{{ceph_daemon="{daemon}"}} '
                             f"{h.get('sum', 0)}")
                lines.append(
                    f'{metric}_count{{ceph_daemon="{daemon}"}} '
                    f"{h.get('count', 0)}")
        return lines


class MgrServer:
    """One mgr daemon: a messenger entity folding beacon/report frames
    into a PGMap, plus the HTTP endpoint (the MgrDaemon shape, wire-fed).
    """

    def __init__(self, name: str, messenger, addr_map=None,
                 http_host: str = "127.0.0.1", http_port: int = 0,
                 clock=None):
        self.name = name
        self.messenger = messenger
        expected = [k for k in (addr_map or {})
                    if k.startswith(("osd.", "mon."))]
        self.pgmap = PGMap(expected=expected, clock=clock)
        self.http_host = http_host
        self.http_port = http_port
        self._server: Optional[asyncio.AbstractServer] = None
        messenger.register(name, self.dispatch)

    async def dispatch(self, src: str, msg) -> None:
        self.pgmap.apply(msg)

    # -- HTTP ---------------------------------------------------------------

    async def start_http(self) -> int:
        self._server = await asyncio.start_server(
            self._serve, self.http_host, self.http_port)
        self.http_port = self._server.sockets[0].getsockname()[1]
        return self.http_port

    async def stop(self) -> None:
        # claim-then-await: the attribute is cleared BEFORE the yield so
        # a concurrent stop() cannot double-close (asyncsan rmw rule)
        server, self._server = self._server, None
        if server is not None:
            server.close()
            await server.wait_closed()

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        try:
            request = await reader.readline()
            while True:  # drain headers
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
            path = request.split()[1].decode() if request.split() else "/"
            if path == "/metrics":
                body = self.pgmap.prometheus_text()
                ctype, code = "text/plain; version=0.0.4", "200 OK"
            elif path == "/health":
                import json

                body = json.dumps(self.pgmap.health())
                ctype, code = "application/json", "200 OK"
            elif path == "/status":
                import json

                body = json.dumps(self.pgmap.dump())
                ctype, code = "application/json", "200 OK"
            else:
                body, ctype, code = ("not found\n", "text/plain",
                                     "404 Not Found")
            data = body.encode()
            writer.write(
                f"HTTP/1.1 {code}\r\nContent-Type: {ctype}\r\n"
                f"Content-Length: {len(data)}\r\n"
                "Connection: close\r\n\r\n".encode() + data
            )
            await writer.drain()
        finally:
            writer.close()
