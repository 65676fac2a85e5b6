"""Cluster state aggregation, health checks, prometheus exposition.

Port of ``ceph_tpu/mgr/mgr.py``.  The exposition differs from the JAX
package's in two series, both because the port's ledgers differ:

* ``ceph_library_builds_total`` stands where the JAX package has
  ``ceph_jit_retraces_total``: the port's residency ledger counts kernel
  libraries built or first loaded (``analysis/residency.py``), where the
  JAX package counts XLA compilations;
* ``ceph_wire_codec_native`` is left out: it reports the native wire
  codec, which the port does not have yet (ROADMAP.md queue 1 item 16b).

The JAX package guards each exposition section with ``except Exception:
pass``.  Every section here reads a port module that is always present,
so none is guarded: a broken ledger read fails the scrape instead of
dropping its series.
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional


class ClusterState:
    """Aggregated cluster view (PGMap / DaemonStateIndex role).

    Round-18 contract: every per-scrape read here is O(daemons +
    degraded), NEVER O(objects).  Store totals come from the object
    stores' incremental counters, degraded accounting from the per-PG
    ``pg_stats`` trackers maintained at the mutation / liveness /
    recovery seams (osd/pg_stats.py).  The old full-object census
    survives only behind ``degraded_objects(deep=True)`` as the verify
    path (``rados_cli health detail --deep`` role)."""

    def __init__(self, cluster):
        self.cluster = cluster  # ECCluster

    def osd_stats(self) -> Dict[str, dict]:
        out = {}
        for osd in self.cluster.osds:
            store_stats = osd.store.stats()
            tier = getattr(osd, "tier", None)
            out[osd.name] = {
                "up": not self.cluster.messenger.is_down(osd.name),
                "num_shards": store_stats["objects"],
                "bytes_used": store_stats["bytes"],
                "perf": osd.perf.snapshot(),
                "ops_in_flight": osd.optracker.num_inflight(),
                # device cache-tier residency (budget + hit/miss ride
                # along so /metrics can expose them as gauges)
                "tier": tier.status() if tier is not None else None,
            }
        return out

    def pool_stats(self) -> dict:
        b = self.cluster.backend
        shards = metas = 0
        for osd in self.cluster.osds:
            st = osd.store.stats()
            shards += st["shards"]
            metas += st["metas"]
        ec = self.cluster.ec
        km = b.km or 1
        return {
            # shard-derived estimate: every logical object stores km
            # shard copies (EC chunks or full replicas) and a meta twin
            # replicates km ways, so distinct objects ~= shards/km +
            # metas/km.  An object holding BOTH data and omap counts
            # twice here -- the honest price of never walking stores on
            # the scrape path (the exact census is degraded-path-only,
            # behind deep=True).
            "num_objects": shards // km + metas // km,
            "k": (km if ec is None else ec.get_data_chunk_count()),
            "m": (0 if ec is None
                  else ec.get_chunk_count() - ec.get_data_chunk_count()),
            "client_perf": b.perf.snapshot(),
        }

    def degraded_objects(self, deep: bool = False) -> List[str]:
        """Objects currently degraded (the PG_DEGRADED accounting role).

        Default: union of the hosted engines' incremental pg_stats
        sets -- O(degraded) per call.  ``deep=True`` runs the original
        full acting-set scan over every stored object as an audit/verify
        pass (O(objects x shards); never on the scrape path)."""
        if not deep:
            out: set = set()
            for osd in self.cluster.osds:
                for backend in osd.pools.values():
                    out |= backend.pg_stats.degraded_oids()
            return sorted(out)
        b = self.cluster.backend
        degraded = []
        oids = sorted({
            soid.rsplit("@", 1)[0]
            for osd in self.cluster.osds
            for soid in osd.store.list_objects()
        })
        for oid in oids:
            if oid.endswith("@meta"):
                continue
            acting = b.acting_set(oid)
            if any(not b._shard_up(acting, s) for s in range(b.km)):
                degraded.append(oid)
        return degraded

    def scrub_inconsistent(self) -> List[str]:
        """Objects whose last deep scrub found inconsistencies and which
        have not yet re-scrubbed clean (ScrubStore aggregation role)."""
        out = set()
        for osd in self.cluster.osds:
            for backend in osd.pools.values():
                out.update(backend.scrub_errors)
        return sorted(out)

    def dump(self) -> dict:
        osds = self.osd_stats()
        n_up = sum(1 for s in osds.values() if s["up"])
        return {
            "osdmap": {"num_osds": len(osds), "num_up_osds": n_up},
            "osd_stats": osds,
            "pools": self.pool_stats(),
            "degraded_objects": self.degraded_objects(),
            "scrub_inconsistent": self.scrub_inconsistent(),
        }


def health_checks(state: dict) -> dict:
    """Health evaluation (src/mon/health_check.h severities)."""
    checks = {}
    osdmap = state["osdmap"]
    down = osdmap["num_osds"] - osdmap["num_up_osds"]
    if down:
        checks["OSD_DOWN"] = {
            "severity": "HEALTH_WARN",
            "summary": f"{down} osds down",
        }
    degraded = state["degraded_objects"]
    if degraded:
        checks["PG_DEGRADED"] = {
            "severity": "HEALTH_WARN",
            "summary":
                f"{len(degraded)} objects have shards on down OSDs",
        }
    inconsistent = state.get("scrub_inconsistent") or []
    if inconsistent:
        checks["OSD_SCRUB_ERRORS"] = {
            "severity": "HEALTH_ERR",
            "summary":
                f"{len(inconsistent)} objects have scrub inconsistencies",
        }
    from ceph_tpu_torch.mgr.pgmap import fold_health

    return fold_health(checks)


def prometheus_text(state: dict) -> str:
    """Prometheus exposition (pybind/mgr/prometheus module role)."""
    lines = [
        "# HELP ceph_osd_up OSD liveness",
        "# TYPE ceph_osd_up gauge",
    ]
    for name, s in sorted(state["osd_stats"].items()):
        osd_id = name.split(".")[1]
        lines.append(f'ceph_osd_up{{ceph_daemon="{name}"}} '
                     f"{1 if s['up'] else 0}")
    lines += ["# HELP ceph_osd_bytes_used bytes stored per OSD",
              "# TYPE ceph_osd_bytes_used gauge"]
    for name, s in sorted(state["osd_stats"].items()):
        lines.append(f'ceph_osd_bytes_used{{ceph_daemon="{name}"}} '
                     f"{s['bytes_used']}")
    lines += ["# HELP ceph_osd_num_shards shard objects per OSD",
              "# TYPE ceph_osd_num_shards gauge"]
    for name, s in sorted(state["osd_stats"].items()):
        lines.append(f'ceph_osd_num_shards{{ceph_daemon="{name}"}} '
                     f"{s['num_shards']}")
    lines += ["# HELP ceph_osd_tier_resident_bytes device-resident "
              "cache-tier bytes per OSD",
              "# TYPE ceph_osd_tier_resident_bytes gauge"]
    for name, s in sorted(state["osd_stats"].items()):
        tier = s.get("tier")
        if tier is not None:
            lines.append(
                f'ceph_osd_tier_resident_bytes{{ceph_daemon="{name}"}} '
                f"{tier['resident_bytes']}")
    lines += ["# HELP ceph_osd_tier_hbm_budget_bytes device byte budget "
              "(osd_tier_hbm_bytes)",
              "# TYPE ceph_osd_tier_hbm_budget_bytes gauge"]
    for name, s in sorted(state["osd_stats"].items()):
        tier = s.get("tier")
        if tier is not None:
            lines.append(
                f'ceph_osd_tier_hbm_budget_bytes{{ceph_daemon="{name}"}} '
                f"{tier['budget']}")
    # exactly-once / client-retry health (docs/resilience.md): replayed
    # ops answered from the PG log, client resends, and PG backoffs --
    # the triple that separates "failover is invisible" from "clients
    # are lying or spinning"
    lines += ["# HELP ceph_osd_dup_op_hit replayed client ops answered "
              "from the PG log dup entries",
              "# TYPE ceph_osd_dup_op_hit counter"]
    for name, s in sorted(state["osd_stats"].items()):
        lines.append(f'ceph_osd_dup_op_hit{{ceph_daemon="{name}"}} '
                     f"{s['perf'].get('dup_op_hit', 0)}")
    # background data plane health (osd/recovery.py): batched rebuild
    # volume, scrub cursor progress, throttle preemptions, and the
    # promote-on-recovery proof counter -- a rebuild storm that starves
    # clients shows up here as recovery_bytes rising with
    # recovery_preempted flat (the throttle not engaging)
    for counter, help_text in (
        ("recovery_bytes", "bytes re-pushed by shard recovery"),
        ("recovery_ops_batched",
         "objects rebuilt through the batched recovery coalescer"),
        ("scrub_chunks",
         "batched deep-scrub read-cursor rounds issued"),
        ("recovery_preempted",
         "background batches that backed off for client traffic"),
        ("tier_promote_from_recovery",
         "rebuilt objects landed hot in the device tier by "
         "promote-on-recovery"),
    ):
        lines += [f"# HELP ceph_osd_{counter} {help_text}",
                  f"# TYPE ceph_osd_{counter} counter"]
        for name, s in sorted(state["osd_stats"].items()):
            lines.append(f'ceph_osd_{counter}{{ceph_daemon="{name}"}} '
                         f"{s['perf'].get(counter, 0)}")
    # repair-bandwidth win of the sub-extent/regenerating gather
    # (docs/ec-regenerating.md): classic-gather bytes minus what the
    # coalescer actually read; flat-at-zero on pools whose codec only
    # speaks whole-shard plans
    lines += ["# HELP ceph_osd_recovery_bytes_saved_total gather bytes "
              "avoided by sub-extent/regenerating repair plans",
              "# TYPE ceph_osd_recovery_bytes_saved_total counter"]
    for name, s in sorted(state["osd_stats"].items()):
        lines.append(
            f'ceph_osd_recovery_bytes_saved_total{{ceph_daemon="{name}"}} '
            f"{s['perf'].get('recovery_bytes_saved', 0)}")
    # unified QoS admission (osd/qos.py, docs/qos.md): per-class
    # admitted ops/bytes and throttle waits (client classes counted per
    # op, recovery/scrub per batch), plus the load-generator-published
    # per-class fairness spread (max/min achieved per-client throughput
    # within the class; 1.0 = perfectly fair)
    qos_rows = {"ops": [], "bytes": [], "throttle_waits": []}
    for name, s in sorted(state["osd_stats"].items()):
        for counter, value in sorted(s["perf"].items()):
            if not counter.startswith("qos_") or \
                    not isinstance(value, (int, float)):
                continue
            for suffix in ("throttle_waits", "bytes", "ops"):
                if counter.endswith(f"_{suffix}"):
                    klass = counter[len("qos_"):-len(suffix) - 1]
                    if klass:
                        qos_rows[suffix].append((name, klass, value))
                    break
    for suffix, help_text in (
        ("ops", "batches/ops admitted per QoS class"),
        ("bytes", "stripe bytes admitted per QoS class"),
        ("throttle_waits",
         "admissions that waited for a dmClock grant per QoS class"),
    ):
        if not qos_rows[suffix]:
            continue
        lines += [f"# HELP ceph_qos_class_{suffix} {help_text}",
                  f"# TYPE ceph_qos_class_{suffix} counter"]
        for name, klass, value in qos_rows[suffix]:
            lines.append(
                f'ceph_qos_class_{suffix}{{ceph_daemon="{name}",'
                f'qos_class="{klass}"}} {value}')
    from ceph_tpu_torch.osd import qos as _qos_mod

    spreads = _qos_mod.fairness_spreads()
    if spreads:
        lines += [
            "# HELP ceph_qos_fairness_spread max/min achieved "
            "per-client throughput within a QoS class (loadgen-"
            "published; 1.0 = perfectly fair)",
            "# TYPE ceph_qos_fairness_spread gauge",
        ]
        for klass in sorted(spreads):
            lines.append(
                f'ceph_qos_fairness_spread{{qos_class="{klass}"}} '
                f"{spreads[klass]}")
    client_perf = state["pools"].get("client_perf", {})
    for counter in ("op_resend", "backoff_received"):
        lines += [f"# HELP ceph_client_{counter} client-side {counter} "
                  "events (Objecter retry/backoff path)",
                  f"# TYPE ceph_client_{counter} counter",
                  f"ceph_client_{counter} "
                  f"{client_perf.get(counter, 0)}"]
    # device-residency health (analysis/residency.py): transfers the
    # storage layer performed through the counted seams and kernel
    # libraries built.  Process-global (all in-process daemons share the
    # one device), so these carry no ceph_daemon label -- a rising
    # library_builds under steady traffic means a hot path builds or
    # loads a library; a rising d2h on the write path means residency
    # broke.  (The JAX package also exposes ceph_wire_codec_native here,
    # the native wire codec's gauge; the port gets that codec with
    # ROADMAP.md queue 1 item 16b.)
    from ceph_tpu_torch.analysis import residency as _residency
    from ceph_tpu_torch.parallel import mesh_plane as _mesh_mod

    rc = _residency.counters().snapshot()
    lines += [
        "# HELP ceph_library_builds_total kernel libraries built or "
        "first loaded in the process (the JAX package counts XLA "
        "compilations as ceph_jit_retraces_total)",
        "# TYPE ceph_library_builds_total counter",
        f"ceph_library_builds_total {rc['library_builds']}",
        "# HELP ceph_transfer_bytes_total bytes moved through the "
        "storage layer's counted transfer seams",
        "# TYPE ceph_transfer_bytes_total counter",
        f'ceph_transfer_bytes_total{{direction="h2d"}} '
        f"{rc['h2d_bytes']}",
        f'ceph_transfer_bytes_total{{direction="d2h"}} '
        f"{rc['d2h_bytes']}",
        "# HELP ceph_transfer_ops_total transfer operations through "
        "the counted seams",
        "# TYPE ceph_transfer_ops_total counter",
        f'ceph_transfer_ops_total{{direction="h2d"}} '
        f"{rc['h2d_ops']}",
        f'ceph_transfer_ops_total{{direction="d2h"}} '
        f"{rc['d2h_ops']}",
    ]
    # per-mesh-axis sharded-dispatch ledger (the mesh data plane)
    axes = sorted(k[len("mesh_"):-len("_bytes")] for k in rc
                  if k.startswith("mesh_") and k.endswith("_bytes"))
    if axes:
        lines += [
            "# HELP ceph_mesh_dispatch_bytes_total bytes placed "
            "along each mesh axis by sharded dispatches",
            "# TYPE ceph_mesh_dispatch_bytes_total counter",
        ]
        for ax in axes:
            lines.append(
                f'ceph_mesh_dispatch_bytes_total{{axis="{ax}"}} '
                f"{rc[f'mesh_{ax}_bytes']}")
    plane = _mesh_mod.current_plane()
    if plane is not None:
        lines += [
            "# HELP ceph_mesh_wire_bytes_avoided_total chunk bytes "
            "delivered in-collective instead of over the wire",
            "# TYPE ceph_mesh_wire_bytes_avoided_total counter",
            f"ceph_mesh_wire_bytes_avoided_total "
            f"{plane.counters['mesh_wire_bytes_avoided']}",
        ]
    # observability plane (utils/trace.py + optracker): slow ops per
    # daemon, trace collector health, and every registered
    # PerfHistogram as REAL prometheus histogram series
    # (_bucket/_sum/_count over the latency marginal) -- the per-stage
    # queue-wait / dispatch / wire-rtt / ack-lag / tier hit-vs-miss
    # attribution
    lines += ["# HELP ceph_osd_slow_ops ops slower than "
              "osd_op_complaint_time (slow-op forensics)",
              "# TYPE ceph_osd_slow_ops counter"]
    for name, s in sorted(state["osd_stats"].items()):
        lines.append(f'ceph_osd_slow_ops{{ceph_daemon="{name}"}} '
                     f"{s['perf'].get('slow_ops', 0)}")
    from ceph_tpu_torch.utils import trace as _trace
    from ceph_tpu_torch.utils.perf import histograms_prometheus_text

    ts = _trace.status()
    lines += [
        "# HELP ceph_trace_spans_finished finished trace spans "
        "collected (bounded ring)",
        "# TYPE ceph_trace_spans_finished counter",
        f"ceph_trace_spans_finished {ts['finished']}",
        "# HELP ceph_trace_spans_dropped finished spans dropped "
        "past the trace_keep ring bound",
        "# TYPE ceph_trace_spans_dropped counter",
        f"ceph_trace_spans_dropped {ts['dropped']}",
        "# HELP ceph_trace_spans_unfinished started-but-unfinished "
        "spans right now (a leak detector: quiesced == 0)",
        "# TYPE ceph_trace_spans_unfinished gauge",
        f"ceph_trace_spans_unfinished {ts['unfinished']}",
    ]
    hist_text = histograms_prometheus_text()
    if hist_text:
        lines.append(hist_text)
    # stage-profiler cost centers (ceph_tpu_torch/profiling/): empty
    # string when profile_mode is off
    from ceph_tpu_torch import profiling as _profiling

    prof_text = _profiling.prometheus_text()
    if prof_text:
        lines.append(prof_text)
    lines += ["# HELP ceph_pool_objects logical objects in the pool",
              "# TYPE ceph_pool_objects gauge",
              f"ceph_pool_objects {state['pools']['num_objects']}",
              "# HELP ceph_degraded_objects objects with shards on down "
              "OSDs",
              "# TYPE ceph_degraded_objects gauge",
              f"ceph_degraded_objects {len(state['degraded_objects'])}"]
    # per-daemon perf counters, flattened
    lines += ["# HELP ceph_osd_perf per-OSD perf counters",
              "# TYPE ceph_osd_perf counter"]
    for name, s in sorted(state["osd_stats"].items()):
        for counter, value in sorted(s["perf"].items()):
            if isinstance(value, (int, float)):
                lines.append(
                    f'ceph_osd_perf{{ceph_daemon="{name}",'
                    f'counter="{counter}"}} {value}'
                )
    return "\n".join(lines) + "\n"


class MgrDaemon:
    """HTTP endpoint: /metrics (prometheus), /health, /status (JSON)."""

    def __init__(self, cluster, host: str = "127.0.0.1", port: int = 0,
                 registry=None):
        self.state = ClusterState(cluster)
        if registry is None:
            from ceph_tpu_torch.mgr.module_host import PyModuleRegistry

            registry = PyModuleRegistry(cluster)
        self.registry = registry
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> int:
        self._server = await asyncio.start_server(
            self._serve, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        # host the modules: serve() loops + map-change notifications
        # (ActivePyModules lifecycle; the reference notifies modules on
        # every map/health epoch -- polled here, the in-process cluster
        # has no mgr subscription channel)
        self.registry.start()
        self._notify_task = asyncio.get_event_loop().create_task(
            self._notify_loop()
        )
        return self.port

    async def _notify_loop(self, interval: float = 1.0) -> None:
        last_up = None
        while True:
            up = tuple(
                not self.state.cluster.messenger.is_down(o.name)
                for o in self.state.cluster.osds
            )
            if up != last_up:
                last_up = up
                self.registry.notify_all("osd_map")
            await asyncio.sleep(interval)

    async def stop(self) -> None:
        task = getattr(self, "_notify_task", None)
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        await self.registry.stop()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

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
                # served BY the prometheus module through the host surface
                prom = self.registry.modules.get("prometheus")
                body = (prom.metrics() if prom is not None
                        else prometheus_text(self.state.dump()))
                ctype = "text/plain; version=0.0.4"
                code = "200 OK"
            elif path == "/health":
                import json

                body = json.dumps(self.registry.gather_health())
                ctype = "application/json"
                code = "200 OK"
            elif path == "/status":
                import json

                body = json.dumps(self.state.dump())
                ctype = "application/json"
                code = "200 OK"
            else:
                body, ctype, code = "not found\n", "text/plain", "404 Not Found"
            data = body.encode()
            writer.write(
                f"HTTP/1.1 {code}\r\nContent-Type: {ctype}\r\n"
                f"Content-Length: {len(data)}\r\n"
                "Connection: close\r\n\r\n".encode() + data
            )
            await writer.drain()
        finally:
            writer.close()
