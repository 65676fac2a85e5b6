"""Telemetry-plane benchmark stage + the wire-fed chaos health gate.

Port of ``ceph_tpu/mgr/telemetry_bench.py``: the same stages and gates.
Every pool runs on ``profile`` (default the ``cuda`` plugin, on the
card; the JAX package's are ``jerasure`` on the host), and
``profile={"device": "cpu"}`` runs it on the CPU.  The port names no JAX
variable for itself or its daemons: the daemons of the vstart smoke run
their pool's chunk math where its profile puts it.

The shippability contract, three parts:

1. **Overhead** -- the MgrClient report loop (beacon + MgrReport frames
   at tightened intervals, per-PG stats + perf slice + histogram
   marginals per frame) must cost <= ``overhead_limit_pct`` on the
   storage-path workload vs reports-off.  Modes run interleaved
   best-of-iters (the trace-bench discipline) and the gate retries
   against scheduler noise before failing.
2. **Scrape-parse roundtrip** -- the aggregated mgr exposition is
   parsed back as prometheus text and ``ceph_degraded_objects`` plus
   the io-rate series must equal the PGMap's own numbers (the
   exposition is an artifact, not a printf).
3. **Chaos health gate** -- a loadgen scenario with a mid-run OSD wipe
   under concurrent client load (telemetry=True: a real mgr endpoint
   fed over real TCP) must show PG_DEGRADED with a NONZERO degraded
   count that drains monotonically (bounded transient upticks from
   concurrent writes) back to HEALTH_OK once the batched recovery
   plane finishes.

``--vstart-smoke`` runs the whole story against REAL PROCESSES:
``tools/vstart`` boots OSD + mgr daemons, an OSD is killed and revived
empty (the replacement-disk wipe), and the degraded->clean transition
is asserted end-to-end from the mgr's admin socket.

Used by ``ceph_tpu_torch/tools/ec_benchmark.py --workload
telemetry-path``, ``chip_smoke.py`` phase 3n and
tests/test_torch_telemetry.py (smoke shape, loose limit).
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, List, Optional

_MODES = ("off", "on")


def _cfg():
    from ceph_tpu_torch.utils.config import get_config

    return get_config()


async def _cluster_cycle(cluster, payloads: Dict[str, bytes],
                         writers: int) -> float:
    """One timed storage-path cycle: concurrent writes then verified
    concurrent reads through the in-process cluster."""
    sem = asyncio.Semaphore(writers)

    async def put(oid, data):
        async with sem:
            await cluster.write(oid, data)

    async def get(oid):
        async with sem:
            return oid, await cluster.read(oid)

    t0 = time.perf_counter()
    await asyncio.gather(*(put(o, d) for o, d in payloads.items()))
    got = dict(await asyncio.gather(*(get(o) for o in payloads)))
    dt = time.perf_counter() - t0
    for oid, data in payloads.items():
        if got.get(oid) != data:
            raise AssertionError(
                f"telemetry-path: read-back of {oid} mismatched")
    return dt


async def _overhead_stage(n_osds: int, k: int, m: int,
                          payloads: Dict[str, bytes], writers: int,
                          iters: int, profile: Dict[str, str]) -> dict:
    """Interleaved off/on cycles over ONE cluster pair; returns per-mode
    best times + the folded-report evidence + the scrape roundtrip."""
    from ceph_tpu_torch.mgr.pgmap import PGMap
    from ceph_tpu_torch.mgr.report import ReportSender
    from ceph_tpu_torch.osd.cluster import ECCluster

    prior = {key: _cfg().get_val(key)
             for key in ("mgr_beacon_interval", "mgr_report_interval")}
    # tighter than production defaults: the gate measures the loop's
    # cost at 5-10x its default duty cycle, so a pass here bounds the
    # default well under the limit
    _cfg().apply_changes({"mgr_beacon_interval": 0.05,
                          "mgr_report_interval": 0.1})
    try:
        clusters = {}
        senders: List = []
        pgmap = None
        for mode in _MODES:
            cluster = ECCluster(
                n_osds, dict({"k": str(k), "m": str(m)}, **profile))
            clusters[mode] = cluster
            if mode == "on":
                pgmap = PGMap(
                    expected=[o.name for o in cluster.osds])

                async def mgr_dispatch(src, msg, _pgmap=pgmap):
                    _pgmap.apply(msg)

                cluster.messenger.register("mgr.0", mgr_dispatch)
                for osd in cluster.osds:
                    sender = ReportSender(
                        osd.name, cluster.messenger,
                        osd.mgr_report_stats, ["mgr.0"], perf=osd.perf)
                    sender.start()
                    senders.append(sender)
        best: Dict[str, float] = {}
        for _ in range(iters):
            for mode in _MODES:
                dt = await _cluster_cycle(clusters[mode], payloads,
                                          writers)
                best[mode] = min(best.get(mode, dt), dt)
        # give the report loop one more interval so the folded map holds
        # the final state, then roundtrip the exposition
        await asyncio.sleep(0.25)
        assert pgmap.reports_folded > 0, \
            "telemetry-path: no reports folded in on-mode"
        scrape = _scrape_roundtrip(pgmap)
        for sender in senders:
            sender.stop()
        for cluster in clusters.values():
            await cluster.shutdown()
        return {"best": best, "reports_folded": pgmap.reports_folded,
                "beacons_folded": pgmap.beacons_folded,
                "scrape": scrape}
    finally:
        _cfg().apply_changes(prior)


def _parse_prometheus(text: str) -> Dict[str, float]:
    """series-name{labels} -> value for every sample line (the parse
    half of the roundtrip; raises on any malformed sample)."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        out[name] = float(value)  # ValueError = malformed exposition
    return out


def _scrape_roundtrip(pgmap) -> dict:
    """Parse the aggregated exposition and pin the headline series to
    the PGMap's own numbers."""
    samples = _parse_prometheus(pgmap.prometheus_text())
    degraded = samples.get("ceph_degraded_objects")
    ops_rate = samples.get("ceph_client_ops_per_sec")
    recovery_rate = samples.get("ceph_recovery_bytes_per_sec")
    totals = pgmap.totals()
    io = pgmap.io_rates()
    assert degraded == totals["degraded"], \
        (degraded, totals["degraded"])
    assert ops_rate == io["client_ops_per_sec"], \
        (ops_rate, io["client_ops_per_sec"])
    assert recovery_rate == io["recovery_bytes_per_sec"]
    return {"degraded": degraded, "client_ops_per_sec": ops_rate,
            "recovery_bytes_per_sec": recovery_rate,
            "series_parsed": len(samples)}


async def _chaos_stage(*, clients: int, duration_s: float,
                       n_osds: int, profile: Dict[str, str]) -> dict:
    """The wipe -> PG_DEGRADED -> monotone drain -> HEALTH_OK gate over
    real TCP with the report plane live."""
    from ceph_tpu_torch.loadgen.scenario import (ClientGroup, Scenario,
                                           run_scenario)

    scenario = Scenario(
        name="telemetry-chaos", duration_s=duration_s,
        groups=(ClientGroup(count=clients, profile="put8k"),),
        chaos=("rebuild",),
    )
    res = await run_scenario(
        scenario, n_osds=n_osds, k=2, m=1, telemetry=True,
        tuning={"osd_recovery_sleep": 0.05,
                "osd_recovery_batch_bytes": 64 << 10},
        profile=profile,
    )
    assert res.wipes >= 1, "chaos stage never wiped an OSD"
    assert res.degraded_max > 0, \
        "wipe raised no degraded count on the wire-fed map"
    assert res.degraded_final == 0, \
        f"degraded count never drained: {res.health_timeline[-5:]}"
    assert res.health_final == "HEALTH_OK", res.health_final
    assert res.degraded_monotonic_violations <= 2, (
        f"degraded drain not monotone "
        f"({res.degraded_monotonic_violations} upticks): "
        f"{[d for _, _, d in res.health_timeline]}")
    assert res.cas_exact, "exactly-once audit failed under the wipe"
    return {
        "clients": res.n_clients,
        "ops": res.ops,
        "wipes": res.wipes,
        "degraded_max": res.degraded_max,
        "degraded_monotonic_violations":
            res.degraded_monotonic_violations,
        "health_final": res.health_final,
        "drain_samples": len(res.health_timeline),
    }


def run_telemetry_bench(*, n_osds: int = 6, k: int = 2, m: int = 1,
                        n_objects: int = 48, obj_bytes: int = 16 << 10,
                        writers: int = 8, iters: int = 2,
                        overhead_limit_pct: float = 3.0,
                        overhead_retries: int = 3,
                        chaos_clients: int = 24,
                        chaos_duration_s: float = 6.0,
                        smoke: bool = False,
                        profile: Optional[Dict[str, str]] = None) -> dict:
    """The full stage; raises on any gate violation (the caller then
    reports the stage as failed instead of shipping a bad number).
    ``profile`` overlays every pool's k/m (the ``cuda`` plugin unless it
    names another)."""
    import numpy as np

    if smoke:
        n_objects, obj_bytes, iters = 16, 8 << 10, 1
        chaos_clients, chaos_duration_s = 12, 3.0
        overhead_limit_pct = max(overhead_limit_pct, 25.0)
    rng = np.random.RandomState(1812)
    payloads = {
        f"tel{i}": rng.randint(0, 256, size=obj_bytes,
                               dtype=np.uint8).tobytes()
        for i in range(n_objects)
    }
    total_bytes = sum(len(v) for v in payloads.values())

    async def main() -> dict:
        overhead_pct = None
        stage = None
        for attempt in range(overhead_retries):
            stage = await _overhead_stage(n_osds, k, m, payloads,
                                          writers, iters, profile)
            t_off, t_on = stage["best"]["off"], stage["best"]["on"]
            overhead_pct = (t_on - t_off) / t_off * 100.0
            if overhead_pct <= overhead_limit_pct:
                break
        assert overhead_pct is not None and \
            overhead_pct <= overhead_limit_pct, (
                f"report-loop overhead {overhead_pct:.1f}% > "
                f"{overhead_limit_pct}% after {overhead_retries} "
                "attempts")
        chaos = await _chaos_stage(clients=chaos_clients,
                                   duration_s=chaos_duration_s,
                                   n_osds=n_osds, profile=profile)
        gibps = {
            mode: round(
                2 * total_bytes / stage["best"][mode] / (1 << 30), 4)
            for mode in _MODES
        }
        return {
            "telemetry_overhead_pct": round(overhead_pct, 2),
            "overhead_limit_pct": overhead_limit_pct,
            "reports_off_GiBs": gibps["off"],
            "reports_on_GiBs": gibps["on"],
            "reports_folded": stage["reports_folded"],
            "beacons_folded": stage["beacons_folded"],
            "scrape": stage["scrape"],
            "chaos": chaos,
            "n_objects": n_objects,
            "obj_bytes": obj_bytes,
        }

    profile = dict(profile or {})
    return asyncio.new_event_loop().run_until_complete(main())


# -- the real-process CI smoke ----------------------------------------------


def run_vstart_smoke(run_dir: Optional[str] = None,
                     n_osds: int = 4, n_objects: int = 30,
                     obj_bytes: int = 16 << 10,
                     profile: Optional[Dict[str, str]] = None,
                     wait: float = 20.0) -> dict:
    """Boot a REAL multi-process cluster (``tools/vstart``: OSD + mgr
    daemons), prove HEALTH_OK arrives from wire-fed reports alone, wipe
    an OSD (SIGKILL + empty revive), and assert the
    OSD_DOWN -> PG_DEGRADED(>0, draining) -> HEALTH_OK transition from
    the mgr's admin socket.  ``profile`` overlays the pool's k=2 m=1 on
    ``cuda``; ``wait`` bounds the daemons' boot (a daemon on the card
    loads torch and makes a CUDA context first)."""
    import os
    import shutil
    import tempfile

    from ceph_tpu_torch.tools import vstart
    from ceph_tpu_torch.utils.admin_socket import admin_command

    pool = dict({"plugin": "cuda", "k": "2", "m": "1"}, **(profile or {}))
    tmp = run_dir or tempfile.mkdtemp(prefix="ceph-torch-tel-")
    # daemon processes inherit env: shrink the chaos time scale and
    # throttle the rebuild so the degraded drain is OBSERVABLE (several
    # report intervals long) instead of completing between two frames
    tuned = {
        "CEPH_TPU_TORCH_MGR_BEACON_INTERVAL": "0.1",
        "CEPH_TPU_TORCH_MGR_REPORT_INTERVAL": "0.2",
        "CEPH_TPU_TORCH_MGR_DAEMON_BEACON_GRACE": "1.5",
        "CEPH_TPU_TORCH_MGR_PG_STALE_GRACE": "3.0",
        "CEPH_TPU_TORCH_OSD_TICK_INTERVAL": "0.4",
        "CEPH_TPU_TORCH_OSD_RECOVERY_SLEEP": "0.1",
        "CEPH_TPU_TORCH_OSD_RECOVERY_BATCH_BYTES": str(48 << 10),
        "CEPH_TPU_TORCH_OSD_RECOVERY_MAX_ACTIVE": "1",
    }
    prior_env = {key: os.environ.get(key) for key in tuned}
    from ceph_tpu_torch.utils.config import get_config

    get_config()  # this process keeps its settings: made before the env
    os.environ.update(tuned)
    mgr_asok = os.path.join(tmp, "data", "mgr.0.asok")

    async def mgr_health() -> dict:
        return await admin_command(mgr_asok, "health")

    async def mgr_degraded() -> int:
        stat = await admin_command(mgr_asok, "pg stat")
        return int(stat["degraded"])

    async def wait_status(want: str, deadline_s: float,
                          check=None) -> None:
        deadline = time.time() + deadline_s
        last = None
        while time.time() < deadline:
            try:
                health = await mgr_health()
            except (OSError, ValueError):
                await asyncio.sleep(0.2)
                continue
            last = health
            if health["status"] == want and (
                    check is None or check(health)):
                return
            await asyncio.sleep(0.2)
        raise AssertionError(
            f"mgr never reached {want}: last {last}")

    async def drive() -> dict:
        from ceph_tpu_torch.daemon.client import RemoteClient

        client = await RemoteClient.connect(
            os.path.join(tmp, "addr_map.json"), pool)
        await client.probe_osds()
        for i in range(n_objects):
            await client.write(f"smoke{i}", bytes([i % 251]) * obj_bytes)
        await client.close()
        # wire-fed HEALTH_OK: every daemon beaconing, no degraded PGs
        await wait_status("HEALTH_OK", 20.0)
        # the wipe: SIGKILL, then an EMPTY revive (memstore daemons
        # lose their store -- replacement-disk semantics); the beacon
        # gap must surface as OSD_DOWN first
        vstart.kill_osd(tmp, 1)
        await wait_status(
            "HEALTH_WARN", 15.0,
            check=lambda h: "OSD_DOWN" in h["checks"])
        vstart.revive_osd(tmp, 1, wait=wait)
        # the revived incarnation forces peers onto the backfill path
        # (boot_id change): degraded must rise above zero, then drain
        series: List[int] = []
        deadline = time.time() + 90.0
        while time.time() < deadline:
            try:
                series.append(await mgr_degraded())
            except (OSError, ValueError):
                pass
            if series and series[-1] == 0 and max(series) > 0:
                health = await mgr_health()
                if health["status"] == "HEALTH_OK":
                    break
            await asyncio.sleep(0.15)
        assert series and max(series) > 0, (
            f"wipe never raised a degraded count: {series[-20:]}")
        assert series[-1] == 0, f"degraded never drained: {series[-20:]}"
        peak_at = series.index(max(series))
        upticks = sum(
            1 for a, b in zip(series[peak_at:], series[peak_at + 1:])
            if b > a)
        assert upticks <= 1, f"drain not monotone: {series[peak_at:]}"
        health = await mgr_health()
        assert health["status"] == "HEALTH_OK", health
        return {"degraded_series": series, "degraded_max": max(series),
                "upticks": upticks, "health_final": health["status"]}

    try:
        vstart.start_cluster(tmp, n_osds, pool, wait=wait)
        result = asyncio.new_event_loop().run_until_complete(drive())
    finally:
        try:
            vstart.stop_cluster(tmp)
        finally:
            for key, val in prior_env.items():
                if val is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = val
            if run_dir is None:
                shutil.rmtree(tmp, ignore_errors=True)
    return result


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="shrunk shapes, loose overhead limit")
    ap.add_argument("--vstart-smoke", action="store_true",
                    help="real-process end-to-end health gate")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the pools' chunk math runs")
    args = ap.parse_args(argv)
    profile = {"device": "cpu"} if args.device == "cpu" else None
    if args.vstart_smoke:
        result = run_vstart_smoke(profile=profile)
    else:
        result = run_telemetry_bench(smoke=args.smoke, profile=profile)
    json.dump(result, sys.stdout)
    print()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
