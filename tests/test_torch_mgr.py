"""The port's manager (``mgr/``: ``report.py``, ``pgmap.py``, ``mgr.py``,
``module_host.py``, ``mgr_modules/``) and ``OSDShard.mgr_report_stats``
against the JAX package's.

Each case of the JAX package's ``tests/test_mgr.py`` runs as the same
script through both packages in one process, over the same cluster
cycle: the JAX package's ``ECCluster`` on its default plugin
(``jerasure``, on the host), the port's on the ``cuda`` plugin with
``device=cpu``.  Compared exactly: ``ClusterState`` dumps, health checks
and their transitions, the HTTP endpoints' JSON, module command outputs,
balancer scores and weights, and ``PGMap.dump`` / ``pg_stat`` /
``status_text`` after folding the same reports.  A perf counter's timed
sum, a latency histogram's buckets and sum, and a daemon's random
``boot_id`` are times or nonces: they are compared by count or by name.

The ``prometheus_text`` series are compared name for name and value for
value, with these exceptions:

* the two named differences: the JAX package's
  ``ceph_jit_retraces_total`` is the port's ``ceph_library_builds_total``
  (its ledger counts kernel libraries, not XLA compilations), and the
  JAX package's ``ceph_wire_codec_native`` has no counterpart until the
  port has the native wire codec (ROADMAP.md queue 1 item 16b);
* the residency ledger's series (library builds, transfers, mesh bytes)
  hold each package's own process-wide transfer ledger, and the port's
  codec uploads where the JAX package's ``jerasure`` runs on the host, so
  each is compared with its own package's ledger at the scrape;
* the latency histograms' buckets and sums are times (their counts are
  compared).

Every test starts from cleared perf counters, histograms and trace
rings, and trace samplers rolled back to their start, in both packages.
"""

import asyncio
import json
import sys
import types

import numpy as np
import pytest

from ceph_tpu import mgr as j_mgr
from ceph_tpu.analysis import residency as j_residency
from ceph_tpu.mgr import module_host as j_module_host
from ceph_tpu.mgr import pgmap as j_pgmap
from ceph_tpu.mgr import report as j_report
from ceph_tpu.osd import cluster as j_cluster
from ceph_tpu.osd import messenger as j_messenger
from ceph_tpu.utils import config as j_config
from ceph_tpu.utils import trace as j_trace
from ceph_tpu.utils.perf import PerfCounters as JPerfCounters
from ceph_tpu_torch import mgr, profiling
from ceph_tpu_torch.analysis import residency
from ceph_tpu_torch.mgr import module_host, pgmap, report
from ceph_tpu_torch.osd import cluster, messenger
from ceph_tpu_torch.utils import config, trace
from ceph_tpu_torch.utils.perf import PerfCounters

PORT = types.SimpleNamespace(
    name="port", mgr=mgr, module_host=module_host, pgmap=pgmap,
    report=report, residency=residency, trace=trace, config=config,
    Messenger=messenger.Messenger, PerfCounters=PerfCounters,
    make=lambda n, prof: cluster.ECCluster(n, dict(prof, device="cpu")))
JAX = types.SimpleNamespace(
    name="jax", mgr=j_mgr, module_host=j_module_host, pgmap=j_pgmap,
    report=j_report, residency=j_residency, trace=j_trace, config=j_config,
    Messenger=j_messenger.Messenger, PerfCounters=JPerfCounters,
    make=lambda n, prof: j_cluster.ECCluster(n, dict(prof)))
BOTH = (PORT, JAX)
PROFILE = {"k": "2", "m": "1"}

#: the two exposition series that differ by design: the JAX package's
#: name -> the port's (None: the port has no counterpart yet)
RENAMED = {"ceph_jit_retraces_total": "ceph_library_builds_total",
           "ceph_wire_codec_native": None}
#: the residency ledger's families: process-wide, compared with each
#: package's own ledger
LEDGER_FAMILIES = ("ceph_library_builds_total", "ceph_transfer_bytes_total",
                   "ceph_transfer_ops_total", "ceph_mesh_dispatch_bytes_total",
                   "ceph_mesh_wire_bytes_avoided_total")


def _policy_runs_tasks() -> bool:
    """Whether the current event-loop policy's loops can run a task (the
    tier-1 conftest's atomic-section verifier cannot under Python 3.12)."""
    async def nothing():
        return None

    coro = nothing()
    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(coro)
        return True
    except TypeError:
        coro.close()
        return False
    finally:
        loop.close()


@pytest.fixture(autouse=True)
def _loop_policy():
    """Keep the conftest's verifying policy where it can run a task;
    where it cannot, both packages' loops run under asyncio's default
    policy."""
    if _policy_runs_tasks():
        yield
        return
    saved = asyncio.get_event_loop_policy()
    asyncio.set_event_loop_policy(asyncio.DefaultEventLoopPolicy())
    yield
    asyncio.set_event_loop_policy(saved)


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _fresh(P):
    """Cleared counters, histograms and trace ring, and the trace
    sampler's roll back at its start (``clear`` keeps the roll, so the
    root ops other tests ran in this process would otherwise decide
    which ops each package samples here)."""
    P.PerfCounters.reset_all()
    P.trace.clear()
    P.trace._sample_tick = 0


def _both(scenario, n_osds=6, profile=PROFILE):
    """``scenario(P, cluster, log)`` in each package on a fresh cluster;
    returns both logs (compared by the caller)."""
    logs = {}
    for P in BOTH:
        _fresh(P)
        log = []

        async def main(P=P, log=log):
            c = P.make(n_osds, profile)
            try:
                await scenario(P, c, log)
            finally:
                await c.shutdown()

        _run(main())
        logs[P.name] = log
    return logs


def _perf(snapshot: dict) -> dict:
    """A perf snapshot with each timed counter's sum (a time) dropped."""
    return {k: (v["avgcount"] if isinstance(v, dict) and "sum" in v else v)
            for k, v in snapshot.items()}


def _state(dump: dict) -> dict:
    """A ``ClusterState.dump`` with its timed sums dropped."""
    out = json.loads(json.dumps(dump))
    for s in out["osd_stats"].values():
        s["perf"] = _perf(s["perf"])
    out["pools"]["client_perf"] = _perf(out["pools"]["client_perf"])
    return out


def _series(text: str, P) -> dict:
    """Exposition sample lines as {series: value}: histogram buckets and
    sums (times) as None, the two renamed series under the port's name,
    and the ledger families checked against ``P``'s own ledger and then
    kept by name only."""
    rc = P.residency.counters().snapshot()
    own = {"ceph_library_builds_total": rc.get(
               "library_builds", rc.get("jit_retraces")),
           'ceph_transfer_bytes_total{direction="h2d"}': rc["h2d_bytes"],
           'ceph_transfer_bytes_total{direction="d2h"}': rc["d2h_bytes"],
           'ceph_transfer_ops_total{direction="h2d"}': rc["h2d_ops"],
           'ceph_transfer_ops_total{direction="d2h"}': rc["d2h_ops"]}
    own.update({f'ceph_mesh_dispatch_bytes_total{{axis="{k[5:-6]}"}}': v
                for k, v in rc.items()
                if k.startswith("mesh_") and k.endswith("_bytes")})
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        family = name.split("{")[0]
        if family in RENAMED:
            if RENAMED[family] is None:
                continue
            name = name.replace(family, RENAMED[family])
            family = RENAMED[family]
        if family in LEDGER_FAMILIES:
            if name in own:
                assert float(value) == own[name], (P.name, line)
            value = None
        elif family.startswith("ceph_hist_") and \
                not family.endswith("_count"):
            value = None
        out[name] = value
    return out


def _cycle_writes(rng):
    return {f"obj{i}": rng.randint(0, 256, 3000 + 997 * i,
                                   dtype=np.uint8).tobytes()
            for i in range(6)}


# -- ClusterState, health, exposition ----------------------------------------


def test_cluster_state_aggregates():
    payloads = _cycle_writes(np.random.RandomState(1))

    async def scenario(P, c, log):
        for oid, data in payloads.items():
            await c.write(oid, data)
        state = P.mgr.ClusterState(c).dump()
        log.append(_state(state))
        log.append(sum(s["bytes_used"] for s in state["osd_stats"].values()))

    logs = _both(scenario)
    assert logs["port"] == logs["jax"]
    state = logs["port"][0]
    assert state["osdmap"] == {"num_osds": 6, "num_up_osds": 6}
    assert state["pools"]["num_objects"] == 6
    assert state["degraded_objects"] == []
    assert logs["port"][1] > sum(map(len, payloads.values()))


def test_health_transitions_on_osd_down():
    async def scenario(P, c, log):
        await c.write("obj", b"z" * 4000)
        await c.write("obj2", b"y" * 9000)
        cs = P.mgr.ClusterState(c)
        log.append(P.mgr.health_checks(cs.dump()))
        acting = c.backend.acting_set("obj")
        c.kill_osd(acting[0])
        log.append(P.mgr.health_checks(cs.dump()))
        log.append(cs.degraded_objects())
        log.append(cs.degraded_objects(deep=True))
        c.revive_osd(acting[0])
        log.append(P.mgr.health_checks(cs.dump()))

    logs = _both(scenario)
    assert logs["port"] == logs["jax"]
    ok, down, degraded, deep, back = logs["port"]
    assert ok["status"] == back["status"] == "HEALTH_OK"
    assert down["status"] == "HEALTH_WARN"
    assert set(down["checks"]) == {"OSD_DOWN", "PG_DEGRADED"}
    assert degraded == deep and "obj" in degraded


def test_prometheus_text_shape():
    async def scenario(P, c, log):
        await c.write("obj", b"m" * 2000)
        await c.write("o2", b"q" * 20000)
        await c.read("o2")
        c.kill_osd(c.backend.acting_set("o2")[0])
        await c.read("o2")
        text = P.mgr.prometheus_text(P.mgr.ClusterState(c).dump())
        log.append(_series(text, P))
        log.append(text)

    logs = _both(scenario)
    mine, text = logs["port"]
    theirs, j_text = logs["jax"]
    assert mine == theirs
    assert 'ceph_osd_up{ceph_daemon="osd.0"} 1' in text
    assert "ceph_pool_objects 2" in text
    assert 'counter="sub_write"' in text
    # the two named differences, and nothing else renamed or dropped
    assert "ceph_library_builds_total " in text
    samples = [ln for ln in text.splitlines() if not ln.startswith("#")]
    assert not any(ln.startswith(("ceph_jit_retraces_total",
                                  "ceph_wire_codec_native"))
                   for ln in samples)
    assert "\nceph_jit_retraces_total " in j_text
    names = {ln.split()[2] for ln in text.splitlines()
             if ln.startswith("# TYPE")}
    j_names = {ln.split()[2] for ln in j_text.splitlines()
               if ln.startswith("# TYPE")}
    assert names ^ j_names == {"ceph_library_builds_total",
                               "ceph_jit_retraces_total",
                               "ceph_wire_codec_native"}


async def _http_get(port, path):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\n\r\n".encode())
    await writer.drain()
    data = await reader.read()
    writer.close()
    head, _, body = data.partition(b"\r\n\r\n")
    return head.decode().split("\r\n")[0], body.decode()


def test_mgr_http_endpoints():
    async def scenario(P, c, log):
        await c.write("obj", b"h" * 1000)
        daemon = P.mgr.MgrDaemon(c)
        port = await daemon.start()
        try:
            head, body = await _http_get(port, "/metrics")
            log.append((head, _series(body, P)))
            head, body = await _http_get(port, "/health")
            log.append((head, json.loads(body)))
            head, body = await _http_get(port, "/status")
            log.append((head, _state(json.loads(body))))
            log.append(await _http_get(port, "/nope"))
        finally:
            await daemon.stop()

    logs = _both(scenario)
    assert logs["port"] == logs["jax"]
    metrics, health, status, nope = logs["port"]
    assert metrics[0] == "HTTP/1.1 200 OK"
    assert metrics[1]["ceph_pool_objects"] == "1"
    assert health[1]["status"] == "HEALTH_OK"
    assert status[1]["osdmap"]["num_osds"] == 6
    assert nope[0] == "HTTP/1.1 404 Not Found"


# -- module host -------------------------------------------------------------


def test_module_host_builtin_modules():
    async def scenario(P, c, log):
        await c.write("obj", b"x" * 4000)
        reg = P.module_host.PyModuleRegistry(c)
        log.append(sorted(reg.modules))
        rc, out, err = reg.handle_command({"prefix": "status status"})
        log.append((rc, out, err))
        rc, out, err = reg.handle_command({"prefix": "prometheus metrics"})
        log.append((rc, _series(out, P), err))
        log.append(reg.handle_command({"prefix": "nosuch verb"}))
        log.append(reg.handle_command({"prefix": "status bogus"}))
        log.append(reg.get("health"))

    logs = _both(scenario, n_osds=4, profile=dict(PROFILE))
    assert logs["port"] == logs["jax"]
    names, status, prom, nosuch, bogus, health = logs["port"]
    assert names == ["prometheus", "status"]
    assert status[0] == 0 and "health:" in status[1] and "osd:" in status[1]
    assert prom[0] == 0 and "ceph_osd_up" in " ".join(prom[1])
    assert nosuch[0] != 0 and "no mgr module" in nosuch[2]
    assert bogus[0] == -22 and health["status"] == "HEALTH_OK"


def _sample_module(P):
    """A third-party module for package ``P`` (the JAX package's
    ``tests/fixtures/sample_mgr_module.py``, subclassing ``P``'s
    ``MgrModule``)."""
    class Module(P.module_host.MgrModule):
        NAME = "sample"

        def __init__(self, host):
            super().__init__(host)
            self.notifies = []

        def notify(self, what, ident):
            self.notifies.append((what, ident))
            if what == "osd_map":
                n_down = sum(1 for s in self.get("osd_stats").values()
                             if not s["up"])
                self.set_health_checks({"SAMPLE_SAW_DOWN": {
                    "severity": "HEALTH_WARN",
                    "summary": f"sample module saw {n_down} down",
                }} if n_down else {})

        def handle_command(self, cmd):
            verb = cmd.get("prefix", "").split(" ", 1)[-1]
            if verb == "ping":
                return 0, "pong\n", ""
            return -22, "", "unknown"

    mod = types.ModuleType(f"torch_mgr_fixtures.sample_{P.name}")
    mod.Module = Module
    return mod


def test_module_host_third_party_by_name(monkeypatch):
    """A third-party module loads by its dotted path from the
    ``mgr_modules`` option, receives notify events, and its raised
    health checks merge into cluster health."""
    for P in BOTH:
        mod = _sample_module(P)
        monkeypatch.setitem(sys.modules, mod.__name__, mod)

    async def scenario(P, c, log):
        cfg = P.config.get_config()
        cfg.set_val("mgr_modules", "status prometheus "
                    f"torch_mgr_fixtures.sample_{P.name}")
        try:
            reg = P.module_host.PyModuleRegistry(c)
        finally:
            cfg.set_val("mgr_modules", "status prometheus")
        log.append(sorted(reg.modules))
        log.append(reg.handle_command({"prefix": "sample ping"}))
        c.kill_osd(0)
        reg.notify_all("osd_map")
        log.append(list(reg.modules["sample"].notifies))
        log.append(reg.gather_health())
        c.revive_osd(0)
        reg.notify_all("osd_map")
        log.append(reg.gather_health())

    logs = _both(scenario, n_osds=4)
    assert logs["port"] == logs["jax"]
    names, ping, notifies, down, back = logs["port"]
    assert names == ["prometheus", "sample", "status"]
    assert ping == (0, "pong\n", "") and notifies == [("osd_map", None)]
    assert "SAMPLE_SAW_DOWN" in down["checks"]
    assert "SAMPLE_SAW_DOWN" not in back["checks"]


def test_module_host_rejects_broken_module():
    async def scenario(P, c, log):
        with pytest.raises(ImportError):
            P.module_host.PyModuleRegistry(c, modules=["no.such.module"])
        with pytest.raises(TypeError) as exc:
            # importable, but without a Module(MgrModule) class
            P.module_host.PyModuleRegistry(
                c, modules=[P.mgr.__name__ + ".mgr"])
        log.append(str(exc.value).replace(P.mgr.__name__, "<pkg>"))
        mod = P.module_host.PyModuleRegistry(c, modules=["balancer"])
        log.append(sorted(mod.modules))

    logs = _both(scenario, n_osds=4)
    assert logs["port"] == logs["jax"]


def test_mgr_daemon_metrics_via_module():
    """/metrics is served by the prometheus module through the host."""
    async def scenario(P, c, log):
        await c.write("o", b"y" * 2000)
        daemon = P.mgr.MgrDaemon(c)
        port = await daemon.start()
        try:
            head, body = await _http_get(port, "/metrics")
            direct = daemon.registry.modules["prometheus"].metrics()
            log.append((head, _series(body, P)))
            log.append(_series(body, P) == _series(direct, P))
        finally:
            await daemon.stop()

    logs = _both(scenario, n_osds=4)
    assert logs["port"] == logs["jax"]
    assert "ceph_osd_up" in " ".join(logs["port"][0][1])
    assert logs["port"][1] is True


def test_balancer_module_scores_and_reweights():
    async def scenario(P, c, log):
        for i in range(40):
            await c.write(f"obj{i}", b"d" * 3000)
        host = P.module_host.PyModuleRegistry(c, modules=["balancer"])
        log.append(host.handle_command({"prefix": "balancer status"}))
        log.append(host.handle_command({"prefix": "balancer eval"}))
        epoch0 = c.placement.epoch
        log.append(host.handle_command({"prefix": "balancer optimize"}))
        log.append((list(c.placement.weights), c.placement.epoch - epoch0))
        # the reweighted map's remaps migrate through peering
        for _ in range(6):
            for osd in c.osds:
                for backend in osd.pools.values():
                    await backend.peering_pass()
        log.append(host.handle_command({"prefix": "balancer status"}))
        log.append(P.mgr.health_checks(P.mgr.ClusterState(c).dump()))
        c.placement.mark_out(1)
        log.append(host.handle_command({"prefix": "balancer optimize"}))
        log.append(list(c.placement.weights))
        log.append(host.handle_command({"prefix": "balancer bogus"}))

    logs = _both(scenario, n_osds=5, profile=dict(PROFILE))
    assert logs["port"] == logs["jax"]
    status, ev, opt, (weights, bumped), after, health, opt2, w2, bogus = \
        logs["port"]
    assert status[0] == 0 and "score" in status[1]
    assert ev[0] == 0 and "ideal shards/osd" in ev[1]
    assert opt[0] == 0
    assert all(0.25 <= w / 0x10000 <= 1.0 for w in weights)
    if "reweighted" in opt[1]:
        assert bumped > 0 and any(w < 0x10000 for w in weights)
    assert health["status"] == "HEALTH_OK"
    assert w2[1] == 0 and bogus[0] == -22


# -- reports, the wire-fed PGMap and the O(counters) contract ----------------


def _report(P, rep: dict) -> dict:
    """An ``mgr_report_stats`` payload with its nonce and times dropped:
    the boot id, the histograms' marginals and sums (counts kept), and
    the residency slice's values (its keys are checked by the caller)."""
    out = {k: v for k, v in rep.items()
           if k not in ("boot_id", "hist", "residency")}
    out["perf"] = _perf(rep["perf"])
    out["hist"] = {name: h["count"] for name, h in rep["hist"].items()}
    return out


def test_mgr_report_stats_and_pgmap_fold():
    """Every OSD's report folded into a ``PGMap`` under a virtual clock:
    reports, ``dump``, ``pg_stat``, ``status_text``, health and the
    cluster log equal the JAX package's, and the folded health equals
    ``health_checks`` of the in-process ``ClusterState``."""
    payloads = _cycle_writes(np.random.RandomState(2))

    async def scenario(P, c, log):
        now = [100.0]
        pm = P.pgmap.PGMap(expected=[o.name for o in c.osds],
                           clock=lambda: now[0])
        seq = [0]

        def fold():
            seq[0] += 1
            for osd in c.osds:
                if c.messenger.is_down(osd.name):
                    continue
                rep = osd.mgr_report_stats()
                log.append((osd.name, _report(P, rep)))
                pm.apply(P.report.MgrReport(osd.name, seq[0], 1.0, rep,
                                            lag_ms=0.0))
            pm.apply(P.report.MgrBeacon("osd.0", seq[0], lag_ms=1.5))

        for oid, data in payloads.items():
            await c.write(oid, data)
        fold()
        log.append(pm.health())
        victim = c.backend.acting_set("obj0")[0]
        c.kill_osd(victim)
        await c.write("obj0", payloads["obj1"])
        await c.read("obj2")
        now[0] += 3.0
        fold()
        log.append(pm.health())
        state_health = P.mgr.health_checks(P.mgr.ClusterState(c).dump())
        log.append(sorted(state_health["checks"]))
        dump = pm.dump()
        for d in dump["daemons"].values():
            d["rates"] = sorted(d["rates"])
        log.append(dump)
        log.append(pm.pg_stat())
        log.append(pm.status_text())
        log.append(_series(pm.prometheus_text(), P))
        c.revive_osd(victim)
        now[0] += 1.0
        fold()
        log.append(pm.health()["status"])
        # a cluster-log entry's stamp is the wall clock: left out
        log.append([{k: v for k, v in e.items() if k != "stamp"}
                    for e in pm.clog.last(50)])

    logs = _both(scenario, n_osds=6)
    assert logs["port"] == logs["jax"]
    port_log = logs["port"]
    ok, warn = [x for x in port_log
                if isinstance(x, dict) and "checks" in x and "status" in x
                and len(x) == 2][:2]
    assert ok["status"] == "HEALTH_OK" and warn["status"] == "HEALTH_WARN"
    assert {"OSD_DOWN", "PG_DEGRADED"} <= set(warn["checks"])
    assert "cluster health HEALTH_OK -> HEALTH_WARN" in json.dumps(
        port_log[-1])


def test_report_residency_slice_differs_by_one_key():
    """The report's residency slice is each package's transfer ledger:
    the port's names ``library_builds`` where the JAX package's names
    ``jit_retraces``, and every other key is the same."""
    keys = {}
    for P in BOTH:
        _fresh(P)

        async def main(P=P):
            c = P.make(4, PROFILE)
            await c.write("o", b"r" * 5000)
            rep = c.osds[0].mgr_report_stats()
            await c.shutdown()
            return rep

        rep = _run(main())
        keys[P.name] = set(rep["residency"])
        assert rep["residency"] == {
            k: v for k, v in P.residency.counters().snapshot().items()}
    assert keys["port"] - keys["jax"] == {"library_builds"}
    assert keys["jax"] - keys["port"] == {"jit_retraces"}


def test_report_sender_feeds_the_mgr_server_over_the_messenger():
    """``ReportSender`` beacons and reports over the in-process messenger
    into an ``MgrServer``; its HTTP endpoint serves the folded map."""
    async def scenario(P, c, log):
        await c.write("obj", b"s" * 6000)
        server = P.pgmap.MgrServer(
            "mgr.0", c.messenger,
            addr_map={o.name: None for o in c.osds} | {"mgr.0": None})
        senders = [P.report.ReportSender(
            o.name, c.messenger, o.mgr_report_stats,
            P.report.mgr_targets_from({"mgr.0": None, o.name: None}),
            perf=o.perf) for o in c.osds]
        for s in senders:
            await s.send_report_now()
        for _ in range(50):
            if server.pgmap.reports_folded == len(senders):
                break
            await asyncio.sleep(0.01)
        port = await server.start_http()
        try:
            head, body = await _http_get(port, "/health")
            log.append((head, json.loads(body)))
            head, body = await _http_get(port, "/metrics")
            log.append((head, sorted(_series(body, P))))
            head, body = await _http_get(port, "/status")
            status = json.loads(body)
            log.append((head, status["reports_folded"],
                        sorted(status["daemons"]), status["totals"],
                        status["store"]))
        finally:
            await server.stop()
            for s in senders:
                s.stop()

    logs = _both(scenario, n_osds=4)
    assert logs["port"] == logs["jax"]
    health, metrics, status = logs["port"]
    assert health[1]["status"] == "HEALTH_OK"
    assert status[1] == 4 and status[2] == [f"osd.{i}" for i in range(4)]
    assert 'ceph_osd_up{ceph_daemon="osd.3"}' in metrics[1]


def test_report_schema_and_counter_filter_match():
    assert report.REPORTED_COUNTERS == j_report.REPORTED_COUNTERS
    assert report.REPORTED_COUNTER_PREFIXES == \
        j_report.REPORTED_COUNTER_PREFIXES
    snap = {"client_ops": 3, "qos_client_ops": 2, "tier_hit": 1,
            "made_up": 9, "sub_write": {"avgcount": 2, "sum": 0.5},
            "write": {"avgcount": 1, "sum": 0.1, "extra": 1},
            "loop_lag_hwm_us": 7.5}
    assert report.filter_counters(snap) == j_report.filter_counters(snap)
    assert report.mgr_targets_from({"osd.0": 1, "mgr.1": 2, "mgr.0": 3}) \
        == ["mgr.0", "mgr.1"]
    for name in ("mgr_modules", "mgr_beacon_interval", "mgr_report_interval",
                 "mgr_daemon_beacon_grace", "mgr_pg_stale_grace",
                 "mgr_lag_warn_ms", "mgr_lag_sustain"):
        mine, theirs = config.OPTIONS[name], j_config.OPTIONS[name]
        assert (mine.type, mine.default, mine.level, mine.see_also) == \
            (theirs.type, theirs.default, theirs.level, theirs.see_also)


def test_reports_and_scrapes_never_walk_an_object_store():
    """``mgr_report_stats``, a ``ClusterState`` scrape, the health checks
    and the exposition are O(counters): with every store's listing
    raising, all of them still answer (only the audit path,
    ``degraded_objects(deep=True)``, walks the stores)."""
    async def main():
        _fresh(PORT)
        c = PORT.make(6, PROFILE)
        for i in range(8):
            await c.write(f"o{i}", bytes([i]) * 7000)
        c.kill_osd(c.backend.acting_set("o0")[0])

        def walk(*args, **kwargs):
            raise AssertionError("a report walked an object store")

        for osd in c.osds:
            osd.store.list_objects = walk
        reports = [osd.mgr_report_stats() for osd in c.osds]
        state = mgr.ClusterState(c)
        dump = state.dump()
        health = mgr.health_checks(dump)
        text = mgr.prometheus_text(dump)
        with pytest.raises(AssertionError, match="walked"):
            state.degraded_objects(deep=True)
        await c.shutdown()
        return reports, dump, health, text

    reports, dump, health, text = _run(main())
    assert all(r["store"]["objects"] >= 0 for r in reports)
    assert health["status"] == "HEALTH_WARN" and dump["degraded_objects"]
    assert "ceph_degraded_objects" in text


def test_exposition_series_are_present():
    """The transfer, mesh, trace and profiling series are rendered from
    the port's ledgers (no guard drops a section): with the mesh plane up
    over CPU slots and the stage profiler on, every family is in the
    scrape, and each ledger value is the ledger's at the scrape."""
    from ceph_tpu_torch import parallel
    from ceph_tpu_torch.parallel import mesh_plane

    cfg = config.get_config()
    prior_mode = profiling.mode()
    cfg.set_val("osd_mesh_data_plane", True)
    parallel.configure_devices(["cpu"] * 4)
    profiling.configure("on")
    try:
        async def main():
            _fresh(PORT)
            c = PORT.make(6, PROFILE)
            await c.write("obj", b"p" * 9000)
            assert await c.read("obj") == b"p" * 9000
            text = mgr.prometheus_text(mgr.ClusterState(c).dump())
            await c.shutdown()
            return text

        text = _run(main())
    finally:
        profiling.configure(prior_mode)
        cfg.set_val("osd_mesh_data_plane", False)
        parallel.configure_devices(None)
        mesh_plane.reset()
    families = {ln.split()[2] for ln in text.splitlines()
                if ln.startswith("# TYPE")}
    for family in ("ceph_library_builds_total", "ceph_transfer_bytes_total",
                   "ceph_transfer_ops_total", "ceph_mesh_dispatch_bytes_total",
                   "ceph_mesh_wire_bytes_avoided_total",
                   "ceph_trace_spans_finished", "ceph_trace_spans_dropped",
                   "ceph_trace_spans_unfinished",
                   "ceph_profile_stage_seconds_total",
                   "ceph_profile_callback_seconds_total",
                   "ceph_osd_tier_resident_bytes",
                   "ceph_osd_tier_hbm_budget_bytes"):
        assert family in families, family
    series = _series(text, PORT)
    assert 'ceph_mesh_dispatch_bytes_total{axis="pg"}' in series
    rc = residency.counters().snapshot()
    assert f'ceph_transfer_bytes_total{{direction="h2d"}} ' \
        f'{rc["h2d_bytes"]}' in text
    assert rc["h2d_bytes"] > 0
