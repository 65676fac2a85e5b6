"""The port's load generator (``ceph_tpu_torch/loadgen/``) and QoS bench
(``osd/qos_bench.py``), on the CPU (``device=cpu``).

Mirrors the JAX package's ``tests/test_loadgen.py`` at its sizes: profile
shapes, arrival processes, the latency reservoir, the open-loop budget,
the real-TCP scenario runner with thrash, rebuild and membership churn and
its exactly-once audit, the overload stage (slow, as there), the QoS
series in the exposition and the QoS profile parse.  Where the JAX
package's code draws from a seeded ``random.Random`` -- profile sampling,
arrival gaps, the reservoir -- the port's draws are compared with the
JAX package's op for op; so are the parsed QoS profiles.  The port's
``ec_benchmark -w qos-path --smoke --stages scale`` closes the file.
"""

import asyncio
import json
import random

import pytest

from ceph_tpu.loadgen import ClosedLoop as JClosedLoop
from ceph_tpu.loadgen import OpenLoop as JOpenLoop
from ceph_tpu.loadgen import PROFILES as J_PROFILES
from ceph_tpu.loadgen.clients import ClientStats as JClientStats
from ceph_tpu.osd import qos as j_qos
from ceph_tpu_torch.loadgen import (ClientGroup, ClosedLoop, OpenLoop,
                                    PROFILES, Scenario, run_scenario)
from ceph_tpu_torch.loadgen.clients import (LATENCY_RESERVOIR, ClientStats,
                                            LoadClient)
from ceph_tpu_torch.osd import qos as t_qos
from torch_verify import port_verifiers

#: every pool of this file runs the cuda plugin's codec on the CPU
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _loop_policy():
    """Both packages' loops run under the port's verifiers
    (``tests/torch_verify.py``): its atomic-section verifier, which holds
    both packages' sections, and its residency verifier."""
    with port_verifiers():
        yield

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread in this worker while the test runs (the CPU
    codec's products are small; the tier-1 run's other workers share the
    host's cores), restored afterwards."""
    import torch

    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


@pytest.fixture(autouse=True)
def _fairness_gauges():
    """The scenario runner publishes its per-class fairness gauges
    process-wide (``osd/qos.py``): put them back as they were, so no
    later test's exposition carries this one's classes."""
    from ceph_tpu_torch.osd import qos

    prior = qos.fairness_spreads()
    yield
    for klass in qos.fairness_spreads():
        qos.set_fairness_spread(klass, prior.get(klass))



def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


# -- profiles, arrivals, the reservoir: op for op against the JAX package --


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_profiles_sample_shapes(name):
    prof, jprof = PROFILES[name], J_PROFILES[name]
    assert (prof.mix, prof.sizes) == (jprof.mix, jprof.sizes)
    rng, jrng = random.Random(1), random.Random(1)
    draws = [prof.sample(rng) for _ in range(300)]
    assert draws == [jprof.sample(jrng) for _ in range(300)]
    for kind, size in draws:
        if kind in ("put", "get", "range_write", "range_read"):
            assert size > 0, (name, kind)
        else:
            assert size == 0, (name, kind)
    # every mixed kind shows up across 300 draws
    assert {k for k, _ in draws} == {k for k, _w in prof.mix}, name


@pytest.mark.parametrize("arrival, jarrival", [
    (ClosedLoop(), JClosedLoop()),
    (ClosedLoop(think_s=0.05), JClosedLoop(think_s=0.05)),
    (OpenLoop(rate_ops_s=100.0), JOpenLoop(rate_ops_s=100.0)),
    (OpenLoop(rate_ops_s=0.0), JOpenLoop(rate_ops_s=0.0)),
], ids=["closed", "closed-think", "open-100", "open-0"])
def test_arrival_processes(arrival, jarrival):
    rng, jrng = random.Random(2), random.Random(2)
    gaps = [arrival.gap(rng) for _ in range(500)]
    assert gaps == [jarrival.gap(jrng) for _ in range(500)]
    assert all(g >= 0 for g in gaps)
    if isinstance(arrival, OpenLoop) and arrival.rate_ops_s > 0:
        assert 0.005 < sum(gaps) / len(gaps) < 0.02  # ~1/rate mean
    if arrival == ClosedLoop():
        assert set(gaps) == {0.0}


def test_latency_reservoir_is_bounded():
    stats, jstats = ClientStats(), JClientStats()
    rng, jrng = random.Random(3), random.Random(3)
    for i in range(5 * LATENCY_RESERVOIR):
        stats.note_latency(rng, float(i))
        jstats.note_latency(jrng, float(i))
    assert len(stats.latencies) == LATENCY_RESERVOIR
    assert stats.latencies == jstats.latencies


# -- per-client in-flight budget (the million-client OOM bound) ------------


def test_open_loop_budget_bounds_inflight_and_counts_shed():
    """An open-loop client whose arrivals outrun completions must cap
    in-flight ops at the budget and count the shed arrivals."""

    class SlowObjecter:
        name = "cb@hub0"

        def __init__(self):
            self.inflight = 0
            self.hwm = 0

        async def write(self, oid, data, snapc=None):
            self.inflight += 1
            self.hwm = max(self.hwm, self.inflight)
            try:
                await asyncio.sleep(0.05)  # far slower than arrivals
            finally:
                self.inflight -= 1

    async def run():
        from ceph_tpu_torch.utils.perf import PerfCounters

        perf = PerfCounters("loadgen-test")
        ob = SlowObjecter()
        client = LoadClient(
            ob, PROFILES["put8k"], random.Random(5),
            arrival=OpenLoop(rate_ops_s=500.0), inflight=3, perf=perf,
        )
        stop = asyncio.Event()
        task = asyncio.ensure_future(client.run(stop))
        await asyncio.sleep(0.4)
        stop.set()
        await task
        return ob, client, perf

    ob, client, perf = _run(run())
    assert ob.hwm <= 3, ob.hwm
    assert client.stats.arrivals_shed > 0
    assert perf.snapshot().get("client_inflight_hwm") == 3


# -- the real-TCP scenario runner ------------------------------------------


def test_scenario_tcp_smoke_mixed_profiles_exact_cas():
    """A few dozen hub-multiplexed clients over real TCP sockets, all
    four traffic families, no chaos: ops flow, the QoS admission layer
    counts them, fairness spread is finite, and the exactly-once audit
    is exact."""
    scn = Scenario(
        name="t1-smoke", duration_s=2.0,
        groups=(
            ClientGroup(count=8, profile="rgw"),
            ClientGroup(count=6, profile="rbd"),
            ClientGroup(count=6, profile="cephfs", mode="open",
                        rate_ops_s=4.0),
            ClientGroup(count=4, profile="txn"),
        ),
        seed=19,
    )
    res = _run(run_scenario(scn, n_osds=5, profile=CPU))
    assert res.n_clients == 24
    assert res.ops > 0
    assert res.cas_clients > 0 and res.cas_exact
    assert res.qos_counters.get("qos_client_ops", 0) > 0
    rgw = res.groups[0]
    assert rgw["ops"] > 0 and rgw["client_ops_min"] >= 0


def test_scenario_chaos_thrash_rebuild_exactly_once():
    """TRUE TCP kills (listener closed, sockets torn) + a mid-run OSD
    wipe under transactional load: ops fail over, the rebuild runs
    through the unified admission, and every CAS/exec counter matches
    its client's acked successes exactly (modulo explicitly booked
    indeterminate outcomes)."""
    scn = Scenario(
        name="t1-chaos", duration_s=5.0,
        groups=(
            ClientGroup(count=10, profile="rgw"),
            ClientGroup(count=8, profile="txn"),
        ),
        chaos=("thrash", "rebuild"),
        seed=23,
    )
    res = _run(run_scenario(scn, n_osds=6, profile=CPU))
    assert res.kills >= 1, "thrash never killed an OSD"
    assert res.wipes == 1
    assert res.cas_clients > 0 and res.cas_exact, res.cas_mismatches
    assert res.ops > 0
    # recovery of the wipe rode the unified dmClock admission
    assert res.qos_counters.get("qos_recovery_ops", 0) > 0


def test_scenario_chaos_membership_churn_exactly_once():
    """Elastic membership under scenario load: a victim OSD is weighted
    out of CRUSH mid-run while its daemon keeps serving, data drains off
    through the peering tick's epoch-skew backfill, then it's weighted
    back in -- with the exactly-once audit exact across both remaps."""
    scn = Scenario(
        name="t1-churn", duration_s=4.0,
        groups=(
            ClientGroup(count=8, profile="rgw"),
            ClientGroup(count=6, profile="txn"),
        ),
        chaos=("churn",),
        seed=31,
    )
    res = _run(run_scenario(scn, n_osds=6, profile=CPU))
    assert res.churn_events >= 2, "churn never flipped a weight"
    assert res.ops > 0
    assert res.cas_clients > 0 and res.cas_exact, res.cas_mismatches


def test_scenario_pool_follows_its_profile():
    """The runner's pool is the cuda plugin's codec on the profile's
    device (the JAX package's runner hard-codes jerasure), and each
    OSD's device tier lives on that device."""
    import torch

    from ceph_tpu_torch.loadgen import ScenarioRunner

    async def run():
        runner = ScenarioRunner(
            Scenario(name="t1-shape", duration_s=0.1,
                     groups=(ClientGroup(count=1, profile="put8k"),)),
            n_osds=3, profile=CPU)
        await runner.start()
        try:
            return (type(runner.ec).__module__,
                    {str(o.tier.device) for o in runner.osds})
        finally:
            await runner.shutdown()

    module, devices = _run(run())
    assert module == "ceph_tpu_torch.plugins.cuda"
    assert devices == {str(torch.device("cpu"))}


async def _wait_for(predicate, timeout: float) -> bool:
    deadline = asyncio.get_event_loop().time() + timeout
    while not predicate():
        if asyncio.get_event_loop().time() > deadline:
            return False
        await asyncio.sleep(0.05)
    return True


@pytest.mark.parametrize("harness", ["cluster", "scenario"])
def test_wipe_during_a_peering_pass_is_rebuilt(harness):
    """A wipe that lands while a primary's peering pass fetches the wiped
    OSD's log deltas: that pass stores its watermark for the OSD after
    the wipe cleared it, so only the wipe's new incarnation (boot_id)
    makes the primary's next pass backfill what the OSD lost.  The JAX
    package's two harnesses keep the old incarnation, and there those
    objects stay missing and degraded for good (the telemetry chaos
    stage's drain stuck at a constant count).  The background deep
    scrub, which would find the missing shards in time, is off here."""
    import numpy as np

    from ceph_tpu_torch.loadgen import ScenarioRunner
    from ceph_tpu_torch.osd.cluster import ECCluster
    from ceph_tpu_torch.utils.config import get_config

    n_osds = 4
    cfg = get_config()
    prior = {"osd_scrub_objects_per_tick":
             cfg.get_val("osd_scrub_objects_per_tick")}

    async def main():
        if harness == "cluster":
            cluster = ECCluster(n_osds, dict(k="2", m="1", **CPU))
            cluster.start_auto_recovery(0.05)
            osds, pool = cluster.osds, cluster.pool
            write, read = cluster.write, cluster.read
            wipe, stop = cluster.wipe_osd, cluster.shutdown
        else:
            runner = ScenarioRunner(
                Scenario(name="t1-wipe", duration_s=0.1,
                         groups=(ClientGroup(count=1, profile="put8k"),)),
                n_osds=n_osds, profile=CPU)
            await runner.start()
            osds, pool = runner.osds, runner.pool
            objecter = runner.clients[0].objecter
            write, read = objecter.write, objecter.read
            wipe, stop = runner._wipe_osd, runner.shutdown
        try:
            rng = np.random.RandomState(2025)
            payloads = {f"w{i}": rng.bytes(4096) for i in range(16)}
            for oid, data in payloads.items():
                await write(oid, data)
            backends = [osd.pools[pool] for osd in osds]
            # quiescent: every primary has peered every OSD's whole log,
            # so no later delta names the objects written above
            assert await _wait_for(lambda: all(
                b._peer_seq.get(osd.name) == osd.pglog.head_seq
                for b in backends for osd in osds), 10.0)
            # E leads an object with a shard on V; the racing write
            # lands on V, so E's next pass fetches V's log deltas
            acting = {oid: backends[0].acting_set(oid) for oid in payloads}
            lead, victim = acting["w0"][0], acting["w0"][1]
            racing = next(f"r{i}" for i in range(64)
                          if victim in backends[0].acting_set(f"r{i}"))
            payloads[racing] = rng.bytes(4096)
            acting[racing] = backends[0].acting_set(racing)
            engine = backends[lead]
            roundtrip = engine._meta_roundtrip
            fired = []

            async def wipe_mid_fetch(targets, payload, *args, **kw):
                if not fired and payload.get("op") == "pg_log_entries" \
                        and f"osd.{victim}" in targets:
                    fired.append(victim)
                    wipe(victim)
                return await roundtrip(targets, payload, *args, **kw)

            engine._meta_roundtrip = wipe_mid_fetch
            await write(racing, payloads[racing])
            assert await _wait_for(lambda: fired, 10.0), \
                "the lead's pass never fetched the victim's log"

            def rebuilt() -> bool:
                for oid, placed in acting.items():
                    for s, osd_id in enumerate(placed):
                        if f"{oid}@{s}" not in \
                                osds[osd_id].store.list_objects():
                            return False
                return sum(b.pg_stats.degraded_count()
                           for b in backends) == 0

            clean = await _wait_for(rebuilt, 20.0)
            missing = sorted(
                f"{oid}@{s}" for oid, placed in acting.items()
                for s, osd_id in enumerate(placed)
                if f"{oid}@{s}" not in osds[osd_id].store.list_objects())
            read_back = {oid: await read(oid) for oid in payloads}
            return clean, missing, read_back == payloads
        finally:
            await stop()

    cfg.apply_changes({"osd_scrub_objects_per_tick": 0})
    try:
        clean, missing, exact = _run(main())
    finally:
        cfg.apply_changes(prior)
    assert clean and not missing, f"never rebuilt: {missing}"
    assert exact


@pytest.mark.slow
def test_qos_bench_overload_smoke_reservation_floor():
    """The qos-path overload sub-stage at smoke shape: calibration,
    10x bulk storm against a gold reservation, floor gate within 10%
    (raises on violation -- the assertion IS the gate)."""
    from ceph_tpu_torch.osd.qos_bench import _overload_stage

    result = _run(_overload_stage(smoke=True, profile=CPU))
    assert result["reservation_ratio"] >= 0.9
    assert result["throttle_waits"] > 0
    assert result["bulk_ops"] > 0


def test_prometheus_exports_qos_class_series_and_fairness_gauge():
    """ceph_qos_class_ops/bytes/throttle_waits per (daemon, class) and
    the loadgen-published fairness spread gauge render in the mgr
    exposition after QoS-admitted traffic."""

    async def run():
        from ceph_tpu_torch.mgr.mgr import ClusterState, prometheus_text
        from ceph_tpu_torch.osd.cluster import ECCluster

        cluster = ECCluster(4, {"k": "2", "m": "1", "device": "cpu"})
        try:
            await cluster.write("pq1", b"q" * 8192)
            assert await cluster.read("pq1") == b"q" * 8192
            t_qos.set_fairness_spread("rgw", 1.25)
            text = prometheus_text(ClusterState(cluster).dump())
        finally:
            t_qos.set_fairness_spread("rgw", None)
            await cluster.shutdown()
        assert "# TYPE ceph_qos_class_ops counter" in text
        assert 'qos_class="client"' in text
        assert "# TYPE ceph_qos_class_bytes counter" in text
        assert 'ceph_qos_fairness_spread{qos_class="rgw"} 1.25' in text

    _run(run())


@pytest.mark.parametrize("text", [
    "client:0:100:0, gold:2:1:8\nbroken nums:a:b:c",
    "   ",
    "client:0:100:0,gold:0.0123:1:0,bulk:0:100:0,recovery:4:10:0,"
    "scrub:1:5:0",
], ids=["mixed", "blank", "bench"])
def test_qos_profile_parse_and_scaling(text):
    prof = t_qos.parse_profile(text)
    assert prof == j_qos.parse_profile(text)
    assert t_qos.profile_bytes_per_s(prof) == \
        j_qos.profile_bytes_per_s(prof)
    if text.startswith("client:0:100:0, gold"):
        assert prof["client"] == (0.0, 100.0, 0.0)
        assert prof["gold"] == (2.0, 1.0, 8.0)
        assert "broken" not in prof and "nums" not in prof
        bps = t_qos.profile_bytes_per_s(prof)
        assert bps["gold"] == (2.0 * (1 << 20), 1.0, 8.0 * (1 << 20))
    if not text.strip():
        # empty/garbage falls back to the shipped defaults
        assert set(prof) == set(t_qos.parse_profile(t_qos.DEFAULT_PROFILE))


# -- the tool -----------------------------------------------------------------


def test_ec_benchmark_qos_path_smoke_on_cpu(capsys):
    """``ec_benchmark -w qos-path --smoke --stages scale -P device=cpu``:
    250 clients of the four families with a mid-run rebuild and tier
    promotion, every gate of the stage armed (the tool raises on one).
    The overload stage's reservation floor is a ratio of host wall times
    that another worker's load between its calibration and its storm
    moves (0.517 on a loaded 8-core host), and the chaos stage's kills
    need the loop to wake within 3.75 s of its start: they run in the
    slow test and the thrash scenario above."""
    from ceph_tpu_torch.tools import ec_benchmark

    assert ec_benchmark.main(["-w", "qos-path", "--smoke", "--stages",
                              "scale", "-P", "device=cpu"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["smoke"] is True
    assert result["qos_path_clients"] == 250
    assert result["qos_path_cas_exact"]
    assert result["scale"]["wipes"] == 1 and result["scale"]["ops"] > 0
