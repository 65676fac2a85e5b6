"""The port's trace-path bench (``osd/trace_bench.py``, ``-w
trace-path``) against the JAX package's.

Both run the JAX package's smoke shape (8 objects of 4 KiB, 4 writers,
one iteration) at reed_sol_van k=4 m=2: the port on its ``cuda`` plugin
at ``device=cpu``, the JAX package on jerasure.  The overhead gate is
open (on a CPU shared by the whole test run the walls are noise: one
loaded run read 108%; the chip smoke runs the 3% gate at full shape);
the correctness gates are armed: a stitched client -> primary ->
sub-writes trace with the ``batch_encode`` fan-in span, timeline
segments summing to the op's end to end, slow ops detected, zero
unfinished spans.  The result's keys
equal the JAX package's, and the bench cluster's stored shards of the
timed objects equal a JAX package cluster's over the same payloads and
pool.
"""

import asyncio
import contextlib
import io
import json

import pytest

from ceph_tpu.msg import cluster_bench as j_cluster_bench
from ceph_tpu.osd import trace_bench as j_trace_bench
from ceph_tpu.plugins import registry as j_registry
from ceph_tpu_torch.osd import trace_bench
from ceph_tpu_torch.plugins import registry
from ceph_tpu_torch.tools import ec_benchmark
from torch_verify import port_verifiers, verifying_policy

PROFILE = {"k": "4", "m": "2", "technique": "reed_sol_van"}
SMOKE = dict(n_objects=8, obj_bytes=4096, writers=4, iters=1,
             overhead_limit_pct=1e9)


@contextlib.contextmanager
def _port_policy():
    with port_verifiers():
        yield


@contextlib.contextmanager
def _verifying_policy():
    saved = asyncio.get_event_loop_policy()
    asyncio.set_event_loop_policy(verifying_policy())
    try:
        yield
    finally:
        asyncio.set_event_loop_policy(saved)


def _jax_shards():
    ec = j_registry.instance().factory("jerasure", dict(PROFILE))
    payloads = j_cluster_bench.make_payloads(SMOKE["n_objects"],
                                             SMOKE["obj_bytes"], 77 + 1)

    async def main():
        h = j_cluster_bench.ClusterHarness(ec, 6, cork=True,
                                           pool="tracepool")
        await h.start()
        try:
            for oid in payloads:
                h.objecter.acting_set(oid)
            await h.run_writes(payloads, SMOKE["writers"])
            return h.shard_bytes()
        finally:
            await h.shutdown()

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(main())
    finally:
        loop.close()


@pytest.fixture(scope="module")
def runs():
    ec = registry.instance().factory("cuda", dict(PROFILE, device="cpu"))
    with _port_policy():
        mine = trace_bench.run_trace_overhead_bench(
            ec, keep_shards=True, **SMOKE)
    with _verifying_policy():
        theirs = j_trace_bench.run_trace_overhead_bench(
            j_registry.instance().factory("jerasure", dict(PROFILE)),
            **SMOKE)
        want = _jax_shards()
    return mine, theirs, want


def test_trace_path_correctness_gates_hold(runs):
    mine, _, _ = runs
    assert mine["slow_ops_detected"] > 0 and mine["historic_slow_returned"]
    assert mine["unfinished_spans"] == 0
    st = mine["stitched"]
    assert st["sub_writes"] == 6 and st["batch_encode_amortized_over"]
    assert st["timeline_segment_sum_ms"] == pytest.approx(
        st["timeline_total_ms"], rel=trace_bench.SUM_TOLERANCE, abs=0.5)
    assert mine["modes"]["off"]["cluster_wall_s"] > 0


def test_trace_path_result_keys_equal_jax(runs):
    mine, theirs, _ = runs
    assert set(mine) - {"_shards"} == set(theirs)
    for key in ("modes", "stitched"):
        assert set(mine[key]) == set(theirs[key]), key
    for mode in mine["modes"]:
        assert set(mine["modes"][mode]) == set(theirs["modes"][mode])


def test_trace_path_shards_equal_jax(runs):
    mine, _, want = runs
    assert len(want) == SMOKE["n_objects"] * 6
    timed = {soid.split("@")[0] for _osd, soid in want}
    got = {key: data for key, data in mine["_shards"].items()
           if key[1].split("@")[0] in timed}
    assert got == want


def test_trace_path_tool_prints_the_jax_keys():
    argv = ["-w", "trace-path", "--objects", "4", "-s", "2048",
            "--writers", "2", "-P", "k=2", "-P", "m=1", "-P", "device=cpu"]
    buf = io.StringIO()
    orig = trace_bench.run_trace_overhead_bench
    try:
        trace_bench.run_trace_overhead_bench = \
            lambda ec, **kw: orig(ec, **kw, overhead_limit_pct=1e9)
        with _port_policy(), contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = ec_benchmark.main(argv)
    finally:
        trace_bench.run_trace_overhead_bench = orig
    assert rc == 0
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert result["stitched"]["sub_writes"] == 3
    assert result["n_objects"] == 4 and result["unfinished_spans"] == 0
