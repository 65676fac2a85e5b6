"""The port's wire-tax bench (``profiling/wire_tax_bench.py``, ``-w
wire-tax``) against the JAX package's.

Both run the JAX package's smoke shape (8 objects of 4 KiB, 4 writers,
one iteration) on a CPU profile: the port's ``cuda`` plugin at
``device=cpu``, the JAX package's in-process jerasure, both reed_sol_van
k=4 m=2.  The timing gates are opened, as the JAX package's own smoke
test opens its A/B gates: on a CPU shared by the whole test run the
walls are noise (one loaded run read a 125% enabled overhead); the chip
smoke runs them at full shape.  Every correctness gate stays armed: frame
bytes identical across codecs, stored shards identical across the
OSD-exec and ring A/Bs, the rings used, the off-mode allocation pin, the
speedscope export.  The result's keys equal the JAX package's, and the
shards the native codec's A/B run stored equal a JAX package cluster's
over the same payloads and pool.  The codec A/B never skips: with the
native codec gated off the bench raises.
"""

import asyncio
import contextlib
import json

import pytest

from ceph_tpu.msg import cluster_bench as j_cluster_bench
from ceph_tpu.plugins import registry as j_registry
from ceph_tpu.profiling import wire_tax_bench as j_wire_tax_bench
from ceph_tpu_torch import profiling
from ceph_tpu_torch.msg import cluster_bench
from ceph_tpu_torch.profiling import wire_tax_bench
from ceph_tpu_torch.tools import ec_benchmark
from torch_verify import port_verifiers, verifying_policy

SMOKE = dict(n_objects=8, obj_bytes=4096, writers=4, iters=1)
#: every timing gate open (coverage and overhead read walls too)
OPEN = dict(coverage_min_pct=0.0, overhead_limit_pct=1e9, retries=1,
            codec_gain_min=0.0, codec_share_ratio_max=1e9,
            osd_share_ratio_max=1e9, ring_gain_min=0.0)
CPU = {"device": "cpu"}


@contextlib.contextmanager
def _port_policy():
    """Both packages' loops run under the port's verifiers
    (``tests/torch_verify.py``): its atomic-section verifier, which holds
    both packages' sections, and its residency verifier."""
    with port_verifiers():
        yield


@pytest.fixture(autouse=True)
def _loop_policy():
    with _port_policy():
        yield


def _jax_call(fn, *args, **kwargs):
    """A JAX package call under the port's verifying policy."""
    saved = asyncio.get_event_loop_policy()
    asyncio.set_event_loop_policy(verifying_policy())
    try:
        return fn(*args, **kwargs)
    finally:
        asyncio.set_event_loop_policy(saved)


def _keys(d, depth=2):
    if depth == 0 or not isinstance(d, dict):
        return None
    return {k: _keys(v, depth - 1) for k, v in d.items()
            if k not in ("decomposition", "bursts", "sampler")}


def _jax_shards(n_osds, writers, batch):
    """The JAX package's stored shards for the bench's payloads, written
    through its vectorized submit into the codec A/B's pool."""
    ec = j_registry.instance().factory(
        "jerasure", dict(wire_tax_bench.PROFILE))
    payloads = j_cluster_bench.make_payloads(
        SMOKE["n_objects"], SMOKE["obj_bytes"], 191)

    async def main():
        h = j_cluster_bench.ClusterHarness(ec, n_osds, cork=True,
                                           pool="wcabnative")
        await h.start()
        try:
            for oid in payloads:
                h.objecter.acting_set(oid)
            await h.run_writes(payloads, writers, batch=batch)
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
    with _port_policy():
        mine = wire_tax_bench.run_wire_tax_bench(
            profile=CPU, keep_shards=True, **SMOKE, **OPEN)
    theirs = _jax_call(j_wire_tax_bench.run_wire_tax_bench, **SMOKE, **OPEN)
    return mine, theirs


def test_wire_tax_correctness_gates_hold(runs):
    mine, _ = runs
    assert mine["wire_tax_alloc_blocks_off"] == 0
    assert mine["wire_codec_native_enabled"] is True
    assert mine["wire_codec_frame_bytes_identical"] is True
    assert mine["osd_exec_shard_bytes_identical"] is True
    assert mine["ring_shard_bytes_identical"] is True
    assert mine["ring_conns"] > 0
    assert mine["wire_tax_coverage_pct"] > 0
    assert mine["wire_tax_ops_per_sec"] > 0
    assert len(mine["wire_tax_top"]) == 5
    assert mine["sampler"]["speedscope_profiles"] >= 1
    assert mine["n_osds"] == 6 and profiling.mode() == "off"


def test_wire_tax_result_keys_equal_jax(runs):
    mine, theirs = runs
    shards = mine["_shards"]
    assert set(mine) - {"_shards"} == set(theirs)
    assert _keys({k: v for k, v in mine.items() if k != "_shards"}) == \
        _keys(theirs)
    assert set(mine["decomposition"]) == set(theirs["decomposition"])
    assert set(mine["sampler"]) == set(theirs["sampler"])
    assert shards


def test_wire_tax_shards_equal_jax(runs):
    mine, _ = runs
    want = _jax_call(_jax_shards, 6, SMOKE["writers"], 8)
    assert mine["_shards"] == want


def test_wire_tax_codec_ab_never_skips():
    cfg = cluster_bench.python_wire_codec()
    with cfg, pytest.raises(AssertionError, match="gated off"):
        wire_tax_bench.run_wire_tax_bench(profile=CPU, **SMOKE, **OPEN)
    assert profiling.mode() == "off"


def test_wire_tax_tool_prints_the_bench_result(capsys, monkeypatch):
    """``ec_benchmark -w wire-tax -P device=cpu`` at a tiny shape, its
    timing gates opened as above: one JSON line (the bench's result) and
    the JAX tool's summary on stderr."""
    orig = wire_tax_bench.run_wire_tax_bench
    monkeypatch.setattr(wire_tax_bench, "run_wire_tax_bench",
                        lambda **kwargs: orig(**kwargs, **OPEN))
    argv = ["-w", "wire-tax", "--objects", "6", "-s", "2048",
            "--writers", "3", "-P", "device=cpu"]
    assert ec_benchmark.main(argv) == 0
    out = capsys.readouterr()
    result = json.loads(out.out.splitlines()[-1])
    assert result["n_objects"] == 6 and result["writers"] == 3
    assert result["wire_codec_native_enabled"] is True
    assert out.err.startswith("wire-tax: ")
