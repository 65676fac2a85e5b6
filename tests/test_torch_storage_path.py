"""The port's storage path (``osd/storage_bench.py``) against the JAX
package's.

The same payloads, made with numpy from a seed, go through the JAX
package's harness with the ``tpu`` plugin (on the CPU) and through the
port's with the ``cuda`` plugin on ``device=cpu``: the committed stores
``{oid@shard: bytes}`` must be identical, per-op and coalesced, and the
degraded read must return the payloads.  The full benchmark runs at the
reference's tier-1 size (48 objects of 4 KiB, k=4 m=2) and its gates
hold; ``ec_benchmark --workload storage-path --profile`` prints the
reference's JSON keys, ``steady_library_builds`` in place of
``steady_jit_retraces``.  The reference's "coalesced not slower" timing
assertion is not carried over: it measures the CPU this runs on.
"""

import asyncio
import contextlib
import io
import json

import pytest

import tools.ec_benchmark as j_ec_benchmark
from ceph_tpu.analysis import residency as j_residency
from ceph_tpu.osd import storage_bench as j_storage_bench
from ceph_tpu.plugins import registry as j_registry
from ceph_tpu_torch.analysis import residency
from ceph_tpu_torch.osd import storage_bench
from ceph_tpu_torch.plugins import registry
from ceph_tpu_torch.tools import ec_benchmark
from torch_verify import port_verifiers

PROFILES = {
    "rs_w8_k4m2": {"technique": "reed_sol_van", "k": "4", "m": "2"},
    "rs_w8_k8m4": {"technique": "reed_sol_van", "k": "8", "m": "4"},
    "rs_w16_k4m2": {"technique": "reed_sol_van", "k": "4", "m": "2",
                    "w": "16"},
    "cauchy_good_k4m2": {"technique": "cauchy_good", "k": "4", "m": "2",
                         "packetsize": "64"},
}


@pytest.fixture(autouse=True)
def _loop_policy():
    """Both packages' loops run under the port's verifiers
    (``tests/torch_verify.py``): its atomic-section verifier, which holds
    both packages' sections, and its residency verifier."""
    with port_verifiers():
        yield


def _harnesses(name, erasures=2):
    ours = registry.instance().factory(
        "cuda", dict(PROFILES[name], device="cpu"))
    theirs = j_registry.instance().factory("tpu", dict(PROFILES[name]))
    return (storage_bench.StoragePathHarness(ours, erasures=erasures),
            j_storage_bench.StoragePathHarness(theirs, erasures=erasures))


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


@pytest.mark.parametrize("coalesce", [False, True],
                         ids=["per_op", "coalesced"])
@pytest.mark.parametrize("name", sorted(PROFILES))
def test_write_pass_stores_match_jax(name, coalesce):
    h, jh = _harnesses(name)
    payloads = storage_bench.make_payloads(12, 3000 + 97 * len(name), seed=5)
    assert payloads == j_storage_bench.make_payloads(
        12, 3000 + 97 * len(name), seed=5)
    stages = {}
    store = _run(h.write_pass(payloads, coalesce=coalesce, writers=4,
                              stages=stages))
    want = _run(jh.write_pass(payloads, coalesce=coalesce, writers=4))
    assert store == want
    assert len(store) == len(payloads) * h.km
    assert set(stages) == {"assemble", "transpose", "encode", "commit"}
    # the degraded read round-trips the payloads in both modes
    sizes = [len(p) for p in payloads]
    for mode in (False, True):
        got = _run(h.read_pass(store, len(payloads), sizes, coalesce=mode,
                               readers=4, stages=stages))
        assert got == payloads
    assert "decode" in stages


def test_read_pass_matches_jax_with_one_erasure():
    h, jh = _harnesses("rs_w8_k8m4", erasures=1)
    assert h.erased == jh.erased == [0]
    payloads = storage_bench.make_payloads(9, 5000, seed=9)
    store = _run(h.write_pass(payloads, coalesce=True, writers=3))
    sizes = [len(p) for p in payloads]
    got = _run(h.read_pass(store, len(payloads), sizes, coalesce=True,
                           readers=3))
    want = _run(jh.read_pass(store, len(payloads), sizes, coalesce=True,
                             readers=3))
    assert got == want == payloads


def test_storage_path_benchmark_gates_hold():
    ec = registry.instance().factory(
        "cuda", {"k": "4", "m": "2", "technique": "reed_sol_van",
                 "device": "cpu"})
    result = storage_bench.run_storage_path_bench(
        ec, n_objects=48, obj_bytes=1 << 12, writers=8, iters=3)
    assert result["bit_exact"]
    assert (result["k"], result["m"], result["erasures"]) == (4, 2, 2)
    assert result["steady_library_builds"] == {"per_op": 0, "coalesced": 0}
    for mode in ("per_op", "coalesced"):
        r = result[mode]
        assert set(r["stages_s"]) == {"assemble", "transpose", "encode",
                                      "commit", "decode"}
        for lane in ("write", "read"):
            res = r["residency"][lane]
            assert res["library_builds"] == 0
            assert res["granules"] >= 1
            assert res["h2d_per_granule"] <= 1.0, res
    # per-op dispatches one granule an object; coalesced fuses them
    per_op = result["per_op"]["residency"]["write"]["granules"]
    assert per_op == 48
    assert result["coalesced"]["residency"]["write"]["granules"] < per_op


def test_steady_state_library_build_fails_the_benchmark():
    ec = registry.instance().factory(
        "cuda", {"k": "4", "m": "2", "technique": "reed_sol_van",
                 "device": "cpu"})
    dispatch = ec.encode_shard_major_batch

    def leaky(blocks, keep_device=None):
        # a library built on the hot path: setup work in every cycle
        residency.note_library_build()
        return dispatch(blocks, keep_device)

    ec.encode_shard_major_batch = leaky
    with pytest.raises(AssertionError, match="steady-state library"):
        storage_bench.run_storage_path_bench(
            ec, n_objects=8, obj_bytes=1 << 12, writers=2, iters=1)


def _json_of(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert main(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _keys(obj, prefix=""):
    if not isinstance(obj, dict):
        return {prefix}
    out = set()
    for k, v in obj.items():
        out |= _keys(v, f"{prefix}/{k}")
    return out


def test_ec_benchmark_storage_path_profile_prints_reference_keys():
    argv = ["-w", "storage-path", "--objects", "6", "-s", "8192",
            "--writers", "3", "--profile", "-P", "k=4", "-P", "m=2"]
    # each package's process ledger lists a mesh axis once any earlier
    # test in the process dispatched over its mesh plane, which this run
    # does not use: run both on ledgers free of other tests' axes
    ledgers = (residency.counters(), j_residency.counters())
    axes = [dict(ledger.mesh_axes) for ledger in ledgers]
    for ledger in ledgers:
        ledger.mesh_axes.clear()
    try:
        ours = _json_of(ec_benchmark.main, argv + ["-P", "device=cpu"])
        theirs = _json_of(j_ec_benchmark.main, argv + ["-p", "tpu"])
    finally:
        for ledger, saved in zip(ledgers, axes):
            ledger.mesh_axes.update(saved)
    # the one renamed gate: steady_jit_retraces -> steady_library_builds,
    # and jit_retraces -> library_builds in each ledger
    assert _keys(ours) == {k.replace("jit_retraces", "library_builds")
                           for k in _keys(theirs)}
    assert ours["bit_exact"] is True
    assert ours["steady_library_builds"] == {"per_op": 0, "coalesced": 0}
    assert ours["write_h2d_per_granule"] <= 1.0
    assert (ours["k"], ours["m"], ours["n_objects"], ours["obj_bytes"]) == \
        (theirs["k"], theirs["m"], theirs["n_objects"], theirs["obj_bytes"])


def test_ec_benchmark_storage_path_full_result():
    result = _json_of(ec_benchmark.main, [
        "-w", "storage-path", "--objects", "4", "-s", "4096",
        "--writers", "2", "-P", "k=4", "-P", "m=2", "-P", "device=cpu"])
    assert result["bit_exact"] and result["n_objects"] == 4
    assert result["write_speedup"] > 0 and result["read_speedup"] > 0


def test_trace_tool_splits_both_modes(monkeypatch):
    # the card-only tool's host split, at a tiny size on the CPU
    from ceph_tpu_torch import profiling
    from ceph_tpu_torch.tools import trace_main_path as tool

    monkeypatch.setattr(tool, "OBJECTS", 6)
    monkeypatch.setattr(tool, "OBJECT", 5000)
    monkeypatch.setattr(tool, "WRITERS", 3)
    monkeypatch.setattr(tool, "ROUNDS", 2)
    ec = registry.instance().factory(
        "cuda", {"k": "4", "m": "2", "technique": "reed_sol_van",
                 "device": "cpu"})
    h = storage_bench.StoragePathHarness(ec, erasures=2)
    payloads = storage_bench.make_payloads(6, 5000, seed=5)
    loop = asyncio.new_event_loop()
    try:
        store = loop.run_until_complete(
            h.write_pass(payloads, coalesce=True, writers=3))
        rows = {(kind, coalesce): tool.profiled_pass(
                    h, loop, payloads, store, kind, coalesce)
                for kind in ("write", "read") for coalesce in (False, True)}
        alt = tool.alternating_passes(h, loop, payloads, store)
    finally:
        loop.close()
    assert profiling.mode() == "off"
    for (kind, coalesce), row in rows.items():
        assert row["call"] == (f"storage_path_{kind}_"
                               f"{'coalesced' if coalesce else 'per_op'}"
                               "_cprofile")
        assert row["wall_s"] > 0 and row["top_tottime"]
        # 6 objects by 3 writers: two fused dispatches, none per-op
        assert row["coalescer_dispatches"] == (2 if coalesce else 0)
        assert row["loop"]["callbacks"] > 0
    for mode in ("per_op", "coalesced"):
        assert len(alt[mode]["write_GiBs"]) == len(alt[mode]["read_GiBs"]) \
            == 2
    assert set(alt["coalesced_over_per_op_median"]) == {"write_GiBs",
                                                        "read_GiBs"}


@pytest.mark.parametrize("coalesce", [False, True],
                         ids=["per_op", "coalesced"])
def test_trace_tool_write_split(monkeypatch, coalesce):
    """The coalesced write's split (pinned allocations, minor page faults,
    the commit's crc and copy per object) at a tiny size on the CPU: the
    pass commits what ``write_pass`` commits, and every object's commit
    is timed in two parts."""
    from ceph_tpu_torch.tools import trace_main_path as tool

    monkeypatch.setattr(tool, "OBJECTS", 6)
    monkeypatch.setattr(tool, "OBJECT", 5000)
    monkeypatch.setattr(tool, "WRITERS", 3)
    ec = registry.instance().factory(
        "cuda", {"k": "4", "m": "2", "technique": "reed_sol_van",
                 "device": "cpu"})
    h = storage_bench.StoragePathHarness(ec, erasures=2)
    payloads = storage_bench.make_payloads(6, 5000, seed=5)
    commit: list = []
    store = _run(tool._split_write_pass(h, payloads, coalesce, commit))
    assert store == _run(h.write_pass(payloads, coalesce=coalesce,
                                      writers=3))
    assert len(commit) == 6 and all(c >= 0 and p >= 0 for c, p in commit)
    loop = asyncio.new_event_loop()
    try:
        row = tool.write_split(h, loop, payloads, coalesce)
    finally:
        loop.close()
    assert row["call"] == ("storage_path_write_split_"
                           f"{'coalesced' if coalesce else 'per_op'}")
    assert row["minor_faults"] >= 0 and row["wall_s"] > 0
    # no card: no pinned allocation is traced
    assert row["host_alloc_calls_traced"] == {}
    for part in ("commit_crc_ms_per_object", "commit_copy_ms_per_object"):
        assert row[part]["sum_s"] > 0
