"""The port's recovery-path benchmark (``osd/recovery_bench.py``) against
the JAX package's.

Both packages rebuild two wiped OSDs at the JAX package's tier-1 size (8
OSDs, 12 objects of 8 KiB, k=4 m=2) with a concurrent client load: the
port through the ``cuda`` plugin on profile ``device=cpu``, the JAX
package through its ``tpu`` plugin on the CPU.  The rebuilt shard stores
are identical, per mode and across the packages, and the port's gates
hold (bit-exact after the rebuild, the same rebuilt stores in both modes,
the batched lane used, the client p99 bound).  ``ec_benchmark -w
recovery-path`` prints the JAX package's JSON keys.
"""

import asyncio
import contextlib
import io
import json

import numpy as np
import pytest

import tools.ec_benchmark as j_ec_benchmark
from ceph_tpu.osd import recovery_bench as j_recovery_bench
from ceph_tpu_torch.osd import recovery_bench
from ceph_tpu_torch.tools import ec_benchmark
from torch_verify import port_verifiers

CPU_PROFILE = dict(recovery_bench.PROFILE, device="cpu")
SIZES = {"n_osds": 8, "n_objects": 12, "obj_bytes": 8 << 10}


@pytest.fixture(autouse=True)
def _loop_policy():
    """Both packages' loops run under the port's verifiers
    (``tests/torch_verify.py``): its atomic-section verifier, which holds
    both packages' sections, and its residency verifier."""
    with port_verifiers():
        yield


def _payloads(seed=77):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size=SIZES["obj_bytes"],
                        dtype=np.uint8).tobytes()
            for _ in range(SIZES["n_objects"])]


def _mode(mod, batched, **kw):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(mod._run_mode(
            batched, n_osds=SIZES["n_osds"], n_objects=SIZES["n_objects"],
            obj_bytes=SIZES["obj_bytes"], payloads=_payloads(), **kw))
    finally:
        loop.close()


def test_profile_is_the_card_and_cpu_is_asked_for():
    assert recovery_bench.PROFILE == {"k": "4", "m": "2", "plugin": "cuda"}
    assert j_recovery_bench.PROFILE == dict(recovery_bench.PROFILE,
                                            plugin="tpu")


@pytest.mark.parametrize("batched", [False, True],
                         ids=["per_object", "batched"])
def test_rebuilt_stores_match_jax(batched):
    mine = _mode(recovery_bench, batched, profile=CPU_PROFILE)
    theirs = _mode(j_recovery_bench, batched)
    assert mine["store"] == theirs["store"]
    assert mine["rebuilt_bytes"] == theirs["rebuilt_bytes"] > 0
    assert set(mine) == set(theirs)
    assert set(mine["counters"]) == set(theirs["counters"])
    if batched:
        assert mine["counters"]["recovery_ops_batched"] > 0
        assert theirs["counters"]["recovery_ops_batched"] > 0


def test_recovery_path_bench_gates_hold():
    r = recovery_bench.run_recovery_path_bench(
        **SIZES, client_p99_bound_ms=10_000.0, profile=CPU_PROFILE)
    want = j_recovery_bench.run_recovery_path_bench(
        **SIZES, client_p99_bound_ms=10_000.0)
    assert r["bit_exact"] and want["bit_exact"]
    assert r["batched"]["counters"]["recovery_ops_batched"] > 0
    assert r["batched"]["time_to_clean_s"] > 0
    assert set(r) == set(want)
    assert r["batched"]["rebuilt_bytes"] == want["batched"]["rebuilt_bytes"]


def test_recovery_path_bench_gate_fails_on_a_tight_p99_bound():
    with pytest.raises(AssertionError, match="client p99"):
        recovery_bench.run_recovery_path_bench(
            **SIZES, client_p99_bound_ms=0.0, profile=CPU_PROFILE)


def _main(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, buf.getvalue().strip().splitlines()


def test_ec_benchmark_recovery_path_prints_the_jax_keys():
    rc, out = _main(ec_benchmark, [
        "-w", "recovery-path", "--objects", "4", "-s", "4096",
        "-P", "device=cpu"])
    assert rc == 0
    got = json.loads(out[-1])
    rc, jout = _main(j_ec_benchmark, [
        "-w", "recovery-path", "--objects", "4", "-s", "4096",
        "-P", "k=4", "-P", "m=2"])
    assert rc == 0
    want = json.loads(jout[-1])
    assert set(got) == set(want)
    for mode in ("per_object", "batched"):
        assert set(got[mode]) == set(want[mode])
    assert got["n_objects"] == 4 and got["obj_bytes"] == 4096
    assert got["bit_exact"] is True
