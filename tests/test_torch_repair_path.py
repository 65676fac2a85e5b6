"""The port's repair-path benchmark (``osd/repair_bench.py``, ``ec_benchmark
-w repair-path``) against the JAX package's, and the uploads of the deep
scrub and of recovery.

Both packages rebuild a wiped OSD of a product-matrix MSR pool (plugin
``regen``, k=4 m=3, 8 OSDs) at the ``--smoke`` shape (8 objects of 6
KiB), through the beta-fractional repair lane and the classic full-stripe
gather: the port on profile ``device=cpu``, the JAX package on the CPU.
The rebuilt victim stores, the drain, the gathered, rebuilt and saved
bytes and the helper symbols served are identical per mode and across
the packages, and the harness's gates hold.

The deep scrub's re-encode and the per-object and batched recovery
decodes upload their granules unhashed (``pipeline.uncached_uploads``):
they add no entry to the H2D upload cache and call no blake2b, while a
one-shot ``encode`` of a repeated buffer still hits; the stores and the
scrub reports are the JAX package's.
"""

import asyncio
import contextlib
import functools
import hashlib
import io
import json
import types

import numpy as np
import pytest

import tools.ec_benchmark as j_ec_benchmark
from ceph_tpu.osd import cluster as j_cluster
from ceph_tpu.osd import repair_bench as j_repair_bench
from ceph_tpu.utils import config as j_config
from ceph_tpu_torch.ops import pipeline
from ceph_tpu_torch.osd import cluster, cluster_bench, repair_bench
from ceph_tpu_torch.tools import ec_benchmark
from ceph_tpu_torch.utils import config
from torch_verify import port_verifiers

CPU_PROFILE = dict(repair_bench.PROFILE, device="cpu")
SMOKE = {"n_osds": 8, "n_objects": 8, "obj_bytes": 6 << 10}


@pytest.fixture(autouse=True)
def _loop_policy():
    """Both packages' loops run under the port's verifiers
    (``tests/torch_verify.py``): its atomic-section verifier, which holds
    both packages' sections, and its residency verifier."""
    with port_verifiers():
        yield


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _payloads(seed=91):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size=SMOKE["obj_bytes"],
                        dtype=np.uint8).tobytes()
            for _ in range(SMOKE["n_objects"])]


def _mode(mod, fractional, **kw):
    return _run(mod._run_mode(
        fractional, n_osds=SMOKE["n_osds"], n_objects=SMOKE["n_objects"],
        obj_bytes=SMOKE["obj_bytes"], payloads=_payloads(), victim=0, **kw))


def test_profile_is_the_card_and_cpu_is_asked_for():
    assert repair_bench.PROFILE == j_repair_bench.PROFILE == \
        {"k": "4", "m": "3", "plugin": "regen"}


@pytest.mark.parametrize("fractional", [False, True],
                         ids=["classic", "fractional"])
def test_rebuilt_stores_and_gather_bytes_match_jax(fractional):
    mine = _mode(repair_bench, fractional, profile=CPU_PROFILE)
    theirs = _mode(j_repair_bench, fractional)
    launches = mine.pop("rebuild_launches")
    assert set(launches) == {"gf2_matrix_w8", "gf2_matrix_w16",
                             "gf2_packet"}
    assert not any(launches.values())  # the CPU runs the plain versions
    mine.pop("time_to_clean_s"), theirs.pop("time_to_clean_s")
    assert mine == theirs
    assert mine["store"] and mine["drain"][-1] == 0
    saved = mine["counters"]["recovery_bytes_saved"]
    assert (saved > 0) == fractional
    assert (mine["counters"]["regen_helpers_served"] > 0) == fractional


def test_repair_path_bench_gates_hold():
    """The JAX package's own smoke test of its harness, through both
    packages: the gates hold and the ratios are the same."""
    r = repair_bench.run_repair_path_bench(
        **SMOKE, time_ratio_bound=2.0, profile=CPU_PROFILE)
    want = j_repair_bench.run_repair_path_bench(**SMOKE,
                                                time_ratio_bound=2.0)
    assert r["bit_exact"] and want["bit_exact"]
    assert r["repair_bytes_ratio"] == want["repair_bytes_ratio"] <= 0.75
    assert r["bytes_saved"] == want["bytes_saved"] > 0
    assert set(r) == set(want)
    for mode in ("classic", "fractional"):
        assert set(r[mode]) == set(want[mode]) | {"rebuild_launches"}
        assert r[mode]["gather_bytes"] == want[mode]["gather_bytes"]


def test_repair_path_bench_gate_fails_on_a_tight_bytes_bound():
    with pytest.raises(AssertionError, match="gather ratio"):
        repair_bench.run_repair_path_bench(
            **SMOKE, bytes_ratio_bound=0.1, time_ratio_bound=1e9,
            profile=CPU_PROFILE)


def _main(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, buf.getvalue().strip().splitlines()


def test_ec_benchmark_repair_path_smoke_prints_the_jax_keys(monkeypatch):
    # at 6 KiB objects each mode cleans in milliseconds: the harnesses'
    # time-to-clean gate runs at the JAX package's own smoke bound
    for mod in (repair_bench, j_repair_bench):
        monkeypatch.setattr(mod, "run_repair_path_bench", functools.partial(
            mod.run_repair_path_bench, time_ratio_bound=2.0))
    rc, out = _main(ec_benchmark, ["-w", "repair-path", "--smoke",
                                   "-P", "device=cpu"])
    assert rc == 0
    got = json.loads(out[-1])
    rc, jout = _main(j_ec_benchmark, ["-w", "repair-path", "--smoke"])
    assert rc == 0
    want = json.loads(jout[-1])
    assert set(got) == set(want)
    assert (got["n_osds"], got["n_objects"], got["obj_bytes"]) == \
        (want["n_osds"], want["n_objects"], want["obj_bytes"]) == \
        (8, 8, 6 << 10)
    assert got["repair_bytes_ratio"] == want["repair_bytes_ratio"]
    assert got["bit_exact"] is True


# -- the scrub's and recovery's uploads -------------------------------------


PORT = types.SimpleNamespace(
    make=lambda: cluster.ECCluster(8, {"k": "4", "m": "2",
                                       "device": "cpu"}, plugin="cuda"),
    config=config)
JAX = types.SimpleNamespace(
    make=lambda: j_cluster.ECCluster(8, {"k": "4", "m": "2"},
                                     plugin="tpu"),
    config=j_config)


class _Blake2bCount:
    """``hashlib`` for the pipeline module, counting blake2b calls."""

    def __init__(self):
        self.calls = 0

    def blake2b(self, *args, **kw):
        self.calls += 1
        return hashlib.blake2b(*args, **kw)


def _scrub_and_recover(pkg, batched, hashes=None):
    """Write, deep-scrub every object, wipe an OSD and recover it, scrub
    again.  With ``hashes`` (the port), the pipeline's blake2b calls and
    the codec's cache entries are counted over the scrubs and the
    recovery."""
    payloads = cluster_bench.make_payloads(6, 20000, seed=8)

    def cached(c):
        codec = c.ec._dc()
        streams = [codec.encode_stream()] + [
            stream for _sel, stream in codec._decode_streams.values()]
        return sum(len(s._h2d_cache) for s in streams)

    async def main():
        cfg = pkg.config.get_config()
        prior = {key: cfg.get_val(key) for key in (
            "osd_recovery_batched", "osd_tier_h2d_cache_bytes",
            "osd_tier_hbm_bytes")}
        cfg.apply_changes({"osd_recovery_batched": batched,
                           "osd_tier_h2d_cache_bytes": 1 << 30,
                           "osd_tier_hbm_bytes": 1 << 31})
        c = pkg.make()
        try:
            for oid, data in payloads.items():
                await c.write(oid, data)
            counts = {}
            if hashes is not None:
                calls, entries = hashes.calls, cached(c)
            reports = [await c.deep_scrub(oid) for oid in payloads]
            if hashes is not None:
                counts["scrub"] = (hashes.calls - calls,
                                   cached(c) - entries)
                calls, entries = hashes.calls, cached(c)
            c.kill_osd(1)
            c.wipe_osd(1)
            c.revive_osd(1)
            for _ in range(12):
                actions = 0
                for osd in c.osds:
                    for backend in osd.pools.values():
                        actions += await backend.peering_pass()
                if actions == 0 and not await c.degraded_report():
                    break
            assert not await c.degraded_report()
            if hashes is not None:
                counts["recovery"] = (hashes.calls - calls,
                                      cached(c) - entries)
            reports += [await c.deep_scrub(oid) for oid in payloads]
            assert {oid: await c.read(oid) for oid in payloads} == payloads
            return (cluster_bench.store_snapshot(c),
                    json.dumps(reports, sort_keys=True, default=str),
                    counts)
        finally:
            cfg.apply_changes(prior)
            await c.shutdown()

    return _run(main())


@pytest.mark.parametrize("batched", [False, True],
                         ids=["per_object", "batched"])
def test_scrub_and_recovery_upload_unhashed(batched, monkeypatch):
    hashes = _Blake2bCount()
    monkeypatch.setattr(pipeline, "hashlib", hashes)
    stores, reports, counts = _scrub_and_recover(PORT, batched, hashes)
    assert counts == {"scrub": (0, 0), "recovery": (0, 0)}
    want_stores, want_reports, _ = _scrub_and_recover(JAX, batched)
    assert stores == want_stores and reports == want_reports
    # every other one-shot caller keeps the cache: a repeated buffer hits
    codec = pipeline.DeviceCodec(
        matrix=np.array([[1, 1], [1, 2]], np.uint32), k=2, m=2, w=8,
        device="cpu")
    data = np.random.RandomState(1).randint(0, 256, (2, 4096), np.uint8)
    calls = hashes.calls
    first = codec.encode(data)
    assert np.array_equal(codec.encode(data), first)
    assert hashes.calls - calls == 2
    assert codec.encode_stream().h2d_cache_hits == 1
    with pipeline.uncached_uploads():
        assert np.array_equal(codec.encode(data), first)
    assert hashes.calls - calls == 2
    assert codec.encode_stream().h2d_cache_hits == 1
    codec.encode_stream().release_h2d()
