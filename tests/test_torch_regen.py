"""The port's regenerating code (``matrices/product_matrix.py``,
``plugins/regen.py`` and the cluster's regen lane in ``osd/shard.py`` and
``osd/recovery.py``) against the JAX package's.

The same profiles as ``tests/test_regen.py``, the same bytes made with
numpy from a seed, run through both packages in one process; the
tolerance is zero.  The port's codec runs on profile ``device=cpu``: its
encode and decode pipelines run the kernels' plain PyTorch versions, and
its repair lanes the host LUT engine, as the JAX package's do off a TPU.
The repair lanes' device pipeline (the card's) is also driven here on the
CPU, by opening the lane gate, and must give the same bytes.  The regen
cluster's stores after a wipe and rebuild are identical to the JAX
package's.
"""

import asyncio
import errno
import itertools

import numpy as np
import pytest
import torch

from ceph_tpu.matrices import product_matrix as j_product_matrix
from ceph_tpu.osd.cluster import ECCluster as JECCluster
from ceph_tpu.plugins import regen as j_regen
from ceph_tpu.plugins import registry as j_registry
from ceph_tpu.plugins.interface import ErasureCodeError as JErasureCodeError
from ceph_tpu.utils.config import get_config as j_get_config
from ceph_tpu_torch.matrices import product_matrix
from ceph_tpu_torch.osd import cluster_bench
from ceph_tpu_torch.osd.cluster import ECCluster
from ceph_tpu_torch.plugins import regen
from ceph_tpu_torch.plugins import registry
from ceph_tpu_torch.plugins.interface import ErasureCodeError
from ceph_tpu_torch.utils.config import get_config
from torch_verify import port_verifiers

#: (k, m) of the JAX package's codec sweeps
KM = [(2, 2), (4, 3), (6, 5), (8, 7)]


@pytest.fixture(autouse=True)
def _loop_policy():
    """Both packages' loops run under the port's verifiers
    (``tests/torch_verify.py``): its atomic-section verifier, which holds
    both packages' sections, and its residency verifier."""
    with port_verifiers():
        yield


@pytest.fixture(params=["host_lane", "pipeline_lane"])
def lane(request, monkeypatch):
    """The port's repair lanes as on the CPU (host LUT engine) and as on
    the card (the device pipeline, here with the plain versions)."""
    if request.param == "pipeline_lane":
        monkeypatch.setattr(regen, "_pipeline_lane", lambda device: True)
    return request.param


def _pair(k, m):
    mine = registry.ErasureCodePluginRegistry().factory(
        "regen", {"k": str(k), "m": str(m), "device": "cpu"})
    theirs = j_registry.ErasureCodePluginRegistry().factory(
        "regen", {"k": str(k), "m": str(m)})
    return mine, theirs


def _same_maps(a, b):
    assert set(a) == set(b)
    for c in a:
        assert np.array_equal(np.asarray(a[c]), np.asarray(b[c])), c


# -- the construction -------------------------------------------------------


@pytest.mark.parametrize("k,m", KM)
def test_product_matrix_equals_the_jax_packages(k, m):
    mine = product_matrix.ProductMatrixMSR(k, m)
    theirs = j_product_matrix.ProductMatrixMSR(k, m)
    assert np.array_equal(mine.generator, theirs.generator)
    assert mine.generator.dtype == theirs.generator.dtype
    assert mine._lam == theirs._lam
    n = k + m
    for lost in range(n):
        assert mine.repair_coeffs(lost) == theirs.repair_coeffs(lost)
        helpers = [s for s in range(n) if s != lost][:mine.d]
        assert np.array_equal(mine.repair_matrix(lost, helpers),
                              theirs.repair_matrix(lost, helpers))


@pytest.mark.parametrize("args", [(4, 3, 16), (1, 3, 8), (4, 2, 8)])
def test_product_matrix_refusals_match(args):
    with pytest.raises(ValueError) as mine:
        product_matrix.ProductMatrixMSR(*args)
    with pytest.raises(ValueError) as theirs:
        j_product_matrix.ProductMatrixMSR(*args)
    assert str(mine.value) == str(theirs.value)


# -- the codec --------------------------------------------------------------


@pytest.mark.parametrize("k,m", KM)
def test_encode_and_every_decode_pattern_match_jax(k, m):
    """Encode, then every erasure pattern of up to m whole nodes (the
    first 40 of them, as the JAX package's sweep), both through the sync
    contract and the batched API."""
    mine, theirs = _pair(k, m)
    n = k + m
    rng = np.random.default_rng(17 + k)
    data = rng.integers(0, 256, 2000 * k, dtype=np.uint8).tobytes()
    chunks = mine.encode(set(range(n)), data)
    _same_maps(chunks, theirs.encode(set(range(n)), data))
    patterns = [p for r in sorted({1, 2, m})
                for p in itertools.combinations(range(n), r)]
    for gone in patterns[:40]:
        have = {s: chunks[s] for s in range(n) if s not in gone}
        _same_maps(mine.decode(set(gone), dict(have)),
                   theirs.decode(set(gone), dict(have)))
    maps = [{s: chunks[s] for s in range(n) if s not in gone}
            for gone in patterns[:6]]
    for a, b in zip(mine.decode_batch(maps), theirs.decode_batch(maps)):
        _same_maps(a, b)
    stripes = [rng.integers(0, 256, 1500 * k, dtype=np.uint8).tobytes()
               for _ in range(3)]
    for a, b in zip(mine.encode_batch(stripes),
                    theirs.encode_batch(stripes)):
        _same_maps(a, b)
    assert mine.decode_concat(chunks) == theirs.decode_concat(chunks)


@pytest.mark.parametrize("k,m", KM)
def test_minimum_to_decode_matches_jax(k, m):
    """The d-helper single-loss plan, the classic multi-loss plan and the
    refusal below k survivors."""
    mine, theirs = _pair(k, m)
    n = k + m
    for want in ([0], [n - 1], [0, 1], [k - 1, k]):
        for avail in ([s for s in range(n) if s not in want],
                      [s for s in range(n) if s not in want][:k]):
            assert mine.minimum_to_decode(want, avail) == \
                theirs.minimum_to_decode(want, avail)
    with pytest.raises(ErasureCodeError) as e1:
        mine.minimum_to_decode([0], list(range(1, k)))
    with pytest.raises(JErasureCodeError) as e2:
        theirs.minimum_to_decode([0], list(range(1, k)))
    assert e1.value.errno == e2.value.errno


@pytest.mark.parametrize("k", [2, 4, 6, 8])
def test_helpers_and_regeneration_match_jax_every_loss(k, lane):
    """For every single lost node: the helper symbols of the d survivors
    and the regenerated shard equal the JAX package's and the lost
    chunk."""
    m = max(2, k - 1)
    mine, theirs = _pair(k, m)
    n = k + m
    rng = np.random.default_rng(5 + k)
    chunks = mine.encode(set(range(n)),
                         rng.integers(0, 256, 3000 * k,
                                      dtype=np.uint8).tobytes())
    for lost in range(n):
        coeffs = mine.repair_coeffs(lost)
        assert coeffs == theirs.repair_coeffs(lost)
        helpers = sorted(s for s in range(n) if s != lost)[:mine.d]
        got = regen.compute_helpers(coeffs, [chunks[h] for h in helpers],
                                    device="cpu")
        want = j_regen.compute_helpers(coeffs, [chunks[h] for h in helpers])
        assert [g.tobytes() for g in got] == [w.tobytes() for w in want]
        stacks = [np.stack(got)] * 2
        out = mine.regenerate_batch(lost, helpers, stacks)
        ref = theirs.regenerate_batch(lost, helpers, stacks)
        assert [o.tobytes() for o in out] == [r.tobytes() for r in ref]
        assert np.array_equal(out[0], chunks[lost])


@pytest.mark.parametrize("beta", [1, 3, 4, 5, 32, 37, 96, 100])
def test_regeneration_widths_match_jax(beta, lane):
    """Widths below a lane, off the 4-byte lane grid and past a rung:
    widths that are not whole int32 lanes take the host LUT path on the
    card as in the JAX package, and every width gives the JAX package's
    bytes."""
    k = 4
    mine, theirs = _pair(k, 3)
    n = mine.get_chunk_count()
    rng = np.random.default_rng(beta)
    chunk_len = mine.alpha * beta
    encoded = {i: rng.integers(0, 256, chunk_len, dtype=np.uint8)
               for i in range(k)}
    encoded.update({i: np.zeros(chunk_len, np.uint8) for i in range(k, n)})
    want = {i: a.copy() for i, a in encoded.items()}
    mine.encode_chunks(set(range(n)), encoded)
    theirs.encode_chunks(set(range(n)), want)
    _same_maps(encoded, want)
    for lost in (0, k - 1, k, n - 1):
        helpers = sorted(s for s in range(n) if s != lost)[:mine.d]
        coeffs = mine.repair_coeffs(lost)
        stack = np.stack(regen.compute_helpers(
            coeffs, [encoded[h] for h in helpers], device="cpu"))
        out = mine.regenerate_batch(lost, helpers, [stack])[0]
        assert out.tobytes() == \
            theirs.regenerate_batch(lost, helpers, [stack])[0].tobytes()
        assert np.array_equal(out, encoded[lost])


def test_pipeline_lane_runs_the_device_codecs(monkeypatch):
    """With the lane open, helper symbols and regeneration go through
    ``DeviceCodec``s on the codec's device (keyed by coefficients and
    device), and widths off the lane grid do not."""
    monkeypatch.setattr(regen, "_pipeline_lane", lambda device: True)
    regen._release_codecs(regen._HELPER_CODECS)
    mine, _ = _pair(4, 3)
    chunks = mine.encode(set(range(7)), bytes(range(256)) * 48)
    coeffs = mine.repair_coeffs(2)
    helpers = [0, 1, 3, 4, 5, 6]
    stack = np.stack(regen.compute_helpers(
        coeffs, [chunks[h] for h in helpers], device="cpu"))
    assert list(regen._HELPER_CODECS) == [(tuple(coeffs), "cpu")]
    assert mine.regenerate_batch(2, helpers, [stack])[0].tobytes() == \
        chunks[2].tobytes()
    assert list(mine._regen_codecs) == [(2, tuple(helpers))]
    codec = mine._regen_codecs[(2, tuple(helpers))]
    assert codec.device.type == "cpu" and codec.k == mine.d
    regen._release_codecs(regen._HELPER_CODECS)
    regen.compute_helpers(coeffs, [np.zeros(9, np.uint8)], device="cpu")
    assert regen._HELPER_CODECS == {}


def test_insufficient_or_bad_helpers_refuse_as_jax():
    mine, theirs = _pair(4, 3)
    beta = 8
    cases = [(0, list(range(1, 6)), np.zeros((5, beta), np.uint8)),
             (0, [1, 1, 2, 3, 4, 5], np.zeros((6, beta), np.uint8)),
             (0, [0, 1, 2, 3, 4, 5], np.zeros((6, beta), np.uint8))]
    for lost, helpers, stack in cases:
        with pytest.raises(ValueError) as e1:
            mine.regenerate_batch(lost, helpers, [stack])
        with pytest.raises(ValueError) as e2:
            theirs.regenerate_batch(lost, helpers, [stack])
        assert str(e1.value) == str(e2.value)
    with pytest.raises(ValueError) as e1:
        regen.compute_helpers(mine.repair_coeffs(0),
                              [np.zeros(7, np.uint8)], device="cpu")
    with pytest.raises(ValueError) as e2:
        j_regen.compute_helpers(theirs.repair_coeffs(0),
                                [np.zeros(7, np.uint8)])
    assert str(e1.value) == str(e2.value)


@pytest.mark.parametrize("profile", [
    {"k": "4", "m": "3", "d": "5"},
    {"k": "4", "m": "2"},
    {"k": "1", "m": "3"},
    {"k": "4", "m": "3", "w": "16"},
    {"k": "4", "m": "3", "technique": "clay"},
])
def test_profile_guard_rails_match_jax(profile):
    with pytest.raises(ErasureCodeError) as e1:
        registry.ErasureCodePluginRegistry().factory(
            "regen", dict(profile, device="cpu"))
    with pytest.raises(JErasureCodeError) as e2:
        j_registry.ErasureCodePluginRegistry().factory(
            "regen", dict(profile))
    assert e1.value.errno == e2.value.errno == -errno.EINVAL
    assert str(e1.value) == str(e2.value)


def test_registry_publishes_the_jax_profile_and_the_device():
    mine = registry.instance().factory(
        "regen", {"k": "6", "m": "5", "technique": "product_matrix",
                  "device": "cpu"})
    theirs = j_registry.instance().factory(
        "regen", {"k": "6", "m": "5", "technique": "product_matrix"})
    prof = dict(mine.get_profile())
    assert prof.pop("device") == "cpu"
    assert prof == theirs.get_profile() and prof["d"] == "10"
    assert mine.get_chunk_count() == 11 and mine.fractional_repair
    assert mine.get_sub_chunk_count() == theirs.get_sub_chunk_count() == 5
    for size in (1, 4096, 4 << 20):
        assert mine.get_chunk_size(size) == theirs.get_chunk_size(size)


def test_the_card_is_the_default_and_cpu_is_asked_for():
    """No profile ``device`` means the card: without CUDA the factory
    and ``compute_helpers`` raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        registry.instance().factory("regen", {"k": "4", "m": "3"})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        regen.compute_helpers([1, 2, 3], [np.zeros(12, np.uint8)])


def test_mesh_lane_is_refused_not_skipped(monkeypatch):
    """Lifted since the port has the mesh data plane: with a plane up,
    the helper symbols and the regeneration run on the daemon's mesh slot
    (the plane's slot-local dispatch, ``gf2_matrix_w8``'s plain twin on
    CPU slots) and give the JAX package's mesh lane's bytes, and the
    single-device lanes' -- nothing is refused or skipped."""
    from ceph_tpu.parallel import mesh_plane as j_mesh_plane
    from ceph_tpu_torch import parallel
    from ceph_tpu_torch.parallel import mesh_plane

    mine, theirs = _pair(4, 3)
    rng = np.random.RandomState(41)
    shards = [rng.randint(0, 256, 3 * 2000, dtype=np.uint8)
              for _ in range(3)]
    stacks = [rng.randint(0, 256, (6, 2000), dtype=np.uint8)
              for _ in range(2)]
    helpers = [1, 2, 3, 4, 5, 6]
    plain = (regen.compute_helpers([1, 2, 3], shards, device="cpu"),
             mine.regenerate_batch(0, helpers, stacks))
    parallel.configure_devices(["cpu"] * 4)
    try:
        plane = mesh_plane.configure(4)
        jplane = j_mesh_plane.configure(4)
        plane.bind("osd.0")
        jplane.bind("osd.0")
        monkeypatch.setattr(regen, "_mesh_plane", lambda: plane)
        monkeypatch.setattr(j_regen, "_mesh_plane", lambda: jplane)
        got = (regen.compute_helpers([1, 2, 3], shards, "osd.0",
                                     device="cpu"),
               mine.regenerate_batch(0, helpers, stacks))
        want = (j_regen.compute_helpers([1, 2, 3], shards, "osd.0"),
                theirs.regenerate_batch(0, helpers, stacks))
        assert plane.counters["mesh_local_dispatches"] == 2
        assert plane.counters == jplane.counters
    finally:
        parallel.configure_devices(None)
        mesh_plane.reset()
        j_mesh_plane.reset()
    for a, b, c in zip(got, want, plain):
        assert len(a) == len(b) == len(c)
        for x, y, z in zip(a, b, c):
            assert np.array_equal(x, y) and np.array_equal(x, z)


# -- the cluster's regen lane -----------------------------------------------


REGEN_PROFILE = {"k": "4", "m": "3", "plugin": "regen"}


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


async def _rebuild_until_clean(cluster, max_rounds: int = 12) -> None:
    for _ in range(max_rounds):
        actions = 0
        for osd in cluster.osds:
            for backend in osd.pools.values():
                actions += await backend.peering_pass()
        if actions == 0 and not await cluster.degraded_report():
            return
    raise AssertionError(
        f"never reached clean: {await cluster.degraded_report()}")


def _pool_counter(cluster, name: str) -> int:
    return sum(b.perf.snapshot().get(name, 0)
               for osd in cluster.osds for b in osd.pools.values())


def _wipe_and_rebuild(make, cfg):
    """The JAX package's regen cluster script: write objects, wipe one
    OSD, rebuild until clean, read back."""
    async def main():
        prior = cfg.get_val("osd_recovery_batched")
        cfg.apply_changes({"osd_recovery_batched": True})
        cluster = make()
        try:
            rng = np.random.default_rng(11)
            objs = {}
            for i in range(6):
                data = rng.integers(0, 256, 2500 + 901 * i,
                                    dtype=np.uint8).tobytes()
                objs[f"r{i}"] = data
                await cluster.write(f"r{i}", data)
            objs["zero"] = b""
            await cluster.write("zero", b"")
            before = cluster_bench.store_snapshot(cluster)
            cluster.kill_osd(0)
            cluster.wipe_osd(0)
            cluster.revive_osd(0)
            await _rebuild_until_clean(cluster)
            reads = {oid: await cluster.read(oid) for oid in objs}
            assert reads == objs
            return {
                "before": before,
                "after": cluster_bench.store_snapshot(cluster),
                "saved": _pool_counter(cluster, "recovery_bytes_saved"),
                "rebuilt": _pool_counter(cluster, "recovery_bytes"),
                "gather": _pool_counter(cluster, "recovery_gather_bytes"),
                "helpers": sum(o.perf.snapshot().get(
                    "regen_helpers_served", 0) for o in cluster.osds),
            }
        finally:
            cfg.apply_changes({"osd_recovery_batched": prior})
            await cluster.shutdown()

    return _run(main())


def test_cluster_repair_rides_the_regen_lane_as_jax(lane):
    """Single-shard repair on a regen pool gathers d beta-sized helper
    symbols: the stores before and after the rebuild, the bytes saved,
    gathered and rebuilt and the helper symbols served are the JAX
    package's."""
    mine = _wipe_and_rebuild(
        lambda: ECCluster(8, dict(REGEN_PROFILE, device="cpu"),
                          op_queue="mclock"), get_config())
    theirs = _wipe_and_rebuild(
        lambda: JECCluster(8, dict(REGEN_PROFILE), op_queue="mclock"),
        j_get_config())
    assert mine == theirs
    assert mine["saved"] > 0 and mine["helpers"] > 0
    assert mine["saved"] == mine["rebuilt"] * 2
