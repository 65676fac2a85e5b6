"""The port's device cache tier (``ceph_tpu_torch/tier/``: the store and
its ledger, the agent, the tier bench; the pipeline's H2D upload cache;
the tier hooks of the OSD and ECBackend) against the JAX package's
(``ceph_tpu/tier/``).

Each case is the twin of a ``tests/test_tier.py`` case that needs neither
mon nor mgr: the same script of calls, with the same payloads made with
numpy from a seed, runs through both packages in one process, and each
package's result must pass the reference test's own assertions and equal
the other's -- every read's bytes, every stored object, the tier's hit and
miss counts, which objects are resident and how many bytes, the ledger.
The tolerance is zero.  The port's clusters run the ``cuda`` plugin on
profile ``device=cpu`` (the kernels' plain versions) and its stores
``device="cpu"``; the JAX package's run ``jerasure`` (``tpu`` for
promote-from-encode, its one plugin that composes device blocks).  The
mon's tier commands run through the port's mon-backed cluster (and are
compared with the JAX package's in tests/test_torch_mon.py); the mgr's
tier gauges are refused in the port.
"""

import asyncio
import contextlib
import gc
import types

import numpy as np
import pytest
import torch

from ceph_tpu.matrices import reed_sol as j_reed_sol
from ceph_tpu.ops import pipeline as j_pipeline
from ceph_tpu.osd import cluster as j_cluster
from ceph_tpu.osd import hitset as j_hitset
from ceph_tpu.plugins import registry as j_registry
from ceph_tpu.tier import device_tier as j_device_tier
from ceph_tpu.tier import tier_bench as j_tier_bench
from ceph_tpu.utils import config as j_config
from ceph_tpu.utils.perf import PerfCounters as JPerfCounters
from ceph_tpu_torch.matrices import reed_sol
from ceph_tpu_torch.ops import pipeline
from ceph_tpu_torch.osd import cluster, cluster_bench, hitset
from ceph_tpu_torch.plugins import registry
from ceph_tpu_torch.tier import device_tier, tier_bench
from ceph_tpu_torch.utils import config, unported
from ceph_tpu_torch.utils.perf import PerfCounters

PROFILE = {"k": "2", "m": "1"}


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
    where it cannot, this file's loops, the JAX package's included, run
    under asyncio's default policy."""
    if _policy_runs_tasks():
        yield
        return
    saved = asyncio.get_event_loop_policy()
    asyncio.set_event_loop_policy(asyncio.DefaultEventLoopPolicy())
    yield
    asyncio.set_event_loop_policy(saved)


#: the two packages behind one namespace each, so a scenario is written once
PORT = types.SimpleNamespace(
    name="port",
    make=lambda n, extra=PROFILE, encode_plugin=False: cluster.ECCluster(
        n, dict(extra, device="cpu"), plugin="cuda"),
    store=lambda **kw: device_tier.DeviceTierStore(device="cpu", **kw),
    DeviceByteAccount=device_tier.DeviceByteAccount,
    device_byte_account=device_tier.device_byte_account,
    HitSetTracker=hitset.HitSetTracker, PerfCounters=PerfCounters,
    config=config, pipeline=pipeline, reed_sol=reed_sol,
    codec=lambda **kw: pipeline.DeviceCodec(device="cpu", **kw),
    factory=lambda prof: registry.instance().factory(
        "cuda", dict(prof, device="cpu")),
    tier_bench=tier_bench, host=lambda block: block.numpy())
JAX = types.SimpleNamespace(
    name="jax",
    make=lambda n, extra=PROFILE, encode_plugin=False: j_cluster.ECCluster(
        n, dict(extra, technique="reed_sol_van") if encode_plugin
        else dict(extra), plugin="tpu" if encode_plugin else "jerasure"),
    store=lambda **kw: j_device_tier.DeviceTierStore(**kw),
    DeviceByteAccount=j_device_tier.DeviceByteAccount,
    device_byte_account=j_device_tier.device_byte_account,
    HitSetTracker=j_hitset.HitSetTracker, PerfCounters=JPerfCounters,
    config=j_config, pipeline=j_pipeline, reed_sol=j_reed_sol,
    codec=lambda **kw: j_pipeline.DeviceCodec(**kw),
    factory=lambda prof: j_registry.instance().factory(
        "jerasure", dict(prof), ""),
    tier_bench=j_tier_bench, host=np.asarray)


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _both(scenario):
    """Run ``scenario(pkg)`` for both packages; the port's result must
    equal the JAX package's."""
    mine, theirs = scenario(PORT), scenario(JAX)
    assert mine == theirs
    return mine


@contextlib.contextmanager
def config_vals(pkg, **kv):
    """Temporarily override one package's config options (restored even
    on failure: the global Config outlives each test)."""
    cfg = pkg.config.get_config()
    prior = {k: cfg.get_val(k) for k in kv}
    try:
        for k, v in kv.items():
            cfg.set_val(k, v)
        yield cfg
    finally:
        for k, v in prior.items():
            cfg.set_val(k, v)


async def _tick_all(c):
    for osd in c.osds:
        await osd.tier_tick()


def _primary_shard(c, oid):
    backend = c.primary_backend(oid)
    return next(o for o in c.osds
                if o.pools.get(c.pool) is backend), backend


def _tiers(c) -> list:
    """Every OSD's tier: hits, misses, resident bytes and resident keys."""
    return [(o.tier.hits, o.tier.misses, o.tier.resident_bytes,
             sorted(e["oid"] for e in o.tier.status()["objects"]))
            for o in c.osds]


async def _finish(c, rec: dict) -> dict:
    rec["tiers"] = _tiers(c)
    rec["stores"] = cluster_bench.store_snapshot(c)
    await c.shutdown()
    return rec


# -- store unit coverage ----------------------------------------------------


def test_store_accounting_is_exact():
    def scenario(pkg):
        acct = pkg.DeviceByteAccount()
        perf = pkg.PerfCounters("tier-test")
        store = pkg.store(perf=perf, account=acct, budget=1 << 40)
        b1 = np.ones((3, 128), dtype=np.uint8)
        b2 = np.ones((3, 256), dtype=np.uint8)
        store.put("p", "a", b1, (1, "w"), 200)
        store.put("p", "b", b2, (1, "w"), 400)
        steps = [(store.resident_bytes, acct.used("tier"))]
        assert store.resident_bytes == 3 * 128 + 3 * 256
        assert acct.used("tier") == store.resident_bytes
        # replacement releases the old charge before the new one lands
        store.put("p", "a", b2, (2, "w"), 400)
        assert store.resident_bytes == 2 * 3 * 256
        assert acct.used("tier") == store.resident_bytes
        steps.append((store.resident_bytes, acct.used("tier")))
        assert store.invalidate("p", "b")
        assert acct.used("tier") == 3 * 256
        store.clear()
        assert store.resident_bytes == 0 and acct.used("tier") == 0
        hwm = perf.snapshot()["tier_resident_bytes_hwm"]
        assert hwm == 2 * 3 * 256
        return steps, hwm

    _both(scenario)


def test_store_lookup_semantics():
    def scenario(pkg):
        store = pkg.store(account=pkg.DeviceByteAccount(), budget=1 << 40)
        blk = np.arange(64, dtype=np.uint8).reshape(2, 32)
        store.put("p", "x", blk, (1, "w"), 50, dirty=True)
        # dirty entries read as misses (unconfirmed bytes must not serve)
        assert store.lookup("p", "x") is None
        assert store.misses == 1
        assert store.mark_clean("p", "x", (1, "w"))
        ent = store.lookup("p", "x")
        assert ent is not None and store.hits == 1
        np.testing.assert_array_equal(pkg.host(ent.block), blk)
        # version-checked mark_clean refuses a mismatched write's confirm
        store.put("p", "x", blk, (2, "w"), 50, dirty=True)
        refused = store.mark_clean("p", "x", (1, "w"))
        assert not refused
        # flush drops only the dirty entry
        store.put("p", "y", blk, (1, "w"), 50)
        flushed = store.flush_dirty()
        assert flushed == 1
        assert store.lookup("p", "y") is not None
        assert not store.contains("p", "x")
        return store.hits, store.misses, flushed, store.status()["entries"]

    _both(scenario)


def test_store_eviction_lru_plus_temperature():
    def scenario(pkg):
        temps = {"hot": 1.0, "cold": 0.0, "warm": 0.5}
        store = pkg.store(account=pkg.DeviceByteAccount(),
                          temp_fn=lambda pool, oid: temps[oid],
                          budget=3 * 64 * 2)
        blk = np.zeros((2, 64), dtype=np.uint8)
        for oid in ("hot", "cold", "warm"):
            store.put("p", oid, blk, (1, "w"), 64)
        store._budget = 2 * 128
        freed = store.evict_to_budget()
        assert freed == 128
        assert not store.contains("p", "cold")  # coldest went first
        assert store.contains("p", "hot") and store.contains("p", "warm")
        assert store.resident_bytes <= store.budget()
        # without temperatures the least recently used goes first
        lru = pkg.store(account=pkg.DeviceByteAccount(), budget=1 << 40)
        for oid in ("a", "b", "c"):
            lru.put("p", oid, blk, (1, "w"), 64)
        lru.lookup("p", "a")
        lru._budget = 2 * 128
        lru.evict_to_budget()
        return freed, [(o, lru.contains("p", o)) for o in "abc"]

    assert _both(scenario)[1] == [("a", True), ("b", False), ("c", True)]


def test_invalidate_oid_keep_version():
    def scenario(pkg):
        store = pkg.store(account=pkg.DeviceByteAccount(), budget=1 << 40)
        blk = np.zeros((2, 16), dtype=np.uint8)
        store.put("p1", "o", blk, (3, "osd.0"), 16)
        # the same versioned write's sub-op must NOT evict its own put
        kept = store.invalidate_oid("o", keep_version=(3, "osd.0"))
        assert kept == 0 and store.contains("p1", "o")
        # a different version proves staleness
        dropped = store.invalidate_oid("o", keep_version=(4, "osd.1"))
        assert dropped == 1 and not store.contains("p1", "o")
        return kept, dropped, store.resident_bytes

    _both(scenario)


# -- agent + data-path wiring ----------------------------------------------


def test_read_only_hot_object_gets_promoted_and_served():
    """A READ-only workload heats the hit sets and the agent promotes; the
    next read is a tier hit with identical bytes."""
    async def main(pkg):
        pkg.PerfCounters.reset_all()
        c = pkg.make(4)
        c.set_tier_mode("readproxy")
        payload = bytes(range(256)) * 8
        await c.write("hot-obj", payload)
        shard, _backend = _primary_shard(c, "hot-obj")
        # promotion below must come from READS alone
        shard.hitsets = pkg.HitSetTracker()
        assert shard.hitsets.temperature("hot-obj") == 0.0
        for _ in range(3):
            assert await c.read("hot-obj") == payload
        temp = shard.hitsets.temperature("hot-obj")
        assert temp > 0
        await _tick_all(c)
        assert shard.tier.contains(c.pool, "hot-obj")
        hits_before = shard.tier.hits
        assert await c.read("hot-obj") == payload
        assert shard.tier.hits == hits_before + 1
        hit_reads = shard.perf.snapshot().get("tier_hit_read", 0)
        assert hit_reads >= 1
        # range reads ride the resident block too
        assert await c.read_range("hot-obj", 100, 50) == payload[100:150]
        return await _finish(c, {"temp": temp, "hit_reads": hit_reads})

    _both(lambda pkg: _run(main(pkg)))


def test_cold_objects_stay_unpromoted():
    async def main(pkg):
        pkg.PerfCounters.reset_all()
        c = pkg.make(4)
        c.set_tier_mode("readproxy")
        await c.write("one-touch", b"z" * 512)
        for shard in c.osds:
            shard.hitsets = pkg.HitSetTracker()
        await _tick_all(c)
        assert all(not o.tier.contains(c.pool, "one-touch")
                   for o in c.osds)
        return await _finish(c, {})

    _both(lambda pkg: _run(main(pkg)))


def test_writeback_promote_on_write_and_write_through():
    """A hot object's write refreshes the resident block in place, clean
    after commit; reads serve the NEW bytes."""
    async def main(pkg):
        pkg.PerfCounters.reset_all()
        c = pkg.make(4)
        c.set_tier_mode("writeback")
        v1, v2 = b"a" * 1000, b"b" * 900
        await c.write("obj", v1)
        for _ in range(2):
            await c.read("obj")
        await _tick_all(c)
        shard, _backend = _primary_shard(c, "obj")
        assert shard.tier.contains(c.pool, "obj")
        await c.write("obj", v2)
        ent = shard.tier.lookup(c.pool, "obj")
        assert ent is not None and not ent.dirty
        assert ent.logical_size == len(v2)
        assert await c.read("obj") == v2
        return await _finish(c, {"version": list(ent.version)})

    _both(lambda pkg: _run(main(pkg)))


def test_readproxy_write_invalidates_resident_copy():
    async def main(pkg):
        pkg.PerfCounters.reset_all()
        c = pkg.make(4)
        c.set_tier_mode("readproxy")
        await c.write("obj", b"old" * 100)
        for _ in range(2):
            await c.read("obj")
        await _tick_all(c)
        shard, _ = _primary_shard(c, "obj")
        assert shard.tier.contains(c.pool, "obj")
        await c.write("obj", b"new" * 120)
        # readproxy never write-promotes: the stale block must be gone
        assert not shard.tier.contains(c.pool, "obj")
        assert await c.read("obj") == b"new" * 120
        # partial (RMW) writes invalidate too
        await _tick_all(c)
        repromoted = shard.tier.contains(c.pool, "obj")
        if repromoted:
            await c.write_range("obj", 0, b"XY")
            assert not shard.tier.contains(c.pool, "obj")
        head = (await c.read("obj"))[:2]
        assert head in (b"XY", b"ne")
        return await _finish(c, {"repromoted": repromoted, "head": head})

    _both(lambda pkg: _run(main(pkg)))


def test_eviction_keeps_resident_bytes_under_budget():
    """Under budget pressure the agent evicts and the ledger's total
    stays <= osd_tier_hbm_bytes."""
    async def main(pkg):
        pkg.PerfCounters.reset_all()
        c = pkg.make(4)
        c.set_tier_mode("readproxy")
        payloads = {f"obj{i}": bytes([i]) * 4096 for i in range(6)}
        for oid, data in payloads.items():
            await c.write(oid, data)
            await c.read(oid)  # heat every object
        with config_vals(pkg, osd_tier_hbm_bytes=1 << 30):
            await _tick_all(c)  # promote under a roomy budget
        promoted = sum(o.tier.resident_bytes for o in c.osds)
        assert promoted > 0
        # foreign ledger charges (the upload cache, other live streams)
        # are not the tier's to reclaim: fold them into the budget so the
        # asserted invariant is exactly the one eviction enforces
        foreign = pkg.device_byte_account().used() - promoted
        budget = promoted // 2 + foreign
        with config_vals(pkg, osd_tier_hbm_bytes=budget):
            await _tick_all(c)
            total = sum(o.tier.resident_bytes for o in c.osds)
            assert pkg.device_byte_account().used() <= budget
            assert total <= promoted // 2
        evicted = sum(o.perf.snapshot().get("tier_evict_bytes", 0)
                      for o in c.osds)
        assert evicted > 0
        # reads still serve correct bytes after eviction (fallback path)
        for oid, data in payloads.items():
            assert await c.read(oid) == data
        return await _finish(c, {"promoted": promoted, "total": total,
                                 "evicted": evicted})

    _both(lambda pkg: _run(main(pkg)))


def test_osd_restart_cold_start_correctness():
    """Device memory does not survive the daemon: after a (simulated)
    restart the tier is empty and reads fall back byte-identically."""
    async def main(pkg):
        pkg.PerfCounters.reset_all()
        c = pkg.make(4)
        c.set_tier_mode("writeback")
        payload = b"q" * 3000
        await c.write("obj", payload)
        for _ in range(2):
            await c.read("obj")
        await _tick_all(c)
        shard, _ = _primary_shard(c, "obj")
        assert shard.tier.contains(c.pool, "obj")
        shard.tier.clear()
        assert shard.tier.resident_bytes == 0
        misses = shard.tier.misses
        assert await c.read("obj") == payload
        assert shard.tier.misses > misses
        return await _finish(c, {})

    _both(lambda pkg: _run(main(pkg)))


# -- pipeline H2D cache byte budget ----------------------------------------


def _h2d_data():
    return [np.random.RandomState(i).randint(0, 256, size=(4, 4096),
                                             dtype=np.uint8)
            for i in range(4)]


def test_h2d_cache_respects_byte_budget():
    def scenario(pkg):
        acct = pkg.device_byte_account()
        k, mm, w = 4, 2, 8
        M = pkg.reed_sol.vandermonde_coding_matrix(k, mm, w)
        data = _h2d_data()
        # budget below two packed granules: at most one stays resident
        # (the stream's OWN bytes are asserted -- other live streams in
        # the process may hold charges of their own)
        with config_vals(pkg, osd_tier_h2d_cache_bytes=5 * 4096,
                         osd_tier_hbm_bytes=1 << 30):
            dc = pkg.codec(matrix=M, k=k, m=mm, w=w)
            outs = [np.asarray(dc.encode(d)) for d in data]
            stream = dc.encode_stream()
            entries = len(stream._h2d_cache)
            assert entries <= 1
            own = sum(e[1] for e in stream._h2d_cache.values())
            assert own <= 5 * 4096
            # retirement settles the ledger for this stream exactly
            before = acct.used("h2d")
            stream.release_h2d()
            assert acct.used("h2d") == before - own
        # under a roomy budget repeated content hits the cache
        with config_vals(pkg, osd_tier_h2d_cache_bytes=64 << 20,
                         osd_tier_hbm_bytes=256 << 20):
            dc2 = pkg.codec(matrix=M, k=k, m=mm, w=w)
            out1 = np.asarray(dc2.encode(data[0]))
            out2 = np.asarray(dc2.encode(data[0]))
            np.testing.assert_array_equal(out1, out2)
            cached = len(dc2.encode_stream()._h2d_cache)
            assert cached >= 1
        # the entry sizes differ by design: the JAX package pads a
        # granule up to a rung (64 KiB here, over this budget), the port
        # uploads it as wide as its stripes (16 KiB)
        return [o.tobytes() for o in outs], entries <= 1, cached >= 1

    _both(scenario)
    # the port's hit is a granule that issues no H2D
    from ceph_tpu_torch.analysis import residency

    dc = PORT.codec(matrix=reed_sol.vandermonde_coding_matrix(4, 2, 8),
                    k=4, m=2, w=8)
    d = _h2d_data()[0]
    # room for this stream's entry whatever other live streams hold
    with config_vals(PORT, osd_tier_h2d_cache_bytes=1 << 40,
                     osd_tier_hbm_bytes=1 << 40):
        dc.encode(d)
        before = residency.counters().snapshot()
        dc.encode(d)
    delta = residency.ResidencyCounters.delta(
        before, residency.counters().snapshot())
    assert delta["h2d_ops"] == 0 and delta["d2h_ops"] == 1
    assert dc.encode_stream().h2d_cache_hits == 1


def test_h2d_cache_escape_hatch(monkeypatch):
    def scenario(pkg):
        k, mm, w = 4, 2, 8
        M = pkg.reed_sol.vandermonde_coding_matrix(k, mm, w)
        dc = pkg.codec(matrix=M, k=k, m=mm, w=w)
        d = np.random.RandomState(0).randint(0, 256, size=(k, 1024),
                                             dtype=np.uint8)
        out = np.asarray(dc.encode(d)).tobytes()
        assert np.asarray(dc.encode(d)).tobytes() == out
        return len(dc.encode_stream()._h2d_cache), out

    # each package reads its own variable: the JAX package's leaves the
    # port's cache on, the port's turns it off
    monkeypatch.setenv("CEPH_TPU_NO_H2D_CACHE", "1")
    assert scenario(PORT)[0] == 1 and scenario(JAX)[0] == 0
    monkeypatch.setenv("CEPH_TPU_TORCH_NO_H2D_CACHE", "1")
    assert _both(scenario)[0] == 0


def test_h2d_cache_skips_fresh_granules_of_a_persistent_pipeline():
    """A persistent pipeline (the plugins' write lane and decode batches)
    neither hashes nor retains its fresh granules -- the JAX package
    donates them (``osd_ec_donate``, on by default) -- while its
    ``keep_device`` granules go through the cache in both packages."""
    def scenario(pkg):
        k, mm, w = 4, 2, 8
        M = pkg.reed_sol.vandermonde_coding_matrix(k, mm, w)
        dc = pkg.codec(matrix=M, k=k, m=mm, w=w)
        stream = dc.encode_stream()
        data = _h2d_data()
        with config_vals(pkg, osd_tier_h2d_cache_bytes=64 << 20,
                         osd_tier_hbm_bytes=256 << 20):
            pipe = pkg.pipeline.EncodePipeline(stream)
            outs = []
            for _ in range(2):
                tickets = [pipe.submit(d) for d in data]
                pipe.flush()
                outs += [np.asarray(pipe.result(t)).tobytes()
                         for t in tickets]
            fresh = len(stream._h2d_cache)
            t = pipe.submit(data[0], keep_device=True)
            outs.append(np.asarray(pipe.result(t)).tobytes())
            pipe.device_result(t)
            kept = len(stream._h2d_cache)
            stream.release_h2d()
        return outs, fresh, kept

    outs, fresh, kept = _both(scenario)
    assert fresh == 0 and kept == 1
    assert outs[:4] == outs[4:8] and outs[8] == outs[0]
    # the port's second pass of the same stripes uploads again: no hash,
    # no hit
    from ceph_tpu_torch.analysis import residency

    dc = PORT.codec(matrix=reed_sol.vandermonde_coding_matrix(4, 2, 8),
                    k=4, m=2, w=8)
    pipe = pipeline.EncodePipeline(dc.encode_stream())
    d = _h2d_data()[0]
    pipe.result(pipe.submit(d))
    before = residency.counters().snapshot()
    pipe.result(pipe.submit(d))
    delta = residency.ResidencyCounters.delta(
        before, residency.counters().snapshot())
    assert delta["h2d_ops"] == 1
    assert dc.encode_stream().h2d_cache_hits == 0


# -- bench smoke gate -------------------------------------------------------


def test_tier_path_bench_bit_exact_smoke():
    """Tiny-shape tier-path bench: bit-exactness gate on, both paths
    timed, hit path present."""
    def scenario(pkg):
        ec = pkg.factory({"technique": "reed_sol_van", "k": "2", "m": "1"})
        r = pkg.tier_bench.run_tier_path_bench(
            ec, n_objects=4, obj_bytes=4096, iters=1, erasures=1)
        assert r["bit_exact"] is True
        assert r["hot_read_GiBs"] > 0 and r["cold_read_GiBs"] > 0
        assert r["read_speedup"] is not None
        assert r["tier_hits"] >= 4
        return {key: r[key] for key in ("n_objects", "obj_bytes", "k", "m",
                                        "erasures", "resident_bytes",
                                        "tier_hits")}

    _both(scenario)


def test_tier_path_bench_matches_jax_at_8_objects_of_64_kib():
    def scenario(pkg):
        ec = pkg.factory({"technique": "reed_sol_van", "k": "4", "m": "2"})
        r = pkg.tier_bench.run_tier_path_bench(
            ec, n_objects=8, obj_bytes=64 << 10, iters=1, erasures=2)
        promoted = r["resident_bytes"] // (6 * (16 << 10))
        return promoted, r["resident_bytes"], r["tier_hits"], r["bit_exact"]

    assert _both(scenario) == (8, 8 * 6 * (16 << 10), 17, True)


# -- promote-from-encode and range reads -----------------------------------


def test_promote_from_encode_inserts_resident_encode_output():
    """A hot writeback write hands the tier the encode pipeline's
    still-resident [k+m, bs] block instead of re-uploading the host copy:
    the tier_promote_from_encode counter moves, the entry serves reads,
    and with the toggle off the host put path is used."""
    async def main(pkg):
        pkg.PerfCounters.reset_all()
        c = pkg.make(4, {"k": "2", "m": "1"}, encode_plugin=True)
        c.set_tier_mode("writeback")
        v1 = bytes(range(256)) * 32
        v2 = bytes(reversed(range(256))) * 32
        await c.write("obj", v1)
        for _ in range(2):
            await c.read("obj")
        await _tick_all(c)
        shard, _ = _primary_shard(c, "obj")
        assert shard.tier.contains(c.pool, "obj")
        before = shard.perf.snapshot().get("tier_promote_from_encode", 0)
        await c.write("obj", v2)
        after = shard.perf.snapshot().get("tier_promote_from_encode", 0)
        assert after == before + 1, (before, after)
        ent = shard.tier.lookup(c.pool, "obj")
        assert ent is not None and not ent.dirty
        assert ent.logical_size == len(v2)
        block = pkg.host(ent.block).tobytes()
        assert await c.read("obj") == v2
        assert await c.read_range("obj", 1000, 500) == v2[1000:1500]
        with config_vals(pkg, osd_tier_promote_from_encode=False):
            await c.write("obj", v1)
            final = shard.perf.snapshot().get("tier_promote_from_encode", 0)
            assert final == after
            assert await c.read("obj") == v1
        return await _finish(c, {"counts": (before, after, final),
                                 "block": block})

    rec = _both(lambda pkg: _run(main(pkg)))
    assert rec["counts"][1] == rec["counts"][0] + 1


def test_promote_from_encode_block_lives_on_the_tier_device():
    """The port's promote-from-encode block is the pipeline's own device
    tensor on the tier's device (no host round trip), and a block from
    another device is refused rather than charged."""
    async def main():
        c = PORT.make(4, {"k": "2", "m": "1"})
        c.set_tier_mode("writeback")
        payload = bytes(range(256)) * 32
        await c.write("obj", payload)
        for _ in range(2):
            await c.read("obj")
        await _tick_all(c)
        await c.write("obj", payload[::-1])
        shard, _ = _primary_shard(c, "obj")
        ent = shard.tier.lookup(c.pool, "obj")
        assert ent.block.device.type == "cpu"
        assert ent.block.dtype == torch.uint8
        assert shard.perf.snapshot().get("tier_promote_from_encode") == 1
        await c.shutdown()

    _run(main())
    store = PORT.store(account=PORT.DeviceByteAccount(), budget=1 << 40)
    with pytest.raises(ValueError):
        store.put("p", "o", torch.zeros((2, 8), dtype=torch.uint8,
                                        device="meta"), (1, "w"), 16)
    assert store.resident_bytes == 0


def test_tier_range_read_extents_on_device():
    """Range reads against a resident entry slice the covering stripes'
    chunk columns on the device: every extent shape returns exactly the
    payload slice."""
    async def main(pkg):
        pkg.PerfCounters.reset_all()
        c = pkg.make(4)
        c.set_tier_mode("readproxy")
        payload = np.random.RandomState(3).randint(
            0, 256, size=5000, dtype=np.uint8).tobytes()
        await c.write("obj", payload)
        for _ in range(3):
            await c.read("obj")
        await _tick_all(c)
        shard, _ = _primary_shard(c, "obj")
        assert shard.tier.contains(c.pool, "obj")
        got = []
        for off, ln in ((0, 10), (1, 1), (100, 4000), (4990, 10),
                        (4990, 500), (0, 5000), (2500, 2500)):
            got.append(await c.read_range("obj", off, ln))
            assert got[-1] == payload[off:off + ln], (off, ln)
        assert await c.read_range("obj", 6000, 10) == b""
        return await _finish(c, {"got": got})

    _both(lambda pkg: _run(main(pkg)))


# -- what the port refuses ---------------------------------------------------


def test_mon_tier_commands_and_prometheus_gauges_refuse():
    """The mon's `osd tier` commands run through the port's mon-backed
    cluster (the mon half is lifted); the tier gauges need the mgr's
    report, which the port does not have yet."""
    async def main():
        c = await cluster.ECCluster.create_with_mons(
            4, dict(PROFILE, device="cpu"), plugin="cuda")
        c.set_tier_mode("readproxy")
        await c.write("obj", b"x" * 2048)
        await c.read("obj")
        await _tick_all(c)
        rc, out = await c.mon_command({
            "prefix": "osd tier cache-mode", "pool": c.pool,
            "mode": "writeback"})
        assert (rc, out) == (0, {"pool": c.pool, "cache_mode": "writeback"})
        rc, st = await c.mon_command({"prefix": "osd tier status"})
        assert rc == 0
        assert st["pools"][c.pool] == {"cache_mode": "writeback"}
        assert st["hbm_budget_bytes"] > 0
        assert (await c.mon_command({
            "prefix": "osd tier cache-mode", "pool": c.pool,
            "mode": "turbo"}))[0] == -22
        with pytest.raises(unported.NotPortedError) as exc:
            c.osds[0].mgr_report_stats()
        assert "ceph_tpu/mgr/" in str(exc.value)
        await c.shutdown()

    _run(main())


# -- the tier cycle (chip_smoke.py phase 3d at a small size) ----------------


@pytest.mark.parametrize("mode", ["writeback", "readproxy"])
def test_tier_cycle_matches_jax(mode):
    """``cluster_bench.run_tier_cycle`` -- write, read, agent tick,
    rewrite, read, degraded read, recover, read -- through both packages
    (the JAX package's ``tpu`` plugin, which composes device blocks as the
    port's ``cuda`` plugin does): every step's tier hits, misses, puts,
    evictions and resident bytes, and every store, are the same.  The
    budget holds five of the eight objects, so eviction runs."""
    payloads = cluster_bench.make_payloads(8, 6000, seed=5)
    rewrites = cluster_bench.make_payloads(8, 5000, seed=6)
    block = 3 * 3008  # [k+m, shard_len] of a 6000-byte object at k=2 m=1

    def scenario(pkg):
        async def main():
            pkg.PerfCounters.reset_all()
            c = pkg.make(4, encode_plugin=True)
            # whatever the process's ledger already holds (other tests'
            # live streams, tiers a failed test never cleared) stays
            # charged: the budget leaves the cycle room for five blocks
            # on top, with no upload cache and no collection mid-cycle
            # that would free foreign charges
            budget = 5 * block + pkg.device_byte_account().used()
            with config_vals(pkg, osd_tier_hbm_bytes=budget,
                             osd_tier_h2d_cache_bytes=0):
                r = await cluster_bench.run_tier_cycle(
                    c, mode, payloads, rewrites, writers=3, deadline_s=30.0)
            assert r["final"] == rewrites
            assert max(r["resident_bytes"].values()) <= 5 * block
            return await _finish(c, {key: r[key] for key in (
                "victim", "tier", "resident_bytes",
                "rewritten_still_resident")})

        gc.collect()
        gc.disable()
        try:
            return _run(main())
        finally:
            gc.enable()

    rec = _both(scenario)
    tier = rec["tier"]
    assert tier["tick"]["tier_promote_ops"] > 0 and tier["read"]["hits"] == 0
    assert all(step["tier_agent_failed"] == 0 for step in tier.values())
    if mode == "writeback":
        assert tier["rewrite"]["tier_promote_from_encode"] == 8
        assert tier["rewrite"]["tier_evict_ops"] > 0
        assert tier["read_hot"]["hits"] == 5
    else:
        # every rewrite invalidated its resident copy
        assert rec["rewritten_still_resident"] == []
        assert tier["rewrite"]["tier_promote_from_encode"] == 0
        assert tier["read_hot"]["hits"] == 0
