"""Recovery-path benchmark stage (bench.py ``recovery_path_host``).

Port of ``ceph_tpu/osd/recovery_bench.py``.

The background-data-plane metric: rebuild a wiped OSD's shards
through the per-object windowed path vs the batched recovery coalescer
(osd/recovery.py), with a CONCURRENT client workload riding the same
mClock op queues -- the scenario the refactor exists for ("rebalance
under heavy client traffic").

Per mode it reports rebuild throughput (authoritative bytes re-pushed /
time-to-clean after the kill+wipe), the client workload's p50/p99
DURING the rebuild, and the background counters
(``recovery_ops_batched``, ``recovery_bytes``, ``recovery_preempted``)
plus a residency-ledger snapshot so recovery's transfer contract is
visible like the write lane's.

Correctness is gated before any number is reported: every object must
read back bit-exact after the rebuild in BOTH modes, the two modes'
recovered shard stores must match byte-for-byte, the batched mode must
actually have used the batched lane, and the batched mode's client p99
must stay under ``client_p99_bound_ms`` (the mClock enforcement
assertion) -- a fast-but-starving rebuild fails the stage.

Used by ``ceph_tpu_torch/tools/ec_benchmark.py --workload
recovery-path`` and ``chip_smoke.py``; tests/test_torch_recovery_path.py
runs it at tiny shapes on the CPU (``profile`` with ``device=cpu``)
beside the JAX package's.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, List

import numpy as np

#: the cuda plugin (the card): its ``decode_batch`` is what the recovery
#: coalescer fuses -- per-object recovery pays one engine dispatch per
#: object, the batched lane one per erasure signature.  Callers pass
#: ``profile=dict(PROFILE, device="cpu")`` to run on the CPU.
PROFILE = {"k": "4", "m": "2", "plugin": "cuda"}


def _pct(samples: List[float], q: float) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(len(s) - 1, int(q * len(s)))]


def _ledger_snapshot() -> Dict[str, int]:
    from ceph_tpu_torch.analysis import residency

    return dict(residency.counters().snapshot())


def _bg_counters() -> Dict[str, int]:
    import json

    from ceph_tpu_torch.utils.perf import PerfCounters

    dump = json.loads(PerfCounters.dump())
    out: Dict[str, int] = {}
    for key in ("recovery_ops_batched", "recovery_bytes",
                "recovery_batches", "recovery_preempted", "recover",
                "recover_window", "scrub_chunks",
                "tier_promote_from_recovery"):
        out[key] = sum(v.get(key, 0) for v in dump.values()
                       if isinstance(v, dict))
    return out


async def _run_mode(batched: bool, *, n_osds: int, n_objects: int,
                    obj_bytes: int, payloads: List[bytes],
                    profile: Dict[str, str]) -> Dict:
    from ceph_tpu_torch.osd.cluster import ECCluster
    from ceph_tpu_torch.utils.config import get_config
    from ceph_tpu_torch.utils.perf import PerfCounters

    PerfCounters.reset_all()
    cfg = get_config()
    prior = cfg.get_val("osd_recovery_batched")
    cfg.apply_changes({"osd_recovery_batched": batched})
    cluster = ECCluster(n_osds, dict(profile), op_queue="mclock")
    try:
        oids = [f"rb{i}" for i in range(n_objects)]
        for oid, data in zip(oids, payloads):
            await cluster.write(oid, data)
        # a separate hot set keeps the concurrent client load off the
        # recovering objects (deterministic rebuild work in both modes)
        hot = [f"hot{i}" for i in range(8)]
        for oid in hot:
            await cluster.write(oid, payloads[0])

        # steady client latency baseline
        steady: List[float] = []
        for oid in hot:
            t0 = time.perf_counter()
            await cluster.read(oid)
            steady.append(time.perf_counter() - t0)

        victims = (0, 1)  # m=2: two replaced disks, still k readable
        for victim in victims:
            cluster.kill_osd(victim)
            cluster.wipe_osd(victim)
            cluster.revive_osd(victim)

        lat: List[float] = []
        stop = asyncio.Event()

        async def client_load():
            i = 0
            while not stop.is_set():
                oid = hot[i % len(hot)]
                t0 = time.perf_counter()
                if i % 3 == 0:
                    await cluster.write(oid, payloads[0])
                else:
                    await cluster.read(oid)
                lat.append(time.perf_counter() - t0)
                i += 1
                await asyncio.sleep(0)

        load_task = asyncio.get_event_loop().create_task(client_load())
        t0 = time.perf_counter()
        try:
            # rebuild until a full pass round reports zero recovery
            # actions (the all-clean confirmation round is part of the
            # timed region in both modes); the degraded scan below is
            # harness bookkeeping, verified OUTSIDE the timed region
            for _pass in range(10):
                n_actions = 0
                for osd in cluster.osds:
                    for backend in osd.pools.values():
                        n_actions += await backend.peering_pass()
                if n_actions == 0:
                    break
        finally:
            stop.set()
            await load_task
        time_to_clean = time.perf_counter() - t0
        if await cluster.degraded_report():
            raise AssertionError(
                f"recovery-path ({'batched' if batched else 'per-object'})"
                ": cluster never reached clean")

        # bit-exactness gate: every object reads back exactly
        for oid, data in zip(oids, payloads):
            got = await cluster.read(oid)
            if got != data:
                raise AssertionError(
                    f"recovery-path: {oid} mismatched after rebuild")
        # the recovered shard stores, for cross-mode byte comparison
        store = {}
        for victim in victims:
            for stored in cluster.osds[victim].store.list_objects():
                store[f"osd{victim}/{stored}"] = \
                    cluster.osds[victim].store.read(stored)

        counters = _bg_counters()
        rebuilt_bytes = sum(len(v) for v in store.values())
        return {
            "time_to_clean_s": round(time_to_clean, 4),
            "rebuild_MiBs": round(
                sum(len(v) for v in store.values())
                / max(time_to_clean, 1e-9) / (1 << 20), 3),
            "rebuilt_bytes": rebuilt_bytes,
            "client_p50_ms": round(_pct(lat, 0.50) * 1e3, 3),
            "client_p99_ms": round(_pct(lat, 0.99) * 1e3, 3),
            "client_ops_during_rebuild": len(lat),
            "steady_p99_ms": round(_pct(steady, 0.99) * 1e3, 3),
            "counters": counters,
            "store": store,
        }
    finally:
        cfg.apply_changes({"osd_recovery_batched": prior})
        await cluster.shutdown()


def run_recovery_path_bench(*, n_osds: int = 8, n_objects: int = 96,
                            obj_bytes: int = 32 << 10,
                            client_p99_bound_ms: float = 2000.0,
                            seed: int = 77,
                            profile: Dict[str, str] = PROFILE) -> Dict:
    rng = np.random.RandomState(seed)
    payloads = [
        rng.randint(0, 256, size=obj_bytes, dtype=np.uint8).tobytes()
        for _ in range(n_objects)
    ]
    loop = asyncio.new_event_loop()
    try:
        l0 = _ledger_snapshot()
        per_obj = loop.run_until_complete(_run_mode(
            False, n_osds=n_osds, n_objects=n_objects,
            obj_bytes=obj_bytes, payloads=payloads, profile=profile))
        l1 = _ledger_snapshot()
        batched = loop.run_until_complete(_run_mode(
            True, n_osds=n_osds, n_objects=n_objects,
            obj_bytes=obj_bytes, payloads=payloads, profile=profile))
        l2 = _ledger_snapshot()
    finally:
        loop.close()

    # cross-mode gate: both rebuild paths must leave the wiped OSD with
    # byte-identical shard objects
    ps, bs = per_obj.pop("store"), batched.pop("store")
    if set(ps) != set(bs):
        raise AssertionError("recovery-path: rebuilt shard sets differ "
                             "between batched and per-object modes")
    for soid in ps:
        if ps[soid] != bs[soid]:
            raise AssertionError(
                f"recovery-path: rebuilt shard {soid} differs between "
                "batched and per-object modes")
    if batched["counters"]["recovery_ops_batched"] <= 0:
        raise AssertionError(
            "recovery-path: batched mode never used the batched lane")
    if batched["client_p99_ms"] > client_p99_bound_ms:
        raise AssertionError(
            f"recovery-path: client p99 {batched['client_p99_ms']}ms "
            f"exceeded the {client_p99_bound_ms}ms bound during the "
            "batched rebuild (mClock enforcement regressed)")
    return {
        "n_osds": n_osds,
        "n_objects": n_objects,
        "obj_bytes": obj_bytes,
        "bit_exact": True,  # the gates raised otherwise
        "client_p99_bound_ms": client_p99_bound_ms,
        "per_object": per_obj,
        "batched": batched,
        "rebuild_speedup": round(
            per_obj["time_to_clean_s"]
            / max(batched["time_to_clean_s"], 1e-9), 3),
        "residency": {
            "per_object": {k: l1[k] - l0[k] for k in l0},
            "batched": {k: l2[k] - l1[k] for k in l1},
        },
    }
