"""Repair-path benchmark stage (bench.py ``repair_path_host``).

Port of ``ceph_tpu/osd/repair_bench.py``.

The regenerating-code repair metric: rebuild a wiped OSD on a
product-matrix MSR pool (plugin ``regen``, d = 2k-2) through the
beta-fractional repair lane vs the classic full-stripe gather on the
SAME pool (``osd_ec_fractional_repair`` off) -- identical data,
identical plugin, only the repair plan differs.

Per mode it reports time-to-clean after the kill+wipe, the measured
gather bytes (``recovery_gather_bytes``: what survivors actually put on
the wire), the bytes-saved accounting and the chaos drain profile
(degraded count per peering round).

Correctness is gated before any number is reported, per mode and
across modes:

- chaos sequence: the wipe must show a degraded PEAK, the degraded
  count must drain MONOTONICALLY round over round, and the pool must
  end clean (the HEALTH_OK analogue: zero actions + empty degraded
  report);
- every object reads back bit-exact after the rebuild in BOTH modes,
  and the rebuilt victim stores match byte-for-byte across modes (a
  regenerated shard is the same bytes a full-stripe decode produces);
- the fractional mode must actually have used the regen lane
  (``recovery_bytes_saved`` > 0, helpers served) and the classic mode
  must not have;
- ``repair_bytes_ratio`` (fractional gather / classic gather) must be
  <= ``bytes_ratio_bound`` (default 0.75; MSR at k=4 measures ~0.5) and
  ``time_to_clean_ratio`` must stay <= ``time_ratio_bound`` (repair
  must not get slower for its bandwidth savings).

Beside the JAX package's keys, each mode reports ``rebuild_launches``:
the codec kernels launched during its drain (``ops/cuda_gf.py``
counts; all zero on the CPU, where the kernels' plain versions run).

Used by ``ceph_tpu_torch/tools/ec_benchmark.py --workload repair-path``
and ``chip_smoke.py``; tests/test_torch_repair_path.py runs it at tiny
shapes on the CPU (``profile`` with ``device=cpu``) beside the JAX
package's.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, List

import numpy as np

#: product-matrix MSR pool: d = 2k-2 = 6 helpers, alpha = k-1 = 3
#: sub-chunks per shard, repair moves d*beta = 2 chunks vs k = 4 classic.
#: The plugin runs on the card; callers pass
#: ``profile=dict(PROFILE, device="cpu")`` to run on the CPU.
PROFILE = {"k": "4", "m": "3", "plugin": "regen"}


def _bg_counters() -> Dict[str, int]:
    import json

    from ceph_tpu_torch.utils.perf import PerfCounters

    dump = json.loads(PerfCounters.dump())
    out: Dict[str, int] = {}
    for key in ("recovery_ops_batched", "recovery_bytes",
                "recovery_gather_bytes", "recovery_bytes_saved",
                "regen_helpers_served", "recovery_batches"):
        out[key] = sum(v.get(key, 0) for v in dump.values()
                       if isinstance(v, dict))
    return out


def _launches() -> Dict[str, int]:
    from ceph_tpu_torch.ops import cuda_gf

    return dict(cuda_gf.launches)


async def _run_mode(fractional: bool, *, n_osds: int, n_objects: int,
                    obj_bytes: int, payloads: List[bytes],
                    victim: int, profile: Dict[str, str]) -> Dict:
    from ceph_tpu_torch.osd.cluster import ECCluster
    from ceph_tpu_torch.utils.config import get_config
    from ceph_tpu_torch.utils.perf import PerfCounters

    PerfCounters.reset_all()
    cfg = get_config()
    prior = cfg.get_val("osd_ec_fractional_repair")
    cfg.apply_changes({"osd_ec_fractional_repair": fractional,
                       "osd_recovery_batched": True})
    cluster = ECCluster(n_osds, dict(profile), op_queue="mclock")
    mode = "fractional" if fractional else "classic"
    try:
        oids = [f"rp{i}" for i in range(n_objects)]
        for oid, data in zip(oids, payloads):
            await cluster.write(oid, data)

        # chaos sequence: wipe -> degraded peak -> monotone drain ->
        # clean.  The degraded poll between rounds is harness
        # bookkeeping paid equally by both modes.
        cluster.kill_osd(victim)
        cluster.wipe_osd(victim)
        cluster.revive_osd(victim)
        peak = len(await cluster.degraded_report())
        if peak == 0:
            raise AssertionError(
                f"repair-path ({mode}): wipe produced no degraded peak")

        drain: List[int] = [peak]
        launched = _launches()
        t0 = time.perf_counter()
        for _round in range(16):
            n_actions = 0
            for osd in cluster.osds:
                for backend in osd.pools.values():
                    n_actions += await backend.peering_pass()
            degraded = len(await cluster.degraded_report())
            drain.append(degraded)
            if n_actions == 0 and degraded == 0:
                break
        time_to_clean = time.perf_counter() - t0
        launched = {name: n - launched.get(name, 0)
                    for name, n in _launches().items()}
        if drain[-1] != 0:
            raise AssertionError(
                f"repair-path ({mode}): never reached clean "
                f"(drain={drain})")
        if any(b > a for a, b in zip(drain, drain[1:])):
            raise AssertionError(
                f"repair-path ({mode}): degraded count regressed "
                f"mid-drain (drain={drain})")

        # bit-exactness gate: every object reads back exactly
        for oid, data in zip(oids, payloads):
            got = await cluster.read(oid)
            if got != data:
                raise AssertionError(
                    f"repair-path ({mode}): {oid} mismatched after "
                    "rebuild")
        # the victim's rebuilt shard store, for cross-mode comparison
        store = {
            stored: cluster.osds[victim].store.read(stored)
            for stored in cluster.osds[victim].store.list_objects()
        }
        counters = _bg_counters()
        return {
            "time_to_clean_s": round(time_to_clean, 4),
            "degraded_peak": peak,
            "drain": drain,
            "rebuilt_bytes": counters["recovery_bytes"],
            "gather_bytes": counters["recovery_gather_bytes"],
            "counters": counters,
            "rebuild_launches": launched,
            "store": store,
        }
    finally:
        cfg.apply_changes({"osd_ec_fractional_repair": prior})
        await cluster.shutdown()


def run_repair_path_bench(*, n_osds: int = 8, n_objects: int = 48,
                          obj_bytes: int = 24 << 10,
                          bytes_ratio_bound: float = 0.75,
                          time_ratio_bound: float = 1.25,
                          seed: int = 91,
                          profile: Dict[str, str] = PROFILE) -> Dict:
    rng = np.random.RandomState(seed)
    payloads = [
        rng.randint(0, 256, size=obj_bytes, dtype=np.uint8).tobytes()
        for _ in range(n_objects)
    ]
    victim = 0
    loop = asyncio.new_event_loop()
    try:
        classic = loop.run_until_complete(_run_mode(
            False, n_osds=n_osds, n_objects=n_objects,
            obj_bytes=obj_bytes, payloads=payloads, victim=victim,
            profile=profile))
        fractional = loop.run_until_complete(_run_mode(
            True, n_osds=n_osds, n_objects=n_objects,
            obj_bytes=obj_bytes, payloads=payloads, victim=victim,
            profile=profile))
    finally:
        loop.close()

    # cross-mode gate: regeneration must produce the exact bytes a
    # full-stripe decode does
    cs, fs = classic.pop("store"), fractional.pop("store")
    if set(cs) != set(fs):
        raise AssertionError("repair-path: rebuilt shard sets differ "
                             "between fractional and classic modes")
    for soid in cs:
        if cs[soid] != fs[soid]:
            raise AssertionError(
                f"repair-path: rebuilt shard {soid} differs between "
                "fractional and classic modes")
    if fractional["counters"]["recovery_bytes_saved"] <= 0:
        raise AssertionError(
            "repair-path: fractional mode never engaged the regen lane")
    if fractional["counters"]["regen_helpers_served"] <= 0:
        raise AssertionError(
            "repair-path: no survivor served a helper symbol")
    if classic["counters"]["recovery_bytes_saved"] != 0:
        raise AssertionError(
            "repair-path: classic baseline rode the regen lane")
    if classic["gather_bytes"] <= 0:
        raise AssertionError("repair-path: classic mode gathered nothing")

    bytes_ratio = round(
        fractional["gather_bytes"] / classic["gather_bytes"], 4)
    time_ratio = round(
        fractional["time_to_clean_s"]
        / max(classic["time_to_clean_s"], 1e-9), 3)
    if bytes_ratio > bytes_ratio_bound:
        raise AssertionError(
            f"repair-path: gather ratio {bytes_ratio} exceeds the "
            f"{bytes_ratio_bound} repair-bandwidth gate")
    if time_ratio > time_ratio_bound:
        raise AssertionError(
            f"repair-path: time-to-clean ratio {time_ratio} exceeds "
            f"{time_ratio_bound} -- the fractional lane made repair "
            "slower")
    return {
        "n_osds": n_osds,
        "n_objects": n_objects,
        "obj_bytes": obj_bytes,
        "bit_exact": True,  # the gates raised otherwise
        "repair_bytes_ratio": bytes_ratio,
        "time_to_clean_ratio": time_ratio,
        "bytes_saved": fractional["counters"]["recovery_bytes_saved"],
        "classic": classic,
        "fractional": fractional,
    }
