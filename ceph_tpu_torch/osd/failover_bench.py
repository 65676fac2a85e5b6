"""Failover robustness benchmark stage (bench.py ``failover_path_host``).

Port of ``ceph_tpu/osd/failover_bench.py``, on the ``cuda`` plugin (the
JAX package's profile names ``jerasure``); ``profile=dict(PROFILE,
device="cpu")`` runs it on the CPU.  The pool's codec encodes and
decodes one stripe before the steady writes are timed, so the first
write does not carry the kernel library's build.

Measures the client-visible cost of primary failover on the in-process
mini-cluster -- the tail-latency window the exactly-once work targets
(studies of online EC under failure show role-handoff stalls dominate
p99, arXiv:1709.05365 / arXiv:1906.08602):

* **steady**: op latency with no faults (the baseline);
* **time-to-first-success (TTFS)**: per kill round, the primary of the
  op in flight is killed in the apply/reply window (the
  ``kill_after_apply`` injector) and the wall time until the SAME
  logical op completes -- probe discovery + jittered backoff + resend +
  PG-log dup answer -- is recorded;
* **thrash p99**: op latency tail across the whole kill/revive churn.

Correctness is gated alongside timing: every killed-window op must
complete with its original result exactly once (dup hits observed, no
error surfaces), so the stage fails loudly if the robustness machinery
regresses rather than reporting a fast-but-wrong number.

``chip_smoke.py`` phase 3i runs it on the card;
tests/test_torch_elastic.py runs it at tests/test_exactly_once.py's tiny
shape in both packages.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, List

PROFILE = {"k": "4", "m": "2", "technique": "reed_sol_van",
           "plugin": "cuda"}


def _pct(samples: List[float], q: float) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(len(s) - 1, int(q * len(s)))]


async def _run(n_osds: int, n_objects: int, obj_bytes: int,
               kills: int, profile: Dict[str, str] = PROFILE) -> Dict:
    import json

    from ceph_tpu_torch.msg.fault import FaultInjector
    from ceph_tpu_torch.osd.cluster import ECCluster
    from ceph_tpu_torch.osd.elastic_bench import warm_codec
    from ceph_tpu_torch.utils.config import get_config
    from ceph_tpu_torch.utils.perf import PerfCounters

    PerfCounters.reset_all()
    cfg = get_config()
    prior_grace = cfg.get_val("client_probe_grace")
    cfg.apply_changes({"client_probe_grace": 0.05})
    fault = FaultInjector(seed=5)
    cluster = ECCluster(n_osds, dict(profile), fault=fault)
    try:
        warm_codec(cluster.ec)
        payload = b"f" * obj_bytes
        oids = [f"fo{i}" for i in range(n_objects)]
        steady: List[float] = []
        for oid in oids:
            t0 = time.perf_counter()
            await cluster.write(oid, payload)
            steady.append(time.perf_counter() - t0)

        thrash: List[float] = []
        ttfs: List[float] = []
        down: List[int] = []
        for round_no in range(kills):
            for osd in down:
                cluster.revive_osd(osd)
            down.clear()
            oid = oids[round_no % len(oids)]
            victim = int(cluster.backend.primary_of(oid).split(".")[1])
            fault.schedule_kill_after_apply("write")
            t0 = time.perf_counter()
            await cluster.write(oid, payload)
            dt = time.perf_counter() - t0
            ttfs.append(dt)
            thrash.append(dt)
            down.append(victim)
            # traffic during the degraded window feeds the p99 tail
            for other in oids[:8]:
                t0 = time.perf_counter()
                if other == oid:
                    await cluster.read(other)
                else:
                    await cluster.write(other, payload)
                thrash.append(time.perf_counter() - t0)
        for osd in down:
            cluster.revive_osd(osd)

        dump = json.loads(PerfCounters.dump())
        dup_hits = sum(v.get("dup_op_hit", 0)
                       for name, v in dump.items()
                       if name.startswith("osd."))
        resends = dump.get("client", {}).get("op_resend", 0)
        if fault.apply_kills != kills:
            raise RuntimeError(
                f"injector fired {fault.apply_kills}/{kills} kills"
            )
        if dup_hits < 1:
            raise RuntimeError("no replay was answered from the PG log")
        return {
            "steady_p50_ms": round(_pct(steady, 0.50) * 1e3, 3),
            "steady_p99_ms": round(_pct(steady, 0.99) * 1e3, 3),
            "ttfs_mean_ms": round(sum(ttfs) / len(ttfs) * 1e3, 3),
            "ttfs_max_ms": round(max(ttfs) * 1e3, 3),
            "thrash_p99_ms": round(_pct(thrash, 0.99) * 1e3, 3),
            "kills": kills,
            "op_resend": resends,
            "dup_op_hit": dup_hits,
        }
    finally:
        cfg.apply_changes({"client_probe_grace": prior_grace})
        await cluster.shutdown()


def run_failover_bench(*, n_osds: int = 8, n_objects: int = 16,
                       obj_bytes: int = 16 << 10, kills: int = 5,
                       profile: Dict[str, str] = PROFILE) -> Dict:
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(
            _run(n_osds, n_objects, obj_bytes, kills, profile)
        )
    finally:
        loop.close()
