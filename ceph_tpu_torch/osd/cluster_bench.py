"""The storage cycle of an EC cluster, timed step by step.

The cycle is the JAX package's storage dry run (``__graft_entry__.py``,
the storage cycle of ``dryrun_multichip``) at a chosen size: write every
object with ``writers`` concurrent client tasks, kill the first OSD of
the first object's acting set, overwrite every ``overwrite_every``-th
object while degraded (the killed OSD's shards go stale), read every
object back (reads that lost a data shard decode), revive the OSD, start
auto recovery and wait until ``degraded_report()`` is empty, then read
every object again.  Every read is checked against its payload.

:func:`run_cycle` drives any ``ECCluster``-shaped object, so one script
of calls runs the port's cluster and the JAX package's side by side; a
``hook(cluster, step, when)`` callback runs at the ``"start"`` and
``"end"`` of each step of :data:`STEPS` (the card run zeroes and reads
the kernel launch counts there, the tests snapshot the stores).

:func:`run_tier_cycle` is the device cache tier's cycle (steps
:data:`TIER_STEPS`): the same objects through a cluster whose pool is in
a cache mode, with the tier's hits, misses, puts and evictions per step.
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable, Dict, List, Optional

import numpy as np

#: the cycle's steps, in order
STEPS = ("write", "degraded_write", "degraded_read", "recovery", "read")
#: the tier cycle's steps, in order
TIER_STEPS = ("write", "read", "tick", "rewrite", "read_hot",
              "degraded_read", "recovery", "read_after")
#: the tier's per-OSD perf counters a tier cycle sums per step
TIER_COUNTERS = ("tier_promote_from_encode", "tier_promote_ops",
                 "tier_evict_ops", "tier_evict_bytes", "tier_invalidate",
                 "tier_hit_read", "tier_agent_failed")


def make_payloads(n_objects: int, obj_bytes: int, seed: int = 0
                  ) -> Dict[str, bytes]:
    """``obj<i>`` -> ``obj_bytes`` random bytes made with numpy from
    ``seed``."""
    rng = np.random.RandomState(seed)
    return {f"obj{i}": rng.bytes(obj_bytes) for i in range(n_objects)}


def make_overwrites(payloads: Dict[str, bytes], every: int, seed: int,
                    obj_bytes: Optional[int] = None) -> Dict[str, bytes]:
    """New payloads for every ``every``-th object (the same size unless
    ``obj_bytes`` is given), made with numpy from ``seed``."""
    rng = np.random.RandomState(seed)
    return {oid: rng.bytes(obj_bytes or len(data))
            for i, (oid, data) in enumerate(payloads.items())
            if i % every == 0}


def percentile(samples: List[float], q: float) -> float:
    """The ``q`` quantile of ``samples`` (nearest rank; 0.0 when empty)."""
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(len(s) - 1, int(q * len(s)))]


async def client_ops(items, op, workers: int) -> List[float]:
    """Run ``op(oid, data)`` over ``items`` from ``workers`` concurrent
    client tasks; returns each op's latency in seconds."""
    queue = list(items)
    lat: List[float] = []

    async def worker():
        while queue:
            oid, data = queue.pop(0)
            t0 = time.perf_counter()
            await op(oid, data)
            lat.append(time.perf_counter() - t0)

    await asyncio.gather(*(worker() for _ in range(workers)))
    return lat


async def recover_until_clean(cluster, victim: int, tick: float,
                              deadline_s: float, what: str) -> None:
    """Revive ``victim``, start auto recovery and wait until
    ``degraded_report()`` is empty; raises after ``deadline_s``."""
    cluster.revive_osd(victim)
    cluster.start_auto_recovery(interval=tick)
    loop = asyncio.get_running_loop()
    deadline = loop.time() + deadline_s
    while await cluster.degraded_report():
        if loop.time() > deadline:
            raise AssertionError(f"{what}: not clean within {deadline_s} s")
        await asyncio.sleep(tick)


async def run_cycle(cluster, payloads: Dict[str, bytes],
                    overwrites: Dict[str, bytes], *, writers: int = 8,
                    tick: float = 0.05, deadline_s: float = 120.0,
                    hook: Optional[Callable[[object, str, str], None]] = None
                    ) -> Dict:
    """The storage cycle (module docstring) on a cluster built in the
    running loop.  Returns the seconds, op latencies and rates of each
    step, the killed OSD and the bytes recovery rewrote on it."""
    hook = hook or (lambda cluster, step, when: None)
    current = dict(payloads)
    steps_s: Dict[str, float] = {}
    lat: Dict[str, List[float]] = {}

    async def write(oid, data):
        await cluster.write(oid, data)

    async def read(oid, want):
        got = await cluster.read(oid)
        if got != want:
            raise AssertionError(f"cluster cycle: read of {oid} differs "
                                 "from its payload")

    async def step(name, coro_fn):
        hook(cluster, name, "start")
        t0 = time.perf_counter()
        out = await coro_fn()
        steps_s[name] = time.perf_counter() - t0
        hook(cluster, name, "end")
        return out

    first = next(iter(payloads))
    victim = cluster.backend.acting_set(first)[0]

    lat["write"] = await step("write", lambda: client_ops(
        payloads.items(), write, writers))
    cluster.kill_osd(victim)
    current.update(overwrites)
    lat["degraded_write"] = await step("degraded_write", lambda: client_ops(
        overwrites.items(), write, writers))
    lat["degraded_read"] = await step("degraded_read", lambda: client_ops(
        current.items(), read, writers))

    await step("recovery", lambda: recover_until_clean(
        cluster, victim, tick, deadline_s, "cluster cycle"))
    lat["read"] = await step("read", lambda: client_ops(
        current.items(), read, writers))

    # the shards recovery rewrote on the revived OSD: those of the
    # objects overwritten while it was down
    osd = cluster.osds[victim]
    rebuilt = 0
    for oid in overwrites:
        acting = cluster.backend.acting_set(oid)
        for s, o in enumerate(acting):
            if o == victim:
                rebuilt += len(osd.store.read(f"{oid}@{s}"))
    gib = 2 ** 30
    written = sum(len(d) for d in payloads.values())
    rewritten = sum(len(d) for d in overwrites.values())
    read_bytes = sum(len(d) for d in current.values())
    return {
        "objects": len(payloads),
        "overwritten": len(overwrites),
        "victim": victim,
        "steps_s": steps_s,
        "write_GiBs": written / gib / steps_s["write"],
        "degraded_write_GiBs": rewritten / gib / steps_s["degraded_write"],
        "degraded_read_GiBs": read_bytes / gib / steps_s["degraded_read"],
        "read_GiBs": read_bytes / gib / steps_s["read"],
        "time_to_clean_s": steps_s["recovery"],
        "rebuilt_bytes": rebuilt,
        "rebuild_MiBs": rebuilt / 2 ** 20 / steps_s["recovery"],
        "op_ms": {name: {"p50": percentile(v, 0.50) * 1e3,
                         "p99": percentile(v, 0.99) * 1e3, "ops": len(v)}
                  for name, v in lat.items()},
        "final": current,
    }


def tier_state(cluster) -> Dict[str, int]:
    """The cluster's tiers summed over its OSDs: hits, misses, resident
    bytes and entries, and the :data:`TIER_COUNTERS`."""
    out = {"hits": 0, "misses": 0, "resident_bytes": 0, "entries": 0,
           **{key: 0 for key in TIER_COUNTERS}}
    for osd in cluster.osds:
        status = osd.tier.status()
        out["hits"] += status["hit"]
        out["misses"] += status["miss"]
        out["resident_bytes"] += status["resident_bytes"]
        out["entries"] += status["entries"]
        perf = osd.perf.snapshot()
        for key in TIER_COUNTERS:
            out[key] += perf.get(key, 0)
    return out


async def run_tier_cycle(cluster, mode: str, payloads: Dict[str, bytes],
                         rewrites: Dict[str, bytes], *, writers: int = 8,
                         tick: float = 0.05, deadline_s: float = 120.0,
                         hook: Optional[Callable[[object, str, str], None]]
                         = None) -> Dict:
    """The device tier's cycle on a cluster built in the running loop,
    with the pool in cache mode ``mode``: write every object (cold:
    nothing is resident yet), read every object (the reads heat the hit
    sets), run one agent tick on every OSD (it promotes the hot objects and
    evicts under the budget), rewrite the objects of ``rewrites``
    (writeback: the write hands the tier the encode's device block,
    promote-from-encode; readproxy: the write invalidates the resident
    copy), read every object, read every object again with the first OSD
    of the first object's acting set killed (a tier hit needs no decode),
    revive it, recover until clean and read every object again.  Every
    read is checked against its payload.  Returns the seconds and the
    change of :func:`tier_state` of each step of :data:`TIER_STEPS`, the
    resident bytes after each step, and the rewritten objects still
    resident after the rewrite."""
    hook = hook or (lambda cluster, step, when: None)
    cluster.set_tier_mode(mode)
    current = dict(payloads)
    steps_s: Dict[str, float] = {}
    deltas: Dict[str, Dict[str, int]] = {}
    resident: Dict[str, int] = {}

    async def write(oid, data):
        await cluster.write(oid, data)

    async def read(oid, want):
        got = await cluster.read(oid)
        if got != want:
            raise AssertionError(f"tier cycle: read of {oid} differs from "
                                 "its payload")

    async def tick_all():
        for osd in cluster.osds:
            await osd.tier_tick()

    async def step(name, coro_fn):
        before = tier_state(cluster)
        hook(cluster, name, "start")
        t0 = time.perf_counter()
        await coro_fn()
        steps_s[name] = time.perf_counter() - t0
        hook(cluster, name, "end")
        after = tier_state(cluster)
        deltas[name] = {key: after[key] - before[key] for key in after
                        if key not in ("resident_bytes", "entries")}
        resident[name] = after["resident_bytes"]

    first = next(iter(payloads))
    victim = cluster.backend.acting_set(first)[0]
    await step("write", lambda: client_ops(payloads.items(), write,
                                            writers))
    await step("read", lambda: client_ops(current.items(), read, writers))
    await step("tick", tick_all)
    current.update(rewrites)
    await step("rewrite", lambda: client_ops(rewrites.items(), write,
                                              writers))
    still = sorted(oid for oid in rewrites
                   if any(osd.tier.contains(cluster.pool, oid)
                          for osd in cluster.osds))
    await step("read_hot", lambda: client_ops(current.items(), read,
                                                writers))
    cluster.kill_osd(victim)
    await step("degraded_read", lambda: client_ops(current.items(), read,
                                                    writers))

    await step("recovery", lambda: recover_until_clean(
        cluster, victim, tick, deadline_s, "tier cycle"))
    await step("read_after", lambda: client_ops(current.items(), read,
                                                 writers))
    gib = 2 ** 30
    read_bytes = sum(len(d) for d in current.values())
    return {
        "mode": mode,
        "objects": len(payloads),
        "rewritten": len(rewrites),
        "victim": victim,
        "steps_s": steps_s,
        "tier": deltas,
        "resident_bytes": resident,
        "rewritten_still_resident": still,
        "write_GiBs": sum(len(d) for d in payloads.values()) / gib /
        steps_s["write"],
        "rewrite_GiBs": sum(len(d) for d in rewrites.values()) / gib /
        steps_s["rewrite"],
        "read_GiBs": read_bytes / gib / steps_s["read"],
        "read_hot_GiBs": read_bytes / gib / steps_s["read_hot"],
        "degraded_read_GiBs": read_bytes / gib / steps_s["degraded_read"],
        "read_after_GiBs": read_bytes / gib / steps_s["read_after"],
        "final": current,
    }


def run_storage_cycle(make_cluster: Callable[[], object],
                      payloads: Dict[str, bytes],
                      overwrites: Dict[str, bytes], **kw) -> Dict:
    """Build a cluster in a new event loop, run :func:`run_cycle` on it
    and shut it down.  ``kw`` goes to :func:`run_cycle`; the result also
    carries the cluster under ``"cluster"`` (shut down, stores intact)."""
    async def main():
        cluster = make_cluster()
        try:
            result = await run_cycle(cluster, payloads, overwrites, **kw)
        finally:
            await cluster.shutdown()
        result["cluster"] = cluster
        return result

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(main())
    finally:
        loop.close()


def store_snapshot(cluster) -> Dict[tuple, tuple]:
    """``(osd id, stored object)`` -> ``(data, attrs, omap)`` over every
    OSD's MemStore, for byte-for-byte comparisons of two clusters."""
    out = {}
    for osd in cluster.osds:
        for name, obj in sorted(osd.store._objects.items()):
            out[(osd.osd_id, name)] = (
                bytes(obj.data), dict(obj.xattrs), dict(obj.omap))
    return out
