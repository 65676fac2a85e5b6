"""The durable cluster's cycle: an EC pool on persistent object stores
through a crash, and a replicated index pool beside it.

:func:`run_durable_cycle` drives a cluster whose OSDs keep their shards in
a persistent engine (``filestore``, ``kstore``, ``blockstore``) under a
data path: write every object with ``writers`` concurrent client tasks,
kill the first OSD of the first object's acting set and read every object
degraded, kill the mon leader and wait for the lease to fail over (where
the cluster has mons: ``ECCluster.create_with_mons``), write ``extra``
objects while the OSD is still down, then crash -- stop the messenger and
abandon the daemons without unmounting their stores, the open store
objects kept alive so that nothing of theirs is flushed or closed -- and
mount a new cluster on the same data path.  The new cluster reads every
object back with the same OSD down, revives it and recovers until
``degraded_report()`` is empty; then the recovery's tick loops stop, so
that what runs next -- every object read again, and whatever the caller
runs on the cluster -- is timed without their background peering and
deep-scrub passes.  Every read is checked against its payload.  A ``hook(cluster, step, when)`` runs at the
``"start"`` and ``"end"`` of each step of :data:`STEPS` that ran (the card
run zeroes and reads the kernel launch counts there).

:func:`run_index_pool` is the replicated pool's part: ``add_pool(...,
pool_type="replicated", size=3)`` on the running cluster's OSDs, small
objects each with an omap (the shape of an RGW bucket index), every object
and omap read back with one OSD down, and every replica's copy compared.
"""

from __future__ import annotations

import os
import time
from typing import Awaitable, Callable, Dict, List, Optional

import numpy as np

from ceph_tpu_torch.osd.cluster_bench import (client_ops, percentile,
                                              recover_until_clean)

#: the durable cycle's steps, in order (``mon_failover`` only with mons)
STEPS = ("write", "degraded_read", "mon_failover", "degraded_write",
         "remount_read", "recovery", "read")


def disk_usage(path: str) -> Dict[str, int]:
    """Files under ``path``: their count, apparent bytes and the bytes
    their blocks take on disk."""
    files = size = blocks = 0
    for root, _dirs, names in os.walk(path):
        for name in names:
            st = os.stat(os.path.join(root, name))
            files += 1
            size += st.st_size
            blocks += st.st_blocks * 512
    return {"files": files, "bytes": size, "disk_bytes": blocks}


def _abandon(cluster) -> List[object]:
    """What a crash leaves: the daemons stop, the stores stay as they are
    (not unmounted); returns the open stores, which the caller keeps
    referenced so that no finalizer flushes or closes them."""
    for osd in cluster.osds:
        osd.tier.clear()
    return [osd.store for osd in cluster.osds]


def stop_auto_recovery(cluster) -> None:
    """Stop the tick loop ``start_auto_recovery`` started on every OSD of a
    clean cluster, with every hosted pool "active" again (either package's
    OSDs: neither has a stop of its own); peering then waits for the next
    ``start_auto_recovery``."""
    for osd in cluster.osds:
        task = getattr(osd, "_tick_task", None)
        if task is not None:
            task.cancel()
        osd._tick_task = None
        osd._peer_event = None
        for pool in osd.pools:
            osd.pg_states[pool] = "active"


async def run_durable_cycle(
        make_cluster: Callable[[], Awaitable[object]],
        payloads: Dict[str, bytes], extra: Dict[str, bytes], *,
        writers: int = 8, tick: float = 0.05, deadline_s: float = 120.0,
        hook: Optional[Callable[[object, str, str], None]] = None,
        data_path: str = "") -> Dict:
    """The durable cycle (module docstring) in the running loop.  Returns
    the seconds, op latencies and rates of each step, the killed OSD, the
    mon leaders before and after the failover, the data path's usage after
    the writes and after recovery, and the remounted cluster under
    ``"cluster"``, still running (the caller shuts it down)."""
    hook = hook or (lambda cluster, step, when: None)
    steps_s: Dict[str, float] = {}
    lat: Dict[str, List[float]] = {}
    current = dict(payloads)
    cluster = None

    async def write(oid, data):
        await cluster.write(oid, data)

    async def read(oid, want):
        got = await cluster.read(oid)
        if got != want:
            raise AssertionError(f"durable cycle: read of {oid} differs "
                                 "from its payload")

    async def step(name, coro_fn):
        hook(cluster, name, "start")
        t0 = time.perf_counter()
        out = await coro_fn()
        steps_s[name] = time.perf_counter() - t0
        hook(cluster, name, "end")
        return out

    cluster = await make_cluster()
    mons = getattr(cluster, "mons", None) is not None
    first = next(iter(payloads))
    victim = cluster.backend.acting_set(first)[0]
    lat["write"] = await step("write", lambda: client_ops(
        payloads.items(), write, writers))
    usage_written = disk_usage(data_path) if data_path else {}
    cluster.kill_osd(victim)
    lat["degraded_read"] = await step("degraded_read", lambda: client_ops(
        current.items(), read, writers))

    leaders = {}
    if mons:
        async def failover():
            old = await cluster.mons.wait_for_leader()
            leaders["before"] = old.rank
            cluster.mons.kill(old.rank)
            rc, st = await cluster.mon_command({"prefix": "status"})
            if rc != 0 or st["leader"] in (None, old.rank):
                raise AssertionError(
                    f"durable cycle: no new mon leader ({rc}, {st})")
            leaders["after"] = st["leader"]

        await step("mon_failover", failover)
    current.update(extra)
    lat["degraded_write"] = await step("degraded_write", lambda: client_ops(
        extra.items(), write, writers))

    # the crash: the daemons stop, their stores are neither flushed nor
    # unmounted, and a new cluster mounts the same data path
    await cluster.messenger.shutdown()
    crashed = _abandon(cluster)
    cluster = await make_cluster()
    cluster.kill_osd(victim)
    lat["remount_read"] = await step("remount_read", lambda: client_ops(
        current.items(), read, writers))
    del crashed

    await step("recovery", lambda: recover_until_clean(
        cluster, victim, tick, deadline_s, "durable cycle"))
    stop_auto_recovery(cluster)
    lat["read"] = await step("read", lambda: client_ops(
        current.items(), read, writers))

    gib = 2 ** 30
    written = sum(len(d) for d in payloads.values())
    read_bytes = sum(len(d) for d in current.values())
    return {
        "objects": len(payloads),
        "extra": len(extra),
        "victim": victim,
        "mon_leaders": leaders,
        "steps_s": steps_s,
        "write_GiBs": written / gib / steps_s["write"],
        "degraded_read_GiBs": written / gib / steps_s["degraded_read"],
        "remount_read_GiBs": read_bytes / gib / steps_s["remount_read"],
        "read_GiBs": read_bytes / gib / steps_s["read"],
        "time_to_clean_s": steps_s["recovery"],
        "op_ms": {name: {"p50": percentile(v, 0.50) * 1e3,
                         "p99": percentile(v, 0.99) * 1e3, "ops": len(v)}
                  for name, v in lat.items()},
        "disk_after_write": usage_written,
        "disk_after_recovery": disk_usage(data_path) if data_path else {},
        "final": current,
        "cluster": cluster,
    }


def index_objects(n_objects: int, obj_bytes: int, keys: int, seed: int
                  ) -> Dict[str, tuple]:
    """``idx<i>`` -> (data, omap of ``keys`` entries), made with numpy
    from ``seed``: an RGW bucket index shard's shape, small data and a
    row of omap keys per object."""
    rng = np.random.RandomState(seed)
    return {f"idx{i}": (rng.bytes(obj_bytes),
                        {f"entry.{i}.{j:04d}": rng.bytes(48)
                         for j in range(keys)})
            for i in range(n_objects)}


async def run_index_pool(cluster, objects: Dict[str, tuple], *,
                         name: str = "meta", size: int = 3,
                         writers: int = 8) -> Dict:
    """The replicated pool's part (module docstring) on a running
    cluster.  Returns its seconds, the OSD killed for the reads and how
    many replica copies were compared."""
    pool = cluster.add_pool(name, pool_type="replicated", size=size)
    steps_s: Dict[str, float] = {}

    async def write(oid, item):
        data, omap = item
        await pool.write(oid, data)
        await pool.omap_set(oid, omap)

    async def read(oid, item):
        data, omap = item
        if await pool.read(oid) != data or await pool.omap_get(oid) != omap:
            raise AssertionError(f"index pool: {oid} differs from what "
                                 "was written")

    t0 = time.perf_counter()
    await client_ops(objects.items(), write, writers)
    steps_s["write"] = time.perf_counter() - t0
    down = pool.acting_set(next(iter(objects)))[0]
    cluster.kill_osd(down)
    t0 = time.perf_counter()
    await client_ops(objects.items(), read, writers)
    steps_s["degraded_read"] = time.perf_counter() - t0
    cluster.revive_osd(down)
    copies = 0
    for oid, (data, omap) in objects.items():
        acting = pool.acting_set(oid)
        for s in range(size):
            store = cluster.osds[acting[s]].store
            if store.read(f"{name}/{oid}@{s}") != data:
                raise AssertionError(f"index pool: replica {s} of {oid} on "
                                     f"osd.{acting[s]} differs")
            copies += 1
        twins = [cluster.osds[o].store.omap_get(f"{name}/{oid}@meta")
                 for o in range(len(cluster.osds))
                 if cluster.osds[o].store.exists(f"{name}/{oid}@meta")]
        if len(twins) < size or any(t != omap for t in twins):
            raise AssertionError(f"index pool: the omap copies of {oid} "
                                 "differ")
    return {"objects": len(objects), "size": size, "down": down,
            "copies_compared": copies, "steps_s": steps_s}
