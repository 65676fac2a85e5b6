#!/usr/bin/env python3
"""rados bench analogue: object write/read throughput on the mini-cluster.

Port of ``tools/rados_bench.py``: the same flags, defaults (20 OSDs, 16
objects of 4 MiB, ``plugin=lrc k=10 m=4 l=7``) and JSON lines.  The
profile decides where the chunk math runs, as everywhere in the port: a
``plugin=cuda`` profile encodes and decodes on the card and raises
without CUDA unless it says ``device=cpu``; the default lrc profile's
generated layers are ``jerasure``'s, on the host.  :func:`bench` runs
the writes and reads and hands back the cluster before its
``shutdown()``, so a caller can inspect what it stored.

Reference role: `rados bench -p <pool> write` against a vstart EC pool.
Boots an in-process cluster with the given profile, writes/reads N
objects of --size bytes, prints one JSON line per phase:
{"phase": "write", "mb_s": ..., "objects": ..., "size": ...}.

    python -m ceph_tpu_torch.tools.rados_bench [--size B] [--objects N] \
        [--osds N] [--profile "plugin=cuda k=8 m=4"]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time

from ceph_tpu_torch.osd.cluster import ECCluster
from ceph_tpu_torch.utils.perf import PerfCounters

#: the reference's defaults: OSDs, objects, object size and profile
OSDS = 20
OBJECTS = 16
SIZE = 4 << 20
PROFILE = "plugin=lrc k=10 m=4 l=7"


def parse_profile(text: str) -> dict:
    return dict(kv.split("=", 1) for kv in text.split())


async def bench(osds: int, objects: int, size: int, profile: dict):
    """Write then read ``objects`` random objects of ``size`` bytes on a
    new ``ECCluster(osds, profile)`` (built in the running loop); returns
    (cluster, payloads, the two result dicts).  The caller shuts the
    cluster down."""
    PerfCounters.reset_all()
    cluster = ECCluster(osds, dict(profile))
    payloads = {f"bench_{i}": os.urandom(size) for i in range(objects)}
    t0 = time.perf_counter()
    for oid, data in payloads.items():
        await cluster.write(oid, data)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    for oid, data in payloads.items():
        got = await cluster.read(oid)
        assert got == data
    t_read = time.perf_counter() - t0
    total_mb = objects * size / 1e6
    results = [{"phase": phase, "mb_s": round(total_mb / t, 2),
                "objects": objects, "size": size}
               for phase, t in (("write", t_write), ("read", t_read))]
    return cluster, payloads, results


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=SIZE)
    p.add_argument("--objects", type=int, default=OBJECTS)
    p.add_argument("--osds", type=int, default=OSDS)
    p.add_argument("--profile", default=PROFILE,
                   help="space-separated k=v EC profile")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    profile = parse_profile(args.profile)

    async def run():
        cluster, _payloads, results = await bench(
            args.osds, args.objects, args.size, profile)
        for line in results:
            print(json.dumps(line))
        await cluster.shutdown()

    asyncio.new_event_loop().run_until_complete(run())
    return 0


if __name__ == "__main__":
    sys.exit(main())
